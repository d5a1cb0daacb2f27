"""Counterpart of ``paddle_tpu/models``: the GPT, LLaMA and BERT/ERNIE
trainers (``gpt``, ``llama``, ``bert``, over ``trainer``), the eager GPT
layers, and ``convert`` to move the reference's trees in from numpy."""
from .gpt import (GPTConfig, GPTModel, GPTForPretraining,  # noqa: F401
                  GPTPretrainingCriterion, build_train_step,
                  init_gpt_params)
from . import bert  # noqa: F401
from . import llama  # noqa: F401
from .bert import BERT_CONFIGS, BertConfig  # noqa: F401
from .llama import LLAMA_CONFIGS, LlamaConfig  # noqa: F401
