"""Counterpart of ``paddle_tpu/nn/functional``: attention, normalisation,
linear, dropout, activations, embedding and cross entropy."""
from .activation import gelu, relu, softmax  # noqa: F401
from .attention import scaled_dot_product_attention  # noqa: F401
from .common import dropout, linear  # noqa: F401
from .flash_attention import (flash_attention, flash_attn_qkvpacked,  # noqa: F401
                              flash_attn_unpadded, flash_attn_unpadded_dense,
                              flashmask_attention, flashmask_attention_dense)
from .input import embedding  # noqa: F401
from .loss import cross_entropy  # noqa: F401
from .norm import layer_norm, rms_norm  # noqa: F401
