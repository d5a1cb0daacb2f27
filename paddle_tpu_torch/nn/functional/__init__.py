"""Counterpart of ``paddle_tpu/nn/functional``: so far attention and the
normalisations."""
from .attention import scaled_dot_product_attention  # noqa: F401
from .flash_attention import (flash_attention, flash_attn_qkvpacked,  # noqa: F401
                              flash_attn_unpadded, flash_attn_unpadded_dense,
                              flashmask_attention, flashmask_attention_dense)
from .norm import layer_norm, rms_norm  # noqa: F401
