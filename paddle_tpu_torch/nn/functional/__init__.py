"""Counterpart of ``paddle_tpu/nn/functional``: attention, convolution,
pooling, normalisation, linear, dropout, activations, embedding and
losses."""
from .activation import (elu, gelu, hardsigmoid, hardswish,  # noqa: F401
                         leaky_relu, log_softmax, mish, relu, relu6, sigmoid,
                         silu, softmax, softplus, softsign, swish,
                         tanh, tanhshrink)
from .attention import scaled_dot_product_attention  # noqa: F401
from .common import dropout, linear  # noqa: F401
from .conv import conv1d, conv2d, conv2d_transpose  # noqa: F401
from .flash_attention import (flash_attention, flash_attn_qkvpacked,  # noqa: F401
                              flash_attn_unpadded, flash_attn_unpadded_dense,
                              flashmask_attention, flashmask_attention_dense)
from .input import embedding  # noqa: F401
from .loss import (binary_cross_entropy_with_logits,  # noqa: F401
                   cross_entropy, l1_loss, mse_loss, nll_loss)
from .norm import (batch_norm, group_norm, instance_norm,  # noqa: F401
                   layer_norm, rms_norm)
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,  # noqa: F401
                      adaptive_max_pool2d, avg_pool1d, avg_pool2d,
                      max_pool1d, max_pool2d)
