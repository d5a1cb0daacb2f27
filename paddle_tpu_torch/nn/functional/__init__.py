"""Counterpart of ``paddle_tpu/nn/functional``: attention, convolution,
pooling, normalisation, linear, dropout, activations, embedding, losses
and the long tail of ``extended``."""
from .activation import (celu, elu, gelu, glu, gumbel_softmax,  # noqa: F401
                         hardshrink, hardsigmoid, hardswish, hardtanh,
                         leaky_relu, log_sigmoid, log_softmax, mish, prelu,
                         relu, relu6, selu, sigmoid, silu, silu_, softmax,
                         softplus, softshrink, softsign, swish, tanh, tanh_,
                         tanhshrink, thresholded_relu)
from .attention import scaled_dot_product_attention  # noqa: F401
from .common import (alpha_dropout, bilinear, cosine_similarity,  # noqa: F401
                     dropout, dropout2d, dropout3d, interpolate,
                     label_smooth, linear, normalize, pad, unfold, upsample)
from .conv import conv1d, conv2d, conv2d_transpose, conv3d  # noqa: F401
from .extended import *  # noqa: F401,F403
from .flash_attention import (flash_attention, flash_attn_qkvpacked,  # noqa: F401
                              flash_attn_unpadded, flash_attn_unpadded_dense,
                              flashmask_attention, flashmask_attention_dense)
from .input import embedding, one_hot  # noqa: F401
from .loss import (binary_cross_entropy,  # noqa: F401
                   binary_cross_entropy_with_logits, cosine_embedding_loss,
                   cross_entropy, gather_tree, kl_div, l1_loss,
                   margin_cross_entropy, margin_ranking_loss, mse_loss,
                   nll_loss, sigmoid_focal_loss, smooth_l1_loss,
                   softmax_with_cross_entropy)
from .norm import (batch_norm, group_norm, instance_norm,  # noqa: F401
                   layer_norm, local_response_norm, rms_norm)
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,  # noqa: F401
                      adaptive_max_pool2d, avg_pool1d, avg_pool2d,
                      max_pool1d, max_pool2d)
