"""Counterpart of ``paddle_tpu/nn``: ``Layer``, the core, vision,
activation and loss layers, the transformer and recurrent layers,
gradient clipping, weight reparameterisations, their initializers and
the functionals."""
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from . import utils  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue, clip_grad_norm_)
from .layer import (Layer, Parameter, create_parameter,  # noqa: F401
                    functional_call)
from .layers_activation import *  # noqa: F401,F403
from .layers_common import *  # noqa: F401,F403
from .param_attr import ParamAttr  # noqa: F401
from .rnn import (RNN, BiRNN, GRU, GRUCell, LSTM, LSTMCell,  # noqa: F401
                  RNNCellBase, SimpleRNN, SimpleRNNCell)
from .transformer import (MultiHeadAttention, Transformer,  # noqa: F401
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)
from .utils import remove_weight_norm, spectral_norm, weight_norm  # noqa: F401
