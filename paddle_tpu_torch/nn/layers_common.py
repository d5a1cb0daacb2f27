"""Core layers: the counterpart of ``paddle_tpu/nn/layers_common.py`` (the
part the eager GPT, a plain MLP and the vision models use). Weight layouts
are paddle's: ``Linear`` weight ``[in, out]``, ``Conv2D`` weight ``[out,
in / groups, kh, kw]``, ``Conv2DTranspose`` weight ``[in, out / groups,
kh, kw]``; the batch norms keep their running statistics in the buffers
``_mean`` and ``_variance``. So state dicts cross unchanged."""
from __future__ import annotations

import numbers

import torch

from . import functional as F
from . import initializer as I
from .layer import Layer, create_parameter

__all__ = ["Linear", "Embedding", "Dropout", "Dropout2D", "Flatten",
           "Identity", "Conv1D", "Conv2D", "Conv2DTranspose", "BatchNorm1D",
           "BatchNorm2D", "BatchNorm3D", "BatchNorm", "SyncBatchNorm",
           "LayerNorm", "RMSNorm", "GroupNorm", "InstanceNorm2D",
           "MaxPool2D", "AvgPool2D", "MaxPool1D", "AvgPool1D",
           "AdaptiveAvgPool2D", "AdaptiveMaxPool2D", "LayerList",
           "Sequential", "LayerDict", "ParameterList", "Upsample",
           "UpsamplingBilinear2D", "Pad2D", "CosineSimilarity", "Bilinear",
           "Unfold"]


class Linear(Layer):
    """``y = x @ W + b``, W ``[in_features, out_features]``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self.weight = create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=None if weight_attr else I.XavierNormal())
        self.bias = None if bias_attr is False else create_parameter(
            [out_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.weight.shape[0]}, "
                f"out_features={self.weight.shape[1]}")


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self._padding_idx = padding_idx
        self.weight = create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=None if weight_attr else I.Normal(0.0, 1.0))
        if padding_idx is not None:
            with torch.no_grad():
                self.weight._t[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        from ..ops.manipulation import flatten
        return flatten(x, self.start_axis, self.stop_axis)


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class _ConvBase(Layer):
    """Weight ``[out, in / groups, *kernel]`` drawn by ``KaimingNormal``
    unless ``weight_attr`` says otherwise; bias ``[out]`` unless
    ``bias_attr`` is False."""

    def __init__(self, in_channels, out_channels, kernel_size, dims,
                 weight_attr=None, bias_attr=None, groups=1):
        super().__init__()
        if isinstance(kernel_size, numbers.Integral):
            kernel_size = (kernel_size,) * dims
        self.weight = create_parameter(
            [out_channels, in_channels // groups] + list(kernel_size),
            attr=weight_attr,
            default_initializer=None if weight_attr else I.KaimingNormal())
        self.bias = None if bias_attr is False else create_parameter(
            [out_channels], attr=bias_attr, is_bias=True)


class Conv2D(_ConvBase):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2,
                         weight_attr, bias_attr, groups)
        self._stride, self._padding = stride, padding
        self._dilation, self._groups = dilation, groups
        self._data_format = data_format

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv1D(_ConvBase):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1,
                         weight_attr, bias_attr, groups)
        self._stride, self._padding = stride, padding
        self._dilation, self._groups = dilation, groups
        self._data_format = data_format

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv2DTranspose(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__()
        if isinstance(kernel_size, numbers.Integral):
            kernel_size = (kernel_size,) * 2
        self.weight = create_parameter(
            [in_channels, out_channels // groups] + list(kernel_size),
            attr=weight_attr,
            default_initializer=None if weight_attr else I.KaimingNormal())
        self.bias = None if bias_attr is False else create_parameter(
            [out_channels], attr=bias_attr, is_bias=True)
        self._stride, self._padding = stride, padding
        self._output_padding = output_padding
        self._dilation, self._groups = dilation, groups
        self._data_format = data_format

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(
            x, self.weight, self.bias, self._stride, self._padding,
            self._output_padding, self._groups, self._dilation,
            self._data_format)


class _BatchNormBase(Layer):
    """Weight 1 and bias 0 ``[num_features]``, running mean 0 and variance
    1 in the buffers ``_mean`` and ``_variance``. ``train()`` normalises
    with the batch's statistics and updates the buffers; ``eval()`` (or
    ``use_global_stats``) with the buffers."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        from ..ops.creation import ones, zeros
        self._momentum, self._epsilon = momentum, epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = None if weight_attr is False else create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else create_parameter(
            [num_features], attr=bias_attr, is_bias=True)
        self.register_buffer("_mean", zeros([num_features]))
        self.register_buffer("_variance", ones([num_features]))

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class BatchNorm(_BatchNormBase):
    """The old-style batch norm, with ``act="relu"`` applied after it."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-05,
                 **kwargs):
        super().__init__(num_channels, momentum, epsilon)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        return F.relu(out) if self._act == "relu" else out


class SyncBatchNorm(_BatchNormBase):
    """Local statistics, as the reference computes them on one device."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        return layer


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, numbers.Integral):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = None if weight_attr is False else create_parameter(
            self._normalized_shape, attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else create_parameter(
            self._normalized_shape, attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups, self._epsilon = num_groups, epsilon
        self._data_format = data_format
        self.weight = None if weight_attr is False else create_parameter(
            [num_channels], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else create_parameter(
            [num_channels], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class InstanceNorm2D(Layer):
    """Per-sample, per-channel statistics; the weight is ``scale``, as in
    the reference."""

    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        self.scale = None if weight_attr is False else create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else create_parameter(
            [num_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.instance_norm(x, weight=self.scale, bias=self.bias,
                               eps=self._epsilon)


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCHW", name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.ceil_mode, self.return_mask = ceil_mode, return_mask
        self.data_format = data_format

    def forward(self, x):
        return F.max_pool2d(x, self.k, self.s, self.p, self.ceil_mode,
                            self.return_mask, self.data_format)


class AvgPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.ceil_mode, self.exclusive = ceil_mode, exclusive
        self.divisor_override = divisor_override
        self.data_format = data_format

    def forward(self, x):
        return F.avg_pool2d(x, self.k, self.s, self.p, self.ceil_mode,
                            self.exclusive, self.divisor_override,
                            self.data_format)


class MaxPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.ceil_mode, self.return_mask = ceil_mode, return_mask

    def forward(self, x):
        return F.max_pool1d(x, self.k, self.s, self.p, self.ceil_mode,
                            self.return_mask)


class AvgPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.ceil_mode, self.exclusive = ceil_mode, exclusive

    def forward(self, x):
        return F.avg_pool1d(x, self.k, self.s, self.p, self.ceil_mode,
                            self.exclusive)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size, self.data_format = output_size, data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size)


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and \
                len(layers[0]) and isinstance(layers[0][0], tuple):
            layers = layers[0]
        for i, layer in enumerate(layers):
            if isinstance(layer, tuple):
                self.add_sublayer(layer[0], layer[1])
            else:
                self.add_sublayer(str(i), layer)

    def forward(self, x):
        for layer in self._sub_layers.values():
            x = layer(x)
        return x

    def __getitem__(self, idx):
        layers = list(self._sub_layers.values())
        return Sequential(*layers[idx]) if isinstance(idx, slice) \
            else layers[idx]

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers.values())


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        for i, l in enumerate(sublayers or ()):
            self.add_sublayer(str(i), l)

    def append(self, sublayer):
        self.add_sublayer(str(len(self._sub_layers)), sublayer)
        return self

    def extend(self, sublayers):
        for l in sublayers:
            self.append(l)
        return self

    def __getitem__(self, idx):
        layers = list(self._sub_layers.values())
        return LayerList(layers[idx]) if isinstance(idx, slice) \
            else layers[idx]

    def __setitem__(self, idx, layer):
        self.add_sublayer(str(idx), layer)

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers.values())


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training,
                           data_format=self.data_format)


class RMSNorm(Layer):
    """``F.rms_norm`` with a weight (ones) and, unless ``bias_attr`` is
    False (the default), a bias."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 bias_attr=False, name=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = create_parameter(
            [hidden_size], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else create_parameter(
            [hidden_size], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.bias, self._epsilon)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor
        self.mode, self.align_corners = mode, align_corners
        self.align_mode, self.data_format = align_mode, data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             data_format=self.data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True,
                         data_format=data_format)


class Pad2D(Layer):
    """``F.pad`` of the last two axes of an NCHW input (the reference pads
    those whatever ``data_format`` says: the port refuses NHWC)."""

    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__()
        if data_format != "NCHW":
            raise NotImplementedError("Pad2D: the reference pads NCHW only")
        self.padding, self.mode, self.value = padding, mode, value

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class Bilinear(Layer):
    """``x1^T W_o x2 + b``; weight ``[out, in1, in2]``, bias ``[1, out]``."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.weight = create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr)
        self.bias = None if bias_attr is False else create_parameter(
            [1, out_features], attr=bias_attr, is_bias=True)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class LayerDict(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers:
            for k, v in (sublayers.items() if isinstance(sublayers, dict)
                         else sublayers):
                self.add_sublayer(k, v)

    def __getitem__(self, key):
        return self._sub_layers[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __len__(self):
        return len(self._sub_layers)

    def keys(self):
        return self._sub_layers.keys()

    def items(self):
        return self._sub_layers.items()

    def values(self):
        return self._sub_layers.values()


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        for i, p in enumerate(parameters or ()):
            self.register_parameter(str(i), p)

    def append(self, parameter):
        self.register_parameter(str(len(self._parameters)), parameter)
        return self

    def __getitem__(self, idx):
        return self._parameters[str(idx)]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())
