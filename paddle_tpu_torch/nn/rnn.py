"""Recurrent layers: the counterpart of ``paddle_tpu/nn/rnn.py``: the
cells (``SimpleRNNCell``, ``LSTMCell``, ``GRUCell``), the one-direction
``RNN`` and ``BiRNN`` wrappers and the stacked ``SimpleRNN`` / ``LSTM`` /
``GRU``.

As in the reference, the time loop is a Python loop of cell calls, one
``[B, in] x [in, gates]`` and one ``[B, H] x [H, gates]`` product a step
(gates ``[i, f, g, o]`` for the LSTM, ``[r, z, c]`` for the GRU, whose
state is ``(1 - z) c + z h``); final states are packed ``[layers x
directions, B, H]``, forward before backward. No cuDNN RNN: its gate
layout and rounding are not these.

The reference takes ``sequence_length`` and ``proj_size`` and ignores
them; the port refuses them.
"""
from __future__ import annotations

import math
from typing import List, Optional

from .._core.tensor import Tensor
from . import functional as F
from . import initializer as I
from .layer import Layer, create_parameter
from ..ops.creation import full
from ..ops.linalg import matmul
from ..ops.manipulation import concat, split, stack, transpose
from ..ops.math import tanh


def _uniform_init(fan):
    k = 1.0 / math.sqrt(fan) if fan > 0 else 0.0
    return I.Uniform(-k, k)


def _no_sequence_length(sequence_length):
    if sequence_length is not None:
        raise NotImplementedError(
            "sequence_length is not computed by the reference, which runs "
            "every sequence to the full length")


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype="float32",
                           init_value=0.0, batch_dim_idx=0):
        batch = batch_ref.shape[batch_dim_idx]
        return full([batch, self.hidden_size], init_value, dtype)


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.activation = activation
        init = _uniform_init(hidden_size)
        self.weight_ih = create_parameter([hidden_size, input_size],
                                          attr=weight_ih_attr,
                                          default_initializer=init)
        self.weight_hh = create_parameter([hidden_size, hidden_size],
                                          attr=weight_hh_attr,
                                          default_initializer=init)
        self.bias_ih = create_parameter([hidden_size], attr=bias_ih_attr,
                                        is_bias=True,
                                        default_initializer=init)
        self.bias_hh = create_parameter([hidden_size], attr=bias_hh_attr,
                                        is_bias=True,
                                        default_initializer=init)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        pre_h = states
        z = matmul(inputs, self.weight_ih, transpose_y=True) \
            + self.bias_ih \
            + matmul(pre_h, self.weight_hh, transpose_y=True) \
            + self.bias_hh
        act = tanh if self.activation == "tanh" else F.relu
        h = act(z)
        return h, h

    @property
    def state_shape(self):
        return (self.hidden_size,)


class LSTMCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 proj_size=0, name=None):
        super().__init__()
        if proj_size:
            raise NotImplementedError(
                "LSTMCell: proj_size is not computed by the reference")
        self.input_size = input_size
        self.hidden_size = hidden_size
        init = _uniform_init(hidden_size)
        self.weight_ih = create_parameter([4 * hidden_size, input_size],
                                          attr=weight_ih_attr,
                                          default_initializer=init)
        self.weight_hh = create_parameter([4 * hidden_size, hidden_size],
                                          attr=weight_hh_attr,
                                          default_initializer=init)
        self.bias_ih = create_parameter([4 * hidden_size],
                                        attr=bias_ih_attr, is_bias=True,
                                        default_initializer=init)
        self.bias_hh = create_parameter([4 * hidden_size],
                                        attr=bias_hh_attr, is_bias=True,
                                        default_initializer=init)

    def forward(self, inputs, states=None):
        if states is None:
            h = self.get_initial_states(inputs)
            c = self.get_initial_states(inputs)
        else:
            h, c = states
        gates = matmul(inputs, self.weight_ih, transpose_y=True) \
            + self.bias_ih \
            + matmul(h, self.weight_hh, transpose_y=True) \
            + self.bias_hh
        i, f, g, o = split(gates, 4, axis=-1)
        i = F.sigmoid(i)
        f = F.sigmoid(f)
        g = tanh(g)
        o = F.sigmoid(o)
        c_new = f * c + i * g
        h_new = o * tanh(c_new)
        return h_new, (h_new, c_new)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))


class GRUCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        init = _uniform_init(hidden_size)
        self.weight_ih = create_parameter([3 * hidden_size, input_size],
                                          attr=weight_ih_attr,
                                          default_initializer=init)
        self.weight_hh = create_parameter([3 * hidden_size, hidden_size],
                                          attr=weight_hh_attr,
                                          default_initializer=init)
        self.bias_ih = create_parameter([3 * hidden_size],
                                        attr=bias_ih_attr, is_bias=True,
                                        default_initializer=init)
        self.bias_hh = create_parameter([3 * hidden_size],
                                        attr=bias_hh_attr, is_bias=True,
                                        default_initializer=init)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        pre_h = states
        x_gates = matmul(inputs, self.weight_ih,
                                transpose_y=True) + self.bias_ih
        h_gates = matmul(pre_h, self.weight_hh,
                                transpose_y=True) + self.bias_hh
        xr, xz, xc = split(x_gates, 3, axis=-1)
        hr, hz, hc = split(h_gates, 3, axis=-1)
        r = F.sigmoid(xr + hr)
        z = F.sigmoid(xz + hz)
        c = tanh(xc + r * hc)
        h = (1.0 - z) * c + z * pre_h   # paddle gate convention
        return h, h

    @property
    def state_shape(self):
        return (self.hidden_size,)


class RNN(Layer):
    """Run a cell over the time dim (rnn.py RNN wrapper)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        _no_sequence_length(sequence_length)
        x = inputs if self.time_major else transpose(
            inputs, [1, 0, 2])
        steps = x.shape[0]
        order = range(steps - 1, -1, -1) if self.is_reverse \
            else range(steps)
        states = initial_states
        outs: List[Optional[Tensor]] = [None] * steps
        for t in order:
            out, states = self.cell(x[t], states)
            outs[t] = out
        y = stack(outs, axis=0)
        if not self.time_major:
            y = transpose(y, [1, 0, 2])
        return y, states


class BiRNN(Layer):
    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        _no_sequence_length(sequence_length)
        st_fw, st_bw = (initial_states if initial_states is not None
                        else (None, None))
        y_fw, s_fw = self.rnn_fw(inputs, st_fw)
        y_bw, s_bw = self.rnn_bw(inputs, st_bw)
        return concat([y_fw, y_bw], axis=-1), (s_fw, s_bw)


class _RNNBase(Layer):
    _CELL = None
    _STATE_PAIR = False

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation=None, weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        if direction in ("bidirect", "bidirectional"):
            self.num_directions = 2
        elif direction == "forward":
            self.num_directions = 1
        else:
            raise ValueError(f"direction must be forward/bidirect, got "
                             f"{direction}")
        self.direction = direction

        kw = dict(weight_ih_attr=weight_ih_attr,
                  weight_hh_attr=weight_hh_attr, bias_ih_attr=bias_ih_attr,
                  bias_hh_attr=bias_hh_attr)
        if activation is not None:
            kw["activation"] = activation
        layers = []
        for ln in range(num_layers):
            in_sz = input_size if ln == 0 else \
                hidden_size * self.num_directions
            if self.num_directions == 2:
                layers.append(BiRNN(self._CELL(in_sz, hidden_size, **kw),
                                    self._CELL(in_sz, hidden_size, **kw),
                                    time_major=time_major))
            else:
                layers.append(RNN(self._CELL(in_sz, hidden_size, **kw),
                                  time_major=time_major))
        from .layers_common import LayerList
        self._layers = LayerList(layers)

    def _layer_initial_states(self, initial_states, ln):
        """Slice the packed [num_layers*num_directions, B, H] states down
        to layer ln's per-cell states (paddle packing convention)."""
        if initial_states is None:
            return None
        nd = self.num_directions

        def pick(t, idx):
            return t[idx]

        if self._STATE_PAIR:
            h, c = initial_states
            if nd == 2:
                return ((pick(h, 2 * ln), pick(c, 2 * ln)),
                        (pick(h, 2 * ln + 1), pick(c, 2 * ln + 1)))
            return (pick(h, ln), pick(c, ln))
        h = initial_states
        if nd == 2:
            return (pick(h, 2 * ln), pick(h, 2 * ln + 1))
        return pick(h, ln)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        _no_sequence_length(sequence_length)
        x = inputs
        finals = []
        for ln, rnn_l in enumerate(self._layers):
            x, st = rnn_l(x, self._layer_initial_states(initial_states,
                                                        ln))
            finals.append(st)
            if self.dropout > 0 and ln < self.num_layers - 1:
                x = F.dropout(x, self.dropout, training=self.training)
        # pack final states [num_layers*num_directions, B, H]
        if self._STATE_PAIR:
            hs, cs = [], []
            for st in finals:
                pairs = st if self.num_directions == 2 else (st,)
                for h, c in pairs:
                    hs.append(h)
                    cs.append(c)
            state = (stack(hs, 0), stack(cs, 0))
        else:
            hs = []
            for st in finals:
                items = st if self.num_directions == 2 else (st,)
                for h in items:
                    hs.append(h)
            state = stack(hs, 0)
        return x, state


class SimpleRNN(_RNNBase):
    _CELL = SimpleRNNCell


class LSTM(_RNNBase):
    _CELL = LSTMCell
    _STATE_PAIR = True


class GRU(_RNNBase):
    _CELL = GRUCell
