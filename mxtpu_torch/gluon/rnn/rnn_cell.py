"""Recurrent cells (the counterpart of ``mxtpu/gluon/rnn/rnn_cell.py``;
reference ``python/mxnet/gluon/rnn/rnn_cell.py``†).

Cells are step functions ``cell(input_t, states) -> (output, states)``
computed through the registry's ops (``FullyConnected``,
``slice_axis``, ``sigmoid``, ``tanh``), as mxtpu's are; ``unroll``
composes them over time in a Python loop.  The fused layers of
:mod:`.rnn_layer` run the cell kernel; the cells do not.

``unroll`` takes NDArrays (the ``nd`` ops) or tensors (the eager ``F``),
and its zero begin states take the inputs' device and type (mxtpu's
``nd.zeros`` has one device).  On a Symbol it raises as mxtpu's does:
``_format_sequence`` reads the input's ``shape``.
"""
from __future__ import annotations

import torch

from ...base import MXNetError
from ... import ndarray as nd_mod
from ...ndarray.ndarray import NDArray
from ..block import Block, F as _F, HybridBlock

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ResidualCell",
           "BidirectionalCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _ops(x):
    """The op namespace of ``x``: the eager ``F`` for a tensor, ``nd``
    for an NDArray."""
    return _F if isinstance(x, torch.Tensor) else nd_mod


def _zeros_like_step(step):
    """``begin_state``'s ``func`` for an unroll over ``step``'s kind:
    zeros on its device, in its type."""
    t = step if isinstance(step, torch.Tensor) else step._data

    def zeros(shape, **kwargs):
        z = torch.zeros(tuple(shape), dtype=t.dtype, device=t.device)
        return z if isinstance(step, torch.Tensor) else NDArray(z)
    return zeros


def _format_sequence(length, inputs, layout, merge):
    """Inputs as a list of (N, C) steps or a merged (T, N, C) / (N, T, C)
    tensor (reference ``_format_sequence``†)."""
    axis = layout.find("T")
    if isinstance(inputs, (list, tuple)):
        seq = list(inputs)
        if length is not None and len(seq) != length:
            raise MXNetError(f"got {len(seq)} steps, expected {length}")
        if merge:
            return _ops(seq[0]).stack(*seq, axis=axis), axis, len(seq)
        return seq, axis, len(seq)
    T = inputs.shape[axis]
    if length is not None and T != length:
        raise MXNetError(f"inputs have {T} steps, expected {length}")
    if merge:
        return inputs, axis, T
    if axis == 0:
        steps = [inputs[t] for t in range(T)]
    else:
        steps = [inputs[:, t] for t in range(T)]
    return steps, axis, T


class RecurrentCell(Block):
    """Base cell (reference ``RecurrentCell``†)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._modules.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Initial states (reference ``begin_state``†): ``func(shape,
        **kwargs)`` a state, default ``nd.zeros`` (the card unless
        ``ctx=`` says otherwise)."""
        if func is None:
            func = nd_mod.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            info = dict(info)
            shape = info.pop("shape")
            info.pop("__layout__", None)
            states.append(func(shape, **kwargs))
        return states

    def __call__(self, inputs, states, *args):
        self._counter += 1
        return super().__call__(inputs, states, *args)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Unroll the cell over ``length`` steps (reference†).  With
        ``valid_length`` the outputs past each row's length are zero and
        the states returned are those at its length."""
        self.reset()
        steps, axis, T = _format_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = self.begin_state(batch_size=steps[0].shape[0],
                                           func=_zeros_like_step(steps[0]))
        states = begin_state
        outputs = []
        step_states = []
        for t in range(T):
            out, states = self(steps[t], states)
            outputs.append(out)
            if valid_length is not None:
                step_states.append(states)
        if valid_length is not None:
            F = _ops(outputs[0])
            stacked = F.stack(*outputs, axis=0)  # (T, N, C)
            masked = F.SequenceMask(stacked, valid_length,
                                    use_sequence_length=True)
            outputs = [masked[t] for t in range(T)]
            states = [
                F.SequenceLast(F.stack(*[s[i] for s in step_states],
                                       axis=0),
                               valid_length, use_sequence_length=True)
                for i in range(len(states))]
        if merge_outputs:
            return _ops(outputs[0]).stack(*outputs,
                                          axis=layout.find("T")), states
        return outputs, states

    def _get_param(self, name, shape, init):
        return self.params.get(name, shape=shape, init=init,
                               allow_deferred_init=True)


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    """Cells whose step is a ``hybrid_forward`` (reference†)."""

    def forward(self, inputs, states, *args):
        return HybridBlock.forward(self, inputs, states, *args)


class RNNCell(HybridRecurrentCell):
    """Elman cell ``h' = act(W x + b + R h + r)`` (reference
    ``RNNCell``†)."""

    def __init__(self, hidden_size, activation="tanh", input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", prefix=None, params=None):
        super().__init__(prefix, params)
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
        self.i2h_weight = self._get_param(
            "i2h_weight", (hidden_size, input_size), i2h_weight_initializer)
        self.h2h_weight = self._get_param(
            "h2h_weight", (hidden_size, hidden_size), h2h_weight_initializer)
        self.i2h_bias = self._get_param("i2h_bias", (hidden_size,),
                                        i2h_bias_initializer)
        self.h2h_bias = self._get_param("h2h_bias", (hidden_size,),
                                        h2h_bias_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _infer_params(self, x, *args):
        if self.i2h_weight.shape and self.i2h_weight.shape[1] == 0:
            self.i2h_weight.shape = (self._hidden_size, int(x.shape[-1]))

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        out = F.Activation(i2h + h2h, act_type=self._activation)
        return out, [out]


class LSTMCell(HybridRecurrentCell):
    """LSTM cell, gate order [i, f, g, o] (reference ``LSTMCell``†)."""

    def __init__(self, hidden_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", prefix=None, params=None):
        super().__init__(prefix, params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        H = hidden_size
        self.i2h_weight = self._get_param("i2h_weight", (4 * H, input_size),
                                          i2h_weight_initializer)
        self.h2h_weight = self._get_param("h2h_weight", (4 * H, H),
                                          h2h_weight_initializer)
        self.i2h_bias = self._get_param("i2h_bias", (4 * H,),
                                        i2h_bias_initializer)
        self.h2h_bias = self._get_param("h2h_bias", (4 * H,),
                                        h2h_bias_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _infer_params(self, x, *args):
        if self.i2h_weight.shape and self.i2h_weight.shape[1] == 0:
            self.i2h_weight.shape = (4 * self._hidden_size,
                                     int(x.shape[-1]))

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        H = self._hidden_size
        gates = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                                 num_hidden=4 * H) + \
            F.FullyConnected(states[0], h2h_weight, h2h_bias,
                             num_hidden=4 * H)
        i = F.sigmoid(F.slice_axis(gates, axis=-1, begin=0, end=H))
        f = F.sigmoid(F.slice_axis(gates, axis=-1, begin=H, end=2 * H))
        g = F.tanh(F.slice_axis(gates, axis=-1, begin=2 * H, end=3 * H))
        o = F.sigmoid(F.slice_axis(gates, axis=-1, begin=3 * H, end=4 * H))
        c = f * states[1] + i * g
        h = o * F.tanh(c)
        return h, [h, c]


class GRUCell(HybridRecurrentCell):
    """GRU cell, gate order [r, z, n] (reference ``GRUCell``†)."""

    def __init__(self, hidden_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", prefix=None, params=None):
        super().__init__(prefix, params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        H = hidden_size
        self.i2h_weight = self._get_param("i2h_weight", (3 * H, input_size),
                                          i2h_weight_initializer)
        self.h2h_weight = self._get_param("h2h_weight", (3 * H, H),
                                          h2h_weight_initializer)
        self.i2h_bias = self._get_param("i2h_bias", (3 * H,),
                                        i2h_bias_initializer)
        self.h2h_bias = self._get_param("h2h_bias", (3 * H,),
                                        h2h_bias_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _infer_params(self, x, *args):
        if self.i2h_weight.shape and self.i2h_weight.shape[1] == 0:
            self.i2h_weight.shape = (3 * self._hidden_size,
                                     int(x.shape[-1]))

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        H = self._hidden_size
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=3 * H)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=3 * H)
        ir = F.slice_axis(i2h, axis=-1, begin=0, end=H)
        iz = F.slice_axis(i2h, axis=-1, begin=H, end=2 * H)
        inn = F.slice_axis(i2h, axis=-1, begin=2 * H, end=3 * H)
        hr = F.slice_axis(h2h, axis=-1, begin=0, end=H)
        hz = F.slice_axis(h2h, axis=-1, begin=H, end=2 * H)
        hn = F.slice_axis(h2h, axis=-1, begin=2 * H, end=3 * H)
        r = F.sigmoid(ir + hr)
        z = F.sigmoid(iz + hz)
        n = F.tanh(inn + r * hn)
        out = (1.0 - z) * n + z * states[0]
        return out, [out]


class SequentialRNNCell(RecurrentCell):
    """Stacked cells (reference ``SequentialRNNCell``†)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._modules.values(), batch_size)

    def begin_state(self, **kwargs):
        return _cells_begin_state(self._modules.values(), **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        pos = 0
        for cell in self._modules.values():
            n = len(cell.state_info())
            state = states[pos:pos + n]
            pos += n
            inputs, state = cell(inputs, state)
            next_states.extend(state)
        return inputs, next_states

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, i):
        return list(self._modules.values())[i]

    def forward(self, *args):
        raise MXNetError("use __call__(inputs, states)")


class DropoutCell(HybridRecurrentCell):
    """Dropout on the input stream (reference ``DropoutCell``†)."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix, params)
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states


class ResidualCell(HybridRecurrentCell):
    """A skip connection around a base cell (reference†)."""

    def __init__(self, base_cell):
        super().__init__()
        self.base_cell = base_cell
        self.register_child(base_cell)

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, **kwargs):
        return self.base_cell.begin_state(**kwargs)

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class BidirectionalCell(RecurrentCell):
    """Two cells over opposite time directions, outputs concatenated
    (reference ``BidirectionalCell``†); only through ``unroll``."""

    def __init__(self, l_cell, r_cell):
        super().__init__()
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")

    @property
    def _l_cell(self):
        return self._modules["l_cell"]

    @property
    def _r_cell(self):
        return self._modules["r_cell"]

    def state_info(self, batch_size=0):
        return _cells_state_info([self._l_cell, self._r_cell], batch_size)

    def begin_state(self, **kwargs):
        return _cells_begin_state([self._l_cell, self._r_cell], **kwargs)

    def __call__(self, inputs, states):
        raise MXNetError("BidirectionalCell cannot be stepped; "
                         "use unroll()")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        steps, axis, T = _format_sequence(length, inputs, layout, False)
        F = _ops(steps[0])
        if begin_state is None:
            begin_state = self.begin_state(batch_size=steps[0].shape[0],
                                           func=_zeros_like_step(steps[0]))
        n_l = len(self._l_cell.state_info())
        l_out, l_states = self._l_cell.unroll(
            length, steps, begin_state[:n_l], layout="TNC",
            merge_outputs=False, valid_length=valid_length)
        # the reverse direction: with valid_length each row's valid
        # prefix alone is reversed, so the padding stays at the tail
        if valid_length is not None:
            stacked = F.stack(*steps, axis=0)  # (T, N, C)
            rev = F.SequenceReverse(stacked, valid_length,
                                    use_sequence_length=True)
            rev_steps = [rev[t] for t in range(T)]
        else:
            rev_steps = list(reversed(steps))
        r_out, r_states = self._r_cell.unroll(
            length, rev_steps, begin_state[n_l:], layout="TNC",
            merge_outputs=False, valid_length=valid_length)
        r_stacked = F.stack(*r_out, axis=0)
        if valid_length is not None:
            r_stacked = F.SequenceReverse(r_stacked, valid_length,
                                          use_sequence_length=True)
        else:
            r_stacked = F.SequenceReverse(r_stacked)
        r_out = [r_stacked[t] for t in range(T)]
        outputs = [F.concat(lo, ro, dim=-1) for lo, ro in zip(l_out, r_out)]
        if merge_outputs:
            return F.stack(*outputs, axis=layout.find("T")), \
                l_states + r_states
        return outputs, l_states + r_states
