"""Fused recurrent layers (the counterpart of
``mxtpu/gluon/rnn/rnn_layer.py``; reference
``python/mxnet/gluon/rnn/rnn_layer.py``†: ``RNN``/``LSTM``/``GRU`` over
the fused ``RNN`` op).

Parameters are stored per layer and direction (``l0_i2h_weight``,
``r0_h2h_bias``, ...), so ``save_parameters`` writes mxtpu's structural
names, and ``hybrid_forward`` concatenates them into the op's flat
vector in mxtpu's order: weights by (layer, direction), then biases.
On the card the op runs each LSTM or GRU layer and direction as one
persistent scan launch each way (per-step cell kernels past that
kernel's limits; :mod:`mxtpu_torch.ndarray.rnn_impl`).

Without states the eager call starts from zeros on the input's device,
in its type.  On a Symbol the zero states become graph inputs named
``<prefix>begin_state_<i>``, as in mxtpu, whose shapes ``infer_shape``
cannot find (mxtpu's ``Module.bind`` fails the same way).
"""
from __future__ import annotations

import warnings

import torch

from ...base import MXNetError
from ... import autograd
from ... import ndarray as nd_mod
from ...ndarray import rnn_impl
from ..block import HybridBlock

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    """Base fused layer (reference ``_RNNLayer``†)."""

    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, prefix=None, params=None):
        super().__init__(prefix, params)
        if layout not in ("TNC", "NTC"):
            raise MXNetError(f"layout must be TNC or NTC, got {layout}")
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._mode = mode
        self._gates = rnn_impl._GATES[mode]
        G, H = self._gates, hidden_size
        ng, ni, nh = G * H, input_size, hidden_size
        for i in range(num_layers):
            for j in self._dirs():
                self._register_param(f"{j}{i}_i2h_weight", (ng, ni),
                                     i2h_weight_initializer)
                self._register_param(f"{j}{i}_h2h_weight", (ng, nh),
                                     h2h_weight_initializer)
                self._register_param(f"{j}{i}_i2h_bias", (ng,),
                                     i2h_bias_initializer)
                self._register_param(f"{j}{i}_h2h_bias", (ng,),
                                     h2h_bias_initializer)
            ni = nh * self._dir
        # the flat vector's order: weights by (layer, direction), then
        # biases
        self._order = [f"{j}{i}_{w}_{kind}" for kind in ("weight", "bias")
                       for i in range(num_layers) for j in self._dirs()
                       for w in ("i2h", "h2h")]

    def _dirs(self):
        return ["l", "r"] if self._dir == 2 else ["l"]

    def _register_param(self, name, shape, init):
        p = self.params.get(name, shape=shape, init=init,
                            allow_deferred_init=True)
        setattr(self, name, p)

    def __repr__(self):
        s = (f"{type(self).__name__}({self._input_size or '?'} -> "
             f"{self._hidden_size}, {self._layout}")
        if self._num_layers != 1:
            s += f", num_layers={self._num_layers}"
        if self._dropout:
            s += f", dropout={self._dropout}"
        if self._dir == 2:
            s += ", bidirectional"
        return s + ")"

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zero states (``func(shape, **kwargs)``, default ``nd.zeros``:
        the card unless ``ctx=`` says otherwise)."""
        if func is None:
            func = nd_mod.zeros
        states = []
        for info in self.state_info(batch_size):
            info = dict(info)
            shape = info.pop("shape")
            info.pop("__layout__", None)
            states.append(func(shape, **kwargs))
        return states

    def _infer_params(self, x, *args):
        if self._input_size == 0:
            ni = int(x.shape[-1])
            self._input_size = ni
            G, H = self._gates, self._hidden_size
            for j in self._dirs():
                p = getattr(self, f"{j}0_i2h_weight")
                if p.shape and p.shape[1] == 0:
                    p.shape = (G * H, ni)

    def hybrid_forward(self, F, inputs, states=None, **params):
        """inputs: (T, N, C) for TNC, (N, T, C) for NTC; states
        optional (without them only the output is returned)."""
        skip_states = states is None
        sym_mode = not hasattr(inputs, "shape")  # Symbol composition
        if self._layout == "NTC":
            inputs = F.transpose(inputs, axes=(1, 0, 2))
        if skip_states:
            if sym_mode:
                # zero initial states become named graph inputs, as the
                # label of SoftmaxOutput does
                states = [F.var(f"{self.prefix}begin_state_{i}")
                          for i in range(len(self.state_info(0)))]
            else:
                states = [torch.zeros(info["shape"], dtype=inputs.dtype,
                                      device=inputs.device)
                          for info in self.state_info(inputs.shape[1])]
        if not isinstance(states, (list, tuple)):
            states = [states]
        flat = F.concat(*[F.reshape(params[n], shape=(-1,))
                          for n in self._order], dim=0)
        op_inputs = [inputs, flat] + list(states)
        training = autograd.is_training()
        if self._dropout > 0 and training and not sym_mode:
            # mxtpu's key input; the mask comes from mxtpu_torch.random's
            # generator of the input's device
            from ... import random as _rnd
            op_inputs.append(torch.tensor(_rnd.key_words(inputs.device),
                                          dtype=torch.int64))
        elif self._dropout > 0 and sym_mode and training:
            warnings.warn(
                "inter-layer RNN dropout is inactive in symbolic graphs "
                "(no PRNG key input); train through the eager/hybridize "
                "path for dropout", stacklevel=2)
        out = F.RNN(*op_inputs, state_size=self._hidden_size,
                    num_layers=self._num_layers, mode=self._mode,
                    bidirectional=self._dir == 2, p=self._dropout,
                    state_outputs=True)
        out, states_out = out[0], list(out[1:])
        if self._layout == "NTC":
            out = F.transpose(out, axes=(1, 0, 2))
        if skip_states:
            return out
        return out, states_out


class RNN(_RNNLayer):
    """Multi-layer Elman RNN (reference ``rnn.RNN``†)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         "rnn_" + activation, prefix, params)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    """Multi-layer LSTM (reference ``rnn.LSTM``†)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC",
                 dropout=0, bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", prefix=None, params=None):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         "lstm", prefix, params)

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size,
                 self._hidden_size)
        return [{"shape": shape, "__layout__": "LNC"},
                {"shape": shape, "__layout__": "LNC"}]


class GRU(_RNNLayer):
    """Multi-layer GRU (reference ``rnn.GRU``†)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC",
                 dropout=0, bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", prefix=None, params=None):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         "gru", prefix, params)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
