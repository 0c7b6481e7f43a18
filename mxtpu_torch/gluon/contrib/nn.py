"""Contrib layers (the counterpart of ``mxtpu/gluon/contrib/nn.py``):
``Concurrent``, ``HybridConcurrent``, ``Identity`` and ``MoEDense``.

``MoEDense`` is the Switch-MoE feed-forward on the ``_contrib_MoEFFN``
op (:mod:`mxtpu_torch.parallel.moe` is its core): on the card it runs
the route, dispatch and combine kernels.  It returns ``(y, aux)``:
compose the load-balancing loss into the training loss (``loss = task +
alpha * aux``).  ``in_units`` left 0 is inferred at the first forward.
Its parameters carry mxtpu's names, so its weights cross in the
``.params`` format as the other Gluon blocks' do.
"""
from __future__ import annotations

import torch

from ...ndarray.ndarray import NDArray
from ..block import HybridBlock
from ..nn import HybridSequential, Sequential

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "MoEDense"]


def _concat(outs, axis):
    if isinstance(outs[0], NDArray):
        from ... import ndarray as nd_mod
        return nd_mod.concat(*outs, dim=axis)
    return torch.cat(outs, dim=axis)


class Concurrent(Sequential):
    """Runs every child on the same input and concatenates their
    outputs along ``axis``."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        return _concat([block(x) for block in self._modules.values()],
                       self.axis)


class HybridConcurrent(HybridSequential):
    """Hybridizable :class:`Concurrent`: ``F.concat`` of the children's
    outputs, so it also builds the graph ``export`` writes."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def hybrid_forward(self, F, x):
        return F.concat(*[block(x) for block in self._modules.values()],
                        dim=self.axis)

    def forward(self, x):
        from ... import symbol as sym_mod
        if isinstance(x, sym_mod.Symbol):
            return self.hybrid_forward(sym_mod, x)
        return _concat([block(x) for block in self._modules.values()],
                       self.axis)


class Identity(HybridBlock):
    """Returns its input."""

    def hybrid_forward(self, F, x):
        return x


class MoEDense(HybridBlock):
    """Switch-MoE feed-forward layer: ``num_experts`` FFNs (``in_units``
    -> ``hidden`` -> ``units``), top-1 routing with capacity factor
    ``capacity_factor``, ``activation`` relu, gelu (tanh form) or
    tanh."""

    def __init__(self, units, hidden, num_experts, capacity_factor=1.25,
                 activation="relu", weight_initializer=None, in_units=0,
                 prefix=None, params=None):
        super().__init__(prefix, params)
        self._units = units
        self._hidden = hidden
        self._E = num_experts
        self._cf = capacity_factor
        self._act = activation
        self.gate_weight = self.params.get(
            "gate_weight", shape=(in_units, num_experts),
            init=weight_initializer, allow_deferred_init=True)
        self.expert_w1 = self.params.get(
            "expert_w1", shape=(num_experts, in_units, hidden),
            init=weight_initializer, allow_deferred_init=True)
        self.expert_b1 = self.params.get(
            "expert_b1", shape=(num_experts, hidden), init="zeros",
            allow_deferred_init=True)
        self.expert_w2 = self.params.get(
            "expert_w2", shape=(num_experts, hidden, units),
            init=weight_initializer, allow_deferred_init=True)
        self.expert_b2 = self.params.get(
            "expert_b2", shape=(num_experts, units), init="zeros",
            allow_deferred_init=True)

    def _infer_params(self, x, *args):
        d = int(x.shape[-1])
        if self.gate_weight.shape and self.gate_weight.shape[0] == 0:
            self.gate_weight.shape = (d, self._E)
            self.expert_w1.shape = (self._E, d, self._hidden)

    def hybrid_forward(self, F, x, gate_weight, expert_w1, expert_b1,
                       expert_w2, expert_b2):
        return F._contrib_MoEFFN(
            x, gate_weight, expert_w1, expert_b1, expert_w2, expert_b2,
            capacity_factor=self._cf, activation=self._act)

    def __repr__(self):
        return (f"MoEDense({self._E} experts, "
                f"hidden={self._hidden} -> {self._units}, "
                f"{self._act})")
