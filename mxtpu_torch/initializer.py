"""Weight initialization (the counterpart of ``mxtpu/initializer.py``):
the ``Xavier`` initializer and gluon's per-parameter defaults.

The draws come from an explicit ``torch.Generator``; JAX's random
stream has no torch counterpart, so a net initialized here matches one
initialized by mxtpu in distribution (bounds and spread per tensor),
not element for element.  Exact weights cross with
``convert.params_from_mxtpu``.  Not ported yet: the other initializers
(``Uniform``, ``Normal``, ``MSRAPrelu``, ``Orthogonal``, ...), the
registry and JSON serialization.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .base import MXNetError

__all__ = ["Xavier", "initialize"]


class Xavier:
    """Xavier/Glorot: uniform in ±sqrt(magnitude / factor) or normal
    with that std, where factor is the mean of fan_in and fan_out
    (``"avg"``), fan_in (``"in"``) or fan_out (``"out"``), computed from
    the stored shape as the reference does: fan_in = shape[1] * prod(
    shape[2:]) and fan_out = shape[0] * prod(shape[2:])."""

    def __init__(self, rnd_type: str = "uniform", factor_type: str = "avg",
                 magnitude: float = 3):
        if rnd_type not in ("uniform", "gaussian"):
            raise MXNetError(f"Xavier rnd_type must be 'uniform' or "
                             f"'gaussian', got {rnd_type!r}")
        if factor_type not in ("avg", "in", "out"):
            raise MXNetError(f"Xavier factor_type must be 'avg', 'in' or "
                             f"'out', got {factor_type!r}")
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = magnitude

    def scale(self, shape) -> float:
        if len(shape) < 2:
            raise MXNetError(f"Xavier requires ndim >= 2, got shape "
                             f"{tuple(shape)}")
        hw = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw, shape[0] * hw
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        return math.sqrt(self.magnitude / factor)

    @torch.no_grad()
    def __call__(self, t: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> None:
        s = self.scale(t.shape)
        if self.rnd_type == "uniform":
            t.uniform_(-s, s, generator=generator)
        else:
            t.normal_(0.0, s, generator=generator)


@torch.no_grad()
def initialize(net: nn.Module, init=None,
               generator: Optional[torch.Generator] = None) -> nn.Module:
    """Initialize every parameter and buffer of ``net`` in place by name,
    as gluon's defaults do: names ending in ``gamma`` or
    ``running_var`` get ones, ``beta``, ``bias`` or ``running_mean``
    zeros, and every other tensor (convolution and dense weights,
    embeddings) the initializer ``init`` (default ``Xavier()``), drawn
    from ``generator``.  Returns the net."""
    init = Xavier() if init is None else init
    for name, t in [*net.named_parameters(), *net.named_buffers()]:
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("gamma", "running_var"):
            t.fill_(1.0)
        elif leaf in ("beta", "bias", "running_mean"):
            t.zero_()
        else:
            init(t, generator)
    return net
