"""Weight initializers (the counterpart of ``mxtpu/initializer.py``):
the registry, ``InitDesc``, name-pattern dispatch, ``Uniform``,
``Normal``, ``Zero``, ``One``, ``Constant`` and ``Xavier``, plus
gluon's per-parameter defaults for a torch module (:func:`initialize`).

``init(InitDesc(name), arr)`` fills an NDArray as the reference's
Module does: names ending in ``gamma`` or ``*_var`` get ones, ``beta``,
``bias`` or ``*_mean`` zeros, every other array the initializer's own
draw.  Draws come from an explicit ``torch.Generator``: by default
``mxtpu_torch.random.generator(device)``, seeded by
``mxtpu_torch.random.seed`` (:func:`initialize` takes its generator
as given, torch's global one when ``None``).  JAX's random stream has no torch
counterpart, so an array initialized here matches one initialized by
mxtpu in distribution (bounds and spread), not element for element;
exact weights cross with ``convert``.  Not ported yet: ``MSRAPrelu``,
``Orthogonal``, ``Bilinear``, ``LSTMBias``, ``Mixed`` and the
``__init__`` attribute of a parameter.
"""
from __future__ import annotations

import json
import math
from typing import Optional

import torch
from torch import nn

from .base import MXNetError, Registry

__all__ = ["Initializer", "InitDesc", "Uniform", "Normal", "Zero", "One",
           "Constant", "Xavier", "register", "create", "initialize"]

_REGISTRY: Registry = Registry("initializer")


def register(klass=None, *, aliases=()):
    """Register an initializer class under its name, lowercased name and
    ``aliases`` (``Zero`` is also ``"zeros"``)."""
    def _do(k):
        _REGISTRY.register(k.__name__, aliases=tuple(aliases))(k)
        return k
    return _do(klass) if klass is not None else _do


def create(init, **kwargs) -> "Initializer":
    """An initializer from an instance, a name, or the reference's JSON
    form ``'["xavier", {...}]'``; ``None`` is ``Uniform(0.07)``."""
    if isinstance(init, Initializer):
        return init
    if init is None:
        return Uniform(0.07)
    if isinstance(init, str):
        if init.startswith("["):
            name, kw = json.loads(init)
            return _REGISTRY.get(name)(**kw)
        return _REGISTRY.get(init)(**kwargs)
    raise MXNetError(f"cannot create initializer from {init!r}")


class InitDesc(str):
    """A parameter's name plus attrs, passed to initializers (reference
    ``initializer.InitDesc``†)."""

    def __new__(cls, name, attrs=None, global_init=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        obj.global_init = global_init
        return obj


class Initializer:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self) -> str:
        return json.dumps([type(self).__name__.lower(), self._kwargs])

    def __call__(self, desc, arr, generator: Optional[torch.Generator] = None
                 ) -> None:
        """Fill NDArray (or tensor) ``arr`` for the parameter named
        ``desc`` by the name rules, drawing from ``generator`` (default
        ``mxtpu_torch.random.generator`` of the array's device)."""
        t = getattr(arr, "_data", arr)
        if generator is None:
            from . import random
            generator = random.generator(t.device)
        with torch.no_grad():
            self.init_weight(str(desc), t, generator)

    def init_weight(self, name: str, t: torch.Tensor, generator=None):
        if name.endswith("gamma") or name.endswith(("running_var",
                                                    "moving_var")):
            t.fill_(1.0)
        elif name.endswith(("beta", "bias", "running_mean",
                            "moving_mean")):
            t.zero_()
        else:
            self._init_weight(name, t, generator)

    def _init_weight(self, name: str, t: torch.Tensor, generator=None):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}({self._kwargs})"


@register
class Uniform(Initializer):
    def __init__(self, scale: float = 0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, t, generator=None):
        t.uniform_(-self.scale, self.scale, generator=generator)


@register
class Normal(Initializer):
    def __init__(self, sigma: float = 0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, t, generator=None):
        t.normal_(0.0, self.sigma, generator=generator)


@register(aliases=("zeros",))
class Zero(Initializer):
    def _init_weight(self, name, t, generator=None):
        t.zero_()


@register(aliases=("ones",))
class One(Initializer):
    def _init_weight(self, name, t, generator=None):
        t.fill_(1.0)


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, t, generator=None):
        t.fill_(self.value)


@register
class Xavier(Initializer):
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
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
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

    def _init_weight(self, name, t, generator=None):
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
        init.init_weight(name.rsplit(".", 1)[-1], t, generator)
    return net
