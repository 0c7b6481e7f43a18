"""Weight initializers (the counterpart of ``mxtpu/initializer.py``):
the registry, ``InitDesc``, name-pattern dispatch, ``Uniform``,
``Normal``, ``Zero``, ``One``, ``Constant`` and ``Xavier``.

``init(InitDesc(name), arr)`` fills an NDArray as the reference's
Module does: names ending in ``gamma`` or ``*_var`` get ones, ``beta``,
``bias`` or ``*_mean`` zeros, every other array the initializer's own
draw.  Draws come from an explicit ``torch.Generator``: by default
``mxtpu_torch.random.generator(device)``, seeded by
``mxtpu_torch.random.seed``.  JAX's random stream has no torch
counterpart, so an array initialized here matches one initialized by
mxtpu in distribution (bounds and spread), not element for element;
exact weights cross with ``convert``.  A parameter's own initializer
rides in ``InitDesc.attrs["__init__"]`` and bypasses the name rules, as
gluon's ``Parameter`` passes it (``bias_initializer="ones"`` wins over
the bias→zero rule).  Also here: ``MSRAPrelu``, ``Orthogonal`` (the
SVD of a draw from the same generator), ``Bilinear``, ``LSTMBias`` and
``Mixed``.
"""
from __future__ import annotations

import json
import math
import re
from typing import Optional

import torch

from .base import MXNetError, Registry

__all__ = ["Initializer", "InitDesc", "Uniform", "Normal", "Zero", "One",
           "Constant", "Xavier", "MSRAPrelu", "Orthogonal", "Bilinear",
           "LSTMBias", "Mixed", "register", "create"]

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
        specific = desc.attrs.get("__init__", "") \
            if isinstance(desc, InitDesc) else ""
        with torch.no_grad():
            if specific:
                create(specific)._init_weight(str(desc), t, generator)
            else:
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


@register
class MSRAPrelu(Xavier):
    """He et al.'s initialization for PReLU nets: Xavier gaussian with
    magnitude ``2 / (1 + slope^2)``."""

    def __init__(self, factor_type: str = "avg", slope: float = 0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Orthogonal(Initializer):
    """``scale`` times an orthonormal basis: the SVD factor of an
    (out, prod(rest)) draw, uniform in [-1, 1] or standard normal."""

    def __init__(self, scale: float = 1.414, rand_type: str = "uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, t, generator=None):
        nout, nin = t.shape[0], math.prod(t.shape[1:])
        tmp = torch.empty((nout, nin), dtype=torch.float64, device=t.device)
        if self.rand_type == "uniform":
            tmp.uniform_(-1.0, 1.0, generator=generator)
        else:
            tmp.normal_(0.0, 1.0, generator=generator)
        u, _, v = torch.linalg.svd(tmp.cpu(), full_matrices=False)
        q = u if tuple(u.shape) == (nout, nin) else v
        t.copy_((self.scale * q).reshape(t.shape))


@register
class Bilinear(Initializer):
    """Bilinear upsampling weights for a deconvolution (N, C, H, W)."""

    def _init_weight(self, name, t, generator=None):
        shape = t.shape
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        x = torch.arange(shape[3], dtype=torch.float64)
        y = torch.arange(shape[2], dtype=torch.float64)
        wy = (1 - (y / f - c).abs()).reshape(-1, 1)
        wx = (1 - (x / f - c).abs()).reshape(1, -1)
        t.copy_((wy * wx).float().expand(shape))


@register
class LSTMBias(Initializer):
    """Zeros, with the forget gate's quarter (the second of four) at
    ``forget_bias``."""

    def __init__(self, forget_bias: float = 1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, t, generator=None):
        t.zero_()
        h = t.shape[0] // 4
        t[h:2 * h] = self.forget_bias


class Mixed:
    """The first initializer whose pattern matches the name (``re.match``)
    fills the array; no match raises."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise MXNetError("patterns and initializers length mismatch")
        self.map = list(zip([re.compile(p) for p in patterns],
                            initializers))

    def __call__(self, name, arr, generator=None):
        for pat, init in self.map:
            if pat.match(name):
                init(name, arr, generator)
                return
        raise MXNetError(f"no initializer pattern matches {name}")
