"""Gluon ``Parameter``, ``Constant`` and ``ParameterDict`` (the
counterpart of ``mxtpu/gluon/parameter.py``).

A :class:`Parameter` keeps the metadata: its name, shape (0 for a size
not known yet), dtype, initializer, ``grad_req``, ``lr_mult``,
``wd_mult`` and whether its initialization may wait for a forward
(deferred shape inference).  Once its shape is known and it is
initialized, its data is one ``torch.nn.Parameter``, registered on
every Block that owns it under the attribute name (a ``grad_req="null"``
parameter, such as BatchNorm's running statistics, with
``requires_grad=False``).  So ``named_parameters()``, ``.to()`` and
``torch.func.functional_call`` see it, and a Block reads the tensor
through the module at call time.

``data()`` and ``grad()`` are NDArrays over the registered tensor and
its ``.grad``; ``set_data`` writes in place; ``cast`` changes the
registered tensor's dtype.  Gradients follow ``grad_req``: ``"write"``
makes each backward of :func:`mxtpu_torch.autograd.backward` replace
the gradient (a hook clears the stale one before torch accumulates),
``"add"`` accumulates, ``"null"`` keeps none.

Initialization runs ``initializer.InitDesc``: a parameter's own ``init``
wins, else the global initializer dispatches by name suffix; draws come
from ``mxtpu_torch.random``'s generator of the parameter's device.
``initialize`` defaults to the card, as every entry point of the port.
"""
from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..base import MXNetError
from ..context import resolve_device
from .. import autograd
from .. import initializer as init_mod
from ..ndarray.ndarray import NDArray, torch_dtype

__all__ = ["Parameter", "ParameterDict", "Constant",
           "DeferredInitializationError"]


class DeferredInitializationError(MXNetError):
    """Raised when .data() is called before shapes are known."""


def _device_of(ctx) -> torch.device:
    if isinstance(ctx, (list, tuple)):
        ctx = ctx[0] if ctx else None
    return resolve_device(ctx)


def _as_tensor(data) -> torch.Tensor:
    if isinstance(data, NDArray):
        return data._data.detach()
    if isinstance(data, torch.Tensor):
        return data.detach()
    a = np.asarray(data)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.tensor(a)


class Parameter:
    """A named, lazily shaped weight (reference ``gluon.Parameter``†)."""

    def __init__(self, name: str, grad_req: str = "write", shape=None,
                 dtype="float32", lr_mult: float = 1.0,
                 wd_mult: float = 1.0, init=None,
                 allow_deferred_init: bool = False,
                 differentiable: bool = True, stype: str = "default",
                 grad_stype: str = "default"):
        self.name = name
        self._grad_req = grad_req if differentiable else "null"
        if self._grad_req not in ("write", "add", "null"):
            raise MXNetError(f"invalid grad_req {grad_req}")
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._differentiable = differentiable
        self.stype = stype
        self.grad_stype = grad_stype
        self._var: Optional[nn.Parameter] = None
        self._owners: List[Tuple["weakref.ref", str]] = []
        self._deferred_init_args = None
        self._grad_gen = -1

    # -- registration on Blocks -------------------------------------------
    def _attach(self, block: nn.Module, attr: str) -> None:
        """Record ``block`` as an owner under ``attr``; the tensor, or an
        empty slot that keeps the registration order, goes into its
        ``_parameters``."""
        self._owners.append((weakref.ref(block), attr))
        block._parameters[attr] = self._var
        if self._var is None:
            block._settled = False   # its next forward looks again

    def _tensor(self) -> Optional[torch.Tensor]:
        """The tensor the first live owner holds (a substitute inside
        ``functional_call``), else the Parameter's own."""
        for ref, attr in self._owners:
            block = ref()
            if block is not None:
                t = block._parameters.get(attr)
                if t is not None:
                    return t
        return self._var

    def _set_var(self, t: torch.Tensor) -> None:
        var = nn.Parameter(t, requires_grad=self._grad_req != "null")
        if var.requires_grad:
            var.register_hook(self._on_grad)
        self._var = var
        for ref, attr in self._owners:
            block = ref()
            if block is not None:
                block._parameters[attr] = var

    def _on_grad(self, g):
        # "write": the first time a backward reaches this parameter, the
        # gradient of the previous backward goes, so torch's
        # accumulation writes a fresh one
        gen = autograd._BACKWARD_GEN[0]
        if self._grad_gen != gen:
            self._grad_gen = gen
            if self._grad_req == "write" and self._var is not None:
                self._var.grad = None
        return None

    # ------------------------------------------------------------------
    @property
    def grad_req(self) -> str:
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req: str) -> None:
        if req not in ("write", "add", "null"):
            raise MXNetError(f"invalid grad_req {req}")
        self._grad_req = req
        if self._var is not None:
            self._var.requires_grad_(req != "null")
            if req == "null":
                self._var.grad = None

    def _shape_is_known(self) -> bool:
        return self.shape is not None and all(s > 0 for s in self.shape)

    # ------------------------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit: bool = False) -> None:
        """Initialize on ``ctx`` (default the card): now if the shape is
        known, else at the first forward when deferred init is
        allowed."""
        if self._var is not None and not force_reinit:
            return
        dev = _device_of(ctx)
        if not self._shape_is_known():
            if self.allow_deferred_init:
                self._deferred_init_args = (init, dev, default_init)
                return
            raise MXNetError(
                f"cannot initialize parameter {self.name}: shape "
                f"{self.shape} not fully known and deferred init not "
                f"allowed")
        self._do_init(init, dev, default_init)

    def _do_init(self, init, dev, default_init) -> None:
        # a parameter-specific init rides in InitDesc attrs and bypasses
        # the global initializer's name-suffix dispatch
        specific = init if init is not None else self.init
        global_init = init_mod.create(
            default_init if default_init is not None else "uniform")
        attrs = {"__init__": specific} if specific is not None else {}
        desc = init_mod.InitDesc(self.name, attrs)
        self._deferred_init_args = None
        if self._var is not None and \
                tuple(self._var.shape) == tuple(self.shape):
            # force_reinit: in place, so every holder keeps the tensor
            global_init(desc, self._var.data)
            return
        t = torch.zeros(self.shape, dtype=torch_dtype(self.dtype),
                        device=dev)
        global_init(desc, t)
        self._set_var(t)

    def _finish_deferred_init(self, device=None) -> None:
        """Initialize a deferred parameter whose shape is now known, on
        ``device`` (the device of the input that gave the shape) or the
        one ``initialize`` was given."""
        if self._var is not None:
            return
        if self._deferred_init_args is None:
            raise DeferredInitializationError(
                f"parameter {self.name} was never initialize()d")
        init, dev, default_init = self._deferred_init_args
        if not self._shape_is_known():
            raise MXNetError(
                f"deferred init of {self.name} could not infer shape "
                f"{self.shape}")
        self._do_init(init, dev if device is None else device,
                      default_init)

    # ------------------------------------------------------------------
    def _checked(self) -> torch.Tensor:
        t = self._tensor()
        if t is None:
            if self._deferred_init_args is not None:
                raise DeferredInitializationError(
                    f"parameter {self.name} deferred; run a forward pass "
                    f"or call initialize() with a known shape")
            raise MXNetError(f"parameter {self.name} not initialized; "
                             f"call .initialize() first")
        return t

    def data(self, ctx=None) -> NDArray:
        return NDArray(self._checked())

    def list_data(self) -> List[NDArray]:
        return [self.data()]

    def list_ctx(self):
        return [self._checked().device]

    def grad(self, ctx=None) -> NDArray:
        t = self._checked()
        if self._grad_req == "null":
            raise MXNetError(f"parameter {self.name} has grad_req='null'")
        if t.grad is None:
            # as attach_grad: a zero gradient until a backward writes one
            t.grad = torch.zeros_like(t)
        return NDArray(t.grad)

    def list_grad(self) -> List[NDArray]:
        return [self.grad()]

    def zero_grad(self) -> None:
        t = self._tensor()
        if t is not None and t.grad is not None:
            t.grad.zero_()

    def set_data(self, data) -> None:
        """Write ``data`` into the parameter in place; an uninitialized
        parameter takes ``data``'s shape and lives on its device."""
        src = _as_tensor(data)
        t = self._tensor()
        if t is None:
            self.shape = tuple(src.shape)
            dev = self._deferred_init_args[1] \
                if self._deferred_init_args is not None else src.device
            self._set_var(src.to(dev, torch_dtype(self.dtype), copy=True))
            self._deferred_init_args = None
            return
        if tuple(src.shape) != tuple(t.shape):
            raise MXNetError(f"set_data: {self.name} has shape "
                             f"{tuple(t.shape)}, got {tuple(src.shape)}")
        with torch.no_grad():
            t.copy_(src)

    def cast(self, dtype) -> None:
        self.dtype = dtype if isinstance(dtype, str) else \
            str(torch_dtype(dtype)).replace("torch.", "")
        if self._var is not None:
            with torch.no_grad():
                self._var.data = self._var.data.to(torch_dtype(dtype))
            self._var.grad = None

    def reset_ctx(self, ctx) -> None:
        if self._var is not None:
            with torch.no_grad():
                self._var.data = self._var.data.to(_device_of(ctx))
            self._var.grad = None

    def var(self):
        from ..symbol import var
        return var(self.name, shape=self.shape, dtype=self.dtype)

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self.shape}, "
                f"dtype={self.dtype})")


class Constant(Parameter):
    """A parameter that is not learned (reference ``gluon.Constant``†)."""

    def __init__(self, name, value):
        t = _as_tensor(value)
        super().__init__(name, grad_req="null", shape=tuple(t.shape),
                         dtype=str(t.dtype).replace("torch.", ""),
                         init=init_mod.Constant(0), differentiable=False)
        self._value = t

    def _do_init(self, init, dev, default_init):
        self._set_var(self._value.to(dev, copy=True))


class ParameterDict:
    """Prefix-namespaced dict of Parameters with sharing (reference
    ``gluon.ParameterDict``†)."""

    def __init__(self, prefix: str = "",
                 shared: Optional["ParameterDict"] = None):
        self._prefix = prefix
        self._params: "OrderedDict[str, Parameter]" = OrderedDict()
        self._shared = shared

    @property
    def prefix(self) -> str:
        return self._prefix

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __contains__(self, name):
        return name in self._params

    def __getitem__(self, name) -> Parameter:
        return self._params[name]

    def __repr__(self):
        lines = "\n".join(f"  {v}" for v in self._params.values())
        return f"ParameterDict '{self._prefix}' (\n{lines}\n)"

    def get(self, name: str, **kwargs) -> Parameter:
        """Get or create ``prefix + name`` (the shared dict first)."""
        full = self._prefix + name
        if full in self._params:
            param = self._params[full]
            for k, v in kwargs.items():
                if v is not None and getattr(param, k, None) in (None, 0):
                    setattr(param, k, v)
            return param
        if self._shared is not None and full in self._shared:
            param = self._shared[full]
            self._params[full] = param
            return param
        param = Parameter(full, **kwargs)
        self._params[full] = param
        return param

    def get_constant(self, name: str, value=None) -> Constant:
        full = self._prefix + name
        if full in self._params:
            return self._params[full]
        c = Constant(full, value)
        self._params[full] = c
        return c

    def update(self, other: "ParameterDict") -> None:
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError(f"parameter name clash on {k}")
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False) -> None:
        for p in self._params.values():
            p.initialize(init=None, ctx=ctx, default_init=init,
                         force_reinit=force_reinit)

    def zero_grad(self) -> None:
        for p in self._params.values():
            p.zero_grad()

    def setattr(self, name, value) -> None:
        for p in self._params.values():
            setattr(p, name, value)

    def reset_ctx(self, ctx) -> None:
        for p in self._params.values():
            p.reset_ctx(ctx)

    # ------------------------------------------------------------------
    def save(self, filename: str, strip_prefix: str = "") -> None:
        from ..ndarray.ndarray import save
        arg = {}
        for name, p in self._params.items():
            if p._tensor() is None:
                continue
            key = name[len(strip_prefix):] \
                if name.startswith(strip_prefix) else name
            arg[key] = p.data()
        save(filename, arg)

    def load(self, filename: str, ctx=None, allow_missing: bool = False,
             ignore_extra: bool = False, restore_prefix: str = "") -> None:
        from ..ndarray import loads
        with open(filename, "rb") as f:
            loaded = loads(f.read())
        if not isinstance(loaded, dict):
            raise MXNetError("parameter file must hold a name->array dict")
        loaded = {restore_prefix + k: v for k, v in loaded.items()}
        for name, p in self._params.items():
            if name in loaded:
                if ctx is not None and p._tensor() is None:
                    p._deferred_init_args = (None, _device_of(ctx), None)
                p.set_data(loaded[name])
            elif not allow_missing:
                raise MXNetError(f"parameter {name} missing in {filename}")
        if not ignore_extra:
            extra = set(loaded) - set(self._params)
            if extra:
                raise MXNetError(
                    f"file {filename} has extra parameters {sorted(extra)}")
