"""Gluon ``Block``, ``HybridBlock`` and ``SymbolBlock`` (the counterpart
of ``mxtpu/gluon/block.py``) as ``torch.nn.Module``s.

Naming is mxtpu's: each Block takes a prefix from a per-package counter
of its lowercased class name (``dense0_``), its parameters are named
``prefix + name`` (``dense0_weight``), and ``name_scope()`` is a no-op,
so the names are flat.  ``collect_params()`` lists a Block's own
parameters, then its children's, in registration order; that is
mxtpu's order and the order of an exported ``.params`` file.  Each
initialized parameter is a ``torch.nn.Parameter`` registered on the
Block under its attribute name (see :mod:`.parameter`).

``HybridBlock.forward(*args)`` runs ``hybrid_forward(F, *args,
**params)`` with each parameter's tensor read from the module at call
time.  Eagerly ``F`` is :data:`F`, the registry's torch rules applied
straight to tensors; under :meth:`HybridBlock.export` it is
``mxtpu_torch.symbol``.  An NDArray handed to a HybridBlock is
unwrapped at the boundary and the result rewrapped; the call then runs
with torch's grad mode on only inside ``autograd.record()``, as an nd op
does.  Tensors pass straight through, in whatever grad mode the caller
set (``TrainStep``'s forward, the serving runner's).

Training mode has one source, ``autograd.is_training()``, as in mxtpu:
Dropout, BatchNorm and the fused epilogue read it
(``autograd.record()``, ``autograd.train_mode()``); ``nn.Module.train()``
changes nothing.

``hybridize()`` keeps mxtpu's flags and runs eagerly: mxtpu's cached
program computes what its eager call computes, so outputs and
gradients are the same.

``set_remat(True)`` rematerializes the block's activations: while
torch records a graph (``autograd.record()``, a ``TrainStep``'s
forward) a call runs under ``torch.utils.checkpoint`` (non-reentrant),
which keeps the call's inputs and drops what the block saved for its
backward, and runs the block again in the backward to get it back.
The replay sees what the first run saw: the parameter tensors it read
(a caller may have substituted them, as ``TrainStep``'s casts do
through ``functional_call``), the recording, training and AMP modes,
and the state of the device's two :mod:`mxtpu_torch.random` streams,
so Dropout draws the same mask and the fused epilogue the same key
words; the streams are put back after the replay, where the first run
left them.  A BatchNorm in training mode inside the region raises (its
running statistics would move twice), as mxtpu's ``_forward_remat``
does.  Off the recorded path (no grad, ``export``) the block runs as
it is.
"""
from __future__ import annotations

import contextlib
import re
import threading
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..base import MXNetError, _as_list
from .. import autograd
from ..context import resolve_device
from ..ndarray import _mode
from ..ndarray.ndarray import NDArray
from ..ops import interpose as _interpose
from ..ops.registry import get_op
from .. import symbol as sym_mod
from .parameter import (DeferredInitializationError, Parameter,
                        ParameterDict, _device_of)

__all__ = ["Block", "HybridBlock", "SymbolBlock", "F"]

_NAME_COUNTERS: Dict[str, int] = {}
_NAME_LOCK = threading.Lock()


class _RematDepth(threading.local):
    depth = 0   # > 0 while a rematerialized block's forward runs


_REMAT = _RematDepth()


def in_remat() -> bool:
    """Whether this thread is inside a rematerialized block's forward
    (its first run or its replay in the backward)."""
    return _REMAT.depth > 0


def _gen_prefix(hint: str) -> str:
    with _NAME_LOCK:
        idx = _NAME_COUNTERS.get(hint, 0)
        _NAME_COUNTERS[hint] = idx + 1
    return f"{hint}{idx}_"


# ----------------------------------------------------------------------
# the eager op namespace over tensors
# ----------------------------------------------------------------------
class _TensorOps:
    """``F`` of an eager ``hybrid_forward``: every registered op as its
    torch rule on tensors (parameters resolved once per distinct
    sequence of keyword arguments; inside an AMP or int8 scope the
    pass's replacement, as ``nd``'s dispatch has it), plus the
    key-drawing ``Dropout`` and ``FusedResidualLayerNorm``."""

    def __init__(self):
        self._fns: Dict[str, Callable] = {}

    def _op(self, name: str) -> Callable:
        fn = self._fns.get(name)
        if fn is None:
            fn = self._fns[name] = self._make(name)
        return fn

    def __getattr__(self, name: str) -> Callable:
        if name.startswith("__"):
            raise AttributeError(name)
        fn = self._op(name)
        # an instance attribute from now on: the next F.<name> does not
        # come here (Dropout and FusedResidualLayerNorm, methods of the
        # class, never do)
        self.__dict__[name] = fn
        return fn

    @staticmethod
    def _make(name: str) -> Callable:
        try:
            op = get_op(name)
        except MXNetError:
            raise AttributeError(f"F has no op {name!r}") from None
        rule, cache = op.fn, {}
        if op.num_inputs == 0:
            # no tensor to take a device from: ``ctx`` names it
            def create(ctx=None, **kwargs):
                return rule(**op.resolve_params(kwargs),
                            device=resolve_device(ctx))
            create.__name__ = create.__qualname__ = name
            return create

        def fn(*tensors, **kwargs):
            key = tuple(kwargs.items())
            try:
                resolved = cache.get(key)
                if resolved is None:
                    resolved = cache[key] = op.resolve_params(kwargs)
            except TypeError:   # an unhashable argument (a list)
                resolved = op.resolve_params(kwargs)
            # the int8 and AMP passes, as nd's dispatch has them: off
            # their scopes, one attribute read
            if _interpose.SCOPES.open:
                wrapped = _interpose.wrap_op(name, op, tensors, resolved)
                if wrapped is not None:
                    return wrapped(*tensors)
            return rule(*tensors, **resolved)
        fn.__name__ = fn.__qualname__ = name
        return fn

    def Dropout(self, data, p=0.5, mode=None, axes=()):  # noqa: N802
        if _mode(mode) != "training" or p <= 0.0:
            return data
        return self._op("Dropout")(data, None, p=p, mode="training",
                                   axes=axes)

    dropout = Dropout

    def FusedResidualLayerNorm(self, data, bias, residual, gamma,  # noqa: N802
                               beta, p=0.1, eps=1e-5, mode=None):
        from .. import random as _rnd
        training = _mode(mode) == "training" and p > 0.0
        key = _rnd.key_words(data.device) if training else None
        return self._op("FusedResidualLayerNorm")(
            data, bias, residual, gamma, beta, key, p=p, eps=eps,
            mode="training" if training else "always_off")


F = _TensorOps()


def _is_symbol(x) -> bool:
    return isinstance(x, sym_mod.Symbol)


def _unwrap(x):
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, (list, tuple)):
        return type(x)(_unwrap(v) for v in x)
    return x


def _wrap(x):
    if isinstance(x, torch.Tensor):
        return NDArray(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_wrap(v) for v in x)
    return x


def _has_nd(args) -> bool:
    return any(isinstance(a, NDArray) or
               (isinstance(a, (list, tuple)) and _has_nd(a)) for a in args)


def _flatten(args):
    """The leaves of ``args`` (lists and tuples opened) and the function
    that puts a list of leaves back into its structure."""
    leaves = []

    def walk(a):
        if isinstance(a, (list, tuple)):
            return type(a), [walk(v) for v in a]
        leaves.append(a)
        return None

    tree = [walk(a) for a in args]

    def rebuild(vals):
        it = iter(vals)

        def build(node):
            if node is None:
                return next(it)
            kind, kids = node
            return kind(build(k) for k in kids)
        return tuple(build(n) for n in tree)
    return leaves, rebuild


class _RunState:
    """What a rematerialized block's first run saw: the tensor behind
    each parameter of its subtree, the port's modes and the random
    streams' state.  :meth:`replay` is the context the recompute runs
    in: it puts all three back for the replay and restores the
    caller's afterwards, the streams where the first run left them."""

    def __init__(self, block, streams):
        self.params = [(m, n, t) for m in block.modules()
                       for n, t in m._parameters.items() if t is not None]
        self.modes = (autograd.is_recording(), autograd.is_training(),
                      _interpose.SCOPES.amp)
        self.streams = streams

    @contextlib.contextmanager
    def replay(self, device):
        from .. import random as _rnd
        live = [(m, n, m._parameters[n]) for m, n, _ in self.params]
        modes = (autograd.is_recording(), autograd.is_training(),
                 _interpose.SCOPES.amp)
        streams = _rnd.get_state(device)
        self._set(self.params, self.modes)
        _rnd.set_state(self.streams, device)
        try:
            yield
        finally:
            _rnd.set_state(streams, device)
            self._set(live, modes)

    @staticmethod
    def _set(params, modes):
        for m, n, t in params:
            m._parameters[n] = t
        autograd.set_recording(modes[0])
        autograd.set_training(modes[1])
        _interpose.SCOPES.amp = modes[2]
        _interpose.SCOPES.refresh()


class _NameScope:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


# ----------------------------------------------------------------------
class Block(nn.Module):
    """Base building block (reference ``gluon.Block``†): a
    ``torch.nn.Module`` with mxtpu's names, parameters and
    persistence."""

    def __init__(self, prefix: Optional[str] = None,
                 params: Optional[ParameterDict] = None):
        super().__init__()
        cls = type(self).__name__.lower()
        self._prefix = prefix if prefix is not None else _gen_prefix(cls)
        self._params = ParameterDict(self._prefix, shared=params)
        self._reg_params: Dict[str, Parameter] = {}

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            reg = self.__dict__.get("_reg_params")
            if reg is None:
                raise MXNetError("Block.__init__ must run before a "
                                 "Parameter is assigned")
            reg[name] = value
            value._attach(self, name)
            object.__setattr__(self, name, value)
            return
        super().__setattr__(name, value)

    # -- naming and parameters --------------------------------------------
    @property
    def prefix(self) -> str:
        return self._prefix

    @property
    def name(self) -> str:
        return self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix

    @property
    def params(self) -> ParameterDict:
        return self._params

    def name_scope(self):
        return _NameScope()

    def collect_params(self, select: Optional[str] = None) -> ParameterDict:
        """Every parameter of this Block and its descendants, own first,
        optionally those whose name matches the regex ``select``."""
        out = ParameterDict(self._params.prefix)
        pattern = re.compile(select) if select else None

        def visit(b):
            if isinstance(b, Block):
                for k, v in b._params.items():
                    if (pattern is None or pattern.match(k)) and \
                            k not in out:
                        out._params[k] = v
            for c in b._modules.values():
                if c is not None:
                    visit(c)
        visit(self)
        return out

    def _collect_params_with_prefix(self, prefix: str = ""
                                    ) -> Dict[str, Parameter]:
        """The structural names ``save_parameters`` writes
        (``encoder.layers.0.attn.qkv.weight``): stable across
        instances, unlike the counters."""
        if prefix:
            prefix += "."
        out: Dict[str, Parameter] = {}
        for name, p in self._reg_params.items():
            out[prefix + name] = p
        for cname, child in self._modules.items():
            if isinstance(child, Block):
                out.update(child._collect_params_with_prefix(
                    prefix + cname))
        return out

    # -- lifecycle ----------------------------------------------------------
    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter on ``ctx`` (default the card)."""
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def cast(self, dtype):
        for p in self.collect_params().values():
            p.cast(dtype)

    def register_child(self, block, name=None):
        self.add_module(name or str(len(self._modules)), block)

    # -- persistence --------------------------------------------------------
    def save_parameters(self, filename: str) -> None:
        from ..ndarray.ndarray import save
        params = self._collect_params_with_prefix()
        save(filename, {k: p.data() for k, p in params.items()
                        if p._tensor() is not None})

    def load_parameters(self, filename: str, ctx=None,
                        allow_missing: bool = False,
                        ignore_extra: bool = False,
                        cast_dtype: bool = False) -> None:
        """Load a ``save_parameters`` file (of this package or mxtpu's)
        by structural name, in place; a parameter not initialized yet
        is created on ``ctx`` (default the card)."""
        from ..ndarray import loads
        with open(filename, "rb") as f:
            loaded = loads(f.read())
        if not isinstance(loaded, dict):
            raise MXNetError("invalid parameter file")
        params = self._collect_params_with_prefix()
        for k, p in params.items():
            if k in loaded:
                if p._tensor() is None:
                    p._deferred_init_args = (None, _device_of(ctx), None)
                p.set_data(loaded[k])
            elif not allow_missing:
                raise MXNetError(f"missing parameter {k} in {filename}")
        extra = set(loaded) - set(params)
        if extra and not ignore_extra:
            raise MXNetError(f"extra parameters in file: {sorted(extra)}")

    save_params = save_parameters
    load_params = load_parameters

    # -- call -----------------------------------------------------------------
    def forward(self, *args, **kwargs):
        raise NotImplementedError

    def hybridize(self, active: bool = True, **kwargs):
        """Propagates to the children (a plain Block runs as it is)."""
        for child in self._modules.values():
            if isinstance(child, Block):
                child.hybridize(active, **kwargs)

    def __repr__(self):
        lines = [f"{type(self).__name__}("]
        for key, child in self._modules.items():
            mod = repr(child).replace("\n", "\n  ")
            lines.append(f"  ({key}): {mod}")
        lines.append(")")
        return "\n".join(lines)


class HybridBlock(Block):
    """A Block written as ``hybrid_forward(F, *args, **params)``, which
    runs eagerly on tensors or builds a symbol graph for
    :meth:`export`."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)
        self._active = False
        self._flags: Dict[str, Any] = {}
        self._remat = False
        # every registered parameter has its tensor (see _ensure_init)
        self._settled = False

    def hybridize(self, active: bool = True, static_alloc: bool = False,
                  static_shape: bool = False, **kwargs):
        """Record mxtpu's flags; the block still runs eagerly (see the
        module's docstring)."""
        self._active = active
        self._flags = dict(static_alloc=static_alloc,
                           static_shape=static_shape, **kwargs)
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)

    def set_remat(self, active: bool = True):
        """Rematerialize this block's activations in the backward (see
        the module's docstring): recompute instead of keeping them,
        trading FLOPs for device memory.  For repeated layers
        (transformer cells), not for blocks holding a training-mode
        BatchNorm."""
        self._remat = active
        return self

    def __call__(self, *args, **kwargs):
        if args and self.__dict__.get("_num_inputs") != len(args):
            # recorded for export(), past nn.Module's __setattr__
            self.__dict__["_num_inputs"] = len(args)
        if _has_nd(args) or (kwargs and _has_nd(kwargs.values())):
            with autograd._grad_mode():
                out = self._call(*_unwrap(args),
                                 **{k: _unwrap(v)
                                    for k, v in kwargs.items()})
            return _wrap(out)
        return self._call(*args, **kwargs)

    def _call(self, *args, **kwargs):
        if self._remat and torch.is_grad_enabled() and \
                not (args and _is_symbol(args[0])):
            return self._forward_remat(args, kwargs)
        return super().__call__(*args, **kwargs)

    def _forward_remat(self, args, kwargs):
        """The call under ``torch.utils.checkpoint``, its replay given
        the first run's parameters, modes and random streams."""
        from torch.utils.checkpoint import checkpoint
        from .. import random as _rnd
        leaves, rebuild = _flatten(args)
        at = [i for i, a in enumerate(leaves)
              if isinstance(a, torch.Tensor)]
        if not at:
            raise MXNetError(
                f"{type(self).__name__}.set_remat: no tensor inputs to "
                f"checkpoint; remat cannot engage on this call (disable "
                f"remat on this block or pass tensor inputs)")
        device = leaves[at[0]].device
        first = _RunState(self, _rnd.get_state(device))

        def run(*tensors):
            full = list(leaves)
            for i, t in zip(at, tensors):
                full[i] = t
            _REMAT.depth += 1
            try:
                return nn.Module.__call__(self, *rebuild(full), **kwargs)
            finally:
                _REMAT.depth -= 1

        def contexts():
            return contextlib.nullcontext(), first.replay(device)

        return checkpoint(run, *(leaves[i] for i in at),
                          use_reentrant=False, context_fn=contexts)

    def forward(self, *args, **kwargs):
        if args and _is_symbol(args[0]):
            # the F-switch: the same hybrid_forward builds a graph, the
            # parameters as variables named like them
            pvals = {name: sym_mod.var(p.name)
                     for name, p in self._reg_params.items()}
            return self.hybrid_forward(sym_mod, *args, **pvals, **kwargs)
        if not self._settled:
            self._ensure_init(*args)
        params = self._parameters
        pvals = {name: params[name] for name in self._reg_params}
        return self.hybrid_forward(F, *args, **pvals, **kwargs)

    def hybrid_forward(self, F, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} must implement hybrid_forward or "
            f"override forward")

    # -- deferred shape inference ---------------------------------------
    def infer_shape(self, *args) -> None:
        self._infer_params(*args)

    def _infer_params(self, *args) -> None:
        return None

    def _ensure_init(self, *args) -> None:
        # forward calls it until every parameter has its tensor; then
        # only a Parameter attached without one (Parameter._attach)
        # brings it back
        params = self._parameters
        deferred = [p for n, p in self._reg_params.items()
                    if params.get(n) is None]
        if deferred:
            self._infer_params(*args)
            dev = next((a.device for a in args
                        if isinstance(a, torch.Tensor)), None)
            for p in deferred:
                if p._deferred_init_args is None:
                    raise DeferredInitializationError(
                        f"parameter {p.name} of {self.name} is not "
                        f"initialized; call initialize() first")
                p._finish_deferred_init(dev)
        self._settled = True

    # -- deployment -------------------------------------------------------
    def export(self, path: str, epoch: int = 0):
        """Write ``path-symbol.json`` (the graph of ``hybrid_forward``
        with ``F = sym``) and ``path-%04d.params`` (``arg:``/``aux:``
        tagged arrays in the MXNet format)."""
        from ..ndarray.ndarray import save
        from ..symbol import _is_aux_name
        params = self.collect_params()
        if any(p._tensor() is None for p in params.values()):
            raise MXNetError(
                "export() needs initialized parameters — run a forward "
                "pass first")
        n_in = getattr(self, "_num_inputs", 1)
        ins = [sym_mod.var("data" if n_in == 1 else f"data{i}")
               for i in range(n_in)]
        out = self(*ins)
        sym = out if isinstance(out, sym_mod.Symbol) \
            else sym_mod.Group(list(out))
        sym.save(f"{path}-symbol.json")
        arrays = {("aux:" if _is_aux_name(p.name) else "arg:") + p.name:
                  p.data() for p in params.values()}
        save(f"{path}-{epoch:04d}.params", arrays)
        return f"{path}-symbol.json", f"{path}-{epoch:04d}.params"


class SymbolBlock(HybridBlock):
    """A symbol graph and its parameters as a block (reference
    ``SymbolBlock``†), evaluated by the port's symbol interpreter."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix="symbolblock_")
        self._outputs = outputs
        self._inputs = inputs if isinstance(inputs, (list, tuple)) \
            else [inputs]
        for k, v in (params or {}).items():
            self._add_param(k, v)

    def _add_param(self, name: str, p: Parameter) -> None:
        self._params._params[name] = p
        p._attach(self, name)

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """Load an ``export``ed graph and its ``.params`` (of this
        package or mxtpu's) onto ``ctx`` (default the card)."""
        from ..ndarray import loads
        from ..symbol import load as sym_load, var as sym_var
        sym = sym_load(symbol_file)
        inputs = [sym_var(n) if isinstance(n, str) else n
                  for n in _as_list(input_names)]
        blk = SymbolBlock(sym, inputs)
        if param_file:
            with open(param_file, "rb") as f:
                loaded = loads(f.read())
            dev = _device_of(ctx)
            for k, v in loaded.items():
                name = k.split(":", 1)[-1]
                p = Parameter(name, shape=np.shape(v),
                              grad_req="null" if k.startswith("aux:")
                              else "write")
                p._deferred_init_args = (None, dev, None)
                blk._add_param(name, p)
                p.set_data(v)
        return blk

    def forward(self, *args):
        from ..symbol import _eval_symbol
        bindings = {inp.name: NDArray(val) for inp, val in
                    zip(self._inputs, args)}
        for name, p in self._params.items():
            bindings[name] = p.data()
        outs = [o._data for o in _eval_symbol(self._outputs, bindings)]
        return outs[0] if len(outs) == 1 else outs

