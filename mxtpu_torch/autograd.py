"""Autograd — the imperative record/backward API over torch autograd
(the counterpart of ``mxtpu/autograd.py``).

``record()``/``pause()`` and ``train_mode()``/``predict_mode()`` keep
the reference's thread-local flags.  NDArray ops run with torch's grad
mode on only while recording, so torch autograd builds the graph the
JAX package keeps on its tape.  ``attach_grad`` makes an NDArray's
tensor a leaf that requires grad; :func:`backward` runs
``torch.autograd.backward`` and moves each leaf's gradient into its
``.grad`` by ``grad_req`` (``"write"`` replaces, ``"add"``
accumulates).  :class:`Function` is a ``torch.autograd.Function``
underneath.
"""
from __future__ import annotations

import threading
import weakref
from typing import Dict, Optional

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "backward",
           "grad", "mark_variables", "Function"]


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_STATE = _State()
# every live NDArray that attach_grad (or mark_variables) made a leaf,
# by id (NDArray is unhashable, like the reference's)
_LEAVES: Dict[int, "weakref.ref"] = {}  # guarded-by: _LEAVES_LOCK
_LEAVES_LOCK = threading.Lock()
# one count per :func:`backward`: a gluon Parameter with grad_req
# "write" clears its gradient the first time a backward reaches it
_BACKWARD_GEN = [0]


def is_recording() -> bool:
    return _STATE.recording


def is_training() -> bool:
    return _STATE.training


def set_recording(is_rec: bool) -> bool:
    prev, _STATE.recording = _STATE.recording, is_rec
    return prev


def set_training(train: bool) -> bool:
    prev, _STATE.training = _STATE.training, train
    return prev


class _Scope:
    def __init__(self, recording: Optional[bool], training: Optional[bool]):
        self._rec, self._train = recording, training

    def __enter__(self):
        if self._rec is not None:
            self._prev_rec = set_recording(self._rec)
        if self._train is not None:
            self._prev_train = set_training(self._train)
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            set_recording(self._prev_rec)
        if self._train is not None:
            set_training(self._prev_train)


def record(train_mode: bool = True) -> _Scope:
    return _Scope(True, train_mode)


def pause(train_mode: bool = False) -> _Scope:
    return _Scope(False, train_mode)


def train_mode() -> _Scope:
    return _Scope(None, True)


def predict_mode() -> _Scope:
    return _Scope(None, False)


def _grad_mode():
    """torch's grad mode for an NDArray op: on while recording."""
    return torch.enable_grad() if _STATE.recording else torch.no_grad()


def _track(nd) -> None:
    key = id(nd)

    def _gone(ref, key=key):
        with _LEAVES_LOCK:
            if _LEAVES.get(key) is ref:
                del _LEAVES[key]
    with _LEAVES_LOCK:
        _LEAVES[key] = weakref.ref(nd, _gone)


def mark_variables(variables, gradients, grad_reqs="write") -> None:
    """Make ``variables`` gradient leaves whose gradients land in
    ``gradients`` (reference ``autograd.mark_variables``†)."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        v._grad_req = req
        v._data = v._data.detach().requires_grad_(req != "null")
        v.grad = g
        _track(v)


def _heads(heads, head_grads):
    from .ndarray.ndarray import NDArray
    heads = [heads] if isinstance(heads, NDArray) else list(heads)
    if head_grads is None:
        head_grads = [None] * len(heads)
    else:
        head_grads = [head_grads] if isinstance(head_grads, NDArray) \
            else list(head_grads)
    outs, grads = [], []
    for h, hg in zip(heads, head_grads):
        if not h._data.requires_grad:
            continue
        outs.append(h._data)
        grads.append(torch.ones_like(h._data) if hg is None else
                     (hg._data if isinstance(hg, NDArray) else
                      torch.as_tensor(hg, device=h._data.device)))
    if not outs:
        raise MXNetError(
            "backward called on arrays not produced under autograd.record "
            "with gradients attached")
    return outs, grads


def backward(heads, head_grads=None, retain_graph: bool = False,
             train_mode: bool = True) -> None:
    """Gradients of ``heads`` (with ``head_grads``, default ones) into
    the ``.grad`` of every leaf they reach (reference
    ``MXAutogradBackwardEx``†)."""
    from .ndarray.ndarray import NDArray
    outs, grads = _heads(heads, head_grads)
    _BACKWARD_GEN[0] += 1
    with _Scope(None, train_mode):
        torch.autograd.backward(outs, grads, retain_graph=retain_graph)
    with _LEAVES_LOCK:
        leaves = [r() for r in _LEAVES.values()]
    for leaf in leaves:
        g = None if leaf is None else leaf._data.grad
        if g is None:
            continue
        leaf._data.grad = None
        if leaf._grad_req == "add" and leaf.grad is not None:
            leaf.grad._data = leaf.grad._data + g
        elif leaf.grad is None:
            leaf.grad = NDArray(g)
        else:
            leaf.grad._data = g


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables``, returned
    without touching any ``.grad`` (reference ``autograd.grad``†);
    ``create_graph=True`` records them for a higher order."""
    from .ndarray.ndarray import NDArray
    single = isinstance(variables, NDArray)
    variables = [variables] if single else list(variables)
    outs, grads = _heads(heads, head_grads)
    with _Scope(None, train_mode):
        res = torch.autograd.grad(
            outs, [v._data for v in variables], grads,
            retain_graph=retain_graph, create_graph=create_graph,
            allow_unused=True)
    if any(r is None for r in res):
        raise MXNetError(
            "some variables are unreachable from the heads' graph; "
            "mark them with attach_grad() before recording")
    res = [NDArray(r) for r in res]
    return res[0] if single else res


class _Bridge(torch.autograd.Function):
    """Runs a :class:`Function`'s NDArray forward and backward."""

    @staticmethod
    def forward(ctx, fn, *tensors):
        from .ndarray.ndarray import NDArray
        ctx.fn = fn
        with pause():
            outs = fn.forward(*[NDArray(t) for t in tensors])
        ctx.single = isinstance(outs, NDArray)
        outs = (outs,) if ctx.single else tuple(outs)
        return outs[0]._data if ctx.single else \
            tuple(o._data for o in outs)

    @staticmethod
    def backward(ctx, *cotangents):
        from .ndarray.ndarray import NDArray
        with pause():
            gin = ctx.fn.backward(*[NDArray(c) for c in cotangents])
        gin = (gin,) if isinstance(gin, NDArray) else tuple(gin)
        return (None,) + tuple(
            g._data if isinstance(g, NDArray) else g for g in gin)


class Function:
    """A user-defined differentiable op (reference
    ``autograd.Function``†): subclass, write ``forward(self, *inputs)``
    and ``backward(self, *output_grads)`` with NDArray ops; gradients
    flow through the user's backward."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *arrays):
        self._saved = arrays

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray
        tensors = [x._data for x in inputs]
        if is_recording() and any(t.requires_grad for t in tensors):
            with torch.enable_grad():
                out = _Bridge.apply(self, *tensors)
            return NDArray(out) if isinstance(out, torch.Tensor) else \
                tuple(NDArray(o) for o in out)
        with pause():
            return self.forward(*inputs)
