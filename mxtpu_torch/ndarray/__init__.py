"""``mxtpu_torch.nd`` — the NDArray type, the eager op namespace and
checkpoint files.

Every op of the registry (:mod:`.ops_impl`) becomes a module-level
function taking and returning NDArrays, as ``mxtpu/ndarray/
__init__.py`` generates its namespace; inside ``autograd.record()`` the
ops run with torch's grad mode on, so torch autograd records them.

``loads`` parses a checkpoint payload into numpy arrays and follows
``mxtpu/ndarray/ndarray.py:555-574`` (legacy dmlc stream, MXTPU01 npz
or bare npz, detected by magic); ``load_params`` adds the ``arg:``/``aux:`` prefix stripping of
``mxtpu/c_predict.py:32-46``.
"""
from __future__ import annotations

import io
import sys
from typing import Dict

import numpy as np
import torch

from .. import profiler as _prof
from ..base import MXNetError
from ..ops import interpose as _interpose
from ..ops.registry import OP_REGISTRY, get_op
from . import legacy_format
from . import ops_impl  # noqa: F401  (populates the registry)
from . import detection_impl  # noqa: F401  (MultiBox/Proposal/ROI ops)
from . import nn_extra  # noqa: F401  (ROIAlign)
from .ndarray import (NDArray, _device, arange, array, concat, empty,
                      full, load, ones, save, stack, waitall, zeros)

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "concat", "stack", "save", "load", "waitall", "loads",
           "load_params", "legacy_format", "contrib"]

_SAVE_MAGIC = b"MXTPU01\n"


def loads(blob: bytes):
    """Parse a checkpoint payload: a dict name → array for named
    saves, a list for anonymous ones."""
    if legacy_format.is_legacy(blob[:8]):
        arrays, names = legacy_format.loads(blob)
        if names:
            return dict(zip(names, arrays))
        return list(arrays)
    buf = io.BytesIO(blob)
    if blob[:len(_SAVE_MAGIC)] == _SAVE_MAGIC:
        buf.seek(len(_SAVE_MAGIC))
    npz = np.load(buf, allow_pickle=False)
    keys = list(npz.keys())
    if all(k.isdigit() for k in keys):
        return [npz[k] for k in sorted(keys, key=int)]
    return {k: npz[k] for k in keys}


def load_params(path: str) -> Dict[str, np.ndarray]:
    """Read a ``.params`` file into name → numpy array with the
    ``arg:``/``aux:`` prefixes stripped, keeping file order."""
    with open(path, "rb") as f:
        loaded = loads(f.read())
    if not isinstance(loaded, dict):
        raise MXNetError(
            f"{path}: anonymous .params blob has no names to bind by")
    out = {}
    for name, arr in loaded.items():
        key = name.split(":", 1)[1] \
            if name.startswith(("arg:", "aux:")) else name
        out[key] = np.asarray(arr)
    return out


# ----------------------------------------------------------------------
# eager dispatch and the generated namespace
# ----------------------------------------------------------------------
def _invoke_op(name: str, *inputs, **kwargs):
    """Run op ``name`` on NDArrays (python scalars become tensors on the
    first array's device) — the role of ``MXImperativeInvokeEx``.  An
    op with no inputs (``_arange``) creates on ``ctx`` (default the
    card)."""
    op = get_op(name)
    ctx = None
    if op.num_inputs == 0:
        if inputs:
            raise MXNetError(f"nd.{name} takes no inputs")
        ctx = kwargs.pop("ctx", None)
    return _invoke_resolved(op, op.resolve_params(kwargs), inputs, ctx, name)


def _invoke_resolved(op, resolved, inputs, ctx=None, name=None):
    """:func:`_invoke_op` after the op's lookup and the resolution of
    its params (what a graph plan does once per node).  ``name`` is the
    op's name as called (an alias keys an int8 scale as mxtpu's
    dispatch does); default the op's own.  While the profiler runs,
    each call is one "operator" span of that name
    (``mxtpu/ndarray/__init__.py:55-63``)."""
    if _prof._ACTIVE:
        t0 = _prof._now_us()
        out = _dispatch(op, resolved, inputs, ctx, name)
        _prof.record_op(name or op.name, t0, _prof._now_us() - t0)
        return out
    return _dispatch(op, resolved, inputs, ctx, name)


def _dispatch(op, resolved, inputs, ctx, name):
    from .. import autograd
    if op.num_inputs == 0:
        return NDArray(op.fn(**resolved, device=_device(ctx)))
    dev = next((x._data.device for x in inputs if isinstance(x, NDArray)),
               None)
    if dev is None:
        raise MXNetError(f"nd.{op.name}: no NDArray among the inputs")
    tensors = [x._data if isinstance(x, NDArray)
               else torch.as_tensor(x, device=dev) for x in inputs]
    # the int8 and AMP passes (mxtpu/ndarray/__init__.py:79-91): off
    # their scopes, one attribute read
    fn = _interpose.wrap_op(name or op.name, op, tensors, resolved) \
        if _interpose.SCOPES.open else None
    # a non-differentiable op is not recorded, as in mxtpu's
    # _invoke_op_inner: its output is a constant, and a backward from it
    # finds no graph
    with autograd._grad_mode() if op.differentiable else torch.no_grad():
        out = fn(*tensors) if fn is not None else op.fn(*tensors, **resolved)
    if isinstance(out, tuple):
        return tuple(NDArray(o) for o in out)
    return NDArray(out)


def _make_op_fn(opname: str):
    op = get_op(opname)

    def fn(*args, out=None, **kwargs):
        res = _invoke_op(opname, *args, **kwargs)
        if out is not None:
            out._data = res._data if isinstance(res, NDArray) \
                else res[0]._data
            return out
        return res
    fn.__name__ = fn.__qualname__ = opname
    fn.__doc__ = op.doc
    return fn


_THIS_MODULE = sys.modules[__name__]
for _op in list(OP_REGISTRY._entries.values()):
    for _n in (_op.name,) + _op.aliases:
        if not hasattr(_THIS_MODULE, _n):
            setattr(_THIS_MODULE, _n, _make_op_fn(_n))


# Dropout and the fused epilogue take a key input: these conveniences
# draw it and read the mode from autograd's training flag, as mxtpu's
# ``nd.Dropout`` / ``nd.FusedResidualLayerNorm`` do (and as a symbol
# graph, which omits the key, evaluates them)
def _key_nd(dev) -> NDArray:
    from .. import random as _rnd
    # the two words live on the host: the epilogue reads them as launch
    # arguments, so drawing them never waits for the card
    return NDArray(torch.tensor(_rnd.key_words(dev), dtype=torch.int64))


def _mode(mode):
    """``mode``, or when None mxtpu's default: "training" under
    ``autograd.is_training()``, else "always_off"."""
    from .. import autograd
    if mode is None:
        return "training" if autograd.is_training() else "always_off"
    return mode


def Dropout(data, p=0.5, mode=None, axes=()):  # noqa: N802
    """Dropout with the mode from ``autograd.is_training()`` when not
    given; the mask from ``mxtpu_torch.random``'s generator."""
    mode = _mode(mode)
    if mode != "training" or p <= 0.0:
        return data
    return _invoke_op("Dropout", data, _key_nd(data.context), p=p,
                      mode="training", axes=axes)


def FusedResidualLayerNorm(data, bias, residual, gamma, beta, p=0.1,  # noqa: N802
                           eps=1e-5, mode=None):
    """``LN(residual + dropout(data + bias))`` with a key drawn from
    ``mxtpu_torch.random`` in training mode."""
    training = _mode(mode) == "training" and p > 0.0
    key = _key_nd(data.context) if training else \
        NDArray(torch.zeros(2, dtype=torch.int64))
    return _invoke_op("FusedResidualLayerNorm", data, bias, residual, gamma,
                      beta, key, p=p, eps=eps,
                      mode="training" if training else "always_off")


dropout = Dropout

# the contrib namespace (box_iou / box_nms / bipartite_matching), after
# the generated functions as in mxtpu: its ops resolve as nd.contrib.*
# and sym.*, not as nd._contrib_*
from . import contrib  # noqa: E402
