"""NDArray — the array type of the imperative API, over a
``torch.Tensor`` on an explicit device (the counterpart of
``mxtpu/ndarray/ndarray.py``).

PyTorch's CUDA stream already gives the reference's asynchronous
semantics: ops enqueue and return, and ``asnumpy``/``wait_to_read`` are
the sync points.  Gradients are torch autograd's: ``attach_grad`` makes
the tensor a leaf that requires grad, ops record only inside
``autograd.record()``, and ``backward`` moves each leaf's gradient into
``.grad`` by its ``grad_req`` (see :mod:`mxtpu_torch.autograd`).

Creation routines default to the card (``cuda:0``) and raise without
CUDA unless given ``ctx=cpu()``, like every entry point of the port.
"""
from __future__ import annotations

import io
from typing import Optional, Tuple

import numpy as np
import torch

from ..base import MXNetError
from ..context import resolve_device

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "concat", "stack", "save", "load", "waitall", "zeros_like",
           "ones_like", "torch_dtype"]

_DTYPES = {
    "float32": torch.float32, "float16": torch.float16,
    "float64": torch.float64, "bfloat16": torch.bfloat16,
    "uint8": torch.uint8, "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}
# the JAX package runs without x64: 64-bit sources narrow to 32 bits
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a name, a numpy dtype or a torch dtype;
    ``None`` is float32."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name not in _DTYPES:
        raise MXNetError(f"unsupported dtype {dtype!r}")
    return _DTYPES[name]


def _device(ctx) -> torch.device:
    return resolve_device(ctx)


class NDArray:
    """A mutable handle over a tensor (reference ``NDArray``†):
    ``a[:] = b`` and in-place arithmetic rebind or overwrite the data."""

    __slots__ = ("_data", "grad", "_grad_req", "__weakref__")

    def __init__(self, data: torch.Tensor):
        if not isinstance(data, torch.Tensor):
            raise MXNetError(f"NDArray wraps a torch.Tensor, got "
                             f"{type(data).__name__}; use nd.array")
        self._data = data
        self.grad: Optional[NDArray] = None
        self._grad_req = "null"

    # -- properties -------------------------------------------------------
    @property
    def data(self) -> torch.Tensor:
        return self._data

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """numpy's dtype, or ``torch.bfloat16`` (numpy has none)."""
        if self._data.dtype == torch.bfloat16:
            return torch.bfloat16
        return np.dtype(str(self._data.dtype).replace("torch.", ""))

    @property
    def size(self) -> int:
        return self._data.numel()

    @property
    def ndim(self) -> int:
        return self._data.ndim

    @property
    def context(self) -> torch.device:
        return self._data.device

    ctx = context

    @property
    def stype(self) -> str:
        return "default"

    # -- sync points ------------------------------------------------------
    def wait_to_read(self) -> None:
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    wait_to_write = wait_to_read

    def asnumpy(self) -> np.ndarray:
        """A copy on the host, as mxtpu's (never a view of a CPU
        tensor, which a later in-place update would change)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            return t.float().cpu().numpy()     # a fresh tensor already
        return t.cpu().numpy() if t.is_cuda else t.numpy().copy()

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("the array is not scalar")
        return self.asnumpy().reshape(()).item()

    item = asscalar

    def tolist(self):
        return self.asnumpy().tolist()

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    # -- autograd ---------------------------------------------------------
    def attach_grad(self, grad_req: str = "write", stype=None) -> None:
        """Make this array a gradient leaf: ``.grad`` is a zero array of
        its shape, written (``"write"``) or added to (``"add"``) by each
        backward."""
        if grad_req not in ("write", "add", "null"):
            raise MXNetError(f"invalid grad_req {grad_req}")
        from .. import autograd
        self._grad_req = grad_req
        self._data = self._data.detach().requires_grad_(grad_req != "null")
        self.grad = zeros_like(self) if grad_req != "null" else None
        autograd._track(self)

    def detach(self) -> "NDArray":
        return NDArray(self._data.detach())

    def backward(self, out_grad: Optional["NDArray"] = None,
                 retain_graph: bool = False, train_mode: bool = True) -> None:
        from .. import autograd
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph, train_mode=train_mode)

    # -- conversion and placement -----------------------------------------
    def astype(self, dtype, copy: bool = True) -> "NDArray":
        td = torch_dtype(dtype)
        if not copy and self._data.dtype == td:
            return self
        from . import _invoke_op
        return _invoke_op("cast", self, dtype=str(td).replace("torch.", ""))

    def copyto(self, other) -> "NDArray":
        """Copy into ``other`` (an NDArray, whose data is overwritten) or
        onto a device (a new NDArray)."""
        if isinstance(other, NDArray):
            with torch.no_grad():
                other._data.copy_(self._data)
            return other
        return NDArray(self._data.detach().to(torch.device(other),
                                              copy=True))

    def copy(self) -> "NDArray":
        return NDArray(self._data.detach().clone())

    def as_in_context(self, ctx) -> "NDArray":
        dev = torch.device(ctx)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", 0)
        if dev == self._data.device:
            return self
        return self.copyto(dev)

    as_in_ctx = as_in_context

    # -- mutation ---------------------------------------------------------
    def __setitem__(self, key, value) -> None:
        if isinstance(value, NDArray):
            value = value._data
        with torch.no_grad():
            if isinstance(value, torch.Tensor):
                value = value.to(self._data.device, self._data.dtype)
            if key is None or (isinstance(key, slice) and
                               key == slice(None)):
                if isinstance(value, torch.Tensor):
                    self._data.copy_(value.expand_as(self._data))
                else:
                    self._data.fill_(value)
            else:
                self._data[key] = value

    def __getitem__(self, key):
        if isinstance(key, NDArray):
            key = key._data.long()
        from .. import autograd
        with autograd._grad_mode():
            return NDArray(self._data[key])

    # -- arithmetic through the registered broadcast ops ------------------
    def _binop(self, other, opname, reverse=False):
        from . import _invoke_op
        a, b = (other, self) if reverse else (self, other)
        return _invoke_op(opname, a, b)

    def __add__(self, o): return self._binop(o, "broadcast_add")
    def __radd__(self, o): return self._binop(o, "broadcast_add", True)
    def __sub__(self, o): return self._binop(o, "broadcast_sub")
    def __rsub__(self, o): return self._binop(o, "broadcast_sub", True)
    def __mul__(self, o): return self._binop(o, "broadcast_mul")
    def __rmul__(self, o): return self._binop(o, "broadcast_mul", True)
    def __truediv__(self, o): return self._binop(o, "broadcast_div")
    def __rtruediv__(self, o): return self._binop(o, "broadcast_div", True)
    def __mod__(self, o): return self._binop(o, "broadcast_mod")
    def __rmod__(self, o): return self._binop(o, "broadcast_mod", True)
    def __pow__(self, o): return self._binop(o, "broadcast_power")
    def __rpow__(self, o): return self._binop(o, "broadcast_power", True)
    def __eq__(self, o): return self._binop(o, "broadcast_equal")
    def __ne__(self, o): return self._binop(o, "broadcast_not_equal")
    def __lt__(self, o): return self._binop(o, "broadcast_lesser")
    def __le__(self, o): return self._binop(o, "broadcast_lesser_equal")
    def __gt__(self, o): return self._binop(o, "broadcast_greater")
    def __ge__(self, o): return self._binop(o, "broadcast_greater_equal")

    def __neg__(self):
        from . import _invoke_op
        return _invoke_op("negative", self)

    def __abs__(self):
        from . import _invoke_op
        return _invoke_op("abs", self)

    __hash__ = None  # mutable container semantics, like the reference

    def _inplace(self, r: "NDArray") -> "NDArray":
        self._data = r._data
        return self

    def __iadd__(self, o): return self._inplace(self + o)
    def __isub__(self, o): return self._inplace(self - o)
    def __imul__(self, o): return self._inplace(self * o)
    def __itruediv__(self, o): return self._inplace(self / o)

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise MXNetError("ambiguous truth value of multi-element NDArray")

    def __len__(self) -> int:
        if not self.shape:
            raise MXNetError("len() of 0-d array")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __repr__(self) -> str:
        return f"\n{self.asnumpy()}\n<NDArray {self.shape} " \
               f"@{self.context} {self._data.dtype}>"

    # -- method mirrors of common ops -------------------------------------
    def _op(self, name, **kw):
        from . import _invoke_op
        return _invoke_op(name, self, **kw)

    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return self._op("reshape", shape=shape)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return self._op("transpose", axes=tuple(axes) if axes else None)

    @property
    def T(self):
        return self.transpose()

    def flatten(self):
        return self._op("flatten")

    def expand_dims(self, axis):
        return self._op("expand_dims", axis=axis)

    def squeeze(self, axis=None):
        return self._op("squeeze", axis=axis)

    def sum(self, axis=None, keepdims=False):
        return self._op("sum", axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._op("mean", axis=axis, keepdims=keepdims)

    def max(self, axis=None, keepdims=False):
        return self._op("max", axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False):
        return self._op("min", axis=axis, keepdims=keepdims)

    def argmax(self, axis=None, keepdims=False):
        return self._op("argmax", axis=axis, keepdims=keepdims)

    def clip(self, a_min, a_max):
        return self._op("clip", a_min=float(a_min), a_max=float(a_max))

    def abs(self):
        return self.__abs__()


def zeros_like(a: NDArray) -> NDArray:
    return NDArray(torch.zeros_like(a._data, requires_grad=False))


def ones_like(a: NDArray) -> NDArray:
    return NDArray(torch.ones_like(a._data, requires_grad=False))


# ----------------------------------------------------------------------
# creation routines
# ----------------------------------------------------------------------
def array(source, ctx=None, dtype=None) -> NDArray:
    """An NDArray holding a copy of ``source`` (numpy, a list, a tensor
    or an NDArray) on ``ctx`` (default the card).  As in mxtpu, python
    numbers and lists become float32 and 64-bit arrays narrow to 32
    bits, unless ``dtype`` says otherwise."""
    dev = _device(ctx)
    if isinstance(source, NDArray):
        t = source._data.detach()
    elif isinstance(source, torch.Tensor):
        t = source.detach()
    else:
        a = np.asarray(source)
        if not isinstance(source, np.ndarray) and a.dtype in (np.float64,
                                                              np.int64):
            a = a.astype(np.float32)  # python numbers are float32 arrays
        t = torch.tensor(a)
    td = torch_dtype(dtype) if dtype is not None else \
        _NARROW.get(t.dtype, t.dtype)
    return NDArray(t.to(device=dev, dtype=td, copy=True))


def _shape(shape) -> Tuple[int, ...]:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, ctx=None, dtype=None) -> NDArray:
    return NDArray(torch.zeros(_shape(shape), dtype=torch_dtype(dtype),
                               device=_device(ctx)))


def ones(shape, ctx=None, dtype=None) -> NDArray:
    return NDArray(torch.ones(_shape(shape), dtype=torch_dtype(dtype),
                              device=_device(ctx)))


def full(shape, val, ctx=None, dtype=None) -> NDArray:
    return NDArray(torch.full(_shape(shape), val, dtype=torch_dtype(dtype),
                              device=_device(ctx)))


def empty(shape, ctx=None, dtype=None) -> NDArray:
    return zeros(shape, ctx, dtype)


def arange(start, stop=None, step=1.0, ctx=None, dtype=None) -> NDArray:
    if stop is None:
        start, stop = 0, start
    return NDArray(torch.arange(start, stop, step, dtype=torch_dtype(dtype),
                                device=_device(ctx)))


def concat(*arrays, dim: int = 1) -> NDArray:
    from . import _invoke_op
    return _invoke_op("concat", *arrays, dim=dim)


def stack(*arrays, axis: int = 0) -> NDArray:
    from . import _invoke_op
    return _invoke_op("stack", *arrays, axis=axis)


def waitall() -> None:
    """Reference ``mx.nd.waitall()``†: wait for the card."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


# ----------------------------------------------------------------------
# save / load: the MXTPU01 container (``mxtpu/ndarray/ndarray.py:
# 528-579``) and the reference's dmlc stream for ``.params`` files
# ----------------------------------------------------------------------
_SAVE_MAGIC = b"MXTPU01\n"


def save(fname: str, data) -> None:
    """Write an NDArray, a list or a dict of them: the legacy dmlc
    stream for a ``.params`` file, else MXTPU01 (a header and an npz
    payload), as mxtpu picks by default; both load in mxtpu and the
    reference."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, (list, tuple)):
        names, arrays = None, [a.asnumpy() for a in data]
    elif isinstance(data, dict):
        names = list(data.keys())
        arrays = [v.asnumpy() for v in data.values()]
    else:
        raise MXNetError("save expects NDArray, list or dict of NDArray")
    if fname.endswith(".params"):
        from . import legacy_format
        blob = legacy_format.dumps(
            arrays if names is None else dict(zip(names, arrays)))
    else:
        buf = io.BytesIO()
        if names is None:
            names = [str(i) for i in range(len(arrays))]
        np.savez(buf, **dict(zip(names, arrays)))
        blob = _SAVE_MAGIC + buf.getvalue()
    with open(fname, "wb") as f:
        f.write(blob)


def load(fname: str, ctx=None):
    """Read a file written by :func:`save`, mxtpu or the reference: a
    dict name → NDArray for named saves, a list for anonymous ones,
    placed on ``ctx`` (default the card)."""
    from . import loads
    with open(fname, "rb") as f:
        loaded = loads(f.read())
    if isinstance(loaded, dict):
        return {k: array(v, ctx=ctx) for k, v in loaded.items()}
    return [array(v, ctx=ctx) for v in loaded]
