"""Runtime kernel compilation: ``CudaModule`` (the reference's
``python/mxnet/rtc.py``†), the port of ``PallasKernel``
(``mxtpu/rtc.py:33-55``, TPU kernel #12).

In the JAX package a user writes a Pallas kernel body and
``PallasKernel`` runs it on NDArrays (``pl.pallas_call`` under
``jax.jit``), while ``CudaModule`` is a stub that raises.  On the card
the roles swap: a user writes CUDA C++ and runs it without rebuilding
the framework, as MXNet 1.x users did::

    source = r'''
    extern "C" __global__ void axpy(const float *x, float *y, float a,
                                    int n) {
        int i = blockIdx.x * blockDim.x + threadIdx.x;
        if (i < n) y[i] += a * x[i];
    }'''
    module = rtc.CudaModule(source, exports=["axpy"])
    axpy = module.get_kernel("axpy", "const float *x, float *y, "
                                     "float a, int n")
    axpy.launch([x, y, 2.0, n], mx.gpu(0), ((n + 255) // 256, 1, 1),
                (256, 1, 1))

Design.  The source is compiled by ``nvcc -cubin`` for ``sm_90a`` into
``mxtpu_torch/_build/rtc/<hash>.cubin`` (the hash covers the source,
the options and the flags, so a cubin is built once per machine) and
loaded with the driver API through ctypes (``cuModuleLoadData``) into
PyTorch's context: the device's primary context, made current on the
calling thread before its first driver call there and checked current
(one ``cuCtxGetCurrent``) at each launch.  Kernels are found by name, so
an exported kernel is declared ``extern "C"``; a name the cubin lacks
raises.  ``launch`` checks every argument against the signature the
caller gave (pointer or scalar, and its C type, which alone decides the
width of the value passed), checks that ``ctx`` is a GPU and every
array lies on it, contiguous, and launches with ``cuLaunchKernel`` on
PyTorch's current stream, so the kernel is ordered with the cuDNN and
PyTorch work around it; a non-zero result raises.  Nothing
falls back to the CPU: without CUDA, ``CudaModule`` raises when it is
made.  Each kernel counts its launches (:func:`launch_counts`).

What bounds a user kernel is the user's business; the kernels
``chip_smoke.py`` runs (a row softmax and its loss gradient) are
bounded by bytes.
"""
from __future__ import annotations

import ctypes
import hashlib
import numbers
import os
import re
import subprocess
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .base import MXNetError
from .ndarray.ndarray import NDArray

__all__ = ["CudaModule", "CudaKernel", "PallasKernel", "parse_signature",
           "launch_counts", "reset_launch_counts"]

NVCC_FLAGS = ("-cubin", "-arch=sm_90a", "-std=c++17", "-O3")

# C type -> torch dtype of a pointer's elements
_PTR_TYPES = {
    "float": torch.float32, "double": torch.float64,
    "__half": torch.float16, "half": torch.float16,
    "__nv_bfloat16": torch.bfloat16, "nv_bfloat16": torch.bfloat16,
    "uint8_t": torch.uint8, "unsigned char": torch.uint8,
    "int8_t": torch.int8, "char": torch.int8, "signed char": torch.int8,
    "int16_t": torch.int16, "short": torch.int16,
    "int": torch.int32, "int32_t": torch.int32,
    "int64_t": torch.int64, "long long": torch.int64, "bool": torch.bool,
}
# C type -> (ctypes type, python kind) of a scalar passed by value
_SCALAR_TYPES = {
    "float": (ctypes.c_float, "float"), "double": (ctypes.c_double, "float"),
    "int": (ctypes.c_int32, "int"), "int32_t": (ctypes.c_int32, "int"),
    "unsigned": (ctypes.c_uint32, "int"),
    "unsigned int": (ctypes.c_uint32, "int"),
    "uint32_t": (ctypes.c_uint32, "int"),
    "int64_t": (ctypes.c_int64, "int"), "long long": (ctypes.c_int64, "int"),
    "uint64_t": (ctypes.c_uint64, "int"), "size_t": (ctypes.c_uint64, "int"),
    "unsigned long long": (ctypes.c_uint64, "int"),
    "int16_t": (ctypes.c_int16, "int"), "short": (ctypes.c_int16, "int"),
    "int8_t": (ctypes.c_int8, "int"), "char": (ctypes.c_int8, "int"),
    "uint8_t": (ctypes.c_uint8, "int"),
    "unsigned char": (ctypes.c_uint8, "int"), "bool": (ctypes.c_bool, "bool"),
}
_QUALIFIERS = {"const", "volatile", "__restrict__", "__restrict",
               "restrict"}
_MAX_STATIC_SHARED = 48 * 1024
_ATTR_MAX_DYNAMIC_SHARED = 8  # CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES

_count_lock = threading.Lock()
LAUNCHES: Dict[str, int] = {}  # guarded-by: _count_lock


def launch_counts() -> Dict[str, int]:
    """Launches of each rtc kernel (by kernel name) since the last
    reset."""
    with _count_lock:
        return dict(LAUNCHES)


def reset_launch_counts() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


class Arg(NamedTuple):
    """One kernel argument: a pointer to ``dtype`` elements, or a scalar
    of C type ``ctype`` (a ctypes type) taking python ``kind``."""
    name: Optional[str]
    is_ptr: bool
    dtype: Optional[torch.dtype]
    ctype: Optional[type]
    kind: Optional[str]
    cname: str


def parse_signature(signature: str) -> List[Arg]:
    """Parse a C parameter list such as ``"const float *x, float *y, int
    n, float alpha"``.  Raises on a type outside the supported set or a
    pointer to a pointer."""
    out = []
    for raw in signature.split(","):
        tokens = re.findall(r"[A-Za-z_]\w*|\*|\S", raw)
        bad = [t for t in tokens if not re.fullmatch(r"[A-Za-z_]\w*|\*", t)]
        stars = tokens.count("*")
        words = [t for t in tokens if t != "*" and t not in _QUALIFIERS]
        if bad or stars > 1 or not words:
            raise MXNetError(f"cannot parse kernel argument {raw.strip()!r}"
                             f" of signature {signature!r}")
        table = _PTR_TYPES if stars else _SCALAR_TYPES
        name = None
        cname = " ".join(words)
        if cname not in table and " ".join(words[:-1]) in table:
            cname, name = " ".join(words[:-1]), words[-1]
        if cname not in table:
            raise MXNetError(
                f"unsupported {'pointer' if stars else 'scalar'} type "
                f"{cname!r} in {raw.strip()!r}; supported: "
                f"{sorted(table)}")
        if stars:
            out.append(Arg(name, True, table[cname], None, None, cname))
        else:
            ct, kind = table[cname]
            out.append(Arg(name, False, None, ct, kind, cname))
    return out


# ----------------------------------------------------------------------
# the driver API through ctypes
# ----------------------------------------------------------------------
_P = ctypes.c_void_p
_U = ctypes.c_uint
_driver_lock = threading.Lock()
_driver_lib = None  # guarded-by: _driver_lock
_primary: Dict[int, int] = {}  # guarded-by: _driver_lock


def _driver():
    global _driver_lib
    with _driver_lock:
        if _driver_lib is None:
            lib = ctypes.CDLL("libcuda.so.1")
            sigs = {
                "cuInit": [_U],
                "cuDeviceGet": [ctypes.POINTER(ctypes.c_int), ctypes.c_int],
                "cuDevicePrimaryCtxRetain": [ctypes.POINTER(_P),
                                             ctypes.c_int],
                "cuCtxGetCurrent": [ctypes.POINTER(_P)],
                "cuCtxSetCurrent": [_P],
                "cuModuleLoadData": [ctypes.POINTER(_P), _P],
                "cuModuleGetFunction": [ctypes.POINTER(_P), _P,
                                        ctypes.c_char_p],
                "cuFuncSetAttribute": [_P, ctypes.c_int, ctypes.c_int],
                "cuLaunchKernel": [_P, _U, _U, _U, _U, _U, _U, _U, _P,
                                   ctypes.POINTER(_P), ctypes.POINTER(_P)],
                "cuGetErrorName": [ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_char_p)],
            }
            for fn, argtypes in sigs.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _driver_lib = lib
            _check(lib.cuInit(0), "cuInit")
        return _driver_lib


def _check(res: int, what: str) -> None:
    if res != 0:
        name = ctypes.c_char_p()
        _driver_lib.cuGetErrorName(res, ctypes.byref(name))
        raise MXNetError(f"{what}: CUDA driver error {res} "
                         f"({(name.value or b'?').decode()})")


def _use_context(index: int):
    """Make the device's primary context (PyTorch's) current on this
    thread; returns the driver library."""
    lib = _driver()
    torch.cuda.current_stream(index)   # PyTorch's own lazy init first
    with _driver_lock:
        ctx = _primary.get(index)
        if ctx is None:
            dev, c = ctypes.c_int(), _P()
            _check(lib.cuDeviceGet(ctypes.byref(dev), index), "cuDeviceGet")
            _check(lib.cuDevicePrimaryCtxRetain(ctypes.byref(c), dev),
                   "cuDevicePrimaryCtxRetain")
            ctx = _primary[index] = c.value
    cur = _P()
    _check(lib.cuCtxGetCurrent(ctypes.byref(cur)), "cuCtxGetCurrent")
    if cur.value != ctx:
        _check(lib.cuCtxSetCurrent(_P(ctx)), "cuCtxSetCurrent")
        _check(lib.cuCtxGetCurrent(ctypes.byref(cur)), "cuCtxGetCurrent")
        if cur.value != ctx:
            raise MXNetError(f"cuda:{index}: the primary context did not "
                             f"become current")
    return lib


def _compile(source: str, options: Sequence[str]):
    """The cubin of ``source`` (built by nvcc unless cached) and the
    seconds its build took (0.0 when cached)."""
    from .kernels import _build
    opts = tuple(options)
    h = hashlib.sha256("\0".join((source,) + opts + NVCC_FLAGS).encode())
    out_dir = _build.BUILD_DIR / "rtc"
    cubin = out_dir / f"{h.hexdigest()[:20]}.cubin"
    if cubin.exists():
        return cubin.read_bytes(), 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    src = cubin.with_suffix(".cu")
    tag = f"{os.getpid()}.{threading.get_ident()}"
    tmp_src = src.with_suffix(f".{tag}.cu")
    tmp_src.write_text(source)
    tmp = cubin.with_suffix(f".{tag}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_build._nvcc(), *NVCC_FLAGS, *opts, "-o",
                           str(tmp), str(tmp_src)], capture_output=True,
                          text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        tmp_src.unlink(missing_ok=True)
        raise MXNetError(f"CudaModule: nvcc failed (exit "
                         f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp_src, src)
    os.replace(tmp, cubin)
    return cubin.read_bytes(), seconds


class CudaModule:
    """CUDA C++ source compiled for the card (reference
    ``mx.rtc.CudaModule``†).  ``options`` are extra nvcc flags;
    ``exports`` names the kernels to check for now (each must be an
    ``extern "C"`` kernel of the source)."""

    def __init__(self, source: str, options: Sequence[str] = (),
                 exports: Sequence[str] = ()):
        if not torch.cuda.is_available():
            raise MXNetError("CudaModule needs a CUDA card and "
                             "torch.cuda.is_available() is false")
        if isinstance(options, str):
            options = (options,)
        self.source = source
        self.options = tuple(options)
        self._cubin, self.build_seconds = _compile(source, self.options)
        self._modules: Dict[int, int] = {}
        self._lock = threading.Lock()
        for name in exports:
            self._function(torch.cuda.current_device(), name)

    def _module(self, index: int) -> int:
        lib = _use_context(index)
        with self._lock:
            mod = self._modules.get(index)
            if mod is None:
                handle = _P()
                image = ctypes.cast(ctypes.c_char_p(self._cubin), _P)
                _check(lib.cuModuleLoadData(ctypes.byref(handle), image),
                       "cuModuleLoadData")
                mod = self._modules[index] = handle.value
        return mod

    def _function(self, index: int, name: str) -> int:
        mod = self._module(index)
        fn = _P()
        res = _driver_lib.cuModuleGetFunction(ctypes.byref(fn), _P(mod),
                                              name.encode())
        if res != 0:
            raise MXNetError(
                f"CudaModule: no kernel {name!r} in the compiled module "
                f"(kernels are found by name: declare it extern \"C\")")
        return fn.value

    def get_kernel(self, name: str, signature: str) -> "CudaKernel":
        """The kernel ``name`` with its C parameter list ``signature``
        (reference ``CudaModule.get_kernel``†)."""
        return CudaKernel(self, name, parse_signature(signature))


class CudaKernel:
    """One kernel of a :class:`CudaModule`; :meth:`launch` runs it
    (reference ``mx.rtc.CudaKernel``†).

    What repeats per launch is cut to the checks themselves: each
    argument's converter is built once from the signature, a context
    resolves once to its device index, and each calling thread keeps one
    ctypes block of the kernel's parameters per device, made the first
    time the thread launches there (the function handle and the pointer
    array to the parameters with it)."""

    def __init__(self, module: CudaModule, name: str, args: List[Arg]):
        self.module = module
        self.name = name
        self.args = args
        self._fns: Dict[int, int] = {}
        self._function(torch.cuda.current_device())
        self._convert = [self._converter(i, s) for i, s in enumerate(args)]
        fields = [(f"a{i}", _P if s.is_ptr else s.ctype)
                  for i, s in enumerate(args)]
        self._struct = type(f"_{name}_params", (ctypes.Structure,),
                            {"_fields_": fields})
        self._index_of: Dict[object, int] = {}
        self._shared_set: Dict[int, int] = {}
        self._local = threading.local()
        with _count_lock:
            LAUNCHES.setdefault(name, 0)

    def _function(self, index: int) -> int:
        fn = self._fns.get(index)
        if fn is None:
            fn = self._fns[index] = self.module._function(index, self.name)
        return fn

    def _converter(self, i: int, spec: Arg):
        """The check and conversion of argument ``i``: a tensor's data
        pointer, or the python scalar itself (ctypes narrows it to the C
        type when it is stored)."""
        what = f"{self.name} argument {i} ({spec.name or spec.cname})"
        if spec.is_ptr:
            def ptr(a, index):
                t = a._data if isinstance(a, NDArray) else a
                if not isinstance(t, torch.Tensor):
                    raise MXNetError(f"{what}: a {spec.cname} pointer takes "
                                     f"an NDArray, got {type(a).__name__}")
                if t.dtype != spec.dtype:
                    raise MXNetError(f"{what}: {spec.cname} * needs "
                                     f"{spec.dtype}, got {t.dtype}")
                if not t.is_cuda or t.get_device() != index:
                    raise MXNetError(f"{what}: the array is on {t.device}, "
                                     f"the launch on cuda:{index}")
                if not t.is_contiguous():
                    raise MXNetError(f"{what}: the array is not contiguous")
                return t.data_ptr()
            return ptr
        fast = {"bool": (bool,), "int": (int,), "float": (float, int)}[
            spec.kind]
        cast = {"bool": bool, "int": int, "float": float}[spec.kind]

        def scalar(a, index):
            if type(a) in fast:
                return a
            if spec.kind == "bool":
                ok = isinstance(a, (bool, np.bool_))
            else:
                ok = isinstance(a, numbers.Integral if spec.kind == "int"
                                else numbers.Real) and \
                    not isinstance(a, (bool, np.bool_))
            if not ok:
                raise MXNetError(f"{what}: a {spec.cname} scalar cannot "
                                 f"take {type(a).__name__} {a!r}")
            return cast(a)
        return scalar

    def _device_index(self, ctx) -> int:
        try:
            return self._index_of[ctx]
        except (KeyError, TypeError):
            pass
        dev = torch.device(ctx)
        if dev.type != "cuda":
            raise MXNetError(f"{self.name}: launch needs a GPU context, "
                             f"got {dev}")
        index = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        if isinstance(ctx, (str, torch.device)) and dev.index is not None:
            self._index_of[ctx] = index
        return index

    def _params(self, index: int):
        """This thread's parameter block on device ``index``: (the
        ctypes structure, the pointer array to its fields, the
        function handle, the driver library, the device's primary
        context), made on first use, which makes the context current."""
        blocks = getattr(self._local, "blocks", None)
        if blocks is None:
            blocks = self._local.blocks = {}
        block = blocks.get(index)
        if block is None:
            lib = _use_context(index)
            with _driver_lock:
                ctx = _primary[index]
            st = self._struct()
            base = ctypes.addressof(st)
            ptrs = (_P * max(1, len(self.args)))(*[
                base + getattr(self._struct, f).offset
                for f, _ in self._struct._fields_])
            block = blocks[index] = (st, ptrs, self._function(index), lib,
                                     ctx)
        return block

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0):
        """Launch on ``ctx`` (a GPU) with the grid and block dims (up to
        three each) and ``shared_mem`` bytes of dynamic shared memory,
        on PyTorch's current stream of that device."""
        index = self._device_index(ctx)
        if len(args) != len(self.args):
            raise MXNetError(f"{self.name}: {len(args)} arguments for a "
                             f"signature of {len(self.args)}")
        dims = _dims(self.name, grid_dims, block_dims)
        st, ptrs, fn, lib, ctx_ptr = self._params(index)
        vals = [conv(a, index) for conv, a in zip(self._convert, args)]
        for (f, _), v in zip(self._struct._fields_, vals):
            setattr(st, f, v)
        _current(lib, index, ctx_ptr)
        if shared_mem > _MAX_STATIC_SHARED and \
                self._shared_set.get(index, 0) < shared_mem:
            _check(lib.cuFuncSetAttribute(_P(fn), _ATTR_MAX_DYNAMIC_SHARED,
                                          int(shared_mem)),
                   f"{self.name}: cuFuncSetAttribute")
            self._shared_set[index] = int(shared_mem)
        _check(lib.cuLaunchKernel(fn, *dims, int(shared_mem),
                                  _raw_stream(index), ptrs, None),
               f"{self.name}: cuLaunchKernel")
        with _count_lock:
            LAUNCHES[self.name] += 1


def _dims(name: str, grid_dims, block_dims) -> tuple:
    """The six launch dims, each a positive integer (three a side, 1
    where fewer are given)."""
    if type(grid_dims) is tuple and type(block_dims) is tuple:
        dims = grid_dims + block_dims
        if len(dims) == 6 and all(type(v) is int and v > 0 for v in dims):
            return dims
    dims = []
    for what, d in (("grid", grid_dims), ("block", block_dims)):
        d = tuple(d) + (1,) * (3 - len(tuple(d)))
        if len(d) != 3 or not all(isinstance(v, numbers.Integral) and v > 0
                                  for v in d):
            raise MXNetError(f"{name}: bad {what} dims {d}")
        dims += d
    return tuple(int(v) for v in dims)


# PyTorch's current stream of a device as a raw handle, without making a
# Stream object (what torch's own generated launchers call)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
    lambda index: torch.cuda.current_stream(index).cuda_stream)


def _current(lib, index: int, ctx: int) -> None:
    """Device ``index``'s primary context ``ctx`` (made current by this
    thread's first launch there) checked current again, one driver call:
    PyTorch may have moved the thread to another device since."""
    cur = getattr(_tls, "cur", None)
    if cur is None:
        cur = _tls.cur = _P()
    _check(lib.cuCtxGetCurrent(ctypes.byref(cur)), "cuCtxGetCurrent")
    if cur.value != ctx:
        _use_context(index)


_tls = threading.local()


class PallasKernel:
    """The JAX package's Pallas wrapper has no counterpart here: Pallas
    targets the TPU.  Write the kernel in CUDA C++ and run it with
    :class:`CudaModule`."""

    def __init__(self, *args, **kwargs):
        raise MXNetError(
            "PallasKernel runs Pallas kernels, which target a TPU; on the "
            "card write the kernel in CUDA C++ and run it with "
            "mxtpu_torch.rtc.CudaModule(source).get_kernel(name, "
            "signature).launch(...)")
