"""Build the hand-written Hopper kernels at first use and load them.

Each ``mxtpu_torch/csrc/<name>.cu`` has a plain C interface and is
compiled by ``nvcc`` on its own into ``lib<name>-<hash>.so`` under
``mxtpu_torch/_build/`` (listed in ``.gitignore``), then opened with
``ctypes``.  The hash covers the source and the flags, so an edited
source never loads a stale library.  :func:`build_all` starts one
``nvcc`` per source at once and waits for all of them.

Every C entry point takes its pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after the launch;
:func:`check` raises when that is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

from ..base import MXNetError

__all__ = ["SOURCES", "CSRC", "BUILD_DIR", "load", "build_all",
           "check", "bind", "stream_of", "build_seconds", "build_log",
           "ptxas_log"]

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = ("flash_attention", "flash_attention_bwd", "layer_norm",
           "layer_norm_bwd", "fused_residual_ln", "fused_residual_ln_bwd",
           "batch_norm", "batch_norm_bwd", "conv_nhwc", "nms")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}  # guarded-by: _lock
# per-source wall seconds of the nvcc run and its ptxas report
build_seconds: Dict[str, float] = {}  # guarded-by: _lock
build_log: Dict[str, str] = {}  # guarded-by: _lock


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise MXNetError("nvcc not found: the CUDA toolkit is needed to build "
                     "the mxtpu_torch kernels")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise MXNetError(f"kernel source {src} missing")
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, nvcc: str):
    """Begin compiling ``name`` unless its library exists; returns
    (process, temp path, final path, start time) or None."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, job) -> None:
    proc, tmp, out, t0 = job
    log, _ = proc.communicate()
    build_seconds[name] = time.perf_counter() - t0
    build_log[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise MXNetError(f"nvcc failed for {name}.cu "
                         f"(exit {proc.returncode}):\n{log}")
    _log_path(out).write_text(log)  # before the library, which marks done
    os.replace(tmp, out)


def _log_path(lib: Path) -> Path:
    return lib.with_suffix(".log")


def ptxas_log(name: str) -> str:
    """The nvcc/ptxas report of kernel source ``name``'s current
    library: this process's build, else the one kept beside a library
    built earlier; "" where neither exists."""
    with _lock:
        log = build_log.get(name)
    if log is not None:
        return log
    path = _log_path(_target(name))
    return path.read_text() if path.exists() else ""


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every listed kernel source in parallel (one ``nvcc``
    each) and load the libraries; returns per-source build seconds."""
    names = tuple(SOURCES if names is None else names)
    with _lock:
        todo = [n for n in names if n not in _libs]
        if todo:
            nvcc = _nvcc()
            for n in todo:      # every source exists before any nvcc starts
                _target(n)
            jobs = {n: _start(n, nvcc) for n in todo}
            errors = []
            for n, job in jobs.items():
                if job is None:
                    continue
                try:
                    _finish(n, job)
                except MXNetError as e:
                    errors.append(str(e))
            if errors:
                raise MXNetError("\n".join(errors))
            for n in todo:
                _libs[n] = ctypes.CDLL(str(_target(n)))
        return {n: build_seconds.get(n, 0.0) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built on first use."""
    with _lock:
        lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        with _lock:
            lib = _libs[name]
    return lib


def check(err: int, what: str) -> None:
    """Raise when a launch reported a CUDA error."""
    if err != 0:
        raise MXNetError(f"{what}: CUDA error {err} at launch")


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, as a C pointer."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def bind(name: str, symbol: str, argtypes) -> "ctypes._CFuncPtr":
    """The C entry ``symbol`` of kernel source ``name`` with its
    argument types declared (pointers and the stream as ``void*``)."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn
