"""Build the hand-written Hopper kernels at first use and load them.

Each ``mxtpu_torch/csrc/<name>.cu`` has a plain C interface and is
compiled by ``nvcc`` on its own into ``lib<name>-<hash>.so`` under
``mxtpu_torch/_build/`` (listed in ``.gitignore``), then opened with
``ctypes``.  The hash covers the source and the flags, so an edited
source never loads a stale library.  :func:`build_all` starts one
``nvcc`` per source at once and waits for all of them.

When the persistent cache has a root (``MXTPU_CACHE_DIR``,
:func:`mxtpu_torch.cache.default_cache`), the root takes the place of
``_build/``: each library is first looked up there as a kernel entry,
keyed by the ``_target`` hash, the release line of ``nvcc --version``,
the flags and the device name.  A verified hit is written to a file
private to the process (``dlopen`` needs a path) and opened, with no
``nvcc``; a miss builds with ``nvcc`` into that private directory and
stores the library (and its ptxas report) for the next process.  An
entry that fails verification is quarantined and rebuilt by ``nvcc``:
it is never opened, and no call goes to a plain version for it.
:data:`build_source` says where each library came from.

Every C entry point takes its pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after the launch;
:func:`check` raises when that is not 0.
"""
from __future__ import annotations

import atexit
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
           "build_source", "kernel_entries", "ptxas_log"]

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = ("flash_attention", "flash_attention_bwd", "layer_norm",
           "layer_norm_bwd", "fused_residual_ln", "fused_residual_ln_bwd",
           "batch_norm", "batch_norm_bwd", "conv_nhwc", "nms", "rnn_cell",
           "moe", "rnn_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}  # guarded-by: _lock
# per-source wall seconds of the nvcc run (or of the disk load) and its
# ptxas report
build_seconds: Dict[str, float] = {}  # guarded-by: _lock
build_log: Dict[str, str] = {}  # guarded-by: _lock
# per-source provenance of the library opened: "nvcc" (built by this
# process), "disk" (a kernel entry of the persistent cache) or
# "build_dir" (a library an earlier process built into BUILD_DIR)
build_source: Dict[str, str] = {}  # guarded-by: _lock
# per-source digest of the kernel entry (with a cache root only)
_entry_digests: Dict[str, str] = {}  # guarded-by: _lock
_nvcc_release: Optional[str] = None  # guarded-by: _lock


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


def _start(name: str, nvcc: str, out: Path):
    """Begin compiling ``name`` into ``out`` unless that library
    exists; returns (process, temp path, final path, start time) or
    None."""
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
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


def _private_dir() -> Path:
    """This process's directory for the libraries it opens with a cache
    root (removed at exit): no other process replaces a file in it."""
    d = BUILD_DIR / f"proc-{os.getpid()}"
    if not d.is_dir():
        d.mkdir(parents=True, exist_ok=True)
        atexit.register(shutil.rmtree, d, True)
    return d


def _release(nvcc: Optional[str]) -> str:
    """The release line of ``nvcc --version`` ("Cuda compilation tools,
    release X, VX.Y.Z"; the first line names no version), "" without
    nvcc."""
    global _nvcc_release
    if _nvcc_release is None:
        out = ""
        if nvcc is not None:
            out = subprocess.run([nvcc, "--version"], capture_output=True,
                                 text=True, timeout=60).stdout
        lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
        _nvcc_release = next((ln for ln in lines if "release" in ln),
                             " ".join(lines))
    return _nvcc_release


def _which_nvcc() -> Optional[str]:
    try:
        return _nvcc()
    except MXNetError:
        return None


def _entry_key(cache, name: str):
    return cache.key(model=f"kernel:{name}",
                     shape=_target(name).stem.rsplit("-", 1)[1],
                     nvcc=_release(_which_nvcc()),
                     flags=" ".join(NVCC_FLAGS))


def _open_from_disk(cache, name: str) -> bool:
    """Open ``name``'s library from its verified kernel entry; False
    on a miss (an entry that fails verification was quarantined by the
    load, one that does not open is quarantined here)."""
    t0 = time.perf_counter()
    key = _entry_key(cache, name)
    entry = cache.load(key)
    if entry is None:
        return False
    path = _private_dir() / _target(name).name
    tmp = path.with_suffix(f".{threading.get_ident()}.tmp")
    tmp.write_bytes(entry["library"])
    os.replace(tmp, path)
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        cache.quarantine(key, "deserialize", repr(e))
        path.unlink(missing_ok=True)
        return False
    _libs[name] = lib
    build_log[name] = entry["log"]
    build_seconds[name] = time.perf_counter() - t0
    build_source[name] = "disk"
    _entry_digests[name] = key.digest
    return True


def _store(cache, name: str, lib: Path) -> None:
    key = _entry_key(cache, name)
    if cache.store(key, {"library": lib.read_bytes(),
                         "log": build_log.get(name, "")},
                   meta={"build_seconds": build_seconds.get(name, 0.0)}):
        _entry_digests[name] = key.digest


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every listed kernel source in parallel (one ``nvcc``
    each) and load the libraries; returns per-source build seconds.
    With a cache root, the sources it holds load from there and only
    the rest start ``nvcc``."""
    from ..cache import default_cache
    names = tuple(SOURCES if names is None else names)
    with _lock:
        todo = [n for n in names if n not in _libs]
        for n in todo:      # every source exists before any nvcc starts
            _target(n)
        cache = default_cache() if todo else None
        if cache is not None:
            todo = [n for n in todo if not _open_from_disk(cache, n)]
        if todo:
            nvcc = _nvcc()
            outs = {n: _target(n) for n in todo}
            if cache is not None:
                # a library left in a private directory of the same pid
                # by a process that died is never reused
                outs = {n: _private_dir() / out.name
                        for n, out in outs.items()}
                for out in outs.values():
                    out.unlink(missing_ok=True)
            jobs = {n: _start(n, nvcc, outs[n]) for n in todo}
            errors = []
            for n, job in jobs.items():
                if job is None:
                    build_source[n] = "build_dir"
                    continue
                try:
                    _finish(n, job)
                    build_source[n] = "nvcc"
                except MXNetError as e:
                    errors.append(str(e))
            if errors:
                raise MXNetError("\n".join(errors))
            for n in todo:
                _libs[n] = ctypes.CDLL(str(outs[n]))
                if cache is not None:
                    _store(cache, n, outs[n])
        return {n: build_seconds.get(n, 0.0) for n in names}


def kernel_entries() -> Dict[str, str]:
    """Per source, the digest of the kernel entry its library was
    loaded from or stored to (none without a cache root)."""
    with _lock:
        return dict(_entry_digests)


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
