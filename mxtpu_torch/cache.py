"""``mxtpu_torch.cache`` — the persistent compile cache (counterpart of
``mxtpu/cache.py``).

Every server process builds its whole bucket ladder before it serves,
and a fleet's ``warm_from=`` handoff only helps while a live donor
exists.  This module is the disk layer that outlives a process: one
file a key under a cache root, so a rollout, a preempted worker's
replacement or a scale-up replica warms from disk.

What an entry holds differs from mxtpu's.  mxtpu stores XLA
executables, which carry their compiled Pallas kernels, so a verified
hit skips tracing and compilation.  On the card a cold replica pays
for two things instead:

* the ``nvcc`` builds of the hand-written kernels
  (:mod:`mxtpu_torch.kernels._build`): a kernel entry is one built
  library (its bytes and its ptxas report), and a hit skips ``nvcc``;
* each bucket's entry (:mod:`mxtpu_torch.serving.entry`): a CUDA graph
  captured over static buffers.  A captured graph has no serialized
  form, so a bucket entry is a *recipe*: the static input and output
  shapes and types, the kernels' launch record of the capture and the
  kernel entries' keys.  A hit cannot skip the warm-up runs and the
  capture; it proves that the new capture launches what the cold one
  launched (a mismatch quarantines the entry as ``stale_key``).

The discipline is mxtpu's:

* **Crash-safe writes** — entry bytes go to a private temp file in the
  cache root, are fsync'd, then ``os.replace``'d onto the final name:
  readers never see a torn entry, and concurrent writers (threads or
  processes) race harmlessly (the last rename wins; both files are
  valid for the same key).
* **Verified loads** — every load checks the magic, the header length,
  the payload length, its sha256 and the FULL key component dict
  (model fingerprint, bucket shape, mesh, torch and CUDA versions,
  backend, device, contract hash, kernel sources, salt, format) before
  anything is unpickled.  A corrupt, truncated or stale entry moves to
  ``<root>/quarantine/`` and the caller builds cold: a wrong entry is
  never returned.  The ``pickle.loads`` below runs only after the
  checksum passed; the checksum defends against corruption, not
  against a malicious root — point ``MXTPU_CACHE_DIR`` at a directory
  you trust as you trust your checkpoints.
* **Degradation, never errors** — a read-only root, a full disk or a
  failed store fall back to the cold build with a ``cache``
  flight-recorder event and a ``mxtpu_cache_fallback_total`` count;
  nothing in the serving path raises because the cache is unhealthy.

The scripted cache faults of :mod:`mxtpu_torch.serving.faults`
(``CorruptEntry``, ``TruncateEntry``, ``StaleKey``, ``ReadOnlyDir``) act
at this module's write seams, and :func:`poison_corrupt` /
:func:`poison_truncate` / :func:`poison_stale` are the helpers tests
and the self-check use directly.

``python -m mxtpu_torch.cache --self-check`` round-trips a tiny program
through a throwaway root and probes every poisoning path.

Knobs (README "Persistent compile cache"): ``MXTPU_CACHE`` (master
switch), ``MXTPU_CACHE_DIR`` (root; unset = no persistence),
``MXTPU_CACHE_SALT`` (extra key component — bump to invalidate).
"""
from __future__ import annotations

import errno
import hashlib
import itertools
import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

from . import knobs
from . import obs
from .base import MXNetError

__all__ = ["CacheKey", "ExecutableCache", "default_cache",
           "contract_fingerprint", "kernels_fingerprint",
           "poison_corrupt", "poison_truncate", "poison_stale",
           "self_check"]

# On-disk entry layout: magic, a fixed-width decimal header length, the
# JSON header (key components + payload checksum), the payload (a
# pickled object).  The magic is the port's own, so an mxtpu entry
# copied into a port root is quarantined as "magic", never loaded;
# FORMAT is also a key component so a layout change never aliases an
# old entry.
_MAGIC = b"MXTORCH1\n"
_FORMAT = 1
_LEN_WIDTH = 10

_QUARANTINE_DIR = "quarantine"

# temp-file uniquifier: pid alone is not enough — two cache instances
# in one process writing the same key would share a temp name
_TMP_SEQ = itertools.count()


class _EntryInvalid(Exception):
    """Internal: entry failed verification; ``reason`` is the
    quarantine label (magic|truncated|header|checksum|stale_key)."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(detail or reason)
        self.reason = reason


class CacheKey:
    """An immutable, order-independent component dict plus its sha256
    digest (the entry filename).  Components are all strings; flipping
    any one changes the digest, and the full dict is also stored in
    the entry header and revalidated on load (a digest collision or a
    hand-renamed file can never smuggle a stale entry in)."""

    __slots__ = ("components", "digest")

    def __init__(self, components: Dict[str, Any]):
        self.components = {str(k): str(v)
                           for k, v in sorted(components.items())}
        blob = json.dumps(self.components, sort_keys=True,
                          separators=(",", ":"))
        self.digest = hashlib.sha256(blob.encode()).hexdigest()

    def filename(self) -> str:
        return f"{self.digest}.mxc"

    def replace(self, **changes: Any) -> "CacheKey":
        """A new key with some components flipped."""
        comps = dict(self.components)
        comps.update(changes)
        return CacheKey(comps)

    def __repr__(self) -> str:
        return f"CacheKey({self.digest[:12]}…, {self.components})"


_CONTRACTS = Path(__file__).resolve().parents[1] / "contracts"


def contract_fingerprint(root: Optional[Path] = None) -> str:
    """sha256 over the repo's ``contracts/*.json`` lockfiles (sorted
    name + content), the walk mxtpu's cache keys by: when the pinned
    contracts change, every entry built under the old ones misses.
    Computed once per process."""
    global _CONTRACT_FP
    if root is None:
        if _CONTRACT_FP is not None:
            return _CONTRACT_FP
        root = _CONTRACTS
    h = hashlib.sha256()
    if root.is_dir():
        for p in sorted(root.rglob("*.json")):
            h.update(p.relative_to(root).as_posix().encode())
            h.update(b"\0")
            try:
                h.update(p.read_bytes())
            except OSError:
                h.update(b"<unreadable>")
            h.update(b"\0")
    fp = h.hexdigest()[:16]
    if root == _CONTRACTS:
        _CONTRACT_FP = fp
    return fp


_CONTRACT_FP: Optional[str] = None
_KERNELS_FP: Optional[str] = None


def kernels_fingerprint() -> str:
    """sha256 over the kernel sources (``csrc/*.cu`` and ``*.cuh``,
    sorted name + content) and ``_build.NVCC_FLAGS``: an edited kernel
    or a changed flag misses every entry.  Computed once per
    process."""
    global _KERNELS_FP
    if _KERNELS_FP is None:
        from .kernels import _build
        h = hashlib.sha256()
        for p in sorted(_build.CSRC.iterdir()):
            if p.suffix in (".cu", ".cuh"):
                h.update(p.name.encode() + b"\0" + p.read_bytes() + b"\0")
        h.update(" ".join(_build.NVCC_FLAGS).encode())
        _KERNELS_FP = h.hexdigest()[:16]
    return _KERNELS_FP


def _device_components(device) -> Tuple[str, str]:
    """(backend, device name) of ``device`` (a torch device or its
    string); None names the card when one is visible, else the CPU."""
    import torch
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        return "cuda", torch.cuda.get_device_name(dev)
    return dev.type, dev.type


class ExecutableCache:
    """One on-disk compile-cache root.

    All methods are thread-safe and never raise on cache trouble: a
    failed ``load`` returns None (after quarantining the bad entry), a
    failed ``store`` returns False (after recording the fallback) — the
    caller builds either way.  ``faults`` is the deterministic
    fault-injection seam (a :class:`~mxtpu_torch.serving.faults.FaultPlan`
    carrying cache faults, consulted at the write seam and after each
    committed entry); production callers leave it None.
    """

    def __init__(self, root, *, salt: str = "", faults=None):
        self.root = Path(root)
        self.salt = str(salt)
        self._faults = faults
        # leaf lock (acquires nothing inside): counters + the write
        # latch; file operations rely on atomic rename, so writers in
        # other processes are safe too
        self._lock = threading.Lock()
        self._stores = 0              # guarded-by: _lock (fault script counter)
        self._write_ok = True         # guarded-by: _lock (latched off on EROFS/EACCES)
        self._stats = {"hit": 0, "miss": 0, "store": 0,       # guarded-by: _lock
                       "fallback": 0, "quarantined": 0}
        self._obs = obs.enabled()
        self._m_quarantined = obs.counter(
            "mxtpu_cache_quarantined_total",
            "Cache entries that failed load verification (corrupt/"
            "truncated/stale) and were moved to quarantine/.",
            labels=("reason",))
        self._m_fallback = obs.counter(
            "mxtpu_cache_fallback_total",
            "Cache degradations that fell back to plain compile "
            "(read-only dir, disk full, unserializable executable).",
            labels=("reason",))
        self._m_store = obs.counter(
            "mxtpu_cache_store_total",
            "Cache entries committed to disk (atomic renames).")
        self.recorder = obs.flight("cache")

    # -- keys -----------------------------------------------------------
    def key(self, *, model: str, shape: Any, mesh: Any = "1dev",
            device=None, **extra: Any) -> CacheKey:
        """Compose a full cache key: the caller names WHAT was built
        (``model`` fingerprint, concrete ``shape``/bucket, ``mesh``,
        the ``device`` it runs on, anything else via ``extra``); the
        cache adds the environment every entry must match — torch and
        CUDA versions, backend, device name, contract fingerprint,
        kernel sources, salt, format."""
        import torch
        backend, name = _device_components(device)
        comps: Dict[str, Any] = {
            "model": model, "shape": str(shape), "mesh": str(mesh),
            "torch": torch.__version__, "cuda": str(torch.version.cuda),
            "backend": backend, "device": name,
            "contract": contract_fingerprint(),
            "kernels": kernels_fingerprint(),
            "salt": self.salt, "format": str(_FORMAT)}
        for k, v in extra.items():
            comps[k] = str(v)
        return CacheKey(comps)

    def path_for(self, key: CacheKey) -> Path:
        return self.root / key.filename()

    def contains(self, key: CacheKey) -> bool:
        """Cheap existence probe (no verification) — what the fleet
        asks before deciding a replacement can warm from disk."""
        return self.path_for(key).is_file()

    # -- load (verify-or-quarantine) ------------------------------------
    def load(self, key: CacheKey, *, with_meta: bool = False):
        """The checksum-verified loader: returns the stored object or
        None (missing / invalid / unloadable — invalid entries are
        quarantined, never returned).  ``with_meta=True`` returns
        ``(object_or_None, meta)``, where ``meta`` is the writer's
        :meth:`store` sidecar dict (``{}`` on a miss)."""
        obj, meta = self._load(key)
        return (obj, meta) if with_meta else obj

    def _load(self, key: CacheKey) -> Tuple[Any, Dict[str, Any]]:
        path = self.path_for(key)
        try:
            blob = path.read_bytes()
        except FileNotFoundError:
            self._bump("miss")
            return None, {}
        except OSError as e:
            self._fallback("read_error", key, err=e)
            return None, {}
        try:
            payload, header = self._verify(blob, key)
        except _EntryInvalid as e:
            self._quarantine(path, e.reason, key, detail=str(e))
            return None, {}
        try:
            import pickle
            # the payload checksum and the whole key were verified above
            obj = pickle.loads(payload)
        except Exception as e:  # noqa: BLE001 — a version mismatch survives the checksum
            self._quarantine(path, "deserialize", key, detail=repr(e))
            return None, {}
        self._bump("hit")
        if self._obs:
            self.recorder.record("hit", digest=key.digest[:12],
                                 model=key.components.get("model",
                                                          "")[:16])
        meta = header.get("meta")
        return obj, meta if isinstance(meta, dict) else {}

    def _verify(self, blob: bytes,
                key: CacheKey) -> Tuple[bytes, Dict[str, Any]]:
        """Structural + checksum + key revalidation; returns
        ``(payload bytes, header dict)`` or raises
        :class:`_EntryInvalid`."""
        if not blob.startswith(_MAGIC):
            raise _EntryInvalid("magic", "bad magic")
        off = len(_MAGIC)
        len_line = blob[off:off + _LEN_WIDTH + 1]
        if len(len_line) < _LEN_WIDTH + 1 or \
                not len_line.endswith(b"\n"):
            raise _EntryInvalid("truncated", "short header-length")
        try:
            hlen = int(len_line[:-1])
        except ValueError:
            raise _EntryInvalid("header", "bad header-length") \
                from None
        off += _LEN_WIDTH + 1
        hbytes = blob[off:off + hlen]
        if len(hbytes) < hlen:
            raise _EntryInvalid("truncated", "short header")
        try:
            header = json.loads(hbytes)
        except ValueError:
            raise _EntryInvalid("header", "undecodable header") \
                from None
        payload = blob[off + hlen:]
        want_len = header.get("payload_len")
        if not isinstance(want_len, int) or len(payload) != want_len:
            raise _EntryInvalid(
                "truncated",
                f"payload {len(payload)}B, header says {want_len}")
        digest = hashlib.sha256(payload).hexdigest()
        if digest != header.get("payload_sha256"):
            raise _EntryInvalid("checksum", "payload sha256 mismatch")
        if header.get("key") != key.components:
            raise _EntryInvalid(
                "stale_key",
                f"entry key {header.get('key')} != expected "
                f"{key.components}")
        return payload, header

    # -- store (crash-safe) ---------------------------------------------
    def store(self, key: CacheKey, obj, *,
              meta: Optional[Dict[str, Any]] = None) -> bool:
        """Pickle + commit one entry crash-safely: temp file in the
        cache root, fsync, atomic ``os.replace``.  Returns False (and
        records the degradation) instead of raising on any trouble.
        ``meta`` is a small JSON-able sidecar stored in the header and
        handed back by ``load(with_meta=True)`` — not part of the key."""
        with self._lock:
            if not self._write_ok:
                return False
            k = self._stores
            self._stores += 1
        try:
            import pickle
            payload = pickle.dumps(obj, protocol=4)
        except Exception as e:  # noqa: BLE001 — degrade, never raise
            self._fallback("serialize_unsupported", key, err=e)
            return False
        header = json.dumps(
            {"format": _FORMAT, "key": key.components,
             "digest": key.digest,
             "payload_sha256": hashlib.sha256(payload).hexdigest(),
             "payload_len": len(payload),
             "meta": dict(meta or {}),
             "created": time.time(), "writer_pid": os.getpid()},
            sort_keys=True).encode()
        blob = (_MAGIC + f"{len(header):0{_LEN_WIDTH}d}\n".encode()
                + header + payload)
        path = self.path_for(key)
        tmp = self.root / (f".{key.digest}.{os.getpid()}"
                           f".{next(_TMP_SEQ)}.tmp")
        try:
            if self._faults is not None:
                self._faults.before_cache_write(k)
            self.root.mkdir(parents=True, exist_ok=True)
            fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC,
                         0o644)
            try:
                view = memoryview(blob)
                while view:
                    view = view[os.write(fd, view):]
                os.fsync(fd)
            finally:
                os.close(fd)
            os.replace(tmp, path)
            self._fsync_dir(self.root)
        except OSError as e:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            if isinstance(e, PermissionError) or \
                    e.errno in (errno.EROFS, errno.EACCES):
                reason = "read_only"
                with self._lock:
                    # latch writes off: a read-only root will not heal
                    # mid-process, and re-failing every build would
                    # spam the recorder
                    self._write_ok = False
            elif e.errno == errno.ENOSPC:
                reason = "disk_full"
            else:
                reason = "write_error"
            self._fallback(reason, key, err=e)
            return False
        if self._faults is not None:
            self._faults.entry_written(k, path)
        self._bump("store")
        if self._obs:
            self._m_store.inc()
            self.recorder.record("store", digest=key.digest[:12],
                                 bytes=len(blob))
        return True

    def load_or_compile(self, key: CacheKey, build: Callable[[], Any], *,
                        meta: Optional[Dict[str, Any]] = None
                        ) -> Tuple[Any, str]:
        """``(object, source)`` where source is ``"disk"`` (a verified
        cache hit) or ``"cold"`` (built now by ``build``; stored for
        the next process if the cache is writable, with ``meta`` as
        the entry's header sidecar)."""
        obj = self.load(key)
        if obj is not None:
            return obj, "disk"
        obj = build()
        self.store(key, obj, meta=meta)
        return obj, "cold"

    def quarantine(self, key: CacheKey, reason: str,
                   detail: str = "") -> None:
        """Move the entry of ``key`` aside after a check the loader
        cannot make: its payload verified, but what was rebuilt from it
        disagrees with it (``reason`` "stale_key": a bucket's capture
        launched other kernels than the recipe records; "deserialize":
        a kernel library that does not open)."""
        path = self.path_for(key)
        if path.is_file():
            self._quarantine(path, reason, key, detail=detail)

    # -- failure bookkeeping --------------------------------------------
    def _bump(self, stat: str, n: int = 1) -> None:
        with self._lock:
            self._stats[stat] += n

    def _quarantine(self, path: Path, reason: str, key: CacheKey,
                    detail: str = "") -> None:
        """Move a failed entry aside (never delete evidence, never
        retry it) and count it.  The quarantined file keeps its digest
        name plus reason + timestamp."""
        qdir = self.root / _QUARANTINE_DIR
        dest = qdir / f"{path.name}.{reason}.{os.getpid()}.{int(time.time() * 1e6)}"
        try:
            qdir.mkdir(parents=True, exist_ok=True)
            os.replace(path, dest)
        except OSError:
            try:  # read-only root: at least stop load() retrying it
                os.unlink(path)
            except OSError:
                pass
        self._bump("quarantined")
        if self._obs:
            self._m_quarantined.labels(reason=reason).inc()
            self.recorder.record("quarantine", reason=reason,
                                 digest=key.digest[:12],
                                 detail=detail[:160])

    def _fallback(self, reason: str, key: Optional[CacheKey],
                  err: Optional[BaseException] = None) -> None:
        self._bump("fallback")
        if self._obs:
            self._m_fallback.labels(reason=reason).inc()
            self.recorder.record(
                "fallback", reason=reason,
                digest=key.digest[:12] if key is not None else "",
                error=repr(err)[:160] if err is not None else "")

    @staticmethod
    def _fsync_dir(d: Path) -> None:
        """Make the rename itself durable.  Best-effort: not every
        filesystem allows O_RDONLY directory fds."""
        try:
            fd = os.open(d, os.O_RDONLY)
        except OSError:
            return
        try:
            os.fsync(fd)
        except OSError:
            pass
        finally:
            os.close(fd)

    # -- introspection ---------------------------------------------------
    def stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._stats)

    def writable(self) -> bool:
        with self._lock:
            return self._write_ok

    def entries(self) -> int:
        try:
            return sum(1 for _ in self.root.glob("*.mxc"))
        except OSError:
            return 0


# ----------------------------------------------------------------------
# process-wide default (knob-driven)
# ----------------------------------------------------------------------
_DEFAULT_LOCK = threading.Lock()
_DEFAULT: Dict[str, ExecutableCache] = {}  # guarded-by: _DEFAULT_LOCK


def default_cache() -> Optional[ExecutableCache]:
    """The knob-configured process cache: None unless ``MXTPU_CACHE``
    is on AND ``MXTPU_CACHE_DIR`` names a root.  One instance per root,
    shared by every runner and the kernel build in the process (their
    entries never collide: the key carries what was built)."""
    if not knobs.get("MXTPU_CACHE"):
        return None
    root = str(knobs.get("MXTPU_CACHE_DIR")).strip()
    if not root:
        return None
    salt = str(knobs.get("MXTPU_CACHE_SALT"))
    with _DEFAULT_LOCK:
        cache = _DEFAULT.get(root)
        if cache is None or cache.salt != salt:
            cache = _DEFAULT[root] = ExecutableCache(root, salt=salt)
        return cache


# ----------------------------------------------------------------------
# poisoning helpers — the shared implementation behind the scripted
# cache faults (serving/faults.py) and the self-check probes
# ----------------------------------------------------------------------
def poison_corrupt(path) -> None:
    """Flip one byte inside the payload region (bit rot: structurally
    intact, the checksum must catch it)."""
    p = Path(path)
    blob = bytearray(p.read_bytes())
    i = len(blob) - max(1, len(blob) // 16)
    blob[i] ^= 0xFF
    p.write_bytes(bytes(blob))


def poison_truncate(path) -> None:
    """Cut the entry in half (a crash mid-write on a filesystem without
    atomic rename, or a partial copy)."""
    p = Path(path)
    blob = p.read_bytes()
    p.write_bytes(blob[:len(blob) // 2])


def poison_stale(path, component: str = "torch",
                 value: str = "0.0.0-stale") -> None:
    """Rewrite one key component in the header, keeping the payload
    checksum valid — the entry parses and checksums clean but fails key
    revalidation (what an entry from an old torch or old contracts
    looks like after an in-place upgrade)."""
    p = Path(path)
    blob = p.read_bytes()
    off = len(_MAGIC)
    hlen = int(blob[off:off + _LEN_WIDTH])
    off += _LEN_WIDTH + 1
    header = json.loads(blob[off:off + hlen])
    header["key"][component] = value
    hbytes = json.dumps(header, sort_keys=True).encode()
    p.write_bytes(_MAGIC + f"{len(hbytes):0{_LEN_WIDTH}d}\n".encode()
                  + hbytes + blob[off + hlen:])


# ----------------------------------------------------------------------
# self check
# ----------------------------------------------------------------------
class _Affine:
    """The self-check's tiny program: ``x * w + b`` with its constants
    in the payload (a stand-in for what a hit must hand back whole)."""

    def __init__(self, w, b):
        self.w, self.b = w, b

    def __call__(self, x):
        import torch
        return x * torch.from_numpy(self.w) + torch.from_numpy(self.b)


def self_check(root: Optional[str] = None) -> Dict[str, Any]:
    """Round-trip + poisoning probes on a tiny program, on the CPU:

    * store → load is a verified hit and the loaded program computes
      bit-identical results;
    * each poisoning (corrupt byte, truncation, stale key component)
      makes ``load`` return None, quarantines the entry, and a
      re-store recovers;
    * an mxtpu-format entry under this key is quarantined as "magic";
    * a scripted read-only root degrades ``store`` to False without
      raising (and latches writes off);
    * flipping any key component misses.

    Raises :class:`MXNetError` on any contract violation; returns an
    info dict."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    tmp = root or tempfile.mkdtemp(prefix="mxtpu_torch_cache_check_")
    made_tmp = root is None
    info: Dict[str, Any] = {"root": tmp}
    try:
        cache = ExecutableCache(tmp, salt="self_check")
        x = torch.arange(8, dtype=torch.float32)
        program = _Affine(np.full(8, 2.0, np.float32),
                          np.ones(8, np.float32))
        want = program(x)
        key = cache.key(model="self_check", shape="(8,)f32", device="cpu")
        if not cache.store(key, program):
            raise MXNetError("cache self_check: store failed")
        info["serialize_supported"] = True
        loaded = cache.load(key)
        if loaded is None:
            raise MXNetError("cache self_check: round-trip load missed")
        got = loaded(x)
        if not torch.equal(want, got):
            raise MXNetError(
                f"cache self_check: loaded program disagrees "
                f"({got} != {want})")

        # any flipped key component must miss
        for comp, val in (("model", "other"), ("shape", "(9,)f32"),
                          ("mesh", "2dev"), ("torch", "0.0.0"),
                          ("contract", "feedfeedfeedfeed"),
                          ("kernels", "feedfeedfeedfeed")):
            if cache.load(key.replace(**{comp: val})) is not None:
                raise MXNetError(
                    f"cache self_check: flipped key component "
                    f"{comp!r} still hit")

        # poisoning probes: each must load None + quarantine, and a
        # fresh store must recover
        path = cache.path_for(key)

        def foreign(p):   # an mxtpu entry: its magic, not ours
            blob = Path(p).read_bytes()
            Path(p).write_bytes(b"MXTPUXC1\n" + blob[len(_MAGIC):])

        probes = (("corrupt", poison_corrupt),
                  ("truncate", poison_truncate),
                  ("stale", poison_stale),
                  ("magic", foreign))
        for name, poison in probes:
            if not cache.contains(key):
                cache.store(key, program)
            poison(path)
            if cache.load(key) is not None:
                raise MXNetError(
                    f"cache self_check: poisoned entry ({name}) "
                    f"was served")
            if cache.contains(key):
                raise MXNetError(
                    f"cache self_check: poisoned entry ({name}) "
                    f"not quarantined")
        st = cache.stats()
        if st["quarantined"] != len(probes):
            raise MXNetError(
                f"cache self_check: expected {len(probes)} "
                f"quarantines, saw {st['quarantined']}")
        qdir = Path(tmp) / _QUARANTINE_DIR
        if sum(1 for _ in qdir.iterdir()) != len(probes):
            raise MXNetError(
                "cache self_check: quarantine dir does not hold the "
                "poisoned entries")

        # read-only degradation: scripted PermissionError at the write
        # seam (chmod is unreliable: roots run as uid 0 ignore it)
        class _Deny:
            def before_cache_write(self, k):
                raise PermissionError("self_check: read-only root")

            def entry_written(self, k, path):
                pass

        ro = ExecutableCache(Path(tmp) / "ro", salt="self_check",
                             faults=_Deny())
        if ro.store(key, program):
            raise MXNetError(
                "cache self_check: store on a read-only root "
                "claimed success")
        if ro.writable():
            raise MXNetError(
                "cache self_check: read-only root did not latch "
                "writes off")
        info.update(stats=st, round_trip=True, poisons=len(probes),
                    read_only_fallback=True)
        return info
    finally:
        if made_tmp:
            shutil.rmtree(tmp, ignore_errors=True)


def _main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="python -m mxtpu_torch.cache")
    ap.add_argument("--self-check", action="store_true",
                    help="round-trip + poisoning probes on a tiny "
                         "program (default action)")
    ap.add_argument("--root", default=None,
                    help="probe inside this directory instead of a "
                         "throwaway tempdir")
    args = ap.parse_args(argv)
    info = self_check(root=args.root)
    print(f"cache.self_check OK: {info}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(_main())
