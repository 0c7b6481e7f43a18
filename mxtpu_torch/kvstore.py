"""KVStore (the counterpart of ``mxtpu/kvstore.py``): an in-process
key-value store with the reference's push/pull semantics.

* ``local``, ``device``, ``nccl`` (and ``local_allreduce_cpu`` /
  ``local_allreduce_device``): one in-process store.  ``push`` sums a
  key's parts (a list is one part a device) left to right into the
  store; ``pull`` writes the stored value into each ``out``.
* ``set_optimizer`` runs the optimizer "server-side": a push then
  updates the stored weight through the port's ``Updater`` and a pull
  returns weights (``update_on_kvstore``).
* ``set_gradient_compression``: ``{'type': '2bit', 'threshold': t}``
  quantizes each pushed part to {-t, 0, +t} with an error-feedback
  residual kept per (key, device slot); ``'1bit'`` sends +-t by sign.
  The quantizers are mxtpu's ``_quantize_2bit``/``_quantize_1bit``
  (``mxtpu/kvstore.py:47-63``) op for op, so the sent values and the
  residuals equal mxtpu's bit for bit; the threshold takes the
  gradient's type.  Compression is refused for a key pushed with
  another number of parts, or a part of another shape, until it is set
  again (which clears the residuals).
* ``dist_sync``, ``dist_device_sync`` and ``dist_async`` raise: the port
  runs in one process (the dist stores wait, ROADMAP 8b).

A pull into an NDArray of the stored value's shape, type and device
writes in place, so a pull into ``param.grad()`` updates the gradient
the optimizer reads; any other ``out`` is rebound to a copy, as mxtpu
rebinds it.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from .base import MXNetError, _as_list
from .ndarray.ndarray import NDArray, waitall
from .optimizer import optimizer as opt_mod

__all__ = ["KVStore", "create"]

_LOCAL = ("local", "device", "nccl", "local_allreduce_cpu",
          "local_allreduce_device")
_DIST = ("dist_sync", "dist_device_sync", "dist_async")


def _quantize_2bit(g, residual, threshold):
    """2-bit quantization with error feedback: accumulate the residual,
    emit {-threshold, 0, +threshold}, keep the quantization error."""
    acc = g + residual
    comp = torch.where(acc >= threshold, threshold,
                       torch.where(acc <= -threshold, -threshold,
                                   torch.zeros_like(acc)))
    return comp, acc - comp


def _quantize_1bit(g, residual, threshold):
    """1-bit (signSGD-style) quantization with error feedback: emit
    +-threshold by the sign of the accumulated gradient."""
    acc = g + residual
    comp = torch.where(acc >= 0, threshold, -threshold)
    return comp, acc - comp


def _raw(v) -> torch.Tensor:
    return v._data if isinstance(v, NDArray) else torch.as_tensor(v)


class KVStore:
    """In-process key-value store with the reference's semantics."""

    def __init__(self, name: str = "local"):
        self._type = name
        self._store: Dict[Any, NDArray] = {}
        self._updater = None
        self._optimizer = None
        self._compression: Dict[str, Any] = {}
        self._residuals: Dict[Any, torch.Tensor] = {}
        self._slot_counts: Dict[Any, int] = {}

    # ------------------------------------------------------------------
    @property
    def type(self) -> str:
        return self._type

    @property
    def rank(self) -> int:
        return 0

    @property
    def num_workers(self) -> int:
        return 1

    @property
    def num_devices(self) -> int:
        """The devices this process trains on: one, whatever the host
        holds (the port trains on one device a process), so the Trainer
        keeps a store only where compression asks for one."""
        return 1

    # ------------------------------------------------------------------
    def init(self, key, value) -> None:
        keys, values = self._normalize(key, value)
        for k, v in zip(keys, values):
            if k in self._store:
                continue
            self._store[k] = NDArray(_raw(_as_list(v)[0]).detach().clone())
            # a fresh key is a fresh compression state
            self._slot_counts.pop(k, None)
            for rk in [rk for rk in self._residuals if rk[0] == k]:
                del self._residuals[rk]

    def push(self, key, value, priority: int = 0) -> None:
        """Sum ``value`` (a list is one part a device) into the store;
        with an optimizer set, update the stored weight with the sum."""
        keys, values = self._normalize(key, value)
        with torch.no_grad():
            for k, v in zip(keys, values):
                parts = [_raw(p) for p in _as_list(v)]
                if self._compression:
                    nslots = self._slot_counts.setdefault(k, len(parts))
                    if nslots != len(parts):
                        raise MXNetError(
                            f"gradient compression: key {k!r} was pushed "
                            f"with {nslots} device parts before, now "
                            f"{len(parts)}; per-slot residuals would be "
                            f"misattributed: call set_gradient_compression "
                            f"again after a device-set change to reset "
                            f"residuals")
                    parts = [self._compress(k, i, p)
                             for i, p in enumerate(parts)]
                reduced = parts[0]
                for p in parts[1:]:
                    reduced = reduced + p
                if self._updater is not None:
                    if k not in self._store:
                        raise MXNetError(f"key {k} not init()ed")
                    self._updater(self._key_int(k), NDArray(reduced),
                                  self._store[k])
                else:
                    self._store[k] = NDArray(reduced.detach().clone())

    def pull(self, key, out=None, priority: int = 0,
             ignore_sparse: bool = True):
        """Write the stored value of each key into its ``out`` (one
        NDArray or a list); with ``out`` None, return copies."""
        keys, outs = self._normalize(key, out)
        results = []
        with torch.no_grad():
            for k, o in zip(keys, outs):
                if k not in self._store:
                    raise MXNetError(f"key {k} not init()ed")
                val = self._store[k]._data
                for dst in _as_list(o):
                    if dst is None:
                        continue
                    t = dst._data
                    if t.shape == val.shape and t.dtype == val.dtype and \
                            t.device == val.device:
                        t.copy_(val)
                    else:
                        dst._data = val.clone()
                results.append(NDArray(val.clone()))
        return results if out is None else None

    def pushpull(self, key, value, out=None, priority: int = 0):
        self.push(key, value, priority)
        self.pull(key, out if out is not None else value, priority)

    def row_sparse_pull(self, key, out=None, priority: int = 0,
                        row_ids=None):
        """A dense pull (the port has no sparse storage, nor has
        mxtpu)."""
        self.pull(key, out=out, priority=priority)

    # ------------------------------------------------------------------
    def set_optimizer(self, optimizer) -> None:
        """Run ``optimizer`` on push, on the stored weights (the
        reference's server-side update)."""
        self._optimizer = optimizer
        self._updater = opt_mod.get_updater(optimizer)

    def set_gradient_compression(self, compression_params) -> None:
        """Quantize each pushed part (see the module's docstring); None
        or ``{}`` turns compression off.  Setting it clears the
        residuals."""
        params = dict(compression_params or {})
        if not params:
            self._compression = {}
            self._residuals.clear()
            self._slot_counts.clear()
            return
        unknown = set(params) - {"type", "threshold"}
        if unknown:
            raise MXNetError(
                f"unknown compression params {sorted(unknown)}; "
                f"supported keys: 'type', 'threshold'")
        if "type" not in params:
            raise MXNetError(
                "compression_params requires an explicit 'type' "
                "('2bit' or '1bit')")
        ctype = params["type"]
        if ctype not in ("2bit", "1bit"):
            raise MXNetError(
                f"unsupported compression type {ctype!r}; "
                f"supported: '2bit', '1bit'")
        threshold = float(params.get("threshold", 0.5))
        if threshold <= 0:
            raise MXNetError("compression threshold must be positive")
        self._compression = {"type": ctype, "threshold": threshold}
        self._residuals.clear()
        self._slot_counts.clear()

    def _compress(self, key, slot, raw: torch.Tensor) -> torch.Tensor:
        rk = (key, slot)
        res = self._residuals.get(rk)
        if res is not None and res.shape != raw.shape:
            raise MXNetError(
                f"gradient compression: key {key!r} slot {slot} shape "
                f"changed {tuple(res.shape)} -> {tuple(raw.shape)}; call "
                f"set_gradient_compression again to reset residuals")
        if res is None:
            res = torch.zeros_like(raw)
        fn = _quantize_2bit if self._compression["type"] == "2bit" \
            else _quantize_1bit
        thr = torch.tensor(self._compression["threshold"], dtype=raw.dtype,
                           device=raw.device)
        comp, self._residuals[rk] = fn(raw, res, thr)
        return comp

    # ------------------------------------------------------------------
    def save_optimizer_states(self, fname, dump_optimizer=False) -> None:
        if self._updater is None:
            raise MXNetError("no optimizer set on kvstore")
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname) -> None:
        """Load :meth:`save_optimizer_states`' file; the states go to the
        stored weights' device (the card when nothing is stored)."""
        if self._updater is None:
            raise MXNetError("no optimizer set on kvstore")
        dev = next((v._data.device for v in self._store.values()), None)
        with open(fname, "rb") as f:
            self._updater.set_states(f.read(), device=dev)

    def barrier(self) -> None:
        """Wait for the card (one process: no peer to meet)."""
        waitall()

    def _key_int(self, k):
        try:
            return int(k)
        except (TypeError, ValueError):
            return k

    @staticmethod
    def _normalize(key, value):
        if isinstance(key, (list, tuple)):
            if value is None:
                return list(key), [None] * len(key)
            if len(key) != len(value):
                raise MXNetError("key/value length mismatch")
            return list(key), list(value)
        return [key], [value]


def create(name: str = "local") -> KVStore:
    """Reference ``mx.kv.create``†."""
    if not isinstance(name, str):
        raise MXNetError("name must be a string")
    if name in _DIST:
        raise MXNetError(
            f"kvstore {name!r} is not ported yet: the port runs in one "
            f"process (the dist stores wait, ROADMAP 8b)")
    if name not in _LOCAL:
        raise MXNetError(f"unknown kvstore type {name!r}")
    return KVStore(name)
