"""ModelRunner — bucketed inference over one weight upload.

Counterpart of ``mxtpu/serving/runner.py``.  A model (an ``nn.Module``)
is moved to its device once; every request batch is padded to a bucket
of a powers-of-two batch ladder crossed with optional sequence-length
buckets, so the card only ever sees a bounded set of shapes.  PyTorch
runs eagerly, so a bucket needs no compile: ``warmup`` runs one forward
per bucket, which builds the kernels and settles the allocator before
traffic arrives.

Pad-to-bucket contract (unchanged from mxtpu): batch padding repeats
row 0, sequence padding uses ``pad_value``, and attention also covers
the pad positions, so a served result equals the model's output on the
same padded batch.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..base import MXNetError
from .. import knobs
from ..context import resolve_device, strict_f32
from .batcher import InferenceRequest

__all__ = ["ModelRunner", "batch_ladder"]


def batch_ladder(max_batch_size: int) -> Tuple[int, ...]:
    """Powers-of-two ladder 1,2,4,… capped at ``max_batch_size`` (the
    cap itself is always a rung so full batches never pad)."""
    if max_batch_size < 1:
        raise MXNetError("max_batch_size must be >= 1")
    rungs = []
    b = 1
    while b < max_batch_size:
        rungs.append(b)
        b *= 2
    rungs.append(max_batch_size)
    return tuple(rungs)


class ModelRunner:
    """Load-once, bucket-per-shape, run-many inference engine.

    Parameters
    ----------
    model : gluon Block (or any torch.nn.Module)
        Called as ``model(*inputs)`` with one tensor per input, in
        ``input_specs`` order; returns a tensor or a tuple of tensors.
    params : dict name -> numpy array, optional
        ``mxtpu`` weights (what an exported ``.params`` file holds),
        carried in through :func:`mxtpu_torch.convert.params_from_mxtpu`:
        by name into a Block, by ``collect_params()`` order into another
        module.  None keeps the model's own (initialized) weights.
    input_specs : dict name -> per-example shape tuple
        Shapes EXCLUDE the batch axis.  A ``None`` entry marks the
        variable (sequence) axis and requires ``seq_buckets``.
    input_dtypes : dict name -> numpy dtype, optional (default float32)
    seq_buckets : ascending ints, optional
    max_batch_size : int, optional (env MXTPU_SERVING_MAX_BATCH, 32)
    device : None (``cuda:0``; raises without CUDA) or a device such as
        ``"cpu"``.
    pad_value : scalar used for sequence padding (default 0).
    """

    def __init__(self, model: nn.Module,
                 params: Optional[Dict[str, np.ndarray]] = None,
                 input_specs: Optional[Dict[str, Tuple]] = None,
                 input_dtypes: Optional[Dict[str, Any]] = None,
                 seq_buckets: Optional[Sequence[int]] = None,
                 max_batch_size: Optional[int] = None,
                 device=None, pad_value: float = 0):
        if not input_specs:
            raise MXNetError("serving: input_specs is required")
        self._device = resolve_device(device)
        if self._device.type == "cuda":
            strict_f32()
        self._input_names = list(input_specs)
        self._input_specs = {k: tuple(v) for k, v in input_specs.items()}
        self._input_dtypes = {
            k: np.dtype((input_dtypes or {}).get(k, np.float32))
            for k in input_specs}
        self.max_batch_size = int(
            max_batch_size if max_batch_size is not None
            else knobs.get("MXTPU_SERVING_MAX_BATCH"))
        self.batch_buckets = batch_ladder(self.max_batch_size)
        self.seq_buckets = tuple(sorted(int(s) for s in seq_buckets)) \
            if seq_buckets else None
        has_var = any(None in spec for spec in self._input_specs.values())
        if has_var and not self.seq_buckets:
            raise MXNetError(
                "serving: input_specs contain a variable (None) axis — "
                "pass seq_buckets")
        self._pad_value = pad_value

        # -- one weight upload, shared by every bucket -----------------
        if params is not None:
            from ..convert import params_from_mxtpu
            params_from_mxtpu(params, model)
        model.eval()
        for p in model.parameters():
            p.requires_grad_(False)
        self._model = model.to(self._device)

        self._lock = threading.Lock()
        self._warm: set = set()  # guarded-by: _lock
        self.warmup_seconds: Dict[Tuple, float] = {}  # guarded-by: _lock

    # -- deployment-artifact constructor ---------------------------------
    @classmethod
    def from_export(cls, model: nn.Module, params_file: str, **kwargs
                    ) -> "ModelRunner":
        """Load the ``.params`` file of an ``mxtpu`` gluon ``export``
        (or ``Module.save_checkpoint``) into ``model``.  The
        ``-symbol.json`` graph is not read: ``model`` is the
        architecture."""
        from ..ndarray import load_params
        return cls(model, load_params(params_file), **kwargs)

    # -- buckets ---------------------------------------------------------
    def bucket_for(self, n: int, seq_len: Optional[int] = None) -> Tuple:
        """Smallest (batch_bucket, seq_bucket) ladder rung covering a
        batch of ``n`` examples of length ``seq_len``."""
        if n < 1:
            raise MXNetError("serving: empty batch")
        if n > self.max_batch_size:
            raise MXNetError(
                f"serving: batch {n} exceeds max_batch_size "
                f"{self.max_batch_size}")
        b = next(r for r in self.batch_buckets if r >= n)
        if self.seq_buckets is None:
            return (b, None)
        if seq_len is None:
            raise MXNetError("serving: token model needs seq_len")
        if seq_len > self.seq_buckets[-1]:
            raise MXNetError(
                f"serving: seq_len {seq_len} exceeds largest bucket "
                f"{self.seq_buckets[-1]}")
        s = next(r for r in self.seq_buckets if r >= seq_len)
        return (b, s)

    def seq_bucket_for(self, seq_len: Optional[int]) -> Optional[int]:
        """The batcher's grouping key: requests sharing a seq bucket
        may batch together; batch-size bucketing happens at dispatch."""
        if self.seq_buckets is None:
            return None
        return self.bucket_for(1, seq_len)[1]

    def buckets(self) -> List[Tuple]:
        """The full ladder (what ``warmup()`` runs)."""
        seqs = self.seq_buckets or (None,)
        return [(b, s) for s in seqs for b in self.batch_buckets]

    def _concrete_shape(self, name: str, batch: int,
                        seq: Optional[int]) -> Tuple[int, ...]:
        return (batch,) + tuple(seq if d is None else int(d)
                                for d in self._input_specs[name])

    def warmup(self, buckets: Optional[Sequence[Tuple]] = None
               ) -> Dict[Tuple, float]:
        """Run one forward per bucket (the whole ladder by default) so
        no production request pays the kernel build or the allocator's
        first growth; returns per-bucket seconds."""
        for bucket in (buckets if buckets is not None
                       else self.buckets()):
            bucket = tuple(bucket)
            batch, seq = bucket
            vals = tuple(
                torch.full(self._concrete_shape(n, batch, seq),
                           self._pad_value,
                           dtype=_torch_dtype(self._input_dtypes[n]),
                           device=self._device)
                for n in self._input_names)
            t0 = time.perf_counter()
            self.run_raw(vals, bucket)
            if self._device.type == "cuda":
                torch.cuda.synchronize(self._device)
            with self._lock:
                self.warmup_seconds[bucket] = time.perf_counter() - t0
        with self._lock:
            return dict(self.warmup_seconds)

    def num_compiled(self) -> int:
        """Buckets run at least once (the ``mxtpu`` name is kept: there
        a bucket is an executable)."""
        with self._lock:
            return len(self._warm)

    # -- execution --------------------------------------------------------
    def _pad_stack(self, rows: List[Dict[str, np.ndarray]],
                   bucket: Tuple) -> Tuple[torch.Tensor, ...]:
        """Per-example input dicts -> padded device tensors of the
        bucket's shape.  Batch padding repeats row 0 (keeps values in
        the embedding/index domain); sequence padding uses
        ``pad_value``."""
        batch, seq = bucket
        vals = []
        for name in self._input_names:
            shape = self._concrete_shape(name, batch, seq)
            dt = self._input_dtypes[name]
            buf = np.empty(shape, dt)
            for i, row in enumerate(rows):
                ex = np.asarray(row[name], dt)
                if ex.shape != shape[1:]:
                    pads = []
                    for d, (want, got) in enumerate(
                            zip(shape[1:], ex.shape)):
                        if got > want:
                            raise MXNetError(
                                f"serving: input {name!r} axis {d} size "
                                f"{got} exceeds bucket {want}")
                        pads.append((0, want - got))
                    ex = np.pad(ex, pads, constant_values=self._pad_value)
                buf[i] = ex
            if len(rows) < batch:
                buf[len(rows):] = buf[0]
            vals.append(torch.from_numpy(buf).to(self._device))
        return tuple(vals)

    def run_raw(self, input_vals: Tuple[torch.Tensor, ...],
                bucket: Tuple) -> Tuple[torch.Tensor, ...]:
        """One forward on pre-padded device tensors of ``bucket``'s
        shape; returns the outputs as a tuple of device tensors."""
        with torch.inference_mode():
            out = self._model(*input_vals)
        with self._lock:
            self._warm.add(tuple(bucket))
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)

    def infer(self, inputs: Dict[str, np.ndarray],
              seq_len: Optional[int] = None) -> List[np.ndarray]:
        """Synchronous batched inference: ``inputs`` carry a leading
        batch axis; pads to the covering bucket, runs, slices back.
        Returns host numpy arrays (one per model output)."""
        names = self._input_names
        n = int(np.asarray(inputs[names[0]]).shape[0])
        if seq_len is None and self.seq_buckets is not None:
            seq_len = int(np.asarray(inputs[names[0]]).shape[1])
        bucket = self.bucket_for(n, seq_len)
        rows = [{name: np.asarray(inputs[name])[i] for name in names}
                for i in range(n)]
        outs = self.run_raw(self._pad_stack(rows, bucket), bucket)
        return [o[:n].cpu().numpy() for o in outs]

    def run_requests(self, requests: List[InferenceRequest],
                     now: Optional[float] = None) -> Tuple:
        """Server path: execute one assembled same-group batch and
        scatter each request its OWN output rows (sequence axis trimmed
        back to the request's true length).  Returns (bucket, outputs)
        for stats."""
        n = len(requests)
        seq = requests[0].group if self.seq_buckets is not None else None
        bucket = self.bucket_for(n, seq)
        vals = self._pad_stack([r.payload for r in requests], bucket)
        # only the real rows cross to the host; padding rows stay behind
        host = [o[:n].cpu().numpy() for o in self.run_raw(vals, bucket)]
        done_t = time.monotonic() if now is None else now
        for i, r in enumerate(requests):
            row_outs = []
            for o in host:
                row = o[i]
                # un-pad the sequence axis (axis 0 of the per-example
                # view) when this output still carries the bucket length
                if (seq is not None and r.seq_len is not None
                        and row.ndim >= 1 and row.shape[0] == seq
                        and r.seq_len < seq):
                    row = row[:r.seq_len]
                row_outs.append(row)
            r._complete(row_outs, done_t)
        return bucket, host

    # -- introspection ----------------------------------------------------
    def weight_bytes(self) -> int:
        return int(sum(p.numel() * p.element_size()
                       for p in self._model.parameters()))


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dt)).dtype
