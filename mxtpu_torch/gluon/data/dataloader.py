"""DataLoader (the counterpart of ``mxtpu/gluon/data/dataloader.py``;
reference ``python/mxnet/gluon/data/dataloader.py``†).

Two kinds of workers, as in mxtpu:

- ``worker_type="thread"`` (the default): a thread pool runs
  ``batchify_fn`` (numpy, which releases the GIL for its copies).
- ``worker_type="process"``: **spawned** processes, for pure-Python
  transforms that would hold the GIL.  The dataset is pickled once to
  each worker, which keeps its pool across epochs; batches come back as
  numpy and become NDArrays on the consumer.  A worker never touches
  CUDA: it starts with ``CUDA_VISIBLE_DEVICES`` empty.  Datasets and
  transforms must pickle and return numpy-convertible samples.

Batches are host (CPU) NDArrays: placing them on the card is the
consumer's job, as for the iterators.
"""
from __future__ import annotations

import os
import pickle
import queue as _queue
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np

from ...base import MXNetError
from ...context import cpu
from ...ndarray.ndarray import NDArray, array
from .dataset import Dataset
from .sampler import BatchSampler, RandomSampler, SequentialSampler, Sampler

__all__ = ["DataLoader", "default_batchify_fn"]

# -- process workers (module level: they must pickle) ------------------
_WORKER_DATASET = None


def _proc_worker_init(dataset_blob: bytes) -> None:
    global _WORKER_DATASET
    # a worker must never create a CUDA context
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    _WORKER_DATASET = pickle.loads(dataset_blob)  # mxlint: disable=raw-deserialize (in-process IPC: bytes this parent just pickled, never touch disk)


def _np_batchify(samples):
    """Stack samples in numpy (the worker side; the consumer makes the
    NDArrays)."""
    first = samples[0]
    if isinstance(first, tuple):
        return tuple(_np_batchify([s[i] for s in samples])
                     for i in range(len(first)))
    return np.stack([np.asarray(s) for s in samples])


def _proc_worker_load(indices):
    return _np_batchify([_WORKER_DATASET[i] for i in indices])


def default_batchify_fn(data):
    """Stack samples into a host batch (reference
    ``default_batchify_fn``†); tuples batch field by field."""
    if isinstance(data[0], NDArray):
        return array(np.stack([d.asnumpy() for d in data]), ctx=cpu())
    if isinstance(data[0], tuple):
        return tuple(default_batchify_fn(list(col)) for col in zip(*data))
    return array(np.asarray(data), ctx=cpu())


class DataLoader:
    """Batches of a Dataset (reference ``DataLoader``†): a sampler (or
    ``shuffle``), ``batch_size`` and ``last_batch`` ("keep",
    "discard" or "rollover"), or a ``batch_sampler``; ``num_workers``
    threads or spawned processes, ``prefetch`` batches in flight
    (default twice the workers)."""

    def __init__(self, dataset: Dataset, batch_size: Optional[int] = None,
                 shuffle: bool = False, sampler: Optional[Sampler] = None,
                 last_batch: Optional[str] = None,
                 batch_sampler: Optional[BatchSampler] = None,
                 batchify_fn: Optional[Callable] = None,
                 num_workers: int = 0, prefetch: Optional[int] = None,
                 worker_type: str = "thread"):
        self._dataset = dataset
        if worker_type not in ("thread", "process"):
            raise MXNetError(f"worker_type {worker_type!r}: choose "
                             f"'thread' or 'process'")
        self._worker_type = worker_type
        if worker_type == "process" and batchify_fn is not None:
            raise MXNetError("custom batchify_fn runs on the consumer "
                             "only in thread mode; process workers use "
                             "the numpy batchifier")
        if batch_sampler is None:
            if batch_size is None:
                raise MXNetError("need batch_size unless batch_sampler "
                                 "is given")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle else \
                    SequentialSampler(len(dataset))
            elif shuffle:
                raise MXNetError("shuffle and sampler are exclusive")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif (batch_size is not None or shuffle or sampler is not None
              or last_batch is not None):
            raise MXNetError("batch_sampler is exclusive with batch_size/"
                             "shuffle/sampler/last_batch")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._num_workers = max(0, num_workers)
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * self._num_workers)
        self._proc_pool = None
        self._thread_pool = None

    def __len__(self):
        return len(self._batch_sampler)

    def _load_batch(self, indices):
        return self._batchify_fn([self._dataset[i] for i in indices])

    @staticmethod
    def _to_nd(batch):
        if isinstance(batch, tuple):
            return tuple(DataLoader._to_nd(b) for b in batch)
        return array(batch, ctx=cpu())

    def __iter__(self):
        if self._num_workers == 0:
            for indices in self._batch_sampler:
                yield self._load_batch(indices)
            return

        if self._worker_type == "process":
            # the pool outlives epochs: the spawn and the dataset's
            # pickle happen once
            if self._proc_pool is None:
                import multiprocessing as mp
                self._proc_pool = ProcessPoolExecutor(
                    self._num_workers,
                    mp_context=mp.get_context("spawn"),
                    initializer=_proc_worker_init,
                    initargs=(pickle.dumps(self._dataset),))
            pool, load, wrap = self._proc_pool, _proc_worker_load, \
                self._to_nd
        else:
            if self._thread_pool is None:
                self._thread_pool = ThreadPoolExecutor(self._num_workers)
            pool, load, wrap = self._thread_pool, self._load_batch, \
                (lambda b: b)

        # a bounded number of batches in flight, in order
        batches = iter(self._batch_sampler)
        inflight: _queue.Queue = _queue.Queue()

        def submit_next():
            try:
                indices = next(batches)
            except StopIteration:
                return False
            inflight.put(pool.submit(load, list(indices)))
            return True

        for _ in range(max(1, self._prefetch)):
            if not submit_next():
                break
        while not inflight.empty():
            fut = inflight.get()
            submit_next()
            yield wrap(fut.result())

    def close(self) -> None:
        """Shut the persistent worker pools down; the worker processes
        are joined."""
        if self._proc_pool is not None:
            self._proc_pool.shutdown(wait=True)
            self._proc_pool = None
        if self._thread_pool is not None:
            self._thread_pool.shutdown(wait=False)
            self._thread_pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
