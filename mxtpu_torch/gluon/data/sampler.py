"""Samplers (the counterpart of ``mxtpu/gluon/data/sampler.py``;
reference ``python/mxnet/gluon/data/sampler.py``†).  ``RandomSampler``
draws its permutation from numpy's global stream, as mxtpu's does, so
equal seeds give mxtpu's order."""
from __future__ import annotations

import numpy as np

from ...base import MXNetError

__all__ = ["Sampler", "SequentialSampler", "RandomSampler",
           "BatchSampler"]


class Sampler:
    """Yields sample indices (reference†)."""

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    def __init__(self, length: int):
        self._length = length

    def __iter__(self):
        return iter(range(self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    def __init__(self, length: int):
        self._length = length

    def __iter__(self):
        return iter(np.random.permutation(self._length).tolist())

    def __len__(self):
        return self._length


class BatchSampler(Sampler):
    """Groups a sampler into batches; last_batch in
    {'keep','discard','rollover'} (reference†)."""

    def __init__(self, sampler: Sampler, batch_size: int,
                 last_batch: str = "keep"):
        if last_batch not in ("keep", "discard", "rollover"):
            raise MXNetError(f"bad last_batch {last_batch!r}")
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev: list = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for idx in self._sampler:
            batch.append(idx)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "rollover":
                self._prev = batch

    def __len__(self):
        n = len(self._sampler) + len(self._prev)
        if self._last_batch == "keep":
            return (n + self._batch_size - 1) // self._batch_size
        if self._last_batch == "discard":
            return n // self._batch_size
        if self._last_batch == "rollover":
            return n // self._batch_size
        raise MXNetError("unreachable")
