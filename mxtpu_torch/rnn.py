"""Legacy ``mx.rnn`` namespace (the counterpart of ``mxtpu/rnn.py``;
reference ``python/mxnet/rnn/``†): the symbol-era cell names, aliases of
``gluon.rnn``'s cells, and ``BucketSentenceIter``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .base import MXNetError
from .context import cpu
from .gluon.rnn import (RNNCell, LSTMCell, GRUCell, SequentialRNNCell,
                        BidirectionalCell, DropoutCell, ResidualCell)
from .io import DataBatch, DataDesc, DataIter
from .ndarray.ndarray import array

__all__ = ["RNNCell", "LSTMCell", "GRUCell", "SequentialRNNCell",
           "BidirectionalCell", "DropoutCell", "ResidualCell",
           "BucketSentenceIter"]


class BucketSentenceIter(DataIter):
    """Bucketed sentence iterator (reference ``BucketSentenceIter``†):
    each integer sequence goes to the tightest bucket that holds it,
    padded with ``invalid_label``; a batch carries ``bucket_key`` for
    ``BucketingModule`` and its labels are the next-token shift.
    Sequences longer than the largest bucket are dropped.  The order is
    drawn from numpy's global RNG, as mxtpu's; batches are host (CPU)
    arrays, which a Module copies onto its device."""

    def __init__(self, sentences: Sequence[Sequence[int]],
                 batch_size: int, buckets: Optional[List[int]] = None,
                 invalid_label: int = -1, data_name: str = "data",
                 label_name: str = "softmax_label", dtype=np.float32):
        super().__init__(batch_size)
        if buckets is None:
            lens = np.bincount([len(s) for s in sentences])
            buckets = [i for i, n in enumerate(lens) if n >= batch_size]
        buckets = sorted(buckets)
        if not buckets:
            raise MXNetError("no usable buckets")
        self.buckets = buckets
        self.data_name = data_name
        self.label_name = label_name
        self.invalid_label = invalid_label
        self.dtype = dtype
        self.data: List[List[np.ndarray]] = [[] for _ in buckets]
        for s in sentences:
            buck = next((i for i, b in enumerate(buckets) if b >= len(s)),
                        None)
            if buck is None:
                continue
            buf = np.full((buckets[buck],), invalid_label, dtype)
            buf[:len(s)] = s
            self.data[buck].append(buf)
        self.data = [np.asarray(x, dtype) if len(x) else
                     np.empty((0, b), dtype)
                     for x, b in zip(self.data, buckets)]
        self.default_bucket_key = max(buckets)
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(self.data_name,
                         (self.batch_size, self.default_bucket_key),
                         self.dtype)]

    @property
    def provide_label(self):
        return [DataDesc(self.label_name,
                         (self.batch_size, self.default_bucket_key),
                         self.dtype)]

    def reset(self):
        self.curr_idx = 0
        self.idx = []
        for i, buck in enumerate(self.data):
            np.random.shuffle(buck)
            for j in range(0, len(buck) - self.batch_size + 1,
                           self.batch_size):
                self.idx.append((i, j))
        np.random.shuffle(self.idx)

    def next(self) -> DataBatch:
        if self.curr_idx >= len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        buck_len = self.buckets[i]
        chunk = self.data[i][j:j + self.batch_size]
        label = np.full_like(chunk, self.invalid_label)
        label[:, :-1] = chunk[:, 1:]
        host = cpu()
        batch = DataBatch(
            data=[array(chunk, ctx=host)], label=[array(label, ctx=host)],
            pad=0,
            provide_data=[DataDesc(self.data_name,
                                   (self.batch_size, buck_len), self.dtype)],
            provide_label=[DataDesc(self.label_name,
                                    (self.batch_size, buck_len),
                                    self.dtype)])
        batch.bucket_key = buck_len
        return batch

    def iter_next(self):
        return self.curr_idx < len(self.idx)
