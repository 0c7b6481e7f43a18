"""Data iterators (the counterpart of ``mxtpu/io.py``): ``DataDesc``,
``DataBatch``, ``DataIter`` and ``NDArrayIter``.

Batches are host-side NDArrays (on the CPU): placing them on the card
is the consumer's job (``Module.forward`` copies each batch onto its
device), as in the JAX package.  ``NDArrayIter`` shuffles with an
explicit ``numpy.random.RandomState`` (``rng=``); without one it draws
from numpy's global stream as mxtpu does, so equal seeds give mxtpu's
order.  Not ported yet: ``ResizeIter``, ``PrefetchingIter``,
``DeviceFeedIter`` and the file iterators.
"""
from __future__ import annotations

from collections import namedtuple
from typing import List, Optional

import numpy as np

from .base import MXNetError
from .context import cpu
from .ndarray.ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape", "dtype", "layout"])):
    """Shape/dtype descriptor of one input (reference ``DataDesc``†)."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        return super().__new__(cls, name, tuple(shape), np.dtype(dtype),
                               layout)

    @staticmethod
    def get_batch_axis(layout: Optional[str]) -> int:
        return 0 if layout is None else layout.find("N")


class DataBatch:
    """One batch (reference ``DataBatch``†); ``pad`` counts the samples
    at the tail that repeat the head and are not part of the data."""

    def __init__(self, data, label=None, pad=0, index=None,
                 provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        shapes = [getattr(d, "shape", None) for d in (self.data or [])]
        return f"DataBatch: data shapes {shapes} pad {self.pad}"


class DataIter:
    """Iterator base (reference ``DataIter``†)."""

    def __init__(self, batch_size: int = 0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self) -> DataBatch:
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self) -> bool:
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        return 0


def _init_data(data, allow_empty: bool, default_name: str):
    """An ordered name → numpy list from an array, a list or a dict
    (reference ``_init_data``†)."""
    if data is None:
        if not allow_empty:
            raise MXNetError("data cannot be None")
        return []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        if not allow_empty and len(data) == 0:
            raise MXNetError("empty data list")
        items = [(default_name, data[0])] if len(data) == 1 else \
            [(f"_{i}_{default_name}", d) for i, d in enumerate(data)]
    elif isinstance(data, dict):
        items = sorted(data.items())
    else:
        raise MXNetError(f"unsupported data type {type(data)}")
    return [(name, arr.asnumpy() if isinstance(arr, NDArray)
             else np.asarray(arr)) for name, arr in items]


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (reference ``NDArrayIter``†).

    ``last_batch_handle``: ``"pad"`` (fill from the head; ``batch.pad``
    says how many), ``"discard"``, or ``"roll_over"`` (the leftover
    starts the next epoch).  ``rng``: the ``RandomState`` that shuffles
    (default numpy's global stream)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", rng=None):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.num_data = self.data[0][1].shape[0]
        for name, arr in self.data + self.label:
            if arr.shape[0] != self.num_data:
                raise MXNetError(
                    f"{name} has {arr.shape[0]} samples, expected "
                    f"{self.num_data}")
        if last_batch_handle not in ("pad", "discard", "roll_over"):
            raise MXNetError(f"bad last_batch_handle {last_batch_handle}")
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self._rng = np.random if rng is None else rng
        self._rollover_remainder: Optional[np.ndarray] = None
        self.reset()

    @property
    def provide_data(self) -> List[DataDesc]:
        return [DataDesc(name, (self.batch_size,) + arr.shape[1:],
                         arr.dtype) for name, arr in self.data]

    @property
    def provide_label(self) -> List[DataDesc]:
        return [DataDesc(name, (self.batch_size,) + arr.shape[1:],
                         arr.dtype) for name, arr in self.label]

    def reset(self):
        order = np.arange(self.num_data)
        if self.shuffle:
            self._rng.shuffle(order)
        if self._rollover_remainder is not None and \
                self.last_batch_handle == "roll_over":
            order = np.concatenate([self._rollover_remainder, order])
            self._rollover_remainder = None
        self._order = order
        self.cursor = 0

    def __len__(self):
        """Batches per epoch (for ``"roll_over"`` without a carried
        remainder)."""
        if self.last_batch_handle == "pad":
            return -(-self.num_data // self.batch_size)
        return self.num_data // self.batch_size

    def iter_next(self) -> bool:
        n = len(self._order)
        if self.last_batch_handle == "discard":
            return self.cursor + self.batch_size <= n
        if self.cursor >= n:
            return False
        if self.cursor + self.batch_size > n and \
                self.last_batch_handle == "roll_over":
            self._rollover_remainder = self._order[self.cursor:]
            return False
        return True

    def next(self) -> DataBatch:
        if not self.iter_next():
            raise StopIteration
        idx = self._order[self.cursor:self.cursor + self.batch_size]
        pad = self.batch_size - len(idx)
        if pad:
            # wrap from the head as often as needed: batches are never
            # ragged
            reps, need = [idx], pad
            while need > 0:
                take = self._order[:need]
                reps.append(take)
                need -= len(take)
            idx = np.concatenate(reps)
        self.cursor += self.batch_size
        host = cpu()
        return DataBatch(data=[array(a[idx], ctx=host) for _, a in self.data],
                         label=[array(a[idx], ctx=host)
                                for _, a in self.label],
                         pad=pad, index=idx.copy(),
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)
