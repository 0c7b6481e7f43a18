"""Datasets (the counterpart of ``mxtpu/gluon/data/dataset.py``;
reference ``python/mxnet/gluon/data/dataset.py``†): ``Dataset`` with
``transform``/``transform_first``, ``SimpleDataset``, ``ArrayDataset``
and ``RecordFileDataset`` over an indexed RecordIO file."""
from __future__ import annotations

from ...base import MXNetError

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset",
           "RecordFileDataset"]


class Dataset:
    """Abstract dataset: ``__getitem__`` + ``__len__`` (reference†)."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def transform(self, fn, lazy=True):
        """Return a dataset with ``fn(*item)`` applied (reference†)."""
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        """Apply ``fn`` to the first element only (the usual image
        transform entry; reference†)."""
        return self.transform(_TransformFirstClosure(fn), lazy)


class _TransformFirstClosure:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class SimpleDataset(Dataset):
    """Wrap any sized indexable (reference ``SimpleDataset``†)."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class ArrayDataset(Dataset):
    """Zip several equal-length arrays (reference ``ArrayDataset``†)."""

    def __init__(self, *args):
        if not args:
            raise MXNetError("ArrayDataset needs at least one array")
        self._length = len(args[0])
        for i, a in enumerate(args):
            if len(a) != self._length:
                raise MXNetError(
                    f"all arrays must have the same length; arg {i} has "
                    f"{len(a)} != {self._length}")
        self._data = args

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)


class RecordFileDataset(Dataset):
    """A dataset over an indexed RecordIO file (reference†)."""

    def __init__(self, filename: str):
        self._filename = filename
        idx_file = filename[:filename.rfind(".")] + ".idx"
        from ... import recordio
        self._record = recordio.MXIndexedRecordIO(idx_file, filename, "r")

    def __len__(self):
        return len(self._record.keys)

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])
