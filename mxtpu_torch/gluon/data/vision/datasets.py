"""Vision datasets (the counterpart of
``mxtpu/gluon/data/vision/datasets.py``; reference
``python/mxnet/gluon/data/vision/datasets.py``†).

The reference downloads its archives at first use; here, as in mxtpu,
a dataset reads files already placed under ``root`` (upstream's file
names) and raises when they are absent.  Images come as host (CPU)
NDArrays, HWC; ``ImageRecordDataset`` and ``ImageFolderDataset``
decode through ``cv2`` at the call, as mxtpu's do.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile
from typing import Callable, Optional

import numpy as np

from ....base import MXNetError
from ....context import cpu
from ....ndarray.ndarray import array
from ..dataset import Dataset, RecordFileDataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset"]


class _DownloadedDataset(Dataset):
    def __init__(self, root: str, train: bool,
                 transform: Optional[Callable]):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._data = None
        self._label = None
        self._get_data()

    def __len__(self):
        return len(self._label)

    def __getitem__(self, idx):
        img = array(self._data[idx], ctx=cpu())
        label = self._label[idx]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def _get_data(self):
        raise NotImplementedError


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(dims)


class MNIST(_DownloadedDataset):
    """MNIST from pre-placed idx files (reference ``MNIST``†).
    Accepts both gzipped and raw idx files."""

    _train_files = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte")
    _test_files = ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")

    def __init__(self, root="~/.mxnet/datasets/mnist", train=True,
                 transform=None):
        super().__init__(root, train, transform)

    def _find(self, base: str) -> str:
        for cand in (base, base + ".gz"):
            p = os.path.join(self._root, cand)
            if os.path.exists(p):
                return p
        raise MXNetError(
            f"{base}[.gz] not found under {self._root}; place the MNIST "
            f"idx files there (no network access to download)")

    def _get_data(self):
        imgs, labels = (self._train_files if self._train
                        else self._test_files)
        data = _read_idx(self._find(imgs))
        self._data = data.reshape(-1, 28, 28, 1)
        self._label = _read_idx(self._find(labels)).astype(np.int32)


class FashionMNIST(MNIST):
    """Same container as MNIST (reference ``FashionMNIST``†)."""

    def __init__(self, root="~/.mxnet/datasets/fashion-mnist", train=True,
                 transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR-10 from the pre-placed python-pickle archive
    (reference ``CIFAR10``†)."""

    _archive = "cifar-10-batches-py"

    def __init__(self, root="~/.mxnet/datasets/cifar10", train=True,
                 transform=None):
        super().__init__(root, train, transform)

    def _batches(self):
        if self._train:
            return [f"data_batch_{i}" for i in range(1, 6)]
        return ["test_batch"]

    def _get_data(self):
        base = os.path.join(self._root, self._archive)
        if not os.path.isdir(base):
            tar = os.path.join(self._root, "cifar-10-python.tar.gz")
            if os.path.exists(tar):
                with tarfile.open(tar) as tf:
                    if hasattr(tarfile, "data_filter"):
                        tf.extractall(self._root, filter="data")
                    else:  # pre-3.12 point releases
                        tf.extractall(self._root)
            else:
                raise MXNetError(
                    f"CIFAR-10 not found under {self._root} (no network "
                    f"access to download)")
        data, labels = [], []
        for name in self._batches():
            with open(os.path.join(base, name), "rb") as f:
                batch = pickle.load(f, encoding="latin1")  # mxlint: disable=raw-deserialize (upstream CIFAR archive format is pickle; file came from the pinned download)
            data.append(batch["data"].reshape(-1, 3, 32, 32)
                        .transpose(0, 2, 3, 1))
            labels.extend(batch["labels"])
        self._data = np.concatenate(data)
        self._label = np.asarray(labels, np.int32)


class CIFAR100(CIFAR10):
    """CIFAR-100 (reference ``CIFAR100``†)."""

    _archive = "cifar-100-python"

    def __init__(self, root="~/.mxnet/datasets/cifar100", train=True,
                 fine_label=True, transform=None):
        self._fine = fine_label
        super().__init__(root, train, transform)

    def _batches(self):
        return ["train"] if self._train else ["test"]

    def _get_data(self):
        base = os.path.join(self._root, self._archive)
        if not os.path.isdir(base):
            raise MXNetError(
                f"CIFAR-100 not found under {self._root} (no network "
                f"access to download)")
        data, labels = [], []
        for name in self._batches():
            with open(os.path.join(base, name), "rb") as f:
                batch = pickle.load(f, encoding="latin1")  # mxlint: disable=raw-deserialize (upstream CIFAR archive format is pickle; file came from the pinned download)
            data.append(batch["data"].reshape(-1, 3, 32, 32)
                        .transpose(0, 2, 3, 1))
            key = "fine_labels" if self._fine else "coarse_labels"
            labels.extend(batch[key])
        self._data = np.concatenate(data)
        self._label = np.asarray(labels, np.int32)


class ImageRecordDataset(RecordFileDataset):
    """Image dataset over an im2rec-style .rec file
    (reference ``ImageRecordDataset``†)."""

    def __init__(self, filename: str, flag: int = 1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from .... import recordio
        record = super().__getitem__(idx)
        header, img = recordio.unpack_img(record, iscolor=self._flag)
        img = array(np.ascontiguousarray(img[:, :, ::-1]) if self._flag
                    else img, ctx=cpu())  # BGR to RGB
        label = header.label
        if isinstance(label, np.ndarray) and label.size == 1:
            label = float(label[0])
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class ImageFolderDataset(Dataset):
    """``root/class_name/*.jpg`` layout (reference†)."""

    def __init__(self, root: str, flag: int = 1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = {".jpg", ".jpeg", ".png"}
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for fname in sorted(os.listdir(path)):
                if os.path.splitext(fname)[1].lower() in self._exts:
                    self.items.append((os.path.join(path, fname), label))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        import cv2
        fname, label = self.items[idx]
        img = cv2.imread(fname,
                         cv2.IMREAD_COLOR if self._flag
                         else cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise MXNetError(f"failed to read image {fname}")
        if self._flag:
            img = img[:, :, ::-1]  # BGR to RGB
        img = array(np.ascontiguousarray(img), ctx=cpu())
        if self._transform is not None:
            return self._transform(img, label)
        return img, label
