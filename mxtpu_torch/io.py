"""Data iterators (the counterpart of ``mxtpu/io.py``): ``DataDesc``,
``DataBatch``, ``DataIter``, ``NDArrayIter``, ``ResizeIter``,
``PrefetchingIter``, ``DeviceFeedIter`` and ``ImageRecordIter``.

Batches are host-side NDArrays (on the CPU), or numpy arrays where
``ImageRecordIter(host_batches=True)`` asks: placing them on the card
is the consumer's job (``Module.forward`` and ``TrainStep`` copy each
batch onto their device), or :class:`DeviceFeedIter`'s, which copies
batch N+1 while the step runs on batch N.  ``NDArrayIter`` shuffles
with an explicit ``numpy.random.RandomState`` (``rng=``); without one
it draws from numpy's global stream as mxtpu does, so equal seeds give
mxtpu's order.  ``ImageRecordIter`` draws its order and augmentations
from ``RandomState(seed)`` in mxtpu's order, so a seeded run hands over
mxtpu's batches bit for bit.  Not ported yet: ``CSVIter``,
``LibSVMIter`` and ``MNISTIter``.
"""
from __future__ import annotations

import os
import queue
import threading
from collections import namedtuple
from typing import List, Optional

import numpy as np
import torch

from .base import MXNetError
from .context import cpu, resolve_device
from .ndarray.ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter",
           "ResizeIter", "PrefetchingIter", "DeviceFeedIter",
           "ImageRecordIter"]


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


class ResizeIter(DataIter):
    """Another iterator resized to ``size`` batches an epoch (reference
    ``ResizeIter``†): it restarts the inner one when that runs out."""

    def __init__(self, data_iter: DataIter, size: int,
                 reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch: Optional[DataBatch] = None

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self) -> bool:
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self) -> DataBatch:
        if not self.iter_next():
            raise StopIteration
        return self.current_batch


class PrefetchingIter(DataIter):
    """One or more iterators read ahead by a worker thread into a queue
    of two batches (reference ``PrefetchingIter``†, the Python face of
    ``iter_prefetcher.h``†'s double buffering).  ``reset`` stops the
    worker, drains the queue, joins the thread and starts anew."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        self.iters = iters if isinstance(iters, (list, tuple)) else [iters]
        super().__init__(self.iters[0].batch_size)
        self.rename_data = rename_data
        self.rename_label = rename_label
        self._queue: "queue.Queue" = queue.Queue(maxsize=2)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._start()

    def _start(self):
        stop, q = self._stop, self._queue

        def worker():
            while not stop.is_set():
                try:
                    batches = [it.next() for it in self.iters]
                except StopIteration:
                    q.put(None)
                    return
                except BaseException as e:   # handed to the consumer
                    q.put(e)
                    return
                q.put(batches)
        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    @property
    def provide_data(self):
        return sum([it.provide_data for it in self.iters], [])

    @property
    def provide_label(self):
        return sum([it.provide_label for it in self.iters], [])

    def _drain(self):
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass

    def reset(self):
        self._stop.set()
        # drain until the worker is out of a blocking put and gone
        while self._thread.is_alive():
            self._drain()
            self._thread.join(timeout=0.01)
        self._drain()
        for it in self.iters:
            it.reset()
        self._stop = threading.Event()
        self._queue = queue.Queue(maxsize=2)
        self._start()

    def next(self) -> DataBatch:
        batches = self._queue.get()
        if batches is None or isinstance(batches, BaseException):
            self._queue.put(batches)   # the worker is gone: say it again
            if batches is None:
                raise StopIteration
            raise batches
        if len(batches) == 1:
            return batches[0]
        return DataBatch(
            data=sum([b.data for b in batches], []),
            label=sum([b.label for b in batches], []),
            pad=max(b.pad for b in batches))

    def iter_next(self):
        raise MXNetError("use next() on PrefetchingIter")

    def close(self) -> None:
        """Stop the worker and join it (also at reset and at GC)."""
        self._stop.set()
        if self._thread is not None:
            while self._thread.is_alive():
                self._drain()
                self._thread.join(timeout=0.01)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class _Staged(DataIter):
    """``data_iter``'s batches passed through ``stage``: the inner
    iterator of :class:`DeviceFeedIter`'s staging thread."""

    def __init__(self, data_iter: DataIter, stage):
        super().__init__(data_iter.batch_size)
        self.data_iter, self._stage = data_iter, stage

    def next(self) -> DataBatch:
        return self._stage(self.data_iter.next())

    def reset(self):
        self.data_iter.reset()


class DeviceFeedIter(DataIter):
    """The host-to-device half of the reference's PrefetcherIter
    (``iter_prefetcher.h``†), as mxtpu's ``DeviceFeedIter``: batches
    ahead of the consumer are already on their way to the card.  When
    ``next()`` hands over batch N, the copies of the next ones have been
    issued and run under the step for N.

    A staging thread (a :class:`PrefetchingIter` over the wrapped
    iterator) copies each host array into a pinned buffer of a ring of
    slots and issues its copy to the card on a copy stream of its own,
    then records an event; so the consumer's thread, which launches the
    step, does no host copy.  At the handover the consumer's stream
    waits on that event (the step's kernels follow the copy, and nothing
    else does), and the device tensors are marked as used on the
    consumer's stream.  A slot's pinned buffers are refilled only after
    the host has waited on the event of the copy that last read them,
    so no batch in flight is overwritten.  A tensor already on the card
    passes as it is.

    ``ctx=cpu()`` hands over the host batch as CPU NDArrays (the tests'
    path); the default is the card, which raises without CUDA.
    Compose with :class:`PrefetchingIter` and ``ImageRecordIter(...,
    host_batches=True)`` for the whole pipeline: disk, assembly on a
    worker thread, staging and the copy on another, the step."""

    def __init__(self, data_iter: DataIter, ctx=None):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self._device = resolve_device(ctx)
        self._cuda = self._device.type == "cuda"
        self._stream = torch.cuda.Stream(self._device) if self._cuda \
            else None
        # each slot: (pinned buffers by position, the event after their
        # copy); the staging thread's queue holds two batches, a third
        # is being staged and a fourth was handed over
        self._ring = [([], None) for _ in range(5)]
        self._slot = 0
        self._staged = PrefetchingIter(_Staged(data_iter, self._stage))

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    @staticmethod
    def _host(a):
        if isinstance(a, NDArray):
            a = a.data
        if isinstance(a, torch.Tensor):
            return a
        return torch.from_numpy(np.ascontiguousarray(a))

    def _stage(self, batch: DataBatch) -> DataBatch:
        """On the staging thread: the batch's arrays on their way to the
        device, and the event that follows their copies."""
        arrs = [self._host(a) for a in (batch.data or [])] + \
            [self._host(a) for a in (batch.label or [])]
        event = None
        if not self._cuda:
            out = [NDArray(t.detach().to(self._device, copy=True))
                   for t in arrs]
        else:
            bufs, event = self._ring[self._slot]
            if event is not None:
                event.synchronize()   # the copy that read this slot is done
            out = []
            with torch.cuda.stream(self._stream):
                for i, t in enumerate(arrs):
                    if t.device == self._device:
                        out.append(NDArray(t))
                        continue
                    if i >= len(bufs) or bufs[i].shape != t.shape or \
                            bufs[i].dtype != t.dtype:
                        buf = torch.empty(t.shape, dtype=t.dtype,
                                          pin_memory=True)
                        bufs[i:i + 1] = [buf]
                    bufs[i].copy_(t)
                    out.append(NDArray(bufs[i].to(self._device,
                                                  non_blocking=True)))
                event = torch.cuda.Event()
                event.record(self._stream)
            self._ring[self._slot] = (bufs, event)
            self._slot = (self._slot + 1) % len(self._ring)
        n = len(batch.data or [])
        staged = DataBatch(data=out[:n], label=out[n:], pad=batch.pad,
                           index=batch.index,
                           provide_data=batch.provide_data,
                           provide_label=batch.provide_label)
        staged._event = event
        return staged

    def reset(self):
        self._staged.reset()

    def next(self) -> DataBatch:
        out = self._staged.next()
        if out._event is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(out._event)
            for a in out.data + out.label:
                a.data.record_stream(consumer)
        return out

    def iter_next(self):
        raise MXNetError("use next() on DeviceFeedIter")

    def close(self) -> None:
        """Stop the staging thread (the wrapped iterator is the
        caller's to close)."""
        self._staged.close()


class ImageRecordIter(DataIter):
    """Image batches from a RecordIO file, decoded and augmented on the
    host (reference ``ImageRecordIter``, ``iter_image_recordio_2.cc``†;
    mxtpu's ``ImageRecordIter``): random crop and mirror, per-channel
    mean, scale and std, ``label_width`` labels, the last batch padded
    from its head (``round_batch``) or dropped.

    ``raw_records=True`` takes records of undecoded CHW pixel bytes at
    ``data_shape``; an indexed file is then read a batch at a time
    (``recordio.read_batch_into``), mirrored blockwise, and
    ``dtype="uint8"`` hands the pixels over without normalizing, for a
    normalization on the card.  ``host_batches=True`` yields numpy
    instead of NDArrays (the producer side of a :class:`DeviceFeedIter`
    pipeline).  Other records are JPEG/PNG images decoded by ``cv2`` at
    the call, as mxtpu's are.  The order (``shuffle`` needs
    ``path_imgidx``) and the three augmentation uniforms a record
    (crop y, crop x, mirror) are drawn serially from
    ``RandomState(seed)``, so the decode pool's scheduling changes
    nothing and a seeded run equals mxtpu's."""

    def __init__(self, path_imgrec: str, data_shape, batch_size=1,
                 path_imgidx: Optional[str] = None, shuffle=False,
                 rand_crop=False, rand_mirror=False, mean_r=0.0,
                 mean_g=0.0, mean_b=0.0, std_r=1.0, std_g=1.0, std_b=1.0,
                 scale=1.0, label_width=1, round_batch=True,
                 preprocess_threads=4, seed=0, raw_records=False,
                 dtype="float32", host_batches=False, **_ignored):
        super().__init__(batch_size)
        from . import recordio as rio
        self.raw_records = bool(raw_records)
        self.host_batches = bool(host_batches)
        self._raw_batched = True      # drops to per-record on ragged files
        self._raw_meta = None         # (header_bytes, flag), lazy
        self._out_dtype = np.dtype(dtype)
        if self._out_dtype not in (np.dtype(np.float32),
                                   np.dtype(np.uint8)):
            raise MXNetError("ImageRecordIter dtype must be float32 "
                             "or uint8")
        self.data_shape = tuple(data_shape)
        self.rand_crop = rand_crop
        self.rand_mirror = rand_mirror
        self.mean = np.array([mean_r, mean_g, mean_b], np.float32)
        self.std = np.array([std_r, std_g, std_b], np.float32)
        self.scale = scale
        self.label_width = label_width
        self.shuffle = shuffle
        self._rng = np.random.RandomState(seed)
        self._threads = max(1, int(preprocess_threads))
        self._pool = None
        if path_imgidx and os.path.exists(path_imgidx):
            self._rec = rio.MXIndexedRecordIO(path_imgidx, path_imgrec,
                                              "r")
            self._keys = list(self._rec.keys)
        else:
            self._rec = rio.MXRecordIO(path_imgrec, "r")
            self._keys = None
            if shuffle:
                raise MXNetError("shuffle requires path_imgidx")
        self.last_batch_handle = "pad" if round_batch else "discard"
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shp = (self.batch_size,) if self.label_width == 1 else \
            (self.batch_size, self.label_width)
        return [DataDesc("softmax_label", shp)]

    def reset(self):
        if self._keys is not None:
            self._order = list(self._keys)
            if self.shuffle:
                self._rng.shuffle(self._order)
            self._pos = 0
        else:
            self._rec.reset()
        self._exhausted = False

    def _read_raw(self) -> Optional[bytes]:
        if self._keys is not None:
            if self._pos >= len(self._order):
                return None
            raw = self._rec.read_idx(self._order[self._pos])
            self._pos += 1
            return raw
        return self._rec.read()

    def close(self) -> None:
        """Release the decode pool (also at GC)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _label(self, label):
        if isinstance(label, np.ndarray) and self.label_width == 1:
            return float(label[0])
        return label

    def _decode_one(self, raw: bytes, aug_u=(0.0, 0.0, 0.0)):
        """One record's CHW image and label; ``aug_u`` holds its three
        pre-drawn uniforms (crop y, crop x, mirror)."""
        from . import recordio as rio
        if self.raw_records:
            header, body = rio.unpack(raw)
            arr = np.frombuffer(body, np.uint8).reshape(self.data_shape)
            if self.rand_mirror and aug_u[2] < 0.5:
                arr = arr[:, :, ::-1]
            if self._out_dtype == np.uint8:
                return arr, self._label(header.label)
            img32 = (arr.astype(np.float32) -
                     self.mean.reshape(3, 1, 1)) * self.scale / \
                self.std.reshape(3, 1, 1)
            return img32, self._label(header.label)
        header, img = rio.unpack_img(raw, iscolor=1)
        c, h, w = self.data_shape
        ih, iw = img.shape[:2]
        if self.rand_crop and ih >= h and iw >= w:
            y0 = int(aug_u[0] * (ih - h + 1))
            x0 = int(aug_u[1] * (iw - w + 1))
            img = img[y0:y0 + h, x0:x0 + w]
        elif (ih, iw) != (h, w):
            import cv2
            img = cv2.resize(img, (w, h))
        if self.rand_mirror and aug_u[2] < 0.5:
            img = img[:, ::-1]
        img = img[:, :, ::-1]  # BGR to RGB
        if self._out_dtype == np.uint8:
            img = np.ascontiguousarray(img)
        else:
            # the reference's order: the mean in pixel units, then the
            # scale, then the std
            img = (img.astype(np.float32) - self.mean) * self.scale / \
                self.std
        return img.transpose(2, 0, 1), self._label(header.label)

    # -- a raw batch assembled at once ---------------------------------
    def _raw_init_meta(self, first_raw: bytes):
        """(header bytes, flag) from the first record: a raw file holds
        one shape and one label flag."""
        from . import recordio as rio
        header, body = rio.unpack(first_raw)
        nbytes = int(np.prod(self.data_shape))
        if len(body) != nbytes:
            raise MXNetError(
                f"raw record payload is {len(body)} bytes but "
                f"data_shape {self.data_shape} needs {nbytes}")
        self._raw_meta = (len(first_raw) - nbytes, int(header.flag))

    def _parse_raw_headers(self, hdrs: bytes, n: int) -> np.ndarray:
        """The n records' labels as (n, label_width) float32."""
        from . import recordio as rio
        hdr_bytes, flag = self._raw_meta
        h = np.frombuffer(hdrs, np.uint8).reshape(n, hdr_bytes)
        if flag == 0:
            lab = h[:, 4:8].copy().view(np.float32)
            if self.label_width > 1:
                lab = np.broadcast_to(lab, (n, self.label_width))
        else:
            if flag < self.label_width:
                raise MXNetError(
                    f"records carry {flag} labels, label_width is "
                    f"{self.label_width}")
            lab = h[:, rio._IR_SIZE:rio._IR_SIZE + 4 * flag].copy() \
                .view(np.float32)[:, :self.label_width]
        return np.ascontiguousarray(lab, np.float32)

    def _wrap(self, data, lab):
        if self.host_batches:
            return [data], [lab]
        return [array(data, ctx=cpu())], [array(lab, ctx=cpu())]

    def _next_raw_batch(self) -> DataBatch:
        from . import recordio as rio
        if self._exhausted:
            raise StopIteration
        B = self.batch_size
        nbytes = int(np.prod(self.data_shape))
        pix = np.empty((B,) + self.data_shape, np.uint8)
        if self._keys is not None:
            n = min(B, len(self._order) - self._pos)
            keys = self._order[self._pos:self._pos + n]
            self._pos += n
            if n:
                if self._raw_meta is None:
                    self._raw_init_meta(self._rec.read_idx(keys[0]))
                hdr_bytes, _ = self._raw_meta
                try:
                    hdrs = rio.read_batch_into(
                        self._rec.uri, [self._rec.idx[k] for k in keys],
                        [hdr_bytes + nbytes] * n, pix[:n], hdr_bytes,
                        self._threads)
                except (OSError, ValueError, MXNetError):
                    # irregular records: rewind and let the per-record
                    # path, which frames every record, take them
                    self._pos -= n
                    self._raw_batched = False
                    return self._next_per_record()
        else:
            raws = []
            while len(raws) < B:
                raw = self._rec.read()
                if raw is None:
                    break
                raws.append(raw)
            n = len(raws)
            if n:
                if self._raw_meta is None:
                    self._raw_init_meta(raws[0])
                hdr_bytes, _ = self._raw_meta
                if any(len(r) != hdr_bytes + nbytes for r in raws):
                    raise MXNetError(
                        "ragged raw records (lengths differ); cannot "
                        "batch-assemble")
                rows = np.frombuffer(b"".join(raws), np.uint8) \
                    .reshape(n, hdr_bytes + nbytes)
                pix[:n].reshape(n, nbytes)[...] = rows[:, hdr_bytes:]
                hdrs = rows[:, :hdr_bytes].tobytes()
        if n == 0:
            self._exhausted = True
            raise StopIteration
        labels = self._parse_raw_headers(hdrs, n)
        aug = self._rng.rand(n, 3)
        if self.rand_mirror:
            m = np.nonzero(aug[:, 2] < 0.5)[0]
            if m.size:
                pix[m] = pix[m][..., ::-1]
        pad = B - n
        if pad:
            self._exhausted = True
            if self.last_batch_handle == "discard":
                raise StopIteration
            reps = np.arange(n, B) % n
            pix[n:] = pix[reps]
            labels = np.concatenate([labels, labels[reps]], axis=0)
        if self._out_dtype == np.uint8:
            data = pix
        else:
            data = (pix.astype(np.float32) -
                    self.mean.reshape(1, 3, 1, 1)) * self.scale / \
                self.std.reshape(1, 3, 1, 1)
        lab = labels[:, 0] if self.label_width == 1 else labels
        data, lab = self._wrap(data, lab)
        return DataBatch(data=data, label=lab, pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def next(self) -> DataBatch:
        if self.raw_records and self._raw_batched:
            return self._next_raw_batch()
        return self._next_per_record()

    def _next_per_record(self) -> DataBatch:
        if self._exhausted:
            raise StopIteration
        c, h, w = self.data_shape
        data = np.zeros((self.batch_size, c, h, w), self._out_dtype)
        labels = np.zeros((self.batch_size, self.label_width), np.float32)
        raws = []
        while len(raws) < self.batch_size:
            raw = self._read_raw()
            if raw is None:
                break
            raws.append(raw)
        n = len(raws)
        # the uniforms come serially from the seeded stream, whatever
        # the decode pool's scheduling
        aug = self._rng.rand(n, 3) if n else None
        if n and self._threads > 1:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor
                self._pool = ThreadPoolExecutor(self._threads)
            decoded = self._pool.map(self._decode_one, raws, aug)
        else:
            decoded = (self._decode_one(raw, aug[i])
                       for i, raw in enumerate(raws))
        for i, (img, label) in enumerate(decoded):
            data[i] = img
            labels[i] = label
        if n == 0:
            self._exhausted = True
            raise StopIteration
        pad = self.batch_size - n
        if pad:
            self._exhausted = True
            if self.last_batch_handle == "discard":
                raise StopIteration
            for i in range(n, self.batch_size):
                data[i] = data[i - n]
                labels[i] = labels[i - n]
        lab = labels[:, 0] if self.label_width == 1 else labels
        data, lab = self._wrap(data, lab)
        return DataBatch(data=data, label=lab, pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def iter_next(self):
        try:
            self._batch = self.next()
            return True
        except StopIteration:
            return False
