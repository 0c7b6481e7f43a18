"""Image utilities (the counterpart of ``mxtpu/image.py``; reference
``python/mxnet/image/image.py``† and ``detection.py``†): decode,
resize, crop and normalize helpers over HWC NDArrays, the
``Augmenter`` family, ``CreateAugmenter`` and ``ImageIter``; and the
detection half, ``DetAugmenter``, ``DetHorizontalFlipAug``,
``DetRandomCropAug``, ``CreateDetAugmenter``, ``ImageDetIter`` and
``pack_det_label``.

``imdecode``/``imread`` decode through ``cv2`` at the call, as mxtpu's
do, into host (CPU) NDArrays; the other helpers compute where their
input lives.  mxtpu resizes with ``jax.image.resize``: bilinear is
torch's ``interpolate(mode="bilinear", antialias=True)`` (half-pixel
centers; a triangle filter widened by the scale when downscaling, as
jax's), and nearest is jax's own rule, source index
floor((i + 0.5) * in * (1 / out)) in f32 (XLA takes the quotient by
a constant as a product with its reciprocal), gathered here.
``random_crop`` and ``HorizontalFlipAug`` draw from Python's
``random`` module, as mxtpu's do.  ``ImageDetIter`` decodes with
``cv2`` and augments on the host in numpy, each sample from a seed
drawn in order, so a pool of any size gives the same batches; its
batches are host (CPU) NDArrays, as every iterator of the port's.
"""
from __future__ import annotations

import os
import random as pyrandom
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .base import MXNetError
from .context import cpu
from .ndarray.ndarray import NDArray, array

__all__ = ["imdecode", "imread", "imresize", "resize_short",
           "fixed_crop", "random_crop", "center_crop", "color_normalize",
           "Augmenter", "HorizontalFlipAug", "CastAug",
           "ColorNormalizeAug", "ResizeAug", "ForceResizeAug",
           "RandomCropAug", "CenterCropAug", "CreateAugmenter", "ImageIter",
           "ImageDetIter", "DetAugmenter", "DetHorizontalFlipAug",
           "DetRandomCropAug", "CreateDetAugmenter", "pack_det_label"]


def imdecode(buf, flag=1, to_rgb=True):
    """A jpeg/png byte buffer as an HWC host NDArray (reference
    ``imdecode``†, through OpenCV)."""
    import cv2
    img = cv2.imdecode(np.frombuffer(buf, np.uint8),
                       cv2.IMREAD_COLOR if flag else cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise MXNetError("imdecode failed")
    if flag and to_rgb:
        img = img[:, :, ::-1]
    return array(np.ascontiguousarray(img), ctx=cpu())


def imread(filename, flag=1, to_rgb=True):
    """An image file as an HWC host NDArray (reference ``imread``†)."""
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb)


def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    """jax.image.resize's nearest source index for each output index as
    XLA computes it: floor((i + 0.5) * in * (1 / out)), each step in
    f32."""
    i = torch.arange(n_out, dtype=torch.float32) + 0.5
    inv = torch.tensor(1.0, dtype=torch.float32) / n_out
    return torch.floor(i * n_in * inv).long().clamp(0, n_in - 1) \
        .to(device)


def resize_hwc(t: torch.Tensor, h: int, w: int,
               interp: int = 1) -> torch.Tensor:
    """An HWC (or HW) tensor resized to (h, w) in f32, as
    ``jax.image.resize(..., "bilinear" if interp else "nearest")``."""
    x = t.float()
    if x.ndim == 2:
        x = x[:, :, None]
    if interp:
        out = F.interpolate(x.permute(2, 0, 1)[None], size=(h, w),
                            mode="bilinear", align_corners=False,
                            antialias=True)[0].permute(1, 2, 0)
    else:
        out = x.index_select(0, _nearest_index(x.shape[0], h, x.device)) \
            .index_select(1, _nearest_index(x.shape[1], w, x.device))
    return out if t.ndim == 3 else out[:, :, 0]


def imresize(src: NDArray, w: int, h: int, interp=1):
    """Resize an HWC image to (w, h) (reference ``imresize``†); a uint8
    image is rounded and clipped back to uint8."""
    out = resize_hwc(src.data, h, w, interp)
    if src.data.dtype == torch.uint8:
        out = out.round().clamp(0, 255).to(torch.uint8)
    return NDArray(out)


def resize_short(src: NDArray, size: int, interp=1):
    """Resize so that the shorter edge is ``size`` (reference†)."""
    h, w = src.shape[:2]
    if h > w:
        new_w, new_h = size, int(h * size / w)
    else:
        new_w, new_h = int(w * size / h), size
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src: NDArray, x0, y0, w, h, size=None, interp=1):
    """Crop [y0:y0+h, x0:x0+w], then resize to ``size`` (w, h) if given
    (reference†)."""
    out = src[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return out


def random_crop(src: NDArray, size: Tuple[int, int], interp=1):
    """A crop of (w, h) at a random corner from Python's ``random``;
    returns (image, (x0, y0, w, h)) (reference†)."""
    h, w = src.shape[:2]
    new_w, new_h = size
    if w < new_w or h < new_h:
        src = resize_short(src, max(new_w, new_h), interp)
        h, w = src.shape[:2]
    x0 = pyrandom.randint(0, w - new_w)
    y0 = pyrandom.randint(0, h - new_h)
    return fixed_crop(src, x0, y0, new_w, new_h), (x0, y0, new_w, new_h)


def center_crop(src: NDArray, size: Tuple[int, int], interp=1):
    """The central (w, h) crop (reference†)."""
    h, w = src.shape[:2]
    new_w, new_h = size
    if w < new_w or h < new_h:
        src = resize_short(src, max(new_w, new_h), interp)
        h, w = src.shape[:2]
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    return fixed_crop(src, x0, y0, new_w, new_h), (x0, y0, new_w, new_h)


def color_normalize(src: NDArray, mean, std=None):
    """(src - mean) / std in f32 (reference†)."""
    dev = src.context
    out = src.astype("float32") - array(np.asarray(mean, np.float32),
                                        ctx=dev)
    if std is not None:
        out = out / array(np.asarray(std, np.float32), ctx=dev)
    return out


# -- augmenters (reference ``Augmenter`` family†) -----------------------

class Augmenter:
    """One step of an augmentation list: an HWC image in, one out."""

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=1):
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=1):
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=1):
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=1):
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    """Mirror W with probability ``p``, drawn from Python's ``random``."""

    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, src):
        if pyrandom.random() < self.p:
            return NDArray(torch.flip(src.data, dims=(1,)))
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        self.mean = mean
        self.std = std

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


def CreateAugmenter(data_shape, resize=0, rand_crop=False,
                    rand_mirror=False, mean=None, std=None,
                    inter_method=1, **_ignored):
    """The standard augmentation list (reference†): resize the short
    edge, crop (random or central) to ``data_shape``'s (w, h), mirror,
    cast to f32, normalize (``mean=True``/``std=True`` take ImageNet's)."""
    auglist: List[Augmenter] = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if mean is not None or std is not None:
        if mean is True:
            mean = np.array([123.68, 116.28, 103.53])
        if std is True:
            std = np.array([58.395, 57.12, 57.375])
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter:
    """Image batches from a .rec file (reference ``ImageIter``†): a thin
    layer over :class:`~mxtpu_torch.io.ImageRecordIter` that runs
    ``aug_list`` over each CHW sample as HWC and restacks the batch."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imgidx=None, shuffle=False, aug_list=None,
                 **kwargs):
        if path_imgrec is None:
            raise MXNetError("ImageIter needs path_imgrec (list-file "
                             "mode: use gluon.data.ImageFolderDataset)")
        from .io import ImageRecordIter
        self._inner = ImageRecordIter(
            path_imgrec=path_imgrec, path_imgidx=path_imgidx,
            data_shape=data_shape, batch_size=batch_size,
            shuffle=shuffle, **kwargs)
        self.provide_data = self._inner.provide_data
        self.provide_label = self._inner.provide_label
        self.batch_size = batch_size
        self.auglist = aug_list if aug_list is not None else []

    def __iter__(self):
        return self

    def reset(self):
        self._inner.reset()

    def next(self):
        batch = self._inner.next()
        if self.auglist:
            from .ndarray.ndarray import stack
            data = batch.data[0]
            samples = []
            for i in range(data.shape[0]):
                img = data[i].transpose(1, 2, 0)
                for aug in self.auglist:
                    img = aug(img)
                samples.append(img.transpose(2, 0, 1))
            batch.data = [stack(*samples, axis=0)]
        return batch

    __next__ = next


# ======================================================================
# Detection iterator (reference ``python/mxnet/image/detection.py``† +
# ``src/io/iter_image_det_recordio.cc``†): box-aware augmentation over
# det-packed .rec files.
# ======================================================================

class DetAugmenter:
    """Base detection augmenter: ``(img_hwc_np, label_np) -> (img,
    label)`` with label rows ``[cls, x1, y1, x2, y2]`` normalized to
    [0, 1] (reference ``DetAugmenter``†)."""

    def __call__(self, img, label):
        raise NotImplementedError


class DetHorizontalFlipAug(DetAugmenter):
    """Mirror image and boxes with probability p (reference
    ``DetHorizontalFlipAug``†)."""

    def __init__(self, p=0.5, rng=None):
        self.p = p
        self._rng = rng or np.random

    def __call__(self, img, label):
        if self._rng.rand() < self.p:
            img = img[:, ::-1]
            valid = label[:, 0] >= 0
            x1 = label[:, 1].copy()
            label[valid, 1] = 1.0 - label[valid, 3]
            label[valid, 3] = 1.0 - x1[valid]
        return img, label


class DetRandomCropAug(DetAugmenter):
    """IoU-constrained random crop (reference ``DetRandomCropAug``†,
    SSD-style sampling): sample a sub-window that covers at least
    ``min_object_covered`` of some box; boxes re-expressed in crop
    coordinates, objects whose center falls outside are dropped
    (marked -1)."""

    def __init__(self, min_object_covered=0.3, aspect_ratio_range=(0.75,
                 1.33), area_range=(0.3, 1.0), max_attempts=25,
                 rng=None):
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self._rng = rng or np.random

    def _try_crop(self, label):
        r = self._rng
        for _ in range(self.max_attempts):
            area = r.uniform(*self.area_range)
            ar = r.uniform(*self.aspect_ratio_range)
            cw = min(np.sqrt(area * ar), 1.0)
            ch = min(np.sqrt(area / ar), 1.0)
            cx = r.uniform(0, 1 - cw)
            cy = r.uniform(0, 1 - ch)
            valid = label[label[:, 0] >= 0]
            if len(valid) == 0:
                return cx, cy, cw, ch
            ix1 = np.maximum(valid[:, 1], cx)
            iy1 = np.maximum(valid[:, 2], cy)
            ix2 = np.minimum(valid[:, 3], cx + cw)
            iy2 = np.minimum(valid[:, 4], cy + ch)
            inter = np.maximum(ix2 - ix1, 0) * np.maximum(iy2 - iy1, 0)
            barea = (valid[:, 3] - valid[:, 1]) * \
                (valid[:, 4] - valid[:, 2])
            cover = inter / np.maximum(barea, 1e-12)
            if cover.max() >= self.min_object_covered:
                return cx, cy, cw, ch
        return None

    def __call__(self, img, label):
        crop = self._try_crop(label)
        if crop is None:
            return img, label
        cx, cy, cw, ch = crop
        h, w = img.shape[:2]
        x0 = int(cx * w)
        y0 = int(cy * h)
        x1 = max(x0 + 1, int((cx + cw) * w))
        y1 = max(y0 + 1, int((cy + ch) * h))
        img = img[y0:y1, x0:x1]
        out = label.copy()
        for i in range(len(out)):
            if out[i, 0] < 0:
                continue
            bx = (out[i, 1] + out[i, 3]) / 2
            by = (out[i, 2] + out[i, 4]) / 2
            if not (cx <= bx <= cx + cw and cy <= by <= cy + ch):
                out[i] = -1.0
                continue
            out[i, 1] = np.clip((out[i, 1] - cx) / cw, 0, 1)
            out[i, 3] = np.clip((out[i, 3] - cx) / cw, 0, 1)
            out[i, 2] = np.clip((out[i, 2] - cy) / ch, 0, 1)
            out[i, 4] = np.clip((out[i, 4] - cy) / ch, 0, 1)
        return img, out


def CreateDetAugmenter(data_shape, rand_crop=0.0, rand_mirror=False,  # noqa: N802
                       min_object_covered=0.3, aspect_ratio_range=(0.75,
                       1.33), area_range=(0.3, 1.0), max_attempts=25,
                       rng=None):
    """Standard detection augmentation list (reference
    ``CreateDetAugmenter``† subset used by the SSD recipe)."""
    augs: List[DetAugmenter] = []
    if rand_crop > 0:
        augs.append(DetRandomCropAug(min_object_covered,
                                     aspect_ratio_range, area_range,
                                     max_attempts, rng=rng))
    if rand_mirror:
        augs.append(DetHorizontalFlipAug(0.5, rng=rng))
    return augs


class ImageDetIter:
    """Detection-record iterator (reference ``ImageDetIter``†).

    Label wire format (what ``tools/im2rec.py --pack-label`` and
    ``pack_det_label`` write): ``[head_w, obj_w, <extra header...>,
    obj1, obj2, ...]`` with ``obj = [cls, x1, y1, x2, y2]`` normalized.
    Batches pad the object dim with -1 rows to ``max_objs`` so shapes
    stay static."""

    def __init__(self, path_imgrec, data_shape, batch_size=1,
                 path_imgidx=None, shuffle=False, max_objs=None,
                 rand_crop=0.0, rand_mirror=False, mean_pixels=None,
                 std_pixels=None, scale=1.0, aug_list=None,
                 last_batch_handle="pad", seed=0,
                 preprocess_threads=4, **kwargs):
        from . import recordio as rio
        from .io import DataDesc
        self.data_shape = tuple(data_shape)
        self.batch_size = batch_size
        self.scale = scale
        self.mean = np.asarray(
            mean_pixels if mean_pixels is not None else (0, 0, 0),
            np.float32)
        self.std = np.asarray(
            std_pixels if std_pixels is not None else (1, 1, 1),
            np.float32)
        self._rng = np.random.RandomState(seed)
        # user-supplied augmenters run shared and on one thread (their
        # rng would race across threads); otherwise augmenters are
        # built per sample from _aug_args with per-sample seeds —
        # _aug_args is the one switch next() and _decode_one read
        self.auglist = aug_list
        self._aug_args = None if aug_list is not None else \
            dict(rand_crop=rand_crop, rand_mirror=rand_mirror)
        self._threads = max(1, int(preprocess_threads))
        self._pool = None
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        if path_imgidx and os.path.exists(path_imgidx):
            self._rec = rio.MXIndexedRecordIO(path_imgidx, path_imgrec,
                                              "r")
            self._keys = list(self._rec.keys)
        else:
            self._rec = rio.MXRecordIO(path_imgrec, "r")
            self._keys = None
            if shuffle:
                raise MXNetError("shuffle requires path_imgidx")
        if max_objs is None:
            max_objs = self._scan_max_objs(path_imgrec)
        self.max_objs = max_objs
        self._DataDesc = DataDesc
        self.reset()

    def _scan_max_objs(self, path):
        from . import recordio as rio
        rec = rio.MXRecordIO(path, "r")
        mx_objs = 1
        while True:
            raw = rec.read()
            if raw is None:
                break
            header, _ = rio.unpack(raw)
            lab = np.asarray(header.label).ravel()
            head_w = int(lab[0])
            obj_w = int(lab[1])
            mx_objs = max(mx_objs, (lab.size - head_w) // obj_w)
        rec.close()
        return mx_objs

    @property
    def provide_data(self):
        return [self._DataDesc(
            "data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        return [self._DataDesc(
            "label", (self.batch_size, self.max_objs, 5))]

    def reset(self):
        if self._keys is not None:
            self._order = list(self._keys)
            if self.shuffle:
                self._rng.shuffle(self._order)
            self._pos = 0
        else:
            self._rec.reset()
        self._exhausted = False

    def _read_raw(self):
        if self._keys is not None:
            if self._pos >= len(self._order):
                return None
            raw = self._rec.read_idx(self._order[self._pos])
            self._pos += 1
            return raw
        return self._rec.read()

    def _parse_label(self, lab):
        lab = np.asarray(lab, np.float32).ravel()
        head_w = int(lab[0])
        obj_w = int(lab[1])
        objs = lab[head_w:].reshape(-1, obj_w)[:, :5]
        out = -np.ones((self.max_objs, 5), np.float32)
        n = min(len(objs), self.max_objs)
        out[:n] = objs[:n]
        return out

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
        rec = getattr(self, "_rec", None)
        if rec is not None and hasattr(rec, "close"):
            rec.close()
            self._rec = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _decode_one(self, raw, aug_seed=None):
        """``aug_seed``: the sample's augmentation seed, drawn in order
        on the consumer (the same at any pool size); None = the shared
        (possibly user-supplied) augmenter list."""
        import cv2

        from . import recordio as rio
        header, img = rio.unpack_img(raw, iscolor=1)
        label = self._parse_label(header.label)
        img = img[:, :, ::-1]  # BGR→RGB
        if aug_seed is None:
            augs = self.auglist or ()
        else:
            augs = CreateDetAugmenter(
                self.data_shape,
                rng=np.random.RandomState(aug_seed),
                **self._aug_args)
        for aug in augs:
            img, label = aug(img, label)
        c, h, w = self.data_shape
        if img.shape[:2] != (h, w):
            img = cv2.resize(img, (w, h))
        img = (img.astype(np.float32) - self.mean) * self.scale / \
            self.std
        return img.transpose(2, 0, 1), label

    def next(self):
        from .io import DataBatch
        if self._exhausted:
            raise StopIteration
        c, h, w = self.data_shape
        data = np.zeros((self.batch_size, c, h, w), np.float32)
        labels = -np.ones((self.batch_size, self.max_objs, 5),
                          np.float32)
        raws = []
        while len(raws) < self.batch_size:
            raw = self._read_raw()
            if raw is None:
                break
            raws.append(raw)
        n = len(raws)
        if n and self._aug_args is not None:
            # per-sample seeds drawn in order: the augmentation stream
            # is the same whatever the decode pool's size
            seeds = self._rng.randint(0, 2 ** 31 - 1, size=n,
                                      dtype=np.int64)
            if self._threads > 1:
                if self._pool is None:
                    from concurrent.futures import ThreadPoolExecutor
                    self._pool = ThreadPoolExecutor(self._threads)
                decoded = list(self._pool.map(self._decode_one, raws,
                                              seeds))
            else:
                decoded = [self._decode_one(r, s)
                           for r, s in zip(raws, seeds)]
        else:
            decoded = [self._decode_one(r) for r in raws]
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
        return DataBatch(data=[array(data, ctx=cpu())],
                         label=[array(labels, ctx=cpu())],
                         pad=pad, provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def __iter__(self):
        return self

    __next__ = next


def pack_det_label(objects, extra_header=()):
    """The det-record label vector from ``[cls, x1, y1, x2, y2]`` rows
    (normalized), the layout ``ImageDetIter`` and the reference's
    ``im2rec --pack-label`` expect."""
    objs = np.asarray(objects, np.float32).reshape(-1, 5)
    head = [2 + len(extra_header), 5] + list(extra_header)
    return np.concatenate([np.asarray(head, np.float32),
                           objs.ravel()])
