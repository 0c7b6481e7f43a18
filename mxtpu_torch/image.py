"""Image utilities, the classification half (the counterpart of
``mxtpu/image.py``; reference ``python/mxnet/image/image.py``†):
decode, resize, crop and normalize helpers over HWC NDArrays, the
``Augmenter`` family, ``CreateAugmenter`` and ``ImageIter``.

``imdecode``/``imread`` decode through ``cv2`` at the call, as mxtpu's
do, into host (CPU) NDArrays; the other helpers compute where their
input lives.  mxtpu resizes with ``jax.image.resize``: bilinear is
torch's ``interpolate(mode="bilinear", antialias=True)`` (half-pixel
centers; a triangle filter widened by the scale when downscaling, as
jax's), and nearest is jax's own rule, source index
floor((i + 0.5) * in * (1 / out)) in f32 (XLA takes the quotient by
a constant as a product with its reciprocal), gathered here.
``random_crop`` and ``HorizontalFlipAug`` draw from Python's
``random`` module, as mxtpu's do.  The detection half
(``ImageDetIter`` and its augmenters) is not ported yet.
"""
from __future__ import annotations

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
           "RandomCropAug", "CenterCropAug", "CreateAugmenter", "ImageIter"]


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
