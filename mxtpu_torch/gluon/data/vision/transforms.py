"""Vision transforms (the counterpart of
``mxtpu/gluon/data/vision/transforms.py``; reference
``python/mxnet/gluon/data/vision/transforms.py``†): Blocks over HWC
images (``ToTensor`` makes them CHW), computed where the image lives.

A HybridBlock transform sees tensors (the port's HybridBlocks unwrap
an NDArray input and wrap the output); a plain Block transform takes an
NDArray or a tensor and gives back the same kind.  ``Resize`` and the
crops that resize use ``image.resize_hwc`` (mxtpu's
``jax.image.resize`` bilinear); the random transforms draw from numpy's
global stream, as mxtpu's do.
"""
from __future__ import annotations

import numpy as np
import torch

from ....image import resize_hwc
from ....ndarray.ndarray import NDArray
from ... import nn
from ...block import Block, HybridBlock

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomResizedCrop", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "RandomBrightness", "RandomContrast"]


class Compose(nn.Sequential):
    """Transforms in sequence (reference ``Compose``†)."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return F.cast(x, dtype=self._dtype)


class ToTensor(HybridBlock):
    """HWC uint8 in [0, 255] to CHW float32 in [0, 1] (NHWC to NCHW for
    a batch; reference ``ToTensor``†)."""

    def hybrid_forward(self, F, x):
        x = F.cast(x, dtype="float32") / 255.0
        if len(x.shape) == 3:
            return F.transpose(x, axes=(2, 0, 1))
        return F.transpose(x, axes=(0, 3, 1, 2))


class Normalize(HybridBlock):
    """(x - mean) / std over the channels of a CHW tensor (reference†)."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = np.asarray(mean, np.float32).reshape(-1, 1, 1)
        self._std = np.asarray(std, np.float32).reshape(-1, 1, 1)

    def hybrid_forward(self, F, x):
        mean = torch.from_numpy(self._mean).to(x.device)
        std = torch.from_numpy(self._std).to(x.device)
        return (x - mean) / std


def _on_tensor(fn):
    """A plain Block's ``forward`` over a tensor, taking and giving an
    NDArray where it is handed one."""
    def forward(self, x):
        if isinstance(x, NDArray):
            return NDArray(fn(self, x.data))
        return fn(self, x)
    return forward


def _resize(x, size):
    w, h = (size, size) if isinstance(size, int) else size
    return resize_hwc(x, h, w)


class Resize(Block):
    """Resize an HWC image to ``size`` (w, h), or its short edge to an
    int ``size`` with ``keep_ratio`` (reference ``Resize``†); f32 out."""

    def __init__(self, size, keep_ratio=False):
        super().__init__()
        self._size = size
        self._keep = keep_ratio

    @_on_tensor
    def forward(self, x):
        if self._keep and isinstance(self._size, int):
            h, w = x.shape[:2]
            if h < w:
                size = (int(self._size * w / h), self._size)
            else:
                size = (self._size, int(self._size * h / w))
        else:
            size = self._size
        return _resize(x, size)


class CenterCrop(Block):
    """The central (w, h) crop, or a resize to it when the image is
    smaller (reference†)."""

    def __init__(self, size):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size

    @_on_tensor
    def forward(self, x):
        w, h = self._size
        ih, iw = x.shape[:2]
        if ih < h or iw < w:
            return _resize(x, self._size)
        y0 = (ih - h) // 2
        x0 = (iw - w) // 2
        return x[y0:y0 + h, x0:x0 + w]


class RandomResizedCrop(Block):
    """A crop of random area and aspect, resized to ``size`` (mxtpu's
    simplified reference†: ten tries, else the whole image)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._scale = scale
        self._ratio = ratio

    @_on_tensor
    def forward(self, x):
        ih, iw = x.shape[:2]
        area = ih * iw
        for _ in range(10):
            target = np.random.uniform(*self._scale) * area
            aspect = np.random.uniform(*self._ratio)
            w = int(round(np.sqrt(target * aspect)))
            h = int(round(np.sqrt(target / aspect)))
            if w <= iw and h <= ih:
                x0 = np.random.randint(0, iw - w + 1)
                y0 = np.random.randint(0, ih - h + 1)
                return _resize(x[y0:y0 + h, x0:x0 + w], self._size)
        return _resize(x, self._size)


class RandomFlipLeftRight(Block):
    @_on_tensor
    def forward(self, x):
        if np.random.rand() < 0.5:
            return torch.flip(x, dims=(1,))
        return x


class RandomFlipTopBottom(Block):
    @_on_tensor
    def forward(self, x):
        if np.random.rand() < 0.5:
            return torch.flip(x, dims=(0,))
        return x


class RandomBrightness(Block):
    def __init__(self, brightness):
        super().__init__()
        self._b = brightness

    @_on_tensor
    def forward(self, x):
        f = 1.0 + np.random.uniform(-self._b, self._b)
        return x * f


class RandomContrast(Block):
    def __init__(self, contrast):
        super().__init__()
        self._c = contrast

    @_on_tensor
    def forward(self, x):
        f = 1.0 + np.random.uniform(-self._c, self._c)
        mean = (x if x.is_floating_point() else x.float()).mean()
        return x * f + mean * (1.0 - f)
