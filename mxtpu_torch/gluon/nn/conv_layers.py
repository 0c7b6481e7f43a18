"""The gluon convolution and pooling layers ResNet needs, as
``nn.Module``s (counterparts of ``mxtpu/gluon/nn/conv_layers.py``).

The JAX package computes these with ``lax.conv_general_dilated``,
``lax.reduce_window`` and ``jnp.mean``, outside any Pallas kernel, so
here they are ``F.conv2d`` (cuDNN on the card), ``F.max_pool2d`` and
``mean``.  Both data layouts of the reference are kept:

* ``"NCHW"``: weights (O, I, kh, kw);
* ``"NHWC"``: weights (O, kh, kw, I), the reference's channels-last
  kernel layout.  The data and the weight are handed to PyTorch as
  ``permute``d channels-last views, so cuDNN reads and writes NHWC,
  and the result permutes back to a contiguous (N, H, W, C) tensor
  with no copy; a result that is not contiguous raises.

Shapes are explicit (``in_channels`` is required).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...base import MXNetError

__all__ = ["Conv2D", "MaxPool2D", "GlobalAvgPool2D"]

_LAYOUTS = ("NCHW", "NHWC")


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        if len(v) != 2:
            raise MXNetError(f"expected a 2-tuple, got {v}")
        return int(v[0]), int(v[1])
    return int(v), int(v)


def _layout(layout: str) -> str:
    if layout not in _LAYOUTS:
        raise MXNetError(f"layout must be one of {_LAYOUTS}, got "
                         f"{layout!r}")
    return layout


def _to_nchw(x: torch.Tensor) -> torch.Tensor:
    # (N, H, W, C) → the same memory as an (N, C, H, W) channels-last view
    return x.permute(0, 3, 1, 2)


def _from_nchw(y: torch.Tensor, what: str) -> torch.Tensor:
    out = y.permute(0, 2, 3, 1)
    if not out.is_contiguous():
        raise MXNetError(f"{what}: the NHWC result {tuple(out.shape)} is "
                         f"not contiguous (strides {out.stride()}): the "
                         f"backend did not keep the channels-last layout")
    return out


class Conv2D(nn.Module):
    """2-D convolution (gluon's ``nn.Conv2D``) with an optional bias;
    dilation and groups are not ported yet."""

    def __init__(self, channels: int, kernel_size, strides=(1, 1),
                 padding=(0, 0), layout: str = "NCHW", use_bias: bool = True,
                 in_channels: int = 0):
        super().__init__()
        if in_channels <= 0:
            raise MXNetError("Conv2D needs in_channels (shapes are "
                             "explicit in mxtpu_torch)")
        self._layout = _layout(layout)
        self._kernel = _pair(kernel_size)
        self._strides = _pair(strides)
        self._padding = _pair(padding)
        shape = (channels, in_channels, *self._kernel) if layout == "NCHW" \
            else (channels, *self._kernel, in_channels)
        self.weight = nn.Parameter(torch.empty(shape))
        nn.init.normal_(self.weight, std=0.02)
        self.bias = nn.Parameter(torch.zeros(channels)) if use_bias \
            else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nhwc = self._layout == "NHWC"
        y = F.conv2d(_to_nchw(x) if nhwc else x,
                     _to_nchw(self.weight) if nhwc else self.weight,
                     self.bias, self._strides, self._padding)
        return _from_nchw(y, "Conv2D") if nhwc else y


class MaxPool2D(nn.Module):
    """Max pooling (gluon's ``nn.MaxPool2D``); the padding counts as
    -inf, as ``lax.reduce_window``'s init does."""

    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout: str = "NCHW"):
        super().__init__()
        self._layout = _layout(layout)
        self._kernel = _pair(pool_size)
        self._strides = _pair(pool_size if strides is None else strides)
        self._padding = _pair(padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nhwc = self._layout == "NHWC"
        y = F.max_pool2d(_to_nchw(x) if nhwc else x, self._kernel,
                         self._strides, self._padding)
        return _from_nchw(y, "MaxPool2D") if nhwc else y


class GlobalAvgPool2D(nn.Module):
    """Mean over the spatial axes, kept as size-1 axes (gluon's
    ``nn.GlobalAvgPool2D``)."""

    def __init__(self, layout: str = "NCHW"):
        super().__init__()
        self._layout = _layout(layout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axes = (2, 3) if self._layout == "NCHW" else (1, 2)
        return x.mean(dim=axes, keepdim=True)
