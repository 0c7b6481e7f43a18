"""Convolution as a matrix product: the patches of a channels-last
input as rows (im2col) and their sum back (col2im), for the AMP and
int8 convolutions, which the card computes with a library GEMM that
keeps what mxtpu's convolutions keep (an f32 output of bf16 operands,
an int32 sum of int8 ones) and cuDNN does not give.

Layouts are mxtpu's: a channels-first layout (``NCHW``) takes weights
``OI<spatial>``, a channels-last one (``NHWC``) ``O<spatial>I``
(``mxtpu/ndarray/ops_impl.py`` ``_CONV_DN``).  Inside, every tensor is
channels-last, so a patch row is (kernel positions..., channels) and a
weight row the same order.
"""
from __future__ import annotations

import itertools
import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = ["channels_last", "from_channels_last", "weight_rows", "patches",
           "patch_rows", "col2im", "out_spatial"]


def channels_last(x: torch.Tensor, layout: str) -> torch.Tensor:
    """``x`` in ``layout`` as a (N, *spatial, C) view."""
    return x if layout.endswith("C") else x.movedim(1, -1)


def from_channels_last(y: torch.Tensor, layout: str) -> torch.Tensor:
    """A (N, *spatial, C) result in ``layout``, contiguous."""
    return y.contiguous() if layout.endswith("C") \
        else y.movedim(-1, 1).contiguous()


def weight_rows(w: torch.Tensor, layout: str) -> torch.Tensor:
    """The weight as (O, prod(kernel) * I), a row an output channel in
    patch order."""
    w = w if layout.endswith("C") else w.movedim(1, -1)
    return w.reshape(w.shape[0], -1)


def out_spatial(spatial: Sequence[int], kernel, stride, pad, dilate
                ) -> Tuple[int, ...]:
    return tuple((s + 2 * p - d * (k - 1) - 1) // st + 1
                 for s, k, st, p, d in zip(spatial, kernel, stride, pad,
                                           dilate))


def patches(x_cl: torch.Tensor, kernel, stride, pad, dilate
            ) -> torch.Tensor:
    """(N, *out, *kernel, C): every patch of the zero-padded
    channels-last input, a strided view (no copy beyond the pad)."""
    d = len(kernel)
    if any(pad):
        spec = []
        for p in reversed(pad):
            spec += [p, p]
        x_cl = F.pad(x_cl, [0, 0] + spec)
    x_cl = x_cl.contiguous()
    n, c = x_cl.shape[0], x_cl.shape[-1]
    out = out_spatial(x_cl.shape[1:-1], kernel, stride, (0,) * d, dilate)
    st = x_cl.stride()
    return x_cl.as_strided(
        (n,) + out + tuple(kernel) + (c,),
        (st[0],) + tuple(st[1 + i] * stride[i] for i in range(d))
        + tuple(st[1 + i] * dilate[i] for i in range(d)) + (st[-1],))


def patch_rows(view: torch.Tensor, groups: int, g: int) -> torch.Tensor:
    """Group ``g``'s channels of a :func:`patches` view as a contiguous
    (N * prod(out), prod(kernel) * C/groups) matrix."""
    c = view.shape[-1] // groups
    if groups > 1:
        view = view[..., g * c:(g + 1) * c]
    d = (view.ndim - 2) // 2
    return view.reshape(-1, math.prod(view.shape[1 + d:]))


def col2im(dcols: torch.Tensor, x_shape_cl, kernel, stride, pad, dilate
           ) -> torch.Tensor:
    """The gradient of :func:`patches`: ``dcols`` (N, *out, *kernel, C)
    summed, in its own type, back onto the (unpadded) input positions
    each patch element was read from."""
    d = len(kernel)
    n, c = x_shape_cl[0], x_shape_cl[-1]
    spatial = x_shape_cl[1:-1]
    out = dcols.shape[1:1 + d]
    dx = torch.zeros((n,) + tuple(s + 2 * p for s, p in zip(spatial, pad))
                     + (c,), dtype=dcols.dtype, device=dcols.device)
    lead = (slice(None),) * (1 + d)
    for k in itertools.product(*(range(kk) for kk in kernel)):
        at = (slice(None),) + tuple(
            slice(k[i] * dilate[i],
                  k[i] * dilate[i] + stride[i] * (out[i] - 1) + 1,
                  stride[i]) for i in range(d)) + (slice(None),)
        dx[at] += dcols[lead + k]
    crop = (slice(None),) + tuple(slice(p, p + s)
                                  for p, s in zip(pad, spatial)) \
        + (slice(None),)
    return dx[crop]
