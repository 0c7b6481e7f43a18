"""Gluon utilities (the counterpart of ``mxtpu/gluon/utils.py``):
``split_data``, ``split_and_load`` and ``clip_global_norm``.  The port
trains on one device, so ``split_and_load`` over one context is a
placement; over several it splits along ``batch_axis`` and places each
slice."""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..base import MXNetError
from .. import ndarray as nd
from ..ndarray.ndarray import NDArray

__all__ = ["split_data", "split_and_load", "clip_global_norm"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``num_slice`` slices of ``data`` along ``batch_axis``; the last
    takes the remainder when ``even_split=False``."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise MXNetError(
            f"cannot evenly split axis {batch_axis} of size {size} into "
            f"{num_slice} slices (set even_split=False)")
    if num_slice == 1:
        return [data]
    step = size // num_slice
    return [nd.slice_axis(data, axis=batch_axis, begin=i * step,
                          end=(i + 1) * step if i < num_slice - 1 else size)
            for i in range(num_slice)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """``data`` split over ``ctx_list``, one slice on each context."""
    if not isinstance(data, NDArray):
        data = nd.array(np.asarray(data), ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` in place so that their joint L2 norm is at most
    ``max_norm``; returns the norm before clipping (a float)."""
    if not arrays:
        raise MXNetError("arrays must be nonempty")
    with torch.no_grad():
        total = sum(a._data.float().square().sum() for a in arrays)
        total_norm = float(torch.sqrt(total))
    if check_isfinite and not np.isfinite(total_norm):
        warnings.warn("nan or inf found during clip_global_norm")
        return total_norm
    scale = max_norm / (total_norm + 1e-8)
    if scale < 1.0:
        for a in arrays:
            a[:] = a * scale
    return total_norm
