"""Greedy non-maximum suppression over score-sorted boxes: the one
suppression sweep of the detection ops (``MultiBoxDetection``,
``Proposal`` and ``_contrib_box_nms``).

* ``nms_keep`` — CUDA ``csrc/nms.cu``: a grid of the tiles on or above
  the diagonal writes the "IoU > threshold, later row" relation of every
  sweeping row that ``keep0`` keeps as bits into scratch this wrapper
  allocates (rows of :func:`mask_words` words, whole 16-byte chunks),
  then one CTA an image sweeps the keep bits in shared memory, 32 rows
  at a time, the mask rows of the coming blocks prefetched into shared
  memory by TMA bulk copies (up to ``PREFETCH_MAX_BOXES``; past it the
  wide sweep reads them from global memory).  One call is the two
  kernels and counts one launch in ``LAUNCHES``, whatever n.
* :func:`nms_keep_reference` — the plain version: :func:`pair_iou`,
  the class mask, then :func:`greedy_nms_keep`, the port of mxtpu's
  ``_greedy_nms_keep`` (``mxtpu/ndarray/detection_impl.py:500-510``),
  which ``_nms_single`` (``mxtpu/ndarray/contrib.py:125-156``) repeats
  inline.

Not the port of a TPU kernel: mxtpu runs the sweep as one
``lax.fori_loop`` on the device, which as a loop of tensor ops on the
card would be 3-4 launches a row (about 1600 for SSD's ``nms_topk``
400, 24 000 for ``Proposal``'s ``rpn_pre_nms_top_n`` 6000).

The IoU is f32 whatever the boxes' type, corner boxes with areas
clamped at 0 or (``pixel``) Proposal's +1-pixel widths unclamped, and
the kernel computes it with the plain version's operations in the same
order, each rounded on its own, and passes a NaN on where torch's
minima and maxima do (a NaN IoU suppresses nothing): the keep masks
agree bit for bit.  The
threshold is rounded to f32, as jax rounds a Python float beside an f32
array.  Rows ``n_iter`` and later suppress nothing (mxtpu's loop runs
``n_iter`` rows).

Dispatch: CPU tensors take the plain version, CUDA tensors the kernel
(or the call raises), ``meta`` tensors get an empty mask of the shape
(shape inference runs the detection rules on ``meta``).
"""
from __future__ import annotations

import ctypes
import sys
from typing import Optional

import numpy as np
import torch

from ..base import MXNetError
from . import _build, aligned16, bump, on_card

__all__ = ["nms_keep", "nms_keep_reference", "greedy_nms_keep",
           "corner_iou", "pair_iou", "mask_words", "MAX_BOXES",
           "PREFETCH_MAX_BOXES", "LAUNCHES"]

# calls of the kernel pair (kernels.launch_counts reads it)
LAUNCHES = 0
_SELF = sys.modules[__name__]

# the sweep keeps an image's keep bits in shared memory: 48 KB of words
MAX_BOXES = 48 * 1024 * 8
# past this many boxes two prefetch stages and the keep bits no longer
# fit a CTA's 227 KB: the wide sweep reads the mask from global memory
PREFETCH_MAX_BOXES = 28000
MASK_TILE = 128          # rows and columns of a mask tile
_P, _I = ctypes.c_void_p, ctypes.c_int
# boxes, ids, keep0, keep, mask; batch, n, n_iter; thr; pixel; stream
_ARGS = [_P] * 5 + [_I] * 3 + [ctypes.c_float, _I, _P]


def mask_words(n: int) -> int:
    """32-bit words of a mask row of ``n`` columns: whole 16-byte chunks
    (a TMA bulk copy moves multiples of 16 bytes from 16-byte
    boundaries)."""
    return -(-n // MASK_TILE) * (MASK_TILE // 32)


def _f32(v: float) -> float:
    return float(np.float32(v))


def corner_iou(a: torch.Tensor, b: torch.Tensor,
               pixel: bool = False) -> torch.Tensor:
    """(..., A, B) IoU of corner boxes ``a`` (..., A, 4) and ``b``
    (..., B, 4), broadcast over their leading axes, in their type: the
    one IoU of the detection ops (mxtpu's ``_iou_corner``, ``box_iou``
    and ``_nms_single``'s matrix, or with ``pixel`` ``_pixel_iou``'s
    +1-pixel widths and unclamped areas).  The kernel repeats its
    operations in this order; NaN passes through as here."""
    wh = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:]) - \
        torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    if pixel:
        wh = wh + 1.0
    wh = wh.clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]

    def area(t):
        if pixel:
            return (t[..., 2] - t[..., 0] + 1.0) * \
                (t[..., 3] - t[..., 1] + 1.0)
        return ((t[..., 2] - t[..., 0]) *
                (t[..., 3] - t[..., 1])).clamp_min(0.0)
    union = area(a)[..., :, None] + area(b)[..., None, :] - inter
    return inter / union.clamp_min(1e-12)


def pair_iou(boxes: torch.Tensor, pixel: bool = False) -> torch.Tensor:
    """(..., n, n) IoU of every pair of the (..., n, 4) corner boxes, in
    f32: :func:`corner_iou` of the boxes with themselves."""
    b = boxes.float()
    return corner_iou(b, b, pixel)


def greedy_nms_keep(iou: torch.Tensor, keep0: torch.Tensor,
                    threshold: float, n_iter: int) -> torch.Tensor:
    """The plain sweep (mxtpu's ``_greedy_nms_keep``) over a (..., n, n)
    IoU matrix of score-descending rows: for i < n_iter, row i, if
    alive, kills every later row whose IoU exceeds the threshold.
    Tensor ops only: on the card it never waits for the device."""
    n = iou.shape[-1]
    later = torch.arange(n, device=iou.device)
    thr = _f32(threshold)
    keep = keep0.clone()
    for i in range(max(0, min(int(n_iter), n))):
        sup = (iou[..., i, :] > thr) & (later > i) & keep[..., i:i + 1]
        keep = keep & ~sup
    return keep


def nms_keep_reference(boxes: torch.Tensor, keep0: torch.Tensor,
                       threshold: float, n_iter: int,
                       ids: Optional[torch.Tensor] = None,
                       pixel: bool = False) -> torch.Tensor:
    """Plain PyTorch: the IoU matrix, 0 between rows of different
    ``ids`` when given, then the sweep."""
    iou = pair_iou(boxes, pixel)
    if ids is not None:
        iou = torch.where(ids[..., :, None] == ids[..., None, :], iou, 0.0)
    return greedy_nms_keep(iou, keep0, threshold, n_iter)


def _check(boxes, keep0, ids):
    if boxes.ndim != 3 or boxes.shape[-1] != 4:
        raise MXNetError(f"nms_keep: boxes must be (batch, n, 4), got "
                         f"{tuple(boxes.shape)}")
    B, n = boxes.shape[:2]
    if tuple(keep0.shape) != (B, n) or keep0.dtype != torch.bool:
        raise MXNetError(f"nms_keep: keep0 must be bool ({B}, {n}), got "
                         f"{keep0.dtype} {tuple(keep0.shape)}")
    if ids is not None and tuple(ids.shape) != (B, n):
        raise MXNetError(f"nms_keep: ids must be ({B}, {n}), got "
                         f"{tuple(ids.shape)}")
    if not boxes.is_floating_point() or (
            ids is not None and ids.dtype not in (
                torch.float32, torch.bfloat16, torch.float16)):
        raise MXNetError(f"nms_keep: boxes must be floating and ids f32, "
                         f"bf16 or f16, got {boxes.dtype} and "
                         f"{None if ids is None else ids.dtype}")
    if n > MAX_BOXES or B > 65535:
        raise MXNetError(f"nms_keep: {B} images of {n} boxes; the kernel "
                         f"takes at most 65535 of {MAX_BOXES}")
    return B, n


def nms_keep(boxes: torch.Tensor, keep0: torch.Tensor, threshold: float,
             n_iter: int, ids: Optional[torch.Tensor] = None,
             pixel: bool = False) -> torch.Tensor:
    """(batch, n) bool keep mask of the greedy sweep over ``boxes``
    (batch, n, 4) in score order from ``keep0``: the kernel on CUDA
    tensors, the plain version on CPU tensors."""
    tensors = (boxes, keep0) + (() if ids is None else (ids,))
    if any(t.device.type == "meta" for t in tensors):
        return torch.empty(keep0.shape, dtype=torch.bool, device="meta")
    B, n = _check(boxes, keep0, ids)
    if not on_card(*tensors):
        return nms_keep_reference(boxes, keep0, threshold, n_iter, ids,
                                  pixel)
    n_iter = max(0, min(int(n_iter), n))
    if B * n == 0:
        return keep0.clone()
    boxes = boxes.float().contiguous()
    if not aligned16(boxes):             # read a box as one float4
        boxes = boxes.clone()
    keep0 = keep0.contiguous()
    if ids is not None:
        ids = ids.float().contiguous()   # exact from bf16 and f16
    mask = torch.empty(max(1, B * n_iter * mask_words(n)),
                       dtype=torch.int32, device=boxes.device)
    keep = torch.empty(B, n, dtype=torch.bool, device=boxes.device)
    fn = _build.bind("nms", "mxt_nms", _ARGS)
    with torch.cuda.device(boxes.device):
        err = fn(boxes.data_ptr(), None if ids is None else ids.data_ptr(),
                 keep0.data_ptr(), keep.data_ptr(), mask.data_ptr(), B, n,
                 n_iter, _f32(threshold), int(bool(pixel)),
                 _build.stream_of(boxes))
    _build.check(err, "nms")
    bump(_SELF)
    return keep
