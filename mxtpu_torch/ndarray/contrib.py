"""``mxtpu_torch.nd.contrib`` — the detection half of
``mxtpu/ndarray/contrib.py``: ``box_iou``, ``box_nms`` and
``bipartite_matching``, each registered (``_contrib_box_iou``,
``_contrib_box_nms`` with its alias ``box_nms``,
``_contrib_bipartite_matching``) and wrapped for NDArrays.  The control
flow (``foreach``, ``while_loop``, ``cond``) and the other contrib ops
(``boolean_mask``, ``getnnz``, ``count_sketch``, ``fft``, ``ifft``,
``quadratic``) wait.

Static shapes as in mxtpu: suppressed rows are -1.  The greedy
suppression is ``kernels.nms.nms_keep`` (its CUDA kernel on the card);
``bipartite_matching`` keeps mxtpu's loop as plain tensor ops (no
model's path runs it).
"""
from __future__ import annotations

import torch

from ..kernels.nms import corner_iou, nms_keep
from ..ops.registry import Param, register_op
from .ndarray import NDArray

__all__ = ["box_iou", "box_nms", "bipartite_matching"]


def _unwrap(x):
    return x._data if isinstance(x, NDArray) else x


def _corners(b):
    return torch.cat([b[..., :2] - b[..., 2:] / 2,
                      b[..., :2] + b[..., 2:] / 2], -1)


def _box_iou_raw(a, b, format="corner"):  # noqa: A002
    """Pairwise IoU (reference ``contrib.box_iou``†): a (..., A, 4), b
    (..., B, 4) → (..., A, B); ``center`` boxes are (cx, cy, w, h)."""
    if format == "center":
        a, b = _corners(a), _corners(b)
    return corner_iou(a, b)


register_op("_contrib_box_iou", num_inputs=2,
            params=[Param("format", str, "corner",
                          enum=("corner", "center"))])(_box_iou_raw)


def box_iou(lhs, rhs, format="corner"):  # noqa: A002
    """Pairwise IoU (reference ``contrib.box_iou``†)."""
    return NDArray(_box_iou_raw(_unwrap(lhs), _unwrap(rhs), format=format))


def _box_nms_raw(d, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
                 coord_start=2, score_index=1, id_index=-1,
                 force_suppress=False, in_format="corner",
                 out_format="corner"):
    """``contrib.box_nms``† with the padded contract: suppressed rows
    are -1 (static output shape).  Greedy over the score order, topk
    rows sweeping (all when topk < 0), rows scoring at most
    valid_thresh dropped; with id_index and not force_suppress only
    rows of one class suppress each other.  The formats are taken as
    corner, as mxtpu takes them."""
    d = d.detach()
    db = d if d.ndim == 3 else d[None]
    B, n, D = db.shape
    # lax.dynamic_slice_in_dim clamps the start so the 4 columns fit
    start = min(max(int(coord_start), 0), max(D - 4, 0))
    scores = db[..., score_index]
    order = torch.argsort(-scores, dim=1, stable=True)
    idx = order[..., None]
    boxes_s = torch.gather(db[..., start:start + 4], 1,
                           idx.expand(B, n, 4))
    scores_s = torch.gather(scores, 1, order)
    ids_s = torch.gather(db[..., id_index], 1, order) \
        if id_index >= 0 and not force_suppress else None
    keep_s = nms_keep(boxes_s, scores_s > valid_thresh, overlap_thresh,
                      n if topk < 0 else min(topk, n), ids=ids_s)
    keep = torch.empty_like(keep_s).scatter_(1, order, keep_s)
    out = torch.where(keep[..., None], db, -torch.ones_like(db))
    return out if d.ndim == 3 else out[0]


register_op("_contrib_box_nms",
            params=[Param("overlap_thresh", float, 0.5),
                    Param("valid_thresh", float, 0.0),
                    Param("topk", int, -1),
                    Param("coord_start", int, 2),
                    Param("score_index", int, 1),
                    Param("id_index", int, -1),
                    Param("force_suppress", bool, False),
                    Param("in_format", str, "corner"),
                    Param("out_format", str, "corner")],
            aliases=("box_nms",), differentiable=False)(_box_nms_raw)


def box_nms(data, **kwargs):
    return NDArray(_box_nms_raw(_unwrap(data), **kwargs))


def _bipartite_matching_raw(data, is_ascend=False, threshold=0.0, topk=-1):
    """``contrib.bipartite_matching``†: greedy matching over a (R, C)
    score matrix (or a batch of them), min(R, C) picks (topk caps
    them) of the best remaining pair while it passes the threshold.
    Returns (row_match (R,), col_match (C,)) in f32, -1 unmatched.
    Tensor ops only, no read on the host."""
    d = data.detach()
    s = (d if d.ndim == 3 else d[None]).to(torch.float32)
    B, R, C = s.shape
    dev = s.device
    worst = float("inf") if is_ascend else float("-inf")
    n = min(R, C) if topk < 0 else min(topk, R, C)
    rm = torch.full((B, R), -1.0, device=dev)
    cm = torch.full((B, C), -1.0, device=dev)
    rows = torch.arange(R, device=dev)
    cols = torch.arange(C, device=dev)
    bi = torch.arange(B, device=dev)
    for _ in range(n):
        flat = s.reshape(B, -1)
        flat = flat.argmin(1) if is_ascend else flat.argmax(1)
        r, c = flat // C, flat % C
        v = s[bi, r, c]
        ok = (v < threshold) if is_ascend else (v > threshold)
        rm = torch.where(ok[:, None] & (rows == r[:, None]),
                         c[:, None].to(rm.dtype), rm)
        cm = torch.where(ok[:, None] & (cols == c[:, None]),
                         r[:, None].to(cm.dtype), cm)
        kill = (rows[None, :, None] == r[:, None, None]) | \
            (cols[None, None, :] == c[:, None, None])
        s = torch.where(ok[:, None, None] & kill, worst, s)
    if d.ndim != 3:
        rm, cm = rm[0], cm[0]
    return rm, cm


register_op("_contrib_bipartite_matching", num_outputs=2,
            params=[Param("is_ascend", bool, False),
                    Param("threshold", float, 0.0),
                    Param("topk", int, -1)],
            differentiable=False)(_bipartite_matching_raw)


def bipartite_matching(data, **kwargs):
    rm, cm = _bipartite_matching_raw(_unwrap(data), **kwargs)
    return NDArray(rm), NDArray(cm)
