"""The detection operators (the counterpart of
``mxtpu/ndarray/detection_impl.py``; reference
``src/operator/contrib/multibox_*.cc``†, ``src/operator/roi_pooling.cc``†,
``src/operator/contrib/proposal.cc``†): ``ROIPooling``, the MultiBox
family (``MultiBoxPrior``, ``MultiBoxTarget``, ``MultiBoxDetection``)
and the RPN's ``Proposal``.  ``ctc_loss`` and the quantize family of the
same JAX module wait.

Shapes stay static as in mxtpu: suppressed rows are -1, not removed.
mxtpu maps each image with ``vmap``; here the batch is a leading
dimension of every tensor op.  Sorts are stable (``jnp.argsort`` is), so
ties keep their index order.  The greedy suppression runs
``kernels.nms.nms_keep``: its CUDA kernel on the card, the plain loop
(:func:`_greedy_nms_keep`, mxtpu's) on the CPU.  Every rule runs on CPU,
CUDA and ``meta`` tensors and never reads a value on the host, so shape
inference and a CUDA graph's capture can run it.

Where mxtpu divides by a Python number (a variance, a bin count) the
rules divide by a tensor: on the card torch multiplies by the
reciprocal of a host scalar, which would round otherwise than the CPU.
The quotients are true ones, as mxtpu's eager ops compute them (inside
a jit XLA multiplies by the f32 reciprocal, so mxtpu's compiled graphs
can place a ROIPooling bin edge a pixel over).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..base import MXNetError
from ..kernels.nms import corner_iou, greedy_nms_keep, nms_keep
from ..ops.registry import Param, register_op

__all__ = ["_greedy_nms_keep", "_anchor_grid", "_base_anchors"]

_NEG = -1e30
_greedy_nms_keep = greedy_nms_keep


def _gather_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t (B, n, ...) reordered along dim 1 by idx (B, m)."""
    shape = idx.shape + t.shape[2:]
    return torch.gather(t, 1, idx.reshape(idx.shape + (1,) * (t.ndim - 2))
                        .expand(shape))


def _const(v, like: torch.Tensor) -> torch.Tensor:
    """A 0-d f32 tensor of ``v`` on ``like``'s device."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)



# ----------------------------------------------------------------------
# ROIPooling
# ----------------------------------------------------------------------

def _roi_windows(rois, ph, pw, H, W, spatial_scale):
    """Each bin's window as row and column masks: (bidx (R,), my (R, ph,
    H), mx (R, pw, W)) with mxtpu's floor/ceil bounds."""
    r = rois.float()
    bidx = r[:, 0].long()
    x1, y1, x2, y2 = (torch.round(r[:, k] * spatial_scale)
                      for k in (1, 2, 3, 4))
    rh = torch.clamp(y2 - y1 + 1.0, min=1.0)
    rw = torch.clamp(x2 - x1 + 1.0, min=1.0)
    # a true quotient, as mxtpu's eager op (and the reference) divides:
    # inside a jit XLA multiplies by the f32 reciprocal instead, and a
    # bin edge's floor or ceil can hang on that last bit
    bin_h = rh / _const(float(ph), r)
    bin_w = rw / _const(float(pw), r)
    ii = torch.arange(ph, device=r.device, dtype=torch.float32)
    jj = torch.arange(pw, device=r.device, dtype=torch.float32)
    hs = torch.floor(y1[:, None] + ii * bin_h[:, None])
    he = torch.ceil(y1[:, None] + (ii + 1.0) * bin_h[:, None])
    ws = torch.floor(x1[:, None] + jj * bin_w[:, None])
    we = torch.ceil(x1[:, None] + (jj + 1.0) * bin_w[:, None])
    ys = torch.arange(H, device=r.device, dtype=torch.float32)
    xs = torch.arange(W, device=r.device, dtype=torch.float32)
    my = (ys >= hs[..., None]) & (ys < he[..., None])
    mx = (xs >= ws[..., None]) & (xs < we[..., None])
    return bidx, my, mx


class _ROIPool(torch.autograd.Function):
    """Max over each bin's window, 0 for an empty window.  mxtpu masks
    every bin against the whole map, (R, ph, pw, C, H, W) elements; the
    forward here takes the max over a bin's columns, then over its rows
    (the same exact max), (R, C, H, W) a bin column.  The backward
    splits a bin's gradient equally among the tied maxima of its window,
    as jnp.max's VJP does, bin by bin."""

    @staticmethod
    def forward(ctx, data, rois, ph, pw, spatial_scale):
        N, C, H, W = data.shape
        bidx, my, mx = _roi_windows(rois, ph, pw, H, W, spatial_scale)
        img = data[bidx]                                 # (R, C, H, W)
        neg = torch.tensor(_NEG, dtype=data.dtype, device=data.device)
        cols = torch.stack([torch.amax(torch.where(
            mx[:, j, None, None, :], img, neg), dim=3) for j in range(pw)],
            dim=-1)                                      # (R, C, H, pw)
        raw = torch.stack([torch.amax(torch.where(
            my[:, i, None, :, None], cols, neg), dim=2) for i in range(ph)],
            dim=2)                                       # (R, C, ph, pw)
        full = my.any(2)[:, :, None] & mx.any(2)[:, None, :]
        ctx.save_for_backward(data, rois, raw)
        ctx.geom = (ph, pw, spatial_scale)
        return torch.where(full[:, None], raw, torch.zeros((), dtype=raw.dtype,
                                                           device=raw.device))

    @staticmethod
    def backward(ctx, g):
        data, rois, raw = ctx.saved_tensors
        ph, pw, spatial_scale = ctx.geom
        N, C, H, W = data.shape
        bidx, my, mx = _roi_windows(rois, ph, pw, H, W, spatial_scale)
        img = data[bidx]
        neg = torch.tensor(_NEG, dtype=data.dtype, device=data.device)
        full = my.any(2)[:, :, None] & mx.any(2)[:, None, :]
        gi = torch.zeros(img.shape, dtype=torch.float32, device=img.device)
        for i in range(ph):
            for j in range(pw):
                m2 = (my[:, i, :, None] & mx[:, j, None, :])[:, None]
                eq = torch.where(m2, img, neg) == raw[:, :, i, j, None, None]
                cnt = eq.sum((2, 3), dtype=torch.float32)
                share = torch.where(full[:, None, i, j], g[:, :, i, j].float(),
                                    0.0) / cnt
                gi = gi + torch.where(eq & m2, share[:, :, None, None], 0.0)
        # per image, the sum of its rois' gradients: a one-hot product
        # (no atomics, so a rerun repeats bit for bit)
        onehot = (bidx[None, :] == torch.arange(N, device=bidx.device)[:, None])
        gd = onehot.float() @ gi.reshape(gi.shape[0], -1)
        return gd.reshape(data.shape).to(data.dtype), None, None, None, None


def _roi_pooling(data, rois, pooled_size=(7, 7), spatial_scale=1.0):
    """data (N, C, H, W); rois (R, 5) = [batch_idx, x1, y1, x2, y2] in
    image coords; output (R, C, ph, pw) (reference ``ROIPooling``†)."""
    ph, pw = (int(v) for v in pooled_size)
    return _ROIPool.apply(data, rois, ph, pw, float(spatial_scale))


register_op("ROIPooling", num_inputs=2,
            params=[Param("pooled_size", tuple, (7, 7)),
                    Param("spatial_scale", float, 1.0)])(_roi_pooling)


# ----------------------------------------------------------------------
# MultiBox (SSD) family
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _prior_np(H, W, sizes, ratios, steps, offsets, clip):
    """MultiBoxPrior's anchors as mxtpu computes them, in f32 numpy."""
    f32 = np.float32
    step_y = steps[0] if steps[0] > 0 else 1.0 / H
    step_x = steps[1] if steps[1] > 0 else 1.0 / W
    cy = (np.arange(H, dtype=f32) + f32(offsets[0])) * f32(step_y)
    cx = (np.arange(W, dtype=f32) + f32(offsets[1])) * f32(step_x)
    r0 = float(np.sqrt(ratios[0]))
    whs = [(s * r0, s / r0) for s in sizes]
    whs += [(sizes[0] * float(np.sqrt(r)), sizes[0] / float(np.sqrt(r)))
            for r in ratios[1:]]
    wh = np.asarray(whs, f32)
    gy, gx = np.meshgrid(cy, cx, indexing="ij")
    cyx = np.repeat(np.stack([gy, gx], -1).reshape(-1, 2), len(wh), axis=0)
    whr = np.tile(wh, (H * W, 1))
    two = f32(2)
    boxes = np.stack([cyx[:, 1] - whr[:, 0] / two, cyx[:, 0] - whr[:, 1] / two,
                      cyx[:, 1] + whr[:, 0] / two, cyx[:, 0] + whr[:, 1] / two],
                     axis=1)
    if clip:
        boxes = np.clip(boxes, f32(0), f32(1))
    boxes = boxes[None].astype(f32)
    boxes.flags.writeable = False
    return boxes


def _multibox_prior(data, sizes=(1.0,), ratios=(1.0,), steps=(-1.0, -1.0),
                    offsets=(0.5, 0.5), clip=False):
    """Anchor generation (reference ``MultiBoxPrior``†): (1, H*W*(S+R-1),
    4) corner boxes in normalized coords, f32 whatever the data's type
    (mxtpu builds them from f32 aranges)."""
    H, W = int(data.shape[2]), int(data.shape[3])
    a = _prior_np(H, W, tuple(float(s) for s in sizes),
                  tuple(float(r) for r in ratios),
                  tuple(float(s) for s in steps),
                  tuple(float(o) for o in offsets), bool(clip))
    return torch.from_numpy(a.copy()).to(data.device)


register_op("MultiBoxPrior", num_inputs=1,
            params=[Param("sizes", tuple, (1.0,)),
                    Param("ratios", tuple, (1.0,)),
                    Param("steps", tuple, (-1.0, -1.0)),
                    Param("offsets", tuple, (0.5, 0.5)),
                    Param("clip", bool, False)],
            differentiable=False)(_multibox_prior)


def _encode(anchors, gt, var):
    """Corner anchors (A, 4) + matched gt corners (..., A, 4) →
    regression targets (..., A, 4); ``var`` the four variances, an f32
    tensor."""
    two, tiny = _const(2.0, gt), 1e-12
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = (anchors[:, 0] + anchors[:, 2]) / two
    acy = (anchors[:, 1] + anchors[:, 3]) / two
    gw = (gt[..., 2] - gt[..., 0]).clamp_min(tiny)
    gh = (gt[..., 3] - gt[..., 1]).clamp_min(tiny)
    gcx = (gt[..., 0] + gt[..., 2]) / two
    gcy = (gt[..., 1] + gt[..., 3]) / two
    tx = (gcx - acx) / aw.clamp_min(tiny) / var[0]
    ty = (gcy - acy) / ah.clamp_min(tiny) / var[1]
    tw = torch.log(gw / aw.clamp_min(tiny)) / var[2]
    th = torch.log(gh / ah.clamp_min(tiny)) / var[3]
    return torch.stack([tx, ty, tw, th], dim=-1)


def _multibox_target(anchors, labels, cls_preds, overlap_threshold=0.5,
                     ignore_label=-1.0, negative_mining_ratio=-1.0,
                     variances=(0.1, 0.1, 0.2, 0.2)):
    """Anchor↔gt matching + target encoding (reference
    ``MultiBoxTarget``†).  labels (N, O, 5) rows [cls, x1, y1, x2, y2],
    cls -1 padding.  Returns (box_target (N, A*4), box_mask (N, A*4),
    cls_target (N, A)); cls_target 0 = background, gt class + 1
    otherwise.

    The force-match gives each valid gt its best anchor; where two
    valid gts share one, the higher gt index wins: mxtpu's scatter with
    a duplicate index, whose last write XLA on the CPU keeps, made
    explicit (CUDA's ``index_put_`` keeps no defined one)."""
    anc = anchors[0].detach()
    labels, cls_preds = labels.detach(), cls_preds.detach()
    N, O = labels.shape[0], labels.shape[1]
    A = anc.shape[0]
    dev = anc.device
    var = torch.tensor(variances, dtype=torch.float32, device=dev)
    valid = labels[..., 0] >= 0                          # (N, O)
    gt_boxes = labels[..., 1:5]
    iou = torch.where(valid[:, None, :], corner_iou(anc, gt_boxes), -1.0)
    best_iou = torch.amax(iou, dim=2)                    # per anchor
    best_gt = torch.argmax(iou, dim=2)
    pos = best_iou > overlap_threshold
    best_anchor = torch.argmax(iou, dim=1)               # (N, O)
    hit = valid[:, None, :] & (best_anchor[:, None, :] ==
                               torch.arange(A, device=dev)[None, :, None])
    forced = hit.any(2)
    forced_gt = torch.where(hit, torch.arange(O, device=dev), -1).amax(2) \
        if O else torch.zeros_like(best_gt)
    gt_idx = torch.where(forced, forced_gt, best_gt)
    pos = pos | forced
    matched = _gather_rows(gt_boxes, gt_idx)             # (N, A, 4)
    target = _encode(anc, matched, var)
    target = torch.where(pos[..., None], target, 0.0)
    mask = torch.where(pos[..., None], torch.ones_like(target), 0.0)
    cls = torch.where(pos, torch.gather(labels[..., 0], 1, gt_idx) + 1.0,
                      0.0)
    if negative_mining_ratio > 0:
        # hard-negative mining: rank negative anchors by their max
        # foreground confidence, keep the hardest ratio*num_pos as
        # background, mark the rest ignore_label
        fg_conf = torch.amax(cls_preds[:, 1:], dim=1)    # (N, A)
        neg = ~pos
        num_pos = pos.sum(1)
        max_neg = (negative_mining_ratio *
                   num_pos.to(torch.float32)).to(torch.int32)
        score = torch.where(neg, fg_conf, float("-inf"))
        order = torch.argsort(-score, dim=1, stable=True)
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(A, device=dev).expand(N, A).contiguous())
        keep_neg = neg & (rank < max_neg[:, None])
        cls = torch.where(pos, cls,
                          torch.where(keep_neg, 0.0, float(ignore_label)))
    return target.reshape(N, -1), mask.reshape(N, -1), cls


register_op("MultiBoxTarget", num_inputs=3, num_outputs=3,
            params=[Param("overlap_threshold", float, 0.5),
                    Param("ignore_label", float, -1.0),
                    Param("negative_mining_ratio", float, -1.0),
                    Param("variances", tuple, (0.1, 0.1, 0.2, 0.2))],
            differentiable=False)(_multibox_target)


def _decode(anchors, loc, var):
    """anchors (A, 4), loc (..., A, 4) offsets → (..., A, 4) corners."""
    two = _const(2.0, loc)
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = (anchors[:, 0] + anchors[:, 2]) / two
    acy = (anchors[:, 1] + anchors[:, 3]) / two
    cx = loc[..., 0] * var[0] * aw + acx
    cy = loc[..., 1] * var[1] * ah + acy
    w = torch.exp(loc[..., 2] * var[2]) * aw
    h = torch.exp(loc[..., 3] * var[3]) * ah
    return torch.stack([cx - w / two, cy - h / two, cx + w / two,
                        cy + h / two], dim=-1)


def _multibox_detection(cls_prob, loc_pred, anchors, clip=True,
                        threshold=0.01, nms_threshold=0.5,
                        force_suppress=False, nms_topk=-1,
                        variances=(0.1, 0.1, 0.2, 0.2)):
    """Decode + class-select + NMS (reference ``MultiBoxDetection``†).
    cls_prob (N, C, A) incl. background class 0; output (N, A, 6) rows
    [cls_id, score, x1, y1, x2, y2] in score order, suppressed rows -1."""
    cls_prob, loc_pred = cls_prob.detach(), loc_pred.detach()
    anc = anchors[0].detach()
    N, A = cls_prob.shape[0], anc.shape[0]
    var = torch.tensor(variances, dtype=torch.float32, device=anc.device)
    loc = loc_pred.reshape(N, A, 4)
    loc = loc.to(torch.promote_types(loc.dtype, torch.float32))
    boxes = _decode(anc, loc, var)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    fg = cls_prob[:, 1:]                                 # (N, C-1, A)
    cls_id = torch.argmax(fg, dim=1).to(torch.float32)
    score = torch.amax(fg, dim=1)
    keep_score = score > threshold
    order = torch.argsort(-score, dim=1, stable=True)
    bs = _gather_rows(boxes, order)
    ss = torch.where(torch.gather(keep_score, 1, order),
                     torch.gather(score, 1, order), 0.0)
    cs = torch.gather(cls_id, 1, order)
    keep0 = ss > 0.0
    if nms_topk > 0:
        # reference: only the top-k scored boxes enter NMS at all
        keep0 = keep0 & (torch.arange(A, device=anc.device) < nms_topk)
    keep = nms_keep(bs, keep0, nms_threshold,
                    A if nms_topk < 0 else min(nms_topk, A),
                    ids=None if force_suppress else cs)
    out = torch.cat([cs[..., None], ss[..., None], bs], dim=-1)
    return torch.where(keep[..., None], out, -torch.ones_like(out))


register_op("MultiBoxDetection", num_inputs=3,
            params=[Param("clip", bool, True),
                    Param("threshold", float, 0.01),
                    Param("nms_threshold", float, 0.5),
                    Param("force_suppress", bool, False),
                    Param("nms_topk", int, -1),
                    Param("variances", tuple, (0.1, 0.1, 0.2, 0.2))],
            differentiable=False)(_multibox_detection)


# ----------------------------------------------------------------------
# RPN Proposal (reference ``src/operator/contrib/proposal.cc``†)
# ----------------------------------------------------------------------

def _base_anchors(stride, scales, ratios):
    """Anchors centered on one stride cell (reference
    ``GenerateAnchors``†: ratio enumeration preserves area, then
    scales)."""
    base = float(stride)
    cx = cy = (base - 1.0) / 2.0
    out = []
    area = base * base
    for r in ratios:
        w = np.round(np.sqrt(area / r))
        h = np.round(w * r)
        for s in scales:
            ws, hs = w * s, h * s
            out.append([cx - (ws - 1) / 2, cy - (hs - 1) / 2,
                        cx + (ws - 1) / 2, cy + (hs - 1) / 2])
    return np.asarray(out, np.float32)


def _anchor_grid(height, width, feature_stride, scales, ratios):
    """All anchors for a height×width feature map in pixel coords,
    position-major anchor-minor — THE ordering contract shared by the
    Proposal op and models.rcnn.rpn_anchors."""
    base = _base_anchors(feature_stride, scales, ratios)
    sx = np.arange(width, dtype=np.float32) * feature_stride
    sy = np.arange(height, dtype=np.float32) * feature_stride
    shift = np.stack([np.tile(sx, height), np.repeat(sy, width),
                      np.tile(sx, height), np.repeat(sy, width)],
                     axis=1)
    return (shift[:, None, :] + base[None]).reshape(-1, 4)


@functools.lru_cache(maxsize=16)
def _anchor_grid_ro(height, width, feature_stride, scales, ratios):
    a = _anchor_grid(height, width, feature_stride, scales, ratios)
    a.flags.writeable = False
    return a


def _proposal(cls_prob, bbox_pred, im_info, scales=(4.0, 8.0, 16.0, 32.0),
              ratios=(0.5, 1.0, 2.0), feature_stride=16,
              rpn_pre_nms_top_n=6000, rpn_post_nms_top_n=300,
              threshold=0.7, rpn_min_size=16, output_score=False):
    """RPN proposals: decode anchor deltas, clip, min-size filter,
    top-k, NMS (reference ``_contrib_Proposal``†).  cls_prob
    (N, 2A, H, W) — background scores first; bbox_pred (N, 4A, H, W);
    im_info (N, 3) rows [height, width, scale].  Returns rois
    (N*post_nms, 5) rows [batch_idx, x1, y1, x2, y2] (+ scores
    (N*post_nms, 1) when output_score); short batches pad with
    zero-boxes."""
    cls_prob, bbox_pred = cls_prob.detach(), bbox_pred.detach()
    im_info = im_info.detach()
    N, twoA, H, W = cls_prob.shape
    A = twoA // 2
    if A != len(scales) * len(ratios):
        raise MXNetError(
            f"Proposal: cls_prob carries {A} anchors/position but "
            f"scales×ratios = {len(scales)}×{len(ratios)} = "
            f"{len(scales) * len(ratios)}")
    dev = cls_prob.device
    anchors = torch.from_numpy(_anchor_grid_ro(
        int(H), int(W), int(feature_stride), tuple(map(float, scales)),
        tuple(map(float, ratios))).copy()).to(dev)
    M = anchors.shape[0]
    pre_n = min(int(rpn_pre_nms_top_n), M) if rpn_pre_nms_top_n > 0 else M
    post_n = int(rpn_post_nms_top_n)
    two = _const(2.0, anchors)
    # (N, 2A, H, W) → fg (N, M), position-major anchor-minor
    fg = cls_prob[:, A:].permute(0, 2, 3, 1).reshape(N, M)
    d = bbox_pred.reshape(N, A, 4, H, W).permute(0, 3, 4, 1, 2) \
        .reshape(N, M, 4)
    d = d.to(torch.promote_types(d.dtype, torch.float32))
    aw = anchors[:, 2] - anchors[:, 0] + 1.0
    ah = anchors[:, 3] - anchors[:, 1] + 1.0
    acx = anchors[:, 0] + (aw - 1.0) / two
    acy = anchors[:, 1] + (ah - 1.0) / two
    cx = d[..., 0] * aw + acx
    cy = d[..., 1] * ah + acy
    w = torch.exp(d[..., 2].clamp(-10.0, 10.0)) * aw
    h = torch.exp(d[..., 3].clamp(-10.0, 10.0)) * ah
    zero = torch.zeros((), dtype=w.dtype, device=dev)
    info = im_info.to(torch.promote_types(im_info.dtype, torch.float32))
    ih, iw, scl = info[:, 0:1], info[:, 1:2], info[:, 2:3]
    # clip to the image, drop boxes below min size (at image scale)
    x1 = torch.minimum(torch.maximum(cx - (w - 1) / two, zero), iw - 1.0)
    y1 = torch.minimum(torch.maximum(cy - (h - 1) / two, zero), ih - 1.0)
    x2 = torch.minimum(torch.maximum(cx + (w - 1) / two, zero), iw - 1.0)
    y2 = torch.minimum(torch.maximum(cy + (h - 1) / two, zero), ih - 1.0)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    min_sz = rpn_min_size * scl
    keep_sz = ((x2 - x1 + 1.0) >= min_sz) & ((y2 - y1 + 1.0) >= min_sz)
    score = torch.where(keep_sz, fg, float("-inf"))
    order = torch.argsort(-score, dim=1, stable=True)[:, :pre_n]
    bs = _gather_rows(boxes, order)
    ss = torch.gather(score, 1, order)
    keep = nms_keep(bs, ss > float("-inf"), threshold, pre_n, pixel=True)
    # compact kept rows into the first post_n slots (slot post_n is the
    # drop row)
    rank = torch.cumsum(keep.to(torch.int32), dim=1) - 1
    tgt = torch.where(keep & (rank < post_n), rank, post_n).long()
    out_b = torch.zeros(N, post_n + 1, 4, dtype=torch.float32, device=dev) \
        .scatter_(1, tgt[..., None].expand(N, pre_n, 4),
                  bs.to(torch.float32))[:, :post_n]
    out_s = torch.zeros(N, post_n + 1, dtype=torch.float32, device=dev) \
        .scatter_(1, tgt, torch.where(keep, ss, 0.0).to(torch.float32)
                  )[:, :post_n]
    batch_idx = torch.arange(N, dtype=torch.float32, device=dev) \
        .repeat_interleave(post_n)
    rois = torch.cat([batch_idx[:, None], out_b.reshape(-1, 4)], dim=1)
    if output_score:
        return rois, out_s.reshape(-1, 1)
    return rois


register_op("Proposal", num_inputs=3,
            params=[Param("scales", tuple, (4.0, 8.0, 16.0, 32.0)),
                    Param("ratios", tuple, (0.5, 1.0, 2.0)),
                    Param("feature_stride", int, 16),
                    Param("rpn_pre_nms_top_n", int, 6000),
                    Param("rpn_post_nms_top_n", int, 300),
                    Param("threshold", float, 0.7),
                    Param("rpn_min_size", int, 16),
                    Param("output_score", bool, False)],
            aliases=("_contrib_Proposal", "_contrib_MultiProposal"),
            num_outputs_fn=lambda params:
                2 if params.get("output_score") else 1,
            differentiable=False)(_proposal)
