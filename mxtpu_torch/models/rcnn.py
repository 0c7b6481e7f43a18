"""Faster R-CNN (the counterpart of ``mxtpu/models/rcnn.py``; reference
``example/rcnn/``†): HybridBlocks over ``Proposal`` and
``ROIPooling``.

Stage 1: a conv backbone of Conv-BN-ReLU-pool blocks feeds an RPN head
whose per-anchor objectness and deltas run through ``Proposal``
(decode → clip → top-k → NMS on the NMS kernel on the card, static
shapes).  Stage 2: ``ROIPooling`` crops each proposal to a fixed grid
and a dense head predicts class scores and per-class box deltas.
``detect`` decodes each class and suppresses on the host's copy, as
mxtpu's does, with one ``box_nms`` call an image on the data's device.
"""
from __future__ import annotations

import numpy as np

from ..gluon import nn
from ..gluon.block import HybridBlock

__all__ = ["RPN", "FasterRCNN", "faster_rcnn_small", "rpn_anchors"]


def rpn_anchors(height, width, feature_stride, scales, ratios,
                im_size, ctx=None):
    """All RPN anchors for an (height x width) feature map, normalized
    to [0, 1] by ``im_size`` — ready for ``MultiBoxTarget``.  Order
    matches the RPN head layout (position-major, anchor-minor).
    ``ctx`` as ``nd.array``'s (default the card)."""
    from ..ndarray.detection_impl import _anchor_grid
    from .. import nd
    anchors = _anchor_grid(height, width, feature_stride, scales,
                           ratios)
    return nd.array((anchors / float(im_size))[None].astype(np.float32),
                    ctx=ctx)


class RPN(HybridBlock):
    """Region proposal head: 3x3 conv → 1x1 objectness (2A channels,
    background-first) + 1x1 deltas (4A channels)."""

    def __init__(self, channels, num_anchors, **kwargs):
        super().__init__(**kwargs)
        self._A = num_anchors
        self.conv = nn.Conv2D(channels, 3, padding=1,
                              activation="relu")
        self.cls = nn.Conv2D(2 * num_anchors, 1)
        self.reg = nn.Conv2D(4 * num_anchors, 1)

    def hybrid_forward(self, F, x):
        t = self.conv(x)
        return self.cls(t), self.reg(t)


class FasterRCNN(HybridBlock):
    """Two-stage detector over ``Proposal`` + ``ROIPooling``.

    ``forward(x, im_info)`` → ``(rois, cls_scores, bbox_deltas,
    rpn_raw, rpn_reg)``: rois (N·R, 5); cls_scores (N·R, C+1);
    bbox_deltas (N·R, 4(C+1)).
    """

    def __init__(self, num_classes, body_channels=(16, 32, 64),
                 rpn_channels=64, scales=(2.0, 4.0), ratios=(0.5, 1.0,
                                                             2.0),
                 post_nms=64, pooled_size=(7, 7), head_units=128,
                 **kwargs):
        super().__init__(**kwargs)
        self._classes = num_classes
        self._stride = 2 ** len(body_channels)
        self._scales = tuple(float(s) for s in scales)
        self._ratios = tuple(float(r) for r in ratios)
        self._A = len(scales) * len(ratios)
        self._post_nms = int(post_nms)
        self._pooled = tuple(pooled_size)
        self.body = nn.HybridSequential()
        for c in body_channels:
            self.body.add(nn.Conv2D(c, 3, padding=1, use_bias=False),
                          nn.BatchNorm(), nn.Activation("relu"),
                          nn.MaxPool2D(2, strides=2))
        self.rpn = RPN(rpn_channels, self._A)
        self.head = nn.HybridSequential()
        for _ in range(2):
            self.head.add(nn.Dense(head_units, activation="relu"))
        self.cls_head = nn.Dense(num_classes + 1)
        self.reg_head = nn.Dense(4 * (num_classes + 1))

    def hybrid_forward(self, F, x, im_info):
        feat = self.body(x)
        rpn_raw, rpn_reg = self.rpn(feat)
        # pairwise bg/fg softmax without reshape tricks: channel a
        # (background) pairs with channel A+a (foreground)
        A = self._A
        bg = F.slice_axis(rpn_raw, axis=1, begin=0, end=A)
        fg = F.slice_axis(rpn_raw, axis=1, begin=A, end=2 * A)
        m = F.maximum(bg, fg)
        eb = F.exp(bg - m)
        ef = F.exp(fg - m)
        denom = eb + ef
        prob = F.concat(eb / denom, ef / denom, dim=1)
        rois = F.Proposal(
            prob, rpn_reg, im_info, scales=self._scales,
            ratios=self._ratios, feature_stride=self._stride,
            rpn_pre_nms_top_n=4 * self._post_nms,
            rpn_post_nms_top_n=self._post_nms, threshold=0.7,
            rpn_min_size=self._stride)
        pooled = F.ROIPooling(feat, rois, pooled_size=self._pooled,
                              spatial_scale=1.0 / self._stride)
        h = self.head(F.Flatten(pooled))
        return (rois, self.cls_head(h), self.reg_head(h), rpn_raw,
                rpn_reg)

    # -- inference ------------------------------------------------------
    def detect(self, x, im_info, score_threshold=0.05,
               nms_threshold=0.3):
        """Per-class decode + NMS over the head outputs.  Returns
        (N, R·C, 6) rows [cls_id, score, x1, y1, x2, y2] in pixels,
        suppressed rows -1, as numpy."""
        from .. import nd
        rois, scores, deltas, _, _ = self(x, im_info)
        N = x.shape[0]
        R = self._post_nms
        C = self._classes
        probs = nd.softmax(scores, axis=-1).asnumpy()
        deltas = deltas.asnumpy().reshape(-1, C + 1, 4)
        boxes = rois.asnumpy()[:, 1:]
        widths = boxes[:, 2] - boxes[:, 0] + 1.0
        heights = boxes[:, 3] - boxes[:, 1] + 1.0
        ctr_x = boxes[:, 0] + 0.5 * (widths - 1)
        ctr_y = boxes[:, 1] + 0.5 * (heights - 1)
        info = im_info.asnumpy() if hasattr(im_info, "asnumpy") \
            else np.asarray(im_info)
        per_image = []
        for n in range(N):
            rows = np.full((C, R, 6), -1.0, np.float32)
            sl = slice(n * R, (n + 1) * R)
            for c in range(1, C + 1):
                d = deltas[sl, c]
                cx = d[:, 0] * widths[sl] + ctr_x[sl]
                cy = d[:, 1] * heights[sl] + ctr_y[sl]
                w = np.exp(np.clip(d[:, 2], -10, 10)) * widths[sl]
                h = np.exp(np.clip(d[:, 3], -10, 10)) * heights[sl]
                b = np.stack([cx - (w - 1) / 2, cy - (h - 1) / 2,
                              cx + (w - 1) / 2, cy + (h - 1) / 2], 1)
                b[:, 0::2] = np.clip(b[:, 0::2], 0, info[n, 1] - 1)
                b[:, 1::2] = np.clip(b[:, 1::2], 0, info[n, 0] - 1)
                rows[c - 1, :, 0] = c - 1.0
                rows[c - 1, :, 1] = probs[sl, c]
                rows[c - 1, :, 2:] = b
            # per-class greedy NMS = ONE box_nms call over the stacked
            # classes with class-masked suppression (id_index)
            kept = nd.contrib.box_nms(
                nd.array(rows.reshape(-1, 6), ctx=x.context),
                overlap_thresh=nms_threshold,
                valid_thresh=score_threshold, coord_start=2,
                score_index=1, id_index=0,
                force_suppress=False).asnumpy()
            per_image.append(kept)
        return np.stack(per_image)


def faster_rcnn_small(num_classes=2):
    """Test/tutorial-scale Faster R-CNN (stride-8 backbone)."""
    return FasterRCNN(num_classes)
