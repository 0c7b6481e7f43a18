"""SSD single-shot detector (the counterpart of ``mxtpu/models/ssd.py``;
reference ``example/ssd/``†): HybridBlocks over the MultiBox ops.

A downsampling conv body of Conv-BN-ReLU blocks, extra feature scales,
a global scale, and per-scale 3x3 class and box predictors whose
outputs concatenate over all anchors.  Anchors come from
``MultiBoxPrior`` per scale, training targets from ``MultiBoxTarget``,
detections from ``MultiBoxDetection`` (its suppression on the NMS
kernel on the card).  A training-mode BatchNorm runs the BatchNorm
kernels (#8/#9, channels-major): ``ssd_300`` launches each 14 times a
step.
"""
from __future__ import annotations

from ..base import MXNetError
from ..gluon import nn
from ..gluon.block import HybridBlock
from ..gluon.loss import Loss

__all__ = ["SSD", "SSDLoss", "toy_ssd", "ssd_300"]


def _conv_block(channels):
    """Conv-BN-ReLU x2 then 2x downsample (reference
    ``legacy_conv_act_layer``† pattern)."""
    blk = nn.HybridSequential()
    for _ in range(2):
        blk.add(nn.Conv2D(channels, 3, padding=1, use_bias=False),
                nn.BatchNorm(), nn.Activation("relu"))
    blk.add(nn.MaxPool2D(2, strides=2))
    return blk


class SSD(HybridBlock):
    """Multi-scale single-shot detector.

    ``body_channels``: channels of the downsampling body blocks;
    ``scale_channels``: channels of the extra scales appended after the
    body.  ``sizes``/``ratios``: per-scale anchor configs (len =
    len(scale_channels) + 2: body output scale + extra scales + the
    global scale).  Forward returns ``(anchors (1, A, 4), cls_preds
    (N, C+1, A), box_preds (N, A*4))`` — the triple
    ``MultiBoxTarget``/``MultiBoxDetection`` consume.
    """

    def __init__(self, num_classes, body_channels=(16, 32, 64),
                 scale_channels=(64, 64), sizes=None, ratios=None,
                 **kwargs):
        super().__init__(**kwargs)
        self._classes = num_classes
        n_scales = len(scale_channels) + 2
        if sizes is None:
            # linearly spaced anchor sizes, small→large (reference ssd
            # default progression)
            lo, hi = 0.2, 0.9
            step = (hi - lo) / (n_scales - 1) if n_scales > 1 else 0.0
            sizes = [(lo + i * step,
                      (lo + i * step) * 1.3) for i in range(n_scales)]
        if ratios is None:
            ratios = [(1.0, 2.0, 0.5)] * n_scales
        if len(sizes) != n_scales or len(ratios) != n_scales:
            raise MXNetError(
                f"sizes/ratios must have {n_scales} entries "
                f"(body + {len(scale_channels)} extra + global)")
        self._sizes = [tuple(float(s) for s in sz) for sz in sizes]
        self._ratios = [tuple(float(r) for r in rt) for rt in ratios]

        self.body = nn.HybridSequential()
        for c in body_channels:
            self.body.add(_conv_block(c))
        self.scales = nn.HybridSequential()
        for c in scale_channels:
            self.scales.add(_conv_block(c))
        self.cls_preds = nn.HybridSequential()
        self.box_preds = nn.HybridSequential()
        for i in range(n_scales):
            k = len(self._sizes[i]) + len(self._ratios[i]) - 1
            self.cls_preds.add(
                nn.Conv2D(k * (num_classes + 1), 3, padding=1))
            self.box_preds.add(nn.Conv2D(k * 4, 3, padding=1))

    def hybrid_forward(self, F, x):
        feats = []
        x = self.body(x)
        feats.append(x)
        for i in range(len(self.scales)):
            x = self.scales[i](x)
            feats.append(x)
        # global scale: collapse to 1x1 (reference ``global pooling``
        # last scale)
        feats.append(F.Pooling(x, global_pool=True, pool_type="max",
                               kernel=(2, 2)))

        anchors, cls_out, box_out = [], [], []
        for i, feat in enumerate(feats):
            anchors.append(F.MultiBoxPrior(
                feat, sizes=self._sizes[i], ratios=self._ratios[i]))
            c = self.cls_preds[i](feat)
            # (N, K*(C+1), H, W) → (N, H*W*K, C+1)
            c = F.transpose(c, axes=(0, 2, 3, 1))
            cls_out.append(F.reshape(c,
                                     shape=(0, -1, self._classes + 1)))
            b = self.box_preds[i](feat)
            b = F.transpose(b, axes=(0, 2, 3, 1))
            box_out.append(F.reshape(b, shape=(0, -1)))
        anchors = F.concat(*anchors, dim=1)
        cls_preds = F.concat(*cls_out, dim=1)
        box_preds = F.concat(*box_out, dim=1)
        # (N, A, C+1) → (N, C+1, A): MultiBox target/detection layout
        cls_preds = F.transpose(cls_preds, axes=(0, 2, 1))
        return anchors, cls_preds, box_preds

    # -- inference ------------------------------------------------------
    def detect(self, x, nms_threshold=0.5, force_suppress=False,
               nms_topk=400):
        """End-to-end detection: forward → class softmax →
        ``MultiBoxDetection``.  Rows: [cls_id, score, x1, y1, x2, y2],
        suppressed entries -1."""
        from .. import nd
        anchors, cls_preds, box_preds = self(x)
        probs = nd.softmax(cls_preds, axis=1)
        return nd.MultiBoxDetection(
            probs, box_preds, anchors, nms_threshold=nms_threshold,
            force_suppress=force_suppress, nms_topk=nms_topk)


class SSDLoss(Loss):
    """Joint detection loss (reference ``example/ssd/train/metric``†
    recipe): softmax CE on mined class targets + smooth-L1 on masked
    box offsets, normalized by the positive count.

    Call as ``loss(cls_preds, box_preds, cls_target, box_target,
    box_mask)`` with the ``MultiBoxTarget`` outputs.
    """

    def __init__(self, box_loss_weight=1.0, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._box_w = float(box_loss_weight)

    def hybrid_forward(self, F, cls_preds, box_preds, cls_target,
                       box_target, box_mask):
        # class CE over (N, C+1, A) with sparse targets (N, A); anchors
        # MultiBoxTarget marks with the ignore label -1 (under negative
        # mining) contribute nothing, and the mean runs over the kept
        # ones (the plain anchor mean when none is ignored)
        logp = F.log_softmax(cls_preds, axis=1)
        keep = cls_target >= 0
        safe_t = F.maximum(cls_target, F.zeros_like(cls_target))
        ce = -F.pick(logp, safe_t, axis=1) * keep
        frac_keep = F.mean(keep, axis=0, exclude=True)
        n_keep = F.maximum(frac_keep, 1e-8 * F.ones_like(frac_keep))
        cls_loss = F.mean(ce, axis=0, exclude=True) / n_keep
        sl1 = F.smooth_l1((box_preds - box_target) * box_mask,
                          scalar=1.0)
        box_loss = F.mean(sl1, axis=0, exclude=True)
        # normalize by positives (mask counts 4 per positive anchor)
        npos = F.mean(box_mask, axis=0, exclude=True)
        return cls_loss + self._box_w * box_loss / \
            F.maximum(npos, F.ones_like(npos) * 1e-8)


def toy_ssd(num_classes=2):
    """Small SSD for tests/tutorial-scale data (the reference gluon
    tutorial's toy detector)."""
    return SSD(num_classes, body_channels=(8, 16),
               scale_channels=(16,))


def ssd_300(num_classes=20):
    """SSD-300-class config (VGG-reduced-style body depth; reference
    ``ssd_vgg16_reduced_300``† capacity class)."""
    return SSD(num_classes, body_channels=(32, 64, 128, 256),
               scale_channels=(256, 128, 128))
