"""Evaluation metrics (the counterpart of ``mxtpu/metric.py``):
``create``, ``EvalMetric``, ``CompositeEvalMetric``, ``Accuracy``,
``TopKAccuracy``, ``CrossEntropy``, ``Perplexity``, ``CustomMetric``
and the detection mAPs ``VOC07MApMetric`` (``voc07_map``) and
``MApMetric`` (``det_map``).

Metrics update on the host from (label, pred) NDArray lists: each
``update`` copies its arrays to numpy, a sync with the card per batch,
as in the reference.  The other metrics of the JAX package (F1, MAE,
MSE, RMSE, ...) wait.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as _np

from .base import MXNetError, Registry, _as_list
from .ndarray.ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "CrossEntropy", "Perplexity", "CustomMetric", "VOC07MApMetric", "MApMetric",
           "create", "register", "check_label_shapes"]

_REGISTRY: Registry = Registry("metric")


def register(klass=None, *, aliases=()):
    def _do(k):
        _REGISTRY.register(k.__name__, aliases=(k.__name__.lower(),)
                           + tuple(aliases))(k)
        return k
    return _do(klass) if klass is not None else _do


def create(metric, *args, **kwargs) -> "EvalMetric":
    """A metric from an instance, a name, a callable or a list
    (reference ``metric.create``†)."""
    if callable(metric) and not isinstance(metric, type):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, (list, tuple)):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    return _REGISTRY.get(str(metric))(*args, **kwargs)


def _as_numpy(x):
    return x.asnumpy() if isinstance(x, NDArray) else _np.asarray(x)


def check_label_shapes(labels, preds, shape=False):
    """Raise unless labels and preds agree in count (or, with
    ``shape``, in shape)."""
    a, b = (labels.shape, preds.shape) if shape else \
        (len(labels), len(preds))
    if a != b:
        raise MXNetError(f"shape of labels {a} does not match shape of "
                         f"predictions {b}")


class EvalMetric:
    """Base metric (reference ``metric.EvalMetric``†)."""

    def __init__(self, name, output_names=None, label_names=None,
                 **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return f"EvalMetric: {dict(zip(*self.get()))}"

    def get_config(self):
        config = dict(self._kwargs)
        config.update({"metric": type(self).__name__, "name": self.name,
                       "output_names": self.output_names,
                       "label_names": self.label_names})
        return config

    def update_dict(self, label: Dict[str, Any], pred: Dict[str, Any]):
        pred = [pred[n] for n in self.output_names] \
            if self.output_names is not None else list(pred.values())
        label = [label[n] for n in self.label_names] \
            if self.label_names is not None else list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        raise NotImplementedError

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        return list(zip(_as_list(name), _as_list(value)))


@register
class CompositeEvalMetric(EvalMetric):
    """Several metrics at once (reference ``CompositeEvalMetric``†)."""

    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update_dict(self, labels, preds):
        for metric in self.metrics:
            metric.update_dict(labels, preds)

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def get(self):
        names, values = [], []
        for metric in self.metrics:
            name, value = metric.get()
            names.extend(_as_list(name))
            values.extend(_as_list(value))
        return names, values


@register(aliases=("acc",))
class Accuracy(EvalMetric):
    """Classification accuracy (reference ``metric.Accuracy``†)."""

    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, axis=axis)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _as_numpy(label), _as_numpy(pred)
            if pred.ndim > label.ndim:
                pred = _np.argmax(pred, axis=self.axis)
            pred = pred.astype("int32").ravel()
            label = label.astype("int32").ravel()
            check_label_shapes(label, pred, shape=True)
            self.sum_metric += float((pred == label).sum())
            self.num_inst += len(label)


@register(aliases=("top_k_accuracy", "top_k_acc"))
class TopKAccuracy(EvalMetric):
    """Top-k accuracy (reference ``metric.TopKAccuracy``†)."""

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, top_k=top_k)
        self.top_k = top_k
        if top_k <= 1:
            raise MXNetError("top_k should be >1; use Accuracy otherwise")
        self.name += f"_{top_k}"

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _as_numpy(pred)
            label = _as_numpy(label).astype("int32").ravel()
            if pred.ndim != 2:
                raise MXNetError("TopKAccuracy expects 2-D predictions")
            top = _np.argpartition(pred.astype("float32"), -self.top_k,
                                   axis=1)[:, -self.top_k:]
            self.sum_metric += float(
                (top.astype("int32") == label[:, None]).sum())
            self.num_inst += len(label)


@register(aliases=("ce",))
class CrossEntropy(EvalMetric):
    """Cross entropy over class probabilities (reference
    ``metric.CrossEntropy``†)."""

    def __init__(self, eps=1e-12, name="cross-entropy",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).ravel()
            pred = _as_numpy(pred)
            if label.shape[0] != pred.shape[0]:
                raise MXNetError(f"{label.shape[0]} labels for "
                                 f"{pred.shape[0]} predictions")
            prob = pred[_np.arange(label.shape[0]), label.astype("int64")]
            self.sum_metric += float((-_np.log(prob + self.eps)).sum())
            self.num_inst += label.shape[0]


@register
class Perplexity(EvalMetric):
    """exp(mean negative log-likelihood) of the labels' probabilities,
    those of ``ignore_label`` left out (reference
    ``metric.Perplexity``†)."""

    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names,
                         ignore_label=ignore_label)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        check_label_shapes(labels, preds)
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            pred = _as_numpy(pred)
            label = _as_numpy(label).reshape(-1).astype("int64")
            pred = pred.reshape(-1, pred.shape[-1])
            probs = pred[_np.arange(label.shape[0]), label]
            if self.ignore_label is not None:
                ignore = label == self.ignore_label
                probs = _np.where(ignore, 1.0, probs)
                num -= int(ignore.sum())
            loss -= float(_np.sum(_np.log(_np.maximum(1e-10, probs))))
            num += label.shape[0]
        self.sum_metric += loss
        self.num_inst += num

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


class CustomMetric(EvalMetric):
    """Wrap ``feval(label, pred) -> float`` or ``(sum, count)``
    (reference ``metric.CustomMetric``†)."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if "<" in name:
                name = f"custom({name})"
        super().__init__(name, output_names, label_names, feval=feval,
                         allow_extra_outputs=allow_extra_outputs)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            reval = self._feval(_as_numpy(label), _as_numpy(pred))
            if isinstance(reval, tuple):
                self.sum_metric += reval[0]
                self.num_inst += reval[1]
            else:
                self.sum_metric += reval
                self.num_inst += 1


@register(aliases=("voc07_map",))
class VOC07MApMetric(EvalMetric):
    """Mean average precision with VOC07's 11-point interpolation
    (reference ``example/ssd/evaluate/eval_metric.py``† MApMetric /
    VOC07MApMetric).

    update(labels, preds):
      * ``preds``: (B, N, 6) detector output rows
        ``[cls_id, score, x1, y1, x2, y2]``; rows with cls_id < 0 are
        padding (the MultiBoxDetection / SSD contract).
      * ``labels``: (B, M, 5+) ground truth rows
        ``[cls_id, x1, y1, x2, y2, (difficult)]``; rows with
        cls_id < 0 are padding.
    """

    def __init__(self, iou_thresh=0.5, class_names=None,
                 name="mAP", pred_idx=0):
        self.iou_thresh = iou_thresh
        self.class_names = class_names
        self._pred_idx = int(pred_idx)
        super().__init__(name)

    def reset(self):
        super().reset()
        # per class: a list of (score, tp) and the gt count
        self._records: Dict[int, List] = {}
        self._gt_counts: Dict[int, int] = {}

    @staticmethod
    def _iou(box, gts):
        ix1 = _np.maximum(box[0], gts[:, 0])
        iy1 = _np.maximum(box[1], gts[:, 1])
        ix2 = _np.minimum(box[2], gts[:, 2])
        iy2 = _np.minimum(box[3], gts[:, 3])
        iw = _np.maximum(ix2 - ix1, 0)
        ih = _np.maximum(iy2 - iy1, 0)
        inter = iw * ih
        a = (box[2] - box[0]) * (box[3] - box[1])
        b = (gts[:, 2] - gts[:, 0]) * (gts[:, 3] - gts[:, 1])
        return inter / _np.maximum(a + b - inter, 1e-12)

    def update(self, labels, preds):
        labels = _as_list(labels)
        preds = _as_list(preds)
        pred = _as_numpy(preds[self._pred_idx])
        label = _as_numpy(labels[0])
        if pred.ndim == 2:
            pred = pred[None]
        if label.ndim == 2:
            label = label[None]
        for b in range(pred.shape[0]):
            gts = label[b]
            gts = gts[gts[:, 0] >= 0]
            # VOC protocol: difficult ground truths (column 5, when
            # present) are excluded from npos, and detections matching
            # them are neutral — neither tp nor fp
            difficult = gts[:, 5] > 0 if gts.shape[1] > 5 else \
                _np.zeros(len(gts), bool)
            for c in set(gts[:, 0].astype(int).tolist()):
                self._gt_counts[c] = self._gt_counts.get(c, 0) + int(
                    ((gts[:, 0] == c) & ~difficult).sum())
            dets = pred[b]
            dets = dets[dets[:, 0] >= 0]
            order = _np.argsort(-dets[:, 1])
            matched = _np.zeros(len(gts), bool)
            for i in order:
                c = int(dets[i, 0])
                rec = self._records.setdefault(c, [])
                cls_mask = gts[:, 0] == c
                if not cls_mask.any():
                    rec.append((float(dets[i, 1]), 0))
                    continue
                ious = self._iou(dets[i, 2:6], gts[:, 1:5])
                ious = _np.where(cls_mask, ious, -1.0)
                j = int(_np.argmax(ious))
                if ious[j] >= self.iou_thresh:
                    if difficult[j]:
                        continue  # neutral: matched a difficult gt
                    if not matched[j]:
                        matched[j] = True
                        rec.append((float(dets[i, 1]), 1))
                    else:
                        rec.append((float(dets[i, 1]), 0))
                else:
                    rec.append((float(dets[i, 1]), 0))
        self.num_inst = 1  # aggregate metric; get() computes live

    def _class_ap(self, c):
        npos = self._gt_counts.get(c, 0)
        rec = self._records.get(c, [])
        if npos == 0:
            return None
        if not rec:
            return 0.0
        arr = _np.asarray(sorted(rec, key=lambda t: -t[0]), _np.float64)
        tp = _np.cumsum(arr[:, 1])
        fp = _np.cumsum(1 - arr[:, 1])
        recall = tp / npos
        precision = tp / _np.maximum(tp + fp, 1e-12)
        # VOC07 11-point interpolation
        ap = 0.0
        for t in _np.arange(0.0, 1.01, 0.1):
            p = precision[recall >= t].max() if (recall >= t).any() \
                else 0.0
            ap += p / 11.0
        return float(ap)

    def get(self):
        classes = sorted(set(self._gt_counts) | set(self._records))
        aps = [ap for ap in (self._class_ap(c) for c in classes)
               if ap is not None]
        if not aps:
            return (self.name, float("nan"))
        return (self.name, float(_np.mean(aps)))


@register(aliases=("det_map",))
class MApMetric(VOC07MApMetric):
    """Area-under-PR-curve mAP (reference ``MApMetric``†): the same
    matching, with exact AP integration instead of 11-point."""

    def __init__(self, iou_thresh=0.5, class_names=None, name="mAP",
                 pred_idx=0):
        super().__init__(iou_thresh, class_names, name, pred_idx)

    def _class_ap(self, c):
        npos = self._gt_counts.get(c, 0)
        rec = self._records.get(c, [])
        if npos == 0:
            return None
        if not rec:
            return 0.0
        arr = _np.asarray(sorted(rec, key=lambda t: -t[0]), _np.float64)
        tp = _np.cumsum(arr[:, 1])
        fp = _np.cumsum(1 - arr[:, 1])
        recall = _np.concatenate([[0.0], tp / npos])
        precision = _np.concatenate(
            [[1.0], tp / _np.maximum(tp + fp, 1e-12)])
        # monotone precision envelope, then integrate
        for i in range(len(precision) - 2, -1, -1):
            precision[i] = max(precision[i], precision[i + 1])
        return float(_np.sum(_np.diff(recall) * precision[1:]))
