"""Evaluation metrics (the counterpart of ``mxtpu/metric.py``):
``create``, ``EvalMetric``, ``CompositeEvalMetric``, ``Accuracy``,
``TopKAccuracy``, ``CrossEntropy`` and ``CustomMetric``.

Metrics update on the host from (label, pred) NDArray lists: each
``update`` copies its arrays to numpy, a sync with the card per batch,
as in the reference.  The other metrics of the JAX package (F1, MAE,
MSE, RMSE, Perplexity, ...) wait.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as _np

from .base import MXNetError, Registry, _as_list
from .ndarray.ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "CrossEntropy", "CustomMetric", "create", "register",
           "check_label_shapes"]

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
