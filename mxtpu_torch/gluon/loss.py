"""Gluon losses (the counterpart of ``mxtpu/gluon/loss.py``): the
``Loss`` base and mxtpu's 11 loss classes, as HybridBlocks over the
registry's ops.  ``sample_weight`` scales the loss elementwise (by
broadcast), ``weight`` by a number, and the loss is averaged over
every axis but ``batch_axis``: a per-sample vector.  As in mxtpu,
``log_softmax`` runs in the prediction's type (bf16 under a bf16
forward).
"""
from __future__ import annotations

from ..base import MXNetError
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "HuberLoss", "HingeLoss", "SquaredHingeLoss",
           "LogisticLoss", "TripletLoss", "CosineEmbeddingLoss"]


def _apply_weighting(F, loss, weight=None, sample_weight=None):
    """Reference ``loss._apply_weighting``†."""
    if sample_weight is not None:
        loss = F.broadcast_mul(loss, sample_weight)
    if weight is not None:
        if not isinstance(weight, (int, float)):
            raise MXNetError("weight must be a number")
        loss = loss * weight
    return loss


def _reshape_like(F, x, y):
    return F.reshape_like(x, y) if tuple(x.shape) != tuple(y.shape) \
        else x


class Loss(HybridBlock):
    """Base loss (reference ``gluon.loss.Loss``†): a HybridBlock whose
    ``hybrid_forward(F, pred, label, ...)`` gives a per-sample loss."""

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return (f"{type(self).__name__}(batch_axis={self._batch_axis}, "
                f"w={self._weight})")

    def _mean_nonbatch(self, F, loss):
        axes = tuple(i for i in range(loss.ndim) if i != self._batch_axis)
        return F.mean(loss, axis=axes) if axes else loss

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class L2Loss(Loss):
    """``0.5 * (pred - label)^2`` (reference ``L2Loss``†)."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.square(label - pred)
        loss = _apply_weighting(F, loss, self._weight / 2, sample_weight)
        return self._mean_nonbatch(F, loss)


class L1Loss(Loss):
    """``|pred - label|`` (reference ``L1Loss``†)."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.abs(label - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_nonbatch(F, loss)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """BCE with optional logits input (reference
    ``SigmoidBinaryCrossEntropyLoss``†); the from-logits form uses the
    stable ``max(x,0) - x*z + log(1+exp(-|x|))`` identity."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       pos_weight=None):
        label = _reshape_like(F, label, pred)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = F.relu(pred) - pred * label + \
                    F.Activation(-F.abs(pred), act_type="softrelu")
            else:
                log_weight = 1 + F.broadcast_mul(pos_weight - 1, label)
                loss = pred - pred * label + log_weight * (
                    F.Activation(-F.abs(pred), act_type="softrelu")
                    + F.relu(-pred))
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -(F.log(pred + eps) * label
                         + F.log(1.0 - pred + eps) * (1.0 - label))
            else:
                loss = -(F.broadcast_mul(F.log(pred + eps) * label,
                                         pos_weight)
                         + F.log(1.0 - pred + eps) * (1.0 - label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_nonbatch(F, loss)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax + CE fused (reference ``SoftmaxCrossEntropyLoss``†) —
    the canonical classification loss.  Sparse labels are picked
    (truncated to integers and clipped into range); dense labels
    (``sparse_label=False``) weight the log-probabilities."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -F.pick(pred, label, axis=self._axis, keepdims=True)
        else:
            label = _reshape_like(F, label, pred)
            loss = -F.sum(pred * label, axis=self._axis, keepdims=True)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_nonbatch(F, loss)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    """Kullback-Leibler divergence (reference ``KLDivLoss``†)."""

    def __init__(self, from_logits=True, axis=-1, weight=None,
                 batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        loss = label * (F.log(label + 1e-12) - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_nonbatch(F, loss)


class HuberLoss(Loss):
    """Smoothed L1 (reference ``HuberLoss``†)."""

    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.abs(label - pred)
        loss = F.where(loss > self._rho,
                       loss - 0.5 * self._rho,
                       (0.5 / self._rho) * F.square(loss))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_nonbatch(F, loss)


class HingeLoss(Loss):
    """``max(0, margin - pred*label)`` (reference ``HingeLoss``†)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.relu(self._margin - pred * label)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_nonbatch(F, loss)


class SquaredHingeLoss(Loss):
    """``max(0, margin - pred*label)^2`` (reference ``SquaredHingeLoss``†)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.square(F.relu(self._margin - pred * label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_nonbatch(F, loss)


class LogisticLoss(Loss):
    """Logistic regression loss (reference ``LogisticLoss``†)."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        if label_format not in ("signed", "binary"):
            raise MXNetError(f"bad label_format {label_format}")
        self._label_format = label_format

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = F.relu(pred) - pred * label + \
            F.Activation(-F.abs(pred), act_type="softrelu")
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_nonbatch(F, loss)


class TripletLoss(Loss):
    """``max(0, |a-p|^2 - |a-n|^2 + margin)`` (reference ``TripletLoss``†)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative,
                       sample_weight=None):
        positive = _reshape_like(F, positive, pred)
        negative = _reshape_like(F, negative, pred)
        axes = tuple(range(1, pred.ndim))
        loss = F.sum(F.square(positive - pred) - F.square(negative - pred),
                     axis=axes) + self._margin
        loss = F.relu(loss)
        return _apply_weighting(F, loss, self._weight, sample_weight)


class CosineEmbeddingLoss(Loss):
    """Cosine-distance pair loss (reference ``CosineEmbeddingLoss``†,
    label=1 similar / label=-1 dissimilar)."""

    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, input1, input2, label, sample_weight=None):
        eps = 1e-12
        prod = F.sum(input1 * input2, axis=-1)
        n1 = F.sqrt(F.sum(F.square(input1), axis=-1) + eps)
        n2 = F.sqrt(F.sum(F.square(input2), axis=-1) + eps)
        cos = prod / (n1 * n2)
        label = label.reshape(cos.shape)
        loss = F.where(label == 1, 1.0 - cos,
                       F.relu(cos - self._margin))
        return _apply_weighting(F, loss, self._weight, sample_weight)
