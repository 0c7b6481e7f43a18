"""Gluon losses the BERT training step needs (the counterpart of
``mxtpu/gluon/loss.py``): the ``Loss`` base with its per-sample mean
over the non-batch axes, and ``SoftmaxCrossEntropyLoss``.

As in the JAX package, ``log_softmax`` runs in the prediction's type
(bf16 under a bf16 ``compute_dtype``), and a loss is a per-sample
vector: the train step takes its mean in f32.
"""
from __future__ import annotations

import torch
from torch import nn

from ..base import MXNetError

__all__ = ["Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    """``loss._apply_weighting``: times ``sample_weight`` (broadcast),
    then times the scalar ``weight``."""
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        if not isinstance(weight, (int, float)):
            raise MXNetError("weight must be a number")
        loss = loss * weight
    return loss


class Loss(nn.Module):
    """Base loss: ``weight`` scales it, and the result is averaged over
    every axis except ``batch_axis``."""

    def __init__(self, weight=None, batch_axis=0):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return (f"{type(self).__name__}(batch_axis={self._batch_axis}, "
                f"w={self._weight})")

    def _mean_nonbatch(self, loss: torch.Tensor) -> torch.Tensor:
        axes = tuple(i for i in range(loss.ndim) if i != self._batch_axis)
        return loss.mean(dim=axes) if axes else loss


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross entropy with sparse (index) labels:
    ``-log_softmax(pred)[label]`` along ``axis``, per sample.  Labels
    may arrive as floats (token ids); as ``pick`` (mode "clip") does,
    they are truncated to integers and clipped into range."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        if not sparse_label:
            raise NotImplementedError(
                "SoftmaxCrossEntropyLoss(sparse_label=False) is not "
                "ported yet")
        self._axis = axis
        self._from_logits = from_logits

    def forward(self, pred: torch.Tensor, label: torch.Tensor,
                sample_weight=None) -> torch.Tensor:
        if not self._from_logits:
            pred = torch.log_softmax(pred, dim=self._axis)
        ax = self._axis % pred.ndim
        idx = label.to(torch.int64).clamp(0, pred.shape[ax] - 1)
        idx = idx.unsqueeze(ax)
        loss = -pred.gather(ax, idx)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
