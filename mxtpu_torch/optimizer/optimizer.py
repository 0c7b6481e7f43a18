"""Optimizer registry and the SGD and Adam optimizers (the counterpart
of ``mxtpu/optimizer/optimizer.py``).

An optimizer holds the hyperparameters, the per-parameter lr/wd
multipliers and the update count; the math is the update ops of
:mod:`.functional` ("optimizers are ops").  The eager ``update`` works
on torch tensors and rebinds ``weight.data`` and the state tensors to
the functionally updated values.  Not ported yet: lr schedulers, the
other optimizers (LAMB, RMSProp, ...), ``Updater``, the eager
multi-precision update and row-sparse lazy updates.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..base import MXNetError

__all__ = ["Optimizer", "register", "create", "SGD", "Adam"]

_REGISTRY: Dict[str, type] = {}


def register(klass):
    """Register an Optimizer subclass under its name and lowercased
    name."""
    for name in (klass.__name__, klass.__name__.lower()):
        if name in _REGISTRY and _REGISTRY[name] is not klass:
            raise MXNetError(f"optimizer {name!r} registered twice")
        _REGISTRY[name] = klass
    return klass


def create(name, **kwargs) -> "Optimizer":
    if isinstance(name, Optimizer):
        return name
    cls = _REGISTRY.get(name) or _REGISTRY.get(str(name).lower())
    if cls is None:
        raise MXNetError(f"unknown optimizer {name!r}; "
                         f"choices: {sorted(_REGISTRY)}")
    return cls(**kwargs)


class Optimizer:
    """Base optimizer: the update count, ``lr_mult``/``wd_mult`` by
    index or name, gradient rescale and clip, and ``multi_precision``
    (read by :func:`.functional.opt_rule`).  The options that take no
    effect here (``sym``, ``param_dict``, ``param_idx2name``,
    ``begin_num_update``, ``lazy_update``) are not accepted."""

    def __init__(self, *, rescale_grad=1.0, wd=0.0, clip_gradient=None,
                 learning_rate=0.01, lr_scheduler=None,
                 multi_precision=None):
        if lr_scheduler is not None:
            raise NotImplementedError("lr_scheduler is not ported yet")
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.num_update = 0
        self._index_update_count: Dict[int, int] = {}
        self.multi_precision = multi_precision
        self.lr_mult: Dict[Any, float] = {}
        self.wd_mult: Dict[Any, float] = {}

    create_optimizer = staticmethod(create)

    # -- eager update ----------------------------------------------------
    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    # -- hyperparameters -------------------------------------------------
    def set_learning_rate(self, lr):
        self.lr = lr

    @property
    def learning_rate(self):
        return self.lr

    @learning_rate.setter
    def learning_rate(self, lr):
        self.set_learning_rate(lr)

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def _update_count(self, index):
        count = self._index_update_count.get(index, 0) + 1
        self._index_update_count[index] = count
        self.num_update = max(count, self.num_update)

    def _get_lr(self, index):
        return self.lr * self.lr_mult.get(index, 1.0)

    def _get_wd(self, index):
        return self.wd * self.wd_mult.get(index, 1.0)

    def _clip(self):
        return self.clip_gradient if self.clip_gradient else -1.0


@register
class SGD(Optimizer):
    """(Momentum) SGD over the ``sgd_update`` / ``sgd_mom_update``
    ops."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        from .functional import sgd_mom_update, sgd_update
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if state is None:
            weight.data = sgd_update(
                weight.detach(), grad, lr=lr, wd=wd,
                rescale_grad=self.rescale_grad,
                clip_gradient=self._clip())
        else:
            weight.data, state.data = sgd_mom_update(
                weight.detach(), grad, state, lr=lr,
                momentum=self.momentum, wd=wd,
                rescale_grad=self.rescale_grad,
                clip_gradient=self._clip())


@register
class Adam(Optimizer):
    """Adam over the ``adam_update`` op, with the bias correction
    folded into the lr."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def update(self, index, weight, grad, state):
        from .functional import adam_bias_correction, adam_update
        self._update_count(index)
        t = self._index_update_count[index]
        lr = self._get_lr(index) * adam_bias_correction(self, t)
        wd = self._get_wd(index)
        mean, var = state
        weight.data, mean.data, var.data = adam_update(
            weight.detach(), grad, mean, var, lr=lr, beta1=self.beta1,
            beta2=self.beta2, epsilon=self.epsilon, wd=wd,
            rescale_grad=self.rescale_grad, clip_gradient=self._clip())
