"""Functional optimizer rules for the train step (the counterpart of
``mxtpu/optimizer/functional.py``) and the update ops they run (the
counterparts of ``adam_update``, ``sgd_update`` and ``sgd_mom_update``
in ``mxtpu/ndarray/ops_impl.py``).

The ops are functional: they return new tensors and leave their inputs
alone; the train step rebinds the parameters to the results.  They are
elementwise glue in plain PyTorch, as the JAX package leaves them to
XLA outside any Pallas kernel.  ``lr`` and ``wd`` arrive as Python
floats holding the f32 values the JAX step passes as f32 arrays, so
each product happens in the tensor's type as there.

Only the per-parameter path is ported: a rule called with
``stacked=True`` (the batched, bucket-stacked update) raises.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

from ..base import MXNetError
from . import optimizer as _opt

__all__ = ["adam_bias_correction", "opt_rule", "adam_update",
           "sgd_update", "sgd_mom_update"]


# ----------------------------------------------------------------------
# update ops
# ----------------------------------------------------------------------

def _rescale_clip(grad, rescale_grad, clip_gradient, wd=0.0, weight=None):
    """rescale, then clip, then ``+ wd * weight`` — the reference's
    order.  A rescale by 1 and a decay of 0 are skipped: both are exact
    identities on finite values."""
    g = grad if rescale_grad == 1.0 else grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    if weight is not None and wd != 0.0:
        g = g + wd * weight
    return g


def _clip_arg(clip_gradient):
    return clip_gradient if clip_gradient > 0 else None


def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0):
    return weight - lr * _rescale_clip(grad, rescale_grad,
                                       _clip_arg(clip_gradient), wd, weight)


def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _rescale_clip(grad, rescale_grad, _clip_arg(clip_gradient), wd,
                      weight)
    mom_new = momentum * mom - lr * g
    return weight + mom_new, mom_new


def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """One Adam step without bias correction (the caller folds it into
    ``lr``); returns (weight, mean, var)."""
    g = _rescale_clip(grad, rescale_grad, _clip_arg(clip_gradient), wd,
                      weight)
    mean_new = beta1 * mean + (1 - beta1) * g
    var_new = beta2 * var + (1 - beta2) * (g * g)
    w_new = weight - lr * mean_new / (torch.sqrt(var_new) + epsilon)
    return w_new, mean_new, var_new


# ----------------------------------------------------------------------
# rules
# ----------------------------------------------------------------------

def adam_bias_correction(opt, t: int) -> float:
    """The ``adam_update`` op does not bias-correct; the step folds
    ``sqrt(1 - beta2^t) / (1 - beta1^t)`` into the lr."""
    if isinstance(opt, _opt.Adam) and t > 0:
        return float(math.sqrt(1.0 - opt.beta2 ** t) /
                     (1.0 - opt.beta1 ** t))
    return 1.0


Rule = Tuple[Callable, Callable]


def opt_rule(optimizer) -> Rule:
    """``(init(w) -> state tuple, update(w, g, state, lr, wd) ->
    (w, state))`` for ``optimizer``.  Unless the optimizer opts out
    (``multi_precision=False``), sub-f32 float weights get an f32
    master as state leaf 0: the rule updates the master with an f32
    gradient and the weight is the master cast down once per step."""
    init, update = _base_rule(optimizer)
    if optimizer.multi_precision is False:
        return init, update
    return _multi_precision_rule(init, update)


def _needs_master(w: torch.Tensor) -> bool:
    return w.is_floating_point() and w.element_size() < 4


def _per_parameter(stacked: bool) -> None:
    if stacked:
        raise NotImplementedError(
            "the batched (bucket-stacked) optimizer update is not ported "
            "yet; the port updates one parameter at a time")


def _multi_precision_rule(base_init, base_update) -> Rule:
    def init(w, stacked=False):
        if not _needs_master(w):
            return base_init(w, stacked=stacked)
        master = w.float()
        return (master,) + tuple(base_init(master, stacked=stacked))

    def update(w, g, state, lr, wd, stacked=False):
        if not _needs_master(w):
            return base_update(w, g, state, lr, wd, stacked=stacked)
        w2, st2 = base_update(state[0], g.float(), tuple(state[1:]), lr,
                              wd, stacked=stacked)
        return w2.to(w.dtype), (w2,) + tuple(st2)
    return init, update


def _base_rule(optimizer) -> Rule:
    if isinstance(optimizer, _opt.Adam):
        def init(w, stacked=False):
            _per_parameter(stacked)
            return (torch.zeros_like(w), torch.zeros_like(w))

        def update(w, g, state, lr, wd, stacked=False):
            _per_parameter(stacked)
            w2, m, v = adam_update(
                w, g, state[0], state[1], lr=lr, beta1=optimizer.beta1,
                beta2=optimizer.beta2, epsilon=optimizer.epsilon, wd=wd,
                rescale_grad=optimizer.rescale_grad,
                clip_gradient=optimizer._clip())
            return w2, (m, v)
        return init, update
    if isinstance(optimizer, _opt.SGD):
        if optimizer.momentum:
            def init(w, stacked=False):
                _per_parameter(stacked)
                return (torch.zeros_like(w),)

            def update(w, g, state, lr, wd, stacked=False):
                _per_parameter(stacked)
                w2, m = sgd_mom_update(
                    w, g, state[0], lr=lr, momentum=optimizer.momentum,
                    wd=wd, rescale_grad=optimizer.rescale_grad,
                    clip_gradient=optimizer._clip())
                return w2, (m,)
            return init, update

        def init(w, stacked=False):  # noqa: F811
            _per_parameter(stacked)
            return ()

        def update(w, g, state, lr, wd, stacked=False):  # noqa: F811
            _per_parameter(stacked)
            return sgd_update(w, g, lr=lr, wd=wd,
                              rescale_grad=optimizer.rescale_grad,
                              clip_gradient=optimizer._clip()), ()
        return init, update
    raise MXNetError(
        f"the train step supports SGD and Adam; got "
        f"{type(optimizer).__name__}")
