"""Functional optimizer rules for the train step (the counterpart of
``mxtpu/optimizer/functional.py``) and the update ops they run (the
counterparts of the optimizer ops of ``mxtpu/ndarray/ops_impl.py:
1247-1460`` and ``:1727-1780``, registered under the same names by
:mod:`..ndarray.ops_impl`).

The ops are functional by default: they return new tensors and leave
their inputs alone, as ``nd.adam_update`` and the eager optimizers
need.  The ops the train step's rules run (``sgd_update``,
``sgd_mom_update``, ``adam_update``, ``rmsprop_update``,
``lamb_update``) also take ``inplace=True``: the new weight and state
are written into the weight and state tensors given, with the same
arithmetic, op for op, so the two forms agree bit for bit.  The train
step updates its parameters that way, to hold no second copy of a
bucket.  They are elementwise glue in plain PyTorch, as the JAX package
leaves them to XLA outside any Pallas kernel.  ``lr`` and ``wd`` arrive
as Python floats holding the f32 values the JAX step passes as f32
arrays (so each product happens in the tensor's type as there), or, for
a stacked bucket whose parameters differ, as f32 tensors of shape
``(n, 1, ..., 1)``.

Every rule accepts ``stacked=True``: parameters of one shape and type
ride stacked on a new axis 0 and one update call handles the bucket.
``init(w, stacked=True)`` treats ``w``'s axis 0 as the stack axis, so
LAMB's per-parameter step count ``t`` becomes an ``(n,)`` vector.  The
rules are elementwise in (w, g, state), so the stacked update equals
the per-parameter one bit for bit, except LAMB's trust-ratio norms,
which reduce per axis-0 slice in another order.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

from ..base import MXNetError
from . import optimizer as _opt

__all__ = ["adam_bias_correction", "opt_rule", "adam_update",
           "sgd_update", "sgd_mom_update", "rmsprop_update",
           "rmspropalex_update", "lamb_update", "ftrl_update",
           "signsgd_update", "signum_update", "multi_sgd_update",
           "multi_sgd_mom_update"]


# ----------------------------------------------------------------------
# update ops
# ----------------------------------------------------------------------

def _nonzero(v) -> bool:
    # a per-slice tensor is applied whatever it holds: 0 * w adds zeros
    return isinstance(v, torch.Tensor) or v != 0.0


def _rescale_clip(grad, rescale_grad, clip_gradient, wd=0.0, weight=None):
    """rescale, then clip, then ``+ wd * weight`` — the reference's
    order.  A rescale by 1 and a decay of 0 are skipped: both are exact
    identities on finite values."""
    g = grad if rescale_grad == 1.0 else grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    if weight is not None and _nonzero(wd):
        g = g + wd * weight
    return g


def _clip_arg(clip_gradient):
    return clip_gradient if clip_gradient > 0 else None


def _out(t, inplace):
    """The ``out=`` of the first op of a chain: ``t`` itself when the
    update is in place, else a new tensor."""
    return t if inplace else None


def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, inplace=False):
    g = _rescale_clip(grad, rescale_grad, _clip_arg(clip_gradient), wd,
                      weight)
    return torch.sub(weight, lr * g, out=_out(weight, inplace))


def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, inplace=False):
    g = _rescale_clip(grad, rescale_grad, _clip_arg(clip_gradient), wd,
                      weight)
    mom_new = torch.mul(mom, momentum, out=_out(mom, inplace)).sub_(lr * g)
    return torch.add(weight, mom_new, out=_out(weight, inplace)), mom_new


def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                inplace=False):
    """One Adam step without bias correction (the caller folds it into
    ``lr``); returns (weight, mean, var)."""
    g = _rescale_clip(grad, rescale_grad, _clip_arg(clip_gradient), wd,
                      weight)
    mean_new = torch.mul(mean, beta1, out=_out(mean, inplace)).add_(
        g * (1 - beta1))
    var_new = torch.mul(var, beta2, out=_out(var, inplace)).add_(
        (g * g).mul_(1 - beta2))
    step = (lr * mean_new).div_(torch.sqrt(var_new).add_(epsilon))
    return torch.sub(weight, step, out=_out(weight, inplace)), mean_new, \
        var_new


def rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.9, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0, inplace=False):
    """Non-centred RMSProp (Tieleman); returns (weight, n)."""
    g = _rescale_clip(grad, rescale_grad, _clip_arg(clip_gradient), wd,
                      weight)
    n_new = torch.mul(n, gamma1, out=_out(n, inplace)).add_(
        (g * g).mul_(1 - gamma1))
    step = (lr * g).div_(torch.sqrt(n_new + epsilon))
    w_new = torch.sub(weight, step, out=_out(weight, inplace))
    if clip_weights > 0:
        w_new.clamp_(-clip_weights, clip_weights)
    return w_new, n_new


def rmspropalex_update(weight, grad, n, g_state, delta, lr=0.001,
                       gamma1=0.95, gamma2=0.9, epsilon=1e-8, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    """Centred RMSProp (Graves); returns (weight, n, g, delta)."""
    g = _rescale_clip(grad, rescale_grad, _clip_arg(clip_gradient), wd,
                      weight)
    n_new = gamma1 * n + (1 - gamma1) * (g * g)
    g_new = gamma1 * g_state + (1 - gamma1) * g
    delta_new = gamma2 * delta - lr * g / torch.sqrt(
        n_new - g_new * g_new + epsilon)
    return weight + delta_new, n_new, g_new, delta_new


def lamb_update(weight, grad, mean, var, t, lr=0.001, beta1=0.9,
                beta2=0.999, epsilon=1e-6, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0, bias_correction=True, stacked=False,
                inplace=False):
    """LAMB (You et al. 2020): Adam moments and a per-tensor trust
    ratio.  ``t`` is the step count (an int or a tensor; ``(n,)`` when
    ``stacked``, one count a slice); ``stacked=True`` takes axis 0 as a
    bucket of parameters and reduces the trust ratio's norms per slice.
    Returns (weight, mean, var)."""
    g = _rescale_clip(grad, rescale_grad, _clip_arg(clip_gradient))
    m_new = torch.mul(mean, beta1, out=_out(mean, inplace)).add_(
        g * (1 - beta1))
    v_new = torch.mul(var, beta2, out=_out(var, inplace)).add_(
        (g * g).mul_(1 - beta2))
    mhat, vhat = m_new, v_new
    if bias_correction:
        tf = torch.as_tensor(t, device=weight.device).float()
        if stacked and tf.ndim == 1:
            tf = tf.reshape((-1,) + (1,) * (weight.ndim - 1))
        mhat = m_new / (1.0 - beta1 ** tf)
        vhat = v_new / (1.0 - beta2 ** tf)
    r = mhat / (torch.sqrt(vhat) + epsilon)
    # the reference adds the decay whatever its value
    r = r + wd * weight
    def norm(x):
        sq = x * x
        if not stacked:
            return torch.sqrt(sq.sum())
        return torch.sqrt(sq.reshape(len(sq), -1).sum(1)).reshape(
            (-1,) + (1,) * (x.ndim - 1))
    wnorm, rnorm = norm(weight), norm(r)
    trust = torch.where((wnorm > 0) & (rnorm > 0), wnorm / rnorm,
                        torch.ones_like(wnorm))
    return torch.sub(weight, lr * trust * r, out=_out(weight, inplace)), \
        m_new, v_new


def ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    """FTRL-proximal; returns (weight, z, n)."""
    g = _rescale_clip(grad, rescale_grad, _clip_arg(clip_gradient))
    n_new = n + g * g
    sigma = (torch.sqrt(n_new) - torch.sqrt(n)) / lr
    z_new = z + g - sigma * weight
    w_new = torch.where(
        torch.abs(z_new) <= lamda1, torch.zeros_like(z_new),
        -(z_new - torch.sign(z_new) * lamda1) /
        ((beta + torch.sqrt(n_new)) / lr + wd))
    return w_new, z_new, n_new


def signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    g = _rescale_clip(grad, rescale_grad, _clip_arg(clip_gradient))
    return weight - lr * (torch.sign(g) + wd * weight)


def signum_update(weight, grad, mom, lr=0.01, momentum=0.9, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    """Signum; returns (weight, mom).  As in the reference, the new
    momentum is ``momentum * mom - (1 - momentum) * g`` and the weight
    moves by ``+lr * sign`` of it."""
    g = _rescale_clip(grad, rescale_grad, _clip_arg(clip_gradient))
    mom_new = momentum * mom - (1 - momentum) * g
    if wd_lh == 0.0:
        w_new = weight + lr * torch.sign(mom_new) - lr * wd * weight
    else:
        w_new = (1 - lr * wd_lh) * weight + \
            lr * torch.sign(mom_new) * (-1.0) * (-1.0) - lr * wd * weight
    return w_new, mom_new


def _multi_grad(g, rescale_grad, clip_gradient):
    g = g * rescale_grad
    return g.clamp(-clip_gradient, clip_gradient) if clip_gradient > 0 \
        else g


def multi_sgd_update(*arrays, lrs=(), wds=(), rescale_grad=1.0,
                     clip_gradient=-1.0, num_weights=1):
    """SGD of ``num_weights`` (weight, grad) pairs in one call."""
    n = int(num_weights)
    if len(arrays) != 2 * n:
        raise MXNetError(f"multi_sgd_update expects {2 * n} inputs "
                         f"(weight, grad)×{n}, got {len(arrays)}")
    outs = []
    for i in range(n):
        w = arrays[2 * i]
        g = _multi_grad(arrays[2 * i + 1], rescale_grad, clip_gradient)
        outs.append(w - lrs[i] * (g + wds[i] * w))
    return tuple(outs) if n > 1 else outs[0]


def multi_sgd_mom_update(*arrays, lrs=(), wds=(), momentum=0.0,
                         rescale_grad=1.0, clip_gradient=-1.0,
                         num_weights=1):
    """Momentum SGD of ``num_weights`` (weight, grad, mom) triples in
    one call: the new weights, then the new momenta."""
    n = int(num_weights)
    if len(arrays) != 3 * n:
        raise MXNetError(f"multi_sgd_mom_update expects {3 * n} inputs "
                         f"(weight, grad, mom)×{n}, got {len(arrays)}")
    outs, moms = [], []
    for i in range(n):
        w, m = arrays[3 * i], arrays[3 * i + 2]
        g = _multi_grad(arrays[3 * i + 1], rescale_grad, clip_gradient)
        m2 = momentum * m - lrs[i] * (g + wds[i] * w)
        outs.append(w + m2)
        moms.append(m2)
    return tuple(outs + moms) if n > 1 else (outs[0], moms[0])


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
    """``(init(w, stacked=False) -> state tuple, update(w, g, state, lr,
    wd, stacked=False, inplace=False) -> (w, state))`` for
    ``optimizer``.  Unless the optimizer opts out
    (``multi_precision=False``), sub-f32 float weights get an f32
    master as state leaf 0: the rule updates the master with an f32
    gradient and the weight is the master cast down once per step.
    ``inplace=True`` writes the new weight and state into ``w`` and
    ``state``."""
    init, update = _base_rule(optimizer)
    if optimizer.multi_precision is False:
        return init, update
    return _multi_precision_rule(init, update)


def _needs_master(w: torch.Tensor) -> bool:
    return w.is_floating_point() and w.element_size() < 4


def _multi_precision_rule(base_init, base_update) -> Rule:
    def init(w, stacked=False):
        if not _needs_master(w):
            return base_init(w, stacked=stacked)
        master = w.float()
        return (master,) + tuple(base_init(master, stacked=stacked))

    def update(w, g, state, lr, wd, stacked=False, inplace=False):
        if not _needs_master(w):
            return base_update(w, g, state, lr, wd, stacked=stacked,
                               inplace=inplace)
        w2, st2 = base_update(state[0], g.float(), tuple(state[1:]), lr,
                              wd, stacked=stacked, inplace=inplace)
        # the only narrowing of the chain: master -> stored weight
        w_new = w.copy_(w2) if inplace else w2.to(w.dtype)
        return w_new, (w2,) + tuple(st2)
    return init, update


def _zeros(w, stacked=False):
    return (torch.zeros_like(w),)


def _base_rule(optimizer) -> Rule:
    o = optimizer
    common = dict(rescale_grad=o.rescale_grad, clip_gradient=o._clip())
    if isinstance(o, _opt.LAMB):
        def init(w, stacked=False):
            # the step count rides in the state, one a slice if stacked
            t0 = torch.zeros((w.shape[0],) if stacked else (),
                             dtype=torch.int32, device=w.device)
            return (torch.zeros_like(w), torch.zeros_like(w), t0)

        def update(w, g, state, lr, wd, stacked=False, inplace=False):
            t = state[2].add_(1) if inplace else state[2] + 1
            w2, m, v = lamb_update(
                w, g, state[0], state[1], t, lr=lr, beta1=o.beta1,
                beta2=o.beta2, epsilon=o.epsilon, wd=wd,
                bias_correction=o.bias_correction, stacked=stacked,
                inplace=inplace, **common)
            return w2, (m, v, t)
        return init, update
    if isinstance(o, _opt.Adam):
        def init(w, stacked=False):
            return (torch.zeros_like(w), torch.zeros_like(w))

        def update(w, g, state, lr, wd, stacked=False, inplace=False):
            w2, m, v = adam_update(
                w, g, state[0], state[1], lr=lr, beta1=o.beta1,
                beta2=o.beta2, epsilon=o.epsilon, wd=wd, inplace=inplace,
                **common)
            return w2, (m, v)
        return init, update
    if isinstance(o, _opt.RMSProp) and not o.centered:
        def update(w, g, state, lr, wd, stacked=False, inplace=False):
            w2, n = rmsprop_update(
                w, g, state[0], lr=lr, gamma1=o.gamma1, epsilon=o.epsilon,
                wd=wd, inplace=inplace, **common)
            return w2, (n,)
        return _zeros, update
    if isinstance(o, _opt.SGD):
        if o.momentum:
            def update(w, g, state, lr, wd, stacked=False, inplace=False):
                w2, m = sgd_mom_update(
                    w, g, state[0], lr=lr, momentum=o.momentum, wd=wd,
                    inplace=inplace, **common)
                return w2, (m,)
            return _zeros, update

        def init(w, stacked=False):
            return ()

        def update(w, g, state, lr, wd, stacked=False,  # noqa: F811
                   inplace=False):
            return sgd_update(w, g, lr=lr, wd=wd, inplace=inplace,
                              **common), ()
        return init, update
    raise MXNetError(
        f"compiled train step supports SGD/Adam/RMSProp/LAMB; got "
        f"{type(o).__name__} (use gluon.Trainer eager path)")
