"""Optimizer registry and the optimizers (the counterpart of
``mxtpu/optimizer/optimizer.py``): ``SGD``, ``NAG``, ``Adam``,
``AdaGrad``, ``AdaDelta``, ``Adamax``, ``Nadam``, ``RMSProp``,
``LAMB``, ``Ftrl``, ``Signum``, ``SGLD``, ``LBSGD`` and ``Test``, and
the ``ccSGD`` alias of ``SGD``.

An optimizer holds the hyperparameters, the per-parameter lr/wd
multipliers, the update count and an optional lr scheduler
(:mod:`.lr_scheduler`); the math is the update ops of
:mod:`.functional` ("optimizers are ops"), or, for the optimizers the
reference writes as NDArray arithmetic, the same arithmetic on tensors.
The eager ``update`` works on torch tensors and rebinds
``weight.data`` and the state tensors to the functionally updated
values.  :class:`Updater` (``get_updater``) applies an optimizer to
NDArray weights with per-index states, as Module does, through the
multi-precision pair (``create_state_multi_precision`` /
``update_multi_precision``): a bf16 or f16 weight gets an f32 master,
updated in f32 and cast back once a step, unless
``multi_precision=False``.  ``SGLD`` draws its noise from the seeded
generator of :mod:`..random`.  Not ported: row-sparse lazy updates
(``lazy_update`` is accepted and every update is dense).
"""
from __future__ import annotations

import math
import pickle
from typing import Any, Dict

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["Optimizer", "register", "create", "SGD", "NAG", "Adam",
           "AdaGrad", "AdaDelta", "Adamax", "Nadam", "RMSProp", "LAMB",
           "Ftrl", "Signum", "SGLD", "LBSGD", "Test", "ccSGD", "Updater",
           "get_updater"]

_REGISTRY: Dict[str, type] = {}


def register(klass, name=None):
    """Register an Optimizer subclass under ``name`` (default its class
    name) and that name lowercased."""
    name = name or klass.__name__
    for n in (name, name.lower()):
        if n in _REGISTRY and _REGISTRY[n] is not klass:
            raise MXNetError(f"optimizer {n!r} registered twice")
        _REGISTRY[n] = klass
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
    index or name, gradient rescale and clip, an lr scheduler, and
    ``multi_precision`` (read by :func:`.functional.opt_rule`).
    ``idx2name`` (``param_idx2name``, or set by Module) lets
    ``lr_mult``/``wd_mult`` be keyed by name for an index;
    ``param_dict`` maps an index to a gluon Parameter whose own
    ``lr_mult``/``wd_mult`` win (what ``gluon.Trainer`` passes).
    ``begin_num_update`` is the count a parameter's updates start from
    (a resumed run passes its last).  ``sym`` is accepted and ignored,
    as in mxtpu.  The arguments keep mxtpu's positional order."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=None,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count: Dict[int, int] = {}
        self.multi_precision = multi_precision
        self.lr_mult: Dict[Any, float] = {}
        self.wd_mult: Dict[Any, float] = {}
        self.idx2name: Dict[int, str] = dict(param_idx2name or {})
        self.param_dict: Dict[int, Any] = dict(param_dict or {})

    def __getstate__(self):
        # gluon Parameters hold their Blocks: a pickled optimizer (an
        # Updater's ``get_states(dump_optimizer=True)``) leaves them out,
        # and Trainer.load_states sets its own again, as mxtpu's does
        state = dict(self.__dict__)
        state["param_dict"] = {}
        return state

    create_optimizer = staticmethod(create)

    # -- eager update ----------------------------------------------------
    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def _wants_master(self, weight) -> bool:
        """The f32-master recipe applies: ``multi_precision`` is not
        False (None, the default, means on) and ``weight`` is a sub-f32
        float, as :func:`.functional.opt_rule` decides for the train
        step."""
        from .functional import _needs_master
        return self.multi_precision is not False and _needs_master(weight)

    def create_state_multi_precision(self, index, weight):
        """``(f32 master, the base state of the master)`` for a weight
        that wants a master, else the base state."""
        if not self._wants_master(weight):
            return self.create_state(index, weight)
        master = weight.detach().float()
        return (master, self.create_state(index, master))

    def update_multi_precision(self, index, weight, grad, state):
        """The update on the f32 master with an f32 gradient; the weight
        becomes the master cast to its type, the only narrowing of the
        step."""
        if not self._wants_master(weight):
            self.update(index, weight, grad, state)
            return
        master, base = state
        self.update(index, master, grad.float(), base)
        weight.data = master.to(weight.dtype)

    # -- hyperparameters -------------------------------------------------
    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError("lr_scheduler is set; cannot set lr directly")
        self.lr = lr

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    @learning_rate.setter
    def learning_rate(self, lr):
        self.set_learning_rate(lr)

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """``wd_mult`` from ``args_wd_mult``, after mxtpu's default: no
        weight decay for an ``idx2name`` name that ends in neither
        ``_weight`` nor ``_gamma`` (biases, betas, running stats)."""
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not n.endswith(("_weight", "_gamma"))}
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        count = self._index_update_count.get(index,
                                             self.begin_num_update) + 1
        self._index_update_count[index] = count
        self.num_update = max(count, self.num_update)

    def _mult(self, attr, index):
        """mxtpu's lookup order: the ``param_dict`` Parameter's own
        multiplier, else the optimizer's entry for the index, else its
        entry for the index's name."""
        if index in self.param_dict:
            return getattr(self.param_dict[index], attr)
        mults = getattr(self, attr)
        if index in mults:
            return mults[index]
        return mults.get(self.idx2name.get(index), 1.0)

    def _get_lr(self, index):
        return self.learning_rate * self._mult("lr_mult", index)

    def _get_wd(self, index):
        return self.wd * self._mult("wd_mult", index)

    def _clip(self):
        return self.clip_gradient if self.clip_gradient else -1.0


@register
class SGD(Optimizer):
    """(Momentum) SGD over the ``sgd_update`` / ``sgd_mom_update``
    ops."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        # kept for mxtpu's signature: the port has no row-sparse
        # gradients, so every update is dense
        self.lazy_update = lazy_update

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
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update   # as SGD's: every update is dense

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


def _clipped(opt, grad, weight, wd, always_decay=False):
    """``grad * rescale_grad``, clipped when ``clip_gradient`` is set,
    plus ``wd * weight`` (always, or only for a nonzero ``wd``): the
    preamble of the optimizers the reference writes as NDArray
    arithmetic."""
    g = grad * opt.rescale_grad
    if opt.clip_gradient:
        g = g.clamp(-opt.clip_gradient, opt.clip_gradient)
    if always_decay or wd:
        g = g + wd * weight
    return g


def _zeros_like(weight, n=1):
    z = tuple(torch.zeros_like(weight) for _ in range(n))
    return z[0] if n == 1 else z


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = _clipped(self, grad, weight, wd, always_decay=True)
        if state is None:
            weight.data = weight - lr * g
        else:
            m = self.momentum * state + g
            state.data = m
            weight.data = weight - lr * (g + self.momentum * m)


@register
class AdaGrad(Optimizer):
    """AdaGrad."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = _clipped(self, grad, weight, wd)
        hist = state + g * g
        state.data = hist
        weight.data = weight - lr * g / torch.sqrt(hist +
                                                   self.float_stable_eps)


@register
class AdaDelta(Optimizer):
    """AdaDelta (it takes no lr)."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return _zeros_like(weight, 2)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        g = _clipped(self, grad, weight, wd)
        acc_g, acc_delta = state
        g2 = self.rho * acc_g + (1 - self.rho) * (g * g)
        delta = torch.sqrt(acc_delta + self.epsilon) / \
            torch.sqrt(g2 + self.epsilon) * g
        d2 = self.rho * acc_delta + (1 - self.rho) * (delta * delta)
        acc_g.data, acc_delta.data = g2, d2
        weight.data = weight - delta


@register
class Adamax(Optimizer):
    """Adamax, Adam under the infinity norm."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return _zeros_like(weight, 2)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        lr /= (1.0 - self.beta1 ** t)
        g = _clipped(self, grad, weight, wd)
        m, u = state
        m_new = self.beta1 * m + (1 - self.beta1) * g
        u_new = torch.maximum(self.beta2 * u, torch.abs(g))
        m.data, u.data = m_new, u_new
        weight.data = weight - lr * m_new / (u_new + 1e-8)


@register
class Nadam(Optimizer):
    """Nesterov Adam.  ``m_schedule`` is one product over every update
    call, whatever the parameter, as in the reference."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return _zeros_like(weight, 2)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        g = _clipped(self, grad, weight, wd)
        m_t = self.beta1 * (1.0 - 0.5 * 0.96 ** (t * self.schedule_decay))
        m_t1 = self.beta1 * (1.0 - 0.5 * 0.96 **
                             ((t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * m_t
        sched1 = self.m_schedule * m_t1
        m, v = state
        g_prime = g / (1.0 - self.m_schedule)
        m_new = self.beta1 * m + (1 - self.beta1) * g
        v_new = self.beta2 * v + (1 - self.beta2) * (g * g)
        m_prime = m_new / (1.0 - sched1)
        v_prime = v_new / (1.0 - self.beta2 ** t)
        m_bar = (1.0 - m_t) * g_prime + m_t1 * m_prime
        m.data, v.data = m_new, v_new
        weight.data = weight - lr * m_bar / (torch.sqrt(v_prime) +
                                             self.epsilon)


@register
class RMSProp(Optimizer):
    """RMSProp over ``rmsprop_update`` (Tieleman) or, with
    ``centered=True``, ``rmspropalex_update`` (Graves)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.epsilon = epsilon
        self.centered = centered
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        return _zeros_like(weight, 3) if self.centered else \
            (torch.zeros_like(weight),)

    def update(self, index, weight, grad, state):
        from .functional import rmsprop_update, rmspropalex_update
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        kw = dict(lr=lr, gamma1=self.gamma1, epsilon=self.epsilon, wd=wd,
                  rescale_grad=self.rescale_grad,
                  clip_gradient=self._clip())
        if not self.centered:
            (n,) = state
            weight.data, n.data = rmsprop_update(
                weight.detach(), grad, n, clip_weights=self.clip_weights
                or -1.0, **kw)
        else:
            n, g, delta = state
            weight.data, n.data, g.data, delta.data = rmspropalex_update(
                weight.detach(), grad, n, g, delta, gamma2=self.gamma2,
                **kw)


@register
class LAMB(Optimizer):
    """LAMB (You et al. 2020, "Large Batch Optimization for Deep
    Learning") over ``lamb_update``: Adam moments with a per-tensor
    trust ratio."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return _zeros_like(weight, 2)

    def update(self, index, weight, grad, state):
        from .functional import lamb_update
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        mean, var = state
        weight.data, mean.data, var.data = lamb_update(
            weight.detach(), grad, mean, var,
            torch.tensor(t, dtype=torch.int32, device=weight.device),
            lr=lr, beta1=self.beta1, beta2=self.beta2,
            epsilon=self.epsilon, wd=wd, rescale_grad=self.rescale_grad,
            clip_gradient=self._clip(),
            bias_correction=self.bias_correction)


@register
class Ftrl(Optimizer):
    """FTRL-proximal over ``ftrl_update``."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return _zeros_like(weight, 2)

    def update(self, index, weight, grad, state):
        from .functional import ftrl_update
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        z, n = state
        weight.data, z.data, n.data = ftrl_update(
            weight.detach(), grad, z, n, lr=lr, lamda1=self.lamda1,
            beta=self.beta, wd=wd, rescale_grad=self.rescale_grad,
            clip_gradient=self._clip())


@register
class Signum(Optimizer):
    """SignSGD (``momentum=0``) and Signum over ``signsgd_update`` /
    ``signum_update``."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        from .functional import signsgd_update, signum_update
        self._update_count(index)
        kw = dict(lr=self._get_lr(index), wd=self._get_wd(index),
                  rescale_grad=self.rescale_grad,
                  clip_gradient=self._clip())
        if state is None:
            weight.data = signsgd_update(weight.detach(), grad, **kw)
        else:
            weight.data, state.data = signum_update(
                weight.detach(), grad, state, momentum=self.momentum,
                wd_lh=self.wd_lh, **kw)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: an SGD half-step plus
    N(0, lr) noise, drawn from the weight's device generator of
    :mod:`..random`."""

    def update(self, index, weight, grad, state):
        from .. import random as _rnd
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = _clipped(self, grad, weight, wd, always_decay=True)
        noise = torch.empty_like(weight).normal_(
            0.0, math.sqrt(lr), generator=_rnd.generator(weight.device))
        weight.data = weight - lr / 2 * g + noise


@register
class LBSGD(SGD):
    """Large-batch SGD; as in the reference, its warm-up and LARS
    heuristics reduce to momentum SGD."""


@register
class Test(Optimizer):
    """The trivial test optimizer: ``w += rescale_grad * g``, its state
    the new weight."""

    def create_state(self, index, weight):
        return torch.zeros(weight.shape, device=weight.device)

    def update(self, index, weight, grad, state):
        weight.data = weight + grad * self.rescale_grad
        state.data = weight.detach()


# ``ccSGD`` was an alias of SGD by the reference's v1.x
ccSGD = register(SGD, "ccSGD")


class Updater:
    """Applies an optimizer to NDArray weights with per-index states
    (reference ``optimizer.Updater``†, the object Module and a KVStore
    call).  ``updater(index, grad, weight)`` updates ``weight`` in
    place, through the optimizer's multi-precision pair (an f32 master
    for a bf16/f16 weight, as mxtpu's ``Updater.__call__``)."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Any] = {}

    def __call__(self, index, grad, weight) -> None:
        w, g = weight._data, grad._data
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, w)
        self.optimizer.update_multi_precision(index, w, g,
                                              self.states[index])

    def get_states(self, dump_optimizer: bool = False) -> bytes:
        """The states as a pickle of numpy arrays (with the optimizer
        when ``dump_optimizer``)."""
        def to_np(s):
            if isinstance(s, torch.Tensor):
                return s.detach().cpu().numpy()
            if isinstance(s, (tuple, list)):
                return type(s)(to_np(x) for x in s)
            return s
        states = {k: to_np(v) for k, v in self.states.items()}
        return pickle.dumps((states, self.optimizer) if dump_optimizer
                            else states)

    def set_states(self, states_bytes: bytes, device=None) -> None:
        """Load :meth:`get_states` output; the arrays go to ``device``
        (default the card)."""
        from ..context import resolve_device
        dev = resolve_device(device)
        data = pickle.loads(states_bytes)  # the caller's own state blob
        if isinstance(data, tuple) and len(data) == 2 and \
                isinstance(data[1], Optimizer):
            states, self.optimizer = data
        else:
            states = data

        def to_t(s):
            if isinstance(s, np.ndarray):
                return torch.from_numpy(s).to(dev)
            if isinstance(s, (tuple, list)):
                return type(s)(to_t(x) for x in s)
            return s
        self.states = {k: to_t(v) for k, v in states.items()}


def get_updater(optimizer: Optimizer) -> Updater:
    """Reference ``mx.optimizer.get_updater``†."""
    return Updater(optimizer)
