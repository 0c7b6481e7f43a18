"""Optimizer registry and the SGD and Adam optimizers (the counterpart
of ``mxtpu/optimizer/optimizer.py``).

An optimizer holds the hyperparameters, the per-parameter lr/wd
multipliers and the update count; the math is the update ops of
:mod:`.functional` ("optimizers are ops").  The eager ``update`` works
on torch tensors and rebinds ``weight.data`` and the state tensors to
the functionally updated values.  :class:`Updater` (``get_updater``)
applies an optimizer to NDArray weights with per-index states, as
Module does, through the multi-precision pair
(``create_state_multi_precision`` / ``update_multi_precision``): a
bf16 or f16 weight gets an f32 master, updated in f32 and cast back
once a step, unless ``multi_precision=False``.  Not ported yet: lr
schedulers, the other optimizers (LAMB, RMSProp, ...) and row-sparse
lazy updates.
"""
from __future__ import annotations

import pickle
from typing import Any, Dict

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["Optimizer", "register", "create", "SGD", "Adam", "Updater",
           "get_updater"]

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
    (read by :func:`.functional.opt_rule`).  ``idx2name``, which Module
    sets, lets ``lr_mult``/``wd_mult`` be keyed by name for an index.
    The options that take no effect here (``sym``, ``param_dict``,
    ``param_idx2name``, ``begin_num_update``, ``lazy_update``) are not
    accepted."""

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
        self.idx2name: Dict[int, str] = {}

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

    def _mult(self, mults, index):
        if index in mults:
            return mults[index]
        return mults.get(self.idx2name.get(index), 1.0)

    def _get_lr(self, index):
        return self.lr * self._mult(self.lr_mult, index)

    def _get_wd(self, index):
        return self.wd * self._mult(self.wd_mult, index)

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
