"""Gluon ``Trainer`` (the counterpart of ``mxtpu/gluon/trainer.py``):
an optimizer applied to a list of Parameters.

``step(batch_size)`` sets ``rescale_grad = rescale / batch_size``,
reduces the gradients through a key-value store where there is one and
updates
every parameter with a gradient, one at a time, through the port's
``Updater`` and its multi-precision pair (an f32 master for a bf16 or
f16 weight unless ``multi_precision=False``).  The optimizer gets
``param_dict = {index: Parameter}``, so each Parameter's own
``lr_mult``/``wd_mult`` apply.  The update runs inside a
``torch.profiler.record_function("update")`` range, as ``TrainStep``'s
does, so a profile of a step splits it without reaching into the
class.

The store follows ``mxtpu/gluon/trainer.py:63-95`` and ``:133-140``:
created at the first step, none for ``kvstore`` None or ``"nccl"`` and
none on one device (a process trains on one, whatever cards its host
holds); with ``compression_params`` a ``local`` store is
created even on one device (its error-feedback quantization changes the
update) and every gradient is pushed through it and pulled back in
place.  ``compression_params`` with no store to carry them raises, and
so do invalid ones.  ``update_on_kvstore`` is kept and not acted on, as
in mxtpu.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..base import MXNetError
from ..optimizer import optimizer as opt_mod
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise MXNetError(
                "params must be a ParameterDict or list of Parameters")
        self._params: List[Parameter] = []
        self._param2idx: Dict[str, int] = {}
        for i, p in enumerate(params):
            if not isinstance(p, Parameter):
                raise MXNetError(f"invalid parameter {p!r}")
            self._param2idx[p.name] = i
            self._params.append(p)
        self._compression_params = compression_params
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._init_optimizer(optimizer, optimizer_params)
        self._kvstore_type = kvstore
        self._kvstore = None
        self._kv_initialized = False
        self._update_on_kvstore = update_on_kvstore

    def _param_dict(self):
        return {i: p for i, p in enumerate(self._params)}

    def _init_optimizer(self, optimizer, optimizer_params):
        if isinstance(optimizer, opt_mod.Optimizer):
            if set(optimizer_params) - {"rescale_grad"}:
                raise MXNetError(
                    "optimizer_params must be None when optimizer is an "
                    "Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = self._param_dict()
        else:
            self._optimizer = opt_mod.create(
                optimizer, param_dict=self._param_dict(),
                **optimizer_params)
        self._updaters = [opt_mod.get_updater(self._optimizer)]

    def _init_kvstore(self):
        """Create the store at the first step, as mxtpu's Trainer does
        (see the module's docstring)."""
        if self._kvstore_type in (None, "nccl") or self._kv_initialized:
            if not self._kv_initialized and self._compression_params:
                raise MXNetError(
                    f"compression_params given but kvstore="
                    f"{self._kvstore_type!r} creates no store to carry "
                    f"the compressed gradients")
            self._kv_initialized = True
            return
        from .. import kvstore as kv_mod
        try:
            self._kvstore = kv_mod.create(self._kvstore_type)
            if self._kvstore.num_devices <= 1 and \
                    not self._compression_params:
                # one device: nothing to reduce, unless compression's
                # quantization is asked for
                self._kvstore = None
        except MXNetError:
            self._kvstore = None
        if self._compression_params:
            if self._kvstore is None:
                raise MXNetError(
                    "compression_params given but no kvstore is "
                    f"available (type={self._kvstore_type!r})")
            self._kvstore.set_gradient_compression(
                self._compression_params)
        self._kv_initialized = True

    # ------------------------------------------------------------------
    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    @property
    def optimizer(self):
        return self._optimizer

    # ------------------------------------------------------------------
    def step(self, batch_size, ignore_stale_grad=False):
        """Reduce the gradients and update: ``rescale_grad`` is the
        constructor's ``rescale_grad / batch_size``."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._allreduce_grads()
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        if not self._kv_initialized:
            self._init_kvstore()
        self._allreduce_grads()

    def _allreduce_grads(self):
        """Push every gradient through the store and pull it back in
        place (no store: nothing to do)."""
        if self._kvstore is None:
            return
        for i, param in enumerate(self._params):
            t = param._tensor()
            if param.grad_req != "null" and t is not None and \
                    t.grad is not None:
                grad = param.grad()
                self._kvstore.push(i, grad, priority=-i)
                self._kvstore.pull(i, grad, priority=-i)

    def update(self, batch_size, ignore_stale_grad=False):
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        missing = [p.name for p in self._params
                   if p.grad_req != "null" and p._tensor() is None]
        if missing:
            raise MXNetError(
                f"cannot step: parameters {missing} are not initialized; "
                f"run forward+backward inside autograd.record() first")
        updater = self._updaters[0]
        with torch.profiler.record_function("update"):
            for i, param in enumerate(self._params):
                if param.grad_req == "null":
                    continue
                updater(i, param.grad(), param.data())

    # ------------------------------------------------------------------
    def save_states(self, fname):
        """The updater's states and the optimizer, pickled (mxtpu's
        ``Trainer.save_states``)."""
        with open(fname, "wb") as f:
            f.write(self._updaters[0].get_states(dump_optimizer=True))

    def load_states(self, fname):
        with open(fname, "rb") as f:
            data = f.read()
        dev = next((p._tensor().device for p in self._params
                    if p._tensor() is not None), None)
        self._updaters[0].set_states(data, device=dev)
        self._optimizer = self._updaters[0].optimizer
        self._optimizer.param_dict = self._param_dict()
