"""Module — the symbol + executor trainer (the counterpart of
``mxtpu/module/module.py``; reference ``python/mxnet/module/
module.py``†).

One executor on one device (``context=``, default the card) evaluates
the graph; batches from the host are copied onto it.  ``kvstore`` is
accepted, whatever its value, and changes nothing, as in the JAX
package, which creates no store there: the update runs in this process
through an :class:`~mxtpu_torch.optimizer.Updater`.
"""
from __future__ import annotations

import logging

import torch

from ..base import MXNetError
from ..context import resolve_device
from .. import initializer as init_mod
from .. import optimizer as opt_mod
from ..io import DataDesc
from ..ndarray import ndarray as _nda
from ..ndarray.ndarray import NDArray
from .base_module import BaseModule

__all__ = ["Module"]


def _descs(shapes):
    return [d if hasattr(d, "name") else DataDesc(d[0], d[1])
            for d in (shapes or [])]


class Module(BaseModule):
    """Single-symbol trainer (reference ``Module``†)."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=None,
                 context=None, work_load_list=None,
                 fixed_param_names=None, state_names=None):
        super().__init__(logger or logging)
        self._symbol = symbol
        self._context = resolve_device(context)
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._fixed_param_names = set(fixed_param_names or [])
        self._param_names = [n for n in symbol.list_arguments()
                             if n not in self._data_names
                             and n not in self._label_names]
        self._aux_names = symbol.list_auxiliary_states()
        self._exec = None
        self._optimizer = None
        self._updater = None
        self._data_shapes = None
        self._label_shapes = None
        self._preload_states = None

    @property
    def symbol(self):
        return self._symbol

    @property
    def context(self) -> torch.device:
        return self._context

    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        if self._exec is None or self._exec._outputs is None:
            return None
        return [o.shape for o in self._exec.outputs]

    # -- bind -------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        if self.binded and not force_rebind:
            return
        self._data_shapes = _descs(data_shapes)
        self._label_shapes = _descs(label_shapes)
        shapes = {d.name: d.shape for d in
                  self._data_shapes + self._label_shapes}
        arg_names = self._symbol.list_arguments()
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**shapes)
        dev = self._context
        args = {n: _nda.zeros(s, dev) for n, s in zip(arg_names, arg_shapes)}
        aux = {n: _nda.zeros(s, dev)
               for n, s in zip(self._aux_names, aux_shapes)}
        req = {}
        for n in arg_names:
            if n in self._data_names:
                req[n] = "write" if inputs_need_grad else "null"
            elif n in self._label_names or n in self._fixed_param_names:
                req[n] = "null"
            else:
                req[n] = grad_req if for_training else "null"
        self._exec = self._symbol.bind(ctx=dev, args=args, grad_req=req,
                                       aux_states=aux)
        self.binded = True
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad

    # -- params -----------------------------------------------------------
    def init_params(self, initializer="uniform", arg_params=None,
                    aux_params=None, allow_missing=False,
                    force_init=False, allow_extra=False):
        """Copy ``arg_params``/``aux_params`` (NDArrays or numpy) into the
        bound arrays and run ``initializer`` on the rest, by name."""
        if not self.binded:
            raise MXNetError("bind before init_params")
        if self.params_initialized and not force_init:
            return
        init = init_mod.create(initializer)
        for names, src, dst in ((self._param_names, arg_params,
                                 self._exec.arg_dict),
                                (self._aux_names, aux_params,
                                 self._exec.aux_dict)):
            for name in names:
                arr = dst[name]
                if src is not None and name in src:
                    val = src[name]
                    val = val._data if isinstance(val, NDArray) else \
                        torch.as_tensor(val)
                    if tuple(val.shape) != arr.shape:
                        raise MXNetError(
                            f"{name}: shape {tuple(val.shape)} given, "
                            f"{arr.shape} bound")
                    arr[:] = val
                else:
                    # missing params run the initializer (reference
                    # semantics: allow_missing only waives the error)
                    init(init_mod.InitDesc(name), arr)
        self.params_initialized = True

    def get_params(self):
        """Copies of the ``(arg_params, aux_params)`` dicts."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind and init_params before get_params")
        arg = {n: self._exec.arg_dict[n].copy() for n in self._param_names}
        aux = {n: self._exec.aux_dict[n].copy() for n in self._aux_names}
        return arg, aux

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(arg_params=arg_params, aux_params=aux_params,
                         allow_missing=allow_missing, force_init=force_init)

    # -- optimizer --------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=None, force_init=False):
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind and init_params before init_optimizer")
        if self.optimizer_initialized and not force_init:
            return
        if not isinstance(optimizer, opt_mod.Optimizer):
            optimizer = opt_mod.create(optimizer,
                                       **dict(optimizer_params or {}))
        optimizer.idx2name = dict(enumerate(self._param_names))
        self._optimizer = optimizer
        self._updater = opt_mod.get_updater(optimizer)
        if self._preload_states is not None:
            with open(self._preload_states, "rb") as f:
                self._updater.set_states(f.read(), self._context)
            self._optimizer = self._updater.optimizer
            self._preload_states = None
        self.optimizer_initialized = True

    # -- execution --------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind and init_params before forward")
        is_train = self.for_training if is_train is None else is_train
        feeds = dict(zip(self._data_names, data_batch.data))
        if data_batch.label is not None:
            feeds.update(zip(self._label_names, data_batch.label))
        self._exec.forward(is_train=is_train, **feeds)

    def backward(self, out_grads=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind and init_params before backward")
        self._exec.backward(out_grads=out_grads)

    def update(self):
        """One optimizer step from the gradients of the last backward
        (reference ``update``†)."""
        if not self.optimizer_initialized:
            raise MXNetError("init_optimizer before update")
        for i, name in enumerate(self._param_names):
            grad = self._exec.grad_dict.get(name)
            if grad is not None:
                self._updater(i, grad, self._exec.arg_dict[name])

    def get_outputs(self, merge_multi_context=True):
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        if not self.inputs_need_grad:
            raise MXNetError("bind with inputs_need_grad=True first")
        return [self._exec.grad_dict.get(n) for n in self._data_names]

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.get_outputs())

    def install_monitor(self, monitor):
        monitor.install(self._exec)

    # -- persistence ------------------------------------------------------
    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        from .. import model
        arg, aux = self.get_params()
        model.save_checkpoint(prefix, epoch, self._symbol, arg, aux)
        if save_optimizer_states and self._updater is not None:
            with open(f"{prefix}-{epoch:04d}.states", "wb") as f:
                f.write(self._updater.get_states())

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module over a checkpoint's symbol whose ``init_params``
        starts from the checkpoint's arrays."""
        from .. import model
        sym, arg, aux = model.load_checkpoint(prefix, epoch,
                                              kwargs.get("context"))
        mod = Module(sym, **kwargs)
        if load_optimizer_states:
            mod._preload_states = f"{prefix}-{epoch:04d}.states"
        orig_init = mod.init_params

        def init_with_loaded(initializer="uniform", arg_params=None,
                             aux_params=None, **kw):
            orig_init(initializer=initializer,
                      arg_params=arg_params or arg,
                      aux_params=aux_params or aux, **kw)
        mod.init_params = init_with_loaded
        return mod
