"""BucketingModule — one Module a bucket key, all on one set of
parameter arrays (the counterpart of ``mxtpu/module/bucketing_module.py``;
reference ``python/mxnet/module/bucketing_module.py``†, MXNet's answer
to variable-length sequences).

Each bucket is a Module over ``sym_gen(key)``'s symbol; the buckets
after the first bind their parameter, gradient and auxiliary names to
the default bucket's NDArrays (the same objects), and share its
optimizer and updater, so the momentum a weight carries is one.
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, Optional

from ..base import MXNetError
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    """``sym_gen(bucket_key) -> (symbol, data_names, label_names)``
    (reference ``BucketingModule``†)."""

    def __init__(self, sym_gen: Callable, default_bucket_key=None,
                 logger=None, context=None, fixed_param_names=None):
        super().__init__(logger or logging)
        if default_bucket_key is None:
            raise MXNetError("default_bucket_key required")
        self._sym_gen = sym_gen
        self._default_key = default_bucket_key
        self._context = context
        self._fixed = fixed_param_names
        self._buckets: Dict = {}
        self._curr_mod: Optional[Module] = None
        self._curr_key = None
        self._monitor = None

    @property
    def symbol(self):
        return self._curr_mod.symbol if self._curr_mod else \
            self._sym_gen(self._default_key)[0]

    def _get_module(self, bucket_key, data_shapes, label_shapes,
                    for_training=True):
        if bucket_key not in self._buckets:
            sym, data_names, label_names = self._sym_gen(bucket_key)
            mod = Module(sym, data_names=data_names,
                         label_names=label_names, logger=self.logger,
                         context=self._context,
                         fixed_param_names=self._fixed)
            mod.bind(data_shapes, label_shapes, for_training=for_training)
            if self._curr_mod is not None and \
                    self._curr_mod.params_initialized:
                self._share_params(mod)
            if self._monitor is not None:
                mod.install_monitor(self._monitor)
            self._buckets[bucket_key] = mod
        return self._buckets[bucket_key]

    def _share_params(self, mod):
        """Bind the default bucket's arrays into ``mod``: one set of
        weights, gradients and auxiliary states across buckets."""
        default = self._buckets[self._default_key]
        for name in mod._param_names:
            if name in default._exec.arg_dict:
                mod._exec.arg_dict[name] = default._exec.arg_dict[name]
                if name in default._exec.grad_dict:
                    mod._exec.grad_dict[name] = \
                        default._exec.grad_dict[name]
        for name in mod._aux_names:
            if name in default._exec.aux_dict:
                mod._exec.aux_dict[name] = default._exec.aux_dict[name]
        mod.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             force_rebind=False, **kwargs):
        if self.binded and not force_rebind:
            return
        self._curr_mod = self._get_module(self._default_key, data_shapes,
                                          label_shapes, for_training)
        self._curr_key = self._default_key
        self.binded = True
        self.for_training = for_training

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make the bucket's Module current, binding it on first use
        (reference†)."""
        if not self.binded:
            raise MXNetError("bind before switch_bucket")
        mod = self._get_module(bucket_key, data_shapes, label_shapes,
                               self.for_training)
        if not mod.params_initialized and self.params_initialized:
            self._share_params(mod)
        self._curr_mod = mod
        self._curr_key = bucket_key

    def init_params(self, **kwargs):
        if not self.binded:
            raise MXNetError("bind before init_params")
        self._buckets[self._default_key].init_params(**kwargs)
        self.params_initialized = True

    def get_params(self):
        return self._buckets[self._default_key].get_params()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=None, force_init=False):
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind and init_params before init_optimizer")
        default = self._buckets[self._default_key]
        default.init_optimizer(kvstore, optimizer, optimizer_params,
                               force_init)
        # one updater (one set of optimizer states) for the shared
        # weights
        for mod in self._buckets.values():
            if mod is not default:
                self._share_optimizer(mod)
        self.optimizer_initialized = True

    def _share_optimizer(self, mod):
        default = self._buckets[self._default_key]
        mod._optimizer = default._optimizer
        mod._updater = default._updater
        mod.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind and init_params before forward")
        key = getattr(data_batch, "bucket_key", self._default_key)
        if key != self._curr_key or key not in self._buckets:
            self.switch_bucket(key, data_batch.provide_data,
                               data_batch.provide_label)
            if self.optimizer_initialized and \
                    not self._curr_mod.optimizer_initialized:
                self._share_optimizer(self._curr_mod)
        self._curr_mod.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        self._curr_mod.backward(out_grads)

    def update(self):
        # the weights live in the shared arrays
        self._curr_mod.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_mod.get_outputs()

    def get_input_grads(self):
        return self._curr_mod.get_input_grads()

    def update_metric(self, eval_metric, labels):
        self._curr_mod.update_metric(eval_metric, labels)

    def install_monitor(self, monitor):
        self._monitor = monitor  # later buckets take it when created
        for mod in self._buckets.values():
            mod.install_monitor(monitor)
