"""BaseModule with the canonical ``fit`` loop (the counterpart of
``mxtpu/module/base_module.py``; reference
``python/mxnet/module/base_module.py``†)."""
from __future__ import annotations

import logging
from collections import namedtuple
from typing import List

from .. import metric as metric_mod
from ..ndarray import NDArray

__all__ = ["BaseModule", "BatchEndParam"]

BatchEndParam = namedtuple("BatchEndParam",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _as_metric(eval_metric):
    if isinstance(eval_metric, metric_mod.EvalMetric):
        return eval_metric
    return metric_mod.create(eval_metric)


class BaseModule:
    """Abstract trainer interface (reference ``BaseModule``†)."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False

    # -- abstract surface ----------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             **kwargs):
        raise NotImplementedError

    def init_params(self, initializer="uniform", arg_params=None,
                    aux_params=None, allow_missing=False,
                    force_init=False, allow_extra=False):
        raise NotImplementedError

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=None, force_init=False):
        raise NotImplementedError

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def get_outputs(self):
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError

    # -- shared conveniences -------------------------------------------
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, reset=True, epoch=0):
        """Evaluate on a DataIter (reference ``score``†)."""
        assert self.binded and self.params_initialized
        eval_metric = _as_metric(eval_metric)
        eval_metric.reset()
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                batch_end_callback(BatchEndParam(
                    epoch=epoch, nbatch=nbatch,
                    eval_metric=eval_metric, locals=locals()))
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True):
        """Run inference over a DataIter (reference ``predict``†)."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        outputs_list: List[List[NDArray]] = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            outs = self.get_outputs()
            if eval_batch.pad:
                outs = [o[:o.shape[0] - eval_batch.pad] for o in outs]
            outputs_list.append([o.copy() for o in outs])
        if not outputs_list:
            return []
        if merge_batches:
            num_outputs = len(outputs_list[0])
            from .. import ndarray as nd_mod
            merged = [nd_mod.concat(*[b[i] for b in outputs_list], dim=0)
                      for i in range(num_outputs)]
            return merged[0] if num_outputs == 1 else merged
        return outputs_list

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, initializer="uniform",
            arg_params=None, aux_params=None, allow_missing=False,
            force_rebind=False, force_init=False, begin_epoch=0,
            num_epoch=None, validation_metric=None, monitor=None):
        """The canonical training loop (reference ``fit``†; call stack
        SURVEY §3.3)."""
        assert num_epoch is not None, "num_epoch required"
        if not self.binded or force_rebind:
            self.bind(data_shapes=train_data.provide_data,
                      label_shapes=train_data.provide_label,
                      for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params,
                         allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=dict(optimizer_params)
                            if not isinstance(optimizer_params, dict)
                            else optimizer_params)
        eval_metric = _as_metric(eval_metric)
        validation_metric = validation_metric or eval_metric

        for epoch in range(begin_epoch, num_epoch):
            eval_metric.reset()
            train_data.reset()
            for nbatch, data_batch in enumerate(train_data):
                if monitor is not None:
                    monitor.tic()
                self.forward_backward(data_batch)
                self.update()
                self.update_metric(eval_metric, data_batch.label)
                if monitor is not None:
                    monitor.toc_print()
                if batch_end_callback is not None:
                    cbs = batch_end_callback if isinstance(
                        batch_end_callback, (list, tuple)) \
                        else [batch_end_callback]
                    for cb in cbs:
                        cb(BatchEndParam(epoch=epoch, nbatch=nbatch,
                                         eval_metric=eval_metric,
                                         locals=locals()))
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name,
                                 val)
            if epoch_end_callback is not None:
                arg_params, aux_params = self.get_params()
                cbs = epoch_end_callback if isinstance(
                    epoch_end_callback, (list, tuple)) \
                    else [epoch_end_callback]
                for cb in cbs:
                    cb(epoch, self.symbol, arg_params, aux_params)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f",
                                     epoch, name, val)

    def install_monitor(self, monitor):
        raise NotImplementedError

    def get_input_grads(self):
        raise NotImplementedError
