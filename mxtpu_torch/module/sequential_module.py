"""SequentialModule, PythonModule and PythonLossModule (the counterpart
of ``mxtpu/module/sequential_module.py``; reference
``python/mxnet/module/sequential_module.py``† / ``python_module.py``†):
chain modules so one module's outputs feed the next, and wrap plain
Python compute as a module.
"""
from __future__ import annotations

import logging
from typing import List

import numpy as np

from ..base import MXNetError
from ..io import DataBatch, DataDesc
from ..ndarray.ndarray import NDArray, array
from .base_module import BaseModule

__all__ = ["SequentialModule", "PythonModule", "PythonLossModule"]


class SequentialModule(BaseModule):
    """A container chaining modules; outputs of module i become the
    data of module i+1 (reference ``SequentialModule``†)."""

    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger)
        self._modules: List[BaseModule] = []
        self._metas: List[dict] = []
        self._label_shapes = None
        self._data_shapes = None

    def add(self, module: BaseModule, **kwargs) -> "SequentialModule":
        """Append a module.  ``take_labels=True`` marks the module
        that consumes the loader's labels (usually the last one)."""
        self._modules.append(module)
        self._metas.append(kwargs)
        self.binded = False
        return self

    @property
    def data_names(self):
        return self._modules[0].data_names if self._modules else []

    @property
    def output_names(self):
        return self._modules[-1].output_names if self._modules else []

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._modules[-1].output_shapes

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             grad_req="write", **kwargs):
        if self.binded and not force_rebind:
            return
        if not self._modules:
            raise MXNetError("SequentialModule.bind: no modules added")
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        cur_shapes = data_shapes
        for i, (mod, meta) in enumerate(zip(self._modules,
                                            self._metas)):
            take_labels = meta.get(self.META_TAKE_LABELS, False) or \
                i == len(self._modules) - 1
            mod.bind(cur_shapes,
                     label_shapes if take_labels else None,
                     for_training=for_training,
                     inputs_need_grad=inputs_need_grad or i > 0,
                     force_rebind=force_rebind, grad_req=grad_req)
            # next module consumes this module's outputs, renamed to
            # its own data names; shapes come from symbol inference
            # (executor outputs don't exist until the first forward)
            if i + 1 == len(self._modules):
                break
            nxt = self._modules[i + 1].data_names
            out_shapes = self._infer_output_shapes(
                mod, cur_shapes,
                label_shapes if take_labels else None)
            cur_shapes = [
                DataDesc(nxt[j] if j < len(nxt) else f"out{j}", s)
                for j, s in enumerate(out_shapes)]
        self.binded = True
        self.for_training = for_training

    @staticmethod
    def _infer_output_shapes(mod, data_shapes, label_shapes):
        sym = getattr(mod, "symbol", None)
        if sym is None:  # e.g. PythonModule mid-chain
            return [tuple(d.shape) for d in mod.output_shapes]
        shapes = {d.name: tuple(d.shape) for d in data_shapes}
        shapes.update({d.name: tuple(d.shape)
                       for d in (label_shapes or [])})
        known = set(sym.list_inputs())
        _, out_shapes, _ = sym.infer_shape(
            **{k: v for k, v in shapes.items() if k in known})
        return [tuple(int(x) for x in s) for s in out_shapes]

    def init_params(self, initializer="uniform", arg_params=None,
                    aux_params=None, allow_missing=False,
                    force_init=False, **kwargs):
        # each child owns only a SUBSET of arg_params, so children run
        # with allow_missing=True; the caller's allow_missing contract
        # is enforced globally below (a typo'd checkpoint key must not
        # silently fresh-initialize)
        for mod in self._modules:
            mod.init_params(initializer=initializer,
                            arg_params=arg_params,
                            aux_params=aux_params,
                            allow_missing=True,
                            force_init=force_init)
        self.params_initialized = True
        if not allow_missing and arg_params is not None:
            arg, aux = self.get_params()
            known = set(arg) | set(aux)
            unknown = [k for k in arg_params if k not in known]
            if unknown:
                raise MXNetError(
                    f"arg_params keys {sorted(unknown)} match no "
                    f"module parameter (allow_missing=False)")
            # every trainable must come from arg_params — a partial
            # checkpoint fails loudly instead of silently
            # fresh-initializing the gaps.  Aux states are only
            # required when aux_params was explicitly provided
            # (aux_params=None means "fresh aux", reference semantics)
            missing = [k for k in arg if k not in arg_params]
            if aux_params is not None:
                missing += [k for k in aux if k not in aux_params]
            if missing:
                raise MXNetError(
                    f"checkpoint is missing parameters "
                    f"{sorted(missing)} (allow_missing=False)")

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=None, force_init=False):
        for mod in self._modules:
            mod.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                               optimizer_params=optimizer_params,
                               force_init=force_init)
        self.optimizer_initialized = True

    def get_params(self):
        arg, aux = {}, {}
        for mod in self._modules:
            a, x = mod.get_params()
            arg.update(a)
            aux.update(x)
        return arg, aux

    def forward(self, data_batch, is_train=None):
        batch = data_batch
        for i, mod in enumerate(self._modules):
            mod.forward(batch, is_train=is_train)
            if i + 1 == len(self._modules):
                break
            outs = mod.get_outputs()
            nxt = self._modules[i + 1]
            batch = DataBatch(
                data=outs, label=data_batch.label,
                pad=getattr(data_batch, "pad", 0),
                provide_data=[
                    DataDesc(n, tuple(o.shape))
                    for n, o in zip(nxt.data_names, outs)],
                provide_label=getattr(data_batch, "provide_label",
                                      None))

    def backward(self, out_grads=None):
        grads = out_grads
        for i in range(len(self._modules) - 1, -1, -1):
            mod = self._modules[i]
            mod.backward(out_grads=grads)
            if i > 0:  # module 0's inputs are the data — no grad
                grads = mod.get_input_grads()

    def update(self):
        for mod in self._modules:
            mod.update()

    def get_outputs(self):
        return self._modules[-1].get_outputs()

    def get_input_grads(self):
        return self._modules[0].get_input_grads()

    def update_metric(self, eval_metric, labels):
        self._modules[-1].update_metric(eval_metric, labels)


class PythonModule(BaseModule):
    """A module whose compute is plain python (reference
    ``PythonModule``†) — parameterless by default; subclass and
    override :meth:`forward`."""

    def __init__(self, data_names, label_names, output_names,
                 logger=logging):
        super().__init__(logger)
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._output_names = list(output_names)
        self._outputs: List[NDArray] = []
        self._data_shapes = None
        self._label_shapes = None

    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._compute_output_shapes()

    def _compute_output_shapes(self):
        """Default: one output shaped like the first input."""
        return [DataDesc(self._output_names[0],
                         tuple(self._data_shapes[0].shape))]

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             grad_req="write", **kwargs):
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        self.binded = True
        self.for_training = for_training

    def init_params(self, *args, **kwargs):
        self.params_initialized = True

    def init_optimizer(self, *args, **kwargs):
        self.optimizer_initialized = True

    def get_params(self):
        return {}, {}

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError(
            "subclass PythonModule and implement forward")

    def backward(self, out_grads=None):
        pass

    def update(self):
        pass

    def get_outputs(self):
        return self._outputs

    def get_input_grads(self):
        return []

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.get_outputs())


class PythonLossModule(PythonModule):
    """Loss expressed in python (reference ``PythonLossModule``†):
    forward stores the prediction; ``backward`` produces the gradient
    via ``grad_func(pred, label)``."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), grad_func=None,
                 logger=logging):
        super().__init__(data_names, label_names,
                         [name + "_output"], logger)
        self._name = name
        self._grad_func = grad_func
        self._scores = None
        self._labels = None
        self._scores_grad = None

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if data_batch.label:
            self._labels = data_batch.label[0]
        self._outputs = [self._scores]

    def backward(self, out_grads=None):
        if self._grad_func is None:
            raise MXNetError("PythonLossModule needs grad_func to "
                             "backpropagate")
        grad = self._grad_func(self._scores, self._labels)
        if not isinstance(grad, NDArray):
            # beside the scores, for the module that made them
            grad = array(np.asarray(grad), ctx=self._scores.context)
        self._scores_grad = grad

    def get_input_grads(self):
        return [self._scores_grad]
