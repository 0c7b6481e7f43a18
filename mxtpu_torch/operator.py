"""Custom operators written in Python (the counterpart of
``mxtpu/operator.py``; reference ``python/mxnet/operator.py``†).

A ``CustomOp`` computes on NDArrays and writes its results with
``assign``; ``Custom`` runs it eagerly and, inside
``autograd.record()``, through a ``torch.autograd.Function`` whose
backward is the op's own ``backward``.  ``out_data``, ``aux`` and
``in_grad`` are allocated on the inputs' device in the inputs' type
(the JAX package makes them with ``np.zeros``, ``operator.py:95-111``).
A custom op's forward and backward may launch their own kernels:
``mxtpu_torch.rtc.CudaModule`` is the facility for that on the card.
"""
from __future__ import annotations

from typing import List, Type

import torch

from .base import MXNetError, Registry
from . import autograd
from .ndarray.ndarray import NDArray

__all__ = ["CustomOp", "CustomOpProp", "register", "get_custom_op",
           "Custom"]

_CUSTOM_REGISTRY: Registry = Registry("custom_op")


class CustomOp:
    """Base custom operator (reference ``mx.operator.CustomOp``†)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst: NDArray, req: str, src) -> None:
        """Write ``src`` into ``dst`` by the request: ``"write"`` (and
        ``"inplace"``) replace, ``"add"`` accumulates, ``"null"`` skips
        (reference ``assign``†)."""
        if req == "null":
            return
        src = src._data if isinstance(src, NDArray) else \
            torch.as_tensor(src, device=dst._data.device)
        src = src.to(dst._data.dtype)
        if req == "add":
            dst._data = dst._data + src
        elif req in ("write", "inplace"):
            dst._data = src
        else:
            raise MXNetError(f"unknown req {req!r}")


class CustomOpProp:
    """Operator properties: arity, shapes, op factory (reference
    ``mx.operator.CustomOpProp``†)."""

    def __init__(self, need_top_grad: bool = True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self) -> List[str]:
        return ["data"]

    def list_outputs(self) -> List[str]:
        return ["output"]

    def list_auxiliary_states(self) -> List[str]:
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), []

    def create_operator(self, ctx, in_shapes, in_dtypes) -> CustomOp:
        raise NotImplementedError


def register(reg_name: str):
    """Decorator registering a ``CustomOpProp`` subclass under
    ``reg_name`` (reference ``mx.operator.register``†)."""
    def _wrap(prop_cls: Type[CustomOpProp]):
        _CUSTOM_REGISTRY.register(reg_name)(prop_cls)
        return prop_cls
    return _wrap


def get_custom_op(name: str) -> Type[CustomOpProp]:
    return _CUSTOM_REGISTRY.get(name)


class _Bridge(torch.autograd.Function):
    """The custom op's forward and backward under torch autograd."""

    @staticmethod
    def forward(ctx, run, *tensors):
        ctx.run = run
        return run.forward(tensors)

    @staticmethod
    def backward(ctx, *out_grads):
        grads = ctx.run.backward(out_grads)
        return (None,) + tuple(g if need else None for g, need in
                               zip(grads, ctx.needs_input_grad[1:]))


class _Run:
    """One invocation of a custom op: its arrays and the calls."""

    def __init__(self, prop, inputs):
        x0 = inputs[0]._data
        self.dev, self.dtype = x0.device, x0.dtype
        self.in_shapes = [tuple(x.shape) for x in inputs]
        _, out_shapes, aux_shapes = prop.infer_shape(self.in_shapes)
        self.op = prop.create_operator(self.dev, self.in_shapes,
                                       [x.dtype for x in inputs])
        self.out_data = [self._zeros(s) for s in out_shapes]
        self.aux = [self._zeros(s) for s in aux_shapes]
        self.ins: List[NDArray] = []

    def _zeros(self, shape) -> NDArray:
        return NDArray(torch.zeros(tuple(shape), dtype=self.dtype,
                                   device=self.dev))

    def forward(self, tensors, is_train=True):
        self.ins = [NDArray(t.detach()) for t in tensors]
        with autograd.pause(is_train):
            self.op.forward(is_train=is_train,
                            req=["write"] * len(self.out_data),
                            in_data=self.ins, out_data=self.out_data,
                            aux=self.aux)
        return tuple(o._data for o in self.out_data) \
            if len(self.out_data) > 1 else self.out_data[0]._data

    def backward(self, out_grads):
        in_grad = [self._zeros(s) for s in self.in_shapes]
        with autograd.pause():
            self.op.backward(req=["write"] * len(in_grad),
                             out_grad=[NDArray(g) for g in out_grads],
                             in_data=self.ins, out_data=self.out_data,
                             in_grad=in_grad, aux=self.aux)
        return [g._data for g in in_grad]


def Custom(*inputs, op_type: str, **kwargs):  # noqa: N802
    """Run the custom op registered as ``op_type`` on NDArrays (the
    ``mx.nd.Custom`` surface†); differentiable inside
    ``autograd.record()``.  Inputs must share one device."""
    if not inputs or not all(isinstance(x, NDArray) for x in inputs):
        raise MXNetError("Custom takes NDArray inputs")
    devs = {x._data.device for x in inputs}
    if len(devs) != 1:
        raise MXNetError(f"Custom inputs on several devices: "
                         f"{sorted(map(str, devs))}")
    prop = get_custom_op(op_type)(**kwargs)
    run = _Run(prop, inputs)
    tensors = [x._data for x in inputs]
    if autograd.is_recording() and any(t.requires_grad for t in tensors):
        with torch.enable_grad():
            out = _Bridge.apply(run, *tensors)
    else:
        out = run.forward(tensors, is_train=False)
    return NDArray(out) if isinstance(out, torch.Tensor) else \
        tuple(NDArray(o) for o in out)
