"""Operator registry — the single source of truth for ops (the
counterpart of ``mxtpu/ops/registry.py``).

An op's rule is a torch function from tensors to a tensor or a tuple of
tensors.  Shape inference runs the same rule on ``meta`` tensors, where
the JAX package uses ``jax.eval_shape`` (``mxtpu/ops/registry.py:
55-60``); gradients come from torch autograd, or from the rule's own
``torch.autograd.Function`` where the op defines its backward.

Every op registered here is exposed eagerly as ``mxtpu_torch.nd.<name>``
and lazily as ``mxtpu_torch.sym.<name>``.

An op with no inputs (``_arange``) has no tensor to take a device from:
its rule takes the device to create on as the keyword ``device``, which
is not one of its params.  The dispatchers pass it (``nd``'s ``ctx``, the
device of a graph's bindings, ``meta`` for shape inference).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..base import Registry
from .params import Param, ParamSet

__all__ = ["Op", "register_op", "get_op", "list_ops", "OP_REGISTRY",
           "Param"]


@dataclass
class Op:
    """Op metadata and rule.  ``num_inputs`` -1 means variadic;
    ``num_outputs_fn(attrs)`` gives the output count of ops whose count
    depends on their params."""
    name: str
    fn: Callable[..., Any]
    params: ParamSet = field(default_factory=ParamSet)
    num_inputs: int = 1
    num_outputs: int = 1
    differentiable: bool = True
    doc: str = ""
    aliases: Tuple[str, ...] = ()
    num_outputs_fn: Optional[Callable[[Dict[str, Any]], int]] = None

    def resolve_params(self, kwargs: Dict[str, Any]) -> Dict[str, Any]:
        return self.params.resolve(kwargs)

    def infer(self, *shapes, dtype=torch.float32, **kwargs
              ) -> List[Tuple[int, ...]]:
        """Output shapes for input ``shapes``: the rule run on ``meta``
        tensors (no data, no device)."""
        resolved = self.resolve_params(kwargs)
        metas = [torch.empty(tuple(s), dtype=dtype, device="meta")
                 for s in shapes]
        if self.num_inputs == 0:
            resolved["device"] = "meta"
        with torch.no_grad():
            out = self.fn(*metas, **resolved)
        outs = out if isinstance(out, tuple) else (out,)
        return [tuple(o.shape) for o in outs]

    def __call__(self, *tensors, **kwargs):
        return self.fn(*tensors, **self.resolve_params(kwargs))


OP_REGISTRY: Registry[Op] = Registry("operator")


def register_op(name: str, *, params: Sequence[Param] = (),
                num_inputs: int = 1, num_outputs: int = 1,
                differentiable: bool = True, aliases: Sequence[str] = (),
                doc: str = "", num_outputs_fn: Optional[Callable] = None):
    """Decorator registering a torch rule as a framework op."""
    def _wrap(fn: Callable[..., Any]) -> Callable[..., Any]:
        op = Op(name=name, fn=fn, params=ParamSet(*params),
                num_inputs=num_inputs, num_outputs=num_outputs,
                differentiable=differentiable,
                doc=doc or (fn.__doc__ or ""), aliases=tuple(aliases),
                num_outputs_fn=num_outputs_fn)
        OP_REGISTRY.register(name, aliases=tuple(aliases))(op)
        return fn
    return _wrap


def get_op(name: str) -> Op:
    return OP_REGISTRY.get(name)


def list_ops() -> List[str]:
    return OP_REGISTRY.list()
