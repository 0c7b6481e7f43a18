"""Carry weights between ``mxtpu`` and an ``mxtpu_torch`` model.

``mxtpu`` gluon parameter names carry per-process counters
(``dense0_weight``, ``fusedresiduallayernorm3_gamma``…), so names say
nothing about which module a weight belongs to.  Weights are matched by
order instead: ``mxtpu``'s ``collect_params()`` order (which is also
the order of an exported ``.params`` file) against the model's own
order: each module's parameters, then its buffers (BatchNorm's
``running_mean`` and ``running_var``, mxtpu's aux parameters), module
by module in registration order — for a model without buffers, its
``parameters()`` order.  Every shape is checked.  ``Dense`` weights
are (out, in) on both sides and convolution weights keep the
reference's layout, so nothing is transposed.

Symbolic models name their arrays in the graph, the same names in both
packages, so :func:`symbol_params_from_mxtpu` and
:func:`symbol_params_to_mxtpu` carry ``Module.get_params()`` dicts by
name.

The NHWC conv kernel (``kernels.conv_nhwc``) and the conv strategy
probe take HWIO weights and NHWC activations, the layouts of the JAX
tool ``tools/probe_conv_strategies.py``; their carry is
``torch.from_numpy`` of the same seeded numpy arrays, so no function
here is needed for them.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .base import MXNetError

__all__ = ["params_from_mxtpu", "params_to_mxtpu", "named_tensors",
           "symbol_params_from_mxtpu", "symbol_params_to_mxtpu"]


def named_tensors(model: nn.Module) -> List[Tuple[str, torch.Tensor]]:
    """``model``'s parameters and buffers in ``collect_params()`` order:
    module by module, each module's own parameters, then its own
    buffers; a tensor shared by two modules counts once."""
    out, seen = [], set()
    for mname, mod in model.named_modules():
        for name, t in [*mod.named_parameters(recurse=False),
                        *mod.named_buffers(recurse=False)]:
            if id(t) not in seen:
                seen.add(id(t))
                out.append((f"{mname}.{name}" if mname else name, t))
    return out


def params_from_mxtpu(params: Dict[str, np.ndarray],
                      model: nn.Module) -> nn.Module:
    """Copy ``params`` (name → array in ``collect_params()`` order) into
    ``model``'s parameters and buffers in place; raises on a count or
    shape mismatch.  Returns the model."""
    targets = named_tensors(model)
    if len(params) != len(targets):
        raise MXNetError(
            f"params_from_mxtpu: {len(params)} mxtpu parameters for "
            f"{len(targets)} model parameters and buffers")
    staged = []
    for (src_name, arr), (dst_name, p) in zip(params.items(), targets):
        a = np.asarray(arr)
        if tuple(a.shape) != tuple(p.shape):
            raise MXNetError(
                f"params_from_mxtpu: {src_name} has shape "
                f"{tuple(a.shape)} but {dst_name} expects "
                f"{tuple(p.shape)}")
        staged.append((p, a))
    with torch.no_grad():
        for p, a in staged:
            p.copy_(torch.tensor(a, dtype=p.dtype))
    return model


def params_to_mxtpu(model: nn.Module,
                    names: Optional[Sequence[str]] = None
                    ) -> Dict[str, np.ndarray]:
    """The inverse of :func:`params_from_mxtpu`: ``model``'s parameters
    and buffers as f32 numpy arrays in ``collect_params()`` order, keyed
    by ``names`` (mxtpu's names, in that order) or else by the model's
    own names."""
    targets = named_tensors(model)
    if names is None:
        names = [n for n, _ in targets]
    names = list(names)
    if len(names) != len(targets):
        raise MXNetError(
            f"params_to_mxtpu: {len(names)} names for {len(targets)} "
            f"model parameters and buffers")
    return {n: p.detach().float().cpu().numpy()
            for n, (_, p) in zip(names, targets)}


def symbol_params_from_mxtpu(arg_params: Dict[str, np.ndarray],
                             aux_params: Dict[str, np.ndarray], ctx=None):
    """mxtpu's ``Module.get_params()`` (its arg and aux dicts, as numpy)
    as the port's ``Module.set_params`` input: two dicts of NDArrays on
    ``ctx`` (default the card), by the same names."""
    from .ndarray.ndarray import array
    return ({k: array(np.asarray(v), ctx=ctx) for k, v in
             arg_params.items()},
            {k: array(np.asarray(v), ctx=ctx) for k, v in
             aux_params.items()})


def symbol_params_to_mxtpu(arg_params: Dict, aux_params: Dict
                           ) -> Tuple[Dict[str, np.ndarray],
                                      Dict[str, np.ndarray]]:
    """The inverse of :func:`symbol_params_from_mxtpu`: the port's
    ``Module.get_params()`` as two dicts of numpy arrays, which mxtpu's
    ``Module.set_params`` takes after ``mxtpu.nd.array``."""
    return ({k: v.asnumpy() for k, v in arg_params.items()},
            {k: v.asnumpy() for k, v in aux_params.items()})
