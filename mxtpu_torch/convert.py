"""Carry weights between ``mxtpu`` and an ``mxtpu_torch`` model.

A gluon Block of the port carries mxtpu's parameter names
(``bertmodel0_pos_embed``, ``dense0_weight``, ...), so its weights are
matched by name: a name missing on either side raises, and so does a
shape that differs.  A name holds only where both packages built the
same blocks in the same order (the counters are per process, as in
mxtpu): a fresh process, or counters set alike.

Any other ``nn.Module`` is matched by order: ``mxtpu``'s
``collect_params()`` order (which is also the order of an exported
``.params`` file) against the model's own order, each module's
parameters, then its buffers, module by module in registration order.

``Dense`` weights are (out, in) on both sides and convolution weights
keep the reference's layout, so nothing is transposed.

mxtpu's functional ``MoEFFN.params()`` is a 5-tuple ``(gate_w, w1, b1,
w2, b2)`` of arrays; :func:`moe_params_from_numpy` makes the port's
tensors of it.  ``gluon.contrib.nn.MoEDense`` is a Block and crosses by
name like the others.

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
           "symbol_params_from_mxtpu", "symbol_params_to_mxtpu",
           "moe_params_from_numpy"]


def _block_params(model):
    from .gluon.block import Block
    return model.collect_params() if isinstance(model, Block) else None


def named_tensors(model: nn.Module) -> List[Tuple[str, torch.Tensor]]:
    """``model``'s parameters and buffers in ``collect_params()`` order:
    a Block's by mxtpu's names; another module's module by module, each
    module's own parameters, then its own buffers; a tensor shared by
    two modules counts once."""
    gparams = _block_params(model)
    if gparams is not None:
        return [(n, p._checked()) for n, p in gparams.items()]
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
    """Copy ``params`` (name → array) into ``model``: a Block's
    parameters by name (one not initialized yet takes the array's
    shape), another module's parameters and buffers by
    ``collect_params()`` order.  Raises on a missing or extra name, a
    count or a shape mismatch.  Returns the model."""
    gparams = _block_params(model)
    if gparams is not None:
        missing = [n for n in gparams.keys() if n not in params]
        extra = [n for n in params if n not in gparams]
        if missing or extra:
            raise MXNetError(
                f"params_from_mxtpu: names differ: missing "
                f"{missing[:5]}{'...' if len(missing) > 5 else ''}, extra "
                f"{extra[:5]}{'...' if len(extra) > 5 else ''}")
        for n, p in gparams.items():
            a = np.asarray(params[n])
            want = p._tensor().shape if p._tensor() is not None \
                else p.shape
            if want is not None and (len(want) != a.ndim or any(
                    w not in (0, s) for w, s in zip(want, a.shape))):
                raise MXNetError(
                    f"params_from_mxtpu: {n} has shape {tuple(a.shape)} "
                    f"but the model expects {tuple(want)}")
        for n, p in gparams.items():
            p.set_data(np.asarray(params[n]))
        return model
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
    by the Block's names (``names``, when given, must be the same set
    and give the order), or for another module by ``names`` (mxtpu's
    names, in that order) or else the module's own."""
    gparams = _block_params(model)
    if gparams is not None:
        order = list(gparams.keys()) if names is None else list(names)
        if sorted(order) != sorted(gparams.keys()):
            raise MXNetError("params_to_mxtpu: names differ from the "
                             "model's")
        return {n: gparams[n]._checked().detach().float().cpu().numpy()
                for n in order}
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


def moe_params_from_numpy(params: Sequence, device=None, dtype=None
                          ) -> Tuple[torch.Tensor, ...]:
    """mxtpu's ``MoEFFN.params()`` 5-tuple ``(gate_w (D, E), w1 (E, D,
    H), b1 (E, H), w2 (E, H, D), b2 (E, D))``, as numpy arrays (or
    anything ``np.asarray`` takes), as tensors on ``device`` (default
    the card) in ``dtype`` (default each array's own)."""
    from .context import resolve_device
    if len(params) != 5:
        raise MXNetError(f"moe_params_from_numpy: 5 arrays (gate_w, w1, "
                         f"b1, w2, b2), got {len(params)}")
    arrs = [np.asarray(a) for a in params]
    D, E = arrs[0].shape
    H = arrs[1].shape[-1]
    want = [(D, E), (E, D, H), (E, H), (E, H, D), (E, D)]
    for name, a, w in zip(("gate_w", "w1", "b1", "w2", "b2"), arrs, want):
        if tuple(a.shape) != w:
            raise MXNetError(f"moe_params_from_numpy: {name} has shape "
                             f"{tuple(a.shape)}, expected {w}")
    dev = resolve_device(device)

    def tensor(a):
        # numpy has no bfloat16 of its own: jax's arrays come through f32
        if a.dtype.name == "bfloat16":
            return torch.tensor(a.astype(np.float32), device=dev).to(
                dtype or torch.bfloat16)
        return torch.tensor(a, dtype=dtype, device=dev)
    return tuple(tensor(a) for a in arrs)
