"""The one-device train step (the counterpart of ``TrainStep`` and
``build_train_step`` in ``mxtpu/parallel/__init__.py``).

One call of a :class:`TrainStep` is forward, backward and the optimizer
update: the model runs in training mode on the step's device, the loss
is the f32 mean of ``loss_fn(net(x), y)``, and every trainable
parameter is updated by the optimizer's functional rule with this
step's ``lr`` and ``wd``.  The JAX package compiles that into one XLA
program; here it runs eagerly, the kernels' autograd Functions supplying
the backward of attention and the norms.

Mixed precision (``compute_dtype``): the f32 master parameters are cast
to ``compute_dtype`` for the forward (``torch.func.functional_call``
substitutes the casts for the module's parameters), so the GEMMs and
convolutions run in bf16 on the tensor cores, and autograd through each
cast hands an f32 gradient back to its master.  Buffers are not cast:
BatchNorm's running statistics stay f32 and the training-mode forward
updates the module's own buffers, as the JAX step keeps its aux
parameters f32.  The loss leaves the bf16 region in f32.
``cast_batch=True`` casts a float batch (images) to ``compute_dtype``;
``cast_batch=False`` keeps it in its own type (float token ids above
256 are not exact in bf16).  Labels are never cast.

A call runs inside two ``torch.profiler.record_function`` ranges,
``forward_backward`` and ``update``, so a profile of one call splits
the step without reaching into the class.

Not ported, and refused with ``NotImplementedError`` rather than
ignored: a device mesh (``mesh``), tensor parallelism
(``param_spec_fn``), ZeRO-1 (``zero``), policy AMP (``amp``), the
persistent executable cache (``cache``), bulked steps (``run_steps``)
and the batched (bucket-stacked) update; the update is per parameter,
the JAX package's ``MXTPU_BATCHED_OPT=0`` path.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..base import MXNetError
from ..context import resolve_device
from ..optimizer import optimizer as opt_mod
from ..optimizer.functional import adam_bias_correction, opt_rule

__all__ = ["TrainStep", "build_train_step"]


def _refuse(what: str) -> None:
    raise NotImplementedError(f"TrainStep: {what} is not ported yet "
                              f"(the port trains on one device)")


def _as_dtype(dtype) -> Optional[torch.dtype]:
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = str(np.dtype(dtype)) if not isinstance(dtype, str) else dtype
    got = getattr(torch, name, None)
    if not isinstance(got, torch.dtype) or not got.is_floating_point:
        raise MXNetError(f"compute_dtype {dtype!r} is not a float type")
    return got


def _f32(v: float) -> float:
    # the value the JAX step holds in its f32 lr/wd vectors
    return float(np.float32(v))


class TrainStep:
    """Forward + backward + optimizer update on one device.  Call with
    (x, y) batches (numpy arrays or tensors); the parameters update in
    place and the call returns the loss, an f32 scalar tensor on the
    device.  A call is :meth:`forward_backward` then :meth:`update`."""

    def __init__(self, net: nn.Module, loss_fn, optimizer, mesh=None,
                 param_spec_fn=None, compute_dtype=None, cast_batch=True,
                 zero=None, cache=None, amp=None, device=None):
        if mesh is not None:
            _refuse("a device mesh (data parallelism)")
        if param_spec_fn is not None:
            _refuse("param_spec_fn (tensor parallelism)")
        if zero:
            _refuse("ZeRO-1 (zero)")
        if amp:
            _refuse("policy-driven AMP (amp)")
        if cache is not None:
            _refuse("the persistent executable cache (cache)")
        self.device = resolve_device(device)
        self.net = net.to(self.device)
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.compute_dtype = _as_dtype(compute_dtype)
        self.cast_batch = cast_batch
        self._t = 0
        named = [(n, p) for n, p in self.net.named_parameters()
                 if p.requires_grad]
        self.param_names = [n for n, _ in named]
        self._params = [p for _, p in named]
        self._opt_init, self._opt_update = opt_rule(optimizer)
        with torch.no_grad():
            self._opt_state = [self._opt_init(p.detach())
                               for p in self._params]

    # -- one step ------------------------------------------------------
    def _batch(self, a, cast: bool) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(a) if not isinstance(
            a, torch.Tensor) else a).to(self.device)
        if cast and self.compute_dtype is not None and t.is_floating_point():
            t = t.to(self.compute_dtype)
        return t

    def forward_backward(self, x, y) -> Tuple[torch.Tensor,
                                              List[torch.Tensor]]:
        """The loss (f32 mean) and the f32 gradient of every trainable
        parameter (in ``param_names`` order), from one training-mode
        forward and backward: the first half of a step."""
        with torch.profiler.record_function("forward_backward"):
            x = self._batch(x, self.cast_batch)
            y = self._batch(y, False)
            self.net.train()
            if self.compute_dtype is None:
                pred = self.net(x)
            else:
                cd = self.compute_dtype
                cast = {n: (p.to(cd) if p.is_floating_point() else p)
                        for n, p in self.net.named_parameters()}
                pred = torch.func.functional_call(self.net, cast, (x,))
            loss = self.loss_fn(pred, y).float().mean()
            grads = torch.autograd.grad(loss, self._params,
                                        allow_unused=True)
        # a parameter the forward did not use (type_embed without token
        # types) has a zero gradient, as under JAX's AD
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(self._params, grads)]

    def _lrs_wds(self) -> Tuple[List[float], List[float]]:
        """Per-parameter (lr, wd) for this step: the Adam bias
        correction folded into the lr, ``lr_mult``/``wd_mult`` read live
        (a parameter's own attribute times the optimizer's entry for its
        name), each rounded to f32 as the JAX step's vectors are."""
        opt = self.optimizer
        opt.num_update = self._t
        lr = _f32(opt.learning_rate * adam_bias_correction(opt, self._t))
        lrs, wds = [], []
        for n, p in zip(self.param_names, self._params):
            lm = _f32(getattr(p, "lr_mult", 1.0) * opt.lr_mult.get(n, 1.0))
            wm = _f32(getattr(p, "wd_mult", 1.0) * opt.wd_mult.get(n, 1.0))
            lrs.append(_f32(lr * lm))
            wds.append(_f32(_f32(opt.wd) * wm))
        return lrs, wds

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor]) -> None:
        """The second half of a step: one optimizer update of every
        trainable parameter, each rebound to the rule's new value, as
        the JAX step rebinds its buffers."""
        with torch.profiler.record_function("update"):
            self._t += 1
            lrs, wds = self._lrs_wds()
            for j, (p, g) in enumerate(zip(self._params, grads)):
                w2, self._opt_state[j] = self._opt_update(
                    p.detach(), g, self._opt_state[j], lrs[j], wds[j])
                p.data = w2

    def __call__(self, x, y) -> torch.Tensor:
        loss, grads = self.forward_backward(x, y)
        self.update(grads)
        return loss

    # -- not ported / introspection -------------------------------------
    def run_steps(self, x, y, steps: int, reuse_batch: bool = False):
        _refuse("run_steps (bulked steps in one program)")

    def memory_summary(self) -> Dict[str, Any]:
        """Peak device memory since the last reset
        (``torch.cuda.max_memory_allocated``), with the bytes of the
        parameters and the optimizer state.  On the CPU the peak is not
        measured (None)."""
        params = sum(p.numel() * p.element_size() for p in self._params)
        state = sum(t.numel() * t.element_size()
                    for st in self._opt_state for t in st)
        peak = torch.cuda.max_memory_allocated(self.device) \
            if self.device.type == "cuda" else None
        return {"device": str(self.device), "peak_bytes": peak,
                "param_bytes": params, "opt_state_bytes": state}


def build_train_step(net, loss_fn, optimizer="sgd", optimizer_params=None,
                     mesh=None, param_spec_fn=None, compute_dtype=None,
                     cast_batch: bool = True, zero=None, cache=None,
                     amp=None, device=None) -> TrainStep:
    """net + loss + optimizer as one train step on ``device`` (default
    ``cuda:0``, which raises without CUDA; tests pass ``"cpu"``).
    ``optimizer`` is an :class:`Optimizer` or a registered name created
    with ``optimizer_params``."""
    if not isinstance(optimizer, opt_mod.Optimizer):
        optimizer = opt_mod.create(optimizer, **(optimizer_params or {}))
    return TrainStep(net, loss_fn, optimizer, mesh=mesh,
                     param_spec_fn=param_spec_fn, compute_dtype=compute_dtype,
                     cast_batch=cast_batch, zero=zero, cache=cache, amp=amp,
                     device=device)
