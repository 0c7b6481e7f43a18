"""The one-device train step (the counterpart of ``TrainStep`` and
``build_train_step`` in ``mxtpu/parallel/__init__.py``).

One call of a :class:`TrainStep` is forward, backward and the optimizer
update: the model runs in training mode on the step's device, the loss
is the f32 mean of ``loss_fn(net(x), y)``, and every trainable
parameter is updated by the optimizer's functional rule with this
step's ``lr`` and ``wd``.  The JAX package compiles that into one XLA
program; here it runs eagerly, the kernels' autograd Functions supplying
the backward of attention and the norms.

The update is bucketed, as the JAX package's is by default
(``MXTPU_BATCHED_OPT``, ``mxtpu/parallel/__init__.py:636-686``): the
trainable parameters are grouped by (shape, dtype) in parameter order,
and each bucket of more than one goes through the rule once, stacked
on a new axis 0, with lr/wd as Python floats where the bucket's
parameters share them and as ``(n, 1, ..., 1)`` f32 tensors where they
do not.  A bucket's weights and optimizer state live in one contiguous
``(n,) + shape`` tensor each, the parameters being views of it, so a
step stacks only the gradients and the update writes the weights and
the state **in place** (a second copy of BERT-Large's adam state would
cost 2.7 GB).  A parameter rebound after the step was built (``p.data
= ...``) is found by its data pointer before the next update and its
bucket re-packed from the live parameters.  ``MXTPU_BATCHED_OPT=0``
updates one parameter at a time, also in place; the rules are
elementwise, so the two paths agree bit for bit (LAMB's trust-ratio
norms, reduced per slice, to rounding).

The model is a gluon Block (its trainable parameters and
``param_names`` from ``collect_params()`` in mxtpu's order; those with
``grad_req="null"`` are not updated) or any ``nn.Module`` (its
``named_parameters()`` that require grad).  A Block whose shapes are
still deferred is set up at the first step, after one predict-mode
forward of its batch, as mxtpu's step does.  The forward runs in
``autograd.train_mode()``, the training flag gluon's layers read.

Mixed precision (``compute_dtype``): the f32 master parameters are cast
to ``compute_dtype`` for the forward (``torch.func.functional_call``
substitutes the casts for the module's parameters), so the GEMMs and
convolutions run in bf16 on the tensor cores, and autograd through each
cast hands an f32 gradient back to its master.  A frozen float
parameter takes the compute type too, as in mxtpu, except BatchNorm's
running statistics: they stay f32 and the training-mode forward
updates the module's own, as the JAX step keeps its aux parameters
f32.  The loss leaves the bf16 region in f32.
``cast_batch=True`` casts a float batch (images) to ``compute_dtype``;
``cast_batch=False`` keeps it in its own type (float token ids above
256 are not exact in bf16).  Labels are never cast.

:meth:`TrainStep.run_steps` runs several steps in one call with the
JAX package's semantics (``mxtpu/parallel/__init__.py:1148-1300``): lr
and wd are sampled once a call, after the step count has advanced by
the call's steps.  The JAX package scans them in one program; here they
are a Python loop (a captured CUDA graph is later work).
:meth:`save_states` / :meth:`load_states` write and read the JAX
package's checkpoint of the optimizer state, per parameter.

A call runs inside two ``torch.profiler.record_function`` ranges,
``forward_backward`` and ``update``, so a profile of one call splits
the step without reaching into the class; ``run_steps`` adds one
``run_steps`` range around its loop.

Policy AMP (``amp=True``, ``mxtpu/parallel/__init__.py:330-345``,
``:576-630``, ``:694-735``; :mod:`mxtpu_torch.amp`): the trainable f32
parameters are stored in bf16 from the first step on (aux-named ones,
BatchNorm's running statistics, stay f32), the optimizer's
multi-precision rule keeps their f32 masters, and its state is f32.
The forward upcasts every float parameter to f32 at the graph's entry
and runs inside ``amp.autocast()``, so only the policy's contractions
see bf16 (with f32 outputs).  With the dynamic loss scaler on
(``MXTPU_AMP_LOSS_SCALE`` > 0, the default) the loss is multiplied by
the scale, the gradients (bf16 at the parameters) are unscaled in f32,
and a step whose gradients are not all finite keeps every weight,
master and state tensor as it was; the scaler then grows, or halves
and counts the skipped step (:meth:`amp_stats`).  mxtpu keeps them with
``where`` on the device; the update here writes in place, so the step
reads the finiteness flag back to the host, once a step (also inside
``run_steps``), and skips the update there.  The scaler's state rides
``save_states``/``load_states``.  ``amp`` with ``compute_dtype``
raises, as in mxtpu; ``MXTPU_AMP=0`` turns AMP off everywhere.

Not ported, and refused with ``NotImplementedError`` rather than
ignored: a device mesh (``mesh``), tensor parallelism
(``param_spec_fn``), ZeRO-1 (``zero``) and the persistent executable
cache (``cache``).

:func:`plan_zero_buckets` (mxtpu's ZeRO-1 bucket geometry, pure
arithmetic over ``(shape, dtype)`` signatures) and :mod:`.moe` (the
Switch-MoE feed-forward) are exported as mxtpu exports them.
"""
from __future__ import annotations

import pickle
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import amp as _amp
from .. import autograd, knobs
from ..base import MXNetError
from ..context import resolve_device
from ..gluon.block import Block
from ..ndarray.ndarray import NDArray
from ..optimizer import optimizer as opt_mod
from ..optimizer.functional import (_needs_master, adam_bias_correction,
                                    opt_rule)

__all__ = ["TrainStep", "build_train_step", "plan_zero_buckets", "moe"]


def _refuse(what: str) -> None:
    raise NotImplementedError(f"TrainStep: {what} is not ported yet "
                              f"(the port trains on one device)")


def _itemsize(dt) -> int:
    """Bytes an element of the dtype named ``dt`` (``"bfloat16"``, which
    numpy does not know, included)."""
    name = str(dt).replace("torch.", "")
    got = getattr(torch, name, None)
    if isinstance(got, torch.dtype):
        return got.itemsize
    return np.dtype(name).itemsize


def plan_zero_buckets(sigs, dp: int, stack_axis_only: bool = False):
    """The ZeRO-1 bucket layout of one optimizer step, as mxtpu plans it
    (``mxtpu/parallel/__init__.py:202``): pure geometry, no arrays.

    ``sigs`` lists ``(shape, dtype_str)`` per trainable parameter in
    step order.  Parameters bucket by (shape, dtype) in first-seen
    order; each bucket shards ONE axis of its stacked ``(n,) + shape``
    array over ``dp``, the axis with the least relative zero-padding
    (ties to the lower axis, the stack axis first), or the stack axis
    alone with ``stack_axis_only`` (LAMB).  Each bucket is a dict:
    ``jidx``, ``shape``, ``dtype``, ``stacked_shape``, ``axis``,
    ``pad``, ``padded_shape``, ``rows`` (extent a device),
    ``param_bytes`` and ``padded_bytes``."""
    if dp < 1:
        raise MXNetError(f"plan_zero_buckets needs dp >= 1, got {dp}")
    by_sig: Dict[Tuple, List[int]] = {}
    for j, (shape, dt) in enumerate(sigs):
        by_sig.setdefault((tuple(shape), str(dt)), []).append(j)
    buckets = []
    for (shape, dt), js in by_sig.items():
        stacked_shape = (len(js),) + shape
        best = None
        cands = [0] if stack_axis_only else range(len(stacked_shape))
        for ax in cands:
            size = stacked_shape[ax]
            pad = (-size) % dp
            key = (pad / size, ax)
            if best is None or key < best[0]:
                best = (key, ax, pad)
        _, axis, pad = best
        padded = list(stacked_shape)
        padded[axis] += pad
        itemsize = _itemsize(dt)
        buckets.append({
            "jidx": js, "shape": shape, "dtype": dt,
            "stacked_shape": stacked_shape, "axis": axis, "pad": pad,
            "padded_shape": tuple(padded),
            "rows": padded[axis] // dp,
            "param_bytes": int(np.prod(stacked_shape, dtype=np.int64))
            * itemsize,
            "padded_bytes": int(np.prod(padded, dtype=np.int64))
            * itemsize,
        })
    return buckets


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
        if cache is not None:
            # the step runs eagerly: there is no compiled program of the
            # step to store until the step is captured as one graph
            raise NotImplementedError(
                "TrainStep: the persistent executable cache (cache) is "
                "not ported yet: the port's step is eager, so it has no "
                "compiled program to store until the captured step "
                "(ROADMAP 2b (a)) exists")
        self.device = resolve_device(device)
        self.net = net.to(self.device)
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.compute_dtype = _as_dtype(compute_dtype)
        self.cast_batch = cast_batch
        self.amp = _amp.resolve(amp)
        if self.amp and self.compute_dtype is not None:
            raise MXNetError(
                "amp and compute_dtype are two mixed-precision recipes — "
                "pass one (amp supersedes compute_dtype)")
        # the loss scaler: (enabled, initial scale, grow window); its
        # state, 0-d tensors on the device, from the first step
        self._amp_scaler, self._amp_init_scale, self._amp_window = \
            _amp.scaler_config() if self.amp else (False, 0.0, 1)
        self._amp_state = None
        self._t = 0
        self._opt_init, self._opt_update = opt_rule(optimizer)
        self._no_master = optimizer.multi_precision is False
        self._params: Optional[List[nn.Parameter]] = None
        if not self._deferred():
            self._setup()

    # -- parameters ------------------------------------------------------
    def _deferred(self) -> bool:
        return isinstance(self.net, Block) and any(
            p._tensor() is None for p in self.net.collect_params().values())

    def _setup(self, x=None) -> None:
        """Collect the trainable parameters (a Block's from
        ``collect_params()`` in mxtpu's order, ``grad_req="null"`` ones
        left out; another module's ``named_parameters()`` that require
        grad) and build the buckets.  Parameters still waiting for a
        shape get it from one forward of ``x`` first, in predict mode
        and without grad, as mxtpu's step does."""
        if x is not None and self._deferred():
            with torch.no_grad(), autograd.pause():
                self.net(x)
        if self._deferred():
            raise MXNetError(
                "TrainStep: the model has parameters whose shape is not "
                "known yet; run a step (or a forward) first")
        if isinstance(self.net, Block):
            gparams = [p for p in self.net.collect_params().values()
                       if p.grad_req != "null"]
            self.param_names = [p.name for p in gparams]
            self._params = [p._tensor() for p in gparams]
            self._mults = gparams
        else:
            named = [(n, p) for n, p in self.net.named_parameters()
                     if p.requires_grad]
            self.param_names = [n for n, _ in named]
            self._params = [p for _, p in named]
            self._mults = self._params
        # torch's dotted names of the trainable tensors, for the
        # compute-dtype substitution; and of the frozen float ones that
        # take the compute type too (mxtpu casts every float parameter
        # but BatchNorm's running statistics)
        from ..symbol import _is_aux_name
        tnames = {id(t): n for n, t in self.net.named_parameters()}
        self._torch_names = [tnames[id(t)] for t in self._params]
        trained = {id(t) for t in self._params}
        if isinstance(self.net, Block):
            frozen = [(p.name, p._tensor())
                      for p in self.net.collect_params().values()]
        else:
            frozen = list(self.net.named_parameters())
        self._frozen_cast = [
            tnames[id(t)] for n, t in frozen
            if id(t) not in trained and id(t) in tnames and
            t.is_floating_point() and not _is_aux_name(n)]
        if self.amp:
            # stored bf16 from here on, over the f32 masters the
            # multi-precision rule seeds; aux-named ones stay f32
            from ..symbol import _is_aux_name
            for n, p in zip(self.param_names, self._params):
                if p.dtype == torch.float32 and not _is_aux_name(n):
                    p.data = p.data.to(torch.bfloat16)
        # buckets: lists of indices into _params, by (shape, dtype) in
        # order of first appearance, or one a parameter
        by_sig: Dict[Tuple, List[int]] = {}
        for j, p in enumerate(self._params):
            key = (tuple(p.shape), p.dtype) \
                if knobs.get("MXTPU_BATCHED_OPT") else j
            by_sig.setdefault(key, []).append(j)
        self._groups = list(by_sig.values())
        # per bucket: its stacked weights (None for a bucket of one) and
        # its state, stacked like them; per parameter: where its data
        # must lie
        self._stacks: List[Optional[torch.Tensor]] = []
        self._ptrs: List[int] = [0] * len(self._params)
        with torch.no_grad():
            for group in self._groups:
                self._stacks.append(self._pack(group)
                                    if len(group) > 1 else None)
            self._opt_state = [
                self._opt_init(self._params[g[0]].detach()
                               if w is None else w, stacked=w is not None)
                for g, w in zip(self._groups, self._stacks)]

    # -- buckets ---------------------------------------------------------
    def _pack(self, group: List[int]) -> torch.Tensor:
        """Stack the live parameters of ``group`` into one contiguous
        tensor and rebind each parameter to its slice."""
        w = torch.stack([self._params[j].detach() for j in group])
        for a, j in enumerate(group):
            self._params[j].data = w[a]
            self._ptrs[j] = self._params[j].data_ptr()
        return w

    def _repack_stale(self) -> None:
        """Re-pack every bucket a parameter of which no longer lies in
        its stack (the caller rebound ``p.data``), so the update never
        writes a stale copy."""
        for k, (group, w) in enumerate(zip(self._groups, self._stacks)):
            if w is None or all(self._params[j].data_ptr() == self._ptrs[j]
                                for j in group):
                continue
            for j in group:
                p = self._params[j]
                if p.shape != w.shape[1:] or p.dtype != w.dtype:
                    raise MXNetError(
                        f"TrainStep: parameter {self.param_names[j]} is "
                        f"now {tuple(p.shape)} {p.dtype}; it was "
                        f"{tuple(w.shape[1:])} {w.dtype} when the step "
                        f"was built")
            self._stacks[k] = self._pack(group)

    def _per_slice(self, vals: List[float], w: torch.Tensor):
        """A bucket's lr or wd: a Python float where its parameters
        share it, else an ``(n, 1, ..., 1)`` f32 tensor."""
        if all(v == vals[0] for v in vals):
            return vals[0]
        return torch.tensor(vals, dtype=torch.float32, device=w.device
                            ).reshape((-1,) + (1,) * (w.ndim - 1))

    def _apply(self, grads: List[torch.Tensor], lrs: List[float],
               wds: List[float]) -> None:
        """One in-place update of every bucket with the given per-
        parameter lr/wd."""
        self._repack_stale()
        for k, (group, w) in enumerate(zip(self._groups, self._stacks)):
            st = self._opt_state[k]
            if w is None:
                j = group[0]
                _, self._opt_state[k] = self._opt_update(
                    self._params[j].detach(), grads[j], st, lrs[j],
                    wds[j], inplace=True)
                continue
            g = torch.stack([grads[j] for j in group])
            lr = self._per_slice([lrs[j] for j in group], w)
            wd = self._per_slice([wds[j] for j in group], w)
            if self._no_master and _needs_master(w) and \
                    (isinstance(lr, torch.Tensor) or
                     isinstance(wd, torch.Tensor)):
                # a sub-f32 weight without a master: an f32 lr tensor
                # would promote the update to f32, so slice by slice
                for a, j in enumerate(group):
                    self._opt_update(w[a], g[a], tuple(s[a] for s in st),
                                     lrs[j], wds[j], inplace=True)
                continue
            _, self._opt_state[k] = self._opt_update(
                w, g, st, lr, wd, stacked=True, inplace=True)

    # -- one step ------------------------------------------------------
    def _batch(self, a, cast: bool) -> torch.Tensor:
        # an NDArray hands over its tensor (mxtpu takes ``arr.data``):
        # a batch already on the card is not copied through the host
        if isinstance(a, NDArray):
            a = a.data
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
            if self._params is None:
                self._setup(x)
            self.net.train()
            if self.amp:
                return self._amp_forward_backward(x, y)
            with autograd.train_mode():
                if self.compute_dtype is None:
                    pred = self.net(x)
                else:
                    cd = self.compute_dtype
                    cast = {n: (p.to(cd) if p.is_floating_point() else p)
                            for n, p in zip(self._torch_names,
                                            self._params)}
                    live = dict(self.net.named_parameters())
                    cast.update((n, live[n].detach().to(cd))
                                for n in self._frozen_cast)
                    pred = torch.func.functional_call(self.net, cast,
                                                      (x,))
                loss = self.loss_fn(pred, y).float().mean()
            grads = torch.autograd.grad(loss, self._params,
                                        allow_unused=True)
        # a parameter the forward did not use (type_embed without token
        # types) has a zero gradient, as under JAX's AD
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(self._params, grads)]

    def _amp_forward_backward(self, x, y):
        """The AMP half step: every float parameter upcast to f32 at the
        entry, the forward and the loss inside ``amp.autocast()``, the
        loss times the scale, the gradients unscaled in f32."""
        if self._amp_scaler and self._amp_state is None:
            self._amp_state = _amp.scaler_init(self._amp_init_scale,
                                               device=self.device)
        upcast = {n: p.float() for n, p in self.net.named_parameters()
                  if p.is_floating_point() and p.dtype != torch.float32}
        with autograd.train_mode(), _amp.autocast():
            pred = torch.func.functional_call(self.net, upcast, (x,)) \
                if upcast else self.net(x)
            loss = self.loss_fn(pred, y).float().mean()
        scaled = loss * self._amp_state[0] if self._amp_scaler else loss
        grads = torch.autograd.grad(scaled, self._params, allow_unused=True)
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 if g is None else g.float()
                 for p, g in zip(self._params, grads)]
        if self._amp_scaler:
            torch._foreach_div_(grads, self._amp_state[0])
        return loss.detach(), grads

    def _lrs_wds(self) -> Tuple[List[float], List[float]]:
        """Per-parameter (lr, wd) for this step: the Adam bias
        correction folded into the lr, ``lr_mult``/``wd_mult`` read live
        (a gluon Parameter's own attribute times the optimizer's entry
        for its mxtpu name), each rounded to f32 as the JAX step's
        vectors are."""
        opt = self.optimizer
        opt.num_update = self._t
        lr = _f32(opt.learning_rate * adam_bias_correction(opt, self._t))
        lrs, wds = [], []
        for n, p in zip(self.param_names, self._mults):
            lm = _f32(getattr(p, "lr_mult", 1.0) * opt.lr_mult.get(n, 1.0))
            wm = _f32(getattr(p, "wd_mult", 1.0) * opt.wd_mult.get(n, 1.0))
            lrs.append(_f32(lr * lm))
            wds.append(_f32(_f32(opt.wd) * wm))
        return lrs, wds

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor]) -> None:
        """The second half of a step: one optimizer update of every
        trainable parameter, written in place."""
        with torch.profiler.record_function("update"):
            self._t += 1
            self._apply_checked(grads, *self._lrs_wds())

    def _apply_checked(self, grads: List[torch.Tensor], lrs: List[float],
                       wds: List[float]) -> None:
        """:meth:`_apply`, and under the AMP loss scaler only for
        finite gradients (the flag read back, once), then the scaler's
        update."""
        if not self._amp_scaler:
            self._apply(grads, lrs, wds)
            return
        finite = _amp.all_finite(grads)
        if bool(finite):
            self._apply(grads, lrs, wds)
        self._amp_state = _amp.scaler_update(self._amp_state, finite,
                                             self._amp_window)

    def __call__(self, x, y) -> torch.Tensor:
        loss, grads = self.forward_backward(x, y)
        self.update(grads)
        return loss

    # -- bulked steps -----------------------------------------------------
    def run_steps(self, x, y, steps: int, reuse_batch: bool = False
                  ) -> torch.Tensor:
        """``steps`` optimizer steps in one call, with the JAX package's
        semantics: ``x``/``y`` hold ``steps`` microbatches stacked on
        the batch axis (leading dim ``steps * B``) or, with
        ``reuse_batch=True``, one batch stepped ``steps`` times.  The
        step count advances by ``steps`` first and lr/wd are sampled
        once for the call, so every step of it takes the last step's
        lr (Adam's bias correction and a scheduler's value included).
        Each step draws fresh dropout words and advances BatchNorm's
        running statistics, and under AMP threads the loss scaler from
        step to step.  Returns the ``(steps,)`` f32 losses on the
        device; nothing is read back to the host inside the loop but,
        under the AMP loss scaler, each step's finiteness flag, as the
        eager step reads it."""
        if steps <= 0:
            raise MXNetError("run_steps needs steps >= 1")
        with torch.profiler.record_function("run_steps"):
            xs = self._batch(x, self.cast_batch)
            ys = self._batch(y, False)
            if not reuse_batch:
                if xs.shape[0] % steps:
                    raise MXNetError(
                        f"leading dim {xs.shape[0]} not divisible into "
                        f"{steps} microbatches")
                xs = xs.reshape((steps, -1) + xs.shape[1:])
                if ys.ndim:
                    ys = ys.reshape((steps, -1) + ys.shape[1:])
            if self._params is None:
                self._setup(xs if reuse_batch else xs[0])
            self._t += steps
            lrs, wds = self._lrs_wds()
            losses = []
            for i in range(steps):
                xb, yb = (xs, ys) if reuse_batch else \
                    (xs[i], ys[i] if ys.ndim else ys)
                loss, grads = self.forward_backward(xb, yb)
                with torch.no_grad(), \
                        torch.profiler.record_function("update"):
                    self._apply_checked(grads, lrs, wds)
                # free the gradients before the next forward, as a
                # step's return does
                del grads
                losses.append(loss)
            return torch.stack(losses)

    # -- checkpoints ------------------------------------------------------
    def _canonical_state(self) -> List[Tuple[torch.Tensor, ...]]:
        """The optimizer state per parameter, in ``param_names`` order
        (a stacked bucket's leaves sliced; LAMB's ``t`` a scalar per
        parameter): the JAX package's canonical layout."""
        if self._params is None:
            self._setup()
        per_param: List[Tuple[torch.Tensor, ...]] = [()] * len(self._params)
        for group, w, st in zip(self._groups, self._stacks,
                                self._opt_state):
            for a, j in enumerate(group):
                per_param[j] = tuple(st) if w is None else \
                    tuple(leaf[a] for leaf in st)
        return per_param

    def save_states(self, fname: str) -> None:
        """Write the step count and the optimizer state, per parameter,
        as the JAX package's ``save_states`` does: a pickle of
        ``{"t": int, "opt_state": tuple of tuples of numpy arrays}``
        (bf16 leaves as f32: numpy has no bf16).  Either update path,
        and either package, loads it."""
        def host(t):
            t = t.detach()
            return (t.float() if _needs_master(t) else t).cpu().numpy()
        blob = {"t": self._t, "opt_state": tuple(
            tuple(host(leaf) for leaf in st)
            for st in self._canonical_state())}
        if self._amp_scaler and self._amp_state is not None:
            blob["amp"] = self.amp_stats()
            blob["amp"]["scale"] = blob["amp"].pop("loss_scale")
        with open(fname, "wb") as f:
            pickle.dump(blob, f)

    @torch.no_grad()
    def load_states(self, fname: str) -> None:
        """Restore a :meth:`save_states` file (of this package or the
        JAX package's): the step count, so bias correction and
        schedules resume where they stopped, and every state leaf,
        copied into this step's buckets in their own types."""
        with open(fname, "rb") as f:
            data = pickle.load(f)  # a checkpoint of the caller's own
        loaded = data["opt_state"]
        cur = self._canonical_state()
        if len(loaded) != len(cur):
            raise MXNetError(f"optimizer state structure mismatch: "
                             f"{len(loaded)} parameters, this step has "
                             f"{len(cur)}")
        for n, a, b in zip(self.param_names, loaded, cur):
            got = [tuple(np.shape(x)) for x in a]
            if got != [tuple(y.shape) for y in b]:
                raise MXNetError(
                    f"optimizer state structure mismatch at {n}: leaves "
                    f"{got}, this step's {[tuple(y.shape) for y in b]}")
        for a, b in zip(loaded, cur):
            for x, y in zip(a, b):
                x = np.asarray(x)
                if x.dtype.name == "bfloat16":   # the JAX package's bf16
                    x = x.astype(np.float32)
                y.copy_(torch.as_tensor(x))
        self._t = int(data["t"])
        if self._amp_scaler and "amp" in data:
            # the scale and its accounting resume (a file without them
            # keeps the fresh scaler)
            a = data["amp"]
            self._amp_state = (
                torch.tensor(a["scale"], dtype=torch.float32,
                             device=self.device),
                torch.tensor(a["good_steps"], dtype=torch.int32,
                             device=self.device),
                torch.tensor(a["skipped_steps"], dtype=torch.int32,
                             device=self.device))

    def amp_stats(self) -> Optional[Dict[str, Any]]:
        """The loss scaler's state on the host: ``{'loss_scale',
        'good_steps', 'skipped_steps'}`` (a read of three scalars).
        None when AMP is off; 1.0/0/0 when scaling is disabled
        (``MXTPU_AMP_LOSS_SCALE=0``) or before the first step."""
        if not self.amp:
            return None
        if not self._amp_scaler or self._amp_state is None:
            return {"loss_scale": 1.0, "good_steps": 0, "skipped_steps": 0}
        scale, good, skipped = (t.item() for t in self._amp_state)
        return {"loss_scale": float(scale), "good_steps": int(good),
                "skipped_steps": int(skipped)}

    # -- introspection ----------------------------------------------------
    def memory_summary(self) -> Dict[str, Any]:
        """Peak device memory since the last reset
        (``torch.cuda.max_memory_allocated``), with the bytes of the
        parameters and the optimizer state.  On the CPU the peak is not
        measured (None)."""
        if self._params is None:
            self._setup()
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


from . import moe  # noqa: E402,F401  (the Switch-MoE feed-forward)
