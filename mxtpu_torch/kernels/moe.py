"""Switch-MoE routing: the router's top-1 choice with ordered capacity
slots, the dispatch of tokens into expert slots and the gate-weighted
combine, forward and backward: ``csrc/moe.cu``.

* :func:`route` — f32 logits (T, E) and the capacity C to ``(probs,
  expert, gate_p, slot_of_token, token_of_slot, frac, mean_p)``: the
  softmax, its argmax (the first maximum wins), each token's slot
  ``e * C + rank`` where ``rank`` is its ORDERED position among the
  tokens routed to expert e before it (-1 past C), the inverse map
  ``token_of_slot`` (E * C, -1 for an empty slot), the gate probability,
  and the load-balancing loss's per-expert fraction and mean probability.
  The kernel is one thread block cluster that takes T in rounds, its
  CTAs' counts scanned in rank order through distributed shared memory;
  its sums run in one fixed order, so two calls give the same bits.
* :func:`dispatch` — ``expert_in[s] = x[token_of_slot[s]]`` (0 for an
  empty slot); :func:`dispatch_bwd` is the inverse gather ``dx[t] =
  d_expert_in[slot_of_token[t]]`` (0 for a dropped token).
* :func:`combine` — ``y[t] = cast(f32(expert_out[slot]) * gate_p[t])``
  (0 for a dropped token); :func:`combine_bwd` gives ``d_expert_out[s] =
  cast(gate_p[t] * f32(dy[t]))`` and ``d_gate_p[t]``, the f32 dot of
  ``expert_out[s]`` and ``dy[t]``.

:func:`route_tokens`, :func:`dispatch_tokens` and :func:`combine_tokens`
are ``torch.autograd.Function``s over them: the dispatch's and the
combine's backward are kernels; the router's is a (T, E) softmax
backward in torch ops (mxtpu has no kernel there either).  Each launch
counts one in its counter (``ROUTE_LAUNCHES``, ``DISPATCH_LAUNCHES``,
``DISPATCH_BWD_LAUNCHES``, ``COMBINE_LAUNCHES``,
``COMBINE_BWD_LAUNCHES``).

Replaces no Pallas kernel: mxtpu routes with dense one-hot einsums
(``mxtpu/parallel/moe.py:37-120``), a (T, E, C) layout that on this card
costs 172 GFLOP of f32 an einsum at bench's shape to compute a
permutation.  The gathers give the same bits on finite inputs.  The plain
versions (``*_reference``), torch ops repeating the kernels' arithmetic
in their order (the softmax's sum in expert order), run for CPU tensors;
a CUDA tensor launches the kernel or the call raises.
"""
from __future__ import annotations

import ctypes
import sys
from typing import Tuple

import torch

from ..base import MXNetError
from . import _build, bump, on_card, refuse_grad

__all__ = ["route", "dispatch", "dispatch_bwd", "combine", "combine_bwd",
           "route_reference", "dispatch_reference", "combine_reference",
           "combine_bwd_reference", "softmax_ordered", "route_tokens",
           "dispatch_tokens", "combine_tokens", "MAX_EXPERTS",
           "ROUTE_LAUNCHES", "DISPATCH_LAUNCHES", "DISPATCH_BWD_LAUNCHES",
           "COMBINE_LAUNCHES", "COMBINE_BWD_LAUNCHES"]

ROUTE_LAUNCHES = 0
DISPATCH_LAUNCHES = 0
DISPATCH_BWD_LAUNCHES = 0
COMBINE_LAUNCHES = 0
COMBINE_BWD_LAUNCHES = 0
_SELF = sys.modules[__name__]

MAX_EXPERTS = 128        # the route kernel's shared memory (csrc/moe.cu)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


# ----------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------
def softmax_ordered(logits: torch.Tensor) -> torch.Tensor:
    """``exp(x - max) / sum`` over the last axis with the sum taken in
    expert order, as the route kernel takes it (jax.nn.softmax's
    formula)."""
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    s = e[..., 0]
    for k in range(1, e.shape[-1]):
        s = s + e[..., k]
    return e / s[..., None]


def route_reference(logits: torch.Tensor, capacity: int):
    """The route kernel's outputs in torch ops: the rank of a token in
    its expert's queue is the cumsum over T of the one-hot choice, as
    mxtpu's ``switch_router`` counts it."""
    T, E = logits.shape
    probs = softmax_ordered(logits.float())
    expert = probs.argmax(-1)
    onehot = torch.nn.functional.one_hot(expert, E)
    pos = (torch.cumsum(onehot, 0) * onehot).sum(-1) - 1
    keep = pos < capacity
    slot = torch.where(keep, expert * capacity + pos, -1)
    token_of_slot = torch.full((E * capacity,), -1, dtype=torch.int64,
                               device=logits.device)
    tok = torch.arange(T, device=logits.device)
    token_of_slot[slot[keep]] = tok[keep]
    gate_p = probs.gather(1, expert[:, None])[:, 0]
    frac = onehot.sum(0).float() / T
    mean_p = probs.sum(0) / T
    i32 = torch.int32
    return (probs, expert.to(i32), gate_p, slot.to(i32),
            token_of_slot.to(i32), frac, mean_p)


def dispatch_reference(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` by ``index``, 0 where it is -1 (the dispatch and its
    backward alike)."""
    got = x[index.long().clamp_min(0)]
    return torch.where((index >= 0)[:, None], got, torch.zeros_like(got))


def combine_reference(expert_out: torch.Tensor, slot_of_token: torch.Tensor,
                      gate_p: torch.Tensor) -> torch.Tensor:
    got = expert_out[slot_of_token.long().clamp_min(0)].float() * \
        gate_p[:, None]
    got = torch.where((slot_of_token >= 0)[:, None], got,
                      torch.zeros_like(got))
    return got.to(expert_out.dtype)


def combine_bwd_reference(dy: torch.Tensor, expert_out: torch.Tensor,
                          token_of_slot: torch.Tensor,
                          gate_p: torch.Tensor) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
    T = dy.shape[0]
    full = (token_of_slot >= 0)[:, None]
    t = token_of_slot.long().clamp_min(0)
    dyf = dy[t].float()
    d_eo = torch.where(full, gate_p[t][:, None] * dyf,
                       torch.zeros_like(dyf)).to(expert_out.dtype)
    dots = (expert_out.float() * dyf).sum(-1)
    d_gate = torch.zeros(T, dtype=torch.float32, device=dy.device)
    d_gate[t[full[:, 0]]] = dots[full[:, 0]]
    return d_eo, d_gate


# ----------------------------------------------------------------------
# the kernels' wrappers (no graph: the autograd Functions call them)
# ----------------------------------------------------------------------
def _check_dtype(what: str, t: torch.Tensor) -> int:
    code = _CODES.get(t.dtype)
    if code is None:
        raise MXNetError(f"{what}: f32, bf16 or f16, got {t.dtype}")
    return code


def _check_index(what: str, idx: torch.Tensor, n: int) -> None:
    if idx.dtype != torch.int32 or idx.dim() != 1 or idx.shape[0] != n \
            or not idx.is_contiguous():
        raise MXNetError(f"{what}: index must be contiguous int32 ({n},), "
                         f"got {idx.dtype} {tuple(idx.shape)}")


def _call(symbol: str, argtypes, args, dev_tensor, counter: str) -> None:
    fn = _build.bind("moe", symbol, argtypes)
    with torch.cuda.device(dev_tensor.device):
        err = fn(*args, _build.stream_of(dev_tensor))
    _build.check(err, symbol)
    bump(_SELF, counter)


def route(logits: torch.Tensor, capacity: int):
    """The router on (T, E) f32 logits: ``(probs, expert, gate_p,
    slot_of_token, token_of_slot, frac, mean_p)``; the kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if logits.dim() != 2 or logits.dtype != torch.float32:
        raise MXNetError(f"moe route: logits must be f32 (T, E), got "
                         f"{logits.dtype} {tuple(logits.shape)}")
    T, E = logits.shape
    C = int(capacity)
    if T == 0 or not 1 <= E <= MAX_EXPERTS or C < 1:
        raise MXNetError(f"moe route: T {T}, E {E} (1..{MAX_EXPERTS}), "
                         f"capacity {C}")
    if not on_card(logits):
        return route_reference(logits, C)
    refuse_grad("moe route", logits, hint="call route_tokens")
    if T > (1 << 31) - 1024 or E * C > (1 << 31) - 1:
        raise MXNetError(f"moe route: T {T} x E {E} x C {C} past int32")
    logits = logits.contiguous()
    dev = logits.device
    f32, i32 = torch.float32, torch.int32
    probs = torch.empty(T, E, dtype=f32, device=dev)
    expert = torch.empty(T, dtype=i32, device=dev)
    gate_p = torch.empty(T, dtype=f32, device=dev)
    slot_of_token = torch.empty(T, dtype=i32, device=dev)
    token_of_slot = torch.empty(E * C, dtype=i32, device=dev)
    frac = torch.empty(E, dtype=f32, device=dev)
    mean_p = torch.empty(E, dtype=f32, device=dev)
    outs = (probs, expert, gate_p, slot_of_token, token_of_slot, frac,
            mean_p)
    _call("mxt_moe_route", [_P, _I, _I, _I] + [_P] * 8,
          [logits.data_ptr(), T, E, C] + [o.data_ptr() for o in outs],
          logits, "ROUTE_LAUNCHES")
    return outs


def _gather(symbol: str, counter: str, src: torch.Tensor,
            index: torch.Tensor) -> torch.Tensor:
    if src.dim() != 2 or not src.is_contiguous():
        raise MXNetError(f"{symbol}: rows must be a contiguous 2-D tensor, "
                         f"got {tuple(src.shape)}")
    _check_dtype(symbol, src)
    n = index.shape[0]
    _check_index(symbol, index, n)
    out = torch.empty(n, src.shape[1], dtype=src.dtype, device=src.device)
    if out.numel() == 0:
        return out
    _call(symbol, [_P, _P, _P, _L, _L, _P],
          [src.data_ptr(), index.data_ptr(), out.data_ptr(), n,
           src.shape[1] * src.element_size()], src, counter)
    return out


def dispatch(x: torch.Tensor, token_of_slot: torch.Tensor) -> torch.Tensor:
    """``(E * C, D)`` expert inputs: rows of ``x`` (T, D) by
    ``token_of_slot``, 0 for an empty slot."""
    if not on_card(x, token_of_slot):
        return dispatch_reference(x, token_of_slot)
    refuse_grad("moe dispatch", x, hint="call dispatch_tokens")
    return _gather("mxt_moe_dispatch", "DISPATCH_LAUNCHES", x, token_of_slot)


def dispatch_bwd(d_expert_in: torch.Tensor,
                 slot_of_token: torch.Tensor) -> torch.Tensor:
    """``(T, D)`` gradient of x: rows of ``d_expert_in`` by
    ``slot_of_token``, 0 for a dropped token."""
    if not on_card(d_expert_in, slot_of_token):
        return dispatch_reference(d_expert_in, slot_of_token)
    return _gather("mxt_moe_dispatch_bwd", "DISPATCH_BWD_LAUNCHES",
                   d_expert_in.contiguous(), slot_of_token)


def combine(expert_out: torch.Tensor, slot_of_token: torch.Tensor,
            gate_p: torch.Tensor) -> torch.Tensor:
    """``(T, D)`` output: each kept token's expert row times its gate
    probability in f32, cast to the rows' type."""
    if not on_card(expert_out, slot_of_token, gate_p):
        return combine_reference(expert_out, slot_of_token, gate_p)
    refuse_grad("moe combine", expert_out, gate_p, hint="call "
                "combine_tokens")
    code = _check_dtype("moe combine", expert_out)
    T = slot_of_token.shape[0]
    _check_index("moe combine", slot_of_token, T)
    if expert_out.dim() != 2 or gate_p.dtype != torch.float32 or \
            tuple(gate_p.shape) != (T,):
        raise MXNetError(f"moe combine: expert_out (E * C, D) and f32 "
                         f"gate_p ({T},), got {tuple(expert_out.shape)} "
                         f"and {gate_p.dtype} {tuple(gate_p.shape)}")
    expert_out, gate_p = expert_out.contiguous(), gate_p.contiguous()
    D = expert_out.shape[1]
    y = torch.empty(T, D, dtype=expert_out.dtype, device=expert_out.device)
    if y.numel() == 0:
        return y
    _call("mxt_moe_combine", [_P, _P, _P, _P, _L, _I, _I, _P],
          [expert_out.data_ptr(), slot_of_token.data_ptr(),
           gate_p.data_ptr(), y.data_ptr(), T, D, code], expert_out,
          "COMBINE_LAUNCHES")
    return y


def combine_bwd(dy: torch.Tensor, expert_out: torch.Tensor,
                token_of_slot: torch.Tensor, gate_p: torch.Tensor):
    """``(d_expert_out, d_gate_p)`` of :func:`combine`."""
    if not on_card(dy, expert_out, token_of_slot, gate_p):
        return combine_bwd_reference(dy.to(expert_out.dtype), expert_out,
                                     token_of_slot, gate_p)
    code = _check_dtype("moe combine_bwd", expert_out)
    dy = dy.to(expert_out.dtype).contiguous()
    expert_out, gate_p = expert_out.contiguous(), gate_p.contiguous()
    S, D = expert_out.shape
    _check_index("moe combine_bwd", token_of_slot, S)
    d_eo = torch.empty_like(expert_out)
    d_gate = torch.zeros(dy.shape[0], dtype=torch.float32, device=dy.device)
    if d_eo.numel() == 0:
        return d_eo, d_gate
    _call("mxt_moe_combine_bwd", [_P] * 6 + [_L, _I, _I, _P],
          [dy.data_ptr(), expert_out.data_ptr(), token_of_slot.data_ptr(),
           gate_p.data_ptr(), d_eo.data_ptr(), d_gate.data_ptr(), S, D,
           code], expert_out, "COMBINE_BWD_LAUNCHES")
    return d_eo, d_gate


# ----------------------------------------------------------------------
# the autograd Functions moe_ffn runs through
# ----------------------------------------------------------------------
class _Route(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, capacity):
        probs, expert, gate_p, sot, tos, frac, mean_p = route(logits,
                                                              capacity)
        ctx.save_for_backward(probs, expert)
        ctx.mark_non_differentiable(sot, tos, frac)
        return gate_p, mean_p, sot, tos, frac

    @staticmethod
    def backward(ctx, d_gate_p, d_mean_p, *_):
        # gate_p = sum(probs * onehot), mean_p = mean(probs, 0); then the
        # softmax's backward
        probs, expert = ctx.saved_tensors
        T = probs.shape[0]
        dprobs = torch.zeros_like(probs)
        if d_gate_p is not None:
            dprobs.scatter_(1, expert.long()[:, None], d_gate_p[:, None])
        if d_mean_p is not None:
            dprobs = dprobs + d_mean_p[None, :] / T
        dlogits = probs * (dprobs - (dprobs * probs).sum(-1, keepdim=True))
        return dlogits, None


class _Dispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, token_of_slot, slot_of_token):
        ctx.save_for_backward(slot_of_token)
        return dispatch(x.contiguous(), token_of_slot)

    @staticmethod
    def backward(ctx, d_expert_in):
        (slot_of_token,) = ctx.saved_tensors
        return dispatch_bwd(d_expert_in, slot_of_token), None, None


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, expert_out, slot_of_token, token_of_slot, gate_p):
        ctx.save_for_backward(expert_out, token_of_slot, gate_p)
        return combine(expert_out.contiguous(), slot_of_token, gate_p)

    @staticmethod
    def backward(ctx, dy):
        expert_out, token_of_slot, gate_p = ctx.saved_tensors
        d_eo, d_gate = combine_bwd(dy, expert_out, token_of_slot, gate_p)
        return d_eo, None, None, d_gate


def route_tokens(logits: torch.Tensor, capacity: int):
    """The router with its gradient: ``(gate_p, mean_p, slot_of_token,
    token_of_slot, frac)``; gate_p and mean_p carry the softmax's
    backward to the logits."""
    return _Route.apply(logits, int(capacity))


def dispatch_tokens(x: torch.Tensor, token_of_slot: torch.Tensor,
                    slot_of_token: torch.Tensor) -> torch.Tensor:
    """:func:`dispatch` with its gradient (:func:`dispatch_bwd`)."""
    return _Dispatch.apply(x, token_of_slot, slot_of_token)


def combine_tokens(expert_out: torch.Tensor, slot_of_token: torch.Tensor,
                   token_of_slot: torch.Tensor,
                   gate_p: torch.Tensor) -> torch.Tensor:
    """:func:`combine` with its gradient (:func:`combine_bwd`)."""
    return _Combine.apply(expert_out, slot_of_token, token_of_slot, gate_p)
