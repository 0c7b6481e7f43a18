"""Flash attention, forward and backward: CUDA ``csrc/flash_attention.cu``
(forward) and ``csrc/flash_attention_bwd.cu`` (dq and dk/dv), each
beside its plain PyTorch version and its launch counter.

Forward — replaces ``mxtpu/kernels/flash_attention.py:_fa_kernel``
(launched by ``_flash_forward``): blockwise attention with an online
softmax whose running max, normalizer and accumulator stay f32,
emitting O and the per-row logsumexp.  The TPU kernel carries those
across a sequential grid axis in VMEM scratch; on Hopper one CTA owns
a tile of query rows of one (batch, head) and loops over the kv tiles
itself.  Keys past the sequence end are masked inside the kernel, so
every length runs on the card without ``_padded_flash``'s pad-to-8.  A
head dim above ``MAX_HEAD_DIM`` raises on CUDA (the JAX package's
D > 512 reference fallback has no counterpart on the card).

Backward — replaces ``_fa_dq_kernel`` and ``_fa_dkv_kernel`` (launched
by ``_flash_backward``): p is recomputed from q, k and the saved lse,
``ds = p * (dp - delta) * scale`` with ``delta = rowsum(dO * O)`` taken
outside the kernels in f32, then dq (one CTA per query tile, kv loop
inside) and dk/dv (one CTA per kv tile, q loop inside): two kernels,
so neither needs atomics and both are deterministic.  All backward
math is f32, for bf16 inputs too; outputs take the input type.  On the
card the backward is always these kernels: the JAX package's ``auto``
mode (AD through the reference below T = 1024, a threshold measured
on a TPU) has no counterpart, and ``chip_smoke.py`` times AD through
the plain version beside the kernels.

Bounds on the H100.  Forward at the serving shape (b*16 heads, T = 128,
D = 64, f32): the bytes — 4*BH*T*D*4 at 3.35 TB/s outweigh the six
bf16 products of the f32 split, 6*4*BH*T*T*D flops at the tensor-core
rate.  Backward at the training shape (BH = 512, T = 128, D = 64): the
bytes of q, k, v, dO, dq, dk, dv, lse and delta, in bf16 and in f32
alike.  Every kernel runs on the tensor cores (wgmma, with TMA loads):
bf16 as ``fa_fwd_wgmma_kernel``, ``fa_bwd_dq_wgmma_kernel`` and
``fa_bwd_dkv_wgmma_kernel``; f32 as ``fa_fwd_f32_wgmma_kernel``,
``fa_bwd_dq_f32_wgmma_kernel`` and ``fa_bwd_dkv_f32_wgmma_kernel``,
each f32 operand split exactly into three bf16 parts, six part
products per product, with no TF32.  TMA needs a 16-byte row stride
and a 16-byte aligned base, so for a head dim off a multiple of 8 the
wrappers run the kernels on copies zero-padded along D and slice the
results back (zero columns change no score; the scale is passed as
given), and raise on a misaligned input.

Dispatch: CPU tensors take the plain version; CUDA tensors launch the
kernel or the call raises.
"""
from __future__ import annotations

import ctypes
import sys
from typing import Optional, Tuple

import torch

from ..base import MXNetError
from . import _build, bump, on_card, refuse_grad

__all__ = ["flash_attention", "flash_forward", "flash_forward_reference",
           "flash_backward", "flash_backward_reference",
           "attention_reference", "MAX_HEAD_DIM", "LAUNCHES",
           "DQ_LAUNCHES", "DKV_LAUNCHES"]

# launches of each kernel (kernels.launch_counts reads them)
LAUNCHES = 0
DQ_LAUNCHES = 0
DKV_LAUNCHES = 0
_SELF = sys.modules[__name__]

_NEG_INF = -1e30
MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _I, _I,
         _P]
_DQ_ARGS = [_P] * 7 + [_I, _I, _I, _I, ctypes.c_float, _I, _I, _I, _P]
_DKV_ARGS = [_P] * 8 + [_I, _I, _I, _I, ctypes.c_float, _I, _I, _I, _P]


def flash_forward_reference(q3, k3, v3, causal: bool, sm_scale: float,
                            delta: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch attention over (BH, T, D) with the kernel's
    conventions: f32 scores and softmax, p cast to the input type
    before p.v, key j visible to query i iff j <= i + delta when
    causal, rows with no visible key give O = 0 and lse = +1e30.
    Returns (O in q's type, lse f32 (BH, Tq))."""
    Tq, Tk = q3.shape[1], k3.shape[1]
    d = Tk - Tq if delta is None else delta
    s = torch.matmul(q3.float(), k3.float().transpose(1, 2)) * sm_scale
    if causal:
        row = torch.arange(Tq, device=q3.device)[:, None] + d
        col = torch.arange(Tk, device=q3.device)[None, :]
        s = torch.where(col <= row, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    p = (e / l).to(q3.dtype).float()
    o = torch.matmul(p, v3.float())
    masked = m == _NEG_INF
    o = torch.where(masked, torch.zeros_like(o), o)
    lse = torch.where(masked, torch.full_like(m, -_NEG_INF),
                      m + torch.log(l))
    return o.to(q3.dtype), lse.squeeze(-1)


def attention_reference(q, k, v, causal=False, sm_scale=None):
    """Plain attention on (B, H, T, D) — the counterpart of
    ``mxtpu.kernels.flash_attention.attention_reference``."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    scale = float(sm_scale) if sm_scale is not None else 1.0 / (D ** 0.5)
    o, _ = flash_forward_reference(q.reshape(B * H, Tq, D),
                                   k.reshape(B * H, Tk, D),
                                   v.reshape(B * H, Tk, D), causal, scale)
    return o.reshape(B, H, Tq, D)


def _check_qkv(q3, k3, v3, *more):
    """What the kernels take: q (BH, Tq, D), k/v (BH, Tk, D), plus any
    (BH, Tq, D) tensors in ``more``, all contiguous, float32 or
    bfloat16 alike, D within MAX_HEAD_DIM."""
    BH, Tq, D = q3.shape
    Tk = k3.shape[1]
    ts = (q3, k3, v3) + more
    if q3.dtype not in _DTYPES or any(t.dtype != q3.dtype for t in ts):
        raise MXNetError(f"flash_attention: inputs must share float32 or "
                         f"bfloat16, got {[t.dtype for t in ts]}")
    if D > MAX_HEAD_DIM:
        raise MXNetError(f"flash_attention: head dim {D} exceeds the "
                         f"kernel bound {MAX_HEAD_DIM}")
    if k3.shape != (BH, Tk, D) or v3.shape != (BH, Tk, D) or \
            any(t.shape != q3.shape for t in more):
        raise MXNetError(f"flash_attention: shapes "
                         f"{[tuple(t.shape) for t in ts]} do not match "
                         f"q {tuple(q3.shape)}")
    if not all(t.is_contiguous() for t in ts):
        raise MXNetError("flash_attention: inputs must be contiguous")


def _aligned(*tensors):
    """The kernels read through TMA, which needs 16-byte aligned base
    addresses; the wrappers raise rather than copy."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise MXNetError(f"flash_attention: {tensors[0].dtype} inputs must "
                         f"start on a 16-byte boundary")


def _pad_d(*tensors):
    """(BH, T, D) tensors zero-padded along D to a multiple of 8 (TMA's
    16-byte row stride in bf16; the f32 kernels take the same); as they
    are when D already is one."""
    D = tensors[0].shape[-1]
    if D % 8 == 0:
        return tensors
    pad = (0, 8 - D % 8)
    return tuple(torch.nn.functional.pad(t, pad) for t in tensors)


def flash_forward(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                  causal: bool, sm_scale: float,
                  delta: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(BH, T, D) → (O, lse): the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if not on_card(q3, k3, v3):
        return flash_forward_reference(q3, k3, v3, causal, sm_scale, delta)
    refuse_grad("flash_forward", q3, k3, v3)
    _check_qkv(q3, k3, v3)
    BH, Tq, D = q3.shape
    Tk = k3.shape[1]
    lse = torch.empty(BH, Tq, dtype=torch.float32, device=q3.device)
    if BH * Tq == 0:
        return torch.empty_like(q3), lse
    _aligned(q3, k3, v3)
    q3, k3, v3 = _pad_d(q3, k3, v3)
    o = torch.empty_like(q3)
    fn = _build.bind("flash_attention", "mxt_flash_attention_fwd", _ARGS)
    with torch.cuda.device(q3.device):
        err = fn(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), BH, Tq, Tk, q3.shape[2], float(sm_scale),
                 int(bool(causal)), Tk - Tq if delta is None else int(delta),
                 _DTYPES[q3.dtype], _build.stream_of(q3))
    _build.check(err, "flash_attention")
    bump(_SELF)
    if o.shape[2] != D:
        o = o[..., :D].contiguous()
    return o, lse


def flash_backward_reference(q3, k3, v3, do3, o3, lse, causal: bool,
                             sm_scale: float, delta: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Plain PyTorch backward over (BH, T, D) with the kernels'
    conventions (``_recompute_p``, ``_fa_dq_kernel``,
    ``_fa_dkv_kernel``): p = exp(s - lse) recomputed in f32 with the
    causal mask j <= i + delta, ds = p * (dp - rowsum(dO * O)) * scale,
    every product in f32; returns (dq, dk, dv) in the inputs' types."""
    Tq, Tk = q3.shape[1], k3.shape[1]
    d = Tk - Tq if delta is None else delta
    qf, kf, vf, dof = (t.float() for t in (q3, k3, v3, do3))
    s = torch.matmul(qf, kf.transpose(1, 2)) * sm_scale
    if causal:
        row = torch.arange(Tq, device=q3.device)[:, None] + d
        col = torch.arange(Tk, device=q3.device)[None, :]
        s = torch.where(col <= row, s, torch.full_like(s, _NEG_INF))
    p = torch.exp(s - lse.float()[..., None])
    dp = torch.matmul(dof, vf.transpose(1, 2))
    ds = p * (dp - _delta_rows(do3, o3)[..., None]) * sm_scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(1, 2), qf)
    dv = torch.matmul(p.transpose(1, 2), dof)
    return dq.to(q3.dtype), dk.to(k3.dtype), dv.to(v3.dtype)


def _delta_rows(do3, o3) -> torch.Tensor:
    # delta_i = rowsum(dO * O) in f32: the softmax Jacobian's diagonal
    # term, outside the kernels as in the reference (:440-441)
    return (do3.float() * o3.float()).sum(dim=-1)


def flash_backward(q3, k3, v3, do3, o3, lse, causal: bool,
                   sm_scale: float, delta: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of attention over (BH, T, D) from the forward's O
    and lse: the dq and dk/dv kernels on CUDA tensors, the plain
    version on CPU tensors."""
    if not on_card(q3, k3, v3, do3, o3, lse):
        return flash_backward_reference(q3, k3, v3, do3, o3, lse, causal,
                                        sm_scale, delta)
    _check_qkv(q3, k3, v3, do3, o3)
    BH, Tq, D = q3.shape
    Tk = k3.shape[1]
    if lse.shape != (BH, Tq) or lse.dtype != torch.float32:
        raise MXNetError(f"flash_backward: lse must be ({BH}, {Tq}) "
                         f"float32, got {tuple(lse.shape)} {lse.dtype}")
    lse = lse.contiguous()
    rows = _delta_rows(do3, o3)
    if BH * Tq == 0 or Tk == 0:
        return (torch.zeros_like(q3), torch.zeros_like(k3),
                torch.zeros_like(v3))
    _aligned(q3, k3, v3, do3)
    pq, pk, pv, pdo = _pad_d(q3, k3, v3, do3)
    dq = torch.empty_like(pq)
    dk = torch.empty_like(pk)
    dv = torch.empty_like(pv)
    d = Tk - Tq if delta is None else int(delta)
    tail = (float(sm_scale), int(bool(causal)), d, _DTYPES[q3.dtype],
            _build.stream_of(q3))
    fdq = _build.bind("flash_attention_bwd", "mxt_flash_attention_bwd_dq",
                      _DQ_ARGS)
    fdkv = _build.bind("flash_attention_bwd",
                       "mxt_flash_attention_bwd_dkv", _DKV_ARGS)
    with torch.cuda.device(q3.device):
        err = fdq(pq.data_ptr(), pk.data_ptr(), pv.data_ptr(),
                  pdo.data_ptr(), lse.data_ptr(), rows.data_ptr(),
                  dq.data_ptr(), BH, Tq, Tk, pq.shape[2], *tail)
        _build.check(err, "flash_backward dq")
        bump(_SELF, "DQ_LAUNCHES")
        err = fdkv(pq.data_ptr(), pk.data_ptr(), pv.data_ptr(),
                   pdo.data_ptr(), lse.data_ptr(), rows.data_ptr(),
                   dk.data_ptr(), dv.data_ptr(), BH, Tq, Tk, pq.shape[2],
                   *tail)
        _build.check(err, "flash_backward dk/dv")
        bump(_SELF, "DKV_LAUNCHES")
    if dk.shape[2] != D:
        dq, dk, dv = (t[..., :D].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward kernel, backward kernels; saves q, k, v, O and lse."""

    @staticmethod
    def forward(ctx, q3, k3, v3, causal, sm_scale):
        o, lse = flash_forward(q3, k3, v3, causal, sm_scale)
        ctx.save_for_backward(q3, k3, v3, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q3, k3, v3, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q3, k3, v3, do.contiguous(), o, lse,
                                    ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, sm_scale=None):
    """Fused attention with its gradient.  q: (B, H, Tq, D); k, v:
    (B, H, Tk, D)."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    scale = float(sm_scale) if sm_scale is not None else 1.0 / (D ** 0.5)
    o = _FlashAttention.apply(q.reshape(B * H, Tq, D),
                              k.reshape(B * H, Tk, D),
                              v.reshape(B * H, Tk, D), bool(causal), scale)
    return o.reshape(B, H, Tq, D)
