"""Flash attention forward: CUDA ``csrc/flash_attention.cu`` beside its
plain PyTorch version and its launch counter.

Replaces ``mxtpu/kernels/flash_attention.py:_fa_kernel`` (launched by
``_flash_forward``): blockwise attention with an online softmax whose
running max, normalizer and accumulator stay f32, emitting O and the
per-row logsumexp.  The TPU kernel carries those across a sequential
grid axis in VMEM scratch; on Hopper one CTA owns a tile of query rows
of one (batch, head) and loops over the kv tiles itself.  Keys past
the sequence end are masked inside the kernel, so every length runs
on the card without ``_padded_flash``'s pad-to-8.  A head dim above
``MAX_HEAD_DIM`` raises on CUDA (the JAX package's D > 512 reference
fallback has no counterpart on the card).

Bound on the H100 at the serving shape (b*16 heads, T = 128, D = 64,
f32): operations.  4*BH*T*T*D flops at the f32 CUDA-core rate (no TF32)
outweigh 4*BH*T*D*4 bytes at 3.35 TB/s.  The first version does its
products as scalar FMAs over shared-memory tiles.

Dispatch: CPU tensors take the plain version; CUDA tensors launch the
kernel or the call raises.
"""
from __future__ import annotations

import ctypes
import sys
from typing import Optional, Tuple

import torch

from ..base import MXNetError
from . import _build, bump, on_card

__all__ = ["flash_attention", "flash_forward", "flash_forward_reference",
           "attention_reference", "MAX_HEAD_DIM", "LAUNCHES"]

# launches of the kernel (kernels.launch_counts reads it)
LAUNCHES = 0
_SELF = sys.modules[__name__]

_NEG_INF = -1e30
MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_ARGS = [_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, _P]


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


def flash_forward(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                  causal: bool, sm_scale: float,
                  delta: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(BH, T, D) → (O, lse): the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if not on_card(q3, k3, v3):
        return flash_forward_reference(q3, k3, v3, causal, sm_scale, delta)
    BH, Tq, D = q3.shape
    Tk = k3.shape[1]
    if q3.dtype not in _DTYPES or k3.dtype != q3.dtype or \
            v3.dtype != q3.dtype:
        raise MXNetError(f"flash_attention: q/k/v must share float32 or "
                         f"bfloat16, got {q3.dtype}/{k3.dtype}/{v3.dtype}")
    if D > MAX_HEAD_DIM:
        raise MXNetError(f"flash_attention: head dim {D} exceeds the "
                         f"kernel bound {MAX_HEAD_DIM}")
    if k3.shape != (BH, Tk, D) or v3.shape != (BH, Tk, D):
        raise MXNetError(f"flash_attention: k/v shapes {tuple(k3.shape)}/"
                         f"{tuple(v3.shape)} do not match q "
                         f"{tuple(q3.shape)}")
    if not (q3.is_contiguous() and k3.is_contiguous()
            and v3.is_contiguous()):
        raise MXNetError("flash_attention: q/k/v must be contiguous")
    o = torch.empty_like(q3)
    lse = torch.empty(BH, Tq, dtype=torch.float32, device=q3.device)
    if BH * Tq == 0:
        return o, lse
    fn = _build.bind("flash_attention", "mxt_flash_attention_fwd", _ARGS)
    with torch.cuda.device(q3.device):
        err = fn(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), BH, Tq, Tk, D, float(sm_scale),
                 int(bool(causal)), Tk - Tq if delta is None else int(delta),
                 _DTYPES[q3.dtype], _build.stream_of(q3))
    _build.check(err, "flash_attention")
    bump(_SELF)
    return o, lse


def flash_attention(q, k, v, causal=False, sm_scale=None):
    """Fused attention.  q: (B, H, Tq, D); k, v: (B, H, Tk, D)."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    scale = float(sm_scale) if sm_scale is not None else 1.0 / (D ** 0.5)
    o, _ = flash_forward(q.reshape(B * H, Tq, D), k.reshape(B * H, Tk, D),
                         v.reshape(B * H, Tk, D), bool(causal), scale)
    return o.reshape(B, H, Tq, D)
