"""LayerNorm and the fused residual LayerNorm, forward and backward.

Four kernels, each beside its plain PyTorch version and its launch
counter:

* ``layer_norm_fwd`` — CUDA ``csrc/layer_norm.cu``; replaces
  ``mxtpu/kernels/layer_norm.py:_ln_fwd_kernel`` (``_pallas_ln_fwd``):
  ``ln_fwd_rows_kernel`` up to C = 8192, ``ln_fwd_wide_kernel`` past
  it (:func:`_ln_fwd_plan`).
* ``layer_norm_bwd`` — CUDA ``csrc/layer_norm_bwd.cu``; replaces
  ``_ln_bwd_kernel`` (``_pallas_ln_bwd``): ``ln_bwd_rows_kernel`` (up
  to C = 8192) or ``ln_bwd_wide_kernel`` (past it) writes dx and one
  partial dgamma/dbeta row per CTA of a persistent grid
  (:func:`_ln_bwd_plan`), ``ln_bwd_finalize_kernel`` sums them in a
  fixed order into gamma's type.
* ``fused_residual_ln_fwd`` — CUDA ``csrc/fused_residual_ln.cu``;
  replaces ``_frln_fwd_kernel`` (``_pallas_frln_fwd``):
  ``y = LN(res + dropout(h + bias))`` with the reference's threefry2x32
  dropout mask over the global linear element index;
  ``frln_fwd_rows_kernel`` up to C = 12288 (4096 on the scalar path),
  ``frln_fwd_wide_kernel`` past it (:func:`_frln_fwd_plan`).
* ``fused_residual_ln_bwd`` — CUDA ``csrc/fused_residual_ln_bwd.cu``;
  replaces ``_frln_bwd_kernel`` (``_pallas_frln_bwd``): recomputes the
  mask and ``u`` from h, bias and res (no saved activation);
  ``frln_bwd_rows_kernel`` (up to C = 4096) or ``frln_bwd_wide_kernel``
  (past it) writes dh, dres and one partial dgamma/dbeta/dbias row per
  CTA of a persistent grid (:func:`_frln_bwd_plan`),
  ``frln_bwd_finalize_kernel`` sums them in a fixed order into the
  parameters' types.

Bound on the H100 (rows = b*T, C = 1024): bytes.  Each is a row
reduction with an elementwise prologue and epilogue at ~10-20 flops per
element, far under the card's flop/byte balance, so the floor is
reading the inputs once and writing the outputs once at 3.35 TB/s.
LayerNorm, both directions, gives each row a group of 1-8 warps that
holds the row in registers (16-byte vector accesses where C and the
pointers allow) between its two shuffle reductions (the forward: the
mean, then the centred sum of squares, as mxtpu's kernel computes
them); the forward's grid gives each group one row, the backward's is
persistent, a few CTAs per SM.  Past C = 8192, which 8 warps' registers
hold, a CTA of 512 threads takes a row and reads it again from L2 for
each pass, for any C (mxtpu's kernels take C up to 131072).  The fused
epilogue's forward and backward are LayerNorm's, each thread also
drawing the dropout mask of its columns while its loads are in flight
(independent threefry chains); the forward holds the residual sum
``u`` in f32 registers, so every input byte is read once and ``u``
never reaches device memory.  Past the row
kernels' widths both directions take a CTA a row that reads the row
again from L2 for each pass and draws the mask once, keeping its keep
bits (C / 8 bytes) in a row of device memory a CTA: any C, as mxtpu's
lax reference takes.  Every backward writes one partial row of the parameter
gradients per CTA.
CUDA C++ rather than Triton: one build route (nvcc + ctypes) for every
kernel of the port.

The public ``layer_norm`` and ``fused_residual_layer_norm`` run through
``torch.autograd.Function``s (forward kernel, backward kernel); mean
and rstd are saved from the forward, and the epilogue's two key words
ride in ``ctx`` as Python ints.

Dispatch: CPU tensors take the plain version; CUDA tensors launch the
kernel or the call raises.
"""
from __future__ import annotations

import ctypes
import sys
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..base import MXNetError
from . import _build, aligned16, bump, on_card, refuse_grad, sm_count

__all__ = ["layer_norm", "layer_norm_fwd", "layer_norm_reference",
           "layer_norm_bwd", "layer_norm_bwd_reference",
           "fused_residual_layer_norm", "fused_residual_ln_fwd",
           "fused_residual_ln_reference", "fused_residual_ln_bwd",
           "fused_residual_ln_bwd_reference", "mask_bits", "keep_thresh",
           "LAUNCHES", "BWD_LAUNCHES", "FRLN_LAUNCHES",
           "FRLN_BWD_LAUNCHES"]

# launches of each kernel (kernels.launch_counts reads them)
LAUNCHES = 0
BWD_LAUNCHES = 0
FRLN_LAUNCHES = 0
FRLN_BWD_LAUNCHES = 0
_SELF = sys.modules[__name__]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the LayerNorm kernels (csrc/layer_norm.cu, csrc/layer_norm_bwd.cu): 8
# warps a CTA, and the row kernels' template instances (their
# LN_FWD_SHAPES and LN_SHAPES): (widest C, elements of a row a thread
# holds, warps a row), the fewest elements that keep 2 CTAs an SM in
# the backward (one warp a row at 32 elements, one CTA an SM, measured
# slower on the H100 at C = 1024); past the last C, the wide kernels
LN_BWD_WARPS = 8
LN_BWD_SHAPES = ((256, 8, 1), (512, 16, 1), (1024, 16, 2), (2048, 16, 4),
                 (4096, 16, 8), (8192, 32, 8))
LN_FWD_SHAPES = LN_BWD_SHAPES   # the same instances in both sources
# widest C the row kernels hold in registers; the wide kernels take any
# C past it, a CTA of LN_WIDE_THREADS a row
LN_ROWS_MAX_C = LN_BWD_SHAPES[-1][0]
LN_WIDE_THREADS = 512
# the fused epilogue (csrc/fused_residual_ln{,_bwd}.cu).  Its
# backward's row kernel instances (FRLN_SHAPES) hold three
# parameter-gradient accumulators besides the row, so fewer elements a
# thread than LayerNorm's; its forward's (FRLN_FWD_SHAPES) are the
# backward's, then LayerNorm's widest and one more, which takes every C
# up to 12288 (the one-CTA-a-row kernel it replaced took 12256) on the
# 16-byte path, and up to FRLN_FWD_SCALAR_MAX_C on the scalar one (past
# it a scalar row would hold one CTA an SM, slower than the wide
# kernel); past either, the wide kernels (a CTA of FRLN_WIDE_THREADS a
# row), any C: the forward's a persistent grid of as many CTAs as an
# SM's 2048 threads take, the backward's of one an SM.
# The wide kernels keep a row's keep bits, one uint32 word a warp, slot
# and element of an access, in a row of device memory a CTA
FRLN_BWD_SHAPES = ((256, 8, 1), (512, 8, 2), (1024, 8, 4), (2048, 8, 8),
                   (4096, 16, 8))
FRLN_FWD_SHAPES = FRLN_BWD_SHAPES + ((8192, 32, 8), (12288, 48, 8))
FRLN_FWD_SCALAR_MAX_C = FRLN_BWD_SHAPES[-1][0]
FRLN_ROWS_MAX_C = FRLN_BWD_SHAPES[-1][0]
FRLN_WIDE_THREADS = 512
FRLN_FWD_WIDE_CTAS_PER_SM = 2048 // FRLN_WIDE_THREADS
# largest grid of a launch (gridDim.x); the kernels stride past it
_MAX_GRID = (1 << 31) - 1

_P = ctypes.c_void_p
_LN_ARGS = [_P, _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_float] + [ctypes.c_int] * 5 + [_P]
_LN_BWD_ARGS = [_P] * 9 + [ctypes.c_longlong] + [ctypes.c_int] * 6 + [_P]
# the mask's arguments: use_mask, k0, k1, thresh, inv_keep
_MASK_ARGS = [ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32,
              ctypes.c_uint32, ctypes.c_float]
# h, bias, res, gamma, beta, y, mean, rstd, bits; R, C, eps, vec, ept,
# wpr, ctas; the mask; dtype, stream
_FRLN_ARGS = [_P] * 9 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float] \
    + [ctypes.c_int] * 4 + _MASK_ARGS + [ctypes.c_int, _P]
# h, bias, res, gamma, mean, rstd, dy, dh, dres, dgamma, dbeta, dbias,
# part, bits; R, C, vec, ept, wpr, ctas; the mask; dtype, stream
_FRLN_BWD_ARGS = [_P] * 14 + [ctypes.c_longlong] + [ctypes.c_int] * 5 \
    + _MASK_ARGS + [ctypes.c_int, _P]


def _check_rows(what: str, x2: torch.Tensor,
                vecs: Sequence[torch.Tensor], rows=()) -> None:
    """What the kernels take: contiguous (R, C) f32/bf16 rows (``x2``
    and ``rows``) and contiguous (C,) vectors of the same type."""
    if x2.dtype not in _DTYPES:
        raise MXNetError(f"{what}: dtype {x2.dtype} not supported "
                         f"(float32, bfloat16)")
    C = x2.shape[-1]
    for t in (x2, *rows):
        if t.shape != x2.shape or t.dtype != x2.dtype or \
                not t.is_contiguous():
            raise MXNetError(f"{what}: row inputs must be contiguous "
                             f"{tuple(x2.shape)} {x2.dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for v in vecs:
        if v.shape != (C,) or v.dtype != x2.dtype or \
                not v.is_contiguous():
            raise MXNetError(
                f"{what}: parameter vectors must be contiguous ({C},) "
                f"{x2.dtype}, got {tuple(v.shape)} {v.dtype}")


# ----------------------------------------------------------------------
# LayerNorm
# ----------------------------------------------------------------------

def layer_norm_reference(x, gamma, beta, eps=1e-5):
    """Plain PyTorch LayerNorm over the last axis with f32 statistics;
    returns (y in x's type, mean, rstd) — the kernel's outputs."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rstd = 1.0 / torch.sqrt(var + eps)
    y = xc * rstd * gamma.float() + beta.float()
    return y.to(x.dtype), mean.squeeze(-1), rstd.squeeze(-1)


class LnPlan(NamedTuple):
    """The launch of a LayerNorm kernel: ``vec`` elements per access
    (16 bytes' worth, or 1), ``ept`` elements of a row per thread and
    ``wpr`` warps per row of the row kernel (both 0: the wide kernel, a
    CTA a row), ``ctas`` CTAs in the grid (in the backward, also its
    partial rows)."""
    vec: int
    ept: int
    wpr: int
    ctas: int

    @property
    def wide(self) -> bool:
        return self.ept == 0


def _vec(C: int, itemsize: int, aligned: bool) -> int:
    """16 bytes' worth of elements per access where C is a multiple of
    it and every pointer is 16-byte aligned, else 1."""
    v = 16 // itemsize
    return v if aligned and C % v == 0 else 1


def _fwd_rows_plan(R: int, C: int, vec: int, shapes) -> LnPlan:
    """A forward row kernel's launch (LayerNorm's or the fused
    epilogue's): the first instance of ``shapes`` that takes C, a grid
    that gives each row group of a CTA one row, capped at ``_MAX_GRID``
    CTAs (the kernels stride past it)."""
    _, ept, wpr = next(s for s in shapes if C <= s[0])
    groups = LN_BWD_WARPS // wpr
    return LnPlan(vec, ept, wpr, min(-(-R // groups), _MAX_GRID))


def _ln_fwd_plan(R: int, C: int, itemsize: int, aligned: bool) -> LnPlan:
    """Launch geometry of the LayerNorm forward for (R, C) rows: the row
    kernel's (:func:`_fwd_rows_plan` of ``LN_FWD_SHAPES``); past
    ``LN_ROWS_MAX_C``, the wide kernel, a CTA a row."""
    if C < 1 or R < 1:
        raise MXNetError(f"layer_norm: no launch for ({R}, {C})")
    vec = _vec(C, itemsize, aligned)
    if C > LN_ROWS_MAX_C:
        return LnPlan(vec, 0, 0, min(R, _MAX_GRID))
    return _fwd_rows_plan(R, C, vec, LN_FWD_SHAPES)


def layer_norm_fwd(x2: torch.Tensor, gamma: torch.Tensor,
                   beta: torch.Tensor, eps: float = 1e-5
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(R, C) rows → (y, mean, rstd): the kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if not on_card(x2, gamma, beta):
        return layer_norm_reference(x2, gamma, beta, eps)
    refuse_grad("layer_norm_fwd", x2, gamma, beta)
    _check_rows("layer_norm", x2, (gamma, beta))
    R, C = x2.shape
    y = torch.empty_like(x2)
    mean = torch.empty(R, dtype=torch.float32, device=x2.device)
    rstd = torch.empty(R, dtype=torch.float32, device=x2.device)
    if R == 0:
        return y, mean, rstd
    plan = _ln_fwd_plan(R, C, x2.element_size(),
                        aligned16(x2, gamma, beta, y))
    fn = _build.bind("layer_norm", "mxt_layer_norm_fwd", _LN_ARGS)
    with torch.cuda.device(x2.device):
        err = fn(x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                 y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), R, C,
                 float(eps), plan.vec, plan.ept, plan.wpr, plan.ctas,
                 _DTYPES[x2.dtype], _build.stream_of(x2))
    _build.check(err, "layer_norm")
    bump(_SELF)
    return y, mean, rstd


def _stats(t: torch.Tensor, R: int) -> torch.Tensor:
    if t.shape != (R,) or t.dtype != torch.float32:
        raise MXNetError(f"mean/rstd must be ({R},) float32, got "
                         f"{tuple(t.shape)} {t.dtype}")
    return t.contiguous()


def layer_norm_bwd_reference(x2, gamma, mean, rstd, dy2):
    """Plain PyTorch backward of :func:`layer_norm_reference` from its
    f32 statistics, as ``_ln_bwd_kernel`` computes it; returns (dx in
    x's type, dgamma, dbeta in gamma's type)."""
    xhat = (x2.float() - mean[:, None]) * rstd[:, None]
    dy = dy2.float()
    dyg = dy * gamma.float()
    c1 = dyg.mean(dim=-1, keepdim=True)
    c2 = (dyg * xhat).mean(dim=-1, keepdim=True)
    dx = rstd[:, None] * (dyg - c1 - xhat * c2)
    return (dx.to(x2.dtype), (dy * xhat).sum(0).to(gamma.dtype),
            dy.sum(0).to(gamma.dtype))


def _ln_min_blocks(ept: int, itemsize: int, vec: int) -> int:
    """CTAs per SM the kernel's launch bounds are set for (its
    ``ln_min_blocks``): from the registers a thread's two accumulators,
    its raw x, dy and gamma (a register each on the scalar path) and
    the scalar path's offsets take."""
    eb = itemsize if vec > 1 else 4
    regs = 2 * ept + 3 * ept * eb // 4 + (0 if vec > 1 else ept) + 24
    return 2 if regs <= 112 else 1


def _ln_bwd_plan(R: int, C: int, itemsize: int, aligned: bool,
                 sms: int) -> LnPlan:
    """Launch geometry of the LayerNorm backward for (R, C) rows: vector
    accesses only where C is a multiple of 16 bytes' worth and every
    pointer is 16-byte aligned; the first of ``LN_BWD_SHAPES`` that
    takes C; a persistent grid of as many CTAs as the SMs hold at once,
    never more than the rows need.  Past ``LN_ROWS_MAX_C``, the wide
    kernel: one CTA an SM, never more than the rows (each CTA's partial
    row is C floats of scratch)."""
    if C < 1 or R < 1:
        raise MXNetError(f"layer_norm_bwd: no launch for ({R}, {C})")
    vec = _vec(C, itemsize, aligned)
    if C > LN_ROWS_MAX_C:
        return LnPlan(vec, 0, 0, min(R, sms))
    _, ept, wpr = next(s for s in LN_BWD_SHAPES if C <= s[0])
    groups = LN_BWD_WARPS // wpr
    ctas = max(1, min(-(-R // groups),
                      sms * _ln_min_blocks(ept, itemsize, vec)))
    return LnPlan(vec, ept, wpr, ctas)


def layer_norm_bwd(x2, gamma, mean, rstd, dy2):
    """(R, C) rows → (dx, dgamma, dbeta): the kernels on CUDA tensors,
    the plain version on CPU tensors."""
    if not on_card(x2, gamma, mean, rstd, dy2):
        return layer_norm_bwd_reference(x2, gamma, mean, rstd, dy2)
    _check_rows("layer_norm_bwd", x2, (gamma,), (dy2,))
    R, C = x2.shape
    mean, rstd = _stats(mean, R), _stats(rstd, R)
    dx = torch.empty_like(x2)
    if R == 0:
        return dx, torch.zeros_like(gamma), torch.zeros_like(gamma)
    plan = _ln_bwd_plan(R, C, x2.element_size(),
                        aligned16(x2, dy2, gamma, dx), sm_count(x2.device))
    parts = torch.empty(2, plan.ctas, C, dtype=torch.float32,
                        device=x2.device)
    dg, db = torch.empty_like(gamma), torch.empty_like(gamma)
    fn = _build.bind("layer_norm_bwd", "mxt_layer_norm_bwd", _LN_BWD_ARGS)
    with torch.cuda.device(x2.device):
        err = fn(x2.data_ptr(), gamma.data_ptr(), mean.data_ptr(),
                 rstd.data_ptr(), dy2.data_ptr(), dx.data_ptr(),
                 dg.data_ptr(), db.data_ptr(), parts.data_ptr(), R, C,
                 plan.vec, plan.ept, plan.wpr, plan.ctas,
                 _DTYPES[x2.dtype], _build.stream_of(x2))
    _build.check(err, "layer_norm_bwd")
    bump(_SELF, "BWD_LAUNCHES")
    return dx, dg, db


class _LayerNorm(torch.autograd.Function):
    """Forward kernel, backward kernel; mean and rstd are saved and
    returned as non-differentiable outputs."""

    @staticmethod
    def forward(ctx, x2, gamma, beta, eps):
        y, mean, rstd = layer_norm_fwd(x2, gamma, beta, eps)
        ctx.save_for_backward(x2, gamma, mean, rstd)
        ctx.mark_non_differentiable(mean, rstd)
        return y, mean, rstd

    @staticmethod
    def backward(ctx, dy, _dmean, _drstd):
        x2, gamma, mean, rstd = ctx.saved_tensors
        dx, dg, db = layer_norm_bwd(x2, gamma, mean, rstd, dy.contiguous())
        return dx, dg, db, None


def layer_norm(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis of any-rank ``x``, with its
    gradient."""
    C = x.shape[-1]
    y, _, _ = _LayerNorm.apply(x.reshape(-1, C), gamma.reshape(-1),
                               beta.reshape(-1), float(eps))
    return y.reshape(x.shape)


# ----------------------------------------------------------------------
# fused residual epilogue: y = LN(res + dropout(h + bias))
# ----------------------------------------------------------------------
_M32 = 0xFFFFFFFF
_THREEFRY_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0: int, k1: int, x0: torch.Tensor,
                  x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """20-round threefry2x32 on int64 tensors holding uint32 values
    (every sum is masked back to 32 bits)."""
    ks = (k0, k1, _THREEFRY_PARITY ^ k0 ^ k1)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for grp in range(5):
        for rot in _ROTATIONS[grp % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << rot) & _M32) | (x1 >> (32 - rot))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(grp + 1) % 3]) & _M32
        x1 = (x1 + ks[(grp + 2) % 3] + grp + 1) & _M32
    return x0, x1


def mask_bits(k0: int, k1: int, row0: int, n_rows: int, n_cols: int,
              device=None) -> torch.Tensor:
    """uint32 dropout bits (as int64) for rows [row0, row0 + n_rows) of
    an (R, n_cols) mask; counter = global linear element index, as
    ``mxtpu/kernels/layer_norm.py:_mask_bits``."""
    r = torch.arange(n_rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(n_cols, dtype=torch.int64, device=device)[None, :]
    ctr = (((row0 + r) & _M32) * n_cols + c) & _M32
    bits, _ = _threefry2x32(k0, k1, ctr, torch.zeros_like(ctr))
    return bits


def keep_thresh(keep: float) -> int:
    # P(bits < thresh) == keep for bits ~ U[0, 2^32)
    return min((1 << 32) - 1, int(round(keep * (1 << 32))))


def _key_words(key_data) -> Tuple[int, int]:
    if isinstance(key_data, torch.Tensor):
        key_data = key_data.cpu().numpy()
    words = np.asarray(key_data).reshape(-1).astype(np.uint32)
    if words.size != 2:
        raise MXNetError(f"key_data must hold two uint32 words, got "
                         f"{words.size}")
    return int(words[0]), int(words[1])


def _keep(p: float, training: bool) -> float:
    return 1.0 if (not training or p <= 0.0) else float(1.0 - p)


def _words(key_data, n: int, keep: float) -> Tuple[int, int]:
    """The two key words for a dropout mask over ``n`` elements ((0, 0)
    when ``keep`` is 1); raises where the uint32 element counter would
    wrap."""
    if keep >= 1.0:
        return 0, 0
    if n >= (1 << 32):
        raise MXNetError("fused_residual_layer_norm: the dropout "
                         "counter would wrap at 2^32 elements")
    return _key_words(key_data)


def _keep_mask(key_data, h: torch.Tensor, keep: float) -> torch.Tensor:
    """Boolean keep mask of ``h``'s shape: threefry bits of the global
    linear element index below round(keep * 2^32)."""
    k0, k1 = _words(key_data, h.numel(), keep)
    C = h.shape[-1]
    bits = mask_bits(k0, k1, 0, h.numel() // C, C, device=h.device)
    return (bits < keep_thresh(keep)).reshape(h.shape)


def _inv_keep(keep: float) -> float:
    # 1/keep as the f32 constant the kernels multiply by
    return float(np.float32(1.0 / keep))


def fused_residual_ln_reference(h, bias, res, gamma, beta, key_data=None,
                                p=0.1, eps=1e-5, training=True):
    """Plain PyTorch version of the epilogue with the same threefry
    mask as the kernel; returns (y in h's type, mean, rstd)."""
    hb = h.float() + bias.float().reshape(-1)
    keep = _keep(p, training)
    if keep < 1.0:
        mask = _keep_mask(key_data, h, keep)
        hb = torch.where(mask, hb * _inv_keep(keep), torch.zeros_like(hb))
    y, mean, rstd = layer_norm_reference(res.float() + hb, gamma, beta, eps)
    return y.to(h.dtype), mean, rstd


def _frln_words(C: int, vec: int) -> int:
    """uint32 words of a row's keep bits in the wide kernels: ``vec``
    words (one an element of an access) for each warp and each slot of
    ``FRLN_WIDE_THREADS * vec`` columns, a lane's bit in each."""
    slots = -(-C // (FRLN_WIDE_THREADS * vec))
    return slots * (FRLN_WIDE_THREADS // 32) * vec


def _mask_scratch(plan, C: int, keep: float,
                  device) -> Optional[torch.Tensor]:
    """Device memory for a wide kernel's keep bits ([ctas][words]
    uint32 as int32); None where the plan is a row kernel's or there is
    no mask."""
    if not plan.wide or keep >= 1.0:
        return None
    return torch.empty(plan.ctas, _frln_words(C, plan.vec),
                       dtype=torch.int32, device=device)


def _frln_fwd_plan(R: int, C: int, itemsize: int, aligned: bool,
                   sms: int) -> LnPlan:
    """Launch geometry of the fused epilogue's forward for (R, C) rows:
    16-byte accesses where C and every pointer allow; up to the last C
    of ``FRLN_FWD_SHAPES`` (``FRLN_FWD_SCALAR_MAX_C`` on the scalar
    path) its row kernel (:func:`_fwd_rows_plan`); past it the wide
    kernel, a persistent grid of ``FRLN_FWD_WIDE_CTAS_PER_SM`` CTAs an
    SM, never more than the rows."""
    if C < 1 or R < 1:
        raise MXNetError(f"fused_residual_layer_norm: no launch for "
                         f"({R}, {C})")
    vec = _vec(C, itemsize, aligned)
    if C > (FRLN_FWD_SHAPES[-1][0] if vec > 1 else FRLN_FWD_SCALAR_MAX_C):
        return LnPlan(vec, 0, 0, min(R, FRLN_FWD_WIDE_CTAS_PER_SM * sms))
    return _fwd_rows_plan(R, C, vec, FRLN_FWD_SHAPES)


def fused_residual_ln_fwd(h2, bias, res2, gamma, beta, key_data=None,
                          p=0.1, eps=1e-5, training=True):
    """(R, C) rows → (y, mean, rstd): the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if not on_card(h2, bias, res2, gamma, beta):
        return fused_residual_ln_reference(h2, bias, res2, gamma, beta,
                                           key_data, p, eps, training)
    refuse_grad("fused_residual_ln_fwd", h2, bias, res2, gamma, beta)
    _check_rows("fused_residual_layer_norm", h2, (bias, gamma, beta),
                (res2,))
    R, C = h2.shape
    keep = _keep(p, training)
    k0, k1 = _words(key_data, R * C, keep)
    y = torch.empty_like(h2)
    mean = torch.empty(R, dtype=torch.float32, device=h2.device)
    rstd = torch.empty(R, dtype=torch.float32, device=h2.device)
    if R == 0:
        return y, mean, rstd
    plan = _frln_fwd_plan(R, C, h2.element_size(),
                          aligned16(h2, bias, res2, gamma, beta, y),
                          sm_count(h2.device))
    bits = _mask_scratch(plan, C, keep, h2.device)
    bits_ptr = None if bits is None else bits.data_ptr()
    fn = _build.bind("fused_residual_ln", "mxt_fused_residual_ln_fwd",
                     _FRLN_ARGS)
    with torch.cuda.device(h2.device):
        err = fn(h2.data_ptr(), bias.data_ptr(), res2.data_ptr(),
                 gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
                 mean.data_ptr(), rstd.data_ptr(), bits_ptr, R, C,
                 float(eps), plan.vec, plan.ept, plan.wpr, plan.ctas,
                 int(keep < 1.0), k0, k1, keep_thresh(keep),
                 _inv_keep(keep), _DTYPES[h2.dtype], _build.stream_of(h2))
    _build.check(err, "fused_residual_layer_norm")
    bump(_SELF, "FRLN_LAUNCHES")
    return y, mean, rstd


def fused_residual_ln_bwd_reference(h2, bias, res2, gamma, key_words,
                                    mean, rstd, dy2, keep):
    """Plain PyTorch backward of the epilogue as ``_frln_bwd_kernel``
    computes it: the mask and u recomputed from the key words, then
    du as LayerNorm's dx, dh = du/keep where kept (else 0), dres = du,
    dbias = sum dh.  Returns (dh, dbias, dres, dgamma, dbeta)."""
    hb = h2.float() + bias.float()
    mask = None
    if keep < 1.0:
        mask = _keep_mask(key_words, h2, keep)
        hb = torch.where(mask, hb * _inv_keep(keep), torch.zeros_like(hb))
    u = res2.float() + hb
    du, dg, db = layer_norm_bwd_reference(u, gamma, mean, rstd, dy2)
    dh = du if mask is None else \
        torch.where(mask, du * _inv_keep(keep), torch.zeros_like(du))
    return (dh.to(h2.dtype), dh.sum(0).to(bias.dtype), du.to(res2.dtype),
            dg, db)


def _frln_min_blocks(ept: int, itemsize: int, vec: int) -> int:
    """CTAs per SM the fused backward's launch bounds are set for (its
    ``frln_min_blocks``): from the registers of a thread's three
    accumulators, its row's xhat and dy * gamma, its raw h, res and dy
    (a register each on the scalar path), the scalar path's offsets and
    the threefry chains."""
    eb = itemsize if vec > 1 else 4
    regs = 5 * ept + 3 * ept * eb // 4 + (0 if vec > 1 else ept) + 32
    return 2 if regs <= 128 else 1


def _frln_bwd_plan(R: int, C: int, itemsize: int, aligned: bool,
                   sms: int) -> LnPlan:
    """Launch geometry of the fused epilogue's backward for (R, C) rows,
    as :func:`_ln_bwd_plan`'s with ``FRLN_BWD_SHAPES``: vector accesses
    only where C is a multiple of 16 bytes' worth and every pointer is
    16-byte aligned; the first instance that takes C; a persistent grid
    of as many CTAs as the SMs hold at once, never more than the rows
    need.  Past ``FRLN_ROWS_MAX_C``, the wide kernel: one CTA an SM,
    never more than the rows."""
    if C < 1 or R < 1:
        raise MXNetError(f"fused_residual_ln_bwd: no launch for ({R}, {C})")
    vec = _vec(C, itemsize, aligned)
    if C > FRLN_ROWS_MAX_C:
        return LnPlan(vec, 0, 0, min(R, sms))
    _, ept, wpr = next(s for s in FRLN_BWD_SHAPES if C <= s[0])
    groups = LN_BWD_WARPS // wpr
    ctas = max(1, min(-(-R // groups),
                      sms * _frln_min_blocks(ept, itemsize, vec)))
    return LnPlan(vec, ept, wpr, ctas)


def fused_residual_ln_bwd(h2, bias, res2, gamma, key_words, mean, rstd,
                          dy2, keep):
    """(R, C) rows → (dh, dbias, dres, dgamma, dbeta): the kernels on
    CUDA tensors (the parameter gradients in their own types, from the
    finalize kernel), the plain version on CPU tensors.  ``keep`` is
    1 - p (1.0: no mask); ``key_words`` the forward's two uint32
    words."""
    if not on_card(h2, bias, res2, gamma, mean, rstd, dy2):
        return fused_residual_ln_bwd_reference(
            h2, bias, res2, gamma, key_words, mean, rstd, dy2, keep)
    _check_rows("fused_residual_ln_bwd", h2, (bias, gamma), (res2, dy2))
    R, C = h2.shape
    mean, rstd = _stats(mean, R), _stats(rstd, R)
    k0, k1 = _words(key_words, R * C, keep)
    dh = torch.empty_like(h2)
    dres = torch.empty_like(h2)
    if R == 0:
        z = torch.zeros_like(gamma)
        return dh, z, dres, z.clone(), z.clone()
    plan = _frln_bwd_plan(R, C, h2.element_size(),
                          aligned16(h2, bias, res2, gamma, dy2, dh, dres),
                          sm_count(h2.device))
    parts = torch.empty(3, plan.ctas, C, dtype=torch.float32,
                        device=h2.device)
    bits = _mask_scratch(plan, C, keep, h2.device)
    bits_ptr = None if bits is None else bits.data_ptr()
    dg, db = torch.empty_like(gamma), torch.empty_like(gamma)
    dbias = torch.empty_like(bias)
    fn = _build.bind("fused_residual_ln_bwd", "mxt_fused_residual_ln_bwd",
                     _FRLN_BWD_ARGS)
    with torch.cuda.device(h2.device):
        err = fn(h2.data_ptr(), bias.data_ptr(), res2.data_ptr(),
                 gamma.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                 dy2.data_ptr(), dh.data_ptr(), dres.data_ptr(),
                 dg.data_ptr(), db.data_ptr(), dbias.data_ptr(),
                 parts.data_ptr(), bits_ptr, R, C, plan.vec, plan.ept,
                 plan.wpr, plan.ctas, int(keep < 1.0), k0, k1,
                 keep_thresh(keep), _inv_keep(keep), _DTYPES[h2.dtype],
                 _build.stream_of(h2))
    _build.check(err, "fused_residual_ln_bwd")
    bump(_SELF, "FRLN_BWD_LAUNCHES")
    return dh, dbias, dres, dg, db


class _FusedResidualLN(torch.autograd.Function):
    """Forward kernel, backward kernel.  Saves h, bias, res, gamma and
    the f32 mean/rstd (returned as non-differentiable outputs); the two
    key words and keep ride in ctx as Python values, so the backward
    redraws exactly the forward's mask."""

    @staticmethod
    def forward(ctx, h2, bias, res2, gamma, beta, k0, k1, p, eps,
                training):
        y, mean, rstd = fused_residual_ln_fwd(
            h2, bias, res2, gamma, beta, (k0, k1), p, eps, training)
        ctx.save_for_backward(h2, bias, res2, gamma, mean, rstd)
        ctx.mark_non_differentiable(mean, rstd)
        ctx.key_words, ctx.keep = (k0, k1), _keep(p, training)
        return y, mean, rstd

    @staticmethod
    def backward(ctx, dy, _dmean, _drstd):
        h2, bias, res2, gamma, mean, rstd = ctx.saved_tensors
        dh, dbias, dres, dg, db = fused_residual_ln_bwd(
            h2, bias, res2, gamma, ctx.key_words, mean, rstd,
            dy.contiguous(), ctx.keep)
        return dh, dbias, dres, dg, db, None, None, None, None, None


def fused_residual_layer_norm(h, bias, res, gamma, beta,
                              key_data: Optional[Sequence[int]] = None,
                              p=0.1, eps=1e-5, training=True):
    """y = LayerNorm(res + dropout(h + bias)) over the last axis.

    ``key_data`` is two uint32 threefry key words; it is read only when
    dropout is on (``training`` and ``p > 0``)."""
    C = h.shape[-1]
    k0, k1 = _words(key_data, h.numel(), _keep(p, training))
    y, _, _ = _FusedResidualLN.apply(
        h.reshape(-1, C), bias.reshape(-1), res.reshape(-1, C),
        gamma.reshape(-1), beta.reshape(-1), k0, k1, float(p), float(eps),
        bool(training))
    return y.reshape(h.shape)
