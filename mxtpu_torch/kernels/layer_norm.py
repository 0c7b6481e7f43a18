"""LayerNorm forward and the fused residual LayerNorm forward.

Two kernels, each beside its plain PyTorch version and its launch
counter:

* ``layer_norm`` — CUDA ``csrc/layer_norm.cu``; replaces
  ``mxtpu/kernels/layer_norm.py:_ln_fwd_kernel`` (``_pallas_ln_fwd``).
* ``fused_residual_layer_norm`` — CUDA ``csrc/fused_residual_ln.cu``;
  replaces ``_frln_fwd_kernel`` (``_pallas_frln_fwd``):
  ``y = LN(res + dropout(h + bias))`` with the reference's threefry2x32
  dropout mask over the global linear element index.

Bound on the H100 (serving shape: rows = b*T, C = 1024): bytes.  Each
is a row reduction with an elementwise prologue and epilogue at ~10
flops per element, far under the card's flop/byte balance, so the floor
is reading the inputs once and writing y once at 3.35 TB/s.  Both
kernels stage one row in shared memory as f32 (one CTA per row), so
every input byte is read once and the residual sum ``u`` never reaches
device memory.  CUDA C++ rather than Triton: one build route (nvcc +
ctypes) for every kernel of the serving path.

Dispatch: CPU tensors take the plain version; CUDA tensors launch the
kernel or the call raises.
"""
from __future__ import annotations

import ctypes
import sys
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..base import MXNetError
from . import _build, bump, on_card

__all__ = ["layer_norm", "layer_norm_fwd", "layer_norm_reference",
           "fused_residual_layer_norm", "fused_residual_ln_fwd",
           "fused_residual_ln_reference", "mask_bits", "keep_thresh",
           "LAUNCHES", "FRLN_LAUNCHES"]

# launches of each kernel (kernels.launch_counts reads them)
LAUNCHES = 0
FRLN_LAUNCHES = 0
_SELF = sys.modules[__name__]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# one row of f32 plus the per-warp scratch must fit the default 48 KB
# of dynamic shared memory
MAX_C = 48 * 1024 // 4 - 32

_P = ctypes.c_void_p
_LN_ARGS = [_P, _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, _P]
_FRLN_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong,
              ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_uint32,
              ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float,
              ctypes.c_int, _P]


def _check_rows(what: str, x2: torch.Tensor,
                vecs: Sequence[torch.Tensor]) -> None:
    """What both kernels take: contiguous (R, C) f32/bf16 rows and
    contiguous (C,) vectors of the same type, C within MAX_C."""
    if x2.dtype not in _DTYPES:
        raise MXNetError(f"{what}: dtype {x2.dtype} not supported "
                         f"(float32, bfloat16)")
    C = x2.shape[-1]
    if C > MAX_C:
        raise MXNetError(f"{what}: {C} features exceed the kernel bound "
                         f"{MAX_C}")
    if not x2.is_contiguous():
        raise MXNetError(f"{what}: input must be contiguous")
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


def layer_norm_fwd(x2: torch.Tensor, gamma: torch.Tensor,
                   beta: torch.Tensor, eps: float = 1e-5
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(R, C) rows → (y, mean, rstd): the kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if not on_card(x2, gamma, beta):
        return layer_norm_reference(x2, gamma, beta, eps)
    _check_rows("layer_norm", x2, (gamma, beta))
    R, C = x2.shape
    y = torch.empty_like(x2)
    mean = torch.empty(R, dtype=torch.float32, device=x2.device)
    rstd = torch.empty(R, dtype=torch.float32, device=x2.device)
    if R == 0:
        return y, mean, rstd
    fn = _build.bind("layer_norm", "mxt_layer_norm_fwd", _LN_ARGS)
    with torch.cuda.device(x2.device):
        err = fn(x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                 y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), R, C,
                 float(eps), _DTYPES[x2.dtype], _build.stream_of(x2))
    _build.check(err, "layer_norm")
    bump(_SELF)
    return y, mean, rstd


def layer_norm(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis of any-rank ``x``."""
    C = x.shape[-1]
    y, _, _ = layer_norm_fwd(x.reshape(-1, C), gamma.reshape(-1),
                             beta.reshape(-1), eps)
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


def fused_residual_ln_reference(h, bias, res, gamma, beta, key_data=None,
                                p=0.1, eps=1e-5, training=True):
    """Plain PyTorch version of the epilogue with the same threefry
    mask as the kernel; returns (y in h's type, mean, rstd)."""
    C = h.shape[-1]
    hb = h.float() + bias.float().reshape(-1)
    keep = _keep(p, training)
    if keep < 1.0:
        n = h.numel()
        if n >= (1 << 32):
            raise MXNetError("fused_residual_layer_norm: the dropout "
                             "counter would wrap at 2^32 elements")
        k0, k1 = _key_words(key_data)
        bits = mask_bits(k0, k1, 0, n // C, C, device=h.device)
        mask = (bits < keep_thresh(keep)).reshape(h.shape)
        hb = torch.where(mask, hb * float(np.float32(1.0 / keep)),
                         torch.zeros_like(hb))
    y, mean, rstd = layer_norm_reference(res.float() + hb, gamma, beta, eps)
    return y.to(h.dtype), mean, rstd


def fused_residual_ln_fwd(h2, bias, res2, gamma, beta, key_data=None,
                          p=0.1, eps=1e-5, training=True):
    """(R, C) rows → (y, mean, rstd): the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if not on_card(h2, bias, res2, gamma, beta):
        return fused_residual_ln_reference(h2, bias, res2, gamma, beta,
                                           key_data, p, eps, training)
    _check_rows("fused_residual_layer_norm", h2, (bias, gamma, beta))
    if res2.shape != h2.shape or res2.dtype != h2.dtype or \
            not res2.is_contiguous():
        raise MXNetError("fused_residual_layer_norm: residual must be a "
                         "contiguous tensor of h's shape and type")
    R, C = h2.shape
    keep = _keep(p, training)
    k0 = k1 = 0
    if keep < 1.0:
        if R * C >= (1 << 32):
            raise MXNetError("fused_residual_layer_norm: the dropout "
                             "counter would wrap at 2^32 elements")
        k0, k1 = _key_words(key_data)
    y = torch.empty_like(h2)
    mean = torch.empty(R, dtype=torch.float32, device=h2.device)
    rstd = torch.empty(R, dtype=torch.float32, device=h2.device)
    if R == 0:
        return y, mean, rstd
    fn = _build.bind("fused_residual_ln", "mxt_fused_residual_ln_fwd",
                     _FRLN_ARGS)
    with torch.cuda.device(h2.device):
        err = fn(h2.data_ptr(), bias.data_ptr(), res2.data_ptr(),
                 gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
                 mean.data_ptr(), rstd.data_ptr(), R, C, float(eps),
                 int(keep < 1.0), k0, k1, keep_thresh(keep),
                 float(np.float32(1.0 / keep)), _DTYPES[h2.dtype],
                 _build.stream_of(h2))
    _build.check(err, "fused_residual_layer_norm")
    bump(_SELF, "FRLN_LAUNCHES")
    return y, mean, rstd


def fused_residual_layer_norm(h, bias, res, gamma, beta,
                              key_data: Optional[Sequence[int]] = None,
                              p=0.1, eps=1e-5, training=True):
    """y = LayerNorm(res + dropout(h + bias)) over the last axis.

    ``key_data`` is two uint32 threefry key words; it is read only when
    dropout is on (``training`` and ``p > 0``)."""
    C = h.shape[-1]
    y, _, _ = fused_residual_ln_fwd(
        h.reshape(-1, C), bias.reshape(-1), res.reshape(-1, C),
        gamma.reshape(-1), beta.reshape(-1), key_data, p, eps, training)
    return y.reshape(h.shape)
