"""Training-mode BatchNorm with an optional fused residual add and ReLU,
forward and backward, over two views of the data.

Four kernels, each beside its launch counter; the plain PyTorch
versions (:func:`bn_act_reference`, :func:`bn_bwd_reference`) serve
both views:

* ``batch_norm_fwd`` — CUDA ``csrc/batch_norm.cu`` over an (N, C, S)
  channels-major view; replaces ``mxtpu/kernels/batch_norm.py:
  _fwd_kernel`` (launched by ``_fwd_call``).
* ``batch_norm_bwd`` — CUDA ``csrc/batch_norm_bwd.cu`` over (N, C, S);
  replaces ``_bwd_kernel`` (``_bwd_call``).
* ``batch_norm_fwd_cm`` — CUDA ``csrc/batch_norm.cu`` over an (R, C)
  channels-minor view (R = N*S); replaces ``_fwd_kernel_cm``
  (``_fwd_call_cm``).
* ``batch_norm_bwd_cm`` — CUDA ``csrc/batch_norm_bwd.cu`` over (R, C);
  replaces ``_bwd_kernel_cm`` (``_bwd_call_cm``).

The forward computes the per-channel batch mean and variance in f32
(``E[x^2] - E[x]^2``, clamped at 0) and ``y = x*scale + shift (+ r)``,
then the ReLU; y keeps x's type, mean and var are f32 (C,).  The
backward recomputes the ReLU mask ``xhat*g + b (+ r) > 0`` from x (not
from y), and returns dx, dr (the masked dy, in dy's type) and the f32
dgamma = sum(dy*xhat), dbeta = sum(dy).

Design on the H100.  The TPU kernels stage a whole channel block (all
N*S elements of a channel) in VMEM; the stem's channel here is 3.2 M
elements, far beyond a CTA's shared memory.  So each direction is a
split reduction of three kernels on one stream: per-chunk partial sums
over a (channel x chunk) grid into an f32 ``[chunks, C]`` workspace, a
finalize that sums the chunks in a fixed order (no float atomics, so
every result repeats bit for bit), and an elementwise pass.  A wrapper
call counts once, not three times.  Bound: bytes — a handful of flops
per element against reading x (dy, r) and writing y (dx, dr).  The
channels-major kernels (:func:`_major_plan`) walk a channel's runs of
S contiguous elements with 16-byte words, several in flight a thread,
the channel's values in registers; the channels-minor pair
(:func:`_cm_plan`) reads 16-byte vectors of neighbouring channels,
several rows in flight a thread.  With the add both backwards' stats
passes write dr, so their apply passes read x and dr only, and every
apply pass walks its data in the reverse of the stats pass's order, so
that what the stats pass read last comes from L2.

Dispatch: CPU tensors take the plain version; CUDA tensors launch the
kernels or the call raises.  :func:`fused_bn_act` picks the view from
the data: BN over an axis with trailing elements (NCHW's axis 1) takes
the channels-major pair, BN over the last axis (NHWC, or (N, C)) the
channels-minor pair; on the card a tensor that is not contiguous in
that layout raises rather than being copied.
"""
from __future__ import annotations

import ctypes
import math
import sys
from typing import NamedTuple, Optional, Tuple

import torch

from ..base import MXNetError
from . import _build, aligned16, bump, on_card, refuse_grad, sm_count

__all__ = ["fused_bn_act", "bn_act_reference", "bn_bwd_reference",
           "bn_fwd", "bn_bwd", "bn_fwd_cm", "bn_bwd_cm", "FWD_LAUNCHES",
           "BWD_LAUNCHES", "FWD_CM_LAUNCHES", "BWD_CM_LAUNCHES"]

# launches of each kernel (kernels.launch_counts reads them)
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
FWD_CM_LAUNCHES = 0
BWD_CM_LAUNCHES = 0
_SELF = sys.modules[__name__]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = ("none", "relu")
# the channels-minor kernels (bn_*_cm_*, both directions): CTAs of 256
# threads over tiles of up to 256 channels, 2 CTAs an SM in one wave,
# and at least 4 rows a row lane
CM_THREADS = 256
CM_WIDTH = 256
CM_CTAS_PER_SM = 2
CM_MIN_ROWS = 4
# the channels-major kernels (bn_*_major_*): CTAs of 256 threads, 256 /
# tc channels (tc threads each) and a chunk of runs each, the grid one
# wave of 2 CTAs an SM where C allows, and at least 12 word slots a
# thread
MAJOR_THREADS = 256
MAJOR_CTAS_PER_SM = 2
MAJOR_MIN_SLOTS = 12
MAX_CHUNKS = 65535  # gridDim.y

_P = ctypes.c_void_p
_LL, _I, _F = ctypes.c_longlong, ctypes.c_int, ctypes.c_float
# x, r, gamma, beta, y, mean, var, work; then channels-major: N, C, S,
# vec, words, tc, chunks, per_chunk, eps; channels-minor: R, C, vec, tv,
# chunks, per_chunk, eps; then relu, add, dtype, stream
_FWD_ARGS = [_P] * 8 + [_LL, _I, _LL, _I, _I, _I, _I, _LL, _F, _I, _I, _I,
                        _P]
_FWD_CM_ARGS = [_P] * 8 + [_LL, _I, _I, _I, _I, _LL, _F, _I, _I, _I, _P]
# x, r, dy, gamma, beta, mean, rstd, dx, dr, dgamma, dbeta, work; N, C,
# S, vec, words, tc, chunks, per_chunk, relu, add, dtype, stream
_BWD_ARGS = [_P] * 12 + [_LL, _I, _LL, _I, _I, _I, _I, _LL, _I, _I, _I, _P]
# the same pointers; R, C, vec, tv, chunks, per_chunk, relu, add, dtype,
# stream
_BWD_CM_ARGS = [_P] * 12 + [_LL, _I, _I, _I, _I, _LL, _I, _I, _I, _P]


# ----------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------

def _axes(x: torch.Tensor, axis: int):
    axis %= x.ndim
    shape = [1] * x.ndim
    shape[axis] = -1
    return tuple(i for i in range(x.ndim) if i != axis), shape


def bn_act_reference(x, gamma, beta, eps=1e-5, act="none", residual=None,
                     axis=1):
    """Plain PyTorch batch-stat BN(+add)(+ReLU) over ``axis``, as
    ``mxtpu/kernels/batch_norm.py:_fwd_kernel`` computes it; returns
    (y in x's type, mean, var), the statistics f32."""
    axes, sh = _axes(x, axis)
    xf = x.float()
    mean = xf.mean(dim=axes)
    var = ((xf * xf).mean(dim=axes) - mean * mean).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    scale = gamma.float() * rstd
    shift = beta.float() - mean * scale
    y = xf * scale.reshape(sh) + shift.reshape(sh)
    if residual is not None:
        y = y + residual.float()
    if act == "relu":
        y = y.clamp_min(0.0)
    return y.to(x.dtype), mean, var


def bn_bwd_reference(x, residual, dy, gamma, beta, mean, rstd, act="none",
                     axis=1):
    """Plain PyTorch backward of :func:`bn_act_reference` from the batch
    mean and ``rstd = rsqrt(var + eps)``, as ``_bwd_kernel`` computes
    it: the ReLU mask recomputed from x (and the residual), then
    ``dx = g*rstd*(dy - sum(dy)/n - xhat*sum(dy*xhat)/n)``.  Returns
    (dx in x's type, dr in dy's type or None, dgamma, dbeta in f32)."""
    axes, sh = _axes(x, axis)
    # elements per channel, the reference's ``n = float(N * S)``
    n = float(x.numel() // x.shape[axis % x.ndim])
    g, b = gamma.float().reshape(sh), beta.float().reshape(sh)
    xhat = (x.float() - mean.reshape(sh)) * rstd.reshape(sh)
    d = dy.float()
    if act == "relu":
        a = xhat * g + b
        if residual is not None:
            a = a + residual.float()
        d = torch.where(a > 0, d, torch.zeros_like(d))
    dr = d.to(dy.dtype) if residual is not None else None
    dbeta = d.sum(dim=axes)
    dgamma = (d * xhat).sum(dim=axes)
    grs = (gamma.float() * rstd).reshape(sh)
    dx = grs * (d - (dbeta / n).reshape(sh) - xhat * (dgamma / n).reshape(sh))
    return dx.to(x.dtype), dr, dgamma, dbeta


# ----------------------------------------------------------------------
# raw wrappers
# ----------------------------------------------------------------------

def _check(what: str, x: torch.Tensor, big=(), vecs=(), stats=()) -> None:
    """What the kernels take: contiguous f32/bf16 data (``x`` and
    ``big`` of x's shape and type), contiguous (C,) parameter vectors
    of x's type and contiguous (C,) f32 statistics."""
    if x.dtype not in _DTYPES:
        raise MXNetError(f"{what}: dtype {x.dtype} not supported "
                         f"(float32, bfloat16)")
    C = x.shape[1]
    for t in (x, *big):
        if t.shape != x.shape or t.dtype != x.dtype or \
                not t.is_contiguous():
            raise MXNetError(f"{what}: data must be contiguous "
                             f"{tuple(x.shape)} {x.dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for v in vecs:
        if v.shape != (C,) or v.dtype != x.dtype or not v.is_contiguous():
            raise MXNetError(f"{what}: gamma/beta must be contiguous "
                             f"({C},) {x.dtype}, got {tuple(v.shape)} "
                             f"{v.dtype}")
    for v in stats:
        if v.shape != (C,) or v.dtype != torch.float32 or \
                not v.is_contiguous():
            raise MXNetError(f"{what}: mean/rstd must be contiguous "
                             f"({C},) float32, got {tuple(v.shape)} "
                             f"{v.dtype}")


def _act(act: str) -> int:
    if act not in _ACTS:
        raise MXNetError(f"BatchNorm act must be one of {_ACTS}, got "
                         f"{act!r}")
    return int(act == "relu")


class MajorPlan(NamedTuple):
    """The launch of the channels-major kernels over (N, C, S): ``vec``
    elements a word (16 bytes' worth, or 1), runs peeled (``peel``:
    S not a multiple of ``vec``), ``words`` word slots a run, ``tc``
    threads a channel, a grid of ceil(C / (256 / tc)) x ``chunks``
    CTAs of ``MAJOR_THREADS``, each chunk ``per_chunk`` runs (the last
    may hold fewer)."""
    vec: int
    peel: bool
    words: int
    tc: int
    chunks: int
    per_chunk: int


def _major_plan(N: int, C: int, S: int, itemsize: int, aligned: bool,
                sms: int) -> MajorPlan:
    """Launch geometry of the channels-major kernels.  A run is the S
    contiguous elements of one (n, c), from element ``(n*C + c)*S``.

    Words: 16 bytes of T where every pointer is 16-byte aligned and a
    run is at least a word long, else single elements (S = 1 and the
    other short runs, and data off a 16-byte boundary).  Where
    ``S * itemsize`` is not a multiple of 16 (S = 49 in both types, 196
    in bf16) runs start off word boundaries, on multiples of gcd(S,
    vec) elements; each run then peels its partial head and tail words:
    they are loaded whole (the bytes are in the same 32-byte sectors
    either way) and used, and stored, element by element, so the body
    moves as 16-byte words whatever S is, in the same kernel (an
    instance of its own, whose per-element masks the others skip).
    ``words`` is the most words a run touches: a slot past a run's last
    word is empty.

    A channel's ``tc`` threads take its chunk's word slots in turn, so
    a run gets as many threads as it has words (up to tc), several runs
    are in flight at small S and several words a thread at large S.  tc
    is 256 (a CTA a channel) unless a thread would get fewer than
    ``MAJOR_MIN_SLOTS`` slots of the whole channel: then it halves, down
    to a warp, and a CTA takes 256 / tc neighbouring channels, as long
    as every SM still gets a CTA (fewer CTAs measured slower: half the
    warps to hide the loads' latency).  The
    chunks make the grid one wave of ``MAJOR_CTAS_PER_SM`` CTAs an SM
    where the channels' CTAs are fewer (more take one chunk each), each
    thread keeping ``MAJOR_MIN_SLOTS`` slots."""
    if N < 1 or C < 1 or S < 1:
        raise MXNetError(f"bn major: no launch for ({N}, {C}, {S})")
    v = 16 // itemsize
    vec = v if aligned and S >= v else 1
    words = (vec - math.gcd(S, vec) + S - 1) // vec + 1
    tc = MAJOR_THREADS
    while tc > 32 and N * words < MAJOR_MIN_SLOTS * tc and \
            -(-C // (2 * MAJOR_THREADS // tc)) >= sms:
        tc //= 2
    ctas = -(-C // (MAJOR_THREADS // tc))
    min_runs = -(-MAJOR_MIN_SLOTS * tc // words)
    want = max(1, min(sms * MAJOR_CTAS_PER_SM // ctas, N // min_runs,
                      MAX_CHUNKS))
    per_chunk = -(-N // want)
    return MajorPlan(vec, S % vec != 0, words, tc, -(-N // per_chunk),
                     per_chunk)


class CmPlan(NamedTuple):
    """The launch of the channels-minor kernels, either direction:
    ``vec`` channels per access (16 bytes' worth, or 1), ``tv`` accesses
    a channel tile spans, ``ly`` row lanes a CTA, a grid of ``tiles`` x
    ``chunks`` CTAs, each chunk ``per_chunk`` rows (the last may hold
    fewer)."""
    vec: int
    tv: int
    ly: int
    tiles: int
    chunks: int
    per_chunk: int


def _work_floats(chunks: int, C: int, coefs: int) -> int:
    """f32 workspace of either view's kernels: partial sums s1, s2 per
    (chunk, channel), then ``coefs`` coefficients per channel (2 forward:
    scale, shift; 3 backward: g*rstd, sum(dy)/n, sum(dy*xhat)/n)."""
    return 2 * chunks * C + coefs * C


def _cm_plan(R: int, C: int, itemsize: int, aligned: bool,
             sms: int) -> CmPlan:
    """Launch geometry of the channels-minor kernels over (R, C), the
    same in both directions and in every pass: vector accesses only
    where C is a multiple of 16 bytes' worth and every pointer is
    16-byte aligned; a channel tile of up to 256 channels a CTA; chunks
    of rows so that the grid is one wave of ``CM_CTAS_PER_SM`` CTAs an
    SM, each row lane walking at least ``CM_MIN_ROWS`` rows."""
    if R < 1 or C < 1:
        raise MXNetError(f"bn cm: no launch for ({R}, {C})")
    v = 16 // itemsize
    vec = v if aligned and C % v == 0 else 1
    vpr = -(-C // vec)
    tv = min(vpr, CM_WIDTH // vec)
    ly = CM_THREADS // tv
    tiles = -(-vpr // tv)
    want = max(1, min(-(-sms * CM_CTAS_PER_SM // tiles),
                      -(-R // (ly * CM_MIN_ROWS)), MAX_CHUNKS))
    per_chunk = -(-R // want)
    return CmPlan(vec, tv, ly, tiles, -(-R // per_chunk), per_chunk)


def _fwd(x, gamma, beta, residual, eps, act, cm):
    what = "bn_fwd_cm" if cm else "bn_fwd"
    if not on_card(x, gamma, beta,
                   *(() if residual is None else (residual,))):
        return bn_act_reference(x, gamma, beta, eps, act, residual, axis=1)
    refuse_grad(what, x, gamma, beta,
                *(() if residual is None else (residual,)))
    _check(what, x, () if residual is None else (residual,), (gamma, beta))
    relu = _act(act)
    if x.numel() == 0:
        raise MXNetError(f"{what}: empty input {tuple(x.shape)}")
    y = torch.empty_like(x)
    A, C = x.shape[:2]
    big = [t for t in (x, residual, y) if t is not None]
    if cm:
        plan = _cm_plan(A, C, x.element_size(), aligned16(*big),
                        sm_count(x.device))
        shape = (A, C, plan.vec, plan.tv, plan.chunks, plan.per_chunk)
        fn = _build.bind("batch_norm", "mxt_bn_fwd_cm", _FWD_CM_ARGS)
    else:
        S = x.shape[2]
        plan = _major_plan(A, C, S, x.element_size(), aligned16(*big),
                           sm_count(x.device))
        shape = (A, C, S, plan.vec, plan.words, plan.tc, plan.chunks,
                 plan.per_chunk)
        fn = _build.bind("batch_norm", "mxt_bn_fwd", _FWD_ARGS)
    mean = torch.empty(C, dtype=torch.float32, device=x.device)
    var = torch.empty(C, dtype=torch.float32, device=x.device)
    work = torch.empty(_work_floats(plan.chunks, C, 2), dtype=torch.float32,
                       device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(),
                 None if residual is None else residual.data_ptr(),
                 gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
                 mean.data_ptr(), var.data_ptr(), work.data_ptr(), *shape,
                 float(eps), relu, int(residual is not None),
                 _DTYPES[x.dtype], _build.stream_of(x))
    _build.check(err, what)
    bump(_SELF, "FWD_CM_LAUNCHES" if cm else "FWD_LAUNCHES")
    return y, mean, var


def _bwd(x, residual, dy, gamma, beta, mean, rstd, act, cm):
    what = "bn_bwd_cm" if cm else "bn_bwd"
    if not on_card(x, dy, gamma, beta, mean, rstd,
                   *(() if residual is None else (residual,))):
        return bn_bwd_reference(x, residual, dy, gamma, beta, mean, rstd,
                                act, axis=1)
    refuse_grad(what, x, dy, gamma, beta,
                *(() if residual is None else (residual,)))
    _check(what, x, (dy,) if residual is None else (dy, residual),
           (gamma, beta), (mean, rstd))
    relu = _act(act)
    if x.numel() == 0:
        raise MXNetError(f"{what}: empty input {tuple(x.shape)}")
    dx = torch.empty_like(x)
    dr = None if residual is None else torch.empty_like(dy)
    A, C = x.shape[:2]
    dgamma = torch.empty(C, dtype=torch.float32, device=x.device)
    dbeta = torch.empty(C, dtype=torch.float32, device=x.device)
    big = [t for t in (x, residual, dy, dx, dr) if t is not None]
    if cm:
        plan = _cm_plan(A, C, x.element_size(), aligned16(*big),
                        sm_count(x.device))
        shape = (A, C, plan.vec, plan.tv, plan.chunks, plan.per_chunk)
        fn = _build.bind("batch_norm_bwd", "mxt_bn_bwd_cm", _BWD_CM_ARGS)
    else:
        S = x.shape[2]
        plan = _major_plan(A, C, S, x.element_size(), aligned16(*big),
                           sm_count(x.device))
        shape = (A, C, S, plan.vec, plan.words, plan.tc, plan.chunks,
                 plan.per_chunk)
        fn = _build.bind("batch_norm_bwd", "mxt_bn_bwd", _BWD_ARGS)
    work = torch.empty(_work_floats(plan.chunks, C, 3), dtype=torch.float32,
                       device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(),
                 None if residual is None else residual.data_ptr(),
                 dy.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                 mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
                 None if dr is None else dr.data_ptr(), dgamma.data_ptr(),
                 dbeta.data_ptr(), work.data_ptr(), *shape, relu,
                 int(residual is not None), _DTYPES[x.dtype],
                 _build.stream_of(x))
    _build.check(err, what)
    bump(_SELF, "BWD_CM_LAUNCHES" if cm else "BWD_LAUNCHES")
    return dx, dr, dgamma, dbeta


def bn_fwd(x3, gamma, beta, residual3=None, eps=1e-5, act="none"):
    """(N, C, S) → (y, mean, var): the channels-major kernel on CUDA
    tensors, the plain version on CPU tensors."""
    return _fwd(x3, gamma, beta, residual3, eps, act, cm=False)


def bn_bwd(x3, residual3, dy3, gamma, beta, mean, rstd, act="none"):
    """(N, C, S) → (dx, dr or None, dgamma, dbeta): the channels-major
    backward kernel on CUDA tensors, the plain version on CPU
    tensors."""
    return _bwd(x3, residual3, dy3, gamma, beta, mean, rstd, act, cm=False)


def bn_fwd_cm(x2, gamma, beta, residual2=None, eps=1e-5, act="none"):
    """(R, C) → (y, mean, var): the channels-minor kernel on CUDA
    tensors, the plain version on CPU tensors."""
    return _fwd(x2, gamma, beta, residual2, eps, act, cm=True)


def bn_bwd_cm(x2, residual2, dy2, gamma, beta, mean, rstd, act="none"):
    """(R, C) → (dx, dr or None, dgamma, dbeta): the channels-minor
    backward kernel on CUDA tensors, the plain version on CPU
    tensors."""
    return _bwd(x2, residual2, dy2, gamma, beta, mean, rstd, act, cm=True)


# ----------------------------------------------------------------------
# autograd and the public entry
# ----------------------------------------------------------------------

class _FusedBN(torch.autograd.Function):
    """Forward kernel, backward kernel.  Saves x, the residual, gamma,
    beta and the f32 batch mean and var; mean and var are returned as
    non-differentiable outputs (the running-stat channel), and the
    backward recomputes rstd from var as ``_fused_bn_bwd`` does."""

    @staticmethod
    def forward(ctx, x, gamma, beta, residual, eps, act, cm):
        y, mean, var = _fwd(x, gamma, beta, residual, eps, act, cm)
        ctx.save_for_backward(x, residual, gamma, beta, mean, var)
        ctx.mark_non_differentiable(mean, var)
        ctx.eps, ctx.act, ctx.cm = eps, act, cm
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, residual, gamma, beta, mean, var = ctx.saved_tensors
        rstd = torch.rsqrt(var + ctx.eps)
        dx, dr, dg, db = _bwd(x, residual, dy.contiguous(), gamma, beta,
                              mean, rstd, ctx.act, ctx.cm)
        return (dx, dg.to(gamma.dtype), db.to(beta.dtype), dr, None, None,
                None)


def fused_bn_act(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 eps: float = 1e-5, act: str = "none",
                 residual: Optional[torch.Tensor] = None,
                 axis: int = 1
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training-mode BN over channel ``axis`` with batch statistics, an
    optional residual add and ReLU, and its gradient.  Returns
    ``(y, batch_mean, batch_var)``; mean and var are f32 and not
    differentiable.

    x is viewed as (A, C, S) around ``axis``: S > 1 takes the
    channels-major kernels on (A, C, S), S = 1 the channels-minor ones
    on (A, C).  On the card x (and the residual) must be contiguous in
    that view; no copy is made."""
    if x.ndim < 2:
        raise MXNetError(f"fused_bn_act: need at least 2 dims, got "
                         f"{tuple(x.shape)}")
    axis %= x.ndim
    _act(act)
    if residual is not None and residual.shape != x.shape:
        raise MXNetError(f"fused_bn_act: residual {tuple(residual.shape)} "
                         f"!= x {tuple(x.shape)}")
    A = math.prod(x.shape[:axis])
    C = x.shape[axis]
    S = math.prod(x.shape[axis + 1:])
    cm = S == 1
    view = (A, C) if cm else (A, C, S)
    if x.device.type == "cuda":
        for name, t in (("x", x), ("residual", residual)):
            if t is not None and not t.is_contiguous():
                layout = "channels-minor (N*S, C)" if cm else \
                    "channels-major (N, C, S)"
                raise MXNetError(
                    f"fused_bn_act: {name} {tuple(t.shape)} with strides "
                    f"{t.stride()} is not contiguous in the {layout} "
                    f"layout that BN over axis {axis} needs")
    r = None if residual is None else residual.reshape(view)
    y, mean, var = _FusedBN.apply(x.reshape(view), gamma.reshape(-1),
                                  beta.reshape(-1), r, float(eps), act, cm)
    return y.reshape(x.shape), mean, var
