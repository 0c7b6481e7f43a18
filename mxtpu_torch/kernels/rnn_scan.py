"""The whole recurrence of one layer and direction of the fused RNN op,
LSTM and GRU, forward and backward: ``csrc/rnn_scan.cu``.

* :func:`lstm_scan` — ``(pre, h0, c0, w_h2h, reverse) -> (ys, h_T,
  c_T)``: ``pre`` (T, N, 4H) is the hoisted i2h product with both biases,
  each step ``h . W_h2h^T`` and the cell of ``rnn_cell.lstm_fwd`` (gates
  [i, f, g, o]).
* :func:`gru_scan` — ``(pre, h0, w_h2h, b_rn, reverse) -> (ys, h_T)``:
  [r, z, n], ``b_rn`` inside the reset product, as ``rnn_cell.gru_fwd``.

Each is a ``torch.autograd.Function`` over a whole direction.  On a CUDA
tensor its forward is one launch of ``lstm_scan_fwd_kernel`` (or the
GRU's) and its backward one launch of ``*_scan_bwd_kernel`` (counted in
``LSTM_SCAN_FWD_LAUNCHES`` and the like), which return the gradient of
``pre`` (and GRU's ``dhh``), of ``h0`` and ``c0``; dW_h2h is then one
GEMM over the (T N) rows, GRU's ``b_rn`` gradient one sum, and the i2h
gradients flow through the caller's ``addmm``.  On CPU tensors the plain
versions run (:func:`lstm_scan_fwd_reference` and the like): the
per-step loop on ``rnn_cell``'s plain cells, whose backward is the same
decomposition (per-step plain cell backwards, then the one dW GEMM).  A
CUDA tensor launches the kernel or the call raises: a failed build, a
launch refused (a grid that cannot be co-resident among them) or a
shape past the limits never gives way to another path.

Rounding points (both versions): ``h . W^T`` and ``dhh . W`` in the
type (a bf16 product rounded as ``torch.matmul``'s output), the cell in
f32 on them, c carried in the type, the saved gates and the carried dc
(and GRU's ``z dh``) in f32; ``dh = (dy + (dh_T or dhh . W)) + z dh``.

Limits (:func:`scan_plan`, the only place the launch's plan is reckoned;
the kernel reads it as ints, ``PLAN_FIELDS``): any N, run in batch
chunks of at most 32 rows inside the one launch; bf16 the rows of a
CTA, G ceil(H / P) (P = min(SMs, H)), at most 64 and its slice of W_h2h
within 227 KB of shared memory (H up to 1632 for the LSTM at a chunk of
<= 24 rows, 1584 at 32, the GRU's 1980 and 1888); f32 a plan whose
narrowest chunk fits (LSTM H up to 43560 at N 20 on 132 SMs).
:func:`scan_path` picks, before any launch, the plain scan (CPU), the
kernel (CUDA within the limits) or the per-step cell kernels of
``rnn_cell`` (CUDA past them).

Replaces no Pallas kernel: mxtpu runs the recurrence as a ``lax.scan``
(``mxtpu/ndarray/rnn_impl.py:77-116``).  The launch reads no value on
the host and runs on torch's current stream.
"""
from __future__ import annotations

import ctypes
import functools
import sys

import torch

from ..base import MXNetError
from . import _build, bump, on_card, sm_count
from .rnn_cell import (gru_bwd_reference, gru_fwd_reference,
                       lstm_bwd_reference, lstm_fwd_reference)

__all__ = ["lstm_scan", "gru_scan", "lstm_scan_fwd", "lstm_scan_bwd",
           "gru_scan_fwd", "gru_scan_bwd", "lstm_scan_fwd_reference",
           "lstm_scan_bwd_reference", "gru_scan_fwd_reference",
           "gru_scan_bwd_reference", "scan_plan", "scan_path",
           "unit_slices", "LSTM_SCAN_FWD_LAUNCHES", "LSTM_SCAN_BWD_LAUNCHES",
           "GRU_SCAN_FWD_LAUNCHES", "GRU_SCAN_BWD_LAUNCHES"]

LSTM_SCAN_FWD_LAUNCHES = 0
LSTM_SCAN_BWD_LAUNCHES = 0
GRU_SCAN_FWD_LAUNCHES = 0
GRU_SCAN_BWD_LAUNCHES = 0
_SELF = sys.modules[__name__]

_P, _I = ctypes.c_void_p, ctypes.c_int
_DTYPES = (torch.float32, torch.bfloat16)
_GATES = {"lstm": 4, "gru": 3}
_MODE = {"lstm": 0, "gru": 1}
THREADS, WARPS = 256, 8
SMEM_MAX = 232448       # a CTA's shared memory on sm_90
CHUNK_N = 32            # batch rows a chunk: the product's N tile at most
# the Plan struct of csrc/rnn_scan.cu, field by field
PLAN_FIELDS = ("R", "RP", "NB", "K", "KB", "KST", "KC", "KW", "RG", "CG",
               "KSI", "RL", "CL", "HALF", "off_red", "off_out", "off_st",
               "bytes", "CN", "TH")
TILE_ROWS = (2, 4, 6, 8)    # the f32 product's compiled RL x CL tiles
KC_F32 = (384, 256, 128, 64, 32)  # an f32 chunk's columns: the widest that fits
F32_THREADS = 384           # the f32 CTA's threads (12 warps)


def _rup(x, m):
    return (x + m - 1) // m * m


def unit_slices(H, P):
    """[(j0, U)] of the P CTAs: CTA k owns units j0 .. j0 + U - 1, U =
    H // P, one more for the first H % P."""
    base, rem = divmod(H, P)
    return [(k * base + min(k, rem), base + (k < rem)) for k in range(P)]


def f32_tiles(R, nb):
    """The f32 product's lane tiles for R rows and a batch chunk of nb:
    (RG, CG, KSI, RL, CL), RL x CL a lane's tile (RL in TILE_ROWS, CL 6
    at nb 24, else 8), RG x CG lanes a k phase, KSI phases a warp; the
    cheapest by rows x passes x max(1, 4 (1 / RL + 1 / CL)) (a tile's
    16-byte loads over its FMAs, against the SM's 128 bytes and 128
    FMAs a clock), of those with the fewest row passes (each pass reads
    the state again)."""
    best = None
    CL = 6 if nb == 24 else 8
    CG = nb // CL
    RG = 1
    while RG * CG <= 32:
        for RL in TILE_ROWS:
            RP = RG * RL
            passes = -(-R // RP)
            cost = passes * RP * max(1.0, 4 * (1 / RL + 1 / CL))
            key = (passes, cost, RP, -RL)
            if best is None or key < best[0]:
                best = (key, (RG, CG, 32 // (RG * CG), RL, CL))
        RG *= 2
    return best[1]


def scan_plan(bf16, fwd, mode, n, H, P, kw=None):
    """See :func:`_plan`; f32 takes the widest chunk of ``KC_F32`` that
    fits."""
    for width in ((None,) if bf16 else KC_F32):
        p = _plan(bf16, fwd, mode, n, H, P, kw, width)
        if p is not None:
            return p
    return None


def _plan(bf16, fwd, mode, n, H, P, kw, kc):
    """The launch's plan, the one place it is reckoned (the kernel reads
    it as its ``Plan``): shared-memory carve and work split, or None
    past the kernel's limits.  The batch runs in ceil(n / 32) chunks of
    CN rows, padded to NB.  bf16 stages the CTA's whole weight slice in
    shared memory.  f32 sums in register tiles (:func:`f32_tiles`), rows
    in passes of RP, k in chunks of KC columns (``kc``) double-buffered
    beside the warps' partial sums, and stages the weights' first KW
    columns (``kw`` caps them: 0 copies every column a chunk at a time)
    in what is left."""
    G = _GATES[mode]
    umax = -(-H // P)
    chunks = -(-n // CHUNK_N) if n > 0 else 1
    cn = -(-n // chunks)
    nb = _rup(cn, 8)
    R = (G if fwd else 1) * umax
    K = H if fwd else G * H
    KB = _rup(K, 32)
    st = (1 if fwd else 2) * umax * nb * 4
    p = dict.fromkeys(PLAN_FIELDS, 0)
    p.update(R=R, NB=nb, K=K, KB=KB, CN=cn,
             TH=THREADS if bf16 else F32_THREADS)
    if bf16:
        RP = _rup(R, 16)
        KST = KB if KB % 64 == 32 else KB + 32   # conflict-free LDS.128
        wbytes = _rup(R * KST * 2, 16)
        region = WARPS * RP * nb * 4
        out_rows = RP
        ok = RP <= 64
        p.update(RP=RP, KST=KST)
    else:
        RG, CG, KSI, RL, CL = f32_tiles(R, nb)
        RP = RG * RL
        red = F32_THREADS // 32 * RP * nb * 4
        KC = min(KB, kc)
        out_rows = R
        fixed = R * nb * 4 + st

        def carve(with_w):
            half = nb * (KC + 4) + (KC * RP if with_w else 0)
            region = max(red, 2 * half * 4)
            left = SMEM_MAX - region - fixed
            KW = min(KB, max(left, 0) // (R * 4) // 32 * 32)
            return half, region, KW if kw is None else min(KW, kw)
        half, region, KW = carve(True)
        if KW == KB:            # every column staged: no weight chunks
            half, region, _ = carve(False)
        wbytes = KW * R * 4
        ok = KC >= 32 and KC % 32 == 0
        p.update(RP=RP, RG=RG, CG=CG, KSI=KSI, RL=RL, CL=CL, KC=KC, KW=KW,
                 HALF=half)
    p["off_red"] = wbytes
    p["off_out"] = wbytes + region
    p["off_st"] = p["off_out"] + out_rows * nb * 4
    p["bytes"] = p["off_st"] + st
    ok = ok and n >= 1 and 1 <= P <= H and p["bytes"] <= SMEM_MAX
    return p if ok else None


def scan_path(device_type, dtype, n, H, mode, sms):
    """Which path one direction takes, from what is known before any
    launch: "plain" (CPU tensors: the plain scan), "scan" (CUDA, f32 or
    bf16, forward and backward plans within the limits: the persistent
    kernels) or "cell" (CUDA otherwise: the per-step cell kernels,
    which raise on a type they do not take)."""
    if device_type == "cpu":
        return "plain"
    if dtype not in _DTYPES:
        return "cell"
    bf16 = dtype == torch.bfloat16
    P = min(sms, H)
    fits = all(scan_plan(bf16, fwd, mode, n, H, P) is not None
               for fwd in (True, False))
    return "scan" if fits else "cell"


def _order(T, reverse):
    return range(T - 1, -1, -1) if reverse else range(T)


def _dw(dhh, ys, h0, reverse):
    """dW_h2h = sum_t dhh_t^T h_prev_t, one GEMM over the (T N) rows;
    h_prev_t is the state step t read (h0 first in the scan's order)."""
    T, N, GH = dhh.shape
    hp = torch.cat([ys[1:], h0[None]]) if reverse else \
        torch.cat([h0[None], ys[:-1]])
    return torch.matmul(dhh.reshape(T * N, GH).t(),
                        hp.reshape(T * N, -1).to(dhh.dtype))


# ----------------------------------------------------------------------
# plain versions: the per-step loop on rnn_cell's plain cells
# ----------------------------------------------------------------------
def lstm_scan_fwd_reference(pre, h0, c0, w, reverse):
    """(ys, h_T, c_T, gates (T, N, 4H) f32, cs (T, N, H) = c_t)."""
    T, N, GH = pre.shape
    ys = torch.empty(T, N, GH // 4, dtype=pre.dtype, device=pre.device)
    cs = torch.empty_like(ys)
    gates = torch.empty(T, N, GH, dtype=torch.float32, device=pre.device)
    h, c = h0, c0
    wt = w.t()
    for t in _order(T, reverse):
        h, c, gates[t] = lstm_fwd_reference(pre[t], torch.matmul(h, wt), c)
        ys[t], cs[t] = h, c
    return ys, h, c, gates, cs


def lstm_scan_bwd_reference(dy, dhT, dcT, gates, cs, c0, w, reverse):
    """(dpre (T, N, 4H), dh0, dc0) in the type of ``cs``."""
    T = gates.shape[0]
    dt = cs.dtype
    dpre = torch.empty(gates.shape, dtype=dt, device=gates.device)
    x = dhT.float()
    dc = dcT.float()
    steps = list(_order(T, reverse))
    for s in range(T - 1, -1, -1):
        t = steps[s]
        c_prev = c0 if s == 0 else cs[steps[s - 1]]
        dh = dy[t].float() + x
        dg, dc = lstm_bwd_reference(dh, dc, gates[t], c_prev, cs[t])
        dpre[t] = dg
        x = torch.matmul(dpre[t], w).float()
    return dpre, x.to(dt), dc.to(dt)


def gru_scan_fwd_reference(pre, h0, w, b_rn, reverse):
    """(ys, h_T, saved (T, N, 4H) f32 = [r, z, n, hh_n + b_rn])."""
    T, N, GH = pre.shape
    H = GH // 3
    ys = torch.empty(T, N, H, dtype=pre.dtype, device=pre.device)
    saved = torch.empty(T, N, 4 * H, dtype=torch.float32, device=pre.device)
    h = h0
    wt = w.t()
    for t in _order(T, reverse):
        h, saved[t] = gru_fwd_reference(pre[t], torch.matmul(h, wt), b_rn, h)
        ys[t] = h
    return ys, h, saved


def gru_scan_bwd_reference(dy, dhT, saved, ys, h0, w, reverse):
    """(dpre (T, N, 3H), dhh (T, N, 3H), dh0) in the type of ``ys``."""
    T, N, H4 = saved.shape
    dt = ys.dtype
    dpre = torch.empty(T, N, 3 * H4 // 4, dtype=dt, device=ys.device)
    dhh = torch.empty_like(dpre)
    x = dhT.float()
    direct = torch.zeros_like(x)
    steps = list(_order(T, reverse))
    for s in range(T - 1, -1, -1):
        t = steps[s]
        h_prev = h0 if s == 0 else ys[steps[s - 1]]
        dh = (dy[t].float() + x) + direct
        dp, dq, direct = gru_bwd_reference(dh, saved[t], h_prev)
        dpre[t], dhh[t] = dp, dq
        x = torch.matmul(dhh[t], w).float()
    return dpre, dhh, (x + direct).to(dt)


# ----------------------------------------------------------------------
# the kernels' wrappers (no graph: the autograd Functions call them)
# ----------------------------------------------------------------------
def _check(what, dt, GH, H, w, *tensors):
    """Contiguous inputs of one type, f32 or bf16, and W_h2h (G H, H);
    else raise."""
    if dt not in _DTYPES:
        raise MXNetError(f"{what}: f32 or bf16, got {dt}")
    if tuple(w.shape) != (GH, H):
        raise MXNetError(f"{what}: w_h2h {tuple(w.shape)}, want ({GH}, {H})")
    for t in (w, *tensors):
        if t.dtype != dt:
            raise MXNetError(f"{what}: mixed types {dt} and {t.dtype}")
        if not t.is_contiguous():
            raise MXNetError(f"{what}: inputs must be contiguous")


def _plan_or_raise(what, dtype, fwd, mode, N, H, dev, kw=None):
    P = min(sm_count(dev), H)
    plan = scan_plan(dtype == torch.bfloat16, fwd, mode, N, H, P, kw)
    if plan is None:
        raise MXNetError(f"{what}: N {N}, H {H} {dtype} is past the "
                         f"persistent kernel's limits (scan_path routes "
                         f"it to the cell kernels)")
    return P, plan


@functools.lru_cache(maxsize=64)
def _pack_index(H, P, G, fwd, device):
    """(P, R) source rows of the packed weights: forward CTA k's row
    i is W's row (i / U) H + j0 + i % U, backward its row u is W's
    column j0 + u; rows past the CTA's own point at the zero row."""
    R = (G if fwd else 1) * -(-H // P)
    zero_row = G * H if fwd else H
    idx = torch.full((P, R), zero_row, dtype=torch.int64)
    for k, (j0, U) in enumerate(unit_slices(H, P)):
        rows = [(i // U) * H + j0 + i % U for i in range((G if fwd else 1)
                                                          * U)]
        idx[k, :len(rows)] = torch.tensor(rows)
    return idx.to(device)


def _pack(w, G, fwd, H, P):
    """The weights as the kernel reads them, a block a CTA: its rows
    (forward W's rows (i / U) H + j0 + i % U, backward W's columns j0 +
    u), zero past K and past the CTA's rows; bf16 [R][KB], copied as is
    into shared memory (stage_w), f32 [KB / 4][R][4], its first KW
    columns staged, the rest copied a chunk at a time (prod_f32: a
    lane's rows side by side in each 4-k group)."""
    src = w if fwd else w.t()
    K = src.shape[1]
    KB = _rup(K, 32)
    pad = torch.zeros(src.shape[0] + 1, KB, dtype=w.dtype, device=w.device)
    pad[:-1, :K] = src
    blocks = pad[_pack_index(H, P, G, fwd, str(w.device))]   # (P, R, KB)
    if w.dtype != torch.float32:
        return blocks
    P_, R, _ = blocks.shape
    return blocks.view(P_, R, KB // 4, 4).transpose(1, 2).contiguous()


def _exchange(plan, dtype, dev, h0=None):
    """The zero-padded (NB, KB) slots the CTAs exchange the state
    through: a ring of two, then (forward) each batch chunk's h0."""
    N = 0 if h0 is None else h0.shape[0]
    CN, NB, KB = plan["CN"], plan["NB"], plan["KB"]
    slots = torch.zeros(2 + -(-N // CN), NB, KB, dtype=dtype, device=dev)
    for c, n0 in enumerate(range(0, N, CN)):
        rows = h0[n0:n0 + CN]
        slots[2 + c, :rows.shape[0], :rows.shape[1]] = rows
    return slots


def _launch(symbol, plan, args, ints, dev_tensor, counter):
    fn = _build.bind("rnn_scan", symbol, [_I, _I, _P, _I] +
                     [_P] * len(args) + [_I] * (len(ints) - 2) + [_P])
    mode, bf16 = ints[:2]
    vals = (ctypes.c_int * len(PLAN_FIELDS))(*(plan[f] for f in PLAN_FIELDS))
    with torch.cuda.device(dev_tensor.device):
        err = fn(mode, bf16, ctypes.cast(vals, _P), len(PLAN_FIELDS),
                 *[None if a is None else a.data_ptr() for a in args],
                 *ints[2:], _build.stream_of(dev_tensor))
    _build.check(err, symbol)
    bump(_SELF, counter)


def _fwd(mode, pre, h0, c0, w, b_rn, reverse, kw=None):
    G = _GATES[mode]
    what = f"{mode}_scan_fwd"
    if pre.dim() != 3 or pre.shape[-1] % G:
        raise MXNetError(f"{what}: expected pre (T, N, {G}H), got "
                         f"{tuple(pre.shape)}")
    T, N, GH = pre.shape
    H = GH // G
    states = (h0,) + ((c0,) if mode == "lstm" else (b_rn,))
    _check(what, pre.dtype, GH, H, w, pre, *states)
    if any(tuple(t.shape) != (N, H) for t in states[:2 if mode == "lstm"
                                                    else 1]) or \
            (mode == "gru" and tuple(b_rn.shape) != (H,)):
        raise MXNetError(f"{what}: states must be (N, H) = ({N}, {H})")
    dev = pre.device
    P, plan = _plan_or_raise(what, pre.dtype, True, mode, N, H, dev, kw)
    dt = pre.dtype
    hx = _exchange(plan, dt, dev, h0)
    ys = torch.empty(T, N, H, dtype=dt, device=dev)
    hT = torch.empty(N, H, dtype=dt, device=dev)
    saved = torch.empty(T, N, 4 * H, dtype=torch.float32, device=dev)
    lstm = mode == "lstm"
    cT = torch.empty_like(hT) if lstm else None
    cs = torch.empty_like(ys) if lstm else None
    wp = _pack(w, G, True, H, P)
    bar = torch.zeros(1, dtype=torch.int32, device=dev)
    _launch("mxt_rnn_scan_fwd", plan,
            (pre, wp, b_rn, c0, hx, ys, hT, cT, saved, cs, bar),
            (_MODE[mode], int(dt == torch.bfloat16), T, N, H, int(reverse),
             P), pre, f"{mode.upper()}_SCAN_FWD_LAUNCHES")
    return ys, hT, cT, saved, cs


def _bwd(mode, dy, dhT, dcT, saved, cs, c0, ys, h0, w, reverse, kw=None):
    G = _GATES[mode]
    what = f"{mode}_scan_bwd"
    T, N, H = ys.shape
    dt = ys.dtype
    dy, dhT = dy.to(dt).contiguous(), dhT.to(dt).contiguous()
    states = (dy, ys, dhT) + ((dcT, cs, c0) if mode == "lstm" else (h0,))
    _check(what, dt, G * H, H, w, *states)
    if tuple(dy.shape) != (T, N, H) or any(
            tuple(t.shape) != (N, H) for t in states[2:]
            if t.dim() == 2) or (cs is not None and cs.shape != ys.shape):
        raise MXNetError(f"{what}: shapes do not match ys {tuple(ys.shape)}")
    if saved.dtype != torch.float32 or tuple(saved.shape) != (T, N, 4 * H) \
            or not saved.is_contiguous():
        raise MXNetError(f"{what}: saved must be contiguous f32 "
                         f"(T, N, 4H)")
    dev = ys.device
    P, plan = _plan_or_raise(what, dt, False, mode, N, H, dev, kw)
    dx = _exchange(plan, dt, dev)
    dpre = torch.empty(T, N, G * H, dtype=dt, device=dev)
    dhh = torch.empty_like(dpre) if mode == "gru" else None
    dh0 = torch.empty(N, H, dtype=dt, device=dev)
    dc0 = torch.empty_like(dh0) if mode == "lstm" else None
    wp = _pack(w, G, False, H, P)
    bar = torch.zeros(1, dtype=torch.int32, device=dev)
    _launch("mxt_rnn_scan_bwd", plan,
            (dy, dhT, dcT, saved, cs, c0, ys, h0, wp, dx, dpre, dhh, dh0,
             dc0, bar),
            (_MODE[mode], int(dt == torch.bfloat16), T, N, H, int(reverse),
             P), ys, f"{mode.upper()}_SCAN_BWD_LAUNCHES")
    return dpre, dhh, dh0, dc0


def lstm_scan_fwd(pre, h0, c0, w, reverse=False):
    """The forward of one direction: (ys, h_T, c_T, f32 gates, cs); the
    kernel on CUDA tensors, the plain version on CPU tensors."""
    if not on_card(pre, h0, c0, w):
        return lstm_scan_fwd_reference(pre, h0, c0, w, reverse)
    return _fwd("lstm", pre, h0.contiguous(), c0.contiguous(), w, None,
                reverse)


def lstm_scan_bwd(dy, dhT, dcT, gates, cs, c0, w, reverse=False):
    """The backward of one direction: (dpre, dh0, dc0) in ``cs``'s
    type."""
    if not on_card(dy, dhT, dcT, gates, cs, c0, w):
        return lstm_scan_bwd_reference(dy, dhT, dcT, gates, cs, c0, w,
                                       reverse)
    # the LSTM reads c, not h: cs stands in for ys (shapes, type)
    dpre, _, dh0, dc0 = _bwd("lstm", dy, dhT, dcT.to(cs.dtype).contiguous(),
                             gates, cs, c0.contiguous(), cs, None, w,
                             reverse)
    return dpre, dh0, dc0


def gru_scan_fwd(pre, h0, w, b_rn, reverse=False):
    """The forward of one direction: (ys, h_T, f32 saved)."""
    if not on_card(pre, h0, w, b_rn):
        return gru_scan_fwd_reference(pre, h0, w, b_rn, reverse)
    ys, hT, _, saved, _ = _fwd("gru", pre, h0.contiguous(), None, w,
                               b_rn.to(pre.dtype).contiguous(), reverse)
    return ys, hT, saved


def gru_scan_bwd(dy, dhT, saved, ys, h0, w, reverse=False):
    """The backward of one direction: (dpre, dhh, dh0) in ``ys``'s
    type."""
    if not on_card(dy, dhT, saved, ys, h0, w):
        return gru_scan_bwd_reference(dy, dhT, saved, ys, h0, w, reverse)
    dpre, dhh, dh0, _ = _bwd("gru", dy, dhT, None, saved, None, None, ys,
                             h0.contiguous(), w, reverse)
    return dpre, dhh, dh0


# ----------------------------------------------------------------------
# the autograd Functions the RNN op runs a direction through
# ----------------------------------------------------------------------
class _LSTMScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pre, h0, c0, w, reverse):
        ys, hT, cT, gates, cs = lstm_scan_fwd(pre.contiguous(), h0, c0, w,
                                              reverse)
        ctx.save_for_backward(gates, cs, h0, c0, ys, w)
        ctx.reverse = reverse
        return ys, hT, cT

    @staticmethod
    def backward(ctx, dys, dhT, dcT):
        gates, cs, h0, c0, ys, w = ctx.saved_tensors
        dys = torch.zeros_like(ys) if dys is None else dys
        dhT = torch.zeros_like(h0) if dhT is None else dhT
        dcT = torch.zeros_like(c0) if dcT is None else dcT
        dpre, dh0, dc0 = lstm_scan_bwd(dys, dhT, dcT, gates, cs, c0, w,
                                       ctx.reverse)
        return (dpre, dh0.to(h0.dtype), dc0.to(c0.dtype),
                _dw(dpre, ys, h0, ctx.reverse).to(w.dtype), None)


class _GRUScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pre, h0, w, b_rn, reverse):
        ys, hT, saved = gru_scan_fwd(pre.contiguous(), h0, w, b_rn, reverse)
        ctx.save_for_backward(saved, h0, ys, w)
        ctx.reverse = reverse
        ctx.b_dtype = b_rn.dtype
        return ys, hT

    @staticmethod
    def backward(ctx, dys, dhT):
        saved, h0, ys, w = ctx.saved_tensors
        dys = torch.zeros_like(ys) if dys is None else dys
        dhT = torch.zeros_like(h0) if dhT is None else dhT
        dpre, dhh, dh0 = gru_scan_bwd(dys, dhT, saved, ys, h0, w,
                                      ctx.reverse)
        H = ys.shape[-1]
        db_rn = dhh[..., 2 * H:].float().sum((0, 1)).to(ctx.b_dtype)
        return (dpre, dh0.to(h0.dtype),
                _dw(dhh, ys, h0, ctx.reverse).to(w.dtype), db_rn, None)


def lstm_scan(pre, h0, c0, w, reverse=False):
    """One LSTM direction (see the module's docstring): ``(ys, h_T,
    c_T)``."""
    return _LSTMScan.apply(pre, h0, c0, w, bool(reverse))


def gru_scan(pre, h0, w, b_rn, reverse=False):
    """One GRU direction (see the module's docstring): ``(ys, h_T)``."""
    return _GRUScan.apply(pre, h0, w, b_rn, bool(reverse))
