"""The f32 kernels on the tensor cores (``fa_fwd_f32_wgmma_kernel`` in
``mxtpu_torch/csrc/flash_attention.cu``, ``conv_nhwc_f32_wgmma_kernel``
in ``csrc/conv_nhwc.cu``), emulated in plain PyTorch on the CPU.

Both kernels split every f32 operand exactly into three bf16 parts, x =
hi + mid + lo (``split3`` in ``csrc/hopper.cuh``: hi is x with its low
16 bits cleared, mid the same of x - hi, lo the rest rounded to bf16),
and take a product as the six part products that matter, smallest
first, into one f32 accumulator: what the TPU does for f32 at
Precision.HIGHEST.  Below: the split's plain twin, bit for bit; the
flash forward tile by tile (128 query rows a CTA for D <= 64, 64 above,
64-key tiles, the online softmax, six products on S and on P.V) against
mxtpu's Pallas ``_flash_forward`` in f32, run in interpret mode; the
conv's walk over the six (x part, w part) pairs, with x's parts stacked
as 3N images, against ``pallas_conv`` (interpret) and ``xla_conv``.
Each is held to the card's f32 gate (``chip_smoke.py``: |r - p| <=
1e-4 * max(1, |p|)); the same emulation with one bf16 product misses
it, which is why the kernels split.
"""
import importlib
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tools.probe_conv_strategies as jpcs

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))
import chip_smoke  # noqa: E402
from test_torch_conv_probe import (BKC, BM, TILING_CASES,  # noqa: E402
                                   _walk, interpret)  # noqa: F401

tfa = importlib.import_module("mxtpu_torch.kernels.flash_attention")
tconv = importlib.import_module("mxtpu_torch.kernels.conv")
jfa = importlib.import_module("mxtpu.kernels.flash_attention")

torch.set_num_threads(2)

GATE = chip_smoke.TOL["float32"]
# the six pairs (A's part, B's part), smallest product first; 0 hi, 1
# mid, 2 lo (hopper.cuh: split_a, split_b)
PAIRS = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))
_HI16 = -65536          # 0xFFFF0000 as an int32
_SIGN = -2 ** 31        # 0x80000000
_EXP = 0x7F800000
FLT_MAX = float(np.finfo(np.float32).max)
FLT_MIN = float(np.finfo(np.float32).tiny)


def split3(x: torch.Tensor):
    """The plain twin of ``split3``: f32 x -> (hi, mid, lo) as f32
    tensors each holding a bf16 exactly."""
    b = x.view(torch.int32)
    sign = b & _SIGN
    hi = (b & _HI16).view(torch.float32)
    r1 = (x - hi).view(torch.int32) | sign
    mid = (r1 & _HI16).view(torch.float32)
    r2 = ((r1.view(torch.float32) - mid).view(torch.int32) | sign) \
        .view(torch.float32)
    lo = r2.to(torch.bfloat16).float()
    finite = (b & _EXP) != _EXP
    zero = torch.zeros_like(x)
    return (torch.where(finite, hi, x), torch.where(finite, mid, zero),
            torch.where(finite, lo, zero))


def _bits(x):
    return x.view(torch.int32)


# ------------------------------------------------------------ (a) split

def _edge_values():
    rng = np.random.RandomState(0)
    x = rng.randn(100_000).astype(np.float32)
    scaled = np.concatenate([x * s for s in (1.0, 1e-30, 1e30, 2.0 ** -100)])
    edges = np.array([0.0, -0.0, FLT_MIN, -FLT_MIN, 1.5 * FLT_MIN,
                      FLT_MIN * (1 + 2.0 ** -7), 2.0 ** -110 * 1.7,
                      FLT_MAX, -FLT_MAX, 1.0, -1.0, 3.0 ** 20],
                     np.float32)
    return torch.from_numpy(np.concatenate([scaled.astype(np.float32),
                                            edges]))


def test_split_rebuilds_x_bit_for_bit():
    # exact wherever x's lowest set bit is at least 2^-133 (the smallest
    # bf16 subnormal): every |x| >= 2^-110 and each hand-picked edge
    # value (FLT_MIN, 1.5 FLT_MIN, FLT_MIN (1 + 2^-7), ...); the randn
    # draws scaled by 1e-30 that fall under 2^-110 lose less than 2^-133
    x = _edge_values()
    hi, mid, lo = split3(x)
    for part in (hi, mid, lo):
        assert torch.equal(_bits(part.to(torch.bfloat16).float()),
                           _bits(part))
    back = (hi + mid) + lo
    exact = (x.abs() >= 2.0 ** -110) | (x == 0)
    exact[-12:] = True
    assert int(exact.sum()) > 390_000
    assert torch.equal(_bits(back[exact]), _bits(x[exact]))
    assert ((back - x).abs() < 2.0 ** -133).all()
    # -0 splits into -0 parts, so the sum keeps the sign
    assert _bits(split3(torch.tensor([-0.0]))[1]).item() == _SIGN


def test_split_parts_shrink_by_2_to_8():
    x = _edge_values()
    x = x[(x != 0) & (x.abs() > 2.0 ** -100)]
    hi, mid, lo = split3(x)
    assert (mid.abs() <= x.abs() * 2.0 ** -7).all()
    assert (lo.abs() <= x.abs() * 2.0 ** -15).all()


def test_truncation_never_overflows_where_rounding_does():
    x = torch.tensor([FLT_MAX, -FLT_MAX])
    assert torch.isinf(x.to(torch.bfloat16).float()).all()
    hi, mid, lo = split3(x)
    assert torch.isfinite(hi).all() and torch.equal(hi + mid + lo, x)


def test_non_finite_splits_as_x_zero_zero():
    x = torch.tensor([float("inf"), -float("inf"), float("nan")])
    hi, mid, lo = split3(x)
    assert torch.equal(hi[:2], x[:2]) and torch.isnan(hi[2])
    assert not mid.any() and not lo.any()


def test_below_the_smallest_bf16_subnormal_the_loss_is_under_it():
    # bf16 keeps f32's exponent range down to 2^-133: below that a bit
    # of x has no part to go to
    x = torch.tensor([2.0 ** -149, 2.0 ** -140 * 1.75, FLT_MIN * 1.999])
    hi, mid, lo = split3(x)
    assert ((hi + mid + lo - x).abs() < 2.0 ** -133).all()


def _one_product(a, b):
    """What a single bf16 product would give: each side rounded."""
    return torch.matmul(a.to(torch.bfloat16).float(),
                        b.to(torch.bfloat16).float())


def _six_products(a, b):
    """a @ b as the kernels take it: the six part products, smallest
    first, into one f32 sum."""
    pa, pb = split3(a.contiguous()), split3(b.contiguous())
    acc = torch.zeros(*a.shape[:-1], b.shape[-1])
    for i, j in PAIRS:
        acc = acc + torch.matmul(pa[i], pb[j])
    return acc


def test_six_products_match_f64_where_one_bf16_product_does_not():
    rng = np.random.RandomState(1)
    a = torch.from_numpy(rng.randn(128, 64).astype(np.float32))
    b = torch.from_numpy(rng.randn(64, 128).astype(np.float32))
    want = a.double() @ b.double()
    six = float((_six_products(a, b).double() - want).abs().max())
    plain = float(((a @ b).double() - want).abs().max())
    one = float((_one_product(a, b).double() - want).abs().max())
    assert six <= 2 * plain and one > 100 * six


# ---------------------------------------------- (b) the flash forward

KEY_TILE = 64


def emulated_flash(q, k, v, causal, scale, delta=None, product=None):
    """(O, lse) of ``fa_fwd_f32_wgmma_kernel`` from f32 q (BH, Tq, D),
    k, v (BH, Tk, D): CTAs of 128 query rows (64 for D > 64), 64-key
    tiles (those wholly past the diagonal skipped), the online softmax
    in f32 with the -1e30 sentinel, S and P.V through ``product``."""
    product = product or _six_products
    BH, Tq, D = q.shape
    Tk = k.shape[1]
    d = Tk - Tq if delta is None else delta
    rows = 128 if D <= 64 else 64
    o = torch.zeros(BH, Tq, D)
    lse = torch.zeros(BH, Tq)
    for q0 in range(0, Tq, rows):
        r = slice(q0, min(q0 + rows, Tq))
        nk = (Tk + KEY_TILE - 1) // KEY_TILE
        if causal:
            last = q0 + rows - 1 + d
            nk = min(nk, 0 if last < 0 else last // KEY_TILE + 1)
        n = r.stop - q0
        m = torch.full((BH, n), -1e30)
        l = torch.zeros(BH, n)
        acc = torch.zeros(BH, n, D)
        for t in range(nk):
            keys = torch.arange(t * KEY_TILE, min(t * KEY_TILE + KEY_TILE,
                                                  Tk))
            s = product(q[:, r], k[:, keys].transpose(1, 2)) * scale
            if causal:
                seen = keys[None, :] <= torch.arange(q0, r.stop)[:, None] + d
                s = torch.where(seen, s, torch.full_like(s, -1e30))
            mn = torch.maximum(m, s.amax(-1))
            al = torch.exp(m - mn)
            p = torch.exp(s - mn[..., None])
            l = al * l + p.sum(-1)
            acc = acc * al[..., None] + product(p, v[:, keys])
            m = mn
        masked = m == -1e30
        safe = torch.where(l == 0, torch.ones_like(l), l)
        o[:, r] = torch.where(masked[..., None], torch.zeros_like(acc),
                              acc / safe[..., None])
        lse[:, r] = torch.where(masked, torch.full_like(m, 1e30),
                                m + torch.log(safe))
    return o, lse


def _pallas_forward(q, k, v, causal, scale, delta):
    jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))
    o, lse = jfa._flash_forward(jq, jk, jv, causal, scale, True,
                                delta=delta)
    return (torch.from_numpy(np.array(o)),
            torch.from_numpy(np.array(lse))[..., 0])


def _qkv(seed, BH, Tq, Tk, D):
    rng = np.random.RandomState(seed)
    q = rng.randn(BH, Tq, D).astype(np.float32)
    k, v = (rng.randn(BH, Tk, D).astype(np.float32) for _ in range(2))
    return tuple(torch.from_numpy(t) for t in (q, k, v))


# (causal, Tq, Tk, D, delta): full and causal tiles, two CTAs of rows,
# D = 128 (64-row CTAs, two column boxes), Tq != Tk, an explicit
# diagonal, rows that see no key (Tq > Tk), D off 64
FLASH_CASES = [(False, 128, 128, 64, None), (True, 128, 128, 64, None),
               (True, 256, 256, 64, None), (False, 192, 192, 128, None),
               (True, 64, 192, 64, None), (True, 96, 160, 64, 3),
               (True, 128, 64, 64, None), (True, 70, 90, 40, -5)]


@pytest.mark.parametrize("causal,Tq,Tk,D,delta", FLASH_CASES)
def test_flash_split_matches_pallas_forward(causal, Tq, Tk, D, delta):
    q, k, v = _qkv(0, 2, Tq, Tk, D)
    scale = 1.0 / D ** 0.5
    o, lse = emulated_flash(q, k, v, causal, scale, delta)
    wo, wlse = _pallas_forward(q, k, v, causal, scale, delta)
    assert torch.isfinite(o).all() and o.shape == wo.shape
    assert chip_smoke.rel_err(o, wo)[0] <= GATE
    assert chip_smoke.rel_err(lse, wlse)[0] <= GATE
    if causal and Tq > Tk and delta is None:
        blind = slice(0, Tq - Tk)   # rows whose first key is past Tk
        assert not o[:, blind].any() and (lse[:, blind] == 1e30).all()


def test_flash_one_bf16_product_misses_the_gate():
    q, k, v = _qkv(0, 2, 128, 128, 64)
    o, _ = emulated_flash(q, k, v, False, 0.125, product=_one_product)
    wo, _ = _pallas_forward(q, k, v, False, 0.125, None)
    assert chip_smoke.rel_err(o, wo)[0] > GATE


def test_flash_split_matches_the_ports_plain_version_at_long_causal_t():
    q, k, v = _qkv(1, 1, 1024, 1024, 64)
    o, lse = emulated_flash(q, k, v, True, 0.125)
    po, plse = tfa.flash_forward_reference(q, k, v, True, 0.125)
    assert chip_smoke.rel_err(o, po)[0] <= GATE
    assert chip_smoke.rel_err(lse, plse)[0] <= GATE


# ------------------------------------------------------- (c) the conv

def emulated_split_conv(x, w, one_product=False):
    """y as ``conv_nhwc_f32_wgmma_kernel`` computes it from f32 x (N, H,
    W, C) and w (KH, KW, C, O), C and O multiples of 8: x's three parts
    stacked as 3N images, w's as 3*KH*KW taps; 128-pixel tiles over the
    flattened N*H*W; per tile an f32 sum over (pair, kh, kw, 64-channel
    chunk); a load that runs past the last image of a part reads the
    next part's first images, into rows past N*H*W that are dropped.
    With ``one_product`` each side is rounded to bf16 once instead."""
    N, H, W, C = x.shape
    KH, KW, _, O = w.shape
    ph, pw = KH // 2, KW // 2
    if one_product:
        xs = x.to(torch.bfloat16).float()
        ws = w.to(torch.bfloat16).float().reshape(KH * KW, C, O)
        pairs = ((0, 0),)
    else:
        xs = torch.cat(split3(x))
        ws = torch.cat([p.reshape(KH * KW, C, O) for p in split3(w)])
        pairs = PAIRS
    images = xs.shape[0]
    M = N * H * W
    y = torch.zeros(M, O)
    for m0 in range(0, M, BM):
        base = torch.tensor(_walk(m0, N, H, W, ph, pw))
        acc = torch.zeros(BM, O)
        for a, b in pairs:
            for kh in range(KH):
                for kw in range(KW):
                    n = base[:, 0] + a * N
                    ih, iw = base[:, 1] + kh, base[:, 2] + kw
                    inside = (n < images) & (ih >= 0) & (ih < H) & \
                        (iw >= 0) & (iw < W)
                    rows = xs[n.clamp(max=images - 1), ih.clamp(0, H - 1),
                              iw.clamp(0, W - 1)] * inside[:, None]
                    tap = ws[b * KH * KW + kh * KW + kw]
                    for c0 in range(0, C, BKC):
                        acc += rows[:, c0:c0 + BKC] @ tap[c0:c0 + BKC]
        y[m0:m0 + BM] = acc[:min(BM, M - m0)]
    return y.reshape(N, H, W, O)


def _conv_inputs(case, seed=0):
    N, H, W, C, O, KH, KW = case
    rng = np.random.RandomState(seed)
    x = rng.randn(N, H, W, C).astype(np.float32)
    w = (rng.randn(KH, KW, C, O) / (KH * np.sqrt(C))).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(w), jnp.asarray(x), \
        jnp.asarray(w)


def _to_torch(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("case", TILING_CASES,
                         ids=["x".join(map(str, c[:5])) + f"_k{c[5]}x{c[6]}"
                              for c in TILING_CASES])
def test_conv_split_matches_pallas_conv(case, interpret):
    x, w, jx, jw = _conv_inputs(case)
    px, pw_ = tconv._pad_channels(x, w)
    got = emulated_split_conv(px, pw_)[..., :case[4]]
    bn = 1 if case[0] % 2 else 2
    assert torch.isfinite(got).all()
    assert chip_smoke.rel_err(got, _to_torch(
        jpcs.pallas_conv(jx, jw, bn=bn)))[0] <= GATE
    if case[5] % 2 and case[6] % 2:   # odd kernels: XLA's SAME
        assert chip_smoke.rel_err(got, _to_torch(
            jpcs.xla_conv(jx, jw)))[0] <= GATE


def test_conv_one_bf16_product_misses_the_gate():
    x, w, jx, jw = _conv_inputs((4, 7, 7, 64, 64, 3, 3))
    got = emulated_split_conv(x, w, one_product=True)
    assert chip_smoke.rel_err(got, _to_torch(jpcs.xla_conv(jx, jw)))[0] \
        > GATE


def test_conv_loads_past_a_part_land_only_in_dropped_rows():
    # 5x5 images: the last tile's walk runs 103 pixels past the last
    # image, into the next part's first images; y is the same as with
    # each part read on its own (zeros past the last image)
    x, w, _, _ = _conv_inputs((1, 5, 5, 8, 8, 3, 3))
    got = emulated_split_conv(x, w)
    want = sum(tconv.conv_nhwc_reference(split3(x)[a], split3(w)[b])
               for a, b in PAIRS)
    assert chip_smoke.rel_err(got, want)[0] <= 1e-6
