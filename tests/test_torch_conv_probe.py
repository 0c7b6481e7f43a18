"""mxtpu_torch's NHWC conv (the port of TPU kernel #13,
``tools/probe_conv_strategies.py:pallas_conv``) and its probe on the
CPU, held against the JAX tool's three strategies.

The same inputs, made from a numpy seed, go to both packages.
``pallas_conv`` runs in Pallas interpret mode: the JAX module's ``pl``
is swapped (``monkeypatch``) for a namespace whose ``pallas_call``
passes ``interpret=True``; nothing under ``tools/`` changes.

Tolerances: f32 within 1e-5 of the output's max (another summation
order over KH*KW*C products); bf16 within one bf16 ulp of the output's
scale (2^-8 of its max): both sides take exact bf16 products, sum them
in f32 and round once, so a sum that differs in its last f32 bit can
move an output across one bf16 rounding boundary.  The CUDA kernel runs
only on the card, through ``chip_smoke.py``.
"""
import functools
import importlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import tools.probe_conv_strategies as jpcs

from mxtpu_torch import MXNetError, kernels as tk
from mxtpu_torch.tools import probe_conv_strategies as tpcs

tconv = importlib.import_module("mxtpu_torch.kernels.conv")

torch.set_num_threads(2)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# (N, H, W, C, O, KH, KW): three small shapes at 3x3 (C != O once), then the
# 1x1, 2x2 and 5x5 kernels
CASES = [(4, 7, 7, 16, 16, 3, 3), (8, 8, 8, 32, 16, 3, 3),
         (4, 5, 5, 16, 16, 3, 3), (4, 7, 7, 16, 16, 1, 1),
         (4, 7, 7, 16, 16, 2, 2), (4, 5, 5, 16, 16, 5, 5)]


@pytest.fixture
def interpret(monkeypatch):
    """``pallas_conv`` through Pallas' interpreter."""
    monkeypatch.setattr(jpcs, "pl", types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec))


def _inputs(case, dtype, seed=0):
    N, H, W, C, O, KH, KW = case
    rng = np.random.RandomState(seed)
    x = rng.randn(N, H, W, C).astype(np.float32)
    w = (rng.randn(KH, KW, C, O) / (KH * np.sqrt(C))).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    return (torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
            jnp.asarray(x, jdt), jnp.asarray(w, jdt))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, dtype):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all() and np.isfinite(want).all()
    scale = float(np.abs(want).max())
    tol = (1e-5 if dtype == "float32" else 2.0 ** -8) * scale
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


# ------------------------------------------- the plain conv vs the JAX tool

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES,
                         ids=["x".join(map(str, c[:5])) + f"_k{c[5]}x{c[6]}"
                              for c in CASES])
def test_plain_conv_matches_the_jax_strategies(case, dtype, interpret):
    x, w, jx, jw = _inputs(case, dtype)
    got = tconv.conv_nhwc_reference(x, w)
    assert got.dtype == x.dtype and got.shape == (*x.shape[:3], w.shape[3])
    _close(got, jpcs.shifted_gemm_conv(jx, jw), dtype)
    for bn in (2, 4):
        assert x.shape[0] % bn == 0
        _close(got, jpcs.pallas_conv(jx, jw, bn=bn), dtype)
    if case[5] % 2 and case[6] % 2:
        # odd kernels: KH//2 on both sides is XLA's SAME
        _close(got, jpcs.xla_conv(jx, jw), dtype)


def test_even_kernel_follows_pallas_conv_not_xla_same(interpret):
    # the reference pads KH//2 on both sides and keeps the top-left H x W;
    # XLA's SAME pads (KH-1)//2 before and KH//2 after
    x, w, jx, jw = _inputs((4, 7, 7, 16, 16, 2, 2), "float32")
    got = tconv.conv_nhwc_reference(x, w)
    _close(got, jpcs.pallas_conv(jx, jw, bn=2), "float32")
    _close(got, jpcs.shifted_gemm_conv(jx, jw), "float32")
    assert float(np.abs(_f32(got) - _f32(jpcs.xla_conv(jx, jw))).max()) > 0.5


def test_every_image_is_computed_where_pallas_conv_leaves_rows(interpret):
    # pallas_conv's grid is N // bn: with N = 10 and bn = 4 images 8-9 are
    # never written (NaN in interpret mode); the port takes no bn
    x, w, jx, jw = _inputs((10, 7, 7, 16, 16, 3, 3), "float32")
    ref = _f32(jpcs.pallas_conv(jx, jw, bn=4))
    assert np.isnan(ref[8:]).all() and np.isfinite(ref[:8]).all()
    got = tconv.conv_nhwc_reference(x, w)
    _close(got, jpcs.xla_conv(jx, jw), "float32")
    _close(got[:8], ref[:8], "float32")


# ------------------------------- the bf16 kernel's tiling, emulated

BM, BKC = 128, 64  # pixels per CTA, channels per K chunk (conv_nhwc.cu)


def _walk(m0, N, H, W, ph, pw):
    """The (n, h, w) bases of the 128 pixels an im2col load walks from
    the flattened pixel m0: W first, then H, then N, inside the bounding
    box whose corners are (-ph, -pw) at both ends (the upper corner
    counts from the image's last row and column); past the last image
    the n is N (zero fill)."""
    t, w0 = divmod(m0, W)
    n, h0 = divmod(t, H)
    bh, bw = h0 - ph, w0 - pw
    out = []
    for _ in range(BM):
        out.append((n, bh, bw))
        bw += 1
        if bw > W - 1 - pw:
            bw, bh = -pw, bh + 1
            if bh > H - 1 - ph:
                bh, n = -ph, n + 1
    return out


def emulated_conv(x, w):
    """y as ``conv_nhwc_wgmma_kernel`` computes it: 128-pixel tiles over
    the flattened N*H*W; per tile an f32 sum over (kh, kw, 64-channel
    chunk) of A (the im2col load: each pixel's base + (kh, kw), zero off
    the image, past C and past the last image) times B (a 64-row chunk
    of w viewed as (KH*KW, C, O), zero past C); one rounding to x's
    type.  The O tiles are column slices and change nothing."""
    N, H, W, C = x.shape
    KH, KW, _, O = w.shape
    ph, pw = KH // 2, KW // 2
    xf = x.float()
    w3 = w.float().reshape(KH * KW, C, O)
    M = N * H * W
    y = torch.zeros(M, O)
    for m0 in range(0, M, BM):
        base = torch.tensor(_walk(m0, N, H, W, ph, pw))
        acc = torch.zeros(BM, O)
        for kh in range(KH):
            for kw in range(KW):
                n, ih, iw = base[:, 0], base[:, 1] + kh, base[:, 2] + kw
                inside = (n < N) & (ih >= 0) & (ih < H) & (iw >= 0) & \
                    (iw < W)
                rows = xf[n.clamp(max=N - 1), ih.clamp(0, H - 1),
                          iw.clamp(0, W - 1)] * inside[:, None]
                for c0 in range(0, C, BKC):
                    a = torch.zeros(BM, BKC)
                    b = torch.zeros(BKC, O)
                    a[:, :min(BKC, C - c0)] = rows[:, c0:c0 + BKC]
                    b[:min(BKC, C - c0)] = w3[kh * KW + kw, c0:c0 + BKC]
                    acc += a @ b
        y[m0:m0 + BM] = acc[:min(BM, M - m0)]
    return y.reshape(N, H, W, O).to(x.dtype)


# a pixel tile that spans images (81 pixels an image, O off 64), the
# 2x2 even kernel over a tile past the last pixel, and C and O off 8
# (the wrapper's zero-padded copies)
TILING_CASES = CASES + [(3, 9, 9, 16, 24, 3, 3), (5, 6, 6, 72, 8, 2, 2),
                        (2, 5, 5, 12, 4, 3, 3)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", TILING_CASES,
                         ids=["x".join(map(str, c[:5])) + f"_k{c[5]}x{c[6]}"
                              for c in TILING_CASES])
def test_kernel_tiling_matches_pallas_conv(case, dtype, interpret):
    x, w, jx, jw = _inputs(case, dtype)
    got = emulated_conv(*tconv._pad_channels(x, w))[..., :case[4]]
    assert got.dtype == x.dtype
    _close(got, tconv.conv_nhwc_reference(x, w), dtype)
    bn = 1 if case[0] % 2 else 2
    _close(got, jpcs.pallas_conv(jx, jw, bn=bn), dtype)


def test_the_walk_spans_images_and_pads():
    # 7x7 images: a 128-pixel tile holds two whole images and 30 pixels
    # of the third; the walk's bases run from -1 to 5 in each direction
    walk = _walk(0, 4, 7, 7, 1, 1)
    assert [n for n, _, _ in walk].count(0) == 49 and walk[98][0] == 2
    assert walk[0] == (0, -1, -1) and walk[48] == (0, 5, 5)
    assert walk[49] == (1, -1, -1) and walk[127] == (2, 3, 0)
    # the even kernel's box is as wide: H x W bases from -1
    walk = _walk(128, 5, 6, 6, 1, 1)
    assert walk[0] == (3, 2, 1) and len({(h, w_) for _, h, w_ in walk}) \
        == 36


# ------------------------------------------------ channels off 8 (2a)

@pytest.mark.parametrize("C,O", [(12, 4), (12, 16), (16, 4), (3, 5)])
def test_channel_padding_changes_nothing(C, O):
    # conv_nhwc runs the kernel on copies zero-padded to multiples of 8
    # and slices y back; the padded conv, sliced, is the unpadded one
    x, w, _, _ = _inputs((2, 5, 5, C, O, 3, 3), "bfloat16")
    px, pw_ = tconv._pad_channels(x, w)
    assert px.shape[-1] % 8 == 0 and pw_.shape[2:] == (px.shape[-1],
                                                       -O % 8 + O)
    assert not px[..., C:].any() and not pw_[:, :, C:].any() and \
        not pw_[..., O:].any()
    tconv._check(px, pw_)
    want = tconv.conv_nhwc_reference(x, w)
    assert torch.equal(tconv.conv_nhwc_reference(px, pw_)[..., :O], want)
    assert torch.equal(emulated_conv(px, pw_)[..., :O], want)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_only_the_bf16_kernel_bounds_the_kernel_size(dtype):
    # the im2col offsets bound KH and KW by 255 in bf16 (conv_nhwc.cu's
    # entry point); the f32 kernel, like pallas_conv, takes any size
    dt = getattr(torch, dtype)
    x = torch.zeros(1, 4, 4, 8, dtype=dt)
    for KH, KW in ((256, 1), (1, 300)):
        w = torch.zeros(KH, KW, 8, 8, dtype=dt)
        if dtype == "bfloat16":
            with pytest.raises(MXNetError, match="bound of 255"):
                tconv._check(x, w)
        else:
            assert tconv._check(x, w)[4:6] == (KH, KW)
    tconv._check(x, torch.zeros(255, 3, 8, 8, dtype=dt))


def test_channels_on_8_are_not_copied():
    x, w, _, _ = _inputs(CASES[1], "bfloat16")
    px, pw_ = tconv._pad_channels(x, w)
    assert px is x and pw_ is w


# ------------------------------------------------------------- dispatch

def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    tk.reset_launch_counts()
    x, w, _, _ = _inputs(CASES[0], "bfloat16")
    assert torch.equal(tk.conv_nhwc(x, w), tconv.conv_nhwc_reference(x, w))
    x, w, _, _ = _inputs(CASES[4], "float32")
    assert torch.equal(tk.conv_nhwc(x, w), tconv.conv_nhwc_reference(x, w))
    assert tk.launch_counts()["conv_nhwc"] == 0


def test_the_wrapper_refuses_inputs_that_require_grad():
    # no backward on any device, as the TPU kernel has none
    x, w, _, _ = _inputs(CASES[0], "float32")
    for args in ((x.requires_grad_(True), w), (x.detach(),
                                               w.requires_grad_(True))):
        with pytest.raises(MXNetError, match="conv_nhwc: inputs require "
                                             "grad.*no backward"):
            tk.conv_nhwc(*args)
    with torch.no_grad():
        tk.conv_nhwc(*args)


@pytest.mark.parametrize("bad,match", [
    (lambda x, w: (x[..., :12].contiguous(), w[:, :, :12]
                   .contiguous()), "multiples of 8"),
    (lambda x, w: (x, w[..., :4].contiguous()), "multiples of 8"),
    (lambda x, w: (x.double(), w.double()), "float32 or bfloat16"),
    (lambda x, w: (x, w.bfloat16()), "float32 or bfloat16"),
    (lambda x, w: (x.transpose(1, 2), w), "contiguous"),
    (lambda x, w: (x[:0], w), "empty"),
    (lambda x, w: (x, w[:, :, :8]), "takes 8 channels"),
    (lambda x, w: (x[0], w), r"\(N, H, W, C\)")])
def test_the_kernel_bounds_refuse(bad, match):
    # the check the wrapper runs before a launch, on CPU tensors
    x, w, _, _ = _inputs(CASES[0], "float32")
    with pytest.raises(MXNetError, match=match):
        tconv._check(*bad(x, w))


def test_the_kernel_bounds_admit_the_probe_and_edge_shapes():
    for (N, H, W, C, O, KH, KW) in [(256, 14, 14, 256, 256, 3, 3),
                                    (1, 5, 5, 16, 32, 5, 5),
                                    (2, 6, 6, 32, 16, 2, 2),
                                    (3, 7, 7, 24, 40, 1, 1)]:
        tconv._check(torch.empty(N, H, W, C, dtype=torch.bfloat16),
                     torch.empty(KH, KW, C, O, dtype=torch.bfloat16))


@pytest.mark.cuda
def test_kernel_matches_its_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU path")
    for case in CASES:
        for dtype in DTYPES:
            x, w, _, _ = _inputs(case, dtype)
            x, w = x.cuda(), w.cuda()
            _close(tk.conv_nhwc(x, w).cpu(),
                   tconv.conv_nhwc_reference(x, w).cpu(), dtype)


@pytest.mark.cuda
def test_kernel_matches_its_plain_version_at_the_tiling_cases_on_the_card():
    # pixel tiles across images, the 2x2 kernel past the last pixel, and
    # C = 12, O = 4 through the wrapper's padded copies
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU path")
    for case in TILING_CASES[len(CASES):]:
        for dtype in DTYPES:
            x, w, _, _ = _inputs(case, dtype)
            x, w = x.cuda(), w.cuda()
            _close(tk.conv_nhwc(x, w).cpu(),
                   tconv.conv_nhwc_reference(x, w).cpu(), dtype)


# ---------------------------------------------------------------- probe

def test_probe_strategies_match_the_jax_tool(interpret):
    x, w, jx, jw = _inputs(CASES[1][:4] + (32, 3, 3), "float32")
    S = tpcs.STRATEGIES
    _close(S["cudnn"](w)(x), jpcs.xla_conv(jx, jw), "float32")
    _close(S["shifted_gemm"](w)(x), jpcs.shifted_gemm_conv(jx, jw),
           "float32")
    _close(S["kernel"](w)(x), jpcs.pallas_conv(jx, jw, bn=4), "float32")


def test_probe_shapes_are_the_jax_tools():
    assert tpcs.SHAPES == ((14, 256), (28, 128), (7, 512)) and tpcs.N == 256


def test_run_shape_prints_three_rows(capsys):
    rows = tpcs.run_shape(4, 5, 16, "cpu", n=2)
    out = capsys.readouterr().out
    assert [r["name"] for r in rows] == ["cudnn", "shifted_gemm", "kernel"]
    assert all(r["status"] == "ok" and r["ms"] > 0 for r in rows)
    assert "FAILED" not in out
    assert sum(f"{n:14s}:" in out for n in tpcs.STRATEGIES) == 3
    # the kernel row is the plain version on the CPU: against the
    # library's f32-accumulated bf16 conv, one rounding (an ulp below 8)
    assert rows[2]["max_abs_err"] <= 2.0 ** -5


def test_run_shape_reports_a_failing_strategy(monkeypatch, capsys):
    def boom(w):
        raise MXNetError("no launch")
    monkeypatch.setitem(tpcs.STRATEGIES, "kernel", boom)
    rows = tpcs.run_shape(2, 5, 16, "cpu", n=1)
    assert rows[2]["status"] == "FAILED" and "no launch" in rows[2]["error"]
    assert "FAILED MXNetError: no launch" in capsys.readouterr().out
