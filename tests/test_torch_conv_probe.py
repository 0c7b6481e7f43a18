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
