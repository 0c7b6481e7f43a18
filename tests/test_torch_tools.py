"""The port's chained-measurement tools (``mxtpu_torch/tools/``) on the
CPU, each held against its JAX twin under ``tools/``.

One chained step of each tool goes through both packages on the same
numpy inputs, in f32 at tiny sizes: ``bench_flash.fwdbwd_chain`` over
the plain attention against the JAX tool's over mxtpu's
``attention_reference``, and ``probe_bn_fusion``'s BN+ReLU chains
(forward, the gradient of the quadratic loss, the grad step) against
the JAX tool's over ``bn_act_reference``; the JAX steps are taken from
the JAX tool itself by replacing its ``sustained`` with a recorder.
Tolerance 1e-5 of the reference's max (f32 in another summation
order).  The tools' timings mean nothing here: on the CPU they time the
plain versions.
"""
import ast
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tools.bench_flash as jbf
import tools.probe_bn_fusion as jbn
from mxtpu.kernels.flash_attention import \
    attention_reference as jattention_reference
from mxtpu.kernels.batch_norm import bn_act_reference as jbn_act_reference

from mxtpu_torch import MXNetError, kernels as tk
from mxtpu_torch.kernels.flash_attention import attention_reference
from mxtpu_torch.tools import (bench_flash, microbench, probe_bn_fusion,
                               probe_conv_strategies)

REPO = Path(__file__).resolve().parent.parent

torch.set_num_threads(2)


def _close(got, want, tol=1e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# ------------------------------------------------------------ sustained

@pytest.mark.parametrize("n,repeats", [(5, 3), (2, 1)])
def test_sustained_chains_every_call(n, repeats):
    seen = []

    def apply_fn(x):
        seen.append(float(x[0]))
        return x + 1.0
    t = microbench.sustained(apply_fn, torch.zeros(4), n=n, repeats=repeats)
    assert t > 0
    assert len(seen) == n * (repeats + 1)
    # each chain starts at x0 and feeds every output to the next call
    assert seen == [float(i) for _ in range(repeats + 1) for i in range(n)]


def test_microbench_tables_on_the_cpu(capsys):
    rows = microbench.bench_matmul("cpu", shapes=((64, 32),), n=2)
    assert rows[0]["M"] == 64 and rows[0]["tflops"] > 0
    rows = microbench.bench_conv("cpu", shapes=((5, 16, 2),), n=2)
    assert rows[0]["H"] == 5 and rows[0]["ms"] > 0
    out = capsys.readouterr().out
    assert "(64,32)@(32,32)" in out and "b2 5x5 C=16" in out
    assert microbench.conv_flops(256, 14, 14, 256, 256) == \
        2 * 256 * 14 * 14 * 256 * 256 * 9


def test_tool_shapes_are_the_jax_tools():
    src = (REPO / "tools" / "microbench.py").read_text()
    for shape in microbench.MATMUL_SHAPES + microbench.CONV_SHAPES:
        assert str(shape) in src
    assert bench_flash.TS == (512, 2048, 4096)
    assert [s[:3] for s in probe_bn_fusion.STAGES] == [
        ("stem112", 64, 112), ("s1_56", 256, 56), ("s2_28", 512, 28),
        ("s3_14", 1024, 14), ("s4_7", 2048, 7)]


@pytest.mark.parametrize("tool", [microbench, probe_conv_strategies,
                                  bench_flash, probe_bn_fusion])
def test_entry_points_run_on_the_card_by_default(tool):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default would be cuda:0")
    with pytest.raises(MXNetError, match="CUDA is not available"):
        tool.main([])


def test_port_imports_no_jax_tool():
    files = sorted((REPO / "mxtpu_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{f.relative_to(REPO)}: {n}" for n in names
                    if n.split(".")[0] == "tools"]
    assert not bad, bad


# ---------------------------------------------------------- bench_flash

def test_bench_flash_chain_matches_the_jax_tool():
    B, H, T, D = 1, 2, 16, 8
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(B, H, T, D).astype(np.float32) for _ in range(3))
    jattn = functools.partial(jattention_reference, causal=True)
    want = jbf.fwdbwd_chain(jattn, *map(jnp.asarray, (q, k, v)), j=2)(
        jnp.asarray(q))
    got = bench_flash.fwdbwd_chain(bench_flash.PATHS["fallback"],
                                   *map(_t, (q, k, v)), j=2)(_t(q))
    _close(got, want)
    # the gradient that the step folds in (1e-6 of it is below the
    # resolution of q), against jax.grad of the JAX tool's loss
    jg = jax.grad(lambda q_: jnp.sum(jattn(q_, jnp.asarray(k),
                                           jnp.asarray(v)) ** 2))(
        jnp.asarray(q))
    q_ = _t(q).requires_grad_(True)
    tg, = torch.autograd.grad(attention_reference(
        q_, _t(k), _t(v), causal=True).pow(2).sum(), q_)
    _close(tg, jg)


@pytest.mark.parametrize("path", ["flash", "sdpa"])
def test_bench_flash_paths_agree_on_the_cpu(path):
    # the kernel path (its plain version on the CPU) and SDPA take the
    # same step as the fallback
    rng = np.random.RandomState(1)
    q, k, v = (_t(rng.randn(1, 2, 16, 8)) for _ in range(3))
    want = bench_flash.fwdbwd_chain(bench_flash.PATHS["fallback"], q, k, v,
                                    j=2)(q)
    _close(bench_flash.fwdbwd_chain(bench_flash.PATHS[path], q, k, v,
                                    j=2)(q), want)


def test_bench_flash_run_prints_a_row_per_path(capsys):
    tk.reset_launch_counts()
    rows = bench_flash.run(16, B=1, H=2, D=8, j=1, n=1, device="cpu")
    assert [r["name"] for r in rows] == ["flash", "fallback", "sdpa"]
    assert all(r["status"] == "ok" and r["ms"] > 0 for r in rows)
    out = capsys.readouterr().out
    assert "FAILED" not in out and "speedup flash/fallback" in out
    assert set(tk.launch_counts().values()) == {0}


# ------------------------------------------------------ probe_bn_fusion

def _jax_steps(monkeypatch, shape, K, grad):
    """The JAX tool's step and x0 for oracle mode, recorded from its
    ``bn_chain_time`` in place of ``sustained``."""
    seen = {}

    def record(step, x0, n=8, repeats=2):
        seen["step"], seen["x0"] = step, x0
        return 1.0
    monkeypatch.setattr(jbn, "sustained", record)
    jbn.bn_chain_time(shape, jnp.float32, "relu", "oracle", K=K, grad=grad)
    return seen["step"], np.asarray(seen["x0"])


def _free(fn, name):
    """A closure variable of ``fn``."""
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


@pytest.mark.parametrize("mode", ["oracle", "kernel", "library"])
def test_bn_chain_matches_the_jax_tool(monkeypatch, mode):
    shape, K = (2, 8, 6, 6), 3
    # the JAX tool's inputs: RandomState(0), x0 then gamma then beta
    rng = np.random.RandomState(0)
    x0 = rng.randn(*shape)
    g = rng.rand(shape[1]).astype(np.float32) + 0.5
    b = rng.randn(shape[1]).astype(np.float32)
    layer = probe_bn_fusion.bn_layer(mode, _t(g), _t(b), "relu")

    jfwd, jx0 = _jax_steps(monkeypatch, shape, K, grad=False)
    np.testing.assert_array_equal(jx0, x0.astype(np.float32))
    _close(probe_bn_fusion.chain_forward(layer, K)(_t(x0)),
           jfwd(jnp.asarray(jx0)))

    jstep, _ = _jax_steps(monkeypatch, shape, K, grad=True)
    x_ = _t(x0).requires_grad_(True)
    dx, = torch.autograd.grad(probe_bn_fusion.chain_loss(layer, K)(x_), x_)
    _close(dx, _free(jstep, "gf")(jnp.asarray(jx0)))
    _close(probe_bn_fusion.grad_step(probe_bn_fusion.chain_loss(layer, K))(
        _t(x0)), jstep(jnp.asarray(jx0)))


def test_conv_bn_chain_matches_the_jax_composite():
    # the conv3x3 + BN + ReLU chain's gradient against the JAX tool's
    # loss (its NCHW/OIHW conv), with bn_act_reference as the BN
    shape, K = (2, 8, 6, 6), 2
    rng = np.random.RandomState(0)
    x0 = rng.randn(*shape).astype(np.float32)
    g = rng.rand(8).astype(np.float32) + 0.5
    b = rng.randn(8).astype(np.float32)
    w = (rng.randn(8, 8, 3, 3) / np.sqrt(72)).astype(np.float32)

    def jlayer(x):
        y = jax.lax.conv_general_dilated(
            x, jnp.asarray(w), (1, 1), "SAME",
            dimension_numbers=("NCHW", "OIHW", "NCHW"))
        return jbn_act_reference(y, jnp.asarray(g), jnp.asarray(b),
                                 act="relu")[0]

    def jloss(x):
        for _ in range(K):
            x = jlayer(x)
        return jnp.sum(jnp.square(x)) * 1e-6

    for mode in ("oracle", "library", "kernel"):
        layer = probe_bn_fusion.conv_bn_layer(mode, _t(g), _t(b), _t(w))
        x_ = _t(x0).requires_grad_(True)
        dx, = torch.autograd.grad(
            probe_bn_fusion.chain_loss(layer, K)(x_), x_)
        _close(dx, jax.grad(jloss)(jnp.asarray(x0)))


def test_probe_bn_fusion_main_on_the_cpu(monkeypatch, capsys):
    tk.reset_launch_counts()
    monkeypatch.setattr(probe_bn_fusion, "STAGES",
                        (("stem112", 8, 6), ("s1_56", 32, 5)))
    rows = probe_bn_fusion.main(["2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "FAILED" not in out and "conv3x3+BN+relu chain" in out
    assert [r["stage"] for r in rows] == ["stem112", "s1_56", "s1_56"]
    assert rows[2]["conv"] and rows[2]["C"] == 8
    for r in rows:
        cells = [c for c in r.values() if isinstance(c, dict)]
        assert cells and all(c["status"] == "ok" and c["ms"] > 0
                             for c in cells)
    assert set(tk.launch_counts().values()) == {0}
    rows = probe_bn_fusion.main(["2", "stem112", "--device", "cpu"])
    assert [r["stage"] for r in rows] == ["stem112"]
