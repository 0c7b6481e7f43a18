"""Backward of the mxtpu_torch kernels (plain PyTorch paths on the CPU)
held against mxtpu's Pallas backward kernels in interpreter mode and
against ``jax.vjp`` of its lax references.

The same inputs, made from a numpy seed, go to both packages.
Tolerances: f32 1e-5 (another f32 summation order; attention's
gradients pass through two more products and an exp: 2e-5), bf16 2e-2
(inputs and outputs carry bf16 rounding, the math is f32 on both
sides).  The dropout mask of the fused epilogue is integer arithmetic
and must match bit for bit.  The CUDA kernels themselves run only on
the card, through ``chip_smoke.py``.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxtpu_torch import MXNetError, kernels as tk

tfa = importlib.import_module("mxtpu_torch.kernels.flash_attention")
tln = importlib.import_module("mxtpu_torch.kernels.layer_norm")
jfa = importlib.import_module("mxtpu.kernels.flash_attention")
jln = importlib.import_module("mxtpu.kernels.layer_norm")

torch.set_num_threads(2)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    # mxtpu's Pallas kernels run in interpreter mode on the CPU, and
    # its flash backward takes the blockwise kernels at these sizes
    monkeypatch.setenv("MXTPU_PALLAS", "interpret")
    monkeypatch.setenv("MXTPU_FLASH_BWD", "pallas")


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _pair(a, dtype):
    """One numpy array as a torch tensor and a jax array of ``dtype``
    (both round f32 to bf16 to nearest even, so the values agree)."""
    td, jd = DTYPES[dtype]
    return torch.from_numpy(a).to(td), jnp.asarray(a).astype(jd)


# ------------------------------------------------------------ attention

FLASH_CASES = [(False, 32, 32), (True, 32, 32), (False, 13, 13),
               (True, 13, 13), (True, 8, 24), (False, 24, 8)]


def _flash_inputs(seed, BH, Tq, Tk, D, causal, dtype):
    rng = np.random.RandomState(seed)
    q, do = (rng.randn(BH, Tq, D).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(BH, Tk, D).astype(np.float32) for _ in range(2))
    (tq, jq), (tk_, jk), (tv, jv), (tdo, jdo) = (
        _pair(a, dtype) for a in (q, k, v, do))
    scale = 1.0 / D ** 0.5
    o, lse = tfa.flash_forward(tq, tk_, tv, causal, scale)
    return (tq, tk_, tv, tdo, o, lse), (jq, jk, jv, jdo), scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,Tq,Tk", FLASH_CASES + [(True, 24, 8)])
def test_flash_backward_matches_pallas_kernels(causal, Tq, Tk, dtype):
    (q, k, v, do, o, lse), (jq, jk, jv, jdo), scale = _flash_inputs(
        0, 3, Tq, Tk, 16, causal, dtype)
    got = tfa.flash_backward(q, k, v, do, o, lse, causal, scale)
    jo = jnp.asarray(o.float().numpy()).astype(DTYPES[dtype][1])
    rows = jnp.sum(jdo.astype(jnp.float32) * jo.astype(jnp.float32), -1)
    want = jfa._flash_backward(jq, jk, jv, jdo,
                               jnp.asarray(lse.numpy())[..., None],
                               rows[..., None], causal, scale, True)
    for g, w in zip(got, want):
        assert g.dtype == q.dtype
        _close(g, w, TOL[dtype] * (2 if dtype == "float32" else 1))


@pytest.mark.parametrize("causal,Tq,Tk", FLASH_CASES)
def test_flash_backward_matches_jax_grad_of_reference(causal, Tq, Tk):
    (q, k, v, do, o, lse), (jq, jk, jv, jdo), scale = _flash_inputs(
        1, 4, Tq, Tk, 8, causal, "float32")
    got = tfa.flash_backward(q, k, v, do, o, lse, causal, scale)
    shape4 = lambda a, T: a.reshape(2, 2, T, 8)  # noqa: E731
    _, vjp = jax.vjp(lambda a, b, c: jfa.attention_reference(
        a, b, c, causal, scale), shape4(jq, Tq), shape4(jk, Tk),
        shape4(jv, Tk))
    want = vjp(shape4(jdo, Tq))
    for g, w, T in zip(got, want, (Tq, Tk, Tk)):
        _close(g, np.asarray(w).reshape(4, T, 8), 2e-5)


@pytest.mark.parametrize("delta", [-3, 5])
def test_flash_backward_explicit_diagonal_matches_pallas(delta):
    rng = np.random.RandomState(11)
    q, do = (rng.randn(2, 16, 8).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(2, 24, 8).astype(np.float32) for _ in range(2))
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    o, lse = tfa.flash_forward(*t[:3], True, 0.3, delta)
    got = tfa.flash_backward(*t, o, lse, True, 0.3, delta)
    j = [jnp.asarray(a) for a in (q, k, v, do)]
    jo, jlse = jfa._flash_forward(*j[:3], True, 0.3, True, delta=delta)
    _close(o, jo, 2e-5)
    rows = jnp.sum(j[3] * jo, -1)[..., None]
    want = jfa._flash_backward(*j, jlse, rows, True, 0.3, True,
                               delta=delta)
    for g, w in zip(got, want):
        _close(g, w, 2e-5)


def test_flash_backward_fully_masked_rows_contribute_nothing():
    # causal, Tq > Tk: the first rows see no key (lse = +1e30)
    (q, k, v, do, o, lse), _, scale = _flash_inputs(2, 2, 12, 4, 8, True,
                                                    "float32")
    assert (lse[:, :8] == 1e30).all()
    dq, dk, dv = tfa.flash_backward(q, k, v, do, o, lse, True, scale)
    assert torch.isfinite(dq).all() and torch.isfinite(dk).all()
    assert (dq[:, :8] == 0).all()
    # a key's gradient gets nothing from the masked rows: zeroing their
    # dO changes nothing
    do2 = do.clone()
    do2[:, :8] = 0
    _, dk2, dv2 = tfa.flash_backward(q, k, v, do2, o, lse, True, scale)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


# ------------------------------------------------------------ LayerNorm

def _ln_inputs(seed, R, C, dtype):
    rng = np.random.RandomState(seed)
    x = (rng.randn(R, C) * 2 + 0.5).astype(np.float32)
    dy = rng.randn(R, C).astype(np.float32)
    g = rng.uniform(0.5, 1.5, C).astype(np.float32)
    b = rng.randn(C).astype(np.float32)
    return [_pair(a, dtype) for a in (x, g, b, dy)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_backward_matches_pallas_kernel(dtype):
    (x, jx), (g, jg), (b, jb), (dy, jdy) = _ln_inputs(3, 32, 64, dtype)
    _, mean, rstd = tln.layer_norm_fwd(x, g, b)
    got = tln.layer_norm_bwd(x, g, mean, rstd, dy)
    _, vjp = jax.vjp(lambda a, c, d: jln._layer_norm_pallas(a, c, d, 1e-5),
                     jx, jg, jb)
    for t, w in zip(got, vjp(jdy)):
        assert t.dtype == x.dtype
        _close(t, w, TOL[dtype])


def test_layer_norm_backward_matches_jax_grad_of_reference():
    (x, jx), (g, jg), (b, jb), (dy, jdy) = _ln_inputs(4, 20, 48,
                                                      "float32")
    _, mean, rstd = tln.layer_norm_fwd(x, g, b)
    got = tln.layer_norm_bwd(x, g, mean, rstd, dy)
    _, vjp = jax.vjp(jln.layer_norm_reference, jx, jg, jb)
    for t, w in zip(got, vjp(jdy)):
        _close(t, w, 1e-5)


# ------------------------------------------------- fused residual epilogue

KEY = (0x2545F491, 0x9E3779B9)


def _frln_inputs(seed, R, C, dtype):
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(R, C).astype(np.float32) for _ in range(3)]
    bias, beta = (rng.randn(C).astype(np.float32) for _ in range(2))
    g = rng.uniform(0.5, 1.5, C).astype(np.float32)
    h, res, dy = (_pair(a, dtype) for a in arrs)
    return h, res, dy, [_pair(a, dtype) for a in (bias, g, beta)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_fused_epilogue_backward_matches_pallas_kernel(p, dtype):
    R, C = 24, 64
    (h, jh), (res, jres), (dy, jdy), [(bias, jbias), (g, jg), (b, jb)] = \
        _frln_inputs(5, R, C, dtype)
    keep = 1.0 - p
    _, mean, rstd = tln.fused_residual_ln_fwd(h, bias, res, g, b, KEY, p)
    got = tln.fused_residual_ln_bwd(h, bias, res, g, KEY, mean, rstd, dy,
                                    keep)
    seed = jnp.asarray(np.array(KEY, np.uint32))
    _, vjp = jax.vjp(lambda *a: jln._fused_residual_ln_pallas(
        *a, seed, keep, 1e-5), jh, jbias, jres, jg, jb)
    want = vjp(jdy)
    for t, w in zip(got, want):
        _close(t, w, TOL[dtype])
    if p:
        bits = np.asarray(jln._mask_bits(jnp.uint32(KEY[0]),
                                         jnp.uint32(KEY[1]),
                                         jnp.uint32(0), R, C))
        dropped = bits >= jln._keep_thresh(keep)
        assert 0 < dropped.sum() < dropped.size
        assert np.array_equal(got[0].float().numpy() == 0, dropped)


def test_fused_epilogue_backward_matches_jax_grad_of_reference():
    (h, jh), (res, jres), (dy, jdy), [(bias, jbias), (g, jg), (b, jb)] = \
        _frln_inputs(6, 16, 32, "float32")
    _, mean, rstd = tln.fused_residual_ln_fwd(h, bias, res, g, b, KEY, 0.1)
    got = tln.fused_residual_ln_bwd(h, bias, res, g, KEY, mean, rstd, dy,
                                    0.9)
    seed = jnp.asarray(np.array(KEY, np.uint32))
    _, vjp = jax.vjp(lambda *a: jln.fused_residual_ln_reference(
        *a, seed, p=0.1), jh, jbias, jres, jg, jb)
    for t, w in zip(got, vjp(jdy)):
        _close(t, w, 1e-5)


# ----------------------------------------- autograd of the public functions

def _grads(fn, *xs):
    xs = [x.detach().clone().requires_grad_(True) for x in xs]
    out = fn(*xs)
    w = torch.from_numpy(np.random.RandomState(9).randn(*out.shape)
                         .astype(np.float32))
    (out * w).sum().backward()
    return [x.grad for x in xs]


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_autograd_matches_plain_autograd(causal):
    rng = np.random.RandomState(7)
    q, k, v = (torch.from_numpy(rng.randn(2, 2, 11, 8).astype(np.float32))
               for _ in range(3))
    got = _grads(lambda *a: tk.flash_attention(*a, causal=causal), q, k, v)
    want = _grads(lambda *a: tfa.attention_reference(*a, causal=causal),
                  q, k, v)
    for g, w in zip(got, want):
        _close(g, w.numpy(), 2e-5)


def test_layer_norm_autograd_matches_plain_autograd():
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randn(3, 5, 32).astype(np.float32))
    g = torch.from_numpy(rng.uniform(0.5, 1.5, 32).astype(np.float32))
    b = torch.from_numpy(rng.randn(32).astype(np.float32))
    got = _grads(tk.layer_norm, x, g, b)
    want = _grads(lambda *a: tln.layer_norm_reference(*a)[0], x, g, b)
    for t, w in zip(got, want):
        _close(t, w.numpy(), 1e-5)


@pytest.mark.parametrize("training", [False, True])
def test_fused_epilogue_autograd_matches_plain_autograd(training):
    rng = np.random.RandomState(10)
    h, res = (torch.from_numpy(rng.randn(2, 6, 32).astype(np.float32))
              for _ in range(2))
    bias, b = (torch.from_numpy(rng.randn(32).astype(np.float32))
               for _ in range(2))
    g = torch.from_numpy(rng.uniform(0.5, 1.5, 32).astype(np.float32))
    kw = dict(p=0.1, training=training)
    got = _grads(lambda *a: tk.fused_residual_layer_norm(*a, KEY, **kw),
                 h, bias, res, g, b)
    want = _grads(lambda *a: tln.fused_residual_ln_reference(
        *a, KEY, **kw)[0], h, bias, res, g, b)
    for t, w in zip(got, want):
        _close(t, w.numpy(), 1e-5)


# --------------------------------------------------------- dispatch rule

def test_backward_wrappers_check_their_inputs():
    x = torch.randn(4, 8)
    with pytest.raises(MXNetError, match="several devices"):
        tln.layer_norm_bwd(x, torch.ones(8), torch.zeros(4),
                           torch.ones(4, device="meta"), x)


@pytest.mark.cuda
def test_raw_forward_wrappers_refuse_grad_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the raw wrappers launch kernels "
                    "there (chip_smoke.py asserts the same refusal)")
    dev = torch.device("cuda", 0)
    q = torch.randn(2, 8, 16, device=dev, requires_grad=True)
    with pytest.raises(MXNetError, match="require grad"):
        tfa.flash_forward(q, q, q, False, 0.25)
    x = torch.randn(4, 16, device=dev, requires_grad=True)
    g = torch.ones(16, device=dev)
    with pytest.raises(MXNetError, match="require grad"):
        tln.layer_norm_fwd(x, g, g)
    with pytest.raises(MXNetError, match="require grad"):
        tln.fused_residual_ln_fwd(x, g, x, g, g, KEY, 0.1)
