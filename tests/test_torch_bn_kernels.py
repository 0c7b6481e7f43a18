"""mxtpu_torch's BatchNorm(+add)(+ReLU) plain versions on the CPU held
against mxtpu's four Pallas BatchNorm kernels in interpreter mode, and
``fused_bn_act`` through autograd against mxtpu's ``fused_bn_act``.

The same inputs, made from a numpy seed, go to both packages.
Tolerances: f32 1e-5 (another summation order of the per-channel sums);
bf16 one bf16 ulp of the output (2^-7 relative, with an absolute floor
of one ulp at 1): inputs and outputs round to bf16 on both sides and
the math is f32 on both, so a sum that differs in its last f32 bit can
move an output across one bf16 rounding boundary.  The ReLU masks are
recomputed from x on both sides with the same f32 operations, so they
agree except where a pre-activation lands within rounding of 0; at
these sizes none does.  The CUDA kernels run only on the card, through
``chip_smoke.py``.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxtpu_torch import MXNetError, kernels as tk

tbn = importlib.import_module("mxtpu_torch.kernels.batch_norm")
jbn = importlib.import_module("mxtpu.kernels.batch_norm")

torch.set_num_threads(2)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
ACTS = ["none", "relu"]


def _tol(dtype):
    return (1e-5, 1e-5) if dtype == "float32" else (2.0 ** -7, 2.0 ** -7)


def _close(got, want, dtype, what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    rtol, atol = _tol(dtype)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


def _pair(a, dtype):
    td, jd = DTYPES[dtype]
    return torch.from_numpy(a).to(td), jnp.asarray(a).astype(jd)


def _inputs(seed, shape, C, dtype, add):
    rng = np.random.RandomState(seed)
    # a channel mean of 0.5 and a spread of 2: the variance is not 1
    x = (0.5 + 2.0 * rng.randn(*shape)).astype(np.float32)
    r = rng.randn(*shape).astype(np.float32) if add else None
    dy = rng.randn(*shape).astype(np.float32)
    g = (1.0 + 0.2 * rng.randn(C)).astype(np.float32)
    b = (0.1 * rng.randn(C)).astype(np.float32)
    return [None if a is None else _pair(a, dtype) for a in (x, r, dy, g, b)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("add", [False, True])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("cm", [False, True], ids=["major", "cm"])
def test_plain_versions_match_pallas_kernels(cm, act, add, dtype):
    shape = (144, 32) if cm else (4, 32, 36)
    C = 32
    (tx, jx), rr, (tdy, jdy), (tg, jg), (tb, jb) = _inputs(
        0, shape, C, dtype, add)
    tr, jr = rr if add else (None, None)
    eps = 1e-5
    if cm:
        want = jbn._fwd_call_cm(jx, jg, jb, jr, eps, act, C, True)
        got = tbn.bn_fwd_cm(tx, tg, tb, tr, eps, act)
    else:
        want = jbn._fwd_call(jx, jg, jb, jr, eps, act, C, True)
        got = tbn.bn_fwd(tx, tg, tb, tr, eps, act)
    for name, a, w in zip(("y", "mean", "var"), got, want):
        _close(a, w, dtype if name == "y" else "float32", name)
    # the backward from the same f32 statistics on both sides
    mean, var = got[1], got[2]
    rstd = torch.rsqrt(var + eps)
    jmean, jrstd = jnp.asarray(mean.numpy()), jnp.asarray(rstd.numpy())
    if cm:
        want = jbn._bwd_call_cm(jx, jr, jdy, jg, jb, jmean, jrstd, act, C,
                                True)
        got = tbn.bn_bwd_cm(tx, tr, tdy, tg, tb, mean, rstd, act)
    else:
        want = jbn._bwd_call(jx, jr, jdy, jg, jb, jmean, jrstd, act, C, True)
        got = tbn.bn_bwd(tx, tr, tdy, tg, tb, mean, rstd, act)
    for name, a, w in zip(("dx", "dr", "dgamma", "dbeta"), got, want):
        if w is None:
            assert a is None
            continue
        assert a.dtype == (torch.float32 if name[1] == "g" or
                           name == "dbeta" else tx.dtype), name
        # dgamma and dbeta are f32 sums of 144 terms of size ~1
        _close(a, w, dtype if name in ("dx", "dr") else "float32", name)


@pytest.mark.parametrize("layout,axis", [("major", 1), ("cm", 3),
                                         ("cm", -1)])
@pytest.mark.parametrize("act,add", [("none", False), ("relu", False),
                                     ("relu", True)])
def test_fused_bn_act_grads_match_mxtpu(monkeypatch, layout, axis, act,
                                        add):
    import jax
    monkeypatch.setenv("MXTPU_PALLAS", "interpret")
    monkeypatch.setenv("MXTPU_FUSED_BN", "1")
    monkeypatch.setenv("MXTPU_BN_LAYOUT", layout)
    shape = (2, 8, 6, 6)
    C = 8
    rng = np.random.RandomState(1)
    x = (0.3 + rng.randn(*shape)).astype(np.float32)
    r = rng.randn(*shape).astype(np.float32) if add else None
    g = (1.0 + 0.2 * rng.randn(C)).astype(np.float32)
    b = (0.1 * rng.randn(C)).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    if axis != 1:
        # the same data channels-last: mxtpu's kernels take axis 1 only,
        # so its side sees the NCHW transpose
        perm = (0, 2, 3, 1)
        tx_np, tr_np, tdy_np = (None if a is None else
                                np.ascontiguousarray(a.transpose(perm))
                                for a in (x, r, dy))
    else:
        tx_np, tr_np, tdy_np = x, r, dy

    def jf(x_, g_, b_, *rr):
        y, mean, var = jbn.fused_bn_act(x_, g_, b_, act=act,
                                        residual=rr[0] if rr else None)
        return y, mean, var
    jargs = [jnp.asarray(a) for a in (x, g, b)] + \
        ([jnp.asarray(r)] if add else [])
    (jy, jmean, jvar), vjp = jax.vjp(jf, *jargs)
    jgrads = vjp((jnp.asarray(dy), jnp.zeros_like(jmean),
                  jnp.zeros_like(jvar)))

    tx = torch.from_numpy(tx_np).requires_grad_(True)
    tg = torch.from_numpy(g).requires_grad_(True)
    tb_ = torch.from_numpy(b).requires_grad_(True)
    tr = torch.from_numpy(tr_np).requires_grad_(True) if add else None
    y, mean, var = tk.fused_bn_act(tx, tg, tb_, act=act, residual=tr,
                                   axis=axis)
    assert not mean.requires_grad and not var.requires_grad
    y.backward(torch.from_numpy(tdy_np))
    back = (lambda a: a) if axis == 1 else \
        (lambda a: a.permute(0, 3, 1, 2))
    _close(back(y.detach()), jy, "float32", "y")
    _close(mean, jmean, "float32", "mean")
    _close(var, jvar, "float32", "var")
    _close(back(tx.grad), jgrads[0], "float32", "dx")
    _close(tg.grad, jgrads[1], "float32", "dgamma")
    _close(tb_.grad, jgrads[2], "float32", "dbeta")
    if add:
        _close(back(tr.grad), jgrads[3], "float32", "dr")


@pytest.mark.parametrize("cm", [False, True], ids=["major", "cm"])
def test_constant_channel_and_single_element(cm):
    # a constant channel: E[x^2] - E[x]^2 may round below 0 before the
    # clamp; var must come out 0 (or a rounding above it), never NaN
    shape = (64, 3) if cm else (4, 3, 16)
    x = torch.full(shape, 0.1)
    x[(slice(None), 1)] = torch.linspace(-1, 1, shape[0])[:, None] \
        if not cm else torch.linspace(-1, 1, shape[0])
    g, b = torch.ones(3), torch.zeros(3)
    fwd, bwd = (tbn.bn_fwd_cm, tbn.bn_bwd_cm) if cm else \
        (tbn.bn_fwd, tbn.bn_bwd)
    y, mean, var = fwd(x, g, b, None, 1e-5, "relu")
    assert torch.isfinite(y).all() and (var >= 0).all()
    assert float(var[0]) < 1e-8 and float(var[2]) < 1e-8
    dx, dr, dg, db = bwd(x, None, torch.ones(shape), g, b, mean,
                         torch.rsqrt(var + 1e-5), "relu")
    assert dr is None and torch.isfinite(dx).all()
    # N*S = 1: var = 0, rstd = eps^-1/2, y = beta, and dx = 0
    one = torch.tensor([[[2.5]], [[-1.0]]]).reshape((1, 2) if cm
                                                     else (1, 2, 1))
    y, mean, var = fwd(one, torch.ones(2), torch.tensor([0.5, -0.5]), None,
                       1e-5, "none")
    assert torch.equal(var, torch.zeros(2))
    # x*scale + (beta - x*scale) at scale = 316: beta to within f32
    # rounding of 790
    assert torch.allclose(y.reshape(-1), torch.tensor([0.5, -0.5]),
                          atol=1e-3)
    dx, _, dg, db = bwd(one, None, torch.ones_like(one), torch.ones(2),
                        torch.zeros(2), mean, torch.rsqrt(var + 1e-5),
                        "none")
    assert torch.equal(dx, torch.zeros_like(dx))
    assert torch.equal(db, torch.ones(2)) and torch.equal(dg, torch.zeros(2))


def test_fused_bn_act_picks_the_view_from_the_axis(monkeypatch):
    calls = []
    real = tbn._fwd

    def spy(*a, **k):
        calls.append(k["cm"] if "cm" in k else a[-1])
        return real(*a, **k)
    monkeypatch.setattr(tbn, "_fwd", spy)
    x = torch.randn(2, 4, 3, 5)
    g, b = torch.ones(4), torch.zeros(4)
    tk.fused_bn_act(x, g, b, axis=1)
    tk.fused_bn_act(x.permute(0, 2, 3, 1).contiguous(), g, b, axis=3)
    tk.fused_bn_act(torch.randn(6, 4), g, b, axis=1)
    assert calls == [False, True, True]
    with pytest.raises(MXNetError, match="residual"):
        tk.fused_bn_act(x, g, b, act="relu", residual=x[:1])
    with pytest.raises(MXNetError, match="act must be"):
        tk.fused_bn_act(x, g, b, act="gelu")


@pytest.mark.cuda
@pytest.mark.parametrize("fn,args", [
    ("bn_fwd", lambda x, v: (x, v, v)),
    ("bn_fwd_cm", lambda x, v: (x[0], v, v)),
    ("bn_bwd", lambda x, v: (x, None, x, v, v, v, v)),
    ("bn_bwd_cm", lambda x, v: (x[0], None, x[0], v, v, v, v))])
def test_raw_wrappers_refuse_grad_on_the_card(fn, args):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: on the CPU the raw wrappers take "
                    "the plain version, which keeps autograd")
    x = torch.randn(2, 4, 8, device="cuda", requires_grad=True)
    v = torch.ones(4, device="cuda")
    with pytest.raises(MXNetError, match="require grad"):
        getattr(tbn, fn)(*args(x, v))


def test_refuse_grad_names_the_wrapper():
    # the check the raw wrappers run on the card, on CPU tensors
    x = torch.randn(2, 4, 8, requires_grad=True)
    for name in ("bn_fwd", "bn_bwd_cm"):
        with pytest.raises(MXNetError, match=f"{name}: inputs require grad"):
            tk.refuse_grad(name, x)
    with torch.no_grad():
        tk.refuse_grad("bn_fwd", x)


def test_cpu_tensors_never_touch_the_build(monkeypatch):
    from mxtpu_torch.kernels import _build

    def boom(*a, **k):
        raise AssertionError("the CPU path reached the kernel build")
    monkeypatch.setattr(_build, "bind", boom)
    monkeypatch.setattr(_build, "load", boom)
    x = torch.randn(2, 4, 3, 3, requires_grad=True)
    g = torch.ones(4, requires_grad=True)
    b = torch.zeros(4, requires_grad=True)
    y, _, _ = tk.fused_bn_act(x, g, b, act="relu", residual=x.detach())
    y.sum().backward()
    y, _, _ = tk.fused_bn_act(x.permute(0, 2, 3, 1).contiguous(), g, b,
                              axis=3)
    y.sum().backward()
    assert x.grad is not None and g.grad is not None


def test_launch_counts_have_the_four_bn_keys():
    counts = tk.launch_counts()
    for k in ("batch_norm_fwd", "batch_norm_bwd", "batch_norm_fwd_cm",
              "batch_norm_bwd_cm"):
        assert k in counts
    tk.reset_launch_counts()
    assert set(tk.launch_counts().values()) == {0}
