"""mxtpu_torch.amp — policy-driven bf16 autocast with f32 masters and
dynamic loss scaling — held against mxtpu.amp on the CPU, with the same
seeded numpy inputs and weights in both packages.

mxtpu's AMP casts nothing on jax 0.9 (``_sub_jaxprs`` looks for the
removed ``jax.core.Jaxpr``) and, once it casts, its backward calls jax
transposes with arguments jax 0.9 renamed; every comparison with it
runs under ``tests/torch_amp_helpers.jax09_shims``, which repairs both
in this process only.

Tolerances.  The contraction forms on the CPU are f32 products of the
bf16-rounded operands in both packages, summed in another order (XLA's
against torch's): output and gradients within 1e-5 of their scale.  The
card's convolution route (the GEMM over the patches), run here through
the plain GEMM, against the plain convolution: 1e-5 of scale.
Training: 3 AMP steps of the port against 3 of mxtpu from the same
weights.  The f32 ops between the contractions round differently in the
last bit, so an activation or master that lands within that of a bf16
rounding boundary rounds to the neighbouring bf16 value (2^-8
relative; ~2.5e-5 of the elements), and what depends on it moves by a
bf16 step: losses 1e-3 relative (measured up to 1.7e-4), every weight
and optimizer-state leaf within one bf16 step (2^-7) of its tensor's
largest magnitude.  Against the port's f32 step, mxtpu's own parity bar
rtol 3e-2 / atol 1e-2 (``tests/test_amp.py``).  Skipped steps,
``run_steps`` against eager steps and ``MXTPU_AMP=0`` against
``amp=None``: bit for bit.  Serving under AMP against mxtpu's AMP
runner: batch rows do not mix, so a row without such a flip agrees to
1e-4 (f32 summation order) and most rows must; every row within a bf16
step of the logits' scale; against the f32 runner within 2 % of the
scale (measured 1 % in both packages).
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxtpu as jmx
from mxtpu import amp as ja
from mxtpu import autograd as jag
from mxtpu import nd as jnd
from mxtpu import parallel as jpar
from mxtpu.gluon import loss as jloss
from mxtpu.gluon import nn as jnn
from mxtpu.models.transformer import BERTModel as JBERT
from mxtpu.ndarray import random as jrandom
from mxtpu.serving import GenerateRunner as JGenRunner
from mxtpu.serving import ModelRunner as JRunner

from mxtpu_torch import MXNetError
from mxtpu_torch import amp as ta
from mxtpu_torch import autograd as tag
from mxtpu_torch import nd as tnd
from mxtpu_torch.convert import params_from_mxtpu
from mxtpu_torch.gluon import loss as tloss
from mxtpu_torch.gluon import nn as tnn
from mxtpu_torch.models import BERTModel
from mxtpu_torch.ops import interpose
from mxtpu_torch.parallel import build_train_step
from mxtpu_torch.serving import GenerateRunner, ModelRunner

from tests.torch_amp_helpers import jax09_shims, shims, small_net  # noqa: F401
from tests.torch_gluon_names import fresh_names

torch.set_num_threads(2)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUM_TOL = 1e-5      # of the output's scale: f32 sums in another order
LOSS_RTOL = 1e-3
BF16_STEP = 2.0 ** -7   # one bf16 step of a tensor's largest magnitude
SERVE_AMP = 2e-2       # AMP against f32 logits, of their scale
PARITY = dict(rtol=3e-2, atol=1e-2)   # AMP vs f32 (tests/test_amp.py)


def _j(a):
    return jnd.array(a)


def _t(a):
    return tnd.array(a, ctx="cpu")


# --------------------------------------------------------- the scaler

def test_scaler_grow_backoff_skip():
    st = ta.scaler_init(1024.0)
    assert float(st[0]) == 1024.0
    st = ta.scaler_update(st, True, window=3)
    st = ta.scaler_update(st, True, window=3)
    assert float(st[0]) == 1024.0 and int(st[1]) == 2
    st = ta.scaler_update(st, True, window=3)
    assert float(st[0]) == 2048.0 and int(st[1]) == 0
    st = ta.scaler_update(st, True, window=3)
    st = ta.scaler_update(st, False, window=3)
    assert float(st[0]) == 1024.0
    assert int(st[1]) == 0 and int(st[2]) == 1


def test_scaler_cap_and_floor():
    st = ta.scaler_update(ta.scaler_init(2.0 ** 24), True, window=1)
    assert float(st[0]) == 2.0 ** 24
    st = ta.scaler_update(ta.scaler_init(1.0), False, window=1)
    assert float(st[0]) == 1.0


@pytest.mark.parametrize("seed, window, init", [(0, 1, 1.0), (1, 2, 3.0),
                                                (2, 3, 2.0 ** 23)])
def test_scaler_matches_mxtpu(seed, window, init):
    """A seeded run of finite and non-finite steps through both
    scalers: every state equal."""
    flags = np.random.RandomState(seed).rand(40) < 0.8
    t, j = ta.scaler_init(init), ja.scaler_init(init)
    for f in flags:
        t = ta.scaler_update(t, bool(f), window)
        j = ja.scaler_update(j, bool(f), window)
        assert [float(t[0]), int(t[1]), int(t[2])] == \
            [float(j[0]), int(j[1]), int(j[2])]
    assert t[0].dtype == torch.float32 and t[1].dtype == torch.int32


def test_all_finite():
    good = (torch.ones(3), torch.zeros((2, 2), dtype=torch.bfloat16))
    bad = (torch.ones(3), torch.tensor([1.0, float("inf")]))
    assert bool(ta.all_finite(good))
    assert not bool(ta.all_finite(bad))
    assert not bool(ta.all_finite([torch.tensor([float("nan")])]))
    assert bool(ta.all_finite((torch.arange(3),)))
    # a large finite leaf never overflows the test
    assert bool(ta.all_finite([torch.full((4,), 3e38)]))


@pytest.mark.parametrize("tree", [
    (np.ones(3, np.float32), np.array([1.0, np.inf], np.float32)),
    [np.arange(3), np.zeros((2, 2), np.float32)],
    {"a": np.array([np.nan], np.float32)}])
def test_all_finite_matches_mxtpu(tree):
    assert bool(ta.all_finite(tree)) is bool(ja.all_finite(tree))


@pytest.mark.parametrize("env", [None, "", "0", "1", "no", "yes"])
@pytest.mark.parametrize("flag", [None, True, False])
def test_resolve_matches_mxtpu(monkeypatch, env, flag):
    if env is None:
        monkeypatch.delenv("MXTPU_AMP", raising=False)
    else:
        monkeypatch.setenv("MXTPU_AMP", env)
    assert ta.resolve(flag) is ja.resolve(flag)


def test_resolve_kill_switch_precedence(monkeypatch):
    monkeypatch.setenv("MXTPU_AMP", "0")
    assert ta.resolve(True) is False
    monkeypatch.setenv("MXTPU_AMP", "1")
    assert ta.resolve(None) is True
    monkeypatch.delenv("MXTPU_AMP")
    assert ta.resolve(None) is False
    assert ta.resolve(True) is True


@pytest.mark.parametrize("scale, window", [(None, None), ("0", "7"),
                                           ("1024", "0")])
def test_scaler_config_matches_mxtpu(monkeypatch, scale, window):
    for k, v in (("MXTPU_AMP_LOSS_SCALE", scale),
                 ("MXTPU_AMP_SCALE_WINDOW", window)):
        if v is None:
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, v)
    assert ta.scaler_config() == ja.scaler_config()


def test_policy_sets_match_mxtpu():
    assert ta.policy_sets() == ja.policy_sets()


def test_autocast_scope_is_restored():
    assert not ta.active() and not interpose.SCOPES.open
    with ta.autocast():
        assert ta.active() and interpose.SCOPES.open
        with ta.autocast(False):
            assert not ta.active() and not interpose.SCOPES.open
        assert ta.active()
    assert not ta.active() and not interpose.SCOPES.open


# ------------------------------------------- the contraction forms

DENSE_CASES = [((8, 32), 24, True), ((4, 16, 32), 24, False),
               ((4, 4, 8), 12, True)]


@pytest.mark.parametrize("xshape, n, flatten", DENSE_CASES)
def test_dense_form_matches_mxtpu(shims, xshape, n, flatten):
    """FullyConnected under autocast, forward and backward, against
    mxtpu's: f32 output and f32 gradients of the f32 inputs from the
    same exact products."""
    rng = np.random.RandomState(sum(xshape) + n)
    x = rng.randn(*xshape).astype(np.float32)
    k = int(np.prod(xshape[1:])) if flatten else xshape[-1]
    w = (0.1 * rng.randn(n, k)).astype(np.float32)
    b = rng.randn(n).astype(np.float32)
    kw = dict(num_hidden=n, flatten=flatten)
    outs = {}
    for pkg, mk, nd, ag, amp in (("j", _j, jnd, jag, ja),
                                 ("t", _t, tnd, tag, ta)):
        arrs = [mk(a) for a in (x, w, b)]
        for a in arrs:
            a.attach_grad()
        with ag.record():
            with amp.autocast():
                y = nd.FullyConnected(*arrs, **kw)
            loss = (y * y).sum()
        loss.backward()
        outs[pkg] = [y.asnumpy()] + [a.grad.asnumpy() for a in arrs]
    for got, want in zip(outs["t"], outs["j"]):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(
            got, want, rtol=0,
            atol=SUM_TOL * max(1.0, float(np.abs(want).max())))


def test_dense_form_plain_and_types():
    """The form on bf16 operands: f32 output equal to its plain version,
    gradients in the operands' types, the cotangent rounded to bf16."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(5, 16).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.randn(7, 16).astype(np.float32)).bfloat16()
    x.requires_grad_(True)
    w.requires_grad_(True)
    y = ta.dense(x, w)
    assert y.dtype == torch.float32
    assert torch.equal(y, ta.dense_plain(x, w))
    g = torch.from_numpy(rng.randn(5, 7).astype(np.float32))
    y.backward(g)
    assert x.grad.dtype == w.grad.dtype == torch.bfloat16
    g16 = g.bfloat16().float()
    assert torch.equal(x.grad, (g16 @ w.detach().float()).bfloat16())
    assert torch.equal(w.grad, (g16.t() @ x.detach().float()).bfloat16())


CONV_CASES = [("NCHW", (2, 3, 16, 16), (8, 3, 7, 7), (2, 2), (3, 3), 1, 1),
              ("NCHW", (2, 6, 9, 9), (8, 6, 3, 3), (1, 1), (1, 1), 1, 1),
              ("NCHW", (2, 8, 7, 7), (4, 8, 1, 1), (2, 2), (0, 0), 1, 1),
              ("NHWC", (2, 16, 16, 3), (8, 7, 7, 3), (2, 2), (3, 3), 1, 1),
              ("NHWC", (2, 9, 9, 6), (8, 3, 3, 6), (1, 1), (1, 1), 1, 1),
              ("NHWC", (2, 7, 7, 8), (4, 1, 1, 8), (2, 2), (0, 0), 1, 1),
              ("NCHW", (1, 4, 8, 8), (6, 2, 3, 3), (1, 1), (2, 2), 2, 2),
              ("NCW", (2, 4, 10), (5, 4, 3), (2,), (1,), 1, 1)]


def _conv_kw(layout, ws, stride, pad, groups, dil):
    kernel = ws[2:] if not layout.endswith("C") else ws[1:-1]
    return dict(kernel=kernel, stride=stride, pad=pad, num_group=groups,
                dilate=(dil,) * len(kernel), num_filter=ws[0],
                layout=layout)


@pytest.mark.parametrize("layout, xs, ws, stride, pad, groups, dil",
                         CONV_CASES)
def test_conv_form_matches_mxtpu(shims, layout, xs, ws, stride, pad,
                                 groups, dil):
    """Convolution under autocast (ResNet's 7×7/2 stem, 3×3, 1×1/2 in
    both layouts, grouped and dilated, 1-D), forward and backward,
    against mxtpu's conv_general."""
    rng = np.random.RandomState(len(xs) + ws[0] + groups)
    x = rng.randn(*xs).astype(np.float32)
    w = (0.2 * rng.randn(*ws)).astype(np.float32)
    b = rng.randn(ws[0]).astype(np.float32)
    kw = _conv_kw(layout, ws, stride, pad, groups, dil)
    outs = {}
    for pkg, mk, nd, ag, amp in (("j", _j, jnd, jag, ja),
                                 ("t", _t, tnd, tag, ta)):
        arrs = [mk(a) for a in (x, w, b)]
        for a in arrs:
            a.attach_grad()
        with ag.record():
            with amp.autocast():
                y = nd.Convolution(*arrs, **kw)
            loss = (y * y).sum()
        loss.backward()
        outs[pkg] = [y.asnumpy()] + [a.grad.asnumpy() for a in arrs]
    for got, want in zip(outs["t"], outs["j"]):
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape
        np.testing.assert_allclose(
            got, want, rtol=0,
            atol=SUM_TOL * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("layout, xs, ws, stride, pad, groups, dil",
                         CONV_CASES)
def test_conv_gemm_route_matches_plain(layout, xs, ws, stride, pad,
                                       groups, dil):
    """The card's convolution route (the bf16 GEMM over the patches,
    col2im for dx), run here through the plain GEMM, against the plain
    convolution forward and backward: the same exact products, f32
    sums in another order."""
    rng = np.random.RandomState(7 + len(xs) + ws[0])
    x = torch.from_numpy(rng.randn(*xs).astype(np.float32)).bfloat16()
    w = torch.from_numpy((0.2 * rng.randn(*ws)).astype(np.float32)
                         ).bfloat16()
    kw = _conv_kw(layout, ws, stride, pad, groups, dil)
    geom = (tuple(kw["kernel"]), stride, pad, kw["dilate"], groups, layout)
    want = ta.conv_plain(x, w, geom)
    got = ta._conv_gemm(x, w, geom)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert got.is_contiguous()
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= SUM_TOL * scale
    g = torch.from_numpy(rng.randn(*want.shape).astype(np.float32)
                         ).bfloat16()
    for got, want in zip(ta._conv_gemm_bwd(x, w, g, geom),
                         ta.conv_bwd_plain(x, w, g, geom)):
        assert got.shape == want.shape
        scale = max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= SUM_TOL * scale


class _CallRecorder:
    def __init__(self, monkeypatch):
        self.calls = []
        real = ta.wrap_op

        def wrap(name, op, tensors, resolved):
            if name in ta.ACCUM_READY:
                self.calls.append((name, [(tuple(t.shape), t.dtype)
                                          for t in tensors],
                                   dict(resolved), ta._cast_decision(op)))
            return real(name, op, tensors, resolved)
        monkeypatch.setattr(ta, "wrap_op", wrap)


DECISION_NETS = {"bert": 9, "bert_export": 9, "resnet50_NCHW": 54,
                 "resnet50_NHWC": 54}


@pytest.mark.parametrize("net_name", sorted(DECISION_NETS))
def test_cast_decisions_match_mxtpu(shims, monkeypatch, net_name):
    """Every (op, params) a BERT and ResNet-50 (NCHW and NHWC) dispatch
    under autocast: the port's table decides as mxtpu's traced decision
    does (every one True under the committed policy)."""
    import jax.numpy as jnp
    from mxtpu.ops.registry import get_op
    net, x = small_net(net_name)
    rec = _CallRecorder(monkeypatch)
    with ta.autocast(), torch.no_grad():
        net(x)
    assert len(rec.calls) == DECISION_NETS[net_name]
    for name, metas, resolved, got in rec.calls:
        arrays = [jnp.zeros(s, np.float32) for s, _ in metas]
        want = ja._cast_decision(name, get_op(name), arrays, resolved)
        assert got is want is True, (name, resolved)


def test_policy_without_dot_switches_the_cast_off(monkeypatch, tmp_path):
    """The decision is read from the policy file: one whose allow class
    lost ``dot`` leaves FullyConnected in f32."""
    import json
    policy = json.load(open(ta.POLICY_PATH))
    policy["allow"].pop("dot")
    path = tmp_path / "amp_policy.json"
    path.write_text(json.dumps(policy))
    real = ta.policy_sets
    monkeypatch.setattr(ta, "policy_sets", lambda p=None: real(str(path)))
    x, w = _t(np.ones((2, 4), np.float32) / 3), _t(np.ones((3, 4),
                                                           np.float32) / 7)
    with ta.autocast():
        got = tnd.FullyConnected(x, w, num_hidden=3, no_bias=True)
    np.testing.assert_array_equal(
        got.asnumpy(), tnd.FullyConnected(x, w, num_hidden=3,
                                          no_bias=True).asnumpy())


# ---------------------------------------------------- the train step

def _dense_net(pkg, x, batchnorm=False):
    """test_amp.py's dense net (Dense 16, BatchNorm, Dense 4) in package
    ``pkg``, its shapes settled by one forward of ``x``."""
    nn = jnn if pkg == "j" else tnn
    net = nn.HybridSequential()
    net.add(nn.Dense(16, flatten=False))
    if batchnorm:
        net.add(nn.BatchNorm(axis=-1))
    net.add(nn.Dense(4, flatten=False))
    if pkg == "j":
        net.initialize(init="xavier")
        net(_j(x))
    else:
        net.initialize(init="xavier", ctx="cpu")
        net(torch.from_numpy(x))
    return net


def _mse(p, t):
    return ((p - t) ** 2).mean()


def _xy(seed, xs=(4, 8), ys=(4, 4)):
    rng = np.random.RandomState(seed)
    return (rng.randn(*xs).astype(np.float32),
            rng.randn(*ys).astype(np.float32))


def _weights(step):
    return {n: p._tensor().detach().clone()
            for n, p in step.net.collect_params().items()}


def test_masters_f32_params_bf16():
    x, y = _xy(0)
    step = build_train_step(_dense_net("t", x, batchnorm=True), _mse,
                            "adam", {"learning_rate": 1e-3}, amp=True,
                            device="cpu")
    assert step.amp_stats() == {"loss_scale": 1.0, "good_steps": 0,
                                "skipped_steps": 0}
    step(x, y)
    for p in step.net.collect_params().values():
        want = torch.float32 if p.name.endswith(("running_mean",
                                                 "running_var")) \
            else torch.bfloat16
        assert p._tensor().dtype == want, p.name
    for st in step._opt_state:
        for leaf in st:
            if leaf.is_floating_point():
                assert leaf.dtype == torch.float32
    stats = step.amp_stats()
    assert stats["skipped_steps"] == 0 and stats["loss_scale"] == 65536.0
    assert stats["good_steps"] == 1


def test_nonfinite_batch_skips_update(monkeypatch):
    """An inf batch: every weight, master and state tensor bit-equal,
    the scale halved, one skipped step counted."""
    monkeypatch.setenv("MXTPU_AMP_LOSS_SCALE", "1024")
    x, y = _xy(1)
    step = build_train_step(_dense_net("t", x), _mse, "adam",
                            {"learning_rate": 0.1}, amp=True, device="cpu")
    step(x, y)
    before = _weights(step)
    state = [leaf.clone() for st in step._opt_state for leaf in st]
    step(x, np.full((4, 4), np.inf, np.float32))
    for n, w in _weights(step).items():
        assert torch.equal(w, before[n]), n
    for a, b in zip(state, [leaf for st in step._opt_state for leaf in st]):
        assert torch.equal(a, b)
    stats = step.amp_stats()
    assert stats["skipped_steps"] == 1 and stats["loss_scale"] == 512.0
    step(x, y)
    assert step.amp_stats()["good_steps"] == 1


def test_amp_with_compute_dtype_raises():
    x, _ = _xy(0)
    with pytest.raises(MXNetError, match="two mixed-precision"):
        build_train_step(_dense_net("t", x), _mse, "sgd", amp=True,
                         compute_dtype="bfloat16", device="cpu")


def test_amp_stats_off_and_unscaled(monkeypatch):
    x, y = _xy(0)
    off = build_train_step(_dense_net("t", x), _mse, "sgd", device="cpu")
    assert off.amp_stats() is None
    monkeypatch.setenv("MXTPU_AMP_LOSS_SCALE", "0")
    un = build_train_step(_dense_net("t", x), _mse, "sgd", amp=True,
                          device="cpu")
    un(x, y)
    assert un.amp_stats() == {"loss_scale": 1.0, "good_steps": 0,
                              "skipped_steps": 0}


def test_kill_switch_bit_equal_to_amp_off(monkeypatch):
    """MXTPU_AMP=0 with amp=True trains exactly as amp=None: losses and
    weights bit for bit, weights still f32."""
    x, y = _xy(2)
    with fresh_names():
        ref = _dense_net("t", x)
    init = {n: p.data().asnumpy() for n, p in ref.collect_params().items()}

    def run(amp):
        with fresh_names():
            net = params_from_mxtpu(init, _dense_net("t", x))
        step = build_train_step(net, _mse, "adam", {"learning_rate": 1e-2},
                                amp=amp, device="cpu")
        return [step(x, y) for _ in range(3)], _weights(step)

    monkeypatch.setenv("MXTPU_AMP", "0")
    killed, wk = run(True)
    monkeypatch.delenv("MXTPU_AMP")
    off, wo = run(None)
    assert all(torch.equal(a, b) for a, b in zip(killed, off))
    for n in wo:
        assert torch.equal(wk[n], wo[n]) and wk[n].dtype == torch.float32
    on, _ = run(True)
    assert not all(torch.equal(a, b) for a, b in zip(on, off))


V = 128


def _bert_pair():
    """test_amp.py's BERT (V 128, U 32, one layer) in both packages from
    the same xavier weights."""
    x = np.random.RandomState(0).randint(0, V, (4, 8)).astype(np.float32)
    with fresh_names():
        jnet = JBERT(V, 32, 64, 1, 1, max_length=16, dropout=0.0)
    jrandom.seed(0)
    jnet.initialize(init="xavier")
    jnet(_j(x))
    w0 = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}

    def tnet():
        with fresh_names():
            net = BERTModel(V, 32, 64, 1, 1, max_length=16, dropout=0.0)
        return params_from_mxtpu(w0, net)

    def jnet_():
        with fresh_names():
            net = JBERT(V, 32, 64, 1, 1, max_length=16, dropout=0.0)
        net.initialize(init="xavier")
        net(_j(x))
        for n, p in net.collect_params().items():
            p.set_data(_j(w0[n]))
        return net
    return x, x, tnet, jnet_


def _convbn_pair():
    """test_amp.py's conv-BN-dense stack in both packages from the same
    xavier weights."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 16, 16).astype(np.float32)
    y = rng.randint(0, 10, (2,)).astype(np.float32)

    def build(nn):
        with fresh_names():
            net = nn.HybridSequential()
            net.add(nn.Conv2D(16, 3, padding=1), nn.BatchNorm(),
                    nn.Activation("relu"),
                    nn.Conv2D(32, 3, strides=2, padding=1), nn.BatchNorm(),
                    nn.Activation("relu"), nn.GlobalAvgPool2D(),
                    nn.Dense(10))
        return net
    j0 = build(jnn)
    jrandom.seed(0)
    j0.initialize(init="xavier")
    j0(_j(x))
    w0 = {n: p.data().asnumpy() for n, p in j0.collect_params().items()}

    def tnet():
        return params_from_mxtpu(w0, build(tnn))

    def jnet_():
        net = build(jnn)
        net.initialize(init="xavier")
        net(_j(x))
        for n, p in net.collect_params().items():
            p.set_data(_j(w0[n]))
        return net
    return x, y, tnet, jnet_


def _t_loss(kind):
    ce = tloss.SoftmaxCrossEntropyLoss()
    if kind == "bert":
        return lambda p, t: ce(p.reshape(-1, V), t.reshape(-1))
    return ce


def _j_loss(kind):
    ce = jloss.SoftmaxCrossEntropyLoss()
    if kind == "bert":
        return lambda p, t: ce(p.reshape((-1, V)), t.reshape((-1,)))
    return ce


NETS = {"bert": (_bert_pair, "adam", {"learning_rate": 1e-3},
                 dict(cast_batch=False)),
        "convbn": (_convbn_pair, "sgd", {"learning_rate": 0.05,
                                         "momentum": 0.9}, {})}


def _mxtpu_weights(net):
    return {n: np.asarray(p.data()._data.astype(np.float32))
            for n, p in net.collect_params().items()}


@pytest.mark.parametrize("kind", sorted(NETS))
def test_amp_train_step_matches_mxtpu(monkeypatch, kind):
    """3 AMP steps from the same weights in both packages: losses,
    every weight (bf16 trainables, f32 running statistics), the scaler;
    the port's AMP steps against its f32 steps at mxtpu's parity bar."""
    make, opt, kw, extra = NETS[kind]
    x, y, tnet, jnet = make()
    tstep = build_train_step(tnet(), _t_loss(kind), opt, dict(kw),
                             amp=True, device="cpu", **extra)
    tl = [float(tstep(x, y)) for _ in range(3)]
    f32 = build_train_step(tnet(), _t_loss(kind), opt, dict(kw),
                           device="cpu", **extra)
    fl = [float(f32(x, y)) for _ in range(3)]
    # mxtpu's own bucketed adam misses its bar on this tree
    # (tests/test_batched_opt.py): its side runs the per-parameter path
    monkeypatch.setenv("MXTPU_BATCHED_OPT", "0")
    with jax09_shims():
        jnet_ = jnet()
        jstep = jpar.build_train_step(jnet_, _j_loss(kind), opt, dict(kw),
                                      amp=True, **extra)
        jl = [float(jstep(_j(x), _j(y)).asscalar()) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tl, fl, **PARITY)
    _same_weights(tstep, jstep, jnet_)
    assert tstep.amp_stats() == jstep.amp_stats()


def _same_weights(tstep, jstep, jnet):
    """Every optimizer state leaf (the f32 masters among them) and every
    weight within BF16_STEP of its tensor's largest magnitude of
    mxtpu's, each weight in mxtpu's type."""
    def close(got, want, what):
        tol = BF16_STEP * max(float(np.abs(want).max()), 1e-3)
        assert float(np.abs(got - want).max()) <= tol, what

    for n, a, b in zip(tstep.param_names, tstep._canonical_state(),
                       jstep._opt_state):
        for x, y in zip(a, b):
            close(x.float().numpy(), np.asarray(y).astype(np.float32), n)
    jw = _mxtpu_weights(jnet)
    for n, w in _weights(tstep).items():
        assert str(w.dtype).endswith(
            str(jnet.collect_params()[n].data()._data.dtype)), n
        close(w.float().numpy(), jw[n], n)


def test_run_steps_under_amp(monkeypatch):
    """run_steps threads the scaler: bit-equal to the same steps taken
    one by one (losses, weights, state, scaler), a non-finite
    microbatch skipped inside it; its losses and scaler against mxtpu's
    run_steps."""
    monkeypatch.setenv("MXTPU_AMP_SCALE_WINDOW", "2")
    rng = np.random.RandomState(3)
    xs = rng.randn(12, 8).astype(np.float32)
    ys = rng.randn(12, 4).astype(np.float32)
    ys[4:8] = np.inf     # the second microbatch's loss is not finite
    with fresh_names():
        ref = _dense_net("t", xs[:4])
    init = {n: p.data().asnumpy() for n, p in ref.collect_params().items()}

    def make():
        with fresh_names():
            net = params_from_mxtpu(init, _dense_net("t", xs[:4]))
        return build_train_step(net, _mse, "adam", {"learning_rate": 1e-2},
                                amp=True, device="cpu")
    bulk, eager = make(), make()
    losses = bulk.run_steps(xs, ys, 3)
    assert losses.shape == (3,)
    eager._t += 3
    lrs, wds = eager._lrs_wds()
    el = []
    for i in range(3):
        loss, grads = eager.forward_backward(xs[4 * i:4 * i + 4],
                                             ys[4 * i:4 * i + 4])
        el.append(loss)
        with torch.no_grad():
            eager._apply_checked(grads, lrs, wds)
    assert torch.equal(losses, torch.stack(el))
    for n, w in _weights(bulk).items():
        assert torch.equal(w, _weights(eager)[n]), n
    for a, b in zip(bulk._opt_state, eager._opt_state):
        assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert bulk.amp_stats() == eager.amp_stats() == \
        {"loss_scale": 32768.0, "good_steps": 1, "skipped_steps": 1}
    monkeypatch.setenv("MXTPU_BATCHED_OPT", "0")
    with jax09_shims():
        with fresh_names():
            jnet = _dense_net("j", xs[:4])
        for n, p in jnet.collect_params().items():
            p.set_data(_j(init[n]))
        jstep = jpar.build_train_step(jnet, _mse, "adam",
                                      {"learning_rate": 1e-2}, amp=True)
        jl = jstep.run_steps(_j(xs), _j(ys), 3).asnumpy()
        assert jstep.amp_stats() == bulk.amp_stats()
    np.testing.assert_allclose(losses.numpy(), jl, rtol=LOSS_RTOL)
    _same_weights(bulk, jstep, jnet)


def test_scaler_state_rides_checkpoint(tmp_path, monkeypatch):
    """The scale and its accounting ride save_states/load_states, and
    cross between the packages in both directions."""
    monkeypatch.setenv("MXTPU_AMP_SCALE_WINDOW", "1")
    monkeypatch.setenv("MXTPU_AMP_LOSS_SCALE", "256")
    x, y = _xy(0)

    def make():
        with fresh_names():
            net = _dense_net("t", x)
        return build_train_step(net, _mse, "adam", {"learning_rate": 1e-3},
                                amp=True, device="cpu")

    step = make()
    for _ in range(2):
        step(x, y)
    assert step.amp_stats()["loss_scale"] == 1024.0
    fname = str(tmp_path / "amp.states")
    step.save_states(fname)
    with open(fname, "rb") as f:
        blob = pickle.load(f)
    assert blob["amp"] == {"scale": 1024.0, "good_steps": 0,
                           "skipped_steps": 0}
    step2 = make()
    step2.load_states(fname)
    assert step2.amp_stats() == step.amp_stats()
    step2(x, y)
    assert step2.amp_stats()["loss_scale"] == 2048.0
    # mxtpu reads the port's file and the port mxtpu's
    with jax09_shims():
        with fresh_names():
            jnet = _dense_net("j", x)
        jstep = jpar.build_train_step(jnet, _mse, "adam",
                                      {"learning_rate": 1e-3}, amp=True)
        jstep.load_states(fname, x_example=_j(x))
        assert jstep.amp_stats() == step.amp_stats()
        jstep(_j(x), _j(y))
        jname = str(tmp_path / "j.states")
        jstep.save_states(jname)
    step3 = make()
    step3.load_states(jname)
    assert step3.amp_stats() == jstep.amp_stats() == \
        {"loss_scale": 2048.0, "good_steps": 0, "skipped_steps": 0}


# ------------------------------------------------------------ serving

@pytest.fixture(scope="module")
def bert_export(tmp_path_factory):
    """A 2-layer BERT exported by mxtpu (V 128, U 32)."""
    d = tmp_path_factory.mktemp("ampbert")
    with fresh_names():
        jnet = JBERT(V, 32, 64, 2, 2, max_length=32, dropout=0.1)
    jnet.initialize(init="xavier")
    jnet(_j(np.zeros((1, 8), np.float32)))
    return jnet.export(str(d / "bert"))


SPEC = dict(input_specs={"data": (None,)}, seq_buckets=[16, 32],
            max_batch_size=4)


def test_model_runner_amp_matches_mxtpu(shims, bert_export):
    """ModelRunner(amp=True): weights uploaded bf16, logits f32, against
    mxtpu's AMP runner and the port's f32 runner (see the module's
    tolerances), at a full bucket of each sequence rung."""
    t = ModelRunner.from_export(*bert_export, device="cpu", amp=True, **SPEC)
    f32 = ModelRunner.from_export(*bert_export, device="cpu", **SPEC)
    j = JRunner.from_export(*bert_export, cache=None, amp=True, **SPEC)
    assert {w.dtype for w in t.weight_buffers()} == {torch.bfloat16}
    assert t.weight_bytes() * 2 == f32.weight_bytes()
    rng = np.random.RandomState(3)
    exact_rows = 0
    for b, s in ((4, 16), (4, 32)):
        toks = rng.randint(0, V, (b, s)).astype(np.float32)
        (got,) = t.infer({"data": toks})
        (want,) = j.infer({"data": toks})
        (ref,) = f32.infer({"data": toks})
        assert got.dtype == np.float32
        scale = max(1.0, float(np.abs(want).max()))
        assert float(np.abs(got - want).max()) <= BF16_STEP * scale
        exact_rows += sum(np.allclose(g, w, rtol=1e-4, atol=1e-4)
                          for g, w in zip(got, want))
        assert 0 < float(np.abs(got - ref).max()) <= SERVE_AMP * scale
    assert exact_rows >= 6


def test_model_runner_amp_kill_switch(monkeypatch, bert_export):
    monkeypatch.setenv("MXTPU_AMP", "0")
    t = ModelRunner.from_export(*bert_export, device="cpu", amp=True, **SPEC)
    monkeypatch.delenv("MXTPU_AMP")
    f32 = ModelRunner.from_export(*bert_export, device="cpu", **SPEC)
    assert {w.dtype for w in t.weight_buffers()} == {torch.float32}
    toks = np.random.RandomState(4).randint(0, V, (2, 16)).astype(
        np.float32)
    np.testing.assert_array_equal(t.infer({"data": toks})[0],
                                  f32.infer({"data": toks})[0])


def test_generate_runner_amp_matches_mxtpu(shims, tmp_path):
    """GenerateRunner(amp=True) on a causal 2-layer BERT's incremental
    export: a prefill and two decode steps against mxtpu's AMP runner
    (1e-4), the KV table f32."""
    with fresh_names():
        jnet = JBERT(32, 16, 32, 2, 2, max_length=16, dropout=0.0,
                     use_token_type=False, causal=True)
    jnet.initialize(init="xavier")
    jnet.hybridize()
    jnet(jmx.nd.array(np.ones((1, 3))), jmx.nd.array(np.zeros(1)),
         jmx.nd.array(np.zeros(jnet.kv_cache_spec(1), np.float32)))
    files = jnet.export(str(tmp_path / "g"))
    spec = jnet.kv_cache_spec(2, 16)
    kw = dict(prompt_buckets=(4, 8), amp=True)
    j = JGenRunner.from_export(*files, spec, cache=None, **kw)
    t = GenerateRunner.from_export(*files, spec, device="cpu", **kw)
    toks = np.array([[3, 7, 1, 4], [5, 2, 9, 9]], np.float32)
    lanes = np.array([0, 1], np.float32)
    step = np.zeros(2, np.float32)
    jl, jkv = j.prefill(toks, step, lanes, j.new_cache())
    tl, tkv = t.prefill(toks, step, lanes, t.new_cache())
    assert tkv.dtype == torch.float32
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-4, atol=1e-4)
    for i in range(2):
        dt = np.zeros((3, 1), np.float32)
        ds = np.zeros(3, np.float32)
        dt[:2, 0], ds[:2] = [11, 12], 4 + i
        jl, jkv = j.decode(dt, ds, jkv)
        tl, tkv = t.decode(dt, ds, tkv)
        np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_allclose(tkv[:, :, :2].numpy(),
                               np.asarray(jkv)[:, :, :2], rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------- self-check

def test_self_check_passes():
    assert ta.self_check() == 0


def test_self_check_cli():
    r = subprocess.run([sys.executable, "-m", "mxtpu_torch.amp",
                        "--self-check"], capture_output=True, text=True,
                       cwd=_ROOT, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "autocast round trip OK" in r.stdout
