"""mxtpu_torch.quant — int8 post-training quantization — held against
mxtpu.quant on the CPU, with the same seeded numpy inputs and weights in
both packages.

mxtpu's int8 path decides nothing on jax 0.9 (``_sub_jaxprs`` looks for
the removed ``jax.core.Jaxpr``), so every comparison with it runs under
``tests/torch_amp_helpers.jax09_shims``, which repairs that in this
process only.

Tolerances.  The int8 pieces are integer or elementwise f32 arithmetic
in the same order in both packages: quantized activations and weights,
per-channel thresholds, int32 accumulators and the dequantized output of
one op are bit-equal.  Calibration keys and thresholds (after
``_round6``) are equal.  A whole network differs in the last bits of its
f32 ops between the packages (attention, LayerNorm, GELU); an activation
that lands that close to a rounding boundary of ``x · 127/t`` moves one
int8 step, so two-layer BERT logits agree within 3 % of the f32 logits'
scale (measured 1.4 %), and a single quantized layer's output within one
activation step times the weight row's abs-sum.  mxtpu's own accuracy
gate holds the port: the quantized serving BERT within 10 % of its f32
twin's logit scale (measured 9.7 % in both packages).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxtpu as jmx
from mxtpu import nd as jnd
from mxtpu import quant as jq
from mxtpu.contrib import quantization as jcq
from mxtpu.serving import GenerateRunner as JGenRunner
from mxtpu.serving import ModelRunner as JRunner

import mxtpu_torch as tmx
from mxtpu_torch import MXNetError, nd as tnd
from mxtpu_torch import quant as tq
from mxtpu_torch import symbol as tsym
from mxtpu_torch.contrib import quantization as tcq
from mxtpu_torch.ops import interpose
from mxtpu_torch.serving import GenerateRunner, ModelRunner

from tests.torch_amp_helpers import jax09_shims, shims, small_net  # noqa: F401

torch.set_num_threads(2)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NET_TOL = 0.03      # two-layer BERT int8 logits, port vs mxtpu, of scale
GATE = 0.10         # mxtpu's int8-vs-f32 accuracy gate, of scale


def _j(a):
    return jnd.array(a)


def _t(a):
    return tnd.array(a, ctx="cpu")


# ------------------------------------------------------ switch + knobs

@pytest.mark.parametrize("env", [None, "", "0", "1", "off", "on", "true"])
@pytest.mark.parametrize("flag", [None, True, False])
def test_resolve_matches_mxtpu(monkeypatch, env, flag):
    if env is None:
        monkeypatch.delenv("MXTPU_QUANT", raising=False)
    else:
        monkeypatch.setenv("MXTPU_QUANT", env)
    assert tq.resolve(flag) is jq.resolve(flag)


def test_resolve_kill_switch_precedence(monkeypatch):
    monkeypatch.setenv("MXTPU_QUANT", "0")
    assert tq.resolve(True) is False
    monkeypatch.setenv("MXTPU_QUANT", "1")
    assert tq.resolve(None) is True
    monkeypatch.delenv("MXTPU_QUANT")
    assert tq.resolve(None) is False
    assert tq.resolve(True) is True


@pytest.mark.parametrize("mode, batches", [(None, None), ("minmax", "3"),
                                           ("ENTROPY", "0")])
def test_calib_config_matches_mxtpu(monkeypatch, mode, batches):
    for k, v in (("MXTPU_QUANT_CALIB", mode),
                 ("MXTPU_QUANT_CALIB_BATCHES", batches)):
        if v is None:
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, v)
    assert tq.calib_config() == jq.calib_config()


def test_calib_config_rejects_unknown_mode(monkeypatch):
    monkeypatch.setenv("MXTPU_QUANT_CALIB", "percentile")
    with pytest.raises(MXNetError, match="MXTPU_QUANT_CALIB"):
        tq.calib_config()


def test_policy_sets_match_mxtpu():
    assert tq.policy_sets() == jq.policy_sets()
    assert tq.POLICY_PATH == jq.POLICY_PATH


# ---------------------------------------------------------- collectors

def _heavy_tailed(seed, n=4096):
    x = np.random.RandomState(seed).randn(n).astype(np.float32)
    x[seed % n] = 40.0
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_optimal_threshold_matches_mxtpu(seed):
    x = _heavy_tailed(seed) * (seed + 1)
    assert tcq.optimal_threshold(x) == jcq.optimal_threshold(x)
    assert tcq.optimal_threshold(np.zeros(5)) == \
        jcq.optimal_threshold(np.zeros(5))


@pytest.mark.parametrize("mode", ["minmax", "entropy"])
def test_collectors_match_mxtpu(mode):
    """The same observations under the same keys give the same table;
    a torch tensor observes as its numpy twin."""
    t, j = tq.make_collector(mode), jq.make_collector(mode)
    rng = np.random.RandomState(7)
    for i in range(3):
        for key in ("FullyConnected_0", "FullyConnected_1"):
            x = (rng.randn(6, 32) * (i + 1)).astype(np.float32)
            t.observe(key, torch.from_numpy(x))
            j.observe(key, x)
    assert t.thresholds() == j.thresholds()
    for v in t.thresholds().values():
        assert v == float(f"{v:.6g}")


def test_collectors_disagree_on_outliers():
    x = _heavy_tailed(5)
    mm, en = tq.MinMaxCollector(), tq.EntropyCollector()
    for c in (mm, en):
        c.observe("k", x)
    t_mm, t_en = mm.thresholds()["k"], en.thresholds()["k"]
    assert t_mm == pytest.approx(40.0, rel=1e-5)
    assert 0 < t_en < 0.5 * t_mm


def test_make_collector_rejects_unknown_mode():
    with pytest.raises(MXNetError, match="unknown collector"):
        tq.make_collector("percentile")


# ------------------------------------------- the int8 forms, bit for bit

FC_CASES = [((8, 32), 24, True, False), ((4, 16, 32), 24, False, False),
            ((4, 4, 8), 24, True, False), ((9, 32), 30, False, True)]


@pytest.mark.parametrize("xshape, n, flatten, no_bias", FC_CASES)
def test_quantized_fc_bit_equal(shims, xshape, n, flatten, no_bias):
    """Quantized activations, weights and thresholds, the int32 sums and
    the dequantized output against mxtpu's, bit for bit."""
    rng = np.random.RandomState(sum(xshape) + n)
    x = rng.randn(*xshape).astype(np.float32)
    k = int(np.prod(xshape[1:])) if flatten else xshape[-1]
    w = (0.1 * rng.randn(n, k)).astype(np.float32)
    b = rng.randn(n).astype(np.float32)
    thr = 2.53117
    kw = dict(num_hidden=n, flatten=flatten, no_bias=no_bias)
    scales = {"FullyConnected_0": thr}
    with jq.quantize(scales):
        want = jnd.FullyConnected(_j(x), _j(w), _j(b), **kw).asnumpy()
    with tq.quantize(scales):
        got = tnd.FullyConnected(_t(x), _t(w), _t(b), **kw).asnumpy()
    np.testing.assert_array_equal(got, want)

    import jax.numpy as jnp
    from jax import lax
    xf = x.reshape(x.shape[0], -1) if flatten else x
    qx = tq.quantize_tensor(torch.from_numpy(xf), thr)
    np.testing.assert_array_equal(
        qx.numpy(), np.asarray(jq._quantize_tensor(jnp.asarray(xf), thr)))
    t_w = tq.channel_thresholds(torch.from_numpy(w))
    jt_w = jq._channel_thresholds(jnp.asarray(w))
    np.testing.assert_array_equal(t_w.numpy(), np.asarray(jt_w))
    qw = tq.quantize_weight(torch.from_numpy(w), t_w)
    jqw = jnp.clip(jnp.round(jnp.asarray(w) * (127.0 / jt_w)[:, None]),
                   -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(qw.numpy(), np.asarray(jqw))
    acc = tq.int_mm(qx.reshape(-1, k), qw)
    jacc = lax.dot_general(jnp.asarray(qx.numpy()).reshape(-1, k), jqw,
                           (((1,), (1,)), ((), ())),
                           preferred_element_type=jnp.int32)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))


CONV_CASES = [((2, 6, 9, 9), (8, 6, 3, 3), (2, 2), (1, 1), 1, (1, 1)),
              ((2, 3, 16, 16), (8, 3, 7, 7), (2, 2), (3, 3), 1, (1, 1)),
              ((2, 8, 7, 7), (4, 8, 1, 1), (2, 2), (0, 0), 1, (1, 1)),
              ((1, 4, 8, 8), (6, 2, 3, 3), (1, 1), (2, 2), 2, (2, 2)),
              ((2, 4, 10), (5, 4, 3), (1,), (1,), 1, (1,))]


@pytest.mark.parametrize("xs, ws, stride, pad, groups, dilate", CONV_CASES)
def test_quantized_conv_bit_equal(shims, xs, ws, stride, pad, groups,
                                  dilate):
    """Channels-first int8 convolutions (the stem's 7×7/2, a 3×3, a
    1×1/2, grouped and dilated, 1-D) against mxtpu's, bit for bit; the
    card's route (the int8 product over the patches) against the plain
    int32 sums, bit for bit."""
    rng = np.random.RandomState(len(xs) + ws[0])
    x = rng.randn(*xs).astype(np.float32)
    w = (0.2 * rng.randn(*ws)).astype(np.float32)
    b = rng.randn(ws[0]).astype(np.float32)
    kw = dict(kernel=ws[2:], stride=stride, pad=pad, dilate=dilate,
              num_filter=ws[0], num_group=groups)
    scales = {"Convolution_0": 2.7}
    with jq.quantize(scales):
        want = jnd.Convolution(_j(x), _j(w), _j(b), **kw).asnumpy()
    with tq.quantize(scales):
        got = tnd.Convolution(_t(x), _t(w), _t(b), **kw).asnumpy()
    np.testing.assert_array_equal(got, want)
    qx = tq.quantize_tensor(torch.from_numpy(x), 2.7)
    qw = tq.quantize_weight(torch.from_numpy(w),
                            tq.channel_thresholds(torch.from_numpy(w)))
    args = (tuple(ws[2:]), stride, pad, dilate, groups)
    plain = tq.int_conv_plain(qx, qw, *args)
    route = tq._int_conv_patches(qx, qw, *args)
    assert route.dtype == plain.dtype == torch.int32
    np.testing.assert_array_equal(route.numpy(), plain.numpy())


def test_channels_last_conv_stays_float(shims):
    """mxtpu quantizes channels-first convolutions only: an NHWC one
    keeps the float path in both packages (the key is still taken)."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 6, 6, 4).astype(np.float32)
    w = (0.2 * rng.randn(5, 3, 3, 4)).astype(np.float32)
    kw = dict(kernel=(3, 3), pad=(1, 1), num_filter=5, layout="NHWC",
              no_bias=True)
    with tq.quantize({"Convolution_0": 2.0}):
        got = tnd.Convolution(_t(x), _t(w), **kw).asnumpy()
        assert interpose.SCOPES.counter == 1
    plain = tnd.Convolution(_t(x), _t(w), **kw).asnumpy()
    np.testing.assert_array_equal(got, plain)
    with jq.quantize({"Convolution_0": 2.0}):
        want = jnd.Convolution(_j(x), _j(w), **kw).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


class _MmLikeIntMm:
    """``torch._int_mm``'s shape rules, then the exact int32 sums."""

    def __init__(self):
        self.shapes = []

    def __call__(self, a, b):
        assert a.dtype == b.dtype == torch.int8
        assert a.shape[0] > 16 and a.shape[1] % 8 == 0
        assert b.shape[1] % 8 == 0 and b.stride(0) == 1   # column-major
        self.shapes.append((tuple(a.shape), tuple(b.shape)))
        return torch.mm(a.double(), b.double()).to(torch.int32)


@pytest.mark.parametrize("m, k, n", [(1, 5, 3), (9, 24, 30), (9, 64, 61),
                                     (17, 16, 8), (33, 100, 8),
                                     (16, 1024, 1000)])
def test_int_mm_padding_is_exact(m, k, n):
    """Shapes ``torch._int_mm`` refuses (a decode step's 9 rows, BERT's
    30522-wide head: N not a multiple of 8, K off 8) are padded with
    zeros and sliced back: bit-equal to the plain int32 product."""
    rng = np.random.RandomState(m * n + k)
    a = torch.from_numpy(rng.randint(-127, 128, (m, k)).astype(np.int8))
    w = torch.from_numpy(rng.randint(-127, 128, (n, k)).astype(np.int8))
    fake = _MmLikeIntMm()
    got = tq._int_mm_padded(a, w, fake)
    assert got.shape == (m, n) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), tq.int_mm_plain(a, w).numpy())
    np.testing.assert_array_equal(
        got.numpy(), a.numpy().astype(np.int64) @ w.numpy().T.astype(np.int64))
    assert len(fake.shapes) == 1


# ------------------------------------------------------------ the scopes

def test_keys_count_candidates_in_dispatch_order():
    """Both scopes key the f32 candidates in dispatch order, skipping
    non-candidates and non-f32 inputs, and reset per scope."""
    x = _t(np.ones((2, 4), np.float32))
    w = _t(np.ones((3, 4), np.float32))
    c = tq.MinMaxCollector()
    with tq.calibrating(c):
        tnd.FullyConnected(x, w, num_hidden=3, no_bias=True)
        tnd.relu(x)
        tnd.FullyConnected(x.astype("float16"), w.astype("float16"),
                           num_hidden=3, no_bias=True)
        tnd.fully_connected(x, w, num_hidden=3, no_bias=True)
    assert sorted(c.thresholds()) == ["FullyConnected_0",
                                      "fully_connected_1"]
    assert not interpose.SCOPES.open and interpose.SCOPES.quant is None


def test_quantize_disabled_is_the_float_path():
    x, w = _t(np.linspace(-1, 1, 8, dtype=np.float32).reshape(2, 4)), \
        _t(np.linspace(1, -1, 12, dtype=np.float32).reshape(3, 4))
    with tq.quantize({"FullyConnected_0": 1.0}, enabled=False):
        assert not interpose.SCOPES.open
        got = tnd.FullyConnected(x, w, num_hidden=3, no_bias=True)
    np.testing.assert_array_equal(
        got.asnumpy(), tnd.FullyConnected(x, w, num_hidden=3,
                                          no_bias=True).asnumpy())


def test_scopes_are_per_thread():
    """A scope opened in one thread leaves another thread's dispatch on
    the float path (a server's workers run plans at once)."""
    import threading
    seen = []
    with tq.quantize({"FullyConnected_0": 1.0}):
        th = threading.Thread(target=lambda: seen.append(
            interpose.SCOPES.open))
        th.start()
        th.join()
        assert interpose.SCOPES.open
    assert seen == [False]


# ------------------------------------------------- decisions vs mxtpu

class _AllKeys(dict):
    def get(self, key, default=None):
        return 1.0


def _record_decisions(monkeypatch, run):
    """Run ``run()`` in a quantize scope that holds a scale for every
    key, recording each candidate the port decides on: (name, input
    shapes and types, resolved params, the port's decision)."""
    calls = []
    real = tq.wrap_op

    def wrap(name, op, tensors, resolved):
        if name in tq.QUANT_READY and len(tensors) > 1 and \
                tensors[0].dtype == tensors[1].dtype == torch.float32:
            calls.append((name, [(tuple(t.shape), t.dtype)
                                 for t in tensors], dict(resolved),
                          tq._quant_decision(op)))
        return real(name, op, tensors, resolved)
    monkeypatch.setattr(tq, "wrap_op", wrap)
    with tq.quantize(_AllKeys()), torch.no_grad():
        run()
    return calls


def _jax_dtype(dt):
    return {torch.float32: np.float32, torch.bfloat16: "bfloat16"}[dt]


def _mxtpu_decision(fn, name, metas, resolved):
    import jax.numpy as jnp
    from mxtpu.ops.registry import get_op
    arrays = [jnp.zeros(s, _jax_dtype(dt)) for s, dt in metas]
    return fn(name, get_op(name), arrays, resolved)


DECISION_NETS = {"bert": 9, "bert_export": 9, "resnet50_NCHW": 54,
                 "resnet50_NHWC": 54}


@pytest.mark.parametrize("net_name", sorted(DECISION_NETS))
def test_quant_decisions_match_mxtpu(shims, monkeypatch, net_name):
    """Every (op, params) a BERT and ResNet-50 (NCHW and NHWC) dispatch
    to the int8 pass: the port's table decides as mxtpu's traced
    decision does (every one of them True under the committed
    policy)."""
    net, x = small_net(net_name)
    calls = _record_decisions(monkeypatch, lambda: net(x))
    assert len(calls) == DECISION_NETS[net_name]
    for name, metas, resolved, got in calls:
        want = _mxtpu_decision(jq._quant_decision, name, metas, resolved)
        assert got is want is True, (name, resolved)


# --------------------------------------- serving: ModelRunner, calibrate

def _fc_runner(**kwargs):
    data = tsym.var("data")
    h = tsym.FullyConnected(data, tsym.var("w1"), tsym.var("b1"),
                            num_hidden=8)
    h = tsym.Activation(h, act_type="relu")
    out = tsym.FullyConnected(h, tsym.var("w2"), tsym.var("b2"),
                              num_hidden=4)
    rng = np.random.RandomState(3)
    params = {"w1": (rng.randn(8, 6) / np.sqrt(6)).astype(np.float32),
              "b1": np.zeros(8, np.float32),
              "w2": (rng.randn(4, 8) / np.sqrt(8)).astype(np.float32),
              "b2": np.zeros(4, np.float32)}
    return ModelRunner(out, params, {"data": (6,)}, max_batch_size=2,
                       device="cpu", **kwargs), params


def _calib_batches(scale=1.0, n=3):
    rng = np.random.RandomState(11)
    return [{"data": (scale * rng.randn(2, 6)).astype(np.float32)}
            for _ in range(n)]


@pytest.mark.parametrize("mode", ["minmax", "entropy"])
def test_calibration_is_deterministic(mode):
    runs = []
    for _ in range(2):
        r, _ = _fc_runner(quant=True)
        runs.append(r.calibrate(_calib_batches(), mode=mode))
    assert runs[0] == runs[1]
    assert sorted(runs[0]) == ["FullyConnected_0", "FullyConnected_1"]
    r, _ = _fc_runner(quant=True)
    first = r.calibrate(_calib_batches(), mode=mode)
    again = r.calibrate(_calib_batches(), mode=mode)
    assert first == again == r.quant_scales()


@pytest.mark.parametrize("mode", ["minmax", "entropy"])
def test_fc_runner_calibrates_and_serves_as_mxtpu(shims, mode):
    """The toy graph through both packages' runners: the same keys and
    thresholds, num_batches honoured; the served int8 outputs within an
    f32 ulp (mxtpu's compiled bucket fuses the dequantize epilogue and
    the bias into one multiply-add, one rounding fewer than the eager
    op, which matches the port bit for bit above)."""
    t, params = _fc_runner(quant=True)
    data = jmx.symbol.var("data")
    h = jmx.symbol.FullyConnected(data, jmx.symbol.var("w1"),
                                  jmx.symbol.var("b1"), num_hidden=8)
    h = jmx.symbol.Activation(h, act_type="relu")
    out = jmx.symbol.FullyConnected(h, jmx.symbol.var("w2"),
                                    jmx.symbol.var("b2"), num_hidden=4)
    j = JRunner(out, params, {"data": (6,)}, max_batch_size=2, cache=None,
                quant=True)
    batches = _calib_batches(n=4)
    assert t.calibrate(batches, mode=mode, num_batches=3) == \
        j.calibrate(batches, mode=mode, num_batches=3)
    x = np.random.RandomState(4).randn(2, 6).astype(np.float32)
    (got,), (want,) = t.infer({"data": x}), j.infer({"data": x})
    np.testing.assert_allclose(got, want, rtol=3e-7, atol=1e-7)


def test_calibrate_guardrails():
    r, _ = _fc_runner(quant=True)
    with pytest.raises(MXNetError, match="no calibrated scales"):
        r.warmup()
    r.calibrate(_calib_batches())
    r.warmup([r.buckets()[0]])
    with pytest.raises(MXNetError, match="after buckets were built"):
        r.calibrate(_calib_batches())
    mul = ModelRunner(tsym.var("data") * tsym.var("w"),
                      {"w": np.ones(3, np.float32)}, {"data": (3,)},
                      max_batch_size=2, device="cpu", quant=True)
    with pytest.raises(MXNetError, match="no quantizable"):
        mul.calibrate([{"data": np.ones((2, 3), np.float32)}])
    plain, _ = _fc_runner()
    with pytest.raises(MXNetError, match="non-quantized"):
        plain.calibrate(_calib_batches())
    assert plain.quant_scales() is None


def test_kill_switch_serves_the_float_path(monkeypatch):
    """MXTPU_QUANT=0 with quant=True: not a quantized runner (calibrate
    refuses) and its outputs are the plain runner's, bit for bit."""
    monkeypatch.setenv("MXTPU_QUANT", "0")
    killed, _ = _fc_runner(quant=True)
    with pytest.raises(MXNetError, match="non-quantized"):
        killed.calibrate(_calib_batches())
    monkeypatch.delenv("MXTPU_QUANT")
    plain, _ = _fc_runner()
    armed, _ = _fc_runner(quant=True)
    armed.calibrate(_calib_batches())
    x = np.random.RandomState(5).randn(2, 6).astype(np.float32)
    (k,), (p,), (a,) = (r.infer({"data": x}) for r in (killed, plain,
                                                       armed))
    np.testing.assert_array_equal(k, p)
    assert not np.array_equal(a, p)


@pytest.fixture(scope="module")
def serving_bert():
    """mxtpu's quantized serving fixture (``tools/hlocheck/targets.py``
    ``_serving_runner``: a 2-layer BERT, V 512, U 64, entropy-calibrated
    on 4 seeded (4, 32) batches) and its f32 twin, under the shims; the
    port's runners on the same graph and weights."""
    from tools.hlocheck import targets as T
    from mxtpu.ndarray import random as mxrnd
    with jax09_shims():
        mxrnd.seed(0)
        jf32 = T._serving_runner()
        jq8 = T._serving_runner(quant=True)
        jboth = T._serving_runner(amp=True, quant=True)
        bucket = (4, 32)
        rng = np.random.RandomState(123)
        reqs = [{"data": rng.randint(0, T._VOCAB, (32,))
                 .astype(np.float32)} for _ in range(4)]
        jl = [np.asarray(r.run_raw(r._pad_stack(reqs, bucket), bucket)[0])
              for r in (jf32, jq8, jboth)]
    sym = tsym.fromjson(jq8._symbol.tojson())
    params = {n: np.asarray(v) for n, v in zip(jq8._param_names,
                                               jq8._param_vals)}
    spec = dict(input_specs={"data": (None,)}, seq_buckets=[16, 32],
                max_batch_size=4, device="cpu")
    tf32 = ModelRunner(sym, params, **spec)
    tq8 = ModelRunner(sym, params, quant=True, **spec)
    scales = tq8.calibrate(T._quant_calib_batches(), mode="entropy")
    return {"j_scales": jq8.quant_scales(), "t_scales": scales,
            "j_amp_scales": jboth.quant_scales(),
            "jl": jl, "tf32": tf32, "tq8": tq8, "reqs": reqs,
            "bucket": bucket, "sym": sym, "params": params,
            "calib": T._quant_calib_batches()}


def test_bert_calibration_matches_mxtpu(serving_bert):
    """mxtpu's census of 9 keys (4 GEMMs a layer and the head), every
    threshold equal."""
    t, j = serving_bert["t_scales"], serving_bert["j_scales"]
    assert sorted(t) == sorted(j) == [f"FullyConnected_{i}"
                                      for i in range(9)]
    assert t == j


def test_bert_int8_accuracy_and_census(serving_bert, monkeypatch):
    """mxtpu's acceptance gate on the port: the int8 logits within 10 %
    of the f32 logits' scale; 9 int8 × int8 → int32 products a forward;
    the port's int8 logits against mxtpu's within NET_TOL of the
    scale."""
    s = serving_bert
    bucket = s["bucket"]
    products = []
    real = tq.int_mm

    def spy(a, w):
        out = real(a, w)
        products.append((a.dtype, w.dtype, out.dtype))
        return out
    monkeypatch.setattr(tq, "int_mm", spy)
    lq = s["tq8"].run_raw(s["tq8"]._pad_stack(s["reqs"], bucket),
                          bucket)[0].numpy()
    assert products == [(torch.int8, torch.int8, torch.int32)] * 9
    lf = s["tf32"].run_raw(s["tf32"]._pad_stack(s["reqs"], bucket),
                           bucket)[0].numpy()
    jf, jq8, _ = s["jl"]
    scale = float(np.abs(lf).max())
    delta = float(np.abs(lq - lf).max())
    assert 0 < delta <= GATE * max(1.0, scale), (delta, scale)
    np.testing.assert_allclose(lf, jf, rtol=1e-4, atol=1e-4)
    assert float(np.abs(lq - jq8).max()) <= NET_TOL * max(1.0, scale)


def test_bert_int8_buckets_equal_the_eager_forward(serving_bert):
    """Every bucket's entry (the plan run eagerly on the CPU) inside the
    quantize scope equals the forward run directly."""
    s = serving_bert
    r = s["tq8"]
    rng = np.random.RandomState(9)
    for b, sq in r.buckets():
        vals = r._pad_stack([{"data": rng.randint(0, 512, sq)
                              .astype(np.float32)} for _ in range(b)],
                            (b, sq))
        (got,) = r.run_raw(vals, (b, sq))
        (want,) = r._forward(*vals)
        assert torch.equal(got, want)


def test_quantized_amp_runner(serving_bert):
    """quant and amp together, as mxtpu's runner has them: the weights
    stored bf16 (so calibrated on the bf16-rounded weights: mxtpu's
    thresholds, key for key), outputs f32, within NET_TOL of mxtpu's
    and within the int8 gate of the f32 logits."""
    s = serving_bert
    spec = dict(input_specs={"data": (None,)}, seq_buckets=[16, 32],
                max_batch_size=4, device="cpu")
    r = ModelRunner(s["sym"], s["params"], quant=True, amp=True, **spec)
    assert r.calibrate(s["calib"], mode="entropy") == s["j_amp_scales"]
    assert {v.dtype for v in r.weight_buffers()} == {torch.bfloat16}
    bucket = s["bucket"]
    got = r.run_raw(r._pad_stack(s["reqs"], bucket), bucket)[0]
    assert got.dtype == torch.float32
    lf = s["tf32"].run_raw(s["tf32"]._pad_stack(s["reqs"], bucket),
                           bucket)[0].numpy()
    scale = float(np.abs(lf).max())
    assert float(np.abs(got.numpy() - lf).max()) <= GATE * max(1.0, scale)
    assert float(np.abs(got.numpy() - s["jl"][2]).max()) <= \
        NET_TOL * max(1.0, scale)


# ------------------------------------------ generation with quant_scales

@pytest.fixture(scope="module")
def gen_pair(tmp_path_factory):
    """A causal 2-layer BERT's incremental export (mxtpu's), the
    thresholds a ModelRunner calibrated on its full-sequence graph, and
    quantized GenerateRunners of both packages on it."""
    from mxtpu.models.transformer import BERTModel as JBERT
    from mxtpu_torch.models import BERTModel
    from tests.torch_gluon_names import fresh_names
    V, U, HID, NL, NH, L = 32, 16, 32, 2, 2, 16
    d = tmp_path_factory.mktemp("qgen")
    with fresh_names():
        jnet = JBERT(V, U, HID, NL, NH, max_length=L, dropout=0.0,
                     use_token_type=False, causal=True)
    jnet.initialize()
    jnet.hybridize()
    kv1 = np.zeros(jnet.kv_cache_spec(1), np.float32)
    jnet(jmx.nd.array(np.ones((1, 3))), jmx.nd.array(np.zeros(1)),
         jmx.nd.array(kv1))
    rng = np.random.RandomState(0)
    for p in jnet.collect_params().values():
        if not p.name.endswith(("_gamma", "_beta")):
            p.set_data(jmx.nd.array(rng.uniform(-0.3, 0.3, p.shape)
                                    .astype(np.float32)))
    files = jnet.export(str(d / "g"))
    params = tmx.nd.load_params(files[1])
    # calibration on the full-sequence graph of the same weights
    with fresh_names():
        tnet = BERTModel(V, U, HID, NL, NH, max_length=L, dropout=0.0,
                         use_token_type=False, causal=True)
    from mxtpu_torch.convert import params_from_mxtpu
    params_from_mxtpu(params, tnet)
    tnet(torch.zeros(1, 4))
    full = tnet.export(str(d / "full"))
    cal = ModelRunner.from_export(*full, input_specs={"data": (None,)},
                                  seq_buckets=[8], max_batch_size=2,
                                  device="cpu", quant=True)
    scales = cal.calibrate([{"data": rng.randint(0, V, (2, 8))
                             .astype(np.float32)} for _ in range(2)],
                           mode="minmax")
    spec = jnet.kv_cache_spec(2, L)
    kw = dict(prompt_buckets=(4, 8))
    with jax09_shims():
        j = JGenRunner.from_export(*files, spec, cache=None, quant=True,
                                   quant_scales=scales, **kw)
        t = GenerateRunner.from_export(*files, spec, device="cpu",
                                       quant=True, quant_scales=scales,
                                       **kw)
    return j, t, scales, files, spec


def test_generate_runner_with_quant_scales_matches_mxtpu(gen_pair,
                                                         monkeypatch):
    """A prefill and two decode steps: logits and the KV lanes against
    mxtpu's quantized runner (NET_TOL of the scale), 9 int8 products a
    call."""
    j, t, scales, _, _ = gen_pair
    assert len(scales) == 9
    products = []
    real = tq.int_mm

    def spy(a, w):
        products.append((a.dtype, w.dtype))
        return real(a, w)
    monkeypatch.setattr(tq, "int_mm", spy)
    toks = np.array([[3, 7, 1, 4], [5, 2, 9, 9]], np.float32)
    lanes = np.array([0, 1], np.float32)
    step = np.zeros(2, np.float32)
    with jax09_shims():
        jl, jkv = j.prefill(toks, step, lanes, j.new_cache())
        tl, tkv = t.prefill(toks, step, lanes, t.new_cache())
        assert len(products) == 9
        logs = [(tl, jl)]
        for i in range(2):
            dt = np.zeros((3, 1), np.float32)
            ds = np.zeros(3, np.float32)
            dt[:2, 0], ds[:2] = [11, 12], 4 + i
            jl, jkv = j.decode(dt, ds, jkv)
            tl, tkv = t.decode(dt, ds, tkv)
            logs.append((tl, jl))
    scale = max(1.0, max(float(np.abs(b).max()) for _, b in logs))
    for a, b in logs:
        assert np.abs(a - np.asarray(b)).max() <= NET_TOL * scale
    np.testing.assert_allclose(tkv[:, :, :2].numpy(),
                               np.asarray(jkv)[:, :, :2],
                               atol=NET_TOL * scale, rtol=0)


def test_quantized_generate_runner_without_scales_raises(gen_pair):
    _, _, _, files, spec = gen_pair
    r = GenerateRunner.from_export(*files, spec, prompt_buckets=(4,),
                                   device="cpu", quant=True)
    with pytest.raises(MXNetError, match="no calibrated scales"):
        r.warmup()
    with jax09_shims():
        j = JGenRunner.from_export(*files, spec, prompt_buckets=(4,),
                                   cache=None, quant=True)
        with pytest.raises(jmx.base.MXNetError,
                           match="no calibrated scales"):
            j.warmup()


# ---------------------------------------------------------- self-check

def test_self_check_passes():
    assert tq.self_check() == 0


def test_self_check_cli():
    r = subprocess.run([sys.executable, "-m", "mxtpu_torch.quant",
                        "--self-check"], capture_output=True, text=True,
                       cwd=_ROOT, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "round trip OK" in r.stdout
