"""The port's encoder-decoder Transformer (``MultiHeadAttention`` with a
memory, ``TransformerDecoderCell``, ``TransformerDecoder``,
``TransformerModel`` and the factories) held against mxtpu's on the
CPU: the same weights from a numpy seed in both packages, moved by
name with ``convert``, the same seeded inputs.

Tolerances: outputs within 1e-5 (f32 sums in another order), each
gradient within 1e-4 of its norm (relative L2); exports byte for byte;
the incremental call within 1e-5 of mxtpu's and of the port's own full
forward.  mxtpu's flash attention and LayerNorm run as its own tests
run them on the CPU.
"""
import json

import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu.symbol as jsym
from mxtpu import parallel as jpar
from mxtpu.gluon import loss as jloss
from mxtpu.gluon.block import HybridBlock as JHybridBlock
from mxtpu.models import transformer as jtr

import mxtpu_torch as tmx
import mxtpu_torch.symbol as tsym
from mxtpu_torch import MXNetError, gluon
from mxtpu_torch import random as trandom
from mxtpu_torch.convert import params_from_mxtpu, params_to_mxtpu
from mxtpu_torch.gluon import loss as tloss
from mxtpu_torch.gluon.block import HybridBlock
from mxtpu_torch.models import transformer as ttr
from mxtpu_torch.parallel import build_train_step

from tests.torch_amp_helpers import jax09_shims
from tests.torch_gluon_names import fresh_names

torch.set_num_threads(2)

CPU = tmx.cpu()
V, U, HID, NL, NH, L = 64, 32, 64, 2, 4, 16
TOL = 1e-5          # outputs: f32 sums in another order
GRAD_TOL = 1e-4     # gradients, relative to their norm
LOSS_RTOL = 1e-3    # AMP losses against mxtpu's (tests/test_torch_amp.py)
PARITY = dict(rtol=3e-2, atol=1e-2)   # AMP vs f32 (tests/test_amp.py)


def _weights(shapes, seed=0):
    """Weights from a numpy seed: uniform(-0.07, 0.07) as mxtpu's
    default initializer draws, norm scales 1 and shifts 0."""
    rng = np.random.RandomState(seed)
    out = {}
    for n, shape in shapes.items():
        if n.endswith("_gamma"):
            out[n] = np.ones(shape, np.float32)
        elif n.endswith("_beta"):
            out[n] = np.zeros(shape, np.float32)
        else:
            out[n] = rng.uniform(-0.07, 0.07, shape).astype(np.float32)
    return out


def _pair(make, *settle, seed=0):
    """``make(module)`` built in both packages under fresh names, with
    the same seeded weights (mxtpu's deferred shapes settled by one
    forward of ``settle``); returns (mxtpu's net, the port's, weights)."""
    with fresh_names():
        jnet, tnet = make(jtr), make(ttr)
    jnet.initialize()
    jnet(*[jmx.nd.array(a) for a in settle])
    w = _weights({n: p.shape for n, p in jnet.collect_params().items()},
                 seed)
    for n, p in jnet.collect_params().items():
        p.set_data(jmx.nd.array(w[n]))
    return jnet, params_from_mxtpu(w, tnet), w


def _run(mx, net, inputs, dy, grad_inputs, **ctx):
    """Output, input gradients and parameter gradients of ``sum(out *
    dy)`` through either package's NDArray autograd."""
    xs = [mx.nd.array(a, **ctx) for a in inputs]
    if grad_inputs:
        for x in xs:
            x.attach_grad()
    with mx.autograd.record():
        out = net(*xs)
    out.backward(mx.nd.array(dy, **ctx))
    return (out.asnumpy(),
            [x.grad.asnumpy() for x in xs] if grad_inputs else [],
            {n: p.grad().asnumpy() for n, p in
             net.collect_params().items()})


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), 1e-30))


def _same_run(jnet, tnet, inputs, out_shape, grad_inputs, seed=1):
    dy = np.random.RandomState(seed).randn(*out_shape).astype(np.float32)
    jo, jgx, jgp = _run(jmx, jnet, inputs, dy, grad_inputs)
    to, tgx, tgp = _run(tmx, tnet, inputs, dy, grad_inputs, ctx=CPU)
    np.testing.assert_allclose(to, jo, rtol=TOL, atol=TOL)
    for i, (a, b) in enumerate(zip(tgx, jgx)):
        assert _rel(a, b) <= GRAD_TOL, f"input {i}: {_rel(a, b):.3e}"
    assert list(tgp) == list(jgp)
    for n in jgp:
        assert _rel(tgp[n], jgp[n]) <= GRAD_TOL, \
            f"{n}: {_rel(tgp[n], jgp[n]):.3e}"


def _tokens(seed, shape):
    return np.random.RandomState(seed).randint(0, V, shape) \
        .astype(np.float32)


def _model(m, dropout=0.0, remat=False):
    return m.TransformerModel(V, U, HID, NL, NH, max_length=L,
                              dropout=dropout, remat=remat)


# ------------------------------------------------------ the blocks

@pytest.mark.parametrize("causal", [False, True])
def test_cross_attention_matches_mxtpu(causal):
    """Queries from x at Tq 8, keys and values from memory at Tk 12:
    the output and the gradients of x, memory and every weight."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, U).astype(np.float32)
    mem = rng.randn(2, 12, U).astype(np.float32)
    jnet, tnet, _ = _pair(
        lambda m: m.MultiHeadAttention(U, NH, causal=causal), x, mem)
    _same_run(jnet, tnet, (x, mem), (2, 8, U), grad_inputs=True)


def test_decoder_cell_matches_mxtpu():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 8, U).astype(np.float32)
    mem = rng.randn(2, 12, U).astype(np.float32)
    jnet, tnet, _ = _pair(
        lambda m: m.TransformerDecoderCell(U, HID, NH, dropout=0.0), x, mem)
    assert [type(c).__name__ for c in tnet.children()] == \
        ["MultiHeadAttention", "MultiHeadAttention", "PositionwiseFFN",
         "FusedResidualLayerNorm", "FusedResidualLayerNorm",
         "FusedResidualLayerNorm"]
    _same_run(jnet, tnet, (x, mem), (2, 8, U), grad_inputs=True)


def test_decoder_matches_mxtpu():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 7, U).astype(np.float32)
    mem = rng.randn(2, 11, U).astype(np.float32)
    jnet, tnet, _ = _pair(
        lambda m: m.TransformerDecoder(NL, U, HID, NH, dropout=0.0), x, mem)
    _same_run(jnet, tnet, (x, mem), (2, 7, U), grad_inputs=True)


@pytest.mark.parametrize("ts, tt", [(12, 8), (8, 12), (16, 16)])
def test_transformer_model_matches_mxtpu(ts, tt):
    """The full call (src, tgt): logits and every parameter's gradient,
    source and target at other lengths than each other."""
    src, tgt = _tokens(4, (2, ts)), _tokens(5, (2, tt))
    jnet, tnet, _ = _pair(_model, src, tgt)
    _same_run(jnet, tnet, (src, tgt), (2, tt, V), grad_inputs=False)


def test_names_shapes_and_order_match_mxtpu():
    src, tgt = _tokens(4, (2, 12)), _tokens(5, (2, 8))
    jnet, tnet, _ = _pair(_model, src, tgt)
    jp, tp = jnet.collect_params(), tnet.collect_params()
    assert list(tp) == list(jp)
    for n in jp:
        assert tuple(tp[n].shape) == tuple(jp[n].shape), n


def test_transformer_big_config():
    """transformer_big pins the WMT big configuration, with mxtpu's
    names before any initialization (as mxtpu's own test checks it)."""
    with fresh_names():
        jnet = jtr.transformer_big(vocab_size=512, max_length=32)
        net = ttr.transformer_big(vocab_size=512, max_length=32)
    assert isinstance(net, ttr.TransformerModel)
    assert len(net.encoder.layers) == 6 and len(net.decoder.layers) == 6
    enc0 = net.encoder.layers[0]
    assert enc0.attn._heads == 16 and enc0.attn._units == 1024
    assert enc0.ffn.ffn1._units == 4096
    assert net.pos_embed.shape == (32, 1024)
    assert list(net.collect_params()) == list(jnet.collect_params())
    base = ttr.transformer_base()
    assert base.encoder.layers[0].attn._units == 512 and \
        base.encoder.layers[0].attn._heads == 8
    enc = ttr.transformer_encoder(num_layers=2)
    assert isinstance(enc, ttr.TransformerEncoder) and len(enc.layers) == 2
    import mxtpu_torch.models as tmodels
    for name in ("TransformerDecoderCell", "TransformerDecoder",
                 "TransformerModel", "transformer_encoder",
                 "transformer_base", "transformer_big"):
        assert name in ttr.__all__ and hasattr(tmodels, name)


def test_length_beyond_max_length_raises():
    net = _model(ttr)
    net.initialize(ctx=CPU)
    ok = torch.zeros(1, L)
    for src, tgt in ((torch.zeros(1, L + 1), ok), (ok, torch.zeros(1, L + 1))):
        with pytest.raises(MXNetError, match="max_length"):
            net(src, tgt)


def test_params_cross_both_ways():
    src, tgt = _tokens(4, (2, 12)), _tokens(5, (2, 8))
    jnet, tnet, w = _pair(_model, src, tgt)
    back = params_to_mxtpu(tnet)
    assert list(back) == list(w)
    for n in w:
        np.testing.assert_array_equal(back[n], w[n], err_msg=n)


# ------------------------------------------------------ incremental

def _cache(net, b):
    return np.zeros(net.kv_cache_spec(b), np.float32)


def test_kv_cache_spec():
    net = _model(ttr)
    assert net.kv_cache_spec(3) == (NL, 2, 3, NH, L, U // NH)
    assert net.kv_cache_spec(2, 9) == (NL, 2, 2, NH, 9, U // NH)


def test_incremental_matches_mxtpu():
    """Two lanes at different frontiers over a random cache: a 3-token
    step then a 1-token step, logits and the cache in both packages."""
    src = _tokens(6, (2, 10))
    jnet, tnet, _ = _pair(_model, src, _tokens(7, (2, 5)))
    rng = np.random.RandomState(0)
    cache = rng.randn(*_cache(tnet, 2).shape).astype(np.float32)
    jc, tc = jmx.nd.array(cache), tmx.nd.array(cache, ctx=CPU)
    for toks, step in ((_tokens(8, (2, 3)), [0.0, 4.0]),
                       (_tokens(9, (2, 1)), [3.0, 7.0])):
        step = np.array(step, np.float32)
        jl, jc = jnet(jmx.nd.array(src), jmx.nd.array(toks),
                      jmx.nd.array(step), jc)
        tl, tc = tnet(*[tmx.nd.array(a, ctx=CPU) for a in
                        (src, toks, step)], tc)
        np.testing.assert_allclose(tl.asnumpy(), jl.asnumpy(),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tc.asnumpy(), jc.asnumpy(),
                                   rtol=TOL, atol=TOL)


def test_incremental_matches_full_forward():
    """A 4-token prefill, then one token a step: each step's logits are
    the full call's at that position of the same prefix."""
    src = _tokens(10, (1, 9))
    _, net, _ = _pair(_model, src, _tokens(11, (1, 4)))
    s = tmx.nd.array(src, ctx=CPU)
    toks = [3, 7, 1, 4]
    cache = tmx.nd.array(_cache(net, 1), ctx=CPU)
    x = tmx.nd.array(np.array([toks], np.float32), ctx=CPU)
    inc, cache = net(s, x, tmx.nd.array(np.zeros(1, np.float32), ctx=CPU),
                     cache)
    np.testing.assert_allclose(inc.asnumpy(), net(s, x).asnumpy(),
                               rtol=TOL, atol=TOL)
    nxt = int(np.argmax(inc.asnumpy()[0, -1]))
    for _ in range(4):
        toks.append(nxt)
        step = tmx.nd.array(np.array([len(toks) - 1], np.float32), ctx=CPU)
        inc, cache = net(s, tmx.nd.array(np.array([[nxt]], np.float32),
                                         ctx=CPU), step, cache)
        full = net(s, tmx.nd.array(np.array([toks], np.float32), ctx=CPU))
        np.testing.assert_allclose(inc.asnumpy()[0, 0],
                                   full.asnumpy()[0, -1], rtol=TOL, atol=TOL)
        nxt = int(np.argmax(inc.asnumpy()[0, 0]))


# ------------------------------------------------------ export

@pytest.mark.parametrize("mode", ["full", "incremental"])
def test_export_is_mxtpus(tmp_path, monkeypatch, mode):
    """Both calls export byte-equal to mxtpu's (inputs data0..data1 or
    data0..data3); the port's export imports and runs."""
    src, tgt = _tokens(12, (2, 10)), _tokens(13, (2, 6))
    jnet, tnet, _ = _pair(_model, src, tgt)
    ins = [src, tgt]
    if mode == "incremental":
        ins += [np.zeros(2, np.float32), _cache(tnet, 2)]
    jnet(*[jmx.nd.array(a) for a in ins])
    want = tnet(*[tmx.nd.array(a, ctx=CPU) for a in ins])
    monkeypatch.setattr(jsym, "_NAME_COUNTERS", {})
    jsf = jnet.export(str(tmp_path / "j"))[0]
    monkeypatch.setattr(tsym, "_NAME_COUNTERS", {})
    tsf, tpf = tnet.export(str(tmp_path / "t"))
    with open(jsf) as a, open(tsf) as b:
        text = b.read()
        assert text == a.read()
    graph = json.loads(text)
    names = [graph["nodes"][i]["name"] for i in graph["arg_nodes"]]
    assert sorted(n for n in names if n.startswith("data")) == \
        [f"data{i}" for i in range(len(ins))]
    assert len(graph["heads"]) == (2 if mode == "incremental" else 1)
    blk = gluon.SymbolBlock.imports(tsf, [f"data{i}" for i in
                                          range(len(ins))], tpf, ctx=CPU)
    got = blk(*[tmx.nd.array(a, ctx=CPU) for a in ins])
    if mode == "incremental":
        got, want = got[0], want[0]
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-6,
                               atol=1e-6)


# ------------------------------------------------------ training

def test_copy_task_loss_falls():
    """mxtpu's test_transformer_model_smoke_train through the port's
    Gluon loop: a tiny encoder-decoder learns to copy, the decoder's
    causal self-attention and cross-attention at T = 12."""
    trandom.seed(0)
    net = ttr.TransformerModel(16, units=32, hidden_size=64, num_layers=2,
                               num_heads=4, max_length=16, dropout=0.0)
    net.initialize(init="xavier", ctx=CPU)
    net.hybridize()
    tr = gluon.Trainer(net.collect_params(), "adam",
                       {"learning_rate": 3e-3})
    ce = tloss.SoftmaxCrossEntropyLoss()
    rng = np.random.RandomState(0)
    losses = []
    for _ in range(30):
        toks = tmx.nd.array(rng.randint(0, 16, (8, 12)).astype(np.float32),
                            ctx=CPU)
        with tmx.autograd.record():
            out = net(toks, toks)
            loss = ce(out.reshape((-1, 16)), toks.reshape((-1,)))
        loss.backward()
        tr.step(8)
        losses.append(float(loss.mean().asnumpy()))
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])


class _Wrap(HybridBlock):
    """bench_transformer's wrapper: src|tgt ride one batch array on the
    time axis, split with slice_axis."""

    def __init__(self, model, split, **kw):
        super().__init__(**kw)
        self._split = split
        self.model = model

    def hybrid_forward(self, F, x):
        src = F.slice_axis(x, axis=1, begin=0, end=self._split)
        tgt = F.slice_axis(x, axis=1, begin=self._split, end=None)
        return self.model(src, tgt)


class _JWrap(JHybridBlock):
    def __init__(self, model, split, **kw):
        super().__init__(**kw)
        self._split = split
        self.model = model

    def hybrid_forward(self, F, x):
        src = F.slice_axis(x, axis=1, begin=0, end=self._split)
        tgt = F.slice_axis(x, axis=1, begin=self._split, end=None)
        return self.model(src, tgt)


def _t_ce(pred, y):
    return tloss.SoftmaxCrossEntropyLoss()(pred.reshape(-1, V),
                                           y.reshape(-1))


def _j_ce(pred, y):
    return jloss.SoftmaxCrossEntropyLoss()(pred.reshape((-1, V)),
                                           y.reshape((-1,)))


def _mt_batch(b=2, ts=8, tt=6, seed=20):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, V, (b, ts + tt)).astype(np.float32),
            rng.randint(0, V, (b, tt)).astype(np.float32))


def _mt_pair(ts=8, tt=6):
    x, _ = _mt_batch(ts=ts, tt=tt)
    jnet, tnet, w = _pair(
        lambda m: (_Wrap if m is ttr else _JWrap)(_model(m), ts),
        x)
    return jnet, tnet, w


def _mt_tnet(w, ts=8):
    with fresh_names():
        net = _Wrap(_model(ttr), ts)
    return params_from_mxtpu(w, net)


def test_train_step_matches_mxtpu(monkeypatch):
    """bench_transformer's step (adam lr 1e-4, cast_batch=False) in f32,
    3 steps in both packages from the same weights: losses and every
    weight (mxtpu on its per-parameter update)."""
    x, y = _mt_batch()
    jnet, tnet, _ = _mt_pair()
    kw = dict(cast_batch=False)
    tstep = build_train_step(tnet, _t_ce, "adam", {"learning_rate": 1e-4},
                             device="cpu", **kw)
    tl = [float(tstep(x, y)) for _ in range(3)]
    monkeypatch.setenv("MXTPU_BATCHED_OPT", "0")
    jstep = jpar.build_train_step(jnet, _j_ce, "adam",
                                  {"learning_rate": 1e-4}, **kw)
    jl = [float(jstep(jmx.nd.array(x), jmx.nd.array(y)).asscalar())
          for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    assert tl[-1] < tl[0]
    tp = tnet.collect_params()
    for n, p in jnet.collect_params().items():
        np.testing.assert_allclose(tp[n].data().asnumpy(),
                                   p.data().asnumpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=n)


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_run_steps_and_states_on_the_transformer(tmp_path, compute_dtype):
    """Three run_steps(x, y, 1) equal three eager steps bit for bit on
    the wrapped model (a call samples adam's bias correction once, for
    its last step); save_states then load_states into a fresh step
    gives the same next step bit for bit; bf16 compute trains (finite,
    falling)."""
    x, y = _mt_batch()
    _, _, w = _mt_pair()

    def step():
        return build_train_step(_mt_tnet(w), _t_ce, "adam",
                                {"learning_rate": 1e-3},
                                compute_dtype=compute_dtype,
                                cast_batch=False, device="cpu")
    eager, bulk = step(), step()
    el = [eager(x, y) for _ in range(3)]
    bl = [bulk.run_steps(x, y, 1, reuse_batch=True) for _ in range(3)]
    assert torch.equal(torch.stack(el), torch.cat(bl))
    for a, b in zip(eager.net.parameters(), bulk.net.parameters()):
        assert torch.equal(a, b)
    assert all(np.isfinite(float(v)) for v in el) and \
        float(el[-1]) < float(el[0])
    fname = str(tmp_path / "s.states")
    eager.save_states(fname)
    again = step()
    params_from_mxtpu(params_to_mxtpu(eager.net), again.net)
    again.load_states(fname)
    assert torch.equal(again(x, y), eager(x, y))
    for a, b in zip(eager.net.parameters(), again.net.parameters()):
        assert torch.equal(a, b)


def test_amp_parity_transformer(monkeypatch):
    """test_amp.py::test_amp_parity_transformer in the port: 3 AMP steps
    against 3 f32 steps at mxtpu's parity bar, and against mxtpu's AMP
    steps (its passes repaired by the jax-0.9 shims) at the AMP tests'
    loss tolerance; the loss scaler's state as mxtpu's."""
    rng = np.random.RandomState(0)
    x = rng.randint(0, 128, (2, 16)).astype(np.float32)
    y = rng.randint(0, 128, (2, 8)).astype(np.float32)

    def make(m):
        model = m.TransformerModel(128, units=32, hidden_size=64,
                                   num_layers=1, num_heads=2,
                                   max_length=32, dropout=0.0)
        return (_Wrap if m is ttr else _JWrap)(model, 8)
    jnet0, _, w = _pair(make, x)

    def tnet():
        with fresh_names():
            net = make(ttr)
        return params_from_mxtpu(w, net)

    t_loss = lambda p, t: tloss.SoftmaxCrossEntropyLoss()(  # noqa: E731
        p.reshape(-1, 128), t.reshape(-1))
    j_loss = lambda p, t: jloss.SoftmaxCrossEntropyLoss()(  # noqa: E731
        p.reshape((-1, 128)), t.reshape((-1,)))
    kw = dict(cast_batch=False)
    amp = build_train_step(tnet(), t_loss, "adam", {"learning_rate": 1e-4},
                           amp=True, device="cpu", **kw)
    al = [float(amp(x, y)) for _ in range(3)]
    f32 = build_train_step(tnet(), t_loss, "adam", {"learning_rate": 1e-4},
                           device="cpu", **kw)
    fl = [float(f32(x, y)) for _ in range(3)]
    np.testing.assert_allclose(al, fl, **PARITY)
    monkeypatch.setenv("MXTPU_BATCHED_OPT", "0")
    with jax09_shims():
        jstep = jpar.build_train_step(jnet0, j_loss, "adam",
                                      {"learning_rate": 1e-4}, amp=True,
                                      **kw)
        jl = [float(jstep(jmx.nd.array(x), jmx.nd.array(y)).asscalar())
              for _ in range(3)]
    np.testing.assert_allclose(al, jl, rtol=LOSS_RTOL)
    assert amp.amp_stats() == jstep.amp_stats()
    assert all(p.dtype == torch.bfloat16 for n, p in
               amp.net.named_parameters() if p.requires_grad)
