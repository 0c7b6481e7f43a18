"""Generation serving in the port against mxtpu: BERT's incremental
decode (``net(tokens, step, cache)``), ``GenerateRunner``,
``GenerateBatcher``'s continuous batching and the server's generator
endpoints (``mxtpu_torch/serving/generate.py``, ``server.py``).

mxtpu's fixture widths (``tests/test_generate.py``): V 32, U 16, HID 32,
2 layers of 2 heads, L 16, 2 lanes, prompt buckets (4, 8).  Both
packages build the net under fresh name counters and take the same
weights (mxtpu's, carried by ``params_from_mxtpu``); mxtpu runs on the
CPU as its own tests run it.  Every case of ``tests/test_generate.py``
is mirrored against the port except those that need the persistent
executable cache, int8, HLO text or the fleet.
"""
import json

import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu.symbol as jsym
from mxtpu.models.transformer import BERTModel as JBERT
from mxtpu.serving import GenerateBatcher as JBatcher
from mxtpu.serving import GenerateRunner as JRunner
from mxtpu.serving import WorkerLost as JWorkerLost

import mxtpu_torch as tmx
import mxtpu_torch.symbol as tsym
from mxtpu_torch import MXNetError, nd
from mxtpu_torch.convert import params_from_mxtpu, params_to_mxtpu
from mxtpu_torch.models import BERTModel
from mxtpu_torch.serving import (GenerateBatcher, GenerateRunner,
                                 InferenceServer, RequestTimeout,
                                 ServerBusy, WorkerLost, sample_token)
from mxtpu_torch.serving.stats import ServingStats

from tests.torch_gluon_names import fresh_names

torch.set_num_threads(2)

CPU = tmx.cpu()
V, U, HID, NL, NH, L = 32, 16, 32, 2, 2, 16
LANES = 2
BUCKETS = (4, 8)
TOL = 1e-5


class FakeClock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _bert(cls):
    return cls(V, U, HID, NL, NH, max_length=L, dropout=0.0,
               use_token_type=False, causal=True)


def _cache(b):
    return np.zeros(_bert(BERTModel).kv_cache_spec(b), np.float32)


def _weights(shapes, seed=0):
    """Weights from a numpy seed, whatever ran before in the process:
    uniform(-0.07, 0.07) as mxtpu's default initializer draws, norm
    scales 1 and shifts 0."""
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


@pytest.fixture(scope="module")
def nets():
    """mxtpu's net (incremental signature traced) and the port's, both
    with the same seeded weights."""
    with fresh_names():
        jnet, tnet = _bert(JBERT), _bert(BERTModel)
    jnet.initialize()
    jnet.hybridize()
    jnet(jmx.nd.array(np.ones((1, 3))), jmx.nd.array(np.zeros(1)),
         jmx.nd.array(_cache(1)))
    w = _weights({n: p.shape for n, p in jnet.collect_params().items()})
    for n, p in jnet.collect_params().items():
        p.set_data(jmx.nd.array(w[n]))
    params_from_mxtpu(w, tnet)
    return jnet, tnet


@pytest.fixture(scope="module")
def net(nets):
    return nets[1]


@pytest.fixture(scope="module")
def exports(nets, tmp_path_factory):
    """Both packages' incremental exports, each from a fresh symbol
    counter: {"j": (sym, params), "t": (sym, params)}."""
    jnet, tnet = nets
    d = tmp_path_factory.mktemp("genbert")
    jnet(jmx.nd.array(np.ones((1, 3))), jmx.nd.array(np.zeros(1)),
         jmx.nd.array(_cache(1)))
    tnet(nd.array(np.ones((1, 3), np.float32), ctx=CPU),
         nd.array(np.zeros(1, np.float32), ctx=CPU),
         nd.array(_cache(1), ctx=CPU))
    saved = jsym._NAME_COUNTERS, tsym._NAME_COUNTERS
    try:
        jsym._NAME_COUNTERS = {}
        j = jnet.export(str(d / "j"))
        tsym._NAME_COUNTERS = {}
        t = tnet.export(str(d / "t"))
    finally:
        jsym._NAME_COUNTERS, tsym._NAME_COUNTERS = saved
    return {"j": j, "t": t}


@pytest.fixture(scope="module")
def export(exports):
    # the port's runner loads mxtpu's own export
    return exports["j"]


def _runner(export, **kw):
    sym_file, param_file = export
    kw.setdefault("prompt_buckets", BUCKETS)
    kw.setdefault("device", "cpu")
    return GenerateRunner.from_export(
        sym_file, param_file, _bert(BERTModel).kv_cache_spec(LANES, L),
        **kw)


@pytest.fixture(scope="module")
def runner(export):
    return _runner(export)


@pytest.fixture(scope="module")
def jrunner(export):
    sym_file, param_file = export
    return JRunner.from_export(sym_file, param_file,
                               _bert(JBERT).kv_cache_spec(LANES, L),
                               prompt_buckets=BUCKETS, cache=None)


def _ref_greedy(net, prompt, n):
    """Reference decode: the full forward re-run per token."""
    toks = list(prompt)
    with torch.no_grad():
        for _ in range(n):
            x = torch.tensor(np.array(toks, np.float32)[None, :])
            logits = net(x).numpy()[0]
            toks.append(int(np.argmax(logits[len(toks) - 1])))
    return toks[len(prompt):]


def _batcher(runner, clk, **kw):
    kw.setdefault("clock", clk)
    return GenerateBatcher(runner, **kw)


def _drive(b, clk, *reqs, n=30, dt=0.01):
    for _ in range(n):
        clk.advance(dt)
        b.step()
        if all(r.done() for r in reqs):
            return
    raise AssertionError(f"requests not done after {n} steps")


# ------------------------------------------------------- the model

def _step_inputs(toks, step, cache):
    return (nd.array(np.array(toks, np.float32), ctx=CPU),
            nd.array(np.array(step, np.float32), ctx=CPU), cache)


def test_incremental_forward_matches_full(net):
    """The (step, cache) path holds the full forward's logits at every
    position: prefill a prompt, then extend one token at a time."""
    prompt = [3, 7, 1, 4]
    cache = nd.array(_cache(1), ctx=CPU)
    x = nd.array(np.array(prompt, np.float32)[None, :], ctx=CPU)
    inc, cache = net(x, nd.array(np.zeros(1, np.float32), ctx=CPU), cache)
    full = net(x)
    np.testing.assert_allclose(inc.asnumpy(), full.asnumpy(),
                               rtol=TOL, atol=TOL)
    toks = list(prompt)
    for step in range(4):
        nxt = int(np.argmax(inc.asnumpy()[0, len(toks) - 1 if step == 0
                                          else 0]))
        toks.append(nxt)
        inc, cache = net(*_step_inputs([[nxt]], [len(toks) - 1], cache))
        ref = net(nd.array(np.array(toks, np.float32)[None, :], ctx=CPU))
        np.testing.assert_allclose(
            inc.asnumpy()[0, 0], ref.asnumpy()[0, len(toks) - 1],
            rtol=TOL, atol=TOL)


def test_incremental_logits_and_cache_match_mxtpu(nets):
    """Two lanes at different frontiers, a 3-token prefill then a
    decode step, in both packages."""
    jnet, tnet = nets
    rng = np.random.RandomState(0)
    cache = rng.randn(*_cache(2).shape).astype(np.float32)
    jc, tc = jmx.nd.array(cache), nd.array(cache, ctx=CPU)
    for toks, step in ((rng.randint(0, V, (2, 3)), [0.0, 5.0]),
                       (rng.randint(0, V, (2, 1)), [3.0, 8.0])):
        toks = toks.astype(np.float32)
        step = np.array(step, np.float32)
        jl, jc = jnet(jmx.nd.array(toks), jmx.nd.array(step), jc)
        tl, tc = tnet(*_step_inputs(toks, step, tc))
        np.testing.assert_allclose(tl.asnumpy(), jl.asnumpy(),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tc.asnumpy(), jc.asnumpy(),
                                   rtol=TOL, atol=TOL)


def test_kv_cache_spec_shape(net):
    assert net.kv_cache_spec(LANES, L) == (NL, 2, LANES, NH, L, U // NH)
    assert net.kv_cache_spec(3) == (NL, 2, 3, NH, L, U // NH)


def test_incremental_export_is_mxtpus(exports):
    """The incremental trace exports byte-equal to mxtpu's: inputs
    data0, data1, data2 and two heads (logits, cache)."""
    (jsf, jpf), (tsf, tpf) = exports["j"], exports["t"]
    with open(jsf) as a, open(tsf) as b:
        jtext, ttext = a.read(), b.read()
    assert ttext == jtext
    graph = json.loads(ttext)
    assert len(graph["heads"]) == 2
    names = [graph["nodes"][i]["name"] for i in graph["arg_nodes"]]
    assert [n for n in names if n.startswith("data")] == \
        ["data0", "data1", "data2"]
    assert tsym.load(tsf).list_outputs() == \
        jsym.load(jsf).list_outputs()


@pytest.mark.parametrize("src, dst", [("j", "t"), ("t", "j")])
def test_exports_cross_between_the_runners(exports, src, dst):
    """mxtpu's incremental export loads into the port's runner and the
    port's into mxtpu's: the same prefill logits either way."""
    sym_file, param_file = exports[src]
    spec = _bert(BERTModel).kv_cache_spec(LANES, L)
    if dst == "t":
        a = GenerateRunner.from_export(sym_file, param_file, spec,
                                       prompt_buckets=(4,), device="cpu")
        b = GenerateRunner.from_export(*exports[dst], spec,
                                       prompt_buckets=(4,), device="cpu")
    else:
        a = JRunner.from_export(sym_file, param_file, spec,
                                prompt_buckets=(4,), cache=None)
        b = JRunner.from_export(*exports[dst], spec, prompt_buckets=(4,),
                                cache=None)
    toks = np.array([[1, 2, 3, 4]], np.float32)
    args = (toks, np.zeros(1, np.float32), np.zeros(1, np.float32))
    la, _ = a.prefill(*args, a.new_cache())
    lb, _ = b.prefill(*args, b.new_cache())
    np.testing.assert_allclose(la, lb, rtol=TOL, atol=TOL)


def test_params_cross_both_ways(nets, exports):
    """The incremental export's .params hold exactly the Block's names,
    and ``params_to_mxtpu`` gives them back."""
    _, tnet = nets
    loaded = nd.load_params(exports["j"][1])
    back = params_to_mxtpu(tnet)
    assert list(back) == list(loaded)
    for n, a in loaded.items():
        np.testing.assert_array_equal(back[n], a)


# ------------------------------------------------------- sample_token

def test_sample_token_greedy_is_argmax():
    logits = np.array([0.1, 2.0, -1.0, 0.5], np.float32)
    assert sample_token(logits, position=5) == 1


def test_sample_token_seeded_by_absolute_position():
    """The draw is keyed by (seed, absolute position) only — the same
    position yields the same token whichever attempt samples it."""
    rng = np.random.RandomState(0)
    logits = rng.randn(64).astype(np.float32)
    a = [sample_token(logits, position=p, seed=9, top_k=8)
         for p in range(12)]
    b = [sample_token(logits, position=p, seed=9, top_k=8)
         for p in range(12)]
    assert a == b
    assert len(set(a)) > 1          # top-k actually varies by position
    c = [sample_token(logits, position=p, seed=10, top_k=8)
         for p in range(12)]
    assert a != c                   # seed matters


def test_sample_token_bit_equal_to_mxtpu():
    """Over a grid of seeds, positions, k and tied logits."""
    from mxtpu.serving import sample_token as jsample
    rng = np.random.RandomState(7)
    rows = [rng.randn(50).astype(np.float32),
            np.round(rng.randn(50), 1).astype(np.float32),   # many ties
            np.zeros(50, np.float32),                         # all tied
            np.repeat(rng.randn(5), 10).astype(np.float32)]
    for row in rows:
        for seed in (0, 1, 13, 2 ** 31 + 5, -3):
            for pos in (0, 1, 7, 99, 2 ** 33):
                for k in (0, 1, 2, 8, 50, 80):
                    assert sample_token(row, position=pos, seed=seed,
                                        top_k=k) == \
                        jsample(row, position=pos, seed=seed, top_k=k)


# -------------------------------------------------------- the runner

def test_runner_bucket_ladder(runner):
    bk = runner.buckets()
    assert ("decode", (LANES + 1,)) in bk
    assert ("prefill", (1, 4)) in bk and ("prefill", (2, 8)) in bk
    assert runner.prompt_bucket_for(3) == 4
    assert runner.prompt_bucket_for(9) == 8   # capped: chunked prefill
    assert runner.batch_rung_for(2) == 2
    with pytest.raises(MXNetError):
        runner.batch_rung_for(LANES + 1)


def test_runner_rejects_bad_kv_spec(export):
    sym_file, param_file = export
    with pytest.raises(MXNetError):
        GenerateRunner.from_export(sym_file, param_file,
                                   (NL, 2, LANES, NH, L),
                                   prompt_buckets=(4,), device="cpu")
    with pytest.raises(MXNetError):
        _runner(export, prompt_buckets=(64,))  # bucket > KV capacity
    with pytest.raises(MXNetError):
        _runner(export, input_names=("data0", "data1"))
    with pytest.raises(MXNetError):
        _runner(export, input_names=("data0", "data1", "cache"))


@pytest.mark.parametrize("name, value", [("cache", None),
                                         ("cache", "auto")])
def test_runner_refuses_options_not_ported(export, name, value,
                                           monkeypatch):
    """``cache=`` is ported: None and "auto" (with no MXTPU_CACHE_DIR)
    give a runner with no cache; what is not an ExecutableCache is
    refused."""
    monkeypatch.delenv("MXTPU_CACHE_DIR", raising=False)
    assert _runner(export, **{name: value})._cache is None
    with pytest.raises(TypeError, match="ExecutableCache"):
        _runner(export, **{name: object()})


def test_runner_takes_amp(export, runner):
    """amp=True (no longer refused): bf16 weights, f32 logits near the
    f32 runner's (mxtpu's AMP parity bar), the table f32."""
    r = _runner(export, amp=True)
    assert {w.dtype for w in r.weight_buffers()} == {torch.bfloat16}
    toks = np.array([[3, 7, 1, 4]], np.float32)
    args = (toks, np.zeros(1, np.float32), np.zeros(1, np.float32))
    got, kv = r.prefill(*args, r.new_cache())
    want, _ = runner.prefill(*args, runner.new_cache())
    assert got.dtype == np.float32 and kv.dtype == torch.float32
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=1e-2)


def test_runner_takes_quant_and_quant_scales(export, runner, monkeypatch):
    """quant=True with no scales raises when it builds an entry, as
    mxtpu's does; with quant_scales (no longer refused) each of the 9
    dense products of a prefill runs in int8."""
    with pytest.raises(MXNetError, match="no calibrated scales"):
        _runner(export, quant=True).warmup()
    scales = {f"FullyConnected_{i}": 1.5 for i in range(9)}
    r = _runner(export, quant=True, quant_scales=scales)
    from mxtpu_torch import quant
    seen = []
    real = quant.int_mm

    def spy(a, w):
        seen.append((a.dtype, w.dtype))
        return real(a, w)
    monkeypatch.setattr(quant, "int_mm", spy)
    toks = np.array([[3, 7, 1, 4]], np.float32)
    args = (toks, np.zeros(1, np.float32), np.zeros(1, np.float32))
    got, _ = r.prefill(*args, r.new_cache())
    assert seen == [(torch.int8, torch.int8)] * 9
    want, _ = runner.prefill(*args, runner.new_cache())
    assert got.shape == want.shape and np.isfinite(got).all()


def test_runner_matches_mxtpus_runner(runner, jrunner):
    """prefill (a padding row on the scratch slot, two lanes at other
    offsets) then decode: logits and every lane of the table, the
    scratch slot left out."""
    rng = np.random.RandomState(3)
    kv = rng.randn(*runner.new_cache().shape).astype(np.float32)
    tkv = torch.tensor(kv)
    jkv = jmx.nd.array(kv)._data
    for b, s, step, lanes in ((2, 8, [0.0, 4.0], [1.0, 0.0]),
                              (2, 4, [10.0, 2.0], [0.0, 2.0])):
        toks = rng.randint(0, V, (b, s)).astype(np.float32)
        args = (toks, np.array(step, np.float32),
                np.array(lanes, np.float32))
        tl, tkv = runner.prefill(*args, tkv)
        jl, jkv = jrunner.prefill(*args, jkv)
        np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tkv.numpy()[:, :, :LANES],
                                   np.asarray(jkv)[:, :, :LANES],
                                   rtol=TOL, atol=TOL)
    for step in ([8.0, 15.0, 3.0], [9.0, 15.0, 0.0]):
        toks = rng.randint(0, V, (LANES + 1, 1)).astype(np.float32)
        tl, tkv = runner.decode(toks, np.array(step, np.float32), tkv)
        jl, jkv = jrunner.decode(toks, np.array(step, np.float32), jkv)
        np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tkv.numpy()[:, :, :LANES],
                                   np.asarray(jkv)[:, :, :LANES],
                                   rtol=TOL, atol=TOL)


def test_donate_on_and_off(export):
    """On: the table passed in is updated in place and returned.  Off:
    a new table, the old one intact.  The same logits either way."""
    on, off = _runner(export, donate=True), _runner(export, donate=False)
    toks = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.float32)
    args = (toks, np.array([0, 2], np.float32), np.array([0, 1],
                                                         np.float32))
    kv_on, kv_off = on.new_cache(), off.new_cache()
    l_on, out_on = on.prefill(*args, kv_on)
    l_off, out_off = off.prefill(*args, kv_off)
    assert out_on is kv_on and out_off is not kv_off
    assert not kv_off.any() and kv_on.any()
    np.testing.assert_array_equal(l_on, l_off)
    dt = np.array([[3], [4], [0]], np.float32)
    ds = np.array([4, 6, 0], np.float32)
    kept = out_off.clone()
    d_on, again_on = on.decode(dt, ds, out_on)
    d_off, again_off = off.decode(dt, ds, out_off)
    assert again_on is out_on and again_off is not out_off
    assert torch.equal(out_off, kept)
    np.testing.assert_array_equal(d_on, d_off)
    assert torch.equal(again_on, again_off)


def test_generation_knobs(export, monkeypatch):
    """MXTPU_SERVING_DONATE sets the runner's default, its MXNET_
    spelling too; MXTPU_GEN_MAX_TOKENS the batcher's default cap."""
    assert _runner(export)._donate is True
    monkeypatch.setenv("MXNET_SERVING_DONATE", "0")
    assert _runner(export)._donate is False
    monkeypatch.setenv("MXTPU_SERVING_DONATE", "1")
    assert _runner(export)._donate is True
    monkeypatch.setenv("MXTPU_GEN_MAX_TOKENS", "3")
    clk = FakeClock()
    b = _batcher(_runner(export), clk)
    r = b.submit([1, 2])
    _drive(b, clk, r)
    assert len(r.result(0)) == 3 and r.finish_reason == "length"


def test_warmup_runs_every_bucket(export):
    r = _runner(export)
    assert r.num_compiled() == 0
    secs = r.warmup()
    assert set(secs) == set(r.buckets())
    assert r.num_compiled() == len(r.buckets())
    assert r.weight_bytes() == sum(t.numel() * 4
                                   for t in r.weight_buffers())


def test_greedy_decode_matches_full_forward(net, runner):
    clk = FakeClock()
    b = _batcher(runner, clk)
    r = b.submit([1, 2, 3], max_tokens=5)
    _drive(b, clk, r)
    assert r.result(0) == _ref_greedy(net, [1, 2, 3], 5)
    assert r.finish_reason == "length"


def test_chunked_prefill_beyond_largest_bucket(net, runner):
    clk = FakeClock()
    b = _batcher(runner, clk)
    r = b.submit([1] * 9, max_tokens=3)       # 9 > largest bucket 8
    _drive(b, clk, r)
    assert r.result(0) == _ref_greedy(net, [1] * 9, 3)


def test_kv_capacity_finishes_as_length(net, runner):
    """A lane whose frontier reaches L finishes as "length": its last
    token is sampled from position L - 1."""
    clk = FakeClock()
    b = _batcher(runner, clk)
    prompt = [2] * 13
    r = b.submit(prompt, max_tokens=10)
    _drive(b, clk, r)
    assert r.finish_reason == "length"
    assert r.result(0) == _ref_greedy(net, prompt, L - len(prompt) + 1)


def test_clamped_last_chunk_matches_mxtpu(export):
    """Prompt buckets that do not divide L: a 14-token prompt prefills
    in chunks of 6 at offsets 0, 6 and 12, and the last chunk's write
    (12 + 6 > L) is clamped to start at L - 6, as mxtpu's
    ``dynamic_update_slice`` clamps it.  The port follows mxtpu there:
    the same logits, table and stream."""
    sym_file, param_file = export
    spec = _bert(BERTModel).kv_cache_spec(LANES, L)
    t = _runner(export, prompt_buckets=(4, 6))
    j = JRunner.from_export(sym_file, param_file, spec,
                            prompt_buckets=(4, 6), cache=None)
    streams = []
    for cls, r in ((GenerateBatcher, t), (JBatcher, j)):
        clk = FakeClock()
        b = cls(r, clock=clk)
        req = b.submit(list(range(1, 15)), max_tokens=3)
        _drive(b, clk, req)
        streams.append(req.result(0))
    assert streams[0] == streams[1]
    toks = np.arange(6, dtype=np.float32)[None, :] + 3
    args = (toks, np.array([12.0], np.float32), np.zeros(1, np.float32))
    tl, tkv = t.prefill(*args, t.new_cache())
    jl, jkv = j.prefill(*args, j.new_cache())
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tkv.numpy(), np.asarray(jkv),
                               rtol=TOL, atol=TOL)
    # the write landed at L - 6 = 10
    assert tkv[:, :, 0, :, 10:].abs().sum() > 0
    assert not tkv[:, :, 0, :, :10].any()


# ------------------------------------------- the continuous batcher

def test_join_at_step_boundary_with_lane_accounting(net, runner):
    """A request submitted mid-decode joins at the NEXT step boundary
    by claiming a free lane; both streams stay exact."""
    clk = FakeClock()
    b = _batcher(runner, clk)
    r1 = b.submit([1, 2, 3], max_tokens=5)
    out = b.step()
    assert out["admitted"] == 1 and b.free_lanes() == LANES - 1
    r2 = b.submit([4, 5], max_tokens=4)        # late joiner
    assert b.depth == 1                        # queued, not in a lane
    clk.advance(0.01)
    out = b.step()                             # the join boundary
    assert out["admitted"] == 1 and b.free_lanes() == LANES - 2
    _drive(b, clk, r1, r2)
    assert r1.result(0) == _ref_greedy(net, [1, 2, 3], 5)
    assert r2.result(0) == _ref_greedy(net, [4, 5], 4)
    assert b.joins == 2
    assert b.free_lanes() == LANES             # both lanes reclaimed


def test_lane_reuse_after_eos(net, runner):
    """An EOS-finished lane frees at the step boundary and the next
    queued request claims it without reading the dead stream's KV."""
    ref = _ref_greedy(net, [1, 2, 3], 5)
    eos = ref[2]
    clk = FakeClock()
    b = _batcher(runner, clk)
    ra = b.submit([1, 2, 3], max_tokens=10, eos_id=eos)
    rb = b.submit([1] * 4, max_tokens=6)
    b.step()
    assert b.free_lanes() == 0
    rc = b.submit([4, 5], max_tokens=3)        # waits for a lane
    _drive(b, clk, ra)
    assert ra.finish_reason == "eos"
    assert ra.result(0) == ref[:ref.index(eos) + 1]
    _drive(b, clk, rb, rc)
    assert rc.result(0) == _ref_greedy(net, [4, 5], 3)
    assert rb.result(0) == _ref_greedy(net, [1] * 4, 6)
    assert b.free_lanes() == LANES


def test_deadline_eviction_mid_decode(runner):
    clk = FakeClock()
    b = _batcher(runner, clk, on_timeout=None)
    r = b.submit([1, 2, 3], max_tokens=50, timeout_s=0.05)
    b.step()                                   # prefill, 1 token out
    clk.advance(1.0)
    b.step()                                   # evicted at the boundary
    with pytest.raises(RequestTimeout):
        r.result(0)
    assert b.free_lanes() == LANES


def test_queue_full_raises_server_busy(runner):
    clk = FakeClock()
    b = _batcher(runner, clk, max_queue=1)
    b.submit([1, 2], max_tokens=2)
    with pytest.raises(ServerBusy):
        for _ in range(3):
            b.submit([1, 2], max_tokens=2)


def test_submit_refusals(runner):
    b = _batcher(runner, FakeClock())
    with pytest.raises(MXNetError):
        b.submit([], max_tokens=2)
    with pytest.raises(MXNetError):
        b.submit([1] * L, max_tokens=2)        # no room to generate
    with pytest.raises(MXNetError):
        b.submit([1, 2], max_tokens=2, prefix=[3, 4])
    b.close()
    with pytest.raises(WorkerLost):
        b.submit([1, 2], max_tokens=2)


def test_max_lanes_knob_caps_batching_width(net, runner, monkeypatch):
    """MXTPU_GEN_MAX_LANES narrows continuous batching below the table's
    width: with one lane the second request waits for the first."""
    monkeypatch.setenv("MXTPU_GEN_MAX_LANES", "1")
    clk = FakeClock()
    b = _batcher(runner, clk)
    assert b.max_lanes == 1
    ra = b.submit([1, 2, 3], max_tokens=3)
    rb = b.submit([4, 5], max_tokens=3)
    clk.advance(0.01)
    b.step()          # ra holds the only lane (prefill + 1st decode)
    assert len(b.active()) == 1 and b.depth == 1
    _drive(b, clk, ra, rb)
    assert ra.result(0) == _ref_greedy(net, [1, 2, 3], 3)
    assert rb.result(0) == _ref_greedy(net, [4, 5], 3)
    assert b.joins == 2


def test_stream_callbacks_carry_indices(net, runner):
    clk = FakeClock()
    b = _batcher(runner, clk)
    got = []
    r = b.submit([1, 2, 3], max_tokens=4,
                 on_token=lambda t, i: got.append((i, t)))
    _drive(b, clk, r)
    exp = _ref_greedy(net, [1, 2, 3], 4)
    assert [t for _, t in got] == exp
    assert [i for i, _ in got] == [0, 1, 2, 3]


def test_stream_knob_off_delivers_only_the_result(runner, monkeypatch):
    monkeypatch.setenv("MXTPU_GEN_STREAM", "0")
    clk = FakeClock()
    b = _batcher(runner, clk)
    got = []
    r = b.submit([1, 2, 3], max_tokens=3,
                 on_token=lambda t, i: got.append(t))
    _drive(b, clk, r)
    assert got == [] and len(r.result(0)) == 3


# ------------------------------- partial state and replay

def test_close_carries_partial_generation_state(runner):
    """WorkerLost from a closed batcher carries prompt + emitted tokens
    + the ORIGINAL t_submit/deadline."""
    clk = FakeClock(200.0)
    b = _batcher(runner, clk)
    r = b.submit([1, 2, 3], max_tokens=50, timeout_s=9.0)
    clk.advance(0.5)
    b.step()                            # prefill + first decode step
    clk.advance(0.5)
    b.step()                            # one more decode step
    b.close()
    with pytest.raises(WorkerLost) as ei:
        r.result(0)
    p = ei.value.partial
    assert p["prompt"] == [1, 2, 3]
    assert p["tokens"] == r.prefix + r.tokens and len(p["tokens"]) == 3
    assert p["t_submit"] == 200.0              # original admission time
    assert p["deadline"] == pytest.approx(209.0)


def test_replay_prefix_resumes_exact_stream(net, runner):
    """Resuming from a prefix gives the identical remaining stream, with
    indices continuing where the dead attempt stopped."""
    exp = _ref_greedy(net, [1, 2, 3], 5)
    clk = FakeClock()
    b = _batcher(runner, clk)
    got = []
    r = b.submit([1, 2, 3], max_tokens=5, prefix=exp[:2],
                 on_token=lambda t, i: got.append((i, t)))
    _drive(b, clk, r)
    assert r.result(0) == exp                  # full stream, replayed
    assert [i for i, _ in got] == [2, 3, 4]    # only NEW indices fired
    assert [t for _, t in got] == exp[2:]


def test_replay_never_double_bills_deadline(runner):
    """A replay submitted with the original deadline already spent
    fails as a queued-deadline expiry."""
    clk = FakeClock(300.0)
    b = _batcher(runner, clk)
    r = b.submit([1, 2, 3], max_tokens=5, prefix=[0],
                 timeout_s=0.05)               # original budget spent
    clk.advance(1.0)
    b.step()
    with pytest.raises(RequestTimeout):
        r.result(0)


def test_topk_sampling_identical_across_runs_and_steal(net, runner):
    """Seeded top-k: two full runs give the same stream, and a replay
    from any prefix point continues it exactly."""
    def run(prefix=()):
        clk = FakeClock()
        b = _batcher(runner, clk)
        r = b.submit([5, 6, 7], max_tokens=6, top_k=4, seed=13,
                     prefix=list(prefix))
        _drive(b, clk, r)
        return r.result(0)

    full_a, full_b = run(), run()
    assert full_a == full_b                    # across runs
    for cut in (1, 3, 5):
        assert run(prefix=full_a[:cut]) == full_a   # across a steal


# ------------------------------- one fake-clock script, both packages

class _Counts:
    """The stats hooks the batcher calls, counted."""

    def __init__(self):
        self.ttft, self.tokens = [], []

    def record_ttft(self, us):
        self.ttft.append(us)

    def record_token(self, us, n=1):
        self.tokens.append(us)


def _scenario(batcher_cls, runner, lost_cls, max_lanes, eos):
    """Join at a step boundary, lane reuse after EOS, deadline eviction
    (queued and mid-decode), ServerBusy, chunked prefill, close() with
    partial state, a prefix replay (greedy and top-k) whose deadline is
    not billed twice.  Returns everything observable."""
    log = []
    clk = FakeClock(50.0)
    counts = _Counts()
    b = batcher_cls(runner, clock=clk, stats=counts, max_queue=4,
                    max_lanes=max_lanes)

    def outcome(r):
        try:
            return ("ok", r.result(0), r.finish_reason)
        except Exception as e:  # noqa: BLE001 — compared by type name
            return (type(e).__name__,
                    getattr(e, "partial", None))

    streams = {}

    def submit(tag, prompt, **kw):
        got = streams.setdefault(tag, [])
        try:
            return b.submit(prompt,
                            on_token=lambda t, i: got.append((i, t)),
                            **kw)
        except Exception as e:  # noqa: BLE001
            log.append((tag, "refused", type(e).__name__))
            return None

    reqs = {"a": submit("a", [1, 2, 3], max_tokens=6, eos_id=eos),
            "b": submit("b", [1] * 9, max_tokens=4)}
    log.append(("step", b.step(), b.free_lanes(), b.depth))
    reqs["c"] = submit("c", [4, 5], max_tokens=5, top_k=4, seed=3)
    reqs["d"] = submit("d", [6, 2, 9, 9, 1], max_tokens=40,
                       timeout_s=0.035)
    reqs["e"] = submit("e", [3, 3], max_tokens=3, timeout_s=0.001)
    reqs["f"] = submit("f", [8], max_tokens=2)
    reqs["g"] = submit("g", [8, 8], max_tokens=2)   # past max_queue
    for _ in range(12):
        clk.advance(0.01)
        log.append(("step", b.step(), b.free_lanes(), b.depth,
                    sorted(b.active())))
    reqs["h"] = submit("h", [2, 4, 6, 8, 10, 12], max_tokens=8,
                       top_k=3, seed=11, timeout_s=5.0)
    reqs["i"] = submit("i", [9, 1], max_tokens=8)
    for _ in range(3):
        clk.advance(0.01)
        log.append(("step", b.step(), b.free_lanes(), b.depth))
    b.close()
    log.append(("joins", b.joins, "steps", b.steps))
    out = {k: outcome(r) for k, r in reqs.items() if r is not None}
    # replay every lost request from its partial state in a new batcher
    clk2 = FakeClock(clk.t + 0.5)
    b2 = batcher_cls(runner, clock=clk2, stats=counts,
                     max_lanes=max_lanes)
    replays = {}
    for k, r in reqs.items():
        if r is None or not isinstance(out[k][1], dict):
            continue
        p = out[k][1]
        got = streams.setdefault(k + "'", [])
        left = None if p["deadline"] is None \
            else p["deadline"] - clk2.t
        replays[k] = b2.submit(p["prompt"], max_tokens=r.max_tokens,
                               top_k=r.top_k, seed=r.seed,
                               prefix=p["tokens"], timeout_s=left,
                               on_token=lambda t, i, g=got:
                                   g.append((i, t)))
    for _ in range(12):
        clk2.advance(0.01)
        b2.step()
    out.update({k + "'": outcome(r) for k, r in replays.items()})
    log.append(("replay joins", b2.joins, "steps", b2.steps))
    return {"log": log, "out": out, "streams": streams,
            "ttft": len(counts.ttft), "tokens": len(counts.tokens),
            "lost_type": all(isinstance(r._error, lost_cls)
                             for k, r in reqs.items()
                             if r is not None and out[k][0] ==
                             "WorkerLost")}


@pytest.mark.parametrize("max_lanes", [LANES, 1])
def test_batchers_agree_on_a_fake_clock_script(net, runner, jrunner,
                                               max_lanes):
    eos = _ref_greedy(net, [1, 2, 3], 6)[2]
    t = _scenario(GenerateBatcher, runner, WorkerLost, max_lanes, eos)
    j = _scenario(JBatcher, jrunner, JWorkerLost, max_lanes, eos)
    assert t == j
    # the script reaches what it is for
    reasons = {v[2] for v in t["out"].values() if v[0] == "ok"}
    kinds = {v[0] for v in t["out"].values()}
    assert "eos" in reasons
    assert {"ok", "RequestTimeout", "WorkerLost"} <= kinds
    assert ("g", "refused", "ServerBusy") in t["log"]
    resumed = [k for k in t["out"] if k.endswith("'")]
    assert resumed
    for k in resumed:
        # each resumed stream starts at the exact next index
        first = t["streams"][k[:-1]]
        again = t["streams"][k]
        if again:
            assert again[0][0] == len(first)


def test_replayed_streams_equal_the_uninterrupted_run(runner):
    """Greedy and top-k, closed mid-stream and resumed in a new batcher
    from ``partial_state()``: the same tokens as a run never closed,
    no index streamed twice."""
    kw = [dict(max_tokens=9), dict(max_tokens=9, top_k=4, seed=21)]
    prompts = [[3, 1, 4], [1, 5, 9, 2, 6]]

    def run_all(close_after=None):
        clk = FakeClock()
        b = _batcher(runner, clk)
        streams = [[] for _ in prompts]
        reqs = [b.submit(p, on_token=lambda t, i, g=g: g.append((i, t)),
                         **k) for p, k, g in zip(prompts, kw, streams)]
        for n in range(30):
            if close_after is not None and n == close_after:
                b.close()
                break
            clk.advance(0.01)
            b.step()
        if close_after is None:
            return [r.result(0) for r in reqs]
        b2 = _batcher(runner, clk)
        out = []
        for r, k, g in zip(reqs, kw, streams):
            with pytest.raises(WorkerLost) as ei:
                r.result(0)
            p = ei.value.partial
            r2 = b2.submit(p["prompt"], prefix=p["tokens"],
                           on_token=lambda t, i, g=g: g.append((i, t)),
                           **k)
            out.append(r2)
        _drive(b2, clk, *out)
        for g in streams:
            assert [i for i, _ in g] == list(range(len(g)))
        return [r.result(0) for r in out]

    full = run_all()
    assert run_all(close_after=3) == full


# ---------------------------------------------------- server endpoint

def test_server_generate_roundtrip(net, export):
    """Streamed generation through InferenceServer's continuous
    endpoint (threaded, real clock): result + per-token callbacks."""
    srv = InferenceServer(log_every_s=1e9)
    srv.register_generator("bert", _runner(export), warmup=True)
    got = []
    out = srv.generate("bert", [1, 2, 3], max_tokens=5, timeout_s=60.0,
                       on_token=lambda t, i: got.append((i, t)))
    assert out == _ref_greedy(net, [1, 2, 3], 5)
    assert [t for _, t in sorted(got)] == out
    snap = srv.stats("bert")
    assert snap["lanes"] == LANES
    assert snap["compiled_buckets"] == len(_runner(export).buckets())
    # first emission lands in the TTFT ring, the rest per-token
    assert snap["generate"]["tokens_emitted"] >= 4
    assert snap["generate"]["ttft_ms"]["n"] == 1
    assert "bert:v1:gen" in srv.stats()
    srv.close()


def test_server_generator_registry_guards(export):
    srv = InferenceServer()
    srv.register_generator("g", _runner(export))
    with pytest.raises(MXNetError):
        srv.register_generator("g", _runner(export))  # dup version
    with pytest.raises(MXNetError):
        srv.register_generator("h", object())          # not a runner
    with pytest.raises(MXNetError):
        srv.generate("nope", [1], max_tokens=1)
    srv.unregister("g")
    with pytest.raises(MXNetError):
        srv.generate("g", [1], max_tokens=1)
    srv.close()
    with pytest.raises(MXNetError):
        srv.generate("g", [1], max_tokens=1)


def test_server_close_fails_waiters_with_partial_state(export):
    """close() stops the generator endpoint: a stream still running
    fails with WorkerLost carrying its partial state; none hangs."""
    srv = InferenceServer()
    srv.register_generator("g", _runner(export))
    r = srv.submit_generate("g", [1, 2], max_tokens=13)
    srv.close()
    assert r.done()
    try:
        out = r.result(0)
        assert len(out) == 13          # it finished before the close
    except WorkerLost as e:
        assert e.partial["prompt"] == [1, 2]


def test_stats_generation_rings():
    st = ServingStats()
    assert "generate" not in st.snapshot()
    st.record_ttft(2000.0)
    for us in (1000.0, 3000.0):
        st.record_token(us)
    g = st.snapshot()["generate"]
    assert g["tokens_emitted"] == 2
    assert g["ttft_ms"] == {"p50": 2.0, "p95": 2.0, "n": 1}
    assert g["token_ms"]["n"] == 2
