"""mxtpu_torch's ModelRunner as mxtpu deploys one: built from a graph
and its params (``ModelRunner(symbol, params, ...)``, ``from_export``,
``from_checkpoint``), held against mxtpu's ``ModelRunner`` (built with
``cache=None``) on the same seeded inputs on the CPU.

mxtpu's runner tests (``tests/test_serving.py``) are mirrored on toy
graphs at mxtpu's 1e-6; a small BERT export, written by either
package, agrees with mxtpu's runner at every bucket within 1e-4 (f32
on both sides: the same products in another summation order over two
encoder layers).  Also here: the graph plan bit for bit against the
walk it replaced, ``ladder_metadata``/``warm_from``, the runtime
guards (``ChurnDetector`` under ``MXTPU_GUARDS``), the options the
port refuses, the launch recorder a captured entry counts with, and
the GenerateRunner's entries.  On the CPU an entry is the graph plan
run eagerly; the CUDA graphs the card captures are held against that
eager plan by ``chip_smoke.py``.
"""
import json
import warnings

import numpy as np
import pytest
import torch

import mxtpu as jmx
from mxtpu import guards as jguards
from mxtpu import nd as jnd
from mxtpu import symbol as jsym
from mxtpu.gluon import nn as jnn
from mxtpu.models.transformer import BERTModel as JBERT
from mxtpu.serving import DynamicBatcher as JBatcher
from mxtpu.serving import ModelRunner as JRunner

import mxtpu_torch as tmx
from mxtpu_torch import MXNetError, autograd, cpu, guards, kernels
from mxtpu_torch import random as trandom
from mxtpu_torch import symbol as tsym
from mxtpu_torch.gluon import nn as tnn
from mxtpu_torch.models import BERTModel
from mxtpu_torch.serving import DynamicBatcher, GenerateRunner, ModelRunner

from tests.torch_gluon_names import fresh_names

torch.set_num_threads(2)

TOY_TOL = 1e-6
ATOL = 1e-4
V, U, H, L, MAXLEN = 128, 64, 4, 2, 40
SPEC = dict(input_specs={"data": (None,)}, seq_buckets=[16, 32],
            max_batch_size=4)
W = np.array([1.0, 2.0, 3.0], np.float32)


class FakeClock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _mul_runners(**kw):
    """mxtpu's per-row graph with one real weight, out = data * w, in
    each package: (mxtpu's runner, the port's)."""
    j = JRunner(jsym.var("data") * jsym.var("w"), {"w": W},
                {"data": (3,)}, max_batch_size=4, cache=None, **kw)
    t = ModelRunner(tsym.var("data") * tsym.var("w"), {"w": W},
                    {"data": (3,)}, max_batch_size=4, device="cpu", **kw)
    return j, t


def _token_runners():
    """Per-token token model, out = data * 3, in each package."""
    spec = dict(seq_buckets=[4, 8], max_batch_size=4)
    j = JRunner(jsym.var("data") * 3.0, {}, {"data": (None,)}, cache=None,
                **spec)
    t = ModelRunner(tsym.var("data") * 3.0, {}, {"data": (None,)},
                    device="cpu", **spec)
    return j, t


# ------------------------------------------------- mxtpu's runner tests

def test_runner_exact_outputs_across_buckets():
    j, t = _mul_runners()
    rng = np.random.RandomState(0)
    for n in (1, 3, 4):         # buckets (1,None),(4,None),(4,None)
        x = rng.randn(n, 3).astype(np.float32)
        (want,) = j.infer({"data": x})
        (out,) = t.infer({"data": x})
        assert out.shape == want.shape == (n, 3)
        np.testing.assert_allclose(out, x * W, rtol=TOY_TOL, atol=TOY_TOL)
        np.testing.assert_allclose(out, want, rtol=TOY_TOL, atol=TOY_TOL)
    assert t.num_compiled() == j.num_compiled() == 2


def test_runner_weights_uploaded_once_shared_across_buckets():
    """One upload feeds every bucket's entry: warming the whole ladder
    neither touches nor copies the weight tensors."""
    j, t = _mul_runners()
    bufs = t.weight_buffers()
    assert len(bufs) == len(j.weight_buffers()) == 1
    ptrs = [b.data_ptr() for b in bufs]
    secs, jsecs = t.warmup(), j.warmup()
    assert t.num_compiled() == len(t.buckets()) == j.num_compiled() == 3
    assert set(secs) == set(jsecs) == set(t.buckets())
    assert all(c > 0 for c in secs.values())
    x = np.ones((4, 3), np.float32)
    t.infer({"data": x})
    t.infer({"data": x[:1]})
    after = t.weight_buffers()
    assert all(a is b for a, b in zip(bufs, after))
    assert [b.data_ptr() for b in after] == ptrs
    assert t.weight_bytes() == j.weight_bytes() == W.nbytes


def test_runner_pad_scatter_roundtrip():
    """Mixed-length requests through pad -> run -> scatter: every
    request gets exactly its own rows, trimmed back to its true
    length, and mxtpu's runner gives each the same rows."""
    fc = FakeClock()
    j, t = _token_runners()
    lens = [2, 3, 4]
    rows = [np.arange(10 * i, 10 * i + n).astype(np.float32)
            for i, n in enumerate(lens)]
    long_row = np.arange(7).astype(np.float32)
    got = {}
    for name, r, batcher in (("mxtpu", j, JBatcher),
                             ("port", t, DynamicBatcher)):
        b = batcher(max_batch_size=4, max_queue_delay_us=0, clock=fc)
        reqs = [b.submit({"data": row}, group=r.seq_bucket_for(n),
                         seq_len=n) for row, n in zip(rows, lens)]
        bucket, _ = r.run_requests(b.poll().requests, now=fc.t)
        assert bucket == (4, 4)
        # second group: longer sequences land in the (., 8) bucket
        reqs.append(b.submit({"data": long_row},
                             group=r.seq_bucket_for(7), seq_len=7))
        bucket, _ = r.run_requests(b.poll().requests, now=fc.t)
        assert bucket == (1, 8)
        got[name] = [req.result(timeout=0)[0] for req in reqs]
    for out, want, row in zip(got["port"], got["mxtpu"], rows + [long_row]):
        assert out.shape == want.shape == row.shape   # padded tail trimmed
        np.testing.assert_allclose(out, row * 3.0, rtol=TOY_TOL)
        np.testing.assert_allclose(out, want, rtol=TOY_TOL, atol=TOY_TOL)
    with pytest.raises(MXNetError, match="exceeds bucket"):
        t._pad_stack([{"data": np.zeros(9, np.float32)}], (1, 8))


def _dense_net(pkg):
    nn_ = jnn if pkg == "mxtpu" else tnn
    with fresh_names():
        net = nn_.HybridSequential()
        net.add(nn_.Dense(8, activation="relu"), nn_.Dense(2))
    return net


@pytest.mark.parametrize("writer", ["mxtpu", "port"])
def test_runner_export_artifacts_roundtrip(tmp_path, writer):
    """``from_export`` serves an export written by either package: the
    port's runner against the net that wrote it and mxtpu's runner."""
    x = np.random.RandomState(0).randn(3, 5).astype(np.float32)
    net = _dense_net(writer)
    if writer == "mxtpu":
        jmx.random.seed(0)
        net.initialize(init="xavier")
        y0 = net(jnd.array(x)).asnumpy()
    else:
        trandom.seed(0)
        net.initialize(init="xavier", ctx=cpu())
        y0 = net(tmx.nd.array(x, ctx=cpu())).asnumpy()
    files = net.export(str(tmp_path / "m"))
    spec = dict(input_specs={"data": (5,)}, max_batch_size=4)
    (out,) = ModelRunner.from_export(*files, device="cpu",
                                     **spec).infer({"data": x})
    (want,) = JRunner.from_export(*files, cache=None,
                                  **spec).infer({"data": x})
    np.testing.assert_allclose(out, y0, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, want, rtol=TOY_TOL, atol=TOY_TOL)


def test_runner_from_checkpoint(tmp_path):
    """``prefix-symbol.json`` + ``prefix-0000.params`` (what export and
    ``Module.save_checkpoint`` write)."""
    net = _dense_net("mxtpu")
    jmx.random.seed(1)
    net.initialize(init="xavier")
    x = np.random.RandomState(1).randn(2, 5).astype(np.float32)
    net(jnd.array(x))
    net.export(str(tmp_path / "ck"), epoch=0)
    spec = dict(input_specs={"data": (5,)}, max_batch_size=2)
    (out,) = ModelRunner.from_checkpoint(str(tmp_path / "ck"), 0,
                                         device="cpu",
                                         **spec).infer({"data": x})
    (want,) = JRunner.from_checkpoint(str(tmp_path / "ck"), 0, cache=None,
                                      **spec).infer({"data": x})
    np.testing.assert_allclose(out, want, rtol=TOY_TOL, atol=TOY_TOL)


def test_graph_inputs_need_a_param_or_a_spec():
    with pytest.raises(MXNetError, match="neither a param nor an "
                                         "input_spec"):
        ModelRunner(tsym.var("data") * tsym.var("w"), {}, {"data": (3,)},
                    device="cpu")
    with pytest.raises(jmx.MXNetError, match="neither a param nor an "
                                             "input_spec"):
        JRunner(jsym.var("data") * jsym.var("w"), {}, {"data": (3,)},
                cache=None)
    # params the graph does not read are left out of the upload
    r = ModelRunner(tsym.var("data") * tsym.var("w"),
                    {"w": W, "unused": np.zeros(2, np.float32)},
                    {"data": (3,)}, device="cpu")
    assert len(r.weight_buffers()) == 1


def test_ladder_metadata_warms_the_intersection():
    """A donor's built buckets warm a replacement with another ladder
    on the buckets both have, as in mxtpu."""
    j, t = _mul_runners()
    for r in (j, t):
        r.infer({"data": np.ones((3, 3), np.float32)})   # (4, None)
        r.infer({"data": np.ones((1, 3), np.float32)})   # (1, None)
    meta, jmeta = t.ladder_metadata(), j.ladder_metadata()
    assert meta["compiled_buckets"] == jmeta["compiled_buckets"] == \
        [[1, None], [4, None]]
    assert {k: meta[k] for k in ("max_batch_size", "seq_buckets",
                                 "weight_bytes")} == \
        {k: jmeta[k] for k in ("max_batch_size", "seq_buckets",
                               "weight_bytes")}
    assert set(meta["compile_seconds"]) == set(jmeta["compile_seconds"])
    jrep = JRunner(jsym.var("data") * jsym.var("w"), {"w": W},
                   {"data": (3,)}, max_batch_size=2, cache=None)
    trep = ModelRunner(tsym.var("data") * tsym.var("w"), {"w": W},
                       {"data": (3,)}, max_batch_size=2, device="cpu")
    got, jgot = trep.warm_from(meta), jrep.warm_from(jmeta)
    assert set(got) == set(jgot) == {(1, None)}
    assert trep.num_compiled() == jrep.num_compiled() == 1
    assert trep.cached_buckets() == [] and trep.warm_from_disk() == {}


@pytest.mark.parametrize("name, value", [("cache", object())])
def test_options_not_ported_raise(name, value):
    """``cache=`` is ported; what is not "auto", None or an
    ExecutableCache is refused."""
    with pytest.raises(TypeError, match=r"ExecutableCache"):
        ModelRunner(tsym.var("data") * 1.0, {}, {"data": (3,)},
                    device="cpu", **{name: value})


def test_amp_option_stores_bf16_weights():
    """amp=True (no longer refused): the weight is uploaded in bf16 and
    re-enters the graph in f32, so a non-contraction op computes on the
    bf16-rounded weight in f32."""
    r = ModelRunner(tsym.var("data") * tsym.var("w"),
                    {"w": np.float32([1.0, 1.0 / 3, 3.14159])},
                    {"data": (3,)}, device="cpu", amp=True)
    assert r.weight_buffers()[0].dtype == torch.bfloat16
    x = np.float32([[1.0, 3.0, 1.0]])
    (out,) = r.infer({"data": x})
    w16 = torch.tensor([1.0, 1.0 / 3, 3.14159]).bfloat16().float().numpy()
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, x * w16)


def test_quant_option_calibrates_and_serves():
    """quant=True (no longer refused): calibrate, then the dense product
    runs in int8 with int32 sums, within one activation step of f32."""
    rng = np.random.RandomState(0)
    w = rng.randn(4, 6).astype(np.float32)
    r = ModelRunner(tsym.FullyConnected(tsym.var("data"), tsym.var("w"),
                                        num_hidden=4, no_bias=True),
                    {"w": w}, {"data": (6,)}, max_batch_size=2,
                    device="cpu", quant=True)
    x = rng.randn(2, 6).astype(np.float32)
    scales = r.calibrate([{"data": x}], mode="minmax")
    assert list(scales) == ["FullyConnected_0"] == list(r.quant_scales())
    (out,) = r.infer({"data": x})
    # each quantized operand is within half its step of the float one
    sx = scales["FullyConnected_0"] / 127
    sw = np.abs(w).max(axis=1) / 127
    bound = (np.abs(w).sum(axis=1) * sx / 2
             + np.abs(x).sum(axis=1, keepdims=True) * sw / 2
             + w.shape[1] * sx * sw / 4)
    assert np.all(np.abs(out - x @ w.T) <= bound * 1.001)


@pytest.mark.parametrize("cache", [None, "auto"])
def test_cache_none_and_auto_are_inert(cache):
    r = ModelRunner(tsym.var("data") * 2.0, {}, {"data": (3,)},
                    device="cpu", cache=cache, amp=False, quant=None,
                    donate=False)
    (out,) = r.infer({"data": W[None]})
    np.testing.assert_array_equal(out, 2 * W[None])


# -------------------------------------------------------------- guards

@pytest.mark.parametrize("mode", ["", "0", "1", "2", "on", "true"])
def test_guard_modes_match_mxtpu(monkeypatch, mode):
    monkeypatch.setenv("MXTPU_GUARDS", mode)
    assert guards.enabled() == jguards.enabled()
    assert guards.strict() == jguards.strict()


def test_disabled_and_cpu_scopes_are_the_shared_nullcontext(monkeypatch):
    monkeypatch.delenv("MXTPU_GUARDS", raising=False)
    monkeypatch.delenv("MXNET_GUARDS", raising=False)
    assert guards.no_implicit_transfers() is guards._NULL
    # nothing synchronises with a card on the CPU
    assert guards.no_implicit_transfers(True, torch.device("cpu")) \
        is guards._NULL


def test_sync_scopes_overlapping_out_of_order_restore_the_mode(
        monkeypatch):
    """Guarded scopes on two threads, closed in the order they opened
    (A opens, B opens, A closes, B closes): the mode is "error" while
    either is open and the one before them once both have closed."""
    import threading
    mode = {"now": 0}
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: mode["now"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda m: mode.__setitem__(
                            "now", {"error": 2}.get(m, m)))
    card = torch.device("cuda", 0)
    a_in, b_in, a_out = (threading.Event() for _ in range(3))
    seen = {}

    def a():
        with guards.no_implicit_transfers(True, card):
            a_in.set()
            b_in.wait(5)
        seen["after_a"] = mode["now"]
        a_out.set()

    def b():
        a_in.wait(5)
        with guards.no_implicit_transfers(True, card):
            b_in.set()
            a_out.wait(5)
            seen["inside_b"] = mode["now"]
        seen["after_b"] = mode["now"]

    threads = [threading.Thread(target=f) for f in (a, b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert seen == {"after_a": 2, "inside_b": 2, "after_b": 0}
    assert guards._scopes == 0


def test_churn_detector_matches_mxtpu():
    """Strict past the limit raises RecompileChurn with mxtpu's
    message; warn mode warns once; stats() as mxtpu's."""
    dets = [mod.ChurnDetector("t", limit=3, strict=True)
            for mod in (guards, jguards)]
    msgs = []
    for det, err in zip(dets, (guards.RecompileChurn,
                               jguards.RecompileChurn)):
        for i in range(3):
            det.note_compile(("sig", i))
        det.note_call()
        with pytest.raises(err, match="recompile churn") as e:
            det.note_compile(("sig", 3))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert dets[0].stats() == dets[1].stats()
    assert issubclass(guards.RecompileChurn, MXNetError)
    det = guards.ChurnDetector("w", limit=1, strict=False)
    det.note_compile("a")
    with pytest.warns(RuntimeWarning, match="recompile churn"):
        det.note_compile("b")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        det.note_compile("c")


@pytest.mark.parametrize("mode", ["1", "2"])
def test_runner_churn_warns_or_raises_as_mxtpu(monkeypatch, mode):
    """A runner built under MXTPU_GUARDS tolerates its ladder plus 4
    builds; the next one warns (1) or raises RecompileChurn (2), in
    both packages."""
    monkeypatch.setenv("MXTPU_GUARDS", mode)
    j, t = _mul_runners()           # ladder of 3: the limit is 7
    buckets = [(b, None) for b in range(1, 9)]
    for r, err in ((t, guards.RecompileChurn),
                   (j, jguards.RecompileChurn)):
        r.warmup(buckets[:7])
        if mode == "1":
            with pytest.warns(RuntimeWarning, match="recompile churn"):
                r.warmup(buckets[7:])
        else:
            with pytest.raises(err, match="recompile churn"):
                r.warmup(buckets[7:])
        r.infer({"data": np.ones((2, 3), np.float32)})
    assert t._churn.stats()["compiles"] == j._churn.stats()["compiles"]
    assert t._churn.stats()["calls"] == j._churn.stats()["calls"] == 1


# ---------------------------------------------------------- BERT export

@pytest.fixture(scope="module")
def bert_exports(tmp_path_factory):
    """A small BERT (dropout on, so serving must switch it off)
    exported by each package from the same seeded weights:
    {"mxtpu": files, "port": files}."""
    d = tmp_path_factory.mktemp("bert")
    with fresh_names():
        jnet = JBERT(V, U, 4 * U, L, H, max_length=MAXLEN, dropout=0.1)
    jnet.initialize(init="xavier")
    jnet(jnd.array(np.zeros((1, 8), np.float32)))
    jfiles = jnet.export(str(d / "jbert"))
    with fresh_names():
        tnet = BERTModel(V, U, 4 * U, L, H, max_length=MAXLEN, dropout=0.1)
    tnet.initialize(ctx=cpu())
    tnet(torch.zeros(1, 8))
    tfiles = tnet.export(str(d / "tbert"))
    return {"mxtpu": jfiles, "port": tfiles}


def _tokens(seed, *shape):
    return np.random.RandomState(seed).randint(0, V, shape) \
        .astype(np.float32)


@pytest.mark.parametrize("writer", ["mxtpu", "port"])
def test_bert_export_every_bucket_matches_mxtpu(bert_exports, writer):
    """Every bucket of the ladder, a batch that fills it, against
    mxtpu's runner on the same export; the weight upload is shared by
    all six entries."""
    files = bert_exports[writer]
    t = ModelRunner.from_export(*files, device="cpu", **SPEC)
    j = JRunner.from_export(*files, cache=None, **SPEC)
    ptrs = [w.data_ptr() for w in t.weight_buffers()]
    buckets = t.buckets() if writer == "mxtpu" else t.buckets()[-2:]
    for i, (b, s) in enumerate(buckets):
        toks = _tokens(100 + i, b, s)
        (got,) = t.infer({"data": toks})
        (want,) = j.infer({"data": toks})
        assert got.shape == want.shape == (b, s, V)
        np.testing.assert_allclose(got, want, rtol=ATOL, atol=ATOL)
    assert t.num_compiled() == len(buckets)
    assert [w.data_ptr() for w in t.weight_buffers()] == ptrs


def _walk_eval(sym, bindings):
    """The interpreter's walk before the graph plan (every call:
    ``_topo``, each node's JSON attributes parsed, its op looked up,
    ``nd._invoke_op``): the reference the plan is held to bit for
    bit."""
    from mxtpu_torch import ndarray as nd_mod
    from mxtpu_torch.ndarray.ndarray import NDArray
    memo = {}
    ctx = next((v._data.device for v in bindings.values()
                if isinstance(v, NDArray)), None)
    for node in sym._topo():
        if node.op is None:
            val = bindings[node.name]
            memo[(id(node), 0)] = val if isinstance(val, NDArray) \
                else nd_mod.array(val)
            continue
        ins = [memo[(id(s), i)] for s, i in node.inputs]
        op = tsym._op_of(node)
        attrs = tsym._node_attrs(node)
        if op.num_inputs == 0:
            out = nd_mod._invoke_op(op.name, ctx=ctx, **attrs)
        elif op.name in tsym._KEY_OPS and len(ins) < op.num_inputs:
            out = getattr(nd_mod, op.name)(*ins, **attrs)
        else:
            out = nd_mod._invoke_op(op.name, *ins, **attrs)
        if isinstance(out, (list, tuple)):
            for i, o in enumerate(out):
                memo[(id(node), i)] = o
        else:
            memo[(id(node), 0)] = out
    return [memo[(id(n), i)] for n, i in sym._heads]


@pytest.mark.parametrize("training", [False, True])
def test_plan_bit_equal_to_the_walk(bert_exports, training):
    """The plan (built once, run twice) against the walk on the BERT
    export, in inference and in training mode (dropout drawn from the
    same seeded generator each time)."""
    from mxtpu_torch.ndarray import load_params
    from mxtpu_torch.ndarray.ndarray import NDArray
    sym_file, params_file = bert_exports["mxtpu"]
    sym = tsym.load(sym_file)
    bindings = {k: NDArray(torch.tensor(v))
                for k, v in load_params(params_file).items()}
    bindings["data"] = NDArray(torch.from_numpy(_tokens(7, 3, 16)))
    plan = tsym._GraphPlan(sym)
    scope = autograd.train_mode() if training else autograd.predict_mode()
    with scope:
        trandom.seed(11)
        (want,) = _walk_eval(sym, bindings)
        for _ in range(2):
            trandom.seed(11)
            (got,) = plan.run(bindings)
            assert torch.equal(got._data, want._data)
        trandom.seed(11)
        (again,) = tsym._eval_symbol(sym, bindings)
    assert torch.equal(again._data, want._data)


def test_plan_names_the_node_that_failed():
    x = tsym.var("x")
    g = tsym.FullyConnected(x, num_hidden=3, name="fc")
    plan = tsym._GraphPlan(g)
    bad = {"x": tmx.nd.zeros((2, 4), cpu()),
           "fc_weight": tmx.nd.zeros((3, 5), cpu()),
           "fc_bias": tmx.nd.zeros((3,), cpu())}
    with pytest.raises(Exception) as e:
        plan.run(bad)
    assert "graph node 'fc' (FullyConnected)" in e.value.__notes__
    with pytest.raises(MXNetError, match="unbound variable 'fc_bias'"):
        plan.run({k: v for k, v in bad.items() if k != "fc_bias"})


# ------------------------------------------------- launches and replays

def test_recording_keeps_launches_out_of_the_counts():
    """What a capture launches goes to its record, not the counts; a
    replay adds the record once."""
    import importlib
    ln = importlib.import_module("mxtpu_torch.kernels.layer_norm")
    kernels.reset_launch_counts()
    with kernels.recording() as rec:
        kernels.bump(ln)
        kernels.bump(ln, "FRLN_LAUNCHES")
        kernels.bump(ln, "FRLN_LAUNCHES")
    assert rec == {(ln, "LAUNCHES"): 1, (ln, "FRLN_LAUNCHES"): 2}
    assert kernels.launch_counts()["layer_norm_fwd"] == 0
    for _ in range(3):
        kernels.add_launches(rec)
    counts = kernels.launch_counts()
    assert counts["layer_norm_fwd"] == 3
    assert counts["fused_residual_ln_fwd"] == 6
    kernels.bump(ln)
    assert kernels.launch_counts()["layer_norm_fwd"] == 4
    kernels.reset_launch_counts()


def test_run_raw_results_are_the_callers():
    """What run_raw, infer and run_requests return is never a buffer a
    later call writes."""
    _, t = _mul_runners()
    a = t.run_raw(t._pad_stack([{"data": W}], (1, None)), (1, None))[0]
    b = t.run_raw(t._pad_stack([{"data": 2 * W}], (1, None)), (1, None))[0]
    assert torch.equal(a, torch.from_numpy(W * W)[None])
    assert torch.equal(b, torch.from_numpy(2 * W * W)[None])
    (x,) = t.infer({"data": W[None]})
    t.infer({"data": 3 * W[None]})
    np.testing.assert_array_equal(x, (W * W)[None])


# ----------------------------------------------------- GenerateRunner

@pytest.fixture(scope="module")
def gen_export(tmp_path_factory):
    with fresh_names():
        net = BERTModel(32, 16, 32, 2, 2, max_length=16, dropout=0.0,
                        use_token_type=False, causal=True)
    net.initialize(ctx=cpu())
    net(tmx.nd.array(np.ones((1, 3), np.float32), ctx=cpu()),
        tmx.nd.zeros((1,), ctx=cpu()),
        tmx.nd.zeros(net.kv_cache_spec(1), ctx=cpu()))
    return net, net.export(str(tmp_path_factory.mktemp("gen") / "g"))


def test_generate_entries_compile_seconds_and_tables(gen_export):
    """warmup builds one entry per bucket (compile_seconds); on the CPU
    no entry binds a table, so every new_cache() table runs on them."""
    net, files = gen_export
    r = GenerateRunner.from_export(*files, net.kv_cache_spec(2, 16),
                                   prompt_buckets=(4, 8), device="cpu")
    secs = r.warmup()
    assert set(secs) == set(r.buckets()) == set(r.compile_seconds)
    assert r.num_compiled() == len(r.buckets())
    kv, other = r.new_cache(), r.new_cache()
    assert other is not kv and not kv.any() and not other.any()
    for table in (kv, other):
        logits, out = r.prefill(np.ones((1, 4), np.float32),
                                np.zeros(1, np.float32),
                                np.zeros(1, np.float32), table)
        assert out is table and table.any() and logits.shape == (1, 4, 32)
    assert r.num_compiled() == len(r.buckets())


def _table_key(kv):
    from mxtpu_torch.serving.entry import tensor_key
    return tensor_key(kv)


def test_generate_ladder_per_table(gen_export):
    """Where entries bind their table (the card), each table gets its
    own ladder, built once: a table keeps its entries while another
    runs, a third table drops the least recently used one's ladder,
    and warmup needs the table.  The binding is forced here on CPU
    entries, which run the same plan."""
    from mxtpu_torch.serving.generate import MAX_TABLES
    net, files = gen_export
    r = GenerateRunner.from_export(*files, net.kv_cache_spec(1, 16),
                                   prompt_buckets=(4,), device="cpu")
    r._captured = True
    with pytest.raises(MXNetError, match="pass kv="):
        r.warmup()
    a, b, c = r.new_cache(), r.new_cache(), r.new_cache()
    dec = ("decode", (2,))
    r.warmup(kv=a)
    entry_a = r._tables[_table_key(a)][dec]
    assert r.num_compiled() == len(r.buckets())
    args = (np.ones((2, 1), np.float32), np.zeros(2, np.float32))
    r.decode(*args, b)
    assert r.num_compiled() == len(r.buckets()) + 1
    r.decode(*args, a)
    assert r._tables[_table_key(a)][dec] is entry_a
    assert r.num_compiled() == len(r.buckets()) + 1
    r.decode(*args, c)          # b was used least recently: dropped
    assert MAX_TABLES == 2 and list(r._tables) == [_table_key(a),
                                                   _table_key(c)]
    r.decode(*args, b)          # a was: dropped, b built anew
    assert list(r._tables) == [_table_key(c), _table_key(b)]
    assert r.num_compiled() == 2


def test_generate_donate_off_is_refused_on_the_card(gen_export):
    """donate=False is no longer refused on the card: a captured step
    writes the table it was captured on, so a runner that does not
    donate binds every entry to a table of its own, copies the caller's
    table into it before a call and hands back a copy after.  Here a
    CPU runner keys its entries by table as the card does: one ladder,
    on its own table, whatever table the caller passes, and each
    caller's table left as it was."""
    from mxtpu_torch.serving.entry import tensor_key
    net, files = gen_export
    spec = net.kv_cache_spec(1, 16)
    off = GenerateRunner.from_export(*files, spec, device="cpu",
                                     prompt_buckets=(4,), donate=False)
    on = GenerateRunner.from_export(*files, spec, device="cpu",
                                    prompt_buckets=(4,), donate=True)
    off._captured = True
    off.warmup()                    # no kv: the runner's own table
    assert list(off._tables) == [tensor_key(off._own)]
    args = (np.array([[1, 2, 3, 4]], np.float32),
            np.zeros(1, np.float32), np.zeros(1, np.float32))
    for _ in range(2):
        kv, kv_on = off.new_cache(), on.new_cache()
        logits, out = off.prefill(*args, kv)
        want, out_on = on.prefill(*args, kv_on)
        assert not kv.any() and out is not kv and out is not off._own
        np.testing.assert_array_equal(logits, want)
        assert torch.equal(out, out_on)
        kept = out.clone()
        toks = np.array([[5], [0]], np.float32)
        step = np.array([4, 0], np.float32)
        dl, dout = off.decode(toks, step, out)
        dwant, _ = on.decode(toks, step, out_on)
        assert torch.equal(out, kept)
        np.testing.assert_array_equal(dl, dwant)
        assert torch.equal(dout, out_on)
    assert list(off._tables) == [tensor_key(off._own)]
    assert off.num_compiled() == len(off.buckets())


@pytest.mark.parametrize("mode", ["1", "2"])
def test_generate_churn_as_mxtpu(gen_export, monkeypatch, mode):
    """GenerateRunner's ChurnDetector: a ladder for each table it keeps
    plus 4 builds; past that it warns or raises as ModelRunner's
    does."""
    from mxtpu_torch.serving.generate import MAX_TABLES
    monkeypatch.setenv("MXTPU_GUARDS", mode)
    net, files = gen_export
    r = GenerateRunner.from_export(*files, net.kv_cache_spec(1, 16),
                                   prompt_buckets=(4,), device="cpu")
    assert r._churn.limit == MAX_TABLES * len(r.buckets()) + 4 == 8
    extra = [("prefill", (1, s)) for s in range(5, 12)]
    r.warmup(r.buckets() + extra[:6])
    if mode == "1":
        with pytest.warns(RuntimeWarning, match="recompile churn"):
            r.warmup(extra[6:])
    else:
        with pytest.raises(guards.RecompileChurn):
            r.warmup(extra[6:])
    r.decode(np.zeros((2, 1), np.float32), np.zeros(2, np.float32),
             r.new_cache())
    assert r._churn.stats()["calls"] == 1
    assert json.dumps(r._churn.stats())


def test_guard_knobs_match_mxtpu(monkeypatch):
    from mxtpu import knobs as jknobs
    from mxtpu_torch import knobs as tknobs
    for name in ("MXTPU_GUARDS", "MXTPU_GUARDS_CHURN_LIMIT"):
        t, j = tknobs._REGISTRY[name], jknobs._REGISTRY[name]
        assert (t.default, t.kind) == (j.default, j.kind)
    monkeypatch.setenv("MXNET_GUARDS_CHURN_LIMIT", "3")
    assert guards.ChurnDetector("k").limit == 3


def test_capture_holds_the_collector_off_counted():
    """A capture runs with the cyclic garbage collector off (a
    collection that frees another entry's graph would destroy it inside
    the capture); nested and concurrent holds turn it back on only when
    the last ends, and leave it off where it was off."""
    import gc
    import threading
    from mxtpu_torch.serving import entry
    was = gc.isenabled()
    try:
        gc.enable()
        with entry._no_collection():
            assert not gc.isenabled()
            done = threading.Event()
            release = threading.Event()

            def other():
                with entry._no_collection():
                    done.set()
                    release.wait(10)
            t = threading.Thread(target=other)
            t.start()
            assert done.wait(10)
        assert not gc.isenabled()        # the other capture still holds
        release.set()
        t.join(10)
        assert not t.is_alive() and gc.isenabled()
        gc.disable()
        with entry._no_collection():
            pass
        assert not gc.isenabled()
    finally:
        (gc.enable if was else gc.disable)()
