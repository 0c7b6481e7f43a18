"""Fleet generation in the port (``FleetRouter.submit_generate``, a
``FleetWorker``'s decode plane, the replay of a stolen stream from its
partial state) against mxtpu's.

The four fleet scenarios of ``tests/test_generate.py`` — a kill
mid-generation resumed exactly, a late join into the running batch, no
hedging of streams, a deadline that never yields a stale stream — and a
seeded top-k stream killed mid-way run on both packages under the same
``FakeClock`` script, on mxtpu's tiny causal BERT (V 32, U 16, 2 layers)
exported once and loaded by both packages' ``GenerateRunner``; the
port's net carries mxtpu's weights (``params_from_mxtpu``).  The tokens,
each request's ``tried`` list, the stream as the caller saw it, the
lane accounting and the fleet counters must equal mxtpu's, and the
greedy streams the port net's full-forward reference.
"""
import json

import pytest

from mxtpu_torch.models import BERTModel

from tests.test_torch_generate import (  # noqa: F401 — fixtures
    LANES, L, _bert, _ref_greedy, export, exports, net, nets)
from tests.torch_fleet_helpers import PKGS, FakeClock, fleet_record

RUNNER_KW = {"mxtpu": {"cache": None}, "port": {"device": "cpu"}}


def _gen_worker(pkg, export, clk, name):
    P = PKGS[pkg]
    runner = P.GenerateRunner.from_export(
        *export, _bert(BERTModel).kv_cache_spec(LANES, L),
        prompt_buckets=(8,), **RUNNER_KW[pkg])
    return P.FleetWorker(None, name, clock=clk, gen_runner=runner)


def _gen_router(P, clk, **kw):
    kw.setdefault("backoff_base_us", 10_000)
    kw.setdefault("backoff_cap_us", 50_000)
    kw.setdefault("jitter", 0.0)
    kw.setdefault("hedge_after_us", 0)
    return P.FleetRouter(clock=clk, threaded=False, canary=None, **kw)


def _crank(router, clk, n=40, dt=0.05, until=None):
    for _ in range(n):
        clk.advance(dt)
        router.tick()
        if until is not None and until():
            return


def _gen_record(router, freqs, streamed=()):
    rec = fleet_record(router)
    rec["streams"] = []
    for f in freqs:
        out = {"tried": list(f.tried), "requeues": f.requeues,
               "hedges": f.hedges, "anomalies": f.anomalies(),
               "finish": f.finish_reason, "t_done": f.t_done}
        try:
            out["tokens"] = f.result(0)
        except Exception as e:  # noqa: BLE001 — the error is the record
            out["error"] = type(e).__name__
        rec["streams"].append(out)
    rec["streamed"] = list(streamed)
    return rec


def sc_kill_mid_generation(pkg, export, top_k=1, seed=0):
    P = PKGS[pkg]
    clk = FakeClock(100.0)
    P.profiler.set_state("run")
    try:
        router = _gen_router(P, clk)
        router.add_worker(_gen_worker(pkg, export, clk, "w0"))
        router.add_worker(_gen_worker(pkg, export, clk, "w1"))
        streamed = []
        freq = router.submit_generate(
            [1, 2, 3], max_tokens=6, top_k=top_k, seed=seed,
            timeout_s=60.0, on_token=lambda t, i: streamed.append((i, t)))
        assert isinstance(freq, P.FleetGenerateRequest)
        _crank(router, clk, dt=0.01, until=lambda: len(streamed) >= 2)
        assert len(streamed) >= 2 and not freq.done()
        host = freq.tried[-1]
        router.kill(host)
        _crank(router, clk, until=freq.done)
        assert freq.requeues == 1
        assert freq.anomalies() == {"duplicate_tokens": 0,
                                    "wrong_tokens": 0}
        assert [i for i, _ in streamed] == list(range(6))
        events = json.loads(P.profiler.dumps())["traceEvents"]
        names = [e["name"] for e in P.obs.trace_of(freq.trace_id,
                                                   events=events)]
        for s in (P.obs.SPAN_SUBMIT, P.obs.SPAN_PREFILL,
                  P.obs.SPAN_TOKEN, P.obs.SPAN_STEAL,
                  P.obs.SPAN_REPLAY):
            assert s in names, f"missing {s} in {names}"
        rec = _gen_record(router, [freq], streamed)
        rec["spans"] = sorted(names)
        rec["resumed"] = next(
            e["args"]["resumed"] for e in P.obs.trace_of(
                freq.trace_id, events=events)
            if e["name"] == P.obs.SPAN_REPLAY)
        router.close()
        return rec
    finally:
        P.profiler.set_state("stop")
        P.profiler.dumps(reset=True)


def sc_continuous_batching_late_join(pkg, export):
    P = PKGS[pkg]
    clk = FakeClock(100.0)
    router = _gen_router(P, clk)
    w = _gen_worker(pkg, export, clk, "w0")
    router.add_worker(w)
    f1 = router.submit_generate([1, 2, 3], max_tokens=5, timeout_s=60.0)
    clk.advance(0.01)
    router.tick()
    lanes = [w.generator.free_lanes()]
    f2 = router.submit_generate([4, 5], max_tokens=4, timeout_s=60.0)
    _crank(router, clk, until=lambda: f1.done() and f2.done())
    lanes += [w.generator.free_lanes(), w.generator.joins]
    assert lanes == [LANES - 1, LANES, 2]
    rec = _gen_record(router, [f1, f2])
    rec["lanes"] = lanes
    router.close()
    return rec


def sc_never_hedges(pkg, export):
    P = PKGS[pkg]
    clk = FakeClock(100.0)
    router = _gen_router(P, clk, hedge_after_us=1)
    router.add_worker(_gen_worker(pkg, export, clk, "w0"))
    router.add_worker(_gen_worker(pkg, export, clk, "w1"))
    freq = router.submit_generate([1, 2, 3], max_tokens=4,
                                  timeout_s=60.0)
    _crank(router, clk, until=freq.done)
    assert freq.hedges == 0 and len(freq.tried) == 1
    rec = _gen_record(router, [freq])
    router.close()
    return rec


def sc_deadline_never_stale_stream(pkg, export):
    P = PKGS[pkg]
    clk = FakeClock(100.0)
    router = _gen_router(P, clk)
    router.add_worker(_gen_worker(pkg, export, clk, "w0"))
    freq = router.submit_generate([1, 2, 3], max_tokens=500,
                                  timeout_s=0.2)
    clk.advance(0.01)
    router.tick()
    clk.advance(5.0)
    router.tick()
    with pytest.raises(P.RequestTimeout):
        freq.result(0)
    rec = _gen_record(router, [freq])
    router.close()
    return rec


def _both(scenario, export, **kw):
    recs = {}
    for pkg, P in PKGS.items():
        P.obs.reset()   # flight recorders are process-wide, by name
        recs[pkg] = scenario(pkg, export, **kw)
    assert recs["port"] == recs["mxtpu"]
    return recs["port"]


def test_fleet_kill_mid_generation_exact_resume(net, export):
    rec = _both(sc_kill_mid_generation, export)
    assert rec["streams"][0]["tokens"] == _ref_greedy(net, [1, 2, 3], 6)
    assert 1 <= rec["resumed"] < 6


def test_fleet_kill_mid_topk_stream_resumes_seeded(export):
    """A seeded top-k stream killed mid-way resumes on the survivor and
    equals the same prompt's uninterrupted stream, token for token."""
    rec = _both(sc_kill_mid_generation, export, top_k=4, seed=13)
    P = PKGS["port"]
    clk = FakeClock(100.0)
    router = _gen_router(P, clk)
    router.add_worker(_gen_worker("port", export, clk, "w0"))
    alone = router.submit_generate([1, 2, 3], max_tokens=6, top_k=4,
                                   seed=13, timeout_s=60.0)
    _crank(router, clk, until=alone.done)
    assert rec["streams"][0]["tokens"] == alone.result(0)
    router.close()


def test_fleet_generate_continuous_batching_late_join(net, export):
    rec = _both(sc_continuous_batching_late_join, export)
    assert rec["streams"][0]["tokens"] == _ref_greedy(net, [1, 2, 3], 5)
    assert rec["streams"][1]["tokens"] == _ref_greedy(net, [4, 5], 4)


def test_fleet_generate_never_hedges(export):
    _both(sc_never_hedges, export)


def test_fleet_generate_deadline_never_stale_stream(export):
    rec = _both(sc_deadline_never_stale_stream, export)
    assert rec["streams"][0]["error"] == "RequestTimeout"


def test_generate_runner_ladder_handoff(export):
    """``ladder_metadata``/``warm_from`` and the cache probes of the
    port's GenerateRunner against mxtpu's: the same metadata keys and
    buckets, a replacement that warms the donor's entries as "donor"
    builds (no cold one), ``default_bucket`` mxtpu's."""
    def run(pkg):
        P = PKGS[pkg]
        clk = FakeClock()
        donor = _gen_worker(pkg, export, clk, "w0")
        donor.generator.runner.warmup(
            [donor.generator.runner.default_bucket("prefill"),
             donor.generator.runner.default_bucket()],
            **({"kv": None} if pkg == "port" else {}))
        meta = donor.handoff()
        fresh = _gen_worker(pkg, export, clk, "w1")
        router = _gen_router(P, clk)
        warmed = router.add_worker(fresh, warm_from=meta)
        r = fresh.generator.runner
        out = {"meta": {k: v for k, v in meta["generate"].items()
                        if k != "compile_seconds"},
               "warmed": warmed, "compiled": r.num_compiled(),
               "default": [r.default_bucket(), r.default_bucket("prefill")],
               "cached": r.cached_buckets(), "disk": r.warm_from_disk()}
        if pkg == "port":
            out["cold"] = r.cold_compiles()
            assert set(r.compile_sources().values()) == {"donor"}
            assert donor.generator.runner.cold_compiles() == 2
        router.close()
        return out
    j, t = run("mxtpu"), run("port")
    assert t.pop("cold") == 0
    assert t == j


def test_eager_plan_stands_in_for_entry(export):
    """``_eager_entry`` takes ``_entry``'s arguments (the source a build
    records included), so the eager plan can replace a runner's entries
    whole, warm-ups and handoffs included, as ``chip_smoke.py`` swaps
    it in to time the eager plan beside the captured graphs."""
    from tests.torch_fleet_helpers import mul_runner
    P = PKGS["port"]
    clk = FakeClock()
    g = _gen_worker("port", export, clk, "w0").generator
    g.runner._entry = g.runner._eager_entry
    g.warmup()
    g.warm_from(g.runner.ladder_metadata())
    req = g.submit([1, 2, 3], max_tokens=3)
    while not req.done():
        g.step()
    assert len(req.result(0)) == 3
    r = mul_runner(P)
    r._entry = r._eager_entry
    r.warmup()
    r.warm_from({"compiled_buckets": [[1, None]]})
    assert r.num_compiled() == 0   # the eager plan stores nothing
