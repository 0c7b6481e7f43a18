"""The port's observability layer (``mxtpu_torch/obs/``,
``mxtpu_torch/profiler.py``) and the serving hooks that feed it,
against mxtpu's.

The same sequence of counter, gauge and histogram operations gives a
byte-equal Prometheus text and equal snapshots in both packages; the
flight recorders' rings and the chrome-trace span records are equal,
timestamps aside; a driven SLO fires at the same ticks; the ``render_*``
pages are equal; a fleet request through a kill leaves the same span
timeline in both; and the port's ``self_check()`` passes on the CPU,
its probe a torch op on ``device="cpu"``.
"""
import json

import numpy as np
import pytest

from tests.torch_fleet_helpers import (PKGS, FakeClock, crank,
                                       mul_runner, payload)


@pytest.fixture(autouse=True)
def _clean():
    for P in PKGS.values():
        P.obs.reset()
        P.profiler.set_state("stop")
        P.profiler.dumps(reset=True)
    yield
    for P in PKGS.values():
        P.profiler.set_state("stop")
        P.profiler.dumps(reset=True)
        P.obs.reset()


def _both(fn):
    """``fn(P)`` on mxtpu and on the port; asserts the two results are
    equal and returns the port's."""
    got = {pkg: fn(P) for pkg, P in PKGS.items()}
    assert got["port"] == got["mxtpu"]
    return got["port"]


def _drive_registry(reg):
    c = reg.counter("mxtpu_probe_events_total", "Events.",
                    labels=("kind",))
    c.labels(kind="a").inc(3)
    c.labels(kind='b"\\esc\n').inc()
    c.labels(kind="a").inc(0.5)
    g = reg.gauge("mxtpu_probe_depth", "Depth.")
    g.set(-2.5)
    g.inc(4)
    g.dec(0.25)
    h = reg.histogram("mxtpu_probe_lat_seconds", "Latency.",
                      labels=("endpoint", "source"),
                      buckets=(0.001, 0.1, 2.0))
    for v in (0.0005, 0.05, 0.05, 5.0, 0.1):
        h.labels(endpoint="fleet", source="cold").observe(v)
    h.labels(endpoint="fleet", source="donor").observe(0.01)
    reg.histogram("mxtpu_probe_bytes", "Bytes.").observe(1e6)
    reg.counter("mxtpu_probe_bare_total", "No labels.").inc(7)


def test_registry_operations_byte_equal():
    def run(P):
        from importlib import import_module
        metrics = import_module(P.obs.__name__ + ".metrics")
        reg = metrics.MetricsRegistry()
        _drive_registry(reg)
        text = reg.prometheus_text()
        assert metrics.parse_prometheus_text(text) == \
            metrics.samples_from_snapshot(reg.snapshot())
        return {"text": text, "snapshot": reg.snapshot(),
                "summary": reg.summary(), "names": reg.names()}
    _both(run)


def test_registry_refusals_match():
    def run(P):
        from importlib import import_module
        metrics = import_module(P.obs.__name__ + ".metrics")
        reg = metrics.MetricsRegistry()
        reg.counter("mxtpu_x_total", "x", labels=("a",))
        out = []
        for fn in (lambda: reg.gauge("mxtpu_x_total", "x"),
                   lambda: reg.counter("mxtpu_x_total", "x",
                                       labels=("b",)),
                   lambda: reg.counter("bad_name_total", "x"),
                   lambda: reg.counter("mxtpu_no_suffix", "x"),
                   lambda: reg.histogram("mxtpu_lat", "x")):
            try:
                fn()
                out.append(None)
            except P.MXNetError as e:
                out.append(str(e))
        return out
    _both(run)


def test_serving_stats_publish_the_same_series():
    def run(P):
        clk = FakeClock(10.0)
        st = P.ServingStats(name="ep", clock=clk)
        st.record_queue_depth(5)
        st.record_batch(3, 4)
        for lat, q in ((1000.0, 200.0), (3000.0, 100.0)):
            clk.advance(0.01)
            st.record_completion(lat, q)
        st.record_rejected(2)
        st.record_timeout()
        st.bump("retries", 3)
        st.record_ttft(5000.0)
        for t in (800.0, 1200.0, 1000.0):
            st.record_token(t)
        eta = [st.token_eta_us(n) for n in (0, 1, 16)]
        cold = P.ServingStats(name="cold").token_eta_us(4)
        return {"text": P.obs.prometheus_text(), "eta": eta,
                "cold": cold, "queue_eta": st.queue_eta_us()}
    got = _both(run)
    assert got["cold"] is None and got["eta"][2] > 0


def test_flight_recorder_ring_and_dump(tmp_path):
    def run(P):
        from importlib import import_module
        recorder = import_module(P.obs.__name__ + ".recorder")
        fc = FakeClock(5.0)
        rec = recorder.FlightRecorder("fleet/w9", capacity=3, clock=fc)
        for k in range(5):
            fc.advance(1.0)
            rec.record("ev", k=k, tag=f"t{k}")
        d = tmp_path / P.obs.__name__
        d.mkdir()
        text = rec.dump(reason="test", path=str(d))
        files = sorted(p.name for p in d.glob("flight_*.json"))
        snap = rec.snapshot()
        rec.clear()
        return {"snapshot": snap, "dump": json.loads(text),
                "files": [f.split("_")[1] for f in files],
                "after_clear": rec.events()}
    _both(run)


def _normalized(events, ids):
    """Span records without their clocks: timestamps, durations, pid
    and tid dropped, trace ids renamed by first appearance."""
    def tid(t):
        return ids.setdefault(t, f"id{len(ids)}")
    out = []
    for ev in events:
        e = {k: v for k, v in ev.items()
             if k not in ("ts", "dur", "pid", "tid")}
        args = dict(e.get("args", {}))
        if "trace_id" in args:
            args["trace_id"] = tid(args["trace_id"])
        if "trace_ids" in args:
            args["trace_ids"] = [tid(t) for t in args["trace_ids"]]
        if args:
            e["args"] = args
        out.append(e)
    return out


def test_span_records_match():
    def run(P):
        P.profiler.set_state("run")
        a = P.obs.new_trace_id()
        b = P.obs.new_trace_id()
        P.obs.span(P.obs.SPAN_SUBMIT, 1.0, 0.0, trace_id=a, group="g")
        P.obs.span(P.obs.SPAN_QUEUE_WAIT, 2.0, 5.0, trace_id=b,
                   worker="w0")
        P.obs.span(P.obs.SPAN_RUN, 3.0, -1.0, cat="serving",
                   trace_ids=[a, b], batch=2)
        with P.profiler.Task("serving:compile:b1"):
            pass
        P.profiler.Marker("m").mark()
        P.profiler.Counter("c", 3).increment(2)
        P.profiler.set_state("stop")
        P.obs.span(P.obs.SPAN_EXECUTE, 4.0, 1.0, trace_id=a)  # not kept
        ev = json.loads(P.profiler.dumps())["traceEvents"]
        ids = {}
        return {"events": _normalized(ev, ids),
                "timeline": _normalized(P.obs.trace_of(a, events=ev),
                                        ids),
                "spans": [getattr(P.obs, n) for n in P.obs.__all__
                          if n.startswith("SPAN_")]}
    _both(run)


def test_eager_dispatch_records_op_spans_as_mxtpu():
    """mxtpu's per-op profiler spans of the eager dispatcher: while the
    profiler runs, each op called through ``nd`` (the operators of
    NDArray included; not the creation functions, which dispatch no
    op) is one "operator" span named as called; none after it
    stops."""
    import mxtpu
    import mxtpu.ndarray as jnd
    import mxtpu_torch
    import mxtpu_torch.ndarray as tnd
    mods = {"mxtpu": (jnd, mxtpu.cpu()),
            "port": (tnd, mxtpu_torch.cpu())}

    def run(P):
        nd, ctx = mods["port" if P is PKGS["port"] else "mxtpu"]
        P.profiler.set_state("run")
        a = nd.array(np.arange(6, dtype=np.float32).reshape(2, 3),
                     ctx=ctx)
        b = nd.relu(a * 2 - 1)
        nd.sum(b, axis=1)
        nd.softmax(a)
        nd.FullyConnected(a, nd.ones((4, 3), ctx=ctx), num_hidden=4,
                          no_bias=True)
        P.profiler.set_state("stop")
        nd.exp(a)                                      # not kept
        ev = json.loads(P.profiler.dumps())["traceEvents"]
        return [(e["name"], e["ph"]) for e in ev
                if e.get("cat") == "operator"]

    spans = _both(run)
    assert [n for n, _ in spans] == [
        "broadcast_mul", "broadcast_sub", "relu", "sum", "softmax",
        "FullyConnected"]


def test_fleet_kill_trace_timeline_matches():
    """A request whose first worker dies mid-flight leaves the same
    span timeline in both packages: submit, the doomed attempt's queue
    wait, steal and backoff, re-dispatch, pad/scatter, run, execute."""
    def run(P):
        clk = FakeClock(100.0)
        P.profiler.set_state("run")
        router = P.FleetRouter(clock=clk, threaded=False, canary=None,
                               backoff_base_us=10_000, jitter=0.0)
        w0 = P.FleetWorker(mul_runner(P), "w0", clock=clk,
                           max_queue_delay_us=0.0,
                           faults=P.FaultPlan(P.CrashAt(0)))
        router.add_worker(w0)
        router.add_worker(P.FleetWorker(mul_runner(P), "w1", clock=clk,
                                        max_queue_delay_us=0.0))
        req = router.submit(payload(3.0), timeout_s=30.0)
        crank(router, clk, n=12, dt=0.05)
        assert req.done()
        events = json.loads(P.profiler.dumps())["traceEvents"]
        timeline = P.obs.trace_of(req.trace_id, events=events)
        names = [e["name"] for e in timeline]
        for s in (P.obs.SPAN_SUBMIT, P.obs.SPAN_QUEUE_WAIT,
                  P.obs.SPAN_STEAL, P.obs.SPAN_BACKOFF,
                  P.obs.SPAN_REDISPATCH, P.obs.SPAN_EXECUTE,
                  P.obs.SPAN_PAD_SCATTER, P.obs.SPAN_RUN):
            assert s in names, f"missing {s} in {names}"
        fleet = [e for e in timeline if e["name"].startswith("fleet/")]
        router.close()
        ids = {}
        return {"fleet": _normalized(fleet, ids),
                # the fleet spans run on the fake clock: their offsets
                # from the first one, not the profiler's epoch
                "fleet_ts": [(round(e["ts"] - fleet[0]["ts"], 3),
                              round(e["dur"], 3)) for e in fleet],
                "names": sorted(names),
                "postmortem": [e["kind"] for e in
                               router.postmortem("w0")["flight"]
                               ["events"]]}
    _both(run)


def _avail_rig(P):
    from importlib import import_module
    metrics = import_module(P.obs.__name__ + ".metrics")
    t = [0.0]
    reg = metrics.MetricsRegistry()
    ep = {"endpoint": "fleet"}
    c = reg.counter("mxtpu_serving_completed_total", "c",
                    labels=("endpoint",)).labels(**ep)
    to = reg.counter("mxtpu_serving_timeout_total", "t",
                     labels=("endpoint",)).labels(**ep)
    h = reg.histogram("mxtpu_serving_latency_seconds", "l",
                      labels=("endpoint",),
                      buckets=(0.01, 0.1, 1.0)).labels(**ep)
    smp = P.obs.Sampler(reg, period_us=0, clock=lambda: t[0])
    rec = import_module(P.obs.__name__ + ".recorder").FlightRecorder(
        "test/slo", clock=lambda: t[0])
    eng = P.obs.SLOEngine(
        [P.obs.AvailabilitySLO("avail", objective=0.9),
         P.obs.LatencySLO("fast", 0.05, objective=0.9)],
        smp, rules=(P.obs.BurnRateRule(fast_s=10.0, slow_s=60.0,
                                       factor=2.0),),
        clock=lambda: t[0],
        alerts=reg.counter("mxtpu_slo_alerts_total", "a",
                           labels=("slo", "window")),
        recorder=rec)
    return t, reg, smp, eng, c, to, h


def test_driven_slo_fires_at_the_same_ticks():
    def run(P):
        t, reg, smp, eng, c, to, h = _avail_rig(P)
        ticks = []
        for k in range(40):
            now = 10.0 * k
            if k < 6:
                c.inc(100)
                for _ in range(20):
                    h.observe(0.005)
            elif k < 20:
                to.inc(30)
                c.inc(10)
                for _ in range(20):
                    h.observe(0.5)
            else:
                c.inc(1000)
                for _ in range(20):
                    h.observe(0.005)
            t[0] = now
            ticks.append((now, [list(f) for f in eng.tick(now)],
                          [list(f) for f in eng.firing()]))
        fired = [x for x in ticks if x[1]]
        assert fired, "the driven SLO never fired"
        return {"ticks": ticks, "snapshot": json.loads(
                    json.dumps(eng.snapshot(), default=str)),
                "recorder": eng.recorder.events(),
                "text": reg.prometheus_text(),
                "sampler": smp.summary()}
    _both(run)


def test_parse_slo_classes_match():
    _both(lambda P: [sorted(vars(s).items()) for s in
                     P.obs.parse_slo_classes(
                         "interactive:fleet:50:0.95,batch:ep:200:0.9:99")])


def test_render_pages_match():
    def run(P):
        t, reg, smp, eng, c, to, h = _avail_rig(P)
        c.inc(10)
        to.inc(90)
        t[0] = 5.0
        eng.tick(5.0)
        t[0] = 15.0
        eng.tick(15.0)
        clk = FakeClock(100.0)
        router = P.FleetRouter(clock=clk, threaded=False, canary=None)
        router.add_worker(P.FleetWorker(mul_runner(P), "w0", clock=clk,
                                        max_queue_delay_us=0.0))
        router.kill("w0")
        crank(router, clk, n=2)
        P.obs.flight("fleet/extra", clock=clk).record("x", n=1)
        http = P.obs.http
        pages = {
            "metrics": http.render_metrics(reg),
            "varz": http.render_varz(reg),
            "healthz": http.render_healthz(router),
            "healthz_none": http.render_healthz(),
            "statusz": json.loads(http.render_statusz(
                router=router, slo=eng, sampler=smp)),
            "tracez": http.render_tracez("r0-000001")}
        for w in pages["statusz"]["fleet"]["workers"].values():
            w.pop("requests_per_sec", None)
        pages["statusz"]["fleet"].pop("requests_per_sec", None)
        router.close()
        return pages
    _both(run)


def test_port_self_check_passes_on_the_cpu():
    from mxtpu_torch import obs as tobs
    from mxtpu import obs as jobs
    info = tobs.self_check(probe=True, device="cpu")
    assert info["probe"] is True and info["probe_device"] == "cpu"
    want = jobs.self_check()
    assert {k: v for k, v in info.items()
            if k not in ("probe", "probe_device")} == want


def test_port_obs_cli(capsys):
    from mxtpu_torch.obs.__main__ import main
    assert main([]) == 0
    assert "obs.self_check OK" in capsys.readouterr().out
    assert main(["--prom"]) == 0


def test_compile_builds_reach_flight_and_registry():
    """A port runner's entry builds land in the "compile" flight
    recorder and the compile counters, as mxtpu's compiles do; the
    ChurnDetector's builds in ``mxtpu_compile_cache_miss_total``."""
    from mxtpu_torch import guards
    P = PKGS["port"]
    clk = FakeClock()
    w0 = P.FleetWorker(mul_runner(P), "w0", clock=clk)
    w0.runner.warmup()
    n = w0.runner.num_compiled()
    w1 = P.FleetWorker(mul_runner(P), "w1", clock=clk)
    w1.runner.warm_from(w0.handoff())
    evs = P.obs.flight("compile").events()
    assert [e["kind"] for e in evs] == ["compile_miss"] * (2 * n)
    assert [e["source"] for e in evs] == ["cold"] * n + ["donor"] * n
    flat = P.obs.summary()
    label = w0.runner._entry_label
    assert flat[f'mxtpu_serving_compile_total{{entry="{label}"}}'] \
        == 2.0 * n
    det = guards.ChurnDetector("probe_entry", limit=100)
    det.note_compile("sig0")
    det.note_compile("sig1")
    assert P.obs.summary()['mxtpu_compile_cache_miss_total'
                           '{entry="probe_entry"}'] == 2.0


def test_device_trace_capture_on_the_cpu(tmp_path):
    """``start_jax_trace``/``stop_jax_trace`` keep mxtpu's names and
    write a torch.profiler chrome trace (CPU ops here; the card's
    kernels too where CUDA is available)."""
    import torch
    from mxtpu_torch import profiler
    profiler.start_jax_trace(str(tmp_path))
    with pytest.raises(P_MXNetError()):
        profiler.start_jax_trace(str(tmp_path))
    (torch.ones(4) * 3).sum()
    path = profiler.stop_jax_trace()
    doc = json.loads(open(path).read())
    assert doc["traceEvents"]
    with pytest.raises(P_MXNetError()):
        profiler.stop_jax_trace()


def P_MXNetError():
    return PKGS["port"].MXNetError
