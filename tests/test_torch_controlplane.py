"""The fleet control plane of the port (``mxtpu_torch/serving/
controlplane.py`` and the router's admission, quotas and weighted
round-robin) against mxtpu's.

The 15 scenarios of ``tests/test_controlplane.py`` run on both packages
under the same ``FakeClock`` script (``SlowExec`` advances that clock,
so service-time histograms are exact): one parametrised test holds the
scale decisions and the ticks they fired at, the quota and admission
sheds, the weighted round-robin completion order and the retry-after
hints equal across the two, with each scenario asserting mxtpu's own
expectations on both.
"""
import numpy as np
import pytest

from tests.torch_fleet_helpers import (PKGS, FakeClock, crank,
                                       fleet_record, mul_runner, payload)


def _router(P, clk, **kw):
    return P.FleetRouter(clock=clk, threaded=False, canary=None, **kw)


def _worker(P, clk, name, **kw):
    kw.setdefault("max_queue_delay_us", 0.0)
    return P.FleetWorker(mul_runner(P), name, clock=clk, **kw)


def _want(i):
    return np.full(3, float(i)) * np.array([1.0, 2.0, 3.0])


def _raises(P, fn):
    """The exception class name ``fn`` raises (None if it returns)."""
    try:
        fn()
    except P.MXNetError as e:
        return type(e).__name__
    return None


# ----------------------------------------------------- priority classes

def sc_parse_classes(P):
    got = P.parse_classes("gold:8,bulk:1:64")
    assert [(c.name, c.weight, c.quota) for c in got] == \
        [("gold", 8.0, None), ("bulk", 1.0, 64)]
    return {"parsed": [(c.name, c.weight, c.quota) for c in got],
            "empty": P.parse_classes(""),
            "solo": repr(P.parse_classes("solo")[0]),
            "bad": [_raises(P, lambda: P.parse_classes("bad:notanumber")),
                    _raises(P, lambda: P.parse_classes("bad:2:1.5"))]}


def sc_priority_class_validation(P):
    out = [_raises(P, lambda: P.PriorityClass("")),
           _raises(P, lambda: P.PriorityClass("x", weight=0.0)),
           _raises(P, lambda: P.PriorityClass("x", quota=0))]
    assert out == ["MXNetError"] * 3
    return {"raised": out}


def sc_router_rejects_unknown_and_duplicate_classes(P):
    clk = FakeClock()
    dup = _raises(P, lambda: _router(
        P, clk, classes=[P.PriorityClass("a"), P.PriorityClass("a")]))
    r = _router(P, clk, classes=[P.PriorityClass("gold", 8.0),
                                 P.PriorityClass("bulk", 1.0)])
    r.add_worker(_worker(P, clk, "w0"))
    unknown = _raises(P, lambda: r.submit(payload(1),
                                          priority="platinum"))
    req = r.submit(payload(1))
    assert req.priority == "gold"
    r.close()
    return {"dup": dup, "unknown": unknown, "default": req.priority}


# ------------------------------------------------ queue ETA estimator

def sc_queue_eta_none_until_first_batch(P):
    st = P.ServingStats(clock=FakeClock())
    a = st.queue_eta_us()
    st.record_completion(500.0, 100.0)
    assert a is None and st.queue_eta_us() is None
    return {"eta": [a, st.queue_eta_us()]}


def sc_queue_eta_formula(P):
    st = P.ServingStats(clock=FakeClock())
    st.record_batch(4, 4)
    st.record_batch(4, 4)
    for _ in range(4):
        st.record_completion(1000.0, 200.0)
    st.record_queue_depth(8)
    assert st.queue_eta_us() == pytest.approx(2400.0)
    return {"eta": [st.queue_eta_us(), st.queue_eta_us(depth=0),
                    st.queue_eta_us(depth=4)]}


def sc_queue_eta_service_time_never_negative(P):
    st = P.ServingStats(clock=FakeClock())
    st.record_batch(1, 1)
    st.record_completion(100.0, 500.0)
    assert st.queue_eta_us(depth=0) == pytest.approx(0.0)
    return {"eta": st.queue_eta_us(depth=0)}


def sc_worker_refusal_carries_eta_hint(P):
    clk = FakeClock()
    w = _worker(P, clk, "w0", max_queue=2)
    w.stats.record_batch(4, 4)
    for _ in range(4):
        w.stats.record_completion(1000.0, 200.0)
    for i in range(2):
        w.submit_attempt(payload(i), (1, None), None, None, clk())
    with pytest.raises(P.ServerBusy) as ei:
        w.submit_attempt(payload(9), (1, None), None, None, clk())
    assert ei.value.retry_after_us == pytest.approx(1200.0)
    w.shutdown()
    return {"hint": ei.value.retry_after_us}


# ------------------------------------------- retry uses the ETA hint

def sc_retry_after_hint_replaces_exponential_backoff(P):
    clk = FakeClock()
    r = _router(P, clk, backoff_base_us=1000, backoff_cap_us=64000,
                jitter=0.2)
    r.add_worker(_worker(P, clk, "w0"))
    now = clk()

    def freq():
        return P.FleetRequest(payload(1), (1, None), None, now,
                              now + 5.0)

    def last_due():
        with r._lock:
            return r._pending[-1].due

    dues = []
    f1 = freq()
    f1.last_error = P.ServerBusy("full", retry_after_us=5000.0)
    with r._lock:
        r._park_locked(f1, now, now)
    dues.append(last_due())
    f2 = freq()
    f2.last_error = P.ServerBusy("full", retry_after_us=1e9)
    with r._lock:
        r._park_locked(f2, now, now)
    dues.append(last_due())
    f3 = freq()
    with r._lock:
        r._handle_attempt_failed_locked(
            f3, "w0", P.ServerBusy("x", retry_after_us=2000.0), now)
    dues.append(last_due())
    f4 = freq()
    with r._lock:
        r._handle_attempt_failed_locked(f4, "w0", P.ServerBusy("x"), now)
    dues.append(last_due())
    assert dues[0] == pytest.approx(now + 0.005)
    assert dues[1] == pytest.approx(now + 0.064)
    assert dues[2] == pytest.approx(now + 0.002)
    assert now + 0.001 <= dues[3] <= now + 0.00121
    r.close()
    return {"dues": dues, "retries": [f3.retries, f4.retries]}


# --------------------------------------------------- per-class quotas

def sc_quota_sheds_and_frees_on_completion(P):
    clk = FakeClock()
    r = _router(P, clk, classes=[P.PriorityClass("gold", 8.0),
                                 P.PriorityClass("bulk", 1.0, quota=2)])
    r.add_worker(_worker(P, clk, "w0"))
    b1 = r.submit(payload(1), priority="bulk")
    b2 = r.submit(payload(2), priority="bulk")
    with pytest.raises(P.ServerBusy) as ei:
        r.submit(payload(3), priority="bulk")
    g = r.submit(payload(4), priority="gold")
    before = fleet_record(r, [b1, b2, g])
    crank(r, clk, n=2)
    assert r.fleet_stats()["classes"]["bulk"]["in_system"] == 0
    b3 = r.submit(payload(5), priority="bulk")
    crank(r, clk, n=2)
    assert b3.done()
    rec = {"before": before, "after": fleet_record(r, [b1, b2, g, b3]),
           "hint": ei.value.retry_after_us}
    r.close()
    return rec


# ------------------------------------------------ scenario: burst-absorb

def sc_burst_absorb_scales_up_with_zero_cold_compiles(P):
    clk = FakeClock()
    r = _router(P, clk)
    w0 = P.FleetWorker(mul_runner(P), "w0", clock=clk,
                       max_queue_delay_us=0.0, max_queue=4)
    r.add_worker(w0)
    w0.runner.warmup()
    nbuckets = w0.runner.num_compiled()
    made = []

    def make_worker(name):
        w = P.FleetWorker(mul_runner(P), name, clock=clk,
                          max_queue_delay_us=0.0, max_queue=4)
        made.append(w)
        return w

    scaler = P.Autoscaler(r, make_worker, min_workers=1, max_workers=3,
                          up_depth=3.0, down_depth=0.5, breach_ticks=2,
                          cooldown_s=0.2)
    r.add_controller(scaler.tick)
    reqs = [r.submit(payload(i), timeout_s=30.0) for i in range(24)]
    for _ in range(20):
        clk.advance(0.05)
        r.tick(clk())
        if made:
            break
    assert made and made[0].runner.num_compiled() == nbuckets
    crank(r, clk, n=20)
    for i, req in enumerate(reqs):
        np.testing.assert_allclose(req.result(timeout=0)[0], _want(i),
                                   rtol=1e-5)
    for w in [w0] + made:
        assert w.runner.num_compiled() == nbuckets
    assert scaler.snapshot()["scale_ups"] == len(made) >= 1
    rec = {"fleet": fleet_record(r, reqs),
           "scaler": scaler.snapshot(),
           "decisions": scaler.recorder.events(),
           "made": [w.name for w in made]}
    r.close()
    return rec


# ------------------------------------- scenario: scale-down-then-burst

def sc_scale_down_drains_then_burst_rewarms_from_last_handoff(P):
    clk = FakeClock()
    r = _router(P, clk)
    w0 = _worker(P, clk, "w0")
    w1 = _worker(P, clk, "w1")
    for w in (w0, w1):
        r.add_worker(w)
        w.runner.warmup()
    nbuckets = w0.runner.num_compiled()
    made = []

    def make_worker(name):
        w = _worker(P, clk, name)
        made.append(w)
        return w

    scaler = P.Autoscaler(r, make_worker, min_workers=1, max_workers=2,
                          up_depth=3.0, down_depth=0.5, breach_ticks=2,
                          cooldown_s=0.1)
    r.add_controller(scaler.tick)
    reqs = [r.submit(payload(i), timeout_s=10.0) for i in range(4)]
    for _ in range(20):
        clk.advance(0.05)
        r.tick(clk())
        if scaler.snapshot()["scale_downs"] == 1:
            break
    crank(r, clk, n=2)
    retired = [w for w in (w0, w1) if w.health.retired]
    assert len(retired) == 1 and retired[0].outstanding() == 0
    mid = fleet_record(r, reqs)
    survivor = w0 if retired[0] is w1 else w1
    r.kill(survivor.name)
    for _ in range(20):
        clk.advance(0.05)
        r.tick(clk())
        if made:
            break
    assert made and made[0].runner.num_compiled() == nbuckets
    reqs2 = [r.submit(payload(10 + i), timeout_s=10.0) for i in range(6)]
    crank(r, clk, n=6)
    for i, req in enumerate(reqs2):
        np.testing.assert_allclose(req.result(timeout=0)[0],
                                   _want(10 + i), rtol=1e-5)
    rec = {"mid": mid, "fleet": fleet_record(r, reqs + reqs2),
           "retired": retired[0].name, "scaler": scaler.snapshot(),
           "decisions": scaler.recorder.events(),
           "made": [w.name for w in made]}
    r.close()
    return rec


# ----------------------------------------------- scenario: brownout-shed

def sc_brownout_sheds_strictly_low_priority_first(P):
    clk = FakeClock()
    r = _router(P, clk, classes=[P.PriorityClass("gold", 8.0),
                                 P.PriorityClass("bulk", 1.0)],
                admission=True, admission_margin=3.0)
    w = P.FleetWorker(mul_runner(P), "w0", clock=clk,
                      max_queue_delay_us=0.0,
                      faults=P.FaultPlan(P.SlowExec(0.1, clk.advance)))
    r.add_worker(w)
    prime = [r.submit(payload(i)) for i in range(4)]
    crank(r, clk, n=1, dt=0.01)
    assert w.stats.queue_eta_us(depth=0) == pytest.approx(1e5)
    admitted, shed = [], []
    for i in range(16):
        cls = "gold" if i % 2 == 0 else "bulk"
        try:
            admitted.append(r.submit(payload(i), timeout_s=1.2,
                                     priority=cls))
        except P.ServerBusy as e:
            shed.append((i, cls, e.retry_after_us))
    assert [(i, c) for i, c, _ in shed] == [(13, "bulk"), (15, "bulk")]
    crank(r, clk, n=4, dt=0.01)
    for req in admitted:
        assert req.t_done <= req.deadline
    rec = {"fleet": fleet_record(r, prime + admitted), "shed": shed,
           "router_sheds": r.recorder.events()}
    r.close()
    return rec


# --------------------------------------------- starvation regression

def sc_wrr_prevents_starvation_of_low_rate_tenant(P):
    clk = FakeClock()
    r = _router(P, clk, classes=[P.PriorityClass("hot", 1.0),
                                 P.PriorityClass("lo", 1.0)])
    r.add_worker(P.FleetWorker(mul_runner(P), "w0", clock=clk,
                               max_queue_delay_us=0.0, max_queue=4))
    hot = [r.submit(payload(i), timeout_s=30.0, priority="hot")
           for i in range(20)]
    lo = [r.submit(payload(100 + i), timeout_s=30.0, priority="lo")
          for i in range(2)]
    crank(r, clk, n=10)
    lo_done = max(q.t_done for q in lo)
    assert sum(1 for q in hot if q.t_done > lo_done) >= 12
    order = sorted(range(22), key=lambda k: ((hot + lo)[k].t_done, k))
    rec = {"fleet": fleet_record(r, hot + lo), "order": order}
    r.close()
    return rec


# ------------------------------------------------- autoscaler plumbing

def sc_autoscaler_validates_bounds(P):
    clk = FakeClock()
    r = _router(P, clk)
    r.add_worker(_worker(P, clk, "w0"))
    out = [_raises(P, lambda: P.Autoscaler(r, lambda n: None,
                                           min_workers=0, max_workers=2)),
           _raises(P, lambda: P.Autoscaler(r, lambda n: None,
                                           min_workers=3, max_workers=2))]
    assert out == ["MXNetError"] * 2
    r.close()
    return {"raised": out}


def sc_autoscaler_respects_cooldown_and_max(P):
    clk = FakeClock()
    r = _router(P, clk)
    r.add_worker(P.FleetWorker(mul_runner(P), "w0", clock=clk,
                               max_queue_delay_us=0.0, max_queue=4))
    made = []

    def make_worker(name):
        w = P.FleetWorker(mul_runner(P), name, clock=clk,
                          max_queue_delay_us=0.0, max_queue=4)
        made.append(w)
        return w

    scaler = P.Autoscaler(r, make_worker, min_workers=1, max_workers=2,
                          up_depth=1.0, breach_ticks=1, cooldown_s=10.0)
    reqs = [r.submit(payload(i), timeout_s=60.0) for i in range(30)]
    for _ in range(6):
        clk.advance(0.05)
        r.tick(clk())
        scaler.tick(clk())
    assert len(made) == 1
    clk.advance(11.0)
    r.tick(clk())
    scaler.tick(clk())
    assert len(made) <= 2 <= 1 + scaler.max_workers
    crank(r, clk, n=12)
    assert all(q.done() for q in reqs)
    rec = {"fleet": fleet_record(r, reqs), "scaler": scaler.snapshot(),
           "decisions": scaler.recorder.events(),
           "made": [w.name for w in made]}
    r.close()
    return rec


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_parse_classes, sc_priority_class_validation,
    sc_router_rejects_unknown_and_duplicate_classes,
    sc_queue_eta_none_until_first_batch, sc_queue_eta_formula,
    sc_queue_eta_service_time_never_negative,
    sc_worker_refusal_carries_eta_hint,
    sc_retry_after_hint_replaces_exponential_backoff,
    sc_quota_sheds_and_frees_on_completion,
    sc_burst_absorb_scales_up_with_zero_cold_compiles,
    sc_scale_down_drains_then_burst_rewarms_from_last_handoff,
    sc_brownout_sheds_strictly_low_priority_first,
    sc_wrr_prevents_starvation_of_low_rate_tenant,
    sc_autoscaler_validates_bounds,
    sc_autoscaler_respects_cooldown_and_max)}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_controlplane_scenario_matches_mxtpu(name):
    recs = {}
    for pkg, P in PKGS.items():
        P.obs.reset()   # flight recorders are process-wide, by name
        recs[pkg] = SCENARIOS[name](P)
    assert recs["port"] == recs["mxtpu"]
