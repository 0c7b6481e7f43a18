"""The serving fleet of the port (``mxtpu_torch/serving/router.py``,
``health.py``, ``faults.py``) against mxtpu's.

Every deterministic scenario of ``tests/test_fleet.py`` runs on both
packages under the same ``FakeClock`` script and ``FaultPlan``, each
worker a ``ModelRunner`` over ``_mul_runner``'s graph (``data * w``;
mxtpu's jitted on the CPU, the port's graph plan on the CPU).  One
parametrised test holds, scenario by scenario, each request's result
and ``tried`` list, the final worker states, the ``fleet_stats()``
counters and the flight recorders' event kinds, in order, equal across
the two; each scenario also asserts mxtpu's own expectations on both.
The threaded smoke with a kill runs on the port alone.
"""
import numpy as np
import pytest

from tests.torch_fleet_helpers import (PKGS, FakeClock, crank,
                                       fleet_record, mul_runner, payload)

CANARY_IN = {"data": np.ones(3, np.float32)}
CANARY_OUT = [np.array([1.0, 2.0, 3.0], np.float32)]


def _router(P, clk, canary=True, **kw):
    kw.setdefault("canary_interval_s", 1.0)
    kw.setdefault("canary_timeout_s", 0.5)
    return P.FleetRouter(clock=clk, threaded=False,
                         canary=CANARY_IN if canary else None,
                         canary_expect=CANARY_OUT if canary else None,
                         **kw)


def _worker(P, clk, name, **kw):
    kw.setdefault("max_queue_delay_us", 0.0)
    return P.FleetWorker(mul_runner(P), name, clock=clk, **kw)


def _health_trace(h):
    return (h.state, h.reason, h.failures, h.admits(), h.admits_canary(),
            h.retired)


# ---------------------------------------------------------- health machine

def sc_health_canary_cycle(P):
    h = P.WorkerHealth("w", dead_after=3)
    out = [_health_trace(h)]
    h.canary_fail(1.0)
    out.append(_health_trace(h))
    assert h.state == P.WorkerState.SUSPECT
    h.canary_ok(2.0)
    out.append(_health_trace(h))
    assert h.state == P.WorkerState.HEALTHY and h.failures == 0
    return {"trace": out, "transitions": list(h.transitions)}


def sc_health_dead_after(P):
    h = P.WorkerHealth("w", dead_after=3)
    out = []
    for t in (1.0, 2.0, 3.0):
        h.canary_fail(t)
        out.append(_health_trace(h))
    assert h.state == P.WorkerState.DEAD
    h.canary_ok(4.0)
    out.append(_health_trace(h))
    h.recover(5.0)
    out.append(_health_trace(h))
    assert h.state == P.WorkerState.RECOVERING and not h.admits()
    h.canary_ok(6.0)
    out.append(_health_trace(h))
    assert h.state == P.WorkerState.HEALTHY
    return {"trace": out, "transitions": list(h.transitions)}


def sc_health_recovering(P):
    h = P.WorkerHealth("w", dead_after=2, start_recovering=True)
    out = [_health_trace(h)]
    for t in range(10):
        h.canary_fail(float(t))
        out.append(_health_trace(h))
    assert h.state == P.WorkerState.RECOVERING
    h.canary_ok(11.0)
    out.append(_health_trace(h))
    assert h.state == P.WorkerState.HEALTHY
    return {"trace": out, "transitions": list(h.transitions)}


def sc_health_exec_signals(P):
    h = P.WorkerHealth("w")
    h.exec_fail(1.0)
    h.exec_ok(2.0)
    assert h.state == P.WorkerState.SUSPECT
    h2 = P.WorkerHealth("w2", exec_recovers=True, dead_after=2)
    h2.exec_fail(1.0)
    a = _health_trace(h2)
    h2.exec_ok(2.0)
    assert h2.state == P.WorkerState.HEALTHY
    return {"trace": [_health_trace(h), a, _health_trace(h2)],
            "transitions": [list(h.transitions), list(h2.transitions)]}


def sc_health_liveness(P):
    h = P.WorkerHealth("w", liveness_s=2.0)
    out = []
    for now, inflight in ((1.0, 1.0), (2.0, 2.5), (3.0, 4.5)):
        h.liveness(now, inflight, None)
        out.append(_health_trace(h))
    assert h.state == P.WorkerState.DEAD
    h2 = P.WorkerHealth("w2", liveness_s=2.0)
    h2.liveness(1.0, None, 5.0)
    out.append(_health_trace(h2))
    assert h2.state == P.WorkerState.DEAD and "wedge" in h2.reason
    return {"trace": out, "transitions": [list(h.transitions),
                                          list(h2.transitions)]}


def sc_health_drain(P):
    h = P.WorkerHealth("w")
    h.drain(1.0)
    a = _health_trace(h)
    h.drained(2.0)
    snap = h.snapshot()
    assert snap["retired"] and snap["state"] == "dead"
    return {"trace": [a, _health_trace(h)], "snapshot": snap}


# ---------------------------------------------------------- fault scripts

def sc_fault_plan_scripting(P):
    plan = P.FaultPlan(P.CrashAt(at_batch=2), P.Corrupt(from_batch=5))
    plan.before_batch(0)
    with pytest.raises(P.WorkerCrashed):
        plan.before_batch(2)
    early = plan.mutator(3)
    early_out = early([np.array([1.0, 2.0], np.float32)])[0].tolist()
    out = plan.mutator(6)([np.array([1.0, 2.0], np.float32)])[0]
    assert not np.allclose(out, [1.0, 2.0])
    wedge = P.FaultPlan(P.QueueWedge(after_batches=1))
    return {"fired": list(plan.fired), "early": early_out,
            "corrupt": out.tolist(), "wedged": [plan.wedged(0),
                                                wedge.wedged(0),
                                                wedge.wedged(1)],
            "wedge_fired": list(wedge.fired)}


def sc_error_taxonomy(P):
    assert issubclass(P.RequestTimeout, P.RetriableError)
    assert issubclass(P.RetriableError, P.MXNetError)
    return {n: ([c.__name__ for c in getattr(P, n).__mro__[:3]],
                getattr(P, n)("x").retriable)
            for n in ("ServerBusy", "WorkerLost", "RequestTimeout",
                      "RetriableError")}


# ------------------------------------------------------- router scenarios

def sc_happy_path_round_robin(P):
    clk = FakeClock()
    with _router(P, clk) as router:
        router.add_worker(_worker(P, clk, "w0"))
        router.add_worker(_worker(P, clk, "w1"))
        reqs = [router.submit(payload(i), timeout_s=5.0)
                for i in range(4)]
        crank(router, clk, n=3)
        for i, r in enumerate(reqs):
            np.testing.assert_allclose(r.result(timeout=0)[0],
                                       [i, 2.0 * i, 3.0 * i])
        assert {r.tried[0] for r in reqs} == {"w0", "w1"}
        return fleet_record(router, reqs)


def sc_crash_requeues_never_drops(P):
    clk = FakeClock()
    with _router(P, clk) as router:
        router.add_worker(_worker(P, clk, "w0"))
        router.add_worker(_worker(
            P, clk, "w1", faults=P.FaultPlan(P.CrashAt(at_batch=0))))
        reqs = [router.submit(payload(i), timeout_s=10.0)
                for i in range(4)]
        crank(router, clk)
        assert router.workers()["w1"] == "dead"
        assert sum(1 for r in reqs if r.requeues) == 2
        return fleet_record(router, reqs)


def sc_hang_detected_by_liveness(P):
    clk = FakeClock()
    with _router(P, clk, canary=False) as router:
        router.add_worker(_worker(P, clk, "w0",
                                  faults=P.FaultPlan(P.Hang(at_batch=0)),
                                  liveness_s=0.1))
        router.add_worker(_worker(P, clk, "w1", liveness_s=0.1))
        reqs = [router.submit(payload(i), timeout_s=10.0)
                for i in range(2)]
        router.tick(clk())
        hung = [r for r in reqs if r.tried[0] == "w0"]
        assert len(hung) == 1 and not hung[0].done()
        crank(router, clk, n=8, dt=0.05)
        assert router.workers()["w0"] == "dead"
        assert hung[0].requeues == 1
        return fleet_record(router, reqs)


def sc_queue_wedge_detected_by_liveness(P):
    clk = FakeClock()
    with _router(P, clk, canary=False) as router:
        router.add_worker(_worker(
            P, clk, "w0", faults=P.FaultPlan(P.QueueWedge(after_batches=0)),
            liveness_s=0.1))
        router.add_worker(_worker(P, clk, "w1", liveness_s=0.1))
        reqs = [router.submit(payload(i), timeout_s=10.0)
                for i in range(2)]
        crank(router, clk, n=8, dt=0.05)
        assert router.workers()["w0"] == "dead"
        return fleet_record(router, reqs)


def sc_corruption_caught_by_canary(P):
    clk = FakeClock()
    with _router(P, clk) as router:
        router.add_worker(_worker(
            P, clk, "w0", dead_after=3,
            faults=P.FaultPlan(P.Corrupt(from_batch=0))))
        crank(router, clk, n=10, dt=1.1)
        assert router.workers()["w0"] == "dead"
        return fleet_record(router)


def sc_slow_start_recovers_via_canary(P):
    clk = FakeClock()
    with _router(P, clk) as router:
        router.add_worker(_worker(P, clk, "w0"))
        router.add_worker(_worker(
            P, clk, "w1", start_recovering=True,
            faults=P.FaultPlan(P.SlowStart(first_n=2))))
        req = router.submit(payload(5), timeout_s=10.0)
        router.tick(clk())
        assert req.tried == ["w0"]
        crank(router, clk, n=6, dt=1.1)
        assert router.workers()["w1"] == "healthy"
        reqs = [router.submit(payload(i), timeout_s=10.0)
                for i in range(4)]
        crank(router, clk, n=2)
        assert {r.tried[0] for r in reqs} == {"w0", "w1"}
        return fleet_record(router, [req] + reqs)


def sc_drain_handoff_warm_replacement(P):
    clk = FakeClock()
    with _router(P, clk) as router:
        w0 = _worker(P, clk, "w0")
        router.add_worker(w0)
        reqs = [router.submit(payload(i), timeout_s=10.0)
                for i in range(3)]
        crank(router, clk, n=2)
        meta = router.drain("w0")
        assert meta["compiled_buckets"]
        crank(router, clk, n=2)
        assert router.workers()["w0"] == "dead"
        w2 = _worker(P, clk, "w2")
        warmed = router.add_worker(w2, warm_from=meta)
        assert w2.runner.num_compiled() >= len(meta["compiled_buckets"])
        req = router.submit(payload(7), timeout_s=10.0)
        crank(router, clk, n=2)
        assert req.tried == ["w2"]
        rec = fleet_record(router, reqs + [req])
        rec["handoff"] = {k: meta[k] for k in ("max_batch_size",
                                               "seq_buckets",
                                               "compiled_buckets")}
        rec["warmed"] = warmed
        rec["replacement_compiled"] = w2.runner.num_compiled()
        return rec


def sc_kill_steals_outstanding(P):
    clk = FakeClock()
    with _router(P, clk, canary=False) as router:
        router.add_worker(_worker(P, clk, "w0"))
        router.add_worker(_worker(P, clk, "w1"))
        reqs = [router.submit(payload(i), timeout_s=10.0)
                for i in range(4)]
        router.kill("w0")
        crank(router, clk, n=4)
        assert all(r.tried[-1] == "w1" for r in reqs)
        return fleet_record(router, reqs)


def sc_backoff_deterministic_and_capped(P):
    clk = FakeClock()
    r1 = _router(P, clk, canary=False, seed=7, backoff_base_us=1000,
                 backoff_cap_us=64000, jitter=0.2)
    r2 = _router(P, clk, canary=False, seed=7, backoff_base_us=1000,
                 backoff_cap_us=64000, jitter=0.2)
    seq1 = [r1._backoff_s(n) for n in range(1, 10)]
    seq2 = [r2._backoff_s(n) for n in range(1, 10)]
    assert seq1 == seq2
    assert all(b <= 64000 * 1.2 / 1e6 for b in seq1)
    r1.close()
    r2.close()
    return {"backoff": seq1}


def sc_retry_exhaustion(P):
    clk = FakeClock()
    with _router(P, clk, canary=False, retry_max=1,
                 backoff_base_us=100) as router:
        for name in ("w0", "w1"):
            router.add_worker(_worker(
                P, clk, name,
                faults=P.FaultPlan(*[P.CrashAt(at_batch=k)
                                     for k in range(8)])))
        req = router.submit(payload(1), timeout_s=50.0)
        crank(router, clk, n=6)
        assert req.done() and req.retries == 1
        with pytest.raises(P.WorkerLost):
            req.result(timeout=0)
        return fleet_record(router, [req])


def sc_deadline_expiry_is_timeout(P):
    clk = FakeClock()
    with _router(P, clk, canary=False) as router:
        router.add_worker(_worker(
            P, clk, "w0", faults=P.FaultPlan(P.QueueWedge(after_batches=0)),
            liveness_s=50.0))
        req = router.submit(payload(1), timeout_s=0.2)
        crank(router, clk, n=8, dt=0.1)
        with pytest.raises(P.RequestTimeout):
            req.result(timeout=0)
        return fleet_record(router, [req])


def sc_pending_buffer_sheds(P):
    clk = FakeClock()
    with _router(P, clk, canary=False, max_pending=2) as router:
        router.add_worker(_worker(P, clk, "w0", start_recovering=True))
        reqs = [router.submit(payload(0), timeout_s=5.0),
                router.submit(payload(1), timeout_s=5.0)]
        with pytest.raises(P.ServerBusy) as ei:
            router.submit(payload(2), timeout_s=5.0)
        rec = fleet_record(router, reqs)
        rec["shed"] = (type(ei.value).__name__, ei.value.retry_after_us)
        return rec


def sc_hedged_request_wins_elsewhere(P):
    clk = FakeClock()
    with _router(P, clk, canary=False, hedge_after_us=100) as router:
        router.add_worker(_worker(
            P, clk, "w0", faults=P.FaultPlan(P.QueueWedge(after_batches=0)),
            liveness_s=100.0))
        router.add_worker(_worker(P, clk, "w1", liveness_s=100.0))
        reqs = [router.submit(payload(2), timeout_s=10.0)]
        while reqs[-1].tried[:1] != ["w0"]:
            reqs.append(router.submit(payload(2), timeout_s=10.0))
        req = reqs[-1]
        router.tick(clk())
        assert not req.done()
        crank(router, clk, n=3, dt=0.01)
        assert req.won_by_hedge and req.hedges == 1
        assert router.fleet_stats()["extras"]["hedges_won"] == 1
        return fleet_record(router, reqs)


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_health_canary_cycle, sc_health_dead_after, sc_health_recovering,
    sc_health_exec_signals, sc_health_liveness, sc_health_drain,
    sc_fault_plan_scripting, sc_error_taxonomy,
    sc_happy_path_round_robin, sc_crash_requeues_never_drops,
    sc_hang_detected_by_liveness, sc_queue_wedge_detected_by_liveness,
    sc_corruption_caught_by_canary, sc_slow_start_recovers_via_canary,
    sc_drain_handoff_warm_replacement, sc_kill_steals_outstanding,
    sc_backoff_deterministic_and_capped, sc_retry_exhaustion,
    sc_deadline_expiry_is_timeout, sc_pending_buffer_sheds,
    sc_hedged_request_wins_elsewhere)}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_fleet_scenario_matches_mxtpu(name):
    recs = {}
    for pkg, P in PKGS.items():
        P.obs.reset()   # flight recorders are process-wide, by name
        recs[pkg] = SCENARIOS[name](P)
    assert recs["port"] == recs["mxtpu"]


def test_fleet_threaded_smoke_with_kill():
    """Real threads and time on the port alone: a kill mid-traffic, and
    nobody hangs, nobody drops."""
    P = PKGS["port"]
    router = P.FleetRouter(threaded=True, tick_s=0.002,
                           canary=CANARY_IN, canary_expect=CANARY_OUT,
                           canary_interval_s=0.05, canary_timeout_s=1.0)
    with router:
        router.add_worker(P.FleetWorker(mul_runner(P), "w0",
                                        max_queue_delay_us=500.0))
        router.add_worker(P.FleetWorker(mul_runner(P), "w1",
                                        max_queue_delay_us=500.0))
        reqs = [router.submit(payload(i % 5), timeout_s=10.0)
                for i in range(8)]
        router.kill("w0")
        reqs += [router.submit(payload(i % 5), timeout_s=10.0)
                 for i in range(8, 16)]
        for i, r in enumerate(reqs):
            v = i % 5
            np.testing.assert_allclose(r.result(timeout=10.0)[0],
                                       [v, 2.0 * v, 3.0 * v])
        snap = router.fleet_stats()
        assert snap["workers"]["w0"]["state"] == "dead"
        assert snap["workers"]["w1"]["state"] == "healthy"
        assert snap["completed"] == 16


def test_replacement_warmed_from_donor_builds_nothing_cold():
    """A replacement attached with a donor's handoff builds the donor's
    buckets as "donor" entries and serves them with no cold build."""
    P = PKGS["port"]
    clk = FakeClock()
    with _router(P, clk, canary=False) as router:
        w0 = _worker(P, clk, "w0")
        router.add_worker(w0)
        w0.runner.warmup()
        assert w0.runner.cold_compiles() == w0.runner.num_compiled()
        w1 = _worker(P, clk, "w1")
        assert router.add_worker(w1, warm_from=w0.handoff()) == "donor"
        router.kill("w0")
        reqs = [router.submit(payload(i), timeout_s=10.0)
                for i in range(7)]
        crank(router, clk, n=4)
        assert all(r.tried == ["w1"] for r in reqs)
        assert w1.runner.cold_compiles() == 0
        assert set(w1.runner.compile_sources().values()) == {"donor"}
        assert w1.runner.cached_buckets() == []
        assert w1.runner.warm_from_disk() == {}
