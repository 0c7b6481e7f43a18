"""Shared pieces of the fleet parity tests (``test_torch_fleet.py``,
``test_torch_controlplane.py``): each scenario is one function of a
package namespace ``P`` (mxtpu's or the port's), run on both under the
same hand-stepped clock and fault plan, returning a record of what
happened that the test holds equal across the two."""
import types

import numpy as np

import mxtpu.base
import mxtpu.obs
import mxtpu.profiler
import mxtpu.serving
import mxtpu.serving.router
import mxtpu.symbol

import mxtpu_torch.base
import mxtpu_torch.obs
import mxtpu_torch.profiler
import mxtpu_torch.serving
import mxtpu_torch.serving.router
import mxtpu_torch.symbol


def _ns(sym, serving, router, obs, profiler, base, runner_kw):
    P = types.SimpleNamespace(**{n: getattr(serving, n)
                                 for n in serving.__all__})
    P.sym, P.obs, P.profiler = sym, obs, profiler
    P.MXNetError = base.MXNetError
    P.FleetRequest = router.FleetRequest
    P.runner_kw = runner_kw
    return P


PKGS = {
    "mxtpu": _ns(mxtpu.symbol, mxtpu.serving, mxtpu.serving.router,
                 mxtpu.obs, mxtpu.profiler, mxtpu.base, {}),
    "port": _ns(mxtpu_torch.symbol, mxtpu_torch.serving,
                mxtpu_torch.serving.router, mxtpu_torch.obs,
                mxtpu_torch.profiler, mxtpu_torch.base,
                {"device": "cpu"}),
}


class FakeClock:
    """Hand-stepped monotonic clock."""

    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def mul_runner(P, **kwargs):
    """out = data * w, per-row independent (padding detectable)."""
    data = P.sym.var("data")
    w = P.sym.var("w")
    return P.ModelRunner(data * w, {"w": np.array([1.0, 2.0, 3.0],
                                                  np.float32)},
                         {"data": (3,)}, max_batch_size=4,
                         **P.runner_kw, **kwargs)


def payload(v):
    return {"data": np.full(3, float(v), np.float32)}


def crank(router, clk, n=8, dt=0.05):
    for _ in range(n):
        clk.advance(dt)
        router.tick(clk())


def outcome(req):
    """A fleet request's end as plain data: its value (lists) or its
    error's class name, and the attempts it made."""
    out = {"tried": list(req.tried), "retries": req.retries,
           "requeues": req.requeues, "hedges": req.hedges,
           "won_by_hedge": req.won_by_hedge, "done": req.done(),
           "t_done": req.t_done}
    if req.done():
        try:
            out["value"] = [np.asarray(v).tolist()
                            for v in req.result(timeout=0)]
        except Exception as e:  # noqa: BLE001 — the error is the record
            out["error"] = type(e).__name__
    return out


def fleet_record(router, reqs=()):
    """What the parity tests compare: each request's outcome, the final
    worker states, the fleet counters, and the flight-recorder event
    kinds of the router and every worker, in order."""
    snap = router.fleet_stats()
    return {
        "requests": [outcome(r) for r in reqs],
        "workers": router.workers(),
        "counters": {k: snap[k] for k in ("completed", "timed_out",
                                          "rejected", "batches",
                                          "latency_ms", "pending",
                                          "healthy_workers",
                                          "total_workers")},
        "extras": dict(snap["extras"]),
        "reasons": {n: w["reason"] for n, w in snap["workers"].items()},
        "classes": snap["classes"],
        "router_events": [e["kind"] for e in router.recorder.events()],
        "worker_events": {w.name: [e["kind"] for e in
                                   w.recorder.events()]
                          for w in router.members()},
    }
