"""Debug HTTP endpoints over the obs stack.

A stdlib ``http.server`` on a daemon thread — no new dependencies, no
effect on the serving data path — that turns the in-process surfaces
into live operator endpoints:

=============  ========================================================
``/metrics``   Prometheus text exposition of the process registry
               (what a scraper ingests; parseable back by
               :func:`.metrics.parse_prometheus_text`)
``/varz``      the JSON registry snapshot (same sample values)
``/healthz``   liveness + fleet health roll-up (200 ``ok`` while any
               worker admits, ``degraded`` otherwise)
``/statusz``   the operator page: fleet health states, the
               SLO/error-budget table (:meth:`.slo.SLOEngine
               .snapshot`), sampler stats and the most recent flight-
               recorder events
``/tracez``    one request's reconstructed timeline by trace id
               (``/tracez?id=<trace_id>`` -> ``obs.trace_of``)
=============  ========================================================

Rendering is factored into pure ``render_*`` functions so
``obs.self_check()`` exercises every page without binding a socket.
``MXTPU_OBS_HTTP_PORT`` picks the port (-1 = never serve, 0 =
ephemeral — tests read the bound port back from ``server.port``).
The server binds loopback by default: these pages are diagnostics,
not a public API.

Lifecycle: the serve loop runs on one daemon thread and each request
on a daemon handler thread (``ThreadingHTTPServer.daemon_threads``);
``close()`` shuts the loop down, closes the socket and joins the
thread — the conftest thread-leak fixture sees nothing left behind.
Zero-overhead contract: ``obs.debug_server()`` returns the shared
:data:`NULL_SERVER` when obs is off (asserted by
``obs.self_check()``).
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional
from urllib.parse import parse_qs, urlparse

__all__ = ["DebugServer", "NULL_SERVER", "render_metrics",
           "render_varz", "render_healthz", "render_statusz",
           "render_tracez"]

_FLIGHT_TAIL = 20       # last events per recorder on /statusz


# -- pure renderers (self_check runs these with no socket) --------------
def render_metrics(registry=None) -> str:
    if registry is None:
        from .. import obs as _obs
        registry = _obs.registry()
    return registry.prometheus_text()


def render_varz(registry=None) -> str:
    if registry is None:
        from .. import obs as _obs
        registry = _obs.registry()
    return json.dumps(registry.snapshot(), indent=2, default=str)


def render_healthz(router=None) -> str:
    """Liveness + fleet roll-up: ``ok`` while some worker is healthy
    (or there is no fleet to judge), ``degraded`` otherwise."""
    doc: Dict[str, Any] = {"status": "ok"}
    if router is not None:
        workers = router.workers()
        doc["workers"] = workers
        if workers and not any(s == "healthy"
                               for s in workers.values()):
            doc["status"] = "degraded"
    return json.dumps(doc, default=str)


def render_statusz(router=None, slo=None, sampler=None,
                   recorders: Optional[Dict[str, Any]] = None) -> str:
    """The operator page: fleet health + SLO/error-budget table +
    last flight events, as one JSON document."""
    if recorders is None:
        from .. import obs as _obs
        recorders = _obs.flight_recorders()
    doc: Dict[str, Any] = {
        "workers": router.workers() if router is not None else {},
        "fleet": router.fleet_stats() if router is not None else None,
        "slo": slo.snapshot() if slo is not None else None,
        "sampler": sampler.summary() if sampler is not None else None,
        "flight": {name: rec.events()[-_FLIGHT_TAIL:]
                   for name, rec in sorted(recorders.items())},
    }
    return json.dumps(doc, default=str)


def render_tracez(trace_id: str) -> str:
    from .trace import trace_of
    return json.dumps(trace_of(trace_id), default=str)


class DebugServer:
    """Daemon-thread HTTP server over one router/SLO-engine/sampler
    trio.  Construct via ``obs.debug_server(...)`` (the factory owns
    the on/off gate); the caller owns ``close()``.

    >>> srv = obs.debug_server(port=0, router=router, slo=engine)
    >>> urllib.request.urlopen(f"{srv.url}/statusz")
    >>> srv.close()
    """

    def __init__(self, *, port: int = 0, host: str = "127.0.0.1",
                 router=None, slo=None, sampler=None):
        self.router = router
        self.slo = slo
        self.sampler = sampler
        self._lock = threading.Lock()
        self._closed = False            # guarded-by: _lock
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            # diagnostics must never spam the serving process's stderr
            def log_message(self, fmt: str, *args: Any) -> None:
                pass

            def do_GET(self) -> None:  # noqa: N802 (stdlib API name)
                try:
                    url = urlparse(self.path)
                    route = _ROUTES.get(url.path)
                    if route is None:
                        self._reply(404, "text/plain",
                                    f"no such page {url.path!r}; "
                                    f"have {sorted(_ROUTES)}")
                        return
                    ctype, body = route(outer, parse_qs(url.query))
                    self._reply(200, ctype, body)
                except _BadRequest as e:
                    self._reply(400, "text/plain", str(e))
                except Exception as e:  # noqa: BLE001 — a debug page
                    # must never kill the handler thread
                    self._reply(500, "text/plain",
                                f"render failed: {e}")

            def _reply(self, code: int, ctype: str,
                       body: str) -> None:
                raw = body.encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type",
                                 f"{ctype}; charset=utf-8")
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.05},
            daemon=True, name="mxtpu-obs-http")
        self._thread.start()

    @property
    def enabled(self) -> bool:
        return True

    @property
    def port(self) -> Optional[int]:
        return self._httpd.server_address[1]

    @property
    def url(self) -> Optional[str]:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def close(self) -> None:
        """Stop serving, close the socket, join the thread.
        Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=2.0)


class _BadRequest(Exception):
    pass


def _page_metrics(srv: "DebugServer", q) -> tuple:
    return ("text/plain", render_metrics())


def _page_varz(srv: "DebugServer", q) -> tuple:
    return ("application/json", render_varz())


def _page_healthz(srv: "DebugServer", q) -> tuple:
    return ("application/json", render_healthz(srv.router))


def _page_statusz(srv: "DebugServer", q) -> tuple:
    return ("application/json",
            render_statusz(srv.router, srv.slo, srv.sampler))


def _page_tracez(srv: "DebugServer", q) -> tuple:
    ids = q.get("id")
    if not ids or not ids[0]:
        raise _BadRequest("tracez needs ?id=<trace_id>")
    return ("application/json", render_tracez(ids[0]))


_ROUTES: Dict[str, Callable] = {
    "/metrics": _page_metrics,
    "/varz": _page_varz,
    "/healthz": _page_healthz,
    "/statusz": _page_statusz,
    "/tracez": _page_tracez,
}


class _NullServer:
    """Shared no-op server behind ``MXTPU_OBS=0`` (or a disabled
    port): nothing is bound, ``close()`` is free
    (``obs.self_check()`` asserts identity)."""

    __slots__ = ()
    enabled = False
    port: Optional[int] = None
    url: Optional[str] = None
    router = None
    slo = None
    sampler = None

    def close(self) -> None:
        pass


NULL_SERVER = _NullServer()
