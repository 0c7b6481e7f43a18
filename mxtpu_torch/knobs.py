"""Registry of the ``MXTPU_*`` environment knobs this package reads.

Same names, types and defaults as ``mxtpu/knobs.py``, restricted to the
knobs the ported paths consume.  :func:`get` reads
``os.environ`` live, with the reference's ``MXNET_*`` spelling as a
fallback.
"""
from __future__ import annotations

import os
from typing import Any, Dict, NamedTuple

from .base import MXNetError

__all__ = ["Knob", "register", "get"]

_TRUTHY = {"1", "true", "yes", "on"}
_FALSY = {"0", "false", "no", "off", ""}


class Knob(NamedTuple):
    name: str
    default: Any
    kind: str          # "bool" | "int" | "float" | "str"
    doc: str
    group: str


_REGISTRY: Dict[str, Knob] = {}
_MISSING = object()


def register(name: str, default: Any, kind: str = "str", doc: str = "",
             group: str = "misc") -> Knob:
    if kind not in ("bool", "int", "float", "str"):
        raise MXNetError(f"knob {name}: unknown kind {kind!r}")
    if not name.startswith("MXTPU_"):
        raise MXNetError(f"knob {name!r} must be MXTPU_-prefixed")
    if name in _REGISTRY:
        raise MXNetError(f"knob {name} registered twice")
    knob = Knob(name, default, kind, doc, group)
    _REGISTRY[name] = knob
    return knob


def _coerce(knob: Knob, raw: str) -> Any:
    if knob.kind == "bool":
        low = raw.strip().lower()
        if low in _TRUTHY:
            return True
        if low in _FALSY:
            return False
        raise MXNetError(f"invalid boolean value {knob.name}={raw!r}")
    if knob.kind == "int":
        return int(raw)
    if knob.kind == "float":
        return float(raw)
    return raw


def get(name: str, default: Any = _MISSING) -> Any:
    """Typed live read of a registered knob.  The environment always
    wins; otherwise ``default`` (when given) overrides the registered
    default."""
    knob = _REGISTRY.get(name)
    if knob is None:
        raise MXNetError(f"unregistered knob {name!r}")
    raw = os.environ.get(name)
    if raw is None:
        raw = os.environ.get("MXNET_" + name[len("MXTPU_"):])
    if raw is None:
        return knob.default if default is _MISSING else default
    return _coerce(knob, raw)


# -- serving -----------------------------------------------------------
register("MXTPU_SERVING_MAX_BATCH", 32, "int",
         "ModelRunner bucket-ladder cap (pow2 rungs up to this).",
         "serving")
register("MXTPU_SERVING_MAX_DELAY_US", 2000.0, "float",
         "DynamicBatcher assembly window in microseconds.", "serving")
register("MXTPU_SERVING_MAX_QUEUE", 0, "int",
         "Bound on queued requests before ServerBusy shedding "
         "(0/unset = 8x max batch).", "serving")
register("MXTPU_SERVING_DONATE", True, "bool",
         "GenerateRunner updates the KV table passed in place (off: a "
         "new table is returned and the old one stays intact).",
         "serving")
register("MXTPU_GEN_MAX_LANES", 8, "int",
         "KV-cache lanes per GenerateRunner: the continuous-batching "
         "decode width (one in-flight generation per lane).",
         "serving")
register("MXTPU_GEN_MAX_TOKENS", 64, "int",
         "Default per-request generation cap when submit passes no "
         "max_tokens.", "serving")
register("MXTPU_GEN_STREAM", True, "bool",
         "Stream tokens through the incremental result channel as "
         "they decode (off = deliver only the final sequence).",
         "serving")

# -- guards --------------------------------------------------------------
register("MXTPU_GUARDS", "", "str",
         "Runtime guard rails (mxtpu_torch.guards): `1` warn on "
         "recompile churn and run ModelRunner/GenerateRunner dispatch "
         "under torch.cuda.set_sync_debug_mode('error'); `2` raise "
         "instead of warn; unset/`0` = off with zero overhead.",
         "guards")
register("MXTPU_GUARDS_CHURN_LIMIT", 10, "int",
         "Compiles tolerated per guarded entry before the recompile-"
         "churn guard fires, for a ChurnDetector built without a limit "
         "(ModelRunner and GenerateRunner set their own from their "
         "bucket ladders).",
         "guards")

# -- training ------------------------------------------------------------
register("MXTPU_BATCHED_OPT", True, "bool",
         "(shape, dtype)-bucketed stacked optimizer updates in "
         "TrainStep; `0` reverts to one update chain per parameter.",
         "kill-switch")

# -- mixed precision and int8 (mxtpu/knobs.py:140-170) --------------------
register("MXTPU_AMP", "", "str",
         "Policy-driven bf16 autocast (mxtpu_torch.amp, reads "
         "contracts/amp_policy.json): `0` is the kill switch — AMP off "
         "everywhere, every step and runner as without it; `1` turns it "
         "on for every TrainStep/ModelRunner/GenerateRunner; unset "
         "defers to the per-call `amp=` argument.", "kill-switch")
register("MXTPU_AMP_LOSS_SCALE", 65536.0, "float",
         "Initial dynamic loss scale for AMP training (a power of two; "
         "x2 after each window of finite steps, halved on a non-finite "
         "step).  `0` disables loss scaling (no scale, no skipped "
         "steps).", "kill-switch")
register("MXTPU_AMP_SCALE_WINDOW", 2000, "int",
         "Consecutive finite steps before the AMP loss scale doubles "
         "(the backoff on a non-finite step is immediate).",
         "kill-switch")
register("MXTPU_QUANT", "", "str",
         "Policy-driven int8 post-training quantization "
         "(mxtpu_torch.quant, reads contracts/quant_policy.json): `0` "
         "is the kill switch — quantization off everywhere, every "
         "runner as without it; `1` turns it on for every ModelRunner "
         "and GenerateRunner; unset defers to the per-call `quant=` "
         "argument.", "kill-switch")
register("MXTPU_QUANT_CALIB", "entropy", "str",
         "Calibration collector for the activation thresholds: "
         "`entropy` (the KL-minimizing threshold) or `minmax` "
         "(abs-max).", "kill-switch")
register("MXTPU_QUANT_CALIB_BATCHES", 10, "int",
         "Most representative batches a ModelRunner.calibrate() pass "
         "reads when the caller does not say otherwise.", "kill-switch")

# -- observability (mxtpu_torch.obs) -----------------------------------
register("MXTPU_OBS", True, "bool",
         "Unified observability layer (mxtpu_torch.obs): metrics "
         "registry, per-request trace ids, flight recorders.  `0` = off: the "
         "factories hand back shared no-op instruments, so hot paths "
         "pay nothing (asserted by `obs.self_check()` at bench "
         "import).", "obs")
register("MXTPU_OBS_FLIGHT_CAPACITY", 256, "int",
         "Flight-recorder ring size — structured events kept per "
         "worker (oldest evicted first).", "obs")
register("MXTPU_OBS_DUMP_ON_ERROR", "", "str",
         "Extra flight-recorder postmortems: unset = dump only on "
         "worker death; `1` also dumps every recorder when a fleet "
         "request fails terminally; a directory path additionally "
         "writes each postmortem there as JSON.", "obs")
register("MXTPU_OBS_SAMPLE_PERIOD_US", 1000000, "int",
         "Time-series sampler period (obs.sampler): how often "
         "maybe_sample() snapshots the metrics registry into the "
         "bounded per-series rings that back windowed rates, "
         "p50/p95/p99 and SLO burn windows.", "obs")
register("MXTPU_OBS_HTTP_PORT", -1, "int",
         "Debug HTTP server (obs.debug_server): /metrics /varz "
         "/healthz /statusz /tracez on loopback.  -1 = never serve "
         "(default); 0 = ephemeral port (tests read it back from "
         "server.port); >0 = fixed port.", "obs")
register("MXTPU_SLO_CLASSES", "", "str",
         "Declarative latency SLOs, comma-separated "
         "`name:endpoint:target_ms:objective[:percentile]` (e.g. "
         "`interactive:fleet:50:0.95`), parsed by "
         "obs.parse_slo_classes into LatencySLO objects next to the "
         "built-in availability SLO.", "obs")
register("MXTPU_PROFILER_AUTOSTART", False, "bool",
         "Start the chrome-trace profiler at import.", "engine")

# -- serving fleet (router / health / retry) ---------------------------
register("MXTPU_FLEET_LIVENESS_S", 2.0, "float",
         "Liveness deadline on a dispatched batch: in-flight past "
         "this is SUSPECT, past 2x is a hang (DEAD).", "fleet")
register("MXTPU_FLEET_DEAD_AFTER", 3, "int",
         "Consecutive canary failures on a SUSPECT worker before it "
         "is declared DEAD.", "fleet")
register("MXTPU_FLEET_CANARY_INTERVAL_S", 5.0, "float",
         "Seconds between canary inferences per worker (0 disables "
         "active health checks).", "fleet")
register("MXTPU_FLEET_CANARY_TIMEOUT_S", 1.0, "float",
         "Deadline on each canary inference.", "fleet")
register("MXTPU_FLEET_RETRY_MAX", 3, "int",
         "Router-level re-dispatch cap per request (retriable "
         "failures only).", "fleet")
register("MXTPU_FLEET_BACKOFF_BASE_US", 1000, "int",
         "Retry backoff base: min(cap, base * 2^(n-1)) + jitter.",
         "fleet")
register("MXTPU_FLEET_BACKOFF_CAP_US", 64000, "int",
         "Retry backoff cap in microseconds.", "fleet")
register("MXTPU_FLEET_JITTER", 0.2, "float",
         "Backoff jitter fraction (deterministic seeded RNG).",
         "fleet")
register("MXTPU_FLEET_HEDGE_AFTER_US", 0, "int",
         "Hedge a still-in-flight request onto a second worker after "
         "this many microseconds (0 disables hedging).", "fleet")
register("MXTPU_FLEET_MAX_PENDING", 1024, "int",
         "Bound on the router's parked-retry buffer before "
         "ServerBusy shedding.", "fleet")
register("MXTPU_FLEET_TICK_S", 0.005, "float",
         "Router ticker period in threaded mode.", "fleet")

# -- fleet control plane (autoscaler / admission / priority) -----------
register("MXTPU_FLEET_AUTOSCALE_MIN", 1, "int",
         "Autoscaler floor: never drain below this many healthy "
         "workers.", "controlplane")
register("MXTPU_FLEET_AUTOSCALE_MAX", 4, "int",
         "Autoscaler ceiling on live (non-dead) workers.",
         "controlplane")
register("MXTPU_FLEET_AUTOSCALE_UP_DEPTH", 4.0, "float",
         "Scale-up band: mean outstanding requests per healthy worker "
         "(router backlog included) above this counts as an overload "
         "tick.", "controlplane")
register("MXTPU_FLEET_AUTOSCALE_DOWN_DEPTH", 0.5, "float",
         "Scale-down band: mean outstanding per healthy worker below "
         "this (with an empty router backlog) counts as an underload "
         "tick.", "controlplane")
register("MXTPU_FLEET_AUTOSCALE_UP_ETA_US", 0.0, "float",
         "Additional scale-up trigger: predicted queue ETA "
         "(ServingStats.queue_eta_us) above this many microseconds "
         "counts as overload (0 disables the ETA signal).",
         "controlplane")
register("MXTPU_FLEET_AUTOSCALE_BURN", False, "bool",
         "Let an attached SLO engine's firing burn-rate alerts count "
         "as autoscaler overload ticks (scale up while the error "
         "budget is burning even if queue depth looks fine).  Off by "
         "default: scaling behaviour is bit-identical to the "
         "pre-SLO autoscaler unless explicitly enabled.",
         "controlplane")
register("MXTPU_FLEET_AUTOSCALE_BREACH_TICKS", 3, "int",
         "Hysteresis: consecutive over/under-band evaluations before "
         "the autoscaler acts (bands reset each action).",
         "controlplane")
register("MXTPU_FLEET_AUTOSCALE_COOLDOWN_S", 5.0, "float",
         "Minimum seconds between autoscaler actions (either "
         "direction).", "controlplane")
register("MXTPU_FLEET_ADMISSION", False, "bool",
         "Predictive admission control: shed a deadline-carrying "
         "request at submit with ServerBusy (+retry_after_us) when "
         "the class-aware queue ETA says it cannot finish in time.",
         "controlplane")
register("MXTPU_FLEET_ADMISSION_MARGIN", 1.0, "float",
         "Admission safety factor: shed when margin x predicted ETA "
         "exceeds the deadline budget (>1 sheds earlier, <1 gambles).",
         "controlplane")
register("MXTPU_FLEET_CLASSES", "", "str",
         "Priority/fairness classes as `name:weight[:quota],...` "
         "(e.g. `gold:8,bulk:1:64`): weight sets the weighted-round-"
         "robin dispatch share, quota bounds in-system requests per "
         "class.  Unset = one `default` class.", "controlplane")

# -- persistent compile cache (mxtpu/knobs.py:395-408) -----------------
register("MXTPU_CACHE", True, "bool",
         "Master switch for the persistent AOT executable cache: "
         "`0` = always compile, never touch disk.  The disk layer is "
         "also inert while MXTPU_CACHE_DIR is unset.", "cache")
register("MXTPU_CACHE_DIR", "", "str",
         "Root directory of the on-disk compiled-executable cache "
         "(crash-safe writes, checksum-verified loads).  ModelRunner "
         "buckets and AOT TrainStep programs load-or-compile through "
         "it; unset disables persistence.", "cache")
register("MXTPU_CACHE_SALT", "", "str",
         "Extra cache-key component: bump it to invalidate every "
         "cached executable (rollout epoch, config generation).",
         "cache")
