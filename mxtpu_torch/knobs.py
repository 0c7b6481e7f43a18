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
