"""``mxtpu_torch.quant`` — int8 post-training quantization (calibrate →
policy → serve), the counterpart of ``mxtpu/quant/__init__.py``.

The policy is mxtpu's committed ``contracts/quant_policy.json``, read
and never written.  Two scopes share the AMP pass's interposition
(:mod:`..ops.interpose`):

* :func:`calibrating` — representative batches run eagerly through the
  deployed graph; every candidate contraction's f32 data input is
  observed by a collector (:class:`MinMaxCollector` or
  :class:`EntropyCollector`) under a per-dispatch key
  (``FullyConnected_3`` = the 4th candidate in dispatch order).
  Deterministic given the batches: no RNG, no clock.
* :func:`quantize` — a candidate whose key has a recorded threshold
  runs its int8 form: the activation quantized on entry (symmetric per
  tensor, ``round(x · f32(127/t))`` clipped to ±127), per-output-channel
  weight thresholds computed at call time (so one captured bucket serves
  every checkpoint), an int8 × int8 → int32 product, and an f32
  dequantize epilogue, then the bias.  An op outside the policy's
  ``allow`` class, or with no recorded scale, stays on the float path.
  A quantized convolution covers channels-first layouts only, as
  mxtpu's does.

The decision is the AMP pass's table (``amp.OPCODES``) against this
policy's ``allow`` class.  The int8 product (:func:`int_mm`) is on the
card ``torch._int_mm`` (cuBLAS int8 GEMM, int32 accumulation; mxtpu's is
an XLA dot, not a Pallas kernel), with the shapes it refuses padded
(rows to more than 16, K and N to multiples of 8, zeros sliced off
after), never a float product; on the CPU its plain version, the
integer sums in f64 (exact below 2^53).  A quantized convolution is
that product over the input's patches (:mod:`..ops.im2col`).  Each int8
contraction on the card counts in :data:`INT8_GEMMS`.

Kill switch: ``MXTPU_QUANT=0`` forces quantization off everywhere
(:func:`resolve`).  ``python -m mxtpu_torch.quant --self-check`` probes
the policy parse and a calibrate → quantize round trip.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import sys
from typing import Any, Dict, FrozenSet, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import knobs
from ..base import MXNetError
from ..ops import im2col
from ..ops.interpose import SCOPES

__all__ = [
    "POLICY_PATH", "load_policy", "policy_sets", "resolve",
    "calib_config", "make_collector", "MinMaxCollector",
    "EntropyCollector", "calibrating", "quantize", "active",
    "wrap_op", "QUANT_READY", "int_mm", "int_mm_plain", "int_conv",
    "int_conv_plain", "self_check",
]

_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))
POLICY_PATH = os.path.join(_REPO_ROOT, "contracts", "quant_policy.json")

_F32 = torch.float32
_QMAX = 127.0  # symmetric int8: [-127, 127], -128 unused (reference)
_CONV_NAMES = ("Convolution", "convolution", "Convolution_v1")

# int8 contractions on the card (a replay of a captured graph adds its
# capture's)
INT8_GEMMS = 0


# ----------------------------------------------------------------------
# policy file
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def load_policy(path: Optional[str] = None) -> Dict[str, Any]:
    """Parse ``contracts/quant_policy.json`` (cached)."""
    p = path or POLICY_PATH
    try:
        with open(p, "r", encoding="utf-8") as f:
            policy = json.load(f)
    except (OSError, ValueError) as e:
        raise MXNetError(
            f"mxtpu_torch.quant: cannot load quant policy {p!r}: {e}")
    for key in ("allow", "deny", "calibration"):
        if not isinstance(policy.get(key), dict):
            raise MXNetError(
                f"mxtpu_torch.quant: policy {p!r} missing section {key!r}")
    return policy


@functools.lru_cache(maxsize=None)
def policy_sets(path: Optional[str] = None
                ) -> Tuple[FrozenSet[str], FrozenSet[str]]:
    """(allow, deny) opcode sets from the policy file."""
    policy = load_policy(path)
    return frozenset(policy["allow"]), frozenset(policy["deny"])


def resolve(flag: Optional[bool] = None) -> bool:
    """The effective quantization switch: ``MXTPU_QUANT=0`` kills it
    everywhere, ``MXTPU_QUANT=1`` forces it on, otherwise the per-call
    ``quant=`` argument decides (default off) — the same precedence as
    ``amp.resolve``."""
    from .. import amp
    return amp._switch("MXTPU_QUANT", flag)


def calib_config() -> Tuple[str, int]:
    """(collector mode, most batches) for calibration runs."""
    mode = str(knobs.get("MXTPU_QUANT_CALIB")).strip().lower()
    if mode not in ("minmax", "entropy"):
        raise MXNetError(
            f"mxtpu_torch.quant: MXTPU_QUANT_CALIB={mode!r} — use "
            f"`minmax` or `entropy`")
    batches = max(1, int(knobs.get("MXTPU_QUANT_CALIB_BATCHES")))
    return mode, batches


# ----------------------------------------------------------------------
# calibration collectors (the reference's two algorithms), pure functions
# of the observed values
# ----------------------------------------------------------------------
def _round6(x: float) -> float:
    """6-significant-figure rounding: a byte-stable decimal form well
    above f32 noise (mxtpu's thresholds land in committed JSON)."""
    return float(f"{float(x):.6g}")


def _observed_np(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().float().cpu().numpy()
    return np.asarray(value, np.float32)


class MinMaxCollector:
    """Per-key symmetric |x| threshold = running abs-max (the
    reference's ``calib_mode='naive'``)."""

    mode = "minmax"

    def __init__(self):
        self._absmax: Dict[str, float] = {}

    def observe(self, key: str, value) -> None:
        arr = _observed_np(value)
        m = float(abs(arr).max()) if arr.size else 0.0
        prev = self._absmax.get(key, 0.0)
        if m > prev:
            self._absmax[key] = m
        else:
            self._absmax.setdefault(key, prev)

    def thresholds(self) -> Dict[str, float]:
        return {k: _round6(max(v, 1e-6))
                for k, v in sorted(self._absmax.items())}


class EntropyCollector:
    """Per-key KL-minimizing |x| threshold over every observed batch
    (the reference's ``calib_mode='entropy'``, via
    :func:`mxtpu_torch.contrib.quantization.optimal_threshold`)."""

    mode = "entropy"

    def __init__(self, num_bins: int = 2001,
                 num_quantized_bins: int = 255):
        self._chunks: Dict[str, List] = {}
        self._num_bins = num_bins
        self._num_quantized_bins = num_quantized_bins

    def observe(self, key: str, value) -> None:
        self._chunks.setdefault(key, []).append(
            _observed_np(value).ravel())

    def thresholds(self) -> Dict[str, float]:
        from ..contrib.quantization import optimal_threshold
        out = {}
        for key in sorted(self._chunks):
            arr = np.concatenate(self._chunks[key])
            out[key] = _round6(max(optimal_threshold(
                arr, self._num_bins, self._num_quantized_bins), 1e-6))
        return out


def make_collector(mode: Optional[str] = None):
    """Collector for ``mode`` (default: the MXTPU_QUANT_CALIB knob)."""
    if mode is None:
        mode, _ = calib_config()
    if mode == "minmax":
        return MinMaxCollector()
    if mode == "entropy":
        return EntropyCollector()
    raise MXNetError(f"mxtpu_torch.quant: unknown collector mode {mode!r}")


# ----------------------------------------------------------------------
# the scopes: the per-scope dispatch counter gives every candidate op a
# key; calibration and the quantized run walk the same graph in the
# same order, so key <-> op instance is one to one across the two
# ----------------------------------------------------------------------
def _enter(mode, collector, scales):
    prev = (SCOPES.quant, SCOPES.collector, SCOPES.scales, SCOPES.counter)
    SCOPES.quant, SCOPES.collector, SCOPES.scales = mode, collector, scales
    SCOPES.counter = 0
    SCOPES.refresh()
    return prev


def _leave(prev) -> None:
    (SCOPES.quant, SCOPES.collector, SCOPES.scales,
     SCOPES.counter) = prev
    SCOPES.refresh()


@contextlib.contextmanager
def calibrating(collector):
    """Scope under which candidate contractions have their f32 data
    input OBSERVED (copied to the host) by ``collector`` instead of
    being rewritten."""
    prev = _enter("calib", collector, None)
    try:
        yield collector
    finally:
        _leave(prev)


@contextlib.contextmanager
def quantize(scales: Dict[str, Any], enabled: bool = True):
    """Scope under which candidate contractions with a recorded
    activation threshold run as int8 × int8 products with int32
    accumulation.  ``scales`` maps dispatch keys to thresholds (float,
    or ``{"threshold": ...}`` as mxtpu's policy evidence stores
    them)."""
    norm = {}
    for k, v in (scales or {}).items():
        t = v.get("threshold") if isinstance(v, dict) else v
        if t is not None and float(t) > 0.0:
            norm[k] = float(t)
    prev = _enter("quant", None, norm) if enabled else None
    try:
        yield
    finally:
        if enabled:
            _leave(prev)


def active() -> bool:
    return SCOPES.quant is not None


# ----------------------------------------------------------------------
# the int8 product
# ----------------------------------------------------------------------
def _bump() -> None:
    from .. import kernels
    kernels.bump(sys.modules[__name__], "INT8_GEMMS")


def int_mm_plain(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a (M, K) @ w (N, K)ᵀ`` of int8 operands as int32: the integer
    sums in f64 (exact: |sum| < K · 127² < 2^53)."""
    return torch.mm(a.double(), w.double().t()).to(torch.int32)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a (M, K) @ w (N, K)ᵀ`` of int8 operands with an int32 sum: on
    the card ``torch._int_mm``, which takes M > 16 and K, N multiples of
    8 — other shapes are padded with zeros and the padding sliced off,
    so the result is the plain product bit for bit; on the CPU
    :func:`int_mm_plain`."""
    if a.device.type == "cpu":
        return int_mm_plain(a, w)
    return _int_mm_padded(a, w, torch._int_mm)


def _int_mm_padded(a, w, mm):
    """``mm(a', w'ᵀ)[:M, :N]`` over copies zero-padded to the shapes
    ``torch._int_mm`` takes (``a'`` more than 16 rows, K and N multiples
    of 8; ``w'ᵀ`` column-major): the zero rows and columns add nothing
    to the kept sums."""
    m, k = a.shape
    n = w.shape[0]
    mp = m if m > 16 else 24
    kp, np_ = _round_up(k, 8), _round_up(n, 8)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        w = F.pad(w, (0, kp - k, 0, np_ - n))
    out = mm(a.contiguous(), w.contiguous().t())
    return out if (mp, np_) == (m, n) else out[:m, :n]


_CONV_FN = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def int_conv_plain(qx, qw, kernel, stride, pad, dilate, groups):
    """The channels-first convolution of int8 operands as int32: the
    integer sums in f64 (exact)."""
    return _CONV_FN[len(kernel)](qx.double(), qw.double(), None, stride,
                                 pad, dilate, groups).to(torch.int32)


def int_conv(qx, qw, kernel, stride, pad, dilate, groups):
    """The channels-first (``OI<spatial>`` weights) convolution of int8
    operands with an int32 sum: on the card :func:`int_mm` over the
    input's patches, a group at a time; on the CPU
    :func:`int_conv_plain`."""
    if qx.device.type == "cpu":
        return int_conv_plain(qx, qw, kernel, stride, pad, dilate, groups)
    return _int_conv_patches(qx, qw, kernel, stride, pad, dilate, groups)


def _int_conv_patches(qx, qw, kernel, stride, pad, dilate, groups):
    """:func:`int_conv`'s route on the card: :func:`int_mm` of the
    patch rows and the weight rows, a group at a time."""
    layout = "NC" + "DHW"[3 - len(kernel):]
    view = im2col.patches(im2col.channels_last(qx, layout), kernel, stride,
                          pad, dilate)
    wr = im2col.weight_rows(qw, layout)
    og = wr.shape[0] // groups
    ys = [int_mm(im2col.patch_rows(view, groups, g),
                 wr[g * og:(g + 1) * og]) for g in range(groups)]
    y = ys[0] if groups == 1 else torch.cat(ys, dim=1)
    return im2col.from_channels_last(
        y.reshape(view.shape[:1 + len(kernel)] + (wr.shape[0],)), layout)


# ----------------------------------------------------------------------
# quantization decision + int8 replacements
# ----------------------------------------------------------------------
# contraction ops with an int8 serving form; attention's batch_dots are
# activation × activation (no weight-side scale) and stay on the float
# path, like the reference's FP32 fallback ops
QUANT_READY = frozenset({
    "FullyConnected", "fully_connected",
    "Convolution", "convolution", "Convolution_v1",
})


def _quant_decision(op) -> bool:
    """``opcodes ⊆ allow`` from this policy, the AMP pass's table of
    what the op lowers to: a deny-class opcode anywhere vetoes the int8
    form."""
    from .. import amp
    opcodes = amp.OPCODES.get(op.name, frozenset())
    allow, deny = policy_sets()
    decision = bool(opcodes) and opcodes <= allow
    assert not (opcodes & deny) or not decision
    return decision


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    # a 0-d f32 tensor on the operand's device: an elementwise op with
    # it divides (and multiplies) in f32 as XLA does, where a Python
    # scalar on the card is folded into a multiply by its reciprocal
    return torch.full((), v, dtype=_F32, device=like.device)


def quantize_tensor(x: torch.Tensor, threshold: float) -> torch.Tensor:
    """f32 -> int8, symmetric per tensor: round(x · f32(127/t)) (half to
    even) clipped to ±127."""
    scaled = x * _scalar(float(np.float32(_QMAX / threshold)), x)
    return torch.clamp(torch.round(scaled), -_QMAX, _QMAX).to(torch.int8)


def channel_thresholds(w: torch.Tensor) -> torch.Tensor:
    """Per-output-channel (axis 0) |w| thresholds, at call time."""
    red = tuple(range(1, w.ndim))
    return torch.clamp_min(w.abs().amax(dim=red), float(np.float32(1e-12)))


def quantize_weight(w: torch.Tensor, t_w: torch.Tensor) -> torch.Tensor:
    s = (_scalar(_QMAX, w) / t_w).reshape((-1,) + (1,) * (w.ndim - 1))
    return torch.clamp(torch.round(w * s), -_QMAX, _QMAX).to(torch.int8)


def dequant_scale(t_act: float, t_w: torch.Tensor) -> torch.Tensor:
    """f32(t_act/127) · (t_w / 127): the epilogue's per-channel
    factor."""
    return _scalar(float(np.float32(t_act / _QMAX)), t_w) * \
        (t_w / _scalar(_QMAX, t_w))


def _q_fully_connected(key: str, t_act: float, resolved):
    no_bias = bool(resolved.get("no_bias", False))
    flatten = bool(resolved.get("flatten", True))

    def fn(*ts):
        x, w = ts[0], ts[1]
        b = ts[2] if len(ts) > 2 else None
        if flatten and x.ndim > 2:
            x = x.reshape(x.shape[0], -1)
        qx = quantize_tensor(x, t_act)
        t_w = channel_thresholds(w)              # (num_hidden,)
        qw = quantize_weight(w, t_w)
        if qx.device.type == "cuda":
            _bump()
        acc = int_mm(qx.reshape(-1, qx.shape[-1]), qw).reshape(
            qx.shape[:-1] + (qw.shape[0],))
        y = acc.float() * dequant_scale(t_act, t_w)
        if b is not None and not no_bias:
            y = y + b
        return y
    return fn


def _q_convolution(key: str, t_act: float, resolved):
    from ..ndarray.ops_impl import _tuple
    kernel = tuple(resolved.get("kernel") or ())
    ndim = len(kernel)
    layout = resolved.get("layout") or \
        {1: "NCW", 2: "NCHW", 3: "NCDHW"}.get(ndim)
    if layout not in ("NCW", "NCHW", "NCDHW"):
        return None  # channels-last stays on the float path
    no_bias = bool(resolved.get("no_bias", False))
    groups = int(resolved.get("num_group") or 1)
    stride = _tuple(resolved.get("stride"), ndim)
    dilate = _tuple(resolved.get("dilate"), ndim)
    pad = resolved.get("pad")
    pad = _tuple(pad, ndim) if pad is not None else (0,) * ndim
    bshape = (1, -1) + (1,) * ndim

    def fn(*ts):
        x, w = ts[0], ts[1]
        b = ts[2] if len(ts) > 2 else None
        qx = quantize_tensor(x, t_act)
        t_w = channel_thresholds(w)              # (O,) of OI<spatial>
        qw = quantize_weight(w, t_w)
        if qx.device.type == "cuda":
            _bump()
        acc = int_conv(qx, qw, kernel, stride, pad, dilate, groups)
        y = acc.float() * dequant_scale(t_act, t_w).reshape(bshape)
        if b is not None and not no_bias:
            y = y + b.reshape(bshape)
        return y
    return fn


def wrap_op(name: str, op, tensors, resolved):
    """Inside a quant scope, either OBSERVE a candidate op's data input
    (calibration) or return its int8 replacement (quantized serving) —
    or None to leave the op on the float path.  Key assignment (the
    per-scope dispatch counter) is the same in both modes."""
    if name not in QUANT_READY or len(tensors) < 2:
        return None
    data, weight = tensors[0], tensors[1]
    if data.dtype != _F32 or weight.dtype != _F32:
        return None
    key = f"{name}_{SCOPES.counter}"
    SCOPES.counter += 1
    if SCOPES.quant == "calib":
        SCOPES.collector.observe(key, data)
        ow = getattr(SCOPES.collector, "observe_weight", None)
        if ow is not None:
            ow(key, weight)
        return None
    t_act = SCOPES.scales.get(key) if SCOPES.scales else None
    if t_act is None:
        return None  # no recorded scale -> the float path
    if not _quant_decision(op):
        return None
    if name in _CONV_NAMES:
        return _q_convolution(key, t_act, resolved)
    return _q_fully_connected(key, t_act, resolved)


# ----------------------------------------------------------------------
# self-check: the policy parse and a calibrate -> quantize round trip,
# checked by outputs and types
# ----------------------------------------------------------------------
def _check_policy() -> None:
    policy = load_policy()
    allow, deny = policy_sets()
    if "dot" not in allow:
        raise MXNetError("quant self-check: policy allow class lost `dot`")
    if not deny:
        raise MXNetError("quant self-check: policy deny class empty")
    if allow & deny:
        raise MXNetError("quant self-check: policy classes overlap")
    calib = policy.get("calibration", {})
    for key in ("activation_thresholds", "weight_scales",
                "int8_contractions"):
        if not calib.get(key):
            raise MXNetError(f"quant self-check: policy calibration "
                             f"evidence lost {key!r}")


def _tiny_net_arrays():
    x = np.linspace(-1.5, 1.5, 48, dtype=np.float32).reshape(8, 6)
    w1 = np.linspace(1, -1, 24, dtype=np.float32).reshape(4, 6)
    b1 = np.linspace(-0.2, 0.2, 4, dtype=np.float32)
    w2 = np.linspace(-0.8, 0.8, 12, dtype=np.float32).reshape(3, 4)
    return x, w1, b1, w2


def _tiny_forward(nd, x, w1, b1, w2):
    h = nd.FullyConnected(x, w1, b1, num_hidden=4)
    h = nd.relu(h)
    return nd.FullyConnected(h, w2, num_hidden=3, no_bias=True)


def _check_roundtrip(verbose: bool = False) -> None:
    from .. import nd
    args = [nd.array(a, ctx="cpu") for a in _tiny_net_arrays()]

    # eager calibration: both collectors see the same dispatch keys
    scales = {}
    for collector in (MinMaxCollector(), EntropyCollector()):
        with calibrating(collector):
            ref = _tiny_forward(nd, *args)
        scales[collector.mode] = collector.thresholds()
    for mode, sc in scales.items():
        if sorted(sc) != ["FullyConnected_0", "FullyConnected_1"]:
            raise MXNetError(
                f"quant self-check: {mode} collector keyed {sorted(sc)} "
                f"— expected one key per candidate dispatch")
    again = MinMaxCollector()
    with calibrating(again):
        _tiny_forward(nd, *args)
    if again.thresholds() != scales["minmax"]:
        raise MXNetError("quant self-check: calibration is not "
                         "deterministic across identical passes")

    # the quantized forward: two int8 products, int32 sums, f32 out,
    # close to the float reference; nothing quantized outside the scope
    table = scales["minmax"]
    seen = []
    real_mm = int_mm

    def spy(a, w):
        seen.append((a.dtype, w.dtype))
        out = real_mm(a, w)
        seen.append(out.dtype)
        return out

    mod = sys.modules[__name__]
    mod.int_mm = spy
    try:
        with quantize(table):
            got = _tiny_forward(nd, *args)
        with quantize(table, enabled=False):
            off = _tiny_forward(nd, *args)
    finally:
        mod.int_mm = real_mm
    want_seen = [(torch.int8, torch.int8), torch.int32] * 2
    if seen != want_seen:
        raise MXNetError(f"quant self-check: expected 2 int8 x int8 -> "
                         f"int32 products, saw {seen}")
    if got.dtype != np.float32:
        raise MXNetError("quant self-check: the dequantized output left "
                         "f32")
    want = ref.asnumpy()
    err = float(np.abs(got.asnumpy() - want).max())
    tol = 0.05 * max(1.0, float(np.abs(want).max()))
    if err > tol:
        raise MXNetError(f"quant self-check: int8 output drifted "
                         f"{err:.4f} from f32 (tol {tol:.4f})")
    if not np.array_equal(off.asnumpy(), want):
        raise MXNetError("quant self-check: int8 leaked outside the "
                         "quantize scope")
    if verbose:
        print(f"quant self-check: round trip OK (2 int8 products, "
              f"|err|={err:.4f} <= {tol:.4f})")


def self_check(verbose: bool = False) -> int:
    """Probe the quantization contracts; 0 on success (raises on
    failure)."""
    _check_policy()
    if verbose:
        print(f"quant self-check: policy parse OK ({POLICY_PATH})")
    _check_roundtrip(verbose)
    if verbose:
        print("quant self-check: calibrate->quantize round trip OK "
              "(deterministic scales, int32 accumulation, no leak outside "
              "the scope)")
    return 0
