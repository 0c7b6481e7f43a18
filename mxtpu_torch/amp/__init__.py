"""``mxtpu_torch.amp`` — policy-driven bf16 autocast with f32
accumulation (the counterpart of ``mxtpu/amp/__init__.py``).

The policy is mxtpu's committed ``contracts/amp_policy.json``, read and
never written: an op is cast to bf16 only when what it lowers to lies
in the policy's ``allow`` class (``_cast_decision``).  mxtpu finds what
an op lowers to by tracing it; the port has no trace, so it keeps a
table (:data:`OPCODES`) of the opcodes each op of :data:`ACCUM_READY`
that its registry holds lowers to in mxtpu, and still decides
``opcodes ⊆ allow`` from the file: a policy that moved ``dot`` out of
``allow`` switches the cast off here too.

Inside an :func:`autocast` scope the dispatchers
(:mod:`..ops.interpose`) hand a candidate op its f32 inputs cast to
bf16, inside the recorded call, so autograd differentiates through the
casts.  The op then runs its contraction form (:func:`dense`,
:func:`conv`, mxtpu's ``dot_general`` and ``conv_general``): bf16 ×
bf16 with an **f32 output**, and a backward that casts the cotangent to
bf16, accumulates dx and dw in f32 and casts each to its input's type.
Everything else stays f32, because ``TrainStep`` and the runners upcast
every float parameter to f32 at the graph's entry.

Routes: on the CPU each form is its plain version, an f32 product of
the bf16-rounded operands (exact products, f32 sums).  On the card the
GEMM is ``torch.mm(a, b, out_dtype=torch.float32)`` on the bf16
operands (cuBLAS, bf16 tensor cores, f32 accumulation and output); the
convolution is that GEMM over the input's patches (:mod:`..ops.im2col`),
since a bf16 cuDNN convolution rounds its output to bf16 and an f32 one
may take an FFT algorithm, whose products are not exact.  Neither is a
hand-written kernel: mxtpu leaves both to XLA.  Each forward counts in
:data:`DOT_LAUNCHES` / :data:`CONV_LAUNCHES`.

Kill switch: ``MXTPU_AMP=0`` forces AMP off everywhere (:func:`resolve`).
``python -m mxtpu_torch.amp --self-check`` probes the policy parse, an
autocast round trip (outputs and dtypes) and the loss scaler.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import sys
from typing import Any, Dict, FrozenSet, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import knobs
from ..base import MXNetError
from ..ops import im2col
from ..ops.interpose import SCOPES

__all__ = [
    "POLICY_PATH", "load_policy", "policy_sets", "resolve",
    "scaler_config", "autocast", "active", "matmul_preferred",
    "ACCUM_READY", "OPCODES", "wrap_op", "gemm", "gemm_plain", "dense",
    "dense_plain", "conv", "conv_plain", "conv_bwd_plain", "scaler_init",
    "scaler_update", "all_finite", "self_check",
]

_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))
POLICY_PATH = os.path.join(_REPO_ROOT, "contracts", "amp_policy.json")

_BF16 = torch.bfloat16
_F32 = torch.float32
_SCALE_MAX = 2.0 ** 24

# forward contractions on the card (a replay of a captured graph adds
# its capture's)
DOT_LAUNCHES = 0
CONV_LAUNCHES = 0


# ----------------------------------------------------------------------
# policy file
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def load_policy(path: Optional[str] = None) -> Dict[str, Any]:
    """Parse ``contracts/amp_policy.json`` (cached)."""
    p = path or POLICY_PATH
    try:
        with open(p, "r", encoding="utf-8") as f:
            policy = json.load(f)
    except (OSError, ValueError) as e:
        raise MXNetError(f"mxtpu_torch.amp: cannot load AMP policy {p!r}: "
                         f"{e}")
    for key in ("allow", "deny", "fp32_force", "inherit"):
        if not isinstance(policy.get(key), dict):
            raise MXNetError(
                f"mxtpu_torch.amp: policy {p!r} missing opcode class "
                f"{key!r}")
    return policy


@functools.lru_cache(maxsize=None)
def policy_sets(path: Optional[str] = None
                ) -> Tuple[FrozenSet[str], FrozenSet[str], FrozenSet[str]]:
    """(allow, deny, fp32_force) opcode sets from the policy file."""
    policy = load_policy(path)
    return (frozenset(policy["allow"]), frozenset(policy["deny"]),
            frozenset(policy["fp32_force"]))


def _switch(knob: str, flag: Optional[bool]) -> bool:
    env = str(knobs.get(knob)).strip().lower()
    if env in ("0", "off", "false", "no"):
        return False
    if flag is not None:
        return bool(flag)
    return env in ("1", "on", "true", "yes")


def resolve(flag: Optional[bool] = None) -> bool:
    """The effective AMP switch: ``MXTPU_AMP=0`` kills it everywhere,
    ``MXTPU_AMP=1`` forces it on, otherwise the per-call ``amp=``
    argument decides (default off)."""
    return _switch("MXTPU_AMP", flag)


def scaler_config() -> Tuple[bool, float, int]:
    """(enabled, init_scale, grow_window) of the dynamic loss scaler.
    ``MXTPU_AMP_LOSS_SCALE=0`` disables scaling."""
    init = float(knobs.get("MXTPU_AMP_LOSS_SCALE"))
    window = max(1, int(knobs.get("MXTPU_AMP_SCALE_WINDOW")))
    return init > 0.0, init, window


# ----------------------------------------------------------------------
# the autocast scope
# ----------------------------------------------------------------------
@contextlib.contextmanager
def autocast(enabled: bool = True):
    """Scope under which the policy's contractions dispatched through
    the op registry run on bf16 inputs with f32 accumulation."""
    prev = SCOPES.amp
    SCOPES.amp = bool(enabled)
    SCOPES.refresh()
    try:
        yield
    finally:
        SCOPES.amp = prev
        SCOPES.refresh()


def active() -> bool:
    return SCOPES.amp


def matmul_preferred(*operands) -> Optional[torch.dtype]:
    """The output type a contraction takes: f32 when an autocast scope
    is open and some float operand is narrower than f32, else None (the
    op as it is)."""
    if not SCOPES.amp:
        return None
    sub = False
    for a in operands:
        if not a.is_floating_point():
            return None
        if a.element_size() < 4:
            sub = True
    return _F32 if sub else None


# ----------------------------------------------------------------------
# the cast decision
# ----------------------------------------------------------------------
# mxtpu's contraction ops that keep f32 accumulation under a bf16 cast
# (mxtpu/amp/__init__.py:172-176); an op the port's registry does not
# hold is never dispatched
ACCUM_READY = frozenset({
    "dot", "batch_dot", "matmul", "linalg_gemm", "linalg_gemm2",
    "FullyConnected", "fully_connected",
    "Convolution", "convolution", "Convolution_v1",
})

# What each op of ACCUM_READY in the port's registry lowers to in mxtpu
# (the mapped opcodes its traced jaxpr holds: FullyConnected a reshape,
# a dot_general and an add; Convolution a conv_general_dilated and an
# add; reshapes and adds are the policy's `inherit` class, unmapped)
OPCODES = {"FullyConnected": frozenset({"dot"}),
           "Convolution": frozenset({"convolution"})}


def _cast_decision(op) -> bool:
    """``opcodes ⊆ allow`` for ``op``, from the policy file: a deny or
    fp32_force opcode anywhere inside vetoes the cast."""
    opcodes = OPCODES.get(op.name, frozenset())
    allow, deny, force = policy_sets()
    decision = bool(opcodes) and opcodes <= allow
    assert not (opcodes & (deny | force)) or not decision
    return decision


def wrap_op(name: str, op, tensors, resolved):
    """Inside an autocast scope, a replacement for ``op.fn`` that casts
    the f32 inputs to bf16 (the op's contraction form then keeps f32
    accumulation), or None to leave the op alone."""
    if name not in ACCUM_READY or not _cast_decision(op):
        return None

    def fn(*ts):
        ts = [t.to(_BF16) if t.dtype == _F32 else t for t in ts]
        return op.fn(*ts, **resolved)
    return fn


# ----------------------------------------------------------------------
# the contraction forms: bf16 operands, f32 output, both directions
# ----------------------------------------------------------------------
def _bump(attr: str) -> None:
    from .. import kernels
    kernels.bump(sys.modules[__name__], attr)


def gemm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a (M, K) @ b (K, N)`` as an f32 product of the (bf16) operands
    upcast: exact products, f32 sums."""
    return torch.mm(a.float(), b.float())


def gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a (M, K) @ b (K, N)`` of bf16 operands with an f32 output: on
    the card cuBLAS's bf16 GEMM accumulating and writing f32, on the
    CPU :func:`gemm_plain`."""
    if a.device.type == "cpu":
        return gemm_plain(a, b)
    return torch.mm(a, b, out_dtype=_F32)


class _Dense(torch.autograd.Function):
    """``x (..., K) @ w (N, K)ᵀ`` with an f32 output (mxtpu's
    ``dot_general`` of FullyConnected, ``mxtpu/amp/__init__.py:335-362``)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.device.type == "cuda":
            _bump("DOT_LAUNCHES")
        y = gemm(x.reshape(-1, x.shape[-1]), w.t())
        return y.reshape(x.shape[:-1] + (w.shape[0],))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.reshape(-1, w.shape[0]).to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = gemm(g, w).reshape(x.shape).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = gemm(g.t(), x.reshape(-1, x.shape[-1])).to(w.dtype)
        return dx, dw


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """FullyConnected's product under autocast: ``x @ wᵀ``, bf16
    operands, f32 output; the gradients in the operands' types."""
    return _Dense.apply(x, w)


def dense_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`dense`'s forward as its plain version."""
    y = gemm_plain(x.reshape(-1, x.shape[-1]), w.t())
    return y.reshape(x.shape[:-1] + (w.shape[0],))


_CONV_FN = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_GRAD = {1: (torch.nn.grad.conv1d_input, torch.nn.grad.conv1d_weight),
              2: (torch.nn.grad.conv2d_input, torch.nn.grad.conv2d_weight),
              3: (torch.nn.grad.conv3d_input, torch.nn.grad.conv3d_weight)}


def _cf(t: torch.Tensor, layout: str) -> torch.Tensor:
    return t.movedim(-1, 1) if layout.endswith("C") else t


def _from_cf(t: torch.Tensor, layout: str) -> torch.Tensor:
    return t.movedim(1, -1).contiguous() if layout.endswith("C") else t


def conv_plain(x, w, geom) -> torch.Tensor:
    """The convolution of the (bf16) operands upcast to f32, in
    ``layout`` (``geom`` = (kernel, stride, pad, dilate, groups,
    layout)): exact products, f32 sums."""
    kernel, stride, pad, dilate, groups, layout = geom
    y = _CONV_FN[len(kernel)](_cf(x, layout).float(), _cf(w, layout).float(),
                              None, stride, pad, dilate, groups)
    return _from_cf(y, layout)


def conv_bwd_plain(x, w, g, geom):
    """(dx, dw) of :func:`conv_plain` for an f32 cotangent ``g`` already
    rounded to bf16, both f32."""
    kernel, stride, pad, dilate, groups, layout = geom
    dgrad, wgrad = _CONV_GRAD[len(kernel)]
    xc, wc, gc = (_cf(t, layout).float() for t in (x, w, g))
    dx = dgrad(xc.shape, wc, gc, stride, pad, dilate, groups)
    dw = wgrad(xc, wc.shape, gc, stride, pad, dilate, groups)
    return _from_cf(dx, layout), _from_cf(dw, layout)


def _conv_gemm(x, w, geom) -> torch.Tensor:
    """The card's route: the patches of x as rows times the weight rows
    through :func:`gemm`, a group at a time."""
    kernel, stride, pad, dilate, groups, layout = geom
    view = im2col.patches(im2col.channels_last(x, layout), kernel, stride,
                          pad, dilate)
    wr = im2col.weight_rows(w, layout)
    og = wr.shape[0] // groups
    ys = [gemm(im2col.patch_rows(view, groups, g),
               wr[g * og:(g + 1) * og].t()) for g in range(groups)]
    y = ys[0] if groups == 1 else torch.cat(ys, dim=1)
    return im2col.from_channels_last(
        y.reshape(view.shape[:1 + len(kernel)] + (wr.shape[0],)), layout)


def _conv_gemm_bwd(x, w, g, geom):
    kernel, stride, pad, dilate, groups, layout = geom
    d = len(kernel)
    x_cl = im2col.channels_last(x, layout)
    view = im2col.patches(x_cl, kernel, stride, pad, dilate)
    wr = im2col.weight_rows(w, layout)
    og, cg = wr.shape[0] // groups, x_cl.shape[-1] // groups
    g_cl = im2col.channels_last(g, layout).reshape(-1, wr.shape[0])
    dws, dcols = [], []
    for k in range(groups):
        gk = g_cl[:, k * og:(k + 1) * og]
        dws.append(gemm(gk.t(), im2col.patch_rows(view, groups, k)))
        dcols.append(gemm(gk, wr[k * og:(k + 1) * og]).reshape(
            view.shape[:1 + 2 * d] + (cg,)))
    dw = dws[0] if groups == 1 else torch.cat(dws, dim=0)
    wshape = (w.shape if layout.endswith("C")
              else (w.shape[0],) + tuple(w.shape[2:]) + (w.shape[1],))
    dw = dw.reshape(wshape)
    if not layout.endswith("C"):
        dw = dw.movedim(-1, 1)
    dcol = dcols[0] if groups == 1 else torch.cat(dcols, dim=-1)
    dx = im2col.col2im(dcol, x_cl.shape, kernel, stride, pad, dilate)
    return im2col.from_channels_last(dx, layout), dw


class _Conv(torch.autograd.Function):
    """mxtpu's ``conv_general`` (``mxtpu/amp/__init__.py:295-323``)."""

    @staticmethod
    def forward(ctx, x, w, geom):
        ctx.save_for_backward(x, w)
        ctx.geom = geom
        if x.device.type == "cpu":
            return conv_plain(x, w, geom)
        _bump("CONV_LAUNCHES")
        return _conv_gemm(x, w, geom)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        if x.device.type == "cpu":
            dx, dw = conv_bwd_plain(x, w, g, ctx.geom)
        else:
            dx, dw = _conv_gemm_bwd(x, w, g, ctx.geom)
        return (dx.to(x.dtype) if ctx.needs_input_grad[0] else None,
                dw.to(w.dtype) if ctx.needs_input_grad[1] else None, None)


def conv(x: torch.Tensor, w: torch.Tensor, kernel, stride, pad, dilate,
         groups: int, layout: str) -> torch.Tensor:
    """Convolution under autocast in mxtpu's ``layout`` (weights
    ``OI<spatial>`` channels-first, ``O<spatial>I`` channels-last): bf16
    operands, f32 output; the gradients in the operands' types."""
    geom = (tuple(kernel), tuple(stride), tuple(pad), tuple(dilate),
            int(groups), layout)
    return _Conv.apply(x, w, geom)


# ----------------------------------------------------------------------
# the dynamic loss scaler (state on the step's device, threaded through
# the train step and its checkpoints)
# ----------------------------------------------------------------------
def scaler_init(init_scale: Optional[float] = None, device=None):
    """(scale f32, good_steps i32, skipped_steps i32), 0-d tensors."""
    if init_scale is None:
        init_scale = float(knobs.get("MXTPU_AMP_LOSS_SCALE"))
    return (torch.tensor(init_scale, dtype=_F32, device=device),
            torch.tensor(0, dtype=torch.int32, device=device),
            torch.tensor(0, dtype=torch.int32, device=device))


def scaler_update(state, finite, window: Optional[int] = None):
    """Grow x2 after ``window`` consecutive finite steps (capped at
    2^24), halve (floor 1.0) and count a skipped step on a non-finite
    one."""
    if window is None:
        window = max(1, int(knobs.get("MXTPU_AMP_SCALE_WINDOW")))
    scale, good, skipped = state
    finite = torch.as_tensor(finite, dtype=torch.bool, device=scale.device)
    good1 = good + 1
    grow = finite & (good1 >= window)
    new_scale = torch.where(
        finite, torch.where(grow, (scale * 2.0).clamp_max(_SCALE_MAX),
                            scale),
        (scale * 0.5).clamp_min(1.0))
    new_good = torch.where(finite & ~grow, good1, torch.zeros_like(good))
    new_skipped = skipped + (~finite).to(skipped.dtype)
    return new_scale, new_good, new_skipped


def _leaves(tree):
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif tree is not None:
        yield torch.as_tensor(tree)


def all_finite(tree) -> torch.Tensor:
    """0-d bool tensor: every float leaf of ``tree`` is finite (an
    inf-norm per leaf, so a large finite leaf never overflows)."""
    leaves = [t for t in _leaves(tree) if t.is_floating_point()]
    if not leaves:
        return torch.tensor(True)
    norms = torch._foreach_norm(leaves, float("inf"))
    return torch.stack([n.float() for n in norms]).isfinite().all()


# ----------------------------------------------------------------------
# self-check: the policy parse, an autocast round trip, the scaler
# ----------------------------------------------------------------------
def _check_policy() -> None:
    policy = load_policy()
    allow, deny, force = policy_sets()
    if "dot" not in allow:
        raise MXNetError("amp self-check: policy allow class lost `dot`")
    if not deny or "reduce" not in force:
        raise MXNetError("amp self-check: policy deny/fp32_force empty")
    if allow & (deny | force):
        raise MXNetError("amp self-check: policy classes overlap")
    for cc in ("batch_norm", "flash_attention", "layer_norm"):
        meta = policy.get("custom_calls", {}).get(cc, {})
        if meta.get("accum_dtype") != "f32":
            raise MXNetError(f"amp self-check: custom call {cc} lost its "
                             f"f32 accumulation contract")


def _check_autocast_roundtrip() -> None:
    import numpy as np
    from .. import autograd, nd
    a = nd.array(np.linspace(-1, 1, 64, dtype=np.float32).reshape(8, 8),
                 ctx="cpu")
    b = nd.array(np.linspace(1, -1, 32, dtype=np.float32).reshape(4, 8),
                 ctx="cpu")
    for t in (a, b):
        t.attach_grad()
    with autograd.record():
        with autocast():
            y = nd.FullyConnected(a, b, num_hidden=4, no_bias=True)
        loss = (nd.softmax(y) ** 2).sum()
    loss.backward()
    want = a._data.bfloat16().float() @ b._data.bfloat16().float().t()
    if y.dtype != np.float32 or not torch.equal(y._data, want):
        raise MXNetError("amp self-check: the autocast product is not the "
                         "f32 product of the bf16-rounded operands")
    if a.grad.dtype != np.float32 or b.grad.dtype != np.float32:
        raise MXNetError("amp self-check: the gradients of f32 inputs "
                         "left f32")
    off = nd.FullyConnected(a, b, num_hidden=4, no_bias=True)
    if not torch.equal(off._data, a._data @ b._data.t()) or \
            torch.equal(off._data, want):
        raise MXNetError("amp self-check: bf16 leaked outside autocast")


def _check_scaler() -> None:
    import numpy as np
    st = scaler_init(1024.0)
    for _ in range(3):
        st = scaler_update(st, True, window=3)
    if float(st[0]) != 2048.0 or int(st[1]) != 0:
        raise MXNetError(f"amp self-check: scaler grow broken: {st}")
    st = scaler_update(st, False, window=3)
    if float(st[0]) != 1024.0 or int(st[2]) != 1:
        raise MXNetError(f"amp self-check: scaler backoff broken: {st}")
    st = scaler_update(st, True, window=3)
    if float(st[0]) != 1024.0 or int(st[1]) != 1 or int(st[2]) != 1:
        raise MXNetError(f"amp self-check: scaler resume broken: {st}")
    bad = (np.ones(3, np.float32), np.array([1.0, np.inf], np.float32))
    if bool(all_finite(bad)) or not bool(all_finite(bad[0])):
        raise MXNetError("amp self-check: all_finite broken")


def self_check(verbose: bool = False) -> int:
    """Probe the policy, the autocast round trip and the scaler; 0 on
    success (raises on failure)."""
    _check_policy()
    if verbose:
        print(f"amp self-check: policy parse OK ({POLICY_PATH})")
    _check_autocast_roundtrip()
    if verbose:
        print("amp self-check: autocast round trip OK (f32 output of the "
              "bf16-rounded operands, f32 gradients, no leak outside the "
              "scope)")
    _check_scaler()
    if verbose:
        print("amp self-check: loss-scaler unit probe OK "
              "(grow/backoff/skip accounting)")
    return 0
