"""The registered ops of the symbolic slice, as torch rules (the
counterpart of ``mxtpu/ndarray/ops_impl.py``).

Names and parameters follow the JAX package (and the reference's
``dmlc::Parameter`` fields), so a symbol written for one runs in the
other.  Ported: the arithmetic that ``NDArray`` and ``Symbol``
operators emit (the ``broadcast_*`` family, the ``_*_scalar`` family,
negation, comparisons), a few unary ops and reductions, the shape ops
``reshape``/``transpose``/``flatten``/``expand_dims``/``squeeze``/
``concat``/``stack``/``cast``, and the network ops ResNet and the MLP
recipes reach: ``Convolution`` (``ops_impl.py:733``), ``BatchNorm``
(``:1071-1111``), ``Activation`` (``:847``), ``Pooling`` (``:828``),
``FullyConnected`` (``:663``), ``softmax``/``log_softmax`` and
``SoftmaxOutput`` (``:907-967``), and the optimizer update ops
(``sgd_update`` ... ``multi_sgd_mom_update``, ``:1247-1460`` and
``:1727-1780``), whose rules live in ``optimizer/functional.py``.  The
rest of the registry waits.

Convolution, pooling and the dense product are lax outside any Pallas
kernel in the JAX package, so they stay torch calls here (cuDNN with
TF32 off, see ``context.strict_f32``).  A batch-statistics
``BatchNorm`` runs ``kernels.batch_norm.fused_bn_act``: its CUDA
kernels on the card, its plain version on the CPU.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import amp as _amp
from .. import random as _random
from ..base import MXNetError
from ..kernels import batch_norm as _bn
from ..kernels import fused_residual_layer_norm as _frln_kernel
from ..kernels import layer_norm as _ln_kernel
from ..ops.registry import Param, register_op
from .ndarray import _NARROW, torch_dtype

# ----------------------------------------------------------------------
# helpers
# ----------------------------------------------------------------------


def _tuple(v, n):
    if v is None:
        return (1,) * n
    if isinstance(v, int):
        return (v,) * n
    t = tuple(int(x) for x in v)
    return t * n if len(t) == 1 else t


def _norm_axis(axis):
    """mxtpu's ``_norm_axis``: None, an int or a tuple of ints, taken as
    written (a negative axis is not reduced modulo the rank)."""
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _flag(x, cond):
    """A binary comparison's result in the reference's type: the input's
    float type, else float32."""
    return cond.to(x.dtype if x.is_floating_point() else torch.float32)


def _scalar_flag(x, cond):
    """A scalar comparison's result: the input's own type, integer or
    float (``astype(x.dtype)`` in the reference)."""
    return cond.to(x.dtype)


def _scalar(x, s):
    """The python scalar ``s`` as a 0-d tensor of the type ``x`` op
    ``s`` takes: x's float type, float32 beside an integer x (a weak
    float, as in jax)."""
    return torch.tensor(s, dtype=torch.result_type(x, s), device=x.device)


def _float_of(x):
    """x, or x as float32 where it holds integers (jnp.mean and
    jax.nn.softmax compute integers in float32)."""
    return x if x.is_floating_point() else x.float()


class _Abs(torch.autograd.Function):
    """|x| with jnp.abs's gradient: the head where x >= 0 (at +0 and -0
    too), its negation elsewhere."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def _sign(x):
    """sign(x), NaN where x is NaN (jnp.sign; torch.sign gives 0)."""
    if not x.is_floating_point():
        return torch.sign(x)
    return torch.where(torch.isnan(x), x, torch.sign(x))


class _Pow(torch.autograd.Function):
    """x ** y with jax's gradients (lax.pow): d/dx = y * x^(y-1), not
    masked where y is 0 (NaN at x = y = 0), and d/dy = x^y * log(x)
    with log(1) where x is 0 (NaN where x^y is infinite there)."""

    @staticmethod
    def forward(ctx, x, y):
        z = torch.pow(x, y)
        ctx.save_for_backward(x, y, z)
        return z

    @staticmethod
    def backward(ctx, g):
        x, y, z = ctx.saved_tensors
        gx = gy = None
        if ctx.needs_input_grad[0]:
            gx = (g * (y * torch.pow(x, y - 1))).sum_to_size(x.shape)
        if ctx.needs_input_grad[1]:
            logx = torch.log(torch.where(x == 0, torch.ones_like(x), x))
            gy = (g * (z * logx)).sum_to_size(y.shape)
        return gx, gy


def _mod(a, b):
    """jnp.mod: the remainder with the divisor's sign; an integer
    remainder by 0 is 0 (torch raises on the CPU)."""
    if a.is_floating_point() or b.is_floating_point():
        return torch.remainder(a, b)
    zero = b == 0
    return torch.where(zero, 0, torch.remainder(
        a, torch.where(zero, torch.ones_like(b), b)))


class _RMod(torch.autograd.Function):
    """s mod x (jnp.mod(s, x)) with jax's gradient in x: lax.rem's
    -trunc(s / x), plus the head where jnp.mod adds x back (a nonzero
    remainder of the other sign); torch implements no derivative of
    remainder in its divisor."""

    @staticmethod
    def forward(ctx, x, s):
        ctx.save_for_backward(x, s)
        return _mod(s, x)

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        rem = torch.fmod(s, x)
        back = (rem != 0) & (torch.sign(rem) != torch.sign(x))
        return torch.where(back, g, torch.zeros_like(g)) - \
            g * torch.trunc(s / x), None


def _rmod(x, s):
    s = _scalar(x, s)
    if torch.is_grad_enabled() and x.requires_grad:
        return _RMod.apply(x, s)
    return _mod(s, x)


class _NoPath(torch.autograd.Function):
    """``value`` as an output of ``x`` whose gradient is zero: what jax's
    vjp gives for stop_gradient, zeros_like and ones_like, so a
    backward from such an output writes zeros into x's gradient, as in
    mxtpu, instead of finding no graph."""

    @staticmethod
    def forward(ctx, x, value):
        return value

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g), None


def _no_path(fn):
    def rule(x):
        value = fn(x)
        if torch.is_grad_enabled() and x.requires_grad:
            return _NoPath.apply(x, value)
        return value
    return rule


# ----------------------------------------------------------------------
# unary elementwise
# ----------------------------------------------------------------------
_UNARY = {
    "abs": _Abs.apply, "negative": torch.neg, "sign": _sign,
    "reciprocal": torch.reciprocal, "square": torch.square,
    "sqrt": torch.sqrt, "rsqrt": torch.rsqrt, "exp": torch.exp,
    "log": torch.log, "relu": torch.relu, "sigmoid": torch.sigmoid,
    "tanh": torch.tanh, "floor": torch.floor, "ceil": torch.ceil,
    "identity": lambda x: x,
}
for _name, _fn in _UNARY.items():
    register_op(_name, differentiable=_name not in ("sign", "floor",
                                                    "ceil"),
                doc=f"elementwise {_name}")((lambda f: lambda x: f(x))(_fn))

register_op("_copy", aliases=("copy",))(lambda x: x.clone())
register_op("BlockGrad", aliases=("stop_gradient",))(
    _no_path(lambda x: x.detach()))
register_op("zeros_like")(_no_path(torch.zeros_like))
register_op("ones_like")(_no_path(torch.ones_like))

# ----------------------------------------------------------------------
# binary broadcast and scalar families
# ----------------------------------------------------------------------
_BINARY = {
    "broadcast_add": (torch.add, True, ("elemwise_add", "_plus")),
    "broadcast_sub": (torch.sub, True, ("elemwise_sub", "_minus")),
    "broadcast_mul": (torch.mul, True, ("elemwise_mul", "_mul")),
    "broadcast_div": (torch.div, True, ("elemwise_div", "_div")),
    "broadcast_mod": (_mod, True, ("_mod",)),
    "broadcast_power": (_Pow.apply, True, ("_power", "pow")),
    "broadcast_maximum": (torch.maximum, True, ("maximum", "_maximum")),
    "broadcast_minimum": (torch.minimum, True, ("minimum", "_minimum")),
    "broadcast_equal": (lambda a, b: _flag(a, a == b), False, ("_equal",)),
    "broadcast_not_equal": (lambda a, b: _flag(a, a != b), False,
                            ("_not_equal",)),
    "broadcast_greater": (lambda a, b: _flag(a, a > b), False,
                          ("_greater",)),
    "broadcast_greater_equal": (lambda a, b: _flag(a, a >= b), False,
                                ("_greater_equal",)),
    "broadcast_lesser": (lambda a, b: _flag(a, a < b), False,
                         ("_lesser",)),
    "broadcast_lesser_equal": (lambda a, b: _flag(a, a <= b), False,
                               ("_lesser_equal",)),
}
for _name, (_fn, _diff, _aliases) in _BINARY.items():
    register_op(_name, num_inputs=2, differentiable=_diff,
                aliases=_aliases)((lambda f: lambda a, b: f(a, b))(_fn))

# tensor∘scalar with the scalar a typed param, so Symbol graphs carry
# scalar arithmetic the way the reference does
_SCALAR = {
    "_plus_scalar": (lambda x, s: x + s, True, ("_PlusScalar",)),
    "_minus_scalar": (lambda x, s: x - s, True, ("_MinusScalar",)),
    "_rminus_scalar": (lambda x, s: s - x, True, ("_RMinusScalar",)),
    "_mul_scalar": (lambda x, s: x * s, True, ("_MulScalar",)),
    "_div_scalar": (lambda x, s: x / s, True, ("_DivScalar",)),
    "_rdiv_scalar": (lambda x, s: s / x, True, ("_RDivScalar",)),
    "_mod_scalar": (lambda x, s: torch.remainder(x, s), True, ()),
    "_rmod_scalar": (_rmod, True, ()),
    "_power_scalar": (lambda x, s: _Pow.apply(x, _scalar(x, s)), True,
                      ("_PowerScalar",)),
    "_rpower_scalar": (lambda x, s: _Pow.apply(_scalar(x, s), x), True,
                       ("_RPowerScalar",)),
    # torch.maximum/minimum pass half the gradient to each side of a
    # tie, as jnp.maximum/minimum do (clamp_min/clamp_max pass it all)
    "_maximum_scalar": (lambda x, s: torch.maximum(x, _scalar(x, s)),
                        True, ("_MaximumScalar",)),
    "_minimum_scalar": (lambda x, s: torch.minimum(x, _scalar(x, s)),
                        True, ("_MinimumScalar",)),
    "_equal_scalar": (lambda x, s: _scalar_flag(x, x == s), False, ()),
    "_not_equal_scalar": (lambda x, s: _scalar_flag(x, x != s), False, ()),
    "_greater_scalar": (lambda x, s: _scalar_flag(x, x > s), False, ()),
    "_greater_equal_scalar": (lambda x, s: _scalar_flag(x, x >= s), False,
                              ()),
    "_lesser_scalar": (lambda x, s: _scalar_flag(x, x < s), False, ()),
    "_lesser_equal_scalar": (lambda x, s: _scalar_flag(x, x <= s), False,
                             ()),
}
for _name, (_fn, _diff, _aliases) in _SCALAR.items():
    register_op(_name, params=[Param("scalar", float, 0.0)],
                differentiable=_diff, aliases=_aliases)(
        (lambda f: lambda x, scalar=0.0: f(x, scalar))(_fn))


def _smooth_l1(x, scalar=1.0):
    """0.5 (scalar x)^2 where |x| < 1/scalar^2, else |x| - 0.5/scalar^2
    (``mxtpu/ndarray/ops_impl.py:173``); torch autograd gives jnp.where's
    gradient, the taken branch's."""
    ax = torch.abs(x)
    return torch.where(ax < 1.0 / (scalar ** 2), 0.5 * (scalar * x) ** 2,
                       ax - 0.5 / (scalar ** 2))


register_op("smooth_l1", params=[Param("scalar", float, 1.0)])(_smooth_l1)

# ----------------------------------------------------------------------
# reductions
# ----------------------------------------------------------------------


def _reduce(name, fn, diff=True):
    def rule(x, axis=None, keepdims=False, exclude=False):
        # mxtpu's axis arithmetic: ``exclude`` keeps the axes as written,
        # so a negative one matches no index and every axis goes; an
        # empty tuple reduces nothing (torch would reduce every axis)
        ax = _norm_axis(axis)
        if exclude and ax is not None:
            kept = (ax,) if isinstance(ax, int) else ax
            ax = tuple(i for i in range(x.ndim) if i not in kept)
        if ax is None:
            ax = tuple(range(x.ndim))
        elif isinstance(ax, int):
            ax = (ax,)
        if not ax:
            return fn(x, None, False)
        return fn(x, ax, bool(keepdims))
    register_op(name, params=[Param("axis", tuple, None),
                              Param("keepdims", bool, False),
                              Param("exclude", bool, False)],
                differentiable=diff)(rule)


def _sum(x, ax, k):
    # jnp.sum of an integer or bool array of at most 32 bits is int32
    dt = torch.int32 if not x.is_floating_point() and \
        x.dtype != torch.uint8 and x.element_size() <= 4 else None
    if ax is None:
        return x.to(dt or x.dtype, copy=True)
    return torch.sum(x, dim=ax, keepdim=k, dtype=dt)


def _mean(x, ax, k):
    x = _float_of(x)
    return x.clone() if ax is None else torch.mean(x, dim=ax, keepdim=k)


_reduce("sum", _sum)
_reduce("mean", _mean)
_reduce("max", lambda x, ax, k: x.clone() if ax is None
        else torch.amax(x, dim=ax, keepdim=k))
_reduce("min", lambda x, ax, k: x.clone() if ax is None
        else torch.amin(x, dim=ax, keepdim=k))


def _arg(fn):
    def rule(x, axis=None, keepdims=False):
        if axis is None:
            out = fn(x.reshape(-1))
            if keepdims:
                out = out.reshape((1,) * x.ndim)
            return out.to(torch.float32)
        ax = int(axis[0]) if isinstance(axis, tuple) else int(axis)
        return fn(x, dim=ax, keepdim=keepdims).to(torch.float32)
    return rule


for _name, _fn in (("argmax", torch.argmax), ("argmin", torch.argmin)):
    register_op(_name, params=[Param("axis", tuple, None),
                               Param("keepdims", bool, False)],
                differentiable=False)(_arg(_fn))

# ----------------------------------------------------------------------
# shape and layout
# ----------------------------------------------------------------------


def _reshape(x, shape=None):
    """The reference's special codes: 0 keeps a dim, -1 infers one."""
    out = [x.shape[i] if s == 0 else int(s) for i, s in
           enumerate(tuple(shape))]
    return x.reshape(tuple(out))


register_op("reshape", params=[Param("shape", tuple, None)],
            aliases=("Reshape",))(_reshape)
register_op("transpose", params=[Param("axes", tuple, None)])(
    lambda x, axes=None: x.permute(
        tuple(axes) if axes else tuple(reversed(range(x.ndim)))))
register_op("expand_dims", params=[Param("axis", int, 0)])(
    lambda x, axis=0: x.unsqueeze(axis))


def _squeeze(x, axis=None):
    """jnp.squeeze: an axis given must have size 1 (ValueError
    otherwise; torch would leave it)."""
    ax = _norm_axis(axis)
    if ax is None:
        return x.squeeze()
    ax = (ax,) if isinstance(ax, int) else ax
    for a in ax:
        if not -x.ndim <= a < x.ndim or x.shape[a] != 1:
            raise ValueError(
                f"cannot squeeze axis {a} of shape {tuple(x.shape)}: its "
                f"size is not one")
    return x.squeeze(tuple(a % x.ndim for a in ax))


register_op("squeeze", params=[Param("axis", tuple, None)])(_squeeze)


def _clip(x, a_min=None, a_max=None):
    """jnp.clip as maximum, then minimum: half the gradient at a tie with
    a bound, as jnp.clip passes (torch.clamp passes all of it)."""
    if a_min is not None:
        x = torch.maximum(x, _scalar(x, a_min))
    if a_max is not None:
        x = torch.minimum(x, _scalar(x, a_max))
    return x


def _cast(x, dtype="float32"):
    """``astype`` as in mxtpu, which runs with jax's 64-bit types off:
    float64 and int64 give float32 and int32.  A float to an integer
    saturates at the target's range and takes NaN to 0, as XLA's convert
    does (torch wraps)."""
    td = torch_dtype(dtype)
    td = _NARROW.get(td, td)
    if x.is_floating_point() and not td.is_floating_point and \
            td != torch.bool:
        info = torch.iinfo(td)
        x = torch.nan_to_num(x.double(), nan=0.0).clamp(info.min, info.max)
    return x.to(td)


register_op("flatten", aliases=("Flatten",))(
    lambda x: x.reshape(x.shape[0], -1))
register_op("concat", num_inputs=-1, params=[Param("dim", int, 1)],
            aliases=("Concat",))(lambda *xs, dim=1: torch.cat(xs, dim=dim))
register_op("stack", num_inputs=-1, params=[Param("axis", int, 0)])(
    lambda *xs, axis=0: torch.stack(xs, dim=axis))


def _arange(start=0.0, stop=None, step=1.0, repeat=1, infer_range=False,
            dtype=None, device=None):
    """``jnp.arange`` (``stop`` None counts from 0 to ``start``), each
    value ``repeat`` times (``ops_extra.py:54-68``); float32 unless
    ``dtype``.  ``infer_range`` is accepted and unused, as in mxtpu."""
    if stop is None:
        start, stop = 0.0, start
    a = torch.arange(start, stop, step, dtype=torch_dtype(dtype),
                     device=device)
    return a.repeat_interleave(repeat) if repeat != 1 else a


register_op("_arange", num_inputs=0, differentiable=False,
            params=[Param("start", float, 0.0),
                    Param("stop", float, None),
                    Param("step", float, 1.0),
                    Param("repeat", int, 1),
                    Param("infer_range", bool, False),
                    Param("dtype", str, None)])(_arange)
register_op("clip", params=[Param("a_min", float, None),
                            Param("a_max", float, None)])(_clip)
register_op("cast", params=[Param("dtype", str, "float32")],
            aliases=("Cast",))(_cast)

# ----------------------------------------------------------------------
# neural-net ops
# ----------------------------------------------------------------------


def _fully_connected(data, weight, *maybe_bias, num_hidden=0,
                     no_bias=False, flatten=True):
    x = data.reshape(data.shape[0], -1) if flatten and data.ndim > 2 \
        else data
    if _amp.matmul_preferred(x, weight) is not None:
        # bf16 operands under autocast: f32 output and accumulation,
        # both directions (mxtpu/ndarray/ops_impl.py:677-680)
        y = _amp.dense(x, weight)
    else:
        y = torch.matmul(x, weight.t())
    if maybe_bias and not no_bias:
        y = y + maybe_bias[0]
    return y


register_op("FullyConnected", num_inputs=-1,
            params=[Param("num_hidden", int, 0),
                    Param("no_bias", bool, False),
                    Param("flatten", bool, True)],
            aliases=("fully_connected",))(_fully_connected)

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _convolution(data, weight, *maybe_bias, kernel=(), stride=None,
                 dilate=None, pad=None, num_filter=0, num_group=1,
                 no_bias=False, layout=None):
    """N-d convolution in the reference's layouts: channels-first
    (weights OI<spatial>) or channels-last (weights O<spatial>I, run on
    permuted channels-first views)."""
    nd = len(kernel)
    layout = layout or {1: "NCW", 2: "NCHW", 3: "NCDHW"}[nd]
    bias = maybe_bias[0] if maybe_bias and not no_bias else None
    if _amp.matmul_preferred(data, weight) is not None:
        # bf16 operands under autocast: f32 output and accumulation,
        # both directions (mxtpu/ndarray/ops_impl.py:711-717); the bias
        # adds in f32
        out = _amp.conv(data, weight, kernel, _tuple(stride, nd),
                        _tuple(pad, nd) if pad is not None else (0,) * nd,
                        _tuple(dilate, nd), num_group, layout)
        if bias is None:
            return out
        return out + (bias if layout.endswith("C")
                      else bias.reshape((1, -1) + (1,) * nd))
    last = layout.endswith("C")
    if last:
        perm = (0, nd + 1) + tuple(range(1, nd + 1))
        data, weight = data.permute(perm), weight.permute(perm)
    out = _CONV[nd](data, weight, bias, _tuple(stride, nd),
                    _tuple(pad, nd) if pad is not None else 0,
                    _tuple(dilate, nd), num_group)
    if last:
        out = out.permute((0,) + tuple(range(2, nd + 2)) + (1,))
    return out


register_op("Convolution", num_inputs=-1,
            params=[Param("kernel", tuple, ()),
                    Param("stride", tuple, None),
                    Param("dilate", tuple, None),
                    Param("pad", tuple, None),
                    Param("num_filter", int, 0),
                    Param("num_group", int, 1),
                    Param("no_bias", bool, False),
                    Param("layout", str, None)],
            aliases=("convolution", "Convolution_v1"))(_convolution)

_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _deconvolution(data, weight, *maybe_bias, kernel=(), stride=None,
                   dilate=None, pad=None, adj=None, num_filter=0,
                   num_group=1, no_bias=False, layout=None):
    """The transposed convolution as mxtpu's ``_deconvolution``
    (``lax.conv_transpose(transpose_kernel=True)``): weights (in,
    out/g, *k), or (in, *k, out/g) channels last; the output is (in -
    1)·stride + dilate·(k - 1) + 1 - 2·pad a side.  mxtpu pads the
    dilated input by dilate·(k - 1) - pad, which crops where pad is
    larger: here torch pads by at most dilate·(k - 1) and the rest is
    cropped off.  As in mxtpu, ``adj`` is ignored and ``num_group`` is
    not passed on: the weights' second axis is the output's width (a
    bias of ``num_filter`` then fails to broadcast, as it does in
    mxtpu)."""
    nd = len(kernel)
    layout = layout or {1: "NCW", 2: "NCHW", 3: "NCDHW"}[nd]
    last = not layout.startswith("NC")
    stride, dil = _tuple(stride, nd), _tuple(dilate, nd)
    pad = _tuple(pad, nd) if pad is not None else (0,) * nd
    if last:
        perm = (0, nd + 1) + tuple(range(1, nd + 1))
        data, weight = data.permute(perm), weight.permute(perm)
    full = tuple(d * (int(k) - 1) for d, k in zip(dil, kernel))
    tpad = tuple(min(p, f) for p, f in zip(pad, full))
    out = _CONV_T[nd](data, weight, None, stride, tpad, 0, 1, dil)
    crop = [p - t for p, t in zip(pad, tpad)]
    if any(crop):
        out = out[(slice(None), slice(None)) + tuple(
            slice(c, out.shape[2 + i] - c) for i, c in enumerate(crop))]
    if maybe_bias and not no_bias:
        b = maybe_bias[0]
        if b.shape[0] != out.shape[1]:
            raise TypeError(
                f"add got incompatible shapes for broadcasting: "
                f"{tuple(out.shape)}, {(1, b.shape[0]) + (1,) * nd}")
        out = out + b.reshape((1, -1) + (1,) * nd)
    if last:
        out = out.permute((0,) + tuple(range(2, nd + 2)) + (1,))
    return out


register_op("Deconvolution", num_inputs=-1,
            params=[Param("kernel", tuple, ()),
                    Param("stride", tuple, None),
                    Param("dilate", tuple, None),
                    Param("pad", tuple, None),
                    Param("adj", tuple, None),
                    Param("num_filter", int, 0),
                    Param("num_group", int, 1),
                    Param("no_bias", bool, False),
                    Param("layout", str, None)])(_deconvolution)

_AVG = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}
_MAX = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _window_sum(x, k, s, p):
    """The sum over each window, zero padding (mxtpu's ``reduce_window``
    with ``lax.add``): an average pool with divisor 1, 1-D as 2-D (the
    1-D pool takes no divisor)."""
    if len(k) == 1:
        return F.avg_pool2d(x.unsqueeze(-2), (1,) + k, (1,) + s, (0,) + p,
                            divisor_override=1).squeeze(-2)
    return _AVG[len(k)](x, k, s, p, divisor_override=1)


def _pooling(x, kernel=(), pool_type="max", global_pool=False, stride=None,
             pad=None, count_include_pad=True, layout=None):
    # case for case mxtpu's _pooling: a global pool other than max is the
    # mean (sum and lp too); a windowed sum ignores count_include_pad;
    # lp is sqrt of the windowed sum of squares
    nd = len(kernel) if kernel else x.ndim - 2
    if nd == 3 and x.dtype == torch.bfloat16 and x.device.type == "cpu" \
            and pool_type != "max":
        # torch's 3-D average pool has no bf16 kernel on the CPU: pool in
        # f32 and round once (the card's takes bf16 as it is)
        return _pooling(x.float(), kernel, pool_type, global_pool, stride,
                        pad, count_include_pad, layout).to(x.dtype)
    layout = layout or {1: "NCW", 2: "NCHW", 3: "NCDHW"}[nd]
    last = layout.endswith("C")
    sp = tuple(range(1, 1 + nd)) if last else tuple(range(2, 2 + nd))
    if global_pool:
        if pool_type == "max":
            return torch.amax(x, dim=sp, keepdim=True)
        return torch.mean(x, dim=sp, keepdim=True)
    if pool_type not in ("max", "avg", "sum", "lp"):
        raise MXNetError(f"pool_type {pool_type} unsupported")
    if last:
        x = x.permute((0, nd + 1) + tuple(range(1, nd + 1)))
    k, s = _tuple(kernel, nd), _tuple(stride, nd)
    p = _tuple(pad, nd) if pad is not None else (0,) * nd
    ones = None
    if any(2 * pi > ki for pi, ki in zip(p, k)):
        # torch pools refuse a pad above half the window: pad here
        # (-inf for max, zeros otherwise) and pool without
        pads = [v for pi in reversed(p) for v in (pi, pi)]
        if pool_type == "avg" and not count_include_pad:
            ones = F.pad(torch.ones_like(x), pads)
        x = F.pad(x, pads, value=-math.inf if pool_type == "max" else 0.0)
        p = (0,) * nd
    if pool_type == "max":
        out = _MAX[nd](x, k, s, p)
    elif pool_type == "sum":
        out = _window_sum(x, k, s, p)
    elif pool_type == "lp":
        out = torch.sqrt(_window_sum(x * x, k, s, p))
    elif ones is not None:
        out = _window_sum(x, k, s, p) / _window_sum(ones, k, s, p)
    else:
        out = _AVG[nd](x, k, s, p, count_include_pad=count_include_pad)
    if last:
        out = out.permute((0,) + tuple(range(2, nd + 2)) + (1,))
    return out


register_op("Pooling",
            params=[Param("kernel", tuple, ()),
                    Param("pool_type", str, "max",
                          enum=("max", "avg", "sum", "lp")),
                    Param("global_pool", bool, False),
                    Param("stride", tuple, None),
                    Param("pad", tuple, None),
                    Param("count_include_pad", bool, True),
                    Param("layout", str, None)],
            aliases=("pooling", "Pooling_v1"))(_pooling)

_ACTS = {"relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
         "softrelu": F.softplus, "softsign": F.softsign}
register_op("Activation", params=[
    Param("act_type", str, "relu",
          enum=("relu", "sigmoid", "tanh", "softrelu", "softsign"))],
    aliases=("activation",))(lambda x, act_type="relu": _ACTS[act_type](x))

register_op("softmax", params=[Param("axis", int, -1),
                               Param("temperature", tuple, None)])(
    lambda x, axis=-1, temperature=None: torch.softmax(
        _float_of(x) if temperature in (None, ()) or
        float(temperature[0]) == 1.0
        else _float_of(x) / float(temperature[0]), dim=axis))
register_op("log_softmax", params=[Param("axis", int, -1)])(
    lambda x, axis=-1: torch.log_softmax(_float_of(x), dim=axis))


class _SoftmaxOutput(torch.autograd.Function):
    """The reference's loss head: softmax forward; backward
    ``grad_scale * (softmax - onehot(label))``, normalized as asked,
    ignoring the incoming cotangent (``ops_impl.py:907-935``)."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, use_ignore,
                normalization):
        out = torch.softmax(data, dim=-1)
        ctx.save_for_backward(out, label)
        ctx.cfg = (grad_scale, ignore_label, use_ignore, normalization)
        return out

    @staticmethod
    def backward(ctx, _g):
        out, label = ctx.saved_tensors
        grad_scale, ignore_label, use_ignore, normalization = ctx.cfg
        # a label outside [0, C) (the ignored -1 or C) has a zero one-hot
        # row, as jax.nn.one_hot gives mxtpu's _so_bwd
        C = out.shape[-1]
        lab = label.long()
        onehot = F.one_hot(lab.clamp(0, C - 1), C).to(out.dtype) * \
            ((lab >= 0) & (lab < C)).unsqueeze(-1).to(out.dtype)
        grad = (out - onehot) * grad_scale
        valid = None
        if use_ignore:
            keep = label != ignore_label
            grad = grad * keep.unsqueeze(-1).to(grad.dtype)
            valid = keep.sum().clamp_min(1)
        if normalization == "valid":
            grad = grad / (valid if valid is not None else label.numel())
        elif normalization == "batch":
            grad = grad / label.shape[0]
        return grad, None, None, None, None, None


def _softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                    use_ignore=False, multi_output=False,
                    preserve_shape=False, normalization="null"):
    if multi_output:
        raise MXNetError("SoftmaxOutput multi_output=True (softmax over "
                         "axis 1) is not implemented yet — reshape to "
                         "(N*d, C) and use the default mode")
    return _SoftmaxOutput.apply(data, label, grad_scale, ignore_label,
                                use_ignore, normalization)


register_op("SoftmaxOutput", num_inputs=2,
            params=[Param("grad_scale", float, 1.0),
                    Param("ignore_label", float, -1.0),
                    Param("use_ignore", bool, False),
                    Param("multi_output", bool, False),
                    Param("preserve_shape", bool, False),
                    Param("normalization", str, "null")],
            aliases=("Softmax",))(_softmax_output)


def _batch_norm(x, gamma, beta, moving_mean, moving_var, eps=1e-5,
                momentum=0.9, fix_gamma=True, use_global_stats=False,
                output_mean_var=False, axis=1):
    """Normalize over every axis but ``axis``; returns (out, mean, var).
    As in the JAX package (``ops_impl.py:1074-1082``) the op never
    updates ``moving_mean``/``moving_var``: with
    ``use_global_stats=False`` it normalizes by the batch statistics in
    training and inference alike and returns them, and with
    ``use_global_stats=True`` it normalizes by the moving ones."""
    axis %= x.ndim
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if use_global_stats:
        sh = [1] * x.ndim
        sh[axis] = -1
        mean, var = moving_mean.float(), moving_var.float()
        scale = g.float() * torch.rsqrt(var + eps)
        out = (x.float() - mean.reshape(sh)) * scale.reshape(sh) + \
            beta.float().reshape(sh)
        return out.to(x.dtype), mean, var
    if x.device.type == "meta":   # shape inference
        return _bn.bn_act_reference(x, g, beta, eps, axis=axis)
    return _bn.fused_bn_act(x, g, beta, eps=eps, axis=axis)


register_op("BatchNorm", num_inputs=5, num_outputs=3,
            params=[Param("eps", float, 1e-5),
                    Param("momentum", float, 0.9),
                    Param("fix_gamma", bool, True),
                    Param("use_global_stats", bool, False),
                    Param("output_mean_var", bool, False),
                    Param("axis", int, 1)],
            aliases=("batch_norm", "BatchNorm_v1"))(_batch_norm)


# ----------------------------------------------------------------------
# the ops gluon's layers, losses and BERT call (``ops_impl.py:248-448``,
# ``:875``, ``:985-1210``).  LayerNorm, BatchNormRelu/BatchNormAddRelu
# and FusedResidualLayerNorm run the port's kernels on a CUDA tensor
# (their plain versions on the CPU; no fallback between the two); the
# rest is torch glue, as mxtpu leaves it to XLA.
# ----------------------------------------------------------------------
register_op("reshape_like", num_inputs=2)(lambda x, y: x.reshape(y.shape))


def _end_of(end, n):
    if isinstance(end, tuple):
        end = end[0] if end else None
    return n if end is None else int(end)


def _slice_axis(x, axis=0, begin=0, end=None):
    """``lax.slice_in_dim``: negative bounds count from the end."""
    n = x.shape[axis]
    b, e = int(begin), _end_of(end, n)
    b, e = b + n if b < 0 else b, e + n if e < 0 else e
    return x.narrow(axis, b, e - b)


register_op("slice_axis", params=[Param("axis", int, 0),
                                  Param("begin", int, 0),
                                  Param("end", tuple, None)])(_slice_axis)


def _slice_like(x, y, axes=()):
    """x sliced to y's sizes on ``axes`` (every axis when empty)."""
    return x[tuple(
        slice(0, y.shape[i]) if (not axes or i in axes or
                                 (i - x.ndim) in axes) else slice(None)
        for i in range(x.ndim))]


register_op("slice_like", num_inputs=2,
            params=[Param("axes", tuple, ())])(_slice_like)


def _pad(x, mode="constant", pad_width=None, constant_value=0.0):
    """``jnp.pad`` on (before, after) pairs per axis, leading axes
    first; "edge" repeats the border and "reflect" mirrors without it,
    both by index so every axis may be padded."""
    pw = tuple(int(v) for v in pad_width)
    pairs = [(pw[2 * i], pw[2 * i + 1]) for i in range(len(pw) // 2)]
    if mode == "constant":
        flat = [v for lo, hi in reversed(pairs) for v in (lo, hi)]
        return F.pad(x, flat, value=float(constant_value))
    for ax, (lo, hi) in enumerate(pairs):
        if not lo and not hi:
            continue
        n = x.shape[ax]
        i = torch.arange(-lo, n + hi, device=x.device)
        if mode == "edge":
            i = i.clamp(0, n - 1)
        else:
            i = i.abs()
            i = torch.where(i > n - 1, 2 * (n - 1) - i, i)
        x = x.index_select(ax, i)
    return x


register_op("pad", params=[Param("mode", str, "constant",
                                 enum=("constant", "edge", "reflect")),
                           Param("pad_width", tuple, ()),
                           Param("constant_value", float, 0.0)],
            aliases=("Pad",))(_pad)


def _take(a, indices, axis=0, mode="clip"):
    """``jnp.take`` with int32-truncated indices, clipped or wrapped
    (mxtpu maps "raise" to "wrap")."""
    n = a.shape[axis]
    idx = indices.to(torch.int64)
    idx = idx.clamp(0, n - 1) if mode == "clip" else torch.remainder(idx, n)
    out = a.index_select(axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


register_op("take", num_inputs=2,
            params=[Param("axis", int, 0),
                    Param("mode", str, "clip",
                          enum=("clip", "wrap", "raise"))])(_take)


def _embedding(data, weight, input_dim=0, output_dim=0, dtype="float32",
               sparse_grad=False):
    """Rows of ``weight`` at the ids (float ids truncate to integers,
    as ``astype(int32)``), in ``jnp.take``'s fill mode: an id in
    [-V, 0) counts from the end, any other id outside [0, V) gives a
    NaN row and adds nothing to the gradient.  The gather reads a
    clamped index, so no id reads out of bounds (on the card that would
    be a device-side assert, fatal to the process's CUDA context)."""
    V = weight.shape[0]
    ids = data.to(torch.int64)
    ids = torch.where(ids < 0, ids + V, ids)
    valid = ((ids >= 0) & (ids < V)).unsqueeze(-1)
    rows = weight[ids.clamp(0, V - 1)]
    return torch.where(valid, rows, torch.full_like(rows, math.nan))


register_op("Embedding", num_inputs=2,
            params=[Param("input_dim", int, 0),
                    Param("output_dim", int, 0),
                    Param("dtype", str, "float32"),
                    Param("sparse_grad", bool, False)],
            aliases=("embedding",))(_embedding)


def _pick(data, index, axis=(-1,), keepdims=False, mode="clip"):
    ax = int(axis[0]) if isinstance(axis, tuple) else int(axis)
    idx = index.to(torch.int64).clamp(0, data.shape[ax] - 1)
    out = data.gather(ax % data.ndim, idx.unsqueeze(ax))
    return out if keepdims else out.squeeze(ax)


register_op("pick", num_inputs=2,
            params=[Param("axis", tuple, (-1,)),
                    Param("keepdims", bool, False),
                    Param("mode", str, "clip")])(_pick)

register_op("where", num_inputs=3)(
    lambda cond, x, y: torch.where(cond.bool(), x, y))


# ----------------------------------------------------------------------
# sequence ops (``ops_impl.py:451-500``): time on ``axis`` (0 or 1), the
# batch on the other; ``sequence_length`` truncated to integers
# ----------------------------------------------------------------------
def _steps_of(data, seq_len, axis):
    """(T, N) or (N, T) positions and lengths, broadcast to ``data``'s
    trailing axes."""
    T = data.shape[axis]
    pos = torch.arange(T, device=data.device)
    sl = seq_len.to(torch.int32).to(torch.int64)
    pos, sl = (pos[:, None], sl[None, :]) if axis == 0 else \
        (pos[None, :], sl[:, None])
    tail = (1,) * (data.ndim - 2)
    return pos.reshape(pos.shape + tail), sl.reshape(sl.shape + tail)


def _sequence_mask(data, *seq, use_sequence_length=False, value=0.0,
                   axis=0):
    """``value`` where the step is at or past the row's length."""
    if not (use_sequence_length and seq):
        return data
    pos, sl = _steps_of(data, seq[0], axis)
    return torch.where(pos < sl, data,
                       torch.tensor(value, dtype=data.dtype,
                                    device=data.device))


def _take_fill(data, axis, idx):
    """``jnp.take_along_axis``'s rule: an index below 0 counts from the
    end, one still outside [0, T) reads NaN."""
    T = data.shape[axis]
    idx = torch.where(idx < 0, idx + T, idx)
    ok = (idx >= 0) & (idx < T)
    out = data.gather(axis, idx.clamp(0, T - 1).expand(
        *[s if d == axis else data.shape[d]
          for d, s in enumerate(idx.shape)]))
    return torch.where(ok, out, torch.tensor(float("nan"), dtype=data.dtype,
                                             device=data.device))


def _sequence_last(data, *seq, use_sequence_length=False, axis=0):
    """The step at each row's length - 1 (the last step without
    lengths)."""
    if not (use_sequence_length and seq):
        return data.select(axis, data.shape[axis] - 1)
    idx = seq[0].to(torch.int32).to(torch.int64) - 1
    shape = ((1, -1) if axis == 0 else (-1, 1)) + (1,) * (data.ndim - 2)
    return _take_fill(data, axis, idx.reshape(shape)).squeeze(axis)


def _sequence_reverse(data, *seq, use_sequence_length=False, axis=0):
    """Each row's first ``length`` steps reversed, the rest in place (all
    steps without lengths)."""
    if not (use_sequence_length and seq):
        return data.flip(axis)
    pos, sl = _steps_of(data, seq[0], axis)
    return _take_fill(data, axis, torch.where(pos < sl, sl - 1 - pos, pos))


register_op("SequenceMask", num_inputs=-1,
            params=[Param("use_sequence_length", bool, False),
                    Param("value", float, 0.0),
                    Param("axis", int, 0)])(_sequence_mask)
register_op("SequenceLast", num_inputs=-1,
            params=[Param("use_sequence_length", bool, False),
                    Param("axis", int, 0)])(_sequence_last)
register_op("SequenceReverse", num_inputs=-1,
            params=[Param("use_sequence_length", bool, False),
                    Param("axis", int, 0)])(_sequence_reverse)

_SELU_ALPHA, _SELU_SCALE = 1.6732632423543772, 1.0507009873554805


def _leaky_relu(x, *extra, act_type="leaky", slope=0.25, lower_bound=0.125,
                upper_bound=0.334):
    if act_type == "leaky":
        return torch.where(x > 0, x, slope * x)
    if act_type == "prelu":
        gamma = extra[0]
        if gamma.ndim == 1 and x.ndim > 1:
            gamma = gamma.reshape((1, -1) + (1,) * (x.ndim - 2))
        return torch.where(x > 0, x, gamma * x)
    if act_type == "elu":
        return torch.where(x > 0, x, slope * (torch.exp(x) - 1.0))
    if act_type == "selu":
        return _SELU_SCALE * torch.where(
            x > 0, x, _SELU_ALPHA * (torch.exp(x) - 1.0))
    if act_type == "gelu":
        return F.gelu(x, approximate="tanh")
    if act_type == "rrelu":
        return torch.where(x > 0, x, (lower_bound + upper_bound) / 2.0 * x)
    raise MXNetError(f"LeakyReLU act_type {act_type} unsupported")


register_op("LeakyReLU", num_inputs=-1,
            params=[Param("act_type", str, "leaky",
                          enum=("leaky", "prelu", "elu", "selu", "gelu",
                                "rrelu")),
                    Param("slope", float, 0.25),
                    Param("lower_bound", float, 0.125),
                    Param("upper_bound", float, 0.334)])(_leaky_relu)


def _layer_norm(x, gamma, beta, axis=-1, eps=1e-5):
    """Over the last axis the LayerNorm kernels (#4, #5); over another
    axis the composite, as mxtpu's op."""
    if axis in (-1, x.ndim - 1):
        if x.device.type == "meta":   # shape inference
            return torch.empty_like(x)
        return _ln_kernel(x.contiguous(), gamma, beta, eps)
    mean = x.mean(dim=axis, keepdim=True)
    var = (x - mean).square().mean(dim=axis, keepdim=True)
    shape = [1] * x.ndim
    shape[axis] = x.shape[axis]
    return (x - mean) * torch.rsqrt(var + eps) * gamma.reshape(shape) + \
        beta.reshape(shape)


register_op("LayerNorm", num_inputs=3,
            params=[Param("axis", int, -1), Param("eps", float, 1e-5)])(
    _layer_norm)


def _instance_norm(x, gamma, beta, eps=1e-3):
    axes = tuple(range(2, x.ndim))
    mean = x.mean(dim=axes, keepdim=True)
    var = (x - mean).square().mean(dim=axes, keepdim=True)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return (x - mean) * torch.rsqrt(var + eps) * gamma.reshape(shape) + \
        beta.reshape(shape)


register_op("InstanceNorm", num_inputs=3,
            params=[Param("eps", float, 1e-3)])(_instance_norm)


def _batch_norm_fused_act(x, gamma, beta, moving_mean, moving_var,
                          residual=None, eps=1e-5, momentum=0.9,
                          fix_gamma=True, use_global_stats=False, axis=1):
    """BatchNorm, then the residual add, then ReLU: with the batch
    statistics the fused BatchNorm kernels (#8-#11, channels-major or
    -minor by ``axis``), with the moving ones the composite."""
    axis %= x.ndim
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if use_global_stats:
        sh = [1] * x.ndim
        sh[axis] = -1
        mean, var = moving_mean.float(), moving_var.float()
        scale = g.float() * torch.rsqrt(var + eps)
        out = (x.float() - mean.reshape(sh)) * scale.reshape(sh) + \
            beta.float().reshape(sh)
        if residual is not None:
            out = out + residual.float()
        return out.clamp_min(0.0).to(x.dtype), mean, var
    if x.device.type == "meta":   # shape inference
        return _bn.bn_act_reference(x, g, beta, eps, "relu", residual,
                                    axis)
    return _bn.fused_bn_act(x, g, beta, eps=eps, act="relu",
                            residual=residual, axis=axis)


_BN_ACT_PARAMS = [Param("eps", float, 1e-5),
                  Param("momentum", float, 0.9),
                  Param("fix_gamma", bool, True),
                  Param("use_global_stats", bool, False),
                  Param("axis", int, 1)]

register_op("BatchNormRelu", num_inputs=5, num_outputs=3,
            params=_BN_ACT_PARAMS)(
    lambda data, gamma, beta, moving_mean, moving_var, **kw:
    _batch_norm_fused_act(data, gamma, beta, moving_mean, moving_var,
                          None, **kw))
# input order (data, addend, gamma, beta, moving_mean, moving_var): the
# addend is the bottleneck's shortcut
register_op("BatchNormAddRelu", num_inputs=6, num_outputs=3,
            params=_BN_ACT_PARAMS)(
    lambda data, addend, gamma, beta, moving_mean, moving_var, **kw:
    _batch_norm_fused_act(data, gamma, beta, moving_mean, moving_var,
                          addend, **kw))


def _dropout(x, key=None, p=0.5, mode="training", axes=()):
    """Inverted dropout in "training" mode: an element (or, along
    ``axes``, a broadcast slice) is kept with probability ``1 - p`` and
    scaled by ``1 / (1 - p)``.  The key input keeps mxtpu's signature;
    the mask comes from ``mxtpu_torch.random``'s generator of x's
    device (jax's PRNG has no torch counterpart)."""
    if mode != "training" or p <= 0.0:
        return x
    if x.device.type == "meta":   # shape inference draws nothing
        return torch.empty_like(x)
    shape = list(x.shape)
    for ax in axes:
        shape[ax] = 1
    keep = 1.0 - p
    u = torch.rand(shape, generator=_random.generator(x.device),
                   device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


register_op("Dropout", num_inputs=2,
            params=[Param("p", float, 0.5),
                    Param("mode", str, "training"),
                    Param("axes", tuple, ())],
            aliases=("dropout",))(_dropout)


def _fused_residual_ln(h, bias, res, gamma, beta, key, p=0.1, eps=1e-5,
                       mode="training"):
    """``LN(res + dropout(h + bias))`` on the fused kernels (#6, #7).
    ``key`` is mxtpu's key data, two uint32 words: the threefry mask
    they give is mxtpu's bit for bit."""
    if h.device.type == "meta":   # shape inference
        return torch.empty_like(h)
    training = mode == "training"
    return _frln_kernel(
        h.contiguous(), bias, res.contiguous(), gamma, beta,
        key if training and p > 0.0 else None, p=p, eps=eps,
        training=training)


register_op("FusedResidualLayerNorm", num_inputs=6,
            params=[Param("p", float, 0.1), Param("eps", float, 1e-5),
                    Param("mode", str, "training")])(_fused_residual_ln)

from . import rnn_impl  # noqa: E402,F401  (flash_attention)


# ----------------------------------------------------------------------
# optimizer ops (``ops_impl.py:1247-1460``, ``:1727-1780``): functional
# torch rules from optimizer/functional.py, not recorded by autograd
# ----------------------------------------------------------------------
from ..optimizer import functional as _upd  # noqa: E402

_CLIP = [Param("rescale_grad", float, 1.0),
         Param("clip_gradient", float, -1.0)]


def _update_op(name, fn, num_inputs, num_outputs, params):
    register_op(name, num_inputs=num_inputs, num_outputs=num_outputs,
                params=params, differentiable=False)(fn)


_update_op("sgd_update", _upd.sgd_update, 2, 1,
           [Param("lr", float), Param("wd", float, 0.0), *_CLIP])
_update_op("sgd_mom_update", _upd.sgd_mom_update, 3, 2,
           [Param("lr", float), Param("momentum", float, 0.0),
            Param("wd", float, 0.0), *_CLIP])
_update_op("adam_update", _upd.adam_update, 4, 3,
           [Param("lr", float), Param("beta1", float, 0.9),
            Param("beta2", float, 0.999), Param("epsilon", float, 1e-8),
            Param("wd", float, 0.0), *_CLIP])
_update_op("rmsprop_update", _upd.rmsprop_update, 3, 2,
           [Param("lr", float), Param("gamma1", float, 0.9),
            Param("epsilon", float, 1e-8), Param("wd", float, 0.0), *_CLIP,
            Param("clip_weights", float, -1.0)])
_update_op("lamb_update", _upd.lamb_update, 5, 3,
           [Param("lr", float), Param("beta1", float, 0.9),
            Param("beta2", float, 0.999), Param("epsilon", float, 1e-6),
            Param("wd", float, 0.0), *_CLIP,
            Param("bias_correction", bool, True),
            Param("stacked", bool, False)])
_update_op("rmspropalex_update", _upd.rmspropalex_update, 5, 4,
           [Param("lr", float), Param("gamma1", float, 0.95),
            Param("gamma2", float, 0.9), Param("epsilon", float, 1e-8),
            Param("wd", float, 0.0), *_CLIP])
_update_op("ftrl_update", _upd.ftrl_update, 4, 3,
           [Param("lr", float), Param("lamda1", float, 0.01),
            Param("beta", float, 1.0), Param("wd", float, 0.0), *_CLIP])
_update_op("signsgd_update", _upd.signsgd_update, 2, 1,
           [Param("lr", float), Param("wd", float, 0.0), *_CLIP])
_update_op("signum_update", _upd.signum_update, 3, 2,
           [Param("lr", float), Param("momentum", float, 0.9),
            Param("wd", float, 0.0), *_CLIP, Param("wd_lh", float, 0.0)])
for _name, _fn, _k, _extra in (
        ("multi_sgd_update", _upd.multi_sgd_update, 1, []),
        ("multi_sgd_mom_update", _upd.multi_sgd_mom_update, 2,
         [Param("momentum", float, 0.0)])):
    register_op(_name, num_inputs=-1,
                params=[Param("lrs", tuple, ()), Param("wds", tuple, ()),
                        *_extra, *_CLIP, Param("num_weights", int, 1)],
                num_outputs_fn=lambda p, k=_k: k * int(
                    p.get("num_weights", 1)),
                differentiable=False)(_fn)
