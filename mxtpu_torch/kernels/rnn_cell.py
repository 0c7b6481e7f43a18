"""The gate math of one step of the fused RNN op, LSTM and GRU, forward
and backward: ``csrc/rnn_cell.cu``.

* :func:`lstm_cell` — ``(pre_t, hh, c_prev) -> (h, c)``: gates =
  ``pre_t + hh`` in the order [i, f, g, o], ``c = sig(f) c_prev + sig(i)
  tanh(g)``, ``h = sig(o) tanh(c)``.  ``pre_t`` is the hoisted i2h
  product with both biases, ``hh = h_prev . W_h2h^T``.
* :func:`gru_cell` — ``(pre_t, hh, b_rn, h_prev) -> h``: [r, z, n] with
  the loop-invariant recurrent bias ``b_rn`` inside the reset product,
  ``n = tanh(pre_n + r (hh_n + b_rn))``, ``h = (1 - z) n + z h_prev``;
  ``pre_t`` holds ``W_i x + b_i + [b_hr, b_hz, 0]`` and ``hh`` no bias.

Each is a ``torch.autograd.Function`` whose forward and backward are one
kernel launch each on CUDA tensors (counted in ``LSTM_FWD_LAUNCHES``,
``LSTM_BWD_LAUNCHES``, ``GRU_FWD_LAUNCHES``, ``GRU_BWD_LAUNCHES``), and
whose plain version (:func:`lstm_fwd_reference` and the like), the same
arithmetic in torch ops, runs for CPU tensors.  A CUDA tensor launches
the kernel or the call raises.  Inputs and outputs are f32 or bf16, the
arithmetic f32, and the activated gates the backward reads are kept in
f32 whatever the type.

Replaces no Pallas kernel: it stands where XLA fuses the elementwise
body of mxtpu's ``lax.scan`` (``mxtpu/ndarray/rnn_impl.py:77-116``).
Bound: bytes (see the source's note); one thread an element of the
(N, H) state.  The launch reads no value on the host, on torch's current
stream, so a captured step can hold it.
"""
from __future__ import annotations

import ctypes
import sys

import torch

from ..base import MXNetError
from . import _build, bump, on_card, refuse_grad

__all__ = ["lstm_cell", "gru_cell", "lstm_fwd", "lstm_bwd", "gru_fwd",
           "gru_bwd", "lstm_fwd_reference", "lstm_bwd_reference",
           "gru_fwd_reference", "gru_bwd_reference", "LSTM_FWD_LAUNCHES",
           "LSTM_BWD_LAUNCHES", "GRU_FWD_LAUNCHES", "GRU_BWD_LAUNCHES"]

LSTM_FWD_LAUNCHES = 0
LSTM_BWD_LAUNCHES = 0
GRU_FWD_LAUNCHES = 0
GRU_BWD_LAUNCHES = 0
_SELF = sys.modules[__name__]

_P, _I = ctypes.c_void_p, ctypes.c_int
_DTYPES = (torch.float32, torch.bfloat16)


# ----------------------------------------------------------------------
# plain versions: the kernels' arithmetic in torch ops, f32 inside
# ----------------------------------------------------------------------
def lstm_fwd_reference(pre, hh, c_prev):
    """(h, c) in the inputs' type and the f32 activated gates (N, 4H)."""
    dt = pre.dtype
    g4 = pre.float() + hh.float()
    H = g4.shape[-1] // 4
    i = torch.sigmoid(g4[:, :H])
    f = torch.sigmoid(g4[:, H:2 * H])
    g = torch.tanh(g4[:, 2 * H:3 * H])
    o = torch.sigmoid(g4[:, 3 * H:])
    c = f * c_prev.float() + i * g
    c_out = c.to(dt)
    return (o * torch.tanh(c)).to(dt), c_out, torch.cat([i, f, g, o], 1)


def lstm_bwd_reference(dh, dc, gates, c_prev, c):
    """(dgates (N, 4H), dc_prev (N, H)) in ``dh``'s type."""
    dt = dh.dtype
    H = gates.shape[-1] // 4
    i, f, g, o = (gates[:, k * H:(k + 1) * H] for k in range(4))
    tc = torch.tanh(c.float())
    dhv = dh.float()
    dct = dc.float() + dhv * o * (1.0 - tc * tc)
    dg = torch.cat([dct * g * i * (1.0 - i),
                    dct * c_prev.float() * f * (1.0 - f),
                    dct * i * (1.0 - g * g),
                    dhv * tc * o * (1.0 - o)], 1)
    return dg.to(dt), (dct * f).to(dt)


def gru_fwd_reference(pre, hh, b_rn, h_prev):
    """h in the inputs' type and the f32 saved (N, 4H) = [r, z, n,
    hh_n + b_rn]."""
    dt = pre.dtype
    p, q = pre.float(), hh.float()
    H = p.shape[-1] // 3
    r = torch.sigmoid(p[:, :H] + q[:, :H])
    z = torch.sigmoid(p[:, H:2 * H] + q[:, H:2 * H])
    hn = q[:, 2 * H:] + b_rn.float()
    n = torch.tanh(p[:, 2 * H:] + r * hn)
    h = (1.0 - z) * n + z * h_prev.float()
    return h.to(dt), torch.cat([r, z, n, hn], 1)


def gru_bwd_reference(dh, saved, h_prev):
    """(dpre (N, 3H), dhh (N, 3H), dh_prev (N, H)) in ``dh``'s type."""
    dt = dh.dtype
    H = saved.shape[-1] // 4
    r, z, n, hn = (saved[:, k * H:(k + 1) * H] for k in range(4))
    dhv = dh.float()
    dn = dhv * (1.0 - z) * (1.0 - n * n)
    dz = dhv * (h_prev.float() - n) * z * (1.0 - z)
    dr = dn * hn * r * (1.0 - r)
    return (torch.cat([dr, dz, dn], 1).to(dt),
            torch.cat([dr, dz, dn * r], 1).to(dt), (dhv * z).to(dt))


# ----------------------------------------------------------------------
# the kernels' wrappers (no graph: the autograd Functions call them)
# ----------------------------------------------------------------------
def _check(what, gates, *tensors):
    """(N, H) of 2-D contiguous inputs of one type (f32 or bf16) whose
    first has ``gates`` x H columns."""
    x = tensors[0]
    if x.dim() != 2 or x.shape[1] % gates:
        raise MXNetError(f"{what}: expected (N, {gates}H), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise MXNetError(f"{what}: f32 or bf16, got {x.dtype}")
    for t in tensors:
        if t.dtype != x.dtype:
            raise MXNetError(f"{what}: mixed types {x.dtype} and {t.dtype}")
        if not t.is_contiguous():
            raise MXNetError(f"{what}: inputs must be contiguous")
    return x.shape[0], x.shape[1] // gates


def _launch(symbol, args, n, H, dtype, dev_tensor, counter):
    if n * H == 0:
        return
    fn = _build.bind("rnn_cell", symbol, [_P] * len(args) + [_I, _I, _I, _P])
    with torch.cuda.device(dev_tensor.device):
        err = fn(*[a.data_ptr() for a in args], n, H,
                 int(dtype == torch.bfloat16), _build.stream_of(dev_tensor))
    _build.check(err, symbol)
    bump(_SELF, counter)


def lstm_fwd(pre, hh, c_prev):
    """The forward step: (h, c, f32 gates); the kernel on CUDA tensors,
    the plain version on CPU tensors."""
    if not on_card(pre, hh, c_prev):
        return lstm_fwd_reference(pre, hh, c_prev)
    refuse_grad("lstm_fwd", pre, hh, c_prev, hint="call lstm_cell")
    c_prev = c_prev.to(pre.dtype).contiguous()
    n, H = _check("lstm_fwd", 4, pre, hh)
    if tuple(c_prev.shape) != (n, H) or tuple(hh.shape) != (n, 4 * H):
        raise MXNetError(f"lstm_fwd: shapes {tuple(pre.shape)}, "
                         f"{tuple(hh.shape)}, {tuple(c_prev.shape)}")
    h = torch.empty(n, H, dtype=pre.dtype, device=pre.device)
    c = torch.empty_like(h)
    gates = torch.empty(n, 4 * H, dtype=torch.float32, device=pre.device)
    _launch("mxt_lstm_fwd", (pre, hh, c_prev, h, c, gates), n, H, pre.dtype,
            pre, "LSTM_FWD_LAUNCHES")
    return h, c, gates


def lstm_bwd(dh, dc, gates, c_prev, c):
    """The backward step: (dgates, dc_prev) in ``c``'s type."""
    if not on_card(dh, dc, gates, c_prev, c):
        return lstm_bwd_reference(dh.to(c.dtype), dc, gates, c_prev, c)
    dt = c.dtype
    dh, dc, c_prev = (t.to(dt).contiguous() for t in (dh, dc, c_prev))
    n, H = _check("lstm_bwd", 1, c, dh, dc, c_prev)
    if gates.dtype != torch.float32 or tuple(gates.shape) != (n, 4 * H) \
            or not gates.is_contiguous():
        raise MXNetError("lstm_bwd: gates must be contiguous f32 (N, 4H)")
    dgates = torch.empty(n, 4 * H, dtype=dt, device=c.device)
    dc_prev = torch.empty(n, H, dtype=dt, device=c.device)
    _launch("mxt_lstm_bwd", (dh, dc, gates, c_prev, c, dgates, dc_prev), n,
            H, dt, c, "LSTM_BWD_LAUNCHES")
    return dgates, dc_prev


def gru_fwd(pre, hh, b_rn, h_prev):
    """The forward step: (h, f32 saved)."""
    if not on_card(pre, hh, b_rn, h_prev):
        return gru_fwd_reference(pre, hh, b_rn, h_prev)
    refuse_grad("gru_fwd", pre, hh, b_rn, h_prev, hint="call gru_cell")
    n, H = _check("gru_fwd", 3, pre, hh)
    b_rn, h_prev = (t.to(pre.dtype).contiguous() for t in (b_rn, h_prev))
    if tuple(h_prev.shape) != (n, H) or tuple(b_rn.shape) != (H,) or \
            tuple(hh.shape) != (n, 3 * H):
        raise MXNetError(f"gru_fwd: shapes {tuple(pre.shape)}, "
                         f"{tuple(hh.shape)}, {tuple(b_rn.shape)}, "
                         f"{tuple(h_prev.shape)}")
    h = torch.empty(n, H, dtype=pre.dtype, device=pre.device)
    saved = torch.empty(n, 4 * H, dtype=torch.float32, device=pre.device)
    _launch("mxt_gru_fwd", (pre, hh, b_rn, h_prev, h, saved), n, H,
            pre.dtype, pre, "GRU_FWD_LAUNCHES")
    return h, saved


def gru_bwd(dh, saved, h_prev):
    """The backward step: (dpre, dhh, dh_prev) in ``h_prev``'s type."""
    if not on_card(dh, saved, h_prev):
        return gru_bwd_reference(dh.to(h_prev.dtype), saved, h_prev)
    dt = h_prev.dtype
    dh, h_prev = dh.to(dt).contiguous(), h_prev.contiguous()
    n, H = _check("gru_bwd", 1, h_prev, dh)
    if saved.dtype != torch.float32 or tuple(saved.shape) != (n, 4 * H) \
            or not saved.is_contiguous():
        raise MXNetError("gru_bwd: saved must be contiguous f32 (N, 4H)")
    dpre = torch.empty(n, 3 * H, dtype=dt, device=dh.device)
    dhh = torch.empty_like(dpre)
    dh_prev = torch.empty(n, H, dtype=dt, device=dh.device)
    _launch("mxt_gru_bwd", (dh, saved, h_prev, dpre, dhh, dh_prev), n, H,
            dt, dh, "GRU_BWD_LAUNCHES")
    return dpre, dhh, dh_prev


# ----------------------------------------------------------------------
# the autograd Functions the RNN op runs a step through
# ----------------------------------------------------------------------
class _LSTMCell(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pre, hh, c_prev):
        h, c, gates = lstm_fwd(pre.contiguous(), hh.contiguous(), c_prev)
        ctx.save_for_backward(gates, c_prev, c)
        ctx.c_dtype = c_prev.dtype
        return h, c

    @staticmethod
    def backward(ctx, dh, dc):
        gates, c_prev, c = ctx.saved_tensors
        dg, dc_prev = lstm_bwd(dh, dc, gates, c_prev, c)
        return dg, dg, dc_prev.to(ctx.c_dtype)


class _GRUCell(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pre, hh, b_rn, h_prev):
        h, saved = gru_fwd(pre.contiguous(), hh.contiguous(), b_rn, h_prev)
        ctx.save_for_backward(saved, h_prev)
        ctx.types = (b_rn.dtype, h_prev.dtype)
        return h

    @staticmethod
    def backward(ctx, dh):
        saved, h_prev = ctx.saved_tensors
        dpre, dhh, dh_prev = gru_bwd(dh, saved, h_prev.to(dh.dtype))
        H = saved.shape[-1] // 4
        db_rn = dhh[:, 2 * H:].float().sum(0).to(ctx.types[0])
        return dpre, dhh, db_rn, dh_prev.to(ctx.types[1])


def lstm_cell(pre, hh, c_prev):
    """One LSTM step (see the module's docstring): ``(h, c)``."""
    return _LSTMCell.apply(pre, hh, c_prev)


def gru_cell(pre, hh, b_rn, h_prev):
    """One GRU step (see the module's docstring): ``h``."""
    return _GRUCell.apply(pre, hh, b_rn, h_prev)
