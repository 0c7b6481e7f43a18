"""The ops of ``mxtpu/ndarray/rnn_impl.py``: the fused ``RNN`` op
(``rnn_impl.py:38-210``), and the attention ops.

``RNN`` is mxtpu's: LSTM, GRU and the two Elman modes, multi-layer,
bidirectional, over cuDNN's flat parameter vector (weights by (layer,
direction), then biases; ``rnn_param_size``, ``_slice_params``).  The
i2h product of every step is hoisted into one GEMM a layer and
direction, as ``_rnn_impl`` does.  For LSTM and GRU ``lax.scan``
becomes one autograd Function over the direction
(``kernels/rnn_scan.py``): on a CUDA tensor one persistent launch runs
every step forward (W_h2h's slice, or in f32 the share of it that
fits, kept on chip, the state exchanged between CTAs through a
grid-wide barrier a step, a batch past 32 rows in chunks) and one every
step backward, then dW_h2h is one GEMM; on the CPU its plain version,
the per-step loop.  A CUDA shape past the persistent kernel's limits (a
bf16 W slice over a CTA's shared memory) takes a Python loop
over T whose step is a GEMM (``h . W_h2h^T``) and one launch of the
cell kernel (``kernels/rnn_cell.py``).  The i2h and dW products are
plain matrix products outside any Pallas kernel in mxtpu, so they are
torch calls here.  The Elman modes' step is a GEMM, an add and an
activation in torch.  Inter-layer dropout draws its mask from
``mxtpu_torch.random``'s generator of the data's device, as ``Dropout``
does; the trailing key input keeps mxtpu's signature and its words are
not read.

``flash_attention`` (``rnn_impl.py:278``), on the flash-attention
kernels (#1 forward, #2 and #3 backward) for a CUDA tensor and their
plain versions on the CPU, and the incremental decode's
``kv_cache_write`` and ``cached_attention`` (``rnn_impl.py:212-266``).
Those two are lax in mxtpu, outside any Pallas kernel, so they are
torch calls here: an index write, two ``torch.matmul``s and a masked
f32 softmax (TF32 off on the card, ``context.strict_f32``).
"""
from __future__ import annotations

import math

import torch

from .. import random as _random
from ..base import MXNetError
from .. import kernels as _kernels
from ..kernels import flash_attention as _flash
from ..kernels import rnn_cell as _cell
from ..kernels import rnn_scan as _scan
from ..ops.registry import Param, register_op

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def rnn_param_size(num_layers: int, input_size: int, state_size: int,
                   bidirectional: bool, mode: str) -> int:
    """Length of the flat parameter vector (reference
    ``rnn_param_size``† in rnn-inl.h)."""
    gates = _GATES[mode]
    dirs = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_size = input_size if layer == 0 else state_size * dirs
        size += gates * state_size * (in_size + state_size + 2) * dirs
    return size


def _slice_params(params, num_layers, input_size, state_size, dirs, gates):
    """The flat vector (of ``rnn_param_size`` elements) cut into
    [w_i2h, w_h2h, b_i2h, b_h2h] a (layer, direction), views of it."""
    H, G = state_size, gates
    weights = []
    off = 0
    for layer in range(num_layers):
        in_size = input_size if layer == 0 else H * dirs
        per_layer = []
        for _ in range(dirs):
            w_i2h = params[off:off + G * H * in_size].reshape(
                G * H, in_size)
            off += G * H * in_size
            w_h2h = params[off:off + G * H * H].reshape(G * H, H)
            off += G * H * H
            per_layer.append([w_i2h, w_h2h, None, None])
        weights.append(per_layer)
    for layer in range(num_layers):
        for d in range(dirs):
            weights[layer][d][2] = params[off:off + G * H]
            off += G * H
            weights[layer][d][3] = params[off:off + G * H]
            off += G * H
    return weights


def _scan_dir(pre, h0, c0, w_h2h, b_rn, mode, reverse):
    """One direction of one layer.  ``pre``: (T, N, G*H), the hoisted
    i2h product with its biases; returns (outputs (T, N, H), h_T,
    c_T).  LSTM and GRU run as one ``kernels/rnn_scan.py`` Function
    over the direction (the persistent kernels on a CUDA tensor within
    their limits, the plain scan on the CPU) unless
    ``rnn_scan.scan_path`` sends a CUDA shape past those limits to the
    per-step loop below, a GEMM and a cell kernel a step."""
    T, N, GH = pre.shape
    if mode in ("lstm", "gru"):
        H = GH // _GATES[mode]
        sms = _kernels.sm_count(pre.device) if pre.is_cuda else 0
        if _scan.scan_path(pre.device.type, pre.dtype, N, H, mode,
                           sms) != "cell":
            if mode == "lstm":
                return _scan.lstm_scan(pre, h0, c0, w_h2h, reverse)
            ys, h = _scan.gru_scan(pre, h0, w_h2h, b_rn, reverse)
            return ys, h, None
    steps = pre.unbind(0)
    order = range(len(steps) - 1, -1, -1) if reverse else range(len(steps))
    h, c = h0, c0
    ys = [None] * len(steps)
    for t in order:
        hh = torch.matmul(h, w_h2h.t())
        if mode == "lstm":
            h, c = _cell.lstm_cell(steps[t], hh, c)
        elif mode == "gru":
            h = _cell.gru_cell(steps[t], hh, b_rn, h)
        elif mode == "rnn_tanh":
            h = torch.tanh(steps[t] + hh)
        else:
            h = torch.relu(steps[t] + hh)
        ys[t] = h
    return torch.stack(ys), h, c


def _rnn_shapes(data, state, state_cell, H, L, dirs, mode, state_outputs):
    """Shape inference: empty outputs of the op's shapes."""
    T, N, _ = data.shape
    out = torch.empty(T, N, dirs * H, dtype=data.dtype, device=data.device)
    if not state_outputs:
        return out
    hn = torch.empty(L * dirs, N, H, dtype=data.dtype, device=data.device)
    return (out, hn, torch.empty_like(hn)) if mode == "lstm" else (out, hn)


def _rnn_op(data, parameters, state, *extra, state_size, num_layers,
            mode="lstm", bidirectional=False, p=0.0, state_outputs=False):
    """The fused RNN.  data: (T, N, I); parameters: the flat vector;
    state: (L*D, N, H); LSTM also takes state_cell; a trailing key input
    turns on inter-layer dropout.  Returns the output (T, N, D*H), with
    ``state_outputs`` also the final states (and cells)."""
    if mode not in _GATES:
        raise MXNetError(f"unknown RNN mode {mode!r}")
    if mode == "lstm":
        state_cell = extra[0] if extra else None
        key = extra[1] if len(extra) > 1 else None
    else:
        state_cell = None
        key = extra[0] if extra else None
    H, L = int(state_size), int(num_layers)
    dirs = 2 if bidirectional else 1
    G = _GATES[mode]
    if data.device.type == "meta":   # shape inference
        return _rnn_shapes(data, state, state_cell, H, L, dirs, mode,
                           state_outputs)
    T, N, I = data.shape
    need = rnn_param_size(L, I, H, bidirectional, mode)
    if need != parameters.shape[0]:
        raise MXNetError(
            f"RNN parameter vector has {parameters.shape[0]} elements, "
            f"layout needs {need} (use rnn_param_size)")
    weights = _slice_params(parameters, L, I, H, dirs, G)
    if mode == "lstm" and state_cell is None:
        raise MXNetError("RNN mode 'lstm' needs state_cell")

    dt = data.dtype
    x = data
    h_finals, c_finals = [], []
    for layer in range(L):
        outs = []
        for d in range(dirs):
            w_i2h, w_h2h, b_i2h, b_h2h = weights[layer][d]
            idx = layer * dirs + d
            h0 = state[idx].to(dt)
            c0 = state_cell[idx].to(dt) if state_cell is not None else None
            b_rn = None
            if mode == "gru":
                # b_h2h's n part stays inside the reset product
                b_rn = b_h2h[2 * H:]
                bias = b_i2h + torch.cat([b_h2h[:2 * H],
                                          torch.zeros_like(b_rn)])
            else:
                bias = b_i2h + b_h2h
            pre = torch.addmm(bias, x.reshape(T * N, -1), w_i2h.t()) \
                .view(T, N, G * H)
            ys, h_t, c_t = _scan_dir(pre, h0, c0, w_h2h, b_rn, mode,
                                     reverse=(d == 1))
            outs.append(ys)
            h_finals.append(h_t)
            if c_t is not None:
                c_finals.append(c_t)
        x = outs[0] if dirs == 1 else torch.cat(outs, dim=-1)
        if p > 0.0 and key is not None and layer < L - 1:
            keep = 1.0 - p
            u = torch.rand(x.shape, generator=_random.generator(x.device),
                           device=x.device)
            x = torch.where(u < keep, x / keep, torch.zeros_like(x))

    if not state_outputs:
        return x
    state_n = torch.stack(h_finals)
    if mode == "lstm":
        return x, state_n, torch.stack(c_finals)
    return x, state_n


def _rnn_num_outputs(attrs) -> int:
    so = attrs.get("state_outputs", False)
    if isinstance(so, str):
        so = so not in ("False", "false", "0")
    if not so:
        return 1
    return 3 if attrs.get("mode", "lstm") == "lstm" else 2


register_op(
    "RNN", num_inputs=-1, num_outputs=3,
    params=[Param("state_size", int),
            Param("num_layers", int),
            Param("mode", str, "lstm",
                  enum=("rnn_relu", "rnn_tanh", "lstm", "gru")),
            Param("bidirectional", bool, False),
            Param("p", float, 0.0),
            Param("state_outputs", bool, False)],
    num_outputs_fn=_rnn_num_outputs,
    doc=_rnn_op.__doc__)(_rnn_op)


def _flash_attention_op(q, k, v, causal=False, sm_scale=-1.0):
    """Fused attention.  q: (B, H, Tq, D), k/v: (B, H, Tk, D);
    ``sm_scale`` < 0 means 1/sqrt(D)."""
    if q.device.type == "meta":   # shape inference
        return torch.empty_like(q)
    scale = None if sm_scale is None or sm_scale < 0 else sm_scale
    # the kernels read (B*H, T, D) rows through TMA: a head split that
    # views rather than copies (B = 1) is made contiguous here, as XLA
    # lays out mxtpu's operands itself
    return _flash(q.contiguous(), k.contiguous(), v.contiguous(),
                  causal=causal, sm_scale=scale)


register_op("flash_attention", num_inputs=3,
            params=[Param("causal", bool, False),
                    Param("sm_scale", float, -1.0)],
            aliases=("contrib_flash_attention",),
            doc=_flash_attention_op.__doc__)(_flash_attention_op)


def _kv_cache_write_op(cache, new, step):
    """Bucket-paged KV-cache write for the incremental decode.
    ``cache``: (B, H, L, D), one cache lane a row; ``new``: (B, H, T, D)
    keys or values; ``step``: (B,) each lane's write offset, truncated
    to an integer.  ``lax.dynamic_update_slice`` per lane: a negative
    start counts from the end (``+ L``), then the start is clamped to
    [0, L - T].  Out of place, ``new`` cast to the cache's type."""
    B, _, L, _ = cache.shape
    T = new.shape[2]
    start = step.to(torch.int32).to(torch.int64)
    start = torch.where(start < 0, start + L, start).clamp(0, L - T)
    pos = start[:, None] + torch.arange(T, device=cache.device)
    rows = torch.arange(B, device=cache.device)[:, None]
    out = cache.clone()
    # the two index tensors lead the result: (B, T, H, D)
    out[rows, :, pos] = new.transpose(1, 2).to(cache.dtype)
    return out


register_op("kv_cache_write", num_inputs=3, differentiable=False,
            doc=_kv_cache_write_op.__doc__)(_kv_cache_write_op)


def _cached_attention_op(q, k_cache, v_cache, step, sm_scale=-1.0):
    """Decode-step attention over a KV cache.  ``q``: (B, H, T, D), the
    T new tokens of lane b at positions ``step_b + t``; ``k_cache`` and
    ``v_cache``: (B, H, L, D).  Key ``l`` is masked (-1e30) where
    ``l > step_b + t``, so what lies past a lane's frontier is never
    read.  Scores, softmax and P.V in f32; the output in q's type.
    ``sm_scale`` < 0 means 1/sqrt(D)."""
    T, D = q.shape[2], q.shape[3]
    L = k_cache.shape[2]
    scale = 1.0 / math.sqrt(D) if sm_scale is None or sm_scale < 0 \
        else float(sm_scale)
    s = step.to(torch.int32)
    scores = torch.matmul(q.float(), k_cache.float().transpose(-1, -2)) \
        * scale
    pos_q = s[:, None] + torch.arange(T, dtype=torch.int32,
                                      device=q.device)
    pos_k = torch.arange(L, dtype=torch.int32, device=q.device)
    mask = pos_k[None, None, :] <= pos_q[:, :, None]
    scores = scores.masked_fill(~mask[:, None], -1e30)
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs, v_cache.float()).to(q.dtype)


register_op("cached_attention", num_inputs=4, differentiable=False,
            params=[Param("sm_scale", float, -1.0)],
            doc=_cached_attention_op.__doc__)(_cached_attention_op)
