"""The attention ops of ``mxtpu/ndarray/rnn_impl.py``:
``flash_attention`` (``rnn_impl.py:278``), on the flash-attention
kernels (#1 forward, #2 and #3 backward) for a CUDA tensor and their
plain versions on the CPU, and the incremental decode's
``kv_cache_write`` and ``cached_attention`` (``rnn_impl.py:212-266``).
Those two are lax in mxtpu, outside any Pallas kernel, so they are
torch calls here: an index write, two ``torch.matmul``s and a masked
f32 softmax (TF32 off on the card, ``context.strict_f32``).  The
recurrent ops are not ported yet.
"""
from __future__ import annotations

import math

import torch

from ..kernels import flash_attention as _flash
from ..ops.registry import Param, register_op


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
