"""The attention op of ``mxtpu/ndarray/rnn_impl.py``: ``flash_attention``
(``rnn_impl.py:278``), on the flash-attention kernels (#1 forward, #2
and #3 backward) for a CUDA tensor and their plain versions on the CPU.
The recurrent ops and the cached decode attention are not ported yet.
"""
from __future__ import annotations

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
