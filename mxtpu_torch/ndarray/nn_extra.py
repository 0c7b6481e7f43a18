"""``_contrib_ROIAlign`` (alias ``ROIAlign``), the detection op of
``mxtpu/ndarray/nn_extra.py`` (``:290-338``, its bilinear gather
``:96``), and ``_contrib_MoEFFN`` (alias ``MoEFFN``, ``:716-734``), the
Switch-MoE feed-forward over :func:`mxtpu_torch.parallel.moe.moe_ffn`;
the module's other ops (deformable convolution, PSROIPooling, the
quantized tier, ...) wait.

ROIAlign is differentiable by torch autograd through the gather, in the
data and in the roi coordinates, as jax differentiates mxtpu's.
MoEFFN's two outputs are ``(y, aux)``: y in the data's shape, aux a
scalar (also under shape inference, where the rule sees ``meta``
tensors); ``gelu`` is jax.nn.gelu's default, the tanh form.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from ..ops.registry import Param, register_op


def _bilinear_gather(data, bidx, y, x):
    """data (N, C, H, W); bidx (R,) image of each roi; y, x (R, ...)
    coords, zero outside the map → (R, C, ...)."""
    H, W = data.shape[-2], data.shape[-1]
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    wy1 = y - y0
    wx1 = x - x0
    b = bidx.reshape((-1,) + (1,) * (y.ndim - 1))
    out = 0.0
    for dy, wy in ((0, 1.0 - wy1), (1, wy1)):
        for dx, wx in ((0, 1.0 - wx1), (1, wx1)):
            yy = y0 + dy
            xx = x0 + dx
            inb = (yy >= 0) & (yy <= H - 1) & (xx >= 0) & (xx <= W - 1)
            yc = yy.clamp(0, H - 1).long()
            xc = xx.clamp(0, W - 1).long()
            val = data[b, :, yc, xc]                 # (R, ..., C)
            out = out + val * (wy * wx * inb)[..., None]
    return out.movedim(-1, 1)


def _roi_align(data, rois, pooled_size=(7, 7), spatial_scale=1.0,
               sample_ratio=2, position_sensitive=False):
    """mxtpu's divergences from the reference (``contrib/roi_align.cc``†)
    kept: ``sample_ratio <= 0`` means a fixed 2x2 grid a bin (not the
    adaptive one), and ``position_sensitive=True`` raises."""
    if position_sensitive:
        raise MXNetError(
            "ROIAlign position_sensitive=True is not implemented; use "
            "_contrib_PSROIPooling for position-sensitive pooling")
    ph, pw = int(pooled_size[0]), int(pooled_size[1])
    C = data.shape[1]
    s = int(sample_ratio) if int(sample_ratio) > 0 else 2
    f32 = np.float32
    # the s*s sample offsets of each bin, as mxtpu's f32 aranges
    off = (np.arange(s, dtype=f32) + f32(0.5)) / f32(s)
    iy = torch.from_numpy((np.arange(ph, dtype=f32)[:, None] + off[None])
                          .reshape(-1)).to(data.device)
    ix = torch.from_numpy((np.arange(pw, dtype=f32)[:, None] + off[None])
                          .reshape(-1)).to(data.device)
    bidx = rois[:, 0].long()
    x1 = rois[:, 1] * spatial_scale
    y1 = rois[:, 2] * spatial_scale
    x2 = rois[:, 3] * spatial_scale
    y2 = rois[:, 4] * spatial_scale
    rh = torch.clamp(y2 - y1, min=1.0)
    rw = torch.clamp(x2 - x1, min=1.0)
    bin_h = rh / torch.tensor(float(ph), dtype=rh.dtype, device=rh.device)
    bin_w = rw / torch.tensor(float(pw), dtype=rw.dtype, device=rw.device)
    yy = y1[:, None] + iy * bin_h[:, None]          # (R, ph*s)
    xx = x1[:, None] + ix * bin_w[:, None]          # (R, pw*s)
    R = rois.shape[0]
    grid_y = yy[:, :, None].expand(R, ph * s, pw * s)
    grid_x = xx[:, None, :].expand(R, ph * s, pw * s)
    vals = _bilinear_gather(data, bidx, grid_y, grid_x)
    return vals.reshape(R, C, ph, s, pw, s).mean(dim=(3, 5))


register_op("_contrib_ROIAlign", num_inputs=2,
            params=[Param("pooled_size", tuple, ()),
                    Param("spatial_scale", float, 1.0),
                    Param("sample_ratio", int, 2),
                    Param("position_sensitive", bool, False)],
            aliases=("ROIAlign",))(_roi_align)


# ---------------------------------------------------------------------------
# Switch-MoE feed-forward (mxtpu_torch/parallel/moe.py is the core)
# ---------------------------------------------------------------------------
def _contrib_moe_ffn(data, gate_w, w1, b1, w2, b2, capacity_factor=1.25,
                     activation="relu"):
    # lazy: gluon and parallel import ndarray
    from ..gluon.nn.basic_layers import gelu
    from ..parallel.moe import moe_ffn
    act = {"relu": torch.relu, "gelu": gelu,
           "tanh": torch.tanh}.get(activation)
    if act is None:
        raise MXNetError(f"MoEFFN activation {activation!r} not in "
                         f"relu/gelu/tanh")
    return moe_ffn(data, gate_w, w1, b1, w2, b2,
                   capacity_factor=float(capacity_factor), activation=act)


register_op("_contrib_MoEFFN", num_inputs=6, num_outputs=2,
            params=[Param("capacity_factor", float, 1.25),
                    Param("activation", str, "relu",
                          enum=("relu", "gelu", "tanh"))],
            aliases=("MoEFFN",))(_contrib_moe_ffn)
