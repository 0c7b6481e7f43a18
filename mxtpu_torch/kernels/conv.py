"""2-D convolution over NHWC data, stride 1, zero padding of KH//2 rows
and KW//2 columns on each side, output H x W: the port of TPU kernel
#13, ``tools/probe_conv_strategies.py:pallas_conv`` (body
``_conv_kernel``).

* ``conv_nhwc`` — CUDA ``csrc/conv_nhwc.cu``, an implicit GEMM on the
  tensor cores: in bf16 ``conv_nhwc_wgmma_kernel`` (TMA im2col loads of
  the pixels, wgmma); in f32, with no TF32, a prepass
  (``conv_split_f32_kernel``) splits x and w exactly into three bf16
  parts each, into scratch this wrapper allocates, and
  ``conv_nhwc_f32_wgmma_kernel`` sums the six part products that matter
  in f32 (the TPU's f32 at Precision.HIGHEST).  For KH or KW above 255,
  past the im2col loads, f32 takes true f32 FMAs
  (``conv_nhwc_f32_kernel``) and bf16 is refused.  One call counts one
  launch in ``CONV_LAUNCHES``.
* :func:`conv_nhwc_reference` — the plain version, the port of
  ``shifted_gemm_conv`` (``:29-43``): pad, then KH*KW matmuls over
  shifted views of the inputs cast to f32, summed in f32, cast back to
  x's type.  Every bf16 product is exact in f32, so it is the oracle on
  the CPU and on the card alike.

x is (N, H, W, C), w (KH, KW, C, O) HWIO, y (N, H, W, O) in x's type;
accumulation in f32.  For an even kernel the padding keeps the
reference's convention (KH//2 on both sides, the top-left H x W), which
is not XLA's SAME.  The reference's ``bn`` (images per VMEM block) has
no meaning on the card and is not taken; every image is computed.

The TPU kernel has no backward, so this one has none either: inputs
that require grad are refused on every device.  On the card the kernel
runs or the call raises (no fallback to the plain version or to cuDNN);
it takes float32 or bfloat16 x and w of one type, contiguous, 16-byte
aligned, N*H*W < 2^30, and in bf16 KH, KW <= 255 (f32 takes any size:
the scalar kernel past 255).  Any C and O, as
``pallas_conv`` takes: the kernel itself needs multiples of 8 (TMA's
16-byte strides), so ``conv_nhwc`` runs it on copies of x and w
zero-padded to them and slices y back; zero channels add nothing.
"""
from __future__ import annotations

import ctypes
import sys

import torch
import torch.nn.functional as F

from ..base import MXNetError
from . import _build, bump, on_card, refuse_grad

__all__ = ["conv_nhwc", "conv_nhwc_reference", "CONV_LAUNCHES"]

# launches of the kernel (kernels.launch_counts reads it)
CONV_LAUNCHES = 0
_SELF = sys.modules[__name__]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# channels per 16 bytes of bf16: TMA's stride unit
CHANNEL_MULTIPLE = 8
MAX_PIXELS = 2 ** 30
# the bf16 kernel's im2col tap offsets and bounding-box corners
MAX_KERNEL = 255
_P, _I = ctypes.c_void_p, ctypes.c_int
# x, w, y, the f32 split's scratch for x and w; N, H, W, C, KH, KW, O,
# dtype, stream
_ARGS = [_P] * 5 + [_I] * 8 + [_P]


def _shapes(x: torch.Tensor, w: torch.Tensor):
    if x.ndim != 4 or w.ndim != 4:
        raise MXNetError(f"conv_nhwc: x must be (N, H, W, C) and w (KH, KW, "
                         f"C, O), got {tuple(x.shape)} and {tuple(w.shape)}")
    N, H, W, C = x.shape
    KH, KW, Cw, O = w.shape
    if Cw != C:
        raise MXNetError(f"conv_nhwc: w {tuple(w.shape)} takes {Cw} "
                         f"channels, x {tuple(x.shape)} has {C}")
    return N, H, W, C, KH, KW, O


def conv_nhwc_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch: pad KH//2 and KW//2 on each side, then one f32
    matmul per (kh, kw) over the shifted (N, H, W, C) view, summed in
    f32 and cast to x's type."""
    N, H, W, C, KH, KW, O = _shapes(x, w)
    ph, pw = KH // 2, KW // 2
    xp = F.pad(x.float(), (0, 0, pw, pw, ph, ph))
    wf = w.float()
    acc = torch.zeros(N, H, W, O, dtype=torch.float32, device=x.device)
    for kh in range(KH):
        for kw in range(KW):
            acc = acc + torch.matmul(xp[:, kh:kh + H, kw:kw + W, :],
                                     wf[kh, kw])
    return acc.to(x.dtype)


def _check(x: torch.Tensor, w: torch.Tensor):
    """What the kernel takes (header of ``csrc/conv_nhwc.cu``); returns
    (N, H, W, C, KH, KW, O)."""
    N, H, W, C, KH, KW, O = _shapes(x, w)
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise MXNetError(f"conv_nhwc: x and w must share float32 or "
                         f"bfloat16, got {x.dtype} and {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise MXNetError("conv_nhwc: x (NHWC) and w (HWIO) must be "
                         "contiguous")
    if C % CHANNEL_MULTIPLE or O % CHANNEL_MULTIPLE:
        raise MXNetError(f"conv_nhwc: C={C} and O={O} must be multiples "
                         f"of {CHANNEL_MULTIPLE} (the kernel's 16-byte "
                         f"loads)")
    if x.dtype == torch.bfloat16 and (KH > MAX_KERNEL or KW > MAX_KERNEL):
        raise MXNetError(f"conv_nhwc: a {KH}x{KW} kernel exceeds the bf16 "
                         f"kernel's bound of {MAX_KERNEL}")
    if N * H * W == 0 or w.numel() == 0:
        raise MXNetError(f"conv_nhwc: empty input {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if N * H * W >= MAX_PIXELS:
        raise MXNetError(f"conv_nhwc: N*H*W = {N * H * W} pixels, the "
                         f"kernel takes fewer than {MAX_PIXELS}")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise MXNetError("conv_nhwc: x and w must be 16-byte aligned")
    return N, H, W, C, KH, KW, O


def _pad_channels(x: torch.Tensor, w: torch.Tensor):
    """x and w with C (x's last and w's third dim) and O (w's last)
    zero-padded to multiples of ``CHANNEL_MULTIPLE``, on copies; as
    they are when both already are."""
    C, O = w.shape[2], w.shape[3]
    pc, po = -C % CHANNEL_MULTIPLE, -O % CHANNEL_MULTIPLE
    if pc:
        x = F.pad(x, (0, pc))
    if pc or po:
        w = F.pad(w, (0, po, 0, pc))
    return x, w


def conv_nhwc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y (N, H, W, O) = the convolution of x (N, H, W, C) by w (KH, KW,
    C, O): the kernel on CUDA tensors, the plain version on CPU
    tensors."""
    refuse_grad("conv_nhwc", x, w,
                hint="it has no backward, as the TPU kernel has none")
    if not on_card(x, w):
        return conv_nhwc_reference(x, w)
    O = _shapes(x, w)[6]
    x, w = _pad_channels(x, w)
    N, H, W, C, KH, KW, Op = _check(x, w)
    y = torch.empty(N, H, W, Op, dtype=x.dtype, device=x.device)
    xs = ws = None  # the three bf16 parts of f32 x and w, stacked
    if x.dtype == torch.float32 and max(KH, KW) <= MAX_KERNEL:
        xs = torch.empty(3 * x.numel(), dtype=torch.bfloat16,
                         device=x.device)
        ws = torch.empty(3 * w.numel(), dtype=torch.bfloat16,
                         device=x.device)
    fn = _build.bind("conv_nhwc", "mxt_conv_nhwc", _ARGS)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                 None if xs is None else xs.data_ptr(),
                 None if ws is None else ws.data_ptr(), N, H, W, C, KH,
                 KW, Op, _DTYPES[x.dtype], _build.stream_of(x))
    _build.check(err, "conv_nhwc")
    bump(_SELF, "CONV_LAUNCHES")
    return y if Op == O else y[..., :O].contiguous()
