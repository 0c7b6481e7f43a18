"""Three ways to compute a 3x3 stride-1 conv on the card (the port of
``tools/probe_conv_strategies.py``), timed with the chained harness
(:func:`~mxtpu_torch.tools.microbench.sustained`):

  a) cuDNN: ``F.conv2d`` on channels-last bf16 (for ``xla_conv``);
  b) shifted GEMM: one bf16 ``torch.matmul`` per (kh, kw) over a shifted
     view of the padded input, the nine products summed in f32;
  c) the hand-written kernel ``kernels.conv_nhwc`` (TPU kernel #13,
     ``pallas_conv``).

All NHWC (HWIO weights), stride 1, pad KH//2, C = O (chainable), bf16,
b256.  The JAX tool's two ``pallas bn=8/16`` rows are one ``kernel``
row: ``bn`` is a VMEM block size with no meaning on the card.

    python -m mxtpu_torch.tools.probe_conv_strategies [shape index] [--device cpu]
"""
from __future__ import annotations

import argparse
import functools
import traceback
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from ..context import resolve_device
from ..kernels import conv_nhwc
from .microbench import conv_flops, cudnn_conv, device_name, sustained

__all__ = ["cudnn_conv", "shifted_gemm_conv", "STRATEGIES", "SHAPES", "N",
           "run_shape", "main"]

# (H, C) of the probe: ResNet's three inner 3x3 shapes
SHAPES = ((14, 256), (28, 128), (7, 512))
N = 256


def shifted_gemm_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Pad, then one matmul in x's type per (kh, kw) over the shifted
    view, the products summed in f32 and cast back.  ``torch.matmul``
    rounds each bf16 product to bf16 (the reference's einsum keeps it
    in f32 by ``preferred_element_type``), so in bf16 this is a few
    roundings from :func:`~mxtpu_torch.kernels.conv.conv_nhwc_reference`."""
    Nb, H, W, C = x.shape
    KH, KW, _, O = w.shape
    ph, pw = KH // 2, KW // 2
    xp = F.pad(x, (0, 0, pw, pw, ph, ph))
    acc = torch.zeros(Nb, H, W, O, dtype=torch.float32, device=x.device)
    for kh in range(KH):
        for kw in range(KW):
            acc = acc + torch.matmul(xp[:, kh:kh + H, kw:kw + W, :],
                                     w[kh, kw]).float()
    return acc.to(x.dtype)


# name -> (HWIO w -> (NHWC x -> NHWC y)); the weight is laid out once,
# outside the timed calls; "kernel" is #13 (its plain version on CPU
# tensors)
STRATEGIES: Dict[str, Callable] = {
    "cudnn": cudnn_conv,
    "shifted_gemm": lambda w: functools.partial(shifted_gemm_conv, w=w),
    "kernel": lambda w: functools.partial(conv_nhwc, w=w)}


def run_shape(Nb: int, H: int, C: int, device=None,
              n: int = 20) -> List[dict]:
    """Time each strategy at (Nb, H, H, C) and print one row each: TF/s,
    ms and the max error against cuDNN.  A strategy that raises prints
    a FAILED row (status "FAILED") and the others still run.  x ~ N(0,
    1) and w (3, 3, C, C) ~ N(0, 1) / (3 sqrt C) in bf16, from torch
    generators seeded 0 and 1 on the device."""
    dev = resolve_device(device)
    x = torch.randn(Nb, H, H, C, generator=torch.Generator(device=dev)
                    .manual_seed(0), device=dev).to(torch.bfloat16)
    w = (torch.randn(3, 3, C, C, generator=torch.Generator(device=dev)
                     .manual_seed(1), device=dev) /
         (3 * C ** 0.5)).to(torch.bfloat16)
    fl = conv_flops(Nb, H, H, C, C)
    with torch.no_grad():
        ref = cudnn_conv(w)(x).float()
    print(f"-- b{Nb} {H}x{H} C={C} ({fl/1e9:.0f} GFLOP) --")
    rows = []
    for name, make in STRATEGIES.items():
        try:
            with torch.no_grad():
                apply = make(w)
                err = float((apply(x).float() - ref).abs().max())
                t = sustained(apply, x, n=n)
            rows.append({"name": name, "status": "ok", "H": H, "C": C,
                         "N": Nb, "tflops": fl / t / 1e12, "ms": t * 1e3,
                         "max_abs_err": err})
            print(f"  {name:14s}: {fl/t/1e12:6.1f} TF/s "
                  f"({t*1e3:.2f} ms)  err={err:.2e}")
        except Exception as e:  # noqa: BLE001 — a row per strategy
            traceback.print_exc()
            msg = str(e).split(chr(10))[0][:120]
            rows.append({"name": name, "status": "FAILED", "H": H, "C": C,
                         "N": Nb, "error": f"{type(e).__name__}: {msg}"})
            print(f"  {name:14s}: FAILED {type(e).__name__}: {msg}")
    return rows


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(prog="mxtpu_torch.tools."
                                      "probe_conv_strategies")
    ap.add_argument("shape", nargs="?", type=int, default=None,
                    help=f"index into {SHAPES}")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    shapes = SHAPES if args.shape is None else [SHAPES[args.shape]]
    print("device:", device_name(dev))
    rows = []
    for (H, C) in shapes:
        rows += run_shape(N, H, C, dev)
    return rows


if __name__ == "__main__":
    main()
