"""Sustained throughput of chained applications (the port of
``tools/microbench.py``).

Each application consumes the previous one's whole output, as in a real
network, and weights are scaled to keep unit variance, so no result is
unused and no value runs off to inf.  PyTorch runs eagerly: the chain
is n launches from Python, so the host's launch cost is part of what is
measured, amortized over n; a step that launches many small kernels
shows it.

    python -m mxtpu_torch.tools.microbench [matmul|conv|all] [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F

from ..context import resolve_device

__all__ = ["sustained", "bench_matmul", "bench_conv", "MATMUL_SHAPES",
           "CONV_SHAPES", "conv_flops", "cudnn_conv", "device_name", "main"]

# (M, K) of y = y @ W with W (K, K)
MATMUL_SHAPES = ((4096, 4096), (8192, 8192), (50176, 256), (50176, 1024),
                 (6272, 1024), (8192, 1024))
# (H, C, N) of a 3x3 stride-1 conv, C = O
CONV_SHAPES = ((14, 256, 256), (28, 128, 256), (7, 512, 256),
               (56, 64, 256), (14, 512, 256))


def conv_flops(N: int, H: int, W: int, C: int, O: int, KH: int = 3,
               KW: int = 3) -> int:
    """Multiply-adds times 2 of a stride-1 conv with an H x W output."""
    return 2 * N * H * W * C * O * KH * KW


def cudnn_conv(w: torch.Tensor) -> Callable[[torch.Tensor], torch.Tensor]:
    """cuDNN's stride-1 conv with the HWIO weight ``w``, laid out once
    here (OIHW channels-last): returns NHWC x -> NHWC y, ``F.conv2d``
    over channels-last views padded KH//2 and KW//2 (SAME for odd
    kernels), the counterpart of ``conv_general_dilated`` on NHWC."""
    KH, KW = w.shape[:2]
    wo = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    pad = (KH // 2, KW // 2)
    return lambda x: F.conv2d(x.permute(0, 3, 1, 2), wo,
                              padding=pad).permute(0, 2, 3, 1)


def _sync(out: torch.Tensor) -> None:
    # a host read of a value of the output: the device has finished
    float(out.sum())


def sustained(apply_fn: Callable[[torch.Tensor], torch.Tensor],
              x0: torch.Tensor, n: int = 50, repeats: int = 3) -> float:
    """Seconds per application of ``apply_fn`` over ``n`` chained
    applications (each consumes the previous output), the best of
    ``repeats`` timed chains after one warm chain.  ``apply_fn`` maps x
    to a tensor of x's shape.  Each chain ends in a host read of the
    output's sum, so the time covers the device's work and, the launches
    being eager, the host's launch cost."""
    def run(x):
        for _ in range(n):
            x = apply_fn(x)
        return x

    _sync(run(x0))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        _sync(run(x0))
        best = min(best, (time.perf_counter() - t0) / n)
    return best


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def _gen(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def bench_matmul(device=None, shapes: Sequence = MATMUL_SHAPES,
                 n: int = 50) -> List[dict]:
    """Chained bf16 ``y = y @ W``; returns one row per shape."""
    dev = resolve_device(device)
    print("== sustained matmul (chained y = y @ W) ==")
    rows = []
    for (M, K) in shapes:
        x = torch.randn(M, K, generator=_gen(dev, 0), device=dev) \
            .to(torch.bfloat16)
        w = (torch.randn(K, K, generator=_gen(dev, 1), device=dev) /
             K ** 0.5).to(torch.bfloat16)
        t = sustained(lambda x: x @ w, x, n=n)
        tf = 2 * M * K * K / t / 1e12
        rows.append({"M": M, "K": K, "tflops": tf, "ms": t * 1e3})
        print(f"  ({M},{K})@({K},{K}): {tf:.1f} TF/s  ({t*1e3:.2f} ms/op)")
    return rows


def bench_conv(device=None, shapes: Sequence = CONV_SHAPES,
               n: int = 50) -> List[dict]:
    """Chained 3x3 stride-1 convs through cuDNN (:func:`cudnn_conv` in
    bf16); returns one row per shape."""
    dev = resolve_device(device)
    print("== sustained conv 3x3 s1 SAME NHWC (chained, C=O) ==")
    rows = []
    for (H, C, N) in shapes:
        x = torch.randn(N, H, H, C, generator=_gen(dev, 0), device=dev) \
            .to(torch.bfloat16)
        w = (torch.randn(3, 3, C, C, generator=_gen(dev, 1), device=dev) /
             (3 * C ** 0.5)).to(torch.bfloat16)
        t = sustained(cudnn_conv(w), x, n=n)
        tf = conv_flops(N, H, H, C, C) / t / 1e12
        rows.append({"N": N, "H": H, "C": C, "tflops": tf, "ms": t * 1e3})
        print(f"  b{N} {H}x{H} C={C}: {tf:.1f} TF/s  ({t*1e3:.2f} ms/op)")
    return rows


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="mxtpu_torch.tools.microbench")
    ap.add_argument("which", nargs="?", default="all",
                    choices=("matmul", "conv", "all"))
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print("device:", device_name(dev))
    out = {}
    if args.which in ("matmul", "all"):
        out["matmul"] = bench_matmul(dev)
    if args.which in ("conv", "all"):
        out["conv"] = bench_conv(dev)
    return out


if __name__ == "__main__":
    main()
