"""Flash attention against the O(T^2) plain attention, causal, forward
and backward (the port of ``tools/bench_flash.py``): the long-context
regime, T = 512, 2048 and 4096 at B4 H16 D64 in bf16.

Methodology (:mod:`~mxtpu_torch.tools.microbench`): each step runs j
fused forward+backward passes with dq folded back into q, so every
pass consumes the previous one's result; the time is per pass.

Rows: ``flash`` (``kernels.flash_attention``, TPU kernels #1-3),
``fallback`` (``attention_reference`` through autograd) and, as a
comparison point used nowhere in the port, ``sdpa``
(``F.scaled_dot_product_attention``, PyTorch's own fused attention).

    python -m mxtpu_torch.tools.bench_flash [T ...] [--n N] [--device cpu]
"""
from __future__ import annotations

import argparse
import functools
import traceback
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from ..context import resolve_device
from ..kernels import flash_attention
from ..kernels.flash_attention import attention_reference
from .microbench import device_name, sustained

__all__ = ["fwdbwd_chain", "run", "PATHS", "TS", "main"]

TS = (512, 2048, 4096)
PATHS = {
    "flash": functools.partial(flash_attention, causal=True),
    "fallback": functools.partial(attention_reference, causal=True),
    "sdpa": functools.partial(F.scaled_dot_product_attention,
                              is_causal=True),
}


def fwdbwd_chain(attn, q, k, v, j: int = 4):
    """A step of j attention forward+backward passes, dq folded back
    into q (``q + dq * 1e-6`` in q's type)."""
    def step(q):
        for _ in range(j):
            q_ = q.detach().requires_grad_(True)
            loss = attn(q_, k, v).float().pow(2).sum()
            g, = torch.autograd.grad(loss, q_)
            q = q + g.to(q.dtype) * 1e-6
        return q
    return step


def run(T: int, B: int = 4, H: int = 16, D: int = 64, j: int = 4,
        n: int = 8, device=None) -> List[dict]:
    """Time each path at (B, H, T, D) bf16; one row each (ms per
    forward+backward, TF/s).  A path that raises prints a FAILED row."""
    dev = resolve_device(device)
    shape = (B, H, T, D)
    q, k, v = (torch.randn(*shape, generator=torch.Generator(device=dev)
                           .manual_seed(s), device=dev).to(torch.bfloat16)
               for s in (0, 1, 2))
    # attention fwd+bwd flops ~= 3 * (4*T^2*D) per (b,h) pair.
    # CAUSAL convention: the flash kernel skips blocks strictly above
    # the diagonal (~T^2/2 executed) while the fallback computes the
    # full masked T^2 — each path is credited the FLOPs it actually
    # executes, so the TF/s columns are per-path utilization and NOT
    # directly comparable; compare times/speedup instead.  SDPA's
    # causal kernels skip those blocks too and are credited the half.
    fl_full = 3 * 4 * T * T * D * B * H
    fl = {"flash": fl_full // 2, "fallback": fl_full, "sdpa": fl_full // 2}
    rows = []
    ms: Dict[str, float] = {}
    for name, attn in PATHS.items():
        try:
            t = sustained(fwdbwd_chain(attn, q, k, v, j=j), q,
                          n=n) / j
            ms[name] = t * 1e3
            rows.append({"name": name, "status": "ok", "T": T, "n": n,
                         "ms": t * 1e3, "tflops": fl[name] / t / 1e12})
            label = f"{name:8s}" + (" (comparison point)" if name == "sdpa"
                                    else "")
            print(f"  T={T} {label}: {t*1e3:7.2f} ms/fwd+bwd "
                  f"({fl[name]/t/1e12:5.1f} TF/s)")
        except Exception as e:  # noqa: BLE001 — a row per path
            traceback.print_exc()
            rows.append({"name": name, "status": "FAILED", "T": T,
                         "error": f"{type(e).__name__}: {str(e)[:100]}"})
            print(f"  T={T} {name:8s}: FAILED {type(e).__name__}: "
                  f"{str(e)[:100]}")
    if "flash" in ms and "fallback" in ms:
        print(f"  T={T} speedup flash/fallback: "
              f"{ms['fallback'] / ms['flash']:.2f}x")
    return rows


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(prog="mxtpu_torch.tools.bench_flash")
    ap.add_argument("T", nargs="*", type=int)
    ap.add_argument("--n", type=int, default=8,
                    help="chained steps per timed chain")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print("device:", device_name(dev))
    rows = []
    for T in args.T or TS:
        rows += run(T, n=args.n, device=dev)
    return rows


if __name__ == "__main__":
    main()
