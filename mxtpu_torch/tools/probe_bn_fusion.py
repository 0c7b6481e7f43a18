"""Training BatchNorm(+ReLU) chained K layers deep at each ResNet-50
stage shape, b256 bf16 NCHW (the port of ``tools/probe_bn_fusion.py``):
marginal ms per layer, forward alone and forward+backward, for

  ``library`` — ``F.batch_norm(training=True)`` + ReLU (PyTorch's own
                BatchNorm, cuDNN or native), the JAX tool's ``xla``
                mode;
  ``kernel``  — ``kernels.fused_bn_act`` (TPU kernels #8/#9), its
                ``pallas`` mode;
  ``oracle``  — ``bn_act_reference`` through autograd (plain PyTorch).

The mode is an argument, not an environment knob (the port has no
``MXTPU_FUSED_BN``), and the JAX tool's ``cb(f/b)`` column, a VMEM
channel block, is dropped.  Then a conv3x3 (cuDNN, NCHW) + BN + ReLU
chain at each bottleneck's inner width, forward+backward, library
against kernel (the JAX tool's ``MXTPU_PROBE_CONV=0`` skip has no
counterpart: the section always runs).

    python -m mxtpu_torch.tools.probe_bn_fusion [batch] [stage,...] [--device cpu]
"""
from __future__ import annotations

import argparse
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F

from ..context import resolve_device
from ..kernels import fused_bn_act
from ..kernels.batch_norm import bn_act_reference
from .microbench import device_name, sustained

__all__ = ["STAGES", "MODES", "bn_layer", "conv_bn_layer", "chain_forward",
           "chain_loss", "grad_step", "stage_data", "bn_chain_time",
           "conv_bn_chain_time", "main"]

# (name, C, H) — ResNet-50 stage shapes
STAGES = (("stem112", 64, 112), ("s1_56", 256, 56), ("s2_28", 512, 28),
          ("s3_14", 1024, 14), ("s4_7", 2048, 7))
MODES = ("library", "kernel", "oracle")


def bn_layer(mode: str, g: torch.Tensor, b: torch.Tensor,
             act: str = "relu") -> Callable[[torch.Tensor], torch.Tensor]:
    """One training BN(+ReLU) layer over NCHW x in ``mode``; g and b are
    f32 and go to the kernel in x's type, as the kernel takes them."""
    if mode == "kernel":
        return lambda x: fused_bn_act(x, g.to(x.dtype), b.to(x.dtype),
                                      act=act)[0]
    if mode == "library":
        def layer(x):
            y = F.batch_norm(x, None, None, g, b, True, 0.1, 1e-5)
            return torch.relu(y) if act == "relu" else y
        return layer
    if mode == "oracle":
        return lambda x: bn_act_reference(x, g, b, act=act)[0]
    raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def chain_forward(layer, K: int):
    """x -> K layers applied in turn."""
    def step(x):
        for _ in range(K):
            x = layer(x)
        return x
    return step


def chain_loss(layer, K: int):
    """x -> a quadratic loss of K layers (a linear loss gives a constant
    cotangent, and the backward would see the same dy every layer)."""
    def loss(x):
        for _ in range(K):
            x = layer(x)
        return x.float().square().sum() * 1e-6
    return loss


def grad_step(loss):
    """x -> x + d loss / dx * 1e-12 in x's type."""
    def step(x):
        x_ = x.detach().requires_grad_(True)
        dx, = torch.autograd.grad(loss(x_), x_)
        return x + dx.to(x.dtype) * 1e-12
    return step


def stage_data(shape, dtype=torch.bfloat16, device=None, seed: int = 0):
    """x0 ~ N(0, 1) of ``shape`` (NCHW), g ~ U(0.5, 1.5) and b ~ N(0, 1)
    f32 of C, made on the device from a torch generator (seeded
    ``seed``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    C = shape[1]
    x0 = torch.randn(*shape, generator=gen, device=dev).to(dtype)
    g = torch.rand(C, generator=gen, device=dev) + 0.5
    b = torch.randn(C, generator=gen, device=dev)
    return x0, g, b


def bn_chain_time(data, act: str, mode: str, K: int = 8,
                  grad: bool = False) -> float:
    """Marginal ms per BN layer: a K-layer chain under
    :func:`~mxtpu_torch.tools.microbench.sustained`."""
    x0, g, b = data
    layer = bn_layer(mode, g, b, act)
    step = grad_step(chain_loss(layer, K)) if grad else \
        chain_forward(layer, K)
    return sustained(step, x0, n=8, repeats=2) * 1e3 / K


def conv_bn_layer(mode: str, g: torch.Tensor, b: torch.Tensor,
                  w: torch.Tensor) -> Callable[[torch.Tensor], torch.Tensor]:
    """conv3x3 (NCHW x, OIHW w, pad 1; cuDNN) then BN + ReLU in
    ``mode``."""
    bn = bn_layer(mode, g, b, "relu")
    return lambda x: bn(F.conv2d(x, w, padding=1))


def conv_bn_chain_time(data, w: torch.Tensor, mode: str,
                       K: int = 6) -> float:
    """Marginal ms per conv3x3 (C -> C) + BN + ReLU layer,
    forward+backward."""
    x0, g, b = data
    layer = conv_bn_layer(mode, g, b, w)
    return sustained(grad_step(chain_loss(layer, K)), x0, n=8,
                     repeats=2) * 1e3 / K


def _cell(fn) -> dict:
    try:
        return {"status": "ok", "ms": fn()}
    except Exception as e:  # noqa: BLE001 — a row per measurement
        traceback.print_exc()
        return {"status": "FAILED",
                "error": f"{type(e).__name__}: {str(e)[:4000]}"}


def _fmt(cell: dict, width: int) -> str:
    return f"{cell['ms']:{width}.3f}" if cell["status"] == "ok" else \
        "FAILED".rjust(width)


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(prog="mxtpu_torch.tools.probe_bn_fusion")
    ap.add_argument("batch", nargs="?", type=int, default=256)
    ap.add_argument("only", nargs="?", default=None,
                    help="comma-separated stage names")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    batch, dtype = args.batch, torch.bfloat16
    print(f"device={device_name(dev)} batch={batch} dtype=bfloat16")
    stages = STAGES
    if args.only:
        only = args.only.split(",")
        stages = tuple(s for s in STAGES if s[0] in only)
    print(f"{'shape':>10} {'lib f':>7} {'ker f':>7} {'lib f+b':>8} "
          f"{'ker f+b':>8}  ms/layer")
    rows = []
    for name, C, H in stages:
        data = stage_data((batch, C, H, H), dtype, dev)
        row = {"stage": name, "C": C, "H": H, "N": batch}
        for mode in ("library", "kernel"):
            for grad, key in ((False, "f"), (True, "f+b")):
                row[f"{mode} {key}"] = _cell(
                    lambda: bn_chain_time(data, "relu", mode, grad=grad))
        del data
        rows.append(row)
        for k, cell in row.items():
            if isinstance(cell, dict) and cell["status"] == "FAILED":
                print(f"    [{name}] {k} error: {cell['error']}")
        print(f"{name:>10} {_fmt(row['library f'], 7)} "
              f"{_fmt(row['kernel f'], 7)} {_fmt(row['library f+b'], 8)} "
              f"{_fmt(row['kernel f+b'], 8)}")

    print("\nconv3x3+BN+relu chain (fwd+bwd, marginal ms/layer):")
    for name, C, H in stages:
        if name == "stem112":
            continue
        Ci = C // 4   # bottleneck inner width
        data = stage_data((batch, Ci, H, H), dtype, dev)
        gw = torch.Generator(device=dev).manual_seed(1)
        w = (torch.randn(Ci, Ci, 3, 3, generator=gw, device=dev) /
             (9 * Ci) ** 0.5).to(dtype)
        row = {"stage": name, "conv": True, "C": Ci, "H": H, "N": batch}
        for mode in ("library", "kernel"):
            row[mode] = _cell(lambda: conv_bn_chain_time(data, w, mode))
        del data
        rows.append(row)
        for mode in ("library", "kernel"):
            if row[mode]["status"] == "FAILED":
                print(f"    [{name}] {mode} error: {row[mode]['error']}")
        print(f"{name:>10} C={Ci:<5} library {_fmt(row['library'], 8)}  "
              f"kernel {_fmt(row['kernel'], 8)}")
    return rows


if __name__ == "__main__":
    main()
