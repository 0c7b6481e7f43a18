"""Eager and device ms of ``TrainStep`` steps on BERT-Large (bf16
compute, b32 x T128, adam lr 1e-4, dropout 0.1) and ResNet-50 v1 NHWC
(bf16 compute, b256 x 224^2, SGD momentum 0.9, lr 0.1, wd 1e-4), for
the ``mxtpu_torch`` of a given source tree, so that a commit and its
parent are timed on one card in one session (run parent, change,
change, parent):

    python mxtpu_torch/tools/step_times.py [--tree DIR] [--out FILE]

``--tree`` (default: the checkout holding this file) is put first on
``sys.path`` before anything of ``mxtpu_torch`` is imported, so the
script runs by its path, not with ``-m``.  It uses only what both the
``torch.nn.Module`` models and the gluon Block models of the port offer
(``BERTModel``, ``resnet50_v1``, ``build_train_step``,
``SoftmaxCrossEntropyLoss``), with xavier weights in both.  Each model:
3 warm-up steps, then the median of 3 windows of 10 steps, each window
ended by ``torch.cuda.synchronize``; then one step under
``torch.profiler``, whose device events give the device ms a step.  One JSON line a model
goes to stdout and, with ``--out``, is appended to FILE.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

WARMUP, STEPS, WINDOWS = 3, 10, 3
BERT = dict(vocab=30522, units=1024, ffn=4096, layers=24, heads=16, b=32,
            t=128)
RESNET = dict(b=256, hw=224, classes=1000)
RANGES = ("forward_backward", "update", "run_steps")


def _settle(net, x1, device):
    """Xavier weights on ``device``: a Block's through ``initialize``
    (its deferred shapes then filled by one forward), another module's
    through the tree's ``initializer.initialize``."""
    import torch
    from mxtpu_torch import initializer
    if hasattr(net, "collect_params"):
        net.initialize(initializer.Xavier(), ctx=device)
        with torch.no_grad():
            net(x1)
        return net
    net = net.to(device)
    initializer.initialize(net, initializer.Xavier(),
                           torch.Generator(device=device).manual_seed(0))
    return net


def bert_case(device: str, cfg: Dict = BERT):
    import numpy as np
    import torch
    from mxtpu_torch import random as trandom
    from mxtpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxtpu_torch.models import BERTModel
    from mxtpu_torch.parallel import build_train_step
    trandom.seed(0)
    torch.manual_seed(0)
    v, t = cfg["vocab"], cfg["t"]
    net = BERTModel(v, cfg["units"], cfg["ffn"], cfg["layers"],
                    cfg["heads"], max_length=t, dropout=0.1)
    net = _settle(net, torch.zeros(1, t, device=device), device)
    ce = SoftmaxCrossEntropyLoss()

    def loss(pred, y):
        return ce(pred.reshape(-1, v), y.reshape(-1))
    step = build_train_step(net, loss, "adam", {"learning_rate": 1e-4},
                            compute_dtype="bfloat16", cast_batch=False,
                            device=device)
    toks = torch.from_numpy(np.random.RandomState(5).randint(
        0, v, (cfg["b"], t)).astype(np.float32)).to(device)
    return step, toks, toks


def resnet_case(device: str, cfg: Dict = RESNET):
    import numpy as np
    import torch
    from mxtpu_torch import random as trandom
    from mxtpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxtpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxtpu_torch.parallel import build_train_step
    trandom.seed(0)
    torch.manual_seed(0)
    hw = cfg["hw"]
    net = resnet50_v1(classes=cfg["classes"], layout="NHWC")
    net = _settle(net, torch.zeros(1, hw, hw, 3, device=device), device)
    step = build_train_step(net, SoftmaxCrossEntropyLoss(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9,
                             "wd": 1e-4},
                            compute_dtype="bfloat16", device=device)
    rng = np.random.RandomState(0)
    x = rng.randn(cfg["b"], hw, hw, 3).astype(np.float32)
    y = rng.randint(0, cfg["classes"], (cfg["b"],)).astype(np.float32)
    return step, torch.from_numpy(x).to(device), \
        torch.from_numpy(y).to(device)


def _sync(device: str) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def device_ms(step, x, y, device: str) -> Optional[float]:
    """The device time of one step: the sum of the profiler's device
    events (None when it recorded none)."""
    from torch.profiler import ProfilerActivity, profile
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(x, y)
        _sync(device)
    busy = sum(e.device_time_total for e in prof.events()
               if "CPU" not in str(e.device_type) and e.name not in RANGES)
    return busy / 1e3 if busy else None


def time_case(name: str, make, device: str, warmup: int = WARMUP,
              steps: int = STEPS, windows: int = WINDOWS) -> Dict:
    import torch
    t0 = time.perf_counter()
    step, x, y = make(device)
    losses = [float(step(x, y)) for _ in range(warmup)]
    _sync(device)
    setup_s = time.perf_counter() - t0
    window_ms: List[float] = []
    for _ in range(windows):
        t1 = time.perf_counter()
        out = [step(x, y) for _ in range(steps)]
        _sync(device)
        window_ms.append((time.perf_counter() - t1) / steps * 1e3)
        losses.append(float(out[-1]))
    dev = device_ms(step, x, y, device)
    del step, x, y
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    window_ms.sort()
    return {"model": name, "ms_per_step": window_ms[len(window_ms) // 2],
            "window_ms_per_step": window_ms, "device_ms": dev,
            "losses": losses, "setup_s": setup_s}


def card() -> Optional[str]:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import mxtpu_torch
    got = os.path.dirname(os.path.dirname(os.path.abspath(
        mxtpu_torch.__file__)))
    if got != tree:
        raise SystemExit(f"mxtpu_torch came from {got}, not {tree}")
    name = card()
    for model, make in (("BERT-Large bf16 b32 T128 adam", bert_case),
                        ("ResNet-50 v1 NHWC bf16 b256 sgd", resnet_case)):
        row = {"tree": args.tree, "card": name,
               **time_case(model, make, "cuda:0")}
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
