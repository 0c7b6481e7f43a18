"""Device ms of the greedy NMS call (``kernels.nms.nms_keep``: the mask
and sweep kernels) and of the MoE route kernel (``kernels.moe.route``)
at the main path's shapes, for the ``mxtpu_torch`` of a given source
tree, so that a commit and its parent are timed on one card in one
session (run parent, change, change, parent):

    python mxtpu_torch/tools/kernel_times.py [--tree DIR] [--out FILE]

``--tree`` (default: the checkout holding this file) is put first on
``sys.path`` before anything of ``mxtpu_torch`` is imported, so the
script runs by its path, not with ``-m``.  The inputs are
``chip_smoke.py``'s: the NMS at b2 x n256 (pixel IoU, thr 0.7), b8 x
n1704 with 400 sweeping rows (thr 0.5) and b2 x n6000 (pixel, thr 0.7),
class-aware, from ``nms_inputs``' seeds; the route on the logits of
bench.py's ``moe_ffn`` layer (T 8192, E 8, capacity 1280) from
``moe_inputs``' seed.  Each kernel's ms is its mean over the launches
torch.profiler records in a window of 20 calls after 3, summed over the
kernels of a call; the route also cold, a 128 MB write flushing the L2
before every call.  One JSON line goes to stdout and, with ``--out``,
is appended to FILE.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from typing import Dict, List, Optional, Sequence

NMS_CASES = ((2, 256, 256, True), (8, 1704, 400, False),
             (2, 6000, 6000, True))
NMS_SEED, CLASSES = 230, 20
MOE_T, MOE_E, MOE_D, MOE_H, MOE_CF, MOE_SEED = 8192, 8, 1024, 4096, 1.25, 320
FLUSH_MB, ITERS, WARMUP = 128, 20, 3


def card() -> Optional[str]:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def by_name(fn, word: str, iters: int = ITERS) -> Dict[str, float]:
    """Device ms per launch of each CUDA kernel whose name holds
    ``word``, over a profiled window of ``iters`` calls of ``fn`` (of
    three windows, the first that records every call's kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    best: Dict[str, float] = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        got, full = {}, True
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            m = re.search(rf"\w*{word}\w*", e.key)
            if m and us > 0:
                got[m.group(0)] = got.get(m.group(0), 0.0) + \
                    us / e.count / 1e3
                full = full and e.count >= iters
        if got and full:
            return got
        best = got or best
    if not best:
        raise SystemExit(f"torch.profiler recorded no kernel named *{word}*")
    return best


def nms_rows(dev: str) -> List[Dict]:
    import numpy as np
    import torch
    from mxtpu_torch.kernels import nms
    rows = []
    for k, (b, n, n_iter, pixel) in enumerate(NMS_CASES):
        rng = np.random.RandomState(NMS_SEED + k)
        scale = 600.0 if pixel else 1.0
        xy = rng.uniform(0, scale, (b, n, 2)).astype(np.float32)
        wh = rng.uniform(0, 0.2 * scale, (b, n, 2)).astype(np.float32)
        boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1)).to(dev)
        ids = torch.from_numpy(rng.randint(0, CLASSES, (b, n))
                               .astype(np.float32)).to(dev)
        keep0 = torch.from_numpy(rng.rand(b, n) > 0.1).to(dev)
        thr = 0.7 if pixel else 0.5
        got = nms.nms_keep(boxes, keep0, thr, n_iter, ids=ids, pixel=pixel)
        want = nms.nms_keep_reference(boxes, keep0, thr, n_iter, ids=ids,
                                      pixel=pixel)
        parts = by_name(lambda: nms.nms_keep(boxes, keep0, thr, n_iter,
                                             ids=ids, pixel=pixel), "nms_")
        rows.append({"case": f"b{b} n{n} n_iter{n_iter}", "pixel": pixel,
                     "equal": bool((got == want).all()),
                     "ms": sum(parts.values()), "ms_parts": parts})
    return rows


def route_row(dev: str) -> Dict:
    import torch
    from mxtpu_torch.kernels import moe as km
    from mxtpu_torch.parallel import moe
    layer = moe.MoEFFN(MOE_D, MOE_H, MOE_E, capacity_factor=MOE_CF,
                       seed=MOE_SEED, device=dev)
    g = torch.Generator(device=dev).manual_seed(MOE_SEED + 1)
    x = torch.randn(MOE_T, MOE_D, generator=g, device=dev).to(torch.bfloat16)
    C = moe.capacity_of(MOE_T, MOE_E, MOE_CF)
    logits = x.float() @ layer.gate_w.float()
    got, want = km.route(logits, C), km.route_reference(logits, C)
    ints = all(torch.equal(got[i], want[i]) for i in (1, 3, 4, 5))
    flush = torch.empty(FLUSH_MB << 18, dtype=torch.float32, device=dev)
    warm = sum(by_name(lambda: km.route(logits, C), "moe_route").values())
    cold = sum(by_name(lambda: (flush.zero_(), km.route(logits, C)),
                       "moe_route").values())
    return {"case": f"T{MOE_T} E{MOE_E} C{C}", "integer_maps_equal": ints,
            "ms_cold": cold, "ms_warm": warm}


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
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times needs a CUDA card")
    from mxtpu_torch.context import strict_f32
    strict_f32()
    row = {"tree": args.tree, "card": card(), "nms": nms_rows("cuda:0"),
           "moe_route": route_row("cuda:0")}
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
