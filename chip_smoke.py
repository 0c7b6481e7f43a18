"""Drive mxtpu_torch on one NVIDIA GPU: build its kernels, hold each
against its plain PyTorch version, and serve BERT-Large through
InferenceServer → DynamicBatcher → ModelRunner.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each fatal on failure:
  1. build every kernel from ``mxtpu_torch/csrc`` (one nvcc per source,
     in parallel);
  2. each kernel against its plain version on the card, at the serving
     path's shapes (b=32, T=128, 16 heads of 64, C=1024), in f32 and
     bf16; flash attention also causal at T=127 and Tq != Tk; the fused
     epilogue at keep=0.9 with its dropout mask recovered from the
     output and compared bit for bit; times of the kernel, the plain
     version and one library call;
  3. BERT-Large (24 layers, 1024 units, vocab 30522, f32 weights from a
     numpy seed, carried in through ``params_from_mxtpu``) served to 4
     client threads sending 128 requests of lengths 16-128; every
     result checked, 0 requeues, launch counts read around the run;
  4. one served batch of 8 x 128 against the same model and weights run
     on the CPU (plain path).

Tolerances: a result r passes against the plain p when
|r - p| <= tol * max(1, |p|), tol = 1e-4 in f32 (another summation
order) and 2e-2 in bf16 (one bf16 rounding of the output); the served
logits against the CPU: 1e-3 (24 layers of f32 GEMMs in another order).

Kernel times are device time per call (torch.profiler: the sum of the
kernels a call launches), for the kernel, its plain version and the
library call alike; the kernel's wall time per call (CUDA events over
back-to-back calls, host launch cost included) is printed beside it.

Output: the card's name and power limit, per-kernel lines, serving
latency, a ``{"kernels": [...]}`` JSON line, and last the line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without CUDA or outside a checkout.  A full report goes to
``mxtpu_torch/_build/chip_smoke_report.json``.
"""
import json
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
VOCAB, UNITS, FFN, LAYERS, HEADS, MAXLEN = 30522, 1024, 4096, 24, 16, 512
B, T, D = 32, 128, UNITS // HEADS
N_REQUESTS, N_CLIENTS = 128, 4
# published H100 SXM peaks (NVIDIA data sheet), at the full 700 W limit
PEAK_BYTES = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SERVE_TOL = 1e-3


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def rel_err(got, want):
    """max |got - want| / max(1, |want|) and max |got - want|."""
    g, w = got.double(), want.double()
    d = (g - w).abs()
    return float((d / w.abs().clamp_min(1.0)).max()), float(d.max())


def time_ms(fn, iters=50, warmup=5):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_us(evt):
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def device_ms(fn, iters=20, warmup=3):
    """Device time of one call of ``fn``: the sum of every kernel it
    launches, from torch.profiler over ``iters`` calls.  Unlike
    :func:`time_ms` it leaves out the host's launch cost, which for a
    ~20 us kernel called from Python can exceed the kernel itself."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(_device_us(e) for e in prof.key_averages())
    if not total:
        fail("torch.profiler recorded no device time")
    return total / iters / 1e3


def timed(kernel, plain, library=None):
    """The timing fields of one kernel: device ms of the kernel, its
    plain version and the library call, plus the kernel's wall ms per
    call (events, host launch cost included)."""
    return {"ms": device_ms(kernel), "plain_ms": device_ms(plain),
            "library_ms": None if library is None else device_ms(library),
            "wall_ms": time_ms(kernel)}


def bound(nbytes, ops, dtype):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Checks:
    def __init__(self):
        self.failed = []
        self.rows = []

    def close(self, name, got, want, dtype):
        rel, absmax = rel_err(got, want)
        ok = rel <= TOL[dtype]
        self.rows.append({"check": name, "dtype": dtype,
                          "max_rel_err": rel, "max_abs_err": absmax,
                          "tol": TOL[dtype], "ok": ok})
        print(f"check {name} [{dtype}]: max_abs_err={absmax:.3e} "
              f"max_rel_err={rel:.3e} tol={TOL[dtype]} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            self.failed.append(f"{name} [{dtype}]")
        return absmax


# ----------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ----------------------------------------------------------------------

def kernel_phase(checks, gen):
    import torch
    import torch.nn.functional as F
    import importlib
    fa = importlib.import_module("mxtpu_torch.kernels.flash_attention")
    ln = importlib.import_module("mxtpu_torch.kernels.layer_norm")
    dev = torch.device("cuda", 0)
    R, C, BH = B * T, UNITS, B * HEADS
    scale = 1.0 / D ** 0.5
    out = {}

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    # -- flash attention ------------------------------------------------
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        q, k, v = (randn(BH, T, D, dtype=dt) for _ in range(3))
        o, lse = fa.flash_forward(q, k, v, False, scale)
        po, plse = fa.flash_forward_reference(q, k, v, False, scale)
        torch.cuda.synchronize()
        err = checks.close("flash_attention b32 T128", o, po, name)
        checks.close("flash_attention lse b32 T128", lse, plse, "float32")
        for causal, tq, tk in ((True, 127, 127), (True, 64, 127),
                               (False, 127, 127)):
            qs, ks, vs = (randn(BH, n, D, dtype=dt) for n in (tq, tk, tk))
            co, clse = fa.flash_forward(qs, ks, vs, causal, scale)
            cpo, cplse = fa.flash_forward_reference(qs, ks, vs, causal,
                                                    scale)
            torch.cuda.synchronize()
            tag = f"flash_attention causal={causal} Tq={tq} Tk={tk}"
            checks.close(tag, co, cpo, name)
            checks.close(tag + " lse", clse, cplse, "float32")
        q4, k4, v4 = (t.reshape(B, HEADS, T, D) for t in (q, k, v))
        nbytes = 4 * BH * T * D * q.element_size() + BH * T * 4
        ops = 4 * BH * T * T * D
        b_ms, b_by = bound(nbytes, ops, name)
        out[("flash_attention_fwd", name)] = {
            "max_abs_err": err,
            **timed(lambda: fa.flash_forward(q, k, v, False, scale),
                    lambda: fa.flash_forward_reference(q, k, v, False,
                                                       scale),
                    lambda: F.scaled_dot_product_attention(q4, k4, v4)),
            "bound_ms": b_ms, "bound_by": b_by}

    # -- LayerNorm ------------------------------------------------------
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        x = randn(R, C, dtype=dt)
        g = (1.0 + 0.1 * randn(C)).to(dt)
        b = (0.1 * randn(C)).to(dt)
        y, mean, rstd = ln.layer_norm_fwd(x, g, b)
        py, pmean, prstd = ln.layer_norm_reference(x, g, b)
        torch.cuda.synchronize()
        err = checks.close("layer_norm R4096 C1024", y, py, name)
        checks.close("layer_norm mean", mean, pmean, "float32")
        checks.close("layer_norm rstd", rstd, prstd, "float32")
        nbytes = 2 * R * C * x.element_size() + 2 * C * x.element_size() \
            + 2 * R * 4
        b_ms, b_by = bound(nbytes, 8 * R * C, name)
        out[("layer_norm_fwd", name)] = {
            "max_abs_err": err,
            **timed(lambda: ln.layer_norm_fwd(x, g, b),
                    lambda: ln.layer_norm_reference(x, g, b),
                    lambda: F.layer_norm(x, (C,), g, b)),
            "bound_ms": b_ms, "bound_by": b_by}

    # -- fused residual LayerNorm ------------------------------------------
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        h, res = randn(R, C, dtype=dt), randn(R, C, dtype=dt)
        bias = (0.1 * randn(C)).to(dt)
        g = (1.0 + 0.1 * randn(C)).to(dt)
        b = (0.1 * randn(C)).to(dt)
        args = (h, bias, res, g, b, None, 0.0, 1e-5, False)
        y, mean, rstd = ln.fused_residual_ln_fwd(*args)
        py, pmean, prstd = ln.fused_residual_ln_reference(*args)
        torch.cuda.synchronize()
        err = checks.close("fused_residual_ln keep=1", y, py, name)
        checks.close("fused_residual_ln mean", mean, pmean, "float32")
        checks.close("fused_residual_ln rstd", rstd, prstd, "float32")
        key = np.array([0x2545F491, 0x9E3779B9], np.uint32)
        dargs = (h, bias, res, g, b, key, 0.1, 1e-5, True)
        dy, _, _ = ln.fused_residual_ln_fwd(*dargs)
        dpy, _, _ = ln.fused_residual_ln_reference(*dargs)
        torch.cuda.synchronize()
        checks.close("fused_residual_ln keep=0.9", dy, dpy, name)
        nbytes = 3 * R * C * h.element_size() + 3 * C * h.element_size() \
            + 2 * R * 4
        b_ms, b_by = bound(nbytes, 10 * R * C, name)
        out[("fused_residual_ln_fwd", name)] = {
            "max_abs_err": err,
            **timed(lambda: ln.fused_residual_ln_fwd(*args),
                    lambda: ln.fused_residual_ln_reference(*args)),
            "bound_ms": b_ms, "bound_by": b_by}

    # dropout mask, bit for bit: with h = 1, bias = res = beta = 0 and
    # gamma = 1, u is 1/keep where kept and 0 where dropped, so y > 0
    # exactly where the kernel kept an element
    ones = torch.ones(R, C, device=dev)
    zc = torch.zeros(C, device=dev)
    key = np.array([0x12345678, 0x0BADF00D], np.uint32)
    y, _, _ = ln.fused_residual_ln_fwd(ones, zc, torch.zeros_like(ones),
                                       torch.ones(C, device=dev), zc, key,
                                       0.1, 1e-5, True)
    want = ln.mask_bits(int(key[0]), int(key[1]), 0, R, C, device=dev) \
        < ln.keep_thresh(0.9)
    mismatch = int(((y > 0) != want).sum())
    kept = float(want.float().mean())
    print(f"check fused_residual_ln keep=0.9 mask: {mismatch} of {R * C} "
          f"bits differ (kept share {kept:.4f}) "
          f"{'ok' if mismatch == 0 else 'FAIL'}", flush=True)
    checks.rows.append({"check": "fused_residual_ln keep=0.9 mask bits",
                        "mismatch": mismatch, "ok": mismatch == 0})
    if mismatch:
        checks.failed.append("fused_residual_ln dropout mask")
    return out


# ----------------------------------------------------------------------
# phase 3/4: BERT-Large served
# ----------------------------------------------------------------------

def mxtpu_params(seed):
    """Random BERT-Large weights named and ordered as mxtpu's
    ``collect_params()`` (and an exported ``.params`` file) has them."""
    rng = np.random.default_rng(seed)
    out = {}

    def w(name, shape, kind):
        if kind == "gamma":
            a = 1.0 + 0.05 * rng.standard_normal(shape, dtype=np.float32)
        elif kind == "bias":
            a = 0.02 * rng.standard_normal(shape, dtype=np.float32)
        else:
            a = 0.02 * rng.standard_normal(shape, dtype=np.float32)
        out[name] = a.astype(np.float32)

    w("bertmodel0_pos_embed", (MAXLEN, UNITS), "weight")
    w("embedding0_weight", (VOCAB, UNITS), "weight")
    w("embedding1_weight", (2, UNITS), "weight")
    w("layernorm0_gamma", (UNITS,), "gamma")
    w("layernorm0_beta", (UNITS,), "bias")
    for i in range(LAYERS):
        d, f = 4 * i, 2 * i
        w(f"dense{d}_weight", (3 * UNITS, UNITS), "weight")
        w(f"dense{d}_bias", (3 * UNITS,), "bias")
        w(f"dense{d + 1}_weight", (UNITS, UNITS), "weight")
        w(f"dense{d + 2}_weight", (FFN, UNITS), "weight")
        w(f"dense{d + 2}_bias", (FFN,), "bias")
        w(f"dense{d + 3}_weight", (UNITS, FFN), "weight")
        for j in (f, f + 1):
            w(f"fusedresiduallayernorm{j}_bias", (UNITS,), "bias")
            w(f"fusedresiduallayernorm{j}_gamma", (UNITS,), "gamma")
            w(f"fusedresiduallayernorm{j}_beta", (UNITS,), "bias")
    w(f"dense{4 * LAYERS}_weight", (VOCAB, UNITS), "weight")
    w(f"dense{4 * LAYERS}_bias", (VOCAB,), "bias")
    return out


def forward_breakdown(runner):
    """One forward of the (32, 128) bucket: its device time, the copy of
    its logits to the host, and device time by kernel family from
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    bucket = (B, T)
    rng = np.random.RandomState(SEED + 2)
    vals = runner._pad_stack(
        [{"data": rng.randint(0, VOCAB, T).astype(np.float32)}
         for _ in range(B)], bucket)
    fwd_ms = time_ms(lambda: runner.run_raw(vals, bucket), iters=10,
                     warmup=2)
    (logits,) = runner.run_raw(vals, bucket)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits.cpu().numpy()
    d2h_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.run_raw(vals, bucket)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fams = {"flash_attention_fwd": "fa_fwd_kernel",
            "layer_norm_fwd": "ln_fwd_kernel",
            "fused_residual_ln_fwd": "frln_fwd_kernel"}
    by = {k: 0.0 for k in (*fams, "gemm", "other")}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if not us:
            continue
        # whole-word match: "ln_fwd_kernel" is inside "frln_fwd_kernel"
        key = next((f for f, k in fams.items()
                    if re.search(rf"\b{k}\b", evt.key)), None)
        if key is None:
            low = evt.key.lower()
            key = "gemm" if any(w in low for w in (
                "gemm", "cutlass", "sm90_xmma", "ampere")) else "other"
        by[key] += us / 1e3
    busy = sum(by.values())
    out = {"forward_ms": fwd_ms, "logits_to_host_ms": d2h_ms,
           "profiled_wall_ms": wall_ms,
           "device_ms_by_family": by, "device_busy_ms": busy,
           "device_idle_share": (1.0 - busy / wall_ms) if busy else None}
    print(f"forward (32, 128): {fwd_ms:.3f} ms on the device (events); "
          f"logits to host {d2h_ms:.3f} ms; profiled: " +
          (", ".join(f"{k} {v:.3f} ms" for k, v in by.items())
           + f"; idle share {out['device_idle_share']:.4f}"
           if busy else "no device time recorded (not measured)"),
          flush=True)
    return out


def serve_phase(checks, params):
    import torch
    from mxtpu_torch import kernels
    from mxtpu_torch.models import bert_large
    from mxtpu_torch.serving import InferenceServer, ModelRunner

    t0 = time.perf_counter()
    runner = ModelRunner(bert_large(), params,
                         input_specs={"data": (None,)},
                         seq_buckets=[64, 128], max_batch_size=32)
    load_s = time.perf_counter() - t0
    warm = runner.warmup()
    print(f"serving: weights {runner.weight_bytes() / 2**30:.3f} GiB "
          f"loaded in {load_s:.1f} s; warmup of {len(warm)} buckets "
          f"{sum(warm.values()):.1f} s", flush=True)

    rng = np.random.RandomState(SEED + 1)
    lens = [int(n) for n in rng.randint(16, 129, N_REQUESTS)]
    toks = [rng.randint(0, VOCAB, n).astype(np.float32) for n in lens]
    results = [None] * N_REQUESTS
    errors = []
    server = InferenceServer(log_every_s=1e9)
    server.register("bert", runner)

    def client(idx):
        # a burst: every request of this client in flight at once, so
        # the batcher fills the b=32 buckets
        try:
            reqs = [(i, server.submit("bert", {"data": toks[i]},
                                      timeout_s=300.0)) for i in idx]
            for i, req in reqs:
                results[i] = req.result(timeout=360.0)[0]
        except Exception as e:  # noqa: BLE001 — reported as a failure
            errors.append(repr(e))

    threads = [threading.Thread(target=client,
                                args=(range(c, N_REQUESTS, N_CLIENTS),))
               for c in range(N_CLIENTS)]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()

    # phase 4 input: one batch of 8 x 128 through the server
    check_toks = [rng.randint(0, VOCAB, T).astype(np.float32)
                  for _ in range(8)]
    check_reqs = [server.submit("bert", {"data": x}, timeout_s=300.0)
                  for x in check_toks]
    served = [r.result(timeout=360.0)[0] for r in check_reqs]
    server.close()
    snap = server.stats("bert")
    ep_err = server._endpoint("bert", None).last_error

    if any(t.is_alive() for t in threads):
        checks.failed.append("client threads did not finish")
    if errors:
        checks.failed.append(f"request errors: {errors[:3]}")
    bad = [i for i, r in enumerate(results)
           if r is None or r.shape != (lens[i], VOCAB)
           or not np.isfinite(r).all()]
    if bad:
        checks.failed.append(f"{len(bad)} served results missing, of the "
                             f"wrong shape or not finite")
    requeues = snap["extras"].get("requeues", 0)
    if requeues:
        checks.failed.append(f"{requeues} requeues (last batch error: "
                             f"{ep_err!r})")
    print(f"kernels: launches in the serving run over "
          f"{N_REQUESTS} requests: {json.dumps(counts)}", flush=True)
    per_fwd = {"flash_attention_fwd": LAYERS, "layer_norm_fwd": 1,
               "fused_residual_ln_fwd": 2 * LAYERS}
    n_fwd = counts["layer_norm_fwd"]
    for name, per in per_fwd.items():
        if counts[name] == 0:
            checks.failed.append(f"kernel {name} never launched on the "
                                 f"main path")
        elif counts[name] != per * n_fwd:
            checks.failed.append(f"{name}: {counts[name]} launches for "
                                 f"{n_fwd} forwards, want {per} each")
    # one forward per batch: at least N/32 batches, at most N
    if not -(-N_REQUESTS // 32) <= n_fwd <= N_REQUESTS:
        checks.failed.append(f"{n_fwd} forwards for {N_REQUESTS} "
                             f"requests")
    rps = N_REQUESTS / wall
    lat = snap["latency_ms"]
    print(f"serving: {N_REQUESTS} requests from {N_CLIENTS} threads in "
          f"{wall:.3f} s = {rps:.2f} req/s; latency p50 {lat['p50']} ms "
          f"p99 {lat['p99']} ms; {n_fwd} forwards, mean batch "
          f"{snap['mean_batch_size']}, fill {snap['batch_fill_rate']}, "
          f"requeues {requeues}", flush=True)

    breakdown = forward_breakdown(runner)

    # the same model and weights on the CPU, plain path
    cpu_runner = ModelRunner(bert_large(), params,
                             input_specs={"data": (None,)},
                             seq_buckets=[128], max_batch_size=8,
                             device="cpu")
    (want,) = cpu_runner.infer({"data": np.stack(check_toks)})
    got = torch.from_numpy(np.stack(served))
    rel, absmax = rel_err(got, torch.from_numpy(want))
    ok = rel <= SERVE_TOL
    print(f"check served 8x128 logits vs CPU plain path: "
          f"max_abs_err={absmax:.3e} max_rel_err={rel:.3e} "
          f"tol={SERVE_TOL} {'ok' if ok else 'FAIL'}", flush=True)
    checks.rows.append({"check": "served 8x128 vs CPU", "max_abs_err":
                        absmax, "max_rel_err": rel, "tol": SERVE_TOL,
                        "ok": ok})
    if not ok:
        checks.failed.append("served logits differ from the CPU path")
    return counts, {"requests": N_REQUESTS, "clients": N_CLIENTS,
                    "wall_s": wall, "req_per_s": rps,
                    "p50_ms": lat["p50"], "p99_ms": lat["p99"],
                    "batches": snap["batches"],
                    "mean_batch_size": snap["mean_batch_size"],
                    "batch_fill_rate": snap["batch_fill_rate"],
                    "requeues": requeues, "warmup_s": sum(warm.values()),
                    "served_vs_cpu_max_abs_err": absmax,
                    "forward_b32_t128": breakdown}


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs an NVIDIA "
             "GPU")
    if not (ROOT / "mxtpu_torch" / "csrc").is_dir():
        fail(f"no mxtpu_torch package beside {Path(__file__).name}: run "
             f"it from the root of a checkout")
    sys.path.insert(0, str(ROOT))
    from mxtpu_torch.context import strict_f32
    from mxtpu_torch.kernels import _build
    strict_f32()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    per_src = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s for "
          f"{len(per_src)} sources in parallel "
          f"({', '.join(f'{k} {v:.2f} s' for k, v in per_src.items())})",
          flush=True)

    checks = Checks()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    timings = kernel_phase(checks, gen)
    for (name, dt), r in timings.items():
        lib = "null" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f}"
        print(f"time {name} [{dt}] (device ms per call): "
              f"kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"library_ms={lib} bound_ms={r['bound_ms']:.4f} "
              f"({r['bound_by']}); kernel wall_ms={r['wall_ms']:.4f} "
              f"(events, host launch included)", flush=True)

    t0 = time.perf_counter()
    params = mxtpu_params(SEED)
    print(f"weights: {len(params)} arrays from numpy seed {SEED} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    counts, serving = serve_phase(checks, params)

    meta = {
        "flash_attention_fwd": ("mxtpu_torch/csrc/flash_attention.cu",
                                "mxtpu/kernels/flash_attention.py:192"),
        "layer_norm_fwd": ("mxtpu_torch/csrc/layer_norm.cu",
                           "mxtpu/kernels/layer_norm.py:104"),
        "fused_residual_ln_fwd": ("mxtpu_torch/csrc/fused_residual_ln.cu",
                                  "mxtpu/kernels/layer_norm.py:355"),
    }
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name],
         **{k: timings[(name, "float32")][k]
            for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                      "bound_by", "library_ms")}}
        for name, (src, rep) in meta.items()]}

    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": per_src,
              "build_log": dict(_build.build_log), "checks": checks.rows,
              "timings": {f"{n}[{d}]": r for (n, d), r in timings.items()},
              "launches": counts, "serving": serving, "kernels": line,
              "failed": checks.failed}
    out_dir = ROOT / "mxtpu_torch" / "_build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_report.json").write_text(
        json.dumps(report, indent=1))

    if checks.failed:
        for f in checks.failed:
            print(f"chip_smoke: FAILED: {f}", file=sys.stderr)
        sys.exit(1)
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
