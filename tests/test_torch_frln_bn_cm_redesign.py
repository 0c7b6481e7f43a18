"""The launch geometry and the arithmetic order of the channels-minor
BatchNorm forward (``csrc/batch_norm.cu``, ``bn_fwd_cm_*``) and of the
fused residual LayerNorm (``csrc/fused_residual_ln.cu``,
``csrc/fused_residual_ln_bwd.cu``: the backward's row kernel, and both
directions' wide kernels), on the CPU.

The geometry helpers (``_cm_plan``, ``_frln_fwd_plan``,
``_frln_bwd_plan``, ``_frln_words``) are pure Python in the port's
modules: these tests check that every (row, channel) of the BatchNorm
forward lands in exactly one thread slot in the stats pass's walk and in
the apply pass's reversed walk, that every row of the fused backward
lands in one row group of one CTA and every column in one thread, that
the partial buffers match the grids, that the vector path is picked only
where C and the alignment allow it, the wide kernels past the row
instances, and that the wide kernels' keep-bit words hold each element's
bit once.  The constants the Python plans mirror are read back from the
CUDA sources, and every ctypes binding of the kernel modules is held to
its C entry's parameter count, at the binding and at each call.

Then each kernel's passes are emulated in torch in the kernels' order
and held against mxtpu's Pallas kernels in interpreter mode: the
BatchNorm forward against ``_fwd_call_cm`` at ``test_torch_bn_kernels``'s
tolerances (f32 1e-5; bf16 one bf16 ulp, 2^-7), the fused backward's row
partition against ``jax.vjp`` of ``_fused_residual_ln_pallas`` at
``test_torch_kernels_bwd``'s (f32 1e-5, bf16 2e-2), its per-thread mask
bits against mxtpu's ``_mask_bits`` bit for bit.  The wide C plain
versions (both directions) are held against mxtpu's
``fused_residual_ln_reference`` and its vjp.  The CUDA kernels
themselves run only on the card, through ``chip_smoke.py``.
"""
import ast
import importlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

tln = importlib.import_module("mxtpu_torch.kernels.layer_norm")
tbn = importlib.import_module("mxtpu_torch.kernels.batch_norm")
jln = importlib.import_module("mxtpu.kernels.layer_norm")
jbn = importlib.import_module("mxtpu.kernels.batch_norm")

torch.set_num_threads(2)

CSRC = Path(tln.__file__).resolve().parent.parent / "csrc"
ITEMSIZE = {"float32": 4, "bfloat16": 2}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
SMS = 132   # the H100's SMs
KEY = (0x2545F491, 0x9E3779B9)
BN_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
LN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# the forward's rows in flight a thread (csrc/batch_norm.cu)
CM_FWD_UNROLL = 4


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "interpret")


def _pair(a, dtype):
    td, jd = DTYPES[dtype]
    return torch.from_numpy(a).to(td), jnp.asarray(a).astype(jd)


def _exactly_once(parts, n):
    """The index lists in ``parts`` tile range(n) with no overlap."""
    got = np.concatenate([np.asarray(p, np.int64) for p in parts]) \
        if parts else np.zeros(0, np.int64)
    assert got.size == n
    assert np.array_equal(np.sort(got), np.arange(n))


def _fma(a, b, c):
    """fmaf on f32 tensors: the product exact in f64, one rounding of
    the sum to f32 (its f64 rounding first can differ only in a tie)."""
    return (a.double() * b.double() + c.double()).float()


def _butterfly(v):
    """The xor butterfly (16, 8, 4, 2, 1) over the last axis of 32
    lanes, as every lane ends with it."""
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lane ^ o]
    return v[..., 0]


# ---------------------------------------------------- the constants

def test_plans_mirror_the_sources():
    bwd = (CSRC / "fused_residual_ln_bwd.cu").read_text()
    fwd = (CSRC / "fused_residual_ln.cu").read_text()
    shapes = re.search(r"#define FRLN_SHAPES\(X\)((?:.|\n)*?)\n\n", bwd)
    got = tuple(tuple(int(v) for v in m) for m in re.findall(
        r"X\((\d+), (\d+), (\d+)\)", shapes.group(1)))
    assert got == tln.FRLN_BWD_SHAPES
    common = (CSRC / "common.cuh").read_text()
    assert f"constexpr int FRLN_WIDE_THREADS = " \
        f"{tln.FRLN_WIDE_THREADS};" in common
    # the keep bits have one storage, device memory
    assert "FRLN_SMEM_BITS" not in common + fwd + bwd
    assert not hasattr(tln, "FRLN_SMEM_BITS")
    assert "sbits" not in fwd + bwd
    # on the 16-byte path the forward's row instances take every C the
    # one-CTA-a-row kernel took (its row of f32 in 48 KB of shared
    # memory: C <= 12256), and that kernel's bound is gone
    assert "FRLN_ROW_MAX_C" not in fwd and \
        not hasattr(tln, "FRLN_FWD_ROW_MAX_C")
    assert tln.FRLN_FWD_SHAPES[-1][0] >= 48 * 1024 // 4 - 32 == 12256
    # the launch bounds' register rule, term for term
    assert "5 * E + 3 * E * eb / 4 + (VEC > 1 ? 0 : E) + 32" in bwd
    assert "return regs <= 128 ? 2 : 1;" in bwd
    assert f"constexpr int CM_THREADS = {tbn.CM_THREADS};" in common
    bn = (CSRC / "batch_norm.cu").read_text()
    assert f"constexpr int CM_FWD_UNROLL = {CM_FWD_UNROLL};" in bn
    # the old channels-minor forward is gone
    for gone in ("apply_body", "finalize_body", "apply_blocks"):
        assert gone not in bn
    for gone in ("_cm_fwd_grid", "CM_TILE", "TARGET_CTAS", "MIN_ROWS",
                 "APPLY_BLOCKS", "_apply_blocks"):
        assert not hasattr(tbn, gone)


def _c_entries():
    """Parameter count of each ``extern "C" int mxt_*`` entry of the
    CUDA sources."""
    out = {}
    for f in CSRC.glob("*.cu"):
        for m in re.finditer(r'extern "C" int (mxt_\w+)\(([^)]*)\)',
                             f.read_text()):
            out[m.group(1)] = len([a for a in m.group(2).split(",")
                                   if a.strip()])
    return out


@pytest.mark.parametrize("mod", ("batch_norm", "conv", "flash_attention",
                                 "layer_norm"))
def test_bindings_match_their_c_entries(mod):
    # every _build.bind names an entry of the sources with as many
    # argument types as its parameters, and every call of the bound
    # function without a starred argument passes that many
    module = importlib.import_module(f"mxtpu_torch.kernels.{mod}")
    tree = ast.parse(Path(module.__file__).read_text())
    entries = _c_entries()
    checked = 0
    for func in ast.walk(tree):
        if not isinstance(func, ast.FunctionDef):
            continue
        bound = {}
        for node in ast.walk(func):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call) and \
                    ast.unparse(node.value.func) == "_build.bind":
                symbol = node.value.args[1].value
                types = eval(ast.unparse(node.value.args[2]), vars(module))
                assert len(types) == entries[symbol], symbol
                bound[node.targets[0].id] = len(types)
        for node in ast.walk(func):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Name) and \
                    node.func.id in bound and \
                    not any(isinstance(a, ast.Starred) for a in node.args):
                assert len(node.args) == bound[node.func.id], \
                    f"{func.name}: {node.func.id}"
                checked += 1
    assert checked or mod == "batch_norm"


# --------------------------------- BatchNorm channels-minor forward (#10)

def _cm_walk(p, chunk, lane, R, reverse=False):
    """The rows one row lane of one chunk visits, in the order its
    kernel's unrolled loop issues them: the stats pass forwards, the
    apply pass from the lane's last row back."""
    r0 = chunk * p.per_chunk
    r1 = min(r0 + p.per_chunk, R)
    n = -(-(r1 - r0 - lane) // p.ly) if r0 + lane < r1 else 0
    out = []
    for i in range(0, n, CM_FWD_UNROLL):
        for u in range(CM_FWD_UNROLL):
            if i + u < n:
                k = n - 1 - (i + u) if reverse else i + u
                out.append(r0 + lane + k * p.ly)
    return out


def _cm_channels(p, tile, t, C):
    if t >= p.ly * p.tv:
        return range(0)
    c0 = (tile * p.tv + t % p.tv) * p.vec
    return range(min(c0, C), min(c0 + p.vec, C))


@pytest.mark.parametrize("dtype", list(ITEMSIZE))
@pytest.mark.parametrize("C", (3, 37, 64, 256, 1030, 2048))
def test_bn_cm_fwd_plan_covers_every_element_once(C, dtype):
    it = ITEMSIZE[dtype]
    v = 16 // it
    for R in (1, 37, 401, 3136, 802816):
        for aligned in (True, False):
            p = tbn._cm_plan(R, C, it, aligned, SMS)
            assert p.vec == (v if aligned and C % v == 0 else 1)
            assert 1 <= p.chunks <= tbn.MAX_CHUNKS
            assert p.chunks <= -(-SMS * tbn.CM_CTAS_PER_SM // p.tiles)
            # the forward's workspace: partial sums per (chunk, channel),
            # then scale and shift
            assert tbn._work_floats(p.chunks, C, 2) == \
                2 * p.chunks * C + 2 * C
            # the channels: each owned by one thread of a row lane of
            # one tile (every row lane owns the same ones), none by a
            # thread past the row lanes
            _exactly_once([_cm_channels(p, tile, t, C)
                           for tile in range(p.tiles)
                           for t in range(p.tv)], C)
            for lane in range(1, p.ly):
                assert all(_cm_channels(p, 0, lane * p.tv + t, C) ==
                           _cm_channels(p, 0, t, C) for t in range(p.tv))
            assert not any(len(_cm_channels(p, 0, t, C))
                           for t in range(p.ly * p.tv, tbn.CM_THREADS))
            if R > 3136:
                continue   # the row walk at ResNet's size: below
            for rev in (False, True):
                # every (row, channel) in one thread slot: each channel
                # in one thread of a tile, each row in one lane of one
                # chunk, and each lane visits its rows once
                walks = [_cm_walk(p, k, lane, R, rev)
                         for k in range(p.chunks) for lane in range(p.ly)]
                _exactly_once(walks, R)
            for k in range(p.chunks):
                for lane in range(p.ly):
                    assert _cm_walk(p, k, lane, R, True) == \
                        _cm_walk(p, k, lane, R)[::-1]


def test_bn_cm_fwd_plan_at_resnet_shapes():
    # NHWC ResNet-50 at N = 256: one wave of 2 CTAs an SM, the 16-byte
    # path, and every lane of a chunk busy
    for C, S in ((64, 12544), (256, 3136), (512, 784), (2048, 49)):
        R = 256 * S
        for it in (2, 4):
            p = tbn._cm_plan(R, C, it, True, SMS)
            assert p.vec == 16 // it
            assert p.tiles * p.chunks <= SMS * tbn.CM_CTAS_PER_SM
            assert p.per_chunk >= p.ly * tbn.CM_MIN_ROWS
            assert sum(len(_cm_walk(p, p.chunks - 1, lane, R))
                       for lane in range(p.ly)) == \
                R - (p.chunks - 1) * p.per_chunk


def test_bn_cm_fwd_plan_follows_alignment_of_the_data():
    off = torch.zeros(3136 * 256 + 1)[1:].view(3136, 256)
    assert off.is_contiguous() and not tbn.aligned16(off)
    assert tbn._cm_plan(3136, 256, 4, tbn.aligned16(off), SMS).vec == 1
    full = torch.zeros(3136, 256)
    assert tbn._cm_plan(3136, 256, 4, tbn.aligned16(full), SMS).vec == 4


def _emulate_cm_fwd(x, r, g, b, eps, act, plan):
    """``bn_fwd_cm_stats_kernel``, ``bn_fwd_cm_finalize_kernel`` and
    ``bn_fwd_cm_apply_kernel`` in torch, in their order of operations:
    per chunk, each row lane's sums over its rows in the walk's order
    (x^2 by fmaf), the lanes in lane order; per channel, 32 lanes adding
    chunks lane, lane + 32, ... in double and a butterfly, then mean,
    var, scale and shift rounded as the kernel rounds them; y from the
    reversed walk, one rounding a step."""
    R, C = x.shape
    xf = x.float()
    part = torch.zeros(2, plan.chunks, C)
    for k in range(plan.chunks):
        s = torch.zeros(2, plan.ly, C)
        for lane in range(plan.ly):
            for row in _cm_walk(plan, k, lane, R):
                s[0, lane] = s[0, lane] + xf[row]
                s[1, lane] = _fma(xf[row], xf[row], s[1, lane])
        for lane in range(plan.ly):
            part[:, k] = part[:, k] + s[:, lane]
    lanes = torch.zeros(2, C, 32, dtype=torch.float64)
    for k in range(plan.chunks):
        lanes[:, :, k % 32] += part[:, k].double()
    a, bb = _butterfly(lanes)
    n = float(R)
    m = a / n
    v = (bb / n - m * m).clamp_min(0.0)
    mf, vf = m.float(), v.float()
    rs = torch.rsqrt(vf + eps)
    sc = g.float() * rs
    sh = b.float() - mf * sc
    y = torch.empty_like(xf)
    for k in range(plan.chunks):
        for lane in range(plan.ly):
            rows = _cm_walk(plan, k, lane, R, reverse=True)
            t = xf[rows] * sc + sh
            if r is not None:
                t = t + r.float()[rows]
            if act == "relu":
                t = t.clamp_min(0.0)
            y[rows] = t
    return y.to(x.dtype), mf, vf


# (R, SMs) a C is run at: several chunks of rows, the last one short
# (C = 3 has 85 row lanes of at least 4 rows a chunk; C = 2048 eight
# channel tiles)
BN_CM_RUNS = {3: (1003, 3), 37: (203, 3), 64: (203, 3), 256: (203, 3),
              1030: (203, 3), 2048: (203, 12)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act,add", [("none", False), ("relu", True)])
@pytest.mark.parametrize("C", tuple(BN_CM_RUNS))
def test_bn_cm_fwd_three_passes_match_pallas_kernel(C, act, add, dtype):
    R, sms = BN_CM_RUNS[C]
    rng = np.random.RandomState(3)
    x = (0.5 + 2.0 * rng.randn(R, C)).astype(np.float32)
    x[:, 0] = 0.1   # a constant channel: var clamped at 0 or a rounding
    r = rng.randn(R, C).astype(np.float32) if add else None
    g = (1.0 + 0.2 * rng.randn(C)).astype(np.float32)
    b = (0.1 * rng.randn(C)).astype(np.float32)
    (tx, jx), (tg, jg), (tb, jb) = (_pair(a, dtype) for a in (x, g, b))
    tr, jr = _pair(r, dtype) if add else (None, None)
    aligned = C % (16 // tx.element_size()) == 0
    plan = tbn._cm_plan(R, C, tx.element_size(), aligned, sms)
    assert plan.chunks > 1 and R % plan.per_chunk != 0
    y, mean, var = _emulate_cm_fwd(tx, tr, tg, tb, 1e-5, act, plan)
    jy, jmean, jvar = jbn._fwd_call_cm(jx, jg, jb, jr, 1e-5, act, C, True)
    tol = BN_TOL[dtype]
    for name, t, w, tl in (("y", y, jy, tol), ("mean", mean, jmean, 1e-5),
                           ("var", var, jvar, 1e-5)):
        w = np.asarray(jnp.asarray(w).astype(jnp.float32)).reshape(t.shape)
        if name == "y":
            # the constant channel's y is its rounding noise times
            # rsqrt(eps) = 316: mxtpu's f32 sums leave var a rounding
            # above 0 (3.6e-9 in f32), the kernel's double sums leave
            # it 0, and the two scales differ by 2e-4.  Both hold var
            # within a rounding of 0 (below); y is compared elsewhere.
            t, w = t[:, 1:], w[:, 1:]
        np.testing.assert_allclose(t.float().numpy(), w, rtol=tl, atol=tl,
                                   err_msg=name)
    assert 0.0 <= float(var[0]) <= 1e-6
    # the plain version the wrapper takes on the CPU agrees too (its
    # f32 sums leave the constant channel as mxtpu's do)
    py, pmean, pvar = tbn.bn_fwd_cm(tx, tg, tb, tr, 1e-5, act)
    np.testing.assert_allclose(y[:, 1:].float().numpy(),
                               py[:, 1:].float().numpy(), rtol=tol, atol=tol)
    np.testing.assert_allclose(var.numpy(), pvar.numpy(), rtol=1e-5,
                               atol=1e-5)


# ------------------------- fused residual LayerNorm backward (#7): rows

def _frln_groups(p):
    return tln.LN_BWD_WARPS // p.wpr


def _frln_rows_of(p, cta, group, R):
    g = _frln_groups(p)
    return range(cta * g + group, R, p.ctas * g)


def _frln_columns_of(p, t, C):
    """The columns thread ``t`` of a row group owns, in its register
    order (bit k * vec + j of its keep word)."""
    G = 32 * p.wpr
    return [c for k in range(p.ept // p.vec)
            for c in range((k * G + t) * p.vec, (k * G + t + 1) * p.vec)
            if c < C]


@pytest.mark.parametrize("dtype", list(ITEMSIZE))
@pytest.mark.parametrize("C", (3, 37, 64, 768, 1024, 1030, 2048, 4096))
def test_frln_bwd_plan_covers_every_row_and_column_once(C, dtype):
    it = ITEMSIZE[dtype]
    v = 16 // it
    for R in (1, 3, 37, 4096, 802816):
        for aligned in (True, False):
            p = tln._frln_bwd_plan(R, C, it, aligned, SMS)
            assert p.vec == (v if aligned and C % v == 0 else 1)
            first = next(s for s in tln.FRLN_BWD_SHAPES if C <= s[0])
            assert first[1:] == (p.ept, p.wpr) and not p.wide
            assert p.ept % p.vec == 0 and 32 * p.wpr * p.ept >= C
            # a thread's keep bits fit one register
            assert p.ept <= 32
            mb = tln._frln_min_blocks(p.ept, it, p.vec)
            assert 1 <= p.ctas <= SMS * mb
            if R < 4096:
                _exactly_once([_frln_rows_of(p, b, q, R)
                               for b in range(p.ctas)
                               for q in range(_frln_groups(p))], R)
                # every CTA has a row: its partial rows are the grid's
                assert all(len(_frln_rows_of(p, b, 0, R))
                           for b in range(p.ctas))
            _exactly_once([_frln_columns_of(p, t, C)
                           for t in range(32 * p.wpr)], C)
    big = tln._frln_bwd_plan(802816, C, it, True, SMS)
    assert big.ctas == SMS * tln._frln_min_blocks(big.ept, it, big.vec)


def test_frln_bwd_plan_at_bert_shape():
    # BERT-Large training: R = 32 * 128, C = 1024; 2 CTAs an SM on the
    # 16-byte path in both types, 4 warps a row, 8 elements a thread
    for it in (2, 4):
        p = tln._frln_bwd_plan(4096, 1024, it, True, SMS)
        assert (p.vec, p.ept, p.wpr, p.ctas) == (16 // it, 8, 4, 2 * SMS)
    # one partial row of each gradient per CTA: 264 where the old
    # kernel wrote 512 (a CTA per 8 rows)
    assert 3 * p.ctas * 1024 * 4 < 3 * 512 * 1024 * 4


@pytest.mark.parametrize("C", (4097, 8192, 12257, 32768, 131072))
def test_frln_wide_plans(C):
    for it in (2, 4):
        for aligned in (True, False):
            v = 16 // it if aligned and C % (16 // it) == 0 else 1
            f = tln._frln_fwd_plan(300, C, it, aligned, SMS)
            b = tln._frln_bwd_plan(300, C, it, aligned, SMS)
            assert b.wide and b.vec == v and b.ctas == min(300, SMS)
            if C > (tln.FRLN_FWD_SHAPES[-1][0] if v > 1 else
                    tln.FRLN_FWD_SCALAR_MAX_C):
                # as many CTAs as the SMs' threads take, never more than
                # the rows
                assert f.wide and f.vec == v and f.ctas == 300
                assert tln._frln_fwd_plan(5000, C, it, aligned,
                                          SMS).ctas == 4 * SMS
            else:
                # the forward's row kernel, a group of 8 warps a row (a
                # CTA) at these widths: on the 16-byte path every C the
                # one-CTA-a-row kernel took, on the scalar one up to
                # FRLN_FWD_SCALAR_MAX_C
                first = next(s for s in tln.FRLN_FWD_SHAPES if C <= s[0])
                assert f == tln.LnPlan(v, *first[1:], 300)
                assert first[2] == tln.LN_BWD_WARPS
            assert tln._frln_bwd_plan(7, C, it, aligned, SMS).ctas == 7
            assert tln._frln_fwd_plan(7, C, it, aligned, SMS).ctas == 7


@pytest.mark.parametrize("C", (1, 37, 1023, 1024, 1025, 12256))
def test_frln_fwd_row_plan_is_the_row_kernel(C):
    # the first row instance that takes C, its row groups each given one
    # of the 5 rows, 16-byte accesses where C allows (aligned bf16: C a
    # multiple of 8)
    p = tln._frln_fwd_plan(5, C, 2, True, SMS)
    first = next(s for s in tln.FRLN_FWD_SHAPES if C <= s[0])
    groups = tln.LN_BWD_WARPS // first[2]
    assert p == tln.LnPlan(8 if C % 8 == 0 else 1, *first[1:],
                           -(-5 // groups))
    assert not p.wide and 32 * p.wpr * p.ept >= C


def _ballot_word(C, vec):
    """The wide kernels' keep-bit layout: the (word, bit) that holds the
    element at each column, from the thread and slot that take it."""
    T = tln.FRLN_WIDE_THREADS
    where = {}
    for k in range(-(-C // (T * vec))):
        for t in range(T):
            for j in range(vec):
                c = (k * T + t) * vec + j
                if c < C:
                    w, lane = divmod(t, 32)
                    where[c] = ((k * (T // 32) + w) * vec + j, lane)
    return where


@pytest.mark.parametrize("C,vec", [(12257, 1), (12264, 8), (32768, 4),
                                   (32768, 8), (131072, 8)])
def test_frln_wide_keep_bits_hold_each_element_once(C, vec):
    where = _ballot_word(C, vec)
    assert sorted(where) == list(range(C))
    slots = set(where.values())
    assert len(slots) == C
    words = tln._frln_words(C, vec)
    assert max(w for w, _ in slots) < words
    # C / 8 bytes of bits, up to a slot's padding: 16 KB at C = 131072
    assert 4 * words <= C // 8 + 4 * (tln.FRLN_WIDE_THREADS // 32) * vec
    if C == 131072:
        assert 4 * words == 16 * 1024


@pytest.mark.parametrize("C", (12257, 131072, 393216, 400000))
def test_frln_wide_keep_bits_scratch(C):
    # a wide kernel with the mask gets a row of device memory a CTA for
    # its bits, at every C; no mask or a row kernel, none
    cpu = torch.device("cpu")
    for plan in (tln.LnPlan(8, 0, 0, 4), tln.LnPlan(1, 0, 0, 3),
                 tln._frln_fwd_plan(4, 131072, 2, True, SMS),
                 tln._frln_fwd_plan(3, 131073, 4, True, SMS)):
        t = tln._mask_scratch(plan, C, 0.9, cpu)
        assert t.shape == (plan.ctas, tln._frln_words(C, plan.vec)) and \
            t.dtype == torch.int32
        assert tln._mask_scratch(plan, C, 1.0, cpu) is None
    assert tln._mask_scratch(tln.LnPlan(1, 8, 4, 3), 1024, 0.9,
                             cpu) is None
    assert tln._mask_scratch(tln._frln_fwd_plan(3, 1024, 2, True, SMS),
                             1024, 0.9, cpu) is None


def _frln_inputs(seed, R, C, dtype):
    rng = np.random.RandomState(seed)
    h, res, dy = (rng.randn(R, C).astype(np.float32) for _ in range(3))
    bias, beta = (rng.randn(C).astype(np.float32) for _ in range(2))
    g = rng.uniform(0.5, 1.5, C).astype(np.float32)
    return [_pair(a, dtype) for a in (h, res, dy, bias, g, beta)]


def _emulate_frln_bwd(h, bias, res, g, mean, rstd, dy, keep, plan):
    """``frln_bwd_rows_kernel`` then ``frln_bwd_finalize_kernel`` in
    torch: each thread's keep bits drawn from its own counters; per row,
    each thread's partial sums over its columns in its order, a warp
    butterfly and the group's warps in order; du, dh and dres; each row
    group's dgamma/dbeta/dbias over its rows in row order, the CTA's
    groups added in group order into its partial rows, summed by 32 row
    lanes and the lanes in order, then cast.  Returns (dh, dbias, dres,
    dgamma, dbeta) and the keep mask the threads drew."""
    R, C = h.shape
    G = 32 * plan.wpr
    cols = [_frln_columns_of(plan, t, C) for t in range(G)]
    width = max(map(len, cols))
    idx = torch.full((G, width), C, dtype=torch.long)
    for t, cs in enumerate(cols):
        idx[t, :len(cs)] = torch.tensor(cs, dtype=torch.long)
    kept = torch.ones(R, C, dtype=torch.bool)
    use = keep < 1.0
    inv = tln._inv_keep(keep) if use else 1.0
    if use:
        thresh = tln.keep_thresh(keep)
        for t, cs in enumerate(cols):
            c = torch.tensor(cs, dtype=torch.int64)
            ctr = (torch.arange(R, dtype=torch.int64)[:, None] * C
                   + c[None, :]) & 0xFFFFFFFF
            bits, _ = tln._threefry2x32(KEY[0], KEY[1], ctr,
                                        torch.zeros_like(ctr))
            kept[:, c] = bits < thresh
    hb = h.float() + bias.float()
    if use:
        hb = torch.where(kept, hb * inv, torch.zeros_like(hb))
    u = res.float() + hb
    xh = (u - mean[:, None]) * rstd[:, None]
    d = dy.float()
    dyg = d * g.float()

    def row_sum(vals):
        pad = torch.cat([vals, vals.new_zeros(R, 1)], 1)[:, idx]
        part = torch.zeros(R, G)
        for k in range(width):
            part = part + pad[:, :, k]
        warps = _butterfly(part.reshape(R, plan.wpr, 32))
        tot = torch.zeros(R)
        for w in range(plan.wpr):
            tot = tot + warps[:, w]
        return tot
    c1 = row_sum(dyg) / C
    c2 = row_sum(dyg * xh) / C
    du = rstd[:, None] * (dyg - c1[:, None] - xh * c2[:, None])
    dhv = torch.where(kept, du * inv, torch.zeros_like(du)) if use else du
    part = torch.zeros(3, plan.ctas, C)
    for b in range(plan.ctas):
        for q in range(_frln_groups(plan)):
            acc = torch.zeros(3, C)
            for row in _frln_rows_of(plan, b, q, R):
                acc[0] += d[row] * xh[row]
                acc[1] += d[row]
                acc[2] += dhv[row]
            part[:, b] = acc if q == 0 else part[:, b] + acc
    lanes = torch.zeros(3, 32, C)
    for p in range(plan.ctas):
        lanes[:, p % 32] += part[:, p]
    tot = torch.zeros(3, C)
    for y in range(32):
        tot += lanes[:, y]
    return (dhv.to(h.dtype), tot[2].to(bias.dtype), du.to(res.dtype),
            tot[0].to(g.dtype), tot[1].to(g.dtype)), kept


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("keep", [1.0, 0.9])
@pytest.mark.parametrize("R,C,aligned,sms", [(40, 64, True, 2),
                                             (24, 1024, True, 3),
                                             (24, 1030, False, 2)],
                         ids=["C64", "C1024", "C1030-scalar"])
def test_frln_bwd_partition_matches_pallas_kernel(R, C, aligned, sms, keep,
                                                  dtype):
    (th, jh), (tres, jres), (tdy, jdy), (tbias, jbias), (tg, jg), \
        (tb, jb) = _frln_inputs(5, R, C, dtype)
    p = 1.0 - keep
    _, mean, rstd = tln.fused_residual_ln_fwd(th, tbias, tres, tg, tb, KEY,
                                              p)
    plan = tln._frln_bwd_plan(R, C, th.element_size(), aligned, sms)
    # several CTAs, several rows a row group
    assert plan.ctas > 1 and len(_frln_rows_of(plan, 0, 0, R)) > 1
    assert plan.vec == (16 // th.element_size() if aligned else 1)
    got, kept = _emulate_frln_bwd(th, tbias, tres, tg, mean, rstd, tdy,
                                  keep, plan)
    if keep < 1.0:
        bits = np.asarray(jln._mask_bits(jnp.uint32(KEY[0]),
                                         jnp.uint32(KEY[1]),
                                         jnp.uint32(0), R, C))
        want_kept = bits < jln._keep_thresh(keep)
        assert np.array_equal(kept.numpy(), want_kept)
        assert 0 < (~want_kept).sum() < want_kept.size
        # dh is 0 exactly where an element was dropped
        assert np.array_equal(got[0].float().numpy() == 0, ~want_kept)
    seed = jnp.asarray(np.array(KEY, np.uint32))
    _, vjp = jax.vjp(lambda *a: jln._fused_residual_ln_pallas(
        *a, seed, keep, 1e-5), jh, jbias, jres, jg, jb)
    tol = LN_TOL[dtype]
    for name, t, w in zip(("dh", "dbias", "dres", "dgamma", "dbeta"), got,
                          vjp(jdy)):
        assert t.dtype == th.dtype, name
        w = np.asarray(jnp.asarray(w).astype(jnp.float32))
        np.testing.assert_allclose(t.float().numpy(), w, rtol=tol, atol=tol,
                                   err_msg=name)


# ------------------------------- fused residual LayerNorm: wide C, plain

@pytest.mark.parametrize("C", (12257, 32768))
def test_frln_wide_plain_versions_match_mxtpu(C):
    R = 3
    (th, jh), (tres, jres), (tdy, jdy), (tbias, jbias), (tg, jg), \
        (tb, jb) = _frln_inputs(7, R, C, "float32")
    seed = jnp.asarray(np.array(KEY, np.uint32))
    y, mean, rstd = tln.fused_residual_ln_fwd(th, tbias, tres, tg, tb, KEY,
                                              0.1)
    jy, vjp = jax.vjp(lambda *a: jln.fused_residual_ln_reference(
        *a, seed, p=0.1), jh, jbias, jres, jg, jb)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    got = tln.fused_residual_ln_bwd(th, tbias, tres, tg, KEY, mean, rstd,
                                    tdy, 0.9)
    for name, t, w in zip(("dh", "dbias", "dres", "dgamma", "dbeta"), got,
                          vjp(jdy)):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    # the dropped set: mxtpu's bits, and dh's zeros
    bits = np.asarray(jln._mask_bits(jnp.uint32(KEY[0]), jnp.uint32(KEY[1]),
                                     jnp.uint32(0), R, C))
    dropped = bits >= jln._keep_thresh(0.9)
    assert np.array_equal(got[0].numpy() == 0, dropped)
