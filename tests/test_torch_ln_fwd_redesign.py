"""The launch geometry and the arithmetic order of the LayerNorm forward
(``csrc/layer_norm.cu``: ``ln_fwd_rows_kernel`` and
``ln_fwd_wide_kernel``), the wide LayerNorm backward
(``csrc/layer_norm_bwd.cu``: ``ln_bwd_wide_kernel``) and the rtc row
softmax (``chip_smoke.py``'s ``RTC_SOURCE`` ``softmax_fwd``), on the
CPU.

The plans are pure Python (``_ln_fwd_plan``, ``_ln_bwd_plan``,
``chip_smoke.rtc_softmax_geometry``): every row falls in exactly one
row group or CTA, every column in exactly one thread, the 16-byte
vector path only where C and alignment allow, and the wide kernels
past the widest C the registers hold.  Then each kernel's partition
and reduction order is emulated in torch (a thread's partial in its
column order, the warp's butterfly of shuffles, the warps added in
order) and held against mxtpu's Pallas kernels in interpreter mode at
``test_torch_kernels.py``'s tolerances (f32 1e-5, bf16 2e-2), and the
softmax's peel, body and tail against its plain version
(``RTC_PLAIN``'s ``torch.softmax``) in f64 to 1e-12.  The CUDA kernels
themselves run only on the card, through ``chip_smoke.py``.
"""
import importlib
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

tln = importlib.import_module("mxtpu_torch.kernels.layer_norm")
jln = importlib.import_module("mxtpu.kernels.layer_norm")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

ROWS = (1, 3, 37, 4096, 802816)
COLS = (3, 37, 64, 256, 768, 1024, 1030, 2048, 8192, 8193, 12257, 32768,
        131072)
ITEMSIZE = {"float32": 4, "bfloat16": 2}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SMS = 132   # the H100's SMs
W = tln.LN_WIDE_THREADS


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "interpret")


def _exactly_once(parts, n):
    got = np.concatenate([np.asarray(p, np.int64) for p in parts]) \
        if parts else np.zeros(0, np.int64)
    assert got.size == n
    assert np.array_equal(np.sort(got), np.arange(n))


# the kernels' partitions, as their index arithmetic computes them

def _groups(p):
    return tln.LN_BWD_WARPS // p.wpr


def _fwd_rows_of(p, cta, group, R):
    """The rows one row group of ``ln_fwd_rows_kernel`` takes (one, but
    for a grid capped below the rows)."""
    g = _groups(p)
    return range(cta * g + group, R, p.ctas * g)


def _row_columns_of(p, t, C):
    """The columns thread ``t`` of a row group owns, in the order it
    adds them."""
    G = 32 * p.wpr
    return [c for k in range(p.ept // p.vec)
            for c in range((k * G + t) * p.vec, (k * G + t + 1) * p.vec)
            if c < C]


def _wide_columns_of(p, t, C):
    """The columns thread ``t`` of a wide kernel's CTA owns, in order."""
    return [c for c0 in range(t * p.vec, C, W * p.vec)
            for c in range(c0, c0 + p.vec)]


# ------------------------------------------------------------ geometry

@pytest.mark.parametrize("dtype", list(ITEMSIZE))
@pytest.mark.parametrize("C", COLS)
def test_ln_fwd_plan_covers_every_row_and_column_once(C, dtype):
    it = ITEMSIZE[dtype]
    v = 16 // it
    for R in ROWS:
        for aligned in (True, False):
            p = tln._ln_fwd_plan(R, C, it, aligned)
            assert p.vec == (v if aligned and C % v == 0 else 1)
            # the wide kernel exactly past what 8 warps' registers hold
            assert p.wide == (C > tln.LN_ROWS_MAX_C)
            if p.wide:
                # a CTA a row, every column owned by one thread
                assert p.ctas == R
                _exactly_once([_wide_columns_of(p, t, C)
                               for t in range(W)], C)
                continue
            first = next(s for s in tln.LN_FWD_SHAPES if C <= s[0])
            assert first[1:] == (p.ept, p.wpr)
            assert p.ept % p.vec == 0 and 32 * p.wpr * p.ept >= C
            # one row a row group: the grid's groups just cover the rows
            assert p.ctas * _groups(p) >= R > (p.ctas - 1) * _groups(p)
            if R <= 4096:
                _exactly_once([_fwd_rows_of(p, b, q, R)
                               for b in range(p.ctas)
                               for q in range(_groups(p))], R)
                assert all(len(_fwd_rows_of(p, b, q, R)) == 1
                           for b in range(p.ctas) for q in range(_groups(p))
                           if b * _groups(p) + q < R)
            _exactly_once([_row_columns_of(p, t, C)
                           for t in range(32 * p.wpr)], C)


@pytest.mark.parametrize("dtype", list(ITEMSIZE))
@pytest.mark.parametrize("C", [c for c in COLS if c > tln.LN_ROWS_MAX_C])
def test_ln_bwd_wide_plan(C, dtype):
    it = ITEMSIZE[dtype]
    for R in ROWS:
        for aligned in (True, False):
            p = tln._ln_bwd_plan(R, C, it, aligned, SMS)
            assert p.wide and p.vec == (16 // it if aligned and
                                        C % (16 // it) == 0 else 1)
            # one CTA an SM, each with a row (the finalize kernel reads
            # every partial row of the grid)
            assert p.ctas == min(R, SMS)
            _exactly_once([range(b, R, p.ctas) for b in range(p.ctas)], R)
            _exactly_once([_wide_columns_of(p, t, C) for t in range(W)], C)


def test_fwd_plan_follows_alignment_of_the_data():
    # a row slice at an odd C and a view one element off a 16-byte
    # boundary take the scalar path; the aligned buffer the vector one
    odd = torch.zeros(11 * 1031)[1031:].view(10, 1031)
    off = torch.zeros(8 * 1024 + 1)[1:].view(8, 1024)
    for t in (odd, off):
        assert t.is_contiguous() and not tln.aligned16(t)
        assert tln._ln_fwd_plan(*t.shape, 4, tln.aligned16(t)).vec == 1
    full = torch.zeros(8, 1024)
    assert tln._ln_fwd_plan(8, 1024, 4, tln.aligned16(full)).vec == 4
    assert tln._ln_fwd_plan(8, 1024, 2, tln.aligned16(full)).vec == 8


def test_no_layer_norm_bound_left():
    # mxtpu's kernels take C up to 131072 (an 8-row block in 4 MiB); the
    # port's LayerNorm and its fused epilogue have no bound in either
    # direction: past their row kernels, the wide kernels take any C
    assert not hasattr(tln, "MAX_C") and not hasattr(tln, "BWD_MAX_C")
    assert not hasattr(tln, "FRLN_MAX_C") and \
        not hasattr(tln, "FRLN_BWD_MAX_C")
    assert jln._row_block(8, 131072) == 8
    for C in (12257, 131072, 131073):
        assert tln._ln_fwd_plan(8, C, 4, True).wide
        assert tln._ln_bwd_plan(8, C, 4, True, SMS).wide
        # the fused forward's row instances reach C = 12288 on the
        # 16-byte path, 4096 on the scalar one (C = 12257, 131073)
        assert tln._frln_fwd_plan(8, C, 4, True, SMS).wide == \
            (C > tln.FRLN_FWD_SHAPES[-1][0] == 12288 or C % 4 != 0)
        assert tln.FRLN_FWD_SCALAR_MAX_C == 4096
        assert tln._frln_bwd_plan(8, C, 4, True, SMS).wide


# --------------------------------------------- the reductions' order

def _butterfly(parts):
    """A warp's shuffle sum (xor 16, 8, 4, 2, 1) over its 32 lanes'
    partials (the last axis), as every lane ends with it."""
    v = parts
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lane ^ o]
    return v[..., 0]


def _thread_partials(vals, cols_of, nthreads):
    """Each thread's partial sum of ``vals[..., c]`` over its columns in
    its order, from 0: (..., nthreads).  A thread with fewer columns
    adds zeros (a padding column), which leaves its sum as it was."""
    lists = [cols_of(t) for t in range(nthreads)]
    C = vals.shape[-1]
    idx = torch.full((nthreads, max(map(len, lists))), C, dtype=torch.long)
    for t, cols in enumerate(lists):
        idx[t, :len(cols)] = torch.tensor(cols, dtype=torch.long)
    padded = torch.cat([vals, vals.new_zeros(vals.shape[:-1] + (1,))], -1)
    g = padded[..., idx]
    out = vals.new_zeros(vals.shape[:-1] + (nthreads,))
    for k in range(idx.shape[1]):
        out = out + g[..., k]
    return out


def _group_sum(vals, cols_of, nthreads):
    """The kernels' row sum: thread partials, a butterfly per warp, the
    warps added in order (the named-barrier exchange or block_sum)."""
    parts = _thread_partials(vals, cols_of, nthreads)
    warps = _butterfly(parts.reshape(parts.shape[:-1] + (-1, 32)))
    tot = torch.zeros(vals.shape[:-1], dtype=vals.dtype)
    for w in range(warps.shape[-1]):
        tot = tot + warps[..., w]
    return tot


def _emulate_ln_fwd(x, g, b, plan, eps=1e-5):
    """Either LayerNorm forward kernel in torch: the mean as the group's
    (or block's) sum over C, the variance as the same sum of the
    centred squares, y from the row in x's type."""
    C = x.shape[-1]
    if plan.wide:
        def cols_of(t):
            return _wide_columns_of(plan, t, C)
        n = W
    else:
        def cols_of(t):
            return _row_columns_of(plan, t, C)
        n = 32 * plan.wpr
    xf = x.float()
    mu = _group_sum(xf, cols_of, n) / C
    d = xf - mu[:, None]
    var = _group_sum(d * d, cols_of, n) / C
    rs = 1.0 / torch.sqrt(var + eps)
    y = d * rs[:, None] * g.float() + b.float()
    return y.to(x.dtype), mu, rs


def _pair(a, dtype):
    td, jd = DTYPES[dtype]
    return torch.from_numpy(a).to(td), jnp.asarray(a).astype(jd)


def _inputs(R, C, dtype, seed=12):
    rng = np.random.RandomState(seed)
    x = (rng.randn(R, C) * 2 + 0.5).astype(np.float32)
    dy = rng.randn(R, C).astype(np.float32)
    g = rng.uniform(0.5, 1.5, C).astype(np.float32)
    b = rng.randn(C).astype(np.float32)
    return [_pair(a, dtype) for a in (x, dy, g, b)]


def _close(got, want, dtype, what):
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), w.reshape(got.shape),
                               rtol=TOL[dtype], atol=TOL[dtype],
                               err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,C,aligned", [(16, 256, True), (16, 1024, True),
                                         (8, 1030, False), (8, 8192, True),
                                         (8, 12257, False),
                                         (8, 32768, True)])
def test_ln_fwd_partition_matches_pallas_kernel(R, C, aligned, dtype):
    (tx, jx), _, (tg, jg), (tb, jb) = _inputs(R, C, dtype)
    plan = tln._ln_fwd_plan(R, C, tx.element_size(), aligned)
    assert plan.wide == (C > tln.LN_ROWS_MAX_C)
    y, mean, rstd = _emulate_ln_fwd(tx, tg, tb, plan)
    wy, wmean, wrstd = jln._pallas_ln_fwd(jx, jg, jb, 1e-5, True)
    assert y.dtype == tx.dtype
    _close(y, wy, dtype, "y")
    _close(mean, wmean, "float32", "mean")
    _close(rstd, wrstd, "float32", "rstd")


def _emulate_ln_bwd_wide(x, g, mean, rstd, dy, plan):
    """``ln_bwd_wide_kernel`` then ``ln_bwd_finalize_kernel`` in torch:
    the two row sums in the block's order, dx per row; each CTA's
    partial row the sum of its rows (b, b + ctas, ...) in order, the
    partial rows summed by 32 row lanes and the lanes in order."""
    R, C = x.shape

    def cols_of(t):
        return _wide_columns_of(plan, t, C)
    xh = (x.float() - mean[:, None]) * rstd[:, None]
    d = dy.float()
    dyg = d * g.float()
    c1 = _group_sum(dyg, cols_of, W) / C
    c2 = _group_sum(dyg * xh, cols_of, W) / C
    dx = (rstd[:, None] * (dyg - c1[:, None] - xh * c2[:, None])).to(x.dtype)
    part = torch.zeros(2, plan.ctas, C)
    for blk in range(plan.ctas):
        for i, row in enumerate(range(blk, R, plan.ctas)):
            if i == 0:
                part[0, blk], part[1, blk] = d[row] * xh[row], d[row]
            else:
                part[0, blk] += d[row] * xh[row]
                part[1, blk] += d[row]
    lanes = torch.zeros(2, 32, C)
    for p in range(plan.ctas):
        lanes[:, p % 32] += part[:, p]
    tot = torch.zeros(2, C)
    for y in range(32):
        tot += lanes[:, y]
    return dx, tot[0].to(g.dtype), tot[1].to(g.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,C,sms", [(16, 12257, 3), (8, 32768, 4)])
def test_ln_bwd_wide_partition_matches_pallas_kernel(R, C, sms, dtype):
    (tx, jx), (tdy, jdy), (tg, jg), (tb, jb) = _inputs(R, C, dtype)
    _, mean, rstd = tln.layer_norm_fwd(tx, tg, tb)
    plan = tln._ln_bwd_plan(R, C, tx.element_size(), True, sms)
    # several CTAs with several rows each
    assert plan.wide and plan.ctas == sms and R > sms
    got = _emulate_ln_bwd_wide(tx, tg, mean, rstd, tdy, plan)
    _, vjp = jax.vjp(lambda a, c, d: jln._layer_norm_pallas(a, c, d, 1e-5),
                     jx, jg, jb)
    for name, t, w in zip(("dx", "dgamma", "dbeta"), got, vjp(jdy)):
        assert t.dtype == tx.dtype, name
        _close(t, w, dtype, name)


@pytest.mark.parametrize("C", [12257, 32768])
def test_public_layer_norm_wide_matches_mxtpu(C):
    # the public layer_norm, forward and gradients, at a C past the old
    # bounds (12256 forward, 8192 backward), against mxtpu's layer_norm
    # (its Pallas kernels, in interpreter mode)
    R = 8
    (tx, jx), (tdy, jdy), (tg, jg), (tb, jb) = _inputs(R, C, "float32")
    shape = (2, R // 2, C)
    txr = tx.reshape(shape).requires_grad_(True)
    tgr, tbr = tg.clone().requires_grad_(True), tb.clone().requires_grad_(True)
    y = tln.layer_norm(txr, tgr, tbr)
    y.backward(tdy.reshape(shape))
    wy, vjp = jax.vjp(lambda a, c, d: jln.layer_norm(a, c, d),
                      jx.reshape(shape), jg, jb)
    _close(y.detach(), wy, "float32", "y")
    for name, t, w in zip(("dx", "dgamma", "dbeta"),
                          (txr.grad, tgr.grad, tbr.grad),
                          vjp(jdy.reshape(shape))):
        _close(t, w, "float32", name)


# ---------------------------------------------------- the rtc softmax

RTC_ROWS = {"head": (128, 10), "mlm-slice": (6, 30522), "odd": (33, 30521)}


def test_softmax_constants_match_the_source():
    src = chip_smoke.RTC_SOURCE
    assert int(re.search(r"#define SM_WARP_COLS (\d+)", src).group(1)) == \
        chip_smoke.RTC_WARP_COLS
    assert int(re.search(r"#define SM_VEC (\d+)", src).group(1)) == \
        chip_smoke.RTC_VEC
    assert "__launch_bounds__(1024)" in src and \
        chip_smoke.RTC_ROW_THREADS <= 1024 and \
        32 * chip_smoke.RTC_WARP_ROWS <= 1024
    assert re.search(r"softmax_fwd\(const float \*x, float \*p, int rows, "
                     r"int cols\)", src)
    assert chip_smoke.RTC_SIGNATURES["softmax_fwd"] == \
        "const float *x, float *p, int rows, int cols"
    assert chip_smoke.RTC_ODD[1] % 4 != 0


def _softmax_partition(rows, cols, base=0):
    """softmax_fwd's assignment of each element of each row: (row, lane
    or thread, element list) for every worker of the launch, and the
    path of each row ("warp", "row" or "stream"), from the geometry the
    launcher gives and the row's byte offset (``base`` the pointer's
    offset from a 16-byte boundary; x and p alike)."""
    grid, block = chip_smoke.rtc_softmax_geometry(rows, cols)
    nt = block[0]
    work, path = [], {}
    if cols <= chip_smoke.RTC_WARP_COLS:
        for b in range(grid[0]):
            for w in range(nt // 32):
                row = b * (nt // 32) + w
                if row >= rows:
                    continue
                path[row] = "warp"
                for lane in range(32):
                    work.append((row, lane, [lane + 32 * k for k in range(32)
                                             if lane + 32 * k < cols]))
        return work, path, nt
    for row in range(grid[0]):
        if row >= rows:
            continue
        off = (base + 4 * row * cols) % 16
        h = ((16 - off) % 16) // 4
        nv = (cols - h) // 4
        tl = cols - h - 4 * nv
        if nv > chip_smoke.RTC_VEC * nt:
            path[row] = "stream"
            for t in range(nt):
                work.append((row, t, list(range(t, cols, nt))))
            continue
        path[row] = "row"
        for t in range(nt):
            own = [t] if t < h else []
            for k in range(chip_smoke.RTC_VEC):
                i = t + k * nt
                if i < nv:
                    own += list(range(h + 4 * i, h + 4 * i + 4))
            if t < tl:
                own.append(h + 4 * nv + t)
            work.append((row, t, own))
    return work, path, nt


@pytest.mark.parametrize("shape", list(RTC_ROWS.values()),
                         ids=list(RTC_ROWS))
def test_rtc_softmax_partition_matches_plain(shape):
    rows, cols = shape
    work, path, nt = _softmax_partition(rows, cols)
    # every element of every row owned once; one launch of the right
    # path a row
    for r in range(rows):
        _exactly_once([own for row, _, own in work if row == r], cols)
    assert len(path) == rows
    want_path = "warp" if cols <= chip_smoke.RTC_WARP_COLS else "row"
    assert set(path.values()) == {want_path}
    if want_path == "row":
        # 30522 floats: every other row starts 8 bytes off a 16-byte
        # boundary (a peel of 2); 30521 walks all four offsets
        peels = {((16 - 4 * r * cols % 16) % 16) // 4 for r in range(rows)}
        assert peels == ({0, 2} if cols % 4 == 2 else {0, 1, 2, 3})
    x = torch.from_numpy(np.random.RandomState(21).randn(rows, cols) * 4)
    # each worker's max and sum of exp over its elements, combined as the
    # warp's or block's reduction (in f64: the order is the point only
    # through the partition)
    m = torch.full((rows,), -np.inf, dtype=torch.float64)
    for row, _, own in work:
        if own:
            m[row] = max(m[row], x[row, own].max())
    s = torch.zeros(rows, dtype=torch.float64)
    for row, _, own in work:
        if own:
            s[row] += torch.exp(x[row, own] - m[row]).sum()
    p = torch.empty_like(x)
    for row, _, own in work:
        p[row, own] = torch.exp(x[row, own] - m[row]) / s[row]
    want = chip_smoke.rtc_plain("softmax_fwd", x)
    np.testing.assert_allclose(p.numpy(), want.numpy(), rtol=1e-12, atol=0)


def test_rtc_softmax_past_the_registers_streams():
    # a row past RTC_VEC float4s a thread takes the three-pass path,
    # every element still owned once
    cols = 4 * chip_smoke.RTC_VEC * chip_smoke.RTC_ROW_THREADS + 7
    work, path, _ = _softmax_partition(2, cols)
    assert set(path.values()) == {"stream"}
    for r in range(2):
        _exactly_once([own for row, _, own in work if row == r], cols)
