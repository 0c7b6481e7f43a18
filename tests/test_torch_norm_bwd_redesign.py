"""The launch geometry and the arithmetic order of the LayerNorm backward
(``csrc/layer_norm_bwd.cu``) and the channels-minor BatchNorm backward
(``csrc/batch_norm_bwd.cu``, ``bn_bwd_cm_*``), on the CPU.

The geometry helpers (``_ln_bwd_plan``, ``_cm_plan``) are pure
Python in the port's modules: these tests check that every row falls in
exactly one CTA or chunk, every column or channel in exactly one thread,
that the partial buffers match the grid, and that the 16-byte vector
path is picked only where C and the alignment allow it.

Then each kernel's passes are emulated in torch in the kernels' order
(partial sums per CTA or chunk, in row order per row lane, added in a
fixed order) and held against mxtpu's Pallas kernels in interpreter
mode: LayerNorm through ``jax.vjp`` of ``_layer_norm_pallas`` at
``test_torch_kernels_bwd.py``'s tolerances (f32 1e-5, bf16 2e-2), the
BatchNorm backward against ``_bwd_call_cm`` at
``test_torch_bn_kernels.py``'s (f32 1e-5; bf16 one bf16 ulp, 2^-7).
The masked dy (dr, written by the stats pass with the add) is a select,
not a rounding: it must equal the plain version's bit for bit.  The
CUDA kernels themselves run only on the card, through
``chip_smoke.py``.
"""
import importlib

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

ROWS = (1, 3, 37, 4096, 802816)
COLS = (3, 37, 64, 768, 1024, 1030, 2048, 8192)
ITEMSIZE = {"float32": 4, "bfloat16": 2}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
SMS = 132   # the H100's SMs


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "interpret")


# the kernels' partitions, as their index arithmetic computes them

def _ln_groups(p):
    """Rows a CTA of ``ln_bwd_rows_kernel`` takes at a time."""
    return tln.LN_BWD_WARPS // p.wpr


def _ln_rows_of(p, cta, group, R):
    """The rows one row group of one CTA walks."""
    g = _ln_groups(p)
    return range(cta * g + group, R, p.ctas * g)


def _ln_columns_of(p, t, C):
    """The columns thread ``t`` of a row group owns, in every row."""
    G = 32 * p.wpr
    return [c for k in range(p.ept // p.vec)
            for c in range((k * G + t) * p.vec, (k * G + t + 1) * p.vec)
            if c < C]


def _cm_rows_of(p, chunk, lane, R):
    """The rows one row lane of one chunk of the channels-minor
    backward walks (in the stats pass's order; the apply pass takes
    them backwards)."""
    r0 = chunk * p.per_chunk
    return range(r0 + lane, min(r0 + p.per_chunk, R), p.ly)


def _cm_channels_of(p, tile, t, C):
    """The channels thread ``t`` of a CTA of channel tile ``tile`` owns
    (none for a thread past the row lanes)."""
    if t >= p.ly * p.tv:
        return range(0)
    c0 = (tile * p.tv + t % p.tv) * p.vec
    return range(min(c0, C), min(c0 + p.vec, C))


def _exactly_once(parts, n):
    """The ranges in ``parts`` tile range(n) with no overlap."""
    got = np.concatenate([np.asarray(p, np.int64) for p in parts]) \
        if parts else np.zeros(0, np.int64)
    assert got.size == n
    assert np.array_equal(np.sort(got), np.arange(n))


# ------------------------------------------------------------ geometry

@pytest.mark.parametrize("dtype", list(ITEMSIZE))
@pytest.mark.parametrize("C", COLS)
def test_ln_bwd_plan_covers_every_row_and_column_once(C, dtype):
    it = ITEMSIZE[dtype]
    v = 16 // it
    for R in ROWS:
        for aligned in (True, False):
            p = tln._ln_bwd_plan(R, C, it, aligned, SMS)
            # the vector path only where C and every pointer allow it
            assert p.vec == (v if aligned and C % v == 0 else 1)
            # one of the kernel's instances, the first that takes C
            first = next(s for s in tln.LN_BWD_SHAPES if C <= s[0])
            assert first[1:] == (p.ept, p.wpr)
            assert p.ept % p.vec == 0 and 32 * p.wpr * p.ept >= C
            # one partial row per CTA of the grid, and every CTA has a
            # row: the (2, ctas, C) buffer is the grid's, none left unset
            assert 1 <= p.ctas <= SMS * tln._ln_min_blocks(p.ept, it, p.vec)
            _exactly_once([_ln_rows_of(p, b, q, R) for b in range(p.ctas)
                           for q in range(_ln_groups(p))], R)
            assert all(len(_ln_rows_of(p, b, 0, R)) for b in range(p.ctas))
            # the columns of a row: each owned by one thread of a group
            _exactly_once([_ln_columns_of(p, t, C)
                           for t in range(32 * p.wpr)], C)
    # every CTA of the grid resident at once: 2 an SM on the vector
    # path up to C = 4096, 1 where the registers would spill
    big = tln._ln_bwd_plan(802816, C, it, True, SMS)
    assert big.ctas == SMS * tln._ln_min_blocks(big.ept, it, big.vec)
    if big.vec > 1 and C <= 4096:
        assert big.ctas == 2 * SMS


@pytest.mark.parametrize("dtype", list(ITEMSIZE))
@pytest.mark.parametrize("C", COLS)
def test_bn_cm_bwd_plan_covers_every_row_and_channel_once(C, dtype):
    it = ITEMSIZE[dtype]
    v = 16 // it
    for R in ROWS:
        for aligned in (True, False):
            p = tbn._cm_plan(R, C, it, aligned, SMS)
            assert p.vec == (v if aligned and C % v == 0 else 1)
            # a tile of at most 256 channels; the row lanes fill the CTA
            assert p.tv * p.vec <= tbn.CM_WIDTH
            assert p.ly == tbn.CM_THREADS // p.tv >= 1
            assert 1 <= p.chunks <= tbn.MAX_CHUNKS
            assert p.chunks <= -(-SMS * tbn.CM_CTAS_PER_SM // p.tiles)
            # chunks tile the rows, and the row lanes each chunk
            _exactly_once([range(k * p.per_chunk,
                                 min((k + 1) * p.per_chunk, R))
                           for k in range(p.chunks)], R)
            _exactly_once([_cm_rows_of(p, k, lane, R)
                           for k in range(p.chunks)
                           for lane in range(p.ly)], R)
            # the channels: each owned by one thread of one tile
            _exactly_once([_cm_channels_of(p, tile, t, C)
                           for tile in range(p.tiles)
                           for t in range(0, p.tv)], C)
            assert all(len(_cm_channels_of(p, tile, t, C)) == 0
                       for tile in range(p.tiles)
                       for t in range(p.ly * p.tv,
                                      tbn.CM_THREADS))
            # the workspace: partial sums per (chunk, channel), then the
            # three coefficients
            assert tbn._work_floats(p.chunks, C, 3) == \
                2 * p.chunks * C + 3 * C


def test_plans_follow_alignment_of_the_data():
    # a row slice at an odd C, and a view one element off a 16-byte
    # boundary at C = 1024, both take the scalar path
    buf = torch.zeros(11 * 1031)
    odd = buf[1031:].view(10, 1031)
    off = torch.zeros(8 * 1024 + 1)[1:].view(8, 1024)
    full = torch.zeros(8, 1024)
    for t in (odd, off):
        assert t.is_contiguous() and not tln.aligned16(t)
        p = tln._ln_bwd_plan(*t.shape, 4, tln.aligned16(t), SMS)
        assert p.vec == 1
        q = tbn._cm_plan(*t.shape, 4, tbn.aligned16(t), SMS)
        assert q.vec == 1
    assert tln.aligned16(full)
    assert tln._ln_bwd_plan(8, 1024, 4, tln.aligned16(full), SMS).vec == 4


# ------------------------------------------- LayerNorm: the partition

def _pair(a, dtype):
    td, jd = DTYPES[dtype]
    return torch.from_numpy(a).to(td), jnp.asarray(a).astype(jd)


def _emulate_ln_bwd(x, g, mean, rstd, dy, plan):
    """``ln_bwd_rows_kernel`` then ``ln_bwd_finalize_kernel`` in torch:
    dx per row; each row group's dgamma/dbeta over its rows in row
    order, the CTA's groups added in group order into its partial row,
    the partial rows summed by 32 row lanes (lane y: rows y, y + 32,
    ...) and the lanes in order, then cast to gamma's type."""
    R, C = x.shape
    xh = (x.float() - mean[:, None]) * rstd[:, None]
    d = dy.float()
    dyg = d * g.float()
    c1 = dyg.sum(-1, keepdim=True) / C
    c2 = (dyg * xh).sum(-1, keepdim=True) / C
    dx = (rstd[:, None] * (dyg - c1 - xh * c2)).to(x.dtype)
    part = torch.zeros(2, plan.ctas, C)
    for b in range(plan.ctas):
        for q in range(_ln_groups(plan)):
            acc = torch.zeros(2, C)
            for row in _ln_rows_of(plan, b, q, R):
                acc[0] += d[row] * xh[row]
                acc[1] += d[row]
            part[:, b] = acc if q == 0 else part[:, b] + acc
    lanes = torch.zeros(2, 32, C)
    for p in range(plan.ctas):
        lanes[:, p % 32] += part[:, p]
    tot = torch.zeros(2, C)
    for y in range(32):
        tot += lanes[:, y]
    return dx, tot[0].to(g.dtype), tot[1].to(g.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,C,sms", [(48, 64, 1), (40, 1030, 2),
                                     (40, 2048, 4)])
def test_ln_bwd_partition_matches_pallas_kernel(R, C, sms, dtype):
    rng = np.random.RandomState(11)
    x = (rng.randn(R, C) * 2 + 0.5).astype(np.float32)
    dy = rng.randn(R, C).astype(np.float32)
    g = rng.uniform(0.5, 1.5, C).astype(np.float32)
    b = rng.randn(C).astype(np.float32)
    (tx, jx), (tdy, jdy), (tg, jg), (tb, jb) = (
        _pair(a, dtype) for a in (x, dy, g, b))
    _, mean, rstd = tln.layer_norm_fwd(tx, tg, tb)
    plan = tln._ln_bwd_plan(R, C, tx.element_size(), True, sms)
    # a grid of several CTAs with several groups and rows each
    assert plan.ctas > 1 and len(_ln_rows_of(plan, 0, 0, R)) > 1
    got = _emulate_ln_bwd(tx, tg, mean, rstd, tdy, plan)
    _, vjp = jax.vjp(lambda a, c, d: jln._layer_norm_pallas(a, c, d, 1e-5),
                     jx, jg, jb)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for name, t, w in zip(("dx", "dgamma", "dbeta"), got, vjp(jdy)):
        assert t.dtype == tx.dtype, name
        w = np.asarray(jnp.asarray(w).astype(jnp.float32))
        np.testing.assert_allclose(t.float().numpy(), w, rtol=tol, atol=tol,
                                   err_msg=name)


# ----------------------------------- BatchNorm channels-minor: two passes

def _fma(a, b, c):
    """fmaf on f32 tensors: the product exact in f64, one rounding of
    the sum to f32 (its f64 rounding first can differ only in a tie)."""
    return (a.double() * b.double() + c.double()).float()


def _emulate_cm_bwd(x, r, dy, g, b, mean, rstd, act, plan):
    """``bn_bwd_cm_stats_kernel``, ``bn_bwd_cm_finalize_kernel`` and
    ``bn_bwd_cm_apply_kernel`` in torch, in their order of operations.
    Returns (dx, dr or None, dgamma, dbeta, d): d is the masked dy."""
    R, C = x.shape
    xh = (x.float() - mean) * rstd
    d = dy.float()
    if act == "relu":
        a = xh * g.float() + b.float()
        if r is not None:
            a = a + r.float()
        d = torch.where(a > 0, d, torch.zeros_like(d))
    dr = None if r is None else d.to(dy.dtype)
    # pass 1: per chunk, each row lane's sums in row order, then the
    # lanes in lane order
    part = torch.zeros(2, plan.chunks, C)
    for k in range(plan.chunks):
        s = torch.zeros(2, plan.ly, C)
        for lane in range(plan.ly):
            for row in _cm_rows_of(plan, k, lane, R):
                s[0, lane] = s[0, lane] + d[row]
                s[1, lane] = _fma(d[row], xh[row], s[1, lane])
        for lane in range(plan.ly):
            part[:, k] = part[:, k] + s[:, lane]
    # finalize: 32 lanes of a warp add chunks lane, lane + 32, ... in
    # double, then a butterfly over the lanes
    lanes = torch.zeros(2, 32, C, dtype=torch.float64)
    for k in range(plan.chunks):
        lanes[:, k % 32] += part[:, k].double()
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, idx ^ o]
    dbeta, dgamma = lanes[0, 0].float(), lanes[1, 0].float()
    n = float(R)
    k0, k1, k2 = g.float() * rstd, dbeta / n, dgamma / n
    # pass 2: d read back from dr with the add, else masked again
    d2 = d if dr is None else dr.float()
    dx = (k0 * ((d2 - k1) - xh * k2)).to(x.dtype)
    return dx, dr, dgamma, dbeta, d


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act,add", [("none", False), ("relu", False),
                                     ("relu", True)])
@pytest.mark.parametrize("C,aligned", [(48, True), (37, False)],
                         ids=["vector", "scalar"])
def test_bn_cm_bwd_two_passes_match_pallas_kernel(C, aligned, act, add,
                                                  dtype):
    R = 400
    rng = np.random.RandomState(2)
    x = (0.5 + 2.0 * rng.randn(R, C)).astype(np.float32)
    r = rng.randn(R, C).astype(np.float32) if add else None
    dy = rng.randn(R, C).astype(np.float32)
    g = (1.0 + 0.2 * rng.randn(C)).astype(np.float32)
    b = (0.1 * rng.randn(C)).astype(np.float32)
    (tx, jx), (tdy, jdy), (tg, jg), (tb, jb) = (
        _pair(a, dtype) for a in (x, dy, g, b))
    tr, jr = _pair(r, dtype) if add else (None, None)
    _, mean, var = tbn.bn_fwd_cm(tx, tg, tb, tr, 1e-5, act)
    rstd = torch.rsqrt(var + 1e-5)
    plan = tbn._cm_plan(R, C, tx.element_size(), aligned, 2)
    assert plan.chunks > 1 and plan.vec == (
        16 // tx.element_size() if aligned else 1)
    dx, dr, dgamma, dbeta, d = _emulate_cm_bwd(tx, tr, tdy, tg, tb, mean,
                                               rstd, act, plan)
    # dr and the mask: the plain version's bit for bit (a zero residual
    # leaves the pre-activation's sign as it is and returns its dr)
    want = tbn.bn_bwd_reference(tx, tr if add else torch.zeros_like(tx),
                                tdy, tg, tb, mean, rstd, act)
    assert torch.equal(d.to(tdy.dtype), want[1])
    if add:
        assert torch.equal(dr, want[1])
    jw = jbn._bwd_call_cm(jx, jr, jdy, jg, jb, jnp.asarray(mean.numpy()),
                          jnp.asarray(rstd.numpy()), act, C, True)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    for name, t, w, tl in (("dx", dx, jw[0], tol),
                           ("dgamma", dgamma, jw[2], 1e-5),
                           ("dbeta", dbeta, jw[3], 1e-5)):
        w = np.asarray(jnp.asarray(w).astype(jnp.float32))
        np.testing.assert_allclose(t.float().numpy(), w, rtol=tl, atol=tl,
                                   err_msg=name)
    if add:
        np.testing.assert_array_equal(
            dr.float().numpy(), np.asarray(jw[1].astype(jnp.float32)))
