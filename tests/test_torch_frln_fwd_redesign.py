"""The launch geometry and the arithmetic order of the fused residual
LayerNorm forward's row kernel (``csrc/fused_residual_ln.cu``:
``frln_fwd_rows_kernel``), on the CPU.

The plan is pure Python (``_frln_fwd_plan``): every element of every
row falls in exactly one (CTA, row group, thread, slot), the 16-byte
vector path only where C and alignment allow, the grid capped at
``_MAX_GRID`` CTAs with a stride that still covers every row (R past
2^31), and the wide kernel past the last row instance (past
``FRLN_FWD_SCALAR_MAX_C`` on the scalar path).  The instances
and the launch bounds' register rule are read back from the CUDA
source, and the one-CTA-a-row kernel is gone from it.  Then the
kernel's passes are emulated in torch in its order (each thread's keep
bits drawn from its own counters, its partial sums in its slot order,
the warp's butterfly of shuffles, the group's warps added in order) and
held against mxtpu's ``fused_residual_layer_norm`` in Pallas
interpreter mode at ``test_torch_kernels.py``'s tolerances (f32 1e-5,
bf16 2e-2), and each thread's keep bits against mxtpu's ``_mask_bits``
bit for bit.  The CUDA kernel itself runs only on the card, through
``chip_smoke.py``.
"""
import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

tln = importlib.import_module("mxtpu_torch.kernels.layer_norm")
jln = importlib.import_module("mxtpu.kernels.layer_norm")

torch.set_num_threads(2)

SRC = Path(tln.__file__).resolve().parent.parent / "csrc" / \
    "fused_residual_ln.cu"
ITEMSIZE = {"float32": 4, "bfloat16": 2}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SMS = 132   # the H100's SMs
KEY = (0x2545F491, 0x9E3779B9)
LAST_C = tln.FRLN_FWD_SHAPES[-1][0]
COLS = (1, 3, 37, 768, 1024, 1030, 4096, 8192, LAST_C)
ROWS = (1, 3, 37, 4096, 802816)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "interpret")


def _exactly_once(parts, n):
    got = np.concatenate([np.asarray(p, np.int64) for p in parts]) \
        if parts else np.zeros(0, np.int64)
    assert got.size == n
    assert np.array_equal(np.sort(got), np.arange(n))


# the kernel's partition, as its index arithmetic computes it

def _groups(p):
    return tln.LN_BWD_WARPS // p.wpr


def _rows_of(p, cta, group, R):
    """The rows one row group takes: one, but for a grid capped below
    the rows' groups."""
    g = _groups(p)
    return range(cta * g + group, R, p.ctas * g)


def _slots_of(p, t, C):
    """(slot, column) of each element thread ``t`` of a row group holds,
    in the order it adds them: slot k * vec + j is u[k * vec + j] and
    bit k * vec + j of its keep word."""
    G = 32 * p.wpr
    return [(k * p.vec + j, (k * G + t) * p.vec + j)
            for k in range(p.ept // p.vec) for j in range(p.vec)
            if (k * G + t) * p.vec < C]


# ------------------------------------------------------------ geometry

@pytest.mark.parametrize("dtype", list(ITEMSIZE))
@pytest.mark.parametrize("C", COLS)
def test_frln_fwd_plan_covers_every_element_once(C, dtype):
    it = ITEMSIZE[dtype]
    v = 16 // it
    for R in ROWS:
        for aligned in (True, False):
            p = tln._frln_fwd_plan(R, C, it, aligned, SMS)
            assert p.vec == (v if aligned and C % v == 0 else 1)
            if p.vec == 1 and C > tln.FRLN_FWD_SCALAR_MAX_C:
                # the scalar path's row instances stop short of the
                # 16-byte path's: past them the wide kernel
                assert p.wide and p.ctas == min(R, 4 * SMS)
                continue
            first = next(s for s in tln.FRLN_FWD_SHAPES if C <= s[0])
            assert not p.wide and (p.ept, p.wpr) == first[1:]
            assert p.ept % p.vec == 0 and 32 * p.wpr * p.ept >= C
            # one row a row group: the grid's groups just cover the rows
            g = _groups(p)
            assert p.ctas * g >= R > (p.ctas - 1) * g
            if R <= 4096:
                _exactly_once([_rows_of(p, b, q, R) for b in range(p.ctas)
                               for q in range(g)], R)
            # every column in one (thread, slot), each slot of a thread
            # one u register and one keep bit of its 64
            slots = [_slots_of(p, t, C) for t in range(32 * p.wpr)]
            _exactly_once([[c for _, c in s] for s in slots], C)
            for s in slots:
                assert len({k for k, _ in s}) == len(s)
                assert all(k < p.ept <= 64 for k, _ in s)
    # past the last row instance, the wide kernel
    assert tln._frln_fwd_plan(8, C + LAST_C, ITEMSIZE[dtype], True,
                              SMS).wide
    # the scalar path's reach: the row kernel up to it, the wide past it
    for c in (C, C + tln.FRLN_FWD_SCALAR_MAX_C):
        assert tln._frln_fwd_plan(8, c, ITEMSIZE[dtype], False, SMS).wide \
            == (c > tln.FRLN_FWD_SCALAR_MAX_C)


def test_frln_fwd_plan_follows_alignment_of_the_data():
    # a view one element off a 16-byte boundary takes the scalar path,
    # the aligned buffer the vector one
    off = torch.zeros(8 * 1024 + 1)[1:].view(8, 1024)
    assert off.is_contiguous() and not tln.aligned16(off)
    assert tln._frln_fwd_plan(8, 1024, 4, tln.aligned16(off), SMS).vec == 1
    full = torch.zeros(8, 1024)
    assert tln._frln_fwd_plan(8, 1024, 4, tln.aligned16(full), SMS).vec == 4
    assert tln._frln_fwd_plan(8, 1024, 2, tln.aligned16(full), SMS).vec == 8


@pytest.mark.parametrize("C", COLS)
def test_frln_fwd_grid_is_capped(C):
    # 2^31 + 5 rows (8 GB of f32 a tensor at C = 1, which the card
    # holds; keep = 1 sets no counter limit): the one-CTA-a-row kernel's
    # grid would exceed gridDim.x's 2^31 - 1.  The grid gives each row
    # group one row, capped at _MAX_GRID CTAs, and the stride covers
    # every row
    R = (1 << 31) + 5
    assert R > tln._MAX_GRID
    p = tln._frln_fwd_plan(R, C, 2, True, SMS)
    g = _groups(p)
    assert p.ctas == min(-(-R // g), tln._MAX_GRID) <= tln._MAX_GRID
    if g == 1:
        assert p.ctas == tln._MAX_GRID
    # row r is taken by CTA (r // g) % ctas, group r % g, in that
    # group's (r // g) // ctas-th turn of the loop, and by no other
    for r in (0, 1, g - 1, g, R // 2, p.ctas * g - 1, p.ctas * g, R - 1):
        if r >= R:
            continue
        cta, q, turn = (r // g) % p.ctas, r % g, (r // g) // p.ctas
        assert cta < p.ctas and _rows_of(p, cta, q, R)[turn] == r
    turns = -(-R // (p.ctas * g))
    assert p.ctas * g * turns >= R
    assert len(_rows_of(p, 0, 0, R)) == turns


# ------------------------------------------- the source and the mirror

def _register_rule(itemsize, vec, E):
    """``frln_fwd_min_blocks``, term for term: u, the raw h, res and
    bias, the threefry chains' two words each, the scalar path's
    offsets and a base of 32."""
    eb = itemsize if vec > 1 else 4
    regs = E + 3 * E * eb // 4 + 2 * E + (0 if vec > 1 else E) + 32
    return 2 if regs <= 128 else 1


def test_frln_fwd_source_mirrors_the_plan():
    src = SRC.read_text()
    shapes = re.search(r"#define FRLN_FWD_SHAPES\(X\)((?:.|\n)*?)\n\n", src)
    got = tuple(tuple(int(v) for v in m) for m in re.findall(
        r"X\((\d+), (\d+), (\d+)\)", shapes.group(1)))
    assert got == tln.FRLN_FWD_SHAPES
    # the scalar path's reach, and the C entry instantiating no scalar
    # instance past it
    assert f"constexpr int FRLN_FWD_SCALAR_MAX_C = " \
        f"{tln.FRLN_FWD_SCALAR_MAX_C};" in src
    assert "if constexpr (VEC > 1 || MAXC <= FRLN_FWD_SCALAR_MAX_C)" in src
    assert any(c == tln.FRLN_FWD_SCALAR_MAX_C for c, _, _ in got)
    # every instance a whole number of 16-byte packs a thread, at most
    # 64 keep bits, and the widest C it is chosen for within its reach
    for c, e, w in got:
        assert e % 8 == 0 and e <= 64 and 32 * w * e == c
    assert "static_assert(E % VEC == 0 && E <= 64" in src
    assert "constexpr int FRLN_FWD_THREADS = 256;" in src and \
        tln.LN_BWD_WARPS == 256 // 32
    # the launch bounds' register rule
    assert "E + 3 * E * eb / 4 + 2 * E + (VEC > 1 ? 0 : E) + 32" in src
    assert "return regs <= 128 ? 2 : 1;" in src
    assert re.search(r"__launch_bounds__\(FRLN_FWD_THREADS,\s*"
                     r"\(frln_fwd_min_blocks<T, VEC, E>\(\)\)\)", src)
    # BERT's instance holds 2 CTAs an SM in both types
    _, e, _ = next(s for s in tln.FRLN_FWD_SHAPES if 1024 <= s[0])
    assert _register_rule(2, 8, e) == _register_rule(4, 4, e) == 2
    # the C entry takes the plan's four numbers, in _FRLN_ARGS's order
    params = re.search(r'extern "C" int mxt_fused_residual_ln_fwd\(([^)]*)\)',
                       src).group(1)
    names = [a.split()[-1].lstrip("*") for a in params.split(",")]
    assert names[9:16] == ["rows", "C", "eps", "vec", "ept", "wpr", "ctas"]
    assert len(names) == len(tln._FRLN_ARGS)
    # the one-CTA-a-row kernel and its shared-memory row are gone
    for gone in (r"\bfrln_fwd_kernel\b", r"\blaunch_row\b",
                 r"\bFRLN_ROW_MAX_C\b", r"extern __shared__", r"\bus\["):
        assert not re.search(gone, src), gone
    for gone in ("FRLN_FWD_ROW_MAX_C", "FrlnFwdPlan"):
        assert not hasattr(tln, gone)


# --------------------------------------- the passes, against mxtpu

def _butterfly(parts):
    """A warp's shuffle sum (xor 16, 8, 4, 2, 1) over its 32 lanes'
    partials (the last axis), as every lane ends with it."""
    v = parts
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lane ^ o]
    return v[..., 0]


def _group_sum(vals, slots, wpr):
    """The kernel's row sum: each thread's partial over its columns in
    slot order from 0 (a thread with fewer adds zeros, which leave its
    sum as it was), a butterfly per warp, the warps added in order."""
    G = 32 * wpr
    C = vals.shape[-1]
    idx = torch.full((G, max(map(len, slots))), C, dtype=torch.long)
    for t, s in enumerate(slots):
        idx[t, :len(s)] = torch.tensor([c for _, c in s], dtype=torch.long)
    padded = torch.cat([vals, vals.new_zeros(vals.shape[0], 1)], -1)
    g = padded[:, idx]
    part = vals.new_zeros(vals.shape[0], G)
    for k in range(idx.shape[1]):
        part = part + g[:, :, k]
    warps = _butterfly(part.reshape(-1, wpr, 32))
    tot = torch.zeros(vals.shape[0], dtype=vals.dtype)
    for w in range(wpr):
        tot = tot + warps[:, w]
    return tot


def _thread_words(p, R, C, thresh, bits_of):
    """Each thread's keep word, (R, threads) int64: bit k * vec + j set
    where its element of that slot is kept; ``bits_of(cols)`` gives the
    (R, len(cols)) uint32 bits of those columns."""
    words = torch.zeros(R, 32 * p.wpr, dtype=torch.int64)
    for t in range(32 * p.wpr):
        s = _slots_of(p, t, C)
        if not s:
            continue
        kept = torch.as_tensor(np.asarray(bits_of([c for _, c in s])),
                               dtype=torch.int64) < thresh
        for i, (k, _) in enumerate(s):
            words[:, t] |= kept[:, i].long() << k
    return words


def _draw_words(p, R, C, keep):
    """The keep words as the threads draw them: threefry over the
    counters row * C + c in uint32, one chain an element."""
    def bits_of(cols):
        ctr = (torch.arange(R, dtype=torch.int64)[:, None] * C +
               torch.tensor(cols, dtype=torch.int64)[None, :]) & 0xFFFFFFFF
        return tln._threefry2x32(KEY[0], KEY[1], ctr,
                                 torch.zeros_like(ctr))[0]
    return _thread_words(p, R, C, tln.keep_thresh(keep), bits_of)


def _emulate_frln_fwd(h, bias, res, g, b, keep, p, eps=1e-5):
    """``frln_fwd_rows_kernel`` in torch: the keep bits from each
    thread's own word, u in f32, the mean as the group's sum over C, the
    variance as the same sum of the centred squares, y in h's type."""
    R, C = h.shape
    slots = [_slots_of(p, t, C) for t in range(32 * p.wpr)]
    hb = h.float() + bias.float()
    if keep < 1.0:
        words = _draw_words(p, R, C, keep)
        kept = torch.zeros(R, C, dtype=torch.bool)
        for t, s in enumerate(slots):
            for k, c in s:
                kept[:, c] = (words[:, t] >> k) & 1 == 1
        hb = torch.where(kept, hb * tln._inv_keep(keep), torch.zeros_like(hb))
    u = res.float() + hb
    mu = _group_sum(u, slots, p.wpr) / C
    d = u - mu[:, None]
    var = _group_sum(d * d, slots, p.wpr) / C
    rs = 1.0 / torch.sqrt(var + eps)
    y = d * rs[:, None] * g.float() + b.float()
    return y.to(h.dtype), mu, rs


def _pair(a, dtype):
    td, jd = DTYPES[dtype]
    return torch.from_numpy(a).to(td), jnp.asarray(a).astype(jd)


def _inputs(R, C, dtype, seed=14):
    rng = np.random.RandomState(seed)
    h, res = (rng.randn(R, C).astype(np.float32) * 2 + 0.5
              for _ in range(2))
    bias, beta = (rng.randn(C).astype(np.float32) for _ in range(2))
    g = rng.uniform(0.5, 1.5, C).astype(np.float32)
    return [_pair(a, dtype) for a in (h, bias, res, g, beta)]


def _close(got, want, dtype, what):
    w = want.float().numpy() if isinstance(want, torch.Tensor) else \
        np.asarray(jnp.asarray(want).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), w.reshape(got.shape),
                               rtol=TOL[dtype], atol=TOL[dtype],
                               err_msg=what)


# (R, C, aligned): BERT's instance; a row instance of several groups a
# CTA; the scalar path at an R off a multiple of the groups (mxtpu's
# Pallas kernels take R in blocks of 8, so there it runs its lax
# composite, the same mask); the widest instance
FWD_RUNS = [(16, 1024, True), (8, 200, True), (37, 1030, False),
            (8, LAST_C - 32, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("keep", [1.0, 0.9])
@pytest.mark.parametrize("R,C,aligned", FWD_RUNS,
                         ids=[f"R{r}-C{c}" for r, c, _ in FWD_RUNS])
def test_frln_fwd_rows_match_mxtpu(R, C, aligned, keep, dtype):
    (th, jh), (tbias, jbias), (tres, jres), (tg, jg), (tb, jb) = \
        _inputs(R, C, dtype)
    p = tln._frln_fwd_plan(R, C, th.element_size(), aligned, SMS)
    assert not p.wide and p.vec == (16 // th.element_size() if aligned
                                    else 1)
    y, mean, rstd = _emulate_frln_fwd(th, tbias, tres, tg, tb, keep, p)
    assert y.dtype == th.dtype
    drop = 0.1 if keep < 1.0 else 0.0
    seed = jnp.asarray(np.array(KEY, np.uint32))
    wy = jln.fused_residual_layer_norm(jh, jbias, jres, jg, jb, seed,
                                       p=drop)
    _close(y, wy, dtype, "y")
    if R % 8 == 0:
        # mxtpu's Pallas kernel also gives the statistics
        _, wmean, wrstd = jln._pallas_frln_fwd(jh, jbias, jres, jg, jb, seed,
                                               keep, 1e-5, True)
        _close(mean, wmean, "float32", "mean")
        _close(rstd, wrstd, "float32", "rstd")
    # the port's plain version, which the wrapper takes on the CPU, too
    py, pmean, prstd = tln.fused_residual_ln_fwd(
        th, tbias, tres, tg, tb, KEY, drop, 1e-5, keep < 1.0)
    _close(y, py, dtype, "y vs plain")
    _close(mean, pmean, "float32", "mean vs plain")
    _close(rstd, prstd, "float32", "rstd vs plain")


@pytest.mark.parametrize("R,C,aligned", FWD_RUNS,
                         ids=[f"R{r}-C{c}" for r, c, _ in FWD_RUNS])
def test_frln_fwd_thread_keep_bits_match_mxtpu(R, C, aligned):
    # each thread's word of keep bits, drawn from its own counters, is
    # the word mxtpu's _mask_bits gives its columns, bit for bit
    p = tln._frln_fwd_plan(R, C, 2, aligned, SMS)
    bits = np.asarray(jln._mask_bits(jnp.uint32(KEY[0]), jnp.uint32(KEY[1]),
                                     jnp.uint32(0), R, C))
    thresh = jln._keep_thresh(0.9)
    assert thresh == tln.keep_thresh(0.9)
    want = _thread_words(p, R, C, thresh,
                         lambda cols: bits[:, cols].astype(np.int64))
    got = _draw_words(p, R, C, 0.9)
    assert torch.equal(got, want)
    dropped = (bits >= thresh).sum()
    assert 0 < dropped < bits.size


def test_frln_dropout_counter_wrap_raises():
    # with dropout on, the mask's uint32 element counter takes R * C <
    # 2^32; past it mxtpu draws jax.random.bernoulli, which no torch
    # generator reproduces, and the port raises.  keep = 1 draws no mask
    # and takes any size
    from mxtpu_torch import MXNetError
    assert tln._words(KEY, (1 << 32) - 1, 0.9) == KEY
    with pytest.raises(MXNetError, match="wrap"):
        tln._words(KEY, 1 << 32, 0.9)
    assert tln._words(KEY, 1 << 40, 1.0) == (0, 0)
