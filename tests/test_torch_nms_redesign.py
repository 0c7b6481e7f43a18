"""The redesigned greedy NMS kernels of ``mxtpu_torch/csrc/nms.cu``,
emulated in numpy on the CPU and held against the plain sweep
(``kernels/nms.py``'s ``greedy_nms_keep`` and ``nms_keep_reference``)
and mxtpu's ``_greedy_nms_keep``.

* The mask kernel: the triangular tile index (every tile on or above
  the diagonal once, none below), rows of ``mask_words(n)`` words, rows
  that ``keep0`` clears left unwritten, and the threshold decided
  without the division where the quotient is clearly on one side.
* The division-free decision: ``RN(inter / uni) > thr`` against
  ``inter > RN(thr_up * uni)`` (true), ``inter < RN(thr * uni)``
  (false), else the division, emulated with ``np.float32`` (each
  operation rounded on its own, as ``__fmul_rn`` and ``__fdiv_rn``)
  over a million seeded pairs and over built adversarial ones.
* The sweep: blocks of 32 rows, each block's mask rows copied in one
  piece from word ``4 * floor(k / 4)`` of its first row to the end of its
  last into a ring of stages whose other words hold
  garbage (a stage refilled once the block before has been read), the
  settle (a ballot of live rows that overlap later live rows, and only
  then a predicated step a row over the diagonal words), the ORs of
  the sources' later words; and the wide sweep past ``PREFETCH_MAX_BOXES``,
  reading the mask rows as they lie.  Rows that ``keep0`` clears and the
  padding words hold garbage, so a read of either would show.

Every keep mask is compared bit for bit.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxtpu.ndarray import detection_impl as jdi

from mxtpu_torch.base import MXNetError
from mxtpu_torch.kernels import nms as tnms

torch.set_num_threads(2)
F32 = np.float32
U32 = np.uint32
FLT_MAX = np.finfo(F32).max
THRESHOLDS = (0.3, 0.45, 0.5, 0.7)


def _source():
    return (tnms._build.CSRC / "nms.cu").read_text()


def _source_constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         _source()).group(1))


def _stages(n, n_iter):
    """``sweep_stages`` of ``nms.cu``: as many stages as fit, 2 to
    MAX_STAGES, no more than the blocks; 0 past the prefetch limit."""
    limit, top = _source_constant("SMEM_LIMIT"), \
        _source_constant("MAX_STAGES")
    if n > tnms.PREFETCH_MAX_BOXES:
        return 0
    s = top
    while s > 2 and (s * 32 + 1) * tnms.mask_words(n) * 4 + 64 > limit:
        s -= 1
    nblk = (n_iter + 31) // 32
    return (nblk if nblk > 0 else 1) if nblk < s else s


# ------------------------------------------------------------- limits

def test_source_limits_match_the_wrapper():
    assert _source_constant("MAX_BOXES") == tnms.MAX_BOXES
    assert _source_constant("PREFETCH_MAX_BOXES") == tnms.PREFETCH_MAX_BOXES
    assert _source_constant("MASK_TILE") == tnms.MASK_TILE
    limit = _source_constant("SMEM_LIMIT")
    assert limit == 227 * 1024       # a CTA's shared memory on Hopper
    # two stages and the keep bits fit at the limit, and the limit is
    # within one tile of the largest n that fits
    words = tnms.mask_words(tnms.PREFETCH_MAX_BOXES)
    assert (2 * 32 + 1) * words * 4 + 64 <= limit
    past = tnms.PREFETCH_MAX_BOXES + 5 * tnms.MASK_TILE
    assert (2 * 32 + 1) * tnms.mask_words(past) * 4 + 64 > limit
    assert tnms.MAX_BOXES // 8 == 48 * 1024
    # a row is whole 16-byte chunks, at least ceil(n / 32) words
    for n in (1, 31, 32, 33, 127, 128, 129, 1704, 6000, 28001):
        w = tnms.mask_words(n)
        assert w % 4 == 0 and (n + 31) // 32 <= w < (n + 31) // 32 + 4
    # the ring: 2 to MAX_STAGES stages up to the limit, the whole mask
    # where it fits, none past the limit
    assert _source_constant("MAX_STAGES") == 16
    assert _stages(6000, 6000) == 9 and _stages(256, 256) == 8
    assert _stages(1704, 400) == 13
    assert _stages(256, 40) == 2 and _stages(90, 0) == 1
    assert _stages(tnms.PREFETCH_MAX_BOXES, 1024) == 2
    assert _stages(tnms.PREFETCH_MAX_BOXES + 1, 1024) == 0


def test_nms_keep_refuses_past_max_boxes():
    n = tnms.MAX_BOXES + 1
    with pytest.raises(MXNetError, match=f"at most 65535 of {tnms.MAX_BOXES}"):
        tnms.nms_keep(torch.zeros(1, n, 4), torch.ones(1, n, dtype=torch.bool),
                      0.5, 10)


# ------------------------------------------------- the division-free test

def _over_threshold(inter, uni, thr):
    """``over_threshold`` of ``nms.cu`` in np.float32: the band test,
    the division inside the band and for NaN or infinite operands.
    Returns (decision, where the division decided)."""
    inter, uni = np.asarray(inter, F32), np.asarray(uni, F32)
    thr = F32(thr)
    up = np.nextafter(thr, F32(np.inf))
    with np.errstate(all="ignore"):
        finite = ~np.isnan(inter) & ~np.isnan(uni) & \
            (np.maximum(inter, uni) <= FLT_MAX)
        hi, lo = up * uni, thr * uni      # f32 products, rounded once
        fast_true = finite & (inter > hi)
        fast_false = finite & ~fast_true & (inter < lo)
        divided = (inter / uni) > thr
    slow = ~(fast_true | fast_false)
    return np.where(fast_true, True, np.where(fast_false, False, divided)), \
        slow


def _divided(inter, uni, thr):
    with np.errstate(all="ignore"):
        return (np.asarray(inter, F32) / np.asarray(uni, F32)) > F32(thr)


def _random_thresholds(rng, k):
    return [float(v) for v in rng.uniform(0.0, 1.0, k).astype(F32)] + \
        [float(v) for v in (rng.randn(k) * 10.0 ** rng.randint(-30, 30, k))
         .astype(F32)]


def _iou_parts(a, b, pixel):
    """inter and union of corner boxes a (n, 4) and b (n, 4) pairwise
    in the kernel's order, each f32 operation rounded on its own."""
    a, b = a.astype(F32), b.astype(F32)
    one = F32(1.0)
    w = np.minimum(a[:, 2], b[:, 2]) - np.maximum(a[:, 0], b[:, 0])
    h = np.minimum(a[:, 3], b[:, 3]) - np.maximum(a[:, 1], b[:, 1])
    if pixel:
        w, h = w + one, h + one

    def area(t):
        if pixel:
            return (t[:, 2] - t[:, 0] + one) * (t[:, 3] - t[:, 1] + one)
        return np.maximum((t[:, 2] - t[:, 0]) * (t[:, 3] - t[:, 1]), F32(0))
    inter = np.maximum(w, F32(0)) * np.maximum(h, F32(0))
    uni = np.maximum((area(a) + area(b)) - inter, F32(1e-12))
    return inter.astype(F32), uni.astype(F32)


@pytest.mark.parametrize("pixel", [False, True])
def test_band_test_equals_the_division_on_a_million_pairs(pixel):
    rng = np.random.RandomState(31 + pixel)
    n = 1 << 20
    scale = 600.0 if pixel else 1.0

    def boxes():
        xy = rng.uniform(0, scale, (n, 2))
        wh = rng.uniform(0, 0.25 * scale, (n, 2))
        b = np.concatenate([xy, xy + wh], -1)
        return np.floor(b) if pixel else b
    # pairs of near boxes (a box and a jittered copy) and of random ones
    a = boxes()
    jitter = rng.uniform(-0.05, 0.05, (n, 4)) * scale
    b = np.where(rng.rand(n, 1) < 0.5, a + (np.round(jitter) if pixel
                                             else jitter), boxes())
    inter, uni = _iou_parts(a, b, pixel)
    assert inter.size >= 10 ** 6
    for thr in THRESHOLDS + tuple(_random_thresholds(rng, 4)):
        got, slow = _over_threshold(inter, uni, thr)
        np.testing.assert_array_equal(got, _divided(inter, uni, thr))
        # the division runs for a sliver of the pairs only
        assert slow.mean() < 1e-3, (thr, slow.mean())
    # random f32 operands over the whole finite range
    bits = rng.randint(0, 0x7f800000, 2 * n, dtype=np.int64).astype(U32)
    inter, uni = bits[:n].view(F32), np.maximum(bits[n:].view(F32),
                                                F32(1e-12))
    for thr in THRESHOLDS + tuple(_random_thresholds(rng, 4)):
        got, _ = _over_threshold(inter, uni, thr)
        np.testing.assert_array_equal(got, _divided(inter, uni, thr))


def _ulps(x, k):
    """x moved k f32 steps (k may be negative)."""
    x = np.asarray(x, F32).copy()
    to = F32(np.inf) if k > 0 else F32(-np.inf)
    for _ in range(abs(k)):
        x = np.nextafter(x, to)
    return x


@np.errstate(over="ignore")
def test_band_test_on_adversarial_pairs():
    rng = np.random.RandomState(7)
    uni = np.concatenate([
        rng.uniform(1e-12, 1.0, 4000), rng.uniform(1.0, 4e5, 4000),
        np.float32(2.0) ** rng.randint(-39, 60, 2000),
        np.full(8, 1e-12), np.array([FLT_MAX / 4, FLT_MAX])]).astype(F32)
    for thr in THRESHOLDS + tuple(_random_thresholds(rng, 6)):
        t32 = F32(thr)
        up = np.nextafter(t32, F32(np.inf))
        cases = []
        for centre in (t32 * uni, up * uni):
            for k in range(-3, 4):
                cases.append((_ulps(centre, k), uni))
        # quotients one ulp either side of thr, and thr itself
        for q in (np.nextafter(t32, F32(-np.inf)), t32, up):
            for k in (-1, 0, 1):
                cases.append((_ulps(F32(q) * uni, k), uni))
        for inter, u in cases:
            inter = np.abs(inter).astype(F32)
            got, _ = _over_threshold(inter, u, thr)
            np.testing.assert_array_equal(got, _divided(inter, u, thr))
    # exact midpoint ties: inter / uni == (thr + thr_up) / 2 needs the
    # midpoint's 25-bit odd significand to fit in 24 bits, so for a
    # normal thr none exists and for a subnormal one it does; there the
    # division (ties to even) decides
    for k in range(1, 40):
        thr = F32(k) * F32(2.0) ** -149
        for j in range(1, 60):
            u = F32(2.0) ** j
            inter = F32((2 * k + 1) * 2.0 ** (j - 150))
            assert float(inter) / float(u) == (float(thr) + float(
                np.nextafter(thr, F32(np.inf)))) / 2
            got, slow = _over_threshold(inter, u, thr)
            assert bool(slow)
            assert bool(got) == bool(_divided(inter, u, thr))
    # zero and tiny intersections, the union's clamp, NaN and infinity
    # (inter = max(w, 0) * max(h, 0) and uni = max(., 1e-12) pass NaN
    # on: inter is >= 0, inf or NaN, uni >= 1e-12, inf or NaN)
    inter, uni = np.meshgrid(
        np.array([0.0, -0.0, 1e-45, 1e-40, 1e-12, 0.5, 1.0, 3e5, FLT_MAX,
                  np.inf, np.nan], F32),
        np.array([1e-12, 2e-12, 1e-6, 1.0, 2.0, 6e5, FLT_MAX, np.inf,
                  np.nan], F32))
    for thr in THRESHOLDS + (0.0, -0.5, 1e-45, float(FLT_MAX), np.inf,
                             -np.inf, np.nan):
        got, _ = _over_threshold(inter, uni, thr)
        np.testing.assert_array_equal(got, _divided(inter, uni, thr))


# ------------------------------------------------------- the mask kernel

def _decode(tile, ct):
    """The mask kernel's (rb, cb) of a triangular tile index."""
    q = 2.0 * ct + 1.0
    rb = int((q - np.sqrt(q * q - 8.0 * tile)) * 0.5)

    def start(r):
        return r * ct - r * (r - 1) // 2
    while rb > 0 and start(rb) > tile:
        rb -= 1
    while start(rb + 1) <= tile:
        rb += 1
    return rb, rb + tile - start(rb)


def test_triangular_tile_index_covers_the_upper_tiles_once():
    for ct in list(range(1, 70)) + [219, 3072]:
        for rt in sorted({1, ct // 3 + 1, ct}):
            tiles = rt * ct - rt * (rt - 1) // 2
            got = [_decode(t, ct) for t in range(tiles)] if ct < 300 else \
                [_decode(t, ct) for t in (0, 1, tiles // 2, tiles - 2,
                                          tiles - 1)]
            if ct < 300:
                assert got == [(r, c) for r in range(rt)
                               for c in range(r, ct)]
            else:
                assert got[0] == (0, 0) and got[-1] == (rt - 1, ct - 1)


def _emulate_mask(boxes, ids, keep0, thr, n_iter, pixel, rng):
    """The mask kernel over one image: (n_iter, words) uint32, rows that
    keep0 clears (and rows nobody writes) left as garbage."""
    n = boxes.shape[0]
    tile = tnms.MASK_TILE
    words = tnms.mask_words(n)
    mask = rng.randint(0, 2 ** 32, (max(n_iter, 1), words),
                       dtype=np.uint64).astype(U32)
    ct, rt = -(-n // tile), -(-n_iter // tile)
    zero_over = F32(0.0) > F32(thr)
    for t in range(rt * ct - rt * (rt - 1) // 2):
        rb, cb = _decode(t, ct)
        j0 = cb * tile
        rows = [i for i in range(rb * tile, min((rb + 1) * tile, n_iter))
                if keep0[i]]
        for i in rows:
            for wd in range(tile // 32):      # four threads a row
                c0 = 32 * wd
                cols = np.arange(max(0, i + 1 - j0 - c0),
                                 min(32, n - j0 - c0))
                word = 0
                if len(cols):
                    j = j0 + c0 + cols
                    a = np.repeat(boxes[i][None], len(cols), 0)
                    inter, uni = _iou_parts(a, boxes[j], pixel)
                    over, _ = _over_threshold(inter, uni, thr)
                    if ids is not None:
                        over = np.where(ids[i] == ids[j], over, zero_over)
                    word = int(sum(1 << int(c) for c in cols[over]))
                mask[i, 4 * cb + wd] = U32(word)
    return mask


# ------------------------------------------------------------- the sweeps

def _keep_words(keep0, n):
    nw = (n + 31) // 32
    alive = np.zeros(nw, U32)
    for i in np.nonzero(keep0)[0]:
        alive[i >> 5] |= U32(1 << (i & 31))
    return alive


def _keep_bytes(alive, n):
    return np.array([(int(alive[i >> 5]) >> (i & 31)) & 1 for i in
                     range(n)], bool)


def _emulate_sweep(mask, keep0, n, n_iter, rng):
    """nms_sweep_kernel: a ring of stages that hold garbage but for the
    words each copy writes (the block's rows from word 4 * floor(k / 4)
    of the first); the settle is a ballot of clashing live rows, then
    only where one clashes a walk through the block's rows on their live
    bits; the ORs read the stage a 16-byte chunk at a time, skipping
    a chunk no source overlaps."""
    words = mask.shape[1]
    stages = _stages(n, n_iter)
    assert stages >= 1
    nw, nblk = (n + 31) // 32, (n_iter + 31) // 32
    ring = rng.randint(0, 2 ** 32, (stages, 32, words),
                       dtype=np.uint64).astype(U32)

    def issue(k):
        # one copy: from word w0 of the block's first row to the end of
        # its last, the rows one after another
        s, rows, w0 = k % stages, min(32, n_iter - 32 * k), k & ~3
        ring[s] = rng.randint(0, 2 ** 32, (32, words),
                              dtype=np.uint64).astype(U32)
        flat = ring[s].reshape(-1)
        flat[w0:rows * words] = mask[32 * k:32 * k + rows].reshape(-1)[w0:]
    alive = _keep_words(keep0, n)
    for k in range(min(stages, nblk)):
        issue(k)
    for k in range(nblk):
        st = ring[k % stages]
        rows = min(32, n_iter - 32 * k)
        # warp 0: lane r's diagonal word (0 past the block's rows); the
        # ballot of live rows overlapping a later live row; only then
        # thread 0's walk, a predicated step a row
        diag = [int(st[r, k]) if r < rows else 0 for r in range(32)]
        word = int(alive[k])
        if any((word >> r) & 1 and diag[r] & word for r in range(32)):
            for r in range(32):
                if (word >> r) & 1:
                    word &= ~diag[r] & 0xffffffff
        alive[k] = U32(word)
        src = word if rows == 32 else word & ((1 << rows) - 1)
        # after the barrier: block k - 1's stage is refilled, then the ORs
        if k > 0 and k - 1 + stages < nblk:
            issue(k - 1 + stages)
        if src:
            # chunks of 4 words; a chunk no source overlaps is skipped
            srcs = [r for r in range(32) if (src >> r) & 1]
            for q in range((k + 1) >> 2, (nw + 3) >> 2):
                chunk = st[srcs, 4 * q:4 * q + 4]
                if not chunk.any():
                    continue
                acc = np.bitwise_or.reduce(chunk, axis=0)
                for i, w in enumerate(range(4 * q, 4 * q + 4)):
                    if k < w < nw:
                        alive[w] &= ~acc[i]
    return _keep_bytes(alive, n)


def _emulate_wide_sweep(mask, keep0, n, n_iter):
    """nms_sweep_wide_kernel: the mask rows read where they lie, the
    block's rows settled a row at a time."""
    nw, nblk = (n + 31) // 32, (n_iter + 31) // 32
    alive = _keep_words(keep0, n)
    for k in range(nblk):
        rows = min(32, n_iter - 32 * k)
        word, src = int(alive[k]), 0
        for s in range(rows):
            d = int(mask[32 * k + s, k])
            if (word >> s) & 1:
                src |= 1 << s
                word &= ~d & 0xffffffff
        alive[k] = U32(word)
        if src:
            srcs = [32 * k + s for s in range(32) if (src >> s) & 1]
            alive[k + 1:nw] &= ~np.bitwise_or.reduce(mask[srcs, k + 1:nw],
                                                     axis=0)
    return _keep_bytes(alive, n)


def _relation_mask(rel, keep0, words, rng):
    """Rows of bits of the (n_iter, n) relation's upper part, garbage in
    the rows keep0 clears and in the padding words."""
    n_iter, n = rel.shape
    mask = rng.randint(0, 2 ** 32, (max(n_iter, 1), words),
                       dtype=np.uint64).astype(U32)
    if n_iter == 0:
        return mask
    upper = rel & (np.arange(n)[None, :] > np.arange(n_iter)[:, None])
    pad = np.zeros((n_iter, 32 * ((n + 31) // 32)), bool)
    pad[:, :n] = upper
    packed = np.packbits(pad.reshape(n_iter, -1, 32)[..., ::-1], axis=-1,
                         bitorder="big").view(">u4")[..., 0].astype(U32)
    for i in range(n_iter):
        if keep0[i]:
            mask[i, :packed.shape[1]] = packed[i]
    return mask


@pytest.mark.parametrize("b,n,n_iter,density,keep", [
    (1, 77, 77, 0.05, 0.9), (2, 300, 250, 0.02, 0.3),
    (1, 1000, 1000, 0.003, 1.0), (3, 129, 33, 0.3, 0.6),
    (1, 4100, 700, 0.0005, 0.95), (2, 64, 64, 0.9, 0.5),
    (1, 1, 1, 0.0, 1.0), (1, 50, 0, 0.2, 0.7)])
def test_sweep_emulations_match_the_plain_loop(b, n, n_iter, density, keep):
    rng = np.random.RandomState(n + n_iter)
    rel = rng.rand(b, n, n) < density
    keep0 = rng.rand(b, n) < keep
    want = tnms.greedy_nms_keep(torch.from_numpy(rel.astype(np.float32)),
                                torch.from_numpy(keep0), 0.5,
                                n_iter).numpy()
    for img in range(b):
        jw = jdi._greedy_nms_keep(jnp.asarray(rel[img].astype(np.float32)),
                                  jnp.asarray(keep0[img]), 0.5, n_iter)
        np.testing.assert_array_equal(np.asarray(jw), want[img])
        mask = _relation_mask(rel[img, :n_iter], keep0[img],
                              tnms.mask_words(n), rng)
        np.testing.assert_array_equal(
            _emulate_sweep(mask, keep0[img], n, n_iter, rng), want[img])
        np.testing.assert_array_equal(
            _emulate_wide_sweep(mask, keep0[img], n, n_iter), want[img])


def test_a_call_past_the_prefetch_limit_takes_the_wide_sweep():
    """b1 and n just past the limit, n_iter 300: the wide sweep's
    emulation on the relation matches the plain loop, and the ring
    emulation is not defined there (no two stages fit)."""
    n, n_iter = tnms.PREFETCH_MAX_BOXES + 37, 300
    assert _stages(n, n_iter) == 0
    rng = np.random.RandomState(5)
    rel = rng.rand(n_iter, n) < 0.001
    keep0 = rng.rand(n) < 0.9
    full = np.zeros((n_iter, n), np.float32)
    full[rel] = 1.0
    want = tnms.greedy_nms_keep(torch.from_numpy(full)[None],
                                torch.from_numpy(keep0)[None], 0.5,
                                n_iter)[0].numpy()
    mask = _relation_mask(rel, keep0, tnms.mask_words(n), rng)
    np.testing.assert_array_equal(
        _emulate_wide_sweep(mask, keep0, n, n_iter), want)


def _boxes(rng, b, n, pixel):
    scale = 600.0 if pixel else 1.0
    xy = rng.uniform(0, scale, (b, n, 2))
    wh = rng.uniform(0, 0.2 * scale, (b, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1)
    return (np.floor(boxes) if pixel else boxes).astype(F32)


@pytest.mark.parametrize("b,n,n_iter,pixel,cls,keep", [
    (2, 256, 256, True, True, 0.9), (1, 300, 120, False, True, 0.5),
    (2, 200, 200, False, False, 1.0), (1, 390, 390, True, False, 0.2)])
def test_mask_and_sweep_emulation_equal_the_plain_nms(b, n, n_iter, pixel,
                                                      cls, keep):
    rng = np.random.RandomState(n * 3 + pixel)
    boxes = _boxes(rng, b, n, pixel)
    boxes[:, 7::41, 0] = np.nan         # NaN corners suppress nothing
    ids = rng.randint(0, 3, (b, n)).astype(F32) if cls else None
    keep0 = rng.rand(b, n) < keep
    thr = 0.7 if pixel else 0.5
    want = tnms.nms_keep_reference(
        torch.from_numpy(boxes), torch.from_numpy(keep0), thr, n_iter,
        None if ids is None else torch.from_numpy(ids), pixel).numpy()
    got_cpu = tnms.nms_keep(
        torch.from_numpy(boxes), torch.from_numpy(keep0), thr, n_iter,
        None if ids is None else torch.from_numpy(ids), pixel).numpy()
    np.testing.assert_array_equal(got_cpu, want)
    for img in range(b):
        mask = _emulate_mask(boxes[img], None if ids is None else ids[img],
                             keep0[img], thr, n_iter, pixel, rng)
        np.testing.assert_array_equal(
            _emulate_sweep(mask, keep0[img], n, n_iter, rng), want[img])
        np.testing.assert_array_equal(
            _emulate_wide_sweep(mask, keep0[img], n, n_iter), want[img])


# ------------------------------------------ the chip script and the tool

def test_chip_script_and_timing_tool_name_every_nms_kernel_and_case():
    """``chip_smoke.py`` reads a call's time from the kernels it names
    and times one case past the prefetch limit; ``tools/kernel_times``
    times the script's NMS cases and route shape."""
    import importlib.util
    from pathlib import Path
    repo = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  repo / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    names = set(re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s+"
                           r"(\w+)\(", _source()))
    assert names == set(smoke.KERNEL_NAMES["nms"]) == {
        "nms_mask_kernel", "nms_sweep_kernel", "nms_sweep_wide_kernel"}
    assert smoke.NMS_WIDE_EXTRA > 0 and smoke.NMS_WIDE_ITER <= 1024
    from mxtpu_torch.tools import kernel_times
    assert kernel_times.NMS_CASES == tuple(c[:4] for c in smoke.NMS_CASES)
    assert (kernel_times.MOE_T, kernel_times.MOE_E, kernel_times.MOE_D,
            kernel_times.MOE_H, kernel_times.MOE_CF) == \
        (smoke.MOE_T, smoke.MOE_E, smoke.MOE_D, smoke.MOE_H, smoke.MOE_CF)
