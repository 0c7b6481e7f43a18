"""The launch geometry and the arithmetic order of the channels-major
BatchNorm kernels (``csrc/batch_norm.cu`` ``bn_fwd_major_*`` and
``csrc/batch_norm_bwd.cu`` ``bn_bwd_major_*``), on the CPU.

The geometry helper ``_major_plan`` is pure Python in the port's module:
these tests walk its slots as the kernels' index arithmetic does
(``common.cuh``: ``major_word``, ``MajorSlot``) and check that every
(n, c, s) falls in exactly one chunk, thread slot and word (a run's
partial head and tail words included), that the grid is the plan's,
that the backward walk of the apply passes covers the same slots, and
that the 16-byte word path is picked only where the alignment of the
data and S allow it.

Then both passes of the forward (#8) and the backward (#9) are emulated
in torch in the kernels' order (each thread's sums over its slots in
order, the block's fixed tree, the chunks added in order in double,
the apply passes walking CTAs and slots backwards) and held against
mxtpu's ``_fwd_call`` / ``_bwd_call`` in interpreter mode at
``test_torch_bn_kernels.py``'s tolerances (f32 1e-5; bf16 one bf16
ulp, 2^-7).  The masked dy (dr, written by the stats pass with the add)
is a select, not a rounding: it must equal the plain version's bit for
bit.  The CUDA kernels themselves run only on the card, through
``chip_smoke.py``.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

tbn = importlib.import_module("mxtpu_torch.kernels.batch_norm")
jbn = importlib.import_module("mxtpu.kernels.batch_norm")

torch.set_num_threads(2)

ITEMSIZE = {"float32": 4, "bfloat16": 2}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
SMS = 132   # the H100's SMs
THREADS = tbn.MAJOR_THREADS
EPS = 1e-5


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS", "interpret")


# the kernels' walk, as their index arithmetic computes it

def _slot_elements(plan, N, C, S, c, chunk):
    """The elements (flat indices into the (N, C, S) tensor) of each
    word slot of CTA (c, chunk), as ``major_word`` finds them: an array
    (slots, vec), -1 where the word's element lies outside the run.
    Slot t is the channel's thread t % tc's (t // tc)-th."""
    n0 = chunk * plan.per_chunk
    runs = min(plan.per_chunk, N - n0)
    t = np.arange(runs * plan.words, dtype=np.int64)
    i, w = t // plan.words, t % plan.words
    start = ((n0 + i) * C + c) * S
    e = ((start // plan.vec + w) * plan.vec)[:, None] + \
        np.arange(plan.vec)[None, :]
    inside = (e >= start[:, None]) & (e < (start + S)[:, None])
    return np.where(inside, e, -1)


class _Slot:
    """``MajorWalk`` of ``common.cuh``: a thread's (run, word) slot and
    the slot tc after or before it, by increments."""

    def __init__(self, t, words, tc):
        self.i, self.w, self.words = t // words, t % words, words
        self.di, self.dw = tc // words, tc % words

    def next(self):
        self.i += self.di
        self.w += self.dw
        if self.w >= self.words:
            self.w -= self.words
            self.i += 1

    def prev(self):
        self.i -= self.di
        self.w -= self.dw
        if self.w < 0:
            self.w += self.words
            self.i -= 1


def _thread_slots(items, words, tc, tid, reverse):
    """The (run, word) slots thread ``tid`` of a channel's ``tc``
    visits, in the stats passes' order or (``reverse``) the apply
    passes': from its last slot, ``last = tid + (items - 1 - tid) // tc
    * tc``, backwards."""
    out = []
    if tid >= items:
        return out
    if reverse:
        last = tid + (items - 1 - tid) // tc * tc
        sl = _Slot(last, words, tc)
        for _ in range(last, -1, -tc):
            out.append((sl.i, sl.w))
            sl.prev()
    else:
        sl = _Slot(tid, words, tc)
        for _ in range(tid, items, tc):
            out.append((sl.i, sl.w))
            sl.next()
    return out


def _channel_elements(N, C, S, c):
    n, s = np.meshgrid(np.arange(N), np.arange(S), indexing="ij")
    return ((n * C + c) * S + s).ravel()


# ------------------------------------------------------------ geometry

@pytest.mark.parametrize("dtype", list(ITEMSIZE))
@pytest.mark.parametrize("C", (3, 37, 256))
@pytest.mark.parametrize("S", (1, 7, 49, 196, 784, 3136, 12544))
def test_major_plan_puts_every_element_in_one_slot(S, C, dtype):
    it = ITEMSIZE[dtype]
    v = 16 // it
    for N in (1, 5, 64):
        for aligned in (True, False):
            p = tbn._major_plan(N, C, S, it, aligned, SMS)
            # 16-byte words only where every pointer is aligned and a
            # run is at least a word long
            assert p.vec == (v if aligned and S >= v else 1)
            assert p.peel == (S % p.vec != 0)
            # tc threads a channel: 256, halved (to a warp at least)
            # while a thread would get fewer than MAJOR_MIN_SLOTS slots
            # and every SM keeps a CTA
            assert p.tc in (32, 64, 128, 256)
            ctas = -(-C // (THREADS // p.tc))
            assert p.tc == 256 or (
                N * p.words < tbn.MAJOR_MIN_SLOTS * 2 * p.tc and
                ctas >= SMS)
            assert p.tc == 32 or N * p.words >= tbn.MAJOR_MIN_SLOTS * p.tc \
                or -(-C // (2 * THREADS // p.tc)) < SMS
            # runs of S * itemsize a multiple of 16 start on word
            # boundaries: no partial word, S / vec slots a run
            if (S * it) % 16 == 0:
                assert p.words == S // p.vec
            # the grid: chunks tile the runs, none empty, one wave of
            # MAJOR_CTAS_PER_SM CTAs an SM unless C alone is more, and
            # a chunk split off only with MAJOR_MIN_SLOTS slots a thread
            assert 1 <= p.chunks <= tbn.MAX_CHUNKS
            assert (p.chunks - 1) * p.per_chunk < N <= p.chunks * p.per_chunk
            assert p.chunks == 1 or \
                p.chunks * ctas <= SMS * tbn.MAJOR_CTAS_PER_SM
            assert p.chunks == 1 or \
                p.per_chunk * p.words >= tbn.MAJOR_MIN_SLOTS * p.tc
            # ``words`` is the most words any run touches
            assert p.words == _most_words(N * C, S, p.vec) or \
                N * C * np.gcd(S, p.vec) < p.vec
            for c in sorted({0, C // 2, C - 1}):
                slots = [_slot_elements(p, N, C, S, c, k)
                         for k in range(p.chunks)]
                # every (n, s) of channel c in exactly one word slot
                got = np.concatenate([e.ravel() for e in slots])
                got = got[got >= 0]
                want = _channel_elements(N, C, S, c)
                assert got.size == want.size
                assert np.array_equal(np.sort(got), want)
                for e in slots:
                    n_in = (e >= 0).sum(1)
                    per_run = n_in.reshape(-1, p.words)
                    assert (per_run.sum(1) == S).all()
                    # a run's words are its first slots, in order, and
                    # all full but its first and last: the head and
                    # tail peels
                    for row in per_run:
                        used = np.nonzero(row)[0]
                        assert used[0] == 0 and (np.diff(used) == 1).all()
                        assert (row[used[1:-1]] == p.vec).all()
                    # full words sit on 16-byte boundaries
                    assert (e[n_in == p.vec, 0] % p.vec == 0).all()


def _most_words(runs, S, vec):
    """The most words of ``vec`` elements any of the first ``runs``
    runs of S elements touches (run m starts at element m * S)."""
    return max((m * S % vec + S - 1) // vec + 1
               for m in range(min(runs, vec)))


@pytest.mark.parametrize("N,C,S,vec", [(3, 37, 1, 1), (5, 3, 49, 8),
                                       (7, 100, 196, 8), (2, 4, 196, 4),
                                       (9, 2, 3136, 8), (1, 2, 12544, 4),
                                       (300, 1, 1, 1)])
def test_apply_walk_is_the_stats_walk_backwards(N, C, S, vec):
    # MajorWalk's increments against the closed form, forwards from
    # each thread's first slot and backwards from its last
    words = (vec - np.gcd(S, vec) + S - 1) // vec + 1
    for tc in (32, 64, 128, 256):
        for runs in (1, 2, N):
            items = runs * words
            for tid in sorted({0, 1, 31, tc - 1} | {items - 1}):
                if tid >= tc:
                    continue
                fwd = _thread_slots(items, words, tc, tid, False)
                assert fwd == [(t // words, t % words)
                               for t in range(tid, items, tc)]
                assert _thread_slots(items, words, tc, tid, True) == \
                    fwd[::-1]


def test_major_plan_follows_alignment_of_the_data():
    # a view one element off a 16-byte boundary takes single elements;
    # the same shape aligned takes 16-byte words, with its runs' heads
    # and tails peeled where S * itemsize is off 16 bytes
    for dt, it in ((torch.float32, 4), (torch.bfloat16, 2)):
        for S in (49, 196, 3136):
            off = torch.zeros(2 * 5 * S + 1, dtype=dt)[1:].view(2, 5, S)
            full = torch.zeros(2, 5, S, dtype=dt)
            assert off.is_contiguous() and not tbn.aligned16(off)
            assert tbn._major_plan(2, 5, S, it, tbn.aligned16(off),
                                   SMS).vec == 1
            assert tbn.aligned16(full)
            p = tbn._major_plan(2, 5, S, it, tbn.aligned16(full), SMS)
            assert p.vec == 16 // it
            assert p.words == _most_words(10, S, p.vec)
            assert (p.words == S // p.vec) == ((S * it) % 16 == 0)
    # runs shorter than a word (S = 1: an (N, C) BatchNorm over axis 1
    # in the major view) take single elements, aligned or not
    assert tbn._major_plan(3, 37, 1, 4, True, SMS).vec == 1
    assert tbn._major_plan(3, 37, 7, 2, True, SMS).vec == 1
    assert tbn._major_plan(3, 37, 8, 2, True, SMS).vec == 8


# ------------------------------------------- the two passes, emulated

def _pair(a, dtype):
    td, jd = DTYPES[dtype]
    return torch.from_numpy(a).to(td), jnp.asarray(a).astype(jd)


def _fma(a, b, c):
    """fmaf on f32 tensors: the product exact in f64, one rounding of
    the sum to f32 (its f64 rounding first can differ only in a tie)."""
    return (a.double() * b.double() + c.double()).float()


def _channel_sum(v):
    """major_sums of ``common.cuh`` over a channel's tc per-thread f32
    values: each warp's xor butterfly, then its warps added in order."""
    v = v.reshape(-1, 32)
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[:, idx ^ o]
    t = torch.zeros((), dtype=torch.float32)
    for w in range(v.shape[0]):
        t = t + v[w, 0]
    return t


def _thread_major(plan, N, C, S, c, chunk):
    """Channel c's slots in a chunk as (k, thread, vec) element indices:
    slot t = k * tc + thread, -1 where empty."""
    e = _slot_elements(plan, N, C, S, c, chunk)
    k = -(-e.shape[0] // plan.tc)
    pad = np.full((k * plan.tc - e.shape[0], plan.vec), -1, np.int64)
    return np.concatenate([e, pad]).reshape(k, plan.tc, plan.vec)


def _stats(plan, N, C, S, step):
    """The stats pass: for each channel and chunk, each of its threads'
    two f32 sums over its slots in order (``step(idx, s1, s2) -> (s1,
    s2)`` for the elements ``idx`` of one element position of one slot,
    -1 for none), then the channel's sum; returns
    part[2][chunks][C]."""
    part = torch.zeros(2, plan.chunks, C)
    for c in range(C):
        for k in range(plan.chunks):
            e = _thread_major(plan, N, C, S, c, k)
            s1 = torch.zeros(plan.tc)
            s2 = torch.zeros(plan.tc)
            for kk in range(e.shape[0]):
                for j in range(plan.vec):
                    s1, s2 = step(torch.from_numpy(e[kk, :, j]), s1, s2)
            part[0, k, c] = _channel_sum(s1)
            part[1, k, c] = _channel_sum(s2)
    return part


def _chunks_in_double(part):
    """The finalize kernels' sums: the chunks in order, in double."""
    a = torch.zeros(part.shape[2], dtype=torch.float64)
    b = torch.zeros(part.shape[2], dtype=torch.float64)
    for k in range(part.shape[1]):
        a = a + part[0, k].double()
        b = b + part[1, k].double()
    return a, b


def _apply(plan, N, C, S, fn, out):
    """The apply pass: CTAs in the reverse of the stats pass's order,
    each thread's slots backwards from its last; ``fn(idx, c)`` gives
    the values of elements ``idx`` of channel c.  Every element is
    written exactly once."""
    flat = out.view(-1)
    seen = np.zeros(N * C * S, np.int64)
    per_cta = THREADS // plan.tc
    ctas = -(-C // per_cta)
    for b in range(ctas * plan.chunks - 1, -1, -1):
        chunk = b // ctas
        for c in range(b % ctas * per_cta, min(C, (b % ctas + 1) * per_cta)):
            e = _slot_elements(plan, N, C, S, c, chunk)
            runs = min(plan.per_chunk, N - chunk * plan.per_chunk)
            items = runs * plan.words
            for tid in range(min(plan.tc, items)):
                for i, w in _thread_slots(items, plan.words, plan.tc, tid,
                                          True):
                    idx = e[i * plan.words + w]
                    idx = idx[idx >= 0]
                    np.add.at(seen, idx, 1)
                    ti = torch.from_numpy(idx)
                    flat[ti] = fn(ti, c)
    assert (seen == 1).all()
    return out


def _emulate_fwd(x, r, g, b, act, plan):
    """bn_fwd_major_stats_kernel, bn_fwd_finalize_kernel and
    bn_fwd_major_apply_kernel in torch; returns (y, mean, var)."""
    N, C, S = x.shape
    xf = x.float().reshape(-1)

    def step(idx, s1, s2):
        ok = idx >= 0
        v = xf[idx.clamp_min(0)]
        return (torch.where(ok, s1 + v, s1),
                torch.where(ok, _fma(v, v, s2), s2))
    part = _stats(plan, N, C, S, step)
    a, bb = _chunks_in_double(part)
    n = float(N * S)
    m = a / n
    v = bb / n - m * m
    v = torch.where(v > 0, v, torch.zeros_like(v))
    mean, var = m.float(), v.float()
    rs = torch.rsqrt(var + torch.tensor(EPS, dtype=torch.float32))
    sc = g.float() * rs
    sh = b.float() - mean * sc
    rf = None if r is None else r.float().reshape(-1)

    def fn(idx, c):
        y = xf[idx] * sc[c] + sh[c]
        if rf is not None:
            y = y + rf[idx]
        if act == "relu":
            y = y.clamp_min(0.0)
        return y.to(x.dtype)
    y = _apply(plan, N, C, S, fn, torch.empty_like(x))
    return y, mean, var


def _emulate_bwd(x, r, dy, g, b, mean, rstd, act, plan):
    """bn_bwd_major_stats_kernel, bn_bwd_finalize_kernel and
    bn_bwd_major_apply_kernel in torch; returns (dx, dr or None,
    dgamma, dbeta)."""
    N, C, S = x.shape
    xf, dyf = x.float().reshape(-1), dy.float().reshape(-1)
    rf = None if r is None else r.float().reshape(-1)
    ch = torch.arange(N * C * S) // S % C
    xh_all = (xf - mean[ch]) * rstd[ch]
    d_all = dyf
    if act == "relu":
        a = xh_all * g.float()[ch] + b.float()[ch]
        if rf is not None:
            a = a + rf
        d_all = torch.where(a > 0, dyf, torch.zeros_like(dyf))

    def step(idx, s1, s2):
        ok = idx >= 0
        i = idx.clamp_min(0)
        d, xh = d_all[i], xh_all[i]
        return (torch.where(ok, s1 + d, s1),
                torch.where(ok, _fma(d, xh, s2), s2))
    part = _stats(plan, N, C, S, step)
    a, bb = _chunks_in_double(part)
    dbeta, dgamma = a.float(), bb.float()
    n = torch.tensor(float(N * S), dtype=torch.float32)
    k0, k1, k2 = g.float() * rstd, dbeta / n, dgamma / n
    # the stats pass writes dr = d with the add; the apply pass reads it
    dr = None if r is None else d_all.to(dy.dtype).reshape(x.shape)
    d_in = d_all if dr is None else dr.float().reshape(-1)

    def fn(idx, c):
        t = (d_in[idx] - k1[c]) - xh_all[idx] * k2[c]
        return (k0[c] * t).to(x.dtype)
    dx = _apply(plan, N, C, S, fn, torch.empty_like(x))
    return dx, dr, dgamma, dbeta


def _close(got, want, tol, what):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


# N of each emulated S: several warps of slots a CTA, and threads with
# more than one slot where a chunk's runs * words pass 256 (S = 1, 49,
# and 196 in f32); at larger N (24 at S = 196) mxtpu's own f32 sums
# drift past 1e-5 from the exact (f64) sums, while the kernels' order
# stays within it
SHAPES = {1: 600, 49: 48, 196: 12}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act,add", [("none", False), ("none", True),
                                     ("relu", False), ("relu", True)])
@pytest.mark.parametrize("S", sorted(SHAPES))
def test_major_passes_match_pallas_kernels(S, act, add, dtype):
    _check_passes(SHAPES[S], 3, S, act, add, dtype, aligned=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_major_passes_on_single_elements_match_pallas_kernels(dtype):
    # data off a 16-byte boundary: the walk over single elements
    _check_passes(48, 3, 49, "relu", True, dtype, aligned=False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tc", [32, 64])
def test_major_passes_with_several_channels_a_cta(tc, dtype):
    # the plan gives these three channels a CTA each (fewer CTAs than
    # SMs); at C = 2048 and S = 49 it takes 128 threads a channel: a
    # warp a channel (8 channels a CTA, 5 idle here) and two warps (4 a
    # CTA, 1 idle) walk more slots a thread and add their warps' sums
    # in order
    _check_passes(12, 3, 196, "relu", True, dtype, aligned=True, tc=tc)


def _check_passes(N, C, S, act, add, dtype, aligned, tc=None):
    rng = np.random.RandomState(3 + S)
    shape = (N, C, S)
    x = (0.5 + 2.0 * rng.randn(*shape)).astype(np.float32)
    r = rng.randn(*shape).astype(np.float32) if add else None
    dy = rng.randn(*shape).astype(np.float32)
    g = (1.0 + 0.2 * rng.randn(C)).astype(np.float32)
    b = (0.1 * rng.randn(C)).astype(np.float32)
    (tx, jx), (tdy, jdy), (tg, jg), (tb, jb) = (
        _pair(a, dtype) for a in (x, dy, g, b))
    tr, jr = _pair(r, dtype) if add else (None, None)
    plan = tbn._major_plan(N, C, S, tx.element_size(), aligned, SMS)
    assert plan.vec == (16 // tx.element_size() if aligned and S > 1
                        else 1)
    # two chunks (the plan keeps one at these sizes): the partial sums
    # of several chunks, added in order by the finalize kernels
    half = -(-N // 2)
    plan = plan._replace(chunks=2, per_chunk=half, tc=tc or plan.tc)
    jf = jbn._fwd_call(jx, jg, jb, jr, EPS, act, C, True)
    y, mean, var = _emulate_fwd(tx, tr, tg, tb, act, plan)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    _close(y, jf[0], tol, "y")
    _close(mean, jf[1], 1e-5, "mean")
    _close(var, jf[2], 1e-5, "var")
    # the backward from the same f32 statistics on both sides
    rstd = torch.rsqrt(var + EPS)
    dx, dr, dgamma, dbeta = _emulate_bwd(tx, tr, tdy, tg, tb, mean, rstd,
                                         act, plan)
    jw = jbn._bwd_call(jx, jr, jdy, jg, jb, jnp.asarray(mean.numpy()),
                       jnp.asarray(rstd.numpy()), act, C, True)
    _close(dx, jw[0], tol, "dx")
    _close(dgamma, jw[2], 1e-5, "dgamma")
    _close(dbeta, jw[3], 1e-5, "dbeta")
    # the kernels' sums (short per-thread sums, a tree, the chunks in
    # double) against exact ones, at the same tolerance
    x64 = tx.double()
    m64 = x64.mean(dim=(0, 2))
    xh = (x64 - mean.double()[:, None]) * rstd.double()[:, None]
    d64 = tdy.double() if dr is None and act == "none" else \
        tbn.bn_bwd_reference(tx, tr if add else torch.zeros_like(tx), tdy,
                             tg, tb, mean, rstd, act)[1].double()
    for what, got, want in (
            ("mean vs f64", mean, m64),
            ("var vs f64", var, (x64 * x64).mean(dim=(0, 2)) - m64 * m64),
            ("dgamma vs f64", dgamma, (d64 * xh).sum(dim=(0, 2))),
            ("dbeta vs f64", dbeta, d64.sum(dim=(0, 2)))):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=what)
    if add:
        # dr: the plain version's and mxtpu's bit for bit
        want = tbn.bn_bwd_reference(tx, tr, tdy, tg, tb, mean, rstd, act)
        assert torch.equal(dr, want[1])
        np.testing.assert_array_equal(
            dr.float().numpy(), np.asarray(jw[1].astype(jnp.float32)))
    else:
        assert dr is None
