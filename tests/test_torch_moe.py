"""The Switch-MoE slice of mxtpu_torch held against mxtpu on the CPU:
``switch_router``, ``moe_ffn`` (forward and the gradients of
``sum(y * c) + alpha * aux`` in every argument), the ``MoEFFN`` op
through ``nd`` and ``sym``, ``gluon.contrib.nn`` (``MoEDense``,
``Concurrent``, ``HybridConcurrent``, ``Identity``), the jitter noise
from a key, ``plan_zero_buckets``, and the route kernel's ordered scan.

``moe_ffn`` on CPU tensors runs mxtpu's dense one-hot form; the gathered
form the card runs (``parallel.moe.ffn_kernels``: the route, dispatch
and combine kernels' autograd Functions) is held here through the
kernels' plain versions, against mxtpu and against the dense form.

Tolerances: f32 1e-5 x max(1, |ref|) (the same f32 products, summed in
another order); bf16: the error's rms within 2e-2 of each tensor's rms
(the expert GEMMs round to bf16 at other places in the two frameworks,
and jax's gelu and tanh round each of their steps to bf16 where torch's
round once, so an element may part by a few bf16 ulps).  Routing is compared
exactly, except for a token whose two largest probabilities lie within
1e-6 relative of each other: such tokens are counted, and at these
seeds there are none.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxtpu as jmx
from mxtpu import autograd as jag
from mxtpu import nd as jnd
from mxtpu import parallel as jpar
from mxtpu import sym as jsym
from mxtpu.base import MXNetError as JMXNetError
from mxtpu.gluon import Trainer as JTrainer
from mxtpu.gluon import contrib as jcontrib
from mxtpu.gluon import nn as jnn
from mxtpu.parallel import moe as jmoe

import mxtpu_torch as tmx
from mxtpu_torch import autograd as tag
from mxtpu_torch import nd as tnd
from mxtpu_torch import parallel as tpar
from mxtpu_torch import symbol as tsym
from mxtpu_torch.base import MXNetError
from mxtpu_torch.convert import moe_params_from_numpy, params_from_mxtpu
from mxtpu_torch.gluon import Trainer as TTrainer
from mxtpu_torch.gluon import contrib as tcontrib
from mxtpu_torch.gluon import nn as tnn
from mxtpu_torch.kernels import moe as kmoe
from mxtpu_torch.parallel import moe as tmoe

from torch_gluon_names import fresh_names

torch.set_num_threads(2)
CPU = tmx.cpu()
NEAR_TIE = 1e-6
TOL_F32 = 1e-5
TOL_BF16 = 2e-2
ACTS = {"relu": (jax.nn.relu, torch.relu),
        "gelu": (jax.nn.gelu,
                 lambda h: torch.nn.functional.gelu(h, approximate="tanh")),
        "tanh": (jnp.tanh, torch.tanh)}


def _arrays(seed, T, D, H, E, gate_scale=1.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(T, D).astype(np.float32),
            (rng.randn(D, E) * gate_scale).astype(np.float32),
            (rng.randn(E, D, H) * 0.3).astype(np.float32),
            (rng.randn(E, H) * 0.1).astype(np.float32),
            (rng.randn(E, H, D) * 0.3).astype(np.float32),
            (rng.randn(E, D) * 0.1).astype(np.float32))


def _near_ties(x, gw):
    """Tokens whose two largest router probabilities lie within
    ``NEAR_TIE`` relative of each other."""
    logits = x.astype(np.float64) @ gw.astype(np.float64)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    if p.shape[1] < 2:
        return 0
    top = np.sort(p, -1)[:, -2:]
    return int(((top[:, 1] - top[:, 0]) <= NEAR_TIE * top[:, 1]).sum())


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    bound = tol * np.maximum(1.0, np.abs(want))
    assert (err <= bound).all(), (what, float(err.max()))


def _close_rms(got, want, tol, what):
    """The error's rms within ``tol`` of the tensor's rms."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rms = max(float(np.sqrt((want ** 2).mean())), 1e-30)
    err = float(np.sqrt(((got - want) ** 2).mean()))
    assert err <= tol * rms, (what, err, rms)


# ----------------------------------------------------------------------
# routing
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed,T,D,E,C", [
    (0, 16, 8, 4, 3), (1, 64, 16, 4, 20), (2, 33, 8, 1, 40),
    (3, 48, 12, 3, 5), (4, 64, 8, 4, 1)])
def test_switch_router_matches_mxtpu(seed, T, D, E, C):
    x, gw = _arrays(seed, T, D, 4, E)[:2]
    assert _near_ties(x, gw) == 0
    jd, jc, ja = jmoe.switch_router(jnp.asarray(x), jnp.asarray(gw), C)
    td, tc, ta = tmoe.switch_router(torch.from_numpy(x),
                                    torch.from_numpy(gw), C)
    assert td.shape == (T, E, C) and td.dtype == torch.float32
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    _close(tc.numpy(), np.asarray(jc), TOL_F32, "combine")
    _close(float(ta), float(ja), TOL_F32, "aux")
    # each token in at most one slot, each slot holds at most one token
    assert td.sum((1, 2)).max() <= 1.0 and td.sum(0).max() <= 1.0


@pytest.mark.parametrize("T,E,C", [(16, 4, 3), (64, 4, 20), (33, 1, 40),
                                   (48, 3, 5)])
def test_route_plain_version_gives_the_dense_maps(T, E, C):
    """The route kernel's plain version: slots, their inverse, gate_p,
    frac and mean_p against mxtpu's dense router."""
    x, gw = _arrays(T + E, T, 8, 4, E)[:2]
    jd, jc, ja = jmoe.switch_router(jnp.asarray(x), jnp.asarray(gw), C)
    jd, jc = np.asarray(jd), np.asarray(jc)
    logits = torch.from_numpy(x) @ torch.from_numpy(gw)
    probs, expert, gate_p, sot, tos, frac, mean_p = kmoe.route(logits, C)
    dense = np.zeros((T, E * C), np.float32)
    kept = sot.numpy() >= 0
    dense[np.nonzero(kept)[0], sot.numpy()[kept]] = 1.0
    np.testing.assert_array_equal(dense.reshape(T, E, C), jd)
    inv = np.full(E * C, -1)
    inv[sot.numpy()[kept]] = np.nonzero(kept)[0]
    np.testing.assert_array_equal(tos.numpy(), inv)
    _close(gate_p.numpy()[kept],
           jc.reshape(T, -1).sum(-1)[kept], TOL_F32, "gate_p")
    _close(float(E * (frac * mean_p).sum()), float(ja), TOL_F32, "aux")
    assert sot.dtype == tos.dtype == expert.dtype == torch.int32


def _butterfly(v):
    """The xor-shuffle sum of 32 f32 lanes (lane 0's value; every lane
    ends with the same bits)."""
    v = np.asarray(v, np.float32).copy()
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[lanes ^ o]).astype(np.float32)
    return v[0]


def _emulated_scan(expert, E, C, probs=None):
    """The route kernel's slot assignment as the card runs it, with the
    CTA size and cluster size read from ``moe.cu``: rounds of
    ``cluster x threads`` tokens, a CTA a contiguous chunk in rank order;
    a token's rank among its warp's lanes of the same expert
    (``__match_any_sync``), the warps' counts scanned per expert, each
    CTA's base the carried total plus the counts of the CTAs ranked
    before it.  Returns (slot_of_token, token_of_slot, counts) and, given
    ``probs``, mean_p summed as the kernel sums it: a warp's lanes and a
    CTA's 32 warps by xor butterflies (zeros past T), the CTAs in rank
    order, the rounds in order.  token_of_slot starts as garbage, takes
    the kept tokens, then the -1 that each expert's owning CTA writes
    into its empty slots."""
    threads = _source_constant("ROUTE_THREADS")
    cluster = _source_constant("ROUTE_CLUSTER")
    warps = threads // 32
    T = len(expert)
    carry = np.zeros(E, np.int64)
    carry_ps = np.zeros(E, np.float32)
    slot = np.full(T, -1, np.int64)
    token_of_slot = np.full(E * C, -7, np.int64)   # torch.empty's garbage
    for r0 in range(0, T, threads * cluster):
        cta_counts, cta_ps, cta_excl = [], [], []
        for c in range(cluster):
            lo = r0 + c * threads
            ex = np.full(threads, -1, np.int64)
            chunk = expert[lo:lo + threads]
            ex[:len(chunk)] = chunk
            onehot = (ex[:, None] == np.arange(E)[None, :]).reshape(
                warps, 32, E)
            counts = onehot.sum(1)                     # (warps, E)
            excl = np.cumsum(counts, 0) - counts
            cta_counts.append(counts.sum(0))
            cta_excl.append((onehot, excl))
            if probs is not None:
                p = np.zeros((threads, E), np.float32)
                rows = probs[lo:lo + threads]
                p[:len(rows)] = rows
                p = p.reshape(warps, 32, E)
                wsum = np.array([[_butterfly(p[w, :, e]) for e in range(E)]
                                 for w in range(warps)], np.float32)
                cta_ps.append(np.array([_butterfly(wsum[:, e])
                                        for e in range(E)], np.float32))
        for c in range(cluster):
            base = carry + sum(cta_counts[:c], np.zeros(E, np.int64))
            onehot, excl = cta_excl[c]
            for w in range(warps):
                for lane in range(32):
                    t = r0 + c * threads + 32 * w + lane
                    if t >= T:
                        continue
                    e = expert[t]
                    rank = int(onehot[w, :lane, e].sum())
                    pos = base[e] + excl[w, e] + rank
                    if pos < C:
                        slot[t] = e * C + pos
                        token_of_slot[e * C + pos] = t
        carry = carry + sum(cta_counts, np.zeros(E, np.int64))
        if probs is not None:
            ps = np.zeros(E, np.float32)
            for c in range(cluster):
                ps = (ps + cta_ps[c]).astype(np.float32)
            carry_ps = (carry_ps + ps).astype(np.float32)
    for e in range(E):
        token_of_slot[e * C + min(int(carry[e]), C):(e + 1) * C] = -1
    mean_p = None if probs is None else \
        (carry_ps / np.float32(T)).astype(np.float32)
    return slot, token_of_slot, carry, mean_p


def _source_constant(name):
    src = (kmoe._build.CSRC / "moe.cu").read_text()
    return int(re.search(rf"{name} = (\d+);", src).group(1))


def _round():
    return _source_constant("ROUTE_THREADS") * \
        _source_constant("ROUTE_CLUSTER")


@pytest.mark.parametrize("T,E,skew", [
    (1, 1, 0.0), (31, 3, 0.0), (1024, 8, 0.0), (1025, 8, 2.0),
    (3000, 5, 1.0), (2100, 2, 3.0),
    # below one CTA, one round, one past it, three rounds, E 1 and 128,
    # and a skewed router that drops tokens
    (700, 4, 0.0), ("round", 8, 0.0), ("round+1", 8, 1.0),
    ("3 rounds", 8, 0.5), (9000, 1, 0.0), ("round+1", 128, 0.0),
    (5000, 8, 4.0)])
def test_route_scan_emulation_matches_cumsum(T, E, skew):
    if isinstance(T, str):
        T = {"round": _round(), "round+1": _round() + 1,
             "3 rounds": 3 * _round()}[T]
    threads = _source_constant("ROUTE_THREADS")
    assert threads % 32 == 0 and _source_constant("ROUTE_CLUSTER") >= 1
    rng = np.random.RandomState(T)
    logits = rng.randn(T, E) + skew * np.arange(E)[None, :] / max(E, 1)
    expert = logits.argmax(-1)
    C = max(1, int(np.ceil(T / E * 1.1)))
    slot, tos, counts, _ = _emulated_scan(expert, E, C)
    _, _, _, sot, ref_tos, frac, _ = kmoe.route_reference(
        torch.from_numpy(logits.astype(np.float32)), C)
    np.testing.assert_array_equal(slot, sot.numpy())
    np.testing.assert_array_equal(tos, ref_tos.numpy())
    np.testing.assert_array_equal((counts / T).astype(np.float32),
                                  frac.numpy())
    if skew >= 4.0:
        assert (slot < 0).any()         # the skewed router drops tokens


@pytest.mark.parametrize("T,E,seed", [(300, 4, 0), ("round+1", 8, 1),
                                      (2500, 128, 2)])
def test_route_emulated_mean_p_and_empty_slots_match_mxtpu(T, E, seed):
    """mean_p summed in the kernel's fixed order against mxtpu's
    ``mean(probs, 0)`` and its aux loss, and every empty slot -1."""
    if isinstance(T, str):
        T = _round() + 1
    x, gw = _arrays(seed, T, 8, 4, E)[:2]
    C = max(1, int(np.ceil(T / E * 0.9)))
    logits = torch.from_numpy(x) @ torch.from_numpy(gw)
    probs = kmoe.softmax_ordered(logits).numpy()
    expert = probs.argmax(-1)
    slot, tos, counts, mean_p = _emulated_scan(expert, E, C, probs)
    jl = jnp.asarray(x) @ jnp.asarray(gw)
    _close(mean_p, np.asarray(jnp.mean(jax.nn.softmax(jl, -1), 0)),
           TOL_F32, "mean_p")
    _, _, ja = jmoe.switch_router(jnp.asarray(x), jnp.asarray(gw), C)
    frac = (counts / T).astype(np.float32)
    _close(float(E * (frac * mean_p).sum()), float(ja), TOL_F32, "aux")
    empty = np.ones(E * C, bool)
    empty[slot[slot >= 0]] = False
    assert (tos[empty] == -1).all() and (tos[~empty] >= 0).all()
    assert empty.any()


def test_route_kernel_source_limits_match_the_wrapper():
    assert _source_constant("MAX_EXPERTS") == kmoe.MAX_EXPERTS
    with pytest.raises(MXNetError, match="1..128"):
        kmoe.route(torch.zeros(4, kmoe.MAX_EXPERTS + 1), 2)


# ----------------------------------------------------------------------
# moe_ffn forward and gradients
# ----------------------------------------------------------------------
def _jax_run(arrays, cf, act, dtype, alpha, c, key=None, jitter=0.0):
    x, gw, w1, b1, w2, b2 = (jnp.asarray(a) for a in arrays)
    x = x.astype(dtype)

    def f(x, gw, w1, b1, w2, b2):
        y, aux = jmoe.moe_ffn(x, gw, w1, b1, w2, b2, capacity_factor=cf,
                              activation=ACTS[act][0], key=key,
                              jitter=jitter)
        return (y.astype(jnp.float32) * c).sum() + alpha * aux, (y, aux)

    grads, (y, aux) = jax.grad(f, argnums=tuple(range(6)), has_aux=True)(
        x, gw, w1, b1, w2, b2)
    return (np.asarray(y.astype(jnp.float32)), float(aux),
            [np.asarray(g.astype(jnp.float32)) for g in grads])


def _torch_run(arrays, cf, act, dtype, alpha, c, gathered, key=None,
               jitter=0.0):
    ts = [torch.from_numpy(a).clone() for a in arrays]
    ts[0] = ts[0].to(dtype)
    for t in ts:
        t.requires_grad_(True)
    if gathered:
        T, E = ts[0].shape[0], ts[2].shape[0]
        y, aux = tmoe.ffn_kernels(*ts, tmoe.capacity_of(T, E, cf),
                                  ACTS[act][1], key, jitter)
    else:
        y, aux = tmoe.moe_ffn(*ts, capacity_factor=cf,
                              activation=ACTS[act][1], key=key,
                              jitter=jitter)
    ((y.float() * torch.from_numpy(c)).sum() + alpha * aux).backward()
    return (y.detach().float().numpy(), float(aux.detach()),
            [t.grad.float().numpy() for t in ts])


@pytest.mark.parametrize("gathered", [False, True],
                         ids=["dense", "gathered"])
@pytest.mark.parametrize("act", ["relu", "gelu", "tanh"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed,T,D,H,E,cf", [(10, 32, 8, 16, 4, 1.25),
                                             (11, 64, 16, 32, 3, 0.5)])
def test_moe_ffn_forward_and_gradients_match_mxtpu(seed, T, D, H, E, cf,
                                                   dtype, act, gathered):
    arrays = _arrays(seed, T, D, H, E)
    assert _near_ties(arrays[0], arrays[1]) == 0
    c = np.random.RandomState(seed + 100).randn(T, D).astype(np.float32)
    alpha = 0.37
    jy, ja, jg = _jax_run(arrays, cf, act, getattr(jnp, dtype), alpha, c)
    ty, ta, tg = _torch_run(arrays, cf, act, getattr(torch, dtype), alpha,
                            c, gathered)
    names = ["y", "x", "gate_w", "w1", "b1", "w2", "b2"]
    check = (lambda g, w, n: _close(g, w, TOL_F32, n)) \
        if dtype == "float32" else \
        (lambda g, w, n: _close_rms(g, w, TOL_BF16, n))
    for n, g, w in zip(names, [ty] + tg, [jy] + jg):
        check(g, w, n)
    _close(ta, ja, TOL_F32, "aux")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gathered_form_equals_dense_form(dtype):
    """The card's composition (gathers) against mxtpu's dense einsums on
    the same inputs: expert_in and y bit for bit (they are a
    permutation of the same values), the gradients to rounding."""
    arrays = _arrays(20, 48, 16, 24, 4)
    C = tmoe.capacity_of(48, 4, 1.0)
    outs = []
    for run in (tmoe.ffn_dense, tmoe.ffn_kernels):
        ts = [torch.from_numpy(a).clone() for a in arrays]
        ts[0] = ts[0].to(dtype)
        for t in ts:
            t.requires_grad_(True)
        y, aux = run(*ts, C, torch.relu)
        (y.float().square().sum() + aux).backward()
        outs.append((y.detach(), aux.detach(), [t.grad for t in ts]))
    (y_d, a_d, g_d), (y_k, a_k, g_k) = outs
    # each form's slot maps and expert inputs, from the same logits
    x = torch.from_numpy(arrays[0]).to(dtype)
    logits = tmoe._logits(x, torch.from_numpy(arrays[1]), None, 0.0)
    dispatch = tmoe._dense_route(logits, C)[0]
    ei_d = torch.einsum("td,tec->ecd", x.float(), dispatch).to(dtype)
    flat = dispatch.reshape(dispatch.shape[0], -1)
    s_d = torch.where(flat.sum(-1) > 0, flat.argmax(-1), -1).to(torch.int32)
    _, _, s_k, tos, _ = kmoe.route_tokens(logits, C)
    ei_k = kmoe.dispatch_tokens(x, tos, s_k).reshape(ei_d.shape)
    assert torch.equal(s_d, s_k) and (s_k < 0).any()
    assert torch.equal(ei_d, ei_k) and torch.equal(y_d, y_k)
    _close(float(a_k), float(a_d), TOL_F32, "aux")
    for gk, gd in zip(g_k, g_d):
        _close_rms(gk.float().numpy(), gd.float().numpy(),
                   TOL_F32 if dtype == torch.float32 else TOL_BF16, "grad")


def test_moe_ffn_keeps_leading_dims():
    arrays = _arrays(21, 24, 8, 16, 2)
    x3 = arrays[0].reshape(2, 12, 8)
    jy, ja = jmoe.moe_ffn(*(jnp.asarray(a) for a in (x3,) + arrays[1:]))
    ty, ta = tmoe.moe_ffn(*(torch.from_numpy(a) for a in (x3,) + arrays[1:]))
    assert ty.shape == (2, 12, 8)
    _close(ty.numpy(), np.asarray(jy), TOL_F32, "y")
    _close(float(ta), float(ja), TOL_F32, "aux")


# ----------------------------------------------------------------------
# edge cases
# ----------------------------------------------------------------------
@pytest.mark.parametrize("gathered", [False, True],
                         ids=["dense", "gathered"])
def test_dropped_tokens_get_zero_output(gathered):
    rng = np.random.RandomState(2)
    D, H, T, E = 4, 8, 32, 2
    # positive features so a negative gate column repels every token
    x = (np.abs(rng.randn(T, D)) + 0.1).astype(np.float32)
    gw = np.zeros((D, E), np.float32)
    gw[:, 1] = -10.0
    _, w1, b1, w2, b2 = (np.asarray(a) for a in
                         jmoe.MoEFFN(D, H, E, capacity_factor=0.125,
                                     seed=3).params())
    arrays = (x, gw, w1, b1, w2, b2)
    jy, _ = jmoe.moe_ffn(*(jnp.asarray(a) for a in arrays),
                         capacity_factor=0.125)
    ts = moe_params_from_numpy(arrays[1:], device="cpu")
    tx = torch.from_numpy(x)
    if gathered:
        ty, _ = tmoe.ffn_kernels(tx, *ts, tmoe.capacity_of(T, E, 0.125),
                                 torch.relu)
    else:
        ty, _ = tmoe.moe_ffn(tx, *ts, capacity_factor=0.125)
    # capacity ceil(32 / 2 * 0.125) = 2 slots: the other 30 tokens give 0
    kept = np.abs(ty.numpy()).sum(-1) > 0
    assert kept.sum() == 2 and (ty.numpy()[~kept] == 0).all()
    _close(ty.numpy(), np.asarray(jy), TOL_F32, "y")


def test_single_expert_matches_dense_ffn():
    """E = 1 with ample capacity is the dense FFN (mxtpu's
    test_moe_single_expert_matches_dense_ffn)."""
    rng = np.random.RandomState(1)
    D, H, T = 8, 16, 12
    x = rng.randn(T, D).astype(np.float32)
    gw = np.zeros((D, 1), np.float32)
    w1 = (rng.randn(1, D, H) * 0.3).astype(np.float32)
    b1 = (rng.randn(1, H) * 0.1).astype(np.float32)
    w2 = (rng.randn(1, H, D) * 0.3).astype(np.float32)
    b2 = (rng.randn(1, D) * 0.1).astype(np.float32)
    ts = [torch.from_numpy(a) for a in (x, gw, w1, b1, w2, b2)]
    y, _ = tmoe.moe_ffn(*ts, capacity_factor=1.0)
    want = torch.relu(ts[0] @ ts[2][0] + ts[3][0]) @ ts[4][0] + ts[5][0]
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    jy, _ = jmoe.moe_ffn(*(jnp.asarray(a) for a in (x, gw, w1, b1, w2, b2)),
                         capacity_factor=1.0)
    _close(y.numpy(), np.asarray(jy), TOL_F32, "y")


def test_refused_activation_and_mesh():
    a = [tnd.array(v, ctx=CPU) for v in _arrays(5, 8, 4, 8, 2)]
    j = [jnd.array(v) for v in _arrays(5, 8, 4, 8, 2)]
    with pytest.raises(MXNetError, match="activation"):
        tnd.MoEFFN(*a, activation="swish")
    with pytest.raises(JMXNetError, match="activation"):
        jnd.MoEFFN(*j, activation="swish")
    # the rule's own check, past the registry's
    from mxtpu_torch.ndarray.nn_extra import _contrib_moe_ffn
    with pytest.raises(MXNetError, match="relu/gelu/tanh"):
        _contrib_moe_ffn(*[v._data for v in a], activation="swish")
    with pytest.raises(NotImplementedError, match="a device mesh"):
        tmoe.moe_ffn(*[v._data for v in a], mesh=object())


@pytest.mark.parametrize("seed,shape,jitter", [(7, (48, 4), 0.1),
                                               (123456789, (1000, 7), 0.37),
                                               (0, (5, 1), 1.0)])
def test_jitter_noise_is_jax_uniform_bit_for_bit(seed, shape, jitter):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.uniform(key, shape, minval=-jitter,
                                         maxval=jitter))
    got = tmoe.jitter_noise(np.asarray(key), shape, jitter).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("gathered", [False, True],
                         ids=["dense", "gathered"])
def test_moe_ffn_with_jitter_key_matches_mxtpu(gathered):
    arrays = _arrays(30, 40, 8, 16, 4, gate_scale=0.2)
    key = jax.random.PRNGKey(11)
    c = np.random.RandomState(31).randn(40, 8).astype(np.float32)
    jy, ja, jg = _jax_run(arrays, 1.25, "relu", jnp.float32, 0.1, c,
                          key=key, jitter=0.05)
    ty, ta, tg = _torch_run(arrays, 1.25, "relu", torch.float32, 0.1, c,
                            gathered, key=np.asarray(key), jitter=0.05)
    ny, _, _ = _torch_run(arrays, 1.25, "relu", torch.float32, 0.1, c,
                          gathered)
    assert not np.array_equal(ty, ny)     # the noise moved some tokens
    for n, g, w in zip(["y", "x", "gate_w", "w1", "b1", "w2", "b2"],
                       [ty] + tg, [jy] + jg):
        _close(g, w, TOL_F32, n)
    _close(ta, ja, TOL_F32, "aux")


def test_moeffn_container_and_converted_params():
    m = tmoe.MoEFFN(8, 16, 4, capacity_factor=1.5, seed=3, device="cpu")
    gw, w1, b1, w2, b2 = m.params()
    assert gw.shape == (8, 4) and w1.shape == (4, 8, 16)
    assert b1.abs().sum() == 0 and b2.shape == (4, 8)
    again = tmoe.MoEFFN(8, 16, 4, seed=3, device="cpu").params()
    assert all(torch.equal(a, b) for a, b in zip(m.params(), again))
    jm = jmoe.MoEFFN(8, 16, 4, capacity_factor=1.5, seed=3)
    x = np.random.RandomState(4).randn(24, 8).astype(np.float32)
    jy, ja = jm.apply(jm.params(), jnp.asarray(x))
    tp = moe_params_from_numpy([np.asarray(p) for p in jm.params()],
                               device="cpu")
    ty, ta = m.apply(tp, torch.from_numpy(x))
    _close(ty.numpy(), np.asarray(jy), TOL_F32, "y")
    _close(float(ta), float(ja), TOL_F32, "aux")
    with pytest.raises(MXNetError, match="5 arrays"):
        moe_params_from_numpy(tp[:4], device="cpu")


# ----------------------------------------------------------------------
# the op through nd and sym
# ----------------------------------------------------------------------
@pytest.mark.parametrize("act", ["relu", "gelu", "tanh"])
def test_op_through_nd_matches_mxtpu(act):
    arrays = _arrays(40, 24, 6, 10, 3)
    x3 = arrays[0].reshape(2, 12, 6)
    outs = []
    for nd, ag, arr in ((jnd, jag, jnd.array),
                        (tnd, tag, lambda v: tnd.array(v, ctx=CPU))):
        ins = [arr(v) for v in (x3,) + arrays[1:]]
        for a in ins:
            a.attach_grad()
        with ag.record():
            y, aux = nd._contrib_MoEFFN(*ins, capacity_factor=1.5,
                                        activation=act)
            loss = (y * y).sum() + 0.5 * aux
        loss.backward()
        alias = nd.MoEFFN(*ins, capacity_factor=1.5, activation=act)
        outs.append((y.asnumpy(), float(aux.asscalar()),
                     [a.grad.asnumpy() for a in ins], alias[0].asnumpy()))
    (jy, ja, jgs, jal), (ty, ta, tgs, tal) = outs
    assert ty.shape == (2, 12, 6)
    _close(ty, jy, TOL_F32, "y")
    np.testing.assert_array_equal(tal, ty)
    _close(ta, ja, TOL_F32, "aux")
    for g, w in zip(tgs, jgs):
        _close(g, w, TOL_F32, "grad")


def test_op_symbol_json_and_infer_shape_match_mxtpu():
    shapes = dict(data=(2, 8, 6), gw=(6, 3), w1=(3, 6, 10), b1=(3, 10),
                  w2=(3, 10, 6), b2=(3, 6))
    got = []
    for S in (jsym, tsym):
        with fresh_names(symbols=True):
            v = [S.var(n) for n in shapes]
            a = S.MoEFFN(*v, capacity_factor=1.5, activation="gelu",
                         name="moe")
            b = S._contrib_MoEFFN(*v)
        got.append((a.tojson(), b.tojson(), a.list_outputs(),
                    a.infer_shape(**shapes),
                    a.infer_shape_partial(data=(2, 8, 6))))
    assert got[0] == got[1]
    assert got[1][3][1] == [(2, 8, 6), ()]


def test_op_symbol_eval_matches_nd():
    arrays = _arrays(41, 16, 6, 8, 2)
    v = [tsym.var(n) for n in ("data", "gw", "w1", "b1", "w2", "b2")]
    out = tsym.MoEFFN(*v)
    got = out.eval(**{n: tnd.array(a, ctx=CPU) for n, a in
                      zip(("data", "gw", "w1", "b1", "w2", "b2"), arrays)})
    want = tnd.MoEFFN(*[tnd.array(a, ctx=CPU) for a in arrays])
    np.testing.assert_array_equal(got[0].asnumpy(), want[0].asnumpy())
    assert got[1].shape == ()


# ----------------------------------------------------------------------
# gluon.contrib.nn
# ----------------------------------------------------------------------
def _moedense_pair(act="relu"):
    with fresh_names():
        jl = jcontrib.nn.MoEDense(units=6, hidden=12, num_experts=4,
                                  activation=act)
        tl = tcontrib.nn.MoEDense(units=6, hidden=12, num_experts=4,
                                  activation=act)
    return jl, tl


def test_moedense_deferred_init_and_one_sgd_step_match_mxtpu():
    rng = np.random.RandomState(5)
    X = rng.randn(32, 6).astype(np.float32)
    Yt = rng.randn(32, 6).astype(np.float32)
    jl, tl = _moedense_pair()
    assert tl.gate_weight.shape == (0, 4)
    jl.initialize(init="xavier")
    tl.initialize(init="xavier", ctx=CPU)
    jl(jnd.array(X))
    tl(tnd.array(X, ctx=CPU))            # deferred in_units settled
    assert tl.gate_weight.shape == (6, 4) and \
        tl.expert_w1.shape == (4, 6, 12)
    assert list(tl.collect_params().keys()) == \
        list(jl.collect_params().keys())
    params_from_mxtpu({n: p.data().asnumpy() for n, p in
                       jl.collect_params().items()}, tl)
    jtr = JTrainer(jl.collect_params(), "sgd", {"learning_rate": 0.1})
    ttr = TTrainer(tl.collect_params(), "sgd", {"learning_rate": 0.1})
    losses = []
    for nd, ag, layer, tr, arr in (
            (jnd, jag, jl, jtr, jnd.array),
            (tnd, tag, tl, ttr, lambda v: tnd.array(v, ctx=CPU))):
        with ag.record():
            y, aux = layer(arr(X))
            loss = nd.mean(nd.square(y - arr(Yt))) + 0.01 * aux
        loss.backward()
        tr.step(1)
        losses.append(float(loss.asscalar()))
    _close(losses[1], losses[0], TOL_F32, "loss")
    for n, p in tl.collect_params().items():
        _close(p.data().asnumpy(), jl.collect_params()[n].data().asnumpy(),
               TOL_F32, n)
    assert np.abs(tl.gate_weight.grad().asnumpy()).sum() > 0
    assert "MoEDense(4 experts, hidden=12 -> 6, relu)" == repr(tl)


def test_moedense_params_cross_and_export_json(tmp_path):
    X = np.random.RandomState(6).randn(10, 6).astype(np.float32)
    jl, tl = _moedense_pair("tanh")
    jl.initialize(init="xavier")
    jl(jnd.array(X))
    jl.save_parameters(str(tmp_path / "moe.params"))
    tl.load_parameters(str(tmp_path / "moe.params"), ctx=CPU)
    jy, ja = jl(jnd.array(X))
    ty, ta = tl(tnd.array(X, ctx=CPU))
    _close(ty.asnumpy(), jy.asnumpy(), TOL_F32, "y")
    _close(float(ta.asscalar()), float(ja.asscalar()), TOL_F32, "aux")
    jl.hybridize()
    tl.hybridize()
    jl(jnd.array(X))
    with fresh_names(symbols=True):
        jpath = jl.export(str(tmp_path / "j"))
    with fresh_names(symbols=True):
        tpath = tl.export(str(tmp_path / "t"))
    jjson = open(jpath[0] if isinstance(jpath, tuple) else
                 str(tmp_path / "j-symbol.json")).read()
    tjson = open(tpath[0] if isinstance(tpath, tuple) else
                 str(tmp_path / "t-symbol.json")).read()
    assert tjson == jjson


@pytest.mark.parametrize("kind", ["Concurrent", "HybridConcurrent"])
@pytest.mark.parametrize("axis", [-1, 1])
def test_concurrent_blocks_match_mxtpu(kind, axis):
    X = np.random.RandomState(7).randn(4, 5).astype(np.float32)
    nets = []
    for nn, contrib in ((jnn, jcontrib), (tnn, tcontrib)):
        with fresh_names():
            net = getattr(contrib.nn, kind)(axis=axis)
            net.add(nn.Dense(3), nn.Dense(2), contrib.nn.Identity())
        nets.append(net)
    jnet, tnet = nets
    jnet.initialize(init="xavier")
    tnet.initialize(ctx=CPU)
    jy = jnet(jnd.array(X))
    tnet(tnd.array(X, ctx=CPU))
    params_from_mxtpu({n: p.data().asnumpy() for n, p in
                       jnet.collect_params().items()}, tnet)
    ty = tnet(tnd.array(X, ctx=CPU))
    assert ty.shape == (4, 10)
    _close(ty.asnumpy(), jy.asnumpy(), TOL_F32, kind)


def test_identity_and_hybrid_concurrent_symbol():
    ident = tcontrib.nn.Identity()
    x = torch.randn(3, 4)
    assert ident(x) is x
    with fresh_names(symbols=True):
        net = tcontrib.nn.HybridConcurrent(axis=1)
        net.add(tcontrib.nn.Identity(), tcontrib.nn.Identity())
        out = net(tsym.var("data"))
    assert out.infer_shape(data=(2, 3))[1] == [(2, 6)]


# ----------------------------------------------------------------------
# plan_zero_buckets
# ----------------------------------------------------------------------
def _bert_large_sigs():
    """BERT-Large's 295 trainable signatures (bench_bert_zero's model,
    T 128) without allocating it: the port's deferred shapes filled from
    the configuration (every deferred input width is the model width,
    the FFN's second Dense's is the hidden width)."""
    from mxtpu_torch.models.transformer import PositionwiseFFN, bert_large
    with fresh_names():
        net = bert_large(vocab_size=30522, max_length=128, dropout=0.1)
    hidden = {id(m.ffn2.weight) for m in net.modules()
              if isinstance(m, PositionwiseFFN)}
    sigs = []
    for p in net.collect_params().values():
        width = 4096 if id(p) in hidden else 1024
        sigs.append((tuple(width if s == 0 else s for s in p.shape),
                     "float32"))
    return sigs


def _plans_equal(sigs, dp, **kw):
    got, want = tpar.plan_zero_buckets(sigs, dp, **kw), \
        jpar.plan_zero_buckets(sigs, dp, **kw)
    assert got == want
    return got


@pytest.mark.parametrize("stack_axis_only", [False, True])
def test_plan_zero_buckets_bert_large_matches_mxtpu(stack_axis_only):
    sigs = _bert_large_sigs()
    assert len(sigs) == 295
    # embeddings (word, position 128, type) and their LayerNorm, 24
    # layers of qkv, proj (no bias), ffn1, ffn2 (no bias) and two fused
    # epilogues (bias, gamma, beta), the untied 30522-way MLM head
    n = sum(int(np.prod(s)) for s, _ in sigs)
    layer = 4096 * 1024 * 3 + 3072 + 4096 + 6 * 1024
    assert n == (30522 + 128 + 2 + 2) * 1024 + 24 * layer + \
        30522 * 1025, n
    plan = _plans_equal(sigs, 8, stack_axis_only=stack_axis_only)
    total = sum(b["param_bytes"] for b in plan)
    per_dev = sum(b["padded_bytes"] // 8 for b in plan)
    assert total == 4 * n
    if not stack_axis_only:
        assert per_dev <= total / 8 * 1.15


@pytest.mark.parametrize("dp", [1, 3, 8])
def test_plan_zero_buckets_zero_cases_match_mxtpu(dp):
    # tests/test_zero.py's geometry signatures and a bf16 twin
    sigs = ([((30522, 1024), "float32")] * 2
            + [((1024, 1024), "float32")] * 96
            + [((4096, 1024), "float32")] * 24
            + [((1024, 4096), "float32")] * 24
            + [((1024,), "float32")] * 146)
    buckets = _plans_equal(sigs, dp)
    emb = {b["shape"]: b for b in buckets}[(30522, 1024)]
    assert emb["pad"] == 0
    if dp == 8:
        assert emb["axis"] != 0
    for b in _plans_equal(sigs, dp, stack_axis_only=True):
        assert b["axis"] == 0
    bf16 = [((16, 16), "bfloat16"), ((16,), "bfloat16"), ((4, 16),
                                                          "float32")] * 3
    assert [b["param_bytes"] for b in _plans_equal(bf16, dp)] == \
        [3 * 512, 3 * 32, 3 * 256]


def test_plan_zero_buckets_needs_dp():
    with pytest.raises(MXNetError, match="dp >= 1"):
        tpar.plan_zero_buckets([((2,), "float32")], 0)
    assert tpar.moe is tmoe and "plan_zero_buckets" in tpar.__all__
