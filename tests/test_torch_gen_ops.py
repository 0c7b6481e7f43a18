"""The incremental decode's ops in the port against mxtpu's: ``_arange``
(``mxtpu/ndarray/ops_extra.py:54-68``), ``kv_cache_write`` and
``cached_attention`` (``mxtpu/ndarray/rnn_impl.py:212-266``), on the
same seeded numpy inputs at 1e-6 in f32, and their registry entries
(parameter names, defaults, input counts, differentiability, aliases)
against mxtpu's ``list_ops()`` specs.
"""
import numpy as np
import pytest
import torch

from mxtpu import nd as jnd
from mxtpu.ops import registry as jreg

import mxtpu_torch as tmx
from mxtpu_torch import nd
from mxtpu_torch.ops import registry as treg

CPU = tmx.cpu()
TOL = 1e-6
B, H, L, D = 3, 2, 8, 4


def _pair(a):
    return jnd.array(a), nd.array(a, ctx=CPU)


def _close(j, t):
    np.testing.assert_allclose(t.asnumpy().astype(np.float32),
                               j.asnumpy().astype(np.float32),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("T, steps", [
    (1, [0.0, 3.0, 7.0]),            # one token at each lane's frontier
    (3, [0.7, 4.9, 6.2]),            # fractional steps truncate; the
                                     # last two clamp to L - T = 5
    (3, [-2.0, 5.0, 9.0]),           # below 0 and past L
    (8, [0.0, 1.0, 2.0]),            # T == L: every start clamps to 0
])
def test_kv_cache_write_matches_mxtpu(T, steps):
    rng = np.random.RandomState(T)
    cache = rng.randn(B, H, L, D).astype(np.float32)
    new = rng.randn(B, H, T, D).astype(np.float32)
    step = np.array(steps, np.float32)
    (jc, tc), (jn, tn), (js, ts) = _pair(cache), _pair(new), _pair(step)
    _close(jnd.kv_cache_write(jc, jn, js), nd.kv_cache_write(tc, tn, ts))


def test_kv_cache_write_casts_f32_values_into_a_bf16_cache():
    rng = np.random.RandomState(1)
    cache = rng.randn(B, H, L, D).astype(np.float32)
    new = rng.randn(B, H, 2, D).astype(np.float32)
    step = np.array([1.0, 6.5, 3.0], np.float32)
    (jc, tc), (jn, tn), (js, ts) = _pair(cache), _pair(new), _pair(step)
    jout = jnd.kv_cache_write(jc.astype("bfloat16"), jn, js)
    tout = nd.kv_cache_write(tc.astype("bfloat16"), tn, ts)
    assert tout.dtype == torch.bfloat16
    assert str(jout.dtype) == "bfloat16"
    # the same bf16 values, bit for bit
    np.testing.assert_array_equal(tout.asnumpy().astype(np.float32),
                                  jout.asnumpy().astype(np.float32))


def test_kv_cache_write_leaves_its_input_intact():
    cache = np.zeros((B, H, L, D), np.float32)
    tc = nd.array(cache, ctx=CPU)
    nd.kv_cache_write(tc, nd.array(np.ones((B, H, 2, D), np.float32),
                                   ctx=CPU),
                      nd.array(np.zeros(B, np.float32), ctx=CPU))
    assert not tc.asnumpy().any()


@pytest.mark.parametrize("T, sm_scale", [(1, -1.0), (3, -1.0), (3, 0.3),
                                         (5, 0.125)])
def test_cached_attention_matches_mxtpu(T, sm_scale):
    rng = np.random.RandomState(10 + T)
    q = rng.randn(B, H, T, D).astype(np.float32)
    k = rng.randn(B, H, L, D).astype(np.float32)
    v = rng.randn(B, H, L, D).astype(np.float32)
    # stale values beyond each lane's frontier: large, so a read of any
    # of them would show
    step = np.array([0.0, 2.5, L - T], np.float32)
    for b, s in enumerate(step.astype(np.int32)):
        k[b, :, s + T:] = 1e3
        v[b, :, s + T:] = -1e3
    ins = [_pair(a) for a in (q, k, v, step)]
    jout = jnd.cached_attention(*[j for j, _ in ins], sm_scale=sm_scale)
    tout = nd.cached_attention(*[t for _, t in ins], sm_scale=sm_scale)
    _close(jout, tout)
    assert np.abs(tout.asnumpy()).max() < 100.0   # no stale value read


def test_cached_attention_keeps_q_type_and_accumulates_in_f32():
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(B, H, n, D).astype(np.float32)
               for n in (2, L, L))
    step = np.array([1.0, 4.0, 6.0], np.float32)
    ins = [_pair(a) for a in (q, k, v, step)]
    jout = jnd.cached_attention(ins[0][0].astype("bfloat16"),
                                ins[1][0].astype("bfloat16"),
                                ins[2][0].astype("bfloat16"), ins[3][0])
    tout = nd.cached_attention(ins[0][1].astype("bfloat16"),
                               ins[1][1].astype("bfloat16"),
                               ins[2][1].astype("bfloat16"), ins[3][1])
    assert tout.dtype == torch.bfloat16
    # f32 sums in another order may round to the neighbouring bf16
    np.testing.assert_allclose(tout.asnumpy().astype(np.float32),
                               jout.asnumpy().astype(np.float32),
                               rtol=2 ** -8, atol=2 ** -8)


@pytest.mark.parametrize("kw", [
    dict(start=0, stop=16),
    dict(start=5),                   # stop None counts from 0
    dict(start=1.5, stop=4.0, step=0.5, repeat=2),
    dict(start=0.1, stop=1.0, step=0.1),
    dict(start=2, stop=11, step=3, repeat=3, infer_range=True),
    dict(start=0, stop=6, dtype="int32"),
])
def test_arange_matches_mxtpu(kw):
    j = jnd._arange(**kw)
    t = nd._arange(**kw, ctx=CPU)
    assert str(t.dtype).split(".")[-1] == str(j.dtype)
    _close(j, t)


def test_arange_in_a_graph_creates_on_the_bindings_device():
    from mxtpu_torch import sym
    from mxtpu_torch.symbol import _eval_symbol
    x = sym.var("x")
    g = sym.broadcast_add(sym._arange(start=0, stop=4), x)
    (out,) = _eval_symbol(g, {"x": nd.array(np.ones(4, np.float32),
                                            ctx=CPU)})
    np.testing.assert_array_equal(out.asnumpy(), [1, 2, 3, 4])
    assert g.infer_shape(x=(4,))[1] == [(4,)]


@pytest.mark.parametrize("name, shapes, kw, want", [
    ("kv_cache_write", [(B, H, L, D), (B, H, 3, D), (B,)], {},
     (B, H, L, D)),
    ("cached_attention", [(B, H, 3, D), (B, H, L, D), (B, H, L, D), (B,)],
     {"sm_scale": 0.5}, (B, H, 3, D)),
    ("_arange", [], {"start": 2, "stop": 8, "repeat": 2}, (12,)),
])
def test_shape_inference_matches_mxtpu(name, shapes, kw, want):
    import jax
    assert treg.get_op(name).infer(*shapes, **kw) == [want]
    avals = [jax.ShapeDtypeStruct(s, np.float32) for s in shapes]
    assert tuple(jreg.get_op(name).infer(*avals, **kw).shape) == want


def _spec(reg, name):
    op = reg.get_op(name)
    return {"params": [(p.name, p.dtype, p.default)
                       for p in op.params],
            "num_inputs": op.num_inputs, "num_outputs": op.num_outputs,
            "differentiable": op.differentiable,
            "aliases": tuple(op.aliases)}


@pytest.mark.parametrize("name", ["_arange", "kv_cache_write",
                                  "cached_attention"])
def test_registry_entry_matches_mxtpu(name):
    assert name in treg.list_ops()
    assert _spec(treg, name) == _spec(jreg, name)
