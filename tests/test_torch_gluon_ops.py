"""The 16 registry ops that gluon's layers, losses and BERT call, held
against mxtpu's on the CPU, forward and backward, in f32 and bf16:
``Embedding``, ``slice_axis``, ``slice_like``, ``take``, ``pick``,
``where``, ``reshape_like``, ``pad``, ``LeakyReLU`` (every act_type),
``LayerNorm``, ``InstanceNorm``, ``BatchNormRelu``, ``BatchNormAddRelu``,
``Dropout``, ``FusedResidualLayerNorm`` and ``flash_attention``.

The same seeded numpy inputs go through each package's registered rule
(mxtpu's kernels as its own tests run them on the CPU), and one seeded
cotangent through ``jax.vjp`` and ``torch.autograd.grad``.  Tolerances,
relative to the largest magnitude of mxtpu's result: f32 1e-6 for the
glue ops (the same arithmetic), 2e-5 for the normalizations and
attention (sums in another order); bf16 2^-6 (two bf16 ulps: each
framework rounds to bf16 at its own places), 2^-4 where a case says
why.  ``Dropout`` is held at
p = 0 and by its keep rate (jax's PRNG has no torch match), and the
fused epilogue's threefry mask bit for bit for the same key data.
Also here: the op names and parameters ``sym`` writes, and ``nd``'s
Dropout/FusedResidualLayerNorm, which draw their key.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxtpu import nd as jnd
from mxtpu.ops.registry import get_op as jget_op

import mxtpu_torch as tmx
from mxtpu_torch import autograd, random as trandom
from mxtpu_torch.ops import get_op as tget_op, list_ops

torch.set_num_threads(2)

CPU = tmx.cpu()
BF16 = 2.0 ** -6
GLUE, NORM = 1e-6, 2e-5

NEW_OPS = ("Embedding", "slice_axis", "slice_like", "take", "pick",
           "where", "reshape_like", "pad", "LeakyReLU", "LayerNorm",
           "InstanceNorm", "BatchNormRelu", "BatchNormAddRelu", "Dropout",
           "FusedResidualLayerNorm", "flash_attention")


def _rng(seed=0):
    return np.random.RandomState(seed)


def _ids(shape, n, seed=1, lo=0):
    return _rng(seed).randint(lo, n, shape).astype(np.float32)


# (op, inputs [(array, float data?)], kwargs, differentiable inputs, tol)
def _cases():
    r = _rng(0)
    x3 = r.randn(4, 6, 5).astype(np.float32)
    img = r.randn(4, 3, 5, 5).astype(np.float32)
    img_l = np.ascontiguousarray(img.transpose(0, 2, 3, 1))
    g3 = (1 + 0.1 * r.randn(3)).astype(np.float32)
    b3 = (0.1 * r.randn(3)).astype(np.float32)
    m3 = (0.1 * r.randn(3)).astype(np.float32)
    v3 = (1 + 0.1 * np.abs(r.randn(3))).astype(np.float32)
    ln_x = r.randn(4, 8, 32).astype(np.float32)
    ln_g = (1 + 0.1 * r.randn(32)).astype(np.float32)
    ln_b = (0.1 * r.randn(32)).astype(np.float32)
    qkv = [r.randn(2, 2, 16, 8).astype(np.float32) for _ in range(3)]
    return [
        ("Embedding", [(_ids((2, 5), 11), False),
                       (r.randn(11, 6).astype(np.float32), True)],
         dict(input_dim=11, output_dim=6), [1], GLUE),
        ("slice_axis", [(x3, True)], dict(axis=1, begin=1, end=4), [0],
         GLUE),
        ("slice_axis", [(x3, True)], dict(axis=-1, begin=-3, end=None),
         [0], GLUE),
        ("slice_like", [(x3, True), (np.zeros((4, 3, 2), np.float32),
                                     False)],
         dict(axes=(1, 2)), [0], GLUE),
        ("slice_like", [(x3, True), (np.zeros((2, 3, 5), np.float32),
                                     False)], {}, [0], GLUE),
        ("take", [(r.randn(7, 4).astype(np.float32), True),
                  (np.array([[0, 9, 3], [-2, 6, 6]], np.float32), False)],
         dict(axis=0, mode="clip"), [0], GLUE),
        ("take", [(r.randn(3, 7).astype(np.float32), True),
                  (np.array([0, 9, -2, 6], np.float32), False)],
         dict(axis=1, mode="wrap"), [0], GLUE),
        ("pick", [(r.randn(4, 5).astype(np.float32), True),
                  (np.array([0, 4, 7, -1], np.float32), False)],
         dict(axis=-1), [0], GLUE),
        ("pick", [(x3, True), (_ids((4, 5), 6), False)],
         dict(axis=1, keepdims=True), [0], GLUE),
        ("where", [((r.rand(3, 4) > 0.5).astype(np.float32), False),
                   (r.randn(3, 4).astype(np.float32), True),
                   (r.randn(3, 4).astype(np.float32), True)], {}, [1, 2],
         GLUE),
        ("reshape_like", [(r.randn(2, 6).astype(np.float32), True),
                          (np.zeros((3, 4), np.float32), False)], {}, [0],
         GLUE),
        *[("pad", [(img, True)],
           dict(mode=m, pad_width=(0, 0, 0, 0, 1, 2, 2, 1),
                constant_value=0.5), [0], GLUE)
          for m in ("constant", "edge", "reflect")],
        *[("LeakyReLU", [(x3, True)], dict(act_type=a, slope=0.3), [0],
           NORM if a in ("elu", "selu", "gelu") else GLUE)
          for a in ("leaky", "elu", "selu", "gelu", "rrelu")],
        ("LeakyReLU", [(img, True), (np.array([0.1, 0.2, 0.3],
                                              np.float32), True)],
         dict(act_type="prelu"), [0, 1], GLUE),
        ("LayerNorm", [(ln_x, True), (ln_g, True), (ln_b, True)],
         dict(axis=-1, eps=1e-5), [0, 1, 2], NORM),
        ("LayerNorm", [(x3, True),
                       ((1 + 0.1 * r.randn(6)).astype(np.float32), True),
                       ((0.1 * r.randn(6)).astype(np.float32), True)],
         dict(axis=1, eps=1e-5), [0, 1, 2], NORM),
        # its composite runs in bf16 on both sides: gamma's gradient
        # sums 100 bf16 products of both signs, rounded at other places
        # (measured 4.7 % apart): 2^-4 in bf16
        ("InstanceNorm", [(img, True), (g3, True), (b3, True)],
         dict(eps=1e-3), [0, 1, 2], NORM, 2.0 ** -4),
        ("BatchNormRelu", [(img, True), (g3, True), (b3, True), (m3, False),
                           (v3, False)],
         dict(fix_gamma=False, axis=1), [0, 1, 2], NORM),
        ("BatchNormRelu", [(img_l, True), (g3, True), (b3, True),
                           (m3, False), (v3, False)],
         dict(fix_gamma=False, axis=3), [0, 1, 2], NORM),
        ("BatchNormRelu", [(img, True), (g3, True), (b3, True), (m3, False),
                           (v3, False)],
         dict(fix_gamma=False, use_global_stats=True), [0, 1, 2], NORM),
        ("BatchNormAddRelu", [(img, True), (r.randn(*img.shape).astype(
            np.float32), True), (g3, True), (b3, True), (m3, False),
            (v3, False)], dict(fix_gamma=False, axis=1), [0, 1, 2, 3],
         NORM),
        ("flash_attention", [(a, True) for a in qkv], dict(causal=False),
         [0, 1, 2], NORM),
        ("flash_attention", [(a, True) for a in qkv],
         dict(causal=True, sm_scale=0.3), [0, 1, 2], NORM),
    ]


CASES = _cases()


IDS = [f"{c[0]}-{c[2].get('act_type') or c[2].get('mode') or i}"
       for i, c in enumerate(CASES)]


def _first(out):
    return out[0] if isinstance(out, (tuple, list)) else out


def _j_run(name, arrays, kw, diff, cot):
    op = jget_op(name)
    resolved = op.resolve_params(kw)
    xs = [jnp.asarray(a) for a in arrays]

    def f(*d):
        full = list(xs)
        for i, v in zip(diff, d):
            full[i] = v
        return _first(op.fn(*full, **resolved))
    out, vjp = jax.vjp(f, *[xs[i] for i in diff])
    grads = vjp(jnp.asarray(cot).astype(out.dtype))
    return (np.asarray(out.astype(jnp.float32)),
            [np.asarray(g.astype(jnp.float32)) for g in grads])


def _t_run(name, arrays, kw, diff, cot):
    op = tget_op(name)
    ts = [torch.tensor(np.asarray(a)) if not isinstance(a, torch.Tensor)
          else a for a in arrays]
    for i in diff:
        ts[i].requires_grad_(True)
    out = _first(op.fn(*ts, **op.resolve_params(kw)))
    grads = torch.autograd.grad(out, [ts[i] for i in diff],
                                torch.tensor(cot).to(out.dtype))
    return (out.detach().float().numpy(),
            [g.float().numpy() for g in grads])


def _close(got, want, tol):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_op_forward_and_backward_match_mxtpu(case, dtype):
    name, inputs, kw, diff, tol = case[:5]
    jin, tin = [], []
    for a, is_data in inputs:
        if is_data and dtype == "bfloat16":
            jin.append(jnp.asarray(a).astype(jnp.bfloat16))
            tin.append(torch.tensor(a).bfloat16())
        else:
            jin.append(a)
            tin.append(torch.tensor(a))
    # the cotangent in the output's shape (the port's forward, which the
    # assertions below hold to mxtpu's shape)
    top = tget_op(name)
    with torch.no_grad():
        shape = tuple(_first(top.fn(*tin, **top.resolve_params(kw))).shape)
    cot = _rng(7).randn(*shape).astype(np.float32)
    if dtype == "bfloat16":
        cot = np.asarray(jnp.asarray(cot).astype(jnp.bfloat16)
                         .astype(jnp.float32))
    jout, jgrads = _j_run(name, jin, kw, diff, cot)
    tout, tgrads = _t_run(name, tin, kw, diff, cot)
    t = (case[5] if len(case) > 5 else BF16) if dtype == "bfloat16" \
        else tol
    assert tout.shape == jout.shape
    _close(tout, jout, t)
    for i, (g, jg) in zip(diff, zip(tgrads, jgrads)):
        assert g.shape == jg.shape, i
        _close(g, jg, t)


def test_the_ops_are_registered_under_mxtpus_names():
    """The 16 names and the parameters of each are mxtpu's."""
    names = set(list_ops())
    assert set(NEW_OPS) <= names
    for n in NEW_OPS:
        assert list(tget_op(n).params.params) == \
            list(jget_op(n).params.params), n
        assert tget_op(n).num_inputs == jget_op(n).num_inputs, n


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_identity_at_p0_and_keep_rate(dtype):
    """p = 0 and a mode other than "training" are the identity in both
    packages; at p = 0.3 the port keeps 70 % of 10^5 elements (within 5
    standard errors), each scaled by 1 / 0.7, as mxtpu's mask does."""
    td = getattr(torch, dtype)
    x = torch.tensor(_rng(3).randn(100, 1000).astype(np.float32)).to(td)
    op = tget_op("Dropout")
    key = torch.zeros(2, dtype=torch.int64)
    for kw in (dict(p=0.0), dict(p=0.3, mode="always")):
        assert torch.equal(op(x, key, **kw), x)
        jx = jnp.asarray(x.float().numpy()).astype(dtype)
        jy = jget_op("Dropout")(jx, jnp.zeros((2,), jnp.uint32), **kw)
        np.testing.assert_array_equal(np.asarray(jy.astype(jnp.float32)),
                                      x.float().numpy())
    trandom.seed(4)
    y = op(x, key, p=0.3)
    kept = y != 0
    n = x.numel()
    rate = kept.float().mean().item()
    assert abs(rate - 0.7) <= 5 * np.sqrt(0.21 / n)
    want = (x.float() / 0.7).to(td)
    assert torch.equal(y[kept], want[kept])
    jy = np.asarray(jget_op("Dropout")(
        jnp.asarray(x.float().numpy()), jnp.array([0, 4], jnp.uint32),
        p=0.3))
    assert abs((jy != 0).mean() - 0.7) <= 5 * np.sqrt(0.21 / n)
    # axes: one draw per broadcast slice
    y = op(x, key, p=0.5, axes=(1,))
    assert ((y != 0).all(dim=1) | (y == 0).all(dim=1)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_epilogue_mask_is_mxtpus_bit_for_bit(dtype):
    """``FusedResidualLayerNorm`` with key data (k0, k1) and p = 0.25
    drops exactly the elements mxtpu drops: dh is 0 at the same places,
    and the outputs and gradients agree as ``_close`` states."""
    r = _rng(5)
    h, res = (r.randn(6, 40).astype(np.float32) for _ in range(2))
    bias = (0.1 * r.randn(40)).astype(np.float32)
    g = (1 + 0.1 * r.randn(40)).astype(np.float32)
    b = (0.1 * r.randn(40)).astype(np.float32)
    key = np.array([0x1234ABCD, 0x0BADF00D], np.uint32)
    kw = dict(p=0.25, eps=1e-5)
    cot = r.randn(6, 40).astype(np.float32)
    jt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jin = [jnp.asarray(a).astype(jt) for a in (h, bias, res, g, b)] + \
        [jnp.asarray(key)]
    tt = getattr(torch, dtype)
    tin = [torch.tensor(a).to(tt) for a in (h, bias, res, g, b)] + \
        [torch.tensor(key.astype(np.int64))]
    jout, jg = _j_run("FusedResidualLayerNorm", jin, kw, [0, 2], cot)
    tout, tg = _t_run("FusedResidualLayerNorm", tin, kw, [0, 2], cot)
    np.testing.assert_array_equal(tg[0] == 0, jg[0] == 0)
    assert 0.15 < (jg[0] == 0).mean() < 0.35
    t = BF16 if dtype == "bfloat16" else NORM
    _close(tout, jout, t)
    for a, c in zip(tg, jg):
        _close(a, c, t)


def test_nd_conveniences_draw_the_key_and_follow_training_mode():
    """``nd.Dropout`` and ``nd.FusedResidualLayerNorm`` read the mode
    from ``autograd.is_training()`` (as mxtpu's do) and draw their key
    from the seeded streams: the same seed, the same mask."""
    x = tmx.nd.array(_rng(6).randn(64, 64).astype(np.float32), ctx=CPU)
    assert tmx.nd.Dropout(x, p=0.5) is x
    with autograd.train_mode():
        trandom.seed(2)
        a = tmx.nd.Dropout(x, p=0.5).asnumpy()
        trandom.seed(2)
        b = tmx.nd.Dropout(x, p=0.5).asnumpy()
    np.testing.assert_array_equal(a, b)
    assert 0.4 < (a == 0).mean() < 0.6
    ones = tmx.nd.array(np.ones(64, np.float32), ctx=CPU)
    zeros = tmx.nd.array(np.zeros(64, np.float32), ctx=CPU)
    off = tmx.nd.FusedResidualLayerNorm(x, zeros, x, ones, zeros, p=0.5)
    with autograd.train_mode():
        on = tmx.nd.FusedResidualLayerNorm(x, zeros, x, ones, zeros,
                                           p=0.5)
    assert not np.array_equal(on.asnumpy(), off.asnumpy())
    want = tget_op("LayerNorm")(x._data + x._data, ones._data, zeros._data)
    np.testing.assert_allclose(off.asnumpy(), want.numpy(), atol=1e-5)


def test_symbol_writes_the_ops_as_mxtpu_does(monkeypatch):
    """A graph of the gluon ops (the key inputs omitted, as mxtpu's sym
    omits them) serializes to mxtpu's JSON byte for byte and evaluates
    as the eager ops do, in predict mode."""
    import mxtpu.symbol as jsym
    import mxtpu_torch.symbol as tsym
    monkeypatch.setattr(jsym, "_NAME_COUNTERS", {})
    monkeypatch.setattr(tsym, "_NAME_COUNTERS", {})

    def graph(S):
        x, g, b = S.var("x"), S.var("g"), S.var("b")
        y = S.LayerNorm(x, g, b, axis=-1, eps=1e-5)
        y = S.Dropout(y, p=0.1, axes=())
        y = S.FusedResidualLayerNorm(y, b, x, g, b, p=0.1, eps=1e-5)
        y = S.slice_axis(y, axis=-1, begin=0, end=4)
        y = S.LeakyReLU(y, act_type="gelu")
        return S.slice_like(y, S.var("like"), axes=(1,))
    jg, tg = graph(jsym), graph(tsym)
    assert tg.tojson() == jg.tojson()
    r = _rng(8)
    vals = {"x": r.randn(2, 5, 8).astype(np.float32),
            "g": np.ones(8, np.float32), "b": np.zeros(8, np.float32),
            "like": np.zeros((2, 3), np.float32)}
    (out,) = tsym._eval_symbol(tg, {k: tmx.nd.array(v, ctx=CPU)
                                    for k, v in vals.items()})
    (jout,) = jsym._eval_symbol(jg, {k: jnd.array(v)
                                     for k, v in vals.items()})
    np.testing.assert_allclose(out.asnumpy(), jout.asnumpy(), atol=NORM)
