"""Where the port once parted from mxtpu, held against it on the CPU
(ROADMAP queue 3): ``Pooling`` (a global "sum" is mxtpu's mean; a
windowed "sum" is the plain zero-padded window sum whatever
``count_include_pad`` says;
"lp" is sqrt of the windowed sum of squares; a pad above half the
window pads and reduces) and ``SoftmaxOutput``'s gradient with
``use_ignore`` and labels outside [0, C) (the ignored row is zero, not
an error); then the eager ``Updater``'s f32 masters for bf16 weights,
``cast``, the reductions' axes, ``argmax`` keepdims, ties, ``abs`` and
``sign`` at 0 and NaN, integer inputs, backward from heads without a
gradient path, the power ops' gradients at 0, ``squeeze``, bf16 3-D
pooling, and the optimizers' constructor arguments, multiplier lookup
and ``set_wd_mult`` default (items 18 and 19), one parametrised test
each.

The same numpy inputs (seed 0) go to both packages; outputs and
gradients agree to 1e-6 (f32, the same sums in another order) and
integers bit for bit; the bf16 cases state their bounds.
"""
import pickle

import numpy as np
import pytest
import torch

import mxtpu as jmx

import mxtpu_torch as tmx
from mxtpu_torch import autograd

torch.set_num_threads(2)

CPU = tmx.cpu()
TOL = 1e-6

# (shape, Pooling kwargs): (a) global sum, (b) windowed sum with and
# without count_include_pad, (c) lp, (d) pads above half the window,
# plus the cases that were right before, kept right
POOL_CASES = [
    ((2, 3, 6, 6), dict(kernel=(2, 2), pool_type="sum", global_pool=True)),
    ((2, 3, 6, 6), dict(kernel=(2, 2), pool_type="lp", global_pool=True)),
    ((2, 3, 6, 6), dict(kernel=(3, 3), pool_type="sum", stride=(1, 1),
                        pad=(1, 1), count_include_pad=False)),
    ((2, 3, 6, 6), dict(kernel=(3, 3), pool_type="sum", stride=(2, 2),
                        pad=(1, 1), count_include_pad=True)),
    ((2, 3, 6), dict(kernel=(3,), pool_type="sum", stride=(1,), pad=(1,),
                     count_include_pad=False)),
    ((2, 3, 6, 6), dict(kernel=(2, 2), pool_type="lp", stride=(2, 2))),
    ((2, 3, 6, 6), dict(kernel=(3, 3), pool_type="lp", stride=(1, 1),
                        pad=(1, 1))),
    ((2, 3, 6, 6), dict(kernel=(3, 3), pool_type="max", stride=(1, 1),
                        pad=(2, 2))),
    ((2, 3, 6, 6), dict(kernel=(3, 3), pool_type="avg", stride=(1, 1),
                        pad=(2, 2), count_include_pad=True)),
    ((2, 3, 6, 6), dict(kernel=(3, 3), pool_type="avg", stride=(2, 2),
                        pad=(2, 2), count_include_pad=False)),
    ((2, 3, 6, 6), dict(kernel=(3, 3), pool_type="sum", stride=(1, 1),
                        pad=(2, 2))),
    ((2, 3, 6, 6), dict(kernel=(3, 3), pool_type="lp", stride=(2, 2),
                        pad=(2, 2))),
    ((2, 6, 6, 3), dict(kernel=(3, 3), pool_type="sum", stride=(1, 1),
                        pad=(2, 2), layout="NHWC")),
    ((2, 3, 6, 6), dict(kernel=(3, 3), pool_type="avg", stride=(1, 1),
                        pad=(1, 1), count_include_pad=False)),
    ((2, 3, 6, 6), dict(kernel=(2, 2), pool_type="avg", global_pool=True)),
    ((2, 3, 6, 6), dict(kernel=(3, 3), pool_type="max", stride=(2, 2),
                        pad=(1, 1))),
]


@pytest.mark.parametrize("shape,kw", POOL_CASES,
                         ids=[f"{c[1]['pool_type']}-{i}"
                              for i, c in enumerate(POOL_CASES)])
def test_pooling_matches_mxtpu(shape, kw):
    xv = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = jmx.nd.Pooling(jmx.nd.array(xv), **kw).asnumpy()
    got = tmx.nd.Pooling(tmx.nd.array(xv, ctx=CPU), **kw).asnumpy()
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


# SoftmaxOutput at (4, 5): an ignored label of -1 (the default), of C
# and inside [0, C), under each normalization; the label column holds
# the ignored label, labels in range, and (with use_ignore off) -1 and C
# outside it
C = 5
SO_LABELS = {-1.0: [-1, 0, 3, 4], float(C): [C, 1, 3, C],
             2.0: [2, 0, 2, 4]}
SO_CASES = [(ig, True, norm) for ig in SO_LABELS
            for norm in ("null", "batch", "valid")] + \
    [(-1.0, False, norm) for norm in ("null", "valid")]


@pytest.mark.parametrize("ignore_label,use_ignore,normalization", SO_CASES)
def test_softmax_output_ignored_labels_match_mxtpu(ignore_label, use_ignore,
                                                   normalization):
    rng = np.random.RandomState(0)
    xv = rng.randn(4, C).astype(np.float32) * 2
    lv = np.asarray(SO_LABELS[ignore_label], np.float32)
    kw = dict(ignore_label=ignore_label, use_ignore=use_ignore,
              normalization=normalization, grad_scale=1.5)

    jx = jmx.nd.array(xv)
    jx.attach_grad()
    with jmx.autograd.record():
        jout = jmx.nd.SoftmaxOutput(jx, jmx.nd.array(lv), **kw)
    jout.backward()

    tx = tmx.nd.array(xv, ctx=CPU)
    tx.attach_grad()
    with autograd.record():
        tout = tmx.nd.SoftmaxOutput(tx, tmx.nd.array(lv, ctx=CPU), **kw)
    tout.backward()

    np.testing.assert_allclose(tout.asnumpy(), jout.asnumpy(), rtol=0,
                               atol=TOL)
    grad = tx.grad.asnumpy()
    assert np.isfinite(grad).all()
    np.testing.assert_allclose(grad, jx.grad.asnumpy(), rtol=0, atol=TOL)
    if use_ignore:
        assert not grad[lv == ignore_label].any()


# ----------------------------------------------------------------------
# ROADMAP queue 3, items 3-16: each case feeds the same numpy inputs
# (seed 0, or the values given) to both packages on the CPU and compares
# values, dtypes, shapes and gradients.  Integer results are bit-exact;
# f32 agrees to 1e-6; bf16 to the rounding bound stated at its case.
# ----------------------------------------------------------------------
PKGS = {"mxtpu": (jmx, {}), "port": (tmx, {"ctx": CPU})}


def _both(fn):
    """``fn(nd, autograd, ctx_kwargs)`` run in each package: its result
    as numpy arrays, or the type of the exception it raised."""
    out = {}
    for name, (m, kw) in PKGS.items():
        try:
            r = fn(m.nd, m.autograd, kw)
        except Exception as e:  # noqa: BLE001 - the type is compared
            out[name] = type(e)
            continue
        r = r if isinstance(r, tuple) else (r,)
        out[name] = tuple(np.asarray(a.asnumpy()) if hasattr(a, "asnumpy")
                          else np.asarray(a) for a in r)
    return out["mxtpu"], out["port"]


def _same(want, got, tol=TOL, exact=False):
    if isinstance(want, type):
        # the same exception: ValueError in both, or each package's own
        # MXNetError
        assert isinstance(got, type) and got.__name__ == want.__name__, \
            (want, got)
        return
    assert not isinstance(got, type), (want, got)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert g.shape == w.shape, (g.shape, w.shape)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        if exact or not np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


def _grad_of(op, xv, head, **kw):
    def fn(nd, ag, ctx):
        x = nd.array(xv, **ctx)
        x.attach_grad()
        with ag.record():
            y = getattr(nd, op)(x, **kw)
        y.backward(nd.array(head, **ctx))
        return y, x.grad
    return fn


# item 3: the eager Updater keeps an f32 master for a bf16 weight.  The
# master's arithmetic is the same f32 ops in both packages, so the bf16
# weights agree bit for bit after 200 steps for sgd; adam's master is
# held to 1e-6 relative and the weight to one bf16 ulp of its value
UPDATER_CASES = [("sgd", {"learning_rate": 1e-3}, 0.1994),
                 ("sgd", {"learning_rate": 1e-3, "momentum": 0.9}, 1.908),
                 ("adam", {"learning_rate": 1e-3}, None),
                 ("sgd", {"learning_rate": 1e-3,
                          "multi_precision": False}, None)]


def _updater_run(m, kw, name, opt_kw, steps=200):
    w0 = (4 + 0.01 * np.random.RandomState(0).randn(4, 5)).astype(
        np.float32)
    w = m.nd.array(w0, **kw).astype("bfloat16")
    g = m.nd.array(np.ones((4, 5), np.float32), **kw).astype("bfloat16")
    up = m.optimizer.get_updater(m.optimizer.create(name, **opt_kw))
    traj = []
    for _ in range(steps):
        up(0, g, w)
        traj.append(w.astype("float32").asnumpy())
    return w0, np.stack(traj), up


@pytest.mark.parametrize("name,opt_kw,moved", UPDATER_CASES,
                         ids=["sgd", "sgd-momentum", "adam", "sgd-no-master"])
def test_updater_bf16_master_matches_mxtpu(name, opt_kw, moved):
    w0, want, jup = _updater_run(jmx, {}, name, opt_kw)
    _, got, tup = _updater_run(tmx, {"ctx": CPU}, name, opt_kw)
    bf16_start = tmx.nd.array(w0, ctx=CPU).astype("bfloat16").astype(
        "float32").asnumpy()
    if name == "adam":
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want))) - 7)
        assert (np.abs(got - want) <= ulp).all()
    else:
        np.testing.assert_array_equal(got, want)
    if moved is not None:
        # mxtpu's numbers: 200 steps of lr 1e-3 move the weight by
        # 0.1994 (1.908 with momentum), within a bf16 ulp of 4
        np.testing.assert_allclose(bf16_start - got[-1], moved,
                                   atol=2.0 ** -6)
    # the master (f32) round-trips through get_states / set_states
    js, ts = (pickle.loads(u.get_states()) for u in (jup, tup))
    if opt_kw.get("multi_precision") is False:
        assert js[0] is None and ts[0] is None   # no master, no state
        return
    jm, tm = js[0][0], ts[0][0]
    assert tm.dtype == np.float32 and tm.shape == (4, 5)
    np.testing.assert_allclose(tm, jm, rtol=1e-6, atol=0)
    again = tmx.optimizer.get_updater(tup.optimizer)
    again.set_states(tup.get_states(), device="cpu")
    np.testing.assert_array_equal(again.states[0][0].numpy(), tm)


def test_updater_f32_weights_unchanged_by_the_master():
    # f32 weights take no master: the Updater's trajectory is the plain
    # optimizer's, bit for bit with mxtpu, for sgd (+ momentum) and adam
    rng = np.random.RandomState(0)
    w0, g0 = rng.randn(3, 4).astype(np.float32), \
        rng.randn(3, 4).astype(np.float32)
    for name, kw in (("sgd", {"learning_rate": 0.1, "momentum": 0.9,
                              "wd": 1e-3}),
                     ("adam", {"learning_rate": 0.01})):
        out = []
        for m, ctx in PKGS.values():
            w, g = m.nd.array(w0, **ctx), m.nd.array(g0, **ctx)
            up = m.optimizer.get_updater(m.optimizer.create(name, **kw))
            for _ in range(6):
                up(0, g, w)
            out.append(w.asnumpy())
        np.testing.assert_array_equal(out[1], out[0])


# item 4 (saturating cast) and item 12 (64-bit targets narrow to 32)
CAST_CASES = [
    ([-1.5, 300.7, -2.5], "uint8"), ([3e9], "int32"),
    ([np.nan, np.inf, -np.inf, -3e9, 2.5], "int32"),
    ([np.nan, np.inf, -np.inf, 1e5, -1e5, -0.5], "int8"),
    ([np.nan, np.inf, -np.inf, 255.9, 256.0], "uint8"),
    ([np.nan, 1e30, -1e30, 7.9], "int16"),
    ([1.5, -2.25], "float64"), ([1.5, -2.25], "int64"),
]


@pytest.mark.parametrize("vals,dtype", CAST_CASES,
                         ids=[f"{d}-{i}" for i, (_, d) in
                              enumerate(CAST_CASES)])
def test_cast_saturates_and_narrows_like_mxtpu(vals, dtype):
    xv = np.asarray(vals, np.float32)
    want, got = _both(lambda nd, ag, ctx: nd.cast(nd.array(xv, **ctx),
                                                  dtype=dtype))
    _same(want, got, exact=True)
    # the same through NDArray.astype, which runs the cast op
    want, got = _both(lambda nd, ag, ctx: nd.array(xv, **ctx).astype(dtype))
    _same(want, got, exact=True)


# item 5: reductions with axis=() and with exclude and a negative axis
REDUCE_CASES = [dict(axis=()), dict(axis=(), keepdims=True),
                dict(axis=(), exclude=True),
                dict(axis=-1, exclude=True, keepdims=True),
                dict(axis=(0, -1), exclude=True), dict(axis=1, exclude=True),
                dict(axis=-1), dict(axis=(0, 2), keepdims=True)]


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min"])
@pytest.mark.parametrize("kw", REDUCE_CASES,
                         ids=[str(i) for i in range(len(REDUCE_CASES))])
def test_reduce_axes_match_mxtpu(op, kw):
    xv = np.random.RandomState(0).randn(2, 3, 4).astype(np.float32)
    _same(*_both(lambda nd, ag, ctx: getattr(nd, op)(nd.array(xv, **ctx),
                                                    **kw)))


# item 6: argmax/argmin with no axis and keepdims
@pytest.mark.parametrize("op", ["argmax", "argmin"])
@pytest.mark.parametrize("keepdims", [True, False])
def test_arg_reduce_keepdims_matches_mxtpu(op, keepdims):
    xv = np.random.RandomState(0).randn(2, 3, 4).astype(np.float32)
    _same(*_both(lambda nd, ag, ctx: getattr(nd, op)(
        nd.array(xv, **ctx), keepdims=keepdims)), exact=True)


# item 7: ties pass half the head gradient, as jnp.maximum/minimum/clip;
# relu at 0 and the binary maximum/minimum ties stay as they were
TIE_X = np.array([1.0, 2.0, 3.0, 0.5], np.float32)
TIE_HEAD = np.full(4, 1.69, np.float32)
TIE_CASES = [("_maximum_scalar", dict(scalar=2.0)),
             ("_minimum_scalar", dict(scalar=2.0)),
             ("_MaximumScalar", dict(scalar=1.0)),
             ("_MinimumScalar", dict(scalar=3.0)),
             ("clip", dict(a_min=1.0, a_max=3.0)),
             ("clip", dict(a_min=2.0, a_max=2.0)),
             ("relu", {})]


@pytest.mark.parametrize("op,kw", TIE_CASES,
                         ids=[f"{o}-{i}" for i, (o, _) in
                              enumerate(TIE_CASES)])
def test_ties_split_the_gradient_like_mxtpu(op, kw):
    xv = TIE_X if op != "relu" else np.array([0.0, -1.0, 1.0, 0.0],
                                             np.float32)
    _same(*_both(_grad_of(op, xv, TIE_HEAD, **kw)))


@pytest.mark.parametrize("op", ["maximum", "minimum"])
def test_binary_ties_split_the_gradient_like_mxtpu(op):
    av, bv = np.array([1.0, 2.0, 4.0]), np.array([1.0, 3.0, 4.0])

    def fn(nd, ag, ctx):
        a, b = nd.array(av, **ctx), nd.array(bv, **ctx)
        a.attach_grad()
        b.attach_grad()
        with ag.record():
            y = getattr(nd, op)(a, b)
        y.backward()
        return y, a.grad, b.grad
    _same(*_both(fn))


# items 8 and 9: abs's gradient at +-0 is the head; sign(NaN) is NaN
def test_abs_gradient_at_zero_matches_mxtpu():
    xv = np.array([0.0, -0.0, 1.0, -2.0], np.float32)
    _same(*_both(_grad_of("abs", xv, TIE_HEAD)), exact=True)


def test_sign_of_nan_matches_mxtpu():
    xv = np.array([np.nan, -1.0, 0.0, 2.0, -0.0], np.float32)
    _same(*_both(lambda nd, ag, ctx: nd.sign(nd.array(xv, **ctx))),
          exact=True)


# item 10 (and 16, found beside it): integer inputs
INT_X = np.array([[1, -2, 3], [4, 0, -6]], np.int32)
INT_Y = np.array([[0, 2, 0], [3, 0, 4]], np.int32)
INT_CASES = {
    **{op: (lambda op: lambda nd, x, y: getattr(nd, op)(x, scalar=1.0))(op)
       for op in ("_equal_scalar", "_not_equal_scalar", "_greater_scalar",
                  "_greater_equal_scalar", "_lesser_scalar",
                  "_lesser_equal_scalar")},
    "sum": lambda nd, x, y: nd.sum(x),
    "sum-axis": lambda nd, x, y: nd.sum(x, axis=1),
    "mean": lambda nd, x, y: nd.mean(x),
    "mean-axis": lambda nd, x, y: nd.mean(x, axis=0, keepdims=True),
    "softmax": lambda nd, x, y: nd.softmax(x),
    "log_softmax": lambda nd, x, y: nd.log_softmax(x),
    "_mod-by-0": lambda nd, x, y: nd._mod(x, y),
    "_rmod_scalar-by-0": lambda nd, x, y: nd._rmod_scalar(x, scalar=5.0),
    "_mod_scalar-by-0": lambda nd, x, y: nd._mod_scalar(x, scalar=0.0),
}


@pytest.mark.parametrize("case", list(INT_CASES))
def test_integer_inputs_match_mxtpu(case):
    fn = INT_CASES[case]
    _same(*_both(lambda nd, ag, ctx: fn(
        nd, nd.array(INT_X, dtype="int32", **ctx),
        nd.array(INT_Y, dtype="int32", **ctx))))


# item 11: a head with no gradient path gives zero gradients; a head of
# a non-differentiable op is no head at all (both raise)
@pytest.mark.parametrize("op", ["BlockGrad", "stop_gradient", "zeros_like",
                                "ones_like", "ceil", "floor", "sign"])
def test_backward_from_a_head_without_a_path_matches_mxtpu(op):
    def fn(nd, ag, ctx):
        x = nd.array(np.array([1.5, -2.0, 0.25], np.float32), **ctx)
        x.attach_grad()
        with ag.record():
            y = getattr(nd, op)(x)
        y.backward()
        return x.grad
    want, got = _both(fn)
    _same(want, got, exact=True)


# item 13: the power ops' gradients at 0 (NaN, not 0 or -inf)
POW_CASES = [("_power_scalar", [0.0, 2.0, -1.0], dict(scalar=0.0)),
             ("_power_scalar", [0.0, 2.0, 1.0], dict(scalar=0.5)),
             ("_rpower_scalar", [-2.0, 0.0, 1.0], dict(scalar=0.0)),
             ("_rpower_scalar", [-2.0, 0.0, 1.0], dict(scalar=2.0))]


@pytest.mark.parametrize("op,xs,kw", POW_CASES,
                         ids=[f"{o}-{i}" for i, (o, _, _) in
                              enumerate(POW_CASES)])
def test_power_gradients_at_zero_match_mxtpu(op, xs, kw):
    xv = np.asarray(xs, np.float32)
    _same(*_both(_grad_of(op, xv, np.ones(3, np.float32), **kw)))


@pytest.mark.parametrize("op", ["_power", "broadcast_power"])
def test_binary_power_gradients_at_zero_match_mxtpu(op):
    av = np.array([0.0, 2.0, 0.0, 3.0], np.float32)
    bv = np.array([0.0, 3.0, 2.0, 0.0], np.float32)

    def fn(nd, ag, ctx):
        a, b = nd.array(av, **ctx), nd.array(bv, **ctx)
        a.attach_grad()
        b.attach_grad()
        with ag.record():
            y = getattr(nd, op)(a, b)
        y.backward()
        return y, a.grad, b.grad
    _same(*_both(fn))


# item 14: squeeze of an axis whose size is not 1 raises ValueError
@pytest.mark.parametrize("shape,axis", [((2, 3), (0,)), ((1, 3, 2), (-1,)),
                                        ((1, 3, 1), (0, -1)),
                                        ((1, 3, 1), (0,))])
def test_squeeze_matches_mxtpu(shape, axis):
    xv = np.ones(shape, np.float32)
    _same(*_both(lambda nd, ag, ctx: nd.squeeze(nd.array(xv, **ctx),
                                                axis=axis)))


# item 15: bf16 3-D average (and sum) pooling on the CPU.  mxtpu adds
# each window of 8 in bf16 (7 roundings of a partial sum at most
# 8 max|x|, each within 2^-9 of it), the port in f32 with one rounding
# of the result: they agree to 8 * 2^-9 * max|x| (2^-6 max|x|)
@pytest.mark.parametrize("kw", [dict(kernel=(2, 2, 2), pool_type="avg"),
                                dict(kernel=(2, 2, 2), pool_type="avg",
                                     stride=(2, 2, 2)),
                                dict(kernel=(2, 2, 2), pool_type="sum",
                                     stride=(2, 2, 2)),
                                dict(kernel=(2, 2, 2), pool_type="max")])
def test_bf16_pool3d_matches_mxtpu(kw):
    xv = np.random.RandomState(0).randn(1, 2, 4, 4, 4).astype(np.float32)
    want, got = _both(lambda nd, ag, ctx: nd.Pooling(
        nd.array(xv, **ctx).astype("bfloat16"), **kw).astype("float32"))
    _same(want, got, tol=2.0 ** -6 * float(np.abs(xv).max()))


# ----------------------------------------------------------------------
# optimizer constructor arguments and the multipliers' lookup (queue 3
# items 18 and 19)
# ----------------------------------------------------------------------

NAMES = {0: "fc_weight", 1: "fc_bias", 2: "bn_beta", 3: "bn_gamma"}


@pytest.mark.parametrize("name", ["sgd", "adam", "nag"])
def test_optimizer_takes_mxtpus_arguments_and_lookup_order(name):
    """``param_idx2name``, ``sym``, ``param_dict`` (and SGD's and Adam's
    ``lazy_update``) are accepted, positionally in mxtpu's order too,
    and ``_get_lr`` / ``_get_wd`` look up ``param_dict`` first, then the
    index, then the name, as mxtpu's do."""
    pkgs = []
    for mx in (jmx, tmx):
        pd = {1: mx.gluon.Parameter("p1", shape=(1,), lr_mult=0.25,
                                    wd_mult=4.0)}
        extra = {"lazy_update": False} if name != "nag" else {}
        o = mx.optimizer.create(name, learning_rate=1.0, wd=0.1,
                                param_idx2name=NAMES, sym=None,
                                param_dict=pd, **extra)
        o.set_lr_mult({0: 0.5, "fc_bias": 9.0, "bn_beta": 3.0})
        o.set_wd_mult({"bn_gamma": 2.0, 2: 0.7})
        pkgs.append([(o._get_lr(i), o._get_wd(i)) for i in range(5)])
        if name != "nag":
            assert o.lazy_update is False
    assert pkgs[0] == pkgs[1]
    # mxtpu's positional order: rescale_grad, param_idx2name, wd, ...
    j = jmx.optimizer.Optimizer(0.5, NAMES, 0.01)
    t = tmx.optimizer.Optimizer(0.5, NAMES, 0.01)
    assert (t.rescale_grad, t.idx2name, t.wd) == \
        (j.rescale_grad, j.idx2name, j.wd)


def test_set_wd_mult_drops_decay_off_weights_and_gammas():
    """With ``idx2name``, ``set_wd_mult`` gives wd_mult 0 to every name
    ending in neither ``_weight`` nor ``_gamma`` before the caller's
    dict, as mxtpu's does: [0.1, 0, 0, 0.1] at wd 0.1, not 0.1 four
    times; the caller's entries still win."""
    got = []
    for mx in (jmx, tmx):
        o = mx.optimizer.SGD(learning_rate=1.0, wd=0.1,
                             param_idx2name=NAMES)
        o.set_wd_mult({})
        first = [o._get_wd(i) for i in range(4)]
        o.set_wd_mult({"fc_bias": 0.5})
        got.append((first, [o._get_wd(i) for i in range(4)]))
    assert got[0] == got[1]
    assert got[1][0] == [0.1, 0.0, 0.0, 0.1]
    assert got[1][1] == [0.1, 0.05, 0.0, 0.1]


# ---------------------------------------------------------------------
# items 22-24: _rmod_scalar's backward, Embedding's ids outside [0, V),
# and TrainStep's NDArray batches
# ---------------------------------------------------------------------
class _RModNet:
    """``F._rmod_scalar(x, scalar=3)`` as a HybridBlock of either
    package."""

    def __new__(cls, mx):
        class RMod(mx.gluon.HybridBlock):
            def hybrid_forward(self, F, x):
                return F._rmod_scalar(x, scalar=3.0)
        return RMod()


def _ctx(mx):
    return mx.cpu()


def _rmod_grad(mx, path, xv):
    """(output, gradient of its sum) of 3 mod x through ``path``."""
    ctx = _ctx(mx)
    if path == "sym":
        ex = (3.0 % mx.sym.Variable("x")).simple_bind(ctx, x=xv.shape)
        ex.arg_dict["x"][:] = mx.nd.array(xv, ctx=ctx)
        ex.forward(is_train=True)
        ex.backward(mx.nd.ones(xv.shape, ctx=ctx))
        return ex.outputs[0].asnumpy(), ex.grad_dict["x"].asnumpy()
    x = mx.nd.array(xv, ctx=ctx)
    x.attach_grad()
    with mx.autograd.record():
        y = _RModNet(mx)(x) if path == "gluon" else \
            mx.nd._rmod_scalar(x, scalar=3.0)
    y.backward()
    return y.asnumpy(), x.grad.asnumpy()


@pytest.mark.parametrize("path", ["sym", "gluon", "nd"])
def test_rmod_scalar_backward_matches_mxtpu(path):
    xv = np.array([0.7, 1.5, 2.5], np.float32)
    jy, jg = _rmod_grad(jmx, path, xv)
    ty, tg = _rmod_grad(tmx, path, xv)
    np.testing.assert_array_equal(jg, [-4.0, -2.0, -1.0])
    np.testing.assert_allclose(ty, jy, rtol=0, atol=TOL)
    np.testing.assert_array_equal(tg, jg)
    # negative divisors and dividends of both signs: jnp.mod adds x
    # back where the truncated remainder's sign differs from x's
    xv = np.array([-0.7, -1.5, 4.0, -4.0, 0.3], np.float32)
    jy, jg = _rmod_grad(jmx, path, xv)
    ty, tg = _rmod_grad(tmx, path, xv)
    np.testing.assert_allclose(ty, jy, rtol=0, atol=TOL)
    np.testing.assert_array_equal(tg, jg)


def test_rmod_scalar_integer_input_matches_mxtpu():
    xv = np.array([2, 4, 5, -2], np.int32)
    want = jmx.nd._rmod_scalar(jmx.nd.array(xv), scalar=3.0)
    got = tmx.nd._rmod_scalar(tmx.nd.array(xv, ctx=CPU), scalar=3.0)
    assert got.asnumpy().dtype == want.asnumpy().dtype
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


EMB_W = np.arange(24, dtype=np.float32).reshape(12, 2) / 7.0
EMB_IDS = np.array([0, 11, 12, 25, -1, -13], np.float32)


def _embedding(mx, path):
    """(rows, gradient of sum(rows * head) in the weight) for the ids of
    ROADMAP's case; NaN rows are zeroed in the head's product so the
    loss stays finite (the gradient rows of those ids must stay 0)."""
    ctx = _ctx(mx)
    head = np.isfinite(EMB_W[np.clip(EMB_IDS.astype(int), -12, 11)]) * \
        np.arange(1, 13, dtype=np.float32).reshape(6, 2)
    if path == "sym":
        s = mx.sym.Embedding(mx.sym.Variable("ids"), mx.sym.Variable("w"),
                             input_dim=12, output_dim=2)
        ex = s.simple_bind(ctx, ids=EMB_IDS.shape, w=EMB_W.shape,
                           grad_req={"ids": "null", "w": "write"})
        ex.arg_dict["ids"][:] = mx.nd.array(EMB_IDS, ctx=ctx)
        ex.arg_dict["w"][:] = mx.nd.array(EMB_W, ctx=ctx)
        ex.forward(is_train=True)
        ex.backward(mx.nd.array(head, ctx=ctx))
        return ex.outputs[0].asnumpy(), ex.grad_dict["w"].asnumpy()
    ids = mx.nd.array(EMB_IDS, ctx=ctx)
    if path == "gluon":
        layer = mx.gluon.nn.Embedding(12, 2)
        layer.initialize(ctx=ctx)
        layer.weight.set_data(mx.nd.array(EMB_W, ctx=ctx))
        with mx.autograd.record():
            rows = layer(ids)
        rows.backward(mx.nd.array(head, ctx=ctx))
        return rows.asnumpy(), layer.weight.grad().asnumpy()
    w = mx.nd.array(EMB_W, ctx=ctx)
    w.attach_grad()
    with mx.autograd.record():
        rows = mx.nd.Embedding(ids, w, input_dim=12, output_dim=2)
    rows.backward(mx.nd.array(head, ctx=ctx))
    return rows.asnumpy(), w.grad.asnumpy()


@pytest.mark.parametrize("path", ["nd", "gluon", "sym"])
def test_embedding_ids_out_of_range_match_mxtpu(path):
    jrows, jgrad = _embedding(jmx, path)
    trows, tgrad = _embedding(tmx, path)
    # 12, 25 and -13 are outside [-12, 12): NaN rows; -1 is row 11
    assert np.isnan(jrows[[2, 3, 5]]).all()
    np.testing.assert_array_equal(np.isnan(trows), np.isnan(jrows))
    np.testing.assert_array_equal(np.nan_to_num(trows),
                                  np.nan_to_num(jrows))
    np.testing.assert_allclose(tgrad.sum(axis=1), jgrad.sum(axis=1),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(tgrad, jgrad, rtol=0, atol=TOL)


def test_train_step_takes_an_ndarray_batch_without_asnumpy(monkeypatch):
    from mxtpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxtpu_torch.ndarray.ndarray import NDArray
    from mxtpu_torch.parallel import build_train_step
    rng = np.random.RandomState(0)
    xv = rng.randn(4, 6).astype(np.float32)
    yv = np.array([0, 2, 1, 2], np.float32)

    def step():
        tmx.random.seed(0)
        net = tmx.gluon.nn.Dense(3, in_units=6)
        net.initialize(ctx=CPU)
        return build_train_step(net, SoftmaxCrossEntropyLoss(), "sgd",
                                {"learning_rate": 0.1}, device="cpu")
    want = [float(step()(xv, yv)) for _ in range(1)]
    x, y = tmx.nd.array(xv, ctx=CPU), tmx.nd.array(yv, ctx=CPU)

    def no_host(self):
        raise AssertionError("the batch went through the host")
    monkeypatch.setattr(NDArray, "asnumpy", no_host)
    got = [float(step()(x, y)) for _ in range(1)]
    assert got == want


def _frozen_scale_net(mx, seen):
    """A frozen scale parameter (``grad_req="null"``) before a Dense: the
    dtype it has inside the step is recorded in ``seen``."""
    class Scale(mx.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.s = self.params.get(
                "s", shape=(1,), init=mx.init.Constant(0.5),
                grad_req="null")

        def hybrid_forward(self, F, x, s):
            seen.append(str(s.dtype).replace("torch.", ""))
            return F.broadcast_mul(x, s)
    net = mx.gluon.nn.HybridSequential()
    net.add(Scale(), mx.gluon.nn.Dense(3, in_units=6))
    return net


def test_compute_dtype_casts_frozen_parameters_as_mxtpu():
    """Queue 3 item 25: mxtpu's step casts every float parameter but
    BatchNorm's running statistics to ``compute_dtype``, frozen ones
    too; the port cast only the trained ones."""
    from mxtpu import parallel as jpar
    from mxtpu.gluon import loss as jloss
    from mxtpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxtpu_torch.parallel import build_train_step
    rng = np.random.RandomState(0)
    xv = rng.randn(4, 6).astype(np.float32)
    yv = np.array([0, 2, 1, 2], np.float32)
    jseen, tseen = [], []
    jnet = _frozen_scale_net(jmx, jseen)
    jnet.initialize()
    jnet(jmx.nd.array(xv))
    jstep = jpar.build_train_step(jnet, jloss.SoftmaxCrossEntropyLoss(),
                                  "sgd", {"learning_rate": 0.1},
                                  compute_dtype="bfloat16", cache=None)
    jstep(jmx.nd.array(xv), jmx.nd.array(yv))
    tnet = _frozen_scale_net(tmx, tseen)
    tnet.initialize(ctx=CPU)
    tnet(torch.from_numpy(xv))
    tstep = build_train_step(tnet, SoftmaxCrossEntropyLoss(), "sgd",
                             {"learning_rate": 0.1},
                             compute_dtype="bfloat16", device="cpu")
    tstep(xv, yv)
    assert jseen[-1] == tseen[-1] == "bfloat16"
    # the stored parameter stays f32
    assert tnet[0].s.data().dtype == np.float32
