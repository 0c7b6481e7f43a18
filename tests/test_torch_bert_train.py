"""A small BERT trained by mxtpu_torch on the CPU, held against mxtpu's
per-parameter train step; also the port's loss, optimizers, dropout and
weight carry-back.

The weights start in mxtpu (xavier), cross with ``params_from_mxtpu``
and come back with ``params_to_mxtpu``.  Dropout is 0 in the parity
runs (the JAX package's dropout stream has no torch counterpart).
Tolerances: f32 losses 1e-5 relative and parameters after five adam
steps 1e-4 (another summation order in every product, amplified by
adam's division by sqrt(v)); bf16 compute 2e-2 on the losses
(``log_softmax`` and the GEMMs round to bf16 at other places in the two
frameworks).  mxtpu's batched optimizer path misses its own parity bar
on this tree, so the reference is its per-parameter path
(``MXTPU_BATCHED_OPT=0``).  Both packages build their BERT with fresh
name counters, so the weights cross by mxtpu's names.
"""
import numpy as np
import pytest
import torch

from mxtpu import nd
from mxtpu import optimizer as jopt
from mxtpu import parallel as jpar
from mxtpu.gluon import loss as jloss
from mxtpu.models.transformer import BERTModel as JBERT

from mxtpu_torch import MXNetError, autograd as tautograd, cpu
from mxtpu_torch import random as trandom
from mxtpu_torch.convert import params_from_mxtpu, params_to_mxtpu
from mxtpu_torch.gluon import nn as tnn
from mxtpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxtpu_torch.models import BERTModel
from mxtpu_torch.optimizer import SGD, Adam, create, functional, register
from mxtpu_torch.parallel import build_train_step

from tests.torch_gluon_names import fresh_names

torch.set_num_threads(2)

V, U, H, L, T, MAXLEN = 128, 64, 4, 2, 16, 40


def _tokens(seed, b=2):
    return np.random.RandomState(seed).randint(0, V, (b, T)) \
        .astype(np.float32)


def _jax_bert():
    with fresh_names():
        net = JBERT(V, U, 4 * U, L, H, max_length=MAXLEN, dropout=0.0)
    net.initialize(init="xavier")
    net(nd.array(_tokens(0)))
    return net


def _jax_params(net):
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


def _torch_bert(params=None, dropout=0.0):
    """The port's BERT named as a fresh process names it: ``params``
    carried in by name, else xavier weights of its own on the CPU (the
    deferred shapes filled at the first forward)."""
    with fresh_names():
        net = BERTModel(V, U, 4 * U, L, H, max_length=MAXLEN,
                        dropout=dropout)
    if params is None:
        net.initialize(init="xavier", ctx=cpu())
        return net
    return params_from_mxtpu(params, net)


def _jmlm(pred, y):
    return jloss.SoftmaxCrossEntropyLoss()(pred.reshape((-1, V)),
                                           y.reshape((-1,)))


_CE = SoftmaxCrossEntropyLoss()


def _tmlm(pred, y):
    return _CE(pred.reshape(-1, V), y.reshape(-1))


# ------------------------------------------------------- the train step

@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_adam_steps_match_mxtpu_per_parameter_step(monkeypatch,
                                                   compute_dtype):
    monkeypatch.setenv("MXTPU_BATCHED_OPT", "0")
    jnet = _jax_bert()
    tnet = _torch_bert(_jax_params(jnet))
    x = _tokens(1)
    kw = dict(cast_batch=False, compute_dtype=compute_dtype)
    jstep = jpar.build_train_step(jnet, _jmlm, "adam",
                                  {"learning_rate": 1e-3}, cache=None,
                                  **kw)
    tstep = build_train_step(tnet, _tmlm, "adam", {"learning_rate": 1e-3},
                             device="cpu", **kw)
    want = [float(jstep(nd.array(x), nd.array(x)).asnumpy())
            for _ in range(5)]
    got = [float(tstep(x, x)) for _ in range(5)]
    if compute_dtype is None:
        np.testing.assert_allclose(got, want, rtol=1e-5)
        jp = _jax_params(jnet)
        tp = params_to_mxtpu(tnet, list(jp))
        for n in jp:
            np.testing.assert_allclose(tp[n], jp[n], rtol=1e-4, atol=1e-4,
                                       err_msg=n)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-2)
        # the masters stay f32 under a bf16 compute type
        assert all(p.dtype == torch.float32 for p in tnet.parameters())


def test_sgd_momentum_steps_match_mxtpu(monkeypatch):
    monkeypatch.setenv("MXTPU_BATCHED_OPT", "0")
    jnet = _jax_bert()
    tnet = _torch_bert(_jax_params(jnet))
    x = _tokens(2)
    opt = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-3}
    jstep = jpar.build_train_step(jnet, _jmlm, "sgd", opt,
                                  cast_batch=False, cache=None)
    tstep = build_train_step(tnet, _tmlm, "sgd", opt, cast_batch=False,
                             device="cpu")
    want = [float(jstep(nd.array(x), nd.array(x)).asnumpy())
            for _ in range(3)]
    got = [float(tstep(x, x)) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_loss_falls_on_a_repeated_batch_with_dropout_on():
    trandom.seed(3)
    net = _torch_bert(dropout=0.1)
    step = build_train_step(net, _tmlm, "adam", {"learning_rate": 1e-3},
                            cast_batch=False, device="cpu")
    x = _tokens(4, b=4)
    losses = [float(step(x, x)) for _ in range(8)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < losses[0]
    mem = step.memory_summary()
    assert mem["peak_bytes"] is None and mem["device"] == "cpu"
    assert mem["opt_state_bytes"] == 2 * mem["param_bytes"]


def test_lr_mult_is_read_live():
    net = _torch_bert()
    step = build_train_step(net, _tmlm, "adam", {"learning_rate": 1e-3},
                            cast_batch=False, device="cpu")
    x = _tokens(5)
    step(x, x)                       # fills the deferred shapes
    # keyed by mxtpu's name, as mxtpu's step reads it
    step.optimizer.set_lr_mult({net.mlm.weight.name: 0.0})
    before = net.mlm.weight.data().asnumpy()
    step(x, x)
    np.testing.assert_array_equal(net.mlm.weight.data().asnumpy(), before)
    step.optimizer.set_lr_mult({})
    step(x, x)
    assert not np.array_equal(net.mlm.weight.data().asnumpy(), before)
    # and the Parameter's own multiplier
    net.mlm.weight.lr_mult = 0.0
    before = net.mlm.weight.data().asnumpy()
    step(x, x)
    np.testing.assert_array_equal(net.mlm.weight.data().asnumpy(), before)


def test_build_train_step_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default would be cuda:0")
    with pytest.raises(MXNetError, match="CUDA is not available"):
        build_train_step(_torch_bert(), _tmlm, "adam")


@pytest.mark.parametrize("option", [
    {"mesh": object()}, {"param_spec_fn": lambda p: None}, {"zero": 1},
    {"cache": "auto"}])
def test_unported_options_raise(option):
    with pytest.raises(NotImplementedError, match="not ported"):
        build_train_step(_torch_bert(), _tmlm, "adam", device="cpu",
                         **option)


def test_amp_option_is_ported():
    """amp=True (no longer refused): the trainable weights are stored in
    bf16 over f32 masters, and a step returns an f32 loss."""
    step = build_train_step(_torch_bert(), _tmlm, "adam", device="cpu",
                            amp=True, cast_batch=False)
    loss = step(_tokens(1), _tokens(1))
    assert {p.dtype for p in step._params} == {torch.bfloat16}
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert step.amp_stats()["good_steps"] == 1


@pytest.mark.parametrize("target,option", [
    # the one-device step has no mesh axis and no buffer donation
    *[("step", o) for o in ("dp_axis", "batch_axis", "donate")],
    # the optimizers take mxtpu's constructor arguments: sym (ignored,
    # as in mxtpu), param_dict and param_idx2name (the multipliers'
    # lookup) and lazy_update (kept; every update is dense)
    *[(n, o) for n in ("adam", "sgd")
      for o in ("sym", "param_dict", "param_idx2name", "lazy_update")]])
def test_options_without_effect_are_refused(target, option):
    if target == "step":
        with pytest.raises(TypeError, match=option):
            build_train_step(_torch_bert(), _tmlm, "adam", device="cpu",
                             **{option: None})
        return
    value = {"sym": None, "param_dict": {0: object()},
             "param_idx2name": {0: "w_weight"}, "lazy_update": False}[option]
    opt = create(target, **{option: value})
    attr = {"param_idx2name": "idx2name", "sym": None}.get(option, option)
    if attr is not None:
        assert getattr(opt, attr) == value


@pytest.mark.parametrize("name,kw", [
    ("adam", {"learning_rate": 0.01}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9})])
def test_begin_num_update_matches_mxtpu(name, kw):
    """``begin_num_update`` is where each parameter's update count
    starts: adam's bias correction at t = 101, 102, 103, and a
    MultiFactorScheduler past its first milestone for both, against
    mxtpu's eager updates at 1e-6."""
    from mxtpu.optimizer.lr_scheduler import MultiFactorScheduler as JMF
    from mxtpu_torch.optimizer.lr_scheduler import MultiFactorScheduler
    rng = np.random.RandomState(9)
    w = rng.randn(4, 6).astype(np.float32)
    grads = [rng.randn(4, 6).astype(np.float32) for _ in range(3)]
    jo = jopt.create(name, begin_num_update=100,
                     lr_scheduler=JMF([50, 102], factor=0.5), **kw)
    to = create(name, begin_num_update=100,
                lr_scheduler=MultiFactorScheduler([50, 102], factor=0.5),
                **kw)
    jw, tw = nd.array(w), torch.from_numpy(w.copy())
    js, ts = jo.create_state(0, jw), to.create_state(0, tw)
    for g in grads:
        jo.update(0, jw, nd.array(g), js)
        to.update(0, tw, torch.from_numpy(g), ts)
        assert to.num_update == jo.num_update
    assert to.num_update == 103
    np.testing.assert_allclose(tw.numpy(), jw.asnumpy(), rtol=1e-6,
                               atol=1e-6)


def test_run_steps_and_the_stacked_update_raise():
    """``run_steps`` raises on the arguments mxtpu's refuses; the
    stacked update, once refused, runs and equals the per-parameter
    one."""
    step = build_train_step(_torch_bert(), _tmlm, "adam", device="cpu")
    for steps in (0, -1):
        with pytest.raises(MXNetError, match="steps >= 1"):
            step.run_steps(_tokens(0), _tokens(0), steps)
    with pytest.raises(MXNetError, match="not divisible into 2"):
        step.run_steps(_tokens(0, b=3), _tokens(0, b=3), 2)
    assert step._t == 0
    init, update = functional.opt_rule(step.optimizer)
    w = torch.randn(2, 3)
    g = torch.randn(2, 3)
    st = init(w, stacked=True)
    w2, (m, v) = update(w, g, st, 0.1, 0.0, stacked=True)
    for a in range(2):
        wa, (ma, va) = update(w[a], g[a], init(w[a]), 0.1, 0.0)
        assert torch.equal(w2[a], wa) and torch.equal(m[a], ma) and \
            torch.equal(v[a], va)


# ------------------------------------------------------------ the pieces

@pytest.mark.parametrize("weight,batch_axis", [(None, 0), (0.5, 1)])
def test_softmax_ce_matches_mxtpu(weight, batch_axis):
    rng = np.random.RandomState(6)
    pred = rng.randn(5, 7, 11).astype(np.float32)
    label = rng.randint(0, 11, (5, 7)).astype(np.float32)
    want = jloss.SoftmaxCrossEntropyLoss(weight=weight,
                                         batch_axis=batch_axis)(
        nd.array(pred), nd.array(label)).asnumpy()
    got = SoftmaxCrossEntropyLoss(weight=weight, batch_axis=batch_axis)(
        torch.from_numpy(pred), torch.from_numpy(label)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,kw", [
    ("adam", {"learning_rate": 0.01, "wd": 0.01}),
    ("sgd", {"learning_rate": 0.1, "wd": 0.01, "clip_gradient": 0.5}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
             "rescale_grad": 0.5})])
def test_eager_update_matches_mxtpu(name, kw):
    rng = np.random.RandomState(7)
    w = rng.randn(4, 6).astype(np.float32)
    grads = [rng.randn(4, 6).astype(np.float32) for _ in range(3)]
    jo, to = jopt.create(name, **kw), create(name, **kw)
    jw, tw = nd.array(w), torch.from_numpy(w.copy())
    js, ts = jo.create_state(0, jw), to.create_state(0, tw)
    for g in grads:
        jo.update(0, jw, nd.array(g), js)
        to.update(0, tw, torch.from_numpy(g), ts)
    np.testing.assert_allclose(tw.numpy(), jw.asnumpy(), rtol=1e-6,
                               atol=1e-6)


def test_optimizer_registry_and_bias_correction():
    assert isinstance(create("Adam"), Adam) and isinstance(create("sgd"),
                                                           SGD)
    with pytest.raises(MXNetError, match="unknown optimizer"):
        create("nope")

    @register
    class Plain(SGD):
        pass
    assert isinstance(create("plain"), Plain)
    from mxtpu.optimizer.functional import adam_bias_correction as jbc
    for t in (1, 2, 10):
        assert functional.adam_bias_correction(Adam(), t) == \
            jbc(jopt.Adam(), t)
    assert functional.adam_bias_correction(SGD(), 3) == 1.0
    # a scheduler takes the optimizer's lr as its base, and then owns it
    from mxtpu_torch.optimizer.lr_scheduler import FactorScheduler
    sched = FactorScheduler(step=10, factor=0.5, base_lr=1.0)
    opt = Adam(learning_rate=0.02, lr_scheduler=sched)
    assert sched.base_lr == 0.02 and opt.learning_rate == 0.02
    opt.num_update = 25
    assert opt.learning_rate == 0.005
    with pytest.raises(MXNetError, match="lr_scheduler is set"):
        opt.set_learning_rate(0.1)


def test_multi_precision_rule_keeps_an_f32_master():
    init, update = functional.opt_rule(Adam(learning_rate=0.1))
    w = torch.randn(8).bfloat16()
    st = init(w)
    assert st[0].dtype == torch.float32 and len(st) == 3
    w2, st2 = update(w, torch.ones(8), st, 0.1, 0.0)
    assert w2.dtype == torch.bfloat16
    assert torch.equal(w2, st2[0].bfloat16())


def test_dropout_draws_from_the_seeded_generator():
    x = torch.ones(64, 64)
    drop = tnn.Dropout(0.25)
    with tautograd.train_mode():
        trandom.seed(11)
        a = drop(x)
        trandom.seed(11)
        b = drop(x)
        c = drop(x)
    assert torch.equal(a, b) and not torch.equal(b, c)
    kept = (a != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.03
    assert torch.allclose(a[a != 0], torch.full_like(a[a != 0], 1 / 0.75))
    # outside training mode (autograd's flag, as in mxtpu) it is off
    assert torch.equal(drop(x), x)
    trandom.seed(11)
    k1 = trandom.key_words()
    trandom.seed(11)
    assert trandom.key_words() == k1 and trandom.key_words() != k1
    assert all(0 <= k < 1 << 32 for k in k1)


def test_params_to_mxtpu_inverts_params_from_mxtpu():
    params = _jax_params(_jax_bert())
    back = params_to_mxtpu(_torch_bert(params), list(params))
    assert list(back) == list(params)
    for n in params:
        np.testing.assert_array_equal(back[n], params[n])
    own = params_to_mxtpu(_torch_bert(params))
    assert list(own)[:2] == ["bertmodel0_pos_embed", "embedding0_weight"]
    with pytest.raises(MXNetError, match="names differ"):
        params_to_mxtpu(_torch_bert(), ["a", "b"])
