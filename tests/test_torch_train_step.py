"""mxtpu_torch's training path as mxtpu runs it, on the CPU: the
bucketed (stacked) update by default, ``run_steps``, the lr schedulers,
the fourteen optimizers, the update ops and ``save_states`` /
``load_states``, held against mxtpu and against the port's own
per-parameter path.

The nets are a 2-layer narrow BERT (as ``test_torch_bert_train.py``
builds it; its 31 parameters fall into 11 (shape, dtype) buckets) and
the narrow ResNet V1 of ``test_torch_resnet_train.py`` in NHWC.

Tolerances.  The port's bucketed update against its per-parameter one:
bit for bit (the rules are elementwise and each op is the same op on a
larger tensor), but LAMB's trust-ratio norms, which reduce per slice in
another order: rtol 1e-5 / atol 1e-6, as ``tests/test_batched_opt.py``
holds mxtpu's.  The port against mxtpu: as in
``test_torch_bert_train.py``, f32 losses 1e-5 relative and parameters
1e-4 after adam steps (another summation order in every product,
amplified by adam's division by sqrt(v)), bf16 compute 2e-2 on the
losses; LAMB and RMSProp losses 1e-5.  mxtpu's own bucketed adam
misses its bar on this tree
(``test_batched_opt.py::test_batched_bit_identical_elementwise_rules
[adam-oparams2]``), so its side runs ``MXTPU_BATCHED_OPT=0``, set after
the port's step was built (the port reads the knob when it builds a
step, mxtpu when it first compiles one).  The eager optimizers: f32
1e-6, bf16 masters 1e-3 relative and the bf16 weights within one bf16
ulp of mxtpu's (two masters 1e-6 apart can round to neighbouring bf16
values); SGLD by its noise's mean and variance over 10^5 elements.
Schedulers: equal as Python floats.
"""
import pickle

import numpy as np
import pytest
import torch

import mxtpu as jmx
from mxtpu import nd
from mxtpu import optimizer as jopt
from mxtpu import parallel as jpar
from mxtpu.gluon import loss as jloss
from mxtpu.models.transformer import BERTModel as JBERT
from mxtpu.optimizer import lr_scheduler as jls

import mxtpu_torch as tmx
from mxtpu_torch import MXNetError, knobs, random as trandom
from mxtpu_torch.convert import params_from_mxtpu, params_to_mxtpu
from mxtpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxtpu_torch.gluon.model_zoo.vision import BottleneckV1, ResNetV1
from mxtpu_torch.models import BERTModel
from mxtpu_torch.optimizer import create, functional
from mxtpu_torch.optimizer import lr_scheduler as tls
from mxtpu_torch.parallel import build_train_step

from test_torch_symbol import build as build_symbol
from tests.torch_gluon_names import fresh_names

torch.set_num_threads(2)

V, U, H, L, T, MAXLEN = 128, 64, 4, 2, 16, 40
CPU = tmx.cpu()


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
    carried in by name, else xavier weights from the seeded generator,
    its deferred shapes filled by one predict-mode forward."""
    with fresh_names():
        net = BERTModel(V, U, 4 * U, L, H, max_length=MAXLEN,
                        dropout=dropout)
    if params is not None:
        return params_from_mxtpu(params, net)
    net.initialize(init="xavier", ctx=CPU)
    net(torch.zeros(1, T))
    return net


def _jmlm(pred, y):
    return jloss.SoftmaxCrossEntropyLoss()(pred.reshape((-1, V)),
                                           y.reshape((-1,)))


_CE = SoftmaxCrossEntropyLoss()


def _tmlm(pred, y):
    return _CE(pred.reshape(-1, V), y.reshape(-1))


def _seeded_step(monkeypatch, batched, opt="adam", kw=None, cd=None,
                 dropout=0.1, net=None, loss=_tmlm, cast_batch=False):
    """The port's step on a BERT from fixed torch and dropout seeds, on
    the bucketed or the per-parameter path."""
    monkeypatch.setenv("MXTPU_BATCHED_OPT", "1" if batched else "0")
    torch.manual_seed(0)
    trandom.seed(0)
    net = net() if net is not None else _torch_bert(dropout=dropout)
    return build_train_step(net, loss, opt,
                            kw or {"learning_rate": 1e-3, "wd": 1e-3},
                            compute_dtype=cd, cast_batch=cast_batch,
                            device="cpu")


def _snapshot(step):
    """Every parameter, buffer and optimizer-state leaf, copied."""
    return ([t.detach().clone() for _, t in step.net.named_parameters()] +
            [t.detach().clone() for _, t in step.net.named_buffers()] +
            [leaf.detach().clone() for st in step._canonical_state()
             for leaf in st])


def _assert_bit_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ------------------------------------------------------------ the rules

RULES = [("sgd", {"learning_rate": 0.1, "wd": 1e-3}),
         ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3,
                  "clip_gradient": 0.5}),
         ("adam", {"learning_rate": 0.01, "wd": 1e-3,
                   "rescale_grad": 0.5}),
         ("rmsprop", {"learning_rate": 0.01, "wd": 1e-3}),
         ("lamb", {"learning_rate": 0.01, "wd": 1e-2})]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,kw", RULES,
                         ids=["sgd", "sgd-momentum", "adam", "rmsprop",
                              "lamb"])
def test_stacked_rule_equals_per_parameter(name, kw, dtype):
    """Three parameters of one shape stacked, updated in place three
    times with per-slice lr/wd tensors, against each parameter updated
    on its own by the functional rule with Python floats."""
    dt = getattr(torch, dtype)
    init, update = functional.opt_rule(create(name, **kw))
    rng = np.random.RandomState(3)
    ws = [torch.from_numpy(rng.randn(4, 5).astype(np.float32)).to(dt)
          for _ in range(3)]
    lrs, wds = [0.1, 0.05, 0.0], [1e-3, 0.0, 2e-3]
    per = [(w.clone(), init(w.clone())) for w in ws]
    w_s = torch.stack(ws)
    st_s = init(w_s, stacked=True)
    bshape = (3, 1, 1)
    lr_t = torch.tensor(lrs).reshape(bshape)
    wd_t = torch.tensor(wds).reshape(bshape)
    for it in range(3):
        gs = [torch.from_numpy(rng.randn(4, 5).astype(np.float32)).to(dt)
              for _ in range(3)]
        per = [update(w, g, st, lr, wd)
               for (w, st), g, lr, wd in zip(per, gs, lrs, wds)]
        w2, st2 = update(w_s, torch.stack(gs), st_s, lr_t, wd_t,
                         stacked=True, inplace=True)
        assert w2 is w_s and all(a is b for a, b in zip(st2, st_s))
    assert w_s.dtype == dt
    for a, (w, st) in enumerate(per):
        got = [w_s[a]] + [leaf[a] for leaf in st_s]
        want = [w] + list(st)
        for x, y in zip(got, want):
            assert x.dtype == y.dtype and x.shape == y.shape
            if name == "lamb":
                np.testing.assert_allclose(x.float().numpy(),
                                           y.float().numpy(), rtol=1e-5,
                                           atol=1e-6)
            else:
                assert torch.equal(x, y)


def test_rules_refuse_other_optimizers():
    for name in ("nag", "adagrad", "ftrl", "signum", "sgld"):
        with pytest.raises(MXNetError, match="supports SGD/Adam/RMSProp"
                           "/LAMB; got"):
            functional.opt_rule(create(name))
    with pytest.raises(MXNetError, match="got RMSProp"):
        functional.opt_rule(create("rmsprop", centered=True))
    # LBSGD and ccSGD are SGD
    for name in ("lbsgd", "ccSGD"):
        functional.opt_rule(create(name, momentum=0.9))


# ------------------------------------------------------- the update ops

def _np(*shapes, seed=0, pos=()):
    rng = np.random.RandomState(seed)
    out = []
    for i, s in enumerate(shapes):
        a = rng.randn(*s).astype(np.float32)
        out.append(np.abs(a) if i in pos else a)
    return out


S = (3, 7)
OPS = [
    ("sgd_update", _np(S, S), {"lr": 0.1, "wd": 1e-2,
                                 "clip_gradient": 0.5}),
    ("sgd_mom_update", _np(S, S, S), {"lr": 0.1, "momentum": 0.9,
                                        "wd": 1e-2}),
    ("adam_update", _np(S, S, S, S, pos=(3,)),
     {"lr": 0.01, "wd": 1e-2, "rescale_grad": 0.5}),
    ("rmsprop_update", _np(S, S, S, pos=(2,)),
     {"lr": 0.01, "wd": 1e-2, "clip_weights": 0.8}),
    ("rmspropalex_update", _np(S, S, S, S, S, pos=(2,)),
     {"lr": 0.01, "wd": 1e-2}),
    ("ftrl_update", _np(S, S, S, S, pos=(3,)), {"lr": 0.1, "wd": 1e-2}),
    ("signsgd_update", _np(S, S), {"lr": 0.1, "wd": 1e-2}),
    ("signum_update", _np(S, S, S), {"lr": 0.1, "wd": 1e-2}),
    ("signum_update", _np(S, S, S), {"lr": 0.1, "wd": 1e-2,
                                       "wd_lh": 1e-2}),
    ("multi_sgd_update", _np(S, S, (5,), (5,)),
     {"lrs": (0.1, 0.2), "wds": (0.0, 1e-2), "num_weights": 2}),
    ("multi_sgd_mom_update", _np(S, S, S, (5,), (5,), (5,)),
     {"lrs": (0.1, 0.2), "wds": (0.0, 1e-2), "momentum": 0.9,
      "num_weights": 2}),
]


@pytest.mark.parametrize("name,arrays,kw", OPS,
                         ids=[o[0] + ("-wd_lh" if "wd_lh" in o[2] else "")
                              for o in OPS])
def test_update_op_matches_mxtpu(name, arrays, kw):
    """Each update op through ``nd`` in both packages, same inputs:
    1e-6 relative."""
    want = getattr(nd, name)(*[nd.array(a) for a in arrays], **kw)
    got = getattr(tmx.nd, name)(*[tmx.nd.array(a, ctx=CPU)
                                  for a in arrays], **kw)
    want = want if isinstance(want, (tuple, list)) else [want]
    got = got if isinstance(got, (tuple, list)) else [got]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("stacked", [False, True])
def test_lamb_op_matches_mxtpu(stacked):
    """``lamb_update`` per tensor and stacked, with per-slice step
    counts: 1e-6 relative."""
    w, g, m, v = _np((3, 4, 5), (3, 4, 5), (3, 4, 5), (3, 4, 5), pos=(3,))
    t = np.array([1, 4, 9], np.int32) if stacked else np.array(3, np.int32)
    kw = {"lr": 0.01, "wd": 1e-2, "stacked": stacked}
    want = nd.lamb_update(*[nd.array(a) for a in (w, g, m, v, t)], **kw)
    got = tmx.nd.lamb_update(*[tmx.nd.array(a, ctx=CPU)
                               for a in (w, g, m, v, t)], **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=1e-6,
                                   atol=1e-7)


# ------------------------------------------------------- the schedulers

def _scheds(mod):
    return {
        "factor": lambda **w: mod.FactorScheduler(
            step=7, factor=0.7, stop_factor_lr=2e-3, base_lr=0.1, **w),
        "multifactor": lambda **w: mod.MultiFactorScheduler(
            [10, 20, 33], factor=0.5, base_lr=0.1, **w),
        "poly": lambda **w: mod.PolyScheduler(50, base_lr=0.1, pwr=2,
                                              final_lr=1e-3, **w),
        "cosine": lambda **w: mod.CosineScheduler(50, base_lr=0.1,
                                                  final_lr=1e-3, **w)}


WARMUPS = {"none": {},
           "linear": {"warmup_steps": 5, "warmup_begin_lr": 0.01},
           "constant": {"warmup_steps": 5, "warmup_begin_lr": 0.01,
                        "warmup_mode": "constant"}}


@pytest.mark.parametrize("warmup", list(WARMUPS))
@pytest.mark.parametrize("kind", ["factor", "multifactor", "poly",
                                  "cosine"])
def test_scheduler_matches_mxtpu(kind, warmup):
    """The lr at update counts 0..60, straight and through an optimizer
    (which overrides the scheduler's base_lr, as mxtpu's does): equal
    as Python floats."""
    j = _scheds(jls)[kind](**WARMUPS[warmup])
    t = _scheds(tls)[kind](**WARMUPS[warmup])
    assert [t(n) for n in range(61)] == [j(n) for n in range(61)]
    jo = jopt.create("sgd", learning_rate=0.05,
                     lr_scheduler=_scheds(jls)[kind](**WARMUPS[warmup]))
    to = create("sgd", learning_rate=0.05,
                lr_scheduler=_scheds(tls)[kind](**WARMUPS[warmup]))
    got, want = [], []
    for n in range(61):
        jo.num_update = to.num_update = n
        got.append(to.learning_rate)
        want.append(jo.learning_rate)
    assert got == want


def test_scheduler_arguments_raise_as_mxtpu():
    for bad in (lambda m: m.FactorScheduler(0),
                lambda m: m.FactorScheduler(2, factor=1.5),
                lambda m: m.MultiFactorScheduler([3, 2]),
                lambda m: m.MultiFactorScheduler([0, 2]),
                lambda m: m.LRScheduler(warmup_mode="cubic")):
        with pytest.raises(jmx.MXNetError):
            bad(jls)
        with pytest.raises(MXNetError):
            bad(tls)
    with pytest.raises(NotImplementedError):
        tls.LRScheduler()(3)


def test_module_fit_follows_the_scheduler_as_mxtpu(monkeypatch):
    """``Module.fit(optimizer_params={"lr_scheduler": ...,
    "begin_num_update": 2})`` on ``module_mlp``'s network: the lr of
    every update, read by a batch-end callback, and the final update
    count equal mxtpu's."""
    rng = np.random.RandomState(4)
    X = rng.rand(48, 784).astype(np.float32)
    y = rng.randint(0, 10, 48).astype(np.float32)
    runs = []
    for mx, pkg, kw in ((jmx, "mxtpu", {}),
                        (tmx, "port", {"context": CPU})):
        mod = mx.mod.Module(build_symbol(pkg, "mlp", monkeypatch), **kw)
        lrs = []
        mod.fit(mx.io.NDArrayIter(X, y, batch_size=8), optimizer="sgd",
                num_epoch=2, initializer=mx.init.Xavier(),
                optimizer_params={
                    "learning_rate": 0.1, "momentum": 0.9,
                    "begin_num_update": 2,
                    "lr_scheduler": mx.lr_scheduler.MultiFactorScheduler(
                        [4, 7, 10], factor=0.5)},
                batch_end_callback=lambda p: lrs.append(
                    p.locals["self"]._optimizer.learning_rate))
        runs.append((lrs, mod._optimizer.num_update))
    (jl, jn), (tl, tn) = runs
    assert tl == jl and tn == jn == 2 + 12
    assert len(set(tl)) == 4


# ------------------------------------------- the eager optimizers (Updater)

OPTIMIZERS = [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("ccSGD", {"learning_rate": 0.1, "clip_gradient": 0.5}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("adam", {"learning_rate": 0.01, "wd": 1e-3}),
    ("adagrad", {"learning_rate": 0.1, "wd": 1e-3, "rescale_grad": 0.5}),
    # mxtpu's NDArray-arithmetic optimizers raise with clip_gradient
    # set (their nd.clip call passes a_min twice), so none sets it here
    ("adadelta", {"wd": 1e-3, "rescale_grad": 0.5}),
    ("adamax", {"learning_rate": 0.01, "wd": 1e-3}),
    ("nadam", {"learning_rate": 0.01, "wd": 1e-3}),
    ("rmsprop", {"learning_rate": 0.01, "clip_weights": 2.0}),
    ("rmsprop", {"learning_rate": 0.01, "centered": True, "wd": 1e-3}),
    ("lamb", {"learning_rate": 0.01, "wd": 1e-2}),
    ("ftrl", {"learning_rate": 0.1, "wd": 1e-3}),
    ("signum", {"learning_rate": 0.01, "wd": 1e-3}),
    ("signum", {"learning_rate": 0.01, "momentum": 0.0}),
    ("lbsgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("test", {"rescale_grad": 0.1}),
]
OPT_IDS = ["sgd", "ccsgd", "nag", "adam", "adagrad", "adadelta", "adamax",
           "nadam", "rmsprop", "rmsprop-centered", "lamb", "ftrl",
           "signum", "signsgd", "lbsgd", "test"]


def _updater_steps(mx, name, kw, dtype, ctx):
    rng = np.random.RandomState(8)
    ws = [rng.randn(4, 6).astype(np.float32),
          rng.randn(6).astype(np.float32)]
    up = mx.optimizer.get_updater(mx.optimizer.create(name, **kw))
    arrs = [mx.nd.array(w, **ctx).astype(dtype) for w in ws]
    for _ in range(5):
        for i, w in enumerate(ws):
            g = mx.nd.array(rng.randn(*w.shape).astype(np.float32),
                            **ctx).astype(dtype)
            up(i, g, arrs[i])
    return ws, arrs, up


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,kw", OPTIMIZERS, ids=OPT_IDS)
def test_optimizer_through_updater_matches_mxtpu(name, kw, dtype):
    """Five updates of two weights through each package's Updater."""
    w0, jw, ju = _updater_steps(jmx, name, kw, dtype, {})
    _, tw, tu = _updater_steps(tmx, name, kw, dtype, {"ctx": CPU})
    for j, t, w in zip(jw, tw, w0):
        jn, tn = j.astype("float32").asnumpy(), t.astype("float32").asnumpy()
        assert not np.array_equal(jn, w)    # the weight moved
        if dtype == "float32":
            np.testing.assert_allclose(tn, jn, rtol=1e-6, atol=1e-6)
        else:
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(jn),
                                                      1e-30))) - 7)
            assert (np.abs(tn - jn) <= ulp).all()
    if dtype == "bfloat16":
        for i in range(2):
            jm = ju.states[i][0].asnumpy()
            tm = tu.states[i][0].numpy()
            assert tm.dtype == np.float32
            np.testing.assert_allclose(tm, jm, rtol=1e-3,
                                       atol=1e-3 * np.abs(jm).max())
            # the weight is its master cast down
            np.testing.assert_array_equal(
                tw[i].astype("float32").asnumpy(),
                torch.from_numpy(tm).bfloat16().float().numpy())


def test_every_mxtpu_optimizer_is_registered():
    names = ["SGD", "NAG", "Adam", "AdaGrad", "AdaDelta", "Adamax",
             "Nadam", "RMSProp", "LAMB", "Ftrl", "Signum", "SGLD", "LBSGD",
             "Test"]
    for n in names + ["ccSGD", "ccsgd"]:
        want = type(jopt.create(n)).__name__
        assert type(create(n)).__name__ == want
        assert type(create(n.lower())).__name__ == want
    assert create("ccSGD").__class__ is tmx.optimizer.SGD


def test_sgld_noise_matches_mxtpu_in_distribution():
    """SGLD's step is ``w - lr/2 * g + N(0, lr)``: over 10^5 elements
    the mean of ``w' - (w - lr/2 g)`` is within 5 standard errors of 0
    and its variance within 5 standard errors (sqrt(2/n) lr) of lr, in
    both packages; the port's noise repeats from the seed."""
    n, lr = 100_000, 0.04
    rng = np.random.RandomState(2)
    w, g = rng.randn(n).astype(np.float32), rng.randn(n).astype(np.float32)
    det = w - lr / 2 * g
    for mx, ctx in ((jmx, {}), (tmx, {"ctx": CPU})):
        mx.random.seed(5)
        o = mx.optimizer.create("sgld", learning_rate=lr)
        arr = mx.nd.array(w, **ctx)
        mx.optimizer.get_updater(o)(0, mx.nd.array(g, **ctx), arr)
        noise = arr.asnumpy().astype(np.float64) - det
        assert abs(noise.mean()) <= 5 * np.sqrt(lr / n)
        assert abs(noise.var() - lr) <= 5 * np.sqrt(2.0 / n) * lr
    first = noise
    tmx.random.seed(5)
    arr = tmx.nd.array(w, ctx=CPU)
    tmx.optimizer.get_updater(tmx.optimizer.create(
        "sgld", learning_rate=lr))(0, tmx.nd.array(g, ctx=CPU), arr)
    np.testing.assert_array_equal(arr.asnumpy().astype(np.float64) - det,
                                  first)


# --------------------------------------------------- the bucketed step

def test_buckets_are_views_of_one_tensor_and_the_knob_turns_them_off(
        monkeypatch):
    step = _seeded_step(monkeypatch, True)
    assert len(step._groups) == 11 and len(step._params) == 31
    for group, w in zip(step._groups, step._stacks):
        assert (w is None) == (len(group) == 1)
        if w is None:
            continue
        assert w.is_contiguous() and w.shape[0] == len(group)
        for a, j in enumerate(group):
            p = step._params[j]
            assert p.data_ptr() == w[a].data_ptr()
            assert tuple(p.shape) == tuple(w.shape[1:])
    assert knobs.get("MXTPU_BATCHED_OPT") is True
    per = _seeded_step(monkeypatch, False)
    assert all(len(g) == 1 for g in per._groups) and \
        all(w is None for w in per._stacks)
    monkeypatch.delenv("MXTPU_BATCHED_OPT")
    monkeypatch.setenv("MXNET_BATCHED_OPT", "0")
    assert knobs.get("MXTPU_BATCHED_OPT") is False


@pytest.mark.parametrize("cd", [None, "bfloat16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("opt,kw", [
    ("adam", {"learning_rate": 1e-3, "wd": 1e-3}),
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-3}),
    ("rmsprop", {"learning_rate": 1e-3}),
    ("lamb", {"learning_rate": 1e-2, "wd": 1e-2})],
    ids=["adam", "sgd-momentum", "rmsprop", "lamb"])
def test_bucketed_step_equals_per_parameter_step(monkeypatch, opt, kw, cd):
    """Five steps of BERT with dropout on, from the same seeds, on the
    two update paths: losses, parameters and every state leaf bit for
    bit (LAMB to its stated tolerance)."""
    x = _tokens(1)
    runs = []
    for batched in (True, False):
        step = _seeded_step(monkeypatch, batched, opt, kw, cd)
        losses = [float(step(x, x)) for _ in range(5)]
        runs.append((losses, _snapshot(step)))
    (la, sa), (lb, sb) = runs
    if opt == "lamb":
        np.testing.assert_allclose(la, lb, rtol=1e-5, atol=1e-7)
        for a, b in zip(sa, sb):
            np.testing.assert_allclose(a.float().numpy(),
                                       b.float().numpy(), rtol=1e-5,
                                       atol=1e-6)
    else:
        assert la == lb
        _assert_bit_equal(sa, sb)


def _resnet():
    with fresh_names():
        net = ResNetV1(BottleneckV1, [1, 1, 1, 1], [8, 16, 32, 64, 128],
                       classes=10, layout="NHWC")
    net.initialize(init="xavier", ctx=CPU)
    net(torch.zeros(1, 32, 32, 3))
    return net


def test_bucketed_resnet_step_equals_per_parameter_step(monkeypatch):
    """The narrow NHWC ResNet, SGD momentum, three steps: losses,
    parameters, BatchNorm's running statistics (which stay outside the
    buckets) and the momenta bit for bit."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    y = np.array([1.0, 7.0], np.float32)
    runs = []
    for batched in (True, False):
        step = _seeded_step(monkeypatch, batched, "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9,
                             "wd": 1e-4}, net=_resnet,
                            loss=SoftmaxCrossEntropyLoss(),
                            cast_batch=True)
        losses = [float(step(x, y)) for _ in range(3)]
        runs.append((losses, _snapshot(step), len(step._groups)))
    (la, sa, na), (lb, sb, nb) = runs
    assert na < nb
    assert la == lb
    _assert_bit_equal(sa, sb)


def test_a_rebound_parameter_is_repacked(monkeypatch):
    """A parameter rebound after the step was built (``p.data = ...``)
    is updated from its new value: the step then equals a fresh
    per-parameter step on the same weights, bit for bit."""
    x = _tokens(2)
    step = _seeded_step(monkeypatch, True, dropout=0.0)
    p = dict(step.net.named_parameters())["encoder.layers.0.ffn.ffn1.weight"]
    j = step.param_names.index(step.net.encoder.layers[0].ffn.ffn1.weight
                               .name)
    k, group = next((k, g) for k, g in enumerate(step._groups) if j in g)
    assert len(group) > 1
    p.data = p.detach() * 0.5 + 0.01
    snap = {n: t.detach().clone() for n, t in step.net.named_parameters()}
    want_net = _torch_bert(dropout=0.0)
    with torch.no_grad():
        for n, t in want_net.named_parameters():
            t.copy_(snap[n])
    monkeypatch.setenv("MXTPU_BATCHED_OPT", "0")
    want = build_train_step(want_net, _tmlm, "adam",
                            {"learning_rate": 1e-3, "wd": 1e-3},
                            cast_batch=False, device="cpu")
    for _ in range(2):
        assert float(step(x, x)) == float(want(x, x))
    _assert_bit_equal(_snapshot(step), _snapshot(want))
    # re-packed: the parameter is a view of its bucket again
    assert p.data_ptr() == step._stacks[k][group.index(j)].data_ptr()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lr_mult_per_slice_in_a_bucket(monkeypatch, dtype):
    """Parameters of one bucket with different lr multipliers (an f32
    lr tensor per slice) equal the per-parameter path bit for bit; so
    do bf16 parameters without f32 masters (``multi_precision=False``),
    which the bucket then updates slice by slice."""
    x = _tokens(3)
    kw = {"learning_rate": 1e-3, "wd": 1e-3}
    if dtype == "bfloat16":
        kw["multi_precision"] = False
    runs = []
    for batched in (True, False):
        step = _seeded_step(
            monkeypatch, batched, kw=kw, dropout=0.0,
            net=lambda: _torch_bert(dropout=0.0).to(getattr(torch, dtype)))
        # by mxtpu's names, as mxtpu's step reads the multipliers
        cells = step.net.encoder.layers
        lm = {cells[0].ffn.ffn1.weight.name: 0.25,
              cells[1].ffn.ffn1.weight.name: 0.0}
        wm = {cells[0].ffn.ffn2.weight.name: 3.0}
        assert set(lm) | set(wm) <= set(step.param_names)
        step.optimizer.set_lr_mult(lm)
        step.optimizer.set_wd_mult(wm)
        losses = [float(step(x, x)) for _ in range(3)]
        runs.append((losses, _snapshot(step)))
    assert runs[0][0] == runs[1][0]
    _assert_bit_equal(runs[0][1], runs[1][1])


# ------------------------------------------------------ against mxtpu

def _parity_pair(monkeypatch, opt, kw, cd=None):
    """The port's bucketed step and mxtpu's per-parameter step on the
    same BERT weights, dropout 0."""
    jnet = _jax_bert()
    tnet = _torch_bert(_jax_params(jnet))
    monkeypatch.delenv("MXTPU_BATCHED_OPT", raising=False)
    tstep = build_train_step(tnet, _tmlm, opt, dict(kw), device="cpu",
                             cast_batch=False, compute_dtype=cd)
    assert len(tstep._groups) < len(tstep._params)
    monkeypatch.setenv("MXTPU_BATCHED_OPT", "0")
    jstep = jpar.build_train_step(jnet, _jmlm, opt, dict(kw), cache=None,
                                  cast_batch=False, compute_dtype=cd)
    return jnet, tnet, jstep, tstep


@pytest.mark.parametrize("opt,kw,cd,tol", [
    ("adam", {"learning_rate": 1e-3, "wd": 1e-3}, None, 1e-5),
    ("adam", {"learning_rate": 1e-3}, "bfloat16", 2e-2),
    ("lamb", {"learning_rate": 1e-2, "wd": 1e-2}, None, 1e-5),
    ("rmsprop", {"learning_rate": 1e-3}, None, 1e-5)],
    ids=["adam-f32", "adam-bf16", "lamb", "rmsprop"])
def test_bucketed_step_matches_mxtpu_per_parameter_step(monkeypatch, opt,
                                                        kw, cd, tol):
    jnet, tnet, jstep, tstep = _parity_pair(monkeypatch, opt, kw, cd)
    x = _tokens(1)
    want = [float(jstep(nd.array(x), nd.array(x)).asnumpy())
            for _ in range(5)]
    got = [float(tstep(x, x)) for _ in range(5)]
    np.testing.assert_allclose(got, want, rtol=tol)
    if cd is None and opt == "adam":
        jp = _jax_params(jnet)
        tp = params_to_mxtpu(tnet, list(jp))
        for n in jp:
            np.testing.assert_allclose(tp[n], jp[n], rtol=1e-4, atol=1e-4,
                                       err_msg=n)


@pytest.mark.parametrize("reuse_batch", [False, True])
def test_run_steps_matches_mxtpu(monkeypatch, reuse_batch):
    """``run_steps(x, y, 3)`` with adam in both packages: the (3,)
    losses 1e-5, the parameters 1e-4; lr/wd sampled once a call, at the
    call's last step (``_t`` advanced by 3 first)."""
    jnet, tnet, jstep, tstep = _parity_pair(
        monkeypatch, "adam", {"learning_rate": 1e-3, "wd": 1e-3})
    x = _tokens(5, b=2 if reuse_batch else 6)
    want = jstep.run_steps(nd.array(x), nd.array(x), 3,
                           reuse_batch=reuse_batch).asnumpy()
    got = tstep.run_steps(x, x, 3, reuse_batch=reuse_batch)
    assert got.shape == (3,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    assert tstep._t == jstep._t == 3
    want2 = jstep.run_steps(nd.array(x), nd.array(x), 3,
                            reuse_batch=reuse_batch).asnumpy()
    got2 = tstep.run_steps(x, x, 3, reuse_batch=reuse_batch)
    np.testing.assert_allclose(got2.numpy(), want2, rtol=1e-5)
    jp = _jax_params(jnet)
    tp = params_to_mxtpu(tnet, list(jp))
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], rtol=1e-4, atol=1e-4,
                                   err_msg=n)


def test_run_steps_argument_errors_raise_as_mxtpu(monkeypatch):
    jnet, tnet, jstep, tstep = _parity_pair(
        monkeypatch, "adam", {"learning_rate": 1e-3})
    for steps, b in ((0, 2), (-2, 2), (2, 3), (4, 6)):
        x = _tokens(0, b=b)
        with pytest.raises(jmx.MXNetError) as je:
            jstep.run_steps(nd.array(x), nd.array(x), steps)
        with pytest.raises(MXNetError) as te:
            tstep.run_steps(x, x, steps)
        assert str(te.value) == str(je.value)
    assert tstep._t == 0


def test_run_steps_equals_eager_steps_where_the_lr_agrees(monkeypatch):
    """Constant-lr SGD momentum: ``run_steps(x, y, 3)`` over three
    microbatches equals three eager calls on them, and with adam three
    ``run_steps(..., 1)`` calls equal three eager calls, bit for bit,
    dropout on; with adam, ``run_steps(..., 3)`` takes step 3's bias
    correction for every step, so it differs."""
    xs = _tokens(6, b=6)
    sgd = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-3}
    a = _seeded_step(monkeypatch, True, "sgd", sgd)
    got = a.run_steps(xs, xs, 3)
    b = _seeded_step(monkeypatch, True, "sgd", sgd)
    want = [b(xs[2 * i:2 * i + 2], xs[2 * i:2 * i + 2]) for i in range(3)]
    assert got.tolist() == [float(v) for v in want]
    _assert_bit_equal(_snapshot(a), _snapshot(b))
    x = xs[:2]
    a = _seeded_step(monkeypatch, True)
    got = [a.run_steps(x, x, 1) for _ in range(3)]
    b = _seeded_step(monkeypatch, True)
    want = [b(x, x) for _ in range(3)]
    assert [float(v[0]) for v in got] == [float(v) for v in want]
    _assert_bit_equal(_snapshot(a), _snapshot(b))
    c = _seeded_step(monkeypatch, True)
    c.run_steps(x, x, 3, reuse_batch=True)
    assert c._t == 3
    assert not all(torch.equal(p, q) for p, q in
                   zip(_snapshot(c), _snapshot(b)))


# ------------------------------------------------------- checkpoints

@pytest.mark.parametrize("opt,kw", [
    ("adam", {"learning_rate": 1e-3, "wd": 1e-3}),
    ("lamb", {"learning_rate": 1e-2, "wd": 1e-2})])
def test_save_load_states_across_paths_and_packages(monkeypatch, tmp_path,
                                                    opt, kw):
    """Three steps, then ``save_states``; the port's step resumes from
    the file on the other update path bit for bit; mxtpu's per-parameter
    step reads the port's file and the port reads mxtpu's, and the
    resumed steps agree (losses 1e-5, parameters 1e-4)."""
    x = _tokens(7)
    jnet, tnet, jstep, tstep = _parity_pair(monkeypatch, opt, kw)
    for _ in range(3):
        jstep(nd.array(x), nd.array(x))
        tstep(x, x)
    tfile, jfile = str(tmp_path / "port.states"), str(tmp_path / "j.states")
    tstep.save_states(tfile)
    jstep.save_states(jfile)
    with open(tfile, "rb") as f:
        blob = pickle.load(f)
    assert blob["t"] == 3 and len(blob["opt_state"]) == 31
    assert all(isinstance(leaf, np.ndarray) for st in blob["opt_state"]
               for leaf in st)
    if opt == "lamb":
        assert all(st[2].shape == () and int(st[2]) == 3
                   for st in blob["opt_state"])
    weights = {n: t.detach().clone() for n, t in tnet.named_parameters()}

    def resumed(batched, fname):
        net = _torch_bert()
        with torch.no_grad():
            for n, t in net.named_parameters():
                t.copy_(weights[n])
        monkeypatch.setenv("MXTPU_BATCHED_OPT", "1" if batched else "0")
        step = build_train_step(net, _tmlm, opt, dict(kw), device="cpu",
                                cast_batch=False)
        step.load_states(fname)
        assert step._t == 3
        return step

    # the port's own: both paths resume where the saving step goes on
    cont = [float(tstep(x, x)) for _ in range(2)]
    for batched in (True, False):
        s = resumed(batched, tfile)
        got = [float(s(x, x)) for _ in range(2)]
        if batched or opt != "lamb":
            assert got == cont
            _assert_bit_equal(_snapshot(s), _snapshot(tstep))
        else:
            np.testing.assert_allclose(got, cont, rtol=1e-5)
    # across the packages: the port resumes from mxtpu's file, mxtpu
    # from the port's
    s = resumed(True, jfile)
    got = [float(s(x, x)) for _ in range(2)]
    np.testing.assert_allclose(got, cont, rtol=1e-5)
    jnet2 = _jax_bert()
    for p, n in zip(jnet2.collect_params().values(), weights):
        p.set_data(nd.array(weights[n].numpy()))
    jstep2 = jpar.build_train_step(jnet2, _jmlm, opt, dict(kw), cache=None,
                                   cast_batch=False)
    jstep2.load_states(tfile, x_example=nd.array(x))
    want = [float(jstep2(nd.array(x), nd.array(x)).asnumpy())
            for _ in range(2)]
    np.testing.assert_allclose(cont, want, rtol=1e-5)


def test_load_states_refuses_another_structure(monkeypatch, tmp_path):
    a = _seeded_step(monkeypatch, True)
    a.save_states(str(tmp_path / "a"))
    b = _seeded_step(monkeypatch, True, "sgd", {"learning_rate": 0.1,
                                                  "momentum": 0.9})
    with pytest.raises(MXNetError, match="structure mismatch"):
        b.load_states(str(tmp_path / "a"))


# ------------------------------------------------ a module not a Block

def test_plain_module_carries_by_order_and_trains_as_mxtpu(monkeypatch):
    """A ``torch.nn.Module`` that is not a Block: mxtpu's weights go in
    by ``collect_params()`` order, ``TrainStep`` takes its
    ``named_parameters()``, and three SGD-momentum steps with weight
    decay follow mxtpu's step from the same weights (losses 1e-5; the
    weights, carried back under mxtpu's names, 1e-5); a count that
    differs raises."""
    from mxtpu.gluon import nn as jnn
    with fresh_names():
        jnet = jnn.HybridSequential()
        jnet.add(jnn.Dense(16, in_units=8, activation="relu"),
                 jnn.Dense(4, in_units=16))
    jnet.initialize(init="xavier")
    jp = _jax_params(jnet)
    tnet = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                               torch.nn.Linear(16, 4))
    params_from_mxtpu(jp, tnet)
    kw = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}
    tstep = build_train_step(tnet, SoftmaxCrossEntropyLoss(), "sgd",
                             dict(kw), device="cpu", cast_batch=False)
    assert tstep.param_names == ["0.weight", "0.bias", "2.weight",
                                 "2.bias"]
    monkeypatch.setenv("MXTPU_BATCHED_OPT", "0")
    jstep = jpar.build_train_step(jnet, jloss.SoftmaxCrossEntropyLoss(),
                                  "sgd", dict(kw), cache=None,
                                  cast_batch=False)
    rng = np.random.RandomState(3)
    x = rng.randn(6, 8).astype(np.float32)
    y = rng.randint(0, 4, 6).astype(np.float32)
    want = [float(jstep(nd.array(x), nd.array(y)).asnumpy())
            for _ in range(3)]
    got = [float(tstep(x, y)) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    jp = _jax_params(jnet)
    tp = params_to_mxtpu(tnet, list(jp))
    assert list(tp) == list(jp)
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], rtol=1e-5, atol=1e-6,
                                   err_msg=n)
    with pytest.raises(MXNetError, match="5 mxtpu parameters for 4"):
        params_from_mxtpu(dict(jp, extra=np.zeros(1, np.float32)), tnet)
