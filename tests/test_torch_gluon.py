"""Gluon as mxtpu has it, held against mxtpu on the CPU: ``Parameter``
and ``ParameterDict``, ``Block``/``HybridBlock``/``SymbolBlock``,
``Trainer``, the layers, the 11 losses, the utilities, the new
initializers, and BERT and ResNet-50 v1 rebuilt as HybridBlocks under
mxtpu's names.

Nets are small: a 2-layer BERT (units 64, vocab 128) and the narrow
ResNet V1 of ``test_torch_resnet_train.py`` (one bottleneck a stage,
widths 8-128) in NCHW and NHWC; the names of a full ``bert_large()``
and ``resnet50_v1()`` are compared before ``initialize``.  Both
packages build with fresh name counters (``tests/torch_gluon_names``)
and the same seeded numpy inputs; the weights are drawn once in the
port (Xavier) and set into both packages by name.  Tolerances: f32 losses 1e-5 relative and weights 1e-4 after
three steps (sums in another order, amplified by adam's division by
sqrt(v)); bf16 with ``multi_precision`` losses 2e-2 relative and the
f32 masters 2e-2 (one bf16 ulp of a weight near 1 is 2^-7; the forward
rounds at other places); files, JSON and hybridized-vs-eager results
bit for bit; losses 1e-6; the initializers by their statistics.
"""
import functools

import numpy as np
import pytest
import torch

import mxtpu as jmx
from mxtpu import autograd as jautograd, gluon as jgluon, nd as jnd
from mxtpu.gluon import loss as jloss
from mxtpu.gluon.model_zoo.vision import resnet50_v1 as jresnet50_v1
from mxtpu.gluon.model_zoo.vision.resnet import BottleneckV1 as JBottleneck
from mxtpu.gluon.model_zoo.vision.resnet import ResNetV1 as JResNetV1
from mxtpu.models import lenet as jlenet
from mxtpu.models.transformer import BERTModel as JBERT
from mxtpu.models.transformer import bert_large as jbert_large
from mxtpu.module.base_module import BatchEndParam as JBatchEndParam

import mxtpu_torch as tmx
from mxtpu_torch import MXNetError, autograd, gluon, initializer, nd
from mxtpu_torch import random as trandom
from mxtpu_torch.convert import named_tensors, params_from_mxtpu
from mxtpu_torch.gluon import loss as tloss
from mxtpu_torch.gluon import nn
from mxtpu_torch.gluon.model_zoo.vision import (BottleneckV1, ResNetV1,
                                                resnet50_v1)
from mxtpu_torch.models import BERTModel, bert_large, lenet
from mxtpu_torch.module.base_module import BatchEndParam
from mxtpu_torch.parallel import build_train_step

from tests.torch_gluon_names import fresh_names

torch.set_num_threads(2)

CPU = tmx.cpu()
V, U, H, L, T, MAXLEN = 128, 64, 4, 2, 16, 40
RN = ([1, 1, 1, 1], [8, 16, 32, 64, 128], 10)


def _tokens(seed, b=2):
    return np.random.RandomState(seed).randint(0, V, (b, T)) \
        .astype(np.float32)


def _images(layout, seed=0, b=2, hw=32):
    shape = (b, 3, hw, hw) if layout == "NCHW" else (b, hw, hw, 3)
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jparams(net):
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


def _torch_model(model, dropout=0.0):
    """The port's small BERT (``model="bert"``) or narrow ResNet in a
    layout, named as a fresh process names it, and a one-sample batch
    for it."""
    with fresh_names():
        if model == "bert":
            return (BERTModel(V, U, 4 * U, L, H, max_length=MAXLEN,
                              dropout=dropout),
                    torch.from_numpy(_tokens(0)))
        return (ResNetV1(BottleneckV1, *RN[:2], classes=RN[2],
                         layout=model),
                torch.from_numpy(_images(model, b=1)))


@functools.lru_cache(maxsize=None)
def _weights(model):
    """Xavier weights of ``_torch_model(model)`` by mxtpu's names, drawn
    once from a seed, the deferred shapes settled by one forward."""
    trandom.seed(0)
    net, x1 = _torch_model(model)
    net.initialize(init="xavier", ctx=CPU)
    net(x1)
    return tuple((n, t.detach().numpy().copy())
                 for n, t in named_tensors(net))


def _pair(model, dropout=0.0):
    """The same net in both packages, named alike, with the same
    weights: drawn in the port, set into each side by name (mxtpu's
    parameters take their shapes from them)."""
    w = dict(_weights(model))
    with fresh_names():
        jnet = JBERT(V, U, 4 * U, L, H, max_length=MAXLEN,
                     dropout=dropout) if model == "bert" else \
            JResNetV1(JBottleneck, *RN[:2], classes=RN[2], layout=model)
    for n, p in jnet.collect_params().items():
        p.set_data(jnd.array(w[n]))
    return jnet, params_from_mxtpu(w, _torch_model(model, dropout)[0])


def _pair_bert(dropout=0.0):
    return _pair("bert", dropout)


def _pair_resnet(layout):
    return _pair(layout)


def _close_params(jnet, tnet, tol):
    tp = tnet.collect_params()
    assert list(tp) == list(jnet.collect_params())
    for n, p in jnet.collect_params().items():
        np.testing.assert_allclose(
            tp[n].data().asnumpy(), p.data().asnumpy().astype(np.float32),
            rtol=tol, atol=tol, err_msg=n)


# ------------------------------------------------------------- names

@pytest.mark.parametrize("model", ["bert", "NCHW", "NHWC"])
def test_names_shapes_and_order_match_mxtpu(model):
    jnet, tnet = _pair_bert() if model == "bert" else _pair_resnet(model)
    jp, tp = jnet.collect_params(), tnet.collect_params()
    assert list(tp) == list(jp)
    for n in jp:
        assert tp[n].shape == jp[n].shape, n
        assert tp[n].grad_req == jp[n].grad_req, n
    assert [n for n, _ in named_tensors(tnet)] == list(jp)


def test_full_size_names_match_before_initialize():
    """A fresh ``bert_large()`` and ``resnet50_v1()`` (both layouts)
    name their parameters as mxtpu's, in mxtpu's order, and their shapes
    (0 where deferred) agree."""
    for jmake, tmake in ((jbert_large, bert_large),
                         (lambda: jresnet50_v1(layout="NHWC"),
                          lambda: resnet50_v1(layout="NHWC")),
                         (jresnet50_v1, resnet50_v1)):
        with fresh_names():
            jp = jmake().collect_params()
        with fresh_names():
            tp = tmake().collect_params()
        assert list(tp) == list(jp)
        assert [p.shape for p in tp.values()] == \
            [p.shape for p in jp.values()]
    assert len(tp) == 299 and list(jp)[0] == "conv2d0_weight"


# ------------------------------------------------------------- files

@pytest.mark.parametrize("model", ["bert", "NHWC"])
def test_parameter_files_cross_both_ways_bit_for_bit(tmp_path, model):
    jnet, tnet = _pair_bert() if model == "bert" else _pair_resnet(model)
    tf, jf = str(tmp_path / "t.params"), str(tmp_path / "j.params")
    tnet.save_parameters(tf)
    jnet.save_parameters(jf)
    with open(tf, "rb") as a, open(jf, "rb") as b:
        assert a.read() == b.read()
    # mxtpu reads the port's file, the port mxtpu's
    again_j, again_t = _pair_bert() if model == "bert" \
        else _pair_resnet(model)
    for p in again_t.collect_params().values():
        p.set_data(np.zeros(p.shape, np.float32))
    again_t.load_parameters(jf, ctx=CPU)
    again_j.load_parameters(tf)
    for n, p in tnet.collect_params().items():
        np.testing.assert_array_equal(
            again_t.collect_params()[n].data().asnumpy(),
            p.data().asnumpy())
        np.testing.assert_array_equal(
            again_j.collect_params()[n].data().asnumpy(),
            p.data().asnumpy())
    # export's .params: arg:/aux: tags, read by both packages
    tp, jp = tnet.export(str(tmp_path / "t"))[1], \
        jnet.export(str(tmp_path / "j"))[1]
    with open(tp, "rb") as a, open(jp, "rb") as b:
        assert a.read() == b.read()
    assert set(tmx.nd.load_params(tp)) == set(jnet.collect_params())


def test_load_parameters_checks_names(tmp_path):
    _, tnet = _pair_bert()
    f = str(tmp_path / "b.params")
    tnet.save_parameters(f)
    with fresh_names():
        small = BERTModel(V, U, 4 * U, 1, H, max_length=MAXLEN)
    with pytest.raises(MXNetError, match="extra parameters"):
        small.load_parameters(f, ctx=CPU)
    small.load_parameters(f, ctx=CPU, ignore_extra=True)
    with fresh_names():
        big = BERTModel(V, U, 4 * U, 3, H, max_length=MAXLEN)
    with pytest.raises(MXNetError, match="missing parameter"):
        big.load_parameters(f, ctx=CPU)
    big.load_params(f, ctx=CPU, allow_missing=True)


# ------------------------------------------------------------- the loop

def _gluon_loop(mx, autograd, gluon, net, x, y, opt, kw, steps=3):
    """mxtpu's Gluon loop, the same code for either package."""
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), opt, kw)
    L = gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(steps):
        with autograd.record():
            out = net(x)
            loss = L(out, y)
        loss.backward()
        trainer.step(x.shape[0])
        losses.append(loss.asnumpy().astype(np.float32))
    return losses


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("opt,kw", [
    ("adam", {"learning_rate": 1e-3, "wd": 1e-3}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4})],
    ids=["adam", "sgd-momentum"])
def test_gluon_training_loop_matches_mxtpu(opt, kw, dtype):
    """Three Trainer steps of the small BERT (dropout 0) with an
    ``lr_mult`` set on mxtpu's name: losses and weights."""
    jnet, tnet = _pair_bert()
    kw = dict(kw)
    if dtype == "bfloat16":
        jnet.cast("bfloat16")
        tnet.cast("bfloat16")
        kw["multi_precision"] = True
    for net in (jnet, tnet):
        net.collect_params()["dense0_weight"].lr_mult = 0.5
    x, y = _tokens(1), _tokens(2)
    want = _gluon_loop(jmx, jautograd, jgluon, jnet, jnd.array(x),
                       jnd.array(y), opt, kw)
    got = _gluon_loop(tmx, autograd, gluon, tnet, nd.array(x, ctx=CPU),
                      nd.array(y, ctx=CPU), opt, kw)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=tol)
    _close_params(jnet, tnet, 2e-2 if dtype == "bfloat16" else 1e-4)
    if dtype == "bfloat16":
        assert all(p.data().dtype == torch.bfloat16
                   for p in tnet.collect_params().values())


def _mnist_loop(mx, autograd, gluon, nd, lenet, BatchEndParam, X, Y,
                path, params, convert):
    """``examples/train_mnist.py``'s Gluon loop (lines 72-90) with the
    imports passed in; ``convert`` carries the same first weights into
    either package's net."""
    args_lr, batch_size = 0.05, 8
    net = lenet()
    net.initialize(init="xavier", ctx=mx.cpu())
    net(nd.array(X[:1], ctx=mx.cpu()))
    convert(params, net)
    train = mx.io.NDArrayIter(X, Y, batch_size=batch_size)
    metric = mx.metric.Accuracy()
    speed = mx.callback.Speedometer(batch_size, 20)
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": args_lr, "momentum": 0.9})
    L = gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for epoch in range(2):
        train.reset()
        metric.reset()
        for i, batch in enumerate(train):
            x, y = batch.data[0], batch.label[0]
            with autograd.record():
                out = net(x)
                loss = L(out, y)
            loss.backward()
            trainer.step(batch_size)
            metric.update([y], [out])
            speed(BatchEndParam(epoch, i, metric, None))
            losses.append(loss.asnumpy())
    net.save_parameters(path)
    return net, losses


def test_train_mnist_loop_runs_with_only_the_imports_changed(tmp_path):
    rng = np.random.RandomState(0)
    X = rng.rand(16, 1, 28, 28).astype(np.float32)
    Y = rng.randint(0, 10, 16).astype(np.float32)
    with fresh_names():
        first = jlenet()
    first.initialize(init="xavier")
    first(jnd.array(X[:1]))

    def jconvert(params, net):
        for n, p in net.collect_params().items():
            p.set_data(jnd.array(params[n]))
    with fresh_names():
        jnet, want = _mnist_loop(jmx, jautograd, jgluon, jnd, jlenet,
                                 JBatchEndParam, X, Y,
                                 str(tmp_path / "j.params"),
                                 _jparams(first), jconvert)
    with fresh_names():
        tnet, got = _mnist_loop(tmx, autograd, gluon, nd, lenet,
                                BatchEndParam, X, Y,
                                str(tmp_path / "t.params"),
                                _jparams(first), params_from_mxtpu)
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-4,
                               atol=1e-5)
    back = tmx.nd.load(str(tmp_path / "t.params"), ctx=CPU)
    assert list(back)[:2] == ["0.weight", "0.bias"]


def test_gluon_step_equals_train_step(monkeypatch):
    """One Trainer step and one ``TrainStep`` step from the same weights
    and batch (f32, dropout 0, per-parameter update): the same loss and
    the same weights bit for bit (the sum-loss gradient times rescale
    1/B and the mean-loss gradient differ by a power of two only), but
    for the word embedding: the CPU's scatter-add sums the gradients of
    duplicate tokens in a thread-dependent order, and one adam step
    moves a weight by at most lr, so two rows part by at most 2 lr."""
    monkeypatch.setenv("MXTPU_BATCHED_OPT", "0")
    jnet, a = _pair_bert()
    with fresh_names():
        b = BERTModel(V, U, 4 * U, L, H, max_length=MAXLEN, dropout=0.0)
    params_from_mxtpu(_jparams(jnet), b)
    x, y = _tokens(3), _tokens(4)
    loss_fn = tloss.SoftmaxCrossEntropyLoss()
    got = _gluon_loop(tmx, autograd, gluon, a, nd.array(x, ctx=CPU),
                      nd.array(y, ctx=CPU), "adam",
                      {"learning_rate": 1e-3}, steps=1)[0]
    step = build_train_step(b, loss_fn, "adam", {"learning_rate": 1e-3},
                            cast_batch=False, device="cpu")
    want = float(step(x, y))
    assert float(np.float32(got.mean())) == pytest.approx(want, rel=1e-6)
    for (n, p), q in zip(a.collect_params().items(),
                         b.collect_params().values()):
        if n == a.word_embed.weight.name:
            np.testing.assert_allclose(p.data().asnumpy(),
                                       q.data().asnumpy(), rtol=0,
                                       atol=2 * 1e-3, err_msg=n)
        else:
            np.testing.assert_array_equal(p.data().asnumpy(),
                                          q.data().asnumpy(), err_msg=n)


# ------------------------------------------------- modes, hybridize, init

def test_training_mode_follows_autograd_as_in_mxtpu():
    """Dropout and BatchNorm read ``autograd.is_training()``: off under
    ``record(train_mode=False)``, on under ``train_mode()`` without
    ``record``, in both packages."""
    x = np.random.RandomState(1).randn(4, 3, 4, 4).astype(np.float32)
    with fresh_names():
        jbn, jd = jgluon.nn.BatchNorm(), jgluon.nn.Dropout(0.5)
    with fresh_names():
        tbn, td = nn.BatchNorm(), nn.Dropout(0.5)
    jbn.initialize()
    tbn.initialize(ctx=CPU)
    jx, tx = jnd.array(x), nd.array(x, ctx=CPU)
    for jscope, tscope, training in (
            (jautograd.record(train_mode=False),
             autograd.record(train_mode=False), False),
            (jautograd.train_mode(), autograd.train_mode(), True)):
        with jscope:
            jy, jz = jbn(jx), jd(jx)
        with tscope:
            ty, tz = tbn(tx), td(tx)
        np.testing.assert_allclose(ty.asnumpy(), jy.asnumpy(), atol=1e-5)
        np.testing.assert_allclose(tbn.running_mean.data().asnumpy(),
                                   jbn.running_mean.data().asnumpy(),
                                   atol=1e-6)
        assert np.array_equal(tz.asnumpy(), x) == (not training)
        assert np.array_equal(jz.asnumpy(), x) == (not training)
    assert np.abs(tbn.running_mean.data().asnumpy()).max() > 0


def test_hybridize_gives_the_eager_outputs_and_gradients():
    _, net = _pair_bert()
    x = nd.array(_tokens(5), ctx=CPU)

    def run():
        with autograd.record():
            out = net(x)
        out.backward()
        return out.asnumpy(), [p.grad().asnumpy() for p in
                               net.collect_params().values()]
    out, grads = run()
    net.hybridize(static_alloc=True, static_shape=True)
    assert net._active and net._flags["static_alloc"]
    assert net.encoder._active
    out2, grads2 = run()
    np.testing.assert_array_equal(out2, out)
    for a, b in zip(grads2, grads):
        np.testing.assert_array_equal(a, b)


def test_deferred_init_of_dense_conv_and_norms():
    x = torch.from_numpy(np.random.RandomState(2).randn(
        2, 5, 6, 6).astype(np.float32))
    dense, conv = nn.Dense(7), nn.Conv2D(4, 3, padding=1)
    bn, ln, inn = nn.BatchNorm(), nn.LayerNorm(), nn.InstanceNorm()
    frln = nn.FusedResidualLayerNorm(0.0)
    for b in (dense, conv, bn, ln, inn, frln):
        b.initialize(ctx=CPU)
        assert 0 in next(iter(b.collect_params().values())).shape
    assert dense(x).shape == (2, 7) and dense.weight.shape == (7, 180)
    assert conv(x).shape == (2, 4, 6, 6) and \
        conv.weight.shape == (4, 5, 3, 3)
    assert bn(x).shape == x.shape and bn.gamma.shape == (5,)
    assert ln(x).shape == x.shape and ln.gamma.shape == (6,)
    assert inn(x).shape == x.shape and inn.beta.shape == (5,)
    assert frln(x, x).shape == x.shape and frln.bias.shape == (6,)
    # initialize defaults to the card, as every entry point
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="CUDA is not available"):
            nn.Dense(3, in_units=2).initialize()


def test_a_parameter_attached_after_the_first_forward_is_initialized():
    """A HybridBlock stops looking for deferred parameters once each has
    its tensor; a Parameter attached later without one brings the look
    back at the next forward, which gives it its shape and data."""
    class Scale(gluon.HybridBlock):
        def _infer_params(self, x):
            for p in self._reg_params.values():
                if p.shape == (0,):
                    p.shape = (int(x.shape[-1]),)

        def hybrid_forward(self, F, x, **params):
            for w in params.values():
                x = F.broadcast_mul(x, w)
            return x
    blk = Scale()
    blk.a = blk.params.get("a", shape=(0,), init=initializer.One(),
                           allow_deferred_init=True)
    blk.initialize(ctx=CPU)
    x = torch.ones(2, 3)
    assert torch.equal(blk(x), x) and blk._settled
    blk.b = blk.params.get("b", shape=(0,), init=initializer.Constant(2.0),
                           allow_deferred_init=True)
    assert not blk._settled
    blk.b.initialize(ctx=CPU)
    assert torch.equal(blk(x), 2 * x) and blk.b.shape == (3,)
    assert blk._settled


def test_remat_argument_raises_and_set_remat_keeps_its_flag():
    """remat=True builds and sets every encoder cell's flag (the
    rematerialization itself is tests/test_torch_remat.py's);
    ``set_remat`` keeps its flag and, without grad, the block runs as
    before."""
    for make in (lambda: bert_large(remat=True),
                 lambda: BERTModel(64, 16, 32, 1, 2, remat=True)):
        net = make()
        assert all(cell._remat for cell in net.encoder.layers)
    _, net = _pair_bert()
    x = torch.from_numpy(_tokens(6))
    with torch.no_grad():
        out = net(x)
    cell = net.encoder.layers[0]
    assert cell.set_remat(True) is cell and cell._remat
    with torch.no_grad():
        assert torch.equal(net(x), out)


def test_block_api():
    with fresh_names():
        net = nn.HybridSequential()
        net.add(nn.Dense(4, in_units=3, activation="relu"),
                nn.Dense(2, in_units=4))
    assert net.prefix == "hybridsequential0_" and net.name == \
        "hybridsequential0"
    assert list(net.collect_params()) == ["dense0_weight", "dense0_bias",
                                          "dense1_weight", "dense1_bias"]
    assert list(net.collect_params(".*bias")) == ["dense0_bias",
                                                  "dense1_bias"]
    assert list(net._collect_params_with_prefix()) == [
        "0.weight", "0.bias", "1.weight", "1.bias"]
    with net.name_scope():
        pass
    net.initialize(ctx=CPU)
    seen = []
    net.register_forward_pre_hook(lambda b, a: seen.append("pre"))
    net.register_forward_hook(lambda b, a, o: seen.append("post"))
    out = net(nd.array(np.ones((5, 3), np.float32), ctx=CPU))
    assert isinstance(out, tmx.nd.NDArray) and seen == ["pre", "post"]
    assert net.apply(lambda b: None) is net
    assert "Dense(3 -> 4, relu)" in repr(net)
    net.cast("float64")
    assert all(p.data().dtype == np.float64
               for p in net.collect_params().values())
    lam = nn.HybridLambda(lambda F, x: F.relu(x))
    assert torch.equal(lam(torch.tensor([-1.0, 2.0])),
                       torch.tensor([0.0, 2.0]))
    assert nn.Lambda("relu")(nd.array([-1.0], ctx=CPU)).asnumpy() == 0


# ------------------------------------------------------------- export

@pytest.mark.parametrize("model", ["bert", "NCHW", "NHWC"])
def test_export_json_is_mxtpus_and_imports_run(monkeypatch, tmp_path,
                                               model):
    import mxtpu.symbol as jsym
    import mxtpu_torch.symbol as tsym
    jnet, tnet = _pair_bert(dropout=0.1) if model == "bert" \
        else _pair_resnet(model)
    monkeypatch.setattr(jsym, "_NAME_COUNTERS", {})
    jsf = jnet.export(str(tmp_path / "j"))[0]
    monkeypatch.setattr(tsym, "_NAME_COUNTERS", {})
    tsf, tpf = tnet.export(str(tmp_path / "t"))
    with open(jsf) as a, open(tsf) as b:
        assert b.read() == a.read()
    blk = gluon.SymbolBlock.imports(tsf, ["data"], tpf, ctx=CPU)
    x = _tokens(6) if model == "bert" else _images(model, seed=6)
    # a BERT export takes any T up to max_length (slice_like)
    for xx in ([x, x[:, :9]] if model == "bert" else [x]):
        want = tnet(torch.from_numpy(xx))
        got = blk(nd.array(xx, ctx=CPU))
        np.testing.assert_allclose(got.asnumpy(), want.detach().numpy(),
                                   rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------- trainer

def test_trainer_api(tmp_path):
    _, net = _pair_bert()
    x, y = nd.array(_tokens(7), ctx=CPU), nd.array(_tokens(8), ctx=CPU)
    tr = gluon.Trainer(net.collect_params(), "adam",
                       {"learning_rate": 1e-3})
    assert tr.learning_rate == 1e-3
    tr.set_learning_rate(2e-3)
    assert tr.optimizer.lr == 2e-3
    assert tr.optimizer.param_dict[0] is net.pos_embed
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

    def step(t):
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        t.allreduce_grads()
        t.update(2)
        return loss.asnumpy()
    step(tr)
    f = str(tmp_path / "tr.states")
    tr.save_states(f)
    snap = {n: p.data().asnumpy() for n, p in
            net.collect_params().items()}
    a = step(tr)
    after = {n: p.data().asnumpy() for n, p in
             net.collect_params().items()}
    for n, p in net.collect_params().items():
        p.set_data(snap[n])
    tr2 = gluon.Trainer(net.collect_params(), "adam",
                        {"learning_rate": 1e-3})
    tr2.load_states(f)
    assert tr2.optimizer.param_dict[0] is net.pos_embed
    np.testing.assert_array_equal(step(tr2), a)
    for n, p in net.collect_params().items():
        np.testing.assert_array_equal(p.data().asnumpy(), after[n])
    with pytest.raises(MXNetError, match="compression_params"):
        gluon.Trainer(net.collect_params(), "sgd", kvstore=None,
                      compression_params={"type": "2bit"}).step(1)
    with pytest.raises(MXNetError, match="must be None"):
        gluon.Trainer(net.collect_params(), tmx.optimizer.SGD(),
                      {"momentum": 0.9})


def test_grad_req_write_add_and_null():
    p = gluon.Parameter("w", shape=(3,), init="ones")
    p.initialize(ctx=CPU)
    for _ in range(2):
        with autograd.record():
            y = nd.NDArray(p._tensor()) * 2
        y.backward()
    np.testing.assert_array_equal(p.grad().asnumpy(), [2, 2, 2])
    p.grad_req = "add"
    with autograd.record():
        y = nd.NDArray(p._tensor()) * 3
    y.backward()
    np.testing.assert_array_equal(p.grad().asnumpy(), [5, 5, 5])
    p.zero_grad()
    np.testing.assert_array_equal(p.grad().asnumpy(), [0, 0, 0])
    p.grad_req = "null"
    with pytest.raises(MXNetError, match="null"):
        p.grad()
    c = gluon.Constant("c", np.arange(3, dtype=np.float32))
    c.initialize(ctx=CPU)
    assert c.grad_req == "null"
    np.testing.assert_array_equal(c.data().asnumpy(), [0, 1, 2])
    # set_data writes in place: a holder of the tensor sees it
    t = p._tensor()
    p.set_data(np.full(3, 7, np.float32))
    assert p._tensor() is t and float(t[0]) == 7
    with pytest.raises(gluon.DeferredInitializationError):
        q = gluon.Parameter("q", shape=(0, 2), allow_deferred_init=True)
        q.initialize(ctx=CPU)
        q.data()


def test_parameter_dict(tmp_path):
    pd = gluon.ParameterDict("net_")
    w = pd.get("w", shape=(2, 3), init="zeros")
    assert w.name == "net_w" and pd.get("w") is w
    shared = gluon.ParameterDict("net_", shared=pd)
    assert shared.get("w") is w
    pd.get_constant("c", np.ones(2, np.float32))
    pd.initialize(ctx=CPU)
    pd.setattr("lr_mult", 0.5)
    assert w.lr_mult == 0.5
    f = str(tmp_path / "pd.params")
    pd.save(f, strip_prefix="net_")
    assert sorted(tmx.nd.load(f, ctx=CPU)) == ["c", "w"]
    pd2 = gluon.ParameterDict("net_")
    pd2.get("w", shape=(2, 3))
    pd2.get("c", shape=(2,))
    pd2.load(f, ctx=CPU, restore_prefix="net_")
    np.testing.assert_array_equal(pd2["net_c"].data().asnumpy(), [1, 1])
    other = gluon.ParameterDict("x_")
    other.get("w", shape=(1,))
    pd.update(other)
    assert "x_w" in pd
    with pytest.raises(MXNetError, match="clash"):
        clash = gluon.ParameterDict("net_")
        clash.get("w", shape=(1,))
        pd.update(clash)


# ------------------------------------------------------------- losses

def _loss_cases():
    r = np.random.RandomState(9)
    p, l = r.randn(4, 5).astype(np.float32), r.randn(4, 5).astype(np.float32)
    sign = np.sign(r.randn(4, 5)).astype(np.float32)
    prob = (0.1 + 0.8 * r.rand(4, 5)).astype(np.float32)
    bin_ = (r.rand(4, 5) > 0.5).astype(np.float32)
    dist = np.exp(l) / np.exp(l).sum(-1, keepdims=True)
    sw = r.rand(4, 1).astype(np.float32)
    return [
        ("L2Loss", {}, [p, l]), ("L2Loss", {"weight": 0.5}, [p, l, sw]),
        ("L1Loss", {}, [p, l]),
        ("SigmoidBinaryCrossEntropyLoss", {}, [p, bin_]),
        ("SigmoidBinaryCrossEntropyLoss", {"from_sigmoid": True},
         [prob, bin_]),
        ("SoftmaxCrossEntropyLoss", {}, [p, r.randint(0, 5, 4)
                                         .astype(np.float32)]),
        ("SoftmaxCrossEntropyLoss", {"sparse_label": False},
         [p, dist.astype(np.float32)]),
        ("SoftmaxCrossEntropyLoss", {"axis": 1, "batch_axis": 0,
                                     "weight": 2.0},
         [r.randn(4, 3, 6).astype(np.float32),
          r.randint(0, 3, (4, 6)).astype(np.float32)]),
        ("KLDivLoss", {}, [np.log(dist).astype(np.float32),
                           dist.astype(np.float32)]),
        ("KLDivLoss", {"from_logits": False}, [p, dist.astype(np.float32)]),
        ("HuberLoss", {"rho": 0.5}, [p, l]),
        ("HingeLoss", {}, [p, sign]), ("SquaredHingeLoss", {}, [p, sign]),
        ("LogisticLoss", {}, [p, sign]),
        ("LogisticLoss", {"label_format": "binary"}, [p, bin_]),
        ("TripletLoss", {"margin": 0.5}, [p, l, r.randn(4, 5)
                                          .astype(np.float32)]),
        ("CosineEmbeddingLoss", {"margin": 0.1},
         [p, l, np.array([1, -1, 1, -1], np.float32)]),
    ]


@pytest.mark.parametrize("name,kw,ins", _loss_cases(),
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(_loss_cases())])
def test_loss_matches_mxtpu(name, kw, ins):
    want = getattr(jloss, name)(**kw)(*[jnd.array(a) for a in ins])
    got = getattr(tloss, name)(**kw)(*[nd.array(a, ctx=CPU) for a in ins])
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-6,
                               atol=1e-6)


def test_all_of_mxtpus_losses_are_here():
    assert set(jloss.__all__) == set(tloss.__all__)


# ------------------------------------------------- initializers, utils

def test_new_initializers_by_their_statistics():
    trandom.seed(0)
    t = torch.zeros(64, 32, 3, 3)
    init = initializer.MSRAPrelu(slope=0.25)
    init(initializer.InitDesc("c_weight"), t)
    std = np.sqrt(2.0 / (1 + 0.25 ** 2) / ((32 * 9 + 64 * 9) / 2))
    np.testing.assert_allclose(t.std().item(), std, rtol=0.05)
    assert abs(t.mean().item()) < 0.05 * std
    for rand_type in ("uniform", "normal"):
        w = torch.zeros(16, 40)
        initializer.Orthogonal(scale=2.0, rand_type=rand_type)(
            initializer.InitDesc("o_weight"), w)
        np.testing.assert_allclose((w @ w.t()).numpy(), 4 * np.eye(16),
                                   atol=1e-5)
    t = torch.zeros(2, 3, 4, 4)
    initializer.Bilinear()(initializer.InitDesc("up_weight"), t)
    j = jnd.zeros((2, 3, 4, 4))
    jmx.initializer.Bilinear()(jmx.initializer.InitDesc("up_weight"), j)
    np.testing.assert_allclose(t.numpy(), j.asnumpy(), atol=1e-7)
    # mxtpu's own LSTMBias writes into a read-only host copy and raises;
    # the port's sets the forget gate's quarter as the reference does
    t = torch.full((12,), 5.0)
    initializer.LSTMBias(forget_bias=2.0)(
        initializer.InitDesc("lstm_i2h_weight"), t)
    np.testing.assert_array_equal(t.numpy(), [0] * 3 + [2] * 3 + [0] * 6)
    mixed = initializer.Mixed([".*scale", ".*"],
                              [initializer.Constant(3.0),
                               initializer.Uniform(0.1)])
    b, w = torch.zeros(4), torch.zeros(50, 50)
    mixed("fc_scale", b)
    mixed("fc_weight", w)
    assert torch.all(b == 3) and w.abs().max() <= 0.1 and w.std() > 0.05
    with pytest.raises(MXNetError, match="no initializer"):
        initializer.Mixed(["a"], [initializer.Zero()])("b", b)
    # a parameter's own initializer wins over the name rules
    p = gluon.Parameter("x_bias", shape=(3,), init="ones")
    p.initialize(ctx=CPU)
    np.testing.assert_array_equal(p.data().asnumpy(), [1, 1, 1])


def test_utils_split_load_and_clip():
    x = nd.array(np.arange(12, dtype=np.float32).reshape(6, 2), ctx=CPU)
    parts = gluon.utils.split_data(x, 3)
    assert [p.shape for p in parts] == [(2, 2)] * 3
    with pytest.raises(MXNetError, match="evenly"):
        gluon.utils.split_data(x, 4)
    assert [p.shape for p in gluon.utils.split_data(x, 4,
                                                    even_split=False)] == \
        [(1, 2), (1, 2), (1, 2), (3, 2)]
    (one,) = gluon.utils.split_and_load(np.ones((4, 2), np.float32), [CPU])
    assert one.shape == (4, 2) and one.context == CPU
    a = nd.array(np.full(4, 3.0, np.float32), ctx=CPU)
    b = nd.array(np.full(9, 4.0, np.float32), ctx=CPU)
    ja, jb = jnd.array(a.asnumpy()), jnd.array(b.asnumpy())
    norm = gluon.utils.clip_global_norm([a, b], 1.0)
    jnorm = jgluon.utils.clip_global_norm([ja, jb], 1.0)
    assert norm == pytest.approx(jnorm, rel=1e-6)
    np.testing.assert_allclose(a.asnumpy(), ja.asnumpy(), rtol=1e-6)
    np.testing.assert_allclose(b.asnumpy(), jb.asnumpy(), rtol=1e-6)
