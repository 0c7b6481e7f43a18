"""``HybridBlock.set_remat`` in the port: a rematerialized block runs
under ``torch.utils.checkpoint`` while torch records, and its replay in
the backward draws the dropout masks and fused-epilogue key words its
first run drew.

Remat against no remat from the same weights and seed, with dropout on
(the ``Dropout`` mask and the fused epilogue's keep-0.9 mask both
replay): losses, gradients, weights and the random streams' state bit
for bit, through ``TrainStep`` in f32, bf16 compute and AMP, and through
the Gluon loop.  Against mxtpu at dropout 0 as mxtpu's own
``test_remat_matches_no_remat``; BatchNorm inside a remat region
raises; remat on the root block engages.  A forward pre-hook counts a
block's runs, so a remat that silently does nothing fails.
"""
import numpy as np
import pytest
import torch

import mxtpu as jmx
from mxtpu import parallel as jpar
from mxtpu.gluon import loss as jloss
from mxtpu.models import transformer as jtr

import mxtpu_torch as tmx
from mxtpu_torch import MXNetError, autograd, gluon
from mxtpu_torch import random as trandom
from mxtpu_torch.convert import params_from_mxtpu
from mxtpu_torch.gluon import loss as tloss
from mxtpu_torch.gluon import nn
from mxtpu_torch.gluon.block import HybridBlock
from mxtpu_torch.models import transformer as ttr
from mxtpu_torch.parallel import build_train_step

from tests.torch_gluon_names import fresh_names

torch.set_num_threads(2)

CPU = tmx.cpu()
V = 32


class _Wrap(HybridBlock):
    """src|tgt on one batch array, as bench_transformer feeds it."""

    def __init__(self, model, split, **kw):
        super().__init__(**kw)
        self._split = split
        self.model = model

    def hybrid_forward(self, F, x):
        return self.model(F.slice_axis(x, axis=1, begin=0, end=self._split),
                          F.slice_axis(x, axis=1, begin=self._split,
                                       end=None))


def _bert(remat, dropout=0.1):
    return ttr.BERTModel(V, 32, 64, 2, 4, max_length=16, dropout=dropout,
                         remat=remat)


def _transformer(remat, dropout=0.1):
    return _Wrap(ttr.TransformerModel(V, 32, 64, 2, 4, max_length=16,
                                      dropout=dropout, remat=remat), 8)


# the model and its number of encoder and decoder cells
MODELS = {"bert": (_bert, 2), "transformer": (_transformer, 4)}


def _batch(model, seed=0):
    rng = np.random.RandomState(seed)
    n_in = 8 if model == "bert" else 14
    x = rng.randint(0, V, (4, n_in)).astype(np.float32)
    return x, x if model == "bert" else \
        rng.randint(0, V, (4, 6)).astype(np.float32)


def _ce(pred, y):
    return tloss.SoftmaxCrossEntropyLoss()(pred.reshape(-1, V),
                                           y.reshape(-1))


def _seeded(model, remat, dropout=0.1):
    """The model from fixed seeds (xavier weights and the dropout
    streams), its deferred shapes settled, the streams reseeded."""
    make, _ = MODELS[model]
    trandom.seed(7)
    with fresh_names():
        net = make(remat, dropout)
    net.initialize(init="xavier", ctx=CPU)
    x, _ = _batch(model)
    with torch.no_grad():
        net(torch.from_numpy(x[:1]))
    trandom.seed(11)
    return net


def _count_runs(net):
    """Forward runs of every rematerialized block (a replay is a run)."""
    runs = [0]
    for m in net.modules():
        if getattr(m, "_remat", False):
            m.register_forward_pre_hook(
                lambda *a: runs.__setitem__(0, runs[0] + 1))
    return runs


def _cells(net):
    return sum(1 for m in net.modules() if getattr(m, "_remat", False))


@pytest.mark.parametrize("mode", ["f32", "bf16", "amp"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_remat_bit_equal_with_dropout(model, mode):
    """3 TrainStep steps with dropout 0.1, remat against no remat: each
    step's loss and gradients, the weights after, and the random
    streams' state bit for bit; the remat cells ran twice a step."""
    x, y = _batch(model)
    kw = {"f32": {}, "bf16": dict(compute_dtype="bfloat16"),
          "amp": dict(amp=True)}[mode]
    got = {}
    for remat in (False, True):
        net = _seeded(model, remat)
        runs = _count_runs(net)
        step = build_train_step(net, _ce, "adam", {"learning_rate": 1e-3},
                                cast_batch=False, device="cpu", **kw)
        trace = []
        for _ in range(3):
            loss, grads = step.forward_backward(x, y)
            step.update(grads)
            trace.append((loss, grads))
        got[remat] = (trace, [p.detach().clone() for p in net.parameters()],
                      trandom.get_state("cpu"), runs[0], _cells(net))
    (t0, w0, s0, _, _), (t1, w1, s1, runs, cells) = got[False], got[True]
    assert cells == MODELS[model][1] and runs == 2 * 3 * cells
    for (l0, g0), (l1, g1) in zip(t0, t1):
        assert torch.equal(l0, l1)
        assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(a, b) for a, b in zip(w0, w1))
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))


def test_dropout_masks_are_live():
    """The bit-equal gate means something: dropout 0.1 changes the loss,
    and two steps from the same weights draw different masks."""
    x, y = _batch("transformer")
    losses = []
    for dropout in (0.0, 0.1):
        net = _seeded("transformer", True, dropout)
        step = build_train_step(net, _ce, "sgd", {"learning_rate": 0.0},
                                cast_batch=False, device="cpu")
        losses.append([float(step(x, y)) for _ in range(2)])
    assert losses[0][0] == losses[0][1]
    assert losses[1][0] != losses[1][1] and losses[1][0] != losses[0][0]


def test_gluon_loop_remat_bit_equal():
    """autograd.record() and backward() through the Gluon loop: the
    gradients and the stream's state bit for bit, remat or not."""
    x, y = _batch("transformer")
    got = {}
    for remat in (False, True):
        net = _seeded("transformer", remat)
        runs = _count_runs(net)
        tr = gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": 1e-3})
        xs, ys = tmx.nd.array(x, ctx=CPU), tmx.nd.array(y, ctx=CPU)
        for _ in range(2):
            with autograd.record():
                loss = _ce(net(xs), ys)
            loss.backward()
            tr.step(4)
        got[remat] = ([p.grad().asnumpy() for p in
                       net.collect_params().values()
                       if p.grad_req != "null"],
                      [p.data().asnumpy() for p in
                       net.collect_params().values()],
                      trandom.get_state("cpu"), runs[0])
    assert got[True][3] == 2 * 2 * 4 and got[False][3] == 0
    for a, b in zip(got[False][0] + got[False][1],
                    got[True][0] + got[True][1]):
        np.testing.assert_array_equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(got[False][2],
                                                 got[True][2]))


def test_remat_matches_mxtpu_at_dropout_0(monkeypatch):
    """mxtpu's test_remat_matches_no_remat: a 2-layer BERT, SGD lr 0.1,
    4 steps, remat on and off in both packages from the same weights."""
    toks = np.random.RandomState(0).randint(0, V, (4, 8)) \
        .astype(np.float32)
    with fresh_names():
        jref = jtr.BERTModel(V, 32, 64, 2, 4, max_length=16, dropout=0.0)
    jref.initialize(init="xavier")
    jref(jmx.nd.array(toks))
    w = {n: p.data().asnumpy() for n, p in jref.collect_params().items()}
    monkeypatch.setenv("MXTPU_BATCHED_OPT", "0")
    losses = {}
    for remat in (False, True):
        with fresh_names():
            jnet = jtr.BERTModel(V, 32, 64, 2, 4, max_length=16,
                                 dropout=0.0, remat=remat)
            tnet = ttr.BERTModel(V, 32, 64, 2, 4, max_length=16,
                                 dropout=0.0, remat=remat)
        jnet.initialize()
        jnet(jmx.nd.array(toks))
        for n, p in jnet.collect_params().items():
            p.set_data(jmx.nd.array(w[n]))
        params_from_mxtpu(w, tnet)
        jstep = jpar.build_train_step(
            jnet, lambda p, y: jloss.SoftmaxCrossEntropyLoss()(
                p.reshape((-1, V)), y.reshape((-1,))),
            "sgd", {"learning_rate": 0.1})
        tstep = build_train_step(tnet, _ce, "sgd", {"learning_rate": 0.1},
                                 device="cpu")
        losses[("j", remat)] = [float(jstep(jmx.nd.array(toks),
                                            jmx.nd.array(toks)).asscalar())
                                for _ in range(4)]
        losses[("t", remat)] = [float(tstep(toks, toks))
                                for _ in range(4)]
    np.testing.assert_array_equal(losses[("t", True)], losses[("t", False)])
    for remat in (False, True):
        np.testing.assert_allclose(losses[("t", remat)],
                                   losses[("j", remat)], rtol=1e-5,
                                   atol=1e-6)


def _bn_net():
    net = nn.HybridSequential()
    inner = nn.HybridSequential()
    inner.add(nn.Dense(4, flatten=False), nn.BatchNorm(axis=-1))
    inner.set_remat(True)
    net.add(inner)
    net.initialize(init="xavier", ctx=CPU)
    return net, inner[1]


def test_remat_rejects_batchnorm_in_training():
    """A training-mode BatchNorm inside a remat region raises, as
    mxtpu's test_remat_rejects_batchnorm_aux, and leaves its running
    statistics as they were; in predict mode it runs."""
    net, bn = _bn_net()
    x = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    with torch.no_grad():
        net(torch.from_numpy(x))
    before = [bn.running_mean.data().asnumpy().copy(),
              bn.running_var.data().asnumpy().copy()]
    step = build_train_step(net, lambda p, y: tloss.L2Loss()(p, y), "sgd",
                            {"learning_rate": 0.1}, device="cpu")
    y = np.zeros((4, 4), np.float32)
    with pytest.raises(MXNetError, match="set_remat"):
        step(x, y)
    with pytest.raises(MXNetError, match="set_remat"):
        with autograd.record():
            net(tmx.nd.array(x, ctx=CPU))
    np.testing.assert_array_equal(bn.running_mean.data().asnumpy(),
                                  before[0])
    np.testing.assert_array_equal(bn.running_var.data().asnumpy(),
                                  before[1])
    with autograd.record(train_mode=False):
        out = net(tmx.nd.array(x, ctx=CPU))
    out.backward()


def test_remat_on_root_block():
    """set_remat on the net handed to build_train_step engages (its
    forward runs twice a step) and trains as the same net without
    remat, bit for bit (mxtpu's test_remat_on_root_block)."""
    x = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    y = np.zeros((4, 2), np.float32)
    got = {}
    for remat in (False, True):
        trandom.seed(3)
        net = nn.HybridSequential()
        net.add(nn.Dense(8, activation="relu"), nn.Dense(2))
        net.initialize(init="xavier", ctx=CPU)
        net.set_remat(remat)
        runs = [0]
        net.register_forward_pre_hook(
            lambda *a: runs.__setitem__(0, runs[0] + 1))
        step = build_train_step(net, lambda p, t: tloss.L2Loss()(p, t),
                                "sgd", {"learning_rate": 0.1}, device="cpu")
        losses = [float(step(x, y)) for _ in range(5)]
        # the first step also settles the deferred shapes: one forward
        got[remat] = (losses, runs[0] - 1)
    assert got[True][0] == got[False][0]
    assert got[True][0][-1] < got[True][0][0]
    assert got[False][1] == 5 and got[True][1] == 10


def test_nested_remat_bit_equal():
    """Remat on the root and on every cell at once: the replays nest,
    and the step is the plain one bit for bit."""
    x, y = _batch("bert")
    got = {}
    for remat in (False, True):
        net = _seeded("bert", remat)
        net.set_remat(remat)
        step = build_train_step(net, _ce, "adam", {"learning_rate": 1e-3},
                                cast_batch=False, device="cpu")
        got[remat] = ([float(step(x, y)) for _ in range(2)],
                      [p.detach().clone() for p in net.parameters()])
    assert got[True][0] == got[False][0]
    assert all(torch.equal(a, b) for a, b in zip(got[True][1],
                                                 got[False][1]))


def test_set_remat_after_hybridize_changes_no_output():
    net = _seeded("transformer", False)
    net.hybridize()
    x = torch.from_numpy(_batch("transformer")[0])
    with torch.no_grad():
        before = net(x)
    for m in net.modules():
        if isinstance(m, (ttr.TransformerEncoderCell,
                          ttr.TransformerDecoderCell)):
            assert m.set_remat(True) is m
    with torch.no_grad():
        assert torch.equal(net(x), before)
    with autograd.train_mode():
        trandom.seed(5)
        a = net(x)
        net.set_remat(False)
        for m in net.modules():
            m._remat = False
        trandom.seed(5)
        b = net(x)
    assert torch.equal(a, b)


def test_remat_without_tensor_input_raises():
    """A rematerialized call with no tensor among its inputs raises, as
    mxtpu's _forward_remat does."""
    class Const(HybridBlock):
        def hybrid_forward(self, F, n):
            return torch.ones(2, requires_grad=True) * n

    blk = Const().set_remat(True)
    with pytest.raises(MXNetError, match="no tensor inputs"):
        blk(3.0)
    with torch.no_grad():
        assert torch.equal(blk(3.0), torch.full((2,), 3.0))


def test_remat_off_the_recorded_path(tmp_path, monkeypatch):
    """Without grad a remat block runs once, and its export is the plain
    model's byte for byte."""
    import mxtpu_torch.symbol as tsym
    texts = []
    for remat in (False, True):
        net = _seeded("transformer", remat)
        runs = _count_runs(net)
        with torch.no_grad():
            net(torch.from_numpy(_batch("transformer")[0]))
        assert runs[0] == (4 if remat else 0)
        monkeypatch.setattr(tsym, "_NAME_COUNTERS", {})
        with open(net.export(str(tmp_path / f"r{remat}"))[0]) as f:
            texts.append(f.read())
    assert texts[0] == texts[1]
