"""mxtpu_torch's Module held against mxtpu's on the CPU: resnet8 of
``examples/train_cifar10.py`` in f32, both Modules from the same
parameters (drawn by mxtpu's Xavier and carried by
``convert.symbol_params_from_mxtpu``), mxtpu's run through its default
jit executor and, with ``MXTPU_EXECUTOR_JIT=0`` set in the test's
environment, through its eager one.

Tolerances, f32: the outputs (softmax probabilities) 1e-5 in train and
eval mode (convolutions summed in another order); each executor
gradient's rms error 1e-4 of its rms; three SGD-momentum steps: each
step's loss 1e-4 of max(|loss|, 0.01) and every parameter 1e-4 of its
largest magnitude.  Also: ``fit`` with the recipe's metric and
callbacks, checkpoints crossing both ways, ``NDArrayIter``'s order,
the BatchNorm auxiliary states after ``fit``, and ``module_mlp``'s adam
recipe.

mxtpu is not always within those bounds of the exact result.  Its
BatchNorm runs in f32 whatever its input and takes ``E[x^2] - E[x]^2``
over f32 sums; on conv0's output (mean^2 up to 13x the variance) its
variance is up to 1.7e-4 off, which moves pre-activations by ~1e-4 and
flips a few ReLU masks.  The BatchNorm betas' gradients sum over those
masks, and so do the convolution weights' before them: mxtpu's land up
to 1.3 % from the exact ones (the ``fit`` test's stage-1 beta), the
port's within 3e-6.  So the gradient, step and ``fit`` checks also run
an oracle that shares no code with the port: mxtpu's own graph,
executor and SGD in f64 (jax x64), with BatchNorm from centered f64
statistics (``_bn_f64``).  The port must be within 1e-5 of it
(gradients; 1e-4 after steps) for every tensor, and every step loss
within 1e-4 of mxtpu's.  Each tensor must also be within 1e-4 of
mxtpu's or, where mxtpu is further than that from the oracle, within
mxtpu's distance plus the port's bound, and never beyond 2e-2.

What mxtpu does with BatchNorm's auxiliary states, the port does too:
the symbolic BatchNorm normalizes by the batch statistics in training
and in inference and never writes ``moving_mean``/``moving_var``, so
after ``fit`` they are as initialized (zeros and ones).  Upstream
MXNet updates them in training and normalizes by them in inference.
"""
import contextlib
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import mxtpu as jmx
from mxtpu.io import NDArrayIter as JIter
from mxtpu.ops import get_op as jget_op

import mxtpu_torch as tmx
from mxtpu_torch import MXNetError
from mxtpu_torch.convert import (symbol_params_from_mxtpu,
                                 symbol_params_to_mxtpu)
from mxtpu_torch.io import NDArrayIter as TIter

from test_torch_symbol import build

torch.set_num_threads(2)

B = 8
CPU = tmx.cpu()
SGD = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4,
       "rescale_grad": 1.0 / B}
MODES = ["jit", "eager"]
ESCAPE_CAP = 2e-2


def _data(n, seed=0):
    """CIFAR-shaped inputs as ``load_cifar``'s fallback makes them."""
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, n).astype(np.float32)
    X[:, 0] += y[:, None, None] * 0.03
    return X, y


def _batches(X, y):
    return (jmx.io.DataBatch([jmx.nd.array(X)], [jmx.nd.array(y)]),
            tmx.io.DataBatch([tmx.nd.array(X, ctx=CPU)],
                             [tmx.nd.array(y, ctx=CPU)]))


def _modules(monkeypatch, mode, net="resnet8", shape=(B, 3, 32, 32)):
    """mxtpu's Module (Xavier from mxtpu's stream) and the port's on the
    CPU, bound for training, from equal parameters."""
    monkeypatch.setenv("MXTPU_EXECUTOR_JIT", "1" if mode == "jit" else "0")
    js, ts = build("mxtpu", net, monkeypatch), build("port", net,
                                                     monkeypatch)
    descs = ([("data", shape)], [("softmax_label", shape[:1])])
    jm = jmx.mod.Module(js)
    jm.bind(*descs)
    jm.init_params(jmx.init.Xavier())
    arg, aux = jm.get_params()
    tm = tmx.mod.Module(ts, context=CPU)
    tm.bind(*descs)
    tm.set_params(*symbol_params_from_mxtpu(
        {k: v.asnumpy() for k, v in arg.items()},
        {k: v.asnumpy() for k, v in aux.items()}, ctx=CPU))
    return jm, tm


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _rms_rel(got, want):
    want = want.astype(np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2)) /
                 max(np.sqrt(np.mean(want ** 2)), 1e-30))


def _bn_f64(x, gamma, beta, mm, mv, eps=1e-5, momentum=0.9, fix_gamma=True,
            use_global_stats=False, output_mean_var=False, axis=1):
    """mxtpu's batch-statistics BatchNorm rule, in jax, in the input's
    dtype (f64 here) with centered statistics."""
    ax = tuple(i for i in range(x.ndim) if i != axis)
    sh = [1] * x.ndim
    sh[axis] = -1
    m = x.mean(axis=ax)
    v = ((x - m.reshape(sh)) ** 2).mean(axis=ax)
    g = jnp.ones_like(gamma) if fix_gamma else gamma
    y = (x - m.reshape(sh)) * lax.rsqrt(v + eps).reshape(sh) * \
        g.reshape(sh) + beta.reshape(sh)
    return y, lax.stop_gradient(m), lax.stop_gradient(v)


@contextlib.contextmanager
def _f64(monkeypatch):
    """mxtpu in f64 with ``_bn_f64`` as its BatchNorm, jit executor."""
    with monkeypatch.context() as m:
        m.setattr(jget_op("BatchNorm"), "fn", _bn_f64)
        m.setenv("MXTPU_EXECUTOR_JIT", "1")
        x64 = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", True)
        try:
            yield
        finally:
            jax.config.update("jax_enable_x64", x64)


class _Oracle:
    """mxtpu's Module over ``jm``'s graph and parameters in f64."""

    def __init__(self, jm, monkeypatch, optimizer_params=None):
        self.mp = monkeypatch
        arg, aux = jm.get_params()
        with _f64(monkeypatch):
            self.m = jmx.mod.Module(jm.symbol)
            self.m.bind(jm.data_shapes, jm.label_shapes)
            self.m.init_params()
            ex = self.m._exec
            for d, src in ((ex.arg_dict, arg), (ex.aux_dict, aux)):
                for k, v in src.items():
                    d[k]._data = jnp.asarray(v.asnumpy(), jnp.float64)
            if optimizer_params is not None:
                self.m.init_optimizer(optimizer="sgd",
                                      optimizer_params=optimizer_params)

    def step(self, X, y, update=False):
        """forward_backward (and update) on ``X, y``: the softmax
        output and the gradients, as f64 numpy arrays."""
        with _f64(self.mp):
            self.m.forward_backward(jmx.io.DataBatch(
                [jmx.nd.array(X.astype(np.float64), dtype="float64")],
                [jmx.nd.array(y)]))
            out = self.m.get_outputs()[0].asnumpy()
            grads = {n: g.asnumpy()
                     for n, g in self.m._exec.grad_dict.items()}
            if update:
                self.m.update()
        assert out.dtype == np.float64
        return out, grads

    def params(self):
        with _f64(self.mp):
            arg, _ = self.m.get_params()
            return {n: v.asnumpy() for n, v in arg.items()}


def _agree(got, want, ref, err, tol, ref_tol, what, escape=True):
    """``got`` (the port) within ``ref_tol`` of the f64 oracle ``ref``,
    and within ``tol`` of mxtpu's ``want``; with ``escape``, where mxtpu
    is further than ``tol`` from ``ref``, within that distance plus
    ``ref_tol`` and never beyond ``ESCAPE_CAP``."""
    e_ref, e_want = err(got, ref), err(want, ref)
    assert e_ref <= ref_tol, (what, "port vs f64", e_ref)
    bound = tol
    if escape:
        bound = min(max(tol, e_want + ref_tol), ESCAPE_CAP)
    assert err(got, want) <= bound, \
        (what, "port vs mxtpu", err(got, want), "mxtpu vs f64", e_want)


def _loss(probs, y):
    return float(-np.mean(np.log(probs[np.arange(len(y)),
                                       y.astype(int)])))


@pytest.mark.parametrize("mode", MODES)
def test_forward_matches_mxtpu(mode, monkeypatch):
    jm, tm = _modules(monkeypatch, mode)
    jb, tb = _batches(*_data(B))
    for is_train in (True, False):
        jm.forward(jb, is_train=is_train)
        tm.forward(tb, is_train=is_train)
        want = jm.get_outputs()[0].asnumpy()
        got = tm.get_outputs()[0].asnumpy()
        assert got.shape == (B, 10)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_gradients_match_mxtpu(mode, monkeypatch):
    jm, tm = _modules(monkeypatch, mode)
    oracle = _Oracle(jm, monkeypatch)
    X, y = _data(B)
    jb, tb = _batches(X, y)
    jm.forward_backward(jb)
    tm.forward_backward(tb)
    _, g64 = oracle.step(X, y)
    names = tm._param_names
    assert len(names) == len(jm._param_names) == 25
    for n in names:
        _agree(tm._exec.grad_dict[n].asnumpy(),
               jm._exec.grad_dict[n].asnumpy(), g64[n], _rms_rel, 1e-4,
               1e-5, n)


def _loss_err(got, want):
    return abs(got - want) / max(abs(want), 0.01)


@pytest.mark.parametrize("mode", MODES)
def test_three_sgd_steps_match_mxtpu(mode, monkeypatch):
    jm, tm = _modules(monkeypatch, mode)
    oracle = _Oracle(jm, monkeypatch, SGD)
    for m in (jm, tm):
        m.init_optimizer(optimizer="sgd", optimizer_params=SGD)
    for step in range(3):
        X, y = _data(B, seed=step)
        jb, tb = _batches(X, y)
        losses = []
        for m, b in ((tm, tb), (jm, jb)):
            m.forward_backward(b)
            losses.append(_loss(m.get_outputs()[0].asnumpy(), y))
            m.update()
        losses.append(_loss(oracle.step(X, y, update=True)[0], y))
        _agree(*losses, _loss_err, 1e-4, 1e-5, f"step {step} loss",
               escape=False)
    (ja, jx), (ta, tx), fa = jm.get_params(), tm.get_params(), \
        oracle.params()
    for n in ja:
        _agree(ta[n].asnumpy(), ja[n].asnumpy(), fa[n], _rel, 1e-4, 1e-4,
               n)
    for n in jx:
        np.testing.assert_array_equal(tx[n].asnumpy(), jx[n].asnumpy())


def test_fit_checkpoints_and_aux_states_match_mxtpu(monkeypatch, tmp_path,
                                                    caplog):
    jm, tm = _modules(monkeypatch, "jit")
    X, y = _data(2 * B + 3)
    # the f64 oracle takes fit's two steps over the same batch order
    oracle = _Oracle(jm, monkeypatch, SGD)
    it64 = TIter(X, y, batch_size=B, shuffle=True,
                 last_batch_handle="discard", rng=np.random.RandomState(7))
    it64.reset()
    for b in it64:
        oracle.step(b.data[0].asnumpy(), b.label[0].asnumpy(), update=True)
    np.random.seed(7)
    jit_ = JIter(X, y, batch_size=B, shuffle=True,
                 last_batch_handle="discard")
    tit = TIter(X, y, batch_size=B, shuffle=True,
                last_batch_handle="discard", rng=np.random.RandomState(7))
    results = []
    for mx, m, it, tag in ((jmx, jm, jit_, "j"), (tmx, tm, tit, "t")):
        metric = mx.metric.Accuracy()
        speed = mx.callback.Speedometer(B, 1)
        with caplog.at_level(logging.INFO):
            m.fit(it, eval_metric=metric, optimizer="sgd",
                  optimizer_params=SGD, initializer=mx.init.Xavier(),
                  num_epoch=1, kvstore="local", batch_end_callback=[speed],
                  epoch_end_callback=[mx.callback.do_checkpoint(
                      str(tmp_path / tag))])
        results.append((m.get_params(), metric.get()))
    assert "Speed:" in caplog.text
    (ja, jx), _ = results[0]
    (ta, tx), _ = results[1]
    fa = oracle.params()
    for n in ja:
        _agree(ta[n].asnumpy(), ja[n].asnumpy(), fa[n], _rel, 1e-4, 1e-4, n)
    for n in jx:
        want = np.zeros(jx[n].shape) if n.endswith("mean") else \
            np.ones(jx[n].shape)
        np.testing.assert_array_equal(jx[n].asnumpy(), want)
        np.testing.assert_array_equal(tx[n].asnumpy(), want)
    # the epoch-end checkpoints: mxtpu reads the port's and the other way
    _, ja1, jx1 = jmx.model.load_checkpoint(str(tmp_path / "t"), 1)
    _, ta1, tx1 = tmx.model.load_checkpoint(str(tmp_path / "j"), 1,
                                            ctx=CPU)
    for n in ja:
        np.testing.assert_array_equal(ja1[n].asnumpy(), ta[n].asnumpy())
        np.testing.assert_array_equal(ta1[n].asnumpy(), ja[n].asnumpy())
    assert set(jx1) == set(tx1) == set(jx)


def test_checkpoints_cross_and_predict_equal(monkeypatch, tmp_path):
    jm, tm = _modules(monkeypatch, "jit")
    X, y = _data(2 * B, seed=3)
    preds = {}
    tm.save_checkpoint(str(tmp_path / "t"), 3)
    jm.save_checkpoint(str(tmp_path / "j"), 3)
    # the same arrays make the same .params bytes (the dmlc stream)
    assert (tmp_path / "t-0003.params").read_bytes() == \
        (tmp_path / "j-0003.params").read_bytes()
    assert (tmp_path / "t-symbol.json").read_text() == \
        (tmp_path / "j-symbol.json").read_text()
    for tag, mx, kw in (("t", jmx, {}), ("j", tmx, {"context": CPU})):
        mod = mx.mod.Module.load(str(tmp_path / tag), 3, **kw)
        it = (JIter if mx is jmx else TIter)(X, y, batch_size=B)
        mod.bind(it.provide_data, it.provide_label, for_training=False)
        mod.init_params()
        preds[(tag, "loaded")] = mod.predict(it).asnumpy()
    for mx, m in ((jmx, jm), (tmx, tm)):
        it = (JIter if mx is jmx else TIter)(X, y, batch_size=B)
        preds[mx.__name__] = m.predict(it).asnumpy()
    want = preds["mxtpu"]
    assert want.shape == (2 * B, 10)
    for k, got in preds.items():
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                   err_msg=str(k))
    # a reload in one package predicts bit for bit what it saved
    np.testing.assert_array_equal(preds[("j", "loaded")],
                                  preds["mxtpu_torch"])
    # and the carry back to mxtpu's numpy dicts is exact
    a, x = symbol_params_to_mxtpu(*tm.get_params())
    ja, jx = jm.get_params()
    for n in ja:
        np.testing.assert_array_equal(a[n], ja[n].asnumpy())
    assert set(x) == set(jx)


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
def test_ndarrayiter_order_matches_mxtpu(handle):
    X = np.arange(23 * 2, dtype=np.float32).reshape(23, 2)
    y = np.arange(23, dtype=np.float32)
    np.random.seed(11)
    j = JIter(X, y, batch_size=5, shuffle=True, last_batch_handle=handle)
    t = TIter(X, y, batch_size=5, shuffle=True, last_batch_handle=handle,
              rng=np.random.RandomState(11))
    assert len(t) == len(j)
    assert t.provide_data == [tmx.io.DataDesc("data", (5, 2))]
    for epoch in range(3):
        j.reset()
        t.reset()
        jb, tb = list(j), list(t)
        assert len(jb) == len(tb) > 0
        for a, b in zip(jb, tb):
            assert a.pad == b.pad
            np.testing.assert_array_equal(a.index, b.index)
            np.testing.assert_array_equal(a.data[0].asnumpy(),
                                          b.data[0].asnumpy())
            np.testing.assert_array_equal(a.label[0].asnumpy(),
                                          b.label[0].asnumpy())
            assert b.data[0].context == CPU


def test_module_mlp_adam_recipe_matches_mxtpu(monkeypatch):
    """``examples/module_mlp.py``'s recipe (adam lr 0.01, batch 64,
    Speedometer) for 2 epochs from equal parameters; the final weights
    1e-4 of their largest magnitude, the validation accuracy equal."""
    rng = np.random.RandomState(0)
    X = rng.randn(2000, 20).astype(np.float32)
    y = X[:, :10].argmax(1).astype(np.float32)
    jm, tm = _modules(monkeypatch, "jit", net="mlp", shape=(64, 20))
    scores = []
    for mx, m, Iter in ((jmx, jm, JIter), (tmx, tm, TIter)):
        train = Iter(X[:1600], y[:1600], batch_size=64,
                     label_name="softmax_label")
        val = Iter(X[1600:], y[1600:], batch_size=64,
                   label_name="softmax_label")
        m.fit(train, eval_data=val, num_epoch=2, optimizer="adam",
              optimizer_params={"learning_rate": 0.01},
              initializer="xavier",
              batch_end_callback=mx.callback.Speedometer(64, 10))
        scores.append(m.score(val, "acc"))
    (ja, _), (ta, _) = jm.get_params(), tm.get_params()
    for n in ja:
        assert _rel(ta[n].asnumpy(), ja[n].asnumpy()) <= 1e-4, n
    assert scores[0] == scores[1]
    assert scores[1][0][1] > 0.5


def test_module_defaults_to_the_card_and_refuses_other_kvstores(
        monkeypatch):
    ts = build("port", "mlp", monkeypatch)
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="CUDA is not available"):
            tmx.mod.Module(ts)
        with pytest.raises(MXNetError, match="CUDA is not available"):
            tmx.nd.array([1.0])
        with pytest.raises(MXNetError, match="CUDA is not available"):
            ts.simple_bind(data=(2, 20), softmax_label=(2,))
    m = tmx.mod.Module(ts, context=CPU)
    m.bind([("data", (4, 20))], [("softmax_label", (4,))])
    m.init_params()
    # mxtpu's Module.init_optimizer accepts any kvstore and creates no
    # store there; so does the port
    m.init_optimizer(kvstore="dist_sync")
    assert m.optimizer_initialized
    m.init_optimizer(kvstore="local", force_init=True)
    assert m.output_shapes is None


def test_grad_req_add_and_fixed_params(monkeypatch):
    ts = build("port", "mlp", monkeypatch)
    X, y = _data(4)
    X = X.reshape(4, -1)[:, :20].copy()
    batch = tmx.io.DataBatch([tmx.nd.array(X, ctx=CPU)],
                             [tmx.nd.array(y, ctx=CPU)])
    m = tmx.mod.Module(ts, context=CPU, fixed_param_names=["fc1_bias"])
    m.bind([("data", (4, 20))], [("softmax_label", (4,))], grad_req="add")
    m.init_params(tmx.init.Xavier())
    m.forward_backward(batch)
    g1 = m._exec.grad_dict["fc2_weight"].asnumpy().copy()
    m.forward_backward(batch)
    np.testing.assert_allclose(m._exec.grad_dict["fc2_weight"].asnumpy(),
                               2 * g1, rtol=1e-6, atol=1e-7)
    assert "fc1_bias" not in m._exec.grad_dict
    assert m._exec._grad_req["fc1_bias"] == "null"


@pytest.mark.parametrize("name,params", [
    ("sgd", SGD),
    ("sgd", dict(SGD, wd=0.1)),
    ("sgd", dict(SGD, momentum=0.0, wd=0.1)),
    ("adam", {"learning_rate": 0.01, "wd": 0.1, "rescale_grad": 1.0 / B}),
])
def test_updater_matches_mxtpu(name, params):
    """The Updater that ``Module.update`` calls, against mxtpu's on the
    same weights and gradients: 4 steps, each weight 1e-6 of its largest
    magnitude.  A weight decay of 0.1 moves each step's weight by 1e-3
    of itself, so the decay is held as well as the rescale and the
    momentum."""
    rng = np.random.RandomState(5)
    w0 = [rng.randn(16, 8).astype(np.float32),
          rng.randn(8).astype(np.float32)]
    ju = jmx.optimizer.get_updater(jmx.optimizer.create(name, **params))
    tu = tmx.optimizer.get_updater(tmx.optimizer.create(name, **params))
    jw = [jmx.nd.array(w) for w in w0]
    tw = [tmx.nd.array(w, ctx=CPU) for w in w0]
    for _ in range(4):
        for i, w in enumerate(w0):
            g = rng.randn(*w.shape).astype(np.float32)
            ju(i, jmx.nd.array(g), jw[i])
            tu(i, tmx.nd.array(g, ctx=CPU), tw[i])
    for j, t, w in zip(jw, tw, w0):
        assert _rel(j.asnumpy(), w) > 1e-3
        assert _rel(t.asnumpy(), j.asnumpy()) <= 1e-6
