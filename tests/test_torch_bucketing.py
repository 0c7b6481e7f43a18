"""mxtpu_torch's ``BucketSentenceIter``, ``BucketingModule``,
``SequentialModule``, ``PythonModule``/``PythonLossModule`` and
``Monitor`` held against mxtpu's on the CPU, mirroring
``tests/test_compat_modules.py:129-260`` and ``tests/test_module.py:
104-172``: the same batches from the same numpy seed, both packages'
modules from the same parameters, and every parameter after the same
steps (1e-5: the same f32 products summed in another order), with the
parameter arrays shared across buckets (one object).
"""
import logging

import numpy as np
import pytest
import torch

import mxtpu as jmx
from mxtpu import nd as jnd
from mxtpu.io import DataBatch as JBatch, DataDesc as JDesc
from mxtpu.io import NDArrayIter as JIter

import mxtpu_torch as tmx
from mxtpu_torch.io import DataBatch as TBatch, DataDesc as TDesc
from mxtpu_torch.io import NDArrayIter as TIter

torch.set_num_threads(2)
CPU = tmx.cpu()
TOL = {"rtol": 1e-5, "atol": 1e-5}


def _sentences(n=200, seed=0):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(1, 20, rng.randint(3, 12))) for _ in range(n)]


def _pooled_sym_gen(m):
    """mxtpu's bucketing symbol (``test_compat_modules.py:145``): an
    embedding mean-pooled over time, so the parameters do not depend on
    the bucket's length."""
    def sym_gen(seq_len):
        data = m.sym.var("data")
        emb = m.sym.Embedding(data, input_dim=20, output_dim=8,
                              name="embed")
        pooled = m.sym.mean(emb, axis=1)
        fc = m.sym.FullyConnected(pooled, num_hidden=20, name="fc")
        out = m.sym.SoftmaxOutput(fc, name="softmax")
        return out, ("data",), ("softmax_label",)
    return sym_gen


def _init_weights(seed=0):
    rng = np.random.RandomState(seed)
    return {"embed_weight": (rng.randn(20, 8) * 0.3).astype(np.float32),
            "fc_weight": (rng.randn(20, 8) * 0.3).astype(np.float32),
            "fc_bias": np.zeros(20, np.float32)}


def _first_token(batch, desc):
    batch.label = [batch.label[0][:, 0]]
    batch.provide_label = [desc("softmax_label", (16,), np.float32)]
    return batch


def test_bucket_sentence_iter_matches_mxtpu():
    """The same sentences and numpy seed give the same bucket keys and
    the same padded batches and next-token labels, in the same order;
    host (CPU) arrays; sentences past the largest bucket dropped."""
    from mxtpu.rnn import BucketSentenceIter as JIt
    from mxtpu_torch.rnn import BucketSentenceIter as TIt
    sents = _sentences() + [list(range(1, 15))]
    np.random.seed(5)
    jit = JIt(sents, batch_size=16, buckets=[6, 12])
    np.random.seed(5)
    tit = TIt(sents, batch_size=16, buckets=[6, 12])
    assert tit.default_bucket_key == jit.default_bucket_key == 12
    assert tit.provide_data[0].shape == (16, 12)
    for jb, tb in zip(jit, tit):
        assert tb.bucket_key == jb.bucket_key
        assert tb.data[0].context.type == "cpu"
        assert tb.provide_data[0].shape == (16, tb.bucket_key)
        np.testing.assert_array_equal(tb.data[0].asnumpy(),
                                      jb.data[0].asnumpy())
        np.testing.assert_array_equal(tb.label[0].asnumpy(),
                                      jb.label[0].asnumpy())
    assert not tit.iter_next()
    np.random.seed(1)
    auto_j = JIt(_sentences(), batch_size=8)
    np.random.seed(1)
    auto_t = TIt(_sentences(), batch_size=8)
    assert auto_t.buckets == auto_j.buckets


def test_bucket_sentence_iter_with_bucketing_module():
    """``test_compat_modules.py:129``: BucketSentenceIter drives
    BucketingModule over the pooled-embedding symbol; the port's
    parameters after each update equal mxtpu's, and every bucket holds
    the default bucket's arrays."""
    from mxtpu.rnn import BucketSentenceIter as JIt
    from mxtpu_torch.rnn import BucketSentenceIter as TIt
    w = _init_weights()
    runs = []
    for m, It, desc, ctx in ((jmx, JIt, JDesc, {}),
                             (tmx, TIt, TDesc, {"context": CPU})):
        np.random.seed(0)
        it = It(_sentences(), batch_size=16, buckets=[6, 12])
        mod = m.mod.BucketingModule(_pooled_sym_gen(m),
                                    default_bucket_key=12, **ctx)
        first = next(it)
        mod.bind(data_shapes=first.provide_data,
                 label_shapes=[desc("softmax_label", (16,), np.float32)])
        mod.init_params(arg_params={k: m.nd.array(v) if m is jmx else
                                    v for k, v in w.items()})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.05})
        it.reset()
        seen, params = [], []
        for i, batch in enumerate(it):
            mod.forward(_first_token(batch, desc), is_train=True)
            mod.backward()
            mod.update()
            seen.append(batch.bucket_key)
            params.append({k: v.asnumpy()
                           for k, v in mod.get_params()[0].items()})
            if i >= 5:
                break
        runs.append((seen, params, mod))
    (js, jp, _), (ts, tp, tmod) = runs
    assert ts == js and set(ts) == {6, 12}
    for a, b in zip(tp, jp):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], err_msg=k, **TOL)
    for k in w:
        assert tmod._buckets[6]._exec.arg_dict[k] is \
            tmod._buckets[12]._exec.arg_dict[k]


def test_bucketing_module_shares_params_and_updater():
    """``test_module.py:104``: buckets 8 and 4 of a mean-pooled symbol,
    forward/backward/update in turns; one array object a parameter, one
    updater, and the weights equal to mxtpu's."""
    def sym_gen(m):
        def gen(seq_len):
            pooled = m.sym.mean(m.sym.var("data"), axis=1)
            fc = m.sym.FullyConnected(pooled, num_hidden=4,
                                      name="shared_fc")
            return m.sym.SoftmaxOutput(fc, name="softmax"), ("data",), \
                ("softmax_label",)
        return gen
    rng = np.random.RandomState(0)
    xs = {s: rng.randn(4, s, 5).astype(np.float32) for s in (8, 4)}
    y = np.array([0, 1, 2, 3], np.float32)
    w = {"shared_fc_weight": (rng.randn(4, 5) * 0.3).astype(np.float32),
         "shared_fc_bias": np.zeros(4, np.float32)}
    res = []
    for m, Batch, desc, arr, ctx in (
            (jmx, JBatch, JDesc, jnd.array, {}),
            (tmx, TBatch, TDesc, lambda a: tmx.nd.array(a, ctx=CPU),
             {"context": CPU})):
        mod = m.mod.BucketingModule(sym_gen(m), default_bucket_key=8,
                                    **ctx)
        mod.bind(data_shapes=[desc("data", (4, 8, 5))],
                 label_shapes=[desc("softmax_label", (4,))])
        mod.init_params(arg_params={k: arr(v) for k, v in w.items()})
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.1, "momentum": 0.9})
        for s in (8, 4, 8, 4):
            b = Batch(data=[arr(xs[s])], label=[arr(y)])
            b.bucket_key = s
            b.provide_data = [desc("data", (4, s, 5))]
            b.provide_label = [desc("softmax_label", (4,))]
            mod.forward(b, is_train=True)
            mod.backward()
            mod.update()
        res.append(mod)
    jm, tm = res
    assert set(tm._buckets) == {8, 4}
    w8 = tm._buckets[8]._exec.arg_dict["shared_fc_weight"]
    assert w8 is tm._buckets[4]._exec.arg_dict["shared_fc_weight"]
    assert tm._buckets[8]._updater is tm._buckets[4]._updater
    for k, v in jm.get_params()[0].items():
        np.testing.assert_allclose(tm.get_params()[0][k].asnumpy(),
                                   v.asnumpy(), err_msg=k, **TOL)


def test_bucketing_module_fit_with_monitor():
    """``fit`` driven by ``bucket_key`` with a ``Monitor``: the same
    per-batch statistics of the softmax output as mxtpu's (both
    packages' buckets created during the epoch pick the monitor up),
    the same weights after the epoch, the training loss falling."""
    from mxtpu.monitor import Monitor as JMon
    from mxtpu.rnn import BucketSentenceIter as JIt
    from mxtpu_torch.monitor import Monitor as TMon
    from mxtpu_torch.rnn import BucketSentenceIter as TIt

    class FirstToken:
        """The iterator's batches with the first token as the label."""

        def __init__(self, it, desc):
            self.it, self.desc = it, desc
            self.provide_data = it.provide_data
            self.provide_label = [desc("softmax_label", (16,))]

        def reset(self):
            self.it.reset()

        def __iter__(self):
            for b in self.it:
                yield _first_token(b, self.desc)

    w = _init_weights(1)
    runs = []
    for m, It, Mon, desc, ctx in ((jmx, JIt, JMon, JDesc, {}),
                                  (tmx, TIt, TMon, TDesc,
                                   {"context": CPU})):
        np.random.seed(2)
        it = FirstToken(It(_sentences(160, seed=3), batch_size=16,
                           buckets=[6, 12]), desc)
        mon = Mon(interval=1, pattern="softmax.*")
        rows = []
        mon.toc_print = lambda mon=mon, rows=rows: rows.extend(mon.toc())
        mod = m.mod.BucketingModule(_pooled_sym_gen(m),
                                    default_bucket_key=12, **ctx)
        metric = m.metric.create("ce")
        mod.fit(it, eval_metric=metric, num_epoch=2, monitor=mon,
                arg_params={k: m.nd.array(v) if m is jmx else v
                            for k, v in w.items()},
                optimizer_params={"learning_rate": 0.5})
        runs.append((rows, mod.get_params()[0], metric.get()[1]))
    (jr, jp, jce), (tr, tp, tce) = runs
    assert len(tr) == len(jr) > 0
    for (ts, tn, tv), (js, jn, jv) in zip(tr, jr):
        assert (ts, tn) == (js, jn)
        np.testing.assert_allclose(float(tv.strip("[]")),
                                   float(jv.strip("[]")), rtol=1e-5)
    for k, v in jp.items():
        np.testing.assert_allclose(tp[k].asnumpy(), v.asnumpy(),
                                   err_msg=k, **TOL)
    np.testing.assert_allclose(tce, jce, rtol=1e-5)


def test_module_monitor_matches_mxtpu():
    """``test_module.py:145``: ``install_monitor`` on a Module, one
    predict-mode forward between ``tic`` and ``toc``; the same rows as
    mxtpu's, and nothing collected off the interval."""
    from mxtpu.monitor import Monitor as JMon
    from mxtpu_torch.monitor import Monitor as TMon
    rng = np.random.RandomState(0)
    X = rng.randn(20, 6).astype(np.float32)
    y = (X[:, :3].argmax(1)).astype(np.float32)
    w = {"fc1_weight": (rng.randn(16, 6) * 0.3).astype(np.float32),
         "fc1_bias": np.zeros(16, np.float32),
         "fc2_weight": (rng.randn(3, 16) * 0.3).astype(np.float32),
         "fc2_bias": np.zeros(3, np.float32)}
    rows = []
    for m, Iter, Mon, ctx in ((jmx, JIter, JMon, {}),
                              (tmx, TIter, TMon, {"context": CPU})):
        s = m.sym.FullyConnected(m.sym.var("data"), num_hidden=16,
                                 name="fc1")
        s = m.sym.Activation(s, act_type="relu")
        s = m.sym.SoftmaxOutput(m.sym.FullyConnected(s, num_hidden=3,
                                                     name="fc2"),
                                name="softmax")
        it = Iter(X, y, batch_size=10, label_name="softmax_label")
        mod = m.mod.Module(s, **ctx)
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        mod.init_params(arg_params={k: m.nd.array(v) if m is jmx else v
                                    for k, v in w.items()})
        mon = Mon(interval=2, pattern=".*", sort=True)
        mod.install_monitor(mon)
        got = []
        for batch in it:
            mon.tic()
            mod.forward(batch, is_train=False)
            got.append(mon.toc())
        rows.append(got)
    jr, tr = rows
    assert len(tr[0]) == 1 and tr[1] == [] == jr[1]
    (ts, tn, tv), = tr[0]
    (js, jn, jv), = jr[0]
    assert (ts, tn) == (js, jn) == (0, "softmax_output")
    np.testing.assert_allclose(float(tv.strip("[]")), float(jv.strip("[]")),
                               rtol=1e-6)


def _feat_cls(m, ctx):
    feat = m.sym.Activation(
        m.sym.FullyConnected(m.sym.Variable("data"), num_hidden=16,
                             name="feat_fc"), act_type="relu")
    cls = m.sym.SoftmaxOutput(
        m.sym.FullyConnected(m.sym.Variable("feat"), num_hidden=2,
                             name="cls_fc"), name="softmax")
    seq = m.mod.SequentialModule()
    seq.add(m.mod.Module(feat, data_names=["data"], label_names=[], **ctx))
    seq.add(m.mod.Module(cls, data_names=["feat"],
                         label_names=["softmax_label"], **ctx),
            take_labels=True)
    return seq


def test_sequential_module_matches_mxtpu():
    """``test_compat_modules.py:196``: two Modules chained, the first's
    outputs the second's data; every parameter after each epoch equal
    to mxtpu's, the accuracy of the reference test reached, and a
    checkpoint key that matches no module refused."""
    rng = np.random.RandomState(0)
    X = rng.randn(256, 8).astype(np.float32)
    Y = (X[:, 0] > 0).astype(np.float32)
    w = {"feat_fc_weight": (rng.randn(16, 8) * 0.3).astype(np.float32),
         "feat_fc_bias": np.zeros(16, np.float32),
         "cls_fc_weight": (rng.randn(2, 16) * 0.3).astype(np.float32),
         "cls_fc_bias": np.zeros(2, np.float32)}
    res = []
    for m, Iter, ctx in ((jmx, JIter, {}), (tmx, TIter, {"context": CPU})):
        it = Iter(X, Y, batch_size=32)
        seq = _feat_cls(m, ctx)
        seq.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        seq.init_params(arg_params={k: m.nd.array(v) if m is jmx else v
                                    for k, v in w.items()})
        seq.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.1, "rescale_grad": 1.0 / 32})
        snaps = []
        for _ in range(6):
            it.reset()
            for batch in it:
                seq.forward(batch, is_train=True)
                seq.backward()
                seq.update()
            snaps.append({k: v.asnumpy()
                          for k, v in seq.get_params()[0].items()})
        metric = m.metric.Accuracy()
        it.reset()
        for batch in it:
            seq.forward(batch, is_train=False)
            seq.update_metric(metric, batch.label)
        res.append((snaps, metric.get()[1]))
        with pytest.raises(Exception, match="match no module"):
            seq.init_params(arg_params={"nope": np.zeros(1, np.float32)},
                            force_init=True)
    (js, ja), (ts, ta) = res
    for a, b in zip(ts, js):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], err_msg=k, **TOL)
    assert ta == ja and ta > 0.9


def test_python_loss_module_chain_matches_mxtpu():
    """``test_compat_modules.py:236``: a PythonLossModule closes the
    chain with a hand-written softmax gradient; the weights after each
    epoch equal mxtpu's and the reference test's accuracy is reached."""
    rng = np.random.RandomState(1)
    X = rng.randn(128, 4).astype(np.float32)
    Y = (X[:, 0] > 0).astype(np.float32)
    w = {"fc_weight": (rng.randn(2, 4) * 0.3).astype(np.float32),
         "fc_bias": np.zeros(2, np.float32)}

    def softmax_grad(scores, labels):
        s = scores.asnumpy()
        e = np.exp(s - s.max(axis=1, keepdims=True))
        p = e / e.sum(axis=1, keepdims=True)
        lab = labels.asnumpy().astype(int)
        p[np.arange(len(lab)), lab] -= 1.0
        return p / len(lab)

    res = []
    for m, Iter, ctx in ((jmx, JIter, {}), (tmx, TIter, {"context": CPU})):
        it = Iter(X, Y, batch_size=32)
        body = m.sym.FullyConnected(m.sym.Variable("data"), num_hidden=2,
                                    name="fc")
        seq = m.mod.SequentialModule()
        seq.add(m.mod.Module(body, data_names=["data"], label_names=[],
                             **ctx))
        seq.add(m.mod.PythonLossModule(grad_func=softmax_grad),
                take_labels=True)
        seq.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        seq.init_params(arg_params={k: m.nd.array(v) if m is jmx else v
                                    for k, v in w.items()})
        seq.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.5})
        snaps = []
        for _ in range(4):
            it.reset()
            for batch in it:
                seq.forward(batch, is_train=True)
                seq.backward()
                seq.update()
            snaps.append({k: v.asnumpy()
                          for k, v in seq.get_params()[0].items()})
        metric = m.metric.Accuracy()
        it.reset()
        for batch in it:
            seq.forward(batch, is_train=False)
            seq.update_metric(metric, batch.label)
        res.append((snaps, metric.get()[1], seq))
    (js, ja, _), (ts, ta, tseq) = res
    for a, b in zip(ts, js):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], err_msg=k, **TOL)
    assert ta == ja and ta > 0.85
    loss_mod = tseq._modules[-1]
    assert loss_mod.output_names == ["pyloss_output"]
    assert loss_mod.get_params() == ({}, {})
    with pytest.raises(tmx.MXNetError, match="grad_func"):
        tmx.mod.PythonLossModule().backward()


def test_python_module_base():
    """PythonModule binds, takes no parameters, and wants ``forward``
    from a subclass; its default output shape is its first input's."""
    pm = tmx.mod.PythonModule(["data"], None, ["out"],
                              logger=logging.getLogger("t"))
    pm.bind([TDesc("data", (3, 2))])
    pm.init_params()
    pm.init_optimizer()
    assert pm.binded and pm.params_initialized and pm.optimizer_initialized
    assert pm.output_shapes[0].shape == (3, 2)
    with pytest.raises(NotImplementedError):
        pm.forward(None)
