"""The recurrent family of mxtpu_torch held against mxtpu's on the CPU:
the fused ``RNN`` op in its four modes (one and two layers,
bidirectional, with and without ``state_outputs``), the three
``Sequence*`` ops, the cells' ``unroll`` (``valid_length``,
``BidirectionalCell``), the ``RNN``/``LSTM``/``GRU`` layers eager and
hybridized, weights crossing as ``.params`` files, inter-layer dropout,
a two-step LSTM language-model loop and ``metric.Perplexity``; then the
cell kernel's plain versions against a numpy step, and the two limits
of mxtpu's symbolic RNN that the port keeps.

Tolerances, f32: forward rtol 1e-5 / atol 1e-6 and gradients 1e-4, as
``tests/test_rnn.py`` uses (the same products summed in another
order); the LM loop's losses and weights 1e-5 after two SGD steps at lr
1; bf16 plain versions within 2 bf16 ulps (2^-7 relative) of the f64
step, their arithmetic being f32 with the inputs and outputs rounded.
"""
import numpy as np
import pytest
import torch

import mxtpu as jmx
from mxtpu import autograd as jag
from mxtpu import nd as jnd
from mxtpu.gluon import rnn as jrnn
from mxtpu.ndarray.rnn_impl import rnn_param_size as j_param_size

import mxtpu_torch as tmx
from mxtpu_torch import autograd as tag
from mxtpu_torch import nd as tnd
from mxtpu_torch.gluon import rnn as trnn
from mxtpu_torch.kernels import rnn_cell as rc
from mxtpu_torch.ndarray.rnn_impl import rnn_param_size

from torch_gluon_names import fresh_names

torch.set_num_threads(2)
CPU = tmx.cpu()
FWD = {"rtol": 1e-5, "atol": 1e-6}
GRAD = {"rtol": 1e-4, "atol": 1e-4}


def _t(a):
    return tnd.array(a, ctx=CPU)


def _run_op(pkg, nd, ag, ins, **kw):
    """The op's outputs and every input's gradient of sum(out^2)."""
    arrs = [nd.array(a) if pkg == "j" else _t(a) for a in ins]
    for a in arrs:
        a.attach_grad()
    with ag.record():
        outs = nd.RNN(*arrs, **kw)
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        loss = sum((o * o).sum() for o in outs)
    loss.backward()
    return [o.asnumpy() for o in outs], [a.grad.asnumpy() for a in arrs]


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
@pytest.mark.parametrize("layers,bi,state_outputs",
                         [(1, False, True), (2, True, True),
                          (2, False, False)])
def test_rnn_op_matches_mxtpu(mode, layers, bi, state_outputs):
    T, N, I, H = 5, 3, 4, 6
    rng = np.random.RandomState(0)
    D = 2 if bi else 1
    P = rnn_param_size(layers, I, H, bi, mode)
    assert P == j_param_size(layers, I, H, bi, mode)
    ins = [rng.randn(T, N, I).astype(np.float32),
           (rng.randn(P) * 0.3).astype(np.float32),
           rng.randn(layers * D, N, H).astype(np.float32)]
    if mode == "lstm":
        ins.append(rng.randn(layers * D, N, H).astype(np.float32))
    kw = dict(state_size=H, num_layers=layers, mode=mode, bidirectional=bi,
              state_outputs=state_outputs)
    jo, jg = _run_op("j", jnd, jag, ins, **kw)
    to, tg = _run_op("t", tnd, tag, ins, **kw)
    assert len(to) == len(jo) == (1 if not state_outputs else
                                  3 if mode == "lstm" else 2)
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a, b, **FWD)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, **GRAD)


def test_rnn_op_shapes_and_refusals():
    """``infer_shape`` runs the op on ``meta`` (graph outputs of each
    mode's count), and a flat vector of the wrong length raises."""
    T, N, I, H = 4, 2, 3, 5
    for mode, n_out in (("lstm", 3), ("gru", 2), ("rnn_tanh", 2)):
        ins = [tmx.sym.var(n) for n in ("data", "p", "s")] + \
            ([tmx.sym.var("c")] if mode == "lstm" else [])
        out = tmx.sym.RNN(*ins, state_size=H, num_layers=2, mode=mode,
                          bidirectional=True, state_outputs=True)
        assert len(out) == n_out
        shapes = dict(data=(T, N, I), s=(4, N, H),
                      p=(rnn_param_size(2, I, H, True, mode),))
        if mode == "lstm":
            shapes["c"] = (4, N, H)
        _, outs, _ = out.infer_shape(**shapes)
        assert outs == [(T, N, 2 * H)] + [(4, N, H)] * (n_out - 1)
    with pytest.raises(tmx.MXNetError, match="layout needs"):
        tnd.RNN(_t(np.zeros((T, N, I), np.float32)),
                _t(np.zeros(7, np.float32)),
                _t(np.zeros((1, N, H), np.float32)),
                _t(np.zeros((1, N, H), np.float32)), state_size=H,
                num_layers=1)


# ------------------------------------------------------------ sequences

@pytest.mark.parametrize("op", ["SequenceMask", "SequenceLast",
                                "SequenceReverse"])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("lengths", [None, (3, 5, 1, 0), (2, 7, 5, 4)])
def test_sequence_ops_match_mxtpu(op, axis, lengths):
    """Forward and gradient, with and without lengths; a length of 0
    (SequenceLast wraps to the last step) and one past T (NaN, jax's
    fill) included."""
    T, N, C = 5, 4, 3
    rng = np.random.RandomState(1)
    shape = (T, N, C) if axis == 0 else (N, T, C)
    x = rng.randn(*shape).astype(np.float32)
    kw = {"axis": axis}
    if op == "SequenceMask":
        kw["value"] = -2.5
    res = []
    for nd, ag, arr in ((jnd, jag, jnd.array), (tnd, tag, _t)):
        ins = [arr(x)]
        if lengths is not None:
            ins.append(arr(np.asarray(lengths, np.float32)))
            kw["use_sequence_length"] = True
        ins[0].attach_grad()
        with ag.record():
            out = getattr(nd, op)(*ins, **kw)
            loss = (out * out).sum() if lengths != (2, 7, 5, 4) or \
                op == "SequenceMask" else out.sum()
        loss.backward()
        res.append((out.asnumpy(), ins[0].grad.asnumpy()))
    (jo, jg), (to, tg) = res
    np.testing.assert_allclose(to, jo, **FWD)
    np.testing.assert_allclose(tg, jg, **GRAD)


# ------------------------------------------------------------ cells

def _copy_params(jblock, tblock):
    """mxtpu's parameter values into the port's Block, by name (both
    built under ``fresh_names``)."""
    tp = tblock.collect_params()
    assert list(tp) == list(jblock.collect_params())
    for n, p in jblock.collect_params().items():
        tp[n].set_data(p.data().asnumpy())


def _cell_pair(kind, H, I):
    def build(m):
        if kind == "seq":
            c = m.SequentialRNNCell()
            c.add(m.LSTMCell(H, input_size=I))
            c.add(m.DropoutCell(0.0))
            c.add(m.ResidualCell(m.GRUCell(H, input_size=H)))
            c.add(m.RNNCell(H, activation="relu", input_size=H))
            return c
        if kind == "bi":
            return m.BidirectionalCell(m.LSTMCell(H, input_size=I),
                                       m.GRUCell(H, input_size=I))
        return {"lstm": m.LSTMCell, "gru": m.GRUCell,
                "rnn": m.RNNCell}[kind](H, input_size=I)
    with fresh_names():
        jc = build(jrnn)
    with fresh_names():
        tc = build(trnn)
    jmx.random.seed(3)
    jc.collect_params().initialize(init="xavier")
    tc.collect_params().initialize(ctx=CPU)
    _copy_params(jc, tc)
    return jc, tc


@pytest.mark.parametrize("kind", ["lstm", "gru", "rnn", "seq", "bi"])
@pytest.mark.parametrize("valid", [False, True])
def test_cell_unroll_matches_mxtpu(kind, valid):
    """``unroll`` over NTC steps, merged, with ``valid_length`` (masked
    outputs, states at each row's length) and without; gradients of
    the inputs and of every parameter."""
    T, N, I, H = 6, 3, 4, 4
    rng = np.random.RandomState(7)
    x = rng.randn(N, T, I).astype(np.float32)
    vl = np.array([2, 6, 4], np.float32)
    jc, tc = _cell_pair(kind, H, I)
    res = []
    for cell, arr, ag in ((jc, jnd.array, jag), (tc, _t, tag)):
        xa = arr(x)
        xa.attach_grad()
        with ag.record():
            outs, states = cell.unroll(
                T, xa, layout="NTC", merge_outputs=True,
                valid_length=arr(vl) if valid else None)
            loss = (outs * outs).sum() + sum((s * s).sum() for s in states)
        loss.backward()
        res.append(([outs.asnumpy()] + [s.asnumpy() for s in states],
                    [xa.grad.asnumpy()] +
                    [p.grad().asnumpy()
                     for p in cell.collect_params().values()]))
    for a, b in zip(res[1][0], res[0][0]):
        np.testing.assert_allclose(a, b, **FWD)
    for a, b in zip(res[1][1], res[0][1]):
        np.testing.assert_allclose(a, b, **GRAD)
    if valid:
        o = res[1][0][0]
        assert np.abs(o[0, 2:]).sum() == 0.0 and np.abs(o[2, 4:]).sum() == 0


def test_cell_step_list_inputs_and_refusals():
    """``unroll`` over a list of tensors (the eager F inside a
    hybrid_forward) equals the NDArray call; a BidirectionalCell cannot
    be stepped."""
    T, N, I, H = 3, 2, 3, 4
    _, tc = _cell_pair("lstm", H, I)
    x = np.random.RandomState(2).randn(T, N, I).astype(np.float32)
    a, _ = tc.unroll(T, _t(x), layout="TNC", merge_outputs=True)
    with torch.no_grad():
        b, _ = tc.unroll(T, [torch.from_numpy(v) for v in x], layout="TNC",
                         merge_outputs=True)
    np.testing.assert_allclose(b.numpy(), a.asnumpy(), **FWD)
    _, bi = _cell_pair("bi", H, I)
    with pytest.raises(tmx.MXNetError, match="use unroll"):
        bi(_t(x[0]), bi.begin_state(batch_size=N, ctx=CPU))


# ------------------------------------------------------------ layers

def _layer_pair(kind, H, layers, layout, bi, dropout=0.0):
    cls = {"lstm": "LSTM", "gru": "GRU", "rnn": "RNN"}[kind]
    with fresh_names():
        jl = getattr(jrnn, cls)(H, num_layers=layers, layout=layout,
                                bidirectional=bi, dropout=dropout)
    with fresh_names():
        tl = getattr(trnn, cls)(H, num_layers=layers, layout=layout,
                                bidirectional=bi, dropout=dropout)
    return jl, tl


@pytest.mark.parametrize("kind", ["lstm", "gru", "rnn"])
@pytest.mark.parametrize("layout,bi", [("TNC", False), ("NTC", True)])
def test_layer_matches_mxtpu(kind, layout, bi):
    """Two layers with deferred ``input_size``, states given: the port
    eager and then hybridized against mxtpu hybridized, outputs, final
    states and every gradient."""
    T, N, I, H = 5, 3, 4, 6
    rng = np.random.RandomState(4)
    jl, tl = _layer_pair(kind, H, 2, layout, bi)
    x = rng.randn(*((T, N, I) if layout == "TNC" else (N, T, I))) \
        .astype(np.float32)
    jmx.random.seed(5)
    jl.initialize(init="xavier")
    jl.hybridize()
    jl(jnd.array(x))
    tl.initialize(ctx=CPU)
    tl(_t(x))
    _copy_params(jl, tl)
    D = 2 if bi else 1
    st = [rng.randn(2 * D, N, H).astype(np.float32)
          for _ in jl.state_info(N)]

    def run(layer, arr, ag):
        xa = arr(x)
        xa.attach_grad()
        with ag.record():
            out, states = layer(xa, [arr(s) for s in st])
            loss = (out * out).sum() + sum((s * s).sum() for s in states)
        loss.backward()
        return ([out.asnumpy()] + [s.asnumpy() for s in states],
                [xa.grad.asnumpy()] +
                [p.grad().asnumpy() for p in layer.collect_params().values()])
    want = run(jl, jnd.array, jag)
    eager = run(tl, _t, tag)
    tl.hybridize()
    for got in (eager, run(tl, _t, tag)):
        for a, b in zip(got[0], want[0]):
            np.testing.assert_allclose(a, b, **FWD)
        for a, b in zip(got[1], want[1]):
            np.testing.assert_allclose(a, b, **GRAD)


def test_layer_params_cross_as_files(tmp_path):
    """``save_parameters`` writes mxtpu's structural names
    (``l0_i2h_weight``, ``r1_h2h_bias``, ...) both ways; after loading,
    both packages compute the same function without states."""
    T, N, I, H = 4, 2, 3, 5
    x = np.random.RandomState(6).randn(T, N, I).astype(np.float32)
    jl, tl = _layer_pair("lstm", H, 2, "TNC", True)
    tl.initialize(ctx=CPU)
    tl(_t(x))
    tl.save_parameters(str(tmp_path / "t.params"))
    jl.load_parameters(str(tmp_path / "t.params"))
    keys = set(jnd.load(str(tmp_path / "t.params")))
    assert {"l0_i2h_weight", "r1_h2h_bias"} <= keys and len(keys) == 16
    np.testing.assert_allclose(tl(_t(x)).asnumpy(),
                               jl(jnd.array(x)).asnumpy(), **FWD)
    jl2, tl2 = _layer_pair("lstm", H, 2, "TNC", True)
    jl.save_parameters(str(tmp_path / "j.params"))
    tl2.load_parameters(str(tmp_path / "j.params"), ctx=CPU)
    np.testing.assert_allclose(tl2(_t(x)).asnumpy(),
                               jl(jnd.array(x)).asnumpy(), **FWD)


def test_layer_symbol_compose_matches_eager():
    """The layer on a Symbol: graph inputs ``<prefix>begin_state_i``, a
    warning when dropout is on in training, and the bound graph equal
    to the eager call."""
    T, N, I, H = 5, 2, 3, 4
    _, tl = _layer_pair("gru", H, 2, "TNC", False, dropout=0.3)
    tl.initialize(ctx=CPU)
    x = np.random.RandomState(9).randn(T, N, I).astype(np.float32)
    want = tl(_t(x)).asnumpy()
    with tag.train_mode(), pytest.warns(UserWarning, match="inactive"):
        tl(tmx.sym.var("data"))
    out = tl(tmx.sym.var("data"))
    args = out.list_arguments()
    assert f"{tl.prefix}begin_state_0" in args
    params = tl.collect_params()
    bind = {a: (_t(x) if a == "data" else
                tnd.zeros((2, N, H), ctx=CPU) if "begin_state" in a
                else params[a].data()) for a in args}
    got = out.eval(ctx=CPU, **bind)
    np.testing.assert_allclose(got[0].asnumpy(), want, **FWD)


def test_inter_layer_dropout():
    """p 0.5 between layers: on a stack that passes positive inputs
    through (ReLU layers, identity i2h, no recurrence) each output is
    either 0 or 2x its input, never 4x (the last layer is not masked),
    about half kept; the gluon layer draws no key outside training
    and then equals p = 0."""
    T, N, H = 8, 16, 32
    x = np.abs(np.random.RandomState(0).randn(T, N, H)).astype(np.float32) \
        + 0.5
    eye = np.eye(H, dtype=np.float32).ravel()
    zeros = np.zeros(H * H, np.float32)
    flat = np.concatenate([eye, zeros, eye, zeros,
                           np.zeros(4 * H, np.float32)])
    tmx.random.seed(0)
    out = tnd.RNN(_t(x), _t(flat), _t(np.zeros((2, N, H), np.float32)),
                  _t(np.zeros(2, np.int64)), state_size=H, num_layers=2,
                  mode="rnn_relu", p=0.5).asnumpy()
    kept = out != 0
    np.testing.assert_allclose(out[kept], 2 * x[kept], rtol=1e-6)
    assert 0.45 < kept.mean() < 0.55
    # the gluon layer: a key only in training mode
    _, tl = _layer_pair("lstm", H, 2, "TNC", False, dropout=0.5)
    tl.initialize(ctx=CPU)
    xa = _t(x)
    eval_out = tl(xa).asnumpy()
    with fresh_names():
        ref = trnn.LSTM(H, num_layers=2, dropout=0.0)
    ref.initialize(ctx=CPU)
    ref(xa)
    for n, p in tl.collect_params().items():
        ref.collect_params()[n.replace(tl.prefix, ref.prefix)].set_data(
            p.data().asnumpy())
    np.testing.assert_array_equal(ref(xa).asnumpy(), eval_out)
    with tag.train_mode():
        train_out = tl(xa).asnumpy()
    assert not np.array_equal(train_out, eval_out)


# ------------------------------------------------------------ LM loop

V, E, HID, STEPS, BATCH = 30, 8, 12, 7, 4


def _lm(pkg):
    gl = pkg.gluon

    class LM(gl.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.embed = gl.nn.Embedding(V, E)
            self.lstm = gl.rnn.LSTM(HID, num_layers=2, layout="NTC",
                                    dropout=0.0, input_size=E)
            self.out = gl.nn.Dense(V, flatten=False, in_units=HID)

        def forward(self, x, states):
            y, states = self.lstm(self.embed(x), states)
            return self.out(y), states
    return LM()


def test_lm_training_loop_matches_mxtpu():
    """``examples/char_rnn.py``'s net at a tiny width, trained as the LM
    runs on the card: a loss a token, SGD lr 1 with ``trainer.step(N x
    T)``, ``clip_global_norm`` at 10 x N x T of the summed gradients,
    hidden states carried across the two batches with ``detach()``; the
    losses, perplexities and every weight after each step."""
    rng = np.random.RandomState(11)
    toks = rng.randint(0, V, (2, BATCH, STEPS + 1)).astype(np.float32)
    with fresh_names():
        jnet = _lm(jmx)
    with fresh_names():
        tnet = _lm(tmx)
    jmx.random.seed(0)
    jnet.initialize(init="xavier")
    tnet.initialize(ctx=CPU)
    _copy_params(jnet, tnet)
    runs = []
    for pkg, net, arr, ag, kw in (
            (jmx, jnet, jnd.array, jag, {}),
            (tmx, tnet, _t, tag, {"ctx": CPU})):
        trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 1.0})
        L = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        ppl = pkg.metric.Perplexity()
        states = net.lstm.begin_state(batch_size=BATCH, **kw)
        losses, weights = [], []
        for b in range(2):
            x, y = arr(toks[b, :, :-1]), arr(toks[b, :, 1:])
            states = [s.detach() for s in states]
            with ag.record():
                out, states = net(x, states)
                loss = L(out.reshape((-1, V)), y.reshape((-1,)))
            loss.backward()
            grads = [p.grad() for p in net.collect_params().values()]
            norm = pkg.gluon.utils.clip_global_norm(
                grads, 10.0 * BATCH * STEPS)
            trainer.step(BATCH * STEPS)
            ppl.update([y], [pkg.nd.softmax(out)])
            losses.extend([float(loss.mean().asnumpy()), float(norm)])
            weights.append([p.data().asnumpy().copy()
                            for p in net.collect_params().values()])
        runs.append((losses, weights, ppl.get()[1]))
    (jl, jw, jp), (tl, tw, tp) = runs
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tp, jp, rtol=1e-5)
    for a_step, b_step in zip(tw, jw):
        for a, b in zip(a_step, b_step):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_perplexity_matches_mxtpu():
    rng = np.random.RandomState(3)
    p = rng.rand(6, 5).astype(np.float32)
    p /= p.sum(1, keepdims=True)
    lab = np.array([0, 4, 2, 2, 1, 3], np.float32)
    for ignore in (None, 2):
        j = jmx.metric.create("perplexity", ignore_label=ignore)
        t = tmx.metric.create("perplexity", ignore_label=ignore)
        j.update([jnd.array(lab)], [jnd.array(p)])
        t.update([_t(lab)], [_t(p)])
        assert t.get()[0] == "perplexity"
        np.testing.assert_allclose(t.get()[1], j.get()[1], rtol=1e-6)


# ---------------------------------------- the kernel's plain versions

def _np_lstm(pre, hh, c):
    g = pre + hh
    H = c.shape[1]
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731
    i, f, gg, o = (g[:, k * H:(k + 1) * H] for k in range(4))
    c2 = sig(f) * c + sig(i) * np.tanh(gg)
    return sig(o) * np.tanh(c2), c2


def _np_gru(pre, hh, b_rn, h):
    H = h.shape[1]
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731
    r = sig(pre[:, :H] + hh[:, :H])
    z = sig(pre[:, H:2 * H] + hh[:, H:2 * H])
    n = np.tanh(pre[:, 2 * H:] + r * (hh[:, 2 * H:] + b_rn))
    return (1 - z) * n + z * h


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,H", [(20, 24), (3, 37)])
def test_cell_plain_versions_match_numpy(dtype, N, H):
    """lstm_cell and gru_cell on CPU tensors (the plain versions):
    forward against a numpy step in f64 and the backward against
    autograd of the same step in f64; f32 at 1e-5, bf16 within 2 ulps
    of the rounded inputs' exact result (the outputs rounded once)."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(N + H)
    tol = {"rtol": 1e-5, "atol": 1e-6} if dtype == "float32" else \
        {"rtol": 2 ** -7, "atol": 2 ** -7}

    def r(*s):
        return torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dt)
    pre, hh, c = r(N, 4 * H), r(N, 4 * H), r(N, H)
    h_t, c_t = rc.lstm_cell(pre, hh, c)
    h_n, c_n = _np_lstm(*(t.double().numpy() for t in (pre, hh, c)))
    np.testing.assert_allclose(h_t.double().numpy(), h_n, **tol)
    np.testing.assert_allclose(c_t.double().numpy(), c_n, **tol)
    pre3, hh3, brn = r(N, 3 * H), r(N, 3 * H), r(H)
    g_t = rc.gru_cell(pre3, hh3, brn, c)
    g_n = _np_gru(*(t.double().numpy() for t in (pre3, hh3, brn, c)))
    np.testing.assert_allclose(g_t.double().numpy(), g_n, **tol)

    # backward: the Functions' gradients against autograd of the f64
    # step, the cotangents dh, dc
    dh, dc = r(N, H), r(N, H)
    leaves = [t.clone().requires_grad_(True) for t in (pre, hh, c)]
    h_t, c_t = rc.lstm_cell(*leaves)
    got = torch.autograd.grad((h_t, c_t), leaves, (dh, dc))
    l64 = [t.double().requires_grad_(True) for t in (pre, hh, c)]
    g4 = l64[0] + l64[1]
    i, f, gg, o = g4.chunk(4, 1)
    c2 = torch.sigmoid(f) * l64[2] + torch.sigmoid(i) * torch.tanh(gg)
    want = torch.autograd.grad((torch.sigmoid(o) * torch.tanh(c2), c2),
                               l64, (dh.double(), dc.double()))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.double().numpy(), b.numpy(), **tol)
    leaves = [t.clone().requires_grad_(True) for t in (pre3, hh3, brn, c)]
    got = torch.autograd.grad(rc.gru_cell(*leaves), leaves, dh)
    l64 = [t.double().requires_grad_(True) for t in (pre3, hh3, brn, c)]
    pr, pz, pn = l64[0].chunk(3, 1)
    qr, qz, qn = l64[1].chunk(3, 1)
    rr, zz = torch.sigmoid(pr + qr), torch.sigmoid(pz + qz)
    nn_ = torch.tanh(pn + rr * (qn + l64[2]))
    want = torch.autograd.grad((1 - zz) * nn_ + zz * l64[3], l64,
                               dh.double())
    # db_rn sums N rows: its bound grows with them
    for k, (a, b) in enumerate(zip(got, want)):
        t = dict(tol)
        if k == 2 and dtype == "bfloat16":
            t["atol"] = 2 ** -7 * N
        np.testing.assert_allclose(a.double().numpy(), b.numpy(), **t)


def test_cell_wrappers_refuse_what_the_kernel_cannot_take():
    """Shapes and types are checked before a launch; a CPU call counts
    no launch."""
    from mxtpu_torch import kernels
    kernels.reset_launch_counts()
    with pytest.raises(tmx.MXNetError, match="expected"):
        rc._check("lstm_fwd", 4, torch.zeros(2, 6))
    with pytest.raises(tmx.MXNetError, match="f32 or bf16"):
        rc._check("lstm_fwd", 4, torch.zeros(2, 8, dtype=torch.float64))
    with pytest.raises(tmx.MXNetError, match="mixed types"):
        rc._check("lstm_fwd", 4, torch.zeros(2, 8),
                  torch.zeros(2, 8, dtype=torch.bfloat16))
    with pytest.raises(tmx.MXNetError, match="contiguous"):
        rc._check("lstm_fwd", 4, torch.zeros(2, 8), torch.zeros(8, 2).t())
    rc.lstm_cell(torch.zeros(2, 8), torch.zeros(2, 8), torch.zeros(2, 2))
    assert kernels.launch_counts()["lstm_cell_fwd"] == 0


# ---------------------------------------- mxtpu's limits, pinned

def _bucket_lstm_sym(pkg):
    def sym_gen(seq_len):
        data = pkg.sym.var("data")
        emb = pkg.sym.Embedding(data, input_dim=20, output_dim=8,
                                name="embed")
        lstm = pkg.gluon.rnn.LSTM(8, layout="NTC", prefix="lstm_")
        out = pkg.sym.FullyConnected(lstm(emb), num_hidden=20,
                                     flatten=False, name="pred")
        out = pkg.sym.SoftmaxOutput(pkg.sym.reshape(out, shape=(-1, 20)),
                                    name="softmax")
        return out, ("data",), ("softmax_label",)
    return sym_gen


@pytest.mark.parametrize("pkg", ["mxtpu", "mxtpu_torch"])
def test_fused_layer_in_bucketing_module_fails_at_bind(pkg):
    """mxtpu cannot bind the fused layer composed on a Symbol inside a
    BucketingModule: infer_shape cannot find the begin states' (and so
    the weights') shapes.  The port raises alike."""
    m = jmx if pkg == "mxtpu" else tmx
    ctx = {} if pkg == "mxtpu" else {"context": CPU}
    mod = m.mod.BucketingModule(_bucket_lstm_sym(m), default_bucket_key=6,
                                **ctx)
    with pytest.raises(Exception, match="could not infer.*lstm_begin_state_0"):
        mod.bind(data_shapes=[("data", (4, 6))],
                 label_shapes=[("softmax_label", (24,))])


@pytest.mark.parametrize("pkg", ["mxtpu", "mxtpu_torch"])
def test_cell_unroll_on_symbol_raises(pkg):
    """The cells do not unroll on a Symbol in mxtpu (``_format_sequence``
    reads ``shape``); nor in the port."""
    m = jmx if pkg == "mxtpu" else tmx
    cell = m.gluon.rnn.SequentialRNNCell()
    cell.add(m.gluon.rnn.LSTMCell(4))
    with pytest.raises(AttributeError, match="shape"):
        cell.unroll(3, m.sym.var("data"), layout="NTC")
