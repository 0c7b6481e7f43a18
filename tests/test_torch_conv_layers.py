"""The N-d convolution, transposed-convolution, pooling and padding
layers of Gluon (``mxtpu_torch/gluon/nn/conv_layers.py``) and the
``Deconvolution`` op, held against mxtpu on the CPU.

Each layer is built in both packages with fresh name counters; the
port draws the weights (Xavier, a seeded torch stream) and mxtpu takes
them by name.  The same numpy input (seed 0) and output gradient go to
both; outputs, input gradients and weight gradients agree to 1e-5
(f32, the same sums in another order).  Also: deferred weight shapes
before and after the first forward, ``output_padding`` (``adj``),
which mxtpu's op ignores (pinned here as a reference behaviour),
``num_group > 1`` (mxtpu passes no group count to
``lax.conv_transpose``: the weights' second axis is the output's width,
and a bias of ``num_filter`` fails to broadcast), a padding above
dilate·(k - 1) (mxtpu crops), the ``Deconvolution`` shape hook, and a
``Conv2DTranspose`` net's export JSON byte-equal to mxtpu's.
"""
import numpy as np
import pytest
import torch

import mxtpu as jmx
from mxtpu import autograd as jautograd, nd as jnd
from mxtpu.gluon import nn as jnn

import mxtpu_torch as tmx
from mxtpu_torch import autograd, nd, random as trandom
from mxtpu_torch.convert import named_tensors
from mxtpu_torch.gluon import nn

from tests.torch_gluon_names import fresh_names

torch.set_num_threads(2)

CPU = tmx.cpu()
TOL = 1e-5

T2 = dict(strides=2, padding=1, dilation=2)
# (class name, kwargs, input shape)
CASES = [
    ("Conv1D", dict(channels=4, kernel_size=3, **T2), (2, 3, 11)),
    ("Conv1D", dict(channels=4, kernel_size=3, layout="NWC", **T2),
     (2, 11, 3)),
    ("Conv1D", dict(channels=4, kernel_size=3, groups=2, activation="relu"),
     (2, 4, 9)),
    ("Conv2D", dict(channels=4, kernel_size=3, **T2), (2, 3, 9, 9)),
    ("Conv3D", dict(channels=4, kernel_size=3, **T2), (2, 3, 7, 7, 7)),
    ("Conv3D", dict(channels=4, kernel_size=(1, 3, 3), layout="NDHWC",
                    **T2), (2, 5, 7, 7, 3)),
    ("Conv1DTranspose", dict(channels=4, kernel_size=3, **T2), (2, 3, 6)),
    ("Conv1DTranspose", dict(channels=4, kernel_size=3, layout="NWC", **T2),
     (2, 6, 3)),
    ("Conv2DTranspose", dict(channels=4, kernel_size=3, **T2),
     (2, 3, 5, 5)),
    ("Conv2DTranspose", dict(channels=4, kernel_size=3, layout="NHWC",
                             **T2), (2, 5, 5, 3)),
    ("Conv2DTranspose", dict(channels=4, kernel_size=(3, 2), strides=2,
                             padding=(3, 2), use_bias=False),
     (2, 3, 6, 6)),
    ("Conv2DTranspose", dict(channels=4, kernel_size=4, strides=2,
                             padding=1, activation="tanh"), (2, 3, 5, 4)),
    ("Conv3DTranspose", dict(channels=4, kernel_size=3, **T2),
     (2, 3, 4, 4, 4)),
    ("Conv3DTranspose", dict(channels=2, kernel_size=2, strides=2,
                             layout="NDHWC"), (2, 3, 3, 3, 3)),
    ("MaxPool1D", dict(pool_size=3, strides=2, padding=1), (2, 3, 11)),
    ("MaxPool1D", dict(pool_size=2, layout="NWC"), (2, 10, 3)),
    ("AvgPool1D", dict(pool_size=3, strides=2, padding=1,
                       count_include_pad=False), (2, 3, 11)),
    ("MaxPool3D", dict(pool_size=3, strides=2, padding=1), (2, 3, 7, 7, 7)),
    ("MaxPool3D", dict(layout="NDHWC"), (2, 6, 6, 6, 3)),
    ("AvgPool3D", dict(pool_size=3, strides=2, padding=1), (2, 3, 7, 7, 7)),
    ("AvgPool3D", dict(pool_size=2, count_include_pad=False, padding=1),
     (2, 3, 5, 5, 5)),
    ("GlobalMaxPool1D", dict(), (2, 3, 11)),
    ("GlobalAvgPool1D", dict(layout="NWC"), (2, 11, 3)),
    ("GlobalMaxPool3D", dict(), (2, 3, 4, 5, 6)),
    ("GlobalAvgPool3D", dict(), (2, 3, 4, 5, 6)),
    ("ReflectionPad2D", dict(padding=2), (2, 3, 6, 7)),
    ("ReflectionPad2D", dict(padding=(1, 2, 3, 0)), (2, 3, 6, 7)),
]


def _make(mx_nn, name, kw):
    with fresh_names():
        return getattr(mx_nn, name)(**kw)


def _pair(name, kw, shape):
    """The layer in both packages with the port's Xavier weights (drawn
    after one forward settles the deferred shapes) set into mxtpu's by
    name."""
    trandom.seed(0)
    tnet = _make(nn, name, kw)
    tnet.initialize(init="xavier", ctx=CPU)
    tnet(torch.zeros(shape))
    w = {n: t.detach().numpy().copy() for n, t in named_tensors(tnet)}
    jnet = _make(jnn, name, kw)
    jnet.initialize()
    jnet(jnd.zeros(shape))
    assert list(jnet.collect_params()) == list(w)
    for n, p in jnet.collect_params().items():
        assert p.shape == w[n].shape, n
        p.set_data(jnd.array(w[n]))
    return jnet, tnet


def _run(jnet, tnet, shape, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    jx = jnd.array(x)
    jx.attach_grad()
    with jautograd.record():
        jy = jnet(jx)
    head = rng.randn(*jy.shape).astype(np.float32)
    jy.backward(jnd.array(head))
    tx = torch.from_numpy(x).requires_grad_()
    tparams = [t for _, t in named_tensors(tnet) if t.requires_grad]
    with autograd.record():
        ty = tnet(tx)
    grads = torch.autograd.grad(ty, [tx] + tparams, torch.from_numpy(head))
    jgrads = [jx.grad.asnumpy()] + [
        p.grad().asnumpy() for p in jnet.collect_params().values()
        if p.grad_req != "null"]
    return jy.asnumpy(), ty.detach().numpy(), jgrads, \
        [g.numpy() for g in grads]


@pytest.mark.parametrize("name,kw,shape", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_layer_matches_mxtpu_forward_and_backward(name, kw, shape):
    jnet, tnet = _pair(name, kw, shape)
    jy, ty, jg, tg = _run(jnet, tnet, shape)
    assert ty.shape == jy.shape
    np.testing.assert_allclose(ty, jy, rtol=TOL, atol=TOL)
    assert len(tg) == len(jg)
    for a, b in zip(tg, jg):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    assert repr(tnet) == repr(jnet)


@pytest.mark.parametrize("name,kw,shape", [
    c for c in CASES if c[0].startswith("Conv")][:10])
def test_deferred_weight_shapes_match_mxtpu(name, kw, shape):
    jnet, tnet = _make(jnn, name, kw), _make(nn, name, kw)
    before = [p.shape for p in jnet.collect_params().values()]
    assert [p.shape for p in tnet.collect_params().values()] == before
    jnet.initialize()
    jnet(jnd.zeros(shape))
    tnet.initialize(ctx=CPU)
    tnet(torch.zeros(shape))
    assert [p.shape for p in tnet.collect_params().values()] == \
        [p.shape for p in jnet.collect_params().values()]
    # explicit in_channels: the shapes are known at construction
    last = not kw.get("layout", "NC").startswith("NC")
    c_in = shape[-1 if last else 1]
    kw2 = dict(kw, in_channels=c_in)
    assert [p.shape for p in _make(nn, name, kw2).collect_params()
            .values()] == [p.shape for p in _make(jnn, name, kw2)
                           .collect_params().values()]


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_output_padding_is_ignored_as_in_mxtpu(ndim):
    """mxtpu's ``_deconvolution`` takes ``adj`` and never reads it, so
    ``output_padding`` changes nothing (upstream MXNet would grow the
    output by it): a reference behaviour, followed."""
    name = f"Conv{ndim}DTranspose"
    shape = (2, 3) + (4,) * ndim
    kw = dict(channels=2, kernel_size=3, strides=2, padding=1)
    jnet, tnet = _pair(name, kw, shape)
    jnet2, tnet2 = _pair(name, dict(kw, output_padding=1), shape)
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    y = tnet(torch.from_numpy(x)).detach().numpy()
    y2 = tnet2(torch.from_numpy(x)).detach().numpy()
    assert y.shape == (2, 2) + (7,) * ndim
    np.testing.assert_array_equal(y2, y)
    np.testing.assert_allclose(y2, jnet2(jnd.array(x)).asnumpy(),
                               rtol=TOL, atol=TOL)
    kwo = dict(kernel=(3,) * ndim, stride=(2,) * ndim, pad=(1,) * ndim,
               num_filter=2, no_bias=True)
    w = np.random.RandomState(2).randn(3, 2, *(3,) * ndim) \
        .astype(np.float32)
    a = nd.Deconvolution(nd.array(x, ctx=CPU), nd.array(w, ctx=CPU),
                         adj=(1,) * ndim, **kwo).asnumpy()
    b = nd.Deconvolution(nd.array(x, ctx=CPU), nd.array(w, ctx=CPU),
                         **kwo).asnumpy()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(
        a, jnd.Deconvolution(jnd.array(x), jnd.array(w), adj=(1,) * ndim,
                             **kwo).asnumpy(), rtol=TOL, atol=TOL)


def test_num_group_is_not_passed_on_as_in_mxtpu():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 4, 5, 5).astype(np.float32)
    w = rng.randn(4, 2, 3, 3).astype(np.float32)
    kw = dict(kernel=(3, 3), num_filter=4, num_group=2)
    want = jnd.Deconvolution(jnd.array(x), jnd.array(w), no_bias=True, **kw)
    got = nd.Deconvolution(nd.array(x, ctx=CPU), nd.array(w, ctx=CPU),
                           no_bias=True, **kw)
    assert got.shape == want.shape == (2, 2, 7, 7)
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=TOL,
                               atol=TOL)
    b = np.zeros(4, np.float32)
    with pytest.raises(TypeError):
        jnd.Deconvolution(jnd.array(x), jnd.array(w), jnd.array(b), **kw)
    with pytest.raises(TypeError):
        nd.Deconvolution(nd.array(x, ctx=CPU), nd.array(w, ctx=CPU),
                         nd.array(b, ctx=CPU), **kw)


@pytest.mark.parametrize("pad,dilate", [((0, 0), (1, 1)), ((1, 2), (1, 1)),
                                        ((3, 3), (1, 1)), ((5, 2), (2, 1)),
                                        ((2, 0), (2, 3))])
def test_deconvolution_op_matches_mxtpu(pad, dilate):
    """Paddings on both sides of dilate·(k - 1), where mxtpu's padding
    of the dilated input goes negative (a crop)."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 6, 5).astype(np.float32)
    w = rng.randn(3, 4, 3, 3).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    kw = dict(kernel=(3, 3), stride=(2, 3), pad=pad, dilate=dilate,
              num_filter=4)
    jx, jw, jb = jnd.array(x), jnd.array(w), jnd.array(b)
    for a in (jx, jw, jb):
        a.attach_grad()
    with jautograd.record():
        jy = jnd.Deconvolution(jx, jw, jb, **kw)
    head = rng.randn(*jy.shape).astype(np.float32)
    jy.backward(jnd.array(head))
    tx, tw, tb = (nd.array(a, ctx=CPU) for a in (x, w, b))
    for a in (tx, tw, tb):
        a.attach_grad()
    with autograd.record():
        ty = nd.Deconvolution(tx, tw, tb, **kw)
    ty.backward(nd.array(head, ctx=CPU))
    assert ty.shape == jy.shape
    np.testing.assert_allclose(ty.asnumpy(), jy.asnumpy(), rtol=TOL,
                               atol=TOL)
    for t, j in ((tx, jx), (tw, jw), (tb, jb)):
        np.testing.assert_allclose(t.grad.asnumpy(), j.grad.asnumpy(),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kw", [
    dict(kernel=(3, 3), num_filter=6),
    dict(kernel=(2, 3, 3), num_filter=6, num_group=3, no_bias=True),
    dict(kernel=(4,), num_filter=2, stride=(2,), pad=(1,))])
def test_deconvolution_infer_shape_matches_mxtpu(kw):
    nd_ = len(kw["kernel"])
    data = (2, 3) + (5,) * nd_
    got = tmx.sym.Deconvolution(tmx.sym.Variable("data"), name="dc", **kw) \
        .infer_shape(data=data)
    want = jmx.sym.Deconvolution(jmx.sym.Variable("data"), name="dc",
                                 **kw).infer_shape(data=data)
    assert got == want


def test_conv2d_transpose_export_is_mxtpus(monkeypatch, tmp_path):
    import mxtpu.symbol as jsym
    import mxtpu_torch.symbol as tsym
    shape = (2, 3, 5, 5)

    def build(mx_nn):
        with fresh_names():
            net = mx_nn.HybridSequential(prefix="gen_")
            with net.name_scope():
                net.add(mx_nn.Conv2DTranspose(8, 4, strides=2, padding=1,
                                              use_bias=False),
                        mx_nn.BatchNorm(),
                        mx_nn.Activation("relu"),
                        mx_nn.Conv2DTranspose(3, 4, strides=2, padding=1,
                                              activation="tanh"))
        return net
    trandom.seed(0)
    tnet = build(nn)
    tnet.initialize(init="xavier", ctx=CPU)
    tnet(torch.zeros(shape))
    jnet = build(jnn)
    jnet.initialize()
    jnet(jnd.zeros(shape))
    w = {n: t.detach().numpy() for n, t in named_tensors(tnet)}
    for n, p in jnet.collect_params().items():
        p.set_data(jnd.array(w[n]))
    jnet.hybridize()
    monkeypatch.setattr(jsym, "_NAME_COUNTERS", {})
    jnet(jnd.zeros(shape))
    jsf = jnet.export(str(tmp_path / "j"))[0]
    monkeypatch.setattr(tsym, "_NAME_COUNTERS", {})
    tsf, tpf = tnet.export(str(tmp_path / "t"))
    with open(jsf) as a, open(tsf) as b:
        assert b.read() == a.read()
    blk = tmx.gluon.SymbolBlock.imports(tsf, ["data"], tpf, ctx=CPU)
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    np.testing.assert_allclose(blk(nd.array(x, ctx=CPU)).asnumpy(),
                               tnet(torch.from_numpy(x)).detach().numpy(),
                               rtol=1e-6, atol=1e-6)
