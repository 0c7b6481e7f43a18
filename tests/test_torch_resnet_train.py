"""A narrow ResNet V1 trained by mxtpu_torch on the CPU, held against
mxtpu's model and per-parameter train step; also the layers it is made
of (BatchNorm, Conv2D, MaxPool2D, GlobalAvgPool2D, Dense), the weight
carry with BatchNorm's running statistics, and the Xavier initializer.

The network is ``ResNetV1(BottleneckV1, [1, 1, 1, 1], [8, 16, 32, 64,
128], classes=10)`` with the 7x7 stem and the max pool, on (2, 3, 64,
64) images, in NCHW (the channels-major BN kernels' path) and NHWC (the
channels-minor ones).  At 32x32 the last stage is 1x1, so its BNs
normalize 2 values per channel and the net is ill-conditioned: mxtpu's
own f32 logits land 1e-3 from an f64 evaluation there; at 64x64 they
land 2.3e-5 from it, and the port's 2.3e-6.  The weights start in
mxtpu (xavier) and cross with ``params_from_mxtpu`` by name (both
packages build with fresh name counters), running statistics
included.  mxtpu's side
runs its traced forward and its compiled train step (its eager forward
costs tens of seconds on the CPU); its deferred parameters get their
shapes from the port's model by name, after one forward of the port's
model has inferred them.

Tolerances, f32: logits 1e-4 (mxtpu's f32 error above), gradients
1e-4 relative L2 per tensor (convolutions and BN sums in another
order), three SGD-momentum steps
1e-4 on losses, parameters and running statistics.  Under a bf16
compute type the two frameworks round at other places (mxtpu's
composite BatchNorm rounds its output to bf16 before the residual add;
the port's fused kernel adds in f32 and rounds once), and a bf16
max-pool window can hold two equal maxima, whose gradient each
framework routes to a different element; the first step's loss is
held at 2e-2 relative, and the later ones only to fall (see the
test).  The
ReLU at exactly 0: mxtpu's composite uses ``jnp.maximum``, whose
gradient at 0 is 0.5, the port's kernels give 0; in f32 no
pre-activation here is exactly 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxtpu import autograd, nd
from mxtpu import parallel as jpar
from mxtpu.gluon import loss as jloss
from mxtpu.gluon import nn as jnn
from mxtpu.gluon.block import _traced_forward
from mxtpu.gluon.model_zoo.vision.resnet import BottleneckV1 as JBottleneck
from mxtpu.gluon.model_zoo.vision.resnet import ResNetV1 as JResNetV1
from mxtpu.ndarray.ndarray import NDArray

from mxtpu_torch import MXNetError, autograd as tautograd, cpu
from mxtpu_torch import initializer, random as trandom
from mxtpu_torch.convert import (named_tensors, params_from_mxtpu,
                                 params_to_mxtpu)
from mxtpu_torch.gluon import nn as tnn
from mxtpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxtpu_torch.gluon.model_zoo.vision import (BottleneckV1, ResNetV1,
                                                get_resnet, resnet50_v1)
from mxtpu_torch.models import resnet50
from mxtpu_torch.parallel import build_train_step

from tests.torch_gluon_names import fresh_names

torch.set_num_threads(2)

LAYERS, CHANNELS, CLASSES = [1, 1, 1, 1], [8, 16, 32, 64, 128], 10
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
LAYOUTS = ["NCHW", "NHWC"]


def _data(layout, seed=0):
    rng = np.random.RandomState(seed)
    shape = (2, 3, 64, 64) if layout == "NCHW" else (2, 64, 64, 3)
    return rng.randn(*shape).astype(np.float32), \
        np.array([1.0, 7.0], np.float32)


def _shaped(net, layout, hw=32):
    """One forward of a zero image (predict mode) fills the deferred
    shapes."""
    shape = (1, 3, hw, hw) if layout == "NCHW" else (1, hw, hw, 3)
    net(torch.zeros(shape))
    return net


def _torch_net(layout, params=None):
    """The port's network named as a fresh process names it: ``params``
    carried in by name, else xavier weights of its own on the CPU."""
    with fresh_names():
        net = ResNetV1(BottleneckV1, LAYERS, CHANNELS, classes=CLASSES,
                       layout=layout)
    if params is not None:
        return params_from_mxtpu(params, net)
    net.initialize(init="xavier", ctx=cpu())
    return _shaped(net, layout)


def _jax_net(layout):
    """mxtpu's network, xavier-initialized, its deferred shapes taken
    from the port's model by name."""
    with fresh_names():
        net = JResNetV1(JBottleneck, LAYERS, CHANNELS, classes=CLASSES,
                        layout=layout)
    shapes = {n: tuple(t.shape) for n, t in
              named_tensors(_torch_net(layout))}
    params = net.collect_params()
    assert list(params) == list(shapes)
    for n, p in params.items():
        p.shape = shapes[n]
    net.initialize(init="xavier")
    return net


def _jax_params(net):
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


def _jax_forward_grads(net, x, y):
    """mxtpu's training-mode logits, the gradient of the mean loss with
    respect to every parameter, and the running-stat updates, from one
    jitted trace of its forward."""
    params = list(net.collect_params().values())
    vals = [p.data().data for p in params]
    loss_fn = jloss.SoftmaxCrossEntropyLoss()

    def f(vals, xx, yy):
        outs, _, aux_params, aux = _traced_forward(
            net, params, vals, [NDArray(xx, None, _placed=True)], True,
            jax.random.key_data(jax.random.PRNGKey(0)))
        loss = loss_fn(NDArray(outs[0], None, _placed=True),
                       NDArray(yy, None, _placed=True))
        return jnp.mean(loss.data), (outs[0], aux)
    (loss, (logits, aux)), grads = jax.jit(jax.value_and_grad(
        f, has_aux=True))(vals, jnp.asarray(x), jnp.asarray(y))
    names = list(net.collect_params())
    train = [i for i, p in enumerate(params) if p.grad_req != "null"]
    return (float(loss), np.asarray(logits),
            {names[i]: np.asarray(grads[i]) for i in train})


_CE = SoftmaxCrossEntropyLoss()


def _grad_close(a, b, floor):
    """rms(a - b) <= 1e-4 * rms(b) + floor.  A convolution bias that
    feeds a BatchNorm has a zero gradient in exact arithmetic (the
    batch mean removes it), so both sides hold rounding noise there;
    ``floor`` is 1e-6 of the largest gradient rms of the net (that
    noise measured 4e-7 of it; every other gradient here is within
    3.4e-5 of mxtpu's, which is itself up to 3.6e-5 from an f64
    evaluation)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    rms = lambda t: float(np.sqrt(np.mean(t * t)))  # noqa: E731
    return rms(a - b) <= 1e-4 * rms(b) + floor


# -------------------------------------------------------------- the slice

@pytest.mark.parametrize("layout", LAYOUTS)
def test_logits_and_gradients_match_mxtpu(layout):
    jnet = _jax_net(layout)
    params = _jax_params(jnet)
    x, y = _data(layout)
    jl, jlogits, jgrads = _jax_forward_grads(jnet, x, y)
    tnet = _torch_net(layout, params)
    with tautograd.train_mode():
        logits = tnet(torch.from_numpy(x))
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, rtol=1e-4,
                               atol=1e-4)
    loss = _CE(logits, torch.from_numpy(y)).mean()
    np.testing.assert_allclose(float(loss.detach()), jl, rtol=1e-5)
    # the parameter gradients, in collect_params() order
    tparams = [(n, p._tensor()) for n, p in tnet.collect_params().items()
               if p.grad_req != "null"]
    grads = torch.autograd.grad(loss, [p for _, p in tparams])
    assert len(grads) == len(jgrads)
    floor = 1e-6 * max(float(np.sqrt(np.mean(np.square(g, dtype=np.float64))))
                       for g in jgrads.values())
    for (tn, _), g, (jn, jg) in zip(tparams, grads, jgrads.items()):
        assert tuple(g.shape) == jg.shape, (tn, jn)
        assert _grad_close(g.numpy(), jg, floor), (tn, jn)


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_sgd_steps_match_mxtpu_per_parameter_step(monkeypatch, layout,
                                                   compute_dtype):
    monkeypatch.setenv("MXTPU_BATCHED_OPT", "0")
    jnet = _jax_net(layout)
    tnet = _torch_net(layout, _jax_params(jnet))
    x, y = _data(layout, seed=1)
    jstep = jpar.build_train_step(jnet, jloss.SoftmaxCrossEntropyLoss(),
                                  "sgd", SGD, compute_dtype=compute_dtype,
                                  cache=None)
    tstep = build_train_step(tnet, SoftmaxCrossEntropyLoss(), "sgd", SGD,
                             compute_dtype=compute_dtype, device="cpu")
    want = [float(jstep(nd.array(x), nd.array(y)).asnumpy())
            for _ in range(3)]
    got = [float(tstep(x, y)) for _ in range(3)]
    if compute_dtype is None:
        # the third loss is near 0 after two steps on two images: an
        # absolute 1e-5 beside the relative 1e-4
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        jp = _jax_params(jnet)
        tp = params_to_mxtpu(tnet, list(jp))
        for n in jp:
            # parameters and the running statistics alike
            np.testing.assert_allclose(tp[n], jp[n], rtol=1e-4, atol=1e-4,
                                       err_msg=n)
        assert any(n.endswith("running_mean") and np.abs(jp[n]).max() > 0
                   for n in jp)
    else:
        # the first step starts from the same weights: its loss differs
        # by bf16 rounding only.  Later steps are not compared: on two
        # images at lr 0.1 the stem's gradient is large, so a rounding
        # difference (or a max-pool tie routed elsewhere) moves the
        # weights apart and the two trajectories part (0.77 against
        # 0.55 at step 2 in NCHW); both must still fit the batch.
        np.testing.assert_allclose(got[0], want[0], rtol=2e-2)
        assert np.isfinite(got).all() and np.isfinite(want).all()
        assert got[-1] < got[0] and want[-1] < want[0]
        # masters and running statistics stay f32 under bf16 compute
        assert all(t.dtype == torch.float32 for _, t in named_tensors(tnet))


def test_params_to_mxtpu_round_trip_carries_buffers():
    jnet = _jax_net("NCHW")
    params = _jax_params(jnet)
    params = {n: (a + 0.25 if n.endswith(("running_mean", "running_var"))
                  else a) for n, a in params.items()}
    tnet = _torch_net("NCHW", params)
    back = params_to_mxtpu(tnet, list(params))
    assert list(back) == list(params)
    for n in params:
        np.testing.assert_array_equal(back[n], params[n])
    names = [n for n, _ in named_tensors(tnet)]
    assert names[:6] == ["conv2d0_weight", "batchnorm0_gamma",
                         "batchnorm0_beta", "batchnorm0_running_mean",
                         "batchnorm0_running_var", "conv2d1_weight"]
    with pytest.raises(MXNetError, match="shape"):
        params_from_mxtpu(params, _torch_net("NHWC"))


# -------------------------------------------------------------- the layers

@pytest.mark.parametrize("axis,act", [(1, None), (1, "relu"), (3, "relu")])
def test_batchnorm_running_stats_and_eval_match_mxtpu(axis, act):
    rng = np.random.RandomState(2)
    shape = (4, 6, 5, 5) if axis == 1 else (4, 5, 5, 6)
    xs = [(0.5 + 2.0 * rng.randn(*shape)).astype(np.float32)
          for _ in range(3)]
    res = rng.randn(*shape).astype(np.float32) if act else None
    jbn = jnn.BatchNorm(axis=axis, momentum=0.8, act_type=act,
                        in_channels=6)
    jbn.initialize()
    tbn = tnn.BatchNorm(axis=axis, momentum=0.8, act_type=act,
                        in_channels=6)
    tbn.initialize(ctx=cpu())
    g = (1.0 + 0.1 * rng.randn(6)).astype(np.float32)
    jbn.gamma.set_data(nd.array(g))
    tbn.gamma.set_data(g)
    for x in xs:
        args = (nd.array(x),) + ((nd.array(res),) if act else ())
        with autograd.record(train_mode=True):
            jy = jbn(*args)
        with tautograd.train_mode():
            ty = tbn(torch.from_numpy(x),
                     *((torch.from_numpy(res),) if act else ()))
        np.testing.assert_allclose(ty.detach().numpy(), jy.asnumpy(),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tbn.running_mean.data().asnumpy(),
                               jbn.running_mean.data().asnumpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tbn.running_var.data().asnumpy(),
                               jbn.running_var.data().asnumpy(),
                               rtol=1e-5, atol=1e-6)
    # predict mode: the running statistics (mxtpu's use_global_stats
    # path)
    want = jbn(*((nd.array(xs[0]),) + ((nd.array(res),) if act else ())))
    got = tbn(torch.from_numpy(xs[0]),
              *((torch.from_numpy(res),) if act else ()))
    np.testing.assert_allclose(got.detach().numpy(), want.asnumpy(),
                               rtol=1e-5, atol=1e-5)


def test_batchnorm_options():
    with pytest.raises(MXNetError, match="act_type"):
        tnn.BatchNorm(in_channels=4, act_type="gelu")
    # in_channels left 0 is inferred at the first forward, as in mxtpu
    bn = tnn.BatchNorm()
    bn.initialize(ctx=cpu())
    bn(torch.randn(2, 4, 3, 3))
    assert bn.gamma.shape == (4,) and bn.running_var.shape == (4,)
    with pytest.raises(MXNetError, match="residual"):
        bn(torch.randn(2, 4, 3, 3), torch.randn(2, 4, 3, 3))
    # scale=False fixes gamma at 1 and leaves it out of training;
    # use_global_stats normalizes with the running statistics in
    # training mode and leaves them alone
    bn = tnn.BatchNorm(in_channels=4, scale=False, center=False,
                       use_global_stats=True)
    bn.initialize(ctx=cpu())
    assert bn.gamma.grad_req == "null" and bn.beta.grad_req == "null"
    assert not any(t.requires_grad for t in bn.parameters())
    bn.gamma.set_data(np.full(4, 5.0, np.float32))
    x = torch.randn(2, 4, 3, 3)
    with tautograd.train_mode():
        assert torch.allclose(bn(x), x / np.sqrt(1 + 1e-5), atol=1e-6)
    assert torch.equal(bn.running_mean.data()._data, torch.zeros(4))
    assert [n.split("_", 1)[1] for n in bn.collect_params()] == \
        ["gamma", "beta", "running_mean", "running_var"]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kw", [
    dict(channels=5, kernel_size=3, strides=1, padding=1, use_bias=False),
    dict(channels=4, kernel_size=1, strides=2, padding=0, use_bias=True),
    dict(channels=6, kernel_size=7, strides=2, padding=3, use_bias=False)])
def test_conv2d_matches_mxtpu(layout, kw):
    rng = np.random.RandomState(3)
    shape = (2, 3, 9, 9) if layout == "NCHW" else (2, 9, 9, 3)
    x = rng.randn(*shape).astype(np.float32)
    with fresh_names():
        jc = jnn.Conv2D(layout=layout, in_channels=3, **kw)
    jc.initialize(init="xavier")
    with fresh_names():
        tc = tnn.Conv2D(layout=layout, in_channels=3, **kw)
    want = jc(nd.array(x)).asnumpy()
    params_from_mxtpu(_jax_params(jc), tc)
    got = tc(torch.from_numpy(x))
    assert got.is_contiguous()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_pooling_matches_mxtpu(layout):
    rng = np.random.RandomState(4)
    shape = (2, 3, 8, 8) if layout == "NCHW" else (2, 8, 8, 3)
    # all negative: the padded border must count as -inf, not 0
    x = (-1.0 - np.abs(rng.randn(*shape))).astype(np.float32)
    for jl, tl in ((jnn.MaxPool2D(3, 2, 1, layout=layout),
                    tnn.MaxPool2D(3, 2, 1, layout=layout)),
                   (jnn.GlobalAvgPool2D(layout=layout),
                    tnn.GlobalAvgPool2D(layout=layout))):
        want = jl(nd.array(x)).asnumpy()
        got = tl(torch.from_numpy(x))
        assert got.is_contiguous()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6)
    with pytest.raises(MXNetError, match="layout"):
        tnn.MaxPool2D(layout="NCW")


def test_dense_flattens_like_gluon():
    rng = np.random.RandomState(5)
    x = rng.randn(3, 4, 1, 2).astype(np.float32)
    with fresh_names():
        jd = jnn.Dense(5, in_units=8)
    jd.initialize(init="xavier")
    with fresh_names():
        td = tnn.Dense(5, in_units=8)
    params_from_mxtpu(_jax_params(jd), td)
    np.testing.assert_allclose(td(torch.from_numpy(x)).detach().numpy(),
                               jd(nd.array(x)).asnumpy(), rtol=1e-5,
                               atol=1e-6)
    flat = tnn.Dense(5, flatten=False)       # in_units from the input
    flat.initialize(ctx=cpu())
    assert flat(torch.from_numpy(x)).shape == (3, 4, 1, 5)
    assert flat.weight.shape == (5, 2)


# -------------------------------------------------------------- the rest

def test_xavier_bounds_and_spread():
    def xavier_net():
        trandom.seed(0)
        with fresh_names():
            net = ResNetV1(BottleneckV1, LAYERS, CHANNELS, classes=CLASSES)
        net.initialize(initializer.Xavier(), ctx=cpu())
        return _shaped(net, "NCHW")
    net = xavier_net()
    jnet = _jax_net("NCHW")
    jp = _jax_params(jnet)
    for (n, t), (jn, ja) in zip(named_tensors(net), jp.items()):
        a = t.detach().numpy()
        if jn.endswith(("gamma", "running_var")):
            assert np.all(a == 1) and np.all(ja == 1), n
        elif jn.endswith(("beta", "bias", "running_mean")):
            assert np.all(a == 0) and np.all(ja == 0), n
        else:
            s = initializer.Xavier().scale(a.shape)
            # uniform in +-s: std s/sqrt(3), both sides within the bound
            assert np.abs(a).max() <= s and np.abs(ja).max() <= s, n
            if a.size >= 1000:
                np.testing.assert_allclose(a.std(), s / np.sqrt(3),
                                           rtol=0.1, err_msg=n)
                np.testing.assert_allclose(ja.std(), s / np.sqrt(3),
                                           rtol=0.1, err_msg=n)
    # the same seed draws the same weights again
    again = xavier_net()
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(named_tensors(net), named_tensors(again)))
    g = initializer.Xavier(rnd_type="gaussian", factor_type="in",
                           magnitude=2)
    assert g.scale((8, 4, 3, 3)) == pytest.approx(np.sqrt(2 / 36))
    with pytest.raises(MXNetError, match="ndim"):
        g.scale((5,))


def test_resnet50_shapes_and_the_default_device():
    net = resnet50()
    n_bn = sum(isinstance(m, tnn.BatchNorm) for m in net.modules())
    assert n_bn == 53
    net.initialize(ctx=cpu())
    _shaped(net, "NCHW")
    # torchvision's 25,557,032 and the 18,880 biases the reference keeps
    # on the bottlenecks' 1x1 convolutions (the running statistics are
    # parameters that are not trained)
    assert sum(p.numel() for p in net.parameters() if p.requires_grad) \
        == 25557032 + 18880
    nhwc = resnet50_v1(layout="NHWC")
    assert nhwc.features[0].weight.shape == (64, 7, 7, 0)   # deferred
    nhwc.initialize(ctx=cpu())
    _shaped(nhwc, "NHWC")
    assert nhwc.features[0].weight.shape == (64, 7, 7, 3)
    # mxtpu's refusals: a depth outside 18/34/50/101/152, a version
    # other than 1 or 2, pretrained weights
    with pytest.raises(MXNetError, match="invalid depth"):
        get_resnet(1, 26)
    with pytest.raises(MXNetError, match="version must be 1 or 2"):
        get_resnet(3, 50)
    with pytest.raises(MXNetError, match="pretrained"):
        get_resnet(2, 50, pretrained=True)
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default would be cuda:0")
    with pytest.raises(MXNetError, match="CUDA is not available"):
        build_train_step(net, SoftmaxCrossEntropyLoss(), "sgd", SGD)


def test_bf16_step_keeps_stats_f32_and_labels_uncast():
    trandom.seed(1)
    net = _torch_net("NHWC")
    seen = {}

    def loss(pred, y):
        seen["pred"], seen["y"] = pred.dtype, y.dtype
        return _CE(pred, y)
    step = build_train_step(net, loss, "sgd", SGD,
                            compute_dtype="bfloat16", device="cpu")
    x, y = _data("NHWC", seed=2)
    before = net.features[1].running_mean.data().asnumpy()
    losses = [float(step(x, y)) for _ in range(3)]
    assert np.isfinite(losses).all()
    assert seen == {"pred": torch.bfloat16, "y": torch.float32}
    rm = net.features[1].running_mean.data()
    assert rm.dtype == np.float32 and \
        not np.array_equal(rm.asnumpy(), before)
