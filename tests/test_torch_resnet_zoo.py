"""The ResNet model zoo of the port (``mxtpu_torch/gluon/model_zoo/
vision/resnet.py``) against mxtpu's on the CPU: the ten ``resnetNN_vK``
constructors' parameter names, order and shapes; narrow nets of the
three blocks the zoo added (``BasicBlockV1``, ``BasicBlockV2``,
``BottleneckV2``) held as ``tests/test_torch_resnet_train.py`` holds
``BottleneckV1``; and the weights crossing both ways.

The narrow nets: layers ``[1, 1, 1, 1]``, channels ``[8, 8, 16, 32,
64]`` (basic blocks) or ``[8, 16, 32, 64, 128]`` (bottleneck), 10
classes, on (2, 3, 64, 64) images, in NCHW and NHWC.  The weights
start in mxtpu (Xavier) and cross with ``params_from_mxtpu`` by name;
mxtpu's side runs its traced forward and its compiled train step (its
eager forward costs tens of seconds on the CPU).

Tolerances, f32: logits 1e-4, loss 1e-5 relative, gradients 1e-4
relative L2 per tensor plus 1e-6 of the largest gradient's rms, and
three SGD-momentum steps 1e-4 on the losses (1e-5 absolute beside
it), parameters and running statistics.  One gradient is zero in exact
arithmetic, so each side holds rounding noise there: the V2
bottleneck net's stem BatchNorm gamma (its beta starts at 0, so its
ReLU output scales with gamma, the max pool keeps the scale, and the
first block's BatchNorm removes it from both of the block's paths, the
block widening 8 to 16 channels through a downsample); each side
is held on its own to 1e-4 of the largest gradient's rms (measured up
to 1.3e-5 of it on either side), not against the other.  The
steps run at lr 0.01: at the recipe's 0.1 two images are memorized in
two steps, and the third loss amplifies the f32 rounding of the first
two (within 2e-6 of mxtpu's) to 1.5 % (measured), which tests the
amplification, not the arithmetic.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxtpu import nd
from mxtpu import parallel as jpar
from mxtpu.gluon import loss as jloss
from mxtpu.gluon.block import _traced_forward
from mxtpu.gluon.model_zoo import vision as jvision
from mxtpu.ndarray.ndarray import NDArray

from mxtpu_torch import autograd as tautograd, cpu
from mxtpu_torch.convert import (named_tensors, params_from_mxtpu,
                                 params_to_mxtpu)
from mxtpu_torch.gluon import nn as tnn
from mxtpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxtpu_torch.gluon.model_zoo import vision as tvision
from mxtpu_torch.parallel import build_train_step

from tests.torch_gluon_names import fresh_names

torch.set_num_threads(2)

CLASSES = 10
SGD = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
BASIC, BOTTLE = [8, 8, 16, 32, 64], [8, 16, 32, 64, 128]
# (net class, block) of the narrow nets, and their channels
NETS = {"v1_basic": ("ResNetV1", "BasicBlockV1", BASIC),
        "v2_basic": ("ResNetV2", "BasicBlockV2", BASIC),
        "v2_bottleneck": ("ResNetV2", "BottleneckV2", BOTTLE)}
CONSTRUCTORS = [f"resnet{d}_v{v}" for v in (1, 2)
                for d in (18, 34, 50, 101, 152)]
# BatchNorm layers a net holds: V1 one after each convolution of the
# body and of each downsample; V2 the input's, two (basic) or three
# (bottleneck) a block, the stem's and the closing one
N_BN = {"resnet18_v1": 20, "resnet34_v1": 36, "resnet50_v1": 53,
        "resnet101_v1": 104, "resnet152_v1": 155, "resnet18_v2": 19,
        "resnet34_v2": 35, "resnet50_v2": 51, "resnet101_v2": 102,
        "resnet152_v2": 153}


@pytest.mark.parametrize("name", CONSTRUCTORS)
def test_constructor_names_order_and_shapes_match_mxtpu(name):
    for layout in ("NCHW", "NHWC"):
        with fresh_names():
            jnet = getattr(jvision, name)(layout=layout)
            tnet = getattr(tvision, name)(layout=layout)
        jp, tp = jnet.collect_params(), tnet.collect_params()
        assert list(tp) == list(jp)
        assert [p.shape for p in tp.values()] == \
            [p.shape for p in jp.values()]
        assert [p.grad_req for p in tp.values()] == \
            [p.grad_req for p in jp.values()]
    assert sum(isinstance(m, tnn.BatchNorm) for m in tnet.modules()) == \
        N_BN[name]
    with fresh_names():
        assert list(tvision.get_model(name.upper(), classes=7)
                    .collect_params()) == \
            list(jvision.get_model(name, classes=7).collect_params())


def test_settled_shapes_and_parameter_count():
    """resnet18_v1 settled by one forward: torchvision's 11,689,512
    parameters (no convolution bias in a basic block); V2's input
    BatchNorm holds a fixed gamma and beta of 3."""
    net = tvision.resnet18_v1()
    net.initialize(ctx=cpu())
    net(torch.zeros(1, 3, 32, 32))
    assert sum(p.numel() for p in net.parameters() if p.requires_grad) \
        == 11689512
    v2 = tvision.resnet18_v2(layout="NHWC")
    v2.initialize(ctx=cpu())
    v2(torch.zeros(1, 32, 32, 3))
    bn0 = v2.features[0]
    assert bn0.gamma.shape == (3,) and bn0.gamma.grad_req == "null"
    assert bn0.beta.grad_req == "null"


def _data(layout, seed=0):
    rng = np.random.RandomState(seed)
    shape = (2, 3, 64, 64) if layout == "NCHW" else (2, 64, 64, 3)
    return rng.randn(*shape).astype(np.float32), \
        np.array([1.0, 7.0], np.float32)


def _build(vision, kind, layout):
    net_cls, block, channels = NETS[kind]
    with fresh_names():
        return getattr(vision, net_cls)(getattr(vision, block),
                                        [1, 1, 1, 1], channels,
                                        classes=CLASSES, layout=layout)


def _torch_net(kind, layout, params=None):
    net = _build(tvision, kind, layout)
    if params is not None:
        return params_from_mxtpu(params, net)
    net.initialize(init="xavier", ctx=cpu())
    shape = (1, 3, 32, 32) if layout == "NCHW" else (1, 32, 32, 3)
    net(torch.zeros(shape))
    return net


def _jax_net(kind, layout):
    """mxtpu's net, Xavier-initialized, its deferred shapes taken from
    the port's model by name."""
    net = _build(jvision, kind, layout)
    shapes = {n: tuple(t.shape) for n, t in
              named_tensors(_torch_net(kind, layout))}
    params = net.collect_params()
    assert list(params) == list(shapes)
    for n, p in params.items():
        p.shape = shapes[n]
    net.initialize(init="xavier")
    return net


def _jax_params(net):
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


def _jax_forward_grads(net, x, y):
    params = list(net.collect_params().values())
    vals = [p.data().data for p in params]
    loss_fn = jloss.SoftmaxCrossEntropyLoss()

    def f(vals, xx, yy):
        outs, _, _, aux = _traced_forward(
            net, params, vals, [NDArray(xx, None, _placed=True)], True,
            jax.random.key_data(jax.random.PRNGKey(0)))
        loss = loss_fn(NDArray(outs[0], None, _placed=True),
                       NDArray(yy, None, _placed=True))
        return jnp.mean(loss.data), outs[0]
    (loss, logits), grads = jax.jit(jax.value_and_grad(
        f, has_aux=True))(vals, jnp.asarray(x), jnp.asarray(y))
    names = list(net.collect_params())
    return (float(loss), np.asarray(logits),
            {names[i]: np.asarray(grads[i]) for i, p in enumerate(params)
             if p.grad_req != "null"})


def _rms(t):
    t = np.asarray(t, np.float64)
    return float(np.sqrt(np.mean(t * t)))


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("kind", list(NETS))
def test_logits_and_gradients_match_mxtpu(kind, layout):
    jnet = _jax_net(kind, layout)
    x, y = _data(layout)
    jl, jlogits, jgrads = _jax_forward_grads(jnet, x, y)
    tnet = _torch_net(kind, layout, _jax_params(jnet))
    with tautograd.train_mode():
        logits = tnet(torch.from_numpy(x))
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, rtol=1e-4,
                               atol=1e-4)
    loss = SoftmaxCrossEntropyLoss()(logits, torch.from_numpy(y)).mean()
    np.testing.assert_allclose(float(loss.detach()), jl, rtol=1e-5)
    tparams = [(n, p._tensor()) for n, p in tnet.collect_params().items()
               if p.grad_req != "null"]
    assert [n for n, _ in tparams] == list(jgrads)
    grads = torch.autograd.grad(loss, [p for _, p in tparams])
    top = max(_rms(g) for g in jgrads.values())
    # the V2 bottleneck net's stem BatchNorm (after the input's
    # BatchNorm and the 7x7 convolution): its gamma's gradient is zero
    # in exact arithmetic
    noise = {tnet.features[2].gamma.name} if kind == "v2_bottleneck" \
        else ()
    for (n, _), g in zip(tparams, grads):
        assert tuple(g.shape) == jgrads[n].shape, n
        if n in noise:
            assert _rms(g.numpy()) <= 1e-4 * top, n
            assert _rms(jgrads[n]) <= 1e-4 * top, n
            continue
        assert _rms(g.numpy() - jgrads[n]) <= \
            1e-4 * _rms(jgrads[n]) + 1e-6 * top, n


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("kind", list(NETS))
def test_sgd_steps_match_mxtpu(monkeypatch, kind, layout):
    monkeypatch.setenv("MXTPU_BATCHED_OPT", "0")
    jnet = _jax_net(kind, layout)
    tnet = _torch_net(kind, layout, _jax_params(jnet))
    x, y = _data(layout, seed=1)
    jstep = jpar.build_train_step(jnet, jloss.SoftmaxCrossEntropyLoss(),
                                  "sgd", SGD, cache=None)
    tstep = build_train_step(tnet, SoftmaxCrossEntropyLoss(), "sgd", SGD,
                             device="cpu")
    want = [float(jstep(nd.array(x), nd.array(y)).asnumpy())
            for _ in range(3)]
    got = [float(tstep(x, y)) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    jp = _jax_params(jnet)
    tp = params_to_mxtpu(tnet, list(jp))
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], rtol=1e-4, atol=1e-4,
                                   err_msg=n)
    assert any(n.endswith("running_var") and
               not np.allclose(jp[n], 1.0) for n in jp)


@pytest.mark.parametrize("kind", list(NETS))
def test_params_cross_both_ways(tmp_path, kind):
    """mxtpu's weights into the port and back bit for bit, and a
    ``.params`` file of either package loads in the other."""
    jnet = _jax_net(kind, "NCHW")
    params = _jax_params(jnet)
    params = {n: (a + 0.25 if n.endswith("running_mean") else a)
              for n, a in params.items()}
    tnet = _torch_net(kind, "NCHW", params)
    back = params_to_mxtpu(tnet, list(params))
    assert list(back) == list(params)
    for n in params:
        np.testing.assert_array_equal(back[n], params[n])
    tnet.save_parameters(str(tmp_path / "t.params"))
    jnet2 = _build(jvision, kind, "NCHW")
    jnet2.load_parameters(str(tmp_path / "t.params"))
    for n, p in jnet2.collect_params().items():
        np.testing.assert_array_equal(p.data().asnumpy(), params[n])
    jnet.save_parameters(str(tmp_path / "j.params"))
    tnet2 = _build(tvision, kind, "NCHW")
    tnet2.load_parameters(str(tmp_path / "j.params"), ctx=cpu())
    for (n, t), (_, u) in zip(named_tensors(tnet2), named_tensors(tnet)):
        want = _jax_params(jnet)[n]
        np.testing.assert_array_equal(t.detach().numpy(), want)
