"""SSD of the port (``mxtpu_torch/models/ssd.py``) against mxtpu's on the
CPU: ``toy_ssd``'s names and shapes, its forward, ``SSDLoss``, one f32
``build_train_step`` step with bench_ssd's ``det_loss``, the same loss
under ``compute_dtype=bfloat16`` (the types), and ``detect``'s rows.

mxtpu is called once a configuration: its forward and gradients through
one jit of its traced forward (its eager forward costs tens of seconds
here), shared by a module fixture; multi-step checks run the port
alone.  The weights start in mxtpu (Xavier) and cross in the
``.params`` format (``save_parameters`` / ``load_parameters``).

The fixture's nets are shared: a test that trains (mxtpu's compiled
step updates its net in place; a training-mode forward updates the
running statistics) builds from the fixture's initial weights.

Tolerances, f32: the forward's outputs 1e-5 of max(1, |ref|) in
predict mode and 1e-4 in training mode (batch statistics; see the
test); the loss
1e-5 relative; each gradient's largest error 1e-4 of its rms; the
second step's loss (after the SGD-momentum update) 1e-5 relative;
detection rows: classes and the kept set equal, scores and corners
1e-6 (the two forwards' f32 rounding; no IoU of the sweep within 1e-6
of the threshold, asserted).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxtpu as jmx
from mxtpu import nd as jnd
from mxtpu import parallel as jpar
from mxtpu.gluon.block import _traced_forward
from mxtpu.models import ssd as jssd
from mxtpu.ndarray.ndarray import NDArray

import mxtpu_torch as tmx
from mxtpu_torch import autograd as tautograd, nd as tnd
from mxtpu_torch.convert import named_tensors, params_from_mxtpu
from mxtpu_torch.gluon.block import F
from mxtpu_torch.kernels import nms as tnms
from mxtpu_torch.models import SSD, SSDLoss, ssd_300, toy_ssd
from mxtpu_torch.parallel import build_train_step

from tests.torch_gluon_names import fresh_names

torch.set_num_threads(2)

CLASSES = 3
SGD = {"learning_rate": 5e-3, "momentum": 0.9, "wd": 5e-4}
B, HW = 2, 64


def _batch(seed=0):
    """bench_ssd's batch at toy size: randn images, then VOC-shaped
    labels (1 + i % 3 objects, -1 padding) from one RandomState."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, 3, HW, HW).astype(np.float32)
    labels = np.full((B, 3, 5), -1.0, np.float32)
    for i in range(B):
        for o in range(1 + i % 3):
            x0, y0 = rng.uniform(0, 0.6, 2)
            labels[i, o] = [rng.randint(CLASSES), x0, y0,
                            x0 + rng.uniform(0.2, 0.4),
                            y0 + rng.uniform(0.2, 0.4)]
    return x, labels


def _torch_net():
    with fresh_names():
        net = toy_ssd(num_classes=CLASSES)
    net.initialize(init="xavier", ctx=tmx.cpu())
    net(torch.zeros(1, 3, HW, HW))
    return net


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """mxtpu's toy_ssd (Xavier, its deferred shapes from the port's
    settled net), its weights saved as .params and loaded by the port."""
    shapes = {n: tuple(t.shape) for n, t in named_tensors(_torch_net())}
    with fresh_names():
        jnet = jssd.toy_ssd(num_classes=CLASSES)
    for n, p in jnet.collect_params().items():
        p.shape = shapes[n]
    # a module fixture is set up before the per-test seeding: seed its
    # weights here, or they follow whatever ran before in the process
    jmx.random.seed(0)
    jnet.initialize(init="xavier")
    path = str(tmp_path_factory.mktemp("ssd") / "toy.params")
    jnet.save_parameters(path)
    with fresh_names():
        tnet = toy_ssd(num_classes=CLASSES)
    tnet.load_parameters(path, ctx=tmx.cpu())
    params = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    return jnet, tnet, params


def _j_det_loss(pred, labels):
    anchors, cls_preds, box_preds = pred
    bt, bm, ct = jnd.MultiBoxTarget(anchors, labels, cls_preds)
    return jnd.mean(jssd.SSDLoss()(cls_preds, box_preds, ct, bt, bm))


def _t_det_loss(pred, labels):
    anchors, cls_preds, box_preds = pred
    bt, bm, ct = F.MultiBoxTarget(anchors, labels, cls_preds)
    return SSDLoss()(cls_preds, box_preds, ct, bt, bm).mean()


@pytest.fixture(scope="module")
def jax_run(pair):
    """mxtpu's training-mode outputs, loss and gradients on ``_batch()``
    (one jit), and the losses of two of its train steps."""
    jnet, _, _ = pair
    x, labels = _batch()
    params = list(jnet.collect_params().values())
    vals = [p.data().data for p in params]

    def f(vals, xx, yy):
        outs, _, _, _ = _traced_forward(
            jnet, params, vals, [NDArray(xx, None, _placed=True)], True,
            jax.random.key_data(jax.random.PRNGKey(0)))
        pred = [NDArray(o, None, _placed=True) for o in outs]
        loss = _j_det_loss(pred, NDArray(yy, None, _placed=True))
        return jnp.mean(loss.data), outs
    (loss, outs), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        vals, jnp.asarray(x), jnp.asarray(labels))
    names = list(jnet.collect_params())
    return {"loss": float(loss), "outs": [np.asarray(o) for o in outs],
            "grads": {names[i]: np.asarray(g) for i, g in enumerate(grads)
                      if params[i].grad_req != "null"}}


def _rms(a):
    a = np.asarray(a, np.float64)
    return float(np.sqrt(np.mean(a * a)))


def test_names_shapes_and_anchor_count(pair):
    jnet, tnet, params = pair
    assert list(tnet.collect_params()) == list(jnet.collect_params())
    for n, t in named_tensors(tnet):
        np.testing.assert_array_equal(t.detach().numpy(), params[n])
    # ssd_300: 1704 anchors at 300², 14 BatchNorms (the 7 blocks' 2)
    with fresh_names():
        big = ssd_300()
    big.initialize(ctx=tmx.cpu())
    with torch.no_grad():
        a, c, b = big(torch.zeros(1, 3, 300, 300))
    assert a.shape == (1, 1704, 4) and c.shape == (1, 21, 1704)
    assert b.shape == (1, 1704 * 4)
    assert sum(type(m).__name__ == "BatchNorm" for m in big.modules()) == 14


def test_forward_matches_mxtpu(pair, jax_run):
    """Training mode (the predict-mode forward is held at 1e-5 in
    test_detect_rows_match_mxtpu): each training-mode BatchNorm divides
    by a batch deviation whose one-pass variance E[x^2] - E[x]^2 rounds
    apart with the summation order (the CPU's thread count among it),
    measured up to 1.5e-5 of max(1, |ref|) over the five blocks."""
    _, tnet, _ = pair
    x, _ = _batch()
    with torch.no_grad(), tautograd.train_mode():
        outs = tnet(torch.from_numpy(x))
    assert len(outs) == 3
    for got, want in zip(outs, jax_run["outs"]):
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_less(
            np.abs(got.numpy() - want), 1e-4 * np.maximum(1, np.abs(want)))


def test_train_step_loss_and_gradients_match_mxtpu(pair, jax_run):
    _, _, params = pair
    with fresh_names():
        tnet = toy_ssd(num_classes=CLASSES)
    params_from_mxtpu(params, tnet)
    step = build_train_step(tnet, _t_det_loss, "sgd", SGD, device="cpu")
    x, labels = _batch()
    loss, grads = step.forward_backward(x, labels)
    np.testing.assert_allclose(float(loss), jax_run["loss"], rtol=1e-5)
    assert step.param_names == list(jax_run["grads"])
    for n, g in zip(step.param_names, grads):
        want = jax_run["grads"][n]
        assert float(np.abs(g.numpy() - want).max()) <= 1e-4 * _rms(want), n


def test_two_sgd_steps_match_mxtpu(monkeypatch, pair):
    """The loss of mxtpu's compiled step and the port's, twice: the
    second after one SGD-momentum update of every weight."""
    monkeypatch.setenv("MXTPU_BATCHED_OPT", "0")
    jnet, _, params = pair
    with fresh_names():
        tnet = toy_ssd(num_classes=CLASSES)
    params_from_mxtpu(params, tnet)
    x, labels = _batch(seed=1)
    jstep = jpar.build_train_step(jnet, _j_det_loss, "sgd", SGD, cache=None)
    want = [float(jstep(jnd.array(x), jnd.array(labels)).asnumpy())
            for _ in range(2)]
    tstep = build_train_step(tnet, _t_det_loss, "sgd", SGD, device="cpu")
    got = [float(tstep(x, labels)) for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_det_loss_under_bf16_compute(pair):
    """bench_ssd's step with ``compute_dtype=bfloat16``: the loss gets all
    three outputs as one tuple, anchors f32 (MultiBoxPrior), the
    predictions bf16, the labels f32 (``cast_batch`` casts only x), the
    targets f32; the loss is an f32 scalar and falls."""
    _, _, params = pair
    with fresh_names():
        tnet = toy_ssd(num_classes=CLASSES)
    params_from_mxtpu(params, tnet)
    seen = []

    def det_loss(pred, labels):
        assert isinstance(pred, tuple) and len(pred) == 3
        anchors, cls_preds, box_preds = pred
        bt, bm, ct = F.MultiBoxTarget(anchors, labels, cls_preds)
        seen.append((anchors.dtype, cls_preds.dtype, box_preds.dtype,
                     labels.dtype, bt.dtype, bm.dtype, ct.dtype))
        return SSDLoss()(cls_preds, box_preds, ct, bt, bm).mean()
    step = build_train_step(tnet, det_loss, "sgd", SGD,
                            compute_dtype="bfloat16", device="cpu")
    x, labels = _batch()
    losses = [step(x, labels) for _ in range(4)]
    f32, bf = torch.float32, torch.bfloat16
    assert seen[0] == (f32, bf, bf, f32, f32, f32, f32)
    assert all(v.dtype == f32 and v.ndim == 0 for v in losses)
    assert all(p.dtype == f32 for p in tnet.parameters())
    vals = [float(v) for v in losses]
    assert np.isfinite(vals).all() and vals[-1] < vals[0]


@pytest.mark.parametrize("ignore", [False, True])
def test_ssd_loss_matches_mxtpu(ignore):
    rng = np.random.RandomState(2)
    N, C, A = 2, 4, 10
    cls_preds = rng.randn(N, C + 1, A).astype(np.float32)
    box_preds = rng.randn(N, A * 4).astype(np.float32)
    box_target = rng.randn(N, A * 4).astype(np.float32)
    mask = (rng.rand(N, A) > 0.6).repeat(4, 1).astype(np.float32)
    ct = rng.randint(0, C + 1, (N, A)).astype(np.float32)
    if ignore:
        ct[:, ::3] = -1.0
    args = (cls_preds, box_preds, ct, box_target, mask)
    got = SSDLoss(box_loss_weight=0.7)(*map(torch.from_numpy, args))
    want = jssd.SSDLoss(box_loss_weight=0.7)(*map(jnd.array, args))
    np.testing.assert_allclose(got.numpy(), want.asnumpy(), rtol=1e-6)


def test_detect_rows_match_mxtpu(pair):
    """``SSD.detect`` (predict mode) against mxtpu's forward (one jit)
    and its MultiBoxDetection at nms_topk 400."""
    jnet, _, init = pair
    with fresh_names():
        tnet = toy_ssd(num_classes=CLASSES)
    params_from_mxtpu(init, tnet)
    x, _ = _batch(seed=3)
    params = list(jnet.collect_params().values())
    outs = jax.jit(lambda v, xx: _traced_forward(
        jnet, params, v, [NDArray(xx, None, _placed=True)], False,
        jax.random.key_data(jax.random.PRNGKey(0)))[0])(
        [jnp.asarray(init[n]) for n in jnet.collect_params()],
        jnp.asarray(x))
    with torch.no_grad():
        mine = tnet(torch.from_numpy(x))
    for got, want in zip(mine, outs):
        want = np.asarray(want)
        np.testing.assert_array_less(
            np.abs(got.numpy() - want), 1e-5 * np.maximum(1, np.abs(want)))
    anchors, cls_preds, box_preds = (jnd.array(np.asarray(o)) for o in outs)
    want = jnd.MultiBoxDetection(jnd.softmax(cls_preds, axis=1), box_preds,
                                 anchors, nms_topk=400).asnumpy()
    got = tnet.detect(tnd.array(x, ctx=tmx.cpu())).asnumpy()
    assert got.shape == want.shape == (B, anchors.shape[1], 6)
    # the two forwards part by f32 rounding: classes (and so the kept
    # set, -1 rows included) equal, scores and corners within 1e-6
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], rtol=0,
                               atol=1e-6)
    kept = want[0][want[0, :, 0] >= 0]
    assert 0 < len(kept)
    iou = tnms.pair_iou(torch.from_numpy(want[0][:400, 2:])).numpy()
    same = want[0][:400, 0][:, None] == want[0][:400, 0][None, :]
    assert np.abs(iou[same] - 0.5).min() > 1e-6


def test_port_trains_toy_ssd_and_hybridize_agrees():
    """12 adam steps on a bright-square scene (the port alone): the loss
    falls below 0.8 of its start; hybridize() then gives the eager
    outputs."""
    rng = np.random.RandomState(0)
    x = rng.rand(4, 3, HW, HW).astype(np.float32) * 0.1
    labels = np.zeros((4, 1, 5), np.float32)
    for i in range(4):
        w = rng.randint(HW // 4, HW // 2)
        x0, y0 = rng.randint(0, HW - w, 2)
        x[i, :, y0:y0 + w, x0:x0 + w] = 1.0
        labels[i, 0] = [0, x0 / HW, y0 / HW, (x0 + w) / HW, (y0 + w) / HW]
    tmx.random.seed(0)
    with fresh_names():
        net = toy_ssd(num_classes=1)
    net.initialize(init="xavier", ctx=tmx.cpu())
    xs, ls = tnd.array(x, ctx=tmx.cpu()), tnd.array(labels, ctx=tmx.cpu())
    net(xs)
    trainer = tmx.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 5e-3})
    losses = []
    for _ in range(12):
        with tautograd.record():
            a, c, b = net(xs)
            bt, bm, ct = tnd.MultiBoxTarget(a, ls, c)
            loss = tnd.mean(SSDLoss()(c, b, ct, bt, bm))
        loss.backward()
        trainer.step(batch_size=4)
        losses.append(float(loss.asscalar()))
    assert np.isfinite(losses).all() and losses[-1] < 0.8 * losses[0]
    eager = [o.asnumpy() for o in net(xs)]
    net.hybridize()
    for e, h in zip(eager, net(xs)):
        np.testing.assert_allclose(h.asnumpy(), e, rtol=2e-5, atol=2e-5)


def test_ssd_sizes_validation():
    with pytest.raises(tmx.base.MXNetError, match="sizes/ratios"):
        SSD(2, body_channels=(8,), scale_channels=(8,), sizes=[(0.2,)])
