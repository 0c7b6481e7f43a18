"""Faster R-CNN of the port (``mxtpu_torch/models/rcnn.py``) against
mxtpu's on the CPU: ``faster_rcnn_small``'s names and shapes, its
forward (rois, class scores, box deltas, the RPN's two maps), the RPN
training step of ``tests/test_rcnn.py`` (objectness CE against
``MultiBoxTarget`` on ``rpn_anchors``), and ``detect``'s rows.

mxtpu's forward runs once, through one jit of its traced forward,
shared by a module fixture; the 12-step RPN training runs the port
alone.  Weights start in mxtpu (Xavier from seed 0, set in the
fixture: a module fixture is built before the per-test seeding, so
unseeded its weights would follow whatever ran before in the process)
and cross by name (``convert.params_from_mxtpu``).

Tolerances, f32, at 2 x 3 x 64²: rois equal in their batch column and
their corners within 1e-5 of the image side (a corner is a difference
of numbers up to 64, through exp, from deltas that training-mode
BatchNorm's statistics part by ~1e-6); the RPN maps 1e-5 of max(1,
|ref|);
ROIPooling over mxtpu's rois equal to mxtpu's eager op (mxtpu's traced
graph is not the reference there: XLA multiplies by the f32 reciprocal
of the bin count where the op divides, moving some bin edges a pixel)
and the head's scores and deltas 1e-5 of max(1, |ref|) against numpy
in f64 on those features; the RPN loss 1e-5 relative and each
gradient's rms error 1e-4 of its rms, where no ReLU or max-pool
choice of the port's forward is within 1e-6 of flipping (asserted; a
flipped choice routes a gradient elsewhere); ``detect``'s body on mxtpu's
forward outputs: classes and the kept set equal, scores and corners
1e-4 (pixels; no IoU of its sweep within 1e-6 of the threshold,
asserted), and the port's own end-to-end ``detect`` finite and in the
image.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxtpu as jmx
from mxtpu import nd as jnd
from mxtpu.gluon.block import _traced_forward
from mxtpu.models import rcnn as jrcnn
from mxtpu.ndarray.ndarray import NDArray

import mxtpu_torch as tmx
from mxtpu_torch import autograd as tautograd, nd as tnd
from mxtpu_torch.convert import named_tensors, params_from_mxtpu
from mxtpu_torch.gluon import Trainer
from mxtpu_torch.kernels import nms as tnms
from mxtpu_torch.models import (RPN, FasterRCNN, faster_rcnn_small,
                                rpn_anchors)
from mxtpu_torch.ndarray import detection_impl as tdi

from tests.torch_gluon_names import fresh_names

torch.set_num_threads(2)

CLASSES, B, HW = 2, 2, 64
NEAR_TIE = 1e-6
CPU = tmx.cpu()


def _x(seed=0):
    return np.random.RandomState(seed).randn(B, 3, HW, HW) \
        .astype(np.float32)


def _info():
    return np.array([[HW, HW, 1.0]] * B, np.float32)


def _torch_net(params=None):
    with fresh_names():
        net = faster_rcnn_small(num_classes=CLASSES)
    if params is not None:
        return params_from_mxtpu(params, net)
    net.initialize(init="xavier", ctx=CPU)
    net(torch.zeros(B, 3, HW, HW), torch.from_numpy(_info()))
    return net


@pytest.fixture(scope="module")
def pair():
    shapes = {n: tuple(t.shape) for n, t in named_tensors(_torch_net())}
    with fresh_names():
        jnet = jrcnn.faster_rcnn_small(num_classes=CLASSES)
    for n, p in jnet.collect_params().items():
        p.shape = shapes[n]
    # a module fixture is set up before the per-test seeding: seed its
    # weights here, or they follow whatever ran before in the process
    jmx.random.seed(0)
    jnet.initialize(init="xavier")
    params = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    return jnet, params


def _jax_forward(jnet, params, x, training):
    plist = list(jnet.collect_params().values())
    vals = [jnp.asarray(params[n]) for n in jnet.collect_params()]
    outs = jax.jit(lambda v, xx, ii: _traced_forward(
        jnet, plist, v, [NDArray(xx, None, _placed=True),
                         NDArray(ii, None, _placed=True)], training,
        jax.random.key_data(jax.random.PRNGKey(0)))[0])(
        vals, jnp.asarray(x), jnp.asarray(_info()))
    return [np.asarray(o) for o in outs]


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_array_less(np.abs(got - want),
                                 tol * np.maximum(1, np.abs(want)) + 1e-30)


def test_names_and_shapes(pair):
    jnet, params = pair
    net = _torch_net(params)
    assert list(net.collect_params()) == list(jnet.collect_params())
    assert isinstance(net.rpn, RPN) and isinstance(net, FasterRCNN)
    assert net._stride == 8 and net._A == 6 and net._post_nms == 64
    assert sum(type(m).__name__ == "BatchNorm" for m in net.modules()) == 3


@pytest.mark.parametrize("training", [False, True])
def test_forward_matches_mxtpu(pair, training):
    """Predict mode (running statistics) and training mode (batch
    statistics): the rois from Proposal (pre_n 256, post_n 64), the
    head over ROIPooling, the RPN's maps."""
    jnet, params = pair
    x = _x()
    want = _jax_forward(jnet, params, x, training)
    net = _torch_net(params)
    with torch.no_grad(), (tautograd.train_mode() if training
                           else tautograd.predict_mode()):
        got = net(torch.from_numpy(x), torch.from_numpy(_info()))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    np.testing.assert_array_equal(got[0][:, 0].numpy(), want[0][:, 0])
    assert float(np.abs(got[0][:, 1:].numpy() - want[0][:, 1:]).max()) <= \
        1e-5 * HW
    for g, w in zip(got[3:], want[3:]):
        _close(g, w, 1e-5)
    assert (want[0][:, 1:] != 0).any(1).sum() > B * 8
    # the head: mxtpu's traced graph places some ROIPooling bin edges a
    # pixel from its eager op (XLA multiplies by 1/7 in f32 where the op
    # divides by 7), so the pooled features are held against mxtpu's
    # eager ROIPooling on the same map and rois, and the head's dense
    # layers against numpy on them
    with torch.no_grad(), (tautograd.train_mode() if training
                           else tautograd.predict_mode()):
        feat = net.body(torch.from_numpy(x))
        rois = torch.from_numpy(want[0].copy())
        pooled = tdi._roi_pooling(feat, rois, pooled_size=(7, 7),
                                  spatial_scale=1 / 8)
        h = net.head(pooled.reshape(pooled.shape[0], -1))
        heads = (net.cls_head(h), net.reg_head(h))
    np.testing.assert_array_equal(pooled.numpy(), jnd.ROIPooling(
        jnd.array(feat.numpy()), jnd.array(want[0]), pooled_size=(7, 7),
        spatial_scale=1 / 8).asnumpy())
    hn = pooled.reshape(pooled.shape[0], -1).double().numpy()
    for k in range(2):
        dense = f"dense{k}_"
        hn = np.maximum(hn @ params[dense + "weight"].T.astype(np.float64) +
                        params[dense + "bias"], 0)
    for g, k in zip(heads, (2, 3)):
        want_k = hn @ params[f"dense{k}_weight"].T.astype(np.float64) + \
            params[f"dense{k}_bias"]
        _close(g.double(), want_k, 1e-5)


def test_rpn_step_matches_mxtpu(pair):
    """test_rcnn's RPN loss (objectness CE against MultiBoxTarget at
    overlap 0.3, mining 3.0 on the rpn_anchors) and its gradients."""
    jnet, params = pair
    x, labels = _scene()
    fh = HW // 8
    A = 6
    janchors = jrcnn.rpn_anchors(fh, fh, 8, (2.0, 4.0), (0.5, 1.0, 2.0), HW)
    tanchors = rpn_anchors(fh, fh, 8, (2.0, 4.0), (0.5, 1.0, 2.0), HW,
                           ctx=CPU)
    np.testing.assert_array_equal(tanchors.asnumpy(), janchors.asnumpy())
    plist = list(jnet.collect_params().values())
    names = list(jnet.collect_params())

    def jloss(vals):
        raw = _traced_forward(
            jnet, plist, vals, [NDArray(jnp.asarray(x), None, _placed=True),
                                NDArray(jnp.asarray(_info()), None,
                                        _placed=True)], True,
            jax.random.key_data(jax.random.PRNGKey(0)))[0][3]
        logits = _j_logits(NDArray(raw, None, _placed=True), A)
        bt, bm, ct = jnd.MultiBoxTarget(janchors, jnd.array(labels), logits,
                                        overlap_threshold=0.3,
                                        negative_mining_ratio=3.0)
        ce = -jnd.pick(jnd.log_softmax(logits, axis=1), ct, axis=1)
        return jnd.mean(ce).data
    jl, jg = jax.jit(jax.value_and_grad(jloss))(
        [jnp.asarray(params[n]) for n in names])
    net = _torch_net(params)
    xs = tnd.array(x, ctx=CPU)
    with tautograd.record(), _decision_inputs(net) as seen:
        raw = net(xs, tnd.array(_info(), ctx=CPU))[3]
        loss = _t_rpn_loss(raw, tanchors, tnd.array(labels, ctx=CPU), A)
    loss.backward()
    _assert_no_near_tie(seen)
    np.testing.assert_allclose(float(loss.asscalar()), float(jl), rtol=1e-5)
    for n, p, g in zip(names, plist, jg):
        if p.grad_req == "null":
            continue
        got = net.collect_params()[n].grad().asnumpy()
        g = np.asarray(g)
        rms = float(np.sqrt(np.mean(np.square(g, dtype=np.float64))))
        assert float(np.sqrt(np.mean((got - g) ** 2.0))) <= \
            1e-4 * max(rms, 1e-12), n


@contextlib.contextmanager
def _decision_inputs(net):
    """The inputs of the body's ReLUs and 2 x 2 max pools while inside:
    the choices that route the gradient."""
    seen = {"relu": [], "pool": []}
    hooks = [m.register_forward_hook(
        lambda mod, i, o, k=k: seen[k].append(i[0].detach().clone()))
        for m in net.body.modules()
        for k in [{"Activation": "relu", "MaxPool2D": "pool"}.get(
            type(m).__name__)] if k]
    try:
        yield seen
    finally:
        for h in hooks:
            h.remove()


def _assert_no_near_tie(seen):
    """The near-tie rule of the gradient gate: the port and mxtpu agree
    on every ReLU and max-pool choice only where no choice is within
    NEAR_TIE of flipping (the two forwards part by ~1e-6 of max(1,
    |v|) at the last pool).  Asserted on the port's inputs: no nonzero
    ReLU input within NEAR_TIE of 0, no pool window whose two largest
    differ (and are not equal) by NEAR_TIE or less, relative to
    max(1, |v|).  Other weight draws do flip a choice: one at a window
    8.9e-8 apart parts conv2d0_weight's gradient by 2e-3 of its rms."""
    assert len(seen["relu"]) == len(seen["pool"]) == 3
    for v in seen["relu"]:
        assert float(v.abs()[v != 0].min()) > NEAR_TIE
    for v in seen["pool"]:
        n, c, h, w = v.shape
        top = v.reshape(n, c, h // 2, 2, w // 2, 2).permute(
            0, 1, 2, 4, 3, 5).reshape(-1, 4).topk(2, dim=1).values
        gap = (top[:, 0] - top[:, 1]) / top[:, 0].abs().clamp_min(1.0)
        assert float(gap[gap > 0].min()) > NEAR_TIE


def _scene():
    """test_rcnn's RPN scene: dim noise, one bright 24-pixel square an
    image, its box the label."""
    rng = np.random.RandomState(0)
    x = rng.rand(B, 3, HW, HW).astype(np.float32) * 0.1
    labels = np.zeros((B, 1, 5), np.float32)
    for i in range(B):
        x0 = 8 + 16 * i
        x[i, :, x0:x0 + 24, x0:x0 + 24] = 1.0
        labels[i, 0] = [0, x0 / HW, x0 / HW, (x0 + 24) / HW,
                        (x0 + 24) / HW]
    return x, labels


def _j_logits(raw, A):
    bg = jnd.transpose(jnd.slice_axis(raw, axis=1, begin=0, end=A),
                       axes=(0, 2, 3, 1)).reshape((B, -1))
    fg = jnd.transpose(jnd.slice_axis(raw, axis=1, begin=A, end=2 * A),
                       axes=(0, 2, 3, 1)).reshape((B, -1))
    return jnd.stack(bg, fg, axis=1)


def _t_rpn_loss(raw, anchors, labels, A):
    bg = tnd.transpose(tnd.slice_axis(raw, axis=1, begin=0, end=A),
                       axes=(0, 2, 3, 1)).reshape((B, -1))
    fg = tnd.transpose(tnd.slice_axis(raw, axis=1, begin=A, end=2 * A),
                       axes=(0, 2, 3, 1)).reshape((B, -1))
    logits = tnd.stack(bg, fg, axis=1)
    bt, bm, ct = tnd.MultiBoxTarget(anchors, labels, logits,
                                    overlap_threshold=0.3,
                                    negative_mining_ratio=3.0)
    return tnd.mean(-tnd.pick(tnd.log_softmax(logits, axis=1), ct, axis=1))


def test_rpn_training_improves_objectness():
    """tests/test_rcnn.py's 12 adam steps through gluon.Trainer, on the
    port alone: the loss ends under 0.7 of its start."""
    tmx.random.seed(0)
    with fresh_names():
        net = faster_rcnn_small(num_classes=1)
    net.initialize(init="xavier", ctx=CPU)
    x, labels = _scene()
    xs, info = tnd.array(x, ctx=CPU), tnd.array(_info(), ctx=CPU)
    labels = tnd.array(labels, ctx=CPU)
    net(xs, info)
    trainer = Trainer(net.collect_params(), "adam", {"learning_rate": 3e-3})
    anchors = rpn_anchors(HW // 8, HW // 8, 8, net._scales, net._ratios, HW,
                          ctx=CPU)
    losses = []
    for _ in range(12):
        with tautograd.record():
            raw = net(xs, info)[3]
            loss = _t_rpn_loss(raw, anchors, labels, net._A)
        loss.backward()
        trainer.step(batch_size=B)
        losses.append(float(loss.asscalar()))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.7, losses


def test_detect_matches_mxtpu(pair):
    """``detect``: the forward, then a per-class decode and one box_nms
    an image (id_index 0) on the host's copies, as mxtpu's."""
    jnet, params = pair
    x = _x(seed=2)
    jout = _jax_forward(jnet, params, x, False)
    rois, scores, deltas = (jnd.array(o) for o in jout[:3])

    # mxtpu's detect body on its own forward's outputs
    class Fwd:
        _post_nms, _classes = jnet._post_nms, jnet._classes

        def __call__(self, *a):
            return rois, scores, deltas, None, None
    want = jrcnn.FasterRCNN.detect(Fwd(), jnd.array(x), jnd.array(_info()),
                                   score_threshold=0.01)
    # the port's detect body on the same outputs (a roi an ulp apart
    # can move a ROIPooling bin, so the forwards are held above)
    trois, tscores, tdeltas = (tnd.array(o, ctx=CPU) for o in jout[:3])

    class TFwd:
        _post_nms, _classes = 64, CLASSES

        def __call__(self, *a):
            return trois, tscores, tdeltas, None, None
    got = FasterRCNN.detect(TFwd(), tnd.array(x, ctx=CPU),
                            tnd.array(_info(), ctx=CPU), score_threshold=0.01)
    assert got.shape == want.shape == (B, 64 * CLASSES, 6)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], rtol=0,
                               atol=1e-4)
    end = _torch_net(params).detect(tnd.array(x, ctx=CPU),
                                    tnd.array(_info(), ctx=CPU),
                                    score_threshold=0.01)
    assert end.shape == got.shape and np.isfinite(end).all()
    kept = end[0][end[0, :, 0] >= 0]
    assert len(kept) and (kept[:, 2:] >= 0).all() and \
        (kept[:, 2:] <= HW - 1).all()
    # the suppression's IoUs leave every pair clear of the threshold
    rows = want[0]
    same = rows[:, 0][:, None] == rows[:, 0][None, :]
    iou = tnms.pair_iou(torch.from_numpy(rows[:, 2:].copy())).numpy()
    assert np.abs(iou[same] - np.float32(0.3)).min() > 1e-6


def test_rpn_anchors_and_proposal_share_the_grid():
    """rpn_anchors is Proposal's anchor grid normalized by the image
    size (position-major, anchor-minor)."""
    a = rpn_anchors(3, 4, 8, (2.0, 4.0), (0.5, 1.0, 2.0), 64, ctx=CPU)
    np.testing.assert_array_equal(
        a.asnumpy()[0] * 64.0,
        tdi._anchor_grid(3, 4, 8, (2.0, 4.0), (0.5, 1.0, 2.0)))
