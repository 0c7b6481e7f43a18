"""The detection ops of the port (``mxtpu_torch/ndarray/
detection_impl.py``, ``contrib.py``, ``nn_extra.py``, ``smooth_l1``,
``kernels/nms.py``'s plain sweep) against mxtpu's on the CPU, from the
same seeded inputs.

Tolerances: the discrete outputs (MultiBoxTarget's cls_target and
box_mask, the keep masks and so the suppressed rows of
MultiBoxDetection, Proposal and box_nms, the bipartite matches, the
anchors) equal; computed coordinates within 1e-6 of max(1, |ref|)
(Proposal's pixel rois 1e-6 relative: a few float32 ulps of numbers up
to the image size, where exp and a product may round apart);
ROIPooling's values equal (a max) and its gradient within 1e-6; smooth
L1 and ROIAlign 1e-6 (forward) and 1e-5 (gradients).  The near-tie rule
(an IoU within 1e-6 of the threshold may flip a keep bit between two
implementations of the same f32 formula) is checked where it could
bite: every sweep here is first held on its IoU matrix, and the seeded
boxes leave no pair within 1e-6 of a threshold (asserted).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxtpu as jmx
from mxtpu import nd as jnd
from mxtpu.ndarray import detection_impl as jdi
from mxtpu.ops.registry import get_op as jget_op, list_ops as jlist_ops

import mxtpu_torch as tmx
from mxtpu_torch import autograd as tautograd, nd as tnd
from mxtpu_torch.kernels import nms as tnms
from mxtpu_torch.ndarray import detection_impl as tdi
from mxtpu_torch.ops.registry import get_op as tget_op, list_ops

torch.set_num_threads(2)

NAMES = ("MultiBoxPrior", "MultiBoxTarget", "MultiBoxDetection",
         "Proposal", "ROIPooling", "_contrib_box_iou", "_contrib_box_nms",
         "_contrib_bipartite_matching", "_contrib_ROIAlign", "smooth_l1")
ALIASES = ("_contrib_Proposal", "_contrib_MultiProposal", "box_nms",
           "ROIAlign")


def T(a):
    return tnd.array(np.asarray(a), ctx=tmx.cpu())


def J(a):
    return jnd.array(np.asarray(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.asnumpy() if hasattr(x, "asnumpy") else x,
                      np.float32)


def _close(got, want, tol=1e-6):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_array_less(np.abs(got - want),
                                 tol * np.maximum(1.0, np.abs(want)) + 1e-30)


def _boxes(rng, n, scale=1.0, size=0.3, batch=None):
    shape = (n, 2) if batch is None else (batch, n, 2)
    xy = rng.uniform(0, scale, shape).astype(np.float32)
    wh = rng.uniform(0.02 * scale, size * scale, shape).astype(np.float32)
    return np.concatenate([xy, xy + wh], -1)


def _labels(rng, b, o, classes=3):
    lab = np.full((b, o, 5), -1.0, np.float32)
    for i in range(b):
        for k in range(1 + i % o):
            x0, y0 = rng.uniform(0, 0.6, 2)
            lab[i, k] = [rng.randint(classes), x0, y0,
                         x0 + rng.uniform(0.2, 0.4),
                         y0 + rng.uniform(0.2, 0.4)]
    return lab


def _no_near_tie(iou, thr):
    assert float(np.abs(np.asarray(iou, np.float64) - np.float32(thr))
                 .min()) > 1e-6


# ---------------------------------------------------------------- registry

def test_registry_names_and_namespaces():
    ops = set(list_ops())
    assert set(NAMES + ALIASES) <= ops
    assert ops <= set(jlist_ops())
    for n in NAMES:
        assert tget_op(n).differentiable == jget_op(n).differentiable, n
        tp, jp = tget_op(n).params.params, jget_op(n).params.params
        assert list(tp) == list(jp), n
        assert [p.default for p in tp.values()] == \
            [p.default for p in jp.values()], n
        assert tget_op(n).aliases == jget_op(n).aliases, n
    assert tget_op("box_nms") is tget_op("_contrib_box_nms")
    for f in ("box_iou", "box_nms", "bipartite_matching"):
        assert callable(getattr(tnd.contrib, f))
    assert hasattr(tnd, "ROIAlign") and hasattr(tnd, "_contrib_Proposal")
    assert not hasattr(tnd, "_contrib_box_nms") and \
        not hasattr(jnd, "_contrib_box_nms")


# ---------------------------------------------------------------- smooth_l1

@pytest.mark.parametrize("scalar", [1.0, 2.0, 0.5])
def test_smooth_l1_forward_and_gradient(scalar):
    rng = np.random.RandomState(1)
    x = (rng.randn(6, 7) * 2).astype(np.float32)
    fn = jget_op("smooth_l1").fn
    want, vjp = jax.vjp(lambda a: fn(a, scalar=scalar), jnp.asarray(x))
    head = rng.randn(6, 7).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tget_op("smooth_l1")(xt, scalar=scalar)
    _close(got, want)
    (g,) = torch.autograd.grad(got, xt, torch.from_numpy(head))
    _close(g, vjp(jnp.asarray(head))[0], 1e-5)


# ---------------------------------------------------------------- MultiBox

@pytest.mark.parametrize("kw", [
    dict(sizes=(0.5, 0.25), ratios=(1, 2, 0.5)),
    dict(sizes=(0.5,), ratios=(2.0,)),
    dict(sizes=(0.3, 0.6), ratios=(1.0, 3.0), steps=(0.2, 0.1),
         offsets=(0.25, 0.75), clip=True)])
def test_multibox_prior_equals_mxtpu(kw):
    x = np.zeros((2, 3, 5, 7), np.float32)
    got = tnd.MultiBoxPrior(T(x), **kw).asnumpy()
    want = jnd.MultiBoxPrior(J(x), **kw).asnumpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # f32 whatever the data's type
    bf = torch.zeros(1, 3, 5, 7, dtype=torch.bfloat16)
    assert tget_op("MultiBoxPrior")(bf, **kw).dtype == torch.float32


def _target_inputs(seed, dtype):
    rng = np.random.RandomState(seed)
    anchors = jnd.MultiBoxPrior(J(np.zeros((1, 3, 6, 6), np.float32)),
                                sizes=(0.3, 0.5),
                                ratios=(1, 2, 0.5)).asnumpy()
    labels = _labels(rng, 3, 3)
    cls = rng.randn(3, 4, anchors.shape[1]).astype(np.float32)
    if dtype == "bfloat16":
        cls = np.asarray(jnp.asarray(cls, jnp.bfloat16))
    return anchors, labels, cls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ratio", [-1.0, 3.0])
def test_multibox_target_equals_mxtpu(ratio, dtype):
    """With padding rows; under bf16 cls_preds the mining scores tie
    often, and the stable sort breaks the ties by index as jnp's."""
    anchors, labels, cls = _target_inputs(3, dtype)
    tcls = torch.from_numpy(cls.astype(np.float32))
    if dtype == "bfloat16":
        tcls = tcls.to(torch.bfloat16)
    got = tget_op("MultiBoxTarget")(torch.from_numpy(anchors),
                                    torch.from_numpy(labels), tcls,
                                    negative_mining_ratio=ratio)
    want = jget_op("MultiBoxTarget").fn(
        jnp.asarray(anchors), jnp.asarray(labels), jnp.asarray(cls),
        negative_mining_ratio=ratio)
    bt, bm, ct = got
    _close(bt, want[0])
    np.testing.assert_array_equal(_np(bm), np.asarray(want[1]))
    np.testing.assert_array_equal(_np(ct), np.asarray(want[2]))
    assert bt.dtype == bm.dtype == ct.dtype == torch.float32
    if ratio > 0:
        assert (_np(ct) < 0).any() and (_np(ct) == 0).any()
        if dtype == "bfloat16":
            fg = np.asarray(cls, np.float32)[:, 1:].max(1)
            assert len(np.unique(fg)) < fg.size  # ties do occur


def test_multibox_target_two_boxes_share_an_anchor():
    """Two valid gts whose best anchor is the same: the higher gt index
    wins the force-match, as XLA's scatter keeps the last write."""
    anchors = np.array([[[0.0, 0.0, 0.5, 0.5], [0.5, 0.5, 1.0, 1.0],
                         [0.0, 0.5, 0.5, 1.0]]], np.float32)
    labels = np.array([[[0, 0.05, 0.05, 0.3, 0.3],
                        [2, 0.1, 0.1, 0.35, 0.4],
                        [-1, 0, 0, 0, 0]]], np.float32)
    cls = np.zeros((1, 4, 3), np.float32)
    got = tnd.MultiBoxTarget(T(anchors), T(labels), T(cls))
    want = jnd.MultiBoxTarget(J(anchors), J(labels), J(cls))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), atol=1e-6)
    assert got[2].asnumpy()[0, 0] == 3.0   # gt 1's class + 1


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("nms_topk", [-1, 12])
@pytest.mark.parametrize("force", [False, True])
def test_multibox_detection_equals_mxtpu(force, nms_topk, clip):
    rng = np.random.RandomState(5)
    anchors = jnd.MultiBoxPrior(J(np.zeros((1, 3, 5, 5), np.float32)),
                                sizes=(0.3, 0.5), ratios=(1, 2)).asnumpy()
    A = anchors.shape[1]
    logits = rng.randn(2, 4, A).astype(np.float32) * 2
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    loc = (rng.randn(2, A * 4) * 0.5).astype(np.float32)
    kw = dict(force_suppress=force, nms_topk=nms_topk, clip=clip,
              nms_threshold=0.45)
    got = tnd.MultiBoxDetection(T(probs), T(loc), T(anchors), **kw)
    want = jnd.MultiBoxDetection(J(probs), J(loc), J(anchors),
                                 **kw).asnumpy()
    got = got.asnumpy()
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_array_equal(got[..., 1], want[..., 1])
    _close(got[..., 2:], want[..., 2:])
    kept = (got[..., 0] >= 0).sum()
    assert 0 < kept < got[..., 0].size
    if nms_topk > 0:
        assert ((got[..., 0] >= 0).sum(1) <= nms_topk).all()
    # the sweep's IoUs leave no pair at the threshold
    rows = want[0]
    _no_near_tie(tnms.pair_iou(torch.from_numpy(rows[:, 2:])).numpy(), 0.45)


# ---------------------------------------------------------------- Proposal

@pytest.mark.parametrize("kw", [
    dict(rpn_pre_nms_top_n=200, rpn_post_nms_top_n=50, output_score=True),
    dict(rpn_pre_nms_top_n=-1, rpn_post_nms_top_n=40, rpn_min_size=40,
         output_score=True),
    dict(scales=(8.0,), ratios=(0.5, 1.0, 2.0), rpn_pre_nms_top_n=60,
         rpn_post_nms_top_n=80, threshold=0.5)])
def test_proposal_equals_mxtpu(kw):
    """pre_n < M, the min-size filter (boxes under 40 px dropped), and a
    post_n past what survives (zero rows)."""
    rng = np.random.RandomState(7)
    A = len(kw.get("scales", (4.0, 8.0, 16.0, 32.0))) * \
        len(kw.get("ratios", (0.5, 1.0, 2.0)))
    N, H, W = 2, 6, 7
    cls = rng.rand(N, 2 * A, H, W).astype(np.float32)
    bbox = (rng.randn(N, 4 * A, H, W) * 0.2).astype(np.float32)
    info = np.array([[96, 112, 1.0], [90, 100, 1.5]], np.float32)
    got = tnd.Proposal(T(cls), T(bbox), T(info), **kw)
    want = jnd.Proposal(J(cls), J(bbox), J(info), **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want) == (2 if kw.get("output_score") else 1)
    g, w = got[0].asnumpy(), want[0].asnumpy()
    np.testing.assert_array_equal(g[:, 0], w[:, 0])
    np.testing.assert_allclose(g[:, 1:], w[:, 1:], rtol=1e-6, atol=1e-6)
    if len(got) == 2:
        np.testing.assert_array_equal(got[1].asnumpy(), want[1].asnumpy())
    if kw.get("rpn_min_size") == 40:
        live = g[(g[:, 1:] != 0).any(1)]
        assert ((live[:, 3] - live[:, 1] + 1 >= 40) |
                (live[:, 4] - live[:, 2] + 1 >= 40)).all()


def test_proposal_refuses_anchor_count():
    with pytest.raises(tmx.base.MXNetError, match="anchors/position"):
        tnd.Proposal(T(np.zeros((1, 6, 4, 4), np.float32)),
                     T(np.zeros((1, 12, 4, 4), np.float32)),
                     T(np.array([[64, 64, 1.0]], np.float32)),
                     scales=(8.0,), ratios=(1.0,))


def test_anchor_grid_and_pixel_iou_equal_mxtpu():
    np.testing.assert_array_equal(
        tdi._anchor_grid(5, 6, 16, (4.0, 8.0), (0.5, 1.0, 2.0)),
        jdi._anchor_grid(5, 6, 16, (4.0, 8.0), (0.5, 1.0, 2.0)))
    rng = np.random.RandomState(2)
    b = _boxes(rng, 40, scale=200.0)
    np.testing.assert_array_equal(
        tnms.pair_iou(torch.from_numpy(b), pixel=True).numpy(),
        np.asarray(jdi._pixel_iou(jnp.asarray(b))))
    np.testing.assert_array_equal(
        tnms.pair_iou(torch.from_numpy(b / 200.0)).numpy(),
        np.asarray(jdi._iou_corner(jnp.asarray(b / 200.0),
                                   jnp.asarray(b / 200.0))))


# ---------------------------------------------------------------- the sweep

@pytest.mark.parametrize("n_iter", [0, 7, 40, 64])
def test_greedy_nms_keep_equals_mxtpu(n_iter):
    rng = np.random.RandomState(n_iter)
    iou = rng.rand(64, 64).astype(np.float32)
    keep0 = rng.rand(64) > 0.2
    got = tnms.greedy_nms_keep(torch.from_numpy(iou),
                               torch.from_numpy(keep0), 0.6, n_iter)
    want = jdi._greedy_nms_keep(jnp.asarray(iou), jnp.asarray(keep0), 0.6,
                                n_iter)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # batched: each image as alone
    iou2 = np.stack([iou, iou.T])
    k2 = np.stack([keep0, keep0[::-1]])
    got2 = tnms.greedy_nms_keep(torch.from_numpy(iou2),
                                torch.from_numpy(k2), 0.6, n_iter).numpy()
    for i in range(2):
        np.testing.assert_array_equal(got2[i], np.asarray(
            jdi._greedy_nms_keep(jnp.asarray(iou2[i]), jnp.asarray(k2[i]),
                                 0.6, n_iter)))


@pytest.mark.parametrize("pixel", [False, True])
def test_iou_and_sweep_pass_nan_as_mxtpu(pixel):
    """A NaN corner gives NaN IoUs (torch's and jnp's minima and maxima
    pass it on, as the kernel's do), and a NaN IoU suppresses nothing:
    the IoU matrix and the keep mask equal mxtpu's."""
    rng = np.random.RandomState(11)
    scale = 200.0 if pixel else 1.0
    b = _boxes(rng, 24, scale=scale)
    b[3, 0] = b[10, 3] = b[17, 1] = np.nan
    got = tnms.pair_iou(torch.from_numpy(b), pixel=pixel).numpy()
    jb = jnp.asarray(b)
    want = jdi._pixel_iou(jb) if pixel else jdi._iou_corner(jb, jb)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert np.isnan(got[3]).all() and np.isnan(got[:, 10]).all()
    keep0 = np.ones(24, bool)
    keep = tnms.nms_keep(torch.from_numpy(b)[None],
                         torch.from_numpy(keep0)[None], 0.3, 24,
                         pixel=pixel)
    np.testing.assert_array_equal(keep[0].numpy(), np.asarray(
        jdi._greedy_nms_keep(want, jnp.asarray(keep0), 0.3, 24)))
    if not pixel:
        np.testing.assert_array_equal(
            tnd.contrib.box_iou(T(b), T(b)).asnumpy(),
            jnd.contrib.box_iou(J(b), J(b)).asnumpy())


def test_nms_keep_on_meta_and_plain_dispatch():
    rng = np.random.RandomState(4)
    b = torch.from_numpy(_boxes(rng, 30, batch=2))
    k0 = torch.ones(2, 30, dtype=torch.bool)
    ids = torch.from_numpy(rng.randint(0, 3, (2, 30)).astype(np.float32))
    meta = tnms.nms_keep(b.to("meta"), k0.to("meta"), 0.5, 30,
                         ids=ids.to("meta"))
    assert meta.device.type == "meta" and meta.shape == (2, 30)
    assert meta.dtype == torch.bool
    got = tnms.nms_keep(b, k0, 0.5, 30, ids=ids)
    iou = torch.where(ids[..., :, None] == ids[..., None, :],
                      tnms.pair_iou(b), 0.0)
    np.testing.assert_array_equal(
        got.numpy(), tnms.greedy_nms_keep(iou, k0, 0.5, 30).numpy())
    with pytest.raises(tmx.base.MXNetError, match="keep0 must be bool"):
        tnms.nms_keep(b, k0.float(), 0.5, 30)


# ---------------------------------------------------------------- ROIs

def _roi_pool_case():
    rng = np.random.RandomState(0)
    # integers: many tied maxima inside a bin
    data = rng.randint(0, 4, (2, 3, 9, 8)).astype(np.float32)
    rois = np.array([[0, 0, 0, 7, 8], [1, 2, 2, 5, 5], [1, -3, 1, 20, 6],
                     [0, 1, 3, 4, 3], [1, 30, 30, 40, 40]], np.float32)
    return data, rois


@pytest.mark.parametrize("pooled,scale", [((3, 3), 1.0), ((2, 4), 0.7),
                                          ((7, 7), 0.5)])
def test_roi_pooling_forward_and_tied_gradient(pooled, scale):
    """Overlapping bins (floor/ceil), a roi past the map, an empty
    bin; the gradient split equally among a bin's tied maxima as
    jnp.max's VJP splits it."""
    data, rois = _roi_pool_case()
    fn = jget_op("ROIPooling").fn
    want, vjp = jax.vjp(lambda d: fn(d, jnp.asarray(rois),
                                     pooled_size=pooled,
                                     spatial_scale=scale),
                        jnp.asarray(data))
    xt = torch.from_numpy(data).requires_grad_(True)
    got = tget_op("ROIPooling")(xt, torch.from_numpy(rois),
                                pooled_size=pooled, spatial_scale=scale)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    head = np.random.RandomState(1).randn(*got.shape).astype(np.float32)
    (g,) = torch.autograd.grad(got, xt, torch.from_numpy(head))
    np.testing.assert_allclose(g.numpy(), np.asarray(
        vjp(jnp.asarray(head))[0]), rtol=1e-6, atol=1e-6)
    assert (np.asarray(want) == 0).any()   # the empty bins


@pytest.mark.parametrize("sample_ratio", [2, 0, 3])
def test_roi_align_forward_and_gradients(sample_ratio):
    rng = np.random.RandomState(3)
    data = rng.randn(2, 3, 10, 9).astype(np.float32)
    rois = np.array([[0, 0.5, 0.5, 7.2, 8.9], [1, 2.3, 1.1, 5.6, 6.4],
                     [1, -2.0, 3.0, 12.0, 5.0]], np.float32)
    kw = dict(pooled_size=(3, 2), spatial_scale=0.8,
              sample_ratio=sample_ratio)
    fn = jget_op("_contrib_ROIAlign").fn
    want, vjp = jax.vjp(lambda d, r: fn(d, r, **kw), jnp.asarray(data),
                        jnp.asarray(rois))
    xt = torch.from_numpy(data).requires_grad_(True)
    rt = torch.from_numpy(rois).requires_grad_(True)
    got = tget_op("ROIAlign")(xt, rt, **kw)
    _close(got, want)
    head = rng.randn(*got.shape).astype(np.float32)
    gx, gr = torch.autograd.grad(got, (xt, rt), torch.from_numpy(head))
    jx, jr = vjp(jnp.asarray(head))
    _close(gx, jx, 1e-5)
    _close(gr, jr, 1e-5)


def test_roi_align_refuses_position_sensitive():
    with pytest.raises(tmx.base.MXNetError, match="position_sensitive"):
        tnd.ROIAlign(T(np.zeros((1, 4, 4, 4), np.float32)),
                     T(np.array([[0, 0, 0, 3, 3]], np.float32)),
                     pooled_size=(2, 2), position_sensitive=True)


# ---------------------------------------------------------------- contrib

@pytest.mark.parametrize("fmt", ["corner", "center"])
def test_box_iou_equals_mxtpu(fmt):
    rng = np.random.RandomState(8)
    a = _boxes(rng, 7, batch=2)
    b = _boxes(rng, 5, batch=2)
    np.testing.assert_array_equal(
        tnd.contrib.box_iou(T(a), T(b), format=fmt).asnumpy(),
        jnd.contrib.box_iou(J(a), J(b), format=fmt).asnumpy())


@pytest.mark.parametrize("kw", [
    dict(id_index=0, topk=-1),
    dict(id_index=0, topk=9, valid_thresh=0.3),
    dict(id_index=0, force_suppress=True, overlap_thresh=0.3),
    dict(id_index=-1, topk=15, coord_start=2)])
@pytest.mark.parametrize("batched", [True, False])
def test_box_nms_equals_mxtpu(kw, batched):
    rng = np.random.RandomState(9)
    rows = np.concatenate([
        rng.randint(0, 3, (2, 40, 1)).astype(np.float32),
        rng.rand(2, 40, 1).astype(np.float32), _boxes(rng, 40, batch=2,
                                                      size=0.5)], -1)
    d = rows if batched else rows[0]
    got = tnd.contrib.box_nms(T(d), **kw).asnumpy()
    want = jnd.contrib.box_nms(J(d), **kw).asnumpy()
    np.testing.assert_array_equal(got, want)
    assert (got[..., 0] == -1).any() and (got[..., 0] >= 0).any()
    assert np.array_equal(tget_op("box_nms")(torch.from_numpy(d), **kw)
                          .numpy(), want)


@pytest.mark.parametrize("kw", [dict(threshold=0.2),
                                dict(is_ascend=True, threshold=0.7),
                                dict(threshold=0.1, topk=2)])
@pytest.mark.parametrize("batched", [True, False])
def test_bipartite_matching_equals_mxtpu(kw, batched):
    rng = np.random.RandomState(10)
    s = rng.rand(2, 5, 4).astype(np.float32)
    d = s if batched else s[0]
    got = tnd.contrib.bipartite_matching(T(d), **kw)
    want = jnd.contrib.bipartite_matching(J(d), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())


# ---------------------------------------------------------------- symbols

def test_symbolic_roipooling_and_proposal():
    """``sym.ROIPooling`` through eval, ``sym.Proposal``'s outputs
    following output_score, and both through infer_shape (the rules
    on ``meta`` tensors)."""
    sym = tmx.sym
    data, rois = sym.var("data"), sym.var("rois")
    out = sym.ROIPooling(data, rois, pooled_size=(2, 2))
    d, r = _roi_pool_case()
    res = out.eval(data=T(d), rois=T(r))
    np.testing.assert_array_equal(
        res[0].asnumpy(), jnd.ROIPooling(J(d), J(r),
                                         pooled_size=(2, 2)).asnumpy())
    _, outs, _ = out.infer_shape(data=(2, 3, 9, 8), rois=(5, 5))
    assert outs == [(5, 3, 2, 2)]
    cls, bbox, info = sym.var("cls"), sym.var("bbox"), sym.var("info")
    two = sym.Proposal(cls, bbox, info, scales=(8.0,), ratios=(1.0,),
                       rpn_post_nms_top_n=4, output_score=True)
    one = sym.Proposal(cls, bbox, info, scales=(8.0,), ratios=(1.0,),
                       rpn_post_nms_top_n=4)
    assert len(two) == 2 and len(one) == 1
    _, outs, _ = two.infer_shape(cls=(2, 2, 4, 4), bbox=(2, 4, 4, 4),
                                 info=(2, 3))
    assert outs == [(8, 5), (8, 1)]
    rng = np.random.RandomState(3)
    c = rng.rand(1, 2, 4, 4).astype(np.float32)
    b = np.zeros((1, 4, 4, 4), np.float32)
    i = np.array([[64, 64, 1.0]], np.float32)
    rois_t, scores_t = two.eval(cls=T(c), bbox=T(b), info=T(i))
    rois_j, scores_j = jmx.sym.Proposal(
        jmx.sym.var("cls"), jmx.sym.var("bbox"), jmx.sym.var("info"),
        scales=(8.0,), ratios=(1.0,), rpn_post_nms_top_n=4,
        output_score=True).eval(cls=J(c), bbox=J(b), info=J(i))
    np.testing.assert_allclose(rois_t.asnumpy(), rois_j.asnumpy(),
                               rtol=1e-6)
    np.testing.assert_array_equal(scores_t.asnumpy(), scores_j.asnumpy())
    det = sym.MultiBoxDetection(sym.var("p"), sym.var("l"), sym.var("a"))
    _, outs, _ = det.infer_shape(p=(2, 3, 20), l=(2, 80), a=(1, 20, 4))
    assert outs == [(2, 20, 6)]
    nms = sym.box_nms(sym.var("d"), topk=3)
    _, outs, _ = nms.infer_shape(d=(2, 10, 6))
    assert outs == [(2, 10, 6)]


def test_nd_ops_record_no_graph_where_mxtpu_has_none():
    """MultiBoxTarget is not differentiable: under record its outputs
    carry no graph, and the loss's gradient reaches cls_preds through
    the loss alone."""
    anchors, labels, cls = _target_inputs(4, "float32")
    c = T(cls)
    c.attach_grad()
    with tautograd.record():
        bt, bm, ct = tnd.MultiBoxTarget(T(anchors), T(labels), c)
        loss = tnd.sum(c * 1.0)
    loss.backward()
    assert not bt.data.requires_grad and not ct.data.requires_grad
    np.testing.assert_array_equal(c.grad.asnumpy(), np.ones_like(cls))
