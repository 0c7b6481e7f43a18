"""The detection data path of the port against mxtpu's on the CPU:
``pack_det_label``, the two box-aware augmenters, ``CreateDetAugmenter``,
``ImageDetIter`` over one ``.rec`` file (written by the port, read by
both) and the two detection mAPs, ``VOC07MApMetric`` and ``MApMetric``.

Everything here is numpy on the host in both packages, so the batches,
labels and metric values are held equal, not close.  Decoding needs
``cv2`` (the tests that read images skip without it).
"""
import numpy as np
import pytest

from mxtpu import image as jimage
from mxtpu import metric as jmetric

from mxtpu_torch import image as timage
from mxtpu_torch import metric as tmetric
from mxtpu_torch import recordio as trio


def _write_rec(prefix, n=12, size=48, seed=5):
    """Det records with the port's recordio: a class-coloured square an
    image (two on every third), labels packed with pack_det_label."""
    pytest.importorskip("cv2")
    rng = np.random.RandomState(seed)
    rec = trio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(n):
        img = (rng.rand(size, size, 3) * 40).astype(np.uint8)
        boxes = []
        for _ in range(1 + (i % 3 == 0)):
            cls = int(rng.randint(2))
            w = int(rng.randint(size // 4, size // 2))
            x0, y0 = (int(v) for v in rng.randint(0, size - w, 2))
            img[y0:y0 + w, x0:x0 + w] = (220, 40, 60) if cls == 0 \
                else (40, 220, 60)
            boxes.append([cls, x0 / size, y0 / size, (x0 + w) / size,
                          (y0 + w) / size])
        rec.write_idx(i, trio.pack_img(
            trio.IRHeader(0, timage.pack_det_label(boxes), i, 0), img,
            quality=95))
    rec.close()
    return prefix + ".rec", prefix + ".idx"


@pytest.mark.parametrize("extra", [(), (7.0, 3.0)])
def test_pack_det_label_equals_mxtpu(extra):
    objs = [[1, 0.1, 0.2, 0.3, 0.4], [0, 0.5, 0.5, 0.9, 0.9]]
    got = timage.pack_det_label(objs, extra_header=extra)
    want = jimage.pack_det_label(objs, extra_header=extra)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_det_flip_aug_equals_mxtpu():
    rng = np.random.RandomState(0)
    img = rng.rand(16, 12, 3)
    label = np.asarray([[0, 0.1, 0.2, 0.4, 0.6], [-1, -1, -1, -1, -1],
                        [1, 0.5, 0.1, 0.9, 0.3]], np.float32)
    for seed in range(6):
        ti, tl = timage.DetHorizontalFlipAug(
            0.5, rng=np.random.RandomState(seed))(img.copy(), label.copy())
        ji, jl = jimage.DetHorizontalFlipAug(
            0.5, rng=np.random.RandomState(seed))(img.copy(), label.copy())
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)


def test_det_random_crop_aug_equals_mxtpu():
    img = np.random.RandomState(3).rand(64, 48, 3)
    label = np.asarray([[0, 0.3, 0.3, 0.7, 0.7], [1, 0.0, 0.0, 0.2, 0.1],
                        [-1, -1, -1, -1, -1]], np.float32)
    kw = dict(min_object_covered=0.5, area_range=(0.3, 0.9),
              max_attempts=10)
    dropped = 0
    for seed in range(10):
        ti, tl = timage.DetRandomCropAug(
            rng=np.random.RandomState(seed), **kw)(img, label.copy())
        ji, jl = jimage.DetRandomCropAug(
            rng=np.random.RandomState(seed), **kw)(img, label.copy())
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)
        dropped += int((tl[:, 0] < 0).sum() > 1)
    assert dropped   # some crop drops an object whose centre falls out


def test_create_det_augmenter_matches_mxtpu():
    for kw in ({}, {"rand_crop": 0.5}, {"rand_mirror": True},
               {"rand_crop": 1.0, "rand_mirror": True}):
        got = timage.CreateDetAugmenter((3, 32, 32), **kw)
        want = jimage.CreateDetAugmenter((3, 32, 32), **kw)
        assert [type(a).__name__ for a in got] == \
            [type(a).__name__ for a in want]
    assert isinstance(got[0], timage.DetAugmenter)


def _epoch(mod, rec, idx, threads, **kw):
    it = mod.ImageDetIter(rec, (3, 32, 32), batch_size=5, path_imgidx=idx,
                          preprocess_threads=threads, **kw)
    out = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in it]
    descs = (it.provide_data, it.provide_label, it.max_objs)
    it.close()
    return out, descs


@pytest.mark.parametrize("threads", [1, 4])
def test_imagedetiter_batches_equal_mxtpu(tmp_path, threads):
    """Seeded shuffle, crop and mirror over the same .rec: batches,
    labels (padded with -1 rows to max_objs) and pads bit for bit, at
    one and four decode threads."""
    rec, idx = _write_rec(str(tmp_path / "det"))
    kw = dict(shuffle=True, rand_crop=0.5, rand_mirror=True, seed=9,
              mean_pixels=(10, 20, 30), std_pixels=(2, 3, 4), scale=0.5)
    got, tdesc = _epoch(timage, rec, idx, threads, **kw)
    want, jdesc = _epoch(jimage, rec, idx, threads, **kw)
    assert len(got) == len(want) == 3
    for (td, tl, tp), (jd, jl, jp) in zip(got, want):
        assert td.dtype == np.float32 and tl.shape == (5, 2, 5)
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tl, jl)
        assert tp == jp
    assert got[-1][2] == 3     # 12 % 5 = 2 real, 3 pad
    assert tdesc[2] == jdesc[2] == 2
    assert [tuple(d.shape) for d in tdesc[0] + tdesc[1]] == \
        [tuple(d.shape) for d in jdesc[0] + jdesc[1]]


def test_imagedetiter_reproducible_any_pool_size_and_host_batches(tmp_path):
    """The port alone: the same seed gives the same epoch at 1 and 4
    threads, a second epoch after reset differs, and batches lie on the
    host."""
    rec, idx = _write_rec(str(tmp_path / "rp"), n=10)
    kw = dict(shuffle=True, rand_crop=0.5, rand_mirror=True, seed=3)
    a, _ = _epoch(timage, rec, idx, 4, **kw)
    b, _ = _epoch(timage, rec, idx, 1, **kw)
    for (da, la, _), (db, lb, _) in zip(a, b):
        np.testing.assert_array_equal(da, db)
        np.testing.assert_array_equal(la, lb)
    it = timage.ImageDetIter(rec, (3, 32, 32), batch_size=4,
                             path_imgidx=idx, **kw)
    first = next(it)
    assert first.data[0].context.type == "cpu"
    it.reset()
    again = next(it)
    assert not np.array_equal(first.data[0].asnumpy(),
                              again.data[0].asnumpy())
    it.close()


def test_imagedetiter_sequential_and_discard(tmp_path):
    rec, idx = _write_rec(str(tmp_path / "sq"), n=7)
    for mod in (timage, jimage):
        with pytest.raises(Exception, match="shuffle requires"):
            mod.ImageDetIter(rec, (3, 32, 32), shuffle=True)
    got = [b.label[0].asnumpy() for b in timage.ImageDetIter(
        rec, (3, 32, 32), batch_size=3, last_batch_handle="discard")]
    want = [b.label[0].asnumpy() for b in jimage.ImageDetIter(
        rec, (3, 32, 32), batch_size=3, last_batch_handle="discard")]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _random_dets(rng, b=3, n=12, m=4, classes=3):
    labels = np.full((b, m, 6), -1.0, np.float32)
    preds = np.full((b, n, 6), -1.0, np.float32)
    for i in range(b):
        for k in range(rng.randint(1, m + 1)):
            x0, y0 = rng.uniform(0, 0.6, 2)
            labels[i, k] = [rng.randint(classes), x0, y0, x0 + 0.3, y0 + 0.3,
                            float(rng.rand() < 0.2)]
        for k in range(rng.randint(1, n + 1)):
            src = labels[i, rng.randint(0, m)]
            if src[0] < 0 or rng.rand() < 0.3:
                x0, y0 = rng.uniform(0, 0.6, 2)
                box = [x0, y0, x0 + 0.3, y0 + 0.3]
            else:
                box = list(src[1:5] + rng.uniform(-0.08, 0.08, 4))
            preds[i, k] = [rng.randint(classes), rng.rand()] + box
    return labels, preds


@pytest.mark.parametrize("name", ["VOC07MApMetric", "MApMetric"])
@pytest.mark.parametrize("iou", [0.5, 0.3])
def test_map_metrics_equal_mxtpu(name, iou):
    """Random detections against labels with difficult rows and padding,
    over three updates; the registry's names and aliases."""
    rng = np.random.RandomState(int(iou * 10))
    t = getattr(tmetric, name)(iou_thresh=iou)
    j = getattr(jmetric, name)(iou_thresh=iou)
    for _ in range(3):
        labels, preds = _random_dets(rng)
        t.update([labels], [preds])
        j.update([labels], [preds])
        assert t.get() == j.get()
    assert 0.0 < t.get()[1] < 1.0
    t.reset()
    assert np.isnan(t.get()[1])
    alias = {"VOC07MApMetric": "voc07_map", "MApMetric": "det_map"}[name]
    assert type(tmetric.create(alias)) is getattr(tmetric, name)
    assert type(tmetric.create(name.lower())) is getattr(tmetric, name)


def test_map_known_values():
    """tests/test_detection_pipeline.py's fixed arrays through both
    metrics: perfect detections, a duplicate (a false positive after
    full recall), a difficult ground truth matched (neutral)."""
    label = np.array([[[0, .1, .1, .5, .5], [1, .6, .6, .9, .9],
                       [-1] * 5]])
    pred = np.array([[[0, .95, .1, .1, .5, .5], [1, .9, .6, .6, .9, .9],
                      [-1] * 6]])
    pred_dup = np.array([[[0, .95, .1, .1, .5, .5],
                          [0, .90, .1, .1, .5, .5], [-1] * 6]])
    label_one = np.array([[[0, .1, .1, .5, .5]]])
    hard = np.array([[[0, .1, .1, .5, .5, 0], [0, .6, .6, .9, .9, 1]]])
    pred_hard = np.array([[[0, .95, .1, .1, .5, .5],
                           [0, .90, .6, .6, .9, .9]]])
    for name in ("VOC07MApMetric", "MApMetric"):
        for lab, pr in ((label, pred), (label_one, pred_dup),
                        (hard, pred_hard)):
            t, j = getattr(tmetric, name)(), getattr(jmetric, name)()
            t.update([lab], [pr])
            j.update([lab], [pr])
            assert t.get() == j.get()
            assert abs(t.get()[1] - 1.0) < 1e-6
