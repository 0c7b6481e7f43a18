"""Gluon's data API and the image helpers of the port
(``mxtpu_torch/gluon/data/``, ``mxtpu_torch/image.py``) against mxtpu's
on the CPU: datasets and ``transform``/``transform_first``, the
samplers (``RandomSampler`` from numpy's global stream, so a seed gives
mxtpu's order), ``BatchSampler``'s ``last_batch`` modes, the
``DataLoader`` with thread and spawned process workers (equal to the
serial loader; one pool kept across epochs), the vision transforms, the
``image.py`` helpers and augmenters, ``ImageIter``, and the CIFAR-10,
CIFAR-100 and MNIST datasets read from files the tests write.

Tolerances: integer and copied data bit for bit; f32 arithmetic 1e-6;
bilinear resizes 1e-4 on 0-255 images (torch's antialiased bilinear
against ``jax.image.resize``, which sum the same taps in another
order; measured 4.6e-5), and a uint8 resize within 1 of mxtpu's where
a value lands near a rounding tie; the nearest resize bit for bit.
JPEG/PNG decoding needs ``cv2``: ``imdecode``/``imread``,
``ImageFolderDataset`` and ``ImageRecordDataset`` tests skip without
it, and one that runs only without it checks the ``ImportError``.
"""
import pickle
import random
import struct

import numpy as np
import pytest
import torch

import mxtpu.image as jimage
from mxtpu import nd as jnd
from mxtpu import recordio as jrio
from mxtpu.gluon import data as jdata
from mxtpu.gluon.data.vision import transforms as jtf

import mxtpu_torch as tmx
from mxtpu_torch import image as timage, nd
from mxtpu_torch.gluon import data as tdata
from mxtpu_torch.gluon.data.vision import transforms as ttf
from mxtpu_torch.ndarray.ndarray import NDArray

torch.set_num_threads(2)

CPU = tmx.cpu()


def _img(h=12, w=15, seed=0, dtype=np.uint8):
    a = np.random.RandomState(seed).rand(h, w, 3) * 255
    return a.astype(dtype)


def _host(a):
    if isinstance(a, tuple):
        return tuple(_host(x) for x in a)
    return a.asnumpy() if hasattr(a, "asnumpy") else np.asarray(a)


# ------------------------------------------------ datasets and samplers

def test_datasets_and_transforms_match_mxtpu():
    X = np.random.RandomState(0).randn(10, 4).astype(np.float32)
    y = np.arange(10)
    for data in (jdata, tdata):
        ds = data.ArrayDataset(X, y)
        assert len(ds) == 10
        xi, yi = ds[3]
        np.testing.assert_array_equal(xi, X[3])
        assert yi == 3
        t = data.SimpleDataset(list(range(5))).transform(lambda v: v * 2)
        assert t[2] == 4 and len(t) == 5
        eager = data.SimpleDataset(list(range(5))).transform(
            lambda v: v + 1, lazy=False)
        assert isinstance(eager, data.SimpleDataset) and eager[4] == 5
        tf = data.ArrayDataset(np.arange(4, dtype=np.float32),
                               np.arange(4)).transform_first(
            lambda v: v + 100)
        assert tf[1] == (101.0, 1)
        assert data.ArrayDataset(X)[2].tolist() == X[2].tolist()
        with pytest.raises(Exception, match="same length"):
            data.ArrayDataset(X, y[:3])


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_samplers_match_mxtpu(last_batch):
    assert list(tdata.SequentialSampler(5)) == [0, 1, 2, 3, 4]
    np.random.seed(3)
    want = list(jdata.RandomSampler(9))
    np.random.seed(3)
    assert list(tdata.RandomSampler(9)) == want
    jb = jdata.BatchSampler(jdata.SequentialSampler(7), 3, last_batch)
    tb = tdata.BatchSampler(tdata.SequentialSampler(7), 3, last_batch)
    for _ in range(2):   # rollover carries the remainder into epoch 2
        assert list(tb) == list(jb)
        assert len(tb) == len(jb)
    with pytest.raises(tmx.MXNetError):
        tdata.BatchSampler(tdata.SequentialSampler(7), 3, "pad")


def test_record_file_dataset_threaded_reads(tmp_path):
    """mxtpu's ``test_record_file_dataset`` and
    ``test_record_dataset_threaded_reads``: concurrent ``read_idx``
    through a thread pool stays consistent."""
    from concurrent.futures import ThreadPoolExecutor
    rec, idx = str(tmp_path / "t.rec"), str(tmp_path / "t.idx")
    w = jrio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(64):
        w.write_idx(i, (f"payload-{i:03d}-" + "x" * (i % 17)).encode())
    w.close()
    ds = tdata.RecordFileDataset(rec)
    assert len(ds) == 64 and ds[2] == jdata.RecordFileDataset(rec)[2]

    def check(i):
        assert ds[i].startswith(f"payload-{i:03d}-".encode())
        return i
    with ThreadPoolExecutor(8) as pool:
        assert len(list(pool.map(check, list(range(64)) * 4))) == 256


# ------------------------------------------------------------ DataLoader

def _loader_batches(data, ds, **kw):
    return [_host(b) for b in data.DataLoader(ds, **kw)]


@pytest.mark.parametrize("kw", [
    dict(batch_size=4, last_batch="keep"),
    dict(batch_size=4, last_batch="discard", shuffle=True),
    dict(batch_size=4, last_batch="rollover", shuffle=True),
    dict(batch_size=3, num_workers=2),
    dict(batch_size=5, shuffle=True, num_workers=1, prefetch=3)])
def test_dataloader_matches_mxtpu(kw):
    X = np.random.RandomState(0).randn(11, 3).astype(np.float32)
    y = np.arange(11, dtype=np.float32)
    np.random.seed(5)
    want = _loader_batches(jdata, jdata.ArrayDataset(X, y), **kw)
    np.random.seed(5)
    loader = tdata.DataLoader(tdata.ArrayDataset(X, y), **kw)
    n = len(loader)   # before the epoch: "rollover" carries its rest on
    got = [_host(b) for b in loader]
    assert len(got) == len(want) == n
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype and gy.dtype == wy.dtype
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    b = next(iter(loader))
    assert isinstance(b[0], NDArray) and b[0].context == CPU
    loader.close()


def test_dataloader_refusals_match_mxtpu():
    ds = tdata.ArrayDataset(np.zeros((8, 2), np.float32))
    for data, d in ((tdata, ds), (jdata, jdata.SimpleDataset([0] * 8))):
        for kw in (dict(batch_size=4, worker_type="fiber"),
                   dict(batch_size=4, worker_type="process",
                        batchify_fn=lambda x: x),
                   dict(), dict(batch_size=4, shuffle=True,
                                sampler=data.SequentialSampler(8)),
                   dict(batch_size=4, batch_sampler=data.BatchSampler(
                       data.SequentialSampler(8), 4))):
            with pytest.raises(Exception):
                data.DataLoader(d, **kw)


def test_process_workers_match_serial_across_epochs():
    """Two spawned workers (each imports torch once, so one pool for the
    whole test): two epochs equal to the serial loader, the same pool
    kept across them, no CUDA in a worker, and ``close`` joins them."""
    rng = np.random.RandomState(1)
    ds = tdata.ArrayDataset(rng.randn(40, 6).astype(np.float32),
                            np.arange(40, dtype=np.int32) % 3)
    loader = tdata.DataLoader(ds, batch_size=8, num_workers=2,
                              worker_type="process")
    serial = [_host(b) for b in tdata.DataLoader(ds, batch_size=8)]
    try:
        for epoch in range(2):
            got = [_host(b) for b in loader]
            assert len(got) == len(serial) == 5
            for (gx, gy), (sx, sy) in zip(got, serial):
                assert gx.dtype == sx.dtype and gy.dtype == sy.dtype
                np.testing.assert_array_equal(gx, sx)
                np.testing.assert_array_equal(gy, sy)
            if epoch == 0:
                pool = loader._proc_pool
        assert loader._proc_pool is pool   # the same workers
        assert pool.submit(_worker_env).result() == ("", False)
    finally:
        loader.close()
    assert loader._proc_pool is None


def _worker_env():
    import os
    return os.environ.get("CUDA_VISIBLE_DEVICES"), \
        torch.cuda.is_initialized()


def test_dataloader_feeds_a_gluon_training_loop():
    """mxtpu's ``test_dataloader_feeds_training`` in the port: the
    loader's host batches through a Trainer loop on the CPU."""
    from mxtpu_torch import autograd, gluon
    from mxtpu_torch.gluon import loss as gloss, nn
    tmx.random.seed(0)
    X = np.random.RandomState(0).randn(64, 6).astype(np.float32)
    yv = (X.sum(1) > 0).astype(np.float32)
    np.random.seed(0)
    loader = tdata.DataLoader(tdata.ArrayDataset(X, yv), batch_size=16,
                              shuffle=True, num_workers=1)
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu"), nn.Dense(1))
    net.initialize(init="xavier", ctx=CPU)
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 0.05})
    L = gloss.SigmoidBinaryCrossEntropyLoss()
    losses = []
    for _ in range(8):
        tot = 0.0
        for xb, yb in loader:
            with autograd.record():
                out = net(xb)
                loss = L(out, yb.reshape((-1, 1)))
            loss.backward()
            trainer.step(xb.shape[0])
            tot += float(loss.mean().asnumpy())
        losses.append(tot)
    assert losses[-1] < losses[0] * 0.7, losses


# ---------------------------------------------------------- transforms

def _pair(make, x):
    """``make(transforms)`` applied to the same HWC image in both
    packages, numpy's global stream seeded alike."""
    np.random.seed(9)
    want = make(jtf)(jnd.array(x)).asnumpy()
    np.random.seed(9)
    got = make(ttf)(nd.array(x, ctx=CPU))
    assert isinstance(got, NDArray)
    return got.asnumpy(), want


TF_CASES = {
    "ToTensor": (lambda t: t.ToTensor(), 1e-6),
    "ToTensor-Normalize": (lambda t: t.Compose([
        t.ToTensor(), t.Normalize(mean=(0.4, 0.5, 0.6),
                                  std=(0.2, 0.25, 0.3))]), 1e-6),
    "Cast": (lambda t: t.Cast("float32"), 0),
    "Resize": (lambda t: t.Resize((6, 5)), 1e-4),
    "Resize-keep-ratio": (lambda t: t.Resize(8, keep_ratio=True), 1e-4),
    "Resize-up": (lambda t: t.Resize((31, 20)), 1e-4),
    "CenterCrop": (lambda t: t.CenterCrop((9, 7)), 0),
    "CenterCrop-small": (lambda t: t.CenterCrop(20), 1e-4),
    "RandomResizedCrop": (lambda t: t.RandomResizedCrop(5), 1e-4),
    "RandomFlipLeftRight": (lambda t: t.Compose(
        [t.RandomFlipLeftRight() for _ in range(3)]), 0),
    "RandomFlipTopBottom": (lambda t: t.Compose(
        [t.RandomFlipTopBottom() for _ in range(3)]), 0),
    "RandomBrightness": (lambda t: t.RandomBrightness(0.3), 1e-6),
    "RandomContrast": (lambda t: t.Compose(
        [t.Cast(), t.RandomContrast(0.3)]), 1e-4),
}


@pytest.mark.parametrize("name", list(TF_CASES))
def test_transform_matches_mxtpu(name):
    make, tol = TF_CASES[name]
    got, want = _pair(make, _img())
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * 255 if tol
                               and name.startswith(("Resize", "Center",
                                                    "RandomResized",
                                                    "RandomContrast"))
                               else tol)


# -------------------------------------------------------------- image.py

@pytest.mark.parametrize("size,interp,dtype", [
    ((6, 5), 1, np.float32), ((31, 20), 1, np.float32),
    ((6, 5), 1, np.uint8), ((45, 61), 0, np.uint8),
    ((7, 4), 0, np.float32), ((61, 45), 0, np.float32)])
def test_imresize_matches_mxtpu(size, interp, dtype):
    x = _img(20, 30, dtype=dtype) if size[0] > 40 else _img(dtype=dtype)
    want = jimage.imresize(jnd.array(x), *size, interp=interp).asnumpy()
    got = timage.imresize(nd.array(x, ctx=CPU), *size,
                          interp=interp).asnumpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if interp == 0:
        np.testing.assert_array_equal(got, want)
    elif dtype == np.uint8:
        assert np.abs(got.astype(int) - want).max() <= 1
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * 255)
    # a 2-D image keeps two axes
    g2 = timage.imresize(nd.array(x[:, :, 0], ctx=CPU), *size,
                         interp=interp)
    assert g2.shape == want.shape[:2]


def test_crops_and_color_normalize_match_mxtpu():
    x = _img(14, 11)
    jx, tx = jnd.array(x), nd.array(x, ctx=CPU)
    np.testing.assert_array_equal(
        timage.fixed_crop(tx, 2, 3, 5, 6).asnumpy(),
        jimage.fixed_crop(jx, 2, 3, 5, 6).asnumpy())
    np.testing.assert_allclose(
        timage.fixed_crop(tx, 2, 3, 5, 6, size=(4, 4)).asnumpy(),
        jimage.fixed_crop(jx, 2, 3, 5, 6, size=(4, 4)).asnumpy(), atol=1)
    for fn in ("center_crop", "random_crop"):
        for size in ((7, 5), (20, 16)):
            random.seed(4)
            (wimg, wbox) = getattr(jimage, fn)(jx, size)
            random.seed(4)
            (gimg, gbox) = getattr(timage, fn)(tx, size)
            assert gbox == wbox
            assert np.abs(gimg.asnumpy().astype(int) -
                          wimg.asnumpy()).max() <= 1
    np.testing.assert_array_equal(
        timage.resize_short(tx, 7).asnumpy().shape,
        jimage.resize_short(jx, 7).asnumpy().shape)
    mean, std = (120.0, 110.0, 100.0), (50.0, 60.0, 70.0)
    np.testing.assert_allclose(
        timage.color_normalize(tx, mean, std).asnumpy(),
        jimage.color_normalize(jx, mean, std).asnumpy(), rtol=1e-6)


def test_augmenters_and_create_augmenter_match_mxtpu():
    x = _img(20, 18)
    kw = dict(resize=16, rand_crop=True, rand_mirror=True, mean=True,
              std=True)
    jaugs = jimage.CreateAugmenter((3, 12, 10), **kw)
    taugs = timage.CreateAugmenter((3, 12, 10), **kw)
    assert [type(a).__name__ for a in taugs] == \
        [type(a).__name__ for a in jaugs]
    for seed in range(4):
        random.seed(seed)
        want = jnd.array(x)
        for a in jaugs:
            want = a(want)
        random.seed(seed)
        got = nd.array(x, ctx=CPU)
        for a in taugs:
            got = a(got)
        assert got.shape == want.shape == (12, 10, 3)
        # resize_short rounds to uint8 (within 1), then the normalize
        # divides by the std (~57)
        np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=0,
                                   atol=1.0 / 57.0 + 1e-5)
    flip = timage.ForceResizeAug((9, 8))(nd.array(x, ctx=CPU))
    assert flip.shape == (8, 9, 3)


def test_image_iter_with_augmenters_matches_mxtpu(tmp_path):
    rng = np.random.RandomState(2)
    imgs = (rng.rand(6, 3, 8, 10) * 255).astype(np.uint8)
    prefix = str(tmp_path / "raw")
    w = jrio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(6):
        w.write_idx(i, jrio.pack(jrio.IRHeader(0, float(i), i, 0),
                                 imgs[i].tobytes()))
    w.close()

    def run(image):
        random.seed(1)
        it = image.ImageIter(4, (3, 8, 10), path_imgrec=prefix + ".rec",
                             path_imgidx=prefix + ".idx", shuffle=True,
                             raw_records=True, dtype="uint8",
                             aug_list=[image.HorizontalFlipAug(0.5),
                                       image.CastAug()])
        return [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in it]
    want, got = run(jimage), run(timage)
    assert len(got) == len(want) == 2
    for (gd, gl), (wd, wl) in zip(got, want):
        assert gd.dtype == wd.dtype
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)
    with pytest.raises(tmx.MXNetError, match="path_imgrec"):
        timage.ImageIter(4, (3, 8, 10))


def test_decoding_needs_cv2_as_in_mxtpu(tmp_path):
    try:
        import cv2  # noqa: F401
    except ImportError:
        for image in (jimage, timage):
            with pytest.raises(ImportError):
                image.imdecode(b"\x89PNG")
        (tmp_path / "a" / "x").mkdir(parents=True)
        (tmp_path / "a" / "x" / "0.png").write_bytes(b"\x89PNG")
        for data in (jdata, tdata):
            ds = data.vision.ImageFolderDataset(str(tmp_path / "a"))
            assert ds.synsets == ["x"] and len(ds) == 1
            with pytest.raises(ImportError):
                ds[0]
        return
    pytest.skip("cv2 is installed: the decode tests below cover it")


def test_imdecode_and_imread_match_mxtpu(tmp_path):
    cv2 = pytest.importorskip("cv2")
    img = _img(9, 11)
    path = str(tmp_path / "a.png")
    cv2.imwrite(path, img)
    with open(path, "rb") as f:
        buf = f.read()
    for kw in (dict(), dict(flag=0), dict(to_rgb=False)):
        want = jimage.imdecode(buf, **kw).asnumpy()
        got = timage.imdecode(buf, **kw)
        assert got.context == CPU
        np.testing.assert_array_equal(got.asnumpy(), want)
    np.testing.assert_array_equal(timage.imread(path).asnumpy(),
                                  img[:, :, ::-1])
    with pytest.raises(tmx.MXNetError, match="imdecode failed"):
        timage.imdecode(b"not an image")


def test_image_folder_and_record_datasets_decode(tmp_path):
    cv2 = pytest.importorskip("cv2")
    raws = [_img(12, 12, seed=i) for i in range(3)]
    for i, img in enumerate(raws):
        (tmp_path / "f" / f"c{i % 2}").mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(tmp_path / "f" / f"c{i % 2}" / f"{i}.png"), img)
    jds = jdata.vision.ImageFolderDataset(str(tmp_path / "f"))
    tds = tdata.vision.ImageFolderDataset(str(tmp_path / "f"))
    assert tds.synsets == jds.synsets == ["c0", "c1"]
    _same_dataset(jds, tds)
    rec, idx = str(tmp_path / "i.rec"), str(tmp_path / "i.idx")
    w = jrio.MXIndexedRecordIO(idx, rec, "w")
    for i, img in enumerate(raws):
        w.write_idx(i, jrio.pack_img(jrio.IRHeader(0, float(i), i, 0), img,
                                     img_fmt=".png"))
    w.close()
    _same_dataset(jdata.vision.ImageRecordDataset(rec),
                  tdata.vision.ImageRecordDataset(rec))
    # pack_img takes BGR (cv2's order); the dataset yields RGB
    np.testing.assert_array_equal(
        tdata.vision.ImageRecordDataset(rec)[1][0].asnumpy(),
        raws[1][:, :, ::-1])


# -------------------------------------------------------- vision datasets

def _write_cifar(root, name, batches, n=4, fine=False):
    base = root / name
    base.mkdir(parents=True)
    rng = np.random.RandomState(len(name))
    for b in batches:
        d = {"data": (rng.rand(n, 3072) * 255).astype(np.uint8)}
        if fine:
            d["fine_labels"] = list(rng.randint(0, 100, n))
            d["coarse_labels"] = list(rng.randint(0, 20, n))
        else:
            d["labels"] = list(rng.randint(0, 10, n))
        with open(base / b, "wb") as f:
            pickle.dump(d, f)


def _same_dataset(jds, tds):
    assert len(tds) == len(jds) > 0
    for i in (0, len(jds) - 1):
        (ti, tl), (ji, jl) = tds[i], jds[i]
        assert isinstance(ti, NDArray) and ti.context == CPU
        np.testing.assert_array_equal(ti.asnumpy(), ji.asnumpy())
        assert tl == jl


@pytest.mark.parametrize("train", [True, False])
def test_cifar_and_mnist_from_local_files_match_mxtpu(tmp_path, train):
    _write_cifar(tmp_path / "c10", "cifar-10-batches-py",
                 [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"])
    _write_cifar(tmp_path / "c100", "cifar-100-python", ["train", "test"],
                 fine=True)
    rng = np.random.RandomState(0)
    (tmp_path / "mnist").mkdir()
    for prefix, n in (("train", 6), ("t10k", 3)):
        imgs = (rng.rand(n, 28, 28) * 255).astype(np.uint8)
        with open(tmp_path / "mnist" / f"{prefix}-images-idx3-ubyte",
                  "wb") as f:
            f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
        with open(tmp_path / "mnist" / f"{prefix}-labels-idx1-ubyte",
                  "wb") as f:
            f.write(struct.pack(">II", 2049, n) +
                    rng.randint(0, 10, n).astype(np.uint8).tobytes())
    for name, root, kw in (("CIFAR10", "c10", {}),
                           ("CIFAR100", "c100", {"fine_label": False}),
                           ("CIFAR100", "c100", {}),
                           ("MNIST", "mnist", {}),
                           ("FashionMNIST", "mnist", {})):
        jds = getattr(jdata.vision, name)(root=str(tmp_path / root),
                                          train=train, **kw)
        tds = getattr(tdata.vision, name)(root=str(tmp_path / root),
                                          train=train, **kw)
        _same_dataset(jds, tds)
    ttr = tdata.vision.CIFAR10(root=str(tmp_path / "c10"), train=train,
                               transform=lambda img, lab: (img, lab + 1))
    assert ttr[0][1] == tdata.vision.CIFAR10(
        root=str(tmp_path / "c10"), train=train)[0][1] + 1
    with pytest.raises(tmx.MXNetError, match="not found"):
        tdata.vision.CIFAR10(root=str(tmp_path / "nowhere"))
