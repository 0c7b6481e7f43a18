"""RecordIO and the data iterators of the port (``mxtpu_torch/
recordio.py``, ``mxtpu_torch/io.py``) against mxtpu's on the CPU.

RecordIO files written by either package are byte-equal (the ``.rec``
and its ``.idx``) and read back in the other; ``scan``,
``read_batch`` and ``read_batch_into`` give mxtpu's results.
``ImageRecordIter`` over raw records hands over mxtpu's batches bit for
bit (pixels, labels, pads) over seeded epochs: indexed and shuffled,
mirrored, sequential without an index, pad and discard,
``label_width`` 2, uint8 and f32, and the per-record path with its
decode pool.  ``ResizeIter``, ``PrefetchingIter`` and
``DeviceFeedIter(ctx=cpu())`` hand over the batches of the iterator
they wrap, across a reset in the middle of an epoch.  Also mirrored:
mxtpu's own ``tests/test_gluon_data.py`` and
``tests/test_io_throughput.py`` cases for these modules, without their
throughput assertions.  JPEG/PNG records need ``cv2``: its tests skip
without it, and a test that runs only without it checks that both
packages then raise ``ImportError`` at the call.
"""

import numpy as np
import pytest
import torch

from mxtpu import io as jio
from mxtpu import recordio as jrio

import mxtpu_torch as tmx
from mxtpu_torch import io as tio
from mxtpu_torch import recordio as trio
from mxtpu_torch.ndarray.ndarray import NDArray

torch.set_num_threads(2)

CPU = tmx.cpu()
PKG = {"mxtpu": jrio, "port": trio}


def _payloads(n=20):
    return [bytes([i % 251]) * (i * 7 + 1) for i in range(n)]


def _write(rio, prefix, indexed, records):
    if indexed:
        w = rio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
        for i, r in enumerate(records):
            w.write_idx(i, r)
    else:
        w = rio.MXRecordIO(prefix + ".rec", "w")
        for r in records:
            w.write(r)
    w.close()


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _headered(rio, n=12):
    """Image-record payloads: scalar labels, then label arrays."""
    rng = np.random.RandomState(0)
    out = []
    for i in range(n):
        label = float(i % 5) if i % 2 else \
            np.array([i, i + 0.5, -i], np.float32)
        out.append(rio.pack(rio.IRHeader(0, label, i, i * 3),
                            rng.bytes(5 + i)))
    return out


@pytest.mark.parametrize("indexed", [False, True])
def test_files_are_byte_equal_and_cross(tmp_path, indexed):
    records = _payloads() + _headered(trio)
    assert _headered(trio) == _headered(jrio)
    for name, rio in PKG.items():
        _write(rio, str(tmp_path / name), indexed, records)
    exts = (".rec", ".idx") if indexed else (".rec",)
    for ext in exts:
        assert _read(tmp_path / ("port" + ext)) == \
            _read(tmp_path / ("mxtpu" + ext))
    for writer, reader in (("mxtpu", trio), ("port", jrio)):
        prefix = str(tmp_path / writer)
        if indexed:
            r = reader.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec",
                                         "r")
            assert r.keys == list(range(len(records)))
            assert [r.read_idx(k) for k in (7, 2, 31)] == \
                [records[7], records[2], records[31]]
        else:
            r = reader.MXRecordIO(prefix + ".rec", "r")
            assert [r.read() for _ in records] == records
            assert r.read() is None
            r.reset()
            assert r.read() == records[0]
        r.close()


def test_irheader_pack_unpack_match_mxtpu():
    for h in (trio.IRHeader(0, 3.0, 42, 0),
              trio.IRHeader(0, np.array([1.0, 2.0, 3.0], np.float32), 7,
                            1)):
        packed = trio.pack(h, b"payload")
        assert packed == jrio.pack(jrio.IRHeader(*h), b"payload")
        (th, tp), (jh, jp) = trio.unpack(packed), jrio.unpack(packed)
        assert tp == jp == b"payload"
        assert (th.flag, th.id, th.id2) == (jh.flag, jh.id, jh.id2)
        np.testing.assert_array_equal(th.label, jh.label)


def test_scan_read_batch_and_read_batch_into_match_mxtpu(tmp_path):
    path = str(tmp_path / "scan.rec")
    payloads = [bytes([i % 251]) * (10 + i * 7) for i in range(50)]
    _write(trio, path[:-4], False, payloads)
    offs, lens = trio.scan(path)
    joffs, jlens = jrio.scan(path)
    assert (list(offs), list(lens)) == (list(joffs), list(jlens))
    assert trio.read_batch(path, offs, lens) == payloads
    # an indexed reader without a .idx scans the chain
    r = trio.MXIndexedRecordIO(str(tmp_path / "missing.idx"), path, "r")
    assert len(r.keys) == 50 and r.read_idx(7) == payloads[7]
    r.close()
    # equal-length records split into a header prefix and rows
    path = str(tmp_path / "into.rec")
    hdr_bytes, row = 24, 48
    rng = np.random.RandomState(3)
    payloads = [rng.randint(0, 256, hdr_bytes + row).astype(np.uint8)
                .tobytes() for _ in range(20)]
    _write(trio, path[:-4], False, payloads)
    offs, lens = trio.scan(path)
    out, jout = np.zeros((20, row), np.uint8), np.zeros((20, row),
                                                        np.uint8)
    hdrs = trio.read_batch_into(path, offs, lens, out, hdr_bytes)
    jhdrs = jrio.read_batch_into(path, offs, lens, jout, hdr_bytes)
    want = np.frombuffer(b"".join(payloads), np.uint8).reshape(20, -1)
    np.testing.assert_array_equal(out, want[:, hdr_bytes:])
    np.testing.assert_array_equal(out, jout)
    assert hdrs == jhdrs == want[:, :hdr_bytes].tobytes()
    with pytest.raises(tmx.MXNetError, match="equal record lengths"):
        trio.read_batch_into(path, offs[:2], [lens[0], lens[0] + 4],
                             out[:2], hdr_bytes)
    # a record in two chunks (dmlc's continuation flags 1 and 3), as
    # other writers split payloads: read as mxtpu reads it
    import struct
    with open(path, "ab") as f:
        off = f.tell()
        for flag, part in ((1, payloads[3][:30]), (3, payloads[3][30:])):
            f.write(struct.pack("<II", 0xCED7230A,
                                (flag << 29) | len(part)))
            f.write(part + b"\x00" * (-len(part) % 4))
    offs2, lens2 = trio.scan(path)
    assert offs2[-1] == off and lens2[-1] == lens[0]
    picks = [offs2[0], off, offs2[5]]
    out, jout = (np.zeros((3, row), np.uint8) for _ in range(2))
    hdrs = trio.read_batch_into(path, picks, [lens[0]] * 3, out, hdr_bytes)
    jhdrs = jrio.read_batch_into(path, picks, [lens[0]] * 3, jout,
                                 hdr_bytes)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(out[1], want[3, hdr_bytes:])
    assert hdrs == jhdrs
    # a length that is not the records': both raise
    for rio in (trio, jrio):
        with pytest.raises(ValueError):
            rio.read_batch_into(path, offs[:2], [lens[0] - 4] * 2,
                                np.zeros((2, row - 4), np.uint8),
                                hdr_bytes)


# --------------------------------------------------------- ImageRecordIter

SHAPE = (3, 8, 10)


def _pack_raw(prefix, n=22, label_width=1, seed=7):
    """Raw CHW uint8 records, written by mxtpu (the files are
    byte-equal, see above)."""
    rng = np.random.RandomState(seed)
    imgs = (rng.rand(n, *SHAPE) * 255).astype(np.uint8)
    rec = jrio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(n):
        label = float(i % 10) if label_width == 1 else \
            np.array([i % 10, -i, 0.5 * i], np.float32)
        rec.write_idx(i, jrio.pack(jrio.IRHeader(0, label, i, 0),
                                   imgs[i].tobytes()))
    rec.close()
    return prefix + ".rec", prefix + ".idx", imgs


def _host(a):
    return a.asnumpy() if hasattr(a, "asnumpy") else np.asarray(a)


def _epoch(it, epochs=2):
    out = []
    for _ in range(epochs):
        for b in it:
            out.append((_host(b.data[0]), _host(b.label[0]), b.pad))
        it.reset()
    return out


ITER_CASES = {
    "indexed-shuffle-mirror-uint8": dict(shuffle=True, rand_mirror=True,
                                         dtype="uint8"),
    "indexed-shuffle-f32": dict(shuffle=True, rand_mirror=True,
                                mean_r=123.7, mean_g=116.3, mean_b=103.5,
                                std_r=58.4, std_g=57.1, std_b=57.4,
                                scale=0.5),
    "sequential-no-index": dict(index=False, dtype="uint8"),
    "sequential-no-index-mirror-f32": dict(index=False, rand_mirror=True),
    "discard": dict(shuffle=True, round_batch=False, dtype="uint8"),
    "label-width-2": dict(shuffle=True, label_width=2, rand_mirror=True),
    "per-record": dict(shuffle=True, rand_mirror=True, per_record=True,
                       preprocess_threads=2),
    "per-record-f32-one-thread": dict(rand_mirror=True, per_record=True,
                                      preprocess_threads=1, mean_g=9.0),
    "host-batches": dict(shuffle=True, rand_mirror=True, dtype="uint8",
                         host_batches=True),
}


@pytest.mark.parametrize("case", list(ITER_CASES))
def test_image_record_iter_batches_equal_mxtpus(tmp_path, case):
    kw = dict(ITER_CASES[case])
    index, per_record = kw.pop("index", True), kw.pop("per_record", False)
    lw = kw.get("label_width", 1)
    rec, idx, imgs = _pack_raw(str(tmp_path / "raw"), label_width=lw + 1
                               if lw > 1 else 1)

    def run(io):
        it = io.ImageRecordIter(rec, SHAPE, batch_size=8,
                                path_imgidx=idx if index else None,
                                raw_records=True, seed=11, **kw)
        it._raw_batched = not per_record
        out = _epoch(it)
        it.close()
        return out
    want, got = run(jio), run(tio)
    assert len(got) == len(want) > 0
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        assert gd.dtype == wd.dtype and gd.shape == wd.shape
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)
    if kw.get("host_batches"):
        assert isinstance(got[0][0], np.ndarray)
    if case == "sequential-no-index":
        np.testing.assert_array_equal(
            np.concatenate([d for d, _, _ in got])[:22], imgs)


def test_image_record_iter_refusals_match_mxtpu(tmp_path):
    rec, _, _ = _pack_raw(str(tmp_path / "raw"), n=4)
    for io in (jio, tio):
        with pytest.raises(Exception, match="shuffle requires path_imgidx"):
            io.ImageRecordIter(rec, SHAPE, batch_size=2, shuffle=True,
                               raw_records=True)
        with pytest.raises(Exception, match="float32 or uint8"):
            io.ImageRecordIter(rec, SHAPE, batch_size=2, dtype="float16",
                               raw_records=True)
        with pytest.raises(Exception, match="needs"):
            io.ImageRecordIter(rec, (3, 4, 4), batch_size=2,
                               raw_records=True).next()


def test_raw_uint8_roundtrip_and_pad_cycles(tmp_path):
    """mxtpu's ``test_imagerecorditer_raw_uint8_roundtrip``: the packed
    pixels bit for bit, labels included, pad rows cycling from the
    head; the batches are host NDArrays."""
    rec, idx, imgs = _pack_raw(str(tmp_path / "raw"), n=10)
    it = tio.ImageRecordIter(rec, SHAPE, batch_size=4, path_imgidx=idx,
                             raw_records=True, dtype="uint8")
    got = [(b.data[0], b.label[0], b.pad) for b in it]
    assert [p for _, _, p in got] == [0, 0, 2]
    assert all(isinstance(d, NDArray) and d.context == CPU
               for d, _, _ in got)
    out = np.concatenate([d.asnumpy() for d, _, _ in got])
    np.testing.assert_array_equal(out[:10], imgs)
    np.testing.assert_array_equal(out[10:], imgs[8:10])
    lab = np.concatenate([l.asnumpy() for _, l, _ in got])[:10]
    np.testing.assert_array_equal(lab, np.arange(10) % 10)


def test_jpeg_records_need_cv2_as_in_mxtpu(tmp_path):
    try:
        import cv2  # noqa: F401
    except ImportError:
        img = np.zeros((4, 4, 3), np.uint8)
        for rio in (jrio, trio):
            with pytest.raises(ImportError):
                rio.pack_img(rio.IRHeader(0, 1.0, 0, 0), img)
            with pytest.raises(ImportError):
                rio.unpack_img(rio.pack(rio.IRHeader(0, 1.0, 0, 0), b"x"))
        return
    pytest.skip("cv2 is installed: test_pack_img_roundtrip covers it")


def _pack_png(prefix, n=10, size=(12, 14)):
    """PNG records (lossless) written by mxtpu through cv2."""
    rng = np.random.RandomState(0)
    rec = jrio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(n):
        img = (rng.rand(*size, 3) * 255).astype(np.uint8)
        rec.write_idx(i, jrio.pack_img(jrio.IRHeader(0, float(i % 3), i, 0),
                                       img, img_fmt=".png"))
    rec.close()
    return prefix + ".rec", prefix + ".idx"


@pytest.mark.parametrize("kw", [
    dict(rand_crop=True, rand_mirror=True, shuffle=True, mean_r=120.0,
         std_b=50.0, preprocess_threads=2),
    dict(rand_crop=True, rand_mirror=True, preprocess_threads=1,
         dtype="uint8"),
    dict(shuffle=True, preprocess_threads=2)])   # no crop: cv2.resize
def test_image_record_iter_decoded_records_match_mxtpu(tmp_path, kw):
    """mxtpu's ``test_image_record_iter`` and
    ``test_imagerecorditer_seeded_reproducible_with_threads``: decoded
    batches (crop, mirror, BGR to RGB, normalize) bit for bit, whatever
    the decode pool's size."""
    pytest.importorskip("cv2")
    rec, idx = _pack_png(str(tmp_path / "png"))

    def run(io):
        it = io.ImageRecordIter(rec, (3, 8, 8), batch_size=4,
                                path_imgidx=idx, seed=3, **kw)
        out = _epoch(it)
        it.close()
        return out
    want, got = run(jio), run(tio)
    assert len(got) == len(want) == 6
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp and gd.dtype == wd.dtype
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)


def test_pack_img_roundtrip():
    pytest.importorskip("cv2")
    img = (np.random.RandomState(0).rand(16, 16, 3) * 255) \
        .astype(np.uint8)
    s = trio.pack_img(trio.IRHeader(0, 1.0, 0, 0), img, img_fmt=".png")
    assert s == jrio.pack_img(jrio.IRHeader(0, 1.0, 0, 0), img,
                              img_fmt=".png")
    h, img2 = trio.unpack_img(s)
    assert h.label == 1.0
    np.testing.assert_array_equal(img, img2)


# ------------------------------------------------- the wrapping iterators

def _ndarray_iter(io):
    X = np.arange(24, dtype=np.float32).reshape(8, 3)
    return io.NDArrayIter(X, np.arange(8, dtype=np.float32), batch_size=3)


def test_resize_iter_matches_mxtpu():
    want = [(_host(b.data[0]), b.pad)
            for b in jio.ResizeIter(_ndarray_iter(jio), 5)]
    it = tio.ResizeIter(_ndarray_iter(tio), 5)
    got = [(_host(b.data[0]), b.pad) for b in it]
    assert len(got) == len(want) == 5
    for (g, gp), (w, wp) in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert gp == wp
    it.reset()
    assert len(list(it)) == 5


def test_prefetching_iter_hands_over_the_inner_batches(tmp_path):
    rec, idx, _ = _pack_raw(str(tmp_path / "raw"))

    def inner():
        return tio.ImageRecordIter(rec, SHAPE, batch_size=8,
                                   path_imgidx=idx, raw_records=True,
                                   dtype="uint8", host_batches=True)
    want = _epoch(inner(), epochs=1)
    p = tio.PrefetchingIter(inner())
    for _ in range(2):
        got = [(_host(b.data[0]), _host(b.label[0]), b.pad) for b in p]
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[0], w[0])
            np.testing.assert_array_equal(g[1], w[1])
            assert g[2] == w[2]
        p.reset()
    # a reset in the middle of an epoch starts the epoch over
    next(p)
    p.reset()
    np.testing.assert_array_equal(_host(next(p).data[0]), want[0][0])
    # two iterators zipped: data and labels concatenated, the larger pad
    q = tio.PrefetchingIter([_ndarray_iter(tio), _ndarray_iter(tio)])
    b = next(q)
    assert len(b.data) == 2 and len(b.label) == 2
    assert len(list(q)) == 2
    q.close()
    p.close()
    with pytest.raises(tmx.MXNetError):
        p.iter_next()


def test_prefetching_iter_hands_a_worker_error_to_the_consumer():
    class Broken(tio.DataIter):
        batch_size = 1

        def next(self):
            raise ValueError("bad record")
    p = tio.PrefetchingIter(Broken())
    with pytest.raises(ValueError, match="bad record"):
        p.next()


def test_device_feed_iter_on_the_cpu(tmp_path):
    """``DeviceFeedIter(ctx=cpu())`` over the pipeline: the host
    batches unchanged, in order, as CPU NDArrays, two epochs and a reset
    in the middle of one (mxtpu's ``test_device_feed_iter`` too)."""
    rec, idx, _ = _pack_raw(str(tmp_path / "raw"))

    def inner():
        return tio.ImageRecordIter(rec, SHAPE, batch_size=8,
                                   path_imgidx=idx, shuffle=True,
                                   rand_mirror=True, raw_records=True,
                                   dtype="uint8", host_batches=True,
                                   seed=5)
    want = _epoch(inner(), epochs=2)
    feed = tio.DeviceFeedIter(tio.PrefetchingIter(inner()), ctx=CPU)
    got = []
    for _ in range(2):
        while True:
            try:
                b = feed.next()
            except StopIteration:
                break
            assert isinstance(b.data[0], NDArray)
            assert b.data[0].context == CPU
            got.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
        feed.reset()
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        assert g[2] == w[2]
    # reset mid-epoch: a plain inner iterator starts over
    feed = tio.DeviceFeedIter(_ndarray_iter(tio), ctx=CPU)
    first = feed.next().data[0].asnumpy()
    feed.next()
    feed.reset()
    np.testing.assert_array_equal(feed.next().data[0].asnumpy(), first)
    if not torch.cuda.is_available():
        with pytest.raises(tmx.MXNetError, match="CUDA is not available"):
            tio.DeviceFeedIter(_ndarray_iter(tio))
