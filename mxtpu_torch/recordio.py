"""RecordIO, the binary record container of MXNet (the counterpart of
``mxtpu/recordio.py``), format-compatible with the reference, so
``im2rec``-made ``.rec``/``.idx`` files load as they are and a file
written by either package reads back in the other byte for byte.

The wire format (``dmlc-core/include/dmlc/recordio.h``†): per record a
u32 magic ``0xced7230a``, a u32 whose upper 3 bits are the continuation
flag and whose lower 29 bits are the payload's length, then the payload
padded to 4 bytes.  The image-record header (``IRHeader``) is
``<IfQQ``, followed by ``flag`` float labels when ``flag > 0``.

This is mxtpu's pure-Python codec; mxtpu's optional native codec
(``core/recordio_core.cc``) is not loaded.  ``pack_img``/``unpack_img``
import ``cv2`` at the call, as mxtpu's do.
"""
from __future__ import annotations

import numbers
import os
import struct
import threading
from collections import namedtuple
from typing import List, Optional

import numpy as np

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader",
           "pack", "unpack", "pack_img", "unpack_img", "scan",
           "read_batch", "read_batch_into"]


def scan(uri: str):
    """Index every record of a .rec file → (offsets, lengths): no .idx
    needed."""
    offsets, lengths = [], []
    with MXRecordIO(uri, "r") as rec:
        while True:
            pos = rec.tell()
            payload = rec.read()
            if payload is None:
                break
            offsets.append(pos)
            lengths.append(len(payload))
    return offsets, lengths


def read_batch(uri: str, offsets, lengths, n_threads: int = 4):
    """Bulk-read records by (offset, length), in order; ``n_threads``
    is kept for mxtpu's signature (its optional native codec reads in
    parallel; this one reads sequentially)."""
    out = []
    with open(uri, "rb") as f:
        for off in offsets:
            f.seek(off)
            header = f.read(8)
            magic, lrec = struct.unpack("<II", header)
            if magic != _K_MAGIC:
                raise MXNetError(f"invalid magic at offset {off}")
            cflag, length = _decode_lrec(lrec)
            parts = [f.read(length)]
            while cflag not in (0, 3):
                f.seek((4 - (length & 3)) & 3, 1)
                magic, lrec = struct.unpack("<II", f.read(8))
                cflag, length = _decode_lrec(lrec)
                parts.append(f.read(length))
            out.append(b"".join(parts))
    return out

def read_batch_into(uri: str, offsets, lengths, out: np.ndarray,
                    header_bytes: int, n_threads: int = 4) -> bytes:
    """Bulk-read N EQUAL-LENGTH records, splitting each payload into
    its first ``header_bytes`` (returned concatenated, for vectorized
    IRHeader/label parsing) and the remainder, written into row ``i``
    of ``out`` (a writable C-contiguous uint8 array of exactly
    ``N * (length - header_bytes)`` bytes).

    The ImageRecordIter raw-record path.  Records of one chunk (the
    form ``MXRecordIO.write`` gives) are read straight into their rows
    of ``out`` (``readinto``, no copy, the GIL released); a batch with
    another record (several chunks, or a length that differs) is
    assembled as mxtpu's pure-Python codec does, with the same result
    or the same error."""
    lengths = list(lengths)
    if len(set(lengths)) > 1:
        raise MXNetError("read_batch_into needs equal record lengths")
    n = len(offsets)
    if not n:
        return b""
    rows = out.reshape(n, -1)
    hdrs = bytearray(n * header_bytes)
    view = memoryview(hdrs)
    with open(uri, "rb", buffering=0) as f:
        for i, off in enumerate(offsets):
            f.seek(off)
            head = f.read(8)
            magic, lrec = struct.unpack("<II", head)
            if magic != _K_MAGIC:
                raise MXNetError(f"invalid magic at offset {off}")
            if lrec != _encode_lrec(0, lengths[0]) or \
                    rows.shape[1] != lengths[0] - header_bytes:
                return _read_batch_joined(uri, offsets, lengths, out,
                                          header_bytes, n_threads)
            got = f.readinto(view[i * header_bytes:(i + 1) * header_bytes])
            got += f.readinto(memoryview(rows[i]))
            if got != lengths[0]:
                raise MXNetError(f"truncated record at offset {off}")
    return bytes(hdrs)


def _read_batch_joined(uri, offsets, lengths, out, header_bytes,
                       n_threads):
    """mxtpu's ``read_batch_into``: every record read whole, joined, and
    split into ``out``'s rows and the header bytes."""
    raws = read_batch(uri, offsets, lengths, n_threads)
    flat = np.frombuffer(b"".join(raws), np.uint8)
    rows = flat.reshape(len(raws), lengths[0])
    out.reshape(len(raws), -1)[...] = rows[:, header_bytes:]
    return rows[:, :header_bytes].tobytes()


_K_MAGIC = 0xCED7230A
_FLAG_BITS = 29
_LEN_MASK = (1 << _FLAG_BITS) - 1


def _encode_lrec(cflag: int, length: int) -> int:
    return (cflag << _FLAG_BITS) | length


def _decode_lrec(lrec: int):
    return lrec >> _FLAG_BITS, lrec & _LEN_MASK


class MXRecordIO:
    """Sequential RecordIO reader/writer (reference ``MXRecordIO``†).

    Large records are split into continuation chunks exactly as
    dmlc-core does, so files interoperate both directions.
    """

    def __init__(self, uri: str, flag: str):
        self.uri = uri
        self.flag = flag
        self.pid = None
        self.record = None
        self.is_open = False
        self.open()

    def open(self):
        if self.flag == "w":
            self.record = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.record = open(self.uri, "rb")
            self.writable = False
        else:
            raise MXNetError(f"invalid flag {self.flag!r} (use 'r'/'w')")
        self.pid = os.getpid()
        self.is_open = True

    def close(self):
        if self.is_open:
            self.record.close()
            self.is_open = False
            self.pid = None

    def reset(self):
        """Seek back to the beginning (read mode)."""
        self.close()
        self.open()

    def _check_pid(self, allow_reset=False):
        # Reference behavior: a forked DataLoader worker must re-open its
        # own file handle (the descriptor's offset is shared after fork).
        if self.pid != os.getpid():
            if allow_reset:
                self.close()
                self.open()
            else:
                raise MXNetError("RecordIO handle used in a forked "
                                 "process; call reset() first")

    def write(self, buf: bytes):
        # Always written as one complete chunk (cflag 0) — dmlc readers
        # accept that unconditionally; the multi-chunk form (cflags
        # 1/2/3, produced by dmlc writers that split payloads at
        # embedded magic words for seek-recovery) is handled in read().
        assert self.writable
        self._check_pid(allow_reset=False)
        n = len(buf)
        self.record.write(struct.pack("<II", _K_MAGIC,
                                      _encode_lrec(0, n)))
        self.record.write(buf)
        pad = (4 - (n & 3)) & 3
        if pad:
            self.record.write(b"\x00" * pad)

    def read(self) -> Optional[bytes]:
        assert not self.writable
        self._check_pid(allow_reset=True)
        parts: List[bytes] = []
        while True:
            header = self.record.read(8)
            if len(header) < 8:
                return b"".join(parts) if parts else None
            magic, lrec = struct.unpack("<II", header)
            if magic != _K_MAGIC:
                raise MXNetError(
                    f"invalid RecordIO magic {magic:#x} in {self.uri}")
            cflag, length = _decode_lrec(lrec)
            data = self.record.read(length)
            if len(data) < length:
                raise MXNetError(f"truncated record in {self.uri}")
            pad = (4 - (length & 3)) & 3
            if pad:
                self.record.read(pad)
            parts.append(data)
            # cflag: 0 = complete record, 1 = first chunk, 2 = middle,
            # 3 = last chunk (dmlc recordio.h†)
            if cflag in (0, 3):
                return b"".join(parts)

    def tell(self) -> int:
        return self.record.tell()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class MXIndexedRecordIO(MXRecordIO):
    """RecordIO with a ``.idx`` sidecar for random access
    (reference ``MXIndexedRecordIO``†; the .idx holds
    ``key\\toffset`` lines)."""

    def __init__(self, idx_path: str, uri: str, flag: str,
                 key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys: List = []
        self.key_type = key_type
        self.fidx = None
        # seek+read must be atomic: DataLoader's thread pool shares one
        # dataset (and thus one file handle) across workers
        self._lock = threading.Lock()
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if self.writable:
            self.fidx = open(self.idx_path, "w")
        else:
            self.fidx = None
            if os.path.exists(self.idx_path):
                with open(self.idx_path) as f:
                    for line in f:
                        parts = line.strip().split("\t")
                        if len(parts) < 2:
                            continue
                        key = self.key_type(parts[0])
                        self.idx[key] = int(parts[1])
                        self.keys.append(key)
            else:
                # no .idx sidecar: rebuild the index by scanning the
                # record chain, cached on the instance so reset() and a
                # reopen after a fork don't rescan the whole file
                cached = getattr(self, "_scan_cache", None)
                if cached is None:
                    cached, _ = scan(self.uri)
                    self._scan_cache = cached
                for i, off in enumerate(cached):
                    key = self.key_type(i)
                    self.idx[key] = off
                    self.keys.append(key)

    def close(self):
        if self.is_open and self.fidx is not None:
            self.fidx.close()
            self.fidx = None
        super().close()

    def seek(self, idx):
        assert not self.writable
        self._check_pid(allow_reset=True)
        self.record.seek(self.idx[idx])

    def read_idx(self, idx) -> bytes:
        with self._lock:
            self.seek(idx)
            return self.read()

    def write_idx(self, idx, buf: bytes):
        assert self.writable
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write(f"{key}\t{pos}\n")
        self.idx[key] = pos
        self.keys.append(key)


#: Image-record header (reference ``IRHeader``†): flag counts extra float
#: labels; label is a scalar when flag == 0.
IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header: IRHeader, s: bytes) -> bytes:
    """Pack a header + payload into the image-record wire format
    (reference ``pack``†)."""
    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        out = struct.pack(_IR_FORMAT, header.flag, header.label,
                          header.id, header.id2)
    else:
        label = np.asarray(header.label, dtype=np.float32)
        out = struct.pack(_IR_FORMAT, label.size, 0.0, header.id,
                          header.id2)
        out += label.tobytes()
    return out + s


def unpack(s: bytes):
    """Unpack ``pack`` output → (IRHeader, payload) (reference†)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], np.float32).copy()
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def pack_img(header: IRHeader, img, quality=95, img_fmt=".jpg") -> bytes:
    """Encode an image (HWC uint8 numpy array) and pack it
    (reference ``pack_img``†, OpenCV-backed)."""
    import cv2
    ext = img_fmt.lower()
    if ext in (".jpg", ".jpeg"):
        encode_params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    elif ext == ".png":
        encode_params = [cv2.IMWRITE_PNG_COMPRESSION, quality // 10]
    else:
        raise MXNetError(f"unsupported image format {img_fmt}")
    ret, buf = cv2.imencode(img_fmt, img, encode_params)
    if not ret:
        raise MXNetError("failed to encode image")
    return pack(header, buf.tobytes())


def unpack_img(s: bytes, iscolor=-1):
    """Unpack and decode an image record → (IRHeader, HWC array)
    (reference ``unpack_img``†)."""
    import cv2
    header, payload = unpack(s)
    img = cv2.imdecode(np.frombuffer(payload, np.uint8), iscolor)
    return header, img
