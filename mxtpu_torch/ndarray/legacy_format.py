"""Reference-binary ``.params`` serialization (dmlc::Stream layout).

Byte-level parity with the reference's NDArray list files
(``src/ndarray/ndarray.cc``† ``NDArray::Save/Load``, framed by
``MXNDArraySave``† in ``src/c_api/c_api.cc``†), so checkpoints written
by the 2018-era framework load here directly and vice versa:

    uint64  kMXAPINDArrayListMagic = 0x112
    uint64  reserved = 0
    uint64  n_arrays, then per array the NDArray record below
    uint64  n_names,  then per name uint64 length + raw bytes

NDArray record (dense):

    uint32  magic: 0xF993FAC9 (V2 — what the reference era writes) or
            0xF993FACA (V3, written by later 1.x; accepted on read)
    int32   storage type (0 = dense; sparse records are rejected with
            guidance — the TPU port stores row_sparse/csr densely)
    uint32  ndim, then ndim dims as little-endian int64 — TShape
            serializes dim_t (int64) for BOTH V2 and V3; only the
            pre-V1 legacy layout used uint32 dims
    int32   dev_type, int32 dev_id   (context; ignored on load — the
            array lands on the current device)
    int32   type_flag (mshadow order: 0=f32 1=f64 2=f16 3=u8 4=i32
            5=i8 6=i64)
    raw     little-endian data bytes (size * dtype itemsize)

Everything is little-endian, matching dmlc on x86/ARM.
"""
from __future__ import annotations

import math
import struct
import warnings
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

from ..base import MXNetError

LIST_MAGIC = 0x112
V2_MAGIC = 0xF993FAC9
V3_MAGIC = 0xF993FACA

# mshadow type_flag ↔ numpy (reference mshadow/base.h† TypeFlag)
_TYPE_FLAG_TO_NP = {0: np.float32, 1: np.float64, 2: np.float16,  # mxlint: disable=dtype-hygiene (mshadow table)
                    3: np.uint8, 4: np.int32, 5: np.int8, 6: np.int64}
_NP_TO_TYPE_FLAG = {np.dtype(v): k for k, v in _TYPE_FLAG_TO_NP.items()}


def _write_arr(out: List[bytes], a: np.ndarray) -> None:
    # ascontiguousarray promotes 0-d to 1-d — restore the true shape
    a = np.ascontiguousarray(a).reshape(np.shape(a))
    if a.dtype == np.bool_:
        a = a.astype(np.uint8)
    flag = _NP_TO_TYPE_FLAG.get(np.dtype(a.dtype))
    if flag is None:
        raise MXNetError(
            f"dtype {a.dtype} has no reference type_flag; cast to one "
            f"of {sorted(str(np.dtype(t)) for t in _NP_TO_TYPE_FLAG)}")
    out.append(struct.pack("<I", V2_MAGIC))
    out.append(struct.pack("<i", 0))  # dense storage
    out.append(struct.pack("<I", a.ndim))
    out.append(struct.pack(f"<{a.ndim}q", *a.shape))
    out.append(struct.pack("<ii", 1, 0))  # cpu(0) context
    out.append(struct.pack("<i", flag))
    out.append(a.astype(a.dtype.newbyteorder("<"), copy=False).tobytes())


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if n < 0:
            raise MXNetError(
                f"negative read of {n} bytes at {self.pos}; "
                f"corrupt stream?")
        if self.pos + n > len(self.data):
            raise MXNetError(
                f"truncated .params stream at byte {self.pos} "
                f"(wanted {n} more of {len(self.data)})")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]


def _read_arr(r: _Reader, v2_dims64: bool = True) -> np.ndarray:
    magic = r.u32()
    if magic not in (V2_MAGIC, V3_MAGIC):
        raise MXNetError(
            f"bad NDArray magic 0x{magic:08x} (pre-V2 legacy streams "
            f"are not supported; re-save with a 1.x reference build)")
    stype = r.i32()
    if stype != 0:
        raise MXNetError(
            f"sparse storage type {stype} in .params; the TPU port "
            f"stores sparse densely — convert with tostype('default') "
            f"before saving")
    ndim = r.u32()
    if ndim > 32:
        raise MXNetError(f"implausible ndim {ndim}; corrupt stream?")
    if magic == V2_MAGIC and not v2_dims64:
        # pre-2026-07-30 mxtpu builds wrote V2 dims as uint32 (a bug —
        # the reference's dim_t is int64); this branch re-reads those
        # self-written files when the int64 whole-stream parse failed
        shape = struct.unpack(f"<{ndim}I", r.take(4 * ndim))
    else:
        shape = struct.unpack(f"<{ndim}q", r.take(8 * ndim))
        if any(d < 0 for d in shape):
            raise MXNetError(
                f"negative dim in shape {shape}; corrupt stream?")
    r.i32()  # dev_type — arrays always land on the current device
    r.i32()  # dev_id
    flag = r.i32()
    np_dtype = _TYPE_FLAG_TO_NP.get(flag)
    if np_dtype is None:
        raise MXNetError(f"unknown type_flag {flag} in .params")
    size = math.prod(shape)
    dt = np.dtype(np_dtype).newbyteorder("<")
    nbytes = size * dt.itemsize
    if r.pos + nbytes > len(r.data):
        raise MXNetError(
            f"truncated .params stream at byte {r.pos} "
            f"(wanted {nbytes} more of {len(r.data)})")
    # zero-copy view into the blob (converted only on big-endian hosts)
    arr = np.frombuffer(r.data, dtype=dt, count=size, offset=r.pos)
    r.pos += nbytes
    if arr.dtype != np.dtype(np_dtype):
        arr = arr.astype(np_dtype)
    return arr.reshape(shape)


def dumps(payload: Union[Dict[str, np.ndarray],
                         Sequence[np.ndarray]]) -> bytes:
    """Serialize named (dict) or anonymous (list) arrays to the
    reference binary layout."""
    if isinstance(payload, dict):
        names = list(payload.keys())
        arrays = [payload[n] for n in names]
    else:
        names = []
        arrays = list(payload)
    out: List[bytes] = [struct.pack("<QQ", LIST_MAGIC, 0),
                        struct.pack("<Q", len(arrays))]
    for a in arrays:
        _write_arr(out, np.asarray(a))
    out.append(struct.pack("<Q", len(names)))
    for n in names:
        nb = n.encode("utf-8")
        out.append(struct.pack("<Q", len(nb)))
        out.append(nb)
    return b"".join(out)


def _loads_impl(data: bytes,
                v2_dims64: bool) -> Tuple[List[np.ndarray], List[str]]:
    r = _Reader(data)
    magic = r.u64()
    if magic != LIST_MAGIC:
        raise MXNetError(
            f"not a reference .params stream (list magic "
            f"0x{magic:016x} != 0x{LIST_MAGIC:x})")
    r.u64()  # reserved
    n = r.u64()
    if n > 10 ** 7:
        raise MXNetError(f"implausible array count {n}; corrupt file?")
    arrays = [_read_arr(r, v2_dims64) for _ in range(n)]
    n_names = r.u64()
    if n_names not in (0, n):
        raise MXNetError(
            f"name count {n_names} does not match array count {n}")
    names = []
    for _ in range(n_names):
        ln = r.u64()
        try:
            names.append(r.take(ln).decode("utf-8"))
        except UnicodeDecodeError as e:
            raise MXNetError(f"undecodable name in .params: {e}") \
                from None
    if r.pos != len(data):
        raise MXNetError(
            f"{len(data) - r.pos} trailing bytes after .params "
            f"payload; corrupt stream?")
    return arrays, names


def loads(data: bytes) -> Tuple[List[np.ndarray], List[str]]:
    """Parse a reference binary stream → (arrays, names); names is
    empty for anonymous list saves.

    Tries the correct layout first (V2/V3 dims as int64 — the
    reference's dim_t).  If the WHOLE stream fails to parse that way,
    retries with uint32 V2 dims, the layout mxtpu builds before
    2026-07-30 wrote, and warns.  Whole-stream validation (record
    tails, payload sizes, name section, exact end-of-stream) makes the
    two layouts unambiguous in practice."""
    try:
        return _loads_impl(data, v2_dims64=True)
    except MXNetError as e:
        try:
            out = _loads_impl(data, v2_dims64=False)
        except MXNetError:
            raise e from None
        warnings.warn(
            "loading a .params stream with uint32 V2 dims (written by "
            "a pre-fix mxtpu build); re-save it to get the "
            "reference-compatible int64 layout", stacklevel=2)
        return out


def is_legacy(head: bytes) -> bool:
    """True if the first 8 bytes carry the reference list magic."""
    return len(head) >= 8 and \
        struct.unpack("<Q", head[:8])[0] == LIST_MAGIC
