"""Checkpoint loading: ``.params`` files written by ``mxtpu`` (or the
reference) into name → numpy arrays, in file order.

``loads`` follows ``mxtpu/ndarray/ndarray.py:555-574`` (legacy dmlc
stream, MXTPU01 npz or bare npz, detected by magic); ``load_params``
adds the ``arg:``/``aux:`` prefix stripping of
``mxtpu/c_predict.py:32-46``.
"""
from __future__ import annotations

import io
from typing import Dict

import numpy as np

from ..base import MXNetError
from . import legacy_format

__all__ = ["loads", "load_params", "legacy_format"]

_SAVE_MAGIC = b"MXTPU01\n"


def loads(blob: bytes):
    """Parse a checkpoint payload: a dict name → array for named
    saves, a list for anonymous ones."""
    if legacy_format.is_legacy(blob[:8]):
        arrays, names = legacy_format.loads(blob)
        if names:
            return dict(zip(names, arrays))
        return list(arrays)
    buf = io.BytesIO(blob)
    if blob[:len(_SAVE_MAGIC)] == _SAVE_MAGIC:
        buf.seek(len(_SAVE_MAGIC))
    npz = np.load(buf, allow_pickle=False)
    keys = list(npz.keys())
    if all(k.isdigit() for k in keys):
        return [npz[k] for k in sorted(keys, key=int)]
    return {k: npz[k] for k in keys}


def load_params(path: str) -> Dict[str, np.ndarray]:
    """Read a ``.params`` file into name → numpy array with the
    ``arg:``/``aux:`` prefixes stripped, keeping file order."""
    with open(path, "rb") as f:
        loaded = loads(f.read())
    if not isinstance(loaded, dict):
        raise MXNetError(
            f"{path}: anonymous .params blob has no names to bind by")
    out = {}
    for name, arr in loaded.items():
        key = name.split(":", 1)[1] \
            if name.startswith(("arg:", "aux:")) else name
        out[key] = np.asarray(arr)
    return out
