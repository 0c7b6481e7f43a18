"""Typed op-parameter descriptors (a copy of ``mxtpu/ops/params.py``).

Equivalent of ``dmlc::Parameter`` (``3rdparty/dmlc-core/
include/dmlc/parameter.h``†): declarative, typed, range-checked kwargs that
form the public op API surface, (de)serializable to strings so symbol JSON
round-trips the way the reference's ``Symbol.tojson`` does (attrs are
string-valued in nnvm JSON).
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

from ..base import MXNetError

__all__ = ["Param", "ParamSet"]

_MISSING = object()


@dataclass
class Param:
    name: str
    dtype: type = float            # python type: int, float, bool, str, tuple
    default: Any = _MISSING        # _MISSING => required
    lower: Optional[float] = None
    upper: Optional[float] = None
    enum: Optional[Sequence[Any]] = None
    doc: str = ""

    @property
    def required(self) -> bool:
        return self.default is _MISSING

    def validate(self, value: Any) -> Any:
        value = self._coerce(value)
        if self.lower is not None and value < self.lower:
            raise MXNetError(
                f"param {self.name}={value} below lower bound {self.lower}")
        if self.upper is not None and value > self.upper:
            raise MXNetError(
                f"param {self.name}={value} above upper bound {self.upper}")
        if self.enum is not None and value not in self.enum:
            raise MXNetError(
                f"param {self.name}={value!r} not in {tuple(self.enum)}")
        return value

    def _coerce(self, value: Any) -> Any:
        if value is None:
            return None
        if self.dtype is tuple:
            if isinstance(value, (list, tuple)):
                return tuple(value)
            if isinstance(value, str):
                parsed = ast.literal_eval(value)
                return tuple(parsed) if isinstance(parsed, (list, tuple)) \
                    else (parsed,)
            return (value,)
        if self.dtype is bool and isinstance(value, str):
            return value.strip().lower() in ("1", "true", "yes", "on")
        if isinstance(value, str) and self.dtype is not str:
            return self.dtype(ast.literal_eval(value))
        return self.dtype(value)

    def serialize(self, value: Any) -> str:
        return str(value)


class ParamSet:
    """Ordered collection of Param descriptors attached to an op."""

    def __init__(self, *params: Param):
        self.params: Dict[str, Param] = {p.name: p for p in params}

    def resolve(self, kwargs: Dict[str, Any]) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for name, p in self.params.items():
            if name in kwargs:
                out[name] = p.validate(kwargs[name])
            elif p.required:
                raise MXNetError(f"required param '{name}' missing")
            else:
                out[name] = p.default
        unknown = set(kwargs) - set(self.params)
        if unknown:
            raise MXNetError(
                f"unknown params {sorted(unknown)}; "
                f"accepted: {sorted(self.params)}")
        return out

    def serialize(self, resolved: Dict[str, Any]) -> Dict[str, str]:
        return {k: self.params[k].serialize(v) for k, v in resolved.items()
                if k in self.params}

    def __iter__(self):
        return iter(self.params.values())

    def __len__(self):
        return len(self.params)
