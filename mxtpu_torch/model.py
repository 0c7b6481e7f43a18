"""Checkpoints in the reference's convention (the counterpart of
``mxtpu/model.py:16-40``): ``prefix-symbol.json`` plus
``prefix-NNNN.params`` with ``arg:``/``aux:`` name prefixes.  The files
are what mxtpu writes and reads, so checkpoints cross between the two
packages both ways.  ``FeedForward`` waits.
"""
from __future__ import annotations

from typing import Dict

from . import ndarray as nd_mod

__all__ = ["save_checkpoint", "load_checkpoint"]


def save_checkpoint(prefix: str, epoch: int, symbol, arg_params: Dict,
                    aux_params: Dict) -> None:
    """Write ``prefix-symbol.json`` (when ``symbol`` is given) and
    ``prefix-{epoch:04d}.params``."""
    if symbol is not None:
        symbol.save(f"{prefix}-symbol.json")
    arrays = {f"arg:{k}": v for k, v in arg_params.items()}
    arrays.update({f"aux:{k}": v for k, v in aux_params.items()})
    nd_mod.save(f"{prefix}-{epoch:04d}.params", arrays)


def load_checkpoint(prefix: str, epoch: int, ctx=None):
    """``(symbol, arg_params, aux_params)``, the arrays on ``ctx``
    (default the card)."""
    from . import symbol as sym_mod
    symbol = sym_mod.load(f"{prefix}-symbol.json")
    loaded = nd_mod.load(f"{prefix}-{epoch:04d}.params", ctx=ctx)
    arg_params, aux_params = {}, {}
    for k, v in loaded.items():
        tag, name = k.split(":", 1)
        if tag == "arg":
            arg_params[name] = v
        elif tag == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params
