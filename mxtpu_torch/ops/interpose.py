"""The interposition point of the AMP and int8 passes (the counterpart
of ``mxtpu/ndarray/__init__.py:79-91``).

mxtpu interposes at one place, its eager/symbolic dispatch.  The port
dispatches at two: ``ndarray._invoke_resolved`` (eager ``nd`` and the
graph plan that serving and the executor run) and the rule closures of
``gluon.block.F`` (every HybridBlock's eager forward, so every
``TrainStep`` on BERT or ResNet-50).  Both ask :func:`wrap_op` only
while a scope is open (:data:`SCOPES`\\ ``.open``), so off the scopes
the cost is one attribute read, as mxtpu's off path is.

The scope state is per thread: the port runs its graphs eagerly, and a
server's worker threads each run a plan at once (mxtpu only traces
under a scope, behind its compile lock).  Quantization goes first, so
an op it rewrites to int8 is never cast to bf16 as well.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional, Sequence

__all__ = ["SCOPES", "wrap_op"]


class _Scopes(threading.local):
    open = False        # an autocast or a quant scope is open here
    amp = False         # an autocast scope is open
    quant = None        # "calib" | "quant" while a quant scope is open
    collector = None    # the live collector (calib)
    scales = None       # {key: activation |x| threshold} (quant)
    counter = 0         # candidate ops seen since the quant scope opened

    def refresh(self) -> None:
        self.open = self.amp or self.quant is not None


SCOPES = _Scopes()


def wrap_op(name: str, op, tensors: Sequence[Any],
            resolved: Dict[str, Any]) -> Optional[Callable]:
    """The replacement for ``op.fn`` that an open scope asks for (the
    int8 form, or the bf16 cast of a contraction's inputs), or None to
    run the op as it is.  Called only while ``SCOPES.open``."""
    from .. import amp, quant
    fn = quant.wrap_op(name, op, tensors, resolved) \
        if SCOPES.quant is not None else None
    if fn is None and SCOPES.amp:
        fn = amp.wrap_op(name, op, tensors, resolved)
    return fn
