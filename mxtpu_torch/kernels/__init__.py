"""Hand-written Hopper kernels and their plain PyTorch versions.

Dispatch goes by tensor device, never by a knob: tensors on the CPU
take the plain PyTorch version, tensors on a CUDA device launch the
kernel, or the call raises (no fallback).  Each wrapper counts its
launches in a plain integer beside it (``LAUNCHES`` and the like of its
module); :func:`launch_counts` reads them all and
:func:`reset_launch_counts` sets them to 0.  A CUDA graph's capture
launches nothing on the card: while a thread records
(:func:`recording`), its wrappers' counts go to the record instead, and
each replay of the graph adds the record (:func:`add_launches`).

The public functions (``flash_attention``, ``layer_norm``,
``fused_residual_layer_norm``, ``fused_bn_act``) run through
``torch.autograd.Function``s whose backward is the backward kernel.
``conv_nhwc`` has no backward (nor has the TPU kernel it ports) and
refuses inputs that require grad on every device.  ``nms.nms_keep``
(the detection ops' greedy suppression, which ports no TPU kernel)
returns a bool mask and has no gradient.  ``rnn_cell.lstm_cell`` and
``rnn_cell.gru_cell`` (the fused RNN op's step, which ports no TPU
kernel either) run through autograd Functions whose backward is the
backward kernel; ``rnn_scan.lstm_scan`` and ``rnn_scan.gru_scan`` (the
op's whole recurrence of a layer and direction, one persistent launch
forward and one backward) likewise.  ``moe.route_tokens``,
``moe.dispatch_tokens`` and ``moe.combine_tokens`` (Switch-MoE routing,
which ports no TPU kernel: mxtpu routes with dense one-hot einsums) run
through autograd Functions whose dispatch and combine backwards are
kernels and whose router backward is torch ops.
The raw wrappers (``flash_forward``, ``layer_norm_fwd``,
``fused_residual_ln_fwd``, ``bn_fwd``, ``bn_bwd`` and the like) keep
no graph, so on the card they refuse inputs that require grad
(:func:`refuse_grad`) rather than cut autograd silently.
"""
from __future__ import annotations

import contextlib
import functools
import importlib
import threading
from typing import Dict, Iterator, Tuple

import torch

from ..base import MXNetError

__all__ = ["on_card", "refuse_grad", "bump", "launch_counts",
           "reset_launch_counts", "recording", "add_launches", "aligned16", "sm_count",
           "flash_attention", "layer_norm", "fused_residual_layer_norm",
           "fused_bn_act", "conv_nhwc"]

_count_lock = threading.Lock()
_recorder = threading.local()


def on_card(*tensors: torch.Tensor) -> bool:
    """False when every tensor lies on the CPU, True when every one
    lies on one CUDA device; anything else raises."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise MXNetError(
            f"kernel inputs on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise MXNetError(f"kernel inputs on unsupported device {dev}")


def refuse_grad(what: str, *tensors: torch.Tensor,
                hint: str = "call the public function, whose autograd "
                            "Function runs the backward kernel") -> None:
    """Raise when grad is on and an input of a raw forward wrapper
    requires it: the launch records no graph, so its result would cut
    autograd.  Inside an autograd Function's forward grad is off, so
    the public functions pass."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise MXNetError(f"{what}: inputs require grad; {hint}")


def aligned16(*tensors: torch.Tensor) -> bool:
    """True when every tensor's data starts on a 16-byte boundary: a
    kernel may then read and write it with 16-byte vector accesses."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (a persistent grid's
    size)."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


def bump(module, attr: str = "LAUNCHES") -> None:
    """Add one to the launch counter ``module.<attr>`` (server worker
    threads launch concurrently, so the read-modify-write takes a
    lock), or to this thread's record while it records."""
    record = getattr(_recorder, "record", None)
    if record is not None:
        record[(module, attr)] = record.get((module, attr), 0) + 1
        return
    with _count_lock:
        setattr(module, attr, getattr(module, attr) + 1)


@contextlib.contextmanager
def recording() -> Iterator[Dict[Tuple[object, str], int]]:
    """Inside it, this thread's launches are counted in the yielded
    record, ``{(module, counter name): launches}``, and not in the
    counts: a CUDA graph's capture (and the eager warm-up before it)
    runs under one, and each replay adds the capture's record."""
    prev = getattr(_recorder, "record", None)
    record: Dict[Tuple[object, str], int] = {}
    _recorder.record = record
    try:
        yield record
    finally:
        _recorder.record = prev


def add_launches(record: Dict[Tuple[object, str], int]) -> None:
    """Add a :func:`recording`'s launches to the counts (a replay of
    the graph it captured launched each of them once)."""
    with _count_lock:
        for (module, attr), n in record.items():
            setattr(module, attr, getattr(module, attr) + n)


def _modules():
    # by module path: the package re-exports functions of the same names
    fa = importlib.import_module(__name__ + ".flash_attention")
    ln = importlib.import_module(__name__ + ".layer_norm")
    bn = importlib.import_module(__name__ + ".batch_norm")
    conv = importlib.import_module(__name__ + ".conv")
    nms = importlib.import_module(__name__ + ".nms")
    rnn = importlib.import_module(__name__ + ".rnn_cell")
    scan = importlib.import_module(__name__ + ".rnn_scan")
    moe = importlib.import_module(__name__ + ".moe")
    return {"flash_attention_fwd": (fa, "LAUNCHES"),
            "flash_attention_bwd_dq": (fa, "DQ_LAUNCHES"),
            "flash_attention_bwd_dkv": (fa, "DKV_LAUNCHES"),
            "layer_norm_fwd": (ln, "LAUNCHES"),
            "layer_norm_bwd": (ln, "BWD_LAUNCHES"),
            "fused_residual_ln_fwd": (ln, "FRLN_LAUNCHES"),
            "fused_residual_ln_bwd": (ln, "FRLN_BWD_LAUNCHES"),
            "batch_norm_fwd": (bn, "FWD_LAUNCHES"),
            "batch_norm_bwd": (bn, "BWD_LAUNCHES"),
            "batch_norm_fwd_cm": (bn, "FWD_CM_LAUNCHES"),
            "batch_norm_bwd_cm": (bn, "BWD_CM_LAUNCHES"),
            "conv_nhwc": (conv, "CONV_LAUNCHES"),
            "nms": (nms, "LAUNCHES"),
            "lstm_cell_fwd": (rnn, "LSTM_FWD_LAUNCHES"),
            "lstm_cell_bwd": (rnn, "LSTM_BWD_LAUNCHES"),
            "gru_cell_fwd": (rnn, "GRU_FWD_LAUNCHES"),
            "gru_cell_bwd": (rnn, "GRU_BWD_LAUNCHES"),
            "lstm_scan_fwd": (scan, "LSTM_SCAN_FWD_LAUNCHES"),
            "lstm_scan_bwd": (scan, "LSTM_SCAN_BWD_LAUNCHES"),
            "gru_scan_fwd": (scan, "GRU_SCAN_FWD_LAUNCHES"),
            "gru_scan_bwd": (scan, "GRU_SCAN_BWD_LAUNCHES"),
            "moe_route": (moe, "ROUTE_LAUNCHES"),
            "moe_dispatch": (moe, "DISPATCH_LAUNCHES"),
            "moe_dispatch_bwd": (moe, "DISPATCH_BWD_LAUNCHES"),
            "moe_combine": (moe, "COMBINE_LAUNCHES"),
            "moe_combine_bwd": (moe, "COMBINE_BWD_LAUNCHES")}


def launch_counts() -> Dict[str, int]:
    with _count_lock:
        return {k: getattr(m, a) for k, (m, a) in _modules().items()}


def reset_launch_counts() -> None:
    with _count_lock:
        for m, a in _modules().values():
            setattr(m, a, 0)


from .flash_attention import flash_attention  # noqa: E402
from .layer_norm import layer_norm, fused_residual_layer_norm  # noqa: E402
from .batch_norm import fused_bn_act  # noqa: E402
from .conv import conv_nhwc  # noqa: E402
