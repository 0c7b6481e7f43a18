"""One bucket's compiled entry, shared by ``ModelRunner`` and
``GenerateRunner`` (the counterpart of the ``jax.jit(...).lower(...)
.compile()`` executable each of mxtpu's runners builds once per
bucket).

On the CPU an entry is the graph plan run eagerly.  On the card it is
one ``torch.cuda.CUDAGraph``: the plan run once more under capture, in
inference mode, over static input buffers, the runner's weights (one
upload, read by every bucket) and any tensor the runner binds (the KV
table), writing static output buffers.  Before the capture the plan
runs eagerly on a side stream, as PyTorch's graph documentation asks:
that first run builds the kernels, sets their shared-memory
attributes and settles the allocator, none of which may happen while
capturing.

The warm-up runs on zeroed stand-ins of the bound tensors, so building
an entry never writes a table in use.

A runner's captures share one memory pool (:class:`GraphPool`), so the
ladder's intermediates overlap instead of each bucket keeping its own.
That is safe because every replay holds the pool's lock: replays of one
runner never overlap, and the static outputs, which stay allocated,
are never reused by another capture.  A replay overwrites the static
outputs, so the caller copies what it keeps on the card under the same
lock, and crosses to the host after releasing it.  An uncaptured entry
writes no shared buffer and takes no lock.

There is no eager fallback on the card: a capture that fails raises
with the graph node it failed in.  A replay launches no wrapper, so
the kernels' launch counts come from the capture's record
(``kernels.recording``), added once a replay.

What the persistent cache keeps of an entry is its :meth:`Entry.recipe`:
the static input and output shapes and types, the launch record and
the kernel entries' keys.  A captured graph has no serialized form, so
a disk hit still runs the warm-up and the capture; :func:`recipe_mismatch`
then holds the new entry against the stored recipe.  An uncaptured
entry built with ``probe`` runs once on its example inputs (and zeroed
stand-ins of the bound tensors) to learn what a recipe records.
"""
from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..base import MXNetError
from .. import guards
from .. import kernels

__all__ = ["Entry", "GraphPool", "tensor_key", "recipe_mismatch"]

# eager runs on the side stream before a capture
WARMUP_ITERS = 2

# the lock of an uncaptured entry: its outputs are new tensors each run
_NO_LOCK = contextlib.nullcontext()


def tensor_key(t: torch.Tensor) -> Tuple:
    """What a captured graph knows of a tensor it was bound to: where
    its memory starts and how it is laid out."""
    return (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype, t.device)


def _sigs(tensors: Sequence[torch.Tensor]) -> List[List]:
    return [[list(t.shape), str(t.dtype).replace("torch.", "")]
            for t in tensors]


def _named(record: Dict[Tuple[object, str], int]) -> Dict[str, int]:
    """A launch record by kernel name (``kernels.launch_counts``'s)."""
    names = {v: k for k, v in kernels._modules().items()}
    return {names[k]: n for k, n in sorted(
        record.items(), key=lambda kv: names.get(kv[0], ""))
        if k in names and n}


def recipe_mismatch(recipe: Dict, entry: "Entry") -> str:
    """Why ``entry`` (built on a disk hit) is not what ``recipe`` (the
    cold build's) describes — "" when it is: the same static inputs
    and outputs, the same launches by kernel, and the kernel libraries
    both name from the same kernel entries."""
    mine = entry.recipe()
    for part in ("inputs", "outputs", "launches"):
        if recipe.get(part) != mine[part]:
            return (f"{entry.label}: {part} {mine[part]} != the "
                    f"recipe's {recipe.get(part)}")
    theirs = recipe.get("kernels", {})
    for name, digest in mine["kernels"].items():
        if name in theirs and theirs[name] != digest:
            return (f"{entry.label}: kernel {name} from entry "
                    f"{digest[:12]}, the recipe's from "
                    f"{theirs[name][:12]}")
    return ""


class GraphPool:
    """What one runner's entries share: the capture memory pool (on the
    card) and the lock every run holds."""

    def __init__(self, device: torch.device):
        self.device = device
        self.lock = threading.Lock()
        self.handle = torch.cuda.graph_pool_handle() \
            if device.type == "cuda" else None


def _failing_node(err: BaseException) -> str:
    """The graph node named in the notes of ``err`` or of an exception
    it was raised from or during (the plan notes the node it was
    running)."""
    seen = set()
    while err is not None and id(err) not in seen:
        seen.add(id(err))
        for note in getattr(err, "__notes__", ()):
            if note.startswith("graph node"):
                return note
        err = err.__cause__ or err.__context__
    return "no graph node (outside the plan)"


_GC_LOCK = threading.Lock()
# captures running with the collector off, and its state before them
_GC_HOLDS = 0   # guarded-by: _GC_LOCK
_GC_WAS_ON = False   # guarded-by: _GC_LOCK


@contextlib.contextmanager
def _no_collection():
    """The cyclic garbage collector off while any thread captures: a
    collection inside a capture that frees another entry's graph
    destroys it (``cudaGraphExecDestroy``) on the capturing thread, a
    call the capture forbids, and the capture is invalidated.  Counted,
    so that concurrent captures turn it back on only when the last one
    ends, as it was before the first."""
    global _GC_HOLDS, _GC_WAS_ON
    with _GC_LOCK:
        if _GC_HOLDS == 0:
            _GC_WAS_ON = gc.isenabled()
            gc.disable()
        _GC_HOLDS += 1
    try:
        yield
    finally:
        with _GC_LOCK:
            _GC_HOLDS -= 1
            if _GC_HOLDS == 0 and _GC_WAS_ON:
                gc.enable()


class Entry:
    """``fn(*inputs, *bound)`` for one bucket's shapes.

    ``inputs`` are example tensors of the bucket's input shapes and
    types (their values feed the warm-up run); a captured entry copies
    each call's inputs into static buffers of that layout.  ``bound``
    tensors are read and written where they lie (the KV table): a
    captured entry only runs on the same tensors (:attr:`bound_key`).
    ``capture`` False gives the eager plan on the card (what
    ``chip_smoke.py`` holds the graph against).  ``probe`` runs an
    uncaptured entry once, so that its :meth:`recipe` has outputs and
    launches (a captured entry always has them)."""

    def __init__(self, fn: Callable[..., Tuple[torch.Tensor, ...]],
                 inputs: Sequence[torch.Tensor], pool: GraphPool,
                 bound: Sequence[torch.Tensor] = (), label: str = "",
                 capture: bool = True, guard: bool = False,
                 probe: bool = False):
        self._fn = fn
        self._device = pool.device
        self.lock = _NO_LOCK
        self.label = label
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Dict[Tuple[object, str], int] = {}
        self.capture_seconds = 0.0
        self.bound_key = tuple(tensor_key(t) for t in bound)
        self._in_sigs = _sigs(inputs)
        self._out_sigs: Optional[List[List]] = None
        if pool.device.type != "cuda" or not capture:
            if probe:
                stand_ins = tuple(torch.zeros_like(t) for t in bound)
                with kernels.recording() as record:
                    self._out_sigs = _sigs(fn(*inputs, *stand_ins))
                self.launches = record
            return
        self.lock = pool.lock
        self._guard = guard
        self._static_in = tuple(t.clone() for t in inputs)
        device = pool.device
        t0 = time.perf_counter()
        # the warm-up writes zeroed stand-ins, never the bound tensors
        # (a live KV table keeps its lanes)
        stand_ins = tuple(torch.zeros_like(t) for t in bound)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with kernels.recording(), torch.cuda.stream(side), \
                guards.no_implicit_transfers(guard, device):
            for _ in range(WARMUP_ITERS):
                fn(*self._static_in, *stand_ins)
        torch.cuda.current_stream(device).wait_stream(side)
        del stand_ins
        graph = torch.cuda.CUDAGraph()
        try:
            with kernels.recording() as record, _no_collection():
                with torch.cuda.graph(graph, pool=pool.handle,
                                      capture_error_mode="thread_local"):
                    with guards.no_implicit_transfers(guard, device):
                        outs = fn(*self._static_in, *bound)
        except Exception as e:  # noqa: BLE001 — re-raised, named
            raise MXNetError(
                f"capture of {label} failed in {_failing_node(e)}: "
                f"{type(e).__name__}: {e}") from e
        self.capture_seconds = time.perf_counter() - t0
        self.graph = graph
        self.launches = record
        self._static_out = tuple(outs)
        self._out_sigs = _sigs(self._static_out)

    def recipe(self) -> Dict:
        """What the persistent cache stores of this entry: the static
        inputs' and outputs' shapes and types, the launches of its
        capture (or probe) by kernel name, and the kernel entries the
        process's libraries came from."""
        from ..kernels import _build
        return {"inputs": self._in_sigs, "outputs": self._out_sigs,
                "launches": _named(self.launches),
                "kernels": _build.kernel_entries()}

    def run(self, inputs: Sequence[torch.Tensor],
            bound: Sequence[torch.Tensor] = ()) -> Tuple[torch.Tensor, ...]:
        """One run on ``inputs`` (and ``bound``, the tensors captured
        on).  The caller holds :attr:`lock` until it has copied what it
        keeps of the result: a captured entry returns its static
        outputs, which the next replay overwrites; an uncaptured one
        returns new tensors."""
        if self.graph is None:
            return tuple(self._fn(*inputs, *bound))
        if tuple(tensor_key(t) for t in bound) != self.bound_key:
            raise MXNetError(
                f"{self.label}: a replay runs only on the tensors it was "
                f"captured on")
        with guards.no_implicit_transfers(self._guard, self._device):
            for static, v in zip(self._static_in, inputs):
                static.copy_(v)
            self.graph.replay()
        kernels.add_launches(self.launches)
        return self._static_out
