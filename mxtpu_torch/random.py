"""``mx.random`` for the port: global seeding and the explicit
generators the training-mode layers draw from (the role of
``mxtpu/ndarray/random.py:seed`` and ``_next_key``).

Each device has its own pair of generators, made on first use from the
global seed: a ``torch.Generator`` on the device for dropout masks, and
one on the host for :func:`key_words`, the two uint32 threefry words the
fused residual-LayerNorm epilogue takes per call.  Drawing the words on
the host means launching the epilogue never waits for the card.  The
JAX package's streams (``jax.random``) give other numbers from the same
seed; what carries over is the rule: equal seeds, equal draws.
:func:`get_state` and :func:`set_state` save and restore both of a
device's streams (a rematerialized block's replay draws what its first
run drew).
"""
from __future__ import annotations

import threading
from typing import Dict, Tuple

import torch

__all__ = ["seed", "generator", "key_words", "get_state", "set_state"]

_LOCK = threading.Lock()
_DEFAULT_SEED = 0
# device name -> (device generator, host generator for key words)
_GENS: Dict[str, Tuple[torch.Generator, torch.Generator]] = {}  # guarded-by: _LOCK


def _name(device) -> str:
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def seed(seed_state: int, ctx="all") -> None:
    """Reseed the streams of every device (``ctx="all"``) or of one
    device (``ctx`` a device or its name)."""
    global _DEFAULT_SEED
    with _LOCK:
        if ctx == "all":
            _DEFAULT_SEED = int(seed_state)
            _GENS.clear()
        else:
            _GENS[_name(ctx)] = _make(_name(ctx), int(seed_state))


def _make(name: str, s: int) -> Tuple[torch.Generator, torch.Generator]:
    dev = torch.Generator(device=name).manual_seed(s)
    # the host stream is offset from the device stream's seed, so the
    # CPU device's two generators do not repeat each other's draws
    host = torch.Generator().manual_seed(s ^ 0x5EED0F4E15)
    return dev, host


def _pair(device) -> Tuple[torch.Generator, torch.Generator]:
    name = _name(device)
    with _LOCK:
        pair = _GENS.get(name)
        if pair is None:
            pair = _GENS[name] = _make(name, _DEFAULT_SEED)
        return pair


def generator(device=None) -> torch.Generator:
    """The generator on ``device`` (default the CPU) that dropout masks
    are drawn from."""
    return _pair(device)[0]


def key_words(device=None) -> Tuple[int, int]:
    """Two fresh uint32 threefry key words for one fused-epilogue call
    on ``device``, drawn from that device's host stream."""
    host = _pair(device)[1]
    with _LOCK:
        w = torch.randint(0, 1 << 32, (2,), dtype=torch.int64,
                          generator=host)
    k0, k1 = w.tolist()
    return int(k0), int(k1)


def get_state(device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The state of ``device``'s two streams, for :func:`set_state`."""
    dev, host = _pair(device)
    with _LOCK:
        return dev.get_state(), host.get_state()


def set_state(state: Tuple[torch.Tensor, torch.Tensor],
              device=None) -> None:
    """Put ``device``'s two streams back to a :func:`get_state`."""
    dev, host = _pair(device)
    with _LOCK:
        dev.set_state(state[0])
        host.set_state(state[1])
