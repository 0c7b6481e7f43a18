"""Switch-MoE feed-forward (the counterpart of ``mxtpu/parallel/moe.py``):
top-1 (Switch) routing with Mesh-TensorFlow's capacity, one FFN an
expert, tokens over capacity dropped (their output is 0, the residual
path carries them), and the Switch load-balancing loss.

* :func:`switch_router` returns mxtpu's dense ``(dispatch, combine,
  aux)``, (T, E, C) f32.
* :func:`moe_ffn` returns ``(y, aux)``.  On CPU tensors it is mxtpu's
  dense one-hot form line for line (:func:`ffn_dense`): ``td,tec->ecd``
  to dispatch and ``ecd,tec->td`` to combine, in f32.  On CUDA tensors it
  runs the route, dispatch and combine kernels of
  :mod:`mxtpu_torch.kernels.moe` (:func:`ffn_kernels`) and never builds a
  (T, E, C) tensor: the einsums compute a permutation, 172 GFLOP of f32
  an einsum at bench.py's shape, and the gathers give the same bits on
  finite inputs.  The router's logits (``x @ gate_w`` in f32) and the
  expert GEMMs are torch products, as mxtpu leaves them to XLA.
* :class:`MoEFFN` — the parameter container and ``apply``.  Its seeded
  init draws from a ``torch.Generator``, so a seed gives other weights
  than mxtpu's; :func:`mxtpu_torch.convert.moe_params_from_numpy` carries
  mxtpu's arrays across.

The jitter noise (``jitter`` with a ``key``, mxtpu's two uint32 key
words) is ``jax.random.uniform(key, (T, E), -jitter, jitter)``'s: jax's
default partitionable threefry2x32 over the flattened index, the two
output words xor-ed, the top 23 bits as the mantissa of a float in
[1, 2), scaled with one rounding as XLA's fused multiply-add does.

Expert parallelism (``mesh``) is refused: the port trains on one device.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..context import resolve_device
from ..kernels import moe as kmoe
from ..kernels import on_card
from ..kernels.layer_norm import _M32, _key_words, _threefry2x32

__all__ = ["moe_ffn", "switch_router", "MoEFFN", "capacity_of",
           "jitter_noise", "ffn_dense", "ffn_kernels"]


def capacity_of(tokens: int, experts: int, capacity_factor: float) -> int:
    """Slots an expert: ``max(ceil(T / E * cf), 1)``."""
    return max(int(math.ceil(tokens / experts * capacity_factor)), 1)


def jitter_noise(key, shape: Tuple[int, int], jitter: float,
                 device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=-jitter, maxval=jitter)``
    in f32, from the key's two uint32 words."""
    k0, k1 = _key_words(key)
    n = int(np.prod(shape))
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = _threefry2x32(k0, k1, (idx >> 32) & _M32, idx & _M32)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    # floats * (hi - lo) + lo rounded once, as XLA's fused multiply-add
    # gives it: floats is a multiple of 2^-23 in [0, 1), so the product
    # and the sum are exact in f64 and the cast is the one rounding
    lo, hi = np.float32(-jitter), np.float32(jitter)
    fused = (floats.double() * float(hi - lo) + float(lo)).float()
    lo_t = torch.tensor(lo, dtype=torch.float32, device=device)
    return torch.maximum(lo_t, fused).reshape(shape)


def _logits(x2d, gate_w, key, jitter):
    logits = x2d.float() @ gate_w.float()
    if jitter > 0.0 and key is not None:
        logits = logits + jitter_noise(key, tuple(logits.shape), jitter,
                                       logits.device)
    return logits


def _dense_route(logits, capacity):
    """mxtpu's ``switch_router`` from the logits on, line for line
    (the softmax in :func:`kernels.moe.softmax_ordered`'s order)."""
    E = logits.shape[1]
    probs = kmoe.softmax_ordered(logits)
    expert = probs.argmax(-1)
    onehot = torch.nn.functional.one_hot(expert, E).float()
    pos = torch.cumsum(onehot, 0) * onehot - 1.0
    keep = (pos >= 0) & (pos < capacity)
    pos_c = pos.clamp(0, capacity - 1).long()
    slot = torch.nn.functional.one_hot(pos_c, capacity).float()
    dispatch = slot * keep.float()[..., None]
    gate_p = (probs * onehot).sum(-1)
    combine = dispatch * gate_p[:, None, None]
    frac = onehot.mean(0)
    mean_p = probs.mean(0)
    aux = E * (frac * mean_p).sum()
    return dispatch, combine, aux


def switch_router(x2d, gate_w, capacity: int, *, key=None,
                  jitter: float = 0.0):
    """Top-1 (Switch) routing: ``(dispatch, combine, aux)``.  x2d (T,
    D), gate_w (D, E); dispatch (T, E, C) one-hot f32, combine =
    dispatch * the gate probability, aux the load-balancing loss ``E *
    sum(frac * mean_p)``.  On CUDA tensors the route kernel assigns the
    slots and the dense tensors are scattered from its maps."""
    logits = _logits(x2d, gate_w, key, jitter)
    if not on_card(logits):
        return _dense_route(logits, capacity)
    T, E = logits.shape
    gate_p, mean_p, sot, _, frac = kmoe.route_tokens(logits, capacity)
    kept = sot >= 0
    dispatch = torch.zeros(T, E * capacity, dtype=torch.float32,
                           device=logits.device)
    dispatch[kept, sot[kept].long()] = 1.0
    dispatch = dispatch.reshape(T, E, capacity)
    combine = dispatch * gate_p[:, None, None]
    return dispatch, combine, E * (frac * mean_p).sum()


def _experts(expert_in, w1c, b1c, w2c, b2c, activation):
    """The per-expert FFN on (E, C, D) inputs, mxtpu's einsums."""
    h = torch.einsum("ecd,edh->ech", expert_in, w1c) + b1c[:, None, :]
    h = activation(h)
    return torch.einsum("ech,ehd->ecd", h, w2c) + b2c[:, None, :]


def ffn_dense(x2d, gate_w, w1, b1, w2, b2, capacity, activation,
              key=None, jitter=0.0):
    """mxtpu's dense form on any device: ``(y2d, aux)``."""
    cdt = x2d.dtype
    dispatch, combine, aux = _dense_route(_logits(x2d, gate_w, key, jitter),
                                          capacity)
    expert_in = torch.einsum("td,tec->ecd", x2d.float(),
                             dispatch).to(cdt)
    expert_out = _experts(expert_in, w1.to(cdt), b1.to(cdt), w2.to(cdt),
                          b2.to(cdt), activation)
    y = torch.einsum("ecd,tec->td", expert_out.float(), combine).to(cdt)
    return y, aux


def ffn_kernels(x2d, gate_w, w1, b1, w2, b2, capacity, activation,
                key=None, jitter=0.0):
    """The gathered form: route, dispatch and combine kernels (their
    plain versions on CPU tensors) around the same expert GEMMs."""
    cdt = x2d.dtype
    E, D = w1.shape[0], x2d.shape[1]
    gate_p, mean_p, sot, tos, frac = kmoe.route_tokens(
        _logits(x2d, gate_w, key, jitter), capacity)
    expert_in = kmoe.dispatch_tokens(x2d, tos, sot).reshape(E, capacity, D)
    expert_out = _experts(expert_in, w1.to(cdt), b1.to(cdt), w2.to(cdt),
                          b2.to(cdt), activation)
    y = kmoe.combine_tokens(expert_out.reshape(E * capacity, D), sot, tos,
                            gate_p)
    return y, E * (frac * mean_p).sum()


def moe_ffn(x, gate_w, w1, b1, w2, b2, *, capacity_factor: float = 1.25,
            mesh=None, ep_axis: str = "ep",
            activation: Callable = torch.relu, key=None,
            jitter: float = 0.0):
    """Switch-MoE feed-forward.  x (..., T, D) or (T, D); per-expert
    params w1 (E, D, H), b1 (E, H), w2 (E, H, D), b2 (E, D); gate_w (D,
    E).  Returns ``(y, aux)``, y in x's shape and type, aux f32."""
    if mesh is not None:
        from . import _refuse
        _refuse("a device mesh (expert parallelism)")
    orig_shape = x.shape
    D = orig_shape[-1]
    x2d = x.reshape(-1, D)
    T = x2d.shape[0]
    E = w1.shape[0]
    capacity = capacity_of(T, E, capacity_factor)
    if x.device.type == "meta":
        # shape inference: y has the data's shape, aux is a scalar
        return (torch.empty(orig_shape, dtype=x.dtype, device="meta"),
                torch.empty((), dtype=torch.float32, device="meta"))
    run = ffn_kernels if on_card(x2d, gate_w, w1, b1, w2, b2) else ffn_dense
    y, aux = run(x2d, gate_w, w1, b1, w2, b2, capacity, activation, key,
                 jitter)
    return y.reshape(orig_shape), aux


class MoEFFN:
    """Parameter container + apply for a Switch-MoE FFN (mxtpu's
    functional API).  The weights are drawn from a ``torch.Generator``
    seeded with ``seed`` on the CPU, then moved to ``device`` (default
    the card)."""

    def __init__(self, units: int, hidden: int, num_experts: int,
                 capacity_factor: float = 1.25, seed: int = 0,
                 device=None):
        dev = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        E, D, H = num_experts, units, hidden
        s1 = 1.0 / math.sqrt(D)
        s2 = 1.0 / math.sqrt(H)

        def normal(*shape):
            return torch.randn(*shape, generator=g).to(dev)
        self.gate_w = normal(D, E) * s1
        self.w1 = normal(E, D, H) * s1
        self.b1 = torch.zeros(E, H, device=dev)
        self.w2 = normal(E, H, D) * s2
        self.b2 = torch.zeros(E, D, device=dev)
        self.capacity_factor = capacity_factor

    def params(self):
        return (self.gate_w, self.w1, self.b1, self.w2, self.b2)

    def apply(self, params, x, mesh=None, ep_axis="ep", key=None,
              jitter: float = 0.0):
        gate_w, w1, b1, w2, b2 = params
        return moe_ffn(x, gate_w, w1, b1, w2, b2,
                       capacity_factor=self.capacity_factor, mesh=mesh,
                       ep_axis=ep_axis, key=key, jitter=jitter)
