"""The gluon layers BERT and ResNet need, as ``nn.Module``s.

Counterparts of ``mxtpu/gluon/nn/basic_layers.py``: same constructor
arguments where they matter, same parameter shapes and the same
registration order (what ``convert.params_from_mxtpu`` relies on).
Shapes are explicit here — no deferred initialization — so each layer
takes its input width.  Training mode is the module's ``training``
flag (the JAX package's ``autograd.record(train_mode=True)``): dropout
draws from the device's generator in :mod:`mxtpu_torch.random`.
"""
from __future__ import annotations

import torch
from torch import nn

from ... import random as _random
from ...base import MXNetError
from ...kernels import fused_bn_act, fused_residual_layer_norm, layer_norm

__all__ = ["Dense", "Dropout", "Embedding", "LayerNorm", "BatchNorm",
           "FusedResidualLayerNorm", "HybridSequential", "gelu"]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """gelu, tanh approximation (``ops_impl.py`` LeakyReLU
    ``act_type="gelu"`` → ``jax.nn.gelu(approximate=True)``)."""
    return torch.nn.functional.gelu(x, approximate="tanh")


class Dense(nn.Module):
    """Fully connected layer ``y = x @ W.T + b`` with ``W`` of shape
    (units, in_units).  ``flatten=True`` (gluon's default) first
    reshapes x to (batch, -1); ``flatten=False`` applies the layer to
    the last axis."""

    def __init__(self, units: int, in_units: int, use_bias: bool = True,
                 flatten: bool = True):
        super().__init__()
        self._flatten = flatten
        self.weight = nn.Parameter(torch.empty(units, in_units))
        nn.init.normal_(self.weight, std=0.02)
        self.bias = nn.Parameter(torch.zeros(units)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._flatten:
            x = x.reshape(x.shape[0], -1)
        y = torch.matmul(x, self.weight.t())
        if self.bias is not None:
            y = y + self.bias
        return y


class Dropout(nn.Module):
    """Dropout: in training mode each element is kept with probability
    ``1 - rate`` and scaled by ``1 / (1 - rate)`` (``ops_impl.py``
    ``_dropout``), the mask drawn from ``random.generator(x.device)``;
    the identity in eval mode."""

    def __init__(self, rate: float):
        super().__init__()
        self._rate = float(rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self._rate <= 0.0:
            return x
        keep = 1.0 - self._rate
        u = torch.rand(x.shape, generator=_random.generator(x.device),
                       device=x.device)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))


class Embedding(nn.Module):
    """Table lookup.  Token ids may arrive as floats (the serving wire
    format) and are truncated to integers, as ``ops_impl.py``'s
    ``Embedding`` does with ``astype(int32)``."""

    def __init__(self, input_dim: int, output_dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(input_dim, output_dim))
        nn.init.normal_(self.weight, std=0.02)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.weight[ids.to(torch.int64)]


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, on the LayerNorm kernel."""

    def __init__(self, in_channels: int, epsilon: float = 1e-5):
        super().__init__()
        self._eps = epsilon
        self.gamma = nn.Parameter(torch.ones(in_channels))
        self.beta = nn.Parameter(torch.zeros(in_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.gamma, self.beta, self._eps)


class BatchNorm(nn.Module):
    """Batch normalization over channel ``axis`` (gluon's
    ``nn.BatchNorm``), with ``act_type="relu"`` fusing the ReLU and,
    when a second ``residual`` input is passed, the shortcut add before
    it (the ``BatchNormAddRelu`` op).

    gamma and beta are parameters (gamma is fixed at 1 when
    ``scale=False``); ``running_mean`` and ``running_var`` are f32
    buffers, registered after them.  In training mode (unless
    ``use_global_stats``) the layer runs :func:`kernels.fused_bn_act`
    on the batch statistics and moves the running statistics by
    ``running * momentum + batch * (1 - momentum)``; otherwise it
    normalizes with the running statistics in plain PyTorch, as the
    JAX package does outside its kernels.  ``in_channels`` is
    required (no deferred shapes)."""

    def __init__(self, axis: int = 1, momentum: float = 0.9,
                 epsilon: float = 1e-5, center: bool = True,
                 scale: bool = True, use_global_stats: bool = False,
                 in_channels: int = 0, act_type=None):
        super().__init__()
        if act_type not in (None, "relu"):
            raise MXNetError(f"BatchNorm act_type must be None or 'relu', "
                             f"got {act_type!r}")
        if in_channels <= 0:
            raise MXNetError("BatchNorm needs in_channels (shapes are "
                             "explicit in mxtpu_torch)")
        self._axis = axis
        self._momentum = float(momentum)
        self._eps = float(epsilon)
        self._scale = scale
        self._use_global_stats = use_global_stats
        self._act = "relu" if act_type == "relu" else "none"
        self.gamma = nn.Parameter(torch.ones(in_channels),
                                  requires_grad=scale)
        self.beta = nn.Parameter(torch.zeros(in_channels),
                                 requires_grad=center)
        self.register_buffer("running_mean", torch.zeros(in_channels))
        self.register_buffer("running_var", torch.ones(in_channels))

    def forward(self, x: torch.Tensor,
                residual: torch.Tensor = None) -> torch.Tensor:
        if residual is not None and self._act != "relu":
            raise MXNetError("BatchNorm residual input requires "
                             "act_type='relu'")
        g = self.gamma if self._scale else torch.ones_like(self.gamma)
        if self.training and not self._use_global_stats:
            y, mean, var = fused_bn_act(x, g, self.beta, self._eps,
                                        self._act, residual, self._axis)
            m = self._momentum
            with torch.no_grad():
                self.running_mean.copy_(self.running_mean * m +
                                        mean * (1 - m))
                self.running_var.copy_(self.running_var * m +
                                       var * (1 - m))
            return y
        shape = [1] * x.ndim
        shape[self._axis] = -1
        scale = g.float() * torch.rsqrt(self.running_var.float() + self._eps)
        out = (x.float() - self.running_mean.float().reshape(shape)) * \
            scale.reshape(shape) + self.beta.float().reshape(shape)
        if residual is not None:
            out = out + residual.float()
        if self._act == "relu":
            out = out.clamp_min(0.0)
        return out.to(x.dtype)


class FusedResidualLayerNorm(nn.Module):
    """Transformer post-LN epilogue ``LN(residual + dropout(x + bias))``
    on the fused kernel.  Owns the bias of the preceding projection
    (build that ``Dense`` with ``use_bias=False``).  Call as
    ``layer(x, residual)``.  In training mode each call draws two
    threefry key words from ``random.key_words(x.device)``; in eval
    mode dropout is off."""

    def __init__(self, in_channels: int, dropout: float = 0.1,
                 epsilon: float = 1e-5):
        super().__init__()
        self._p = float(dropout)
        self._eps = epsilon
        self.bias = nn.Parameter(torch.zeros(in_channels))
        self.gamma = nn.Parameter(torch.ones(in_channels))
        self.beta = nn.Parameter(torch.zeros(in_channels))

    def forward(self, x: torch.Tensor,
                residual: torch.Tensor) -> torch.Tensor:
        training = self.training and self._p > 0.0
        key = _random.key_words(x.device) if training else None
        return fused_residual_layer_norm(
            x, self.bias, residual, self.gamma, self.beta, key,
            p=self._p, eps=self._eps, training=training)


class HybridSequential(nn.Sequential):
    """Sequential container (``HybridSequential``); ``add`` appends."""

    def add(self, *blocks: nn.Module) -> None:
        for b in blocks:
            if not isinstance(b, nn.Module):
                raise MXNetError(f"HybridSequential.add: {b!r} is not a "
                                 f"module")
            self.append(b)
