"""Gluon basic layers (the counterpart of
``mxtpu/gluon/nn/basic_layers.py``): ``Sequential``,
``HybridSequential``, ``Dense``, ``Dropout``, ``BatchNorm``,
``InstanceNorm``, ``LayerNorm``, ``FusedResidualLayerNorm``,
``Embedding``, ``Flatten``, ``Lambda`` and ``HybridLambda``.

Each layer has mxtpu's constructor and parameter names and one
``hybrid_forward`` over the registry's ops, so the same code runs
eagerly on tensors and builds the graph ``export`` writes.  A size left
0 (``in_units``, ``in_channels``) is inferred at the first forward.
LayerNorm, BatchNorm (in training mode) and the fused residual
epilogue reach the port's kernels through their ops.  BatchNorm moves
its running statistics as mxtpu does, ``running * momentum + batch *
(1 - momentum)``, written in place after the call in training mode.
"""
from __future__ import annotations

import torch

from ...base import MXNetError
from ... import autograd
from ..block import Block, HybridBlock, in_remat

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout",
           "BatchNorm", "InstanceNorm", "LayerNorm",
           "FusedResidualLayerNorm", "Embedding", "Flatten", "Lambda",
           "HybridLambda", "gelu"]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """gelu, tanh approximation (the ``LeakyReLU`` op's
    ``act_type="gelu"``, ``jax.nn.gelu(approximate=True)``)."""
    return torch.nn.functional.gelu(x, approximate="tanh")


class _Stack:
    """``add``, ``len``, indexing and iteration over the children."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, key):
        layers = list(self._modules.values())
        if isinstance(key, slice):
            net = type(self)(prefix=self._prefix)
            for layer in layers[key]:
                net.add(layer)
            return net
        return layers[key]

    def __iter__(self):
        return iter(self._modules.values())


class Sequential(_Stack, Block):
    """Stacks Blocks sequentially (reference ``nn.Sequential``†)."""

    def forward(self, x, *args):
        for block in self._modules.values():
            x = block(x, *args)
            args = ()
            if isinstance(x, (tuple, list)):
                args = tuple(x[1:])
                x = x[0]
        if args:
            return (x,) + args
        return x


class HybridSequential(_Stack, HybridBlock):
    """Stacks HybridBlocks (reference ``nn.HybridSequential``†)."""

    def forward(self, x, *args):
        for block in self._modules.values():
            x = block(x, *args)
            args = ()
        return x


class Dense(HybridBlock):
    """``act(x W^T + b)`` on the ``FullyConnected`` op, W (units,
    in_units); ``flatten=True`` first reshapes x to (batch, -1)."""

    def __init__(self, units, activation=None, use_bias=True,
                 flatten=True, dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, prefix=None,
                 params=None):
        super().__init__(prefix, params)
        self._units = units
        self._flatten = flatten
        self._act = activation
        self.weight = self.params.get(
            "weight", shape=(units, in_units), dtype=dtype,
            init=weight_initializer, allow_deferred_init=True)
        if use_bias:
            self.bias = self.params.get(
                "bias", shape=(units,), dtype=dtype,
                init=bias_initializer, allow_deferred_init=True)
        else:
            self.bias = None

    def _infer_params(self, x, *args):
        if self.weight.shape and self.weight.shape[1] == 0:
            in_units = 1
            for s in x.shape[1:]:
                in_units *= int(s)
            self.weight.shape = (self._units, in_units if self._flatten
                                 else int(x.shape[-1]))

    def hybrid_forward(self, F, x, weight, bias=None):
        if bias is None:
            out = F.FullyConnected(x, weight, no_bias=True,
                                   num_hidden=self._units,
                                   flatten=self._flatten)
        else:
            out = F.FullyConnected(x, weight, bias,
                                   num_hidden=self._units,
                                   flatten=self._flatten)
        if self._act is not None:
            out = F.Activation(out, act_type=self._act)
        return out

    def __repr__(self):
        shape = self.weight.shape
        return (f"Dense({shape[1] if shape and len(shape) > 1 else None} "
                f"-> {self._units}, "
                f"{'linear' if self._act is None else self._act})")


class Dropout(HybridBlock):
    """Dropout (reference ``nn.Dropout``†), on only in training mode
    (``autograd.record()`` / ``autograd.train_mode()``)."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix, params)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        if self._rate <= 0:
            return x
        return F.Dropout(x, p=self._rate, axes=self._axes)

    def __repr__(self):
        return f"Dropout(p = {self._rate}, axes={self._axes})"


class BatchNorm(HybridBlock):
    """Batch normalization over channel ``axis`` (reference
    ``nn.BatchNorm``†).  ``act_type="relu"`` fuses the ReLU and, when a
    second ``residual`` input is passed, the shortcut add before it
    (the ``BatchNormRelu`` / ``BatchNormAddRelu`` ops): in training
    mode the fused BatchNorm kernels, channels-major for axis 1 of a
    4-d input and channels-minor for the last axis."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 act_type=None, prefix=None, params=None):
        super().__init__(prefix, params)
        if act_type not in (None, "relu"):
            raise MXNetError(f"BatchNorm act_type must be None or 'relu', "
                             f"got {act_type!r}")
        self._act_type = act_type
        self._axis = axis
        self._momentum = momentum
        self._eps = epsilon
        self._center = center
        self._scale = scale
        self._use_global_stats = use_global_stats
        self.gamma = self.params.get(
            "gamma", shape=(in_channels,), init=gamma_initializer,
            allow_deferred_init=True,
            grad_req="write" if scale else "null")
        self.beta = self.params.get(
            "beta", shape=(in_channels,), init=beta_initializer,
            allow_deferred_init=True,
            grad_req="write" if center else "null")
        self.running_mean = self.params.get(
            "running_mean", shape=(in_channels,),
            init=running_mean_initializer, allow_deferred_init=True,
            differentiable=False)
        self.running_var = self.params.get(
            "running_var", shape=(in_channels,),
            init=running_variance_initializer, allow_deferred_init=True,
            differentiable=False)

    def _infer_params(self, x, *args):
        c = int(x.shape[self._axis])
        for p in (self.gamma, self.beta, self.running_mean,
                  self.running_var):
            if p.shape and p.shape[0] == 0:
                p.shape = (c,)

    def hybrid_forward(self, F, x, residual=None, gamma=None, beta=None,
                       running_mean=None, running_var=None):
        training = autograd.is_training()
        if training and not self._use_global_stats and in_remat():
            # the replay would move the running statistics a second
            # time; mxtpu refuses the update inside its checkpoint too
            raise MXNetError(
                f"{self.name}: a training-mode BatchNorm updates its "
                f"running statistics inside a set_remat region; remat a "
                f"smaller block or disable remat")
        kw = dict(eps=self._eps, momentum=self._momentum,
                  fix_gamma=not self._scale,
                  use_global_stats=self._use_global_stats or not training,
                  axis=self._axis)
        if residual is not None:
            if self._act_type != "relu":
                raise MXNetError("BatchNorm residual input requires "
                                 "act_type='relu'")
            out, mean, var = F.BatchNormAddRelu(
                x, residual, gamma, beta, running_mean, running_var, **kw)
        elif self._act_type == "relu":
            out, mean, var = F.BatchNormRelu(
                x, gamma, beta, running_mean, running_var, **kw)
        else:
            out, mean, var = F.BatchNorm(
                x, gamma, beta, running_mean, running_var, **kw)
        if training and not self._use_global_stats:
            m = self._momentum
            with torch.no_grad():
                running_mean.copy_(running_mean * m + mean * (1 - m))
                running_var.copy_(running_var * m + var * (1 - m))
        return out

    def __repr__(self):
        return (f"BatchNorm(axis={self._axis}, eps={self._eps}, "
                f"momentum={self._momentum}, in_channels="
                f"{self.gamma.shape[0] if self.gamma.shape else None})")


class InstanceNorm(HybridBlock):
    """Instance normalization (reference ``nn.InstanceNorm``†)."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix, params)
        self._axis = axis
        self._eps = epsilon
        self.gamma = self.params.get(
            "gamma", shape=(in_channels,), init=gamma_initializer,
            allow_deferred_init=True,
            grad_req="write" if scale else "null")
        self.beta = self.params.get(
            "beta", shape=(in_channels,), init=beta_initializer,
            allow_deferred_init=True,
            grad_req="write" if center else "null")

    def _infer_params(self, x, *args):
        c = int(x.shape[self._axis])
        for p in (self.gamma, self.beta):
            if p.shape and p.shape[0] == 0:
                p.shape = (c,)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.InstanceNorm(x, gamma, beta, eps=self._eps)


class LayerNorm(HybridBlock):
    """Layer normalization (reference ``nn.LayerNorm``†): the
    ``LayerNorm`` op, on the LayerNorm kernels over the last axis."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix, params)
        self._axis = axis
        self._eps = epsilon
        self.gamma = self.params.get(
            "gamma", shape=(in_channels,), init=gamma_initializer,
            allow_deferred_init=True,
            grad_req="write" if scale else "null")
        self.beta = self.params.get(
            "beta", shape=(in_channels,), init=beta_initializer,
            allow_deferred_init=True,
            grad_req="write" if center else "null")

    def _infer_params(self, x, *args):
        c = int(x.shape[self._axis])
        for p in (self.gamma, self.beta):
            if p.shape and p.shape[0] == 0:
                p.shape = (c,)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis, eps=self._eps)


class FusedResidualLayerNorm(HybridBlock):
    """The transformer post-LN epilogue ``LN(residual + dropout(x +
    bias))`` over the last axis as one layer, on the fused kernels.
    It owns the bias of the projection before it (build that ``Dense``
    with ``use_bias=False``).  Call as ``layer(x, residual)``; in
    training mode each call draws fresh threefry key words."""

    def __init__(self, dropout=0.1, epsilon=1e-5,
                 beta_initializer="zeros", gamma_initializer="ones",
                 bias_initializer="zeros", in_channels=0, prefix=None,
                 params=None):
        super().__init__(prefix, params)
        self._p = dropout
        self._eps = epsilon
        self.bias = self.params.get(
            "bias", shape=(in_channels,), init=bias_initializer,
            allow_deferred_init=True)
        self.gamma = self.params.get(
            "gamma", shape=(in_channels,), init=gamma_initializer,
            allow_deferred_init=True)
        self.beta = self.params.get(
            "beta", shape=(in_channels,), init=beta_initializer,
            allow_deferred_init=True)

    def _infer_params(self, x, *args):
        c = int(x.shape[-1])
        for p in (self.bias, self.gamma, self.beta):
            if p.shape and p.shape[0] == 0:
                p.shape = (c,)

    def hybrid_forward(self, F, x, residual, bias, gamma, beta):
        return F.FusedResidualLayerNorm(x, bias, residual, gamma, beta,
                                        p=self._p, eps=self._eps)


class Embedding(HybridBlock):
    """Id → row lookup (reference ``nn.Embedding``† → ``Embedding``
    op); float ids truncate to integers."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, prefix=None,
                 params=None):
        super().__init__(prefix, params)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self.weight = self.params.get(
            "weight", shape=(input_dim, output_dim), dtype=dtype,
            init=weight_initializer,
            grad_stype="row_sparse" if sparse_grad else "default")

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim)

    def __repr__(self):
        return f"Embedding({self._input_dim} -> {self._output_dim})"


class Flatten(HybridBlock):
    """Flattens to (batch, -1) (reference ``nn.Flatten``†)."""

    def hybrid_forward(self, F, x):
        return F.flatten(x)

    def __repr__(self):
        return "Flatten"


class Lambda(Block):
    """Wraps a function, or the name of an ``nd`` function, as a Block
    (reference ``nn.Lambda``†)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix)
        if isinstance(function, str):
            from ... import ndarray as nd
            if not hasattr(nd, function):
                raise MXNetError(f"no such nd function {function}")
            self._func = getattr(nd, function)
            self._name = function
        elif callable(function):
            self._func = function
            self._name = getattr(function, "__name__", "lambda")
        else:
            raise MXNetError("function must be str or callable")

    def forward(self, *args):
        return self._func(*args)

    def __repr__(self):
        return f"Lambda({self._name})"


class HybridLambda(HybridBlock):
    """Wraps ``function(F, *args)``, or the name of an op, as a
    HybridBlock (reference ``nn.HybridLambda``†)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix)
        if isinstance(function, str):
            self._func_name = function
            self._func = None
        elif callable(function):
            self._func = function
            self._func_name = getattr(function, "__name__", "lambda")
        else:
            raise MXNetError("function must be str or callable")

    def hybrid_forward(self, F, *args):
        if self._func is not None:
            return self._func(F, *args)
        return getattr(F, self._func_name)(*args)

    def __repr__(self):
        return f"HybridLambda({self._func_name})"
