"""Gluon convolution and pooling layers (the counterpart of
``mxtpu/gluon/nn/conv_layers.py``): ``Conv2D``, ``MaxPool2D``,
``AvgPool2D``, ``GlobalAvgPool2D`` and ``GlobalMaxPool2D``, on the
``Convolution`` and ``Pooling`` ops, with a deferred ``in_channels``.

The JAX package computes these with ``lax.conv_general_dilated`` and
``lax.reduce_window``, outside any Pallas kernel, so the ops are
``F.conv2d`` (cuDNN on the card, TF32 off) and torch's pools.  Both
data layouts of the reference are kept: ``"NCHW"`` with weights (O, I,
kh, kw), and ``"NHWC"`` with weights (O, kh, kw, I), which the ops hand
to cuDNN as channels-last views.  The other convolution and pooling
classes are not ported yet.
"""
from __future__ import annotations

from ...base import MXNetError
from ..block import HybridBlock

__all__ = ["Conv2D", "MaxPool2D", "AvgPool2D", "GlobalMaxPool2D",
           "GlobalAvgPool2D"]

_LAYOUTS = ("NCHW", "NHWC")


def _to_tuple(v, n):
    if isinstance(v, (tuple, list)):
        if len(v) != n:
            raise MXNetError(f"expected {n}-tuple, got {v}")
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _layout(layout: str) -> str:
    if layout not in _LAYOUTS:
        raise MXNetError(f"layout must be one of {_LAYOUTS}, got "
                         f"{layout!r}")
    return layout


class Conv2D(HybridBlock):
    """2-D convolution (reference ``nn.Conv2D``†) with an optional bias
    and activation; ``in_channels=0`` is inferred at the first
    forward."""

    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1, layout="NCHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, prefix=None,
                 params=None):
        super().__init__(prefix, params)
        self._channels = channels
        self._in_channels = in_channels
        self._kernel = _to_tuple(kernel_size, 2)
        self._strides = _to_tuple(strides, 2)
        self._padding = _to_tuple(padding, 2)
        self._dilation = _to_tuple(dilation, 2)
        self._groups = groups
        self._layout = _layout(layout)
        self._act = activation
        in_g = in_channels // groups if in_channels else 0
        self.weight = self.params.get(
            "weight", shape=self._wshape(in_g), init=weight_initializer,
            allow_deferred_init=True)
        if use_bias:
            self.bias = self.params.get(
                "bias", shape=(channels,), init=bias_initializer,
                allow_deferred_init=True)
        else:
            self.bias = None

    def _wshape(self, in_g):
        # OIhw for NCHW, OhwI for the channels-last layout
        if self._layout == "NHWC":
            return (self._channels,) + self._kernel + (in_g,)
        return (self._channels, in_g) + self._kernel

    def _infer_params(self, x, *args):
        if self.weight.shape and 0 in self.weight.shape:
            in_c = int(x.shape[-1 if self._layout == "NHWC" else 1])
            self.weight.shape = self._wshape(in_c // self._groups)
            self._in_channels = in_c

    def hybrid_forward(self, F, x, weight, bias=None):
        kwargs = dict(kernel=self._kernel, stride=self._strides,
                      dilate=self._dilation, pad=self._padding,
                      num_filter=self._channels, num_group=self._groups,
                      layout=self._layout)
        if bias is None:
            out = F.Convolution(x, weight, no_bias=True, **kwargs)
        else:
            out = F.Convolution(x, weight, bias, **kwargs)
        if self._act is not None:
            out = F.Activation(out, act_type=self._act)
        return out

    def __repr__(self):
        return (f"Conv2D({self._in_channels or None} -> "
                f"{self._channels}, kernel_size={self._kernel}, "
                f"stride={self._strides}, padding={self._padding})")


class _Pooling(HybridBlock):
    _pool_type = "max"
    _global = False

    def __init__(self, pool_size, strides, padding, ceil_mode=False,
                 count_include_pad=True, layout="NCHW", prefix=None,
                 params=None):
        super().__init__(prefix, params)
        self._layout = _layout(layout)
        if not self._global:
            self._kernel = _to_tuple(pool_size, 2)
            self._strides = _to_tuple(
                pool_size if strides is None else strides, 2)
            self._padding = _to_tuple(padding, 2)
        self._ceil = ceil_mode
        self._count_include_pad = count_include_pad

    def hybrid_forward(self, F, x):
        if self._global:
            return F.Pooling(x, pool_type=self._pool_type,
                             global_pool=True, layout=self._layout)
        return F.Pooling(x, kernel=self._kernel, pool_type=self._pool_type,
                         stride=self._strides, pad=self._padding,
                         count_include_pad=self._count_include_pad,
                         layout=self._layout)

    def __repr__(self):
        if self._global:
            return f"{type(self).__name__}()"
        return (f"{type(self).__name__}(size={self._kernel}, "
                f"stride={self._strides}, padding={self._padding})")


class MaxPool2D(_Pooling):
    """Max pooling (reference ``nn.MaxPool2D``†); the padding counts as
    -inf."""

    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(pool_size, strides, padding, ceil_mode,
                         layout=layout, **kwargs)


class AvgPool2D(_Pooling):
    """Average pooling (reference ``nn.AvgPool2D``†)."""
    _pool_type = "avg"

    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(pool_size, strides, padding, ceil_mode,
                         count_include_pad, layout=layout, **kwargs)


class _GlobalPool(_Pooling):
    _global = True

    def __init__(self, layout="NCHW", **kwargs):
        super().__init__(None, None, None, layout=layout, **kwargs)


class GlobalMaxPool2D(_GlobalPool):
    """Max over the spatial axes, kept as size-1 axes."""


class GlobalAvgPool2D(_GlobalPool):
    """Mean over the spatial axes, kept as size-1 axes."""
    _pool_type = "avg"
