"""Gluon convolution, transposed-convolution, pooling and padding layers
(the counterpart of ``mxtpu/gluon/nn/conv_layers.py``): ``Conv1D`` to
``Conv3D``, ``Conv1DTranspose`` to ``Conv3DTranspose``, max, average
and global pooling in 1 to 3 dimensions, and ``ReflectionPad2D``, on the
``Convolution``, ``Deconvolution``, ``Pooling`` and ``pad`` ops, with a
deferred ``in_channels``.

The JAX package computes these with ``lax.conv_general_dilated``,
``lax.conv_transpose`` and ``lax.reduce_window``, outside any Pallas
kernel, so the ops are torch's convolutions (cuDNN on the card, TF32
off) and pools.  Both data layouts of the reference are kept: channels
first (``NCW``/``NCHW``/``NCDHW``, convolution weights
(O, I/g, *k)) and channels last (``NWC``/``NHWC``/``NDHWC``, weights
(O, *k, I/g)), which the ops hand to cuDNN as permuted views; a
transposed convolution's weights are (I, O/g, *k), or (I, *k, O/g)
channels last.
"""
from __future__ import annotations

from ...base import MXNetError
from ..block import HybridBlock

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "ReflectionPad2D"]

# channels first, channels last, by the number of spatial axes
_LAYOUTS = {1: ("NCW", "NWC"), 2: ("NCHW", "NHWC"), 3: ("NCDHW", "NDHWC")}


def _to_tuple(v, n):
    if isinstance(v, (tuple, list)):
        if len(v) != n:
            raise MXNetError(f"expected {n}-tuple, got {v}")
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _layout(layout, n):
    if layout not in _LAYOUTS[n]:
        raise MXNetError(f"layout must be one of {_LAYOUTS[n]}, got "
                         f"{layout!r}")
    return layout


class _Conv(HybridBlock):
    """The N-d convolution layers' shared body (mxtpu's ``_Conv``):
    ``_ndim`` spatial axes, the ``Convolution`` or ``Deconvolution``
    op, an optional bias and activation."""

    _ndim = 2
    _op = "Convolution"

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", output_padding=None,
                 prefix=None, params=None):
        super().__init__(prefix, params)
        n = self._ndim
        self._channels = channels
        self._in_channels = in_channels
        self._kernel = _to_tuple(kernel_size, n)
        self._strides = _to_tuple(strides, n)
        self._padding = _to_tuple(padding, n)
        self._dilation = _to_tuple(dilation, n)
        self._groups = groups
        self._layout = _layout(layout, n)
        self._act = activation
        self._output_padding = (_to_tuple(output_padding, n)
                                if output_padding is not None else None)
        self.weight = self.params.get(
            "weight", shape=self._wshape(in_channels),
            init=weight_initializer, allow_deferred_init=True)
        if use_bias:
            self.bias = self.params.get(
                "bias", shape=(channels,), init=bias_initializer,
                allow_deferred_init=True)
        else:
            self.bias = None

    def _wshape(self, in_c):
        """mxtpu's weight shape for ``in_c`` input channels (0 while
        deferred; a deferred transposed convolution keeps mxtpu's
        channels-first shape until the first forward)."""
        last = not self._layout.startswith("NC")
        if self._op == "Convolution":
            in_g = in_c // self._groups if in_c else 0
            return ((self._channels,) + self._kernel + (in_g,) if last
                    else (self._channels, in_g) + self._kernel)
        out_g = self._channels // self._groups
        if last and in_c:
            return (in_c,) + self._kernel + (out_g,)
        return (in_c, out_g) + self._kernel

    def _infer_params(self, x, *args):
        if self.weight.shape and 0 in self.weight.shape:
            last = not self._layout.startswith("NC")
            in_c = int(x.shape[-1 if last else 1])
            self.weight.shape = self._wshape(in_c)
            self._in_channels = in_c

    def hybrid_forward(self, F, x, weight, bias=None):
        op = getattr(F, self._op)
        kwargs = dict(kernel=self._kernel, stride=self._strides,
                      dilate=self._dilation, pad=self._padding,
                      num_filter=self._channels, num_group=self._groups,
                      layout=self._layout)
        if self._op == "Deconvolution" and self._output_padding:
            kwargs["adj"] = self._output_padding
        if bias is None:
            out = op(x, weight, no_bias=True, **kwargs)
        else:
            out = op(x, weight, bias, **kwargs)
        if self._act is not None:
            out = F.Activation(out, act_type=self._act)
        return out

    def __repr__(self):
        return (f"{type(self).__name__}({self._in_channels or None} -> "
                f"{self._channels}, kernel_size={self._kernel}, "
                f"stride={self._strides}, padding={self._padding})")


class Conv1D(_Conv):
    """1-D convolution (reference ``nn.Conv1D``†)."""
    _ndim = 1

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv2D(_Conv):
    """2-D convolution (reference ``nn.Conv2D``†)."""
    _ndim = 2

    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1, layout="NCHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv3D(_Conv):
    """3-D convolution (reference ``nn.Conv3D``†)."""
    _ndim = 3

    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv1DTranspose(_Conv):
    """1-D transposed convolution (reference ``nn.Conv1DTranspose``†);
    ``output_padding`` reaches the op as ``adj``, which mxtpu's op
    ignores, and so does the port's."""
    _ndim = 1
    _op = "Deconvolution"

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         output_padding=output_padding, **kwargs)


class Conv2DTranspose(_Conv):
    """2-D transposed convolution (reference ``nn.Conv2DTranspose``†)."""
    _ndim = 2
    _op = "Deconvolution"

    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), output_padding=(0, 0), dilation=(1, 1),
                 groups=1, layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         output_padding=output_padding, **kwargs)


class Conv3DTranspose(_Conv):
    """3-D transposed convolution (reference ``nn.Conv3DTranspose``†)."""
    _ndim = 3
    _op = "Deconvolution"

    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         output_padding=output_padding, **kwargs)


class _Pooling(HybridBlock):
    _ndim = 2
    _pool_type = "max"
    _global = False

    def __init__(self, pool_size, strides, padding, ceil_mode=False,
                 count_include_pad=True, layout=None, prefix=None,
                 params=None):
        super().__init__(prefix, params)
        n = self._ndim
        self._layout = _layout(layout or _LAYOUTS[n][0], n)
        if not self._global:
            self._kernel = _to_tuple(pool_size, n)
            self._strides = _to_tuple(
                pool_size if strides is None else strides, n)
            self._padding = _to_tuple(padding, n)
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


class MaxPool1D(_Pooling):
    """Max pooling over W (reference ``nn.MaxPool1D``†); the padding
    counts as -inf."""
    _ndim = 1

    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        super().__init__(pool_size, strides, padding, ceil_mode,
                         layout=layout, **kwargs)


class MaxPool2D(_Pooling):
    """Max pooling (reference ``nn.MaxPool2D``†); the padding counts as
    -inf."""
    _ndim = 2

    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(pool_size, strides, padding, ceil_mode,
                         layout=layout, **kwargs)


class MaxPool3D(_Pooling):
    """Max pooling over D, H, W (reference ``nn.MaxPool3D``†)."""
    _ndim = 3

    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kwargs):
        super().__init__(pool_size, strides, padding, ceil_mode,
                         layout=layout, **kwargs)


class AvgPool1D(_Pooling):
    """Average pooling over W (reference ``nn.AvgPool1D``†)."""
    _ndim = 1
    _pool_type = "avg"

    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, **kwargs):
        super().__init__(pool_size, strides, padding, ceil_mode,
                         count_include_pad, layout=layout, **kwargs)


class AvgPool2D(_Pooling):
    """Average pooling (reference ``nn.AvgPool2D``†)."""
    _ndim = 2
    _pool_type = "avg"

    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(pool_size, strides, padding, ceil_mode,
                         count_include_pad, layout=layout, **kwargs)


class AvgPool3D(_Pooling):
    """Average pooling over D, H, W (reference ``nn.AvgPool3D``†)."""
    _ndim = 3
    _pool_type = "avg"

    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(pool_size, strides, padding, ceil_mode,
                         count_include_pad, layout=layout, **kwargs)


class _GlobalPool(_Pooling):
    _global = True

    def __init__(self, layout=None, **kwargs):
        super().__init__(None, None, None, layout=layout, **kwargs)


class GlobalMaxPool1D(_GlobalPool):
    """Max over W, kept as a size-1 axis."""
    _ndim = 1


class GlobalMaxPool2D(_GlobalPool):
    """Max over the spatial axes, kept as size-1 axes."""
    _ndim = 2


class GlobalMaxPool3D(_GlobalPool):
    """Max over D, H, W, kept as size-1 axes."""
    _ndim = 3


class GlobalAvgPool1D(_GlobalPool):
    """Mean over W, kept as a size-1 axis."""
    _ndim = 1
    _pool_type = "avg"


class GlobalAvgPool2D(_GlobalPool):
    """Mean over the spatial axes, kept as size-1 axes."""
    _ndim = 2
    _pool_type = "avg"


class GlobalAvgPool3D(_GlobalPool):
    """Mean over D, H, W, kept as size-1 axes."""
    _ndim = 3
    _pool_type = "avg"


class ReflectionPad2D(HybridBlock):
    """Reflection padding of H and W (reference ``nn.ReflectionPad2D``†);
    ``padding`` is one int or (left, right, top, bottom)."""

    def __init__(self, padding=0, prefix=None, params=None):
        super().__init__(prefix, params)
        if isinstance(padding, int):
            padding = (padding,) * 4
        self._padding = tuple(int(p) for p in padding)

    def hybrid_forward(self, F, x):
        left, right, top, bottom = self._padding
        return F.pad(x, mode="reflect",
                     pad_width=(0, 0, 0, 0, top, bottom, left, right))
