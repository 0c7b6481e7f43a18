"""ResNet V1 with bottleneck blocks as HybridBlocks (the counterpart of
``mxtpu/gluon/model_zoo/vision/resnet.py``; He et al. 2015), with
mxtpu's children and so mxtpu's parameter names in mxtpu's order.

As in the reference, the bottleneck's two 1x1 convolutions keep their
bias and take their input width at the first forward.  Every BatchNorm
runs the fused BN(+add)(+ReLU) ops: channel axis 1 under
``layout="NCHW"`` (the channels-major kernels in training mode), axis
3 under ``"NHWC"`` (the channels-minor ones).

Not ported yet: ``BasicBlockV1`` (resnet18/34), ``ResNetV2`` and its
blocks, pretrained weights.
"""
from __future__ import annotations

from ....base import MXNetError
from ... import nn
from ...block import HybridBlock

__all__ = ["BottleneckV1", "ResNetV1", "get_resnet", "resnet50_v1"]


def _conv3x3(channels, stride, in_channels, layout="NCHW"):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels,
                     layout=layout)


def _bn_axis(layout):
    # channel axis for BatchNorm under the given data layout
    return 1 if layout.startswith("NC") else 3


class BottleneckV1(HybridBlock):
    """1x1-3x3-1x1 bottleneck (resnet50+ v1); the last BatchNorm adds
    the shortcut before its ReLU."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        ax = _bn_axis(layout)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(nn.Conv2D(channels // 4, kernel_size=1,
                                strides=stride, layout=layout))
        self.body.add(nn.BatchNorm(axis=ax, act_type="relu"))
        self.body.add(_conv3x3(channels // 4, 1, channels // 4, layout))
        self.body.add(nn.BatchNorm(axis=ax, act_type="relu"))
        self.body.add(nn.Conv2D(channels, kernel_size=1, strides=1,
                                layout=layout))
        self.bn_out = nn.BatchNorm(axis=ax, act_type="relu")
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(nn.Conv2D(
                channels, kernel_size=1, strides=stride, use_bias=False,
                in_channels=in_channels, layout=layout))
            self.downsample.add(nn.BatchNorm(axis=ax))
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return self.bn_out(x, residual)


class ResNetV1(HybridBlock):
    """ResNet V1: stem, four stages of ``block``, global average pool
    and a ``Dense`` classifier.  ``thumbnail=True`` replaces the 7x7
    stem, its BatchNorm and the max pool with one 3x3 convolution (for
    32x32 inputs)."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(channels) - 1:
            raise MXNetError(f"ResNetV1: {len(layers)} stages need "
                             f"{len(layers) + 1} channel counts, got "
                             f"{len(channels)}")
        self._layout = layout
        ax = _bn_axis(layout)
        self.features = nn.HybridSequential(prefix="")
        if thumbnail:
            self.features.add(_conv3x3(channels[0], 1, 0, layout))
        else:
            self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                        use_bias=False, layout=layout))
            self.features.add(nn.BatchNorm(axis=ax, act_type="relu"))
            self.features.add(nn.MaxPool2D(3, 2, 1, layout=layout))
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            self.features.add(self._make_layer(
                block, num_layer, channels[i + 1], stride,
                in_channels=channels[i], layout=layout))
        self.features.add(nn.GlobalAvgPool2D(layout=layout))
        self.output = nn.Dense(classes, in_units=channels[-1])

    def _make_layer(self, block, layers, channels, stride, in_channels=0,
                    layout="NCHW"):
        layer = nn.HybridSequential(prefix="")
        layer.add(block(channels, stride, channels != in_channels,
                        in_channels=in_channels, layout=layout))
        for _ in range(layers - 1):
            layer.add(block(channels, 1, False, in_channels=channels,
                            layout=layout))
        return layer

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


# depth -> (stage depths, channels) of the bottleneck depths ported so
# far
_resnet_spec = {
    50: ([3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
}


def get_resnet(version, num_layers, pretrained=False, **kwargs):
    """A ResNet V1 of ``num_layers`` (50 so far); ``kwargs`` go to
    :class:`ResNetV1` (``classes``, ``thumbnail``, ``layout``)."""
    if version != 1:
        raise NotImplementedError("ResNet V2 is not ported yet")
    if num_layers not in _resnet_spec:
        raise MXNetError(f"invalid depth {num_layers}; ported: "
                         f"{sorted(_resnet_spec)}")
    if pretrained:
        raise MXNetError("pretrained weights are not bundled; "
                         "load_parameters() from a local file instead")
    layers, channels = _resnet_spec[num_layers]
    return ResNetV1(BottleneckV1, layers, channels, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)
