"""ResNet V1 and V2 as HybridBlocks (the counterpart of
``mxtpu/gluon/model_zoo/vision/resnet.py``; He et al. 2015 and 2016),
with mxtpu's children and so mxtpu's parameter names in mxtpu's order:
the basic blocks of resnet18/34, the bottlenecks of resnet50/101/152,
in both versions, and the ten ``resnetNN_vK`` constructors.

As in the reference, V1's bottleneck keeps the bias of its two 1x1
convolutions and takes their input width at the first forward.  Every
BatchNorm runs the fused BN(+add)(+ReLU) ops: channel axis 1 under
``layout="NCHW"`` (the channels-major kernels in training mode), axis
3 under ``"NHWC"`` (the channels-minor ones).  V2's blocks are
pre-activation: BatchNorm + ReLU before each convolution, the shortcut
added after the last one; its stem normalizes the input with a
``BatchNorm(scale=False, center=False)``, and a BatchNorm and a ReLU
close the features.  Pretrained weights are not bundled.
"""
from __future__ import annotations

from ....base import MXNetError
from ... import nn
from ...block import HybridBlock

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "get_resnet",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
           "resnet101_v2", "resnet152_v2"]


def _conv3x3(channels, stride, in_channels, layout="NCHW"):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels,
                     layout=layout)


def _bn_axis(layout):
    # channel axis for BatchNorm under the given data layout
    return 1 if layout.startswith("NC") else 3


class BasicBlockV1(HybridBlock):
    """Two 3x3 convolutions (resnet18/34 v1); the second BatchNorm adds
    the shortcut before its ReLU."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        ax = _bn_axis(layout)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(_conv3x3(channels, stride, in_channels, layout))
        self.body.add(nn.BatchNorm(axis=ax, act_type="relu"))
        self.body.add(_conv3x3(channels, 1, channels, layout))
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


class BasicBlockV2(HybridBlock):
    """Pre-activation basic block (resnet18/34 v2): the shortcut is the
    input, or a 1x1 convolution of its first BatchNorm + ReLU."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        ax = _bn_axis(layout)
        self.bn1 = nn.BatchNorm(axis=ax, act_type="relu")
        self.conv1 = _conv3x3(channels, stride, in_channels, layout)
        self.bn2 = nn.BatchNorm(axis=ax, act_type="relu")
        self.conv2 = _conv3x3(channels, 1, channels, layout)
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                        in_channels=in_channels,
                                        layout=layout)
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.bn1(x)
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.bn2(x)
        x = self.conv2(x)
        return x + residual


class BottleneckV2(HybridBlock):
    """Pre-activation bottleneck (resnet50/101/152 v2), no convolution
    bias."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        ax = _bn_axis(layout)
        self.bn1 = nn.BatchNorm(axis=ax, act_type="relu")
        self.conv1 = nn.Conv2D(channels // 4, kernel_size=1, strides=1,
                               use_bias=False, layout=layout)
        self.bn2 = nn.BatchNorm(axis=ax, act_type="relu")
        self.conv2 = _conv3x3(channels // 4, stride, channels // 4, layout)
        self.bn3 = nn.BatchNorm(axis=ax, act_type="relu")
        self.conv3 = nn.Conv2D(channels, kernel_size=1, strides=1,
                               use_bias=False, layout=layout)
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                        in_channels=in_channels,
                                        layout=layout)
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.bn1(x)
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.bn2(x)
        x = self.conv2(x)
        x = self.bn3(x)
        x = self.conv3(x)
        return x + residual


def _make_layer(block, layers, channels, stride, in_channels, layout):
    layer = nn.HybridSequential(prefix="")
    layer.add(block(channels, stride, channels != in_channels,
                    in_channels=in_channels, layout=layout))
    for _ in range(layers - 1):
        layer.add(block(channels, 1, False, in_channels=channels,
                        layout=layout))
    return layer


def _check_stages(cls, layers, channels):
    if len(layers) != len(channels) - 1:
        raise MXNetError(f"{cls}: {len(layers)} stages need "
                         f"{len(layers) + 1} channel counts, got "
                         f"{len(channels)}")


class ResNetV1(HybridBlock):
    """ResNet V1: stem, four stages of ``block``, global average pool
    and a ``Dense`` classifier.  ``thumbnail=True`` replaces the 7x7
    stem, its BatchNorm and the max pool with one 3x3 convolution (for
    32x32 inputs)."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        _check_stages("ResNetV1", layers, channels)
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
            self.features.add(_make_layer(
                block, num_layer, channels[i + 1], stride, channels[i],
                layout))
        self.features.add(nn.GlobalAvgPool2D(layout=layout))
        self.output = nn.Dense(classes, in_units=channels[-1])

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


class ResNetV2(HybridBlock):
    """ResNet V2: the input's BatchNorm (no scale, no shift), the stem,
    four stages of pre-activation ``block``, BatchNorm + ReLU, global
    average pool and a ``Dense`` classifier."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        _check_stages("ResNetV2", layers, channels)
        self._layout = layout
        ax = _bn_axis(layout)
        self.features = nn.HybridSequential(prefix="")
        self.features.add(nn.BatchNorm(axis=ax, scale=False, center=False))
        if thumbnail:
            self.features.add(_conv3x3(channels[0], 1, 0, layout))
        else:
            self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                        use_bias=False, layout=layout))
            self.features.add(nn.BatchNorm(axis=ax, act_type="relu"))
            self.features.add(nn.MaxPool2D(3, 2, 1, layout=layout))
        in_channels = channels[0]
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            self.features.add(_make_layer(
                block, num_layer, channels[i + 1], stride, in_channels,
                layout))
            in_channels = channels[i + 1]
        self.features.add(nn.BatchNorm(axis=ax))
        self.features.add(nn.Activation("relu"))
        self.features.add(nn.GlobalAvgPool2D(layout=layout))
        self.output = nn.Dense(classes, in_units=channels[-1])

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


_resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
_resnet_net_versions = [ResNetV1, ResNetV2]
_resnet_block_versions = [
    {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
    {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2},
]


def get_resnet(version, num_layers, pretrained=False, **kwargs):
    """A ResNet of ``version`` 1 or 2 and ``num_layers`` 18, 34, 50, 101
    or 152; ``kwargs`` go to the net (``classes``, ``thumbnail``,
    ``layout``)."""
    if num_layers not in _resnet_spec:
        raise MXNetError(f"invalid depth {num_layers}; "
                         f"choices {sorted(_resnet_spec)}")
    if version not in (1, 2):
        raise MXNetError("version must be 1 or 2")
    if pretrained:
        raise MXNetError("pretrained weights are not bundled (no "
                         "network access); load_parameters() from a "
                         "local file instead")
    block_type, layers, channels = _resnet_spec[num_layers]
    net_cls = _resnet_net_versions[version - 1]
    block_cls = _resnet_block_versions[version - 1][block_type]
    return net_cls(block_cls, layers, channels, **kwargs)


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)


def resnet18_v2(**kwargs):
    return get_resnet(2, 18, **kwargs)


def resnet34_v2(**kwargs):
    return get_resnet(2, 34, **kwargs)


def resnet50_v2(**kwargs):
    return get_resnet(2, 50, **kwargs)


def resnet101_v2(**kwargs):
    return get_resnet(2, 101, **kwargs)


def resnet152_v2(**kwargs):
    return get_resnet(2, 152, **kwargs)
