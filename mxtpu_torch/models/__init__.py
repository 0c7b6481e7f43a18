"""Model builders (``mxtpu.models`` counterpart): the Transformer and
BERT families, the detectors (``ssd``: ``SSD``, ``SSDLoss``,
``toy_ssd``, ``ssd_300``; ``rcnn``: ``FasterRCNN``, ``RPN``,
``faster_rcnn_small``, ``rpn_anchors``), and
``lenet``, ``mlp`` and ``resnet50`` as the JAX package builds them."""
from ..gluon import nn
from . import rcnn, ssd  # noqa: F401  (the detector families)
from .rcnn import RPN, FasterRCNN, faster_rcnn_small, rpn_anchors  # noqa: F401
from .ssd import SSD, SSDLoss, ssd_300, toy_ssd  # noqa: F401
from .transformer import (BERTModel, MultiHeadAttention,  # noqa: F401
                          PositionwiseFFN, TransformerDecoder,
                          TransformerDecoderCell, TransformerEncoder,
                          TransformerEncoderCell, TransformerModel,
                          bert_base, bert_large, transformer_base,
                          transformer_big, transformer_encoder)


def resnet50(classes: int = 1000, thumbnail: bool = False):
    """ResNet-50 v1, the JAX package's ``bench_resnet50`` model
    (``mxtpu/models/__init__.py`` ``resnet50``)."""
    from ..gluon.model_zoo import vision
    return vision.get_resnet(1, 50, thumbnail=thumbnail, classes=classes)


def lenet(classes: int = 10):
    """LeNet-5 as the reference's MNIST example builds it."""
    net = nn.HybridSequential(prefix="lenet_")
    net.add(nn.Conv2D(20, kernel_size=5, activation="tanh"),
            nn.MaxPool2D(pool_size=2, strides=2),
            nn.Conv2D(50, kernel_size=5, activation="tanh"),
            nn.MaxPool2D(pool_size=2, strides=2),
            nn.Flatten(),
            nn.Dense(500, activation="tanh"),
            nn.Dense(classes))
    return net


def mlp(classes: int = 10, hidden=(128, 64)):
    """The reference's canonical MLP."""
    net = nn.HybridSequential(prefix="mlp_")
    for h in hidden:
        net.add(nn.Dense(h, activation="relu"))
    net.add(nn.Dense(classes))
    return net
