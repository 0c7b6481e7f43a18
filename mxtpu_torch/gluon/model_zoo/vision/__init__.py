"""Vision models (``mxtpu.gluon.model_zoo.vision`` counterpart)."""
from .resnet import (BottleneckV1, ResNetV1, get_resnet,  # noqa: F401
                     resnet50_v1)
