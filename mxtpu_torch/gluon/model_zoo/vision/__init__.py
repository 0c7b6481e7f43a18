"""Vision models (``mxtpu.gluon.model_zoo.vision`` counterpart): the
ResNet family, and ``get_model`` over its names."""
from ....base import MXNetError
from .resnet import (ResNetV1, ResNetV2, BasicBlockV1,  # noqa: F401
                     BasicBlockV2, BottleneckV1, BottleneckV2, get_resnet,
                     resnet18_v1, resnet34_v1, resnet50_v1, resnet101_v1,
                     resnet152_v1, resnet18_v2, resnet34_v2, resnet50_v2,
                     resnet101_v2, resnet152_v2)

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1,
    "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2,
    "resnet50_v2": resnet50_v2, "resnet101_v2": resnet101_v2,
    "resnet152_v2": resnet152_v2,
}


def get_model(name, **kwargs):
    """A model by name (reference ``get_model``†); the ported names are
    the ResNets'."""
    name = name.lower()
    if name not in _models:
        raise MXNetError(
            f"unknown model {name!r}; choices: {sorted(_models)}")
    return _models[name](**kwargs)
