"""Model definitions (``mxtpu.models`` counterpart)."""
from .transformer import (BERTModel, MultiHeadAttention,  # noqa: F401
                          PositionwiseFFN, TransformerEncoder,
                          TransformerEncoderCell, bert_base, bert_large)


def resnet50(classes: int = 1000, thumbnail: bool = False):
    """ResNet-50 v1, the JAX package's ``bench_resnet50`` model
    (``mxtpu/models/__init__.py`` ``resnet50``)."""
    from ..gluon.model_zoo import vision
    return vision.get_resnet(1, 50, thumbnail=thumbnail, classes=classes)
