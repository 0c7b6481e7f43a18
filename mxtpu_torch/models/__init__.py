"""Model definitions (``mxtpu.models`` counterpart)."""
from .transformer import (BERTModel, MultiHeadAttention,  # noqa: F401
                          PositionwiseFFN, TransformerEncoder,
                          TransformerEncoderCell, bert_base, bert_large)
