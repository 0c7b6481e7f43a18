"""BERT encoder family on PyTorch modules — the counterpart of
``mxtpu/models/transformer.py`` (full-sequence forward and its
gradients, in eval or training mode; the incremental ``(step, cache)``
decode mode is not ported yet).

Attention runs on the flash-attention kernels, the post-LN epilogues
on the fused residual-LayerNorm kernels and the embedding LayerNorm on
the LayerNorm kernels, forward and backward (autograd Functions); the
dense products stay ``torch.matmul``, as the JAX package leaves them to
XLA.  In training mode the epilogues drop out with fresh key words per
call and ``embed_drop`` draws its mask from the device's generator.
Parameter registration order matches ``mxtpu``'s ``collect_params()``
order.
"""
from __future__ import annotations

import torch
from torch import nn

from ..base import MXNetError
from ..gluon import nn as gnn
from ..kernels import flash_attention

__all__ = ["MultiHeadAttention", "PositionwiseFFN",
           "TransformerEncoderCell", "TransformerEncoder", "BERTModel",
           "bert_base", "bert_large"]


class MultiHeadAttention(nn.Module):
    """Self-attention over (N, T, C) via the fused attention kernel."""

    def __init__(self, units: int, num_heads: int, causal: bool = False,
                 proj_bias: bool = True):
        super().__init__()
        if units % num_heads:
            raise MXNetError(f"units {units} not divisible by "
                             f"num_heads {num_heads}")
        self._units = units
        self._heads = num_heads
        self._causal = causal
        self.qkv = gnn.Dense(3 * units, units, flatten=False)
        # proj_bias=False when a FusedResidualLayerNorm epilogue folds
        # the output bias into its kernel
        self.proj = gnn.Dense(units, units, use_bias=proj_bias,
                               flatten=False)

    def _split_heads(self, t: torch.Tensor) -> torch.Tensor:
        # (N, T, u) -> (N, h, T, u/h), contiguous for the kernel
        n, T, _ = t.shape
        t = t.reshape(n, T, self._heads, self._units // self._heads)
        return t.transpose(1, 2).contiguous()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        u = self._units
        q, k, v = self.qkv(x).split(u, dim=-1)
        out = flash_attention(self._split_heads(q), self._split_heads(k),
                              self._split_heads(v), causal=self._causal)
        n, _, T, _ = out.shape
        out = out.transpose(1, 2).reshape(n, T, u)
        return self.proj(out)


class PositionwiseFFN(nn.Module):
    """Dense → gelu → Dense (the transformer MLP)."""

    def __init__(self, units: int, hidden_size: int,
                 out_bias: bool = True):
        super().__init__()
        self.ffn1 = gnn.Dense(hidden_size, units, flatten=False)
        self.ffn2 = gnn.Dense(units, hidden_size, use_bias=out_bias,
                               flatten=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ffn2(gnn.gelu(self.ffn1(x)))


class TransformerEncoderCell(nn.Module):
    """Post-LN encoder layer (BERT convention): LN(x + attn),
    LN(x + ffn), each epilogue one fused kernel that also applies the
    sub-block's output bias and dropout."""

    def __init__(self, units: int, hidden_size: int, num_heads: int,
                 dropout: float = 0.0, causal: bool = False):
        super().__init__()
        self.attn = MultiHeadAttention(units, num_heads, causal,
                                       proj_bias=False)
        self.ffn = PositionwiseFFN(units, hidden_size, out_bias=False)
        self.ln1 = gnn.FusedResidualLayerNorm(units, dropout)
        self.ln2 = gnn.FusedResidualLayerNorm(units, dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ln1(self.attn(x), x)
        return self.ln2(self.ffn(x), x)


class TransformerEncoder(nn.Module):
    """Stack of encoder cells."""

    def __init__(self, num_layers: int, units: int, hidden_size: int,
                 num_heads: int, dropout: float = 0.0,
                 causal: bool = False):
        super().__init__()
        self.layers = gnn.HybridSequential()
        for _ in range(num_layers):
            self.layers.add(TransformerEncoderCell(
                units, hidden_size, num_heads, dropout, causal))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x)


class BERTModel(nn.Module):
    """BERT-style encoder LM: token + position (+ type) embeddings,
    encoder stack, MLM head.  ``forward(tokens, token_types=None)``
    takes (N, T) ids (float ids are truncated) and returns (N, T, vocab)
    logits."""

    def __init__(self, vocab_size: int, units: int, hidden_size: int,
                 num_layers: int, num_heads: int, max_length: int = 512,
                 dropout: float = 0.1, use_token_type: bool = True,
                 causal: bool = False):
        super().__init__()
        self._units = units
        self._num_layers = num_layers
        self._num_heads = num_heads
        self._max_length = max_length
        self.pos_embed = nn.Parameter(torch.empty(max_length, units))
        nn.init.normal_(self.pos_embed, std=0.02)
        self.word_embed = gnn.Embedding(vocab_size, units)
        self.type_embed = gnn.Embedding(2, units) \
            if use_token_type else None
        self.embed_ln = gnn.LayerNorm(units)
        self.embed_drop = gnn.Dropout(dropout) if dropout else None
        self.encoder = TransformerEncoder(num_layers, units, hidden_size,
                                          num_heads, dropout, causal)
        self.mlm = gnn.Dense(vocab_size, units, flatten=False)

    def forward(self, tokens: torch.Tensor,
                token_types: torch.Tensor = None) -> torch.Tensor:
        T = tokens.shape[1]
        if T > self._max_length:
            raise MXNetError(f"sequence length {T} exceeds max_length "
                             f"{self._max_length}")
        x = self.word_embed(tokens) + self.pos_embed[:T]
        if self.type_embed is not None and token_types is not None:
            x = x + self.type_embed(token_types)
        x = self.embed_ln(x)
        if self.embed_drop is not None:
            x = self.embed_drop(x)
        return self.mlm(self.encoder(x))


def bert_base(vocab_size=30522, max_length=512, dropout=0.1):
    """BERT-Base: 12 layers, 768 units, 12 heads."""
    return BERTModel(vocab_size, 768, 3072, 12, 12, max_length, dropout)


def bert_large(vocab_size=30522, max_length=512, dropout=0.1):
    """BERT-Large: 24 layers, 1024 units, 4096 FFN, 16 heads."""
    return BERTModel(vocab_size, 1024, 4096, 24, 16, max_length, dropout)
