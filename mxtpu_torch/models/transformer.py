"""The Transformer and BERT families as HybridBlocks (the counterpart
of ``mxtpu/models/transformer.py``): ``MultiHeadAttention``,
``PositionwiseFFN``, the encoder and decoder cells and stacks,
``TransformerModel`` (the seq2seq translation model), ``BERTModel`` and
the factories ``bert_base``, ``bert_large``, ``transformer_encoder``,
``transformer_base`` and ``transformer_big``, with mxtpu's children, so
their parameters carry mxtpu's names in mxtpu's order
(``bertmodel0_pos_embed``, ``embedding0_weight``, ...).

Attention runs on the ``flash_attention`` op (the flash-attention
kernels), the post-LN epilogues on ``FusedResidualLayerNorm`` and the
embedding LayerNorm on ``LayerNorm`` (their kernels, forward and
backward); the dense products are the ``FullyConnected`` op, as the JAX
package leaves them to XLA.  The position table is cut to the
sequence with ``slice_like``, so an exported BERT takes any T up to
``max_length``.

``net(tokens, step, cache)`` is the incremental decode that
``mxtpu_torch.serving.generate`` serves (a ``causal=True`` BERT): the T
new tokens of each lane at positions ``step_b + t``, their keys and
values written into the lane's cache (``kv_cache_write``) and attended
with ``cached_attention``; it returns ``(logits, new_cache)``, the
cache ``kv_cache_spec(B, L)``-shaped.  Its graph is mxtpu's, op for op,
so the incremental ``export()`` is byte-equal to mxtpu's.

``MultiHeadAttention(x, memory)`` is cross-attention: queries from
``qkv(x)``, keys and values from ``qkv(memory)``, as mxtpu reuses the
fused weights (two full 3u-wide GEMMs, a third of the second and two
thirds of the first unused).  ``TransformerModel(src, tgt)`` embeds
both sides with the shared table and ``embed_ln``, encodes ``src`` and
decodes ``tgt`` over it; ``net(src, tgt, step, cache)`` re-encodes
``src`` and decodes the new target tokens against the decoder's
self-attention cache (``kv_cache_spec``), cross-attention recomputed
from the memory each call, as in mxtpu.

``remat=True`` sets ``set_remat`` on every encoder and decoder cell:
each cell's activations are dropped after its forward and recomputed
in the backward, with the forward's dropout masks and epilogue keys
(see :mod:`mxtpu_torch.gluon.block`).
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError
from ..gluon import nn
from ..gluon.block import HybridBlock, _is_symbol

__all__ = ["MultiHeadAttention", "PositionwiseFFN",
           "TransformerEncoderCell", "TransformerEncoder",
           "TransformerDecoderCell", "TransformerDecoder",
           "TransformerModel", "BERTModel", "bert_base", "bert_large",
           "transformer_encoder", "transformer_base",
           "transformer_big"]


class MultiHeadAttention(HybridBlock):
    """Self- or cross-attention over (N, T, C) on the fused attention
    op: a second input (``memory``) makes it cross-attention, queries
    from ``x`` and keys/values from ``memory``."""

    def __init__(self, units, num_heads, dropout=0.0, causal=False,
                 proj_bias=True, **kwargs):
        super().__init__(**kwargs)
        if units % num_heads:
            raise MXNetError(f"units {units} not divisible by "
                             f"num_heads {num_heads}")
        self._units = units
        self._heads = num_heads
        self._causal = causal
        self.qkv = nn.Dense(3 * units, flatten=False, use_bias=True)
        # proj_bias=False when a FusedResidualLayerNorm epilogue folds
        # the output bias (and dropout) into its kernel
        self.proj = nn.Dense(units, flatten=False, use_bias=proj_bias)
        self.drop = nn.Dropout(dropout) if dropout else None

    def _split_heads(self, F, t):
        # (N, T, u) -> (N, h, T, u/h)
        t = F.reshape(t, shape=(0, -1, self._heads,
                                self._units // self._heads))
        return F.transpose(t, axes=(0, 2, 1, 3))

    def _qkv(self, F, x, memory=None):
        u = self._units
        qkv = self.qkv(x)
        # cross-attention: the q rows project x, the kv rows memory
        kv = qkv if memory is None else self.qkv(memory)
        if _is_symbol(qkv):
            # mxtpu's graph: three slice_axis
            parts = [F.slice_axis(kv if i else qkv, axis=-1, begin=i * u,
                                  end=(i + 1) * u) for i in range(3)]
        else:
            # the same slices as splits, whose backward writes each
            # GEMM's gradient once (each slice_axis backward writes all
            # of it, and adds sum the slices)
            parts = qkv.split(u, dim=-1)
            if memory is not None:
                parts = (parts[0],) + kv.split(u, dim=-1)[1:]
        return [self._split_heads(F, t) for t in parts]

    def _project(self, F, out):
        out = F.reshape(F.transpose(out, axes=(0, 2, 1, 3)),
                        shape=(0, -1, self._units))
        out = self.proj(out)
        if self.drop is not None:
            out = self.drop(out)
        return out

    def hybrid_forward(self, F, x, *args):
        if len(args) == 2:
            # incremental decode: x holds the T new tokens, cache is
            # (2, B, H, L, u/h) [k; v] and step (B,) each lane's write
            # frontier; returns (out, new_cache)
            step, cache = args
            q, k, v = self._qkv(F, x)
            k_cache = F.squeeze(
                F.slice_axis(cache, axis=0, begin=0, end=1), axis=0)
            v_cache = F.squeeze(
                F.slice_axis(cache, axis=0, begin=1, end=2), axis=0)
            k_cache = F.kv_cache_write(k_cache, k, step)
            v_cache = F.kv_cache_write(v_cache, v, step)
            out = F.cached_attention(q, k_cache, v_cache, step)
            return self._project(F, out), F.stack(k_cache, v_cache, axis=0)
        q, k, v = self._qkv(F, x, args[0] if args else None)
        return self._project(
            F, F.flash_attention(q, k, v, causal=self._causal))


class PositionwiseFFN(HybridBlock):
    """Dense → gelu → Dense (the transformer MLP)."""

    def __init__(self, units, hidden_size, dropout=0.0, out_bias=True,
                 **kwargs):
        super().__init__(**kwargs)
        self.ffn1 = nn.Dense(hidden_size, flatten=False)
        self.ffn2 = nn.Dense(units, flatten=False, use_bias=out_bias)
        self.drop = nn.Dropout(dropout) if dropout else None

    def hybrid_forward(self, F, x):
        out = self.ffn2(F.LeakyReLU(self.ffn1(x), act_type="gelu"))
        if self.drop is not None:
            out = self.drop(out)
        return out


class TransformerEncoderCell(HybridBlock):
    """Post-LN encoder layer (BERT convention): LN(x + attn),
    LN(x + ffn), each epilogue one fused op that also applies the
    sub-block's output bias and dropout."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 causal=False, **kwargs):
        super().__init__(**kwargs)
        self.attn = MultiHeadAttention(units, num_heads, 0.0, causal,
                                       proj_bias=False)
        self.ffn = PositionwiseFFN(units, hidden_size, 0.0,
                                   out_bias=False)
        self.ln1 = nn.FusedResidualLayerNorm(dropout)
        self.ln2 = nn.FusedResidualLayerNorm(dropout)

    def hybrid_forward(self, F, x, *args):
        if args:
            step, cache = args
            a, cache = self.attn(x, step, cache)
            x = self.ln1(a, x)
            return self.ln2(self.ffn(x), x), cache
        x = self.ln1(self.attn(x), x)
        return self.ln2(self.ffn(x), x)


class TransformerEncoder(HybridBlock):
    """Stack of encoder cells."""

    def __init__(self, num_layers, units, hidden_size, num_heads,
                 dropout=0.0, causal=False, remat=False, **kwargs):
        super().__init__(**kwargs)
        self.layers = nn.HybridSequential()
        for _ in range(num_layers):
            self.layers.add(TransformerEncoderCell(
                units, hidden_size, num_heads, dropout,
                causal).set_remat(remat))

    def hybrid_forward(self, F, x, *args):
        if args:
            # incremental: cache is (num_layers, 2, B, H, L, u/h), a
            # static slice of it a layer
            step, cache = args
            outs = []
            for i, cell in enumerate(self.layers):
                c = F.squeeze(F.slice_axis(cache, axis=0, begin=i,
                                           end=i + 1), axis=0)
                x, c = cell(x, step, c)
                outs.append(c)
            return x, F.stack(*outs, axis=0)
        return self.layers(x)


class TransformerDecoderCell(HybridBlock):
    """Post-LN decoder layer: causal self-attention, cross-attention
    over the encoder memory and the FFN, each closed by a fused
    residual LayerNorm epilogue."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 **kwargs):
        super().__init__(**kwargs)
        self.self_attn = MultiHeadAttention(units, num_heads, 0.0,
                                            causal=True, proj_bias=False)
        self.cross_attn = MultiHeadAttention(units, num_heads, 0.0,
                                             proj_bias=False)
        self.ffn = PositionwiseFFN(units, hidden_size, 0.0,
                                   out_bias=False)
        self.ln1 = nn.FusedResidualLayerNorm(dropout)
        self.ln2 = nn.FusedResidualLayerNorm(dropout)
        self.ln3 = nn.FusedResidualLayerNorm(dropout)

    def hybrid_forward(self, F, x, memory, *args):
        if args:
            # incremental: only self-attention is cached; cross-attention
            # is recomputed from the fixed memory at each call
            step, cache = args
            a, cache = self.self_attn(x, step, cache)
            x = self.ln1(a, x)
            x = self.ln2(self.cross_attn(x, memory), x)
            return self.ln3(self.ffn(x), x), cache
        x = self.ln1(self.self_attn(x), x)
        x = self.ln2(self.cross_attn(x, memory), x)
        return self.ln3(self.ffn(x), x)


class TransformerDecoder(HybridBlock):
    """Stack of decoder cells, the memory threaded to every layer."""

    def __init__(self, num_layers, units, hidden_size, num_heads,
                 dropout=0.0, remat=False, **kwargs):
        super().__init__(**kwargs)
        self.layers = nn.HybridSequential()
        for _ in range(num_layers):
            self.layers.add(TransformerDecoderCell(
                units, hidden_size, num_heads, dropout).set_remat(remat))

    def hybrid_forward(self, F, x, memory, *args):
        if args:
            # incremental: cache is (num_layers, 2, B, H, L, u/h), a
            # static slice of it a layer
            step, cache = args
            outs = []
            for i, cell in enumerate(self.layers):
                c = F.squeeze(F.slice_axis(cache, axis=0, begin=i,
                                           end=i + 1), axis=0)
                x, c = cell(x, memory, step, c)
                outs.append(c)
            return x, F.stack(*outs, axis=0)
        for cell in self.layers:
            x = cell(x, memory)
        return x


class TransformerModel(HybridBlock):
    """Encoder-decoder transformer for translation (the WMT
    configuration): one embedding table shared by source and target,
    learned positions, a shared ``embed_ln``, and an output projection
    of its own.  ``net(src, tgt)`` takes (N, Ts) and (N, Tt) ids (float
    ids truncate) and gives (N, Tt, vocab) logits."""

    def __init__(self, vocab_size, units=1024, hidden_size=4096,
                 num_layers=6, num_heads=16, max_length=256,
                 dropout=0.1, remat=False, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._num_layers = num_layers
        self._num_heads = num_heads
        self._max_length = max_length
        self.embed = nn.Embedding(vocab_size, units)
        self.pos_embed = self.params.get(
            "pos_embed", shape=(max_length, units), init="normal")
        self.embed_ln = nn.LayerNorm()
        self.drop = nn.Dropout(dropout) if dropout else None
        self.encoder = TransformerEncoder(num_layers, units, hidden_size,
                                          num_heads, dropout, remat=remat)
        self.decoder = TransformerDecoder(num_layers, units, hidden_size,
                                          num_heads, dropout, remat=remat)
        self.out_proj = nn.Dense(vocab_size, flatten=False)

    def _check_length(self, tokens, side):
        if not _is_symbol(tokens) and tokens.shape[1] > self._max_length:
            raise MXNetError(f"{side} length {tokens.shape[1]} exceeds "
                             f"max_length {self._max_length}")

    def _embed(self, F, tokens, pos_embed):
        x = self.embed(tokens) * float(np.sqrt(self._units))
        # slice_like, not a static-T slice_axis: an exported graph runs
        # for any length up to max_length
        pe = F.slice_like(F.expand_dims(pos_embed, axis=0), x, axes=(1,))
        x = self.embed_ln(x + pe)
        if self.drop is not None:
            x = self.drop(x)
        return x

    def _embed_at(self, F, tokens, step, pos_embed, scale):
        """The embedding for incremental decode: token t of lane b sits
        at position ``step_b + t``, gathered from the table (``take``)."""
        x = self.embed(tokens) if scale is None else \
            self.embed(tokens) * scale
        # an op with no inputs: eagerly it is told the device
        ar = F._arange(start=0, stop=self._max_length) \
            if _is_symbol(x) else \
            F._arange(start=0, stop=self._max_length, ctx=x.device)
        pos = F.slice_like(F.expand_dims(ar, axis=0), x, axes=(1,))
        pos = F.broadcast_add(pos, F.expand_dims(step, axis=1))
        x = self.embed_ln(x + F.take(pos_embed, pos, axis=0))
        if self.drop is not None:
            x = self.drop(x)
        return x

    def kv_cache_spec(self, batch_size, max_len=None):
        """Shape of the stacked decoder self-attention KV cache this
        model consumes/returns in incremental mode."""
        L = self._max_length if max_len is None else int(max_len)
        return (self._num_layers, 2, int(batch_size), self._num_heads,
                L, self._units // self._num_heads)

    def hybrid_forward(self, F, src, tgt, *args, pos_embed=None):
        self._check_length(src, "source")
        if args:
            # incremental decode: (src, tgt_new, step, cache); the
            # encoder runs in full on src each call, the decoder
            # consumes and returns its per-layer KV state
            step, cache = args
            memory = self.encoder(self._embed(F, src, pos_embed))
            x = self._embed_at(F, tgt, step, pos_embed,
                               float(np.sqrt(self._units)))
            dec, cache = self.decoder(x, memory, step, cache)
            return self.out_proj(dec), cache
        self._check_length(tgt, "target")
        memory = self.encoder(self._embed(F, src, pos_embed))
        dec = self.decoder(self._embed(F, tgt, pos_embed), memory)
        return self.out_proj(dec)


class BERTModel(HybridBlock):
    """BERT-style encoder LM: token + position (+ type) embeddings, the
    encoder stack and the MLM head.  ``net(tokens, token_types=None)``
    takes (N, T) ids (float ids truncate) and gives (N, T, vocab)
    logits."""

    def __init__(self, vocab_size, units, hidden_size, num_layers,
                 num_heads, max_length=512, dropout=0.1,
                 use_token_type=True, causal=False, remat=False,
                 **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._num_layers = num_layers
        self._num_heads = num_heads
        self._max_length = max_length
        self.word_embed = nn.Embedding(vocab_size, units)
        self.pos_embed = self.params.get(
            "pos_embed", shape=(max_length, units), init="normal")
        self.type_embed = nn.Embedding(2, units) if use_token_type \
            else None
        self.embed_ln = nn.LayerNorm()
        self.embed_drop = nn.Dropout(dropout) if dropout else None
        self.encoder = TransformerEncoder(num_layers, units, hidden_size,
                                          num_heads, dropout,
                                          causal=causal, remat=remat)
        self.mlm = nn.Dense(vocab_size, flatten=False)

    def kv_cache_spec(self, batch_size, max_len=None):
        """Shape of the stacked per-layer KV cache this model
        consumes/returns in incremental mode:
        (num_layers, 2, B, num_heads, L, units // num_heads)."""
        L = self._max_length if max_len is None else int(max_len)
        return (self._num_layers, 2, int(batch_size), self._num_heads,
                L, self._units // self._num_heads)

    def hybrid_forward(self, F, tokens, *args, pos_embed=None):
        if len(args) == 2:
            # incremental decode: (tokens, step, cache); token t of lane
            # b sits at position step_b + t, gathered from the table (no
            # token-type embedding on the generation path)
            step, cache = args
            x = self.word_embed(tokens)
            # an op with no inputs: eagerly it is told the device
            ar = F._arange(start=0, stop=self._max_length) \
                if _is_symbol(x) else \
                F._arange(start=0, stop=self._max_length, ctx=x.device)
            pos = F.slice_like(F.expand_dims(ar, axis=0), x, axes=(1,))
            pos = F.broadcast_add(pos, F.expand_dims(step, axis=1))
            x = x + F.take(pos_embed, pos, axis=0)
            x = self.embed_ln(x)
            if self.embed_drop is not None:
                x = self.embed_drop(x)
            x, cache = self.encoder(x, step, cache)
            return self.mlm(x), cache
        token_types = args[0] if args else None
        if not _is_symbol(tokens) and tokens.shape[1] > self._max_length:
            raise MXNetError(f"sequence length {tokens.shape[1]} exceeds "
                             f"max_length {self._max_length}")
        x = self.word_embed(tokens)
        # slice_like, not a static-T slice_axis: an exported graph runs
        # for any sequence length up to max_length
        pe = F.slice_like(F.expand_dims(pos_embed, axis=0), x, axes=(1,))
        x = x + pe
        if self.type_embed is not None and token_types is not None:
            x = x + self.type_embed(token_types)
        x = self.embed_ln(x)
        if self.embed_drop is not None:
            x = self.embed_drop(x)
        x = self.encoder(x)
        return self.mlm(x)


def bert_base(vocab_size=30522, max_length=512, dropout=0.1):
    """BERT-Base: 12 layers, 768 units, 12 heads."""
    return BERTModel(vocab_size, 768, 3072, 12, 12, max_length, dropout)


def bert_large(vocab_size=30522, max_length=512, dropout=0.1,
               remat=False):
    """BERT-Large: 24 layers, 1024 units, 4096 FFN, 16 heads."""
    return BERTModel(vocab_size, 1024, 4096, 24, 16, max_length,
                     dropout, remat=remat)


def transformer_encoder(num_layers=6, units=512, hidden_size=2048,
                        num_heads=8, dropout=0.1, causal=False):
    """The Transformer-base encoder stack."""
    return TransformerEncoder(num_layers, units, hidden_size, num_heads,
                              dropout, causal)


def transformer_big(vocab_size=32768, max_length=256, dropout=0.1,
                    remat=False):
    """Transformer-big, the WMT configuration: 6+6 layers, 1024 units,
    16 heads, 4096 FFN."""
    return TransformerModel(vocab_size, 1024, 4096, 6, 16, max_length,
                            dropout, remat=remat)


def transformer_base(vocab_size=32768, max_length=256, dropout=0.1,
                     remat=False):
    """Transformer-base, the WMT configuration: 6+6 layers, 512 units,
    8 heads, 2048 FFN."""
    return TransformerModel(vocab_size, 512, 2048, 6, 8, max_length,
                            dropout, remat=remat)
