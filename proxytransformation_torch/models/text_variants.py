"""The text-tower zoo of the reference's `t_type`, in PyTorch.

Counterpart of proxytransformation_tpu/models/text_variants.py. Every
tower shares the grounder's contract

    encoder(input_ids (B, L), attention_mask (B, L)) -> (B, L, width)

and holds its parameters under the upstream checkpoint's key names, so
the `text_encoder.*` entries of an upstream state_dict load with
`load_state_dict`, and the JAX package's converters (`convert_hf_bert_text`,
`convert_hf_t5_encoder`, `convert_open_clip_text`, `convert_hf_deberta`)
read the port's state_dict:

* `BertTextEncoder`: HF BertModel (post-LN, exact GELU, token-type
  embeddings); FLAVA's text tower is BERT-architecture and maps here.
* `RobertaTextEncoder`: the BERT body with Roberta's position ids
  (cumsum(mask)·mask + padding_idx, reference default t_type).
* `T5TextEncoder`: HF T5EncoderModel (RMSNorm, bias-free dense layers,
  bucketed relative position bias from block 0).
* `DebertaTextEncoder`: HF DebertaModel v1 (c2p + p2c disentangled
  attention over the shared `rel_embeddings`; q/k/v packed per head in
  `in_proj`).
* `OpenCLIPTextEncoder`: open_clip's text transformer as the reference
  patches it (causal mask only, exact GELU, `ln_final` token features);
  also loads the `text.`-prefixed CustomTextCLIP layout.
* HF-CLIP sizes build `text_encoder.CLIPTextEncoder`.

Every tower checks its token ids on the host (`text_encoder.TokenChecks`):
an id at or beyond its vocabulary, or a sequence longer than its
positions, raises a `ValueError` (the JAX towers return NaN rows or index
out of range; an embedding on the card would assert).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import linear
from .norms import layer_norm
from .text_encoder import CLIPTextEncoder, TokenChecks


def _strict_extra(state_dict, prefix, ignored) -> None:
    """Drop the upstream entries a tower does not use (its pooler, tied
    embeddings, index buffers) from a state_dict being loaded."""
    for k in [k for k in state_dict if k.startswith(prefix)]:
        if k[len(prefix):].startswith(ignored):
            state_dict.pop(k)


def _bert_ln(width: int) -> nn.LayerNorm:
    return nn.LayerNorm(width, eps=1e-12)


def _embedding(n: int, width: int) -> nn.Embedding:
    e = nn.Embedding(n, width)
    nn.init.zeros_(e.weight)
    return e


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, L, C) → (B, H, L, C / H)."""
    B, L, C = t.shape
    return t.reshape(B, L, heads, C // heads).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    """(B, H, L, d) → (B, L, H·d)."""
    B, H, L, d = t.shape
    return t.transpose(1, 2).reshape(B, L, H * d)


def _pad_bias(mask: torch.Tensor) -> torch.Tensor:
    """(B, L) mask → (B, 1, 1, L) additive bias: 0 where valid, -1e9."""
    z = torch.zeros((), device=mask.device)
    return torch.where(mask.bool()[:, None, None, :], z,
                       torch.full((), -1e9, device=mask.device))


# --------------------------------------------------------------------------
# BERT / Roberta / FLAVA
# --------------------------------------------------------------------------
class _BertSelf(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.query = linear(width, width)
        self.key = linear(width, width)
        self.value = linear(width, width)


class _BertOutput(nn.Module):
    def __init__(self, c_in: int, width: int):
        super().__init__()
        self.dense = linear(c_in, width)
        self.LayerNorm = _bert_ln(width)


class _BertAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.self = _BertSelf(width)
        self.output = _BertOutput(width, width)

    def forward(self, x, bias):
        s = self.self
        hd = x.shape[-1] // self.heads
        q = _heads(s.query(x) * hd ** -0.5, self.heads)
        k, v = _heads(s.key(x), self.heads), _heads(s.value(x), self.heads)
        attn = torch.softmax(q @ k.transpose(-1, -2) + bias, dim=-1)
        a = self.output.dense(_merge(attn @ v))
        return self.output.LayerNorm(x + a)


class _BertIntermediate(nn.Module):
    def __init__(self, width: int, intermediate: int):
        super().__init__()
        self.dense = linear(width, intermediate)


class _BertLayer(nn.Module):
    def __init__(self, width: int, heads: int, intermediate: int):
        super().__init__()
        self.attention = _BertAttention(width, heads)
        self.intermediate = _BertIntermediate(width, intermediate)
        self.output = _BertOutput(intermediate, width)

    def forward(self, x, bias):
        x = self.attention(x, bias)
        h = F.gelu(self.intermediate.dense(x))
        return self.output.LayerNorm(x + self.output.dense(h))


class _BertEmbeddings(nn.Module):
    def __init__(self, vocab_size, width, max_positions, type_vocab_size):
        super().__init__()
        self.word_embeddings = _embedding(vocab_size, width)
        self.position_embeddings = _embedding(max_positions, width)
        self.token_type_embeddings = _embedding(type_vocab_size, width)
        self.LayerNorm = _bert_ln(width)


class _Stack(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layer = nn.ModuleList(layers)


class BertTextEncoder(TokenChecks, nn.Module):
    """HF BertModel's `last_hidden_state` (keys `embeddings.*`,
    `encoder.layer.{i}.*`; an upstream `pooler.*` is accepted and
    unused)."""

    _ignored = ('pooler.', 'embeddings.position_ids',
                'embeddings.token_type_ids')

    def __init__(self, vocab_size: int = 30522, width: int = 768,
                 layers: int = 12, heads: int = 12, intermediate: int = 3072,
                 max_positions: int = 512, type_vocab_size: int = 2,
                 position_offset: int = 0, pad_token_id: int = 0,
                 t_type: str = 'bert-base-uncased'):
        super().__init__()
        self.vocab_size, self.width, self.heads = vocab_size, width, heads
        self.position_offset = position_offset
        self.pad_token_id = pad_token_id
        self.max_length = max_positions - position_offset
        self.t_type = t_type
        self.embeddings = _BertEmbeddings(vocab_size, width, max_positions,
                                          type_vocab_size)
        self.encoder = _Stack(_BertLayer(width, heads, intermediate)
                              for _ in range(layers))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kw):
        _strict_extra(state_dict, prefix, self._ignored)
        super()._load_from_state_dict(state_dict, prefix, *args, **kw)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        self._check_input(input_ids)
        e = self.embeddings
        L = input_ids.shape[1]
        tok = e.word_embeddings(input_ids.long())
        if self.position_offset:
            # Roberta: positions advance over valid tokens only, from
            # padding_idx + 1 (HF create_position_ids_from_input_ids)
            m = attention_mask.to(torch.int32)
            ids = torch.cumsum(m, dim=1) * m + self.position_offset - 1
            pos = e.position_embeddings.weight[ids.long()]
        else:
            pos = e.position_embeddings.weight[None, :L]
        x = e.LayerNorm(tok + pos + e.token_type_embeddings.weight[0])
        bias = _pad_bias(attention_mask)
        for layer in self.encoder.layer:
            x = layer(x, bias)
        return x


class RobertaTextEncoder(BertTextEncoder):
    """HF RobertaModel: the BERT body with offset position ids."""

    def __init__(self, vocab_size: int = 50265, width: int = 768,
                 layers: int = 12, heads: int = 12, intermediate: int = 3072,
                 max_positions: int = 514, type_vocab_size: int = 1,
                 position_offset: int = 2, pad_token_id: int = 1,
                 t_type: str = 'roberta-base'):
        super().__init__(vocab_size, width, layers, heads, intermediate,
                         max_positions, type_vocab_size, position_offset,
                         pad_token_id, t_type)


# --------------------------------------------------------------------------
# T5
# --------------------------------------------------------------------------
def t5_relative_bucket(rel_pos: np.ndarray, num_buckets: int = 32,
                       max_distance: int = 128) -> np.ndarray:
    """HF T5's bidirectional relative position bucket, in float64 numpy
    as the JAX package computes it."""
    num_buckets //= 2
    ret = (rel_pos > 0).astype(np.int32) * num_buckets
    n = np.abs(rel_pos)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact) / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)).astype(np.int32)
    large = np.minimum(large, num_buckets - 1)
    return ret + np.where(is_small, n, large)


class T5RMSNorm(nn.Module):
    """x · rsqrt(mean(x²) + 1e-6) · weight (no mean, no bias)."""

    def __init__(self, width: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(width))

    def forward(self, x):
        var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
        return x * torch.rsqrt(var + 1e-6) * self.weight


class _T5SelfAttention(nn.Module):
    def __init__(self, width: int, heads: int, buckets: Optional[int]):
        super().__init__()
        self.heads = heads
        self.q = linear(width, width, bias=False)
        self.k = linear(width, width, bias=False)
        self.v = linear(width, width, bias=False)
        self.o = linear(width, width, bias=False)
        if buckets:
            self.relative_attention_bias = _embedding(buckets, heads)


class _T5AttnLayer(nn.Module):
    def __init__(self, width, heads, buckets):
        super().__init__()
        self.SelfAttention = _T5SelfAttention(width, heads, buckets)
        self.layer_norm = T5RMSNorm(width)

    def forward(self, x, bias):
        a = self.SelfAttention
        h = self.layer_norm(x)
        q, k, v = (_heads(f(h), a.heads) for f in (a.q, a.k, a.v))
        attn = torch.softmax(q @ k.transpose(-1, -2) + bias, dim=-1)
        return x + a.o(_merge(attn @ v))


class _T5DenseReluDense(nn.Module):
    def __init__(self, width: int, d_ff: int):
        super().__init__()
        self.wi = linear(width, d_ff, bias=False)
        self.wo = linear(d_ff, width, bias=False)


class _T5FFLayer(nn.Module):
    def __init__(self, width, d_ff):
        super().__init__()
        self.DenseReluDense = _T5DenseReluDense(width, d_ff)
        self.layer_norm = T5RMSNorm(width)

    def forward(self, x):
        f = self.DenseReluDense
        return x + f.wo(torch.relu(f.wi(self.layer_norm(x))))


class _T5Block(nn.Module):
    def __init__(self, width, heads, d_ff, buckets):
        super().__init__()
        self.layer = nn.ModuleList([_T5AttnLayer(width, heads, buckets),
                                    _T5FFLayer(width, d_ff)])


class _T5Encoder(nn.Module):
    def __init__(self, width, layers, heads, d_ff, buckets):
        super().__init__()
        self.block = nn.ModuleList(
            _T5Block(width, heads, d_ff, buckets if i == 0 else None)
            for i in range(layers))
        self.final_layer_norm = T5RMSNorm(width)


class T5TextEncoder(TokenChecks, nn.Module):
    """HF T5EncoderModel's `last_hidden_state` (keys `shared.weight`,
    `encoder.block.{i}.layer.{0,1}.*`, `encoder.final_layer_norm`; the
    tied `encoder.embed_tokens.weight` is accepted and unused)."""

    _ignored = ('encoder.embed_tokens.',)

    def __init__(self, vocab_size: int = 32128, width: int = 512,
                 layers: int = 6, heads: int = 8, d_ff: int = 2048,
                 rel_buckets: int = 32, rel_max_distance: int = 128,
                 t_type: str = 't5-small'):
        super().__init__()
        self.vocab_size, self.width, self.heads = vocab_size, width, heads
        self.rel_buckets, self.rel_max_distance = rel_buckets, rel_max_distance
        self.t_type = t_type
        self.shared = _embedding(vocab_size, width)
        self.encoder = _T5Encoder(width, layers, heads, d_ff, rel_buckets)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kw):
        _strict_extra(state_dict, prefix, self._ignored)
        super()._load_from_state_dict(state_dict, prefix, *args, **kw)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        self._check_input(input_ids)
        L = input_ids.shape[1]
        x = self.shared(input_ids.long())
        rel = np.arange(L)[None, :] - np.arange(L)[:, None]  # key - query
        buckets = torch.as_tensor(
            t5_relative_bucket(rel, self.rel_buckets, self.rel_max_distance),
            device=x.device).long()
        table = self.encoder.block[0].layer[0].SelfAttention.\
            relative_attention_bias.weight
        bias = table[buckets].permute(2, 0, 1)[None] + _pad_bias(
            attention_mask)
        for block in self.encoder.block:
            x = block.layer[1](block.layer[0](x, bias))
        return self.encoder.final_layer_norm(x)


# --------------------------------------------------------------------------
# DeBERTa v1
# --------------------------------------------------------------------------
class _DisentangledSelfAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj = linear(width, 3 * width, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(width))
        self.v_bias = nn.Parameter(torch.zeros(width))
        self.pos_proj = linear(width, width, bias=False)
        self.pos_q_proj = linear(width, width)

    def forward(self, x, pad, rel_emb, max_rel):
        B, L, C = x.shape
        H = self.heads
        hd = C // H
        # HF packs q/k/v per head: head h's rows [3·h·hd, 3·(h+1)·hd)
        qkv = self.in_proj(x).reshape(B, L, H, 3, hd).permute(3, 0, 2, 1, 4)
        q = qkv[0] + self.q_bias.reshape(H, 1, hd)
        k = qkv[1]
        v = qkv[2] + self.v_bias.reshape(H, 1, hd)
        # q / sqrt(3·hd) for a compile-time constant: XLA multiplies by
        # the float32 reciprocal
        inv_scale = np.float32(1.0) / np.sqrt(np.float32(hd * 3))
        q = q * float(inv_scale)
        scores = q @ k.transpose(-1, -2)

        span = min(L, max_rel)
        rel_slice = rel_emb[max_rel - span:max_rel + span]   # (2span, C)
        ar = torch.arange(L, device=x.device)
        rel = ar[:, None] - ar[None, :]                       # i - j
        pos_key = _heads(self.pos_proj(rel_slice)[None], H)   # (1,H,2s,hd)
        c2p = q @ pos_key.transpose(-1, -2)                   # (B,H,L,2s)
        c2p_idx = torch.clamp(rel + span, 0, 2 * span - 1)
        c2p = torch.gather(c2p, -1, c2p_idx.expand(B, H, L, L))
        pos_q = _heads(self.pos_q_proj(rel_slice)[None], H) * float(inv_scale)
        p2c = k @ pos_q.transpose(-1, -2)                     # (B,H,L,2s)
        p2c_idx = torch.clamp(-rel + span, 0, 2 * span - 1)
        p2c = torch.gather(p2c, -1, p2c_idx.expand(B, H, L, L))
        scores = scores + c2p + p2c.transpose(-1, -2)
        # pads masked along both the query and the key axis
        m2 = pad[:, None, None, :] & pad[:, None, :, None]
        scores = torch.where(m2, scores, torch.full(
            (), torch.finfo(torch.float32).min, device=x.device))
        probs = torch.softmax(scores, dim=-1)
        return _merge(probs @ v)


class _DebertaAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.self = _DisentangledSelfAttention(width, heads)
        self.output = _DebertaOutput(width, width)


class _DebertaOutput(nn.Module):
    def __init__(self, c_in: int, width: int):
        super().__init__()
        self.dense = linear(c_in, width)
        self.LayerNorm = nn.LayerNorm(width, eps=1e-7)


class _DebertaLayer(nn.Module):
    def __init__(self, width: int, heads: int, intermediate: int):
        super().__init__()
        self.attention = _DebertaAttention(width, heads)
        self.intermediate = _BertIntermediate(width, intermediate)
        self.output = _DebertaOutput(intermediate, width)

    def forward(self, x, pad, rel_emb, max_rel):
        att = self.attention
        a = att.output.dense(att.self(x, pad, rel_emb, max_rel))
        x = att.output.LayerNorm(x + a)
        h = F.gelu(self.intermediate.dense(x))
        return self.output.LayerNorm(x + self.output.dense(h))


class _DebertaEmbeddings(nn.Module):
    def __init__(self, vocab_size: int, width: int):
        super().__init__()
        self.word_embeddings = _embedding(vocab_size, width)
        self.LayerNorm = nn.LayerNorm(width, eps=1e-7)


class _DebertaEncoder(_Stack):
    def __init__(self, layers, width, max_rel):
        super().__init__(layers)
        self.rel_embeddings = _embedding(2 * max_rel, width)


class DebertaTextEncoder(TokenChecks, nn.Module):
    """HF DebertaModel (v1) `last_hidden_state`: word embeddings only,
    mask-multiplied after their LayerNorm, and per-layer c2p + p2c
    relative terms against `encoder.rel_embeddings`."""

    _ignored = ('embeddings.position_ids',)

    def __init__(self, vocab_size: int = 50265, width: int = 768,
                 layers: int = 12, heads: int = 12, intermediate: int = 3072,
                 max_rel: int = 512, t_type: str = 'deberta-base'):
        super().__init__()
        self.vocab_size, self.width, self.heads = vocab_size, width, heads
        self.max_rel = max_rel
        self.t_type = t_type
        self.embeddings = _DebertaEmbeddings(vocab_size, width)
        self.encoder = _DebertaEncoder(
            [_DebertaLayer(width, heads, intermediate) for _ in range(layers)],
            width, max_rel)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kw):
        _strict_extra(state_dict, prefix, self._ignored)
        super()._load_from_state_dict(state_dict, prefix, *args, **kw)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        self._check_input(input_ids)
        pad = attention_mask.bool()
        x = self.embeddings.LayerNorm(
            self.embeddings.word_embeddings(input_ids.long()))
        x = x * pad[..., None].to(x.dtype)
        rel_emb = self.encoder.rel_embeddings.weight
        for layer in self.encoder.layer:
            x = layer(x, pad, rel_emb, self.max_rel)
        return x


# --------------------------------------------------------------------------
# open_clip towers (ViT-bigG/H-14, EVA02)
# --------------------------------------------------------------------------
class _OpenCLIPAttention(nn.Module):
    """torch MultiheadAttention's parameters (packed `in_proj_weight`
    rows [q; k; v]), computed as the JAX package's `_CLIPAttention`."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = linear(width, width)

    def forward(self, x, mask):
        C = x.shape[-1]
        hd = C // self.heads
        w, b = self.in_proj_weight, self.in_proj_bias
        q = F.linear(x, w[:C], b[:C]) * hd ** -0.5
        k = F.linear(x, w[C:2 * C], b[C:2 * C])
        v = F.linear(x, w[2 * C:], b[2 * C:])
        q, k, v = (_heads(t, self.heads) for t in (q, k, v))
        attn = torch.softmax(q @ k.transpose(-1, -2) + mask, dim=-1)
        return self.out_proj(_merge(attn @ v))


class _OpenCLIPMLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = linear(width, 4 * width)
        self.c_proj = linear(4 * width, width)


class _ResBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = layer_norm(width)
        self.attn = _OpenCLIPAttention(width, heads)
        self.ln_2 = layer_norm(width)
        self.mlp = _OpenCLIPMLP(width)

    def forward(self, x, mask):
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp.c_proj(F.gelu(self.mlp.c_fc(self.ln_2(x))))


class _Transformer(nn.Module):
    def __init__(self, width, layers, heads):
        super().__init__()
        self.resblocks = nn.ModuleList(_ResBlock(width, heads)
                                       for _ in range(layers))


class OpenCLIPTextEncoder(TokenChecks, nn.Module):
    """open_clip's TextTransformer with the reference's token-level
    patch: `ln_final` features, no pooling or projection; the attention
    mask is accepted and unused (the reference passes only the ids), so
    attention is causal only. Loads open_clip's bare layout and the
    `text.`-prefixed CustomTextCLIP one; `text_projection`, `logit_scale`
    and `attn_mask` entries are accepted and unused."""

    _ignored = ('text_projection', 'logit_scale', 'logit_bias', 'attn_mask')

    def __init__(self, vocab_size: int = 49408, width: int = 1024,
                 layers: int = 24, heads: int = 16, max_positions: int = 77,
                 t_type: str = 'vit-h-14'):
        super().__init__()
        self.vocab_size, self.width, self.heads = vocab_size, width, heads
        self.max_length = max_positions
        self.t_type = t_type
        self.token_embedding = _embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(
            torch.zeros(max_positions, width))
        self.transformer = _Transformer(width, layers, heads)
        self.ln_final = layer_norm(width)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kw):
        if any(k.startswith(prefix + 'text.token_embedding')
               for k in state_dict):
            for k in [k for k in state_dict if k.startswith(prefix + 'text.')]:
                state_dict[prefix + k[len(prefix) + 5:]] = state_dict.pop(k)
        _strict_extra(state_dict, prefix, self._ignored)
        super()._load_from_state_dict(state_dict, prefix, *args, **kw)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        self._check_input(input_ids)
        L = input_ids.shape[1]
        x = (self.token_embedding(input_ids.long())
             + self.positional_embedding[None, :L])
        causal = torch.triu(torch.full((L, L), -1e9, device=x.device),
                            diagonal=1)[None, None]
        for block in self.transformer.resblocks:
            x = block(x, causal)
        return self.ln_final(x)


# --------------------------------------------------------------------------
# t_type dispatch (JAX text_variants.py:409-472)
# --------------------------------------------------------------------------
_CLIP_SIZES = {
    # t_type fragment: (width, layers, heads)
    'clip-vit-base-patch32': (512, 12, 8),
    'clip-vit-base-patch16': (512, 12, 8),
    'clip-vit-large-patch14': (768, 12, 12),
    'clip-vit-large-patch14-336': (768, 12, 12),
}
_OPEN_CLIP_SIZES = {
    # open_clip text_cfg of ViT-bigG-14, ViT-H-14, EVA02-L-14-336,
    # EVA02-E-14-plus
    'vit-bigg-14': (1280, 32, 20),
    'vit-h-14': (1024, 24, 16),
    'eva02-l-14-336': (768, 12, 12),
    'eva02-e-14-plus': (1280, 32, 20),
}
_DEBERTA_SIZES = {
    'deberta-base': (768, 12, 12, 3072),
    'deberta-large': (1024, 24, 16, 4096),
}
_T5_SIZES = {
    't5-small': (512, 6, 8, 2048),
    't5-base': (768, 12, 12, 3072),
    't5-large': (1024, 24, 16, 4096),
}


def _sized(sizes, t, names, overrides, longest_first=False):
    """Fill `overrides` from the first size entry whose fragment is in
    t; True when one matched."""
    items = sorted(sizes.items(), key=lambda kv: -len(kv[0])) \
        if longest_first else sizes.items()
    for frag, dims in items:
        if frag in t:
            for n, d in zip(names, dims):
                overrides.setdefault(n, d)
            return True
    return False


def build_text_encoder(t_type: str = 'clip-vit-large-patch14-336',
                       **overrides) -> Tuple[nn.Module, int]:
    """t_type → (tower, feature width), the JAX package's dispatch."""
    t = t_type.lower()
    overrides.setdefault('t_type', t_type)
    if 'roberta' in t:
        enc = RobertaTextEncoder(**overrides)
    elif ('bert' in t and 'deberta' not in t) or 'flava' in t:
        # FLAVA's text tower is BERT-architecture
        enc = BertTextEncoder(**overrides)
    elif 'deberta' in t:
        _sized(_DEBERTA_SIZES, t, ('width', 'layers', 'heads',
                                   'intermediate'), overrides)
        enc = DebertaTextEncoder(**overrides)
    elif 't5' in t:
        _sized(_T5_SIZES, t, ('width', 'layers', 'heads', 'd_ff'),
               overrides)
        enc = T5TextEncoder(**overrides)
    elif _sized(_OPEN_CLIP_SIZES, t, ('width', 'layers', 'heads'),
                overrides, longest_first=True):
        enc = OpenCLIPTextEncoder(**overrides)
    elif 'clip' in t:
        _sized(_CLIP_SIZES, t, ('width', 'layers', 'heads'), overrides,
               longest_first=True)
        enc = CLIPTextEncoder(**overrides)
    else:
        raise ValueError(
            f'unknown t_type {t_type!r}; supported: roberta*, bert*, '
            f'flava*, deberta*, t5*, clip*, '
            f'{sorted(_CLIP_SIZES) + sorted(_OPEN_CLIP_SIZES)}')
    return enc, enc.width

