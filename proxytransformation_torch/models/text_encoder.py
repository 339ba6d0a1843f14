"""CLIP text tower (HF `CLIPTextModel` layout, `last_hidden_state`).

Counterpart of proxytransformation_tpu/models/text_encoder.py::
CLIPTextEncoder: token + position embeddings, pre-LN blocks with causal
and padding attention and quick-GELU MLPs, final LayerNorm. LayerNorms
use the JAX package's epsilon (1e-6). The tokenizer is not part of this
module: it takes `input_ids` directly.
"""
from __future__ import annotations

import torch
from torch import nn

from .layers import linear
from .norms import layer_norm


class _Attention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = linear(width, width)
        self.k_proj = linear(width, width)
        self.v_proj = linear(width, width)
        self.out_proj = linear(width, width)

    def forward(self, x, mask):
        B, L, C = x.shape
        hd = C // self.heads

        def split(t):
            return t.reshape(B, L, self.heads, hd).transpose(1, 2)

        q = split(self.q_proj(x) * hd ** -0.5)
        k, v = split(self.k_proj(x)), split(self.v_proj(x))
        attn = torch.softmax(q @ k.transpose(-1, -2) + mask, dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(B, L, C)
        return self.out_proj(out)


class _MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.fc1 = linear(width, width * 4)
        self.fc2 = linear(width * 4, width)

    def forward(self, x):
        h = self.fc1(x)
        return self.fc2(h * torch.sigmoid(1.702 * h))


class _Block(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.layer_norm1 = layer_norm(width)
        self.self_attn = _Attention(width, heads)
        self.layer_norm2 = layer_norm(width)
        self.mlp = _MLP(width)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, vocab_size: int, width: int, max_positions: int):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.position_embedding = nn.Embedding(max_positions, width)
        nn.init.zeros_(self.token_embedding.weight)
        nn.init.zeros_(self.position_embedding.weight)


class _Encoder(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.layers = nn.ModuleList(_Block(width, heads)
                                    for _ in range(layers))


class _TextModel(nn.Module):
    def __init__(self, vocab_size, width, layers, heads, max_positions):
        super().__init__()
        self.embeddings = _Embeddings(vocab_size, width, max_positions)
        self.encoder = _Encoder(width, layers, heads)
        self.final_layer_norm = layer_norm(width)


class CLIPTextEncoder(nn.Module):
    """(B, L) token ids + (B, L) attention mask → (B, L, width)."""

    def __init__(self, vocab_size: int = 49408, width: int = 768,
                 layers: int = 12, heads: int = 12, max_positions: int = 77):
        super().__init__()
        self.text_model = _TextModel(vocab_size, width, layers, heads,
                                     max_positions)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        tm = self.text_model
        L = input_ids.shape[1]
        x = (tm.embeddings.token_embedding(input_ids.long())
             + tm.embeddings.position_embedding.weight[None, :L])
        dev = x.device
        causal = torch.triu(torch.full((L, L), -1e9, device=dev), diagonal=1)
        pad = torch.where(attention_mask.bool()[:, None, None, :],
                          torch.zeros((), device=dev),
                          torch.full((), -1e9, device=dev))
        mask = causal[None, None] + pad
        for layer in tm.encoder.layers:
            x = layer(x, mask)
        return tm.final_layer_norm(x)
