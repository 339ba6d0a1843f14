"""CLIP text tower (HF `CLIPTextModel` layout, `last_hidden_state`).

Counterpart of proxytransformation_tpu/models/text_encoder.py::
CLIPTextEncoder: token + position embeddings, pre-LN blocks with causal
and padding attention and quick-GELU MLPs, final LayerNorm. LayerNorms
use the JAX package's epsilon (1e-6). The tower takes `input_ids`.

Also here, as in the JAX package (reference :144-279), the host-side
tokenization: `build_tokenizer` (the CLIP BPE of `data/clip_bpe.py` over
a local vocab, a local HF tokenizer where transformers is installed, else
the offline `HashTokenizer`) and `create_positive_map`, numpy only.
"""
from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .layers import linear
from .norms import layer_norm


class TokenChecks:
    """The host-side checks of a text tower's inputs (`vocab_size`,
    `max_length` (None: any length) and `t_type` are set by the tower):
    `check_ids` takes a host array, before a batch goes to the card; the
    tower's forward checks a CPU tensor itself and only the length of a
    CUDA one (a value check there would wait for the card)."""

    vocab_size: int
    max_length: Optional[int] = None
    t_type: str = ''

    def check_length(self, length: int) -> None:
        if self.max_length is not None and length > self.max_length:
            raise ValueError(
                f't_type={self.t_type!r}: {length} tokens, but the tower '
                f'takes at most {self.max_length} positions')

    def check_ids(self, input_ids) -> None:
        """Raise when a host array (numpy or a CPU tensor) of ids is
        longer than the tower's positions or holds an id outside
        [0, vocab_size)."""
        ids = np.asarray(input_ids)
        self.check_length(ids.shape[-1])
        if ids.size == 0:
            return
        lo, hi = int(ids.min()), int(ids.max())
        if lo < 0 or hi >= self.vocab_size:
            bad = hi if hi >= self.vocab_size else lo
            raise ValueError(
                f't_type={self.t_type!r}: token id {bad} (largest {hi}) is '
                f'outside the tower\'s vocabulary of {self.vocab_size}')

    def _check_input(self, input_ids: torch.Tensor) -> None:
        if input_ids.device.type == 'cpu':
            self.check_ids(input_ids.numpy())
        else:
            self.check_length(input_ids.shape[-1])


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


class CLIPTextEncoder(TokenChecks, nn.Module):
    """(B, L) token ids + (B, L) attention mask → (B, L, width)."""

    def __init__(self, vocab_size: int = 49408, width: int = 768,
                 layers: int = 12, heads: int = 12, max_positions: int = 77,
                 t_type: str = 'clip'):
        super().__init__()
        self.vocab_size, self.width, self.heads = vocab_size, width, heads
        self.max_length = max_positions
        self.t_type = t_type
        self.text_model = _TextModel(vocab_size, width, layers, heads,
                                     max_positions)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        self._check_input(input_ids)
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


# --------------------------------------------------------------------------
# host-side tokenization
# --------------------------------------------------------------------------
class TokenizedBatch:
    """Mirror of the HF BatchEncoding bits the pipeline needs."""

    def __init__(self, input_ids: np.ndarray, attention_mask: np.ndarray,
                 char_maps: List[List[Optional[int]]]):
        self.input_ids = input_ids
        self.attention_mask = attention_mask
        self._char_maps = char_maps

    def char_to_token(self, batch_idx: int, char_idx: int) -> Optional[int]:
        cm = self._char_maps[batch_idx]
        if 0 <= char_idx < len(cm):
            return cm[char_idx]
        return None


class HashTokenizer:
    """Deterministic offline tokenizer (fallback when no HF vocab files).

    Word-level split with stable FNV-1a hashing into the CLIP vocab
    range; BOS/EOS like CLIP. Preserves char→token mapping for
    positive-map construction.
    """
    bos_id = 49406
    eos_id = 49407
    pad_id = 0

    def __init__(self, vocab_size: int = 49408, max_length: int = 77):
        self.vocab_size = vocab_size
        self.max_length = max_length

    @staticmethod
    def _hash(word: str, mod: int) -> int:
        h = 2166136261
        for ch in word.encode('utf-8'):
            h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
        return 1 + h % (mod - 3)  # avoid pad/bos/eos

    @staticmethod
    def _lower_with_origin(text: str) -> Tuple[str, List[int]]:
        """text.lower() and the index in `text` of each of its characters
        (a character such as 'İ' lowers to two; the JAX package indexes
        the lowered text as if it were the original and then misplaces
        or, near the end, fails with an IndexError)."""
        low = text.lower()
        if len(low) == len(text):
            return low, list(range(len(text)))
        orig = [i for i, ch in enumerate(text) for _ in ch.lower()]
        if len(orig) != len(low):  # lower() of the whole differs per char
            orig = [min(i, len(text) - 1) for i in range(len(low))]
        return low, orig

    def __call__(self, texts: Sequence[str]) -> TokenizedBatch:
        tokenized, char_maps = [], []
        for text in texts:
            ids = [self.bos_id]
            cmap: List[Optional[int]] = [None] * len(text)
            low, orig = self._lower_with_origin(text)
            for m in re.finditer(r"\w+|[^\w\s]", low):
                tid = self._hash(m.group(0), self.vocab_size)
                if len(ids) >= self.max_length - 1:
                    break
                for ci in range(m.start(), m.end()):
                    cmap[orig[ci]] = len(ids)
                ids.append(tid)
            ids.append(self.eos_id)
            tokenized.append(ids)
            char_maps.append(cmap)
        L = max(len(t) for t in tokenized)
        input_ids = np.full((len(texts), L), self.pad_id, np.int32)
        attn = np.zeros((len(texts), L), np.int32)
        for i, t in enumerate(tokenized):
            input_ids[i, :len(t)] = t
            attn[i, :len(t)] = 1
        return TokenizedBatch(input_ids, attn, char_maps)


class HFTokenizerWrapper:
    """Wraps a HuggingFace tokenizer loaded from a local path."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer
        self.tok = AutoTokenizer.from_pretrained(path)

    def __call__(self, texts: Sequence[str]) -> TokenizedBatch:
        enc = self.tok.batch_encode_plus(list(texts), padding='longest',
                                         truncation=True, return_tensors='np')
        char_maps = []
        for i, text in enumerate(texts):
            cmap: List[Optional[int]] = []
            for ci in range(len(text)):
                try:
                    cmap.append(enc.char_to_token(i, ci))
                except Exception:
                    cmap.append(None)
            char_maps.append(cmap)
        return TokenizedBatch(np.asarray(enc['input_ids'], np.int32),
                              np.asarray(enc['attention_mask'], np.int32),
                              char_maps)


def build_tokenizer(path: Optional[str] = None):
    """Best available tokenizer for a local path.

    Preference order: our pure-python CLIP BPE (exact, offline — see
    data/clip_bpe.py) when vocab.json+merges.txt exist at `path`, then
    a HF tokenizer loaded from `path`, then the hash fallback.

    Equivalence scope: the BPE engine reproduces HF CLIPTokenizer's
    non-ftfy path exactly (incl. NFC, CJK spacing, final-sigma lower —
    HF-parity tested on unicode inputs); an environment WITH ftfy
    installed differs only on mojibake/ambiguous-encoding inputs.
    """
    if path:
        import os
        vj = os.path.join(path, 'vocab.json')
        mt = os.path.join(path, 'merges.txt')
        if os.path.exists(vj) and os.path.exists(mt):
            try:
                from ..data.clip_bpe import ClipBPETokenizer
                return ClipBPETokenizer.from_files(vj, mt)
            except Exception:
                pass
        try:
            return HFTokenizerWrapper(path)
        except Exception:
            pass
    return HashTokenizer()


def create_positive_map(tokenized: TokenizedBatch,
                        tokens_positive: Sequence[Sequence[Tuple[int, int]]],
                        batch_idx: int,
                        max_text_len: int = 256) -> np.ndarray:
    """Box→token association map (reference :796-847): positive_map[i, j]
    is 1/span for tokens j inside box i's character ranges."""
    positive_map = np.zeros((len(tokens_positive), max_text_len), np.float32)
    for j, tok_list in enumerate(tokens_positive):
        for (beg, end) in tok_list:
            beg_pos = tokenized.char_to_token(batch_idx, beg)
            end_pos = tokenized.char_to_token(batch_idx, end - 1)
            if beg_pos is None:
                beg_pos = (tokenized.char_to_token(batch_idx, beg + 1)
                           or tokenized.char_to_token(batch_idx, beg + 2))
            if end_pos is None:
                end_pos = (tokenized.char_to_token(batch_idx, end - 2)
                           or tokenized.char_to_token(batch_idx, end - 3))
            if beg_pos is None or end_pos is None:
                continue
            positive_map[j, beg_pos:end_pos + 1] = 1.0
    return positive_map / (positive_map.sum(-1, keepdims=True) + 1e-6)
