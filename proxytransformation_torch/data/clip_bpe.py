r"""CLIP byte-level BPE tokenizer — pure python, offline, exact.

The port's own copy of proxytransformation_tpu/data/clip_bpe.py: the
reference's tokenization (HF `CLIPTokenizer.batch_encode_plus(texts,
padding='longest', truncation=True)`, reference
sparse_featfusion_grounder_preshape.py:641-691) without the transformers
runtime — byte→unicode mapping, the CLIP split, greedy rank-ordered BPE
merges with the `</w>` end-of-word convention, BOS/EOS framing,
longest-padding and truncation to the 77-token context, plus
`char_to_token` offsets into the original string for the positive maps.
`train_bpe` builds a vocabulary offline; `from_files` loads CLIP's
`vocab.json` + `merges.txt` where they are present.

The JAX package splits with the `regex` module's pattern
`<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|
[^\s\p{L}\p{N}]+` under IGNORECASE. `regex` is not a dependency of the
port, so `split_words` scans the text with `unicodedata` categories to
the same matches: a letter is a general category L*, a number N*;
whitespace is Unicode White_Space (`str.isspace` less U+001C-U+001F,
which `regex` counts as other); U+0345 (combining ypogegrammeni, whose
case fold is a letter) joins no class under IGNORECASE, so it is
skipped like whitespace; the contractions and special tokens match
case-insensitively through `re`.
"""
from __future__ import annotations

import collections
import functools
import json
import re
import unicodedata
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

_SPECIAL = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d""",
    re.IGNORECASE)
# code points that `str.isspace` calls whitespace and Unicode does not
_NOT_WHITE_SPACE = frozenset('\x1c\x1d\x1e\x1f')
# a combining mark that IGNORECASE keeps out of every class of the split
_NO_CLASS = '\u0345'

BOS = '<|startoftext|>'
EOS = '<|endoftext|>'


@functools.lru_cache(maxsize=1 << 16)
def char_class(ch: str) -> str:
    """'L' (letter), 'N' (number), 'S' (whitespace), 'O' (other) or ''
    (in no class) for the CLIP split."""
    if ch == _NO_CLASS:
        return ''
    cat = unicodedata.category(ch)[0]
    if cat in 'LN':
        return cat
    if ch.isspace() and ch not in _NOT_WHITE_SPACE:
        return 'S'
    return 'O'


def split_words(text: str) -> Iterator[Tuple[int, int]]:
    """(start, end) of each match of the CLIP split pattern, in order:
    a special token or contraction, else a run of letters, one number,
    or a run of other characters; whitespace separates them."""
    i, n = 0, len(text)
    while i < n:
        m = _SPECIAL.match(text, i)
        if m:
            yield m.start(), m.end()
            i = m.end()
            continue
        cls = char_class(text[i])
        if cls in ('S', ''):
            i += 1
            continue
        j = i + 1
        if cls != 'N':
            while j < n and char_class(text[j]) == cls:
                j += 1
        yield i, j
        i = j


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP reversible byte→printable-unicode table."""
    bs = (list(range(ord('!'), ord('~') + 1))
          + list(range(ord('\xa1'), ord('\xac') + 1))
          + list(range(ord('\xae'), ord('\xff') + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _is_control(ch: str) -> bool:
    if ch in ('\t', '\n', '\r'):
        return False
    return unicodedata.category(ch).startswith('C')


def _is_whitespace(ch: str) -> bool:
    if ch in (' ', '\t', '\n', '\r'):
        return True
    return unicodedata.category(ch) == 'Zs'


def _is_cjk(cp: int) -> bool:
    """HF BasicTokenizer._is_chinese_char block list."""
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


def _nfc_with_origin(chars: List[str],
                     orig: List[int]) -> Tuple[List[str], List[int]]:
    """NFC-normalize a char list, tracking per-char origins.

    The TEXT is exact by construction (verified against whole-string
    NFC); origins are tracked per combining sequence (a composed char
    inherits its sequence's first source index) and degrade to a
    monotone approximation only if an exotic script composes across our
    segment boundaries."""
    s = ''.join(chars)
    whole = unicodedata.normalize('NFC', s)
    if whole == s:
        return chars, orig
    out_c: List[str] = []
    out_o: List[int] = []
    seg: List[str] = []
    seg_o: List[int] = []

    def flush():
        if not seg:
            return
        for j, ch in enumerate(unicodedata.normalize('NFC', ''.join(seg))):
            out_c.append(ch)
            out_o.append(seg_o[min(j, len(seg_o) - 1)])
        seg.clear()
        seg_o.clear()

    for ch, o in zip(chars, orig):
        # segment starts at starters (ccc=0), except Hangul V/T jamo
        # which compose with a PRECEDING starter
        if (unicodedata.combining(ch) == 0
                and not 0x1160 <= ord(ch) <= 0x11FF):
            flush()
        seg.append(ch)
        seg_o.append(o)
    flush()
    if ''.join(out_c) != whole:  # composition crossed a boundary
        out_c = list(whole)
        out_o = [orig[min(i, len(orig) - 1)] for i in range(len(whole))]
    return out_c, out_o


def _clean_with_origin(text: str) -> Tuple[str, List[int]]:
    """HF CLIPTokenizer non-ftfy-path cleaning, tracking each output
    char's index in the ORIGINAL string for char_to_token.

    Reproduces `' '.join(BasicTokenizer(strip_accents=False,
    do_split_on_punc=False).tokenize(text))`: control-char removal, CJK
    char spacing, NFC normalization, whitespace collapse/strip, and
    per-token lowercase (including Python/Unicode's final-sigma rule).
    HF-equivalence is tested on ASCII, accented, CJK and Greek inputs
    (tests/test_clip_bpe.py). Remaining documented gap: environments
    WITH ftfy installed take `ftfy.fix_text` instead, which differs on
    mojibake/ambiguous-encoding inputs only.
    """
    # pass 1: clean + CJK spacing + whitespace collapse
    chars: List[str] = []
    orig: List[int] = []
    prev_space = True  # leading whitespace collapses away
    for i, ch in enumerate(text):
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_whitespace(ch):
            if not prev_space:
                chars.append(' ')
                orig.append(i)
            prev_space = True
            continue
        if _is_cjk(cp):
            if not prev_space:
                chars.append(' ')
                orig.append(i)
            chars.append(ch)
            orig.append(i)
            chars.append(' ')
            orig.append(i)
            prev_space = True
            continue
        prev_space = False
        chars.append(ch)
        orig.append(i)
    while chars and chars[-1] == ' ':
        chars.pop()
        orig.pop()

    # pass 2: NFC (HF normalizes before splitting; spaces are starters
    # and never compose, so collapsing first is equivalent)
    chars, orig = _nfc_with_origin(chars, orig)

    # pass 3: per-token lowercase. str.lower on the whole token applies
    # the context-sensitive final-sigma rule; per-char expansion (e.g.
    # 'İ' → 'i̇') keeps origins aligned, then token-level lower output
    # overwrites the chars when lengths agree.
    out: List[str] = []
    oorig: List[int] = []
    i, n = 0, len(chars)
    while i < n:
        if chars[i] == ' ':
            out.append(' ')
            oorig.append(orig[i])
            i += 1
            continue
        j = i
        while j < n and chars[j] != ' ':
            j += 1
        tok = chars[i:j]
        pieces = [c.lower() for c in tok]
        low = ''.join(tok).lower()
        if sum(len(p) for p in pieces) == len(low):
            pos, fixed = 0, []
            for p in pieces:
                fixed.append(low[pos:pos + len(p)])
                pos += len(p)
            pieces = fixed
        for p, o in zip(pieces, orig[i:j]):
            for lch in p:
                out.append(lch)
                oorig.append(o)
        i = j
    return ''.join(out), oorig


class ClipBPETokenizer:
    """Drop-in tokenizer for text_encoder.build_tokenizer."""

    bos_id: int
    eos_id: int
    pad_id: int = 0

    def __init__(self, vocab: Dict[str, int],
                 merges: Sequence[Tuple[str, str]], max_length: int = 77):
        self.encoder = dict(vocab)
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.max_length = max_length
        self.byte_encoder = bytes_to_unicode()
        self.bos_id = self.encoder[BOS]
        self.eos_id = self.encoder[EOS]
        self.unk_id = self.encoder[EOS]
        self._cache: Dict[str, List[str]] = {}

    # -- construction ----------------------------------------------------
    @classmethod
    def from_files(cls, vocab_json: str, merges_txt: str,
                   max_length: int = 77) -> 'ClipBPETokenizer':
        with open(vocab_json, encoding='utf-8') as f:
            vocab = json.load(f)
        with open(merges_txt, encoding='utf-8') as f:
            lines = f.read().strip().split('\n')[1:49152 - 256 - 2 + 1]
        merges = [tuple(line.split()) for line in lines]
        return cls(vocab, merges, max_length)

    # -- BPE -------------------------------------------------------------
    def _bpe(self, token: str) -> List[str]:
        """Greedy lowest-rank merges; token is a byte-unicode string."""
        if token in self._cache:
            return self._cache[token]
        word: List[str] = list(token[:-1]) + [token[-1] + '</w>']
        if len(word) == 1:
            self._cache[token] = word
            return word
        while len(word) > 1:
            pairs = [(word[i], word[i + 1]) for i in range(len(word) - 1)]
            best = min(pairs,
                       key=lambda p: self.bpe_ranks.get(p, float('inf')))
            if best not in self.bpe_ranks:
                break
            first, second = best
            new_word: List[str] = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = new_word
        self._cache[token] = word
        return word

    def _encode_word(self, token: str) -> Tuple[List[int], List[int]]:
        """Byte-encode + BPE one word of the split.

        Returns (ids, sym_nchars): for each output symbol, how many
        CLEANED characters of the token it covers (for offsets)."""
        bstr = []
        char_of_byte = []                 # byte position -> char position
        for ci, ch in enumerate(token):
            for b in ch.encode('utf-8'):
                bstr.append(self.byte_encoder[b])
                char_of_byte.append(ci)
        symbols = self._bpe(''.join(bstr))
        ids, nchars = [], []
        pos = 0
        for sym in symbols:
            ids.append(self.encoder.get(sym, self.unk_id))
            w = len(sym) - (len('</w>') if sym.endswith('</w>') else 0)
            last_char = char_of_byte[min(pos + max(w, 1) - 1,
                                         len(char_of_byte) - 1)]
            first_char = char_of_byte[min(pos, len(char_of_byte) - 1)]
            nchars.append((first_char, last_char))
            pos += w
        return ids, nchars

    # -- public API ------------------------------------------------------
    def __call__(self, texts: Sequence[str]):
        from ..models.text_encoder import TokenizedBatch
        tokenized: List[List[int]] = []
        char_maps: List[List[Optional[int]]] = []
        for text in texts:
            cleaned, orig = _clean_with_origin(text)
            ids: List[int] = [self.bos_id]
            cmap: List[Optional[int]] = [None] * len(text)
            done = False
            for start, end in split_words(cleaned):
                if done:
                    break
                tok_ids, spans = self._encode_word(cleaned[start:end])
                for tid, (c0, c1) in zip(tok_ids, spans):
                    if len(ids) >= self.max_length - 1:
                        done = True
                        break
                    for cc in range(start + c0, start + c1 + 1):
                        if cc < len(orig):
                            cmap[orig[cc]] = len(ids)
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


# --------------------------------------------------------------------------
# offline BPE training (for fixtures and custom corpora)
# --------------------------------------------------------------------------
def train_bpe(corpus: Sequence[str], n_merges: int = 512
              ) -> Tuple[Dict[str, int], List[Tuple[str, str]]]:
    """Train a CLIP-convention BPE vocabulary on a text corpus.

    Vocabulary layout mirrors CLIP: 256 byte symbols, 256 byte+'</w>'
    symbols, one token per merge, then BOS/EOS. The result loads into
    both this tokenizer and HF's CLIPTokenizer (see tests).
    """
    b2u = bytes_to_unicode()
    word_freq: collections.Counter = collections.Counter()
    for text in corpus:
        cleaned, _ = _clean_with_origin(text)
        for start, end in split_words(cleaned):
            bstr = ''.join(b2u[b] for b in cleaned[start:end].encode('utf-8'))
            word_freq[bstr] += 1

    words = {w: list(w[:-1]) + [w[-1] + '</w>'] for w in word_freq}
    merges: List[Tuple[str, str]] = []
    for _ in range(n_merges):
        pair_freq: collections.Counter = collections.Counter()
        for w, sym in words.items():
            f = word_freq[w]
            for i in range(len(sym) - 1):
                pair_freq[(sym[i], sym[i + 1])] += f
        if not pair_freq:
            break
        best, cnt = pair_freq.most_common(1)[0]
        if cnt < 2:
            break
        merges.append(best)
        first, second = best
        for w, sym in words.items():
            out, i = [], 0
            while i < len(sym):
                if (i < len(sym) - 1 and sym[i] == first
                        and sym[i + 1] == second):
                    out.append(first + second)
                    i += 2
                else:
                    out.append(sym[i])
                    i += 1
            words[w] = out

    vocab: Dict[str, int] = {}
    for ch in b2u.values():
        vocab[ch] = len(vocab)
    for ch in b2u.values():
        vocab[ch + '</w>'] = len(vocab)
    for a, b in merges:
        tok = a + b
        if tok not in vocab:
            vocab[tok] = len(vocab)
    vocab[BOS] = len(vocab)
    vocab[EOS] = len(vocab)
    return vocab, merges


def save_vocab(vocab: Dict[str, int], merges: List[Tuple[str, str]],
               vocab_json: str, merges_txt: str) -> None:
    with open(vocab_json, 'w', encoding='utf-8') as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(merges_txt, 'w', encoding='utf-8') as f:
        f.write('#version: 0.2\n')
        for a, b in merges:
            f.write(f'{a} {b}\n')
