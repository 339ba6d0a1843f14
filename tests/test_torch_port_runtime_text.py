"""The port's tokenizer and positive maps against the JAX package's.

Token ids, attention masks, every character's `char_to_token` and the
positive maps must be bit-equal with the JAX package on
tests/test_clip_bpe.py's SENTENCES (unicode included), with a vocabulary
that `train_bpe` builds offline and with the hash fallback.

The JAX package splits words with the `regex` module's pattern; the port
(whose card host has no `regex`) scans with `unicodedata` categories
(`data/clip_bpe.py::split_words`). Its classes are checked against
`regex`'s over every code point, and its split against `regex`'s on
random unicode text. The two Unicode databases differ on code points
assigned after Python's (15.0): those are left out of both checks,
since a category the port's Python cannot know is not a fault of the
split.
"""
import unicodedata

import numpy as np
import pytest
import regex
from hypothesis import given, settings, strategies as st

from proxytransformation_tpu.data import clip_bpe as jbpe
from proxytransformation_tpu.models import text_encoder as jtext
from proxytransformation_torch.data import clip_bpe as tbpe
from proxytransformation_torch.models import text_encoder as ttext

from test_clip_bpe import CORPUS, SENTENCES

# the split's three classes as the JAX pattern writes them
_REGEX_CLASS = {
    'L': regex.compile(r'[\p{L}]', regex.IGNORECASE),
    'N': regex.compile(r'[\p{N}]', regex.IGNORECASE),
    'O': regex.compile(r'[^\s\p{L}\p{N}]', regex.IGNORECASE),
}
_REGEX_ASSIGNED = regex.compile(r'[^\p{Cn}\p{Cs}]')


def _known_to_both(ch: str) -> bool:
    """A code point both Unicode databases assign (and not a surrogate)."""
    return (unicodedata.category(ch) not in ('Cn', 'Cs')
            and bool(_REGEX_ASSIGNED.match(ch)))


@pytest.fixture(scope='module')
def vocab_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp('clipvocab')
    vocab, merges = jbpe.train_bpe(CORPUS, n_merges=200)
    jbpe.save_vocab(vocab, merges, str(d / 'vocab.json'),
                    str(d / 'merges.txt'))
    return d


def test_train_bpe_matches_jax():
    assert tbpe.train_bpe(CORPUS, n_merges=200) == \
        jbpe.train_bpe(CORPUS, n_merges=200)


def _positive_spans(text):
    """Character spans of every word of `text` and of two words at once,
    the way a grounding annotation marks the target's name."""
    words = [(m.start(), m.end()) for m in regex.finditer(r'\S+', text)]
    spans = [[list(w)] for w in words]
    if len(words) > 2:
        spans.append([list(words[0]), list(words[2])])
    return spans


def _lower_keeps_length(text):
    return len(text.lower()) == len(text)


@pytest.mark.parametrize('kind', ['bpe', 'hash'])
def test_tokenizer_matches_jax(vocab_dir, kind):
    """Bit-equal outputs. The JAX hash tokenizer indexes `text.lower()` as
    if it were `text`, which fails on a sentence whose lowercase is
    longer ('İstanbul'); the port keeps each lowered character's origin,
    and those sentences are held in `test_hash_tokenizer_expanding_lower`."""
    path = str(vocab_dir) if kind == 'bpe' else None
    jtok, ttok = jtext.build_tokenizer(path), ttext.build_tokenizer(path)
    assert type(ttok).__name__ == type(jtok).__name__ == (
        'ClipBPETokenizer' if kind == 'bpe' else 'HashTokenizer')
    texts = [t for t in SENTENCES
             if kind == 'bpe' or _lower_keeps_length(t)]
    assert len(texts) >= len(SENTENCES) - 1
    want, got = jtok(texts), ttok(texts)
    np.testing.assert_array_equal(got.input_ids, want.input_ids)
    np.testing.assert_array_equal(got.attention_mask, want.attention_mask)
    assert got.input_ids.dtype == want.input_ids.dtype
    for b, text in enumerate(texts):
        for ci in range(-1, len(text) + 1):
            assert got.char_to_token(b, ci) == want.char_to_token(b, ci), \
                (text, ci)
        spans = _positive_spans(text)
        np.testing.assert_array_equal(
            ttext.create_positive_map(got, spans, b, 32),
            jtext.create_positive_map(want, spans, b, 32), err_msg=text)


def test_hash_tokenizer_expanding_lower():
    """'İ'.lower() is two characters: the JAX hash tokenizer fails there,
    the port's maps every character of the original text, and the
    words after it keep their own token."""
    text = next(t for t in SENTENCES if not _lower_keeps_length(t))
    with pytest.raises(IndexError):
        jtext.HashTokenizer()([text])
    got = ttext.HashTokenizer()([text])
    n = int(got.attention_mask[0].sum())
    shelf = text.index('shelf')
    assert {got.char_to_token(0, ci) for ci in range(shelf, len(text))} \
        == {n - 2}
    assert got.char_to_token(0, shelf - 1) is None       # the space
    assert all(got.char_to_token(0, ci) is not None
               for ci in range(shelf - 1))
    # the same words hash alike wherever they stand
    ref = ttext.HashTokenizer()(['shelf'])
    assert got.input_ids[0, n - 2] == ref.input_ids[0, 1]


def test_split_classes_match_regex():
    """Every code point both databases assign falls in the same class of
    the split (letter, number, other, or none) on both sides."""
    checked = 0
    for cp in range(0x110000):
        ch = chr(cp)
        if not _known_to_both(ch):
            continue
        want = next((c for c, pat in _REGEX_CLASS.items() if pat.match(ch)),
                    '')
        got = tbpe.char_class(ch)
        assert (got if got in 'LNO' else '') == want, (hex(cp), got, want)
        checked += 1
    assert checked > 250_000


_TEXT = st.text(st.characters(exclude_categories=('Cs', 'Cn')).filter(
    _known_to_both), max_size=40)
# the pattern's own ingredients, so specials and contractions occur
_PIECES = st.lists(st.one_of(
    _TEXT, st.sampled_from(["'s", "'T", "'re", "'VE", "'m", "'ll", "'D",
                            "'ſ", '<|startoftext|>', '<|ENDOFTEXT|>', ' ',
                            '\x1c', 'ͅ', ' ', ' ', '12',
                            'Ⅻ', '²', '_', "'"])), max_size=8)


@settings(max_examples=300, deadline=None)
@given(_PIECES)
def test_split_matches_regex(pieces):
    text = ''.join(pieces)
    want = [(m.start(), m.end()) for m in jbpe.PAT.finditer(text)]
    assert list(tbpe.split_words(text)) == want
