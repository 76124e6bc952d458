"""Native C++ host library parity tests (vs pure-Python backend)."""

import numpy as np
import pytest

from slimt_jax import native
from slimt_jax.io.shortlist import hash_words as py_hash_words
from slimt_jax.text.synthetic_vocab import build_vocabulary

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable"
)

WORDS = ["hello", "world", "test", "quick", "brown", "héllo"]

LINES = [
    "hello world",
    "a quick brown test!",
    "unknown zzz qq",
    "  spaces   collapse  ",
    "héllo wörld",
    "",
    "punctuation, works. fine?",
]


@pytest.fixture(scope="module")
def py_vocab():
    return build_vocabulary(WORDS, backend="none")


@pytest.fixture(scope="module")
def native_vocab():
    return build_vocabulary(WORDS, backend="native")


def test_hash_words_matches_python():
    words = [3, 1, 4, 1, 5, 9, 2, 6]
    assert native.hash_words(0, words) == py_hash_words(words)
    assert native.hash_words(7, []) == 7


def test_encode_parity(py_vocab, native_vocab):
    for line in LINES:
        py_ids, py_ranges = py_vocab.encode(line)
        nat_ids, nat_ranges = native_vocab.encode(line)
        assert nat_ids == py_ids, line
        assert nat_ranges == py_ranges, line


def test_decode_parity(py_vocab, native_vocab):
    for line in LINES:
        ids, _ = py_vocab.encode(line, add_eos=True)
        py_text, py_ranges = py_vocab.decode(ids)
        nat_text, nat_ranges = native_vocab.decode(ids)
        assert nat_text == py_text, line
        assert nat_ranges == py_ranges, line


def test_decode_ignore_eos_parity(py_vocab, native_vocab):
    ids, _ = py_vocab.encode("hello world", add_eos=True)
    py_text, py_ranges = py_vocab.decode(ids, ignore_eos=True)
    nat_text, nat_ranges = native_vocab.decode(ids, ignore_eos=True)
    assert nat_text == py_text
    assert nat_ranges == py_ranges


def test_encode_speed_sanity(native_vocab):
    # not a benchmark — just ensure it handles a long line
    line = "hello world test " * 200
    ids, ranges = native_vocab.encode(line)
    assert len(ids) > 500
    # final range extends to end-of-line (stripped trailing whitespace
    # folds into the last token's span, matching the python backend)
    assert ranges[-1][1] == len(line.encode("utf-8"))


def test_decode_batch_parity(py_vocab, native_vocab):
    """decode_batch == N decode calls, native == python fallback."""
    segments = []
    for line in LINES:
        ids, _ = py_vocab.encode(line, add_eos=True)
        segments.append(ids)
    segments.append([])  # empty segment edge case
    nat = native_vocab.decode_batch(segments)
    py = py_vocab.decode_batch(segments)
    assert len(nat) == len(py) == len(segments)
    for ids, (nd, ne), (pd, pe) in zip(segments, nat, py):
        assert nd == pd
        assert list(ne) == list(pe)
        # cross-check against the per-call decode contract
        text, ranges = native_vocab.decode(ids)
        assert nd == text.encode("utf-8")
        assert list(ne) == [e for _, e in ranges]


def test_decode_batch_empty():
    vocab = build_vocabulary(WORDS, backend="native")
    assert vocab.decode_batch([]) == []


def test_decode_leading_unk_parity(py_vocab, native_vocab):
    """unk_surface participates in the leading-space strip (matches
    the HF/sentencepiece decoder): a leading <unk> must not keep its
    space or eat the next word's."""
    ids, _ = py_vocab.encode("hello")
    seq = [1] + ids  # synthetic vocab: id 1 is <unk>
    assert py_vocab.decode(seq) == native_vocab.decode(seq)
    text, _ranges = py_vocab.decode(seq)
    assert not text.startswith(" ")
