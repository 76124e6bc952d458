"""Precompiled charsmap normalization parity: native C++ darts
traversal vs pure-Python reader vs HF tokenizers' Precompiled, over a
synthesized darts blob (real blobs like nmt_nfkc are not downloadable
here; the builder itself is validated by HF parsing its output)."""

import pytest

from slimt_jax.text import spm_proto
from slimt_jax.text.synthetic_vocab import build_spm_model
from slimt_jax.text.vocabulary import Vocabulary

from .darts import build_charsmap

# Single-grapheme keys only: HF's Precompiled normalizes grapheme by
# grapheme (a documented quirk of its reimplementation), while
# sentencepiece — and this engine's native/python readers — use
# longest-prefix streaming. The two agree exactly on this rule shape,
# which is what real charsmaps (nmt_nfkc) contain.
RULES = {
    "½".encode(): "1/2",
    "…".encode(): "...",
    "Ａ".encode(): "A",   # fullwidth A
    "ﬁ".encode(): "fi",  # ligature, expands 3 -> 2 bytes
    " ".encode(): " ",  # nbsp -> space (interacts with ws logic)
    "x".encode(): "",    # deletion rule
}

WORDS = ["hello", "world", "fi", "test", "1/2", "A", "..."]

TEXTS = [
    "hello world",
    "½ cup",
    "wait… what",
    "ＡＢＣ test",
    "ﬁne ﬁsh",
    "non breaking space",
    "xxhello xworld",           # deletions
    "…½ﬁ mixed",
    "",
    "   ½   ",                  # ws interaction after replacement
]


def _vocab(backend):
    spm = build_spm_model(WORDS)
    spm.normalizer.precompiled_charsmap = build_charsmap(RULES)
    return Vocabulary(spm_proto.serialize_model(spm), backend=backend)


@pytest.fixture(scope="module")
def vocabs():
    out = {}
    for backend in ("none", "hf", "native"):
        try:
            out[backend] = _vocab(backend)
        except Exception:
            out[backend] = None
    if out["none"] is None:
        pytest.skip("python backend unavailable")
    return out


def test_python_charsmap_applies(vocabs):
    v = vocabs["none"]
    norm, align = v._normalize("½x…")
    # ½ -> "1/2" (3 chars), x deleted, … -> "..." + dummy prefix ▁
    assert norm == "▁1/2..."
    assert len(align) == len(norm) + 1
    assert align[-1] == len("½x…".encode())


@pytest.mark.parametrize("other", ["native", "hf"])
def test_backend_parity_with_charsmap(vocabs, other):
    if vocabs[other] is None:
        pytest.skip(f"{other} backend unavailable")
    py = vocabs["none"]
    ov = vocabs[other]
    texts = TEXTS
    if other == "hf":
        # HF quirk: leading/trailing spaces around a replaced char
        # break its internal offset composition (Precompiled + Strip),
        # dropping the Metaspace prefix — encode() returns '1','/','2'
        # while its own normalizer + pre_tokenizer report '▁1/2'.
        # sentencepiece (and this engine's py/native readers) tokenize
        # it as one piece; skip that input for the HF comparison only.
        texts = [t for t in TEXTS if t != "   ½   "]
    for text in texts:
        ids_py, ranges_py = py.encode(text)
        ids_o, ranges_o = ov.encode(text)
        assert ids_o == ids_py, (other, text, ids_o, ids_py)
        if other == "native":
            # surface alignment must agree exactly with the python
            # reader (HF aligns replacements differently in spots)
            assert ranges_o == ranges_py, (text, ranges_o, ranges_py)


def test_native_batch_matches_single_with_charsmap(vocabs):
    if vocabs["native"] is None:
        pytest.skip("native backend unavailable")
    v = vocabs["native"]
    assert v.resolved_batch_backend == "native"
    got = v.encode_batch_begins(TEXTS)
    for text, (ids, begins, end) in zip(TEXTS, got):
        ids_s, ranges_s = v.encode(text)
        assert ids == ids_s
        if ranges_s:
            assert begins == [b for b, _ in ranges_s]
            assert end == ranges_s[-1][1]


def test_ingest_lines_with_charsmap(vocabs):
    if vocabs["native"] is None:
        pytest.skip("native backend unavailable")
    from slimt_jax.text.processor import TextProcessor

    proc = TextProcessor("sentence", vocabs["native"])
    results = proc.process_batch(TEXTS, 8)
    for text, (source, segments) in zip(TEXTS, results):
        assert source.token_begin[-1] == len(source.data)
        for seg in segments:
            assert seg[-1] == vocabs["native"].eos_id
            assert len(seg) <= 8


def test_expanding_rule_capacity():
    """A 1-byte key expanding to many chars must not overflow the
    byte-based token capacity bounds (cap multiplier)."""
    spm = build_spm_model(WORDS)
    spm.normalizer.precompiled_charsmap = build_charsmap(
        {b"q": "one two three four five"}
    )
    v = Vocabulary(spm_proto.serialize_model(spm), backend="native")
    ids, ranges = v.encode("qqqqqqqq")
    ids_py, _ = Vocabulary(
        spm_proto.serialize_model(spm), backend="none"
    ).encode("qqqqqqqq")
    assert ids == ids_py
    batch = v.encode_batch_begins(["qqqqqqqq", "q"])
    assert batch[0][0] == ids
