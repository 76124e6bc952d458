"""Tests for annotation, spm proto, and vocabulary."""

import numpy as np
import pytest

from slimt_jax.text import spm_proto
from slimt_jax.text.annotation import AnnotatedText, Encoding, Range
from slimt_jax.text.synthetic_vocab import build_spm_model, build_vocabulary
from slimt_jax.text.vocabulary import SPACE, Vocabulary


# --- Annotation ------------------------------------------------------


def test_annotation_empty():
    a = AnnotatedText()
    assert a.sentence_count() == 0
    assert a.gap_text(0) == ""


def test_append_sentence_and_gaps():
    a = AnnotatedText()
    a.append_sentence("", ["Hello", " world"])
    a.append_sentence(" ", ["Good", "bye"])
    a.append_ending_whitespace("\n")
    assert a.text == "Hello world Goodbye\n"
    assert a.sentence_count() == 2
    assert a.sentence(0) == "Hello world"
    assert a.sentence(1) == "Goodbye"
    assert a.word(0, 0) == "Hello"
    assert a.word(0, 1) == " world"
    assert a.word(1, 1) == "bye"
    assert a.gap_text(0) == ""
    assert a.gap_text(1) == " "
    assert a.gap_text(2) == "\n"


def test_record_existing_sentence():
    text = "  One two.  "
    a = AnnotatedText(text)
    # tokens "One", " two", "." at byte offsets
    a.record_existing_sentence([(2, 5), (5, 9), (9, 10)], 2)
    assert a.sentence_count() == 1
    assert a.sentence(0) == "One two."
    assert a.gap_text(0) == "  "
    assert a.gap_text(1) == "  "
    assert a.words(0) == ["One", " two", "."]


def test_encoding_conversion():
    text = "héllo wörld"
    a = AnnotatedText(text)
    data = text.encode("utf-8")
    # tokens: "héllo" (6 bytes), " wörld" (7 bytes)
    a.record_existing_sentence([(0, 6), (6, 13)], 0)
    assert a.word(0, 0) == "héllo"
    byte_range = a.word_as_range(0, 0)
    assert byte_range == Range(0, 6)
    a.to(Encoding.UTF8)
    assert a.word_as_range(0, 0) == Range(0, 5)  # codepoints
    assert a.word(0, 0) == "héllo"
    a.to(Encoding.BYTE)
    assert a.word_as_range(0, 0) == Range(0, 6)


def test_apply_rewrites_tokens():
    a = AnnotatedText()
    a.append_sentence("", ["ab", "cd"])
    out = a.apply(lambda r, text, last: text.upper())
    assert out.text == "ABCD"
    assert out.word(0, 0) == "AB"


# --- spm proto -------------------------------------------------------


def test_spm_proto_round_trip():
    model = build_spm_model(["hello", "world"])
    blob = spm_proto.serialize_model(model)
    parsed = spm_proto.parse_model(blob)
    assert [p.piece for p in parsed.pieces] == [p.piece for p in model.pieces]
    assert parsed.eos_id == 0
    assert parsed.unk_id == 1
    assert parsed.pad_id == -1  # negative varint round-trips
    assert parsed.normalizer.add_dummy_prefix is True


# --- Vocabulary ------------------------------------------------------


@pytest.fixture(scope="module", params=["py", "hf"])
def vocab(request):
    if request.param == "py":
        return build_vocabulary(
            ["hello", "world", "test", "quick", "brown"], backend="none"
        )
    return build_vocabulary(
        ["hello", "world", "test", "quick", "brown"], backend="hf"
    )


def test_encode_known_words(vocab):
    ids, ranges = vocab.encode("hello world")
    pieces = [vocab.pieces[i].piece for i in ids]
    assert pieces == [SPACE + "hello", SPACE + "world"]
    # byte ranges tile the source line
    assert ranges[0] == (0, 5)
    assert ranges[1] == (5, 11)


def test_encode_add_eos(vocab):
    ids, ranges = vocab.encode("hello", add_eos=True)
    assert ids[-1] == vocab.eos_id
    assert len(ranges) == len(ids) - 1


def test_encode_unknown_chars_fallback(vocab):
    ids, ranges = vocab.encode("hello zzz")
    assert all(0 <= i < len(vocab) for i in ids)
    # ranges must cover the line contiguously
    assert ranges[0][0] == 0
    for (b0, e0), (b1, e1) in zip(ranges, ranges[1:]):
        assert e0 == b1
    assert ranges[-1][1] == len("hello zzz")


def test_decode_round_trip(vocab):
    ids, _ = vocab.encode("hello world test", add_eos=True)
    text, views = vocab.decode(ids)
    assert text == "hello world test"
    assert len(views) == len(ids)
    assert views[-1][0] == views[-1][1]  # EOS surfaces as empty range


def test_decode_views_tile_text(vocab):
    ids, _ = vocab.encode("quick brown test")
    text, views = vocab.decode(ids)
    rebuilt = "".join(
        text.encode("utf-8")[b:e].decode("utf-8") for b, e in views
    )
    assert rebuilt == text


def test_batch_encode_matches_single(vocab):
    lines = ["hello world", "quick brown test", ""]
    batch = vocab.encode_batch(lines, add_eos=True)
    for line, (ids, ranges) in zip(lines, batch):
        want_ids, want_ranges = vocab.encode(line, add_eos=True)
        assert ids == want_ids
        assert ranges == want_ranges


def test_py_and_hf_backends_agree():
    words = ["hello", "world", "test", "quick", "brown"]
    py = build_vocabulary(words, backend="none")
    try:
        hf = build_vocabulary(words, backend="hf")
    except Exception:
        pytest.skip("hf tokenizers backend unavailable")
    for line in ["hello world", "a quick brown test!", "unknown zzz qq"]:
        py_ids, py_ranges = py.encode(line)
        hf_ids, hf_ranges = hf.encode(line)
        assert py_ids == hf_ids, line
        assert py_ranges == hf_ranges, line


def test_append_sentence_raw_matches_append_sentence():
    from slimt_jax.text.annotation import AnnotatedText

    cases = [
        ("", ["hello", " world"]),
        (" ", ["héllo", " wörld", ""]),
        ("\n\n", []),
        ("", ["", "a", ""]),
    ]
    a = AnnotatedText()
    b = AnnotatedText()
    for prefix, tokens in cases:
        a.append_sentence(prefix, tokens)
        data = "".join(tokens).encode("utf-8")
        ends, pos = [], 0
        for t in tokens:
            pos += len(t.encode("utf-8"))
            ends.append(pos)
        b.append_sentence_raw(prefix.encode("utf-8"), data, ends)
    a.append_ending_whitespace(" tail")
    b.append_ending_whitespace(" tail")
    assert a.data == b.data
    assert a.token_begin == b.token_begin
    assert a.gap == b.gap


def test_record_contiguous_sentence_matches_existing():
    text = "  One two.  More text  "
    a = AnnotatedText(text)
    ranges = [(2, 5), (5, 9), (9, 10)]
    a.record_existing_sentence(ranges + [(10, 10)], 2)  # zero-width EOS
    a.record_existing_sentence([(12, 16), (16, 21), (21, 21)], 12)

    b = AnnotatedText(text)
    b.record_contiguous_sentence([r[0] for r in ranges], 10)
    b.record_contiguous_sentence([12, 16], 21)

    assert a.token_begin == b.token_begin
    assert a.gap == b.gap
    assert a.data == b.data
    assert [b.sentence(i) for i in range(2)] == ["One two.", "More text"]
    assert b.gap_text(1) == "  "


@pytest.mark.parametrize("backend", ["none", "hf"])
def test_encode_batch_begins_matches_encode_batch(backend):
    words = ["hello", "world", "test", "quick", "brown"]
    try:
        vocab = build_vocabulary(words, backend=backend)
    except Exception:
        pytest.skip(f"{backend} backend unavailable")
    lines = [
        "hello world test",
        "héllo wörld quick",  # non-ASCII: byte offsets differ from chars
        "",
        "brown",
        "a b  c",
    ]
    full = vocab.encode_batch(lines)
    fast = vocab.encode_batch_begins(lines)
    for (ids, ranges), (fids, begins, end) in zip(full, fast):
        assert list(ids) == list(fids)
        assert begins == [b for b, _ in ranges]
        assert end == (ranges[-1][1] if ranges else 0)


def test_from_arrays_lazy_concurrent_first_access():
    """Lazy materialization (AnnotatedText.from_arrays) must be safe
    under concurrent first access: materialization is idempotent and
    _lazy is only dropped after all three attributes are set."""
    import sys
    import threading

    import numpy as np

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(200):
            a = AnnotatedText.from_arrays(
                b"hello world",
                np.array([0, 5, 6, 11, 11], np.int64),
                np.array([0, 1], np.int64),
            )
            errors = []
            barrier = threading.Barrier(8)

            def read(attr):
                barrier.wait()
                try:
                    getattr(a, attr)
                except Exception as e:  # pragma: no cover
                    errors.append(e)

            threads = [
                threading.Thread(
                    target=read, args=(("token_begin", "gap", "_data")[i % 3],)
                )
                for i in range(8)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert not errors, errors
            assert a.token_begin == [0, 5, 6, 11, 11]
            assert a.gap == [0, 1]
            assert a.data == b"hello world"
            assert "_lazy" not in a.__dict__
    finally:
        sys.setswitchinterval(saved)
