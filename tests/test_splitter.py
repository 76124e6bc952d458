"""Sentence splitter heuristic tests (vs slimt/Splitter.cc behavior)."""

import pytest

from slimt_jax.text.splitter import (
    SentenceStream,
    SplitMode,
    Splitter,
    _read_line,
    _read_paragraph,
    single_line,
)


@pytest.fixture
def splitter():
    s = Splitter()
    s.load_from_serialized("Mr\nDr\nProf\nNo # NUMERIC_ONLY #\netc\n")
    return s


def test_basic_split(splitter):
    assert splitter.split("Hello world. Goodbye world? Yes!") == [
        "Hello world.",
        "Goodbye world?",
        "Yes!",
    ]


def test_lowercase_no_break(splitter):
    # lowercase after the period → not a sentence boundary
    assert splitter.split("This is approx. five words.") == [
        "This is approx. five words."
    ]


def test_nonbreaking_prefix(splitter):
    assert splitter.split("Mr. Smith went home. He slept.") == [
        "Mr. Smith went home.",
        "He slept.",
    ]


def test_numeric_only_prefix(splitter):
    # "No." breaks before uppercase but not before a number
    assert splitter.split("See No. 5 for details. Next sentence.") == [
        "See No. 5 for details.",
        "Next sentence.",
    ]
    # non-NUMERIC_ONLY prefix before digit still breaks
    assert splitter.split("It was 1999. 2000 came next.") == [
        "It was 1999.",
        "2000 came next.",
    ]


def test_cjk_no_whitespace_required(splitter):
    assert splitter.split("這是一句話。這是另一句話。") == [
        "這是一句話。",
        "這是另一句話。",
    ]


def test_ellipsis_footnote_no_break(splitter):
    assert splitter.split("The text [...] continues here. Done.") == [
        "The text [...] continues here.",
        "Done.",
    ]


def test_trailing_quote(splitter):
    got = splitter.split('He said "Stop." Then he left.')
    assert got == ['He said "Stop."', "Then he left."]


def test_single_line_collapses_newlines():
    assert single_line("a\nb\n  c") == "a b c"
    assert single_line("plain") == "plain"


def test_read_line():
    line, pos = _read_line("ab\r\ncd", 0)
    assert line == "ab" and pos == 4
    line, pos = _read_line("ab\r\ncd", 4)
    assert line == "cd" and pos == 6
    line, pos = _read_line("ab\r\ncd", 6)
    assert line is None


def test_read_paragraph():
    text = "one line\nsame para\n\nnext para"
    para, pos = _read_paragraph(text, 0)
    assert para == "one line\nsame para"
    para2, pos2 = _read_paragraph(text, pos)
    assert para2 == "next para"
    assert _read_paragraph(text, pos2)[0] is None


def test_stream_sentence_mode(splitter):
    stream = SentenceStream(
        "Hello world.\nGoodbye.", splitter, SplitMode.ONE_SENTENCE_PER_LINE
    )
    got = [(s, b, e) for s, b, e in stream]
    assert [s for s, _, _ in got] == ["Hello world.", "Goodbye."]
    # spans index the original text
    text = "Hello world.\nGoodbye."
    for s, b, e in got:
        assert text[b:e] == s


def test_stream_paragraph_mode(splitter):
    text = "First one. Second one.\nNext line."
    stream = SentenceStream(text, splitter, SplitMode.ONE_PARAGRAPH_PER_LINE)
    sentences = [s for s, _, _ in stream if s]
    assert sentences == ["First one.", "Second one.", "Next line."]


def test_stream_wrapped_mode(splitter):
    text = "One. Two.\nstill same paragraph.\n\nNew paragraph here."
    stream = SentenceStream(text, splitter, SplitMode.WRAPPED_TEXT)
    sentences = [s for s, _, _ in stream if s]
    assert sentences[0] == "One."
    assert "New paragraph here." in sentences
