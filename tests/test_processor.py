"""TextProcessor tests: sentence → tokens → wrap → annotation."""

import pytest

from slimt_jax.text.processor import TextProcessor
from slimt_jax.text.synthetic_vocab import build_vocabulary


@pytest.fixture(scope="module")
def vocab():
    return build_vocabulary(
        ["hello", "world", "goodbye", "test", "one", "two", "three"],
        backend="none",
    )


@pytest.fixture(scope="module")
def processor(vocab):
    return TextProcessor("sentence", vocab)


def test_process_single_line(processor, vocab):
    source, segments = processor.process("hello world", wrap_length=128)
    assert len(segments) == 1
    assert segments[0][-1] == vocab.eos_id
    assert source.sentence_count() == 1
    assert source.sentence(0) == "hello world"
    # words reconstruct the sentence (incl. zero-width EOS slot)
    words = source.words(0)
    assert "".join(words) == "hello world"
    assert words[-1] == ""  # the EOS placeholder


def test_process_multi_line(processor, vocab):
    text = "hello world\ngoodbye test"
    source, segments = processor.process(text, wrap_length=128)
    assert len(segments) == 2
    assert source.sentence_count() == 2
    assert source.sentence(0) == "hello world"
    assert source.sentence(1) == "goodbye test"
    assert source.gap_text(1) == "\n"


def test_wrap_length(processor, vocab):
    # "one two three one two three" = 6 tokens; wrap_length=4 → chunks
    # of 3 tokens + EOS
    text = "one two three one two three"
    source, segments = processor.process(text, wrap_length=4)
    assert len(segments) == 2
    for seg in segments:
        assert len(seg) <= 4
        assert seg[-1] == vocab.eos_id
    assert source.sentence_count() == 2
    # both wrapped sentences reconstruct the full text
    assert (source.sentence(0) + source.sentence(1)) == text


def test_empty_lines_skipped(processor):
    source, segments = processor.process("\n\nhello\n\n", wrap_length=128)
    assert len(segments) == 1


def test_process_annotated_round(processor, vocab):
    source, segments = processor.process(
        "hello world\ngoodbye", wrap_length=128
    )
    replacement, new_segments = processor.process_annotated(source)
    assert len(new_segments) == len(segments)
    assert [s for s in new_segments] == [s for s in segments]
    assert replacement.text == source.text
    assert replacement.sentence(0) == source.sentence(0)


def test_unicode_offsets(processor, vocab):
    text = "héllo wörld"
    source, segments = processor.process(text, wrap_length=128)
    assert source.sentence_count() == 1
    assert source.sentence(0) == text


# -- native ingest parity ------------------------------------------------

NATIVE_CORPUS = [
    "",
    "   ",
    "hello world. Goodbye world? One two three!",
    "héllo wörld. Ünïcödé tests.",
    "a  b   c",
    " lead and trail ",
    ("hello world " * 80).strip(),  # forces wrap at 128 tokens
    "日本語のテスト。これはテストです。",
    "mixed 日本 ascii end",
    "Dr. Smith went to Washington. He arrived at 3 p.m. sharp.",
    "line\nwith\nnewlines",
    "tabs\tand\rcr",
    "x" * 300,  # long unknown run (merged unknowns)
]


def _generic_process_batch(proc, texts, wrap_length):
    """The pure-Python process_batch path (HF/py encode + Python wrap),
    bypassing the native ingest routing — oracle for parity."""
    from slimt_jax.text.annotation import AnnotatedText
    from slimt_jax.text.splitter import SentenceStream
    from slimt_jax.text.vocabulary import byte_prefix

    plans = []
    all_sentences = []
    for text in texts:
        source = AnnotatedText(text)
        prefix = (
            None if len(text.encode("utf-8")) == len(text)
            else byte_prefix(text)
        )
        spans = []
        for sentence, begin, _ in SentenceStream(text, proc.splitter, proc.mode):
            if not sentence:
                continue
            spans.append((sentence, begin if prefix is None else prefix[begin]))
            all_sentences.append(sentence)
        plans.append((source, spans))
    encoded = []
    for line in all_sentences:  # per-line encode (native single + _tile)
        ids, ranges = proc.vocabulary.encode(line)
        if ranges:
            b, e = zip(*ranges)
            encoded.append((ids, list(b), e[-1]))
        else:
            encoded.append((ids, [], 0))
    results = []
    cursor = 0
    for source, spans in plans:
        segments = []
        for _, byte_offset in spans:
            ids, begins, end = encoded[cursor]
            cursor += 1
            if not ids:
                continue
            if byte_offset:
                begins = [byte_offset + b for b in begins]
                end += byte_offset
            proc._wrap(ids, begins, end, segments, source, wrap_length)
        results.append((source, segments))
    return results


@pytest.fixture(scope="module")
def native_processor():
    from slimt_jax import native as native_mod

    if not native_mod.available():
        pytest.skip("native library unavailable")
    vocab = build_vocabulary(
        ["hello", "world", "goodbye", "test", "one", "two", "three",
         "mixed", "lead", "trail", "went", "sharp"],
        backend="native",
    )
    return TextProcessor("sentence", vocab)


@pytest.mark.parametrize("wrap_length", [128, 8])
def test_native_ingest_matches_generic(native_processor, wrap_length):
    proc = native_processor
    assert proc.vocabulary.resolved_batch_backend == "native"
    got = proc.process_batch(NATIVE_CORPUS, wrap_length)
    ref = _generic_process_batch(proc, NATIVE_CORPUS, wrap_length)
    assert len(got) == len(ref)
    for (sa, ga), (sb, gb) in zip(ref, got):
        assert ga == gb
        assert sa.token_begin == sb.token_begin
        assert sa.gap == sb.gap
        assert sa.data == sb.data


def test_native_ingest_raw_consistent(native_processor):
    """raw=True columnar form agrees with the materialized form."""
    import numpy as np

    proc = native_processor
    vocab = proc.vocabulary
    nat = vocab._native
    from slimt_jax.text.splitter import SentenceStream

    line_datas, sent_begin, sent_end, sent_counts = [], [], [], []
    for text in NATIVE_CORPUS:
        data = text.encode("utf-8")
        line_datas.append(data)
        count = 0
        from slimt_jax.text.vocabulary import byte_prefix

        prefix = None if len(data) == len(text) else byte_prefix(text)
        for s, b, e in SentenceStream(text, proc.splitter, proc.mode):
            if not s:
                continue
            sent_begin.append(b if prefix is None else prefix[b])
            sent_end.append(e if prefix is None else prefix[e])
            count += 1
        sent_counts.append(count)

    mat = nat.ingest_lines(
        line_datas, sent_begin, sent_end, sent_counts, 128, vocab.eos_id
    )
    seg_ids, bounds, seg_line, tb, tb_counts, gap, gap_counts = (
        nat.ingest_lines(
            line_datas, sent_begin, sent_end, sent_counts, 128,
            vocab.eos_id, raw=True,
        )
    )
    # reconstruct materialized form from the columnar arrays
    ids_list = seg_ids.tolist()
    tb_list = tb.tolist()
    gap_list = gap.tolist()
    sl = seg_line.tolist()
    b = bounds.tolist()
    tb_pos = gap_pos = 0
    seg_pos = 0
    for l, (segments, token_begin, gap_l) in enumerate(mat):
        n_segs = len(segments)
        assert sl[seg_pos : seg_pos + n_segs] == [l] * n_segs
        for s in range(n_segs):
            assert ids_list[b[seg_pos + s] : b[seg_pos + s + 1]] == segments[s]
        seg_pos += n_segs
        assert tb_list[tb_pos : tb_pos + tb_counts[l]] == token_begin
        assert gap_list[gap_pos : gap_pos + gap_counts[l]] == gap_l
        tb_pos += tb_counts[l]
        gap_pos += gap_counts[l]
    assert seg_pos == len(sl)


@pytest.mark.parametrize("backend", ["none", "auto"])
def test_process_annotated_batch_matches_single(backend):
    """process_annotated_batch (pivot leg 2 at corpus scale) must be
    byte-identical to per-source process_annotated across backends."""
    import random
    import string

    try:
        vocab = build_vocabulary(
            ["hello", "world", "goodbye", "test", "one", "two"],
            backend=backend,
        )
    except Exception:
        pytest.skip(f"{backend} backend unavailable")
    proc = TextProcessor("sentence", vocab)
    rng = random.Random(5)
    alphabet = string.ascii_letters + string.digits + " .,!?'\"-äöüé中文"
    texts = [
        "".join(rng.choice(alphabet) for _ in range(rng.randint(0, 120)))
        for _ in range(25)
    ] + ["", "hello world. goodbye test.", "  spaced  out  "]
    annotated = [proc.process(t, wrap_length=16)[0] for t in texts]
    batch = proc.process_annotated_batch(annotated)
    for source, (brep, bsegs) in zip(annotated, batch):
        srep, ssegs = proc.process_annotated(source)
        assert bsegs == ssegs
        assert brep.data == srep.data
        assert brep.token_begin == srep.token_begin
        assert brep.gap == srep.gap
