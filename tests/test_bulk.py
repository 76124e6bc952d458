"""Differential tests: Blocking.translate_bulk must produce byte-
identical Responses to the general Blocking.translate path (same
annotations, alignments, cache interaction, HTML restore)."""

import dataclasses

import pytest

from slimt_jax.config import Config
from slimt_jax.runtime.response import Options
from slimt_jax.runtime.service import Blocking

from .helpers import make_model


@pytest.fixture(scope="module")
def model():
    return make_model()


CORPUS = [
    "hello world",
    "goodbye test one two three",
    "",
    "   ",
    "héllo wörld",
    "hello world. goodbye test. one two.",
    " ".join(["hello"] * 200),  # forces wrap at 128
    "hello world",  # duplicate: exercises within-call cache behavior
]


def _assert_same(a, b, alignments=True):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert ra.source.data == rb.source.data
        assert ra.source.token_begin == rb.source.token_begin
        assert ra.source.gap == rb.source.gap
        assert ra.target.data == rb.target.data
        assert ra.target.token_begin == rb.target.token_begin
        assert ra.target.gap == rb.target.gap
        if alignments:
            assert len(ra.alignments) == len(rb.alignments)
            for aa, ab in zip(ra.alignments, rb.alignments):
                assert aa == ab or (
                    len(aa) == len(ab)
                    and all(list(x) == list(y) for x, y in zip(aa, ab))
                )


@pytest.mark.parametrize("cache_size", [0, 64])
def test_bulk_matches_general(model, cache_size):
    general = Blocking(
        Config(cache_size=cache_size, prefer_bulk=False)
    ).translate(
        model, CORPUS
    )
    bulk = Blocking(Config(cache_size=cache_size)).translate_bulk(
        model, CORPUS
    )
    _assert_same(general, bulk)


def test_bulk_with_alignment(model):
    opts = Options(alignment=True)
    general = Blocking(
        Config(cache_size=0, prefer_bulk=False)
    ).translate(model, CORPUS, opts)
    bulk = Blocking(Config(cache_size=0)).translate_bulk(
        model, CORPUS, opts
    )
    _assert_same(general, bulk)
    for r in bulk:
        assert all(len(a) > 0 for a in r.alignments)


def test_bulk_html(model):
    html_corpus = ["<b>hello</b> world", "plain text", "<i>one</i> two"]
    opts = Options(html=True)
    general = Blocking(
        Config(cache_size=0, prefer_bulk=False)
    ).translate(model, html_corpus, opts)
    bulk = Blocking(Config(cache_size=0)).translate_bulk(
        model, html_corpus, opts
    )
    assert [r.target.text for r in bulk] == [r.target.text for r in general]


def test_bulk_cache_warm_cross_path(model):
    """Bulk probes/stores the same cache entries as the general path:
    a bulk run after a general run hits the cache (and vice versa)."""
    service = Blocking(Config(cache_size=256, prefer_bulk=False))
    first = service.translate(model, ["hello world", "goodbye test"])
    bulk = service.translate_bulk(model, ["hello world", "goodbye test"])
    _assert_same(first, bulk, alignments=False)

    service2 = Blocking(Config(cache_size=256, prefer_bulk=False))
    warm = service2.translate_bulk(model, ["one two three"])
    general = service2.translate(model, ["one two three"])
    _assert_same(warm, general, alignments=False)


def test_bulk_forward_error_propagates(model):
    service = Blocking(Config(cache_size=0))

    def boom(*args, **kwargs):
        raise RuntimeError("device exploded")

    import unittest.mock as mock

    # Both bulk lanes must propagate device errors: the columnar lane
    # dispatches via forward_async_arrays, the general one via
    # forward_async.
    with mock.patch.object(model, "forward_async", side_effect=boom), \
         mock.patch.object(
             model, "forward_async_arrays", side_effect=boom, create=True
         ):
        with pytest.raises(RuntimeError, match="device exploded"):
            service.translate_bulk(model, ["hello world"])


def test_pack_budget_and_oversize():
    """_pack follows the Batcher's greedy rule ((n+1)*maxlen <=
    max_words, slimt/Batcher.cc:95-120) and emits an oversize segment
    as a singleton batch instead of stalling."""
    from slimt_jax.runtime.bulk import _pack

    flat = sorted(
        [(3, 0, 0, [1] * 3), (3, 1, 0, [2] * 3), (5, 2, 0, [3] * 5),
         (20, 3, 0, [4] * 20)],
        key=lambda t: t[0],
    )
    batches = _pack(flat, max_words=12)
    sizes = [[item[0] for item in b] for b in batches]
    assert sizes == [[3, 3], [5], [20]]  # 3*3<=12, 3*5>12; 20 oversize
    assert all(b for b in batches)


def test_bulk_wrapped_long_sentence(model):
    """A sentence longer than wrap_length translates identically on
    both paths (wrapping + small batch budget)."""
    config = Config(cache_size=0, max_words=32, wrap_length=16)
    text = " ".join(["hello"] * 40)
    general = Blocking(
        dataclasses.replace(config, prefer_bulk=False)
    ).translate(model, [text])
    bulk = Blocking(config).translate_bulk(model, [text])
    _assert_same(general, bulk)


def test_bulk_chunked_matches_unchunked(model):
    """Chunked ingest (bulk_chunk_lines) must not change outputs.

    The decode step cap is limit_factor × the batch's longest source
    (reference slimt/Model.cc:160), so regrouping segments CAN change
    where a never-ending synthetic decode truncates — that is shared
    reference semantics, not a chunking artifact. Uniform-length lines
    pin the cap so outputs must match exactly."""
    corpus = [
        "hello world test",
        "goodbye hello world",
        "test world hello",
        "world goodbye test",
        "hello test goodbye",
    ]
    one = Blocking(Config(cache_size=0, bulk_chunk_lines=0)).translate_bulk(
        model, corpus
    )
    chunked = Blocking(
        Config(cache_size=0, bulk_chunk_lines=2)
    ).translate_bulk(model, corpus)
    _assert_same(one, chunked)


def test_bulk_empty_corpus(model):
    assert Blocking(Config(bulk_chunk_lines=0)).translate_bulk(model, []) == []
    assert Blocking(Config()).translate_bulk(model, []) == []


def test_bulk_process_ingest_matches(model):
    """ingest_processes > 0 (worker-process tokenization) must produce
    identical outputs to in-process ingest."""
    inproc = Blocking(
        Config(cache_size=0, bulk_chunk_lines=2)
    ).translate_bulk(model, CORPUS)
    with Blocking(
        Config(cache_size=0, ingest_processes=2, bulk_chunk_lines=2)
    ) as svc:
        multi = svc.translate_bulk(model, CORPUS)
    _assert_same(inproc, multi)


def test_ingest_pool_fallback_after_close():
    """A closed/broken IngestPool returns None from submit; callers
    fall back to in-process ingest."""
    from slimt_jax.text.ingest_pool import IngestPool

    pool = IngestPool(workers=1)
    pool.close()
    assert pool.submit(None, ["x"], 128) is None


def test_service_facade_translate_bulk(model):
    from slimt_jax.bindings import Service

    svc = Service(workers=1, cache_size=64)
    try:
        general = svc.translate(model, ["hello world", "goodbye test"])
        bulk = svc.translate_bulk(model, ["hello world", "goodbye test"])
        assert [r.target.text for r in bulk] == [
            r.target.text for r in general
        ]
    finally:
        svc.close()


def test_bulk_partial_cache_hit_line(model):
    """A multi-sentence line where SOME sentences are already cached:
    the columnar lane assembles such lines per-segment (mixing cached
    content with fresh batch output) — must still match the general
    path byte for byte."""
    mixed = ["hello world. goodbye test. one two.", "hello world."]
    # Both paths follow the SAME warm-then-mixed cache sequence: the
    # decode-step cap is limit_factor × the batch's actual longest
    # source (slimt/Model.cc:160), so the cached segment's content
    # depends on the batch it was first decoded in — shared reference
    # semantics, not a lane artifact.
    service = Blocking(Config(cache_size=256))
    service.translate_bulk(model, ["hello world."])  # warms one segment
    bulk = service.translate_bulk(model, mixed)
    pinned = Blocking(Config(cache_size=256, prefer_bulk=False))
    pinned.translate(model, ["hello world."])
    general = pinned.translate(model, mixed)
    _assert_same(bulk, general, alignments=False)


def test_bulk_one_sentence_per_line_matches_general(model):
    """ONE_SENTENCE_PER_LINE: the columnar lane's per-line fast split
    (whole text = one sentence, splitter._read_line semantics) must
    match the general path, including texts the fast path must skip
    (embedded newline, trailing CR) and texts it handles (trailing
    whitespace, multi-sentence punctuation treated as one sentence)."""
    from slimt_jax.text.splitter import SplitMode

    corpus = [
        "hello world",
        "",
        "hello world. goodbye test. one two.",  # one sentence in this mode
        "trailing space ",
        "tab\tinside",
        "line with\ncr embedded",  # fast path skipped: falls back
        "carriage return\r",  # fast path skipped: falls back
        "héllo wörld",
    ]
    saved = model.processor.mode
    model.processor.mode = SplitMode.ONE_SENTENCE_PER_LINE
    try:
        general = Blocking(
        Config(cache_size=0, prefer_bulk=False)
    ).translate(model, list(corpus))
        bulk = Blocking(Config(cache_size=0)).translate_bulk(
            model, list(corpus)
        )
        _assert_same(general, bulk)
    finally:
        model.processor.mode = saved


@pytest.mark.parametrize(
    "mode", ["paragraph", "wrapped_text"], ids=["paragraph", "wrapped"]
)
def test_bulk_paragraph_modes_match_general(model, mode):
    """Paragraph/wrapped split modes through the columnar lane: the
    splitter yields empty paragraph-boundary markers that the lane
    must skip while preserving the byte gaps around them."""
    from slimt_jax.text.splitter import SplitMode

    corpus = [
        "hello world. goodbye test.\n\nnew paragraph here. one two.",
        "single line",
        "",
        "wrapped text flows\nacross lines. second sentence\nhere too.",
        "héllo wörld. ünïcode paragraph.\n\nnext pära.",
    ]
    saved = model.processor.mode
    model.processor.mode = SplitMode(mode)
    try:
        general = Blocking(
        Config(cache_size=0, prefer_bulk=False)
    ).translate(model, list(corpus))
        bulk = Blocking(Config(cache_size=0)).translate_bulk(
            model, list(corpus)
        )
        _assert_same(general, bulk)
    finally:
        model.processor.mode = saved


def test_bulk_cache_warm_bulk_then_general(model):
    """Cache entries stored by the bulk lane serve the general path
    (decoded text is rebuilt on demand when the stored hypothesis
    carries none)."""
    service = Blocking(Config(cache_size=256, prefer_bulk=False))
    bulk = service.translate_bulk(model, ["hello world", "goodbye test"])
    general = service.translate(model, ["hello world", "goodbye test"])
    _assert_same(bulk, general, alignments=False)


@pytest.mark.parametrize(
    "opts",
    [Options(), Options(alignment=True), Options(html=True)],
    ids=["plain", "alignment", "html"],
)
def test_pivot_bulk_leg2_matches_request_path(model, opts):
    """Blocking.pivot with prefer_bulk (leg 2 on the bulk lane via
    process_annotated_batch) must match the pinned per-request pivot
    byte for byte."""
    corpus = [
        "hello world",
        "goodbye test one two three",
        "",
        "héllo wörld. second sentence.",
    ]
    if opts.html:
        corpus = ["<b>hello</b> world", "plain text here"]
    bulk = Blocking(Config(cache_size=0)).pivot(
        model, model, list(corpus), opts
    )
    general = Blocking(Config(cache_size=0, prefer_bulk=False)).pivot(
        model, model, list(corpus), opts
    )
    _assert_same(general, bulk)


def test_bulk_lazy_response_encoding_conversion(model):
    """Encoding.to(UTF8/BYTE) on lazy (from_arrays) bulk Responses
    materializes and converts identically to the request path."""
    from slimt_jax.text.annotation import Encoding

    texts = ["héllo wörld", "hello world. ünïcode."]
    bulk = Blocking(Config(cache_size=0)).translate_bulk(model, texts)
    general = Blocking(
        Config(cache_size=0, prefer_bulk=False)
    ).translate(model, texts)
    for rb, rg in zip(bulk, general):
        rb.to(Encoding.UTF8)
        rg.to(Encoding.UTF8)
        assert rb.source.token_begin == rg.source.token_begin
        assert rb.target.token_begin == rg.target.token_begin
        rb.to(Encoding.BYTE)
        rg.to(Encoding.BYTE)
        assert rb.target.token_begin == rg.target.token_begin
