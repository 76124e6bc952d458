"""End-to-end service tests: text in → translation machinery → text out.

The synthetic model emits arbitrary (but deterministic) tokens, so
assertions target structure, determinism, caching, batching, and
pivot mechanics rather than translation quality.
"""

import pytest

from slimt_jax.config import Config
from slimt_jax.runtime.response import Options
from slimt_jax.runtime.service import Async, Blocking

from .helpers import TINY_TEST_CONFIG, make_model, make_package
from slimt_jax.models.model import Model


@pytest.fixture(scope="module")
def model():
    return make_model()


@pytest.fixture(scope="module")
def model_with_shortlist():
    config = TINY_TEST_CONFIG
    return Model(config, make_package(config=config, with_shortlist=True))


def test_blocking_translate_single(model):
    service = Blocking(Config(cache_size=0))
    responses = service.translate(model, ["hello world"])
    assert len(responses) == 1
    response = responses[0]
    assert response.source.text == "hello world"
    assert response.source.sentence_count() == 1
    assert response.target.sentence_count() == 1
    assert len(response.alignments) == 1


def test_blocking_translate_multiple(model):
    service = Blocking(Config(cache_size=0))
    sources = ["hello world", "goodbye test", "quick brown fox"]
    responses = service.translate(model, sources)
    assert [r.source.text for r in responses] == sources
    for response in responses:
        assert response.target.sentence_count() == 1


def test_translate_deterministic(model):
    service = Blocking(Config(cache_size=0))
    first = service.translate(model, ["hello world test"])
    second = service.translate(model, ["hello world test"])
    assert first[0].target.text == second[0].target.text


def test_translate_empty_input(model):
    service = Blocking(Config(cache_size=0))
    responses = service.translate(model, [""])
    assert len(responses) == 1
    assert responses[0].target.text == ""


def test_cache_hit_consistent(model):
    service = Blocking(Config(cache_size=256))
    first = service.translate(model, ["hello world"])[0]
    # Second call: every segment comes from the cache (request
    # completes during construction).
    second = service.translate(model, ["hello world"])[0]
    assert first.target.text == second.target.text


def test_multiline_gaps_preserved(model):
    service = Blocking(Config(cache_size=0))
    response = service.translate(model, ["hello world\ngoodbye test"])[0]
    assert response.source.sentence_count() == 2
    # inter-sentence gap transferred to target
    assert response.target.gap_text(1) == "\n"


def test_wrap_length_produces_multiple_segments(model):
    service = Blocking(Config(cache_size=0, wrap_length=4))
    text = "hello world test quick brown fox jumps over"
    response = service.translate(model, [text])[0]
    assert response.source.sentence_count() > 1
    assert response.source.text == text


def test_alignment_shapes(model):
    service = Blocking(Config(cache_size=0))
    response = service.translate(
        model, ["hello world"], Options(alignment=True)
    )[0]
    n_src = response.source.word_count(0)
    for row in response.alignments[0]:
        assert len(row) == n_src
        assert all(0.0 <= p <= 1.001 for p in row)


@pytest.mark.parametrize(
    "kv_dtype", ["int8", "int16", "k8v16", "k16v8", "float16", "bfloat16", "float32"]
)
def test_kv_cache_dtype_through_service(kv_dtype):
    """Every kv_cache_dtype decodes deterministically through the full
    Blocking service (joined-layout reduced-precision caches included)."""
    import dataclasses

    config = dataclasses.replace(TINY_TEST_CONFIG, kv_cache_dtype=kv_dtype)
    m = Model(config, make_package(config=config))
    service = Blocking(Config(cache_size=0))
    a = service.translate(m, ["hello world", "quick brown fox"])
    b = service.translate(m, ["hello world", "quick brown fox"])
    assert [r.target.text for r in a] == [r.target.text for r in b]
    for r in a:
        assert r.target.sentence_count() == 1
        assert r.target.text


def test_shortlist_model_runs(model_with_shortlist):
    service = Blocking(Config(cache_size=0))
    response = service.translate(model_with_shortlist, ["hello world"])[0]
    assert response.target.sentence_count() == 1


def test_async_translate(model):
    config = Config(cache_size=0, workers=2)
    with Async(config) as service:
        handles = [
            service.translate(model, text)
            for text in ["hello world", "goodbye test", "quick brown"]
        ]
        for handle, text in zip(
            handles, ["hello world", "goodbye test", "quick brown"]
        ):
            response = handle.result(timeout=60)
            assert response.source.text == text
            info = handle.info()
            assert info.words.p == info.words.q  # all words complete


def test_async_matches_blocking(model):
    blocking = Blocking(Config(cache_size=0))
    want = blocking.translate(model, ["hello world test"])[0]
    with Async(Config(cache_size=0, workers=1)) as service:
        got = service.translate(model, "hello world test").result(60)
    assert got.target.text == want.target.text


def test_blocking_pivot(model):
    # pivot through the same synthetic model (en->X->en shape-wise)
    service = Blocking(Config(cache_size=0))
    responses = service.pivot(
        model, model, ["hello world"], Options(alignment=True)
    )
    assert len(responses) == 1
    response = responses[0]
    assert response.source.text == "hello world"
    assert response.target.sentence_count() == response.source.sentence_count()
    # remapped alignments exist with target-major shape
    assert len(response.alignments) == 1
    assert len(response.alignments[0]) == response.target.word_count(0)


def test_async_pivot(model):
    with Async(Config(cache_size=0, workers=2)) as service:
        handle = service.pivot(model, model, "hello world test")
        response = handle.result(timeout=60)
        assert response.source.text == "hello world test"
        assert response.target.sentence_count() >= 1


def test_multi_model_async():
    model_a = make_model(seed=0)
    model_b = make_model(seed=1)
    with Async(Config(cache_size=0, workers=2)) as service:
        ha = service.translate(model_a, "hello world")
        hb = service.translate(model_b, "hello world")
        ra = ha.result(60)
        rb = hb.result(60)
    assert ra.source.text == rb.source.text == "hello world"


def test_async_translate_many(model):
    with Async(Config(cache_size=0, workers=2)) as service:
        texts = ["hello world", "goodbye test", "quick brown fox"]
        handles = service.translate_many(model, texts)
        responses = [h.result(60) for h in handles]
    assert [r.source.text for r in responses] == texts
    # matches single-submit results
    blocking = Blocking(Config(cache_size=0))
    want = blocking.translate(model, texts)
    assert [r.target.text for r in responses] == [
        r.target.text for r in want
    ]


def test_translate_routes_prefer_bulk(model):
    """Blocking.translate routes through the bulk lane by default;
    Config(prefer_bulk=False) pins the per-request exhaust loop."""
    import unittest.mock as mock

    svc = Blocking(Config(cache_size=0))
    with mock.patch.object(
        svc, "translate_bulk", wraps=svc.translate_bulk
    ) as bulk:
        svc.translate(model, ["hello world"])
        assert bulk.called

    pinned = Blocking(Config(cache_size=0, prefer_bulk=False))
    with mock.patch.object(
        pinned, "translate_bulk", wraps=pinned.translate_bulk
    ) as bulk:
        out = pinned.translate(model, ["hello world"])
        assert not bulk.called
    assert out[0].target.text


def test_decode_cap_uses_actual_length(model):
    """A never-EOS greedy decode truncates at limit_factor × the
    batch's ACTUAL longest source (slimt/Model.cc:160), not at the
    padded shape bucket (t_pad is a multiple of 16)."""
    seg = [3, 4, 5, 6, 7]  # 5 tokens, bucket pads T to 16
    hists = model.forward([seg], need_alignment=False)
    words = list(hists[0].target)
    cap = int(model.limit_factor * len(seg))
    eos = model.vocabulary.eos_id
    if eos in words:
        pytest.skip("synthetic decode emitted EOS before the cap")
    assert len(words) == cap


def test_raw_completion_differential(model):
    """The columnar completion path (Batch.complete_raw — round 4)
    must produce byte-identical Responses to the per-row path on both
    the Blocking exhaust loop and the Async workers, including cached
    reuse across batches."""
    from slimt_jax.runtime import service as service_mod

    corpus = [
        "hello world",
        "the quick brown fox jumps over the lazy dog again and again",
        "goodbye test",
        "",
        "hello world",  # duplicate: cache interplay
        "one two three four five six seven eight nine ten eleven twelve "
        "thirteen fourteen fifteen sixteen",  # wraps into 2+ segments
    ]

    def snapshot(responses):
        return [
            (
                r.source.text,
                r.target.text,
                [
                    r.target.word(s, w)
                    for s in range(r.target.sentence_count())
                    for w in range(r.target.word_count(s))
                ],
                r.alignments,
            )
            for r in responses
        ]

    results = {}
    for raw_flag in (True, False):
        service_mod.RAW_COMPLETION = raw_flag
        try:
            blocking = Blocking(
                Config(cache_size=64, max_words=64, wrap_length=16,
                       prefer_bulk=False)
            )
            got_blocking = snapshot(blocking.translate(model, corpus))
            with Async(
                Config(cache_size=64, max_words=64, wrap_length=16,
                       workers=2)
            ) as svc:
                handles = svc.translate_many(model, corpus)
                got_async = snapshot([h.result(120) for h in handles])
        finally:
            service_mod.RAW_COMPLETION = True
        results[raw_flag] = (got_blocking, got_async)

    assert results[True][0] == results[False][0]  # Blocking identical
    assert results[True][1] == results[False][1]  # Async identical
