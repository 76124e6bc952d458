"""Property/fuzz tests: pipeline invariants over random unicode text."""

import random
import string

import pytest

from slimt_jax.config import Config
from slimt_jax.runtime.service import Blocking
from slimt_jax.text.processor import TextProcessor
from slimt_jax.text.synthetic_vocab import build_vocabulary

from .helpers import make_model

ALPHABET = (
    string.ascii_letters + string.digits + " .,!?;:'\"()-\n"
    + "äöüéàñ中文日本語"
)


def _random_text(rng, max_len=200):
    n = rng.randint(0, max_len)
    return "".join(rng.choice(ALPHABET) for _ in range(n))


@pytest.fixture(scope="module")
def processor():
    vocab = build_vocabulary(["hello", "world", "test"], backend="none")
    return TextProcessor("sentence", vocab)


def test_processor_annotation_invariants(processor):
    rng = random.Random(42)
    for _ in range(60):
        text = _random_text(rng)
        source, segments = processor.process(text, wrap_length=16)
        # text preserved exactly
        assert source.text == text
        assert source.sentence_count() == len(segments)
        data = source.data
        # token ranges are monotone and within bounds
        assert source.token_begin == sorted(source.token_begin)
        assert source.token_begin[-1] == len(data)
        for s in range(source.sentence_count()):
            assert segments[s][-1] == processor.vocabulary.eos_id
            assert len(segments[s]) <= 16
            for w in range(source.word_count(s)):
                r = source.word_as_range(s, w)
                assert 0 <= r.begin <= r.end <= len(data)


def test_processor_utf8_conversion_fuzz(processor):
    from slimt_jax.text.annotation import Encoding

    rng = random.Random(7)
    for _ in range(20):
        text = _random_text(rng, max_len=80)
        source, _ = processor.process(text, wrap_length=16)
        words_before = [
            source.word(s, w)
            for s in range(source.sentence_count())
            for w in range(source.word_count(s))
        ]
        source.to(Encoding.UTF8)
        words_utf8 = [
            source.word(s, w)
            for s in range(source.sentence_count())
            for w in range(source.word_count(s))
        ]
        source.to(Encoding.BYTE)
        assert words_before == words_utf8


def test_service_fuzz_random_lines():
    model = make_model()
    service = Blocking(Config(cache_size=16))
    rng = random.Random(3)
    lines = [_random_text(rng, max_len=60).replace("\n", " ") for _ in range(12)]
    responses = service.translate(model, lines)
    assert [r.source.text for r in responses] == lines
    for response in responses:
        # target annotation is internally consistent
        t = response.target
        assert t.token_begin == sorted(t.token_begin)
        assert t.token_begin[-1] == len(t.data)


def test_long_sentence_flash_attention():
    """Long-context capability: a single unwrapped long sentence
    through the flash encoder (wrap lifted)."""
    import jax.numpy as jnp
    import numpy as np

    from slimt_jax.models.decode import translate_batch

    model = make_model()
    words = "hello world test quick brown " * 120  # ~600 tokens
    ids, _ = model.vocabulary.encode(words, add_eos=True)
    assert len(ids) > 400
    indices = np.asarray(ids, np.int32)[None, :]
    mask = np.ones_like(indices, np.float32)
    result = translate_batch(
        model.params, jnp.asarray(indices), jnp.asarray(mask),
        eos_id=model.vocabulary.eos_id, max_steps=8,
        num_heads=model.config.num_heads, provider="xla_int8",
        flash_attention=True,
    )
    assert np.asarray(result.valid).shape[1] == 8


def test_bulk_columnar_fuzz_matches_general():
    """Random unicode corpora through the columnar bulk lane must be
    byte-identical (text + annotations) to the general Blocking path.

    Both services run cache-free and single-chunk so segment grouping
    is identical — the decode-step cap is limit_factor × the batch's
    longest source (slimt/Model.cc:160), so different groupings
    legitimately truncate never-EOS synthetic decodes differently
    (cache-hit regrouping is covered deterministically in
    test_bulk.py)."""
    rng = random.Random(77)
    model = make_model()
    bulk_svc = Blocking(Config(cache_size=0))
    plain_svc = Blocking(Config(cache_size=0, prefer_bulk=False))
    for round_no in range(3):
        corpus = [_random_text(rng, 120) for _ in range(40)]
        corpus += corpus[:5]  # repeats within one call
        bulk = bulk_svc.translate_bulk(model, corpus)
        general = plain_svc.translate(model, corpus)
        assert len(bulk) == len(general)
        for rb, rg in zip(bulk, general):
            assert rb.source.data == rg.source.data
            assert rb.source.token_begin == rg.source.token_begin
            assert rb.source.gap == rg.source.gap
            assert rb.target.data == rg.target.data
            assert rb.target.token_begin == rg.target.token_begin
            assert rb.target.gap == rg.target.gap


def test_native_ingest_fuzz_matches_hf():
    """Random unicode lines: the native ingest (tokenize+wrap+annotate
    in C++) must agree with the HF-backend process_batch on every line
    where the two tokenizers agree on ids (they are parity-tested;
    surface-offset conventions for multibyte unknowns may differ, so
    compare ids + structure, and full annotations on ASCII lines)."""
    import os

    from slimt_jax import native as native_mod

    if not native_mod.available():
        pytest.skip("native library unavailable")
    rng = random.Random(99)
    vocab = build_vocabulary(
        ["hello", "world", "test", "quick", "brown"], backend="auto"
    )
    if vocab._hf is None or vocab._native is None:
        pytest.skip("needs both backends")
    proc = TextProcessor("sentence", vocab)
    lines = [_random_text(rng, 100) for _ in range(60)]
    os.environ["SLIMT_JAX_BATCH_BACKEND"] = "native"
    try:
        got = proc.process_batch(lines, 32)
    finally:
        os.environ.pop("SLIMT_JAX_BATCH_BACKEND", None)
    # oracle: split + per-sentence single encode (same native backend)
    # + the Python wrap, mirroring the generic process_batch
    from slimt_jax.text.splitter import SentenceStream

    step = 32 - 1
    for line, (source, segments) in zip(lines, got):
        flat = [w for seg in segments for w in seg[:-1]]
        expected = []
        for sentence, _b, _e in SentenceStream(
            line, proc.splitter, proc.mode
        ):
            if not sentence:
                continue
            ids, _ranges = vocab.encode(sentence)
            expected.extend(ids)
        assert flat == expected
        # every wrapped segment ends in EOS and holds <= step tokens
        for seg in segments:
            assert seg[-1] == vocab.eos_id
            assert len(seg) - 1 <= step
        assert source.sentence_count() == len(segments)
        assert source.token_begin[-1] == len(source.data)
