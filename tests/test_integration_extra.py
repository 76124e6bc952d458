"""Integration coverage for corners not exercised elsewhere:
HTML pivot, async stress with cache, warmup, malformed vocab."""

import threading

import numpy as np
import pytest

from slimt_jax.config import Config
from slimt_jax.runtime.response import Options
from slimt_jax.runtime.service import Async, Blocking
from slimt_jax.text import spm_proto
from slimt_jax.text.vocabulary import Vocabulary

from .helpers import make_model


@pytest.fixture(scope="module")
def model():
    return make_model()


def test_html_pivot_blocking(model):
    service = Blocking(Config(cache_size=0))
    response = service.pivot(
        model, model, ["<b>hello</b> world"], Options(html=True)
    )[0]
    assert "<b>" in response.source.text
    # markup transferred through two translation legs stays balanced
    assert response.target.text.count("<b>") == response.target.text.count(
        "</b>"
    )


def test_async_stress_with_cache(model):
    """Many concurrent requests with overlapping content + cache on:
    exercises cache races, batching window, and countdowns."""
    config = Config(cache_size=128, workers=3, batch_latency=0.005)
    texts = [f"hello world {i % 7}" for i in range(60)]
    with Async(config) as service:
        handles = [service.translate(model, t) for t in texts]
        responses = [h.result(timeout=120) for h in handles]
    assert [r.source.text for r in responses] == texts
    # identical inputs give identical outputs (cache coherence)
    by_text = {}
    for text, resp in zip(texts, responses):
        by_text.setdefault(text, set()).add(resp.target.text)
    assert all(len(v) == 1 for v in by_text.values())


def test_async_error_surfaces_to_future(model):
    class BrokenModel:
        id = 987654
        vocabulary = model.vocabulary
        processor = model.processor

        def forward(self, segments, need_alignment=True):
            raise RuntimeError("synthetic device failure")

        def forward_async(self, segments, need_alignment=True, raw=False):
            raise RuntimeError("synthetic device failure")

    with Async(Config(cache_size=0, workers=1)) as service:
        handle = service.translate(BrokenModel(), "hello world")
        with pytest.raises(RuntimeError, match="synthetic device failure"):
            handle.result(timeout=60)
        # worker survived: a healthy model still translates
        ok = service.translate(model, "hello world").result(timeout=120)
        assert ok.target.sentence_count() == 1


def test_model_warmup(model):
    compiled = model.warmup(batch_buckets=(1,), seq_buckets=(16,))
    assert compiled == 1


def test_vocabulary_rejects_garbage():
    with pytest.raises(Exception):
        Vocabulary(b"\xff\xfe not a protobuf at all \x00\x01")


def test_vocabulary_empty_model():
    blob = spm_proto.serialize_model(
        spm_proto.SpmModel(pieces=[], unk_id=0, eos_id=0)
    )
    vocab = Vocabulary(blob, backend="none")
    ids, ranges = vocab.encode("x")
    assert all(i == 0 for i in ids)  # everything unk
