"""Unit tests for cache, request, and batcher."""

import threading

import pytest

from slimt_jax.runtime.batcher import (
    AggregateBatcher,
    Batcher,
    SegmentRef,
    Threadsafe,
)
from slimt_jax.runtime.cache import AtomicCache, make_cache
from slimt_jax.runtime.request import Hypothesis, Request, cache_key
from slimt_jax.text.annotation import AnnotatedText

from .helpers import make_model


class FakeVocab:
    eos_id = 0
    pad_id = 0

    def decode(self, words, ignore_eos=False):
        text = " ".join(f"w{w}" for w in words if w != 0)
        ranges = []
        pos = 0
        for i, w in enumerate(words):
            token = ("" if i == 0 or w == 0 else " ") + (
                f"w{w}" if w != 0 else ""
            )
            ranges.append((pos, pos + len(token)))
            pos += len(token)
        return text, ranges


def _make_request(
    segments, continuation=None, cache=None, id_=0, needs_alignment=False
):
    source = AnnotatedText()
    for seg in segments:
        source.append_sentence("", [f"t{w}" for w in seg])
    return Request(
        id_,
        model_id=7,
        source=source,
        segments=segments,
        vocabulary=FakeVocab(),
        cache=cache,
        continuation=continuation or (lambda r: None),
        needs_alignment=needs_alignment,
    )


def test_cache_store_find():
    cache = AtomicCache(8, 2)
    cache.store(42, "x")
    assert cache.find(42) == (True, "x")
    assert cache.find(43)[0] is False
    # collision overwrites (42 % 8 == 50 % 8)
    cache.store(50, "y")
    assert cache.find(42)[0] is False
    assert cache.find(50) == (True, "y")


def test_make_cache_disabled():
    assert make_cache(0) is None
    assert make_cache(4) is not None


def test_cache_key_deterministic():
    assert cache_key(1, [2, 3]) == cache_key(1, [2, 3])
    assert cache_key(1, [2, 3]) != cache_key(2, [2, 3])
    assert cache_key(1, [2, 3]) != cache_key(1, [3, 2])


def test_request_completion_fires_continuation():
    done = []
    request = _make_request(
        [[5, 0], [6, 0]], continuation=lambda r: done.append(r)
    )
    assert not done
    request.process(0, Hypothesis([5, 0], []))
    assert not done
    request.process(1, Hypothesis([6, 0], []))
    assert len(done) == 1
    response = done[0]
    assert response.target.sentence_count() == 2
    assert "w5" in response.target.text and "w6" in response.target.text


def test_request_empty_completes_immediately():
    done = []
    _make_request([], continuation=lambda r: done.append(r))
    assert len(done) == 1


def test_request_cache_prefill():
    cache = AtomicCache(64, 4)
    done = []
    first = _make_request(
        [[9, 0]], continuation=lambda r: done.append(r), cache=cache
    )
    first.process(0, Hypothesis([1, 0], []))
    assert len(done) == 1
    # Same segment again: prefilled from cache, completes in constructor.
    second = _make_request(
        [[9, 0]], continuation=lambda r: done.append(r), cache=cache
    )
    assert len(done) == 2
    assert second.cached(0)


def test_batcher_packs_shortest_first():
    batcher = Batcher(max_words=8, wrap_length=4, tgt_length_limit_factor=1.5)
    request = _make_request([[1, 2], [1, 2, 3, 4], [1]], id_=0)
    assert batcher.enqueue(request) == 3
    batch = batcher.generate()
    sizes = [ref.size() for ref in batch.segment_refs]
    assert sizes == sorted(sizes)
    # budget: (n+1)*len <= 8
    assert batch.token_count <= 8


def test_batcher_respects_budget():
    batcher = Batcher(max_words=4, wrap_length=4, tgt_length_limit_factor=1.0)
    request = _make_request([[1, 2, 3, 4], [5, 6, 7, 8]], id_=0)
    batcher.enqueue(request)
    first = batcher.generate()
    assert len(first) == 1  # 2 segments * 4 tokens > 4 budget
    second = batcher.generate()
    assert len(second) == 1
    assert batcher.generate().empty()


def test_batcher_skips_cached():
    cache = AtomicCache(64, 4)
    seg = [3, 0]
    done = []
    warm = _make_request([seg], continuation=lambda r: done.append(r), cache=cache)
    warm.process(0, Hypothesis([1, 0], []))
    request = _make_request(
        [seg, [4, 0]], continuation=lambda r: done.append(r), cache=cache
    )
    batcher = Batcher(max_words=64, wrap_length=8)
    assert batcher.enqueue(request) == 1  # cached segment not enqueued


class FakeModel:
    def __init__(self, id_):
        self.id = id_


def test_aggregate_batcher_multi_model():
    agg = AggregateBatcher(max_words=64, wrap_length=8)
    model_a, model_b = FakeModel(0), FakeModel(1)
    agg.enqueue(model_a, _make_request([[1, 2]], id_=0))
    agg.enqueue(model_b, _make_request([[3, 4]], id_=1))
    batch1, m1 = agg.generate()
    batch2, m2 = agg.generate()
    assert {m1.id, m2.id} == {0, 1}
    assert not batch1.empty() and not batch2.empty()
    batch3, m3 = agg.generate()
    assert batch3.empty() and m3 is None


def test_threadsafe_shutdown_unblocks():
    ts = Threadsafe(AggregateBatcher(max_words=64, wrap_length=8))
    results = []

    def worker():
        batch, model = ts.generate()
        results.append(batch.empty())

    t = threading.Thread(target=worker)
    t.start()
    ts.shutdown()
    t.join(timeout=5)
    assert results == [True]


def test_threadsafe_delivers_work():
    ts = Threadsafe(AggregateBatcher(max_words=64, wrap_length=8))
    model = FakeModel(0)
    results = []

    def worker():
        batch, m = ts.generate()
        results.append((len(batch), m.id if m else None))

    t = threading.Thread(target=worker)
    t.start()
    ts.enqueue(model, _make_request([[1, 2]], id_=0))
    t.join(timeout=5)
    assert results == [(1, 0)]
    ts.shutdown()


def test_cache_alignmentless_entry_not_served_to_alignment_request():
    """A hypothesis cached without alignments must not satisfy a
    request that needs them (would break HTML restore)."""
    cache = AtomicCache(64, 4)
    warm = _make_request([[9, 0]], cache=cache)
    warm.process(0, Hypothesis([1, 0], []))  # cached, no alignment
    needy = _make_request([[9, 0]], cache=cache, needs_alignment=True)
    assert not needy.cached(0)  # goes to translation again


def test_request_fail_propagates():
    errors = []
    request = _make_request([[1, 0]])
    request.on_error = errors.append
    exc = RuntimeError("device gone")
    request.fail(exc)
    request.fail(RuntimeError("second"))  # only first propagates
    assert errors == [exc]


def test_batcher_oversize_singleton():
    batcher = Batcher(max_words=4, wrap_length=4, tgt_length_limit_factor=1.0)
    long_segment = [1, 2, 3, 4, 5]  # > max_words
    request = _make_request([long_segment, [7]], id_=0)
    batcher.enqueue(request)
    sizes = []
    while True:
        batch = batcher.generate()
        if batch.empty():
            break
        sizes.append(len(batch.segment_refs[0].get()))
    assert 5 in sizes  # oversize emitted as its own batch, not dropped
    assert 1 in sizes


def test_failed_request_never_completes():
    """A request failed by one batch (fail()) must ignore later
    process() calls from its other batches: firing the continuation
    after failure would set_result on a future that already holds the
    exception and poison the completing batch (Async._work)."""
    fired = []
    request = _make_request(
        [[1, 2], [3, 4]], continuation=lambda r: fired.append(r)
    )
    errors = []
    request.on_error = errors.append

    request.process(0, Hypothesis([5, 0], []))
    request.fail(RuntimeError("device exploded"))
    assert len(errors) == 1
    # The second batch completes afterwards — must be a no-op.
    request.process(1, Hypothesis([6, 0], []))
    assert fired == []
    assert isinstance(request.failed, RuntimeError)


def test_batching_window_breaks_early_when_full():
    """Threadsafe's batch_latency window must not sleep once a maximal
    batch is already queued."""
    import time

    from slimt_jax.runtime.batcher import Batcher, Threadsafe

    inner = Batcher(max_words=16, wrap_length=4)
    ts = Threadsafe(inner, batch_latency=5.0)  # would be 5s of dead time
    for i in range(8):
        ts.enqueue(_make_request([[1, 2]], id_=i))
    t0 = time.monotonic()
    batch = ts.generate()
    assert time.monotonic() - t0 < 1.0, "latency window slept while full"
    assert not batch.empty()


def test_batching_window_no_spurious_poison():
    """Two workers in the latency window + one batch of work: the
    worker that loses the race must NOT emit an empty (poison) batch;
    it keeps waiting until shutdown."""
    import threading

    from slimt_jax.runtime.batcher import Batcher, Threadsafe

    inner = Batcher(max_words=64, wrap_length=4)
    ts = Threadsafe(inner, batch_latency=0.02)
    results = []

    def worker():
        while True:
            batch = ts.generate()
            results.append(len(batch))
            if batch.empty():
                return

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    ts.enqueue(_make_request([[1, 2]]))
    import time

    time.sleep(0.3)  # both workers raced the window by now
    # Only shutdown may produce empty batches.
    assert all(n > 0 for n in results), results
    ts.shutdown()
    for t in threads:
        t.join(timeout=5)
    assert all(not t.is_alive() for t in threads)
