"""Length-bucketed batching of segments across requests.

Mirrors slimt/Batcher.{hh,cc}:

  - SegmentRef: (index, request) proxy ordered by (request id, index);
  - Batcher: per-token-length buckets, greedy shortest-first packing
    while (batch_size+1) * length <= max_words
    (slimt/Batcher.cc:95-120);
  - AggregateBatcher: per-model Batcher map plus a pending-model queue
    for multi-model serving (slimt/Batcher.cc:155-202);
  - Threadsafe: the monitor wrapper (mutex + condition + empty-batch
    shutdown poison) that workers block on
    (slimt/Batcher.hh:203-259).
"""

from __future__ import annotations

import heapq
import threading
from typing import Dict, List, Optional, Tuple

from slimt_jax.runtime.request import History, Hypothesis, Request


class SegmentRef:
    __slots__ = ("index", "request")

    def __init__(self, index: int, request: Request):
        self.index = index
        self.request = request

    def size(self) -> int:
        return self.request.word_count(self.index)

    def get(self) -> List[int]:
        return self.request.segment(self.index)

    def complete(self, history: History) -> None:
        self.request.process(self.index, history)

    def _key(self) -> Tuple[int, int]:
        return (self.request.id, self.index)

    def __lt__(self, other: "SegmentRef") -> bool:
        return self._key() < other._key()


class Batch:
    def __init__(self):
        self.segment_refs: List[SegmentRef] = []
        self.token_count = 0
        self.max_length = 0

    def __len__(self) -> int:
        return len(self.segment_refs)

    def empty(self) -> bool:
        return not self.segment_refs

    def add(self, ref: SegmentRef) -> None:
        self.segment_refs.append(ref)
        self.token_count += ref.size()
        self.max_length = max(self.max_length, ref.size())

    def complete(self, histories: List[History]) -> None:
        assert len(histories) == len(self.segment_refs)
        if self.segment_refs:
            # One batched detokenize call for the whole device batch
            # (all refs share the model — batchers are per-model);
            # Request._complete consumes the precomputed bytes.
            vocabulary = self.segment_refs[0].request.vocabulary
            decoded = vocabulary.decode_batch(
                [history.target for history in histories]
            )
            for history, d in zip(histories, decoded):
                history.decoded = d
        for ref, history in zip(self.segment_refs, histories):
            ref.complete(history)

    def complete_raw(self, tokens, steps, vocabulary) -> None:
        """Columnar completion for alignment-free batches: decode the
        padded device token matrix in ONE native call
        (decode_padded — no per-token Python objects), then hand each
        request a Hypothesis carrying presliced bytes + end offsets.
        This is the bulk lane's fetch path (runtime/bulk.py
        _translate_bulk_columnar.fetch) applied to the per-request
        machinery; Request.process/continuation semantics (countdown,
        cache store, pivot CPS) are unchanged and the Responses are
        byte-identical to complete() (differential-tested,
        tests/test_service.py)."""
        refs = self.segment_refs
        n = len(refs)
        if n == 0:
            return
        nat = vocabulary._native
        text, text_off, ends, ends_off = nat.decode_padded(tokens[:n], steps)
        steps_l = steps.tolist()
        text_off_l = text_off.tolist()
        ends_off_l = ends_off.tolist()
        ends_l = ends.tolist()
        # Target token lists are only consumed by the translation
        # cache (Request.process stores them for future hits); one
        # whole-matrix tolist beats per-row numpy slicing when needed.
        rows = (
            tokens[:n].tolist()
            if any(ref.request.cache is not None for ref in refs)
            else None
        )
        for i, ref in enumerate(refs):
            history = Hypothesis(
                target=rows[i][: steps_l[i]] if rows is not None else [],
                alignment=[],
                decoded=(
                    text[text_off_l[i] : text_off_l[i + 1]].tobytes(),
                    ends_l[ends_off_l[i] : ends_off_l[i + 1]],
                ),
            )
            ref.complete(history)


class Batcher:
    def __init__(
        self,
        max_words: int,
        wrap_length: int,
        tgt_length_limit_factor: float = 3.0,
    ):
        self.max_words = max_words
        slack = int(wrap_length * tgt_length_limit_factor) - wrap_length
        size = wrap_length + slack + 1
        if size - 1 > max_words:
            raise ValueError(
                "wrap_length > max_words would produce sentences longer "
                "than a batch can fit"
            )
        self._buckets: List[List[SegmentRef]] = [[] for _ in range(size)]
        self._running_max = 0
        self.pending_words = 0  # queued tokens (Threadsafe early-break)

    def enqueue(self, request: Request) -> int:
        """Insert all uncached segments; returns how many. Heap
        entries are ((request id, index), ref) so heap ordering uses
        C-speed tuple comparison, not SegmentRef.__lt__."""
        enqueued = 0
        rid = request.id
        for i in range(request.size()):
            if request.cached(i):
                continue
            ref = SegmentRef(i, request)
            length = ref.size()
            while length >= len(self._buckets):
                self._buckets.append([])
            heapq.heappush(self._buckets[length], ((rid, i), ref))
            self._running_max = max(self._running_max, length)
            self.pending_words += length
            enqueued += 1
        return enqueued

    def generate(self) -> Batch:
        """Greedy shortest-first packing under the max_words budget.

        A single segment longer than max_words (possible on pivot
        leg 2, which re-tokenizes without wrapping) is emitted as a
        singleton batch rather than stalling the pool (the reference
        asserts here, slimt/Batcher.cc:107-110)."""
        batch = Batch()
        for length in range(self._running_max + 1):
            bucket = self._buckets[length]
            while bucket:
                if (len(batch) + 1) * max(length, 1) <= self.max_words:
                    batch.add(heapq.heappop(bucket)[1])
                elif batch.empty():
                    batch.add(heapq.heappop(bucket)[1])  # oversize singleton
                    self.pending_words -= batch.token_count
                    return batch
                else:
                    self.pending_words -= batch.token_count
                    return batch
        self.pending_words -= batch.token_count
        return batch


class AggregateBatcher:
    """Per-model batchers + pending-model set; generate() returns
    (batch, model) pairs round-robin over pending models."""

    def __init__(
        self,
        max_words: int,
        wrap_length: int,
        tgt_length_limit_factor: float = 3.0,
    ):
        self.max_words = max_words
        self.wrap_length = wrap_length
        self.tgt_length_limit_factor = tgt_length_limit_factor
        self._batchers: Dict[int, Batcher] = {}
        self._models: Dict[int, object] = {}
        self._queue: List[int] = []  # pending model ids, insertion order

    def enqueue(self, model, request: Request) -> int:
        model_id = model.id
        if model_id not in self._batchers:
            self._batchers[model_id] = Batcher(
                self.max_words, self.wrap_length, self.tgt_length_limit_factor
            )
        if model_id not in self._queue:
            self._queue.append(model_id)
        self._models[model_id] = model
        return self._batchers[model_id].enqueue(request)

    @property
    def pending_words(self) -> int:
        return sum(b.pending_words for b in self._batchers.values())

    def generate(self) -> Tuple[Batch, Optional[object]]:
        while self._queue:
            model_id = self._queue[0]
            batch = self._batchers[model_id].generate()
            if not batch.empty():
                return batch, self._models[model_id]
            self._queue.pop(0)
        return Batch(), None


class Threadsafe:
    """Monitor wrapper over a batcher: enqueue notifies, generate
    blocks until work or shutdown; an empty batch is the shutdown
    poison (slimt/Batcher.hh:203-259).

    `batch_latency` > 0 adds a batching window: once work exists, a
    worker waits up to that many seconds for more segments before
    packing a batch. The reference has no such window (CPU workers
    want work instantly); a device worker amortizes per-call overhead
    over large batches, so trading a few ms of latency for occupancy
    is usually a large throughput win."""

    def __init__(self, inner, batch_latency: float = 0.0):
        self._inner = inner
        self._cond = threading.Condition()
        self._enqueued = 0
        self._shutdown = False
        self._batch_latency = batch_latency

    def enqueue(self, *args) -> int:
        with self._cond:
            assert not self._shutdown
            count = self._inner.enqueue(*args)
            self._enqueued += count
            self._cond.notify_all()
            return count

    def enqueue_many(self, items) -> int:
        """Enqueue a batch of argument tuples under ONE lock
        acquisition and ONE notify — the bulk-ingest path
        (translate_many); per-call enqueue would wake the workers
        thousands of times."""
        with self._cond:
            assert not self._shutdown
            count = 0
            for args in items:
                count += self._inner.enqueue(*args)
            self._enqueued += count
            self._cond.notify_all()
            return count

    def generate(self):
        import time as _time

        with self._cond:
            while True:
                while self._enqueued == 0 and not self._shutdown:
                    self._cond.wait()
                if self._batch_latency > 0 and not self._shutdown:
                    # Wait for more work, but break out as soon as a
                    # maximal batch can already be packed — under
                    # sustained load the window adds no occupancy,
                    # only dead time.
                    full = getattr(self._inner, "max_words", None)
                    deadline = _time.monotonic() + self._batch_latency
                    while True:
                        if full is not None and (
                            getattr(self._inner, "pending_words", 0) >= full
                        ):
                            break
                        remaining = deadline - _time.monotonic()
                        if remaining <= 0 or self._shutdown:
                            break
                        self._cond.wait(timeout=remaining)
                # Another worker may have drained the queue while we
                # sat in the latency window (the wait releases the
                # lock): an empty non-shutdown batch would be mistaken
                # for the shutdown poison by the worker loop — go back
                # to waiting instead.
                if self._enqueued == 0 and not self._shutdown:
                    continue
                result = self._inner.generate()
                batch = result[0] if isinstance(result, tuple) else result
                self._enqueued -= len(batch)
                return result

    def shutdown(self) -> None:
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()
