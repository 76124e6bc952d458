"""Service frontends: Blocking and Async translation.

Mirrors slimt/Frontend.{hh,cc}:

  - Blocking: per-call local Batcher; enqueue all requests, then an
    exhaust loop (generate → forward → complete) on the caller thread
    (slimt/Frontend.cc:42-60,91-145).
  - Async: shared Threadsafe[AggregateBatcher] + N worker threads; the
    caller gets a Handle (future + progress); pivot chains a second
    request from the first leg's continuation (CPS)
    (slimt/Frontend.cc:207-314).

The device forward releases the GIL while XLA executes, so worker
threads overlap host batching with device compute.
"""

from __future__ import annotations

import itertools
import threading
from concurrent.futures import Future
from typing import List, Optional

from slimt_jax.config import Config
from slimt_jax.runtime.batcher import AggregateBatcher, Batch, Batcher, Threadsafe
from slimt_jax.runtime.cache import make_cache
from slimt_jax.runtime.request import Request
from slimt_jax.runtime.response import Handle, Options, Response, combine


def _make_request(
    ids, model, cache, annotated, segments, continuation,
    needs_alignment=True,
):
    return Request(
        next(ids),
        model.id,
        annotated,
        segments,
        model.vocabulary,
        cache,
        continuation,
        needs_alignment=needs_alignment,
    )


def _needs_alignment(batch: Batch) -> bool:
    return any(ref.request.needs_alignment for ref in batch.segment_refs)


# Differential-test toggle (tests/test_service.py): False pins every
# batch to the historical per-row completion path.
RAW_COMPLETION = True


def _use_raw(model, need_alignment: bool) -> bool:
    """Alignment-free batches with the native tokenizer complete
    through the columnar path (Batch.complete_raw — one decode call
    per device batch, no per-row Hypothesis/tolist work); alignment
    batches keep the per-row path that materializes the attention
    matrices."""
    return (
        RAW_COMPLETION
        and not need_alignment
        and model.vocabulary.resolved_batch_backend == "native"
    )


def _complete_batch(model, batch: Batch, finish, raw: bool) -> None:
    if raw:
        tokens, steps, _align = finish()
        batch.complete_raw(tokens, steps, model.vocabulary)
    else:
        batch.complete(finish())


def _exhaust(model, batcher: Batcher, meters=None, pool=None) -> None:
    """Translate until the batcher runs dry, recording wps/occupancy
    (slimt/Frontend.cc:42-60).

    All device batches are dispatched before any result is fetched:
    JAX's async dispatch pipelines them, hiding host↔device round
    trips behind compute (the reference's loop is strictly serial).
    With `pool`, host-side completion (detokenize + response
    assembly) runs on executor threads, overlapping the device waits
    for later batches — completion is already exercised concurrently
    by the Async workers, so it is thread-safe by construction."""
    from slimt_jax.utils import Timer

    while True:
        timer = Timer()
        in_flight = []
        batch = batcher.generate()
        while not batch.empty():
            segments = [ref.get() for ref in batch.segment_refs]
            need_alignment = _needs_alignment(batch)
            raw = _use_raw(model, need_alignment)
            finish = model.forward_async(
                segments, need_alignment=need_alignment, raw=raw
            )
            in_flight.append((batch, len(segments), finish, raw))
            batch = batcher.generate()
        if not in_flight:
            return

        pending = []
        try:
            for batch, n_segments, finish, raw in in_flight:
                if pool is None:
                    _complete_batch(model, batch, finish, raw)
                else:
                    # finish() (the device→host fetch) rides the pool
                    # too, so fetches of several batches overlap.
                    pending.append(
                        pool.submit(_complete_batch, model, batch, finish, raw)
                    )
                if meters is not None:
                    meters.record_batch(
                        words=batch.token_count,
                        elapsed=timer.elapsed(),
                        used=batch.token_count,
                        capacity=n_segments * max(batch.max_length, 1),
                    )
                    timer.reset()
        finally:
            # Drain even if a later finish() raised, so no completion
            # thread is still mutating responses after translate()
            # propagates the error (serial-mode semantics).
            import sys

            first_err = None
            for done in pending:
                try:
                    done.result()
                except Exception as e:  # noqa: BLE001
                    if first_err is None:
                        first_err = e
            if first_err is not None and sys.exc_info()[0] is None:
                raise first_err
        # completions may have enqueued follow-up work


class Blocking:
    def __init__(self, config: Optional[Config] = None):
        from concurrent.futures import ThreadPoolExecutor

        from slimt_jax.utils import ServiceMeters, tune_gc

        self.config = config or Config()
        tune_gc(self.config.gc_gen0_threshold)
        self.cache = make_cache(self.config.cache_size)
        self._ids = itertools.count()
        self.meters = ServiceMeters()
        self._pool = (
            ThreadPoolExecutor(
                max_workers=self.config.completion_threads,
                thread_name_prefix="slimt-complete",
            )
            if self.config.completion_threads > 0
            else None
        )
        self._ingest_pool = None
        if self.config.ingest_processes > 0:
            from slimt_jax.text.ingest_pool import IngestPool

            self._ingest_pool = IngestPool(self.config.ingest_processes)

    def close(self) -> None:
        """Shut down the completion + ingest pools (idempotent)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        if self._ingest_pool is not None:
            self._ingest_pool.close()
            self._ingest_pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        pool = getattr(self, "_pool", None)
        if pool is not None:
            pool.shutdown(wait=False)
        ingest = getattr(self, "_ingest_pool", None)
        if ingest is not None:
            ingest.close()

    def translate(
        self,
        model,
        sources: List[str],
        options: Optional[Options] = None,
    ) -> List[Response]:
        """Translate a list of texts (reference Blocking::translate,
        slimt/Frontend.cc:91-145). Routes through the bulk lane by
        default (identical Responses, differential-tested; higher host
        throughput); Config(prefer_bulk=False) pins the per-request
        exhaust loop."""
        if self.config.prefer_bulk:
            return self.translate_bulk(model, sources, options)
        return self._translate_requests(model, sources, options)

    def _translate_requests(
        self,
        model,
        sources: List[str],
        options: Optional[Options] = None,
    ) -> List[Response]:
        options = options or Options()
        batcher = Batcher(
            self.config.max_words,
            self.config.wrap_length,
            self.config.tgt_length_limit_factor,
        )

        htmls = []
        texts = list(sources)
        if options.html:
            from slimt_jax.html.html import HTML

            for i, source in enumerate(texts):
                html = HTML(source)
                htmls.append(html)
                texts[i] = html.source

        responses: List[Optional[Response]] = [None] * len(texts)

        def make_continuation(i):
            def continuation(response: Response):
                if options.html:
                    htmls[i].restore(response)
                responses[i] = response
                return None

            return continuation

        processed = model.processor.process_batch(
            texts, self.config.wrap_length
        )
        for i, (annotated, segments) in enumerate(processed):
            request = _make_request(
                self._ids, model, self.cache, annotated, segments,
                make_continuation(i),
                needs_alignment=options.alignment or options.html,
            )
            batcher.enqueue(request)

        _exhaust(model, batcher, self.meters, self._pool)
        assert all(r is not None for r in responses)
        return responses

    def translate_bulk(
        self,
        model,
        sources: List[str],
        options: Optional[Options] = None,
        process=None,
    ) -> List[Response]:
        """Corpus fast path: same Responses as translate() with
        prefer_bulk=False (identical annotations/alignments/cache/HTML
        semantics — differential-tested), but without per-request
        machinery, so at a multiple of the host throughput of the
        per-request exhaust loop. translate() routes here by default. `process`
        overrides the chunk-ingest step (see bulk.translate_bulk);
        pivot leg 2 passes process_annotated_batch."""
        from slimt_jax.runtime.bulk import translate_bulk

        return translate_bulk(
            model,
            sources,
            self.config,
            cache=self.cache,
            options=options,
            meters=self.meters,
            pool=self._pool,
            ingest_pool=self._ingest_pool,
            process=process,
        )

    def pivot(
        self,
        first,
        second,
        sources: List[str],
        options: Optional[Options] = None,
    ) -> List[Response]:
        """source → pivot → target with alignment remapping
        (slimt/Frontend.cc:147-205)."""
        options = options or Options()

        htmls = []
        texts = list(sources)
        if options.html:
            from slimt_jax.html.html import HTML

            for i, source in enumerate(texts):
                html = HTML(source)
                htmls.append(html)
                texts[i] = html.source

        raw = Options(
            alignment=options.alignment or options.html, html=False
        )
        source_to_pivots = self.translate(first, texts, raw)

        if self.config.prefer_bulk:
            # Leg 2 on the bulk lane: the re-tokenized pivot texts are
            # a known list, so the Request machinery is skipped; the
            # custom `process` re-tokenizes each chunk preserving
            # sentence boundaries (identical outputs to the request
            # path — differential-tested).
            pivot_to_targets = self.translate_bulk(
                second,
                [r.target for r in source_to_pivots],
                raw,
                process=second.processor.process_annotated_batch,
            )
            responses = [
                combine(first_leg, second_leg)
                for first_leg, second_leg in zip(
                    source_to_pivots, pivot_to_targets
                )
            ]
        else:
            batcher = Batcher(
                self.config.max_words,
                self.config.wrap_length,
                self.config.tgt_length_limit_factor,
            )
            responses = [None] * len(source_to_pivots)

            def make_continuation(i, first_leg):
                def continuation(pivot_to_target: Response):
                    responses[i] = combine(first_leg, pivot_to_target)
                    return None

                return continuation

            processed = second.processor.process_annotated_batch(
                [r.target for r in source_to_pivots]
            )
            for i, source_to_pivot in enumerate(source_to_pivots):
                annotated, segments = processed[i]
                request = _make_request(
                    self._ids, second, self.cache, annotated, segments,
                    make_continuation(i, source_to_pivot),
                    needs_alignment=options.alignment or options.html,
                )
                batcher.enqueue(request)

            _exhaust(second, batcher, self.meters, self._pool)

        if options.html:
            for html, response in zip(htmls, responses):
                html.restore(response)
        return responses


class Async:
    def __init__(self, config: Optional[Config] = None):
        from slimt_jax.utils import ServiceMeters, tune_gc

        self.config = config or Config()
        tune_gc(self.config.gc_gen0_threshold)
        self.cache = make_cache(self.config.cache_size)
        self.meters = ServiceMeters()
        self._ids = itertools.count()
        self.batcher = Threadsafe(
            AggregateBatcher(
                self.config.max_words,
                self.config.wrap_length,
                self.config.tgt_length_limit_factor,
            ),
            batch_latency=self.config.batch_latency,
        )
        self._workers = [
            threading.Thread(target=self._work, daemon=True)
            for _ in range(self.config.workers)
        ]
        for worker in self._workers:
            worker.start()

    def _work(self) -> None:
        """Worker loop (slimt/Frontend.cc:212-227); empty batch =
        shutdown poison. A failing batch fails its requests (futures
        get the exception) instead of killing the worker."""
        import logging

        import time

        while True:
            batch, model = self.batcher.generate()
            if batch.empty():
                return
            try:
                t0 = time.perf_counter()
                need_alignment = _needs_alignment(batch)
                raw = _use_raw(model, need_alignment)
                finish = model.forward_async(
                    [ref.get() for ref in batch.segment_refs],
                    need_alignment=need_alignment, raw=raw,
                )
                _complete_batch(model, batch, finish, raw)
                self.meters.record_batch(
                    words=batch.token_count,
                    elapsed=time.perf_counter() - t0,
                    used=batch.token_count,
                    capacity=len(batch.segment_refs)
                    * max(batch.max_length, 1),
                )
            except Exception as e:  # noqa: BLE001
                logging.getLogger(__name__).exception(
                    "translation batch failed"
                )
                for ref in batch.segment_refs:
                    ref.request.fail(e)

    def translate(
        self, model, source: str, options: Optional[Options] = None
    ) -> Handle:
        options = options or Options()
        html = None
        if options.html:
            from slimt_jax.html.html import HTML

            html = HTML(source)
            source = html.source

        future: Future = Future()

        def continuation(response: Response):
            try:
                if html is not None:
                    html.restore(response)
                future.set_result(response)
            except Exception as e:  # noqa: BLE001
                future.set_exception(e)
            return None

        annotated, segments = model.processor.process(
            source, self.config.wrap_length
        )
        request = _make_request(
            self._ids, model, self.cache, annotated, segments, continuation,
            needs_alignment=options.alignment or options.html,
        )
        request.on_error = future.set_exception
        self.batcher.enqueue(model, request)
        return Handle(request, parts=1, future=future)

    def translate_many(
        self,
        model,
        sources: List[str],
        options: Optional[Options] = None,
    ) -> List[Handle]:
        """Batch submission: tokenizes all inputs in one parallel
        encode_batch and enqueues them together (one notify), so
        workers see full queues immediately — the high-throughput
        ingest path for corpus workloads."""
        options = options or Options()
        htmls: List[Optional[object]] = [None] * len(sources)
        texts = list(sources)
        if options.html:
            from slimt_jax.html.html import HTML

            for i, source in enumerate(texts):
                html = HTML(source)
                htmls[i] = html
                texts[i] = html.source

        handles = []
        # CHUNKED ingest (1024 lines): each chunk is one batched
        # native tokenize + one enqueue_many, so workers start on the
        # first chunk while the caller thread ingests the rest, instead
        # of every worker idling through a serial whole-corpus ingest.
        # The native ingest/decode calls release the GIL, so the
        # overlap is real parallelism, not time-slicing.
        chunk_lines = 1024
        for start in range(0, len(texts), chunk_lines):
            chunk = texts[start : start + chunk_lines]
            processed = model.processor.process_batch(
                chunk, self.config.wrap_length
            )
            pending = []
            for html, (annotated, segments) in zip(
                htmls[start : start + chunk_lines], processed
            ):
                future: Future = Future()

                def continuation(
                    response: Response, html=html, future=future
                ):
                    try:
                        if html is not None:
                            html.restore(response)
                        future.set_result(response)
                    except Exception as e:  # noqa: BLE001
                        future.set_exception(e)
                    return None

                request = _make_request(
                    self._ids, model, self.cache, annotated, segments,
                    continuation,
                    needs_alignment=options.alignment or options.html,
                )
                request.on_error = future.set_exception
                pending.append((model, request))
                handles.append(Handle(request, parts=1, future=future))
            # One lock/notify per chunk: workers wake to a full queue
            # instead of being poked once per request.
            self.batcher.enqueue_many(pending)
        return handles

    def pivot(
        self, first, second, source: str, options: Optional[Options] = None
    ) -> Handle:
        """CPS-chained two-leg translation
        (slimt/Frontend.cc:259-314)."""
        options = options or Options()
        html = None
        if options.html:
            from slimt_jax.html.html import HTML

            html = HTML(source)
            source = html.source

        future: Future = Future()

        def continuation(partial: Response):
            def joining(pivot_to_target: Response):
                try:
                    response = combine(partial, pivot_to_target)
                    if html is not None:
                        html.restore(response)
                    future.set_result(response)
                except Exception as e:  # noqa: BLE001
                    future.set_exception(e)
                return None

            annotated, segments = second.processor.process_annotated(
                partial.target
            )
            request = _make_request(
                self._ids, second, self.cache, annotated, segments, joining,
                needs_alignment=options.alignment or options.html,
            )
            request.on_error = future.set_exception
            self.batcher.enqueue(second, request)
            return request

        annotated, segments = first.processor.process(
            source, self.config.wrap_length
        )
        request = _make_request(
            self._ids, first, self.cache, annotated, segments, continuation,
            needs_alignment=options.alignment or options.html,
        )
        request.on_error = future.set_exception
        self.batcher.enqueue(first, request)
        return Handle(request, parts=2, future=future)

    def close(self) -> None:
        self.batcher.shutdown()
        for worker in self._workers:
            worker.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
