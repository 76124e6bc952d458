"""Bulk corpus translation: the high-throughput path.

The reference streams corpora through the Async worker pool one
request at a time (slimt/Frontend.cc:207-257) — the right design for
a CPU engine fed by interactive traffic. For a device engine translating
a known list of lines, the per-request machinery (Request objects,
locks, atomic countdowns, futures) is pure overhead: this module
flattens the whole corpus into segments, packs batches with the same
shortest-first / max_words rule as the Batcher
(slimt/Batcher.cc:95-120), dispatches every batch to the device before
fetching any result (JAX async dispatch pipelines them), and
assembles all Responses in one tight loop.

Response contents are exactly those of Blocking.translate — same
annotations, alignments, cache interaction (probe before translate,
store after; slimt/Request.cc:29-85), HTML extract/restore — verified
by tests/test_bulk.py differential tests. Pivot stays on the general
path.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from slimt_jax.runtime.request import Hypothesis, cache_key, cache_usable
from slimt_jax.runtime.response import Options, Response


# Tokenize the next chunk on the completion pool while the main
# thread flattens/dispatches the current one (the Rust batch encoder
# releases the GIL, so the stages overlap). Module flag so A/B
# measurement and emergency rollback don't need a code edit.
THREAD_LOOKAHEAD = True


def _pack(flat, max_words: int):
    """Greedy shortest-first packing under the `(n+1)*maxlen <=
    max_words` budget (slimt/Batcher.cc:95-120); an oversize segment
    becomes a singleton batch rather than stalling."""
    batches: List[list] = []
    current: list = []
    for item in flat:
        length = max(item[0], 1)
        # shortest-first order → `length` is the running max
        if current and (len(current) + 1) * length > max_words:
            batches.append(current)
            current = []
        current.append(item)
    if current:
        batches.append(current)
    return batches


def _ingest_and_dispatch(
    texts, chunk_lines, chunks, processed, hyps, keys,
    model, config, cache, need_alignment, fetch, pool,
    ingest_pool=None, process=None,
):
    """Tokenize the corpus chunk by chunk and dispatch each chunk's
    batches before the next chunk tokenizes (appending per-chunk work
    to `chunks` as it goes, so a failure can be drained by the
    caller). With `ingest_pool`, all chunks fan out to worker
    processes immediately and this thread consumes them in order —
    tokenization then scales across cores instead of being capped by
    this process's GIL."""
    model_id = model.id
    if process is None:
        def process(chunk):
            return model.processor.process_batch(chunk, config.wrap_length)
    pending = []  # (lo, chunk texts, ingest future or None)
    for lo in range(0, len(texts), chunk_lines):
        chunk = texts[lo : lo + chunk_lines]
        future = (
            ingest_pool.submit(model, chunk, config.wrap_length)
            if ingest_pool is not None and len(texts) > chunk_lines
            else None
        )
        pending.append((lo, chunk, future))

    lookahead = (
        THREAD_LOOKAHEAD
        and ingest_pool is None
        and pool is not None
        and len(pending) > 1
    )
    if lookahead:
        # Thread-lookahead: tokenize the NEXT chunk on the completion
        # pool while this thread flattens/packs/dispatches the current
        # one. The Rust batch tokenizer releases the GIL, so the two
        # stages genuinely overlap. Submitted one ahead (not all at
        # once) so ingest tasks never queue behind this chunk's
        # fetches on the shared pool.
        pending = [
            (
                lo,
                chunk,
                pool.submit(process, chunk) if i == 1 else None,
            )
            for i, (lo, chunk, _) in enumerate(pending)
        ]

    for idx, (lo, chunk, future) in enumerate(pending):
        chunk_processed = (
            future.result() if future is not None else process(chunk)
        )
        if (
            lookahead
            and idx + 2 < len(pending)
            and pending[idx + 2][2] is None
        ):
            nlo, nchunk, _ = pending[idx + 2]
            pending[idx + 2] = (
                nlo,
                nchunk,
                pool.submit(process, nchunk),
            )

        # Flatten segments; probe the cache exactly like Request
        # construction does (slimt/Request.cc:29-85).
        flat: List[Tuple[int, int, int, list]] = []  # (len, line, sent, seg)
        for li, (annotated, segments) in enumerate(
            chunk_processed, start=len(processed)
        ):
            slots: List[Optional[Hypothesis]] = [None] * len(segments)
            kslots: List[Optional[int]] = [None] * len(segments)
            for si, seg in enumerate(segments):
                if cache is not None:
                    key = cache_key(model_id, seg)
                    kslots[si] = key
                    found, history = cache.find(key)
                    if found and cache_usable(history, need_alignment):
                        slots[si] = history
                        continue
                flat.append((len(seg), li, si, seg))
            hyps.append(slots)
            keys.append(kslots)
        processed.extend(chunk_processed)

        flat.sort(key=lambda t: (t[0], t[1], t[2]))
        work = []  # pool: futures; serial: (batch, finish) pairs
        for b in _pack(flat, config.max_words):
            finish = model.forward_async(
                [item[3] for item in b], need_alignment=need_alignment
            )
            work.append(
                pool.submit(fetch, b, finish) if pool is not None
                else (b, finish)
            )
        chunks.append((lo, len(processed), work))


def translate_bulk(
    model,
    sources: List[str],
    config,
    cache=None,
    options: Optional[Options] = None,
    meters=None,
    pool=None,
    ingest_pool=None,
    process=None,
) -> List[Response]:
    """`process` overrides the chunk-ingest step (chunk of `sources`
    → [(AnnotatedText, Segments)]): pivot leg 2 passes re-tokenization
    of already-annotated pivot texts (process_annotated_batch); the
    default is the splitter+wrap TextProcessor.process_batch. With a
    custom process, `sources` need not be strings and the columnar /
    HTML / worker-process ingest lanes (raw-string-specific) are
    bypassed."""
    options = options or Options()
    need_alignment = bool(options.alignment or options.html)

    if getattr(model, "_multiprocess", False):
        # finish() runs process_allgather collectives: every host must
        # issue them for the SAME batch in the SAME order. Pool fetches
        # would let hosts interleave different batches' collectives and
        # deadlock the slice — fetch serially in dispatch order.
        pool = None

    if (
        process is None
        and not need_alignment
        and ingest_pool is None
        and not getattr(model, "_multiprocess", False)
        and model.vocabulary.resolved_batch_backend == "native"
    ):
        return _translate_bulk_columnar(
            model, sources, config, cache=cache, meters=meters, pool=pool
        )
    if process is not None:
        ingest_pool = None

    htmls = None
    texts = list(sources)
    if options.html and process is None:
        from slimt_jax.html.html import HTML

        htmls = []
        for i, source in enumerate(texts):
            html = HTML(source)
            htmls.append(html)
            texts[i] = html.source

    import threading

    from slimt_jax.utils import Timer

    timer = Timer()
    meter_lock = threading.Lock()  # Timer.elapsed/reset is not atomic
    vocabulary = model.vocabulary

    processed: List[tuple] = []
    hyps: List[List[Optional[Hypothesis]]] = []
    keys: List[List[Optional[int]]] = []

    def fetch(b, finish):
        """Fetch one batch's results and slot them in. Each (li, si)
        slot is written by exactly one batch, so concurrent fetches
        need no locking; finish() releases the GIL during the
        device→host transfer (and decode_batch during the native
        call), so a small pool overlaps the per-batch round-trip
        latency and the ingest of later chunks."""
        histories = finish()
        decoded = vocabulary.decode_batch(
            [history.target for history in histories]
        )
        for (length, li, si, seg), history, dec in zip(b, histories, decoded):
            history.decoded = dec
            hyps[li][si] = history
            if cache is not None:
                cache.store(keys[li][si], history)
        if meters is not None:
            tokens = sum(item[0] for item in b)
            with meter_lock:
                meters.record_batch(
                    words=tokens,
                    elapsed=timer.elapsed(),
                    used=tokens,
                    capacity=len(b) * max(b[-1][0], 1),
                )
                timer.reset()

    # The corpus is ingested in chunks: each chunk's batches are
    # dispatched (and, with a pool, fetched concurrently) before the
    # next chunk tokenizes, so device compute and result round-trips
    # hide behind host ingest instead of following it. Chunking does
    # not change outputs — segments translate independently and
    # padding is inert (differential-tested vs the general path).
    chunk_lines = getattr(config, "bulk_chunk_lines", 2048) or len(texts) or 1
    chunks: List[tuple] = []  # (line_lo, line_hi, per-chunk fetch work)
    try:
        _ingest_and_dispatch(
            texts, chunk_lines, chunks, processed, hyps, keys,
            model, config, cache, need_alignment, fetch, pool,
            ingest_pool=ingest_pool, process=process,
        )
    except BaseException:
        # An ingest/dispatch failure (bad input, XLA error) must not
        # leave pool fetches of earlier chunks mutating shared state
        # after the caller sees the exception.
        for _lo, _hi, work in chunks:
            for item in work:
                if pool is not None:
                    try:
                        item.result()
                    except Exception:  # noqa: BLE001
                        pass  # the ingest error is what propagates
        raise

    # Drain and assemble chunk by chunk: while chunk i assembles on
    # this thread, later chunks' fetches keep running on the pool —
    # only the last chunk's assembly is not hidden. On any fetch
    # error, keep draining (no thread may still be mutating state
    # when the error propagates) but skip further assembly.
    responses: List[Response] = []
    first_err = None
    for lo, hi, work in chunks:
        for item in work:
            try:
                if pool is not None:
                    item.result()
                else:
                    fetch(*item)
            except Exception as e:  # noqa: BLE001
                if first_err is None:
                    first_err = e
        if first_err is not None:
            continue
        # Assemble Responses — the Request._complete loop, inlined.
        for li in range(lo, hi):
            annotated, _segments = processed[li]
            slots = hyps[li]
            response = Response()
            response.source = annotated
            target = response.target
            n = len(slots)
            for si, history in enumerate(slots):
                if history.decoded is None:  # cache hit predating decode
                    history.decoded = vocabulary.decode_batch(
                        [history.target]
                    )[0]
                data, ends = history.decoded
                target.append_sentence_raw(annotated.gap_data(si), data, ends)
                if si + 1 == n:
                    target.append_ending_whitespace_data(annotated.gap_data(n))
                response.alignments.append(history.alignment)
            if htmls is not None:
                htmls[li].restore(response)
            responses.append(response)
    if first_err is not None:
        raise first_err
    return responses


def _translate_bulk_columnar(
    model, sources: List[str], config, cache=None, meters=None, pool=None
) -> List[Response]:
    """The columnar bulk lane: per chunk, ONE native ingest call
    (tokenize + wrap + annotate), vectorized numpy batch packing, raw
    device results decoded straight from the padded token matrix in
    ONE native call per batch, and per-line target text/annotations
    built by ONE native assemble call — no per-token Python objects
    anywhere. Sources/targets carry lazy annotations (materialized on
    first access). Output identical to the general bulk path
    (differential-tested); lines touching the translation cache fall
    back to per-line Python assembly (their content lives outside the
    batch buffers). Alignment/HTML requests use the general path."""
    import threading

    import numpy as np

    from slimt_jax import native as native_mod
    from slimt_jax.models.model import _bucket_batch, _bucket_seq
    from slimt_jax.text.annotation import AnnotatedText
    from slimt_jax.text.splitter import SentenceStream, SplitMode
    from slimt_jax.text.vocabulary import byte_prefix
    from slimt_jax.utils import Timer

    vocab = model.vocabulary
    nat = vocab._native
    eos = vocab.eos_id
    pad_id = vocab.pad_id
    model_id = model.id
    wrap = config.wrap_length
    max_words = config.max_words
    data_size = getattr(model, "_data_size", 1)
    processor = model.processor

    timer = Timer()
    meter_lock = threading.Lock()

    texts = list(sources)
    chunk_lines = getattr(config, "bulk_chunk_lines", 2048) or len(texts) or 1

    one_per_line = processor.mode == SplitMode.ONE_SENTENCE_PER_LINE

    def split_chunk(chunk_texts):
        line_datas: List[bytes] = []
        sent_begin: List[int] = []
        sent_end: List[int] = []
        sent_counts: List[int] = []
        for text in chunk_texts:
            data = text.encode("utf-8")
            line_datas.append(data)
            if one_per_line and "\n" not in text and not text.endswith(
                "\r"
            ):
                # single line: the sentence IS the whole text
                # (splitter._read_line semantics)
                if text:
                    sent_begin.append(0)
                    sent_end.append(len(data))
                    sent_counts.append(1)
                else:
                    sent_counts.append(0)
                continue
            count = 0
            prefix = None if len(data) == len(text) else byte_prefix(text)
            for s, b, e in SentenceStream(
                text, processor.splitter, processor.mode
            ):
                if not s:
                    continue
                if prefix is None:
                    sent_begin.append(b)
                    sent_end.append(e)
                else:
                    sent_begin.append(prefix[b])
                    sent_end.append(prefix[e])
                count += 1
            sent_counts.append(count)
        return line_datas, sent_begin, sent_end, sent_counts

    class Chunk:
        __slots__ = (
            "line_datas", "seg_ids", "bounds", "seg_line", "tb",
            "tb_counts", "gap", "gap_counts", "lengths", "seg_starts",
            "seg_counts", "keys", "hits", "seg_batch", "seg_row",
            "seg_text_len", "seg_steps", "brecs", "work",
        )

    def ingest_chunk(split):
        line_datas, sent_begin, sent_end, sent_counts = split
        c = Chunk()
        c.line_datas = line_datas
        n = len(line_datas)
        (c.seg_ids, c.bounds, c.seg_line, c.tb, c.tb_counts,
         c.gap, c.gap_counts) = nat.ingest_lines(
            line_datas, sent_begin, sent_end, sent_counts, wrap, eos,
            raw=True,
        )
        S = len(c.seg_line)
        c.lengths = np.diff(c.bounds)
        counts = (
            np.bincount(c.seg_line, minlength=n).astype(np.int64)
            if S
            else np.zeros(n, np.int64)
        )
        c.seg_counts = counts
        c.seg_starts = np.zeros(n, np.int64)
        if n:
            np.cumsum(counts[:-1], out=c.seg_starts[1:])
        c.seg_batch = np.full(S, -1, np.int32)
        c.seg_row = np.zeros(S, np.int32)
        c.seg_text_len = np.zeros(S, np.int64)
        c.seg_steps = np.zeros(S, np.int32)
        c.brecs = []
        c.keys = None
        c.hits = {}
        if cache is not None and S:
            ids_list = c.seg_ids.tolist()
            b_list = c.bounds.tolist()
            keys = []
            hit = []
            for s in range(S):
                key = cache_key(model_id, ids_list[b_list[s] : b_list[s + 1]])
                keys.append(key)
                found, h = cache.find(key)
                if found and cache_usable(h, False):
                    c.hits[s] = h
                    hit.append(s)
            c.keys = keys
            fresh = np.ones(S, bool)
            if hit:
                fresh[hit] = False
            c.work = np.nonzero(fresh)[0]
        else:
            c.work = np.arange(S)
        return c

    def dispatch_chunk(c):
        """Pack fresh segments shortest-first under the max_words rule
        (slimt/Batcher.cc:95-120) and dispatch every batch; returns
        (batch_no, idx array, finish) triples."""
        work = c.work
        if len(work) == 0:
            return []
        order = work[np.argsort(c.lengths[work], kind="stable")]
        lens = c.lengths[order].tolist()
        # greedy packing: boundaries over the sorted run
        batches = []
        start = 0
        count = 0
        for i, length in enumerate(lens):
            length = max(length, 1)
            if count and (count + 1) * length > max_words:
                batches.append((start, i))
                start = i
                count = 0
            count += 1
        if count:
            batches.append((start, len(lens)))

        out = []
        for bno, (lo, hi) in enumerate(batches):
            idx = order[lo:hi]
            n_rows = len(idx)
            lens_b = c.lengths[idx]
            t_pad = _bucket_seq(int(lens_b[-1]))
            b_pad = -(-_bucket_batch(n_rows) // data_size) * data_size
            indices = np.full((b_pad, t_pad), pad_id, np.int32)
            mask = np.zeros((b_pad, t_pad), np.float32)
            col = np.arange(t_pad)[None, :]
            colmask = col < lens_b[:, None]
            srcpos = (c.bounds[idx][:, None] + col)[colmask]
            gathered = c.seg_ids[srcpos]
            indices[:n_rows][colmask] = gathered
            mask[:n_rows][colmask] = 1.0
            words = (
                gathered if model.shortlist_generator is not None else None
            )
            finish = model.forward_async_arrays(
                indices, mask, lens_b, n_rows,
                need_alignment=False, shortlist_words=words, raw=True,
            )
            c.brecs.append(None)
            out.append((bno, idx, finish))
        return out

    def fetch(c, bno, idx, finish):
        """Fetch one batch: decode the padded token matrix natively and
        record per-segment locations; GIL-releasing device transfer +
        native decode overlap across the pool."""
        tokens, steps, _align = finish()
        n_rows = len(idx)
        text, text_off, ends, ends_off = nat.decode_padded(
            tokens[:n_rows], steps
        )
        c.brecs[bno] = (text, text_off, ends, ends_off)
        c.seg_batch[idx] = bno
        c.seg_row[idx] = np.arange(n_rows, dtype=np.int32)
        c.seg_text_len[idx] = np.diff(text_off.astype(np.int64))
        c.seg_steps[idx] = steps
        if cache is not None:
            steps_l = steps.tolist()
            rows = tokens[:n_rows].tolist()
            for i, s in enumerate(idx.tolist()):
                cache.store(
                    c.keys[s],
                    Hypothesis(
                        target=rows[i][: steps_l[i]], alignment=[]
                    ),
                )
        if meters is not None:
            used = int(c.lengths[idx].sum())
            with meter_lock:
                meters.record_batch(
                    words=used,
                    elapsed=timer.elapsed(),
                    used=used,
                    capacity=n_rows * max(int(c.lengths[idx][-1]), 1),
                )
                timer.reset()

    def assemble_chunk(c):
        n = len(c.line_datas)
        line_has_hit = np.zeros(n, bool)
        if c.hits:
            line_has_hit[c.seg_line[list(c.hits)]] = True
        seg_counts_c = c.seg_counts.astype(np.int32)
        if c.hits:
            seg_counts_c = seg_counts_c.copy()
            seg_counts_c[line_has_hit] = -1
        src_blob = b"".join(c.line_datas)
        src_line_off = np.zeros(n + 1, np.uint64)
        np.cumsum([len(d) for d in c.line_datas], out=src_line_off[1:])
        src_tb_off = np.zeros(n + 1, np.int64)
        np.cumsum(c.tb_counts, out=src_tb_off[1:])
        src_gap_off = np.zeros(n + 1, np.int64)
        np.cumsum(c.gap_counts, out=src_gap_off[1:])

        (out_text, out_text_off, out_tb, out_tbc, out_gap, out_gapc) = (
            native_mod.assemble_lines(
                src_blob, src_line_off, c.tb, src_tb_off, c.gap,
                src_gap_off, seg_counts_c, c.seg_starts, c.seg_batch,
                c.seg_row, c.brecs, c.seg_text_len, c.seg_steps,
            )
            if n
            else (None,) * 6
        )
        tb_l = src_tb_off.tolist()
        gap_l = src_gap_off.tolist()
        out_text_l = out_text_off.tolist() if n else []
        out_tb_off = np.zeros(n + 1, np.int64)
        out_gap_off = np.zeros(n + 1, np.int64)
        if n:
            np.cumsum(out_tbc, out=out_tb_off[1:])
            np.cumsum(out_gapc, out=out_gap_off[1:])
        out_tb_l = out_tb_off.tolist()
        out_gap_l = out_gap_off.tolist()

        seg_starts_l = c.seg_starts.tolist()
        seg_counts_l = c.seg_counts.tolist()
        responses = []
        blank_response = Response._blank  # every field set below
        for li in range(n):
            response = blank_response()
            response.source = AnnotatedText.from_arrays(
                c.line_datas[li],
                c.tb[tb_l[li] : tb_l[li + 1]],
                c.gap[gap_l[li] : gap_l[li + 1]],
            )
            k = seg_counts_l[li]
            if not line_has_hit[li]:
                response.target = AnnotatedText.from_arrays(
                    out_text[out_text_l[li] : out_text_l[li + 1]],
                    out_tb[out_tb_l[li] : out_tb_l[li + 1]],
                    out_gap[out_gap_l[li] : out_gap_l[li + 1]],
                )
                response.alignments = [[] for _ in range(k)]
            else:
                response.target = target = AnnotatedText()
                response.alignments = []
                annotated = response.source
                lo = seg_starts_l[li]
                for si in range(k):
                    s = lo + si
                    hit = c.hits.get(s)
                    if hit is not None:
                        if hit.decoded is None:
                            hit.decoded = vocab.decode_batch(
                                [hit.target]
                            )[0]
                        data, ends = hit.decoded
                    else:
                        bno = int(c.seg_batch[s])
                        row = int(c.seg_row[s])
                        text, text_off, ends_arr, ends_off = c.brecs[bno]
                        t0, t1 = int(text_off[row]), int(text_off[row + 1])
                        e0, e1 = int(ends_off[row]), int(ends_off[row + 1])
                        data = text[t0:t1].tobytes()
                        ends = ends_arr[e0:e1].tolist()
                    target.append_sentence_raw(
                        annotated.gap_data(si), data, ends
                    )
                    if si + 1 == k:
                        target.append_ending_whitespace_data(
                            annotated.gap_data(k)
                        )
                    response.alignments.append(
                        hit.alignment if hit is not None else []
                    )
            responses.append(response)
        return responses

    # Chunk pipeline: split chunk i+1 on the pool while chunk i
    # ingests/dispatches here; fetches run on the pool; per-chunk
    # assembly overlaps later chunks' fetches (same structure as the
    # general bulk path).
    spans = [
        texts[lo : lo + chunk_lines]
        for lo in range(0, len(texts), chunk_lines)
    ]
    lookahead = THREAD_LOOKAHEAD and pool is not None and len(spans) > 1
    split_futures: List = [None] * len(spans)
    if lookahead:
        split_futures[1] = pool.submit(split_chunk, spans[1])

    chunk_work = []  # (chunk, [fetch futures or (args) tuples])
    try:
        for i, span in enumerate(spans):
            fut = split_futures[i]
            split = fut.result() if fut is not None else split_chunk(span)
            if lookahead and i + 2 < len(spans):
                split_futures[i + 2] = pool.submit(split_chunk, spans[i + 2])
            c = ingest_chunk(split)
            triples = dispatch_chunk(c)
            work = [
                pool.submit(fetch, c, bno, idx, fin) if pool is not None
                else (c, bno, idx, fin)
                for bno, idx, fin in triples
            ]
            chunk_work.append((c, work))
    except BaseException:
        for _c, work in chunk_work:
            for item in work:
                if pool is not None:
                    try:
                        item.result()
                    except Exception:  # noqa: BLE001
                        pass
        raise

    responses: List[Response] = []
    first_err = None
    for c, work in chunk_work:
        for item in work:
            try:
                if pool is not None:
                    item.result()
                else:
                    fetch(*item)
            except Exception as e:  # noqa: BLE001
                if first_err is None:
                    first_err = e
        if first_err is None:
            responses.extend(assemble_chunk(c))
    if first_err is not None:
        raise first_err
    return responses
