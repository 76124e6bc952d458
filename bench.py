"""Benchmarks, run on the GPU.

Each mode prints ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "device": {...}, ...}
`device` names what the number was measured on: JAX's platform,
device_kind and device count, and the card's name and power limit as
nvidia-smi reports them. A run that finds no GPU exits nonzero before
measuring anything: a CPU timing is never a device number.

Modes:
    python bench.py            # headline: tiny11 INT8 batched decode
    python bench.py headline_shortlist  # device-level shortlisted decode
    python bench.py batch1     # tiny11 greedy batch=1 latency
    python bench.py shortlist  # shortlist through the full service
    python bench.py base       # base model (emb 512 / ffn 2048)
    python bench.py e2e        # full service pipeline (host + device)
    python bench.py providers  # xla_int8 vs f32
    python bench.py continuous # step-level continuous batching vs
                               # batch-at-a-time (online + offline)
    python bench.py latency    # open-loop Poisson serving latency
                               # (p50/p95/p99 vs offered load,
                               # batch_latency 0 vs 50 ms)
    python bench.py longctx    # encoder: einsum vs chunked attention
    python bench.py trace      # profiler-trace breakdown (bench_trace)

ONE declared numerics config across all modes (= ModelConfig defaults
= the parity table in crosscheck/serving_agreement.json): int16
per-row-scaled KV cache + packed_int argmax + alignment-free.
BENCH_KV / BENCH_ARGMAX / BENCH_ALIGN / BENCH_SHORTLIST override for
ablations.
"""

import json
import os
import sys
import time

import numpy as np

from slimt_jax import device

# Published peak rates, keyed by jax device_kind (NVIDIA H100 data
# sheet, SXM part, dense, at the 700 W power limit). A kind that is
# not here gets no roofline share at all.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_gbps": 3350.0,
        "int8_tops": 1979.0,
        "bf16_tflops": 989.0,
    },
}


def peak_rates(kind):
    """The PEAKS entry for a device_kind, or None when unknown."""
    return PEAKS.get(kind)


def device_fields():
    """{"platform", "kind", "count", "card"} of the device this
    process measures on; exits 2 when JAX finds no GPU."""
    import jax

    from slimt_jax.device import card_line

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(
            f"bench.py: no GPU (JAX platform {devices[0].platform!r}); "
            "refusing to report a CPU timing as a device number",
            file=sys.stderr,
        )
        sys.exit(2)
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
        "card": card_line(),
    }


def result_line(result):
    """The JSON line a mode prints: its result plus the device."""
    return json.dumps({
        **result,
        "device": device_fields(),
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    })


def hbm_share(result, gbps):
    """Attach hbm_gbps and, for a device_kind in PEAKS, its share of
    the published memory bandwidth."""
    import jax

    result["hbm_gbps"] = round(gbps, 1)
    peak = peak_rates(jax.devices()[0].device_kind)
    if peak is not None:
        result["pct_peak_hbm"] = round(100.0 * gbps / peak["hbm_gbps"], 1)
    return result


# KV-cache bytes/elem per dtype tag, for the HBM floor-bytes models —
# ONE copy (three bench modes consume it; a missed edit in a copied
# literal silently mis-sizes hbm_gbps/pct_peak for that mode).
KV_BYTES = {
    "int8": 1, "k8v16": 1.5, "k16v8": 1.5, "int16": 2,
    "float16": 2, "bfloat16": 2, "float32": 4,
}


def _model(vocab=32000, emb=256, ffn=1536, enc=6, dec=2, with_shortlist=False):
    from slimt_jax.config import ModelConfig
    from slimt_jax.io.shortlist import build_synthetic_shortlist
    from slimt_jax.io.synthetic import synthetic_model_bytes
    from slimt_jax.models.model import Model, Package
    from slimt_jax.text import spm_proto
    from slimt_jax.text.synthetic_vocab import DEFAULT_WORDS, build_spm_model

    config = ModelConfig(encoder_layers=enc, decoder_layers=dec)
    spm = build_spm_model(DEFAULT_WORDS, target_size=vocab)
    package = Package(
        model=synthetic_model_bytes(
            config=config, vocab_size=vocab, emb_dim=emb, ffn_dim=ffn, seed=0
        ),
        vocabulary=spm_proto.serialize_model(spm),
        shortlist=(
            build_synthetic_shortlist(vocab, best=20, frequent=100)
            if with_shortlist
            else None
        ),
    )
    return Model(config, package)


def _default_enc_dtype():
    """The service default (ModelConfig.encoder_dtype) so every bench
    mode runs THE declared numerics config unless BENCH_ENC_DTYPE
    overrides for an ablation."""
    from slimt_jax.config import ModelConfig

    return ModelConfig.encoder_dtype


def _make_shortlist(vocab, width, rng):
    """Static sorted unique shortlist of `width` target ids — the
    device-side shape of the reference's flagship operating mode
    (Shortlist.cc:115-175: ~frequent+best*src_len candidates, padded;
    the engine buckets widths to multiples of 1024)."""
    import jax.numpy as jnp

    ids = np.sort(rng.choice(vocab, size=width, replace=False))
    return jnp.asarray(ids.astype(np.int32))


def _decode_bench(
    batch=64, seq=64, vocab=32000, emb=256, ffn=1536, enc=6, dec=2,
    provider=None, iters=5, metric="decode_tokens_per_sec_per_chip_tiny11_int8",
    kv=None, shortlist_width=0,
):
    import jax
    import jax.numpy as jnp

    from slimt_jax.config import ModelConfig
    from slimt_jax.io import load_items
    from slimt_jax.io.loader import load_weights, stack_layers
    from slimt_jax.io.synthetic import synthetic_model_bytes
    from slimt_jax.models.decode import translate_batch

    config = ModelConfig(encoder_layers=enc, decoder_layers=dec)
    items = load_items(
        synthetic_model_bytes(
            config=config, vocab_size=vocab, emb_dim=emb, ffn_dim=ffn, seed=0
        )
    )
    # ONE declared numerics config across every mode (BENCH headline =
    # service default = parity table): int16 per-row-scaled KV cache +
    # packed_int argmax + alignment-free — see
    # crosscheck/serving_agreement.json (config
    # "packedint+int16+noalign") for the measured token agreement vs
    # the compiled reference binary. BENCH_KV / BENCH_ARGMAX /
    # BENCH_ALIGN override for ablations.
    kv = kv or os.environ.get("BENCH_KV", "int16")
    with_alignment = os.environ.get("BENCH_ALIGN") == "1"
    argmax_method = os.environ.get("BENCH_ARGMAX", "packed_int")
    # Reduced-precision encoder activations (ModelConfig.encoder_dtype
    # default); BENCH_ENC_DTYPE=float32 ablates the exact f32 encoder.
    enc_dtype = os.environ.get("BENCH_ENC_DTYPE", _default_enc_dtype())
    if enc_dtype in ("", "float32", "none"):
        enc_dtype = None
    # Decoder form matches the service's dtype-aware choice
    # (models/model.py): stacked under int8 KV, unrolled otherwise.
    # BENCH_STACK_DEC=1/0 forces it for ablations.
    stack_env = os.environ.get("BENCH_STACK_DEC")
    stack_dec = (kv == "int8") if stack_env is None else stack_env == "1"
    params = jax.device_put(stack_layers(
        load_weights(items, config), decoder=stack_dec,
    ))
    # BENCH_PROVIDER overrides the default; an explicit provider
    # argument (the `providers` comparison mode) still wins.
    provider = provider or os.environ.get("BENCH_PROVIDER") or config.qmm_provider

    rng = np.random.default_rng(0)
    indices = rng.integers(3, vocab, (batch, seq)).astype(np.int32)
    mask = np.ones((batch, seq), np.float32)
    max_steps = int(1.5 * seq)
    shortlist_width = shortlist_width or int(
        os.environ.get("BENCH_SHORTLIST", 0)
    )
    sl = (
        _make_shortlist(vocab, shortlist_width, rng)
        if shortlist_width else None
    )

    # Transport compaction (uint16 tokens + bit-packed valid) is the
    # serving default (ModelConfig.compact_transfer) — the bench
    # matches it, including the host-side unpack cost.
    # BENCH_COMPACT=0 measures plain int32/bool transport.
    compact = os.environ.get("BENCH_COMPACT", "1") == "1"
    from slimt_jax.models.decode import compact_result, unpack_compact

    def _run(p, i, m):
        res = translate_batch(
            p, i, m,
            eos_id=-1,  # never emitted: full-length decode, no early exit
            max_steps=max_steps,
            num_heads=config.num_heads,
            provider=provider,
            kv_dtype=kv,
            shortlist=sl,
            with_alignment=with_alignment,
            argmax_method=argmax_method,
            encoder_dtype=enc_dtype,
        )
        return compact_result(res) if compact else res

    fn = device.jit(_run)
    # Distinct inputs per iteration, so no result can be reused.
    variants = [
        jnp.asarray(
            rng.integers(3, vocab, (batch, seq)).astype(np.int32)
        )
        for _ in range(iters)
    ]
    mask_j = jnp.asarray(mask)
    warm_out = fn(params, variants[0], mask_j)  # warmup/compile
    np.asarray(warm_out.packed if compact else warm_out.tokens)
    # Pipelined like the serving exhaust loop (forward_async): dispatch
    # every batch, then materialize every result on the host — with
    # fetches on a small thread pool like the service's completion
    # pool (each call transfers its full [B, steps] token matrix: what
    # serving pays).
    from concurrent.futures import ThreadPoolExecutor

    def materialize(out):
        if compact:
            tokens, valid = unpack_compact(np.asarray(out.packed), max_steps)
            return int(tokens[0, 0]) + int(valid.sum())
        return int(np.asarray(out.tokens)[0, 0]) + int(
            np.asarray(out.valid).sum()
        )

    with ThreadPoolExecutor(max_workers=4) as fetch_pool:
        t0 = time.perf_counter()
        outs = [fn(params, idx, mask_j) for idx in variants]
        checksum = sum(fetch_pool.map(materialize, outs))
        elapsed = time.perf_counter() - t0
    tps = batch * max_steps * iters / elapsed

    # Roofline audit: floor bytes per decode step (reads the step
    # cannot avoid — KV caches, decoder weights incl. the output
    # projection, recurrent state r/w; fused intermediates and logits
    # excluded, so this is a FLOOR and pct_peak_hbm is conservative).
    # The encoder's time counts against these bytes too.
    kv_bytes = KV_BYTES.get(kv, 2)
    kv_traffic = 2 * dec * batch * seq * emb * kv_bytes  # K+V, joined layout
    step_weights = dec * (4 * emb * emb + 2 * emb * ffn)  # int8: SSRU F/O, att Q/O, FFN
    logit_width = shortlist_width or vocab
    out_proj = emb * logit_width  # int8 tied embedding (gathered cols)
    state_rw = 2 * dec * batch * emb * 4  # f32 SSRU cell read+write
    embed_gather = batch * emb * 4
    bytes_per_step = kv_traffic + step_weights + out_proj + state_rw + embed_gather
    total_bytes = bytes_per_step * max_steps * iters
    hbm_gbps = total_bytes / elapsed / 1e9

    result = hbm_share({
        "metric": metric,
        "value": round(tps, 1),
        "unit": "tokens/s",
        "batch": batch,
        "kv": kv,
        "checksum": checksum,
    }, hbm_gbps)
    if shortlist_width:
        result["shortlist_width"] = shortlist_width
    return result


def bench_headline():
    # Peak-throughput serving batch (bulk-translation shape); per-call
    # host round-trip included. The numerics are THE
    # declared serving config (int16 KV + packed_int argmax +
    # noalign — same as ModelConfig defaults and the parity table in
    # crosscheck/serving_agreement.json); BENCH_BATCH / BENCH_KV
    # override for ablations.
    batch = int(os.environ.get("BENCH_BATCH", 2048))
    kv = os.environ.get("BENCH_KV", "int16")
    print(result_line(_decode_bench(batch=batch, iters=6, kv=kv)))


def _step_slope_us(batch=1, seq=24, vocab=32000, emb=256, ffn=1536,
                   enc=6, dec=2, provider=None, kv=None, iters=12,
                   shortlist_width=0):
    """Per-decode-step time via a two-point slope: time the same jitted
    translate_batch at max_steps=M and k·M (no early exit) and divide
    the difference by (k-1)·M. Dispatch, transfer and the encoder pass
    are identical at both points and cancel. Returns (µs/step, the
    median wall time at M steps in s, M)."""
    import jax
    import jax.numpy as jnp

    from slimt_jax.config import ModelConfig
    from slimt_jax.io import load_items
    from slimt_jax.io.loader import load_weights, stack_layers
    from slimt_jax.io.synthetic import synthetic_model_bytes
    from slimt_jax.models.decode import translate_batch

    config = ModelConfig(encoder_layers=enc, decoder_layers=dec)
    items = load_items(
        synthetic_model_bytes(
            config=config, vocab_size=vocab, emb_dim=emb, ffn_dim=ffn, seed=0
        )
    )
    kv = kv or os.environ.get("BENCH_KV", "int16")
    # Decoder form: dtype-aware like the service (see _decode_bench).
    stack_env = os.environ.get("BENCH_STACK_DEC")
    stack_dec = (kv == "int8") if stack_env is None else stack_env == "1"
    params = jax.device_put(stack_layers(
        load_weights(items, config), decoder=stack_dec,
    ))
    provider = provider or os.environ.get("BENCH_PROVIDER") or config.qmm_provider
    with_alignment = os.environ.get("BENCH_ALIGN") == "1"
    argmax_method = os.environ.get("BENCH_ARGMAX", "packed_int")
    rng = np.random.default_rng(0)
    mask_j = jnp.asarray(np.ones((batch, seq), np.float32))
    shortlist_width = shortlist_width or int(
        os.environ.get("BENCH_SHORTLIST", 0)
    )
    sl = (
        _make_shortlist(vocab, shortlist_width, rng)
        if shortlist_width else None
    )
    m = int(os.environ.get("BENCH_SLOPE_M", int(1.5 * seq)))
    k = int(os.environ.get("BENCH_SLOPE_K", 8))

    def timed(steps):
        fn = device.jit(
            lambda p, i, mk: translate_batch(
                p, i, mk, eos_id=-1, max_steps=steps,
                num_heads=config.num_heads, provider=provider, kv_dtype=kv,
                shortlist=sl,
                with_alignment=with_alignment, argmax_method=argmax_method,
            )
        )
        variants = [
            jnp.asarray(rng.integers(3, vocab, (batch, seq)).astype(np.int32))
            for _ in range(iters)
        ]
        jax.block_until_ready(fn(params, variants[0], mask_j))  # compile
        times = []
        for idx in variants:
            t0 = time.perf_counter()
            jax.block_until_ready(fn(params, idx, mask_j))
            times.append(time.perf_counter() - t0)
        times.sort()
        return times[len(times) // 2]

    t1, t2 = timed(m), timed(k * m)
    return max(t2 - t1, 0.0) / ((k - 1) * m) * 1e6, t1, m


def bench_batch1():
    kv = os.environ.get("BENCH_KV", "int16")
    result = _decode_bench(
        batch=1, seq=24, iters=20,
        metric="decode_tokens_per_sec_batch1_tiny11_int8", kv=kv,
    )
    # Per-step time from the two-point slope (dispatch, transfer and
    # encoder cancel); sentence latency = 36 steps at that slope.
    slope_us, t_m, m = _step_slope_us(kv=kv)
    raw_ms = 36 / result["value"] * 1000  # wall clock incl. transfer
    result["sentence_latency_ms"] = round(raw_ms, 2)
    result["step_device_us"] = round(slope_us, 1)
    result["device_latency_ms"] = round(slope_us * 36 / 1000, 2)
    print(result_line(result))


def _service_corpus(seed, lines, low=6, high=24):
    rng = np.random.default_rng(seed)
    words = (
        "hello world goodbye this is a test of the translation engine "
        "quick brown fox jumps over lazy dog sentence splitting works"
    ).split()
    return [
        " ".join(rng.choice(words, rng.integers(low, high)))
        for _ in range(lines)
    ]


def _best_service_rate(translate, lines, iters=3):
    """Warm on one corpus, then time `iters` runs on distinct corpora
    (best-of drops runs hit by a stray compile). Returns
    (tokens/s, source words/s, last responses)."""
    translate(_service_corpus(0, lines))  # warm all shape buckets
    best = (0.0, 0.0)
    for it in range(1, iters + 1):
        corpus = _service_corpus(it, lines)
        t0 = time.perf_counter()
        responses = translate(corpus)
        elapsed = time.perf_counter() - t0
        tokens = sum(
            r.target.word_count(s)
            for r in responses
            for s in range(r.target.sentence_count())
        )
        source_words = sum(len(line.split()) for line in corpus)
        best = max(best, (tokens / elapsed, source_words / elapsed))
    return best


def bench_shortlist(lines=2048):
    """Shortlisted output projection through the full Blocking service
    (pipelined batches, like the e2e mode but with the lexical
    shortlist restricting the logit matmul)."""
    from slimt_jax.config import Config
    from slimt_jax.runtime.service import Blocking

    model = _model(with_shortlist=True)
    # `value` is the public API (Blocking.translate — bulk-routed by
    # default, differential-tested identical outputs); the pinned
    # per-request exhaust loop (prefer_bulk=False, comparable with
    # recorded history) is reported alongside.
    service = Blocking(Config(cache_size=0, max_words=8192))
    tps, _ = _best_service_rate(
        lambda corpus: service.translate(model, corpus), lines
    )
    general = Blocking(Config(cache_size=0, max_words=8192, prefer_bulk=False))
    general_tps, _ = _best_service_rate(
        lambda corpus: general.translate(model, corpus), lines
    )
    print(
        result_line(
            {
                "general_path_tokens_per_sec": round(general_tps, 1),
                "metric": "shortlist_decode_tokens_per_sec_tiny11_int8",
                "value": round(tps, 1),
                "unit": "tokens/s",
            }
        )
    )


def bench_headline_shortlist():
    """The reference's flagship operating mode at device level:
    shortlisted output projection (slimt/Shortlist.cc:115-175) in the
    raw batched decode — the [B,E]x[E,32000] logit matmul (~40% of the
    full-vocab step) shrinks to [B,E]x[E,width]. Width defaults to
    1024 (the service's shortlist bucket; measured widths for
    wrap-128 batches land in the 512-2048 range — see
    bench.py realcorpus shortlist stats)."""
    batch = int(os.environ.get("BENCH_BATCH", 2048))
    kv = os.environ.get("BENCH_KV", "int16")
    width = int(os.environ.get("BENCH_SHORTLIST", 1024))
    print(
        result_line(
            _decode_bench(
                batch=batch, iters=6, kv=kv, shortlist_width=width,
                metric="decode_tokens_per_sec_per_chip_tiny11_int8_shortlist",
            )
        )
    )


def bench_base():
    print(
        result_line(
            _decode_bench(
                batch=1024, emb=512, ffn=2048,
                metric="decode_tokens_per_sec_per_chip_base_int8",
            )
        )
    )


def bench_e2e(lines=2048, workers=4):
    """Full pipeline: split → tokenize → batch → decode → detokenize."""
    from slimt_jax.config import Config
    from slimt_jax.runtime.service import Blocking

    model = _model()
    # `value` is the public API (Blocking.translate — bulk-routed by
    # default, differential-tested identical outputs); the pinned
    # per-request exhaust loop (prefer_bulk=False, comparable with
    # recorded history) is reported alongside.
    service = Blocking(Config(cache_size=0, max_words=8192))
    tps, swps = _best_service_rate(
        lambda corpus: service.translate(model, corpus), lines
    )
    general = Blocking(Config(cache_size=0, max_words=8192, prefer_bulk=False))
    general_tps, _ = _best_service_rate(
        lambda corpus: general.translate(model, corpus), lines
    )
    print(
        result_line(
            {
                "general_path_tokens_per_sec": round(general_tps, 1),
                "metric": "e2e_target_tokens_per_sec_tiny11_int8",
                "value": round(tps, 1),
                "unit": "tokens/s",
                "source_words_per_sec": round(swps, 1),
                "lines": lines,
            }
        )
    )


def bench_realcorpus():
    """End-to-end on the checked-in NATURAL corpus (data/corpus.txt:
    648 mixed-length English lines, ~16.6 words/line, ~8% duplicate
    lines) with shortlist + translation cache enabled — the realism
    counterpart of the synthetic-sampler service modes.  Reports
    cache-hit and shortlist-width statistics alongside throughput; a
    single COLD pass, so the cache-hit rate reflects genuine corpus
    repetition, not warmup artifacts."""
    from slimt_jax.config import Config
    from slimt_jax.runtime.service import Blocking

    model = _model(with_shortlist=True)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "data", "corpus.txt")
    with open(path) as f:
        corpus = [line.rstrip("\n") for line in f if line.strip()]

    # Warm ALL shape buckets with a cache-less full pass (jit cache is
    # per-model, shared across services), then measure one cold-CACHE
    # pass in chunks: a single blocking mega-call can never hit its
    # own cache (every segment is in flight before any completes —
    # reference semantics, slimt/Request.cc:29-85), so chunking is
    # what lets genuine corpus repetition show up, like a streaming
    # workload would.
    chunk = 64
    # Warm with the SAME chunking AND the same cache config as the
    # measured pass: chunked calls produce different (B, T,
    # shortlist-width) buckets than one mega-call, and cache hits
    # shrink device batches into yet other B buckets (hit segments
    # never reach the device) — the corpus and chunking are
    # deterministic, so an identically-configured warm service sees
    # the identical hit pattern and compiles the identical bucket
    # set. An unwarmed bucket means an XLA compile inside the timed
    # region (~1.4 s per 64-line chunk — what this bench used to
    # measure by accident).
    # Two chunks in flight (a 2-deep software pipeline): chunk i+1's
    # ingest+dispatch overlaps chunk i's device wait + assembly — a
    # streaming client would do the same — while chunk i+2 still sees
    # every cache entry chunk i produced. The warm pass
    # runs the IDENTICAL pipeline (pipelining shifts which cache
    # entries each chunk sees, hence which (B, T) buckets the misses
    # land in).
    from concurrent.futures import ThreadPoolExecutor

    def chunked_pass(service):
        starts = list(range(0, len(corpus), chunk))
        responses = []
        with ThreadPoolExecutor(max_workers=2) as pool:
            futures = []
            for start in starts:
                futures.append(
                    pool.submit(
                        service.translate, model, corpus[start : start + chunk]
                    )
                )
                if len(futures) > 1:  # keep at most 2 in flight, in order
                    responses.extend(futures.pop(0).result())
            for future in futures:
                responses.extend(future.result())
        return responses

    chunked_pass(Blocking(Config(cache_size=4096, max_words=8192)))
    service = Blocking(Config(cache_size=4096, max_words=8192))
    t0 = time.perf_counter()
    responses = chunked_pass(service)
    elapsed = time.perf_counter() - t0

    tokens = sum(
        r.target.word_count(s)
        for r in responses
        for s in range(r.target.sentence_count())
    )
    source_words = sum(len(line.split()) for line in corpus)
    cache = service.cache
    hits, misses = (cache.hits, cache.misses) if cache else (0, 0)
    tps = tokens / elapsed
    print(
        result_line(
            {
                "metric": "realcorpus_tokens_per_sec",
                "value": round(tps, 1),
                "unit": "tokens/s",
                "lines": len(corpus),
                "source_words_per_sec": round(source_words / elapsed, 1),
                "cache_hit_rate": round(hits / max(1, hits + misses), 3),
                "cache_lookups": hits + misses,
                "chunk": chunk,
                "shortlist": model.shortlist_meter.snapshot(),
            }
        )
    )


def bench_bulk(lines=10000):
    """Corpus throughput through the bulk path
    (Blocking.translate_bulk): flattened segments, one packing pass,
    pipelined device dispatch, no per-request machinery — this
    engine's answer to the reference's async corpus workload
    (differential-tested equal outputs)."""
    from slimt_jax.config import Config
    from slimt_jax.runtime.service import Blocking

    model = _model()
    service = Blocking(Config(cache_size=2048, max_words=8192))
    tps, swps = _best_service_rate(
        lambda corpus: service.translate_bulk(model, corpus), lines
    )
    print(
        result_line(
            {
                "metric": "bulk_corpus_target_tokens_per_sec",
                "value": round(tps, 1),
                "unit": "tokens/s",
                "source_words_per_sec": round(swps, 1),
                "lines": lines,
            }
        )
    )


def bench_multipair(lines_per_model=2048):
    """Two resident models (en-de + de-en analog) served through one
    Async service — the multi-pair serving config (reference
    AggregateBatcher slimt/Batcher.hh:130-180). `value`
    uses batch submission per model (translate_many, the corpus
    ingest API); per-line submission (one Handle per request, the
    interactive pattern) and the bulk lane (both directions'
    corpora through Blocking.translate_bulk back to back — the
    throughput-scale multi-direction config) are reported
    alongside."""
    from slimt_jax.config import Config
    from slimt_jax.runtime.service import Async, Blocking

    model_a = _model()
    model_b = _model()

    def run(corpus, per_line):
        with Async(Config(
            cache_size=0, max_words=8192,
            workers=int(os.environ.get("BENCH_WORKERS", 8)),
            batch_latency=float(os.environ.get("BENCH_LATENCY", 0.05)),
        )) as svc:
            if per_line:
                handles = []
                for line in corpus:
                    handles.append(svc.translate(model_a, line))
                    handles.append(svc.translate(model_b, line))
            else:
                handles = svc.translate_many(model_a, corpus)
                handles += svc.translate_many(model_b, corpus)
            responses = [h.result(600) for h in handles]
        return responses

    def measure(per_line):
        best = 0.0
        responses = []
        for it in (1, 2, 3):
            corpus = _service_corpus(it, lines_per_model, low=6, high=20)
            t0 = time.perf_counter()
            responses = run(corpus, per_line)
            elapsed = time.perf_counter() - t0
            tokens = sum(
                r.target.word_count(s)
                for r in responses
                for s in range(r.target.sentence_count())
            )
            best = max(best, tokens / elapsed)
        return best, len(responses)

    def measure_bulk():
        # Same corpora and batch budget as the async runs above, so
        # the printed bulk/async numbers are directly comparable.
        service = Blocking(Config(cache_size=0, max_words=8192))

        def both(corpus):
            return service.translate_bulk(
                model_a, corpus
            ) + service.translate_bulk(model_b, corpus)

        both(_service_corpus(0, lines_per_model, low=6, high=20))  # warm
        best = 0.0
        for it in (1, 2, 3):
            corpus = _service_corpus(it, lines_per_model, low=6, high=20)
            t0 = time.perf_counter()
            responses = both(corpus)
            elapsed = time.perf_counter() - t0
            tokens = sum(
                r.target.word_count(s)
                for r in responses
                for s in range(r.target.sentence_count())
            )
            best = max(best, tokens / elapsed)
        return best

    run(_service_corpus(0, lines_per_model, low=6, high=20), False)  # warm
    tokens_per_sec, n = measure(per_line=False)
    per_line_tps, _ = measure(per_line=True)
    bulk_tps = measure_bulk()
    print(
        result_line(
            {
                "bulk_tokens_per_sec": round(bulk_tps, 1),
                "metric": "multipair_async_tokens_per_sec_two_models",
                "value": round(tokens_per_sec, 1),
                "unit": "tokens/s",
                "per_line_tokens_per_sec": round(per_line_tps, 1),
                "models": 2,
                "requests": n,
            }
        )
    )


def bench_pivot(lines=2048):
    """Two-leg pivot translation (source→pivot→target, reference
    slimt/Frontend.cc:147-205) through Blocking.pivot: leg 1 rides the
    bulk lane (prefer_bulk), leg 2 re-tokenizes the pivot text
    preserving sentence boundaries. Tokens/s counts final-target
    tokens (one model-decode each on two models per token)."""
    from slimt_jax.config import Config
    from slimt_jax.runtime.service import Blocking

    first = _model()
    second = _model()
    service = Blocking(Config(cache_size=0, max_words=8192))
    tps, swps = _best_service_rate(
        lambda corpus: service.pivot(first, second, corpus), lines
    )
    print(
        result_line(
            {
                "metric": "pivot_target_tokens_per_sec_tiny11_int8",
                "value": round(tps, 1),
                "unit": "tokens/s",
                "source_words_per_sec": round(swps, 1),
                "lines": lines,
            }
        )
    )


def bench_corpus(path=None, workers=None):
    workers = workers or int(os.environ.get("BENCH_WORKERS", 8))
    """WNGT20-style corpus throughput: pipe a real file through the
    Async service (the reference's scripts/run.sh workload — 10k
    shuffled sources, N workers). Falls back to a synthetic corpus
    when no file is given (the WNGT20 sets need network access)."""
    from slimt_jax.config import Config
    from slimt_jax.runtime.service import Async

    model = _model()
    lines = 10000

    def make_corpus(seed):
        if path:
            with open(path, encoding="utf-8") as f:
                return [line.strip() for line in f if line.strip()][:lines]
        return _service_corpus(seed + 100, lines, low=5, high=30)

    def run(corpus):
        with Async(
            Config(
                cache_size=2048, max_words=8192, workers=workers,
                batch_latency=float(
                    os.environ.get("BENCH_LATENCY", 0.02)
                ),
            )
        ) as svc:
            handles = svc.translate_many(model, corpus)
            return [h.result(1200) for h in handles]

    run(make_corpus(0))  # warmup compiles
    best = (0.0, 0.0)
    for it in (1, 2):
        corpus = make_corpus(it)
        t0 = time.perf_counter()
        responses = run(corpus)
        elapsed = time.perf_counter() - t0
        source_words = sum(len(line.split()) for line in corpus)
        target_tokens = sum(
            r.target.word_count(s)
            for r in responses
            for s in range(r.target.sentence_count())
        )
        best = max(
            best, (target_tokens / elapsed, source_words / elapsed)
        )
    tps, swps = best
    print(
        result_line(
            {
                "metric": "corpus_async_target_tokens_per_sec",
                "value": round(tps, 1),
                "unit": "tokens/s",
                "source_words_per_sec": round(swps, 1),
                "lines": lines,
                "workers": workers,
                "elapsed_s": round(elapsed, 2),
            }
        )
    )


def bench_continuous():
    """Step-level continuous batching (models/continuous.py) vs the
    strongest batch-at-a-time baseline (offline shortest-first packing
    into full batches), same length-skewed workload, declared serving
    numerics.

    Fairness: "useful work" = Σ min-cap tokens per segment (1.5 x its
    OWN length), identical for both paths. The batch path decodes
    every row to its BATCH's cap (1.5 x batch-max source length,
    reference slimt/Model.cc:160) — tokens past a row's own cap are
    the straggler waste continuous batching exists to remove, so they
    count against its time, not its tokens. EOS is disabled (eos_id=1
    over 32k random-weight logits) so the comparison is deterministic;
    real workloads add EOS-time variance, which only helps the
    continuous side. BENCH_SLOTS / BENCH_CHUNK / BENCH_SEGMENTS
    override the defaults (2048 / 16 / 4x slots)."""
    import jax
    import jax.numpy as jnp

    from slimt_jax.config import ModelConfig
    from slimt_jax.io import load_items
    from slimt_jax.io.loader import load_weights
    from slimt_jax.io.synthetic import synthetic_model_bytes
    from slimt_jax.models.continuous import ContinuousEngine
    from slimt_jax.models.decode import translate_batch_jit

    slots = int(os.environ.get("BENCH_SLOTS", 2048))
    chunk = int(os.environ.get("BENCH_CHUNK", 16))
    nseg = int(os.environ.get("BENCH_SEGMENTS", 4 * slots))
    t_slot = 64
    vocab, emb, ffn = 32000, 256, 1536
    config = ModelConfig(encoder_layers=6, decoder_layers=2)
    params = jax.device_put(
        load_weights(
            load_items(
                synthetic_model_bytes(
                    config=config, vocab_size=vocab, emb_dim=emb,
                    ffn_dim=ffn, seed=0,
                )
            ),
            config,
        )
    )
    rng = np.random.default_rng(0)
    # Length-skewed mix (the continuous win case): lognormal over
    # [4, t_slot], shuffled arrival order.
    lengths = np.clip(
        np.rint(np.exp(rng.normal(3.0, 0.7, nseg))), 4, t_slot
    ).astype(int)
    segments = [
        rng.integers(3, vocab, n).astype(int).tolist() for n in lengths
    ]
    useful = int(sum(max(1, int(1.5 * n)) for n in lengths))
    eos_id = 1

    # --- batch-at-a-time baseline: full batches of `slots` rows, T
    # padded to a 16-multiple bucket. `sort=True` = OFFLINE (global
    # shortest-first — the strongest batch baseline); False = ONLINE
    # arrival order (the serving regime: the reference Batcher can
    # only sort what is queued, slimt/Batcher.cc:95-120, so a steady
    # stream packs mixed lengths and every row decodes to the batch
    # max cap).
    def run_batches(sort):
        order = (
            np.argsort(lengths, kind="stable")
            if sort else np.arange(nseg)
        )
        total = 0
        outs = []
        for start in range(0, nseg, slots):
            idxs = order[start : start + slots]
            t_max = int(lengths[idxs].max())
            t_pad = -(-t_max // 16) * 16
            b_pad = slots  # full batches by construction (nseg % slots == 0)
            indices = np.zeros((b_pad, t_pad), np.int32)
            mask = np.zeros((b_pad, t_pad), np.float32)
            for r, seg_i in enumerate(idxs):
                toks = segments[seg_i]
                indices[r, : len(toks)] = toks
                mask[r, : len(toks)] = 1.0
            cap = np.int32(max(1, int(1.5 * t_max)))
            out = translate_batch_jit(
                params,
                jnp.asarray(indices),
                jnp.asarray(mask),
                jnp.zeros((1024,), jnp.int32),
                cap,
                eos_id=eos_id,
                max_steps=int(1.5 * t_pad),
                num_heads=config.num_heads,
                with_shortlist=False,
                kv_dtype="int16",
                with_alignment=False,
                argmax_method="packed_int",
                compact_output=True,
            )
            outs.append(out)
            total += b_pad
        for out in outs:
            np.asarray(out.packed)
        return total

    run_batches(sort=True)  # warm/compile every bucket
    batch = {}
    for label, sort in (("offline_sorted", True), ("online_stream", False)):
        run_batches(sort=sort)  # warm the mode's buckets
        t0 = time.perf_counter()
        run_batches(sort=sort)
        batch[label] = useful / (time.perf_counter() - t0)

    # --- continuous engine (fresh pool; warm pass compiles its jits).
    def make_engine(order):
        return ContinuousEngine(
            params,
            eos_id=eos_id,
            num_heads=config.num_heads,
            slots=slots,
            chunk=chunk,
            t_slot=t_slot,
            admit_bucket=min(slots, 1024),
            admit_order=order,
        )

    make_engine("shortest").translate(segments[: slots // 2])  # compile
    cont = {}
    engines = {}
    for label, order in (
        ("offline_sorted", "shortest"), ("online_stream", "fifo")
    ):
        engine = make_engine(order)
        t0 = time.perf_counter()
        engine.translate(segments)
        cont[label] = useful / (time.perf_counter() - t0)
        engines[label] = engine

    stream = engines["online_stream"]
    print(
        result_line(
            {
                "metric": "continuous_batching_tokens_per_sec",
                "value": round(cont["online_stream"], 1),
                "unit": "useful tokens/s",
                "online_stream": {
                    "continuous": round(cont["online_stream"], 1),
                    "batch_at_a_time": round(batch["online_stream"], 1),
                    "ratio": round(
                        cont["online_stream"] / batch["online_stream"], 3
                    ),
                    "occupancy": round(stream.occupancy(), 3),
                    "chunks": stream.stats["chunks"],
                },
                "offline_sorted": {
                    "continuous": round(cont["offline_sorted"], 1),
                    "batch_at_a_time": round(batch["offline_sorted"], 1),
                    "ratio": round(
                        cont["offline_sorted"] / batch["offline_sorted"], 3
                    ),
                    "occupancy": round(
                        engines["offline_sorted"].occupancy(), 3
                    ),
                },
                "slots": slots,
                "chunk": chunk,
                "segments": nseg,
            }
        )
    )


def bench_longctx():
    """Long-context encoder (SURVEY §5 "long context"): the reference
    hard-wraps every input at 128 tokens because its SDPA materializes
    full [B,H,T,T] score matrices (slimt/Modules.cc:24-86,
    slimt/Frontend.hh:27). This engine lifts the constraint with the
    query-chunked encoder attention (`flash_attention`,
    ops/attention.py — O(T·128) attention memory). Measures encoder
    throughput at growing T with the TOTAL token count fixed, einsum
    SDPA vs chunked, on the tiny11 encoder, and reports per T whether
    the default (ModelConfig.flash_attention) is the faster form."""
    import jax
    import jax.numpy as jnp

    from slimt_jax.config import ModelConfig
    from slimt_jax.io import load_items
    from slimt_jax.io.loader import load_weights, stack_layers
    from slimt_jax.io.synthetic import synthetic_model_bytes
    from slimt_jax.models import transformer as tfm

    vocab, emb, ffn = 32000, 256, 1536
    config = ModelConfig(encoder_layers=6, decoder_layers=2)
    items = load_items(
        synthetic_model_bytes(
            config=config, vocab_size=vocab, emb_dim=emb, ffn_dim=ffn, seed=0
        )
    )
    params = jax.device_put(stack_layers(load_weights(items, config)))
    total = int(os.environ.get("BENCH_LONGCTX_TOKENS", 16384))
    lengths = [int(t) for t in os.environ.get(
        "BENCH_LONGCTX_T", "128,256,512,768,1024,2048,4096").split(",")]
    rng = np.random.default_rng(0)
    rows = {}
    for t in lengths:
        batch = max(1, total // t)
        for flash in (False, True):
            key = f"T={t} " + ("chunked" if flash else "einsum")
            if not flash and batch * t * t * config.num_heads * 4 > 16 << 30:
                # The einsum materializes [B,H,T,T] f32 scores: skip
                # shapes whose scores alone exceed 16 GiB.
                rows[key] = "skipped (scores > 16 GiB)"
                continue

            def run(p, idx, msk, flash=flash):
                x = tfm.transform_embedding(tfm.embed(p, idx))
                out = tfm.encoder_forward(
                    p, x, tfm.make_additive_mask(msk),
                    config.num_heads, None, flash=flash,
                )
                return jnp.sum(out)

            fn = device.jit(run)
            variants = [
                jnp.asarray(rng.integers(3, vocab, (batch, t)).astype(np.int32))
                for _ in range(5)
            ]
            msk = jnp.asarray(np.ones((batch, t), np.float32))
            jax.block_until_ready(fn(params, variants[0], msk))  # compile
            times = []
            for idx in variants:
                t0 = time.perf_counter()
                jax.block_until_ready(fn(params, idx, msk))
                times.append(time.perf_counter() - t0)
            rows[key] = round(batch * t / sorted(times)[len(times) // 2], 1)
    default = ModelConfig.flash_attention
    winners = {}
    for t in lengths:
        ein = rows.get(f"T={t} einsum")
        chk = rows.get(f"T={t} chunked")
        chunked_wins = not isinstance(ein, float) or chk > ein
        winners[f"T={t}"] = {
            "winner": "chunked" if chunked_wins else "einsum",
            "default_is_winner": chunked_wins == default,
        }
    value = rows.get("T=1024 chunked", 0.0)
    print(
        result_line(
            {
                "metric": "longctx_encoder_tokens_per_sec_T1024_chunked",
                "value": value,
                "unit": "tokens/s",
                "total_tokens_per_config": total,
                "rows": rows,
                "winners": winners,
            }
        )
    )


def bench_latency():
    """Open-loop serving latency: Poisson arrivals into the Async
    service at several offered loads, per-request end-to-end latency
    (tokenize → queue/batch → decode → detokenize) percentiles at each
    load, for batch_latency ∈ {0, 50 ms} — the latency side of the
    occupancy trade Config.batch_latency makes (reference
    slimt/Frontend.hh:21-39 exposes the same knobs; Response.cc:196-219
    is its live per-request wps metric).

    Latency is measured from the request's SCHEDULED arrival time
    (open-loop convention): if the engine falls behind, queueing shows
    up in the tail instead of silently stretching the arrival process.
    A closed-loop B=1 row (single-sentence Blocking round trip, the
    interactive floor) anchors the table."""
    import threading

    from slimt_jax.config import Config
    from slimt_jax.runtime.service import Async, Blocking

    model = _model()
    loads = [
        int(x)
        for x in os.environ.get(
            "BENCH_LOADS", "100,500,2000,8000,20000"
        ).split(",")
    ]
    duration = float(os.environ.get("BENCH_LAT_SECONDS", 6.0))
    windows = [0.0, 0.05]
    rows = {}
    knee = (0.0, None)  # (tok/s, row key) at the knee

    def run_load(service, load, seed, timed):
        n = min(int(load * duration), 30000)
        corpus = _service_corpus(seed, n)
        rng = np.random.default_rng(seed)
        gaps = rng.exponential(1.0 / load, n)
        sched = np.cumsum(gaps)
        done = np.zeros(n)
        pending = threading.Semaphore(0)

        t0 = time.perf_counter()
        for i, line in enumerate(corpus):
            now = time.perf_counter() - t0
            if sched[i] > now:
                time.sleep(sched[i] - now)
            handle = service.translate(model, line)

            def cb(fut, i=i):
                done[i] = time.perf_counter() - t0
                pending.release()

            handle.future.add_done_callback(cb)
        for _ in range(n):
            pending.acquire()
        wall = time.perf_counter() - t0
        if not timed:
            return None
        lat_ms = (done - sched) * 1e3
        tokens = sum(len(line.split()) for line in corpus)  # source words
        return {
            "offered_lps": load,
            "achieved_lps": round(n / wall, 1),
            "source_wps": round(tokens / wall, 1),
            "p50_ms": round(float(np.percentile(lat_ms, 50)), 2),
            "p95_ms": round(float(np.percentile(lat_ms, 95)), 2),
            "p99_ms": round(float(np.percentile(lat_ms, 99)), 2),
            "n": n,
        }

    for window in windows:
        service = Async(
            Config(
                cache_size=0, max_words=8192, workers=4,
                batch_latency=window,
            )
        )
        # Warm every shape bucket the arrival process will touch (the
        # low-load regime decodes B=1..8 buckets the corpus modes never
        # compile) by running the same Poisson process once untimed.
        run_load(service, loads[0], seed=99, timed=False)
        run_load(service, max(loads), seed=98, timed=False)
        for load in loads:
            row = run_load(service, load, seed=load, timed=True)
            key = f"window={int(window * 1000)}ms load={load}/s"
            rows[key] = row
            # The knee: highest load this window sustains (≥95% of
            # offered admitted AND p99 under 250 ms).
            if (
                row["achieved_lps"] >= 0.95 * load
                and row["p99_ms"] <= 250.0
                and row["source_wps"] > knee[0]
            ):
                knee = (row["source_wps"], key)

    # Interactive floor: closed-loop single-sentence Blocking round
    # trip (per-request path, B=1 bucket) — median of 50.
    floor = Blocking(Config(cache_size=0, prefer_bulk=False))
    floor_corpus = _service_corpus(7, 64, low=8, high=16)
    floor.translate(model, floor_corpus[:8])  # warm B∈{1..8}, T buckets
    samples = []
    for line in floor_corpus[8:]:
        t0 = time.perf_counter()
        floor.translate(model, [line])
        samples.append((time.perf_counter() - t0) * 1e3)
    rows["closed-loop B=1 Blocking"] = {
        "p50_ms": round(float(np.percentile(samples, 50)), 2),
        "p95_ms": round(float(np.percentile(samples, 95)), 2),
        "n": len(samples),
    }

    print(
        result_line(
            {
                "metric": "serving_knee_source_words_per_sec",
                "value": round(knee[0], 1),
                "unit": "source words/s",
                "knee": knee[1],
                "rows": rows,
            }
        )
    )


def _device_events(path):
    """Device-side op events of one profiler trace: [(name, start_ns,
    end_ns)] from the GPU planes, preferring each plane's "XLA Ops"
    line (one event per executed HLO op) over its raw stream lines,
    plus the plane/line inventory for inspection."""
    from jax.profiler import ProfileData

    data = ProfileData.from_file(path)
    events, inventory = [], {}
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = list(plane.lines)
        inventory[plane.name] = {
            line.name: sum(1 for _ in line.events) for line in lines
        }
        ops = [line for line in lines if line.name == "XLA Ops"]
        for line in ops or [ln for ln in lines if ln.name.startswith("Stream")]:
            for ev in line.events:
                events.append(
                    (ev.name, int(ev.start_ns), int(ev.start_ns + ev.duration_ns))
                )
    return events, inventory


def reduce_trace(events, window_ns):
    """Busy time (union of op intervals), idle share over `window_ns`,
    and per-op-name device time, from `_device_events` output."""
    busy, end = 0, None
    for _, start, stop in sorted(events, key=lambda e: e[1]):
        if end is None or start > end:
            busy += stop - start
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    per_op = {}
    for name, start, stop in events:
        per_op[name] = per_op.get(name, 0) + (stop - start)
    return {
        "busy_ns": busy,
        "idle_share": (1.0 - busy / window_ns) if window_ns else None,
        "per_op_ns": per_op,
    }


def _trace_window(fn, args, calls, directory):
    """Run `fn(*args)` `calls` times under the profiler (already
    compiled); returns (events, inventory, wall_ns of the window)."""
    import glob
    import shutil

    import jax

    shutil.rmtree(directory, ignore_errors=True)
    jax.profiler.start_trace(directory)
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        jax.block_until_ready(fn(*args))
    wall = time.perf_counter_ns() - t0
    jax.profiler.stop_trace()
    path = sorted(glob.glob(f"{directory}/**/*.xplane.pb", recursive=True))[-1]
    events, inventory = _device_events(path)
    return events, inventory, wall


def _dot_lowering(hlo_text):
    """What each dot became in optimized GPU HLO: the instructions that
    take an s8 operand or call a GEMM library, grouped by kind."""
    import re

    defined = dict(re.findall(r"%([\w.\-]+) = \(?([a-z]+\d*)\[", hlo_text))
    kinds = {}
    for line in hlo_text.splitlines():
        target = re.search(r'custom_call_target="([^"]+)"', line)
        is_dot = " dot(" in line or "gemm" in line or (
            target is not None and "matmul" in target.group(1)
        )
        if not is_dot:
            continue
        if target is not None:
            kind = target.group(1)
        elif "kind=kCustom" in line:
            kind = "fusion(kCustom)"
        elif " dot(" in line:
            kind = "dot"
        else:
            kind = "fusion"
        # Operand types only: a cuBLAS call also returns an s8
        # workspace buffer, so the output side says nothing. Optimized
        # HLO names its operands without their types: look them up.
        call = re.search(r"(?:custom-call|dot|fusion)\(([^)]*)", line)
        operands = call.group(1) if call else ""
        found = re.findall(r"\b([a-z]+\d*)\[", operands) or [
            defined.get(name, "") for name in re.findall(r"%([\w.\-]+)", operands)
        ]
        operand_types = "s8" if "s8" in found else (
            "f32" if "f32" in found else "other"
        )
        key = f"{kind} [{operand_types}]"
        kinds[key] = kinds.get(key, 0) + 1
    return kinds


def bench_trace():
    """Profiler-trace breakdown on the GPU, written to
    $BENCH_TRACE_DIR/trace_report.json (default bench_out/) with a
    summary line on stdout:

      - encoder: tiny11 B=2048xT=64 and base B=1024xT=64, one XLA
        encoder call — device time, idle share, the top ops, and the
        share of time in ops that read or write the [B,H,T,T] scores;
      - decode: translate_batch_jit (declared serving config, no
        early exit) at B=1 (T=24) and B=2048 (T=64) — per-step wall
        time, device busy time and the host gap per step;
      - lowering: what every dot of the decode jit became in the
        optimized HLO (cuBLAS custom call, Triton GEMM fusion, or a
        plain dot emitter), by operand type;
      - reference rates: a 8192^3 bf16 matmul and a 2 GiB copy."""
    import re

    import jax
    import jax.numpy as jnp

    from slimt_jax.config import ModelConfig
    from slimt_jax.io import load_items
    from slimt_jax.io.loader import load_weights, stack_layers
    from slimt_jax.io.synthetic import synthetic_model_bytes
    from slimt_jax.models import transformer as tfm
    from slimt_jax.models.decode import translate_batch_jit

    out_dir = os.environ.get("BENCH_TRACE_DIR", "bench_out")
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    config = ModelConfig()
    report = {"encoder": {}, "decode": {}}

    def params_for(emb, ffn, stack_decoder):
        items = load_items(synthetic_model_bytes(
            config=config, vocab_size=32000, emb_dim=emb, ffn_dim=ffn, seed=0
        ))
        return jax.device_put(stack_layers(
            load_weights(items, config), decoder=stack_decoder
        ))

    def top_ops(per_op, total, n=12):
        ranked = sorted(per_op.items(), key=lambda kv: -kv[1])[:n]
        return [[name, round(ns / 1e3, 1), round(ns / total, 3)]
                for name, ns in ranked]

    for label, emb, ffn, batch in (
        ("tiny11", 256, 1536, 2048), ("base", 512, 2048, 1024)
    ):
        params = params_for(emb, ffn, False)
        t = 64

        def enc(p, idx, msk):
            x = tfm.transform_embedding(tfm.embed(p, idx))
            return tfm.encoder_forward(
                p, x, tfm.make_additive_mask(msk), config.num_heads
            )

        idx = jnp.asarray(rng.integers(3, 32000, (batch, t)).astype(np.int32))
        msk = jnp.ones((batch, t), jnp.float32)
        fn = device.jit(enc)
        hlo = fn.lower(params, idx, msk).compile().as_text()
        jax.block_until_ready(fn(params, idx, msk))
        calls = 5
        events, inventory, wall = _trace_window(
            fn, (params, idx, msk), calls, os.path.join(out_dir, f"tr_enc_{label}")
        )
        red = reduce_trace(events, wall)
        # The scores path: fusions whose HLO line carries a
        # [.., H, T, T] shape (kernels are named after their fusion,
        # '.' -> '_'), plus the cuBLAS f32 GEMM kernels — in the
        # encoder those are exactly the two SDPA einsums, since every
        # projection is an int8 GEMM.
        pat = f"{config.num_heads},{t},{t}]"
        score_ops = {
            m.group(1).replace(".", "_") for m in re.finditer(
                r"^\s*(?:ROOT )?%?([\w.\-]+) = [^\n]*", hlo, re.M
            ) if pat in m.group(0)
        }
        score_ns = sum(
            ns for name, ns in red["per_op_ns"].items()
            if name in score_ops or "gemm_f32f32" in name
        )
        total = max(1, sum(red["per_op_ns"].values()))
        report["encoder"][label] = {
            "batch": batch, "t": t,
            "ms_per_call_wall": round(wall / calls / 1e6, 3),
            "ms_per_call_device_busy": round(red["busy_ns"] / calls / 1e6, 3),
            "idle_share": round(red["idle_share"], 4),
            "scores_share_of_op_time": round(score_ns / total, 4),
            "top_ops_us_share": top_ops(red["per_op_ns"], total),
            "device_lines": inventory,
        }

    params = params_for(256, 1536, False)
    for batch, t in ((1, 24), (2048, 64)):
        steps = int(1.5 * t)
        idx = jnp.asarray(rng.integers(3, 32000, (batch, t)).astype(np.int32))
        msk = jnp.ones((batch, t), jnp.float32)
        kwargs = dict(
            eos_id=-1, max_steps=steps, num_heads=config.num_heads,
            kv_dtype=config.kv_cache_dtype, with_alignment=False,
            argmax_method=config.argmax_method, compact_output=True,
        )
        sl = jnp.zeros((1024,), jnp.int32)

        def dec(p, i, m):
            return translate_batch_jit(p, i, m, sl, **kwargs)

        hlo = device.jit(dec).lower(params, idx, msk).compile().as_text()
        jax.block_until_ready(dec(params, idx, msk))
        calls = 3
        events, inventory, wall = _trace_window(
            dec, (params, idx, msk), calls,
            os.path.join(out_dir, f"tr_dec_b{batch}"),
        )
        red = reduce_trace(events, wall)
        total = max(1, sum(red["per_op_ns"].values()))
        n_steps = calls * steps
        copies = sum(1 for name, _, _ in events if "emcpy" in name)
        report["decode"][f"B={batch}"] = {
            "t": t, "steps_per_call": steps,
            "us_per_step_wall": round(wall / n_steps / 1e3, 2),
            "us_per_step_device_busy": round(red["busy_ns"] / n_steps / 1e3, 2),
            "us_gap_per_step": round((wall - red["busy_ns"]) / n_steps / 1e3, 2),
            "idle_share": round(red["idle_share"], 4),
            "memcpy_events_per_step": round(copies / n_steps, 2),
            "top_ops_us_share": top_ops(red["per_op_ns"], total),
            "dot_lowering": _dot_lowering(hlo),
            "device_lines": inventory,
        }

    a = jnp.asarray(rng.standard_normal((8192, 8192)), jnp.bfloat16)
    mm = device.jit(lambda x: x @ x)
    jax.block_until_ready(mm(a))
    t0 = time.perf_counter()
    for _ in range(10):
        jax.block_until_ready(mm(a))
    mm_s = (time.perf_counter() - t0) / 10
    big = jnp.ones((512, 1024, 1024), jnp.float32)  # 2 GiB
    cp = device.jit(lambda x: x + 1.0)
    jax.block_until_ready(cp(big))
    t0 = time.perf_counter()
    for _ in range(10):
        jax.block_until_ready(cp(big))
    cp_s = (time.perf_counter() - t0) / 10
    report["reference_rates"] = {
        "bf16_matmul_8192_tflops": round(2 * 8192 ** 3 / mm_s / 1e12, 1),
        "copy_2gib_read_write_gbps": round(2 * big.nbytes / cp_s / 1e9, 1),
    }
    report["device"] = device_fields()
    with open(os.path.join(out_dir, "trace_report.json"), "w") as f:
        json.dump(report, f, indent=1)
    summary = {
        "metric": "trace_report",
        "value": report["decode"]["B=2048"]["us_per_step_wall"],
        "unit": "us/step (B=2048 decode, wall)",
        "encoder": {
            k: {kk: v[kk] for kk in (
                "ms_per_call_wall", "ms_per_call_device_busy",
                "idle_share", "scores_share_of_op_time")}
            for k, v in report["encoder"].items()
        },
        "decode": {
            k: {kk: v[kk] for kk in (
                "us_per_step_wall", "us_per_step_device_busy",
                "us_gap_per_step", "idle_share", "memcpy_events_per_step",
                "dot_lowering")}
            for k, v in report["decode"].items()
        },
        "reference_rates": report["reference_rates"],
    }
    print(result_line(summary))


def bench_providers():
    for provider in ("xla_int8", "f32"):
        result = _decode_bench(provider=provider, iters=3)
        result["provider"] = provider
        print(result_line(result))


def _watchdog(mode, seconds):
    """If the mode has not finished after `seconds`, report that on
    stderr and exit 3 — no result line, so nothing reads as a
    measurement."""
    import threading

    def fire():
        print(
            f"bench.py {mode}: no result after {seconds}s; aborting",
            file=sys.stderr, flush=True,
        )
        os._exit(3)

    timer = threading.Timer(seconds, fire)
    timer.daemon = True
    timer.start()
    return timer


def main():
    from slimt_jax.device import configure_compile_cache

    mode = sys.argv[1] if len(sys.argv) > 1 else "headline"
    modes = {
        "headline": bench_headline,
        "headline_shortlist": bench_headline_shortlist,
        "batch1": bench_batch1,
        "shortlist": bench_shortlist,
        "base": bench_base,
        "e2e": bench_e2e,
        "bulk": bench_bulk,
        "multipair": bench_multipair,
        "pivot": bench_pivot,
        "corpus": bench_corpus,
        "realcorpus": bench_realcorpus,
        "providers": bench_providers,
        "longctx": bench_longctx,
        "continuous": bench_continuous,
        "latency": bench_latency,
        "trace": bench_trace,
    }
    if mode not in modes:
        print(f"unknown mode {mode!r}; one of {sorted(modes)}", file=sys.stderr)
        return 2
    configure_compile_cache()
    device_fields()  # no GPU: exit before measuring anything
    timer = _watchdog(mode, int(os.environ.get("BENCH_WATCHDOG_S", 2400)))
    modes[mode]()
    timer.cancel()
    return 0


if __name__ == "__main__":
    sys.exit(main())
