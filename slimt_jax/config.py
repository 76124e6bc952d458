"""Configuration structs for models and the translation service.

Mirrors the reference's plain-struct config surface:
- service `Config` (reference slimt/Frontend.hh:21-39)
- `Model::Config` (reference slimt/Model.hh:33-51)
- presets tiny/base/nano (reference slimt/Model.cc:206-245)
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class ModelConfig:
    """Architecture hyperparameters of a Bergamot student model.

    Defaults are the `tiny` preset (6 encoder layers, 2 SSRU decoder
    layers, 8 heads; reference slimt/Model.cc:206-218).
    """

    encoder_layers: int = 6
    decoder_layers: int = 2
    feed_forward_depth: int = 2
    num_heads: int = 8
    split_mode: str = "sentence"

    # Execution knobs (no reference equivalent).
    # Quantized-matmul provider: "xla_int8" (lax.dot_general int8 ->
    # int32) or "f32" (dequantized float reference path). Mirrors the
    # reference's compile-time QMM provider switch (QMM.cc:3-34).
    qmm_provider: str = "xla_int8"
    # The reference decoder adds the position-0 sinusoid at *every* decode
    # step (Transformer.cc:160 calls transform_embedding with start=0).
    # Keep True for output parity with the reference; False restores
    # marian's per-position signal.
    decoder_position_zero: bool = True
    # Cross-attention K/V cache dtype for the decode loop. The cache
    # is re-read from device memory every step, the dominant per-step
    # traffic at serving batch. Reduced-precision dtypes also switch
    # the cache to the joined [B,T,E] layout with GEMM attention
    # (models/transformer._decode_attention_joined). The default
    # "int16" is the PARITY-PROVEN serving config: per-row (b,t)
    # scales at 2 bytes/elem (the same traffic as fp16/bf16) with a
    # uniform absolute error of rowmax/65534 (16x finer than fp16,
    # ~256x finer than bf16); converts to f32 inside the attention
    # matmul operand read. Measured vs the compiled reference binary
    # on the adversarial crosscheck serving sweep (CPU;
    # crosscheck/serving_agreement.json, 2048 sentences/config; the
    # exact path's own ceiling there is 99.92%): int16 99.7% tokens;
    # fp16 99.0%; bf16 96.8%; int8 per-row 93.8% — all remain explicit
    # opt-ins. "float32" restores exact reference numerics (and the
    # split-layout cache).
    kv_cache_dtype: str = "int16"
    # Greedy-sampling argmax implementation. "packed_int" (DEFAULT) =
    # one plain int32 max-reduce over INTEGER packed keys in the
    # accumulator domain: the projection's per-tensor scale is a
    # positive scalar, so the bias folds to i32 accumulator units once
    # (loop-invariant) and the whole float epilogue (i32->f32 convert,
    # scale, bias add, round, bitcast, sortable map) collapses to an
    # integer add + shift (models/transformer.packed_int_argmax;
    # first-index tie-break, invariant-certified in
    # tests/test_packed_argmax.py). Agreement vs the reference binary
    # (CPU crosscheck serving sweep): packed_int alone matches the
    # exact path (99.92% tokens); the full default stack (int16 KV +
    # packed_int + alignment-free) measures 99.69% tokens / 99.1%
    # sentence-exact (= the int16 KV's own ceiling). The compared-value
    # truncation (2^shift accumulator units) and half-unit bias
    # rounding are the only numerics deltas. "packed_fp16"/
    # "packed_bf16" = the 16-bit-float packed keys (99.79%/98.56%
    # alone); "exact" = f32 variadic argmax (reference numerics; also
    # the fallback when the provider is f32, which has no integer
    # accumulator).
    argmax_method: str = "packed_int"
    # Query-chunked encoder self-attention (ops/attention.
    # chunked_attention): O(T·block) memory instead of the einsum's
    # [B,H,T,T] f32 scores, for unwrapped inputs whose scores would not
    # fit. Off by default: on the H100 the einsum was faster at every T
    # from 256 to 4096 and within 4% at T=128 (bench.py longctx;
    # PERF.md), so no T-based switch pays for itself.
    flash_attention: bool = False
    # LOSSLESS result-transport compaction: the decode jit returns
    # tokens as uint16 and the valid mask bit-packed (2.35x fewer
    # result bytes per batch device-to-host; models/decode.
    # compact_result / unpack_compact). Bit-exact — a transport
    # encoding, not a numerics knob; auto-disabled when
    # vocab_size > 65535 (marian tiny/base vocabs are 32k).
    compact_transfer: bool = True
    # Reduced-precision ENCODER activations ("float16"/"bfloat16"):
    # the residual stream and SDPA operands between encoder blocks
    # ride this dtype (LN statistics and matmul accumulation stay
    # f32; the int8 affine inputs round through it before
    # quantization). MEASURED AGREEMENT (CPU crosscheck serving
    # sweep): float16 92.8% / bfloat16 92.5% token agreement —
    # int8-CLASS (any reduced dtype upstream of an int8 activation
    # quantize flips rint() by ±1 LSB on a few % of entries; six
    # cascaded layers amplify it). None = exact f32 encoder
    # (bit-identical reference numerics).
    encoder_dtype: "str | None" = None


@dataclasses.dataclass
class Config:
    """Service configuration (reference slimt/Frontend.hh:21-39)."""

    max_words: int = 1024  # max padded tokens per device batch
    cache_size: int = 1024  # translation cache entries; 0 disables
    workers: int = 1  # async worker threads
    tgt_length_limit_factor: float = 1.5  # max target len / source len
    wrap_length: int = 128  # hard wrap for long sentences (tokens)
    html: bool = False
    # Async batching window (seconds): how long a worker waits for
    # more segments once work exists. 0 = reference behavior (pack
    # immediately); a few ms greatly improves device batch occupancy
    # under streaming request loads.
    batch_latency: float = 0.0
    # Blocking-service completion pool: host-side response assembly
    # (detokenize + annotations) runs on this many executor threads,
    # overlapped with the device waits for later batches. 0 = strict
    # reference behavior (complete serially on the caller thread).
    completion_threads: int = 4
    # Bulk path (Blocking.translate_bulk) ingest chunk size in lines:
    # each chunk's device batches dispatch before the next chunk
    # tokenizes, hiding device compute behind host ingest. 0 = one
    # chunk (ingest everything first).
    bulk_chunk_lines: int = 2048
    # Bulk-path ingest worker processes: chunks tokenize in this many
    # spawned processes (each with its own TextProcessor), lifting the
    # GIL's one-core cap on host ingest. 0 = in-process ingest (the
    # right choice on few-core hosts, where main-thread unpickling
    # replaces already-overlapped tokenization; worth enabling on
    # many-core serving hosts). The pool starts lazily on first multi-chunk
    # translate_bulk call and lives for the service's lifetime.
    ingest_processes: int = 0
    # Blocking.translate routes through the bulk lane by default: for
    # a known list of lines it produces byte-identical Responses to
    # the per-request path (differential-tested: annotations,
    # alignments, cache interplay, HTML) at a multiple of the host
    # throughput. False pins the reference-style Request/Batcher
    # exhaust loop (slimt/Frontend.cc:91-145) for every call.
    prefer_bulk: bool = True
    # Raise Python's gen-0 garbage-collection threshold to this many
    # allocations while a service exists (0 = leave gc untouched).
    # JAX runs an XLA collect_garbage callback on EVERY gc pass; at
    # the default gen-0 threshold (700 allocations) a host-heavy
    # serving loop pays for it hundreds of times per second.
    # Only ever raises the threshold, never lowers it.
    gc_gen0_threshold: int = 50_000


class preset:
    """Model presets (reference slimt/Model.cc:206-245)."""

    @staticmethod
    def tiny() -> ModelConfig:
        return ModelConfig(encoder_layers=6, decoder_layers=2)

    @staticmethod
    def base() -> ModelConfig:
        return ModelConfig(encoder_layers=6, decoder_layers=2)

    @staticmethod
    def nano() -> ModelConfig:
        return ModelConfig(encoder_layers=4, decoder_layers=2)
