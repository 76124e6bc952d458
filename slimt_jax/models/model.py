"""Model: vocabulary + text processor + transformer weights + shortlist.

The user-facing model object (reference slimt/Model.{hh,cc}): built
from a Package of artifacts (paths or bytes), owns the loaded weight
pytree on device, and turns batches of token segments into Histories
via the jitted encoder + greedy-decode step.

Accelerator adaptations over the reference forward
(slimt/Model.cc:111-204):

  - (B, T) shapes are bucketed (T to multiples of 16, B to powers of
    two) so the XLA compile cache stays small; padded rows carry a
    zero mask and their outputs are discarded;
  - the shortlist is padded to a static bucket size (multiples of
    1024, capped at the vocab) with unused target ids, keeping the
    logit matmul shape stable and the compile cache tiny;
  - the whole decode loop runs on device (lax.while_loop with early
    exit), not one host step per token.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Sequence, Union

import numpy as np

from slimt_jax.config import ModelConfig
from slimt_jax.io import load_items
from slimt_jax.io.loader import load_weights, model_dims, stack_layers
from slimt_jax.io.shortlist import ShortlistGenerator
from slimt_jax.runtime.request import Hypothesis
from slimt_jax.text.processor import TextProcessor
from slimt_jax.text.vocabulary import Vocabulary

_model_ids = itertools.count()

SHORTLIST_BUCKET = 1024
SEQ_BUCKET = 16

def _bucket_seq(t: int) -> int:
    return max(SEQ_BUCKET, -(-t // SEQ_BUCKET) * SEQ_BUCKET)


def _bucket_batch(b: int) -> int:
    out = 1
    while out < b:
        out *= 2
    return out


@dataclasses.dataclass
class Package:
    """Artifact bundle (reference slimt/Model.hh:23-44): each field is
    a filesystem path or raw bytes."""

    model: Union[str, bytes]
    vocabulary: Union[str, bytes]
    shortlist: Union[str, bytes, None] = None
    ssplit: Union[str, bytes, None] = None

    @staticmethod
    def _bytes(source: Union[str, bytes, None]) -> Optional[bytes]:
        if source is None:
            return None
        if isinstance(source, (bytes, bytearray)):
            return bytes(source)
        with open(source, "rb") as f:
            return f.read()


class Model:
    def __init__(
        self,
        config: ModelConfig,
        package: Package,
        tgt_length_limit_factor: float = 1.5,
        mesh=None,
        sharding: str = "tp",
        shard_sequence: bool = False,
    ):
        """`mesh` (a jax.sharding.Mesh with axes "data"/"model"/"seq")
        turns the model multi-chip: weights are tensor-parallel sharded
        over "model" (or replicated with sharding="replicate" — usually
        faster for these tiny models) and request batches data-parallel
        over "data". With shard_sequence=True (and a "seq" axis > 1)
        the token dim of every batch is additionally sequence-sharded
        (SP) — encoder activations and cross-attention KV caches
        inherit it. Single chip when mesh is None."""
        import jax

        from slimt_jax.device import configure_compile_cache

        configure_compile_cache()
        self.id = next(_model_ids)
        self.config = config
        self.limit_factor = tgt_length_limit_factor
        self.mesh = mesh

        model_bytes = Package._bytes(package.model)
        from slimt_jax.io import checkpoint as ckpt

        if ckpt.is_native(model_bytes):
            import io as _io

            host_params, meta = ckpt.load_native(_io.BytesIO(model_bytes))
            self.vocab_size = meta["vocab_size"]
            self.emb_dim = meta["emb_dim"]
            self.ffn_dim = meta["ffn_dim"]
        else:
            items = load_items(model_bytes)
            host_params = load_weights(items, config)
            self.vocab_size, self.emb_dim, self.ffn_dim = model_dims(
                host_params
            )
            # Encoder stacked (lax.scan): much faster XLA compiles
            # per shape bucket. The decoder is stacked under int8 KV
            # and unrolled otherwise (a choice made on the earlier
            # accelerator; not yet re-measured on the GPU).
            host_params = stack_layers(
                host_params, decoder=config.kv_cache_dtype == "int8"
            )
        if mesh is not None:
            from slimt_jax.parallel import sharding as shd

            # Multi-process SPMD (one process per host): every
            # process runs the identical host pipeline on the full
            # request stream; device arrays are assembled from each
            # process's addressable shards and results all-gathered.
            self._multiprocess = jax.process_count() > 1
            if sharding == "replicate":
                self.params = shd.replicate_params(host_params, mesh)
            else:
                self.params = shd.shard_params(host_params, mesh)
            seq_axis = mesh.shape.get("seq", 1)
            shard_seq = shard_sequence and seq_axis > 1
            if shard_seq and 16 % seq_axis != 0:
                # T buckets are multiples of 16 (_bucket_seq); the seq
                # axis must divide them for the [B, T] sharding.
                raise ValueError(
                    f"seq axis {seq_axis} must divide the T bucket (16)"
                )
            self._batch_sharding = jax.sharding.NamedSharding(
                mesh, shd.batch_pspec(seq=shard_seq)
            )
            self._data_size = mesh.shape.get("data", 1)
        else:
            self.params = jax.device_put(host_params)
            self._batch_sharding = None
            self._data_size = 1
            self._multiprocess = False

        self.vocabulary = Vocabulary(Package._bytes(package.vocabulary))
        ssplit = Package._bytes(package.ssplit)
        self.processor = TextProcessor(
            config.split_mode,
            self.vocabulary,
            ssplit.decode("utf-8") if ssplit else None,
        )

        self.shortlist_generator: Optional[ShortlistGenerator] = None
        shortlist_bytes = Package._bytes(package.shortlist)
        if shortlist_bytes:
            self.shortlist_generator = ShortlistGenerator(
                shortlist_bytes, vocab_size=self.vocab_size
            )
        from slimt_jax.utils import ShortlistMeter

        self.shortlist_meter = ShortlistMeter()

    # -- device forward ------------------------------------------------

    def forward(
        self,
        segments: Sequence[Sequence[int]],
        need_alignment: bool = True,
    ) -> List[Hypothesis]:
        """Translate a batch of token segments (each ending in EOS)
        into Histories (reference slimt/Model.cc:187-204).

        `need_alignment=False` skips the device→host transfer of the
        per-step cross-attention matrices ([B, steps, T] — by far the
        largest result buffer); hypotheses then carry empty
        alignments. The reference always materializes them
        (slimt/Model.cc:84-108); here the transfer is the cost, not
        the compute."""
        return self.forward_async(segments, need_alignment)()

    def forward_async(
        self,
        segments: Sequence[Sequence[int]],
        need_alignment: bool = True,
        raw: bool = False,
    ):
        """Dispatch the device computation and return a zero-arg
        callable producing the Histories. JAX dispatch is async, so
        callers can launch several batches back-to-back and fetch
        results later — hiding the host↔device round-trip behind
        compute (the serving loops use this to pipeline batches).

        `raw=True`: finish() returns the columnar result arrays
        (tokens [B, steps], per-row step counts, alignment or None)
        instead of per-row Hypothesis objects — the serving loops feed
        these straight to Batch.complete_raw (one native decode call
        for the whole matrix, no per-row Python)."""
        batch = len(segments)
        lengths = [len(s) for s in segments]
        # power-of-two bucket, rounded to a multiple of the data axis
        b_pad = -(-_bucket_batch(batch) // self._data_size) * self._data_size
        t_pad = _bucket_seq(max(lengths))

        pad_id = self.vocabulary.pad_id
        indices = np.full((b_pad, t_pad), pad_id, np.int32)
        mask = np.zeros((b_pad, t_pad), np.float32)
        for i, segment in enumerate(segments):
            indices[i, : len(segment)] = segment
            mask[i, : len(segment)] = 1.0

        words = None
        if self.shortlist_generator is not None:
            words = [w for s in segments for w in s]
        return self._dispatch(
            indices, mask, lengths, batch, need_alignment, words, raw=raw
        )

    def forward_async_arrays(
        self,
        indices: np.ndarray,
        mask: np.ndarray,
        lengths,
        batch: int,
        need_alignment: bool = False,
        shortlist_words=None,
        raw: bool = False,
    ):
        """Columnar forward: the caller packed the padded [B,T]
        indices/mask arrays itself (one vectorized scatter from flat
        token arrays — the bulk lane). With raw=True the finish()
        returns the result arrays (tokens [B,T'], steps per row,
        alignment or None) instead of per-row Hypothesis objects."""
        return self._dispatch(
            indices, mask, lengths, batch, need_alignment,
            shortlist_words, raw=raw,
        )

    def _dispatch(
        self, indices, mask, lengths, batch, need_alignment,
        shortlist_words, raw: bool = False,
    ):
        import jax
        import jax.numpy as jnp

        from slimt_jax.models.decode import translate_batch_jit

        b_pad, t_pad = indices.shape
        shortlist = None
        if self.shortlist_generator is not None:
            words = shortlist_words
            if words is None:
                words = []
            elif isinstance(words, np.ndarray):
                words = words.tolist()
            raw_width = len(self.shortlist_generator.generate(words))
            shortlist = self.shortlist_generator.generate_padded(
                words, SHORTLIST_BUCKET
            ).astype(np.int32)
            # Observability: generated vs bucket-padded widths
            # (surfaced by bench realcorpus / server /stats).
            self.shortlist_meter.record_widths(raw_width, len(shortlist))

        # Static bound (sizes output buffers, keyed into the compile
        # cache by the bucketed t_pad) vs dynamic cap (the reference's
        # limit_factor × actual batch max source length,
        # slimt/Model.cc:160 — a traced scalar, so truncation does not
        # depend on which shape bucket the batch landed in and varying
        # it never recompiles).
        max_steps = max(1, int(self.limit_factor * t_pad))
        actual_max = max((int(n) for n in lengths), default=t_pad)
        steps_cap = np.int32(max(1, int(self.limit_factor * actual_max)))
        if self._multiprocess:
            # Each process serves its addressable shards of the (host-
            # replicated) global batch.
            indices_j = jax.make_array_from_callback(
                indices.shape, self._batch_sharding,
                lambda idx: indices[idx],
            )
            mask_j = jax.make_array_from_callback(
                mask.shape, self._batch_sharding, lambda idx: mask[idx]
            )
        elif self._batch_sharding is not None:
            indices_j = jax.device_put(indices, self._batch_sharding)
            mask_j = jax.device_put(mask, self._batch_sharding)
        else:
            indices_j = jnp.asarray(indices)
            mask_j = jnp.asarray(mask)
        # Lossless transport compaction (uint16 tokens + bit-packed
        # valid): 2.35x fewer result bytes per fetch. Transport
        # encoding only — bit-exact after unpack_compact.
        compact = (
            getattr(self.config, "compact_transfer", False)
            and self.vocab_size <= 65535
        )
        result = translate_batch_jit(
            self.params,
            indices_j,
            mask_j,
            jnp.asarray(shortlist) if shortlist is not None else jnp.zeros(
                (SHORTLIST_BUCKET,), jnp.int32
            ),
            steps_cap,
            eos_id=self.vocabulary.eos_id,
            max_steps=max_steps,
            num_heads=self.config.num_heads,
            provider=self.config.qmm_provider,
            decoder_position_zero=self.config.decoder_position_zero,
            with_shortlist=shortlist is not None,
            flash_attention=bool(self.config.flash_attention),
            kv_dtype=(
                None
                if self.config.kv_cache_dtype == "float32"
                else self.config.kv_cache_dtype
            ),
            # Static: alignment-free requests (no Options.alignment/
            # html — the serving default) compile a loop variant with
            # no [B, max_steps, T] alignment carry
            # (models/decode.greedy_decode). Each (B, T, S) bucket gets
            # at most two variants, warmed per the service's needs.
            with_alignment=bool(need_alignment),
            argmax_method=self.config.argmax_method,
            compact_output=compact,
            encoder_dtype=self.config.encoder_dtype,
        )
        def finish() -> List[Hypothesis]:
            if self._multiprocess:
                from jax.experimental import multihost_utils

                if compact:
                    from slimt_jax.models.decode import unpack_compact

                    packed = np.asarray(
                        multihost_utils.process_allgather(
                            result.packed, tiled=True
                        )
                    )
                    tokens, valid = unpack_compact(packed, max_steps)
                else:
                    tokens = np.asarray(
                        multihost_utils.process_allgather(
                            result.tokens, tiled=True
                        )
                    )
                    valid = np.asarray(
                        multihost_utils.process_allgather(
                            result.valid, tiled=True
                        )
                    )
                align = (
                    np.asarray(
                        multihost_utils.process_allgather(
                            result.alignment, tiled=True
                        )
                    )
                    if need_alignment
                    else None
                )
            elif compact:
                from slimt_jax.models.decode import unpack_compact

                tokens, valid = unpack_compact(result.packed, max_steps)
                align = (
                    np.asarray(result.alignment) if need_alignment else None
                )
            else:
                tokens = np.asarray(result.tokens)
                valid = np.asarray(result.valid)
                align = (
                    np.asarray(result.alignment) if need_alignment else None
                )

            if raw:
                steps = valid[:batch].sum(axis=1).astype(np.int32)
                return tokens, steps, align

            histories = []
            for i in range(batch):
                steps = int(valid[i].sum())
                target = tokens[i, :steps].tolist()
                if align is not None:
                    alignment = [
                        align[i, t, : lengths[i]].tolist()
                        for t in range(steps)
                    ]
                else:
                    alignment = []
                histories.append(
                    Hypothesis(target=target, alignment=alignment)
                )
            return histories

        return finish

    def warmup(
        self,
        batch_buckets: Sequence[int] = (1, 8, 64),
        seq_buckets: Sequence[int] = (16, 32, 64, 128),
        alignment: bool = False,
    ) -> int:
        """Pre-compile the (B, T) shape buckets a serving workload will
        hit, so no request pays XLA compile latency. Returns the number
        of variants compiled. No reference equivalent (the CPU path
        has no compile step).

        `alignment=True` additionally warms the with-alignment loop
        variant (requests carrying Options.alignment/html compile
        separately — the default variant drops the alignment carry)."""
        compiled = 0
        for b in batch_buckets:
            for t in seq_buckets:
                segment = [1] * (t - 1) + [self.vocabulary.eos_id]
                self.forward([segment] * b, need_alignment=False)
                compiled += 1
                if alignment:
                    self.forward([segment] * b, need_alignment=True)
                    compiled += 1
        return compiled

    def __repr__(self):
        return (
            f"Model(id={self.id}, vocab={self.vocab_size}, "
            f"emb={self.emb_dim}, ffn={self.ffn_dim})"
        )
