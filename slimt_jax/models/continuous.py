"""Step-level continuous batching: chunked decode over a slot pool.

The reference generalizes only as far as batch-at-a-time: a Batcher
packs a batch, the whole batch decodes to completion, new requests wait
(slimt/Batcher.cc:95-120, slimt/Frontend.cc:207-227). The north-star
asks for "the Batcher generalized to continuous batching of translation
requests" — new work joining a RUNNING decode. On the device the decode loop
is a compiled `lax.while_loop`, so requests cannot literally join
mid-loop; instead the loop is segmented into fixed-size CHUNKS of k
steps. Between chunks, finished rows free their slots and queued
segments are admitted into them (their encoder pass + cross-KV scatter
happen while other rows keep decoding in subsequent chunks).

Device state lives in a persistent slot pool (`SlotPool`):
  - per-decoder-layer joined KV caches [B, T, E] (+ per-row scales),
  - additive source mask [B, 1, 1, T],
  - SSRU cell states, prev word, per-row step counts and caps,
  - a complete flag per row.

Three jitted programs, each compiled once per pool shape:
  - `_encode`:   indices/mask [A, T] → joined KV rows + mask rows
                 (the encoder + precompute_cross_kv prefix of
                 translate_batch, on the admission batch only);
  - `_admit`:    scatter A new rows into the pool at given slot ids
                 (OOB id = padding, dropped);
  - `_chunk`:    k decode steps from the carried state; returns the
                 updated pool and ONE uint16 buffer per chunk
                 [B, k tokens + bit-packed valid + complete flags]
                 (compact-transport discipline: one fetch per chunk).

Numerics are identical to `greedy_decode` — same decoder_step, same
argmax, same per-row EOS/cap bookkeeping — so a segment's tokens are
bit-equal to the batch-at-a-time path (differential-tested in
tests/test_continuous.py). Alignment-free only (the serving default);
full-vocab only (a shortlist is a per-batch union, incompatible with
rows that outlive batches).

Scheduling (host, `ContinuousEngine.translate`): shortest-first
admission from a pending heap, admissions padded to a fixed bucket to
bound compiles, fetch of chunk i overlapped with dispatch of chunk
i+1. Each fetched buffer is unpacked and appended per-slot; a row's
segment completes when its flag bit arrives.

Reference match: slimt/Batcher.cc:95-120 (the design generalized),
slimt/Model.cc:111-185 (per-sentence EOS/limit bookkeeping).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from slimt_jax import device
from slimt_jax.models import transformer as tfm


class SlotPool(NamedTuple):
    """Device-resident decode state for B slots (pytree)."""

    kv: Tuple  # per decoder layer: dict(k, v, kqi, vqi), rows = slots
    mask_add: jax.Array  # [B, 1, 1, T] f32
    states: Tuple  # per decoder layer: [B, 1, E] f32 SSRU cells
    prev: jax.Array  # [B] int32 previous word (0 = start)
    steps_done: jax.Array  # [B] int32
    cap: jax.Array  # [B] int32 per-row step cap (1.5 x src len)
    complete: jax.Array  # [B] bool


def _tree_scatter(pool_leaf, new_leaf, rows):
    """pool_leaf[rows] = new_leaf, OOB rows dropped (padding)."""
    return pool_leaf.at[rows].set(new_leaf, mode="drop")


@functools.partial(
    device.jit,
    static_argnames=(
        "num_heads", "provider", "kv_dtype", "encoder_dtype",
    ),
)
def encode_segments(
    params,
    indices,  # [A, T] int32
    mask,  # [A, T] f32
    *,
    num_heads: int,
    provider: Optional[str] = None,
    kv_dtype: Optional[str] = "int16",
    encoder_dtype: Optional[str] = None,
):
    """Encoder + cross-KV projection for an admission batch: the
    translate_batch prefix (models/decode.py) on A rows. Returns
    (kv rows pytree, mask_add [A,1,1,T], cap [A])."""
    act = jnp.dtype(encoder_dtype) if encoder_dtype else None
    x = tfm.transform_embedding(tfm.embed(params, indices, dtype=act))
    mask_add = tfm.make_additive_mask(mask)
    encoder_out = tfm.encoder_forward(
        params, x, mask_add, num_heads, provider, act_dtype=act
    )
    kv = tfm.precompute_cross_kv(
        params, encoder_out, num_heads, provider,
        dtype=(
            kv_dtype
            if kv_dtype in ("k8v16", "k16v8")
            else jnp.dtype(kv_dtype) if kv_dtype else None
        ),
    )
    lengths = jnp.sum(mask, axis=-1)  # [A]
    # floor() matches the batch path's int(limit_factor * len)
    # truncation (models/model.py steps_cap); per-ROW here — a row in
    # a continuous pool has no batch whose max length could cap it.
    cap = jnp.maximum(1, jnp.floor(1.5 * lengths)).astype(jnp.int32)
    return kv, mask_add, cap


@device.jit
def admit(pool: SlotPool, rows, kv_new, mask_new, cap_new) -> SlotPool:
    """Scatter A admissions into the pool at `rows` ([A] int32; an id
    >= B is padding and is dropped). Fresh rows start like
    greedy_decode's carry: zero states, prev=0, steps=0, incomplete."""
    kv = jax.tree_util.tree_map(
        lambda p, n: _tree_scatter(p, n, rows), pool.kv, kv_new
    )
    mask_add = _tree_scatter(pool.mask_add, mask_new, rows)
    states = jax.tree_util.tree_map(
        lambda s: s.at[rows].set(0.0, mode="drop"), pool.states
    )
    zero = jnp.zeros(rows.shape, jnp.int32)
    return SlotPool(
        kv=kv,
        mask_add=mask_add,
        states=states,
        prev=pool.prev.at[rows].set(zero, mode="drop"),
        steps_done=pool.steps_done.at[rows].set(zero, mode="drop"),
        cap=_tree_scatter(pool.cap, cap_new, rows),
        complete=pool.complete.at[rows].set(False, mode="drop"),
    )


def make_pool(
    params,
    slots: int,
    t_slot: int,
    *,
    kv_dtype: Optional[str] = "int16",
) -> SlotPool:
    """An all-complete (empty) pool; rows are populated by `admit`."""
    layers = params["decoder"]
    if not isinstance(layers, list):
        raise ValueError(
            "continuous decode needs list (unrolled) decoder layers — "
            "load with stack_layers(decoder=False)"
        )
    emb_dim = layers[0]["rnn"]["ln"]["scale"].shape[-1]
    kv_map = {
        "int16": jnp.int16, "int8": jnp.int8,
        "float16": jnp.float16, "bfloat16": jnp.bfloat16,
    }
    if kv_dtype not in kv_map:
        raise ValueError(
            f"continuous decode supports joined KV dtypes only, not "
            f"{kv_dtype!r}"
        )
    kdt = kv_map[kv_dtype]
    kv = tuple(
        {
            "k": jnp.zeros((slots, t_slot, emb_dim), kdt),
            "v": jnp.zeros((slots, t_slot, emb_dim), kdt),
            "kqi": jnp.ones((slots, t_slot), jnp.float32),
            "vqi": jnp.ones((slots, t_slot), jnp.float32),
        }
        for _ in layers
    )
    return SlotPool(
        kv=kv,
        mask_add=jnp.full((slots, 1, 1, t_slot), -1e8, jnp.float32),
        states=tuple(
            jnp.zeros((slots, 1, emb_dim), jnp.float32) for _ in layers
        ),
        prev=jnp.zeros((slots,), jnp.int32),
        steps_done=jnp.zeros((slots,), jnp.int32),
        cap=jnp.zeros((slots,), jnp.int32),
        complete=jnp.ones((slots,), jnp.bool_),
    )


@functools.partial(
    device.jit,
    static_argnames=(
        "chunk", "eos_id", "num_heads", "provider", "argmax_method",
    ),
)
def chunk_decode(
    params,
    pool: SlotPool,
    *,
    chunk: int,
    eos_id: int,
    num_heads: int,
    provider: Optional[str] = None,
    argmax_method: str = "packed_int",
) -> Tuple[SlotPool, jax.Array]:
    """Up to `chunk` greedy decode steps from the pool's carried state.

    Same per-step math and bookkeeping as greedy_decode
    (models/decode.py): zero embedding before the first word, the
    position-0 sinusoid every step, EOS recorded then row completed,
    per-row step caps. Early-exits when every row is complete.

    Returns (updated pool, packed uint16 [B, chunk + W + F]): chunk
    token columns, W = bit-packed valid words, F = bit-packed complete
    flags — one buffer, one host fetch per chunk."""
    slots = pool.prev.shape[0]
    emb_dim = pool.states[0].shape[-1]
    sqrt_e = math.sqrt(emb_dim)
    signal0 = tfm.sinusoidal_signal(0, 1, emb_dim)
    projection = tfm.prepare_output_projection(params, None)
    # states carried as [L] tuple; mask/kv are loop-invariant reads.
    tokens0 = jnp.zeros((slots, chunk), jnp.int32)
    valid0 = jnp.zeros((slots, chunk), jnp.bool_)

    def cond(carry):
        i, _, _, _, complete, _, _ = carry
        return jnp.logical_and(i < chunk, ~jnp.all(complete))

    def body(carry):
        i, prev, states, steps, complete, tokens, valid = carry
        # steps==0 rows feed the zero embedding (no previous word,
        # slimt/Transformer.cc:138-147) — steps replaces the global
        # loop counter of greedy_decode because rows have private ages.
        prev_embed = tfm.embed(params, prev[:, None])
        prev_embed = jnp.where(
            (steps == 0)[:, None, None], 0.0, prev_embed
        )
        x = prev_embed * sqrt_e + signal0
        choice, new_states, _ = tfm.decoder_step(
            params,
            states,
            x,
            pool.mask_add,
            pool.kv,
            num_heads,
            provider,
            None,
            projection=projection,
            sample=True,
            argmax_method=argmax_method,
        )
        word = choice.astype(jnp.int32)
        active = ~complete & (steps < pool.cap)
        tokens = jax.lax.dynamic_update_slice_in_dim(
            tokens, jnp.where(active, word, 0)[:, None], i, axis=1
        )
        valid = jax.lax.dynamic_update_slice_in_dim(
            valid, active[:, None], i, axis=1
        )
        steps = steps + active.astype(jnp.int32)
        complete = complete | (active & (word == eos_id)) | (
            steps >= pool.cap
        )
        prev = jnp.where(active, word, prev)
        return (i + 1, prev, new_states, steps, complete, tokens, valid)

    carry = (
        jnp.int32(0), pool.prev, pool.states, pool.steps_done,
        pool.complete, tokens0, valid0,
    )
    _, prev, states, steps, complete, tokens, valid = jax.lax.while_loop(
        cond, body, carry
    )
    new_pool = SlotPool(
        kv=pool.kv,
        mask_add=pool.mask_add,
        states=states,
        prev=prev,
        steps_done=steps,
        cap=pool.cap,
        complete=complete,
    )
    # One uint16 transport buffer: tokens, valid bits, complete bits.
    def packbits16(bits):
        by = jnp.packbits(bits, axis=-1)
        if by.shape[-1] % 2:
            by = jnp.pad(by, ((0, 0), (0, 1)))
        return (
            by[:, 0::2].astype(jnp.uint16)
            | (by[:, 1::2].astype(jnp.uint16) << 8)
        )

    packed = jnp.concatenate(
        [
            tokens.astype(jnp.uint16),
            packbits16(valid),
            packbits16(complete[:, None]),
        ],
        axis=1,
    )
    return new_pool, packed


def unpack_chunk(packed: np.ndarray, chunk: int):
    """Host inverse of chunk_decode's transport buffer: returns
    (tokens [B, chunk] int32, valid [B, chunk] bool, complete [B])."""
    packed = np.asarray(packed)
    tokens = packed[:, :chunk].astype(np.int32)
    wvalid = (chunk + 15) // 16

    def unpack(words, n):
        by = np.empty((words.shape[0], 2 * words.shape[1]), np.uint8)
        by[:, 0::2] = words & 0xFF
        by[:, 1::2] = words >> 8
        return np.unpackbits(
            by[:, : (n + 7) // 8], axis=1, count=n
        ).astype(bool)

    valid = unpack(packed[:, chunk : chunk + wvalid], chunk)
    complete = unpack(packed[:, chunk + wvalid :], 1)[:, 0]
    return tokens, valid, complete


class ContinuousEngine:
    """Host scheduler: shortest-first admission, chunked decode,
    fetch-behind-dispatch pipelining.

    `translate(segments)` returns per-segment token lists, bit-equal
    to the batch-at-a-time decode of the same segments."""

    def __init__(
        self,
        params,
        *,
        eos_id: int,
        num_heads: int,
        slots: int = 256,
        chunk: int = 16,
        t_slot: int = 64,
        admit_bucket: Optional[int] = None,
        kv_dtype: str = "int16",
        provider: Optional[str] = None,
        argmax_method: str = "packed_int",
        encoder_dtype: Optional[str] = None,
        admit_order: str = "shortest",  # "shortest" | "fifo" (online)
    ):
        self.params = params
        self.eos_id = eos_id
        self.num_heads = num_heads
        self.slots = slots
        self.chunk = chunk
        self.t_slot = t_slot
        self.admit_bucket = admit_bucket or max(8, slots // 4)
        self.kv_dtype = kv_dtype
        self.provider = provider
        self.argmax_method = argmax_method
        self.encoder_dtype = encoder_dtype
        self.admit_order = admit_order
        # Chunk transport packs tokens as uint16 (like the compact
        # transport): marian vocabs are 32k; larger vocabs need a
        # wider token column.
        vocab = params["emb"]["q"].shape[0]
        if vocab > 65535:
            raise ValueError(
                f"continuous decode's uint16 chunk transport supports "
                f"vocab <= 65535, model has {vocab}"
            )
        self.pool = make_pool(params, slots, t_slot, kv_dtype=kv_dtype)
        # Host mirror of slot occupancy: segment id per slot (-1 free).
        self.slot_seg = np.full(slots, -1, np.int64)
        self.stats: Dict[str, float] = {
            "chunks": 0, "occupied_rows": 0, "row_slots": 0,
            "admitted": 0, "encode_calls": 0,
        }

    def _encode_admissions(self, seg_tokens: List[List[int]]):
        a = self.admit_bucket
        indices = np.zeros((a, self.t_slot), np.int32)
        mask = np.zeros((a, self.t_slot), np.float32)
        for i, toks in enumerate(seg_tokens):
            if len(toks) > self.t_slot:
                # Never truncate silently: the caller owns wrapping
                # (TextProcessor wraps at wrap_length ≤ t_slot).
                raise ValueError(
                    f"segment of {len(toks)} tokens exceeds the pool's "
                    f"t_slot={self.t_slot}; wrap it first"
                )
            n = len(toks)
            indices[i, :n] = toks
            mask[i, :n] = 1.0
        kv, mask_add, cap = encode_segments(
            self.params,
            jnp.asarray(indices),
            jnp.asarray(mask),
            num_heads=self.num_heads,
            provider=self.provider,
            kv_dtype=self.kv_dtype,
            encoder_dtype=self.encoder_dtype,
        )
        self.stats["encode_calls"] += 1
        return kv, mask_add, cap

    def translate(self, segments: List[List[int]]) -> List[List[int]]:
        """Decode every segment (token id lists WITHOUT trailing EOS
        semantics changes — same input contract as translate_batch's
        rows). Admission order: "shortest" mirrors the reference
        Batcher's shortest-first packing (slimt/Batcher.cc:95-120);
        "fifo" admits in arrival order (the ONLINE serving regime
        where global sorting is impossible)."""
        if self.admit_order == "shortest":
            order = sorted(
                range(len(segments)), key=lambda i: len(segments[i])
            )
        else:
            order = list(range(len(segments)))
        pending = list(reversed(order))  # pop() = admission order
        results: List[Optional[List[int]]] = [None] * len(segments)
        grown: Dict[int, List[int]] = {}
        pool = self.pool
        inflight = None  # (future packed array, slot_seg snapshot)

        def harvest(packed_dev, snapshot):
            tokens, valid, complete = unpack_chunk(
                np.asarray(packed_dev), self.chunk
            )
            freed = []
            for b in range(self.slots):
                seg = snapshot[b]
                # A snapshot can name a segment that already completed
                # in an earlier chunk (its slot was freed after this
                # chunk was dispatched): the device row is complete and
                # produced nothing — skip, never re-complete it.
                if seg < 0 or results[seg] is not None:
                    continue
                row = grown.setdefault(seg, [])
                row.extend(tokens[b][valid[b]].tolist())
                self.stats["occupied_rows"] += 1
                if complete[b]:
                    results[seg] = grown.pop(seg)
                    freed.append(b)
            self.stats["row_slots"] += self.slots
            return freed

        # Occupancy loop: admit → dispatch chunk → (lagged) harvest.
        free = list(range(self.slots))[::-1]
        while pending or any(s >= 0 for s in self.slot_seg) or inflight:
            # Admit pending segments into every free slot (bucketed
            # into fixed-size encode calls to bound the compile cache).
            while pending and free:
                batch: List[List[int]] = []
                rows: List[int] = []
                while pending and free and len(batch) < self.admit_bucket:
                    seg = pending.pop()
                    b = free.pop()
                    self.slot_seg[b] = seg
                    batch.append(segments[seg])
                    rows.append(b)
                kv, mask_add, cap = self._encode_admissions(batch)
                row_ids = np.full(self.admit_bucket, self.slots, np.int32)
                row_ids[: len(rows)] = rows
                pool = admit(pool, jnp.asarray(row_ids), kv, mask_add, cap)
                self.stats["admitted"] += len(rows)
            if not any(s >= 0 for s in self.slot_seg):
                if inflight:
                    freed = harvest(*inflight)
                    free.extend(freed)
                    for b in freed:
                        self.slot_seg[b] = -1
                    inflight = None
                    continue
                break
            snapshot = self.slot_seg.copy()
            pool, packed = chunk_decode(
                self.params,
                pool,
                chunk=self.chunk,
                eos_id=self.eos_id,
                num_heads=self.num_heads,
                provider=self.provider,
                argmax_method=self.argmax_method,
            )
            self.stats["chunks"] += 1
            # Harvest the PREVIOUS chunk while this one runs on device
            # (fetch-behind-dispatch, one chunk of pipeline lag).
            if inflight:
                freed = harvest(*inflight)
                free.extend(freed)
                for b in freed:
                    # A freed slot stays idle for the chunk already
                    # dispatched; cleared here so the NEXT admission
                    # round can take it.
                    self.slot_seg[b] = -1
            inflight = (packed, snapshot)
        self.pool = pool
        return [r if r is not None else [] for r in results]

    def occupancy(self) -> float:
        return self.stats["occupied_rows"] / max(1, self.stats["row_slots"])
