"""Greedy decode as a device-resident loop.

The reference's decode (slimt/Model.cc:111-185) is a host-side Python-
style loop: one `Decoder::step` per target token with per-sentence EOS
bookkeeping and an early exit when every sentence finished. Here the
whole loop is a `lax.while_loop` inside one jit: fixed trip bound
`max_steps = limit_factor * T_src` with a finished-mask, and the early
exit preserved through the loop predicate (`step < max_steps AND any
unfinished`) — so a batch that finishes in 10 steps costs 10 steps.

Semantics matched to the reference:
  - step 0 feeds a zero embedding (no previous word,
    slimt/Transformer.cc:138-147);
  - the positional signal added to decoder embeddings is position 0
    every step (slimt/Transformer.cc:160 — `transform_embedding`
    defaulting start=0), switchable via `decoder_position_zero`;
  - the EOS token itself is recorded, then the sentence is marked
    complete (slimt/Model.cc:125-137);
  - per-step soft alignments are head 0 of the last decoder layer's
    cross-attention (slimt/Model.cc:84-108).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from slimt_jax import device
from slimt_jax.models import transformer as tfm

# Read ONCE at import: the value participates in traced control flow,
# so a mid-process change could not take effect for already-compiled
# shape buckets anyway (jit caches would silently mix unrolls). Set it
# before the process imports slimt_jax, or pass `loop_unroll`
# explicitly per call.
import os as _os

_ENV_DECODE_UNROLL = int(_os.environ.get("SLIMT_JAX_DECODE_UNROLL", "1"))


class GreedyResult(NamedTuple):
    tokens: jax.Array  # [B, max_steps] int32
    valid: jax.Array  # [B, max_steps] bool — recorded positions
    alignment: jax.Array  # [B, max_steps, T_src] f32 — head-0 cross-attn


def greedy_decode(
    params: dict,
    encoder_out: jax.Array,
    mask_add: jax.Array,
    eos_id: int,
    max_steps: int,
    num_heads: int,
    provider: Optional[str] = None,
    shortlist: Optional[jax.Array] = None,
    decoder_position_zero: bool = True,
    kv_dtype: Optional[str] = None,
    steps_cap: Optional[jax.Array] = None,
    with_alignment: bool = True,
    argmax_method: str = "exact",
    loop_unroll: Optional[int] = None,
) -> GreedyResult:
    batch, t_src, emb_dim = encoder_out.shape
    # Decode steps per while_loop iteration (bit-exact for any factor,
    # incl. steps_cap tails). Default 1; SLIMT_JAX_DECODE_UNROLL or the
    # parameter overrides.
    if loop_unroll is None:
        loop_unroll = _ENV_DECODE_UNROLL
    unroll = max(1, int(loop_unroll))
    steps_padded = -(-max_steps // unroll) * unroll
    if kv_dtype == "float32":
        # "float32" means THE exact path (split [B,H,T,D] f32 caches —
        # the same mapping models/model.py applies to
        # ModelConfig.kv_cache_dtype), not a joined-layout f32 cache
        # with its different accumulation order.
        kv_dtype = None
    kv_caches = tfm.precompute_cross_kv(
        params, encoder_out, num_heads, provider,
        # "k8v16"/"k16v8" (mixed-precision caches) are composite
        # tags, not jnp dtypes — passed through as-is.
        dtype=(
            kv_dtype
            if kv_dtype in ("k8v16", "k16v8")
            else jnp.dtype(kv_dtype) if kv_dtype else None
        ),
    )
    # Loop-invariant output projection (incl. shortlist select).
    projection = tfm.prepare_output_projection(params, shortlist)
    if isinstance(params["decoder"], list):
        states0 = tuple(
            jnp.zeros((batch, 1, emb_dim), jnp.float32)
            for _ in params["decoder"]
        )
    else:  # stacked layers: one [L, B, 1, E] state array
        n_layers = params["decoder"]["rnn"]["ln"]["scale"].shape[0]
        states0 = jnp.zeros((n_layers, batch, 1, emb_dim), jnp.float32)

    tokens0 = jnp.zeros((batch, steps_padded), jnp.int32)
    valid0 = jnp.zeros((batch, steps_padded), jnp.bool_)
    # `with_alignment=False` (requests without Options.alignment/html —
    # the serving default) drops the [B, max_steps, T_src] alignment
    # buffer from the loop carry entirely (no per-step masked write),
    # and XLA dead-code-eliminates the attention-weights extraction
    # once nothing reads it. A zero-width [B, max_steps, 0] result keeps the return
    # structure (and downstream reshapes) intact.
    align_w = t_src if with_alignment else 0
    align0 = jnp.zeros((batch, steps_padded, align_w), jnp.float32)
    # Padding rows (fully-masked; added by batch-size bucketing) start
    # complete so they never defeat the early exit.
    complete0 = ~jnp.any(mask_add[:, 0, 0, :] == 0.0, axis=-1)
    prev0 = jnp.zeros((batch,), jnp.int32)

    sqrt_e = math.sqrt(emb_dim)

    # `max_steps` (static, from the bucketed T) sizes the output
    # buffers; `steps_cap` (traced, limit_factor × the batch's ACTUAL
    # longest source — reference slimt/Model.cc:160) bounds the trip
    # count, so truncation of a never-EOS decode does not depend on
    # the shape bucket the batch landed in.
    limit = (
        max_steps
        if steps_cap is None
        else jnp.minimum(max_steps, steps_cap)
    )

    def cond(carry):
        step, _, _, complete, *_ = carry
        return jnp.logical_and(step < limit, ~jnp.all(complete))

    # With the reference's position-0 behavior the decoder positional
    # signal is a constant — computed once, not per step.
    signal0 = tfm.sinusoidal_signal(0, 1, emb_dim)

    def one_step(carry):
        step, prev, states, complete, tokens, valid, align = carry

        prev_embed = tfm.embed(params, prev[:, None])  # [B, 1, E]
        prev_embed = jnp.where(step == 0, 0.0, prev_embed)
        if decoder_position_zero:
            signal = signal0
        else:
            signal = tfm.sinusoidal_signal(
                0, 1, emb_dim,
                positions=step[None].astype(jnp.float32)
                if hasattr(step, "astype")
                else jnp.asarray([step], jnp.float32),
            )
        x = prev_embed * sqrt_e + signal

        choice, new_states, attn = tfm.decoder_step(
            params,
            states,
            x,
            mask_add,
            kv_caches,
            num_heads,
            provider,
            shortlist,
            projection=projection,
            sample=True,
            argmax_method=argmax_method,
        )
        if shortlist is not None:
            word = jnp.take(shortlist, choice, axis=0).astype(jnp.int32)
        else:
            word = choice

        # `step < limit` guards unroll tail sub-steps past the cap —
        # a no-op for unroll=1 (the loop cond already guarantees it).
        in_limit = step < limit
        active = ~complete & in_limit
        tokens = jax.lax.dynamic_update_slice_in_dim(
            tokens, jnp.where(active, word, 0)[:, None], step, axis=1
        )
        valid = jax.lax.dynamic_update_slice_in_dim(
            valid, active[:, None], step, axis=1
        )
        if with_alignment:
            head0 = attn[:, 0, 0, :]  # [B, T_src]
            align = jax.lax.dynamic_update_slice(
                align,
                jnp.where(active[:, None], head0, 0.0)[:, None, :],
                (0, step, 0),
            )
        complete = complete | ((word == eos_id) & in_limit)
        return (step + 1, word, new_states, complete, tokens, valid, align)

    def body(carry):
        for _ in range(unroll):
            carry = one_step(carry)
        return carry

    carry = (0, prev0, states0, complete0, tokens0, valid0, align0)
    _, _, _, _, tokens, valid, align = jax.lax.while_loop(cond, body, carry)
    if steps_padded != max_steps:
        tokens = tokens[:, :max_steps]
        valid = valid[:, :max_steps]
        align = align[:, :max_steps]
    return GreedyResult(tokens, valid, align)


def translate_batch(
    params: dict,
    indices: jax.Array,
    mask: jax.Array,
    eos_id: int,
    max_steps: int,
    num_heads: int,
    provider: Optional[str] = None,
    shortlist: Optional[jax.Array] = None,
    decoder_position_zero: bool = True,
    flash_attention: bool = False,
    kv_dtype: Optional[str] = None,
    steps_cap: Optional[jax.Array] = None,
    with_alignment: bool = True,
    argmax_method: str = "exact",
    loop_unroll: Optional[int] = None,
    encoder_dtype: Optional[str] = None,
) -> GreedyResult:
    """Full forward: embed → encoder → greedy decode
    (slimt/Model.cc:187-204). `indices`/`mask`: [B, T] padded batch in
    the reference Input layout (slimt/Input.cc:20-47).

    `encoder_dtype` ("float16"/"bfloat16") runs the encoder's residual
    stream and SDPA operands in that dtype (half the activation bytes);
    the int8 affine inputs round through it before quantization.
    None = exact f32. The
    decode loop's own numerics (kv_dtype, argmax) are independent."""
    act = jnp.dtype(encoder_dtype) if encoder_dtype else None
    word_embedding = tfm.embed(params, indices, dtype=act)
    word_embedding = tfm.transform_embedding(word_embedding)
    mask_add = tfm.make_additive_mask(mask)
    encoder_out = tfm.encoder_forward(
        params, word_embedding, mask_add, num_heads, provider,
        flash=flash_attention,
        act_dtype=act,
    )
    return greedy_decode(
        params,
        encoder_out,
        mask_add,
        eos_id,
        max_steps,
        num_heads,
        provider,
        shortlist,
        decoder_position_zero,
        kv_dtype,
        steps_cap,
        with_alignment,
        argmax_method,
        loop_unroll,
    )


class CompactResult(NamedTuple):
    """Transport-compact decode result: ONE uint16 buffer per batch.

    packed[:, :S] = tokens as uint16 (valid for 32k marian vocabs;
    the caller guards vocab_size > 65535); packed[:, S:] = the valid
    mask bit-packed little-endian-by-byte into uint16 words: ~2.4×
    fewer bytes and half the device-to-host copies vs (int32 tokens,
    bool valid).
    Alignments are untouched (f32-semantic: HTML hard-align ties).
    """

    packed: jax.Array  # [B, S + ceil(ceil(S/8)/2)] uint16
    alignment: jax.Array  # as GreedyResult


def compact_result(result: GreedyResult) -> CompactResult:
    """Lossless device-side compaction; inverse: `unpack_compact`."""
    tokens16 = result.tokens.astype(jnp.uint16)
    bits = jnp.packbits(result.valid, axis=-1)  # [B, ceil(S/8)] u8
    if bits.shape[-1] % 2:
        bits = jnp.pad(bits, ((0, 0), (0, 1)))
    lo = bits[:, 0::2].astype(jnp.uint16)
    hi = bits[:, 1::2].astype(jnp.uint16)
    words = lo | (hi << 8)
    return CompactResult(
        jnp.concatenate([tokens16, words], axis=1), result.alignment
    )


def unpack_compact(packed, max_steps: int):
    """Host-side inverse of `compact_result` on the fetched numpy
    array: returns (tokens int32 [B, max_steps], valid bool
    [B, max_steps])."""
    import numpy as _np

    packed = _np.asarray(packed)
    tokens = packed[:, :max_steps].astype(_np.int32)
    words = packed[:, max_steps:]
    byte_pairs = _np.empty(
        (words.shape[0], 2 * words.shape[1]), _np.uint8
    )
    byte_pairs[:, 0::2] = words & 0xFF
    byte_pairs[:, 1::2] = words >> 8
    nbytes = (max_steps + 7) // 8
    valid = _np.unpackbits(
        byte_pairs[:, :nbytes], axis=1, count=max_steps
    ).astype(bool)
    return tokens, valid


@functools.partial(
    device.jit,
    static_argnames=(
        "eos_id",
        "max_steps",
        "num_heads",
        "provider",
        "decoder_position_zero",
        "with_shortlist",
        "flash_attention",
        "kv_dtype",
        "with_alignment",
        "argmax_method",
        "compact_output",
        "encoder_dtype",
    ),
)
def translate_batch_jit(
    params,
    indices,
    mask,
    shortlist,
    steps_cap=None,
    *,
    eos_id: int,
    max_steps: int,
    num_heads: int,
    provider: Optional[str] = None,
    decoder_position_zero: bool = True,
    with_shortlist: bool = False,
    flash_attention: bool = False,
    kv_dtype: Optional[str] = None,
    with_alignment: bool = True,
    argmax_method: str = "exact",
    compact_output: bool = False,
    encoder_dtype: Optional[str] = None,
):
    """Jitted entry; compile cache keyed on (B, T, S) bucket shapes.
    `steps_cap` is a traced scalar (no recompile across values).
    `compact_output` applies `compact_result` inside the jit (no extra
    dispatch): tokens uint16 + bit-packed valid for cheap host
    transfer; decode numerics are untouched."""
    result = translate_batch(
        params,
        indices,
        mask,
        eos_id,
        max_steps,
        num_heads,
        provider,
        shortlist if with_shortlist else None,
        decoder_position_zero,
        flash_attention,
        kv_dtype,
        steps_cap,
        with_alignment,
        argmax_method,
        encoder_dtype=encoder_dtype,
    )
    return compact_result(result) if compact_output else result
