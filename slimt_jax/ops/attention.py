"""Query-chunked encoder self-attention for long inputs.

The reference sidesteps long sequences entirely — inputs are hard-
wrapped at 128 tokens and SDPA materializes full [B,H,T,T] score
matrices via CBLAS sgemm (slimt/Modules.cc:24-86, SURVEY §5 "long
context"). `chunked_attention` lifts that constraint for the encoder:
queries are processed in blocks of `BLOCK_Q` under `lax.map`, so the
live score buffer is [B,H,BLOCK_Q,T] instead of [B,H,T,T] — O(T·block)
memory, plain XLA ops, no custom kernel.

Used for encoder self-attention only — decoder cross-attention needs
the attention weights for alignments (slimt/Model.cc:84-108) and has
query length 1 anyway.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from slimt_jax import device

BLOCK_Q = 128


def chunked_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    mask_add: jax.Array,
) -> jax.Array:
    """q,k,v: [B,H,T,D] f32; mask_add: [B,1,1,Tk] additive →
    out [B,H,Tq,D] f32. Same math as the einsum SDPA, one query block
    at a time; T not a multiple of BLOCK_Q is padded (padded query
    rows are computed and dropped)."""
    precision = device.F32_DOT_PRECISION
    b, h, t_q, d = q.shape
    scale = 1.0 / math.sqrt(d)
    block = min(BLOCK_Q, t_q)
    n_blocks = -(-t_q // block)
    pad = n_blocks * block - t_q
    if pad:
        q = jnp.pad(q, ((0, 0), (0, 0), (0, pad), (0, 0)))
    # [N, B, H, block, D]: lax.map walks the leading block axis.
    blocks = q.reshape(b, h, n_blocks, block, d).transpose(2, 0, 1, 3, 4)

    def one_block(qb):
        scores = jnp.einsum(
            "bhqd,bhkd->bhqk", qb, k,
            preferred_element_type=jnp.float32, precision=precision,
        ) * scale + mask_add
        attn = jax.nn.softmax(scores, axis=-1)
        return jnp.einsum(
            "bhqk,bhkd->bhqd", attn, v,
            preferred_element_type=jnp.float32, precision=precision,
        )

    out = jax.lax.map(one_block, blocks)  # [N, B, H, block, D]
    out = out.transpose(1, 2, 0, 3, 4).reshape(b, h, n_blocks * block, d)
    return out[:, :, :t_q, :]
