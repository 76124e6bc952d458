"""Continuous (chunked, slot-pooled) decode vs batch-at-a-time.

The engine's contract: a segment decoded through the continuous pool
produces BIT-EQUAL tokens to the same segment through translate_batch
(per-row decode math is row-independent; the per-row step cap equals
the B=1 batch cap). Exercises multi-wave admission (slots << segments),
chunk boundaries that do not divide the caps, EOS completion, and
engine reuse across calls."""

import numpy as np
import pytest

import jax.numpy as jnp

from slimt_jax.config import ModelConfig
from slimt_jax.io import load_items
from slimt_jax.io.loader import load_weights
from slimt_jax.io.synthetic import synthetic_model_bytes
from slimt_jax.models import decode as dec
from slimt_jax.models.continuous import (
    ContinuousEngine,
    chunk_decode,
    encode_segments,
    make_pool,
    unpack_chunk,
)

CONFIG = ModelConfig(encoder_layers=2, decoder_layers=2, num_heads=4)
VOCAB, EMB, FFN = 96, 32, 64
T_SLOT = 24


@pytest.fixture(scope="module")
def params():
    items = load_items(
        synthetic_model_bytes(
            config=CONFIG, vocab_size=VOCAB, emb_dim=EMB, ffn_dim=FFN, seed=11
        )
    )
    return load_weights(items, CONFIG)  # list (unrolled) decoder


def segments_fixture(n=12, seed=5):
    rng = np.random.default_rng(seed)
    return [
        rng.integers(3, VOCAB, rng.integers(4, 21)).astype(int).tolist()
        for _ in range(n)
    ]


def batch1_tokens(params, toks, eos_id, kv_dtype="int16"):
    t = T_SLOT
    indices = np.zeros((1, t), np.int32)
    mask = np.zeros((1, t), np.float32)
    indices[0, : len(toks)] = toks
    mask[0, : len(toks)] = 1.0
    cap = max(1, int(1.5 * len(toks)))
    res = dec.translate_batch(
        params,
        jnp.asarray(indices),
        jnp.asarray(mask),
        eos_id=eos_id,
        max_steps=int(1.5 * t),
        num_heads=CONFIG.num_heads,
        kv_dtype=kv_dtype,
        steps_cap=jnp.int32(cap),
        with_alignment=False,
        argmax_method="packed_fp16",
    )
    tokens = np.asarray(res.tokens)[0]
    valid = np.asarray(res.valid)[0]
    return tokens[valid].tolist()


@pytest.mark.parametrize("eos_mode", ["cap", "natural"])
def test_continuous_matches_batch(params, eos_mode):
    segments = segments_fixture()
    # "cap": an eos id the model never emits — every row truncates at
    # its per-row cap. "natural": eos = a token the model does emit,
    # so some rows complete early and free slots mid-stream.
    if eos_mode == "cap":
        eos_id = 1
    else:
        probe = batch1_tokens(params, segments[0], eos_id=1)
        eos_id = probe[len(probe) // 2]
    want = [batch1_tokens(params, s, eos_id) for s in segments]

    engine = ContinuousEngine(
        params,
        eos_id=eos_id,
        num_heads=CONFIG.num_heads,
        slots=4,
        chunk=5,  # does not divide the caps: exercises boundaries
        t_slot=T_SLOT,
        admit_bucket=4,
    )
    got = engine.translate(segments)
    assert got == want
    assert engine.stats["admitted"] == len(segments)
    assert 0.0 < engine.occupancy() <= 1.0


def test_engine_reuse_and_long_tail(params):
    """Second translate() on the same engine (pool reuse), with a
    length-skewed mix (one long straggler + many short) — the
    continuous win case: short rows cycle through slots while the
    straggler keeps decoding."""
    rng = np.random.default_rng(9)
    segments = [rng.integers(3, VOCAB, 20).astype(int).tolist()] + [
        rng.integers(3, VOCAB, 4).astype(int).tolist() for _ in range(9)
    ]
    engine = ContinuousEngine(
        params, eos_id=1, num_heads=CONFIG.num_heads,
        slots=3, chunk=4, t_slot=T_SLOT, admit_bucket=2,
    )
    want = [batch1_tokens(params, s, 1) for s in segments]
    assert engine.translate(segments) == want
    # Reuse: a fresh workload on the same pool.
    seg2 = segments_fixture(n=5, seed=77)
    want2 = [batch1_tokens(params, s, 1) for s in seg2]
    assert engine.translate(seg2) == want2


def test_chunk_transport_roundtrip(params):
    """unpack_chunk inverts chunk_decode's packed buffer."""
    pool = make_pool(params, slots=4, t_slot=T_SLOT)
    segs = segments_fixture(n=4, seed=3)
    from slimt_jax.models.continuous import admit

    a = 4
    indices = np.zeros((a, T_SLOT), np.int32)
    mask = np.zeros((a, T_SLOT), np.float32)
    for i, toks in enumerate(segs):
        indices[i, : len(toks)] = toks
        mask[i, : len(toks)] = 1.0
    kv, mask_add, cap = encode_segments(
        params, jnp.asarray(indices), jnp.asarray(mask),
        num_heads=CONFIG.num_heads,
    )
    pool = admit(pool, jnp.asarray(np.arange(4, dtype=np.int32)),
                 kv, mask_add, cap)
    pool, packed = chunk_decode(
        params, pool, chunk=7, eos_id=1, num_heads=CONFIG.num_heads,
    )
    tokens, valid, complete = unpack_chunk(np.asarray(packed), 7)
    assert tokens.shape == (4, 7)
    assert valid.shape == (4, 7)
    assert complete.shape == (4,)
    # rows with cap < 7 stop early:
    caps = np.asarray(cap)
    for b in range(4):
        assert valid[b].sum() == min(7, caps[b])


def test_overlength_segment_raises(params):
    engine = ContinuousEngine(
        params, eos_id=1, num_heads=CONFIG.num_heads,
        slots=2, chunk=4, t_slot=8, admit_bucket=2,
    )
    with pytest.raises(ValueError, match="exceeds the pool"):
        engine.translate([[5] * 9])


def test_vocab_bound_guard():
    from slimt_jax.models.continuous import ContinuousEngine as CE

    big = ModelConfig(encoder_layers=1, decoder_layers=1)
    items = load_items(
        synthetic_model_bytes(
            config=big, vocab_size=70000, emb_dim=32, ffn_dim=64, seed=1
        )
    )
    p = load_weights(items, big)
    with pytest.raises(ValueError, match="65535"):
        CE(p, eos_id=1, num_heads=big.num_heads, slots=2, chunk=2,
           t_slot=8)
