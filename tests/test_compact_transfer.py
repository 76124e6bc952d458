"""Lossless result-transport compaction (uint16 tokens + bit-packed
valid): bit-exact after unpack, at the jit level and through the
service. A transport encoding, not a numerics knob — so equality here
is exact, not statistical."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from slimt_jax.io import load_items
from slimt_jax.io.loader import load_weights
from slimt_jax.io.synthetic import synthetic_model_bytes
from slimt_jax.models.decode import (
    compact_result,
    translate_batch_jit,
    unpack_compact,
)
from tests.helpers import TINY_TEST_CONFIG, make_package

VOCAB = 128


@pytest.fixture(scope="module")
def params():
    items = load_items(
        synthetic_model_bytes(
            config=TINY_TEST_CONFIG, vocab_size=VOCAB, emb_dim=32,
            ffn_dim=64, seed=5,
        )
    )
    return load_weights(items, TINY_TEST_CONFIG)


def test_jit_compact_roundtrip(params):
    rng = np.random.default_rng(0)
    b, t = 4, 12
    indices = jnp.asarray(rng.integers(3, 120, (b, t)).astype(np.int32))
    mask = jnp.ones((b, t), jnp.float32)
    sl = jnp.zeros((8,), jnp.int32)
    kwargs = dict(
        eos_id=0,
        max_steps=18,
        num_heads=TINY_TEST_CONFIG.num_heads,
        kv_dtype="int16",
        argmax_method="packed_fp16",
        with_alignment=False,
    )
    plain = translate_batch_jit(params, indices, mask, sl, **kwargs)
    compact = translate_batch_jit(
        params, indices, mask, sl, compact_output=True, **kwargs
    )
    assert compact.packed.dtype == jnp.uint16
    # S tokens + ceil(ceil(S/8)/2) bit-words in ONE buffer.
    assert compact.packed.shape == (b, 18 + -(-(-(-18 // 8)) // 2))
    tokens, valid = unpack_compact(np.asarray(compact.packed), 18)
    np.testing.assert_array_equal(tokens, np.asarray(plain.tokens))
    np.testing.assert_array_equal(valid, np.asarray(plain.valid))


@pytest.mark.parametrize(
    "b,s",
    [(3, 10), (1, 1), (2, 8), (1, 7), (4, 9), (2, 16), (1, 17), (5, 96)],
)
def test_compact_result_matches_manual_packing(b, s):
    """Round-trip across the bit-packing edge cases: S below/at/above
    one byte word, odd S (padding byte), single-row batches."""
    rng = np.random.default_rng(s * 31 + b)
    res_tokens = jnp.asarray(rng.integers(0, 65535, (b, s)).astype(np.int32))
    res_valid = jnp.asarray(rng.integers(0, 2, (b, s)).astype(bool))

    from slimt_jax.models.decode import GreedyResult

    res = GreedyResult(res_tokens, res_valid, jnp.zeros((b, s, 0)))
    c = compact_result(res)
    assert c.packed.dtype == jnp.uint16
    assert c.packed.shape == (b, s + (((s + 7) // 8 + 1) // 2))
    tokens, valid = unpack_compact(np.asarray(c.packed), s)
    np.testing.assert_array_equal(tokens, np.asarray(res_tokens))
    np.testing.assert_array_equal(valid, np.asarray(res_valid))


def test_service_outputs_identical_with_and_without_compaction():
    from slimt_jax.config import Config, ModelConfig
    from slimt_jax.models.model import Model
    from slimt_jax.runtime.service import Blocking

    texts = ["hello world", "the quick brown fox jumps", "a b c d e"]
    outs = []
    for compact in (False, True):
        config = dataclasses.replace(
            ModelConfig(
                encoder_layers=TINY_TEST_CONFIG.encoder_layers,
                decoder_layers=TINY_TEST_CONFIG.decoder_layers,
                num_heads=TINY_TEST_CONFIG.num_heads,
            ),
            compact_transfer=compact,
        )
        model = Model(config, make_package(with_shortlist=True))
        service = Blocking(Config(cache_size=0))
        responses = service.translate(model, texts)
        outs.append(
            [
                (
                    r.target.text,
                    [
                        r.target.word_as_range(s, w)
                        for s in range(r.target.sentence_count())
                        for w in range(r.target.word_count(s))
                    ],
                )
                for r in responses
            ]
        )
    assert outs[0] == outs[1]


def test_compaction_disabled_for_wide_vocab():
    """vocab_size > 65535 must silently fall back to plain transport."""
    from slimt_jax.config import ModelConfig
    from slimt_jax.models.model import Model

    model = Model(
        ModelConfig(
            encoder_layers=TINY_TEST_CONFIG.encoder_layers,
            decoder_layers=TINY_TEST_CONFIG.decoder_layers,
            num_heads=TINY_TEST_CONFIG.num_heads,
        ),
        make_package(),
    )
    assert model.vocab_size <= 65535  # test package is small
    model.vocab_size = 70000  # simulate a wide vocabulary
    hyps = model.forward(
        [[5, 9, 0]], need_alignment=False
    )
    assert hyps and hyps[0].target  # plain path still works
