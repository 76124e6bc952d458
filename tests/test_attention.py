"""Query-chunked attention vs the einsum SDPA reference."""

import numpy as np
import pytest

import jax.numpy as jnp

from slimt_jax.models import transformer as tfm
from slimt_jax.ops.attention import chunked_attention


def _case(b=2, h=4, t=96, d=32, seed=0, pad=5):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, t, d)).astype(np.float32)
    k = rng.standard_normal((b, h, t, d)).astype(np.float32)
    v = rng.standard_normal((b, h, t, d)).astype(np.float32)
    mask = np.ones((b, t), np.float32)
    if pad:
        mask[:, -pad:] = 0.0
    mask_add = ((1.0 - mask) * -99999999.0)[:, None, None, :].astype(
        np.float32
    )
    return map(jnp.asarray, (q, k, v, mask_add))


def test_matches_sdpa():
    q, k, v, mask_add = _case()
    want, _ = tfm.scaled_dot_product_attention(q, k, v, mask_add)
    got = chunked_attention(q, k, v, mask_add)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), atol=2e-5, rtol=1e-5
    )


def test_long_sequence_blocks():
    # T > BLOCK_Q exercises the map over query blocks
    q, k, v, mask_add = _case(b=1, h=2, t=512, d=32, pad=17)
    want, _ = tfm.scaled_dot_product_attention(q, k, v, mask_add)
    got = chunked_attention(q, k, v, mask_add)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), atol=2e-5, rtol=1e-5
    )


def test_uneven_block():
    q, k, v, mask_add = _case(b=1, h=1, t=200, d=32, pad=0)
    want, _ = tfm.scaled_dot_product_attention(q, k, v, mask_add)
    got = chunked_attention(q, k, v, mask_add)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), atol=2e-5, rtol=1e-5
    )


def test_encoder_with_flash_matches(params=None):
    from slimt_jax.config import ModelConfig
    from slimt_jax.io import load_items
    from slimt_jax.io.loader import load_weights
    from slimt_jax.io.synthetic import synthetic_model_bytes

    config = ModelConfig(encoder_layers=2, decoder_layers=1, num_heads=4)
    items = load_items(
        synthetic_model_bytes(
            config=config, vocab_size=64, emb_dim=32, ffn_dim=48
        )
    )
    params = load_weights(items, config)
    rng = np.random.default_rng(1)
    indices = rng.integers(1, 64, (2, 20)).astype(np.int32)
    mask = np.ones((2, 20), np.float32)
    mask[1, -4:] = 0.0
    x = tfm.transform_embedding(tfm.embed(params, jnp.asarray(indices)))
    mask_add = jnp.asarray(tfm.make_additive_mask(jnp.asarray(mask)))
    want = tfm.encoder_forward(params, x, mask_add, 4, "xla_int8")
    got = tfm.encoder_forward(
        params, x, mask_add, 4, "xla_int8", flash=True
    )
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), atol=1e-4, rtol=1e-4
    )
