"""The XLA greedy decode against the NumPy oracle's decode loop
(tests/reference_impl.greedy_decode): batch sizes down to the B=1
latency shape, full vocab and shortlist, the declared serving cache,
and every reduced-precision cross-attention cache against f32."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from slimt_jax.config import ModelConfig
from slimt_jax.io import load_items
from slimt_jax.io.loader import load_weights, stack_layers
from slimt_jax.io.synthetic import synthetic_model_bytes
from slimt_jax.models import decode as dec
from slimt_jax.models import transformer as tfm

from . import reference_impl as ref

CONFIG = ModelConfig(encoder_layers=2, decoder_layers=2, num_heads=4)
VOCAB = 4736  # not a power of two
EMB = 32


@pytest.fixture(scope="module")
def host():
    blob = synthetic_model_bytes(
        config=CONFIG, vocab_size=VOCAB, emb_dim=EMB, ffn_dim=64, seed=3
    )
    return load_weights(load_items(blob), CONFIG)


def _batch(seed, b=5, t=9, vocab=VOCAB):
    rng = np.random.default_rng(seed)
    indices = rng.integers(3, vocab, size=(b, t)).astype(np.int32)
    lengths = rng.integers(3, t + 1, size=b)
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    indices[mask == 0] = 0
    return indices, mask


def _oracle(host, indices, mask, num_heads, max_steps=12, shortlist=None):
    hostnp = jax.tree.map(np.asarray, host)
    mask_add = ref.make_additive_mask(mask)
    x = ref.transform_embedding(ref.embed(hostnp, indices))
    enc = ref.encoder_forward(hostnp, x, mask_add, num_heads)
    tokens, valid, _ = ref.greedy_decode(
        hostnp, enc, mask_add, 2, max_steps, num_heads, shortlist=shortlist
    )
    return tokens, valid


def _run(host, indices, mask, num_heads=4, shortlist=None, **kw):
    return dec.translate_batch(
        stack_layers(host), jnp.asarray(indices), jnp.asarray(mask),
        eos_id=2, max_steps=12, num_heads=num_heads,
        shortlist=None if shortlist is None else jnp.asarray(shortlist),
        **kw,
    )


@pytest.mark.parametrize("b", [1, 3, 33])
def test_decode_batch_sizes_match_oracle(host, b):
    """Exact numerics (f32 cache, f32 argmax) reproduce the oracle's
    tokens and valid mask; padding rows leak nothing."""
    indices, mask = _batch(seed=4, b=b)
    want, valid = _oracle(host, indices, mask, 4)
    got = _run(host, indices, mask, kv_dtype=None, argmax_method="exact")
    np.testing.assert_array_equal(np.asarray(got.tokens), want)
    np.testing.assert_array_equal(np.asarray(got.valid), valid)
    assert np.isfinite(np.asarray(got.alignment)).all()


def test_decode_shortlist_matches_oracle(host):
    indices, mask = _batch(seed=2)
    shortlist = np.arange(0, VOCAB, 5, dtype=np.int32)
    want, _ = _oracle(host, indices, mask, 4, shortlist=shortlist)
    got = _run(host, indices, mask, shortlist=shortlist, kv_dtype=None,
               argmax_method="exact")
    np.testing.assert_array_equal(np.asarray(got.tokens), want)


def test_decode_full_vocab_declared_config_matches_oracle(host):
    """The declared serving numerics (int16 per-row cache, packed_int
    argmax, no alignment) against the f32 oracle over the full tied
    vocab."""
    indices, mask = _batch(seed=1)
    want, _ = _oracle(host, indices, mask, 4)
    got = _run(host, indices, mask, kv_dtype="int16",
               argmax_method="packed_int", with_alignment=False)
    agree = (np.asarray(got.tokens) == want).mean()
    assert agree >= 0.95, f"token agreement {agree}"


def test_decode_int16_cache_matches_oracle(host):
    indices, mask = _batch(seed=6)
    want, _ = _oracle(host, indices, mask, 4)
    got = _run(host, indices, mask, kv_dtype="int16", argmax_method="exact")
    agree = (np.asarray(got.tokens) == want).mean()
    assert agree >= 0.95, f"token agreement {agree}"


def test_decode_base_like_shapes_match_oracle():
    """8 heads, emb 64, ffn 128 (base-model ratios scaled down)."""
    config = ModelConfig(encoder_layers=2, decoder_layers=2, num_heads=8)
    host = load_weights(
        load_items(synthetic_model_bytes(
            config=config, vocab_size=512, emb_dim=64, ffn_dim=128, seed=7
        )),
        config,
    )
    indices, mask = _batch(seed=0, b=4, t=8, vocab=512)
    want, _ = _oracle(host, indices, mask, 8)
    got = _run(host, indices, mask, num_heads=8, kv_dtype=None,
               argmax_method="exact")
    np.testing.assert_array_equal(np.asarray(got.tokens), want)


def _cross_attention_case(b, t, emb=64, seed=0):
    rng = np.random.default_rng(seed)
    yq = rng.standard_normal((b, 1, emb)).astype(np.float32)
    k = rng.standard_normal((b, t, emb)).astype(np.float32)
    v = rng.standard_normal((b, t, emb)).astype(np.float32)
    mask = np.ones((b, t), np.float32)
    mask[0, t // 2:] = 0
    return yq, k, v, ref.make_additive_mask(mask)


def _oracle_cross_attention(yq, k, v, mask_add, heads):
    q, kk, vv = (ref.split_heads(a, heads) for a in (yq, k, v))
    scores = np.einsum("bhqd,bhkd->bhqk", q, kk) / np.sqrt(q.shape[-1])
    attn = ref.softmax(scores + mask_add)
    return ref.join_heads(np.einsum("bhqk,bhkd->bhqd", attn, vv)), attn


def _joined_cache(k, v, kv_dtype):
    dtype = kv_dtype if kv_dtype in ("k8v16", "k16v8") else jnp.dtype(kv_dtype)
    return tfm.quantize_cross_kv(jnp.asarray(k), jnp.asarray(v), dtype)


@pytest.mark.parametrize("b,t", [(1, 16), (3, 48), (33, 64)])
def test_joined_int16_attention_matches_oracle(b, t):
    """Decode-step cross-attention over the declared int16 per-row
    cache against f32 attention: the cache's rowmax/65534 error."""
    yq, k, v, mask_add = _cross_attention_case(b, t, seed=b + t)
    want, want_attn = _oracle_cross_attention(yq, k, v, mask_add, 4)
    cache = _joined_cache(k, v, "int16")
    out, attn = tfm._decode_attention_joined(
        jnp.asarray(yq), cache, jnp.asarray(mask_add), 4
    )
    np.testing.assert_allclose(np.asarray(out), want, atol=2e-3)
    np.testing.assert_allclose(np.asarray(attn), want_attn, atol=2e-3)


@pytest.mark.parametrize(
    "kv_dtype,atol",
    [("int8", 0.25), ("k8v16", 0.25), ("k16v8", 0.1),
     ("float16", 1e-2), ("bfloat16", 0.1)],
)
def test_reduced_caches_track_f32_attention(kv_dtype, atol):
    """Every reduced-precision cache the config accepts stays within
    its dtype's error class of f32 attention."""
    yq, k, v, mask_add = _cross_attention_case(4, 32, seed=9)
    want, _ = _oracle_cross_attention(yq, k, v, mask_add, 4)
    cache = _joined_cache(k, v, kv_dtype)
    out, attn = tfm._decode_attention_joined(
        jnp.asarray(yq), cache, jnp.asarray(mask_add), 4
    )
    np.testing.assert_allclose(np.asarray(out), want, atol=atol)
    np.testing.assert_allclose(np.asarray(attn).sum(-1), 1.0, atol=1e-5)
