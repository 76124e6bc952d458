"""Golden-parity tests: JAX model vs independent NumPy oracle."""

import numpy as np
import pytest

import jax.numpy as jnp

from slimt_jax.config import ModelConfig
from slimt_jax.io import load_items
from slimt_jax.io.loader import load_weights, model_dims
from slimt_jax.io.synthetic import synthetic_model_bytes
from slimt_jax.models import decode as dec
from slimt_jax.models import transformer as tfm

from . import reference_impl as ref

CONFIG = ModelConfig(encoder_layers=2, decoder_layers=2, num_heads=4)
VOCAB, EMB, FFN = 96, 32, 64


@pytest.fixture(scope="module")
def params():
    items = load_items(
        synthetic_model_bytes(
            config=CONFIG, vocab_size=VOCAB, emb_dim=EMB, ffn_dim=FFN, seed=7
        )
    )
    return load_weights(items, CONFIG)


@pytest.fixture(scope="module")
def batch(rng=np.random.default_rng(3)):
    b, t = 3, 10
    lengths = np.array([10, 7, 4])
    indices = np.zeros((b, t), np.int32)
    mask = np.zeros((b, t), np.float32)
    for i, n in enumerate(lengths):
        indices[i, :n] = rng.integers(1, VOCAB, n)
        mask[i, :n] = 1.0
    return indices, mask


def test_sinusoidal_signal_matches_reference():
    got = np.asarray(tfm.sinusoidal_signal(2, 5, EMB))
    want = ref.sinusoidal_signal(2, 5, EMB)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_embedding(params, batch):
    indices, _ = batch
    got = np.asarray(tfm.embed(params, jnp.asarray(indices)))
    want = ref.embed(params, indices)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_encoder_parity_int8(params, batch):
    indices, mask = batch
    x = ref.transform_embedding(ref.embed(params, indices))
    mask_add = ref.make_additive_mask(mask)
    want = ref.encoder_forward(params, x, mask_add, CONFIG.num_heads)

    xj = tfm.transform_embedding(tfm.embed(params, jnp.asarray(indices)))
    got = np.asarray(
        tfm.encoder_forward(
            params,
            xj,
            jnp.asarray(mask_add),
            CONFIG.num_heads,
            provider="xla_int8",
        )
    )
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_ssru_parity(params):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 1, EMB)).astype(np.float32)
    state = rng.standard_normal((3, 1, EMB)).astype(np.float32)
    rnn = params["decoder"][0]["rnn"]
    want_h, want_c = ref.ssru(rnn, state, x)
    got_h, got_c = tfm.ssru_forward(
        rnn, jnp.asarray(state), jnp.asarray(x), provider="xla_int8"
    )
    np.testing.assert_allclose(np.asarray(got_c), want_c, atol=1e-4)
    np.testing.assert_allclose(np.asarray(got_h), want_h, atol=1e-4)


def test_output_logits_shortlist_consistent(params):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, EMB)).astype(np.float32)
    shortlist = np.array([0, 1, 5, 17, 33, 64, 80, 95], dtype=np.int32)
    full = np.asarray(tfm.output_logits(params, jnp.asarray(x)))
    sel = np.asarray(
        tfm.output_logits(params, jnp.asarray(x), shortlist=jnp.asarray(shortlist))
    )
    np.testing.assert_allclose(sel, full[:, shortlist], atol=1e-5)
    want = ref.output_logits(params, x, shortlist)
    np.testing.assert_allclose(sel, want, atol=1e-4)


def test_greedy_decode_parity(params, batch):
    indices, mask = batch
    eos, max_steps = 2, 15

    want_tokens, want_valid, want_align = ref.greedy_decode(
        params,
        ref.encoder_forward(
            params,
            ref.transform_embedding(ref.embed(params, indices)),
            ref.make_additive_mask(mask),
            CONFIG.num_heads,
        ),
        ref.make_additive_mask(mask),
        eos,
        max_steps,
        CONFIG.num_heads,
    )

    got = dec.translate_batch(
        params,
        jnp.asarray(indices),
        jnp.asarray(mask),
        eos_id=eos,
        max_steps=max_steps,
        num_heads=CONFIG.num_heads,
        provider="xla_int8",
    )
    np.testing.assert_array_equal(np.asarray(got.valid), want_valid)
    got_tokens = np.asarray(got.tokens)
    np.testing.assert_array_equal(
        got_tokens[want_valid], want_tokens[want_valid]
    )
    np.testing.assert_allclose(
        np.asarray(got.alignment), want_align, atol=1e-3
    )


def test_greedy_decode_with_shortlist(params, batch):
    indices, mask = batch
    eos, max_steps = 2, 12
    shortlist = np.arange(0, VOCAB, 2, dtype=np.int32)  # even ids only

    want_tokens, want_valid, _ = ref.greedy_decode(
        params,
        ref.encoder_forward(
            params,
            ref.transform_embedding(ref.embed(params, indices)),
            ref.make_additive_mask(mask),
            CONFIG.num_heads,
        ),
        ref.make_additive_mask(mask),
        eos,
        max_steps,
        CONFIG.num_heads,
        shortlist=shortlist,
    )
    got = dec.translate_batch(
        params,
        jnp.asarray(indices),
        jnp.asarray(mask),
        eos_id=eos,
        max_steps=max_steps,
        num_heads=CONFIG.num_heads,
        provider="xla_int8",
        shortlist=jnp.asarray(shortlist),
    )
    np.testing.assert_array_equal(np.asarray(got.valid), want_valid)
    np.testing.assert_array_equal(
        np.asarray(got.tokens)[want_valid], want_tokens[want_valid]
    )
    # every emitted token must be in the shortlist
    assert np.isin(np.asarray(got.tokens)[want_valid], shortlist).all()


def test_f32_provider_close_to_int8(params, batch):
    """The f32 debug path approximates the int8 path (weight-only
    quantization error bound)."""
    indices, mask = batch
    xj = tfm.transform_embedding(tfm.embed(params, jnp.asarray(indices)))
    mask_add = jnp.asarray(ref.make_additive_mask(mask))
    a = np.asarray(
        tfm.encoder_forward(params, xj, mask_add, CONFIG.num_heads, "f32")
    )
    b = np.asarray(
        tfm.encoder_forward(params, xj, mask_add, CONFIG.num_heads, "xla_int8")
    )
    assert np.abs(a - b).mean() < 0.05


@pytest.mark.parametrize("enc_dtype", ["float16", "bfloat16"])
def test_encoder_dtype_reduced_mode(params, batch, enc_dtype):
    """encoder_dtype (reduced-precision encoder activations, a labeled
    speed opt-in — measured 92.5-92.8% token agreement on the
    adversarial crosscheck sweep, int8-class): runs, keeps its residual
    stream in the requested dtype, and stays close to the exact
    encoder in value."""
    indices, mask = batch
    x = tfm.transform_embedding(
        tfm.embed(params, jnp.asarray(indices), dtype=jnp.dtype(enc_dtype))
    )
    assert x.dtype == jnp.dtype(enc_dtype)
    mask_add = tfm.make_additive_mask(jnp.asarray(mask))
    out = tfm.encoder_forward(
        params, x, mask_add, CONFIG.num_heads,
        act_dtype=jnp.dtype(enc_dtype),
    )
    assert out.dtype == jnp.dtype(enc_dtype)
    exact = tfm.encoder_forward(
        params,
        tfm.transform_embedding(tfm.embed(params, jnp.asarray(indices))),
        mask_add,
        CONFIG.num_heads,
    )
    assert exact.dtype == jnp.float32
    # Valid (unmasked) positions stay within reduced-precision reach
    # of the exact encoder output.
    m = np.asarray(mask)[:, :, None]
    d = np.abs(np.asarray(out, np.float32) - np.asarray(exact)) * m
    scale = np.abs(np.asarray(exact)).max()
    assert d.max() <= 0.05 * scale, (d.max(), scale)


def test_encoder_dtype_none_is_exact(params, batch):
    """encoder_dtype=None must stay bit-identical to the historical
    f32 path (the oracle-parity tests above pin the semantics; this
    pins the decode-level plumbing default)."""
    indices, mask = batch
    r_default = dec.translate_batch(
        params, jnp.asarray(indices), jnp.asarray(mask),
        eos_id=2, max_steps=15, num_heads=CONFIG.num_heads,
    )
    r_none = dec.translate_batch(
        params, jnp.asarray(indices), jnp.asarray(mask),
        eos_id=2, max_steps=15, num_heads=CONFIG.num_heads,
        encoder_dtype=None,
    )
    np.testing.assert_array_equal(
        np.asarray(r_default.tokens), np.asarray(r_none.tokens)
    )
