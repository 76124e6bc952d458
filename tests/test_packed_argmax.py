"""packed_argmax_16 (models/transformer.py): the single-reduce greedy
sampler must equal argmax over the 16-bit-ROUNDED logits exactly —
including jnp.argmax's first-index tie-break — for both rounding
dtypes (float16, the service default, and bfloat16) and every shape
the decode path can produce (full 32k vocab and the shortlist
buckets). The only sanctioned numerics difference vs the exact f32
path is the 16-bit rounding itself (quantified against the reference
binary in crosscheck/serving_agreement.json)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from slimt_jax.models.transformer import packed_argmax_16, packed_argmax_bf16

DTYPES = [jnp.float16, jnp.bfloat16]


def _want(x, dtype=jnp.bfloat16):
    # ground truth: argmax over the rounded values, first index
    return jnp.argmax(x.astype(dtype), axis=-1).astype(jnp.int32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "shape", [(1, 7), (3, 96), (4, 1024), (2, 4096), (2, 32000), (1, 65536)]
)
def test_matches_rounded_argmax(shape, dtype):
    rng = np.random.default_rng(abs(hash(shape)) % 2**32)
    # wide dynamic range: mixes signs, magnitudes, and rounding-tied
    # values
    x = jnp.asarray(
        (rng.standard_normal(shape) * rng.choice([0.01, 1.0, 100.0], shape))
        .astype(np.float32)
    )
    np.testing.assert_array_equal(
        np.asarray(packed_argmax_16(x, dtype)), np.asarray(_want(x, dtype))
    )


@pytest.mark.parametrize("dtype", DTYPES)
def test_all_negative(dtype):
    rng = np.random.default_rng(5)
    x = jnp.asarray(-np.abs(rng.standard_normal((4, 513))).astype(np.float32) - 0.5)
    np.testing.assert_array_equal(
        np.asarray(packed_argmax_16(x, dtype)), np.asarray(_want(x, dtype))
    )


def test_fp16_overflow_saturates_and_orders():
    """Logits beyond float16 range saturate to ±inf; the packed key
    must still order them above every finite value (and below, for
    -inf) exactly like jnp.argmax over the fp16-rounded array."""
    x = np.array(
        [[1e5, 2e5, -1e5, 3.0], [-1e6, -2e6, 7.0, -3e6]], np.float32
    )
    np.testing.assert_array_equal(
        np.asarray(packed_argmax_16(jnp.asarray(x), jnp.float16)),
        np.asarray(_want(jnp.asarray(x), jnp.float16)),
    )


def test_tie_break_first_index_positive():
    # distinct in f32, EQUAL after bf16 rounding (bf16 step near 5.0
    # is 2^-5): the packed key's reversed column must pick the FIRST
    x = np.full((1, 8), -3.0, np.float32)
    x[0, 2] = 5.0005  # rounds to bf16(5.0)
    x[0, 5] = 5.0
    assert int(packed_argmax_bf16(jnp.asarray(x))[0]) == 2
    assert int(_want(jnp.asarray(x))[0]) == 2


def test_tie_break_first_index_negative():
    # negative ties exercise the flipped-bits half of the sortable map
    x = np.full((1, 8), -7.0, np.float32)
    x[0, 3] = -2.0
    x[0, 6] = -2.0001  # rounds to bf16(-2.0)
    assert int(packed_argmax_bf16(jnp.asarray(x))[0]) == 3


def test_max_at_column_bounds():
    # first and last column (reversed-index packing boundary)
    for col in (0, 299):
        x = np.full((2, 300), -1.0, np.float32)
        x[:, col] = 9.0
        got = np.asarray(packed_argmax_bf16(jnp.asarray(x)))
        assert (got == col).all()


def test_inf_and_large_magnitudes():
    # f32 values beyond bf16 max round to +/-inf; ordering must hold
    x = np.asarray(
        [[-3.2e38, 1.0, 3.0e38, 2.9e38, -1.0]], np.float32
    )
    # 3.0e38 and 2.9e38 both round to... (bf16 max ~3.39e38, both
    # representable-range, distinct) — argmax is column 2 either way
    assert int(packed_argmax_bf16(jnp.asarray(x))[0]) == int(_want(jnp.asarray(x))[0])


def test_inside_jit_and_vmap():
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.standard_normal((8, 257)).astype(np.float32))
    got = jax.jit(packed_argmax_bf16)(x)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(_want(x)))


# ---- packed_int: the integer-accumulator-domain argmax ----------------

from slimt_jax.models.transformer import (  # noqa: E402
    packed_int_argmax,
    packed_int_params,
)


def _want_int(acc, b_i32, shift):
    # ground truth: argmax over the shifted integer sums, first index
    v = (np.asarray(acc).astype(np.int64) + np.asarray(b_i32)) >> shift
    return np.argmax(v, axis=-1).astype(np.int32)


@pytest.mark.parametrize("width", [7, 96, 1024, 4096, 32000])
def test_packed_int_matches_shifted_argmax(width):
    emb = 256
    width_bits, shift = packed_int_params(width, emb)
    rng = np.random.default_rng(width)
    cap = emb * 127 * 127
    acc = rng.integers(-cap, cap, (4, width)).astype(np.int32)
    b = rng.integers(-cap, cap, (width,)).astype(np.int32)
    # Force exact ties after the shift in some rows
    acc[1, :] = acc[1, 0]
    acc[2, width // 2] = acc[2, 3] = acc[2].max() + 1
    got = packed_int_argmax(
        jnp.asarray(acc), jnp.asarray(b), width_bits, shift
    )
    np.testing.assert_array_equal(np.asarray(got), _want_int(acc, b, shift))


def test_packed_int_key_budget():
    """The packed key must fit int32 at the extreme accumulator bound
    for every (width, emb) the engine ships."""
    for emb in (256, 512):
        for width in (1024, 2048, 32000, 65536):
            width_bits, shift = packed_int_params(width, emb)
            bound = 2 * emb * 127 * 127 + 1
            vmax = bound >> shift
            assert (vmax << width_bits) + (1 << width_bits) - 1 < 2**31
            assert width - 1 <= (1 << width_bits) - 1


def test_output_argmax_packed_int_plumbing():
    """output_argmax(method='packed_int') equals the shifted-integer
    oracle computed from the same quantized operands."""
    from slimt_jax.ops import qmm
    from slimt_jax.models.transformer import output_argmax

    rng = np.random.default_rng(3)
    e, v, b_sz = 64, 500, 5
    w = rng.integers(-127, 128, (e, v)).astype(np.int8)
    bias = rng.standard_normal(v).astype(np.float32)
    params = {
        "emb": {"q": jnp.asarray(w.T), "scale": jnp.float32(12.0)},
        "out": {"aq": jnp.float32(9.0), "b": jnp.asarray(bias)},
    }
    x = jnp.asarray(rng.standard_normal((b_sz, e)).astype(np.float32))
    got = output_argmax(params, x, method="packed_int")

    x_q = np.asarray(qmm.quantize_activations(x, params["out"]["aq"]))
    acc = x_q.astype(np.int64) @ w.astype(np.int64)
    cap = e * 127 * 127
    b_i32 = np.clip(np.rint(bias * 9.0 * 12.0), -cap, cap).astype(np.int64)
    _, shift = packed_int_params(v, e)
    np.testing.assert_array_equal(
        np.asarray(got), _want_int(acc, b_i32, shift)
    )


def test_translate_batch_packed_int_runs():
    """argmax_method='packed_int' decodes through translate_batch on
    the declared int16 KV numerics (shape/validity sanity; agreement
    is quantified by the crosscheck serving sweep)."""
    from slimt_jax.config import ModelConfig
    from slimt_jax.io import load_items
    from slimt_jax.io.loader import load_weights, stack_layers
    from slimt_jax.io.synthetic import synthetic_model_bytes
    from slimt_jax.models.decode import translate_batch

    config = ModelConfig(encoder_layers=2, decoder_layers=2)
    items = load_items(
        synthetic_model_bytes(
            config=config, vocab_size=500, emb_dim=256, ffn_dim=512, seed=2
        )
    )
    params = stack_layers(load_weights(items, config))
    rng = np.random.default_rng(2)
    idx = jnp.asarray(rng.integers(3, 500, (4, 16)).astype(np.int32))
    mask = jnp.asarray(np.ones((4, 16), np.float32))
    out = translate_batch(
        params, idx, mask, eos_id=0, max_steps=12, num_heads=8,
        kv_dtype="int16", argmax_method="packed_int", with_alignment=False,
    )
    assert out.tokens.shape == (4, 12)
    assert np.asarray(out.tokens).max() < 500
