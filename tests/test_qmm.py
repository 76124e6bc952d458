"""QMM provider tests: xla_int8 and f32 against the NumPy oracle."""

import numpy as np
import pytest

import jax.numpy as jnp

from slimt_jax.ops import qmm

from . import reference_impl as ref


def _setup(m=5, k=32, n=48, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.3
    absmax = np.abs(w).max()
    bq = np.float32(127.0 / absmax)
    w_q = np.clip(np.rint(w * bq), -127, 127).astype(np.int8)
    b = rng.standard_normal(n).astype(np.float32) * 0.1
    aq = np.float32(16.0)
    return x, w_q, b, aq, bq


def test_xla_int8_matches_numpy_oracle():
    x, w_q, b, aq, bq = _setup()
    want = ref.affine({"q": w_q, "b": b, "aq": aq, "bq": bq}, x)
    got = np.asarray(qmm.affine(jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(b), aq, bq, provider="xla_int8"))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_dot_no_bias():
    x, w_q, _, aq, bq = _setup()
    got = np.asarray(qmm.dot(jnp.asarray(x), jnp.asarray(w_q), aq, bq))
    want = ref.affine({"q": w_q, "aq": aq, "bq": bq}, x)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_affine_with_select():
    x, w_q, b, aq, bq = _setup(n=64)
    ids = np.array([0, 3, 17, 33, 63], np.int32)
    full = np.asarray(qmm.affine(jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(b), aq, bq))
    sel = np.asarray(
        qmm.affine_with_select(
            jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(b), aq, bq, jnp.asarray(ids)
        )
    )
    np.testing.assert_allclose(sel, full[:, ids], atol=1e-5)


def test_3d_activations():
    x, w_q, b, aq, bq = _setup(m=6, k=32, n=16)
    x3 = x.reshape(2, 3, 32)
    flat = np.asarray(qmm.affine(jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(b), aq, bq))
    batched = np.asarray(qmm.affine(jnp.asarray(x3), jnp.asarray(w_q), jnp.asarray(b), aq, bq))
    np.testing.assert_allclose(batched.reshape(6, 16), flat, atol=1e-6)


def test_quantize_activations_rounding():
    # round-half-even like intgemm's cvtps
    x = jnp.asarray([[0.5, 1.5, 2.5, -0.5, 200.0, -200.0]], jnp.float32)
    q = np.asarray(qmm.quantize_activations(x, jnp.float32(1.0)))
    np.testing.assert_array_equal(q[0], [0, 2, 2, 0, 127, -127])


def test_provider_switch():
    qmm.set_default_provider("f32")
    assert qmm.default_provider() == "f32"
    qmm.set_default_provider("xla_int8")
    with pytest.raises(ValueError):
        qmm.set_default_provider("bogus")
