"""The declared argmax (packed_int) at the logit widths the decode loop
meets — shortlist buckets and a partial final 512-column block —
against an integer NumPy oracle of its contract, with ties and padded
columns."""

import numpy as np
import jax.numpy as jnp
import pytest

from slimt_jax.models import transformer as tfm
from slimt_jax.ops import qmm

from . import reference_impl as ref

EMB = 256
AQ, BQ = np.float32(31.7), np.float32(90.2)


def _params(w, bias):
    """Minimal tied-output params: logits = x @ w + bias."""
    return {
        "emb": {"q": jnp.asarray(w.T), "scale": jnp.float32(BQ)},
        "out": {"b": jnp.asarray(bias), "aq": jnp.float32(AQ)},
    }


def _oracle_packed_int(x, w, bias):
    """argmax over floor((acc + rint(b·aq·bq)) / 2^shift), first index
    on ties, in integer NumPy."""
    acc = ref.quantize(x, AQ).astype(np.int64) @ w.astype(np.int64)
    cap = w.shape[0] * 127 * 127
    b_i = np.clip(np.rint(bias.astype(np.float32) * (AQ * BQ)), -cap, cap)
    _, shift = tfm.packed_int_params(w.shape[1], w.shape[0])
    v = (acc + b_i.astype(np.int64)) >> shift
    return v.argmax(axis=-1)


def _case(b, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, EMB)).astype(np.float32)
    w = rng.integers(-127, 128, (EMB, n)).astype(np.int8)
    bias = (rng.standard_normal(n) * 0.1).astype(np.float32)
    return x, w, bias


def _argmax(x, w, bias, method="packed_int", provider=None):
    return np.asarray(tfm.output_argmax(
        _params(w, bias), jnp.asarray(x), provider=provider,
        projection=(jnp.asarray(w), jnp.asarray(bias)), method=method,
    ))


@pytest.mark.parametrize("width", [512, 1024, 2048, 2688])
def test_packed_int_matches_integer_oracle(width):
    x, w, bias = _case(16, width, seed=width)
    np.testing.assert_array_equal(
        _argmax(x, w, bias), _oracle_packed_int(x, w, bias)
    )


@pytest.mark.parametrize("width", [1024, 2688])
def test_packed_int_ties_prefer_first_index(width):
    """Identical columns far apart (different 512-column blocks) give
    exact ties; the first index wins, as in jnp.argmax."""
    x = np.ones((3, EMB), np.float32)
    w = np.zeros((EMB, width), np.int8)
    w[:, 3] = 5
    w[:, width - 7] = 5
    w[:, 700] = 5
    bias = np.zeros(width, np.float32)
    np.testing.assert_array_equal(_argmax(x, w, bias), [3, 3, 3])


def test_packed_int_padding_never_wins():
    """A shortlist padded to its bucket with duplicate columns, every
    real logit negative: the winner is the first copy of the best
    real column, inside the real range."""
    real = 640
    x, w, bias = _case(4, real, seed=0)
    x = np.abs(x) + 0.1
    w = -np.abs(w).clip(1, 127).astype(np.int8)
    bias = np.full(real, -0.5, np.float32)
    pad = 1024 - real
    w_pad = np.concatenate([w, np.repeat(w[:, :1], pad, axis=1)], axis=1)
    b_pad = np.concatenate([bias, np.repeat(bias[:1], pad)])
    got = _argmax(x, w_pad, b_pad)
    assert (got < real).all()
    np.testing.assert_array_equal(got, _oracle_packed_int(x, w, bias))


def test_packed_int_agrees_with_exact_argmax_at_32k():
    """At the full tied vocab the truncated comparison still picks the
    exact f32 argmax when the top-2 gap is above the quantum."""
    x, w, bias = _case(8, 32000, seed=5)
    np.testing.assert_array_equal(
        _argmax(x, w, bias), _argmax(x, w, bias, method="exact")
    )


def test_packed_int_params_cover_int32_budget():
    for width in (512, 1024, 2048, 2688, 32000, 65536):
        width_bits, shift = tfm.packed_int_params(width, EMB)
        assert (1 << width_bits) >= width
        bound = 2 * EMB * 127 * 127 + 1
        assert (bound >> shift).bit_length() + width_bits <= 31


def test_f32_provider_default_resolves_to_exact(monkeypatch):
    """With the process default provider set to "f32", packed_int with
    provider=None falls back to the exact float argmax rather than
    silently running int8 arithmetic."""
    x, w, bias = _case(4, 512, seed=3)
    want = _argmax(x, w, bias, method="exact", provider="f32")
    monkeypatch.setattr(qmm, "_DEFAULT_PROVIDER", "f32")
    np.testing.assert_array_equal(_argmax(x, w, bias), want)
