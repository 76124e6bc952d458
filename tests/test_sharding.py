"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from slimt_jax.config import ModelConfig
from slimt_jax.io import load_items
from slimt_jax.io.loader import load_weights
from slimt_jax.io.synthetic import synthetic_model_bytes
from slimt_jax.models.decode import translate_batch
from slimt_jax.parallel import sharding as shd

CONFIG = ModelConfig(encoder_layers=2, decoder_layers=2, num_heads=4)
VOCAB, EMB, FFN = 128, 32, 64


@pytest.fixture(scope="module")
def params():
    items = load_items(
        synthetic_model_bytes(
            config=CONFIG, vocab_size=VOCAB, emb_dim=EMB, ffn_dim=FFN, seed=9
        )
    )
    return load_weights(items, CONFIG)


def _batch(b, t, seed=2):
    rng = np.random.default_rng(seed)
    indices = rng.integers(3, VOCAB, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.float32)
    mask[b // 2 :, -3:] = 0.0
    return indices, mask


def _run(params, indices, mask):
    return translate_batch(
        params,
        jnp.asarray(indices),
        jnp.asarray(mask),
        eos_id=1,
        max_steps=6,
        num_heads=CONFIG.num_heads,
        provider="xla_int8",
    )


def test_mesh_creation():
    mesh = shd.make_mesh(data=4, model=2)
    assert mesh.shape == {"data": 4, "model": 2, "seq": 1}
    mesh = shd.make_mesh(data=2, seq=4)
    assert mesh.shape == {"data": 2, "model": 1, "seq": 4}


def test_pspec_tree_matches_params(params):
    specs = shd.weight_pspecs(params)
    jax.tree.map(
        lambda a, s: None, params, specs,
        is_leaf=lambda x: isinstance(x, P),
    )  # raises on structure mismatch


@pytest.mark.parametrize("data,model", [(8, 1), (4, 2), (2, 4)])
def test_sharded_translate_matches_single_device(params, data, model):
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    indices, mask = _batch(b=8, t=12)
    want = _run(params, indices, mask)

    mesh = shd.make_mesh(data=data, model=model)
    sharded = shd.shard_params(params, mesh)
    bspec = NamedSharding(mesh, shd.batch_pspec())
    got = _run(
        params=sharded,
        indices=jax.device_put(jnp.asarray(indices), bspec),
        mask=jax.device_put(jnp.asarray(mask), bspec),
    )
    np.testing.assert_array_equal(np.asarray(got.valid), np.asarray(want.valid))
    np.testing.assert_array_equal(
        np.asarray(got.tokens), np.asarray(want.tokens)
    )


@pytest.mark.parametrize("data,seq", [(1, 8), (2, 4)])
def test_sequence_sharded_translate_matches_single_device(params, data, seq):
    """SP: the [B, T] input sharded along tokens — encoder activations
    and cross-attention KV caches inherit the T sharding, XLA/GSPMD
    inserts the attention all-gathers. Long-context analog of the
    reference's hard wrap (slimt/TextProcessor.cc:123-157)."""
    assert len(jax.devices()) >= 8
    indices, mask = _batch(b=4, t=16)
    want = _run(params, indices, mask)

    mesh = shd.make_mesh(data=data, seq=seq)
    rep = shd.replicate_params(params, mesh)
    bspec = NamedSharding(mesh, shd.batch_pspec(seq=True))
    got = _run(
        params=rep,
        indices=jax.device_put(jnp.asarray(indices), bspec),
        mask=jax.device_put(jnp.asarray(mask), bspec),
    )
    np.testing.assert_array_equal(np.asarray(got.valid), np.asarray(want.valid))
    np.testing.assert_array_equal(
        np.asarray(got.tokens), np.asarray(want.tokens)
    )


def test_replicated_params(params):
    mesh = shd.make_mesh(data=8, model=1)
    rep = shd.replicate_params(params, mesh)
    leaf = rep["emb"]["q"]
    assert leaf.sharding.is_fully_replicated


def test_sharded_int8_kv_matches_single_device(params):
    """The per-row int8 KV cache's [B, T] scale arrays must shard
    consistently with the [B, T, E] caches under DP×SP (GSPMD infers
    both from the batch input sharding)."""
    assert len(jax.devices()) >= 8
    indices, mask = _batch(b=4, t=16)

    def run(p, i, m):
        return translate_batch(
            p, jnp.asarray(i), jnp.asarray(m),
            eos_id=1, max_steps=6, num_heads=CONFIG.num_heads,
            provider="xla_int8", kv_dtype="int8",
        )

    want = run(params, indices, mask)
    mesh = shd.make_mesh(data=2, seq=4)
    rep = shd.replicate_params(params, mesh)
    bspec = NamedSharding(mesh, shd.batch_pspec(seq=True))
    got = run(
        rep,
        jax.device_put(jnp.asarray(indices), bspec),
        jax.device_put(jnp.asarray(mask), bspec),
    )
    np.testing.assert_array_equal(
        np.asarray(got.tokens), np.asarray(want.tokens)
    )


def test_flagship_shapes_dp_tp_exact_match():
    """The FLAGSHIP tiny11 shapes (32k vocab, emb 256, 6 enc / 2 dec)
    under DP×TP: the vocab-sharded tied embedding + logit projection at
    real shapes is the claim the toy-shape tests above skip. Every
    matmul in the int8 path accumulates in i32 (associative), so the
    TP partial-sum collective must be BIT-exact vs one device — for
    the exact numerics AND the shipped serving config (fp16 KV +
    packed_bf16 argmax). Mirrors the dryrun_multichip flagship leg
    (__graft_entry__.py)."""
    assert len(jax.devices()) >= 8
    config = ModelConfig(encoder_layers=6, decoder_layers=2, num_heads=8)
    items = load_items(
        synthetic_model_bytes(
            config=config, vocab_size=32000, emb_dim=256, ffn_dim=1536,
            seed=3,
        )
    )
    flag = load_weights(items, config)
    rng = np.random.default_rng(4)
    indices = rng.integers(3, 32000, (8, 16)).astype(np.int32)
    mask = np.ones((8, 16), np.float32)
    mask[4:, -3:] = 0.0

    mesh = shd.make_mesh(data=4, model=2)
    sharded = shd.shard_params(flag, mesh)
    bspec = NamedSharding(mesh, shd.batch_pspec())

    for options in (
        {},  # exact reference numerics
        {"kv_dtype": "float16", "argmax_method": "packed_bf16",
         "with_alignment": False},  # the shipped serving config
    ):
        def run(p, i, m):
            return translate_batch(
                p, jnp.asarray(i), jnp.asarray(m),
                eos_id=1, max_steps=6, num_heads=config.num_heads,
                provider="xla_int8", **options,
            )

        want = run(flag, indices, mask)
        got = run(
            sharded,
            jax.device_put(jnp.asarray(indices), bspec),
            jax.device_put(jnp.asarray(mask), bspec),
        )
        np.testing.assert_array_equal(
            np.asarray(got.valid), np.asarray(want.valid)
        )
        np.testing.assert_array_equal(
            np.asarray(got.tokens), np.asarray(want.tokens)
        )
