"""The XLA encoder against the NumPy oracle (tests/reference_impl.py)
at tiny and base widths and the wrap-regime shapes the service
buckets to, plus its data-parallel and stacked forms.

The int8 affines are bit-exact; LN/softmax are the same f32 formulas
in another accumulation order. Where that order flips one activation
rint() the next affine moves a whole row by one quantization step, so
each comparison bounds the error magnitude and the number of such
rows."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from slimt_jax.config import ModelConfig
from slimt_jax.io import load_items
from slimt_jax.io.loader import load_weights, stack_layers
from slimt_jax.io.synthetic import synthetic_model_bytes
from slimt_jax.models import transformer as tfm

from . import reference_impl as ref


def _build(vocab=1000, ffn=1536, emb=256, seed=0, layers=2):
    config = ModelConfig(encoder_layers=layers, decoder_layers=2)
    items = load_items(
        synthetic_model_bytes(
            config=config, vocab_size=vocab, emb_dim=emb, ffn_dim=ffn,
            seed=seed,
        )
    )
    return config, load_weights(items, config)


def _inputs(b, t, emb, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, emb)).astype(np.float32)
    mask = np.ones((b, t), np.float32)
    mask[-1, t // 2:] = 0
    return x, ref.make_additive_mask(mask)


def assert_close_to_oracle(got, want, tol=5e-2, max_flip_rows=0.05):
    scale = np.abs(want).max()
    diff = np.abs(np.asarray(got) - want)
    assert diff.max() <= tol * scale, diff.max() / scale
    rows = diff.reshape(-1, diff.shape[-1]).max(axis=-1)
    off = int((rows > 1e-4 * scale).sum())
    assert off <= max(1, max_flip_rows * rows.size), off


def _oracle_layer(layer, x, mask_add, num_heads):
    out, _ = ref.attention(layer["att"], x, x, x, mask_add, num_heads)
    return ref.ffn_block(layer, out)


@pytest.mark.parametrize("b,t", [(1, 16), (4, 32), (8, 64), (3, 48)])
def test_layer_matches_oracle(b, t):
    config, host = _build(seed=b + t)
    layer = jax.tree.map(np.asarray, host["encoder"][0])
    x, mask_add = _inputs(b, t, 256, seed=b * 100 + t)
    got = tfm.encoder_layer_forward(
        host["encoder"][0], jnp.asarray(x), jnp.asarray(mask_add),
        config.num_heads,
    )
    assert_close_to_oracle(got, _oracle_layer(layer, x, mask_add, 8))


@pytest.mark.parametrize(
    "b,t,emb,ffn",
    [
        (2, 128, 512, 2048),  # base model (emb 512 / ffn 2048) at the
        (4, 64, 512, 2048),   # wrap-regime T the service actually uses
        (2, 128, 256, 1536),  # tiny at full wrap_length T=128
        (2, 256, 256, 1536),  # the einsum path's long end
    ],
)
def test_layer_matches_oracle_base_shapes(b, t, emb, ffn):
    config, host = _build(emb=emb, ffn=ffn, seed=t + emb)
    layer = jax.tree.map(np.asarray, host["encoder"][0])
    x, mask_add = _inputs(b, t, emb, seed=emb + t)
    got = jax.jit(
        lambda l, xx, m: tfm.encoder_layer_forward(l, xx, m, 8)
    )(host["encoder"][0], jnp.asarray(x), jnp.asarray(mask_add))
    assert_close_to_oracle(got, _oracle_layer(layer, x, mask_add, 8))


def test_layer_dp_mesh_bit_exact():
    """The encoder layer jitted over an 8-device "data" mesh (the DP
    serving mesh; weights replicated) is bit-identical to the unsharded
    layer: nothing in it reduces across batch rows."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from slimt_jax.parallel import sharding as shd

    config, host = _build(seed=3)
    layer = host["encoder"][0]
    x, mask_add = _inputs(16, 32, 256, seed=11)
    fn = jax.jit(lambda ll, xx, mm: tfm.encoder_layer_forward(ll, xx, mm, 8))
    base = fn(layer, jnp.asarray(x), jnp.asarray(mask_add))
    mesh = shd.make_mesh(data=8)
    got = fn(
        jax.tree.map(
            lambda a: jax.device_put(a, NamedSharding(mesh, P())), dict(layer)
        ),
        jax.device_put(x, NamedSharding(mesh, P("data"))),
        jax.device_put(mask_add, NamedSharding(mesh, P("data"))),
    )
    np.testing.assert_array_equal(np.asarray(got), np.asarray(base))


def test_model_meshes_match_one_device():
    """Model on a replicated DP mesh and on a TP mesh produces the
    single-device tokens exactly."""
    from tests.helpers import make_package
    from slimt_jax.models.model import Model
    from slimt_jax.parallel import sharding as shd

    config = ModelConfig(encoder_layers=2, decoder_layers=2)
    pkg = make_package(config=config, emb_dim=256, ffn_dim=512)
    segments = [[5, 9, 4, 0], [7, 2, 0], [3, 8, 6, 2, 0]]
    want = [h.target for h in Model(config, pkg).forward(segments)]
    for mesh, sharding in (
        (shd.make_mesh(data=2), "replicate"),
        (shd.make_mesh(model=2), "tp"),
    ):
        model = Model(config, pkg, mesh=mesh, sharding=sharding)
        assert [h.target for h in model.forward(segments)] == want


def test_encoder_forward_list_and_stacked_match_oracle():
    """encoder_forward over list layers (unrolled) and stacked layers
    (lax.scan) agree with each other and with the oracle."""
    config, host = _build()
    rng = np.random.default_rng(7)
    b, t = 4, 32
    idx = rng.integers(3, 1000, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.float32)
    mask[2, 20:] = 0
    mask_add = ref.make_additive_mask(mask)
    x = ref.transform_embedding(
        ref.embed(jax.tree.map(np.asarray, host), idx)
    ).astype(np.float32)
    want = ref.encoder_forward(jax.tree.map(np.asarray, host), x, mask_add, 8)
    stacked = stack_layers(dict(host), decoder=False)
    got_stacked = tfm.encoder_forward(
        stacked, jnp.asarray(x), jnp.asarray(mask_add), config.num_heads
    )
    got_list = tfm.encoder_forward(
        host, jnp.asarray(x), jnp.asarray(mask_add), config.num_heads
    )
    assert_close_to_oracle(got_stacked, want)
    assert_close_to_oracle(got_list, want)
    np.testing.assert_allclose(
        np.asarray(got_stacked), np.asarray(got_list), atol=5e-5, rtol=0
    )


def test_translate_batch_tokens_match_oracle():
    """Greedy tokens of the full XLA forward equal the oracle's, for
    the exact path and the declared serving numerics."""
    from slimt_jax.models.decode import translate_batch

    config, host = _build(vocab=500, seed=1)
    hostnp = jax.tree.map(np.asarray, host)
    params = jax.device_put(stack_layers(host))
    rng = np.random.default_rng(1)
    b, t = 4, 16
    idx = rng.integers(3, 500, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.float32)
    mask[1, 9:] = 0
    idx[1, 9:] = 0
    mask_add = ref.make_additive_mask(mask)
    enc = ref.encoder_forward(
        hostnp, ref.transform_embedding(ref.embed(hostnp, idx)), mask_add, 8
    )
    want, _, _ = ref.greedy_decode(hostnp, enc, mask_add, 0, 12, 8)
    for kv, method in ((None, "exact"), ("int16", "packed_int")):
        got = translate_batch(
            params, jnp.asarray(idx), jnp.asarray(mask), eos_id=0,
            max_steps=12, num_heads=config.num_heads, kv_dtype=kv,
            argmax_method=method, with_alignment=False,
        )
        np.testing.assert_array_equal(np.asarray(got.tokens), want)
