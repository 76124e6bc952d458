"""Native checkpoint round-trip and Model integration."""

import io

import numpy as np
import pytest

from slimt_jax.config import Config, ModelConfig
from slimt_jax.io import checkpoint as ckpt
from slimt_jax.io import load_items
from slimt_jax.io.loader import load_weights, stack_layers
from slimt_jax.io.synthetic import synthetic_model_bytes
from slimt_jax.models.model import Model, Package
from slimt_jax.runtime.service import Blocking

from .helpers import TINY_TEST_CONFIG, make_package


def test_round_trip():
    config = ModelConfig(encoder_layers=2, decoder_layers=2, num_heads=4)
    blob = synthetic_model_bytes(
        config=config, vocab_size=64, emb_dim=16, ffn_dim=32
    )
    stacked = stack_layers(load_weights(load_items(blob), config))
    buffer = io.BytesIO()
    ckpt.save_native(buffer, stacked, meta={"x": 1})
    buffer.seek(0)
    loaded, meta = ckpt.load_native(buffer)
    assert meta == {"x": 1}

    import jax

    jax.tree.map(
        lambda a, b: np.testing.assert_array_equal(a, b), stacked, loaded
    )


def test_save_rejects_unstacked():
    config = ModelConfig(encoder_layers=1, decoder_layers=1, num_heads=4)
    blob = synthetic_model_bytes(
        config=config, vocab_size=64, emb_dim=16, ffn_dim=32
    )
    params = load_weights(load_items(blob), config)
    with pytest.raises(ValueError):
        ckpt.save_native(io.BytesIO(), params)


def test_is_native():
    config = ModelConfig(encoder_layers=1, decoder_layers=1, num_heads=4)
    marian = synthetic_model_bytes(
        config=config, vocab_size=64, emb_dim=16, ffn_dim=32
    )
    assert not ckpt.is_native(marian)
    native = ckpt.convert_marian(marian, config)
    assert ckpt.is_native(native)


def test_model_from_native_checkpoint_matches_marian():
    package = make_package()
    marian_model = Model(TINY_TEST_CONFIG, package)
    native_bytes = ckpt.convert_marian(
        Package._bytes(package.model), TINY_TEST_CONFIG
    )
    native_package = Package(
        model=native_bytes,
        vocabulary=package.vocabulary,
        shortlist=package.shortlist,
    )
    native_model = Model(TINY_TEST_CONFIG, native_package)
    assert native_model.vocab_size == marian_model.vocab_size

    service = Blocking(Config(cache_size=0))
    want = service.translate(marian_model, ["hello world test"])[0]
    got = service.translate(native_model, ["hello world test"])[0]
    assert got.target.text == want.target.text
