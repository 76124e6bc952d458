"""Marian .bin round-trip and loader tests (format per slimt/Io.cc)."""

import struct

import numpy as np
import pytest

from slimt_jax.config import ModelConfig
from slimt_jax.io import load_items, save_items
from slimt_jax.io.loader import load_weights, model_dims
from slimt_jax.io.marian import (
    DATA_ALIGNMENT,
    TYPE_FLOAT32,
    TYPE_INTGEMM8,
    item_from_array,
    quantize_item,
)
from slimt_jax.io.synthetic import synthetic_items, synthetic_model_bytes


def test_round_trip_simple():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    b = (np.arange(8, dtype=np.float32) - 3.0).reshape(2, 4)
    blob = save_items([item_from_array("a", a), quantize_item("bq", b)])
    items = load_items(blob)
    assert [i.name for i in items] == ["a", "bq"]
    np.testing.assert_array_equal(items[0].array, a)
    assert items[0].type_code == TYPE_FLOAT32
    assert items[1].type_code == TYPE_INTGEMM8
    # Dequantized int8 payload approximates the original.
    deq = items[1].array.astype(np.float32) / items[1].scale
    np.testing.assert_allclose(deq, b, atol=0.5 / items[1].scale)


def test_data_section_aligned():
    blob = save_items([item_from_array("x", np.ones(7, dtype=np.float32))])
    # Locate the pad field: after version, count, 1 header, name, shape.
    pos = 8 + 8 + 32 + 2 + 4
    (pad,) = struct.unpack_from("<Q", blob, pos)
    assert (pos + 8 + pad) % DATA_ALIGNMENT == 0


def test_version_check():
    blob = bytearray(save_items([item_from_array("x", np.ones(2, np.float32))]))
    struct.pack_into("<Q", blob, 0, 99)
    with pytest.raises(ValueError):
        load_items(bytes(blob))


def test_intgemm8_trailing_scale_layout():
    w = np.array([[1.0, -2.0], [3.0, -4.0]], dtype=np.float32)
    item = quantize_item("w", w)
    blob = save_items([item])
    loaded = load_items(blob)[0]
    assert loaded.scale == pytest.approx(127.0 / 4.0)
    assert loaded.array.dtype == np.int8
    assert loaded.array.shape == (2, 2)


def test_synthetic_model_loads():
    config = ModelConfig(encoder_layers=2, decoder_layers=2)
    items = load_items(
        synthetic_model_bytes(
            config=config, vocab_size=64, emb_dim=16, ffn_dim=32
        )
    )
    params = load_weights(items, config)
    assert model_dims(params) == (64, 16, 32)
    assert len(params["encoder"]) == 2
    assert len(params["decoder"]) == 2
    enc = params["encoder"][0]
    assert enc["att"]["q"]["q"].dtype == np.int8
    assert enc["att"]["q"]["b"].shape == (16,)
    assert enc["ffn"]["w1"]["q"].shape == (16, 32)
    dec = params["decoder"][0]
    assert "b" not in dec["rnn"]["w"]  # SSRU W is a bias-free linear
    assert dec["rnn"]["wf"]["q"].shape == (16, 16)
    assert params["out"]["b"].shape == (64,)


def test_loader_warns_on_unused(caplog):
    import logging

    config = ModelConfig(encoder_layers=1, decoder_layers=1)
    items = synthetic_items(config=config, vocab_size=32, emb_dim=8, ffn_dim=16)
    items.append(item_from_array("rogue_param", np.zeros(3, np.float32)))
    with caplog.at_level(logging.WARNING):
        load_weights(items, config)
    assert any("rogue_param" in r.message for r in caplog.records)


def test_loader_quantizes_f32_matrices():
    """Float32 checkpoints are quantized at load (extension over the
    reference, which only consumes pre-quantized intgemm8 models)."""
    config = ModelConfig(encoder_layers=1, decoder_layers=1)
    items = synthetic_items(config=config, vocab_size=32, emb_dim=8, ffn_dim=16)
    out = []
    for item in items:
        if item.is_quantized:
            deq = (item.array.astype(np.float32) / item.scale).reshape(item.shape)
            out.append(item_from_array(item.name, deq))
        else:
            out.append(item)
    params = load_weights(out, config)
    assert params["emb"]["q"].dtype == np.int8
