"""Robustness tests mirroring the reference's edge-case suite
(test_ende_borked_base.py: config/file mismatch tolerance; input
validation fail-fast per SURVEY.md §5)."""

import numpy as np
import pytest

from slimt_jax.config import Config, ModelConfig
from slimt_jax.io import load_items, save_items
from slimt_jax.io.loader import MissingParameter, load_weights
from slimt_jax.io.shortlist import ShortlistGenerator, write_shortlist
from slimt_jax.io.synthetic import synthetic_model_bytes
from slimt_jax.models.model import Model, Package
from slimt_jax.runtime.service import Blocking

from .helpers import TINY_TEST_CONFIG, make_package


def test_fewer_decoder_layers_than_file():
    """A 2-decoder-layer file loaded with decoder_layers=1 works
    (extra items only warn), like the reference's borked-base test."""
    file_config = ModelConfig(encoder_layers=2, decoder_layers=2, num_heads=4)
    blob = synthetic_model_bytes(
        config=file_config, vocab_size=64, emb_dim=16, ffn_dim=32
    )
    borked = ModelConfig(encoder_layers=2, decoder_layers=1, num_heads=4)
    params = load_weights(load_items(blob), borked)
    assert len(params["decoder"]) == 1


def test_more_layers_than_file_fails():
    file_config = ModelConfig(encoder_layers=1, decoder_layers=1, num_heads=4)
    blob = synthetic_model_bytes(
        config=file_config, vocab_size=64, emb_dim=16, ffn_dim=32
    )
    wants_more = ModelConfig(encoder_layers=3, decoder_layers=1, num_heads=4)
    with pytest.raises(MissingParameter):
        load_weights(load_items(blob), wants_more)


def test_truncated_model_file_fails():
    blob = synthetic_model_bytes(
        config=ModelConfig(encoder_layers=1, decoder_layers=1),
        vocab_size=64, emb_dim=16, ffn_dim=32,
    )
    with pytest.raises(Exception):
        load_items(blob[: len(blob) // 2])


def test_shortlist_bad_magic_fails():
    blob = write_shortlist([0, 1], [5], frequent=1, best=1)
    corrupted = b"\x00" * 8 + blob[8:]
    with pytest.raises(ValueError, match="magic"):
        ShortlistGenerator(corrupted, vocab_size=64)


def test_shortlist_bad_checksum_fails():
    blob = bytearray(write_shortlist([0, 1], [5], frequent=1, best=1))
    # Corrupt a checksum-covered byte (the hash folds whole u64 words
    # from offset 16; a trailing 4-byte u32 tail is uncovered, as in
    # the reference's hash_bytes over u64s).
    blob[20] ^= 0xFF
    with pytest.raises(ValueError, match="checksum"):
        ShortlistGenerator(bytes(blob), vocab_size=64)


def test_shortlist_out_of_bounds_fails():
    blob = write_shortlist([0, 1], [500], frequent=1, best=1)
    with pytest.raises(ValueError, match="bounds"):
        ShortlistGenerator(blob, vocab_size=64)


def test_service_with_borked_model_translates():
    package = make_package()
    borked = ModelConfig(
        encoder_layers=TINY_TEST_CONFIG.encoder_layers,
        decoder_layers=1,
        num_heads=TINY_TEST_CONFIG.num_heads,
    )
    model = Model(borked, package)
    service = Blocking(Config(cache_size=0))
    response = service.translate(model, ["hello world"])[0]
    assert response.target.sentence_count() == 1
