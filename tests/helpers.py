"""Shared test fixtures: complete synthetic model packages."""

from slimt_jax.config import ModelConfig
from slimt_jax.io.shortlist import build_synthetic_shortlist
from slimt_jax.io.synthetic import synthetic_model_bytes
from slimt_jax.models.model import Model, Package
from slimt_jax.text import spm_proto
from slimt_jax.text.synthetic_vocab import DEFAULT_WORDS, build_spm_model

TINY_TEST_CONFIG = ModelConfig(encoder_layers=2, decoder_layers=2, num_heads=4)


def make_package(
    config=TINY_TEST_CONFIG,
    emb_dim=32,
    ffn_dim=64,
    words=DEFAULT_WORDS,
    with_shortlist=False,
    seed=0,
):
    spm = build_spm_model(words)
    vocab_size = max(len(spm.pieces), 64)
    spm = build_spm_model(words, target_size=vocab_size)
    package = Package(
        model=synthetic_model_bytes(
            config=config,
            vocab_size=vocab_size,
            emb_dim=emb_dim,
            ffn_dim=ffn_dim,
            seed=seed,
        ),
        vocabulary=spm_proto.serialize_model(spm),
        shortlist=(
            build_synthetic_shortlist(vocab_size, seed=seed)
            if with_shortlist
            else None
        ),
    )
    return package


def make_model(**kwargs) -> Model:
    import dataclasses

    config = dataclasses.replace(kwargs.pop("config", TINY_TEST_CONFIG))
    return Model(config, make_package(config=config, **kwargs))
