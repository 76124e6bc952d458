"""Synthetic Bergamot-style model generation.

Produces random-weight models in the exact marian v1 binary layout and
naming scheme the loader (and the reference parser, slimt/Io.cc +
slimt/Modules.cc:336-406) expects. Used by the test-suite and benchmarks
because real Bergamot checkpoints cannot be downloaded in this
environment; a real en-de tiny11 .bin drops in with no code changes.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from slimt_jax.config import ModelConfig
from slimt_jax.io.marian import (
    Item,
    item_from_array,
    quantize_item,
    save_items,
)


def _rng_matrix(rng: np.random.Generator, rows: int, cols: int) -> np.ndarray:
    # Xavier-ish scale keeps activations in a sane range through layers.
    scale = 1.0 / np.sqrt(rows)
    return rng.standard_normal((rows, cols)).astype(np.float32) * scale


def synthetic_items(
    config: Optional[ModelConfig] = None,
    vocab_size: int = 256,
    emb_dim: int = 64,
    ffn_dim: int = 128,
    seed: int = 0,
    activation_quant: float = 20.0,
) -> List[Item]:
    """Random model items with the reference's parameter names.

    `activation_quant` is used for every `*_QuantMultA`: real models
    ship calibrated per-tensor activation multipliers; a moderate
    constant keeps int8 activation quantization error small for the
    random weights used in tests.
    """
    config = config or ModelConfig()
    rng = np.random.default_rng(seed)
    items: List[Item] = []

    def affine(prefix: str, w: str, b: str, rows: int, cols: int):
        items.append(quantize_item(f"{prefix}_{w}", _rng_matrix(rng, rows, cols)))
        items.append(
            item_from_array(
                f"{prefix}_{b}",
                (rng.standard_normal((1, cols)) * 0.05).astype(np.float32),
            )
        )
        items.append(
            item_from_array(
                f"{prefix}_{w}_QuantMultA",
                np.array([[activation_quant]], dtype=np.float32),
            )
        )

    def layer_norm(prefix: str, dim: int):
        items.append(
            item_from_array(
                f"{prefix}_ln_scale",
                (1.0 + 0.05 * rng.standard_normal((1, dim))).astype(np.float32),
            )
        )
        items.append(
            item_from_array(
                f"{prefix}_ln_bias",
                (0.05 * rng.standard_normal((1, dim))).astype(np.float32),
            )
        )

    def attention(prefix: str):
        for key in ("q", "k", "v", "o"):
            affine(prefix, f"W{key}", f"b{key}", emb_dim, emb_dim)
        layer_norm(f"{prefix}_Wo", emb_dim)

    def ffn(prefix: str):
        affine(prefix, "ffn_W1", "ffn_b1", emb_dim, ffn_dim)
        affine(prefix, "ffn_W2", "ffn_b2", ffn_dim, emb_dim)
        layer_norm(f"{prefix}_ffn_ffn", emb_dim)

    # Tied embedding [V, E] stored as intgemm8 (slimt/Io.cc:182-224).
    items.append(
        quantize_item("Wemb", _rng_matrix(rng, vocab_size, emb_dim) * 4.0)
    )
    items.append(
        item_from_array(
            "none_QuantMultA", np.array([[activation_quant]], dtype=np.float32)
        )
    )
    items.append(
        item_from_array(
            "decoder_ff_logit_out_b",
            (0.05 * rng.standard_normal((1, vocab_size))).astype(np.float32),
        )
    )

    for i in range(1, config.encoder_layers + 1):
        attention(f"encoder_l{i}_self")
        ffn(f"encoder_l{i}")

    for i in range(1, config.decoder_layers + 1):
        prefix = f"decoder_l{i}"
        attention(f"{prefix}_context")
        # SSRU: W (linear, no bias) + Wf/bf + post-LN named "rnn_ffn"
        # (slimt/Modules.cc:385-396).
        items.append(
            quantize_item(f"{prefix}_rnn_W", _rng_matrix(rng, emb_dim, emb_dim))
        )
        items.append(
            item_from_array(
                f"{prefix}_rnn_W_QuantMultA",
                np.array([[activation_quant]], dtype=np.float32),
            )
        )
        items.append(
            quantize_item(f"{prefix}_rnn_Wf", _rng_matrix(rng, emb_dim, emb_dim))
        )
        items.append(
            item_from_array(
                f"{prefix}_rnn_bf",
                (0.05 * rng.standard_normal((1, emb_dim))).astype(np.float32),
            )
        )
        items.append(
            item_from_array(
                f"{prefix}_rnn_Wf_QuantMultA",
                np.array([[activation_quant]], dtype=np.float32),
            )
        )
        layer_norm(f"{prefix}_rnn_ffn", emb_dim)
        ffn(prefix)

    return items


def synthetic_model_bytes(**kwargs) -> bytes:
    """A complete synthetic marian .bin blob."""
    return save_items(synthetic_items(**kwargs))
