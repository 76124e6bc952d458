"""Build the model weight pytree from marian .bin items.

Mirrors the reference's parameter registration and load
(slimt/Transformer.cc:185-232, slimt/Modules.cc:336-406) but produces a
nested dict of numpy arrays ready to be device_put as JAX arrays:

    params = {
      "emb":  {"q": int8 [V,E], "scale": f32[]},        # tied embedding
      "out":  {"aq": f32[], "b": f32 [V]},              # logit projection
      "encoder": [per-layer {
          "att": {"q"|"k"|"v"|"o": affine, "ln": ln},
          "ffn": {"w1": affine, "w2": affine, "ln": ln}}],
      "decoder": [per-layer {
          "rnn": {"w": linear, "wf": affine, "ln": ln},
          "att": {...}, "ffn": {...}}],
    }
    affine = {"q": int8 [in,out], "bq": f32[], "aq": f32[], "b": f32 [out]}
    linear = affine without "b"
    ln     = {"scale": f32 [E], "bias": f32 [E]}

Quantization convention (slimt/QMM.hh:48-63, qmm/Gemmology.inl.cc):
`q = round(f32 * mult)`, `f32 = q / mult`; "aq" is the per-tensor
activation multiplier (`*_QuantMultA` items), "bq" the weight multiplier
stored as the trailing f32 of each intgemm8 payload.

The output projection reuses the transposed int8 embedding, with
`none_QuantMultA` as its activation multiplier (the reference's naming
quirk — slimt/Transformer.cc:104-117) and `decoder_ff_logit_out_b` bias.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from slimt_jax.config import ModelConfig
from slimt_jax.io.marian import Item, TYPE_FLOAT32, TYPE_INTGEMM8

log = logging.getLogger(__name__)


class MissingParameter(KeyError):
    pass


def _quantize(weights: np.ndarray) -> tuple:
    absmax = float(np.max(np.abs(weights))) or 1.0
    mult = 127.0 / absmax
    q = np.clip(np.rint(weights * mult), -127, 127).astype(np.int8)
    return q, np.float32(mult)


class _Items:
    def __init__(self, items: Sequence[Item]):
        self.by_name: Dict[str, Item] = {item.name: item for item in items}
        self.used = set()

    def take(self, name: str) -> Item:
        if name not in self.by_name:
            raise MissingParameter(name)
        self.used.add(name)
        return self.by_name[name]

    def matrix(self, name: str) -> dict:
        """int8 weight matrix + multiplier; quantizes f32 matrices."""
        item = self.take(name)
        if item.is_quantized:
            return {"q": item.array, "bq": np.float32(item.scale)}
        q, mult = _quantize(np.asarray(item.array, dtype=np.float32))
        return {"q": q, "bq": mult}

    def f32(self, name: str) -> np.ndarray:
        item = self.take(name)
        if item.is_quantized:
            # e.g. Wemb_QuantMultA is stored as a useless ig8 blob
            # (slimt/Io.cc:166-181); treat as absent.
            raise MissingParameter(name)
        return np.asarray(item.array, dtype=np.float32)

    def scalar(self, name: str) -> np.float32:
        return np.float32(self.f32(name).reshape(-1)[0])

    def vector(self, name: str) -> np.ndarray:
        return self.f32(name).reshape(-1)

    def unused(self) -> List[str]:
        return [n for n in self.by_name if n not in self.used]


def _affine(items: _Items, w: str, b: str, quant: str) -> dict:
    out = items.matrix(w)
    out["b"] = items.vector(b)
    out["aq"] = items.scalar(quant)
    return out


def _linear(items: _Items, w: str, quant: str) -> dict:
    out = items.matrix(w)
    out["aq"] = items.scalar(quant)
    return out


def _ln(items: _Items, prefix: str) -> dict:
    return {
        "scale": items.vector(prefix + "_ln_scale"),
        "bias": items.vector(prefix + "_ln_bias"),
    }


def _attention(items: _Items, prefix: str) -> dict:
    # prefix like "encoder_l1_self" or "decoder_l1_context"
    # (slimt/Modules.cc:336-372).
    att = {
        key: _affine(
            items,
            f"{prefix}_W{key}",
            f"{prefix}_b{key}",
            f"{prefix}_W{key}_QuantMultA",
        )
        for key in ("q", "k", "v", "o")
    }
    att["ln"] = _ln(items, f"{prefix}_Wo")
    return att


def _ffn(items: _Items, prefix: str) -> dict:
    # prefix like "encoder_l1" (slimt/Modules.cc:374-383).
    return {
        "w1": _affine(
            items, f"{prefix}_ffn_W1", f"{prefix}_ffn_b1",
            f"{prefix}_ffn_W1_QuantMultA",
        ),
        "w2": _affine(
            items, f"{prefix}_ffn_W2", f"{prefix}_ffn_b2",
            f"{prefix}_ffn_W2_QuantMultA",
        ),
        "ln": _ln(items, f"{prefix}_ffn_ffn"),
    }


def load_weights(items: Sequence[Item], config: ModelConfig) -> dict:
    """Assemble the params pytree; warns on unused items like the
    reference's load_parameters (slimt/Transformer.cc:216-225)."""
    if config.feed_forward_depth != 2:
        raise ValueError(
            "only feed_forward_depth=2 (W1/relu/W2) models are supported, "
            f"got {config.feed_forward_depth}"
        )
    pool = _Items(items)

    emb_item = pool.take("Wemb")
    if emb_item.is_quantized:
        emb = {"q": emb_item.array,
               "scale": np.float32(emb_item.scale)}
    else:
        q, mult = _quantize(np.asarray(emb_item.array, dtype=np.float32))
        emb = {"q": q, "scale": mult}

    # Output projection activation multiplier: none_QuantMultA when the
    # model was exported with a shortlist, Wemb_QuantMultA otherwise
    # (slimt/Transformer.cc:106-113).
    try:
        out_aq = pool.scalar("none_QuantMultA")
    except MissingParameter:
        out_aq = pool.scalar("Wemb_QuantMultA")
    # Mark the ig8 alias variant as consumed if present.
    if "Wemb_QuantMultA" in pool.by_name:
        pool.used.add("Wemb_QuantMultA")
    # A prepared "Wemb_intgemm8" from a re-serialized checkpoint would
    # also be redundant with emb["q"].
    if "Wemb_intgemm8" in pool.by_name:
        pool.used.add("Wemb_intgemm8")

    params = {
        "emb": emb,
        "out": {
            "aq": out_aq,
            "b": pool.vector("decoder_ff_logit_out_b"),
        },
        "encoder": [],
        "decoder": [],
    }

    for i in range(1, config.encoder_layers + 1):
        prefix = f"encoder_l{i}"
        params["encoder"].append(
            {
                "att": _attention(pool, f"{prefix}_self"),
                "ffn": _ffn(pool, prefix),
            }
        )

    for i in range(1, config.decoder_layers + 1):
        prefix = f"decoder_l{i}"
        rnn_prefix = f"{prefix}_rnn"
        params["decoder"].append(
            {
                "rnn": {
                    "w": _linear(
                        pool, f"{rnn_prefix}_W", f"{rnn_prefix}_W_QuantMultA"
                    ),
                    "wf": _affine(
                        pool,
                        f"{rnn_prefix}_Wf",
                        f"{rnn_prefix}_bf",
                        f"{rnn_prefix}_Wf_QuantMultA",
                    ),
                    "ln": _ln(pool, f"{rnn_prefix}_ffn"),
                },
                "att": _attention(pool, f"{prefix}_context"),
                "ffn": _ffn(pool, prefix),
            }
        )

    for name in pool.unused():
        log.warning("failed to ingest expected load of %s", name)
    return params


def model_dims(params: dict) -> tuple:
    """(vocab_size, emb_dim, ffn_dim) from a loaded pytree."""
    vocab, emb = params["emb"]["q"].shape
    encoder = params["encoder"]
    if isinstance(encoder, list):
        ffn = encoder[0]["ffn"]["w1"]["q"].shape[-1]
    else:  # stacked: leading layer axis
        ffn = encoder["ffn"]["w1"]["q"].shape[-1]
    return vocab, emb, ffn


def _stack(layers: List[dict]) -> dict:
    import jax

    return jax.tree.map(lambda *xs: np.stack(xs), *layers)


def stack_layers(params: dict, decoder: bool = True) -> dict:
    """Convert the per-layer lists into stacked pytrees (leading layer
    axis) so the encoder/decoder run as `lax.scan` over layers — much
    smaller HLO (one layer body instead of N unrolled), faster
    compiles, and the natural substrate for pipeline-stage splits.
    Numerics identical to the unrolled form.

    `decoder=False` stacks only the encoder: the 2-layer decoder stays
    an unrolled list, removing the inner scan-over-layers loop from
    every decode step (per-step loop setup + per-layer dynamic slices
    of the stacked params/KV) while the 6-layer encoder keeps the
    compile-time win stacking is for."""
    out = dict(params)
    out["encoder"] = _stack(params["encoder"])
    if decoder:
        out["decoder"] = _stack(params["decoder"])
    return out
