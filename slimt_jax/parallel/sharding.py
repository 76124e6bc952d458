"""Device-mesh sharding for weights and batches.

The reference is single-machine CPU with thread parallelism
(slimt/Frontend.cc:212-227); scaling here is SPMD over a
`jax.sharding.Mesh` with two axes:

  - "data":  batch dimension of every request batch (DP). Across hosts
    this axis rides DCN; within a slice, ICI.
  - "model": tensor parallelism (TP) over ICI — attention-head/FFN
    hidden/vocab dimensions of the int8 weights, mirroring megatron
    column→row sharding so each encoder block needs one collective
    pair, and the tied-embedding logit projection is vocab-sharded.
  - "seq":   sequence parallelism (SP) over ICI — the token dimension
    of the [B, T] input (and therefore of every [B, T, E] encoder
    activation and cross-attention KV cache). The reference sidesteps
    long inputs by hard-wrapping at 128 tokens
    (slimt/TextProcessor.cc:123-157); with SP an unwrapped long input
    spreads its O(T²) encoder attention and O(T) KV traffic across
    chips — XLA/GSPMD inserts the all-gathers for the attention
    contractions from the input sharding alone.

Sharding is expressed as a PartitionSpec pytree matching the weight
pytree from slimt_jax.io.loader; XLA inserts the collectives
(psum/all-gather) during pjit compilation.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    data: int = 1,
    model: int = 1,
    seq: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    need = data * model * seq
    if need > len(devices):
        raise ValueError(
            f"mesh {data}x{model}x{seq} needs {need} devices, "
            f"have {len(devices)}"
        )
    grid = np.asarray(devices[:need]).reshape(data, model, seq)
    return Mesh(grid, axis_names=("data", "model", "seq"))


def _affine_spec(kind: str) -> dict:
    """kind: 'col' shards the output dim, 'row' the input dim."""
    if kind == "col":
        return {"q": P(None, "model"), "b": P("model"), "aq": P(), "bq": P()}
    return {"q": P("model", None), "b": P(), "aq": P(), "bq": P()}


def _linear_spec(kind: str) -> dict:
    spec = _affine_spec(kind)
    del spec["b"]
    return spec


_LN_SPEC = {"scale": P(), "bias": P()}


def _attention_spec() -> dict:
    # Column-parallel QKV (heads split over "model"), row-parallel O —
    # one psum at the O-projection per attention block.
    return {
        "q": _affine_spec("col"),
        "k": _affine_spec("col"),
        "v": _affine_spec("col"),
        "o": _affine_spec("row"),
        "ln": dict(_LN_SPEC),
    }


def _ffn_spec() -> dict:
    return {
        "w1": _affine_spec("col"),
        "w2": _affine_spec("row"),
        "ln": dict(_LN_SPEC),
    }


def _encoder_layer_spec() -> dict:
    return {"att": _attention_spec(), "ffn": _ffn_spec()}


def _decoder_layer_spec() -> dict:
    return {
        "rnn": {
            # SSRU runs column-parallel: W/Wf output-sharded so
            # gate/highway/relu stay local; the post-LN over the
            # full feature dim gathers.
            "w": _linear_spec("col"),
            "wf": _affine_spec("col"),
            "ln": dict(_LN_SPEC),
        },
        "att": _attention_spec(),
        "ffn": _ffn_spec(),
    }


def _prepend_none(spec_tree):
    """Stacked layers carry a leading layer axis: replicate it."""
    return jax.tree.map(
        lambda p: P(None, *p),
        spec_tree,
        is_leaf=lambda x: isinstance(x, P),
    )


def weight_pspecs(params: dict) -> dict:
    """PartitionSpec pytree mirroring loader.load_weights output
    (list-form layers) or loader.stack_layers output (stacked).
    Encoder and decoder forms are detected INDEPENDENTLY — the service
    runs the mixed form (stacked encoder for compile speed, unrolled
    2-layer decoder for step speed under non-int8 KV; models/model.py)."""
    spec = {
        # Vocab-sharded tied embedding: logit projection is embarrassingly
        # parallel over "model"; the (small) embedding gather all-gathers.
        "emb": {"q": P("model", None), "scale": P()},
        "out": {"aq": P(), "b": P("model")},
    }
    if isinstance(params["encoder"], list):
        spec["encoder"] = [
            _encoder_layer_spec() for _ in params["encoder"]
        ]
    else:
        spec["encoder"] = _prepend_none(_encoder_layer_spec())
    if isinstance(params["decoder"], list):
        spec["decoder"] = [
            _decoder_layer_spec() for _ in params["decoder"]
        ]
    else:
        spec["decoder"] = _prepend_none(_decoder_layer_spec())
    return spec


def batch_pspec(seq: bool = False) -> P:
    """Request batches are data-parallel on the leading dim; with
    seq=True the token dim is additionally sequence-sharded (SP) —
    every downstream [B, T, ...] activation inherits it."""
    return P("data", "seq") if seq else P("data", None)


def _divisible(arr, spec: P, mesh: Mesh) -> bool:
    shape = np.shape(arr)
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        names = axes if isinstance(axes, tuple) else (axes,)
        factor = 1
        for name in names:
            factor *= mesh.shape[name]
        if dim >= len(shape) or shape[dim] % factor != 0:
            return False
    return True


def shard_params(params: dict, mesh: Mesh) -> dict:
    """device_put the weight pytree with its TP shardings.

    Leaves whose dimensions don't divide the mesh axis (e.g. an odd
    vocab size) fall back to replication rather than failing."""
    specs = weight_pspecs(params)

    def place(arr, spec):
        if not _divisible(arr, spec, mesh):
            spec = P()
        return jax.device_put(arr, NamedSharding(mesh, spec))

    return jax.tree.map(
        place, params, specs, is_leaf=lambda x: isinstance(x, P)
    )


def replicate_params(params: dict, mesh: Mesh) -> dict:
    """Fully-replicated weights (pure DP — best for tiny models)."""
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(lambda arr: jax.device_put(arr, sharding), params)
