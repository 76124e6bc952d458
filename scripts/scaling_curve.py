"""DP/TP/SP scaling curves on the virtual 8-device CPU mesh.

Exact-match tests (tests/test_sharding.py) prove sharded programs are
CORRECT; this measures whether sharding introduces hidden
serialization.  On a single shared-CPU host, adding virtual devices
adds no compute, so the honest metric is STRONG scaling at fixed total
work: tokens/s of the sharded program at mesh size N divided by the
single-device tokens/s on the same total batch.  A ratio near 1.0
means GSPMD partitioned the program without serializing it; a low
ratio flags collective/layout overhead that exact-match tests cannot
see.  (Real ≥0.8/host weak-scaling numbers require real chips; see
DEPLOYMENT.md.)

Usage:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python scripts/scaling_curve.py [--batch 64] [--steps 12]
Prints one JSON line per mesh config.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

os.environ.setdefault(
    "XLA_FLAGS", "--xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402


def measure(params, config, mesh_kw, batch, seq, steps, repeats=5):
    """Best-of-N wall time for the jitted sharded decode at fixed
    total batch; returns tokens/s."""
    from slimt_jax import device
    from slimt_jax.models.decode import translate_batch
    from slimt_jax.parallel import sharding as shd

    mesh = shd.make_mesh(**mesh_kw)
    n = int(np.prod(list(mesh.shape.values())))
    if mesh_kw.get("model", 1) > 1:
        placed = shd.shard_params(params, mesh)
    elif n > 1:
        placed = shd.replicate_params(params, mesh)
    else:
        placed = params
    seq_sharded = mesh_kw.get("seq", 1) > 1
    bspec = NamedSharding(mesh, shd.batch_pspec(seq=seq_sharded))

    rng = np.random.default_rng(0)
    fn = device.jit(
        lambda p, i, m: translate_batch(
            p, i, m,
            eos_id=-1,  # full-length decode: fixed work per run
            max_steps=steps,
            num_heads=config.num_heads,
            provider="xla_int8",
        )
    )

    def inputs(seed):
        r = np.random.default_rng(seed)
        idx = r.integers(3, 128, (batch, seq)).astype(np.int32)
        msk = np.ones((batch, seq), np.float32)
        if n > 1:
            return (
                jax.device_put(jnp.asarray(idx), bspec),
                jax.device_put(jnp.asarray(msk), bspec),
            )
        return jnp.asarray(idx), jnp.asarray(msk)

    idx, msk = inputs(1)
    np.asarray(fn(placed, idx, msk).tokens)  # compile + warm
    best = float("inf")
    for rep in range(repeats):
        idx, msk = inputs(rep + 2)
        t0 = time.perf_counter()
        out = fn(placed, idx, msk)
        np.asarray(out.tokens)
        best = min(best, time.perf_counter() - t0)
    return batch * steps / best


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--seq", type=int, default=24)
    parser.add_argument("--steps", type=int, default=12)
    args = parser.parse_args()

    from slimt_jax.config import ModelConfig
    from slimt_jax.io import load_items
    from slimt_jax.io.loader import load_weights
    from slimt_jax.io.synthetic import synthetic_model_bytes

    config = ModelConfig(encoder_layers=3, decoder_layers=2, num_heads=4)
    items = load_items(
        synthetic_model_bytes(
            config=config, vocab_size=128, emb_dim=64, ffn_dim=128, seed=0
        )
    )
    params = load_weights(items, config)

    configs = [
        ("single", {}),
        ("dp2", {"data": 2}),
        ("dp4", {"data": 4}),
        ("dp8", {"data": 8}),
        ("tp2", {"model": 2}),
        ("tp4", {"model": 4}),
        ("dp2xtp2", {"data": 2, "model": 2}),
        ("sp2", {"seq": 2}),
    ]
    base = None
    for name, mesh_kw in configs:
        tps = measure(
            params, config, mesh_kw, args.batch, args.seq, args.steps
        )
        if base is None:
            base = tps
        print(
            json.dumps(
                {
                    "mesh": name,
                    "tokens_per_sec": round(tps, 1),
                    "vs_single_device": round(tps / base, 3),
                }
            )
        )


if __name__ == "__main__":
    main()
