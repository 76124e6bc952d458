"""Multi-process SPMD translation demo / test worker.

Each process owns a subset of devices; together they form one global
mesh. Every process builds the same model (replicated or TP-sharded
over the global mesh), takes its strided shard of the corpus
(multihost.shard_lines), and translates it — the per-host serving
recipe that replaces the reference's single-machine worker threads
(SURVEY §2.2).

Driven by tests/test_multiprocess.py with N CPU processes; on real
clusters the same flow runs one process per host.

Usage: multihost_demo.py <process_id> <num_processes> <coordinator>
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4"
)

import jax

jax.config.update("jax_platforms", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    process_id = int(sys.argv[1])
    num_processes = int(sys.argv[2])
    coordinator = sys.argv[3]

    from slimt_jax.parallel import multihost

    multihost.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )

    from slimt_jax.config import Config, ModelConfig
    from slimt_jax.io.synthetic import synthetic_model_bytes
    from slimt_jax.models.model import Model, Package
    from slimt_jax.runtime.service import Blocking
    from slimt_jax.text import spm_proto
    from slimt_jax.text.synthetic_vocab import build_spm_model

    config = ModelConfig(encoder_layers=2, decoder_layers=2, num_heads=4)
    words = ["hello", "world", "test", "quick", "brown"]
    spm = build_spm_model(words, target_size=64)
    package = Package(
        model=synthetic_model_bytes(
            config=config, vocab_size=64, emb_dim=16, ffn_dim=32, seed=0
        ),
        vocabulary=spm_proto.serialize_model(spm),
    )

    mesh = multihost.global_mesh(model=1)
    model = Model(config, package, mesh=mesh, sharding="replicate")

    # SPMD serving: every process runs the identical host pipeline on
    # the full (replicated) request stream; the device batch is
    # sharded over the global "data" axis and results all-gathered.
    corpus = [f"hello world test {i}" for i in range(8)]
    service = Blocking(Config(cache_size=0))
    responses = service.translate(model, corpus)
    for line, response in zip(corpus, responses):
        print(
            f"proc {process_id} | {line!r} -> {response.target.text!r}",
            flush=True,
        )
    print(
        f"proc {process_id} DONE devices={len(jax.devices())} "
        f"local={len(jax.local_devices())} lines={len(corpus)}",
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
