"""Multi-host SPMD serving glue.

The reference's only concurrency is worker threads on one machine
(slimt/Frontend.cc:207-227, Batcher.hh:203-259). The scale-out
story here:

  - within a slice: one process per host, SPMD over a global
    jax.sharding.Mesh (`initialize` wraps jax.distributed.initialize);
    weights TP-sharded/replicated over "model" (ICI), batches
    data-parallel over "data" (ICI within slice, DCN across slices);
  - request routing: each host runs the same Blocking/Async service;
    `shard_lines` splits a corpus deterministically across hosts so
    every process feeds its local slice of the global batch
    (single-controller-per-host, the standard JAX multi-host serving
    pattern).

Scaling efficiency = (throughput at N hosts) / (N × throughput at 1).
`scaling_report` measures it on whatever mesh is available (real pod
slice, or the virtual CPU mesh in tests).
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """jax.distributed.initialize with env-var fallback; no-op for
    single-process runs."""
    import jax

    if num_processes in (None, 1):
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(data: Optional[int] = None, model: int = 1):
    """Mesh over all (local + remote) devices: data × model."""
    import jax

    from slimt_jax.parallel.sharding import make_mesh

    devices = jax.devices()
    if data is None:
        data = len(devices) // model
    return make_mesh(data=data, model=model, devices=devices)


def shard_lines(lines: Sequence[str], process_id: int, num_processes: int) -> List[str]:
    """Deterministic per-host slice of a corpus (strided so hosts get
    similar length distributions)."""
    return list(lines[process_id::num_processes])


def measure_throughput(model, service, corpus: Sequence[str]) -> float:
    """Steady-state target-tokens/sec through a Blocking service."""
    service.translate(model, list(corpus))  # warm all shape buckets
    start = time.perf_counter()
    responses = service.translate(model, list(corpus))
    elapsed = time.perf_counter() - start
    tokens = sum(
        r.target.word_count(s)
        for r in responses
        for s in range(r.target.sentence_count())
    )
    return tokens / elapsed


def scaling_report(make_model, make_service, corpus, device_counts):
    """Throughput at several data-parallel widths on the local device
    pool; returns {n_devices: tokens/sec} plus efficiencies."""
    results = {}
    for n in device_counts:
        mesh = global_mesh(data=n, model=1)
        model = make_model(mesh)
        service = make_service()
        results[n] = measure_throughput(model, service, corpus)
    base = results[device_counts[0]] / device_counts[0]
    return {
        "throughput": results,
        "efficiency": {
            n: results[n] / (n * base) for n in device_counts
        },
    }
