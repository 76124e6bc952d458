"""Utilities: timing, running averages, profiling, debug printing.

Parity with the reference's Utils.hh: `Timer` (Utils.hh:69-99),
`AverageMeter` (Utils.hh:101-112), `argsort` (Utils.hh:114-130),
`hash_combine/hash_bytes` (Utils.hh:47-67 — in io.shortlist). The
tracing equivalent of the reference's SLIMT_TRACE/gprof hooks
(Macros.hh:7-28, CMakeLists.txt:171-182) is `jax.profiler` via
`trace()`.

Env knobs (reference: SLIMT_DEBUG / SLIMT_EPS, Tensor.cc:172-228):
  SLIMT_JAX_DEBUG=1          enable debug tensor printing
  SLIMT_JAX_PROFILE=dir      write a jax profiler trace to dir

The persistent compilation cache lives in slimt_jax.device.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, List, Optional, Sequence


def tune_gc(gen0_threshold: int) -> None:
    """Raise (never lower) Python's gen-0 gc threshold. JAX registers
    an XLA collect_garbage callback on every gc pass (jax issue
    #14882); at CPython's default gen-0 threshold of 700 allocations,
    a host-heavy serving loop triggers it hundreds of times per
    second. Called by the services with Config.gc_gen0_threshold."""
    if gen0_threshold <= 0:
        return
    import gc

    current = gc.get_threshold()
    if current[0] < gen0_threshold:
        gc.set_threshold(gen0_threshold, *current[1:])


class Timer:
    def __init__(self):
        self.start = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.start

    def reset(self) -> None:
        self.start = time.perf_counter()


class AverageMeter:
    """Running average (reference Utils.hh:101-112). Thread-safe:
    recorded from concurrent Async workers and completion threads."""

    def __init__(self):
        import threading

        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def record(self, value: float) -> None:
        with self._lock:
            self.sum += value
            self.count += 1

    def average(self) -> float:
        with self._lock:
            return self.sum / self.count if self.count else 0.0


def argsort(values: Sequence) -> List[int]:
    return sorted(range(len(values)), key=values.__getitem__)


def debug_enabled() -> bool:
    return os.environ.get("SLIMT_JAX_DEBUG", "") not in ("", "0")


def debug_print(name: str, array) -> None:
    """numpy-ish tensor dump behind SLIMT_JAX_DEBUG (reference
    Utils.cc:28-96 print_ndarray)."""
    if not debug_enabled():
        return
    import sys

    import numpy as np

    arr = np.asarray(array)
    print(
        f"{name}: shape={arr.shape} dtype={arr.dtype} "
        f"mean={arr.mean():.6g} std={arr.std():.6g}\n{arr}",
        file=sys.stderr,
    )


@contextlib.contextmanager
def trace(name: str = "slimt_jax", directory: Optional[str] = None):
    """jax.profiler trace scope; no-op unless a directory is given or
    SLIMT_JAX_PROFILE is set."""
    directory = directory or os.environ.get("SLIMT_JAX_PROFILE")
    if not directory:
        yield
        return
    import jax

    with jax.profiler.trace(directory):
        with jax.profiler.TraceAnnotation(name):
            yield


class ShortlistMeter:
    """Generated vs bucket-padded shortlist width statistics
    (observability for the static-shape padding tax)."""

    def __init__(self):
        self.generated = AverageMeter()
        self.padded = AverageMeter()

    def record_widths(self, generated: int, padded: int) -> None:
        self.generated.record(generated)
        self.padded.record(padded)

    def snapshot(self) -> dict:
        return {
            "batches": self.generated.count,
            "avg_generated_width": round(self.generated.average(), 1),
            "avg_padded_width": round(self.padded.average(), 1),
        }


class ServiceMeters:
    """Words-per-second + batch occupancy meters, the reference's
    exhaust-loop instrumentation (slimt/Frontend.cc:44-59)."""

    def __init__(self):
        self.wps = AverageMeter()
        self.occupancy = AverageMeter()

    def record_batch(
        self, words: int, elapsed: float, used: int, capacity: int
    ) -> None:
        if elapsed > 0:
            self.wps.record(words / elapsed)
        if capacity > 0:
            self.occupancy.record(used / capacity)


def stub_device_forward(model) -> None:
    """Replace a Model's device forward with an instant echo
    (hypothesis tokens = source tokens), keeping every HOST stage real
    (ingest, packing, completion, detokenize, response assembly).

    Measurement tool, not a serving mode: isolates the host-side
    budget of the service path from device time — used, via
    SLIMT_JAX_STUB_DEVICE=1 in slimt_jax.server, by the router
    fleet-scaling measurement (scripts/fleet_budget.py), where N
    backend processes must be bounded by host cores and transport,
    not by a device."""
    import numpy as np

    from slimt_jax.runtime.request import Hypothesis

    def forward_async(segments, need_alignment=True, raw=False):
        if raw:
            # Columnar completion contract (Batch.complete_raw):
            # padded token matrix + per-row step counts.
            steps = np.asarray([len(s) for s in segments], np.int32)
            t = max(1, int(steps.max()))
            toks = np.zeros((len(segments), t), np.int32)
            for i, s in enumerate(segments):
                toks[i, : len(s)] = s
            return lambda: (toks, steps, None)
        hyps = [
            Hypothesis(target=list(s), alignment=[]) for s in segments
        ]
        return lambda: hyps

    def forward_async_arrays(
        indices, mask, lengths, batch, need_alignment=False,
        shortlist_words=None, raw=False,
    ):
        steps = np.asarray(lengths, np.int32)
        if raw:
            return lambda: (indices, steps, None)
        return lambda: [
            Hypothesis(
                target=indices[i, : steps[i]].tolist(), alignment=[]
            )
            for i in range(batch)
        ]

    model.forward_async = forward_async
    model.forward_async_arrays = forward_async_arrays
    model.forward = lambda segments, need_alignment=True: forward_async(
        segments, need_alignment
    )()
