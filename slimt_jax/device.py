"""Every question the program asks about the device, in one module.

  - `F32_DOT_PRECISION`: the precision every float32 dot asks for.
    XLA:GPU may run a DEFAULT-precision f32 matmul in TF32 (10-bit
    mantissa); the attention einsums, the encoder SDPA and the "f32"
    QMM provider pass this constant explicitly instead (PERF.md,
    "TF32 vs HIGHEST", has the agreement measured at each setting).
  - `upcast_mixed_dots()`: whether dots with integer or 16-bit float
    operands must be upcast to f32 first — the one backend branch left
    in the model code.
  - `jit()`: `jax.jit` with `COMPILER_OPTIONS`; every program
    compilation goes through it, so the options hold whatever the
    process did with JAX before.
  - `configure_compile_cache()`: the persistent compilation cache,
    set up by every entry point (Model, bench.py, chip_smoke.py, the
    CLI, the server, the C API).
  - `card_line()`: the GPU's name and power limit, printed beside
    every measured rate.
"""

from __future__ import annotations

import os
import subprocess
from typing import Any, Callable, Mapping, Optional

import jax

F32_DOT_PRECISION = jax.lax.Precision.HIGHEST

# XLA:GPU's Triton GEMM emitter returned wrong int8 results on the
# H100 (JAX 0.9: first-step logits off by half their magnitude, 82%
# token agreement with the CPU; PERF.md "bring-up"). With it off every
# GEMM goes to cuBLAS/cuBLASLt and the results match the CPU. These are
# per-executable options: other backends ignore them, and nothing
# process-wide changes.
COMPILER_OPTIONS = {"xla_gpu_enable_triton_gemm": False}

# Fixed, inside the checkout: the directory is part of the cache key,
# so one that moves between runs (a temp name, a pid) never hits.
DEFAULT_COMPILE_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache",
)


def upcast_mixed_dots() -> bool:
    """True where XLA has no mixed-precision dot: the CPU backend
    multiplies int8×int8→int32 and bf16 dots in batched einsums only
    after an f32 upcast. Integer contractions here stay below 2^24, so
    the upcast int8 branch is bit-exact with the native one."""
    return jax.default_backend() == "cpu"


def compile_cache_dir(environ: Mapping[str, str]) -> Optional[str]:
    """The directory the program must set, or None when
    JAX_COMPILATION_CACHE_DIR is set (JAX reads that variable itself
    and the program sets no other)."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return DEFAULT_COMPILE_CACHE


def jit(fun: Callable, **kwargs: Any):
    """`jax.jit(fun, **kwargs)` compiled with COMPILER_OPTIONS."""
    return jax.jit(fun, compiler_options=COMPILER_OPTIONS, **kwargs)


def configure_compile_cache() -> None:
    """Turn on JAX's persistent compilation cache (idempotent; call
    before the first jit)."""
    directory = compile_cache_dir(os.environ)
    if directory is not None:
        jax.config.update("jax_compilation_cache_dir", directory)


def card_line() -> str:
    """`name, power.limit` of each visible NVIDIA GPU, as nvidia-smi
    reports them (empty when there is no nvidia-smi)."""
    try:
        proc = subprocess.run(
            [
                "nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader",
            ],
            capture_output=True, text=True, timeout=30,
        )
    except FileNotFoundError:
        return ""
    return proc.stdout.strip()
