"""Quantized matmul (QMM) — the compute centerpiece.

Replacement for the reference's intgemm/ruy/gemmology providers
(slimt/QMM.hh:11-65, slimt/qmm/*.inl.cc). The contract is the
reference's exactly:

    affine(x, w):  y = (round(x*aq) @ w_q) / (aq*bq) + b
    dot(x, w):     y = (round(x*aq) @ w_q) / (aq*bq)
    affine_with_select(x, w, ids): columns of w_q (+ bias) gathered by
        `ids` before the multiply — the shortlisted output projection
        (qmm/Gemmology.inl.cc:83-98).

where aq/bq are the per-tensor activation/weight multipliers
(q = f32*mult). The reference's shifted-unsigned-A trick with
PrepareBias compensation (qmm/Gemmology.inl.cc:63-80) exists only
because x86 lacks signed×signed int8 dot products; XLA's integer dot
multiplies signed int8 directly, so the math here is the plain signed
form — numerically equivalent up to that kernel's saturation behavior.

Providers (runtime switch, mirroring the compile-time one in
slimt/QMM.cc:3-34):
  - "xla_int8":  jnp quantize + lax.dot_general(int8→int32). XLA fuses
                 the quantize/dequantize elementwise chains around the
                 integer GEMM.
  - "f32":       dequantize weights and multiply in f32 — reference-
                 numerics debug path.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from slimt_jax import device

PROVIDERS = ("xla_int8", "f32")
_DEFAULT_PROVIDER = "xla_int8"


def set_default_provider(name: str) -> None:
    global _DEFAULT_PROVIDER
    if name not in PROVIDERS:
        raise ValueError(f"unknown qmm provider {name!r}")
    _DEFAULT_PROVIDER = name


def default_provider() -> str:
    return _DEFAULT_PROVIDER


def quantize_activations(x: jax.Array, aq: jax.Array) -> jax.Array:
    """f32 → int8 with the per-tensor multiplier `aq`.

    Round-to-nearest-even with saturation to ±127, matching intgemm's
    PrepareA rounding (cvtps rounds half-to-even; saturation to the
    symmetric int8 range).
    """
    scaled = x.astype(jnp.float32) * aq
    return jnp.clip(jnp.rint(scaled), -127.0, 127.0).astype(jnp.int8)


def _int8_matmul(x_q: jax.Array, w_q: jax.Array) -> jax.Array:
    """[.., M, K] int8 × [K, N] int8 → [.., M, N] int32."""
    return jax.lax.dot_general(
        x_q,
        w_q,
        dimension_numbers=(((x_q.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )


def affine(
    x: jax.Array,
    w_q: jax.Array,
    b: Optional[jax.Array],
    aq: jax.Array,
    bq: jax.Array,
    provider: Optional[str] = None,
    out_dtype: jnp.dtype = jnp.float32,
) -> jax.Array:
    """y = dequant(quant(x) @ w_q) [+ b]; w_q is int8 [K, N]."""
    provider = provider or _DEFAULT_PROVIDER
    if provider == "f32":
        w = w_q.astype(jnp.float32) / bq
        y = jnp.dot(
            x.astype(jnp.float32), w, preferred_element_type=jnp.float32,
            precision=device.F32_DOT_PRECISION,
        )
    else:
        x_q = quantize_activations(x, aq)
        acc = _int8_matmul(x_q, w_q)
        y = acc.astype(jnp.float32) * (1.0 / (aq * bq))
    if b is not None:
        y = y + b
    return y.astype(out_dtype)


def dot(
    x: jax.Array,
    w_q: jax.Array,
    aq: jax.Array,
    bq: jax.Array,
    provider: Optional[str] = None,
    out_dtype: jnp.dtype = jnp.float32,
) -> jax.Array:
    """Bias-free variant (reference qmm::dot, used by SSRU's W)."""
    return affine(x, w_q, None, aq, bq, provider=provider, out_dtype=out_dtype)


def affine_with_select(
    x: jax.Array,
    w_q: jax.Array,
    b: jax.Array,
    aq: jax.Array,
    bq: jax.Array,
    indices: jax.Array,
    provider: Optional[str] = None,
    out_dtype: jnp.dtype = jnp.float32,
) -> jax.Array:
    """Shortlisted affine: gather columns of w_q and entries of b by
    `indices` (static-shaped, pre-padded), then multiply.

    The gather happens on int8 data before the matmul, so the GEMM only
    computes the S selected logits (S ≪ V) — same work-saving as the
    reference's SelectColumnsB (qmm/Gemmology.inl.cc:83-98).
    """
    w_sel = jnp.take(w_q, indices, axis=1)
    b_sel = jnp.take(b, indices, axis=0)
    return affine(
        x, w_sel, b_sel, aq, bq, provider=provider, out_dtype=out_dtype
    )
