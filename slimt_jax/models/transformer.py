"""Bergamot student transformer: encoder + SSRU decoder.

Pure functions over the weight pytree from slimt_jax.io.loader. The
computation reproduces the reference semantics:

  - embedding scale + sinusoidal signal (slimt/Transformer.cc:24-49,
    slimt/TensorOps.cc:245-265)
  - post-LN encoder layers: self-attention (residual + LN inside the
    attention block) then 2-affine ReLU FFN with residual + LN
    (slimt/Modules.cc:287-334)
  - SSRU decoder recurrence (slimt/Modules.cc:182-235):
        f(t) = σ(Wf·x + bf)
        c(t) = f ⊙ c(t-1) + (1-f) ⊙ (W·x)
        y(t) = relu(c(t));  h(t) = LN(x + y)
  - cross-attention over encoder output; unlike the reference (which
    recomputes K/V projections of encoder_out at every decode step —
    the TODO at slimt/Modules.cc:248), K/V are projected once before
    the decode loop.
  - tied-embedding output projection with optional shortlist column
    select (slimt/Transformer.cc:104-117,176-182)

All projections run through slimt_jax.ops.qmm (int8 GEMMs). Masks are
additive: 0 for real tokens, -1e8 for padding (slimt/Input.cc:49-63).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from slimt_jax import device
from slimt_jax.ops import qmm

LN_EPS = 1e-6  # slimt/TensorOps.cc:647
MASK_MIN = -99999999.0  # slimt/Input.cc:57-58


def layer_norm(x: jax.Array, ln: dict) -> jax.Array:
    """y = (x - mean) / sqrt(var + eps) * scale + bias
    (slimt/TensorOps.cc:542-580; variance is the biased /N form).

    Statistics always accumulate in f32; the output carries the input
    dtype (the reduced-precision encoder mode keeps its residual
    stream in fp16/bf16 — see encoder `act_dtype`)."""
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=-1, keepdims=True)
    centered = xf - mean
    var = jnp.mean(centered * centered, axis=-1, keepdims=True)
    inv = jax.lax.rsqrt(var + LN_EPS)
    return (centered * inv * ln["scale"] + ln["bias"]).astype(x.dtype)


def embed(
    params: dict, indices: jax.Array, dtype: Optional[jnp.dtype] = None
) -> jax.Array:
    """Token ids → float embeddings [.., E] (f32 unless `dtype`).

    The embedding matrix is kept int8 in HBM (it doubles as the output
    projection); rows are gathered then dequantized, matching the
    reference's load-time unquantize of Wemb (slimt/Io.cc:182-224).
    """
    dt = dtype or jnp.float32
    rows = jnp.take(params["emb"]["q"], indices, axis=0)
    return rows.astype(dt) * (1.0 / params["emb"]["scale"]).astype(dt)


def sinusoidal_signal(
    start: int, length: int, emb_dim: int, positions: Optional[jax.Array] = None
) -> jax.Array:
    """Marian's sin/cos positional signal (slimt/TensorOps.cc:245-265):
    first half sin, second half cos, timescale exp(-i*ln(1e4)/(E/2-1)).

    `positions` (shape [length]) overrides `start + arange(length)` so
    the decoder can feed a traced step index.
    """
    half = emb_dim // 2
    if positions is None:
        positions = start + jnp.arange(length, dtype=jnp.float32)
    positions = positions.astype(jnp.float32)
    log_timescale_increment = math.log(10000.0) / (half - 1.0)
    inv_timescales = jnp.exp(
        jnp.arange(half, dtype=jnp.float32) * -log_timescale_increment
    )
    angles = positions[:, None] * inv_timescales[None, :]  # [T, half]
    return jnp.concatenate([jnp.sin(angles), jnp.cos(angles)], axis=-1)


def transform_embedding(
    x: jax.Array, start: int = 0, positions: Optional[jax.Array] = None
) -> jax.Array:
    """x*sqrt(E) + positional signal (slimt/Transformer.cc:24-49).

    Dtype-preserving: the signal is rounded to x's dtype so the
    reduced-precision encoder mode doesn't silently promote back to
    f32 (f32 paths are bit-identical — the cast is a no-op there)."""
    emb_dim = x.shape[-1]
    signal = sinusoidal_signal(start, x.shape[-2], emb_dim, positions)
    return x * math.sqrt(emb_dim) + signal.astype(x.dtype)


def _affine(
    p: dict,
    x: jax.Array,
    provider: Optional[str],
    out_dtype: jnp.dtype = jnp.float32,
) -> jax.Array:
    return qmm.affine(
        x, p["q"], p["b"], p["aq"], p["bq"], provider=provider,
        out_dtype=out_dtype,
    )


def _split_heads(x: jax.Array, num_heads: int) -> jax.Array:
    """[B, T, E] → [B, H, T, D] (slimt/Modules.cc:88-126).

    T == 1 (decode steps) needs no data movement — pure reshape."""
    b, t, e = x.shape
    if t == 1:
        return x.reshape(b, num_heads, 1, e // num_heads)
    return x.reshape(b, t, num_heads, e // num_heads).transpose(0, 2, 1, 3)


def _join_heads(x: jax.Array) -> jax.Array:
    """[B, H, T, D] → [B, T, E]."""
    b, h, t, d = x.shape
    if t == 1:
        return x.reshape(b, 1, h * d)
    return x.transpose(0, 2, 1, 3).reshape(b, t, h * d)


def scaled_dot_product_attention(
    q: jax.Array, k: jax.Array, v: jax.Array, mask_add: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """[B,H,Tq,D] × [B,H,Tk,D] with additive mask [B,1,1,Tk].

    Scaling by 1/sqrt(D) is applied to the QK^T product like the
    reference's sgemm alpha (slimt/Modules.cc:42-51).
    """
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    if q.shape[-2] == 1 and k.dtype != jnp.float32:
        # Decode-step attention on a reduced-precision split cache:
        # broadcast-multiply + reduce instead of batched [1,D]x[T,D]
        # matmuls (bandwidth-bound either way).
        qb = q[:, :, 0, :].astype(k.dtype)  # [B,H,D]
        scores = (
            (k * qb[:, :, None, :]).astype(jnp.float32).sum(-1) * scale
            + mask_add[:, :, 0, :]
        )  # [B,H,Tk]
        attn = jax.nn.softmax(scores, axis=-1)
        out = (v.astype(jnp.float32) * attn[..., None]).sum(2)  # [B,H,D]
        return out[:, :, None, :], attn[:, :, None, :]
    # K/V may be reduced-precision (bf16 cache); multiply in that
    # dtype, accumulate f32.
    scores = jnp.einsum(
        "bhqd,bhkd->bhqk",
        q.astype(k.dtype),
        k,
        preferred_element_type=jnp.float32,
        precision=device.F32_DOT_PRECISION,
    ) * scale
    scores = scores + mask_add
    attn = jax.nn.softmax(scores.astype(jnp.float32), axis=-1)
    out = jnp.einsum(
        "bhqk,bhkd->bhqd",
        attn.astype(v.dtype),
        v,
        preferred_element_type=jnp.float32,
        precision=device.F32_DOT_PRECISION,
    )
    # Dtype-preserving on q: the reduced-precision encoder keeps its
    # residual stream in fp16/bf16 (f32 paths unchanged).
    return out.astype(q.dtype), attn


def _head_selector(emb_dim: int, num_heads: int, dtype) -> jax.Array:
    """Block-diagonal [E, H] 0/1 matrix: column h selects head h's
    feature slice. Lets decode attention keep K/V in the joined
    [B, T, E] layout and do the per-head reduction as a matmul instead
    of a [B, H, T, D] split with a narrow D=32 minor dimension."""
    d = emb_dim // num_heads
    eye = jnp.eye(num_heads, dtype=dtype)  # [H, H]
    return jnp.repeat(eye, d, axis=0)  # [E, H]


def _decode_attention_joined(
    yq: jax.Array,
    kv: dict,
    mask_add: jax.Array,
    num_heads: int,
) -> Tuple[jax.Array, jax.Array]:
    """Decode-step (T_q == 1) cross-attention over a joined-layout
    [B, T, E] KV cache. Both contraction steps run as batched GEMMs
    with the head structure expressed via the selector matrix; int8
    caches multiply as int8 x int8 (half the bytes of bf16).

    yq: Q-projection output [B, 1, E]. Returns (out [B, 1, E],
    attn [B, H, 1, Tk]) — same contract as
    scaled_dot_product_attention at T_q == 1."""
    q = yq[:, 0, :]  # [B, E]
    k, v = kv["k"], kv["v"]
    b, t, e = k.shape
    scale = 1.0 / math.sqrt(e // num_heads)
    # Where the backend lacks mixed-precision dots the operands are
    # upcast to f32 (device.upcast_mixed_dots). int8 branch: bit-exact
    # either way (contractions stay < 2^24). bf16 branch: operands are
    # first ROUNDED THROUGH bf16, so the upcast path multiplies the
    # same values; only dot accumulation order can still differ.
    on_cpu = device.upcast_mixed_dots()
    hi = device.F32_DOT_PRECISION
    if k.dtype == jnp.int8 and v.dtype == jnp.int16:
        # MIXED cache ("k8v16"): scores from an int8 K (int8 GEMM,
        # like the int8 branch) but the value mix from an int16 V (f32
        # GEMM via fused convert, like the int16 branch) — 1.5
        # bytes/elem average. Measured agreement (crosscheck serving
        # sweep, CPU): 96.0% tokens — int8-class, not int16-class — so
        # K's quantization dominates the attention error. Kept as a
        # measured variant; int16 remains the default.
        sel8 = _head_selector(e, num_heads, jnp.int8)
        aq = 127.0 / jnp.maximum(jnp.max(jnp.abs(q)), 1e-6)
        q_q = qmm.quantize_activations(q, aq)
        q2 = q_q[:, :, None] * sel8[None]  # [B, E, H] int8
        if on_cpu:
            k_op, q2_op = k.astype(jnp.float32), q2.astype(jnp.float32)
            acc = jnp.float32
        else:
            k_op, q2_op, acc = k, q2, jnp.int32
        scores = jnp.einsum(
            "bte,beh->bht", k_op, q2_op, preferred_element_type=acc
        ).astype(jnp.float32) * (scale / aq) * kv["kqi"][:, None, :]
        scores = scores + mask_add[:, :, 0, :]
        attn = jax.nn.softmax(scores, axis=-1)  # [B, H, T]
        attn_v = attn * kv["vqi"][:, None, :]
        res = jnp.einsum(
            "bht,bte->bhe",
            attn_v,
            v.astype(jnp.float32),
            preferred_element_type=jnp.float32,
            precision=hi,
        )  # [B, H, E]
        selt = _head_selector(e, num_heads, jnp.float32)
    elif k.dtype == jnp.int8:
        sel = _head_selector(e, num_heads, jnp.int8)
        # Dynamic per-step activation scale for q (per-tensor, like
        # every other activation quantization in the engine).
        aq = 127.0 / jnp.maximum(jnp.max(jnp.abs(q)), 1e-6)
        q_q = qmm.quantize_activations(q, aq)
        q2 = q_q[:, :, None] * sel[None]  # [B, E, H] int8
        if on_cpu:
            k_op, q2_op = k.astype(jnp.float32), q2.astype(jnp.float32)
            acc = jnp.float32
        else:
            k_op, q2_op, acc = k, q2, jnp.int32
        # K carries PER-ROW (b, t) scales: the dequant folds into the
        # scores elementwise as a [B, 1, T] broadcast — same work as a
        # per-tensor scalar, much tighter quantization.
        scores = jnp.einsum(
            "bte,beh->bht", k_op, q2_op, preferred_element_type=acc
        ).astype(jnp.float32) * (scale / aq) * kv["kqi"][:, None, :]
        scores = scores + mask_add[:, :, 0, :]
        attn = jax.nn.softmax(scores, axis=-1)  # [B, H, T]
        # V's per-row dequant folds into attn before its quantization;
        # attn is then re-quantized with a dynamic per-(b, h) scale
        # (attn_v >= 0, so max == absmax).
        attn_v = attn * kv["vqi"][:, None, :]
        s_a = 127.0 / jnp.maximum(
            jnp.max(attn_v, axis=-1, keepdims=True), 1e-9
        )  # [B, H, 1]
        attn_q = jnp.rint(attn_v * s_a).astype(jnp.int8)
        if on_cpu:
            a_op, v_op = attn_q.astype(jnp.float32), v.astype(jnp.float32)
        else:
            a_op, v_op = attn_q, v
        res = jnp.einsum(
            "bht,bte->bhe", a_op, v_op, preferred_element_type=acc
        ).astype(jnp.float32) / s_a
        selt = _head_selector(e, num_heads, jnp.float32)
    elif k.dtype == jnp.int16:
        # int16 per-row-scaled cache (the service default): the cache
        # converts to f32 inside the matmul operand read (2-byte
        # traffic, f32 GEMM); the per-row dequants fold elementwise
        # exactly like the int8 branch, but q and attn stay f32 (no
        # activation quantization needed). The "k16v8" mixed cache
        # (int16 K + int8 V) rides this same branch: both operands
        # convert to f32 inside their reads, V just carries 1 byte/elem.
        sel = _head_selector(e, num_heads, jnp.float32)
        q2 = q[:, :, None] * sel[None]  # [B, E, H] f32
        scores = jnp.einsum(
            "bte,beh->bht",
            k.astype(jnp.float32),
            q2,
            preferred_element_type=jnp.float32,
            precision=hi,
        ) * scale * kv["kqi"][:, None, :]
        scores = scores + mask_add[:, :, 0, :]
        attn = jax.nn.softmax(scores, axis=-1)  # [B, H, T]
        attn_v = attn * kv["vqi"][:, None, :]
        res = jnp.einsum(
            "bht,bte->bhe",
            attn_v,
            v.astype(jnp.float32),
            preferred_element_type=jnp.float32,
            precision=hi,
        )  # [B, H, E]
        selt = sel
    else:
        kv_dtype = k.dtype
        # bf16 cache: BOTH operands of the dot are rounded through
        # bf16 (q/attn too), so every backend multiplies the same
        # values. fp16 cache: only the CACHE itself is rounded; q/attn
        # stay f32 and the dot promotes to f32 — half the rounding
        # sources, worth ~+0.6% serving agreement by itself.
        round_operands = kv_dtype == jnp.bfloat16

        def op(arr):
            if round_operands:
                arr = arr.astype(kv_dtype)
            return arr.astype(jnp.float32) if on_cpu else arr

        sel = _head_selector(e, num_heads, jnp.float32)
        q2 = op(q[:, :, None] * sel[None])  # [B, E, H]
        scores = (
            jnp.einsum(
                "bte,beh->bht",
                op(k),
                q2,
                preferred_element_type=jnp.float32,
                precision=hi,
            )
            * scale
            + mask_add[:, :, 0, :]
        )
        attn = jax.nn.softmax(scores, axis=-1)  # [B, H, T]
        res = jnp.einsum(
            "bht,bte->bhe",
            op(attn),
            op(v),
            preferred_element_type=jnp.float32,
            precision=hi,
        )  # [B, H, E]
        selt = sel
    out = (res * selt.T[None]).sum(1)  # [B, E] diagonal-block extract
    return out[:, None, :], attn[:, :, None, :]


def attention_forward(
    att: dict,
    q_in: jax.Array,
    k_in: jax.Array,
    v_in: jax.Array,
    mask_add: jax.Array,
    num_heads: int,
    provider: Optional[str] = None,
    kv_cache: Optional[Tuple[jax.Array, jax.Array]] = None,
    flash: bool = False,
    act_dtype: Optional[jnp.dtype] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Full attention block incl. residual + post-LN
    (slimt/Modules.cc:287-319). Returns (out, attn_weights).

    `kv_cache` supplies pre-projected K/V for cross-attention so
    encoder projections happen once per batch, not once per decode
    step: either a (K, V) pair of pre-split [B,H,Tk,D] arrays (exact
    f32 path) or a joined-layout dict from precompute_cross_kv
    (reduced-precision [B,Tk,E] cache). `flash=True` uses the
    query-chunked attention (ops.attention.chunked_attention:
    O(T·block) memory; attn weights not materialized — returns None
    for them). `act_dtype` (encoder reduced-precision mode) carries the
    residual stream and SDPA operands in fp16/bf16; None keeps the
    exact f32 path bit-identical.
    """
    act = act_dtype or jnp.float32
    if isinstance(kv_cache, dict):
        yq = _affine(att["q"], q_in, provider)  # [B, 1, E]
        attn_out, attn = _decode_attention_joined(
            yq, kv_cache, mask_add, num_heads
        )
        out = _affine(att["o"], attn_out, provider)
        return layer_norm(q_in + out, att["ln"]), attn
    yq = _split_heads(
        _affine(att["q"], q_in, provider, out_dtype=act), num_heads
    )
    if kv_cache is None:
        yk = _split_heads(
            _affine(att["k"], k_in, provider, out_dtype=act), num_heads
        )
        yv = _split_heads(
            _affine(att["v"], v_in, provider, out_dtype=act), num_heads
        )
    else:
        yk, yv = kv_cache
    if flash:
        from slimt_jax.ops.attention import chunked_attention

        attn_out = chunked_attention(
            yq.astype(jnp.float32),
            yk.astype(jnp.float32),
            yv.astype(jnp.float32),
            mask_add,
        )
        attn = None
    else:
        attn_out, attn = scaled_dot_product_attention(yq, yk, yv, mask_add)
    out = _affine(
        att["o"], _join_heads(attn_out).astype(act), provider, out_dtype=act
    )
    return layer_norm(q_in.astype(act) + out, att["ln"]), attn


def _ffn_block(
    layer: dict,
    x: jax.Array,
    provider: Optional[str],
    act_dtype: Optional[jnp.dtype] = None,
) -> jax.Array:
    """FFN1 → relu → FFN2 → residual → post-LN
    (slimt/Modules.cc:321-334)."""
    act = act_dtype or jnp.float32
    h = jax.nn.relu(_affine(layer["ffn"]["w1"], x, provider, out_dtype=act))
    y = _affine(layer["ffn"]["w2"], h, provider, out_dtype=act)
    return layer_norm(y + x.astype(act), layer["ffn"]["ln"])


def encoder_layer_forward(
    layer: dict,
    x: jax.Array,
    mask_add: jax.Array,
    num_heads: int,
    provider: Optional[str] = None,
    flash: bool = False,
    act_dtype: Optional[jnp.dtype] = None,
) -> jax.Array:
    out, _ = attention_forward(
        layer["att"], x, x, x, mask_add, num_heads, provider, flash=flash,
        act_dtype=act_dtype,
    )
    return _ffn_block(layer, out, provider, act_dtype=act_dtype)


def encoder_forward(
    params: dict,
    word_embedding: jax.Array,
    mask_add: jax.Array,
    num_heads: int,
    provider: Optional[str] = None,
    flash: bool = False,
    act_dtype: Optional[jnp.dtype] = None,
) -> jax.Array:
    """[B,T,E] → [B,T,E] through all encoder layers
    (slimt/Transformer.cc:57-69).

    Layers come either as a Python list (unrolled under jit) or as a
    stacked pytree with a leading layer axis (loader.stack_layers),
    which runs as one `lax.scan` — identical numerics, much smaller
    compiled program. `act_dtype` is the reduced-precision encoder
    mode (ModelConfig.encoder_dtype): the residual stream between
    blocks rides fp16/bf16; None = exact f32."""
    layers = params["encoder"]
    if isinstance(layers, list):
        x = word_embedding
        for layer in layers:
            x = encoder_layer_forward(
                layer, x, mask_add, num_heads, provider, flash=flash,
                act_dtype=act_dtype,
            )
        return x

    def step(x, layer):
        return (
            encoder_layer_forward(
                layer, x, mask_add, num_heads, provider, flash=flash,
                act_dtype=act_dtype,
            ),
            None,
        )

    x, _ = jax.lax.scan(step, word_embedding, layers)
    return x


def ssru_forward(
    rnn: dict, state: jax.Array, x: jax.Array, provider: Optional[str] = None
) -> Tuple[jax.Array, jax.Array]:
    """One SSRU step (slimt/Modules.cc:182-235).

    state: cell c(t-1), [B, 1, E]. Returns (h, c(t))."""
    f = jax.nn.sigmoid(_affine(rnn["wf"], x, provider))
    wx = qmm.dot(
        x, rnn["w"]["q"], rnn["w"]["aq"], rnn["w"]["bq"], provider=provider
    )
    # highway: c_t = σ(f)⊙c + (1-σ(f))⊙Wx (slimt/TensorOps.cc:662-682;
    # sigmoid already applied above).
    c_t = f * state + (1.0 - f) * wx
    y = jax.nn.relu(c_t)
    h = layer_norm(x + y, rnn["ln"])
    return h, c_t


def quantize_cross_kv(k: jax.Array, v: jax.Array, dtype) -> dict:
    """The joined-layout cache for one decoder layer from its K/V
    projections [B, T, E]: per-row (b, t) scales for the integer
    dtypes (and the mixed "k8v16"/"k16v8" tags), a plain cast for
    16-bit floats."""
    if dtype == jnp.int8:
        # Per-row (b, t) scales: each cached token row quantizes
        # against its own absmax. The inverse scales fold into the
        # decode step's existing elementwise dequants (see
        # _decode_attention_joined), so the finer granularity is
        # ~free — and lifts worst-case token agreement to bf16
        # levels (tests/test_stacked.py).
        kq = 127.0 / jnp.maximum(
            jnp.max(jnp.abs(k), axis=-1), 1e-6
        )  # [B, T]
        vq = 127.0 / jnp.maximum(jnp.max(jnp.abs(v), axis=-1), 1e-6)
        return {
            "k": qmm.quantize_activations(k, kq[..., None]),
            "v": qmm.quantize_activations(v, vq[..., None]),
            "kqi": 1.0 / kq,
            "vqi": 1.0 / vq,
        }
    if dtype == "k8v16":
        # Mixed cache: int8 K (score operand; int8 GEMM) + int16 V
        # (value mix; f32 GEMM) with per-row scales on both — 1.5
        # bytes/elem average (see _decode_attention_joined).
        kq = 127.0 / jnp.maximum(
            jnp.max(jnp.abs(k), axis=-1), 1e-6
        )  # [B, T]
        vq = 32767.0 / jnp.maximum(jnp.max(jnp.abs(v), axis=-1), 1e-6)
        return {
            "k": qmm.quantize_activations(k, kq[..., None]),
            "v": (
                jnp.clip(jnp.rint(v * vq[..., None]), -32767, 32767)
                .astype(jnp.int16)
            ),
            "kqi": 1.0 / kq,
            "vqi": 1.0 / vq,
        }
    if dtype == "k16v8":
        # Mixed cache, the REVERSE of k8v16: int16 K (the
        # argmax-sensitive score operand stays at int16 precision)
        # + int8 V (the value mix, whose per-row error dissolves
        # under the softmax weights) — 1.5 bytes/elem average.
        # k8v16 measured int8-CLASS agreement because K's score
        # perturbation flips near-tie argmaxes; this orientation
        # tests the converse hypothesis (see the Numerics table).
        kq = 32767.0 / jnp.maximum(
            jnp.max(jnp.abs(k), axis=-1), 1e-6
        )  # [B, T]
        vq = 127.0 / jnp.maximum(jnp.max(jnp.abs(v), axis=-1), 1e-6)
        return {
            "k": (
                jnp.clip(jnp.rint(k * kq[..., None]), -32767, 32767)
                .astype(jnp.int16)
            ),
            "v": qmm.quantize_activations(v, vq[..., None]),
            "kqi": 1.0 / kq,
            "vqi": 1.0 / vq,
        }
    if dtype == jnp.int16:
        # int16 with the same per-row (b, t) scales: 2 bytes/elem
        # (identical traffic to fp16/bf16) but a UNIFORM absolute
        # error of absmax/65534 per row — 16x finer than fp16's
        # relative rounding, ~256x finer than bf16. The cache
        # converts to f32 inside the attention matmul (there is
        # no s16 GEMM; the convert fuses into the operand read).
        # This is the
        # service default: 99.69% token agreement vs the reference
        # binary on the adversarial crosscheck serving sweep, vs
        # 99.00% fp16 / 96.83% bf16 at identical bandwidth
        # (crosscheck/serving_agreement.json).
        kq = 32767.0 / jnp.maximum(
            jnp.max(jnp.abs(k), axis=-1), 1e-6
        )  # [B, T]
        vq = 32767.0 / jnp.maximum(jnp.max(jnp.abs(v), axis=-1), 1e-6)

        def q16(x, s):
            return (
                jnp.clip(jnp.rint(x * s[..., None]), -32767, 32767)
                .astype(jnp.int16)
            )

        return {
            "k": q16(k, kq),
            "v": q16(v, vq),
            "kqi": 1.0 / kq,
            "vqi": 1.0 / vq,
        }
    one = jnp.float32(1.0)
    return {
        "k": k.astype(dtype),
        "v": v.astype(dtype),
        "kqi": one,
        "vqi": one,
    }



def precompute_cross_kv(
    params: dict,
    encoder_out: jax.Array,
    num_heads: int,
    provider: Optional[str] = None,
    dtype: Optional[jnp.dtype] = None,
) -> Tuple:
    """Per-decoder-layer (K, V) head-split projections of encoder_out.

    Computed once per batch; the reference redoes this every step
    (TODO at slimt/Modules.cc:248).

    `dtype=None` keeps the exact f32 path: pre-split [B,H,Tk,D] (K,V)
    pairs. A reduced-precision dtype (bfloat16 / int8) switches to the
    joined [B,Tk,E] layout consumed by _decode_attention_joined, which
    the decode loop re-reads every step (the dominant memory traffic
    at large batch). int8 caches quantize with
    per-row (b, t) scales — each cached token row against its own
    absmax (rint, clip to ±127); the inverse scales (`kqi`/`vqi`) ride
    in the joined-layout dict and fold into the decode step's existing
    elementwise dequants."""
    layers = params["decoder"]

    def project(layer):
        att = layer["att"]
        if dtype is None:
            k = _split_heads(
                _affine(att["k"], encoder_out, provider), num_heads
            )
            v = _split_heads(
                _affine(att["v"], encoder_out, provider), num_heads
            )
            return k, v
        return quantize_cross_kv(
            _affine(att["k"], encoder_out, provider),  # [B, T, E]
            _affine(att["v"], encoder_out, provider),
            dtype,
        )

    if isinstance(layers, list):
        return tuple(project(layer) for layer in layers)
    # stacked: leading [L] layer axis on every leaf — a (K, V) pair of
    # [L,B,H,T,D] for the exact f32 path, or a joined-layout dict of
    # [L,B,T,E] caches + per-layer [L] scales for bf16/int8.
    return jax.lax.map(project, layers)


def decoder_layer_forward(
    layer: dict,
    state: jax.Array,
    x: jax.Array,
    mask_add: jax.Array,
    kv_cache: Tuple[jax.Array, jax.Array],
    num_heads: int,
    provider: Optional[str] = None,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """SSRU → cross-attention → FFN (slimt/Modules.cc:237-259).
    Returns (out, new_state, cross_attn_weights)."""
    decoder_out, new_state = ssru_forward(layer["rnn"], state, x, provider)
    out, attn = attention_forward(
        layer["att"],
        decoder_out,
        None,
        None,
        mask_add,
        num_heads,
        provider,
        kv_cache=kv_cache,
    )
    return _ffn_block(layer, out, provider), new_state, attn


def decoder_step(
    params: dict,
    states: Sequence[jax.Array],
    prev_embed: jax.Array,
    mask_add: jax.Array,
    kv_caches: Tuple,
    num_heads: int,
    provider: Optional[str] = None,
    shortlist: Optional[jax.Array] = None,
    projection: Optional[Tuple[jax.Array, jax.Array]] = None,
    sample: bool = False,
    argmax_method: str = "exact",
) -> Tuple[jax.Array, Tuple, jax.Array]:
    """One decode timestep over all decoder layers + logit projection
    (slimt/Transformer.cc:120-183).

    prev_embed: already transformed [B, 1, E]. Returns
    (logits [B, V or S], new_states, guided_alignment [B, H, 1, Tk]
    from the last decoder layer). With `sample=True` the first element
    is instead the greedy choice [B] int32 (see output_argmax)."""
    x = prev_embed
    layers = params["decoder"]
    if isinstance(layers, list):
        new_states = []
        guided = None
        for layer, state, kv in zip(layers, states, kv_caches):
            x, new_state, attn = decoder_layer_forward(
                layer, state, x, mask_add, kv, num_heads, provider,
            )
            new_states.append(new_state)
            guided = attn
        new_states = tuple(new_states)
    else:
        # stacked form: scan over the layer axis of (layers, states, kv)
        def step(x, inputs):
            layer, state, kv = inputs
            y, new_state, attn = decoder_layer_forward(
                layer, state, x, mask_add, kv, num_heads, provider,
            )
            return y, (new_state, attn)

        x, (new_states, attns) = jax.lax.scan(
            step, x, (layers, states, kv_caches)
        )
        guided = attns[-1]
    if projection is None:
        projection = prepare_output_projection(params, shortlist)
    if sample:
        choice = output_argmax(
            params, x[:, 0, :], provider, projection, method=argmax_method
        )
        return choice, new_states, guided
    logits = output_logits(params, x[:, 0, :], provider, None, projection)
    return logits, new_states, guided


def prepare_output_projection(
    params: dict, shortlist: Optional[jax.Array] = None
) -> Tuple[jax.Array, jax.Array]:
    """(W [E, V or S], b) for the tied-embedding logit projection,
    with the shortlist column-select applied once — hoisted out of the
    decode loop (the gather+transpose is loop-invariant; the reference
    re-selects per call, qmm/Gemmology.inl.cc:83-98)."""
    emb_q = params["emb"]["q"]  # [V, E]
    bias = params["out"]["b"]
    if shortlist is not None:
        return (
            jnp.take(emb_q, shortlist, axis=0).T,
            jnp.take(bias, shortlist, axis=0),
        )
    return emb_q.T, bias


def output_logits(
    params: dict,
    x: jax.Array,
    provider: Optional[str] = None,
    shortlist: Optional[jax.Array] = None,
    projection: Optional[Tuple[jax.Array, jax.Array]] = None,
) -> jax.Array:
    """Tied-embedding logit projection: x [B,E] @ Wemb^T [E,V]
    (slimt/Transformer.cc:104-117). With a shortlist, only the selected
    rows of Wemb are multiplied (affine_with_select semantics).
    `projection` supplies a precomputed (W, b) pair."""
    if projection is None:
        projection = prepare_output_projection(params, shortlist)
    w, b = projection
    aq = params["out"]["aq"]
    bq = params["emb"]["scale"]
    return qmm.affine(x, w, b, aq, bq, provider=provider)


def packed_argmax_16(logits: jax.Array, dtype) -> jax.Array:
    """argmax(logits.astype(dtype), axis=-1) for a 16-bit IEEE-ordered
    float dtype (bfloat16 or float16), as ONE plain int32 max-reduce
    over a packed key: the sortable-int transform of the rounded logit
    bits in the high 16 bits, the reversed column index in the low 16
    (so equal rounded values resolve to the FIRST index — jnp.argmax's
    tie-break).

    Why: a single s32 max-reduce replaces XLA's variadic (value,
    index) argmax reduce over the int8 projection. The only numerics
    change is the 16-bit rounding of the COMPARED values: float16
    keeps 10 mantissa bits (8x fewer ties than bfloat16's 7) and is
    the service default — 99.79% token agreement vs the reference
    binary on the adversarial crosscheck serving sweep, vs 98.56% for
    bf16 keys (crosscheck/serving_agreement.json). Logits beyond
    float16 range
    (|x| > 65504) saturate to ±inf, which still orders correctly; a
    divergence needs >= 2 overflowing logits in one row, impossible
    for LN-bounded student-model logits.

    Requires logits.shape[-1] <= 65536 (the 32k vocab and every
    shortlist bucket qualify)."""
    lb = logits.astype(dtype)
    bits = jax.lax.bitcast_convert_type(lb, jnp.uint16).astype(jnp.int32)
    # Monotone 16-bit float -> [0, 0xFFFF]: flip all bits for
    # negatives, set the sign bit for positives (IEEE ordering is
    # sign-magnitude; both bf16 and fp16 qualify).
    sortable = jnp.where(bits >= 0x8000, 0xFFFF - bits, bits | 0x8000)
    col = jax.lax.broadcasted_iota(jnp.int32, logits.shape, logits.ndim - 1)
    # Bias into signed range BEFORE the shift (0x8000 << 16 would
    # overflow int32's sign bit and break the max-ordering).
    key = ((sortable - 0x8000) << 16) | (0xFFFF - col)
    best = jnp.max(key, axis=-1)
    return (0xFFFF - (best & 0xFFFF)).astype(jnp.int32)


def packed_argmax_bf16(logits: jax.Array) -> jax.Array:
    """Back-compat wrapper: packed argmax over bf16-rounded logits."""
    return packed_argmax_16(logits, jnp.bfloat16)


def packed_int_argmax(
    acc: jax.Array, b_i32: jax.Array, width_bits: int, shift: int
) -> jax.Array:
    """argmax over floor((acc + b_i32) / 2**shift) with first-index
    tie-break, as ONE plain int32 max-reduce over integer packed keys.

    The INT32-ACCUMULATOR-DOMAIN argmax: the logit projection's
    per-tensor scale s = 1/(aq·bq) is a positive scalar, so
    argmax(acc·s + b) = argmax(acc + b/s) — fold the bias into integer
    accumulator units once (b_i32 = rint(b·aq·bq), loop-invariant) and
    the whole float epilogue (i32→f32 convert, scale multiply, bias
    add, fp16 convert, bitcast, sortable transform) collapses to one
    integer add + shift before the same single s32 max-reduce
    packed_argmax_16 uses. `shift` drops low bits so the compared
    value and the reversed column index share an int32 key.

    Numerics vs the exact f32 argmax: only (a) the half-unit bias
    rounding and (b) the 2^shift truncation of compared values can
    flip a near-tie. At shortlist widths (width_bits ≤ 11 → shift ≈ 3
    for E=256) the comparison is ~32x FINER than packed_fp16's
    half-precision rounding near a full-scale max."""
    v = (acc + b_i32) >> shift  # arithmetic shift on int32
    col = jax.lax.broadcasted_iota(jnp.int32, acc.shape, acc.ndim - 1)
    mask_col = (1 << width_bits) - 1
    key = (v << width_bits) | (mask_col - col)
    best = jnp.max(key, axis=-1)
    return (mask_col - (best & mask_col)).astype(jnp.int32)


def packed_int_params(width: int, emb_dim: int) -> Tuple[int, int]:
    """(width_bits, shift) for packed_int_argmax: the reversed column
    index needs width_bits; the compared value gets the remaining
    int32 budget, so low bits are shifted off the conservative
    accumulator bound 2·E·127² (|int8 dot| ≤ E·127²; + the clipped
    bias)."""
    width_bits = max(1, (width - 1).bit_length())
    bound = 2 * emb_dim * 127 * 127 + 1
    value_bits = 31 - width_bits  # signed int32 key budget
    shift = max(0, bound.bit_length() - (value_bits - 1))
    return width_bits, shift


def output_argmax(
    params: dict,
    x: jax.Array,
    provider: Optional[str] = None,
    projection: Optional[Tuple[jax.Array, jax.Array]] = None,
    method: str = "exact",
) -> jax.Array:
    """argmax over the output logits, [B] int32 (greedy sampling,
    slimt/Transformer.cc:279-339).

    method="exact" (default): XLA logits + f32 variadic argmax
    (reference numerics; also the fallback when the provider is f32,
    which has no integer accumulator).

    method="packed_int": integer-domain packed argmax over the int32
    accumulators (packed_int_argmax — the declared serving config).

    method="packed_bf16"/"packed_fp16": the packed single-reduce
    argmax over 16-bit-float-rounded logits (packed_argmax_16)."""
    if projection is None:
        projection = prepare_output_projection(params)
    w, b = projection
    resolved = provider or qmm.default_provider()
    if method == "packed_int" and resolved == "xla_int8":
        # Integer-domain packed argmax: compare shifted int32
        # accumulators directly — no float epilogue at all (see
        # packed_int_argmax); agreement measured by the crosscheck
        # serving sweep.
        aq = params["out"]["aq"]
        bq = params["emb"]["scale"]
        x_q = qmm.quantize_activations(x, aq)
        acc = qmm._int8_matmul(x_q, w)
        e_dim, width = w.shape
        width_bits, shift = packed_int_params(width, e_dim)
        cap = e_dim * 127 * 127
        b_i32 = jnp.clip(
            jnp.rint(b.astype(jnp.float32) * (aq * bq)), -cap, cap
        ).astype(jnp.int32)
        return packed_int_argmax(acc, b_i32, width_bits, shift)
    logits = output_logits(params, x, provider, None, projection)
    if w.shape[1] <= 65536 and method in ("packed_bf16", "packed_fp16"):
        return packed_argmax_16(
            logits,
            jnp.float16 if method == "packed_fp16" else jnp.bfloat16,
        )
    return jnp.argmax(logits, axis=-1).astype(jnp.int32)


def make_additive_mask(mask: jax.Array) -> jax.Array:
    """0/1 mask [B, T] → additive form [B, 1, 1, T]
    ((1-m) * -1e8, slimt/Input.cc:49-63)."""
    return ((1.0 - mask) * MASK_MIN)[:, None, None, :]
