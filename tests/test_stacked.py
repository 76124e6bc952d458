"""Stacked-layer (lax.scan) form matches the unrolled form exactly."""

import numpy as np
import pytest

import jax.numpy as jnp

from slimt_jax.config import ModelConfig
from slimt_jax.io import load_items
from slimt_jax.io.loader import load_weights, stack_layers
from slimt_jax.io.synthetic import synthetic_model_bytes
from slimt_jax.models import decode as dec

CONFIG = ModelConfig(encoder_layers=3, decoder_layers=2, num_heads=4)
VOCAB, EMB, FFN = 96, 32, 64


@pytest.fixture(scope="module")
def params():
    items = load_items(
        synthetic_model_bytes(
            config=CONFIG, vocab_size=VOCAB, emb_dim=EMB, ffn_dim=FFN, seed=7
        )
    )
    return load_weights(items, CONFIG)


def _batch(seed=3):
    rng = np.random.default_rng(seed)
    b, t = 3, 10
    indices = rng.integers(1, VOCAB, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.float32)
    mask[1, -3:] = 0.0
    return indices, mask


def _run(params, indices, mask, shortlist=None, **options):
    return dec.translate_batch(
        params,
        jnp.asarray(indices),
        jnp.asarray(mask),
        eos_id=2,
        max_steps=12,
        num_heads=CONFIG.num_heads,
        provider="xla_int8",
        shortlist=jnp.asarray(shortlist) if shortlist is not None else None,
        **options,
    )


def test_stacked_matches_unrolled(params):
    indices, mask = _batch()
    want = _run(params, indices, mask)
    got = _run(stack_layers(params), indices, mask)
    np.testing.assert_array_equal(np.asarray(got.valid), np.asarray(want.valid))
    np.testing.assert_array_equal(
        np.asarray(got.tokens), np.asarray(want.tokens)
    )
    np.testing.assert_allclose(
        np.asarray(got.alignment), np.asarray(want.alignment), atol=1e-5
    )


def test_stacked_with_shortlist(params):
    indices, mask = _batch(seed=5)
    shortlist = np.arange(0, VOCAB, 2, dtype=np.int32)
    want = _run(params, indices, mask, shortlist)
    got = _run(stack_layers(params), indices, mask, shortlist)
    np.testing.assert_array_equal(
        np.asarray(got.tokens), np.asarray(want.tokens)
    )


def test_kv_dtype_bfloat16_decodes(params):
    """bf16 KV cache path: same structure, tokens may differ slightly
    from f32 (reduced precision) but decode must complete and stay
    deterministic."""
    indices, mask = _batch(seed=9)
    stacked = stack_layers(params)
    a = dec.translate_batch(
        stack_layers(params), jnp.asarray(indices), jnp.asarray(mask),
        eos_id=2, max_steps=10, num_heads=CONFIG.num_heads,
        provider="xla_int8", kv_dtype="bfloat16",
    )
    b = dec.translate_batch(
        stacked, jnp.asarray(indices), jnp.asarray(mask),
        eos_id=2, max_steps=10, num_heads=CONFIG.num_heads,
        provider="xla_int8", kv_dtype="bfloat16",
    )
    np.testing.assert_array_equal(np.asarray(a.tokens), np.asarray(b.tokens))
    assert np.asarray(a.valid).any()


@pytest.mark.parametrize(
    "kv_dtype,floor",
    [("int16", 0.95), ("k8v16", 0.9), ("k16v8", 0.95), ("float16", 0.95),
     ("bfloat16", 0.9), ("int8", 0.9)],
)
def test_reduced_kv_agrees_with_f32(params, kv_dtype, floor):
    """The joined-layout reduced-precision KV cache (fp16/bf16/int8
    with selector-matrix GEMM attention) decodes nearly the same tokens
    as the exact f32 split-layout path — both unrolled and stacked,
    with and without a shortlist. Random-weight models have near-tied
    logits (worst case for reduced precision), so assert a high
    agreement rate rather than exact equality; trained models are far
    more peaked. Cross-implementation agreement vs the reference
    binary (4 architectures x 2048 sentences per config) lives in
    crosscheck/serving_agreement.json — int16 (the service default)
    measured 99.69% tokens there."""
    indices, mask = _batch(seed=11)
    shortlist = np.arange(0, VOCAB, 3, dtype=np.int32)
    for p in (params, stack_layers(params)):
        for sl in (None, shortlist):
            want = dec.translate_batch(
                p, jnp.asarray(indices), jnp.asarray(mask),
                eos_id=2, max_steps=12, num_heads=CONFIG.num_heads,
                provider="xla_int8",
                shortlist=jnp.asarray(sl) if sl is not None else None,
            )
            got = dec.translate_batch(
                p, jnp.asarray(indices), jnp.asarray(mask),
                eos_id=2, max_steps=12, num_heads=CONFIG.num_heads,
                provider="xla_int8",
                shortlist=jnp.asarray(sl) if sl is not None else None,
                kv_dtype=kv_dtype,
            )
            agree = (
                np.asarray(got.tokens) == np.asarray(want.tokens)
            ).mean()
            assert agree >= floor, f"token agreement {agree} (sl={sl is not None})"
            assert np.asarray(got.valid).any()


def test_encoder_only_stacking(params):
    """stack_layers(decoder=False) — the SERVICE's form for non-int8
    KV configs (stacked encoder for compile speed, unrolled 2-layer
    decoder for step speed; models/model.py) — must decode
    bit-identically to both the unrolled and fully stacked forms."""
    indices, mask = _batch(seed=14)
    want = _run(params, indices, mask)
    got = _run(stack_layers(params, decoder=False), indices, mask)
    np.testing.assert_array_equal(
        np.asarray(got.tokens), np.asarray(want.tokens)
    )
    np.testing.assert_array_equal(
        np.asarray(got.valid), np.asarray(want.valid)
    )


@pytest.mark.parametrize(
    "method,rdtype",
    [("packed_fp16", jnp.float16), ("packed_bf16", jnp.bfloat16)],
)
def test_packed_argmax_decode_divergence_only_on_ties(
    params, method, rdtype
):
    """The 16-bit-float packed argmax methods (the r3/r4 service
    default; packed_int superseded them as the default in round 5)
    equal argmax over ROUNDED logits exactly (exhaustive
    kernel tests in test_packed_argmax.py). Certify that property ON
    REAL DECODE TRAJECTORIES through the fused projection+argmax path:
    walk the decode step by step, continuing with the packed choices,
    and at EVERY step assert the fused sample's pick equals
    argmax(rounded(logits)) — so any divergence from the exact f32
    argmax is a genuine rounding tie, never a plumbing bug. This is a
    per-step invariant, not an agreement floor (cross-implementation
    agreement numbers vs the reference binary live in
    crosscheck/serving_agreement.json)."""
    import math

    from slimt_jax.models import transformer as tfm

    indices, mask = _batch(seed=9)
    shortlist = np.arange(0, VOCAB, 3, dtype=np.int32)
    emb_dim = EMB
    sqrt_e = math.sqrt(emb_dim)
    signal0 = tfm.sinusoidal_signal(0, 1, emb_dim)
    for p in (params, stack_layers(params)):
        for sl in (None, shortlist):
            sl_j = jnp.asarray(sl) if sl is not None else None
            word_embedding = tfm.transform_embedding(
                tfm.embed(p, jnp.asarray(indices))
            )
            mask_add = tfm.make_additive_mask(jnp.asarray(mask))
            encoder_out = tfm.encoder_forward(
                p, word_embedding, mask_add, CONFIG.num_heads, "xla_int8"
            )
            kv = tfm.precompute_cross_kv(
                p, encoder_out, CONFIG.num_heads, "xla_int8"
            )
            projection = tfm.prepare_output_projection(p, sl_j)
            if isinstance(p["decoder"], list):
                states = tuple(
                    jnp.zeros((indices.shape[0], 1, emb_dim), jnp.float32)
                    for _ in p["decoder"]
                )
            else:
                n_layers = p["decoder"]["rnn"]["ln"]["scale"].shape[0]
                states = jnp.zeros(
                    (n_layers, indices.shape[0], 1, emb_dim), jnp.float32
                )
            prev = jnp.zeros((indices.shape[0],), jnp.int32)
            divergences = 0
            for step in range(8):
                prev_embed = tfm.embed(p, prev[:, None])
                if step == 0:
                    prev_embed = jnp.zeros_like(prev_embed)
                x = prev_embed * sqrt_e + signal0
                common = dict(
                    mask_add=mask_add, kv_caches=kv,
                    num_heads=CONFIG.num_heads, provider="xla_int8",
                    shortlist=sl_j, projection=projection,
                )
                logits, _, _ = tfm.decoder_step(
                    p, states, x, sample=False, **common
                )
                choice, states, _ = tfm.decoder_step(
                    p, states, x, sample=True,
                    argmax_method=method, **common
                )
                logits_np = np.asarray(logits, np.float32)
                choice_np = np.asarray(choice)
                # The invariant: the fused pick IS the rounded argmax.
                want = np.asarray(
                    jnp.argmax(logits.astype(rdtype), axis=-1)
                )
                np.testing.assert_array_equal(choice_np, want)
                exact = logits_np.argmax(axis=-1)
                for b in range(logits_np.shape[0]):
                    if exact[b] == choice_np[b]:
                        continue
                    divergences += 1
                    # Divergence sanity: f32 prefers `exact`, the
                    # rounding must prefer-or-tie `choice` — a genuine
                    # tie within one rounding quantum.
                    le, lc = logits_np[b, exact[b]], logits_np[b, choice_np[b]]
                    assert le >= lc
                    assert jnp.asarray(le, rdtype) <= jnp.asarray(
                        lc, rdtype
                    )
                word = (
                    np.asarray(sl)[choice_np]
                    if sl is not None
                    else choice_np
                )
                prev = jnp.asarray(word.astype(np.int32))
            # The invariant held at every step (asserted above);
            # divergences themselves are allowed and expected on
            # random-weight near-tied logits.


def test_packed_int_decode_divergence_bounded_by_quantum(params):
    """packed_int (the round-5 service default) on REAL DECODE
    TRAJECTORIES: walk the decode continuing with the packed_int
    choices; wherever the pick diverges from the exact f32 argmax,
    the two logits must lie within the method's comparison quantum —
    (2^shift truncation + 0.5-unit bias rounding + 0.5-unit argmax-
    path quantization skew) × the per-tensor scale — i.e. a genuine
    near-tie, never a plumbing bug. (The exact key-level invariant is
    exhaustively certified in test_packed_argmax.py; agreement vs the
    reference binary in crosscheck/serving_agreement.json.)"""
    import math

    from slimt_jax.models import transformer as tfm

    indices, mask = _batch(seed=21)
    shortlist = np.arange(0, VOCAB, 3, dtype=np.int32)
    emb_dim = EMB
    sqrt_e = math.sqrt(emb_dim)
    signal0 = tfm.sinusoidal_signal(0, 1, emb_dim)
    p = stack_layers(params)
    aq = float(np.asarray(p["out"]["aq"]))
    bq = float(np.asarray(p["emb"]["scale"]))
    scale = 1.0 / (aq * bq)  # one accumulator unit in logit units
    for sl in (None, shortlist):
        sl_j = jnp.asarray(sl) if sl is not None else None
        width = len(sl) if sl is not None else VOCAB
        _, shift = tfm.packed_int_params(width, emb_dim)
        quantum = ((1 << shift) + 1.0) * scale
        word_embedding = tfm.transform_embedding(
            tfm.embed(p, jnp.asarray(indices))
        )
        mask_add = tfm.make_additive_mask(jnp.asarray(mask))
        encoder_out = tfm.encoder_forward(
            p, word_embedding, mask_add, CONFIG.num_heads, "xla_int8"
        )
        kv = tfm.precompute_cross_kv(
            p, encoder_out, CONFIG.num_heads, "xla_int8"
        )
        projection = tfm.prepare_output_projection(p, sl_j)
        n_layers = p["decoder"]["rnn"]["ln"]["scale"].shape[0]
        states = jnp.zeros(
            (n_layers, indices.shape[0], 1, emb_dim), jnp.float32
        )
        prev = jnp.zeros((indices.shape[0],), jnp.int32)
        for step in range(8):
            prev_embed = tfm.embed(p, prev[:, None])
            if step == 0:
                prev_embed = jnp.zeros_like(prev_embed)
            x = prev_embed * sqrt_e + signal0
            common = dict(
                mask_add=mask_add, kv_caches=kv,
                num_heads=CONFIG.num_heads, provider="xla_int8",
                shortlist=sl_j, projection=projection,
            )
            logits, _, _ = tfm.decoder_step(
                p, states, x, sample=False, **common
            )
            choice, states, _ = tfm.decoder_step(
                p, states, x, sample=True,
                argmax_method="packed_int", **common
            )
            logits_np = np.asarray(logits, np.float32)
            choice_np = np.asarray(choice)
            exact = logits_np.argmax(axis=-1)
            for b in range(logits_np.shape[0]):
                if exact[b] == choice_np[b]:
                    continue
                gap = (
                    logits_np[b, exact[b]] - logits_np[b, choice_np[b]]
                )
                assert 0 <= gap <= quantum, (
                    f"divergence beyond the packed_int quantum: "
                    f"{gap} > {quantum} (step {step}, row {b})"
                )
            word = (
                np.asarray(sl)[choice_np] if sl is not None else choice_np
            )
            prev = jnp.asarray(word.astype(np.int32))


def test_without_alignment_tokens_identical(params):
    """with_alignment=False (requests without Options.alignment/html)
    drops the alignment carry from the decode loop — tokens/valid must
    be bit-identical to the full variant, and the alignment result
    collapses to zero width."""
    indices, mask = _batch(seed=12)
    stacked = stack_layers(params)
    kw = dict(
        eos_id=2, max_steps=12, num_heads=CONFIG.num_heads,
        provider="xla_int8",
    )
    for p in (params, stacked):
        for kv_dtype in (None, "int8"):
            want = dec.translate_batch(
                p, jnp.asarray(indices), jnp.asarray(mask),
                kv_dtype=kv_dtype, **kw
            )
            got = dec.translate_batch(
                p, jnp.asarray(indices), jnp.asarray(mask),
                kv_dtype=kv_dtype, with_alignment=False, **kw
            )
            np.testing.assert_array_equal(
                np.asarray(got.tokens), np.asarray(want.tokens)
            )
            np.testing.assert_array_equal(
                np.asarray(got.valid), np.asarray(want.valid)
            )
            assert got.alignment.shape == (indices.shape[0], 12, 0)


def test_flash_attention_flag_through_translate(params):
    indices, mask = _batch(seed=10)
    stacked = stack_layers(params)
    want = dec.translate_batch(
        stacked, jnp.asarray(indices), jnp.asarray(mask),
        eos_id=2, max_steps=8, num_heads=CONFIG.num_heads,
        provider="xla_int8",
    )
    got = dec.translate_batch(
        stacked, jnp.asarray(indices), jnp.asarray(mask),
        eos_id=2, max_steps=8, num_heads=CONFIG.num_heads,
        provider="xla_int8", flash_attention=True,
    )
    # encoder flash path is numerically very close; greedy tokens match
    np.testing.assert_array_equal(
        np.asarray(got.tokens), np.asarray(want.tokens)
    )


def test_decoder_position_zero_false(params):
    """Marian-style per-position decoder signal (the reference's
    behavior uses position 0 every step; the flag restores marian's)."""
    indices, mask = _batch(seed=11)
    stacked = stack_layers(params)
    ref_mode = dec.translate_batch(
        stacked, jnp.asarray(indices), jnp.asarray(mask),
        eos_id=2, max_steps=10, num_heads=CONFIG.num_heads,
        provider="xla_int8", decoder_position_zero=True,
    )
    marian_mode = dec.translate_batch(
        stacked, jnp.asarray(indices), jnp.asarray(mask),
        eos_id=2, max_steps=10, num_heads=CONFIG.num_heads,
        provider="xla_int8", decoder_position_zero=False,
    )
    # both decode; outputs (generally) differ from step 2 onward
    assert np.asarray(ref_mode.valid).any()
    assert np.asarray(marian_mode.valid).any()
    np.testing.assert_array_equal(  # step 0 identical (position 0)
        np.asarray(ref_mode.tokens)[:, 0], np.asarray(marian_mode.tokens)[:, 0]
    )


@pytest.mark.parametrize("unroll", [2, 3])
def test_loop_unroll_bit_exact(params, unroll):
    """greedy_decode's loop_unroll (N steps per while_loop iteration)
    must be
    BIT-exact vs unroll=1 — including odd max_steps (buffer-padding
    tails) and a traced steps_cap that is not a multiple of the
    unroll factor."""
    indices, mask = _batch(seed=21)
    for max_steps, cap in ((8, None), (9, None), (9, 7)):
        kw = dict(
            eos_id=2, max_steps=max_steps, num_heads=CONFIG.num_heads,
            provider="xla_int8",
            steps_cap=None if cap is None else jnp.asarray(cap),
        )
        want = dec.translate_batch(
            params, jnp.asarray(indices), jnp.asarray(mask),
            **kw, loop_unroll=1,
        )
        got = dec.translate_batch(
            params, jnp.asarray(indices), jnp.asarray(mask),
            **kw, loop_unroll=unroll,
        )
        np.testing.assert_array_equal(
            np.asarray(got.tokens), np.asarray(want.tokens)
        )
        np.testing.assert_array_equal(
            np.asarray(got.valid), np.asarray(want.valid)
        )
        np.testing.assert_allclose(
            np.asarray(got.alignment), np.asarray(want.alignment)
        )
