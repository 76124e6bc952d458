"""Translation-parity validation harness.

Modes (SURVEY.md §6: BLEU parity should be validated by running the
reference and the new engine on identical inputs):

  oracle     — decode a corpus with the JAX engine AND the independent
               NumPy oracle (tests/reference_impl.py, written from the
               reference C++ semantics); report exact-token agreement.
  providers  — xla_int8 vs f32 output agreement.
  bleu       — sacrebleu between two output files and a reference file
               (for when real models + reference-CLI outputs exist).

Usage:
    python scripts/parity.py oracle [--lines 64]
    python scripts/parity.py providers [--lines 64]
    python scripts/parity.py bleu hyp.txt ref.txt
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _build(provider="xla_int8", seed=0):
    import jax

    from slimt_jax.config import ModelConfig
    from slimt_jax.io import load_items
    from slimt_jax.io.loader import load_weights
    from slimt_jax.io.synthetic import synthetic_model_bytes

    config = ModelConfig(encoder_layers=3, decoder_layers=2, num_heads=4)
    config.qmm_provider = provider
    items = load_items(
        synthetic_model_bytes(
            config=config, vocab_size=512, emb_dim=64, ffn_dim=128, seed=seed
        )
    )
    params = load_weights(items, config)
    return config, params


def _corpus(lines, vocab=512, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(lines):
        n = int(rng.integers(4, 20))
        out.append(rng.integers(3, vocab, n).astype(np.int32))
    return out


def _decode_jax(
    config, params, batch_tokens, eos, max_steps, provider, shortlist=None,
    **options,
):
    import jax.numpy as jnp

    from slimt_jax.models.decode import translate_batch

    b = len(batch_tokens)
    t = max(len(x) for x in batch_tokens)
    indices = np.zeros((b, t), np.int32)
    mask = np.zeros((b, t), np.float32)
    for i, toks in enumerate(batch_tokens):
        indices[i, : len(toks)] = toks
        mask[i, : len(toks)] = 1.0
    result = translate_batch(
        params,
        jnp.asarray(indices),
        jnp.asarray(mask),
        eos_id=eos,
        max_steps=max_steps,
        num_heads=config.num_heads,
        provider=provider,
        shortlist=jnp.asarray(shortlist) if shortlist is not None else None,
        **options,
    )
    tokens = np.asarray(result.tokens)
    valid = np.asarray(result.valid)
    return [
        tokens[i][valid[i]].tolist() for i in range(b)
    ]


def mode_oracle(args):
    from tests import reference_impl as ref

    if getattr(args, "preset", "tiny") == "base":
        # base-model ratios scaled down: 6 enc / 2 dec / 8 heads.
        from slimt_jax.config import ModelConfig
        from slimt_jax.io import load_items
        from slimt_jax.io.loader import load_weights
        from slimt_jax.io.synthetic import synthetic_model_bytes

        config = ModelConfig(encoder_layers=6, decoder_layers=2, num_heads=8)
        items = load_items(
            synthetic_model_bytes(
                config=config, vocab_size=512, emb_dim=64, ffn_dim=256, seed=0
            )
        )
        params = load_weights(items, config)
    else:
        config, params = _build()
    corpus = _corpus(args.lines)
    eos, max_steps = 2, 24
    shortlist = (
        np.arange(0, 512, 2, dtype=np.int32)
        if getattr(args, "shortlist", False)
        else None
    )

    agree, total = _oracle_agree(
        config, params, corpus, eos, max_steps, shortlist,
        verbose=args.verbose,
    )
    print(f"oracle agreement: {agree}/{total} sentences exact-match")
    return 0 if agree == total else 1


def _oracle_agree(
    config, params, corpus, eos, max_steps, shortlist, verbose=False
):
    from tests import reference_impl as ref

    got = _decode_jax(
        config, params, corpus, eos, max_steps, "xla_int8",
        shortlist=shortlist,
    )
    agree = total = 0
    for i, toks in enumerate(corpus):
        indices = np.asarray(toks)[None, :]
        mask = np.ones_like(indices, np.float32)
        mask_add = ref.make_additive_mask(mask)
        enc = ref.encoder_forward(
            params,
            ref.transform_embedding(ref.embed(params, indices)),
            mask_add,
            config.num_heads,
        )
        want_tokens, want_valid, _ = ref.greedy_decode(
            params, enc, mask_add, eos, max_steps, config.num_heads,
            shortlist=shortlist,
        )
        want = want_tokens[0][want_valid[0]].tolist()
        total += 1
        if want == got[i]:
            agree += 1
        elif verbose:
            print(f"line {i}: jax={got[i]} oracle={want}")
    return agree, total


def mode_matrix(args):
    """Parity matrix: exact-match vs the NumPy oracle over a sweep of
    architectures × shortlist, one verdict per cell."""
    from slimt_jax.config import ModelConfig
    from slimt_jax.io import load_items
    from slimt_jax.io.loader import load_weights
    from slimt_jax.io.synthetic import synthetic_model_bytes

    cells = [
        # (label, enc, dec, heads, emb, ffn, seed)
        ("tiny-ratio 3/2/4", 3, 2, 4, 64, 128, 0),
        ("base-ratio 6/2/8", 6, 2, 8, 64, 256, 1),
        ("narrow 2/2/2", 2, 2, 2, 32, 64, 2),
        ("single 1/1/1", 1, 1, 1, 32, 64, 3),
        ("deep-dec 2/4/4", 2, 4, 4, 64, 128, 4),
    ]
    eos, max_steps = 2, 24
    failures = 0
    for label, enc, dec, heads, emb, ffn, seed in cells:
        config = ModelConfig(
            encoder_layers=enc, decoder_layers=dec, num_heads=heads
        )
        items = load_items(
            synthetic_model_bytes(
                config=config, vocab_size=512, emb_dim=emb, ffn_dim=ffn,
                seed=seed,
            )
        )
        params = load_weights(items, config)
        corpus = _corpus(args.lines, seed=seed + 10)
        for shortlist in (None, np.arange(0, 512, 2, dtype=np.int32)):
            agree, total = _oracle_agree(
                config, params, corpus, eos, max_steps, shortlist
            )
            tag = "shortlist" if shortlist is not None else "full-vocab"
            verdict = "OK" if agree == total else "FAIL"
            if agree != total:
                failures += 1
            print(f"{label:20s} {tag:10s} {agree}/{total} {verdict}")
    return 1 if failures else 0


def mode_providers(args):
    """Token agreement of the "f32" (dequantized float) provider with
    the "xla_int8" one. The two differ by the int8 activation
    quantization, so this reports a distance, not a parity gate."""
    corpus = _corpus(args.lines)
    eos, max_steps = 2, 24
    outputs = {}
    for provider in ("xla_int8", "f32"):
        config, params = _build(provider)
        outputs[provider] = _decode_jax(
            config, params, corpus, eos, max_steps, provider
        )
    agree = sum(
        1 for a, b in zip(outputs["xla_int8"], outputs["f32"]) if a == b
    )
    print(
        f"provider agreement (xla_int8 vs f32): {agree}/{len(corpus)}"
    )
    return 0


def mode_reduced(args):
    """Token-agreement statistics for the reduced-precision execution
    options vs the exact path, over several random-weight models ×
    corpora. Random weights produce near-tied logits — the WORST case
    for any reduced-precision option; trained models are far more
    peaked, so these numbers are lower bounds. Position-wise agreement
    is computed over the exact path's emitted positions.

    Options measured: kv_dtype ∈ {bfloat16, int8} (the joined-layout
    reduced-precision caches — the numerics behind the headline int8-KV
    default) and argmax=packed_bf16 (the single-reduce greedy sampler
    comparing bf16-rounded logits; models/transformer.py
    packed_argmax_bf16)."""
    eos, max_steps = 2, 24
    options = [
        ("kv=int16", dict(kv_dtype="int16")),
        ("kv=float16", dict(kv_dtype="float16")),
        ("kv=bfloat16", dict(kv_dtype="bfloat16")),
        ("kv=int8", dict(kv_dtype="int8")),
        ("argmax=packed_fp16", dict(argmax_method="packed_fp16")),
        ("argmax=packed_bf16", dict(argmax_method="packed_bf16")),
        ("serving default", dict(
            kv_dtype="int16", argmax_method="packed_fp16",
            with_alignment=False,
        )),
    ]
    stats = {label: [] for label, _ in options}
    for seed in range(args.models):
        config, params = _build(seed=seed)
        corpus = _corpus(args.lines, seed=seed + 100)
        want = _decode_jax(config, params, corpus, eos, max_steps, "xla_int8")
        for label, opts in options:
            got = _decode_jax(
                config, params, corpus, eos, max_steps, "xla_int8", **opts
            )
            matched = total = 0
            for w, g in zip(want, got):
                total += len(w)
                matched += sum(
                    1 for a, b in zip(w, g) if a == b
                )
            stats[label].append(matched / max(total, 1))
    failures = 0
    for label, rates in stats.items():
        mean, worst = float(np.mean(rates)), float(np.min(rates))
        verdict = "OK" if worst >= args.threshold else "FAIL"
        if worst < args.threshold:
            failures += 1
        print(
            f"{label:22s} mean {mean:.3f}  worst {worst:.3f} "
            f"over {args.models} models x {args.lines} lines  {verdict}"
        )
    return 1 if failures else 0


def mode_bleu(args):
    import sacrebleu

    with open(args.hypothesis) as f:
        hyp = [line.rstrip("\n") for line in f]
    with open(args.reference) as f:
        refs = [line.rstrip("\n") for line in f]
    score = sacrebleu.corpus_bleu(hyp, [refs])
    print(score)
    return 0


def main():
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="mode", required=True)
    o = sub.add_parser("oracle")
    o.add_argument("--lines", type=int, default=64)
    o.add_argument("--verbose", action="store_true")
    o.add_argument("--shortlist", action="store_true")
    o.add_argument("--preset", choices=["tiny", "base"], default="tiny")
    o.set_defaults(fn=mode_oracle)
    p = sub.add_parser("providers")
    p.add_argument("--lines", type=int, default=64)
    p.set_defaults(fn=mode_providers)
    m = sub.add_parser("matrix")
    m.add_argument("--lines", type=int, default=16)
    m.set_defaults(fn=mode_matrix)
    r = sub.add_parser("reduced")
    r.add_argument("--lines", type=int, default=32)
    r.add_argument("--models", type=int, default=5)
    r.add_argument("--threshold", type=float, default=0.8)
    r.set_defaults(fn=mode_reduced)
    b = sub.add_parser("bleu")
    b.add_argument("hypothesis")
    b.add_argument("reference")
    b.set_defaults(fn=mode_bleu)
    args = parser.parse_args()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
