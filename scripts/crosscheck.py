"""Reference-binary differential harness driver.

Diffs slimt_jax's decode output against the ACTUAL reference C++
implementation (compiled verbatim from /root/reference/slimt into
crosscheck/bin/slimt_ref_harness — see crosscheck/Makefile for what is
genuine reference code vs. thin third-party shims).  This converts the
repo's parity story from self-agreement with a builder-written NumPy
oracle into cross-implementation evidence:

  - the marian .bin + SPM packages are written by THIS repo's writers
    and parsed by the reference's Io.cc/Vocabulary.cc;
  - the shortlist file is read and expanded by the reference's
    Shortlist.cc (diffed directly in `shortlist` mode);
  - greedy decode tokens come from the reference's Transformer.cc /
    Modules.cc / TensorOps.cc / qmm (Ruy provider semantics).

Measured agreement (see tests/test_crosscheck.py): full-vocab greedy
decode is 100% token-exact across every architecture cell and batch
size, despite the candidate deltas (reference ruy quantizes
activations with roundf vs slimt_jax's rint; system-BLAS vs XLA:CPU
f32 accumulation order) — none of them flip an argmax on these shapes.

Shortlisted decode is exact once the logit bias is zeroed; with a
nonzero bias the reference's Ruy provider itself diverges from its
intgemm/gemmology providers: qmm/Ruy.inl.cc:169-176 computes
`selected_bias` but line 195-199 passes the UNSELECTED `prepared_bias`
to unquantizeAddBias, adding bias[packed_index] instead of
bias[shortlist[packed_index]].  slimt_jax selects the bias like the
intgemm/gemmology providers (qmm/Gemmology.inl.cc:151-169) — the
providers real x86 deployments use.  The tokens mode therefore runs
shortlist cells with a zeroed logit bias (isolating everything else)
and separately QUANTIFIES the reference-Ruy bias bug's impact with the
natural bias (`ruy-bias-bug` line).

Modes:
  tokens     — per-sentence exact-match + token-level agreement over a
               matrix of architectures × {full-vocab, shortlist},
               B=1 and batched; divergences auto-attributed via the
               roundf-patched oracle.
  shortlist  — diff ShortlistGenerator.generate outputs directly.
  split      — sentence boundaries vs the real-PCRE2 Splitter.cc.
  process    — TextProcessor segments + AnnotatedText byte ranges
               (same tokenizer both sides; isolates wrap/EOS/
               annotation semantics).
  e2e        — the COMPLETE reference slimt-cli (app/main.cc + full
               Frontend/Batcher/Request/Response service layer,
               compiled verbatim) vs `python -m slimt_jax translate`:
               text in, translated text out, exact string compare,
               incl. --html markup transfer (tag skeleton exact; tag
               position may move on f32 attention ties).
  all        — everything (default); exits non-zero below floors.

Usage:
  JAX_PLATFORMS=cpu python scripts/crosscheck.py
      [all|tokens|shortlist|split|process] [--lines 48] [--verbose]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

HARNESS = os.path.join(ROOT, "crosscheck", "bin", "slimt_ref_harness")

# (label, enc, dec, heads, emb, ffn, seed) — mirrors parity.py matrix
# plus the tiny11-ratio cell.
CELLS = [
    ("tiny-ratio 3/2/4", 3, 2, 4, 64, 128, 0),
    ("base-ratio 6/2/8", 6, 2, 8, 64, 256, 1),
    ("narrow 2/2/2", 2, 2, 2, 32, 64, 2),
    ("deep-dec 2/4/4", 2, 4, 4, 64, 128, 4),
]
# The serving sweep adds a REPEATED-NEAR-TIE stress cell: a wide
# logit-bias spread was built hoping to emulate a trained model's peaked logits, but MEASURED HARDER than
# the adversarial cells — with the bias dominating, the SAME top-2
# contest (fixed bias gap ~0.6 at V=512 order statistics) repeats
# every decode step, re-rolling the f32-accumulation-order dice each
# time: even the EXACT path drops to ~99.0% tokens here (vs its
# 99.6% adversarial worst cell). Kept and reported separately because
# it bounds something the adversarial aggregate cannot: on the
# hardest cell, the DECLARED config's excess divergence over the
# exact path's own ceiling is ~0.5pp — reduced precision degrades
# gracefully exactly where f32-order noise is already flipping
# argmaxes. Genuinely peaked (trained-weight) agreement remains
# blocked on real checkpoints (fold into the BLEU harness when a
# model tarball lands). Both sides consume the same transformed .bin.
PEAKED_CELL = ("STRESS repeated-near-tie 3/2/4", 3, 2, 4, 64, 128, 9)
PEAKED_BIAS_SCALE = 40.0  # bias std 0.05 -> 2.0: bias-dominated contests
VOCAB = 512


def build_harness() -> None:
    subprocess.run(
        ["make", "-C", os.path.join(ROOT, "crosscheck")],
        check=True,
        capture_output=True,
    )


def write_package(tmp, enc, dec, heads, emb, ffn, seed, bias_scale=None):
    """Synthetic .bin/.spm/.shortlist package readable by both sides.

    `bias_scale` multiplies decoder_ff_logit_out_b (the STRESS cell:
    a bias-dominated repeated top-2 contest — see PEAKED_CELL note)."""
    from slimt_jax.config import ModelConfig
    from slimt_jax.io.shortlist import build_synthetic_shortlist
    from slimt_jax.io.synthetic import synthetic_model_bytes
    from slimt_jax.text import spm_proto
    from slimt_jax.text.synthetic_vocab import build_spm_model

    config = ModelConfig(
        encoder_layers=enc, decoder_layers=dec, num_heads=heads
    )
    model_bytes = synthetic_model_bytes(
        config=config, vocab_size=VOCAB, emb_dim=emb, ffn_dim=ffn, seed=seed
    )
    if bias_scale is not None:
        from slimt_jax.io import marian

        items = marian.load_items(model_bytes)
        for item in items:
            if item.name == "decoder_ff_logit_out_b":
                item.array = (item.array * bias_scale).astype(np.float32)
        model_bytes = marian.save_items(items)
    # Exactly VOCAB pieces: the reference's greedy_sample strides its
    # logits buffer by Vocabulary::size() (Transformer.cc:282), so the
    # SPM piece count must equal the model's output vocab exactly.
    spm = build_spm_model([], target_size=0)
    base = list(spm.pieces)
    extra = [
        spm_proto.Piece(f"▁w{i}", -float(i + 2), spm_proto.PIECE_NORMAL)
        for i in range(VOCAB - len(base))
    ]
    spm = dataclasses.replace(spm, pieces=base + extra)
    assert len(spm.pieces) == VOCAB, len(spm.pieces)
    paths = {}
    for name, payload in (
        ("model.bin", model_bytes),
        ("vocab.spm", spm_proto.serialize_model(spm)),
        ("shortlist.bin", build_synthetic_shortlist(VOCAB, seed=seed)),
    ):
        paths[name] = os.path.join(tmp, f"{seed}-{name}")
        with open(paths[name], "wb") as f:
            f.write(payload)
    return config, model_bytes, spm, paths


def zero_logit_bias(model_bytes):
    """Re-serialize with decoder_ff_logit_out_b zeroed (isolates the
    reference Ruy provider's unselected-bias bug in shortlist cells —
    see module docstring)."""
    from slimt_jax.io import marian

    items = marian.load_items(model_bytes)
    for item in items:
        if item.name == "decoder_ff_logit_out_b":
            item.array = np.zeros_like(item.array)
    return marian.save_items(items)


def corpus(lines, eos, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(lines):
        n = int(rng.integers(4, 20))
        ids = rng.integers(2, VOCAB, n).astype(np.uint32).tolist()
        ids.append(eos)
        out.append(ids)
    return out


def run_reference(paths, config, sentences, batch, with_shortlist,
                  dump_shortlist=False):
    cmd = [
        HARNESS,
        "--model", paths["model.bin"],
        "--vocab", paths["vocab.spm"],
        "--enc", str(config.encoder_layers),
        "--dec", str(config.decoder_layers),
        "--heads", str(config.num_heads),
        "--batch", str(batch),
    ]
    if with_shortlist or dump_shortlist:
        cmd += ["--shortlist", paths["shortlist.bin"]]
    if dump_shortlist:
        cmd += ["--dump-shortlist"]
    text = "\n".join(" ".join(str(w) for w in s) for s in sentences) + "\n"
    proc = subprocess.run(
        cmd, input=text, capture_output=True, text=True, check=True
    )
    for line in proc.stderr.splitlines():
        if "warn" in line:
            raise RuntimeError(f"reference load warning: {line}")
    return [
        [int(tok) for tok in line.split()]
        for line in proc.stdout.splitlines()
    ]


def run_slimt_jax(model_bytes, config, sentences, batch, eos, pad,
                  shortlist_gen, kv_dtype="float32", argmax_method="exact",
                  with_alignment=True, encoder_dtype=None):
    """Decode through slimt_jax. Defaults are the EXACT numerics
    (f32 KV cache, f32 variadic argmax — reference
    Transformer.cc:279-339 semantics); the serving mode overrides
    kv_dtype/argmax_method/with_alignment to diff the
    reduced-precision execution configs against the same reference
    outputs."""
    import functools

    import jax
    import jax.numpy as jnp

    from slimt_jax import device
    from slimt_jax.io import load_items
    from slimt_jax.io.loader import load_weights
    from slimt_jax.models.decode import translate_batch

    params = load_weights(load_items(model_bytes), config)
    # ONE jit wrapper (max_steps static): executables are cached per
    # (shapes, max_steps) inside it and freed with it — an eager
    # translate_batch here re-traces and permanently caches a fresh
    # while_loop per CALL, which at serving-sweep scale (16k calls)
    # both recompiles everything and leaks to OOM. The jitted form is
    # the one the service itself runs (models/model.py
    # translate_batch_jit) — byte-identical to the reference through
    # the e2e CLI differential.
    fn = device.jit(
        functools.partial(
            translate_batch,
            eos_id=eos,
            num_heads=config.num_heads,
            kv_dtype=kv_dtype,
            argmax_method=argmax_method,
            with_alignment=with_alignment,
            encoder_dtype=encoder_dtype,
        ),
        static_argnames=("max_steps",),
    )
    out = []
    for start in range(0, len(sentences), batch):
        group = sentences[start : start + batch]
        t = max(len(s) for s in group)
        indices = np.full((len(group), t), pad, np.int32)
        mask = np.zeros((len(group), t), np.float32)
        for i, toks in enumerate(group):
            indices[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1.0
        shortlist = None
        if shortlist_gen is not None:
            flat = [w for s in group for w in s]
            sl = shortlist_gen.generate(flat).astype(np.int32)
            # Pad the width to a multiple of 64 with DUPLICATES of an
            # existing entry — semantics-preserving (a duplicate column
            # carries an identical logit; whichever copy wins any tie
            # maps to the same word id, and both argmax methods break
            # ties first-index), unlike the service's generate_padded
            # which adds real extra candidates. Bounds the number of
            # compiled shortlist shapes.
            want = -(-len(sl) // 64) * 64
            if want > len(sl):
                sl = np.concatenate(
                    [sl, np.full(want - len(sl), sl[0], np.int32)]
                )
            shortlist = jnp.asarray(sl)
        result = fn(
            params,
            jnp.asarray(indices),
            jnp.asarray(mask),
            max_steps=int(1.5 * t),
            shortlist=shortlist,
        )
        tokens = np.asarray(result.tokens)
        valid = np.asarray(result.valid)
        out.extend(tokens[i][valid[i]].tolist() for i in range(len(group)))
    return out


def diff(name, ref, got, verbose):
    sent_total = len(ref)
    sent_exact = 0
    tok_total = tok_agree = 0
    divergent = []
    for i, (r, g) in enumerate(zip(ref, got)):
        if r == g:
            sent_exact += 1
        else:
            divergent.append(i)
            if verbose:
                print(f"  line {i}: ref={r}\n          ours={g}")
        # Token-level: agreement over the aligned prefix + count length
        # mismatch as disagreement.
        n = max(len(r), len(g))
        tok_total += n
        tok_agree += sum(1 for a, b in zip(r, g) if a == b)
    pct_sent = 100.0 * sent_exact / max(1, sent_total)
    pct_tok = 100.0 * tok_agree / max(1, tok_total)
    print(
        f"{name:34s} sentences {sent_exact}/{sent_total} ({pct_sent:.1f}%)"
        f"  tokens {tok_agree}/{tok_total} ({pct_tok:.1f}%)"
    )
    return pct_sent, pct_tok, divergent


def roundf_decode(model_bytes, config, sentence, eos, max_steps, shortlist):
    """Decode one sentence with the NumPy oracle patched to roundf
    (half-away-from-zero) activation quantization — the reference Ruy
    provider's rounding (qmm/Ruy.inl.cc:14).  slimt_jax uses rint
    (half-even, = x86 cvtps2dq, the intgemm/gemmology rounding); the
    reference's own providers disagree with each other on exact-half
    activations, so a divergence reproduced by this decode is the two
    PROVIDERS' delta, not an engine bug."""
    import unittest.mock as mock

    from slimt_jax.io import load_items
    from slimt_jax.io.loader import load_weights
    from tests import reference_impl as ri

    def quantize_roundf(x, mult):
        a = x.astype(np.float32) * mult
        half = np.where(a >= 0, np.float32(0.5), np.float32(-0.5))
        return np.clip(np.trunc(a + half), -127, 127).astype(np.int8)

    params = load_weights(load_items(model_bytes), config)
    indices = np.asarray(sentence)[None, :]
    mask_add = ri.make_additive_mask(np.ones_like(indices, np.float32))
    with mock.patch.object(ri, "quantize", quantize_roundf):
        enc = ri.encoder_forward(
            params,
            ri.transform_embedding(ri.embed(params, indices)),
            mask_add,
            config.num_heads,
        )
        toks, valid, _ = ri.greedy_decode(
            params, enc, mask_add, eos, max_steps, config.num_heads,
            shortlist=np.asarray(shortlist, np.int64)
            if shortlist is not None else None,
        )
    return toks[0][valid[0]].tolist()


def mode_tokens(args):
    from slimt_jax.io.shortlist import ShortlistGenerator

    worst_sent = 100.0
    with tempfile.TemporaryDirectory() as tmp:
        for label, enc, dec, heads, emb, ffn, seed in CELLS:
            config, model_bytes, spm, paths = write_package(
                tmp, enc, dec, heads, emb, ffn, seed
            )
            eos = spm.eos_id
            pad = max(0, spm.pad_id)
            sentences = corpus(args.lines, eos, seed + 100)
            with open(paths["shortlist.bin"], "rb") as f:
                gen = ShortlistGenerator(f.read(), VOCAB)
            nobias_bytes = zero_logit_bias(model_bytes)
            nobias_path = paths["model.bin"] + ".nobias"
            with open(nobias_path, "wb") as f:
                f.write(nobias_bytes)
            for with_shortlist in (False, True):
                for batch in (1, 8):
                    # Shortlist cells: zeroed logit bias (the reference
                    # Ruy provider adds the wrong bias under select —
                    # module docstring).
                    cell_paths = (
                        dict(paths, **{"model.bin": nobias_path})
                        if with_shortlist
                        else paths
                    )
                    cell_bytes = (
                        nobias_bytes if with_shortlist else model_bytes
                    )
                    ref = run_reference(
                        cell_paths, config, sentences, batch, with_shortlist
                    )
                    got = run_slimt_jax(
                        cell_bytes, config, sentences, batch, eos, pad,
                        gen if with_shortlist else None,
                    )
                    tag = "shortlist" if with_shortlist else "full-vocab"
                    pct_sent, _, divergent = diff(
                        f"{label} {tag} B={batch}", ref, got, args.verbose
                    )
                    # Attribute divergences: reproduced by the oracle
                    # with roundf quantization = the reference's OWN
                    # Ruy-vs-intgemm provider rounding delta, not an
                    # engine disagreement.
                    attributed = 0
                    for i in divergent:
                        # Reconstruct the sentence's BATCH context:
                        # the shortlist is generated from the group's
                        # flattened words and the step cap from the
                        # group's max length (Model.cc:116-120,160).
                        group = sentences[
                            (i // batch) * batch : (i // batch) * batch + batch
                        ]
                        sl = (
                            gen.generate([w for s in group for w in s])
                            if with_shortlist else None
                        )
                        cap = int(1.5 * max(len(s) for s in group))
                        want = roundf_decode(
                            cell_bytes, config, sentences[i], eos, cap, sl
                        )
                        if want == ref[i]:
                            attributed += 1
                    if attributed:
                        print(
                            f"    {attributed}/{len(divergent)} divergences"
                            " attributed to provider rounding (roundf"
                            " oracle == reference)"
                        )
                    adj = 100.0 * (
                        int(round(pct_sent / 100.0 * len(ref))) + attributed
                    ) / max(1, len(ref))
                    worst_sent = min(worst_sent, adj)

        # Quantify the reference-Ruy unselected-bias bug: same cell,
        # natural bias, shortlist on. Informational (not gating).
        label, enc, dec, heads, emb, ffn, seed = CELLS[0]
        config, model_bytes, spm, paths = write_package(
            tmp, enc, dec, heads, emb, ffn, seed
        )
        sentences = corpus(args.lines, spm.eos_id, seed + 100)
        with open(paths["shortlist.bin"], "rb") as f:
            gen = ShortlistGenerator(f.read(), VOCAB)
        ref = run_reference(paths, config, sentences, 1, True)
        got = run_slimt_jax(
            model_bytes, config, sentences, 1, spm.eos_id,
            max(0, spm.pad_id), gen,
        )
        diff("ruy-bias-bug (informational)", ref, got, args.verbose)[0]
    print(f"worst-cell sentence exact-match: {worst_sent:.1f}%")
    return worst_sent


def serving_corpus(lines, eos, seed, lengths=(7, 11, 15), batch=8,
                   vocab=VOCAB):
    """Corpus for the serving-numerics sweep: consecutive groups of
    `batch` sentences share a length, so every [B, T] batch shape (and
    its 1.5*T step cap) repeats — bounding XLA compiles to
    len(lengths) shapes per (cell, config) instead of one per group.
    Both sides see the identical order, so grouping semantics match
    the reference harness's fixed-size flush batching."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < lines:
        n = int(lengths[(len(out) // batch) % len(lengths)])
        for _ in range(batch):
            ids = rng.integers(2, vocab, n).astype(np.uint32).tolist()
            ids.append(eos)
            out.append(ids)
    return out[:lines]


# The serving-numerics sweep: every reduced-precision execution config
# the engine ships, diffed against the SAME reference-binary outputs
# as the exact path. "exact" is the control row (must stay at the
# tokens-mode floor); the rest quantify what each knob costs in
# agreement with the reference (which has no reduced-precision mode of
# its own — its numerics are f32-KV + f32 argmax, so agreement here IS
# "distance from the reference's output").
SERVING_CONFIGS = [
    ("exact", {}),
    ("kv=int16", {"kv_dtype": "int16"}),
    ("kv=k8v16", {"kv_dtype": "k8v16"}),
    ("kv=k16v8", {"kv_dtype": "k16v8"}),
    ("kv=float16", {"kv_dtype": "float16"}),
    ("kv=bfloat16", {"kv_dtype": "bfloat16"}),
    ("kv=int8", {"kv_dtype": "int8"}),
    ("argmax=packed_fp16", {"argmax_method": "packed_fp16"}),
    ("argmax=packed_bf16", {"argmax_method": "packed_bf16"}),
    # Integer-accumulator-domain packed argmax (models/transformer.
    # packed_int_argmax): the bias folds to i32 accumulator units
    # (half-unit rounding) and low accumulator bits are shifted off to
    # share the key with the column index. Measured round 5: alone it
    # MATCHES the exact path (99.92% tokens) on the adversarial cells.
    ("argmax=packed_int", {"argmax_method": "packed_int"}),
    # THE DECLARED SERVING CONFIG since round 5 (= ModelConfig
    # defaults = the bench headline): int16 per-row KV + packed_int
    # argmax + alignment-free — 99.69% tokens / 99.1% sentence-exact
    # (the int16 KV's own ceiling; supersedes the packed_fp16 stack at
    # 99.57%).
    ("packedint+int16+noalign", {
        "kv_dtype": "int16", "argmax_method": "packed_int",
        "with_alignment": False,
    }),
    # The round-3/4 declared serving config (packed_fp16 argmax) —
    # superseded as the default by packedint+int16+noalign below;
    # kept as a measured row.
    ("int16+packedfp16+noalign", {
        "kv_dtype": "int16", "argmax_method": "packed_fp16",
        "with_alignment": False,
    }),
    ("k8v16+packedfp16+noalign", {
        "kv_dtype": "k8v16", "argmax_method": "packed_fp16",
        "with_alignment": False,
    }),
    # k16v8 = the REVERSE mix (int16 K + int8 V, 1.5 B/elem): k8v16
    # landed at int8-class agreement because K's score error flips
    # near-tie argmaxes; if V's error really mixes out under softmax,
    # this orientation should land near int16-class at 25% less KV
    # bandwidth.
    ("k16v8+packedfp16+noalign", {
        "kv_dtype": "k16v8", "argmax_method": "packed_fp16",
        "with_alignment": False,
    }),
    ("fp16+packedfp16+noalign", {
        "kv_dtype": "float16", "argmax_method": "packed_fp16",
        "with_alignment": False,
    }),
    ("bf16+packedbf16+noalign", {
        "kv_dtype": "bfloat16", "argmax_method": "packed_bf16",
        "with_alignment": False,
    }),
    ("int8+packedbf16+noalign", {
        "kv_dtype": "int8", "argmax_method": "packed_bf16",
        "with_alignment": False,
    }),
    # Reduced-precision ENCODER activations (ModelConfig.encoder_dtype
    # — the residual stream between encoder blocks rides fp16/bf16;
    # int8 affine inputs round through it before quantization). A
    # one-shot perturbation of encoder_out, unlike the KV rows whose
    # error re-enters every decode step.
    ("enc=float16", {"encoder_dtype": "float16"}),
    ("enc=bfloat16", {"encoder_dtype": "bfloat16"}),
    # Candidate full stack: fp16 encoder on top of the declared
    # serving config.
    ("encfp16+int16+packedfp16+noalign", {
        "encoder_dtype": "float16",
        "kv_dtype": "int16", "argmax_method": "packed_fp16",
        "with_alignment": False,
    }),
]


def mode_serving(args):
    """Reduced-precision serving configs vs the reference binary:
    4 architectures × {full-vocab, shortlist} × B=8 × --serving-lines
    sentences per cell, for every config in SERVING_CONFIGS. Prints one
    table (sentence-exact%, token agreement%) and writes
    crosscheck/serving_agreement.json for PERF.md and the config
    comments to cite. Exit status gates only the exact control
    row (>=98% sentences, the tokens-mode floor); the reduced rows are
    the published measurement."""
    configs = SERVING_CONFIGS
    partial = bool(getattr(args, "serving_configs", None))
    if partial:
        pats = [p.strip() for p in args.serving_configs.split(",") if p.strip()]
        configs = [
            (label, opts)
            for label, opts in SERVING_CONFIGS
            if label == "exact" or any(p in label for p in pats)
        ]
    totals = {
        label: [0, 0, 0, 0]  # sent_exact, sent_total, tok_agree, tok_total
        for label, _ in configs
    }
    per_cell = {label: [] for label, _ in configs}
    batch = 8
    with tempfile.TemporaryDirectory() as tmp:
        for label, enc, dec, heads, emb, ffn, seed in CELLS + [PEAKED_CELL]:
            from slimt_jax.io.shortlist import ShortlistGenerator

            peaked = label.startswith("STRESS")
            config, model_bytes, spm, paths = write_package(
                tmp, enc, dec, heads, emb, ffn, seed,
                bias_scale=PEAKED_BIAS_SCALE if peaked else None,
            )
            eos = spm.eos_id
            pad = max(0, spm.pad_id)
            sentences = serving_corpus(
                args.serving_lines, eos, seed + 300, batch=batch
            )
            with open(paths["shortlist.bin"], "rb") as f:
                gen = ShortlistGenerator(f.read(), VOCAB)
            nobias_bytes = zero_logit_bias(model_bytes)
            nobias_path = paths["model.bin"] + ".nobias"
            with open(nobias_path, "wb") as f:
                f.write(nobias_bytes)
            # The PEAKED cell runs full-vocab only: its point IS the
            # wide logit-bias spread, and shortlist legs zero the bias
            # (reference Ruy unselected-bias bug — module docstring).
            legs = (False,) if peaked else (False, True)
            for with_shortlist in legs:
                # Shortlist cells: zeroed logit bias (reference Ruy
                # provider's unselected-bias bug — module docstring).
                cell_paths = (
                    dict(paths, **{"model.bin": nobias_path})
                    if with_shortlist else paths
                )
                cell_bytes = nobias_bytes if with_shortlist else model_bytes
                ref = run_reference(
                    cell_paths, config, sentences, batch, with_shortlist
                )
                for conf_label, opts in configs:
                    got = run_slimt_jax(
                        cell_bytes, config, sentences, batch, eos, pad,
                        gen if with_shortlist else None, **opts,
                    )
                    se = st = ta = tt = 0
                    for r, g in zip(ref, got):
                        st += 1
                        se += int(r == g)
                        n = max(len(r), len(g))
                        tt += n
                        ta += sum(1 for a, b in zip(r, g) if a == b)
                    if not peaked:
                        # The published aggregate stays ADVERSARIAL
                        # (worst-case); the peaked cell reports
                        # separately as the realistic-side bound.
                        agg = totals[conf_label]
                        agg[0] += se
                        agg[1] += st
                        agg[2] += ta
                        agg[3] += tt
                    per_cell[conf_label].append(
                        {
                            "cell": label,
                            "shortlist": with_shortlist,
                            "sent_exact": se,
                            "sent_total": st,
                            "tok_agree": ta,
                            "tok_total": tt,
                        }
                    )
                    if args.verbose:
                        print(
                            f"  {label} shortlist={with_shortlist} "
                            f"{conf_label}: {se}/{st} sentences, "
                            f"{100.0 * ta / max(1, tt):.2f}% tokens",
                            flush=True,
                        )
            # Keep the sweep's memory flat across cells: drop every
            # cached executable before the next architecture.
            import jax

            jax.clear_caches()

    print(
        f"{'config':24s} {'sentences exact':>18s} {'tokens agree':>16s}"
        f" {'worst cell tok%':>16s}"
    )
    report = {}
    for conf_label, _ in configs:
        se, st, ta, tt = totals[conf_label]
        adversarial = [
            c for c in per_cell[conf_label]
            if not c["cell"].startswith("STRESS")
        ]
        peaked_cells = [
            c for c in per_cell[conf_label]
            if c["cell"].startswith("STRESS")
        ]
        worst = min(
            100.0 * c["tok_agree"] / max(1, c["tok_total"])
            for c in adversarial
        )
        row = {
            "sentence_exact_pct": round(100.0 * se / max(1, st), 2),
            "token_agreement_pct": round(100.0 * ta / max(1, tt), 2),
            "worst_cell_token_pct": round(worst, 2),
            "sentences": st,
            "cells": per_cell[conf_label],
        }
        peaked_str = ""
        if peaked_cells:
            pc = peaked_cells[0]
            row["stress_cell_token_pct"] = round(
                100.0 * pc["tok_agree"] / max(1, pc["tok_total"]), 2
            )
            row["stress_cell_sentence_pct"] = round(
                100.0 * pc["sent_exact"] / max(1, pc["sent_total"]), 2
            )
            peaked_str = f"  stress {row['stress_cell_token_pct']:.2f}%"
        print(
            f"{conf_label:24s} {se:>7d}/{st} ({100.0 * se / max(1, st):5.1f}%)"
            f" {100.0 * ta / max(1, tt):7.2f}% {worst:15.2f}%{peaked_str}"
        )
        report[conf_label] = row
    out_path = os.path.join(ROOT, "crosscheck", "serving_agreement.json")
    if partial and getattr(args, "serving_merge", False):
        # MERGE mode: append/refresh just the filtered rows in the
        # published json. Sound only if the measurement is the same
        # experiment: batch and lines_per_cell must match, and the
        # re-run exact CONTROL row must reproduce the stored one
        # bit-for-bit (CPU runs are deterministic — any drift means
        # the environment changed and a full regeneration is needed).
        with open(out_path) as f:
            existing = json.load(f)
        if existing.get("batch") != batch or (
            existing.get("lines_per_cell") != args.serving_lines
        ):
            raise SystemExit(
                "--serving-merge: batch/lines_per_cell mismatch with "
                f"{out_path} — run the full sweep instead"
            )
        if existing["configs"].get("exact") != report["exact"]:
            raise SystemExit(
                "--serving-merge: the exact control row does not "
                "reproduce the stored one — environment changed; run "
                "the full sweep instead"
            )
        existing["configs"].update(report)
        with open(out_path, "w") as f:
            json.dump(existing, f, indent=1)
        print(f"merged {len(report) - 1} row(s) into {out_path}")
        exact = totals["exact"]
        return 100.0 * exact[0] / max(1, exact[1])
    if partial:
        print("(filtered run: serving_agreement.json NOT updated)")
        exact = totals["exact"]
        return 100.0 * exact[0] / max(1, exact[1])
    with open(out_path, "w") as f:
        json.dump(
            {
                "batch": batch,
                "lines_per_cell": args.serving_lines,
                "reference": "crosscheck/bin/slimt_ref_harness "
                "(verbatim reference core, Ruy provider)",
                "configs": report,
            },
            f,
            indent=1,
        )
    print(f"wrote {out_path}")
    exact = totals["exact"]
    return 100.0 * exact[0] / max(1, exact[1])


def mode_shortlist(args):
    """Directly diff ShortlistGenerator.generate (reference
    Shortlist.cc:115-175 vs slimt_jax io/shortlist.py)."""
    from slimt_jax.io.shortlist import ShortlistGenerator

    mismatches = total = 0
    with tempfile.TemporaryDirectory() as tmp:
        label, enc, dec, heads, emb, ffn, seed = CELLS[0]
        config, model_bytes, spm, paths = write_package(
            tmp, enc, dec, heads, emb, ffn, seed
        )
        sentences = corpus(args.lines, spm.eos_id, seed + 200)
        with open(paths["shortlist.bin"], "rb") as f:
            gen = ShortlistGenerator(f.read(), VOCAB)
        for batch in (1, 8):
            ref_lists = run_reference(
                paths, config, sentences, batch, True, dump_shortlist=True
            )
            idx = 0
            for start in range(0, len(sentences), batch):
                group = sentences[start : start + batch]
                flat = [w for s in group for w in s]
                mine = gen.generate(flat).tolist()
                total += 1
                if mine != ref_lists[idx]:
                    mismatches += 1
                    if args.verbose:
                        print(f"batch {idx}: ref={ref_lists[idx][:16]}...")
                        print(f"          ours={mine[:16]}...")
                idx += 1
    print(
        f"shortlist generation: {total - mismatches}/{total} batches "
        f"identical"
    )
    return mismatches


# Adversarial splitter corpus: abbreviations, NUMERIC_ONLY prefixes,
# CJK/Armenian stops, footnotes, quotes, ellipses, mixed newlines,
# unicode whitespace — aimed at the heuristics in Splitter.cc:183-240.
SPLIT_DOCS = [
    "Hello world. This is a test. Short! Done?",
    "Dr. Smith met Mr. Jones at 5 p.m. They talked. etc. And left.",
    "No. 5 is here. No. Five is not. Art. 12 applies.",
    "He said “Stop.” Then left. She asked “Why?” Nobody knew.",
    "This is v2.0 of the spec. Versions 1.5.2 and 3.10 differ.",
    "这是一个句子。这是另一个！"
    "你好吗？再见。",
    "Այս մի նախադաս"
    "ություն է։ Եւ "
    "մեկ ուրիշ։",
    "A claim was made [12]. Another claim [3, 4] followed. See refs.",
    "Wait... what happened? An ellipsis… then more. The end.",
    "i.e. this stays together. E.g. so does this? Q.E.D. Done.",
    "Sentence one.\nSentence two on a new line. And three.\n\n"
    "New paragraph starts here. It continues! Done.",
    "Line with CRLF.\r\nNext line. More text?\r\n\r\nAfter blank.",
    "Ends with no punctuation and trailing spaces   ",
    "((Parenthetical.)) 'Quoted.' “Curly.” Next one.",
    "A.B. initials here. J. R. R. Tolkien wrote books. True.",
    "1. First item. 2. Second item. 10. Tenth item.",
]

# Moses-style nonbreaking prefix file (class 1 + NUMERIC_ONLY class 2),
# format per slimt/Splitter.cc:31-53.
PREFIX_FILE = """# nonbreaking prefixes (crosscheck corpus)
Dr
Mr
Mrs
Prof
etc
i.e
e.g
vs
A
B
J
R
Q.E.D
No #NUMERIC_ONLY#
Art #NUMERIC_ONLY#
pp #NUMERIC_ONLY#
"""


def mode_split(args):
    """Diff the repo's regex-based splitter against the reference's
    PCRE2 Splitter.cc (compiled verbatim, real libpcre2) over the
    adversarial corpus: per-document byte-range boundary identity."""
    from slimt_jax.text.splitter import SentenceStream, SplitMode, Splitter

    mode_map = {
        "sentence": SplitMode.ONE_SENTENCE_PER_LINE,
        "paragraph": SplitMode.ONE_PARAGRAPH_PER_LINE,
        "wrapped": SplitMode.WRAPPED_TEXT,
    }
    mismatch = total = 0
    with tempfile.TemporaryDirectory() as tmp:
        prefix_path = os.path.join(tmp, "prefixes.txt")
        with open(prefix_path, "w") as f:
            f.write(PREFIX_FILE)
        for use_prefixes in (False, True):
            splitter = Splitter()
            if use_prefixes:
                splitter.load(prefix_path)
            for mode_name, mode in mode_map.items():
                for doc_id, doc in enumerate(SPLIT_DOCS):
                    cmd = [HARNESS, "--split", mode_name]
                    if use_prefixes:
                        cmd += ["--prefix-file", prefix_path]
                    proc = subprocess.run(
                        cmd, input=doc, capture_output=True, text=True,
                        check=True,
                    )
                    ref = proc.stdout.splitlines()
                    # Repo side: char offsets → byte offsets.
                    byte_of = [0]
                    for ch in doc:
                        byte_of.append(byte_of[-1] + len(ch.encode("utf-8")))
                    mine = []
                    for sent, begin, end in SentenceStream(
                        doc, splitter, mode
                    ):
                        if sent == "":
                            mine.append("para")
                        else:
                            mine.append(f"{byte_of[begin]} {byte_of[end]}")
                    # Reference may or may not emit a trailing paragraph
                    # marker; normalize trailing markers on both sides.
                    while ref and ref[-1] == "para":
                        ref.pop()
                    while mine and mine[-1] == "para":
                        mine.pop()
                    total += 1
                    if ref != mine:
                        mismatch += 1
                        if args.verbose:
                            print(
                                f"doc {doc_id} mode={mode_name} "
                                f"prefixes={use_prefixes}:"
                            )
                            print(f"  ref={ref}")
                            print(f"  ours={mine}")
    print(f"splitter boundaries: {total - mismatch}/{total} documents identical")
    return mismatch


def mode_process(args):
    """Text-pipeline differential: the reference TextProcessor (+real
    Splitter/Annotation) vs slimt_jax's text/processor.py on identical
    text, SAME tokenizer on both sides (the shim Vocabulary bridges to
    native/slimt_host.cpp; the repo side forces backend='native') — so
    any diff is wrap/EOS/annotation semantics, not segmentation.
    Compares segments (ids incl. EOS) AND the AnnotatedText's sentence
    + word byte ranges."""
    from slimt_jax.text import spm_proto
    from slimt_jax.text.processor import TextProcessor
    from slimt_jax.text.synthetic_vocab import DEFAULT_WORDS, build_spm_model
    from slimt_jax.text.vocabulary import Vocabulary

    spm = build_spm_model(DEFAULT_WORDS)
    spm_bytes = spm_proto.serialize_model(spm)
    mismatch = total = 0
    with tempfile.TemporaryDirectory() as tmp:
        vocab_path = os.path.join(tmp, "vocab.spm")
        with open(vocab_path, "wb") as f:
            f.write(spm_bytes)
        prefix_path = os.path.join(tmp, "prefixes.txt")
        with open(prefix_path, "w") as f:
            f.write(PREFIX_FILE)
        vocabulary = Vocabulary(spm_bytes, backend="native")
        for mode in ("sentence", "paragraph", "wrapped_text"):
            processor = TextProcessor(mode, vocabulary, PREFIX_FILE)
            for wrap in (8, 128):
                for doc_id, doc in enumerate(SPLIT_DOCS):
                    proc = subprocess.run(
                        [HARNESS, "--process", mode, "--vocab", vocab_path,
                         "--wrap", str(wrap), "--prefix-file", prefix_path],
                        input=doc, capture_output=True, text=True,
                        check=True,
                    )
                    ref = proc.stdout.splitlines()

                    annotated, segments = processor.process(doc, wrap)
                    mine = [
                        "ids " + " ".join(str(w) for w in segment)
                        for segment in segments
                    ]
                    ann = annotated
                    for s in range(ann.sentence_count()):
                        rng = ann.sentence_as_range(s)
                        words = " ".join(
                            f"{ann.word_as_range(s, w).begin}:"
                            f"{ann.word_as_range(s, w).end}"
                            for w in range(ann.word_count(s))
                        )
                        mine.append(
                            f"sent {rng.begin} {rng.end} :"
                            + (f" {words}" if words else "")
                        )
                    total += 1
                    if ref != mine:
                        mismatch += 1
                        if args.verbose:
                            print(f"doc {doc_id} mode={mode} wrap={wrap}:")
                            for a, b in zip(ref + [""] * 9, mine + [""] * 9):
                                if a != b:
                                    print(f"  ref={a}\n  ours={b}")
    print(
        f"text pipeline: {total - mismatch}/{total} documents identical "
        f"(segments + annotations)"
    )
    return mismatch


def mode_e2e(args):
    """The capstone differential: the reference's COMPLETE slimt-cli
    (app/main.cc + the full Frontend/Batcher/Request/Response service
    layer, compiled verbatim into crosscheck/bin/slimt_ref_cli) vs
    `python -m slimt_jax translate` on identical text and an identical
    synthetic package — text in, translated text out, exact string
    compare.  Tokenizer held identical on both sides (shim bridge /
    SLIMT_JAX_BATCH_BACKEND=native); full-vocab only (the reference
    CLI's shortlist path carries the Ruy bias bug, see module
    docstring)."""
    cli = os.path.join(ROOT, "crosscheck", "bin", "slimt_ref_cli")
    corpus_path = os.path.join(ROOT, "data", "corpus.txt")
    mismatch = total = 0
    with tempfile.TemporaryDirectory() as tmp:
        pkg = os.path.join(tmp, "pkg")
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   SLIMT_JAX_BATCH_BACKEND="native")
        subprocess.run(
            [sys.executable, "-m", "slimt_jax", "synth", "--out", pkg],
            check=True, capture_output=True, env=env, cwd=ROOT,
        )
        # Both CLIs prefix --root onto every path incl. --ssplit
        # (app/main.cc Package semantics) — keep it package-relative.
        with open(os.path.join(pkg, "prefixes.txt"), "w") as f:
            f.write(PREFIX_FILE)

        documents = ["\n".join(SPLIT_DOCS)]
        if os.path.exists(corpus_path):
            with open(corpus_path) as f:
                lines = [line.rstrip("\n") for line in f][:32]
            documents.append("\n".join(lines))

        html_documents = [
            "<b>Hello world.</b> This <i>is</i> a test of <a href='x'>"
            "markup transfer</a>. Done!",
            "<p>First paragraph here.</p><p>Second one, with "
            "<em>emphasis</em> and a <br/>void tag.</p>",
            "Text with &amp; entities &lt;escaped&gt; and trailing "
            "words after <span class='x'>spans</span> end.",
        ]
        cases = [(doc, False) for doc in documents] + [
            (doc, True) for doc in html_documents
        ]
        for doc_id, (doc, html) in enumerate(cases):
            html_flag = ["--html"] if html else []
            ref = subprocess.run(
                [cli, "--root", pkg, "--model", "model.bin",
                 "--vocabulary", "vocab.spm", "--ssplit", "prefixes.txt"]
                + html_flag,
                input=doc, capture_output=True, text=True, check=True,
            )
            # Drop the 4-line config echo (app/main.cc:73-76).
            ref_text = "\n".join(ref.stdout.splitlines()[4:]).strip()
            # --exact pins f32-KV + exact-argmax numerics: the
            # byte-identity gate must not depend on the shipped
            # serving defaults' (quantified, non-exact) agreement.
            mine = subprocess.run(
                [sys.executable, "-m", "slimt_jax", "translate",
                 "--root", pkg, "--ssplit", "prefixes.txt", "--exact"]
                + html_flag,
                input=doc, capture_output=True, text=True, check=True,
                env=env, cwd=ROOT,
            )
            mine_text = mine.stdout.strip()
            total += 1
            if ref_text != mine_text:
                # HTML restore places tags by argmax over the f32
                # head-0 cross-attention; with near-uniform attention
                # (synthetic weights) that argmax is tie-noise between
                # BLAS+std::exp and XLA numerics. Tag SKELETON and
                # token multiset must still match exactly — only the
                # position of tags relative to translated tokens may
                # move on such ties.
                import re as _re

                def skeleton(text):
                    tags = _re.findall(r"<[^>]+>", text)
                    words = sorted(_re.sub(r"<[^>]+>", " ", text).split())
                    return tags, words

                if html and skeleton(ref_text) == skeleton(mine_text):
                    if args.verbose:
                        print(
                            f"document {doc_id}: tag placement differs "
                            "on an attention tie (skeleton + tokens "
                            "identical)"
                        )
                else:
                    mismatch += 1
                    if args.verbose:
                        print(f"document {doc_id} html={html}:")
                        print(f"  ref: {ref_text[:400]}")
                        print(f"  ours: {mine_text[:400]}")
        # Informational (non-gating): the same documents through the
        # SHIPPED serving defaults (int16 KV + packed_fp16 — the
        # declared config; sentence-level agreement quantified in
        # serving mode). Divergence here is expected tie-flips, not a
        # bug.
        serving_same = serving_total = 0
        for doc, html in cases:
            html_flag = ["--html"] if html else []
            ref = subprocess.run(
                [cli, "--root", pkg, "--model", "model.bin",
                 "--vocabulary", "vocab.spm", "--ssplit", "prefixes.txt"]
                + html_flag,
                input=doc, capture_output=True, text=True, check=True,
            )
            ref_text = "\n".join(ref.stdout.splitlines()[4:]).strip()
            mine = subprocess.run(
                [sys.executable, "-m", "slimt_jax", "translate",
                 "--root", pkg, "--ssplit", "prefixes.txt"] + html_flag,
                input=doc, capture_output=True, text=True, check=True,
                env=env, cwd=ROOT,
            )
            serving_total += 1
            serving_same += int(ref_text == mine.stdout.strip())
    print(f"e2e CLI text: {total - mismatch}/{total} documents identical")
    print(
        f"e2e serving-config (informational): {serving_same}/"
        f"{serving_total} documents byte-identical under the shipped "
        "int16+packed_fp16 defaults"
    )
    return mismatch


def mode_bleu(args):
    """THE driver metric, one command (reference scripts/run.sh:1-28:
    translate a test set with both engines, score with sacrebleu):
    run the verbatim-compiled reference CLI and the slimt_jax CLI on
    identical input and print corpus BLEU for both plus line-level
    agreement.

    With a real model package (--bleu-package, e.g. en-de tiny11 via
    `python -m slimt_jax download`) and a real test set
    (--bleu-source/--bleu-reference, e.g. WNGT20), this prints the
    real-weights BLEU parity the reference README quotes. Offline —
    the default — it validates the identical plumbing on the synthetic
    package + data/corpus.txt, scoring against the reference CLI's own
    output as pseudo-reference (reference BLEU = 100 by construction;
    the slimt_jax rows then express translation agreement in BLEU
    units). Scoring: scripts/bleu.py, validated against the installed
    sacrebleu to 4 decimals (tests/test_bleu.py)."""
    from bleu import corpus_bleu

    cli = os.path.join(ROOT, "crosscheck", "bin", "slimt_ref_cli")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               SLIMT_JAX_BATCH_BACKEND="native")

    with tempfile.TemporaryDirectory() as tmp:
        pkg = args.bleu_package
        model_name, vocab_name = args.bleu_model, args.bleu_vocab
        if pkg is None:
            pkg = os.path.join(tmp, "pkg")
            subprocess.run(
                [sys.executable, "-m", "slimt_jax", "synth", "--out", pkg],
                check=True, capture_output=True, env=env, cwd=ROOT,
            )
            with open(os.path.join(pkg, "prefixes.txt"), "w") as f:
                f.write(PREFIX_FILE)

        if args.bleu_source:
            with open(args.bleu_source, encoding="utf-8") as f:
                sources = [line.rstrip("\n") for line in f]
        else:
            with open(os.path.join(ROOT, "data", "corpus.txt")) as f:
                sources = [line.rstrip("\n") for line in f if line.strip()]
        sources = sources[: args.bleu_lines]
        text = "\n".join(sources)

        ssplit = (
            ["--ssplit", "prefixes.txt"]
            if os.path.exists(os.path.join(pkg, "prefixes.txt"))
            else []
        )
        ref = subprocess.run(
            [cli, "--root", pkg, "--model", model_name,
             "--vocabulary", vocab_name] + ssplit,
            input=text, capture_output=True, text=True, check=True,
        )
        ref_lines = ref.stdout.splitlines()[4:]  # drop the config echo

        def run_mine(extra):
            mine = subprocess.run(
                [sys.executable, "-m", "slimt_jax", "translate",
                 "--root", pkg, "--model", model_name,
                 "--vocabulary", vocab_name] + ssplit + extra,
                input=text, capture_output=True, text=True, check=True,
                env=env, cwd=ROOT,
            )
            return mine.stdout.splitlines()

        serving_lines = run_mine([])  # the declared serving config
        exact_lines = run_mine(["--exact"])

        pseudo = args.bleu_reference is None
        if pseudo:
            references = ref_lines
        else:
            with open(args.bleu_reference, encoding="utf-8") as f:
                references = [line.rstrip("\n") for line in f]
            references = references[: args.bleu_lines]

        n = min(len(references), len(ref_lines), len(serving_lines),
                len(exact_lines))
        rows = {}
        for label, lines in (
            ("reference_cli", ref_lines),
            ("slimt_jax_serving", serving_lines),
            ("slimt_jax_exact", exact_lines),
        ):
            score, detail = corpus_bleu(lines[:n], references[:n])
            rows[f"bleu_{label}"] = round(score, 2)
        agree_serving = sum(
            a == b for a, b in zip(serving_lines[:n], ref_lines[:n])
        )
        agree_exact = sum(
            a == b for a, b in zip(exact_lines[:n], ref_lines[:n])
        )
        out = {
            **rows,
            "delta_serving": round(
                rows["bleu_slimt_jax_serving"] - rows["bleu_reference_cli"], 2
            ),
            "lines": n,
            "line_exact_vs_reference_serving": round(agree_serving / n, 4),
            "line_exact_vs_reference_exact": round(agree_exact / n, 4),
            "pseudo_reference": pseudo,
        }
        print(json.dumps(out))
        # Gate: the exact path must reproduce the reference's text
        # nearly verbatim (pseudo-ref mode); with a real reference
        # file there is no gate — the two BLEUs are the report.
        if pseudo and out["line_exact_vs_reference_exact"] < 0.98:
            return 1
        return 0


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "mode", nargs="?", default="all",
        choices=["all", "tokens", "shortlist", "split", "process", "e2e",
                 "serving", "bleu"],
    )
    parser.add_argument("--lines", type=int, default=48)
    parser.add_argument(
        "--serving-lines", type=int, default=256,
        help="sentences per architecture cell in the serving sweep "
        "(x4 cells x2 projection legs = total corpus)",
    )
    parser.add_argument(
        "--serving-configs", default=None,
        help="comma-separated substring filter over SERVING_CONFIGS "
        "labels ('exact' always included as the control); a filtered "
        "run prints the table but does NOT overwrite "
        "serving_agreement.json",
    )
    parser.add_argument(
        "--serving-merge", action="store_true",
        help="with --serving-configs: merge the filtered rows into "
        "serving_agreement.json, gated on the exact control row "
        "reproducing the stored one bit-for-bit (same batch and "
        "lines_per_cell required)",
    )
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument(
        "--bleu-package", default=None,
        help="model package dir for the bleu mode (default: synthetic "
        "package; for real weights: python -m slimt_jax download)",
    )
    parser.add_argument("--bleu-model", default="model.bin")
    parser.add_argument("--bleu-vocab", default="vocab.spm")
    parser.add_argument(
        "--bleu-source", default=None,
        help="test-set source file (default: data/corpus.txt)",
    )
    parser.add_argument(
        "--bleu-reference", default=None,
        help="test-set reference translations; absent = score against "
        "the reference CLI's own output (plumbing validation)",
    )
    parser.add_argument("--bleu-lines", type=int, default=128)
    args = parser.parse_args()

    if not os.path.exists(HARNESS):
        print("building reference harness...", flush=True)
    build_harness()

    rc = 0
    if args.mode in ("all", "shortlist"):
        if mode_shortlist(args) != 0:
            rc = 1
    if args.mode in ("all", "split"):
        if mode_split(args) != 0:
            rc = 1
    if args.mode in ("all", "process"):
        if mode_process(args) != 0:
            rc = 1
    if args.mode in ("all", "e2e"):
        if mode_e2e(args) != 0:
            rc = 1
    if args.mode in ("all", "tokens"):
        # Measured exact on every cell (module docstring); the floor
        # leaves headroom for a rare rounding-boundary argmax flip on
        # future corpora.
        if mode_tokens(args) < 98.0:
            rc = 1
    if args.mode == "bleu":
        if mode_bleu(args) != 0:
            rc = 1
    if args.mode == "serving":
        # Gates only the exact control row; the reduced-precision rows
        # are the published measurement (serving_agreement.json).
        if mode_serving(args) < 98.0:
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
