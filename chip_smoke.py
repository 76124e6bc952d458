"""Smoke test of the translation engine on one NVIDIA GPU.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the multi-device path
                                   # against one card, and nothing else

Phases (one card):
  1. device   — JAX must find a GPU; prints the card's name and power
                limit (nvidia-smi) and JAX's device_kind.
  2. service  — full-width tiny11 synthetic package (vocab 32000, emb
                256, ffn 1536, 6 encoder / 2 SSRU decoder layers, 8
                heads; random weights from a seed): Blocking.translate
                on data/sample.txt, the HTTP server in-process (/health,
                /translate, a 64-line bulk batch, /submit + /job), and
                one base-width (emb 512, ffn 2048) Model.forward at B=64.
  3. numerics — the compiled decode's dots go to cuBLAS, with no
                Triton GEMM fusion; against the NumPy oracle
                (tests/reference_impl.py) at both published widths:
                int8 accumulators bit-exact, encoder layer, full
                encoder and first-step logits within a printed
                tolerance, greedy tokens of the exact path; then the
                declared serving config's tokens on the crosscheck
                serving cells (scripts/crosscheck.py serving) and, at
                both widths, on those 8 sentences and on a full-vocab
                sweep, against the same code on the CPU in a
                subprocess, at the shipped f32 dot precision (the bar,
                over every cell: >= 99% tokens and >= 99% exact
                sentences) and, for the record, at DEFAULT precision;
                the exact path's full-vocab sweeps against the CPU,
                for the record.
  4. options  — every reachable ModelConfig numerics option compiles
                and runs once at small batch.

With --four: Model on a data=4 replicated mesh and on a data=2 x
model=2 mesh through Blocking, tokens bit-exact against one card, plus
the pipeline and sequence-parallel legs of __graft_entry__.

The last line of stdout is {"ok": true, "device": {...}} on success.
Without a GPU the script exits nonzero before any phase runs.
"""

import argparse
import functools
import hashlib
import json
import os
import subprocess
import sys
import time
import types

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SWEEP_LINES_PER_CELL = 64
SWEEP_LINES_PER_WIDTH = 192
SWEEP_BATCH = 32
AGREEMENT_BAR_PCT = 99.0
# (vocab, emb, ffn) at the published widths.
WIDTHS = {"tiny11": (32000, 256, 1536), "base": (32000, 512, 2048)}


def _say(msg):
    print(msg, flush=True)


def _check(ok, what):
    if not ok:
        raise AssertionError(what)


# -- shared constructors ---------------------------------------------------


def _package(width="tiny11"):
    from slimt_jax.config import ModelConfig
    from slimt_jax.io.synthetic import synthetic_model_bytes
    from slimt_jax.models.model import Package
    from slimt_jax.text import spm_proto
    from slimt_jax.text.synthetic_vocab import DEFAULT_WORDS, build_spm_model

    vocab, emb, ffn = WIDTHS[width]
    spm = build_spm_model(DEFAULT_WORDS, target_size=vocab)
    return Package(
        model=synthetic_model_bytes(
            config=ModelConfig(), vocab_size=vocab, emb_dim=emb,
            ffn_dim=ffn, seed=0,
        ),
        vocabulary=spm_proto.serialize_model(spm),
    )


def _corpus(n, seed):
    rng = np.random.default_rng(seed)
    words = (
        "hello world goodbye this is a test of the translation engine "
        "quick brown fox jumps over lazy dog sentence splitting works"
    ).split()
    return [
        " ".join(rng.choice(words, rng.integers(4, 20))) + "."
        for _ in range(n)
    ]


def _host_params(width):
    from slimt_jax.config import ModelConfig
    from slimt_jax.io import load_items
    from slimt_jax.io.loader import load_weights
    from slimt_jax.io.synthetic import synthetic_model_bytes

    vocab, emb, ffn = WIDTHS[width]
    config = ModelConfig()
    return load_weights(
        load_items(synthetic_model_bytes(
            config=config, vocab_size=vocab, emb_dim=emb, ffn_dim=ffn, seed=0
        )),
        config,
    )


def _crosscheck():
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import crosscheck

    return crosscheck


@functools.lru_cache(maxsize=None)
def oracle_case(width):
    """The numerics inputs at one published width, the same in every
    process (seed 0): host weights, three activation blocks for the
    int8 accumulators, an [8, 32] batch with one padded row, its
    additive mask, its embedded input and the oracle's encoder
    output."""
    import jax

    sys.path.insert(0, ROOT)
    from tests import reference_impl as ref

    vocab, emb, _ = WIDTHS[width]
    host = _host_params(width)
    hostnp = jax.tree.map(np.asarray, host)
    rng = np.random.default_rng(0)
    acts = [rng.standard_normal((64, emb)).astype(np.float32)
            for _ in range(3)]
    b, t = 8, 32
    idx = rng.integers(3, vocab, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.float32)
    mask[1, 20:] = 0
    idx[1, 20:] = 0
    madd = ref.make_additive_mask(mask)
    x = ref.transform_embedding(ref.embed(hostnp, idx)).astype(np.float32)
    enc = ref.encoder_forward(hostnp, x, madd, 8).astype(np.float32)
    return types.SimpleNamespace(
        host=host, hostnp=hostnp, acts=acts, madd=madd, x=x, enc=enc
    )


def oracle_greedy(width, kv_dtype, argmax_method):
    """Greedy tokens [8, 24] of one numerics config, decoded from the
    oracle's encoder output at `width`."""
    import jax.numpy as jnp

    from slimt_jax import device
    from slimt_jax.io.loader import stack_layers
    from slimt_jax.models.decode import greedy_decode

    case = oracle_case(width)
    res = device.jit(lambda p, e, m: greedy_decode(
        p, e, m, 2, 24, 8, kv_dtype=kv_dtype, argmax_method=argmax_method,
        with_alignment=False,
    ))(stack_layers(case.host), jnp.asarray(case.enc), jnp.asarray(case.madd))
    return np.asarray(res.tokens)


def backend_tokens(with_exact=True):
    """The greedy tokens phase 3 compares across backends; the GPU run
    and the CPU subprocess both call this.

    {"declared": {label: one token list per sentence}} holds the
    declared serving config on every crosscheck serving cell (small
    widths, VOCAB 512) and, at each published width, on the 8 numerics
    sentences (decoded from the oracle's encoder output; label
    "<width> oracle8") and on a full-vocab sweep ("<width> sweep").
    "exact" holds the exact path (f32 cache, f32 argmax) on the same
    full-vocab sweeps. "oracle8" has the declared [8, 24] token arrays
    and "enc_sha256" a hash of the oracle encoder output each side
    decoded from."""
    import tempfile

    from slimt_jax.config import ModelConfig
    from slimt_jax.io.synthetic import synthetic_model_bytes

    cc = _crosscheck()
    declared = ModelConfig()
    config_kw = {
        "declared": dict(kv_dtype=declared.kv_cache_dtype,
                         argmax_method=declared.argmax_method,
                         with_alignment=False),
        "exact": dict(with_alignment=False),
    }
    out = {"declared": {}, "exact": {}, "oracle8": {}, "enc_sha256": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for label, enc, dec, heads, emb, ffn, seed in cc.CELLS:
            config, model_bytes, spm, _ = cc.write_package(
                tmp, enc, dec, heads, emb, ffn, seed
            )
            sentences = cc.serving_corpus(
                SWEEP_LINES_PER_CELL, spm.eos_id, seed + 300, batch=8
            )
            out["declared"][label] = cc.run_slimt_jax(
                model_bytes, config, sentences, 8, spm.eos_id,
                max(0, spm.pad_id), None, **config_kw["declared"],
            )
    for width, (vocab, emb, ffn) in WIDTHS.items():
        tokens = oracle_greedy(
            width, declared.kv_cache_dtype, declared.argmax_method
        ).tolist()
        out["oracle8"][width] = tokens
        out["declared"][f"{width} oracle8"] = tokens
        out["enc_sha256"][width] = hashlib.sha256(
            oracle_case(width).enc.tobytes()
        ).hexdigest()
        model_bytes = synthetic_model_bytes(
            config=declared, vocab_size=vocab, emb_dim=emb, ffn_dim=ffn,
            seed=0,
        )
        sentences = cc.serving_corpus(
            SWEEP_LINES_PER_WIDTH, 2, 300 + emb, batch=SWEEP_BATCH,
            vocab=vocab,
        )
        for name in ("declared", "exact") if with_exact else ("declared",):
            out[name][f"{width} sweep"] = cc.run_slimt_jax(
                model_bytes, declared, sentences, SWEEP_BATCH, 2, 0, None,
                **config_kw[name],
            )
    return out


def agreement(ref, got):
    """(token agreement %, exact-sentence %, sentences) over every
    sentence of `ref` ({label: [token list, ...]}), counted as the
    crosscheck serving sweep counts them."""
    se = st = ta = tt = 0
    for label in ref:
        for r, g in zip(ref[label], got[label]):
            st += 1
            se += int(r == g)
            tt += max(len(r), len(g))
            ta += sum(1 for a, b in zip(r, g) if a == b)
    return 100.0 * ta / max(1, tt), 100.0 * se / max(1, st), st


def triton_gemm_fusions(hlo):
    """Triton GEMM fusions in an optimized HLO module's text."""
    return sum(hlo.count(f'"kind":"{kind}"') for kind in (
        "__triton_gemm", "__triton_nested_gemm_fusion"))


# -- phases ----------------------------------------------------------------


def phase_device():
    import jax

    from slimt_jax.device import card_line

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: no GPU (JAX platform {devices[0].platform!r})"
        )
    _say(f"card: {card_line()}")
    _say(
        f"jax: platform={devices[0].platform} "
        f"kind={devices[0].device_kind} count={len(devices)}"
    )
    return devices


def phase_service():
    import urllib.request

    from slimt_jax.config import Config, ModelConfig
    from slimt_jax.models.model import Model
    from slimt_jax.runtime.service import Blocking
    from slimt_jax.server import TranslationServer, make_httpd

    model = Model(ModelConfig(), _package())
    with open(os.path.join(ROOT, "data", "sample.txt")) as f:
        sample = [line.rstrip("\n") for line in f if line.strip()]
    bulk = _corpus(64, seed=5)
    # No translation cache: each comparison below must decode.
    with Blocking(Config(cache_size=0)) as service:
        responses = service.translate(model, sample)
        _check(len(responses) == len(sample), "Blocking response count")
        for line, r in zip(sample, responses):
            _check(r.source.text == line, "source round trip")
            _check(r.target.sentence_count() >= 1, "empty target")
            _say(f"  blocking: {line!r} -> {r.target.text[:60]!r}")
        # Random weights rarely emit EOS, so a target's length is the
        # batch's step cap (1.5 x its longest source): compare the
        # server with Blocking on the same batches.
        want_one = [
            service.translate(model, [line])[0].target.text
            for line in (sample[0], sample[-1])
        ]
        want_bulk = [r.target.text for r in service.translate(model, bulk)]

    server = TranslationServer(Config(workers=2))
    server.add_model("tiny11", model)
    httpd = make_httpd(server, "127.0.0.1", 0)
    import threading

    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def call(path, payload=None):
        data = None if payload is None else json.dumps(payload).encode()
        with urllib.request.urlopen(
            urllib.request.Request(base + path, data=data), timeout=300
        ) as resp:
            return json.loads(resp.read())

    try:
        health = call("/health")
        _check(health["status"] == "ok", f"/health {health}")
        _say(f"  server /health: {health}")
        one = call("/translate", {"text": sample[0]})
        _check(one["target"] == want_one[0], "/translate text")
        _say(f"  server /translate: {one['target'][:60]!r} (= Blocking)")
        many = call("/translate", {"texts": bulk})
        _check(many["targets"] == want_bulk, "/translate bulk batch")
        _say(f"  server /translate texts: {len(bulk)} lines (= Blocking)")
        job = call("/submit", {"text": sample[-1]})["job"]
        deadline = time.time() + 300
        while True:
            body = call(f"/job/{job}")
            if body.get("done") or time.time() > deadline:
                break
            time.sleep(0.05)
        _check(body.get("target") == want_one[-1], f"/job {body}")
        _say(f"  server /submit + /job/{job}: done (= Blocking)")
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()

    vocab, emb, ffn = WIDTHS["base"]
    base_model = Model(ModelConfig(), _package("base"))
    rng = np.random.default_rng(3)
    eos = base_model.vocabulary.eos_id
    segments = [
        rng.integers(3, vocab, int(n)).tolist() + [eos]
        for n in rng.integers(4, 40, 64)
    ]
    hyps = base_model.forward(segments, need_alignment=False)
    _check(len(hyps) == 64, "base forward count")
    _check(
        all(h.target and 0 <= min(h.target) and max(h.target) < vocab
            for h in hyps),
        "base forward tokens out of range",
    )
    _say(
        f"  base (emb {emb}, ffn {ffn}) Model.forward B=64: "
        f"{sum(len(h.target) for h in hyps)} tokens"
    )


def phase_numerics(cpu_proc):
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, ROOT)
    import bench
    from tests import reference_impl as ref

    from slimt_jax import device
    from slimt_jax.config import ModelConfig
    from slimt_jax.io.loader import stack_layers
    from slimt_jax.models import transformer as tfm
    from slimt_jax.models.decode import translate_batch_jit
    from slimt_jax.ops import qmm

    misses = []
    declared = ModelConfig()

    def expect(ok, what):
        # Every comparison runs and prints; the phase fails at its end.
        if not ok:
            misses.append(what)
            _say(f"  MISS: {what}")

    # What the program's int8 dots compile to: cuBLAS, never a Triton
    # GEMM fusion (device.COMPILER_OPTIONS; PERF.md "bring-up").
    case = oracle_case("tiny11")
    hlo = translate_batch_jit.lower(
        stack_layers(case.host), jnp.zeros((8, 32), jnp.int32),
        jnp.ones((8, 32), jnp.float32), jnp.zeros((1024,), jnp.int32),
        eos_id=2, max_steps=24, num_heads=8, provider="xla_int8",
        kv_dtype=declared.kv_cache_dtype,
        argmax_method=declared.argmax_method, with_alignment=False,
        compact_output=True,
    ).compile().as_text()
    triton = triton_gemm_fusions(hlo)
    _say(f"  declared decode, compiled dots: {bench._dot_lowering(hlo)}; "
         f"Triton GEMM fusions: {triton} (tolerance 0)")
    expect(triton == 0, "Triton GEMM fusions in the compiled decode")

    oracle_tokens = {}
    for label in WIDTHS:
        vocab, emb, ffn = WIDTHS[label]
        case = oracle_case(label)
        hostnp, host, madd, x = case.hostnp, case.host, case.madd, case.x
        # int8 accumulators: bit-exact against integer NumPy.
        for (name, w), act in zip((
            ("enc0.att.q", hostnp["encoder"][0]["att"]["q"]),
            ("enc0.ffn.w1", hostnp["encoder"][0]["ffn"]["w1"]),
            ("logits", {"q": hostnp["emb"]["q"].T,
                        "aq": hostnp["out"]["aq"]}),
        ), case.acts):
            got = np.asarray(device.jit(qmm._int8_matmul)(
                qmm.quantize_activations(jnp.asarray(act), w["aq"]),
                jnp.asarray(w["q"]),
            ))
            want = (ref.quantize(act, w["aq"]).astype(np.int32)
                    @ w["q"].astype(np.int32))
            exact = np.array_equal(got, want)
            _say(f"  {label} int8 accumulators {name} {w['q'].shape}: "
                 + ("bit-exact" if exact else "DIFFER"))
            expect(exact, f"{label} {name} int8 acc")

        b = x.shape[0]

        def compare(what, got, want, tol, flip_tol=None):
            # Accumulation order may differ from NumPy's; where that
            # flips one int8 activation rint() the next affine moves a
            # whole row by a quantization step, so `flip_tol` bounds the
            # share of rows off by more than 1e-4 of max|ref|.
            scale = float(np.abs(want).max())
            diff = np.abs(got - want)
            err = float(diff.max()) / scale
            rows = diff.reshape(-1, diff.shape[-1]).max(axis=-1)
            flips = float((rows > 1e-4 * scale).mean())
            line = (f"  {label} {what}: max|err|/max|ref| = {err:.3g} "
                    f"(tolerance {tol})")
            if flip_tol is not None:
                line += (f", rows off > 1e-4: {100 * flips:.2f}% "
                         f"(tolerance {100 * flip_tol:g}%)")
            _say(line)
            expect(
                err <= tol and (flip_tol is None or flips <= flip_tol),
                f"{label} {what}",
            )

        layer0 = hostnp["encoder"][0]
        out, _ = ref.attention(layer0["att"], x, x, x, madd, 8)
        want = ref.ffn_block(layer0, out)
        got = np.asarray(device.jit(
            lambda l, xx, m: tfm.encoder_layer_forward(l, xx, m, 8)
        )(host["encoder"][0], jnp.asarray(x), jnp.asarray(madd)))
        compare("encoder layer 0", got, want, 5e-2, flip_tol=0.05)

        stacked = stack_layers(host)
        enc_want = case.enc
        enc_got = np.asarray(device.jit(
            lambda p, xx, m: tfm.encoder_forward(p, xx, m, 8)
        )(stacked, jnp.asarray(x), jnp.asarray(madd)))
        # Six cascaded int8 activation quantizations spread any flip
        # through later layers: only the magnitude is bounded.
        compare("encoder (6 layers)", enc_got, enc_want, 0.1)

        states = [np.zeros((b, 1, emb), np.float32) for _ in range(2)]
        xd = ref.transform_embedding(np.zeros((b, 1, emb), np.float32))
        for li, layer in enumerate(hostnp["decoder"]):
            h, states[li] = ref.ssru(layer["rnn"], states[li], xd)
            o, _ = ref.attention(layer["att"], h, enc_want, enc_want, madd, 8)
            xd = ref.ffn_block(layer, o)
        logits_want = ref.output_logits(hostnp, xd[:, 0, :])

        def first_step(p, enc, m):
            kv = tfm.precompute_cross_kv(p, enc, 8)
            st = tuple(jnp.zeros((b, 1, emb)) for _ in p["decoder"])
            x0 = tfm.transform_embedding(jnp.zeros((b, 1, emb)))
            logits, _, _ = tfm.decoder_step(p, st, x0, m, kv, 8)
            return logits

        logits_got = np.asarray(device.jit(first_step)(
            host, jnp.asarray(enc_want), jnp.asarray(madd)
        ))
        compare(f"first-step logits [{b},{vocab}]", logits_got,
                logits_want, 5e-2, flip_tol=0.05)

        toks_want, _, _ = ref.greedy_decode(
            hostnp, enc_want, madd, eos_id=2, max_steps=24, num_heads=8
        )
        oracle_tokens[label] = np.asarray(toks_want)
        # The exact path (f32 cache, f32 argmax) has the oracle's
        # numerics and is held to the bar here.
        pct = 100.0 * float(
            (oracle_greedy(label, None, "exact") == toks_want).mean())
        _say(f"  {label} greedy tokens kv=float32 argmax=exact: "
             f"{pct:.2f}% equal to the oracle (bar {AGREEMENT_BAR_PCT}%)")
        expect(pct >= AGREEMENT_BAR_PCT, f"{label} exact greedy tokens")

    # The declared config (int16 KV, packed_int argmax) rounds the
    # cache and the logits, so on a near-tie it may pick another token
    # than the f32 oracle: its distance from the oracle is a property
    # of the config, the same on either backend. Its bar is the CPU
    # run of the same code: the crosscheck serving cells, and at both
    # published widths the 8 sentences above and a full-vocab sweep.
    gpu = backend_tokens()
    stdout, stderr = cpu_proc.communicate(timeout=900)
    _check(cpu_proc.returncode == 0, f"CPU run failed: {stderr[-2000:]}")
    cpu = json.loads(stdout.strip().splitlines()[-1])
    for label in WIDTHS:
        same_input = cpu["enc_sha256"][label] == gpu["enc_sha256"][label]
        pct = {
            side: 100.0 * float((np.asarray(run["oracle8"][label])
                                 == oracle_tokens[label]).mean())
            for side, run in (("GPU", gpu), ("CPU", cpu))
        }
        _say(f"  {label} greedy tokens kv={declared.kv_cache_dtype} "
             f"argmax={declared.argmax_method} against the oracle: GPU "
             f"{pct['GPU']:.2f}%, CPU {pct['CPU']:.2f}% (reported; both "
             "decode the same oracle encoder output: "
             f"{'yes' if same_input else 'NO'})")
        expect(same_input, f"{label} oracle encoder output differs")
    for name in ("declared", "exact"):
        for label in cpu[name]:
            tok, sent, n = agreement(
                {label: cpu[name][label]}, gpu[name])
            _say(f"  {name} config vs CPU, {label} ({n} sentences): "
                 f"tokens {tok:.2f}%, exact sentences {sent:.2f}%")
    shipped = device.F32_DOT_PRECISION
    tok, sent, n = agreement(cpu["declared"], gpu["declared"])
    _say(f"  declared config vs CPU, every cell ({n} sentences, f32 dots "
         f"{shipped.name}): tokens {tok:.2f}%, exact sentences {sent:.2f}% "
         f"(bar {AGREEMENT_BAR_PCT}% / {AGREEMENT_BAR_PCT}%)")
    expect(tok >= AGREEMENT_BAR_PCT and sent >= AGREEMENT_BAR_PCT,
           "declared config agreement with the CPU")
    other = (jax.lax.Precision.DEFAULT
             if shipped == jax.lax.Precision.HIGHEST
             else jax.lax.Precision.HIGHEST)
    device.F32_DOT_PRECISION = other
    jax.clear_caches()
    try:
        tok_o, sent_o, _ = agreement(
            cpu["declared"], backend_tokens(with_exact=False)["declared"])
    finally:
        device.F32_DOT_PRECISION = shipped
        jax.clear_caches()
    _say(f"  declared config vs CPU, every cell, at f32 dots {other.name} "
         f"(not shipped): tokens {tok_o:.2f}%, exact sentences "
         f"{sent_o:.2f}%")
    _check(not misses, "; ".join(misses))


def phase_options():
    import jax
    import jax.numpy as jnp

    from slimt_jax.io.loader import stack_layers
    from slimt_jax.models.decode import translate_batch_jit, unpack_compact

    vocab = WIDTHS["tiny11"][0]
    host = _host_params("tiny11")
    params = {
        False: jax.device_put(stack_layers(host, decoder=False)),
        True: jax.device_put(stack_layers(host, decoder=True)),
    }
    rng = np.random.default_rng(1)
    declared = dict(
        kv_dtype="int16", argmax_method="packed_int", with_alignment=False,
        provider="xla_int8", compact_output=True,
    )
    variants = [("declared", {})]
    variants += [(f"kv={kv}", {"kv_dtype": kv}) for kv in (
        None, "int8", "k8v16", "k16v8", "float16", "bfloat16")]
    variants += [(f"argmax={m}", {"argmax_method": m})
                 for m in ("exact", "packed_fp16", "packed_bf16")]
    variants += [
        ("alignment", {"with_alignment": True}),
        ("shortlist", {"with_shortlist": True}),
        ("provider=f32", {"provider": "f32"}),
        ("encoder=float16", {"encoder_dtype": "float16"}),
        ("encoder=bfloat16", {"encoder_dtype": "bfloat16"}),
        ("compact=off", {"compact_output": False}),
        ("flash T=1024", {"flash_attention": True}),
    ]
    shortlist = jnp.asarray(np.sort(
        rng.choice(vocab, 1024, replace=False)).astype(np.int32))
    for label, opts in variants:
        kw = dict(declared, **opts)
        b, t = (1, 1024) if kw.get("flash_attention") else (4, 16)
        steps = 12
        idx = rng.integers(3, vocab, (b, t)).astype(np.int32)
        t0 = time.perf_counter()
        res = translate_batch_jit(
            params[kw["kv_dtype"] == "int8"], jnp.asarray(idx),
            jnp.ones((b, t), jnp.float32), shortlist, np.int32(steps),
            eos_id=2, max_steps=steps, num_heads=8, **kw,
        )
        if kw["compact_output"]:
            tokens, valid = unpack_compact(res.packed, steps)
        else:
            tokens, valid = np.asarray(res.tokens), np.asarray(res.valid)
        align = np.asarray(res.alignment)
        _check(valid[:, 0].all(), f"{label}: no first token")
        _check(
            (tokens >= 0).all() and (tokens < vocab).all(),
            f"{label}: token out of range",
        )
        _check(np.isfinite(align).all(), f"{label}: alignment not finite")
        _say(f"  option {label}: ok ({time.perf_counter() - t0:.1f} s incl. "
             "compile)")


def phase_four():
    import jax

    from slimt_jax.config import Config, ModelConfig
    from slimt_jax.models.model import Model
    from slimt_jax.parallel import sharding as shd
    from slimt_jax.runtime.service import Blocking

    devices = jax.devices()
    _check(len(devices) == 4, f"--four needs 4 GPUs, found {len(devices)}")
    package = _package()
    lines = _corpus(256, seed=11)
    rng = np.random.default_rng(4)
    segments = [
        rng.integers(3, WIDTHS["tiny11"][0], int(n)).tolist() + [2]
        for n in rng.integers(4, 60, 96)
    ]

    def run(model):
        hyps = model.forward(segments, need_alignment=False)
        with Blocking(Config()) as service:
            texts = [r.target.text for r in service.translate(model, lines)]
        return [h.target for h in hyps], texts

    # Mesh first, then Model, as README.md shows it.
    got = {}
    for label, mesh_axes, sharding in (
        ("DP data=4 (replicated weights)", {"data": 4}, "replicate"),
        ("DPxTP data=2 x model=2", {"data": 2, "model": 2}, "tp"),
    ):
        mesh = shd.make_mesh(**mesh_axes)
        got[label] = run(
            Model(ModelConfig(), package, mesh=mesh, sharding=sharding))
    want = run(Model(ModelConfig(), package))
    for label, (tokens, texts) in got.items():
        _check(tokens == want[0], f"{label}: tokens differ from one card")
        _check(texts == want[1], f"{label}: Blocking texts differ")
        _say(f"  {label}: {len(segments)} segments + {len(lines)} lines "
             "through Blocking, bit-exact with one card")

    sys.path.insert(0, ROOT)
    from __graft_entry__ import dryrun_multichip

    dryrun_multichip(4)
    _say("  dryrun_multichip(4): DPxTP flagship bit-exact, two-stage "
         "pipeline and sequence-parallel legs ran")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four", action="store_true",
                        help="run the four-card path only")
    parser.add_argument("--cpu-reference", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    if args.cpu_reference:
        # Child process of phase 3: the same code on the CPU backend.
        print(json.dumps(backend_tokens()))
        return 0

    from slimt_jax.device import configure_compile_cache

    configure_compile_cache()
    devices = phase_device()
    phases = [("multi-device", phase_four)] if args.four else [
        ("service", phase_service),
        ("numerics", None),
        ("options", phase_options),
    ]
    cpu_proc = None
    if not args.four:
        env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
        cpu_proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cpu-reference"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, cwd=ROOT,
        )
    failed = []
    try:
        for name, fn in phases:
            t0 = time.perf_counter()
            _say(f"phase {name}:")
            try:
                if fn is None:
                    phase_numerics(cpu_proc)
                else:
                    fn()
            except Exception as e:  # noqa: BLE001 — reported, run goes on
                import traceback

                traceback.print_exc()
                failed.append(name)
                _say(f"phase {name}: FAILED ({type(e).__name__}: {e})")
            else:
                _say(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)")
    finally:
        if cpu_proc is not None and cpu_proc.poll() is None:
            cpu_proc.kill()
            cpu_proc.wait()
    if failed:
        _say(f"chip_smoke: failed phases: {', '.join(failed)}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
