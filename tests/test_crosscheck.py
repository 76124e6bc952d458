"""Reference-binary differential tests.

Compiles the ACTUAL reference implementation's core
(/root/reference/slimt — Io, TensorOps, QMM(Ruy), Modules,
Transformer, Shortlist, Splitter over the real PCRE2) into
crosscheck/bin/slimt_ref_harness and diffs slimt_jax against it.
This is the cross-implementation evidence layer on top of the NumPy
oracle (tests/reference_impl.py): the oracle shares an author with the
engine; the harness does not share code with either.

Full coverage (4 architectures × shortlist × batch, larger corpora,
the ruy-bias-bug quantification) lives in scripts/crosscheck.py; this
keeps a fast always-on slice in CI.

Skips if the reference tree or toolchain is unavailable.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

REFERENCE = "/root/reference/slimt"


def _build_harness():
    proc = subprocess.run(
        ["make", "-C", os.path.join(REPO, "crosscheck")],
        capture_output=True,
        text=True,
    )
    return proc.returncode == 0, proc.stderr


pytestmark = pytest.mark.skipif(
    not os.path.isdir(REFERENCE), reason="reference tree unavailable"
)


@pytest.fixture(scope="module")
def crosscheck():
    ok, err = _build_harness()
    if not ok:
        pytest.skip(f"reference harness did not build: {err[-500:]}")
    import crosscheck as cc

    return cc


@pytest.fixture(scope="module")
def cell(crosscheck, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("crosscheck_pkg"))
    label, enc, dec, heads, emb, ffn, seed = crosscheck.CELLS[2]  # narrow
    config, model_bytes, spm, paths = crosscheck.write_package(
        tmp, enc, dec, heads, emb, ffn, seed
    )
    return crosscheck, config, model_bytes, spm, paths


def test_shortlist_generation_bit_identical(cell):
    cc, config, model_bytes, spm, paths = cell
    from slimt_jax.io.shortlist import ShortlistGenerator

    with open(paths["shortlist.bin"], "rb") as f:
        gen = ShortlistGenerator(f.read(), cc.VOCAB)
    sentences = cc.corpus(12, spm.eos_id, 7)
    ref_lists = cc.run_reference(
        paths, config, sentences, 1, True, dump_shortlist=True
    )
    for sent, ref in zip(sentences, ref_lists):
        assert gen.generate(sent).tolist() == ref


@pytest.mark.parametrize("batch", [1, 8])
def test_full_vocab_decode_token_exact(cell, batch):
    cc, config, model_bytes, spm, paths = cell
    sentences = cc.corpus(8, spm.eos_id, 11)
    ref = cc.run_reference(paths, config, sentences, batch, False)
    got = cc.run_slimt_jax(
        model_bytes, config, sentences, batch, spm.eos_id,
        max(0, spm.pad_id), None,
    )
    assert got == ref


def test_shortlist_decode_token_exact_zero_bias(cell):
    # Zero logit bias isolates the reference Ruy provider's
    # unselected-bias bug (qmm/Ruy.inl.cc:169-199) — see
    # scripts/crosscheck.py docstring.
    cc, config, model_bytes, spm, paths = cell
    from slimt_jax.io.shortlist import ShortlistGenerator

    nobias = cc.zero_logit_bias(model_bytes)
    nobias_path = paths["model.bin"] + ".nobias"
    with open(nobias_path, "wb") as f:
        f.write(nobias)
    with open(paths["shortlist.bin"], "rb") as f:
        gen = ShortlistGenerator(f.read(), cc.VOCAB)
    sentences = cc.corpus(8, spm.eos_id, 13)
    ref = cc.run_reference(
        dict(paths, **{"model.bin": nobias_path}), config, sentences, 1, True
    )
    got = cc.run_slimt_jax(
        nobias, config, sentences, 1, spm.eos_id, max(0, spm.pad_id), gen
    )
    assert got == ref


def test_splitter_boundaries_byte_identical(crosscheck):
    class Args:
        verbose = True

    assert crosscheck.mode_split(Args()) == 0


def test_e2e_cli_text_identical(crosscheck):
    # The complete reference slimt-cli vs the repo CLI: text in,
    # translated text out (incl. HTML markup transfer).
    class Args:
        verbose = True

    assert crosscheck.mode_e2e(Args()) == 0


def test_text_pipeline_identical(crosscheck):
    # Reference TextProcessor + Annotation vs text/processor.py: same
    # tokenizer both sides, so any diff is wrap/EOS/annotation logic.
    class Args:
        verbose = True

    assert crosscheck.mode_process(Args()) == 0


def test_serving_config_agreement_vs_reference(cell):
    """CI slice of the serving-numerics differential
    (scripts/crosscheck.py serving): the SHIPPED config (int16 KV +
    packed_int argmax + alignment-free — ModelConfig defaults since
    round 5) vs the reference binary on one cell. The full published
    measurement (4 architectures x 2048 sentences/config = 99.69%
    tokens) lives in crosscheck/serving_agreement.json; this guards
    against a numerics regression sneaking into the default path
    between sweep runs."""
    cc, config, model_bytes, spm, paths = cell
    sentences = cc.serving_corpus(32, spm.eos_id, 17)
    ref = cc.run_reference(paths, config, sentences, 8, False)
    got = cc.run_slimt_jax(
        model_bytes, config, sentences, 8, spm.eos_id,
        max(0, spm.pad_id), None,
        kv_dtype="int16", argmax_method="packed_int",
        with_alignment=False,
    )
    tok_total = tok_agree = 0
    for r, g in zip(ref, got):
        n = max(len(r), len(g))
        tok_total += n
        tok_agree += sum(1 for a, b in zip(r, g) if a == b)
    agree = tok_agree / max(1, tok_total)
    # Small-sample floor well under the published 99.57% but far above
    # anything a broken int16/packed path would produce.
    assert agree >= 0.95, f"serving-config agreement {agree:.3f}"


def test_bleu_parity_harness(crosscheck):
    """CI slice of the one-command BLEU-parity harness
    (scripts/crosscheck.py bleu): both CLIs on 12 natural-corpus
    lines against the synthetic package, scored with scripts/bleu.py
    (itself sacrebleu-validated in test_bleu.py). Gates on the exact
    path reproducing the reference CLI's text (pseudo-reference
    mode)."""

    class Args:
        verbose = True
        bleu_package = None
        bleu_model = "model.bin"
        bleu_vocab = "vocab.spm"
        bleu_source = None
        bleu_reference = None
        bleu_lines = 12

    assert crosscheck.mode_bleu(Args()) == 0
