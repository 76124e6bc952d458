"""Guards on the ONE-declared-serving-config discipline (CLAUDE.md):
ModelConfig's defaults, the bench defaults, and the committed parity
table must name the SAME configuration — and flash auto-selection
must follow the measured long-context winner."""

import json
import os

from slimt_jax.config import ModelConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_declared_config_has_committed_parity_row():
    """The committed serving_agreement.json must contain BOTH the
    lone-argmax row and the full-stack row for the shipped defaults,
    and the stack must meet the stated >=99%/99% bar."""
    config = ModelConfig()
    assert config.kv_cache_dtype == "int16"
    assert config.argmax_method == "packed_int"
    table = json.load(
        open(os.path.join(REPO, "crosscheck", "serving_agreement.json"))
    )["configs"]
    assert "argmax=packed_int" in table
    stack = table["packedint+int16+noalign"]
    assert stack["token_agreement_pct"] >= 99.0
    assert stack["sentence_exact_pct"] >= 99.0


def test_bench_defaults_match_model_config():
    """bench.py's env-default numerics = ModelConfig defaults (the
    one-config discipline is enforced, not assumed)."""
    src = open(os.path.join(REPO, "bench.py")).read()
    config = ModelConfig()
    assert f'BENCH_ARGMAX", "{config.argmax_method}"' in src
    assert f'BENCH_KV", "{config.kv_cache_dtype}"' in src


def test_resolve_flash_auto_matches_crossover():
    """On the H100 the einsum encoder attention beat the chunked form
    at every T from 256 to 4096 and came within 4% at T=128 (bench.py
    longctx), so there is no crossover to select on: the default is the
    einsum everywhere, and the chunked form is an explicit opt-in that
    Model passes through."""
    from tests.helpers import make_model

    assert ModelConfig().flash_attention is False
    model = make_model()
    model.config.flash_attention = True
    eos = model.vocabulary.eos_id
    want = make_model().forward([[5, 6, 7, eos]])[0].target
    assert model.forward([[5, 6, 7, eos]])[0].target == want
