"""Pipeline-parallel stage split and health/failure utilities."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from slimt_jax.config import ModelConfig
from slimt_jax.io import load_items
from slimt_jax.io.loader import load_weights, stack_layers
from slimt_jax.io.synthetic import synthetic_model_bytes
from slimt_jax.models.decode import translate_batch
from slimt_jax.parallel.pipeline import TwoStagePipeline
from slimt_jax.runtime.health import Watchdog, probe_devices

CONFIG = ModelConfig(encoder_layers=2, decoder_layers=2, num_heads=4)
VOCAB, EMB, FFN = 96, 32, 64


@pytest.fixture(scope="module")
def params():
    items = load_items(
        synthetic_model_bytes(
            config=CONFIG, vocab_size=VOCAB, emb_dim=EMB, ffn_dim=FFN, seed=4
        )
    )
    return stack_layers(load_weights(items, CONFIG))


def _batches(n=3, b=2, t=10, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        indices = rng.integers(1, VOCAB, (b, t)).astype(np.int32)
        mask = np.ones((b, t), np.float32)
        out.append((jnp.asarray(indices), jnp.asarray(mask)))
    return out


def test_two_stage_pipeline_matches_single_device(params):
    devices = jax.devices()
    assert len(devices) >= 2
    pipeline = TwoStagePipeline(
        params, CONFIG.num_heads, devices[0], devices[1], provider="xla_int8"
    )
    batches = _batches()
    results = pipeline.translate_batches(batches, eos_id=2, max_steps=8)
    for (indices, mask), result in zip(batches, results):
        want = translate_batch(
            params, indices, mask,
            eos_id=2, max_steps=8, num_heads=CONFIG.num_heads,
            provider="xla_int8",
        )
        np.testing.assert_array_equal(
            np.asarray(result.tokens), np.asarray(want.tokens)
        )
        np.testing.assert_array_equal(
            np.asarray(result.valid), np.asarray(want.valid)
        )
    # stage outputs actually live on the decoder device
    assert results[0].tokens.devices() == {devices[1]}


def test_probe_devices():
    probe = probe_devices(timeout=60)
    assert probe["ok"] is True
    assert len(probe["devices"]) == len(jax.local_devices())


def test_watchdog_fail_fast():
    calls = []

    def flaky(x):
        calls.append(x)
        raise ValueError("boom")

    dog = Watchdog(flaky, max_failures=2)
    for _ in range(2):
        with pytest.raises(ValueError):
            dog(1)
    assert not dog.healthy
    with pytest.raises(RuntimeError, match="unhealthy"):
        dog(1)
    assert len(calls) == 2  # no work attempted once unhealthy


def test_watchdog_recovers_on_success():
    state = {"fail": True}

    def sometimes(x):
        if state["fail"]:
            raise ValueError("boom")
        return x

    dog = Watchdog(sometimes, max_failures=3)
    with pytest.raises(ValueError):
        dog(1)
    state["fail"] = False
    assert dog(5) == 5
    assert dog.healthy
