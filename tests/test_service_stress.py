"""Concurrency stress: many client threads hammering one Async
service (the reference's serving topology, slimt/Frontend.cc:207-257,
scaled up) must produce exactly the per-request-path Blocking outputs
for every call — no cross-request leakage, no lost completions, no
cache corruption.

Lines are built with EQUAL token counts so the decode-step cap
(limit_factor × the batch's longest source, slimt/Model.cc:160) is
identical under every batch composition the scheduler happens to pick
— synthetic models never emit EOS, so unequal lengths would make
outputs legitimately batch-dependent.
"""

import random
import threading

from slimt_jax.config import Config
from slimt_jax.runtime.response import Options
from slimt_jax.runtime.service import Async, Blocking

from .helpers import make_model

_WORDS = ["hello", "world", "quick", "brown", "fox", "dog", "lazy", "test"]


def _equal_length_pool(model, rng, n):
    pool = list(
        dict.fromkeys(" ".join(rng.sample(_WORDS, 4)) for _ in range(n * 2))
    )[:n]
    token_counts = {
        len(model.vocabulary.encode(line, add_eos=True)[0]) for line in pool
    }
    assert len(token_counts) == 1, "pool must be length-homogeneous"
    return pool


def test_async_concurrent_clients_deterministic():
    model = make_model()
    rng = random.Random(41)
    pool = _equal_length_pool(model, rng, 14)

    with Blocking(Config(cache_size=0, prefer_bulk=False)) as oracle_svc:
        oracle = {
            line: response.target.data
            for line, response in zip(
                pool, oracle_svc.translate(model, list(pool))
            )
        }

    errors = []
    with Async(Config(workers=3, cache_size=32, batch_latency=0.01)) as svc:
        def client(seed):
            crng = random.Random(seed)
            picks = [crng.choice(pool) for _ in range(25)]
            handles = [svc.translate(model, line) for line in picks]
            for line, handle in zip(picks, handles):
                response = handle.result(timeout=300)
                if response.source.text != line:
                    errors.append(
                        f"source mixed up: {line!r} -> "
                        f"{response.source.text!r}"
                    )
                elif response.target.data != oracle[line]:
                    errors.append(f"target diverged for {line!r}")

        threads = [
            threading.Thread(target=client, args=(100 + i,)) for i in range(8)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert not errors, errors[:5]


def test_async_concurrent_pivot_and_translate():
    """Interleaved pivot (continuation-chained two-leg requests) and
    plain translates from parallel clients, same determinism bar.

    Pivot breaks the module's equal-length premise: leg-2 re-tokenizes
    leg-1 output (slimt/TextProcessor.cc:159-199) so its segments are
    LONGER than leg-1's, and the decode-step cap is limit_factor × the
    batch's longest source (slimt/Model.cc:160) — co-batching a leg-1
    with a leg-2 segment would legitimately change the leg-1 output of
    a never-EOS synthetic model. max_words=9 forces singleton batches
    (a second 5-token segment needs (1+1)*5 = 10 > 9) so every cap is
    per-segment and batch-composition-independent; wrap_length=6 stays
    above the 4-content-token lines (no wrapping) while satisfying the
    Batcher's wrap_length*limit_factor <= max_words guard."""
    model = make_model()
    rng = random.Random(43)
    pool = _equal_length_pool(model, rng, 8)

    with Blocking(Config(cache_size=0, prefer_bulk=False)) as oracle_svc:
        translate_oracle = {
            line: response.target.data
            for line, response in zip(
                pool, oracle_svc.translate(model, list(pool))
            )
        }
        pivot_oracle = {
            line: response.target.data
            for line, response in zip(
                pool, oracle_svc.pivot(model, model, list(pool))
            )
        }

    errors = []
    with Async(
        Config(
            workers=2,
            cache_size=0,
            batch_latency=0.01,
            max_words=9,
            wrap_length=6,
        )
    ) as svc:
        def client(seed, do_pivot):
            crng = random.Random(seed)
            picks = [crng.choice(pool) for _ in range(10)]
            if do_pivot:
                handles = [svc.pivot(model, model, line) for line in picks]
                expected = pivot_oracle
            else:
                handles = [svc.translate(model, line) for line in picks]
                expected = translate_oracle
            for line, handle in zip(picks, handles):
                response = handle.result(timeout=300)
                if response.target.data != expected[line]:
                    errors.append(
                        f"{'pivot' if do_pivot else 'translate'} diverged "
                        f"for {line!r}"
                    )

        threads = [
            threading.Thread(target=client, args=(200 + i, i % 2 == 0))
            for i in range(6)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert not errors, errors[:5]


def test_async_concurrent_multi_model():
    """Two resident models (the AggregateBatcher case) served to
    parallel clients must never cross weights or vocabularies."""
    model_a = make_model(seed=0)
    model_b = make_model(seed=7)
    rng = random.Random(47)
    pool = _equal_length_pool(model_a, rng, 8)

    oracles = {}
    with Blocking(Config(cache_size=0, prefer_bulk=False)) as oracle_svc:
        for key, model in (("a", model_a), ("b", model_b)):
            oracles[key] = {
                line: response.target.data
                for line, response in zip(
                    pool, oracle_svc.translate(model, list(pool))
                )
            }
    assert oracles["a"] != oracles["b"], "models must actually differ"

    errors = []
    with Async(Config(workers=3, cache_size=16, batch_latency=0.01)) as svc:
        def client(seed, key, model):
            crng = random.Random(seed)
            picks = [crng.choice(pool) for _ in range(15)]
            handles = [svc.translate(model, line) for line in picks]
            for line, handle in zip(picks, handles):
                response = handle.result(timeout=300)
                if response.target.data != oracles[key][line]:
                    errors.append(f"model {key} diverged for {line!r}")

        threads = [
            threading.Thread(
                target=client,
                args=(300 + i, *(("a", model_a) if i % 2 else ("b", model_b))),
            )
            for i in range(6)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert not errors, errors[:5]
