"""Router-sharded fleet throughput at absolute scale (no device needed).

scripts/scaling_demo.py runs REAL CPU-JAX decode on every backend, so
it measures CPU decode, not the fleet. This script measures the fleet
itself: N slimt_jax.server processes with the DEVICE FORWARD
STUBBED to an instant echo (SLIMT_JAX_STUB_DEVICE=1 — every host stage
real: HTTP, JSON, ingest, packing, completion, detokenize) behind
runtime.router, 10k-line corpus, aggregate tokens/s vs N.

Rows:
  local_bulk   — in-process Blocking.translate_bulk on a stubbed
                 model: the transportless single-process host ceiling
  direct N=1   — one stubbed backend, client POSTs straight to it:
                 + HTTP/JSON transport, no router
  router N=k   — k stubbed backends behind the router (batch-sharded)

The interesting ratios: direct/local = transport cost; router(1)/direct
= router hop cost; router(k)/(k·router(1)) = fleet efficiency.
Reference match: the worker-pool serving model being generalized,
slimt/Frontend.cc:207-227.

Usage: python scripts/fleet_budget.py [--lines 10000] [--backends 1 2 3]
Prints one JSON object.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

ENV = dict(
    os.environ,
    JAX_PLATFORMS="cpu",
    PYTHONPATH=REPO,
    SLIMT_JAX_STUB_DEVICE="1",
)


def corpus(lines, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    words = (
        "hello world goodbye this is a test of the translation engine "
        "quick brown fox jumps over lazy dog sentence splitting works"
    ).split()
    return [
        " ".join(rng.choice(words, rng.integers(6, 24)))
        for _ in range(lines)
    ]


def wait_health(url, timeout=180):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(url + "/health", timeout=5) as r:
                if json.loads(r.read()).get("status") == "ok":
                    return
        except Exception:  # noqa: BLE001
            pass
        time.sleep(0.5)
    raise RuntimeError(f"{url} never became healthy")


def push(url, texts):
    request = urllib.request.Request(
        url + "/translate",
        data=json.dumps({"texts": texts}).encode("utf-8"),
        headers={"Content-Type": "application/json"},
    )
    t0 = time.perf_counter()
    with urllib.request.urlopen(request, timeout=1200) as resp:
        body = json.loads(resp.read())
    elapsed = time.perf_counter() - t0
    tokens = sum(len(t.split()) for t in body["targets"])
    assert len(body["targets"]) == len(texts)
    return tokens / elapsed


def best_push(url, lines, iters=3):
    push(url, corpus(256, seed=99))  # warm buckets + ingest pool
    return max(push(url, corpus(lines, seed=i)) for i in range(iters))


def start_backend(pkg, port):
    proc = subprocess.Popen(
        [sys.executable, "-m", "slimt_jax.server",
         "--root", pkg, "--port", str(port), "--workers", "2"],
        env=ENV, cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    return proc, f"http://127.0.0.1:{port}"


def stop_all(procs):
    for p in procs:
        p.terminate()
    for p in procs:
        try:
            p.wait(timeout=20)
        except subprocess.TimeoutExpired:
            p.kill()


def local_bulk_rate(pkg, n):
    """Transportless in-process ceiling: stubbed model through
    Blocking.translate_bulk."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from slimt_jax.config import Config, preset
    from slimt_jax.models.model import Model, Package
    from slimt_jax.runtime.service import Blocking
    from slimt_jax.utils import stub_device_forward

    # Same package the servers load, same host pipeline.
    model = Model(
        preset.tiny(),
        Package(
            model=os.path.join(pkg, "model.bin"),
            vocabulary=os.path.join(pkg, "vocab.spm"),
        ),
    )
    stub_device_forward(model)
    with Blocking(Config(cache_size=0, max_words=8192)) as svc:
        svc.translate_bulk(model, corpus(n))  # warm
        best = 0.0
        for i in range(3):
            t = corpus(n, seed=i)
            t0 = time.perf_counter()
            responses = svc.translate_bulk(model, t)
            elapsed = time.perf_counter() - t0
            toks = sum(
                r.target.word_count(s)
                for r in responses
                for s in range(r.target.sentence_count())
            )
            best = max(best, toks / elapsed)
    return best


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--lines", type=int, default=10000)
    parser.add_argument("--backends", type=int, nargs="+", default=[1, 2, 3])
    parser.add_argument("--base-port", type=int, default=18970)
    args = parser.parse_args()

    with tempfile.TemporaryDirectory() as tmp:
        pkg = os.path.join(tmp, "pkg")
        subprocess.run(
            [sys.executable, "-m", "slimt_jax", "synth", "--out", pkg],
            env=ENV, cwd=REPO, check=True, capture_output=True,
        )

        out = {"lines": args.lines, "cores": os.cpu_count()}
        out["local_bulk_tps"] = round(
            local_bulk_rate(pkg, args.lines), 1
        )
        print(f"local bulk: {out['local_bulk_tps']:,.0f} tok/s", flush=True)

        # Direct (routerless) single backend.
        procs = []
        try:
            proc, url = start_backend(pkg, args.base_port + 1)
            procs.append(proc)
            wait_health(url)
            out["direct_tps"] = round(best_push(url, args.lines), 1)
            print(f"direct N=1: {out['direct_tps']:,.0f} tok/s", flush=True)
        finally:
            stop_all(procs)

        # Router-sharded fleets.
        fleet = {}
        for n in args.backends:
            procs = []
            try:
                urls = []
                for i in range(n):
                    proc, url = start_backend(pkg, args.base_port + 1 + i)
                    procs.append(proc)
                    urls.append(url)
                for url in urls:
                    wait_health(url)
                router = subprocess.Popen(
                    [sys.executable, "-m", "slimt_jax.runtime.router",
                     "--port", str(args.base_port)]
                    + [a for u in urls for a in ("--backend", u)],
                    env=ENV, cwd=REPO,
                    stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                )
                procs.append(router)
                rurl = f"http://127.0.0.1:{args.base_port}"
                wait_health(rurl)
                fleet[n] = round(best_push(rurl, args.lines), 1)
                print(
                    f"router N={n}: {fleet[n]:,.0f} tok/s", flush=True
                )
            finally:
                stop_all(procs)

        out["router_tps"] = {str(k): v for k, v in fleet.items()}
        if 1 in fleet:
            out["fleet_efficiency"] = {
                str(n): round(tps / (n * fleet[1]), 3)
                for n, tps in fleet.items()
            }
        out["transport_cost_pct"] = round(
            100.0 * (1 - out["direct_tps"] / out["local_bulk_tps"]), 1
        )
        print(json.dumps(out))


if __name__ == "__main__":
    main()
