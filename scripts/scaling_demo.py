"""Shared-nothing fleet scaling demo (CPU; no device needed).

The absolute numbers this demo prints are bounded by CPU-JAX DECODE on
each backend, not by the fleet machinery — for the fleet/transport
measurement at real scale use scripts/fleet_budget.py (device
stubbed). This demo remains the end-to-end smoke of the REAL decode
path behind the router.

Starts N independent slimt_jax.server processes (the DEPLOYMENT.md
"N hosts" mode, each process = one host) behind the runtime.router
front door, pushes the same corpus through the router at each fleet
size, and reports tokens/s and scaling efficiency vs one backend.

On this mode there is no cross-host communication in the serving path,
so efficiency is bounded only by the client/router host's own cores —
with one process per GPU host and one router it is 1.0 by
construction.

Usage: python scripts/scaling_demo.py [--backends 1 2] [--lines 2000]
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

ENV = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)


def wait_health(url, timeout=120):
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
    return tokens / elapsed, len(body["targets"])


def run_fleet(pkg, n_backends, lines, base_port):
    procs = []
    try:
        urls = []
        for i in range(n_backends):
            port = base_port + 1 + i
            procs.append(
                subprocess.Popen(
                    [sys.executable, "-m", "slimt_jax.server",
                     "--root", pkg, "--port", str(port)],
                    env=ENV, cwd=REPO,
                    stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                )
            )
            urls.append(f"http://127.0.0.1:{port}")
        for url in urls:
            wait_health(url)
        router = subprocess.Popen(
            [sys.executable, "-m", "slimt_jax.runtime.router",
             "--port", str(base_port)]
            + [arg for url in urls for arg in ("--backend", url)],
            env=ENV, cwd=REPO,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
        procs.append(router)
        rurl = f"http://127.0.0.1:{base_port}"
        wait_health(rurl)
        push(rurl, corpus(200, seed=99))  # warm compile on every backend
        best = 0.0
        for it in range(3):
            tps, n = push(rurl, corpus(lines, seed=it))
            best = max(best, tps)
        return best
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--backends", type=int, nargs="+", default=[1, 2])
    parser.add_argument("--lines", type=int, default=2000)
    parser.add_argument("--base-port", type=int, default=18960)
    args = parser.parse_args()

    with tempfile.TemporaryDirectory() as tmp:
        pkg = os.path.join(tmp, "pkg")
        subprocess.run(
            [sys.executable, "-m", "slimt_jax", "synth", "--out", pkg],
            env=ENV, cwd=REPO, check=True, capture_output=True,
        )
        results = {}
        for n in args.backends:
            results[n] = run_fleet(pkg, n, args.lines, args.base_port)
            print(f"backends={n}: {results[n]:,.0f} tok/s", flush=True)
        if 1 in results:
            for n, tps in sorted(results.items()):
                eff = tps / (n * results[1]) if n else 0.0
                print(
                    f"scaling efficiency at {n} backend(s): {eff:.2f}",
                    flush=True,
                )
        print(json.dumps({
            "metric": "fleet_tokens_per_sec",
            "results": {str(k): round(v, 1) for k, v in results.items()},
        }))


if __name__ == "__main__":
    main()
