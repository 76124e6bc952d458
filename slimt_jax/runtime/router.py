"""Multi-host request router (the serving front door).

The reference is single-machine: its `Threadsafe<AggregateBatcher>`
monitor (slimt/Batcher.hh:203-259) is the only channel between request
producers and the translate workers. The recommended
deployment is shared-nothing: one `slimt_jax.server` per GPU, each
owning its card (DEPLOYMENT.md). This module is the piece
that makes that a complete system rather than a diagram: an HTTP front
door that

  - health-checks every backend host (`GET /health`) on a background
    thread and ejects/readmits them as they fail/recover (the
    fail-fast-and-restart semantics of SURVEY §5 — a restarted host
    rejoins automatically);
  - routes each `POST /translate` to the healthy backend with the
    fewest requests in flight (least-loaded), failing over to the next
    backend on transport errors — client-visible at-most-N retries,
    never a hang;
  - optionally *shards* batched `{"texts": [...]}` requests across the
    healthy backends holding the requested model, in contiguous
    chunks, merging the results in order — one bulk client saturates
    the whole pod;
  - is model-aware on heterogeneous fleets: requests route to backends
    whose /health reports the requested model (and pivot) resident;
  - proxies the async job API with affinity: `POST /submit` routes
    like /translate and remembers the owning backend, `GET /job/<id>`
    polls that backend (mapping dropped when the job completes);
  - aggregates health: `GET /health` reports per-backend status and
    the union of resident models.

Run:  python -m slimt_jax.runtime.router --port 8000 \\
          --backend http://host0:8080 --backend http://host1:8080

Backend application errors (4xx/5xx JSON bodies) pass through
unchanged — the router only owns transport-level failures.
"""

from __future__ import annotations

import argparse
import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple


class Backend:
    """One serving host endpoint and its observed state."""

    def __init__(self, url: str):
        self.url = url.rstrip("/")
        self.healthy = True
        self.inflight = 0
        # None = inventory unknown (no successful sweep yet); [] = the
        # backend reported holding no models. The distinction matters
        # for model-affinity routing.
        self.models: Optional[List[str]] = None
        self.last_error: Optional[str] = None
        self._lock = threading.Lock()

    def begin(self) -> None:
        with self._lock:
            self.inflight += 1

    def end(self) -> None:
        with self._lock:
            self.inflight -= 1

    def mark(self, healthy: bool, error: Optional[str] = None,
             models: Optional[List[str]] = None) -> None:
        self.healthy = healthy
        self.last_error = error
        if models is not None:
            self.models = models


class RouterError(Exception):
    """Transport-level failure after exhausting failover candidates."""


class Router:
    def __init__(
        self,
        backend_urls: List[str],
        health_interval: float = 2.0,
        health_timeout: float = 5.0,
        request_timeout: float = 300.0,
        shard_batches: bool = True,
        min_shard: int = 8,
    ):
        if not backend_urls:
            raise ValueError("router needs at least one backend")
        self.backends = [Backend(u) for u in backend_urls]
        self.health_interval = health_interval
        self.health_timeout = health_timeout
        self.request_timeout = request_timeout
        self.shard_batches = shard_batches
        # Below this many texts, sharding a batch costs more in
        # per-request overhead + lost batch occupancy than it wins.
        self.min_shard = min_shard
        self._pool = ThreadPoolExecutor(
            max_workers=max(4, 2 * len(self.backends)),
            thread_name_prefix="router",
        )
        self._job_backends: Dict[str, Backend] = {}
        self._job_lock = threading.Lock()
        self.max_tracked_jobs = 65536
        self._stop = threading.Event()
        self._health_thread = threading.Thread(
            target=self._health_loop, daemon=True, name="router-health"
        )
        self.check_backends()  # synchronous first pass: start accurate
        self._health_thread.start()

    # -- health -------------------------------------------------------

    def _check_one(self, b: Backend) -> None:
        try:
            with urllib.request.urlopen(
                b.url + "/health", timeout=self.health_timeout
            ) as resp:
                body = json.loads(resp.read())
            b.mark(True, models=list(body.get("models", [])))
        except Exception as e:  # noqa: BLE001 — any transport error
            b.mark(False, error=f"{type(e).__name__}: {e}")

    def check_backends(self) -> None:
        """One health sweep, all backends probed in parallel — one
        wedged backend costs one timeout, not one per backend."""
        futures = [
            self._pool.submit(self._check_one, b) for b in self.backends
        ]
        for f in futures:
            f.result()

    def _health_loop(self) -> None:
        while not self._stop.wait(self.health_interval):
            self.check_backends()

    def close(self) -> None:
        self._stop.set()
        self._pool.shutdown(wait=False)

    def health(self) -> dict:
        healthy = [b for b in self.backends if b.healthy]
        models = sorted({m for b in healthy for m in (b.models or [])})
        return {
            "status": "ok" if len(healthy) == len(self.backends)
            else ("degraded" if healthy else "down"),
            "healthy_backends": len(healthy),
            "models": models,
            "backends": {
                b.url: {
                    "healthy": b.healthy,
                    "inflight": b.inflight,
                    "models": b.models,
                    "error": b.last_error,
                }
                for b in self.backends
            },
        }

    # -- routing ------------------------------------------------------

    def _has_models(self, b: Backend, needed: List[str]) -> bool:
        # models is None until a sweep succeeds — don't rule a backend
        # out on missing information. An actual [] means the backend
        # reported holding nothing: it IS ruled out.
        if not needed or b.models is None:
            return True
        return all(m in b.models for m in needed)

    def _needed_models(self, payload: dict) -> List[str]:
        needed = []
        if payload.get("model"):
            needed.append(payload["model"])
        if payload.get("pivot"):
            needed.append(payload["pivot"])
        return needed

    def _candidates(self, needed: Optional[List[str]] = None) -> List[Backend]:
        """Healthy backends holding the needed models, least-loaded
        first; then healthy backends without them (they 404 cleanly if
        really absent); unhealthy ones are appended as last-resort
        failover targets: a backend that just died may not have been
        swept yet, and symmetrically a swept-out backend may have
        already restarted."""
        needed = needed or []
        healthy = sorted(
            (b for b in self.backends if b.healthy),
            key=lambda b: (not self._has_models(b, needed), b.inflight),
        )
        rest = [b for b in self.backends if not b.healthy]
        return healthy + rest

    def _post_one(
        self, payload: dict, prefer: Optional[Backend] = None
    ) -> Tuple[int, dict]:
        """POST to the best backend, failing over across all of them."""
        status, body, _ = self._post_routed(payload, "/translate", prefer)
        return status, body

    def _post_routed(
        self,
        payload: dict,
        path: str,
        prefer: Optional[Backend] = None,
    ) -> Tuple[int, dict, Backend]:
        last: Optional[str] = None
        candidates = self._candidates(self._needed_models(payload))
        if prefer is not None and prefer in candidates:
            candidates.remove(prefer)
            candidates.insert(0, prefer)
        for b in candidates:
            b.begin()
            try:
                status, body = _post_json(
                    b.url + path, payload, self.request_timeout
                )
                return status, body, b
            except (urllib.error.URLError, ConnectionError, OSError) as e:
                last = f"{b.url}: {type(e).__name__}: {e}"
                b.mark(False, error=last)
            finally:
                b.end()
        raise RouterError(last or "no backends configured")

    def submit(self, payload: dict) -> Tuple[int, dict]:
        """Route POST /submit and remember which backend owns the job
        so /job/<id> polls reach the same host."""
        status, body, backend = self._post_routed(payload, "/submit")
        if status == 200 and "job" in body:
            with self._job_lock:
                if len(self._job_backends) >= self.max_tracked_jobs:
                    # Evict oldest mappings (dict preserves insertion
                    # order); their polls will 404, like an expired job.
                    for key in list(self._job_backends)[
                        : self.max_tracked_jobs // 10
                    ]:
                        del self._job_backends[key]
                self._job_backends[body["job"]] = backend
        return status, body

    def poll_job(self, job_id: str) -> Tuple[int, dict]:
        """Forward GET /job/<id> to the backend that owns the job."""
        with self._job_lock:
            backend = self._job_backends.get(job_id)
        if backend is None:
            return 404, {"error": f"unknown job {job_id!r}"}
        try:
            status, body = _get_json(
                backend.url + f"/job/{job_id}", self.request_timeout
            )
        except (urllib.error.URLError, ConnectionError, OSError) as e:
            backend.mark(False, error=f"{type(e).__name__}: {e}")
            return 502, {
                "error": f"backend holding job {job_id!r} unreachable"
            }
        if status == 404 or (status == 200 and body.get("done")):
            with self._job_lock:
                self._job_backends.pop(job_id, None)
        return status, body

    def handle(self, payload: dict) -> Tuple[int, dict]:
        texts = payload.get("texts")
        needed = self._needed_models(payload)
        eligible = [
            b for b in self.backends
            if b.healthy and self._has_models(b, needed)
        ]
        if (
            self.shard_batches
            and isinstance(texts, list)
            and len(eligible) > 1
            and len(texts) >= max(self.min_shard, len(eligible))
        ):
            return self._handle_sharded(payload, texts, eligible)
        return self._post_one(payload)

    def _handle_sharded(
        self, payload: dict, texts: list, eligible: List[Backend]
    ) -> Tuple[int, dict]:
        # Contiguous chunks keep sentence order (and thus any
        # client-side alignment of inputs to outputs) trivially intact.
        n = len(texts)
        ways = len(eligible)
        bounds = [(i * n) // ways for i in range(ways + 1)]
        chunks = [texts[bounds[i]: bounds[i + 1]] for i in range(ways)]
        # Pin chunk i to the i-th eligible backend (concurrent
        # least-loaded picks would race onto one backend); _post_one
        # still fails over if the pinned backend dies mid-request.
        futures = [
            self._pool.submit(
                self._post_one,
                {**payload, "texts": chunk},
                eligible[i % len(eligible)],
            )
            for i, chunk in enumerate(chunks)
            if chunk
        ]
        results = [f.result() for f in futures]
        # Any non-200 chunk fails the whole batch with that chunk's
        # error — partial translations would silently misalign the
        # client's outputs with its inputs.
        for status, body in results:
            if status != 200:
                return status, body
        merged: Dict[str, list] = {"targets": []}
        details: List = []
        has_detail = False
        for _, body in results:
            merged["targets"].extend(body.get("targets", []))
            d = body.get("detail")
            if d is not None:
                has_detail = True
                details.extend(d)
        merged["detail"] = details if has_detail else None
        return 200, merged


def _get_json(url: str, timeout: float) -> Tuple[int, dict]:
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read())
        except Exception:  # noqa: BLE001 — non-JSON error body
            return e.code, {"error": f"backend returned {e.code}"}


def _post_json(url: str, payload: dict, timeout: float) -> Tuple[int, dict]:
    request = urllib.request.Request(
        url,
        data=json.dumps(payload).encode("utf-8"),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(request, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        # Application-level error from the backend: pass through.
        try:
            return e.code, json.loads(e.read())
        except Exception:  # noqa: BLE001 — non-JSON error body
            return e.code, {"error": f"backend returned {e.code}"}


def make_handler(router: Router):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _reply(self, code: int, body: dict):
            data = json.dumps(body).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            try:
                if self.path == "/health":
                    health = router.health()
                    self._reply(
                        200 if health["status"] != "down" else 503, health
                    )
                elif self.path.startswith("/job/"):
                    status, body = router.poll_job(
                        self.path[len("/job/"):]
                    )
                    self._reply(status, body)
                else:
                    self._reply(404, {"error": "not found"})
            except Exception as e:  # noqa: BLE001
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def do_POST(self):
            if self.path not in ("/translate", "/submit"):
                self._reply(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length) or b"{}"
                try:
                    payload = json.loads(raw)
                except json.JSONDecodeError as e:
                    self._reply(400, {"error": f"invalid JSON body: {e}"})
                    return
                if not isinstance(payload, dict):
                    self._reply(
                        400, {"error": "request body must be a JSON object"}
                    )
                    return
                if self.path == "/submit":
                    status, body = router.submit(payload)
                else:
                    status, body = router.handle(payload)
                self._reply(status, body)
            except RouterError as e:
                self._reply(502, {"error": f"all backends failed: {e}"})
            except Exception as e:  # noqa: BLE001
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def make_httpd(
    router: Router, host: str = "127.0.0.1", port: int = 8000
) -> ThreadingHTTPServer:
    return ThreadingHTTPServer((host, port), make_handler(router))


def serve(router: Router, host: str = "127.0.0.1", port: int = 8000):
    httpd = make_httpd(router, host, port)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="route /translate across slimt_jax.server hosts"
    )
    parser.add_argument(
        "--backend", action="append", required=True,
        help="backend base URL (repeat per host)",
    )
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--health-interval", type=float, default=2.0)
    parser.add_argument(
        "--no-shard", action="store_true",
        help="never split 'texts' batches across backends",
    )
    args = parser.parse_args(argv)
    router = Router(
        args.backend,
        health_interval=args.health_interval,
        shard_batches=not args.no_shard,
    )
    httpd = make_httpd(router, args.host, args.port)
    health = router.health()
    print(
        f"routing on {args.host}:{args.port} over "
        f"{health['healthy_backends']}/{len(router.backends)} backends"
    )
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        router.close()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
