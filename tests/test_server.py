"""HTTP serving endpoint tests (in-process)."""

import json
import urllib.request

import pytest

from slimt_jax.config import Config
from slimt_jax.server import TranslationServer, serve

from .helpers import make_model


@pytest.fixture(scope="module")
def endpoint():
    server = TranslationServer(Config(workers=1, cache_size=0))
    server.add_model("en-de", make_model(seed=0))
    server.add_model("de-en", make_model(seed=1))
    httpd = serve(server, host="127.0.0.1", port=0)
    port = httpd.server_address[1]
    yield f"http://127.0.0.1:{port}", server
    httpd.shutdown()
    server.close()


def _post(url, payload):
    request = urllib.request.Request(
        url + "/translate",
        data=json.dumps(payload).encode("utf-8"),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(request, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_health(endpoint):
    url, _ = endpoint
    with urllib.request.urlopen(url + "/health", timeout=30) as resp:
        body = json.loads(resp.read())
    assert body["status"] == "ok"
    assert body["models"] == ["de-en", "en-de"]


def test_translate(endpoint):
    url, _ = endpoint
    status, body = _post(url, {"text": "hello world", "model": "en-de"})
    assert status == 200
    assert body["source"] == "hello world"
    assert isinstance(body["target"], str)


def test_translate_detail(endpoint):
    url, _ = endpoint
    status, body = _post(
        url, {"text": "hello world", "model": "en-de", "detail": True}
    )
    assert status == 200
    assert body["detail"]["source"]["text"] == "hello world"


def test_pivot(endpoint):
    url, _ = endpoint
    status, body = _post(
        url, {"text": "hello world", "model": "en-de", "pivot": "de-en"}
    )
    assert status == 200
    assert body["source"] == "hello world"


def test_unknown_model(endpoint):
    url, _ = endpoint
    status, body = _post(url, {"text": "x", "model": "nope"})
    assert status == 404


def test_translate_batch_texts(endpoint):
    url, _ = endpoint
    texts = ["hello world", "a quick brown test", "hello world"]
    status, body = _post(url, {"texts": texts, "model": "en-de"})
    assert status == 200, body
    assert len(body["targets"]) == 3
    assert body["targets"][0] == body["targets"][2]  # same input
    assert body["detail"] is None

    status, body = _post(
        url, {"texts": ["hello"], "model": "en-de", "detail": True}
    )
    assert status == 200
    assert body["detail"][0]["source"]["text"] == "hello"


def test_pivot_batch_texts(endpoint):
    url, _ = endpoint
    status, body = _post(
        url,
        {"texts": ["hello world"], "model": "en-de", "pivot": "de-en"},
    )
    assert status == 200, body
    assert len(body["targets"]) == 1 and isinstance(body["targets"][0], str)


def test_bad_request_bodies(endpoint):
    """Malformed bodies get 400s, not 500s."""
    url, _ = endpoint
    status, body = _post(url, ["not", "an", "object"])
    assert status == 400
    assert "JSON object" in body["error"]

    request = urllib.request.Request(
        url + "/translate",
        data=b"{not json",
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(request, timeout=30) as resp:
            status = resp.status
    except urllib.error.HTTPError as e:
        status, body = e.code, json.loads(e.read())
    assert status == 400
    assert "invalid JSON" in body["error"]

    status, body = _post(url, {"model": "en-de"})
    assert status == 400
    assert "text" in body["error"]


@pytest.fixture(scope="module")
def bulk_endpoint():
    """Server with a tiny bulk_threshold so batch tests hit the bulk
    lane (and one with a huge threshold pinning the streaming lane,
    for differential comparison)."""
    from slimt_jax.server import serve as serve_fn

    bulk = TranslationServer(Config(workers=1, cache_size=0),
                             bulk_threshold=4)
    streaming = TranslationServer(Config(workers=1, cache_size=0),
                                  bulk_threshold=10**9)
    for server in (bulk, streaming):
        server.add_model("en-de", make_model(seed=0))
        server.add_model("de-en", make_model(seed=1))
    hb = serve_fn(bulk, host="127.0.0.1", port=0)
    hs = serve_fn(streaming, host="127.0.0.1", port=0)
    yield (
        f"http://127.0.0.1:{hb.server_address[1]}",
        f"http://127.0.0.1:{hs.server_address[1]}",
    )
    hb.shutdown()
    hs.shutdown()
    bulk.close()
    streaming.close()


def test_bulk_lane_matches_streaming_lane(bulk_endpoint):
    bulk_url, streaming_url = bulk_endpoint
    texts = [f"hello world {i}" for i in range(6)]
    payload = {"texts": texts, "model": "en-de", "detail": True}
    s1, via_bulk = _post(bulk_url, payload)
    s2, via_streaming = _post(streaming_url, payload)
    assert s1 == s2 == 200
    assert via_bulk["targets"] == via_streaming["targets"]
    assert via_bulk["detail"] == via_streaming["detail"]


def test_bulk_lane_pivot_matches_streaming(bulk_endpoint):
    bulk_url, streaming_url = bulk_endpoint
    texts = [f"hello world {i}" for i in range(5)]
    payload = {"texts": texts, "model": "en-de", "pivot": "de-en"}
    s1, via_bulk = _post(bulk_url, payload)
    s2, via_streaming = _post(streaming_url, payload)
    assert s1 == s2 == 200
    assert via_bulk["targets"] == via_streaming["targets"]


def test_stats_endpoint(bulk_endpoint):
    bulk_url, streaming_url = bulk_endpoint
    # One bulk-lane batch and one streaming single text on each server.
    _post(bulk_url, {"texts": [f"hi there {i}" for i in range(6)],
                     "model": "en-de"})
    _post(bulk_url, {"text": "hello stats", "model": "en-de"})
    with urllib.request.urlopen(bulk_url + "/stats", timeout=30) as r:
        stats = json.loads(r.read())
    assert stats["requests"] >= 2
    assert stats["lines"] >= 7
    assert stats["models"] == ["de-en", "en-de"]
    # Bulk lane ran (6 >= threshold 4) and streaming ran (single text).
    assert stats["bulk"]["batches"] >= 1
    assert stats["streaming"]["batches"] >= 1
    assert stats["streaming"]["wps_avg"] > 0
    assert 0 < stats["streaming"]["occupancy_avg"] <= 1
    # Errors counted.
    _post(bulk_url, {"text": "x", "model": "nope"})
    with urllib.request.urlopen(bulk_url + "/stats", timeout=30) as r:
        stats = json.loads(r.read())
    assert stats["errors"] >= 1


def test_job_submit_poll_fetch(endpoint):
    url, _ = endpoint
    # Single text job.
    status, body = _post_path(url, "/submit", {"text": "hello world",
                                               "model": "en-de"})
    assert status == 200
    job = body["job"]
    done = _poll_until_done(url, job)
    assert done["target"]
    assert done["source"] == "hello world"
    # The fetch that returned done=true consumed the job.
    status, body = _get_json(url, f"/job/{job}")
    assert status == 404

    # Batch job with detail.
    texts = [f"hello world {i}" for i in range(3)]
    status, body = _post_path(
        url, "/submit", {"texts": texts, "model": "en-de", "detail": True}
    )
    assert status == 200
    done = _poll_until_done(url, body["job"])
    assert len(done["targets"]) == 3
    assert len(done["detail"]) == 3

    status, body = _get_json(url, "/job/nope")
    assert status == 404


def test_job_progress_shape():
    """A zero-worker service never completes: the poll must keep
    reporting the Handle::info progress shape."""
    from slimt_jax.server import TranslationServer, serve as serve_fn

    server = TranslationServer(Config(workers=0, cache_size=0))
    server.add_model("en-de", make_model(seed=0))
    httpd = serve_fn(server, host="127.0.0.1", port=0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        status, body = _post_path(url, "/submit",
                                  {"text": "hello world", "model": "en-de"})
        assert status == 200
        status, poll = _get_json(url, f"/job/{body['job']}")
        assert status == 200
        assert poll["done"] is False
        progress = poll["progress"]
        assert progress["words"][1] > 0 and progress["words"][0] == 0
        assert progress["parts"] == [1, 1]
    finally:
        httpd.shutdown()
        server.close()


def _post_path(url, path, payload, timeout=120):
    request = urllib.request.Request(
        url + path,
        data=json.dumps(payload).encode("utf-8"),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(request, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get_json(url, path, timeout=30):
    try:
        with urllib.request.urlopen(url + path, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _poll_until_done(url, job, tries=600):
    import time as _time

    for _ in range(tries):
        status, body = _get_json(url, f"/job/{job}")
        assert status == 200, body
        if body["done"]:
            return body
        _time.sleep(0.05)
    raise AssertionError(f"job {job} never finished")


def test_concurrent_mixed_clients(bulk_endpoint):
    """16 parallel clients mixing blocking singles, bulk batches, and
    async jobs; every request succeeds and every batch keeps its
    input order (index is embedded in each line and must come back in
    position via detail.source)."""
    from concurrent.futures import ThreadPoolExecutor

    bulk_url, _ = bulk_endpoint

    def blocking_single(i):
        status, body = _post(bulk_url, {"text": f"hello single {i}",
                                        "model": "en-de"})
        assert status == 200, body
        assert body["source"] == f"hello single {i}"

    def bulk_batch(i):
        texts = [f"hello batch {i} line {j}" for j in range(6)]
        status, body = _post(bulk_url, {"texts": texts, "model": "en-de",
                                        "detail": True})
        assert status == 200, body
        assert len(body["targets"]) == 6
        for j, d in enumerate(body["detail"]):
            assert d["source"]["text"] == f"hello batch {i} line {j}"

    def job(i):
        status, body = _post_path(bulk_url, "/submit",
                                  {"text": f"hello job {i}",
                                   "model": "en-de"})
        assert status == 200, body
        done = _poll_until_done(bulk_url, body["job"])
        assert done["source"] == f"hello job {i}"

    work = [blocking_single, bulk_batch, job] * 6
    with ThreadPoolExecutor(max_workers=16) as pool:
        futures = [pool.submit(fn, i) for i, fn in enumerate(work)]
        for f in futures:
            f.result(timeout=180)


def test_bulk_timeout_maps_to_504(bulk_endpoint):
    bulk_url, _ = bulk_endpoint
    texts = [f"hello timeout {i}" for i in range(50)]
    status, body = _post(bulk_url, {"texts": texts, "model": "en-de",
                                    "timeout": 1e-6})
    assert status == 504
    assert "timed out" in body["error"]


def test_job_table_ttl_eviction():
    """A full job table admits new jobs once old ones expire."""
    from slimt_jax.server import TranslationServer

    server = TranslationServer(Config(workers=0, cache_size=0))
    server.add_model("en-de", make_model(seed=0))
    try:
        server.max_jobs = 2
        server.job_ttl_s = 0.0  # everything is immediately expired
        for _ in range(5):  # would overflow max_jobs without eviction
            server.submit({"text": "hello", "model": "en-de"})
    finally:
        server.close()
