"""Multi-host router tests: two in-process server backends behind one
Router front door — routing, batch sharding, health ejection/failover,
and error passthrough (DEPLOYMENT.md "N hosts" shared-nothing mode)."""

import json
import urllib.error
import urllib.request

import pytest

from slimt_jax.config import Config
from slimt_jax.runtime.router import Router, serve as serve_router
from slimt_jax.server import TranslationServer, serve as serve_backend

from .helpers import make_model


def _post(url, payload, timeout=120):
    request = urllib.request.Request(
        url + "/translate",
        data=json.dumps(payload).encode("utf-8"),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(request, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get_health(url, timeout=30):
    try:
        with urllib.request.urlopen(url + "/health", timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def fleet():
    """Two backends (same model pair) + a router over them."""
    model = make_model(seed=0)
    backends, httpds = [], []
    for _ in range(2):
        server = TranslationServer(Config(workers=1, cache_size=0))
        server.add_model("en-de", model)
        httpd = serve_backend(server, host="127.0.0.1", port=0)
        backends.append(server)
        httpds.append(httpd)
    urls = [f"http://127.0.0.1:{h.server_address[1]}" for h in httpds]
    router = Router(urls, health_interval=0.2, min_shard=2)
    rhttpd = serve_router(router, host="127.0.0.1", port=0)
    rurl = f"http://127.0.0.1:{rhttpd.server_address[1]}"
    yield rurl, router, urls, httpds, backends
    rhttpd.shutdown()
    router.close()
    for h in httpds:
        h.shutdown()
    for s in backends:
        s.close()


def test_health_aggregates(fleet):
    rurl, router, urls, _, _ = fleet
    status, body = _get_health(rurl)
    assert status == 200
    assert body["status"] == "ok"
    assert body["healthy_backends"] == 2
    assert body["models"] == ["en-de"]
    assert set(body["backends"]) == set(urls)


def test_single_text_routes(fleet):
    rurl, _, _, _, _ = fleet
    status, body = _post(rurl, {"text": "hello world", "model": "en-de"})
    assert status == 200
    assert body["source"] == "hello world"
    assert isinstance(body["target"], str)


def test_batch_shards_across_backends_in_order(fleet):
    rurl, router, urls, _, _ = fleet
    texts = [f"hello world {i}" for i in range(8)]
    status, body = _post(rurl, {"texts": texts, "model": "en-de"})
    assert status == 200
    assert len(body["targets"]) == len(texts)
    # Order-preservation: the same batch, unsharded, through one
    # backend directly must give the same targets in the same order.
    status2, direct = _post(urls[0], {"texts": texts, "model": "en-de"})
    assert status2 == 200
    assert body["targets"] == direct["targets"]


def test_batch_detail_merges(fleet):
    rurl, _, _, _, _ = fleet
    texts = [f"hello world {i}" for i in range(4)]
    status, body = _post(
        rurl, {"texts": texts, "model": "en-de", "detail": True}
    )
    assert status == 200
    assert len(body["detail"]) == len(texts)
    assert body["detail"][0]["source"]["text"].startswith("hello")


def test_application_errors_pass_through(fleet):
    rurl, _, _, _, _ = fleet
    status, body = _post(rurl, {"text": "x", "model": "nope"})
    assert status == 404
    assert "nope" in body["error"]
    status, body = _post(rurl, {"model": "en-de"})
    assert status == 400


def test_failover_and_ejection(fleet):
    rurl, router, urls, httpds, _ = fleet
    # Kill backend 0's HTTP listener (the service object stays alive —
    # the module fixture reuses it across tests via backend 1).
    httpds[0].shutdown()
    httpds[0].server_close()
    try:
        # Requests keep succeeding through failover even before the
        # health sweep notices.
        status, body = _post(rurl, {"text": "hello world", "model": "en-de"})
        assert status == 200
        # Batch requests also succeed (sharding degrades to one way).
        texts = [f"hello world {i}" for i in range(6)]
        status, body = _post(rurl, {"texts": texts, "model": "en-de"})
        assert status == 200
        assert len(body["targets"]) == 6
        # The sweep ejects the dead backend.
        router.check_backends()
        status, health = _get_health(rurl)
        assert health["status"] == "degraded"
        assert health["healthy_backends"] == 1
        assert health["backends"][urls[0]]["healthy"] is False
    finally:
        pass  # backend 0 stays down; later tests only need the router


def test_all_backends_down_is_502_then_503(fleet):
    rurl, router, urls, httpds, _ = fleet
    httpds[1].shutdown()
    httpds[1].server_close()
    router.check_backends()
    status, body = _post(rurl, {"text": "hello", "model": "en-de"})
    assert status == 502
    assert "all backends failed" in body["error"]
    status, health = _get_health(rurl)
    assert status == 503
    assert health["status"] == "down"


def test_model_affinity_heterogeneous_fleet():
    """Backends holding different model sets: requests route to the
    backend that has the model, and batch sharding only spans
    eligible backends."""
    s_ende = TranslationServer(Config(workers=1, cache_size=0))
    s_ende.add_model("en-de", make_model(seed=0))
    s_deen = TranslationServer(Config(workers=1, cache_size=0))
    s_deen.add_model("de-en", make_model(seed=1))
    h0 = serve_backend(s_ende, host="127.0.0.1", port=0)
    h1 = serve_backend(s_deen, host="127.0.0.1", port=0)
    urls = [f"http://127.0.0.1:{h.server_address[1]}" for h in (h0, h1)]
    router = Router(urls, health_interval=60.0, min_shard=2)
    rhttpd = serve_router(router, host="127.0.0.1", port=0)
    rurl = f"http://127.0.0.1:{rhttpd.server_address[1]}"
    try:
        status, health = _get_health(rurl)
        assert sorted(health["models"]) == ["de-en", "en-de"]
        # Singles route to the holder regardless of load ordering.
        for model in ("en-de", "de-en"):
            for _ in range(3):
                status, body = _post(rurl, {"text": "hello world",
                                            "model": model})
                assert status == 200, body
        # A batch for one model stays on its single holder (sharding
        # degrades to one way) and still succeeds.
        texts = [f"hello world {i}" for i in range(8)]
        status, body = _post(rurl, {"texts": texts, "model": "de-en"})
        assert status == 200, body
        assert len(body["targets"]) == 8
    finally:
        rhttpd.shutdown()
        router.close()
        h0.shutdown()
        h1.shutdown()
        s_ende.close()
        s_deen.close()


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


def test_job_api_proxies_with_affinity():
    """Jobs submitted through the router poll the backend that owns
    them; empty-inventory backends are ineligible for routing."""
    import time as _time

    s_full = TranslationServer(Config(workers=1, cache_size=0))
    s_full.add_model("en-de", make_model(seed=0))
    s_empty = TranslationServer(Config(workers=1, cache_size=0))  # no models
    h0 = serve_backend(s_empty, host="127.0.0.1", port=0)
    h1 = serve_backend(s_full, host="127.0.0.1", port=0)
    urls = [f"http://127.0.0.1:{h.server_address[1]}" for h in (h0, h1)]
    router = Router(urls, health_interval=60.0, min_shard=2)
    rhttpd = serve_router(router, host="127.0.0.1", port=0)
    rurl = f"http://127.0.0.1:{rhttpd.server_address[1]}"
    try:
        # Submit via the router (must land on the model holder).
        status, body = _post_path(rurl, "/submit",
                                  {"text": "hello world", "model": "en-de"})
        assert status == 200, body
        job = body["job"]
        for _ in range(600):
            status, poll = _get_json(rurl, f"/job/{job}")
            assert status == 200, poll
            if poll["done"]:
                break
            _time.sleep(0.05)
        assert poll["done"] and poll["target"]
        # Consumed: mapping dropped on the router AND the backend.
        status, poll = _get_json(rurl, f"/job/{job}")
        assert status == 404
        status, poll = _get_json(rurl, "/job/zzz")
        assert status == 404
        # Batches for en-de never shard onto the empty backend.
        texts = [f"hello world {i}" for i in range(8)]
        status, body = _post_path(rurl, "/translate",
                                  {"texts": texts, "model": "en-de"})
        assert status == 200, body
        assert len(body["targets"]) == 8
    finally:
        rhttpd.shutdown()
        router.close()
        h0.shutdown()
        h1.shutdown()
        s_full.close()
        s_empty.close()
