"""Compiled native client against a live HTTP server.

The reference's JNI bindings (bindings/java/slimt.cpp) let a non-C++
host call the engine; slimt-jax's counterpart surfaces are the C ABI
(tests/test_capi.py) and the HTTP endpoint.  This test proves the
cross-language HTTP story end-to-end with a real compiled foreign
client (examples/http_client.cc, plain POSIX sockets), and — when a
JDK is present — compiles and runs examples/JavaClient.java the same
way.
"""

import os
import shutil
import subprocess

import pytest

from slimt_jax.config import Config
from slimt_jax.server import TranslationServer, serve

from .helpers import make_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def endpoint():
    server = TranslationServer(Config(workers=1, cache_size=0))
    server.add_model("en-de", make_model(seed=0))
    httpd = serve(server, host="127.0.0.1", port=0)
    port = httpd.server_address[1]
    yield "127.0.0.1", str(port)
    httpd.shutdown()
    server.close()


@pytest.fixture(scope="module")
def client_bin(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler")
    out = str(tmp_path_factory.mktemp("client") / "http_client")
    proc = subprocess.run(
        ["g++", "-std=c++17", "-O1",
         os.path.join(REPO, "examples", "http_client.cc"), "-o", out],
        capture_output=True, text=True,
    )
    assert proc.returncode == 0, proc.stderr
    return out


def test_cpp_client_translates(endpoint, client_bin):
    host, port = endpoint
    proc = subprocess.run(
        [client_bin, host, port, "hello world", "goodbye"],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 2
    assert all(line.strip() for line in lines)


def test_cpp_client_health_failure_path(client_bin):
    # Nothing listening: the client must fail cleanly, not hang.
    proc = subprocess.run(
        [client_bin, "127.0.0.1", "1"],  # port 1: connection refused
        capture_output=True, text=True, timeout=60,
    )
    assert proc.returncode == 1
    assert "health check failed" in proc.stderr


def test_java_client_translates(endpoint):
    javac, java = shutil.which("javac"), shutil.which("java")
    if not javac or not java:
        pytest.skip("no JDK in this environment")
    host, port = endpoint
    build = subprocess.run(
        [javac, "-d", "/tmp/javaclient",
         os.path.join(REPO, "examples", "JavaClient.java")],
        capture_output=True, text=True,
    )
    assert build.returncode == 0, build.stderr
    proc = subprocess.run(
        [java, "-cp", "/tmp/javaclient", "JavaClient",
         f"http://{host}:{port}", "hello world"],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
