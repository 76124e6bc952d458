"""JNI binding (native/slimt_jni.cpp) driven by the fake-JVM harness.

No JDK exists in this environment, so native/jni_host.cpp stands in
for the JVM: it builds a spec-ordered JNINativeInterface_ table,
dlopens libslimt_jni.so with RTLD_LOCAL (exactly what HotSpot's
System.loadLibrary does), resolves the Java_* symbols by name, and
drives Model.ncreate -> Service.ncreate -> Service.ntranslate.
RTLD_LOCAL is the load mode that caught the embedded-libpython
visibility bug slimt_init now fixes (promote via
dlopen(RTLD_GLOBAL|RTLD_NOLOAD)) — keeping the harness on RTLD_LOCAL
is the regression test for it.

Counterpart of the reference's bindings/java/slimt.cpp surface
(Model/Service natives).
"""

import os
import shutil
import subprocess

import pytest

from tests.helpers import TINY_TEST_CONFIG, make_package

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "native")

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None or shutil.which("make") is None,
    reason="no C++ toolchain",
)


@pytest.fixture(scope="module")
def jni_artifacts():
    subprocess.run(
        ["make", "-s", "-C", NATIVE, "libslimt_jni.so", "jni_host"],
        check=True,
        timeout=300,
    )
    return (
        os.path.join(NATIVE, "libslimt_jni.so"),
        os.path.join(NATIVE, "jni_host"),
    )


@pytest.fixture(scope="module")
def package_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("jni_pkg")
    package = make_package(with_shortlist=True)
    for name, payload in (
        ("model.bin", package.model),
        ("vocab.spm", package.vocabulary),
        ("shortlist.bin", package.shortlist),
    ):
        (root / name).write_bytes(payload)
    return root


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["SLIMT_JAX_PYTHONPATH"] = REPO
    env.pop("XLA_FLAGS", None)  # plain single-device CPU is enough
    env.pop("SLIMT_JNI_FAKE_FAIL_FIELD", None)
    return env


def _run(jni_artifacts, package_dir, texts, env=None, timeout=600):
    library, host = jni_artifacts
    config = TINY_TEST_CONFIG
    return subprocess.run(
        [
            host,
            library,
            str(package_dir),
            str(config.encoder_layers),
            str(config.decoder_layers),
            str(config.feed_forward_depth),
            str(config.num_heads),
            *texts,
        ],
        capture_output=True,
        text=True,
        timeout=timeout,
        env=env or _env(),
    )


def test_jni_end_to_end(jni_artifacts, package_dir):
    texts = ["hello world .", "this is a test ."]
    result = _run(jni_artifacts, package_dir, texts)
    assert result.returncode == 0, result.stderr + result.stdout
    lines = result.stdout.splitlines()
    assert len(lines) == len(texts)
    assert all(isinstance(line, str) for line in lines)
    # Deterministic engine: same input twice -> same output.
    again = _run(jni_artifacts, package_dir, texts)
    assert again.stdout == result.stdout


def test_jni_missing_field_throws(jni_artifacts, package_dir):
    """A real JVM returns null from GetFieldID (pending
    NoSuchFieldError) when the Java class lacks a field; the binding
    must clear it and throw one RuntimeException instead of issuing
    JNI calls with an exception pending (UB per the JNI spec)."""
    env = _env()
    env["SLIMT_JNI_FAKE_FAIL_FIELD"] = "vocabulary"
    result = _run(jni_artifacts, package_dir, ["hello ."], env=env)
    assert result.returncode != 0
    assert "missing Java field: vocabulary" in result.stderr
