"""C embedding ABI (native/slimt_capi.{h,cpp} + slimt_jax/capi.py).

Two layers of coverage:
- the Python object-table backend directly (fast, no compiler);
- the real .so driven end-to-end from a compiled C++ host
  (examples/embed_capi.cc), the counterpart of the reference's JNI
  smoke path (bindings/java/slimt.cpp).
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

from tests.helpers import TINY_TEST_CONFIG, make_package

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "native")


@pytest.fixture(scope="module")
def package_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("capi_pkg")
    package = make_package(with_shortlist=True)
    for name, payload in (
        ("model.bin", package.model),
        ("vocab.spm", package.vocabulary),
        ("shortlist.bin", package.shortlist),
    ):
        (root / name).write_bytes(payload)
    return root


def _spec(package_dir, **overrides):
    spec = {
        "preset": "tiny",
        "encoder_layers": TINY_TEST_CONFIG.encoder_layers,
        "decoder_layers": TINY_TEST_CONFIG.decoder_layers,
        "num_heads": TINY_TEST_CONFIG.num_heads,
        "model": str(package_dir / "model.bin"),
        "vocabulary": str(package_dir / "vocab.spm"),
        "shortlist": str(package_dir / "shortlist.bin"),
    }
    spec.update(overrides)
    return json.dumps(spec)


def test_capi_python_backend(package_dir):
    from slimt_jax import capi

    capi.init()
    service = capi.service_create(1, 128)
    model = capi.model_create(_spec(package_dir))
    try:
        outputs = capi.translate(service, model, ["hello world ."])
        assert len(outputs) == 1 and isinstance(outputs[0], str)

        as_json = capi.translate(
            service, model, ["hello world ."], as_json=True
        )
        decoded = json.loads(as_json[0])
        assert decoded["source"]["text"] == "hello world ."
        assert decoded["target"]["text"] == outputs[0]
        # The JSON contract includes alignments even without html=1.
        assert decoded["alignments"] and decoded["alignments"][0]

        pivoted = capi.pivot(service, model, model, ["hello world ."])
        assert len(pivoted) == 1
    finally:
        capi.release(model)
        capi.release(service)
    with pytest.raises(KeyError):
        capi.translate(service, model, ["x"])


def test_capi_model_create_rejects_missing_file(package_dir):
    from slimt_jax import capi

    with pytest.raises(FileNotFoundError):
        capi.model_create(_spec(package_dir, model="/nonexistent/m.bin"))


@pytest.mark.skipif(
    shutil.which("g++") is None or shutil.which("make") is None,
    reason="no C++ toolchain",
)
def test_capi_shared_library_end_to_end(package_dir, tmp_path):
    subprocess.run(
        ["make", "-s", "-C", NATIVE, "libslimt_capi.so"],
        check=True,
        timeout=300,
    )
    binary = tmp_path / "embed_capi"
    subprocess.run(
        [
            "g++",
            "-std=c++17",
            os.path.join(REPO, "examples", "embed_capi.cc"),
            f"-I{NATIVE}",
            f"-L{NATIVE}",
            "-lslimt_capi",
            f"-Wl,-rpath,{NATIVE}",
            "-o",
            str(binary),
        ],
        check=True,
        timeout=300,
    )
    # Config overrides ride the spec via a tiny wrapper package dir:
    # embed_capi.cc uses the plain tiny preset, so hand it a package
    # built with the full preset shapes.
    from slimt_jax.config import preset

    full = tmp_path / "pkg"
    full.mkdir()
    package = make_package(config=preset.tiny(), emb_dim=32, ffn_dim=64)
    (full / "model.bin").write_bytes(package.model)
    (full / "vocab.spm").write_bytes(package.vocabulary)
    from slimt_jax.io.shortlist import build_synthetic_shortlist
    from slimt_jax.text.synthetic_vocab import DEFAULT_WORDS, build_spm_model

    vocab_size = max(len(build_spm_model(DEFAULT_WORDS).pieces), 64)
    (full / "shortlist.bin").write_bytes(
        build_synthetic_shortlist(vocab_size)
    )

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["SLIMT_JAX_PYTHONPATH"] = REPO
    env.pop("XLA_FLAGS", None)  # plain single-device CPU is enough
    result = subprocess.run(
        [str(binary), str(full)],
        capture_output=True,
        text=True,
        timeout=600,
        env=env,
        cwd=str(tmp_path),
    )
    assert result.returncode == 0, result.stderr + result.stdout
    lines = result.stdout.strip().splitlines()
    assert lines[-1] == "ok"
    assert lines[0].startswith("0\t")
    assert any(line.startswith("json\t{") for line in lines)


def _ctypes_lib():
    import ctypes

    path = os.path.join(NATIVE, "libslimt_capi.so")
    if not os.path.exists(path):
        pytest.skip("libslimt_capi.so not built")
    lib = ctypes.CDLL(path)
    lib.slimt_init.argtypes = [ctypes.c_char_p]
    lib.slimt_last_error.restype = ctypes.c_char_p
    lib.slimt_model_create.restype = ctypes.c_longlong
    lib.slimt_model_create.argtypes = [ctypes.c_char_p]
    return lib


@pytest.mark.skipif(shutil.which("make") is None, reason="no make")
def test_capi_error_reporting_via_ctypes(package_dir):
    """Load the .so into this (already-Python) process: slimt_init must
    cope with a live interpreter, and errors must surface through
    slimt_last_error instead of raising."""
    subprocess.run(
        ["make", "-s", "-C", NATIVE, "libslimt_capi.so"],
        check=True,
        timeout=300,
    )
    if sys.platform != "linux":
        pytest.skip("linux only")
    lib = _ctypes_lib()
    assert lib.slimt_init(REPO.encode()) == 0
    handle = lib.slimt_model_create(b'{"preset": "tiny", "model": "/nope"}')
    assert handle == 0
    message = lib.slimt_last_error().decode()
    assert "model_create" in message or "nope" in message or message
