"""CLI smoke tests (subprocess, like the reference's test_cmdline.py)."""

import os
import subprocess
import sys

import pytest

ENV = dict(
    os.environ,
    JAX_PLATFORMS="cpu",
    PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(__file__))]
        + os.environ.get("PYTHONPATH", "").split(os.pathsep)
    ),
)


def _run(*argv, input_text=""):
    return subprocess.run(
        [sys.executable, "-m", "slimt_jax", *argv],
        input=input_text,
        capture_output=True,
        text=True,
        env=ENV,
        timeout=300,
    )


def test_synth_and_translate(tmp_path):
    out = str(tmp_path / "pkg")
    result = _run("synth", "--out", out)
    assert result.returncode == 0, result.stderr
    assert os.path.exists(os.path.join(out, "model.bin"))

    result = _run(
        "translate",
        "--root", out,
        "--shortlist", "shortlist.bin",
        "--preset", "tiny",
        input_text="hello world\n",
    )
    assert result.returncode == 0, result.stderr
    assert result.stdout.endswith("\n")


def test_translate_async(tmp_path):
    out = str(tmp_path / "pkg")
    assert _run("synth", "--out", out).returncode == 0
    result = _run(
        "translate",
        "--root", out,
        "--async",
        "--workers", "2",
        "--text", "hello world",
    )
    assert result.returncode == 0, result.stderr


def _seed_repository(tmp_path):
    """Local browsermt-style inventory + a cached archive: the offline
    path download must handle (reference repository.py:53-120 fetches
    then unpacks; here the fetch is already satisfied by the cache)."""
    import io
    import json
    import tarfile

    repo_dir = tmp_path / "repo"
    base = repo_dir / "slimt_jax" / "browsermt"
    (base / "archives").mkdir(parents=True)
    inventory = {
        "models": [
            {
                "code": "en-xx-tiny",
                "name": "English-Whatever tiny",
                "url": "https://example.invalid/en-xx-tiny.tar.gz",
            },
            {
                "code": "xx-en-tiny",
                "name": "Whatever-English tiny",
                "url": "https://example.invalid/xx-en-tiny.tar.gz",
            },
        ]
    }
    (base / "models.json").write_text(json.dumps(inventory))
    with tarfile.open(base / "archives" / "en-xx-tiny.tar.gz", "w:gz") as tar:
        for name, payload in (
            ("en-xx-tiny/config.intgemm8.yml", b"models:\n  - model.bin\n"),
            ("en-xx-tiny/model.bin", b"\x00" * 16),
        ):
            info = tarfile.TarInfo(name)
            info.size = len(payload)
            tar.addfile(info, io.BytesIO(payload))
    return str(repo_dir)


def test_download_unpacks_cached_archive(tmp_path):
    repo_root = _seed_repository(tmp_path)
    result = _run(
        "download", "-m", "en-xx-tiny", "--repo-root", repo_root
    )
    assert result.returncode == 0, result.stderr
    unpacked = os.path.join(
        repo_root, "slimt_jax", "browsermt", "models", "en-xx-tiny",
        "en-xx-tiny",
    )
    assert os.path.exists(os.path.join(unpacked, "config.intgemm8.yml"))
    assert os.path.exists(os.path.join(unpacked, "model.bin"))

    # The repository layer resolves the unpacked config path (what
    # `translate -m <code>` style flows consume in the reference).
    from slimt_jax.repository import TranslateLocallyLike

    repo = TranslateLocallyLike(
        "browsermt", "https://example.invalid/models.json", root=repo_root
    )
    assert repo.model_config_path("en-xx-tiny").endswith(
        "config.intgemm8.yml"
    )
    assert repo.models(filter_downloaded=True) == ["en-xx-tiny"]


def test_download_offline_failure_names_cache_path(tmp_path):
    repo_root = _seed_repository(tmp_path)
    result = _run(
        "download", "-m", "xx-en-tiny", "--repo-root", repo_root
    )
    assert result.returncode == 1
    assert "xx-en-tiny.tar.gz" in result.stderr  # where to drop the file
    assert "archives" in result.stderr


def test_download_unknown_model(tmp_path):
    repo_root = _seed_repository(tmp_path)
    result = _run("download", "-m", "nope", "--repo-root", repo_root)
    assert result.returncode == 1
    assert "unknown model" in result.stderr


def test_ls_inventory(tmp_path):
    repo_root = _seed_repository(tmp_path)
    result = _run("ls", "--all", "--repo-root", repo_root)
    assert result.returncode == 0, result.stderr
    assert "en-xx-tiny" in result.stdout and "xx-en-tiny" in result.stdout
    # Nothing downloaded yet: the filtered view is empty.
    result = _run("ls", "--repo-root", repo_root)
    assert "no models downloaded" in result.stdout
    _run("download", "-m", "en-xx-tiny", "--repo-root", repo_root)
    result = _run("ls", "--repo-root", repo_root)
    assert "en-xx-tiny" in result.stdout
    assert "xx-en-tiny" not in result.stdout


def test_ls_empty(tmp_path):
    result = _run("ls", "--root", str(tmp_path))
    assert result.returncode == 0


def test_cli_inspect(tmp_path, capsys):
    from slimt_jax.cli import main

    package = tmp_path / "pkg"
    assert main(["synth", "--out", str(package)]) == 0
    capsys.readouterr()
    assert main(["inspect", str(package / "model.bin")]) == 0
    out = capsys.readouterr().out
    assert "Wemb" in out and "intgemm8" in out and "scale=" in out
    assert "tensors" in out.splitlines()[-1]


def test_ci_smoke_sample_txt(tmp_path):
    """The reference CI smoke (scripts/ci/ubuntu/03-test.sh): pipe
    data/sample.txt through the CLI, one translation per input line."""
    out = str(tmp_path / "pkg")
    assert _run("synth", "--out", out).returncode == 0
    sample = os.path.join(
        os.path.dirname(os.path.dirname(__file__)), "data", "sample.txt"
    )
    with open(sample, encoding="utf-8") as f:
        text = f.read()
    result = _run("translate", "--root", out, input_text=text)
    assert result.returncode == 0, result.stderr
    lines = result.stdout.split("\n")
    assert len([l for l in lines if l]) == 2


def test_translate_remote_url():
    """--url turns the CLI into a fleet client (blocking + async job
    polling + error paths), against an in-process server."""
    import json
    import urllib.request

    from slimt_jax.config import Config
    from slimt_jax.server import TranslationServer, serve

    from .helpers import make_model

    server = TranslationServer(Config(workers=1, cache_size=0))
    server.add_model("en-de", make_model(seed=0))
    httpd = serve(server, host="127.0.0.1", port=0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        result = _run(
            "translate", "--url", url, "--remote-model", "en-de",
            "--text", "hello world",
        )
        assert result.returncode == 0, result.stderr
        assert result.stdout.strip()

        result = _run(
            "translate", "--url", url, "--async", "--poll", "0.05",
            "--text", "hello world",
        )
        assert result.returncode == 0, result.stderr
        assert result.stdout.strip()

        result = _run(
            "translate", "--url", url, "--remote-model", "nope",
            "--text", "x",
        )
        assert result.returncode == 1
        assert "404" in result.stderr
    finally:
        httpd.shutdown()
        server.close()


def test_translate_remote_unreachable():
    result = _run(
        "translate", "--url", "http://127.0.0.1:1", "--text", "x",
    )
    assert result.returncode == 1
    assert "cannot reach" in result.stderr


def test_translate_numerics_flags(tmp_path):
    """--exact / --kv-dtype / --argmax-method select execution
    numerics; --exact must reproduce the explicit f32+exact pair."""
    out = str(tmp_path / "pkg")
    assert _run("synth", "--out", out).returncode == 0
    base = _run(
        "translate", "--root", out, "--exact", "--text", "hello world"
    )
    assert base.returncode == 0, base.stderr
    explicit = _run(
        "translate", "--root", out, "--kv-dtype", "float32",
        "--argmax-method", "exact", "--text", "hello world",
    )
    assert explicit.stdout == base.stdout
    served = _run(
        "translate", "--root", out, "--kv-dtype", "int8",
        "--argmax-method", "packed_bf16", "--text", "hello world",
    )
    assert served.returncode == 0, served.stderr
    assert served.stdout.strip()
