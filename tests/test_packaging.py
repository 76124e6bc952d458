"""Distribution-packaging tests: the `make -C native install` tree,
pkg-config and cmake package consumption, and the pure-Python wheel.

The reference installs libslimt + headers + slimt.pc + slimtConfig.cmake
under SLIMT_PACKAGE=ON (slimt/CMakeLists.txt:120-175) and wheels the
python binding via setup.py (packaging/PKGBUILD.python-slimt-git);
these tests exercise the slimt_jax analogs end to end against a staged
DESTDIR install.
"""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "native")

pytestmark = pytest.mark.skipif(
    shutil.which("make") is None or shutil.which("g++") is None,
    reason="no native toolchain",
)


@pytest.fixture(scope="module")
def staged_install(tmp_path_factory):
    stage = tmp_path_factory.mktemp("stage")
    subprocess.run(
        ["make", "-s", "-C", NATIVE, "install",
         f"DESTDIR={stage}", "PREFIX=/usr"],
        check=True, capture_output=True, text=True,
    )
    return os.path.join(stage, "usr")


def test_install_tree(staged_install):
    for rel in (
        "lib/libslimt_capi.so",
        "lib/libslimt_host.so",
        "lib/libslimt_jni.so",
        "include/slimt_capi.h",
        "lib/pkgconfig/slimt_jax.pc",
        "lib/cmake/slimt_jax/slimt_jaxConfig.cmake",
        "lib/cmake/slimt_jax/slimt_jaxConfigVersion.cmake",
    ):
        assert os.path.exists(os.path.join(staged_install, rel)), rel


@pytest.mark.skipif(shutil.which("pkg-config") is None, reason="no pkg-config")
def test_pkg_config_compile_link(staged_install, tmp_path):
    """A third-party C embedder builds against the installed tree using
    only `pkg-config slimt_jax` — the workflow slimt.pc exists for."""
    env = dict(os.environ)
    env["PKG_CONFIG_PATH"] = os.path.join(staged_install, "lib", "pkgconfig")
    # The staged prefix is /usr, which pkg-config elides as a system
    # dir; force emission so the flags can be rewritten to the stage.
    env["PKG_CONFIG_ALLOW_SYSTEM_CFLAGS"] = "1"
    env["PKG_CONFIG_ALLOW_SYSTEM_LIBS"] = "1"

    version = subprocess.run(
        ["pkg-config", "--modversion", "slimt_jax"],
        env=env, check=True, capture_output=True, text=True,
    ).stdout.strip()
    assert version == "0.1.0"
    flags = subprocess.run(
        ["pkg-config", "--cflags", "--libs", "slimt_jax"],
        env=env, check=True, capture_output=True, text=True,
    ).stdout.split()
    # The staged prefix is /usr inside DESTDIR; rewrite for the compile
    # (a real install would not need this).
    flags = [f.replace("/usr", staged_install) for f in flags]

    src = tmp_path / "embed.c"
    src.write_text(
        "#include <slimt_capi.h>\n"
        "int main(void) { return slimt_last_error() ? 1 : 0; }\n"
    )
    exe = tmp_path / "embed"
    subprocess.run(
        ["gcc", str(src), "-o", str(exe), *flags,
         f"-Wl,-rpath,{staged_install}/lib"],
        check=True, capture_output=True, text=True,
    )
    assert exe.exists()


@pytest.mark.skipif(shutil.which("cmake") is None, reason="no cmake")
def test_cmake_find_package(staged_install, tmp_path):
    """find_package(slimt_jax) resolves the imported targets — the
    consumer contract of slimtConfig.cmake.in in the reference."""
    (tmp_path / "CMakeLists.txt").write_text(
        "cmake_minimum_required(VERSION 3.16)\n"
        "project(consumer C)\n"
        "find_package(slimt_jax 0.1 REQUIRED)\n"
        "add_executable(embed embed.c)\n"
        "target_link_libraries(embed PRIVATE slimt_jax::capi)\n"
    )
    (tmp_path / "embed.c").write_text(
        "#include <slimt_capi.h>\n"
        "int main(void) { return slimt_last_error() ? 1 : 0; }\n"
    )
    build = tmp_path / "build"
    build.mkdir()
    subprocess.run(
        ["cmake", "-S", str(tmp_path), "-B", str(build),
         f"-DCMAKE_PREFIX_PATH={staged_install}"],
        check=True, capture_output=True, text=True,
    )
    subprocess.run(
        ["cmake", "--build", str(build)],
        check=True, capture_output=True, text=True,
    )
    assert (build / "embed").exists()

    # Version gate: requesting a newer major must fail.
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "CMakeLists.txt").write_text(
        "cmake_minimum_required(VERSION 3.16)\n"
        "project(consumer NONE)\n"
        "find_package(slimt_jax 1.0 REQUIRED)\n"
    )
    result = subprocess.run(
        ["cmake", "-S", str(bad), "-B", str(bad / "build"),
         f"-DCMAKE_PREFIX_PATH={staged_install}"],
        capture_output=True, text=True,
    )
    assert result.returncode != 0


@pytest.mark.slow
def test_wheel_builds_and_installs(tmp_path):
    """`pip wheel` from pyproject.toml produces an installable wheel
    whose console script and package land intact (the cibuildwheel
    path of the reference's CI, minus network)."""
    wheel_dir = tmp_path / "dist"
    subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-build-isolation",
         "--no-deps", "-w", str(wheel_dir), REPO],
        check=True, capture_output=True, text=True,
    )
    wheels = list(wheel_dir.glob("slimt_jax-*.whl"))
    assert len(wheels) == 1
    target = tmp_path / "site"
    subprocess.run(
        [sys.executable, "-m", "pip", "install", "--no-deps",
         "--target", str(target), str(wheels[0])],
        check=True, capture_output=True, text=True,
    )
    assert (target / "slimt_jax" / "cli.py").exists()
    # The wheel's package must import and expose the public API from
    # its own install dir (native/ is rebuilt or absent there — the
    # import path must not require it).
    probe = subprocess.run(
        [sys.executable, "-c",
         "import slimt_jax, slimt_jax.config; "
         "print(slimt_jax.config.ModelConfig().kv_cache_dtype)"],
        env={**os.environ, "PYTHONPATH": str(target),
             "JAX_PLATFORMS": "cpu"},
        check=True, capture_output=True, text=True,
    )
    assert probe.stdout.strip() == "int16"
