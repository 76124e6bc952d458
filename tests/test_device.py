"""Device questions answered in one place (slimt_jax.device) and the
benchmark's device bookkeeping (bench.py): compile-cache placement,
the f32 dot precision, the backend function, the peak table and the
trace reduction."""

import os
import re
import subprocess
import sys

import jax
import pytest

from slimt_jax import device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import bench  # noqa: E402


def test_compile_cache_default_is_fixed_in_checkout():
    path = device.compile_cache_dir({})
    assert path == os.path.join(REPO, ".jax_cache")
    assert device.compile_cache_dir({"HOME": "/elsewhere"}) == path


def test_compile_cache_env_wins_and_program_sets_none():
    assert device.compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/some/dir"}
    ) is None
    # An empty value counts as unset.
    assert device.compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": ""}) == (
        os.path.join(REPO, ".jax_cache")
    )


def test_compile_cache_is_gitignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_configure_compile_cache_in_fresh_process(tmp_path, env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    code = (
        "import jax; from slimt_jax.device import configure_compile_cache;"
        "configure_compile_cache();"
        "print(jax.config.jax_compilation_cache_dir)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        check=True, cwd=REPO, env=env,
    ).stdout.strip()
    want = str(tmp_path / env_dir) if env_dir else os.path.join(
        REPO, ".jax_cache"
    )
    assert out == want


def test_f32_dots_ask_for_highest_precision():
    assert device.F32_DOT_PRECISION == jax.lax.Precision.HIGHEST


def test_upcast_mixed_dots_follows_backend(monkeypatch):
    assert device.upcast_mixed_dots() is True  # the suite runs on CPU
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert device.upcast_mixed_dots() is False


def test_card_line_without_nvidia_smi(monkeypatch):
    monkeypatch.setenv("PATH", "/nonexistent")
    assert device.card_line() == ""


def test_peak_table_h100_sxm():
    peak = bench.peak_rates("NVIDIA H100 80GB HBM3")
    assert peak["hbm_gbps"] == 3350.0
    assert peak["int8_tops"] == 1979.0


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB"])
def test_peak_table_unknown_kind_gets_no_share(kind):
    assert bench.peak_rates(kind) is None


def test_hbm_share_omitted_for_unknown_device():
    result = bench.hbm_share({"value": 1.0}, 123.45)
    assert result["hbm_gbps"] == 123.5
    assert "pct_peak_hbm" not in result  # the CPU is not in PEAKS


def test_bench_refuses_to_measure_on_cpu():
    with pytest.raises(SystemExit) as exit_info:
        bench.device_fields()
    assert exit_info.value.code == 2


def test_reduce_trace_busy_union_and_idle_share():
    events = [
        ("a", 0, 10), ("b", 5, 15),  # overlap: union 0..15
        ("a", 20, 30),  # gap 15..20
        ("c", 22, 25),  # nested
    ]
    red = bench.reduce_trace(events, window_ns=40)
    assert red["busy_ns"] == 25
    assert red["idle_share"] == pytest.approx(1 - 25 / 40)
    assert red["per_op_ns"] == {"a": 20, "b": 10, "c": 3}


def test_dot_lowering_classifies_gemms():
    hlo = "\n".join([
        '  %cublas-gemm.1 = (s32[64,256]{1,0}, s8[0]{0}) custom-call('
        's8[64,256]{1,0} %a, s8[256,256]{1,0} %b), '
        'custom_call_target="__cublas$gemm"',
        '  %cublas-gemm.5 = (f32[8,64]{1,0}, s8[4096]{0}) custom-call('
        'f32[8,32]{1,0} %c, f32[32,64]{1,0} %d), '
        'custom_call_target="__cublas$gemm"',
        '  %gemm_fusion_dot.2 = f32[8,64]{1,0} fusion(f32[8,32]{1,0} %x, '
        'f32[32,64]{1,0} %y), kind=kCustom, calls=%gemm_fusion_dot.2.c',
        '  %dot.3 = s32[4,8]{1,0} dot(s8[4,16]{1,0} %p, s8[16,8]{1,0} %q)',
        '  %add.4 = f32[4]{0} add(f32[4]{0} %u, f32[4]{0} %v)',
    ])
    assert bench._dot_lowering(hlo) == {
        "__cublas$gemm [s8]": 1,
        "__cublas$gemm [f32]": 1,
        "fusion(kCustom) [f32]": 1,
        "dot [s8]": 1,
    }


def test_dot_lowering_resolves_untyped_operands():
    # Optimized HLO names operands without types.
    hlo = "\n".join([
        '  %p.0 = s8[64,256]{1,0} parameter(0)',
        '  %block_fusion = s8[256,256]{0,1} fusion(%p.1), kind=kLoop',
        '  %cublas-gemm.1 = (s32[64,256]{1,0}, s8[0]{0}) custom-call('
        '%p.0, %block_fusion), custom_call_target="__cublas$gemm"',
        '  %f.2 = f32[8,32]{1,0} parameter(1)',
        '  %cublas-gemm.2 = (f32[8,8]{1,0}, s8[0]{0}) custom-call('
        '%f.2, %f.2), custom_call_target="__cublas$gemm"',
    ])
    assert bench._dot_lowering(hlo) == {
        "__cublas$gemm [s8]": 1,
        "__cublas$gemm [f32]": 1,
    }


def test_compiler_options_turn_off_triton_gemm_only():
    assert device.COMPILER_OPTIONS == {"xla_gpu_enable_triton_gemm": False}


def test_jit_carries_compiler_options():
    lowered = device.jit(lambda x: x @ x).lower(jax.numpy.ones((4, 4)))
    assert lowered._lowering._compiler_options_kvs == tuple(
        device.COMPILER_OPTIONS.items()
    )
    # Compiles and runs on a backend that has no such option of its own.
    assert float(lowered.compile()(jax.numpy.ones((4, 4))).sum()) == 64.0


def test_jit_keeps_jax_jit_arguments():
    fn = device.jit(lambda x, n: x * n, static_argnames=("n",))
    assert float(fn(jax.numpy.ones(3), n=2).sum()) == 6.0


def test_translate_jit_is_compiled_with_the_options():
    from slimt_jax.models import decode
    from tests.helpers import TINY_TEST_CONFIG, make_package
    from slimt_jax.io import load_items
    from slimt_jax.io.loader import load_weights, stack_layers

    params = stack_layers(load_weights(
        load_items(make_package().model), TINY_TEST_CONFIG
    ))
    lowered = decode.translate_batch_jit.lower(
        params, jax.numpy.zeros((2, 5), jax.numpy.int32),
        jax.numpy.ones((2, 5)), jax.numpy.zeros((64,), jax.numpy.int32),
        eos_id=2, max_steps=4, num_heads=TINY_TEST_CONFIG.num_heads,
    )
    assert lowered._lowering._compiler_options_kvs == tuple(
        device.COMPILER_OPTIONS.items()
    )


@pytest.mark.parametrize(
    "where",
    ["slimt_jax", "scripts", "bench.py", "chip_smoke.py",
     "__graft_entry__.py"],
)
def test_program_compiles_only_through_device_jit(where):
    path = os.path.join(REPO, where)
    files = [path] if path.endswith(".py") else [
        os.path.join(d, f)
        for d, _, names in os.walk(path) for f in names if f.endswith(".py")
    ]
    bare = [
        f"{os.path.relpath(f, REPO)}:{n}"
        for f in files if not f.endswith(os.path.join("slimt_jax", "device.py"))
        for n, line in enumerate(open(f, encoding="utf-8"), 1)
        if re.search(r"\bjax\.jit\b", line.split("#")[0])
    ]
    assert not bare, bare


def test_model_after_backend_start_and_mesh():
    # README order: the backend is up and a mesh exists before Model.
    from slimt_jax.parallel.sharding import make_mesh
    from tests.helpers import TINY_TEST_CONFIG, make_package
    from slimt_jax.models.model import Model

    assert jax.devices()
    mesh = make_mesh(data=2)
    model = Model(TINY_TEST_CONFIG, make_package(), mesh=mesh,
                  sharding="replicate")
    hyps = model.forward([[5, 6, 7, 2], [8, 9, 2]], need_alignment=False)
    assert len(hyps) == 2 and all(h.target for h in hyps)
