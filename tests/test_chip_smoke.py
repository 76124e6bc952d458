"""chip_smoke.py refuses to run without a GPU and outside the repo; its
agreement arithmetic is the crosscheck serving sweep's."""

import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, script], capture_output=True, text=True,
        cwd=cwd, env=env, timeout=300,
    )


def _last_line(proc):
    lines = proc.stdout.strip().splitlines()
    return lines[-1] if lines else ""


def test_exits_nonzero_on_cpu():
    proc = _run(REPO, "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok": true' not in _last_line(proc)
    assert "no GPU" in proc.stdout + proc.stderr


def test_exits_nonzero_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(tmp_path, "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok": true' not in _last_line(proc)


def test_agreement_counts_like_the_serving_sweep():
    ref = {"a": [[1, 2, 3], [4, 5]], "b": [[7]]}
    got = {"a": [[1, 2, 3], [4, 6, 9]], "b": [[7]]}
    tokens, sentences, n = chip_smoke.agreement(ref, got)
    # tokens: 3/3 + 1/3 (max length) + 1/1 = 5/7; sentences 2/3
    assert abs(tokens - 100.0 * 5 / 7) < 1e-9
    assert abs(sentences - 100.0 * 2 / 3) < 1e-9
    assert n == 3


def test_agreement_reads_only_the_reference_labels():
    # One cell at a time: the other side may hold more cells.
    ref = {"base sweep": [[1, 2], [3]]}
    got = {"base sweep": [[1, 2], [4]], "tiny11 sweep": [[9]]}
    assert chip_smoke.agreement(ref, got) == (
        100.0 * 2 / 3, 50.0, 2
    )


def test_triton_gemm_fusions_counted_in_optimized_hlo():
    hlo = "\n".join([
        '%f.1 = s32[8,64] fusion(...), kind=kCustom, backend_config='
        '{"fusion_backend_config":{"kind":"__triton_nested_gemm_fusion"}}',
        '%f.2 = f32[8,64] fusion(...), kind=kCustom, backend_config='
        '{"fusion_backend_config":{"kind":"__triton_gemm"}}',
        '%f.3 = f32[8] fusion(...), kind=kCustom, backend_config='
        '{"fusion_backend_config":{"kind":"__triton"}}',
        '%g = (s32[8,64], s8[0]) custom-call(...), '
        'custom_call_target="__cublas$gemm"',
    ])
    # The softmax-style "__triton" fusion is not a GEMM.
    assert chip_smoke.triton_gemm_fusions(hlo) == 2
    assert chip_smoke.triton_gemm_fusions(hlo.split("\n")[-1]) == 0
