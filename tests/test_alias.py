"""The package's former import name still imports, as slimt_jax itself."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALIASES = sorted(
    d for d in os.listdir(REPO)
    if d.startswith("slimt_") and d != "slimt_jax"
    and os.path.isfile(os.path.join(REPO, d, "__init__.py"))
)


def test_there_is_one_alias():
    assert len(ALIASES) == 1


@pytest.mark.parametrize("module", ["", ".config", ".models.model"])
def test_alias_gives_the_same_module_objects(module):
    old = ALIASES[0] + module
    code = (
        "import importlib, warnings\n"
        "with warnings.catch_warnings(record=True) as caught:\n"
        "    warnings.simplefilter('always')\n"
        f"    old = importlib.import_module({old!r})\n"
        f"new = importlib.import_module('slimt_jax{module}')\n"
        "assert old is new, (old, new)\n"
        "assert new.__spec__.name == new.__name__, new.__spec__\n"
        "assert any(w.category is DeprecationWarning for w in caught)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=REPO, env=env, timeout=120,
    )
    assert proc.stdout.strip() == "ok", proc.stderr
