"""Test configuration: run everything on a virtual 8-device CPU mesh.

Must set the environment before JAX initializes its backends; mirrors
the multi-host-on-CPU fake-backend strategy from SURVEY.md §4.
"""

import os

# The suite runs on the CPU backend; the environment must be set
# before JAX initializes its backends.
os.environ["JAX_PLATFORMS"] = "cpu"
# Tests compile and run; they neither read nor fill the persistent
# compilation cache that entry points set up (slimt_jax.device).
os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)
