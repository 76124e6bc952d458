"""Mesh-backed Model + multihost helpers on the 8-device CPU mesh."""

import numpy as np
import pytest

import jax

from slimt_jax.config import Config
from slimt_jax.parallel import multihost
from slimt_jax.parallel.sharding import make_mesh
from slimt_jax.runtime.service import Blocking

from .helpers import TINY_TEST_CONFIG, make_package
from slimt_jax.models.model import Model


@pytest.fixture(scope="module")
def package():
    return make_package()


def test_model_on_mesh_matches_single_device(package):
    single = Model(TINY_TEST_CONFIG, package)
    mesh = make_mesh(data=4, model=2)
    sharded = Model(TINY_TEST_CONFIG, package, mesh=mesh)

    service = Blocking(Config(cache_size=0))
    sources = ["hello world", "goodbye test", "quick brown fox jumps"]
    want = service.translate(single, sources)
    got = service.translate(sharded, sources)
    assert [r.target.text for r in got] == [r.target.text for r in want]


def test_model_replicated_mesh(package):
    mesh = make_mesh(data=8, model=1)
    model = Model(TINY_TEST_CONFIG, package, mesh=mesh, sharding="replicate")
    service = Blocking(Config(cache_size=0))
    responses = service.translate(model, ["hello world"])
    assert responses[0].target.sentence_count() == 1


def test_shard_lines():
    lines = [f"l{i}" for i in range(10)]
    parts = [multihost.shard_lines(lines, p, 3) for p in range(3)]
    assert sorted(sum(parts, [])) == sorted(lines)
    assert parts[0] == ["l0", "l3", "l6", "l9"]


def test_global_mesh_all_devices():
    mesh = multihost.global_mesh(model=2)
    assert mesh.shape["model"] == 2
    assert mesh.shape["data"] == len(jax.devices()) // 2


def test_initialize_single_process_noop():
    multihost.initialize(num_processes=1)  # must not raise


def test_scaling_report_harness(package):
    """The scaling-efficiency harness runs (CPU mesh: functional, not
    a perf statement)."""
    from slimt_jax.config import Config
    from slimt_jax.runtime.service import Blocking

    corpus = ["hello world"] * 4

    def make_model(mesh):
        return Model(
            TINY_TEST_CONFIG, package, mesh=mesh, sharding="replicate"
        )

    def make_service():
        return Blocking(Config(cache_size=0))

    report = multihost.scaling_report(
        make_model, make_service, corpus, device_counts=[1, 2]
    )
    assert set(report["throughput"]) == {1, 2}
    assert report["efficiency"][1] == pytest.approx(1.0)


def test_model_sequence_sharded_matches_single_device(package):
    """Service-level SP: Model(mesh, shard_sequence=True) splits the
    token dim of every device batch over the "seq" axis; outputs match
    single device exactly."""
    single = Model(TINY_TEST_CONFIG, package)
    mesh = make_mesh(data=2, seq=4)
    sp = Model(
        TINY_TEST_CONFIG, package, mesh=mesh, sharding="replicate",
        shard_sequence=True,
    )
    service = Blocking(Config(cache_size=0))
    sources = ["hello world", "goodbye test", "quick brown fox jumps"]
    want = service.translate(single, sources)
    got = service.translate(sp, sources)
    assert [r.target.text for r in got] == [r.target.text for r in want]

    with pytest.raises(ValueError, match="seq axis"):
        Model(
            TINY_TEST_CONFIG, package, mesh=make_mesh(seq=5),
            shard_sequence=True,
        )
