"""The port's mesh against the JAX package's.

``MeshSpec.for_devices`` and ``validate`` agree with JAX's (values and
refusals) over a grid of device counts and axis overrides; for the same
spec the port's ``DeviceMesh`` has JAX's axis names, order, sizes and
rank layout.  Meshes wider than one rank are built over torch's fake
process group (one process standing for every rank); the one-rank mesh
over the real default group that ``build_mesh`` makes for a plain run.
"""

import itertools

import jax
import numpy as np
import pytest
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from tpucfn.mesh import ALL_AXES as JAX_AXES
from tpucfn.mesh import BATCH_AXES as JAX_BATCH_AXES
from tpucfn.mesh import MeshSpec as JaxSpec
from tpucfn.mesh import build_mesh as jax_build_mesh
from tpucfn_torch.mesh import (ALL_AXES, BATCH_AXES, MeshSpec, build_mesh,
                               mesh_device, mesh_sizes)

OVERRIDES = [{}, {"fsdp": 2}, {"tensor": 2}, {"fsdp": 2, "tensor": 2},
             {"context": 4}, {"pipeline": 2, "expert": 2}, {"fsdp": 3},
             {"tensor": 8}, {"data": 2}]


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("ValueError", str(e))


def test_axis_names_and_batch_axes_are_jax_s():
    assert ALL_AXES == JAX_AXES
    assert BATCH_AXES == JAX_BATCH_AXES


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8, 16])
def test_for_devices_and_validate_agree_with_jax(n):
    for kw in OVERRIDES:
        want = _outcome(lambda: JaxSpec.for_devices(n, **kw).axis_sizes)
        got = _outcome(lambda: MeshSpec.for_devices(n, **kw).axis_sizes)
        assert got == want, (n, kw)
        if want[0] == "ok":
            spec, jspec = MeshSpec.for_devices(n, **kw), \
                JaxSpec.for_devices(n, **kw)
            assert (spec.num_devices, spec.dp_size) == \
                (jspec.num_devices, jspec.dp_size)
            for m in (n, n + 1, 2 * n):
                assert _outcome(lambda: spec.validate(m)) == \
                    _outcome(lambda: jspec.validate(m)), (n, kw, m)


def test_bad_axis_sizes_are_refused_as_in_jax():
    for bad in ({"tensor": 0}, {"fsdp": -1}, {"data": 1.5}):
        assert _outcome(lambda: MeshSpec(**bad)) == \
            _outcome(lambda: JaxSpec(**bad))


@pytest.fixture
def fake_world():
    """A fake process group of ``n`` ranks; torn down after the test."""
    def make(n):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


SPECS = [dict(n=8, fsdp=2), dict(n=8, tensor=2, context=2),
         dict(n=8, pipeline=2, fsdp=2, tensor=2), dict(n=4),
         dict(n=6, expert=3), dict(n=8, fsdp=8)]


@pytest.mark.parametrize("case", SPECS, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
def test_mesh_has_jax_axes_sizes_and_layout(case, fake_world):
    kw = dict(case)
    n = kw.pop("n")
    fake_world(n)
    spec = MeshSpec.for_devices(n, **kw)
    mesh = build_mesh(spec, device_type="cpu")
    jmesh = jax_build_mesh(JaxSpec.for_devices(n, **kw),
                           devices=jax.devices()[:n])
    assert tuple(mesh.mesh_dim_names) == tuple(jmesh.axis_names)
    assert mesh_sizes(mesh) == dict(jmesh.shape)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices) - jax.devices()[0].id
    assert mesh.mesh.tolist() == ids.tolist()
    assert mesh_device(mesh).type == "cpu"


def test_default_mesh_fills_data_with_every_rank(fake_world):
    fake_world(4)
    mesh = build_mesh(device_type="cpu")
    assert mesh_sizes(mesh) == dict(zip(ALL_AXES, (1, 4, 1, 1, 1, 1)))


def test_wrong_rank_count_is_refused(fake_world):
    fake_world(4)
    with pytest.raises(ValueError, match="wants 8 devices"):
        build_mesh(MeshSpec(data=8), device_type="cpu")


def test_plain_run_gets_a_one_rank_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        build_mesh(MeshSpec(data=2), device_type="cpu")
    try:
        mesh = build_mesh(MeshSpec(), device_type="cpu")
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        assert mesh_sizes(mesh) == dict.fromkeys(ALL_AXES, 1)
        assert list(itertools.chain.from_iterable(
            mesh.mesh.reshape(1, -1).tolist())) == [0]
    finally:
        dist.destroy_process_group()
