"""The port's named-axis collectives (``tpucfn_torch.collectives``) over 4
gloo ranks against the JAX package's wrappers under ``shard_map`` on 4 of
the 8 fake CPU devices, on the same numpy inputs: each case of
``tests/test_collectives.py`` (psum, pmean, the tiled all-gather,
reduce-scatter, the ring permute at +1 and -1, all-to-all, the axis index
and size), the gradients of ``ring_permute`` and ``all_to_all`` (and of
psum, the tiled all-gather and reduce-scatter), a tuple of axes, and an
axis of size 1, which returns its input without a collective.  Each rank
returns its shard; the shards, concatenated in rank order, equal JAX's
output exactly (the values are small integers or their sums: every
tolerance is 0 but for the float gradient, at 1e-6).
"""

import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from test_torch_rank_pool import RankPool
from tpucfn import collectives as col

W = 4
GRAD_TOL = 1e-6

CASES = textwrap.dedent("""
    import numpy as np
    import torch
    from tpucfn_torch import collectives as col
    from tpucfn_torch.mesh import MeshSpec, build_mesh

    MESHES = {}

    def mesh(**axes):
        key = tuple(sorted(axes.items()))
        if key not in MESHES:
            MESHES[key] = build_mesh(MeshSpec(**axes), device_type="cpu")
        return MESHES[key]

    def shard(x, rank, world):
        n = x.shape[0] // world
        return torch.from_numpy(x[rank * n:(rank + 1) * n]).clone()

    def forward(rank, world, inputs):
        m = mesh(data=world)
        x = shard(inputs["x"], rank, world)
        rows = torch.from_numpy(inputs["rows"][rank])
        cube = shard(inputs["cube"], rank, world)
        return {
            "psum": col.psum(x, "data", mesh=m).numpy(),
            "pmean": col.pmean(x, "data", mesh=m).numpy(),
            "pmax": col.pmax(x, "data", mesh=m).numpy(),
            "all_gather": col.all_gather(x, "data", mesh=m).numpy(),
            "all_gather_stacked": col.all_gather(
                x, "data", mesh=m, tiled=False).numpy(),
            "reduce_scatter": col.reduce_scatter(rows, "data",
                                                 mesh=m).numpy(),
            "ring_permute": col.ring_permute(x, "data", mesh=m).numpy(),
            "ring_permute_back": col.ring_permute(x, "data", mesh=m,
                                                  shift=-1).numpy(),
            "all_to_all": col.all_to_all(cube, "data", mesh=m, split_axis=1,
                                         concat_axis=0).numpy(),
            "axis": np.array([col.axis_index("data", mesh=m),
                              col.axis_size("data", mesh=m)]),
        }

    def grads(rank, world, inputs):
        m = mesh(data=world)
        out = {}
        fns = {
            "ring_permute": lambda t: col.ring_permute(t, "data", mesh=m),
            "ring_permute_back": lambda t: col.ring_permute(
                t, "data", mesh=m, shift=-1),
            "all_to_all": lambda t: col.all_to_all(
                t, "data", mesh=m, split_axis=1, concat_axis=0),
            "psum": lambda t: col.psum(t, "data", mesh=m),
            "all_gather": lambda t: col.all_gather(t, "data", mesh=m,
                                                   gather_axis=1),
            "reduce_scatter": lambda t: col.reduce_scatter(
                t, "data", mesh=m, scatter_axis=1),
        }
        for name, fn in fns.items():
            x = shard(inputs["x_" + name], rank, world).requires_grad_()
            w = shard(inputs["w_" + name], rank, world)
            (fn(x) * w).sum().backward()
            out[name] = x.grad.numpy()
        return out

    def tuple_axes(rank, world, inputs):
        m = mesh(data=2, context=world // 2)
        x = shard(inputs["x"], rank, world)
        both = ("data", "context")
        return {"psum": col.psum(x, both, mesh=m).numpy(),
                "all_gather": col.all_gather(x, both, mesh=m).numpy(),
                "axis": np.array([col.axis_index(both, mesh=m),
                                  col.axis_size(both, mesh=m)])}

    def size_one(rank, world, inputs):
        import torch.distributed as dist

        m = mesh(data=world)
        x = torch.from_numpy(inputs["x"])
        sent = []
        real = {n: getattr(dist, n) for n in (
            "all_reduce", "all_gather", "reduce_scatter_tensor",
            "batch_isend_irecv", "all_to_all_single")}
        for n, fn in real.items():
            setattr(dist, n, lambda *a, _n=n, **k: sent.append(_n))
        try:
            same = [
                col.psum(x, "context", mesh=m) is x,
                col.pmean(x, "context", mesh=m).equal(x),
                col.pmax(x, "context", mesh=m) is x,
                col.all_gather(x, "context", mesh=m) is x,
                col.reduce_scatter(x, "context", mesh=m) is x,
                col.ring_permute(x, "context", mesh=m) is x,
                col.ring_permute(x, "data", mesh=m, shift=world) is x,
                col.all_to_all(x, "context", mesh=m, split_axis=0,
                               concat_axis=0) is x,
                col.axis_index("context", mesh=m) == 0,
                col.axis_size("context", mesh=m) == 1,
            ]
        finally:
            for n, fn in real.items():
                setattr(dist, n, fn)
        return {"same": np.array(same), "sent": np.array(len(sent))}
""")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    with RankPool(W, CASES, tmp_path_factory.mktemp("collectives")) as pool:
        yield pool


@pytest.fixture(scope="module")
def mesh4():
    return Mesh(np.array(jax.devices()[:W]), ("data",))


def _shmap(mesh, fn, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def _inputs():
    x = np.arange(8.0, dtype=np.float32)
    rows = np.tile(np.arange(8.0, dtype=np.float32)[None], (W, 1))
    cube = np.arange(W * W * 2, dtype=np.float32).reshape(W, W, 2)
    return x, rows, cube


@pytest.fixture(scope="module")
def forward(ranks):
    x, rows, cube = _inputs()
    return ranks.run("forward", x=x, rows=rows, cube=cube)


def _cat(got, key):
    return np.concatenate([g[key] for g in got])


def test_psum_pmean_pmax(forward, mesh4):
    x = _inputs()[0]
    for name, fn in (("psum", col.psum), ("pmean", col.pmean),
                     ("pmax", col.pmax)):
        ref = _shmap(mesh4, lambda s, fn=fn: fn(s, "data"), P("data"),
                     P("data"))(jnp.asarray(x))
        np.testing.assert_array_equal(_cat(forward, name), np.asarray(ref),
                                      err_msg=name)


def test_all_gather_tiled_and_stacked(forward, mesh4):
    x = jnp.asarray(_inputs()[0])
    for name, tiled in (("all_gather", True), ("all_gather_stacked", False)):
        ref = _shmap(mesh4, lambda s, t=tiled: col.all_gather(
            s, "data", tiled=t)[None], P("data"), P("data"))(x)
        for rank, g in enumerate(forward):
            np.testing.assert_array_equal(g[name], np.asarray(ref)[rank],
                                          err_msg=name)


def test_reduce_scatter_is_psum_shard(forward, mesh4):
    rows = _inputs()[1]
    ref = _shmap(mesh4, lambda s: col.reduce_scatter(s[0], "data"),
                 P("data", None), P("data"))(jnp.asarray(rows))
    np.testing.assert_array_equal(_cat(forward, "reduce_scatter"),
                                  np.asarray(ref))


@pytest.mark.parametrize("name,shift", [("ring_permute", 1),
                                        ("ring_permute_back", -1)])
def test_ring_permute(forward, mesh4, name, shift):
    x = _inputs()[0]
    ref = _shmap(mesh4, lambda s: col.ring_permute(s, "data", shift=shift),
                 P("data"), P("data"))(jnp.asarray(x))
    np.testing.assert_array_equal(_cat(forward, name), np.asarray(ref))
    np.testing.assert_array_equal(_cat(forward, name),
                                  np.roll(x.reshape(W, -1), shift, 0)
                                  .reshape(-1))


def test_all_to_all_transposes_shard_axis(forward, mesh4):
    cube = _inputs()[2]
    ref = _shmap(mesh4, lambda s: col.all_to_all(s, "data", split_axis=1,
                                                 concat_axis=0),
                 P("data"), P("data"))(jnp.asarray(cube))
    np.testing.assert_array_equal(_cat(forward, "all_to_all"),
                                  np.asarray(ref))


def test_axis_index_size(forward):
    assert [g["axis"].tolist() for g in forward] == [[r, W] for r in range(W)]


def test_gradients_equal_jax(ranks, mesh4):
    """d/dx sum(f(x) * w) through each differentiable wrapper, against
    ``jax.grad`` through the same JAX wrapper."""
    rs = np.random.RandomState(0)
    shapes = {"ring_permute": (W * 2, 3), "ring_permute_back": (W * 2, 3),
              "all_to_all": (W, W, 2), "psum": (W * 2, 3),
              "all_gather": (W * 2, 3), "reduce_scatter": (W * 2, W * 2)}
    out_shapes = dict(shapes, all_to_all=(W * W, 1, 2),
                      all_gather=(W * 2, 3 * W), reduce_scatter=(W * 2, 2))
    jfns = {
        "ring_permute": lambda s: col.ring_permute(s, "data"),
        "ring_permute_back": lambda s: col.ring_permute(s, "data", shift=-1),
        "all_to_all": lambda s: col.all_to_all(s, "data", split_axis=1,
                                               concat_axis=0),
        "psum": lambda s: col.psum(s, "data"),
        "all_gather": lambda s: col.all_gather(s, "data", gather_axis=1),
        "reduce_scatter": lambda s: col.reduce_scatter(s, "data",
                                                       scatter_axis=1),
    }
    inputs = {}
    for name, shape in shapes.items():
        inputs["x_" + name] = rs.randn(*shape).astype(np.float32)
        inputs["w_" + name] = rs.randn(*out_shapes[name]).astype(np.float32)
    got = ranks.run("grads", **inputs)
    for name, fn in jfns.items():
        f = _shmap(mesh4, fn, P("data"), P("data"))
        ref = jax.grad(lambda x: jnp.sum(
            f(x) * inputs["w_" + name]))(jnp.asarray(inputs["x_" + name]))
        np.testing.assert_allclose(_cat(got, name), np.asarray(ref),
                                   atol=GRAD_TOL, rtol=0, err_msg=name)


def test_tuple_of_axes(ranks):
    """A tuple resolves to one group over both axes, its index row-major
    (``lax`` over a 2 x 2 mesh's ``("data", "context")``)."""
    x = _inputs()[0]
    mesh = Mesh(np.array(jax.devices()[:W]).reshape(2, W // 2),
                ("data", "context"))
    both = ("data", "context")
    got = ranks.run("tuple_axes", x=x)
    ref = _shmap(mesh, lambda s: col.psum(s, both), P(both), P(both))(
        jnp.asarray(x))
    np.testing.assert_array_equal(_cat(got, "psum"), np.asarray(ref))
    gathered = _shmap(mesh, lambda s: col.all_gather(s, both)[None],
                      P(both), P(both))(jnp.asarray(x))
    idx = _shmap(mesh, lambda s: s * 0 + col.axis_index(both)
                 + 10 * col.axis_size(both), P(both), P(both))(
        jnp.zeros(W))
    for rank, g in enumerate(got):
        np.testing.assert_array_equal(g["all_gather"],
                                      np.asarray(gathered)[rank])
        assert g["axis"].tolist() == [int(idx[rank]) % 10,
                                      int(idx[rank]) // 10]


def test_axis_of_size_one_makes_no_collective(ranks):
    for g in ranks.run("size_one", x=np.arange(4.0, dtype=np.float32)):
        assert g["same"].all(), g["same"]
        assert int(g["sent"]) == 0
