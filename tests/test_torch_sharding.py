"""The port's sharding rules and data parallelism against the JAX
package's.

* For every parameter of ``tiny`` and of ``llama3_1b`` (both built
  abstractly: JAX's through ``eval_shape``, the port's on the ``meta``
  device), the port's spec equals JAX's ``make_partition_spec`` output
  carried through the weight conversion: the scanned layer axis dropped
  and, for the (in, out) dense kernels that the port stores (out, in),
  reversed.
* A rule that places a parameter on a mesh axis of size > 1 places its
  block: the state is born sharded, the moments placed as their
  parameter, the scalars replicated.  A pipeline axis of size > 1, and a
  context axis that does not split the batch, are refused; a tensor axis
  is taken.
* DP parity: one trainer step (two, in fact) over 2 gloo ranks, each with
  half the batch, equals a 1-rank step on the whole batch: the loss,
  every gradient after the global-norm clip, and the params after the
  update agree within 1e-5 relative (norm of the difference over norm of
  the reference, per tensor), fp32.  Once with the token loss, once with
  the packed loss over halves with very different counts of valid
  positions (the example's ``loss_weight``).
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from tpucfn.models.llama import Llama as JaxLlama
from tpucfn.models.llama import LlamaConfig as JaxConfig
from tpucfn.models.llama import sharding_rules as jax_sharding_rules
from tpucfn.parallel.sharding import make_partition_spec as jax_make_spec
from tpucfn_torch.mesh import MeshSpec, build_mesh
from tpucfn_torch.models.llama import Llama, LlamaConfig, sharding_rules
from tpucfn_torch.parallel import (ShardingRules, batch_spec,
                                   make_partition_spec, shard_batch)
from tpucfn_torch.train import Trainer, adamw, llama_train_fns

REPO = Path(__file__).resolve().parent.parent
REL_TOL = 1e-5


def _jax_specs_as_port(jcfg, n_layers, **rule_kw):
    abstract = jax.eval_shape(JaxLlama(jcfg).init, jax.random.key(0),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    specs = jax_make_spec(jax_sharding_rules(jcfg, **rule_kw), abstract)
    leaves = jax.tree_util.tree_flatten_with_path(abstract)[0]
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    out = {}
    for (path, leaf), spec in zip(leaves, spec_leaves):
        keys = [str(k.key) for k in path]
        entries = tuple(spec) + (None,) * (leaf.ndim - len(spec))
        if keys[-1] == "kernel":  # DenseGeneral (in, out) -> nn.Linear (out, in)
            entries = (entries[:-2] + entries[-2:][::-1])
        name = {"embedding": "weight", "kernel": "weight",
                "scale": "scale"}[keys[-1]]
        if keys[0] == "layers":
            for i in range(n_layers):
                out[".".join(["layers", str(i), *keys[1:-1], name])] = \
                    entries[1:]
        else:
            out[".".join([*keys[:-1], name])] = entries
    return out


@pytest.mark.parametrize("preset", ["tiny", "llama3_1b"])
@pytest.mark.parametrize("fsdp,tensor", [(True, True), (True, False),
                                         (False, True), (False, False)])
def test_specs_equal_jax_through_the_conversion(preset, fsdp, tensor):
    jcfg, pcfg = getattr(JaxConfig, preset)(), getattr(LlamaConfig, preset)()
    want = _jax_specs_as_port(jcfg, pcfg.n_layers, fsdp=fsdp, tensor=tensor)
    with torch.device("meta"):
        sd = Llama(pcfg).state_dict()
    got = make_partition_spec(sharding_rules(pcfg, fsdp=fsdp, tensor=tensor),
                              sd)
    assert set(got) == set(want)
    assert got == want


def test_spec_engine_matches_jax_resolution():
    rules = ShardingRules(((r"a\.w$", ("fsdp",)), (r"\.w$", (None, "tensor")),
                           (r".*", ())))
    assert rules.spec_for("x.a.w", 2) == ("fsdp", None)
    assert rules.spec_for("x.b.w", 3) == (None, "tensor", None)
    assert rules.spec_for("x.b.v", 1) == (None,)
    with pytest.raises(ValueError, match="rank 1"):
        rules.spec_for("x.b.w", 1)
    assert batch_spec(("context",)) == (("data", "fsdp", "expert"), "context")


@pytest.fixture
def fake_world():
    def make(n):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


def _tiny_fns():
    import dataclasses

    cfg = dataclasses.replace(LlamaConfig.tiny(), param_dtype=torch.float32)
    return cfg, llama_train_fns(cfg, chunk_size=16)


def test_a_rule_on_a_split_axis_places_blocks(fake_world):
    fake_world(2)
    cfg, (init_fn, loss_fn) = _tiny_fns()
    mesh = build_mesh(MeshSpec(fsdp=2), device_type="cpu")
    trainer = Trainer(mesh, sharding_rules(cfg), loss_fn, adamw(1e-3),
                      init_fn)
    state = trainer.init(0)
    full = init_fn(torch.Generator().manual_seed(0))[0]
    name = "layers.0.attn.q_proj.weight"  # (tensor, fsdp): in over fsdp
    assert tuple(state.params[name].shape) == (64, 32)
    torch.testing.assert_close(state.params[name].detach(),
                               full[name][:, :32], rtol=0, atol=0)
    assert tuple(state.params["embed_tokens.weight"].shape) == (256, 32)
    assert tuple(state.params["final_norm.scale"].shape) == (64,)
    specs = trainer.param_spec()
    assert specs[f"params/{name}"] == ("tensor", "fsdp")
    assert specs[f"opt/exp_avg/{name}"] == ("tensor", "fsdp")
    assert specs[f"opt/step/{name}"] == ()
    assert specs["step"] == () and specs["generator"] == (None,)
    assert trainer.abstract_state()[f"params/{name}"].shape == (64, 64)
    assert trainer.state_shardings()[f"params/{name}"].splits() == [
        (1, ("fsdp",))]
    assert trainer.batch_sharding().spec == (("data", "fsdp", "expert"),)


def test_non_batch_axes_are_refused(fake_world):
    """A pipeline axis (C5) and a context axis that does not split the
    batch are refused; a tensor axis is taken."""
    fake_world(2)
    cfg, (init_fn, loss_fn) = _tiny_fns()
    for axis, text in (("context", "batch_extra_axes"), ("pipeline", "C5")):
        mesh = build_mesh(MeshSpec(**{axis: 2}), device_type="cpu")
        with pytest.raises(NotImplementedError, match=text):
            Trainer(mesh, sharding_rules(cfg, tensor=False), loss_fn,
                    adamw(1e-3), init_fn)
    mesh = build_mesh(MeshSpec(tensor=2), device_type="cpu")
    trainer = Trainer(mesh, sharding_rules(cfg), loss_fn, adamw(1e-3),
                      init_fn)
    assert (trainer.world, trainer.batch_world) == (2, 1)


def test_mesh_and_rules_go_together():
    cfg, (init_fn, loss_fn) = _tiny_fns()
    with pytest.raises(NotImplementedError, match="pass both"):
        Trainer(None, sharding_rules(cfg), loss_fn, adamw(1e-3), init_fn,
                device="cpu")


def test_shard_batch_puts_rows_on_the_mesh_device():
    try:
        mesh = build_mesh(MeshSpec(), device_type="cpu")
        out = shard_batch(mesh, {"tokens": np.arange(6).reshape(2, 3)})
        assert out["tokens"].device.type == "cpu"
        assert out["tokens"].tolist() == [[0, 1, 2], [3, 4, 5]]
    finally:
        dist.destroy_process_group()


# ---- DP parity ---------------------------------------------------------------

STEP = textwrap.dedent("""
    import dataclasses, sys
    import numpy as np, torch, torch.distributed as dist
    from tpucfn_torch.mesh import MeshSpec, build_mesh
    from tpucfn_torch.models.llama import LlamaConfig, sharding_rules
    from tpucfn_torch.train import (Trainer, adamw, chain,
                                    clip_by_global_norm, llama_train_fns,
                                    warmup_cosine_decay_schedule)

    torch.set_num_threads(1)
    rank, world, port, out, kind = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])

    class Record:  # keeps the gradients the clip hands on
        def __init__(self): self.seen = []
        def init(self, params): return ()
        def state_dict(self, state, params): return {}
        def load_state_dict(self, state, params, sd): pass
        def update(self, grads, state, params):
            self.seen.append({k: g.clone() for k, g in grads.items()})
            return grads

    cfg = dataclasses.replace(LlamaConfig.tiny(), param_dtype=torch.float32)
    init_fn, loss_fn = llama_train_fns(cfg, chunk_size=16, z_loss=1e-4)
    loss_weight = None
    tokens = np.random.RandomState(3).randint(0, 256, (8, 32)).astype(np.int32)
    batch = {"tokens": tokens}
    if kind == "packed":
        from tpucfn_torch.data.packing import (packed_causal_lm_loss,
                                               packed_loss_weight)
        from tpucfn_torch.models.llama import Llama

        def loss_fn(params, mstate, batch, generator):
            model = Llama.from_state_dict(cfg, params, trainable=True)
            logits = model(batch["tokens"], segment_ids=batch["segments"])
            loss, acc = packed_causal_lm_loss(
                logits, batch["tokens"], batch["segments"], z_loss=1e-4)
            return loss, ({"accuracy": acc}, mstate)

        loss_weight = packed_loss_weight
        # rows 0-3 full of documents, rows 4-7 mostly padding
        segments = np.zeros((8, 32), np.int32)
        segments[:4, :20], segments[:4, 20:] = 1, 2
        segments[4:, :5] = 1
        batch["segments"] = segments
    rec = Record()
    tx = chain(clip_by_global_norm(1.0), rec, adamw(
        warmup_cosine_decay_schedule(0.0, 3e-3, 1, 10), b1=0.9, b2=0.95,
        weight_decay=0.1))
    if world > 1:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world)
        mesh = build_mesh(MeshSpec.for_devices(world), device_type="cpu")
        trainer = Trainer(mesh, sharding_rules(cfg), loss_fn, tx, init_fn,
                          loss_weight=loss_weight)
    else:
        trainer = Trainer(None, None, loss_fn, tx, init_fn, device="cpu",
                          loss_weight=loss_weight)
    # rank 0 inits from seed 0; the others from another seed: the
    # broadcast must make them equal
    state = trainer.init(0 if rank == 0 else 7)
    rows = 8 // world
    losses = []
    for _ in range(2):
        state, m = trainer.step(state, {
            k: v[rank * rows:(rank + 1) * rows] for k, v in batch.items()})
        losses.append(m["loss"].item())
    np.savez(out, losses=np.array(losses),
             **{f"grad{i}/{k}": v.numpy() for i, g in enumerate(rec.seen)
                for k, v in g.items()},
             **{f"param/{k}": v.detach().numpy()
                for k, v in state.params.items()})
    if world > 1:
        dist.destroy_process_group()
""")


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("kind", ["tokens", "packed"])
def test_two_gloo_ranks_equal_one_rank(kind, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    port = str(_free_port())
    runs = [(0, 1), (0, 2), (1, 2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", STEP, str(rank), str(world), port,
         str(tmp_path / f"r{rank}w{world}.npz"), kind],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank, world in runs]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
    ref = np.load(tmp_path / "r0w1.npz")
    for rank in range(2):
        got = np.load(tmp_path / f"r{rank}w2.npz")
        assert set(got.files) == set(ref.files)
        assert np.allclose(got["losses"], ref["losses"], rtol=REL_TOL,
                           atol=0), (got["losses"], ref["losses"])
        worst = max(((_rel(got[k], ref[k]), k) for k in ref.files
                     if k != "losses"))
        assert worst[0] <= REL_TOL, worst
