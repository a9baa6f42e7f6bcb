"""Expert parallelism, tensor parallelism beside a context axis, and
sharded checkpoints in the port's Trainer, on 4 gloo ranks of one pool;
the first two against the JAX package's Trainer on 8 fake CPU devices
(JAX's initial params carried across, the same global batch).

* MoE (4 experts, top-2, capacity factor 1.25) with ``expert`` 2: the
  port on data 2 x expert 2 (``moe_expert_group``: each rank holds 2
  experts and routes its own rows), JAX on data 2 x expert 2 x tensor 2
  with ``ep_mesh`` (the same 4 row shards, so the same local capacity;
  nothing placed on ``tensor``): the loss of each of 3 AdamW steps within
  2e-4 relative.
* context 2 x tensor 2 under ``sharding_rules(cfg)``: ring attention
  (flash hops, their CPU path) over each rank's block of the heads, and
  Ulysses over them (4 KV heads, so a tensor rank's 2 divide over the
  context axis), against JAX's ring and Ulysses on data 2 x context 2 x
  tensor 2: the same tolerance.
* Ulysses refuses a rank's heads that do not divide over the context
  axis, and a Llama a tensor axis that does not divide its KV heads,
  naming the sizes.
* A checkpoint saved under fsdp 2 x tensor 2 restores under data 4, and
  one saved under data 4 restores under fsdp 2 x tensor 2: every param
  and every AdamW moment equal, bit for bit, the step too.
"""

import dataclasses
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from test_torch_rank_pool import RankPool
from tpucfn.kernels import make_ring_attention, make_ulysses_attention
from tpucfn.mesh import MeshSpec, build_mesh
from tpucfn.models import llama as jax_llama
from tpucfn.models.moe import MoEConfig as JaxMoEConfig
from tpucfn.models.moe import collect_moe_aux
from tpucfn.parallel import shard_batch
from tpucfn.train import Trainer, TrainerConfig

W = 4
LOSS_RTOL = 2e-4
CHUNK, Z_LOSS = 8, 1e-4
LR = 3e-3
STEPS = 3

CASES = textwrap.dedent("""
    import dataclasses
    import numpy as np
    import torch
    from tpucfn_torch.collectives import axis_index, axis_size
    from tpucfn_torch.kernels import make_ulysses_attention
    from tpucfn_torch.mesh import BATCH_AXES, MeshSpec, build_mesh
    from tpucfn_torch.models.llama import (LlamaConfig,
                                           causal_lm_loss_weight,
                                           sharding_rules)
    from tpucfn_torch.models.moe import MoEConfig
    from tpucfn_torch.parallel import shard_batch
    from tpucfn_torch.train import (Trainer, TrainerConfig, adamw,
                                    llama_train_fns)

    MESHES = {}

    def mesh_of(axes):
        key = tuple(sorted(axes.items()))
        if key not in MESHES:
            MESHES[key] = build_mesh(MeshSpec(**axes), device_type="cpu")
        return MESHES[key]

    def config(inputs):
        cfg = dataclasses.replace(LlamaConfig.tiny(),
                                  param_dtype=torch.float32,
                                  n_kv_heads=int(inputs["kv_heads"]))
        if int(inputs["experts"]):
            cfg = dataclasses.replace(
                cfg, moe=MoEConfig(n_experts=int(inputs["experts"])))
        return cfg

    def trainer_on(axes, cfg, params, attention="ring"):
        m = mesh_of(axes)
        kw, extra, weight = {}, (), None
        if axes.get("tensor", 1) > 1:
            kw["tensor_mesh"] = m
        if axes.get("expert", 1) > 1:
            kw["moe_expert_group"] = m.get_group("expert")
        if axes.get("context", 1) > 1:
            kw["context_mesh"] = m
            if attention == "ulysses":
                kw["attention_fn"] = make_ulysses_attention(m)
            extra, weight = ("context",), causal_lm_loss_weight(m)
        _, loss_fn = llama_train_fns(cfg, chunk_size=8, z_loss=1e-4, **kw)
        return m, Trainer(
            m, sharding_rules(cfg, tensor=axes.get("tensor", 1) > 1),
            loss_fn, adamw(3e-3), lambda g: (dict(params), {}),
            config=TrainerConfig(batch_extra_axes=extra),
            loss_weight=weight)

    def batch_of(m, tokens, extra):
        rows = tokens.shape[0] // axis_size(BATCH_AXES, mesh=m)
        d = axis_index(BATCH_AXES, mesh=m)
        return shard_batch(m, {"tokens": tokens[d * rows:(d + 1) * rows]},
                           extra)

    def train(rank, world, inputs):
        axes = {k[5:]: int(v) for k, v in inputs.items()
                if k.startswith("mesh/")}
        params = {k[2:]: torch.from_numpy(v) for k, v in inputs.items()
                  if k.startswith("p/")}
        m, trainer = trainer_on(axes, config(inputs), params,
                                str(inputs["attention"]))
        state = trainer.init(0)
        batch = batch_of(m, inputs["tokens"],
                         trainer.config.batch_extra_axes)
        losses = []
        for _ in range(int(inputs["steps"])):
            state, metrics = trainer.step(state, batch)
            losses.append(metrics["loss"].item())
        return {"losses": np.array(losses)}

    def ckpt(rank, world, inputs):
        from tpucfn_torch.ckpt import CheckpointManager

        cfg = config(inputs)
        params = {k[2:]: torch.from_numpy(v) for k, v in inputs.items()
                  if k.startswith("p/")}
        layouts = {"fsdp2_tensor2": {"fsdp": 2, "tensor": 2},
                   "data4": {"data": 4}}
        out = {}
        for label in ("saved", "restored"):
            m, trainer = trainer_on(layouts[str(inputs[label])], cfg, params)
            state = trainer.init(0)
            mgr = CheckpointManager(str(inputs["dir"]), async_save=False)
            if label == "saved":
                batch = batch_of(m, inputs["tokens"], ())
                for _ in range(2):
                    state, _ = trainer.step(state, batch)
                mgr.save(2, state, force=True)
            else:
                state = mgr.restore(state, 2)
            mgr.close()
            shardings = trainer.state_shardings()
            for k, v in state.state_dict().items():
                if k.startswith(("params/", "opt/")):
                    out[f"{label}/{k}"] = shardings[k].unshard(v).numpy()
            out[f"{label}/step"] = np.array(state.step)
        return out
""")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    with RankPool(W, CASES, tmp_path_factory.mktemp("parallel")) as pool:
        yield pool


def _tokens(vocab, b=8, s=16, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


def _jax_cfg(experts=0, kv_heads=2):
    cfg = dataclasses.replace(jax_llama.LlamaConfig.tiny(),
                              n_kv_heads=kv_heads)
    if experts:
        cfg = dataclasses.replace(cfg, moe=JaxMoEConfig(n_experts=experts))
    return cfg


def _port_params(jax_params, experts=0, kv_heads=2):
    from tpucfn_torch.models.convert import llama_state_dict_from_jax
    from tpucfn_torch.models.llama import LlamaConfig
    from tpucfn_torch.models.moe import MoEConfig

    pcfg = dataclasses.replace(
        LlamaConfig.tiny(), param_dtype=torch.float32, n_kv_heads=kv_heads,
        moe=MoEConfig(n_experts=experts) if experts else None)
    return {f"p/{k}": v.numpy() for k, v in
            llama_state_dict_from_jax(jax_params, pcfg).items()}


def _jax_train(spec, cfg, *, attention=None, ep=False, context=False):
    """3 AdamW steps of the JAX Trainer on ``spec``'s mesh: the tokens,
    the initial params and each step's loss."""
    mesh = build_mesh(MeshSpec(**spec))
    kw = {}
    if attention is not None:
        kw["attention_fn"] = attention(mesh)
    if ep:
        kw["ep_mesh"] = mesh
    model = jax_llama.Llama(cfg, **kw)
    tokens = _tokens(cfg.vocab_size)

    def init_fn(rng):
        return model.init(rng, jnp.zeros((4, 16), jnp.int32))["params"], {}

    def loss_fn(params, mstate, batch, rng):
        hidden, muts = model.apply({"params": params}, batch["tokens"],
                                   return_hidden=True,
                                   mutable=["losses", "metrics"])
        loss, acc = jax_llama.chunked_causal_lm_loss(
            hidden, params["lm_head"]["kernel"], batch["tokens"],
            chunk_size=CHUNK, z_loss=Z_LOSS)
        return loss + collect_moe_aux(muts), ({"accuracy": acc}, mstate)

    extra = ("context",) if context else ()
    trainer = Trainer(mesh, jax_llama.sharding_rules(
        cfg, tensor=spec.get("tensor", 1) > 1 and not ep), loss_fn,
        optax.adamw(LR), init_fn,
        config=TrainerConfig(batch_extra_axes=extra))
    state = trainer.init(jax.random.key(0))
    before = jax.tree.map(np.asarray, state.params)
    batch = shard_batch(mesh, {"tokens": tokens}, extra_axes=extra)
    losses = []
    for _ in range(STEPS):
        state, m = trainer.step(state, batch)
        losses.append(float(m["loss"]))
    return tokens, before, np.array(losses)


def _held(got, losses):
    for g in got:  # every rank reports the global loss
        np.testing.assert_allclose(g["losses"], losses, rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]


def test_moe_expert_parallel_matches_jax(ranks):
    tokens, before, losses = _jax_train(
        {"data": 2, "expert": 2, "tensor": 2}, _jax_cfg(experts=4), ep=True)
    got = ranks.run("train", experts=4, kv_heads=2, attention="ring",
                    steps=STEPS, tokens=tokens, **{"mesh/data": 2,
                                                   "mesh/expert": 2},
                    **_port_params(before, experts=4))
    _held(got, losses)


@pytest.mark.parametrize("attention,kv_heads", [("ring", 2),
                                                ("ulysses", 4)])
def test_context_and_tensor_match_jax(ranks, attention, kv_heads):
    make = {"ring": make_ring_attention,
            "ulysses": make_ulysses_attention}[attention]
    tokens, before, losses = _jax_train(
        {"data": 2, "context": 2, "tensor": 2}, _jax_cfg(kv_heads=kv_heads),
        attention=make, context=True)
    got = ranks.run("train", experts=0, kv_heads=kv_heads,
                    attention=attention, steps=STEPS, tokens=tokens,
                    **{"mesh/context": 2, "mesh/tensor": 2},
                    **_port_params(before, kv_heads=kv_heads))
    _held(got, losses)


@pytest.fixture
def fake_world():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    yield
    dist.destroy_process_group()


def test_ulysses_refuses_heads_that_do_not_divide(fake_world):
    from tpucfn_torch.kernels import make_ulysses_attention as port_ulysses
    from tpucfn_torch.mesh import MeshSpec as PortSpec
    from tpucfn_torch.mesh import build_mesh as port_mesh

    mesh = port_mesh(PortSpec(context=2, tensor=2), device_type="cpu")
    fn = port_ulysses(mesh)
    q, kv = torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 1, 8)
    with pytest.raises(ValueError, match=r"heads 2/1 \(this rank's block "
                       r"over tensor of size 2\) not divisible by context "
                       r"axis 2"):
        fn(q, kv, kv)


def test_tensor_axis_must_divide_the_kv_heads(fake_world):
    from tpucfn_torch.mesh import MeshSpec as PortSpec
    from tpucfn_torch.mesh import build_mesh as port_mesh
    from tpucfn_torch.models.llama import Llama, LlamaConfig

    mesh = port_mesh(PortSpec(tensor=4), device_type="cpu")
    with torch.device("meta"), pytest.raises(
            ValueError, match="KV heads 2 do not split over the tensor axis "
            "of size 4"):
        Llama(LlamaConfig.tiny(), tensor_mesh=mesh)


@pytest.mark.parametrize("saved,restored", [("fsdp2_tensor2", "data4"),
                                            ("data4", "fsdp2_tensor2")])
def test_checkpoint_restores_onto_another_layout(ranks, tmp_path, saved,
                                                 restored):
    from tpucfn_torch.models.llama import LlamaConfig, init_llama_params

    cfg = dataclasses.replace(LlamaConfig.tiny(), param_dtype=torch.float32)
    sd = init_llama_params(cfg, generator=torch.Generator().manual_seed(0))
    got = ranks.run("ckpt", experts=0, kv_heads=2, saved=saved,
                    restored=restored, dir=str(tmp_path / "ckpt"),
                    tokens=_tokens(cfg.vocab_size),
                    **{f"p/{k}": v.numpy() for k, v in sd.items()})
    for g in got:
        keys = [k[len("saved/"):] for k in g if k.startswith("saved/")]
        assert any(k.startswith("opt/1/exp_avg_sq/") for k in keys) or \
            any(k.startswith("opt/exp_avg_sq/") for k in keys)
        for k in keys:
            np.testing.assert_array_equal(g[f"restored/{k}"],
                                          g[f"saved/{k}"], err_msg=k)
        assert int(g["restored/step"]) == 2
