"""Sharded parameters in the port's Trainer against the JAX package's, on
4 gloo ranks of one pool (the JAX Trainer on 8 fake CPU devices in this
process, JAX's initial params carried across, the same global batch).

* fsdp 2 x tensor 2 under ``sharding_rules(cfg)`` (the port on 4 ranks,
  JAX on data 2 x fsdp 2 x tensor 2: the global mean does not depend on
  the data axis): the loss of each of 3 AdamW steps within 2e-4
  relative, as ``tests/test_llama.py``'s TP x FSDP test holds JAX's
  sharded training to its replicated one.  The chunked CE with z-loss,
  whose log-sum-exp spans the tensor shards.
* ZeRO-1 (``zero1_rules`` over the fsdp-only rules; the port on data 2 x
  fsdp 2, JAX on data 4 x fsdp 2): the same.
* Each rank's blocks of the params and of the first AdamW moment have
  the shapes of JAX's per-device shards (carried through the layout
  conversion), under both.
* The clip's norm is the global one: one step of a global-norm clip that
  binds, then SGD, over full logits (gathered over the tensor axis),
  leaves every param within 1e-5 relative of JAX's.
"""

import dataclasses
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_rank_pool import RankPool
from tpucfn.mesh import MeshSpec, build_mesh
from tpucfn.models import llama as jax_llama
from tpucfn.parallel import shard_batch
from tpucfn.parallel.presets import zero1_rules as jax_zero1_rules
from tpucfn.train import Trainer

W = 4
LOSS_RTOL = 2e-4
PARAM_RTOL = 1e-5
CHUNK, Z_LOSS = 8, 1e-4
LR = 3e-3
CLIP, CLIP_LR = 0.05, 0.1
STEPS = 3

CASES = textwrap.dedent("""
    import dataclasses
    import numpy as np
    import torch
    from tpucfn_torch.collectives import axis_index, axis_size
    from tpucfn_torch.mesh import BATCH_AXES, MeshSpec, build_mesh
    from tpucfn_torch.models.llama import LlamaConfig, sharding_rules
    from tpucfn_torch.parallel import zero1_rules
    from tpucfn_torch.train import (Trainer, adamw, chain,
                                    clip_by_global_norm, llama_train_fns,
                                    sgd)

    MESHES = {}

    def train(rank, world, inputs):
        axes = {k[5:]: int(v) for k, v in inputs.items()
                if k.startswith("mesh/")}
        key = tuple(sorted(axes.items()))
        if key not in MESHES:
            MESHES[key] = build_mesh(MeshSpec(**axes), device_type="cpu")
        m = MESHES[key]
        cfg = dataclasses.replace(LlamaConfig.tiny(),
                                  param_dtype=torch.float32)
        params = {k[2:]: torch.from_numpy(v) for k, v in inputs.items()
                  if k.startswith("p/")}
        rules = sharding_rules(cfg, tensor=axes.get("tensor", 1) > 1)
        if str(inputs["rules"]) == "zero1":
            rules = zero1_rules(rules)
        _, loss_fn = llama_train_fns(
            cfg, chunk_size=int(inputs["chunk"]),
            z_loss=float(inputs["z_loss"]),
            tensor_mesh=m if axes.get("tensor", 1) > 1 else None)
        lr = float(inputs["lr"])
        tx = adamw(lr) if str(inputs["opt"]) == "adamw" else chain(
            clip_by_global_norm(float(inputs["clip"])), sgd(lr))
        trainer = Trainer(m, rules, loss_fn, tx,
                          lambda g: (dict(params), {}))
        state = trainer.init(0)
        tokens = inputs["tokens"]
        rows = tokens.shape[0] // axis_size(BATCH_AXES, mesh=m)
        d = axis_index(BATCH_AXES, mesh=m)
        batch = {"tokens": torch.from_numpy(tokens[d * rows:(d + 1) * rows])}
        losses = []
        for _ in range(int(inputs["steps"])):
            state, metrics = trainer.step(state, batch)
            losses.append(metrics["loss"].item())
        out = {"losses": np.array(losses)}
        for k, v in state.state_dict().items():
            if k.startswith(("params/", "opt/exp_avg/")):
                out[f"shape/{k}"] = np.array(v.shape)
        shardings = trainer.state_shardings()
        for name, p in state.params.items():
            out[f"p/{name}"] = shardings[f"params/{name}"].unshard(p).numpy()
        return out
""")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    with RankPool(W, CASES, tmp_path_factory.mktemp("sharded")) as pool:
        yield pool


def _tokens(vocab, b=8, s=16, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


def _jax_train(spec, rules, tx, *, chunk, steps, norm=False):
    """``steps`` steps of the JAX Trainer on ``spec``'s mesh: the losses,
    the params before and after, the state's first-moment and params'
    per-device shard shapes, and with ``norm`` JAX's global gradient norm
    at the first step."""
    cfg = jax_llama.LlamaConfig.tiny()
    mesh = build_mesh(MeshSpec(**spec))
    model = jax_llama.Llama(cfg)
    tokens = _tokens(cfg.vocab_size)

    def init_fn(rng):
        return model.init(rng, jnp.zeros((2, 16), jnp.int32))["params"], {}

    def loss_fn(params, mstate, batch, rng):
        if chunk:
            hidden = model.apply({"params": params}, batch["tokens"],
                                 return_hidden=True)
            loss, acc = jax_llama.chunked_causal_lm_loss(
                hidden, params["lm_head"]["kernel"], batch["tokens"],
                chunk_size=chunk, z_loss=Z_LOSS)
        else:
            logits = model.apply({"params": params}, batch["tokens"])
            loss, acc = jax_llama.causal_lm_loss(logits, batch["tokens"],
                                                 z_loss=Z_LOSS)
        return loss, ({"accuracy": acc}, mstate)

    trainer = Trainer(mesh, rules(cfg), loss_fn, tx, init_fn)
    state = trainer.init(jax.random.key(0))
    before = jax.tree.map(np.asarray, state.params)
    batch = shard_batch(mesh, {"tokens": tokens})
    grad_norm = float(jax.jit(lambda p: optax.global_norm(jax.grad(
        lambda q: loss_fn(q, {}, batch, None)[0])(p)))(state.params)) \
        if norm else None

    def shard_shapes(tree):
        return jax.tree.map(lambda a: np.zeros(
            a.addressable_shards[0].data.shape, np.float32), tree)

    shards = {"params": shard_shapes(state.params)}
    if hasattr(state.opt_state[0], "mu"):
        shards["mu"] = shard_shapes(state.opt_state[0].mu)
    losses = []
    for _ in range(steps):
        state, m = trainer.step(state, batch)
        losses.append(float(m["loss"]))
    return dict(tokens=tokens, before=before,
                after=jax.tree.map(np.asarray, state.params),
                losses=np.array(losses), shards=shards, grad_norm=grad_norm)


def _port_cfg():
    from tpucfn_torch.models.llama import LlamaConfig

    return dataclasses.replace(LlamaConfig.tiny(), param_dtype=torch.float32)


def _as_port(tree):
    from tpucfn_torch.models.convert import llama_state_dict_from_jax

    return {k: v.numpy() for k, v in
            llama_state_dict_from_jax(tree, _port_cfg()).items()}


def _shapes_as_port(tree):
    """Port name -> shape of a JAX tree of (per-device) arrays: the scanned
    layer axis dropped, a dense kernel's (in, out) read as (out, in)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(k.key) for k in path]
        shape = leaf.shape
        if keys[-1] == "kernel":
            shape = shape[:-2] + shape[-2:][::-1]
        name = {"embedding": "weight", "kernel": "weight",
                "scale": "scale"}[keys[-1]]
        if keys[0] == "layers":
            for i in range(_port_cfg().n_layers):
                out[".".join(["layers", str(i), *keys[1:-1], name])] = \
                    tuple(shape[1:])
        else:
            out[".".join([*keys[:-1], name])] = tuple(shape)
    return out


# (port mesh, JAX mesh, rules name, JAX rules)
LAYOUTS = {
    "tp_fsdp": ({"fsdp": 2, "tensor": 2}, {"data": 2, "fsdp": 2, "tensor": 2},
                "tp_fsdp", lambda cfg: jax_llama.sharding_rules(cfg)),
    "zero1": ({"data": 2, "fsdp": 2}, {"data": 4, "fsdp": 2}, "zero1",
              lambda cfg: jax_zero1_rules(
                  jax_llama.sharding_rules(cfg, tensor=False))),
}


@pytest.fixture(scope="module")
def adamw_runs(ranks):
    """Per layout: JAX's run and the port's, 3 AdamW steps each."""
    out = {}
    for layout, (port_mesh, jax_mesh, name, rules) in LAYOUTS.items():
        ref = _jax_train(jax_mesh, rules, optax.adamw(LR), chunk=CHUNK,
                         steps=STEPS)
        got = ranks.run("train", rules=name, chunk=CHUNK, z_loss=Z_LOSS,
                        lr=LR, opt="adamw", clip=0.0, steps=STEPS,
                        tokens=ref["tokens"],
                        **{f"mesh/{a}": n for a, n in port_mesh.items()},
                        **{f"p/{k}": v
                           for k, v in _as_port(ref["before"]).items()})
        out[layout] = ref, got
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_training_matches_jax(adamw_runs, layout):
    ref, got = adamw_runs[layout]
    for g in got:  # every rank reports the global loss
        np.testing.assert_allclose(g["losses"], ref["losses"],
                                   rtol=LOSS_RTOL)
    assert ref["losses"][-1] < ref["losses"][0]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_shard_shapes_equal_jax(adamw_runs, layout):
    ref, got = adamw_runs[layout]
    want = {f"params/{k}": v
            for k, v in _shapes_as_port(ref["shards"]["params"]).items()}
    want.update({f"opt/exp_avg/{k}": v
                 for k, v in _shapes_as_port(ref["shards"]["mu"]).items()})
    for g in got:
        have = {k[len("shape/"):]: tuple(int(n) for n in v)
                for k, v in g.items() if k.startswith("shape/")}
        assert have == want
    split = [k for k, v in want.items()
             if v != tuple(_as_port(ref["before"])[k.split("/")[-1]].shape)]
    assert split  # the layout splits something


def test_clip_norm_is_the_global_norm(ranks):
    port_mesh, jax_mesh, name, rules = LAYOUTS["tp_fsdp"]
    ref = _jax_train(jax_mesh, rules, optax.chain(
        optax.clip_by_global_norm(CLIP), optax.sgd(CLIP_LR)), chunk=0,
        steps=1, norm=True)
    assert ref["grad_norm"] > 10 * CLIP  # the clip binds
    got = ranks.run("train", rules=name, chunk=0, z_loss=Z_LOSS, lr=CLIP_LR,
                    opt="sgd", clip=CLIP, steps=1, tokens=ref["tokens"],
                    **{f"mesh/{a}": n for a, n in port_mesh.items()},
                    **{f"p/{k}": v
                       for k, v in _as_port(ref["before"]).items()})
    want = _as_port(ref["after"])
    for g in got:
        np.testing.assert_allclose(g["losses"], ref["losses"],
                                   rtol=LOSS_RTOL)
        for k, v in want.items():
            rel = np.linalg.norm(g[f"p/{k}"] - v) / np.linalg.norm(v)
            assert rel <= PARAM_RTOL, (k, rel)
