"""Context parallelism in the port's training path against the JAX
package's.

* The Trainer with ``TrainerConfig(batch_extra_axes=("context",))`` over 4
  gloo ranks at (data 1, context 4), ring hops through the flash
  wrappers (their CPU path, dLSE included: ``llama_train_fns``' default
  attention over a context mesh), and at (data 2, context 2),
  dense hops, against the JAX Trainer on ``MeshSpec(data=2, context=4)``
  (ring attention, dense hops), with JAX's initial params carried
  across, the same global batch, the chunked CE with z-loss, and a
  global-norm clip before SGD with momentum (linear in the gradients:
  AdamW's first steps divide each gradient by its own magnitude, which
  turns sum-order noise in a near-zero gradient into a whole step): after
  two steps each step's loss within 1e-5 relative, its accuracy within
  1e-6, and every updated parameter within 1e-5 relative (norm of the
  difference over the norm), on every rank.  The global mean does not
  depend on the mesh.
* ``causal_lm_loss`` and ``chunked_causal_lm_loss`` on blocks of the
  sequence, weighted by ``causal_lm_loss_weight``'s counts, equal the
  JAX package's whole-sequence values within 1e-6 relative, the last
  block's missing prediction included.
* The port's example under the launcher's env contract with ``--model
  tiny --context 2 --ring-flash`` on 2 gloo ranks: each step's loss
  within 1e-5 relative of ``--context 1`` on one rank (where
  ``--ring-flash`` changes nothing).
* ``--packed --context 2`` exits with the JAX example's text, ``--tensor
  2`` still names C2, and the Trainer takes a context axis only with
  ``batch_extra_axes``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from test_torch_rank_pool import RankPool, free_port
from tpucfn.kernels import make_ring_attention
from tpucfn.mesh import MeshSpec, build_mesh
from tpucfn.models import llama as jax_llama
from tpucfn.parallel import shard_batch
from tpucfn.train import Trainer, TrainerConfig

REPO = Path(__file__).resolve().parent.parent
W = 4
LOSS_RTOL = 1e-5
ACC_ATOL = 1e-6
PARAM_RTOL = 1e-5
BLOCK_RTOL = 1e-6
CHUNK, Z_LOSS = 8, 1e-4
LR = 0.5

CASES = textwrap.dedent("""
    import dataclasses
    import numpy as np
    import torch
    from tpucfn_torch.collectives import axis_index
    from tpucfn_torch.kernels import make_ring_attention
    from tpucfn_torch.mesh import BATCH_AXES, MeshSpec, build_mesh
    from tpucfn_torch.models.llama import (LlamaConfig, causal_lm_loss_weight,
                                           sharding_rules)
    from tpucfn_torch.parallel import shard_batch
    from tpucfn_torch.train import (Trainer, TrainerConfig, chain,
                                    clip_by_global_norm, llama_train_fns,
                                    sgd)

    MESHES = {}

    def train(rank, world, inputs):
        data, LR = int(inputs["data"]), float(inputs["lr"])
        if data not in MESHES:
            MESHES[data] = build_mesh(MeshSpec(data=data,
                                               context=world // data),
                                      device_type="cpu")
        m = MESHES[data]
        cfg = dataclasses.replace(LlamaConfig.tiny(),
                                  param_dtype=torch.float32)
        params = {k[2:]: torch.from_numpy(v) for k, v in inputs.items()
                  if k.startswith("p/")}
        hop = str(inputs["hop"])
        # flash hops: llama_train_fns' own default over a context mesh
        _, loss_fn = llama_train_fns(
            cfg, attention_fn=None if hop == "flash" else make_ring_attention(
                m, hop_attention=hop),
            chunk_size=int(inputs["chunk"]), z_loss=float(inputs["z_loss"]),
            context_mesh=m)
        tx = chain(clip_by_global_norm(1.0), sgd(LR, momentum=0.9))
        trainer = Trainer(m, sharding_rules(cfg, tensor=False), loss_fn, tx,
                          lambda g: (dict(params), {}),
                          config=TrainerConfig(batch_extra_axes=("context",)),
                          loss_weight=causal_lm_loss_weight(m))
        state = trainer.init(0)
        tokens = inputs["tokens"]
        rows = tokens.shape[0] // data
        d = axis_index(BATCH_AXES, mesh=m)
        batch = shard_batch(m, {"tokens": tokens[d * rows:(d + 1) * rows]},
                            ("context",))
        losses, accs = [], []
        for _ in range(2):
            state, metrics = trainer.step(state, batch)
            losses.append(metrics["loss"].item())
            accs.append(metrics["accuracy"].item())
        return {"losses": np.array(losses), "accuracy": np.array(accs),
                **{f"p/{k}": v.detach().numpy()
                   for k, v in state.params.items()}}
""")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    with RankPool(W, CASES, tmp_path_factory.mktemp("context")) as pool:
        yield pool


def _tokens(vocab, b=4, s=32, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


@pytest.fixture(scope="module")
def jax_run():
    """Two steps of the JAX Trainer on (data 2, context 4): each step's
    loss and accuracy, and the params before and after."""
    cfg = jax_llama.LlamaConfig.tiny()
    mesh = build_mesh(MeshSpec(data=2, context=4))
    model = jax_llama.Llama(cfg, attention_fn=make_ring_attention(mesh))
    tokens = _tokens(cfg.vocab_size)

    def init_fn(rng):
        return model.init(rng, jnp.zeros((2, 32), jnp.int32))["params"], {}

    def loss_fn(params, mstate, batch, rng):
        hidden = model.apply({"params": params}, batch["tokens"],
                             return_hidden=True)
        loss, acc = jax_llama.chunked_causal_lm_loss(
            hidden, params["lm_head"]["kernel"], batch["tokens"],
            chunk_size=CHUNK, z_loss=Z_LOSS)
        return loss, ({"accuracy": acc}, mstate)

    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.sgd(LR, momentum=0.9))
    trainer = Trainer(mesh, jax_llama.sharding_rules(cfg, tensor=False),
                      loss_fn, tx, init_fn,
                      config=TrainerConfig(batch_extra_axes=("context",)))
    state = trainer.init(jax.random.key(0))
    before = jax.tree.map(np.asarray, state.params)
    batch = shard_batch(mesh, {"tokens": tokens}, extra_axes=("context",))
    losses, accs = [], []
    for _ in range(2):
        state, m = trainer.step(state, batch)
        losses.append(float(m["loss"]))
        accs.append(float(m["accuracy"]))
    return (tokens, before, jax.tree.map(np.asarray, state.params),
            np.array(losses), np.array(accs))


def _port_cfg():
    from tpucfn_torch.models.llama import LlamaConfig

    return dataclasses.replace(LlamaConfig.tiny(), param_dtype=torch.float32)


@pytest.mark.parametrize("data,hop", [(1, "flash"), (2, "dense")],
                         ids=["data1_context4_flash", "data2_context2_dense"])
def test_trainer_equals_the_jax_trainer(ranks, jax_run, data, hop):
    from tpucfn_torch.models.convert import llama_state_dict_from_jax

    tokens, before, after, losses, accs = jax_run
    pcfg = _port_cfg()
    sd = llama_state_dict_from_jax(before, pcfg)
    want = llama_state_dict_from_jax(after, pcfg)
    got = ranks.run("train", data=data, hop=hop, chunk=CHUNK, z_loss=Z_LOSS,
                    lr=LR, tokens=tokens,
                    **{f"p/{k}": v.numpy() for k, v in sd.items()})
    for g in got:  # every rank: the global loss, accuracy and params
        np.testing.assert_allclose(g["losses"], losses, rtol=LOSS_RTOL)
        np.testing.assert_allclose(g["accuracy"], accs, rtol=0,
                                   atol=ACC_ATOL)
        for name, ref in want.items():
            ref = ref.numpy()
            rel = (np.linalg.norm(g[f"p/{name}"] - ref)
                   / max(np.linalg.norm(ref), 1e-30))
            assert rel <= PARAM_RTOL, (name, rel)
    assert losses[1] < losses[0]


class _Blocks:
    """A stand-in mesh: block ``i`` of ``n`` on the context axis."""

    def __init__(self, i, n):
        self.i, self.mesh_dim_names, self.shape = i, ("context",), (n,)

    def get_local_rank(self, axis):
        return self.i


@pytest.mark.parametrize("blocks", [2, 4])
@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_losses_on_blocks_equal_the_whole_sequence(blocks, z_loss):
    from tpucfn_torch.models.llama import (causal_lm_loss,
                                           causal_lm_loss_weight,
                                           chunked_causal_lm_loss)

    rs = np.random.RandomState(1)
    b, s, v, d = 3, 16, 32, 8
    tokens = rs.randint(0, v, (b, s)).astype(np.int32)
    logits = rs.randn(b, s, v).astype(np.float32)
    hidden = rs.randn(b, s, d).astype(np.float32)
    w = rs.randn(d, v).astype(np.float32)  # JAX's (D, V) kernel
    ref = jax_llama.causal_lm_loss(jnp.asarray(logits), jnp.asarray(tokens),
                                   z_loss=z_loss)
    ref_chunked = jax_llama.chunked_causal_lm_loss(
        jnp.asarray(hidden), jnp.asarray(w), jnp.asarray(tokens),
        chunk_size=3, z_loss=z_loss)
    t = torch.from_numpy(tokens)
    n = s // blocks
    sums = np.zeros((2, 2))  # (full, chunked) x (loss, accuracy)
    count = 0
    for i in range(blocks):
        sl = slice(i * n, (i + 1) * n)
        nxt = t[:, (i + 1) * n:(i + 1) * n + 1] if i < blocks - 1 else None
        c = int(causal_lm_loss_weight(_Blocks(i, blocks))({"tokens": t[:, sl]}))
        full = causal_lm_loss(torch.from_numpy(logits[:, sl]), t[:, sl],
                              z_loss=z_loss, next_tokens=nxt)
        chunked = chunked_causal_lm_loss(
            torch.from_numpy(hidden[:, sl]), torch.from_numpy(w.T.copy()),
            t[:, sl], chunk_size=3, z_loss=z_loss, next_tokens=nxt)
        sums += c * np.array([[x.item() for x in full],
                              [x.item() for x in chunked]])
        count += c
    assert count == b * (s - 1)
    for got, want in zip(sums / count, (ref, ref_chunked)):
        np.testing.assert_allclose(got, [float(x) for x in want],
                                   rtol=BLOCK_RTOL)


# ---- the example ---------------------------------------------------------------

EXAMPLE = ["-m", "tpucfn_torch.examples.llama3_8b_fsdp", "--device", "cpu",
           "--model", "tiny", "--seq-len", "32", "--batch-size", "4",
           "--num-examples", "16", "--ce-chunk", "8", "--log-every", "1",
           "--steps", "4", "--ckpt-every", "100", "--ring-flash"]


def _losses(run_dir):
    rows = [json.loads(line) for line in
            (Path(run_dir) / "logs" / "train-host000.jsonl").read_text()
            .splitlines()]
    return {r["step"]: r["loss"] for r in rows if "loss" in r}


def test_example_context_2_equals_context_1(tmp_path):
    from tpucfn_torch.bootstrap import EnvContract

    env = dict(os.environ, PYTHONPATH=str(REPO))
    for var in EnvContract.__dataclass_fields__:
        env.pop(f"TPUCFN_{var.upper()}", None)
    one = subprocess.Popen([sys.executable, *EXAMPLE, "--run-dir",
                            str(tmp_path / "one")], env=env, cwd=REPO,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    (tmp_path / "hostfile").write_text("127.0.0.1\n127.0.0.1\n")
    port = free_port()
    two = []
    for rank in range(2):
        rank_env = dict(env, **EnvContract(
            workers_path=str(tmp_path / "hostfile"), workers_count=2,
            worker_chip_count=1, coordinator=f"127.0.0.1:{port}",
            host_id=rank, storage="", generation=0).to_env())
        two.append(subprocess.Popen(
            [sys.executable, *EXAMPLE, "--context", "2", "--run-dir",
             str(tmp_path / "two")], env=rank_env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for p in (one, *two):
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-4000:]
    ref, got = _losses(tmp_path / "one"), _losses(tmp_path / "two")
    assert sorted(ref) == sorted(got) == [1, 2, 3, 4]
    np.testing.assert_allclose([got[s] for s in ref], list(ref.values()),
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("flags,text", [
    (["--packed", "--context", "2"],
     "--packed composes with DP/FSDP/TP only (segment ids don't thread "
     "through PP/SP yet)"),
    (["--tensor", "2", "--context", "2"], "ROADMAP Queue 1 C2")],
    ids=["packed", "tensor"])
def test_example_refusals(flags, text, tmp_path):
    from tpucfn_torch.examples import llama3_8b_fsdp as ex

    with pytest.raises(SystemExit) as e:
        ex.main(["--device", "cpu", "--run-dir", str(tmp_path), "--model",
                 "tiny", *flags])
    assert isinstance(e.value.code, str) and text in e.value.code
    assert "C3" not in e.value.code
    assert not list(tmp_path.iterdir())


@pytest.fixture
def fake_world():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def make(n):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


def test_trainer_takes_a_context_axis_only_as_a_batch_split(fake_world):
    from tpucfn_torch.mesh import build_mesh as port_mesh
    from tpucfn_torch.mesh import MeshSpec as PortSpec
    from tpucfn_torch.models.llama import sharding_rules
    from tpucfn_torch.train import Trainer as PortTrainer
    from tpucfn_torch.train import TrainerConfig as PortConfig
    from tpucfn_torch.train import adamw, llama_train_fns

    fake_world(4)
    cfg = _port_cfg()
    init_fn, loss_fn = llama_train_fns(cfg, chunk_size=16)
    split = PortConfig(batch_extra_axes=("context",))

    def trainer(config, **axes):
        return PortTrainer(port_mesh(PortSpec(**axes), device_type="cpu"),
                           sharding_rules(cfg, tensor=False), loss_fn,
                           adamw(1e-3), init_fn, config=config)

    assert trainer(split, context=4).world == 4
    assert trainer(split, data=2, context=2).world == 4
    with pytest.raises(NotImplementedError, match="batch_extra_axes"):
        trainer(PortConfig(), context=4)
    for axis, item in (("tensor", "C2"), ("pipeline", "C5")):
        with pytest.raises(NotImplementedError, match=item) as e:
            trainer(split, context=2, **{axis: 2})
        assert "C3" not in str(e.value)
