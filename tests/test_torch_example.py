"""The port's Llama example and training loop against the JAX package's.

* Loop parity: JAX's ``run_train_loop`` with JAX's ``Trainer`` (in a
  subprocess: the JAX example module arms a process-wide compile cache at
  import) and the port's with the port's, on the same tiny fp32 config,
  the same shards, the example's optimizer chain and loss, and JAX's
  initial params carried across, for 6 steps: their ``MetricLogger``
  JSONL losses agree within 1e-4 absolute (the tolerance of the tiny fp32
  kernel-against-plain checks).  Beside it, the port's analytic step
  FLOPs against the JAX trainer's XLA cost analysis of the same step.
* Resume: the example as a subprocess with ``--device cpu``,
  ``--stop-after 3`` then a relaunch to ``--steps 6``, prints ``resumed
  from step 3`` and its losses for steps 4-6 equal an uninterrupted run's
  exactly.
* Packed: ``--packed`` runs 3 steps with finite losses.
* Refusals: each unported flag exits non-zero naming what is missing
  (the input service and the compile cache, refused here before, run
  since: ``tests/test_torch_planes.py``); a step that will not restore
  exits with ``RESTORE_FAILED_RC``; without ``--device cpu`` there is no
  card here, and the example raises instead of training on the CPU.
"""

import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

REPO = Path(__file__).resolve().parent.parent
EXAMPLE = REPO / "tpucfn_torch" / "examples" / "llama3_8b_fsdp.py"
LOSS_TOL = 1e-4
TINY = ["--model", "tiny", "--seq-len", "32", "--batch-size", "8",
        "--num-examples", "64", "--ce-chunk", "16", "--log-every", "1"]


def _losses(run_dir):
    rows = [json.loads(line) for line in
            (Path(run_dir) / "logs" / "train-host000.jsonl").read_text()
            .splitlines()]
    return {r["step"]: r["loss"] for r in rows if "loss" in r}


@pytest.fixture
def no_group():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


# ---- loop parity -------------------------------------------------------------

JAX_RUN = textwrap.dedent("""
    import argparse, dataclasses, importlib.util, json, sys
    from pathlib import Path
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp, numpy as np, optax
    repo, run_dir = Path(sys.argv[1]), Path(sys.argv[2])
    spec = importlib.util.spec_from_file_location(
        "jax_example_common", repo / "examples" / "common.py")
    common = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(common)
    from tpucfn.data import ShardedDataset
    from tpucfn.mesh import MeshSpec, build_mesh
    from tpucfn.models.llama import (Llama, LlamaConfig,
                                     chunked_causal_lm_loss, sharding_rules)
    from tpucfn.parallel import shard_batch
    from tpucfn.train import Trainer

    p = argparse.ArgumentParser()
    common.add_cluster_args(p)
    args = p.parse_args(["--run-dir", str(run_dir), "--batch-size", "8",
                         "--steps", "6", "--log-every", "1"])
    cfg = LlamaConfig.tiny()
    shards = common.stage_synthetic("tokens", run_dir / "data", n=64,
                                    num_shards=8, seed=0, seq_len=32,
                                    vocab=cfg.vocab_size)
    mesh = build_mesh(MeshSpec(), devices=jax.devices()[:1])
    model = Llama(cfg)
    params = model.init(jax.random.key(7), jnp.zeros((1, 32), jnp.int32))["params"]
    flat = {"/".join(str(k.key) for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(run_dir / "init_params.npz", **flat)

    def loss_fn(params, mstate, batch, rng):
        hidden = model.apply({"params": params}, batch["tokens"],
                             return_hidden=True)
        loss, acc = chunked_causal_lm_loss(
            hidden, params["lm_head"]["kernel"], batch["tokens"],
            chunk_size=16, z_loss=1e-4)
        return loss, ({"accuracy": acc}, mstate)

    total = 6
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        optax.warmup_cosine_decay_schedule(0.0, 3e-4,
                                           max(1, min(100, total // 10)),
                                           total),
        b1=0.9, b2=0.95, weight_decay=0.1))
    trainer = Trainer(mesh, sharding_rules(cfg, tensor=False), loss_fn, tx,
                      lambda rng: (params, {}))
    ds = ShardedDataset(shards, batch_size_per_process=8, seed=0)
    common.run_train_loop(trainer, ds, mesh, args, items_per_step=8 * 32)
    batch = jax.ShapeDtypeStruct((8, 32), jnp.int32,
                                 sharding=trainer.batch_sharding())
    flops = {"scanned": trainer.step_cost_flops({"tokens": batch})}
    # the same step with the layers unrolled: XLA's cost analysis counts a
    # loop body once, so the scanned figure holds one layer
    cfg = dataclasses.replace(cfg, scan_layers=False)
    model = Llama(cfg)  # the one loss_fn applies
    unrolled = model.init(jax.random.key(7),
                          jnp.zeros((1, 32), jnp.int32))["params"]
    trainer = Trainer(mesh, sharding_rules(cfg, tensor=False), loss_fn, tx,
                      lambda rng: (unrolled, {}))
    trainer.step(trainer.init(jax.random.key(0)),
                 shard_batch(mesh, next(ds.batches(1))))
    flops["unrolled"] = trainer.step_cost_flops({"tokens": batch})
    print(json.dumps(flops))
""")


def _carried_state_dict(run_dir, pcfg):
    from tpucfn_torch.models.convert import llama_state_dict_from_jax

    flat = np.load(Path(run_dir) / "init_params.npz")
    tree: dict = {}
    for path in flat.files:
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = flat[path]
    return llama_state_dict_from_jax(tree, pcfg)


def test_loop_parity_with_jax(tmp_path, no_group):
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_dir.mkdir()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TPUCFN_")}
    env["PYTHONPATH"] = str(REPO)
    env["TPUCFN_XLA_CACHE"] = str(tmp_path / "xla-cache")
    r = subprocess.run([sys.executable, "-c", JAX_RUN, str(REPO),
                        str(jax_dir)], env=env, cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    jax_flops = json.loads(r.stdout.strip().splitlines()[-1])

    from tpucfn_torch.data import ShardedDataset
    from tpucfn_torch.examples import llama3_8b_fsdp as ex
    from tpucfn_torch.examples.common import run_train_loop
    from tpucfn_torch.mesh import MeshSpec, build_mesh
    from tpucfn_torch.models.llama import sharding_rules, train_step_flops
    from tpucfn_torch.train import Trainer

    args = ex.build_parser().parse_args(
        ["--device", "cpu", "--run-dir", str(port_dir), "--steps", "6",
         *TINY])
    cfg = ex.model_config(args)
    sd = _carried_state_dict(jax_dir, cfg)
    mesh = build_mesh(MeshSpec(), device_type="cpu")
    trainer = Trainer(mesh, sharding_rules(cfg, tensor=False),
                      ex.make_loss_fn(cfg, args), ex.example_chain(6),
                      lambda generator: ({k: v.clone() for k, v in sd.items()},
                                         {}))
    ds = ShardedDataset(sorted((jax_dir / "data").glob("*.tpurec")),
                        batch_size_per_process=8, seed=0)
    state = run_train_loop(trainer, ds, mesh, args, items_per_step=8 * 32)
    assert state.step == 6

    want, got = _losses(jax_dir), _losses(port_dir)
    assert sorted(got) == sorted(want) == list(range(1, 7))
    diff = max(abs(got[s] - want[s]) for s in want)
    assert diff <= LOSS_TOL, (got, want)
    assert got[6] < got[1]
    # the MFU numerator: analytic FLOPs against XLA's count of the JAX
    # step (dense S x S attention, elementwise work, the optimizer)
    port_flops = train_step_flops(cfg, 8, 32)
    print(f"step FLOPs tiny 8x32: port analytic {port_flops:.6g}, JAX "
          f"cost analysis {jax_flops['scanned']:.6g} (layers scanned), "
          f"{jax_flops['unrolled']:.6g} (unrolled)")
    # the scanned figure counts one layer's body; unrolled, within 10%
    assert port_flops > jax_flops["scanned"]
    assert abs(port_flops / jax_flops["unrolled"] - 1) < 0.1


# ---- the example as a program --------------------------------------------

def _example(run_dir, *argv, timeout=240):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TPUCFN_")}
    env["PYTHONPATH"] = str(REPO)
    return subprocess.Popen(
        [sys.executable, str(EXAMPLE), "--device", "cpu", "--run-dir",
         str(run_dir), *TINY, *argv], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _done(proc, timeout=240):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-4000:]
    return out


def test_resume_equals_an_uninterrupted_run(tmp_path):
    whole = _example(tmp_path / "whole", "--steps", "6")
    first = _example(tmp_path / "cut", "--steps", "6", "--stop-after", "3")
    _done(whole)
    out = _done(first)
    assert "final: step=3" in out and "resumed" not in out
    assert sorted(int(p.name) for p in (tmp_path / "cut" / "ckpt").iterdir()) \
        == [1, 3]  # the directory's first save, and the final force-save
    out = _done(_example(tmp_path / "cut", "--steps", "6"))
    assert "resumed from step 3" in out and "final: step=6" in out
    whole_l, cut_l = _losses(tmp_path / "whole"), _losses(tmp_path / "cut")
    assert [cut_l[s] for s in (4, 5, 6)] == [whole_l[s] for s in (4, 5, 6)]
    assert all(math.isfinite(v) for v in whole_l.values())


def test_packed_runs(tmp_path):
    out = _done(_example(tmp_path, "--packed", "--steps", "3"))
    assert "final: step=3" in out
    losses = _losses(tmp_path)
    assert sorted(losses) == [1, 2, 3]
    assert all(math.isfinite(v) for v in losses.values())
    assert (tmp_path / "data" / "corpus.jsonl").exists()


@pytest.mark.parametrize("flags,item", [
    (["--profile-server", "9001"], "B3"),
    (["--fsdp", "2"], "C2"), (["--tensor", "2"], "C2"),
    (["--context", "2", "--pipeline", "2"], "C5"),
    (["--context", "2", "--packed"], "DP/FSDP/TP only"),
    (["--moe-experts", "4", "--expert", "2"], "C2"),
    (["--pipeline", "2"], "C5")])
def test_unported_flags_are_refused(flags, item, tmp_path):
    from tpucfn_torch.examples import llama3_8b_fsdp as ex

    with pytest.raises(SystemExit) as e:
        ex.main(["--device", "cpu", "--run-dir", str(tmp_path), *TINY,
                 *flags])
    assert isinstance(e.value.code, str) and item in e.value.code
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("flags", [
    ["--lr", "0.01"], ["--resume"], ["--kv-store", "device"],
    ["--microbatches", "8"], ["--pp-schedule", "1f1b"], ["--pp-virtual", "2"]])
def test_options_the_port_lacks_are_rejected(flags, tmp_path):
    """Options of the JAX command line that would do nothing here."""
    from tpucfn_torch.examples import llama3_8b_fsdp as ex

    with pytest.raises(SystemExit) as e:
        ex.main(["--device", "cpu", "--run-dir", str(tmp_path), *TINY,
                 *flags])
    assert e.value.code == 2  # argparse: unrecognized arguments
    assert not list(tmp_path.iterdir())


def test_eval_every_without_a_held_out_split_is_refused(tmp_path, no_group):
    from tpucfn_torch.examples import llama3_8b_fsdp as ex

    with pytest.raises(SystemExit) as e:
        ex.main(["--device", "cpu", "--run-dir", str(tmp_path), *TINY,
                 "--eval-every", "2"])
    assert isinstance(e.value.code, str) and "held-out" in e.value.code
    assert not (tmp_path / "ckpt").exists()


def test_refused_plane_exits_non_zero_as_a_program(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, str(EXAMPLE), "--device", "cpu",
                        "--run-dir", str(tmp_path / "run"), *TINY,
                        "--profile-server", "9001"],
                       env=env, cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 1
    assert "--profile-server" in r.stderr and "ROADMAP" in r.stderr
    assert not (tmp_path / "run").exists()


def test_a_step_that_will_not_restore_exits_restore_failed(tmp_path,
                                                          no_group):
    from tpucfn_torch.examples import llama3_8b_fsdp as ex
    from tpucfn_torch.ft import RESTORE_FAILED_RC

    argv = ["--device", "cpu", "--run-dir", str(tmp_path), *TINY,
            "--steps", "2"]
    assert ex.main(argv) == 0
    biggest = max((tmp_path / "ckpt" / "2").glob("*.distcp"),
                  key=lambda p: p.stat().st_size)
    biggest.write_bytes(b"")
    with pytest.raises(SystemExit) as e:
        ex.main(argv)
    assert e.value.code == RESTORE_FAILED_RC


def test_the_example_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    from tpucfn_torch.examples import llama3_8b_fsdp as ex

    with pytest.raises(RuntimeError, match="no CUDA device"):
        ex.main(["--run-dir", str(tmp_path), *TINY])
