"""The port's RL actor and loop (``tpucfn_torch/rl/actor.py``,
``rl/loop.py``), its entry points and its fleet drills, on the CPU:

* the rollout's shapes, and a replay from the same generator state;
* the loop's determinism contract, as ``tests/test_rl.py`` pins the JAX
  package's: same seed ⇒ bit-identical rows, a run interrupted at 4 and
  resumed equals the uninterrupted one (queue counters restored mid
  stream), another seed differs.  The JAX package marks these slow for
  their jit; here each run takes a second or two;
* ``RLObs`` (a copy of the JAX package's) charging iteration 1 to
  ``compile``;
* ``python -m tpucfn_torch.cli rl train --device cpu`` and
  ``tpucfn_torch/examples/anakin_rl.py --device cpu`` end to end;
* two gloo ranks: the data-parallel update over the halves of a slab
  equals one process's update over the whole slab (within 1e-6), and a
  2-rank loop (4 envs a rank) resumed at 3 of 6 replays its rows;
* ``create-stack --accelerator cpu-1`` + ``launch --ft --chaos``: a
  kill of the rank mid-run, one gang restart, a resume from a multiple
  of the checkpoint interval, rows 1-30 equal to an uninterrupted run,
  and the goodput buckets ``act``/``learn``/``refresh`` > 0 summing to
  wall.

The random draws are the port's own (torch generators seeded from
``(seed, i)``), not JAX's threefry draws, so rows are compared run
against run of the port, never against the JAX package's numbers.
"""

import argparse
import json
import os
import random
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from tpucfn_torch.rl import (Actor, RLConfig, RLLearner, RLObs, make_env,
                             run_rl_loop)
from tpucfn_torch.rl.loop import ActorPlacement, fold_in

REPO = Path(__file__).resolve().parent.parent


def _gen(seed):
    return torch.Generator(device="cpu").manual_seed(seed)


def _rows(run_dir, host=0):
    """Per-iteration rows; a resumed re-execution wins on overlap."""
    out = {}
    path = Path(run_dir) / f"rl-host{host:03d}.jsonl"
    for line in path.read_text().splitlines():
        r = json.loads(line)
        out[r["iter"]] = r
    return out


def _traj(rows):
    return {i: tuple(r[k] for k in ("loss", "reward_mean", "entropy",
                                    "pushed", "popped"))
            for i, r in rows.items()}


def _cfg(run_dir, **kw):
    kw = {"iters": 5, "ckpt_every": 100, "log_every": 100, "fresh": True,
          "device": "cpu", **kw}
    return RLConfig(run_dir=str(run_dir), **kw)


# -- actor ------------------------------------------------------------------


@pytest.mark.parametrize("name", ["bandit", "gridworld"])
def test_rollout_shapes_and_replay(name):
    env = make_env(name, num_envs=8, device="cpu")
    learner = RLLearner(None, env)
    actor = Actor(env, learner.apply_fn, unroll=5)
    params = learner.refresh(learner.init(0))
    es, obs = actor.reset(_gen(1))
    es1, obs1, traj1 = actor.rollout(params, es, obs, _gen(2))
    assert traj1["obs"].shape == (8, 5, env.obs_dim)
    assert traj1["action"].shape == traj1["reward"].shape == (8, 5)
    assert traj1["done"].shape == traj1["value"].shape == (8, 5)
    assert traj1["bootstrap"].shape == (8,)
    assert traj1["action"].dtype == torch.int64
    assert int(traj1["action"].max()) < env.num_actions
    assert actor.steps_per_rollout == 40
    # the slab's first obs is the obs it was given; its next one, returned
    assert torch.equal(traj1["obs"][:, 0], obs)
    # a function of (params, env_state, obs, generator state)
    _, obs2, traj2 = actor.rollout(params, es, obs, _gen(2))
    assert all(torch.equal(traj1[k], traj2[k]) for k in traj1)
    assert torch.equal(obs1, obs2)
    _, _, traj3 = actor.rollout(params, es, obs, _gen(3))
    assert not torch.equal(traj1["action"], traj3["action"])


def test_unroll_must_be_positive():
    env = make_env("bandit", 2, device="cpu")
    with pytest.raises(ValueError, match="unroll must be >= 1"):
        Actor(env, None, unroll=0)


def test_fold_in_streams_are_distinct_and_fixed():
    seeds = {fold_in(s, i) for s in range(4) for i in range(64)}
    assert len(seeds) == 256 and all(0 <= s < 2 ** 63 for s in seeds)
    assert fold_in(0, 2) == fold_in(0, 2) != fold_in(1, 2)


def test_placement_shards_only_when_the_world_divides():
    assert ActorPlacement(1, 0, 8).local_envs == 8
    two = ActorPlacement(2, 1, 8)
    assert two.sharded and two.local_envs == 4
    assert two.stream(0, 5) != ActorPlacement(2, 0, 8).stream(0, 5)
    three = ActorPlacement(3, 2, 8)  # 3 does not divide 8: replicated
    assert not three.sharded and three.local_envs == 8
    assert three.stream(0, 5) == ActorPlacement(3, 0, 8).stream(0, 5)
    t = torch.arange(8)
    assert torch.equal(two.local(t), torch.tensor([4, 5, 6, 7]))


# -- loop determinism -------------------------------------------------------


def test_loop_same_seed_bit_identical(tmp_path):
    a = run_rl_loop(_cfg(tmp_path / "a"))
    b = run_rl_loop(_cfg(tmp_path / "b"))
    assert _traj(_rows(tmp_path / "a")) == _traj(_rows(tmp_path / "b"))
    assert a["loss"] == b["loss"] and a["reward_mean"] == b["reward_mean"]


@pytest.mark.parametrize("env", ["bandit", "gridworld"])
def test_loop_resume_bit_identical(tmp_path, env):
    """Interrupt at iteration 4, resume, finish: every row matches the
    uninterrupted reference bit for bit."""
    ref, res = tmp_path / "ref", tmp_path / "res"
    run_rl_loop(_cfg(ref, env=env, iters=8, ckpt_every=2))
    run_rl_loop(_cfg(res, env=env, iters=8, ckpt_every=2, stop_after=4))
    out = run_rl_loop(_cfg(res, env=env, iters=8, ckpt_every=2,
                           fresh=False))
    assert out["iter"] == 8
    rref, rres = _rows(ref), _rows(res)
    assert set(rref) == set(rres) == set(range(1, 9))
    assert _traj(rref) == _traj(rres)
    # queue sequence counters restored mid-stream, not reset
    last = json.loads((res / "rl-host000.jsonl").read_text()
                      .splitlines()[-1])
    assert last["pushed"] == last["popped"] == 8


def test_loop_different_seed_differs(tmp_path):
    run_rl_loop(_cfg(tmp_path / "a", iters=3, seed=0))
    run_rl_loop(_cfg(tmp_path / "b", iters=3, seed=1))
    assert _traj(_rows(tmp_path / "a")) != _traj(_rows(tmp_path / "b"))


def test_corrupt_checkpoint_exits_restore_failed(tmp_path):
    from tpucfn_torch.ft import RESTORE_FAILED_RC, corrupt_latest_checkpoint

    run_rl_loop(_cfg(tmp_path, iters=4, ckpt_every=2))
    assert corrupt_latest_checkpoint(tmp_path / "ckpt", random.Random(0))
    with pytest.raises(SystemExit) as e:
        run_rl_loop(_cfg(tmp_path, iters=6, ckpt_every=2, fresh=False))
    assert e.value.code == RESTORE_FAILED_RC


# -- obs glue ---------------------------------------------------------------


def test_rlobs_first_iter_charged_to_compile():
    from tpucfn_torch.obs.registry import MetricRegistry

    class FakeLedger:
        def __init__(self):
            self.rows = []

        def account(self, bucket, dur_s, step=None):
            self.rows.append((bucket, step))

    clock = [0.0]

    def tick():
        clock[0] += 1.0
        return clock[0]

    led = FakeLedger()
    obs = RLObs(MetricRegistry(), ledger=led, clock=tick)
    with obs.act(1):
        pass
    with obs.learn(1):
        pass
    with obs.refresh(1):
        pass
    obs.iteration_done(1, 128)
    with obs.act(2):
        pass
    with obs.learn(2):
        pass
    buckets = [b for b, _ in led.rows]
    assert buckets == ["compile", "compile", "compile", "act", "learn"]
    assert obs.env_steps_total.value == 128


# -- entry points -----------------------------------------------------------


def _run(argv, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-m", *argv], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)


def test_cli_rl_train_on_the_cpu(tmp_path):
    r = _run(["tpucfn_torch.cli", "rl", "train", "--device", "cpu",
              "--env", "gridworld", "--unroll", "4", "--iters", "6",
              "--ckpt-every", "3", "--log-every", "3", "--run-dir",
              str(tmp_path)])
    assert r.returncode == 0, r.stderr[-3000:]
    assert "iter=6 " in r.stdout and "final: step=6" in r.stdout
    rows = _rows(tmp_path)
    assert sorted(rows) == list(range(1, 7))
    assert all(np.isfinite(v["loss"]) for v in rows.values())
    assert sorted(int(p.name) for p in (tmp_path / "ckpt").iterdir()
                  if p.name.isdigit())[-1] == 6
    # the same run in this process gives the same rows
    run_rl_loop(_cfg(tmp_path / "again", env="gridworld", unroll=4, iters=6))
    assert _traj(_rows(tmp_path / "again")) == _traj(rows)
    # a rerun resumes from the last save
    r = _run(["tpucfn_torch.cli", "rl", "train", "--device", "cpu",
              "--env", "gridworld", "--unroll", "4", "--iters", "8",
              "--run-dir", str(tmp_path)])
    assert r.returncode == 0 and "rl resumed from iteration 6" in r.stdout


def test_anakin_example_on_the_cpu(tmp_path):
    r = _run(["tpucfn_torch.examples.anakin_rl", "--device", "cpu",
              "--steps", "5", "--log-every", "5", "--run-dir",
              str(tmp_path)])
    assert r.returncode == 0, r.stderr[-3000:]
    assert "final: step=5" in r.stdout
    assert sorted(_rows(tmp_path)) == list(range(1, 6))


def _rl_train_flags(parser):
    """``rl train``'s flags and their defaults, from a CLI's parser."""
    def sub(p):
        return next(a for a in p._actions
                    if isinstance(a, argparse._SubParsersAction))

    train = sub(sub(parser).choices["rl"]).choices["train"]
    return {s: a.default for a in train._actions for s in a.option_strings
            if s != "-h"}


def test_rl_train_takes_the_references_flags():
    from tpucfn.cli.main import build_parser as jax_build_parser
    from tpucfn_torch.cli import build_parser

    ours, theirs = (_rl_train_flags(build_parser()),
                    _rl_train_flags(jax_build_parser()))
    assert ours.pop("--device") == "cuda"
    assert ours == theirs


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    from tpucfn_torch.cli import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["rl", "train", "--iters", "1", "--run-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_rl_loop(RLConfig(run_dir=str(tmp_path), iters=1))


# -- two gloo ranks ---------------------------------------------------------

RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from tpucfn_torch.mesh import MeshSpec, build_mesh
    from tpucfn_torch.rl import RLConfig, RLLearner, make_env, run_rl_loop

    torch.set_num_threads(1)
    rank, port, data, out = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                             sys.argv[4])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    ref = np.load(data)
    mesh = build_mesh(MeshSpec.for_devices(2), device_type="cpu")
    learner = RLLearner(mesh, make_env("gridworld", 4, device="cpu"),
                        hidden=16, lr=3e-2)
    # rank 1 inits from another seed: the broadcast makes them equal
    state = learner.init(0 if rank == 0 else 5)
    losses = []
    for i in range(3):
        half = {k[len(f"slab{i}/"):]: torch.from_numpy(v[rank * 4:
                                                          (rank + 1) * 4])
                for k, v in ref.items() if k.startswith(f"slab{i}/")}
        state, m = learner.step(state, half)
        losses.append(m["loss"].item())
    np.savez(out, losses=np.array(losses),
             **{k: p.detach().numpy() for k, p in state.params.items()})
    run_dir = sys.argv[5]
    kw = dict(env="gridworld", unroll=4, iters=6, ckpt_every=2,
              log_every=100, device="cpu")
    run_rl_loop(RLConfig(run_dir=run_dir + "/whole", fresh=True, **kw))
    run_rl_loop(RLConfig(run_dir=run_dir + "/res", fresh=True,
                         stop_after=3, **kw))
    run_rl_loop(RLConfig(run_dir=run_dir + "/res", **kw))
    dist.destroy_process_group()
""")


def _store_ports():
    """Candidate ports for the gloo store, below the kernel's ephemeral
    range and in a slice per xdist worker (another test's ``bind(0)``
    never draws them)."""
    worker = os.environ.get("PYTEST_XDIST_WORKER", "gw0")
    index = int(worker[2:]) if worker[2:].isdigit() else 0
    lo, width = 10000 + 600 * (index % 15), 600
    start = os.getpid() % width
    for i in range(width):
        port = lo + (start + i) % width
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        yield port


def test_two_gloo_ranks_equal_one_process(tmp_path):
    rs = np.random.RandomState(0)
    slabs = {}
    for i in range(3):
        done = rs.rand(8, 6) < 0.25
        slabs.update({f"slab{i}/obs": rs.randn(8, 6, 4).astype(np.float32),
                      f"slab{i}/action": rs.randint(0, 4, (8, 6)),
                      f"slab{i}/reward": rs.randn(8, 6).astype(np.float32),
                      f"slab{i}/done": done,
                      f"slab{i}/bootstrap": rs.randn(8).astype(np.float32)})
    np.savez(tmp_path / "slabs.npz", **slabs)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    port = next(_store_ports())
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(rank), str(port),
         str(tmp_path / "slabs.npz"), str(tmp_path / f"r{rank}.npz"),
         str(tmp_path / "loop")], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
    # one process over the whole slabs, from rank 0's init
    learner = RLLearner(None, make_env("gridworld", 8, device="cpu"),
                        hidden=16, lr=3e-2)
    state = learner.init(0)
    losses = []
    for i in range(3):
        slab = {k[len(f"slab{i}/"):]: torch.from_numpy(v)
                for k, v in slabs.items() if k.startswith(f"slab{i}/")}
        state, m = learner.step(state, slab)
        losses.append(m["loss"].item())
    for rank in range(2):
        got = np.load(tmp_path / f"r{rank}.npz")
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-6)
        for k, p in state.params.items():
            np.testing.assert_allclose(got[k], p.detach().numpy(),
                                       rtol=1e-6, atol=1e-7)
    # the 2-rank loop: both ranks' rows carry the same mean loss, and the
    # run resumed at 3 replays the uninterrupted one on each rank
    loop = tmp_path / "loop"
    for host in range(2):
        assert _traj(_rows(loop / "res", host)) == \
            _traj(_rows(loop / "whole", host))
        assert sorted(_rows(loop / "res", host)) == list(range(1, 7))
    assert _traj(_rows(loop / "whole", 0)) == _traj(_rows(loop / "whole", 1))


# -- the launch drill -------------------------------------------------------

DRILL_ITERS, DRILL_CKPT_EVERY, DRILL_KILL_AT = 30, 5, 12
DRILL_JOB = ["--device", "cpu", "--env", "gridworld", "--unroll", "8",
             "--iters", str(DRILL_ITERS), "--ckpt-every",
             str(DRILL_CKPT_EVERY), "--iter-sleep-s", "0.1",
             "--log-every", "1000"]


def _cli(state, *argv, timeout=180):
    return _run(["tpucfn_torch.cli", "--state-dir", str(state), *argv],
                timeout=timeout)


def test_chaos_kill_resumes_bit_identical(tmp_path):
    """The reference's RL chaos drill (``tests/test_rl_e2e.py``) through
    the port's CLI: a kill at iteration 12 (heartbeat-reported, so it
    lands a few iterations later), one gang restart, the resume from a
    save at a multiple of 5, every row equal to an uninterrupted run."""
    from tpucfn_torch.obs.goodput import goodput_report

    state, name = tmp_path / "state", "rl"
    r = _cli(state, "create-stack", "--name", name, "--accelerator", "cpu-1")
    assert r.returncode == 0 and f"CREATE_COMPLETE {name}" in r.stdout
    spec = tmp_path / "chaos.json"
    spec.write_text(json.dumps({"seed": 0, "events": [
        {"action": "kill", "at_step": DRILL_KILL_AT, "host": 0}]}))
    run_dir = state / "clusters" / name
    r = _cli(state, "launch", "--name", name, "--ft",
             "--ft-restart-budget", "1", "--ft-heartbeat-interval", "0.5",
             "--ft-backoff", "0", "--ft-startup-grace", "120", "--chaos",
             str(spec), "--", sys.executable, "-m", "tpucfn_torch.cli", "rl",
             "train", *DRILL_JOB, "--run-dir", str(run_dir))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "launch finished rc=0" in r.stdout
    events = [json.loads(s) for s in
              (run_dir / "ft" / "events.jsonl").read_text().splitlines()]
    kinds = [e["kind"] for e in events]
    for k in ("rl_run_start", "detect", "rl_resumed", "done"):
        assert k in kinds, kinds
    decides = [e for e in events if e["kind"] == "decide"]
    assert [(d["action"], d["planned"]) for d in decides] == [
        ("gang_restart", False)]
    resumed = next(e for e in events if e["kind"] == "rl_resumed")
    assert resumed["ckpt_step"] >= DRILL_CKPT_EVERY
    assert resumed["ckpt_step"] % DRILL_CKPT_EVERY == 0
    assert resumed["iteration"] == resumed["ckpt_step"]
    rows = _rows(run_dir)
    assert len({r["pid"] for r in rows.values()}) == 2
    run_rl_loop(RLConfig(run_dir=str(tmp_path / "whole"), env="gridworld",
                         unroll=8, iters=DRILL_ITERS,
                         ckpt_every=DRILL_CKPT_EVERY, device="cpu",
                         log_every=1000))
    ref = _rows(tmp_path / "whole")
    assert set(rows) == set(ref) == set(range(1, DRILL_ITERS + 1))
    assert _traj(rows) == _traj(ref)
    rep = goodput_report(run_dir / "goodput",
                         ft_events_path=run_dir / "ft" / "events.jsonl")
    b = rep["buckets"]
    for k in ("act", "learn", "refresh"):
        assert b[k] > 0, (k, b)
    assert abs(sum(b.values()) - rep["wall_s"]) <= 0.05 * rep["wall_s"]
