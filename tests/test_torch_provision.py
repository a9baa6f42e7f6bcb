"""The provisioner policy loop through ``python -m tpucfn_torch.cli launch
--ft --input-hosts 1 --provision-policy goodput`` on the fake control
plane (``h100-2``: a trainer host and an input host; the job never touches
a card), with a toy trainer written into the test's directory.

The toy follows the protocol of the JAX package's
``tests/provision_e2e_worker.py`` on the port's copies (``ft.heartbeat``,
``ft.preempt``, ``obs.goodput``, ``data.service``): it folds
``w <- 0.9 w + mean(batch.x)`` over its batches, accounts each batch wait
and step to its goodput ledger, stops cleanly at a drain boundary, and
resumes its fold from the step it had reached.  Loading locally pays a
sleep per example (the toy's decode); the input host streams the same
batches with no decode.

* **grow**: the input plane deferred, the toy starts starved on local
  loading; the policy grows the plane once (a planned drain and relaunch
  with ``TPUCFN_INPUT_ADDRS``), the ``data_wait`` share falls, and the
  fold equals an uninterrupted run's bit for bit;
* **shrink**: served from the start, the policy finds the fleet
  ``data_rich`` and stops the input host once; the toy's stream degrades
  to local loading at the exact cursor, with no restart, and the fold is
  again equal.
"""

import json
import socket
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from tpucfn_torch.cli import main
from tpucfn_torch.data import ShardedDataset, write_dataset_shards

REPO = Path(__file__).resolve().parent.parent
BATCH, SEED = 8, 7
EXAMPLES, SHARDS = 960, 4
STEPS = EXAMPLES // BATCH  # 120
INIT_S = 0.5  # the toy's model init after it opens its stream
# 64 KB batches: through the input link's bounded buffers (one queued
# batch, 64 KB socket buffers a side) and the prefetcher, the toy holds a
# few batches ahead of its fold, so a shrink mid-run reaches its stream.
EXAMPLE_FLOATS = 2048

TOY = textwrap.dedent('''
    import json, os, socket, sys, time
    from pathlib import Path

    import numpy as np

    from tpucfn_torch.data.pipeline import ShardedDataset
    from tpucfn_torch.data.service import (input_addrs_from_env,
                                           service_or_local_batches)
    from tpucfn_torch.ft.heartbeat import HeartbeatWriter
    from tpucfn_torch.ft.preempt import drain_requested
    from tpucfn_torch.obs.goodput import GoodputLedger


    class SleepDecode:
        """Value-preserving decode cost of local loading (draws nothing
        from the RNG, so the served stream, which skips it, is equal)."""

        def __init__(self, seconds):
            self.seconds = seconds

        def __call__(self, ex, rs):
            time.sleep(self.seconds)
            return ex


    def boot(addrs, deadline_s=60.0):
        """The toy's boot ends when its input hosts accept connections, as
        a real trainer's (model init, kernel libraries) outlasts an input
        host's: the first batch wait is then the stream's, not the boot
        skew's."""
        t_end = time.monotonic() + deadline_s
        for addr in addrs:
            host, port = addr.rsplit(":", 1)
            while True:
                try:
                    socket.create_connection((host, int(port)), 1.0).close()
                    break
                except OSError:
                    if time.monotonic() > t_end:
                        raise
                    time.sleep(0.05)


    def main():
        run_dir, shards = Path(sys.argv[1]), Path(sys.argv[2])
        decode_s, step_s, init_s = map(float, sys.argv[3:6])
        host = int(os.environ["TPUCFN_HOST_ID"])
        trainers = int(os.environ["TPUCFN_WORKERS_COUNT"])
        ft_dir = os.environ["TPUCFN_FT_DIR"]
        boot(input_addrs_from_env())
        hb = HeartbeatWriter(ft_dir, host_id=host, role="trainer",
                             interval_s=float(
                                 os.environ["TPUCFN_FT_HEARTBEAT_S"])).start()
        ledger = GoodputLedger(run_dir / "goodput", host_id=host,
                               role="trainer")
        state = run_dir / f"state-host{host:03d}.json"
        step, w = 0, 10.0
        if state.exists():
            st = json.loads(state.read_text())
            step, w = int(st["step"]), float(st["w"])
        ds = ShardedDataset(sorted(shards.glob("*.tpurec")),
                            batch_size_per_process=%(batch)d, seed=%(seed)d,
                            process_index=host, process_count=trainers,
                            transform=SleepDecode(decode_s))

        def degraded(reason):
            with open(run_dir / f"degraded-host{host:03d}.jsonl", "a") as f:
                f.write(json.dumps({"t": time.time(), "reason": reason})
                        + "\\n")

        stream = service_or_local_batches(ds, num_epochs=1,
                                          on_degrade=degraded)
        # the model's init, while a served stream fetches its first
        # batches, as the port's loop builds its state
        time.sleep(init_s)
        try:
            for _ in range(step):  # the batches folded before a drain
                next(stream)
            with open(run_dir / f"fold-host{host:03d}.jsonl", "a") as f:
                while True:
                    t0 = time.monotonic()
                    b = next(stream, None)
                    wait = time.monotonic() - t0
                    if b is None:
                        break
                    step += 1
                    ledger.account("data_wait", wait, step=step)
                    t0 = time.monotonic()
                    w = 0.9 * w + float(np.mean(b["x"]))
                    f.write(json.dumps({"step": step, "w": w}) + "\\n")
                    f.flush()
                    state.write_text(json.dumps({"step": step, "w": w}))
                    hb.update_step(step)
                    time.sleep(step_s)
                    ledger.account("step", time.monotonic() - t0, step=step)
                    if drain_requested(ft_dir, step):
                        break
        finally:
            close = getattr(stream, "close", None)
            if close is not None:
                close()
            hb.stop()
            ledger.close()


    main()
''') % {"batch": BATCH, "seed": SEED}


def _free_port_pair():
    """A base port B with B + 1 free (the input host, host 1, binds it)."""
    for _ in range(50):
        with socket.socket() as a:
            a.bind(("127.0.0.1", 0))
            port = a.getsockname()[1]
        if port >= 65000:
            continue
        with socket.socket() as b:
            try:
                b.bind(("127.0.0.1", port + 1))
            except OSError:
                continue
        return port - 1
    raise RuntimeError("no free port")


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("shards")
    rs = np.random.RandomState(2)
    write_dataset_shards(
        ({"x": rs.randn(EXAMPLE_FLOATS).astype(np.float32)}
         for _ in range(EXAMPLES)),
        d, num_shards=SHARDS)
    return d


@pytest.fixture(scope="module")
def uninterrupted_fold(shards):
    """The fold of one trainer over every batch, in this process."""
    ds = ShardedDataset(sorted(shards.glob("*.tpurec")),
                        batch_size_per_process=BATCH, seed=SEED,
                        process_index=0, process_count=1)
    w, out = 10.0, []
    for step, b in enumerate(ds.batches(1), 1):
        w = 0.9 * w + float(np.mean(b["x"]))
        out.append(json.dumps({"step": step, "w": w}))
    assert len(out) == STEPS
    return out


def _launch(tmp_path, monkeypatch, shards, *, defer, decode_s, step_s):
    state = tmp_path / "state"
    run_dir = state / "clusters" / "prov"
    toy = tmp_path / "toy.py"
    toy.write_text(TOY)
    assert main(["--state-dir", str(state), "create-stack", "--name", "prov",
                 "--accelerator", "h100-2"]) == 0
    serve = (f"{sys.executable} -m tpucfn_torch.cli data serve --shards "
             f"{shards} --batch-size {BATCH} --seed {SEED} --num-epochs 1 "
             "--host 127.0.0.1 --idle-exit 2 --queue-batches 1 "
             "--sndbuf-kb 64")
    monkeypatch.setenv("PYTHONPATH", str(REPO))
    monkeypatch.delenv("TPUCFN_INPUT_ADDRS", raising=False)
    monkeypatch.setenv("TPUCFN_INPUT_RCVBUF", str(64 * 1024))
    rc = main(["--state-dir", str(state), "launch", "--name", "prov",
               "--ft", "--ft-restart-budget", "0",
               "--ft-heartbeat-interval", "0.2", "--ft-backoff", "0",
               "--input-hosts", "1", "--input-port", str(_free_port_pair()),
               "--input-cmd", serve,
               *(["--defer-input-plane"] if defer else []),
               "--provision-policy", "goodput", "--provision-interval", "0.4",
               "--provision-cooldown", "300", "--",
               sys.executable, str(toy), str(run_dir), str(shards),
               str(decode_s), str(step_s), str(INIT_S)])
    assert rc == 0
    events = [json.loads(line) for line in
              (run_dir / "ft" / "events.jsonl").read_text().splitlines()]
    return run_dir, events


def _phases(run_dir):
    return [r for r in map(json.loads, (run_dir / "goodput"
                                        / "goodput-host000.jsonl")
                           .read_text().splitlines())
            if r["kind"] == "phase"]


def _data_wait_share(recs):
    return (sum(r["dur_s"] for r in recs if r["bucket"] == "data_wait")
            / sum(r["dur_s"] for r in recs))


def _fold(run_dir):
    return (run_dir / "fold-host000.jsonl").read_text().splitlines()


def _degrades(run_dir):
    path = run_dir / "degraded-host000.jsonl"
    return ([json.loads(line) for line in path.read_text().splitlines()]
            if path.exists() else [])


def test_starved_fleet_grows_its_input_plane_once(tmp_path, shards,
                                                  uninterrupted_fold,
                                                  monkeypatch, capsys):
    run_dir, events = _launch(tmp_path, monkeypatch, shards, defer=True,
                              decode_s=0.006, step_s=0.01)
    decisions = [e for e in events if e["kind"] == "provision_decision"]
    assert [(d["action"], d["signal"]) for d in decisions] == [
        ("grow_input_hosts", "data_starved")], decisions
    assert decisions[0]["data_wait_share"] > 0.25
    grown = [e for e in events if e["kind"] == "provision_actuated"]
    assert [e["action"] for e in grown] == ["grow_input_hosts"]
    # one planned drain and relaunch; the restart budget untouched
    assert [e["kind"] for e in events].count("drain") == 1
    assert [e["kind"] for e in events].count("launch") == 2
    sup = json.loads((run_dir / "ft" / "supervisor.json").read_text())
    assert sup["budget"]["used"] == 0
    assert sup["metrics"]["provision_grow_total"] == 1
    assert sup["metrics"].get("provision_shrink_total", 0) == 0
    recs = _phases(run_dir)
    pre = [r for r in recs if r["t"] < grown[0]["ts"]]
    post = [r for r in recs if r["t"] >= grown[0]["ts"]]
    assert pre and post
    assert _data_wait_share(post) < _data_wait_share(pre)
    assert _degrades(run_dir) == []
    assert _fold(run_dir) == uninterrupted_fold
    assert "launch finished rc=0" in capsys.readouterr().out


def test_data_rich_fleet_shrinks_its_input_plane_once(tmp_path, shards,
                                                      uninterrupted_fold,
                                                      monkeypatch, capsys):
    run_dir, events = _launch(tmp_path, monkeypatch, shards, defer=False,
                              decode_s=0.001, step_s=0.04)
    decisions = [e for e in events if e["kind"] == "provision_decision"]
    assert [(d["action"], d["signal"]) for d in decisions] == [
        ("shrink_input_hosts", "data_rich")], decisions
    assert decisions[0]["data_wait_share"] < 0.02
    shrunk = [e for e in events if e["kind"] == "provision_actuated"]
    assert [e["action"] for e in shrunk] == ["shrink_input_hosts"]
    # no restart: one launch, no drain, the budget untouched
    kinds = [e["kind"] for e in events]
    assert kinds.count("launch") == 1 and "drain" not in kinds
    sup = json.loads((run_dir / "ft" / "supervisor.json").read_text())
    assert sup["budget"]["used"] == 0
    assert sup["metrics"]["provision_shrink_total"] == 1
    assert sup["metrics"].get("provision_grow_total", 0) == 0
    # the stream went local once, after the decision, and the toy kept
    # folding after the shrink
    degrades = _degrades(run_dir)
    assert len(degrades) == 1 and degrades[0]["t"] >= decisions[0]["ts"]
    after = [r for r in _phases(run_dir) if r["t"] >= shrunk[0]["ts"]
             and r["bucket"] == "step"]
    assert after
    assert _fold(run_dir) == uninterrupted_fold
    assert "launch finished rc=0" in capsys.readouterr().out
