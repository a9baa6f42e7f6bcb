"""The launch planes of ``python -m tpucfn_torch.cli``: ``--supervise``
re-executes the port's CLI, never the JAX package's; the standalone
planes (``data serve``, ``compilecache serve|gc|stats``, ``chaos
proxy``) run with the reference's flags and print its JSON lines; and,
marked slow, the whole fleet drill on the CPU: ``create-stack
--accelerator h100-2`` then ``launch --ft --supervise --compile-cache
--input-hosts 1 --chaos-proxy`` with a trickle on the input plane and a
coordinator kill, under which the tiny example degrades to local loading
at the exact cursor, the supervisor adopts the fleet with the rank's pid
unchanged, and the losses equal an uninterrupted run's.
"""

import itertools
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from tpucfn.launch.supervise import supervised_cli_argv as jax_argv
from tpucfn_torch.cli import main
from tpucfn_torch.data import ShardedDataset, write_dataset_shards
from tpucfn_torch.launch.supervise import supervised_cli_argv

REPO = Path(__file__).resolve().parent.parent


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("argv", [
    ["--state-dir", "/s", "launch", "--name", "x", "--ft", "--supervise",
     "--supervise-restarts", "5", "--", "python", "job.py"],
    ["launch", "--supervise-restarts=5", "--ft"],
    ["launch", "--ft", "--supervise", "--", "python", "myjob.py",
     "--supervise", "--supervise-restarts", "5"],
], ids=["flags", "equals-form", "user-argv"])
def test_supervised_argv_runs_the_ports_cli(argv):
    out = supervised_cli_argv(argv)
    assert out[:3] == [sys.executable, "-m", "tpucfn_torch.cli"]
    # the rest as the JAX package strips it
    assert out[3:] == jax_argv(argv)[3:]
    assert "tpucfn.cli" not in out


def _job_writes_its_parent(path):
    """A job that records the command line of the process that spawned
    it (the coordinator) and exits 0."""
    return [sys.executable, "-c",
            "import os; open(%r, 'w').write(open('/proc/%%d/cmdline' %% "
            "os.getppid()).read())" % str(path)]


def test_supervise_reexecs_the_ports_coordinator(tmp_path, capsys):
    state = tmp_path / "state"
    assert main(["--state-dir", str(state), "create-stack", "--name", "sv",
                 "--accelerator", "cpu-1"]) == 0
    parent = tmp_path / "parent"
    rc = main(["--state-dir", str(state), "launch", "--name", "sv", "--ft",
               "--supervise", "--supervise-restarts", "1",
               "--ft-heartbeat-interval", "0.5", "--",
               *_job_writes_its_parent(parent)])
    out, err = capsys.readouterr()
    assert rc == 0 and "launch finished rc=0" in out, err[-2000:]
    assert "supervising coordinator (up to 1 restart(s)" in err
    cmdline = parent.read_text().split("\0")
    assert cmdline[1:3] == ["-m", "tpucfn_torch.cli"]
    assert "launch" in cmdline and "--supervise" not in cmdline
    events = [json.loads(line)["kind"] for line in
              (state / "clusters" / "sv" / "ft" / "events.jsonl")
              .read_text().splitlines()]
    assert events[0] == "launch" and events[-1] == "done"


# ---- the standalone planes ---------------------------------------------------

def _in_thread(argv, capsys, *, until):
    """``main(argv)`` on a thread (no SIGTERM hook off the main thread);
    ``until()`` runs meanwhile; returns (rc, the last stdout JSON line)."""
    box = {}
    t = threading.Thread(target=lambda: box.setdefault("rc", main(argv)))
    t.start()
    try:
        until()
    finally:
        t.join(timeout=60)
    assert not t.is_alive()
    out = capsys.readouterr().out.strip().splitlines()
    return box["rc"], json.loads(out[-1])


def _retry(connect, timeout=20.0):
    """``connect()`` again until the server on the thread listens."""
    end = time.monotonic() + timeout
    while True:
        try:
            return connect()
        except (OSError, RuntimeError):  # RuntimeError: ServiceError
            if time.monotonic() > end:
                raise
            time.sleep(0.05)


def test_data_serve_streams_the_local_batches(tmp_path, capsys):
    from tpucfn_torch.data.service import ServiceBatchStream

    rs = np.random.RandomState(0)
    write_dataset_shards(({"x": rs.randn(8).astype(np.float32)}
                          for _ in range(64)), tmp_path / "d", num_shards=4)
    port = _free_port()
    got = []

    def read():
        stream = _retry(lambda: ServiceBatchStream(
            f"127.0.0.1:{port}", 1, process_count=2, batch_size=4, seed=7))
        got.extend(itertools.islice(stream, 6))
        stream.close()

    rc, line = _in_thread(
        ["data", "serve", "--shards", str(tmp_path / "d"), "--batch-size",
         "4", "--num-trainers", "2", "--seed", "7", "--host", "127.0.0.1",
         "--port", str(port), "--idle-exit", "0.3"], capsys, until=read)
    assert rc == 0 and line["connections"] == 1
    assert line["batches_streamed"] >= 6
    ds = ShardedDataset(sorted((tmp_path / "d").glob("*.tpurec")),
                        batch_size_per_process=4, seed=7, process_index=1,
                        process_count=2)
    for a, b in zip(got, itertools.islice(ds.batches(None), 6)):
        np.testing.assert_array_equal(a["x"], b["x"])
    assert len(got) == 6


def test_data_serve_needs_shards_and_a_trainer_count(tmp_path, capsys,
                                                     monkeypatch):
    monkeypatch.delenv("TPUCFN_WORKERS_COUNT", raising=False)
    assert main(["data", "serve", "--shards", str(tmp_path),
                 "--batch-size", "4"]) == 2
    assert "no *.tpurec shards" in capsys.readouterr().err
    write_dataset_shards(({"x": np.zeros(2, np.float32)} for _ in range(8)),
                         tmp_path, num_shards=2)
    assert main(["data", "serve", "--shards", str(tmp_path),
                 "--batch-size", "4"]) == 2
    assert "--num-trainers required" in capsys.readouterr().err


def test_compilecache_serve_stats_and_gc(tmp_path, capsys):
    from tpucfn_torch.compilecache.service import ArtifactClient

    port = _free_port()
    stats = {}

    def use():
        c = ArtifactClient(f"127.0.0.1:{port}", device_kind="card",
                           jax_version="tools")
        _retry(lambda: c.put("cd" * 32, b"\x7fELF lib",
                             {"label": "flash_bwd"}))
        assert c.get("cd" * 32)[0] == b"\x7fELF lib"
        assert main(["compilecache", "stats", "--addr",
                     f"127.0.0.1:{port}"]) == 0
        stats.update(json.loads(capsys.readouterr().out.splitlines()[-1]))

    rc, line = _in_thread(
        ["compilecache", "serve", "--dir", str(tmp_path / "s"), "--host",
         "127.0.0.1", "--port", str(port), "--toolchain", "tools",
         "--serve-for", "1.5"], capsys, until=use)
    assert rc == 0 and line["entries"] == 1 and line["publishes"] == 1
    assert line["hits"] == 1
    assert stats["entries"] == 1 and stats["jax_version"] == "tools"
    assert main(["compilecache", "gc", "--dir", str(tmp_path / "s"),
                 "--max-bytes", "0"]) == 0
    gc = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert gc["max_bytes"] == 0 and gc["evicted"] == 1
    assert main(["compilecache", "gc", "--dir", str(tmp_path / "s"),
                 "--max-bytes", "lots"]) == 2
    assert main(["compilecache", "stats", "--addr",
                 f"127.0.0.1:{_free_port()}"]) == 1


def test_chaos_proxy_forwards_and_fires_its_schedule(tmp_path, capsys):
    upstream = socket.socket()
    upstream.bind(("127.0.0.1", 0))
    upstream.listen(1)
    port = _free_port()
    echoed = []

    def talk():
        with _retry(lambda: socket.create_connection(("127.0.0.1", port))) \
                as c:
            peer = upstream.accept()[0]
            c.sendall(b"hello")
            echoed.append(peer.recv(5))
            peer.close()

    spec = json.dumps({"seed": 3, "faults": [
        {"kind": "latency", "at_s": 0.0, "delay_s": 0.01,
         "duration_s": 60}]})
    rc, line = _in_thread(
        ["chaos", "proxy", "--listen", str(port), "--host", "127.0.0.1",
         "--upstream", "127.0.0.1:%d" % upstream.getsockname()[1], "--spec",
         spec, "--serve-for", "1.0"], capsys, until=talk)
    upstream.close()
    assert rc == 0 and echoed == [b"hello"]
    assert line["connections"] == 1 and line["faults_fired"] == 1
    assert [f["kind"] for f in line["fired"]] == ["latency"]
    assert main(["chaos", "proxy", "--upstream", "nowhere"]) == 2


# ---- the fleet drill (subprocesses) ------------------------------------------

DRILL_JOB = ["--device", "cpu", "--model", "tiny", "--seq-len", "512",
             "--batch-size", "8", "--num-examples", "64", "--ce-chunk", "128",
             "--log-every", "1", "--ckpt-every", "1000", "--steps", "24"]
THROTTLE_AT, KILL_AT = 3, 18


def _cli(state, *argv, env=None, timeout=300):
    e = dict(os.environ, PYTHONPATH=str(REPO), **(env or {}))
    return subprocess.run(
        [sys.executable, "-m", "tpucfn_torch.cli", "--state-dir", str(state),
         *argv], env=e, cwd=REPO, capture_output=True, text=True,
        timeout=timeout)


@pytest.mark.slow
def test_fleet_drill_trickle_then_coordinator_kill(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    whole = tmp_path / "whole"
    r = subprocess.run([sys.executable, "-m",
                        "tpucfn_torch.examples.llama3_8b_fsdp", *DRILL_JOB,
                        "--run-dir", str(whole)], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    state = tmp_path / "state"
    run = state / "clusters" / "fleet"
    assert _cli(state, "create-stack", "--name", "fleet", "--accelerator",
                "h100-2").returncode == 0
    run.mkdir(parents=True, exist_ok=True)
    (run / "data").symlink_to(whole / "data")
    cc_port, in_port, px_port = _free_port(), _free_port(), _free_port()
    consume = 8 * 512 * 4 / 0.3  # bytes a second at ~0.3 s a step
    spec = {"seed": 0, "events": [
        # the link paced at ~1.5x what the trainer consumes, so the
        # socket buffers hold seconds of batches, not the whole run
        {"action": "net_throttle", "at_s": 0, "rate_bps": 1.5 * consume,
         "duration_s": 600},
        {"action": "net_throttle", "at_step": THROTTLE_AT, "rate_bps": 64,
         "duration_s": 600},
        {"action": "kill_coordinator", "at_step": KILL_AT}]}
    r = _cli(state, "launch", "--name", "fleet", "--ft", "--supervise",
             "--ft-heartbeat-interval", "0.5", "--ft-backoff", "0",
             "--compile-cache", "--compile-cache-port", str(cc_port),
             "--input-hosts", "1", "--input-port", str(in_port - 1),
             "--input-cmd",
             f"{sys.executable} -m tpucfn_torch.cli data serve --shards "
             f"{run / 'data'} --batch-size 8 --host 127.0.0.1 --idle-exit 2 "
             "--queue-batches 1 --sndbuf-kb 64",
             "--chaos-proxy", f"{px_port}:127.0.0.1:{in_port}",
             "--chaos", json.dumps(spec), "--",
             "env", f"TPUCFN_INPUT_ADDRS=127.0.0.1:{px_port}",
             "TPUCFN_INPUT_OP_DEADLINE_S=2", "TPUCFN_INPUT_RCVBUF=65536",
             sys.executable, "-m", "tpucfn_torch.examples.llama3_8b_fsdp",
             *DRILL_JOB, "--run-dir", str(run), timeout=600)
    assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-3000:])
    assert "compile-artifact server" in r.stderr
    rows = [json.loads(line) for line in
            (run / "logs" / "train-host000.jsonl").read_text().splitlines()]
    ev = [json.loads(line) for line in
          (run / "ft" / "events.jsonl").read_text().splitlines()]
    kinds = [e["kind"] for e in ev]
    # one launch, the coordinator killed, restarted by the supervisor and
    # adopting the running rank: no gang restart, no budget spent
    assert kinds.count("launch") == 1 and "decide" not in kinds, kinds
    assert ["coordinator_killed", "coordinator_restarted",
            "coordinator_adopted"] == [k for k in kinds
                                       if k.startswith("coordinator_")]
    adopted = next(e for e in ev if e["kind"] == "coordinator_adopted")
    assert adopted["budget_used"] == 0
    beats = [json.loads(line) for line in
             (run / "ft" / "hb-host000.jsonl").read_text().splitlines()]
    assert len({b["pid"] for b in beats}) == 1
    # served, then the trickle, then local loading from the exact cursor
    faults = [e for e in ev if e["kind"] == "chaos_net_fault"]
    degraded = [r for r in rows if "input_degraded_cursor" in r]
    assert len(faults) == 2 and len(degraded) == 1, (faults, degraded)
    latency = degraded[0]["input_degraded_wall"] - faults[1]["ts"]
    killed = next(e for e in ev if e["kind"] == "coordinator_killed")
    assert 0 < latency <= 10.0, latency
    assert degraded[0]["input_degraded_wall"] < killed["ts"]
    assert degraded[0]["input_degraded_cursor"] >= THROTTLE_AT
    losses = {r["step"]: r["loss"] for r in rows if "loss" in r}
    want = {r["step"]: r["loss"] for r in map(json.loads, (
        whole / "logs" / "train-host000.jsonl").read_text().splitlines())
            if "loss" in r}
    assert losses == want
