"""``python -m tpucfn_torch.cli`` on the fake control plane: ``create-stack
--accelerator cpu-1``, then ``launch --ft --chaos`` runs the port's Llama
example (``--device cpu``, tiny) under the port's copy of the gang
coordinator, and the run survives each fault the way the JAX package's
drills do:

* ``kill`` at step 3: one unplanned gang restart (budget 1, used), the
  relaunch resumes from a checkpoint, and the losses of all 16 steps equal
  an uninterrupted run's;
* ``preempt_notice`` at step 3: one planned drain (a force-save at the
  drain step, then a relaunch that resumes there), the budget untouched;
* ``corrupt_ckpt`` with a ``kill`` at step 4: the relaunched rank's
  restore fails with ``RESTORE_FAILED_RC`` (77), the coordinator
  blacklists that step and the next relaunch resumes from the previous
  one, with the losses again an uninterrupted run's.

Every launch option whose plane the port lacks (the provisioner policy
loop) exits 2 naming its ROADMAP item; so does ``--backend gcp``.  The
planes ported since (input hosts, compile cache, supervision, chaos
proxies) take their flags, with the JAX package's usage errors.  The steps are sized (tiny
Llama, 16 x 256 tokens, ~0.2 s a step on an idle CPU) and counted (16,
faults at 3 and 4) so that a fault at a heartbeat-reported step lands
well before the run ends, also on a loaded machine, where the heartbeat
and the coordinator's poll fall a few steps behind.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JOB = ["--device", "cpu", "--model", "tiny", "--seq-len", "256",
       "--batch-size", "16", "--num-examples", "64", "--ce-chunk", "64",
       "--log-every", "1", "--steps", "16", "--ckpt-every", "2"]
# Beats every 0.5 s, so a rank is called dead after 3 s of silence: on a
# loaded machine the final save's writer thread starved 0.1 s beats past
# their 0.6 s into a false HANG.
FT = ["--ft", "--ft-restart-budget", "1", "--ft-heartbeat-interval", "0.5",
      "--ft-backoff", "0", "--ft-startup-grace", "120"]


def _cli(state, *argv, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, "-m", "tpucfn_torch.cli", "--state-dir", str(state),
         *argv], env=env, cwd=REPO, capture_output=True, text=True,
        timeout=timeout)


def _losses(run_dir):
    """The last loss logged for each step (a relaunch appends)."""
    out = {}
    for line in (Path(run_dir) / "logs" / "train-host000.jsonl") \
            .read_text().splitlines():
        rec = json.loads(line)
        if "loss" in rec:
            out[rec["step"]] = rec["loss"]
    return out


def _events(state, name):
    path = Path(state) / "clusters" / name / "ft" / "events.jsonl"
    return [json.loads(line) for line in path.read_text().splitlines()]


def _supervisor(state, name):
    return json.loads((Path(state) / "clusters" / name / "ft"
                       / "supervisor.json").read_text())


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    run = tmp_path_factory.mktemp("whole")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run(
        [sys.executable, "-m", "tpucfn_torch.examples.llama3_8b_fsdp", *JOB,
         "--run-dir", str(run)], env=env, cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return _losses(run)


def _drill(tmp_path, name, events):
    state = tmp_path / "state"
    r = _cli(state, "create-stack", "--name", name, "--accelerator", "cpu-1")
    assert r.returncode == 0 and f"CREATE_COMPLETE {name}" in r.stdout
    spec = tmp_path / "chaos.json"
    spec.write_text(json.dumps({"seed": 0, "events": events}))
    run_dir = state / "clusters" / name
    r = _cli(state, "launch", "--name", name, *FT, "--chaos", str(spec),
             "--", sys.executable, "-m",
             "tpucfn_torch.examples.llama3_8b_fsdp", *JOB,
             "--run-dir", str(run_dir), timeout=300)
    return state, run_dir, r


def test_kill_is_recovered_with_the_budget(tmp_path, uninterrupted):
    state, run_dir, r = _drill(tmp_path, "kill",
                               [{"action": "kill", "at_step": 3, "host": 0}])
    assert r.returncode == 0, r.stderr[-3000:]
    assert "launch finished rc=0" in r.stdout
    ev = _events(state, "kill")
    decides = [e for e in ev if e["kind"] == "decide"]
    assert len(decides) == 1 and decides[0]["action"] == "gang_restart"
    assert decides[0]["planned"] is False
    assert [e["failures"][0]["rc"] for e in ev if e["kind"] == "detect"] \
        == [-9]
    assert _supervisor(state, "kill")["budget"]["used"] == 1
    resumed = [int(line.rsplit(" ", 1)[1]) for line in r.stdout.splitlines()
               if line.startswith("resumed from step")]
    assert len(resumed) == 1 and 1 <= resumed[0] < 16
    assert _losses(run_dir) == uninterrupted


def test_preempt_notice_drains_without_budget(tmp_path, uninterrupted):
    state, run_dir, r = _drill(
        tmp_path, "drain",
        [{"action": "preempt_notice", "at_step": 3, "host": 0}])
    assert r.returncode == 0, r.stderr[-3000:]
    ev = _events(state, "drain")
    drains = [e for e in ev if e["kind"] == "drain"]
    assert len(drains) == 1
    recovered = [e for e in ev if e["kind"] == "recovered"]
    assert len(recovered) == 1 and recovered[0]["planned"] is True
    assert _supervisor(state, "drain")["budget"]["used"] == 0
    stopped = [int(line.rsplit(" ", 1)[1]) for line in r.stdout.splitlines()
               if line.startswith("preemption drain: stopping cleanly at")]
    resumed = [int(line.rsplit(" ", 1)[1]) for line in r.stdout.splitlines()
               if line.startswith("resumed from step")]
    # the relaunch resumes from the drain's force-save
    assert len(stopped) == 1 and resumed == stopped
    assert _losses(run_dir) == uninterrupted


def test_corrupt_checkpoint_retries_from_the_previous(tmp_path,
                                                      uninterrupted):
    state, run_dir, r = _drill(
        tmp_path, "corrupt",
        [{"action": "corrupt_ckpt", "at_step": 4},
         {"action": "kill", "at_step": 4, "host": 0}])
    assert r.returncode == 0, r.stderr[-3000:]
    ev = _events(state, "corrupt")
    corrupted = [e for e in ev if e["kind"] == "chaos_ckpt_corrupted"]
    assert len(corrupted) == 1 and corrupted[0]["path"]
    bad = int(Path(corrupted[0]["path"]).relative_to(
        run_dir / "ckpt").parts[0])
    assert 77 in [e["rc"] for e in ev if e["kind"] == "host_exit"] or any(
        f["rc"] == 77 for e in ev if e["kind"] == "detect"
        for f in e["failures"])
    retry = [e for e in ev if e["kind"] == "ckpt_retry"]
    assert len(retry) == 1 and retry[0]["bad_step"] == bad
    assert retry[0]["blacklist"] == [bad] and retry[0]["retry_from"] < bad
    assert "checkpoint restore failed" in r.stdout
    resumed = [int(line.rsplit(" ", 1)[1]) for line in r.stdout.splitlines()
               if line.startswith("resumed from step")]
    assert resumed[-1] == retry[0]["retry_from"]
    # the kill used the budget; the retry did not
    assert _supervisor(state, "corrupt")["budget"]["used"] == 1
    assert _losses(run_dir) == uninterrupted


def test_cluster_commands(tmp_path, capsys):
    from tpucfn_torch.cli import main

    def cli(*argv):
        rc = main(["--state-dir", str(tmp_path), *argv])
        return rc, capsys.readouterr().out

    rc, out = cli("create-stack", "--name", "c1", "--accelerator", "cpu-1")
    assert rc == 0 and "CREATE_COMPLETE c1" in out
    assert cli("status", "--name", "c1") == (
        0, "c1: ACTIVE gen=1\n  host0 10.0.0.1:8471 healthy\n")
    rc, out = cli("env", "--name", "c1")
    assert "export TPUCFN_WORKERS_COUNT='1'" in out
    assert "export TPUCFN_WORKER_CHIP_COUNT='1'" in out
    marker = tmp_path / "host"
    rc, out = cli("launch", "--name", "c1", "--", sys.executable, "-c",
                  "import os; open(%r, 'w').write(os.environ['TPUCFN_HOST_ID'])"
                  % str(marker))
    assert rc == 0 and marker.read_text() == "0"
    assert cli("kill-host", "--name", "c1", "--host", "0")[0] == 0
    assert "DEAD" in cli("status", "--name", "c1")[1]
    rc, out = cli("heal", "--name", "c1")
    assert rc == 0 and "gen=2" in out
    rc, out = cli("delete", "--name", "c1")
    assert rc == 0 and "DELETE_COMPLETE c1" in out
    with pytest.raises(ValueError, match="unknown accelerator"):
        cli("create-stack", "--name", "c2", "--accelerator", "v5e-8")


@pytest.mark.parametrize("flags,item", [
    (["--provision-policy", "goodput"], "B7"),
    (["--provision-interval", "1"], "B7"),
    (["--provision-grow-threshold", "0.3"], "B7"),
    (["--provision-shrink-threshold", "0.1"], "B7"),
    (["--provision-cooldown", "9"], "B7"),
    (["--provision-goodput-dir", "/g"], "B7"),
    (["--defer-input-plane"], "B7"),
], ids=lambda v: v if isinstance(v, str) else v[0])
def test_unported_launch_planes_are_refused(flags, item, tmp_path, capsys):
    from tpucfn_torch.cli import main

    marker = tmp_path / "ran"
    rc = main(["--state-dir", str(tmp_path / "state"), "launch", "--name",
               "x", *flags, "--", sys.executable, "-c",
               f"open({str(marker)!r}, 'w')"])
    assert rc == 2 and not marker.exists()
    err = capsys.readouterr().err
    assert f"ROADMAP Queue 1 {item}" in err and "not ported" in err


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


NET_RST = '{"events": [{"action": "net_rst", "at_s": 60}]}'


# The planes ported since (B2 input service, B4 compile cache, B5
# supervised coordinator, B6 network chaos proxy): each flag is taken,
# with the JAX package's usage errors (rc 2 and its message) where the
# flag alone is not a valid launch.
@pytest.mark.parametrize("flags,outcome", [
    (["--input-hosts", "1"], "leaves no trainer in a 1-host cluster"),
    (["--input-port", "7000"], 0), (["--input-cmd", "serve"], 0),
    (["--ft-restart-input-hosts"], 0),
    (["--compile-cache"], 0), (["--compile-cache-dir", "c"], 0),
    (["--compile-cache-port", "7741"], 0),
    (["--compile-cache-advertise", "h"], 0),
    (["--supervise"], "--supervise needs --ft"),
    (["--supervise-restarts", "2"], 0),
    (["--chaos-proxy", "0:127.0.0.1:7641"], 0),
    (["--chaos-proxy", "7641"], "wants LISTEN:HOST:PORT"),
    (["--ft", "--chaos", NET_RST], "need at least one --chaos-proxy"),
    (["--ft", "--chaos", NET_RST, "--chaos-proxy", "0:127.0.0.1:7641"], 0),
], ids=["--input-hosts", "--input-port", "--input-cmd",
        "--ft-restart-input-hosts", "--compile-cache", "--compile-cache-dir",
        "--compile-cache-port", "--compile-cache-advertise", "--supervise",
        "--supervise-restarts", "--chaos-proxy", "--chaos-proxy-malformed",
        "net_rst-without-a-proxy", "net_rst-with-a-proxy"])
def test_ported_launch_planes_are_accepted(flags, outcome, tmp_path, capsys):
    from tpucfn_torch.cli import main

    state = str(tmp_path / "state")
    assert main(["--state-dir", state, "create-stack", "--name", "pl",
                 "--accelerator", "cpu-1"]) == 0
    if flags == ["--compile-cache"]:
        flags = [*flags, "--compile-cache-port", str(_free_port())]
    env_file = tmp_path / "env.json"
    rc = main(["--state-dir", state, "launch", "--name", "pl", *flags, "--",
               sys.executable, "-c",
               "import json, os; open(%r, 'w').write(json.dumps({k: v for "
               "k, v in os.environ.items() if k.startswith('TPUCFN_')}))"
               % str(env_file)])
    out, err = capsys.readouterr()
    if outcome == 0:
        assert rc == 0 and "launch finished rc=0" in out, err[-2000:]
        env = json.loads(env_file.read_text())
        assert env["TPUCFN_WORKERS_COUNT"] == "1"
        if "--compile-cache" in flags:
            port = flags[flags.index("--compile-cache-port") + 1]
            assert env["TPUCFN_COMPILE_CACHE_ADDRS"] == f"127.0.0.1:{port}"
            assert "compile-artifact server" in err
        else:
            assert "TPUCFN_COMPILE_CACHE_ADDRS" not in env
        if "--chaos-proxy" in flags:
            assert "chaos proxy: :" in err
    else:
        assert rc == 2 and outcome in err and not env_file.exists()
        assert "not ported" not in err


def test_gcp_backend_is_refused(tmp_path, capsys):
    from tpucfn_torch.cli import main

    assert main(["--state-dir", str(tmp_path), "--backend", "gcp",
                 "create-stack", "--name", "x"]) == 2
    assert "fake control plane" in capsys.readouterr().err
    assert not tmp_path.joinpath("control_plane.json").exists()


def test_state_dir_is_not_the_reference_clis(tmp_path, monkeypatch):
    """The JAX package's $TPUCFN_STATE_DIR holds TPU records the port's
    registry cannot load: the port reads its own variable."""
    from tpucfn_torch.cli import build_parser

    monkeypatch.setenv("TPUCFN_STATE_DIR", str(tmp_path / "jax"))
    monkeypatch.delenv("TPUCFN_TORCH_STATE_DIR", raising=False)
    args = build_parser().parse_args(["status", "--name", "x"])
    assert args.state_dir == "~/.tpucfn_torch"
    monkeypatch.setenv("TPUCFN_TORCH_STATE_DIR", str(tmp_path / "torch"))
    args = build_parser().parse_args(["status", "--name", "x"])
    assert args.state_dir == str(tmp_path / "torch")
