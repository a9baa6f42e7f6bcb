"""The port's training loop on the fault-tolerance plane, held against the
JAX package's ``tpucfn.ft`` on the CPU.

* Heartbeats: the port's loop, run tiny with ``TPUCFN_FT_DIR``, writes
  heartbeat files that the JAX package's ``HeartbeatMonitor`` reads as
  live at the loop's last step, and ``read_heartbeats`` of both packages
  return the same records.
* Drain: a drain asked for with the JAX package's ``request_drain`` at
  step 3 stops the port's loop at that step boundary, with a force-save
  of step 3 and no step after it.
* Fan-out: ``Launcher.host_env`` of both packages is equal for the same
  contract and options.
"""

import json
from pathlib import Path

import pytest
import torch.distributed as dist

TINY = ["--device", "cpu", "--model", "tiny", "--seq-len", "32",
        "--batch-size", "8", "--num-examples", "64", "--ce-chunk", "16",
        "--log-every", "1"]


@pytest.fixture
def no_group():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _losses(run_dir):
    rows = [json.loads(line) for line in
            (Path(run_dir) / "logs" / "train-host000.jsonl").read_text()
            .splitlines()]
    return {r["step"]: r["loss"] for r in rows if "loss" in r}


def test_heartbeats_read_by_the_reference_monitor(tmp_path, monkeypatch,
                                                  no_group):
    from tpucfn.ft import HeartbeatMonitor, HostState, MonitorConfig
    from tpucfn.ft import read_heartbeats as jax_read
    from tpucfn_torch.examples import llama3_8b_fsdp as ex
    from tpucfn_torch.ft import read_heartbeats

    ft_dir = tmp_path / "ft"
    monkeypatch.setenv("TPUCFN_FT_DIR", str(ft_dir))
    # beats every 10 ms: the final force-save of step 4 (tens of ms)
    # spans several, so the last beat carries step 4
    monkeypatch.setenv("TPUCFN_FT_HEARTBEAT_S", "0.01")
    assert ex.main([*TINY, "--steps", "4", "--run-dir",
                    str(tmp_path / "run")]) == 0
    ours, theirs = read_heartbeats(ft_dir), jax_read(ft_dir)
    assert ours == theirs and set(ours) == {0}
    last = ours[0]
    assert last["step"] == 4 and last["role"] == "trainer"
    steps = [json.loads(line)["step"] for line in
             (ft_dir / "hb-host000.jsonl").read_text().splitlines()]
    seen = [s for s in steps if s is not None]
    assert seen == sorted(seen) and set(seen) <= {1, 2, 3, 4}
    monitor = HeartbeatMonitor(ft_dir, expected_hosts=1,
                               config=MonitorConfig(interval_s=0.01))
    view = monitor.observe(now=last["t"])
    verdict = view.by_host()[0]
    assert verdict.state is HostState.LIVE and verdict.step == 4
    assert view.max_step() == 4
    # and, long after the run, the same files read as dead
    assert monitor.observe(now=last["t"] + 60).by_host()[0].state \
        is HostState.DEAD


def test_reference_drain_stops_the_loop_with_a_force_save(tmp_path, capsys,
                                                          monkeypatch,
                                                          no_group):
    from tpucfn.ft import request_drain
    from tpucfn_torch.examples import llama3_8b_fsdp as ex

    ft_dir, run = tmp_path / "ft", tmp_path / "run"
    monkeypatch.setenv("TPUCFN_FT_DIR", str(ft_dir))
    # the coordinator's targeted drain: every rank stops once it reaches
    # step 3 (a rank at step 3 when the file lands stops at once)
    request_drain(ft_dir, step=3)
    assert ex.main([*TINY, "--steps", "8", "--ckpt-every", "100",
                    "--run-dir", str(run)]) == 0
    out = capsys.readouterr().out
    assert "preemption drain: stopping cleanly at step 3" in out
    assert "final: step=3" in out
    assert sorted(_losses(run)) == [1, 2, 3]
    # the directory's first save and the drain's force-save
    assert sorted(int(p.name) for p in (run / "ckpt").iterdir()
                  if p.name.isdigit()) == [1, 3]


@pytest.mark.parametrize("opts", [
    {},
    {"obs_base_port": 9300, "ft_dir": "/ft", "ft_heartbeat_s": 0.25},
    {"ft_dir": "/ft", "extra_env": {"TPUCFN_CKPT_BLACKLIST": "4"}},
], ids=["plain", "obs_and_ft", "blacklist"])
def test_host_env_equals_the_reference(opts, tmp_path):
    from tpucfn.bootstrap import EnvContract as JaxContract
    from tpucfn.launch import Launcher as JaxLauncher
    from tpucfn.launch import LocalTransport as JaxLocal
    from tpucfn_torch.bootstrap import EnvContract
    from tpucfn_torch.launch import Launcher, LocalTransport

    hostfile = tmp_path / "hostfile"
    hostfile.write_text("10.0.0.1:8471\n10.0.0.2:8471\n")
    fields = dict(workers_path=str(hostfile), workers_count=2,
                  worker_chip_count=1, coordinator="10.0.0.1:8476",
                  host_id=0, storage=str(tmp_path), generation=3)
    ours = Launcher(EnvContract(**fields), LocalTransport(), **opts)
    theirs = JaxLauncher(JaxContract(**fields), JaxLocal(), **opts)
    for host in (0, 1):
        assert ours.host_env(host) == theirs.host_env(host)
    if opts.get("obs_base_port"):
        assert ours.host_env(1)["TPUCFN_OBS_PORT"] == "9302"
