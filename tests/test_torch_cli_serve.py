"""The port's ``serve`` and ``obs`` commands on the CPU
(``python -m tpucfn_torch.cli``): the speculative-decoding, router,
admission and SLO flags, exit codes (0 only when every request was
served), the compile-cache env on the CPU, and, in a subprocess, a SIGTERM drain
with ``--obs-port``, ``--trace-dir`` (and ``POST /profile`` through ``obs
profile``) and heartbeats under ``TPUCFN_FT_DIR``, read back by ``obs``.

No tolerance is involved: the checks are counts (requests served,
proposals accepted, exit codes, series present)."""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest
import torch

from tpucfn_torch.cli import main
from tpucfn_torch.ft.heartbeat import heartbeat_path

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
BASE = ["serve", "--preset", "tiny", "--device", "cpu", "--max-batch", "4",
        "--cache-len", "64", "--num-blocks", "48", "--block-size", "8",
        "--prompt-len", "3:12"]


@pytest.fixture
def serve(capsys, monkeypatch):
    """Run ``serve`` in this process: (rc, last stdout JSON, stderr).  The
    SIGTERM handler it installs is put back afterwards."""
    monkeypatch.delenv("TPUCFN_FT_DIR", raising=False)
    monkeypatch.delenv("TPUCFN_OBS_PORT", raising=False)
    monkeypatch.delenv("TPUCFN_COMPILE_CACHE_ADDRS", raising=False)
    prev = signal.getsignal(signal.SIGTERM)

    def run(*flags):
        try:
            rc = main(BASE + list(flags))
        finally:
            signal.signal(signal.SIGTERM, prev)
        out, err = capsys.readouterr()
        lines = out.strip().splitlines()
        return rc, (json.loads(lines[-1]) if lines else None), err

    return run


def test_spec_self_draft_accepts_everything(serve):
    rc, snap, err = serve("--synthetic", "6", "--max-new", "12",
                          "--spec-draft", "self")
    assert rc == 0, err
    assert snap["completed"] == 6 and snap["generated_tokens"] == 72
    assert snap["spec_acceptance_rate"] == 1.0
    assert snap["tokens_per_target_step"] > 1.5


@pytest.mark.parametrize("flags", [
    ("--spec-draft", "nano", "--spec-k", "2", "--no-spec-adaptive"),
    ("--spec-draft", "tiny", "--spec-draft-seed", "9", "--spec-k", "3"),
], ids=["nano-pinned-k", "tiny-other-seed"])
def test_spec_other_drafts_serve_everything(serve, flags):
    rc, snap, err = serve("--synthetic", "6", "--max-new", "10", *flags)
    assert rc == 0, err
    assert snap["completed"] == 6 and snap["generated_tokens"] == 60
    assert snap["spec_proposed"] > 0
    assert snap["spec_accepted"] < snap["spec_proposed"]


def test_replicas_with_one_spec_replica(serve):
    rc, snap, err = serve("--synthetic", "8", "--max-new", "8",
                          "--replicas", "2", "--spec-draft", "self",
                          "--spec-replicas", "0", "--retry-budget", "1",
                          "--hedge-ms", "0", "--slo-ttft", "5",
                          "--slo-tpot", "1", "--slo-objective", "0.9")
    assert rc == 0, err
    router = snap["router"]
    assert router["completed"] == 8 and router["failed"] == 0
    assert [r["spec"] for r in router["replicas"]] == [True, False]


def test_expired_requests_exit_1(serve):
    rc, snap, err = serve("--synthetic", "3", "--max-new", "4",
                          "--deadline-s", "-1")
    assert rc == 1
    assert snap["expired"] == 3 and "served 0/3" in err


def test_queue_cap_rejections_exit_1(serve):
    rc, snap, err = serve("--synthetic", "6", "--max-new", "8",
                          "--max-queued-tokens", "40")
    assert rc == 1
    assert "rejected (429)" in err
    assert 0 < snap["completed"] < 6


@pytest.mark.parametrize("flags,message", [
    (("--replicas", "2", "--spec-draft", "self", "--spec-replicas", "0,2"),
     "--spec-replicas [2] outside 0..1"),
], ids=["spec-replica-out-of-range"])
def test_usage_errors_exit_2(serve, flags, message):
    rc, snap, err = serve("--synthetic", "2", *flags)
    assert rc == 2 and snap is None
    assert message in err


@pytest.mark.parametrize("value", ["1.0", "0", "x"])
def test_slo_objective_outside_0_1_is_a_usage_error(serve, value):
    with pytest.raises(SystemExit) as e:
        serve("--slo-objective", value)
    assert e.value.code == 2


def test_compile_cache_env_leaves_the_cpu_path_alone(serve, monkeypatch):
    """The fleet cache serves kernel libraries; the CPU's plain path
    loads none, so the env changes nothing there and installs nothing."""
    from tpucfn_torch.compilecache import kernels

    monkeypatch.setenv("TPUCFN_COMPILE_CACHE_ADDRS", "127.0.0.1:7741")
    rc, snap, err = serve("--synthetic", "2")
    assert rc == 0 and snap["completed"] == 2, err
    assert kernels.installed() is None


def test_obs_needs_a_run_dir(capsys):
    assert main(["obs"]) == 2
    assert "--run-dir required" in capsys.readouterr().err


def _metrics(url):
    """The text of ``url`` (the printed endpoint is its /metrics), or ""
    while the server does not answer."""
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.read().decode()
    except OSError:
        return ""


def _sample(text, name):
    """The value of the series ``name`` in a Prometheus exposition."""
    for line in text.splitlines():
        if line.startswith(name + "{") or line.startswith(name + " "):
            return float(line.rsplit(" ", 1)[1])
    return None


def test_sigterm_drains_every_accepted_request(tmp_path, capsys):
    """A subprocess serving 2 replicas (replica 0 speculative) gets SIGTERM
    mid-run: every accepted request is served within the grace and the
    exit code is 0.  While it runs, /metrics carries the router_* and
    serve_spec_* series, ``obs profile`` gets a capture from ``POST
    /profile`` and the heartbeats advance; afterwards ``obs``
    reads the request breakdown back from the trace, with the spec split."""
    run = tmp_path / "run"
    ft = tmp_path / "ft"
    env = {**os.environ, "OMP_NUM_THREADS": "1", "TPUCFN_FT_DIR": str(ft),
           "TPUCFN_FT_HEARTBEAT_S": "0.1"}
    env.pop("TPUCFN_OBS_PORT", None)
    env.pop("TPUCFN_COMPILE_CACHE_ADDRS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpucfn_torch.cli", *BASE, "--synthetic", "32",
         "--max-new", "64", "--cache-len", "128", "--num-blocks", "96",
         "--replicas", "2", "--spec-draft", "self",
         "--spec-replicas", "0", "--drain-grace", "120", "--obs-port", "0",
         "--trace-dir", str(run / "trace")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        url = None
        for line in proc.stderr:
            if line.startswith("obs endpoint: "):
                url = line.split(": ", 1)[1].strip()
                break
        assert url, "no obs endpoint line"
        # every request submitted: the drain handler is installed
        deadline = time.monotonic() + 120
        text = ""
        while _sample(text, "router_requests_total") != 32.0:
            assert time.monotonic() < deadline, text
            time.sleep(0.02)
            text = _metrics(url)
        assert _sample(text, "serve_spec_k") == 4.0
        assert _sample(text, "serve_spec_acceptance_rate") is not None
        # POST /profile with requests in flight, through ``obs profile``
        host = url.split("//", 1)[1].split("/", 1)[0]
        assert main(["obs", "profile", "--host", host, "--seconds",
                     "0.5"]) == 0
        capture = json.loads(capsys.readouterr().out)
        assert capture["seconds"] == 0.5
        json.loads((Path(capture["artifact"]) / "trace.json").read_text())
        assert Path(capture["artifact"]).parent == run / "profile"
        beat0 = json.loads(heartbeat_path(ft, 0).read_text().splitlines()[-1])
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert "SIGTERM: draining (grace 120s)" in err
    assert "served 32/32" in err
    snap = json.loads(out.strip().splitlines()[-1])["router"]
    assert snap["completed"] == 32 and snap["failed"] == 0
    beats = [json.loads(line) for line in
             heartbeat_path(ft, 0).read_text().splitlines()]
    assert beats[-1]["seq"] > beat0["seq"]
    assert (ft / "serve" / "events.jsonl").is_file()
    assert (run / "flight").is_dir()

    obs = subprocess.run(
        [sys.executable, "-m", "tpucfn_torch.cli", "obs", "--run-dir",
         str(run), "--json"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120)
    assert obs.returncode == 0, obs.stderr
    report = json.loads(obs.stdout)
    rows = report["requests"]
    assert len(rows) == 32 and all(r["outcome"] == "ok" for r in rows)
    spec_rows = [r for r in rows if r["spec_propose_s"] > 0]
    assert spec_rows and all(r["spec_verify_s"] > 0 for r in spec_rows)
    table = subprocess.run(
        [sys.executable, "-m", "tpucfn_torch.cli", "obs", "--run-dir",
         str(run)], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120)
    assert "== request latency breakdown ==" in table.stdout
    assert "spec_propose_s" in table.stdout
