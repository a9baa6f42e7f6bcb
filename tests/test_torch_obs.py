"""The port's obs plane (server, flight recorder, profiler, device gauges)
held against the JAX package's ``tpucfn.obs`` on the CPU.

* ``ProfileCapture`` with an injected capture behaves as the JAX
  package's: out-of-range seconds raise ``ValueError``, an overlapping
  capture raises ``ProfilerBusy``, which the port's server answers 409.
* A real ``torch.profiler`` capture asked for over HTTP while a loop runs
  steps on another thread writes a Chrome trace holding that loop's ops;
  with no loop attached it fails at once, and on a loop that reaches no
  step boundary it fails within its deadline and frees the next capture.
* A live rank of the port's example serves ``/healthz`` with its step,
  ``/metrics`` with the step gauge and the kernels' launch counters,
  ``/flightrecorder`` and ``POST /profile``.
* On the CPU, ``sample_device`` and ``register_device_gauges`` are
  no-ops, as in the JAX package.
* A flight dump the port writes is read by the JAX package's
  ``read_flight_file``, and ``hbm_watermark`` gives the same verdict on
  the same samples in both packages.
"""

import json
import math
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


def _packages():
    import tpucfn.obs.profiler as jax_profiler

    import tpucfn_torch.obs.profiler as profiler

    return {"port": profiler, "reference": jax_profiler}


@pytest.mark.parametrize("side", ["port", "reference"])
@pytest.mark.parametrize("seconds", [0.0, -1.0, float("nan"), 601.0])
def test_capture_rejects_out_of_range_seconds(side, seconds, tmp_path):
    mod = _packages()[side]
    calls = []
    pc = mod.ProfileCapture(tmp_path, capture_fn=lambda d, s: calls.append(s))
    with pytest.raises(ValueError):
        pc(seconds)
    assert not calls and not list(tmp_path.iterdir())


@pytest.mark.parametrize("side", ["port", "reference"])
def test_overlapping_capture_is_busy(side, tmp_path):
    mod = _packages()[side]
    started, release = threading.Event(), threading.Event()

    def slow_capture(d, s):
        started.set()
        release.wait(5)

    pc = mod.ProfileCapture(tmp_path, capture_fn=slow_capture)
    results = {}
    t = threading.Thread(target=lambda: results.setdefault("first", pc(1.0)))
    t.start()
    assert started.wait(5)
    with pytest.raises(mod.ProfilerBusy):
        pc(1.0)
    release.set()
    t.join(5)
    assert results["first"]["seconds"] == 1.0
    assert Path(results["first"]["artifact"]).is_dir()


def _post(url, timeout=30):
    req = urllib.request.Request(url, data=b"", method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def test_server_answers_409_while_a_capture_runs(tmp_path):
    from tpucfn_torch.obs.profiler import ProfileCapture
    from tpucfn_torch.obs.registry import MetricRegistry
    from tpucfn_torch.obs.server import ObsServer

    started, release = threading.Event(), threading.Event()

    def slow_capture(d, s):
        started.set()
        release.wait(5)

    srv = ObsServer(MetricRegistry(), port=0, host="127.0.0.1",
                    profiler=ProfileCapture(tmp_path,
                                            capture_fn=slow_capture))
    try:
        results = {}
        t = threading.Thread(target=lambda: results.setdefault(
            "first", _post(srv.url("/profile?seconds=0.5"))))
        t.start()
        assert started.wait(5)
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.url("/profile?seconds=0.5"))
        assert e.value.code == 409
        release.set()
        t.join(10)
        assert results["first"][0] == 200
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.url("/profile?seconds=0"))
        assert e.value.code == 400
    finally:
        release.set()
        srv.close()


def _trace_names(path):
    return {e.get("name") for e in json.loads(Path(path).read_text())
            ["traceEvents"]}


def test_capture_over_http_holds_the_loop_threads_ops(tmp_path):
    """torch.profiler records the CPU ops of the thread that starts it:
    the capture, asked for from the server's thread, runs on the loop's
    thread between its step boundaries."""
    from tpucfn_torch.obs.profiler import ProfileCapture
    from tpucfn_torch.obs.registry import MetricRegistry
    from tpucfn_torch.obs.server import ObsServer

    pc = ProfileCapture(tmp_path)
    srv = ObsServer(MetricRegistry(), port=0, host="127.0.0.1", profiler=pc)
    x = torch.randn(64, 64)
    try:
        with pc.attach_loop():
            results = {}
            t = threading.Thread(target=lambda: results.setdefault(
                "r", _post(srv.url("/profile?seconds=0.2"))))
            t.start()
            deadline = time.monotonic() + 30
            while t.is_alive() and time.monotonic() < deadline:
                torch.mm(x, x)  # one "step"
                time.sleep(0.01)
                pc.step_boundary()
            t.join(30)
        status, body = results["r"]
        assert status == 200 and body["dur_s"] >= 0.2
        trace = Path(body["artifact"]) / "trace.json"
        assert "aten::mm" in _trace_names(trace)
    finally:
        srv.close()


def test_a_capture_not_started_when_the_loop_ends_fails(tmp_path):
    from tpucfn_torch.obs.profiler import ProfileCapture

    pc = ProfileCapture(tmp_path)
    errors = []
    with pc.attach_loop():
        t = threading.Thread(target=lambda: _record_error(pc, errors))
        t.start()
        while pc._handoff is None:
            time.sleep(0.01)
    t.join(10)
    assert len(errors) == 1 and "before the capture started" in errors[0]


def _record_error(pc, errors):
    try:
        pc(1.0)
    except RuntimeError as e:
        errors.append(str(e))


def test_a_capture_with_no_loop_attached_fails_at_once(tmp_path):
    """Boot, restore and the final save run with no loop to capture: a
    trace from the server's thread would hold none of the trainer's ops."""
    from tpucfn_torch.obs.profiler import ProfileCapture

    pc = ProfileCapture(tmp_path)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="no training loop"):
        pc(5.0)
    assert time.monotonic() - t0 < 1.0


@pytest.mark.parametrize("started", [False, True],
                         ids=["never_started", "started_then_hung"])
def test_a_capture_on_a_hung_loop_fails_in_time_and_frees_the_next(
        started, tmp_path, monkeypatch):
    """A loop that stops reaching step boundaries (a hung collective, a
    long save) fails the capture within seconds + grace (HTTP 500), and
    the next capture is not refused with 409.  A profiler the hung loop
    had started is stopped at its next boundary, and a capture after
    that runs."""
    from tpucfn_torch.obs.profiler import ProfileCapture
    from tpucfn_torch.obs.registry import MetricRegistry
    from tpucfn_torch.obs.server import ObsServer

    monkeypatch.setattr(ProfileCapture, "GRACE_S", 0.3)
    pc = ProfileCapture(tmp_path)
    srv = ObsServer(MetricRegistry(), port=0, host="127.0.0.1", profiler=pc)
    x = torch.randn(64, 64)
    try:
        with pc.attach_loop():
            if started:
                # the loop starts the capture at one boundary, then hangs
                t = threading.Thread(target=lambda: _expect_http(
                    srv.url("/profile?seconds=0.2"), 500))
                t.start()
                while pc._handoff is None:
                    time.sleep(0.01)
                req = pc._handoff
                pc.step_boundary()
                assert req.prof is not None
                t.join(10)
                assert not t.is_alive()
                assert pc._orphan is not None
            t0 = time.monotonic()
            _expect_http(srv.url("/profile?seconds=0.2"), 500)
            assert time.monotonic() - t0 < 0.2 + 0.3 + 2.0
            # the loop comes back: it drops the hung capture's profiler,
            # and the next capture runs and writes its trace (with the
            # real grace: a first profiler start may take a second)
            monkeypatch.setattr(ProfileCapture, "GRACE_S", 30.0)
            results = {}
            t = threading.Thread(target=lambda: results.setdefault(
                "r", _post(srv.url("/profile?seconds=0.1"))))
            t.start()
            deadline = time.monotonic() + 30
            while t.is_alive() and time.monotonic() < deadline:
                torch.mm(x, x)
                time.sleep(0.01)
                pc.step_boundary()
            t.join(30)
            assert pc._orphan is None
        status, body = results["r"]
        assert status == 200
        assert "aten::mm" in _trace_names(Path(body["artifact"]) / "trace.json")
    finally:
        srv.close()


def _expect_http(url, code):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url)
    assert e.value.code == code, e.value.read()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read().decode()


def test_a_live_rank_serves_the_obs_routes(tmp_path):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), TPUCFN_OBS_PORT=str(port))
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpucfn_torch.examples.llama3_8b_fsdp",
         "--device", "cpu", "--model", "tiny", "--seq-len", "256",
         "--batch-size", "16", "--num-examples", "64", "--ce-chunk", "64",
         "--steps", "40", "--ckpt-every", "1000", "--run-dir",
         str(tmp_path / "run")],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        step = None
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                status, body = _get(base + "/healthz")
                step = json.loads(body).get("step")
                if status == 200 and step:
                    break
            except OSError:
                pass
            time.sleep(0.1)
        assert step, proc.communicate(timeout=60)[1][-3000:]
        status, body = _post(base + "/profile?seconds=0.3", timeout=60)
        assert status == 200
        names = _trace_names(Path(body["artifact"]) / "trace.json")
        assert "aten::mm" in names  # the training thread's ops
        _, metrics = _get(base + "/metrics")
        assert "train_last_step" in metrics
        assert "kernel_launches_flash_fwd_sm90" in metrics
        assert "device_hbm_used_bytes" not in metrics  # no card here
        _, ring = _get(base + "/flightrecorder")
        kinds = {s["kind"] for s in json.loads(ring)["samples"]}
        assert "step" in kinds and "hbm" not in kinds
    finally:
        proc.kill()
        proc.wait(30)


@pytest.mark.parametrize("side", ["port", "reference"])
def test_device_probes_are_no_ops_on_the_cpu(side):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    if side == "port":
        from tpucfn_torch.obs.flight import FlightRecorder
        from tpucfn_torch.obs.metrics import (device_memory_stats,
                                              register_device_gauges)
        from tpucfn_torch.obs.registry import MetricRegistry
    else:
        from tpucfn.obs.flight import FlightRecorder
        from tpucfn.obs.metrics import (device_memory_stats,
                                        register_device_gauges)
        from tpucfn.obs.registry import MetricRegistry
    reg = MetricRegistry()
    assert register_device_gauges(reg) == []
    assert "device_hbm" not in reg.to_prometheus()
    assert device_memory_stats() is None
    fr = FlightRecorder(capacity=4)
    assert fr.sample_device() is None and fr.sample_device() is None
    assert fr.snapshot()["samples"] == []


def test_the_port_ignores_jit_sources_and_cpu_devices():
    from tpucfn_torch.obs.metrics import (device_memory_stats,
                                          register_device_gauges)
    from tpucfn_torch.obs.registry import MetricRegistry

    reg = MetricRegistry()
    assert register_device_gauges(reg, torch.device("cpu"),
                                  jit_sources=(lambda: None,)) == []
    assert device_memory_stats(torch.device("cpu")) is None
    assert reg.to_prometheus().strip() == ""


def test_reference_reads_the_ports_flight_dump(tmp_path):
    from tpucfn.obs.flight import read_flight_dir as jax_read_dir
    from tpucfn.obs.flight import read_flight_file as jax_read

    from tpucfn_torch.obs.flight import FlightRecorder

    fr = FlightRecorder(capacity=8, host_id=3, role="trainer")
    for step in range(1, 11):
        fr.record("step", step=step, dur_s=0.25)
    fr.record("hbm", used=40e9, peak=41e9, limit=80e9)
    path = fr.dump(tmp_path)
    header, samples, skipped = jax_read(path)
    assert header["host"] == 3 and header["role"] == "trainer"
    assert header["recorded"] == 11 and header["dropped"] == 3
    assert skipped == 0 and len(samples) == 8
    assert samples[-1]["kind"] == "hbm" and samples[0]["step"] == 4
    assert set(jax_read_dir(tmp_path)) == {3}


def _ramp(ratios, dt=10.0):
    return [{"kind": "hbm", "t": i * dt, "used": r * 80e9, "limit": 80e9}
            for i, r in enumerate(ratios)]


@pytest.mark.parametrize("samples", [
    [],
    _ramp([0.5, 0.6, 0.7]),
    _ramp([0.5, 0.95, 0.96]),
    _ramp([0.93, 0.94, 0.95, 0.97, 0.99]),
    _ramp([0.95, 0.5, 0.95, 0.96, 0.97, 0.98]),
    [{"kind": "step", "t": 0.0}, {"kind": "hbm", "t": 1.0, "used": 1,
                                  "limit": 0}],
], ids=["empty", "low", "short_spike", "sustained", "dip_then_high",
        "unusable"])
def test_hbm_watermark_verdicts_match(samples):
    from tpucfn.obs.flight import hbm_watermark as jax_watermark

    from tpucfn_torch.obs.flight import hbm_watermark

    ours, theirs = hbm_watermark(samples), jax_watermark(samples)
    assert ours == theirs
    assert ours["level"] in ("ok", "alert", "no_data")
    assert ours["ratio"] is None or math.isfinite(ours["ratio"])


def test_kernel_launch_counts_name_the_gauges():
    """The loop logs the counters under the names ``/metrics`` gives them."""
    from tpucfn_torch.obs.metrics import (kernel_launch_counts,
                                          register_kernel_gauges)
    from tpucfn_torch.obs.registry import MetricRegistry

    counts = kernel_launch_counts()
    assert sorted(counts) == sorted(register_kernel_gauges(MetricRegistry()))
    assert all(isinstance(n, int) for n in counts.values())
