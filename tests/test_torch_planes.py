"""The port's launch planes on the CPU: the input service and the
artifact service against the JAX package's on the wire, and the port's
training loop fed by the input service.

* Wire parity, in one process: the JAX package's ``ServiceBatchStream``
  reads the port's ``InputService`` and the port's client reads the JAX
  package's server; both streams equal the batches ``ShardedDataset``
  gives locally for the same shards, seed and identity.  The same for
  ``ArtifactClient`` against ``ArtifactServer``, both ways.
* The loop (the example, tiny, ``--device cpu``, in this process) fed by
  an in-process ``InputService``: the same losses as the local loop; a
  run stopped at step 3 and resumed over the service gets the batches of
  the resumed local run; a resume whose input host is gone degrades to
  local loading at once, at the restored step, and trains the same.
* ``served_or_local_batches`` degrades mid-stream at the exact cursor: a
  connection reset by a ``ChaosProxy`` between trainer and service, and
  the sequence stays the local one.
"""

import atexit
import contextlib
import io
import itertools
import json
import shutil
import signal
import socket
from pathlib import Path

import numpy as np
import pytest
import torch.distributed as dist

import tpucfn.compilecache.service as ref_cc
import tpucfn.data.service as ref_svc
from tpucfn_torch.compilecache import service as port_cc
from tpucfn_torch.data import ShardedDataset, write_dataset_shards
from tpucfn_torch.data import service as port_svc

TINY = ["--device", "cpu", "--model", "tiny", "--seq-len", "32",
        "--batch-size", "8", "--num-examples", "64", "--ce-chunk", "16",
        "--log-every", "1", "--ckpt-every", "1000"]
BATCH, SEED = 8, 0


@pytest.fixture
def no_group():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


# ---- wire parity -------------------------------------------------------------

@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("shards")
    rs = np.random.RandomState(3)
    return write_dataset_shards(
        ({"x": rs.randn(16).astype(np.float32),
          "y": np.int32(rs.randint(0, 10))} for _ in range(96)),
        d, num_shards=4)


def _local(shards, trainer, n, pc=2):
    ds = ShardedDataset(shards, batch_size_per_process=4, seed=5,
                        process_index=trainer, process_count=pc)
    return list(itertools.islice(ds.batches(None), n))


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("server,client", [(port_svc, ref_svc),
                                           (ref_svc, port_svc)],
                         ids=["port-server", "jax-server"])
def test_input_service_wire_parity(shards, server, client):
    with server.InputService(shards, num_trainers=2,
                             batch_size_per_process=4, seed=5) as svc:
        svc.start()
        for trainer in (0, 1):
            stream = client.ServiceBatchStream(
                svc.address, trainer, process_count=2, batch_size=4,
                seed=5, start_batch=2)
            try:
                got = list(itertools.islice(stream, 10))
            finally:
                stream.close()
            _same(got, _local(shards, trainer, 12)[2:])


@pytest.mark.parametrize("server,client", [(port_cc, ref_cc),
                                           (ref_cc, port_cc)],
                         ids=["port-server", "jax-server"])
def test_artifact_service_wire_parity(tmp_path, server, client):
    key = "ab" * 32
    with server.ArtifactServer(tmp_path / "store", host="127.0.0.1") as srv:
        srv.start()
        c = client.ArtifactClient(srv.address, device_kind="card",
                                  jax_version="tools 1")
        assert c.get(key) is None
        assert c.claim(key) == "granted"
        assert c.claim(key) == "busy"
        c.put(key, b"\x7fELF library bytes", {"label": "flash_bwd"})
        payload, meta = c.get(key)
        assert payload == b"\x7fELF library bytes"
        assert meta["label"] == "flash_bwd" and meta["key"] == key
        stats = c.stats()
        assert stats["entries"] == 1
        # the fleet identity is pinned by the first client
        other = client.ArtifactClient(srv.address, device_kind="other card",
                                      jax_version="tools 1")
        with pytest.raises(Exception, match="refused"):
            other.get(key)


# ---- the loop on the service -------------------------------------------------

def _run(run_dir, *argv):
    """The example through its ``main`` in this process; the flight dump
    hooks it arms for the process's exit go with the run."""
    from tpucfn_torch.examples import llama3_8b_fsdp as ex
    from tpucfn_torch.obs.flight import FlightRecorder

    real = FlightRecorder.install_dump_handlers
    armed = []

    def install(rec, d, *a, **kw):
        armed.append((rec, signal.getsignal(signal.SIGTERM)))
        return real(rec, d, *a, **kw)

    out = io.StringIO()
    FlightRecorder.install_dump_handlers = install
    try:
        with contextlib.redirect_stdout(out):
            assert ex.main([*TINY, "--run-dir", str(run_dir), *argv]) == 0
    finally:
        FlightRecorder.install_dump_handlers = real
        for rec, sigterm in armed:
            atexit.unregister(rec._dump_quietly)
            signal.signal(signal.SIGTERM, sigterm)
        if dist.is_initialized():
            dist.destroy_process_group()
    rows = [json.loads(line) for line in
            (Path(run_dir) / "logs" / "train-host000.jsonl").read_text()
            .splitlines()]
    return out.getvalue(), rows


def _losses(rows):
    return {r["step"]: r["loss"] for r in rows if "loss" in r}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The local run (6 steps), and over an in-process service a run
    stopped at step 3, its copy, and the first resumed to step 6."""
    root = tmp_path_factory.mktemp("planes")
    mp = pytest.MonkeyPatch()
    try:
        mp.delenv("TPUCFN_INPUT_ADDRS", raising=False)
        mp.delenv("TPUCFN_COMPILE_CACHE_ADDRS", raising=False)
        mp.delenv("TPUCFN_COMPILE_CACHE_DIR", raising=False)
        out = {"local": _run(root / "local", "--steps", "6")}
        shards = sorted((root / "local" / "data").glob("*.tpurec"))
        with port_svc.InputService(shards, num_trainers=1,
                                   batch_size_per_process=BATCH,
                                   seed=SEED) as svc:
            svc.start()
            mp.setenv("TPUCFN_INPUT_ADDRS", svc.address)
            served = root / "served"
            shutil.copytree(root / "local" / "data", served / "data")
            out["stopped"] = _run(served, "--steps", "6", "--stop-after", "3")
            shutil.copytree(served, root / "orphan")
            out["resumed"] = _run(served, "--steps", "6")
            out["served_batches"] = svc.batches_c.value
            out["connections"] = svc.connections_c.value
        # the input host is gone: a port nothing listens on
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            dead = f"127.0.0.1:{s.getsockname()[1]}"
        mp.setenv("TPUCFN_INPUT_ADDRS", dead)
        out["orphan"] = _run(root / "orphan", "--steps", "6")
    finally:
        mp.undo()
    return out


def test_served_loop_trains_as_the_local_loop(runs):
    local = _losses(runs["local"][1])
    stopped = _losses(runs["stopped"][1])
    assert sorted(local) == [1, 2, 3, 4, 5, 6]
    assert stopped == {s: local[s] for s in (1, 2, 3)}
    assert runs["connections"] == 2  # the first run and its resume
    assert runs["served_batches"] >= 6
    for _, rows in (runs["stopped"], runs["resumed"]):
        assert not any("input_degraded_cursor" in r for r in rows)


def test_resume_over_the_service_gets_the_local_batches(runs):
    stdout, rows = runs["resumed"]
    assert "resumed from step 3" in stdout
    local = _losses(runs["local"][1])
    resumed = _losses(rows)
    assert {s: resumed[s] for s in (4, 5, 6)} == {s: local[s]
                                                 for s in (4, 5, 6)}


def test_resume_without_an_input_host_degrades_at_the_restored_step(runs):
    stdout, rows = runs["orphan"]
    assert "input plane degraded to local loading at batch 3" in stdout
    assert [r["input_degraded_cursor"] for r in rows
            if "input_degraded_cursor" in r] == [3]
    local = _losses(runs["local"][1])
    got = _losses(rows)
    assert {s: got[s] for s in (4, 5, 6)} == {s: local[s] for s in (4, 5, 6)}


# ---- degrade at the exact cursor ---------------------------------------------

def test_stream_degrades_to_local_at_the_exact_cursor(tmp_path):
    """256 KB batches through a proxy that resets the connection after
    five: the trainer's receive buffer holds one batch and the reset drops
    the proxy's, so the stream degrades within a few batches, and the
    whole sequence is the local loader's."""
    from tpucfn_torch.examples.common import served_or_local_batches
    from tpucfn_torch.net.proxy import ChaosProxy

    rs = np.random.RandomState(0)
    shards = write_dataset_shards(
        ({"x": rs.randn(16384).astype(np.float32)} for _ in range(32)),
        tmp_path, num_shards=2)
    ds = ShardedDataset(shards, batch_size_per_process=4, seed=1,
                        process_index=0, process_count=1)
    degraded = []
    with port_svc.InputService(shards, num_trainers=1,
                               batch_size_per_process=4, seed=1,
                               queue_batches=1,
                               sndbuf_bytes=64 * 1024) as svc:
        svc.start()
        with ChaosProxy(svc.address) as proxy:
            proxy.start()
            it = served_or_local_batches(
                ds, 2, env={"TPUCFN_INPUT_ADDRS": proxy.address,
                            "TPUCFN_INPUT_RCVBUF": str(64 * 1024)},
                on_degrade=lambda reason, cursor: degraded.append(cursor))
            try:
                got = [next(it) for _ in range(5)]
                proxy.inject("rst")
                got += [next(it) for _ in range(40)]
            finally:
                it.close()
    _same(got, list(itertools.islice(ds.batches(None), 2, 47)))
    assert len(degraded) == 1 and 2 + 5 <= degraded[0] < 2 + 45, degraded


def test_without_input_hosts_the_local_loader_from_the_start(shards):
    from tpucfn_torch.examples.common import served_or_local_batches

    ds = ShardedDataset(shards, batch_size_per_process=4, seed=5,
                        process_index=0, process_count=2)
    it = served_or_local_batches(ds, 3, env={})
    assert not hasattr(it, "pop_link")
    _same(list(itertools.islice(it, 4)), _local(shards, 0, 7)[3:])
