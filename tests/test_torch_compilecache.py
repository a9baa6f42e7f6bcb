"""The kernel-library cache (``tpucfn_torch.compilecache.kernels``) with an
injected builder in place of ``nvcc`` and an injected opener in place of
``ctypes.CDLL``, over a real artifact server and store:

* cold: one build and one publish; warm (a second host: empty kernel
  directory and store): a fetch and no build; a library already in the
  kernel directory loads without the network; the local store serves a
  warm restart;
* a corrupt store entry is quarantined and rebuilt; a fetched library
  that will not open is refused and rebuilt;
* a dead or stalled server falls back to a local build inside the op
  deadline; a server pinned to another card is refused and the library
  is built here;
* two processes racing on a cold fleet build once;
* with no cache configured, ``_build.load`` builds and loads as it always
  did, and ``configure_from_env`` installs nothing;
* the ``CompileCacheProbe`` verdicts and the goodput buckets they give,
  and the port's own default store directory.
"""

import ctypes
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from tpucfn_torch.compilecache import kernels as kc
from tpucfn_torch.compilecache.service import (ArtifactServer,
                                               CompileCacheClient)
from tpucfn_torch.compilecache.store import ArtifactStore, default_store_dir
from tpucfn_torch.kernels import _build
from tpucfn_torch.obs.profiler import CompileCacheProbe

REPO = Path(__file__).resolve().parent.parent
CARD, TOOLS = "NVIDIA H100 80GB HBM3", "torch t; cuda c; nvcc n"


class Host:
    """One host: its own kernel directory, artifact store and builder."""

    def __init__(self, root: Path, addrs=(), *, device_kind=CARD,
                 op_deadline_s=None, build_s=0.0, store=True):
        self.dir = root / "kernels"
        self.builds: list[str] = []
        self.build_s = build_s
        self.probe = CompileCacheProbe(self.dir)
        client = CompileCacheClient(
            ArtifactStore(root / "store", device_kind=device_kind,
                          jax_version=TOOLS) if store else None,
            addrs, device_kind=device_kind, jax_version=TOOLS,
            probe=self.probe, op_deadline_s=op_deadline_s,
            connect_timeout_s=1.0, wait_s=30.0, poll_s=0.05)
        self.cache = kc.KernelLibraryCache(
            client, arch="sm_90", build_fn=self.build, open_fn=self.open,
            library_path=lambda name: self.dir / f"{name}-0123456789abcdef.so")

    def build(self, name):
        time.sleep(self.build_s)
        self.builds.append(name)
        self.dir.mkdir(parents=True, exist_ok=True)
        (self.dir / f"{name}-0123456789abcdef.so").write_bytes(
            b"\x7fELF " + name.encode())

    @staticmethod
    def open(path):
        data = Path(path).read_bytes()
        if not data.startswith(b"\x7fELF"):
            raise OSError(f"{path}: invalid ELF header")
        return ("lib", data)

    def counters(self):
        m = self.cache.client.registry.varz()["metrics"]
        return {k.removeprefix("compilecache_").removesuffix("_total"): v
                for k, v in m.items() if k.startswith("compilecache_")
                and k.endswith("_total") and not k.startswith(
                    "compilecache_net")}


@pytest.fixture
def server(tmp_path):
    with ArtifactServer(tmp_path / "server", host="127.0.0.1") as srv:
        srv.start()
        yield srv


def test_cold_builds_and_publishes_once_warm_fetches(tmp_path, server):
    a = Host(tmp_path / "a", [server.address])
    assert a.cache.load("flash_bwd") == ("lib", b"\x7fELF flash_bwd")
    assert a.builds == ["flash_bwd"]
    c = a.counters()
    assert (c["compiles"], c["client_publishes"], c["fetch_hits"]) == (1, 1, 0)
    assert a.cache.client.last_outcome == "compile"
    assert a.probe.outcome() == "miss"

    b = Host(tmp_path / "b", [server.address])
    assert b.cache.load("flash_bwd") == ("lib", b"\x7fELF flash_bwd")
    assert b.builds == []
    c = b.counters()
    assert (c["compiles"], c["fetch_hits"]) == (0, 1)
    assert b.probe.outcome() == "fetch"
    # the fetched library took its name in the kernel directory
    assert (b.dir / "flash_bwd-0123456789abcdef.so").read_bytes() == \
        b"\x7fELF flash_bwd"
    assert not list(b.dir.glob("*.fetch"))


def test_kernel_directory_and_local_store_serve_without_the_network(
        tmp_path, server):
    a = Host(tmp_path / "a", [server.address])
    a.cache.load("flash_fwd_sm90")
    server.close()  # nothing to dial from here on
    # the library in the kernel directory: compile_cached
    again = Host(tmp_path / "a", ["127.0.0.1:1"])
    assert again.cache.load("flash_fwd_sm90")[1] == b"\x7fELF flash_fwd_sm90"
    assert again.counters()["kernel_dir_hits"] == 1
    assert again.probe.outcome() == "hit" and again.builds == []
    # kernel directory emptied, the store still holds it: compile_cached
    for p in (tmp_path / "a" / "kernels").iterdir():
        p.unlink()
    warm = Host(tmp_path / "a", ["127.0.0.1:1"])
    assert warm.cache.load("flash_fwd_sm90")[1] == b"\x7fELF flash_fwd_sm90"
    assert warm.counters()["store_hits"] == 1
    assert warm.probe.outcome() == "hit" and warm.builds == []


def test_corrupt_store_entry_is_quarantined_and_rebuilt(tmp_path):
    a = Host(tmp_path / "a")  # a store, no fleet
    a.cache.load("flash_bwd_dq_sm90")
    for p in a.dir.iterdir():
        p.unlink()
    bins = list((tmp_path / "a" / "store").glob("*.bin"))
    assert len(bins) == 1
    bins[0].write_bytes(b"\x7fELF flipped bits")
    b = Host(tmp_path / "a")
    assert b.cache.load("flash_bwd_dq_sm90")[1] == b"\x7fELF flash_bwd_dq_sm90"
    assert b.builds == ["flash_bwd_dq_sm90"]
    assert b.counters()["corrupt"] == 1
    assert list((tmp_path / "a" / "store" / "corrupt").iterdir())


def test_fetched_library_that_will_not_open_is_rebuilt(tmp_path, server):
    a = Host(tmp_path / "a", [server.address])
    key = a.cache.key("flash_bwd_dkv_sm90")
    a.cache.client._clients()[0].put(key, b"not a library", {"label": "x"})
    assert a.cache.load("flash_bwd_dkv_sm90")[1] == \
        b"\x7fELF flash_bwd_dkv_sm90"
    assert a.builds == ["flash_bwd_dkv_sm90"]
    # refused at the fetch and again when the claim answered "hit"
    assert a.counters()["corrupt"] == 2
    assert not list(a.dir.glob("*.fetch"))


def _stalled_server():
    """Accepts and reads, never answers: a gray artifact server."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)
    conns = []

    def accept():
        while True:
            try:
                conns.append(srv.accept()[0])
            except OSError:
                return

    threading.Thread(target=accept, daemon=True).start()
    return srv, conns


@pytest.mark.parametrize("kind", ["dead", "stalled"])
def test_unreachable_server_falls_back_to_a_local_build(tmp_path, kind):
    if kind == "dead":
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            addr = f"127.0.0.1:{s.getsockname()[1]}"
        srv = None
    else:
        srv, conns = _stalled_server()
        addr = "127.0.0.1:%d" % srv.getsockname()[1]
    try:
        a = Host(tmp_path / "a", [addr], op_deadline_s=0.5)
        t0 = time.monotonic()
        assert a.cache.load("flash_fwd_mma_sm90")[1] == \
            b"\x7fELF flash_fwd_mma_sm90"
        took = time.monotonic() - t0
    finally:
        if srv is not None:
            srv.close()
    assert a.builds == ["flash_fwd_mma_sm90"]
    c = a.counters()
    assert c["compiles"] == 1 and c["fetch_failures"] >= 2
    # get, claim and the publish attempt, each inside its op deadline
    assert took < 3 * 0.5 + 1.0, took


def test_server_pinned_to_another_card_is_refused(tmp_path):
    with ArtifactServer(tmp_path / "server", host="127.0.0.1",
                        device_kind="NVIDIA A100-SXM4-80GB",
                        jax_version=TOOLS) as srv:
        srv.start()
        other = ArtifactStore(tmp_path / "server")
        a = Host(tmp_path / "a", [srv.address])
        other.put(a.cache.key("flash_bwd"), b"\x7fELF built elsewhere",
                  {"device_kind": "NVIDIA A100-SXM4-80GB"})
        assert a.cache.load("flash_bwd")[1] == b"\x7fELF flash_bwd"
        assert a.builds == ["flash_bwd"]
        assert srv.refusals_c.value >= 1


def test_store_entry_for_another_toolchain_is_refused(tmp_path):
    a = Host(tmp_path / "a")
    key = a.cache.key("flash_bwd")
    ArtifactStore(tmp_path / "a" / "store").put(
        key, b"\x7fELF other nvcc", {"jax_version": "torch t; cuda c; nvcc m"})
    assert a.cache.load("flash_bwd")[1] == b"\x7fELF flash_bwd"
    assert a.builds == ["flash_bwd"] and a.counters()["corrupt"] == 1


def test_key_covers_card_arch_toolchain_and_source(tmp_path):
    a = Host(tmp_path / "a")
    keys = {a.cache.key("flash_bwd"), a.cache.key("flash_fwd_sm90")}
    b = Host(tmp_path / "b", device_kind="NVIDIA H200")
    keys.add(b.cache.key("flash_bwd"))
    b.cache.arch = "sm_100"
    keys.add(b.cache.key("flash_bwd"))
    assert len(keys) == 4 and all(len(k) == 64 for k in keys)


RACER = r"""
import json, sys, time
from pathlib import Path
sys.path.insert(0, {tests!r})
from test_torch_compilecache import Host
root, addr, go = Path(sys.argv[1]), sys.argv[2], float(sys.argv[3])
host = Host(root, [addr], build_s=1.0)
time.sleep(max(0.0, go - time.time()))
lib = host.cache.load("flash_fwd_sm90")
print(json.dumps({{"builds": host.builds, "outcome":
                  host.cache.client.last_outcome, "lib": lib[1].decode()}}))
"""


def test_two_racing_processes_build_once(tmp_path, server):
    code = RACER.format(tests=str(REPO / "tests"))
    go = time.time() + 2.0  # both started and imported by then, mostly
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(tmp_path / f"h{i}"), server.address,
         str(go)], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=60)
        assert p.returncode == 0, err[-2000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert sorted(len(o["builds"]) for o in outs) == [0, 1], outs
    assert sorted(o["outcome"] for o in outs) == ["compile", "fetch"], outs
    assert {o["lib"] for o in outs} == {"\x7fELF flash_fwd_sm90"}


# ---- _build without and with a cache ----------------------------------------

@pytest.fixture
def fake_nvcc(monkeypatch):
    """``_build.build`` and ``ctypes.CDLL`` recorded, a fresh load table."""
    calls = []
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "build", lambda *n: calls.append(("build", n)))
    monkeypatch.setattr(ctypes, "CDLL",
                        lambda path: calls.append(("open", path)) or path)
    yield calls
    kc.install(None)


def test_without_a_cache_build_loads_as_before(fake_nvcc, monkeypatch):
    for var in ("TPUCFN_COMPILE_CACHE_ADDRS", "TPUCFN_COMPILE_CACHE_DIR"):
        monkeypatch.delenv(var, raising=False)
    assert kc.configure_from_env() is None and kc.installed() is None
    lib = _build.load("flash_bwd")
    assert lib == str(_build.library_path("flash_bwd"))
    assert fake_nvcc == [("build", ("flash_bwd",)), ("open", lib)]
    assert _build.load("flash_bwd") is lib and len(fake_nvcc) == 2


def test_with_a_cache_build_loads_through_it(fake_nvcc):
    asked = []

    class Cache:
        def load(self, name):
            asked.append(name)
            return f"cached {name}"

    kc.install(Cache())
    assert _build.load("flash_bwd") == "cached flash_bwd"
    assert _build.load("flash_bwd") == "cached flash_bwd"
    assert asked == ["flash_bwd"] and fake_nvcc == []


def test_a_slow_library_does_not_hold_up_another(fake_nvcc):
    """Each library has a lock of its own: a fetch or build of one never
    blocks the loading of another."""
    release = threading.Event()

    class Cache:
        def load(self, name):
            if name == "slow":
                release.wait(10)
            return name

    kc.install(Cache())
    t = threading.Thread(target=_build.load, args=("slow",))
    t.start()
    try:
        t0 = time.monotonic()
        assert _build.load("fast") == "fast"
        assert time.monotonic() - t0 < 1.0
    finally:
        release.set()
        t.join()


# ---- the probe, the buckets, the store dir -----------------------------------

@pytest.mark.parametrize("marks,outcome,bucket", [
    ((), None, "compile"),
    (("store",), "hit", "compile_cached"),
    (("store", "fetch"), "fetch", "compile_fetched"),
    (("fetch", "compile", "store"), "miss", "compile"),
])
def test_probe_verdicts_and_their_buckets(tmp_path, marks, outcome, bucket):
    from tpucfn_torch.train.trainer import TrainerObs

    probe = CompileCacheProbe(tmp_path)
    obs = TrainerObs(compile_probe=probe)
    probe.rearm()
    for m in marks:
        probe.mark(m)
    assert probe.outcome() == outcome
    assert probe.hit() == (None if outcome is None
                           else outcome in ("hit", "fetch"))
    assert obs._compile_bucket() == bucket


def test_probe_reads_the_kernel_directory(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "_loaded", {})
    probe = CompileCacheProbe(tmp_path)
    _build._loaded["a"] = object()  # loaded, nothing built: a hit
    assert probe.outcome() == "hit"
    (tmp_path / "b-0.so").write_bytes(b"")  # a library appeared: nvcc ran
    assert probe.outcome() == "miss"
    probe.rearm()
    assert probe.outcome() is None


def test_default_store_dir_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.setenv("TPUCFN_COMPILE_CACHE_DIR", str(tmp_path / "pinned"))
    assert default_store_dir() == str(tmp_path / "pinned")
    monkeypatch.delenv("TPUCFN_COMPILE_CACHE_DIR")
    monkeypatch.setenv("TPUCFN_TORCH_STATE_DIR", str(tmp_path / "state"))
    assert default_store_dir() == str(tmp_path / "state" / "compilecache")
    monkeypatch.delenv("TPUCFN_TORCH_STATE_DIR")
    monkeypatch.setenv("TPUCFN_XLA_CACHE", str(tmp_path / "xla"))
    assert default_store_dir() == str(
        Path("~/.tpucfn_torch/compilecache").expanduser())


def test_toolchain_identity_names_torch_cuda_and_nvcc():
    import torch

    ident = kc.toolchain_identity()
    assert ident.startswith(f"torch {torch.__version__}; cuda ")
    assert "; nvcc " in ident
