"""The port's cluster join against the JAX package's env contract.

``EnvContract.from_env`` reads what JAX's ``to_env()`` writes;
``initialize_runtime`` does nothing without the contract, refuses more
than one card per host and a card that is not there, and two processes
given the contract join one gloo group (ranks and world size from the
contract, an all_reduce across them).
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from tpucfn.bootstrap.contract import EnvContract as JaxContract
from tpucfn_torch.bootstrap import EnvContract
from tpucfn_torch.launch import initialize_runtime, process_count, \
    process_index

REPO = Path(__file__).resolve().parent.parent
CONTRACT_VARS = ("TPUCFN_WORKERS_PATH", "TPUCFN_WORKERS_COUNT",
                 "TPUCFN_WORKER_CHIP_COUNT", "TPUCFN_COORDINATOR",
                 "TPUCFN_HOST_ID", "TPUCFN_STORAGE", "TPUCFN_GENERATION")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_contract(**kw):
    base = dict(workers_path="/tmp/hostfile", workers_count=2,
                worker_chip_count=1, coordinator="127.0.0.1:8476",
                host_id=1, storage="/tmp/storage", generation=3)
    base.update(kw)
    return JaxContract(**base)


@pytest.mark.parametrize("kw", [{}, {"host_id": 0, "generation": 0},
                                {"workers_count": 16, "worker_chip_count": 4,
                                 "storage": ""}])
def test_from_env_reads_what_jax_writes(kw):
    jc = _jax_contract(**kw)
    env = jc.to_env()
    pc = EnvContract.from_env(env)
    assert [getattr(pc, f) for f in pc.__dataclass_fields__] == \
        [getattr(jc, f) for f in jc.__dataclass_fields__]
    assert pc.to_env() == env


def test_missing_contract_names_the_variable():
    env = _jax_contract().to_env()
    del env["TPUCFN_COORDINATOR"]
    with pytest.raises(EnvironmentError, match="TPUCFN_COORDINATOR"):
        EnvContract.from_env(env)


def test_hosts_reads_the_hostfile(tmp_path):
    (tmp_path / "hostfile").write_text("10.0.0.1:8476\n10.0.0.2:8476\n")
    c = EnvContract.from_env(_jax_contract(
        workers_path=str(tmp_path / "hostfile")).to_env())
    assert c.hosts() == JaxContract.from_env(c.to_env()).hosts() == \
        ["10.0.0.1:8476", "10.0.0.2:8476"]


def test_no_env_is_a_no_op(monkeypatch):
    for var in CONTRACT_VARS:
        monkeypatch.delenv(var, raising=False)
    assert initialize_runtime(device="cpu") is None
    assert not torch.distributed.is_initialized()
    assert (process_index(), process_count()) == (0, 1)


def test_single_host_contract_joins_nothing():
    c = EnvContract.from_env(_jax_contract(workers_count=1,
                                           host_id=0).to_env())
    assert initialize_runtime(c, device="cpu") == c
    assert not torch.distributed.is_initialized()


def test_more_than_one_card_per_host_is_refused():
    c = EnvContract.from_env(_jax_contract(worker_chip_count=8).to_env())
    with pytest.raises(NotImplementedError, match="ROADMAP A1"):
        initialize_runtime(c, device="cpu")


def test_the_card_is_never_replaced_by_gloo():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    c = EnvContract.from_env(_jax_contract().to_env())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize_runtime(c)
    assert not torch.distributed.is_initialized()


RANK = textwrap.dedent("""
    import torch, torch.distributed as dist
    from tpucfn_torch.launch import initialize_runtime, process_count, \\
        process_index
    c = initialize_runtime(device="cpu")
    t = torch.tensor([float(c.host_id + 1)])
    dist.all_reduce(t)
    print(dist.get_backend(), process_index(), process_count(), t.item())
    dist.destroy_process_group()
""")


def test_two_ranks_join_one_gloo_group(tmp_path):
    (tmp_path / "hostfile").write_text("127.0.0.1\n127.0.0.1\n")
    port = free_port()
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items() if k not in CONTRACT_VARS}
        env.update(EnvContract(
            workers_path=str(tmp_path / "hostfile"), workers_count=2,
            worker_chip_count=1, coordinator=f"127.0.0.1:{port}",
            host_id=rank, storage="", generation=0).to_env())
        env["PYTHONPATH"] = str(REPO)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    lines = sorted(out.split()[-4:] for out, _ in outs)
    assert lines == [["gloo", "0", "2", "3.0"], ["gloo", "1", "2", "3.0"]]
