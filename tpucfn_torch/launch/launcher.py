"""The multihost launcher and joining the cluster (the port of
``tpucfn/launch/launcher.py``).

:class:`Launcher` (over :class:`LocalTransport` or :class:`SSHTransport`)
fans one command out to every host with that host's env: the contract,
``TPUCFN_OBS_PORT = base + 1 + host_id`` and ``TPUCFN_FT_DIR``; the gang
coordinator (``tpucfn_torch.ft``) or :func:`run_with_restarts` supervises
it.  These are copies held equal to the JAX package's by
``tests/test_torch_isolation.py``, with the two constants that the JAX
package imports from its input service and compile cache kept here
(neither plane is ported: ``tpucfn_torch.cli launch`` refuses their
flags, so the copies never set them).

``python -m tpucfn_torch.cli launch`` fans the env contract
(:class:`tpucfn_torch.bootstrap.EnvContract`) out to one process per
host; :func:`initialize_runtime` reads it and joins a ``torch.distributed``
process group at ``tcp://{TPUCFN_COORDINATOR}`` with rank
``TPUCFN_HOST_ID`` and world size ``TPUCFN_WORKERS_COUNT``: NCCL on the
card, gloo only when the caller asks for the CPU.  Without the contract
it does nothing, so the same script runs single-host.

Not ported yet (ROADMAP A1 and D2): one rank per card under a per-host
parent, so a host with ``TPUCFN_WORKER_CHIP_COUNT`` > 1 is refused; and
the persistent compile cache the JAX package arms here.
"""

from __future__ import annotations

import dataclasses
import os
import shlex
import subprocess
import sys
from typing import Sequence

import torch

from tpucfn_torch.bootstrap.contract import EnvContract
from tpucfn_torch.device import resolve_device

# The JAX package's input service base port
# (``tpucfn/data/service.py:DEFAULT_INPUT_PORT``) and compile-cache env
# variable (``tpucfn/compilecache/service.py:COMPILE_CACHE_ADDRS_ENV``).
DEFAULT_INPUT_PORT = 7641
COMPILE_CACHE_ADDRS_ENV = "TPUCFN_COMPILE_CACHE_ADDRS"  # comma host:port


class Transport:
    def run(self, host: str, argv: Sequence[str], env: dict[str, str]) -> subprocess.Popen:
        raise NotImplementedError


class LocalTransport(Transport):
    """Spawn on this machine (ignores ``host``)."""

    def run(self, host: str, argv: Sequence[str], env: dict[str, str]) -> subprocess.Popen:
        full_env = {**os.environ, **env}
        return subprocess.Popen(list(argv), env=full_env)

    def argv_for(self, host: str, argv: Sequence[str], env: dict[str, str]) -> list[str]:
        return list(argv)


class SSHTransport(Transport):
    """Fan out over passwordless SSH (the bootstrap layer's key contract).

    Mirrors the reference's dmlc ssh tracker / `mpirun -hostfile` hop:
    env is passed inline because ssh does not forward arbitrary vars.
    """

    def __init__(self, ssh_args: Sequence[str] = ("-o", "StrictHostKeyChecking=no")):
        self.ssh_args = tuple(ssh_args)

    def argv_for(self, host: str, argv: Sequence[str], env: dict[str, str]) -> list[str]:
        hostname = host.rsplit(":", 1)[0]
        env_prefix = " ".join(f"{k}={shlex.quote(v)}" for k, v in sorted(env.items()))
        remote_cmd = f"{env_prefix} {' '.join(shlex.quote(a) for a in argv)}"
        return ["ssh", *self.ssh_args, hostname, remote_cmd]

    def run(self, host: str, argv: Sequence[str], env: dict[str, str]) -> subprocess.Popen:
        return subprocess.Popen(self.argv_for(host, argv, env))


@dataclasses.dataclass
class Launcher:
    contract: EnvContract
    transport: Transport
    # Observability-plane port fan-out: when set, the supervisor keeps
    # ``obs_base_port`` for its own /metrics endpoint and each host's
    # process gets ``base + 1 + host_id`` via TPUCFN_OBS_PORT — every
    # role in the job becomes scrapeable at a predictable address
    # (tpucfn/obs/server.py documents the endpoint surface).
    obs_base_port: int | None = None
    # Fault-tolerance-plane fan-out (tpucfn/ft): when set, every host
    # writes heartbeats into this shared directory (TPUCFN_FT_DIR) at
    # TPUCFN_FT_HEARTBEAT_S intervals, and the gang coordinator's
    # HeartbeatMonitor reads the same dir.  Part of host_env so a solo
    # restart reuses the identical env — the replacement rank appends to
    # the same heartbeat file the dead one owned.
    ft_dir: str | None = None
    ft_heartbeat_s: float | None = None
    # Supervisor-injected vars applied to every subsequent (re)launch —
    # how the coordinator's graceful-degradation state (e.g. the ckpt
    # step blacklist on a corruption retry, ISSUE 7) reaches the ranks
    # without the contract changing.  Applied last, so it can override.
    extra_env: dict[str, str] = dataclasses.field(default_factory=dict)
    # Disaggregated input plane (ISSUE 11): the LAST ``input_hosts`` of
    # the launched slice serve batches instead of training.  They run
    # ``input_argv`` (default: the same argv — role-switching jobs read
    # TPUCFN_ROLE), bind ``input_port + host_id``, and every host gets
    # TPUCFN_INPUT_ADDRS so trainers know where the batches are.
    # Trainer ranks see TPUCFN_WORKERS_COUNT = the TRAINER count — the
    # jax.distributed rendezvous is over accelerator hosts only; input
    # hosts never join it (they never import jax at all).
    input_hosts: int = 0
    input_port: int | None = None
    input_argv: list[str] | None = dataclasses.field(default=None)
    # TPUCFN_INPUT_ADDRS advertises the hostfile addresses by default.
    # Those are only dialable when the fleet really runs on them — a
    # LocalTransport fleet runs every "host" on loopback while the fake
    # control plane hands out synthetic 10.0.0.x addresses, so trainers
    # would burn the full connect-retry window and silently degrade to
    # local loading (same failure class as --compile-cache-advertise,
    # ISSUE 13).  Set to the host trainers should dial instead.
    input_advertise_host: str | None = None
    # Provisioner policy loop (ISSUE 18): reserve the input hosts in the
    # topology but do NOT spawn or advertise them yet.  Trainers still
    # see TPUCFN_ROLE/TPUCFN_WORKERS_COUNT (the per-trainer shard split
    # must be identical before and after activation — that is what keeps
    # the trajectory bit-identical across a policy-driven grow), but
    # TPUCFN_INPUT_ADDRS stays absent so service_or_local_batches keeps
    # loading locally.  activate_input_plane() flips the switch; the
    # next (re)launch spawns the input hosts with the full served env.
    defer_input_plane: bool = False
    # Fleet warm start (ISSUE 13): every host learns where the compiled-
    # artifact servers are (TPUCFN_COMPILE_CACHE_ADDRS, same pattern as
    # TPUCFN_INPUT_ADDRS) — trainers/serve replicas consult them before
    # compiling, so host 0 compiles once and N-1 peers fetch.  A RELAUNCH
    # through launch_host / a gang restart re-derives the same env, which
    # is what makes restart MTTR stop repaying the compile.  None/empty ⇒
    # the env key is absent and behavior is byte-identical (pinned).
    compile_cache_addrs: list[str] | None = dataclasses.field(default=None)

    @property
    def trainer_count(self) -> int:
        return self.contract.workers_count - self.input_hosts

    @property
    def trainer_host_ids(self) -> list[int]:
        return list(range(self.trainer_count))

    @property
    def input_host_ids(self) -> list[int]:
        return list(range(self.trainer_count, self.contract.workers_count))

    @property
    def deferred_input_host_ids(self) -> list[int]:
        """Input hosts reserved but not yet activated (ISSUE 18)."""
        return self.input_host_ids if self.defer_input_plane else []

    def activate_input_plane(self) -> None:
        """Provisioner actuation: the next (re)launch spawns the
        reserved input hosts and fans TPUCFN_INPUT_ADDRS out to the
        trainers.  Idempotent; a no-op when nothing was deferred."""
        self.defer_input_plane = False

    def _input_base_port(self) -> int:
        if self.input_port is not None:
            return self.input_port

        return DEFAULT_INPUT_PORT

    def host_env(self, host_id: int) -> dict[str, str]:
        env = self.contract.to_env()
        env["TPUCFN_HOST_ID"] = str(host_id)
        if self.obs_base_port is not None:
            env["TPUCFN_OBS_PORT"] = str(self.obs_base_port + 1 + host_id)
        if self.ft_dir is not None:
            env["TPUCFN_FT_DIR"] = self.ft_dir
            if self.ft_heartbeat_s is not None:
                env["TPUCFN_FT_HEARTBEAT_S"] = repr(float(self.ft_heartbeat_s))
        if self.input_hosts > 0:
            if self.trainer_count < 1:
                raise ValueError(
                    f"input_hosts={self.input_hosts} leaves no trainer in "
                    f"a {self.contract.workers_count}-host slice")
            base = self._input_base_port()
            hosts = self.contract.hosts()[: self.contract.workers_count]
            env["TPUCFN_ROLE"] = ("input" if host_id in self.input_host_ids
                                  else "trainer")
            # the rendezvous (and every per-trainer shard split) is over
            # trainer ranks only
            env["TPUCFN_WORKERS_COUNT"] = str(self.trainer_count)
            if not self.defer_input_plane:
                env["TPUCFN_INPUT_ADDRS"] = ",".join(
                    f"{self.input_advertise_host or hosts[h].rsplit(':', 1)[0]}"
                    f":{base + h}"
                    for h in self.input_host_ids)
                if host_id in self.input_host_ids:
                    env["TPUCFN_INPUT_PORT"] = str(base + host_id)
        if self.compile_cache_addrs:

            env[COMPILE_CACHE_ADDRS_ENV] = ",".join(self.compile_cache_addrs)
        env.update(self.extra_env)
        return env

    def _argv_for_host(self, argv: Sequence[str], host_id: int) -> list[str]:
        if self.input_hosts > 0 and host_id in self.input_host_ids \
                and self.input_argv is not None:
            return list(self.input_argv)
        return list(argv)

    def launch(
        self,
        argv: Sequence[str],
        *,
        kill_host_after: tuple[int, float] | None = None,
    ) -> list[subprocess.Popen]:
        """Start ``argv`` on every host; returns the Popen handles (the
        local handle for LocalTransport, the ssh client handles for SSH).

        ``kill_host_after=(host_id, seconds)`` is the fault-injection hook
        (SURVEY.md §5): a timer SIGKILLs that host's process mid-run so
        recovery paths (fail-fast wait, --restarts resume) can be
        exercised deterministically in tests and drills.
        """
        # The contract's count wins over the hostfile's line count (the
        # reference's launch.py -n had the same precedence over -H).
        hosts = self.contract.hosts()[: self.contract.workers_count]
        if kill_host_after is not None and not (
            0 <= kill_host_after[0] < len(hosts)
        ):
            # Validate before spawning: an out-of-range victim must not
            # leak an already-launched gang.  (The CLI validates against
            # the full hostfile, which may be longer than workers_count.)
            raise ValueError(
                f"kill_host_after host_id {kill_host_after[0]} out of range "
                f"for {len(hosts)} launched hosts"
            )
        deferred = set(self.deferred_input_host_ids)
        procs = []
        for host_id, host in enumerate(hosts):
            if host_id in deferred:
                continue  # reserved for the provisioner; not spawned yet
            procs.append(self.transport.run(
                host, self._argv_for_host(argv, host_id),
                self.host_env(host_id)))
        if kill_host_after is not None:
            import threading

            victim, delay = kill_host_after

            def _kill(p=procs[victim]):
                if p.poll() is None:
                    p.kill()

            t = threading.Timer(delay, _kill)
            t.daemon = True
            t.start()
        return procs

    def launch_host(self, argv: Sequence[str], host_id: int) -> subprocess.Popen:
        """(Re)start ``argv`` on one host with that host's exact env —
        the solo-restart path: the replacement rank gets the same
        host_id, obs port, and heartbeat file as the rank it replaces,
        so the rest of the gang cannot tell the difference."""
        hosts = self.contract.hosts()[: self.contract.workers_count]
        if not 0 <= host_id < len(hosts):
            raise ValueError(
                f"host_id {host_id} out of range for {len(hosts)} hosts")
        return self.transport.run(hosts[host_id],
                                  self._argv_for_host(argv, host_id),
                                  self.host_env(host_id))

    def stop_all(self, procs: Sequence[subprocess.Popen], *,
                 grace_s: float = 5.0, poll_interval: float = 0.05) -> int:
        """Stop every live process: SIGTERM first, then SIGKILL whatever
        is still alive after ``grace_s`` (a rank wedged in a collective,
        or SIGSTOP'd by the chaos harness, ignores SIGTERM forever).
        All processes are reaped before returning.  Returns how many
        needed the SIGKILL escalation.

        ``procs`` is the ``poll/terminate/kill/wait`` duck-type, not
        necessarily ``Popen``: an adopting coordinator (ISSUE 12) hands
        this :class:`~tpucfn.ft.journal.AdoptedProcess` handles for
        ranks it re-attached to but did not spawn."""
        import time

        live = [p for p in procs if p.poll() is None]
        for p in live:
            p.terminate()
        deadline = time.monotonic() + grace_s
        while any(p.poll() is None for p in live):
            if time.monotonic() >= deadline:
                break
            time.sleep(poll_interval)
        escalated = 0
        for p in live:
            if p.poll() is None:
                escalated += 1
                p.kill()
        for p in live:
            p.wait()
        return escalated

    def wait(self, procs: list[subprocess.Popen], poll_interval: float = 0.05) -> int:
        """Wait for all ranks; first nonzero exit wins and the rest are
        terminated, so one dead host fails the job fast instead of hanging
        the collective (SURVEY.md §5 failure-detection row). Polls rather
        than waiting in rank order — rank 0 being alive must not mask a
        crashed rank 3."""
        import time

        rc = 0
        remaining = set(range(len(procs)))
        try:
            while remaining:
                for i in sorted(remaining):
                    r = procs[i].poll()
                    if r is None:
                        continue
                    remaining.discard(i)
                    if r != 0 and rc == 0:
                        rc = r
                        for q in procs:
                            if q.poll() is None:
                                q.terminate()
                if remaining:
                    time.sleep(poll_interval)
        finally:
            for q in procs:
                if q.poll() is None:
                    q.kill()
        return rc


def run_with_restarts(
    launcher: "Launcher",
    argv: Sequence[str],
    *,
    max_restarts: int = 0,
    backoff_s: float = 0.0,
    kill_host_after: tuple[int, float] | None = None,
    registry=None,
) -> int:
    """Supervise a job: relaunch the whole gang after a failure.

    The recovery contract from SURVEY.md §5 (failure detection row): a TPU
    slice is not elastic, so recovery is re-launch + resume-from-
    checkpoint — jobs written with tpucfn's CheckpointManager pick up at
    their latest step (the examples' ``--resume`` path). The reference's
    answer here was "the training job dies and is re-run by hand"; this
    automates the re-run.

    ``registry`` (a ``tpucfn.obs.MetricRegistry``) makes the supervisor
    itself a scrapeable role: attempts, restarts, failures, gang size,
    and the last exit code are published so a dashboard can tell
    "training is slow" apart from "training is crash-looping".

    Exit-cause accounting (ISSUE 4 satellite): only actual failures
    consume the restart budget and bump ``supervisor_failures_total`` /
    ``supervisor_restarts_total`` — a clean rc=0 gang after a prior
    failure ends the run successfully without burning a slot.
    ``supervisor_launch_attempts_total`` still counts every gang launch
    including the first (it is a launch counter, not a failure counter).
    """
    from tpucfn_torch.ft import GangCoordinator, GangRestart, RestartBudget

    # multiplier=1/jitter=0/uncapped preserves this entry point's
    # historical constant-backoff contract (the replaced loop slept
    # exactly backoff_s); the full exponential+jitter surface is
    # GangCoordinator with an explicitly built RestartBudget.
    budget = RestartBudget(max_restarts, backoff_s=backoff_s,
                           multiplier=1.0, jitter=0.0,
                           max_backoff_s=float("inf"))
    coordinator = GangCoordinator(
        launcher, argv, policy=GangRestart(budget), registry=registry,
        kill_host_after=kill_host_after)
    return coordinator.run()


def initialize_runtime(contract: EnvContract | None = None, *,
                       device: str | torch.device = "cuda"
                       ) -> EnvContract | None:
    """Per-process entry: join the cluster rendezvous.

    Returns the contract, or None for a plain single-host run (no
    cluster env), which joins nothing.  ``device`` picks the backend:
    ``nccl`` for the card (raising when there is none, never falling back
    to gloo), ``gloo`` for ``"cpu"``."""
    if contract is None:
        try:
            contract = EnvContract.from_env()
        except EnvironmentError:
            return None  # plain single-host run, no cluster env
    if contract.worker_chip_count > 1:
        raise NotImplementedError(
            f"TPUCFN_WORKER_CHIP_COUNT={contract.worker_chip_count}: the port "
            "runs one rank per card, and a per-host parent that starts one "
            "rank per card is not ported yet (ROADMAP A1); launch one "
            "process per card with a chip count of 1")
    dev = resolve_device(device)
    if contract.workers_count > 1:
        import torch.distributed as dist

        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://{contract.coordinator}",
            world_size=contract.workers_count, rank=contract.host_id)
    return contract


def process_index() -> int:
    """This process's rank in the default process group (0 without one):
    the counterpart of ``jax.process_index()``."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """Ranks in the default process group (1 without one): the
    counterpart of ``jax.process_count()``, and of ``jax.device_count()``
    with one card per rank."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def main_argv_for_script(script: str, args: Sequence[str]) -> list[str]:
    return [sys.executable, script, *args]
