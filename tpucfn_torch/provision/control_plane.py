"""TPU control-plane abstraction + fake implementation.

The reference trusted the CloudFormation service as an untestable black
box (SURVEY.md §4: "multi-node was only ever tested on real EC2"). Here
the control plane is an interface so the whole provisioning state machine
is exercised in CI against :class:`FakeControlPlane` — a deterministic,
optionally-failing in-process implementation of the TPU queued-resource
lifecycle:

    QUEUED → PROVISIONING → ACTIVE → (DELETING → DELETED | FAILED)

A real GCP/AWS-trn backend implements the same five methods against the
cloud API; nothing above this module changes (SURVEY.md §5 failure-
detection row and §7.2 step 4).
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import itertools
import threading
from typing import Callable

from tpucfn_torch.spec import ClusterSpec


class ClusterState(enum.Enum):
    QUEUED = "QUEUED"
    PROVISIONING = "PROVISIONING"
    ACTIVE = "ACTIVE"
    DELETING = "DELETING"
    DELETED = "DELETED"
    FAILED = "FAILED"


@dataclasses.dataclass
class HostRecord:
    host_id: int
    address: str  # ip:port the launcher reaches this host at
    healthy: bool = True


@dataclasses.dataclass
class ClusterRecord:
    spec: ClusterSpec
    state: ClusterState
    hosts: list[HostRecord]
    generation: int = 0  # bumped on every (re)acquire — resume fencing
    message: str = ""


class ControlPlane:
    """Interface; see FakeControlPlane for semantics."""

    def create(self, spec: ClusterSpec) -> ClusterRecord:
        raise NotImplementedError

    def describe(self, name: str) -> ClusterRecord:
        raise NotImplementedError

    def delete(self, name: str) -> None:
        raise NotImplementedError

    def tick(self) -> None:
        """Advance async state transitions (real backends poll instead)."""

    def kill_host(self, name: str, host_id: int) -> None:
        """Fault injection: mark a host dead (test-only on real backends)."""
        raise NotImplementedError


class FakeControlPlane(ControlPlane):
    """Deterministic fake with scriptable latency and failures.

    ``steps_to_provision`` QUEUED→ACTIVE ticks model queued-resource wait;
    ``fail_after`` makes creation land in FAILED (capacity error);
    ``kill_host`` flips a host unhealthy, which the Provisioner's monitor
    must notice (SURVEY.md §5: ASG auto-replacement analogue — except a
    TPU slice is atomic, so replacement = re-acquire the whole slice).
    """

    def __init__(self, *, steps_to_provision: int = 2, fail_creation: bool = False,
                 state_file: str | None = None):
        """``state_file`` persists cluster records to disk so separate CLI
        invocations (create-stack, then launch, then delete) share state —
        the role the CFN service's own database played for the reference."""
        self.steps_to_provision = steps_to_provision
        self.fail_creation = fail_creation
        self._clusters: dict[str, ClusterRecord] = {}
        self._pending: dict[str, int] = {}
        self._gen = itertools.count(1)
        self.events: list[tuple[str, str]] = []  # (cluster, event) audit log
        self._state_file = state_file
        self._in_txn = False
        # Guards _in_txn/_clusters for threads sharing one instance; the
        # flock serializes across processes, this across threads.  RLock
        # so describe() inside a same-thread transaction doesn't deadlock.
        self._ilock = threading.RLock()
        if state_file:
            self._load()

    # -- persistence -----------------------------------------------------
    #
    # Concurrent CLI invocations (e.g. a health-monitor loop racing a user
    # resize) serialize on an flock'd sidecar: every mutation is a full
    # read-modify-write transaction under the lock (reload state, apply,
    # write), so no invocation can lose another's update.  Writes are
    # atomic (tmp + rename) so lock-free readers never observe a torn
    # JSON — the control-plane-race concern from SURVEY.md §5.

    @contextlib.contextmanager
    def _locked(self):
        import fcntl
        from pathlib import Path

        lock_path = Path(self._state_file).with_suffix(".lock")
        lock_path.parent.mkdir(parents=True, exist_ok=True)
        with open(lock_path, "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(lk, fcntl.LOCK_UN)

    @contextlib.contextmanager
    def _transaction(self):
        """Critical section for mutations: reload → mutate → persist,
        all under one flock, so concurrent processes (kill-host racing
        heal, monitor racing resize) serialize instead of last-writer-
        wins over a stale in-memory copy."""
        if not self._state_file:
            with self._ilock:  # memory-only instances still serialize
                yield
            return
        with self._ilock, self._locked():
            self._load_unlocked()
            self._in_txn = True
            try:
                yield
            finally:
                self._in_txn = False
            self._save_unlocked()

    def _load_unlocked(self) -> None:
        import json
        from pathlib import Path

        p = Path(self._state_file)
        if not p.exists():
            return
        raw = json.loads(p.read_text())
        self._clusters = {}
        for name, rec in raw.get("clusters", {}).items():
            self._clusters[name] = ClusterRecord(
                spec=ClusterSpec.from_json(rec["spec"]),
                state=ClusterState(rec["state"]),
                hosts=[HostRecord(**h) for h in rec["hosts"]],
                generation=rec["generation"],
                message=rec.get("message", ""),
            )
        self._pending = dict(raw.get("pending", {}))
        self._gen = itertools.count(raw.get("next_gen", 1))

    def _load(self) -> None:
        with self._locked():
            self._load_unlocked()

    def _save_unlocked(self) -> None:
        import dataclasses as dc
        import json
        from pathlib import Path

        next_gen = next(self._gen)  # peek (consumes; re-prime below)
        self._gen = itertools.count(next_gen)
        data = {
            "clusters": {
                name: {
                    "spec": rec.spec.to_json(),
                    "state": rec.state.value,
                    "hosts": [dc.asdict(h) for h in rec.hosts],
                    "generation": rec.generation,
                    "message": rec.message,
                }
                for name, rec in self._clusters.items()
            },
            "pending": self._pending,
            "next_gen": next_gen,
        }
        p = Path(self._state_file)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_suffix(".tmp")
        tmp.write_text(json.dumps(data, indent=2))
        tmp.replace(p)

    # -- ControlPlane ----------------------------------------------------

    def create(self, spec: ClusterSpec) -> ClusterRecord:
        with self._transaction():
            existing = self._clusters.get(spec.name)
            if existing is not None and existing.state not in (
                ClusterState.DELETED,
                ClusterState.FAILED,
            ):
                raise ValueError(f"cluster {spec.name!r} already exists ({existing.state.value})")
            rec = ClusterRecord(spec=spec, state=ClusterState.QUEUED, hosts=[],
                                generation=next(self._gen))
            self._clusters[spec.name] = rec
            self._pending[spec.name] = self.steps_to_provision
            self.events.append((spec.name, "create"))
        return rec

    def describe(self, name: str) -> ClusterRecord:
        # Long-lived readers (health monitors) must see other processes'
        # writes; inside a transaction the state was just reloaded.
        with self._ilock:
            if self._state_file and not self._in_txn:
                self._load()
            if name not in self._clusters:
                raise KeyError(f"no cluster named {name!r}")
            return self._clusters[name]

    def delete(self, name: str) -> None:
        with self._transaction():
            rec = self.describe(name)
            rec.state = ClusterState.DELETED
            rec.hosts = []
            self._pending.pop(name, None)
            self.events.append((name, "delete"))

    def tick(self) -> None:
        with self._transaction():
            for name, rec in self._clusters.items():
                if rec.state in (ClusterState.QUEUED, ClusterState.PROVISIONING):
                    left = self._pending.get(name, 0) - 1
                    self._pending[name] = left
                    if left > 0:
                        rec.state = ClusterState.PROVISIONING
                    elif self.fail_creation:
                        rec.state = ClusterState.FAILED
                        rec.message = "no capacity for requested topology"
                        self.events.append((name, "failed"))
                    else:
                        rec.state = ClusterState.ACTIVE
                        rec.hosts = [
                            HostRecord(host_id=i, address=f"10.0.0.{i + 1}:8471")
                            for i in range(rec.spec.num_hosts)
                        ]
                        self.events.append((name, "active"))

    def kill_host(self, name: str, host_id: int) -> None:
        with self._transaction():
            rec = self.describe(name)
            rec.hosts[host_id].healthy = False
            self.events.append((name, f"host{host_id}-died"))


WaitCallback = Callable[[ClusterRecord], None]
