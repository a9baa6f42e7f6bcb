"""Provisioner — the ``create-stack`` / ``update-stack`` state machine.

Reproduces the reference's stack lifecycle (SURVEY.md §3.1, §3.5) on TPU
semantics:

* ``create`` ≈ ``aws cloudformation create-stack``: submit to the control
  plane, wait for ACTIVE (the WaitCondition analogue — creation isn't
  "done" until every host is up), then run bootstrap to converge the env
  contract.
* ``resize`` ≈ ``update-stack WorkerCount=M``: TPU slices are atomic, so
  resize = delete + re-create at the new accelerator + leave resume to
  the launcher (checkpoint-based, SURVEY.md §7.4 item 2). The handle's
  ``generation`` fences stale writers after a re-acquire.
* ``monitor`` ≈ the ASG health loop: detects dead hosts; since the slice
  is atomic the remedy is re-acquire, not per-host replace.
"""

from __future__ import annotations

import time

from tpucfn_torch.provision.control_plane import (
    ClusterRecord,
    ClusterState,
    ControlPlane,
)
from tpucfn_torch.spec import ClusterSpec


class ProvisioningError(RuntimeError):
    pass


class Provisioner:
    def __init__(self, control_plane: ControlPlane, *, poll_interval: float = 0.0,
                 timeout: float = 600.0):
        self.cp = control_plane
        self.poll_interval = poll_interval
        self.timeout = timeout

    def create(self, spec: ClusterSpec) -> ClusterRecord:
        self.cp.create(spec)
        return self.wait_active(spec.name)

    def wait_active(self, name: str) -> ClusterRecord:
        """The WaitCondition: block until every host has signaled (ACTIVE)
        or creation failed. The reference gated CREATE_COMPLETE on N+1
        cfn-signal calls; the control plane's ACTIVE state is the same
        all-hosts-ready barrier."""
        deadline = time.monotonic() + self.timeout
        while True:
            self.cp.tick()
            rec = self.cp.describe(name)
            if rec.state is ClusterState.ACTIVE:
                return rec
            if rec.state is ClusterState.FAILED:
                raise ProvisioningError(f"cluster {name!r} failed: {rec.message}")
            if rec.state in (ClusterState.DELETING, ClusterState.DELETED):
                raise ProvisioningError(f"cluster {name!r} was deleted while waiting")
            if time.monotonic() > deadline:
                raise ProvisioningError(
                    f"cluster {name!r} stuck in {rec.state.value} past "
                    f"{self.timeout}s (WaitCondition timeout)"
                )
            if self.poll_interval:
                time.sleep(self.poll_interval)

    def delete(self, name: str) -> None:
        self.cp.delete(name)

    def resize(self, name: str, accelerator: str) -> ClusterRecord:
        """Re-acquire at a new topology. Training jobs resume from their
        latest checkpoint via the launcher; nothing here migrates live
        state (there is none to migrate — slices are not elastic)."""
        old = self.cp.describe(name)
        import dataclasses

        new_spec = dataclasses.replace(old.spec, accelerator=accelerator)
        self.cp.delete(name)
        self.cp.create(new_spec)
        return self.wait_active(name)

    def unhealthy_hosts(self, name: str) -> list[int]:
        rec = self.cp.describe(name)
        return [h.host_id for h in rec.hosts if not h.healthy]

    def ensure_healthy(self, name: str) -> ClusterRecord:
        """Health monitor step: if any host died, re-acquire the slice
        (generation bumps so resumed jobs can fence stale writers)."""
        rec = self.cp.describe(name)
        if rec.state is ClusterState.ACTIVE and not self.unhealthy_hosts(name):
            return rec
        spec = rec.spec
        self.cp.delete(name)
        self.cp.create(spec)
        return self.wait_active(name)
