"""Shared fleet-transport hardening (ISSUE 15).

Every fleet TCP plane — the input service, the compile-artifact
service — speaks through this package's two halves:

* :mod:`tpucfn.net.deadline` — an end-to-end :class:`Deadline`
  composed over per-chunk socket timeouts (a trickling peer can no
  longer reset the clock one byte at a time), one jittered-backoff
  :class:`RetryPolicy` shared by every plane's retry loop, and the
  ``net_*`` metric family.
* :mod:`tpucfn.net.proxy` — a deterministic fault-injection TCP proxy
  (:class:`ChaosProxy`, ``tpucfn chaos proxy``) that sits in front of
  any plane's port and injects gray failures from a seeded schedule:
  latency, throttle/trickle, mid-stream stall with the connection held
  open, one-way partition, torn-frame-then-close, RST.

jax-free on purpose: input hosts, the coordinator, the supervise loop,
and the analyzer all sit on top of it.
"""

from tpucfn_torch.net.deadline import (  # noqa: F401
    Deadline,
    DeadlineExceeded,
    NetMetrics,
    RetryPolicy,
    sendall_deadline,
)
from tpucfn_torch.net.proxy import (  # noqa: F401
    NET_FAULT_KINDS,
    ChaosProxy,
    NetFault,
    NetFaultSchedule,
)
