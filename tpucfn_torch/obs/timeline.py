"""The clock probe of the fleet timeline (copies of ``ClockProbe`` and
``probe_clock`` from ``tpucfn/obs/timeline.py``, held equal to them by
``tests/test_torch_isolation.py``).

The gang coordinator probes every live rank's obs ``/clock`` route on a
cadence and appends the offsets to ``<ft_dir>/clock-offsets.jsonl``.
The merged timeline, critical path and exports that read them are not
ported (ROADMAP A9).
"""

from __future__ import annotations

import dataclasses
import json
import time
import urllib.request
from typing import Callable


@dataclasses.dataclass(frozen=True)
class ClockProbe:
    """One offset measurement of a host's wall clock.

    ``offset_s`` is positive when the probed host's clock runs AHEAD of
    the prober's — the same sign convention as the step-anchored
    estimator's skew, so ``ts - offset`` maps the host's timestamps
    onto the prober's clock.  ``unc_s`` is the RTT/2 bound: the true
    offset lies within ``offset_s ± unc_s`` (the server's wall read
    happened somewhere inside the round trip)."""

    host: int
    role: str
    offset_s: float
    unc_s: float
    rtt_s: float


def probe_clock(url: str, *,
                fetch: Callable[[str], dict] | None = None,
                mono: Callable[[], float] = time.monotonic,
                wall: Callable[[], float] = time.time,
                timeout_s: float = 2.0) -> ClockProbe:
    """One NTP-style probe of ``GET /clock`` at ``url``.

    The server's single wall read is bracketed between two local
    clock reads; assuming symmetric network halves, the server read
    happened at the local midpoint, so the offset is
    ``server_wall - local_wall_midpoint`` and the worst-case
    asymmetry error is RTT/2.  ``fetch``/``mono``/``wall`` are
    injectable so the estimator tests with synthetic clocks and zero
    sockets."""
    if fetch is None:
        def fetch(u: str) -> dict:
            with urllib.request.urlopen(u, timeout=timeout_s) as r:
                return json.loads(r.read().decode())
    m0, w0 = mono(), wall()
    body = fetch(url)
    m1 = mono()
    rtt = max(0.0, m1 - m0)
    # local wall at the bracket midpoint, reconstructed from the one
    # wall read plus monotonic deltas (immune to a wall step mid-probe)
    local_mid = w0 + rtt / 2.0
    server_wall = float(body["wall"])
    return ClockProbe(host=body.get("host_id"),
                      role=str(body.get("role") or ""),
                      offset_s=server_wall - local_mid,
                      unc_s=rtt / 2.0,
                      rtt_s=rtt)
