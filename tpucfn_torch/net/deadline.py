"""End-to-end deadlines + jittered retry for the fleet TCP planes.

The gray-failure lesson (ISSUE 15): per-chunk socket timeouts bound
*idle* peers, not *slow* ones.  ``recv_frame`` loops call ``recv`` per
chunk with the socket's timeout, so a trickling peer delivering 1 byte
per ``recv_timeout_s`` resets the clock forever — the op never times
out, and a production trainer sits minutes behind a peer that is up
but useless.  A :class:`Deadline` is the end-to-end budget composed
OVER those per-chunk timeouts: each chunk's socket timeout becomes
``min(chunk budget, deadline remaining)``, so the whole operation —
however many chunks, however slow each one — finishes or fails inside
one bound.

:class:`DeadlineExceeded` subclasses :class:`OSError` deliberately:
every plane already treats ``OSError`` as "transport failed — fail
over, then degrade", so an expired deadline rides the exact same
recovery path as a dead peer (latency cost, never correctness), while
still being distinguishable where a plane wants to count it.

:class:`RetryPolicy` is the one jittered-backoff loop the planes
share, replacing the hand-rolled fixed-interval retry/poll loops that
each plane had grown independently; :class:`NetMetrics` is the
``net_<plane>_*`` counter family the goodput/degradation story reads.

jax-free, stdlib only — input hosts and the coordinator import it.
"""

from __future__ import annotations

import random
import socket
import time
from typing import Callable, Iterator

# Server-side sends are chunked at this size when a deadline is
# attached, so a stalled receiver is noticed at chunk granularity
# instead of wherever the kernel happened to block inside one sendall.
SEND_CHUNK_BYTES = 64 * 1024


class DeadlineExceeded(OSError):
    """An end-to-end operation deadline expired mid-operation.

    An :class:`OSError` on purpose — see the module docstring: the
    planes' existing transport-failure handling (failover → degrade to
    local) is exactly the right response, so the type slots into every
    ``except OSError`` that already exists."""


class Deadline:
    """A fixed point in (injectable) monotonic time every chunk of a
    multi-step operation is measured against.

    Unlike a per-chunk timeout, the remaining budget only shrinks:
    ``timeout()`` hands each socket operation ``min(remaining, cap)``
    and raises :class:`DeadlineExceeded` once nothing is left — which
    is what makes a trickling peer time out in bounded time."""

    __slots__ = ("t_end", "clock", "label")

    def __init__(self, seconds: float, *,
                 clock: Callable[[], float] = time.monotonic,
                 label: str = ""):
        self.clock = clock
        self.t_end = clock() + float(seconds)
        self.label = label

    @classmethod
    def at(cls, t_end: float, *,
           clock: Callable[[], float] = time.monotonic,
           label: str = "") -> "Deadline":
        """A deadline at an absolute clock() value — for windows
        anchored somewhere earlier than the call site (e.g. the input
        client's startup connect-retry window, measured from stream
        construction, not from the current retry round)."""
        d = cls(0.0, clock=clock, label=label)
        d.t_end = float(t_end)
        return d

    def remaining(self) -> float:
        return self.t_end - self.clock()

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def check(self, what: str = "") -> None:
        if self.expired():
            raise DeadlineExceeded(self._msg(what))

    def timeout(self, *, cap: float | None = None, floor: float = 1e-3,
                what: str = "") -> float:
        """The socket timeout for the NEXT chunk of the operation:
        the remaining budget (optionally capped), floored so a nearly
        spent deadline still sets a positive timeout instead of
        flipping the socket to non-blocking.  Raises once spent."""
        rem = self.remaining()
        if rem <= 0.0:
            raise DeadlineExceeded(self._msg(what))
        if cap is not None:
            rem = min(rem, cap)
        return max(floor, rem)

    def _msg(self, what: str) -> str:
        tag = f" {self.label}" if self.label else ""
        op = f" during {what}" if what else ""
        return f"deadline{tag} exceeded{op}"


def sendall_deadline(sock: socket.socket, data: bytes | memoryview,
                     deadline: Deadline | None, *,
                     chunk: int = SEND_CHUNK_BYTES) -> None:
    """``sock.sendall(data)`` bounded by an end-to-end deadline.

    ``sendall`` under a plain socket timeout has the same trickle hole
    as ``recv`` loops — a receiver draining one window per timeout
    keeps it alive forever, pinning the sender (and everything queued
    behind it) indefinitely.  Chunked sends re-arm the per-chunk
    timeout from the deadline's shrinking remainder, so a stalled or
    trickling receiver fails the send inside the bound."""
    if deadline is None:
        sock.sendall(data)
        return
    view = memoryview(bytes(data) if not isinstance(data, (bytes, memoryview))
                      else data)
    off = 0
    while off < len(view):
        sock.settimeout(deadline.timeout(what="send"))
        try:
            off += sock.send(view[off:off + chunk])
        except socket.timeout:
            raise DeadlineExceeded(deadline._msg("send")) from None


class RetryPolicy:
    """Jittered exponential backoff — the one retry loop the fleet
    planes share (ISSUE 15 replaces each plane's hand-rolled
    fixed-interval loop with this).

    Deterministic on purpose: jitter draws from a seeded
    ``random.Random``, so a drill replays the same delays; ``clock``
    and ``sleep`` are injectable so policy tests run with zero real
    sleeping (the same convention as the coordinator)."""

    def __init__(self, *, max_attempts: int | None = None,
                 base_s: float = 0.25, multiplier: float = 2.0,
                 max_s: float = 5.0, jitter: float = 0.25,
                 seed: int = 0,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        if base_s <= 0 or multiplier < 1.0 or max_s < base_s:
            raise ValueError(
                f"need base_s > 0, multiplier >= 1, max_s >= base_s; got "
                f"base_s={base_s}, multiplier={multiplier}, max_s={max_s}")
        if not 0.0 <= jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {jitter}")
        self.max_attempts = max_attempts
        self.base_s = base_s
        self.multiplier = multiplier
        self.max_s = max_s
        self.jitter = jitter
        self.rng = random.Random(seed)
        self.clock = clock
        self.sleep = sleep

    def backoff_s(self, attempt: int) -> float:
        """Delay before attempt ``attempt + 1`` (attempt 0 never
        waits): capped exponential, +/- ``jitter`` fraction."""
        d = min(self.max_s, self.base_s * self.multiplier ** attempt)
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * self.rng.random() - 1.0)
        return d

    def attempts(self, *, deadline: Deadline | None = None,
                 metrics: "NetMetrics | None" = None,
                 sleep_first: bool = False) -> Iterator[int]:
        """Yield attempt indices, sleeping the backoff between them.

        Stops (raising :class:`StopIteration` out of the ``for``, not
        an error — retry exhaustion is the CALLER's decision to
        surface) when ``max_attempts`` runs out or the ``deadline``
        expires; a sleep never overshoots the deadline's remainder.
        ``sleep_first`` backs off before the first yield too — the
        poll-until-published shape, where attempt 0 already failed at
        the call site."""
        a = 0
        while True:
            if self.max_attempts is not None and a >= self.max_attempts:
                return
            if a > 0 or sleep_first:
                d = self.backoff_s(a if sleep_first else a - 1)
                if deadline is not None:
                    rem = deadline.remaining()
                    if rem <= 0.0:
                        return
                    d = min(d, rem)
                if metrics is not None:
                    if a > 0:
                        metrics.retries_c.add()
                    metrics.backoff_c.add(d)
                self.sleep(d)
                if deadline is not None and deadline.expired():
                    return
            yield a
            a += 1


class NetMetrics:
    """The ``net_<plane>_*`` counter family, one instance per fleet
    plane ('input', 'compilecache').  A fixed, small plane set — the
    plane name is a call-site constant, never fleet-scaled (the
    registry-cardinality rule's line)."""

    def __init__(self, registry, plane: str):
        self.plane = plane
        self.deadline_exceeded_c = registry.counter(
            f"net_{plane}_deadline_exceeded_total",
            "ops that hit their end-to-end deadline on this plane "
            "(stalled/trickling peer — degraded, never waited out)")
        self.retries_c = registry.counter(
            f"net_{plane}_retries_total",
            "op retries taken by the shared RetryPolicy on this plane")
        self.backoff_c = registry.counter(
            f"net_{plane}_backoff_seconds_total",
            "seconds spent sleeping in retry backoff on this plane")
