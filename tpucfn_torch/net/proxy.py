"""Deterministic gray-failure injection: a TCP proxy that misbehaves
on schedule (ISSUE 15 tentpole, the injection half).

``ChaosEngine`` could always kill a process; until now it could not
make a *network* lie — a peer that is up but slow, stalled, trickling,
half-open, or gone in one direction only, which is how production TPU
fleets actually fail.  :class:`ChaosProxy` sits in front of any fleet
plane's port (input service, compile-artifact service) and forwards
traffic verbatim until a fault fires:

======================  =====================================================
fault kind              observable behavior
======================  =====================================================
``latency``             every forwarded chunk waits ``delay_s`` first
``throttle``            forwarding is rate-limited to ``rate_bps`` (a tiny
                        rate IS the trickle: bytes keep flowing, per-chunk
                        socket timeouts keep resetting, only an end-to-end
                        deadline notices)
``stall``               forwarding stops mid-stream, both sockets held OPEN
                        (the half-alive peer: no FIN, no RST, no bytes)
``partition``           one direction's bytes are silently dropped, the
                        other keeps flowing (asymmetric reachability)
``tear``                ``after_bytes`` more bytes are forwarded, then both
                        sides are closed — a frame torn mid-payload
``rst``                 connections are closed with SO_LINGER(0): the peer
                        sees ECONNRESET now, not a quiet FIN
======================  =====================================================

Determinism (the chaos plane's standing rule since ISSUE 4): every
unpinned choice — today only a ``tear``'s unspecified ``after_bytes``
— draws from a ``random.Random`` seeded by the schedule, faults fire
in schedule order off one injectable clock, and the resolved firing
timeline lands in :attr:`ChaosProxy.fired` for drills to assert on.
Same seed, same schedule ⇒ same fault timeline, bit for bit.

Two driving modes: a standalone seeded schedule (``tpucfn chaos proxy
--spec``), or slaved to a :class:`~tpucfn.ft.chaos.ChaosEngine` via
:meth:`ChaosProxy.inject` — the coordinator's ``net_*`` chaos ACTIONS
land here, so launch-level chaos specs schedule network faults exactly
like kills.

jax-free, stdlib only.
"""

from __future__ import annotations

import dataclasses
import json
import random
import socket
import struct
import threading
import time
from typing import Callable

NET_FAULT_KINDS = ("latency", "throttle", "stall", "partition", "tear",
                   "rst", "clear")

_DIRECTIONS = ("up", "down", "both")  # up: client->upstream

# Forwarding chunk; small enough that throttle/stall/tear act at
# sub-frame granularity (a torn frame is the point of `tear`).
_CHUNK = 16 * 1024
# Poll cadence for the pump loops and the fault scheduler — bounds how
# stale a fault decision can be, not any user-visible latency.
_POLL_S = 0.05


@dataclasses.dataclass(frozen=True)
class NetFault:
    """One scheduled network fault.  ``at_s`` is seconds since the
    proxy started (schedule mode; ignored under ``inject()``).
    ``duration_s`` bounds latency/throttle/stall/partition windows
    (0 = until cleared).  ``after_bytes`` arms ``tear``/``stall`` only
    after that many MORE bytes were forwarded in the fault's direction
    — the mid-stream precision the drills need (handshakes pass, the
    payload tears); ``None`` on a ``tear`` draws from the seeded RNG.
    ``clear`` lifts every active fault (scheduled recovery)."""

    kind: str
    at_s: float = 0.0
    duration_s: float = 0.0
    delay_s: float = 0.0       # latency
    rate_bps: float = 0.0      # throttle
    direction: str = "both"
    after_bytes: int | None = None  # tear / stall arming offset

    def __post_init__(self):
        if self.kind not in NET_FAULT_KINDS:
            raise ValueError(
                f"unknown net fault {self.kind!r}; one of {NET_FAULT_KINDS}")
        if self.direction not in _DIRECTIONS:
            raise ValueError(
                f"bad direction {self.direction!r}; one of {_DIRECTIONS}")
        if self.kind == "throttle" and self.rate_bps <= 0:
            raise ValueError("throttle needs rate_bps > 0")
        if self.kind == "latency" and self.delay_s <= 0:
            raise ValueError("latency needs delay_s > 0")

    def to_json(self) -> dict:
        out = {"kind": self.kind, "at_s": self.at_s}
        if self.duration_s:
            out["duration_s"] = self.duration_s
        if self.delay_s:
            out["delay_s"] = self.delay_s
        if self.rate_bps:
            out["rate_bps"] = self.rate_bps
        if self.direction != "both":
            out["direction"] = self.direction
        if self.after_bytes is not None:
            out["after_bytes"] = self.after_bytes
        return out


@dataclasses.dataclass(frozen=True)
class NetFaultSchedule:
    faults: tuple[NetFault, ...]
    seed: int = 0

    @classmethod
    def from_json(cls, obj: str | dict) -> "NetFaultSchedule":
        if isinstance(obj, str):
            obj = json.loads(obj)
        return cls(faults=tuple(NetFault(**f) for f in obj.get("faults", ())),
                   seed=int(obj.get("seed", 0)))

    def to_json(self) -> dict:
        return {"seed": self.seed,
                "faults": [f.to_json() for f in self.faults]}


class _FaultState:
    """The proxy-wide active-fault picture the pump threads consult.
    All mutation under one lock; reads snapshot the fields they need
    (a pump must never sleep holding it)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.latency_s = 0.0
        self.latency_until: float | None = None   # None = inactive
        self.rate_bps = 0.0
        self.rate_until: float | None = None
        self.stall_until: float | None = None     # inf = until cleared
        self.stall_dir = "both"
        self.stall_after: int | None = None       # arm at this fwd-bytes mark
        self.partition_until: float | None = None
        self.partition_dir = "both"
        # tear is ONE-SHOT: cut at this forwarded-bytes mark, then the
        # state self-clears (a fired tear must not kill every later
        # connection at birth)
        self.tear_at: int | None = None
        self.tear_dir = "both"

    def clear(self):
        with self.lock:
            self.latency_until = None
            self.rate_until = None
            self.stall_until = None
            self.stall_after = None
            self.partition_until = None
            self.tear_at = None


class ChaosProxy:
    """A misbehaving-on-schedule TCP forwarder in front of one
    upstream ``host:port``.  Start it, point clients at
    :attr:`address`, and inject gray failures — from the seeded
    schedule, or programmatically via :meth:`inject` (the
    :class:`~tpucfn.ft.chaos.ChaosEngine` path)."""

    def __init__(self, upstream: str, *, host: str = "127.0.0.1",
                 port: int = 0, schedule: NetFaultSchedule | None = None,
                 registry=None,
                 connect_timeout_s: float = 5.0,
                 io_timeout_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        up_host, _, up_port = upstream.rpartition(":")
        self.upstream = (up_host or "127.0.0.1", int(up_port))
        self._bind_host = host
        self._bind_port = port
        self.schedule = schedule
        self.rng = random.Random(schedule.seed if schedule is not None else 0)
        self.connect_timeout_s = connect_timeout_s
        self.io_timeout_s = io_timeout_s
        self.clock = clock
        self.state = _FaultState()
        self._fwd_bytes = {"up": 0, "down": 0}  # forwarded, under state.lock
        self.fired: list[dict] = []  # resolved fault timeline (audit trail)
        self._pending = list(schedule.faults) if schedule is not None else []
        self._conns: list["_Conn"] = []
        self._lock = threading.Lock()
        self._closed = threading.Event()
        self._t0: float | None = None
        self._sock: socket.socket | None = None
        self._threads: list[threading.Thread] = []
        if registry is not None:
            self.conns_c = registry.counter(
                "net_proxy_connections_total", "connections proxied")
            self.fired_c = registry.counter(
                "net_proxy_faults_fired_total", "scheduled faults fired")
            self.bytes_c = registry.counter(
                "net_proxy_forwarded_bytes_total", "bytes forwarded")
            self.dropped_c = registry.counter(
                "net_proxy_dropped_bytes_total",
                "bytes dropped by a one-way partition")
        else:
            from tpucfn_torch.obs.metrics import Counter

            # private instruments (non-fleet use falls back to bare
            # counters; names still registry-shaped for the audit dict)
            self.conns_c = Counter()
            self.fired_c = Counter()
            self.bytes_c = Counter()
            self.dropped_c = Counter()

    # -- lifecycle ---------------------------------------------------------

    @property
    def port(self) -> int:
        if self._sock is None:
            raise RuntimeError("proxy not started")
        return self._sock.getsockname()[1]

    @property
    def address(self) -> str:
        return f"{self._bind_host}:{self.port}"

    def start(self) -> "ChaosProxy":
        if self._sock is not None:
            return self
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self._bind_host, self._bind_port))
        s.listen(32)
        # Polling accept (the PR 11 lesson: close() does not wake a
        # blocked accept on Linux).
        s.settimeout(0.25)
        self._sock = s
        self._t0 = self.clock()
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name="tpucfn-chaosproxy-accept")
        t.start()
        self._threads.append(t)
        if self._pending:
            ts = threading.Thread(target=self._schedule_loop, daemon=True,
                                  name="tpucfn-chaosproxy-sched")
            ts.start()
            self._threads.append(ts)
        return self

    def close(self) -> None:
        self._closed.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            c.close()
        for t in self._threads:
            t.join(timeout=5)
        self._threads.clear()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    # -- fault surface -----------------------------------------------------

    def inject(self, kind: str, *, duration_s: float = 0.0,
               delay_s: float = 0.0, rate_bps: float = 0.0,
               direction: str = "both",
               after_bytes: int | None = None) -> dict:
        """Apply one fault NOW — the ChaosEngine-slaved form (the
        ``net_*`` chaos ACTIONS land here); schedule-mode firings go
        through the same path so the two modes cannot drift."""
        fault = NetFault(kind=kind, duration_s=duration_s, delay_s=delay_s,
                         rate_bps=rate_bps, direction=direction,
                         after_bytes=after_bytes)
        return self._apply(fault)

    def clear(self) -> None:
        """Lift every active fault (pass-through resumes)."""
        self.state.clear()

    def _apply(self, f: NetFault) -> dict:
        st = self.state
        now = self.clock()
        until = (now + f.duration_s) if f.duration_s > 0 else float("inf")
        resolved: dict = {"kind": f.kind, "direction": f.direction,
                          "elapsed_s": round(now - (self._t0 or now), 4)}
        with st.lock:
            if f.kind == "latency":
                st.latency_s = f.delay_s
                st.latency_until = until
                resolved["delay_s"] = f.delay_s
            elif f.kind == "throttle":
                st.rate_bps = f.rate_bps
                st.rate_until = until
                resolved["rate_bps"] = f.rate_bps
            elif f.kind == "stall":
                st.stall_until = until
                st.stall_dir = f.direction
                if f.after_bytes is not None:
                    st.stall_after = (self._fwd(f.direction)
                                      + int(f.after_bytes))
                    resolved["after_bytes"] = int(f.after_bytes)
                else:
                    st.stall_after = None
            elif f.kind == "partition":
                st.partition_until = until
                st.partition_dir = f.direction
            elif f.kind == "tear":
                n = f.after_bytes if f.after_bytes is not None \
                    else self.rng.randrange(1, 64)
                st.tear_at = self._fwd(f.direction) + int(n)
                st.tear_dir = f.direction
                resolved["after_bytes"] = int(n)
            elif f.kind == "rst":
                pass  # one-shot: applied to live connections below
            elif f.kind == "clear":
                pass  # handled below, outside the lock
        if f.kind == "clear":
            st.clear()
        if f.kind == "rst":
            self._rst_all()
        self.fired_c.add()
        self.fired.append(resolved)
        return resolved

    def _fwd(self, direction: str) -> int:
        # caller holds state.lock
        if direction == "up":
            return self._fwd_bytes["up"]
        if direction == "down":
            return self._fwd_bytes["down"]
        return self._fwd_bytes["up"] + self._fwd_bytes["down"]

    def _rst_all(self) -> None:
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            c.reset()

    # -- loops -------------------------------------------------------------

    def _schedule_loop(self) -> None:
        assert self._t0 is not None
        while not self._closed.is_set() and self._pending:
            elapsed = self.clock() - self._t0
            due = [f for f in self._pending if elapsed >= f.at_s]
            if due:
                self._pending = [f for f in self._pending
                                 if elapsed < f.at_s]
                # schedule order: seeded draws must resolve identically
                # run to run
                for f in sorted(due, key=lambda f: f.at_s):
                    self._apply(f)
            time.sleep(_POLL_S / 2)

    def _accept_loop(self) -> None:
        assert self._sock is not None
        while not self._closed.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(self.io_timeout_s)
            self.conns_c.add()
            with self._lock:
                self._conns = [c for c in self._conns if not c.dead]
                self._conns.append(_Conn(self, conn))


class _Conn:
    """One proxied connection: two pump threads (client→upstream and
    upstream→client) consulting the shared fault state per chunk."""

    def __init__(self, proxy: ChaosProxy, client: socket.socket):
        self.proxy = proxy
        self.client = client
        self.dead = False
        self._lock = threading.Lock()
        self.up: socket.socket | None = None
        try:
            up = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            up.settimeout(proxy.connect_timeout_s)
            up.connect(proxy.upstream)
            up.settimeout(proxy.io_timeout_s)
            self.up = up
        except OSError:
            self.close()
            return
        for src, dst, direction in ((client, up, "up"), (up, client, "down")):
            threading.Thread(
                target=self._pump, args=(src, dst, direction),
                daemon=True, name=f"tpucfn-chaosproxy-{direction}").start()

    def close(self) -> None:
        with self._lock:
            self.dead = True
        for s in (self.client, self.up):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass

    def reset(self) -> None:
        """Close with SO_LINGER(0): the client (and upstream) see an
        RST — ECONNRESET — instead of a graceful FIN."""
        for s in (self.client, self.up):
            if s is not None:
                try:
                    s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                 struct.pack("ii", 1, 0))
                except OSError:
                    pass
        self.close()

    # -- the per-chunk fault gauntlet --------------------------------------

    def _pump(self, src: socket.socket, dst: socket.socket,
              direction: str) -> None:
        proxy = self.proxy
        try:
            while not self.dead and not proxy._closed.is_set():
                # A stall must also stop READING: the upstream's own
                # sendall then backpressures exactly like a real wedged
                # peer (bytes neither drained nor acked away).
                if self._stalled(direction):
                    time.sleep(_POLL_S)
                    continue
                src.settimeout(_POLL_S)
                try:
                    data = src.recv(_CHUNK)
                except socket.timeout:
                    continue
                except OSError:
                    return
                if not data:
                    # half-close: forward the FIN, keep the other
                    # direction pumping
                    try:
                        dst.shutdown(socket.SHUT_WR)
                    except OSError:
                        pass
                    return
                if not self._forward(dst, direction, data):
                    self.close()  # broken pipe or a fired tear: all done
                    return
        finally:
            if self.dead or proxy._closed.is_set():
                self.close()

    def _stalled(self, direction: str) -> bool:
        st = self.proxy.state
        now = self.proxy.clock()
        with st.lock:
            if st.stall_until is None or now >= st.stall_until:
                return False
            if st.stall_dir not in (direction, "both"):
                return False
            if st.stall_after is not None \
                    and self.proxy._fwd(st.stall_dir) < st.stall_after:
                return False  # not armed yet: the marker bytes still flow
            return True

    def _forward(self, dst: socket.socket, direction: str,
                 data: bytes) -> bool:
        """Apply latency / throttle / partition / tear to one chunk,
        then forward.  False ends the pump (tear fired, or peer gone)."""
        proxy = self.proxy
        st = proxy.state
        # A pump blocked in recv when the stall fired still lands here
        # with a chunk in hand: hold it (connection open, nothing
        # forwarded) until the stall lifts — without this gate the
        # first post-stall chunk slips through.
        while self._stalled(direction) and not self.dead \
                and not proxy._closed.is_set():
            time.sleep(_POLL_S)
        now = proxy.clock()
        with st.lock:
            delay = st.latency_s if (st.latency_until is not None
                                     and now < st.latency_until) else 0.0
            rate = st.rate_bps if (st.rate_until is not None
                                   and now < st.rate_until) else 0.0
            partitioned = (st.partition_until is not None
                           and now < st.partition_until
                           and st.partition_dir in (direction, "both"))
            tear_at = st.tear_at if (st.tear_at is not None
                                     and st.tear_dir in (direction, "both")) \
                else None
            fwd = proxy._fwd(st.tear_dir) if tear_at is not None else 0
        if partitioned:
            proxy.dropped_c.add(len(data))
            with st.lock:
                # dropped bytes still count as "consumed" for tear/stall
                # arming: the schedule is in wire bytes, not luck
                proxy._fwd_bytes[direction] += len(data)
            return True
        if delay > 0:
            self._nap(delay)
        budget = None
        if tear_at is not None:
            budget = max(0, tear_at - fwd)
            data = data[:budget]
        view = memoryview(data)
        off = 0
        while off < len(view):
            if self.dead or proxy._closed.is_set():
                # an unbounded stall must not outlive the proxy: without
                # this check a pump holding a mid-chunk remainder spins
                # here forever after close() (close does not join pumps)
                return False
            if self._stalled(direction):
                # a stall armed mid-chunk (after_bytes landed inside
                # this chunk): hold the remainder, connection open
                time.sleep(_POLL_S)
                continue
            n = len(view) - off
            if rate > 0:
                # trickle: at most rate * tick bytes per tick, so the
                # receiver sees a continuous dribble (each chunk resets
                # a naive per-chunk timeout — the hole deadlines close)
                n = min(n, max(1, int(rate * _POLL_S)))
            with st.lock:
                if (st.stall_until is not None
                        and proxy.clock() < st.stall_until
                        and st.stall_dir in (direction, "both")
                        and st.stall_after is not None):
                    # a byte-armed stall must never be overshot by a
                    # large chunk: cap the slice at the threshold, so
                    # the next iteration's gate holds exactly there
                    gap = st.stall_after - proxy._fwd(st.stall_dir)
                    if gap <= 0:
                        continue  # armed: the gate above takes over
                    n = min(n, gap)
            try:
                dst.settimeout(proxy.io_timeout_s)
                sent = dst.send(view[off:off + n])
            except OSError:
                return False
            off += sent
            proxy.bytes_c.add(sent)
            with st.lock:
                proxy._fwd_bytes[direction] += sent
            if rate > 0 and off < len(view):
                self._nap(_POLL_S)
        if budget is not None:
            with st.lock:
                done = (st.tear_at is not None
                        and proxy._fwd(st.tear_dir) >= st.tear_at)
                if done:
                    st.tear_at = None  # one-shot: later connections live
            if done:
                self.close()  # torn frame, then a plain close
                return False
        return True

    def _nap(self, seconds: float) -> None:
        """Sleep in poll-sized slices so close() is honored promptly."""
        end = self.proxy.clock() + seconds
        while not self.dead and not self.proxy._closed.is_set():
            rem = end - self.proxy.clock()
            if rem <= 0:
                return
            time.sleep(min(_POLL_S, rem))
