"""Fleet distribution plane for compiled XLA artifacts.

A jax-free artifact server (run by host 0, an input-role host, or the
``tpucfn launch --compile-cache`` coordinator process) plus the client
trainers/serve replicas consult before compiling.  Reuses the PR 11
input-plane framing (:mod:`tpucfn.data.service` — length-prefixed
frames over TCP) under its own magic, with the same design rules:

* **handshake validates identity** — a client whose device_kind or jax
  version disagrees with the fleet's is refused loudly (an executable
  serialized for v5e under jax X must never be deserialized on
  different hardware or a different compiler); the server pins the
  fleet identity from its flags or from the first client.
* **single-flight on a cold fleet** — ``claim`` hands exactly one
  client the right to compile a key; everyone else polls ``get`` until
  the publish lands (or their wait budget expires and they compile
  locally — correctness never waits on the network).
* **every transport failure degrades to local compile** — a dead
  server, a refused handshake, or a fetch torn mid-transfer costs
  startup latency, never correctness: the client falls back to
  compiling the exact same lowered program, so the run trajectory is
  bit-identical (pinned by test).

:class:`CompileCacheClient` is the jax-free orchestration of
local-store / fleet-fetch / single-flight-compile — compile and
(de)serialize are injected callables, which is what lets the
cold-fleet stampede tests race N clients with a counting fake compiler
and no jax in the process.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time
from pathlib import Path
from typing import Callable, Sequence

from tpucfn_torch.data.service import (
    ServiceError,
    recv_frame,
    recv_frame_ctx,
    send_frame,
)
from tpucfn_torch.net.deadline import (
    Deadline,
    DeadlineExceeded,
    NetMetrics,
    RetryPolicy,
)
from tpucfn_torch.compilecache.store import (
    ArtifactStore,
    CacheCorrupt,
    CacheMismatch,
    valid_key,
)

# -- env contract (fanned out by the launcher, ISSUE 13) --------------------

COMPILE_CACHE_ADDRS_ENV = "TPUCFN_COMPILE_CACHE_ADDRS"  # comma host:port
COMPILE_CACHE_DIR_ENV = "TPUCFN_COMPILE_CACHE_DIR"      # local store dir
DEFAULT_COMPILE_CACHE_PORT = 7741


def cache_addrs_from_env(env: dict | None = None) -> list[str]:
    import os

    e = os.environ if env is None else env
    raw = (e.get(COMPILE_CACHE_ADDRS_ENV) or "").strip()
    return [a for a in (s.strip() for s in raw.split(",")) if a]


# -- wire protocol ----------------------------------------------------------

CC_MAGIC = b"TPCC"  # tpucfn compile cache
# v2 (ISSUE 20): the shared frame header (see data.service._HEADER)
# grew three u64 trace-context fields — (trace_id, span_id, origin),
# all-zero = none.  The client injects its compile_fetch span context
# into the op frame; the server's artifact_serve span records it as
# its remote parent, which is what lets the merged fleet timeline draw
# the trainer-step -> artifact-fetch edge.
CC_PROTOCOL_VERSION = 2

# frame kinds (1 byte); HELLO/ERROR mirror the input plane's roles
CC_HELLO = b"H"    # client -> server: JSON identity handshake
CC_OK = b"O"       # server -> client: JSON ack (handshake / put / stats)
CC_ERROR = b"X"    # server -> client: utf-8 reason, connection is dead
CC_GET = b"G"      # client -> server: utf-8 key
CC_HIT = b"A"      # server -> client: meta+payload blob (see _pack_entry)
CC_MISS = b"N"     # server -> client: JSON {"claimed": bool}
CC_CLAIM = b"C"    # client -> server: utf-8 key (single-flight request)
CC_GRANTED = b"R"  # server -> client: this client owns the compile
CC_BUSY = b"B"     # server -> client: someone else is compiling it
CC_PUT = b"U"      # client -> server: meta+payload blob
CC_STAT = b"S"     # client -> server: empty; answered with CC_OK stats
CC_RELEASE = b"L"  # client -> server: utf-8 key (claim owner gives up)


def _pack_entry(meta: dict, payload: bytes) -> bytes:
    head = json.dumps(meta).encode()
    return struct.pack("<I", len(head)) + head + payload


def _unpack_entry(blob: bytes | bytearray) -> tuple[dict, bytes]:
    if len(blob) < 4:
        raise ServiceError("torn artifact blob (no meta length)")
    head_len, = struct.unpack_from("<I", blob, 0)
    if 4 + head_len > len(blob):
        raise ServiceError("torn artifact blob (truncated meta)")
    try:
        meta = json.loads(bytes(blob[4:4 + head_len]).decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ServiceError(f"undecodable artifact meta: {e}") from None
    if not isinstance(meta, dict):
        raise ServiceError("artifact meta is not an object")
    return meta, bytes(blob[4 + head_len:])


# -- the server -------------------------------------------------------------

class ArtifactServer:
    """Serves one :class:`ArtifactStore` to the fleet.

    jax-free: the coordinator or an input-role host runs it.  One
    thread per connection (connections are one-op and short-lived);
    claims are in-memory with an expiry so a claimer that died mid-
    compile frees the key for the next cold client.
    """

    def __init__(self, store_dir: str | Path, *, host: str = "0.0.0.0",
                 port: int = 0, device_kind: str | None = None,
                 jax_version: str | None = None,
                 claim_ttl_s: float = 600.0,
                 send_deadline_s: float = 60.0,
                 registry=None,
                 tracer=None,
                 clock: Callable[[], float] = time.monotonic):
        self.store = ArtifactStore(store_dir)
        self._bind_host = host
        self._bind_port = port
        # Fleet identity: from flags when given, else pinned to the
        # first client's handshake — after that, a disagreeing client
        # is refused (heterogeneous fleets need one server per kind).
        self.device_kind = device_kind
        self.jax_version = jax_version
        self.claim_ttl_s = claim_ttl_s
        # End-to-end bound on serving one response frame (ISSUE 15): an
        # artifact payload is tens of MB, and a stalled/trickling client
        # would otherwise pin this connection's thread for as long as
        # per-chunk timeouts keep resetting.
        self.send_deadline_s = float(send_deadline_s)
        # Fleet timeline (ISSUE 20): one ``artifact_serve`` span per op,
        # remote-parented on the requesting client's span context from
        # the op frame header (its compile_fetch span).
        self.tracer = tracer
        self.clock = clock
        self._claims: dict[str, float] = {}  # key -> expiry
        self._lock = threading.Lock()
        self._sock: socket.socket | None = None
        self._accept_thread: threading.Thread | None = None
        self._closed = threading.Event()
        if registry is None:
            from tpucfn_torch.obs.registry import MetricRegistry

            registry = MetricRegistry()
        self.registry = registry
        self.gets_c = registry.counter(
            "compilecache_gets_total", "artifact GET requests served")
        self.hits_c = registry.counter(
            "compilecache_hits_total", "artifact GETs answered with a hit")
        self.puts_c = registry.counter(
            "compilecache_publishes_total", "artifacts published by clients")
        self.claims_c = registry.counter(
            "compilecache_claims_granted_total",
            "single-flight compile claims granted")
        self.refusals_c = registry.counter(
            "compilecache_handshake_refusals_total",
            "connections refused at the identity handshake")
        self.send_stalls_c = registry.counter(
            "compilecache_send_stalls_total",
            "responses dropped because the send deadline expired "
            "(stalled/trickling client)")
        self.bytes_c = registry.counter(
            "compilecache_served_bytes_total", "artifact payload bytes served")
        registry.computed_gauge(
            "compilecache_entries", lambda: float(len(self.store.keys())),
            "artifacts resident in the server's store")

    # -- lifecycle ---------------------------------------------------------

    @property
    def port(self) -> int:
        if self._sock is None:
            raise RuntimeError("server not started")
        return self._sock.getsockname()[1]

    @property
    def address(self) -> str:
        host = self._bind_host if self._bind_host not in ("", "0.0.0.0") \
            else "127.0.0.1"
        return f"{host}:{self.port}"

    def start(self) -> "ArtifactServer":
        if self._sock is not None:
            return self
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self._bind_host, self._bind_port))
        s.listen(64)
        # Polling accept, same reason as InputService: close() from
        # another thread does not reliably wake a blocked accept().
        s.settimeout(0.25)
        self._sock = s
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name="tpucfn-compilecache-accept")
        self._accept_thread.start()
        return self

    def close(self) -> None:
        self._closed.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)
            self._accept_thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    def _accept_loop(self) -> None:
        assert self._sock is not None
        while not self._closed.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(30.0)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True,
                             name="tpucfn-compilecache-conn").start()

    # -- per-connection protocol -------------------------------------------

    def _validate_hello(self, hello: dict) -> str | None:
        if hello.get("v") != CC_PROTOCOL_VERSION:
            return (f"protocol version {hello.get('v')} != "
                    f"{CC_PROTOCOL_VERSION}")
        dk = hello.get("device_kind") or None
        jv = hello.get("jax_version") or None
        with self._lock:
            if self.device_kind is None and dk:
                self.device_kind = dk  # first client pins the fleet
            if self.jax_version is None and jv:
                self.jax_version = jv
            if dk and self.device_kind and dk != self.device_kind:
                return (f"device_kind {dk!r} != fleet {self.device_kind!r} "
                        "— an executable for one cannot run on the other")
            if jv and self.jax_version and jv != self.jax_version:
                return (f"jax version {jv} != fleet {self.jax_version} — "
                        "serialized executables do not cross versions")
        return None

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            kind, payload = recv_frame(conn, magic=CC_MAGIC)
            if kind != CC_HELLO:
                self._send(conn, CC_ERROR, b"expected HELLO")
                return
            try:
                hello = json.loads(bytes(payload).decode())
            except (UnicodeDecodeError, json.JSONDecodeError):
                self._send(conn, CC_ERROR, b"undecodable HELLO")
                return
            refusal = self._validate_hello(hello)
            if refusal:
                self.refusals_c.add()
                self._send(conn, CC_ERROR, refusal.encode())
                return
            self._send(conn, CC_OK,
                       json.dumps({"v": CC_PROTOCOL_VERSION}).encode())
            kind, payload, ctx = recv_frame_ctx(conn, magic=CC_MAGIC)
            t_op = time.monotonic()
            key = None
            if kind == CC_GET:
                key = bytes(payload).decode()
                self._op_get(conn, key)
            elif kind == CC_CLAIM:
                key = bytes(payload).decode()
                self._op_claim(conn, key)
            elif kind == CC_PUT:
                self._op_put(conn, payload)
            elif kind == CC_RELEASE:
                key = bytes(payload).decode()
                self._op_release(conn, key)
            elif kind == CC_STAT:
                self._send(conn, CC_OK, json.dumps({
                    "entries": len(self.store.keys()),
                    "claims": len(self._live_claims()),
                    "device_kind": self.device_kind,
                    "jax_version": self.jax_version,
                }).encode())
            else:
                self._send(conn, CC_ERROR,
                           f"unknown op {kind!r}".encode())
            if self.tracer is not None and self.tracer.enabled:
                # trace_id adopts the client's (the trainer step that
                # triggered the fetch) so the server-side work lands in
                # that step's tree on the merged timeline.
                self.tracer.record(
                    "artifact_serve", start=t_op, end=time.monotonic(),
                    trace_id=(ctx[0] if ctx and ctx[0] else None),
                    remote_parent=ctx, op=kind.decode(errors="replace"),
                    **({"key": key} if key else {}))
        except DeadlineExceeded:
            # a response outlived its send deadline: the client is
            # stalled or trickling — drop the connection (it is one-op;
            # nothing to salvage) and count the gray failure
            self.send_stalls_c.add()
        except (OSError, ServiceError):
            pass  # client vanished / torn frame: nothing to answer
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _send(self, conn: socket.socket, kind: bytes,
              payload: bytes) -> None:
        """One response frame under its own end-to-end deadline — a
        multi-MB artifact to a stalled client fails inside the bound
        instead of pinning this connection thread per-chunk-forever.
        0 disables the bound (the sibling-knob convention) instead of
        minting an already-expired deadline."""
        send_frame(conn, kind, payload, magic=CC_MAGIC,
                   deadline=(Deadline(self.send_deadline_s,
                                      label="compilecache send")
                             if self.send_deadline_s > 0 else None))

    def _live_claims(self) -> dict[str, float]:
        now = self.clock()
        with self._lock:
            self._claims = {k: t for k, t in self._claims.items() if t > now}
            return dict(self._claims)

    def _op_get(self, conn: socket.socket, key: str) -> None:
        self.gets_c.add()
        if not valid_key(key):
            self._send(conn, CC_ERROR, f"invalid key {key!r}".encode())
            return
        try:
            got = self.store.get(key)
        except (CacheCorrupt, CacheMismatch) as e:
            # quarantined server-side; the client sees a miss and
            # compiles — the corrupt artifact is never served.
            self._send(conn, CC_MISS,
                       json.dumps({"claimed": False,
                                   "corrupt": str(e)}).encode())
            return
        if got is None:
            claimed = key in self._live_claims()
            self._send(conn, CC_MISS,
                       json.dumps({"claimed": claimed}).encode())
            return
        payload, meta = got
        self.hits_c.add()
        self.bytes_c.add(len(payload))
        self._send(conn, CC_HIT, _pack_entry(meta, payload))

    def _op_claim(self, conn: socket.socket, key: str) -> None:
        if not valid_key(key):
            self._send(conn, CC_ERROR, f"invalid key {key!r}".encode())
            return
        if self.store.has(key):
            # published while the client was dialing: answer as a GET —
            # but a corrupt entry (get() quarantines it) means the key
            # is COLD, not served: fall through and grant the claim, or
            # the claimer would get a CC_MISS it cannot interpret and
            # the cold fleet would stampede-compile the key.
            try:
                got = self.store.get(key)
            except (CacheCorrupt, CacheMismatch):
                got = None
            if got is not None:
                payload, meta = got
                # counted as a served GET too: a hit answered through
                # CLAIM must keep hits_total <= gets_total (ratio
                # dashboards read the pair)
                self.gets_c.add()
                self.hits_c.add()
                self.bytes_c.add(len(payload))
                self._send(conn, CC_HIT, _pack_entry(meta, payload))
                return
        now = self.clock()
        with self._lock:
            expiry = self._claims.get(key, 0.0)
            if expiry > now:
                self._send(conn, CC_BUSY, b"")
                return
            self._claims[key] = now + self.claim_ttl_s
        self.claims_c.add()
        self._send(conn, CC_GRANTED, b"")

    def _op_release(self, conn: socket.socket, key: str) -> None:
        """A granted claimer whose compile (or publish) failed gives
        the key back so the cold fleet's waiters stop polling for a
        publish that will never come — without this, a single failed
        compile on the claim owner holds every peer until claim_ttl_s."""
        if not valid_key(key):
            self._send(conn, CC_ERROR, f"invalid key {key!r}".encode())
            return
        with self._lock:
            self._claims.pop(key, None)
        self._send(conn, CC_OK, json.dumps({"released": key}).encode())

    def _op_put(self, conn: socket.socket, blob) -> None:
        try:
            meta, payload = _unpack_entry(blob)
        except ServiceError as e:
            self._send(conn, CC_ERROR, str(e).encode())
            return
        key = str(meta.get("key") or "")
        if not valid_key(key):
            self._send(conn, CC_ERROR, f"invalid key {key!r}".encode())
            return
        self.store.put(key, payload, meta)
        with self._lock:
            self._claims.pop(key, None)
        self.puts_c.add()
        self._send(conn, CC_OK, json.dumps({"stored": key}).encode())


# -- the client -------------------------------------------------------------

class ArtifactClient:
    """One-op-per-connection client of :class:`ArtifactServer`.

    Every method raises :class:`~tpucfn.data.service.ServiceError` on
    any transport/protocol failure — :class:`CompileCacheClient` turns
    that into failover across addrs and then local compilation."""

    def __init__(self, addr: str, *, device_kind: str = "",
                 jax_version: str = "", connect_timeout_s: float = 5.0,
                 recv_timeout_s: float = 60.0,
                 op_deadline_s: float | None = None,
                 net_metrics: NetMetrics | None = None):
        self.addr = addr
        self.device_kind = device_kind
        self.jax_version = jax_version
        self.connect_timeout_s = connect_timeout_s
        self.recv_timeout_s = recv_timeout_s
        # One op = dial + handshake + request + response, end to end
        # (ISSUE 15).  recv_timeout_s alone was per-chunk — a trickling
        # server delivering an artifact a byte per timeout never failed.
        self.op_deadline_s = (float(op_deadline_s) if op_deadline_s
                              else recv_timeout_s)
        self.net_metrics = net_metrics

    def _dial(self, deadline: Deadline) -> socket.socket:
        host, _, port = self.addr.rpartition(":")
        sock = None
        try:
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.settimeout(deadline.timeout(cap=self.connect_timeout_s,
                                             what="connect"))
            sock.connect((host or "127.0.0.1", int(port)))
            sock.settimeout(self.recv_timeout_s)
            hello = {"v": CC_PROTOCOL_VERSION,
                     "device_kind": self.device_kind,
                     "jax_version": self.jax_version}
            send_frame(sock, CC_HELLO, json.dumps(hello).encode(),
                       magic=CC_MAGIC, deadline=deadline)
            kind, payload = recv_frame(sock, magic=CC_MAGIC,
                                       deadline=deadline)
            if kind == CC_ERROR:
                raise ServiceError(
                    f"artifact server {self.addr} refused: "
                    f"{bytes(payload).decode(errors='replace')}")
            if kind != CC_OK:
                raise ServiceError(f"unexpected handshake frame {kind!r}")
            return sock
        except (OSError, ValueError) as e:
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
            if isinstance(e, DeadlineExceeded):
                if self.net_metrics is not None:
                    self.net_metrics.deadline_exceeded_c.add()
                raise ServiceError(
                    f"artifact server {self.addr}: {e}") from None
            raise ServiceError(
                f"connect to artifact server {self.addr}: {e}") from None
        except ServiceError:
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
            raise

    def _op(self, kind: bytes, payload: bytes,
            ctx: tuple[int, int, int] | None = None
            ) -> tuple[bytes, bytearray]:
        deadline = Deadline(self.op_deadline_s, label="compilecache op")
        sock = self._dial(deadline)
        try:
            send_frame(sock, kind, payload, magic=CC_MAGIC, ctx=ctx,
                       deadline=deadline)
            resp, body = recv_frame(sock, magic=CC_MAGIC, deadline=deadline)
        except DeadlineExceeded as e:
            # gray peer (stalled mid-response / trickling payload):
            # counted, then degraded exactly like a dead one
            if self.net_metrics is not None:
                self.net_metrics.deadline_exceeded_c.add()
            raise ServiceError(f"artifact op to {self.addr}: {e}") from None
        except OSError as e:
            raise ServiceError(f"artifact op to {self.addr}: {e}") from None
        finally:
            try:
                sock.close()
            except OSError:
                pass
        if resp == CC_ERROR:
            raise ServiceError(
                f"artifact server {self.addr}: "
                f"{bytes(body).decode(errors='replace')}")
        return resp, body

    def get(self, key: str,
            ctx: tuple[int, int, int] | None = None
            ) -> tuple[bytes, dict] | None:
        """``(payload, meta)`` or None on a miss.  ``ctx`` is the
        caller's span context for the op frame header (ISSUE 20) —
        the server's artifact_serve span remote-parents on it.  The
        payload is re-verified against the meta's sha256 HERE — a fetch
        torn mid-transfer (or a lying server) raises, it never
        deserializes."""
        resp, body = self._op(CC_GET, key.encode(), ctx=ctx)
        if resp == CC_MISS:
            return None
        if resp != CC_HIT:
            raise ServiceError(f"unexpected GET response {resp!r}")
        meta, payload = _unpack_entry(body)
        import hashlib

        if hashlib.sha256(payload).hexdigest() != meta.get("sha256"):
            raise ServiceError(
                f"artifact {key} from {self.addr} fails its sha256 — "
                "torn transfer or corrupt server entry; refusing it")
        return payload, meta

    def claim(self, key: str) -> str:
        """``"granted"`` | ``"busy"`` | ``"hit"`` (published while we
        dialed — call :meth:`get`)."""
        resp, _body = self._op(CC_CLAIM, key.encode())
        if resp == CC_GRANTED:
            return "granted"
        if resp == CC_BUSY:
            return "busy"
        if resp == CC_HIT:
            return "hit"
        raise ServiceError(f"unexpected CLAIM response {resp!r}")

    def put(self, key: str, payload: bytes, meta: dict) -> None:
        meta = {**meta, "key": key}
        resp, _body = self._op(CC_PUT, _pack_entry(meta, payload))
        if resp != CC_OK:
            raise ServiceError(f"unexpected PUT response {resp!r}")

    def release(self, key: str) -> None:
        """Give a granted single-flight claim back (compile failed or
        nothing publishable) so waiting peers stop polling."""
        resp, _body = self._op(CC_RELEASE, key.encode())
        if resp != CC_OK:
            raise ServiceError(f"unexpected RELEASE response {resp!r}")

    def stats(self) -> dict:
        resp, body = self._op(CC_STAT, b"")
        if resp != CC_OK:
            raise ServiceError(f"unexpected STAT response {resp!r}")
        return json.loads(bytes(body).decode())


class CompileCacheClient:
    """local store → fleet fetch → single-flight compile → publish.

    jax-free orchestration: ``compile_fn``/``serialize_fn``/
    ``deserialize_fn`` are injected per call, so the jax glue
    (:mod:`tpucfn.compilecache.jit`) and the stampede tests share one
    implementation.  Outcomes (also marked on the attached
    :class:`~tpucfn.obs.profiler.CompileCacheProbe` and counted on the
    registry):

    * ``"store"``   — the local artifact store had it (warm restart on
      the same machine); ledger bucket ``compile_cached``;
    * ``"fetch"``   — a fleet peer's artifact was fetched + installed;
      ledger bucket ``compile_fetched``, with its own
      ``compile_fetch`` trace span;
    * ``"compile"`` — compiled here (and published when possible);
      ledger bucket ``compile``.
    """

    def __init__(self, store: ArtifactStore | None,
                 addrs: Sequence[str] = (), *,
                 device_kind: str = "", jax_version: str = "",
                 registry=None, tracer=None, probe=None,
                 wait_s: float = 600.0, poll_s: float = 0.25,
                 connect_timeout_s: float = 5.0,
                 op_deadline_s: float | None = None,
                 retry: RetryPolicy | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        self.store = store
        self.addrs = list(addrs)
        self.device_kind = device_kind
        self.jax_version = jax_version
        self.tracer = tracer
        self.probe = probe
        self.wait_s = wait_s
        self.poll_s = poll_s
        self.connect_timeout_s = connect_timeout_s
        self.op_deadline_s = op_deadline_s
        self.clock = clock
        self.sleep = sleep
        self.last_outcome: str | None = None
        if registry is None:
            from tpucfn_torch.obs.registry import MetricRegistry

            registry = MetricRegistry()
        self.registry = registry
        self.net_metrics = NetMetrics(registry, "compilecache")
        # The shared jittered-backoff policy (ISSUE 15) behind both
        # wait-for-the-claim-owner poll loops (fleet and local-store) —
        # poll_s stays the floor so the busy-wait tests' fake clocks
        # keep their cadence, jitter spreads a whole cold fleet's polls.
        self.retry = retry if retry is not None else RetryPolicy(
            base_s=poll_s, multiplier=1.5, max_s=max(poll_s * 8, poll_s),
            jitter=0.25, seed=0, clock=clock, sleep=sleep)
        self.store_hits_c = registry.counter(
            "compilecache_store_hits_total",
            "programs served from the local artifact store")
        self.fetch_hits_c = registry.counter(
            "compilecache_fetch_hits_total",
            "programs fetched from a fleet artifact server")
        self.compiles_c = registry.counter(
            "compilecache_compiles_total",
            "programs compiled locally (cold key, or degraded)")
        self.publish_c = registry.counter(
            "compilecache_client_publishes_total",
            "artifacts published back to the fleet")
        self.corrupt_c = registry.counter(
            "compilecache_corrupt_total",
            "artifacts refused for integrity/version failure")
        self.fetch_failures_c = registry.counter(
            "compilecache_fetch_failures_total",
            "fleet fetch attempts that failed (degraded to local)")

    def _clients(self) -> list[ArtifactClient]:
        return [ArtifactClient(a, device_kind=self.device_kind,
                               jax_version=self.jax_version,
                               connect_timeout_s=self.connect_timeout_s,
                               op_deadline_s=self.op_deadline_s,
                               net_metrics=self.net_metrics)
                for a in self.addrs]

    def _mark(self, outcome: str) -> None:
        self.last_outcome = outcome
        if self.probe is not None:
            try:
                self.probe.mark(outcome)
            except Exception:  # noqa: BLE001 — the probe is best-effort
                pass

    def _try_deserialize(self, key: str, payload: bytes, meta: dict,
                         deserialize_fn):
        """None on failure (counted): a payload that will not
        deserialize is corruption-by-another-name — quarantine locally
        and fall through to compiling."""
        try:
            return deserialize_fn(payload, meta)
        except Exception:  # noqa: BLE001 — degrade to compile, loudly counted
            self.corrupt_c.add()
            if self.store is not None and self.store.has(key):
                self.store.quarantine(key)
            return None

    def get_or_compile(self, key: str, compile_fn, *,
                       serialize_fn=None, deserialize_fn=None,
                       label: str = ""):
        """Returns ``(result, outcome)``.  ``compile_fn()`` must return
        the result; ``serialize_fn(result) -> bytes`` (or None to skip
        publishing); ``deserialize_fn(payload, meta) -> result``.  Any
        artifact-plane failure degrades to ``compile_fn()`` — the
        result is always the same program."""
        deserialize_fn = deserialize_fn or (lambda payload, meta: payload)
        # 1. local artifact store
        if self.store is not None:
            try:
                got = self.store.get(key)
            except (CacheCorrupt, CacheMismatch):
                self.corrupt_c.add()
                got = None
            if got is not None:
                result = self._try_deserialize(key, got[0], got[1],
                                               deserialize_fn)
                if result is not None:
                    self.store_hits_c.add()
                    self._mark("store")
                    return result, "store"
        # 2. fleet fetch / single-flight
        if self.addrs:
            result = self._fleet(key, compile_fn, serialize_fn,
                                 deserialize_fn, label)
            if result is not None:
                return result
        # 3. local-only path (no fleet, or fleet unreachable): local
        # single-flight via the store's claim lock, then compile.
        return self._compile_local(key, compile_fn, serialize_fn,
                                   deserialize_fn, publish=None, label=label)

    # -- fleet path --------------------------------------------------------

    def _fetch(self, clients, key: str, deserialize_fn):
        for c in clients:
            t0 = self.clock()
            # Pre-mint the compile_fetch span id so the op frame can
            # carry it (ISSUE 20): the server's artifact_serve span
            # remote-parents on (origin, sid) and the merged timeline
            # draws the fetch edge.  Failed attempts burn an id each —
            # ids are plentiful, alignment is not.
            sid = (self.tracer.next_span_id()
                   if self.tracer is not None and self.tracer.enabled
                   else None)
            try:
                got = c.get(key, ctx=((0, sid, self.tracer.origin)
                                      if sid is not None else None))
            except ServiceError:
                self.fetch_failures_c.add()
                continue
            if got is None:
                continue
            payload, meta = got
            result = self._try_deserialize(key, payload, meta,
                                           deserialize_fn)
            if result is None:
                continue
            dt = self.clock() - t0
            if self.store is not None:
                try:
                    self.store.put(key, payload, meta)
                except OSError:
                    pass
            if self.tracer is not None:
                self.tracer.record("compile_fetch", start=t0, dur_s=dt,
                                   span_id=sid,
                                   key=key, label=label_or(meta, ""),
                                   addr=c.addr, bytes=len(payload))
            self.fetch_hits_c.add()
            self._mark("fetch")
            return result, "fetch"
        return None

    def _fleet(self, key, compile_fn, serialize_fn, deserialize_fn, label):
        clients = self._clients()
        got = self._fetch(clients, key, deserialize_fn)
        if got is not None:
            return got
        # miss everywhere: try to become the fleet's one compiler
        owner = None
        busy = False
        for c in clients:
            try:
                verdict = c.claim(key)
            except ServiceError:
                self.fetch_failures_c.add()
                continue
            if verdict == "granted":
                owner = c
                break
            if verdict == "hit":
                got = self._fetch([c], key, deserialize_fn)
                if got is not None:
                    return got
            if verdict == "busy":
                busy = True
        if owner is not None:
            return self._compile_local(key, compile_fn, serialize_fn,
                                       deserialize_fn, publish=owner,
                                       label=label)
        if busy:
            # someone else is compiling it: poll until it publishes or
            # the wait budget expires (then compile locally — waiting
            # forever on a peer that may have died is worse than
            # paying the compile).  Each round also re-claims: a
            # claimer whose compile failed RELEASEs (and a dead one
            # expires at claim_ttl_s), and the first waiter to notice
            # becomes the fleet's compiler instead of stalling out its
            # whole wait budget.  The cadence is the shared RetryPolicy
            # (ISSUE 15): jittered backoff, so a cold fleet's waiters
            # do not hammer the server in lockstep.
            deadline = Deadline(self.wait_s, clock=self.clock,
                                label="compile wait")
            for _ in self.retry.attempts(deadline=deadline,
                                         metrics=self.net_metrics,
                                         sleep_first=True):
                got = self._fetch(clients, key, deserialize_fn)
                if got is not None:
                    return got
                for c in clients:
                    try:
                        verdict = c.claim(key)
                    except ServiceError:
                        continue
                    if verdict == "granted":
                        return self._compile_local(
                            key, compile_fn, serialize_fn, deserialize_fn,
                            publish=c, label=label)
                    if verdict == "hit":
                        got = self._fetch([c], key, deserialize_fn)
                        if got is not None:
                            return got
        return None  # fleet could not help: caller compiles locally

    # -- compile-and-publish ----------------------------------------------

    def _compile_local(self, key, compile_fn, serialize_fn,
                       deserialize_fn, *,
                       publish: ArtifactClient | None, label: str):
        claimed = False
        if self.store is not None and publish is None:
            # local single-flight: the bench's "second process on the
            # same machine" and N local ranks sharing one store dir
            claimed = self.store.claim(key)
            if not claimed:
                deadline = Deadline(self.wait_s, clock=self.clock,
                                    label="local claim wait")
                for _ in self.retry.attempts(deadline=deadline,
                                             metrics=self.net_metrics,
                                             sleep_first=True):
                    try:
                        got = self.store.get(key)
                    except (CacheCorrupt, CacheMismatch):
                        self.corrupt_c.add()
                        break
                    if got is not None:
                        # the claim winner published: deserialize it —
                        # through the caller's real deserialize_fn, the
                        # payload bytes are NOT the executable
                        result = self._try_deserialize(
                            key, got[0], got[1], deserialize_fn)
                        if result is not None:
                            self.store_hits_c.add()
                            self._mark("store")
                            return result, "store"
                        break  # its artifact is corrupt: compile here
                    if self.store.claim(key):
                        claimed = True
                        break
        published = False
        try:
            result = compile_fn()
        except BaseException:
            # neither claim may outlive a failed compile: give the
            # fleet claim back NOW so waiting peers re-claim instead of
            # polling out their whole wait budget against a dead
            # publish, and free the local lockfile for the next rank.
            if publish is not None:
                try:
                    publish.release(key)
                except ServiceError:
                    pass
            if claimed and self.store is not None:
                self.store.release(key)
            raise
        try:
            self.compiles_c.add()
            self._mark("compile")
            payload = None
            if serialize_fn is not None:
                try:
                    payload = serialize_fn(result)
                except Exception:  # noqa: BLE001 — publish is best-effort
                    payload = None
            if payload is not None:
                meta = {"key": key, "label": label,
                        "device_kind": self.device_kind,
                        "jax_version": self.jax_version}
                if self.store is not None:
                    try:
                        self.store.put(key, payload, meta)
                    except OSError:
                        pass
                targets = [publish] if publish is not None \
                    else self._clients()
                for c in targets:
                    try:
                        c.put(key, payload, meta)
                        self.publish_c.add()
                        published = True
                        break
                    except ServiceError:
                        self.fetch_failures_c.add()
            return result, "compile"
        finally:
            if publish is not None and not published:
                # compiled fine but nothing publishable landed (backend
                # cannot serialize, or the put failed): same rule —
                # release so the fleet stops waiting on this key.
                try:
                    publish.release(key)
                except ServiceError:
                    pass
            if claimed and self.store is not None:
                self.store.release(key)


def label_or(meta: dict, default: str) -> str:
    v = meta.get("label")
    return v if isinstance(v, str) else default
