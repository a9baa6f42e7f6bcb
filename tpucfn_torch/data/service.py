"""Disaggregated input plane — dedicated input hosts stream ready
batches to trainer hosts (ISSUE 11 tentpole).

The bench has said the same thing since round 3: the training path is
input-bound (resnet50 on v5e runs a 0.101 s compute step behind a
5.50 s loader step), and the goodput ledger names ``data_wait`` as a
first-class thief.  The fix is the tf.data-service-style worker/
dataflow split (PAPERS.md: "TensorFlow: A system for large-scale
machine learning"): input capacity becomes a provisionable resource
that scales independently of accelerator hosts.

Three pieces, all stdlib + numpy (an input host never imports jax —
that is the point of disaggregation):

* **Wire protocol** — :func:`encode_batch` / :func:`decode_batch` pack
  a host batch (dict of numpy arrays) into one self-describing binary
  frame; :func:`send_frame` / :func:`recv_frame` do length-prefixed
  framing over a socket.  TCP's own flow control is the transport-level
  backpressure: a slow trainer blocks the service's ``sendall``, never
  grows its memory.
* **InputService** — the server an input host runs (``tpucfn data
  serve``).  Per connected trainer it runs the SAME
  ``ShardedDataset``/``MultiProcessLoader`` stage the trainer would run
  locally (same shards, same ``(seed, process_index, process_count)``
  identity), so the served stream is bit-identical to the local one —
  which is what makes client-side degradation transparent.  A bounded
  per-stream queue overlaps decode with send and caps memory at
  ``queue_batches`` batches per trainer.
* **Client** — :class:`ServiceBatchStream` (one stream),
  :class:`ResilientBatchStream` (failover across input hosts, then
  degrade to LOCAL loading from the exact batch cursor — a dead input
  host costs throughput, never correctness), and
  :class:`AdaptivePrefetcher` whose depth is driven by the goodput
  plane's ``data_wait`` share (:class:`PrefetchController`): deepen
  while the consumer is input-bound, decay when it is not, bounded by
  host memory.  The output feeds :func:`~tpucfn.data.pipeline.
  prefetch_to_mesh` unchanged.

Determinism contract: the service and the trainer's local fallback
must be configured identically (shards, batch size, seed, transform,
loader type).  The handshake carries the cheap-to-check half
(process_count, batch size, seed) and the service REFUSES mismatches,
so a drifted config degrades loudly to local loading instead of
silently training on a different batch sequence.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import threading
import time
from collections import deque
from pathlib import Path
from typing import Callable, Iterator, Sequence

import numpy as np

from tpucfn_torch.net.deadline import (
    Deadline,
    DeadlineExceeded,
    NetMetrics,
    RetryPolicy,
    sendall_deadline,
)

# -- env contract (fanned out by the launcher, ISSUE 11) --------------------

ROLE_ENV = "TPUCFN_ROLE"                # "trainer" | "input"
INPUT_ADDRS_ENV = "TPUCFN_INPUT_ADDRS"  # comma list of host:port
INPUT_PORT_ENV = "TPUCFN_INPUT_PORT"    # this input host's bind port
# End-to-end per-frame deadline for the trainer-side client (ISSUE 15):
# how long one complete batch frame may take — including a trickling
# host's dribble — before the stream fails over / degrades to local.
INPUT_OP_DEADLINE_ENV = "TPUCFN_INPUT_OP_DEADLINE_S"
# launcher default base port: input host h binds DEFAULT_INPUT_PORT + h
# (ids are fleet-unique, so one machine hosting the whole test gang
# still gets distinct ports)
DEFAULT_INPUT_PORT = 7641


def input_addrs_from_env(env: dict | None = None) -> list[str]:
    """The input-host endpoints the launcher fanned out (empty list
    when the job has no input plane — callers fall back to local
    loading)."""
    e = os.environ if env is None else env
    raw = (e.get(INPUT_ADDRS_ENV) or "").strip()
    return [a for a in (s.strip() for s in raw.split(",")) if a]


# -- wire protocol ----------------------------------------------------------

MAGIC = b"TPIB"  # tpucfn input batch
PROTOCOL_VERSION = 2  # v2 (ISSUE 20): trace context joined the header

# frame kinds (1 byte)
FRAME_HELLO = b"H"  # client -> server: JSON handshake
FRAME_BATCH = b"B"  # server -> client: one encoded batch
FRAME_END = b"E"    # server -> client: stream complete (clean)
FRAME_ERROR = b"X"  # server -> client: utf-8 reason, stream is dead

# Wire contract (shared by every plane built on this framing — input
# batches here, compiled artifacts in ``compilecache.service``):
#
#     magic      4s   plane identity (TPIB / TPCC)
#     kind       c    frame kind byte
#     length     I    payload byte count
#     trace_id   Q    \  sender's span context at send time (ISSUE 20):
#     span_id    Q     } all-zero = no context.  (origin, span_id)
#     origin     Q    /  names the sender-side span fleet-uniquely
#                        (origin = obs.trace.origin_id(role, host_id));
#                        trace_id is the step / batch cursor / request
#                        that triggered the frame, 0 = none.
#
# The receiver's span that consumes or answers the frame records the
# triple as its ``rp`` (remote parent) so the offline merger can draw
# the cross-host edge.  The header grew 24 bytes in protocol v2; mixed
# fleets fail the HELLO version check (and misframe loudly before it).
_HEADER = struct.Struct("<4scIQQQ")
_NO_CTX = (0, 0, 0)
MAX_FRAME_BYTES = 1 << 31  # sanity bound: a torn header must not OOM us


class ServiceError(RuntimeError):
    """Protocol/stream failure talking to an input host (the client
    treats every one of these as 'try the next host, then go local')."""


def encode_batch(batch: dict[str, np.ndarray]) -> bytes:
    """One self-describing payload: JSON array table + raw C-order
    bytes.  Keys are sorted so encode(decode(x)) is byte-stable."""
    arrays = []
    blobs = []
    for k in sorted(batch):
        a = np.asarray(batch[k])
        # shape recorded BEFORE ascontiguousarray: it promotes 0-d
        # scalars to (1,), and labels must round-trip as scalars.
        arrays.append({"k": k, "dtype": a.dtype.str, "shape": list(a.shape)})
        blobs.append(np.ascontiguousarray(a).tobytes())
    head = json.dumps({"v": PROTOCOL_VERSION, "arrays": arrays}).encode()
    return b"".join([struct.pack("<I", len(head)), head, *blobs])


def decode_batch(payload: bytes | bytearray) -> dict[str, np.ndarray]:
    """Inverse of :func:`encode_batch`.  Decodes into WRITABLE arrays
    (``np.frombuffer`` over a bytearray) without an extra copy, so
    downstream transforms/stacking behave exactly like locally built
    batches."""
    if len(payload) < 4:
        raise ServiceError("torn batch payload (no header length)")
    head_len, = struct.unpack_from("<I", payload, 0)
    if 4 + head_len > len(payload):
        raise ServiceError("torn batch payload (truncated header)")
    try:
        head = json.loads(bytes(payload[4:4 + head_len]).decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ServiceError(f"undecodable batch header: {e}") from None
    buf = payload if isinstance(payload, bytearray) else bytearray(payload)
    out: dict[str, np.ndarray] = {}
    off = 4 + head_len
    for spec in head.get("arrays", ()):
        dt = np.dtype(spec["dtype"])
        shape = tuple(int(s) for s in spec["shape"])
        n = int(dt.itemsize * int(np.prod(shape, dtype=np.int64)))
        if off + n > len(buf):
            raise ServiceError(
                f"torn batch payload (array {spec['k']!r} truncated)")
        out[spec["k"]] = np.frombuffer(
            memoryview(buf)[off:off + n], dtype=dt).reshape(shape)
        off += n
    return out


def send_frame(sock: socket.socket, kind: bytes, payload: bytes, *,
               magic: bytes = MAGIC,
               deadline: Deadline | None = None,
               ctx: tuple[int, int, int] | None = None) -> None:
    """Length-prefixed framing.  ``magic`` distinguishes the planes that
    share this idiom (input batches here; compiled-artifact frames in
    :mod:`tpucfn.compilecache.service`) so a client dialed at the wrong
    port fails the handshake loudly instead of mis-parsing payloads.

    ``ctx`` is the sender's span context ``(trace_id, span_id, origin)``
    riding the header (ISSUE 20) — None sends all-zero, meaning "no
    context"; a trace_id of None maps to 0 the same way.

    ``deadline`` bounds the WHOLE frame end to end (ISSUE 15): without
    it, a stalled or trickling receiver pins ``sendall`` for as long as
    the socket timeout keeps resetting — with it the send is chunked
    and every chunk draws from the one shrinking budget, raising
    :class:`~tpucfn.net.deadline.DeadlineExceeded` on expiry."""
    tid, sid, org = ctx if ctx is not None else _NO_CTX
    head = _HEADER.pack(magic, kind, len(payload),
                        _wire_u64(tid), _wire_u64(sid), _wire_u64(org))
    if deadline is None:
        sock.sendall(head)
        if payload:
            sock.sendall(payload)
        return
    sendall_deadline(sock, head, deadline)
    if payload:
        sendall_deadline(sock, payload, deadline)


def _wire_u64(v) -> int:
    """Clamp a context component onto the header's u64: None and
    non-int trace_ids (serve request strings) ride as 0 — the wire
    carries only resolvable numeric identities."""
    if not isinstance(v, int) or isinstance(v, bool) or v < 0:
        return 0
    return v & 0xFFFFFFFFFFFFFFFF


def _recv_exact(sock: socket.socket, n: int,
                deadline: Deadline | None = None) -> bytearray:
    """Read exactly ``n`` bytes.  With a ``deadline``, every chunk's
    socket timeout is the deadline's REMAINDER — the gray-failure fix
    (ISSUE 15): the per-chunk form lets a trickling peer deliver one
    byte per timeout and never expire, because each ``recv`` resets the
    clock; composing the chunks over one end-to-end budget means the
    whole read finishes or fails inside the bound."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        if deadline is not None:
            sock.settimeout(deadline.timeout(what="recv"))
        try:
            r = sock.recv_into(view[got:], n - got)
        except socket.timeout:
            if deadline is not None:
                raise DeadlineExceeded(
                    f"recv deadline exceeded after {got}/{n} bytes"
                ) from None
            raise
        if r == 0:
            raise ServiceError("input stream closed mid-frame")
        got += r
    return buf


def recv_frame(sock: socket.socket, *, magic: bytes = MAGIC,
               deadline: Deadline | None = None) -> tuple[bytes, bytearray]:
    kind, payload, _ctx = recv_frame_ctx(sock, magic=magic,
                                         deadline=deadline)
    return kind, payload


def recv_frame_ctx(
    sock: socket.socket, *, magic: bytes = MAGIC,
    deadline: Deadline | None = None,
) -> tuple[bytes, bytearray, tuple[int, int, int] | None]:
    """:func:`recv_frame` plus the header's span context —
    ``(trace_id, span_id, origin)``, or None when the sender carried no
    context (all-zero span/origin)."""
    head = _recv_exact(sock, _HEADER.size, deadline)
    got_magic, kind, length, tid, sid, org = _HEADER.unpack(bytes(head))
    if got_magic != magic:
        raise ServiceError(f"bad frame magic {got_magic!r}")
    if length > MAX_FRAME_BYTES:
        raise ServiceError(f"frame length {length} exceeds sanity bound")
    ctx = (tid, sid, org) if sid and org else None
    return kind, (_recv_exact(sock, length, deadline) if length
                  else bytearray()), ctx


# -- the service (input-host side) ------------------------------------------

class InputService:
    """Streams per-trainer batch sequences to connected trainer hosts.

    One listening socket; per accepted connection a producer thread
    runs the trainer's exact data stage and a bounded queue
    (``queue_batches``) hands encoded frames to the sender — decode
    overlaps the network, memory stays bounded, and a slow trainer
    backpressures its own stream without touching anyone else's.

    ``mp_workers > 0`` runs each stream through
    :class:`~tpucfn.data.pipeline.MultiProcessLoader` (decode across
    worker processes — the input host's whole reason to exist);
    ``mp_workers == 0`` uses :class:`~tpucfn.data.pipeline.
    ShardedDataset` directly (in-process, optionally thread-pooled via
    ``ds_kwargs['num_workers']``).
    """

    def __init__(self, shard_paths: Sequence[str | Path], *,
                 num_trainers: int,
                 batch_size_per_process: int,
                 seed: int = 0,
                 num_epochs: int | None = None,
                 host: str = "127.0.0.1",
                 port: int = 0,
                 queue_batches: int = 4,
                 mp_workers: int = 0,
                 registry=None,
                 sndbuf_bytes: int | None = None,
                 send_deadline_s: float = 120.0,
                 hello_timeout_s: float = 30.0,
                 tracer=None,
                 **ds_kwargs):
        if num_trainers < 1:
            raise ValueError(f"num_trainers must be >= 1, got {num_trainers}")
        self.shard_paths = sorted(str(p) for p in shard_paths)
        if not self.shard_paths:
            raise ValueError("no shard paths given")
        self.num_trainers = num_trainers
        self.batch = int(batch_size_per_process)
        self.seed = int(seed)
        self.num_epochs = num_epochs
        self.queue_batches = max(1, int(queue_batches))
        self.mp_workers = int(mp_workers)
        # Optional hard cap on the kernel send buffer per stream: the
        # documented per-trainer memory bound is queue_batches batches
        # PLUS the socket buffer, and Linux auto-tunes loopback/LAN
        # windows to several MB — cap it when the bound must be real
        # (None keeps OS auto-tuning: right for high-BDP fleet links).
        self.sndbuf_bytes = sndbuf_bytes
        # Per-FRAME send deadline (ISSUE 15 satellite): the old shape —
        # one generous per-connection timeout — let a stalled or
        # blackholed trainer pin this stream's producer thread (and its
        # full queue_batches of encoded batches) for the whole window,
        # because sendall under a plain socket timeout resets per
        # drained chunk.  One frame now has send_deadline_s end to end;
        # expiry counts input_send_stalls_total and drops the stream
        # like any disconnect.  Must comfortably exceed the trainers'
        # worst-case step time (a full prefetch chain stops reading
        # while a step runs) — it bounds the half-dead, not the slow.
        self.send_deadline_s = float(send_deadline_s)
        self.hello_timeout_s = float(hello_timeout_s)
        # Fleet timeline (ISSUE 20): one ``input_serve`` span per BATCH
        # frame — encode start through send complete, trace_id = the
        # batch cursor — whose pre-minted span id rides the frame
        # header so the trainer's data_wait records it as its remote
        # parent.  Tracer is thread-safe; streams share it.
        self.tracer = tracer
        self.ds_kwargs = dict(ds_kwargs)
        if self.mp_workers > 0 and self.ds_kwargs.get("num_workers"):
            # Two decode axes at once is a config error, not a silent
            # drop: MultiProcessLoader's spawn workers own the axis and
            # cannot thread-pool inside each worker.
            raise ValueError(
                "mp_workers and num_workers are mutually exclusive — "
                "process workers (mp_workers) own the decode axis")
        if self.mp_workers > 0:
            self.ds_kwargs.pop("num_workers", None)  # the CLI's default 0
        self._bind_host = host
        self._bind_port = port
        self._sock: socket.socket | None = None
        self._accept_thread: threading.Thread | None = None
        self._streams: list[_Stream] = []
        self._lock = threading.Lock()
        self._closed = threading.Event()
        # SIGTERM-handler form (plain GIL-atomic store, no lock, no
        # Event internals — the PR 8 drain(wait=False) lesson): the
        # serving thread notices and runs the real close().
        self._close_requested = False
        self._last_activity = time.monotonic()
        self._ever_connected = False
        # input_* metrics under the fleet prefix convention (the
        # metric-hygiene rule knows the "input" family; per-trainer
        # series are deliberately AGGREGATED — a name per trainer would
        # be exactly the registry-cardinality bug).
        if registry is None:
            from tpucfn_torch.obs.registry import MetricRegistry

            registry = MetricRegistry()
        self.registry = registry
        self.batches_c = registry.counter(
            "input_batches_streamed_total",
            "batches encoded and handed to trainer streams")
        self.bytes_c = registry.counter(
            "input_bytes_streamed_total",
            "encoded batch bytes handed to trainer streams")
        self.connections_c = registry.counter(
            "input_connections_total", "trainer stream connections accepted")
        self.stream_errors_c = registry.counter(
            "input_stream_errors_total",
            "streams that ended in a handshake refusal or transport error")
        self.send_stalls_c = registry.counter(
            "input_send_stalls_total",
            "streams dropped because one frame's send deadline expired "
            "(stalled/blackholed trainer — producer and queue released)")
        registry.computed_gauge(
            "input_active_streams", lambda: float(len(self._live_streams())),
            "trainer streams currently connected")
        registry.computed_gauge(
            "input_queue_depth",
            lambda: float(sum(len(s.queue) for s in self._live_streams())),
            "encoded batches buffered across all trainer streams "
            "(bounded by queue_batches per stream)")

    # -- lifecycle ---------------------------------------------------------

    @property
    def port(self) -> int:
        if self._sock is None:
            raise RuntimeError("service not started")
        return self._sock.getsockname()[1]

    @property
    def address(self) -> str:
        return f"{self._bind_host}:{self.port}"

    def _live_streams(self) -> list["_Stream"]:
        with self._lock:
            return [s for s in self._streams if not s.done.is_set()]

    def start(self) -> "InputService":
        if self._sock is not None:
            return self
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self._bind_host, self._bind_port))
        s.listen(16)
        # Polling accept: close() from another thread does NOT reliably
        # wake a blocked accept() on Linux — the loop must observe
        # _closed on its own clock.
        s.settimeout(0.25)
        self._sock = s
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="tpucfn-input-accept")
        self._accept_thread.start()
        return self

    def _accept_loop(self) -> None:
        assert self._sock is not None
        while not self._closed.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listening socket closed
            # Guards only the HELLO read (clients handshake the moment
            # they connect); the send path is bounded per-frame by
            # send_deadline_s, which retired the old generous
            # per-connection timeout that let one stalled trainer pin a
            # producer thread for 5 minutes (ISSUE 15 satellite).
            conn.settimeout(self.hello_timeout_s)
            if self.sndbuf_bytes is not None:
                conn.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF,
                                self.sndbuf_bytes)
            self.connections_c.add()
            with self._lock:
                self._last_activity = time.monotonic()
                self._ever_connected = True
                # prune finished streams here, not just filter copies: a
                # long-running service under reconnect churn must not
                # accumulate dead _Stream objects (and their queued
                # frames) per connection ever accepted
                self._streams = [s for s in self._streams
                                 if not s.done.is_set()]
                self._streams.append(_Stream(self, conn))

    def request_close(self) -> None:
        """The signal-handler shutdown form: one plain attribute store,
        lock-free by construction (a handler may interrupt a frame that
        holds any of this object's locks).  The thread blocked in
        :meth:`wait_idle` notices and performs the real :meth:`close`."""
        self._close_requested = True

    def close(self) -> None:
        """Stop accepting, end every stream, join the workers.  Safe to
        call twice; ``tpucfn data serve`` runs it after :meth:`wait_idle`
        returns (never from the signal handler itself)."""
        self._closed.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        with self._lock:
            streams = list(self._streams)
        for st in streams:
            st.stop()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)
            self._accept_thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    def wait_idle(self, idle_exit_s: float | None = None,
                  poll_s: float = 0.2) -> None:
        """Block until a :meth:`request_close`/:meth:`close`, or —
        when ``idle_exit_s`` is set — until that many seconds pass with
        no live stream.  ``tpucfn data serve --idle-exit``: under the
        launch fan-out the input host must EXIT once the trainers are
        done or the supervisor would wait on it forever."""
        while not self._closed.is_set() and not self._close_requested:
            with self._lock:
                live = any(not s.done.is_set() for s in self._streams)
                if live:
                    self._last_activity = time.monotonic()
                idle = time.monotonic() - self._last_activity
                armed = self._ever_connected
            # The countdown only arms once a trainer has EVER connected:
            # under the launch fan-out, trainer boot (jax import + first
            # compile) takes tens of seconds, and an input host that
            # idle-exits before the fleet's first connection serves
            # nobody.  A run whose trainers never connect is reaped by
            # the coordinator at run end instead.
            if idle_exit_s is not None and armed and not live \
                    and idle >= idle_exit_s:
                return
            time.sleep(poll_s)

    # -- the per-stream data stage ----------------------------------------

    def _batches(self, trainer: int, num_epochs: int | None
                 ) -> Iterator[dict[str, np.ndarray]]:
        # Imported lazily: pipeline stays jax-free either way (PR 11
        # made its jax imports lazy), but the service must not pay the
        # import until a trainer actually connects.
        from tpucfn_torch.data.pipeline import MultiProcessLoader, ShardedDataset

        if self.mp_workers > 0:
            loader = MultiProcessLoader(
                self.shard_paths, num_workers=self.mp_workers,
                batch_size_per_process=self.batch, seed=self.seed,
                process_index=trainer, process_count=self.num_trainers,
                **self.ds_kwargs)
            return loader.batches(num_epochs)
        ds = ShardedDataset(
            self.shard_paths, batch_size_per_process=self.batch,
            seed=self.seed, process_index=trainer,
            process_count=self.num_trainers, **self.ds_kwargs)
        return ds.batches(num_epochs)


class _Stream:
    """One trainer connection: handshake, producer thread filling a
    bounded frame queue, sender loop draining it over the socket."""

    def __init__(self, service: InputService, conn: socket.socket):
        self.service = service
        self.conn = conn
        self.queue: deque[bytes | None] = deque()
        self._cv = threading.Condition()
        self._stop = threading.Event()
        self.done = threading.Event()
        self.trainer: int | None = None
        self._producer: threading.Thread | None = None
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="tpucfn-input-stream")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        try:
            self.conn.close()
        except OSError:
            pass

    # producer side --------------------------------------------------------

    def _produce(self, trainer: int, start_batch: int,
                 num_epochs: int | None) -> None:
        svc = self.service
        it = None
        try:
            it = svc._batches(trainer, num_epochs)
            cursor = 0
            for batch in it:
                if self._stop.is_set():
                    return
                cursor += 1
                if cursor <= start_batch:
                    # reconnect catch-up: the stream must still CONSUME
                    # the skipped batches (the augmentation RNG advances
                    # with them), it just doesn't ship them.
                    continue
                t_enc = time.monotonic()
                self._enqueue(("batch", cursor, t_enc, encode_batch(batch)))
            self._enqueue(None)  # clean end marker
        except Exception as e:  # noqa: BLE001 — surfaced as an error frame
            svc.stream_errors_c.add()
            self._enqueue(("error", f"{type(e).__name__}: {e}"))
        finally:
            # An abandoned stream must not leak its stage: closing the
            # generator runs MultiProcessLoader.batches' finally, which
            # terminates the spawn workers NOW instead of at GC.
            if it is not None and hasattr(it, "close"):
                it.close()

    def _enqueue(self, item) -> None:
        with self._cv:
            while (len(self.queue) >= self.service.queue_batches
                   and not self._stop.is_set()):
                self._cv.wait(timeout=0.5)
            if self._stop.is_set():
                return
            self.queue.append(item)
            self._cv.notify_all()

    def _dequeue(self):
        with self._cv:
            while not self.queue and not self._stop.is_set():
                self._cv.wait(timeout=0.5)
            if self._stop.is_set() and not self.queue:
                return False, None
            item = self.queue.popleft()
            self._cv.notify_all()
            return True, item

    # sender side ----------------------------------------------------------

    def _run(self) -> None:
        svc = self.service
        streaming = False  # past the handshake, batches flowing
        try:
            kind, payload = recv_frame(self.conn)
            if kind != FRAME_HELLO:
                raise ServiceError(f"expected HELLO, got {kind!r}")
            hello = json.loads(bytes(payload).decode())
            trainer = int(hello.get("trainer", -1))
            refusal = self._validate(hello, trainer)
            if refusal:
                svc.stream_errors_c.add()
                self._send(FRAME_ERROR, refusal.encode())
                return
            self.trainer = trainer
            # The service's configured bound is the default whenever the
            # client does not ASK for one: every shipped client sends
            # the key (as None), so key-presence must not disable
            # `data serve --num-epochs`.
            num_epochs = hello.get("num_epochs")
            if num_epochs is None:
                num_epochs = self.service.num_epochs
            self._producer = threading.Thread(
                target=self._produce,
                args=(trainer, int(hello.get("start_batch", 0)), num_epochs),
                daemon=True, name=f"tpucfn-input-produce-{trainer}")
            self._producer.start()
            streaming = True
            while True:
                ok, item = self._dequeue()
                if not ok:
                    return
                if item is None:
                    self._send(FRAME_END, b"")
                    return
                if item[0] == "error":  # ("error", reason)
                    self._send(FRAME_ERROR, item[1].encode())
                    return
                _tag, cursor, t_enc, payload = item
                tr = svc.tracer
                if tr is not None and tr.enabled:
                    # Span id minted BEFORE the send so the frame header
                    # carries it; the span itself (encode start → send
                    # complete, i.e. serve work plus backpressure wait)
                    # is written after, under the same id.
                    sid = tr.next_span_id()
                    self._send(FRAME_BATCH, payload,
                               ctx=(cursor, sid, tr.origin))
                    tr.record("input_serve", start=t_enc,
                              end=time.monotonic(), span_id=sid,
                              trace_id=cursor, trainer=trainer,
                              frame_bytes=len(payload))
                else:
                    self._send(FRAME_BATCH, payload)
                svc.batches_c.add()
                svc.bytes_c.add(len(payload))
        except DeadlineExceeded:
            # One frame exceeded its end-to-end send deadline: the
            # trainer is stalled or blackholed, not merely busy — drop
            # the stream like any disconnect (the finally releases the
            # producer and its queued batches NOW, not after a 5-minute
            # window).  Not a stream "error": a reconnecting trainer
            # resumes from its cursor, a dead one degrades to local.
            svc.send_stalls_c.add()
        except (OSError, ServiceError, json.JSONDecodeError, ValueError) as e:
            # A trainer on an UNBOUNDED stream ends it by disconnecting
            # (the shipped integration's normal exit) — that is not a
            # stream error, or every clean run would trip the alerting
            # metric.  Anything pre-handshake, or not a plain peer
            # disconnect, still counts.
            if not (streaming and isinstance(
                    e, (ConnectionResetError, BrokenPipeError))):
                svc.stream_errors_c.add()
        finally:
            self._stop.set()
            with self._cv:
                self.queue.clear()  # drop buffered frames with the stream
                self._cv.notify_all()
            try:
                self.conn.close()
            except OSError:
                pass
            self.done.set()
            with svc._lock:
                svc._last_activity = time.monotonic()

    def _send(self, kind: bytes, payload: bytes,
              ctx: tuple[int, int, int] | None = None) -> None:
        """One frame under its own end-to-end deadline (ISSUE 15
        satellite: the bound on how long a gray trainer can pin this
        stream).  0 disables the bound — the sibling-knob convention
        (``--serve-for 0``, ``duration_s=0``) — rather than minting an
        already-expired deadline that drops every stream at frame 1."""
        s = self.service.send_deadline_s
        send_frame(self.conn, kind, payload, ctx=ctx,
                   deadline=(Deadline(s, label="input send")
                             if s > 0 else None))

    def _validate(self, hello: dict, trainer: int) -> str | None:
        """The determinism contract's cheap half: a trainer whose
        identity or batch geometry disagrees with the service's would
        silently train on a DIFFERENT sequence than its local fallback
        — refuse loudly so the client degrades to local instead."""
        svc = self.service
        if hello.get("v") != PROTOCOL_VERSION:
            return f"protocol version {hello.get('v')} != {PROTOCOL_VERSION}"
        if not 0 <= trainer < svc.num_trainers:
            return (f"trainer {trainer} out of range for "
                    f"{svc.num_trainers} trainer(s)")
        pc = hello.get("process_count")
        if pc is not None and int(pc) != svc.num_trainers:
            return (f"trainer fleet size {pc} != service num_trainers "
                    f"{svc.num_trainers} — shard split would diverge")
        b = hello.get("batch_size")
        if b is not None and int(b) != svc.batch:
            return f"batch_size {b} != service batch {svc.batch}"
        s = hello.get("seed")
        if s is not None and int(s) != svc.seed:
            return f"seed {s} != service seed {svc.seed}"
        mw = hello.get("mp_workers")
        if mw is not None and int(mw) != svc.mp_workers:
            # MultiProcessLoader's merge order differs per worker count
            # (its own contract), so a served mp_workers=W stream is NOT
            # the client's local-fallback sequence unless the fallback
            # is the same W — degrading mid-run would silently swap
            # permutations (some examples trained twice, some never).
            return (f"loader shape mismatch: trainer fallback has "
                    f"mp_workers={mw}, service runs mp_workers="
                    f"{svc.mp_workers} — the degrade handoff would not "
                    "be bit-identical")
        return None


# -- client (trainer-host side) ---------------------------------------------

class ServiceBatchStream:
    """Iterator over one input host's stream for this trainer.  Raises
    :class:`ServiceError` on any transport/protocol failure — the
    resilient wrapper turns that into failover/degradation."""

    def __init__(self, addr: str, trainer: int, *,
                 process_count: int | None = None,
                 batch_size: int | None = None,
                 seed: int | None = None,
                 start_batch: int = 0,
                 num_epochs: int | None = None,
                 connect_timeout_s: float = 5.0,
                 recv_timeout_s: float = 120.0,
                 op_deadline_s: float | None = None,
                 rcvbuf_bytes: int | None = None,
                 mp_workers: int | None = None,
                 net_metrics: NetMetrics | None = None):
        # End-to-end bound for receiving ONE complete frame (ISSUE 15):
        # recv_timeout_s alone is per-CHUNK, which a trickling input
        # host resets forever — op_deadline_s is the budget the chunks
        # share.  Defaults to recv_timeout_s, so the worst case becomes
        # "one timeout total" instead of "one timeout per byte".
        self.op_deadline_s = (float(op_deadline_s) if op_deadline_s
                              else recv_timeout_s)
        self.net_metrics = net_metrics
        host, _, port = addr.rpartition(":")
        self._sock = None  # socket() itself can fail (fd exhaustion):
        # every construction failure must be a ServiceError, or the
        # resilient wrapper cannot degrade past it
        try:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            if rcvbuf_bytes is not None:
                # pre-connect so the advertised window honors the cap
                # (part of the client's host-memory bound alongside the
                # adaptive prefetcher's max_bytes)
                self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                      rcvbuf_bytes)
            self._sock.settimeout(connect_timeout_s)
            self._sock.connect((host or "127.0.0.1", int(port)))
        except (OSError, ValueError) as e:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
            raise ServiceError(f"connect to input host {addr}: {e}") from None
        self._sock.settimeout(recv_timeout_s)
        self.addr = addr
        hello = {"v": PROTOCOL_VERSION, "trainer": int(trainer),
                 "start_batch": int(start_batch), "num_epochs": num_epochs,
                 "process_count": process_count, "batch_size": batch_size,
                 "seed": seed}
        if mp_workers is not None:
            # declare the LOCAL FALLBACK's loader shape so the service
            # can refuse a stream the degrade handoff couldn't reproduce
            hello["mp_workers"] = int(mp_workers)
        try:
            send_frame(self._sock, FRAME_HELLO, json.dumps(hello).encode(),
                       deadline=Deadline(self.op_deadline_s,
                                         label="input hello"))
        except OSError as e:
            self.close()
            raise ServiceError(f"handshake to {addr}: {e}") from None
        self._ended = False
        # span context of the most recent BATCH frame (ISSUE 20): the
        # input host's (cursor, input_serve span_id, origin), read off
        # the frame header — what the consumer's data_wait span records
        # as its remote parent.  None until a batch arrives or when the
        # serving host traces nothing.
        self.last_ctx: tuple[int, int, int] | None = None

    def __iter__(self):
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        if self._ended:
            raise StopIteration
        try:
            kind, payload, ctx = recv_frame_ctx(
                self._sock,
                deadline=Deadline(self.op_deadline_s, label="input batch"))
        except DeadlineExceeded as e:
            # The gray case the deadline exists for: the host is up but
            # trickling/stalled — counted apart from plain transport
            # errors, then degraded through the exact same path.
            if self.net_metrics is not None:
                self.net_metrics.deadline_exceeded_c.add()
            self.close()
            raise ServiceError(f"stream from {self.addr}: {e}") from None
        except (OSError, ServiceError) as e:
            self.close()
            raise ServiceError(f"stream from {self.addr}: {e}") from None
        if kind == FRAME_BATCH:
            self.last_ctx = ctx
            return decode_batch(payload)
        if kind == FRAME_END:
            self._ended = True
            self.close()
            raise StopIteration
        if kind == FRAME_ERROR:
            reason = bytes(payload).decode(errors="replace")
            self.close()
            raise ServiceError(f"input host {self.addr} refused: {reason}")
        self.close()
        raise ServiceError(f"unexpected frame kind {kind!r}")

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class ResilientBatchStream:
    """The trainer's input iterator: service-fed while an input host
    answers, LOCAL from the exact cursor the moment none does.

    * ``addrs`` — every input host (the launcher's fan-out); the
      primary is ``addrs[trainer % len(addrs)]`` so trainers spread
      across input hosts, and a failed stream fails over to the
      remaining hosts (every input host serves every trainer's
      identical stream) before degrading.
    * ``local_factory(start_batch)`` — builds the local fallback
      iterator ALREADY advanced past ``start_batch`` batches (the
      caller owns loader construction; the streams being bit-identical
      is what makes the handoff invisible to training).
    * ``on_degrade(reason)`` — observability hook (gauge flip, log
      line); degradation is permanent for the run: determinism over
      opportunism.
    * ``connect_retry_s`` bounds a STARTUP-only retry window: fleet
      roles boot with skew (an input host's interpreter may trail the
      trainers by seconds), so a refused first connection is retried
      until the window expires — but once any batch has flowed, a
      failure means the host died and the stream fails over / degrades
      immediately.
    """

    def __init__(self, addrs: Sequence[str], trainer: int, *,
                 local_factory: Callable[[int], Iterator[dict]],
                 process_count: int | None = None,
                 batch_size: int | None = None,
                 seed: int | None = None,
                 num_epochs: int | None = None,
                 connect_timeout_s: float = 5.0,
                 connect_retry_s: float = 20.0,
                 recv_timeout_s: float = 120.0,
                 op_deadline_s: float | None = None,
                 rcvbuf_bytes: int | None = None,
                 mp_workers: int | None = None,
                 registry=None,
                 retry: RetryPolicy | None = None,
                 on_degrade: Callable[[str], None] | None = None):
        if not addrs:
            raise ValueError("no input-host addresses (use the local "
                             "loader directly instead)")
        self.trainer = int(trainer)
        self.net_metrics = (NetMetrics(registry, "input")
                            if registry is not None else None)
        # rotate so trainer i's primary is addrs[i % n]
        n = len(addrs)
        self._addrs = [addrs[(self.trainer + k) % n] for k in range(n)]
        self._kw = dict(process_count=process_count, batch_size=batch_size,
                        seed=seed, num_epochs=num_epochs,
                        connect_timeout_s=connect_timeout_s,
                        recv_timeout_s=recv_timeout_s,
                        op_deadline_s=op_deadline_s,
                        rcvbuf_bytes=rcvbuf_bytes,
                        mp_workers=mp_workers,
                        net_metrics=self.net_metrics)
        self.local_factory = local_factory
        self.on_degrade = on_degrade
        self.connect_retry_s = connect_retry_s
        # The shared jittered-backoff policy (ISSUE 15) drives the
        # startup connect-retry window, replacing this class's
        # hand-rolled fixed 0.25 s loop; seeded per trainer so a
        # whole booting fleet does not knock in lockstep.
        self.retry = retry if retry is not None else RetryPolicy(
            base_s=0.25, multiplier=2.0, max_s=2.0, jitter=0.25,
            seed=self.trainer)
        self.cursor = 0  # batches already yielded
        self.degraded = False
        # Cross-host link FIFO (ISSUE 20): one entry per yielded batch —
        # the serving host's span context for a served batch, None for a
        # locally loaded one.  Consumers that care (the train loop) call
        # :meth:`pop_link` once per consumed batch; because every buffer
        # between here and the consumer (AdaptivePrefetcher,
        # prefetch_to_mesh) is strictly FIFO, position alone pairs link
        # to batch.  Bounded: an integration that never pops (benches,
        # rl) must not leak one tuple per batch forever — past the cap
        # the FIFO poisons itself and pop_link returns None for the
        # rest of the run (an honest "no link" beats a misaligned one).
        self._links: deque = deque()
        self._links_poisoned = False
        self._local: Iterator[dict] | None = None
        self._stream: ServiceBatchStream | None = None
        self._tried = 0  # next index into _addrs to try
        self._t0 = time.monotonic()
        # the most recent stream-level failure: connect attempts can
        # SUCCEED right up to the degrade (a gray host accepts and
        # swallows), so without this the degrade reason would report
        # the uninformative ctor-side default
        self._last_error: str | None = None

    def _degrade(self, reason: str) -> None:
        self.degraded = True
        self._local = self.local_factory(self.cursor)
        if self.on_degrade is not None:
            try:
                self.on_degrade(reason)
            except Exception:  # noqa: BLE001 — observability must not kill input
                pass

    def _next_stream(self) -> ServiceBatchStream | None:
        last = self._last_error or "all input hosts exhausted"
        # The startup window is anchored at stream CONSTRUCTION (fleet
        # roles boot with skew), so the deadline is absolute, not
        # per-round; once any batch has flowed (cursor > 0) the window
        # is closed and a failure degrades after one pass.
        window = Deadline.at(self._t0 + self.connect_retry_s,
                             label="input connect window")
        rounds = self.retry.attempts(deadline=window,
                                     metrics=self.net_metrics,
                                     sleep_first=True)
        while True:
            while self._tried < len(self._addrs):
                addr = self._addrs[self._tried]
                self._tried += 1
                try:
                    return ServiceBatchStream(
                        addr, self.trainer, start_batch=self.cursor,
                        **self._kw)
                except ServiceError as e:
                    last = self._last_error = str(e)
            if self.cursor == 0 and next(rounds, None) is not None:
                # startup skew, not death: nobody has served a batch
                # yet, so keep knocking (jittered backoff) until the
                # window expires
                self._tried = 0
                continue
            self._degrade(last)
            return None

    def __iter__(self):
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        while True:
            if self._local is not None:
                batch = next(self._local)  # StopIteration propagates
                self.cursor += 1
                self._push_link(None)
                return batch
            if self._stream is None:
                self._stream = self._next_stream()
                if self._stream is None:
                    continue  # degraded: loop into the local branch
            try:
                batch = next(self._stream)
            except StopIteration:
                raise
            except ServiceError as e:
                self._last_error = str(e)
                self._stream = None
                continue  # failover (remaining addrs) or degrade
            self.cursor += 1
            self._push_link(self._stream.last_ctx)
            return batch

    _LINKS_CAP = 4096

    def _push_link(self, ctx) -> None:
        if self._links_poisoned:
            return
        if len(self._links) >= self._LINKS_CAP:
            self._links.clear()
            self._links_poisoned = True
            return
        self._links.append(ctx)

    def pop_link(self) -> tuple[int, int, int] | None:
        """The span context paired with the OLDEST not-yet-claimed
        yielded batch (None for a local/untraced one).  Call exactly
        once per consumed batch; FIFO buffering between this stream and
        the consumer keeps the pairing exact at any prefetch depth."""
        if self._links_poisoned or not self._links:
            return None
        return self._links.popleft()

    def close(self) -> None:
        if self._stream is not None:
            self._stream.close()
            self._stream = None


# -- adaptive prefetch (the data_wait feedback loop) ------------------------

class PrefetchController:
    """Pure depth policy: deepen while the consumer's ``data_wait``
    share says the input plane is behind, decay when it is not.

    ``observe(wait_s, busy_s)`` feeds one step's blocked-on-input time
    and compute time; the rolling-window share drives the target depth:

    * share > ``deepen_share``  -> depth doubles (bounded by
      ``max_depth``) and the window resets, so one decision is judged
      on fresh evidence;
    * share < ``shrink_share`` over a full window -> depth decays by 1
      toward ``min_depth`` (buffered batches are host RAM — holding 16
      deep while data_wait is zero is pure waste).

    This is the goodput plane's ``data_wait`` bucket, measured at the
    consumer, closing the loop the ISSUE names; injectable and pure so
    it tests with zero sleeps.
    """

    def __init__(self, *, min_depth: int = 1, max_depth: int = 16,
                 deepen_share: float = 0.05, shrink_share: float = 0.01,
                 window: int = 8):
        if not 1 <= min_depth <= max_depth:
            raise ValueError(
                f"need 1 <= min_depth <= max_depth, got "
                f"{min_depth}..{max_depth}")
        if not 0.0 <= shrink_share <= deepen_share:
            raise ValueError("need 0 <= shrink_share <= deepen_share")
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.deepen_share = deepen_share
        self.shrink_share = shrink_share
        self.window = max(1, int(window))
        self.depth = min_depth
        self._hist: deque[tuple[float, float]] = deque(maxlen=self.window)

    def wait_share(self) -> float:
        wait = sum(w for w, _ in self._hist)
        total = wait + sum(b for _, b in self._hist)
        return (wait / total) if total > 0 else 0.0

    def observe(self, wait_s: float, busy_s: float) -> int:
        self._hist.append((max(0.0, wait_s), max(0.0, busy_s)))
        share = self.wait_share()
        if share > self.deepen_share and self.depth < self.max_depth:
            self.depth = min(self.max_depth, self.depth * 2)
            self._hist.clear()
        elif (share < self.shrink_share and self.depth > self.min_depth
              and len(self._hist) == self.window):
            self.depth = max(self.min_depth, self.depth - 1)
            self._hist.clear()
        return self.depth


class AdaptivePrefetcher:
    """Host-RAM batch buffer between an input iterator and the train
    loop, ``PrefetchController``-deep, ``max_bytes``-bounded.

    The consumer's ``__next__`` measures its own blocked time (that IS
    the ``data_wait`` bucket) and the time between calls (the step);
    both feed the controller.  A producer thread keeps the buffer at
    the controller's current target — backpressure flows through the
    buffer bound all the way to the input service's queue and socket.
    Feeds :func:`~tpucfn.data.pipeline.prefetch_to_mesh` unchanged (the
    device-transfer leg keeps its own small fixed depth).
    """

    _END = object()

    def __init__(self, it: Iterator[dict], *,
                 controller: PrefetchController | None = None,
                 max_bytes: int = 1 << 30,
                 registry=None,
                 clock: Callable[[], float] = time.monotonic):
        self.it = it
        self.controller = (controller if controller is not None
                           else PrefetchController())
        self.max_bytes = int(max_bytes)
        self.clock = clock
        self._buf: deque = deque()
        self._buf_bytes = 0
        self._cv = threading.Condition()
        self._stop = threading.Event()
        self._exhausted = False
        self._last_return: float | None = None
        if registry is not None:
            registry.computed_gauge(
                "input_prefetch_depth",
                lambda: float(self.controller.depth),
                "adaptive host-side prefetch target depth "
                "(data_wait-share driven)")
        self._thread = threading.Thread(
            target=self._fill, daemon=True, name="tpucfn-input-prefetch")
        self._thread.start()

    @staticmethod
    def _nbytes(item) -> int:
        if isinstance(item, dict):
            return sum(getattr(v, "nbytes", 0) for v in item.values())
        return 0

    def _fill(self) -> None:
        try:
            for batch in self.it:
                nb = self._nbytes(batch)
                with self._cv:
                    while not self._stop.is_set() and self._buf and (
                            len(self._buf) >= self.controller.depth
                            or self._buf_bytes + nb > self.max_bytes):
                        self._cv.wait(timeout=0.5)
                    if self._stop.is_set():
                        return
                    self._buf.append(batch)
                    self._buf_bytes += nb
                    self._cv.notify_all()
        except BaseException as e:  # noqa: BLE001 — surface to the consumer
            with self._cv:
                self._buf.append(e if isinstance(e, Exception)
                                 else RuntimeError(repr(e)))
                self._cv.notify_all()
            return
        with self._cv:
            self._buf.append(self._END)
            self._cv.notify_all()

    def __iter__(self):
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        if self._exhausted:
            # iterator protocol: repeated next() after the end must keep
            # raising, not wait forever on a fill thread that exited
            raise StopIteration
        t0 = self.clock()
        busy = (t0 - self._last_return) if self._last_return is not None \
            else 0.0
        with self._cv:
            while not self._buf:
                if self._stop.is_set():
                    # close() raced an empty buffer: the fill thread
                    # exits WITHOUT an _END sentinel, so waiting on one
                    # would spin forever
                    self._exhausted = True
                    raise StopIteration
                self._cv.wait(timeout=0.5)
            item = self._buf.popleft()
            if isinstance(item, dict):
                self._buf_bytes -= self._nbytes(item)
            self._cv.notify_all()
        now = self.clock()
        if item is self._END:
            self._exhausted = True
            self.close()
            raise StopIteration
        if isinstance(item, Exception):
            self._exhausted = True
            self.close()
            raise item
        self.controller.observe(now - t0, busy)
        self._last_return = now
        return item

    def pop_link(self) -> tuple[int, int, int] | None:
        """Delegate to the wrapped stream's link FIFO (ISSUE 20).  The
        buffer here is strictly FIFO, so link/batch pairing survives
        any prefetch depth; None when the source has no links (local
        loader, untraced service)."""
        pop = getattr(self.it, "pop_link", None)
        return pop() if pop is not None else None

    def close(self) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        # The underlying stream keeps its socket (and the service's
        # producer, and up to max_bytes of buffered batches) alive
        # otherwise — a train loop that stops at a step target must
        # release the whole chain, not just the fill thread.
        c = getattr(self.it, "close", None)
        if c is not None:
            try:
                c()
            except Exception:  # noqa: BLE001 — teardown is best-effort
                pass


# -- the one-call trainer integration ---------------------------------------

def service_or_local_batches(ds, *, num_epochs: int | None = None,
                             env: dict | None = None,
                             registry=None,
                             on_degrade: Callable[[str], None] | None = None,
                             max_bytes: int = 1 << 30) -> Iterator[dict]:
    """The drop-in for ``ds.batches(num_epochs)`` in a train loop.

    No ``TPUCFN_INPUT_ADDRS`` in the env -> the local iterator,
    unchanged.  With input hosts fanned out -> a resilient service
    stream (failover, then degrade to ``ds`` itself from the exact
    cursor) behind an adaptive prefetcher.  ``ds`` must be the
    :class:`~tpucfn.data.pipeline.ShardedDataset` the trainer would
    have used locally — its ``(pi, pc, batch, seed)`` identity is what
    the handshake asserts against the service.
    """
    addrs = input_addrs_from_env(env)
    if not addrs:
        return ds.batches(num_epochs)
    import itertools

    def local_factory(start_batch: int) -> Iterator[dict]:
        return itertools.islice(ds.batches(num_epochs), start_batch, None)

    e = os.environ if env is None else env
    trainer = getattr(ds, "pi", None)
    if trainer is None:  # loaders without a process identity attr
        trainer = int(e.get("TPUCFN_HOST_ID", "0") or 0)
    pc = getattr(ds, "pc", None)
    if pc is None:
        pc = int(e.get("TPUCFN_WORKERS_COUNT", "0") or 0) or None
    stream = ResilientBatchStream(
        addrs, trainer,
        local_factory=local_factory,
        process_count=pc, batch_size=getattr(ds, "batch", None),
        seed=getattr(ds, "seed", None),
        num_epochs=num_epochs, on_degrade=on_degrade,
        rcvbuf_bytes=int(e.get("TPUCFN_INPUT_RCVBUF", "0") or 0) or None,
        op_deadline_s=float(e.get(INPUT_OP_DEADLINE_ENV, "0") or 0) or None,
        registry=registry,
        mp_workers=0)  # the fallback IS ds.batches(): plain loader order
    return AdaptivePrefetcher(stream, registry=registry,
                              max_bytes=max_bytes)
