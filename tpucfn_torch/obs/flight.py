"""Flight recorder: the fleet's last-N-seconds, always in memory (a copy
of ``tpucfn/obs/flight.py``, held equal to it definition by definition
by ``tests/test_torch_isolation.py`` except for
:meth:`FlightRecorder.sample_device` and the constructor's comment on
it, which read the card through ``torch.cuda``: the JAX package's only
device probe).

When the ft plane declares an incident, the operator's evidence so far
was one ``events.jsonl`` row — nothing about what each host was *doing*
in its final seconds (ISSUE 6).  The :class:`FlightRecorder` is the
black box that fixes that: a bounded in-memory ring of high-frequency
samples (step durations, data-wait, HBM bytes-in-use/peak, serve queue
depth, scheduler decisions) that costs O(capacity) memory forever and
is materialized only when someone asks:

* **on signal / atexit** — :meth:`install_dump_handlers` writes the
  ring to ``<dir>/flight-host{NNN}.jsonl`` when the process ends (the
  gang coordinator's SIGTERM included), so even a host that dies keeps
  its last seconds on disk;
* **on demand** — the obs HTTP server's ``GET /flightrecorder`` route
  returns :meth:`snapshot` as JSON (tpucfn/obs/server.py);
* **at detect time** — :class:`~tpucfn.ft.coordinator.GangCoordinator`
  fetches every surviving host's ring over that route *before* it kills
  the gang, writing ``<ft_dir>/flight/incident{NNN}-host{HHH}.jsonl``
  so every incident carries the fleet's final seconds (the postmortem
  bundle's per-host tails).

Sample schema (one JSON object per ring entry; ``seq`` is a monotonic
per-recorder counter so a reader can tell how much history the ring
overwrote)::

    {"kind": "step",  "t": <wall>, "seq": 17, "step": 120, "dur_s": 0.2}
    {"kind": "hbm",   "t": <wall>, "seq": 18, "used": ..., "peak": ...,
     "limit": ...}
    {"kind": "serve", "t": <wall>, "seq": 19, "queue": 3, "running": 8,
     "occupancy": 0.8}
    {"kind": "sched", "t": <wall>, "seq": 20, "work": "prefill",
     "batch": 4, "bucket": 32}

Dump file layout: a ``{"kind": "flight_dump", ...}`` header line
(host/role/capacity/recorded/dropped/samples) followed by one line per
sample.  The read side (:func:`read_flight_file`) is torn-tolerant and
counting, like every other JSONL reader in the repo — a dump cut short
by SIGKILL mid-write yields whatever complete lines landed.
"""

from __future__ import annotations

import collections
import json
import os
import signal as _signal
import threading
import time
from pathlib import Path

from tpucfn_torch.obs.goodput import host_id_from_path, read_jsonl_counting

FLIGHT_GLOB = "flight-host*.jsonl"

# Canonical kinds of the flight FILE format (ISSUE 10): "flight" is a
# live snapshot body, "flight_dump" the on-disk header line.  Ring
# SAMPLE kinds stay an open vocabulary (each instrumentation point
# names its own); only the file-level kinds are matched by readers.
FLIGHT_FILE_KINDS = ("flight", "flight_dump")


def flight_path(d: str | Path, host_id: int) -> Path:
    return Path(d) / f"flight-host{host_id:03d}.jsonl"


def incident_flight_path(d: str | Path, incident: int, host_id: int) -> Path:
    """Where the coordinator lands a host's ring captured at detect time
    (``<ft_dir>/flight/``); ``host_id_from_path`` still parses the host."""
    return Path(d) / f"incident{incident:03d}-host{host_id:03d}.jsonl"


class FlightRecorder:
    """Bounded ring of high-frequency samples for one process.

    ``record()`` is cheap (one dict build + deque append under a lock)
    so instrumentation points can call it every step / serve iteration;
    the ring overwrites oldest-first and counts what it dropped.  All
    sampling is pull-free — nothing leaves the process until a dump or
    an HTTP snapshot asks.
    """

    def __init__(self, capacity: int = 4096, host_id: int = 0, *,
                 role: str = "", clock=time.time):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.host_id = host_id
        self.role = role
        self.clock = clock
        self._ring: collections.deque[dict] = collections.deque(
            maxlen=capacity)
        # REENTRANT on purpose: the SIGTERM dump handler runs ON the
        # main thread, possibly interrupting a record() that already
        # holds this lock — a plain Lock would self-deadlock exactly at
        # the moment the dump exists for (the coordinator's stop_all),
        # and the process would hang until the SIGKILL escalation.
        self._lock = threading.RLock()
        self._seq = 0
        self._dropped = 0
        # device resolved once; None-result memoized so a process on the
        # CPU does not probe torch.cuda every step for nothing.
        self._device = None
        self._device_probed = False

    def record(self, kind: str, **fields) -> dict:
        rec = {"kind": kind, "t": self.clock(), **fields}
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            if len(self._ring) == self.capacity:
                self._dropped += 1
            self._ring.append(rec)
        return rec

    def sample_device(self, device=None) -> dict | None:
        """One ``hbm`` sample from :func:`~tpucfn_torch.obs.metrics.
        device_memory_stats` — None-safe: a process that trains on the
        CPU (or has not touched CUDA yet) gets no stats, and once the
        first probe found none the call is a memoized no-op (no sample,
        no error)."""
        from tpucfn_torch.obs.metrics import device_memory_stats

        if device is None:
            if self._device_probed and self._device is None:
                return None  # known stats-less process
            device = self._device
        stats = device_memory_stats(device)
        if device is None and not self._device_probed:
            # first resolve: remember the card (or that there is none)
            self._device_probed = True
            if stats is not None:
                import torch

                self._device = torch.device(
                    "cuda", torch.cuda.current_device())
        if stats is None:
            return None
        return self.record(
            "hbm",
            used=stats.get("bytes_in_use"),
            peak=stats.get("peak_bytes_in_use"),
            limit=stats.get("bytes_limit"))

    def snapshot(self) -> dict:
        """The ring's current contents plus its own accounting — the
        ``GET /flightrecorder`` body and the dump's source of truth."""
        with self._lock:
            samples = list(self._ring)
            seq, dropped = self._seq, self._dropped
        return {"kind": "flight", "host": self.host_id, "role": self.role,
                "t": self.clock(), "capacity": self.capacity,
                "recorded": seq, "dropped": dropped, "samples": samples}

    # -- materialization ---------------------------------------------------

    def dump(self, path: str | Path) -> Path:
        """Write the ring to ``path`` (a dir derives the standard
        per-host file name).  Truncate-write on purpose: the latest ring
        IS the forensic record; repeated dumps (signal then atexit) must
        not concatenate two overlapping rings into one fused timeline."""
        p = Path(path)
        if p.suffix != ".jsonl":
            p.mkdir(parents=True, exist_ok=True)
            p = flight_path(p, self.host_id)
        else:
            p.parent.mkdir(parents=True, exist_ok=True)
        write_flight_dump(p, self.snapshot())
        return p

    def install_dump_handlers(self, d: str | Path,
                              signals=(_signal.SIGTERM,)) -> None:
        """Dump to ``d`` on process exit: atexit for clean ends, and the
        given signals (default SIGTERM — what the coordinator's
        ``stop_all`` sends first) for killed ones.  After dumping, the
        signal's default disposition is restored and the signal
        re-raised so the process still dies with the right status.
        Signal installation needs the main thread; elsewhere only the
        atexit hook is armed."""
        import atexit

        d = Path(d)
        atexit.register(self._dump_quietly, d)
        for sig in signals:
            try:
                prev = _signal.getsignal(sig)

                def _handler(signum, frame, _prev=prev):
                    self._dump_quietly(d)
                    if _prev is _signal.SIG_IGN:
                        # the process was configured to survive this
                        # signal (inherited ignore); dump, keep living
                        return
                    if callable(_prev) and _prev is not _signal.SIG_DFL:
                        _prev(signum, frame)
                    else:
                        _signal.signal(signum, _signal.SIG_DFL)
                        os.kill(os.getpid(), signum)

                _signal.signal(sig, _handler)
            except ValueError:  # not the main thread: atexit still holds
                break

    def _dump_quietly(self, d: Path) -> None:
        try:
            self.dump(d)
        except OSError:
            pass  # a full/vanished disk must not mask the real exit


# HBM watermark defaults (ISSUE 12 satellite, ROADMAP forensics
# follow-on): "used/limit sustained over a threshold" — the burn-rate
# shape the serve SLO plane uses, applied to device memory so an OOM
# becomes a /healthz prediction instead of a postmortem.
HBM_WATERMARK_THRESHOLD = 0.92
HBM_WATERMARK_SUSTAIN_S = 30.0


def hbm_watermark(samples, *, threshold: float = HBM_WATERMARK_THRESHOLD,
                  sustain_s: float = HBM_WATERMARK_SUSTAIN_S,
                  now: float | None = None) -> dict:
    """Burn-rate-style watermark over a ring's ``hbm`` samples.

    Walks the contiguous tail of samples whose ``used/limit`` ratio is
    at or above ``threshold``; the alert fires only when that tail has
    *sustained* for ``sustain_s`` seconds — one transient allocation
    spike (a compile's scratch, a fused temp) must not page anyone.

    Returns ``{"level": "ok"|"alert"|"no_data", "ratio", "peak_ratio",
    "sustained_s", "threshold", "sustain_s"}`` — merged into /healthz
    detail by the obs server whenever a flight recorder is attached.
    ``level`` never flips the probe's HTTP status: a watermark is a
    prediction for operators and autoscalers, not a liveness verdict.
    """
    pts: list[tuple[float, float]] = []
    for s in samples:
        # tpucfn: allow[vocab-drift] ring SAMPLE kinds are open (module doc)
        if s.get("kind") != "hbm":
            continue
        used, limit = s.get("used"), s.get("limit")
        if not isinstance(used, (int, float)) \
                or not isinstance(limit, (int, float)) or limit <= 0:
            continue
        pts.append((float(s.get("t", 0.0)), used / limit))
    base = {"threshold": threshold, "sustain_s": sustain_s}
    if not pts:
        return {"level": "no_data", "ratio": None, "peak_ratio": None,
                "sustained_s": 0.0, **base}
    ratio = pts[-1][1]
    peak = max(r for _, r in pts)
    over_since = None
    for t, r in reversed(pts):
        if r < threshold:
            break
        over_since = t
    sustained = 0.0
    if over_since is not None and ratio >= threshold:
        end = pts[-1][0] if now is None else now
        sustained = max(0.0, end - over_since)
    level = "alert" if sustained >= sustain_s else "ok"
    return {"level": level, "ratio": round(ratio, 4),
            "peak_ratio": round(peak, 4),
            "sustained_s": round(sustained, 3), **base}


def write_flight_dump(path: str | Path, snapshot: dict) -> Path:
    """One dump file from a :meth:`FlightRecorder.snapshot`-shaped dict:
    header line (``samples`` becomes a count) then one line per sample.
    Shared by the in-process dump and the coordinator's HTTP capture so
    the two artifacts are read by the same :func:`read_flight_file`."""
    p = Path(path)
    samples = snapshot.get("samples") or []
    header = {**snapshot, "kind": "flight_dump", "samples": len(samples)}
    with open(p, "w", buffering=1) as f:
        f.write(json.dumps(header) + "\n")
        for s in samples:
            f.write(json.dumps(s) + "\n")
    return p


def read_flight_file(path: str | Path) -> tuple[dict | None, list[dict], int]:
    """``(header, samples, skipped)`` for one dump file.  Torn/undecodable
    lines are skipped and counted (a SIGKILL mid-dump leaves a partial
    tail); a dump missing its header (torn head) still yields samples."""
    recs, skipped = read_jsonl_counting(path)
    header = None
    samples: list[dict] = []
    for r in recs:
        if r.get("kind") == "flight_dump" and header is None:
            header = r
        else:
            samples.append(r)
    return header, samples, skipped


def read_flight_dir(d: str | Path,
                    glob: str = FLIGHT_GLOB) -> dict[int, dict]:
    """``host_id -> {header, samples, skipped, path}`` for every dump
    matching ``glob`` under ``d`` (missing dir -> ``{}``).  When several
    files name the same host, the lexicographically last wins (incident
    captures are numbered, so later incidents shadow earlier ones)."""
    out: dict[int, dict] = {}
    dd = Path(d)
    if not dd.is_dir():
        return out
    for p in sorted(dd.glob(glob)):
        host = host_id_from_path(p)
        if host is None:
            continue
        header, samples, skipped = read_flight_file(p)
        if header is None and not samples:
            continue
        out[host] = {"header": header, "samples": samples,
                     "skipped": skipped, "path": str(p)}
    return out
