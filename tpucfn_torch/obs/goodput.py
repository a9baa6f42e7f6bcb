"""The device peak behind the live MFU gauge, the goodput ledger's
writer, and the ledger readers the flight recorder and the gang
coordinator use (the port of that part of ``tpucfn/obs/goodput.py``).

:func:`device_peak_flops`, :class:`GoodputLedger` (with ``ledger_path``)
and the readers (:func:`parse_jsonl_line`, :func:`read_jsonl_counting`,
:func:`host_id_from_path`, :func:`read_goodput_dir`,
:func:`fleet_window_observation`, with ``RECORDED_BUCKETS`` and
``LEDGER_GLOB``) are copies held equal to the JAX package's by
``tests/test_torch_isolation.py``.  The peak table is the port's own:
the JAX package lists TPU generations, this one the card it runs on.
The merge, the report and the ``tpucfn obs goodput`` CLI are not ported
(ROADMAP A9); the port's loop passes no ledger, so ``TrainerObs`` writes
through a ``GoodputLedger(None)``, a no-op.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from pathlib import Path

# Peak dense bf16 TFLOP/s by a substring of torch.cuda.get_device_name(),
# from the public specification: NVIDIA H100 SXM (the H100 80GB HBM3) at
# 989 at its full 700 W.  Differs from the JAX package's TPU table.
PEAK_BF16_TFLOPS = (
    ("h100 80gb hbm3", 989.0),
)


# Buckets the ledger writer records (the JAX package's vocabulary; the
# port's loop writes none of them yet, see the module doc).
RECORDED_BUCKETS = ("step", "compile", "compile_cached", "compile_fetched",
                    "data_wait", "ckpt", "act", "learn", "refresh")

LEDGER_GLOB = "goodput-host*.jsonl"


def device_peak_flops(device_kind: str) -> float | None:
    """Peak FLOP/s (not TFLOP/s) for ``device_kind``, or None for
    devices without a published peak (CPU hosts: MFU stays unset rather
    than lying)."""
    kind = device_kind.lower()
    for key, tflops in PEAK_BF16_TFLOPS:
        if key in kind:
            return tflops * 1e12
    return None


def ledger_path(d: str | Path, host_id: int) -> Path:
    return Path(d) / f"goodput-host{host_id:03d}.jsonl"


class GoodputLedger:
    """Per-host goodput JSONL writer (see module doc for the schema).

    Opens in append mode and immediately writes a ``window`` marker: a
    restarted incarnation appending to the same file is exactly how the
    merge learns where downtime gaps are.  ``GoodputLedger(None)`` is a
    full no-op so instrumentation points can call unconditionally.
    """

    def __init__(self, d: str | Path | None, host_id: int = 0, *,
                 role: str = "trainer", clock=time.time,
                 pid: int | None = None):
        self.host_id = host_id
        self.role = role
        self.clock = clock
        self.path: Path | None = None
        self._f = None
        self._lock = threading.Lock()
        if d is not None:
            dd = Path(d)
            dd.mkdir(parents=True, exist_ok=True)
            self.path = ledger_path(dd, host_id)
            # Line-buffered append, one write per record — a reader never
            # sees a torn line except at a crash boundary (tolerated).
            self._f = open(self.path, "a", buffering=1)
            self._write({"kind": "window", "host": host_id, "role": role,
                         "pid": os.getpid() if pid is None else pid})

    @property
    def enabled(self) -> bool:
        return self._f is not None

    def _write(self, rec: dict) -> None:
        rec.setdefault("t", self.clock())
        line = json.dumps(rec)
        with self._lock:
            if self._f is not None:
                self._f.write(line + "\n")

    def account(self, bucket: str, dur_s: float, *,
                step: int | None = None) -> None:
        """Attribute ``dur_s`` seconds to ``bucket`` (one of
        ``RECORDED_BUCKETS``; unknown buckets are written as-is and
        merged into ``idle``-adjacent custom columns by nobody — keep to
        the vocabulary)."""
        if self._f is None:
            return
        rec = {"kind": "phase", "bucket": bucket, "dur_s": float(dur_s),
               "host": self.host_id}
        if step is not None:
            rec["step"] = int(step)
        self._write(rec)

    def close(self) -> None:
        if self._f is None:
            return
        self._write({"kind": "close", "host": self.host_id})
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def parse_jsonl_line(line: str | bytes) -> dict | None:
    """The ONE tolerant JSONL line rule every counting reader shares
    (here and aggregate.JsonlTailer): bytes decode with U+FFFD
    replacement, parse failures and non-dict records -> None — the
    caller counts the skip.  Corruption confined to a JSON string
    value still parses (as U+FFFD text) and the record survives;
    structural corruption is what this rejects without raising."""
    if isinstance(line, bytes):
        line = line.decode("utf-8", errors="replace")
    try:
        rec = json.loads(line)
    except json.JSONDecodeError:
        return None
    return rec if isinstance(rec, dict) else None


def read_jsonl_counting(path: str | Path) -> tuple[list[dict], int]:
    """All records of one JSONL; torn/undecodable lines are skipped AND
    counted (the file may still be appended to, or its writer died
    mid-line), non-UTF-8 bytes tolerated — never raised on."""
    out: list[dict] = []
    skipped = 0
    try:
        with open(path, encoding="utf-8", errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = parse_jsonl_line(line)
                if rec is None:
                    skipped += 1
                else:
                    out.append(rec)
    except OSError:
        return [], 0
    return out, skipped


def host_id_from_path(p: str | Path) -> int | None:
    """``...host{NNN}.jsonl`` -> ``NNN``, or None when the stem doesn't
    parse.  Every per-host-file reader (ledgers here, heartbeats in the
    CLI) goes through this so the naming convention lives in one place."""
    try:
        return int(Path(p).stem.rsplit("host", 1)[1])
    except (IndexError, ValueError):
        return None


def read_goodput_dir(d: str | Path) -> tuple[dict[int, list[dict]], int]:
    """``host_id -> [records]`` for every ledger under ``d`` plus the
    total count of torn/skipped lines.  Missing/empty dir -> ``({}, 0)``
    — the merge renders an empty report, it does not raise."""
    by_host: dict[int, list[dict]] = {}
    skipped = 0
    dd = Path(d)
    if not dd.is_dir():
        return by_host, skipped
    for p in sorted(dd.glob(LEDGER_GLOB)):
        host = host_id_from_path(p)
        if host is None:
            skipped += 1
            continue
        recs, sk = read_jsonl_counting(p)
        skipped += sk
        if recs:
            by_host[host] = recs
    return by_host, skipped


def fleet_window_observation(goodput_dir: str | Path, *,
                             since_t: float | None = None) -> dict | None:
    """Live windowed view of the fleet ledgers for the provisioner
    policy loop (ISSUE 18): bucket *shares* of wall since ``since_t``
    (wall clock, the same clock ledger records carry in ``t``).

    Unlike :func:`merge_goodput` — the end-of-run postmortem — this is
    read mid-run, repeatedly, over ledgers still being appended to, and
    the caller cares about the RECENT window only: a policy must not
    keep acting on starvation that an earlier actuation already fixed.
    Filtering by ``t`` (not by incarnation) is what makes "the window
    since my last actuation" expressible.

    Per host: phase records with finite ``t >= since_t``; the host wall
    is the ``t``-span of its in-window records; ``idle`` is the
    residual.  Shares are averaged across hosts (the same merge rule as
    :func:`merge_goodput`).  Returns ``None`` when no host has a
    usable window (empty dir, all records filtered, zero wall) — the
    policy treats that as "no evidence", never as "healthy".
    """
    by_host, _ = read_goodput_dir(goodput_dir)
    per_host: list[dict] = []
    for records in by_host.values():
        lo = hi = None
        buckets = {b: 0.0 for b in RECORDED_BUCKETS}
        for rec in records:
            t = rec.get("t")
            if not isinstance(t, (int, float)) or not math.isfinite(t):
                continue
            if since_t is not None and t < since_t:
                continue
            lo = t if lo is None else min(lo, t)
            hi = t if hi is None else max(hi, t)
            if rec.get("kind") != "phase":
                continue
            dur = rec.get("dur_s")
            bucket = rec.get("bucket")
            if (isinstance(dur, (int, float)) and math.isfinite(dur)
                    and dur >= 0 and bucket in buckets):
                buckets[bucket] += dur
        if lo is None or hi is None:
            continue
        wall = hi - lo
        if wall <= 0:
            continue
        shares = {b: min(1.0, v / wall) for b, v in buckets.items()}
        shares["idle"] = max(0.0, 1.0 - sum(shares.values()))
        per_host.append({"wall_s": wall, "shares": shares})
    if not per_host:
        return None
    n = len(per_host)
    share_names = set()
    for h in per_host:
        share_names.update(h["shares"])
    shares = {b: sum(h["shares"].get(b, 0.0) for h in per_host) / n
              for b in sorted(share_names)}
    return {
        "wall_s": sum(h["wall_s"] for h in per_host) / n,
        "shares": shares,
        "goodput_ratio": shares.get("step", 0.0),
        "num_hosts": n,
    }
