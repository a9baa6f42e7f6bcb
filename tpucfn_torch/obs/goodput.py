"""The device peak behind the live MFU gauge, and the goodput ledger's
writer (the port of what ``TrainerObs`` takes from
``tpucfn/obs/goodput.py``).

:func:`device_peak_flops` and :class:`GoodputLedger` (with
``ledger_path``) are copies held equal to the JAX package's by
``tests/test_torch_isolation.py``.  The peak table is the port's own:
the JAX package lists TPU generations, this one the card it runs on.
The ledger's readers and the ``tpucfn obs goodput`` CLI are not ported
(ROADMAP A9); the port's loop passes no ledger, so ``TrainerObs`` writes
through a ``GoodputLedger(None)``, a no-op.
"""

from __future__ import annotations

import json
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
