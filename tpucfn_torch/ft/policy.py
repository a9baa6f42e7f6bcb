"""The restore-failure contract of the fault-tolerance plane (copies of
``RESTORE_FAILED_RC``, ``CKPT_BLACKLIST_ENV`` and ``parse_ckpt_blacklist``
from ``tpucfn/ft/policy.py``, held equal to them by
``tests/test_torch_isolation.py`` and ``tests/test_torch_ckpt.py``).

A rank whose existing checkpoint will not restore exits with
``RESTORE_FAILED_RC``; the gang coordinator then relaunches with the bad
step listed in ``TPUCFN_CKPT_BLACKLIST``, which
:class:`tpucfn_torch.ckpt.CheckpointManager` skips when it picks the
latest step.  The coordinator, heartbeats and drain are not ported yet
(ROADMAP Queue 1).
"""

from __future__ import annotations

# Exit code a rank uses when an EXISTING checkpoint failed to restore
# (corruption, truncation).  Distinguishable from a generic crash so the
# coordinator can retry from the previous finalized step instead of
# crash-looping the same corrupt artifact into give_up.
RESTORE_FAILED_RC = 77

# Env var fanned out by the coordinator on a checkpoint-corruption retry:
# comma-separated step numbers the relaunched ranks' CheckpointManager
# must treat as nonexistent for latest-step/restore selection.
CKPT_BLACKLIST_ENV = "TPUCFN_CKPT_BLACKLIST"


def parse_ckpt_blacklist(value: str | None) -> frozenset[int]:
    """Tolerant parse of the env value — a garbled entry is skipped, not
    raised on (a wrong blacklist must degrade to a smaller blacklist,
    never to a crashed resume path)."""
    out = set()
    for part in (value or "").split(","):
        part = part.strip()
        if not part:
            continue
        try:
            out.add(int(part))
        except ValueError:
            continue
    return frozenset(out)
