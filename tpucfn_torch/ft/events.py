"""Canonical vocabulary of the ft plane's ``events.jsonl`` (ISSUE 10).

Every incident event the GangCoordinator or the serve-tier
ReplicaRouter appends carries a ``kind`` from this tuple — and both
emitters validate against it, so a typo'd kind fails loudly at the
emit site instead of producing a row no consumer (``tpucfn ft
status``, goodput incident attribution, postmortem assembly) will ever
match.  This is the same drift-proofing heartbeat file naming got with
``HB_GLOB`` in PR 5, applied to the event vocabulary; the
``vocab-drift`` rule of ``tpucfn check`` reads this tuple via ``ast``
(no imports) and flags stray literals anywhere in the package.

jax-free on purpose: the coordinator, the router, and the analyzer all
import it.
"""

from __future__ import annotations

EVENT_KINDS = (
    # lifecycle (GangCoordinator)
    "launch",          # gang (re)launched: hosts, generation
    "solo_launch",     # one host relaunched into the running gang
    "host_exit",       # a rank finished cleanly (rc 0)
    "done",            # the run ended; final rc
    # incident flow (GangCoordinator + ReplicaRouter)
    "detect",          # failures observed: [{host, kind, rc, step, detail}]
    "decide",          # policy verdict for an incident
    "flight_capture",  # survivors' flight rings captured at detect time
    "span_capture",    # survivors' span tails (+ optional profiles)
                       # captured at detect time (ISSUE 20)
    "recovered",       # incident closed: action, mttr_s
    "give_up",         # restart budget exhausted / unrecoverable
    "goodput_incident",  # goodput attribution row (downtime, lost work)
    # graceful degradation (ISSUE 7)
    "drain",           # drain initiated (preemption notice / router drain)
    "drained",         # router: one replica's drain finished (clean flag)
    "drain_all",       # router: process-level SIGTERM drain
    "shrink",          # contract re-converged at N-k survivors
    "ckpt_retry",      # corrupt checkpoint quarantined, retrying earlier
    "ckpt_blacklist_expired",  # a newer finalized step retired the blacklist
    # serve-tier specifics (ISSUE 9)
    "relaunch_skipped",  # old serve thread outlived the join; slot stays dead
    # disaggregated input plane (ISSUE 11): input-host failures degrade
    # trainers to local loading — they never restart the gang or touch
    # the restart budget
    "input_degraded",    # an input host died/hung; trainers load locally
    "input_recovered",   # the input host was solo-relaunched
    # coordinator crash-safety (ISSUE 12): the supervisor itself is
    # journaled, restartable, and adoptable
    "coordinator_adopted",    # a restarted coordinator attached to the fleet
    "coordinator_restarted",  # the --supervise loop relaunched a dead one
    "coordinator_give_up",    # the supervise restart budget ran out
    "coordinator_killed",     # chaos kill_coordinator fired (bookkeeping)
    # chaos bookkeeping (ISSUE 4/7 harness)
    "chaos_preempt_notice",
    "chaos_ckpt_corrupted",
    "host_lost",
    # network fault injection (ISSUE 15): a net_* chaos op landed on
    # the registered ChaosProxy instances
    "chaos_net_fault",
    # provisioner policy loop (ISSUE 18): the goodput-driven controller
    # decided (signal + action from the decision table), actuated
    # (grow = planned drain-relaunch with the input plane activated,
    # shrink = input hosts released), or flagged chronic starvation
    # (observation-only — the operator owns accelerator topology)
    "provision_decision",
    "provision_actuated",
    "provision_flagged",
    # RL plane (tpucfn.rl.loop): Podracer actors+learner on one mesh.
    # rl_run_start marks a fresh loop; rl_resumed a post-restore
    # continuation (carries the iteration and ckpt step it rejoined at,
    # so the chaos drill can pin the recovery boundary).
    "rl_run_start",
    "rl_resumed",
)


def validate_event_kind(kind: str) -> str:
    """Raise at the emit site on a kind outside the canonical set — a
    row nothing will ever match is a silent bug, not an event."""
    if kind not in EVENT_KINDS:
        raise ValueError(
            f"event kind {kind!r} is not in ft.events.EVENT_KINDS — add it "
            "to the canonical tuple (and its consumers) or fix the typo")
    return kind


def append_event(ft_dir, kind: str, **fields) -> dict:
    """Append one validated event row, flushed AND fsync'd before
    returning (ISSUE 12 satellite): the detect/decide record of the
    very incident that kills the writer must survive the writer —
    a buffered append was exactly the durability hole the coordinator
    shipped with.  Shared by the coordinator and the supervise loop."""
    import json
    import os
    import time
    from pathlib import Path

    rec = {"ts": time.time(), "kind": validate_event_kind(kind), **fields}
    with open(Path(ft_dir) / "events.jsonl", "a") as f:
        f.write(json.dumps(rec) + "\n")
        f.flush()
        os.fsync(f.fileno())
    return rec
