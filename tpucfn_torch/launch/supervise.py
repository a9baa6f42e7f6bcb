"""Self-supervision: the re-exec loop above the gang coordinator (the
port of ``tpucfn/launch/supervise.py``).

``python -m tpucfn_torch.cli launch --ft --supervise`` runs the
coordinator as a child of :func:`run_supervised`, which makes itself a
child subreaper (orphaned ranks reparent to it when the coordinator
dies), reaps every child with ``waitpid(-1)`` (a rank's status lands in
``<ft_dir>/rc/rc-<pid>.json``, the only way an adopting coordinator can
tell a clean exit from a crash) and relaunches a crashed coordinator up
to ``max_restarts`` times; the relaunched coordinator replays the
write-ahead journal and adopts the running fleet.  A journal that says
the run ended is never restarted; SIGTERM is forwarded and ends the
loop.

:func:`set_child_subreaper`, :func:`_status_rc` and :func:`run_supervised`
are copies held equal to the JAX package's by
``tests/test_torch_isolation.py``.  :func:`supervised_cli_argv` is the
port's own: the child it builds runs ``tpucfn_torch.cli``, so a
relaunched coordinator is the port's, never the JAX package's.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Sequence

from tpucfn_torch.ft.events import append_event
from tpucfn_torch.ft.journal import (
    journal_path,
    replay_journal,
    rotate_journal,
    write_rc,
)

PR_SET_CHILD_SUBREAPER = 36


def set_child_subreaper() -> bool:
    """Linux-only best effort: orphaned grandchildren reparent to us so
    our ``waitpid(-1)`` sees their real exit statuses.  Elsewhere (or
    under a restricted sandbox) adoption still works — unknown deaths
    just degrade to CRASH-with-unknown-rc."""
    try:
        import ctypes

        libc = ctypes.CDLL(None, use_errno=True)
        return libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) == 0
    except Exception:  # noqa: BLE001 — non-Linux / no libc access
        return False


def _status_rc(status: int) -> int:
    if os.WIFSIGNALED(status):
        return -os.WTERMSIG(status)
    return os.WEXITSTATUS(status)


def run_supervised(child_argv: Sequence[str], *, ft_dir: str | Path,
                   max_restarts: int = 3, backoff_s: float = 0.5,
                   env: dict | None = None,
                   sleep=time.sleep) -> int:
    """Run ``child_argv`` (a coordinator invocation) under supervision;
    returns the run's final exit code.

    Restart rule: relaunch only while the journal says the run has NOT
    ended — a coordinator that returned its run's rc (clean finish or
    give_up) propagates it; one that *died* (signal, crash) is
    relaunched with the same argv, and its adoption of the journal is
    what makes the relaunch safe.  ``max_restarts`` bounds the loop so
    a coordinator that crashes on arrival cannot flap forever.
    """
    ft_dir = Path(ft_dir)
    ft_dir.mkdir(parents=True, exist_ok=True)
    try:
        st0, _, _ = replay_journal(journal_path(ft_dir))
        if st0.started and st0.done_rc is not None:
            # A FINISHED previous run's journal must not masquerade as
            # this run's.  The coordinator rotates it on a fresh start —
            # but a child that crashes on arrival never gets there, and
            # the post-exit replay below would then read the OLD run's
            # done rc as this run's result and report a coordinator
            # that trained nothing as a completed run.
            rotate_journal(journal_path(ft_dir))
    except Exception:  # noqa: BLE001 — corrupt journal: let the child's
        pass           # adoption refuse it loudly
    subreaper = set_child_subreaper()
    restarts = 0
    state = {"child_pid": None, "stop_sig": None}

    import signal as _signal

    def _forward(signum, frame):
        # Signal-handler discipline: plain stores + os.kill only.
        state["stop_sig"] = signum
        pid = state["child_pid"]
        if pid is not None:
            try:
                os.kill(pid, signum)
            except ProcessLookupError:
                pass

    prev_term = _signal.getsignal(_signal.SIGTERM)
    try:
        _signal.signal(_signal.SIGTERM, _forward)
    except ValueError:
        prev_term = None  # not the main thread (tests): no forwarding
    try:
        while True:
            proc = subprocess.Popen(
                list(child_argv),
                env=env if env is not None else None)
            state["child_pid"] = proc.pid
            rc: int | None = None
            while rc is None:
                try:
                    pid, status = os.waitpid(-1, 0)
                except ChildProcessError:
                    # no children left at all: the coordinator is gone
                    # and something else reaped it (shouldn't happen —
                    # degrade to its poll)
                    rc = proc.poll()
                    rc = 1 if rc is None else rc
                    break
                if pid == proc.pid:
                    rc = _status_rc(status)
                    # keep the Popen object's bookkeeping honest: we
                    # reaped its child behind its back
                    proc.returncode = rc
                else:
                    # an orphaned grandchild (a rank whose coordinator
                    # died): land its real rc where an adopting
                    # coordinator can find it
                    write_rc(ft_dir, pid, _status_rc(status))
            state["child_pid"] = None
            done_rc = None
            try:
                st, _, _ = replay_journal(journal_path(ft_dir))
                done_rc = st.done_rc if st.started else None
            except Exception:  # noqa: BLE001 — corrupt journal
                # adoption would refuse it loudly too: restarting is
                # futile, propagate the crash
                return rc
            if done_rc is not None:
                return done_rc if rc != 0 else rc
            if rc == 0 or state["stop_sig"] is not None:
                return rc
            if restarts >= max_restarts:
                append_event(ft_dir, "coordinator_give_up",
                             restarts=restarts, rc=rc)
                return rc
            restarts += 1
            append_event(ft_dir, "coordinator_restarted",
                         restarts=restarts, rc=rc,
                         subreaper=subreaper)
            sleep(backoff_s)
    finally:
        if prev_term is not None:
            try:
                _signal.signal(_signal.SIGTERM, prev_term)
            except ValueError:
                pass


def supervised_cli_argv(argv: Sequence[str]) -> list[str]:
    """The child command for ``python -m tpucfn_torch.cli launch
    --supervise``: the port's CLI with the same invocation minus the
    supervise flags (the child must run the coordinator, not another
    supervisor).  Adoption needs no flag: the relaunched coordinator
    finds the unfinished journal."""
    out: list[str] = [sys.executable, "-m", "tpucfn_torch.cli"]
    skip_next = False
    passthrough = False  # past the first bare "--": the USER JOB's argv
    for a in argv:
        if passthrough:
            out.append(a)
            continue
        if skip_next:
            skip_next = False
            continue
        if a == "--":
            passthrough = True
            out.append(a)
            continue
        if a == "--supervise":
            continue
        if a == "--supervise-restarts":
            skip_next = True
            continue
        if a.startswith("--supervise-restarts="):
            continue
        out.append(a)
    return out
