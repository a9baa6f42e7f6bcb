"""A pool of gloo ranks for the port's multi-rank tests, and its own tests.

:class:`RankPool` starts ``world`` torch-only processes once (a test file
keeps one pool in a module-scoped fixture), joined in one gloo group.
Each runs the case functions of a source text it is given: a case
``name(rank, world, inputs)`` takes a dict of numpy arrays, the same on
every rank, and returns a dict of arrays, which :meth:`RankPool.run`
hands back, one dict per rank.  JAX stays in the test process: the ranks
import ``torch`` and numpy, never ``jax`` or ``tpucfn``.  A case that
fails on any rank fails the call with that rank's traceback, and the
pool starts fresh ranks for the next call (the others may be stuck in a
collective, which gloo ends after ``COLLECTIVE_TIMEOUT_S``).
"""

import json
import os
import queue
import socket
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
COLLECTIVE_TIMEOUT_S = 60
REPLY = "RANK_REPLY "

WORKER = textwrap.dedent("""
    import json, sys, traceback
    from datetime import timedelta
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world, port, source, timeout = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=float(timeout)))
    cases = {"__name__": "rank_cases"}
    exec(compile(open(source).read(), source, "exec"), cases)
    for line in sys.stdin:
        req = json.loads(line)
        try:
            with np.load(req["in"]) as z:
                inputs = {k: z[k] for k in z.files}
            out = cases[req["case"]](rank, world, inputs)
            np.savez(req["out"], **{k: np.asarray(v) for k, v in out.items()})
            reply = {"ok": True}
        except BaseException:
            reply = {"ok": False, "error": traceback.format_exc()}
        print("RANK_REPLY " + json.dumps(reply), flush=True)
    dist.destroy_process_group()
""")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RankPool:
    """``world`` gloo ranks running the cases of ``source``."""

    def __init__(self, world: int, source: str, workdir: Path):
        self.world, self.dir = world, Path(workdir)
        self.source = self.dir / "cases.py"
        self.source.write_text(source)
        self.procs, self.calls = None, 0

    def _start(self):
        env = dict(os.environ, PYTHONPATH=str(REPO))
        port = str(free_port())
        self.procs, self.replies = [], []
        for rank in range(self.world):
            log = open(self.dir / f"rank{rank}.log", "a")
            p = subprocess.Popen(
                [sys.executable, "-c", WORKER, str(rank), str(self.world),
                 port, str(self.source), str(COLLECTIVE_TIMEOUT_S)],
                env=env, cwd=REPO, stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, stderr=log, text=True)
            log.close()
            q = queue.Queue()
            threading.Thread(target=self._read, args=(p, q),
                             daemon=True).start()
            self.procs.append(p)
            self.replies.append(q)

    @staticmethod
    def _read(proc, q):
        for line in proc.stdout:
            if line.startswith(REPLY):
                q.put(json.loads(line[len(REPLY):]))
        q.put({"ok": False, "error": f"rank exited ({proc.wait()})"})

    def run(self, case: str, timeout: float = 180.0, **inputs) -> list[dict]:
        """Run ``case`` on every rank with ``inputs``; its outputs, one
        dict of arrays per rank."""
        if self.procs is None:
            self._start()
        self.calls += 1
        src = self.dir / f"in{self.calls}.npz"
        np.savez(src, **{k: np.asarray(v) for k, v in inputs.items()})
        outs = [self.dir / f"out{self.calls}r{r}.npz"
                for r in range(self.world)]
        for p, out in zip(self.procs, outs):
            p.stdin.write(json.dumps({"case": case, "in": str(src),
                                      "out": str(out)}) + "\n")
            p.stdin.flush()
        errors = []
        for rank, q in enumerate(self.replies):
            try:
                reply = q.get(timeout=timeout)
            except queue.Empty:
                reply = {"ok": False, "error": f"no reply in {timeout} s"}
            if not reply["ok"]:
                errors.append(f"rank {rank}: {reply['error']}")
        if errors:
            self.close()
            raise AssertionError(f"case {case!r} failed:\n" + "\n".join(errors))
        got = []
        for out in outs:
            with np.load(out) as z:
                got.append({k: z[k] for k in z.files})
        return got

    def close(self):
        if self.procs is None:
            return
        for p in self.procs:
            try:
                p.stdin.close()
            except OSError:
                pass
        for p in self.procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self.procs = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---- the pool's own tests ----------------------------------------------------

CASES = textwrap.dedent("""
    import numpy as np
    import torch
    import torch.distributed as dist

    def rank_sum(rank, world, inputs):
        t = torch.from_numpy(inputs["x"]) * (rank + 1)
        dist.all_reduce(t)
        return {"sum": t.numpy(), "jax": np.array(
            any(m.split(".")[0] in ("jax", "tpucfn") for m in __import__(
                "sys").modules))}

    def fail_on_one(rank, world, inputs):
        if rank == world - 1:
            raise ValueError("the last rank refuses")
        return {}
""")


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(2, CASES, tmp_path_factory.mktemp("pool")) as p:
        yield p


def test_ranks_share_one_group_and_import_no_jax(pool):
    for _ in range(2):  # the same ranks answer call after call
        got = pool.run("rank_sum", x=np.arange(3.0))
        for g in got:
            np.testing.assert_array_equal(g["sum"], np.arange(3.0) * 3)
            assert not g["jax"]
    assert pool.calls == 2


def test_a_failing_rank_fails_the_call_and_the_pool_recovers(pool):
    with pytest.raises(AssertionError, match="the last rank refuses"):
        pool.run("fail_on_one")
    assert pool.procs is None
    got = pool.run("rank_sum", x=np.ones(2))
    np.testing.assert_array_equal(got[0]["sum"], np.full(2, 3.0))
