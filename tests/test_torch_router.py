"""The replica router over the port's real ``Server`` and ``ServeEngine``
on the CPU: failover after a kill, a relaunch that joins the old serve
loop before it starts the new one, probation, hedging, and
``drain`` / ``drain_all``.

Two replicas run engines that share one set of tiny fp32 weights (random,
seeded), so greedy output is the same wherever a request lands: every
routed request's tokens are held IDENTICAL to one plain ``Server`` run
(no tolerance; fp32 on both sides, the same engine code).  Unthreaded
tests pump the replicas' loops by hand so each interleaving is
scripted; the threaded ones bound every wait."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from tpucfn_torch.obs.registry import MetricRegistry
from tpucfn_torch.serve import ReplicaFailed, ReplicaRouter, Server
from tpucfn_torch.serve.engine import ServeEngine, demo_llama_engine
from tpucfn_torch.serve.spec import SpecDecoder

torch.set_num_threads(1)

CACHE_LEN = 64


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class LoopGuard:
    """Counts the threads inside an engine's entry points at one time:
    the port's cache is updated in place, so two serve loops on one
    engine would corrupt it."""

    ENTRY_POINTS = ("prefill_batch", "decode", "copy_prefix", "verify",
                    "rollback")

    def __init__(self, engine):
        self.lock = threading.Lock()
        self.active = self.most = self.calls = 0
        for name in self.ENTRY_POINTS:
            setattr(engine, name, self._wrap(getattr(engine, name)))

    def _wrap(self, inner):
        def guarded(*a, **kw):
            with self.lock:
                self.active += 1
                self.calls += 1
                self.most = max(self.most, self.active)
            try:
                return inner(*a, **kw)
            finally:
                with self.lock:
                    self.active -= 1
        return guarded


@pytest.fixture(scope="module")
def weights():
    cfg, eng = demo_llama_engine("tiny", seed=3, max_batch=4,
                                 cache_len=CACHE_LEN, device="cpu")
    return cfg, eng.params


def _engine(weights):
    cfg, params = weights
    return ServeEngine.from_llama(cfg, params, max_batch=4,
                                  cache_len=CACHE_LEN, device="cpu")


def _prompts(n, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 256, rs.randint(3, 12)).tolist() for _ in range(n)]


@pytest.fixture(scope="module")
def reference(weights):
    """Plain greedy tokens of ``_prompts(12)`` at 8 new tokens, from one
    Server."""
    server = Server(_engine(weights), num_blocks=64, block_size=8)
    reqs = [server.submit(p, max_new_tokens=8) for p in _prompts(12)]
    server.run_until_idle()
    return [r.result(timeout=0) for r in reqs]


def _router(engines, clock=None, **kw):
    def factory(i):
        return Server(engines[i], num_blocks=64, block_size=8)

    kw.setdefault("registry", MetricRegistry())
    if clock is not None:
        kw["clock"] = clock
    return ReplicaRouter(factory, len(engines), **kw)


def _pump(router, i):
    try:
        router.replicas[i].server.run_until_idle()
    except ReplicaFailed:
        pass


def _pump_all(router):
    for i, rep in enumerate(router.replicas):
        if rep.server.failed is None:
            _pump(router, i)


def test_failover_after_kill_matches_plain_greedy(weights, reference):
    router = _router([_engine(weights), _engine(weights)])
    prompts = _prompts(12)[:6]
    reqs = [router.submit(p, max_new_tokens=8) for p in prompts]
    assert {a.replica for r in reqs for a in r.attempts} == {0, 1}
    router.replicas[0].server.step()   # replica 0 starts its prefills
    router.kill_replica(0)             # unthreaded: fail + retry inline
    _pump_all(router)
    assert [r.result(0) for r in reqs] == reference[:6]
    retried = [r for r in reqs if r.retries > 0]
    assert retried and all(r.attempts[-1].replica == 1 for r in retried)
    assert router.failovers_c.value == 1
    assert router.failed_c.value == 0
    for rep in router.replicas:
        assert rep.server.kv.allocator.num_used == 0


def test_relaunch_joins_the_old_loop_then_probation(weights, reference):
    """Threaded: replica 1 (a self-draft SpecDecoder on replica 0, as
    ``--spec-replicas 0``) is killed mid-decode; the relaunch joins the
    old loop before the factory builds the new Server, no engine ever
    runs two loops at once, every request completes, and the relaunched
    replica serves again after its probation."""
    engines = [_engine(weights) for _ in range(3)]
    guards = [LoopGuard(e) for e in engines]
    replica_engines = [SpecDecoder(engines[0], engines[2], k=4), engines[1]]
    servers: dict[int, list[Server]] = {0: [], 1: []}
    alive_at_build = []

    def factory(i):
        old = servers[i][-1] if servers[i] else None
        t = old._thread if old is not None else None
        alive_at_build.append(t is not None and t.is_alive())
        srv = Server(replica_engines[i], num_blocks=64, block_size=8)
        servers[i].append(srv)
        return srv

    router = ReplicaRouter(factory, 2, registry=MetricRegistry(),
                           hedge_ms=0.0)
    router.start()
    try:
        prompts = _prompts(12)
        first = [router.submit(p, max_new_tokens=8) for p in prompts[:8]]
        t_end = time.monotonic() + 60
        while (servers[1][0].metrics.snapshot()["generated_tokens"] == 0
               and time.monotonic() < t_end):
            time.sleep(0.002)
        assert servers[1][0].metrics.snapshot()["generated_tokens"] > 0
        router.kill_replica(1)
        assert len(servers[1]) == 2, "replica 1 was not relaunched"
        assert router.replicas[1].state(router.clock()) in (
            "half_open", "closed")
        later = [router.submit(p, max_new_tokens=8) for p in prompts[8:]]
        for r in first + later:
            assert r.done.wait(60), "request never completed"
    finally:
        router.stop()
    assert alive_at_build == [False, False, False]
    assert [r.result(0) for r in first + later] == reference
    assert all(g.most == 1 for g in guards), [g.most for g in guards]
    assert router.failovers_c.value == 1
    assert router.retries_c.value >= 1
    assert servers[1][1].metrics.snapshot()["completed"] >= 1
    assert router.replicas[1].state(router.clock()) == "closed"
    for srv in (servers[0][0], servers[1][1]):
        assert srv.kv.allocator.num_used == 0


def test_relaunch_refused_while_the_old_loop_is_wedged(weights, monkeypatch):
    """A serve loop stuck inside an engine call outlives the join bound:
    the relaunch is refused and the slot stays dead, rather than a second
    loop starting on the same engine."""
    import tpucfn_torch.serve.router as router_mod

    monkeypatch.setattr(router_mod, "RELAUNCH_JOIN_S", 0.2)
    engines = [_engine(weights), _engine(weights)]
    release = threading.Event()
    inner = engines[1].decode

    def stuck_decode(toks):
        release.wait(30)
        return inner(toks)

    engines[1].decode = stuck_decode
    router = _router(engines)
    router.start()
    try:
        reqs = [router.submit(p, max_new_tokens=4) for p in _prompts(4)]
        t_end = time.monotonic() + 30
        while not any(a.replica == 1 for r in reqs for a in r.attempts):
            assert time.monotonic() < t_end
            time.sleep(0.01)
        time.sleep(0.3)   # replica 1 reaches its (stuck) decode
        assert router.relaunch(1) is False
        assert router.replicas[1].state(router.clock()) == "dead"
    finally:
        release.set()
        router.stop()


def test_hedge_fires_and_the_loser_is_cancelled(weights, reference):
    clk = FakeClock()
    router = _router([_engine(weights), _engine(weights)], clock=clk,
                     hedge_ms=100.0)
    req = router.submit(_prompts(12)[0], max_new_tokens=8, deadline_s=60.0)
    assert req.hedge_at == pytest.approx(0.1)
    assert router._fire_due_hedges(0.05) == 0
    clk.advance(0.2)
    assert router._fire_due_hedges() == 1
    hedge = next(a for a in req.attempts if a.hedge)
    primary = next(a for a in req.attempts if not a.hedge)
    assert hedge.replica != primary.replica
    _pump(router, hedge.replica)
    assert req.status == "ok" and req.result(0) == reference[0]
    assert router.hedges_won_c.value == 1
    _pump(router, primary.replica)
    assert primary.sreq.status == "cancelled"
    assert router.completed_c.value == 1
    for rep in router.replicas:
        assert rep.server.kv.allocator.num_used == 0


def test_drain_hands_queued_work_to_the_other_replica(weights, reference):
    router = _router([_engine(weights), _engine(weights)],
                     drain_grace_s=30.0)
    prompts = _prompts(12)[:6]
    reqs = [router.submit(p, max_new_tokens=8) for p in prompts]
    on_zero = [r for r in reqs if r.attempts[0].replica == 0]
    assert on_zero
    assert router.drain(0) is True
    for r in on_zero:
        assert r.attempts[0].sreq.status == "retried"
        assert r.attempts[-1].replica == 1
    _pump(router, 1)
    assert [r.result(0) for r in reqs] == reference[:6]
    assert router.replicas[0].state(router.clock()) == "stopped"
    assert router.submit([42], max_new_tokens=1).attempts[0].replica == 1
    router.relaunch(0, probation=False)
    assert router.replicas[0].state(router.clock()) == "closed"
    assert router.drains_c.value == 1


def test_drain_all_finishes_accepted_work_and_stops_relaunches(
        weights, reference, tmp_path):
    """The SIGTERM form, threaded: every accepted request finishes inside
    the grace, no replica is relaunched, and the incident log records
    the drain."""
    router = _router([_engine(weights), _engine(weights)],
                     ft_dir=tmp_path / "ft")
    router.start()
    try:
        reqs = [router.submit(p, max_new_tokens=8) for p in _prompts(12)]
        router.drain_all(30.0, wait=True)
        assert all(r.done.wait(30) for r in reqs)
    finally:
        router.stop()
    assert [r.result(0) for r in reqs] == reference
    assert router.auto_relaunch is False
    assert {rep.state(router.clock()) for rep in router.replicas} == \
        {"stopped"}
    events = [json.loads(line) for line in
              (tmp_path / "ft" / "events.jsonl").read_text().splitlines()]
    assert [e["kind"] for e in events] == ["drain_all"]
    assert router.snapshot()["completed"] == len(reqs)
