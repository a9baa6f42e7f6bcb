"""The port's replay queue (``tpucfn_torch/rl/replay.py``) against the JAX
package's (``tpucfn/rl/replay.py``): FIFO order, the sequence counters,
the host spill and its order, the strict no-spill mode, and one
push/pop sequence giving the same slabs in both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucfn.rl.replay import ReplayQueue as JaxReplayQueue
from tpucfn_torch.rl.replay import ReplayQueue


def _slab(v, shape=(4, 3)):
    return {"x": torch.full(shape, float(v)),
            "n": torch.full((4,), v, dtype=torch.int32)}


def test_replay_fifo_order():
    q = ReplayQueue(capacity=3)
    st = q.init_state(_slab(0))
    for v in (1, 2, 3):
        st = q.push(st, _slab(v))
    assert q.size(st) == 3
    for v in (1, 2, 3):
        st, item = q.pop(st)
        assert float(item["x"][0, 0]) == v
    assert q.size(st) == 0
    with pytest.raises(RuntimeError):
        q.pop(st)


def test_replay_counters_track_sequence():
    q = ReplayQueue(capacity=2)
    st = q.init_state(_slab(0))
    st = q.push(st, _slab(1))
    st, _ = q.pop(st)
    st = q.push(st, _slab(2))
    assert int(st["pushed"]) == 2 and int(st["popped"]) == 1
    # the counters are host tensors: the state checkpoints as tensors
    assert all(st[k].device.type == "cpu" and st[k].dtype == torch.int64
               for k in ("head", "tail", "count", "pushed", "popped"))


def test_replay_spill_preserves_order():
    q = ReplayQueue(capacity=2)
    st = q.init_state(_slab(0))
    for v in (1, 2, 3, 4, 5):  # 3..5 spill to host
        st = q.push(st, _slab(v))
    assert q.spilled_total == 3
    assert q.size(st) == 5
    with pytest.raises(RuntimeError):  # spill outstanding: no ckpt allowed
        q.assert_quiescent()
    got = []
    for _ in range(5):
        st, item = q.pop(st)
        got.append(int(item["n"][0]))
    assert got == [1, 2, 3, 4, 5]
    q.assert_quiescent()  # drained: quiescent again


def test_replay_spill_disabled_raises():
    q = ReplayQueue(capacity=1, spill=False)
    st = q.init_state(_slab(0))
    st = q.push(st, _slab(1))
    with pytest.raises(RuntimeError, match="spill is disabled"):
        q.push(st, _slab(2))


def test_popped_slab_is_a_copy():
    """A pop's slab stays as it was when the freed slot is written again
    (here by the spill's re-injection in the same pop)."""
    q = ReplayQueue(capacity=1)
    st = q.init_state(_slab(0))
    st = q.push(st, _slab(1))
    st = q.push(st, _slab(2))  # spilled
    st, item = q.pop(st)       # pops 1, re-injects 2 into the same slot
    assert float(item["x"][0, 0]) == 1.0
    st, item = q.pop(st)
    assert float(item["x"][0, 0]) == 2.0


def test_capacity_must_be_positive():
    for cls in (ReplayQueue, JaxReplayQueue):
        with pytest.raises(ValueError, match="capacity must be >= 1"):
            cls(0)


def test_same_sequence_same_slabs_as_jax():
    """One interleaving of pushes and pops, through a ring of 2 with
    spills, in both packages: the same slabs, counters and spill count."""
    rs = np.random.RandomState(0)
    slabs = [{"obs": rs.randn(3, 5, 2).astype(np.float32),
              "action": rs.randint(0, 4, (3, 5)).astype(np.int32),
              "done": rs.rand(3, 5) < 0.3} for _ in range(7)]
    ops = ["push", "push", "push", "pop", "push", "push", "pop", "pop",
           "push", "pop", "push", "pop", "pop", "pop"]
    jq, tq = JaxReplayQueue(capacity=2), ReplayQueue(capacity=2)
    js = jq.init_state({k: jnp.asarray(v) for k, v in slabs[0].items()})
    ts = tq.init_state({k: torch.from_numpy(v) for k, v in slabs[0].items()})
    pushed = popped = 0
    for op in ops:
        if op == "push":
            s = slabs[pushed]
            js = jq.push(js, {k: jnp.asarray(v) for k, v in s.items()})
            ts = tq.push(ts, {k: torch.from_numpy(v) for k, v in s.items()})
            pushed += 1
        else:
            js, jitem = jq.pop(js)
            ts, titem = tq.pop(ts)
            for k in slabs[0]:
                assert np.array_equal(titem[k].numpy(), np.asarray(jitem[k]))
                assert np.array_equal(titem[k].numpy(), slabs[popped][k])
            popped += 1
        for k in ("head", "tail", "count", "pushed", "popped"):
            assert int(ts[k]) == int(js[k]), (op, k)
        assert tq.size(ts) == jq.size(js)
    assert popped == pushed == 7
    assert tq.spilled_total == jq.spilled_total > 0
