"""Trajectory queue on the card, with host spill as the fallback (the
port of ``ReplayQueue`` in ``tpucfn/rl/replay.py``).

The actor→learner hand-off is a queue of fixed-shape trajectory slabs.
Keeping it on the device means the learner batch never goes through
the host: the ring is a preallocated ``[capacity, ...]`` tensor per
slab field, a push is one ``index_copy_`` per field and a pop one
device copy out of the ring.

**Sequence discipline**: slabs leave in arrival order, and the
``head``/``tail``/``count``/``pushed``/``popped`` counters are part of
the queue state, which the loop checkpoints with the learner state, so
a restored run replays the same batch sequence.  The counters are
host tensors: a push or pop never waits on the card to learn whether
the ring is full.

**Host spill** is the fallback: a push into a full ring moves the slab
to host memory and re-injects it, in order, as pops free slots.  The
loop drains the queue every iteration, so the spill is transient, and
:meth:`assert_quiescent` guards each save: a save with slabs spilled
would under-describe the queue.
"""

from __future__ import annotations

from collections import deque

import torch

_COUNTERS = ("head", "tail", "count", "pushed", "popped")


class ReplayQueue:
    """FIFO queue of fixed-shape trajectory slabs (dicts of tensors),
    device-resident.

    ``capacity`` is the ring size (slots are preallocated from the
    example slab's shapes, on its device).  ``spill=True`` enables the
    host overflow deque; with ``spill=False`` a push into a full ring
    raises.
    """

    def __init__(self, capacity: int = 4, *, spill: bool = True):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.spill_enabled = spill
        self._spill: deque = deque()
        self.spilled_total = 0
        self._slot_ids = None

    # -- state -------------------------------------------------------------

    def init_state(self, example: dict) -> dict:
        """Fresh queue state: zeroed ``[capacity, ...]`` slots on the
        example's device plus the counters (0-dim int64 host tensors), one
        flat dict of tensors that checkpoints with the rest."""
        slots = {k: torch.zeros((self.capacity, *x.shape), dtype=x.dtype,
                                device=x.device)
                 for k, x in example.items()}
        return {"slots": slots,
                **{c: torch.zeros((), dtype=torch.int64) for c in _COUNTERS}}

    # -- device writes and reads -----------------------------------------

    def _index(self, slots: dict, i: int) -> torch.Tensor:
        """Slot ``i`` as a one-element index on the ring's device (a view
        of an arange made once: no host-to-device copy per push)."""
        device = next(iter(slots.values())).device
        if self._slot_ids is None or self._slot_ids.device != device:
            self._slot_ids = torch.arange(self.capacity, device=device)
        return self._slot_ids[i:i + 1]

    def _push_fn(self, state, item):
        idx = self._index(state["slots"], int(state["head"]) % self.capacity)
        for k, s in state["slots"].items():
            s.index_copy_(0, idx, item[k].to(s.device).unsqueeze(0))
        return {**state, "head": state["head"] + 1,
                "count": state["count"] + 1,
                "pushed": state["pushed"] + 1}

    def _pop_fn(self, state):
        i = int(state["tail"]) % self.capacity
        # a copy: the slot is free for the next push once popped
        item = {k: s[i].clone() for k, s in state["slots"].items()}
        new = {**state, "tail": state["tail"] + 1,
               "count": state["count"] - 1,
               "popped": state["popped"] + 1}
        return new, item

    # -- host API ----------------------------------------------------------

    def __len__(self) -> int:
        return len(self._spill)

    def size(self, state) -> int:
        """Slabs queued (device ring + host spill)."""
        return int(state["count"]) + len(self._spill)

    def push(self, state, item):
        """Enqueue one slab; returns the new queue state.

        Full ring + spill enabled → the slab is copied to host and
        queued there (arrival order preserved: spilled slabs re-enter
        the ring only behind everything already spilled).  Full ring
        without spill raises."""
        if int(state["count"]) >= self.capacity or self._spill:
            if not self.spill_enabled:
                raise RuntimeError(
                    f"ReplayQueue full (capacity={self.capacity}) and "
                    "host spill is disabled")
            self._spill.append({k: v.to("cpu") for k, v in item.items()})
            self.spilled_total += 1
            return state
        return self._push_fn(state, item)

    def pop(self, state):
        """Dequeue the oldest slab; returns ``(state, slab)``.

        Pops always come off the device ring (FIFO); a freed slot is
        immediately backfilled from the host spill so spilled slabs
        flow back in order.  Raises on an empty queue."""
        if int(state["count"]) == 0:
            if not self._spill:
                raise RuntimeError("ReplayQueue is empty")
            # ring drained while slabs sit spilled: re-inject then pop
            state = self._push_fn(state, self._spill.popleft())
        state, item = self._pop_fn(state)
        while self._spill and int(state["count"]) < self.capacity:
            state = self._push_fn(state, self._spill.popleft())
        return state, item

    def assert_quiescent(self) -> None:
        """Checkpoint-boundary guard: the host spill must be empty, or
        the fixed-shape state under-describes the queue and a restore
        would drop slabs (sequence discipline broken)."""
        if self._spill:
            raise RuntimeError(
                f"{len(self._spill)} spilled slab(s) outstanding at a "
                "checkpoint boundary — drain the queue before saving")
