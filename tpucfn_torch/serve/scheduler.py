"""Continuous-batching decode scheduler.

The serving throughput lever on TPU is the SCHEDULER, not the kernel
(PAPERS.md: the Gemma-on-TPU serving writeup and the Podracer
architectures both win at the batching layer): keep a fixed-shape decode
batch full by admitting new prefills the moment slots and KV blocks free
up, and retire finished sequences in place instead of draining the whole
batch (the static-batch failure mode, where one long request holds B-1
finished slots hostage).

Shape discipline (the TPU-specific part): every jitted engine entry
point runs at a FIXED shape — decode always at ``max_batch`` slots, and
each prefill padded to a power-of-two length bucket capped at the cache
capacity (the same next-pow2 family rule as
``kernels/flash_autotune._bucket``), so steady state compiles
``len(buckets) + 1`` programs total and never again.  Admission control
(queue caps, deadlines, 429s) lives one layer up in
``serve/frontend.py``; this module decides only WHAT RUNS NEXT.

Prefill is cheap in two dimensions (ISSUE 3 tentpole):

* **Prefix caching.**  ``_plan`` asks the KV manager for the longest
  indexed full-block run of the prompt and picks a BACKER — a running,
  already-prefilled holder whose device slot contains those tokens at
  positions ``[0, cached_len)``.  A hit replaces the full bucketed
  prefill with a device-side slot copy (``ServeEngine.copy_prefix``)
  plus a much shorter SUFFIX prefill; the bucket is computed from the
  suffix, so a 64-token shared system prompt turns a 128-bucket prefill
  into a 16- or 32-bucket one.  The scheduler also keeps a host-side
  map of what each FREE slot still holds (``_slot_tokens``): a retired
  sequence's KV stays physically intact until its slot is reassigned,
  so the next wave of requests hits even after every live sharer
  finished (block accounting is NOT shared on this path — the blocks
  were freed at retirement, so the hit allocates a full table and only
  the device copy is saved; when the matched slot itself is chosen as
  the destination the copy is skipped entirely).  No valid backer ->
  plain miss (the scheduler never promises device bytes it cannot
  point at).
* **Batched prefill.**  ``next_work`` admits up to ``max_prefill_batch``
  waiting sequences that share the head-of-line BUCKET (hits and misses
  mix freely — the engine takes a per-lane cache start offset) while
  slots and blocks last; the engine runs them as one vmapped program,
  so compile count stays keyed by bucket alone.

Preemption: when the block pool runs dry mid-decode, the youngest
running sequence is evicted (its references dropped — blocks shared
with other sequences survive — and the sequence re-queued at the front
of the waiting line) and later recomputed from its full prefix — prompt
plus everything it had generated.  Greedy decode makes the recompute
token-identical; sampled requests resume from a fresh rng fold
(documented, not hidden).
"""

from __future__ import annotations

import dataclasses
import enum
import time
from collections import deque

from tpucfn_torch.serve.kvcache import KVCacheManager, OutOfBlocksError, PrefixMatch

# Smallest prefill bucket: below this, padding waste beats recompiles.
MIN_PREFILL_BUCKET = 16

# How deep next_work() scans the waiting queue for same-bucket batch
# mates.  Unbounded, a deep queue would pay O(queue * prompt) host
# hashing per admitted wave — the same O(n^2) class expire() was cured
# of.  A bounded window keeps the scan O(1) per wave; mates deeper than
# this simply ride a later wave.
PREFILL_SCAN_WINDOW = 64


def prefill_bucket(n: int, cache_len: int,
                   min_bucket: int = MIN_PREFILL_BUCKET) -> int:
    """Padded prefill length for an ``n``-token prefix: next power of two
    from ``min_bucket``, capped at the cache capacity (a bucket longer
    than the cache would trip the decode model's overflow poisoning).
    One compile per bucket — the flash-autotune S-bucket rule applied to
    serving shapes."""
    if n > cache_len:
        raise ValueError(f"prefix of {n} tokens exceeds cache_len {cache_len}")
    b = min_bucket
    while b < n:
        b *= 2
    return min(b, cache_len)


class SequenceState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"
    EXPIRED = "expired"   # deadline passed before completion
    CANCELLED = "cancelled"  # withdrawn (hedge loser / drain requeue)


@dataclasses.dataclass
class Sequence:
    """One in-flight generation.  ``prompt`` is immutable; ``generated``
    grows one token per decode step.  After a preemption the re-prefill
    prefix is ``prompt + generated`` (recompute, not cache migration —
    though the recompute itself may hit the prefix cache through any
    surviving sharer)."""

    seq_id: int
    prompt: list[int]
    max_new_tokens: int
    temperature: float = 0.0
    deadline: float | None = None   # absolute time.monotonic() cutoff
    arrival: float = 0.0
    generated: list[int] = dataclasses.field(default_factory=list)
    state: SequenceState = SequenceState.WAITING
    preemptions: int = 0
    # True once the engine has materialized this sequence's KV in its
    # slot — the gate for serving as a copy_prefix backer.
    prefilled: bool = False

    @property
    def prefix(self) -> list[int]:
        return self.prompt + self.generated

    @property
    def last_token(self) -> int:
        return self.generated[-1] if self.generated else self.prompt[-1]

    @property
    def remaining(self) -> int:
        return self.max_new_tokens - len(self.generated)


@dataclasses.dataclass
class PrefillItem:
    """One sequence's share of a (possibly batched) prefill call.
    ``cached_len > 0`` means positions ``[0, cached_len)`` are served by
    copying from ``src_slot``'s device cache before the suffix runs."""
    seq: Sequence
    slot: int
    cached_len: int = 0
    src_slot: int | None = None


@dataclasses.dataclass
class PrefillWork:
    """Run ONE bucketed prefill program over up to K same-bucket
    sequences and sample each one's first token."""
    items: list[PrefillItem]
    bucket: int

    # Single-item compatibility views (most tests and the K=1 path).
    @property
    def seq(self) -> Sequence:
        return self.items[0].seq

    @property
    def slot(self) -> int:
        return self.items[0].slot


@dataclasses.dataclass
class _PrefillPlan:
    """Host-side decision for one candidate admit: how much of the
    prompt the cache serves, who backs it, and what it still costs."""
    match: PrefixMatch | None   # passed to admit() iff a backer exists
    cached_len: int
    src_slot: int | None
    bucket: int
    blocks_needed: int


@dataclasses.dataclass
class DecodeWork:
    """Run one decode iteration over every running slot.

    With speculative decoding (ISSUE 14) the round is propose-verify:
    the serve loop stashes each slot's verified candidate run in
    ``proposed`` before recording it, so the flight ring's scheduler-
    decision samples carry what was speculated — every slot still has
    exactly ONE up-front block reservation; tokens past it are
    committed best-effort by :meth:`~ContinuousBatchingScheduler.
    record_decode_tokens`."""
    slots: dict[int, Sequence]  # slot -> sequence, all reserved for +1 token
    proposed: dict[int, list[int]] | None = None


class ContinuousBatchingScheduler:
    """FCFS admission, prefill-priority interleave, preempt-on-full.

    The engine owns ``max_batch`` physical decode slots; this class owns
    which sequence occupies each slot and whether the next engine call is
    a prefill (a slot and the prompt's KV blocks are available — filling
    the batch beats another decode iteration for every queued request's
    TTFT) or a decode iteration over everything running.
    """

    def __init__(self, kv: KVCacheManager, *, max_batch: int, cache_len: int,
                 eos_id: int | None = None,
                 min_bucket: int = MIN_PREFILL_BUCKET,
                 max_prefill_batch: int = 1,
                 flight=None):
        """``flight`` is a :class:`~tpucfn.obs.flight.FlightRecorder`
        (or None): admissions and preemptions — the scheduler decisions
        a postmortem wants in the final seconds — land in the ring as
        ``admit``/``preempt`` samples (ISSUE 6)."""
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_prefill_batch < 1:
            raise ValueError(
                f"max_prefill_batch must be >= 1, got {max_prefill_batch}")
        self.kv = kv
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.eos_id = eos_id
        self.min_bucket = min_bucket
        self.max_prefill_batch = max_prefill_batch
        self.flight = flight
        self.waiting: deque[Sequence] = deque()
        self.running: dict[int, Sequence] = {}
        self._free_slots = list(range(max_batch - 1, -1, -1))
        # Free-slot residue: slot -> tokens whose KV its rows still hold
        # (the last occupant's written history).  Valid until the slot
        # is reassigned; lets a retired sequence keep backing prefix
        # hits after every live sharer finished.
        self._slot_tokens: dict[int, list[int]] = {}
        # (head seq_id, num_free) of the last head-of-line plan that did
        # NOT fit: while neither changes, every decode round would
        # re-derive the same verdict, so skip the O(prompt) re-hash.
        self._stalled_plan: tuple | None = None

    # -- intake ------------------------------------------------------------
    def add(self, seq: Sequence) -> None:
        """Accept a sequence or raise ValueError when it can NEVER run —
        the whole-pool feasibility check that keeps an oversized request
        from starving at the head of the queue forever.  (Queue-depth
        backpressure and deadlines are the frontend's jurisdiction.)"""
        if not seq.prompt:
            raise ValueError("empty prompt")
        if seq.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {seq.max_new_tokens}")
        total = len(seq.prompt) + seq.max_new_tokens
        if total > self.cache_len:
            raise ValueError(
                f"prompt {len(seq.prompt)} + max_new {seq.max_new_tokens} "
                f"exceeds cache_len {self.cache_len}")
        # The last sampled token is never written back, hence total - 1.
        if not self.kv.fits_at_all(total - 1):
            raise ValueError(
                f"request needs {self.kv.blocks_for(total - 1)} KV blocks; "
                f"pool has {self.kv.allocator.num_blocks}")
        seq.state = SequenceState.WAITING
        self.waiting.append(seq)

    # -- deadline sweep ----------------------------------------------------
    def expire(self, now: float | None = None) -> list[Sequence]:
        """Drop every waiting AND running sequence whose deadline has
        passed (a running one frees its slot and blocks — capacity back
        to live traffic immediately).  Returns the casualties; the
        caller completes their requests with a timeout error.  The
        waiting queue is rebuilt in ONE pass — a deadline storm on a
        deep queue must cost O(n), not O(n^2) of deque.remove()."""
        now = time.monotonic() if now is None else now
        dead = [s for s in self.waiting
                if s.deadline is not None and now > s.deadline]
        if dead:
            dead_ids = {s.seq_id for s in dead}
            self.waiting = deque(s for s in self.waiting
                                 if s.seq_id not in dead_ids)
            for s in dead:
                s.state = SequenceState.EXPIRED
        for slot, s in list(self.running.items()):
            if s.deadline is not None and now > s.deadline:
                self._vacate(slot)
                s.state = SequenceState.EXPIRED
                dead.append(s)
        return dead

    # -- cancellation (ISSUE 9) --------------------------------------------
    def cancel(self, seq_id: int) -> Sequence | None:
        """Withdraw one sequence wherever it is: waiting (dropped from
        the queue) or running (slot and blocks released, exactly like a
        deadline expiry).  Returns the sequence, or None when it is not
        here (already finished/expired) — cancellation of finished work
        is a no-op, which is what first-completion-wins hedging needs."""
        for i, s in enumerate(self.waiting):
            if s.seq_id == seq_id:
                del self.waiting[i]
                s.state = SequenceState.CANCELLED
                return s
        for slot, s in list(self.running.items()):
            if s.seq_id == seq_id:
                self._vacate(slot)
                s.state = SequenceState.CANCELLED
                return s
        return None

    # -- the core decision -------------------------------------------------
    def next_work(self) -> PrefillWork | DecodeWork | None:
        """Prefill if the head-of-line sequence fits (slot + blocks) —
        batched with every later waiter that shares its bucket while
        slots, blocks, and ``max_prefill_batch`` last — else one decode
        iteration, else None (idle)."""
        if self._free_slots and self.waiting:
            stall_key = (self.waiting[0].seq_id, self.kv.allocator.num_free)
            plan = (None if self._stalled_plan == stall_key
                    else self._plan(self.waiting[0]))
            if plan is not None \
                    and plan.blocks_needed <= self.kv.allocator.num_free:
                self._stalled_plan = None
                head = self.waiting.popleft()
                items = [self._admit(head, plan)]
                if self.max_prefill_batch > 1 and self.waiting:
                    taken: set[int] = set()
                    for scanned, seq in enumerate(self.waiting):
                        if (scanned >= PREFILL_SCAN_WINDOW
                                or len(items) >= self.max_prefill_batch
                                or not self._free_slots):
                            break
                        p = self._plan(seq)
                        if (p.bucket != plan.bucket or
                                p.blocks_needed > self.kv.allocator.num_free):
                            continue
                        items.append(self._admit(seq, p))
                        taken.add(seq.seq_id)
                    if taken:
                        self.waiting = deque(
                            s for s in self.waiting
                            if s.seq_id not in taken)
                return PrefillWork(items, plan.bucket)
            # else: blocks are tied up in running sequences; decode below
            # makes progress and will free them (add() guaranteed fit).
            self._stalled_plan = stall_key
        if self.running:
            return DecodeWork(self._reserve_all())
        return None

    def _plan(self, seq: Sequence) -> _PrefillPlan:
        """Price one admit: prefix-cache the longest matched run a
        backer can serve — a running, prefilled holder of the indexed
        blocks (accounting shared by incref) or a FREE slot whose
        retired occupant's KV still covers the prefix (device-only hit,
        full block allocation) — whichever caches more; bucket the
        (suffix) length; fall back to a full prefill when the hit would
        not fit the bucket family (cached_len + bucket > cache_len)."""
        tokens = seq.prefix
        cached_len, src_slot, match_used = 0, None, None
        match = self.kv.match_prefix(tokens)
        if match.cached_len:
            slot = next(
                (slot for slot, s in self.running.items()
                 if s.prefilled and s.seq_id in match.holders), None)
            if slot is not None:
                cached_len, src_slot, match_used = \
                    match.cached_len, slot, match
        if self.kv.prefix_cache_enabled:
            bs = self.kv.block_size
            for slot in self._free_slots:
                held = self._slot_tokens.get(slot)
                if held is None:
                    continue
                n = 0
                for a, b in zip(held, tokens):
                    if a != b:
                        break
                    n += 1
                n = min(n, len(tokens) - 1) // bs * bs
                if n > cached_len:
                    cached_len, src_slot, match_used = n, slot, None
        if cached_len:
            bucket = prefill_bucket(len(tokens) - cached_len,
                                    self.cache_len, self.min_bucket)
            if cached_len + bucket <= self.cache_len:
                shared = match_used.num_blocks if match_used else 0
                return _PrefillPlan(
                    match_used, cached_len, src_slot, bucket,
                    self.kv.blocks_for(len(tokens)) - shared)
        return _PrefillPlan(
            None, 0, None,
            prefill_bucket(len(tokens), self.cache_len, self.min_bucket),
            self.kv.blocks_for(len(tokens)))

    def _admit(self, seq: Sequence, plan: _PrefillPlan) -> PrefillItem:
        if (plan.src_slot is not None and plan.match is None
                and plan.src_slot in self._free_slots):
            # The backer is a retired slot: land the new sequence ON it,
            # making the device copy a no-op (frontend skips src == dst).
            self._free_slots.remove(plan.src_slot)
            slot = plan.src_slot
        else:
            slot = self._free_slots.pop()
        self._slot_tokens.pop(slot, None)
        self.kv.admit(seq.seq_id, tokens=seq.prefix, match=plan.match)
        seq.state = SequenceState.RUNNING
        seq.prefilled = False
        self.running[slot] = seq
        if self.flight is not None:
            self.flight.record("admit", seq=seq.seq_id, slot=slot,
                               bucket=plan.bucket,
                               cached_len=plan.cached_len,
                               preemptions=seq.preemptions)
        return PrefillItem(seq, slot, plan.cached_len, plan.src_slot)

    def _reserve_all(self) -> dict[int, Sequence]:
        """Reserve the block slot every decode step is about to write
        into (each step caches its INPUT token's K/V — one entry per
        step, last step included), preempting youngest-first whenever
        the pool runs dry.  Oldest sequences reserve first so preemption
        converges: the oldest sequence alone always fits, because add()
        checked the whole pool (a preempted sharer's blocks free only
        when their LAST holder goes, but every preemption removes a
        holder, so the loop still terminates).  Returns the surviving
        running map."""
        by_age = sorted(self.running.items(), key=lambda kv_: kv_[1].arrival)
        for slot, seq in by_age:
            if self.running.get(slot) is not seq:
                continue  # preempted by an earlier reservation this round
            while True:
                try:
                    self.kv.reserve_next(seq.seq_id)
                    break
                except OutOfBlocksError:
                    victim_slot, victim = max(
                        self.running.items(),
                        key=lambda kv_: (kv_[1].arrival, kv_[1].seq_id))
                    self.preempt(victim_slot)
                    if victim is seq:
                        break
        return dict(self.running)

    # -- step results ------------------------------------------------------
    def record_prefill(self, slot: int, token: int) -> Sequence | None:
        """First sampled token for a just-prefilled slot.  Returns the
        sequence if it is already finished (max_new=1 or instant EOS)."""
        seq = self.running[slot]
        seq.prefilled = True
        seq.generated.append(token)
        return self._maybe_retire(slot, token)

    def record_decode(self, slot: int, token: int) -> Sequence | None:
        """One decoded token: charge the cache entry the step wrote (the
        K/V of its INPUT token, covered by this round's reservation),
        append, retire in place when done.  Returns the sequence iff
        finished."""
        fin, _ = self.record_decode_tokens(slot, [token])
        return fin

    def record_decode_tokens(self, slot: int,
                             tokens: list[int]) -> tuple[Sequence | None,
                                                         int]:
        """A variable-length decode result for one slot (ISSUE 14: a
        propose-verify round emits 1..k+1 tokens).  Tokens are applied
        IN ORDER, each charging its input token's cache entry; the
        first rides the round's up-front reservation, later ones
        reserve as they commit.  The run stops early — and the rest of
        the candidates are DROPPED — when:

        * a token hits a stop condition (EOS / ``max_new_tokens``): the
          sequence retires and the slot vacates exactly as a one-token
          round would;
        * the block pool runs dry mid-run: acceptance is truncated, not
          preempted — greedy decode re-derives the dropped tokens
          bit-identically next round, so a tight pool degrades
          throughput, never output.

        Returns ``(finished sequence or None, number of tokens actually
        recorded)`` — the caller repairs the engine caches to the
        recorded length (``SpecDecoder.commit_round``)."""
        if not tokens:
            raise ValueError("record_decode_tokens with no tokens")
        seq = self.running[slot]
        fin = None
        recorded = 0
        for i, token in enumerate(tokens):
            if i > 0 and not self.kv.try_reserve_next(seq.seq_id):
                break
            self.kv.commit_token(seq.seq_id, token=seq.last_token)
            seq.generated.append(token)
            recorded += 1
            fin = self._maybe_retire(slot, token)
            if fin is not None:
                break
        return fin, recorded

    def _maybe_retire(self, slot: int, token: int) -> Sequence | None:
        seq = self.running[slot]
        if (self.eos_id is not None and token == self.eos_id) \
                or len(seq.generated) >= seq.max_new_tokens:
            self._vacate(slot)
            seq.state = SequenceState.FINISHED
            return seq
        return None

    def preempt(self, slot: int) -> Sequence:
        """Evict a running sequence: its block references dropped
        (counted as eviction; blocks shared with other sequences
        survive), slot returned, sequence re-queued FIRST so it is
        recomputed as soon as capacity returns (no starvation of
        preempted work)."""
        seq = self.running[slot]
        self._vacate(slot, evicted=True)
        seq.state = SequenceState.WAITING
        seq.preemptions += 1
        self.waiting.appendleft(seq)
        if self.flight is not None:
            self.flight.record("preempt", seq=seq.seq_id, slot=slot,
                               generated=len(seq.generated))
        return seq

    def _vacate(self, slot: int, *, evicted: bool = False) -> None:
        seq = self.running.pop(slot)
        self.kv.release(seq.seq_id, evicted=evicted)
        self._free_slots.append(slot)
        if seq.prefilled and self.kv.prefix_cache_enabled:
            # The slot's rows hold prompt + generated[:-1] (each decode
            # step writes its INPUT token's K/V; the last sampled token
            # was never written) — usable residue until reassignment.
            self._slot_tokens[slot] = seq.prefix[:-1]
        else:
            self._slot_tokens.pop(slot, None)
        seq.prefilled = False

    # -- observability -----------------------------------------------------
    @property
    def num_waiting(self) -> int:
        return len(self.waiting)

    @property
    def num_running(self) -> int:
        return len(self.running)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)
