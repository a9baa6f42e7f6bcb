"""Speculative decoding — draft-model propose/verify over paired
ServeEngines (ISSUE 14 tentpole).

Per-token decode steps dominate serve cost on TPU (PAPERS.md, the
Gemma-on-TPU serving economics): every decode round is one full
target-model dispatch that emits ONE token per slot.  Speculative
decoding amortizes that dispatch: a second, much smaller ``ServeEngine``
(the draft) at the SAME slot layout autoregressively proposes ``k``
tokens per running slot, then the target scores all ``k + 1`` positions
in ONE batched verify dispatch (``ServeEngine.verify``).  Standard
greedy verification accepts the longest proposed prefix the target
agrees with, plus the target's own corrected token — so the emitted
sequence is **bit-identical to plain greedy decode**: every emitted
token is the argmax of the target's logits over exactly the cache a
plain decode would have had (pinned on CPU in
``tests/test_serve_spec.py``).

The propose/verify round (:meth:`SpecDecoder.run_round`):

1. **Resync.**  Any active slot whose draft cache has fallen out of
   mirror (spec was off for a while, or a prefix-hit copy came from a
   stale draft slot) is re-synced through the draft's OWN bucketed
   prefill machinery (``prefill_batch`` with a start offset) — draft
   state is a pure accelerant, never a correctness input, so a slot
   that cannot be resynced just proposes garbage that verification
   rejects.
2. **Propose.**  ``k`` draft decode dispatches produce ``k`` greedy
   proposals per slot (the draft's own cache advances as it goes).
3. **Verify.**  One target dispatch scores ``k + 1`` positions per
   slot.  Position 0 is sampled exactly as plain decode samples (same
   ``_sample``, same temps); positions 1+ are greedy argmax.  Slots
   with ``temperature > 0`` accept no proposals (budget 1): greedy
   verification would change their sampling distribution, so they ride
   the round as plain one-token decodes.
4. **Accept.**  Per slot: the longest prefix of proposals matching the
   target's verdicts, plus one corrected token, capped by the slot's
   budget (``remaining`` tokens) — between 1 and ``k + 1`` tokens.
5. **Commit.**  After the scheduler records what actually landed (EOS
   or a dry block pool can truncate), both engines' caches roll back to
   the accepted position (``ServeEngine.rollback``) — K/V written past
   it is dead by the standard write-before-read argument.

The verify width is shape-bucketed (``1 + pow2`` proposals, capped by
the round's minimum per-slot headroom) so the compile family stays
bounded the same way prefill buckets are.

**The controller** (:class:`SpecKController`, window-reset like PR 11's
``PrefetchController``) keeps the worst case bounded: the measured
acceptance rate over a rolling window shrinks ``k`` toward 1 when the
draft stops earning its dispatches, and — below that — turns
speculation OFF entirely (plain decode rounds, zero draft cost),
probing every ``probe_every``-th round so a workload shift can turn it
back on.  A zero-acceptance adversarial workload therefore costs plain
decode plus one amortized probe, not plain-plus-k-drafts forever
(``benches/serve_bench.py --spec`` rc-gates the bound).

Draft-side cache accounting: the draft runs at the same slot layout
(same ``max_batch``, same ``cache_len``), mirrors every prefill /
copy_prefix / rollback, and writes strictly fewer positions per round
than the target's verify does — so the scheduler's single
``KVCacheManager`` accounting bounds BOTH caches and admission can
never over-commit either (see ``serve/kvcache.py``).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

from tpucfn_torch.serve.scheduler import prefill_bucket


@dataclasses.dataclass
class SpecRoundStats:
    """One round's observability payload: the serve loop turns this
    into ``spec_propose``/``spec_verify`` spans and the
    ``serve_spec_*`` counters."""

    mode: str                 # "spec" | "off"
    width: int                # verify width (k_round + 1); 1 when off
    proposed: int = 0         # draft tokens proposed (greedy slots only)
    accepted: int = 0         # proposed tokens the target agreed with
    resyncs: int = 0          # draft slots re-prefilled this round
    t_propose0: float = 0.0
    t_propose1: float = 0.0
    t_verify0: float = 0.0
    t_verify1: float = 0.0


class SpecKController:
    """Acceptance-driven proposal depth: shrink ``k`` when the measured
    acceptance rate over a rolling window drops below threshold, grow it
    back when the draft is earning its dispatches, and turn speculation
    off entirely (with periodic probes) when even ``min_k`` is waste.

    Pure and clock-free (the window is rounds, not seconds) so it tests
    with zero sleeps — the ``PrefetchController`` discipline.  Window
    RESET on every decision: each k is judged on fresh evidence, not on
    the regime that preceded it.
    """

    def __init__(self, *, k: int = 4, min_k: int = 1, max_k: int | None = None,
                 shrink_below: float = 0.35, grow_above: float = 0.75,
                 window: int = 8, allow_off: bool = True,
                 probe_every: int = 64, adaptive: bool = True):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        max_k = k if max_k is None else max_k
        if not 1 <= min_k <= max_k:
            raise ValueError(
                f"need 1 <= min_k <= max_k, got {min_k}..{max_k}")
        if not 0.0 <= shrink_below <= grow_above <= 1.0:
            raise ValueError("need 0 <= shrink_below <= grow_above <= 1")
        if probe_every < 2:
            raise ValueError(f"probe_every must be >= 2, got {probe_every}")
        self.k = max(min_k, min(k, max_k))
        self.min_k = min_k
        self.max_k = max_k
        self.shrink_below = shrink_below
        self.grow_above = grow_above
        self.window = max(1, int(window))
        self.allow_off = allow_off
        self.probe_every = probe_every
        self.adaptive = adaptive
        self._hist: deque[tuple[int, int]] = deque(maxlen=self.window)
        self._off_rounds = 0
        self._probing = False

    @property
    def off(self) -> bool:
        return self.k == 0

    def round_k(self) -> int:
        """Proposal depth for the NEXT round.  0 = plain decode (spec
        off); while off, every ``probe_every``-th round runs a
        ``min_k`` probe whose observation is the re-enable signal."""
        if self.k > 0:
            return self.k
        self._off_rounds += 1
        if self._off_rounds % self.probe_every == 0:
            self._probing = True
            return self.min_k
        self._probing = False
        return 0

    def acceptance_rate(self) -> float:
        """Windowed acceptance rate (accepted / proposed over the
        rolling window); 0.0 before any proposing round."""
        prop = sum(p for p, _ in self._hist)
        return (sum(a for _, a in self._hist) / prop) if prop else 0.0

    def observe(self, proposed: int, accepted: int) -> int:
        """Feed one PROPOSING round's counts; returns the (possibly
        updated) k.  Rounds that proposed nothing carry no signal."""
        if proposed <= 0:
            return self.k
        self._hist.append((proposed, accepted))
        if not self.adaptive:
            return self.k
        rate = self.acceptance_rate()
        if self.k == 0:
            # A probe: one good round re-enables at min_k (optimistic —
            # the normal window then takes over); a bad one stays off.
            if self._probing and rate >= self.grow_above:
                self.k = self.min_k
                self._off_rounds = 0
                self._hist.clear()
            else:
                self._hist.clear()
            self._probing = False
            return self.k
        if len(self._hist) >= self.window:
            if rate < self.shrink_below:
                nk = self.k // 2
                self.k = (0 if nk < self.min_k and self.allow_off
                          else max(self.min_k, nk))
                self._hist.clear()
            elif rate > self.grow_above and self.k < self.max_k:
                self.k = min(self.max_k, self.k * 2)
                self._hist.clear()
        return self.k


def _down_pow2(n: int) -> int:
    """Largest power of two <= n (n >= 1) — the verify-width bucket
    family: one compile per width, like prefill buckets."""
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


class SpecDecoder:
    """Engine-protocol wrapper pairing a target ``ServeEngine`` with a
    smaller draft at the same slot layout.

    Presents the exact duck-typed surface ``serve/frontend.Server``
    drives (``prefill_batch`` / ``prefill`` / ``copy_prefix`` /
    ``decode`` / ``max_batch`` / ``cache_len`` / ``prefill_width``),
    mirroring every cache-shaping call onto the draft, plus the
    propose-verify round (:meth:`run_round` / :meth:`commit_round`) the
    spec-aware decode branch uses.  ``spec_enabled`` is the branch
    flag; a Server holding a bare engine never takes the spec path,
    which is what keeps the no-draft configuration byte-identical.
    """

    spec_enabled = True

    def __init__(self, target, draft, *, k: int = 4,
                 controller: SpecKController | None = None,
                 adaptive: bool = True):
        if draft.max_batch != target.max_batch \
                or draft.cache_len != target.cache_len:
            raise ValueError(
                f"draft slot layout ({draft.max_batch} slots x "
                f"{draft.cache_len}) must match the target's "
                f"({target.max_batch} x {target.cache_len}) — slots and "
                "positions are shared identities in the propose-verify "
                "round")
        if getattr(draft, "prefill_width", 1) \
                < getattr(target, "prefill_width", 1):
            raise ValueError(
                "draft prefill_width must cover the target's: mirrored "
                "prefill batches are sized by the target's width")
        self.target = target
        self.draft = draft
        self.controller = (controller if controller is not None
                           else SpecKController(k=k, adaptive=adaptive))
        # Per-slot count of leading draft-cache positions that are a
        # byte-valid mirror of the target's slot.  Pure bookkeeping on
        # the host: staleness costs acceptance, never correctness.
        self._draft_sync: dict[int, int] = {}
        self._pending: dict[int, int] | None = None  # round in flight

    # -- engine-protocol proxies -------------------------------------------
    @property
    def max_batch(self) -> int:
        return self.target.max_batch

    @property
    def cache_len(self) -> int:
        return self.target.cache_len

    @property
    def prefill_width(self) -> int:
        return self.target.prefill_width

    @property
    def params(self):
        return self.target.params

    def prefill_batch(self, items, bucket: int) -> dict[int, int]:
        out = self.target.prefill_batch(items, bucket)
        # Draft mirror at temperature 0: proposals are always greedy.
        self.draft.prefill_batch(
            [(slot, toks, start, 0.0) for slot, toks, start, _t in items],
            bucket)
        for slot, toks, start, _t in items:
            prev = self._draft_sync.get(slot, 0)
            self._draft_sync[slot] = (start + len(toks) if start <= prev
                                      else prev)
        return out

    def prefill(self, slot: int, prefix: list[int], bucket: int,
                temperature: float = 0.0, start: int = 0) -> int:
        return self.prefill_batch([(slot, prefix, start, temperature)],
                                  bucket)[slot]

    def copy_prefix(self, src_slot: int, dst_slot: int,
                    n_tokens: int) -> None:
        self.target.copy_prefix(src_slot, dst_slot, n_tokens)
        # Mirror unconditionally so the draft's cache_index stays in
        # lockstep; validity is whatever the source slot really held.
        self.draft.copy_prefix(src_slot, dst_slot, n_tokens)
        self._draft_sync[dst_slot] = min(
            n_tokens, self._draft_sync.get(src_slot, 0))

    def decode(self, tokens_by_slot: dict[int, int]) -> dict[int, int]:
        """Plain one-token round on the TARGET only (protocol
        completeness for direct engine users); the draft is not fed, so
        those slots resync lazily at the next proposing round."""
        return self.target.decode(tokens_by_slot)

    def compile_counts(self) -> dict:
        return {"target": self.target.compile_counts(),
                "draft": self.draft.compile_counts()}

    # -- the propose-verify round ------------------------------------------
    def _resync(self, slots, n_by_slot: dict[int, int]) -> int:
        """Re-mirror stale draft slots through the draft's bucketed
        prefill: tokens ``prefix[sync:-1]`` at start ``sync`` (or the
        whole history from 0 when the suffix bucket cannot fit).
        Returns how many slots were resynced."""
        need: list[tuple[int, list[int], int]] = []  # (slot, toks, start)
        for slot, seq in slots.items():
            n = n_by_slot[slot]
            if self._draft_sync.get(slot, -1) == n:
                continue
            start = self._draft_sync.get(slot, 0)
            if not 0 <= start < n:
                start = 0
            toks = list(seq.prefix[start:n])
            bucket = prefill_bucket(len(toks), self.cache_len)
            if start + bucket > self.cache_len:
                start, toks = 0, list(seq.prefix[:n])
                bucket = prefill_bucket(len(toks), self.cache_len)
            need.append((slot, toks, start))
        # Group into same-bucket draft prefill batches (the engine's
        # one-compile-per-bucket contract).
        by_bucket: dict[int, list[tuple[int, list[int], int]]] = {}
        for slot, toks, start in need:
            by_bucket.setdefault(
                prefill_bucket(len(toks), self.cache_len), []).append(
                (slot, toks, start))
        width = getattr(self.draft, "prefill_width", 1)
        for bucket, group in sorted(by_bucket.items()):
            for i in range(0, len(group), width):
                chunk = group[i:i + width]
                self.draft.prefill_batch(
                    [(slot, toks, start, 0.0)
                     for slot, toks, start in chunk], bucket)
                for slot, toks, start in chunk:
                    self._draft_sync[slot] = start + len(toks)
        return len(need)

    def run_round(self, slots) -> tuple[dict[int, list[int]],
                                        SpecRoundStats]:
        """One decode round over ``slots`` (slot -> Sequence-like with
        ``prefix`` / ``last_token`` / ``remaining`` / ``temperature``).
        Returns per-slot CANDIDATE emissions (1..k+1 tokens each, every
        one bit-identical to what plain greedy decode would emit) and
        the round's stats.  The caller records them through the
        scheduler — which may truncate on EOS/max_new or a dry block
        pool — then MUST :meth:`commit_round` with the final lengths."""
        if self._pending is not None:
            raise RuntimeError("run_round before commit_round of the "
                               "previous round")
        n_by_slot = {slot: len(seq.prefix) - 1
                     for slot, seq in slots.items()}
        budgets = {slot: (1 if seq.temperature > 0
                          else max(1, seq.remaining))
                   for slot, seq in slots.items()}
        k_round = self.controller.round_k()
        # Width safety: the verify writes W positions from each slot's
        # current length; headroom per slot is remaining + 1, so the
        # width is capped by the round's minimum remaining (then
        # bucketed to a power of two to bound the compile family).
        k_cap = min([k_round] + [seq.remaining for seq in slots.values()])
        if k_round == 0 or k_cap < 1 or max(budgets.values()) <= 1:
            # Spec off, no headroom, or nothing in the batch CAN accept
            # (all sampled / all on their last token): one plain target
            # dispatch — never pay a draft that cannot earn anything.
            t0 = time.monotonic()
            out = self.target.decode(
                {slot: seq.last_token for slot, seq in slots.items()})
            t1 = time.monotonic()
            self._pending = {}  # decode advanced exactly one: no repair
            return ({slot: [tok] for slot, tok in out.items()},
                    SpecRoundStats(mode="off", width=1, t_verify0=t0,
                                   t_verify1=t1))
        k_eff = _down_pow2(k_cap)
        width = k_eff + 1
        stats = SpecRoundStats(mode="spec", width=width)
        stats.t_propose0 = time.monotonic()
        stats.resyncs = self._resync(slots, n_by_slot)
        cur = {slot: seq.last_token for slot, seq in slots.items()}
        proposed: dict[int, list[int]] = {slot: [] for slot in slots}
        for _ in range(k_eff):
            cur = self.draft.decode(cur)
            for slot, tok in cur.items():
                proposed[slot].append(tok)
        stats.t_propose1 = stats.t_verify0 = time.monotonic()
        outs = self.target.verify(
            {slot: [slots[slot].last_token] + proposed[slot]
             for slot in slots}, width)
        stats.t_verify1 = time.monotonic()
        emitted: dict[int, list[int]] = {}
        extra_feed = False
        for slot, verdict in outs.items():
            m = 0
            while m < k_eff and proposed[slot][m] == verdict[m]:
                m += 1
            j = min(m + 1, budgets[slot])
            emitted[slot] = verdict[:j]
            if j == width:
                extra_feed = True
            if budgets[slot] > 1:
                stats.proposed += k_eff
                stats.accepted += j - 1
        if extra_feed:
            # A fully-accepted slot's last proposal was never fed to the
            # draft (it was the draft's OUTPUT); one more draft step
            # writes its K/V so the mirror stays exact.  Slots that
            # accepted less get the write rolled back with everything
            # else.
            self.draft.decode({slot: proposed[slot][-1] for slot in slots})
        self.controller.observe(stats.proposed, stats.accepted)
        # Draft cache positions written this round: k_eff (+1 on the
        # extra feed) from each slot's synced length.
        self._pending = n_by_slot
        return emitted, stats

    def abandon_round(self) -> None:
        """Drop a round that will never be committed (the replica died
        between run_round and commit_round — ``Server._fail_all`` calls
        this).  Cache repair is NOT needed: a failed replica never runs
        another step, and a relaunched incarnation re-prefills every
        slot before decoding it, which rewrites the row and its
        ``cache_index`` on both engines."""
        self._pending = None

    def commit_round(self, final_lengths: dict[int, int]) -> None:
        """Repair both caches to the per-slot lengths the scheduler
        actually recorded (``len(prefix) - 1`` after appending — for
        retired slots too, so their residue stays a valid prefix-cache
        backer).  A round that ran in off mode advanced exactly one
        position per slot and needs no repair."""
        if self._pending is None:
            raise RuntimeError("commit_round without a pending round")
        pending, self._pending = self._pending, None
        if not pending:
            return  # off-mode round: plain decode left the cache exact
        self.target.rollback(final_lengths)
        self.draft.rollback(final_lengths)
        self._draft_sync.update(final_lengths)
