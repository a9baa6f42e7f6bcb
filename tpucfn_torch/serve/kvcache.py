"""Paged KV-cache accounting: fixed-size blocks, free-list allocator,
per-sequence block tables, ref-counted sharing, block-level prefix
caching, eviction bookkeeping.

The serving memory problem (vLLM's observation, PAPERS.md serving rows):
a contiguous per-request KV allocation sized for ``prompt + max_new``
wastes most of HBM on requests that finish early or never reach their
limit.  Paging fixes the ACCOUNTING even before it changes the kernel:
sequences own lists of fixed-size blocks, blocks come from one shared
free list, a sequence is charged only for tokens it has actually cached
(plus at most one partially-filled block of internal fragmentation), and
admission control can answer "does this prompt fit right now?" exactly.

Prefix caching (ISSUE 3 tentpole) rides on two additions:

* **Ref counts.**  Every allocated block carries a reference count; a
  block shared by N sequences is charged once and returns to the free
  list only when the LAST holder releases it — evicting one holder of a
  shared block never frees it (the "eviction refused until refcount
  drops to 1" rule).
* **A content-hash index.**  Each FULL block of a tracked sequence gets
  a chain hash — ``hash(prev_block_hash, block_tokens)`` — so a block's
  identity encodes its entire prefix.  ``match_prefix`` walks a new
  prompt's full blocks through the index and returns the longest cached
  run plus the *holders*: live sequences whose device cache contains
  exactly those tokens at positions ``[0, cached_len)``.  The scheduler
  picks a prefilled holder's slot as the device-side copy source
  (``ServeEngine.copy_prefix``); ``admit(match=...)`` then increfs the
  shared blocks and allocates only the suffix.

Copy-on-write: sharing is append-only by construction (matched blocks
are full, writes happen at the tail), so the one divergent-write case is
a prompt whose full-block match covers the whole prompt — at least one
token must still be prefilled to produce logits, and that write lands in
the last matched block.  ``match_prefix`` drops that block from the
match (the sequence gets a private copy of its token range instead) and
``admit`` counts it in ``cow_copies``.

This module is pure host-side bookkeeping (no jax): it governs what the
scheduler admits and when it preempts.  The device-side cache today is
the engine's slot-contiguous layout (``serve/engine.py``); the block
tables produced here are exactly the indirection a future paged-
attention kernel consumes, so the allocator/scheduler layer survives
that swap untouched (ROADMAP serving follow-ons).
"""

from __future__ import annotations

import dataclasses


class OutOfBlocksError(RuntimeError):
    """The free list cannot satisfy an allocation.  Callers (the
    scheduler) react by preempting or queueing — never by partially
    allocating: ``BlockAllocator.alloc`` is atomic."""


class BlockAllocator:
    """Fixed pool of ``num_blocks`` ref-counted KV blocks handed out LIFO.

    LIFO keeps the working set of physical blocks small and recently
    used (friendlier to any cache level below us); allocation is atomic
    (all-or-nothing) and every free is validated so leaks and double
    frees fail loudly in tests instead of silently shrinking capacity.

    ``alloc`` hands out blocks at refcount 1; ``incref`` adds a sharer;
    ``free`` DECREMENTS and only returns a block to the free list when
    its count reaches zero — the mechanism behind prefix sharing: a
    block N sequences hold survives any N-1 of their releases.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free = list(range(num_blocks - 1, -1, -1))  # pop() -> block 0 first
        self._refs: dict[int, int] = {}
        self.high_water = 0  # max simultaneously-used blocks ever

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return len(self._refs)

    def ref(self, block: int) -> int:
        """Current reference count (0 for free/unknown blocks)."""
        return self._refs.get(block, 0)

    def alloc(self, n: int) -> list[int]:
        """n blocks (each at refcount 1) or OutOfBlocksError — never a
        partial allocation."""
        if n < 0:
            raise ValueError(f"cannot alloc {n} blocks")
        if n > len(self._free):
            raise OutOfBlocksError(
                f"need {n} blocks, {len(self._free)} free "
                f"(pool {self.num_blocks})")
        got = [self._free.pop() for _ in range(n)]
        for b in got:
            self._refs[b] = 1
        self.high_water = max(self.high_water, len(self._refs))
        return got

    def incref(self, block: int) -> None:
        """Add a sharer to an allocated block."""
        if block not in self._refs:
            raise ValueError(
                f"incref on block {block} that is not allocated")
        self._refs[block] += 1

    def free(self, blocks: list[int]) -> list[int]:
        """Drop one reference per listed block; returns the blocks whose
        count reached zero and were actually returned to the free list
        (a SHARED block is refused — it stays allocated for its
        remaining holders)."""
        freed = []
        for b in blocks:
            if b not in self._refs:
                raise ValueError(
                    f"freeing block {b} that is not allocated "
                    "(double free or foreign id)")
            self._refs[b] -= 1
            if self._refs[b] == 0:
                del self._refs[b]
                self._free.append(b)
                freed.append(b)
        return freed


@dataclasses.dataclass
class BlockTable:
    """One sequence's view of the cache: ordered physical block ids plus
    the number of tokens actually cached.  ``num_tokens`` may lag the
    capacity ``len(blocks) * block_size`` by up to ``block_size - 1``
    (internal fragmentation) and by exactly 1 between ``reserve_next``
    and ``commit_token``.  A leading run of blocks may be SHARED with
    other sequences (refcount > 1) via the prefix cache."""

    blocks: list[int]
    num_tokens: int

    def capacity(self, block_size: int) -> int:
        return len(self.blocks) * block_size


@dataclasses.dataclass
class PrefixMatch:
    """Longest cached full-block run for a prompt.

    ``cached_len`` tokens (a multiple of ``block_size``) can be served
    by sharing ``blocks``; ``holders`` are the sequence ids whose DEVICE
    cache contains those tokens at positions ``[0, cached_len)`` (any
    prefilled, still-running holder is a valid ``copy_prefix`` source).
    ``cow`` marks the copy-on-write case: the match covered the whole
    prompt, so its last block was dropped (the suffix prefill must write
    that token range, and a shared block is never written)."""

    cached_len: int
    blocks: list[int]
    hashes: list[int]
    holders: set
    cow: bool = False

    @property
    def num_blocks(self) -> int:
        return len(self.blocks)


@dataclasses.dataclass
class AdmitResult:
    """The admit split (ISSUE 3): ``cached_len`` tokens already backed
    by shared blocks, ``suffix`` tokens that still need prefill (None
    when the sequence was admitted by length only, with no tokens to
    split)."""

    table: BlockTable
    cached_len: int
    suffix: list[int] | None


def _block_hash(prev: int | None, tokens) -> int:
    """Chain hash of one full block: identity covers the whole prefix."""
    return hash((prev, tuple(tokens)))


class KVCacheManager:
    """Admission + growth + release accounting over one BlockAllocator,
    plus the block-level prefix cache when ``prefix_cache=True``.

    Protocol (driven by the scheduler):

    * ``match_prefix(tokens)`` — longest cached full-block run and its
      live holders; the scheduler validates a holder is prefilled and
      running before committing to the hit.
    * ``admit(seq_id, prompt_len)`` or ``admit(seq_id, tokens=...,
      match=...)`` — allocate the prompt's blocks atomically, sharing
      the matched run by incref when a match is supplied.
    * ``reserve_next(seq_id)`` — before a decode step, guarantee room
      for the token that step will write; grows the table by one block
      at block boundaries (raises :class:`OutOfBlocksError` when the
      pool is dry — the scheduler's preemption trigger).
    * ``commit_token(seq_id, token=...)`` — after the step, charge the
      token; with the token value supplied, full generated blocks are
      registered in the prefix index too (preemption resumes and
      agent-style shared histories hit the cache).
    * ``release(seq_id, evicted=False)`` — drop one reference on every
      block (shared blocks survive); ``evicted`` marks a preemption so
      evictions are first-class numbers, not log archaeology.
    """

    def __init__(self, num_blocks: int, block_size: int, *,
                 prefix_cache: bool = False):
        self.allocator = BlockAllocator(num_blocks, block_size)
        self.block_size = block_size
        self.prefix_cache_enabled = prefix_cache
        self._tables: dict[object, BlockTable] = {}
        # hash -> physical block currently carrying that content; a hash
        # entry lives as long as SOME live sequence holds the content
        # (device validity: retired slots are overwritten at will).
        self._index: dict[int, int] = {}
        # hash -> that block's OWN token tuple.  _block_hash is python's
        # builtin (fast, non-cryptographic), so every lookup re-verifies
        # content: a collision must degrade to a miss, never share a
        # stranger's KV.  (The chain property makes per-block comparison
        # sufficient — the prefix below was verified one step earlier.)
        self._content: dict[int, tuple] = {}
        # hash -> seq_ids whose device cache contains this chain.
        self._holders: dict[int, set] = {}
        # seq_id -> chain hashes of its full blocks (prompt + generated).
        self._chains: dict[object, list[int]] = {}
        # seq_id -> (last full-block chain hash, tokens since boundary).
        self._pending: dict[object, tuple[int | None, list[int]]] = {}
        self.evictions = 0
        self.blocks_evicted = 0
        self.prefix_hits = 0        # admits that reused >= 1 block
        self.prefix_hit_tokens = 0  # tokens served from shared blocks
        self.cow_copies = 0         # aligned full matches privately re-blocked

    # -- sizing ------------------------------------------------------------
    def blocks_for(self, tokens: int) -> int:
        return -(-tokens // self.block_size)  # ceil div

    @property
    def total_tokens_capacity(self) -> int:
        return self.allocator.num_blocks * self.block_size

    def fits_at_all(self, tokens: int) -> bool:
        """Whole-pool feasibility (admission-time sanity: a request whose
        worst case can never fit must be rejected up front, not starved)."""
        return self.blocks_for(tokens) <= self.allocator.num_blocks

    def can_admit(self, prompt_len: int) -> bool:
        return self.blocks_for(prompt_len) <= self.allocator.num_free

    # -- prefix cache ------------------------------------------------------
    def match_prefix(self, tokens) -> PrefixMatch:
        """Longest indexed full-block run covering a prefix of
        ``tokens``.  Capped below the full prompt: at least one token
        must remain for the suffix prefill (a full-cover match drops its
        last block — the COW case)."""
        if not self.prefix_cache_enabled:
            return PrefixMatch(0, [], [], set())
        bs = self.block_size
        blocks, hashes = [], []
        h = None
        for j in range(len(tokens) // bs):
            blk = tuple(tokens[j * bs:(j + 1) * bs])
            h = _block_hash(h, blk)
            if h not in self._index or self._content[h] != blk:
                break
            blocks.append(self._index[h])
            hashes.append(h)
        m, cow = len(blocks), False
        if m and m * bs >= len(tokens):
            m -= 1
            cow = True
        if m == 0:
            return PrefixMatch(0, [], [], set(), cow)
        holders = set(self._holders.get(hashes[m - 1], ()))
        return PrefixMatch(m * bs, blocks[:m], hashes[:m], holders, cow)

    # -- lifecycle ---------------------------------------------------------
    def admit(self, seq_id, prompt_len: int | None = None, *,
              tokens=None, match: PrefixMatch | None = None) -> AdmitResult:
        """Allocate a sequence's prompt blocks atomically.  With
        ``tokens`` the full blocks are registered in the prefix index;
        with ``match`` (from :meth:`match_prefix`, validated by the
        caller against a live backer) the matched run is SHARED by
        incref and only ``blocks_for(prompt) - match.num_blocks`` fresh
        blocks are drawn."""
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id!r} already admitted")
        if tokens is not None:
            prompt_len = len(tokens)
        if prompt_len is None or prompt_len < 1:
            raise ValueError(f"prompt_len must be >= 1, got {prompt_len}")
        shared: list[int] = []
        cached_len = 0
        if match is not None and match.cached_len:
            if tokens is None:
                raise ValueError("admit with match= requires tokens=")
            needed = self.blocks_for(prompt_len) - match.num_blocks
            # Atomicity: check before touching refcounts so a failed
            # admit leaves nothing to unwind.
            if needed > self.allocator.num_free:
                raise OutOfBlocksError(
                    f"need {needed} blocks past the {match.num_blocks} "
                    f"shared, {self.allocator.num_free} free")
            for b in match.blocks:
                self.allocator.incref(b)
            shared = list(match.blocks)
            cached_len = match.cached_len
            fresh = self.allocator.alloc(needed)
            self.prefix_hits += 1
            self.prefix_hit_tokens += cached_len
            if match.cow:
                # The dropped aligned block: this sequence writes its
                # token range, so it got a PRIVATE copy instead of a ref.
                self.cow_copies += 1
        else:
            fresh = self.allocator.alloc(self.blocks_for(prompt_len))
        table = BlockTable(shared + fresh, prompt_len)
        self._tables[seq_id] = table
        suffix = None
        if tokens is not None:
            suffix = list(tokens[cached_len:])
            if self.prefix_cache_enabled:
                self._register_prompt(seq_id, tokens, table)
        return AdmitResult(table, cached_len, suffix)

    def _register_prompt(self, seq_id, tokens, table: BlockTable) -> None:
        """Index every full prompt block and record this sequence as a
        holder of each chain hash (its device slot will contain those
        tokens once prefilled — the scheduler gates on that)."""
        bs = self.block_size
        h = None
        chain: list[int] = []
        for j in range(len(tokens) // bs):
            blk = tuple(tokens[j * bs:(j + 1) * bs])
            h = _block_hash(h, blk)
            chain.append(h)
            if h not in self._index:
                self._index[h] = table.blocks[j]
                self._content[h] = blk
                self._holders.setdefault(h, set()).add(seq_id)
            elif self._content[h] == blk:
                self._holders[h].add(seq_id)
            # else: hash collision — a stranger's content owns this
            # entry; this block stays unindexed (match degrades to miss).
        self._chains[seq_id] = chain
        self._pending[seq_id] = (h, list(tokens[len(chain) * bs:]))

    def reserve_next(self, seq_id) -> None:
        t = self._tables[seq_id]
        if t.num_tokens + 1 > t.capacity(self.block_size):
            t.blocks.extend(self.allocator.alloc(1))

    def try_reserve_next(self, seq_id) -> bool:
        """Non-raising :meth:`reserve_next` for the multi-token commit
        path (ISSUE 14): speculative decode may land several tokens per
        slot per round, and tokens past the round's up-front reservation
        are best-effort — a dry pool TRUNCATES the acceptance (greedy
        decode re-derives the same tokens next round) instead of
        preempting mid-commit.  Returns True when the next token's slot
        is covered.

        Draft-side accounting note: the draft engine runs at the SAME
        slot layout (``SpecDecoder`` refuses anything else) and every
        round writes strictly no more positions than the target's
        verify pass, then rolls back to the same accepted length — so
        this manager's per-sequence token accounting bounds BOTH the
        target's and the draft's cache occupancy, and admission can
        never over-commit either cache."""
        try:
            self.reserve_next(seq_id)
            return True
        except OutOfBlocksError:
            return False

    def commit_token(self, seq_id, token: int | None = None) -> None:
        t = self._tables[seq_id]
        if t.num_tokens + 1 > t.capacity(self.block_size):
            raise RuntimeError(
                f"commit_token for {seq_id!r} without reserve_next "
                f"({t.num_tokens} tokens in {len(t.blocks)} blocks)")
        t.num_tokens += 1
        if seq_id not in self._pending:
            return
        if token is None:
            # A tracked sequence committed an unknown token: its chain
            # can no longer be extended truthfully — stop tracking the
            # tail (existing full-block entries stay valid).
            del self._pending[seq_id]
            return
        h, pending = self._pending[seq_id]
        pending.append(token)
        if len(pending) == self.block_size:
            blk = tuple(pending)
            h2 = _block_hash(h, blk)
            j = t.num_tokens // self.block_size - 1
            if h2 not in self._index:
                self._index[h2] = t.blocks[j]
                self._content[h2] = blk
                self._holders.setdefault(h2, set()).add(seq_id)
            elif self._content[h2] == blk:
                self._holders[h2].add(seq_id)
            self._chains[seq_id].append(h2)
            self._pending[seq_id] = (h2, [])

    def release(self, seq_id, *, evicted: bool = False) -> None:
        t = self._tables.pop(seq_id)
        chain = self._chains.pop(seq_id, [])
        self._pending.pop(seq_id, None)
        freed = set(self.allocator.free(t.blocks))
        for j, h in enumerate(chain):
            hs = self._holders.get(h)
            if hs is None:
                continue
            hs.discard(seq_id)
            if not hs:
                del self._holders[h]
                self._index.pop(h, None)
                self._content.pop(h, None)
            elif self._index.get(h) in freed:
                # The indexed physical block died with this release but
                # other live sequences still carry the content: re-point
                # the entry at a survivor's block (same chain depth ->
                # same table position).
                survivor = next(iter(hs))
                self._index[h] = self._tables[survivor].blocks[j]
        if evicted:
            self.evictions += 1
            self.blocks_evicted += len(freed)

    def table(self, seq_id) -> BlockTable:
        return self._tables[seq_id]

    # -- observability -----------------------------------------------------
    @property
    def num_sequences(self) -> int:
        return len(self._tables)

    def occupancy(self) -> float:
        """Fraction of the pool in use — the cache-occupancy gauge."""
        return self.allocator.num_used / self.allocator.num_blocks

    def internal_fragmentation(self) -> int:
        """Allocated-but-unfilled token slots across live sequences
        (bounded by ``num_sequences * (block_size - 1)`` + reservations)."""
        return sum(t.capacity(self.block_size) - t.num_tokens
                   for t in self._tables.values())

    def prefix_cache_stats(self) -> dict:
        return {
            "enabled": self.prefix_cache_enabled,
            "hits": self.prefix_hits,
            "hit_tokens": self.prefix_hit_tokens,
            "cow_copies": self.cow_copies,
            "indexed_blocks": len(self._index),
        }
