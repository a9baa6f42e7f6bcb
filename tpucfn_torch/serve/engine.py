"""ServeEngine — prefill/decode steps over a slot-resident KV cache (the
port of ``tpucfn/serve/engine.py``).

The engine owns ``max_batch`` physical decode slots.  The cache is one
:class:`~tpucfn_torch.models.llama.DecodeCache` whose batch axis is the
slot axis: per layer (max_batch, cache_len, Hkv, D) keys and values, and
one (max_batch,) int32 ``index`` — every slot sits at its own sequence
position, and attention takes the index as a per-row query offset.
Attention in every call runs the flash forward kernel
(:func:`tpucfn_torch.kernels.auto.serve_decode_attention_fn`).

Three entry points, as in the JAX engine:

* ``prefill_batch``: up to ``prefill_width`` sequences, each padded to
  the SAME length bucket, run through the decode-mode model as one
  batch.  Each lane carries its own cache START offset: a lane with
  ``start > 0`` continues from a prefix that ``copy_prefix`` already
  planted in its slot, so a prefix-cache hit prefills only the suffix.
  The lanes' rows are gathered from the slot cache, run, and each lane's
  ``index`` is set to its TRUE total length, so bucket pad garbage
  beyond it is overwritten by the next decode step before causality
  could ever expose it; the rows are scattered back and each first
  token is sampled from the last REAL position.  Partial batches pad by
  repeating lane 0, so the lane count is fixed.
* ``decode``: one token for EVERY slot, in place on the slot cache.
  Vacant slots compute garbage lanes that are never read.
* ``copy_prefix``: whole-row KV copy from a backer slot plus an
  ``index`` set to the shared prefix length.  Bytes past the prefix are
  stale backer state, dead by the same write-before-read argument.

Two more entry points serve speculative decoding
(:mod:`tpucfn_torch.serve.spec`):

* ``verify``: score ``width`` token positions for EVERY slot in one
  forward over ``(max_batch, width)`` tokens — each slot's last emitted
  token followed by ``width - 1`` draft proposals.  Position 0 is
  sampled exactly as ``decode`` samples (same ``_sample``, same temps,
  same generator); positions 1+ take the argmax.  The pass is a peek:
  K/V rows gain the ``width`` new entries, but the whole ``(max_batch,)``
  index, vacant slots' included, is put back after the pass (a free
  slot's residue backs prefix-cache hits, and an index that crept up by
  ``width`` a round would clamp later writes back INTO that residue).
  A lane with ``index + width > cache_len`` comes back NaN-poisoned,
  which is harmless only in lanes that are never read.
* ``rollback``: set the listed slots' index to given lengths (masked:
  every other slot keeps its own).  K/V past the new index is dead by
  the write-before-read argument the bucket-pad rewind rests on.

The cache is updated in place (JAX donates the buffer to the same
effect).  Sampling temperatures live in a device-resident
``(max_batch,)`` tensor written only by prefill, with a host mirror: a
step in which no slot samples is the argmax alone.  Greedy decode here is
token-identical to :func:`tpucfn_torch.models.generate.generate` wherever
the two attention paths round alike (fp32).  ``compile_counts`` counts
the distinct shapes each entry point has run: what the JAX engine
compiles once each, and what CUDA graphs of these steps would capture.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from tpucfn_torch.device import resolve_device
from tpucfn_torch.models.generate import categorical


def _sample(logits: torch.Tensor, temps: torch.Tensor,
            generator: torch.Generator | None,
            sampling: bool = True) -> torch.Tensor:
    """(N, V) fp32 logits -> (N,) int tokens.  temp<=0 is greedy;
    otherwise categorical over logits/temp.  ``sampling=False`` (no
    temp > 0, known on the host) takes the argmax alone and draws
    nothing from ``generator``."""
    greedy = logits.argmax(dim=-1)
    if not sampling:
        return greedy
    sampled = categorical(logits / temps.clamp_min(1e-6)[:, None], generator)
    return torch.where(temps > 0.0, sampled, greedy)


class ServeEngine:
    """Wraps a decode-mode model (``init_cache``, ``forward(tokens,
    cache=..., return_hidden=True)``, ``logits``) behind the serving
    steps.  Use :meth:`from_llama` for the model zoo's decoder."""

    def __init__(self, model: Any, *, max_batch: int, cache_len: int,
                 generator: torch.Generator | None = None,
                 prefill_width: int = 4, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.max_batch = max_batch
        self.cache_len = cache_len
        # Fixed lane count of the batched prefill: partial batches waste
        # (K - n)/K of the pass (lanes duplicate lane 0), the same trade
        # as vacant decode lanes.
        self.prefill_width = max(1, int(prefill_width))
        self.generator = (generator if generator is not None
                          else torch.Generator(self.device).manual_seed(0))
        self.cache = model.init_cache(max_batch, cache_len, self.device)
        self._temps = torch.zeros((max_batch,), dtype=torch.float32,
                                  device=self.device)
        self._host_temps = np.zeros((max_batch,), np.float32)  # its mirror
        # Distinct shapes run per entry point (``compile_counts``); the
        # speculative entries appear once they have run.
        self._shapes: dict[str, set] = {"prefill": set(), "decode": set(),
                                        "copy_prefix": set()}

    @classmethod
    def from_llama(cls, cfg, params, *, max_batch: int = 8,
                   cache_len: int | None = None,
                   generator: torch.Generator | None = None,
                   prefill_width: int = 4,
                   device: str | torch.device = "cuda"):
        """Engine over the flagship decoder and ``params`` (the port's
        state dict; tensors already on the device in their storage dtype
        are shared, not copied).  ``cache_len`` sizes every slot's KV
        buffer (default ``cfg.max_seq``)."""
        from tpucfn_torch.kernels.auto import serve_decode_attention_fn
        from tpucfn_torch.models.llama import Llama

        device = resolve_device(device)
        cache_len = cache_len or cfg.max_seq
        dcfg = dataclasses.replace(cfg, max_seq=cache_len)
        model = Llama.from_state_dict(
            dcfg, params, decode=True, device=device,
            attention_fn=serve_decode_attention_fn(cache_len))
        return cls(model, max_batch=max_batch, cache_len=cache_len,
                   generator=generator, prefill_width=prefill_width,
                   device=device)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        """``a`` on the device.  On the card the copy is staged in pinned
        memory and queued behind the stream's work: a copy from pageable
        memory waits for the stream, once per host array of every step."""
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _sampling(self) -> bool:
        """Whether any slot samples (temp > 0); else a step is argmax."""
        return bool((self._host_temps > 0).any())

    @property
    def params(self) -> dict[str, torch.Tensor]:
        """The weights (the model's state dict: the engine's own tensors,
        not copies), e.g. for a draft engine over the same weights."""
        return self.model.state_dict()

    # -- host API (the scheduler loop calls these) -------------------------
    def prefill(self, slot: int, prefix: list[int], bucket: int,
                temperature: float = 0.0, start: int = 0) -> int:
        """Run one bucketed prefill into ``slot``; returns the sequence's
        first sampled token.  ``start > 0`` continues from a prefix that
        :meth:`copy_prefix` already planted (``prefix`` is then the
        SUFFIX tokens only)."""
        return self.prefill_batch([(slot, prefix, start, temperature)],
                                  bucket)[slot]

    @torch.no_grad()
    def prefill_batch(self, items, bucket: int) -> dict[int, int]:
        """One prefill over up to ``prefill_width`` sequences sharing
        ``bucket``.  ``items`` is a list of ``(slot, tokens, start,
        temperature)`` — ``tokens`` are the tokens to run (the suffix
        when ``start > 0``).  Returns {slot: first token}."""
        k = self.prefill_width
        if not 1 <= len(items) <= k:
            raise ValueError(
                f"{len(items)} prefill items vs prefill_width {k}")
        slots = [it[0] for it in items]
        if len(set(slots)) != len(slots):
            raise ValueError(f"duplicate slots in prefill batch: {slots}")
        padded = list(items) + [items[0]] * (k - len(items))
        prompts = np.zeros((k, bucket), np.int64)
        true_lens = np.zeros((k,), np.int32)
        starts = np.zeros((k,), np.int32)
        slot_arr = np.zeros((k,), np.int64)
        temps = np.zeros((k,), np.float32)
        for i, (slot, toks, start, temp) in enumerate(padded):
            n = len(toks)
            if not 1 <= n <= bucket:
                raise ValueError(
                    f"suffix len {n} / bucket {bucket} violate "
                    "1 <= len <= bucket")
            if start < 0 or start + bucket > self.cache_len:
                raise ValueError(
                    f"start {start} + bucket {bucket} exceeds cache_len "
                    f"{self.cache_len}")
            if not 0 <= slot < self.max_batch:
                raise ValueError(f"slot {slot} out of range")
            prompts[i, :n] = np.asarray(toks, np.int64)
            true_lens[i] = start + n
            starts[i] = start
            slot_arr[i] = slot
            temps[i] = temp
        slots_t = self._tensor(slot_arr)
        true_t = self._tensor(true_lens)
        new_temps = self._tensor(temps)
        rows = self.cache.rows(slots_t)
        rows.index.copy_(self._tensor(starts))
        hidden = self.model(self._tensor(prompts), cache=rows,
                            return_hidden=True)
        rows.index.copy_(true_t)  # rewind past the bucket pad
        last = hidden[torch.arange(k, device=self.device),
                      self._tensor((true_lens - starts - 1).astype(np.int64))]
        toks_out = _sample(self.model.logits(last), new_temps, self.generator,
                           sampling=bool((temps > 0).any()))
        # Pad lanes repeat lane 0: their slots are duplicates, but their
        # rows are identical, so the scatter order does not matter.
        self.cache.put_rows(slots_t, rows)
        self._temps.index_copy_(0, slots_t, new_temps)
        self._host_temps[slot_arr] = temps
        self._shapes["prefill"].add(bucket)
        toks_out = toks_out.cpu().numpy()
        return {slot: int(toks_out[i]) for i, slot in enumerate(slots)}

    @torch.no_grad()
    def copy_prefix(self, src_slot: int, dst_slot: int,
                    n_tokens: int) -> None:
        """Device-side prefix reuse: make slot ``dst_slot`` start life
        with the first ``n_tokens`` of slot ``src_slot``'s cache (a
        prefix-cache hit's replacement for re-prefilling those tokens)."""
        if not 0 <= src_slot < self.max_batch \
                or not 0 <= dst_slot < self.max_batch:
            raise ValueError(
                f"slots {src_slot}->{dst_slot} out of range "
                f"[0, {self.max_batch})")
        if src_slot == dst_slot:
            raise ValueError(f"copy_prefix onto itself (slot {src_slot})")
        if not 1 <= n_tokens <= self.cache_len:
            raise ValueError(
                f"n_tokens {n_tokens} outside [1, {self.cache_len}]")
        for t in self.cache.keys + self.cache.values:
            t[dst_slot].copy_(t[src_slot])
        self.cache.index[dst_slot] = n_tokens
        self._shapes["copy_prefix"].add(())

    @torch.no_grad()
    def decode(self, tokens_by_slot: dict[int, int]) -> dict[int, int]:
        """One decode iteration.  ``tokens_by_slot`` maps ACTIVE slots to
        their last emitted token; vacant slots run dead lanes.  Returns
        the next token per active slot."""
        toks = np.zeros((self.max_batch, 1), np.int64)
        for slot, tok in tokens_by_slot.items():
            toks[slot, 0] = tok
        hidden = self.model(self._tensor(toks), cache=self.cache,
                            return_hidden=True)
        nxt = _sample(self.model.logits(hidden[:, -1]), self._temps,
                      self.generator, self._sampling()).cpu().numpy()
        self._shapes["decode"].add(1)
        return {slot: int(nxt[slot]) for slot in tokens_by_slot}

    @torch.no_grad()
    def verify(self, tokens_by_slot: dict[int, list[int]],
               width: int) -> dict[int, list[int]]:
        """One multi-token verify pass: each ACTIVE slot's row is its
        last emitted token plus ``width - 1`` proposed tokens.  Returns
        the target model's ``width`` next-token verdicts per active slot;
        vacant slots run dead lanes.  A peek: every slot's index comes
        back unchanged, and the caller then ADVANCES each active slot to
        its accepted length with :meth:`rollback` before the next engine
        call touches it."""
        if width < 1:
            raise ValueError(f"verify width must be >= 1, got {width}")
        toks = np.zeros((self.max_batch, width), np.int64)
        for slot, run in tokens_by_slot.items():
            if len(run) != width:
                raise ValueError(
                    f"slot {slot}: run of {len(run)} tokens vs width "
                    f"{width}")
            toks[slot] = np.asarray(run, np.int64)
        index = self.cache.index.clone()
        hidden = self.model(self._tensor(toks), cache=self.cache,
                            return_hidden=True)
        self.cache.index.copy_(index)
        logits = self.model.logits(hidden)
        first = _sample(logits[:, 0], self._temps, self.generator,
                        self._sampling())
        rest = logits[:, 1:].argmax(dim=-1)
        out = torch.cat([first[:, None], rest], dim=1).cpu().numpy()
        self._shapes.setdefault("verify", set()).add(width)
        return {slot: [int(t) for t in out[slot]]
                for slot in tokens_by_slot}

    @torch.no_grad()
    def rollback(self, lengths_by_slot: dict[int, int]) -> None:
        """Repair the index after a verify (or a draft's proposal run)
        over-advanced it: each listed slot's index is set to its accepted
        cache length; every other slot is untouched."""
        if not lengths_by_slot:
            return
        listed = np.zeros((2, self.max_batch), np.int32)  # (mask, length)
        for slot, n in lengths_by_slot.items():
            if not 0 <= n <= self.cache_len:
                raise ValueError(
                    f"rollback length {n} outside [0, {self.cache_len}]")
            listed[:, slot] = (1, n)
        listed = self._tensor(listed)  # one copy
        index = self.cache.index
        index.copy_(torch.where(listed[0] != 0, listed[1], index))
        self._shapes.setdefault("rollback", set()).add(())

    def compile_counts(self) -> dict[str, int]:
        """Distinct shapes run per entry point: one per prefill bucket,
        one decode, one copy_prefix and, once speculation ran, one per
        verify width and one rollback.  The JAX engine compiles one
        program for each; here each is one CUDA graph a captured step
        would need."""
        return {name: len(shapes) for name, shapes in self._shapes.items()}


# Named Llama configs for the demo surfaces (``--preset`` of the CLI).
LLAMA_PRESETS = ("nano", "tiny", "llama3-1b", "llama3-8b")


def _nano_config():
    from tpucfn_torch.models.llama import LlamaConfig

    return dataclasses.replace(LlamaConfig.tiny(), dim=32, n_layers=1,
                               n_heads=2, n_kv_heads=1, ffn_dim=64)


def demo_llama_engine(preset: str, *, seed: int = 0, max_batch: int = 8,
                      cache_len: int | None = None, prefill_width: int = 4,
                      device: str | torch.device = "cuda"):
    """(cfg, ServeEngine) over a RANDOM-init Llama preset, its weights
    drawn on ``device`` from a generator seeded with ``seed`` (real
    deployments construct the engine from checkpointed weights).  The
    weights are ``engine.model.state_dict()``."""
    from tpucfn_torch.models.llama import LlamaConfig, init_llama_params

    device = resolve_device(device)
    ctors = {"nano": _nano_config, "tiny": LlamaConfig.tiny,
             "llama3-1b": LlamaConfig.llama3_1b,
             "llama3-8b": LlamaConfig.llama3_8b}
    cfg = ctors[preset]()
    gen = torch.Generator(device).manual_seed(seed)
    params = init_llama_params(cfg, generator=gen, device=device)
    return cfg, ServeEngine.from_llama(
        cfg, params, max_batch=max_batch, cache_len=cache_len,
        prefill_width=prefill_width, device=device)
