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

The cache is updated in place (JAX donates the buffer to the same
effect).  Sampling temperatures live in a device-resident
``(max_batch,)`` tensor written only by prefill.  Greedy decode here is
token-identical to :func:`tpucfn_torch.models.generate.generate` wherever
the two attention paths round alike (fp32).  Speculative decoding
(``verify``/``rollback``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from tpucfn_torch.device import resolve_device
from tpucfn_torch.models.generate import categorical


def _sample(logits: torch.Tensor, temps: torch.Tensor,
            generator: torch.Generator | None) -> torch.Tensor:
    """(N, V) fp32 logits -> (N,) int tokens.  temp<=0 is greedy;
    otherwise categorical over logits/temp."""
    greedy = logits.argmax(dim=-1)
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
        return torch.from_numpy(a).to(self.device)

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
        toks_out = _sample(self.model.logits(last), new_temps, self.generator)
        # Pad lanes repeat lane 0: their slots are duplicates, but their
        # rows are identical, so the scatter order does not matter.
        self.cache.put_rows(slots_t, rows)
        self._temps.index_copy_(0, slots_t, new_temps)
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
                      self.generator).cpu().numpy()
        return {slot: int(nxt[slot]) for slot in tokens_by_slot}


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
