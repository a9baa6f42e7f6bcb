"""The measured dense/flash speedup table (the port of the measurement
half of ``tpucfn/kernels/flash_autotune.py``).

* :func:`tune` times the port's plain dense attention
  (:func:`tpucfn_torch.ops.attention.dot_product_attention`) against the
  flash kernels' ``torch.autograd.Function``
  (:func:`tpucfn_torch.kernels.flash_attention.flash_attention`), forward
  + backward, with CUDA events, and persists the dense/flash ratio.
* :func:`lookup_speedup` — the evidence :mod:`tpucfn_torch.kernels.auto`
  consults: the measured ratio for an (S, D, dtype, causal) family on the
  current card, or None.

The table is keyed by (device kind, causal, S bucket, D, dtype) as in the
JAX package, with the device kind of ``torch.cuda.get_device_name()``
and the S bucket the next power of two.  Entries keep the JAX format,
``[block_q, block_k, speedup]``, and a fourth element: the card's name
and power limit as ``nvidia-smi`` gives them.  Block-size pairs have no
counterpart here: the port's kernels pick their own tiles (fixed in their
sources or planned from the shapes), so the block half of an entry is
null and the JAX module's ``lookup`` of (block_q, block_k) is not ported.

``flash_tune_builtin.json`` beside this module holds the entries measured
by ``python -m tpucfn_torch.kernels.flash_autotune`` on the card it names;
a user's own ``tune`` runs (``~/.tpucfn/flash_tune.json``, or
``TPUCFN_FLASH_TUNE_CACHE``) override them per key.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

_MEM_CACHE: dict[str, tuple[int, int]] | None = None

# The example's families: llama3-1b (D = 64) and llama3-8b (D = 128)
# attention, 32 query heads over 8 KV heads, causal, bf16, from its
# default --seq-len of 128 up to 8192.
FAMILIES = tuple((s, d) for s in (128, 256, 512, 1024, 2048, 4096, 8192)
                 for d in (64, 128))


def _cache_path() -> Path:
    return Path(os.environ.get(
        "TPUCFN_FLASH_TUNE_CACHE",
        os.path.expanduser("~/.tpucfn/flash_tune.json")))


def _bucket(s: int) -> int:
    b = 128
    while b < s:
        b *= 2
    return b


def _dtype_name(dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``: numpy's name of the same
    type, which the JAX package's keys carry."""
    return str(dtype).removeprefix("torch.")


# Differs from the JAX package's: dtype names without numpy.
def _key(device_kind: str, causal: bool, s: int, d: int, dtype) -> str:
    return "|".join([device_kind, "causal" if causal else "full",
                     str(_bucket(s)), str(d), _dtype_name(dtype)])


def _read_table(path: Path) -> dict[str, tuple]:
    """Entries are [block_q, block_k] (legacy) or [block_q, block_k,
    speedup] where speedup is the MEASURED fwd+bwd dense/flash time
    ratio at tune time (None/absent = never measured against dense)."""
    try:
        raw = json.loads(path.read_text())
        return {k: tuple(v) for k, v in raw.items()}
    except (OSError, ValueError):
        return {}


# Differs from the JAX package's: the docstring names the port's table.
def _load() -> dict[str, tuple[int, int]]:
    """User cache layered over the packaged table: the entries shipped
    with the package (flash_tune_builtin.json, each measured on the card
    it names) seed the defaults; a user's own ``tune`` runs
    override them per key.  The user cache file stores only the user's
    own tunes (``_save`` never writes builtin entries into it, so a
    package update can improve unpinned keys)."""
    global _MEM_CACHE
    if _MEM_CACHE is None:
        table = _read_table(Path(__file__).parent / "flash_tune_builtin.json")
        for k, v in _read_table(_cache_path()).items():
            # A legacy (pre-speedup) user entry must not erase a builtin
            # measured ratio it agrees with on blocks — that would flip
            # a measured-winning family back to the no-evidence dense
            # rule for exactly the users who tuned.
            old = table.get(k)
            if (len(v) < 3 and old is not None and len(old) >= 3
                    and tuple(old[:2]) == tuple(v[:2])):
                v = tuple(v[:2]) + (old[2],)
            table[k] = v
        _MEM_CACHE = table
    return _MEM_CACHE


def _save(cache: dict[str, tuple[int, int]]) -> None:
    p = _cache_path()
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_suffix(".tmp")
    tmp.write_text(json.dumps({k: list(v) for k, v in cache.items()},
                              indent=1, sort_keys=True))
    os.replace(tmp, p)


def _device_kind() -> str | None:
    """The current card's name, or None without one."""
    import torch

    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name()


# Differs from the JAX package's: the kind is the CUDA card's name.
def _entry(s: int, d: int, dtype, causal: bool) -> tuple | None:
    kind = _device_kind()
    if kind is None:
        return None
    return _load().get(_key(kind, causal, s, d, dtype))


def kind_has_entries(device_kind: str) -> bool:
    """Whether the merged table (builtin + user cache) has ANY entry for
    this device kind — the discoverability probe behind
    ``kernels.auto``'s one-time untuned-device warning: a kind with zero
    entries runs dense everywhere below ``untuned_flash_min_s`` and the
    operator should know why."""
    prefix = device_kind + "|"
    return any(k.startswith(prefix) for k in _load())


def lookup_speedup(s: int, d: int, dtype, causal: bool) -> float | None:
    """MEASURED fwd+bwd speedup of tuned flash over XLA dense for this
    shape family on the current device — the evidence
    ``kernels.auto``'s dispatch consults (VERDICT r4 #5). None when the
    family was never tuned against dense (incl. legacy 2-entry rows)."""
    e = _entry(s, d, dtype, causal)
    if e is None or len(e) < 3 or e[2] is None:
        return None
    return float(e[2])


def card_label() -> str | None:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (its
    first line), or None when it cannot be read."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def tune(s: int, d: int = 128, *, heads: int = 32, kv_heads: int = 8,
         batch: int = 1, dtype=None, causal: bool = True, iters: int = 5,
         persist: bool = True) -> dict:
    """Time plain dense attention and the flash Function, forward +
    backward of ``sum(out.float() ** 2)``, on the current card; persist
    and return the ratio.

    Returns ``{"key", "flash_ms", "dense_ms", "speedup_vs_dense",
    "label"}``: each time is the mean of ``iters`` calls after one
    warm-up, measured with CUDA events.  Dense running out of memory is
    an answer too: ``dense_ms`` then holds the error and the speedup is
    None (the untuned-length rule in :mod:`tpucfn_torch.kernels.auto`
    decides such a family)."""
    import torch

    from tpucfn_torch.device import resolve_device
    from tpucfn_torch.kernels.flash_attention import flash_attention
    from tpucfn_torch.ops.attention import dot_product_attention

    device = resolve_device("cuda")
    dtype = dtype or torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(0)

    def rand(h):
        return torch.randn((batch, s, h, d), generator=gen, device=device,
                           dtype=dtype).requires_grad_(True)

    q, k, v = rand(heads), rand(kv_heads), rand(kv_heads)

    def fwd_bwd(attention):
        out = attention(q, k, v, causal=causal)
        torch.autograd.grad((out.float() ** 2).sum(), (q, k, v))

    def timed(attention):
        fwd_bwd(attention)  # builds the kernels' libraries on first use
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fwd_bwd(attention)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    flash_ms = timed(flash_attention)
    speedup = None
    try:
        dense_ms = timed(dot_product_attention)
        speedup = round(dense_ms / flash_ms, 3)
    except torch.OutOfMemoryError as e:
        dense_ms = f"error: {repr(e)[:160]}"
        torch.cuda.empty_cache()

    key = _key(_device_kind(), causal, s, d, dtype)
    label = card_label()
    if persist:
        global _MEM_CACHE
        user = _read_table(_cache_path())
        user[key] = (None, None, speedup, label)
        _save(user)
        _MEM_CACHE = None  # re-merge (builtin + user) on next lookup
    return {"key": key, "flash_ms": flash_ms, "dense_ms": dense_ms,
            "speedup_vs_dense": speedup, "label": label}


def main(argv=None) -> int:
    """Tune every family of :data:`FAMILIES` and write the table (the
    form of ``flash_tune_builtin.json``) to ``--out``; one JSON line per
    family on stdout."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__.split(";")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    table = {}
    for s, d in FAMILIES:
        row = tune(s, d, iters=args.iters, persist=False)
        print(json.dumps({"s": s, "d": d, **row}), flush=True)
        table[row["key"]] = [None, None, row["speedup_vs_dense"],
                             row["label"]]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(table, indent=1, sort_keys=True)
                              + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
