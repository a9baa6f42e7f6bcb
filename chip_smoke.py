#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpucfn_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # every phase; needs one CUDA device

Phases, each printed as one JSON line:

1. ``device``: the card's name, and its name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   gives them (also printed raw on a line of its own).
2. ``build``: compiles every kernel of the serving path from
   ``tpucfn_torch/kernels/csrc`` with ``nvcc`` for ``sm_90a``.
3. ``kernel``: the flash forward kernel against its plain PyTorch version
   on the same inputs, at the serving path's shapes (llama3-1b decode
   and prefill) and at the edge cases (fp32/D=16/GQA, empty rows,
   segment ids, non-causal); error, tolerance, times of the kernel, the
   plain version and one PyTorch library call
   (``scaled_dot_product_attention`` with a boolean mask: a yardstick
   only, never called by the port), and the roofline bound.
4. ``serve_llama3_1b``: ``Server`` -> ``ServeEngine`` -> ``Llama`` at the
   full width and depth of llama3-1b (random weights from a seed) answers
   8 requests; every request completes, no KV block leaks, the kernel ran
   on every layer of every prefill and decode call, and teacher-forced
   logits agree with the plain attention path.
5. ``serve_tiny_fp32``: the tiny preset in fp32; the engine's greedy
   tokens (kernel) equal ``generate``'s (plain attention).

Then a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``.  Any failed phase exits non-zero before that line.  Without a
CUDA device, or without the package beside it, the script exits 1 and
prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
PHASES = ("device", "build", "kernel", "serve_llama3_1b", "serve_tiny_fp32")

# NVIDIA H100 SXM published peaks (dense), at the full 700 W limit.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}

# K1 against its plain version.  bf16: the plain version rounds P to bf16
# before the PV product (as the JAX dense path does) while the kernel
# keeps P in fp32, so O differs by up to ~2^-9 * max|v| plus the output's
# own bf16 rounding; LSE is fp32 on both sides (sum order only).  fp32:
# sum order only.
TOL = {"torch.bfloat16": {"o": 2e-2, "lse": 1e-3},
       "torch.float32": {"o": 2e-5, "lse": 2e-5}}
# Teacher-forced llama3-1b logits, kernel path vs plain path (bf16): the
# P rounding above, carried through 16 layers of bf16 activations.
LOGITS_TOL_BF16 = 0.25


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Phase:
    def __init__(self):
        self.failed = []

    def run(self, name, fn, *args):
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        except Exception:  # noqa: BLE001 — report the phase, then stop
            traceback.print_exc()
            emit({"phase": name, "ok": False,
                  "seconds": round(time.perf_counter() - t0, 3)})
            self.failed.append(name)
            return None
        emit({"phase": name, "ok": True,
              "seconds": round(time.perf_counter() - t0, 3), **(out or {})})
        return out


# ---- phase 1 ---------------------------------------------------------------
def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    return {"name": torch.cuda.get_device_name(0),
            "nvidia_smi": smi[0] if smi else None,
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda}


# ---- phase 2 ---------------------------------------------------------------
def phase_build():
    from tpucfn_torch.kernels import _build

    logs = _build.build("flash_fwd")
    for name, log in logs.items():
        print(f"--- nvcc {name}\n{log}", file=sys.stderr)
    _build.load("flash_fwd")
    return {"built": sorted(logs), "library": str(
        _build.library_path("flash_fwd").relative_to(HERE))}


# ---- phase 3 ---------------------------------------------------------------
class Timer:
    """Mean device time of one call in ms: CUDA events around each call,
    with the L2 cache flushed before each (a serving layer meets its K/V
    cold).  The calls are queued behind a sleeping kernel, so the events
    time the device's work and not the host's Python around the launch."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters=30, warmup=3):
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        marks = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        torch.cuda._sleep(100_000_000)  # ~50 ms: the host queues meanwhile
        for a, b in marks:
            self.flush.zero_()
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in marks) / iters


def _kernel_cases(torch):
    """(label, kwargs for the inputs) at the serving path's shapes and the
    edge cases."""
    bf, f32 = torch.bfloat16, torch.float32
    sk = 2048  # llama3-1b serving cache_len
    decode_off = [int(x) for x in torch.linspace(0, sk - 1, 8)]
    cases = [("decode_llama3_1b", dict(b=8, h=32, hkv=8, d=64, sq=1, sk=sk,
                                       dtype=bf, q_offset=decode_off))]
    for sq in (16, 128, 512):
        cases.append((f"prefill_llama3_1b_sq{sq}",
                      dict(b=4, h=32, hkv=8, d=64, sq=sq, sk=sk, dtype=bf,
                           q_offset=[0, 0, 300, sk - sq])))
    cases += [
        ("tiny_fp32_d16_gqa2", dict(b=2, h=4, hkv=2, d=16, sq=64, sk=64,
                                    dtype=f32, q_offset=[0, 0])),
        ("empty_rows_k_offset", dict(b=2, h=4, hkv=4, d=64, sq=128, sk=128,
                                     dtype=bf, q_offset=[0, 0], k_offset=40)),
        ("segment_ids", dict(b=2, h=8, hkv=2, d=64, sq=256, sk=256, dtype=bf,
                             q_offset=[0, 0], segments=True)),
        ("non_causal_d128_ragged", dict(b=2, h=8, hkv=8, d=128, sq=200,
                                        sk=300, dtype=bf, q_offset=[0, 0],
                                        causal=False)),
        ("fp32_d128_two_chunk_tiles", dict(b=2, h=8, hkv=4, d=128, sq=96,
                                           sk=160, dtype=f32,
                                           q_offset=[0, 64])),
    ]
    return cases


def _one_case(torch, timer, label, b, h, hkv, d, sq, sk, dtype, q_offset,
              k_offset=0, causal=True, segments=False):
    import torch.nn.functional as F

    from tpucfn_torch.kernels import flash_attention as fa
    from tpucfn_torch.ops.attention import (NEG_INF,
                                            dot_product_attention_with_lse)

    g = torch.Generator("cuda").manual_seed(len(label))
    q = torch.randn(b, sq, h, d, generator=g, device="cuda").to(dtype)
    k = torch.randn(b, sk, hkv, d, generator=g, device="cuda").to(dtype)
    v = torch.randn(b, sk, hkv, d, generator=g, device="cuda").to(dtype)
    q_off = torch.tensor(q_offset, dtype=torch.int32, device="cuda")
    q_seg = kv_seg = mask = None
    if segments:
        q_seg = (torch.arange(sq, device="cuda") // 48).int()[None].expand(b, sq).contiguous()
        kv_seg = (torch.arange(sk, device="cuda") // 48).int()[None].expand(b, sk).contiguous()
        mask = (q_seg[:, None, :, None] == kv_seg[:, None, None, :])

    def kernel():
        return fa.flash_fwd(q, k, v, causal=causal, q_offset=q_off,
                            k_offset=k_offset, q_seg=q_seg, kv_seg=kv_seg)

    def plain():
        return dot_product_attention_with_lse(
            q, k, v, causal=causal, mask=mask, q_offset=q_off,
            k_offset=k_offset)

    o, lse = kernel()
    torch.cuda.synchronize()
    ro, rlse = plain()
    rlse = rlse.transpose(1, 2)
    tol = TOL[str(dtype)]
    err_o = (o.float() - ro.float()).abs().max().item()
    err_lse = (lse - rlse).abs().max().item()
    finite = bool(torch.isfinite(o).all() and torch.isfinite(lse).all())
    # Live (query, key) pairs of these inputs: the work the function needs.
    qpos = q_off.long()[:, None] + torch.arange(sq, device="cuda")[None]
    kpos = torch.arange(sk, device="cuda") + k_offset
    live = torch.ones(b, sq, sk, dtype=torch.bool, device="cuda")
    if causal:
        live &= qpos[:, :, None] >= kpos[None, None, :]
    if mask is not None:
        live &= mask[:, 0]
    empty = ~live.any(-1)  # (B, Sq) rows attending to nothing
    empty_ok = bool((o.float()[empty] == 0).all()
                    and (lse.transpose(1, 2)[empty] == NEG_INF).all())
    ok = err_o <= tol["o"] and err_lse <= tol["lse"] and finite and empty_ok

    # Library yardstick: SDPA over (B, H, S, D), KV heads repeated and the
    # mask built beforehand (outside the timed call).
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    kt = kt.repeat_interleave(h // hkv, dim=1)
    vt = vt.repeat_interleave(h // hkv, dim=1)
    lib_mask = live[:, None]

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=lib_mask)

    ms = timer(kernel)
    plain_ms = timer(plain)
    library_ms = timer(library)
    esize = torch.finfo(dtype).bits // 8
    keys_needed = live.any(1).sum(-1)  # (B,) keys any query row of b sees
    bytes_ = (q.numel() * esize * 2                       # q in, o out
              + int(keys_needed.sum()) * hkv * d * esize * 2   # K and V
              + b * h * sq * 4 + b * 4                    # lse out, offsets
              + (b * (sq + sk) * 4 if segments else 0))
    flops = 4 * d * h * int(live.sum())  # QK^T and PV, 2 flops per MAC
    t_bytes = bytes_ / PEAK_BYTES_S * 1e3
    t_flops = flops / PEAK_FLOPS[str(dtype)] * 1e3
    return {"case": label, "shape": dict(b=b, h=h, hkv=hkv, d=d, sq=sq, sk=sk,
                                         dtype=str(dtype), causal=causal,
                                         k_offset=k_offset, segments=segments),
            "ok": ok, "max_abs_err": err_o, "lse_max_abs_err": err_lse,
            "tol": tol, "finite": finite, "empty_rows": int(empty.sum()),
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "bytes": bytes_, "flops": flops}


def phase_kernel(results):
    import torch

    from tpucfn_torch.kernels import flash_attention as fa

    timer = Timer(torch)
    before = fa.flash_fwd.launches
    rows = []
    for label, kw in _kernel_cases(torch):
        row = _one_case(torch, timer, label, **kw)
        emit({"kernel_case": row})
        rows.append(row)
    results["kernel_rows"] = rows
    bad = [r["case"] for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")
    if fa.flash_fwd.launches == before:
        raise AssertionError("the comparisons never launched the kernel")
    return {"cases": len(rows),
            "worst_max_abs_err": max(r["max_abs_err"] for r in rows)}


# ---- phases 4 and 5 ----------------------------------------------------------
def _instrument(engine, counts):
    """Count and time the engine's prefill and decode calls (each ends in a
    device->host copy of the sampled tokens, so host time is complete)."""
    for name in ("prefill_batch", "decode"):
        inner = getattr(engine, name)

        def timed(*a, _inner=inner, _name=name, **kw):
            t0 = time.perf_counter()
            out = _inner(*a, **kw)
            counts[_name] += 1
            counts[_name + "_s"] += time.perf_counter() - t0
            return out

        setattr(engine, name, timed)


def _teacher_forced_logits(torch, model, prompt, out):
    """Logits at the positions that predict each generated token, from one
    decode-mode pass over prompt + generated[:-1] on a fresh cache."""
    seq = torch.tensor([prompt + out[:-1]], device="cuda")
    cache = model.init_cache(1)
    with torch.no_grad():
        hidden = model(seq, cache=cache, return_hidden=True)
        return model.logits(hidden[0, len(prompt) - 1:])


def _profile(torch, fn, steps):
    """Host wall time and device kernel time per call of ``fn`` over a
    short profiled window (torch.profiler with CUDA activity); the device
    busy share is kernel time over wall time (one stream, no overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [r for r in prof.key_averages()
               if r.device_type == DeviceType.CUDA]
    device_ms = sum(r.self_device_time_total for r in kernels) / 1e3 / steps
    top = sorted(kernels, key=lambda r: -r.self_device_time_total)[:8]
    return {"wall_ms": wall_ms,
            "device_ms": device_ms if kernels else "not measured",
            "device_busy_share": device_ms / wall_ms if kernels else None,
            "kernels_per_call": sum(r.count for r in kernels) / steps,
            "top_device_ms": [[r.key[:60], r.self_device_time_total / 1e3
                               / steps] for r in top]}


def phase_serve_llama3_1b(results):
    import numpy as np
    import torch

    from tpucfn_torch.kernels import flash_attention as fa
    from tpucfn_torch.models.llama import Llama
    from tpucfn_torch.serve import Server
    from tpucfn_torch.serve.engine import demo_llama_engine

    cache_len, max_new = 2048, 32
    cfg, engine = demo_llama_engine("llama3-1b", seed=0, max_batch=8,
                                    cache_len=cache_len, prefill_width=4,
                                    device="cuda")
    assert (cfg.dim, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.ffn_dim, cfg.vocab_size) == \
        (2048, 16, 32, 8, 64, 8192, 128256), cfg
    rs = np.random.RandomState(0)
    shared = rs.randint(0, cfg.vocab_size, 64).tolist()
    lengths = [16, 48, 100, 200, 333, 512]
    prompts = [rs.randint(0, cfg.vocab_size, n).tolist() for n in lengths]
    prompts += [shared + rs.randint(0, cfg.vocab_size, n).tolist()
                for n in (40, 150)]

    # Warm-up (cuBLAS handles, the kernel library): one short request on a
    # throwaway Server over the same engine.
    warm = Server(engine, num_blocks=16, block_size=16)
    warm.submit(prompts[0], max_new_tokens=2)
    warm.run_until_idle()

    counts = {"prefill_batch": 0, "decode": 0, "prefill_batch_s": 0.0,
              "decode_s": 0.0}
    _instrument(engine, counts)
    server = Server(engine, num_blocks=cache_len * 8 // 16, block_size=16,
                    prefix_cache=True, max_prefill_batch=4)
    fa.flash_fwd.launches = 0
    reqs = [server.submit(p, max_new_tokens=max_new) for p in prompts]
    server.run_until_idle()
    torch.cuda.synchronize()
    launches = fa.flash_fwd.launches
    counts = dict(counts)  # the run's; later calls below are not counted
    calls = counts["prefill_batch"] + counts["decode"]
    results["main_path_launches"] = launches

    snap = server.metrics.snapshot()
    assert all(r.error is None for r in reqs), [r.error for r in reqs]
    assert snap["completed"] == len(prompts), snap
    assert server.kv.allocator.num_used == 0, server.kv.allocator.num_used
    assert launches == cfg.n_layers * calls, (launches, calls)
    assert snap["prefix_hit_requests"] >= 1, snap

    plain = Llama.from_state_dict(engine.model.cfg, engine.model.state_dict(),
                                  decode=True, device="cuda")
    worst, match, total = 0.0, 0, 0
    for p, r in zip(prompts, reqs):
        out = r.result(timeout=0)
        ref = _teacher_forced_logits(torch, plain, p, out)
        got = _teacher_forced_logits(torch, engine.model, p, out)
        assert torch.isfinite(got).all() and got.shape == (max_new, cfg.vocab_size)
        worst = max(worst, (ref[-1] - got[-1]).abs().max().item())
        match += int((ref.argmax(-1).cpu() == torch.tensor(out)).sum())
        total += len(out)
    assert worst <= LOGITS_TOL_BF16, worst

    tpot = [(r.t_done - r.t_first_token) / (len(r.tokens) - 1) for r in reqs]
    # Where the time goes: a decode step over all 8 slots, and a full-width
    # prefill call (4 lanes x 512 tokens), profiled after the run.
    profile_decode = _profile(
        torch, lambda: engine.decode({s: 1 for s in range(8)}), 6)
    long_prompts = [(s, prompts[5], 0, 0.0) for s in range(4)]
    profile_prefill = _profile(
        torch, lambda: engine.prefill_batch(long_prompts, 512), 2)
    return {"requests": len(reqs), "completed": snap["completed"],
            "kv_blocks_used_after": server.kv.allocator.num_used,
            "prefill_calls": counts["prefill_batch"],
            "decode_steps": counts["decode"],
            "k1_launches": launches,
            "k1_launches_expected": cfg.n_layers * calls,
            "prefix_hit_requests": snap["prefix_hit_requests"],
            "last_logits_max_abs_err": worst,
            "logits_tol": LOGITS_TOL_BF16,
            "greedy_match_rate": match / total,
            "ttft_s": snap["ttft_s"], "tpot_s_mean": sum(tpot) / len(tpot),
            "prefill_tokens_per_s": snap["prefilled_tokens"]
            / counts["prefill_batch_s"],
            "decode_tokens_per_s": snap["decode_tokens"] / counts["decode_s"],
            "decode_step_ms_mean": counts["decode_s"] / counts["decode"] * 1e3,
            "prefilled_tokens": snap["prefilled_tokens"],
            "decode_tokens": snap["decode_tokens"],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "profile_decode_step": profile_decode,
            "profile_prefill_4x512": profile_prefill}


def phase_serve_tiny_fp32(results):
    import numpy as np
    import torch

    from tpucfn_torch.models.generate import generate
    from tpucfn_torch.serve import Server
    from tpucfn_torch.serve.engine import demo_llama_engine

    cfg, engine = demo_llama_engine("tiny", seed=1, max_batch=4, cache_len=128,
                                    device="cuda")
    assert cfg.dtype == torch.float32
    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, cfg.vocab_size, n).tolist()
               for n in (3, 9, 17, 30, 41, 64)]
    server = Server(engine, num_blocks=64, block_size=8)
    reqs = [server.submit(p, max_new_tokens=12) for p in prompts]
    server.run_until_idle()
    params = engine.model.state_dict()
    for p, r in zip(prompts, reqs):
        ref = generate(cfg, params, [p], max_new_tokens=12)[0, len(p):]
        assert r.result(timeout=0) == ref.tolist(), (p, r.tokens, ref)
    assert server.kv.allocator.num_used == 0
    return {"requests": len(reqs), "identical": True}


def _kernels_line(results):
    rows = results.get("kernel_rows", [])
    main = next(r for r in rows if r["case"] == "decode_llama3_1b")
    return {"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "tpucfn_torch/kernels/csrc/flash_fwd.cu",
        "replaces": "tpucfn/kernels/flash_attention.py:98",
        "launches": results["main_path_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "at": main["case"],
        "shapes": [{k: r[k] for k in ("case", "ms", "plain_ms", "library_ms",
                                       "bound_ms", "bound_by", "max_abs_err")}
                   for r in rows]}]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    wanted = [p for p in args.phases.split(",") if p]
    if not (HERE / "tpucfn_torch").is_dir():
        print("chip_smoke: the tpucfn_torch package is not beside this "
              "script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # fp32 means fp32: no TF32 in the plain versions' products.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    results: dict = {}
    phase = Phase()
    fns = {"device": lambda: phase_device(), "build": lambda: phase_build(),
           "kernel": lambda: phase_kernel(results),
           "serve_llama3_1b": lambda: phase_serve_llama3_1b(results),
           "serve_tiny_fp32": lambda: phase_serve_tiny_fp32(results)}
    for name in wanted:
        phase.run(name, fns[name])
        if phase.failed:
            return 1
    if set(wanted) != set(PHASES):
        print("chip_smoke: partial run, no result", file=sys.stderr)
        return 2
    emit(_kernels_line(results))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
