"""The port's serving path against the JAX package's, on the CPU: the
engine, the Server and the CLI of ``tpucfn_torch.serve`` over JAX's own
tiny-Llama weights (carried across by ``convert``), greedy tokens held
IDENTICAL to JAX ``generate`` and JAX ``ServeEngine`` (fp32: the same
argmax over logits that agree to ~1e-6).

Sampled (temperature > 0) output is not compared: the port draws from a
``torch.Generator`` and JAX from ``jax.random``, which give different
numbers from the same seed.

Mirrors ``tests/test_serve_engine.py``; one module-wide 8-slot engine,
as there (every prefill overwrites its slot's whole row)."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucfn.models.generate import generate as jax_generate
from tpucfn.models.llama import Llama as JaxLlama
from tpucfn.models.llama import LlamaConfig as JaxConfig
from tpucfn.serve import ServeEngine as JaxServeEngine
from tpucfn_torch.models.convert import llama_state_dict_from_jax
from tpucfn_torch.models.generate import generate
from tpucfn_torch.models.llama import LlamaConfig
from tpucfn_torch.serve import DeadlineExceeded, ServeEngine, Server

# The suite runs several pytest workers side by side on the CPU; torch's
# intra-op pool would otherwise claim every core in each of them and starve
# the JAX tests' multi-device collectives in the other workers.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(JaxConfig.tiny(), max_seq=64)
    params = JaxLlama(jcfg).init(jax.random.key(2),
                                 jnp.zeros((2, 8), jnp.int32))["params"]
    pcfg = dataclasses.replace(LlamaConfig.tiny(), max_seq=64)
    sd = llama_state_dict_from_jax(jax.tree.map(np.asarray, params), pcfg)
    return jcfg, params, pcfg, sd


@pytest.fixture(scope="module")
def eng8(tiny):
    _, _, pcfg, sd = tiny
    return ServeEngine.from_llama(pcfg, sd, max_batch=8, cache_len=64,
                                  device="cpu")


def _ref_tokens(tiny, prompts, max_new):
    """JAX greedy references for same-length prompts, in ONE generate()
    call."""
    jcfg, params, _, _ = tiny
    assert len({len(p) for p in prompts}) == 1
    out = jax_generate(jcfg, params, jnp.asarray(prompts, jnp.int32),
                       max_new_tokens=max_new)
    return [list(map(int, np.asarray(out[i, len(prompts[i]):])))
            for i in range(len(prompts))]


def _refs_by_len(tiny, prompts, max_new):
    by_len = {}
    for p in prompts:
        by_len.setdefault(len(p), []).append(p)
    refs = {}
    for same in by_len.values():
        refs.update(zip(map(tuple, same), _ref_tokens(tiny, same, max_new)))
    return refs


def test_generate_matches_jax_generate(tiny):
    _, _, pcfg, sd = tiny
    prompts = np.random.RandomState(5).randint(0, 256, (3, 6))
    out = generate(pcfg, sd, prompts, max_new_tokens=6)
    assert out.shape == (3, 12)
    assert [row[6:] for row in out.tolist()] == _ref_tokens(
        tiny, prompts.tolist(), 6)


def test_engine_greedy_parity_with_jax_engine_and_generate(tiny, eng8):
    jcfg, params, _, _ = tiny
    prompt = [5, 9, 2, 77, 31]
    tok = eng8.prefill(slot=1, prefix=prompt, bucket=16)
    toks = [tok]
    for _ in range(5):
        toks.append(eng8.decode({1: toks[-1]})[1])
    assert toks == _ref_tokens(tiny, [prompt], 6)[0]
    jeng = JaxServeEngine.from_llama(jcfg, params, max_batch=2, cache_len=64)
    jtoks = [jeng.prefill(slot=1, prefix=prompt, bucket=16)]
    for _ in range(5):
        jtoks.append(jeng.decode({1: jtoks[-1]})[1])
    assert toks == jtoks


def test_engine_parity_interleaved_ragged_slots(tiny, eng8):
    rs = np.random.RandomState(3)
    p_a = rs.randint(0, 256, 11).tolist()
    p_b = rs.randint(0, 256, 4).tolist()
    a = [eng8.prefill(slot=0, prefix=p_a, bucket=16)]
    a.append(eng8.decode({0: a[-1]})[0])          # a decodes alone first
    b = [eng8.prefill(slot=2, prefix=p_b, bucket=16)]
    for _ in range(4):                            # then both, interleaved
        out = eng8.decode({0: a[-1], 2: b[-1]})
        a.append(out[0])
        b.append(out[2])
    assert a == _ref_tokens(tiny, [p_a], 6)[0]
    assert b == _ref_tokens(tiny, [p_b], 5)[0]


def test_engine_copy_prefix_then_suffix_prefill_parity(tiny, eng8):
    prompt = np.random.RandomState(7).randint(0, 256, 12).tolist()
    a = [eng8.prefill(slot=5, prefix=prompt, bucket=16)]
    eng8.copy_prefix(5, 6, 8)
    b = [eng8.prefill(slot=6, prefix=prompt[8:], bucket=16, start=8)]
    for _ in range(4):
        out = eng8.decode({5: a[-1], 6: b[-1]})
        a.append(out[5])
        b.append(out[6])
    ref = _ref_tokens(tiny, [prompt], 5)[0]
    assert a == ref
    assert b == ref


def test_engine_prefill_batch_matches_singles(tiny, eng8):
    rs = np.random.RandomState(11)
    prompts = [rs.randint(0, 256, n).tolist() for n in (5, 9, 13)]
    toks = eng8.prefill_batch([(s, p, 0, 0.0) for s, p in enumerate(prompts)],
                              bucket=16)
    singles = [eng8.prefill(slot=s + 3, prefix=p, bucket=16)
               for s, p in enumerate(prompts)]
    assert [toks[s] for s in range(3)] == singles
    outs = {s: [toks[s]] for s in (0, 1, 2)}
    for _ in range(3):
        nxt = eng8.decode({s: outs[s][-1] for s in outs})
        for s in outs:
            outs[s].append(nxt[s])
    for slot, p in enumerate(prompts):
        assert outs[slot] == _ref_tokens(tiny, [p], 4)[0]


def test_server_e2e_zero_leaks(tiny, eng8):
    rs = np.random.RandomState(0)
    lengths = [3, 5, 8, 10, 12]
    system = rs.randint(0, 256, 16).tolist()
    prompts = [rs.randint(0, 256, lengths[i % 5]).tolist() for i in range(6)]
    prompts += [system + rs.randint(0, 256, 3).tolist() for _ in range(4)]
    server = Server(eng8, num_blocks=64, block_size=8)
    reqs = [server.submit(p, max_new_tokens=4) for p in prompts]
    dead = server.submit([1, 2, 3], max_new_tokens=4, deadline_s=-1.0)
    server.run_until_idle()
    refs = _refs_by_len(tiny, prompts, 4)
    for p, r in zip(prompts, reqs):
        assert r.result(timeout=0) == refs[tuple(p)]
    with pytest.raises(DeadlineExceeded):
        dead.result(timeout=0)
    snap = server.metrics.snapshot()
    assert snap["completed"] == 10 and snap["expired"] == 1
    assert snap["prefix_hit_requests"] > 0
    assert snap["prefill_calls"] < len(prompts)
    assert server.kv.allocator.num_used == 0
    assert server.kv.allocator.num_free == 64


def test_server_preemption_preserves_greedy_output(tiny, eng8):
    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, 256, 5).tolist() for _ in range(3)]
    # 5-token prompts at block_size 2 = 3 blocks each: all three admit
    # into 9 blocks with zero slack, so the first decode reservations
    # must evict.
    server = Server(eng8, num_blocks=9, block_size=2)
    reqs = [server.submit(p, max_new_tokens=6) for p in prompts]
    server.run_until_idle()
    refs = _ref_tokens(tiny, prompts, 6)
    for r, ref in zip(reqs, refs):
        assert r.result(timeout=0) == ref
    assert server.metrics.snapshot()["preemptions"] > 0
    assert server.kv.allocator.num_free == 9


def test_cli_serve_cpu_smoke():
    proc = subprocess.run(
        [sys.executable, "-m", "tpucfn_torch.cli", "serve", "--preset",
         "tiny", "--device", "cpu", "--synthetic", "6", "--prompt-len", "3:9",
         "--max-new", "4", "--max-batch", "4", "--cache-len", "64",
         "--num-blocks", "32", "--block-size", "8"],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    snap = json.loads(proc.stdout.strip().splitlines()[-1])
    assert snap["completed"] == 6
    assert snap["generated_tokens"] == 24
