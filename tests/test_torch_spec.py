"""Speculative decoding in the port against the JAX package's, on the CPU:
the engine's ``verify`` / ``rollback`` / ``compile_counts`` and the
``SpecDecoder`` over the port's engines, fed JAX's own tiny-Llama weights
(carried across by ``convert``) and the same numpy inputs.

Tolerance: none.  In fp32 both sides take the argmax of logits that agree
to ~1e-6, so every token is held IDENTICAL: the port's verify verdicts to
JAX's, the port's spec output to JAX's spec output and to plain greedy
decode.  Every test builds its own SpecDecoders (draft sync state is per
decoder) over module-wide engines, which every prefill overwrites."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucfn.models.llama import Llama as JaxLlama
from tpucfn.models.llama import LlamaConfig as JaxConfig
from tpucfn.serve import ServeEngine as JaxServeEngine
from tpucfn.serve import Server as JaxServer
from tpucfn.serve.spec import SpecDecoder as JaxSpecDecoder
from tpucfn.serve.spec import SpecKController as JaxSpecKController
from tpucfn_torch.models.convert import llama_state_dict_from_jax
from tpucfn_torch.models.llama import Llama, LlamaConfig
from tpucfn_torch.serve import Cancelled, ServeEngine, Server
from tpucfn_torch.serve.spec import SpecDecoder, SpecKController

torch.set_num_threads(1)

CACHE_LEN = 64


def _nano(cfg, vocab):
    """The demo draft's shape (``serve.engine._nano_config``) at ``vocab``."""
    return dataclasses.replace(cfg, dim=32, n_layers=1, n_heads=2,
                               n_kv_heads=1, ffn_dim=64, vocab_size=vocab)


@pytest.fixture(scope="module")
def models():
    """name -> (JAX cfg, JAX params, port cfg, port state dict): the
    target, a draft of other weights, and a draft whose vocabulary (64)
    is smaller than the target's (256)."""
    jcfg = dataclasses.replace(JaxConfig.tiny(), max_seq=CACHE_LEN)
    pcfg = dataclasses.replace(LlamaConfig.tiny(), max_seq=CACHE_LEN)
    out = {}
    for name, key, jc, pc in (
            ("target", 2, jcfg, pcfg), ("divergent", 77, jcfg, pcfg),
            ("small_vocab", 5, _nano(jcfg, 64), _nano(pcfg, 64))):
        params = JaxLlama(jc).init(jax.random.key(key),
                                   jnp.zeros((2, 8), jnp.int32))["params"]
        sd = llama_state_dict_from_jax(jax.tree.map(np.asarray, params), pc)
        out[name] = (jc, params, pc, sd)
    return out


def _jeng(models, name="target", max_batch=4):
    jc, params, _, _ = models[name]
    return JaxServeEngine.from_llama(jc, params, max_batch=max_batch,
                                     cache_len=CACHE_LEN)


def _peng(models, name="target", max_batch=4):
    _, _, pc, sd = models[name]
    return ServeEngine.from_llama(pc, sd, max_batch=max_batch,
                                  cache_len=CACHE_LEN, device="cpu")


@pytest.fixture(scope="module")
def engines(models):
    """Module-wide engine pairs (JAX, port): target, a second target-weight
    engine (the self draft) and the two other drafts."""
    return {name: (_jeng(models, src), _peng(models, src))
            for name, src in (("target", "target"), ("self", "target"),
                              ("divergent", "divergent"),
                              ("small_vocab", "small_vocab"))}


def _run(server_cls, engine, prompts, max_new, **kw):
    server = server_cls(engine, **{"num_blocks": 48, "block_size": 8, **kw})
    reqs = [server.submit(p, max_new_tokens=max_new) for p in prompts]
    server.run_until_idle()
    assert server.kv.allocator.num_used == 0, "KV blocks leaked"
    return [r.result(timeout=0) if r.error is None else type(r.error).__name__
            for r in reqs], server


def _mixed_prompts(vocab, seed=0, n=10):
    rs = np.random.RandomState(seed)
    system = rs.randint(0, vocab, 16).tolist()
    out = []
    for i in range(n):
        if i % 3 == 0:  # shared-prefix arrivals exercise copy_prefix
            out.append(system + rs.randint(0, vocab, 2 + i % 4).tolist())
        else:
            out.append(rs.randint(0, vocab, rs.randint(3, 14)).tolist())
    return out


def _spec_pair(engines, draft, **kw):
    """(JAX SpecDecoder, port SpecDecoder) over the module engines."""
    jt, pt = engines["target"]
    jd, pd = engines[draft]
    jkw = dict(kw)
    if "controller" in kw:
        c = kw["controller"]
        jkw["controller"] = JaxSpecKController(**c)
        kw = {**kw, "controller": SpecKController(**c)}
    return JaxSpecDecoder(jt, jd, **jkw), SpecDecoder(pt, pd, **kw)


# ---- the engine's verify / rollback ----------------------------------------

def test_verify_and_rollback_match_jax_engine_and_sequential_decode(engines):
    """The verify-then-rollback sequence of the JAX engine's own test, on
    both engines: exact verdicts, the index restored by verify and moved
    by rollback."""
    outs = []
    for eng in engines["target"]:
        prompt = [5, 9, 2, 77, 31]
        ref = [eng.prefill(slot=1, prefix=prompt, bucket=16)]
        for _ in range(6):
            ref.append(eng.decode({1: ref[-1]})[1])
        # rewind the slot by prefilling it again, then verify
        assert eng.prefill(slot=1, prefix=prompt, bucket=16) == ref[0]
        v1 = eng.verify({1: ref[:3]}, 3)[1]       # every proposal right
        eng.rollback({1: len(prompt) + 3})
        v2 = eng.verify({1: [ref[3], 1234 % 256, 7]}, 3)[1]  # wrong ones
        eng.rollback({1: len(prompt) + 4})
        nxt = eng.decode({1: ref[4]})[1]
        outs.append((ref, v1, v2, nxt))
    (ref, v1, v2, nxt), port = outs
    assert port == outs[0]
    assert v1 == ref[1:4] and v2[0] == ref[4] and nxt == ref[5]


def test_verify_restores_every_slots_index(engines):
    _, eng = engines["target"]
    eng.prefill_batch([(0, [1, 2, 3], 0, 0.0), (2, [4, 5, 6, 7, 8], 0, 0.0)],
                      16)
    eng.cache.index[3] = 9  # a free slot's residue length
    before = eng.cache.index.clone()
    eng.verify({0: [3, 4, 5, 6, 7]}, 5)
    assert torch.equal(eng.cache.index, before)


@pytest.mark.parametrize("side", ["jax", "port"])
def test_rollback_is_masked_and_validated(engines, side):
    eng = engines["target"][0 if side == "jax" else 1]
    p = [3, 1, 4, 1, 5]
    a = [eng.prefill(slot=0, prefix=p, bucket=16)]
    b = [eng.prefill(slot=2, prefix=p, bucket=16)]
    eng.verify({0: [a[0], 1, 2]}, 3)
    eng.rollback({0: len(p)})  # slot 2 is not listed: it keeps its place
    for _ in range(3):
        out = eng.decode({0: a[-1], 2: b[-1]})
        a.append(out[0])
        b.append(out[2])
    assert a == b
    with pytest.raises(ValueError, match="width"):
        eng.verify({0: [1, 2]}, 3)
    with pytest.raises(ValueError, match="width must be"):
        eng.verify({}, 0)
    with pytest.raises(ValueError, match="rollback length"):
        eng.rollback({0: CACHE_LEN + 1})
    with pytest.raises(ValueError, match="rollback length"):
        eng.rollback({0: -1})



def test_greedy_steps_draw_nothing_from_the_generator(models):
    """A step in which no slot samples (every temperature 0, vacant slots'
    too) is the argmax alone and leaves the generator where it was; once
    a slot samples, decode and verify draw from it."""
    eng = _peng(models)
    eng.prefill_batch([(0, [1, 2, 3], 0, 0.0)], 16)
    state = eng.generator.get_state()
    eng.decode({0: 4})
    eng.verify({0: [5, 6, 7]}, 3)
    assert torch.equal(eng.generator.get_state(), state)
    eng.prefill_batch([(1, [1, 2, 3], 0, 0.8)], 16)
    for step in (lambda: eng.decode({0: 4, 1: 9}),
                 lambda: eng.verify({0: [5, 6, 7], 1: [9, 1, 2]}, 3)):
        state = eng.generator.get_state()
        step()
        assert not torch.equal(eng.generator.get_state(), state)

def test_verify_lane_at_capacity(engines, models):
    """A lane with index + width > cache_len: the write clamps, the lane
    comes back NaN-poisoned (argmax 0 at every position, as in JAX), and
    the other lanes' verdicts are untouched.  The poisoned lane leaves NaN
    K/V in its slot's deeper layers, so this runs on engines of its own."""
    verdicts = []
    for eng in (_jeng(models), _peng(models)):
        p = list(range(10, 20))
        tok = eng.prefill(slot=1, prefix=p, bucket=16)
        eng.prefill(slot=3, prefix=[7] * 16, bucket=16)
        eng.rollback({3: CACHE_LEN - 2})          # 2 positions of room
        out = eng.verify({1: [tok, 1, 2, 3], 3: [4, 5, 6, 8]}, 4)
        verdicts.append(out)
    jax_out, port_out = verdicts
    assert port_out == jax_out
    assert port_out[3] == [0, 0, 0, 0]
    _, eng = engines["target"]   # lane 1 alone, no lane at capacity
    tok = eng.prefill(slot=1, prefix=list(range(10, 20)), bucket=16)
    assert eng.verify({1: [tok, 1, 2, 3]}, 4)[1] == port_out[1]


def test_compile_counts_match_jax(engines, models):
    counts = []
    for eng in (_jeng(models), _peng(models)):
        eng.prefill_batch([(0, [1, 2, 3], 0, 0.0)], 16)
        eng.prefill_batch([(1, list(range(20)), 0, 0.0)], 32)
        eng.copy_prefix(1, 2, 8)
        eng.decode({0: 1, 1: 2})
        plain = eng.compile_counts()
        for w in (2, 3, 5, 3):
            eng.verify({0: [1] * w}, w)
        eng.rollback({0: 4})
        eng.rollback({1: 20})
        counts.append((plain, eng.compile_counts()))
    assert counts[1] == counts[0]
    assert counts[1][1] == {"prefill": 2, "decode": 1, "copy_prefix": 1,
                            "verify": 3, "rollback": 1}


def test_params_are_the_engines_own_tensors(engines, models):
    _, eng = engines["target"]
    params = eng.params
    assert set(params) == set(eng.model.state_dict())
    draft = ServeEngine.from_llama(models["target"][2], params, max_batch=4,
                                   cache_len=CACHE_LEN, device="cpu")
    for name, t in draft.model.state_dict().items():
        assert t.data_ptr() == params[name].data_ptr(), name


# ---- a draft whose vocabulary is smaller than the target's ------------------

def test_out_of_vocabulary_ids_embed_as_jax_take_does(models):
    """JAX's ``nn.Embed`` is ``jnp.take``: an id past the vocabulary gets
    a row of NaN and a negative id counts from the end.  The port's
    embedding gives the same rows (where ``nn.Embedding`` would raise)."""
    jc, params, pc, sd = models["small_vocab"]
    ids = np.array([[0, 5, 63, 64, 200, -1, -64, -65]])
    want = np.asarray(jnp.take(jnp.asarray(params["embed_tokens"]["embedding"]),
                               jnp.asarray(ids), axis=0))
    model = Llama.from_state_dict(pc, sd, device="cpu")
    got = model._embed(torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])
    assert np.isnan(got[0, 3:5]).all() and np.isnan(got[0, 7]).all()


def test_small_vocab_draft_proposes_what_the_jax_draft_does(engines):
    """Target ids past the draft's vocabulary: the JAX draft runs NaN
    through the rows that see them (its decode step's greedy token is
    argmax(NaN) = 0); the port's draft gives the same tokens, with no
    error."""
    toks = []
    for eng in engines["small_vocab"]:
        first = eng.prefill(slot=0, prefix=[5, 200, 7], bucket=16)
        nxt = eng.decode({0: 250})[0]
        ok = eng.prefill(slot=1, prefix=[5, 20, 7], bucket=16)
        toks.append((first, nxt, ok))
    assert toks[1] == toks[0]
    assert toks[0][1] == 0


# ---- SpecDecoder output: port == JAX == plain greedy -------------------------

@pytest.mark.parametrize("draft", ["self", "divergent", "small_vocab"])
def test_spec_output_equals_jax_spec_and_plain_greedy(engines, draft):
    """A mixed prefill/decode workload with prefix-cache hits, with an
    agreeing, a divergent and a smaller-vocabulary draft."""
    prompts = _mixed_prompts(256)
    jt, pt = engines["target"]
    ref, _ = _run(Server, pt, prompts, 6)
    jref, _ = _run(JaxServer, jt, prompts, 6)
    assert ref == jref
    jspec, spec = _spec_pair(engines, draft, k=4,
                             adaptive=draft == "self")
    jout, jserver = _run(JaxServer, jspec, prompts, 6)
    out, server = _run(Server, spec, prompts, 6)
    assert out == ref and jout == ref
    snap, jsnap = server.metrics.snapshot(), jserver.metrics.snapshot()
    for key in ("spec_rounds", "spec_proposed", "decode_rounds",
                "prefix_hit_requests"):
        assert snap[key] == jsnap[key], key
    if draft == "self":
        assert snap["spec_accepted"] == snap["spec_proposed"] > 0
        assert snap["tokens_per_target_step"] > 1.5
    else:
        assert snap["spec_accepted"] < snap["spec_proposed"]


def test_spec_prefix_hits_equal_jax_and_plain(engines):
    rs = np.random.RandomState(11)
    system = rs.randint(0, 256, 16).tolist()
    first = [system + rs.randint(0, 256, 2).tolist()]
    second = [system + rs.randint(0, 256, 3 + i).tolist() for i in range(3)]

    def staged(server_cls, engine):
        server = server_cls(engine, num_blocks=48, block_size=8)
        reqs = [server.submit(p, max_new_tokens=5) for p in first]
        server.run_until_idle()   # retired: its residue backs later hits
        reqs += [server.submit(p, max_new_tokens=5) for p in second]
        server.run_until_idle()
        assert server.kv.allocator.num_used == 0
        return [r.result(timeout=0) for r in reqs], server

    jt, pt = engines["target"]
    ref, _ = staged(Server, pt)
    jspec, spec = _spec_pair(engines, "self", k=3)
    jout, _ = staged(JaxServer, jspec)
    out, server = staged(Server, spec)
    assert out == ref == jout
    assert server.metrics.snapshot()["prefix_hit_requests"] > 0


def test_spec_preemption_and_slot_reuse_equal_jax_and_plain(engines):
    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, 256, 5).tolist() for _ in range(3)]
    jt, pt = engines["target"]
    ref, _ = _run(Server, pt, prompts, 6, num_blocks=9, block_size=2)
    jspec, spec = _spec_pair(engines, "divergent", k=2, adaptive=False)
    jout, jserver = _run(JaxServer, jspec, prompts, 6, num_blocks=9,
                         block_size=2)
    out, server = _run(Server, spec, prompts, 6, num_blocks=9, block_size=2)
    assert out == ref == jout
    assert server.metrics.snapshot()["preemptions"] > 0
    assert server.metrics.snapshot()["preemptions"] == \
        jserver.metrics.snapshot()["preemptions"]


def _drive_mid_flight(server_cls, engine, act):
    """Two requests decode speculatively for two rounds; then ``act``
    (server, victim) strikes the first; both run to the end."""
    server = server_cls(engine, num_blocks=48, block_size=8)
    victim = server.submit([9, 8, 7], max_new_tokens=30)
    keeper = server.submit([7, 11, 2], max_new_tokens=12)
    for _ in range(4):   # one prefill, then propose-verify rounds
        server.step()
    seq = next(s for s in server.scheduler.running.values()
               if s.seq_id == victim.req_id)
    assert len(seq.generated) > 1
    act(server, victim)
    server.run_until_idle()
    assert server.kv.allocator.num_used == 0
    return victim, keeper.result(timeout=0)


def _expire(server, victim):
    seq = next(s for s in server.scheduler.running.values()
               if s.seq_id == victim.req_id)
    seq.deadline = 0.0  # long past on the monotonic clock


def _cancel(server, victim):
    server.cancel(victim.req_id)


@pytest.mark.parametrize("act", [_expire, _cancel], ids=["deadline", "cancel"])
def test_spec_mid_flight_deadline_and_cancel_equal_jax(engines, act):
    jt, pt = engines["target"]
    ref, _ = _run(Server, pt, [[7, 11, 2]], 12)
    jspec, spec = _spec_pair(engines, "self", k=2)
    jvictim, jkept = _drive_mid_flight(JaxServer, jspec, act)
    victim, kept = _drive_mid_flight(Server, spec, act)
    assert kept == jkept == ref[0]
    assert victim.status == jvictim.status == (
        "expired" if act is _expire else "cancelled")
    assert victim.tokens == jvictim.tokens
    if act is _cancel:
        assert isinstance(victim.error, Cancelled)


def test_spec_off_probe_resync_equals_jax(engines):
    """Speculation forced off goes stale; a probe resyncs the draft through
    its prefill and re-enables speculation, on both sides alike."""
    prompts = _mixed_prompts(256, seed=3, n=4)
    jt, pt = engines["target"]
    ref, _ = _run(Server, pt, prompts, 10)
    jspec, spec = _spec_pair(engines, "self",
                             controller=dict(k=2, probe_every=3))
    jspec.controller.k = spec.controller.k = 0
    jout, jserver = _run(JaxServer, jspec, prompts, 10)
    out, server = _run(Server, spec, prompts, 10)
    assert out == ref == jout
    assert spec.controller.k == jspec.controller.k >= 1
    snap, jsnap = server.metrics.snapshot(), jserver.metrics.snapshot()
    assert (snap["spec_rounds"], snap["spec_accepted"]) == \
        (jsnap["spec_rounds"], jsnap["spec_accepted"])
    assert snap["spec_rounds"] < snap["decode_rounds"]


def test_spec_compile_counts_cover_both_engines(engines, models):
    spec = SpecDecoder(_peng(models), _peng(models), k=4)
    _run(Server, spec, _mixed_prompts(256, n=4), 6)
    counts = spec.compile_counts()
    assert set(counts) == {"target", "draft"}
    assert counts["target"]["verify"] >= 1
    assert counts["target"]["rollback"] == counts["draft"]["rollback"] == 1
    assert "verify" not in counts["draft"]
    assert spec.params is spec.target.params or \
        set(spec.params) == set(spec.target.params)
