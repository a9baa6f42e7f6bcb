"""The port's training path against the JAX package's, on the CPU.

* the tiny Llama's loss and every parameter gradient (JAX's weights
  carried across by ``convert.llama_state_dict_from_jax``, JAX's gradient
  tree by the same mapping): the dense path with the port's flash
  Function pinned (the plain forward and backward for CPU tensors) against
  JAX's dense path, the chunked CE, the packed path, and remat;
* the optimizer chain (global-norm clip, warmup-cosine schedule, AdamW)
  against optax numbers produced here;
* the port's ``Trainer`` from JAX's init params against the stored
  ``tiny_llama`` golden curve (``tests/golden_curves.json``), at the
  golden test's own ``RTOL``;
* the trainer's grad accumulation, EMA and refusals.

fp32 throughout.  Tolerances: the loss within 1e-5 absolute and each
gradient within 1e-5 absolute (both sides sum in fp32, in different
orders; the gradients are of order 1e-2 to 1).
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from tpucfn.data.packing import pack_sequences as jax_pack_sequences
from tpucfn.data.packing import packed_causal_lm_loss as jax_packed_loss
from tpucfn.models.llama import Llama as JaxLlama
from tpucfn.models.llama import LlamaConfig as JaxConfig
from tpucfn.models.llama import causal_lm_loss as jax_causal_lm_loss
from tpucfn.models.llama import chunked_causal_lm_loss as jax_chunked_loss
from tpucfn_torch.data import synthetic_tokens
from tpucfn_torch.models.convert import llama_state_dict_from_jax
from tpucfn_torch.models.llama import Llama, LlamaConfig
from tpucfn_torch.train import (Trainer, TrainerConfig, adamw, chain,
                                clip_by_global_norm, llama_train_fns,
                                warmup_cosine_decay_schedule)

ATOL = 1e-5
GOLDEN = json.loads((Path(__file__).parent / "golden_curves.json").read_text())
GOLDEN_RTOL = 2e-4  # tests/test_golden_curves.py's RTOL

torch.set_num_threads(1)


def _configs(**port_kw):
    return JaxConfig.tiny(), dataclasses.replace(
        LlamaConfig.tiny(), param_dtype=torch.float32, **port_kw)


@pytest.fixture(scope="module")
def carried():
    jcfg, pcfg = _configs()
    params = jax.jit(JaxLlama(jcfg).init)(
        jax.random.key(2), jnp.zeros((1, 8), jnp.int32))["params"]
    sd = llama_state_dict_from_jax(jax.tree.map(np.asarray, params), pcfg)
    return jcfg, pcfg, params, sd


def _tokens(b=2, s=24, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (b, s)).astype(np.int32)


def _port_loss_and_grads(pcfg, sd, batch, **fns_kw):
    params = {k: nn.Parameter(v.clone()) for k, v in sd.items()}
    _, loss_fn = llama_train_fns(pcfg, **fns_kw)
    loss, (aux, _) = loss_fn(params, {}, {k: torch.from_numpy(v)
                                          for k, v in batch.items()}, None)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss, aux, dict(zip(params, grads))


def _jax_loss_and_grads(jcfg, pcfg, params, loss):
    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return float(value), llama_state_dict_from_jax(
        jax.tree.map(np.asarray, grads), pcfg)


def _assert_grads_close(port, ref, atol=ATOL):
    assert set(port) == set(ref)
    for name in ref:
        np.testing.assert_allclose(port[name].numpy(), ref[name].numpy(),
                                   atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_dense_loss_and_every_grad_match_jax(carried, z_loss):
    jcfg, pcfg, params, sd = carried
    tokens = _tokens()
    loss, aux, grads = _port_loss_and_grads(
        pcfg, sd, {"tokens": tokens}, chunk_size=None, z_loss=z_loss)

    def jloss(p):
        logits = JaxLlama(jcfg).apply({"params": p}, jnp.asarray(tokens))
        return jax_causal_lm_loss(logits, jnp.asarray(tokens),
                                  z_loss=z_loss)[0]

    ref_loss, ref_grads = _jax_loss_and_grads(jcfg, pcfg, params, jloss)
    assert abs(loss.item() - ref_loss) <= ATOL
    _assert_grads_close(grads, ref_grads)
    assert 0.0 <= aux["accuracy"].item() <= 1.0


def test_chunked_loss_matches_jax_and_the_plain_loss(carried):
    jcfg, pcfg, params, sd = carried
    tokens = _tokens(s=29, seed=1)  # 28 predictions: a short last chunk
    loss, _, grads = _port_loss_and_grads(
        pcfg, sd, {"tokens": tokens}, chunk_size=8, z_loss=1e-4)

    def jloss(p):
        hidden = JaxLlama(jcfg).apply({"params": p}, jnp.asarray(tokens),
                                      return_hidden=True)
        return jax_chunked_loss(hidden, p["lm_head"]["kernel"],
                                jnp.asarray(tokens), chunk_size=8,
                                z_loss=1e-4)[0]

    ref_loss, ref_grads = _jax_loss_and_grads(jcfg, pcfg, params, jloss)
    assert abs(loss.item() - ref_loss) <= ATOL
    _assert_grads_close(grads, ref_grads)
    plain_loss, _, plain_grads = _port_loss_and_grads(
        pcfg, sd, {"tokens": tokens}, chunk_size=None, z_loss=1e-4)
    assert abs(loss.item() - plain_loss.item()) <= ATOL
    _assert_grads_close(grads, plain_grads)


def test_packed_path_matches_jax(carried):
    """Packed rows: the loss over valid positions and every gradient (the
    CPU path masks with same & valid, as the JAX package off a TPU)."""
    jcfg, pcfg, params, sd = carried
    rs = np.random.RandomState(3)
    docs = [rs.randint(1, 256, n).astype(np.int32) for n in (9, 5, 14, 3, 7)]
    tokens, segments = jax_pack_sequences(docs, 20)
    loss, _, grads = _port_loss_and_grads(
        pcfg, sd, {"tokens": tokens, "segments": segments})

    def jloss(p):
        logits = JaxLlama(jcfg).apply({"params": p}, jnp.asarray(tokens),
                                      segment_ids=jnp.asarray(segments))
        return jax_packed_loss(logits, jnp.asarray(tokens),
                               jnp.asarray(segments))[0]

    ref_loss, ref_grads = _jax_loss_and_grads(jcfg, pcfg, params, jloss)
    assert abs(loss.item() - ref_loss) <= ATOL
    _assert_grads_close(grads, ref_grads)

    valid = segments > 0
    model = Llama.from_state_dict(pcfg, sd)
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens),
                       segment_ids=torch.from_numpy(segments)).numpy()
    ref = JaxLlama(jcfg).apply({"params": params}, jnp.asarray(tokens),
                               segment_ids=jnp.asarray(segments))
    np.testing.assert_allclose(logits[valid], np.asarray(ref)[valid],
                               atol=1e-4, rtol=0)


def test_remat_grads_equal_no_remat(carried):
    _, pcfg, _, sd = carried
    batch = {"tokens": _tokens(seed=4)}
    got = [_port_loss_and_grads(dataclasses.replace(pcfg, remat=remat), sd,
                                batch, chunk_size=8)
           for remat in (True, False)]
    assert got[0][0].item() == got[1][0].item()
    for name in got[0][2]:
        torch.testing.assert_close(got[0][2][name], got[1][2][name],
                                   atol=0, rtol=0)


def test_remat_policies():
    assert LlamaConfig(remat="full").remat == "full"
    LlamaConfig(remat="none")
    for policy in ("dots", "dots_no_batch"):
        with pytest.raises(NotImplementedError, match="not ported"):
            LlamaConfig(remat=policy)
    with pytest.raises(ValueError):
        LlamaConfig(remat="sometimes")


def test_segment_ids_refusals(carried):
    _, pcfg, _, sd = carried
    tokens = torch.from_numpy(_tokens())
    seg = torch.ones_like(tokens)
    with pytest.raises(ValueError, match="q_offset"):
        Llama.from_state_dict(pcfg, sd)(tokens, q_offset=4, segment_ids=seg)
    decode = Llama.from_state_dict(pcfg, sd, decode=True)
    with pytest.raises(ValueError, match="decode"):
        decode(tokens, cache=decode.init_cache(2, 32), segment_ids=seg)


def test_storage_dtypes():
    """Training stores fp32 master weights; serving (param_dtype None)
    keeps storing the compute dtype, so its numbers do not move."""
    with torch.device("meta"):
        serve = Llama(LlamaConfig.llama3_1b()).state_dict()
        train = Llama(dataclasses.replace(
            LlamaConfig.llama3_1b(), param_dtype=torch.float32)).state_dict()
    assert serve["layers.0.attn.q_proj.weight"].dtype == torch.bfloat16
    assert serve["embed_tokens.weight"].dtype == torch.bfloat16
    assert {t.dtype for t in train.values()} == {torch.float32}
    assert serve["lm_head.weight"].dtype == torch.float32
    assert serve["layers.0.input_norm.scale"].dtype == torch.float32


def test_trainable_model_shares_the_callers_parameters(carried):
    _, pcfg, _, sd = carried
    params = {k: nn.Parameter(v.clone()) for k, v in sd.items()}
    model = Llama.from_state_dict(pcfg, params, trainable=True)
    assert model.layers[1].mlp.up_proj.weight is params[
        "layers.1.mlp.up_proj.weight"]
    assert all(p.requires_grad for p in model.parameters())
    frozen = Llama.from_state_dict(pcfg, sd)
    assert not any(p.requires_grad for p in frozen.parameters())


# ---- the optimizer chain against optax -------------------------------------


def _tree(rs, scale=1.0):
    return {"w": (rs.randn(6, 5) * scale).astype(np.float32),
            "b": (rs.randn(7) * scale).astype(np.float32)}


def test_schedule_matches_optax():
    ours = warmup_cosine_decay_schedule(0.0, 3e-4, 10, 100, end_value=1e-5)
    ref = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 10, 100,
                                             end_value=1e-5)
    for count in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        assert ours(count) == pytest.approx(float(ref(count)), rel=1e-6,
                                            abs=1e-12)
    assert ours(0) == 0.0  # the first update runs at init_value


@pytest.mark.parametrize("scale", [0.01, 10.0])  # below and above max_norm
def test_clip_by_global_norm_matches_optax(scale):
    grads = _tree(np.random.RandomState(0), scale)
    ref, _ = optax.clip_by_global_norm(1.0).update(
        jax.tree.map(jnp.asarray, grads), optax.EmptyState())
    ours = clip_by_global_norm(1.0).update(
        {k: torch.from_numpy(v.copy()) for k, v in grads.items()}, (), None)
    for k in grads:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-7)


def test_example_chain_matches_optax():
    """clip 1.0 -> AdamW(b2 0.95, wd 0.1) on a warmup-cosine schedule, the
    example's chain, over steps whose grads cross the clip threshold."""
    rs = np.random.RandomState(1)
    params = _tree(rs)
    grads = [_tree(rs, scale) for scale in (0.05, 3.0, 0.2, 5.0, 0.01)]
    sched = dict(init_value=0.0, peak_value=3e-2, warmup_steps=2,
                 decay_steps=5)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        optax.warmup_cosine_decay_schedule(**sched), b1=0.9, b2=0.95,
        weight_decay=0.1))
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)

    ours = chain(clip_by_global_norm(1.0), adamw(
        warmup_cosine_decay_schedule(**sched), b1=0.9, b2=0.95,
        weight_decay=0.1))
    tp = {k: nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    ostate = ours.init(tp)
    for g in grads:
        assert ours.update({k: torch.from_numpy(v.copy()) for k, v in g.items()},
                           ostate, tp) is None
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-6)


def test_adamw_defaults_are_optax():
    opt = adamw(1e-3).init({"w": nn.Parameter(torch.zeros(3))})["optimizer"]
    group = opt.param_groups[0]
    assert (group["betas"], group["eps"], group["weight_decay"]) == (
        (0.9, 0.999), 1e-8, 1e-4)


# ---- the trainer -------------------------------------------------------------


def _tiny_trainer(init_fn, config=TrainerConfig(), tx=None, **fns_kw):
    _, pcfg = _configs()
    _, loss_fn = llama_train_fns(pcfg, chunk_size=None, **fns_kw)
    return Trainer(None, None, loss_fn, tx or adamw(1e-3), init_fn, config,
                   device="cpu")


def test_golden_tiny_llama_curve():
    """tests/test_golden_curves.py's tiny_llama setup — adamw(1e-3),
    synthetic_tokens(64, seq_len=32), batches of 16, 50 steps, the loss
    every 2nd step — through the port's Trainer, starting from the JAX
    Trainer's own init params (the key(0) split of ``_create_state``)."""
    jcfg, pcfg = _configs()
    params_rng, _ = jax.random.split(jax.random.key(0))
    params = jax.jit(JaxLlama(jcfg).init)(
        params_rng, jnp.zeros((8, 32), jnp.int32))["params"]
    sd = llama_state_dict_from_jax(jax.tree.map(np.asarray, params), pcfg)
    trainer = _tiny_trainer(lambda gen: (sd, {}))
    state = trainer.init(0)
    items = [it["tokens"] for it in synthetic_tokens(
        64, seq_len=32, vocab=pcfg.vocab_size, seed=0)]
    batches = [{"tokens": np.stack(items[16 * j:16 * j + 16])}
               for j in range(4)]
    curve = []
    for i in range(50):
        state, m = trainer.step(state, batches[i % 4])
        if (i + 1) % 2 == 0:
            curve.append(round(m["loss"].item(), 6))
    np.testing.assert_allclose(curve, GOLDEN["tiny_llama"], rtol=GOLDEN_RTOL)


def _init_from(sd):
    return lambda gen: ({k: v.clone() for k, v in sd.items()}, {})


def test_grad_accum_averages_microbatches(carried):
    _, _, _, sd = carried
    batch = {"tokens": torch.from_numpy(_tokens(b=4, seed=6))}
    results = []
    for accum in (1, 2):
        trainer = _tiny_trainer(_init_from(sd), TrainerConfig(grad_accum=accum))
        state = trainer.init(0)
        results.append(trainer._grads(state, batch))
    (l1, a1, _, g1), (l2, a2, _, g2) = results
    assert abs(l1.item() - l2.item()) <= ATOL
    assert abs(a1["accuracy"].item() - a2["accuracy"].item()) <= ATOL
    _assert_grads_close(g2, g1)
    trainer = _tiny_trainer(_init_from(sd), TrainerConfig(grad_accum=3))
    with pytest.raises(ValueError, match="grad_accum"):
        trainer.step(trainer.init(0), batch)


def test_ema_is_post_update(carried):
    _, _, _, sd = carried
    trainer = _tiny_trainer(_init_from(sd), TrainerConfig(ema_decay=0.9))
    state = trainer.init(0)
    before = {k: p.detach().clone() for k, p in state.params.items()}
    state, _ = trainer.step(state, {"tokens": _tokens(seed=7)})
    assert state.step == 1
    for k, p in state.params.items():
        assert not torch.equal(p, before[k]) or k.endswith("scale")
        torch.testing.assert_close(state.model_state["ema"][k],
                                   before[k] * 0.9 + p.detach() * 0.1,
                                   atol=1e-7, rtol=1e-6)


def test_eval_step_does_not_update(carried):
    _, _, _, sd = carried
    trainer = _tiny_trainer(_init_from(sd))
    state = trainer.init(0)
    batch = {"tokens": _tokens(seed=8)}
    first = trainer.eval_step(state, batch)
    assert trainer.eval_step(state, batch)["loss"].item() == first["loss"].item()
    assert set(first) == {"loss", "accuracy"}


def test_trainer_refusals(carried):
    _, pcfg, _, sd = carried
    init_fn, loss_fn = llama_train_fns(pcfg)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(None, None, loss_fn, adamw(1e-3), init_fn)
    with pytest.raises(NotImplementedError, match="mesh"):
        Trainer(object(), None, loss_fn, adamw(1e-3), init_fn, device="cpu")
    trainer = Trainer(None, None, loss_fn, clip_by_global_norm(1.0),
                      _init_from(sd), device="cpu")
    with pytest.raises(ValueError, match="optimizer"):
        trainer.step(trainer.init(0), {"tokens": _tokens()})
