"""The port's ring attention and Ulysses (``tpucfn_torch.kernels``) over 4
context ranks (gloo) against the JAX package's on ``mesh_ctx4``
(``MeshSpec(data=2, context=4)`` on the fake CPU devices), on the same
numpy inputs: the twelve cases of ``tests/test_ring_attention.py``.

* Ring, dense hops: causal, GQA, non-causal, gradients.
* Ring, flash hops (the port's ``flash_attention_with_lse``, whose CPU
  path is its plain version, against the JAX kernel in interpret mode):
  match, GQA, gradients through dLSE.
* Ulysses: match, indivisible heads refused with the same text, a flash
  inner.
* The Llama with each SP mode: JAX's initial params carried across, the
  loss after three AdamW steps (each step's loss, in fact) equal to the
  JAX Trainer's.

Each rank returns its block of the output (and of dQ, dK, dV); the
blocks, concatenated in rank order, are held against JAX's global
arrays: outputs within 2e-5 and gradients within 1e-4 (flash hops'
3e-4), the reference tests' own tolerances against dense attention;
losses within 1e-5 relative.  Beside them, the hops the ring launches,
counted at the K1 wrapper (``flash_fwd``) and at the backward's
(``flash_bwd``): rank r of a causal ring runs r + 1 hops (its diagonal
and its r past blocks; future blocks launch nothing), W(W+1)/2 = 10 over
the ring, and a non-causal ring W each, W^2 = 16.
"""

import dataclasses
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from test_torch_rank_pool import RankPool
from tpucfn.kernels import make_ring_attention, make_ulysses_attention
from tpucfn.kernels.flash_attention import flash_attention
from tpucfn.mesh import MeshSpec, build_mesh
from tpucfn.models.llama import Llama, LlamaConfig, causal_lm_loss, \
    sharding_rules
from tpucfn.ops.attention import dot_product_attention
from tpucfn.parallel import shard_batch
from tpucfn.train import Trainer, TrainerConfig

W = 4
OUT_TOL = 2e-5
GRAD_TOL = 1e-4
FLASH_GRAD_TOL = 3e-4
LOSS_RTOL = 1e-5

CASES = textwrap.dedent("""
    import dataclasses
    import numpy as np
    import torch
    from tpucfn_torch.kernels import (flash_attention as fa,
                                      make_ring_attention,
                                      make_ulysses_attention)
    from tpucfn_torch.mesh import MeshSpec, build_mesh

    MESH = {}

    def mesh(world):
        if not MESH:
            MESH["m"] = build_mesh(MeshSpec(context=world), device_type="cpu")
        return MESH["m"]

    def block(x, rank, world):
        s = x.shape[1] // world
        return torch.from_numpy(x[:, rank * s:(rank + 1) * s]).clone()

    def attention(kind, m):
        if kind == "ring_dense":
            return make_ring_attention(m, heads_axis=None,
                                       hop_attention="dense")
        if kind == "ring_flash":
            return make_ring_attention(m, heads_axis=None,
                                       hop_attention="flash")
        if kind == "ulysses":
            return make_ulysses_attention(m, heads_axis=None)
        return make_ulysses_attention(m, heads_axis=None,
                                      inner=fa.flash_attention)

    def attend(rank, world, inputs):
        fn = attention(str(inputs["kind"]), mesh(world))
        grad = bool(inputs["grad"])
        q, k, v = (block(inputs[n], rank, world).requires_grad_(grad)
                   for n in "qkv")
        try:
            out = fn(q, k, v, causal=bool(inputs["causal"]))
        except ValueError as e:
            return {"error": np.array(str(e))}
        res = {"out": out.detach().numpy()}
        if grad:
            (out ** 2).sum().backward()
            res.update(dq=q.grad.numpy(), dk=k.grad.numpy(),
                       dv=v.grad.numpy())
        return res

    def hops(rank, world, inputs):
        calls = {"fwd": 0, "bwd": 0}
        real = fa.flash_fwd, fa.flash_bwd

        def fwd(*a, **k):
            calls["fwd"] += 1
            return real[0](*a, **k)

        def bwd(*a, **k):
            calls["bwd"] += 1
            return real[1](*a, **k)

        fa.flash_fwd, fa.flash_bwd = fwd, bwd
        try:
            res = attend(rank, world, inputs)
        finally:
            fa.flash_fwd, fa.flash_bwd = real
        return {"fwd": np.array(calls["fwd"]), "bwd": np.array(calls["bwd"]),
                **res}

    def llama(rank, world, inputs):
        from tpucfn_torch.models.llama import (LlamaConfig,
                                               causal_lm_loss_weight,
                                               sharding_rules)
        from tpucfn_torch.parallel import shard_batch
        from tpucfn_torch.train import (Trainer, TrainerConfig, adamw,
                                        llama_train_fns)

        m = mesh(world)
        cfg = dataclasses.replace(
            LlamaConfig.tiny(), param_dtype=torch.float32,
            n_heads=int(inputs["n_heads"]),
            n_kv_heads=int(inputs["n_kv_heads"]))
        params = {k[2:]: torch.from_numpy(v) for k, v in inputs.items()
                  if k.startswith("p/")}
        _, loss_fn = llama_train_fns(
            cfg, attention_fn=attention(str(inputs["kind"]), m),
            chunk_size=None, context_mesh=m)
        trainer = Trainer(m, sharding_rules(cfg, tensor=False), loss_fn,
                          adamw(3e-3), lambda g: (dict(params), {}),
                          config=TrainerConfig(batch_extra_axes=("context",)),
                          loss_weight=causal_lm_loss_weight(m))
        state = trainer.init(0)
        batch = shard_batch(m, {"tokens": inputs["tokens"]}, ("context",))
        losses = []
        for _ in range(3):
            state, metrics = trainer.step(state, batch)
            losses.append(metrics["loss"].item())
        return {"losses": np.array(losses)}
""")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    with RankPool(W, CASES, tmp_path_factory.mktemp("ring")) as pool:
        yield pool


@pytest.fixture(scope="module")
def mesh_ctx4():
    return build_mesh(MeshSpec(data=2, context=4))


def _qkv(b=2, s=32, h=4, hkv=4, d=16, seed=0):
    rng = jax.random.key(seed)
    q = jax.random.normal(jax.random.fold_in(rng, 0), (b, s, h, d))
    k = jax.random.normal(jax.random.fold_in(rng, 1), (b, s, hkv, d))
    v = jax.random.normal(jax.random.fold_in(rng, 2), (b, s, hkv, d))
    return q, k, v


def _port(ranks, kind, q, k, v, *, causal=True, grad=False, case="attend"):
    got = ranks.run(case, kind=kind, causal=causal, grad=grad,
                    q=np.asarray(q), k=np.asarray(k), v=np.asarray(v))
    keys = ("out", "dq", "dk", "dv") if grad else ("out",)
    return got, [np.concatenate([g[key] for g in got], axis=1)
                 for key in keys]


def _jax(fn, q, k, v, *, causal=True, grad=False):
    out = jax.jit(lambda q, k, v: fn(q, k, v, causal=causal))(q, k, v)
    if not grad:
        return [out]
    grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(
        fn(q, k, v, causal=causal) ** 2), (0, 1, 2)))(q, k, v)
    return [out, *grads]


def _assert_close(got, ref, grad_tol=GRAD_TOL):
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                   atol=OUT_TOL if name == "out" else
                                   grad_tol, err_msg=name)


@pytest.mark.parametrize("case,qkv_kw,causal", [
    ("ring_matches_full", {}, True),
    ("ring_gqa", dict(h=8, hkv=2), True),
    ("ring_non_causal", {}, False)])
def test_ring_dense_hops(ranks, mesh_ctx4, case, qkv_kw, causal):
    q, k, v = _qkv(**qkv_kw)
    ring = make_ring_attention(mesh_ctx4, heads_axis=None)
    _, got = _port(ranks, "ring_dense", q, k, v, causal=causal)
    _assert_close(got, _jax(ring, q, k, v, causal=causal))


def test_ring_gradients_match(ranks, mesh_ctx4):
    q, k, v = _qkv(s=16)
    ring = make_ring_attention(mesh_ctx4, heads_axis=None)
    _, got = _port(ranks, "ring_dense", q, k, v, grad=True)
    _assert_close(got, _jax(ring, q, k, v, grad=True))


@pytest.mark.parametrize("qkv_kw", [dict(s=64), dict(s=64, h=8, hkv=2)],
                         ids=["match_full", "gqa"])
def test_ring_flash_hops(ranks, mesh_ctx4, qkv_kw):
    q, k, v = _qkv(**qkv_kw)
    ring = make_ring_attention(mesh_ctx4, heads_axis=None,
                               hop_attention="flash")
    _, got = _port(ranks, "ring_flash", q, k, v)
    _assert_close(got, _jax(ring, q, k, v))


def test_ring_flash_hops_gradients(ranks, mesh_ctx4):
    """The dLSE path: each hop's LSE feeds the merge, so the gradients
    flow through both outputs of every hop."""
    q, k, v = _qkv(s=64, d=16)
    ring = make_ring_attention(mesh_ctx4, heads_axis=None,
                               hop_attention="flash")
    _, got = _port(ranks, "ring_flash", q, k, v, grad=True)
    _assert_close(got, _jax(ring, q, k, v, grad=True),
                  grad_tol=FLASH_GRAD_TOL)


def test_ulysses_matches_full(ranks, mesh_ctx4):
    q, k, v = _qkv(h=8, hkv=4)
    ul = make_ulysses_attention(mesh_ctx4, heads_axis=None)
    _, got = _port(ranks, "ulysses", q, k, v)
    _assert_close(got, _jax(ul, q, k, v))


def test_ulysses_rejects_indivisible_heads(ranks, mesh_ctx4):
    q, k, v = _qkv(h=8, hkv=2)
    ul = make_ulysses_attention(mesh_ctx4, heads_axis=None)
    with pytest.raises(ValueError, match="not divisible") as e:
        ul(q, k, v, causal=True)
    got = ranks.run("attend", kind="ulysses", causal=True, grad=False,
                    q=np.asarray(q), k=np.asarray(k), v=np.asarray(v))
    assert {str(g["error"]) for g in got} == {str(e.value)}


def test_ulysses_flash_inner(ranks, mesh_ctx4):
    q, k, v = _qkv(s=64, h=8, hkv=8)
    ul = make_ulysses_attention(mesh_ctx4, heads_axis=None,
                                inner=flash_attention)
    _, got = _port(ranks, "ulysses_flash", q, k, v)
    _assert_close(got, _jax(ul, q, k, v))


@pytest.mark.parametrize("causal,per_rank", [
    (True, [1, 2, 3, 4]), (False, [W] * W)], ids=["causal", "non_causal"])
def test_ring_hop_launches(ranks, causal, per_rank):
    q, k, v = _qkv(s=32, h=8, hkv=2)
    got, outs = _port(ranks, "ring_flash", q, k, v, causal=causal,
                      grad=True, case="hops")
    assert [int(g["fwd"]) for g in got] == per_rank
    assert [int(g["bwd"]) for g in got] == per_rank
    assert sum(per_rank) == (W * (W + 1) // 2 if causal else W * W)
    ref = dot_product_attention(q, k, v, causal=causal)
    np.testing.assert_allclose(outs[0], np.asarray(ref), atol=OUT_TOL)


def _jax_sp_losses(mesh, attention_fn, cfg, tokens):
    """The reference test's ``_sp_trainer``, three steps; returns each
    step's loss and the initial params."""
    model = Llama(cfg, attention_fn=attention_fn)
    sample = jnp.zeros((2, 32), jnp.int32)

    def init_fn(rng):
        return model.init(rng, sample)["params"], {}

    def loss_fn(params, mstate, batch, rng):
        logits = model.apply({"params": params}, batch["tokens"])
        loss, acc = causal_lm_loss(logits, batch["tokens"])
        return loss, ({"accuracy": acc}, mstate)

    trainer = Trainer(mesh, sharding_rules(cfg, tensor=False), loss_fn,
                      optax.adamw(3e-3), init_fn,
                      config=TrainerConfig(batch_extra_axes=("context",)))
    state = trainer.init(jax.random.key(0))
    params = jax.tree.map(np.asarray, state.params)
    batch = shard_batch(mesh, {"tokens": tokens}, extra_axes=("context",))
    losses = []
    for _ in range(3):
        state, m = trainer.step(state, batch)
        losses.append(float(m["loss"]))
    return np.array(losses), params


@pytest.mark.parametrize("kind,heads", [("ring_dense", (4, 4)),
                                        ("ulysses", (4, 4))],
                         ids=["ring_attention", "ulysses"])
def test_llama_sp_end_to_end(ranks, mesh_ctx4, kind, heads):
    """Llama with sequence-sharded inputs under each SP mode, JAX's init
    carried across: the loss of each of three AdamW steps equals the JAX
    Trainer's (the reference's ring run; its Ulysses run only checks
    that the loss falls)."""
    import torch

    from tpucfn_torch.models.convert import llama_state_dict_from_jax
    from tpucfn_torch.models.llama import LlamaConfig as PortConfig

    n_heads, n_kv_heads = heads
    cfg = dataclasses.replace(LlamaConfig.tiny(), n_heads=n_heads,
                              n_kv_heads=n_kv_heads)
    tokens = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (4, 32)).astype(np.int32)
    jfn = (make_ring_attention(mesh_ctx4, heads_axis=None)
           if kind == "ring_dense"
           else make_ulysses_attention(mesh_ctx4, heads_axis=None))
    ref, params = _jax_sp_losses(mesh_ctx4, jfn, cfg, tokens)
    pcfg = dataclasses.replace(PortConfig.tiny(), param_dtype=torch.float32,
                               n_heads=n_heads, n_kv_heads=n_kv_heads)
    sd = llama_state_dict_from_jax(params, pcfg)
    got = ranks.run("llama", kind=kind, n_heads=n_heads,
                    n_kv_heads=n_kv_heads, tokens=tokens,
                    **{f"p/{k}": v.numpy() for k, v in sd.items()})
    for g in got:  # every rank reports the global loss
        np.testing.assert_allclose(g["losses"], ref, rtol=LOSS_RTOL)
    assert ref[-1] < ref[0]
