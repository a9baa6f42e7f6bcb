"""The port's flash-attention backward against the JAX package's, on the
CPU.

* the autograd Functions behind ``flash_attention`` and
  ``flash_attention_with_lse`` (on CPU tensors: the plain forward and the
  plain backward) against ``jax.grad`` of the JAX package's
  ``flash_attention``/``flash_attention_with_lse`` run in Pallas interpret
  mode, which runs the K2/K3 kernels' own code: GQA, segment ids, odd
  lengths, offsets, empty rows and a nonzero dLSE;
* the backward wrappers (Delta, K2, K3) on CPU tensors take the plain
  backward and count no launch;
* the fault the Functions repair: a forward whose outputs are filled
  outside autograd (as ``flash_fwd`` fills them on the card) leaves q, k
  and v without a gradient, and raises nothing.

Inputs are made with numpy from a seed and handed to both sides.
Tolerance: fp32 throughout, 1e-5 absolute (both sides sum in fp32, in
different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucfn.kernels.flash_attention import flash_attention as jax_flash
from tpucfn.kernels.flash_attention import \
    flash_attention_with_lse as jax_flash_lse
from tpucfn_torch.kernels import flash_attention as fa
from tpucfn_torch.ops.attention import NEG_INF

ATOL = 1e-5

# The suite runs several pytest workers side by side on the CPU; torch's
# intra-op pool would otherwise claim every core in each of them.
torch.set_num_threads(1)


def _arrays(b=2, sq=16, sk=16, hq=4, hkv=4, d=16, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for shape in (
        (b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d), (b, sq, hq, d))]


def _leaves(*arrays):
    return [torch.from_numpy(a).requires_grad_() for a in arrays]


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port.detach()), np.asarray(ref),
                               atol=ATOL, rtol=0)


def _jax_grads(fn, q, k, v, w):
    """d/d(q, k, v) of sum(fn(q, k, v) * w) through the JAX kernels."""
    loss = lambda q, k, v: jnp.sum(fn(q, k, v) * w)  # noqa: E731
    return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


@pytest.mark.parametrize("causal,rep,sq,sk,q_offset,k_offset", [
    (True, 1, 16, 16, 0, 0),     # MHA, the training shape in small
    (True, 2, 13, 13, 0, 0),     # GQA, odd length
    (False, 4, 12, 20, 0, 0),    # non-causal, Sq != Sk
    (True, 2, 7, 29, 22, 0),     # a later query chunk (ring-hop offsets)
    (True, 1, 24, 40, 16, 8),
    (True, 2, 16, 16, 0, 6)])    # k_offset > 0: the first rows are empty
def test_flash_attention_grads_match_jax(causal, rep, sq, sk, q_offset,
                                         k_offset):
    q, k, v, w = _arrays(sq=sq, sk=sk, hq=4, hkv=4 // rep)
    tq, tk, tv = _leaves(q, k, v)
    out = fa.flash_attention(tq, tk, tv, causal=causal, q_offset=q_offset,
                             k_offset=k_offset)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                (tq, tk, tv))
    ref = _jax_grads(lambda q, k, v: jax_flash(
        q, k, v, causal=causal, q_offset=q_offset, k_offset=k_offset,
        block_q=8, block_k=8, interpret=True), q, k, v, w)
    for g, r in zip(grads, ref):
        assert torch.isfinite(g).all()
        _close(g, r)


def test_flash_attention_segment_grads_match_jax():
    q, k, v, w = _arrays(sq=24, sk=24, hq=4, hkv=2, seed=1)
    seg = np.repeat(np.array([[0, 1, 2], [0, 0, 1]]), 8, axis=1).astype(np.int32)
    tq, tk, tv = _leaves(q, k, v)
    out = fa.flash_attention(tq, tk, tv, segment_ids=torch.from_numpy(seg))
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                (tq, tk, tv))
    ref = _jax_grads(lambda q, k, v: jax_flash(
        q, k, v, segment_ids=jnp.asarray(seg), block_q=8, block_k=8,
        interpret=True), q, k, v, w)
    for g, r in zip(grads, ref):
        _close(g, r)


@pytest.mark.parametrize("rep,sq,sk,q_offset", [(1, 16, 16, 0),
                                                (2, 9, 21, 12)])
def test_flash_with_lse_grads_carry_dlse(rep, sq, sk, q_offset):
    """Both outputs consumed: dLSE feeds dS (the ring-hop merge path)."""
    q, k, v, w = _arrays(sq=sq, sk=sk, hq=4, hkv=4 // rep, seed=2)
    w_lse = np.random.RandomState(3).randn(2, sq, 4).astype(np.float32)
    tq, tk, tv = _leaves(q, k, v)
    o, lse = fa.flash_attention_with_lse(tq, tk, tv, q_offset=q_offset)
    loss = (o * torch.from_numpy(w)).sum() + (lse * torch.from_numpy(w_lse)).sum()
    grads = torch.autograd.grad(loss, (tq, tk, tv))

    def jloss(q, k, v):
        jo, jl = jax_flash_lse(q, k, v, q_offset=q_offset, block_q=8,
                               block_k=8, interpret=True)
        return jnp.sum(jo * w) + jnp.sum(jl * w_lse)

    ref = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for g, r in zip(grads, ref):
        _close(g, r)


@pytest.mark.parametrize("with_dlse", [False, True])
def test_gqa3_grads_match_jax(with_dlse):
    """A GQA group of 3 (H=6, Hkv=2): K2's and K3's mma variants in
    either dtype; with LSE consumed too, dLSE feeds dS."""
    q, k, v, w = _arrays(sq=12, sk=20, hq=6, hkv=2, seed=6)
    w_lse = np.random.RandomState(7).randn(2, 12, 6).astype(np.float32)
    assert (fa.dkv_variant(torch.bfloat16, 6, 2),
            fa.dq_variant(torch.bfloat16, 6, 2)) == ("mma", "mma")
    tq, tk, tv = _leaves(q, k, v)
    o, lse = fa.flash_attention_with_lse(tq, tk, tv, q_offset=8)
    loss = (o * torch.from_numpy(w)).sum()
    if with_dlse:
        loss = loss + (lse * torch.from_numpy(w_lse)).sum()
    grads = torch.autograd.grad(loss, (tq, tk, tv))

    def jloss(q, k, v):
        jo, jl = jax_flash_lse(q, k, v, q_offset=8, block_q=8, block_k=8,
                               interpret=True)
        return jnp.sum(jo * w) + (jnp.sum(jl * w_lse) if with_dlse else 0.0)

    ref = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for g, r in zip(grads, ref):
        assert torch.isfinite(g).all()
        _close(g, r)


@pytest.mark.parametrize("sq,sk", [(8, 256), (5, 200), (12, 136)])
def test_long_keys_with_dlse_grads_match_jax(sq, sk):
    """Few rows (GQA 4) over many keys, some ragged, non-causal, both
    outputs consumed, in fp32 (K2's and K3's mma variants on the card):
    ``chip_smoke.py``'s ``fp32_long_keys_dlse`` holds the kernels against
    this plain path."""
    q, k, v, w = _arrays(sq=sq, sk=sk, hq=8, hkv=2, seed=10)
    w_lse = np.random.RandomState(11).randn(2, sq, 8).astype(np.float32)
    assert fa.dq_variant(torch.float32, 8, 2) == "mma"
    tq, tk, tv = _leaves(q, k, v)
    o, lse = fa.flash_attention_with_lse(tq, tk, tv, causal=False)
    loss = (o * torch.from_numpy(w)).sum() + (lse * torch.from_numpy(w_lse)).sum()
    grads = torch.autograd.grad(loss, (tq, tk, tv))

    def jloss(q, k, v):
        jo, jl = jax_flash_lse(q, k, v, causal=False, block_q=32,
                               block_k=128, interpret=True)
        return jnp.sum(jo * w) + jnp.sum(jl * w_lse)

    ref = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for g, r in zip(grads, ref):
        assert torch.isfinite(g).all()
        _close(g, r)


def test_flash_with_lse_grad_of_lse_alone():
    """Only LSE consumed: the O cotangent is absent, not a NaN source."""
    q, k, v, _ = _arrays(seed=4)
    tq, tk, tv = _leaves(q, k, v)
    _, lse = fa.flash_attention_with_lse(tq, tk, tv)
    grads = torch.autograd.grad(lse.sum(), (tq, tk, tv))
    ref = jax.jit(jax.grad(lambda q, k, v: jnp.sum(jax_flash_lse(
        q, k, v, block_q=8, block_k=8, interpret=True)[1]),
        argnums=(0, 1, 2)))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for g, r in zip(grads, ref):
        _close(g, r)


def test_empty_rows_give_zero_grads_not_nan():
    """k_offset past every query: every row is empty, LSE = NEG_INF, and
    the backward's P must be 0 exactly: zero gradients, no NaN."""
    q, k, v, w = _arrays(seed=5)
    tq, tk, tv = _leaves(q, k, v)
    o, lse = fa.flash_attention_with_lse(tq, tk, tv, k_offset=1000)
    assert (lse == NEG_INF).all()
    grads = torch.autograd.grad((o * torch.from_numpy(w)).sum(), (tq, tk, tv))
    for g in grads:
        assert torch.isfinite(g).all() and (g == 0).all()


def test_bypassing_autograd_leaves_q_without_grad():
    """The fault the Functions repair.  A forward whose output is
    allocated with torch.empty and filled outside autograd (what
    ``flash_fwd`` does for CUDA tensors) cuts q, k and v out of the graph:
    the loss still backpropagates into the weights after attention, and
    q gets no gradient at all.  Through ``flash_attention`` they get
    ``jax.grad``'s."""
    q, k, v, w = _arrays(seed=6)

    def bypass(q, k, v):
        o = torch.empty_like(q)
        with torch.no_grad():
            o.copy_(fa.flash_fwd(q, k, v)[0])
        return o

    x, tk, tv = _leaves(q, k, v)
    proj = torch.from_numpy(w).requires_grad_()
    (bypass(x * 1.0, tk, tv) * proj).sum().backward()
    assert proj.grad is not None
    assert x.grad is None and tk.grad is None and tv.grad is None

    x, tk, tv = _leaves(q, k, v)
    proj = torch.from_numpy(w).requires_grad_()
    (fa.flash_attention(x * 1.0, tk, tv) * proj).sum().backward()
    ref = _jax_grads(lambda q, k, v: jax_flash(q, k, v, block_q=8, block_k=8,
                                               interpret=True), q, k, v, w)
    for g, r in zip((x.grad, tk.grad, tv.grad), ref):
        _close(g, r)


def test_backward_wrappers_take_the_plain_backward_on_cpu():
    """Delta, K2 and K3's wrappers on CPU tensors: their plain versions,
    equal to the composite plain backward, and no launch counted."""
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(hq=4, hkv=2, seed=7))
    o, lse = fa.flash_fwd(q, k, v)
    before = [f.launches for f in (fa.flash_bwd_delta, fa.flash_bwd_dq,
                                   fa.flash_bwd_dkv)]
    delta = fa.flash_bwd_delta(o, do)
    np.testing.assert_allclose(
        delta.numpy(), (do * o).sum(-1).transpose(1, 2).numpy(), atol=ATOL)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta)
    for got, ref in zip((dq, dk, dv), fa.flash_bwd_plain(q, k, v, o, lse, do)):
        torch.testing.assert_close(got, ref, atol=0, rtol=0)
    for got, ref in zip(fa.flash_bwd(q, k, v, o, lse, do),
                        fa.flash_bwd_plain(q, k, v, o, lse, do)):
        torch.testing.assert_close(got, ref, atol=0, rtol=0)
    assert [f.launches for f in (fa.flash_bwd_delta, fa.flash_bwd_dq,
                                 fa.flash_bwd_dkv)] == before


def test_per_row_offsets_are_forward_only():
    """A (B,) q_offset tensor (the serving form) under requires_grad
    raises; under no_grad it runs, as serving does."""
    q, k, v, _ = _arrays(seed=8)
    tq, tk, tv = _leaves(q, k, v)
    offsets = torch.tensor([0, 3], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="forward-only"):
        fa.flash_attention(tq, tk, tv, q_offset=offsets)
    with pytest.raises(NotImplementedError, match="forward-only"):
        fa.flash_attention_with_lse(tq, tk, tv, q_offset=offsets)
    with torch.no_grad():
        out = fa.flash_attention(tq, tk, tv, q_offset=offsets)
    assert not out.requires_grad and out.shape == tq.shape


def test_dk_dv_come_back_in_kv_dtype():
    q, k, v, w = _arrays(hq=4, hkv=2, seed=9)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
                  for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv)
    grads = torch.autograd.grad(out.float().sum(), (tq, tk, tv))
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3
    assert [g.shape for g in grads] == [tq.shape, tk.shape, tv.shape]
