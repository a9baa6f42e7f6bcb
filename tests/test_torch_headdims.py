"""Head dims 32, 40, 80 and 160 on the CPU: the plain versions of K1 and
of the backward against the JAX package's ``flash_attention`` in
interpret mode at the UNet's shapes, the variant rules, the wrappers'
head-dim checks and the dispatcher's decisions on a ``"cuda"`` device
string (no card here)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucfn.kernels.flash_attention import flash_attention as jax_flash
from tpucfn_torch.kernels import auto
from tpucfn_torch.kernels import flash_attention as fa

BF, F32 = torch.bfloat16, torch.float32
# fp32 on both sides: sum order only (the reference's own flash-vs-dense
# tolerance at these shapes is 2e-6 on O).
FWD_TOL = 2e-6
GRAD_TOL = 3e-5  # relative to each gradient's largest entry


def _inputs(b, sq, sk, h, hkv, d, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, s, n, d).astype(np.float32)
            for s, n in ((sq, h), (sk, hkv), (sk, hkv))]


# The reference's UNet shapes (tests/test_flash_attention.py): 2 x 256
# queries, 8 heads, D = 40 over 256 keys and over the 77-key context, and
# D = 160 over the context; D = 80 and 160 (the 32x32 and 16x16 stages)
# likewise; and D = 32, the tiny UNet's middle block.
@pytest.mark.parametrize("d,sk,causal", [
    (40, 256, False), (40, 77, False), (40, 256, True),
    (32, 256, False), (32, 77, False), (32, 256, True),
    (80, 256, False), (80, 77, False), (80, 256, True),
    (160, 256, False), (160, 77, False), (160, 256, True)])
def test_plain_forward_matches_interpret_flash(d, sk, causal):
    q, k, v = _inputs(2, 256, sk, 8, 8, d)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                interpret=True))
    got, _ = fa.flash_fwd(*map(torch.from_numpy, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_TOL, rtol=0)


@pytest.mark.parametrize("d,sk,causal,hkv", [
    (40, 64, False, 4), (40, 77, False, 4), (40, 64, True, 2),
    (32, 64, False, 4), (32, 77, False, 2), (32, 64, True, 4),
    (80, 64, False, 4), (80, 77, False, 2), (80, 64, True, 4),
    (160, 64, False, 4), (160, 77, False, 4), (160, 64, True, 2)])
def test_plain_backward_matches_interpret_flash(d, sk, causal, hkv):
    """``flash_attention``'s gradients through the plain backward
    (``flash_bwd_plain``) against ``jax.grad`` of the reference's kernel
    in interpret mode."""
    q, k, v = _inputs(2, 64, sk, 4, hkv, d, seed=1)
    w = np.random.RandomState(2).randn(2, 64, 4, d).astype(np.float32)
    ref = jax.grad(lambda q, k, v: jnp.sum(jax_flash(
        q, k, v, causal=causal, block_q=32, block_k=32, interpret=True)
        * w), argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=causal)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                (tq, tk, tv))
    for g, r in zip(grads, ref):
        r = np.asarray(r)
        scale = float(np.abs(r).max())
        assert float(np.abs(g.numpy() - r).max()) <= GRAD_TOL * scale


@pytest.mark.parametrize("dtype,sq,h,hkv,d,want", [
    (BF, 4096, 8, 8, 40, "sm90"),   # the UNet's 64x64 self-attention
    (BF, 4096, 8, 8, 32, "sm90"),
    (BF, 64, 6, 2, 40, "mma"),      # a group of 3: mma in bf16
    (BF, 16, 8, 8, 40, "mma"),      # <= 16 rows, decode lacks D = 40
    (BF, 1, 4, 2, 32, "mma"),       # <= 16 rows, decode lacks D = 32
    (BF, 1, 4, 2, 64, "decode"),    # the decode variant keeps 16/64/128
    (BF, 1, 4, 2, None, "decode"),  # no head dim: the old rule
    (F32, 256, 2, 2, 32, "mma"),    # the tiny fp32 UNet's middle block
    (F32, 4096, 8, 8, 40, "mma"),
    (BF, 1024, 8, 8, 80, "sm90"),   # the UNet's 32x32 self-attention
    (BF, 256, 8, 8, 160, "sm90"),   # the 16x16 stage
    (BF, 64, 8, 8, 160, "sm90"),    # the middle block: one 64-row tile
    (BF, 64, 6, 2, 80, "mma"),      # a group of 3
    (BF, 64, 6, 2, 160, "mma"),
    (BF, 16, 8, 8, 80, "mma"),      # <= 16 rows, decode lacks D = 80
    (BF, 2, 8, 1, 160, "mma"),      # <= 16 rows, decode lacks D = 160
    (F32, 1024, 8, 8, 80, "mma"),
    (F32, 64, 8, 8, 160, "mma"),
])
def test_fwd_variant_takes_the_head_dim(dtype, sq, h, hkv, d, want):
    assert fa.fwd_variant(dtype, sq, h, hkv, d) == want
    if d is not None:
        assert d in fa.VARIANT_HEAD_DIMS[want]


@pytest.mark.parametrize("dtype,h,hkv,want", [
    (BF, 8, 8, "sm90"), (BF, 6, 2, "mma"), (F32, 8, 8, "mma")])
@pytest.mark.parametrize("d", [32, 40, 80, 160])
def test_backward_variants_take_the_head_dim(dtype, h, hkv, want, d):
    assert fa.dkv_variant(dtype, h, hkv) == fa.dq_variant(dtype, h, hkv) == want
    assert d in fa.VARIANT_HEAD_DIMS[want] and d in fa.HEAD_DIMS


def _stub(d, dtype=BF):
    """What ``_check_cuda`` reads of a tensor, on a CUDA device (no card
    is needed to name one)."""
    return types.SimpleNamespace(device=torch.device("cuda", 0), dtype=dtype,
                                 shape=(1, 64, 8, d),
                                 is_contiguous=lambda: True,
                                 data_ptr=lambda: 256)


@pytest.mark.parametrize("d", [16, 32, 40, 64, 80, 128, 160])
@pytest.mark.parametrize("variant", ["sm90", "mma", "decode", "fma"])
def test_check_cuda_checks_the_variants_head_dims(variant, d):
    """The check before a launch holds the head dim to the variant about
    to launch, and names it when it refuses."""
    t = _stub(d)
    if d in fa.VARIANT_HEAD_DIMS[variant]:
        assert fa._check_cuda("flash_fwd", {"q": t}, variant=variant) == [t]
    else:
        with pytest.raises(ValueError, match=f"the {variant} variant's"):
            fa._check_cuda("flash_fwd", {"q": t}, variant=variant)


@pytest.mark.parametrize("d", [96, 256])
def test_unbuilt_head_dims_still_raise(d):
    for variant in fa.VARIANT_HEAD_DIMS:
        with pytest.raises(ValueError, match="not in"):
            fa._check_cuda("flash_fwd", {"q": _stub(d)}, variant=variant)
    with pytest.raises(ValueError, match="not in the kernel's"):
        fa._check_cuda("flash_bwd_delta", {"o": _stub(d)})


def test_head_dims_are_those_every_reachable_variant_takes():
    """``HEAD_DIMS`` (what the dispatcher reads) holds a head dim only if
    every variant a call can reach takes it: K1's sm90 and mma (bf16 at
    <= 16 rows goes to mma where decode lacks it), K2/K3's sm90 and mma;
    Delta is checked against ``HEAD_DIMS`` itself."""
    reachable = [fa.VARIANT_HEAD_DIMS[v] for v in ("sm90", "mma")]
    for d in fa.HEAD_DIMS:
        assert all(d in dims for dims in reachable)
    assert set(fa.HEAD_DIMS) == {16, 32, 40, 64, 80, 128, 160}


# The SD-1.5 UNet's attentions at batch 2: the 64x64 stage (D = 40,
# 4096 queries over 4096 keys, and over the 77-token context), the 32x32
# (D = 80) and the 16x16 and middle blocks (D = 160).
UNET_CALLS = [(4096, 4096, 40), (4096, 77, 40), (1024, 1024, 80),
              (1024, 77, 80), (256, 256, 160), (256, 77, 160),
              (64, 64, 160), (64, 77, 160)]


@pytest.fixture
def port_defaults(monkeypatch):
    monkeypatch.delenv("TPUCFN_FLASH_MIN_S", raising=False)
    monkeypatch.delenv("TPUCFN_FLASH_UNTUNED_MIN_S", raising=False)


def test_dispatch_at_the_ports_defaults(port_defaults):
    """Thresholds 0: on the card the kernels take every UNet call, the
    self- and the cross-attention at D = 40, 80 and 160.  CPU tensors are
    always dense."""
    for s_q, s_kv, d in UNET_CALLS:
        assert auto.should_use_flash_full(
            s_q, s_kv, d=d, dtype=BF, device="cuda"), (s_q, s_kv, d)
        assert not auto.should_use_flash_full(s_q, s_kv, d=d, dtype=BF,
                                              device="cpu")
    assert auto.should_use_flash_full(256, 256, d=32, dtype=F32,
                                      device="cuda")


def test_dispatch_at_the_references_thresholds(monkeypatch):
    """With the JAX package's thresholds (2048 for both) the decisions are
    those of its ``test_full_attention_auto_dispatch_policy``: the long
    self-attention flash, the 77-key cross-attention and the short
    self-attention dense."""
    monkeypatch.setenv("TPUCFN_FLASH_MIN_S", "2048")
    monkeypatch.setenv("TPUCFN_FLASH_UNTUNED_MIN_S", "2048")
    decide = lambda s_q, s_kv: auto.should_use_flash_full(  # noqa: E731
        s_q, s_kv, d=40, dtype=BF, device="cuda")
    assert [decide(4096, 4096), decide(4096, 77), decide(1024, 1024)] == [
        True, False, False]
    for s_q, s_kv, d in UNET_CALLS:
        if d != 40:
            assert not auto.should_use_flash_full(s_q, s_kv, d=d, dtype=BF,
                                                  device="cuda")


def test_full_attention_auto_routes_the_unet_calls(port_defaults,
                                                   monkeypatch):
    """``full_attention_auto`` itself, with the device check answering as
    the card would: every UNet call reaches ``flash_attention``, none the
    dense op."""
    import tpucfn_torch.ops.attention as dense_mod

    calls = []
    monkeypatch.setattr(auto, "_on_card", lambda device: True)
    monkeypatch.setattr(fa, "flash_attention", lambda q, k, v, **kw: (
        calls.append(("flash", k.shape[1], q.shape[-1])) or q))
    monkeypatch.setattr(dense_mod, "dot_product_attention",
                        lambda q, k, v, **kw: (
                            calls.append(("dense", k.shape[1], q.shape[-1]))
                            or q))
    for s_q, s_kv, d in UNET_CALLS:
        q = torch.zeros(1, s_q, 1, d, dtype=BF)
        kv = torch.zeros(1, s_kv, 1, d, dtype=BF)
        auto.full_attention_auto(q, kv, kv)
    assert calls == [("flash", s_kv, d) for _, s_kv, d in UNET_CALLS]
