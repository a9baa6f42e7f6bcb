"""The port's attention against the JAX package's, on the CPU.

* ``tpucfn_torch.ops.attention`` (the plain version of the flash forward
  kernel) against ``tpucfn.ops.attention``;
* the flash wrapper on CPU tensors (it takes the plain version there)
  against JAX ``flash_attention``/``flash_attention_with_lse`` run in
  Pallas interpret mode, as the JAX package's own tests run them;
* per-row query offsets (the serving engine's form), row by row against
  JAX's static-offset calls.

Inputs are made with numpy from a seed and handed to both.  Tolerance:
fp32 throughout, 1e-5 absolute (both sides sum in fp32, in different
orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucfn.kernels.flash_attention import flash_attention as jax_flash
from tpucfn.kernels.flash_attention import \
    flash_attention_with_lse as jax_flash_lse
from tpucfn.ops.attention import \
    dot_product_attention_with_lse as jax_dense_lse
from tpucfn_torch.kernels import flash_attention as fa
from tpucfn_torch.ops.attention import NEG_INF, dot_product_attention_with_lse

ATOL = 1e-5

# The suite runs several pytest workers side by side on the CPU; torch's
# intra-op pool would otherwise claim every core in each of them and starve
# the JAX tests' multi-device collectives in the other workers.
torch.set_num_threads(1)


def _qkv(b=2, sq=16, sk=16, hq=4, hkv=4, d=16, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, sq, hq, d).astype(np.float32),
            rs.randn(b, sk, hkv, d).astype(np.float32),
            rs.randn(b, sk, hkv, d).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("causal,q_offset,k_offset,rep", [
    (True, 0, 0, 1), (False, 0, 0, 1), (True, 8, 0, 2), (True, 0, 4, 4),
    (False, 0, 0, 4), (True, 5, 3, 2)])
def test_plain_matches_jax_dense(causal, q_offset, k_offset, rep):
    q, k, v = _qkv(sq=12, sk=20, hq=4, hkv=4 // rep)
    o, lse = dot_product_attention_with_lse(
        *_t(q, k, v), causal=causal, q_offset=q_offset, k_offset=k_offset)
    jo, jlse = jax_dense_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, q_offset=q_offset,
                             k_offset=k_offset)
    _close(o, jo)
    _close(lse, jlse)


def test_plain_mask_matches_jax_dense():
    q, k, v = _qkv(sq=8, sk=8)
    mask = np.random.RandomState(1).rand(2, 1, 8, 8) > 0.3
    o, lse = dot_product_attention_with_lse(*_t(q, k, v), causal=False,
                                            mask=torch.from_numpy(mask))
    jo, jlse = jax_dense_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=False, mask=jnp.asarray(mask))
    _close(o, jo)
    _close(lse, jlse)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rep", [1, 2, 4])
def test_flash_wrapper_matches_jax_flash(causal, rep):
    q, k, v = _qkv(sq=32, sk=32, hq=4, hkv=4 // rep)
    out = fa.flash_attention(*_t(q, k, v), causal=causal)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, interpret=True)
    _close(out, ref)


@pytest.mark.parametrize("sq,sk,q_offset,k_offset", [
    (13, 13, 0, 0), (7, 50, 43, 0), (24, 40, 16, 8), (50, 29, 0, 0)])
def test_flash_with_lse_odd_lengths_and_offsets(sq, sk, q_offset, k_offset):
    """Odd S (the block padding of _block_and_pad on the JAX side) and
    causal offsets, both outputs."""
    q, k, v = _qkv(sq=sq, sk=sk, hq=4, hkv=2)
    o, lse = fa.flash_attention_with_lse(*_t(q, k, v), q_offset=q_offset,
                                         k_offset=k_offset, block_q=16,
                                         block_k=16)
    jo, jlse = jax_flash_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             q_offset=q_offset, k_offset=k_offset,
                             block_q=16, block_k=16, interpret=True)
    assert lse.shape == (2, sq, 4)
    _close(o, jo)
    _close(lse, jlse)


def test_flash_segment_ids_match_jax_flash():
    q, k, v = _qkv(sq=24, sk=24, hq=4, hkv=2)
    seg = np.repeat(np.array([[0, 1, 2], [0, 0, 1]]), 8, axis=1).astype(np.int32)
    out = fa.flash_attention(*_t(q, k, v), segment_ids=torch.from_numpy(seg))
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    segment_ids=jnp.asarray(seg), interpret=True)
    _close(out, ref)


def test_flash_empty_rows_zero_out_and_neg_inf_lse():
    """k_offset past every query: each row attends to nothing, so O = 0
    and LSE = NEG_INF (finite), never NaN — on both sides."""
    q, k, v = _qkv(sq=16, sk=16)
    o, lse = fa.flash_attention_with_lse(*_t(q, k, v), k_offset=1000)
    jo, jlse = jax_flash_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             k_offset=1000, interpret=True)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    assert (o == 0).all()
    assert (lse == NEG_INF).all()
    _close(o, jo)
    _close(lse, jlse)


def test_flash_partly_empty_rows():
    """k_offset > 0 causal: the first rows see no key, later rows do."""
    q, k, v = _qkv(sq=16, sk=16)
    o, lse = fa.flash_attention_with_lse(*_t(q, k, v), k_offset=6)
    jo, jlse = jax_flash_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             k_offset=6, interpret=True)
    assert (lse[:, :6] == NEG_INF).all() and (lse[:, 6:] > NEG_INF / 2).all()
    _close(o, jo)
    _close(lse, jlse)


@pytest.mark.parametrize("sq", [1, 5])
def test_per_row_q_offset_matches_static_rows(sq):
    """One query offset per batch row (decode/prefill over slots at
    different positions) equals JAX's static-offset call on each row."""
    b, sk = 4, 40
    q, k, v = _qkv(b=b, sq=sq, sk=sk, hq=8, hkv=2, seed=3)
    offsets = np.array([0, 7, 19, sk - sq], np.int32)
    o, lse = fa.flash_attention_with_lse(
        *_t(q, k, v), q_offset=torch.from_numpy(offsets))
    for row, off in enumerate(offsets):
        jo, jlse = jax_flash_lse(
            jnp.asarray(q[row:row + 1]), jnp.asarray(k[row:row + 1]),
            jnp.asarray(v[row:row + 1]), q_offset=int(off), interpret=True)
        _close(o[row:row + 1], jo)
        _close(lse[row:row + 1], jlse)


@pytest.mark.parametrize("hq,hkv", [(8, 2), (6, 2)])
def test_per_row_q_offset_decode_shape(hq, hkv):
    """The decode variant's shape (8 slots, one query position, GQA groups
    of 4 and 3) at offsets from 0 to Sk - 1, row by row against JAX's
    static-offset calls."""
    b, sk = 8, 40
    q, k, v = _qkv(b=b, sq=1, sk=sk, hq=hq, hkv=hkv, seed=4)
    offsets = np.array([0, 1, 5, 13, 20, 27, 38, sk - 1], np.int32)
    assert fa.fwd_variant(torch.bfloat16, 1, hq, hkv) == "decode"
    o, lse = fa.flash_attention_with_lse(
        *_t(q, k, v), q_offset=torch.from_numpy(offsets))
    for row, off in enumerate(offsets):
        jo, jlse = jax_flash_lse(
            jnp.asarray(q[row:row + 1]), jnp.asarray(k[row:row + 1]),
            jnp.asarray(v[row:row + 1]), q_offset=int(off), interpret=True)
        _close(o[row:row + 1], jo)
        _close(lse[row:row + 1], jlse)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_gqa3_matches_jax_flash(causal):
    """A GQA group of 3 (H=6, Hkv=2), which K1 runs on its mma variant in
    either dtype (3 does not divide the sm90 tile), both outputs."""
    q, k, v = _qkv(sq=24, sk=32, hq=6, hkv=2, seed=5)
    assert fa.fwd_variant(torch.bfloat16, 24, 6, 2) == "mma"
    o, lse = fa.flash_attention_with_lse(*_t(q, k, v), causal=causal,
                                         q_offset=8)
    jo, jlse = jax_flash_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, q_offset=8, block_q=8, block_k=8,
                             interpret=True)
    _close(o, jo)
    _close(lse, jlse)


@pytest.mark.parametrize("sq", [5, 9])
def test_verify_width_matches_jax_flash(sq):
    """A speculative-decoding verify pass (Sq = 1 + k at GQA 4: 20 and 36
    packed rows, K1's mma variant in bf16) over a longer cache, at a
    per-row query offset each, row by row against JAX's static-offset
    calls."""
    b, sk = 4, 64
    q, k, v = _qkv(b=b, sq=sq, sk=sk, hq=8, hkv=2, seed=6)
    offsets = np.array([0, 17, 40, sk - sq], np.int32)
    assert fa.fwd_variant(torch.bfloat16, sq, 8, 2) == "mma"
    o, lse = fa.flash_attention_with_lse(
        *_t(q, k, v), q_offset=torch.from_numpy(offsets))
    for row, off in enumerate(offsets):
        jo, jlse = jax_flash_lse(
            jnp.asarray(q[row:row + 1]), jnp.asarray(k[row:row + 1]),
            jnp.asarray(v[row:row + 1]), q_offset=int(off), block_q=8,
            block_k=16, interpret=True)
        _close(o[row:row + 1], jo)
        _close(lse[row:row + 1], jlse)


def test_flash_mask_argument_rejected():
    q, k, v = _t(*_qkv())
    with pytest.raises(NotImplementedError):
        fa.flash_attention(q, k, v, mask=torch.ones(1, dtype=torch.bool))


def test_cpu_path_counts_no_launch():
    before = fa.flash_fwd.launches
    fa.flash_attention(*_t(*_qkv()))
    assert fa.flash_fwd.launches == before


@pytest.mark.parametrize("s,target,expect", [
    (1, 64, (8, 8)), (13, 64, (16, 16)), (64, 64, (64, 64)),
    (100, 64, (64, 128)), (2048, 64, (64, 2048))])
def test_block_and_pad(s, target, expect):
    assert fa._block_and_pad(s, target) == expect


def test_block_choice_order(monkeypatch):
    monkeypatch.delenv("TPUCFN_FLASH_BLOCK_Q", raising=False)
    monkeypatch.delenv("TPUCFN_FLASH_BLOCK_K", raising=False)
    assert fa._choose_blocks(None, None) == (64, 64)
    monkeypatch.setenv("TPUCFN_FLASH_BLOCK_Q", "32")
    assert fa._choose_blocks(None, 16) == (32, 16)
    assert fa._choose_blocks(128, None) == (128, 64)
    for bad in (0, 12, 136.5, "x"):
        with pytest.raises(ValueError):
            fa._check_block(bad, "block_q")
    monkeypatch.setenv("TPUCFN_FLASH_BLOCK_K", "20")
    with pytest.raises(ValueError, match="TPUCFN_FLASH_BLOCK_K"):
        fa.flash_attention(*_t(*_qkv()))


def test_wrapper_shape_checks():
    q, k, v = _t(*_qkv(hq=4, hkv=3))
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q, k, v)
    q, k, v = _t(*_qkv())
    with pytest.raises(ValueError, match="segment"):
        fa.flash_attention(q, k, v,
                           segment_ids=(torch.zeros(2, 16, dtype=torch.int32),
                                        torch.zeros(2, 3, dtype=torch.int32)))


@pytest.mark.parametrize("ctas,n_tiles,expect", [
    (64, 32, (8, 4)),       # fp32 decode: 8 slots x 8 KV heads, 2048 keys
    (32, 32, (16, 2)),      # prefill Sq=16: 4 lanes x 8 KV heads, one row block
    (256, 32, (3, 11)),     # prefill Sq=128
    (1024, 32, (1, 32)),    # prefill Sq=512: enough CTAs, no split
    (16, 3, (1, 3)),        # too few tiles to split
    (1, 100, (15, 7))])     # capped at MAX_SPLITS (16 -> 7 tiles each)
def test_kv_split_choice(ctas, n_tiles, expect):
    n_split, split_tiles = fa._kv_splits(ctas, n_tiles, 132)
    assert (n_split, split_tiles) == expect
    assert (n_split - 1) * split_tiles < n_tiles <= n_split * split_tiles


@pytest.mark.parametrize("sk,expect", [
    (2048, (256, 8)),     # llama3-1b serving cache: 8 chunks of 256 keys
    (8192, (1024, 8)),    # llama3-8b width over an 8192-key cache
    (128, (64, 2)),       # the tiny preset's cache
    (40, (64, 1)),        # a cache shorter than one chunk: no merge
    (300, (64, 5)),       # a ragged last chunk
    (1000, (128, 8)),
])
def test_decode_chunks(sk, expect):
    chunk, n_chunks = fa._decode_chunks(sk)
    assert (chunk, n_chunks) == expect
    assert chunk % 64 == 0 and 1 <= n_chunks <= fa.DECODE_CLUSTER
    # The chunks tile the capacity: the last one holds the last key.
    assert (n_chunks - 1) * chunk < sk <= n_chunks * chunk
