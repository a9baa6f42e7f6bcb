"""The port's kernel bindings, checked without a card.

* Every ``ctypes`` signature in ``flash_attention.ARGTYPES`` against the
  ``extern "C"`` prototype parsed from its ``csrc/<name>.cu``: the same
  functions, the same arity, ``c_void_p`` for every pointer and the
  stream (a ``c_int`` would cut a 64-bit address to 32 bits, which only a
  launch on the card would show).
* The variant choice of K1, K2 and K3 (``sm90``, ``decode``, ``mma`` or
  ``fma``) at the serving, training and edge shapes.
* The decode and mma planners' limits against their kernels' constants.
* The build key covers the shared headers, so an edited header rebuilds.
"""

from __future__ import annotations

import ctypes
import re
import shutil

import pytest
import torch

from tpucfn_torch.kernels import _build
from tpucfn_torch.kernels import flash_attention as fa

C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float,
           "size_t": ctypes.c_size_t}


def _prototypes(name: str) -> dict[str, tuple[str, list[str]]]:
    """name -> (return type, [parameter types]) of every function defined
    in the ``extern "C" { ... }`` block of ``csrc/<name>.cu``."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    block = src[src.index('extern "C" {'):]
    block = re.sub(r"//[^\n]*", "", block)
    out = {}
    for ret, fn, params in re.findall(
            r"([A-Za-z_][\w\s\*]*?)\s*\b(\w+)\s*\(([^)]*)\)\s*\{", block):
        types = [re.sub(r"\s*\b\w+$", "", p.strip())
                 for p in params.split(",") if p.strip()]
        out[fn] = (ret.strip(), types)
    return out


def _ctype(c_type: str):
    if "*" in c_type:
        return ctypes.c_char_p if c_type == "const char*" else ctypes.c_void_p
    return C_TYPES[c_type.replace("const ", "").strip()]


def test_every_source_has_a_signature_table():
    sources = {p.stem for p in _build.CSRC.glob("*.cu")}
    assert sources == set(fa.ARGTYPES)


@pytest.mark.parametrize("name", sorted(fa.ARGTYPES))
def test_argtypes_match_the_c_prototypes(name):
    protos = _prototypes(name)
    assert set(protos) == set(fa.ARGTYPES[name]), name
    for fn, (ret, params) in protos.items():
        argtypes, restype = fa.ARGTYPES[name][fn]
        assert len(argtypes) == len(params), (fn, len(argtypes), params)
        for i, (got, c_type) in enumerate(zip(argtypes, params)):
            want = ctypes.c_void_p if "*" in c_type else _ctype(c_type)
            assert got is want, (fn, i, c_type, got)
        assert restype is _ctype(ret), (fn, ret, restype)


@pytest.mark.parametrize("name", sorted(fa.ARGTYPES))
def test_pointers_and_stream_are_full_width(name):
    """The last argument of every launcher is the stream, and no pointer
    argument is bound narrower than a pointer."""
    for fn, (ret, params) in _prototypes(name).items():
        argtypes, _ = fa.ARGTYPES[name][fn]
        if params and params[-1] == "void*":
            assert argtypes[-1] is ctypes.c_void_p, fn
        pointers = [t for t, p in zip(argtypes, params) if "*" in p]
        assert all(ctypes.sizeof(t) == ctypes.sizeof(ctypes.c_void_p)
                   for t in pointers), fn


BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,sq,h,hkv,want", [
    (BF, 1, 32, 8, "decode"),    # llama3-1b serving decode: 4 packed rows
    (BF, 1, 6, 2, "decode"),     # decode at a GQA group of 3
    (BF, 1, 16, 1, "decode"),    # decode at a group of 16: one mma M tile
    (BF, 4, 32, 8, "decode"),    # 4 positions x group 4: 16 rows
    (BF, 5, 32, 8, "mma"),       # 20 rows: past one mma tile, short of 64
    (BF, 9, 32, 8, "mma"),       # 36 rows: a verify pass of width 9 at group 4
    (F32, 1, 32, 8, "mma"),      # fp32 decode: 3xTF32, never plain TF32
    (BF, 16, 32, 8, "sm90"),     # the smallest prefill bucket: 64 rows
    (BF, 16, 8, 2, "sm90"),      # a 16-token prefill at group 4
    (BF, 8, 32, 8, "mma"),       # below one 64-row tile
    (BF, 512, 32, 8, "sm90"),    # prefill 512
    (BF, 2048, 32, 8, "sm90"),   # llama3-1b training
    (F32, 2048, 32, 8, "mma"),   # fp32: 3xTF32, never plain TF32
    (BF, 64, 4, 2, "sm90"),      # tiny shape in bf16, D=16 GQA 2
    (BF, 64, 6, 2, "mma"),       # a group of 3 does not divide the tile
    (BF, 1, 64, 1, "sm90"),      # a group of 64: one position is one tile
    (BF, 4, 128, 1, "mma"),      # a group of 128 exceeds the tile
])
def test_fwd_variant(dtype, sq, h, hkv, want):
    assert fa.fwd_variant(dtype, sq, h, hkv) == want


@pytest.mark.parametrize("dtype,h,hkv,want", [
    (BF, 32, 8, "sm90"), (BF, 4, 2, "sm90"), (BF, 8, 8, "sm90"),
    (F32, 32, 8, "mma"), (BF, 6, 2, "mma"), (BF, 128, 1, "mma"),
])
def test_dkv_variant(dtype, h, hkv, want):
    assert fa.dkv_variant(dtype, h, hkv) == want


@pytest.mark.parametrize("dtype,h,hkv,want", [
    (BF, 32, 8, "sm90"),    # llama3-1b training: a group of 4
    (BF, 4, 2, "sm90"),     # tiny shape in bf16: a group of 2
    (BF, 8, 8, "sm90"),     # no GQA: a group of 1
    (F32, 32, 8, "mma"),    # fp32: 3xTF32, never plain TF32
    (BF, 6, 2, "mma"),      # a group of 3 does not divide the tile
    (BF, 128, 1, "mma"),    # a group of 128 exceeds the tile
] + [
    # every group from 1 to 128 in either dtype: sm90 only for bf16 groups
    # that divide the 64-row tile
    (dtype, 2 * rep, 2,
     "sm90" if dtype == BF and rep in (1, 2, 4, 8, 16, 64) else "mma")
    for dtype in (BF, F32) for rep in (1, 2, 3, 4, 5, 8, 16, 64, 128)
])
def test_dq_variant(dtype, h, hkv, want):
    assert fa.dq_variant(dtype, h, hkv) == want


def test_backward_variants_agree():
    """K2 and K3 take one variant rule: the dQ and dK/dV kernels of one
    backward are the same design."""
    assert fa.dq_variant is fa.dkv_variant


def test_decode_planner_fits_the_kernel():
    """The decode planner's row and chunk limits are the kernel's own: one
    mma M tile of packed rows, and at most one portable cluster of
    chunks (a larger cluster fails only at launch, on the card)."""
    src = (_build.CSRC / "flash_fwd_decode_sm90.cu").read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(const["kRows"]) == fa.DECODE_ROWS
    assert int(const["kMaxCluster"]) == fa.DECODE_CLUSTER <= 8


def test_mma_planner_fits_the_kernel():
    """The mma planners' constants are the kernels' own: 16 rows a warp,
    at most 4 warps a CTA and one portable cluster of key chunks (K1),
    K1's key tile, and K3's key block of one mma M tile over 4 warps."""
    fwd = (_build.CSRC / "flash_fwd_mma_sm90.cu").read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", fwd))
    assert int(const["kRowsPerWarp"]) == fa.MMA_ROWS
    assert int(const["kMaxWarps"]) == fa.MMA_MAX_WARPS
    assert int(const["kMaxCluster"]) == fa.MMA_CLUSTER <= 8
    tile = re.search(r"is_same<T, float>::value && D >= (\d+) \? (\d+) : (\d+)",
                     fwd).groups()
    for dtype, d in ((F32, 16), (F32, 64), (F32, 80), (F32, 128), (F32, 160),
                     (BF, 16), (BF, 80), (BF, 128), (BF, 160)):
        want = int(tile[1]) if dtype == F32 and d >= int(tile[0]) \
            else int(tile[2])
        assert fa._mma_keys(dtype, d) == want
    bwd = (_build.CSRC / "flash_bwd_dkv_mma_sm90.cu").read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", bwd))
    assert int(const["kWarpKeys"]) == fa.MMA_ROWS and int(const["kWarps"]) == 4


def test_mma_dq_kernel_tiles_rows_as_k1_mma():
    """K2 mma tiles its rows as K1 mma does: 16 packed rows a warp, at
    most 4 warps a CTA."""
    src = (_build.CSRC / "flash_bwd_dq_mma_sm90.cu").read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(const["kRowsPerWarp"]) == fa.MMA_ROWS
    assert int(const["kMaxWarps"]) == fa.MMA_MAX_WARPS


@pytest.mark.parametrize("dtype,b,sq,h,hkv,d,sk,want", [
    # verify passes over llama3-1b's 2048-key cache: 20 and 36 rows
    (BF, 8, 5, 32, 8, 64, 2048, (2, 256, 8)),
    (BF, 8, 9, 32, 8, 64, 2048, (3, 256, 8)),
    (F32, 2, 64, 4, 2, 16, 64, (4, 64, 1)),      # the tiny fp32 shape
    (F32, 2, 96, 8, 4, 128, 160, (4, 32, 5)),    # fp32 D=128: 32-key tiles
    (BF, 2, 64, 6, 2, 64, 128, (4, 128, 1)),     # GQA 3: 2 bf16 tiles, 1 chunk
    (F32, 2, 2048, 32, 8, 64, 2048, (4, 2048, 1)),  # many rows: one chunk
    (F32, 2, 64, 8, 8, 160, 77, (4, 32, 3)),     # fp32 D=160: 32-key tiles
    (BF, 2, 16, 8, 8, 80, 77, (1, 128, 1)),      # bf16 D=80, 16 rows: mma
])
def test_mma_fwd_plan(dtype, b, sq, h, hkv, d, sk, want):
    warps, chunk, n = fa._mma_fwd_plan(dtype, b, sq, h, hkv, d, sk)
    assert (warps, chunk, n) == want
    assert chunk % fa._mma_keys(dtype, d) == 0 and chunk * n >= sk
    assert 1 <= n <= fa.MMA_CLUSTER and 1 <= warps <= fa.MMA_MAX_WARPS


def test_cpu_calls_count_no_launch():
    """CPU tensors take the plain versions: no counter moves, the decode
    variant's included."""
    rs = torch.Generator().manual_seed(0)
    q = torch.randn(1, 64, 4, 16, generator=rs).to(BF)
    k = torch.randn(1, 64, 2, 16, generator=rs).to(BF)
    wrappers = (fa.flash_fwd, fa.flash_bwd_delta, fa.flash_bwd_dq,
                fa.flash_bwd_dkv)
    by_variant = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    assert set(fa.flash_fwd.launches_by_variant) == {"sm90", "decode", "mma",
                                                     "fma"}
    for w in (fa.flash_bwd_dq, fa.flash_bwd_dkv):
        assert set(w.launches_by_variant) == {"sm90", "mma", "fma"}
    before = ([w.launches for w in wrappers],
              [dict(w.launches_by_variant) for w in by_variant])
    assert fa.fwd_variant(BF, 1, 4, 2) == "decode"
    fa.flash_fwd(q[:, :1], k, k, q_offset=torch.tensor([63]))
    o, lse = fa.flash_fwd(q, k, k)
    delta = fa.flash_bwd_delta(o, q)
    fa.flash_bwd_dq(q, k, k, q, lse, delta)
    fa.flash_bwd_dkv(q, k, k, q, lse, delta)
    assert ([w.launches for w in wrappers],
            [w.launches_by_variant for w in by_variant]) == before


def test_build_key_covers_shared_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build.library_path("flash_fwd_sm90")
    header = csrc / "sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path("flash_fwd_sm90") != before
