// FlashAttention backward, dK and dV, on Hopper's tensor cores (sm_90a),
// bf16.
//
// Replaces the Pallas TPU kernel `_bwd_dkv_kernel` in
// tpucfn/kernels/flash_attention.py for bf16 inputs whose GQA group size
// divides 64; the FMA kernel in flash_bwd.cu keeps fp32.  It computes what
// that kernel computes: for each live (query, key) pair P = exp(S * scale
// - LSE) and dS = P * (dP - Delta + dLSE) * scale, then dV = P^T dO and
// dK = dS^T Q summed over every query head of the KV head's group, with
// causality (int offsets), segment ids, the ragged edges and empty rows
// (P = 0 exactly).  Each CTA writes its dK and dV rows once: no atomics,
// no repeated KV.
//
// What bounds it on an H100.  Operations: four products of length D per
// live pair (8 * D flops) against O(S * D) bytes.  The design follows
// FlashAttention-3's backward, with keys as the wgmma M dimension.
//  * One CTA per (64-key block, KV head, batch row); its consumer
//    warpgroup keeps K and V in shared memory (one TMA load each) and dK,
//    dV in fp32 registers (at D = 160 one after the other, below).
//  * A producer warp streams the group's packed query rows (position
//    major, as in the forward) in tiles of 64: Q and dO by TMA, 4-D boxes
//    of 64 / rep positions x rep heads, into a 2-stage ring guarded by
//    full/empty mbarriers, with each row's LSE (times log2 e) and
//    Delta - dLSE staged beside them.
//  * S^T = K Q^T and dP^T = V dO^T are two wgmma chains from shared
//    memory, so P^T and dS^T land in registers in the accumulator layout,
//    which is the A-operand layout of dV += P^T dO and dK += dS^T Q; those
//    read dO and Q from the same shared tiles as MN-major operands.  The
//    row statistics are per column of the transposed tile, read from the
//    staged vectors.
//  * Software pipeline: S^T and dP^T of tile t + 1 are issued right behind
//    dV/dK of tile t.  (P^T is computed in place over S^T's accumulator
//    while dP^T is in flight, which ptxas answers by serializing the wgmma
//    pipeline (C7515); registers of its own for P^T cost more: at D = 64
//    two CTAs per SM leave 168 registers a thread, and it spills.)
//  * D = 32 tiles use the 64-byte swizzle; D = 40, 80 and 160 run on
//    zero-padded tiles of 64, 128 and 192 columns (sm90.cuh, tile_cols):
//    S^T and dP^T reduce over 48, 80 and 160 columns, dK and dV are
//    accumulated over the padded width and D are stored.
//  * Registers.  Up to 128 columns the consumer warpgroup holds both
//    accumulators (2 x 64 registers a thread at 128) beside S^T, dP^T and
//    their bf16 fragments.  At 192 columns (D = 160) dK and dV alone would
//    take 192 registers a thread and the whole more than the 255 a thread
//    may have, and a wgmma accumulator that spills is serialized.  So
//    there the warpgroup makes two passes over the streamed query tiles,
//    each with one 96-register accumulator: S^T, P^T and dV += P^T dO,
//    then S^T, dP^T, dS^T and dK += dS^T Q (Q and dO are streamed twice
//    and S^T computed twice: five products a tile where one pass does
//    four).  A second consumer warpgroup, one for dV and one for dK, was
//    tried first: ptxas holds a CTA of 288 threads to 168 registers a
//    thread (as for 384), and the dK warpgroup spilled 896 bytes.
//
// Numerics.  K Q^T and V dO^T take exact bf16 inputs with fp32
// accumulation; P^T and dS^T are rounded to bf16 as operands of the second
// products (as FlashAttention-2 and -3 do); accumulation is fp32.
//
// Layout: q, dO (B, Sq, H, D); k, v, dK, dV (B, Sk, Hkv, D), bf16,
// contiguous, 16-byte aligned; lse, delta, dlse (B, H, Sq) fp32 (dlse may
// be null); q_seg (B, Sq), kv_seg (B, Sk) int32 or null.

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kKeys = 64;      // keys per CTA: the M of every product
constexpr int kBQ = 64;        // packed query rows per streamed tile
constexpr int kStages = 2;     // Q/dO ring depth
constexpr int kThreads = 160;  // warps 0-3 consume, warp 4 produces
constexpr int kDV = 1, kDK = 2;  // what a pass over the query tiles accumulates

template <int D>
struct Cfg {
  static constexpr int DT = tile_cols(D);   // columns of a shared-memory tile
  // Passes over the query tiles: one for both accumulators, or at 192
  // columns one for dV, then one for dK (registers).
  static constexpr int PASSES = DT > 128 ? 2 : 1;
  static constexpr int MIN_CTAS = DT >= 128 ? 1 : 2;  // CTAs an SM holds (registers)
  static constexpr int TILE = 64 * DT * 2;  // bytes of one 64 x DT bf16 tile
  static constexpr int OFF_V = TILE;
  static constexpr int OFF_Q = 2 * TILE;
  static constexpr int OFF_DO = OFF_Q + kStages * TILE;
  static constexpr int OFF_STAT = OFF_DO + kStages * TILE;  // 2 x kBQ floats per stage
  static constexpr int OFF_BAR = OFF_STAT + kStages * 2 * kBQ * 4;
  static constexpr int SMEM = OFF_BAR + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
};

struct Params {
  bf16* dk;
  bf16* dv;
  const float* lse;
  const float* delta;
  const float* dlse;
  const int* q_seg;
  const int* kv_seg;
  int B, H, Hkv, Sq, Sk, q_offset, k_offset, causal;
  float scale;
};

// What the consumer warpgroup needs of its CTA.
struct Block {
  const bf16* sK;
  const bf16* sV;
  const bf16* sQ;
  const bf16* sDO;
  const float* sStat;
  uint64_t* full;
  uint64_t* empty;
  int b, hk, rep, total, k0, r_begin, n_tiles;
};

// One pass of the consumer warpgroup over the streamed query tiles: dV
// (kRole & kDV) and dK (kRole & kDK) of the block's 64 keys, accumulated
// in registers and stored at the end.  The ring's tiles are numbered
// across passes: this pass reads tiles `base` to `base + n_tiles - 1`.
template <int D, int kRole>
__device__ __forceinline__ void consume(const Params& p, const Block& c, int warp, int lane,
                                        int base) {
  using C = Cfg<D>;
  constexpr int DT = C::DT;
  constexpr bool DV = kRole & kDV, DK = kRole & kDK;
  // Thread (warp, lane) holds keys kr and kr + 8 of the block, kr = 16 warp
  // + lane / 4, and columns 8 n + 2 (lane % 4) + {0, 1}: query rows of the
  // S^T / dP^T tiles, head-dim columns of dK / dV.
  const int kr = warp * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  int kpos[2], kseg[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    kpos[i] = c.k0 + kr + 8 * i;
    if (p.q_seg != nullptr && kpos[i] < p.Sk) kseg[i] = p.kv_seg[c.b * p.Sk + kpos[i]];
  }
  const float scale_log2 = p.scale * kLog2e;
  const long long last_key = (long long)p.k_offset + c.k0 + kKeys - 1;

  float dk[DK ? DT / 2 : 1], dv[DV ? DT / 2 : 1];
#pragma unroll
  for (int i = 0; i < DT / 2; ++i) {
    if constexpr (DK) dk[i] = 0.f;
    if constexpr (DV) dv[i] = 0.f;
  }
  float pt[kBQ / 2], dpt[DK ? kBQ / 2 : 1];  // S^T then P^T; dP^T then dS^T

  // S^T = K Q_t^T (and for dK dP^T = V dO_t^T), each a committed group.
  auto issue_sdp = [&](int t) {
    const int s = (base + t) % kStages;
    mbar_wait(c.full + s, ((base + t) / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < k_steps(D); ++kk)
      wgmma_ss<kBQ>(pt, desc_kmajor<D>(c.sK, kKeys, kk), desc_kmajor<D>(c.sQ + s * kBQ * DT, kBQ, kk), kk > 0);
    wgmma_commit();
    if constexpr (DK) {
#pragma unroll
      for (int kk = 0; kk < k_steps(D); ++kk)
        wgmma_ss<kBQ>(dpt, desc_kmajor<D>(c.sV, kKeys, kk), desc_kmajor<D>(c.sDO + s * kBQ * DT, kBQ, kk), kk > 0);
      wgmma_commit();
    }
  };

  // Software pipeline: S^T and dP^T of tile t + 1 are issued right behind
  // tile t's dV/dK products, so the tensor cores run on while P^T of the
  // next tile is computed.  At the top of iteration t the groups in flight
  // are dV/dK of tile t - 1, then S^T (and dP^T) of tile t.
  if (c.n_tiles > 0) issue_sdp(0);
  for (int t = 0; t < c.n_tiles; ++t) {
    const int s = (base + t) % kStages;
    const int row0 = c.r_begin + t * kBQ;
    const float* st = c.sStat + s * 2 * kBQ;
    if constexpr (DK) wgmma_wait<1>();  // dV/dK of tile t - 1 and S^T of tile t
    else wgmma_wait<0>();
    fence_regs<kBQ / 2>(pt);
    if constexpr (DV) fence_regs<DT / 2>(dv);
    if constexpr (DK) fence_regs<DT / 2>(dk);
    if (t > 0 && lane == 0) mbar_arrive(c.empty + (base + t - 1) % kStages);

    // P^T = exp(S^T * scale - LSE[column]) on live pairs.
    const bool masked = c.k0 + kKeys > p.Sk ||
                        (p.causal && (long long)p.q_offset + row0 / c.rep < last_key) ||
                        p.q_seg != nullptr;
#pragma unroll
    for (int n = 0; n < kBQ / 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 8 * n + col0 + j;
        const float l2 = st[col];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 4 * n + 2 * i + j;
          float pr = exp2_ftz(fmaf(pt[e], scale_log2, -l2));
          if (masked) {
            const int R = row0 + col, qp = R / c.rep;
            bool keep = kpos[i] < p.Sk;
            if (p.causal) keep = keep && (long long)p.q_offset + qp >= (long long)p.k_offset + kpos[i];
            if (p.q_seg != nullptr) keep = keep && R < c.total && p.q_seg[c.b * p.Sq + qp] == kseg[i];
            if (!keep) pr = 0.f;
          }
          pt[e] = pr;
        }
      }
    if constexpr (DK) {
      wgmma_wait<0>();  // dP^T of tile t
      fence_regs<kBQ / 2>(dpt);
      // dS^T = P^T (dP^T - (Delta - dLSE)[column]) * scale.
#pragma unroll
      for (int n = 0; n < kBQ / 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float dl = st[kBQ + 8 * n + col0 + j];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 4 * n + 2 * i + j;
            dpt[e] = pt[e] * (dpt[e] - dl) * p.scale;
          }
        }
    }
    uint32_t pa[DV ? kBQ / 16 : 1][4], da[DK ? kBQ / 16 : 1][4];
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      if constexpr (DV) a_frag(pt, kk, pa[kk]);
      if constexpr (DK) a_frag(dpt, kk, da[kk]);
    }
    wgmma_fence();
    if constexpr (DV) {
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)
        wgmma_rs<DT>(dv, pa[kk], desc_mnmajor<D>(c.sDO + s * kBQ * DT, kBQ, kk));
    }
    if constexpr (DK) {
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)
        wgmma_rs<DT>(dk, da[kk], desc_mnmajor<D>(c.sQ + s * kBQ * DT, kBQ, kk));
    }
    wgmma_commit();
    if (t + 1 < c.n_tiles) issue_sdp(t + 1);
  }
  wgmma_wait<0>();
  if constexpr (DV) fence_regs<DT / 2>(dv);
  if constexpr (DK) fence_regs<DT / 2>(dk);
  // The pass's last tile is free too (a next pass's tiles refill it).
  if (c.n_tiles > 0 && lane == 0) mbar_arrive(c.empty + (base + c.n_tiles - 1) % kStages);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (kpos[i] >= p.Sk) continue;
    const size_t off = ((size_t)(c.b * p.Sk + kpos[i]) * p.Hkv + c.hk) * D + col0;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      if constexpr (DK)
        *reinterpret_cast<uint32_t*>(p.dk + off + 8 * n) =
            pack_bf16(dk[4 * n + 2 * i], dk[4 * n + 2 * i + 1]);
      if constexpr (DV)
        *reinterpret_cast<uint32_t*>(p.dv + off + 8 * n) =
            pack_bf16(dv[4 * n + 2 * i], dv[4 * n + 2 * i + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, Cfg<D>::MIN_CTAS)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                              const __grid_constant__ CUtensorMap domap,
                              const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap, const Params p) {
  using C = Cfg<D>;
  constexpr int DT = C::DT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = reinterpret_cast<bf16*>(smem + C::OFF_V);
  bf16* sQ = reinterpret_cast<bf16*>(smem + C::OFF_Q);
  bf16* sDO = reinterpret_cast<bf16*>(smem + C::OFF_DO);
  float* sStat = reinterpret_cast<float*>(smem + C::OFF_STAT);
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* full = full_kv + 1;
  uint64_t* empty = full + kStages;

  const int bhs = p.B * p.Hkv;
  const int kb = blockIdx.x / bhs;  // heaviest first: key block 0 of every (head, row) first
  const int hk = blockIdx.x % bhs % p.Hkv, b = blockIdx.x % bhs / p.Hkv;
  const int rep = p.H / p.Hkv;
  const int total = p.Sq * rep;
  const int k0 = kb * kKeys;
  int r_begin = 0;  // the first packed row that can see this block's first key
  if (p.causal) {
    const long long first = (long long)p.k_offset + k0 - p.q_offset;
    if (first > 0) r_begin = (int)(first < p.Sq ? first : p.Sq) * rep;
  }
  const int n_tiles = (total - r_begin + kBQ - 1) / kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 32);          // the producer warp's lanes (stats), one with the TMA bytes
      mbar_init(empty + s, 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {  // producer
    if (lane == 0) {
      prefetch_map(&qmap);
      prefetch_map(&domap);
      mbar_expect_tx(full_kv, 2 * C::TILE);
      tma_tile<D>(sK, &kmap, full_kv, kKeys, hk, k0, b);
      tma_tile<D>(sV, &vmap, full_kv, kKeys, hk, k0, b);
    }
    // Tile g of the ring is row tile g % n_tiles of pass g / n_tiles.
    for (int g = 0; g < C::PASSES * n_tiles; ++g) {
      const int s = g % kStages;
      if (g >= kStages) mbar_wait(empty + s, ((g / kStages) & 1) ^ 1);
      const int row0 = r_begin + g % n_tiles * kBQ;
      float* st = sStat + s * 2 * kBQ;
      for (int r = lane; r < kBQ; r += 32) {
        const int R = row0 + r;
        float l2 = INFINITY, dl = 0.f;  // padded rows: P = exp(-inf) = 0
        if (R < total) {
          const size_t idx = ((size_t)b * p.H + hk * rep + R % rep) * p.Sq + R / rep;
          const float lse = p.lse[idx];
          if (lse > 0.5f * kNegInf) l2 = lse * kLog2e;  // a row that sees nothing: P = 0
          dl = p.delta[idx] - (p.dlse != nullptr ? p.dlse[idx] : 0.f);
        }
        st[r] = l2;
        st[kBQ + r] = dl;
      }
      if (lane == 0) {
        mbar_expect_tx(full + s, 2 * C::TILE);
        tma_tile<D>(sQ + s * kBQ * DT, &qmap, full + s, kBQ, hk * rep, row0 / rep, b);
        tma_tile<D>(sDO + s * kBQ * DT, &domap, full + s, kBQ, hk * rep, row0 / rep, b);
      } else {
        mbar_arrive(full + s);
      }
    }
    return;
  }

  const Block c{sK, sV, sQ, sDO, sStat, full, empty, b, hk, rep, total, k0, r_begin, n_tiles};
  mbar_wait(full_kv, 0);
  if constexpr (C::PASSES == 1) {
    consume<D, kDV | kDK>(p, c, warp, lane, 0);
  } else {
    consume<D, kDV>(p, c, warp, lane, 0);
    consume<D, kDK>(p, c, warp, lane, n_tiles);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const Params& p,
           cudaStream_t stream) {
  using C = Cfg<D>;
  const int rep = p.H / p.Hkv;
  if (kBQ % rep != 0) return kErrGroup;
  CUtensorMap qm, dom, km, vm;
  int err = make_map(&qm, q, p.B, p.Sq, p.H, D, rep, kBQ / rep);
  if (err == 0) err = make_map(&dom, dout, p.B, p.Sq, p.H, D, rep, kBQ / rep);
  if (err == 0) err = make_map(&km, k, p.B, p.Sk, p.Hkv, D, 1, kKeys);
  if (err == 0) err = make_map(&vm, v, p.B, p.Sk, p.Hkv, D, 1, kKeys);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkv_sm90_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((p.Sk + kKeys - 1) / kKeys) * p.B * p.Hkv;
  flash_bwd_dkv_sm90_kernel<D><<<grid, kThreads, C::SMEM, stream>>>(qm, dom, km, vm, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() after the
// launch (0 on success) or a negative code (flash_bwd_dkv_sm90_error_string).
int flash_bwd_dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, const float* dlse, const int* q_seg,
                       const int* kv_seg, void* dk, void* dv, int B, int H, int Hkv, int Sq,
                       int Sk, int D, int q_offset, int k_offset, int causal, float scale,
                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Params p{static_cast<bf16*>(dk), static_cast<bf16*>(dv), lse, delta, dlse, q_seg, kv_seg,
                 B, H, Hkv, Sq, Sk, q_offset, k_offset, causal, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, dout, p, s);
    case 32: return launch<32>(q, k, v, dout, p, s);
    case 40: return launch<40>(q, k, v, dout, p, s);
    case 64: return launch<64>(q, k, v, dout, p, s);
    case 80: return launch<80>(q, k, v, dout, p, s);
    case 128: return launch<128>(q, k, v, dout, p, s);
    case 160: return launch<160>(q, k, v, dout, p, s);
    default: return kErrHeadDim;
  }
}

const char* flash_bwd_dkv_sm90_error_string(int err) { return error_string(err); }

}  // extern "C"
