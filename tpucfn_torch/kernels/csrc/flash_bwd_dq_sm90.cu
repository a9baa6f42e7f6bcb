// FlashAttention backward, dQ, on Hopper's tensor cores (sm_90a), bf16.
//
// Replaces the Pallas TPU kernel `_bwd_dq_kernel` in
// tpucfn/kernels/flash_attention.py for bf16 inputs whose GQA group size
// divides 64, the inputs on which flash_bwd_dkv_sm90.cu runs K3; the FMA
// kernel in flash_bwd.cu keeps fp32 and the other groups.  It computes
// what that kernel computes: for each live (query, key) pair
// P = exp(S * scale - LSE) and dS = P * (dP - Delta + dLSE) * scale with
// dP = dO V^T, then dQ = sum over keys of dS K, with causality (int
// offsets), segment ids, the ragged Sq and Sk edges and rows that see
// nothing (P = 0 exactly).  Each CTA owns its rows and writes their dQ
// once: no atomics, no repeated KV, the same result on every run.
//
// What bounds it on an H100.  Operations: three products of length D per
// live pair (6 * D flops: S = Q K^T, dP = dO V^T, dQ += dS K) against
// O(S * D) bytes.  At the llama3-1b training shape (B = 2, H = 32,
// S = 2048 causal, D = 64) that is 51.6 GFLOP, 0.0521 ms at 989 TFLOP/s.
// Only the tensor cores reach that rate, so all three products run on
// wgmma.  The design is FlashAttention-3's dQ without its atomics.
//  * One CTA per (64 GQA-packed query rows, KV head, batch row): a row is
//    one (query position, query head) pair of the KV head's group,
//    position major, as in the forward.  One consumer warpgroup holds dQ
//    in fp32 registers; a producer warp issues the loads.
//  * Q and dO are loaded once each by TMA, a 4-D box of 64 / rep
//    positions x rep heads (zero-filled past Sq).  Each row's LSE (times
//    log2 e) and Delta - dLSE are read once into the registers of the
//    threads that hold the row in the accumulator layout.
//  * K and V stream in 64-key tiles by TMA into a 2-stage ring guarded by
//    full/empty mbarriers, from key 0 up to the last key the block's last
//    row can see (the forward's causal truncation).  With segment ids the
//    producer stages each tile's key ids in shared memory beside it; each
//    row's query id is read once.
//  * S = Q K^T and dP = dO V^T are two wgmma chains from shared memory (all
//    four operands K-major).  P and dS are computed in their accumulator
//    registers, and dS, rounded to bf16, is the register A operand of
//    dQ += dS K, which reads K from the same shared tile as an MN-major
//    operand (as the forward reads V in O += P V).
//  * Software pipeline: S and dP of tile t + 1 are issued right behind dQ
//    of tile t.  K is read by two products of a tile (S and dQ), so a ring
//    stage is freed only once that tile's dQ group has completed, one
//    iteration later.  Because those groups cross the loop's back edge,
//    ptxas serializes the wgmma pipeline (C7515); a loop that retires
//    every group within its iteration avoids that, but at D = 64 it needs
//    148 registers a thread, which leaves two CTAs per SM, and ran slower.
//  * D = 32 tiles use the 64-byte swizzle; D = 40, 80 and 160 run on
//    zero-padded tiles of 64, 128 and 192 columns (sm90.cuh, tile_cols): S
//    and dP reduce over 48, 80 and 160 columns, dQ is accumulated over the
//    padded width and D are stored.
//  * Occupancy is what hides the latencies the serialized pipeline
//    exposes: at D <= 64 the kernel is held to 128 registers and a 2-stage
//    ring (50 KB of shared memory) so that three CTAs share an SM; on
//    tiles of 128 columns (D = 80, 128) the dQ accumulator doubles and one
//    CTA runs per SM, on 192 columns (D = 160) it is 96 registers a thread
//    beside 80 of S, dP and dS, in a 144 KB ring.
//  * Masks are computed only for tiles where one can apply (the ragged Sk
//    edge, the diagonal under causality, segment ids).  A row that sees
//    nothing (the forward wrote LSE = -1e30) or lies past Sq carries
//    LSE = +inf, so its P is exactly 0 without a compare.
//  * Row blocks are dispatched heaviest first: under causality the last
//    row block of every (KV head, batch row) in the first wave.
//
// Numerics.  Q K^T and dO V^T take exact bf16 inputs with fp32
// accumulation; dS is rounded to bf16 as the operand of dS K (as
// FlashAttention-2 and -3 do); accumulation is fp32; dQ is rounded to bf16
// once.
//
// Layout: q, dO, dQ (B, Sq, H, D); k, v (B, Sk, Hkv, D), bf16, contiguous,
// 16-byte aligned; lse, delta, dlse (B, H, Sq) fp32 (dlse may be null);
// q_seg (B, Sq), kv_seg (B, Sk) int32 or null.

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 64;      // packed query rows per CTA: the M of every product
constexpr int kKeys = 64;      // keys per K/V tile
constexpr int kStages = 2;     // K/V ring depth (three CTAs per SM hide the loads)
constexpr int kThreads = 160;  // warps 0-3 consume, warp 4 produces

template <int D>
struct Cfg {
  static constexpr int DT = tile_cols(D);   // columns of a shared-memory tile
  static constexpr int TILE = 64 * DT * 2;  // bytes of one 64 x DT bf16 tile
  static constexpr int MIN_CTAS = DT >= 128 ? 1 : 3;  // CTAs an SM holds (registers)
  static constexpr int OFF_DO = TILE;
  static constexpr int OFF_K = 2 * TILE;  // every tile starts 1024-aligned
  static constexpr int OFF_V = OFF_K + kStages * TILE;
  static constexpr int OFF_SEG = OFF_V + kStages * TILE;  // kKeys key ids per stage
  static constexpr int OFF_BAR = OFF_SEG + kStages * kKeys * 4;
  static constexpr int SMEM = OFF_BAR + 8 * (1 + 3 * kStages) + 1024;  // + alignment slack
};

struct Params {
  bf16* dq;
  const float* lse;
  const float* delta;
  const float* dlse;
  const int* q_seg;
  const int* kv_seg;
  int B, H, Hkv, Sq, Sk, q_offset, k_offset, causal, n_rb;
  float scale;
};

template <int D>
__global__ void __launch_bounds__(kThreads, Cfg<D>::MIN_CTAS)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap domap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap, const Params p) {
  using C = Cfg<D>;
  constexpr int DT = C::DT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDO = reinterpret_cast<bf16*>(smem + C::OFF_DO);
  bf16* sK = reinterpret_cast<bf16*>(smem + C::OFF_K);
  bf16* sV = reinterpret_cast<bf16*>(smem + C::OFF_V);
  int* sSeg = reinterpret_cast<int*>(smem + C::OFF_SEG);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;

  // Heaviest first: the last row block of every (KV head, batch row), then
  // the one before, and so on.
  const int bhs = p.B * p.Hkv;
  const int rb = p.n_rb - 1 - (int)(blockIdx.x / bhs);
  const int hk = blockIdx.x % bhs % p.Hkv, b = blockIdx.x % bhs / p.Hkv;
  const int rep = p.H / p.Hkv;
  const int total = p.Sq * rep;
  const int row0 = rb * kRows;
  const int rows = min(kRows, total - row0);  // real rows of this block
  int n_keys = p.Sk;  // keys this block can see (the causal truncation)
  if (p.causal) {
    const long long live = (long long)p.q_offset + (row0 + rows - 1) / rep + 1 - p.k_offset;
    if (live < n_keys) n_keys = (int)(live > 0 ? live : 0);
  }
  const int n_tiles = (n_keys + kKeys - 1) / kKeys;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + s, 32);  // the producer warp's lanes (key ids), one with the TMA bytes
      mbar_init(full_v + s, 1);
      mbar_init(empty + s, 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {  // producer
    if (lane == 0) {
      prefetch_map(&kmap);
      prefetch_map(&vmap);
      mbar_expect_tx(full_q, 2 * C::TILE);
      tma_tile<D>(sQ, &qmap, full_q, kRows, hk * rep, row0 / rep, b);
      tma_tile<D>(sDO, &domap, full_q, kRows, hk * rep, row0 / rep, b);
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      if (t >= kStages) mbar_wait(empty + s, ((t / kStages) & 1) ^ 1);
      if (p.q_seg != nullptr) {
        for (int c = lane; c < kKeys; c += 32) {
          const int kp = t * kKeys + c;
          sSeg[s * kKeys + c] = kp < p.Sk ? p.kv_seg[b * p.Sk + kp] : 0;  // past Sk: masked anyway
        }
      }
      if (lane == 0) {
        mbar_expect_tx(full_k + s, C::TILE);
        tma_tile<D>(sK + s * kKeys * DT, &kmap, full_k + s, kKeys, hk, t * kKeys, b);
        mbar_expect_tx(full_v + s, C::TILE);
        tma_tile<D>(sV + s * kKeys * DT, &vmap, full_v + s, kKeys, hk, t * kKeys, b);
      } else {
        mbar_arrive(full_k + s);
      }
    }
    return;
  }

  // Consumers: thread (warp, lane) holds rows r and r + 8 of the block,
  // r = 16 warp + lane / 4, and columns 8 n + 2 (lane % 4) + {0, 1} of
  // every 8-column chunk n of each accumulator: keys of the S / dP tiles,
  // head-dim columns of dQ.
  const int r_lo = warp * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  int qpos[2], qseg[2] = {0, 0};
  float l2[2], dl[2];  // LSE * log2 e (+inf: P = 0) and Delta - dLSE per row
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int R = row0 + r_lo + 8 * i;
    qpos[i] = R / rep;
    l2[i] = INFINITY;  // rows past Sq
    dl[i] = 0.f;
    if (R < total) {
      const size_t idx = ((size_t)b * p.H + hk * rep + R % rep) * p.Sq + qpos[i];
      const float lse = p.lse[idx];
      if (lse > 0.5f * kNegInf) l2[i] = lse * kLog2e;  // a row that sees nothing: P = 0
      dl[i] = p.delta[idx] - (p.dlse != nullptr ? p.dlse[idx] : 0.f);
      if (p.q_seg != nullptr) qseg[i] = p.q_seg[b * p.Sq + qpos[i]];
    }
  }
  const float scale_log2 = p.scale * kLog2e;
  // Keys up to this position are visible to every row of the block.
  const long long first_visible = (long long)p.q_offset + row0 / rep - p.k_offset;

  float dq[DT / 2];
#pragma unroll
  for (int i = 0; i < DT / 2; ++i) dq[i] = 0.f;
  float s[kKeys / 2], dp[kKeys / 2];  // S then P; dP then dS

  // S = Q K_t^T and dP = dO V_t^T, issued as two committed groups.
  auto issue_sdp = [&](int t) {
    const int st = t % kStages;
    mbar_wait(full_k + st, (t / kStages) & 1);
    mbar_wait(full_v + st, (t / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < k_steps(D); ++kk)
      wgmma_ss<kKeys>(s, desc_kmajor<D>(sQ, kRows, kk),
                      desc_kmajor<D>(sK + st * kKeys * DT, kKeys, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < k_steps(D); ++kk)
      wgmma_ss<kKeys>(dp, desc_kmajor<D>(sDO, kRows, kk),
                      desc_kmajor<D>(sV + st * kKeys * DT, kKeys, kk), kk > 0);
    wgmma_commit();
  };

  // Software pipeline: S and dP of tile t + 1 are issued right behind dQ
  // of tile t, so the tensor cores run on while P of the next tile is
  // computed.  At the top of iteration t the groups in flight are dQ of
  // tile t - 1, then S and dP of tile t.
  mbar_wait(full_q, 0);
  if (n_tiles > 0) issue_sdp(0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    const int k0 = t * kKeys;
    wgmma_wait<1>();  // dQ of tile t - 1 and S of tile t
    fence_regs<kKeys / 2>(s);
    if (t > 0 && lane == 0) mbar_arrive(empty + (t - 1) % kStages);

    // P = exp(S * scale - LSE[row]) on live pairs.
    const bool masked = k0 + kKeys > p.Sk ||
                        (p.causal && (long long)k0 + kKeys - 1 > first_visible) ||
                        p.q_seg != nullptr;
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2, c = 8 * n + col0 + (e & 1);
        float pr = exp2_ftz(fmaf(s[4 * n + e], scale_log2, -l2[i]));
        if (masked) {
          const int kpos = k0 + c;
          bool keep = kpos < p.Sk;
          if (p.causal) keep = keep && (long long)p.q_offset + qpos[i] >= (long long)p.k_offset + kpos;
          if (p.q_seg != nullptr) keep = keep && qseg[i] == sSeg[st * kKeys + c];
          if (!keep) pr = 0.f;
        }
        s[4 * n + e] = pr;
      }
    wgmma_wait<0>();  // dP of tile t
    fence_regs<kKeys / 2>(dp);
    // dS = P (dP - (Delta - dLSE)[row]) * scale, rounded to bf16 fragments.
    uint32_t da[kKeys / 16][4];
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[4 * n + e] = s[4 * n + e] * (dp[4 * n + e] - dl[e / 2]) * p.scale;
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) a_frag(dp, kk, da[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      wgmma_rs<DT>(dq, da[kk], desc_mnmajor<D>(sK + st * kKeys * DT, kKeys, kk));
    wgmma_commit();
    if (t + 1 < n_tiles) issue_sdp(t + 1);
  }
  wgmma_wait<0>();
  fence_regs<DT / 2>(dq);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_lo + 8 * i, R = row0 + r;
    if (r >= rows) continue;
    bf16* row = p.dq + ((size_t)(b * p.Sq + R / rep) * p.H + hk * rep + R % rep) * D + col0;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(row + 8 * n) = pack_bf16(dq[4 * n + 2 * i], dq[4 * n + 2 * i + 1]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, Params p,
           cudaStream_t stream) {
  using C = Cfg<D>;
  const int rep = p.H / p.Hkv;
  if (kRows % rep != 0) return kErrGroup;
  CUtensorMap qm, dom, km, vm;
  int err = make_map(&qm, q, p.B, p.Sq, p.H, D, rep, kRows / rep);
  if (err == 0) err = make_map(&dom, dout, p.B, p.Sq, p.H, D, rep, kRows / rep);
  if (err == 0) err = make_map(&km, k, p.B, p.Sk, p.Hkv, D, 1, kKeys);
  if (err == 0) err = make_map(&vm, v, p.B, p.Sk, p.Hkv, D, 1, kKeys);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_sm90_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  p.n_rb = (p.Sq * rep + kRows - 1) / kRows;
  const unsigned grid = (unsigned)p.n_rb * p.B * p.Hkv;
  flash_bwd_dq_sm90_kernel<D><<<grid, kThreads, C::SMEM, stream>>>(qm, dom, km, vm, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() after the
// launch (0 on success) or a negative code (flash_bwd_dq_sm90_error_string).
int flash_bwd_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, const float* dlse, const int* q_seg,
                      const int* kv_seg, void* dq, int B, int H, int Hkv, int Sq, int Sk, int D,
                      int q_offset, int k_offset, int causal, float scale, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Params p{static_cast<bf16*>(dq), lse, delta, dlse, q_seg, kv_seg, B, H, Hkv, Sq, Sk,
                 q_offset, k_offset, causal, 0, scale};
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

const char* flash_bwd_dq_sm90_error_string(int err) { return error_string(err); }

}  // extern "C"
