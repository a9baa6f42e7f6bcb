// FlashAttention backward, dQ, on Hopper's tensor cores through mma.sync
// (sm_90a): K2's "mma" variant, for the calls the wgmma kernel
// (flash_bwd_dq_sm90.cu) does not take — fp32, and bf16 GQA groups that do
// not divide 64.  K3 takes the same split (flash_bwd_dkv_mma_sm90.cu).
//
// Replaces the Pallas TPU kernel `_bwd_dq_kernel` in
// tpucfn/kernels/flash_attention.py for those calls, and computes what it
// computes: for each live (query, key) pair P = exp(S * scale - LSE) and
// dS = P * (dP - Delta + dLSE) * scale with dP = dO V^T, then dQ = sum over
// keys of dS K, with causality (int offsets), segment ids, the ragged Sq
// and Sk edges and rows that see nothing (P = 0 exactly, so dQ = 0, never
// NaN).  Each row's dQ is written once: no atomics, no repeated KV, the
// same result on every run.
//
// What bounds it on an H100.  At the shapes it takes (a few hundred packed
// rows per (batch row, KV head)) neither bytes nor operations: the bound is
// a few microseconds or less, and the time is the chain of dependent steps
// each CTA takes per key tile (loads, three products, barriers).  The
// design is K1 mma's (flash_fwd_mma_sm90.cu), with K in the role V plays
// there: query rows on M, a walk over key tiles, a result that belongs to
// the rows.
//  * Tensor cores at M = 16: a warp owns 16 packed rows, so any row count
//    and any GQA group fit.  A CTA has 1 to 4 warps (M tiles) on the same
//    keys; the packed row r of KV head hk is position r / rep, head
//    hk * rep + r % rep (position major, as in the forward), loaded row by
//    row.  Each row's LSE (times log2 e) and Delta - dLSE are read once
//    into registers; a row that sees nothing (the forward wrote LSE =
//    -1e30) or lies past the last carries LSE = +inf, so its P is exactly
//    0 with no compare.
//  * One CTA per (row block, KV head x batch row) walks every key its rows
//    can see; the keys are not split into chunks.
//  * K and V tiles staged with cp.async (16 bytes a thread) in a two-slot
//    ring, with the key segment ids in the same copy group: the next
//    tile's copies are in flight while this one computes, and one
//    block-wide barrier per tile both publishes a tile and frees the slot
//    of the one before.  No L2 eviction hint: every row block of a (batch
//    row, KV head) reads the same K and V, and ptxas 12.9 miscompiled
//    hinted copies in K3 mma (chip_smoke.py's SASS check).  Under
//    causality a row block stops at the last key its last row can see.
//  * Per tile and warp: S = Q K^T and dP = dO V^T on mma.sync; P and dS
//    are computed in their accumulator registers, which are the A
//    fragment of dQ += dS K, and dQ stays in fp32 registers for the walk.
//    Masks are computed only for tiles where one can apply (the Sk
//    edge, the causal diagonal, segment ids).
//  * bf16: mma.sync.m16n8k16 (fp32 accumulation), Q and dO held as A
//    fragments for the whole walk, K's and V's B fragments of S and dP by
//    ldmatrix and K's B fragment of dQ by ldmatrix.trans from XOR-swizzled
//    tiles; dS is rounded to bf16 as the A operand of dS K (the rounding
//    point of the sm90 variant and FlashAttention-2).
//  * fp32: 3xTF32 on mma.sync.m16n8k8 (sm90.cuh, split_tf32), which keeps
//    fp32 accuracy where plain TF32 keeps ~3 digits.  Q and dO stay in
//    shared memory and are split as they are read; tiles are fp32 rows
//    padded by 4 floats, read with 32-bit loads free of bank conflicts;
//    the key order inside each k-slice of dS K is permuted so that dS's
//    accumulator registers are its A fragment with no shuffle.
//  * Registers: dQ's accumulator is 64 a thread at D = 128 (80 at 160),
//    beside Q's and dO's fragments in bf16 (as many again), so D = 128 and
//    160 walk 32-key tiles (S and dP then take 16 registers each instead
//    of 32).
//
// Head dims 16, 32, 40, 64, 80, 128 and 160.  bf16 reduces over D in
// 16-column k-steps, so a D = 40 row (five 16-byte chunks) is staged as
// 48 columns, the sixth chunk zero-filled by cp.async, in a 64-column
// swizzled tile; fp32 (ten chunks a row) reduces in 8-column k-steps,
// which 40 fills.  80 and 160 are whole k-steps; their bf16 rows (10 and
// 20 chunks) are padded by one chunk where the others are swizzled.
// Products into D columns run over D / 8 n-tiles and store only those.
//
// Layout: q, dO, dQ (B, Sq, H, D); k, v (B, Sk, Hkv, D), one dtype (bf16
// or fp32), contiguous, 16-byte aligned; lse, delta, dlse (B, H, Sq) fp32
// (dlse may be null); q_seg (B, Sq), kv_seg (B, Sk) int32 or null.

#include <type_traits>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using sm90::cp_async16;
using sm90::cp_async4;
using sm90::cp_async_commit;
using sm90::cp_async_wait;
using sm90::exp2_ftz;
using sm90::ldsm_x2;
using sm90::ldsm_x2_trans;
using sm90::mma16816;
using sm90::mma1688_3xtf32;
using sm90::pack_bf16;
using sm90::smem_u32;
using sm90::split_tf32;
using sm90::store2;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRowsPerWarp = 16;  // packed rows of one warp: one mma M tile
constexpr int kMaxWarps = 4;      // M tiles per CTA
constexpr int kMaxRows = kMaxWarps * kRowsPerWarp;
constexpr int kSlots = 2;  // ring slots

constexpr int kErrHeadDim = -1;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  const float* dlse;  // null when LSE is not an output
  const int* q_seg;
  const int* kv_seg;
  void* dq;
  int B, H, Hkv, Sq, Sk, q_offset, k_offset, causal;
  float scale;
};

// Keys of one tile: 64, or 32 at D = 128 and 160 (registers).
template <int D>
constexpr int tile_keys() {
  return D >= 128 ? 32 : 64;
}

// Shared memory of one CTA: the ring (per slot a K tile, a V tile), fp32's
// Q and dO tiles, the key segment ids per slot.
template <typename T, int D>
struct Cfg {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int KEYS = tile_keys<D>();
  // bf16 reduces over D in 16-column k-steps, so D = 40 is staged as a
  // 48-column row, its last 16 bytes zero-filled, in a 64-column tile (the
  // XOR swizzle spans a power of two of 16-byte columns).
  static constexpr int DK = F32 ? D : (D + 15) / 16 * 16;   // columns reduced over
  static constexpr int DS = F32 || D != 40 ? D : 64;        // bf16 columns of a tile row
  // bf16 rows of a power of two of 16-byte columns are XOR-swizzled; the
  // 10 and 20 of D = 80 and 160 cannot be, so their rows are padded by one
  // 16-byte column, which puts any 8 consecutive rows on distinct banks.
  static constexpr bool SWZ = !F32 && (DS / 8 & (DS / 8 - 1)) == 0;
  static constexpr int PITCH = F32 ? (D + 4) * 4 : SWZ ? DS * 2 : DS * 2 + 16;  // bytes of a row
  static constexpr int QD = D * (int)sizeof(T) / 16;        // 16-byte columns of a row
  static constexpr int QZ = DK * (int)sizeof(T) / 16;       // ... staged (past QD: zeros)
  static constexpr int QN = DS / 8 < 8 ? DS / 8 : 8;        // bf16 swizzle span
  static constexpr int TILE = KEYS * PITCH;
  static constexpr int RING = kSlots * 2 * TILE;
  static constexpr int OFF_Q = RING;
  static constexpr int OFF_DO = OFF_Q + (F32 ? kMaxRows * PITCH : 0);
  static constexpr int OFF_SEG = OFF_DO + (F32 ? kMaxRows * PITCH : 0);
  static constexpr int SMEM = OFF_SEG + kSlots * KEYS * 4;
  // Byte offset of 16-byte column q of row `row` in a tile: fp32 rows and
  // bf16 rows at D = 80 and 160 are padded, the other bf16 rows
  // XOR-swizzled (ldmatrix reads both conflict-free).
  __device__ static uint32_t at(int row, int q) {
    if constexpr (SWZ) return row * PITCH + ((q ^ (row & (QN - 1))) << 4);
    else return row * PITCH + q * 16;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kMaxWarps * 32) flash_bwd_dq_mma_kernel(const Params p) {
  using C = Cfg<T, D>;
  constexpr int KEYS = C::KEYS, NT = KEYS / 8;  // n-tiles of S and dP per key tile
  constexpr int ND = D / 8;                     // n-tiles of dQ
  constexpr int FP = D + 4;                     // fp32 row pitch in floats
  extern __shared__ __align__(128) uint8_t smem[];
  const int rb = blockIdx.x, hk = blockIdx.y % p.Hkv, b = blockIdx.y / p.Hkv;
  const int warps = blockDim.x / 32, nthr = blockDim.x, tid = threadIdx.x;
  const int rep = p.H / p.Hkv, n_rows = p.Sq * rep;
  const int row0 = rb * warps * kRowsPerWarp;
  const int rows = min(warps * kRowsPerWarp, n_rows - row0);  // real rows of this CTA
  // Keys any row of the block can see: all Sk, or under causality up to
  // its last row's position.
  int n_keys = p.Sk;
  if (p.causal) {
    const long long live = (long long)p.q_offset + (row0 + rows - 1) / rep + 1 - p.k_offset;
    n_keys = live < p.Sk ? (int)(live > 0 ? live : 0) : p.Sk;
  }
  const int n_tiles = (n_keys + KEYS - 1) / KEYS;

  const int warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
  const int wrow = row0 + warp * kRowsPerWarp;  // the warp's first packed row
  const float sl2 = p.scale * kLog2e;
  const uint32_t ring = smem_u32(smem);
  const int* s_seg = reinterpret_cast<const int*>(smem + C::OFF_SEG);
  const char* K = static_cast<const char*>(p.k);
  const char* V = static_cast<const char*>(p.v);
  const T* Q = static_cast<const T*>(p.q);
  const T* DO = static_cast<const T*>(p.dout);
  // Element offset of packed row R in q, dO and dQ.
  auto row_at = [&](int R) {
    return ((size_t)(b * p.Sq + R / rep) * p.H + hk * rep + R % rep) * D;
  };

  // fp32: the CTA's Q and dO rows into shared memory, in the first copy
  // group; rows past the last are zero-filled.
  if constexpr (C::F32) {
    for (int i = tid; i < warps * kRowsPerWarp * C::QD; i += nthr) {
      const int r = i / C::QD, q = i % C::QD;
      const bool real = r < rows;
      const size_t src = row_at(real ? row0 + r : row0) + q * 4;
      cp_async16(ring + C::OFF_Q + C::at(r, q), Q + src, real ? 16 : 0);
      cp_async16(ring + C::OFF_DO + C::at(r, q), DO + src, real ? 16 : 0);
    }
  }
  // Tile j's K and V rows (and key segment ids) into slot j % 2, one copy
  // group per tile; keys past the live end are zero-filled.
  auto stage = [&](int j) {
    if (j < n_tiles) {
      const int k0 = j * KEYS;
      const uint32_t kt = ring + j % kSlots * 2 * C::TILE;
      for (int i = tid; i < KEYS * C::QZ; i += nthr) {
        const int key = i / C::QZ, q = i % C::QZ;
        const int kpos = min(k0 + key, n_keys - 1);
        const size_t src =
            (((size_t)(b * p.Sk + kpos) * p.Hkv + hk) * D) * sizeof(T) + (q < C::QD ? q : 0) * 16;
        const int bytes = k0 + key < n_keys && q < C::QD ? 16 : 0;
        cp_async16(kt + C::at(key, q), K + src, bytes);
        cp_async16(kt + C::TILE + C::at(key, q), V + src, bytes);
      }
      if (p.kv_seg != nullptr)
        for (int i = tid; i < KEYS; i += nthr) {
          const int kpos = min(k0 + i, n_keys - 1);
          cp_async4(smem_u32(s_seg + j % kSlots * KEYS + i), p.kv_seg + b * p.Sk + kpos,
                    k0 + i < n_keys ? 4 : 0);
        }
    }
    cp_async_commit();  // possibly empty: one group per tile keeps the count
  };
  stage(0);

  // The warp's rows g and g + 8: positions, query segment ids, LSE * log2 e
  // (+inf for a row that sees nothing or lies past the last: P = 0) and
  // Delta - dLSE.
  int qpos[2], qseg[2] = {0, 0};
  float l2[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int R = wrow + g + 8 * i;
    qpos[i] = R / rep;
    l2[i] = INFINITY;
    dd[i] = 0.f;
    if (R < n_rows) {
      const size_t idx = ((size_t)b * p.H + hk * rep + R % rep) * p.Sq + R / rep;
      const float lse = p.lse[idx];
      if (lse > 0.5f * kNegInf) l2[i] = lse * kLog2e;
      dd[i] = p.delta[idx] - (p.dlse != nullptr ? p.dlse[idx] : 0.f);
      if (p.q_seg != nullptr) qseg[i] = p.q_seg[b * p.Sq + qpos[i]];
    }
  }
  // bf16: Q's and dO's rows as A fragments (k-step kk: columns 16 kk + 2c,
  // + 1 and + 8, + 9), loaded once; rows past n_rows and columns past D
  // are zero.
  uint32_t qa[C::F32 ? 1 : C::DK / 16][4], da[C::F32 ? 1 : C::DK / 16][4];
  if constexpr (!C::F32) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int R = wrow + g + 8 * i;
      const bool real = R < n_rows;
      const uint32_t* qs = reinterpret_cast<const uint32_t*>(Q + row_at(real ? R : 0));
      const uint32_t* ds = reinterpret_cast<const uint32_t*>(DO + row_at(real ? R : 0));
#pragma unroll
      for (int kk = 0; kk < C::DK / 16; ++kk) {
        const bool hi = real && 16 * kk + 8 < D;  // columns 16 kk + 8 .. + 15 exist
        qa[kk][i] = real ? __ldg(qs + 8 * kk + c) : 0u;
        qa[kk][i + 2] = hi ? __ldg(qs + 8 * kk + 4 + c) : 0u;
        da[kk][i] = real ? __ldg(ds + 8 * kk + c) : 0u;
        da[kk][i + 2] = hi ? __ldg(ds + 8 * kk + 4 + c) : 0u;
      }
    }
  }

  // Keys up to this one are visible to every row of the warp.
  const long long all_visible = (long long)p.q_offset + wrow / rep - p.k_offset;
  const bool warp_live = wrow < n_rows;
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int lrow = lane % 8, lmat = lane / 8 % 2;  // ldmatrix row addresses
  const float* sQ = reinterpret_cast<const float*>(smem + C::OFF_Q) + warp * kRowsPerWarp * FP;
  const float* sDO = reinterpret_cast<const float*>(smem + C::OFF_DO) + warp * kRowsPerWarp * FP;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<0>();  // tile j has landed
    __syncthreads();     // ... for every thread, and every warp is done with tile j - 1
    stage(j + 1);        // into the slot tile j - 1 used
    if (!warp_live) continue;
    const int k0 = j * KEYS;
    const uint32_t kt = ring + j % kSlots * 2 * C::TILE, vt = kt + C::TILE;
    const float* sK = reinterpret_cast<const float*>(smem + (kt - ring));
    const float* sV = reinterpret_cast<const float*>(smem + (vt - ring));
    // S = Q K^T and dP = dO V^T: s[t][e] is row g + 8 (e / 2), key
    // k0 + 8t + 2c + e % 2.
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
    if constexpr (C::F32) {
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
        const float* qr = sQ + g * FP + 8 * ks + c;
        const float* dr = sDO + g * FP + 8 * ks + c;
        const float a[4] = {qr[0], qr[8 * FP], qr[4], qr[8 * FP + 4]};
        const float ad[4] = {dr[0], dr[8 * FP], dr[4], dr[8 * FP + 4]};
        uint32_t ab[4], as[4], db[4], dsm[4];
        split_tf32<4>(a, ab, as);
        split_tf32<4>(ad, db, dsm);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const float* kr = sK + (8 * t + g) * FP + 8 * ks + c;
          const float* vr = sV + (8 * t + g) * FP + 8 * ks + c;
          const float kv[2] = {kr[0], kr[4]}, vv[2] = {vr[0], vr[4]};
          uint32_t kb[2], ksm[2], vb[2], vsm[2];
          split_tf32<2>(kv, kb, ksm);
          split_tf32<2>(vv, vb, vsm);
          mma1688_3xtf32(s[t], ab, as, kb, ksm);
          mma1688_3xtf32(dp[t], db, dsm, vb, vsm);
        }
      }
    } else {
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int kk = 0; kk < C::DK / 16; ++kk) {
          uint32_t b0, b1;  // keys 8t .. 8t + 7 x columns 16 kk .. + 15
          ldsm_x2(kt + C::at(8 * t + lrow, 2 * kk + lmat), b0, b1);
          mma16816(s[t], qa[kk], b0, b1);
          ldsm_x2(vt + C::at(8 * t + lrow, 2 * kk + lmat), b0, b1);
          mma16816(dp[t], da[kk], b0, b1);
        }
    }
    // P = exp(S * scale - LSE) on live pairs, dS = P (dP - (Delta - dLSE))
    // * scale, in dP's registers.
    const bool masked = k0 + KEYS > n_keys || p.q_seg != nullptr ||
                        (p.causal && k0 + KEYS - 1 > all_visible);
    const int* seg = s_seg + j % kSlots * KEYS;
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2, key = 8 * t + 2 * c + (e & 1), kpos = k0 + key;
        float pr = exp2_ftz(fmaf(s[t][e], sl2, -l2[i]));
        if (masked) {
          bool keep = kpos < n_keys;
          if (keep && p.causal) keep = (long long)p.q_offset + qpos[i] >= (long long)p.k_offset + kpos;
          if (keep && p.q_seg != nullptr) keep = qseg[i] == seg[key];
          if (!keep) pr = 0.f;
        }
        dp[t][e] = pr * (dp[t][e] - dd[i]) * p.scale;
      }
    // dQ += dS K.
    if constexpr (C::F32) {
      // k-slice t is keys 8t .. 8t + 7, in the order 0, 2, 4, 6, 1, 3, 5, 7:
      // logical k = c is key 2c and k = c + 4 is key 2c + 1, so dS's
      // accumulators (row g / g + 8, keys 2c, 2c + 1) are its A fragment.
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const float a[4] = {dp[t][0], dp[t][2], dp[t][1], dp[t][3]};
        uint32_t ab[4], as[4];
        split_tf32<4>(a, ab, as);
        const float* kr = sK + (8 * t + 2 * c) * FP + g;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          const float bv[2] = {kr[8 * n], kr[FP + 8 * n]};
          uint32_t bb[2], bs[2];
          split_tf32<2>(bv, bb, bs);
          mma1688_3xtf32(acc[n], ab, as, bb, bs);
        }
      }
    } else {
      // dS's A fragment is its accumulators rounded to bf16; K's B fragment
      // for dQ's n-tile n by ldmatrix.trans of 16 keys.
#pragma unroll
      for (int kk = 0; kk < KEYS / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                                pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                                pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                                pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          uint32_t b0, b1;
          ldsm_x2_trans(kt + C::at(16 * kk + 8 * lmat + lrow, n), b0, b1);
          mma16816(acc[n], pa, b0, b1);
        }
      }
    }
  }

  cp_async_wait<0>();  // no copy may land after the CTA leaves
  T* dQ = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int R = wrow + g + 8 * i;
    if (R >= n_rows) continue;
    T* dst = dQ + row_at(R) + 2 * c;
#pragma unroll
    for (int n = 0; n < ND; ++n) store2(dst + 8 * n, acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

template <typename T, int D>
int launch(const Params& p, cudaStream_t s) {
  using C = Cfg<T, D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_mma_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const int m_tiles = (p.Sq * (p.H / p.Hkv) + kRowsPerWarp - 1) / kRowsPerWarp;
  const int warps = min(kMaxWarps, m_tiles);
  const dim3 grid((m_tiles + warps - 1) / warps, p.Hkv * p.B);
  flash_bwd_dq_mma_kernel<T, D><<<grid, warps * 32, C::SMEM, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const Params& p, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(p, s);
    case 32: return launch<T, 32>(p, s);
    case 40: return launch<T, 40>(p, s);
    case 64: return launch<T, 64>(p, s);
    case 80: return launch<T, 80>(p, s);
    case 128: return launch<T, 128>(p, s);
    case 160: return launch<T, 160>(p, s);
    default: return kErrHeadDim;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() after the
// launch (0 on success) or a negative code
// (flash_bwd_dq_mma_sm90_error_string).
int flash_bwd_dq_mma_sm90(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, const float* dlse,
                          const int* q_seg, const int* kv_seg, void* dq, int B, int H, int Hkv,
                          int Sq, int Sk, int D, int q_offset, int k_offset, int causal,
                          float scale, int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Params p{q,  k, v,   dout, lse, delta,    dlse,     q_seg,  kv_seg, dq,
                 B,  H, Hkv, Sq,   Sk,  q_offset, k_offset, causal, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_d<bf16>(D, p, s) : dispatch_d<float>(D, p, s);
}

const char* flash_bwd_dq_mma_sm90_error_string(int err) {
  switch (err) {
    case kErrHeadDim: return "unsupported head dim";
    default: return cudaGetErrorString((cudaError_t)err);
  }
}

}  // extern "C"
