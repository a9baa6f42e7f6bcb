// FlashAttention backward, dK and dV, on Hopper's tensor cores through
// mma.sync (sm_90a): K3's "mma" variant, for the calls the wgmma kernel
// (flash_bwd_dkv_sm90.cu) does not take — fp32, and bf16 GQA groups that
// do not divide 64.
//
// Replaces the Pallas TPU kernel `_bwd_dkv_kernel` in
// tpucfn/kernels/flash_attention.py for those calls, and computes what it
// computes: for each live (query, key) pair P = exp(S * scale - LSE) and
// dS = P * (dP - Delta + dLSE) * scale, then dV = P^T dO and dK = dS^T Q
// summed over every query head of the KV head's group, with causality (int
// offsets), segment ids, the ragged edges and rows that attend to nothing
// (P = 0 exactly, never NaN).  Each CTA writes its dK and dV rows once: no
// atomics, no repeated KV.
//
// What bounds it on an H100.  At the shapes it takes (a few hundred packed
// rows per (batch row, KV head)) neither bytes nor operations: the bound
// is a few microseconds or less, and the time is the chain of dependent
// steps each warp takes over the query rows.  The design keeps it short.
//  * One CTA of 4 warps per (16-key block, KV head, batch row).  Its warps
//    share the block's keys, the M of every product, and keep their dK
//    and dV in fp32 registers; each takes a quarter of every staged row
//    tile, which cuts the chain over the rows four-fold, and the four
//    partial dK and dV are summed once through shared memory at the end,
//    in warp order.
//  * The group's packed query rows (position major, as in the forward:
//    row r is position r / rep, head hk * rep + r % rep, gathered row by
//    row, so any group size costs nothing extra) are streamed in tiles
//    through a two-slot cp.async ring (no L2 eviction hint: every key
//    block's CTA reads the same rows, and ptxas 12.9 miscompiled the
//    hinted copies of this kernel, see chip_smoke.py's SASS check), with
//    each row's LSE, Delta, dLSE and query segment id staged beside them;
//    the next tile's copies are in flight while this one computes, and one
//    block-wide barrier per tile publishes it and frees the slot of the
//    one before.  Under causality a key block starts at the first row
//    that can see it.
//  * Per tile and warp: S^T = K Q^T and dP^T = V dO^T on mma.sync, so
//    P^T and dS^T land in the accumulator layout, which is the A operand
//    layout of dV += P^T dO and dK += dS^T Q.  Masks are computed only
//    where one can apply (the Sk edge, the causal diagonal, segment ids);
//    key segment ids are read once into registers.
//  * bf16: mma.sync.m16n8k16, A fragments of K and V by ldmatrix, Q and dO
//    as B by ldmatrix (S^T, dP^T) and ldmatrix.trans (dK, dV) from
//    XOR-swizzled tiles; P^T and dS^T are rounded to bf16 as operands of
//    the second products (as the sm90 variant and FlashAttention-2 do).
//  * fp32: 3xTF32 on mma.sync.m16n8k8 (sm90.cuh, split_tf32), which keeps
//    fp32 accuracy; tiles are fp32 rows padded by 4 floats, read with
//    32-bit loads free of bank conflicts, and the row order inside each
//    k-slice of the second products is permuted so that P^T's and dS^T's
//    accumulator registers are their A fragments with no shuffle.
//
// Head dims 16, 32, 40, 64, 80, 128 and 160.  bf16 reduces over D in
// 16-column k-steps, so a D = 40 row (five 16-byte chunks) is staged as
// 48 columns, the sixth chunk zero-filled by cp.async, in a 64-column
// swizzled tile; fp32 (ten chunks a row) reduces in 8-column k-steps,
// which 40 fills.  80 and 160 are whole k-steps; their bf16 rows (10 and
// 20 chunks) are padded by one chunk where the others are swizzled.
// Products into D columns run over D / 8 n-tiles and store only those.
//
// Layout: q, dO (B, Sq, H, D); k, v, dK, dV (B, Sk, Hkv, D), one dtype
// (bf16 or fp32), contiguous, 16-byte aligned; lse, delta, dlse (B, H, Sq)
// fp32 (dlse may be null); q_seg (B, Sq), kv_seg (B, Sk) int32 or null.

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
using sm90::ldsm_x4;
using sm90::mma16816;
using sm90::mma1688_3xtf32;
using sm90::pack_bf16;
using sm90::smem_u32;
using sm90::split_tf32;
using sm90::store2;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpKeys = 16;  // keys of a CTA, shared by its warps: one mma M tile
constexpr int kSlots = 2;      // ring slots

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
  void* dk;
  void* dv;
  int B, H, Hkv, Sq, Sk, q_offset, k_offset, causal;
  float scale;
};

// Shared memory of one CTA: the key block's K and V tiles, then the ring
// (per slot a Q tile, a dO tile and the rows' LSE, Delta, dLSE and segment
// ids); after the walk, the other warps' dK and dV over its start.
template <typename T, int D>
struct Cfg {
  static constexpr bool F32 = std::is_same<T, float>::value;
  // Rows of a staged tile, 128 (64 for fp32 at D = 128 and 160: shared
  // memory; for bf16 at D = 160: registers, beside dK and dV's 160), and of
  // one warp's quarter of it.
  static constexpr int ROWS = (F32 ? D >= 128 : D > 128) ? 64 : 128;
  static constexpr int BQ = ROWS / kWarps;
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
  static constexpr int OFF_V = kWarpKeys * PITCH;
  static constexpr int OFF_RING = 2 * kWarpKeys * PITCH;
  static constexpr int TILE = ROWS * PITCH;
  static constexpr int STATS = 4 * ROWS * 4;  // lse, delta, dlse, q_seg
  static constexpr int SLOT = 2 * TILE + STATS;
  static constexpr int MAIN = OFF_RING + kSlots * SLOT;
  static constexpr int RED = (kWarps - 1) * 2 * kWarpKeys * D * 4;
  static constexpr int SMEM = MAIN > RED ? MAIN : RED;
  __device__ static uint32_t at(int row, int q) {
    if constexpr (SWZ) return row * PITCH + ((q ^ (row & (QN - 1))) << 4);
    else return row * PITCH + q * 16;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_mma_kernel(const Params p) {
  using C = Cfg<T, D>;
  constexpr int BQ = C::BQ, NT = BQ / 8, ND = D / 8;
  constexpr int FP = D + 4;  // fp32 row pitch in floats
  extern __shared__ __align__(128) uint8_t smem[];
  const int bhs = p.B * p.Hkv;
  const int kb = blockIdx.x / bhs;  // heaviest first: key block 0 of every (head, row) first
  const int hk = blockIdx.x % bhs % p.Hkv, b = blockIdx.x % bhs / p.Hkv;
  const int rep = p.H / p.Hkv, total = p.Sq * rep;
  const int k0 = kb * kWarpKeys;
  int r_begin = 0;  // the first packed row that can see this block's first key
  if (p.causal) {
    const long long first = (long long)p.k_offset + k0 - p.q_offset;
    if (first > 0) r_begin = (int)(first < p.Sq ? first : p.Sq) * rep;
  }
  const int n_tiles = (total - r_begin + C::ROWS - 1) / C::ROWS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
  const int wr = warp * BQ;  // the warp's first row in a tile
  const uint32_t base = smem_u32(smem);
  const size_t qrow = (size_t)D * sizeof(T);  // bytes of a row

  // The block's K and V rows, in the first copy group; keys past Sk are
  // zero-filled.
  for (int i = tid; i < kWarpKeys * C::QZ; i += kThreads) {
    const int key = i / C::QZ, q = i % C::QZ, kpos = min(k0 + key, p.Sk - 1);
    const size_t src = ((size_t)(b * p.Sk + kpos) * p.Hkv + hk) * qrow + (q < C::QD ? q : 0) * 16;
    const int bytes = k0 + key < p.Sk && q < C::QD ? 16 : 0;
    cp_async16(base + C::at(key, q), static_cast<const char*>(p.k) + src, bytes);
    cp_async16(base + C::OFF_V + C::at(key, q), static_cast<const char*>(p.v) + src, bytes);
  }
  // Tile j's rows of Q and dO and their statistics into slot j % 2, one
  // copy group per tile; rows past the last are zero-filled (zero Q and
  // dO rows add nothing to dK or dV).
  auto stage = [&](int j) {
    if (j < n_tiles) {
      const int row0 = r_begin + j * C::ROWS;
      const uint32_t slot = base + C::OFF_RING + j % kSlots * C::SLOT;
      for (int i = tid; i < C::ROWS * C::QZ; i += kThreads) {
        const int r = i / C::QZ, q = i % C::QZ, R = min(row0 + r, total - 1);
        const size_t src = ((size_t)(b * p.Sq + R / rep) * p.H + hk * rep + R % rep) * qrow +
                           (q < C::QD ? q : 0) * 16;
        const int bytes = row0 + r < total && q < C::QD ? 16 : 0;
        cp_async16(slot + C::at(r, q), static_cast<const char*>(p.q) + src, bytes);
        cp_async16(slot + C::TILE + C::at(r, q), static_cast<const char*>(p.dout) + src, bytes);
      }
      const uint32_t st = slot + 2 * C::TILE;
      for (int r = tid; r < C::ROWS; r += kThreads) {
        const int R = min(row0 + r, total - 1), bytes = row0 + r < total ? 4 : 0;
        const size_t idx = ((size_t)b * p.H + hk * rep + R % rep) * p.Sq + R / rep;
        cp_async4(st + 4 * r, p.lse + idx, bytes);
        cp_async4(st + 4 * (C::ROWS + r), p.delta + idx, bytes);
        if (p.dlse != nullptr) cp_async4(st + 4 * (2 * C::ROWS + r), p.dlse + idx, bytes);
        if (p.q_seg != nullptr)
          cp_async4(st + 4 * (3 * C::ROWS + r), p.q_seg + b * p.Sq + R / rep, bytes);
      }
    }
    cp_async_commit();  // possibly empty: one group per tile keeps the count
  };
  stage(0);

  // Thread (warp, lane) holds keys g and g + 8 of the block (the
  // accumulator rows), and columns 8n + 2c + {0, 1}: query rows of S^T and
  // dP^T, head-dim columns of dK and dV.
  int kpos[2], kseg[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    kpos[i] = k0 + g + 8 * i;
    if (p.q_seg != nullptr && kpos[i] < p.Sk) kseg[i] = p.kv_seg[b * p.Sk + kpos[i]];
  }
  const float sl2 = p.scale * kLog2e;
  const long long first_key = (long long)p.k_offset + k0;
  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const int lrow = lane % 8, lmat = lane / 8 % 2;  // ldmatrix row addresses
  const float* sK = reinterpret_cast<const float*>(smem);
  const float* sV = reinterpret_cast<const float*>(smem + C::OFF_V);

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<0>();  // tile j (and the key block) has landed
    __syncthreads();     // ... for every thread, and every warp is done with tile j - 1
    stage(j + 1);        // into the slot tile j - 1 used
    const int row0 = r_begin + j * C::ROWS + wr;  // the warp's first packed row
    if (row0 >= total) continue;
    const int last = min(row0 + BQ, total) - 1;
    if (p.causal && (long long)p.q_offset + last / rep < first_key) continue;  // sees none
    const int so = C::OFF_RING + j % kSlots * C::SLOT;
    const uint32_t qt = base + so, dot = qt + C::TILE;
    const float* stat = reinterpret_cast<const float*>(smem + so + 2 * C::TILE);

    // S^T = K Q^T, dP^T = V dO^T: s[t][e] is key g + 8 (e / 2), row
    // row0 + 8t + 2c + e % 2.
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
    if constexpr (C::F32) {
      const float* sQ = reinterpret_cast<const float*>(smem + so) + wr * FP;
      const float* sDO = sQ + C::TILE / 4;
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
        const float* kr = sK + g * FP + 8 * ks + c;
        const float* vr = sV + g * FP + 8 * ks + c;
        const float ka[4] = {kr[0], kr[8 * FP], kr[4], kr[8 * FP + 4]};
        const float va[4] = {vr[0], vr[8 * FP], vr[4], vr[8 * FP + 4]};
        uint32_t kab[4], kas[4], vab[4], vas[4];
        split_tf32<4>(ka, kab, kas);
        split_tf32<4>(va, vab, vas);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const float* qr = sQ + (8 * t + g) * FP + 8 * ks + c;
          const float* dr = sDO + (8 * t + g) * FP + 8 * ks + c;
          const float qb[2] = {qr[0], qr[4]}, db[2] = {dr[0], dr[4]};
          uint32_t qbb[2], qbs[2], dbb[2], dbs[2];
          split_tf32<2>(qb, qbb, qbs);
          split_tf32<2>(db, dbb, dbs);
          mma1688_3xtf32(s[t], kab, kas, qbb, qbs);
          mma1688_3xtf32(dp[t], vab, vas, dbb, dbs);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < C::DK / 16; ++kk) {
        // K's and V's A fragments: the block's 16 keys x columns 16 kk .. + 15.
        uint32_t ka[4], va[4];
        const int arow = lrow + 8 * lmat, acol = 2 * kk + lane / 16;
        ldsm_x4(base + C::at(arow, acol), ka);
        ldsm_x4(base + C::OFF_V + C::at(arow, acol), va);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          uint32_t b0, b1;  // rows 8t .. 8t + 7 x columns 16 kk .. + 15
          ldsm_x2(qt + C::at(wr + 8 * t + lrow, 2 * kk + lmat), b0, b1);
          mma16816(s[t], ka, b0, b1);
          ldsm_x2(dot + C::at(wr + 8 * t + lrow, 2 * kk + lmat), b0, b1);
          mma16816(dp[t], va, b0, b1);
        }
      }
    }

    // P^T = exp(S^T * scale - LSE[row]) on live pairs (0 for rows that
    // see nothing), dS^T = P^T (dP^T - (Delta - dLSE)[row]) * scale.
    const bool masked = k0 + kWarpKeys > p.Sk || p.q_seg != nullptr ||
                        (p.causal && (long long)p.q_offset + row0 / rep < first_key + kWarpKeys - 1);
    const int* sseg = reinterpret_cast<const int*>(stat + 3 * C::ROWS);
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int r = wr + 8 * t + 2 * c + e2;  // row in the tile
        const float lse = stat[r];
        const float l2 = lse > 0.5f * kNegInf ? lse * kLog2e : INFINITY;
        const float dd = stat[C::ROWS + r] - (p.dlse != nullptr ? stat[2 * C::ROWS + r] : 0.f);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 2 * i + e2;
          float pr = exp2_ftz(fmaf(s[t][e], sl2, -l2));
          if (masked) {
            const int R = row0 - wr + r;
            bool keep = kpos[i] < p.Sk;
            if (p.causal) keep = keep && (long long)p.q_offset + R / rep >= (long long)p.k_offset + kpos[i];
            if (p.q_seg != nullptr) keep = keep && sseg[r] == kseg[i];
            if (!keep) pr = 0.f;
          }
          s[t][e] = pr;
          dp[t][e] = pr * (dp[t][e] - dd) * p.scale;
        }
      }

    // dV += P^T dO, dK += dS^T Q.
    if constexpr (C::F32) {
      // k-slice t is rows 8t .. 8t + 7 in the order 0, 2, 4, 6, 1, 3, 5, 7:
      // logical k = c is row 2c and k = c + 4 is row 2c + 1, so the
      // accumulators of P^T and dS^T are their A fragments.
      const float* sQ = reinterpret_cast<const float*>(smem + so) + wr * FP;
      const float* sDO = sQ + C::TILE / 4;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const float pa[4] = {s[t][0], s[t][2], s[t][1], s[t][3]};
        const float da[4] = {dp[t][0], dp[t][2], dp[t][1], dp[t][3]};
        uint32_t pab[4], pas[4], dab[4], das[4];
        split_tf32<4>(pa, pab, pas);
        split_tf32<4>(da, dab, das);
        const float* dor = sDO + (8 * t + 2 * c) * FP + g;
        const float* qr = sQ + (8 * t + 2 * c) * FP + g;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          const float ob[2] = {dor[8 * n], dor[FP + 8 * n]}, qb[2] = {qr[8 * n], qr[FP + 8 * n]};
          uint32_t obb[2], obs[2], qbb[2], qbs[2];
          split_tf32<2>(ob, obb, obs);
          split_tf32<2>(qb, qbb, qbs);
          mma1688_3xtf32(dv[n], pab, pas, obb, obs);
          mma1688_3xtf32(dk[n], dab, das, qbb, qbs);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const uint32_t da[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                                pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                                pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                                pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
        const int brow = wr + 16 * kk + 8 * lmat + lrow;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          uint32_t b0, b1;
          ldsm_x2_trans(dot + C::at(brow, n), b0, b1);
          mma16816(dv[n], pa, b0, b1);
          ldsm_x2_trans(qt + C::at(brow, n), b0, b1);
          mma16816(dk[n], da, b0, b1);
        }
      }
    }
  }

  // The other warps' dK and dV are added to the first one's through shared
  // memory (over the tiles, once no copy is in flight and every warp is
  // done), in warp order.
  constexpr int KD = kWarpKeys * D;  // floats of one warp's dK (or dV)
  cp_async_wait<0>();
  __syncthreads();
  if (warp > 0) {
    float* red = reinterpret_cast<float*>(smem) + (warp - 1) * 2 * KD;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int idx = (g + 8 * i) * D + 8 * n + 2 * c;
        *reinterpret_cast<float2*>(red + idx) = make_float2(dk[n][2 * i], dk[n][2 * i + 1]);
        *reinterpret_cast<float2*>(red + KD + idx) = make_float2(dv[n][2 * i], dv[n][2 * i + 1]);
      }
  }
  __syncthreads();
  if (warp > 0) return;
#pragma unroll
  for (int w = 1; w < kWarps; ++w)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const float* part = reinterpret_cast<const float*>(smem) + (w - 1) * 2 * KD;
        const int idx = (g + 8 * i) * D + 8 * n + 2 * c;
        const float2 rk = *reinterpret_cast<const float2*>(part + idx);
        const float2 rv = *reinterpret_cast<const float2*>(part + KD + idx);
        dk[n][2 * i] += rk.x, dk[n][2 * i + 1] += rk.y;
        dv[n][2 * i] += rv.x, dv[n][2 * i + 1] += rv.y;
      }

  T* dK = static_cast<T*>(p.dk);
  T* dV = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (kpos[i] >= p.Sk) continue;
    const size_t off = ((size_t)(b * p.Sk + kpos[i]) * p.Hkv + hk) * D + 2 * c;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      store2(dK + off + 8 * n, dk[n][2 * i], dk[n][2 * i + 1]);
      store2(dV + off + 8 * n, dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
}

template <typename T, int D>
int launch(const Params& p, cudaStream_t s) {
  using C = Cfg<T, D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_mma_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const unsigned grid = (unsigned)((p.Sk + kWarpKeys - 1) / kWarpKeys) * p.B * p.Hkv;
  flash_bwd_dkv_mma_kernel<T, D><<<grid, kThreads, C::SMEM, s>>>(p);
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
// (flash_bwd_dkv_mma_sm90_error_string).
int flash_bwd_dkv_mma_sm90(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, const float* dlse,
                           const int* q_seg, const int* kv_seg, void* dk, void* dv, int B, int H,
                           int Hkv, int Sq, int Sk, int D, int q_offset, int k_offset, int causal,
                           float scale, int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Params p{q,  k, v, dout, lse, delta, dlse,     q_seg,    kv_seg, dk,   dv,
                 B,  H, Hkv, Sq, Sk, q_offset, k_offset, causal, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_d<bf16>(D, p, s) : dispatch_d<float>(D, p, s);
}

const char* flash_bwd_dkv_mma_sm90_error_string(int err) {
  switch (err) {
    case kErrHeadDim: return "unsupported head dim";
    default: return cudaGetErrorString((cudaError_t)err);
  }
}

}  // extern "C"
