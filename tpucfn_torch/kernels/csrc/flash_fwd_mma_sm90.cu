// FlashAttention forward on Hopper's tensor cores through mma.sync (sm_90a):
// K1's "mma" variant, for the calls the other two tensor-core variants do
// not take — fp32 at any size, bf16 with 17 to 63 packed query rows per
// (batch row, KV head) (a speculative-decoding verify pass), and bf16 GQA
// groups that do not divide 64.  bf16 with at most 16 rows runs
// flash_fwd_decode_sm90.cu, bf16 with at least 64 and a group dividing 64
// runs flash_fwd_sm90.cu.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in
// tpucfn/kernels/flash_attention.py (launched by `_flash_fwd`) for those
// calls, and computes all of its function: O = softmax(mask(Q K^T *
// D^-1/2)) V and fp32 LSE = m + log l, causality with a per-row query
// offset read from device memory plus a key offset, segment ids, the Sk
// edge, GQA position-major row packing with no KV repeat, and O = 0,
// LSE = NEG_INF (-1e30, finite) for rows that attend to nothing.
//
// What bounds it on an H100.  At the shapes it takes (a few hundred
// packed rows at most per (batch row, KV head), or a verify pass over a
// long cache) neither bytes nor operations: the bound is a few
// microseconds or less, and the time is the chain of dependent steps each
// CTA takes per key tile (loads, products, the softmax, barriers).  The
// design keeps that chain short.
//
// What the design does about it.
//  * Tensor cores at M = 16: a warp owns 16 packed rows, so any row count
//    and any GQA group fit (a wgmma tile takes 64 rows and a TMA box
//    aligned to the group).  A CTA has 1 to 4 warps (M tiles) on the same
//    keys; the packed row r of KV head hk is position r / rep, head
//    hk * rep + r % rep, loaded row by row, so rows of a tile need not
//    share a position.
//  * Keys split into chunks when the row blocks alone would not fill the
//    card (a verify pass over a long cache): one CTA per (key chunk, row
//    block, KV head x batch row), the chunks of a row block one
//    thread-block cluster, merged on chip through distributed shared
//    memory by all the live CTAs of the cluster, each taking a share of
//    the columns (the decode variant's first-CTA merge, spread out: a
//    row block has up to 64 rows where a decode CTA has 16).  A chunk past the
//    row block's live keys exits at once.  The split is chosen on the host
//    from the shapes alone (flash_attention.py `_mma_fwd_plan`).
//  * K and V tiles staged with cp.async (16 bytes a thread, evict-first in
//    L2) in a two-slot ring: the next tile's copies are in flight while
//    this one computes, and one block-wide barrier per tile both publishes
//    a tile and frees the slot of the one before.  Key segment ids ride
//    in the same copy group, one int per key.
//  * S, the online softmax and O stay in the mma accumulator registers;
//    masks are computed only for tiles where one can apply (the chunk's
//    edge, the causal diagonal, segment ids).
//  * bf16: mma.sync.m16n8k16 (fp32 accumulation), Q held as A fragments
//    for the whole walk, K's B fragment by ldmatrix and V's by
//    ldmatrix.trans from XOR-swizzled tiles; P is rounded to bf16 as the A
//    operand of O += P V (the rounding point of the sm90 and decode
//    variants).
//  * fp32: 3xTF32 on mma.sync.m16n8k8 (sm90.cuh, split_tf32): each operand
//    is split into two tf32 values and three products are summed in fp32,
//    which keeps fp32 accuracy where plain TF32 keeps ~3 digits.  Tiles
//    are fp32 rows padded by 4 floats, read with 32-bit loads free of bank
//    conflicts; the key order inside P V's k-slice is permuted so that P's
//    accumulator registers are its A fragment with no shuffle.  Q stays in
//    shared memory and is split as it is read.
//
// Head dims 16, 32, 40, 64, 80, 128 and 160.  bf16 reduces over D in
// 16-column k-steps, so a D = 40 row (five 16-byte chunks) is staged as
// 48 columns, the sixth chunk zero-filled by cp.async, in a 64-column
// swizzled tile; fp32 (ten chunks a row) reduces in 8-column k-steps,
// which 40 fills.  80 and 160 are whole k-steps; their bf16 rows (10 and
// 20 chunks) are padded by one chunk where the others are swizzled.
// Products into D columns run over D / 8 n-tiles and store only those.
//
// Layout: q, o (B, Sq, H, D); k, v (B, Sk, Hkv, D), one dtype (bf16 or
// fp32), contiguous, 16-byte aligned; lse (B, H, Sq) fp32; q_offset int32
// (B,); q_seg (B, Sq), kv_seg (B, Sk) int32 or null.

#include <cooperative_groups.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

namespace cg = cooperative_groups;
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
using sm90::store4;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRowsPerWarp = 16;  // packed rows of one warp: one mma M tile
constexpr int kMaxWarps = 4;      // M tiles per CTA
constexpr int kMaxRows = kMaxWarps * kRowsPerWarp;
constexpr int kMaxCluster = 8;  // key chunks per row block: the portable cluster limit
constexpr int kSlots = 2;       // ring slots

constexpr int kErrHeadDim = -1;
constexpr int kErrPlan = -2;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  const int* q_offset;
  const int* q_seg;
  const int* kv_seg;
  int B, H, Hkv, Sq, Sk, k_offset, causal, chunk_keys;
  float scale;
};

// Keys of one tile: 64, or 32 for fp32 at D = 128 and 160 (registers and
// shared memory).  flash_attention.py `_mma_keys` mirrors this.
template <typename T, int D>
constexpr int tile_keys() {
  return std::is_same<T, float>::value && D >= 128 ? 32 : 64;
}

// Shared memory of one CTA: the ring (per slot a K tile, a V tile), fp32's
// Q tile, the key segment ids per slot; after the walk, the CTA's partial
// (acc [kMaxRows][D], then (m, l) per row) over the ring's start.
template <typename T, int D>
struct Cfg {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int KEYS = tile_keys<T, D>();
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
  static constexpr int OFF_SEG = OFF_Q + (F32 ? kMaxRows * PITCH : 0);
  static constexpr int MAIN = OFF_SEG + kSlots * KEYS * 4;
  static constexpr int PART = (kMaxRows * D + 2 * kMaxRows) * 4;
  static constexpr int SMEM = MAIN > PART ? MAIN : PART;
  // Byte offset of 16-byte column q of row `row` in a tile: fp32 rows and
  // bf16 rows at D = 80 and 160 are padded, the other bf16 rows
  // XOR-swizzled (ldmatrix reads both conflict-free).
  __device__ static uint32_t at(int row, int q) {
    if constexpr (SWZ) return row * PITCH + ((q ^ (row & (QN - 1))) << 4);
    else return row * PITCH + q * 16;
  }
};

// The live CTAs of a cluster merge their n_live partials (rows [row0,
// row0 + rows) of a row block) into O and LSE together: CTA `rank` takes
// every n_live-th group of 4 columns, and each thread loads every rank's
// values before any arithmetic, so the remote reads are in flight
// together; the sum runs in chunk order (deterministic).
template <typename T, int D>
__device__ void merge_cluster(const Params& p, cg::cluster_group& cluster, float* part,
                              int n_live, int rank, int b, int hk, int row0, int rows) {
  const int rep = p.H / p.Hkv;
  const float sl2 = p.scale * kLog2e;
  const float* parts[kMaxCluster];
#pragma unroll
  for (int k = 0; k < kMaxCluster; ++k) parts[k] = cluster.map_shared_rank(part, k < n_live ? k : 0);
  T* O = static_cast<T*>(p.o);
  for (int i = rank * blockDim.x + threadIdx.x; i < rows * D / 4; i += n_live * blockDim.x) {
    const int r = i / (D / 4), d = i % (D / 4) * 4;
    float2 ml[kMaxCluster];
    float4 oc[kMaxCluster];
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k)
      if (k < n_live) {
        ml[k] = *reinterpret_cast<const float2*>(parts[k] + kMaxRows * D + 2 * r);
        oc[k] = *reinterpret_cast<const float4*>(parts[k] + r * D + d);
      }
    float mm = -INFINITY;
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k)
      if (k < n_live) mm = fmaxf(mm, ml[k].x);
    float ll = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k)
      if (k < n_live && ml[k].x != -INFINITY) {  // a chunk that saw nothing adds nothing
        const float w = exp2_ftz((ml[k].x - mm) * sl2);
        ll = fmaf(w, ml[k].y, ll);
        o[0] = fmaf(w, oc[k].x, o[0]);
        o[1] = fmaf(w, oc[k].y, o[1]);
        o[2] = fmaf(w, oc[k].z, o[2]);
        o[3] = fmaf(w, oc[k].w, o[3]);
      }
    const float inv = ll > 0.f ? 1.f / ll : 0.f;
    const int R = row0 + r;
    store4(O + ((size_t)(b * p.Sq + R / rep) * p.H + hk * rep + R % rep) * D + d, o[0] * inv,
           o[1] * inv, o[2] * inv, o[3] * inv);
    if (d == 0)
      p.lse[((size_t)b * p.H + hk * rep + R % rep) * p.Sq + R / rep] =
          ll > 0.f ? mm * p.scale + logf(ll) : kNegInf;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kMaxWarps * 32) flash_fwd_mma_kernel(const Params p) {
  using C = Cfg<T, D>;
  constexpr int KEYS = C::KEYS, NT = KEYS / 8;  // n-tiles of S per key tile
  constexpr int ND = D / 8;                     // n-tiles of O
  constexpr int FP = (D + 4);                   // fp32 row pitch in floats
  extern __shared__ __align__(128) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int chunk = blockIdx.x, rb = blockIdx.y;  // chunk = rank in the cluster
  const int hk = blockIdx.z % p.Hkv, b = blockIdx.z / p.Hkv;
  const int warps = blockDim.x / 32, nthr = blockDim.x, tid = threadIdx.x;
  const int rep = p.H / p.Hkv, n_rows = p.Sq * rep;
  const int row0 = rb * warps * kRowsPerWarp;
  const int rows = min(warps * kRowsPerWarp, n_rows - row0);  // real rows of this CTA
  const int q_off = p.q_offset[b];
  // Keys any row of the block can see: all Sk, or under causality up to
  // its last row's position.
  int n_keys = p.Sk;
  if (p.causal) {
    const long long live = (long long)q_off + (row0 + rows - 1) / rep + 1 - p.k_offset;
    n_keys = live < p.Sk ? (int)(live > 0 ? live : 0) : p.Sk;
  }
  const int n_live = (n_keys + p.chunk_keys - 1) / p.chunk_keys;
  // A chunk past the live keys has nothing to add; the first CTA stays
  // even then, to write the result.
  if (chunk > 0 && chunk >= n_live) return;
  const int key_begin = chunk * p.chunk_keys;
  const int key_end = min(n_keys, key_begin + p.chunk_keys);
  const int n_tiles = key_begin < key_end ? (key_end - key_begin + KEYS - 1) / KEYS : 0;

  const int warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
  const int wrow = row0 + warp * kRowsPerWarp;  // the warp's first packed row
  const float sl2 = p.scale * kLog2e;
  const uint32_t ring = smem_u32(smem);
  const int* s_seg = reinterpret_cast<const int*>(smem + C::OFF_SEG);
  const uint64_t policy = sm90::evict_first_policy();
  const char* K = static_cast<const char*>(p.k);
  const char* V = static_cast<const char*>(p.v);
  const T* Q = static_cast<const T*>(p.q);

  // fp32: the CTA's Q rows into shared memory, in the first copy group.
  if constexpr (C::F32) {
    for (int i = tid; i < warps * kRowsPerWarp * C::QD; i += nthr) {
      const int r = i / C::QD, q = i % C::QD, R = row0 + r;
      const bool real = r < rows;
      const T* src = Q + ((size_t)(b * p.Sq + (real ? R / rep : 0)) * p.H + hk * rep +
                          (real ? R % rep : 0)) * D + q * 4;
      cp_async16(ring + C::OFF_Q + C::at(r, q), src, real ? 16 : 0, policy);
    }
  }
  // Tile j's K and V rows (and key segment ids) into slot j % 2, one copy
  // group per tile; keys past the chunk's live end are zero-filled.
  auto stage = [&](int j) {
    if (j < n_tiles) {
      const int k0 = key_begin + j * KEYS;
      const uint32_t kt = ring + j % kSlots * 2 * C::TILE;
      for (int i = tid; i < KEYS * C::QZ; i += nthr) {
        const int key = i / C::QZ, q = i % C::QZ;
        const int kpos = min(k0 + key, key_end - 1);
        const size_t src =
            (((size_t)(b * p.Sk + kpos) * p.Hkv + hk) * D) * sizeof(T) + (q < C::QD ? q : 0) * 16;
        const int bytes = k0 + key < key_end && q < C::QD ? 16 : 0;
        cp_async16(kt + C::at(key, q), K + src, bytes, policy);
        cp_async16(kt + C::TILE + C::at(key, q), V + src, bytes, policy);
      }
      if (p.kv_seg != nullptr)
        for (int i = tid; i < KEYS; i += nthr) {
          const int kpos = min(k0 + i, key_end - 1);
          cp_async4(smem_u32(s_seg + j % kSlots * KEYS + i), p.kv_seg + b * p.Sk + kpos,
                    k0 + i < key_end ? 4 : 0);
        }
    }
    cp_async_commit();  // possibly empty: one group per tile keeps the count
  };
  stage(0);

  // The warp's rows g and g + 8: positions and query segment ids.
  int qpos[2], qseg[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int R = wrow + g + 8 * i;
    qpos[i] = R / rep;
    if (R < n_rows && p.q_seg != nullptr) qseg[i] = p.q_seg[b * p.Sq + qpos[i]];
  }
  // bf16: Q's rows as A fragments (k-step kk: columns 16 kk + 2c, + 1 and
  // + 8, + 9), loaded once; rows past n_rows and columns past D are zero.
  uint32_t qa[C::F32 ? 1 : C::DK / 16][4];
  if constexpr (!C::F32) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int R = wrow + g + 8 * i;
      const bool real = R < n_rows;
      const uint32_t* src = reinterpret_cast<const uint32_t*>(
          Q + ((size_t)(b * p.Sq + (real ? R / rep : 0)) * p.H + hk * rep + R % rep) * D);
#pragma unroll
      for (int kk = 0; kk < C::DK / 16; ++kk) {
        qa[kk][i] = real ? __ldg(src + 8 * kk + c) : 0u;
        qa[kk][i + 2] = real && 16 * kk + 8 < D ? __ldg(src + 8 * kk + 4 + c) : 0u;
      }
    }
  }

  // Keys up to this one are visible to every row of the warp.
  const long long all_visible = (long long)q_off + wrow / rep - p.k_offset;
  const bool warp_live = wrow < n_rows;
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // m in raw score units
  const int lrow = lane % 8, lmat = lane / 8 % 2;            // ldmatrix row addresses
  const float* sQ = reinterpret_cast<const float*>(smem + C::OFF_Q) + warp * kRowsPerWarp * FP;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<0>();  // tile j has landed
    __syncthreads();     // ... for every thread, and every warp is done with tile j - 1
    stage(j + 1);        // into the slot tile j - 1 used
    if (!warp_live) continue;
    const int k0 = key_begin + j * KEYS;
    const uint32_t kt = ring + j % kSlots * 2 * C::TILE, vt = kt + C::TILE;
    // S = Q K^T: s[t][e] is row g + 8 (e / 2), key k0 + 8t + 2c + e % 2.
    float s[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
    if constexpr (C::F32) {
      const float* sK = reinterpret_cast<const float*>(smem + (kt - ring));
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
        const float* qr = sQ + g * FP + 8 * ks + c;
        const float a[4] = {qr[0], qr[8 * FP], qr[4], qr[8 * FP + 4]};
        uint32_t ab[4], as[4];
        split_tf32<4>(a, ab, as);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const float* kr = sK + (8 * t + g) * FP + 8 * ks + c;
          const float bv[2] = {kr[0], kr[4]};
          uint32_t bb[2], bs[2];
          split_tf32<2>(bv, bb, bs);
          mma1688_3xtf32(s[t], ab, as, bb, bs);
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
        }
    }
    if (k0 + KEYS > key_end || p.q_seg != nullptr ||
        (p.causal && k0 + KEYS - 1 > all_visible)) {
      const int* seg = s_seg + j % kSlots * KEYS;
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 8 * t + 2 * c + (e & 1), kpos = k0 + key, i = e / 2;
          bool keep = kpos < key_end;
          if (keep && p.causal) keep = (long long)q_off + qpos[i] >= (long long)p.k_offset + kpos;
          if (keep && p.q_seg != nullptr) keep = qseg[i] == seg[key];
          if (!keep) s[t][e] = -INFINITY;
        }
    }
    // Online softmax over this tile's keys: the row max over the 4 threads
    // of a row, then P = exp(S - m) and the rescale of l and acc.
    float mx[2] = {m[0], m[1]}, base[2], alpha[2];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[t][e]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      base[i] = mx[i] == -INFINITY ? 0.f : mx[i] * sl2;  // a row with nothing live yet
      alpha[i] = exp2_ftz(m[i] * sl2 - base[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = exp2_ftz(fmaf(s[t][e], sl2, -base[e / 2]));
        s[t][e] = pr;
        l[e / 2] += pr;
      }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha[0], acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1], acc[n][3] *= alpha[1];
    }
    // O += P V.
    if constexpr (C::F32) {
      // k-slice t is keys 8t .. 8t + 7, in the order 0, 2, 4, 6, 1, 3, 5, 7:
      // logical k = c is key 2c and k = c + 4 is key 2c + 1, so S's
      // accumulators (row g / g + 8, keys 2c, 2c + 1) are P's A fragment.
      const float* sV = reinterpret_cast<const float*>(smem + (vt - ring));
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const float a[4] = {s[t][0], s[t][2], s[t][1], s[t][3]};
        uint32_t ab[4], as[4];
        split_tf32<4>(a, ab, as);
        const float* vr = sV + (8 * t + 2 * c) * FP + g;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          const float bv[2] = {vr[8 * n], vr[FP + 8 * n]};
          uint32_t bb[2], bs[2];
          split_tf32<2>(bv, bb, bs);
          mma1688_3xtf32(acc[n], ab, as, bb, bs);
        }
      }
    } else {
      // P's A fragment is S's accumulators rounded to bf16; V's B fragment
      // for O's n-tile n by ldmatrix.trans of 16 keys.
#pragma unroll
      for (int kk = 0; kk < KEYS / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          uint32_t b0, b1;
          ldsm_x2_trans(vt + C::at(16 * kk + 8 * lmat + lrow, n), b0, b1);
          mma16816(acc[n], pa, b0, b1);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }

  if (n_live > 1) {
    // This CTA's partial in its own shared memory (over the ring, once no
    // copy is in flight and every warp is done with it), published to the
    // cluster; the live CTAs merge them together.
    cp_async_wait<0>();
    __syncthreads();
    float* part = reinterpret_cast<float*>(smem);
    if (warp_live) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = warp * kRowsPerWarp + g + 8 * i;
#pragma unroll
        for (int n = 0; n < ND; ++n)
          *reinterpret_cast<float2*>(part + r * D + 8 * n + 2 * c) =
              make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
        if (c == 0) part[kMaxRows * D + 2 * r] = m[i], part[kMaxRows * D + 2 * r + 1] = l[i];
      }
    }
    cluster.sync();
    merge_cluster<T, D>(p, cluster, part, n_live, chunk, b, hk, row0, rows);
    cluster.sync();  // no CTA leaves while another may still read its partial
    return;
  }

  // O = acc / l and LSE = m + log l (O = 0, LSE = NEG_INF for a row that
  // saw nothing).
  cp_async_wait<0>();  // no copy may land after the CTA leaves
  T* O = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int R = wrow + g + 8 * i;
    if (R >= n_rows) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* dst = O + ((size_t)(b * p.Sq + R / rep) * p.H + hk * rep + R % rep) * D + 2 * c;
#pragma unroll
    for (int n = 0; n < ND; ++n) store2(dst + 8 * n, acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    if (c == 0)
      p.lse[((size_t)b * p.H + hk * rep + R % rep) * p.Sq + R / rep] =
          l[i] > 0.f ? m[i] * p.scale + logf(l[i]) : kNegInf;
  }
}

template <typename T, int D>
int launch(const Params& p, int warps, int n_chunks, cudaStream_t s) {
  using C = Cfg<T, D>;
  if (p.chunk_keys % C::KEYS != 0) return kErrPlan;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const int rows = p.Sq * (p.H / p.Hkv), block = warps * kRowsPerWarp;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_chunks, (rows + block - 1) / block, p.Hkv * p.B);
  cfg.blockDim = dim3(warps * 32);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = n_chunks;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, flash_fwd_mma_kernel<T, D>, p);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const Params& p, int warps, int n_chunks, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(p, warps, n_chunks, s);
    case 32: return launch<T, 32>(p, warps, n_chunks, s);
    case 40: return launch<T, 40>(p, warps, n_chunks, s);
    case 64: return launch<T, 64>(p, warps, n_chunks, s);
    case 80: return launch<T, 80>(p, warps, n_chunks, s);
    case 128: return launch<T, 128>(p, warps, n_chunks, s);
    case 160: return launch<T, 160>(p, warps, n_chunks, s);
    default: return kErrHeadDim;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`: CTAs of `warps` (1 to 4) M tiles of 16
// packed rows, the keys cut into n_chunks (1 to 8) chunks of chunk_keys
// (a multiple of the tile: 64 keys, 32 for fp32 at D >= 128) per row block,
// one cluster each; returns cudaGetLastError() after the launch (0 on
// success) or a negative code (flash_fwd_mma_sm90_error_string).
int flash_fwd_mma_sm90(const void* q, const void* k, const void* v, void* o, float* lse,
                       const int* q_offset, const int* q_seg, const int* kv_seg, int B, int H,
                       int Hkv, int Sq, int Sk, int D, int k_offset, int causal, float scale,
                       int warps, int chunk_keys, int n_chunks, int is_bf16, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (warps < 1 || warps > kMaxWarps || n_chunks < 1 || n_chunks > kMaxCluster ||
      chunk_keys < 1 || (long long)chunk_keys * n_chunks < Sk)
    return kErrPlan;
  const Params p{q, k, v, o, lse, q_offset, q_seg, kv_seg, B, H, Hkv, Sq, Sk, k_offset, causal,
                 chunk_keys, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_d<bf16>(D, p, warps, n_chunks, s)
                 : dispatch_d<float>(D, p, warps, n_chunks, s);
}

const char* flash_fwd_mma_sm90_error_string(int err) {
  switch (err) {
    case kErrHeadDim: return "unsupported head dim";
    case kErrPlan:
      return "1 to 4 warps, and 1 to 8 chunks of a multiple of the key tile that cover the keys";
    default: return cudaGetErrorString((cudaError_t)err);
  }
}

}  // extern "C"
