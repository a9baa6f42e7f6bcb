// FlashAttention forward for decode on Hopper (sm_90a), bf16: K1's "decode"
// variant, for calls with at most 16 packed query rows per (batch row, KV
// head) — a serving decode step (one position x the GQA group) or a short
// multi-token query.  Longer bf16 calls run flash_fwd_sm90.cu, fp32 runs
// flash_fwd.cu.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in
// tpucfn/kernels/flash_attention.py (launched by `_flash_fwd`) for those
// calls, and computes all of its function: O = softmax(mask(Q K^T *
// D^-1/2)) V and fp32 LSE = m + log l, causality with a per-row query
// offset read from device memory plus a key offset, segment ids, the Sk
// edge, GQA position-major row packing with no KV repeat, and O = 0,
// LSE = NEG_INF (-1e30, finite) for rows that attend to nothing.
//
// What bounds it on an H100.  Bytes: every live key's K and V row is read
// once (2 * D * 2 bytes a key per KV head) for at most 16 rows of work, so
// a call does at most 16 flops a byte read (4 at llama3's GQA group of 4),
// far under the card's ~295.  A (KV head, batch row) with a long live
// prefix needs several SMs to read it at the card's rate, and their parts
// must then be merged: the old decode path (the fma kernel) paid serial
// tile walks, and a merge through device memory (partials, a fence, an
// atomic, a second read) adds several round trips to L2 after the last
// chunk.
//
// What the design does about it.
//  * Grid from the cache's capacity, not its live length: one CTA per (key
//    chunk, KV head, batch row), the capacity cut into at most 8 chunks
//    (a multiple of 64 keys each), and the chunks of one (KV head, batch
//    row) form one thread-block cluster.  The host never reads device
//    data, so a launch can be captured in a CUDA graph and replayed as the
//    offsets move.
//  * Merge on chip: each CTA of a cluster leaves its fp32 (m, l, acc) in
//    its own shared memory, a cluster barrier publishes them, and the
//    first CTA reads the others' through distributed shared memory (every
//    thread with every rank's loads in flight at once, not a serial walk
//    over the ranks) and merges them in chunk order (deterministic), then
//    writes O and LSE.  A CTA whose chunk starts past the live keys exits
//    at once (a cluster barrier waits only for the threads that have not
//    exited), which frees its SM for the live ones; a (KV head, batch row)
//    whose live keys fall in one chunk skips the merge: its first CTA
//    writes directly.
//  * Four warps, each on its own keys: step j of warp w is keys
//    64 j + 16 w .. + 15 of the chunk.  A warp stages its steps' K and V
//    rows through its own two-slot shared-memory ring with cp.async (16
//    bytes a lane, evict-first in L2: the cache is read once per call), the
//    next step's copies in flight while a step computes; no block-wide
//    barrier until the end of the chunk.  Tiles stay bf16, XOR-swizzled by
//    16-byte column so that ldmatrix reads them without bank conflicts.
//    The ring keeps a CTA at 32 KB (D = 64), so CTAs waiting at a cluster
//    barrier cost little occupancy.
//  * Tensor cores at M = 16: mma.sync.m16n8k16 (bf16 in, fp32 out).  The
//    packed rows of Q are the A fragment, loaded once; K's B fragment comes
//    from ldmatrix, V's from ldmatrix.trans; S stays in the accumulator
//    registers for the online softmax; P is rounded to bf16 in place as the
//    A fragment of O += P V (the rounding point of the sm90 kernel).  A
//    wgmma tile would take 64 rows; this one leaves at most 12 of 16 empty.
//
// Layout: q, o (B, Sq, H, D); k, v (B, Sk, Hkv, D), bf16, contiguous,
// 16-byte aligned; lse (B, H, Sq) fp32; q_offset int32 (B,); q_seg (B, Sq),
// kv_seg (B, Sk) int32 or null.

#include <cooperative_groups.h>

#include "sm90.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using sm90::cp_async16;
using sm90::cp_async_commit;
using sm90::cp_async_wait;
using sm90::exp2_ftz;
using sm90::ldsm_x2;
using sm90::ldsm_x2_trans;
using sm90::mma16816;
using sm90::pack_bf16;
using sm90::smem_u32;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;                      // packed query rows: one mma M tile
constexpr int kStepKeys = 16;                  // keys of one warp step
constexpr int kTileKeys = kWarps * kStepKeys;  // keys of one step of all warps
constexpr int kSlots = 2;                      // ring slots per warp
constexpr int kMaxCluster = 8;  // chunks per (KV head, batch row): the portable cluster limit

constexpr int kErrHeadDim = -1;
constexpr int kErrRows = -2;
constexpr int kErrChunks = -3;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* lse;
  const int* q_offset;
  const int* q_seg;
  const int* kv_seg;
  int B, H, Hkv, Sq, Sk, k_offset, causal, chunk_keys;
  float scale;
};

// Shared memory of one CTA: each warp's ring of staged K and V tiles (16
// keys x D bf16 per slot), later reused by the merge of the warps and the
// CTA's merged partial, which the cluster's first CTA reads.
template <int D>
struct Cfg {
  static constexpr int ROW = 2 * D;                   // bytes of a key row
  static constexpr int TILE = kStepKeys * ROW;        // a warp step's K (or V)
  static constexpr int WARP = kSlots * 2 * TILE;      // a warp's ring
  static constexpr int QN = D / 8 < 8 ? D / 8 : 8;    // swizzle span, 16-byte columns
  static constexpr int MERGE = (kWarps * kRows * (D + 4) + 2 * kWarps * kRows) * 4;
  static constexpr int PART = (kRows * D + 2 * kRows) * 4;  // acc, then (m, l)
  static constexpr int SMEM = kWarps * WARP > MERGE + PART ? kWarps * WARP : MERGE + PART;
  // Byte offset of 16-byte column q of key row `key` in a tile.
  __device__ static uint32_t at(int key, int q) {
    return key * ROW + ((q ^ (key & (QN - 1))) << 4);
  }
};

// The first CTA of a cluster merges the n_live partials (acc [kRows][D],
// then (m, l) per row, in each CTA's shared memory) into O and LSE.  All
// its threads take column pairs of the rows, and each loads every rank's
// values before any arithmetic, so the remote reads are in flight
// together; the sum runs in rank (chunk) order: deterministic.
template <int D>
__device__ void merge_cluster(const Params& p, cg::cluster_group& cluster, float* part,
                              int n_live, int b, int hk) {
  const int rep = p.H / p.Hkv, n_rows = p.Sq * rep;
  const float sl2 = p.scale * kLog2e;
  const float* parts[kMaxCluster];
#pragma unroll
  for (int k = 0; k < kMaxCluster; ++k) parts[k] = cluster.map_shared_rank(part, k < n_live ? k : 0);
  for (int i = threadIdx.x; i < n_rows * D / 2; i += kThreads) {
    const int r = i / (D / 2), d = i % (D / 2) * 2;
    float2 ml[kMaxCluster], oc[kMaxCluster];
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k)
      if (k < n_live) {
        ml[k] = *reinterpret_cast<const float2*>(parts[k] + kRows * D + 2 * r);
        oc[k] = *reinterpret_cast<const float2*>(parts[k] + r * D + d);
      }
    float mm = -INFINITY;
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k)
      if (k < n_live) mm = fmaxf(mm, ml[k].x);
    float ll = 0.f, o0 = 0.f, o1 = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k)
      if (k < n_live && ml[k].x != -INFINITY) {  // a chunk that saw nothing adds nothing
        const float w = exp2_ftz((ml[k].x - mm) * sl2);
        ll = fmaf(w, ml[k].y, ll);
        o0 = fmaf(w, oc[k].x, o0);
        o1 = fmaf(w, oc[k].y, o1);
      }
    const float inv = ll > 0.f ? 1.f / ll : 0.f;
    bf16* dst = p.o + ((size_t)(b * p.Sq + r / rep) * p.H + hk * rep + r % rep) * D + d;
    *reinterpret_cast<uint32_t*>(dst) = pack_bf16(o0 * inv, o1 * inv);
    if (d == 0)
      p.lse[((size_t)b * p.H + hk * rep + r % rep) * p.Sq + r / rep] =
          ll > 0.f ? mm * p.scale + logf(ll) : kNegInf;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_decode_kernel(const Params p) {
  using C = Cfg<D>;
  constexpr int QD = D / 8;                // 16-byte columns of a row
  constexpr int DT = D >= 32 ? D / 8 : 4;  // merge: columns per thread (4-column groups)
  constexpr int TPR = D / DT;              // merge: threads per row
  extern __shared__ __align__(128) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int chunk = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;  // chunk = rank in the cluster
  const int rep = p.H / p.Hkv, n_rows = p.Sq * rep;
  const int q_off = p.q_offset[b];
  // Keys any row of (b, hk) can see: all Sk, or under causality up to the
  // last query position's.
  int n_keys = p.Sk;
  if (p.causal) {
    const long long live = (long long)q_off + p.Sq - p.k_offset;
    n_keys = live < p.Sk ? (int)(live > 0 ? live : 0) : p.Sk;
  }
  const int n_live = (n_keys + p.chunk_keys - 1) / p.chunk_keys;
  // A chunk past the live keys has nothing to add; the first CTA stays
  // even then, to write the result.
  if (chunk > 0 && chunk >= n_live) return;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const float sl2 = p.scale * kLog2e;
  const int key_base = chunk * p.chunk_keys + warp * kStepKeys;
  const int chunk_end = min(n_keys, (chunk + 1) * p.chunk_keys);
  // Warp steps with a live key: this warp's keys k0 = key_base + 64 j.
  const int steps = key_base < chunk_end ? (chunk_end - key_base + kTileKeys - 1) / kTileKeys : 0;

  // The ring: step j's K and V rows go to slot j % 2 as 16-byte copies, one
  // group per step, the next step's in flight while this one computes.
  // Keys past n_keys are zero-filled without a read.
  const uint32_t ring = smem_u32(smem) + warp * C::WARP;
  const uint64_t policy = sm90::evict_first_policy();
  auto stage = [&](int j) {
    if (j < steps) {
      const int k0 = key_base + j * kTileKeys;
#pragma unroll
      for (int u = 0; u < kStepKeys * QD / 32; ++u) {
        const int i = lane + 32 * u, key = i / QD, q = i % QD;
        const int kpos = min(k0 + key, n_keys - 1);
        const size_t src = ((size_t)(b * p.Sk + kpos) * p.Hkv + hk) * D + q * 8;
        const int bytes = k0 + key < n_keys ? 16 : 0;
        const uint32_t dst = ring + j % kSlots * 2 * C::TILE + C::at(key, q);
        cp_async16(dst, p.k + src, bytes, policy);
        cp_async16(dst + C::TILE, p.v + src, bytes, policy);
      }
    }
    cp_async_commit();  // possibly empty: one group per step keeps the count
  };
  stage(0);
  stage(1);

  // Q: rows g and g + 8 as A fragments (k-step kk: columns 16 kk + 2c,
  // + 1 and + 8, + 9), loaded once; rows past n_rows are zero.
  uint32_t qa[D / 16][4];
  int qpos[2], qseg[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = g + 8 * i;
    qpos[i] = r / rep;
    const bool real = r < n_rows;
    const uint32_t* src = reinterpret_cast<const uint32_t*>(
        p.q + ((size_t)(b * p.Sq + (real ? qpos[i] : 0)) * p.H + hk * rep + r % rep) * D);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk][i] = real ? __ldg(src + 8 * kk + c) : 0u;
      qa[kk][i + 2] = real ? __ldg(src + 8 * kk + 4 + c) : 0u;
    }
    if (real && p.q_seg != nullptr) qseg[i] = p.q_seg[b * p.Sq + qpos[i]];
  }

  // Keys up to this one are visible to every row (the first position's).
  const long long all_visible = (long long)q_off - p.k_offset;
  float acc[QD][4];
#pragma unroll
  for (int n = 0; n < QD; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // m in raw score units
  // ldmatrix row addresses: lane l gives row l % 8 of matrix l / 8 % 2.
  const int lrow = lane % 8, lmat = lane / 8 % 2;

  for (int j = 0; j < steps; ++j) {
    const int k0 = key_base + j * kTileKeys;
    cp_async_wait<1>();  // step j's group has landed (j + 1's may be pending)
    __syncwarp();        // every lane's copies of it are visible to the warp
    const uint32_t kt = ring + j % kSlots * 2 * C::TILE, vt = kt + C::TILE;
    // S = Q K^T: s[t][e] is row g + 8 (e / 2), key k0 + 8t + 2c + e % 2.
    float s[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b0, b1;  // keys 8t .. 8t + 7 x columns 16 kk .. + 15
        ldsm_x2(kt + C::at(8 * t + lrow, 2 * kk + lmat), b0, b1);
        mma16816(s[t], qa[kk], b0, b1);
      }
    }
    if (k0 + kStepKeys > n_keys || p.q_seg != nullptr ||
        (p.causal && k0 + kStepKeys - 1 > all_visible)) {
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * t + 2 * c + (e & 1), i = e / 2;
          bool keep = kpos < n_keys;
          if (keep && p.causal) keep = (long long)q_off + qpos[i] >= (long long)p.k_offset + kpos;
          if (keep && p.q_seg != nullptr) keep = qseg[i] == p.kv_seg[b * p.Sk + kpos];
          if (!keep) s[t][e] = -INFINITY;
        }
    }
    // Online softmax over this step's 16 keys: the row max over the 4
    // threads of a row, then P = exp(S - m) and the rescale of l and acc.
    float mx[2] = {m[0], m[1]}, base[2], alpha[2];
#pragma unroll
    for (int t = 0; t < 2; ++t)
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
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = exp2_ftz(fmaf(s[t][e], sl2, -base[e / 2]));
        s[t][e] = pr;
        l[e / 2] += pr;
      }
#pragma unroll
    for (int n = 0; n < QD; ++n) {
      acc[n][0] *= alpha[0], acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1], acc[n][3] *= alpha[1];
    }
    // O += P V: P's A fragment is S's accumulators rounded to bf16; V's B
    // fragment for O's n-tile n (columns 8n .. 8n + 7) by ldmatrix.trans of
    // keys 0-7 and 8-15.
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int n = 0; n < QD; ++n) {
      uint32_t b0, b1;
      ldsm_x2_trans(vt + C::at(8 * lmat + lrow, n), b0, b1);
      mma16816(acc[n], pa, b0, b1);
    }
    __syncwarp();  // every lane is done with this slot
    stage(j + 2);  // into the slot just freed
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }

  // The warps' (m, l, acc) merged once, through shared memory (the ring,
  // once every warp is done with it): thread t then owns row t / TPR,
  // columns (t % TPR) * DT .. + DT.
  cp_async_wait<0>();  // no copy may land in the ring after this point
  __syncthreads();
  float(*s_acc)[kRows][D + 4] = reinterpret_cast<float(*)[kRows][D + 4]>(smem);
  float(*s_m)[kRows] = reinterpret_cast<float(*)[kRows]>(smem + kWarps * kRows * (D + 4) * 4);
  float(*s_l)[kRows] = s_m + kWarps;
  if (c == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      s_m[warp][g + 8 * i] = m[i];
      s_l[warp][g + 8 * i] = l[i];
    }
  }
#pragma unroll
  for (int n = 0; n < QD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s_acc[warp][g + 8 * (e / 2)][8 * n + 2 * c + (e & 1)] = acc[n][e];
  __syncthreads();

  const int r = threadIdx.x / TPR, d0 = threadIdx.x % TPR * DT;
  float mm = -INFINITY, ll = 0.f, out[DT];
#pragma unroll
  for (int e = 0; e < DT; ++e) out[e] = 0.f;
  if (r < n_rows) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, s_m[w][r]);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wgt = s_m[w][r] == -INFINITY ? 0.f : exp2_ftz((s_m[w][r] - mm) * sl2);
      ll = fmaf(wgt, s_l[w][r], ll);
#pragma unroll
      for (int e = 0; e < DT; ++e) out[e] = fmaf(wgt, s_acc[w][r][d0 + e], out[e]);
    }
  }

  if (n_live > 1) {
    // This CTA's partial in its own shared memory (past the warps' merge
    // area, which other threads may still be reading), published to the
    // cluster; the first CTA merges them all.
    float* part = reinterpret_cast<float*>(smem + C::MERGE);
    if (r < n_rows) {
#pragma unroll
      for (int e = 0; e < DT; ++e) part[r * D + d0 + e] = out[e];
      if (d0 == 0) part[kRows * D + 2 * r] = mm, part[kRows * D + 2 * r + 1] = ll;
    }
    cluster.sync();
    if (chunk == 0) merge_cluster<D>(p, cluster, part, n_live, b, hk);
    cluster.sync();  // no CTA leaves while the first may still read its partial
    return;
  }

  // O = acc / l and LSE = m + log l (O = 0, LSE = NEG_INF for a row that
  // saw nothing).
  if (r < n_rows) {
    const float inv = ll > 0.f ? 1.f / ll : 0.f;
    bf16* dst = p.o + ((size_t)(b * p.Sq + r / rep) * p.H + hk * rep + r % rep) * D + d0;
#pragma unroll
    for (int e = 0; e < DT; e += 4)
      *reinterpret_cast<uint2*>(dst + e) = make_uint2(pack_bf16(out[e] * inv, out[e + 1] * inv),
                                                      pack_bf16(out[e + 2] * inv, out[e + 3] * inv));
    if (d0 == 0)
      p.lse[((size_t)b * p.H + hk * rep + r % rep) * p.Sq + r / rep] =
          ll > 0.f ? mm * p.scale + logf(ll) : kNegInf;
  }
}

template <int D>
int launch(const Params& p, int n_chunks, cudaStream_t s) {
  using C = Cfg<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_decode_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_chunks, p.Hkv, p.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = n_chunks;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, flash_fwd_decode_kernel<D>, p);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`: n_chunks (1 to 8) chunks of chunk_keys
// keys (a multiple of 64) per (KV head, batch row), one cluster each;
// returns cudaGetLastError() after the launch (0 on success) or a negative
// code (flash_fwd_decode_sm90_error_string).
int flash_fwd_decode_sm90(const void* q, const void* k, const void* v, void* o, float* lse,
                          const int* q_offset, const int* q_seg, const int* kv_seg, int B, int H,
                          int Hkv, int Sq, int Sk, int D, int k_offset, int causal, float scale,
                          int chunk_keys, int n_chunks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Sq * (H / Hkv) > kRows) return kErrRows;
  if (n_chunks < 1 || n_chunks > kMaxCluster || chunk_keys % kTileKeys != 0 ||
      (long long)chunk_keys * n_chunks < Sk)
    return kErrChunks;
  const Params p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v),  static_cast<bf16*>(o),
                 lse, q_offset, q_seg, kv_seg,
                 B, H, Hkv, Sq, Sk, k_offset, causal, chunk_keys, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(p, n_chunks, s);
    case 64: return launch<64>(p, n_chunks, s);
    case 128: return launch<128>(p, n_chunks, s);
    default: return kErrHeadDim;
  }
}

const char* flash_fwd_decode_sm90_error_string(int err) {
  switch (err) {
    case kErrHeadDim: return "unsupported head dim";
    case kErrRows: return "more than 16 packed query rows per (batch row, KV head)";
    case kErrChunks: return "1 to 8 chunks of a multiple of 64 keys must cover the cache";
    default: return cudaGetErrorString((cudaError_t)err);
  }
}

}  // extern "C"
