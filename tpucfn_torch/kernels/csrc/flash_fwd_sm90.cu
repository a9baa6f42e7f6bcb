// FlashAttention forward on Hopper's tensor cores (sm_90a), bf16.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in
// tpucfn/kernels/flash_attention.py (launched by `_flash_fwd`) for bf16
// inputs with at least 64 packed query rows per (batch row, KV head); the
// split-KV FMA kernel in flash_fwd.cu keeps fp32 and the decode shape.  It
// computes what that kernel computes: O = softmax(mask(Q K^T * D^-1/2)) V
// and fp32 LSE = m + log l, causality with a per-row query offset read
// from memory plus a key offset, segment ids, the ragged Sk edge, GQA
// position-major row packing with no KV repeat, and O = 0, LSE = NEG_INF
// (-1e30, finite) for rows that attend to nothing.
//
// What bounds it on an H100.  At prefill and training shapes, operations:
// 4 * D flops per live (query, key) pair against O(S * D) bytes.  Only the
// tensor cores reach the card's bf16 rate, so both products run on wgmma.
//
// What the design does about it.
//  * One consumer warpgroup per CTA owns 64 packed rows (a row is one
//    (query position, query head) pair of a KV head's group, position
//    major).  S = Q K^T is one wgmma chain with Q and K in shared memory;
//    the online softmax runs on the fp32 accumulator in registers, each row
//    spread over the 4 threads that share it (max and sum reduced with two
//    shuffles); P is rounded to bf16 in registers, where the accumulator
//    layout already is the A operand's, and O += P V reads V from shared
//    memory as an MN-major operand.
//  * A producer warp issues TMA loads: the Q tile once (a 4-D box of
//    64 / rep positions x rep adjacent heads: the GQA packing is the box
//    shape), then K and V tiles into a 3-stage ring guarded by full/empty
//    mbarriers, so the next tiles land while this one computes.  Tiles
//    stay bf16 in shared memory, in the 128-byte (64-byte at D = 32,
//    32-byte at D = 16) swizzle that the wgmma descriptors name.  D = 40,
//    80 and 160 run on zero-padded tiles of 64, 128 and 192 columns
//    (sm90.cuh, tile_cols): Q K^T reduces over 48, 80 and 160 columns, P V
//    produces the padded width, and D are stored.
//  * Keys per K/V tile: 128 for tiles up to 64 columns, 64 for 128 and
//    192 (shared memory: at 192 columns the Q tile and three stages of K
//    and V take 168 KB, so one CTA runs per SM there).
//  * Software pipeline: S of tile t + 1 is issued just before P V of tile
//    t, so the softmax of t + 1 runs while P V of t is on the tensor cores;
//    O is rescaled once P V has landed.  A stage is freed one softmax
//    later than without it, hence three stages.
//  * Causal skip: a CTA stops at the last key its last row can see.  Row
//    blocks are dispatched heaviest first (the last rows of every (batch
//    row, KV head) in the first wave).
//  * Masks are computed only for tiles where one can apply: the ragged Sk
//    edge, tiles past the block's first row under causality, and tiles
//    with segment ids.  Full tiles skip the compares.
//  * Two CTAs share an SM up to 128 columns, so one's softmax overlaps the
//    other's products.
//
// Numerics.  Q K^T takes exact bf16 inputs with fp32 accumulation; P is
// rounded to bf16 as the operand of P V (as FlashAttention-2 and -3 do,
// and as the plain version does); the softmax statistics are fp32.
//
// Layout: q, o (B, Sq, H, D); k, v (B, Sk, Hkv, D), bf16, contiguous,
// 16-byte aligned; lse (B, H, Sq) fp32; q_offset int32 (B,); q_seg
// (B, Sq), kv_seg (B, Sk) int32 or null.

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 64;      // packed query rows per CTA: one warpgroup
constexpr int kStages = 3;     // K/V ring depth (the pipelined loop frees a stage late)
constexpr int kThreads = 160;  // warps 0-3 consume, warp 4 produces

template <int D>
struct Cfg {
  static constexpr int DT = tile_cols(D);  // columns of a shared-memory tile
  static constexpr int BK = DT >= 128 ? 64 : 128;  // keys per K/V tile
  static constexpr int MIN_CTAS = DT > 128 ? 1 : 2;  // CTAs an SM holds (shared memory)
  static constexpr int Q_BYTES = kRows * DT * 2;
  static constexpr int KV_BYTES = BK * DT * 2;
  static constexpr int OFF_K = Q_BYTES;  // every tile starts 1024-aligned
  static constexpr int OFF_V = OFF_K + kStages * KV_BYTES;
  static constexpr int OFF_BAR = OFF_V + kStages * KV_BYTES;
  static constexpr int SMEM = OFF_BAR + 8 * (1 + 3 * kStages) + 1024;  // + alignment slack
};

struct Params {
  bf16* o;
  float* lse;
  const int* q_offset;
  const int* q_seg;
  const int* kv_seg;
  int B, H, Hkv, Sq, Sk, k_offset, causal, n_rb;
  float scale;
};

template <int D>
__global__ void __launch_bounds__(kThreads, Cfg<D>::MIN_CTAS)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap, const Params p) {
  using C = Cfg<D>;
  constexpr int BK = C::BK, DT = C::DT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = reinterpret_cast<bf16*>(smem + C::OFF_K);
  bf16* sV = reinterpret_cast<bf16*>(smem + C::OFF_V);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;

  // Heaviest first: the last row block of every (batch row, KV head), then
  // the one before, and so on.
  const int bhs = p.B * p.Hkv;
  const int rb = p.n_rb - 1 - (int)(blockIdx.x / bhs);
  const int hk = blockIdx.x % bhs % p.Hkv, b = blockIdx.x % bhs / p.Hkv;
  const int rep = p.H / p.Hkv;
  const int row0 = rb * kRows;
  const int rows = min(kRows, p.Sq * rep - row0);  // real rows of this block
  const int q_off = p.q_offset[b];
  int n_keys = p.Sk;  // keys this block can see (the causal skip)
  if (p.causal) {
    const long long live = (long long)q_off + (row0 + rows - 1) / rep + 1 - p.k_offset;
    if (live < n_keys) n_keys = (int)(live > 0 ? live : 0);
  }
  const int n_tiles = (n_keys + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(full_v + s, 1);
      mbar_init(empty + s, 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {  // producer
    if (lane == 0) {
      prefetch_map(&qmap);
      prefetch_map(&kmap);
      prefetch_map(&vmap);
      mbar_expect_tx(full_q, C::Q_BYTES);
      tma_tile<D>(sQ, &qmap, full_q, kRows, hk * rep, row0 / rep, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(empty + s, ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(full_k + s, C::KV_BYTES);
        tma_tile<D>(sK + s * BK * DT, &kmap, full_k + s, BK, hk, t * BK, b);
        mbar_expect_tx(full_v + s, C::KV_BYTES);
        tma_tile<D>(sV + s * BK * DT, &vmap, full_v + s, BK, hk, t * BK, b);
      }
    }
    return;
  }

  // Consumers: thread (warp, lane) holds rows r and r + 8 of the block,
  // r = 16 warp + lane / 4, and columns 8 n + 2 (lane % 4) + {0, 1} of
  // every 8-column chunk n of each accumulator.
  const int r_lo = warp * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  int qpos[2], qseg[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qpos[i] = (row0 + r_lo + 8 * i) / rep;
    if (p.q_seg != nullptr && qpos[i] < p.Sq) qseg[i] = p.q_seg[b * p.Sq + qpos[i]];
  }
  // Keys up to this one are visible to every row of the block.
  const long long first_visible = (long long)q_off + row0 / rep - p.k_offset;
  const float scale_log2 = p.scale * kLog2e;

  float o[DT / 2];
#pragma unroll
  for (int i = 0; i < DT / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // m in raw score units
  uint32_t pa[BK / 16][4];  // P of the tile whose P V is next, as A fragments

  // S = Q K_t^T into x, issued and committed (not waited for).
  auto scores = [&](int t, float* x) {
    mbar_wait(full_k + t % kStages, (t / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < k_steps(D); ++kk)
      wgmma_ss<BK>(x, desc_kmajor<D>(sQ, kRows, kk),
                   desc_kmajor<D>(sK + t % kStages * BK * DT, BK, kk), kk > 0);
    wgmma_commit();
  };
  // O += P V_t from pa, issued and committed.
  auto pv = [&](int t) {
    mbar_wait(full_v + t % kStages, (t / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<DT>(o, pa[kk], desc_mnmajor<D>(sV + t % kStages * BK * DT, BK, kk));
    wgmma_commit();
  };
  // Online softmax of tile t's scores x, in place: masks where one can
  // apply, the row max over the 4 threads of a row, the running sum
  // rescaled, x = exp(S - m); alpha is the factor O must be rescaled by.
  auto softmax = [&](int t, float* x, float* alpha) {
    const int k0 = t * BK;
    const bool masked = k0 + BK > p.Sk || (p.causal && (long long)k0 + BK - 1 > first_visible) ||
                        p.q_seg != nullptr;
    if (masked) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e / 2, kpos = k0 + 8 * n + col0 + (e & 1);
          bool keep = kpos < p.Sk;
          if (p.causal) keep = keep && (long long)q_off + qpos[i] >= (long long)p.k_offset + kpos;
          if (p.q_seg != nullptr) keep = keep && qseg[i] == p.kv_seg[b * p.Sk + kpos];
          if (!keep) x[4 * n + e] = -INFINITY;
        }
    }
    float mx[2] = {m[0], m[1]}, base[2];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], x[4 * n + e]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      base[i] = mx[i] == -INFINITY ? 0.f : mx[i] * scale_log2;  // a row with nothing live yet
      alpha[i] = exp2_ftz(m[i] * scale_log2 - base[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = exp2_ftz(fmaf(x[4 * n + e], scale_log2, -base[e / 2]));
        x[4 * n + e] = pr;
        l[e / 2] += pr;
      }
  };

  // Software pipeline: while P V of tile t runs on the tensor cores, the
  // softmax of tile t + 1 (whose S = Q K^T was issued just before it)
  // runs on the other units; O is rescaled once P V has landed.
  mbar_wait(full_q, 0);
  if (n_tiles > 0) {
    float x[BK / 2], alpha[2];
    scores(0, x);
    wgmma_wait<0>();
    fence_regs<BK / 2>(x);
    softmax(0, x, alpha);  // O is still 0: no rescale
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) a_frag(x, kk, pa[kk]);
  }
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      float x[BK / 2], alpha[2];
      scores(t + 1, x);
      pv(t);
      wgmma_wait<1>();  // S of tile t + 1
      fence_regs<BK / 2>(x);
      softmax(t + 1, x, alpha);
      wgmma_wait<0>();  // P V of tile t
      fence_regs<DT / 2>(o);
      if (lane == 0) mbar_arrive(empty + t % kStages);
#pragma unroll
      for (int n = 0; n < DT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * n + e] *= alpha[e / 2];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) a_frag(x, kk, pa[kk]);
    } else {
      pv(t);
      wgmma_wait<0>();
      fence_regs<DT / 2>(o);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = r_lo + 8 * i, R = row0 + r;
    if (r >= rows) continue;
    const int h = hk * rep + R % rep;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    bf16* orow = p.o + ((size_t)(b * p.Sq + R / rep) * p.H + h) * D + col0;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n) =
          pack_bf16(o[4 * n + 2 * i] * inv, o[4 * n + 2 * i + 1] * inv);
    if (lane % 4 == 0)
      p.lse[((size_t)b * p.H + h) * p.Sq + R / rep] =
          l[i] > 0.f ? m[i] * p.scale + logf(l[i]) : kNegInf;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, Params p, cudaStream_t stream) {
  using C = Cfg<D>;
  const int rep = p.H / p.Hkv;
  if (kRows % rep != 0) return kErrGroup;
  CUtensorMap qm, km, vm;
  int err = make_map(&qm, q, p.B, p.Sq, p.H, D, rep, kRows / rep);
  if (err == 0) err = make_map(&km, k, p.B, p.Sk, p.Hkv, D, 1, C::BK);
  if (err == 0) err = make_map(&vm, v, p.B, p.Sk, p.Hkv, D, 1, C::BK);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_sm90_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  p.n_rb = (p.Sq * rep + kRows - 1) / kRows;
  const unsigned grid = (unsigned)p.n_rb * p.B * p.Hkv;
  flash_fwd_sm90_kernel<D><<<grid, kThreads, C::SMEM, stream>>>(qm, km, vm, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() after the
// launch (0 on success) or a negative code (flash_fwd_sm90_error_string).
int flash_fwd_sm90(const void* q, const void* k, const void* v, void* o, float* lse,
                   const int* q_offset, const int* q_seg, const int* kv_seg, int B, int H,
                   int Hkv, int Sq, int Sk, int D, int k_offset, int causal, float scale,
                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Params p{static_cast<bf16*>(o), lse, q_offset, q_seg, kv_seg, B, H, Hkv, Sq, Sk,
           k_offset, causal, 0, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, p, s);
    case 32: return launch<32>(q, k, v, p, s);
    case 40: return launch<40>(q, k, v, p, s);
    case 64: return launch<64>(q, k, v, p, s);
    case 80: return launch<80>(q, k, v, p, s);
    case 128: return launch<128>(q, k, v, p, s);
    case 160: return launch<160>(q, k, v, p, s);
    default: return kErrHeadDim;
  }
}

const char* flash_fwd_sm90_error_string(int err) { return error_string(err); }

}  // extern "C"
