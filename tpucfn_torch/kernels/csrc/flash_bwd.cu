// FlashAttention-2 backward for Hopper (sm_90a), plain shared-memory tiles.
//
// Three kernels, the backward of flash_fwd.cu's K1:
//
//  * flash_bwd_delta: Delta = rowsum(dO * O) in fp32.  Replaces the XLA
//    preprocess in `_flash_bwd` (tpucfn/kernels/flash_attention.py, line
//    393).  Bound by the bytes of O and dO it reads: a CTA covers 32
//    positions x a run of heads of one batch row, each thread loads 16-byte
//    vectors of O and dO for 8 rows before any math (a row takes D / 8
//    lanes in bf16, D / 4 in fp32, up to one warp: fp32 at D = 160 takes
//    two vectors a lane; loads marked evict-first, as the data is read
//    once), the lanes of a row reduce by shuffles,
//    and the results go out through shared memory so that each head's 32
//    positions leave as one 128-byte store.
//  * flash_bwd_dq (K2): replaces the Pallas TPU kernel `_bwd_dq_kernel`.
//    For each live (query, key) pair it recomputes P = exp(S - LSE), forms
//    dP = dO . V, dS = P * (dP - Delta [+ dLSE]) * scale, and accumulates
//    dQ += dS . K: three products of length D per live pair.  This is K2's
//    "fma" variant, for fp32 and GQA groups that do not divide 64; bf16
//    runs the tensor-core kernel in flash_bwd_dq_sm90.cu.
//  * flash_bwd_dkv (K3): replaces `_bwd_dkv_kernel`.  Per KV block it
//    recomputes P and dS the same way and accumulates dV += P^T . dO and
//    dK += dS^T . Q over every query head of its GQA group and every query
//    row: four products of length D per live pair.  This is K3's "fma"
//    variant, for fp32 and GQA groups that do not divide 64; bf16 runs
//    the tensor-core kernel in flash_bwd_dkv_sm90.cu.
//
// What bounds them on an H100.  At training shapes both are bound by
// operations: 3 (K2) and 4 (K3) multiply-adds of length D per live pair,
// against an input of O(S * D) bytes.  These kernels do them as fp32 FMA
// from shared memory (no tensor cores), far below the card's bf16 rate;
// in bf16 both run on wgmma instead (the sm90 variants).
//
// What the design does about it.
//  * No sequential grid: K2 is one CTA per (row block, KV head, batch row)
//    and loops over KV tiles inside the CTA up to the last key its last row
//    can see (q_offset + last position - k_offset: the causal skip K1
//    uses).  K3 is one CTA per (KV block, KV head, batch row) and loops
//    over query rows from the first one that can see its first key.  Each
//    accumulates its gradient in fp32 registers and writes it once: no
//    repeated KV, no atomics, no second pass.
//  * GQA packing as in K1: a row is one (query position, query head) pair
//    of a KV head's group, position-major, so the rep query heads sharing a
//    KV head share every K/V tile (K2) and every K3 CTA covers its whole
//    group.
//  * Register accumulators with a fixed owner: thread t owns column
//    d = t % D and rows (K2) or keys (K3) t / D + j * (256 / D), so each
//    shared-memory read of a K, Q or dO element feeds NACC FMAs, and the
//    dS/P operand is a warp-wide broadcast.
//  * Q/dO/K/V rows are stored as fp32 padded by four floats, so the
//    S = Q.K and dP = dO.V loops read float4 without bank conflicts.
//  * Masking (the ragged Sk edge, causality with int offsets, segment ids)
//    happens in the kernel; nothing is padded in device memory.  Masked pairs and rows
//    with LSE = NEG_INF (rows that attend to nothing) give P = 0 exactly.
//
// Layout: q, o, dO, dQ are (B, Sq, H, D); k, v, dK, dV are (B, Sk, Hkv, D),
// all contiguous and of one dtype (fp32 or bf16); lse, delta and dlse are
// (B, H, Sq) fp32; q_seg (B, Sq) and kv_seg (B, Sk) are int32 or null;
// dlse may be null.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kBlockQ = 64;  // query rows per tile
constexpr int kBlockK = 64;  // keys per tile
constexpr int kSS = kBlockK + 4;  // row stride of the P / dS tiles

struct BwdParams {
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
  void* dk;
  void* dv;
  int B, H, Hkv, Sq, Sk, q_offset, k_offset, causal;
  float scale;
};

// 16-byte vectors: 4 fp32 or 8 bf16 values.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void to_f32(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  // bf16 is the high half of an fp32: widening is a shift.
  __device__ static void to_f32(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ constexpr int padded(int D) { return D + 4; }

// Copies `cap` tile rows of a (B, S, Hn, D) tensor into shared memory as
// fp32 with row stride D + 4.  Tile row r is source row R = row0 + r:
// position R / rep, head head0 + R % rep (rep = 1 for K/V tiles); rows
// r >= rows are zero-filled.
template <typename T, int D>
__device__ void load_rows(float* dst, const T* src, int S, int Hn, int b, int head0, int rep,
                          int row0, int rows, int cap) {
  constexpr int N = Vec<T>::N;
  constexpr int RV = D / N;
  for (int i = threadIdx.x; i < cap * RV; i += kThreads) {
    const int r = i / RV, d0 = (i % RV) * N;
    float f[N];
    if (r < rows) {
      const int R = row0 + r;
      const uint4 u = *reinterpret_cast<const uint4*>(
          src + ((size_t)(b * S + R / rep) * Hn + head0 + R % rep) * D + d0);
      Vec<T>::to_f32(u, f);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < N; e += 4)
      *reinterpret_cast<float4*>(dst + r * padded(D) + d0 + e) =
          make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
  }
}

// LSE and Delta - dLSE of tile rows (row r = packed row row0 + r of KV head
// hk); rows past `rows` get LSE = NEG_INF, which no live pair reads.
__device__ void load_row_stats(const BwdParams& p, float* sLse, float* sDelta, int b, int hk,
                               int rep, int row0, int rows) {
  for (int r = threadIdx.x; r < kBlockQ; r += kThreads) {
    float l = kNegInf, dl = 0.f;
    if (r < rows) {
      const int R = row0 + r;
      const size_t idx = ((size_t)b * p.H + hk * rep + R % rep) * p.Sq + R / rep;
      l = p.lse[idx];
      dl = p.delta[idx] - (p.dlse != nullptr ? p.dlse[idx] : 0.f);
    }
    sLse[r] = l;
    sDelta[r] = dl;
  }
}

// P and dS of one (row, key) pair of the tiles, or (0, 0) when the pair is
// masked (causality, segments) or outside the tiles (the ragged Sk edge).
template <int D>
__device__ __forceinline__ void p_and_ds(const BwdParams& p, const float* sQ, const float* sDO,
                                         const float* sK, const float* sV, const float* sLse,
                                         const float* sDelta, int b, int rep, int row0, int rows,
                                         int k0, int cols, int r, int c, float& pr, float& ds) {
  constexpr int KS = padded(D);
  pr = ds = 0.f;
  if (r >= rows || c >= cols) return;
  const int kpos = k0 + c;
  const int qpos = (row0 + r) / rep;
  if (p.causal && (long long)p.q_offset + qpos < (long long)p.k_offset + kpos) return;
  if (p.q_seg != nullptr && p.q_seg[b * p.Sq + qpos] != p.kv_seg[b * p.Sk + kpos]) return;
  const float4* qr = reinterpret_cast<const float4*>(sQ + r * KS);
  const float4* dor = reinterpret_cast<const float4*>(sDO + r * KS);
  const float4* kr = reinterpret_cast<const float4*>(sK + c * KS);
  const float4* vr = reinterpret_cast<const float4*>(sV + c * KS);
  float s = 0.f, dp = 0.f;
#pragma unroll
  for (int d = 0; d < D / 4; ++d) {
    const float4 a = qr[d], k4 = kr[d], g = dor[d], v4 = vr[d];
    s = fmaf(a.x, k4.x, s);
    s = fmaf(a.y, k4.y, s);
    s = fmaf(a.z, k4.z, s);
    s = fmaf(a.w, k4.w, s);
    dp = fmaf(g.x, v4.x, dp);
    dp = fmaf(g.y, v4.y, dp);
    dp = fmaf(g.z, v4.z, dp);
    dp = fmaf(g.w, v4.w, dp);
  }
  pr = expf(s * p.scale - sLse[r]);
  ds = pr * (dp - sDelta[r]) * p.scale;
}

// Shared memory, in floats: four (tile rows x D+4) tiles, the P / dS
// tiles and two row vectors.
__host__ __device__ inline size_t smem_floats(int which, int D) {
  const size_t tiles = (size_t)2 * (kBlockQ + kBlockK) * padded(D);
  const size_t pds = (size_t)(which == 0 ? 1 : 2) * kBlockQ * kSS;
  return tiles + pds + 2 * kBlockQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(BwdParams p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int KS = padded(D);
  constexpr int NACC = kBlockQ * D / kThreads;  // rows of dQ one thread owns
  constexpr int RSTEP = kThreads / D;
  float* sQ = smem;
  float* sDO = sQ + kBlockQ * KS;
  float* sK = sDO + kBlockQ * KS;
  float* sV = sK + kBlockK * KS;
  float* sDS = sV + kBlockK * KS;
  float* sLse = sDS + kBlockQ * kSS;
  float* sDelta = sLse + kBlockQ;

  const int hk = blockIdx.y, b = blockIdx.z;
  const int rep = p.H / p.Hkv;
  const int row0 = blockIdx.x * kBlockQ;
  const int rows = min(kBlockQ, p.Sq * rep - row0);
  const int tid = threadIdx.x;
  const int d = tid % D, rbase = tid / D;

  load_rows<T, D>(sQ, static_cast<const T*>(p.q), p.Sq, p.H, b, hk * rep, rep, row0, rows, kBlockQ);
  load_rows<T, D>(sDO, static_cast<const T*>(p.dout), p.Sq, p.H, b, hk * rep, rep, row0, rows,
                  kBlockQ);
  load_row_stats(p, sLse, sDelta, b, hk, rep, row0, rows);

  // Keys this block can see: all Sk, or under causality up to the last
  // row's position (the causal skip).
  int n_keys = p.Sk;
  if (p.causal) {
    const long long live = (long long)p.q_offset + (row0 + rows - 1) / rep + 1 - p.k_offset;
    if (live < n_keys) n_keys = (int)(live > 0 ? live : 0);
  }

  float acc[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < n_keys; k0 += kBlockK) {
    const int cols = min(kBlockK, p.Sk - k0);
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, D>(sK, static_cast<const T*>(p.k), p.Sk, p.Hkv, b, hk, 1, k0, cols, kBlockK);
    load_rows<T, D>(sV, static_cast<const T*>(p.v), p.Sk, p.Hkv, b, hk, 1, k0, cols, kBlockK);
    __syncthreads();
    for (int i = tid; i < kBlockQ * kBlockK; i += kThreads) {
      const int r = i / kBlockK, c = i % kBlockK;
      float pr, ds;
      p_and_ds<D>(p, sQ, sDO, sK, sV, sLse, sDelta, b, rep, row0, rows, k0, cols, r, c, pr, ds);
      sDS[r * kSS + c] = ds;
    }
    __syncthreads();
    // dQ[r, d] += sum_c dS[r, c] K[c, d]
    for (int c = 0; c < cols; ++c) {
      const float kd = sK[c * KS + d];
#pragma unroll
      for (int j = 0; j < NACC; ++j) acc[j] = fmaf(sDS[(rbase + j * RSTEP) * kSS + c], kd, acc[j]);
    }
  }

  T* dQ = static_cast<T*>(p.dq);
#pragma unroll
  for (int j = 0; j < NACC; ++j) {
    const int r = rbase + j * RSTEP;
    if (r < rows) {
      const int R = row0 + r;
      dQ[((size_t)(b * p.Sq + R / rep) * p.H + hk * rep + R % rep) * D + d] = from_f32<T>(acc[j]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(BwdParams p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int KS = padded(D);
  constexpr int NACC = kBlockK * D / kThreads;  // keys of dK/dV one thread owns
  constexpr int CSTEP = kThreads / D;
  float* sK = smem;
  float* sV = sK + kBlockK * KS;
  float* sQ = sV + kBlockK * KS;
  float* sDO = sQ + kBlockQ * KS;
  float* sP = sDO + kBlockQ * KS;
  float* sDS = sP + kBlockQ * kSS;
  float* sLse = sDS + kBlockQ * kSS;
  float* sDelta = sLse + kBlockQ;

  const int hk = blockIdx.y, b = blockIdx.z;
  const int rep = p.H / p.Hkv;
  const int k0 = blockIdx.x * kBlockK;
  const int cols = min(kBlockK, p.Sk - k0);
  const int tid = threadIdx.x;
  const int d = tid % D, cbase = tid / D;

  load_rows<T, D>(sK, static_cast<const T*>(p.k), p.Sk, p.Hkv, b, hk, 1, k0, cols, kBlockK);
  load_rows<T, D>(sV, static_cast<const T*>(p.v), p.Sk, p.Hkv, b, hk, 1, k0, cols, kBlockK);

  // Packed rows that can see this block: all, or under causality from the
  // first position that reaches its first key.
  const int total_rows = p.Sq * rep;
  int r_begin = 0;
  if (p.causal) {
    const long long first = (long long)p.k_offset + k0 - p.q_offset;
    if (first > 0) r_begin = (int)(first < p.Sq ? first : p.Sq) * rep;
  }

  float acc_k[NACC], acc_v[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc_k[j] = acc_v[j] = 0.f;

  for (int row0 = r_begin; row0 < total_rows; row0 += kBlockQ) {
    const int rows = min(kBlockQ, total_rows - row0);
    __syncthreads();  // the previous rows' readers are done
    load_rows<T, D>(sQ, static_cast<const T*>(p.q), p.Sq, p.H, b, hk * rep, rep, row0, rows,
                    kBlockQ);
    load_rows<T, D>(sDO, static_cast<const T*>(p.dout), p.Sq, p.H, b, hk * rep, rep, row0, rows,
                    kBlockQ);
    load_row_stats(p, sLse, sDelta, b, hk, rep, row0, rows);
    __syncthreads();
    for (int i = tid; i < kBlockQ * kBlockK; i += kThreads) {
      const int r = i / kBlockK, c = i % kBlockK;
      float pr, ds;
      p_and_ds<D>(p, sQ, sDO, sK, sV, sLse, sDelta, b, rep, row0, rows, k0, cols, r, c, pr, ds);
      sP[r * kSS + c] = pr;
      sDS[r * kSS + c] = ds;
    }
    __syncthreads();
    // dV[c, d] += sum_r P[r, c] dO[r, d];  dK[c, d] += sum_r dS[r, c] Q[r, d]
    for (int r = 0; r < rows; ++r) {
      const float qd = sQ[r * KS + d], dod = sDO[r * KS + d];
#pragma unroll
      for (int j = 0; j < NACC; ++j) {
        const int c = cbase + j * CSTEP;
        acc_v[j] = fmaf(sP[r * kSS + c], dod, acc_v[j]);
        acc_k[j] = fmaf(sDS[r * kSS + c], qd, acc_k[j]);
      }
    }
  }

  T* dK = static_cast<T*>(p.dk);
  T* dV = static_cast<T*>(p.dv);
#pragma unroll
  for (int j = 0; j < NACC; ++j) {
    const int c = cbase + j * CSTEP;
    if (c < cols) {
      const size_t off = ((size_t)(b * p.Sk + k0 + c) * p.Hkv + hk) * D + d;
      dK[off] = from_f32<T>(acc_k[j]);
      dV[off] = from_f32<T>(acc_v[j]);
    }
  }
}

// Delta[b, h, s] = sum_d dO[b, s, h, d] * O[b, s, h, d].  A CTA covers
// kDeltaPos positions x HEADS heads of batch row blockIdx.z; its rows run
// head-fastest (memory order), a row is L lanes of VPL 16-byte vectors
// each (VPL = 1 up to 32 vectors a row, 2 for fp32 at D = 160's 40; the
// lane count rounded up to a power of two: at D = 40 the lanes past the
// row's 5 (bf16) or 10 (fp32) vectors load nothing and add zero), and
// thread t takes rows t / L + j * (kThreads / L), j < kDeltaRows.
constexpr int kDeltaPos = 32;  // positions per CTA: one 128-byte run of Delta per head
constexpr int kDeltaRows = 8;  // rows per thread, all loads in flight together

__host__ __device__ constexpr int pow2_ceil(int n) { return n <= 1 ? 1 : 2 * pow2_ceil((n + 1) / 2); }

template <typename T, int D>
struct DeltaCfg {
  static constexpr int VECS = D / Vec<T>::N;              // 16-byte vectors per row
  static constexpr int VPL = (VECS + 31) / 32;            // vectors per lane: a row in one warp
  static constexpr int L = pow2_ceil((VECS + VPL - 1) / VPL);  // lanes per row
  static constexpr int PASS = kThreads / L;               // rows per pass of the CTA
  static constexpr int HEADS = PASS * kDeltaRows / kDeltaPos;
  static_assert(HEADS >= 1 && HEADS * kDeltaPos == PASS * kDeltaRows, "whole runs of positions");
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_delta_kernel(const T* o, const T* dout, float* delta, int Sq, int H) {
  using C = DeltaCfg<T, D>;
  constexpr int L = C::L, HEADS = C::HEADS, VPL = C::VPL;
  __shared__ float tile[HEADS][kDeltaPos + 1];
  const int s0 = blockIdx.x * kDeltaPos, h0 = blockIdx.y * HEADS, b = blockIdx.z;
  const int part = threadIdx.x % L, first = threadIdx.x / L;
  uint4 ov[kDeltaRows][VPL], dv[kDeltaRows][VPL];
#pragma unroll
  for (int j = 0; j < kDeltaRows; ++j) {
    const int row = first + j * C::PASS, s = s0 + row / HEADS, h = h0 + row % HEADS;
#pragma unroll
    for (int u = 0; u < VPL; ++u) {
      const int vec = part + u * L;
      ov[j][u] = dv[j][u] = make_uint4(0u, 0u, 0u, 0u);
      if (s < Sq && h < H && vec < C::VECS) {
        const size_t off = ((size_t)(b * Sq + s) * H + h) * D + vec * Vec<T>::N;
        // read once: evict-first in L2, so no other line is pushed out for them
        ov[j][u] = __ldcs(reinterpret_cast<const uint4*>(o + off));
        dv[j][u] = __ldcs(reinterpret_cast<const uint4*>(dout + off));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kDeltaRows; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int u = 0; u < VPL; ++u) {
      float fo[Vec<T>::N], fd[Vec<T>::N];
      Vec<T>::to_f32(ov[j][u], fo);
      Vec<T>::to_f32(dv[j][u], fd);
#pragma unroll
      for (int e = 0; e < Vec<T>::N; ++e) acc = fmaf(fd[e], fo[e], acc);
    }
#pragma unroll
    for (int w = L / 2; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
    const int row = first + j * C::PASS;
    if (part == 0) tile[row % HEADS][row / HEADS] = acc;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < HEADS * kDeltaPos; i += kThreads) {
    const int h = h0 + i / kDeltaPos, s = s0 + i % kDeltaPos;
    if (s < Sq && h < H) delta[((size_t)b * H + h) * Sq + s] = tile[i / kDeltaPos][i % kDeltaPos];
  }
}

template <typename T, int D>
int launch_delta(const void* o, const void* dout, float* delta, int B, int Sq, int H,
                 cudaStream_t s) {
  constexpr int HEADS = DeltaCfg<T, D>::HEADS;
  const dim3 grid((Sq + kDeltaPos - 1) / kDeltaPos, (H + HEADS - 1) / HEADS, B);
  flash_bwd_delta_kernel<T, D><<<grid, kThreads, 0, s>>>(static_cast<const T*>(o),
                                                           static_cast<const T*>(dout), delta, Sq, H);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_delta(int D, const void* o, const void* dout, float* delta, int B, int Sq, int H,
                   cudaStream_t s) {
  switch (D) {
    case 16: return launch_delta<T, 16>(o, dout, delta, B, Sq, H, s);
    case 32: return launch_delta<T, 32>(o, dout, delta, B, Sq, H, s);
    case 40: return launch_delta<T, 40>(o, dout, delta, B, Sq, H, s);
    case 64: return launch_delta<T, 64>(o, dout, delta, B, Sq, H, s);
    case 80: return launch_delta<T, 80>(o, dout, delta, B, Sq, H, s);
    case 128: return launch_delta<T, 128>(o, dout, delta, B, Sq, H, s);
    case 160: return launch_delta<T, 160>(o, dout, delta, B, Sq, H, s);
    default: return -1;
  }
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, size_t smem, const BwdParams& p, void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// which: 0 = dQ (K2), 1 = dK/dV (K3).
template <typename T, int D>
int launch_d(int which, const BwdParams& p, void* stream) {
  const size_t smem = smem_floats(which, D) * sizeof(float);
  if (which == 0) {
    const dim3 grid((p.Sq * (p.H / p.Hkv) + kBlockQ - 1) / kBlockQ, p.Hkv, p.B);
    return launch(flash_bwd_dq_kernel<T, D>, grid, smem, p, stream);
  }
  const dim3 grid((p.Sk + kBlockK - 1) / kBlockK, p.Hkv, p.B);
  return launch(flash_bwd_dkv_kernel<T, D>, grid, smem, p, stream);
}

template <typename T>
int dispatch_d(int which, int D, const BwdParams& p, void* stream) {
  switch (D) {
    case 16: return launch_d<T, 16>(which, p, stream);
    case 64: return launch_d<T, 64>(which, p, stream);
    case 128: return launch_d<T, 128>(which, p, stream);
    default: return -1;
  }
}

int run(int which, const void* q, const void* k, const void* v, const void* dout, const float* lse,
        const float* delta, const float* dlse, const int* q_seg, const int* kv_seg, void* dq,
        void* dk, void* dv, int B, int H, int Hkv, int Sq, int Sk, int D, int q_offset,
        int k_offset, int causal, float scale, int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  BwdParams p{q,  k, v, dout, lse, delta, dlse,     q_seg,    kv_seg, dq,   dk,
              dv, B, H, Hkv,  Sq,  Sk,    q_offset, k_offset, causal, scale};
  return is_bf16 ? dispatch_d<__nv_bfloat16>(which, D, p, stream)
                 : dispatch_d<float>(which, D, p, stream);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA of dQ (which = 0) or dK/dV
// (which = 1) needs at head dim D.
size_t flash_bwd_smem_bytes(int which, int D) { return smem_floats(which, D) * sizeof(float); }

// Each launcher returns cudaGetLastError() after its launch (0 on
// success), or -1 for an unsupported head dim.
int flash_bwd_delta(const void* o, const void* dout, float* delta, int B, int Sq, int H, int D,
                    int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_delta<__nv_bfloat16>(D, o, dout, delta, B, Sq, H, s)
                 : dispatch_delta<float>(D, o, dout, delta, B, Sq, H, s);
}

int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                 const float* delta, const float* dlse, const int* q_seg, const int* kv_seg,
                 void* dq, int B, int H, int Hkv, int Sq, int Sk, int D, int q_offset,
                 int k_offset, int causal, float scale, int is_bf16, int device, void* stream) {
  return run(0, q, k, v, dout, lse, delta, dlse, q_seg, kv_seg, dq, nullptr, nullptr, B, H, Hkv,
             Sq, Sk, D, q_offset, k_offset, causal, scale, is_bf16, device, stream);
}

int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                  const float* delta, const float* dlse, const int* q_seg, const int* kv_seg,
                  void* dk, void* dv, int B, int H, int Hkv, int Sq, int Sk, int D,
                  int q_offset, int k_offset, int causal, float scale, int is_bf16, int device,
                  void* stream) {
  return run(1, q, k, v, dout, lse, delta, dlse, q_seg, kv_seg, nullptr, dk, dv, B, H, Hkv, Sq,
             Sk, D, q_offset, k_offset, causal, scale, is_bf16, device, stream);
}

const char* flash_bwd_error_string(int err) {
  return err < 0 ? "unsupported head dim" : cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
