// FlashAttention-2 forward for Hopper (sm_90a), plain shared-memory tiles:
// K1's "fma" variant, for fp32 and for bf16 calls with 17 to 63 packed
// rows per (batch row, KV head).  bf16 calls with more run the
// tensor-core kernel in flash_fwd_sm90.cu, with at most 16 (decode) the
// one in flash_fwd_decode_sm90.cu.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in
// tpucfn/kernels/flash_attention.py (launched by `_flash_fwd`): it
// computes O = softmax(mask(Q K^T * D^-1/2)) V and LSE = m + log l with an
// online softmax in fp32, masks by kv_len, causality with per-row query
// offsets, and segment ids, and reads GQA KV head h / rep without
// repeating K/V.  Rows that attend to nothing give O = 0 and
// LSE = NEG_INF (-1e30, finite), never NaN.
//
// What bounds it on an H100.  Decode (one query row per slot over a long
// KV cache) is bound by the K/V bytes it must read: its arithmetic is
// about one FMA per byte read.  A long prefill is bound by operations
// (2 * Sq * Sk * D multiply-adds per head for QK^T and PV).
//
// What the design does about that.
//  * A CTA's rows are (query position, query head) pairs of one KV head,
//    position-major (GQA packing): the rep query heads that share a KV
//    head share every K/V tile load, with no KV repeat.  A decode slot's
//    rep heads are the rows of one CTA.
//  * One CTA per (row block, KV head, batch row) walks its KV tiles,
//    keeping the running max m, the sum l and the fp32 accumulator in
//    shared memory.
//  * Causal skip: a CTA reads its batch row's query offset from memory and
//    stops at the last key its last row can see, q_offset[b] + last
//    position - k_offset.  A decode slot therefore reads only its live
//    prefix of the cache, not all of cache_len — the byte bound's lever.
//    This replaces the TPU kernel's "re-fetch block 0" index-map trick.
//  * Split-KV: when those CTAs alone would not fill the card (decode, short
//    prefills over a long cache), n_split CTAs share each one and walk a
//    slice of its KV tiles apiece, so the longest slot's serial walk is
//    cut n_split-fold; a second, small kernel merges their (m, l, acc).
//  * K/V tiles move as 16-byte vectors staged through registers: all of a
//    tile's loads are issued at once, and the next tile's loads are in
//    flight while the current one computes.
//  * Arithmetic is fp32 FMA for both bf16 and fp32 inputs (no TF32), as
//    in the TPU kernel.  Tiles are widened to fp32 as they land in shared
//    memory; Q and K rows are padded by four floats so the S = QK^T loop
//    reads them as float4 without bank conflicts.
//  * No tensor cores: fp32 stays fp32 (no TF32), and a decode CTA has a
//    few rows where a wgmma tile has 64.
//
// Layout: q, o are (B, Sq, H, D); k, v are (B, Sk, Hkv, D), all
// contiguous; lse is (B, H, Sq) fp32; q_offset is int32 (B,); q_seg
// (B, Sq) and kv_seg (B, Sk) are int32 or null.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;

struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  const int* q_offset;
  const int* q_seg;
  const int* kv_seg;
  int B, H, Hkv, Sq, Sk, kv_len, k_offset, causal, block_q, block_k;
  float scale;
  // Split-KV: n_split CTAs share one (q-block, head, row) and each walks
  // split_tiles KV tiles; with n_split > 1 they write unnormalized
  // partials (o_part: acc, ml_part: m then l) that a combine pass merges.
  int n_split, split_tiles;
  float* o_part;
  float* ml_part;
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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Row stride, in floats, of the Q and K tiles: D + 4 keeps rows 16-byte
// aligned for float4 access, and makes the float4 reads of eight
// consecutive K rows (one quarter-warp) fall in distinct bank groups.
__host__ __device__ constexpr int padded(int D) { return D + 4; }

// Shared memory, in floats, for one CTA.
__host__ __device__ inline size_t smem_floats(int D, int bq, int bk) {
  const size_t ks = (size_t)padded(D);
  return bq * ks            // Q tile
         + bk * ks          // K tile
         + (size_t)bk * D   // V tile
         + (size_t)bq * bk  // S, then P
         + (size_t)bq * D   // accumulator
         + 3 * (size_t)bq;  // m, l, alpha
}

// Global -> shared staging of a K/V tile: each thread holds up to kVecs
// 16-byte vectors of K and of V in registers, so all of a chunk's loads
// are in flight at once (and the next tile's, while this one computes).
constexpr int kVecs = 4;

template <typename T, int D>
struct KVTile {
  static constexpr int N = Vec<T>::N;
  static constexpr int RV = D / N;  // vectors per row
  uint4 k[kVecs], v[kVecs];

  // Vectors [base, base + kVecs * kThreads) of the tile at key k0.
  __device__ void load(const FwdParams& p, const T* K, const T* V, int b, int hk, int k0,
                       int cols, int nvec, int base) {
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int idx = base + j * kThreads + threadIdx.x;
      const int c = idx / RV, dv = idx % RV;
      k[j] = v[j] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < nvec && c < cols) {
        const size_t off = ((size_t)(b * p.Sk + k0 + c) * p.Hkv + hk) * D + dv * N;
        k[j] = *reinterpret_cast<const uint4*>(K + off);
        v[j] = *reinterpret_cast<const uint4*>(V + off);
      }
    }
  }

  __device__ void store(float* sK, float* sV, int nvec, int base) const {
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int idx = base + j * kThreads + threadIdx.x;
      if (idx < nvec) {
        const int c = idx / RV, d0 = (idx % RV) * N;
        float f[N];
        Vec<T>::to_f32(k[j], f);
#pragma unroll
        for (int e = 0; e < N; e += 4)
          *reinterpret_cast<float4*>(sK + c * padded(D) + d0 + e) =
              make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
        Vec<T>::to_f32(v[j], f);
#pragma unroll
        for (int e = 0; e < N; e += 4)
          *reinterpret_cast<float4*>(sV + c * D + d0 + e) =
              make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
      }
    }
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FwdParams p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int KS = padded(D);
  constexpr int N = Vec<T>::N;
  constexpr int RV = D / N;
  const int bq = p.block_q, bk = p.block_k;
  float* sQ = smem;
  float* sK = sQ + bq * KS;
  float* sV = sK + bk * KS;
  float* sS = sV + bk * D;
  float* sAcc = sS + bq * bk;
  float* sM = sAcc + bq * D;
  float* sL = sM + bq;
  float* sAlpha = sL + bq;

  // A row is one (query position, query head) pair of KV head hk; rows run
  // position-major, so row R is position R / rep of head hk * rep + R % rep.
  const int rb = blockIdx.x / p.n_split, split = blockIdx.x % p.n_split;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int rep = p.H / p.Hkv;
  const int row0 = rb * bq;
  const int rows = min(bq, p.Sq * rep - row0);  // real rows of this block
  const int q_off = p.q_offset[b];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;

  const T* Q = static_cast<const T*>(p.q);
  const T* K = static_cast<const T*>(p.k);
  const T* V = static_cast<const T*>(p.v);
  T* O = static_cast<T*>(p.o);

  for (int i = tid; i < rows * RV; i += kThreads) {
    const int r = i / RV, d0 = (i % RV) * N;
    const uint4 u = *reinterpret_cast<const uint4*>(
        Q + ((size_t)(b * p.Sq + (row0 + r) / rep) * p.H + hk * rep + (row0 + r) % rep) * D + d0);
    float f[N];
    Vec<T>::to_f32(u, f);
#pragma unroll
    for (int e = 0; e < N; ++e) sQ[r * KS + d0 + e] = f[e];
  }
  for (int i = tid; i < rows * D; i += kThreads) sAcc[i] = 0.f;
  for (int r = tid; r < rows; r += kThreads) {
    sM[r] = kNegInf;
    sL[r] = 0.f;
  }

  // Keys this block can see: all of kv_len, or under causality up to the
  // last live row's position (the causal skip).
  int n_keys = p.kv_len;
  if (p.causal) {
    const long long live = (long long)q_off + (row0 + rows - 1) / rep + 1 - p.k_offset;
    if (live < n_keys) n_keys = (int)(live > 0 ? live : 0);
  }
  const int n_tiles = n_keys > 0 ? (n_keys + bk - 1) / bk : 0;
  const int t_begin = split * p.split_tiles;
  const int t_end = min(n_tiles, t_begin + p.split_tiles);
  const int nvec = bk * RV;                         // vectors per K (or V) tile
  const bool one_chunk = nvec <= kVecs * kThreads;  // then prefetch across tiles
  KVTile<T, D> stage;
  if (one_chunk && t_begin < t_end)
    stage.load(p, K, V, b, hk, t_begin * bk, min(bk, p.Sk - t_begin * bk), nvec, 0);
  __syncthreads();

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * bk;
    if (one_chunk) {
      stage.store(sK, sV, nvec, 0);
    } else {
      for (int base = 0; base < nvec; base += kVecs * kThreads) {
        stage.load(p, K, V, b, hk, k0, min(bk, p.Sk - k0), nvec, base);
        stage.store(sK, sV, nvec, base);
      }
    }
    __syncthreads();
    // The next tile's loads fly while this one computes.
    if (one_chunk && t + 1 < t_end)
      stage.load(p, K, V, b, hk, k0 + bk, min(bk, p.Sk - k0 - bk), nvec, 0);

    // S = Q K^T * scale, masked.
    for (int i = tid; i < rows * bk; i += kThreads) {
      const int r = i / bk, c = i % bk;
      const float4* qr = reinterpret_cast<const float4*>(sQ + r * KS);
      const float4* kr = reinterpret_cast<const float4*>(sK + c * KS);
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D / 4; ++d) {
        const float4 a = qr[d], k4 = kr[d];
        s = fmaf(a.x, k4.x, s);
        s = fmaf(a.y, k4.y, s);
        s = fmaf(a.z, k4.z, s);
        s = fmaf(a.w, k4.w, s);
      }
      s *= p.scale;
      const int kpos = k0 + c;
      bool keep = kpos < p.kv_len;
      const int qpos = (row0 + r) / rep;
      if (keep && p.causal) keep = (long long)q_off + qpos >= (long long)p.k_offset + kpos;
      if (keep && p.q_seg != nullptr)
        keep = p.q_seg[b * p.Sq + qpos] == p.kv_seg[b * p.Sk + kpos];
      sS[r * bk + c] = keep ? s : kNegInf;
    }
    __syncthreads();

    // Online softmax, one warp per row: masked entries give p = 0 exactly,
    // so a row with nothing live keeps l = 0.
    for (int r = warp; r < rows; r += kWarps) {
      float mx = kNegInf;
      for (int c = lane; c < bk; c += 32) mx = fmaxf(mx, sS[r * bk + c]);
      mx = warp_max(mx);
      const float m_prev = sM[r];
      const float m_cur = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < bk; c += 32) {
        const float s = sS[r * bk + c];
        const float pr = s > 0.5f * kNegInf ? expf(s - m_cur) : 0.f;
        sS[r * bk + c] = pr;
        sum += pr;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = m_prev > 0.5f * kNegInf ? expf(m_prev - m_cur) : 0.f;
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_cur;
        sAlpha[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V.
    for (int i = tid; i < rows * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const float* pr = sS + r * bk;
      float a = 0.f;
      for (int c = 0; c < bk; ++c) a = fmaf(pr[c], sV[c * D + d], a);
      sAcc[r * D + d] = sAcc[r * D + d] * sAlpha[r] + a;
    }
    __syncthreads();
  }

  // Row r's index in the (B, H, Sq) order of LSE and of the partials.
  auto bhs = [&](int r) {
    const int R = row0 + r;
    return ((size_t)b * p.H + hk * rep + R % rep) * p.Sq + R / rep;
  };
  if (p.n_split > 1) {  // partials, merged by flash_fwd_combine
    const size_t all = (size_t)p.B * p.H * p.Sq;
    const size_t base = (size_t)split * all;
    for (int i = tid; i < rows * D; i += kThreads)
      p.o_part[(base + bhs(i / D)) * D + i % D] = sAcc[i];
    for (int r = tid; r < rows; r += kThreads) {
      p.ml_part[base + bhs(r)] = sM[r];
      p.ml_part[p.n_split * all + base + bhs(r)] = sL[r];
    }
    return;
  }
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D, d = i % D, R = row0 + r;
    const float l = sL[r];
    const float o = l > 0.f ? sAcc[r * D + d] / l : 0.f;
    O[((size_t)(b * p.Sq + R / rep) * p.H + hk * rep + R % rep) * D + d] = from_f32<T>(o);
  }
  for (int r = tid; r < rows; r += kThreads) {
    const float l = sL[r];
    p.lse[bhs(r)] = l > 0.f ? sM[r] + logf(l) : kNegInf;
  }
}

// Merges the split-KV partials: one warp per (b, h, query row).  The
// online-softmax merge of the n_split (m, l, acc) triples, then O = acc/l
// and LSE = m + log l, with the same empty-row rule as the main kernel.
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_combine(FwdParams p, int D) {
  __shared__ float sW[kThreads / 32][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t rows = (size_t)p.B * p.H * p.Sq;
  const size_t w = (size_t)blockIdx.x * (kThreads / 32) + warp;  // (b*H + h)*Sq + row
  if (w >= rows) return;
  const float m_s = lane < p.n_split ? p.ml_part[lane * rows + w] : kNegInf;
  const float l_s = lane < p.n_split ? p.ml_part[(p.n_split + lane) * rows + w] : 0.f;
  const float m = warp_max(m_s);
  const float wgt = m_s > 0.5f * kNegInf ? expf(m_s - m) : 0.f;
  const float l = warp_sum(l_s * wgt);
  sW[warp][lane] = wgt;
  __syncwarp();
  const int row = (int)(w % p.Sq), h = (int)(w / p.Sq % p.H), b = (int)(w / ((size_t)p.Sq * p.H));
  T* O = static_cast<T*>(p.o);
  for (int d = lane; d < D; d += 32) {
    float acc = 0.f;
    for (int s = 0; s < p.n_split; ++s) acc = fmaf(p.o_part[(s * rows + w) * D + d], sW[warp][s], acc);
    O[((size_t)(b * p.Sq + row) * p.H + h) * D + d] = from_f32<T>(l > 0.f ? acc / l : 0.f);
  }
  if (lane == 0) p.lse[w] = l > 0.f ? m + logf(l) : kNegInf;
}

template <typename T, int D>
int launch(const FwdParams& p, void* stream) {
  const size_t smem = smem_floats(D, p.block_q, p.block_k) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = p.Sq * (p.H / p.Hkv);
  const dim3 grid((rows + p.block_q - 1) / p.block_q * p.n_split, p.Hkv, p.B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.n_split == 1) return (int)err;
  const size_t warps = (size_t)p.B * p.H * p.Sq;
  flash_fwd_combine<T><<<(unsigned)((warps + kThreads / 32 - 1) / (kThreads / 32)), kThreads, 0, s>>>(p, D);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const FwdParams& p, void* stream) {
  switch (D) {
    case 16: return launch<T, 16>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA needs (the wrapper checks it
// against the card's limit before launching, to raise a clear error).
size_t flash_fwd_smem_bytes(int D, int block_q, int block_k) {
  return smem_floats(D, block_q, block_k) * sizeof(float);
}

// Launches the kernel (and, with n_split > 1, its combine pass) on
// `stream`; returns cudaGetLastError() after the launches (0 on success),
// or -1 for an unsupported head dim.  o_part holds n_split*B*H*Sq*D
// floats and ml_part 2*n_split*B*H*Sq; both may be null when n_split is 1.
int flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
              const int* q_offset, const int* q_seg, const int* kv_seg, float* o_part,
              float* ml_part, int B, int H, int Hkv, int Sq, int Sk, int D, int kv_len,
              int k_offset, int causal, float scale, int block_q, int block_k,
              int n_split, int split_tiles, int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  FwdParams p{q,       k,       v,     o,       lse,         q_offset, q_seg,  kv_seg,
              B,       H,       Hkv,   Sq,      Sk,          kv_len,   k_offset, causal,
              block_q, block_k, scale, n_split, split_tiles, o_part,   ml_part};
  return is_bf16 ? dispatch_d<__nv_bfloat16>(D, p, stream) : dispatch_d<float>(D, p, stream);
}

const char* flash_fwd_error_string(int err) {
  return err < 0 ? "unsupported head dim" : cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
