// Hopper (sm_90a) building blocks shared by the tensor-core flash kernels
// (flash_fwd_sm90.cu, flash_bwd_dq_sm90.cu, flash_bwd_dkv_sm90.cu): TMA
// tensor maps and loads,
// mbarriers, and warpgroup matrix multiplies (wgmma) with their shared
// memory descriptors; and for the mma.sync kernels (flash_fwd_decode_sm90.cu,
// flash_fwd_mma_sm90.cu, flash_bwd_dq_mma_sm90.cu, flash_bwd_dkv_mma_sm90.cu)
// cp.async, ldmatrix, mma.sync in bf16 and in tf32, the 3xTF32 split and
// the result stores.  Plain inline PTX; no CUTLASS.
//
// Shared-memory tiles.  A tile of R rows x D bf16 values is loaded by TMA
// with the swizzle that its row width allows: a D = 64 row is 128 bytes,
// one 128-byte swizzle atom wide (SW128); wider tiles are loaded as
// 64-column blocks, each an SW128 block of R x 64, one after the other
// (two at D = 128); a D = 32 row is 64 bytes (SW64) and a D = 16 row 32
// bytes (SW32).  A head dim above 32 that is not a multiple of 64 (40, 80,
// 160) is padded to the next one (tile_cols: 64, 128, 192): its last box
// lies partly past a tensor map whose innermost extent is D, so TMA fills
// the columns past D with zeros and the products see a zero-padded tile;
// the reduction over D stops at the first 16-column slice past D
// (k_steps: 48 of 64 at D = 40, exactly 80 and 160 at the others), and
// the kernels store only the D real columns of each output row, which in
// global memory is the next head's start.  Every tile starts on a
// 1024-byte boundary, so the swizzle pattern that TMA writes is the one
// that the wgmma descriptor names.
//
// Descriptors (PTX ISA, "matrix descriptor"; the canonical layouts are
// those of CUTLASS's make_gmma_desc):
//  * K-major (the reduced dimension contiguous, e.g. K for S = Q K^T): rows
//    are `pitch` bytes apart, eight rows make one swizzle atom, and SBO is
//    the step between atoms, 8 * pitch.  A 16-wide K slice is the atom's
//    start address plus 32 bytes per slice; LBO is unused.
//  * MN-major (the output dimension contiguous, e.g. V for O += P V): the
//    reduced dimension runs down the rows, so SBO = 8 * pitch steps eight
//    rows of it and LBO steps from one 64-column half block to the next.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <type_traits>

namespace sm90 {

// Error codes returned beside cudaError_t values (which are >= 0).
constexpr int kErrHeadDim = -1;
constexpr int kErrTensorMap = -2;
constexpr int kErrDriver = -3;
constexpr int kErrGroup = -4;

inline const char* error_string(int err) {
  switch (err) {
    case kErrHeadDim: return "unsupported head dim";
    case kErrTensorMap: return "cuTensorMapEncodeTiled refused the tensor map";
    case kErrDriver: return "cuTensorMapEncodeTiled not found in libcuda";
    case kErrGroup: return "query heads per KV head must divide 64";
    default: return cudaGetErrorString((cudaError_t)err);
  }
}

// ---- host: tensor maps -------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's encoder, looked up once in the libcuda the process already
// runs on (no link-time dependency on the driver library).
inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (h == nullptr) h = dlopen("libcuda.so", RTLD_NOW | RTLD_GLOBAL);
    return h ? reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// Columns of a shared-memory tile: D up to 32, else D rounded up to whole
// 64-column SW128 boxes (40 -> 64, 80 -> 128, 160 -> 192; zero-padded).
__host__ __device__ constexpr int tile_cols(int D) { return D <= 32 ? D : (D + 63) / 64 * 64; }
// 16-wide K slices of a product that reduces over D: the columns past D
// are zero, so the padded tile's 16-column slices past D are skipped
// (40 -> 48 of 64; 80 and 160 reduce over exactly D).
__host__ __device__ constexpr int k_steps(int D) { return (D + 15) / 16; }
// Width in bf16 of one TMA box row, and its swizzle: 64 (SW128) for tiles
// of 64 columns or more, else the tile's width (32: SW64, 16: SW32).
__host__ __device__ constexpr int box_cols(int D) {
  return tile_cols(D) >= 64 ? 64 : tile_cols(D);
}
__host__ __device__ constexpr int pitch_bytes(int D) { return box_cols(D) * 2; }

// A 4-D map over a contiguous (B, S, Hn, D) bf16 tensor, dims innermost
// first (D, Hn, S, B), box (box_cols(D), heads, rows, 1): a box of `heads`
// adjacent heads at `rows` positions lands as rows * heads tile rows,
// position-major, which is the GQA row packing.  Out-of-range positions
// (and at D = 40, 80 and 160 the last box's columns past D) are filled
// with zeros.
inline int make_map(CUtensorMap* map, const void* base, int B, int S, int Hn, int D, int heads,
                    int rows) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return kErrDriver;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hn, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)Hn * D * 2,
                                 (cuuint64_t)S * Hn * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols(D), (cuuint32_t)heads, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = pitch_bytes(D) == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : pitch_bytes(D) == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                       : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                         strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

// ---- device: shared memory, mbarriers, TMA -----------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.  A
// wait of about ten seconds (2^34 cycles) can only be a deadlock: it traps,
// so the launch fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}

// TMA: the box of `map` at coordinates (c0, c1, c2, c3) into shared memory
// at `dst`, completing `bytes` on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Loads an R x tile_cols(D) tile (R = heads * rows) at coordinates (head,
// pos, b): one box, or one 64-column box per block for tiles of 128 and
// 192 columns.
template <int D>
__device__ __forceinline__ void tma_tile(__nv_bfloat16* dst, const CUtensorMap* map,
                                         uint64_t* bar, int R, int head, int pos, int b) {
#pragma unroll
  for (int h = 0; h < tile_cols(D) / box_cols(D); ++h)
    tma_load_4d(dst + h * R * box_cols(D), map, bar, h * box_cols(D), head, pos, b);
}

// ---- device: wgmma -------------------------------------------------------------

__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo, uint32_t sbo, int D) {
  const uint64_t layout = pitch_bytes(D) == 128 ? 1 : pitch_bytes(D) == 64 ? 2 : 3;  // SW128/64/32
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | layout << 62;
}

// K-major operand: rows [0, R) of an R x D tile, K slice kk (16 wide).
template <int D>
__device__ __forceinline__ uint64_t desc_kmajor(const __nv_bfloat16* tile, int R, int kk) {
  constexpr int W = box_cols(D);
  const __nv_bfloat16* p = tile + (kk * 16 / W) * R * W + (kk * 16 % W);
  return make_desc(p, 16, 8 * pitch_bytes(D), D);
}

// MN-major operand: rows [16 kk, 16 kk + 16) of an R x D tile as the
// reduced dimension, all tile_cols(D) columns as the output dimension.
template <int D>
__device__ __forceinline__ uint64_t desc_mnmajor(const __nv_bfloat16* tile, int R, int kk) {
  constexpr int W = box_cols(D);
  return make_desc(tile + kk * 16 * W, R * pitch_bytes(D), 8 * pitch_bytes(D), D);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from touching an accumulator while a wgmma that
// writes it is in flight (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D(64 x 64, fp32) (+)= A(64 x 16) * B(16 x 64); A and B bf16 in shared
// memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D(64 x 128, fp32) (+)= A(64 x 16) * B(16 x 128); A and B bf16 in shared
// memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D(64 x 16, fp32) += A(64 x 16) * B(16 x 16); A bf16 in registers (the
// accumulator layout of a previous product), B bf16 in shared memory,
// MN-major.
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 32, fp32) += A(64 x 16) * B(16 x 32); A bf16 in registers (the
// accumulator layout of a previous product), B bf16 in shared memory,
// MN-major.
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 64, fp32) += A(64 x 16) * B(16 x 64); A bf16 in registers (the
// accumulator layout of a previous product), B bf16 in shared memory,
// MN-major.
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 128, fp32) += A(64 x 16) * B(16 x 128); A bf16 in registers (the
// accumulator layout of a previous product), B bf16 in shared memory,
// MN-major.
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 192, fp32) += A(64 x 16) * B(16 x 192); A bf16 in registers (the
// accumulator layout of a previous product), B bf16 in shared memory,
// MN-major: the products into a 192-column tile (D = 160, padded).
__device__ __forceinline__ void wgmma_rs_n192(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int accumulate) {
  static_assert(N == 64 || N == 128, "wgmma_ss: N is 64 or 128");
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, accumulate);
  else wgmma_ss_n128(d, da, db, accumulate);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128 || N == 192,
                "wgmma_rs: N is 16, 32, 64, 128 or 192");
  if constexpr (N == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n192(d, a, db);
}

// ---- device: cp.async, ldmatrix, mma.sync ------------------------------------
// The warp-level path of the mma.sync kernels (flash_fwd_decode_sm90.cu,
// flash_fwd_mma_sm90.cu, flash_bwd_dkv_mma_sm90.cu).

// An L2 policy that evicts the lines it tags first (data read once).
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// 16 bytes from global to shared memory, bypassing L1, tagged with an L2
// `policy`; `bytes` = 0 fills zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes,
                                           uint64_t policy) {
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::"r"(dst),
               "l"(src), "r"(bytes), "l"(policy)
               : "memory");
}

// The same with no L2 hint, for rows that other CTAs read again.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

// 4 bytes from global to shared memory; `bytes` = 0 fills zeros.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Two 8 x 8 bf16 matrices; lanes 0-7 and 8-15 give their rows' addresses.
__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}
// Four 8 x 8 bf16 matrices; lanes 8i .. 8i + 7 give matrix i's rows.
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// C(16 x 8, fp32) += A(16 x 16) B(16 x 8), bf16 operands in registers.
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// C(16 x 8, fp32) += A(16 x 8) B(8 x 8), tf32 operands in registers.
__device__ __forceinline__ void mma1688_tf32(float* c, const uint32_t* a, uint32_t b0,
                                             uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32 (CUTLASS's "fast fp32"): x = big + small, each a tf32 value
// (big = tf32(x), small = tf32(x - big), the subtraction exact in fp32),
// and a product of fp32 operands is big.big + big.small + small.big,
// accumulated in fp32 (small.small, ~2^-22 relative, is dropped).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
template <int N>
__device__ __forceinline__ void split_tf32(const float* x, uint32_t* big, uint32_t* small) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    big[i] = to_tf32(x[i]);
    small[i] = to_tf32(x[i] - __uint_as_float(big[i]));
  }
}
__device__ __forceinline__ void mma1688_3xtf32(float* c, const uint32_t* a_big,
                                               const uint32_t* a_small, const uint32_t* b_big,
                                               const uint32_t* b_small) {
  mma1688_tf32(c, a_small, b_big[0], b_big[1]);
  mma1688_tf32(c, a_big, b_small[0], b_small[1]);
  mma1688_tf32(c, a_big, b_big[0], b_big[1]);
}

// 2^x on the special-function unit, subnormal results flushed to zero (the
// softmax's smallest terms; exp2f without fast math adds a rescale around
// the same instruction to keep them).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The 64 x 16 A fragment of columns [16 kk, 16 kk + 16) of a 64 x N fp32
// accumulator, rounded to bf16: the accumulator's register layout is the
// A operand's, so no data moves between threads.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ void a_frag(const float* acc, int kk, uint32_t* a) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = pack_bf16(acc[8 * kk + 2 * i], acc[8 * kk + 2 * i + 1]);
}

// Two or four consecutive fp32 results stored as T (float or bf16), in one
// 8- or 16-byte (fp32) or 4- or 8-byte (bf16) store: the mma kernels' output.
template <typename T>
__device__ __forceinline__ void store2(T* dst, float a, float b) {
  if constexpr (std::is_same<T, float>::value)
    *reinterpret_cast<float2*>(dst) = make_float2(a, b);
  else
    *reinterpret_cast<uint32_t*>(dst) = pack_bf16(a, b);
}

template <typename T>
__device__ __forceinline__ void store4(T* dst, float a, float b, float c, float d) {
  if constexpr (std::is_same<T, float>::value)
    *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
  else
    *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(a, b), pack_bf16(c, d));
}

}  // namespace sm90
