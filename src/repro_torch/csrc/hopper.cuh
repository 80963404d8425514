// Hopper (sm_90a) building blocks shared by the tensor-core kernels
// (prefill_attn_tc.cu, ptc_wide_tc.cu, ptc_wide_3xtf32.cu): wgmma
// shared-memory descriptors and products (bf16 and tf32), mbarriers, TMA
// tile loads, and the host-side tensor-map encoder.
// Included by each .cu file, which is compiled into its own library
// (kernels/build.py hashes every csrc/*.cuh header into every library name,
// so an edited header is never served a stale build).

#pragma once

#include <cuda.h>           // CUtensorMap and its enums; no libcuda link
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// error codes past the CUDA runtime's: cuTensorMapEncodeTiled failed
constexpr int kEncodeError = 100000;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor, 128-byte swizzle: 8-row groups 1024 B
// apart (SBO); LBO is unused by every operand here (each spans one swizzle
// atom, 64 bf16, along its contiguous dimension).  The same descriptor
// serves K-major operands (rows along M or N, 64 K values a row; a k16
// step is +32 B) and MN-major ones (rows along K, 64 M or N values a row;
// a k16 step is +2048 B) of 64 rows or columns.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;                 // LBO (unused), 16 B
  d |= (uint64_t)(1024 >> 4) << 32;       // SBO
  d |= (uint64_t)1 << 62;                 // SWIZZLE_128B
  return d;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// after every mbar_init of a CTA, before any thread uses the barriers
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// a tile that never arrives (a refused copy) stops the kernel with a trap
// after some seconds of waiting instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// shared-memory writes by threads made visible to wgmma and TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier over `threads` threads of the CTA (id 1..15; 0 is
// __syncthreads')
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_wait_all() { wgmma_wait<0>(); }

// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HOPPER_D32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define HOPPER_OUT32(d)                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define HOPPER_OUT64(d)                                                     \
  HOPPER_OUT32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),      \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),      \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),      \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),      \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),      \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),      \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define HOPPER_D128                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "                               \
  "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "                      \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "                      \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "                      \
  "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "                      \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "                      \
  "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "                      \
  "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "                      \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "                      \
  "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "                      \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "            \
  "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "            \
  "%120, %121, %122, %123, %124, %125, %126, %127}"
#define HOPPER_OUT128(d)                                                    \
  HOPPER_OUT64(d), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),      \
      "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),                   \
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),                   \
      "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),                   \
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),                   \
      "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),                   \
      "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),                   \
      "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),                   \
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),                   \
      "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),               \
      "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),               \
      "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),               \
      "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),               \
      "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),               \
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),               \
      "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

// d (64 x 64, fp32) (+)= A (64 x 16, smem) * B (16 x 64, smem), bf16 in;
// TA / TB = 1: that operand is MN-major (rows along K), else K-major;
// scale_d = 0 overwrites d.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : HOPPER_OUT32(d)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

#define HOPPER_D64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "                               \
  "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "                      \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "                      \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "                      \
  "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "                      \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "                      \
  "%60, %61, %62, %63}"

// d (64 x 128, fp32) += A (64 x 16, K-major smem) * B (16 x 128, K-major
// smem: 128 rows of N)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_OUT64(d)
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 256, fp32) += A (64 x 16, K-major smem) * B (16 x 256, K-major
// smem: 256 rows of N)
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " HOPPER_D128
      ", %128, %129, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_OUT128(d)
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 registers) * B (16 x 64,
// MN-major smem).  A's fragment: a[0] row r, columns 2c and 2c + 1;
// a[1] row r + 8, the same columns; a[2], a[3] the same rows at columns
// 2c + 8 and 2c + 9; r = 16 * warp + lane / 4, c = lane % 4.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HOPPER_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, fp32) (+)= A (64 x 8) * B (8 x 64), tf32 in, both from
// shared memory and both K-major: wgmma has no transpose bit for tf32.  A
// k8 step of a 128-byte-swizzled fp32 row is +32 B, as bf16's k16.  The
// operands are fp32 words already on tf32's grid (low 13 bits zero): the
// tensor cores ignore those bits, so a raw fp32 value would be truncated.
// scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " HOPPER_D32
      ", %32, %33, p, 1, 1;\n}\n"
      : HOPPER_OUT32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128, fp32) (+)= A (64 x 8) * B (8 x 128), tf32 in, as above
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " HOPPER_D64
      ", %64, %65, p, 1, 1;\n}\n"
      : HOPPER_OUT64(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (so the
// library links no libcuda); null where the driver lacks it
static inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major (rows, cols) bf16 (or, with fp32 set, fp32) matrix as a 2-D
// tensor map (cols, rows), 128-byte swizzle, boxes of box_cols x box_rows;
// loads past the edges are zero-filled.  0, or kEncodeError + the
// driver's code.
static inline int map_2d(CUtensorMap* map, const void* ptr, long long rows,
                         long long cols, int box_rows, int box_cols,
                         bool fp32 = false) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return kEncodeError;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * (fp32 ? 4 : 2)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUtensorMapDataType type = fp32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUresult res = fn(map, type, 2,
                          const_cast<void*>(ptr), dims, strides, box, estr,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeError + (int)res;
}

}  // namespace hopper
