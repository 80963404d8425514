// Helpers shared by the PTC kernels (ptc_block_matmul.cu, sigma_grad.cu,
// feedback_matmul.cu, ptc_wide.cu) and the CUDA-core prefill attention:
// type widening, cp.async copies into shared memory, and the fixed-order
// sum of split partials.  Included by each .cu file, which is compiled into
// its own library (kernels/build.py hashes this header into every library
// name, so an edited header is never served a stale build).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptc {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename Tv>
__device__ __forceinline__ Tv from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// the k a kernel is compiled for: the least of 4, 8, 9, 16, 32 that holds k
// (0 past 32); k = 9 is the paper's block size and gets its own
__host__ __device__ constexpr int kernel_k(int k) {
  return k <= 4 ? 4 : k <= 8 ? 8 : k == 9 ? 9 : k <= 16 ? 16 : k <= 32 ? 32 : 0;
}
__host__ __device__ constexpr int pad4(int n) { return (n + 3) / 4 * 4; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, or 16 zero bytes where !valid (src unread)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes global -> shared, or a zero where !valid (src unread)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                         bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// out[i] = sum over splits s = 0, 1, ..., in that order, of part[s * n + i]:
// the second pass of a split reduction (deterministic, no atomics).  Each
// library wraps it in a kernel of its own name, so a profile tells them apart.
template <typename Tv>
__device__ __forceinline__ void sum_splits(const float* __restrict__ part,
                                           Tv* __restrict__ out, long long n,
                                           int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float a = 0.f;
  for (int s = 0; s < splits; ++s) a += part[(long long)s * n + i];
  out[i] = from_f32<Tv>(a);
}

}  // namespace ptc
