// Blocked photonic-tensor-core forward  y_p = sum_q U_pq (s_pq * (V*_pq x_q)).
//
// Replaces the TPU kernel repro/kernels/ptc_block_matmul.py::ptc_block_matmul
// (dispatched by repro/kernels/ops.py::ptc_block_matmul).  Shapes: x (T, Q*k),
// u and v (P, Q, k, k) with v holding V*, s (P, Q, k)  ->  y (T, P*k).
//
// What bounds it on an H100: arithmetic.  Per output row and block it does
// 2k^2 + k multiply-adds (4k^2 + k flops) and it reads each U/V element once
// per row tile, so at the serve shape (T = 1024, P = 57, Q = 456, k = 9:
// 8.9 GFLOP over ~37 MB) the fp32 CUDA-core rate, not device memory, is the
// bound.  k = 9 matches no tensor-core tile, so this first kernel stays on
// the CUDA cores in full fp32 (no TF32); a wgmma design is later work.
//
// Design:
//  * The TPU grid walks q sequentially and accumulates into the revisited
//    output tile.  GPU blocks run in no order, so here a block owns one
//    (row tile, p) output tile and loops over q inside itself, accumulating
//    in fp32 registers: no atomics, no second pass.
//  * One thread per output row keeps its k accumulators in registers
//    (template K >= k; padded entries are zero in shared memory, so the
//    inner loops carry no bounds checks).
//  * Per pass the block stages QC blocks' U_pq, V_pq, s_pq and the matching
//    x columns of its row tile in shared memory.  Loads are coalesced along
//    x's rows; the x tile has an odd row stride so that threads reading one
//    column of it hit distinct banks; every thread reads the same U/V
//    element at once (a broadcast).
//  * The ragged T tail is masked in the kernel (no divisor search as in
//    ops.py).  bf16 inputs are widened on load and accumulate in fp32.
//  * Launches on the caller's stream, allocates nothing, and returns
//    cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxRows = 128;

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

template <int K, typename Tv>
__global__ void __launch_bounds__(kMaxRows)
ptc_block_matmul_kernel(const Tv* __restrict__ x, const Tv* __restrict__ u,
                        const Tv* __restrict__ s, const Tv* __restrict__ v,
                        Tv* __restrict__ y, int T, int P, int Q, int k) {
  constexpr int QC = (48 / K) > 0 ? (48 / K) : 1;  // q blocks per pass
  constexpr int COLS = QC * K;
  constexpr int ROW = COLS | 1;                     // odd: conflict-free
  __shared__ float xs[kMaxRows * ROW];
  __shared__ float us[QC][K][K];
  __shared__ float vs[QC][K][K];
  __shared__ float ss[QC][K];

  const int rows = blockDim.x;
  const int p = blockIdx.x;
  const long long t0 = (long long)blockIdx.y * rows;
  const int r = threadIdx.x;
  const long long ldx = (long long)Q * k;

  float acc[K];
#pragma unroll
  for (int i = 0; i < K; ++i) acc[i] = 0.f;

  for (int q0 = 0; q0 < Q; q0 += QC) {
    const int nq = min(QC, Q - q0);
    __syncthreads();  // the previous pass is done with the tiles
    for (int i = threadIdx.x; i < rows * COLS; i += rows) {
      const int rr = i / COLS, c = i % COLS, qi = c / K, j = c % K;
      const long long t = t0 + rr;
      float val = 0.f;
      if (t < T && qi < nq && j < k) val = to_f32(x[t * ldx + (long long)(q0 + qi) * k + j]);
      xs[rr * ROW + c] = val;
    }
    for (int i = threadIdx.x; i < QC * K * K; i += rows) {
      const int qi = i / (K * K), e = i % (K * K), ii = e / K, j = e % K;
      float uv = 0.f, vv = 0.f;
      if (qi < nq && ii < k && j < k) {
        const long long off = (((long long)p * Q + q0 + qi) * k + ii) * k + j;
        uv = to_f32(u[off]);
        vv = to_f32(v[off]);
      }
      us[qi][ii][j] = uv;
      vs[qi][ii][j] = vv;
    }
    for (int i = threadIdx.x; i < QC * K; i += rows) {
      const int qi = i / K, j = i % K;
      ss[qi][j] = (qi < nq && j < k)
                      ? to_f32(s[((long long)p * Q + q0 + qi) * k + j])
                      : 0.f;
    }
    __syncthreads();

    for (int qi = 0; qi < nq; ++qi) {
      float xr[K];
#pragma unroll
      for (int j = 0; j < K; ++j) xr[j] = xs[r * ROW + qi * K + j];
      float vx[K];
#pragma unroll
      for (int i = 0; i < K; ++i) {
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < K; ++j) a = fmaf(vs[qi][i][j], xr[j], a);
        vx[i] = a * ss[qi][i];
      }
#pragma unroll
      for (int i = 0; i < K; ++i) {
        float a = acc[i];
#pragma unroll
        for (int j = 0; j < K; ++j) a = fmaf(us[qi][i][j], vx[j], a);
        acc[i] = a;
      }
    }
  }

  const long long t = t0 + r;
  if (t < T) {
    Tv* yr = y + t * ((long long)P * k) + (long long)p * k;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if (i < k) yr[i] = from_f32<Tv>(acc[i]);
    }
  }
}

template <int K, typename Tv>
cudaError_t launch(const void* x, const void* u, const void* s, const void* v,
                   void* y, int T, int P, int Q, int k, cudaStream_t stream) {
  const int rows = T >= kMaxRows ? kMaxRows : ((T + 31) / 32) * 32;
  const dim3 grid(P, (T + rows - 1) / rows);
  ptc_block_matmul_kernel<K, Tv><<<grid, rows, 0, stream>>>(
      static_cast<const Tv*>(x), static_cast<const Tv*>(u),
      static_cast<const Tv*>(s), static_cast<const Tv*>(v),
      static_cast<Tv*>(y), T, P, Q, k);
  return cudaGetLastError();
}

template <typename Tv>
cudaError_t dispatch(const void* x, const void* u, const void* s,
                     const void* v, void* y, int T, int P, int Q, int k,
                     cudaStream_t stream) {
  if (k <= 4) return launch<4, Tv>(x, u, s, v, y, T, P, Q, k, stream);
  if (k <= 8) return launch<8, Tv>(x, u, s, v, y, T, P, Q, k, stream);
  if (k == 9) return launch<9, Tv>(x, u, s, v, y, T, P, Q, k, stream);
  if (k <= 16) return launch<16, Tv>(x, u, s, v, y, T, P, Q, k, stream);
  if (k <= 32) return launch<32, Tv>(x, u, s, v, y, T, P, Q, k, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// dtype: 0 = float32, 1 = bfloat16 (all of x, u, s, v and y).
extern "C" int ptc_block_matmul(const void* x, const void* u, const void* s,
                                const void* v, void* y, int T, int P, int Q,
                                int k, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(dispatch<float>(x, u, s, v, y, T, P, Q, k, st));
  if (dtype == 1)
    return static_cast<int>(dispatch<__nv_bfloat16>(x, u, s, v, y, T, P, Q, k, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
