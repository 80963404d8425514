// Block-masked error feedback  dx_q = sum_p mask[q,p] V*_pq^T (s_pq * (U_pq^T dy_p))
// (paper Eq. 5, the input-gradient half, with feedback sampling: masked
// blocks are skipped whole).
//
// Replaces the TPU kernel repro/kernels/feedback_matmul.py::feedback_matmul
// (dispatched by repro/kernels/ops.py::feedback_matmul).  Shapes: dy
// (T, P*k), u and v (P, Q, k, k) with v holding V*, s (P, Q, k), mask (Q, P)
// already scaled by its normalizer  ->  dx (T, Q*k); fp32 throughout.
//
// What bounds it on an H100: arithmetic.  Per row and kept block it does
// two k x k products and a k-wide scale ((4k^2 + k) flops); at the widest
// shape of the training path (FC 4096 -> 512 of VGG-8, T = 1024, P = 57,
// Q = 456, k = 9) with 60% of the blocks kept that is ~5.4 GFLOP over ~28
// MB: the fp32 CUDA-core rate is the bound.  k = 9 fits no tensor-core tile,
// so this first kernel stays on the CUDA cores in full fp32.
//
// Design:
//  * It is the transposed traffic of the PTC forward kernel, and reuses its
//    scheme: a CTA owns one (128-row tile, q) output tile and loops over p
//    itself, accumulating in fp32 registers (one thread per row, k
//    accumulators): no atomics, no second pass.
//  * Masked blocks are skipped at block level.  A first small kernel
//    compacts, on the card, each mask row into the ascending list of p with
//    mask[q, p] != 0 (one warp per q, ballot + popc); the main kernel walks
//    only those.  The mask never travels to the host, so there is no
//    synchronisation per step.  btopk keeps exactly round(alpha P) blocks
//    per row, so every CTA does the same work.  A row with no kept block
//    writes exact zeros.
//  * Per pass the CTA stages PC kept blocks' U, V*, s * mask and the
//    matching dy columns of its row tile in shared memory (coalesced loads,
//    odd row stride; every thread reads the same U/V element at once).
//  * The ragged T tail is masked in the kernel.  Launches on the caller's
//    stream, allocates nothing (the wrapper passes the list scratch), and
//    returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kMaxRows = 128;

// plist[q, :counts[q]] = the p with mask[q, p] != 0, ascending.
__global__ void kept_blocks_kernel(const float* __restrict__ mask,
                                   int* __restrict__ plist,
                                   int* __restrict__ counts, int Q, int P) {
  const int q = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (q >= Q) return;  // whole warps leave together
  const float* row = mask + (long long)q * P;
  int* out = plist + (long long)q * P;
  int n = 0;
  for (int base = 0; base < P; base += 32) {
    const int p = base + lane;
    const bool kept = p < P && row[p] != 0.f;
    const unsigned bits = __ballot_sync(0xffffffffu, kept);
    if (kept) out[n + __popc(bits & ((1u << lane) - 1u))] = p;
    n += __popc(bits);
  }
  if (lane == 0) counts[q] = n;
}

template <int K>
__global__ void __launch_bounds__(kMaxRows)
feedback_matmul_kernel(const float* __restrict__ dy,
                       const float* __restrict__ u,
                       const float* __restrict__ s,
                       const float* __restrict__ v,
                       const float* __restrict__ mask,
                       const int* __restrict__ plist,
                       const int* __restrict__ counts,
                       float* __restrict__ dx, int T, int P, int Q, int k) {
  constexpr int PC = (48 / K) > 0 ? (48 / K) : 1;  // kept blocks per pass
  constexpr int COLS = PC * K;
  constexpr int ROW = COLS | 1;                     // odd: conflict-free
  __shared__ float dys[kMaxRows * ROW];
  __shared__ float us[PC][K][K];
  __shared__ float vs[PC][K][K];
  __shared__ float ss[PC][K];
  __shared__ int ps[PC];

  const int rows = blockDim.x;
  const int q = blockIdx.x;
  const long long t0 = (long long)blockIdx.y * rows;
  const int r = threadIdx.x;
  const long long ldy = (long long)P * k;
  const int n = counts[q];
  const int* kept = plist + (long long)q * P;

  float acc[K];
#pragma unroll
  for (int j = 0; j < K; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < n; c0 += PC) {
    const int np = min(PC, n - c0);
    __syncthreads();  // the previous pass is done with the tiles
    if (r < PC) ps[r] = r < np ? kept[c0 + r] : 0;
    __syncthreads();
    for (int i = r; i < rows * COLS; i += rows) {
      const int rr = i / COLS, c = i % COLS, pi = c / K, j = c % K;
      const long long t = t0 + rr;
      dys[rr * ROW + c] = (t < T && pi < np && j < k)
                              ? dy[t * ldy + (long long)ps[pi] * k + j]
                              : 0.f;
    }
    for (int i = r; i < PC * K * K; i += rows) {
      const int pi = i / (K * K), e = i % (K * K), ii = e / K, j = e % K;
      float uv = 0.f, vv = 0.f;
      if (pi < np && ii < k && j < k) {
        const long long off = (((long long)ps[pi] * Q + q) * k + ii) * k + j;
        uv = u[off];
        vv = v[off];
      }
      us[pi][ii][j] = uv;
      vs[pi][ii][j] = vv;
    }
    for (int i = r; i < PC * K; i += rows) {
      const int pi = i / K, j = i % K;
      ss[pi][j] = (pi < np && j < k)
                      ? s[((long long)ps[pi] * Q + q) * k + j] *
                            mask[(long long)q * P + ps[pi]]
                      : 0.f;
    }
    __syncthreads();

    for (int pi = 0; pi < np; ++pi) {
      float dyr[K];
#pragma unroll
      for (int j = 0; j < K; ++j) dyr[j] = dys[r * ROW + pi * K + j];
      float g[K];
#pragma unroll
      for (int i = 0; i < K; ++i) {
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < K; ++j) a = fmaf(us[pi][j][i], dyr[j], a);
        g[i] = a * ss[pi][i];
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {
        float a = acc[j];
#pragma unroll
        for (int i = 0; i < K; ++i) a = fmaf(vs[pi][i][j], g[i], a);
        acc[j] = a;
      }
    }
  }

  const long long t = t0 + r;
  if (t < T) {
    float* out = dx + t * ((long long)Q * k) + (long long)q * k;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (j < k) out[j] = acc[j];
    }
  }
}

template <int K>
cudaError_t launch(const float* dy, const float* u, const float* s,
                   const float* v, const float* mask, int* plist, int* counts,
                   float* dx, int T, int P, int Q, int k,
                   cudaStream_t stream) {
  kept_blocks_kernel<<<(Q + 3) / 4, 128, 0, stream>>>(mask, plist, counts, Q,
                                                       P);
  const int rows = T >= kMaxRows ? kMaxRows : ((T + 31) / 32) * 32;
  const dim3 grid(Q, (T + rows - 1) / rows);
  feedback_matmul_kernel<K><<<grid, rows, 0, stream>>>(
      dy, u, s, v, mask, plist, counts, dx, T, P, Q, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// fp32 only.  plist: (Q, P) int32 and counts: (Q,) int32 scratch.
extern "C" int feedback_matmul(const void* dy, const void* u, const void* s,
                               const void* v, const void* mask, void* plist,
                               void* counts, void* dx, int T, int P, int Q,
                               int k, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(dy);
  const float* b = static_cast<const float*>(u);
  const float* c = static_cast<const float*>(s);
  const float* d = static_cast<const float*>(v);
  const float* m = static_cast<const float*>(mask);
  int* pl = static_cast<int*>(plist);
  int* cn = static_cast<int*>(counts);
  float* o = static_cast<float*>(dx);
  if (k <= 4) return static_cast<int>(launch<4>(a, b, c, d, m, pl, cn, o, T, P, Q, k, st));
  if (k <= 8) return static_cast<int>(launch<8>(a, b, c, d, m, pl, cn, o, T, P, Q, k, st));
  if (k == 9) return static_cast<int>(launch<9>(a, b, c, d, m, pl, cn, o, T, P, Q, k, st));
  if (k <= 16) return static_cast<int>(launch<16>(a, b, c, d, m, pl, cn, o, T, P, Q, k, st));
  if (k <= 32) return static_cast<int>(launch<32>(a, b, c, d, m, pl, cn, o, T, P, Q, k, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
