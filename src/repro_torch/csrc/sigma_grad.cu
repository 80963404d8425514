// In-situ singular-value gradient  ds_pq = sum_t (U_pq^T dy_p) * (V*_pq x_q)
// (paper Eq. 5: the two reciprocal PTC passes and the electronic
// Hadamard-accumulate, fused; the (T, P, Q, k) intermediates never exist).
//
// Replaces the TPU kernel repro/kernels/sigma_grad.py::sigma_grad
// (dispatched by repro/kernels/ops.py::sigma_grad).  Shapes: dy (T, P*k),
// x (T, Q*k), u and v (P, Q, k, k) with v holding V*  ->  ds (P, Q, k), fp32
// throughout.
//
// What bounds it on an H100: arithmetic.  Per row and block it does two k x k
// products and a k-wide multiply-add ((4k^2 + 2k) flops), so at the widest
// shape of the training path (FC 4096 -> 512 of VGG-8 at T = 1024 rows:
// P = 57, Q = 456, k = 9) that is ~9.1 GFLOP over ~37 MB of inputs: the fp32
// CUDA-core rate, not device memory, is the bound.  k = 9 fits no
// tensor-core tile, so this first kernel stays on the CUDA cores in full
// fp32; a wgmma design, and sharing U^T dy with the feedback pass, is later
// work.
//
// Design:
//  * The TPU grid (P, Q, T-tiles) keeps one block's (k,) accumulator
//    resident across a sequential token stream.  GPU blocks run in no
//    order, and on the training path T is the long axis (32,768 rows for a
//    VGG-8 conv at batch 32 against 24 blocks in its first layer), so T is
//    split: a CTA owns (p, a group of QC consecutive q, a chunk of rows).
//  * Each thread takes one row of a 128-row tile at a time; its QC x K
//    accumulators stay in registers across the whole chunk.  U_pq and V*_pq
//    of the group sit in shared memory for the CTA's life (every thread
//    reads the same element at once: a broadcast); the row tiles of dy_p and
//    of the group's x columns are staged in shared memory with coalesced
//    loads and an odd row stride (no bank conflicts).  Padded entries
//    (j >= k, rows >= T) are zero, so the unrolled loops need no checks.
//  * The chunk's partial sums are reduced across the CTA in a fixed order
//    (warp butterfly, then warps in order) and written to partials
//    (n_chunks, P, Q, k); a second kernel sums the chunks in order.  No
//    atomics: two runs give the same bits.  With one chunk the first kernel
//    writes ds directly.
//  * Launches on the caller's stream, allocates nothing (the wrapper passes
//    the partials buffer), and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;           // threads per CTA = rows per tile
constexpr int kWarps = kRows / 32;
constexpr int kTargetCtas = 1024;    // ~8 per SM on 132 SMs
constexpr int kMinChunkRows = 512;   // amortize the U/V load and reduction

__host__ __device__ constexpr int group_of(int K) {
  return (48 / K) > 0 ? (48 / K) : 1;  // q blocks per CTA
}

template <int K>
__global__ void __launch_bounds__(kRows)
sigma_grad_kernel(const float* __restrict__ dy, const float* __restrict__ x,
                  const float* __restrict__ u, const float* __restrict__ v,
                  float* __restrict__ out, int T, int P, int Q, int k,
                  int chunk_rows) {
  constexpr int QC = group_of(K);
  constexpr int XCOLS = QC * K;
  constexpr int XROW = XCOLS | 1;    // odd: conflict-free column reads
  constexpr int DROW = K | 1;
  __shared__ float xs[kRows * XROW];
  __shared__ float dys[kRows * DROW];
  __shared__ float us[QC][K][K];
  __shared__ float vs[QC][K][K];
  __shared__ float red[kWarps][XCOLS];

  const int n_groups = (Q + QC - 1) / QC;
  const int p = blockIdx.x / n_groups;
  const int q0 = (blockIdx.x % n_groups) * QC;
  const int nq = min(QC, Q - q0);
  const long long t_begin = (long long)blockIdx.y * chunk_rows;
  const long long t_end = min((long long)T, t_begin + chunk_rows);
  const int tid = threadIdx.x;
  const long long ldy = (long long)P * k;
  const long long ldx = (long long)Q * k;

  for (int i = tid; i < QC * K * K; i += kRows) {
    const int qi = i / (K * K), e = i % (K * K), ii = e / K, j = e % K;
    float uv = 0.f, vv = 0.f;
    if (qi < nq && ii < k && j < k) {
      const long long off = (((long long)p * Q + q0 + qi) * k + ii) * k + j;
      uv = u[off];
      vv = v[off];
    }
    us[qi][ii][j] = uv;
    vs[qi][ii][j] = vv;
  }

  float acc[QC][K];
#pragma unroll
  for (int qi = 0; qi < QC; ++qi) {
#pragma unroll
    for (int i = 0; i < K; ++i) acc[qi][i] = 0.f;
  }

  for (long long t0 = t_begin; t0 < t_end; t0 += kRows) {
    __syncthreads();  // the previous tile is consumed (and U/V are staged)
    for (int i = tid; i < kRows * K; i += kRows) {
      const int rr = i / K, j = i % K;
      const long long t = t0 + rr;
      dys[rr * DROW + j] =
          (t < t_end && j < k) ? dy[t * ldy + (long long)p * k + j] : 0.f;
    }
    for (int i = tid; i < kRows * XCOLS; i += kRows) {
      const int rr = i / XCOLS, c = i % XCOLS, qi = c / K, j = c % K;
      const long long t = t0 + rr;
      xs[rr * XROW + c] = (t < t_end && qi < nq && j < k)
                              ? x[t * ldx + (long long)(q0 + qi) * k + j]
                              : 0.f;
    }
    __syncthreads();

    float dyr[K];
#pragma unroll
    for (int j = 0; j < K; ++j) dyr[j] = dys[tid * DROW + j];
#pragma unroll
    for (int qi = 0; qi < QC; ++qi) {
      if (qi < nq) {
        float xr[K];
#pragma unroll
        for (int j = 0; j < K; ++j) xr[j] = xs[tid * XROW + qi * K + j];
        float xv[K];
#pragma unroll
        for (int i = 0; i < K; ++i) {
          float a = 0.f;
#pragma unroll
          for (int j = 0; j < K; ++j) a = fmaf(vs[qi][i][j], xr[j], a);
          xv[i] = a;
        }
#pragma unroll
        for (int i = 0; i < K; ++i) {
          float g = 0.f;
#pragma unroll
          for (int j = 0; j < K; ++j) g = fmaf(us[qi][j][i], dyr[j], g);
          acc[qi][i] = fmaf(g, xv[i], acc[qi][i]);
        }
      }
    }
  }

  // fixed-order reduction over the CTA's 128 rows
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int qi = 0; qi < QC; ++qi) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      float a = acc[qi][i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        a += __shfl_xor_sync(0xffffffffu, a, off);
      if (lane == 0) red[warp][qi * K + i] = a;
    }
  }
  __syncthreads();
  for (int c = tid; c < XCOLS; c += kRows) {
    const int qi = c / K, i = c % K;
    if (qi < nq && i < k) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) a += red[w][c];
      out[(((long long)blockIdx.y * P + p) * Q + q0 + qi) * k + i] = a;
    }
  }
}

// ds[n] = sum over chunks c, in order, of part[c][n]
__global__ void sum_chunks_kernel(const float* __restrict__ part,
                                  float* __restrict__ ds, long long n,
                                  int n_chunks) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float a = 0.f;
  for (int c = 0; c < n_chunks; ++c) a += part[(long long)c * n + i];
  ds[i] = a;
}

template <int K>
int chunks_for(int T, int P, int Q) {
  const long long ctas = (long long)P * ((Q + group_of(K) - 1) / group_of(K));
  long long want = (kTargetCtas + ctas - 1) / ctas;
  const long long most = (T + kMinChunkRows - 1) / kMinChunkRows;
  if (want > most) want = most;
  if (want > 65535) want = 65535;
  return want < 1 ? 1 : static_cast<int>(want);
}

template <int K>
cudaError_t launch(const float* dy, const float* x, const float* u,
                   const float* v, float* part, float* ds, int T, int P,
                   int Q, int k, int n_chunks, cudaStream_t stream) {
  const long long per = ((long long)T + n_chunks - 1) / n_chunks;
  const int chunk_rows = static_cast<int>((per + kRows - 1) / kRows * kRows);
  const int used = static_cast<int>((T + chunk_rows - 1) / chunk_rows);
  const int n_groups = (Q + group_of(K) - 1) / group_of(K);
  const dim3 grid(P * n_groups, used);
  sigma_grad_kernel<K><<<grid, kRows, 0, stream>>>(
      dy, x, u, v, used > 1 ? part : ds, T, P, Q, k, chunk_rows);
  if (used > 1) {
    const long long n = (long long)P * Q * k;
    sum_chunks_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                        stream>>>(part, ds, n, used);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// How many row chunks sigma_grad splits T into; the wrapper sizes the
// partials buffer (n_chunks, P, Q, k) from it.  0 for an unsupported k.
extern "C" int sigma_grad_chunks(int T, int P, int Q, int k) {
  if (k <= 4) return chunks_for<4>(T, P, Q);
  if (k <= 8) return chunks_for<8>(T, P, Q);
  if (k == 9) return chunks_for<9>(T, P, Q);
  if (k <= 16) return chunks_for<16>(T, P, Q);
  if (k <= 32) return chunks_for<32>(T, P, Q);
  return 0;
}

// fp32 only.  part: (n_chunks, P, Q, k) scratch, unused when n_chunks == 1.
extern "C" int sigma_grad(const void* dy, const void* x, const void* u,
                          const void* v, void* part, void* ds, int T, int P,
                          int Q, int k, int n_chunks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(dy);
  const float* b = static_cast<const float*>(x);
  const float* c = static_cast<const float*>(u);
  const float* d = static_cast<const float*>(v);
  float* pt = static_cast<float*>(part);
  float* o = static_cast<float*>(ds);
  cudaError_t err = cudaErrorInvalidValue;
  if (n_chunks < 1) return static_cast<int>(err);
  if (k <= 4) err = launch<4>(a, b, c, d, pt, o, T, P, Q, k, n_chunks, st);
  else if (k <= 8) err = launch<8>(a, b, c, d, pt, o, T, P, Q, k, n_chunks, st);
  else if (k == 9) err = launch<9>(a, b, c, d, pt, o, T, P, Q, k, n_chunks, st);
  else if (k <= 16) err = launch<16>(a, b, c, d, pt, o, T, P, Q, k, n_chunks, st);
  else if (k <= 32) err = launch<32>(a, b, c, d, pt, o, T, P, Q, k, n_chunks, st);
  return static_cast<int>(err);
}
