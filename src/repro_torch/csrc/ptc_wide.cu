// The blocked PTC kernels at any block size k > 32 (the "wide" route):
// forward, Sigma-gradient and error feedback of a PTC linear at LM widths
// (k = 128 in every LM config).
//
// Replaces, for k > 32, the TPU kernels
//   repro/kernels/ptc_block_matmul.py::ptc_block_matmul  y_p  = sum_q U_pq (s_pq * V*_pq x_q)
//   repro/kernels/sigma_grad.py::sigma_grad              ds_pq = sum_t (U_pq^T dy_p) * (V*_pq x_q)
//   repro/kernels/feedback_matmul.py::feedback_matmul    dx_q = sum_p mask[q,p] V*_pq^T (s_pq * U_pq^T dy_p)
// (dispatched by repro/kernels/ops.py).  Shapes: x (T, Q*k), dy (T, P*k),
// u and v (P, Q, k, k) with v holding V*, s (P, Q, k), mask (Q, P) fp32,
// the Sigma-gradient's column scale col (T,) fp32; x, dy, u, s, v all fp32
// or all bf16, widened to fp32 on load; every product and sum is fp32.
//
// What bounds it on an H100: operations.  At olmo-1b's up projection
// (2048 -> 8192, k = 128, T = 4096) the forward is 68.7 G multiply-adds on
// 33 MB of operands: 2.1 ms at the fp32 CUDA-core rate (67 TFLOP/s)
// against 0.01-0.03 ms of bytes.  The k <= 32 kernels cannot be
// instantiated at 128: their threads own whole blocks (8 rows x one block
// of outputs; a k x k tile of G; one block composed in one thread).
//
// Design: every product here is one register-tiled fp32 tile product.  A
// CTA of 256 threads owns a 128 x 128 output tile (one block at k = 128);
// a thread owns 8 x 8 outputs (rows ty*4 + {0..3} and 64 + ty*4 + {0..3},
// columns likewise by tx, so that the float4 operand loads of a warp hit
// distinct banks).  Operand tiles of 16 reduction steps are held k-major
// in shared memory (A as [kk][m], B as [kk][n]): per step a thread loads
// two float4 of A and two of B and does 64 FMAs.  Global -> shared goes
// through registers, widening bf16 and transposing A where its rows run
// along the reduction: the next step's loads are in flight while the
// current one is multiplied (two shared buffers, one barrier a step).
// The summation order is fixed: two runs give the same bits.  Kernels:
//
//  * ptc_wide_compose_kernel (batched block product, grid P*Q blocks x
//    output tiles): W_pq = (U_pq diag(s_pq)) V*_pq, scaled by mask[q,p]
//    for the feedback, written into a composed fp32 scratch W (P*k, Q*k)
//    the wrapper allocates; a masked block is written as zeros without
//    being composed.
//  * ptc_wide_gemm_kernel: forward y = x W^T (A = x and B = W, both with
//    rows along the reduction, transposed on load), feedback dx = dy W
//    (A = dy, transposed on load, which skips every reduction step whose
//    blocks are all masked for the tile's q range: btopk at alpha_W = 0.6
//    keeps round(0.6 P) blocks of each q row, 60%, and skips the other
//    40%), sigma G = (col * dy)^T x over all T rows
//    (A = dy, scaled by col on load, and B = x, both k-major as stored),
//    written to an fp32 scratch (P*k, Q*k).
//  * ptc_wide_project_kernel (batched block product, grid P*Q blocks x
//    row tiles): ds_pq[i] = sum_b (U_pq^T G_pq)[i, b] V*_pq[i, b], walking
//    the block's column tiles in order and reducing each row over the 16
//    threads that share it by shuffles.
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include "ptc_common.cuh"

namespace {

using ptc::from_f32;
using ptc::to_f32;

constexpr int kBM = 128, kBN = 128, kBK = 16;  // CTA tile, reduction step
constexpr int kThreads = 256;                  // 16 x 16 threads, 8 x 8 each
constexpr int kStride = kBM + 4;               // shared row: 16-byte aligned
constexpr int kPer = kBK * kBM / kThreads;     // staged elements a thread

// element (m, kk) of a tile operand, m along the output, kk along the
// reduction: at p[m * ld + kk] where MMAJOR (x and dy in the forward and
// feedback: a row per m, running along the reduction), else at
// p[kk * ld + m] (a row per reduction step)
struct Operand {
  const void* p;
  long long ld;   // row stride (elements)
  long long m0;   // first m of the tile
  long long nm;   // m's extent (zero past it)
  const float* kscale = nullptr;  // a factor per reduction index, or none
};

template <typename Tv, bool MMAJOR>
__device__ __forceinline__ void stage_load(const Operand& op, long long k0,
                                           long long kend, float (&r)[kPer]) {
  const Tv* base = static_cast<const Tv*>(op.p);
  const int tid = threadIdx.x;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int idx = tid + e * kThreads;
    // consecutive threads read consecutive addresses of a row
    const int m = MMAJOR ? idx / kBK : idx % kBM;
    const int kk = MMAJOR ? idx % kBK : idx / kBM;
    const long long gm = op.m0 + m, gk = k0 + kk;
    float val = 0.f;
    if (gm < op.nm && gk < kend) {
      val = to_f32(MMAJOR ? base[gm * op.ld + gk] : base[gk * op.ld + gm]);
      if (op.kscale != nullptr) val *= op.kscale[gk];
    }
    r[e] = val;
  }
}

template <bool MMAJOR>
__device__ __forceinline__ void stage_store(float* s, const float (&r)[kPer]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int idx = tid + e * kThreads;
    const int m = MMAJOR ? idx / kBK : idx % kBM;
    const int kk = MMAJOR ? idx % kBK : idx / kBM;
    s[kk * kStride + m] = r[e];
  }
}

__device__ __forceinline__ void mma_step(const float* as, const float* bs,
                                         float (&acc)[8][8]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(as + kk * kStride + ty * 4);
    const float4 a1 = *reinterpret_cast<const float4*>(as + kk * kStride + 64 + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * kStride + tx * 4);
    const float4 b1 = *reinterpret_cast<const float4*>(bs + kk * kStride + 64 + tx * 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// the thread's i-th row / column within the tile
__device__ __forceinline__ int row_of(int i) {
  return (i < 4 ? 0 : 64) + (threadIdx.x / 16) * 4 + (i & 3);
}
__device__ __forceinline__ int col_of(int j) {
  return (j < 4 ? 0 : 64) + (threadIdx.x % 16) * 4 + (j & 3);
}

// acc = sum over the reduction steps `steps` lists of A(m, kk) B(kk, n).
// Steps walks the step indices in order: steps.first(), steps.next(s)
// (-1 past the last) and steps.range(s, &k0, &kend).
template <typename TA, bool AM, typename TB, bool BM_, typename StepsT>
__device__ __forceinline__ void tile_product(const Operand& a,
                                             const Operand& b,
                                             const StepsT& steps,
                                             float* smem,
                                             float (&acc)[8][8]) {
  // buffer c: A at smem + c * 2 * kBK * kStride, B right after it
  auto as = [&](int c) { return smem + c * 2 * kBK * kStride; };
  auto bs = [&](int c) { return smem + (2 * c + 1) * kBK * kStride; };
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  int s = steps.first();
  if (s < 0) return;
  float ra[kPer], rb[kPer];
  long long k0, kend;
  steps.range(s, k0, kend);
  stage_load<TA, AM>(a, k0, kend, ra);
  stage_load<TB, BM_>(b, k0, kend, rb);
  stage_store<AM>(as(0), ra);
  stage_store<BM_>(bs(0), rb);
  __syncthreads();
  int cur = 0;
  while (s >= 0) {
    const int nx = steps.next(s);
    if (nx >= 0) {  // the next step's loads in flight during this one
      steps.range(nx, k0, kend);
      stage_load<TA, AM>(a, k0, kend, ra);
      stage_load<TB, BM_>(b, k0, kend, rb);
    }
    mma_step(as(cur), bs(cur), acc);
    if (nx >= 0) {
      stage_store<AM>(as(cur ^ 1), ra);
      stage_store<BM_>(bs(cur ^ 1), rb);
    }
    __syncthreads();
    cur ^= 1;
    s = nx;
  }
}

constexpr size_t kSmemFloats = 4 * kBK * kStride;   // 33.8 KB

// the reduction [0, K) in steps of kBK, cut at segment edges (a segment
// is one block's k rows where the feedback skips masked blocks; else the
// whole range); with a mask, a segment none of whose (q, p) pairs in the
// tile's q range is kept is skipped
struct Steps {
  long long K;
  int seg, per_seg, n_seg;
  const float* mask;  // (Q, P), or null: every step is live
  int P, q_lo, q_hi;

  __device__ bool live(int g) const {
    if (mask == nullptr) return true;
    for (int q = q_lo; q <= q_hi; ++q)
      if (__ldg(mask + (long long)q * P + g) != 0.f) return true;
    return false;
  }
  __device__ int from_seg(int g) const {
    while (g < n_seg && !live(g)) ++g;
    return g < n_seg ? g * per_seg : -1;
  }
  __device__ int first() const { return from_seg(0); }
  __device__ int next(int s) const {
    if ((s + 1) % per_seg != 0) return s + 1;
    return from_seg((s + 1) / per_seg);
  }
  __device__ void range(int s, long long& k0, long long& kend) const {
    const long long g = s / per_seg;
    k0 = g * seg + (long long)(s % per_seg) * kBK;
    kend = min(K, (g + 1) * seg);
  }
};

__device__ Steps dense_steps(long long K) {
  Steps st;
  st.K = K;
  st.seg = (int)min(K, (long long)1 << 30);
  st.per_seg = (st.seg + kBK - 1) / kBK;
  st.n_seg = K > 0 ? (int)((K + st.seg - 1) / st.seg) : 0;
  st.mask = nullptr;
  st.P = st.q_lo = st.q_hi = 0;
  return st;
}

// --- batched block products -------------------------------------------

// U_pq diag(s_pq): element (i, a) = U[i, a] s[a], i along the tile's
// rows or columns (its rows run along i: staged as an m-major operand)
template <typename Tv>
__device__ __forceinline__ void stage_load_us(const Tv* u, const Tv* s,
                                              int k, int i0, long long k0,
                                              float (&r)[kPer]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int idx = tid + e * kThreads;
    const int i = idx / kBK, kk = idx % kBK;
    const long long gi = i0 + i, gk = k0 + kk;
    r[e] = (gi < k && gk < k) ? to_f32(u[gi * k + gk]) * to_f32(s[gk]) : 0.f;
  }
}

// W (P*k, Q*k): W_pq scaled by mask[q, p] (by 1 without a mask), as the
// tile product W_pq[i, j] = sum_a (U[i, a] s[a]) V*[a, j]; a thread's
// columns are consecutive in the scratch's rows.
template <typename Tv>
__global__ void __launch_bounds__(kThreads, 2)
ptc_wide_compose_kernel(const Tv* __restrict__ u, const Tv* __restrict__ s,
                        const Tv* __restrict__ v,
                        const float* __restrict__ mask,
                        float* __restrict__ w, int P, int Q, int k) {
  __shared__ __align__(16) float smem[kSmemFloats];
  const long long blk = blockIdx.x;  // p * Q + q
  const int p = (int)(blk / Q), q = (int)(blk % Q);
  const int nt = (k + kBN - 1) / kBN;
  const int m0 = (blockIdx.y / nt) * kBM, n0 = (blockIdx.y % nt) * kBN;
  const long long kk2 = (long long)k * k;
  const float scale = mask == nullptr ? 1.f : mask[(long long)q * P + p];
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  if (scale != 0.f) {  // uniform across the CTA
    const Tv* ub = u + blk * kk2;
    const Tv* sb = s + blk * k;
    // V*: rows along the reduction a, columns j along the tile's columns
    const Operand vop{v + blk * kk2, k, n0, k};
    auto as = [&](int c) { return smem + c * 2 * kBK * kStride; };
    auto bs = [&](int c) { return smem + (2 * c + 1) * kBK * kStride; };
    float rv[kPer], ru[kPer];
    auto load = [&](long long k0) {
      stage_load<Tv, false>(vop, k0, k, rv);
      stage_load_us<Tv>(ub, sb, k, m0, k0, ru);
    };
    auto store = [&](int buf) {
      stage_store<true>(as(buf), ru);
      stage_store<false>(bs(buf), rv);
    };
    const int ns = (k + kBK - 1) / kBK;
    load(0);
    store(0);
    __syncthreads();
    for (int st = 0; st < ns; ++st) {
      const int cur = st & 1;
      if (st + 1 < ns) load((long long)(st + 1) * kBK);
      mma_step(as(cur), bs(cur), acc);
      if (st + 1 < ns) store(cur ^ 1);
      __syncthreads();
    }
  }
  const long long ldw = (long long)Q * k;
  const long long row0 = (long long)p * k, col0 = (long long)q * k;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + row_of(i);
    if (r >= k) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + col_of(j);
      if (c < k) w[(row0 + r) * ldw + col0 + c] = acc[i][j] * scale;
    }
  }
}

// ds_pq[i] = sum_b (sum_a U[a, i] G[p*k + a, q*k + b]) V*[i, b]
template <typename Tv>
__global__ void __launch_bounds__(kThreads, 2)
ptc_wide_project_kernel(const float* __restrict__ g,
                        const Tv* __restrict__ u, const Tv* __restrict__ v,
                        float* __restrict__ ds, int P, int Q, int k) {
  __shared__ __align__(16) float smem[kSmemFloats];
  const long long blk = blockIdx.x;
  const int p = (int)(blk / Q), q = (int)(blk % Q);
  const int m0 = blockIdx.y * kBM;
  const long long kk2 = (long long)k * k, ldg = (long long)Q * k;
  const Tv* vb = v + blk * kk2;
  // A(i, a) = U[a, i]: U's rows run along the reduction
  const Operand a{u + blk * kk2, k, m0, k};
  const Steps steps = dense_steps(k);
  float rows[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float acc[8][8];
  for (int n0 = 0; n0 < k; n0 += kBN) {
    const Operand b{g + (long long)p * k * ldg + (long long)q * k, ldg, n0, k};
    tile_product<Tv, false, float, false>(a, b, steps, smem, acc);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = m0 + row_of(i);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + col_of(j);
        if (r < k && c < k)
          rows[i] = fmaf(acc[i][j], to_f32(vb[(long long)r * k + c]), rows[i]);
      }
    }
  }
  // the 16 threads of a half-warp share their rows
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int o = 1; o < 16; o *= 2)
      rows[i] += __shfl_xor_sync(0xffffffffu, rows[i], o);
  if (threadIdx.x % 16 == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = m0 + row_of(i);
      if (r < k) ds[blk * k + r] = rows[i];
    }
  }
}

// --- the products over T ------------------------------------------------

enum Mode { kForward = 0, kFeedback = 1, kSigma = 2 };

// forward:  C (T, P*k) = x (T, Q*k) . W^T, W (P*k, Q*k)
// feedback: C (T, Q*k) = dy (T, P*k) . W (P*k, Q*k), vec the mask (Q, P)
// sigma:    C (P*k, Q*k) = (vec * dy)^T . x over T, vec the column scale
//           (T,) or null
template <typename Tv, int MODE>
__global__ void __launch_bounds__(kThreads, 2)
ptc_wide_gemm_kernel(const Tv* __restrict__ a, const void* __restrict__ b,
                     const float* __restrict__ vec, void* __restrict__ c,
                     int T, int P, int Q, int k) {
  __shared__ __align__(16) float smem[kSmemFloats];
  const long long m0 = (long long)blockIdx.y * kBM;
  const long long n0 = (long long)blockIdx.x * kBN;
  const long long pk = (long long)P * k, qk = (long long)Q * k;
  float acc[8][8];
  long long M, N;
  if constexpr (MODE == kForward) {
    M = T, N = pk;
    const Operand oa{a, qk, m0, T}, ob{b, qk, n0, pk};
    tile_product<Tv, true, float, true>(oa, ob, dense_steps(qk), smem, acc);
  } else if constexpr (MODE == kFeedback) {
    M = T, N = qk;
    Steps st;
    st.K = pk;
    st.seg = k;
    st.per_seg = (k + kBK - 1) / kBK;
    st.n_seg = P;
    st.mask = vec;
    st.P = P;
    st.q_lo = (int)(n0 / k);
    st.q_hi = (int)(min(n0 + kBN, qk) - 1) / k;
    const Operand oa{a, pk, m0, T}, ob{b, qk, n0, qk};
    tile_product<Tv, true, float, false>(oa, ob, st, smem, acc);
  } else {
    M = pk, N = qk;
    const Operand oa{a, pk, m0, pk, vec}, ob{b, qk, n0, qk};
    tile_product<Tv, false, Tv, false>(oa, ob, dense_steps(T), smem, acc);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = m0 + row_of(i);
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long cc = n0 + col_of(j);
      if (cc >= N) continue;
      if constexpr (MODE == kSigma)
        static_cast<float*>(c)[r * N + cc] = acc[i][j];
      else
        static_cast<Tv*>(c)[r * N + cc] = from_f32<Tv>(acc[i][j]);
    }
  }
}

dim3 gemm_grid(long long M, long long N) {
  return dim3((unsigned)((N + kBN - 1) / kBN), (unsigned)((M + kBM - 1) / kBM));
}

unsigned tiles(int k) { return (unsigned)((k + kBM - 1) / kBM); }

template <typename Tv>
cudaError_t compose(const void* u, const void* s, const void* v,
                    const float* mask, float* w, int P, int Q, int k,
                    cudaStream_t st) {
  ptc_wide_compose_kernel<Tv><<<dim3((unsigned)P * Q, tiles(k) * tiles(k)),
                                kThreads, 0, st>>>(
      static_cast<const Tv*>(u), static_cast<const Tv*>(s),
      static_cast<const Tv*>(v), mask, w, P, Q, k);
  return cudaGetLastError();
}

template <typename Tv>
cudaError_t forward(const void* x, const void* u, const void* s,
                    const void* v, float* w, void* y, int T, int P, int Q,
                    int k, cudaStream_t st) {
  cudaError_t err = compose<Tv>(u, s, v, nullptr, w, P, Q, k, st);
  if (err != cudaSuccess) return err;
  ptc_wide_gemm_kernel<Tv, kForward>
      <<<gemm_grid(T, (long long)P * k), kThreads, 0, st>>>(
          static_cast<const Tv*>(x), w, nullptr, y, T, P, Q, k);
  return cudaGetLastError();
}

template <typename Tv>
cudaError_t feedback(const void* dy, const void* u, const void* s,
                     const void* v, const float* mask, float* w, void* dx,
                     int T, int P, int Q, int k, cudaStream_t st) {
  cudaError_t err = compose<Tv>(u, s, v, mask, w, P, Q, k, st);
  if (err != cudaSuccess) return err;
  ptc_wide_gemm_kernel<Tv, kFeedback>
      <<<gemm_grid(T, (long long)Q * k), kThreads, 0, st>>>(
          static_cast<const Tv*>(dy), w, mask, dx, T, P, Q, k);
  return cudaGetLastError();
}

template <typename Tv>
cudaError_t sigma(const void* dy, const void* x, const void* u,
                  const void* v, const float* col, float* g, float* ds, int T,
                  int P, int Q, int k, cudaStream_t st) {
  ptc_wide_gemm_kernel<Tv, kSigma>
      <<<gemm_grid((long long)P * k, (long long)Q * k), kThreads, 0, st>>>(
          static_cast<const Tv*>(dy), x, col, g, T, P, Q, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ptc_wide_project_kernel<Tv><<<dim3((unsigned)P * Q, tiles(k)), kThreads,
                                0, st>>>(g, static_cast<const Tv*>(u),
                                         static_cast<const Tv*>(v), ds, P,
                                         Q, k);
  return cudaGetLastError();
}

bool bad(int T, int P, int Q, int k) {
  return T < 0 || P < 1 || Q < 1 || k < 1 ||
         (long long)P * Q > 0x7fffffffLL ||
         (long long)(T + kBM - 1) / kBM > 65535 ||
         ((long long)P * k + kBM - 1) / kBM > 65535;
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// The tile of every wide kernel: out[0] = rows, out[1] = columns of a
// CTA's output tile, out[2] = reduction steps a stage.
extern "C" int ptc_wide_tile(int* out) {
  out[0] = kBM;
  out[1] = kBN;
  out[2] = kBK;
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16 (x, u, s, v and y alike).  Scratch: w
// (P*k, Q*k) fp32.
extern "C" int ptc_wide_forward(const void* x, const void* u, const void* s,
                                const void* v, void* w, void* y, int T,
                                int P, int Q, int k, int dtype,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ww = static_cast<float*>(w);
  if (bad(T, P, Q, k)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(forward<float>(x, u, s, v, ww, y, T, P, Q, k, st));
  if (dtype == 1)
    return static_cast<int>(
        forward<__nv_bfloat16>(x, u, s, v, ww, y, T, P, Q, k, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// dy, u, s, v and dx alike (dtype as above); mask (Q, P) fp32.  Scratch:
// w (P*k, Q*k) fp32.
extern "C" int ptc_wide_feedback(const void* dy, const void* u, const void* s,
                                 const void* v, const void* mask, void* w,
                                 void* dx, int T, int P, int Q, int k,
                                 int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  float* ww = static_cast<float*>(w);
  if (bad(T, P, Q, k) || ((long long)Q * k + kBN - 1) / kBN > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(
        feedback<float>(dy, u, s, v, m, ww, dx, T, P, Q, k, st));
  if (dtype == 1)
    return static_cast<int>(
        feedback<__nv_bfloat16>(dy, u, s, v, m, ww, dx, T, P, Q, k, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// dy, x, u and v alike (dtype as above); col (T,) fp32, dy's row scale, or
// null; ds (P, Q, k) fp32.  Scratch: g (P*k, Q*k) fp32.
extern "C" int ptc_wide_sigma(const void* dy, const void* x, const void* u,
                              const void* v, const void* col, void* g,
                              void* ds, int T, int P, int Q, int k, int dtype,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(col);
  float* gg = static_cast<float*>(g);
  float* d = static_cast<float*>(ds);
  if (bad(T, P, Q, k)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(
        sigma<float>(dy, x, u, v, c, gg, d, T, P, Q, k, st));
  if (dtype == 1)
    return static_cast<int>(
        sigma<__nv_bfloat16>(dy, x, u, v, c, gg, d, T, P, Q, k, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
