// Blocked photonic-tensor-core forward  y_p = sum_q U_pq (s_pq * (V*_pq x_q)).
//
// Replaces the TPU kernel repro/kernels/ptc_block_matmul.py::ptc_block_matmul
// (dispatched by repro/kernels/ops.py::ptc_block_matmul).  Shapes: x (T, Q*k),
// u and v (P, Q, k, k) with v holding V*, s (P, Q, k)  ->  y (T, P*k); fp32 or
// bf16 (all alike), accumulated in fp32.
//
// The function's least work composes each W_pq = U_pq diag(s_pq) V*_pq once
// (k^3 multiply-adds a block), then does one dense product y = x W^T (k^2 a
// row and block).  The first design applied V*, Sigma and U to every row
// (2k^2 + k a row and block, twice the work) and fed each FMA one operand
// from shared memory, so it ran at the shared-memory issue rate.  Two routes,
// picked by kernels/ptc_block_matmul.py::route from the shapes alone, each
// with its own launch counter:
//
// Product route (serve, SL forward, VGG-8), three launches:
//  1. ptc_compose_kernel writes W^T into scratch the wrapper allocates, wt
//     (Q*k, P*KP) fp32: row q*k + j holds W_pq[i, j] at column p*KP + i, with
//     KP = KT rounded up to a multiple of 4, so that every row of every
//     block column is 16-byte aligned.  A CTA composes 16 p x 2 q blocks:
//     its loads are runs of 2 blocks, its writes runs of 16.  A pre-pass,
//     not a composition inside the product's tiles: the product's CTAs that
//     share a block column would compose it again each (T/BM times; 8 at
//     serve W1), and the pre-pass moves 16.8 MB of U, V* and 11 MB of W at
//     serve W1 (a few microseconds) while composing in the tiles would
//     repeat 151 M multiply-adds on the critical path of every CTA.
//  2. ptc_product_kernel: y = x W^T on the CUDA cores in full fp32 (FFMA;
//     TF32 keeps about three digits and would miss the 1e-4 limit).  A CTA
//     of 8 warps owns BM rows x NBLK output blocks (BM 128 and 16 blocks = 144
//     columns at k = 9, or 256 rows x 8 blocks where P <= 8, so that VGG-8's
//     first convolutions (P = 8) waste no column), every N edge on a block
//     edge.  A thread owns TM rows x one block (8 x 9 accumulators at k = 9):
//     per K step it loads TM values of x (as float2 pairs) and KP of W (as
//     float4), so each shared-memory load feeds 8 or more FMAs.  Operand
//     tiles of 32 K columns come through a 3-stage cp.async ring (x by
//     16-byte copies where its rows are 16-byte aligned, Q*k % 4 == 0; by
//     4-byte copies otherwise: Q*k = 27 and 513 on VGG-8; bf16 x is widened
//     by plain loads, which cp.async cannot do).  One CTA per SM (up to
//     255 registers, 161 used at k = 9): on an H100 that ran 3-7% faster
//     than two CTAs of 128 registers at 16 K columns a stage, at every
//     VGG-8 shape and at serve W1; neither a 4-stage ring nor scalar loads
//     of W moved it.  Where the output tiles would leave more than half the
//     SMs idle (serve W1: 32 tiles on 132 SMs; FC W1 at T = 32: 4), the
//     wrapper's plan splits the K range across CTAs and
//  3. ptc_sum_splits_kernel adds the (splits, T, P*k) fp32 partials in a
//     fixed order.  No atomics: two runs give the same bits.
//
// Per-block route (Q = 1 and T of the order of k: the IC/PM probes, the
// eye through every block): the output is the composed blocks themselves
// and the work is bytes (U, V* and y once).  A CTA stages NB consecutive
// blocks' U, s and V* (contiguous, float4 loads) in shared memory, one
// thread per (block, output row i) composes W_p[i, :] in registers and
// applies it to the T rows; thread (b, i) writes y[t, (p0 + b) k + i], so a
// warp writes each row of y as one contiguous run across the CTA's blocks.
//
// Launches on the caller's stream, allocates nothing (the wrapper passes
// scratch and partials), and returns cudaGetLastError().

#include "ptc_common.cuh"

namespace {

using ptc::cp_async16;
using ptc::cp_async4;
using ptc::from_f32;
using ptc::to_f32;

constexpr int kBK = 32;            // K columns per ring stage
constexpr int kStages = 3;
constexpr int kThreads = 256;      // product kernel: 8 warps
constexpr int kAStride = kBK + 4;  // x tile row stride: 16-byte aligned rows
                                   // on distinct banks for 4 rows of a warp

template <int KT>
struct Prod {
  static constexpr int KP = ptc::pad4(KT);
  static constexpr int TM = KT <= 9 ? 8 : (KT <= 16 ? 4 : 2);  // rows/thread
  static constexpr int WR = 32 / TM;  // lanes along rows (WR * TM = 32)
  static constexpr int WB = TM;       // lanes along blocks (WR * WB = 32)
};

template <int KT, int WN>
struct ProdTile {  // WN warps side by side along N, 8 / WN along M
  static constexpr int BM = 256 / WN;
  static constexpr int NBLK = WN * Prod<KT>::WB;
  static constexpr int BSTR = NBLK * Prod<KT>::KP;  // W tile row (floats)
  static constexpr int ASTAGE = BM * kAStride;
  static constexpr int STAGE = ASTAGE + kBK * BSTR;
  static constexpr size_t SMEM = sizeof(float) * kStages * STAGE;
};

// per-block route: NB blocks per CTA (a multiple of 4, so a CTA's U and V*
// start 16-byte aligned), rows of x staged TC at a time
template <int KT>
struct PerBlock {
  static constexpr int NB = KT == 32 ? 4 : (256 / KT) / 4 * 4;
  static constexpr int THREADS = NB * KT;
  static constexpr int TC = 32;
};

// n contiguous elements of src into fp32 shared memory (float4 loads where
// src is 16-byte aligned)
template <typename Tv>
__device__ __forceinline__ void stage_f32(float* dst, const Tv* src, int n) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if constexpr (sizeof(Tv) == 4) {
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const int n4 = n / 4;
      const float4* s4 = reinterpret_cast<const float4*>(src);
      float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll 4
      for (int i = tid; i < n4; i += nt) d4[i] = __ldg(s4 + i);
      for (int i = 4 * n4 + tid; i < n; i += nt) dst[i] = __ldg(src + i);
      return;
    }
  }
#pragma unroll 4
  for (int i = tid; i < n; i += nt) dst[i] = to_f32(src[i]);
}

// w = row i of W = U diag(s) V* for one block, from its dense k x k U and
// V* and its k values of s (zero past k)
template <int KT>
__device__ __forceinline__ void compose_row(const float* ub, const float* sb,
                                            const float* vb, int i, int k,
                                            float (&w)[KT]) {
#pragma unroll
  for (int j = 0; j < KT; ++j) w[j] = 0.f;
#pragma unroll
  for (int a = 0; a < KT; ++a) {
    if (a < k) {
      const float c = ub[i * k + a] * sb[a];
#pragma unroll
      for (int j = 0; j < KT; ++j)
        if (j < k) w[j] = fmaf(c, vb[a * k + j], w[j]);
    }
  }
}

// the compose pre-pass: a CTA composes PB consecutive p x QB consecutive q
// blocks, so that its loads are runs of QB blocks (contiguous in u, s, v)
// and its writes runs of PB blocks (contiguous in a row of wt)
template <int KT>
struct Compose {
  static constexpr int PB = KT <= 9 ? 16 : (KT == 16 ? 8 : 4);
  static constexpr int QB = KT == 32 ? 1 : 2;
  static constexpr int THREADS = PB * QB * KT;
};

// wt[q*k + j, p*KP + i] = sum_a u[p,q,i,a] s[p,q,a] v[p,q,a,j] for i < k.
// Thread (qb, pb, i) composes row i of block (p0 + pb, q0 + qb); for each j
// the threads of one qb write PB * KP consecutive floats of row (q*k + j).
// The padding columns k <= i < KP are never written: they feed only
// accumulators the product never stores.
template <int KT, typename Tv>
__global__ void __launch_bounds__(Compose<KT>::THREADS)
ptc_compose_kernel(const Tv* __restrict__ u, const Tv* __restrict__ s,
                   const Tv* __restrict__ v, float* __restrict__ wt, int P,
                   int Q, int k) {
  using L = Compose<KT>;
  constexpr int PB = L::PB, QB = L::QB, KP = ptc::pad4(KT);
  __shared__ float us[PB * QB * KT * KT], vs[PB * QB * KT * KT];
  __shared__ float ss[PB * QB * KT];
  const int p0 = blockIdx.x * PB, q0 = blockIdx.y * QB, tid = threadIdx.x;
  const int np = min(PB, P - p0), nq = min(QB, Q - q0), kk = k * k;
  // block (pb, qb) at us[(pb * QB + qb) * kk]: each pb's nq blocks are one
  // contiguous run of u, s and v
  for (int e = tid; e < np * nq * kk; e += L::THREADS) {
    const int pb = e / (nq * kk), r = e % (nq * kk);
    const long long off = ((long long)(p0 + pb) * Q + q0) * kk + r;
    us[pb * QB * kk + r] = to_f32(u[off]);
    vs[pb * QB * kk + r] = to_f32(v[off]);
  }
  for (int e = tid; e < np * nq * k; e += L::THREADS) {
    const int pb = e / (nq * k), r = e % (nq * k);
    ss[pb * QB * k + r] = to_f32(s[((long long)(p0 + pb) * Q + q0) * k + r]);
  }
  __syncthreads();
  const int i = tid % KT, pb = (tid / KT) % PB, qb = tid / (KT * PB);
  if (i >= k || pb >= np || qb >= nq) return;
  const int blk = pb * QB + qb;
  float w[KT];
  compose_row<KT>(us + blk * kk, ss + blk * k, vs + blk * kk, i, k, w);
  const long long ldw = (long long)P * KP;
  float* out =
      wt + (long long)(q0 + qb) * k * ldw + (long long)(p0 + pb) * KP + i;
#pragma unroll
  for (int j = 0; j < KT; ++j)
    if (j < k) out[j * ldw] = w[j];
}

// y (or the split's partial) = x[:, K range of split z] . wt[K range, :]
template <int KT, typename Tv, int WN>
__global__ void __launch_bounds__(kThreads, 1)
ptc_product_kernel(const Tv* __restrict__ x, const float* __restrict__ wt,
                   Tv* __restrict__ y, float* __restrict__ part, int T,
                   int P, int Kdim, int k, int kc, int splits, int vec) {
  using L = Prod<KT>;
  using G = ProdTile<KT, WN>;
  constexpr int KP = L::KP, TM = L::TM, WR = L::WR, WB = L::WB;
  constexpr int BM = G::BM, NBLK = G::NBLK, BSTR = G::BSTR;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WN, wq = warp % WN;
  const int lr = lane % WR, lb = lane / WR;
  const int pb0 = blockIdx.x * NBLK;
  const long long m0 = (long long)blockIdx.y * BM;
  const int split = blockIdx.z;
  const int kbeg = split * kc, kend = min(Kdim, kbeg + kc);
  const int nk = (kend - kbeg + kBK - 1) / kBK;
  const long long ldw = (long long)P * KP;

  // one ring stage: x rows m0.. and wt rows k0.. (zero past T, past the
  // split's K range and past P)
  auto load = [&](int slot, int kt) {
    float* As = smem + slot * G::STAGE;
    float* Bs = As + G::ASTAGE;
    const int k0 = kbeg + kt * kBK;
    if constexpr (sizeof(Tv) == 4) {
      if (vec) {
        for (int c = tid; c < BM * (kBK / 4); c += kThreads) {
          const int r = c / (kBK / 4), cc = (c % (kBK / 4)) * 4;
          const long long t = m0 + r;
          const bool ok = t < T && k0 + cc < kend;
          cp_async16(As + r * kAStride + cc,
                     ok ? x + t * Kdim + k0 + cc : x, ok);
        }
      } else {
        for (int c = tid; c < BM * kBK; c += kThreads) {
          const int r = c / kBK, cc = c % kBK;
          const long long t = m0 + r;
          const bool ok = t < T && k0 + cc < kend;
          cp_async4(As + r * kAStride + cc, ok ? x + t * Kdim + k0 + cc : x,
                    ok);
        }
      }
    } else {  // bf16, widened on load
      for (int c = tid; c < BM * kBK; c += kThreads) {
        const int r = c / kBK, cc = c % kBK;
        const long long t = m0 + r;
        const bool ok = t < T && k0 + cc < kend;
        As[r * kAStride + cc] = ok ? to_f32(x[t * Kdim + k0 + cc]) : 0.f;
      }
    }
    for (int c = tid; c < kBK * (BSTR / 4); c += kThreads) {
      const int r = c / (BSTR / 4), cc = (c % (BSTR / 4)) * 4;
      const bool ok = k0 + r < kend && pb0 + cc / KP < P;
      cp_async16(Bs + r * BSTR + cc,
                 ok ? wt + (k0 + r) * ldw + (long long)pb0 * KP + cc : wt, ok);
    }
  };

  float acc[TM][KT];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < KT; ++j) acc[i][j] = 0.f;

  const int arow = wm * 32 + lr;            // + WR * i
  const int bcol = (wq * WB + lb) * KP;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load(st, st);
    ptc::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    ptc::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed; the slot of kt - 1 is free
    {
      const int nt = kt + kStages - 1;
      if (nt < nk) load(nt % kStages, nt);
      ptc::cp_async_commit();
    }
    const float* As = smem + (kt % kStages) * G::STAGE;
    const float* Bs = As + G::ASTAGE;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 2) {
      float2 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float2*>(
            As + (arow + WR * i) * kAStride + kk);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float b[KP];
#pragma unroll
        for (int j4 = 0; j4 < KP / 4; ++j4) {
          const float4 w4 = *reinterpret_cast<const float4*>(
              Bs + (kk + h) * BSTR + bcol + 4 * j4);
          b[4 * j4] = w4.x;
          b[4 * j4 + 1] = w4.y;
          b[4 * j4 + 2] = w4.z;
          b[4 * j4 + 3] = w4.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = h ? a[i].y : a[i].x;
#pragma unroll
          for (int j = 0; j < KT; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
        }
      }
    }
  }

  const int blk = pb0 + wq * WB + lb;
  if (blk >= P) return;
  const long long ldy = (long long)P * k;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long t = m0 + arow + WR * i;
    if (t >= T) continue;
    if (splits == 1) {
      Tv* yr = y + t * ldy + (long long)blk * k;
#pragma unroll
      for (int j = 0; j < KT; ++j)
        if (j < k) yr[j] = from_f32<Tv>(acc[i][j]);
    } else {
      float* pr = part + ((long long)split * T + t) * ldy + (long long)blk * k;
#pragma unroll
      for (int j = 0; j < KT; ++j)
        if (j < k) pr[j] = acc[i][j];
    }
  }
}

template <int KT, typename Tv>
__global__ void __launch_bounds__(PerBlock<KT>::THREADS)
ptc_perblock_kernel(const Tv* __restrict__ x, const Tv* __restrict__ u,
                    const Tv* __restrict__ s, const Tv* __restrict__ v,
                    Tv* __restrict__ y, int T, int P, int k) {
  using L = PerBlock<KT>;
  constexpr int NB = L::NB, TC = L::TC;
  __shared__ __align__(16) float us[NB * KT * KT];
  __shared__ __align__(16) float vs[NB * KT * KT];
  __shared__ __align__(16) float ss[NB * KT];
  __shared__ __align__(16) float xs[TC * KT];
  const int p0 = blockIdx.x * NB, tid = threadIdx.x;
  const int nb = min(NB, P - p0), kk = k * k;
  stage_f32(us, u + (long long)p0 * kk, nb * kk);
  stage_f32(vs, v + (long long)p0 * kk, nb * kk);
  stage_f32(ss, s + (long long)p0 * k, nb * k);
  __syncthreads();

  const int b = tid / KT, i = tid % KT;
  const bool live = b < nb && i < k;
  float w[KT];
  compose_row<KT>(us + b * kk, ss + b * k, vs + b * kk, live ? i : 0, k, w);
  const long long ldy = (long long)P * k;
  Tv* yc = y + (long long)(p0 + b) * k + i;
  for (int t0 = 0; t0 < T; t0 += TC) {
    const int tn = min(TC, T - t0);
    __syncthreads();  // the previous rows of x are used
    stage_f32(xs, x + (long long)t0 * k, tn * k);
    __syncthreads();
    if (live) {
      for (int tl = 0; tl < tn; ++tl) {
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < KT; ++j)
          if (j < k) a = fmaf(w[j], xs[tl * k + j], a);
        yc[(long long)(t0 + tl) * ldy] = from_f32<Tv>(a);
      }
    }
  }
}

template <typename Tv>
__global__ void ptc_sum_splits_kernel(const float* __restrict__ part,
                                      Tv* __restrict__ y, long long n,
                                      int splits) {
  ptc::sum_splits(part, y, n, splits);
}

template <int KT, typename Tv, int WN>
cudaError_t launch_product(const Tv* x, const Tv* u, const Tv* s,
                           const Tv* v, float* wt, float* part, Tv* y, int T,
                           int P, int Q, int k, int kc, int splits,
                           cudaStream_t st) {
  using G = ProdTile<KT, WN>;
  using C = Compose<KT>;
  ptc_compose_kernel<KT, Tv>
      <<<dim3((P + C::PB - 1) / C::PB, (Q + C::QB - 1) / C::QB), C::THREADS,
         0, st>>>(u, s, v, wt, P, Q, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int Kdim = Q * k;
  const int vec = sizeof(Tv) == 4 && Kdim % 4 == 0 &&
                  (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  auto kern = ptc_product_kernel<KT, Tv, WN>;
  if (G::SMEM > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::SMEM);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((P + G::NBLK - 1) / G::NBLK, (T + G::BM - 1) / G::BM,
                  splits);
  kern<<<grid, kThreads, G::SMEM, st>>>(x, wt, y, part, T, P, Kdim, k, kc,
                                        splits, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long n = (long long)T * P * k;
  ptc_sum_splits_kernel<Tv><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      part, y, n, splits);
  return cudaGetLastError();
}

template <typename Tv>
cudaError_t product(const void* x, const void* u, const void* s,
                    const void* v, void* wt, void* part, void* y, int T,
                    int P, int Q, int k, int wn, int kc, int splits,
                    cudaStream_t st) {
  const Tv *xx = static_cast<const Tv*>(x), *uu = static_cast<const Tv*>(u),
           *ss = static_cast<const Tv*>(s), *vv = static_cast<const Tv*>(v);
  float *w = static_cast<float*>(wt), *pt = static_cast<float*>(part);
  Tv* yy = static_cast<Tv*>(y);
#define REPRO_PRODUCT(KT)                                                    \
  return wn == 1 ? launch_product<KT, Tv, 1>(xx, uu, ss, vv, w, pt, yy, T, P, \
                                             Q, k, kc, splits, st)            \
                 : launch_product<KT, Tv, 2>(xx, uu, ss, vv, w, pt, yy, T, P, \
                                             Q, k, kc, splits, st)
  switch (ptc::kernel_k(k)) {
    case 4: REPRO_PRODUCT(4);
    case 8: REPRO_PRODUCT(8);
    case 9: REPRO_PRODUCT(9);
    case 16: REPRO_PRODUCT(16);
    case 32: REPRO_PRODUCT(32);
  }
#undef REPRO_PRODUCT
  return cudaErrorInvalidValue;
}

template <int KT, typename Tv>
cudaError_t launch_perblock(const void* x, const void* u, const void* s,
                            const void* v, void* y, int T, int P, int k,
                            cudaStream_t st) {
  using L = PerBlock<KT>;
  ptc_perblock_kernel<KT, Tv><<<(P + L::NB - 1) / L::NB, L::THREADS, 0, st>>>(
      static_cast<const Tv*>(x), static_cast<const Tv*>(u),
      static_cast<const Tv*>(s), static_cast<const Tv*>(v),
      static_cast<Tv*>(y), T, P, k);
  return cudaGetLastError();
}

template <typename Tv>
cudaError_t perblock(const void* x, const void* u, const void* s,
                     const void* v, void* y, int T, int P, int k,
                     cudaStream_t st) {
  switch (ptc::kernel_k(k)) {
    case 4: return launch_perblock<4, Tv>(x, u, s, v, y, T, P, k, st);
    case 8: return launch_perblock<8, Tv>(x, u, s, v, y, T, P, k, st);
    case 9: return launch_perblock<9, Tv>(x, u, s, v, y, T, P, k, st);
    case 16: return launch_perblock<16, Tv>(x, u, s, v, y, T, P, k, st);
    case 32: return launch_perblock<32, Tv>(x, u, s, v, y, T, P, k, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// The product route's tile for block size k and wn warps along N: out[0] =
// rows per CTA, out[1] = output blocks per CTA, out[2] = K columns per ring
// stage.  Returns 0, or cudaErrorInvalidValue for an unsupported k or wn.
extern "C" int ptc_block_matmul_tile(int k, int wn, int* out) {
  const int kt = ptc::kernel_k(k);
  if (kt == 0 || (wn != 1 && wn != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int wb = kt <= 9 ? 8 : (kt <= 16 ? 4 : 2);
  out[0] = 256 / wn;
  out[1] = wn * wb;
  out[2] = kBK;
  return 0;
}

// Product route.  dtype: 0 = float32, 1 = bfloat16 (x, u, s, v and y).
// Scratch: wt (Q*k, P*KP) fp32, KP = the kernel's k rounded up to a multiple
// of 4; part (splits, T, P*k) fp32, unused when splits == 1.  The K range
// Q*k is cut into splits of kc columns (kc a multiple of 16).
extern "C" int ptc_block_matmul_product(const void* x, const void* u,
                                        const void* s, const void* v,
                                        void* wt, void* part, void* y, int T,
                                        int P, int Q, int k, int dtype,
                                        int wn, int kc, int splits,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kc <= 0 || kc % kBK != 0 || splits < 1 ||
      splits != (Q * k + kc - 1) / kc || (wn != 1 && wn != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(product<float>(x, u, s, v, wt, part, y, T, P, Q,
                                           k, wn, kc, splits, st));
  if (dtype == 1)
    return static_cast<int>(product<__nv_bfloat16>(
        x, u, s, v, wt, part, y, T, P, Q, k, wn, kc, splits, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Per-block route (Q = 1): x (T, k), u and v (P, 1, k, k), s (P, 1, k).
extern "C" int ptc_block_matmul_perblock(const void* x, const void* u,
                                         const void* s, const void* v,
                                         void* y, int T, int P, int k,
                                         int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(perblock<float>(x, u, s, v, y, T, P, k, st));
  if (dtype == 1)
    return static_cast<int>(
        perblock<__nv_bfloat16>(x, u, s, v, y, T, P, k, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
