// Block-masked error feedback  dx_q = sum_p mask[q,p] V*_pq^T (s_pq * (U_pq^T dy_p))
// (paper Eq. 5, the input-gradient half, with feedback sampling: masked
// blocks are skipped whole).
//
// Replaces the TPU kernel repro/kernels/feedback_matmul.py::feedback_matmul
// (dispatched by repro/kernels/ops.py::feedback_matmul).  Shapes: dy
// (T, P*k), u and v (P, Q, k, k) with v holding V*, s (P, Q, k), mask (Q, P)
// already scaled by its normalizer  ->  dx (T, Q*k); dy, u, s, v and dx fp32
// or bf16 (all alike; the mask fp32), widened to fp32 by the pre-passes,
// every product and sum fp32.  k <= 32; larger k take the wide route
// (ptc_wide.cu).
//
// What bounds it on an H100: arithmetic.  Composed, a kept block costs
// 2k^2 flops per row; at the widest shape of the training path (FC 4096 ->
// 512 of VGG-8, T = 1024, P = 57, Q = 456, k = 9) with 60% of the blocks
// kept that is 2.6 GFLOP over ~28 MB: 0.039 ms at the fp32 CUDA-core rate
// (67 TFLOP/s).  k = 9 fits no tensor-core tile and plain TF32 misses the
// 1e-4 limit; 3xTF32 on k padded to 16 would waste 2/3 of each product,
// so the products stay on the CUDA cores in full fp32.
//
// The first design kept the factored form (4k^2 + k flops per row and block,
// twice the composed cost), fed every FMA one shared-memory operand (one
// thread per row, U and V* broadcast: no register reuse), and gave each
// CTA one q, so every dy column tile was staged again for each of the
// ~0.6 Q CTAs that kept it (~0.57 GB of fills at FC W1): 17x its bound.
//
// Design:
//  * Two pre-passes into scratch the wrapper allocates.  (1) Each kept block
//    is composed once, W~_pq = mask[q,p] U_pq diag(s_pq) V*_pq (2k^3 flops
//    a block, ~23 MFLOP at FC W1), laid out (P, Q, k, KP) with KP = k padded
//    to a multiple of 4 by zero columns; masked blocks are not composed,
//    and the product never reads them.  Then dx_q = sum_p dy_p W~_pq.  (2) dy is transposed to
//    (P*k, T_pad), so one block column of a row tile is contiguous and moves
//    by one bulk copy (dy's own rows, P*k floats, are not 16-byte aligned).
//  * The main kernel's CTA owns a tile of 32 * RT rows and a group of 8
//    consecutive q, one consumer warp each, plus a producer warp.  It lists,
//    on the card, the p that any q of the group kept (ballot + popc, with
//    each p's per-q bits).  The producer's one thread walks that list and
//    bulk-copies (cp.async.bulk, mbarrier completion) each block's dy
//    column tile and the group's W~ blocks into a ring of NB slots in
//    shared memory: each dy tile is staged once for all 8 q, where the first
//    design staged it once per q.  Consumer warps release a slot through a
//    second mbarrier, so a warp whose q kept more blocks so far may trail
//    the others by up to NB blocks before it holds them up.  A warp whose q
//    did not keep p skips it (the test is warp-uniform).
//  * Register tiling: each lane owns RT rows x k columns of accumulators
//    (4 consecutive rows per float4 load when RT >= 4), so a dy load feeds
//    k FMAs and a W~ row (float4 broadcast loads) feeds RT rows.
//  * Output goes through shared memory in rounds of 32 or 128 rows, so each
//    row's 8k columns of the group are written contiguously.
//  * A mask row with no kept block gives an exact zero; the T tail is zero
//    in dy's transpose and never stored.  Fixed order, no atomics: two
//    runs give the same bits.  Launches on the caller's stream, allocates
//    nothing, and returns cudaGetLastError().

#include "ptc_common.cuh"

namespace {

constexpr int kGroup = 8;                  // q per CTA, one consumer warp each
constexpr int kThreads = 32 * (kGroup + 1);  // + one producer warp
constexpr int kRingBytes = 96 * 1024;      // ring budget per CTA

__host__ __device__ constexpr int padded(int K) { return (K + 3) / 4 * 4; }

template <int K, int RT>
struct Ring {  // in floats
  static constexpr int KP = padded(K);
  static constexpr int TR = 32 * RT;                 // rows per CTA
  static constexpr int DY = K * TR;                  // dy^T tile: [l][row]
  static constexpr int SLOT = DY + kGroup * K * KP;  // + the group's W~
  static constexpr int NB_FIT = kRingBytes / (4 * SLOT);
  static constexpr int NB = NB_FIT < 2 ? 2 : (NB_FIT > 8 ? 8 : NB_FIT);
  // output rows staged per round: 128 (4 per lane) when RT >= 4, else 32
  static constexpr int RR = RT >= 4 ? 128 : 32;
  static constexpr int OUT = RR * (kGroup * K + 1);
  static constexpr int FLOATS = NB * SLOT > OUT ? NB * SLOT : OUT;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
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
// a copy that never lands stops the kernel with a trap after some
// seconds instead of hanging the card
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
// bytes (a multiple of 16) from global to shared, completing on bar
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// the consumer warps' own barrier (the producer warp does not join)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kGroup) : "memory");
}

// wt[p, q, l, :] = mask[q, p] * sum_i u[p, q, l, i] s[p, q, i] v[p, q, i, :]
// for kept blocks (zero past column k); masked blocks are left unwritten.
// A CTA stages 128 / K consecutive blocks' U, s and V* in shared memory
// (coalesced), then one thread composes one row l of one block.
template <int K, typename Tv>
__global__ void __launch_bounds__(128)
compose_kernel(const Tv* __restrict__ u, const Tv* __restrict__ s,
               const Tv* __restrict__ v, const float* __restrict__ mask,
               float* __restrict__ wt, int P, int Q, int k) {
  constexpr int KP = padded(K), B = 128 / K;
  __shared__ float us[B * K * K], vs[B * K * K], ss[B * K], ms[B];
  const long long blk0 = (long long)blockIdx.x * B;
  const int nb = (int)min((long long)B, (long long)P * Q - blk0);
  const int tid = threadIdx.x, kk = k * k;
  for (int i = tid; i < nb * kk; i += 128) {
    us[i] = ptc::to_f32(u[blk0 * kk + i]);
    vs[i] = ptc::to_f32(v[blk0 * kk + i]);
  }
  for (int i = tid; i < nb * k; i += 128) ss[i] = ptc::to_f32(s[blk0 * k + i]);
  if (tid < nb) {
    const long long blk = blk0 + tid;  // p * Q + q
    ms[tid] = mask[(blk % Q) * P + blk / Q];
  }
  __syncthreads();
  const int b = tid / k, l = tid % k;
  if (b >= nb) return;
  const float m = ms[b];
  if (m == 0.f) return;
  const float* ub = us + b * kk + l * k;
  const float* sb = ss + b * k;
  const float* vb = vs + b * kk;
  float w[KP];
#pragma unroll
  for (int j = 0; j < KP; ++j) w[j] = 0.f;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (i < k) {
      const float a = ub[i] * sb[i];
#pragma unroll
      for (int j = 0; j < K; ++j)
        if (j < k) w[j] = fmaf(a, vb[i * k + j], w[j]);
    }
  }
  float4* out = reinterpret_cast<float4*>(wt + ((blk0 + b) * k + l) * KP);
#pragma unroll
  for (int j4 = 0; j4 < KP / 4; ++j4)
    out[j4] = make_float4(w[4 * j4] * m, w[4 * j4 + 1] * m,
                          w[4 * j4 + 2] * m, w[4 * j4 + 3] * m);
}

// dyt (P*k, T_pad) = dy (T, P*k) transposed, zero past row T: each
// (block, column l)'s rows are contiguous, so one bulk copy moves a row
// tile of it
template <typename Tv>
__global__ void transpose_kernel(const Tv* __restrict__ dy,
                                 float* __restrict__ dyt, int T, int T_pad,
                                 int N) {
  __shared__ float tile[32][33];
  const int c0 = blockIdx.x * 32, t0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int t = t0 + i, c = c0 + threadIdx.x;
    tile[i][threadIdx.x] =
        (t < T && c < N) ? ptc::to_f32(dy[(long long)t * N + c]) : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int c = c0 + i, t = t0 + threadIdx.x;
    if (c < N && t < T_pad) dyt[(long long)c * T_pad + t] = tile[threadIdx.x][i];
  }
}

template <int K, int RT, typename To>
__global__ void __launch_bounds__(kThreads, 2)
feedback_matmul_kernel(const float* __restrict__ dyt,
                       const float* __restrict__ wt,
                       const float* __restrict__ mask,
                       To* __restrict__ dx, int T, int T_pad, int P,
                       int Q, int k) {
  using L = Ring<K, RT>;
  constexpr int KP = L::KP, TR = L::TR, NB = L::NB;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);        // [NB][SLOT]
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + L::FLOATS);
  int* plist = reinterpret_cast<int*>(bars + 2 * NB);   // [P]
  uint32_t* pbits = reinterpret_cast<uint32_t*>(plist + P);  // [P]
  __shared__ int n_kept;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * kGroup;
  const int nq = min(kGroup, Q - q0);
  const int t0 = blockIdx.y * TR;
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * NB;

  // the p any q of the group kept, ascending, with the group's bits
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < P; base += 32) {
      const int p = base + lane;
      uint32_t bits = 0;
      if (p < P)
        for (int w = 0; w < nq; ++w)
          bits |= (uint32_t)(mask[(long long)(q0 + w) * P + p] != 0.f) << w;
      const unsigned kept = __ballot_sync(0xffffffffu, bits != 0);
      if (bits != 0) {
        const int at = n + __popc(kept & ((1u << lane) - 1u));
        plist[at] = p;
        pbits[at] = bits;
      }
      n += __popc(kept);
    }
    if (lane == 0) n_kept = n;
  } else if (warp == kGroup && lane == 0) {
    for (int b = 0; b < NB; ++b) {
      mbar_init(full0 + 8 * b, 1);
      mbar_init(empty0 + 8 * b, kGroup);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int n = n_kept;

  if (warp == kGroup) {
    // producer: slot idx % NB takes kept block plist[idx] once every
    // consumer warp has released the slot's previous block
    if (lane == 0) {
      const uint32_t wbytes = 4u * nq * k * KP;
      for (int idx = 0; idx < n; ++idx) {
        const int b = idx % NB, round = idx / NB;
        if (round > 0) mbar_wait(empty0 + 8 * b, (round - 1) & 1);
        const uint32_t full = full0 + 8 * b;
        mbar_expect_tx(full, 4u * k * TR + wbytes);
        const int p = plist[idx];
        const uint32_t slot = smem_u32(ring + b * L::SLOT);
        for (int l = 0; l < k; ++l)
          bulk_copy(slot + 4 * l * TR,
                    dyt + ((long long)p * k + l) * T_pad + t0, 4u * TR, full);
        bulk_copy(slot + 4 * L::DY, wt + ((long long)p * Q + q0) * k * KP,
                  wbytes, full);
      }
    }
    return;
  }

  // consumers: warp w owns q0 + w; lane owns rows row_of(i, lane) of the
  // tile: 4 consecutive rows per 128 (float4 loads) when RT >= 4, else
  // lane + 32 i
  float acc[RT][K];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j) acc[i][j] = 0.f;

  const bool live = warp < nq;
  for (int idx = 0; idx < n; ++idx) {
    const int b = idx % NB;
    mbar_wait(full0 + 8 * b, (idx / NB) & 1);
    if (live && ((pbits[idx] >> warp) & 1u)) {
      const float* d = ring + b * L::SLOT + (RT >= 4 ? 4 * lane : lane);
      const float* w = ring + b * L::SLOT + L::DY + warp * k * KP;
#pragma unroll
      for (int l = 0; l < K; ++l) {
        if (l < k) {
          float dv[RT], wv[KP];
          if constexpr (RT >= 4) {
#pragma unroll
            for (int h = 0; h < RT / 4; ++h) {
              const float4 x = *reinterpret_cast<const float4*>(
                  d + l * TR + 128 * h);
              dv[4 * h] = x.x;
              dv[4 * h + 1] = x.y;
              dv[4 * h + 2] = x.z;
              dv[4 * h + 3] = x.w;
            }
          } else {
#pragma unroll
            for (int i = 0; i < RT; ++i) dv[i] = d[l * TR + 32 * i];
          }
#pragma unroll
          for (int j4 = 0; j4 < KP / 4; ++j4) {
            const float4 x =
                *reinterpret_cast<const float4*>(w + l * KP + 4 * j4);
            wv[4 * j4] = x.x;
            wv[4 * j4 + 1] = x.y;
            wv[4 * j4 + 2] = x.z;
            wv[4 * j4 + 3] = x.w;
          }
#pragma unroll
          for (int i = 0; i < RT; ++i)
#pragma unroll
            for (int j = 0; j < K; ++j)
              acc[i][j] = fmaf(dv[i], wv[j], acc[i][j]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * b);
  }
  consumers_sync();  // every block consumed: the ring is free

  // RR rows at a time through shared memory: row rr, column w * k + j
  constexpr int OS = kGroup * K + 1, RR = L::RR;
  const int width = nq * k;
  float* os = ring;
#pragma unroll
  for (int h = 0; h < TR / RR; ++h) {
    if (live) {
#pragma unroll
      for (int c = 0; c < RT * RR / TR; ++c) {
        const int i = h * (RT * RR / TR) + c;  // acc row of this round
        const int rr = RT >= 4 ? 4 * lane + c : lane;
#pragma unroll
        for (int j = 0; j < K; ++j)
          if (j < k) os[rr * OS + warp * k + j] = acc[i][j];
      }
    }
    consumers_sync();
    for (int rr = warp; rr < RR; rr += kGroup) {
      const long long t = t0 + RR * h + rr;
      if (t >= T) break;
      To* row = dx + t * ((long long)Q * k) + (long long)q0 * k;
      for (int cc = lane; cc < width; cc += 32)
        row[cc] = ptc::from_f32<To>(os[rr * OS + cc]);
    }
    consumers_sync();
  }
}

template <int K, int RT, typename To>
cudaError_t launch_main(const float* dyt, const float* wt, const float* mask,
                        To* dx, int T, int T_pad, int P, int Q, int k,
                        cudaStream_t st) {
  using L = Ring<K, RT>;
  const size_t smem =
      sizeof(float) * L::FLOATS + 16 * L::NB + 2 * sizeof(int) * P;
  auto kern = feedback_matmul_kernel<K, RT, To>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Q + kGroup - 1) / kGroup, T_pad / L::TR);
  kern<<<grid, kThreads, smem, st>>>(dyt, wt, mask, dx, T, T_pad, P, Q, k);
  return cudaGetLastError();
}

template <int K, typename To>
cudaError_t by_rows(int rt, const float* dyt, const float* wt,
                    const float* mask, To* dx, int T, int T_pad, int P,
                    int Q, int k, cudaStream_t st) {
  switch (rt) {
    case 1:
      return launch_main<K, 1, To>(dyt, wt, mask, dx, T, T_pad, P, Q, k, st);
    case 2:
      return launch_main<K, 2, To>(dyt, wt, mask, dx, T, T_pad, P, Q, k, st);
    case 4:
      if constexpr (K <= 16)
        return launch_main<K, 4, To>(dyt, wt, mask, dx, T, T_pad, P, Q, k,
                                     st);
      break;
    case 8:
      if constexpr (K <= 9)
        return launch_main<K, 8, To>(dyt, wt, mask, dx, T, T_pad, P, Q, k,
                                     st);
      break;
  }
  return cudaErrorInvalidValue;
}

// the two pre-passes (compose, transpose), then the product
template <int K, typename Tv>
cudaError_t launch(int rt, const Tv* dy, const Tv* u, const Tv* s,
                   const Tv* v, const float* mask, float* wt, float* dyt,
                   Tv* dx, int T, int P, int Q, int k, cudaStream_t st) {
  const int tr = 32 * rt;
  const int T_pad = (T + tr - 1) / tr * tr;
  const long long rows = (long long)P * Q * k;
  if (rows > 0) {
    constexpr int B = 128 / K;  // blocks per compose CTA
    compose_kernel<K, Tv><<<(unsigned)(((long long)P * Q + B - 1) / B), 128, 0,
                        st>>>(u, s, v, mask, wt, P, Q, k);
    const dim3 grid((P * k + 31) / 32, T_pad / 32);
    transpose_kernel<Tv><<<grid, dim3(32, 8), 0, st>>>(dy, dyt, T, T_pad,
                                                       P * k);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return by_rows<K, Tv>(rt, dyt, wt, mask, dx, T, T_pad, P, Q, k, st);
}

template <typename Tv>
cudaError_t by_k(int kt, int rt, const void* dy, const void* u,
                 const void* s, const void* v, const float* m, float* w,
                 float* d, void* dx, int T, int P, int Q, int k,
                 cudaStream_t st) {
  const Tv* a = static_cast<const Tv*>(dy);
  const Tv* uu = static_cast<const Tv*>(u);
  const Tv* ss = static_cast<const Tv*>(s);
  const Tv* vv = static_cast<const Tv*>(v);
  Tv* o = static_cast<Tv*>(dx);
  switch (kt) {
    case 4: return launch<4, Tv>(rt, a, uu, ss, vv, m, w, d, o, T, P, Q, k, st);
    case 8: return launch<8, Tv>(rt, a, uu, ss, vv, m, w, d, o, T, P, Q, k, st);
    case 9: return launch<9, Tv>(rt, a, uu, ss, vv, m, w, d, o, T, P, Q, k, st);
    case 16: return launch<16, Tv>(rt, a, uu, ss, vv, m, w, d, o, T, P, Q, k, st);
    case 32: return launch<32, Tv>(rt, a, uu, ss, vv, m, w, d, o, T, P, Q, k, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// dtype: 0 = float32, 1 = bfloat16 (dy, u, s, v and dx alike; the mask
// fp32).  kt: the kernel's k (4, 8, 9, 16 or 32, >= k); rt: rows per lane
// (1, 2, 4 or 8; at most 8 for kt <= 9, 4 for 16, 2 for 32).
// Scratch: wt (P, Q, k, KP) with KP = kt rounded up to a multiple of 4;
// dyt (P*k, T_pad) with T_pad = T rounded up to a multiple of 32 * rt.
extern "C" int feedback_matmul(const void* dy, const void* u, const void* s,
                               const void* v, const void* mask, void* wt,
                               void* dyt, void* dx, int T, int P, int Q,
                               int k, int kt, int rt, int dtype,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  float* w = static_cast<float*>(wt);
  float* d = static_cast<float*>(dyt);
  if (k < 1 || k > kt || (kt == 32 && rt > 2) || (kt == 16 && rt > 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(by_k<float>(kt, rt, dy, u, s, v, m, w, d, dx, T,
                                        P, Q, k, st));
  if (dtype == 1)
    return static_cast<int>(by_k<__nv_bfloat16>(kt, rt, dy, u, s, v, m, w, d,
                                                 dx, T, P, Q, k, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
