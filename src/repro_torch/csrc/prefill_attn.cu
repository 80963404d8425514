// Chunked paged-prefill attention for the serving gateway.
//
// Since the tensor-core kernel (prefill_attn_tc.cu), this one serves only
// fp32 q (over fp32 or bf16 K/V) and bf16 pairs at head dims other than
// 64 and 128.
//
// Replaces the TPU kernel repro/kernels/prefill_attn.py::prefill_attention
// (dispatched by repro/kernels/ops.py).  Shapes: lens (B,) int32; q (B, C,
// H, Dh); k, v (B, S, Hkv, Dh) page-assembled views with the chunk's own
// rows already spliced in  ->  out (B, C, H, Dh) in q's dtype.  Query c of
// slot b sits at absolute position qi = lens[b] + c and sees key ki iff
// ki <= qi (and ki > qi - window for a sliding window); query head h reads
// KV head h / (H / Hkv) (GQA).  logit = (q . k) / sqrt(Dh), soft-capped as
// cap * tanh(logit / cap) when a cap is given, before masking.  q and k/v
// are fp32/fp32, fp32/bf16 or bf16/bf16; every product and sum is fp32.
//
// What bounds it on an H100: at the gateway's full-width step (B 8, C 64,
// H 32, Hkv 8, Dh 128, S 640) about 4 * Dh * H FLOPs per live query-key pair,
// a few GFLOP over a few tens of MB: the tensor cores' rate, were the products
// on them.  This first kernel keeps them on the CUDA cores in fp32 (the
// wgmma design is prefill_attn_tc.cu).
//
// Design:
//  * The TPU grid (slot, KV block) carries the online-softmax state (running
//    max, denominator, accumulator) in VMEM scratch from one KV block to the
//    next.  Here one CTA owns (slot b, KV head g, 32 query rows), a row being
//    one (chunk position c, query head h of the group): the rep query heads
//    that share KV head g read each K/V tile from shared memory once.  The
//    CTA loops over the view's keys in tiles of T <= 32 keys (T divides the
//    caller's block `blk`, so no tile straddles two blocks) and keeps each
//    row's state in registers of its warp: lane j computes the logit of key
//    j of the tile, the warp reduces max and sum by shuffles, and each lane
//    accumulates Dh / 32 output columns.
//  * Masking discipline as in the reference: a masked logit is forced to the
//    finite floor NEG_INF = -2^30 before the tile max, so a row whose keys
//    are all masked so far keeps a finite running max, and its probability is
//    zeroed BY THE MASK (never by the floor), so a fully masked tile adds
//    exactly +0.0 (alpha = exp(0) = 1, p = 0).
//  * Causal masking leaves about half the keys dead.  Tiles wholly past the
//    CTA's last query position, or wholly before its window, are skipped:
//    their contribution is exactly zero, so skipping changes no bit.
//  * Deterministic: fixed summation order, no atomics; two runs give the
//    same bits.
//  * The Pallas body rounds bf16 q.k logits to bf16 before its fp32 cast;
//    this kernel does not copy that rounding.
//  * Launch on the caller's stream, allocate nothing, return
//    cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per CTA
constexpr float kNegInf = -1073741824.0f;     // -2^30, the reference's floor
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <typename QT, typename KT, int DPL>
__global__ void __launch_bounds__(kThreads)
prefill_kernel(const int* __restrict__ lens, const QT* __restrict__ q,
               const KT* __restrict__ k, const KT* __restrict__ v,
               QT* __restrict__ out, int C, int H, int Hkv, int Dh, int S,
               int T, int window, float cap, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                    // kRows x Dh
  float* ks = qs + kRows * Dh;         // T x (Dh + 1): conflict-free rows
  float* vs = ks + T * (Dh + 1);       // T x Dh
  const int rep = H / Hkv;
  const int b = blockIdx.z, g = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int n_rows = C * rep;          // rows of (b, g)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ln = lens[b];

  for (int i = threadIdx.x; i < kRows * Dh; i += kThreads) {
    const int r = row0 + i / Dh, d = i % Dh;
    float x = 0.f;
    if (r < n_rows) {
      const int c = r / rep, h = g * rep + r % rep;
      x = to_float(q[(((long long)b * C + c) * H + h) * Dh + d]);
    }
    qs[i] = x;
  }

  // keys any row of this CTA can see
  const int last_row = min(n_rows, row0 + kRows) - 1;
  const int key_hi = min(ln + last_row / rep, S - 1);
  const int key_lo = window > 0 ? max(0, ln + row0 / rep - window + 1) : 0;
  const int t_begin = key_lo / T;
  const int t_end = key_lo <= key_hi ? key_hi / T + 1 : t_begin;

  float acc[kRowsPerWarp][DPL], m[kRowsPerWarp], den[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    den[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[i][e] = 0.f;
  }

  const long long kv_row = (long long)Hkv * Dh;  // view row stride
  const KT* kb = k + (long long)b * S * kv_row + (long long)g * Dh;
  const KT* vb = v + (long long)b * S * kv_row + (long long)g * Dh;

  for (int t = t_begin; t < t_end; ++t) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int i = threadIdx.x; i < T * Dh; i += kThreads) {
      const int j = i / Dh, d = i % Dh;
      const long long off = (long long)(t * T + j) * kv_row + d;
      ks[j * (Dh + 1) + d] = to_float(kb[off]);
      vs[j * Dh + d] = to_float(vb[off]);
    }
    __syncthreads();

    const int kpos = t * T + lane;  // this lane's key
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int rl = warp * kRowsPerWarp + i;
      const int r = row0 + rl;
      if (r < n_rows) {  // warp-uniform
        const int qi = ln + r / rep;
        float logit = kNegInf;
        bool ok = false;
        if (lane < T) {
          const float* qr = qs + rl * Dh;
          const float* kr = ks + lane * (Dh + 1);
          float dot = 0.f;
          for (int d = 0; d < Dh; ++d) dot = fmaf(qr[d], kr[d], dot);
          logit = dot * scale;
          if (cap > 0.f) logit = cap * tanhf(logit / cap);
          ok = kpos <= qi && (window <= 0 || kpos > qi - window);
          if (!ok) logit = kNegInf;
        }
        const float m_new = fmaxf(m[i], warp_max(logit));
        const float alpha = expf(m[i] - m_new);
        const float p = ok ? expf(logit - m_new) : 0.f;
        den[i] = den[i] * alpha + warp_sum(p);
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[i][e] *= alpha;
        for (int j = 0; j < T; ++j) {
          const float pj = __shfl_sync(kFull, p, j);
          const float* vr = vs + j * Dh;
#pragma unroll
          for (int e = 0; e < DPL; ++e) {
            const int d = lane + 32 * e;
            if (d < Dh) acc[i][e] = fmaf(pj, vr[d], acc[i][e]);
          }
        }
        m[i] = m_new;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = row0 + warp * kRowsPerWarp + i;
    if (r < n_rows) {
      const int c = r / rep, h = g * rep + r % rep;
      QT* o = out + (((long long)b * C + c) * H + h) * Dh;
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        const int d = lane + 32 * e;
        if (d < Dh) store(o + d, acc[i][e] / den[i]);
      }
    }
  }
}

template <typename QT, typename KT, int DPL>
cudaError_t launch(const int* lens, const void* q, const void* k,
                   const void* v, void* out, int B, int C, int H, int Hkv,
                   int Dh, int S, int T, int window, float cap, float scale,
                   cudaStream_t st) {
  const size_t smem = sizeof(float) *
      ((size_t)kRows * Dh + (size_t)T * (Dh + 1) + (size_t)T * Dh);
  auto kern = prefill_kernel<QT, KT, DPL>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((C * (H / Hkv) + kRows - 1) / kRows, Hkv, B);
  kern<<<grid, kThreads, smem, st>>>(
      lens, static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<QT*>(out), C, H, Hkv, Dh, S, T,
      window, cap, scale);
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t by_width(const int* lens, const void* q, const void* k,
                     const void* v, void* out, int B, int C, int H, int Hkv,
                     int Dh, int S, int T, int window, float cap, float scale,
                     cudaStream_t st) {
  if (Dh <= 32) return launch<QT, KT, 1>(lens, q, k, v, out, B, C, H, Hkv, Dh, S, T, window, cap, scale, st);
  if (Dh <= 64) return launch<QT, KT, 2>(lens, q, k, v, out, B, C, H, Hkv, Dh, S, T, window, cap, scale, st);
  if (Dh <= 128) return launch<QT, KT, 4>(lens, q, k, v, out, B, C, H, Hkv, Dh, S, T, window, cap, scale, st);
  if (Dh <= 256) return launch<QT, KT, 8>(lens, q, k, v, out, B, C, H, Hkv, Dh, S, T, window, cap, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// q_bf16 / kv_bf16: 1 = bf16, 0 = fp32.  T: keys per tile (1..32, divides
// S).  window <= 0: none; cap <= 0: none.
extern "C" int prefill_attention(const void* lens, const void* q,
                                 const void* k, const void* v, void* out,
                                 int B, int C, int H, int Hkv, int Dh, int S,
                                 int T, int window, float cap, float scale,
                                 int q_bf16, int kv_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ln = static_cast<const int*>(lens);
  if (T < 1 || T > 32 || S % T != 0 || Hkv < 1 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (q_bf16 && kv_bf16)
    err = by_width<__nv_bfloat16, __nv_bfloat16>(ln, q, k, v, out, B, C, H, Hkv, Dh, S, T, window, cap, scale, st);
  else if (q_bf16)  // bf16 q over fp32 K/V: no caller (the pools are bf16)
    err = cudaErrorInvalidValue;
  else if (kv_bf16)
    err = by_width<float, __nv_bfloat16>(ln, q, k, v, out, B, C, H, Hkv, Dh, S, T, window, cap, scale, st);
  else
    err = by_width<float, float>(ln, q, k, v, out, B, C, H, Hkv, Dh, S, T, window, cap, scale, st);
  return static_cast<int>(err);
}
