// Chunked paged-prefill attention for the serving gateway, on the CUDA cores.
//
// Since the tensor-core kernel (prefill_attn_tc.cu), this one serves only
// fp32 q (over fp32 or bf16 K/V) and bf16 pairs at head dims other than
// 64 and 128, up to 256.
//
// Replaces the TPU kernel repro/kernels/prefill_attn.py::prefill_attention
// (dispatched by repro/kernels/ops.py).  Shapes: lens (B,) int32; q (B, C,
// H, Dh); k, v (B, S, Hkv, Dh) page-assembled views with the chunk's own
// rows already spliced in  ->  out (B, C, H, Dh) in q's dtype.  Query c of
// slot b sits at absolute position qi = lens[b] + c and sees key ki iff
// ki <= qi (and ki > qi - window for a sliding window); query head h reads
// KV head h / (H / Hkv) (GQA).  logit = (q . k) / sqrt(Dh), soft-capped as
// cap * tanh(logit / cap) when a cap is given, before masking.  q and k/v
// are fp32/fp32, fp32/bf16 or bf16/bf16; every product and sum is fp32
// (TF32 on the tensor cores would miss the 2e-5 limit of the fp32 sweep).
//
// What bounds it on an H100: operations.  At the gateway's full-width step
// (B 8, C 64, H 32, Hkv 8, Dh 128, S 640) about 4 * Dh * H FLOPs per live
// query-key pair, 2.7 GFLOP over 21 MB in fp32: 0.040 ms at the fp32
// CUDA-core rate.  The first design ran at 7% of that: each logit
// cost two shared-memory loads per FMA (lane j did key j's whole dot
// product), K/V tiles of 32 keys were loaded with nothing overlapping the
// loads, and a CTA owned 32 query rows, so the 256 rows of a (slot, KV
// head) read the same K/V eight times.
//
// Design:
//  * One CTA of 256 threads owns (slot b, KV head g, 64 query rows), a row
//    being one (chunk position c, query head h of the group): the rep query
//    heads that share KV head g read each K/V tile once.  Its 64 rows of q
//    are widened to fp32 in shared memory once.
//  * K/V tiles of 64 keys (32 past head dim 128, to fit shared memory) come
//    through a two-stage cp.async ring, in their own dtype (bf16 widened
//    when read): the next tile is in flight while this one is used.  Views
//    whose rows are not 16-byte aligned are copied by plain loads instead.
//  * Register tiling: thread (ty, tx) of a 16 x 16 grid owns rows ty*4 + i
//    (i < 4) and keys tx + 16 j of the tile for S = q K^T (4 x 4 logits, fed
//    by float4 loads along Dh: 8 FMAs a load), then columns tx*4 + 64 c + e
//    of the output for O += P V (4 rows x up to 16 columns; a float4 of V
//    feeds 16 FMAs).  P goes through shared memory between the two.
//  * The online softmax of a row is held by the 16 threads of a half-warp
//    that share it: max and sum are reduced by xor-shuffles, which give
//    every lane the same bits.
//  * Masking discipline as in the reference: a masked logit is forced to the
//    finite floor NEG_INF = -2^30 before the tile max, so a row whose keys
//    are all masked so far keeps a finite running max, and its probability is
//    zeroed BY THE MASK (never by the floor), so a fully masked tile adds
//    exactly +0.0 (alpha = exp(0) = 1, p = 0).
//  * Tiles wholly past the CTA's last query position, or wholly before its
//    window, are skipped: their contribution is exactly zero.
//  * Deterministic: fixed summation order, no atomics; two runs give the
//    same bits.
//  * The Pallas body rounds bf16 q.k logits to bf16 before its fp32 cast;
//    this kernel does not copy that rounding.
//  * Launch on the caller's stream, allocate nothing, return
//    cudaGetLastError().

#include "ptc_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;                  // query rows per CTA
constexpr float kNegInf = -1073741824.0f;  // -2^30, the reference's floor
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 4 consecutive elements of a shared row, as floats
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);  // bf16 = high half
  return make_float4(__uint_as_float(w.x << 16),
                     __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xffff0000u));
}

// reductions over the 16 threads of a half-warp (the threads of a row)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o *= 2) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o *= 2) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}
// shared row strides (elements): rows 4 banks apart, 16-byte aligned
__host__ __device__ constexpr int q_stride(int dh) { return round_up(dh, 4) + 4; }
template <typename KT>
__host__ __device__ constexpr int kv_stride(int dh) {
  return sizeof(KT) == 4 ? round_up(dh, 4) + 4 : round_up(dh, 8) + 8;
}

template <typename QT, typename KT, int KEYS, int DC>
__global__ void __launch_bounds__(kThreads, 1)
prefill_kernel(const int* __restrict__ lens, const QT* __restrict__ q,
               const KT* __restrict__ k, const KT* __restrict__ v,
               QT* __restrict__ out, int C, int H, int Hkv, int Dh, int S,
               int window, float cap, float scale, int vec) {
  constexpr int KPT = KEYS / 16;       // keys of a thread in S
  constexpr int PS = KEYS + 4;         // P row stride
  extern __shared__ float4 smem4[];
  const int ldq = q_stride(Dh), ldk = kv_stride<KT>(Dh);
  float* qs = reinterpret_cast<float*>(smem4);                 // [64][ldq]
  KT* ks = reinterpret_cast<KT*>(qs + kRows * ldq);            // [2][KEYS][ldk]
  KT* vs = ks + 2 * KEYS * ldk;                                // [2][KEYS][ldk]
  float* ps = reinterpret_cast<float*>(vs + 2 * KEYS * ldk);   // [64][PS]

  const int rep = H / Hkv;
  const int b = blockIdx.z, g = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int n_rows = C * rep;          // rows of (b, g)
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int ln = lens[b];
  const int dhr = round_up(Dh, 4);

  for (int i = tid; i < kRows * dhr; i += kThreads) {
    const int r = row0 + i / dhr, d = i % dhr;
    float x = 0.f;
    if (r < n_rows && d < Dh) {
      const int c = r / rep, h = g * rep + r % rep;
      x = ptc::to_f32(q[(((long long)b * C + c) * H + h) * Dh + d]);
    }
    qs[(i / dhr) * ldq + d] = x;
  }

  // keys any row of this CTA can see
  const int last_row = min(n_rows, row0 + kRows) - 1;
  const int key_hi = min(ln + last_row / rep, S - 1);
  const int key_lo = window > 0 ? max(0, ln + row0 / rep - window + 1) : 0;
  const int t_begin = key_lo / KEYS;
  const int t_end = key_lo <= key_hi ? key_hi / KEYS + 1 : t_begin;

  const long long kv_row = (long long)Hkv * Dh;  // view row stride
  const KT* kb = k + (long long)b * S * kv_row + (long long)g * Dh;
  const KT* vb = v + (long long)b * S * kv_row + (long long)g * Dh;

  // tile t's keys into ring stage st (zero past the view's end)
  auto load_tile = [&](int st, int t) {
    KT* kd = ks + st * KEYS * ldk;
    KT* vd = vs + st * KEYS * ldk;
    if (vec) {
      constexpr int E = 16 / sizeof(KT);  // elements a copy
      const int per_row = Dh / E;
      for (int i = tid; i < KEYS * per_row; i += kThreads) {
        const int j = i / per_row, d = (i % per_row) * E;
        const int key = t * KEYS + j;
        const bool ok = key < S;
        const long long off = (long long)key * kv_row + d;
        ptc::cp_async16(kd + j * ldk + d, ok ? kb + off : kb, ok);
        ptc::cp_async16(vd + j * ldk + d, ok ? vb + off : vb, ok);
      }
    } else {
      for (int i = tid; i < KEYS * dhr; i += kThreads) {
        const int j = i / dhr, d = i % dhr;
        const int key = t * KEYS + j;
        const bool ok = key < S && d < Dh;
        const long long off = (long long)key * kv_row + d;
        kd[j * ldk + d] = ok ? kb[off] : KT(0.f);
        vd[j * ldk + d] = ok ? vb[off] : KT(0.f);
      }
    }
  };

  float acc[4][4 * DC], m[4], den[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    den[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * DC; ++e) acc[i][e] = 0.f;
  }

  if (t_begin < t_end) load_tile(0, t_begin);
  ptc::cp_async_commit();
  for (int t = t_begin; t < t_end; ++t) {
    const int st = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      load_tile(st ^ 1, t + 1);
      ptc::cp_async_commit();
      ptc::cp_async_wait<1>();
    } else {
      ptc::cp_async_wait<0>();
    }
    __syncthreads();  // tile t landed (and q is staged)

    // S = q K^T for the thread's 4 rows x KPT keys
    const KT* kt = ks + st * KEYS * ldk;
    float s[4][KPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dhr; d += 4) {
      float4 qa[4], ka[KPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = ld4(qs + (ty * 4 + i) * ldq + d);
#pragma unroll
      for (int j = 0; j < KPT; ++j) ka[j] = ld4(kt + (tx + 16 * j) * ldk + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          float a = s[i][j];
          a = fmaf(qa[i].x, ka[j].x, a);
          a = fmaf(qa[i].y, ka[j].y, a);
          a = fmaf(qa[i].z, ka[j].z, a);
          a = fmaf(qa[i].w, ka[j].w, a);
          s[i][j] = a;
        }
    }

    // the online softmax of each row over this tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = ln + (row0 + ty * 4 + i) / rep;
      float p[KPT];
      bool ok[KPT];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int kpos = t * KEYS + tx + 16 * j;
        float logit = s[i][j] * scale;
        if (cap > 0.f) logit = cap * tanhf(logit / cap);
        ok[j] = kpos <= qi && kpos < S && (window <= 0 || kpos > qi - window);
        p[j] = ok[j] ? logit : kNegInf;
        mx = fmaxf(mx, p[j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        p[j] = ok[j] ? expf(p[j] - m_new) : 0.f;
        sum += p[j];
        ps[(ty * 4 + i) * PS + tx + 16 * j] = p[j];
      }
      den[i] = den[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < 4 * DC; ++e) acc[i][e] *= alpha;
    }
    __syncthreads();  // P is whole

    // O += P V for the thread's 4 rows x its columns tx*4 + 64 c + e
    const KT* vt = vs + st * KEYS * ldk;
    for (int j0 = 0; j0 < KEYS; j0 += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pr[i] = *reinterpret_cast<const float4*>(ps + (ty * 4 + i) * PS + j0);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int d = tx * 4 + 64 * c;
          if (d >= dhr) continue;
          const float4 vv = ld4(vt + (j0 + jj) * ldk + d);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pv = jj == 0 ? pr[i].x : jj == 1 ? pr[i].y
                             : jj == 2 ? pr[i].z : pr[i].w;
            acc[i][4 * c] = fmaf(pv, vv.x, acc[i][4 * c]);
            acc[i][4 * c + 1] = fmaf(pv, vv.y, acc[i][4 * c + 1]);
            acc[i][4 * c + 2] = fmaf(pv, vv.z, acc[i][4 * c + 2]);
            acc[i][4 * c + 3] = fmaf(pv, vv.w, acc[i][4 * c + 3]);
          }
        }
      }
    }
    __syncthreads();  // stage st and P are free
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= n_rows) continue;
    const int c = r / rep, h = g * rep + r % rep;
    QT* o = out + (((long long)b * C + c) * H + h) * Dh;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = tx * 4 + 64 * cc + e;
        if (d < Dh) store(o + d, acc[i][4 * cc + e] / den[i]);
      }
  }
}

template <typename QT, typename KT, int KEYS, int DC>
cudaError_t launch(const int* lens, const void* q, const void* k,
                   const void* v, void* out, int B, int C, int H, int Hkv,
                   int Dh, int S, int window, float cap, float scale,
                   cudaStream_t st) {
  const size_t smem = sizeof(float) * kRows * q_stride(Dh) +
                      sizeof(KT) * 4 * KEYS * kv_stride<KT>(Dh) +
                      sizeof(float) * kRows * (KEYS + 4);
  auto kern = prefill_kernel<QT, KT, KEYS, DC>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int vec = (reinterpret_cast<uintptr_t>(k) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(v) % 16 == 0) &&
                  (Dh * sizeof(KT)) % 16 == 0;
  const dim3 grid((C * (H / Hkv) + kRows - 1) / kRows, Hkv, B);
  kern<<<grid, kThreads, smem, st>>>(
      lens, static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<QT*>(out), C, H, Hkv, Dh, S,
      window, cap, scale, vec);
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t by_width(const int* lens, const void* q, const void* k,
                     const void* v, void* out, int B, int C, int H, int Hkv,
                     int Dh, int S, int window, float cap, float scale,
                     cudaStream_t st) {
  if (Dh <= 64)
    return launch<QT, KT, 64, 1>(lens, q, k, v, out, B, C, H, Hkv, Dh, S,
                                 window, cap, scale, st);
  if (Dh <= 128)
    return launch<QT, KT, 64, 2>(lens, q, k, v, out, B, C, H, Hkv, Dh, S,
                                 window, cap, scale, st);
  if (Dh <= 256)
    return launch<QT, KT, 32, 4>(lens, q, k, v, out, B, C, H, Hkv, Dh, S,
                                 window, cap, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// q_bf16 / kv_bf16: 1 = bf16, 0 = fp32.  window <= 0: none; cap <= 0: none.
extern "C" int prefill_attention(const void* lens, const void* q,
                                 const void* k, const void* v, void* out,
                                 int B, int C, int H, int Hkv, int Dh, int S,
                                 int window, float cap, float scale,
                                 int q_bf16, int kv_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ln = static_cast<const int*>(lens);
  if (S < 1 || Dh < 1 || Hkv < 1 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (q_bf16 && kv_bf16)
    err = by_width<__nv_bfloat16, __nv_bfloat16>(ln, q, k, v, out, B, C, H,
                                                 Hkv, Dh, S, window, cap,
                                                 scale, st);
  else if (q_bf16)  // bf16 q over fp32 K/V: no caller (the pools are bf16)
    err = cudaErrorInvalidValue;
  else if (kv_bf16)
    err = by_width<float, __nv_bfloat16>(ln, q, k, v, out, B, C, H, Hkv, Dh,
                                         S, window, cap, scale, st);
  else
    err = by_width<float, float>(ln, q, k, v, out, B, C, H, Hkv, Dh, S,
                                 window, cap, scale, st);
  return static_cast<int>(err);
}
