// Chunked paged-prefill attention for the serving gateway, bf16 on the
// tensor cores (wgmma, TMA-fed K/V tiles).
//
// Replaces the TPU kernel repro/kernels/prefill_attn.py::prefill_attention
// (dispatched by repro/kernels/ops.py) for bf16 q over bf16 K/V views at
// head dims 64 and 128; every other (dtype, head dim) goes to the CUDA-core
// kernel in prefill_attn.cu.  Shapes: lens (B,) int32; q (B, C, H, Dh);
// k, v (B, S, Hkv, Dh) page-assembled views with the chunk's own rows
// already spliced in  ->  out (B, C, H, Dh) bf16.  Query c of slot b sits
// at absolute position qi = lens[b] + c and sees key ki iff ki <= qi (and
// ki > qi - window for a sliding window); query head h reads KV head
// h / (H / Hkv) (GQA).  logit = (q . k) / sqrt(Dh), soft-capped as
// cap * tanh(logit / cap) when a cap is given, before masking.
//
// What bounds it on an H100: at the gateway's full-width step (B 8, C 64,
// H 32, Hkv 8, Dh 128, S 640) 2.7 GFLOP of q.k and p.v products over about
// 20 MB of q, K/V and output: bytes, 0.006 ms at 3.35 TB/s, were every
// product on the tensor cores (989 TFLOP/s bf16).  The first kernel
// (prefill_attn.cu) kept them on the CUDA cores in fp32: a serial Dh-long
// q.k loop per lane out of shared memory, a p.v loop of T <= 32 keys with
// a shuffle per key, and K/V tiles converted to fp32 by synchronous loads,
// so no copy overlapped any product (97x the bound, 11x one
// scaled_dot_product_attention).
//
// Design:
//  * Work split: one CTA (one warpgroup, 128 threads) owns (slot b, KV
//    head g, 64 rows of the group's C * rep query rows), a row being one
//    (chunk position c, query head h of the group), so the rep query heads
//    of a group share every K/V tile.  Q is loaded once into shared memory
//    in the 128-byte-swizzled layout wgmma reads.
//  * S = Q K^T: wgmma m64n64k16, bf16 in and fp32 accumulate, A (Q) and B
//    (the 64-key K tile) both K-major in shared memory.  Scale, cap, the
//    mask to the finite floor NEG_INF = -2^30, and the online softmax run
//    in registers; each row's max is reduced across the four threads that
//    hold it.
//  * O += P V: P is rounded to bf16 in registers and fed to wgmma as the A
//    operand (its accumulator layout is the A fragment's); V is B,
//    MN-major, straight from the TMA tile.  The denominator sums the fp32
//    probabilities.
//  * K/V tiles arrive by TMA (a 4-D tensor map over (Dh, Hkv, S, B), 128-B
//    swizzle, keys at or past S zero-filled) into a two-stage ring, each
//    stage with an mbarrier: tile t + 1 is in flight while tile t's
//    products run.  cuTensorMapEncodeTiled comes from
//    cudaGetDriverEntryPoint(ByVersion), so the library links no libcuda.
//  * Masking discipline as in the reference: a masked logit takes the floor
//    before the tile max and its probability is zeroed BY THE MASK, so a
//    fully masked tile adds exactly +0.0.  Tiles wholly past the CTA's
//    last query or wholly before its window are skipped: changing no bit.
//    Key rows at or past S are masked, so S need not be a multiple of 64.
//  * Deterministic: fixed summation order, no atomics.  Launch on the
//    caller's stream, allocate nothing, return cudaGetLastError().

#include "hopper.cuh"

namespace {

using hopper::desc_sw128;
using hopper::encode_fn;
using hopper::EncodeTiled;
using hopper::fence_proxy_async;
using hopper::fence_regs;
using hopper::kEncodeError;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_init_fence;
using hopper::mbar_wait;
using hopper::pack_bf16;
using hopper::smem_u32;
using hopper::tma_load_4d;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_rs;
using hopper::wgmma_ss;
using hopper::wgmma_wait_all;

constexpr int kRows = 64;      // query rows per CTA: one wgmma M
constexpr int kKeys = 64;      // keys per K/V tile: the S product's N
constexpr int kStages = 2;     // K/V ring depth
constexpr int kThreads = 128;  // one warpgroup
constexpr float kNegInf = -1073741824.0f;  // -2^30, the reference's floor
constexpr int kHalfBytes = 64 * 128;       // 64 rows x 64 bf16 (128 B)

template <int HALVES>
struct Layout {  // byte offsets from a 1024-aligned base
  static constexpr int q = 0;
  static constexpr int tile = HALVES * kHalfBytes;   // one K or V tile
  static constexpr int stage = 2 * tile;             // K then V
  static constexpr int stages = tile;                // after Q
  static constexpr int bars = stages + kStages * stage;
  static constexpr int bytes = bars + 8 * kStages + 1024;  // + align slack
};

// K and V tile t_begin + it (keys from 64 * (t_begin + it), KV head g,
// slot b) into stage it % kStages; one thread issues it
template <int HALVES>
__device__ __forceinline__ void issue_tile(const CUtensorMap* kmap,
                                           const CUtensorMap* vmap,
                                           uint32_t sbase, int it,
                                           int t_begin, int g, int b) {
  using L = Layout<HALVES>;
  const int st = it % kStages;
  const uint32_t bar = sbase + L::bars + 8 * st;
  const uint32_t kdst = sbase + L::stages + st * L::stage;
  const uint32_t vdst = kdst + L::tile;
  mbar_expect_tx(bar, L::stage);
  const int key0 = (t_begin + it) * kKeys;
#pragma unroll
  for (int hh = 0; hh < HALVES; ++hh) {
    tma_load_4d(kdst + hh * kHalfBytes, kmap, bar, 64 * hh, g, key0, b);
    tma_load_4d(vdst + hh * kHalfBytes, vmap, bar, 64 * hh, g, key0, b);
  }
}

// HALVES = Dh / 64
template <int HALVES>
__global__ void __launch_bounds__(kThreads)
prefill_tc_kernel(__grid_constant__ const CUtensorMap kmap,
                  __grid_constant__ const CUtensorMap vmap,
                  const int* __restrict__ lens,
                  const __nv_bfloat16* __restrict__ q,
                  __nv_bfloat16* __restrict__ out, int C, int H, int Hkv,
                  int S, int window, float cap, float scale) {
  using L = Layout<HALVES>;
  constexpr int Dh = 64 * HALVES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  unsigned char* base = smem_raw + pad;   // generic, 1024-aligned
  const uint32_t sbase = raw + pad;       // shared-space address

  const int rep = H / Hkv;
  const int b = blockIdx.z, g = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int n_rows = C * rep;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ln = lens[b];

  // keys any row of this CTA can see, in tiles of kKeys
  const int last_row = min(n_rows, row0 + kRows) - 1;
  const int key_hi = min(ln + last_row / rep, S - 1);
  const int key_lo = window > 0 ? max(0, ln + row0 / rep - window + 1) : 0;
  const int t_begin = key_lo / kKeys;
  const int n_tiles = key_lo <= key_hi ? key_hi / kKeys + 1 - t_begin : 0;

  const uint32_t bar0 = sbase + L::bars;
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(bar0 + 8 * st, 1);
    mbar_init_fence();
    for (int it = 0; it < min(kStages, n_tiles); ++it)
      issue_tile<HALVES>(&kmap, &vmap, sbase, it, t_begin, g, b);
  }

  // Q rows into shared memory, 16 B at a time, 128-byte swizzled: row r's
  // 16-byte chunk c of half hh lands at hh*8K + r*128 + ((c ^ (r & 7))*16)
  for (int i = tid; i < kRows * Dh / 8; i += kThreads) {
    const int r = i / (Dh / 8), ci = i % (Dh / 8);
    const int hh = ci / 8, c16 = ci % 8;
    const int R = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (R < n_rows) {
      const int c = R / rep, h = g * rep + R % rep;
      val = *reinterpret_cast<const uint4*>(
          q + (((long long)b * C + c) * H + h) * Dh + ci * 8);
    }
    *reinterpret_cast<uint4*>(base + L::q + hh * kHalfBytes + r * 128 +
                              ((c16 ^ (r & 7)) << 4)) = val;
  }
  fence_proxy_async();
  __syncthreads();

  // this thread's two rows of the accumulator tiles, and their queries
  const int ra = warp * 16 + lane / 4;  // and ra + 8
  int qi[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int R = row0 + ra + 8 * e;
    qi[e] = R < n_rows ? ln + R / rep : -1;  // -1: padding, sees no key
  }
  float m[2] = {kNegInf, kNegInf}, den[2] = {0.f, 0.f};
  float o[HALVES][32];
#pragma unroll
  for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[hh][i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    mbar_wait(bar0 + 8 * st, (it / kStages) & 1);
    const uint32_t ks = sbase + L::stages + st * L::stage;
    const uint32_t vs = ks + L::tile;

    // S = Q K^T over Dh in steps of 16
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Dh / 16; ++kk) {
      const uint32_t off = (kk / 4) * kHalfBytes + (kk % 4) * 32;
      wgmma_ss<0, 0>(s, desc_sw128(sbase + L::q + off), desc_sw128(ks + off),
                     kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // scale, cap, mask; online softmax (rows ra: regs 4n, 4n+1; ra + 8:
    // regs 4n+2, 4n+3; key 8n + 2 * (lane % 4) + (i % 2) of the tile)
    const int key0 = (t_begin + it) * kKeys + 2 * (lane % 4);
    float tmax[2] = {kNegInf, kNegInf};
    uint32_t okbits = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int e = (i / 2) % 2;
      const int kp = key0 + 8 * (i / 4) + (i % 2);
      float logit = s[i] * scale;
      if (cap > 0.f) logit = cap * tanhf(logit / cap);
      const bool ok = kp <= qi[e] && kp < S &&
                      (window <= 0 || kp > qi[e] - window);
      okbits |= (uint32_t)ok << i;
      s[i] = ok ? logit : kNegInf;
      tmax[e] = fmaxf(tmax[e], s[i]);
    }
    float alpha[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      tmax[e] = fmaxf(tmax[e], __shfl_xor_sync(0xffffffffu, tmax[e], 1));
      tmax[e] = fmaxf(tmax[e], __shfl_xor_sync(0xffffffffu, tmax[e], 2));
      const float m_new = fmaxf(m[e], tmax[e]);
      alpha[e] = expf(m[e] - m_new);
      m[e] = m_new;
      den[e] *= alpha[e];
    }
    // probabilities zeroed by the mask, never by the floor; as bf16 they
    // are the A fragments of 4 k-steps of 16 keys
    uint32_t pa[4][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int e = (i / 2) % 2;
      const float p0 = (okbits >> i) & 1u ? expf(s[i] - m[e]) : 0.f;
      const float p1 = (okbits >> (i + 1)) & 1u ? expf(s[i + 1] - m[e]) : 0.f;
      den[e] += p0 + p1;
      pa[i / 8][(i % 8) / 2] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[hh][i] *= alpha[(i / 2) % 2];

    // O += P V over the tile's keys in steps of 16
#pragma unroll
    for (int hh = 0; hh < HALVES; ++hh) fence_regs(o[hh]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
      for (int hh = 0; hh < HALVES; ++hh)
        wgmma_rs(o[hh], pa[kk], desc_sw128(vs + hh * kHalfBytes + kk * 2048));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int hh = 0; hh < HALVES; ++hh) fence_regs(o[hh]);

    __syncthreads();  // every thread is done with this stage
    if (tid == 0 && it + kStages < n_tiles)
      issue_tile<HALVES>(&kmap, &vmap, sbase, it + kStages, t_begin, g, b);
  }

  // den: this thread's columns, summed over the row's four threads
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    den[e] += __shfl_xor_sync(0xffffffffu, den[e], 1);
    den[e] += __shfl_xor_sync(0xffffffffu, den[e], 2);
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int R = row0 + ra + 8 * e;
    if (R >= n_rows) continue;
    const int c = R / rep, h = g * rep + R % rep;
    __nv_bfloat16* orow = out + (((long long)b * C + c) * H + h) * Dh;
    const float inv = 1.f / den[e];
#pragma unroll
    for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = 64 * hh + 8 * n + 2 * (lane % 4);
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(o[hh][4 * n + 2 * e] * inv,
                                  o[hh][4 * n + 2 * e + 1] * inv);
      }
  }
}

// (B, S, Hkv, Dh) bf16 as a 4-D map (Dh, Hkv, S, B); box 64 x 1 x 64 x 1
int kv_map(CUtensorMap* map, const void* ptr, int B, int S, int Hkv, int Dh) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return kEncodeError;
  const cuuint64_t dims[4] = {(cuuint64_t)Dh, (cuuint64_t)Hkv, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)Dh * 2,
                                 (cuuint64_t)Hkv * Dh * 2,
                                 (cuuint64_t)S * Hkv * Dh * 2};
  const cuuint32_t box[4] = {64, 1, kKeys, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                          const_cast<void*>(ptr), dims, strides, box, estr,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeError + (int)res;
}

template <int HALVES>
int launch(const int* lens, const void* q, const void* k, const void* v,
           void* out, int B, int C, int H, int Hkv, int S, int window,
           float cap, float scale, cudaStream_t st) {
  constexpr int Dh = 64 * HALVES;
  CUtensorMap kmap, vmap;
  int err = kv_map(&kmap, k, B, S, Hkv, Dh);
  if (err == 0) err = kv_map(&vmap, v, B, S, Hkv, Dh);
  if (err != 0) return err;
  auto kern = prefill_tc_kernel<HALVES>;
  constexpr int smem = Layout<HALVES>::bytes;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid((C * (H / Hkv) + kRows - 1) / kRows, Hkv, B);
  kern<<<grid, kThreads, smem, st>>>(
      kmap, vmap, lens, static_cast<const __nv_bfloat16*>(q),
      static_cast<__nv_bfloat16*>(out), C, H, Hkv, S, window, cap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int status) {
  if (status >= kEncodeError)
    return "cuTensorMapEncodeTiled failed or is missing from the driver";
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// bf16 q, k, v, out; Dh 64 or 128; window <= 0: none; cap <= 0: none.
// q, k, v 16-byte aligned (the tensor maps need it).
extern "C" int prefill_attention_tc(const void* lens, const void* q,
                                    const void* k, const void* v, void* out,
                                    int B, int C, int H, int Hkv, int Dh,
                                    int S, int window, float cap, float scale,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ln = static_cast<const int*>(lens);
  if (Hkv < 1 || H % Hkv != 0 || S < 1 || B > 65535 || Hkv > 65535 ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) & 15u))
    return static_cast<int>(cudaErrorInvalidValue);
  if (Dh == 64)
    return launch<1>(ln, q, k, v, out, B, C, H, Hkv, S, window, cap, scale, st);
  if (Dh == 128)
    return launch<2>(ln, q, k, v, out, B, C, H, Hkv, S, window, cap, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
