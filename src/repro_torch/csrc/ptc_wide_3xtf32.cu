// The blocked PTC forward, Sigma-gradient and error feedback at k = 64 and
// 128 with fp32 operands, on the tensor cores in 3xTF32 (the "wide_3xtf32"
// route).
//
// Replaces, for fp32 operands at k = 64 and 128 (k = 128 in every LM
// config), the TPU kernels
//   repro/kernels/ptc_block_matmul.py::ptc_block_matmul  y_p  = sum_q U_pq (s_pq * V*_pq x_q)
//   repro/kernels/sigma_grad.py::sigma_grad              ds_pq = sum_t col_t (U_pq^T dy_p) * (V*_pq x_q)
//   repro/kernels/feedback_matmul.py::feedback_matmul    dx_q = sum_p mask[q,p] V*_pq^T (s_pq * U_pq^T dy_p)
// (dispatched by repro/kernels/ops.py).  Shapes: x (T, Q*k), dy (T, P*k),
// u and v (P, Q, k, k) with v holding V*, s (P, Q, k), all fp32; col (T,)
// fp32 or none; mask (Q, P) fp32, already scaled; y (T, P*k) fp32, ds
// (P, Q, k) fp32, dx (T, Q*k) fp32.  bf16 operands take the bf16
// tensor-core route (ptc_wide_tc.cu), other k the CUDA cores
// (ptc_wide.cu).
//
// 3xTF32: every fp32 operand a is split into tf32 hi = rna(a) and lo =
// rna(a - hi) (round to nearest, ties away from zero, as cvt.rna.tf32.f32;
// done by integer operations on the bits, so the low 13 bits are zero by
// construction and the tensor cores, which ignore them, see exact values),
// and a product a b is taken as lo_a hi_b + hi_a lo_b + hi_a hi_b, the
// small terms first, summed into one fp32 accumulator (lo lo dropped).
// hi + lo holds a to about 2^-22; one tf32 pass would miss the port's
// fp32 limit (about 3e-4 of the largest entry at K = 2048, against 4e-7).
//
// What bounds it on an H100: operations, three tf32 passes at 495 TFLOP/s
// (an effective 165 TFLOP/s).  At olmo-1b's up projection (2048 -> 8192,
// k = 128, T = 4096) the forward is 137.4 GFLOP of product and 4.3 of
// composing, 0.86 ms at 3 passes against 2.1 ms at the fp32 CUDA-core
// peak; the Sigma-gradient is the same product (G = dy^T x) and a 4.3
// GFLOP projection; the feedback is the product over the kept blocks
// alone (about 614 of 1,024 under btopk at alpha_W = 0.6: about 85 GFLOP,
// 0.51 ms).  Their bytes (x and W's planes, or dy's and x's, written and
// read once more) take about 0.1-0.15 ms.
//
// Design (fixed order of sums, no atomics: two runs give the same bits):
//  * x3_compose_kernel: W_pq = (U_pq diag(s_pq)) V*_pq composed once per
//    block, a 64 x 64 tile a warpgroup, on 3xTF32 wgmma (m64n64k8; a
//    partial sum a 32-column chunk, added in fp32 as below): U s
//    formed in fp32 and split, K-major as stored; V* transposed while it
//    is split (tf32 has no transpose bit).  W is written as its tf32 hi
//    and lo planes (2, P*k, Q*k), so the product never splits its B.
//  * x3_split_kernel (forward): x split once into its planes (2, T, Q*k).
//  * x3_tsplit_kernel (Sigma-gradient): col * dy (formed in fp32) and x
//    split and transposed into T-contiguous planes (2, P*k, Tp) and
//    (2, Q*k, Tp), Tp = T rounded up to 32 and zero-padded: the reduction
//    runs over T, the slow axis of both, and a wgmma operand in shared
//    memory must be K-major.  A column scale costs no extra product.
//  * x3_product_kernel: C = A B^T over K-major planes, both operands' hi and
//    lo arriving by TMA (128-byte swizzle, 32 fp32 columns a stage, rows past
//    the edges zero-filled) into a ring of 3 stages of 64 KB (A hi, A lo, B
//    hi, B lo at 16 KB each for a 128 x 128 output tile: 192 KB of the 227
//    KB).  Splitting A in registers instead would take 48 KB a stage (4
//    stages), but every CTA along a row of tiles would split the same A again
//    and feed wgmma's register fragments by hand; the planes cost one pass
//    over x (or dy).  One producer thread keeps the ring full; two consumer
//    warpgroups each own 64 rows x 128 columns and issue three wgmma
//    m64n128k8 per k8 step into a partial sum of the stage, which the
//    consumer adds to its fp32 accumulators on the CUDA cores, rounded to
//    nearest: the tensor cores' own fp32 accumulation is not, and summed
//    there over all of K its error grows with K, past the 1e-5 limit at
//    the up projection; one warpgroup's additions overlap the other's
//    products.  The forward stores y (masking T's ragged edge).
//    The Sigma-gradient reduces G over all T and projects it in the epilogue
//    on the CUDA cores in fp32: the tile (one block at k = 128, 2 x 2 blocks
//    at k = 64) goes to shared memory with the tile's U blocks, H = U^T G is
//    a register-tiled product (8 x 8 a thread), and ds[i] = sum_b H[i, b]
//    V*[i, b] is reduced over the 16 threads that share a row.  G never
//    reaches device memory.
//  * The feedback, dx = dy W~ with W~_pq = mask[q, p] W_pq:
//    - x3_fcompose_kernel: the compose above with its operands swapped,
//      so each kept block is composed once and transposed, Wt_qp =
//      (mask[q, p] U_pq diag(s_pq) V*_pq)^T, into Wt's planes (2, Q*k,
//      P*k): A = V*^T, transposed while it is split; B = U diag(s) mask,
//      both products formed in fp32 and then split, K-major as stored.
//      A masked block's CTAs return at once, but at k = 64, where a
//      product tile holds two q blocks, they write zeros where the tile's
//      other q block keeps the p block (the product reads them there).
//    - x3_fsplit_kernel: dy split once into its planes (2, T, P*k); the
//      reduction runs over P*k, dy's contiguous axis: no transpose.
//    - x3_feedback_kernel: the product above on (dy, Wt), over the live
//      32-column stages only: a stage (32 columns of one p block) is live
//      where the mask keeps that p block for a q block of the tile's 128
//      columns (one q block at k = 128, so the skip keeps the mask's whole
//      saving; two at k = 64).  The producer walks the tile's mask row(s)
//      and loads the live stages; the consumers derive the same count,
//      so no branch sits among the wgmmas.  A tile with no live stage
//      stores exact zeros.
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() (or kEncodeError + the driver's code when a tensor
// map cannot be made).

#include "hopper.cuh"

namespace {

using hopper::desc_sw128;
using hopper::fence_proxy_async;
using hopper::fence_regs;
using hopper::kEncodeError;
using hopper::map_2d;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_init_fence;
using hopper::mbar_wait;
using hopper::named_sync;
using hopper::smem_u32;
using hopper::tma_load_2d;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_tf32_n128;
using hopper::wgmma_tf32_n64;
using hopper::wgmma_wait;

constexpr int kBM = 128, kBN = 128;   // a CTA's output tile
constexpr int kBK = 32;               // reduction columns a stage: 128 B
constexpr int kThreads = 384;         // a producer and two consumer warpgroups
constexpr int kConsumerWarps = 8;     // arrivals that empty a stage
constexpr int kStages = 3;
constexpr int kPlane = kBM * kBK * 4;  // 128 rows of 32 fp32: 16 KB

struct Layout {  // byte offsets from the aligned base
  static constexpr int stage = 4 * kPlane;  // A hi, A lo, B hi, B lo
  static constexpr int bars = kStages * stage;
  static constexpr int bytes = bars + 16 * kStages + 1024;
};

// the 1024-aligned base of dynamic shared memory (128-byte swizzle)
__device__ __forceinline__ uint32_t aligned_base(unsigned char* raw,
                                                 unsigned char** generic) {
  const uint32_t r = smem_u32(raw);
  const uint32_t pad = ((r + 1023u) & ~1023u) - r;
  *generic = raw + pad;
  return r + pad;
}

// round to tf32's grid, to nearest with ties away from zero
__device__ __forceinline__ float tf32_rna(float a) {
  return __uint_as_float((__float_as_uint(a) + 0x1000u) & 0xFFFFE000u);
}

__device__ __forceinline__ void split(float a, float& hi, float& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(__fsub_rn(a, hi));
}

__device__ __forceinline__ void split4(float4 a, float4& hi, float4& lo) {
  split(a.x, hi.x, lo.x);
  split(a.y, hi.y, lo.y);
  split(a.z, hi.z, lo.z);
  split(a.w, hi.w, lo.w);
}

// byte offset of element c (0..31) of row r in a 128-byte-swizzled tile
// of 32-fp32 rows: 16-byte chunk c / 4 stored at chunk (c / 4) ^ (r & 7)
__device__ __forceinline__ int sw_off(int r, int c) {
  return r * 128 + (((c >> 2) ^ (r & 7)) << 4) + (c & 3) * 4;
}

// part = (part +) lo_a hi_b + hi_a lo_b + hi_a hi_b over one k8 step;
// first: overwrite part instead of adding to it
template <int N>
__device__ __forceinline__ void mma3(float (&part)[N / 2], uint32_t ahi,
                                     uint32_t alo, uint32_t bhi,
                                     uint32_t blo, bool first) {
  if constexpr (N == 64) {
    wgmma_tf32_n64(part, desc_sw128(alo), desc_sw128(bhi), !first);
    wgmma_tf32_n64(part, desc_sw128(ahi), desc_sw128(blo), 1);
    wgmma_tf32_n64(part, desc_sw128(ahi), desc_sw128(bhi), 1);
  } else {
    wgmma_tf32_n128(part, desc_sw128(alo), desc_sw128(bhi), !first);
    wgmma_tf32_n128(part, desc_sw128(ahi), desc_sw128(blo), 1);
    wgmma_tf32_n128(part, desc_sw128(ahi), desc_sw128(bhi), 1);
  }
}

// acc += part, rounded to nearest on the CUDA cores
template <int R>
__device__ __forceinline__ void add_part(float (&acc)[R],
                                         const float (&part)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
}

// --- pre-passes ---------------------------------------------------------

// hi, lo = split(a), n4 float4 each
__device__ __forceinline__ void split_body(const float4* __restrict__ a,
                                           float4* __restrict__ hi,
                                           float4* __restrict__ lo,
                                           long long n4) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n4;
       i += (long long)gridDim.x * 256) {
    float4 h, l;
    split4(a[i], h, l);
    hi[i] = h;
    lo[i] = l;
  }
}

// the forward's x
__global__ void __launch_bounds__(256)
x3_split_kernel(const float4* __restrict__ a, float4* __restrict__ hi,
                float4* __restrict__ lo, long long n4) {
  split_body(a, hi, lo, n4);
}

// the feedback's dy (its own name, so a profile tells the two apart)
__global__ void __launch_bounds__(256)
x3_fsplit_kernel(const float4* __restrict__ a, float4* __restrict__ hi,
                 float4* __restrict__ lo, long long n4) {
  split_body(a, hi, lo, n4);
}

// hi[m, t], lo[m, t] = split(col[t] * in[t, m]) for t < T, zero for
// T <= t < Tp: a 32 x 32 tile (m0 = 32 blockIdx.x, t0 = 32 blockIdx.y)
// through shared memory; in (T, M) row-major, the planes (M, Tp)
__global__ void __launch_bounds__(256)
x3_tsplit_kernel(const float* __restrict__ in, const float* __restrict__ col,
                 float* __restrict__ hi, float* __restrict__ lo, int T,
                 int Tp, int M) {
  __shared__ float tile[32][33];
  const int m0 = blockIdx.x * 32, t0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
#pragma unroll
  for (int r = ty; r < 32; r += 8) {
    const int t = t0 + r;
    float val = 0.f;
    if (t < T) {
      val = in[(long long)t * M + m0 + tx];
      if (col != nullptr) val = __fmul_rn(val, col[t]);
    }
    tile[r][tx] = val;
  }
  __syncthreads();
#pragma unroll
  for (int r = ty; r < 32; r += 8) {
    const long long o = (long long)(m0 + r) * Tp + t0 + tx;
    float h, l;
    split(tile[tx][r], h, l);
    hi[o] = h;
    lo[o] = l;
  }
}

// --- compose -----------------------------------------------------------

// The forward (FEED false): W[p*KB + m0 + i, q*KB + n0 + j] = sum_a (U[i, a]
// s[a]) V*[a, j] for the CTA's 64 x 64 tile (m0, n0) of block p*Q + q,
// written as tf32 hi and lo planes of W (P*KB, Q*KB).  The feedback (FEED
// true): Wt[q*KB + m0 + j, p*KB + n0 + i] = sum_a V*[a, j] (U[i, a] s[a]
// m), m = mask[q, p], into Wt's planes (Q*KB, P*KB); a masked block's
// tile is not composed (KB = 64: zeros where the other q block of its
// product tile keeps p).  blockIdx.x = (p*Q + q) * (KB/64)^2 + tile.
template <int KB, bool FEED>
__device__ __forceinline__ void compose_body(const float* __restrict__ u,
                                             const float* __restrict__ s,
                                             const float* __restrict__ v,
                                             const float* __restrict__ mask,
                                             float* __restrict__ whi,
                                             float* __restrict__ wlo, int P,
                                             int Q) {
  constexpr int nt = KB / 64;
  constexpr int kT = 64 * 128;  // 64 rows of 32 fp32: 8 KB
  const long long blk = blockIdx.x / (nt * nt);
  const int tile = blockIdx.x % (nt * nt);
  const int p = (int)(blk / Q), q = (int)(blk % Q);
  float m = 1.f;
  bool live = true;
  if constexpr (FEED) {
    m = mask[(long long)q * P + p];
    live = m != 0.f;
    // at KB = 64 the product's tile of 128 columns holds q blocks q and
    // q ^ 1: it reads this block where the other one keeps p
    if (!live && (KB == 128 || (q ^ 1) >= Q ||
                  mask[(long long)(q ^ 1) * P + p] == 0.f))
      return;
  }
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base;
  const uint32_t sbase = aligned_base(smem_raw, &base);
  const int m0 = (tile / nt) * 64, n0 = (tile % nt) * 64;
  const float* ub = u + blk * KB * KB;
  const float* sb = s + blk * KB;
  const float* vb = v + blk * KB * KB;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // U diag(s) (m) is the forward's A and the feedback's B; V*^T the other
  const int us_off = FEED ? 2 * kT : 0, vt_off = FEED ? 0 : 2 * kT;
  const int us_row0 = FEED ? n0 : m0, vt_row0 = FEED ? m0 : n0;

  float acc[32], part[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int a0 = 0; a0 < KB && live; a0 += kBK) {
    // U diag(s) (m): row r is U's row us_row0 + r, K-major as stored; each
    // product formed in fp32 before the split
    for (int e = tid; e < 64 * 8; e += 128) {
      const int r = e / 8, c = e % 8;
      const float4 uv = *reinterpret_cast<const float4*>(
          ub + (us_row0 + r) * KB + a0 + 4 * c);
      const float4 sv = *reinterpret_cast<const float4*>(sb + a0 + 4 * c);
      float4 w = make_float4(__fmul_rn(uv.x, sv.x), __fmul_rn(uv.y, sv.y),
                             __fmul_rn(uv.z, sv.z), __fmul_rn(uv.w, sv.w));
      if constexpr (FEED)
        w = make_float4(__fmul_rn(w.x, m), __fmul_rn(w.y, m),
                        __fmul_rn(w.z, m), __fmul_rn(w.w, m));
      float4 h, l;
      split4(w, h, l);
      const int off = r * 128 + ((c ^ (r & 7)) << 4);
      *reinterpret_cast<float4*>(base + us_off + off) = h;
      *reinterpret_cast<float4*>(base + us_off + kT + off) = l;
    }
    // V*^T: row j holds V*[a0 .. a0 + 31, vt_row0 + j]
    for (int e = tid; e < kBK * 16; e += 128) {
      const int a = e / 16, j4 = 4 * (e % 16);
      const float4 vv = *reinterpret_cast<const float4*>(
          vb + (a0 + a) * KB + vt_row0 + j4);
      const float vals[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float h, l;
        split(vals[jj], h, l);
        const int off = sw_off(j4 + jj, a);
        *reinterpret_cast<float*>(base + vt_off + off) = h;
        *reinterpret_cast<float*>(base + vt_off + kT + off) = l;
      }
    }
    fence_proxy_async();
    __syncthreads();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk)
      mma3<64>(part, sbase + 32 * kk, sbase + kT + 32 * kk,
               sbase + 2 * kT + 32 * kk, sbase + 3 * kT + 32 * kk, kk == 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
    add_part(acc, part);
    __syncthreads();  // before the next chunk overwrites the tiles
  }

  // rows m0 + 16 warp + lane / 4 (+ 8) of the block's tile, columns n0 +
  // 8 j + 2 (lane % 4): of W's block (p, q), or of Wt's block (q, p)
  const long long ldw = (long long)(FEED ? P : Q) * KB;
  const long long row0 = (long long)(FEED ? q : p) * KB;
  const long long col0 = (long long)(FEED ? p : q) * KB;
  const int r = m0 + 16 * warp + lane / 4, c2 = n0 + 2 * (lane % 4);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const long long row = row0 + r + 8 * e;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long at = row * ldw + col0 + c2 + 8 * j;
      float2 h, l;
      split(acc[4 * j + 2 * e], h.x, l.x);
      split(acc[4 * j + 2 * e + 1], h.y, l.y);
      *reinterpret_cast<float2*>(whi + at) = h;
      *reinterpret_cast<float2*>(wlo + at) = l;
    }
  }
}

template <int KB>
__global__ void __launch_bounds__(128)
x3_compose_kernel(const float* __restrict__ u, const float* __restrict__ s,
                  const float* __restrict__ v, float* __restrict__ whi,
                  float* __restrict__ wlo, int P, int Q) {
  compose_body<KB, false>(u, s, v, nullptr, whi, wlo, P, Q);
}

template <int KB>
__global__ void __launch_bounds__(128)
x3_fcompose_kernel(const float* __restrict__ u, const float* __restrict__ s,
                   const float* __restrict__ v,
                   const float* __restrict__ mask, float* __restrict__ whi,
                   float* __restrict__ wlo, int P, int Q) {
  compose_body<KB, true>(u, s, v, mask, whi, wlo, P, Q);
}

// --- the product C = A B^T over K-major planes ----------------------------

constexpr int kLdG = kBN + 4;  // the epilogue's G and U rows (floats)
constexpr int kLdU64 = 64 + 4;

// ds of the blocks under G tile (tm, tn) = (blockIdx.y, blockIdx.x), G in
// shared memory (128 x kLdG); the 256 consumer threads (ct) each own an
// 8 x 8 tile of H = U^T G: rows (ii < 4 ? 0 : 64) + 4 ty + (ii & 3),
// columns likewise by tx
template <int KB>
__device__ __forceinline__ void project(float* gs, float* us,
                                        const float* __restrict__ u,
                                        const float* __restrict__ v,
                                        float* __restrict__ ds, int P, int Q,
                                        int ct) {
  const int tm = blockIdx.y, tn = blockIdx.x;
  // the tile's U blocks: at k = 128 block (tm, tn) as us[a][i]; at k = 64
  // the blocks (2 tm + pi, 2 tn + qi) as us[2 pi + qi][a][i] (past P or
  // Q: clamped, and their ds not written)
  if constexpr (KB == 128) {
    const float* ub = u + ((long long)tm * Q + tn) * KB * KB;
    for (int e = ct; e < KB * 32; e += 256) {
      const int a = e / 32, i4 = 4 * (e % 32);
      *reinterpret_cast<float4*>(us + a * kLdG + i4) =
          *reinterpret_cast<const float4*>(ub + a * KB + i4);
    }
  } else {
    for (int e = ct; e < 4 * 64 * 16; e += 256) {
      const int w = e / 1024, a = (e / 16) % 64, i4 = 4 * (e % 16);
      const long long blk = (long long)min(2 * tm + w / 2, P - 1) * Q +
                            min(2 * tn + w % 2, Q - 1);
      *reinterpret_cast<float4*>(us + (w * 64 + a) * kLdU64 + i4) =
          *reinterpret_cast<const float4*>(u + blk * 64 * 64 + a * 64 + i4);
    }
  }
  named_sync(1, 2 * 128);

  const int ty = ct / 16, tx = ct % 16;
  float h[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) h[i][j] = 0.f;
  if constexpr (KB == 128) {
#pragma unroll 4
    for (int a = 0; a < KB; ++a) {
      const float4 u0 = *reinterpret_cast<const float4*>(us + a * kLdG + 4 * ty);
      const float4 u1 =
          *reinterpret_cast<const float4*>(us + a * kLdG + 64 + 4 * ty);
      const float4 g0 = *reinterpret_cast<const float4*>(gs + a * kLdG + 4 * tx);
      const float4 g1 =
          *reinterpret_cast<const float4*>(gs + a * kLdG + 64 + 4 * tx);
      const float uu[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
      const float gg[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) h[i][j] = fmaf(uu[i], gg[j], h[i][j]);
    }
    // ds[i] = sum_b H[i, b] V*[i, b]: this thread's 8 columns, then the 16
    // threads that share the row
    const long long blk = (long long)tm * Q + tn;
    const float* vb = v + blk * KB * KB;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = (i < 4 ? 0 : 64) + 4 * ty + (i & 3);
      const float4 v0 = *reinterpret_cast<const float4*>(vb + row * KB + 4 * tx);
      const float4 v1 =
          *reinterpret_cast<const float4*>(vb + row * KB + 64 + 4 * tx);
      const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) sum = fmaf(h[i][j], vv[j], sum);
#pragma unroll
      for (int o = 1; o < 16; o *= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (tx == 0) ds[blk * KB + row] = sum;
    }
  } else {
    // H's quarter (pi, qi) = U_(pi, qi)^T G[64 pi .., 64 qi ..]: a runs
    // over the block's 64 rows of G
#pragma unroll 2
    for (int a = 0; a < 64; ++a) {
      float gg[2][8];
#pragma unroll
      for (int pi = 0; pi < 2; ++pi) {
        const float* gr = gs + (64 * pi + a) * kLdG;
        const float4 g0 = *reinterpret_cast<const float4*>(gr + 4 * tx);
        const float4 g1 = *reinterpret_cast<const float4*>(gr + 64 + 4 * tx);
        gg[pi][0] = g0.x, gg[pi][1] = g0.y, gg[pi][2] = g0.z, gg[pi][3] = g0.w;
        gg[pi][4] = g1.x, gg[pi][5] = g1.y, gg[pi][6] = g1.z, gg[pi][7] = g1.w;
      }
#pragma unroll
      for (int pi = 0; pi < 2; ++pi)
#pragma unroll
        for (int qi = 0; qi < 2; ++qi) {
          const float4 u4 = *reinterpret_cast<const float4*>(
              us + ((2 * pi + qi) * 64 + a) * kLdU64 + 4 * ty);
          const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              h[4 * pi + r][4 * qi + c] =
                  fmaf(uu[r], gg[pi][4 * qi + c], h[4 * pi + r][4 * qi + c]);
        }
    }
#pragma unroll
    for (int pi = 0; pi < 2; ++pi)
#pragma unroll
      for (int qi = 0; qi < 2; ++qi) {
        const int p = 2 * tm + pi, q = 2 * tn + qi;
        const bool live = p < P && q < Q;  // uniform across the CTA
        const long long blk = (long long)min(p, P - 1) * Q + min(q, Q - 1);
        const float* vb = v + blk * 64 * 64;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = 4 * ty + r;
          const float4 v4 =
              *reinterpret_cast<const float4*>(vb + row * 64 + 4 * tx);
          const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
          float sum = 0.f;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            sum = fmaf(h[4 * pi + r][4 * qi + c], vv[c], sum);
#pragma unroll
          for (int o = 1; o < 16; o *= 2)
            sum += __shfl_xor_sync(0xffffffffu, sum, o);
          if (live && tx == 0) ds[blk * 64 + row] = sum;
        }
      }
  }
}

// whether the feedback tile of 128 columns from q block q0 keeps p block
// pb: q0 alone at FKB = 128, q0 or q0 + 1 (where it exists) at FKB = 64
template <int FKB>
__device__ __forceinline__ bool fb_live(const float* __restrict__ mask,
                                        int P, int Q, int q0, int pb) {
  bool live = __ldg(mask + (long long)q0 * P + pb) != 0.f;
  if constexpr (FKB == 64)
    live = live || (q0 + 1 < Q &&
                    __ldg(mask + (long long)(q0 + 1) * P + pb) != 0.f);
  return live;
}

// C tile (blockIdx.y, blockIdx.x): rows 128 y .. of A's M, columns 128 x
// .. of B's N, over K columns (a multiple of kBK).  KB = 0, FKB = 0: the
// forward, C stored to out (M, N) with rows >= M and columns >= N masked;
// KB = 64 or 128: the Sigma-gradient, C = G projected to out = ds (P, Q,
// KB); FKB = 64 or 128: the feedback, C = dx stored as the forward's, K =
// P*FKB walked over the live stages only (mask (Q, P)).
template <int KB, int FKB>
__device__ __forceinline__ void product_body(
    const CUtensorMap* ahi, const CUtensorMap* alo, const CUtensorMap* bhi,
    const CUtensorMap* blo, float* __restrict__ out, int M, int N, int K,
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ mask, int P, int Q) {
  using L = Layout;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base;
  const uint32_t sbase = aligned_base(smem_raw, &base);
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  auto full = [&](int st) { return sbase + L::bars + 8 * st; };
  auto empty = [&](int st) { return sbase + L::bars + 8 * (kStages + st); };
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();
  // the feedback: the tile's first q block, and stages a p block
  constexpr int per_p = FKB / kBK;
  const int q0 = n0 / (FKB == 0 ? kBN : FKB);

  if (wg == 0) {  // producer: one thread issues every load
    if (tid == 0) {
      auto load = [&](int vs, int k0) {  // stage vs from column k0
        const int st = vs % kStages;
        if (vs >= kStages) mbar_wait(empty(st), (vs / kStages - 1) & 1);
        const uint32_t dst = sbase + st * L::stage;
        mbar_expect_tx(full(st), L::stage);
        tma_load_2d(dst, ahi, full(st), k0, m0);
        tma_load_2d(dst + kPlane, alo, full(st), k0, m0);
        tma_load_2d(dst + 2 * kPlane, bhi, full(st), k0, n0);
        tma_load_2d(dst + 3 * kPlane, blo, full(st), k0, n0);
      };
      if constexpr (FKB == 0) {
        for (int kt = 0; kt < K / kBK; ++kt) load(kt, kt * kBK);
      } else {
        int vs = 0;
        for (int pb = 0; pb < P; ++pb) {
          if (!fb_live<FKB>(mask, P, Q, q0, pb)) continue;
          for (int h = 0; h < per_p; ++h, ++vs) load(vs, pb * FKB + h * kBK);
        }
      }
    }
    return;
  }

  // the stages the producer sends
  int nk = K / kBK;
  if constexpr (FKB != 0) {
    nk = 0;
    for (int pb = 0; pb < P; ++pb) nk += fb_live<FKB>(mask, P, Q, q0, pb);
    nk *= per_p;
  }
  // each stage's products go to a fresh partial sum, added to acc on the
  // CUDA cores (rounded to nearest): the tensor cores' own fp32
  // accumulation is not rounded to nearest, and over all of K (3 K / 8
  // accumulations) its error grows past 1e-5 of the largest entry
  const int c = wg - 1;  // this warpgroup's 64 rows of the tile
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % kStages;
    mbar_wait(full(st), (kt / kStages) & 1);
    const uint32_t a = sbase + st * L::stage + c * (kPlane / 2);
    const uint32_t b = sbase + st * L::stage + 2 * kPlane;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk)
      mma3<128>(part, a + 32 * kk, a + kPlane + 32 * kk, b + 32 * kk,
                b + kPlane + 32 * kk, kk == 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
    if (lane == 0) mbar_arrive(empty(st));  // this stage is read: free it
    add_part(acc, part);
  }

  // this thread's accumulators: rows 64 c + 16 warp + lane / 4 (+ 8),
  // columns 8 j + 2 (lane % 4) (+ 1) of the tile
  const int c2 = 2 * (lane % 4);
  if constexpr (KB == 0) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = m0 + 64 * c + 16 * warp + lane / 4 + 8 * e;
      if (row >= M) continue;
      float* yr = out + (long long)row * N + n0 + c2;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
        if (n0 + 8 * j < N)
          *reinterpret_cast<float2*>(yr + 8 * j) =
              make_float2(acc[4 * j + 2 * e], acc[4 * j + 2 * e + 1]);
    }
  } else {
    // every consumer is done with the ring: G and the U blocks take its
    // place
    named_sync(1, 2 * 128);
    float* gs = reinterpret_cast<float*>(base);
    float* us = gs + kBM * kLdG;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = 64 * c + 16 * warp + lane / 4 + 8 * e;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
        *reinterpret_cast<float2*>(gs + row * kLdG + 8 * j + c2) =
            make_float2(acc[4 * j + 2 * e], acc[4 * j + 2 * e + 1]);
    }
    project<KB>(gs, us, u, v, out, P, Q, threadIdx.x - 128);
  }
}

// the forward (KB = 0) and the Sigma-gradient (KB = 64, 128)
template <int KB>
__global__ void __launch_bounds__(kThreads, 1)
x3_product_kernel(__grid_constant__ const CUtensorMap ahi,
                  __grid_constant__ const CUtensorMap alo,
                  __grid_constant__ const CUtensorMap bhi,
                  __grid_constant__ const CUtensorMap blo,
                  float* __restrict__ out, int M, int N, int K,
                  const float* __restrict__ u, const float* __restrict__ v,
                  int P, int Q) {
  product_body<KB, 0>(&ahi, &alo, &bhi, &blo, out, M, N, K, u, v, nullptr,
                      P, Q);
}

// the feedback, blocks of FKB = 64 or 128
template <int FKB>
__global__ void __launch_bounds__(kThreads, 1)
x3_feedback_kernel(__grid_constant__ const CUtensorMap ahi,
                   __grid_constant__ const CUtensorMap alo,
                   __grid_constant__ const CUtensorMap bhi,
                   __grid_constant__ const CUtensorMap blo,
                   float* __restrict__ out, int M, int N, int K,
                   const float* __restrict__ mask, int P, int Q) {
  product_body<0, FKB>(&ahi, &alo, &bhi, &blo, out, M, N, K, nullptr,
                       nullptr, mask, P, Q);
}

// --- host side ----------------------------------------------------------

template <typename Kern>
cudaError_t allow_smem(Kern kern, int bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) *done = true;
  return e;
}

// the four planes' tensor maps and the product's launch: the forward or
// the Sigma-gradient (FKB = 0; u, v for the projection), or the feedback
// (FKB = 64, 128; mask)
template <int KB, int FKB = 0>
int product(const float* ahi, const float* alo, long long am,
            const float* bhi, const float* blo, long long bn, long long K,
            float* out, int M, int N, const float* u, const float* v,
            const float* mask, int P, int Q, cudaStream_t st) {
  CUtensorMap mah, mal, mbh, mbl;
  int rc = map_2d(&mah, ahi, am, K, kBM, kBK, true);
  if (rc == 0) rc = map_2d(&mal, alo, am, K, kBM, kBK, true);
  if (rc == 0) rc = map_2d(&mbh, bhi, bn, K, kBN, kBK, true);
  if (rc == 0) rc = map_2d(&mbl, blo, bn, K, kBN, kBK, true);
  if (rc != 0) return rc;
  const dim3 grid((unsigned)((bn + kBN - 1) / kBN),
                  (unsigned)((am + kBM - 1) / kBM));
  static bool smem_set = false;
  if constexpr (FKB == 0) {
    auto kern = x3_product_kernel<KB>;
    const cudaError_t err = allow_smem(kern, Layout::bytes, &smem_set);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<grid, kThreads, Layout::bytes, st>>>(mah, mal, mbh, mbl, out, M,
                                                N, (int)K, u, v, P, Q);
  } else {
    auto kern = x3_feedback_kernel<FKB>;
    const cudaError_t err = allow_smem(kern, Layout::bytes, &smem_set);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<grid, kThreads, Layout::bytes, st>>>(mah, mal, mbh, mbl, out, M,
                                                N, (int)K, mask, P, Q);
  }
  return static_cast<int>(cudaGetLastError());
}

// hi, lo = split(a) over n fp32 (a multiple of 4)
template <typename Kern>
cudaError_t split_launch(Kern kern, const float* a, float* hi, float* lo,
                         long long n, cudaStream_t st) {
  const long long n4 = n / 4, blocks = (n4 + 255) / 256;
  kern<<<(unsigned)(blocks < 2048 ? blocks : 2048), 256, 0, st>>>(
      reinterpret_cast<const float4*>(a), reinterpret_cast<float4*>(hi),
      reinterpret_cast<float4*>(lo), n4);
  return cudaGetLastError();
}

constexpr int kComposeSmem = 4 * 64 * 128 + 1024;

template <int KB>
int forward(const float* x, const float* u, const float* s, const float* v,
            float* xs, float* w, float* y, int T, int P, int Q,
            cudaStream_t st) {
  constexpr int nt = KB / 64;
  const long long N = (long long)P * KB, K = (long long)Q * KB;
  const long long nx = (long long)T * K;
  cudaError_t err = split_launch(x3_split_kernel, x, xs, xs + nx, nx, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  x3_compose_kernel<KB><<<(unsigned)((long long)P * Q * nt * nt), 128,
                          kComposeSmem, st>>>(u, s, v, w, w + N * K, P, Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return product<0>(xs, xs + nx, T, w, w + N * K, N, K, y, T, (int)N,
                    nullptr, nullptr, nullptr, P, Q, st);
}

template <int KB>
int sigma(const float* dy, const float* x, const float* u, const float* v,
          const float* col, float* a, float* b, float* ds, int T, int P,
          int Q, cudaStream_t st) {
  const int Tp = (T + kBK - 1) / kBK * kBK;
  const long long M = (long long)P * KB, N = (long long)Q * KB;
  x3_tsplit_kernel<<<dim3((unsigned)(M / 32), (unsigned)(Tp / 32)), 256, 0,
                     st>>>(dy, col, a, a + M * Tp, T, Tp, (int)M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  x3_tsplit_kernel<<<dim3((unsigned)(N / 32), (unsigned)(Tp / 32)), 256, 0,
                     st>>>(x, nullptr, b, b + N * Tp, T, Tp, (int)N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return product<KB>(a, a + M * Tp, M, b, b + N * Tp, N, Tp, ds, (int)M,
                     (int)N, u, v, nullptr, P, Q, st);
}

template <int KB>
int feedback(const float* dy, const float* u, const float* s,
             const float* v, const float* mask, float* dys, float* wt,
             float* dx, int T, int P, int Q, cudaStream_t st) {
  constexpr int nt = KB / 64;
  const long long K = (long long)P * KB, N = (long long)Q * KB;
  const long long ny = (long long)T * K;
  cudaError_t err = split_launch(x3_fsplit_kernel, dy, dys, dys + ny, ny,
                                 st);
  if (err != cudaSuccess) return static_cast<int>(err);
  x3_fcompose_kernel<KB><<<(unsigned)((long long)P * Q * nt * nt), 128,
                           kComposeSmem, st>>>(u, s, v, mask, wt,
                                               wt + N * K, P, Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return product<0, KB>(dys, dys + ny, T, wt, wt + N * K, N, K, dx, T,
                        (int)N, nullptr, nullptr, mask, P, Q, st);
}

bool bad(int T, int P, int Q, int k) {
  return T < 1 || P < 1 || Q < 1 || (k != 64 && k != 128) ||
         (long long)P * Q * k * k > 0x7fffffffLL ||
         (long long)(T + kBM - 1) / kBM > 65535 ||
         (long long)(T + kBK - 1) / kBK > 65535 ||
         ((long long)P * k + kBM - 1) / kBM > 65535;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int status) {
  if (status >= kEncodeError)
    return "cuTensorMapEncodeTiled failed or is missing from the driver";
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// The product's tile: out[0] = rows, out[1] = columns of a CTA's output
// tile, out[2] = reduction columns a stage.
extern "C" int ptc_3xtf32_tile(int* out) {
  out[0] = kBM;
  out[1] = kBN;
  out[2] = kBK;
  return 0;
}

// x, u, s, v, y fp32, k 64 or 128.  Scratch: xs (2, T, Q*k) fp32, x's tf32
// hi and lo; w (2, P*k, Q*k) fp32, the composed blocks' hi and lo.  x, u,
// s, v, xs and w 16-byte aligned, y 8-byte.
extern "C" int ptc_3xtf32_forward(const void* x, const void* u,
                                  const void* s, const void* v, void* xs,
                                  void* w, void* y, int T, int P, int Q,
                                  int k, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad(T, P, Q, k) || !aligned16(x) || !aligned16(u) || !aligned16(s) ||
      !aligned16(v) || !aligned16(xs) || !aligned16(w) ||
      (reinterpret_cast<uintptr_t>(y) & 7u))
    return static_cast<int>(cudaErrorInvalidValue);
  const float *xf = static_cast<const float*>(x),
              *uf = static_cast<const float*>(u),
              *sf = static_cast<const float*>(s),
              *vf = static_cast<const float*>(v);
  float *xsf = static_cast<float*>(xs), *wf = static_cast<float*>(w),
        *yf = static_cast<float*>(y);
  return k == 64 ? forward<64>(xf, uf, sf, vf, xsf, wf, yf, T, P, Q, st)
                 : forward<128>(xf, uf, sf, vf, xsf, wf, yf, T, P, Q, st);
}

// dy, x, u, v fp32, k 64 or 128; col (T,) fp32 or null; ds (P, Q, k) fp32.
// Scratch, with Tp = T rounded up to a multiple of 32: a (2, P*k, Tp) and
// b (2, Q*k, Tp) fp32, the tf32 hi and lo of col * dy and of x,
// transposed.  u, v, a and b 16-byte aligned.
extern "C" int ptc_3xtf32_sigma(const void* dy, const void* x, const void* u,
                                const void* v, const void* col, void* a,
                                void* b, void* ds, int T, int P, int Q, int k,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad(T, P, Q, k) || !aligned16(u) || !aligned16(v) || !aligned16(a) ||
      !aligned16(b))
    return static_cast<int>(cudaErrorInvalidValue);
  const float *dyf = static_cast<const float*>(dy),
              *xf = static_cast<const float*>(x),
              *uf = static_cast<const float*>(u),
              *vf = static_cast<const float*>(v),
              *cf = static_cast<const float*>(col);
  float *af = static_cast<float*>(a), *bf = static_cast<float*>(b),
        *dsf = static_cast<float*>(ds);
  return k == 64
             ? sigma<64>(dyf, xf, uf, vf, cf, af, bf, dsf, T, P, Q, st)
             : sigma<128>(dyf, xf, uf, vf, cf, af, bf, dsf, T, P, Q, st);
}

// dy, u, s, v, dx fp32, k 64 or 128; mask (Q, P) fp32, scaled.  Scratch:
// dys (2, T, P*k) fp32, dy's tf32 hi and lo; wt (2, Q*k, P*k) fp32, the
// kept blocks composed and transposed, hi and lo (a masked block's tiles
// are written only where the product reads them: zeros).  dy, u, s, v,
// dys and wt 16-byte aligned, dx 8-byte, mask 4-byte.
extern "C" int ptc_3xtf32_feedback(const void* dy, const void* u,
                                   const void* s, const void* v,
                                   const void* mask, void* dys, void* wt,
                                   void* dx, int T, int P, int Q, int k,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad(T, P, Q, k) || !aligned16(dy) || !aligned16(u) || !aligned16(s) ||
      !aligned16(v) || !aligned16(dys) || !aligned16(wt) ||
      (reinterpret_cast<uintptr_t>(dx) & 7u) ||
      (reinterpret_cast<uintptr_t>(mask) & 3u))
    return static_cast<int>(cudaErrorInvalidValue);
  const float *dyf = static_cast<const float*>(dy),
              *uf = static_cast<const float*>(u),
              *sf = static_cast<const float*>(s),
              *vf = static_cast<const float*>(v),
              *mf = static_cast<const float*>(mask);
  float *dysf = static_cast<float*>(dys), *wtf = static_cast<float*>(wt),
        *dxf = static_cast<float*>(dx);
  return k == 64
             ? feedback<64>(dyf, uf, sf, vf, mf, dysf, wtf, dxf, T, P, Q, st)
             : feedback<128>(dyf, uf, sf, vf, mf, dysf, wtf, dxf, T, P, Q,
                             st);
}
