// The blocked PTC forward, Sigma-gradient and error feedback at k = 64
// and 128 with bf16 operands, on the tensor cores (the "wide_tc" route).
//
// Replaces, for bf16 operands at k = 64 and 128 (k = 128 in every LM
// config), the TPU kernels
//   repro/kernels/ptc_block_matmul.py::ptc_block_matmul  y_p  = sum_q U_pq (s_pq * V*_pq x_q)
//   repro/kernels/sigma_grad.py::sigma_grad              ds_pq = sum_t col_t (U_pq^T dy_p) * (V*_pq x_q)
//   repro/kernels/feedback_matmul.py::feedback_matmul    dx_q = sum_p mask[q,p] V*_pq^T (s_pq * U_pq^T dy_p)
// (dispatched by repro/kernels/ops.py).  Shapes: x (T, Q*k), dy (T, P*k),
// u and v (P, Q, k, k) with v holding V*, s (P, Q, k), all bf16; col (T,)
// fp32 or none; mask (Q, P) fp32, already scaled; y (T, P*k) bf16, ds
// (P, Q, k) fp32, dx (T, Q*k) bf16.  fp32 operands and other k take the
// CUDA-core route (ptc_wide.cu).
//
// What bounds it on an H100: operations.  At olmo-1b's up projection
// (2048 -> 8192, k = 128, T = 4096) the forward is 137.4 GFLOP of product
// and 4.3 of composing: 0.143 ms at the bf16 tensor-core rate (989
// TFLOP/s) against 0.045 ms of bytes; the Sigma-gradient is the same
// product (G = dy^T x) and the same projection; the feedback is the
// product over the kept blocks alone (608 of 1,024 under btopk at
// alpha_W = 0.6: 81.6 GFLOP, 0.085 ms).  The CUDA-core route multiplies
// these bf16 operands in fp32 at 67 TFLOP/s; wgmma is the only way to the
// tensor cores' rate.
//
// Design (bf16 products, fp32 accumulators; no atomics, fixed order of
// sums: two runs give the same bits):
//  * tc_compose_kernel, one batched launch over the P*Q blocks, a 64 x 64
//    tile of W_pq = (U_pq diag(s_pq)) V*_pq a warpgroup: A = U diag(s) is
//    formed in registers (U's fragment scaled by s in fp32, rounded once
//    to bf16) and fed to wgmma; B = V* (rows along the reduction) sits in
//    shared memory, 128-byte swizzled; W is rounded once to bf16 into a
//    (P*k, Q*k) scratch the wrapper allocates.  Composing first, not in
//    the product's tiles, composes each block once instead of once per
//    row tile (32 times at T = 4096).
//  * tc_product_kernel, y = x W^T: both operands K-major, 64-column tiles
//    of 128 rows of x and 256 of W by TMA (128-byte swizzle, rows past T
//    zero-filled) into a four-stage ring, one full and one empty mbarrier
//    a stage.  One producer thread keeps the ring full; two consumer
//    warpgroups each own 64 rows x 256 columns of the 128 x 256 output
//    tile (two p-blocks at k = 128) and issue wgmma m64n256k16, keeping
//    one stage's products in flight while the next stage's wait.  Against
//    a 128 x 128 tile it reads each x tile once for twice the columns,
//    moves less shared memory per product (m64n256 against two m64n128),
//    and halves the tiles whose pipeline fill and epilogue the tensor
//    cores wait out.  The epilogue rounds to bf16 and masks T's ragged
//    edge.
//  * tc_col_split_kernel (only with a column scale): col * dy in fp32,
//    split into bf16 hi + lo, hi + lo within 2^-17 of the fp32 product.
//    One bf16 rounding of col * dy (off bf16's grid) would cost G about
//    2^-9 of its typical entry.  It flags each 64-row stage whose lo is
//    not all zero; the Sigma-gradient loads and multiplies lo only
//    there, so a scale on bf16's grid (the samplers' {0, 1} columns)
//    costs one pass, not two.
//  * tc_sigma_kernel, G_pq = sum_t dy_t,p x_t,q^T with its projection in
//    the epilogue: the CTA owns a 128 x 128 tile of G (one block at
//    k = 128, 2 x 2 blocks at k = 64) and reduces over all T.  dy (or hi,
//    then lo into the same accumulator) and x arrive by TMA as 64-row
//    tiles, both MN-major (rows along T), read by wgmma through the
//    transpose bit: no transpose pass.  A ring of 4 stages, the same
//    producer and two consumer warpgroups; hi's and lo's tiles of a T
//    range are two stages of the ring, each with x's tile, so the
//    products issue with no branch between them.  The tile's U blocks
//    arrive by TMA during the loop.  Epilogue: G (fp32 registers) is
//    split into bf16 hi + lo in shared memory, H = U^T (G_hi + G_lo) by
//    wgmma, then ds[i] = sum_b H[i, b] V*[i, b] reduced over the four
//    threads that share a row.  G never reaches device memory.
//  * tc_fcompose_kernel, the feedback's compose: only the kept blocks
//    (mask[q, p] != 0; a masked block's CTAs return at once), each
//    composed once and transposed, Wt_qp = (mask[q, p] U_pq diag(s_pq)
//    V*_pq)^T, into a (Q*k, P*k) bf16 scratch: A = V*^T read from shared
//    memory through wgmma's transpose bit, B = U diag(s) mask (scaled in
//    fp32, rounded once to bf16) K-major; Wt rounded once to bf16.  With
//    W~ stored transposed the product is the forward's K-major x W^T.
//  * tc_feedback_kernel, dx = dy Wt^T: the forward's ring, producer and
//    two consumer warpgroups, over the live 64-column stages only: a
//    stage (64 rows of one p block) is live where the mask keeps that p
//    block for any q block of the tile's columns.  The producer and the
//    consumers derive the same count from the mask (the producer the
//    stages themselves, the consumers how many), so no branch sits among
//    the wgmmas.  The tile is 256 rows x one q block (k columns; two
//    consumer warpgroups of 128 rows, m64n128k16 at k = 128), so the
//    skip keeps the mask's whole saving: under btopk at alpha_W = 0.6
//    60% of a tile's stages are live, where a tile of two q blocks (the
//    forward's 128 x 256 at k = 128) has a stage live wherever either
//    block keeps it, about 84%.  A q block with no kept p block gives an
//    exact zero.
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
using hopper::pack_bf16;
using hopper::smem_u32;
using hopper::tma_load_2d;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_rs;
using hopper::wgmma_ss;
using hopper::wgmma_ss_n128;
using hopper::wgmma_ss_n256;
using hopper::wgmma_wait;

typedef __nv_bfloat16 bf16;

constexpr int kBM = 128, kBN = 128;  // output tile of G
constexpr int kPBN = 256;            // the product's output tile: 128 x 256
constexpr int kBK = 64;              // reduction rows of a stage: 128 B of bf16
constexpr int kThreads = 384;        // a producer and two consumer warpgroups
constexpr int kConsumerWarps = 8;    // arrivals that empty a stage
constexpr int kHalf = 64 * 128;      // 64 rows of 64 bf16, one swizzled block

// the 1024-aligned base of dynamic shared memory (128-byte swizzle)
__device__ __forceinline__ uint32_t aligned_base(unsigned char* raw,
                                                 unsigned char** generic) {
  const uint32_t r = smem_u32(raw);
  const uint32_t pad = ((r + 1023u) & ~1023u) - r;
  *generic = raw + pad;
  return r + pad;
}

// --- compose -----------------------------------------------------------

// W[p*KB + m0 + i, q*KB + n0 + j] = sum_a bf16(U[i, a] s[a]) V*[a, j] for
// the CTA's 64 x 64 tile (m0, n0) of block blockIdx.x = p*Q + q
template <int KB>
__global__ void __launch_bounds__(128)
tc_compose_kernel(const bf16* __restrict__ u, const bf16* __restrict__ s,
                  const bf16* __restrict__ v, bf16* __restrict__ w, int Q) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base;
  const uint32_t sbase = aligned_base(smem_raw, &base);
  const long long blk = blockIdx.x;
  const int p = (int)(blk / Q), q = (int)(blk % Q);
  constexpr int nt = KB / 64;
  const int m0 = (blockIdx.y / nt) * 64, n0 = (blockIdx.y % nt) * 64;
  const bf16* ub = u + blk * KB * KB;
  const bf16* sb = s + blk * KB;
  const bf16* vb = v + blk * KB * KB;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // V*[a, n0 .. n0 + 63] for every a, 128-byte swizzled: row a's 16-byte
  // chunk c at a*128 + ((c ^ (a & 7)) * 16)
  for (int i = tid; i < KB * 8; i += 128) {
    const int a = i >> 3, c = i & 7;
    *reinterpret_cast<uint4*>(base + a * 128 + ((c ^ (a & 7)) << 4)) =
        *reinterpret_cast<const uint4*>(vb + a * KB + n0 + c * 8);
  }
  // A's fragments, U diag(s) rounded once to bf16: rows r and r + 8,
  // columns 16 kk + 2 (lane % 4) + {0, 1, 8, 9}
  const int r = m0 + 16 * warp + lane / 4, c2 = 2 * (lane % 4);
  uint32_t af[KB / 16][4];
#pragma unroll
  for (int kk = 0; kk < KB / 16; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = 16 * kk + 8 * h + c2;
      const float2 sv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(sb + col));
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float2 uv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(ub + (r + 8 * e) * KB +
                                                     col));
        af[kk][2 * h + e] = pack_bf16(__fmul_rn(uv.x, sv.x),
                                      __fmul_rn(uv.y, sv.y));
      }
    }
  fence_proxy_async();
  __syncthreads();

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KB / 16; ++kk)
    wgmma_rs(acc, af[kk], desc_sw128(sbase + kk * 2048));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);

  const long long ldw = (long long)Q * KB;
  bf16* wr = w + ((long long)p * KB + r) * ldw + (long long)q * KB + n0 + c2;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(wr + 8 * j) =
        __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<__nv_bfloat162*>(wr + 8 * ldw + 8 * j) =
        __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// --- product y = x W^T ------------------------------------------------

constexpr int kProdStages = 4;
struct ProductLayout {  // byte offsets from the aligned base
  static constexpr int tile_x = kBM * kBK * 2;        // 16 KB of x
  static constexpr int stage = tile_x + kPBN * kBK * 2;  // then 32 KB of W
  static constexpr int bars = kProdStages * stage;
  static constexpr int bytes = bars + 16 * kProdStages + 1024;
};

__global__ void __launch_bounds__(kThreads, 1)
tc_product_kernel(__grid_constant__ const CUtensorMap xmap,
                  __grid_constant__ const CUtensorMap wmap,
                  bf16* __restrict__ y, int T, int N, int K) {
  using L = ProductLayout;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base;
  const uint32_t sbase = aligned_base(smem_raw, &base);
  const int n0 = blockIdx.x * kPBN, m0 = blockIdx.y * kBM;
  const int nk = K / kBK;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  auto full = [&](int st) { return sbase + L::bars + 8 * st; };
  auto empty = [&](int st) { return sbase + L::bars + 8 * (kProdStages + st); };
  if (threadIdx.x == 0) {
    for (int st = 0; st < kProdStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread issues every load
    if (tid == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % kProdStages;
        if (kt >= kProdStages) mbar_wait(empty(st), (kt / kProdStages - 1) & 1);
        const uint32_t dst = sbase + st * L::stage;
        mbar_expect_tx(full(st), L::stage);
        tma_load_2d(dst, &xmap, full(st), kt * kBK, m0);
        tma_load_2d(dst + L::tile_x, &wmap, full(st), kt * kBK, n0);
      }
    }
    return;
  }

  const int c = wg - 1;  // this warpgroup's 64 rows of the tile
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % kProdStages;
    mbar_wait(full(st), (kt / kProdStages) & 1);
    const uint32_t a = sbase + st * L::stage + c * kHalf;
    const uint32_t b = sbase + st * L::stage + L::tile_x;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_ss_n256(acc, desc_sw128(a + 32 * kk), desc_sw128(b + 32 * kk));
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: free it
    fence_regs(acc);
    if (kt > 0 && lane == 0) mbar_arrive(empty((kt - 1) % kProdStages));
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // rows m0 + 64 c + 16 warp + lane / 4 (+ 8), columns n0 + 8 j + 2 (lane % 4)
  const int c2 = 2 * (lane % 4);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = m0 + 64 * c + 16 * warp + lane / 4 + 8 * e;
    if (row >= T) continue;
    bf16* yr = y + (long long)row * N + n0 + c2;
#pragma unroll
    for (int j = 0; j < kPBN / 8; ++j)
      if (n0 + 8 * j < N)
        *reinterpret_cast<__nv_bfloat162*>(yr + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * e], acc[4 * j + 2 * e + 1]);
  }
}

// --- feedback: Wt = W~^T composed, then dx = dy Wt^T ---------------------

// Wt[q*KB + j0 + j, p*KB + i0 + i] = sum_a V*[a, j0 + j] bf16(U[i0 + i, a]
// s[a] m) for the CTA's 64 x 64 tile of block blockIdx.x = p*Q + q, m =
// mask[q, p]; a masked block (m = 0) is not composed: its tiles of Wt are
// left as they are (the product's one-q-block tiles never read them)
template <int KB>
__global__ void __launch_bounds__(128)
tc_fcompose_kernel(const bf16* __restrict__ u, const bf16* __restrict__ s,
                   const bf16* __restrict__ v, const float* __restrict__ mask,
                   bf16* __restrict__ wt, int P, int Q) {
  const long long blk = blockIdx.x;
  const int p = (int)(blk / Q), q = (int)(blk % Q);
  const float m = mask[(long long)q * P + p];
  if (m == 0.f) return;
  constexpr int nt = KB / 64;
  const int j0 = (blockIdx.y / nt) * 64, i0 = (blockIdx.y % nt) * 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base;
  const uint32_t sbase = aligned_base(smem_raw, &base);
  constexpr int b_off = KB * 128;  // B after A's KB rows
  const bf16* ub = u + blk * KB * KB;
  const bf16* sb = s + blk * KB;
  const bf16* vb = v + blk * KB * KB;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // A = V*^T, MN-major: V*[a, j0 .. j0 + 63] for every a, 128-byte
  // swizzled (row a's 16-byte chunk c at a*128 + ((c ^ (a & 7)) * 16))
  for (int i = tid; i < KB * 8; i += 128) {
    const int a = i >> 3, c = i & 7;
    *reinterpret_cast<uint4*>(base + a * 128 + ((c ^ (a & 7)) << 4)) =
        *reinterpret_cast<const uint4*>(vb + a * KB + j0 + c * 8);
  }
  // B = (U diag(s) m)^T, K-major: row n = U's row i0 + n, its KB values
  // of a in 64-wide swizzle atoms of 8 KB; each product U s m formed in
  // fp32 and rounded once to bf16
  for (int i = tid; i < 64 * (KB / 8); i += 128) {
    const int n = i / (KB / 8), a0 = 8 * (i % (KB / 8));
    const uint4 raw =
        *reinterpret_cast<const uint4*>(ub + (long long)(i0 + n) * KB + a0);
    const __nv_bfloat162* u2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
    uint4 packed;
    uint32_t* o = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 uv = __bfloat1622float2(u2[e]);
      const float2 sv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(sb + a0 + 2 * e));
      o[e] = pack_bf16(__fmul_rn(__fmul_rn(uv.x, sv.x), m),
                       __fmul_rn(__fmul_rn(uv.y, sv.y), m));
    }
    const int c = (a0 % 64) / 8;
    *reinterpret_cast<uint4*>(base + b_off + (a0 / 64) * kHalf + n * 128 +
                              ((c ^ (n & 7)) << 4)) = packed;
  }
  fence_proxy_async();
  __syncthreads();

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KB / 16; ++kk)
    wgmma_ss<1, 0>(acc, desc_sw128(sbase + kk * 2048),
                   desc_sw128(sbase + b_off + (kk / 4) * kHalf +
                              (kk % 4) * 32),
                   1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);

  // rows j0 + 16 warp + lane / 4 (+ 8) of Wt's block row q, columns
  // i0 + 8 jj + 2 (lane % 4) of its block column p
  const int r = 16 * warp + lane / 4, c2 = 2 * (lane % 4);
  const long long ldw = (long long)P * KB;
  bf16* wr = wt + ((long long)q * KB + j0 + r) * ldw + (long long)p * KB +
             i0 + c2;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    *reinterpret_cast<__nv_bfloat162*>(wr + 8 * jj) =
        __floats2bfloat162_rn(acc[4 * jj], acc[4 * jj + 1]);
    *reinterpret_cast<__nv_bfloat162*>(wr + 8 * ldw + 8 * jj) =
        __floats2bfloat162_rn(acc[4 * jj + 2], acc[4 * jj + 3]);
  }
}

constexpr int kFBM = 256;  // the feedback product's tile: 256 rows x k

template <int KB>
struct FeedbackLayout {  // byte offsets from the aligned base
  static constexpr int stages = 4;
  static constexpr int tile_a = kFBM * kBK * 2;       // kFBM rows of dy
  static constexpr int stage = tile_a + KB * kBK * 2;  // then KB of Wt
  static constexpr int bars = stages * stage;
  static constexpr int bytes = bars + 16 * stages + 1024;
};

// d (64 x N) += A (64 x 16) * B (16 x N), both K-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_kmajor(float (&d)[N / 2], uint64_t da,
                                             uint64_t db) {
  if constexpr (N == 64)
    wgmma_ss<0, 0>(d, da, db, 1);
  else
    wgmma_ss_n128(d, da, db);
}

// dx tile (blockIdx.y, blockIdx.x): rows kFBM*y .. of T, the KB columns of
// q block x, over the 64-column stages of the p blocks that q keeps
template <int KB>
__global__ void __launch_bounds__(kThreads, 1)
tc_feedback_kernel(__grid_constant__ const CUtensorMap amap,
                   __grid_constant__ const CUtensorMap bmap,
                   const float* __restrict__ mask, bf16* __restrict__ dx,
                   int T, int P, int Q) {
  using L = FeedbackLayout<KB>;
  constexpr int S = L::stages;
  constexpr int per_p = KB / kBK;  // stages a p block
  constexpr int MT = kFBM / 128;   // 64-row products a consumer
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base;
  const uint32_t sbase = aligned_base(smem_raw, &base);
  const int N = Q * KB;
  const int n0 = blockIdx.x * KB, m0 = blockIdx.y * kFBM;
  const float* mrow = mask + (long long)blockIdx.x * P;  // mask[q, :]
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  auto full = [&](int st) { return sbase + L::bars + 8 * st; };
  auto empty = [&](int st) { return sbase + L::bars + 8 * (S + st); };
  if (threadIdx.x == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer: the live stages, in order
    if (tid == 0) {
      int vs = 0;
      for (int pb = 0; pb < P; ++pb) {
        if (__ldg(mrow + pb) == 0.f) continue;
        for (int h = 0; h < per_p; ++h, ++vs) {
          const int st = vs % S;
          if (vs >= S) mbar_wait(empty(st), (vs / S - 1) & 1);
          const uint32_t dst = sbase + st * L::stage;
          const int kc = pb * KB + h * kBK;
          mbar_expect_tx(full(st), L::stage);
          tma_load_2d(dst, &amap, full(st), kc, m0);
          tma_load_2d(dst + L::tile_a, &bmap, full(st), kc, n0);
        }
      }
    }
    return;
  }

  // consumer c owns rows c*kFBM/2 .. of the tile, all KB columns; it
  // counts the stages the producer sends
  const int c = wg - 1;
  int n_live = 0;
  for (int pb = 0; pb < P; ++pb) n_live += __ldg(mrow + pb) != 0.f;
  n_live *= per_p;
  float acc[MT][KB / 2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < KB / 2; ++i) acc[mt][i] = 0.f;
  for (int vs = 0; vs < n_live; ++vs) {
    const int st = vs % S;
    mbar_wait(full(st), (vs / S) & 1);
    const uint32_t a = sbase + st * L::stage + c * (kFBM / 2) * 128;
    const uint32_t b = sbase + st * L::stage + L::tile_a;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        wgmma_kmajor<KB>(acc[mt], desc_sw128(a + mt * kHalf + 32 * kk),
                         desc_sw128(b + 32 * kk));
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: free it
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
    if (vs > 0 && lane == 0) mbar_arrive(empty((vs - 1) % S));
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);

  // rows m0 + c*kFBM/2 + 64 mt + 16 warp + lane / 4 (+ 8), columns n0 + 8 j
  // + 2 (lane % 4)
  const int c2 = 2 * (lane % 4);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = m0 + c * (kFBM / 2) + 64 * mt + 16 * warp +
                      lane / 4 + 8 * e;
      if (row >= T) continue;
      bf16* xr = dx + (long long)row * N + n0 + c2;
#pragma unroll
      for (int j = 0; j < KB / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(xr + 8 * j) =
            __floats2bfloat162_rn(acc[mt][4 * j + 2 * e],
                                  acc[mt][4 * j + 2 * e + 1]);
    }
}

// --- the column scale: hi + lo = col * dy --------------------------------

// CTA (blockIdx.x, blockIdx.y): 64 rows of dy (one reduction stage of
// tc_sigma_kernel) by 256 of its columns; lo_live[blockIdx.y] set to 1
// where any lo of the stage is not zero (it starts zeroed)
constexpr int kSplitCols = 256;
__global__ void __launch_bounds__(256)
tc_col_split_kernel(const bf16* __restrict__ dy, const float* __restrict__ col,
                    bf16* __restrict__ hi, bf16* __restrict__ lo,
                    int* __restrict__ lo_live, int T, int M) {
  const int r0 = blockIdx.y * kBK, c0 = blockIdx.x * kSplitCols;
  int nz = 0;
  for (int i = threadIdx.x; i < kBK * kSplitCols / 8; i += 256) {
    const int r = r0 + i / (kSplitCols / 8);
    const int cc = c0 + 8 * (i % (kSplitCols / 8));
    if (r >= T || cc >= M) continue;
    const long long at = ((long long)r * M + cc) / 8;
    const float cs = col[r];
    const uint4 raw = reinterpret_cast<const uint4*>(dy)[at];
    const bf16* d = reinterpret_cast<const bf16*>(&raw);
    uint4 h4, l4;
    bf16* h = reinterpret_cast<bf16*>(&h4);
    bf16* l = reinterpret_cast<bf16*>(&l4);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float f = __fmul_rn(__bfloat162float(d[e]), cs);
      h[e] = __float2bfloat16_rn(f);
      l[e] = __float2bfloat16_rn(__fsub_rn(f, __bfloat162float(h[e])));
    }
    nz |= (l4.x | l4.y | l4.z | l4.w) != 0u;
    reinterpret_cast<uint4*>(hi)[at] = h4;
    reinterpret_cast<uint4*>(lo)[at] = l4;
  }
  // every writer stores the same 1: no atomic needed
  if (__syncthreads_or(nz) && threadIdx.x == 0) lo_live[blockIdx.y] = 1;
}

// --- Sigma-gradient -----------------------------------------------------

struct SigmaLayout {  // byte offsets from the aligned base
  static constexpr int stages = 4;
  static constexpr int a = 0;                       // dy, hi or lo: 2 x 8 KB
  static constexpr int b = 2 * kHalf;               // x: 2 x 8 KB
  static constexpr int stage = 4 * kHalf;
  static constexpr int u = stages * stage;          // the tile's U: 32 KB
  static constexpr int bars = u + 4 * kHalf;
  static constexpr int bytes = bars + 8 * (2 * stages + 1) + 1024;
  // after the loop, in the ring's place: G hi, then G lo, each two
  // 64-column halves of 128 rows (16 KB)
  static constexpr int ghi = 0, glo = 4 * kHalf;
};

// whether 64-row stage kt of lo takes part: with lo, where lo_live says
// so (every stage without lo_live)
template <bool SPLIT>
__device__ __forceinline__ bool lo_stage(const int* lo_live, int kt) {
  return SPLIT && (lo_live == nullptr || lo_live[kt] != 0);
}

// ds of the blocks under G tile (tm, tn) = (blockIdx.y, blockIdx.x): rows
// 128 tm .. of P*KB (dy's columns), columns 128 tn .. of Q*KB (x's)
template <int KB, bool SPLIT>
__global__ void __launch_bounds__(kThreads, 1)
tc_sigma_kernel(__grid_constant__ const CUtensorMap amap,
                __grid_constant__ const CUtensorMap lmap,
                __grid_constant__ const CUtensorMap xmap,
                __grid_constant__ const CUtensorMap umap,
                const bf16* __restrict__ v, const int* __restrict__ lo_live,
                float* __restrict__ ds, int T, int P, int Q) {
  using L = SigmaLayout;
  constexpr int S = L::stages;
  constexpr int stage_bytes = L::stage;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base;
  const uint32_t sbase = aligned_base(smem_raw, &base);
  const int tn = blockIdx.x, tm = blockIdx.y;
  const int nk = (T + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  auto full = [&](int st) { return sbase + L::bars + 8 * st; };
  auto empty = [&](int st) { return sbase + L::bars + 8 * (S + st); };
  const uint32_t ubar = sbase + L::bars + 8 * (2 * S);
  if (threadIdx.x == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kConsumerWarps);
    }
    mbar_init(ubar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    if (tid == 0) {
      // the tile's U blocks: at k = 128 block (tm, tn) as two 64-column
      // halves of 128 rows; at k = 64 the blocks (2 tm + w, 2 tn + h) at
      // (2 w + h) * 8 KB (past P or Q: clamped, and their ds not written)
      mbar_expect_tx(ubar, 4 * kHalf);
      if (KB == 128) {
        const int row = (tm * Q + tn) * 128;
        tma_load_2d(sbase + L::u, &umap, ubar, 0, row);
        tma_load_2d(sbase + L::u + 2 * kHalf, &umap, ubar, 64, row);
      } else {
        for (int wh = 0; wh < 4; ++wh) {
          const int p = min(2 * tm + wh / 2, P - 1);
          const int q = min(2 * tn + wh % 2, Q - 1);
          tma_load_2d(sbase + L::u + wh * kHalf, &umap, ubar, 0,
                      (p * Q + q) * 64);
        }
      }
      // 64-column halves wholly past P*KB or Q*KB (k = 64, odd P or Q)
      // load the last block's columns instead: no box lies wholly outside
      const int a_last = P * KB - 64, b_last = Q * KB - 64;
      // the ring's stages: dy's (or hi's) tile kt, then lo's where it
      // takes part, each with x's tile kt
      int vs = 0;
      for (int kt = 0; kt < nk; ++kt)
        for (int part = 0; part < 2; ++part) {
          if (part == 1 && !lo_stage<SPLIT>(lo_live, kt)) continue;
          const int st = vs % S;
          if (vs >= S) mbar_wait(empty(st), (vs / S - 1) & 1);
          const uint32_t dst = sbase + st * stage_bytes;
          const int t0 = kt * kBK;
          mbar_expect_tx(full(st), stage_bytes);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int ac = min(kBM * tm + 64 * h, a_last);
            const int bc = min(kBN * tn + 64 * h, b_last);
            tma_load_2d(dst + L::a + h * kHalf, part ? &lmap : &amap,
                        full(st), ac, t0);
            tma_load_2d(dst + L::b + h * kHalf, &xmap, full(st), bc, t0);
          }
          ++vs;
        }
    }
    return;
  }

  // consumer c owns G's rows 64 c .. 64 c + 63 of the tile, both halves
  // of its columns
  const int c = wg - 1;
  float acc[2][32];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
  // the stages the producer sends: one a 64-row tile, plus one for each
  // tile of lo that takes part (hi, then lo, into the same accumulator)
  int n_stages = nk;
  for (int kt = 0; kt < nk; ++kt) n_stages += lo_stage<SPLIT>(lo_live, kt);
  for (int vs = 0; vs < n_stages; ++vs) {
    const int st = vs % S;
    mbar_wait(full(st), (vs / S) & 1);
    const uint32_t sb = sbase + st * stage_bytes;
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        wgmma_ss<1, 1>(acc[h], desc_sw128(sb + L::a + c * kHalf + kk * 2048),
                       desc_sw128(sb + L::b + h * kHalf + kk * 2048), 1);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    if (vs > 0 && lane == 0) mbar_arrive(empty((vs - 1) % S));
  }
  wgmma_wait<0>();
  fence_regs(acc[0]);
  fence_regs(acc[1]);

  // every consumer is done with the ring: G's bf16 hi and lo take its
  // place, rows along the reduction of H = U^T G (MN-major), swizzled
  named_sync(1, 2 * 128);
  const int c4 = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = 64 * c + 16 * warp + lane / 4 + 8 * e;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float g0 = acc[h][4 * j + 2 * e], g1 = acc[h][4 * j + 2 * e + 1];
        const __nv_bfloat162 hv = __floats2bfloat162_rn(g0, g1);
        const float2 hf = __bfloat1622float2(hv);
        const int off = h * 2 * kHalf + row * 128 + ((j ^ (row & 7)) << 4) +
                        4 * c4;
        *reinterpret_cast<__nv_bfloat162*>(base + L::ghi + off) = hv;
        *reinterpret_cast<uint32_t*>(base + L::glo + off) =
            pack_bf16(__fsub_rn(g0, hf.x), __fsub_rn(g1, hf.y));
      }
    }
  fence_proxy_async();
  named_sync(1, 2 * 128);
  mbar_wait(ubar, 0);

  // H = U^T (G_hi + G_lo): A = U^T from the U tile (rows along a, MN-major),
  // B = G's halves.  At k = 128 this warpgroup's H rows are i = 64 c ..,
  // over all 128 a; at k = 64 its block row is p = 2 tm + c, i over the
  // block's 64, a over G's rows 64 c ..
  float hacc[2][32];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) hacc[h][i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KB / 16; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t ua = KB == 128
                              ? sbase + L::u + c * 2 * kHalf + kk * 2048
                              : sbase + L::u + (2 * c + h) * kHalf + kk * 2048;
      const uint32_t gb = h * 2 * kHalf + (KB == 128 ? 0 : c * kHalf) +
                          kk * 2048;
      wgmma_ss<1, 1>(hacc[h], desc_sw128(ua), desc_sw128(sbase + L::ghi + gb),
                     1);
      wgmma_ss<1, 1>(hacc[h], desc_sw128(ua), desc_sw128(sbase + L::glo + gb),
                     1);
    }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(hacc[0]);
  fence_regs(hacc[1]);

  // ds[i] = sum_b H[i, b] V*[i, b]: this thread's columns, then the four
  // threads that share the row
  const int il = 16 * warp + lane / 4;  // and il + 8
  if (KB == 128) {
    const long long blk = (long long)tm * Q + tn;
    const bf16* vb = v + blk * KB * KB;
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 64 * c + il + 8 * e;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 vv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  vb + i * KB + 64 * h + 8 * j + 2 * c4));
          sum[e] = fmaf(hacc[h][4 * j + 2 * e], vv.x, sum[e]);
          sum[e] = fmaf(hacc[h][4 * j + 2 * e + 1], vv.y, sum[e]);
        }
      sum[e] += __shfl_xor_sync(0xffffffffu, sum[e], 1);
      sum[e] += __shfl_xor_sync(0xffffffffu, sum[e], 2);
      if (c4 == 0) ds[blk * KB + i] = sum[e];
    }
  } else {
    const int p = 2 * tm + c;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = 2 * tn + h;
      const bool live = p < P && q < Q;  // uniform across the warp
      const long long blk = (long long)min(p, P - 1) * Q + min(q, Q - 1);
      const bf16* vb = v + blk * KB * KB;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = il + 8 * e;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 vv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(vb + i * KB + 8 * j +
                                                       2 * c4));
          sum = fmaf(hacc[h][4 * j + 2 * e], vv.x, sum);
          sum = fmaf(hacc[h][4 * j + 2 * e + 1], vv.y, sum);
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (live && c4 == 0) ds[blk * KB + i] = sum;
      }
    }
  }
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <int KB>
int forward(const void* x, const void* u, const void* s, const void* v,
            void* w, void* y, int T, int P, int Q, cudaStream_t st) {
  constexpr int nt = KB / 64;
  tc_compose_kernel<KB><<<dim3((unsigned)P * Q, nt * nt), 128,
                          KB * 128 + 1024, st>>>(
      static_cast<const bf16*>(u), static_cast<const bf16*>(s),
      static_cast<const bf16*>(v), static_cast<bf16*>(w), Q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long N = (long long)P * KB, K = (long long)Q * KB;
  CUtensorMap xmap, wmap;
  int rc = map_2d(&xmap, x, T, K, kBM, kBK);
  if (rc == 0) rc = map_2d(&wmap, w, N, K, kPBN, kBK);
  if (rc != 0) return rc;
  static bool smem_set = false;
  err = allow_smem(tc_product_kernel, ProductLayout::bytes, &smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  tc_product_kernel<<<dim3((unsigned)((N + kPBN - 1) / kPBN),
                           (unsigned)((T + kBM - 1) / kBM)),
                      kThreads, ProductLayout::bytes, st>>>(
      xmap, wmap, static_cast<bf16*>(y), T, (int)N, (int)K);
  return static_cast<int>(cudaGetLastError());
}

template <int KB, bool SPLIT>
int sigma(const void* a, const void* lo, const int* lo_live, const void* x,
          const void* u, const void* v, void* ds, int T, int P, int Q,
          cudaStream_t st) {
  using L = SigmaLayout;
  const long long M = (long long)P * KB, N = (long long)Q * KB;
  CUtensorMap amap, lmap, xmap, umap;
  int rc = map_2d(&amap, a, T, M, kBK, 64);
  if (rc == 0) rc = map_2d(&lmap, SPLIT ? lo : a, T, M, kBK, 64);
  if (rc == 0) rc = map_2d(&xmap, x, T, N, kBK, 64);
  if (rc == 0) rc = map_2d(&umap, u, (long long)P * Q * KB, KB, KB, 64);
  if (rc != 0) return rc;
  auto kern = tc_sigma_kernel<KB, SPLIT>;
  static bool smem_set = false;
  cudaError_t err = allow_smem(kern, L::bytes, &smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3((unsigned)((N + kBN - 1) / kBN), (unsigned)((M + kBM - 1) / kBM)),
         kThreads, L::bytes, st>>>(amap, lmap, xmap, umap,
                                   static_cast<const bf16*>(v), lo_live,
                                   static_cast<float*>(ds), T, P, Q);
  return static_cast<int>(cudaGetLastError());
}

template <int KB>
int sigma_any(const void* a, const void* lo, const int* lo_live,
              const void* x, const void* u, const void* v, void* ds, int T,
              int P, int Q, cudaStream_t st) {
  return lo != nullptr
             ? sigma<KB, true>(a, lo, lo_live, x, u, v, ds, T, P, Q, st)
             : sigma<KB, false>(a, lo, nullptr, x, u, v, ds, T, P, Q, st);
}

template <int KB>
int feedback(const void* dy, const void* u, const void* s, const void* v,
             const float* mask, void* wt, void* dx, int T, int P, int Q,
             cudaStream_t st) {
  using L = FeedbackLayout<KB>;
  constexpr int nt = KB / 64;
  tc_fcompose_kernel<KB><<<dim3((unsigned)P * Q, nt * nt), 128,
                           KB * 128 + 64 * KB * 2 + 1024, st>>>(
      static_cast<const bf16*>(u), static_cast<const bf16*>(s),
      static_cast<const bf16*>(v), mask, static_cast<bf16*>(wt), P, Q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long M = (long long)P * KB, N = (long long)Q * KB;
  CUtensorMap amap, bmap;
  int rc = map_2d(&amap, dy, T, M, kFBM, kBK);
  if (rc == 0) rc = map_2d(&bmap, wt, N, M, KB, kBK);
  if (rc != 0) return rc;
  auto kern = tc_feedback_kernel<KB>;
  static bool smem_set = false;
  err = allow_smem(kern, L::bytes, &smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3((unsigned)Q, (unsigned)((T + kFBM - 1) / kFBM)),
         kThreads, L::bytes, st>>>(amap, bmap, mask, static_cast<bf16*>(dx),
                                   T, P, Q);
  return static_cast<int>(cudaGetLastError());
}

bool bad(int T, int P, int Q, int k) {
  return T < 1 || P < 1 || Q < 1 || (k != 64 && k != 128) ||
         (long long)P * Q * k > 0x7fffffffLL ||
         (long long)(T + kBK - 1) / kBK > 65535 ||
         ((long long)P * k + kBM - 1) / kBM > 65535;
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int status) {
  if (status >= kEncodeError)
    return "cuTensorMapEncodeTiled failed or is missing from the driver";
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// The forward product's tile: out[0] = rows, out[1] = columns of a CTA's
// output tile, out[2] = reduction columns a stage (G's tile: 128 x 128
// over 64 rows a stage).
extern "C" int ptc_tc_tile(int* out) {
  out[0] = kBM;
  out[1] = kPBN;
  out[2] = kBK;
  return 0;
}

// x, u, s, v, y bf16, k 64 or 128; w: scratch (P*k, Q*k) bf16, the
// composed blocks.  x, v and w 16-byte aligned.
extern "C" int ptc_tc_forward(const void* x, const void* u, const void* s,
                              const void* v, void* w, void* y, int T, int P,
                              int Q, int k, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad(T, P, Q, k) || !aligned16(x) || !aligned16(v) || !aligned16(w) ||
      ((reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(s) |
        reinterpret_cast<uintptr_t>(y)) & 3u))
    return static_cast<int>(cudaErrorInvalidValue);
  return k == 64 ? forward<64>(x, u, s, v, w, y, T, P, Q, st)
                 : forward<128>(x, u, s, v, w, y, T, P, Q, st);
}

// dy, x, u, v bf16, k 64 or 128; ds (P, Q, k) fp32.  With col (T,) fp32,
// the reduction runs over the bf16 hi and lo of col * dy, formed first
// into split (2, T, P*k) bf16, skipping each 64-row stage whose lo is
// zero throughout (lo_live: ceil(T / 64) int32 of scratch); else with lo
// (T, P*k) bf16, over dy and lo (dy taken as the hi part); else over dy
// alone.  dy, lo, x, u and split 16-byte aligned.
extern "C" int ptc_tc_sigma(const void* dy, const void* lo, const void* x,
                            const void* u, const void* v, const void* col,
                            void* split, void* lo_live, void* ds, int T,
                            int P, int Q, int k, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad(T, P, Q, k) || !aligned16(dy) || !aligned16(x) || !aligned16(u) ||
      (lo != nullptr && !aligned16(lo)) ||
      (col != nullptr &&
       (split == nullptr || !aligned16(split) || lo_live == nullptr)) ||
      (reinterpret_cast<uintptr_t>(v) & 3u))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* a = dy;
  int* live = nullptr;
  if (col != nullptr) {
    const long long n = (long long)T * P * k;
    bf16* hi = static_cast<bf16*>(split);
    bf16* lw = hi + n;
    const int stages = (T + kBK - 1) / kBK;
    live = static_cast<int*>(lo_live);
    cudaError_t err = cudaMemsetAsync(live, 0, sizeof(int) * stages, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    tc_col_split_kernel<<<dim3((P * k + kSplitCols - 1) / kSplitCols, stages),
                          256, 0, st>>>(static_cast<const bf16*>(dy),
                                        static_cast<const float*>(col), hi,
                                        lw, live, T, P * k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    a = hi;
    lo = lw;
  }
  return k == 64 ? sigma_any<64>(a, lo, live, x, u, v, ds, T, P, Q, st)
                 : sigma_any<128>(a, lo, live, x, u, v, ds, T, P, Q, st);
}

// dy, u, s, v, dx bf16, k 64 or 128; mask (Q, P) fp32, scaled; wt:
// scratch (Q*k, P*k) bf16, the kept blocks composed and transposed (a
// masked block's tiles are neither written nor read).  dy, u, v and wt
// 16-byte aligned.
extern "C" int ptc_tc_feedback(const void* dy, const void* u, const void* s,
                               const void* v, const void* mask, void* wt,
                               void* dx, int T, int P, int Q, int k,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  if (bad(T, P, Q, k) || !aligned16(dy) || !aligned16(u) || !aligned16(v) ||
      !aligned16(wt) ||
      ((reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(mask) |
        reinterpret_cast<uintptr_t>(dx)) & 3u))
    return static_cast<int>(cudaErrorInvalidValue);
  return k == 64 ? feedback<64>(dy, u, s, v, m, wt, dx, T, P, Q, st)
                 : feedback<128>(dy, u, s, v, m, wt, dx, T, P, Q, st);
}
