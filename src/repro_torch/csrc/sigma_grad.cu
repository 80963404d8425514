// In-situ singular-value gradient  ds_pq = sum_t (U_pq^T dy_p) * (V*_pq x_q)
// (paper Eq. 5: the two reciprocal PTC passes and the electronic
// Hadamard-accumulate, fused; the (T, P, Q, k) intermediates never exist).
//
// Replaces the TPU kernel repro/kernels/sigma_grad.py::sigma_grad
// (dispatched by repro/kernels/ops.py::sigma_grad).  Shapes: dy (T, P*k),
// x (T, Q*k), u and v (P, Q, k, k) with v holding V*  ->  ds (P, Q, k) fp32;
// dy, x, u, v fp32 or bf16 (all alike), widened to fp32 on load, every sum
// fp32.  k <= 32; larger k take the wide route (ptc_wide.cu).
//
// The function's least work: the dense G = dy^T x summed over all rows
// (k^2 multiply-adds a row and block), then ds_pq[i] = sum_a U[a,i]
// (G_pq V*_pq^T)[a,i] once per block (2k^3).  The first design applied U^T
// and V* to every row (2k^2 + k a row and block) with one shared-memory
// operand per FMA, so it ran at twice the work and at the shared-memory
// issue rate.
//
// Design:
//  * A CTA of 128 threads owns a tile of G: MP p-blocks x NQ q-blocks
//    (8 x 16 blocks = 72 x 144 at k = 9), and walks its range of T.  Each
//    thread owns a TT x TT register tile of it (9 x 9 at k = 9: one whole
//    block; 8 x 8 otherwise); per row it loads TT values of dy and TT of x
//    as float4s from shared memory (each thread's slot padded to a multiple
//    of 4 floats) and adds their outer product: 13 FMAs per load at k = 9.
//  * Row slices of dy[:, p-range] and x[:, q-range], 16 rows a stage, come
//    through a 3-stage cp.async ring.  The copies are 4 bytes each: the
//    slots' padding scatters the columns, and dy's rows (P*k = 513, 135 and
//    261 floats on VGG-8) and x's (Q*k = 27, 513) are not 16-byte aligned.
//    Each thread copies the same (at most two) columns every stage, so the
//    copy addresses are computed once.  bf16 rows are widened by plain
//    loads and stores into the same ring (cp.async cannot convert).  The
//    ring starts zeroed, and
//    positions no copy writes (padding, blocks past P or Q) stay zero; rows
//    past the range are zero-filled.
//  * Epilogue: G goes to shared memory (it never reaches device memory),
//    and one thread per (block, i) writes ds_pq[i] = sum_a U[a,i]
//    (sum_b G[a,b] V*[i,b]), reading U and V* through L2 (prefetched there
//    when the CTA starts).
//  * Where the output tiles cannot fill the card (conv l1 of VGG-8: P = 8,
//    Q = 64, 4 tiles; FC 512 -> 10: 4 tiles), the wrapper's plan splits T
//    into chunks across CTAs; each chunk projects its partial G (the
//    projection is linear) into (splits, P, Q, k) partials, and a second
//    pass adds them in a fixed order.  No atomics: two runs give the same
//    bits.  With one chunk the kernel writes ds directly.
//  * Launches on the caller's stream, allocates nothing (the wrapper passes
//    the partials), and returns cudaGetLastError().

#include "ptc_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTY = 8, kTX = 16;   // thread grid over the G tile
constexpr int kBK = 16;            // rows of T per ring stage
constexpr int kStages = 3;

template <int KT>
struct Tile {
  static constexpr int TT = KT == 9 ? 9 : 8;         // thread tile TT x TT
  static constexpr int TS = ptc::pad4(TT);           // its slot in smem
  static constexpr int BMG = kTY * TT, BNG = kTX * TT;  // G tile
  static constexpr int MP = BMG / KT, NQ = BNG / KT;    // blocks in it
  static constexpr int DW = kTY * TS, XW = kTX * TS;    // smem row widths
  static constexpr int STAGE = kBK * (DW + XW);
  static constexpr int GS = BNG + 1;                    // G row stride
  static constexpr int RING = kStages * STAGE;
  static constexpr int FLOATS = RING > BMG * GS ? RING : BMG * GS;
  static constexpr int COLS = BMG + BNG;                // copied columns
  static constexpr int CPT = (COLS + kThreads - 1) / kThreads;
};

template <int KT, typename Tv>
__global__ void __launch_bounds__(kThreads, 3)
sigma_grad_kernel(const Tv* __restrict__ dy, const Tv* __restrict__ x,
                  const Tv* __restrict__ u, const Tv* __restrict__ v,
                  float* __restrict__ out, int T, int P, int Q, int k,
                  int chunk_rows, int splits) {
  using L = Tile<KT>;
  constexpr int TT = L::TT, TS = L::TS, MP = L::MP, NQ = L::NQ;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x, ty = tid / kTX, tx = tid % kTX;
  const int q0 = blockIdx.x * NQ, p0 = blockIdx.y * MP, split = blockIdx.z;
  const long long t_beg = (long long)split * chunk_rows;
  const long long t_end = min((long long)T, t_beg + chunk_rows);
  const int ldy = P * k, ldx = Q * k, kk = k * k;

  for (int i = tid; i < L::RING; i += kThreads) smem[i] = 0.f;
  // the epilogue's U and V* rows of this tile, into L2
  for (int pb = 0; pb < MP && p0 + pb < P; ++pb) {
    const int nq = min(NQ, Q - q0);
    const long long off = ((long long)(p0 + pb) * Q + q0) * kk;
    for (int e = 32 * tid; e < nq * kk; e += 32 * kThreads) {
      asm volatile("prefetch.global.L2 [%0];" ::"l"(u + off + e));
      asm volatile("prefetch.global.L2 [%0];" ::"l"(v + off + e));
    }
  }

  // this thread's copy columns: c < BMG in dy's tile, else in x's; src is
  // the column's element in row 0, or null where no copy is made
  const Tv* src[L::CPT];
  int ld[L::CPT], dst[L::CPT], rs[L::CPT];
#pragma unroll
  for (int n = 0; n < L::CPT; ++n) {
    const int c = tid + n * kThreads;
    src[n] = nullptr;
    ld[n] = dst[n] = rs[n] = 0;
    if (c < L::BMG) {
      const int blk = c / KT, a = c % KT;
      if (a < k && p0 + blk < P) src[n] = dy + (p0 + blk) * k + a;
      ld[n] = ldy;
      dst[n] = (c / TT) * TS + c % TT;
      rs[n] = L::DW;
    } else if (c < L::COLS) {
      const int c2 = c - L::BMG, blk = c2 / KT, a = c2 % KT;
      if (a < k && q0 + blk < Q) src[n] = x + (q0 + blk) * k + a;
      ld[n] = ldx;
      dst[n] = kBK * L::DW + (c2 / TT) * TS + c2 % TT;
      rs[n] = L::XW;
    }
  }
  __syncthreads();  // the zeroed ring before any copy lands

  auto load = [&](int slot, long long t0) {
    float* base = smem + slot * L::STAGE;
#pragma unroll
    for (int n = 0; n < L::CPT; ++n) {
      if (src[n] == nullptr) continue;
      const Tv* p = src[n] + t0 * ld[n];
#pragma unroll
      for (int r = 0; r < kBK; ++r) {
        const bool ok = t0 + r < t_end;
        if constexpr (sizeof(Tv) == 4)
          ptc::cp_async4(base + dst[n] + r * rs[n],
                         ok ? p + (long long)r * ld[n] : src[n], ok);
        else
          base[dst[n] + r * rs[n]] =
              ok ? ptc::to_f32(p[(long long)r * ld[n]]) : 0.f;
      }
    }
  };

  float acc[TT][TT];
#pragma unroll
  for (int i = 0; i < TT; ++i)
#pragma unroll
    for (int j = 0; j < TT; ++j) acc[i][j] = 0.f;

  const int nt = static_cast<int>((t_end - t_beg + kBK - 1) / kBK);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nt) load(st, t_beg + (long long)st * kBK);
    ptc::cp_async_commit();
  }
  for (int it = 0; it < nt; ++it) {
    ptc::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage it landed; the slot of it - 1 is free
    {
      const int nx = it + kStages - 1;
      if (nx < nt) load(nx % kStages, t_beg + (long long)nx * kBK);
      ptc::cp_async_commit();
    }
    const float* Ds = smem + (it % kStages) * L::STAGE;
    const float* Xs = Ds + kBK * L::DW;
#pragma unroll 4
    for (int r = 0; r < kBK; ++r) {
      float d[TS], xv[TS];
#pragma unroll
      for (int j4 = 0; j4 < TS / 4; ++j4) {
        const float4 a4 = *reinterpret_cast<const float4*>(
            Ds + r * L::DW + ty * TS + 4 * j4);
        const float4 b4 = *reinterpret_cast<const float4*>(
            Xs + r * L::XW + tx * TS + 4 * j4);
        d[4 * j4] = a4.x;
        d[4 * j4 + 1] = a4.y;
        d[4 * j4 + 2] = a4.z;
        d[4 * j4 + 3] = a4.w;
        xv[4 * j4] = b4.x;
        xv[4 * j4 + 1] = b4.y;
        xv[4 * j4 + 2] = b4.z;
        xv[4 * j4 + 3] = b4.w;
      }
#pragma unroll
      for (int i = 0; i < TT; ++i)
#pragma unroll
        for (int j = 0; j < TT; ++j) acc[i][j] = fmaf(d[i], xv[j], acc[i][j]);
    }
  }

  // epilogue: G to shared memory, then ds_pq[i] for each (block, i)
  ptc::cp_async_wait<0>();
  __syncthreads();
  float* g = smem;
#pragma unroll
  for (int i = 0; i < TT; ++i)
#pragma unroll
    for (int j = 0; j < TT; ++j)
      g[(ty * TT + i) * L::GS + tx * TT + j] = acc[i][j];
  __syncthreads();
  for (int task = tid; task < MP * NQ * KT; task += kThreads) {
    const int i = task % KT, blk = task / KT;
    const int qb = blk % NQ, pb = blk / NQ;
    const int p = p0 + pb, q = q0 + qb;
    if (i >= k || p >= P || q >= Q) continue;
    const long long b0 = ((long long)p * Q + q) * kk;
    const float* gb = g + pb * KT * L::GS + qb * KT;
    float vrow[KT];
#pragma unroll
    for (int b = 0; b < KT; ++b)
      vrow[b] = b < k ? ptc::to_f32(__ldg(v + b0 + i * k + b)) : 0.f;
    float a_sum = 0.f;
#pragma unroll
    for (int a = 0; a < KT; ++a) {
      if (a < k) {
        float gv = 0.f;
#pragma unroll
        for (int b = 0; b < KT; ++b) gv = fmaf(gb[a * L::GS + b], vrow[b], gv);
        a_sum = fmaf(ptc::to_f32(__ldg(u + b0 + a * k + i)), gv, a_sum);
      }
    }
    const long long o = ((long long)p * Q + q) * k + i;
    out[splits == 1 ? o : (long long)split * P * Q * k + o] = a_sum;
  }
}

__global__ void sigma_sum_splits_kernel(const float* __restrict__ part,
                                        float* __restrict__ ds, long long n,
                                        int splits) {
  ptc::sum_splits(part, ds, n, splits);
}

template <int KT, typename Tv>
cudaError_t launch(const Tv* dy, const Tv* x, const Tv* u, const Tv* v,
                   float* part, float* ds, int T, int P, int Q, int k,
                   int chunk_rows, int splits, cudaStream_t st) {
  using L = Tile<KT>;
  const size_t smem = sizeof(float) * L::FLOATS;
  auto kern = sigma_grad_kernel<KT, Tv>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Q + L::NQ - 1) / L::NQ, (P + L::MP - 1) / L::MP, splits);
  kern<<<grid, kThreads, smem, st>>>(dy, x, u, v, splits > 1 ? part : ds, T,
                                     P, Q, k, chunk_rows, splits);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long n = (long long)P * Q * k;
  sigma_sum_splits_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      part, ds, n, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// The tile for block size k: out[0] = p-blocks, out[1] = q-blocks per CTA,
// out[2] = rows per ring stage.  Returns 0, or cudaErrorInvalidValue for an
// unsupported k.
extern "C" int sigma_grad_tile(int k, int* out) {
  int mp, nq;
  switch (ptc::kernel_k(k)) {
    case 4: mp = Tile<4>::MP; nq = Tile<4>::NQ; break;
    case 8: mp = Tile<8>::MP; nq = Tile<8>::NQ; break;
    case 9: mp = Tile<9>::MP; nq = Tile<9>::NQ; break;
    case 16: mp = Tile<16>::MP; nq = Tile<16>::NQ; break;
    case 32: mp = Tile<32>::MP; nq = Tile<32>::NQ; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  out[0] = mp;
  out[1] = nq;
  out[2] = kBK;
  return 0;
}

namespace {

template <typename Tv>
cudaError_t by_k(const void* dy, const void* x, const void* u, const void* v,
                 float* pt, float* o, int T, int P, int Q, int k,
                 int chunk_rows, int splits, cudaStream_t st) {
  const Tv* a = static_cast<const Tv*>(dy);
  const Tv* b = static_cast<const Tv*>(x);
  const Tv* c = static_cast<const Tv*>(u);
  const Tv* d = static_cast<const Tv*>(v);
  switch (ptc::kernel_k(k)) {
#define REPRO_SIGMA(KT) \
  case KT:              \
    return launch<KT, Tv>(a, b, c, d, pt, o, T, P, Q, k, chunk_rows, splits, st)
    REPRO_SIGMA(4);
    REPRO_SIGMA(8);
    REPRO_SIGMA(9);
    REPRO_SIGMA(16);
    REPRO_SIGMA(32);
#undef REPRO_SIGMA
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (dy, x, u and v alike); ds is fp32.  T
// is cut into splits of chunk_rows rows (a multiple of 16); part: (splits,
// P, Q, k) scratch, unused when splits == 1.
extern "C" int sigma_grad(const void* dy, const void* x, const void* u,
                          const void* v, void* part, void* ds, int T, int P,
                          int Q, int k, int chunk_rows, int splits, int dtype,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(part);
  float* o = static_cast<float*>(ds);
  if (chunk_rows <= 0 || chunk_rows % kBK != 0 || splits < 1 ||
      splits != (int)(((long long)T + chunk_rows - 1) / chunk_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(by_k<float>(dy, x, u, v, pt, o, T, P, Q, k,
                                        chunk_rows, splits, st));
  if (dtype == 1)
    return static_cast<int>(by_k<__nv_bfloat16>(dy, x, u, v, pt, o, T, P, Q,
                                                 k, chunk_rows, splits, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
