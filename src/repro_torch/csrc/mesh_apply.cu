// Block-batched MZI mesh application  y = U(phi_b, d_b) x  for many meshes.
//
// Replaces the TPU kernel repro/kernels/mesh_apply.py::mesh_apply_butterfly
// together with its coefficient-table pass repro/kernels/ops.py::_coeff_tables.
// The TPU kernel applies ONE mesh to many rows; here every mesh b of a batch
// has its own phases (B, T) and sign diagonal (B, k), which is what building
// the realized unitaries of every block in Identity Calibration and Parallel
// Mapping needs (each ZO probe rebuilds U and V of every block).
//
// What bounds it on an H100: device-memory bytes.  For build_unitary at
// k = 9 each mesh reads T = 36 phases and 9 signs and writes 81 outputs, and
// does 36 sincos + 9*36*6 flops; 51,984 meshes (an IC probe of VGG-8's
// classifier head) move 26 MB, 7.8 us at 3.35 TB/s.  The instructions come
// close behind: a full-precision sincosf is some 45 of them and each
// rotation four FMAs and a shared load per row, so the kernel below issues
// for about as long as its bytes take (PERF.md has its share of the bound).
//
// The narrow route (mesh_apply_kernel, k <= 32):
//  * A thread owns rows of one mesh, each row's wires in registers (K, the
//    compiled width, >= k): two rows up to K = 9, one past it.  The
//    adjacent-wire exchange of a rotation is a register move: no
//    shuffles, no shared-memory traffic.
//  * The rotation sequence is fixed at compile time per (kind, K): the
//    mesh's pairs in application order (clements: layer by layer; reck:
//    the reversed column-wise nulling order), unrolled, so each rotation is
//    one shared (cos, sin) load at a constant offset and four FMAs a row,
//    with no lookup and no branch.  Rotations on disjoint wires commute, so
//    this order gives the layered order's bits.  k below its compiled K
//    runs the K pattern under a host table (kernels/mesh_apply.py::
//    narrow_plan) of each rotation's phase slot, -1 where absent (a
//    uniform branch); a reck mesh of k sits on wires K - k .. K - 1 of the
//    K mesh, a clements mesh on wires 0 .. k - 1.
//  * cos/sin are computed in the kernel (sincosf, full precision: phases
//    carry an unknown bias up to 2*pi plus quantization) once per (mesh,
//    phase) into shared memory and shared by the mesh's rows, replacing the
//    separate table pass.
//  * Persistent CTAs walk groups of meshes (as many whole meshes as fill
//    256 threads: 51 at k = 9), and prefetch the next group's phases and
//    signs by cp.async into a second buffer while the current group
//    computes.
//  * Stores go through shared memory: a group's outputs are one contiguous
//    span of y (its meshes whole, or a row range of one mesh, in either
//    output layout), written as float4 with its ragged ends scalar.
//  * x may be broadcast over meshes (batch stride 0): build_unitary applies
//    every mesh to one shared identity without copying it per mesh.  The
//    output strides are free (a group whose span is not contiguous stores
//    from registers), so build_unitary writes U transposed in place.
//  * Launches on the caller's stream, allocates nothing, and returns
//    cudaGetLastError().
//
// The wide route (mesh_apply_wide_kernel, any k > 32; k = 128 in every LM
// config): a row's k wires no longer fit in one thread's registers, and a
// reck mesh at k = 128 has 8,128 phases in 253 layers, so neither its
// cos/sin (65 KB) nor its slot table (130 KB) fits beside the rows in 48 KB
// of shared memory.  A CTA owns one mesh and a tile of up to 64 rows, held
// in shared memory (row stride k + 1); warp w owns rows w, w + 8, ...
// Rotations come as a list in layer order (upper wire, phase slot, and
// each layer's start), so a layer costs no scan of idle wires: a lane
// takes a layer's rotations lane, lane + 32, ... and applies each to the
// warp's 8 rows (8 independent updates per rotation it reads).
// A layer's (cos, sin, upper wire) are staged once per CTA, for the next
// layer only, into one of two small buffers while the current layer is
// applied: one barrier a layer, and the shared memory no longer grows with
// the phase count.  Since the unrolled route took k = 64 and 128 it serves
// only the other k > 32, which no configuration of the port uses.
//
// The unrolled route (mesh_apply_unrolled_kernel, k = 64 and 128): the
// wide route's CTA closed each of a reck mesh's 253 layers at k = 128 with
// a barrier and moved two wires of each row through shared memory per
// rotation, at 6% of its bound.  Here, as in the narrow route, a thread
// owns one row and holds its k wires in registers (k = 128: 128 of them),
// and the rotation order is fixed at compile time per (kind, k):
//  * A CTA owns one mesh and up to k of its rows (one thread a row; more
//    rows take more CTAs along grid.y).  It first computes every phase's
//    (cos, sin) once, with full-precision sincosf, into shared memory
//    (8,128 pairs at k = 128, about 68 KB with the padding below: Hopper
//    lets a kernel opt in to 227 KB), in a flat loop of independent
//    iterations that keeps several phase loads in flight a thread; then
//    each rotation is one broadcast shared load (all threads read the same
//    address) and four FP instructions a row, with no barrier in the
//    rotation loop.
//  * What bounds it: each rotation delivers its 8 bytes of (cos, sin)
//    from shared memory to every row's lane, 2.2 G row-rotations (18 GB
//    of lane deliveries) for 2,048 reck meshes at k = 128, beside 13
//    GFLOP of FP work (0.19 ms at 67 TFLOP/s); three CTAs an SM (the
//    shared memory's limit) leave few warps to hide the loads.  The
//    registers are capped at 168 for those three CTAs (the reck variant
//    spills 76 bytes there; a cap of 255, two CTAs an SM, was slower).
//  * Reck, in application order, is k - 1 sweeps: sweep c (c = k - 2 down
//    to 0) rotates (c, c + 1), (c + 1, c + 2), ..., (k - 2, k - 1) on
//    consecutive phase slots (core/unitary.py::mesh_spec(k, "reck").pairs).
//    A sweep is stored from wire 8 (c / 8) on, its wires below c as
//    identity rotations (cos 1, sin 0: exact), so it starts on a group of
//    8 wires: the kernel runs the groups g >= c / 8 of one unrolled body of
//    k / 8 groups (constant register indices; a uniform branch a group),
//    each group's 8 (cos, sin) read as four 16-byte loads.  The padding
//    adds 5% of rotations at k = 128.
//  * Clements, k layers alternating even (pairs (0, 1), (2, 3), ...) and
//    odd ((1, 2), (3, 4), ...): two unrolled layer bodies in alternation,
//    their k / 2 and k / 2 - 1 rotations independent of each other.
//  * Each thread stores its own row; in build_unitary's transposed layout
//    (y_rstride 1) neighbouring threads write neighbouring addresses.
// tests/test_torch_mesh_wide.py::unrolled_table mirrors the table's layout
// and the application order for the CPU tests.

#include <utility>

#include "ptc_common.cuh"

namespace {

// --- the narrow route -----------------------------------------------------

enum MeshKind { kClements = 0, kReck = 1 };
constexpr int kNarrowThreads = 256;
constexpr int kNarrowMaxSmem = 96 * 1024;

// the upper wire of rotation t (of K*(K-1)/2) of a (kind, K) mesh in
// application order: clements, layer l's pairs (a, a + 1) for a = l % 2,
// l % 2 + 2, ...; reck, the nulling order (column c, rows K - 1 down to
// c + 1) reversed.  The order of core/unitary.py::mesh_spec(K, kind).pairs.
__host__ __device__ constexpr int pattern_upper(int K, int kind, int t) {
  int n = 0;
  if (kind == kClements) {
    for (int l = 0; l < K; ++l)
      for (int a = l % 2; a < K - 1; a += 2)
        if (n++ == t) return a;
  } else {
    const int T = K * (K - 1) / 2;
    for (int c = 0; c < K - 1; ++c)
      for (int r = K - 1; r > c; --r)
        if (n++ == T - 1 - t) return r - 1;
  }
  return -1;
}

// rows a thread applies its mesh to: two up to K = 9 (each (cos, sin)
// load and the thread's fixed work then serve two rows), one past it
template <int K>
__host__ __device__ constexpr int rows_per_thread() { return K <= 9 ? 2 : 1; }

// rotation I of the pattern on the thread's rows: (cos, sin) of its phase
// slot (I itself where k == K; else the host table's slot, -1 absent)
template <int K, int KIND, bool EXACT, int RPT, int I>
__device__ __forceinline__ void rotate(float (&v)[RPT][K],
                                       const float2* __restrict__ cs,
                                       const int* __restrict__ slot) {
  constexpr int a = pattern_upper(K, KIND, I);
  static_assert(a >= 0 && a + 1 < K, "rotation outside the mesh");
  int t = I;
  if constexpr (!EXACT) {
    t = slot[I];
    if (t < 0) return;
  }
  const float2 r = cs[t];
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const float x0 = v[j][a], x1 = v[j][a + 1];
    v[j][a] = r.x * x0 - r.y * x1;
    v[j][a + 1] = r.y * x0 + r.x * x1;
  }
}

template <int K, int KIND, bool EXACT, int RPT, int... I>
__device__ __forceinline__ void rotate_all(float (&v)[RPT][K],
                                           const float2* __restrict__ cs,
                                           const int* __restrict__ slot,
                                           std::integer_sequence<int, I...>) {
  (rotate<K, KIND, EXACT, RPT, I>(v, cs, slot), ...);
}

// a CTA's shared memory, in floats: (cos, sin) of a group's phases, the
// group's outputs (+ 3 for the span's alignment shift), the phases and
// signs of two groups (the current one and the next), the slot table
struct NarrowSmem {
  int cs, out, ph, dd, slot, total;
  __host__ __device__ NarrowSmem(int G, int rows, int k, int T, int TK,
                                 bool exact) {
    using ptc::pad4;
    cs = 0;
    out = cs + pad4(2 * G * T);
    ph = out + pad4(G * rows * k + 3);
    dd = ph + 2 * pad4(G * T);
    slot = dd + 2 * pad4(G * k);
    total = slot + (exact ? 0 : pad4(TK));
  }
};

// groups of G whole meshes (rows == R) or of `rows` rows of one mesh
// (G == 1); group g = (mesh group g / row_groups, row group g % row_groups).
// Registers are capped at 64 a thread up to K = 16 (four CTAs an SM; the
// uncapped K = 16 pattern under a slot table takes more than 128) and at
// 128 for K = 32.
template <int K, int KIND, bool EXACT>
__global__ void __launch_bounds__(kNarrowThreads, K <= 16 ? 4 : 2)
mesh_apply_kernel(const float* __restrict__ x, long long x_bstride,
                  const float* __restrict__ phases,
                  const float* __restrict__ d,
                  const int* __restrict__ slot_g, float* __restrict__ y,
                  long long y_bstride, long long y_rstride,
                  long long y_wstride, int B, int R, int k, int T, int off,
                  int G, int rows, int row_groups, int groups, int staged) {
  constexpr int TK = K * (K - 1) / 2;
  constexpr int RPT = rows_per_thread<K>();
  extern __shared__ __align__(16) float nsm[];
  const NarrowSmem L(G, rows, EXACT ? K : k, T, TK, EXACT);
  float2* cs = reinterpret_cast<float2*>(nsm + L.cs);
  float* out = nsm + L.out;
  int* slot = reinterpret_cast<int*>(nsm + L.slot);
  const int tid = threadIdx.x;
  if (!EXACT)
    for (int i = tid; i < TK; i += kNarrowThreads) slot[i] = slot_g[i];

  auto stage = [&](int g, int buf) {  // group g's phases and signs
    const long long b0 = (long long)(g / row_groups) * G;
    const int nb = (int)min((long long)G, B - b0);
    float* ph = nsm + L.ph + buf * ptc::pad4(G * T);
    for (int i = tid; i < nb * T; i += kNarrowThreads)
      ptc::cp_async4(ph + i, phases + b0 * T + i, true);
    if (d != nullptr) {
      float* dd = nsm + L.dd + buf * ptc::pad4(G * k);
      for (int i = tid; i < nb * k; i += kNarrowThreads)
        ptc::cp_async4(dd + i, d + b0 * k + i, true);
    }
    ptc::cp_async_commit();
  };

  if ((int)blockIdx.x < groups) stage(blockIdx.x, 0);
  for (int g = blockIdx.x, it = 0; g < groups; g += gridDim.x, ++it) {
    const int buf = it & 1;
    const long long b0 = (long long)(g / row_groups) * G;
    const int r0 = (g % row_groups) * rows;
    const int nb = (int)min((long long)G, B - b0);
    const int nr = min(rows, R - r0);
    if (g + (int)gridDim.x < groups) {
      stage(g + gridDim.x, buf ^ 1);
      ptc::cp_async_wait<1>();
    } else {
      ptc::cp_async_wait<0>();
    }
    __syncthreads();  // group g's phases and signs have landed

    const float* ph = nsm + L.ph + buf * ptc::pad4(G * T);
    for (int i = tid; i < nb * T; i += kNarrowThreads) {
      float sv, cv;
      sincosf(ph[i], &sv, &cv);
      cs[i] = make_float2(cv, sv);
    }
    __syncthreads();

    // the group's outputs are y[s0 ..) of n elements; out[shift + j] holds
    // y[s0 + j], so out and y agree modulo 16 bytes
    const long long s0 = b0 * y_bstride + (long long)r0 * y_rstride;
    const int shift = (int)(s0 & 3);
    // thread (mb, tr) of the tpm threads a mesh: rows tr, tr + tpm, ...
    // of the group's nr (a missing last row recomputes row nr - 1 and
    // stores nothing)
    const int tpm = (nr + RPT - 1) / RPT;
    if (tid < nb * tpm) {
      const int mb = tid / tpm, tr = tid % tpm;
      const long long b = b0 + mb;
      const float* dd = nsm + L.dd + buf * ptc::pad4(G * k) + mb * k;
      float v[RPT][K];
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int r = r0 + min(tr + j * tpm, nr - 1);
        const float* xr = x + b * x_bstride + (long long)r * k;
#pragma unroll
        for (int w = 0; w < K; ++w) {
          const int i = w - off;  // the caller's wire
          float xv = 0.f;
          if (EXACT || (i >= 0 && i < k)) {
            xv = xr[i];
            if (d != nullptr) xv *= dd[i];
          }
          v[j][w] = xv;
        }
      }
      rotate_all<K, KIND, EXACT, RPT>(v, cs + mb * T, slot,
                                      std::make_integer_sequence<int, TK>{});
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        if (tr + j * tpm >= nr) continue;
        const int r = r0 + tr + j * tpm;
        if (staged) {
          float* o = out + shift + mb * y_bstride + (r - r0) * y_rstride;
#pragma unroll
          for (int w = 0; w < K; ++w) {
            const int i = w - off;
            if (EXACT || (i >= 0 && i < k)) o[i * y_wstride] = v[j][w];
          }
        } else {
          float* yr = y + b * y_bstride + (long long)r * y_rstride;
#pragma unroll
          for (int w = 0; w < K; ++w) {
            const int i = w - off;
            if (EXACT || (i >= 0 && i < k)) yr[i * y_wstride] = v[j][w];
          }
        }
      }
    }
    __syncthreads();

    if (staged) {  // float4 where a whole aligned quad lies in the span
      const int n = nb * nr * k;
      float* dst = y + (s0 - shift);
      for (int q = tid; q < (shift + n + 3) / 4; q += kNarrowThreads) {
        const int j0 = 4 * q;
        if (j0 >= shift && j0 + 4 <= shift + n) {
          reinterpret_cast<float4*>(dst)[q] =
              reinterpret_cast<const float4*>(out)[q];
        } else {
          for (int j = j0; j < j0 + 4; ++j)
            if (j >= shift && j < shift + n) dst[j] = out[j];
        }
      }
    }
  }
}

template <int K, int KIND, bool EXACT>
cudaError_t launch_narrow(const float* x, long long x_bstride,
                          const float* phases, const float* d,
                          const int* slot, float* y, long long y_bstride,
                          long long y_rstride, long long y_wstride, int B,
                          int R, int k, int T, int off, cudaStream_t stream) {
  constexpr int TK = K * (K - 1) / 2;
  constexpr int RPT = rows_per_thread<K>();
  auto kern = mesh_apply_kernel<K, KIND, EXACT>;
  const int rows = R < RPT * kNarrowThreads ? R : RPT * kNarrowThreads;
  int G = rows == R ? kNarrowThreads / ((R + RPT - 1) / RPT) : 1;
  while (G > 1 && NarrowSmem(G, rows, k, T, TK, EXACT).total * 4 >
                      kNarrowMaxSmem)
    --G;
  const int smem = NarrowSmem(G, rows, k, T, TK, EXACT).total * 4;
  const int row_groups = (R + rows - 1) / rows;
  const long long groups = (((long long)B + G - 1) / G) * row_groups;
  if (smem > kNarrowMaxSmem || groups > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  // a group's outputs are contiguous (and staged through shared memory)
  // where meshes are dense in y and the group holds whole meshes or rows
  // of k consecutive outputs; y 16-byte aligned for the float4 stores
  const int staged =
      y_bstride == (long long)R * k &&
      (rows == R || (y_rstride == k && y_wstride == 1)) &&
      (reinterpret_cast<uintptr_t>(y) & 15u) == 0;
  static bool smem_set = false;
  static int sms = 0, per_sm = 0, per_sm_smem = -1;
  cudaError_t err;
  if (!smem_set) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kNarrowMaxSmem);
    if (err != cudaSuccess) return err;
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  if (per_sm_smem != smem) {  // resident CTAs an SM at this size
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kNarrowThreads, smem);
    if (err != cudaSuccess) return err;
    per_sm_smem = smem;
  }
  const long long resident = (long long)sms * (per_sm > 1 ? per_sm : 1);
  const long long grid = groups < resident ? groups : resident;
  kern<<<(unsigned)grid, kNarrowThreads, smem, stream>>>(
      x, x_bstride, phases, d, slot, y, y_bstride, y_rstride, y_wstride, B,
      R, k, T, off, G, rows, row_groups, (int)groups, staged);
  return cudaGetLastError();
}

template <int K, int KIND>
cudaError_t launch_narrow_kind(const float* x, long long x_bstride,
                               const float* phases, const float* d,
                               const int* slot, float* y,
                               long long y_bstride, long long y_rstride,
                               long long y_wstride, int B, int R, int k,
                               int T, int off, cudaStream_t stream) {
  if (k == K)
    return launch_narrow<K, KIND, true>(x, x_bstride, phases, d, nullptr, y,
                                        y_bstride, y_rstride, y_wstride, B,
                                        R, k, T, 0, stream);
  if constexpr (K == 9) {
    return cudaErrorInvalidValue;  // k < 9 compiles to 4 or 8
  } else {
    if (slot == nullptr) return cudaErrorInvalidValue;
    return launch_narrow<K, KIND, false>(x, x_bstride, phases, d, slot, y,
                                         y_bstride, y_rstride, y_wstride, B,
                                         R, k, T, off, stream);
  }
}

// rows of one CTA of the wide route: up to 64, as many as fit 96 KB at
// row stride k + 1, a multiple of the 8 warps
constexpr int kWideWarps = 8, kWideRowsPerWarp = 8;
__host__ __device__ inline int wide_rows(int k) {
  int rows = 24576 / (k + 1);
  rows = rows > kWideWarps * kWideRowsPerWarp ? kWideWarps * kWideRowsPerWarp
                                              : rows;
  return rows / kWideWarps * kWideWarps;
}

__global__ void __launch_bounds__(32 * kWideWarps)
mesh_apply_wide_kernel(const float* __restrict__ x, long long x_bstride,
                       const float* __restrict__ phases,
                       const float* __restrict__ d,
                       const int* __restrict__ rot_wire,
                       const int* __restrict__ rot_slot,
                       const int* __restrict__ layer_start,
                       float* __restrict__ y, long long y_bstride,
                       long long y_rstride, long long y_wstride, int R,
                       int k, int T, int L, int rows) {
  extern __shared__ float smem[];
  // two buffers of a layer's rotations: (cos, sin, upper wire) each
  const int sb = 3 * (k / 2 + 1);
  float* rot = smem;                 // [2][k / 2 + 1][3]
  float* v = smem + 2 * sb;          // [rows][k + 1]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long b = blockIdx.x;
  const int r0 = blockIdx.y * rows;
  const int nr = min(rows, R - r0);
  const int ldv = k + 1;
  const float* ph = phases + b * T;

  for (int e = tid; e < nr * k; e += blockDim.x) {
    const int r = e / k, w = e % k;
    float xv = x[b * x_bstride + (long long)(r0 + r) * k + w];
    if (d != nullptr) xv *= d[b * k + w];
    v[r * ldv + w] = xv;
  }
  auto stage = [&](int l, float* buf) {  // layer l's rotations into buf
    const int s0 = layer_start[l], n = layer_start[l + 1] - s0;
    for (int j = tid; j < n; j += blockDim.x) {
      float sv, cv;
      sincosf(ph[rot_slot[s0 + j]], &sv, &cv);
      buf[3 * j] = cv;
      buf[3 * j + 1] = sv;
      buf[3 * j + 2] = __int_as_float(rot_wire[s0 + j]);
    }
  };
  if (L > 0) stage(0, rot);
  __syncthreads();
  for (int l = 0; l < L; ++l) {
    const float* cur = rot + (l & 1) * sb;
    const int n = layer_start[l + 1] - layer_start[l];
    // lane: rotations lane, lane + 32, ..., each read once and applied to
    // the warp's (up to kWideRowsPerWarp) independent rows
    for (int j = lane; j < n; j += 32) {
      const float c = cur[3 * j], s = cur[3 * j + 1];
      const int w = __float_as_int(cur[3 * j + 2]);
#pragma unroll
      for (int i = 0; i < kWideRowsPerWarp; ++i) {
        const int r = warp + kWideWarps * i;
        if (r < nr) {
          float* vr = v + r * ldv;
          const float a = vr[w], bw = vr[w + 1];
          vr[w] = c * a - s * bw;
          vr[w + 1] = s * a + c * bw;
        }
      }
    }
    if (l + 1 < L) stage(l + 1, rot + ((l + 1) & 1) * sb);
    __syncthreads();
  }
  // consecutive threads on consecutive output addresses
  float* yb = y + b * y_bstride + (long long)r0 * y_rstride;
  for (int e = tid; e < nr * k; e += blockDim.x) {
    const int r = y_rstride == 1 ? e % nr : e / k;
    const int w = y_rstride == 1 ? e / nr : e % k;
    yb[(long long)r * y_rstride + (long long)w * y_wstride] = v[r * ldv + w];
  }
}


// --- the unrolled route (k = 64, 128) ---------------------------------------

// rotation (a, a + 1) of one row by r = (cos, sin)
template <int K>
__device__ __forceinline__ void rot(float (&v)[K], int a, float c, float s) {
  const float x0 = v[a], x1 = v[a + 1];
  v[a] = c * x0 - s * x1;
  v[a + 1] = s * x0 + c * x1;
}

// group G of a reck sweep: rotations on wires 8 G .. 8 G + 7 (the last
// group 7: wire K - 1 is no upper wire), their (cos, sin) at cs[0 .. 7]
template <int K, int G>
__device__ __forceinline__ void reck_group(float (&v)[K],
                                           const float4* __restrict__ cs) {
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const float4 r = cs[h];
    rot<K>(v, 8 * G + 2 * h, r.x, r.y);
    if (8 * G + 2 * h + 2 < K) rot<K>(v, 8 * G + 2 * h + 1, r.z, r.w);
  }
}

// one sweep entered at group g0: groups g0 .. K/8 - 1, group G's pairs at
// cs[4 G ..] (cs points at the sweep's start less 4 g0)
template <int K, int... G>
__device__ __forceinline__ void reck_sweep(float (&v)[K],
                                           const float4* __restrict__ cs,
                                           int g0,
                                           std::integer_sequence<int, G...>) {
  ((G >= g0 ? reck_group<K, G>(v, cs + 4 * G) : void()), ...);
}

// the unrolled table's length in (cos, sin) pairs: reck, sweep c from wire
// 8 (c / 8) to k - 1 (k - 1 a pad); clements, k / 2 layer pairs of k
__host__ __device__ constexpr int unrolled_pairs(int K, int kind) {
  int n = 0;
  if (kind == kClements) return K * K / 2;
  for (int c = 0; c < K - 1; ++c) n += K - 8 * (c / 8);
  return n;
}

// Registers: at most 168 a thread at K = 128 (three CTAs an SM, as their
// shared memory allows), 128 at K = 64.
template <int K, int KIND>
__global__ void __launch_bounds__(K, K == 128 ? 3 : 8)
mesh_apply_unrolled_kernel(const float* __restrict__ x, long long x_bstride,
                           const float* __restrict__ phases,
                           const float* __restrict__ d,
                           float* __restrict__ y, long long y_bstride,
                           long long y_rstride, long long y_wstride, int R) {
  constexpr int T = K * (K - 1) / 2;
  extern __shared__ float4 usm[];
  float2* tab = reinterpret_cast<float2*>(usm);
  float* dd = reinterpret_cast<float*>(tab + unrolled_pairs(K, KIND));
  int* spos = reinterpret_cast<int*>(dd + K);  // reck: each sweep's start
  const int tid = threadIdx.x;
  const long long b = blockIdx.x;
  const float* ph = phases + b * T;

  // every phase's (cos, sin) once, into the unrolled layout: a flat loop
  // of independent iterations (unrolled, so each thread keeps several
  // phase loads in flight)
  auto cs_of = [&](int slot) {
    float sv, cv;
    sincosf(ph[slot], &sv, &cv);
    return make_float2(cv, sv);
  };
  if constexpr (KIND == kReck) {
    // sweep i (application order) is c = K - 2 - i, its slots from i (i +
    // 1) / 2, stored from spos[i] on, from wire 8 (c / 8): wires below c
    // identities, wire K - 1 a pad
    if (tid < K - 1) {
      int pos = 0;
      for (int i = 0; i < tid; ++i) pos += K - 8 * ((K - 2 - i) / 8);
      spos[tid] = pos;
    }
    __syncthreads();
    for (int e = tid; e < (K - 1) * 8; e += K) {
      const int i = e / 8, j = e % 8, c = K - 2 - i, lo = 8 * (c / 8);
      if (lo + j < c) tab[spos[i] + j] = make_float2(1.f, 0.f);
      if (j == 0) tab[spos[i] + K - 1 - lo] = make_float2(1.f, 0.f);
    }
#pragma unroll 8
    for (int t = tid; t < T; t += K) {
      // t's sweep: the i with i (i + 1) / 2 <= t < (i + 1) (i + 2) / 2
      int i = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
      i += (i + 1) * (i + 2) / 2 <= t;
      i -= i * (i + 1) / 2 > t;
      const int c = K - 2 - i, lo = 8 * (c / 8);
      tab[spos[i] + c + t - i * (i + 1) / 2 - lo] = cs_of(t);
    }
  } else {
    // layer pair m: the even layer's K/2 pairs, then the odd layer's K/2 -
    // 1 and a pad; pair w of the two sits at slot m (K - 1) + w
#pragma unroll 8
    for (int i = tid; i < K * K / 2; i += K) {
      const int m = i / K, w = i % K;
      tab[i] = w < K - 1 ? cs_of(m * (K - 1) + w) : make_float2(1.f, 0.f);
    }
  }
  if (d != nullptr && tid < K) dd[tid] = d[b * K + tid];
  __syncthreads();

  const int r = blockIdx.y * K + tid;
  if (r >= R) return;
  float v[K];
  const float* xr = x + b * x_bstride + (long long)r * K;
#pragma unroll
  for (int w = 0; w < K; ++w) v[w] = xr[w];
  if (d != nullptr) {
#pragma unroll
    for (int w = 0; w < K; ++w) v[w] *= dd[w];
  }

  if constexpr (KIND == kReck) {
    for (int i = 0; i < K - 1; ++i) {
      const int g0 = (K - 2 - i) / 8;
      reck_sweep<K>(v,
                    reinterpret_cast<const float4*>(tab + spos[i]) - 4 * g0,
                    g0, std::make_integer_sequence<int, K / 8>{});
    }
  } else {
    const float4* cs = usm;
    for (int m = 0; m < K / 2; ++m, cs += K / 2) {
#pragma unroll
      for (int h = 0; h < K / 4; ++h) {  // even layer: (4h, +1), (4h+2, +3)
        const float4 rr = cs[h];
        rot<K>(v, 4 * h, rr.x, rr.y);
        rot<K>(v, 4 * h + 2, rr.z, rr.w);
      }
#pragma unroll
      for (int h = 0; h < K / 4; ++h) {  // odd layer: (4h+1, +2), (4h+3, +4)
        const float4 rr = cs[K / 4 + h];
        rot<K>(v, 4 * h + 1, rr.x, rr.y);
        if (4 * h + 4 < K) rot<K>(v, 4 * h + 3, rr.z, rr.w);
      }
    }
  }

  float* yr = y + b * y_bstride + (long long)r * y_rstride;
#pragma unroll
  for (int w = 0; w < K; ++w) yr[w * y_wstride] = v[w];
}

template <int K, int KIND>
cudaError_t launch_unrolled(const float* x, long long x_bstride,
                            const float* phases, const float* d, float* y,
                            long long y_bstride, long long y_rstride,
                            long long y_wstride, int B, int R,
                            cudaStream_t stream) {
  auto kern = mesh_apply_unrolled_kernel<K, KIND>;
  const int smem = (int)(sizeof(float2) * unrolled_pairs(K, KIND) +
                         (sizeof(float) + sizeof(int)) * K);
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  kern<<<dim3((unsigned)B, (unsigned)((R + K - 1) / K)), K, smem, stream>>>(
      x, x_bstride, phases, d, y, y_bstride, y_rstride, y_wstride, R);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// The narrow route, k <= 32: x: (B or 1, R, k) fp32 rows, batch stride
// x_bstride (0 = shared by all meshes); phases: (B, T) fp32; d: (B, k)
// fp32 or null; y[b, r, w] at b*y_bstride + r*y_rstride + w*y_wstride;
// kind 0 clements, 1 reck.  k in 4, 8, 9, 16, 32 runs its own pattern
// (slot null, off 0); any other k the pattern of the next of those, K,
// with slot (K*(K-1)/2,) int32 the phase slot of each of its rotations
// (-1 where the k mesh has none) and off the first of K's wires that the
// k mesh uses (kernels/mesh_apply.py::narrow_plan).
extern "C" int mesh_apply_f32(const float* x, long long x_bstride,
                              const float* phases, const float* d,
                              const int* slot, float* y, long long y_bstride,
                              long long y_rstride, long long y_wstride,
                              int B, int R, int k, int T, int kind, int off,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kk = ptc::kernel_k(k);
  if (kk == 0 || k < 2 || T != k * (k - 1) / 2 || B < 1 || R < 1 ||
      off < 0 || off + k > kk || (kind != kClements && kind != kReck))
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_NARROW(KK)                                                      \
  return static_cast<int>(                                                   \
      kind == kClements                                                      \
          ? launch_narrow_kind<KK, kClements>(x, x_bstride, phases, d, slot, \
                                              y, y_bstride, y_rstride,       \
                                              y_wstride, B, R, k, T, off, s) \
          : launch_narrow_kind<KK, kReck>(x, x_bstride, phases, d, slot, y,  \
                                          y_bstride, y_rstride, y_wstride,   \
                                          B, R, k, T, off, s))
  switch (kk) {
    case 4: REPRO_NARROW(4);
    case 8: REPRO_NARROW(8);
    case 9: REPRO_NARROW(9);
    case 16: REPRO_NARROW(16);
    default: REPRO_NARROW(32);
  }
#undef REPRO_NARROW
}

// The wide route, any k >= 2: rot_wire / rot_slot (T,) int32, each
// rotation's upper wire and phase slot in layer order; layer_start (L + 1,)
// int32.  Other arguments as mesh_apply_f32.
extern "C" int mesh_apply_wide_f32(const float* x, long long x_bstride,
                                   const float* phases, const float* d,
                                   const int* rot_wire, const int* rot_slot,
                                   const int* layer_start, float* y,
                                   long long y_bstride, long long y_rstride,
                                   long long y_wstride, int B, int R, int k,
                                   int T, int L, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = wide_rows(k);
  if (rows < kWideWarps || B < 1 || R < 1 || (R + rows - 1) / rows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (6 * (size_t)(k / 2 + 1) +
                                       (size_t)rows * (k + 1));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mesh_apply_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B, (R + rows - 1) / rows);
  mesh_apply_wide_kernel<<<grid, 32 * kWideWarps, smem, s>>>(
      x, x_bstride, phases, d, rot_wire, rot_slot, layer_start, y, y_bstride,
      y_rstride, y_wstride, R, k, T, L, rows);
  return static_cast<int>(cudaGetLastError());
}

// The unrolled route, k = 64 and 128: arguments as mesh_apply_f32 (no slot
// table, no offset).
extern "C" int mesh_apply_unrolled_f32(const float* x, long long x_bstride,
                                       const float* phases, const float* d,
                                       float* y, long long y_bstride,
                                       long long y_rstride,
                                       long long y_wstride, int B, int R,
                                       int k, int T, int kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((k != 64 && k != 128) || T != k * (k - 1) / 2 || B < 1 || R < 1 ||
      (R + k - 1) / k > 65535 || (kind != kClements && kind != kReck))
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_UNROLLED(KK)                                                  \
  return static_cast<int>(                                                 \
      kind == kClements                                                    \
          ? launch_unrolled<KK, kClements>(x, x_bstride, phases, d, y,     \
                                           y_bstride, y_rstride,           \
                                           y_wstride, B, R, s)             \
          : launch_unrolled<KK, kReck>(x, x_bstride, phases, d, y,         \
                                       y_bstride, y_rstride, y_wstride, B, \
                                       R, s))
  if (k == 64) REPRO_UNROLLED(64);
  REPRO_UNROLLED(128);
#undef REPRO_UNROLLED
}
