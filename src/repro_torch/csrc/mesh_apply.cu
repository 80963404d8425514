// Block-batched MZI mesh application  y = U(phi_b, d_b) x  for many meshes.
//
// Replaces the TPU kernel repro/kernels/mesh_apply.py::mesh_apply_butterfly
// together with its coefficient-table pass repro/kernels/ops.py::_coeff_tables.
// The TPU kernel applies ONE mesh to many rows; here every mesh b of a batch
// has its own phases (B, T) and sign diagonal (B, k), which is what building
// the realized unitaries of every block in Identity Calibration and Parallel
// Mapping needs (each ZO probe rebuilds U and V of every block).
//
// What bounds it on an H100: the work is tiny per byte and per launch.  For
// build_unitary at k = 9 each mesh reads T = 36 phases and 9 signs and writes
// 81 outputs, and does 36 sincos + 9*36*4 FMAs; 52k meshes per IC probe are a
// few MB of traffic, so the kernel is bound by device-memory bytes (and, at
// these sizes, by launch latency) rather than by arithmetic.
//
// Design:
//  * One thread per row (mesh b, row r) with the row's k wires in registers
//    (template K >= k, wires >= k idle).  The adjacent-wire exchange of a
//    layer is then a register move: no shuffles, no shared-memory traffic.
//    One lane per wire with __shfl_sync was the alternative; k = 9 (the
//    paper's block size) fills 9 of 32 lanes, so rows would have to be packed
//    three to a warp with segmented shuffles, and each layer would still pay
//    a shuffle per wire.  Registers cost nothing per layer.
//  * cos/sin are computed in the kernel (sincosf, full precision: phases
//    carry an unknown bias up to 2*pi plus quantization) once per (mesh,
//    phase) into shared memory and shared by the mesh's rows, replacing the
//    separate table pass.  Each rotation reads its (cos, sin) pair once and
//    updates both of its wires, so the per-wire sign table is not needed:
//    the host passes, per layer and wire, the phase slot of the rotation
//    whose UPPER wire it is (-1 otherwise).
//  * A block covers several meshes and a range of rows, so that build_unitary
//    (9 rows per mesh) still fills 252 of 256 threads.
//  * x may be broadcast over meshes (batch stride 0): build_unitary applies
//    every mesh to one shared identity without copying it per mesh.  The
//    output strides are free, so build_unitary writes U transposed in place.
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
// the phase count.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBytes = 48 * 1024;

template <int K>
__global__ void __launch_bounds__(kThreads)
mesh_apply_kernel(const float* __restrict__ x, long long x_bstride,
                  const float* __restrict__ phases,
                  const float* __restrict__ d,
                  const int* __restrict__ up_slot,
                  float* __restrict__ y, long long y_bstride,
                  long long y_rstride, long long y_wstride,
                  int B, int R, int k, int T, int L,
                  int meshes_per_block, int rows_per_block) {
  extern __shared__ float smem[];
  float* cs = smem;                                         // [mpb][T][2]
  int* up = reinterpret_cast<int*>(smem + 2 * meshes_per_block * T);  // [L][K]

  const int b0 = blockIdx.x * meshes_per_block;
  const int r0 = blockIdx.y * rows_per_block;
  const int nb = min(meshes_per_block, B - b0);
  const int nr = min(rows_per_block, R - r0);

  for (int i = threadIdx.x; i < L * K; i += blockDim.x) {
    const int l = i / K, w = i % K;
    up[i] = (w < k) ? up_slot[l * k + w] : -1;
  }
  for (int i = threadIdx.x; i < nb * T; i += blockDim.x) {
    float sv, cv;
    sincosf(phases[(long long)b0 * T + i], &sv, &cv);
    cs[2 * i] = cv;
    cs[2 * i + 1] = sv;
  }
  __syncthreads();

  for (int item = threadIdx.x; item < nb * nr; item += blockDim.x) {
    const int mb = item / nr;
    const int r = r0 + item % nr;
    const long long b = b0 + mb;
    const float* xr = x + b * x_bstride + (long long)r * k;
    const float* db = d != nullptr ? d + b * k : nullptr;
    float v[K];
#pragma unroll
    for (int w = 0; w < K; ++w) {
      float xv = 0.f;
      if (w < k) {
        xv = xr[w];
        if (db != nullptr) xv *= db[w];
      }
      v[w] = xv;
    }
    const float* csb = cs + 2 * mb * T;
    for (int l = 0; l < L; ++l) {
#pragma unroll
      for (int w = 0; w < K - 1; ++w) {
        const int t = up[l * K + w];
        if (t >= 0) {
          const float c = csb[2 * t], s = csb[2 * t + 1];
          const float a = v[w], bw = v[w + 1];
          v[w] = c * a - s * bw;
          v[w + 1] = s * a + c * bw;
        }
      }
    }
    float* yr = y + b * y_bstride + (long long)r * y_rstride;
#pragma unroll
    for (int w = 0; w < K; ++w) {
      if (w < k) yr[w * y_wstride] = v[w];
    }
  }
}

template <int K>
cudaError_t launch(const float* x, long long x_bstride, const float* phases,
                   const float* d, const int* up_slot, float* y,
                   long long y_bstride, long long y_rstride,
                   long long y_wstride, int B, int R, int k, int T, int L,
                   cudaStream_t stream) {
  const int rows_per_block = R < kThreads ? R : kThreads;
  int meshes_per_block = kThreads / rows_per_block;
  const int table_bytes = L * K * (int)sizeof(int);
  const int max_meshes = (kSmemBytes - table_bytes) / (2 * T * (int)sizeof(float));
  if (meshes_per_block > max_meshes) meshes_per_block = max_meshes;
  if (meshes_per_block < 1) meshes_per_block = 1;
  const dim3 grid((B + meshes_per_block - 1) / meshes_per_block,
                  (R + rows_per_block - 1) / rows_per_block);
  const size_t smem = 2 * (size_t)meshes_per_block * T * sizeof(float) + table_bytes;
  mesh_apply_kernel<K><<<grid, kThreads, smem, stream>>>(
      x, x_bstride, phases, d, up_slot, y, y_bstride, y_rstride, y_wstride,
      B, R, k, T, L, meshes_per_block, rows_per_block);
  return cudaGetLastError();
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

}  // namespace

extern "C" const char* repro_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// x: (B or 1, R, k) fp32 rows, batch stride x_bstride (0 = shared by all
// meshes); phases: (B, T) fp32; d: (B, k) fp32 or null; up_slot: (L, k)
// int32; y[b, r, w] at b*y_bstride + r*y_rstride + w*y_wstride.
extern "C" int mesh_apply_f32(const float* x, long long x_bstride,
                              const float* phases, const float* d,
                              const int* up_slot, float* y,
                              long long y_bstride, long long y_rstride,
                              long long y_wstride, int B, int R, int k, int T,
                              int L, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_MESH_LAUNCH(KK)                                                 \
  return static_cast<int>(launch<KK>(x, x_bstride, phases, d, up_slot, y,    \
                                      y_bstride, y_rstride, y_wstride, B, R,  \
                                      k, T, L, s))
  if (k <= 4) REPRO_MESH_LAUNCH(4);
  if (k <= 8) REPRO_MESH_LAUNCH(8);
  if (k == 9) REPRO_MESH_LAUNCH(9);
  if (k <= 16) REPRO_MESH_LAUNCH(16);
  if (k <= 32) REPRO_MESH_LAUNCH(32);
#undef REPRO_MESH_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
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
