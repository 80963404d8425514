// Paged KV-cache page assembly for the serving gateway: gather and scatter.
//
// Replaces the TPU kernels repro/kernels/paged_kv.py::paged_gather and
// ::paged_scatter (which also serves ::paged_scatter_rows), dispatched by
// repro/kernels/ops.py.
//
//   gather:  table (B, J) int32, pages (n_pages, ps, d)  ->  out (B, J*ps, d),
//            out[b, j*ps:(j+1)*ps] = pages[table[b, j]]: an exact copy.
//   scatter: idx (R, 2) int32 of (page, offset), rows (R, d), pages updated
//            in place: pages[idx[r, 0], idx[r, 1]] = rows[r].
//
// Both kernels move bytes and compute nothing, so the element type does not
// matter: they copy in units of `V` (16, 8, 4, 2 or 1 bytes), the widest one
// that divides the page (row) size and both base addresses; the wrapper
// picks it.  What bounds them on an H100: device memory, read once and
// written once (gather: 2 x view bytes; scatter: the rows read and the
// winning rows written).
//
// Design:
//  * gather: one CTA per (row of the table, page slot).  The TPU version has
//    the page id prefetched as a scalar so the index map can address the
//    page before the body runs; here the CTA reads its id first and copies
//    the page's ps*d elements as 16-byte vectors (one 32 KB page per CTA at
//    the gateway's ps 16, d 1024, bf16).
//  * scatter: the Pallas grid runs one row after another, so rows with the
//    same target resolve LAST-WINS.  The gateway depends on that: every idle
//    slot's row and every padding column land on one scratch page, at offset
//    0.  GPU blocks run in no order, so the port resolves the winner
//    explicitly in two passes: (1) each row atomicMax-es its index into an
//    int32 "winner" entry per (page, offset), set to -1 first; (2) one warp
//    per row copies it only if it is its target's winner.  The result is
//    the reference's bits, scratch page included, on every run.
//  * A page id or offset outside the pool is a caller's bug: the kernel
//    stops the launch with __trap() (the next synchronising call raises a
//    CUDA error, and the context is lost), as the plain versions raise an
//    IndexError; it never reads or writes out of bounds, and never drops a
//    write or fills a page with zeros in silence.
//  * Launch on the caller's stream, allocate nothing (the wrapper passes the
//    winner buffer), return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const int* __restrict__ table, const V* __restrict__ pages,
              V* __restrict__ out, int n_pages, long long page_vecs) {
  const long long cell = blockIdx.x;  // row * J + j
  const int pid = table[cell];
  if (pid < 0 || pid >= n_pages) __trap();
  V* dst = out + cell * page_vecs;
  const V* src = pages + (long long)pid * page_vecs;
  for (long long i = threadIdx.x; i < page_vecs; i += kThreads) dst[i] = src[i];
}

__device__ __forceinline__ long long target_of(const int* idx, long long r,
                                               int n_pages, int ps) {
  const int pid = idx[2 * r], off = idx[2 * r + 1];
  if (pid < 0 || pid >= n_pages || off < 0 || off >= ps) __trap();
  return (long long)pid * ps + off;
}

__global__ void __launch_bounds__(kThreads)
claim_kernel(const int* __restrict__ idx, int* __restrict__ winner, int R,
             int n_pages, int ps) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  atomicMax(winner + target_of(idx, r, n_pages, ps), (int)r);
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
write_kernel(const int* __restrict__ idx, const V* __restrict__ rows,
             V* __restrict__ pages, const int* __restrict__ winner, int R,
             int n_pages, int ps, long long row_vecs) {
  const long long r = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= R) return;
  const long long t = target_of(idx, r, n_pages, ps);
  if (winner[t] != (int)r) return;
  const V* src = rows + r * row_vecs;
  V* dst = pages + t * row_vecs;
  for (long long i = lane; i < row_vecs; i += 32) dst[i] = src[i];
}

template <typename V>
cudaError_t gather(const void* table, const void* pages, void* out, int rows,
                   int J, int n_pages, long long vecs, cudaStream_t st) {
  gather_kernel<V><<<(unsigned)((long long)rows * J), kThreads, 0, st>>>(
      static_cast<const int*>(table), static_cast<const V*>(pages),
      static_cast<V*>(out), n_pages, vecs);
  return cudaGetLastError();
}

template <typename V>
cudaError_t scatter(const void* idx, const void* rows, void* pages,
                    void* winner, int R, int n_pages, int ps, long long vecs,
                    cudaStream_t st) {
  const int* ix = static_cast<const int*>(idx);
  int* win = static_cast<int*>(winner);
  cudaError_t err = cudaMemsetAsync(
      win, 0xff, sizeof(int) * (size_t)n_pages * (size_t)ps, st);  // -1
  if (err != cudaSuccess) return err;
  claim_kernel<<<(R + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      ix, win, R, n_pages, ps);
  const int per_cta = kThreads / 32;
  write_kernel<V><<<(R + per_cta - 1) / per_cta, kThreads, 0, st>>>(
      ix, static_cast<const V*>(rows), static_cast<V*>(pages), win, R,
      n_pages, ps, vecs);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// page_bytes = ps * d * element size; vec_bytes in {16, 8, 4, 2, 1} divides
// it and both base addresses.
extern "C" int paged_gather(const void* table, const void* pages, void* out,
                            int rows, int J, int n_pages, long long page_bytes,
                            int vec_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long vecs = page_bytes / vec_bytes;
  cudaError_t err;
  switch (vec_bytes) {
    case 16: err = gather<uint4>(table, pages, out, rows, J, n_pages, vecs, st); break;
    case 8: err = gather<uint2>(table, pages, out, rows, J, n_pages, vecs, st); break;
    case 4: err = gather<uint32_t>(table, pages, out, rows, J, n_pages, vecs, st); break;
    case 2: err = gather<uint16_t>(table, pages, out, rows, J, n_pages, vecs, st); break;
    case 1: err = gather<uint8_t>(table, pages, out, rows, J, n_pages, vecs, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// row_bytes = d * element size; vec_bytes divides it and both base
// addresses.  winner: (n_pages * ps) int32 scratch.
extern "C" int paged_scatter(const void* idx, const void* rows, void* pages,
                             void* winner, int R, int n_pages, int ps,
                             long long row_bytes, int vec_bytes,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long vecs = row_bytes / vec_bytes;
  cudaError_t err;
  switch (vec_bytes) {
    case 16: err = scatter<uint4>(idx, rows, pages, winner, R, n_pages, ps, vecs, st); break;
    case 8: err = scatter<uint2>(idx, rows, pages, winner, R, n_pages, ps, vecs, st); break;
    case 4: err = scatter<uint32_t>(idx, rows, pages, winner, R, n_pages, ps, vecs, st); break;
    case 2: err = scatter<uint16_t>(idx, rows, pages, winner, R, n_pages, ps, vecs, st); break;
    case 1: err = scatter<uint8_t>(idx, rows, pages, winner, R, n_pages, ps, vecs, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
