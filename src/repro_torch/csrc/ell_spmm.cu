// ELL (padded-row) SpMM over a packed x of 1-3 segments, rank-batched.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ell_spmv/kernel.py
// (ell_spmm_packed, body _ell_kernel).  For every rank r, row i, column c:
//
//     out[r, i, c] = sum_k vals[r, i, k] * X_r[max(cols[r, i, k], 0), c]
//
// where X_r is the concatenation of the rank's segments x_s[r] ([len_s, nv]
// each) and is never materialised: the column id picks its segment by
// comparing with the segment bounds.  Padding slots (col -1, val 0) are
// inert.  Slots are summed in order k = 0..kmax-1 in f32 (fmaf).
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): bytes.  Each slot
// costs 8 bytes of cols+vals and 2 flops per rhs column, 1/4 flop per byte
// at nv = 1.  At the main path's shapes (512 ranks, rows 8064, kmax 9,
// segments 8064/4096/2048, nv = 1) cols+vals are 297 MB, x 29 MB and the
// output 16.5 MB: ~343 MB, >= 0.10 ms.  The transpose shape (rows 14208,
// one segment of 8064) moves ~570 MB, >= 0.17 ms.
//
// Design: one thread per (rank, row, rhs column), rank on grid axis y, the
// rhs column fastest within a row so that the nv threads of a row read the
// same cols/vals words (one broadcast) and neighbouring x entries.  No
// shared memory: each input byte is needed once, and the gathered x rows
// (29 MB at nv = 1) are left to L2.  Ragged nv needs no padding.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int NSEG>
__global__ void ell_spmm_kernel(const int* __restrict__ cols,
                                const float* __restrict__ vals,
                                const float* __restrict__ x0,
                                const float* __restrict__ x1,
                                const float* __restrict__ x2,
                                long long len0, long long len1, long long len2,
                                float* __restrict__ out,
                                int n_rows, int kmax, int nv) {
  const long long rank = blockIdx.y;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n_rows * nv) return;
  const long long row = t / nv;
  const int c = (int)(t - row * nv);
  const long long base = (rank * n_rows + row) * kmax;
  const float* xr0 = x0 + rank * len0 * nv + c;
  const float* xr1 = x1 + rank * len1 * nv + c;
  const float* xr2 = x2 + rank * len2 * nv + c;
  float acc = 0.0f;
  for (int k = 0; k < kmax; ++k) {
    long long col = cols[base + k];
    col = col < 0 ? 0 : col;
    float xv;
    if (NSEG == 1 || col < len0) {
      xv = xr0[col * nv];
    } else if (NSEG == 2 || col < len0 + len1) {
      xv = xr1[(col - len0) * nv];
    } else {
      xv = xr2[(col - len0 - len1) * nv];
    }
    acc = fmaf(vals[base + k], xv, acc);
  }
  out[(rank * n_rows + row) * nv + c] = acc;
}

}  // namespace

extern "C" int ell_spmm_packed_f32(const int* cols, const float* vals,
                                   const float* x0, const float* x1,
                                   const float* x2, long long len0,
                                   long long len1, long long len2, int nseg,
                                   float* out, int n_procs, int n_rows,
                                   int kmax, int nv, void* stream) {
  const long long work = (long long)n_rows * nv;
  if (work == 0 || n_procs == 0) return (int)cudaGetLastError();
  dim3 grid((unsigned)((work + kThreads - 1) / kThreads), (unsigned)n_procs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nseg) {
    case 1:
      ell_spmm_kernel<1><<<grid, kThreads, 0, s>>>(
          cols, vals, x0, x1, x2, len0, len1, len2, out, n_rows, kmax, nv);
      break;
    case 2:
      ell_spmm_kernel<2><<<grid, kThreads, 0, s>>>(
          cols, vals, x0, x1, x2, len0, len1, len2, out, n_rows, kmax, nv);
      break;
    case 3:
      ell_spmm_kernel<3><<<grid, kThreads, 0, s>>>(
          cols, vals, x0, x1, x2, len0, len1, len2, out, n_rows, kmax, nv);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
