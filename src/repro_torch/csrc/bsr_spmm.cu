// BSR SpMM over a packed x of 1-3 bn-aligned segments, rank-batched.
//
// Replaces three Pallas TPU kernels, all instances of the one template
// below:
//   * src/repro/kernels/bsr_spmv/fused.py fused_bsr_spmm_packed (body
//     _make_packed_kernel: up to three segments) -> fused_bsr_spmm_f32;
//   * src/repro/kernels/bsr_spmv/fused.py fused_bsr_spmm (_fused_kernel:
//     one concatenated x) -> fused_bsr_spmm_f32 with one segment;
//   * src/repro/kernels/bsr_spmv/kernel.py bsr_spmm_padded (the unfused
//     padded-uniform BSR SpMM of one matrix) -> bsr_spmm_padded_f32, one
//     segment and one rank.
// For every rank r and block row i:
//
//     w[r, i] = sum_k blocks[r, i, k] @ X_r[cols[r, i, k]]
//
// with blocks (bm, bn), X_r the block columns [bn, nv] of the rank's
// segments taken in order, and padding slots (col -1) carrying zero
// blocks, which the kernel skips: it reads neither their block nor an x
// block.  The segment is picked by comparing the block column with the
// segment bounds, so the concatenated x is never materialised; the
// arithmetic does not depend on the segment count, so the packed and the
// concatenated calls are bit-equal.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): bytes.  Each (8, 128)
// block is 4 KB read for 2 * 8 * 128 * nv flops, 1/2 flop per byte at
// nv = 1.  The live blocks dominate every other operand: for
// bsr_spmm_padded on the 2024 x 2024 rotated anisotropic stencil with
// (8, 128) blocks, 1,726,916 live blocks (7.07 GB) of 512,072 x 4 slots
// (8.39 GB with padding), so >= 2.12 ms, against >= 2.52 ms for a kernel
// that also read the padding.
//
// Design: one thread block per (block row, tile of kNvTile rhs columns,
// rank), rank on grid axis z; one warp per block-matrix row m (a warp
// takes rows m, m + 8, ... up to bm = 128).  Lane l takes elements
// j = l, l + 32, ... of the bn axis, so every warp reads a block row as
// contiguous 128-byte lines and the x block with unit stride at nv = 1
// (at bn = 8 lanes 8-31 idle).  Each lane keeps kNvTile f32 partial sums
// in registers across all ktot slots (slot order), then a shuffle tree
// sums the 32 lanes.  CUDA-core FMAs; the (8, 128) shape does not fill a
// tensor-core tile.  Every offset is 64-bit: 8.39 GB of blocks is 2.1e9
// floats, and (128, 128) blocks pass 2^31 floats sooner.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kNvTile = 8;

template <int NSEG>
__global__ void fused_bsr_kernel(const int* __restrict__ cols,
                                 const float* __restrict__ blocks,
                                 const float* __restrict__ x0,
                                 const float* __restrict__ x1,
                                 const float* __restrict__ x2,
                                 long long nb0, long long nb1, long long nb2,
                                 float* __restrict__ out, int n_brows,
                                 int ktot, int bm, int bn, int nv) {
  const long long rank = blockIdx.z;
  const long long brow = (long long)rank * n_brows + blockIdx.x;
  const int v0 = blockIdx.y * kNvTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int* crow = cols + brow * ktot;
  const long long blk_elems = (long long)bm * bn;
  const long long xblk_elems = (long long)bn * nv;
  const float* xs0 = x0 + rank * nb0 * xblk_elems;
  const float* xs1 = x1 + rank * nb1 * xblk_elems;
  const float* xs2 = x2 + rank * nb2 * xblk_elems;

  for (int m = warp; m < bm; m += kWarps) {
    float acc[kNvTile];
#pragma unroll
    for (int t = 0; t < kNvTile; ++t) acc[t] = 0.0f;
    for (int k = 0; k < ktot; ++k) {
      const long long c = crow[k];
      if (c < 0) continue;  // padding slot: a zero block
      const float* xb;
      if (NSEG == 1 || c < nb0) {
        xb = xs0 + c * xblk_elems;
      } else if (NSEG == 2 || c < nb0 + nb1) {
        xb = xs1 + (c - nb0) * xblk_elems;
      } else {
        xb = xs2 + (c - nb0 - nb1) * xblk_elems;
      }
      const float* a = blocks + (brow * ktot + k) * blk_elems + (long long)m * bn;
      for (int j = lane; j < bn; j += 32) {
        const float aj = a[j];
        const float* xr = xb + (long long)j * nv + v0;
#pragma unroll
        for (int t = 0; t < kNvTile; ++t) {
          if (v0 + t < nv) acc[t] = fmaf(aj, xr[t], acc[t]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kNvTile; ++t) {
      float s = acc[t];
      for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
      acc[t] = s;
    }
    if (lane == 0) {
      float* o = out + (brow * bm + m) * (long long)nv + v0;
#pragma unroll
      for (int t = 0; t < kNvTile; ++t) {
        if (v0 + t < nv) o[t] = acc[t];
      }
    }
  }
}

}  // namespace

extern "C" int fused_bsr_spmm_f32(const int* cols, const float* blocks,
                                  const float* x0, const float* x1,
                                  const float* x2, long long nb0,
                                  long long nb1, long long nb2, int nseg,
                                  float* out, int n_procs, int n_brows,
                                  int ktot, int bm, int bn, int nv,
                                  void* stream) {
  if (n_procs == 0 || n_brows == 0 || nv == 0) return (int)cudaGetLastError();
  dim3 grid((unsigned)n_brows, (unsigned)((nv + kNvTile - 1) / kNvTile),
            (unsigned)n_procs);
  dim3 block(32 * kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nseg) {
    case 1:
      fused_bsr_kernel<1><<<grid, block, 0, s>>>(
          cols, blocks, x0, x1, x2, nb0, nb1, nb2, out, n_brows, ktot, bm, bn, nv);
      break;
    case 2:
      fused_bsr_kernel<2><<<grid, block, 0, s>>>(
          cols, blocks, x0, x1, x2, nb0, nb1, nb2, out, n_brows, ktot, bm, bn, nv);
      break;
    case 3:
      fused_bsr_kernel<3><<<grid, block, 0, s>>>(
          cols, blocks, x0, x1, x2, nb0, nb1, nb2, out, n_brows, ktot, bm, bn, nv);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int bsr_spmm_padded_f32(const int* cols, const float* blocks,
                                   const float* x, long long n_bcols,
                                   float* out, int n_brows, int kmax, int bm,
                                   int bn, int nv, void* stream) {
  return fused_bsr_spmm_f32(cols, blocks, x, x, x, n_bcols, 0, 0, 1, out, 1,
                            n_brows, kmax, bm, bn, nv, stream);
}
