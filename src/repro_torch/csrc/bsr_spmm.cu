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
// segments taken in order, and padding slots (col -1, anywhere in the
// row) carrying zero blocks, which the kernel skips: it reads neither
// their block nor an x block.  The segment is picked by comparing the
// block column with the segment bounds, so the concatenated x is never
// materialised; the arithmetic does not depend on the segment count, so
// the packed and the concatenated calls are bit-equal.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): bytes.  Each (8, 128)
// block is 4 KB read for 2 * 8 * 128 * nv flops: 1/2 flop per byte at
// nv = 1 and 4 at nv = 8, far below the f32 ridge of ~20, so tensor cores
// would not help, and TF32 would break the f32 results: the products are
// f32 FMAs on the CUDA cores.  The live blocks dominate every other
// operand: for bsr_spmm_padded on the 2024 x 2024 rotated anisotropic
// stencil with (8, 128) blocks, 1,726,916 live blocks (7.07 GB) of
// 512,072 x 4 slots (8.39 GB with padding), so >= 2.12 ms.
//
// Design:
//   * Work unit.  One warp owns an 8-row band of one (rank, block row)
//     and one tile of T rhs columns (T = 1 at nv = 1, else 4), across all
//     of the row's live slots.  At bm = 8 the band is the whole block row;
//     at bm = 128 sixteen warps share the row.
//   * Loads.  Lane l reads columns 4l .. 4l + 3 of the band's 8 rows as
//     16-byte vectors (at bn = 128 one warp-wide load is a 512-byte row of
//     the block), streamed with evict-first since each is read once, and
//     its x values of the slot once, through the read-only path, reused
//     over the 8 rows.  x (16 MB at n = 2024) stays in the 50 MB L2.
//   * Sums.  The band's 8 x T partial sums stay in registers across all
//     slots; one shuffle butterfly per unit at the end.
//   * Bytes in flight.  The warp reads 32 column ids in one coalesced load
//     and takes the live mask with a ballot; it issues the next live
//     slot's loads before the FMAs of the current one, and loads the next
//     unit's ids while the current unit runs.
//   * Grid.  Sized to the card (SMs x resident blocks of 8 warps); each
//     warp walks one contiguous range of units, so no block is launched
//     per block row.  Not a stride of the warp count: at n = 512 that
//     stride is a multiple of the 64 block rows of a rank, and the rows
//     with 6 live slots all fell to the same warps (1.9x the mean work).
//   * Ragged shapes.  Rows past bm and columns past bn are masked; bn not
//     a multiple of 4 takes the same kernel with 4-byte loads (VEC = 1).
//     The 16-byte loads need 16-byte aligned blocks and x, which the
//     Python wrappers check.
//   * Offsets are 64-bit throughout: 8.39 GB of blocks is 2.1e9 floats,
//     and (128, 128) blocks pass 2^31 floats sooner.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBand = 8;  // block-matrix rows a warp owns
constexpr unsigned kAll = 0xffffffffu;

// VEC consecutive floats, streamed (block entries, read once).
template <int VEC>
__device__ __forceinline__ void load_stream(float (&d)[VEC], const float* p) {
  if constexpr (VEC == 4) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  } else {
    d[0] = __ldcs(p);
  }
}

// VEC consecutive floats through the read-only path (x, reread by the
// other rows and bands that use the same block column).
template <int VEC>
__device__ __forceinline__ void load_ro(float (&d)[VEC], const float* p) {
  if constexpr (VEC == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  } else {
    d[0] = __ldg(p);
  }
}

// One step of a unit: a live slot's band (this lane's columns of its 8
// rows) and the matching x values.
template <int VEC, int T>
struct Stage {
  float a[kBand][VEC];
  float x[T][VEC];
};

template <int VEC, int T>
__global__ void __launch_bounds__(kThreads, T == 1 ? 2 : 1)
bsr_band_kernel(const int* __restrict__ cols, const float* __restrict__ blocks,
                const float* __restrict__ x0, const float* __restrict__ x1,
                const float* __restrict__ x2, long long nb0, long long nb1,
                long long nb2, float* __restrict__ out, long long n_units,
                int n_brows, int ktot, int bm, int bn, int nv, long long bands,
                long long tiles) {
  const int lane = threadIdx.x & 31;
  // this warp's contiguous range of units
  const long long warps = (long long)gridDim.x * kWarps;
  const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long u_end = n_units * (w + 1) / warps;
  const int chunks = (bn + 32 * VEC - 1) / (32 * VEC);
  const long long blk = (long long)bm * bn, xblk = (long long)bn * nv;
  const long long per_brow = bands * tiles;
  // the first 32 column ids of unit u's block row, one per lane
  auto first_ids = [&](long long u) {
    return u < u_end && lane < ktot ? __ldg(cols + u / per_brow * ktot + lane) : -1;
  };

  long long u = n_units * w / warps;
  int ids_next = first_ids(u);
  for (; u < u_end; ++u) {
    const long long bg = u / per_brow;  // rank * n_brows + block row
    const long long rem = u - bg * per_brow;
    const int m0 = (int)(rem / tiles) * kBand;
    const int v0 = (int)(rem % tiles) * T;
    const long long rank = bg / n_brows;
    const float* xs0 = x0 + rank * nb0 * xblk + v0;
    const float* xs1 = x1 + rank * nb1 * xblk + v0;
    const float* xs2 = x2 + rank * nb2 * xblk + v0;
    const float* arow = blocks + bg * ktot * blk + (long long)m0 * bn;
    int ids = ids_next;
    ids_next = first_ids(u + 1);

    float acc[kBand][T];
#pragma unroll
    for (int r = 0; r < kBand; ++r)
#pragma unroll
      for (int t = 0; t < T; ++t) acc[r][t] = 0.0f;

    for (int g = 0; g < ktot; g += 32) {
      if (g > 0) ids = g + lane < ktot ? __ldg(cols + bg * ktot + g + lane) : -1;
      unsigned rest = __ballot_sync(kAll, ids >= 0);
      if (rest == 0) continue;

      // issue the loads of step (slot g + k, column chunk ch) into s
      auto load = [&](Stage<VEC, T>& s, int k, int ch) {
        const long long c = __shfl_sync(kAll, ids, k);
        const float* xb = c < nb0         ? xs0 + c * xblk
                          : c < nb0 + nb1 ? xs1 + (c - nb0) * xblk
                                          : xs2 + (c - nb0 - nb1) * xblk;
        const int j = (ch * 32 + lane) * VEC;
        const bool in = j < bn;  // VEC = 4 only when bn % 4 == 0
        const float* a = arow + (long long)(g + k) * blk + j;
#pragma unroll
        for (int r = 0; r < kBand; ++r) {
          if (in && m0 + r < bm) {
            load_stream<VEC>(s.a[r], a + (long long)r * bn);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) s.a[r][e] = 0.0f;
          }
        }
        if constexpr (T == 1) {  // nv == 1: the x block is bn contiguous floats
          if (in) {
            load_ro<VEC>(s.x[0], xb + j);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) s.x[0][e] = 0.0f;
          }
        } else {
#pragma unroll
          for (int t = 0; t < T; ++t)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              s.x[t][e] = in && v0 + t < nv ? __ldg(xb + (long long)(j + e) * nv + t) : 0.0f;
        }
      };

      int k = __ffs(rest) - 1, ch = 0;
      rest &= rest - 1;
      Stage<VEC, T> cur;
      load(cur, k, ch);
      for (;;) {
        int nk = k, nc = ch + 1;
        bool more = true;
        if (nc >= chunks) {
          nc = 0;
          more = rest != 0;
          if (more) {
            nk = __ffs(rest) - 1;
            rest &= rest - 1;
          }
        }
        Stage<VEC, T> nxt;
        if (more) load(nxt, nk, nc);  // in flight during the FMAs below
#pragma unroll
        for (int e = 0; e < VEC; ++e)
#pragma unroll
          for (int r = 0; r < kBand; ++r)
#pragma unroll
            for (int t = 0; t < T; ++t) acc[r][t] = fmaf(cur.a[r][e], cur.x[t][e], acc[r][t]);
        if (!more) break;
        cur = nxt;
        k = nk;
        ch = nc;
      }
    }

#pragma unroll
    for (int r = 0; r < kBand; ++r)
#pragma unroll
      for (int t = 0; t < T; ++t)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[r][t] += __shfl_xor_sync(kAll, acc[r][t], off);
    if (lane == 0) {
      float* o = out + (bg * bm + m0) * nv + v0;
#pragma unroll
      for (int r = 0; r < kBand; ++r)
#pragma unroll
        for (int t = 0; t < T; ++t)
          if (m0 + r < bm && v0 + t < nv) o[(long long)r * nv + t] = acc[r][t];
    }
  }
}

template <int VEC, int T>
int launch(const int* cols, const float* blocks, const float* x0,
           const float* x1, const float* x2, long long nb0, long long nb1,
           long long nb2, float* out, int n_procs, int n_brows, int ktot,
           int bm, int bn, int nv, cudaStream_t s) {
  static int resident = 0;  // blocks the card holds at once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bsr_band_kernel<VEC, T>,
                                                        kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long bands = (bm + kBand - 1) / kBand, tiles = (nv + T - 1) / T;
  const long long units = (long long)n_procs * n_brows * bands * tiles;
  if (units == 0) return (int)cudaGetLastError();
  const long long want = (units + kWarps - 1) / kWarps;
  const unsigned grid = (unsigned)(want < resident ? want : resident);
  bsr_band_kernel<VEC, T><<<grid, kThreads, 0, s>>>(
      cols, blocks, x0, x1, x2, nb0, nb1, nb2, out, units, n_brows, ktot, bm, bn,
      nv, bands, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_bsr_spmm_f32(const int* cols, const float* blocks,
                                  const float* x0, const float* x1,
                                  const float* x2, long long nb0,
                                  long long nb1, long long nb2, int nseg,
                                  float* out, int n_procs, int n_brows,
                                  int ktot, int bm, int bn, int nv,
                                  void* stream) {
  if (nseg < 1 || nseg > 3) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn % 4 == 0) {
    return nv == 1 ? launch<4, 1>(cols, blocks, x0, x1, x2, nb0, nb1, nb2, out,
                                  n_procs, n_brows, ktot, bm, bn, nv, s)
                   : launch<4, 4>(cols, blocks, x0, x1, x2, nb0, nb1, nb2, out,
                                  n_procs, n_brows, ktot, bm, bn, nv, s);
  }
  return nv == 1 ? launch<1, 1>(cols, blocks, x0, x1, x2, nb0, nb1, nb2, out,
                                n_procs, n_brows, ktot, bm, bn, nv, s)
                 : launch<1, 4>(cols, blocks, x0, x1, x2, nb0, nb1, nb2, out,
                                n_procs, n_brows, ktot, bm, bn, nv, s);
}

extern "C" int bsr_spmm_padded_f32(const int* cols, const float* blocks,
                                   const float* x, long long n_bcols,
                                   float* out, int n_brows, int kmax, int bm,
                                   int bn, int nv, void* stream) {
  return fused_bsr_spmm_f32(cols, blocks, x, x, x, n_bcols, 0, 0, 1, out, 1,
                            n_brows, kmax, bm, bn, nv, stream);
}
