// Single-token GQA decode attention (flash-decode) over a strided KV cache.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attn/kernel.py
// (decode_attention_grouped, body _kernel).  For every sequence b, kv head
// h and query row j of the head's group of g:
//
//     out[b, h, j, :] = sum_{s in [lo, hi)} p_s v[b, h, s, :],
//     p = softmax over s of c(scale * q[b, h, j, :] . k[b, h, s, :]),
//
// with hi = min(lengths[b], S), lo = max(hi - window, 0) when window > 0
// (the sliding window of models/common.py cache_decode_attention) and
// lo = 0 otherwise (the TPU kernel's contract), and c(x) = cap * tanh(x /
// cap) when softcap > 0 (gemma2), the identity otherwise.  An empty range
// gives zeros: acc / max(l, 1e-30) with the running max started at -1e30,
// as in the TPU kernel.  expf and tanhf, not the fast intrinsics.
//
// k and v are read where they lie, through element strides (b, h, s) and a
// unit stride along D: the [B, Hkv, S, D] layout of the TPU kernel and the
// model's [B, S, Hkv, D] cache (seen as its transpose) take the same code
// with no copy, and bf16 or f32 are read as stored and accumulated in f32.
// Positions outside [lo, hi) are never read, so neither the ragged end nor
// the part below the window needs padding or masking.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s f32 on the CUDA cores):
// bytes.  Each k/v row inside [lo, hi) is read once, 2 * D * sizeof(T)
// bytes for 4 * g * D flops: 1 flop per byte at gemma2's g = 2 in bf16.
// At B = 8, S = 32768, Hkv = 4, D = 256 in bf16 one layer's cache is
// 1.07 GB, >= 0.32 ms at full lengths.
//
// Design: the TPU kernel carries (m, l, acc) across a sequential grid axis;
// Hopper runs blocks in no order, so the positions are split.  Each warp is
// an independent worker over `chunk` consecutive positions of [lo, hi) for
// one (b, h) and a tile of GT query rows, keeping (m, l, acc) of its rows in
// registers (online softmax).  Lane l holds elements [8 l, 8 l + 8) of D:
// one 16-byte load per row in bf16 (two in f32), so a warp reads a row as
// one contiguous segment (512 bytes at D = 256 in bf16).  A warp walks its
// chunk kRows rows at a time and loads the next kRows rows of k and v
// before it computes on the current ones, so the loads' latency hides
// behind the arithmetic; rows stay packed in registers until used.  The
// dot products reduce across the warp with shuffles, so every lane holds
// every score and the warp's control flow stays uniform.  The partials
// (m, l, acc) of the warps go to a scratch buffer, and a second kernel
// combines them per (b, h, j) and 32 columns, the weights e^(m_u - M) in
// shared memory.
// Few (b, h) pairs at long lengths are the usual decode shape, so the
// wrapper splits each pair's positions over up to ~2000 blocks of 4 warps
// in all (at least 16 positions to a warp).  Blocks share no memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxD = 256;
constexpr int kCombineWarps = 8;
constexpr int kMaxUnits = 10240;  // combine weights: 40 KB of shared memory
constexpr float kNegBig = -1e30f;

// One lane's 8 elements of a row, as loaded (16 bytes of bf16, 32 of f32).
template <typename T>
struct Row;

template <>
struct Row<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void zero() { u = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void unpack(float (&o)[8]) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Row<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = *reinterpret_cast<const float4*>(p);
    b = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ __forceinline__ void zero() {
    a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    b = a;
  }
  __device__ __forceinline__ void unpack(float (&o)[8]) const {
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int R>
__device__ __forceinline__ void load_rows(Row<T> (&kr)[R], Row<T> (&vr)[R],
                                          const T* kb, const T* vb,
                                          long long kss, long long vss,
                                          int s0, int end, bool live) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (live && s0 + r < end) {
      kr[r].load(kb + (long long)(s0 + r) * kss);
      vr[r].load(vb + (long long)(s0 + r) * vss);
    } else {
      kr[r].zero();
      vr[r].zero();
    }
  }
}

template <typename T, int GT>
__global__ void __launch_bounds__(kWarps * 32)
decode_attn_partial(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    long long ksb, long long ksh, long long kss,
                    long long vsb, long long vsh, long long vss,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int hkv, int g, int seq, int d, int window, int units,
                    int chunk, float scale, float softcap) {
  constexpr int kRows = GT >= 8 ? 2 : 4;
  const int b = blockIdx.z;
  const int gtiles = (g + GT - 1) / GT;
  const int h = blockIdx.y / gtiles;
  const int j0 = (blockIdx.y - h * gtiles) * GT;
  const int lane = threadIdx.x & 31;
  const int unit = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int e0 = lane * 8;
  const bool live = e0 < d;

  const int hi = min(max(lengths[b], 0), seq);
  const int lo = window > 0 ? max(hi - window, 0) : 0;
  const long long first = lo + (long long)unit * chunk;
  const int begin = (int)min(first, (long long)hi);
  const int end = (int)min(first + chunk, (long long)hi);

  float qf[GT][8], acc[GT][8], m[GT], l[GT];
#pragma unroll
  for (int jj = 0; jj < GT; ++jj) {
    Row<T> qr;
    if (live && j0 + jj < g) {
      qr.load(q + ((long long)(b * hkv + h) * g + j0 + jj) * d + e0);
    } else {
      qr.zero();
    }
    qr.unpack(qf[jj]);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[jj][e] = 0.0f;
    m[jj] = kNegBig;
    l[jj] = 0.0f;
  }

  const T* kb = k + b * ksb + h * ksh + e0;
  const T* vb = v + b * vsb + h * vsh + e0;
  Row<T> kc[kRows], vc[kRows], kn[kRows], vn[kRows];
  load_rows(kc, vc, kb, vb, kss, vss, begin, end, live);
  for (int s0 = begin; s0 < end; s0 += kRows) {
    load_rows(kn, vn, kb, vb, kss, vss, s0 + kRows, end, live);
    float sc[GT][kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float kf[8];
      kc[r].unpack(kf);
#pragma unroll
      for (int jj = 0; jj < GT; ++jj) {
        float dot = 0.0f;
#pragma unroll
        for (int e = 0; e < 8; ++e) dot = fmaf(qf[jj][e], kf[e], dot);
        sc[jj][r] = dot;
      }
    }
#pragma unroll
    for (int jj = 0; jj < GT; ++jj) {
      float m_new = m[jj];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float s = warp_sum(sc[jj][r]) * scale;
        if (softcap > 0.0f) s = softcap * tanhf(s / softcap);
        sc[jj][r] = s0 + r < end ? s : kNegBig;
        m_new = fmaxf(m_new, sc[jj][r]);
      }
      const float alpha = expf(m[jj] - m_new);
      float lsum = l[jj] * alpha;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[jj][e] *= alpha;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        sc[jj][r] = s0 + r < end ? expf(sc[jj][r] - m_new) : 0.0f;
        lsum += sc[jj][r];
      }
      l[jj] = lsum;
      m[jj] = m_new;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float vf[8];
      vc[r].unpack(vf);
#pragma unroll
      for (int jj = 0; jj < GT; ++jj) {
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[jj][e] = fmaf(sc[jj][r], vf[e], acc[jj][e]);
      }
      kc[r] = kn[r];
      vc[r] = vn[r];
    }
  }

#pragma unroll
  for (int jj = 0; jj < GT; ++jj) {
    const int j = j0 + jj;
    if (j >= g) continue;
    const long long row = ((long long)(b * hkv + h) * g + j) * units + unit;
    if (live) {
      float4* dst = reinterpret_cast<float4*>(part_acc + row * d + e0);
      dst[0] = make_float4(acc[jj][0], acc[jj][1], acc[jj][2], acc[jj][3]);
      dst[1] = make_float4(acc[jj][4], acc[jj][5], acc[jj][6], acc[jj][7]);
    }
    if (lane == 0) {
      part_ml[2 * row] = m[jj];
      part_ml[2 * row + 1] = l[jj];
    }
  }
}

// Reduce over the block (blockDim.x a multiple of 32); every thread gets
// the result.  `red` holds one value per warp.
template <bool kMax>
__device__ float block_reduce(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[warp] = x;
  __syncthreads();
  x = red[0];
  for (int w = 1; w < n_warps; ++w) x = kMax ? fmaxf(x, red[w]) : x + red[w];
  return x;
}

// out[row, :] = sum_u acc_u e^(m_u - M) / max(sum_u l_u e^(m_u - M), 1e-30),
// M = max_u m_u, over the units partials of one (b, h, j) row.  Grid (rows,
// ceil(d / 32)): warp w of a block sums units w, w + kCombineWarps, ... of
// the block's 32 columns, lane = column, and warp 0 adds the warps' sums.
__global__ void __launch_bounds__(kCombineWarps * 32)
decode_attn_combine(const float* __restrict__ part_acc,
                    const float* __restrict__ part_ml,
                    float* __restrict__ out, int units, int d) {
  extern __shared__ float weight[];
  __shared__ float red[kCombineWarps];
  __shared__ float sums[kCombineWarps][32];
  const long long row = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* ml = part_ml + row * units * 2;
  float mx = kNegBig;
  for (int u = threadIdx.x; u < units; u += blockDim.x) mx = fmaxf(mx, ml[2 * u]);
  mx = block_reduce<true>(mx, red);
  float lsum = 0.0f;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    weight[u] = expf(ml[2 * u] - mx);
    lsum += ml[2 * u + 1] * weight[u];
  }
  lsum = block_reduce<false>(lsum, red);  // its barriers publish weight[]
  const int e = blockIdx.y * 32 + lane;
  float o = 0.0f;
  if (e < d) {
    const float* acc = part_acc + row * units * d + e;
#pragma unroll 4
    for (int u = warp; u < units; u += kCombineWarps)
      o = fmaf(acc[(long long)u * d], weight[u], o);
  }
  sums[warp][lane] = o;
  __syncthreads();
  if (warp == 0 && e < d) {
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < kCombineWarps; ++w) total += sums[w][lane];
    out[row * d + e] = total / fmaxf(lsum, 1e-30f);
  }
}

template <typename T, int GT>
void launch_partial(dim3 grid, cudaStream_t s, const void* q, const void* k,
                    const void* v, const int* lengths, long long ksb,
                    long long ksh, long long kss, long long vsb, long long vsh,
                    long long vss, float* part_acc, float* part_ml, int hkv,
                    int g, int seq, int d, int window, int units, int chunk,
                    float scale, float softcap) {
  decode_attn_partial<T, GT><<<grid, kWarps * 32, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, ksb, ksh, kss, vsb, vsh, vss,
      part_acc, part_ml, hkv, g, seq, d, window, units, chunk, scale, softcap);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k and v alike).  q [B, Hkv, g, D]
// contiguous; k/v strides in elements; part holds B * Hkv * g * units *
// (D + 2) floats of scratch; out [B, Hkv, g, D] float32.
extern "C" int decode_attention_grouped(
    const void* q, const void* k, const void* v, const int* lengths, int dtype,
    long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, float* out, float* part, int batch, int hkv, int g, int gt,
    int seq, int d, int window, int units, int chunk, float scale,
    float softcap, void* stream) {
  if (d <= 0 || d > kMaxD || d % 8 || units <= 0 || units % kWarps ||
      units > kMaxUnits || chunk < 0 ||
      (gt != 1 && gt != 2 && gt != 4 && gt != 8) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)batch * hkv * g;
  if (rows == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part_acc = part;
  float* part_ml = part + rows * units * d;
  const dim3 grid(units / kWarps, hkv * ((g + gt - 1) / gt), batch);
#define DECODE_ATTN_LAUNCH(T, GT)                                            \
  launch_partial<T, GT>(grid, s, q, k, v, lengths, ksb, ksh, kss, vsb, vsh,  \
                        vss, part_acc, part_ml, hkv, g, seq, d, window,      \
                        units, chunk, scale, softcap)
  if (dtype == 0) {
    switch (gt) {
      case 1: DECODE_ATTN_LAUNCH(float, 1); break;
      case 2: DECODE_ATTN_LAUNCH(float, 2); break;
      case 4: DECODE_ATTN_LAUNCH(float, 4); break;
      default: DECODE_ATTN_LAUNCH(float, 8); break;
    }
  } else {
    switch (gt) {
      case 1: DECODE_ATTN_LAUNCH(__nv_bfloat16, 1); break;
      case 2: DECODE_ATTN_LAUNCH(__nv_bfloat16, 2); break;
      case 4: DECODE_ATTN_LAUNCH(__nv_bfloat16, 4); break;
      default: DECODE_ATTN_LAUNCH(__nv_bfloat16, 8); break;
    }
  }
#undef DECODE_ATTN_LAUNCH
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 combine_grid((unsigned)rows, (d + 31) / 32);
  decode_attn_combine<<<combine_grid, kCombineWarps * 32,
                        (size_t)units * sizeof(float), s>>>(
      part_acc, part_ml, out, units, d);
  return (int)cudaGetLastError();
}
