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
// with no copy.  Positions below lo are never read; positions at or past
// hi inside the last tile are zero-filled and masked.
//
// Bound on an H100 SXM (3.35 TB/s): bytes.  Each k/v row inside [lo, hi)
// is read once, 2 * D * sizeof(T) bytes, and q, out and lengths once; the
// work is 4 * g * D flops a row, 16 flop/byte at g = 16 in bf16, far below
// the tensor cores' ridge.  At qwen3-moe's heads (Hkv 4, g 16, D 128) and
// decode_32k's lengths (B 8, S 32768, 99,979 rows) that is 0.2052 GB,
// 0.0612 ms.
//
// Design.  A block attends for one (b, kv head) over a run of its
// positions with ALL g query rows of the head (up to kMaxRows; a larger
// group launches again), so every k/v row is read from memory once
// whatever g is.  The rows are held as M-tiles of 16 (rows past g are zero
// and never stored).  Tiles of kTile positions of k and v stream through a
// ring of kStages buffers in shared memory by cp.async.cg (16 bytes a
// copy, zero-filled past hi), as many stages as keep three blocks on an
// SM (two where three stages would not fit, as at D = 256), so the next
// tiles' loads are in flight while the block computes on this one.
// Per tile:
//   - S = Q K^T: warp w takes positions [8 w, 8 w + 8) for every row, on
//     the tensor cores in bf16 (mma.sync m16n8k16, K by ldmatrix, Q's
//     fragments kept in registers across tiles where the registers allow;
//     bf16 products are exact in the f32 accumulator), or by FMAs in f32
//     with the same fragment layout (tensor cores would mean TF32, which
//     the port keeps off; the f32 instantiation serves the float32 held
//     models and the tests, and skips an M-tile's rows 8-15 when g leaves
//     them empty, as at g <= 8);
//   - the online softmax on the accumulator fragments: each score is
//     scaled, capped and exponentiated once, by the one lane that holds
//     it; row maxima and sums reduce over the quad (two shuffles) and
//     across the warps through shared memory;
//   - P (f32) goes to shared memory and O += P V runs with warp w owning
//     the column groups w, w + 4, ... of 16 columns of D, so a lane's
//     accumulator is 16 M-tile rows x D / 4 columns (32 f32 registers at
//     D = 256).  In bf16 P is split into P_hi = bf16(P) and P_lo =
//     bf16(P - P_hi), two mma's against V (ldmatrix.trans), ~2^-17
//     relative: P in one bf16 would cost 2^-9 a weight.  V stays exact.
// The work: a span that fits one block (ONE_BLOCK_SPAN in the wrapper, the
// served caches) is one block a (b, kv head) that normalizes and writes
// out itself: one launch.  A longer one is split by the lengths, on the
// card: chunks of w tiles a sequence and kv head, w sized so the units
// fill the card's block slots once (ragged lengths leave no block idle and
// no wave half full), ordered so the kv heads of one position, side by
// side in the model's cache, are read side by side.  Each unit writes a
// partial (m, l, acc) and a second kernel combines each pair's.
// The row pitch of every shared tile carries 16 bytes of padding, so the
// ldmatrix rows of an 8 x 8 matrix fall on distinct banks; D % 16 = 8
// pads the mma's k-dimension with zeros in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;               // positions of a staged tile: 8 a warp
constexpr int kMaxD = 256;
constexpr int kMaxRows = 32;            // query rows a launch holds: two M-tiles
constexpr int kPPitch = kTile + 8;      // floats a row of P in shared memory
constexpr int kSmemPerSm = 233472;      // 228 KB, 1 KB of it reserved a block
constexpr int kMaxBlocks = 65535;       // blocks of the split
constexpr int kMinTiles = 16;           // fewest tiles (512 positions) a unit of the split
constexpr float kNegBig = -1e30f;

using bf16 = __nv_bfloat16;

template <typename T, int DMAX, int MT>
struct Cfg {
  static constexpr int kRows = 16 * MT;
  static constexpr int kPitch = DMAX + 16 / (int)sizeof(T);  // elements a row
  static constexpr int kStageBytes = 2 * kTile * kPitch * (int)sizeof(T);
  static constexpr int kFixedBytes = kRows * kPitch * (int)sizeof(T) +
                                     kRows * kPPitch * 4 + 2 * kWarps * kRows * 4;
  // three blocks an SM where three stages fit and one M-tile leaves the
  // registers for it, else two (at least two stages)
  static constexpr int kFit3 = (kSmemPerSm / 3 - 1024 - kFixedBytes) / kStageBytes;
  static constexpr int kFit2 = (kSmemPerSm / 2 - 1024 - kFixedBytes) / kStageBytes;
  static constexpr bool kThree = MT == 1 && kFit3 >= 3;
  static constexpr int kMinBlocks = kThree ? 3 : 2;
  static constexpr int kFit = kThree ? kFit3 : kFit2;
  static constexpr int kStages = kFit < 2 ? 2 : (kFit > 8 ? 8 : kFit);
  static constexpr int kSmem = kFixedBytes + kStages * kStageBytes;
  static constexpr int kGroups = DMAX / 64;  // 16-column groups of D a warp
  // bf16: the A fragments of Q stay in registers across tiles (64 at most;
  // 16 where three blocks an SM leave 168 registers a thread)
  static constexpr bool kQRegs = MT * DMAX <= (kThree ? 64 : 256);
  static constexpr int kQSteps = kQRegs ? DMAX / 16 : 1;
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(full ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += a b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), c 16 x 8 f32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);  // x in the low half
  return *reinterpret_cast<uint32_t*>(&h);
}

// P_hi and P_lo of two adjacent weights: P_hi = bf16(p), P_lo = bf16(p - P_hi).
__device__ __forceinline__ void split_bf16(float2 p, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(p.x, p.y);
  const float2 h = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&hi));
  lo = pack_bf16(p.x - h.x, p.y - h.y);
}

// acc + x . y, in the order x, y, z, w.
__device__ __forceinline__ float dot4(float4 x, float4 y, float acc) {
  return fmaf(x.w, y.w, fmaf(x.z, y.z, fmaf(x.y, y.y, fmaf(x.x, y.x, acc))));
}

// A lane's ldmatrix.x4 address in a 16 x 16 tile of a [row][col] array:
// matrices (rows 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15).
// Q's tiles so are the A operand; V's, transposed, two n8 B operands.
template <int kPitch>
__device__ __forceinline__ uint32_t a_tile_addr(const bf16* base, int lane) {
  return smem_u32(base + ((lane & 7) + 8 * ((lane >> 3) & 1)) * kPitch + 8 * (lane >> 4));
}

// The bf16 A fragments of Q (all of D), kept in registers when they fit.
template <typename T, int DMAX, int MT>
__device__ __forceinline__ void load_q_frags(
    const T* qs, int lane, uint32_t (&qa)[MT][Cfg<T, DMAX, MT>::kQSteps][4]) {
  using C = Cfg<T, DMAX, MT>;
  if constexpr (std::is_same<T, bf16>::value && C::kQRegs) {
    const uint32_t base = a_tile_addr<C::kPitch>(qs, lane);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int ks = 0; ks < DMAX / 16; ++ks)
        ldsm_x4(qa[mt][ks], base + (mt * 16 * C::kPitch) * 2 + ks * 32);
  }
}

// The scores of warp `warp`'s 8 positions of the tile `kt` for every row
// of `qs`, in the m16n8 accumulator layout: sc[mt][0..1] row 16 mt + lane
// / 4, positions 8 warp + 2 (lane % 4) + {0, 1}; sc[mt][2..3] row + 8.
template <typename T, int DMAX, int MT>
__device__ __forceinline__ void tile_scores(
    const T* qs, const uint32_t (&qa)[MT][Cfg<T, DMAX, MT>::kQSteps][4], const T* kt,
    int d, int rows, int warp, int lane, float (&sc)[MT][4]) {
  using C = Cfg<T, DMAX, MT>;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[mt][e] = 0.0f;
  if constexpr (std::is_same<T, bf16>::value) {
    // B (K^T): matrices (positions, k lo) and (positions, k hi) of 8 x 8,
    // all of the tile's k-steps first, then the mma's in two chains
    const uint32_t ka = smem_u32(kt + (8 * warp + (lane & 7)) * C::kPitch +
                                 8 * ((lane >> 3) & 1));
    const int ksteps = (d + 15) / 16;
    uint32_t kb[DMAX / 16][2];
#pragma unroll
    for (int ks = 0; ks < DMAX / 16; ++ks)
      if (ks < ksteps) ldsm_x2(kb[ks][0], kb[ks][1], ka + ks * 32);
    float odd[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) odd[mt][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < DMAX / 16; ++ks) {
      if (ks < ksteps) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float (&acc)[4] = (ks & 1) ? odd[mt] : sc[mt];
          if constexpr (C::kQRegs) {
            mma_bf16(acc, qa[mt][ks], kb[ks][0], kb[ks][1]);
          } else {
            uint32_t a[4];
            ldsm_x4(a, a_tile_addr<C::kPitch>(qs, lane) + (mt * 16 * C::kPitch) * 2 +
                           ks * 32);
            mma_bf16(acc, a, kb[ks][0], kb[ks][1]);
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[mt][e] += odd[mt][e];
  } else {
    const int grp = lane >> 2, p0 = 8 * warp + 2 * (lane & 3);
    const float* k0 = kt + p0 * C::kPitch;
    const float* k1 = k0 + C::kPitch;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* q0 = qs + (16 * mt + grp) * C::kPitch;
      const float* q1 = q0 + 8 * C::kPitch;
      if (16 * mt + 8 < rows) {
#pragma unroll 4
        for (int e = 0; e < d; e += 4) {
          const float4 qa = *reinterpret_cast<const float4*>(q0 + e);
          const float4 qb = *reinterpret_cast<const float4*>(q1 + e);
          const float4 ka = *reinterpret_cast<const float4*>(k0 + e);
          const float4 kb = *reinterpret_cast<const float4*>(k1 + e);
          sc[mt][0] = dot4(qa, ka, sc[mt][0]);
          sc[mt][1] = dot4(qa, kb, sc[mt][1]);
          sc[mt][2] = dot4(qb, ka, sc[mt][2]);
          sc[mt][3] = dot4(qb, kb, sc[mt][3]);
        }
      } else {  // rows 8-15 of the M-tile are past g: their scores stay 0
#pragma unroll 4
        for (int e = 0; e < d; e += 4) {
          const float4 qa = *reinterpret_cast<const float4*>(q0 + e);
          sc[mt][0] = dot4(qa, *reinterpret_cast<const float4*>(k0 + e), sc[mt][0]);
          sc[mt][1] = dot4(qa, *reinterpret_cast<const float4*>(k1 + e), sc[mt][1]);
        }
      }
    }
  }
}

// o += P V over the tile for warp `warp`'s column groups (16 (warp + 4 i)
// of D), o[mt][i][half] in the m16n8 accumulator layout.
template <typename T, int DMAX, int MT>
__device__ __forceinline__ void tile_pv(const float* ps, const T* vt, int d, int rows,
                                        int warp, int lane,
                                        float (&o)[MT][Cfg<T, DMAX, MT>::kGroups][2][4]) {
  using C = Cfg<T, DMAX, MT>;
  const int grp = lane >> 2, quad = lane & 3;
  if constexpr (std::is_same<T, bf16>::value) {
    // B (V): (positions lo, cols lo), (hi, lo), (lo, hi), (hi, hi), transposed
    const uint32_t va = a_tile_addr<C::kPitch>(vt, lane);
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      uint32_t hi[MT][4], lo[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* p0 = ps + (16 * mt + grp) * kPPitch + 16 * ks + 2 * quad;
        const float* p1 = p0 + 8 * kPPitch;
        split_bf16(*reinterpret_cast<const float2*>(p0), hi[mt][0], lo[mt][0]);
        split_bf16(*reinterpret_cast<const float2*>(p1), hi[mt][1], lo[mt][1]);
        split_bf16(*reinterpret_cast<const float2*>(p0 + 8), hi[mt][2], lo[mt][2]);
        split_bf16(*reinterpret_cast<const float2*>(p1 + 8), hi[mt][3], lo[mt][3]);
      }
#pragma unroll
      for (int i = 0; i < C::kGroups; ++i) {
        const int cg = warp + 4 * i;
        if (16 * cg < d) {
          uint32_t b[4];
          ldsm_x4_trans(b, va + (16 * ks * C::kPitch + 16 * cg) * 2);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(o[mt][i][0], hi[mt], b[0], b[1]);
            mma_bf16(o[mt][i][0], lo[mt], b[0], b[1]);
            mma_bf16(o[mt][i][1], hi[mt], b[2], b[3]);
            mma_bf16(o[mt][i][1], lo[mt], b[2], b[3]);
          }
        }
      }
    }
  } else {
#pragma unroll 2
    for (int n = 0; n < kTile; ++n) {
      const float* vr = vt + n * C::kPitch + 2 * quad;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const bool upper = 16 * mt + 8 < rows;  // rows 8-15 of the M-tile in g
        const float p0 = ps[(16 * mt + grp) * kPPitch + n];
        const float p1 = upper ? ps[(16 * mt + grp + 8) * kPPitch + n] : 0.0f;
#pragma unroll
        for (int i = 0; i < C::kGroups; ++i) {
          const int cg = warp + 4 * i;
          if (16 * cg < d) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const float2 x = *reinterpret_cast<const float2*>(vr + 16 * cg + 8 * half);
              float* c = o[mt][i][half];
              c[0] = fmaf(p0, x.x, c[0]);
              c[1] = fmaf(p0, x.y, c[1]);
              if (upper) {
                c[2] = fmaf(p1, x.x, c[2]);
                c[3] = fmaf(p1, x.y, c[3]);
              }
            }
          }
        }
      }
    }
  }
}

// The launch's operands.  q [B, Hkv, g, D] contiguous, rows [j0, j0 +
// rows) of each group this launch; k/v strides in elements.  n_blocks = 0:
// one block a (b, kv head), out written directly; else the split over
// n_blocks blocks, partials in part_acc [slot][rows][D] and part_ml
// [slot][rows][2] (slot = block + pair) and each pair's first and last
// slot in slots [pair][2].
template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  const int* lengths;
  long long ksb, ksh, kss, vsb, vsh, vss;
  float* out;
  float* part_acc;
  float* part_ml;
  int* slots;
  int batch, hkv, g, j0, rows, seq, d, window, n_blocks;
  float scale, softcap;
};

// [lo, hi) of sequence b, and its tiles of kTile positions.
__device__ __forceinline__ int2 seq_range(const int* lengths, int b, int seq, int window) {
  const int hi = min(max(lengths[b], 0), seq);
  return make_int2(window > 0 ? max(hi - window, 0) : 0, hi);
}

__device__ __forceinline__ int seq_tiles(const int* lengths, int b, int seq, int window) {
  const int2 r = seq_range(lengths, b, seq, window);
  return (r.y - r.x + kTile - 1) / kTile;
}

template <typename T>
struct Smem {
  T* kst;          // [kStages][kTile][kPitch]
  T* vst;          // [kStages][kTile][kPitch]
  T* qs;           // [kRows][kPitch]
  float* ps;       // [kRows][kPPitch]
  float* red_max;  // [kWarps][kRows]
  float* red_sum;  // [kWarps][kRows]
};

// Attention of the launch's rows of pair (b, h) over positions [begin,
// end): o / l into acc_dst (row r at acc_dst + r d) when ml_dst is null,
// else the unnormalized o there and (m, l) into ml_dst.
template <typename T, int DMAX, int MT>
__device__ __forceinline__ void attend(const Args<T>& a, const Smem<T>& sm, int b,
                                       int h, int begin, int end, float* acc_dst,
                                       float* ml_dst) {
  using C = Cfg<T, DMAX, MT>;
  constexpr int kRows = C::kRows, kPitch = C::kPitch, kStages = C::kStages;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, quad = lane & 3;
  const int d = a.d;
  const long long pair = (long long)b * a.hkv + h;
  __syncthreads();  // the previous segment is done with q, P and the tiles

  // q's rows [j0, j0 + rows) of the pair, zero past rows and d
  const T zero = from_float<T>(0.0f);
  for (int i = tid; i < kRows * kPitch; i += kThreads) {
    const int r = i / kPitch, c = i - r * kPitch;
    sm.qs[i] = (r < a.rows && c < d) ? a.q[(pair * a.g + a.j0 + r) * d + c] : zero;
  }

  // the copies of a tile: 16 bytes each, thread tid starts at (r0, c0)
  constexpr int kVec = 16 / (int)sizeof(T);
  const int vecs = d / kVec;
  const int r0 = tid / vecs, c0 = tid - r0 * vecs;
  const int dr = kThreads / vecs, dc = kThreads - dr * vecs;
  const T* kb = a.k + b * a.ksb + h * a.ksh;
  const T* vb = a.v + b * a.vsb + h * a.vsh;
  const int n_tiles = (end - begin + kTile - 1) / kTile;
  auto load_tile = [&](int t) {
    const int slot = t % kStages, s0 = begin + t * kTile;
    const uint32_t kd = smem_u32(sm.kst + slot * kTile * kPitch);
    const uint32_t vd = smem_u32(sm.vst + slot * kTile * kPitch);
    int r = r0, c = c0;
    while (r < kTile) {
      const bool live = s0 + r < end;
      const long long s = live ? s0 + r : begin;  // a valid row; nothing is read
      const uint32_t off = (uint32_t)((r * kPitch + c * kVec) * sizeof(T));
      cp_async16(kd + off, kb + s * a.kss + c * kVec, live);
      cp_async16(vd + off, vb + s * a.vss + c * kVec, live);
      r += dr;
      c += dc;
      if (c >= vecs) {
        c -= vecs;
        ++r;
      }
    }
  };

  float m[MT][2], l[MT][2], o[MT][C::kGroups][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m[mt][hh] = kNegBig;
      l[mt][hh] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < C::kGroups; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) o[mt][i][e >> 2][e & 3] = 0.0f;
  }

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_tile(t);
    cp_async_commit();
  }
  __syncthreads();  // q (and, the first time, the pad columns)
  uint32_t qa[MT][C::kQSteps][4];
  load_q_frags<T, DMAX, MT>(sm.qs, lane, qa);
  const int col = 8 * warp + 2 * quad;  // position offset of sc[.][0] and [2]
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    if (t + kStages - 1 < n_tiles) load_tile(t + kStages - 1);
    cp_async_commit();
    const int slot = t % kStages, s0 = begin + t * kTile;
    float sc[MT][4];
    tile_scores<T, DMAX, MT>(sm.qs, qa, sm.kst + slot * kTile * kPitch, d, a.rows, warp,
                             lane, sc);

    const bool live0 = s0 + col < end, live1 = s0 + col + 1 < end;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = sc[mt][e] * a.scale;
        if (a.softcap > 0.0f) s = a.softcap * tanhf(s / a.softcap);
        sc[mt][e] = ((e & 1) ? live1 : live0) ? s : kNegBig;
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float x = fmaxf(sc[mt][2 * hh], sc[mt][2 * hh + 1]);
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        if (quad == 0) sm.red_max[warp * kRows + 16 * mt + 8 * hh + grp] = x;
      }
    }
    __syncthreads();  // every warp's row maxima
    float alpha[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = 16 * mt + 8 * hh + grp;
        float mx = m[mt][hh];
#pragma unroll
        for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm.red_max[w * kRows + row]);
        alpha[mt][hh] = expf(m[mt][hh] - mx);
        m[mt][hh] = mx;
        const float p0 = live0 ? expf(sc[mt][2 * hh] - mx) : 0.0f;
        const float p1 = live1 ? expf(sc[mt][2 * hh + 1] - mx) : 0.0f;
        *reinterpret_cast<float2*>(sm.ps + row * kPPitch + col) = make_float2(p0, p1);
        float x = p0 + p1;
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        if (quad == 0) sm.red_sum[warp * kRows + row] = x;
      }
    }
    __syncthreads();  // P and every warp's row sums
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = 16 * mt + 8 * hh + grp;
        float x = l[mt][hh] * alpha[mt][hh];
#pragma unroll
        for (int w = 0; w < kWarps; ++w) x += sm.red_sum[w * kRows + row];
        l[mt][hh] = x;
#pragma unroll
        for (int i = 0; i < C::kGroups; ++i)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            o[mt][i][half][2 * hh] *= alpha[mt][hh];
            o[mt][i][half][2 * hh + 1] *= alpha[mt][hh];
          }
      }
    }
    tile_pv<T, DMAX, MT>(sm.ps, sm.vst + slot * kTile * kPitch, d, a.rows, warp, lane, o);
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = 16 * mt + 8 * hh + grp;
      if (row >= a.rows) continue;
      float* dst = acc_dst + (long long)row * d;
      const float den = ml_dst ? 1.0f : fmaxf(l[mt][hh], 1e-30f);
#pragma unroll
      for (int i = 0; i < C::kGroups; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int c = 16 * (warp + 4 * i) + 8 * half + 2 * quad;
          if (c < d)
            *reinterpret_cast<float2*>(dst + c) = make_float2(
                o[mt][i][half][2 * hh] / den, o[mt][i][half][2 * hh + 1] / den);
        }
      if (ml_dst && warp == 0 && quad == 0) {
        ml_dst[2 * row] = m[mt][hh];
        ml_dst[2 * row + 1] = l[mt][hh];
      }
    }
  }
}

// Sum of one value a thread over the block, through `buf` (kWarps long
// longs of shared memory); every thread gets it.
__device__ __forceinline__ long long block_sum(long long x, long long* buf) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  __syncthreads();  // buf is free
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = x;
  __syncthreads();
  x = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) x += buf[w];
  return x;
}

// Inclusive scan of one value a thread over the block in `buf` (kThreads
// long longs of shared memory): the thread's inclusive prefix; the block's
// total in *total.
__device__ __forceinline__ long long block_scan(long long x, long long* buf,
                                                long long* total) {
  const int tid = threadIdx.x;
  __syncthreads();  // buf is free
  buf[tid] = x;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {
    const long long y = tid >= off ? buf[tid - off] : 0;
    __syncthreads();
    buf[tid] += y;
    __syncthreads();
  }
  *total = buf[kThreads - 1];
  return buf[tid];
}

// One block a (b, kv head) (n_blocks = 0), or the split.  The split cuts
// every sequence's tiles into chunks of w tiles (w from the lengths, on
// the card: at least kMinTiles, and large enough that the units, one a
// chunk and kv head, fit the n_blocks blocks when they can) and orders the
// units (b, chunk, h), so the blocks reading one position's kv heads, which
// lie side by side in the model's [B, S, Hkv, D] cache, run side by side.
// Unit u writes its partial in slot u; the unit of a pair's first chunk
// records the pair's first slot and its chunks (slots stride Hkv).
template <typename T, int DMAX, int MT>
__global__ void __launch_bounds__(kThreads, (Cfg<T, DMAX, MT>::kMinBlocks))
    decode_attn_tiles(const Args<T> a) {
  using C = Cfg<T, DMAX, MT>;
  constexpr int kRows = C::kRows, kPitch = C::kPitch, kStages = C::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  Smem<T> sm;
  sm.kst = reinterpret_cast<T*>(smem);
  sm.vst = sm.kst + kStages * kTile * kPitch;
  sm.qs = sm.vst + kStages * kTile * kPitch;
  sm.ps = reinterpret_cast<float*>(sm.qs + kRows * kPitch);
  sm.red_max = sm.ps + kRows * kPPitch;
  sm.red_sum = sm.red_max + kWarps * kRows;
  const int tid = threadIdx.x;

  // the pad columns of every k/v row, which the copies never write, zero
  const T zero = from_float<T>(0.0f);
  const int padw = kPitch - a.d;
  for (int i = tid; i < 2 * kStages * kTile * padw; i += kThreads) {
    const int r = i / padw;
    sm.kst[r * kPitch + a.d + (i - r * padw)] = zero;
  }

  if (a.n_blocks == 0) {
    const long long pair = blockIdx.x;
    const int b = (int)(pair / a.hkv), h = (int)(pair - (long long)b * a.hkv);
    const int2 r = seq_range(a.lengths, b, a.seq, a.window);
    attend<T, DMAX, MT>(a, sm, b, h, r.x, r.y, a.out + (pair * a.g + a.j0) * a.d, nullptr);
    return;
  }

  // thread tid's sequences [b_lo, b_hi); scans in P's shared memory, which
  // no unit uses yet.  First the tiles a head and the sequences with any
  // (packed: tiles << 20 | sequences), then the chunks of w tiles.
  long long* buf = reinterpret_cast<long long*>(sm.ps);
  __shared__ long long found[2];
  const int per = (a.batch + kThreads - 1) / kThreads;
  const int b_lo = min(tid * per, a.batch), b_hi = min(b_lo + per, a.batch);
  long long mine = 0;
  for (int b = b_lo; b < b_hi; ++b) {
    const long long n = seq_tiles(a.lengths, b, a.seq, a.window);
    mine += (n << 20) + (n > 0);
  }
  const long long packed = block_sum(mine, buf);
  const long long tiles = packed >> 20, seqs = packed & ((1 << 20) - 1);
  if (tiles == 0) return;
  // w: the fewest tiles (>= kMinTiles, >= the even share) whose units fit
  // the blocks; at most the bound that each sequence and head add one short
  // chunk; the even share when even one chunk a pair would not fit
  const long long per_head = a.n_blocks / a.hkv;
  long long w = max((a.hkv * tiles + a.n_blocks - 1) / a.n_blocks, (long long)kMinTiles);
  if (per_head > seqs) {
    long long hi_w = max((tiles + per_head - seqs - 1) / (per_head - seqs), w);
    while (w < hi_w) {  // the units fall as w grows: bisect
      const long long mid = (w + hi_w) / 2;
      long long n_chunks = 0;
      for (int b = b_lo; b < b_hi; ++b)
        n_chunks += (seq_tiles(a.lengths, b, a.seq, a.window) + mid - 1) / mid;
      if (block_sum(n_chunks, buf) <= per_head) hi_w = mid; else w = mid + 1;
    }
  }
  mine = 0;
  for (int b = b_lo; b < b_hi; ++b)
    mine += (seq_tiles(a.lengths, b, a.seq, a.window) + w - 1) / w;
  long long chunks;
  const long long excl = block_scan(mine, buf, &chunks) - mine;
  const long long units = chunks * a.hkv;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const long long cu = u / a.hkv;
    const int h = (int)(u - cu * a.hkv);
    // the sequence holding chunk cu: the thread whose sequences span it
    if (excl <= cu && cu < excl + mine) {
      long long base = excl;
      int b = b_lo;
      for (;; ++b) {
        const long long nc = (seq_tiles(a.lengths, b, a.seq, a.window) + w - 1) / w;
        if (cu < base + nc) break;
        base += nc;
      }
      found[0] = b;
      found[1] = base;
    }
    __syncthreads();
    const int b = (int)found[0];
    const long long j = cu - found[1];
    const int2 r = seq_range(a.lengths, b, a.seq, a.window);
    const int begin = r.x + (int)(j * w * kTile);
    const int end = (int)min((long long)r.x + (j + 1) * w * kTile, (long long)r.y);
    attend<T, DMAX, MT>(a, sm, b, h, begin, end, a.part_acc + u * a.rows * a.d,
                        a.part_ml + u * a.rows * 2);
    if (tid == 0 && j == 0) {
      const long long pair = (long long)b * a.hkv + h;
      a.slots[2 * pair] = (int)u;
      a.slots[2 * pair + 1] = (int)((r.y - r.x + w * kTile - 1) / (w * kTile));
    }
  }
}

// out[b, h, j0 + r, :] = sum_u acc_u e^(m_u - M) / max(sum_u l_u e^(m_u -
// M), 1e-30), M = max_u m_u, over the units u of pair (b, h): its chunks,
// in slots first, first + Hkv, ... (a pair without tiles gives zeros).
// One warp a (b, h, r) and 32 columns, a lane a column; every lane reads
// the few (m_u, l_u) itself, so the warp needs no reduction.
__global__ void __launch_bounds__(32)
decode_attn_combine(const float* __restrict__ part_acc,
                    const float* __restrict__ part_ml, const int* __restrict__ slots,
                    const int* __restrict__ lengths, float* __restrict__ out, int hkv,
                    int g, int j0, int rows, int seq, int window, int d) {
  const long long pair = blockIdx.x / rows;
  const int r = (int)(blockIdx.x - pair * rows);
  const int b = (int)(pair / hkv);
  const int e = blockIdx.y * 32 + threadIdx.x;
  if (e >= d) return;
  const bool live = seq_tiles(lengths, b, seq, window) > 0;
  const long long first = live ? slots[2 * pair] : 0;
  const int units = live ? slots[2 * pair + 1] : 0;
  const float* ml = part_ml + (first * rows + r) * 2;
  const long long ml_step = 2LL * hkv * rows;
  float mx = kNegBig;
  for (int u = 0; u < units; ++u) mx = fmaxf(mx, ml[u * ml_step]);
  const float* acc = part_acc + (first * rows + r) * d + e;
  const long long step = (long long)hkv * rows * d;
  float o = 0.0f, lsum = 0.0f;
#pragma unroll 4
  for (int u = 0; u < units; ++u) {
    const float w = expf(ml[u * ml_step] - mx);
    lsum += ml[u * ml_step + 1] * w;
    o = fmaf(acc[u * step], w, o);
  }
  out[(pair * g + j0 + r) * d + e] = o / fmaxf(lsum, 1e-30f);
}

// The tile kernel of one instantiation, opted in (once a device) to its
// dynamic shared memory above 48 KB and to the largest carveout.
template <typename T>
using TilesFn = void (*)(Args<T>);

template <typename T, int DMAX, int MT>
cudaError_t tiles_kernel(TilesFn<T>* kernel) {
  using C = Cfg<T, DMAX, MT>;
  static_assert(C::kSmem <= 232448, "shared memory above a block's 227 KB");
  *kernel = decode_attn_tiles<T, DMAX, MT>;
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && ready[dev])) return err;
  err = cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(*kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < 64) ready[dev] = true;
  return err;
}

template <typename T, int DMAX, int MT>
struct Inst {
  using type = T;
  static constexpr int kDMax = DMAX, kMT = MT;
};

// f(Inst<T, DMAX, MT>{}) for dtype (0 float32, 1 bfloat16), D's bucket
// (128: every model's head but gemma2's, which takes 256) and the M-tiles
// of `rows` query rows (1 up to 16, else 2).
template <typename T, typename F>
cudaError_t dispatch_t(int d, int rows, F& f) {
  if (rows <= 16) return d <= 128 ? f(Inst<T, 128, 1>{}) : f(Inst<T, 256, 1>{});
  return d <= 128 ? f(Inst<T, 128, 2>{}) : f(Inst<T, 256, 2>{});
}

template <typename F>
cudaError_t dispatch(int dtype, int d, int rows, F&& f) {
  return dtype == 0 ? dispatch_t<float>(d, rows, f) : dispatch_t<bf16>(d, rows, f);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k and v alike).  q [B, Hkv, g, D]
// contiguous; k/v strides in elements; out [B, Hkv, g, D] float32.
// n_blocks = 0: one block a (b, kv head), one launch; else the split over
// n_blocks blocks and the combine, with part holding (n_blocks + B Hkv)
// min(g, kMaxRows) (D + 2) + 2 B Hkv floats of scratch.  Each group of
// kMaxRows query rows is one launch (and one combine).
extern "C" int decode_attention_grouped(
    const void* q, const void* k, const void* v, const int* lengths, int dtype,
    long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, float* out, float* part, int batch, int hkv, int g, int seq,
    int d, int window, int n_blocks, float scale, float softcap, void* stream) {
  if (d <= 0 || d > kMaxD || d % 8 || n_blocks < 0 || n_blocks > kMaxBlocks ||
      batch > 65535 || hkv > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long pairs = (long long)batch * hkv;
  if (pairs * g == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long slots = n_blocks + pairs;
  const int max_rows = g < kMaxRows ? g : kMaxRows;
  for (int j0 = 0; j0 < g; j0 += kMaxRows) {
    const int rows = g - j0 < kMaxRows ? g - j0 : kMaxRows;
    float* part_acc = part;
    float* part_ml = part + slots * max_rows * d;
    int* part_slots = reinterpret_cast<int*>(part_ml + slots * max_rows * 2);
    cudaError_t err = dispatch(dtype, d, rows, [&](auto inst) {
      using I = decltype(inst);
      using T = typename I::type;
      TilesFn<T> kernel;
      cudaError_t e = tiles_kernel<T, I::kDMax, I::kMT>(&kernel);
      if (e != cudaSuccess) return e;
      const Args<T> a{static_cast<const T*>(q), static_cast<const T*>(k),
                      static_cast<const T*>(v), lengths, ksb, ksh, kss, vsb, vsh, vss,
                      out, part_acc, part_ml, part_slots, batch, hkv, g, j0, rows, seq,
                      d, window, n_blocks, scale, softcap};
      const unsigned grid = n_blocks ? (unsigned)n_blocks : (unsigned)pairs;
      kernel<<<grid, kThreads, Cfg<T, I::kDMax, I::kMT>::kSmem, s>>>(a);
      return cudaGetLastError();
    });
    if (err != cudaSuccess) return (int)err;
    if (n_blocks) {
      const dim3 combine_grid((unsigned)(pairs * rows), (d + 31) / 32);
      decode_attn_combine<<<combine_grid, 32, 0, s>>>(
          part_acc, part_ml, part_slots, lengths, out, hkv, g, j0, rows, seq, window, d);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaSuccess;
}

// Blocks of the tile kernel an SM holds and its dynamic shared memory, for
// one instantiation (dtype as above, d, rows <= kMaxRows query rows).
extern "C" int decode_attention_occupancy(int dtype, int d, int rows, int* blocks,
                                          int* smem_bytes) {
  if (d <= 0 || d > kMaxD || rows <= 0 || rows > kMaxRows || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return (int)dispatch(dtype, d, rows, [&](auto inst) {
    using I = decltype(inst);
    using T = typename I::type;
    TilesFn<T> kernel;
    cudaError_t e = tiles_kernel<T, I::kDMax, I::kMT>(&kernel);
    if (e != cudaSuccess) return e;
    *smem_bytes = Cfg<T, I::kDMax, I::kMT>::kSmem;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, kThreads, Cfg<T, I::kDMax, I::kMT>::kSmem);
  });
}
