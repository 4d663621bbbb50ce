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
//
// g = 1 (one query row a kv head: zamba2-2.7b's 32 heads of D 80,
// whisper-small's 12 of D 64) takes a path of its own, decode_attn_g1
// below; the tile kernel above serves g >= 2.  Its bound is the same: the
// bytes of the k/v rows inside the masks, read once (1.0239 GB, 0.3056 ms
// at zamba2's heads and decode_32k's lengths; 5.3687 GB, 1.6026 ms a
// shared-block application of its long_500k cell).  At 1 flop a byte an
// M-tile of 16 rows with one live row, P split for the tensor cores and
// barriers across warps every tile buy nothing, so the design drops them:
//   - a group of D / 8 lanes holds one head's row, 8 elements a lane (one
//     16-byte vector in bf16, two in f32: 10 lanes at D 80, 8 at D 64),
//     and keeps that head's running max, sum and output in registers;
//     scores reduce within the group by shuffles;
//   - each thread streams its own slices of k and v through a ring of
//     kG1Stages slots in shared memory by cp.async (kG1Pos positions a
//     slot, zero-filled past the unit's end) and reads back only what it
//     copied itself, so the ring needs no barrier: three slots in flight
//     a thread while it computes on the fourth, 138 KB an SM at D 80;
//   - the work is units of (sequence, run of R positions, group of hg kv
//     heads), hg dividing Hkv: in the model's [B, S, Hkv, D] cache one
//     position's heads lie side by side, so a block reads rows of hg D
//     contiguous elements.  A block's lane groups take the hg heads times
//     `phases` interleaved runs of positions; the phases merge once, in
//     shared memory, at the unit's end.  R is the fewest positions whose
//     units fit the grid (at least one block slot each, the sequences'
//     lengths read on the card), so every unit of a sequence but its last
//     has R positions and the balance comes from the construction;
//   - a sequence of one unit writes its output; else each unit writes a
//     partial (m, l, acc) and counts itself on an atomic counter of its
//     (sequence, head group), and the last to arrive merges the partials
//     and resets the counter: one launch, no combine kernel.
// Other strides (the [B, Hkv, S, D] layout) take the same code; a row of
// a head then no longer lies beside its neighbours'.

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

// ---------------------------------------------------------------------------
// g = 1 (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int kG1Warps = 8;
constexpr int kG1Threads = kG1Warps * 32;
constexpr int kG1Stages = 4;      // ring slots a thread: three in flight while it computes
constexpr int kG1Lane = 8;        // elements of D a lane holds
constexpr int kG1MinBlocks = 3;

template <typename T>
struct G1Cfg {
  static constexpr int kVecs = kG1Lane * (int)sizeof(T) / 16;  // 16-byte vectors of a slice
  static constexpr int kPos = 2 / kVecs;                       // positions a slot: 2 bf16, 1 f32
  static constexpr int kSlotVecs = 2 * kPos * kVecs;           // k and v: 4 either way
  static constexpr int kSmem = kG1Stages * kSlotVecs * 16 * kG1Threads;  // 64 KB
};

// q [B, Hkv, 1, D] contiguous, k/v strides in elements, out [B, Hkv, 1, D];
// part: the partials' acc [grid][hg][D] then (m, l) [grid][hg][2]; counts
// [B][Hkv / hg], zero between launches.
template <typename T>
struct G1Args {
  const T* q;
  const T* k;
  const T* v;
  const int* lengths;
  long long ksb, ksh, kss, vsb, vsh, vss;
  float* out;
  float* part;
  int* counts;
  int batch, hkv, seq, d, window, hg, phases;
  float scale, softcap;
};

// A block's unit: sequence b, head group hg, positions [begin, end); the
// sequence's units are chunks first, first + 1, ... (nu of them) of the
// plan's (b, chunk) order.
struct G1Unit {
  int b, hg, nu, begin, end;
  long long first;
};

__device__ __forceinline__ long long warp_sum(long long x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Chunks of sequence b at a run of r positions: at least one (an empty
// sequence's unit writes its zeros).
__device__ __forceinline__ long long g1_chunks(int n, long long r) {
  return n > 0 ? (n + r - 1) / r : 1;
}

// The unit plan, computed by each warp alone (the same in every warp, so
// no barrier): the run R is the fewest positions whose chunks, times the
// head groups, fit the grid's slots (gridDim.x / nhg chunks a head group,
// at least B by the host's grid); units in (b, chunk, head group) order.
// False for a block past the last unit.
template <typename T>
__device__ bool g1_unit(const G1Args<T>& a, long long u, int nhg, G1Unit& un) {
  const int lane = threadIdx.x & 31;
  const long long slots = gridDim.x / nhg;
  long long total = 0;
  int longest = 0;
  for (int b = lane; b < a.batch; b += 32) {
    const int2 r = seq_range(a.lengths, b, a.seq, a.window);
    total += r.y - r.x;
    longest = max(longest, r.y - r.x);
  }
  total = warp_sum(total);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    longest = max(longest, __shfl_xor_sync(0xffffffffu, longest, off));
  auto chunks = [&](long long run) {
    long long c = 0;
    for (int b = lane; b < a.batch; b += 32) {
      const int2 r = seq_range(a.lengths, b, a.seq, a.window);
      c += g1_chunks(r.y - r.x, run);
    }
    return warp_sum(c);
  };
  // R in [ceil(total / slots), longest]; each sequence adds at most one
  // short chunk, so ceil(total / (slots - B)) fits when slots > B
  long long lo = max(1LL, (total + slots - 1) / slots), hi = max(1, longest);
  if (slots > a.batch) hi = min(hi, max(lo, (total + slots - a.batch - 1) / (slots - a.batch)));
  while (lo < hi) {
    const long long mid = (lo + hi) / 2;
    if (chunks(mid) <= slots) hi = mid; else lo = mid + 1;
  }
  const long long run = lo, cu = u / nhg;
  long long base = 0;
  for (int b0 = 0; b0 < a.batch; b0 += 32) {
    const int b = b0 + lane;
    const int2 r = b < a.batch ? seq_range(a.lengths, b, a.seq, a.window) : make_int2(0, 0);
    const long long c = b < a.batch ? g1_chunks(r.y - r.x, run) : 0;
    long long incl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    const bool mine = b < a.batch && base + incl - c <= cu && cu < base + incl;
    const unsigned hit = __ballot_sync(0xffffffffu, mine);
    if (hit) {
      const int src = __ffs(hit) - 1;
      un.b = b0 + src;
      un.first = base + __shfl_sync(0xffffffffu, incl - c, src);
      un.nu = (int)__shfl_sync(0xffffffffu, c, src);
      const int lo_b = __shfl_sync(0xffffffffu, r.x, src);
      const int hi_b = __shfl_sync(0xffffffffu, r.y, src);
      const long long j = cu - un.first;
      un.hg = (int)(u - cu * nhg);
      un.begin = (int)min((long long)lo_b + j * run, (long long)hi_b);
      un.end = (int)min((long long)lo_b + (j + 1) * run, (long long)hi_b);
      return true;
    }
    base += __shfl_sync(0xffffffffu, incl, 31);
  }
  return false;
}

// A lane's 8 elements as floats; vector i of the slice at p + i * stride.
template <typename T>
__device__ __forceinline__ void unpack8(const uint4* p, int stride, float (&x)[8]) {
  if constexpr (std::is_same<T, bf16>::value) {
    const uint4 u = *p;
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  } else {
    const float4 lo = *reinterpret_cast<const float4*>(p);
    const float4 hi = *reinterpret_cast<const float4*>(p + stride);
    x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
    x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
  }
}

// Sums over the lh lanes of each lane group (lanes [base, base + lh)), in
// every lane of the group: a butterfly when lh is a power of two (p2 ==
// lh), else a tree to the group's first lane and a broadcast.
template <int N>
__device__ __forceinline__ void group_sums(float (&x)[N], int lh, int p2, int idx, int base) {
  if (lh == p2) {
    for (int off = lh >> 1; off > 0; off >>= 1)
#pragma unroll
      for (int n = 0; n < N; ++n) x[n] += __shfl_xor_sync(0xffffffffu, x[n], off);
  } else {
    for (int off = p2 >> 1; off > 0; off >>= 1)
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float y = __shfl_down_sync(0xffffffffu, x[n], off);
        if (idx + off < lh) x[n] += y;
      }
#pragma unroll
    for (int n = 0; n < N; ++n) x[n] = __shfl_sync(0xffffffffu, x[n], base);
  }
}

__device__ __forceinline__ void store8(float* dst, const float (&x)[8], float den) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(x[0] / den, x[1] / den, x[2] / den, x[3] / den);
  reinterpret_cast<float4*>(dst)[1] = make_float4(x[4] / den, x[5] / den, x[6] / den, x[7] / den);
}

__device__ __forceinline__ void load8(const float* src, float (&x)[8]) {
  const float4 lo = reinterpret_cast<const float4*>(src)[0];
  const float4 hi = reinterpret_cast<const float4*>(src)[1];
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}

// Each head's (m, l, acc) merged over its lane groups' phases through
// `red` ([lane group][D + 4] floats of shared memory, free on entry): the
// lead lanes (phase 0) get the result; a barrier inside.
__device__ __forceinline__ void merge_phases(float* red, int d, int i, int idx, int hl,
                                             int hg, int phases, bool active, bool lead,
                                             float& m, float& l, float (&acc)[kG1Lane]) {
  const int pitch = d + 4;
  if (active) {
    float* r = red + i * pitch;
    store8(r + kG1Lane * idx, acc, 1.0f);
    if (idx == 0) {
      r[d] = m;
      r[d + 1] = l;
    }
  }
  __syncthreads();
  if (!lead) return;
  m = kNegBig;
  for (int p = 0; p < phases; ++p) m = fmaxf(m, red[(p * hg + hl) * pitch + d]);
  l = 0.0f;
#pragma unroll
  for (int e = 0; e < kG1Lane; ++e) acc[e] = 0.0f;
  for (int p = 0; p < phases; ++p) {
    const float* r = red + (p * hg + hl) * pitch;
    const float w = expf(r[d] - m);
    float x[kG1Lane];
    load8(r + kG1Lane * idx, x);
    l = fmaf(r[d + 1], w, l);
#pragma unroll
    for (int e = 0; e < kG1Lane; ++e) acc[e] = fmaf(x[e], w, acc[e]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kG1Threads, kG1MinBlocks) decode_attn_g1(const G1Args<T> a) {
  using C = G1Cfg<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nhg = a.hkv / a.hg;
  G1Unit un;
  if (!g1_unit(a, blockIdx.x, nhg, un)) return;

  // lane group i = (head hl of the unit's group, phase ph); lanes of a
  // warp past its whole groups, and groups past hg x phases, stay idle
  // (they shuffle along and copy nothing)
  const int lh = a.d / kG1Lane, per_warp = 32 / lh;
  const int p2 = lh > 1 ? 1 << (32 - __clz(lh - 1)) : 1;
  const int grp = lane / lh, idx = lane - grp * lh;
  const int i = warp * per_warp + grp;
  const bool active = grp < per_warp && i < a.hg * a.phases;
  const int hl = active ? i % a.hg : 0, ph = active ? i / a.hg : 0;
  const int h = un.hg * a.hg + hl;
  const int n_tiles = (un.end - un.begin + C::kPos - 1) / C::kPos;
  const int steps = (n_tiles + a.phases - 1) / a.phases;
  const T* kb = a.k + un.b * a.ksb + h * a.ksh + kG1Lane * idx;
  const T* vb = a.v + un.b * a.vsb + h * a.vsh + kG1Lane * idx;
  const uint32_t ring = smem_u32(smem) + tid * 16;
  constexpr int kPer16 = 16 / (int)sizeof(T);
  // step st: this lane group's tile ph + st phases, into slot st % kG1Stages
  auto load = [&](int st) {
    const int slot = st % kG1Stages;
    const int p0 = un.begin + (ph + st * a.phases) * C::kPos;
#pragma unroll
    for (int p = 0; p < C::kPos; ++p) {
      const bool live = active && p0 + p < un.end;
      const T* ks = live ? kb + (long long)(p0 + p) * a.kss : a.k;
      const T* vs = live ? vb + (long long)(p0 + p) * a.vss : a.v;
#pragma unroll
      for (int e = 0; e < C::kVecs; ++e) {
        const int vk = (slot * C::kSlotVecs + (2 * p) * C::kVecs + e) * kG1Threads;
        const int vv = (slot * C::kSlotVecs + (2 * p + 1) * C::kVecs + e) * kG1Threads;
        cp_async16(ring + vk * 16, ks + e * kPer16, live);
        cp_async16(ring + vv * 16, vs + e * kPer16, live);
      }
    }
  };
#pragma unroll
  for (int st = 0; st < kG1Stages; ++st) {
    if (st < steps) load(st);
    cp_async_commit();
  }

  float q[kG1Lane], acc[kG1Lane];
#pragma unroll
  for (int e = 0; e < kG1Lane; ++e) acc[e] = 0.0f;
  if (active) {
    const T* qp = a.q + ((long long)un.b * a.hkv + h) * a.d + kG1Lane * idx;
    unpack8<T>(reinterpret_cast<const uint4*>(qp), 1, q);
  } else {
#pragma unroll
    for (int e = 0; e < kG1Lane; ++e) q[e] = 0.0f;
  }
  float m = kNegBig, l = 0.0f;
  const uint4* mine = reinterpret_cast<const uint4*>(smem) + tid;
  for (int st = 0; st < steps; ++st) {
    cp_async_wait<kG1Stages - 1>();  // this thread's copies of step st landed
    const int slot = st % kG1Stages;
    const int p0 = un.begin + (ph + st * a.phases) * C::kPos;
    float kx[C::kPos][kG1Lane], vx[C::kPos][kG1Lane], s[C::kPos];
#pragma unroll
    for (int p = 0; p < C::kPos; ++p) {
      unpack8<T>(mine + (slot * C::kSlotVecs + 2 * p * C::kVecs) * kG1Threads, kG1Threads,
                 kx[p]);
      unpack8<T>(mine + (slot * C::kSlotVecs + (2 * p + 1) * C::kVecs) * kG1Threads,
                 kG1Threads, vx[p]);
      s[p] = 0.0f;
#pragma unroll
      for (int e = 0; e < kG1Lane; ++e) s[p] = fmaf(q[e], kx[p][e], s[p]);
    }
    group_sums(s, lh, p2, idx, grp * lh);
    float mx = m;
#pragma unroll
    for (int p = 0; p < C::kPos; ++p) {
      float x = s[p] * a.scale;
      if (a.softcap > 0.0f) x = a.softcap * tanhf(x / a.softcap);
      s[p] = active && p0 + p < un.end ? x : kNegBig;
      mx = fmaxf(mx, s[p]);
    }
    const float alpha = expf(m - mx);
    m = mx;
    l *= alpha;
#pragma unroll
    for (int e = 0; e < kG1Lane; ++e) acc[e] *= alpha;
#pragma unroll
    for (int p = 0; p < C::kPos; ++p) {
      const float w = active && p0 + p < un.end ? expf(s[p] - mx) : 0.0f;
      l += w;
#pragma unroll
      for (int e = 0; e < kG1Lane; ++e) acc[e] = fmaf(w, vx[p][e], acc[e]);
    }
    // the slot is read: step st + kG1Stages into it
    if (st + kG1Stages < steps) load(st + kG1Stages);
    cp_async_commit();
  }

  // the phases of each head merge in shared memory (the ring is done)
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  const bool lead = active && ph == 0;
  merge_phases(red, a.d, i, idx, hl, a.hg, a.phases, active, lead, m, l, acc);
  float* out = a.out + ((long long)un.b * a.hkv + h) * a.d + kG1Lane * idx;
  if (un.nu == 1) {
    if (lead) store8(out, acc, fmaxf(l, 1e-30f));
    return;
  }

  // a partial; the unit that counts last merges its group's: lane group
  // (hl, ph) the units ph, ph + phases, ..., then the phases as above
  float* part_acc = a.part;
  float* part_ml = a.part + (long long)gridDim.x * a.hg * a.d;
  if (lead) {
    const long long slot = (long long)blockIdx.x * a.hg + hl;
    store8(part_acc + slot * a.d + kG1Lane * idx, acc, 1.0f);
    if (idx == 0) *reinterpret_cast<float2*>(part_ml + 2 * slot) = make_float2(m, l);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* c = a.counts + (long long)un.b * nhg + un.hg;
    last = atomicAdd(c, 1) == un.nu - 1;
    if (last) *c = 0;  // every unit of the group has counted
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  m = kNegBig;
  l = 0.0f;
#pragma unroll
  for (int e = 0; e < kG1Lane; ++e) acc[e] = 0.0f;
  for (int j = active ? ph : un.nu; j < un.nu; j += a.phases) {
    const long long sj = ((un.first + j) * nhg + un.hg) * a.hg + hl;
    const float2 ml = __ldcg(reinterpret_cast<const float2*>(part_ml + 2 * sj));
    const float4* src = reinterpret_cast<const float4*>(part_acc + sj * a.d + kG1Lane * idx);
    const float4 lo = __ldcg(src), hi = __ldcg(src + 1);
    const float x[kG1Lane] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const float mn = fmaxf(m, ml.x);
    const float alpha = expf(m - mn), w = expf(ml.x - mn);
    m = mn;
    l = l * alpha + ml.y * w;
#pragma unroll
    for (int e = 0; e < kG1Lane; ++e) acc[e] = fmaf(x[e], w, acc[e] * alpha);
  }
  merge_phases(red, a.d, i, idx, hl, a.hg, a.phases, active, lead, m, l, acc);
  if (lead) store8(out, acc, fmaxf(l, 1e-30f));
}

template <typename T>
cudaError_t g1_kernel(void (**kernel)(G1Args<T>)) {
  *kernel = decode_attn_g1<T>;
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && ready[dev])) return err;
  err = cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             G1Cfg<T>::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(*kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < 64) ready[dev] = true;
  return err;
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

// g = 1 (q [B, Hkv, 1, D]): units of hg kv heads (hg dividing Hkv) with
// `phases` lane groups a head, over `grid` blocks (at least B Hkv / hg);
// part holds grid hg (D + 2) floats and counts B Hkv / hg ints, zero before
// the first launch (each launch leaves them zero).  One launch.
extern "C" int decode_attention_g1(
    const void* q, const void* k, const void* v, const int* lengths, int dtype,
    long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, float* out, float* part, int* counts, int batch, int hkv, int seq,
    int d, int window, int hg, int phases, int grid, float scale, float softcap,
    void* stream) {
  if (d <= 0 || d > kMaxD || d % kG1Lane || hg <= 0 || phases <= 0 || hkv % hg ||
      hg * phases > kG1Warps * (32 / (d / kG1Lane)) || (dtype != 0 && dtype != 1) ||
      (long long)grid < (long long)batch * (hkv / hg) || grid <= 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)batch * hkv == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    void (*kernel)(G1Args<T>);
    cudaError_t e = g1_kernel<T>(&kernel);
    if (e != cudaSuccess) return e;
    const G1Args<T> a{static_cast<const T*>(q), static_cast<const T*>(k),
                      static_cast<const T*>(v), lengths, ksb, ksh, kss, vsb, vsh, vss,
                      out, part, counts, batch, hkv, seq, d, window, hg, phases,
                      scale, softcap};
    kernel<<<(unsigned)grid, kG1Threads, G1Cfg<T>::kSmem, s>>>(a);
    return cudaGetLastError();
  };
  return (int)(dtype == 0 ? run((float*)nullptr) : run((bf16*)nullptr));
}

// Blocks of the g = 1 kernel an SM holds (dtype as above).
extern "C" int decode_attention_g1_occupancy(int dtype, int* blocks) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  auto run = [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    void (*kernel)(G1Args<T>);
    cudaError_t e = g1_kernel<T>(&kernel);
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kG1Threads,
                                                         G1Cfg<T>::kSmem);
  };
  return (int)(dtype == 0 ? run((float*)nullptr) : run((bf16*)nullptr));
}
