// Weight-only quantized matrix products y[T, N] = x[T, K] @ W[K, N]:
//
//   * B10, int8: replaces the TPU kernel
//     flash_attention_cute_tpu/ops/quantized_matmul.py `_qmm_kernel` (:149,
//     pallas_call at :178). W = values[K_pad, N_pad] int8 with one f32 scale
//     per column: y = (x @ values) * scales, the scale applied once to the
//     fully combined fp32 sum (exact: it is constant along K).
//   * B11, int4: replaces `_qmm4_kernel` (:360, pallas_call at :429). W is
//     nibble-packed (biased u = q + 8, block-local packing in blocks of
//     bk = min(512, K_pad) rows: packed row r of a block holds K row r in
//     its low nibble and row bk/2 + r in its high nibble) with one f32 scale
//     per (128-row group, column): y = sum over groups g of s[g, n] *
//     (x_g @ q_g). Each group's product is summed in fp32 on its own and
//     multiplied by its fp32 scale into the accumulator; the scale is never
//     folded into a bf16 weight (that would round q * s to bf16).
//
// x is bf16 or f16 with its last dim contiguous, read only up to its logical
// K (never padded in memory); y is written only at its logical T x N,
// contiguous. The packing and padding are the JAX package's
// (ops/quantized_matmul.py in both packages). Numerics: int8 and q = u - 8
// widen to bf16 / f16 exactly, every product is summed in fp32, and y is
// rounded once; sums run in a fixed order, so two calls give the same bits.
//
// Both designs walk the weight in tiles of kRows = 64 stored rows by kBN =
// 128 columns (8 KB; int8: 64 K rows; int4: 64 packed rows, that is the
// low-nibble rows of one 64-row half of a group and the high-nibble rows of
// another). The wrapper's plan (ops/quantized_matmul.py `qmm_plan`) picks
// the design and the number of K splits; a split covers whole units (one
// tile for the int8 prefill; a pair of tiles for int4, so that a group's two
// halves stay in one split, and for the decode design, whose stages hold
// two tiles). With more than one split, each block writes an fp32 partial
// into a workspace and a second small pass in this same entry point adds
// the partials in split order, applies int8's scale and rounds.
//
// Design A, decode and small T (bound by the weight's bytes at 3.35 TB/s;
// compute is under 1 % of the bound). A block of 8 warps owns 128 columns
// (256 where 128-column blocks would already put more than one block on an
// SM), up to 16 rows of x and one K split; splits give about one block per
// SM at every projection of the Llama-3-8B trees. Stages of 16 KB of
// weights (two tiles by 128 columns, or one by 256), with the x rows and
// int4 scale rows that go with them, stream through a ring of kStagesA
// stages in shared memory, filled by 16-byte cp.async.cg copies (3 stages,
// 48 KB of weights, in flight per block). The product is mma.sync
// m16n8k16 with the roles swapped: the weight is the A operand (16 columns
// per m16 tile) and x^T the B operand (8 rows of x per n8 tile), so the few
// rows of x waste no tensor-core work on the weight side. K is permuted
// inside each k16 step (a thread's four k slots are four consecutive stored
// rows) and so are the columns (a thread's 16 m slots are 16 consecutive
// columns): each thread reads its weights with four 16-byte shared loads
// (swizzled against bank conflicts) and its x fragment with one 8-byte
// shared load. Each warp sums 16 of a stage's rows for its 128 columns; the
// warps' sums are added in warp order at the end. Eight warps, not four,
// because one warp a scheduler left the widening's latency bare (measured,
// PERF.md).
//
// Design B, prefill (bound by the bf16 tensor-core rate). A block of three
// warpgroups owns a 128 x 128 tile of y and one K split: warpgroup 0 is the
// producer (one thread issues TMA copies and gives back its registers by
// setmaxnreg), warpgroups 1 and 2 are the consumers. x comes by TMA with
// the 128-byte swizzle (its out-of-bounds zero fill covers the ragged K and
// T edges) through a ring of kXS stages, the raw weight tiles by TMA through
// a ring of kWS stages, each signalled by mbarriers. The block computes
// y^T = W^T x^T with wgmma m64n128k16: the weight is the A operand, read
// from the raw tile by ldmatrix.trans (which hands each lane two columns of
// two K rows, the A fragment's pairs) and widened in registers, 64 weight
// columns per consumer warpgroup; x is the B operand, read K-major straight
// from its TMA stage by all 128 of its rows. Nothing widened goes back to
// shared memory and the two consumers never wait for each other. The next
// step's fragments are widened while the current step's products run.
// int8 accumulates into one fp32 accumulator; int4 orders its K steps so
// that one group's two halves accumulate into one fp32 partial, which is
// multiplied by the group's fp32 scale into the accumulator.
//
// Unpacking, all exact, two values per 32-bit register: a nibble u OR-ed
// into bf16 0x4300 (128 + u) or f16 0x6400 (1024 + u), and one bf16x2 /
// f16x2 fma subtracting 136 / 1032; an int8 byte's low 7 bits OR-ed into the
// same magic, and one fma subtracting the magic with the sign bit folded in
// (`int8_pair`). Not copied from the TPU kernels: their tile caps, the scale
// rows padded to 8 sublanes, the compile-service workaround, and the -8 *
// rowsum(x) correction (subtracting 8 at unpack is exact here).
#include <cstdio>

#include "hopper.cuh"

namespace fact {

constexpr int kBN = 128;                 // columns of y per block (both designs)
constexpr int kRows = 64;                // stored weight rows per tile
constexpr int kTileBytes = kRows * kBN;  // 8 KB of raw weight bytes
constexpr int kGroup4 = 128;             // K rows per int4 scale group

struct QmmArgs {
  const void* x;    // [T, K] in T; row stride x_st, last dim contiguous
  const int8_t* w;  // int8: values [K_pad, N_pad]; int4: packed [K_pad / 2, N_pad]
  const float* s;   // int8: [N_pad]; int4: [K_pad / 128, N_pad]
  void* y;          // [T, N] in T, contiguous
  float* ws;        // [splits, T, N] fp32 partials (splits > 1)
  int t, k, n, k_pad, n_pad;
  int64_t x_st;
  int x_vec;   // x rows are 16-byte aligned: vector loads
  int splits;  // K splits (blockIdx.y in design A, blockIdx.z in design B)
  int tiles;   // weight tiles the product walks
  int unit;    // tiles per split unit: 1 (the int8 prefill) or 2
};

// Tiles [j0, j0 + nj) of split `s`.
__device__ __forceinline__ void split_range(const QmmArgs& p, int s, int& j0, int& nj) {
  const int units = p.tiles / p.unit;
  const int u0 = static_cast<int>(static_cast<int64_t>(s) * units / p.splits);
  const int u1 = static_cast<int>(static_cast<int64_t>(s + 1) * units / p.splits);
  j0 = u0 * p.unit;
  nj = (u1 - u0) * p.unit;
}

// K rows of tile j: int8 rows klo .. klo + 63; int4 the low nibbles hold
// rows klo .. klo + 63 and the high nibbles khi .. khi + 63 (pack blocks of
// bk = min(512, K_pad) rows: 256 or 512, so bk / 2 = 1 << lb).
template <bool kInt4>
__device__ __forceinline__ void tile_rows(int j, int k_pad, int& klo, int& khi) {
  if constexpr (kInt4) {
    const int lb = k_pad >= 512 ? 8 : 7, pr = j * kRows;
    klo = ((pr >> lb) << (lb + 1)) | (pr & ((1 << lb) - 1));
    khi = klo + (1 << lb);
  } else {
    klo = j * kRows;
    khi = klo;
  }
}

// ---------------------------------------------------------------------------
// Exact unpacking.

// Two int8 values b (bytes 0 and 2 of t) to a T2 pair. v = magic + (b & 127)
// with magic 128 (bf16 0x4300) or 1024 (f16 0x6400); b = v - magic - 128 *
// (sign bit), and magic + 128 * (sign bit) is the magic with the sign bit
// OR-ed into its lowest exponent (bf16) or mantissa (f16) bit: one fma.
template <typename T>
__device__ __forceinline__ uint32_t int8_pair(uint32_t t) {
  uint32_t out;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const uint32_t v = (t & 0x007F007Fu) | 0x43004300u, c = (t & 0x00800080u) | 0xC300C300u;
    asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(out) : "r"(v), "r"(0x3F803F80u), "r"(c));
  } else {
    const uint32_t v = (t & 0x007F007Fu) | 0x64006400u, c = (t & 0x00800080u) | 0xE400E400u;
    asm("fma.rn.f16x2 %0, %1, %2, %3;" : "=r"(out) : "r"(v), "r"(0x3C003C00u), "r"(c));
  }
  return out;
}

// Two nibbles u (bits 0-3 and 16-19 of t) to a T2 pair of u - 8.
template <typename T>
__device__ __forceinline__ uint32_t nibbles(uint32_t t) {
  uint32_t out;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const uint32_t v = (t & 0x000F000Fu) | 0x43004300u;  // 128 + u
    asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(out) : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));
  } else {
    const uint32_t v = (t & 0x000F000Fu) | 0x64006400u;  // 1024 + u
    asm("fma.rn.f16x2 %0, %1, %2, %3;" : "=r"(out) : "r"(v), "r"(0x3C003C00u), "r"(0xE408E408u));
  }
  return out;
}

// ---------------------------------------------------------------------------
// cp.async copies and shared-memory loads (TMA, mbarriers and wgmma: hopper.cuh).

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint4 lds128(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a));
  return v;
}

// ---------------------------------------------------------------------------
// Design A: decode and small T (mma.sync, split K, cp.async ring).

constexpr int kDecWarps = 8;
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kStageW = 16 * kDecWarps * kBN;  // 16 KB of raw weight bytes a stage
constexpr int kStagesA = 4;

// The decode design's stage: kHalves column halves of 128 columns, each
// taken by 8 / kHalves warps of 16 stored rows: 128 rows (two tiles) by 128
// columns, or 64 rows (one tile) by 256 columns.
template <int kHalves>
struct DecodeStage {
  static constexpr int kCols = kBN * kHalves;             // columns of y per block
  static constexpr int kKWarps = kDecWarps / kHalves;     // warps along K
  static constexpr int kRowsS = 16 * kKWarps;             // stored rows a stage
  static constexpr int kTiles = kRowsS / kRows;           // tiles a stage
  static constexpr int kXRow = 2 * kRowsS + 32;           // bytes per row of x, padded
};

// A stage: its tiles' weights, x's rows for their K rows (int4: the low and
// the high nibbles' K rows), int4: the scale rows of the two groups (a
// stage starts at an even tile or is one tile, so its low-nibble rows are
// one group, and so are its high-nibble rows).
template <bool kInt4, int kNT8, int kHalves>
__host__ __device__ constexpr int decode_stage_bytes() {
  using S = DecodeStage<kHalves>;
  return kStageW + (kInt4 ? 2 : 1) * 8 * kNT8 * S::kXRow + (kInt4 ? 2 * S::kCols * 4 : 0);
}
template <bool kInt4, int kNT8, int kHalves>
__host__ __device__ constexpr int decode_smem() {
  return kStagesA * decode_stage_bytes<kInt4, kNT8, kHalves>();
}
static_assert(decode_smem<false, 2, 1>() >= kDecWarps * 16 * kBN * 4, "the warps' sums fit the ring");

// Stored row r of a stage (rows of `row_bytes`) keeps its 16-byte chunk c at
// chunk c ^ ((r >> 1) & 6): the four rows 4 t4 .. 4 t4 + 3 and the 16
// columns that a lane reads then fall into distinct banks within each
// quarter warp.
__device__ __forceinline__ uint32_t decode_chunk(int r, int c, int row_bytes) {
  return r * row_bytes + ((c ^ ((r >> 1) & 6)) << 4);
}

__device__ __forceinline__ uint2 lds64(uint32_t a) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0,%1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(a));
  return v;
}
__device__ __forceinline__ void sts128(uint32_t a, const uint4& v) {
  asm volatile("st.shared.v4.u32 [%0], {%1,%2,%3,%4};\n" ::"r"(a), "r"(v.x), "r"(v.y), "r"(v.z),
               "r"(v.w)
               : "memory");
}

template <typename T, bool kInt4, int kNT8, int kHalves>
__global__ void __launch_bounds__(kDecThreads) qmm_decode_kernel(const QmmArgs p) {
  using S = DecodeStage<kHalves>;
  constexpr int kRowsT = 8 * kNT8;  // rows of x per block
  constexpr int kXHalf = kRowsT * S::kXRow;
  constexpr int kScales = kStageW + (kInt4 ? 2 : 1) * kXHalf;
  constexpr int kStage = decode_stage_bytes<kInt4, kNT8, kHalves>();
  constexpr int kChunksRow = S::kCols / 16;  // 16-byte chunks of a stored row
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sbase = smem_u32(smem);
  const int n0 = blockIdx.x * S::kCols, split = blockIdx.y, t0 = blockIdx.z * kRowsT;
  int j0, nj;
  split_range(p, split, j0, nj);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int half = warp / S::kKWarps;  // the warp's 128 columns
  const T* x = static_cast<const T*>(p.x);

  // Copy assignments, fixed for the loop: weight chunks (rows wr + q *
  // kDecThreads / kChunksRow, chunk wc) and at most two chunks of x rows.
  constexpr int kXCh = S::kRowsS / 8;  // 16-byte chunks of a stage's x row
  constexpr int kXChunks = (kInt4 ? 2 : 1) * kRowsT * kXCh;
  constexpr int kWStep = kDecThreads / kChunksRow;
  const int wr = tid / kChunksRow, wc = tid % kChunksRow;
  const int8_t* wsrc = p.w + static_cast<int64_t>(j0 * kRows + wr) * p.n_pad + n0 + wc * 16;
  const int64_t wstep = static_cast<int64_t>(kWStep) * p.n_pad;
  const T* xsrc[2];
  uint32_t xdst[2];
  int xhalf[2], xk[2];
  bool xlive[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int c = tid + q * kDecThreads;
    const int h = c / (kRowsT * kXCh), tok = (c / kXCh) % kRowsT, ch = c % kXCh;
    xlive[q] = c < kXChunks && t0 + tok < p.t;
    xsrc[q] = x + static_cast<int64_t>(t0 + tok) * p.x_st + ch * 8;
    xdst[q] = kStageW + h * kXHalf + tok * S::kXRow + ch * 16;
    xhalf[q] = h;
    xk[q] = ch * 8;
  }

  // Stage i (tiles j0 + i kTiles ..) into ring slot `slot`. Rows of x past
  // T are left as they are (their outputs are never stored); K columns past
  // the logical K are written as zeros (the weight's rows there are zero,
  // and x must not be read there).
  auto issue = [&](int i, int slot) {
    const int j = j0 + i * S::kTiles;
    const uint32_t dst = sbase + slot * kStage;
    const int8_t* src = wsrc + static_cast<int64_t>(i) * S::kRowsS * p.n_pad;
#pragma unroll
    for (int q = 0; q < kStageW / 16 / kDecThreads; ++q)
      cp_async16(dst + decode_chunk(wr + q * kWStep, wc, S::kCols), src + q * wstep);
    int klo, khi;
    tile_rows<kInt4>(j, p.k_pad, klo, khi);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (!xlive[q]) continue;
      const int k0 = xhalf[q] ? khi : klo, k = k0 + xk[q];
      const T* xs = xsrc[q] + k0;
      if (p.x_vec && k + 8 <= p.k) {
        cp_async16(dst + xdst[q], xs);
      } else {
        float e[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) e[i] = k + i < p.k ? Elem<T>::to_float(xs[i]) : 0.f;
        sts128(dst + xdst[q], make_uint4(Elem<T>::pack(e[0], e[1]), Elem<T>::pack(e[2], e[3]),
                                         Elem<T>::pack(e[4], e[5]), Elem<T>::pack(e[6], e[7])));
      }
    }
    if constexpr (kInt4) {
      if (tid < 2 * kChunksRow * 4) {  // the scale rows of the low and the high nibbles' groups
        const int h = tid / (kChunksRow * 4), ch = tid % (kChunksRow * 4);
        const float* sr = p.s + static_cast<int64_t>((h ? khi : klo) >> 7) * p.n_pad + n0;
        cp_async16(dst + kScales + h * S::kCols * 4 + ch * 16, sr + ch * 4);
      }
    }
  };

  // x^T fragments (B operand) for the lane's K rows kr .. kr + 3 of x rows
  // 8 nt + g, from a stage's x rows at `xrows`.
  auto x_frag = [&](uint32_t xrows, int kr, uint32_t (&b)[kNT8][2]) {
#pragma unroll
    for (int nt = 0; nt < kNT8; ++nt) {
      const uint2 v = lds64(xrows + (nt * 8 + g) * S::kXRow + kr * 2);
      b[nt][0] = v.x;
      b[nt][1] = v.y;
    }
  };

  float acc[8][kNT8][4];
#pragma unroll
  for (int mt = 0; mt < 8; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  const int nst = nj / S::kTiles;  // stages: the split holds whole pairs of tiles
#pragma unroll
  for (int s = 0; s < kStagesA - 1; ++s) {
    if (s < nst) issue(s, s);
    cp_async_commit();
  }
  const int kr = (warp % S::kKWarps) * 16 + 4 * t4;  // the lane's first stored row in a stage
  const int wchunk = 8 * half + g;                   // the lane's 16 columns
  for (int i = 0; i < nst; ++i) {
    cp_async_wait<kStagesA - 2>();
    __syncthreads();  // stage i landed for all; every warp is done with stage i - 1
    if (i + kStagesA - 1 < nst) issue(i + kStagesA - 1, (i + kStagesA - 1) % kStagesA);
    cp_async_commit();

    const uint32_t st = sbase + (i % kStagesA) * kStage;
    uint32_t xlo[kNT8][2], xhi[kNT8][2];
    x_frag(st + kStageW, kr, xlo);
    if constexpr (kInt4) x_frag(st + kStageW + kXHalf, kr, xhi);
    uint32_t w[4][4];  // rows kr .. kr + 3, the lane's 16 columns
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint4 v = lds128(st + decode_chunk(kr + r, wchunk, S::kCols));
      w[r][0] = v.x, w[r][1] = v.y, w[r][2] = v.z, w[r][3] = v.w;
    }
    if constexpr (kInt4) {
      float slo[16], shi[16];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t sc = st + kScales + (16 * wchunk + 4 * q) * 4;
        const uint4 a = lds128(sc), b = lds128(sc + S::kCols * 4);
        slo[4 * q] = __uint_as_float(a.x), slo[4 * q + 1] = __uint_as_float(a.y);
        slo[4 * q + 2] = __uint_as_float(a.z), slo[4 * q + 3] = __uint_as_float(a.w);
        shi[4 * q] = __uint_as_float(b.x), shi[4 * q + 1] = __uint_as_float(b.y);
        shi[4 * q + 2] = __uint_as_float(b.z), shi[4 * q + 3] = __uint_as_float(b.w);
      }
#pragma unroll
      for (int mt = 0; mt < 8; ++mt) {
        // Columns 2 mt and 2 mt + 1 of the lane's 16: bytes pos, pos + 1 of word q.
        const int q = mt >> 1, pos = 2 * (mt & 1);
        const uint32_t sel = pos | (pos + 1) << 4 | (pos + 4) << 8 | (pos + 5) << 12;
        const uint32_t t01 = __byte_perm(w[0][q], w[1][q], sel);  // rows kr, kr + 1
        const uint32_t t23 = __byte_perm(w[2][q], w[3][q], sel);  // rows kr + 2, kr + 3
        const uint32_t alo[4] = {nibbles<T>(t01), nibbles<T>(t01 >> 8), nibbles<T>(t23),
                                 nibbles<T>(t23 >> 8)};
        const uint32_t ahi[4] = {nibbles<T>(t01 >> 4), nibbles<T>(t01 >> 12),
                                 nibbles<T>(t23 >> 4), nibbles<T>(t23 >> 12)};
#pragma unroll
        for (int nt = 0; nt < kNT8; ++nt) {
          float plo[4] = {0.f, 0.f, 0.f, 0.f}, phi[4] = {0.f, 0.f, 0.f, 0.f};
          Elem<T>::mma(plo, alo, xlo[nt][0], xlo[nt][1]);
          Elem<T>::mma(phi, ahi, xhi[nt][0], xhi[nt][1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 2 * mt + (e >> 1);
            acc[mt][nt][e] = fmaf(plo[e], slo[c], acc[mt][nt][e]);
            acc[mt][nt][e] = fmaf(phi[e], shi[c], acc[mt][nt][e]);
          }
        }
      }
    } else {
#pragma unroll
      for (int mt = 0; mt < 8; ++mt) {
        // t: bytes pos, pos + 1 (columns 2 mt, 2 mt + 1) of two rows, at
        // bytes 0, 1 and 2, 3; int8_pair takes bytes 0 and 2.
        const int q = mt >> 1, pos = 2 * (mt & 1);
        const uint32_t sel = pos | (pos + 1) << 4 | (pos + 4) << 8 | (pos + 5) << 12;
        const uint32_t t01 = __byte_perm(w[0][q], w[1][q], sel);
        const uint32_t t23 = __byte_perm(w[2][q], w[3][q], sel);
        const uint32_t a[4] = {int8_pair<T>(t01), int8_pair<T>(t01 >> 8), int8_pair<T>(t23),
                               int8_pair<T>(t23 >> 8)};
#pragma unroll
        for (int nt = 0; nt < kNT8; ++nt) Elem<T>::mma(acc[mt][nt], a, xlo[nt][0], xlo[nt][1]);
      }
    }
  }

  // The warps' sums, added in warp order.
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [kDecWarps][kRowsT][kBN]
#pragma unroll
  for (int mt = 0; mt < 8; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(warp * kRowsT + nt * 8 + 2 * t4 + (e & 1)) * kBN + 16 * g + 2 * mt + (e >> 1)] =
            acc[mt][nt][e];
  __syncthreads();
  for (int o = tid; o < kRowsT * S::kCols; o += kDecThreads) {
    const int tok = o / S::kCols, c = o % S::kCols, row = t0 + tok, col = n0 + c;
    if (row >= p.t || col >= p.n) continue;
    // The sums of the warps of column half c / 128, in warp order.
    const float* r0 = red + ((c / kBN) * S::kKWarps * kRowsT + tok) * kBN + c % kBN;
    float v = r0[0];
#pragma unroll
    for (int wi = 1; wi < S::kKWarps; ++wi) v += r0[wi * kRowsT * kBN];
    const int64_t at = static_cast<int64_t>(row) * p.n + col;
    if (p.splits > 1) {
      p.ws[static_cast<int64_t>(split) * p.t * p.n + at] = v;
    } else {
      if constexpr (!kInt4) v *= p.s[col];
      static_cast<T*>(p.y)[at] = Elem<T>::from_float(v);
    }
  }
}

// ---------------------------------------------------------------------------
// Design B: prefill (wgmma, TMA rings, a producer warpgroup).

constexpr int kPreThreads = 384;
constexpr int kPreBM = 128;               // rows of x per block
constexpr int kXS = 6, kWS = 6;           // x and raw weight ring stages
constexpr int kXBytes = kPreBM * 64 * 2;  // 64 K columns of 128 rows
constexpr int kPreSmem = 1024 + kXS * kXBytes + kWS * kTileBytes + (2 * kXS + 2 * kWS) * 8;

// Step i of a block: its local weight tile and which nibbles (int4). int4
// walks pairs of tiles 2p, 2p + 1: their low nibbles (one group, 128 K rows)
// in steps 4p, 4p + 1, then their high nibbles (another group) in 4p + 2,
// 4p + 3. int8: step i is tile i.
template <bool kInt4>
__device__ __forceinline__ void step_tile(int i, int& lt, int& half) {
  if constexpr (kInt4) {
    lt = 2 * (i >> 2) + (i & 1);
    half = (i >> 1) & 1;
  } else {
    lt = i;
    half = 0;
  }
}

// One register of ldmatrix.trans over raw weight bytes holds, for the lane
// (g, t4), columns 2g, 2g + 1 (bytes 0, 1) of K row 2 t4 and the same
// columns (bytes 2, 3) of K row 2 t4 + 1: the A fragment pair of column 2g
// is bytes 0 and 2, that of column 2g + 1 bytes 1 and 3. int4 takes the
// low or the high nibbles (`half`).
template <typename T, bool kInt4>
__device__ __forceinline__ void widen_a(uint32_t r, int half, uint32_t& even, uint32_t& odd) {
  if constexpr (kInt4) {
    const uint32_t v = r >> (4 * half);
    even = nibbles<T>(v);
    odd = nibbles<T>(v >> 8);
  } else {
    even = int8_pair<T>(r);
    odd = int8_pair<T>(r >> 8);
  }
}

__device__ __forceinline__ void fence_a(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// y^T = W^T x^T per block: the weight is wgmma's A operand, widened into
// registers (M = 128 weight columns, 64 per consumer warpgroup); x is the B
// operand read from its TMA stage (N = 128 rows of x, K-major).
template <typename T, bool kInt4>
__global__ void __launch_bounds__(kPreThreads, 1)
    qmm_prefill_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap, const QmmArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sx = (smem_u32(smem) + 1023) & ~1023u;  // the 128-byte swizzle needs 1 KB
  const uint32_t sw = sx + kXS * kXBytes, bars = sw + kWS * kTileBytes;
  auto full_x = [&](int s) { return bars + 8 * s; };
  auto empty_x = [&](int s) { return bars + 8 * (kXS + s); };
  auto full_w = [&](int s) { return bars + 8 * (2 * kXS + s); };
  auto empty_w = [&](int s) { return bars + 8 * (2 * kXS + kWS + s); };

  const int m0 = blockIdx.x * kPreBM, n0 = blockIdx.y * kBN;
  int j0, nj;
  split_range(p, blockIdx.z, j0, nj);
  const int nsteps = kInt4 ? 2 * nj : nj;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kXS; ++s) mbar_init(full_x(s), 1), mbar_init(empty_x(s), 8);
    for (int s = 0; s < kWS; ++s) mbar_init(full_w(s), 1), mbar_init(empty_w(s), 8);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: one thread keeps the rings full.
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int i = 0; i < nsteps; ++i) {
        int lt, half, klo, khi;
        step_tile<kInt4>(i, lt, half);
        tile_rows<kInt4>(j0 + lt, p.k_pad, klo, khi);
        const int xs = i % kXS;
        mbar_wait(empty_x(xs), ((i / kXS) & 1) ^ 1);
        mbar_expect_tx(full_x(xs), kXBytes);
        tma_load_2d(sx + xs * kXBytes, &xmap, half ? khi : klo, m0, full_x(xs));
        if (half == 0) {  // the tile's first use
          const int ws = lt % kWS;
          mbar_wait(empty_w(ws), ((lt / kWS) & 1) ^ 1);
          mbar_expect_tx(full_w(ws), kTileBytes);
          tma_load_2d(sw + ws * kTileBytes, &wmap, n0, (j0 + lt) * kRows, full_w(ws));
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int ct = threadIdx.x - 128, cwg = ct >> 7, lane = ct & 31, g = lane >> 2;
    // The warp's 16 weight columns: 16-byte chunk 4 cwg + (warp in the
    // warpgroup) of the tile's 128-byte rows. ldmatrix lane addresses: lanes
    // 8q .. 8q + 7 give the 8 rows of matrix q (K rows 8q .. 8q + 7 of two
    // k16 steps).
    const int chunk = 4 * cwg + ((ct >> 5) & 3);
    const int lrow = 8 * (lane >> 3) + (lane & 7);

    // Step i's A fragments (4 k16 steps) from its raw tile.
    auto load_a = [&](int i, uint32_t (&a)[4][4]) {
      int lt, half;
      step_tile<kInt4>(i, lt, half);
      const int slot = lt % kWS;
      mbar_wait(full_w(slot), (lt / kWS) & 1);
      const uint32_t tile = sw + slot * kTileBytes;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kr = 32 * h + lrow;
        uint32_t r[4];
        ldmatrix_x4_trans(r, tile + kr * 128 + ((chunk ^ (kr & 7)) << 4));
#pragma unroll
        for (int s2 = 0; s2 < 2; ++s2) {
          widen_a<T, kInt4>(r[2 * s2], half, a[2 * h + s2][0], a[2 * h + s2][1]);
          widen_a<T, kInt4>(r[2 * s2 + 1], half, a[2 * h + s2][2], a[2 * h + s2][3]);
        }
      }
      if (!kInt4 || half == 1) {  // the tile's last use
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_w(slot));
      }
    };

    float acc[64], part[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.f, part[e] = 0.f;
    const int col = n0 + 16 * chunk + 2 * g;  // the lane's two weight columns

    // One step: its products from `cur`, then step i + 1's fragments into
    // `nxt` once the products that read `nxt` last (step i - 1) are done.
    float2 sc = make_float2(0.f, 0.f);  // int4: the current group's scales of the two columns
    auto step = [&](int i, uint32_t (&cur)[4][4], uint32_t (&nxt)[4][4]) {
      const int xs = i % kXS;
      if constexpr (kInt4) {
        if (!(i & 1)) {  // a group's first step: its scales, in flight until its last
          int lt, half, klo, khi;
          step_tile<true>(i, lt, half);
          tile_rows<true>(j0 + lt, p.k_pad, klo, khi);
          sc = *reinterpret_cast<const float2*>(
              p.s + static_cast<int64_t>((half ? khi : klo) / kGroup4) * p.n_pad + col);
        }
      }
      mbar_wait(full_x(xs), (i / kXS) & 1);
      const uint64_t db = wgmma_desc(sx + xs * kXBytes, 16, 1024);
      float(&d)[64] = *(kInt4 ? &part : &acc);
      fence_regs(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<T, 128, false>(d, cur[kk], db + 2 * kk, (kInt4 && !(i & 1) && kk == 0) ? 0 : 1);
      wgmma_commit();
      fence_regs(d);
      wgmma_wait<1>();  // step i - 1's products are done
      fence_regs(d);
      fence_a(nxt);
      if (!kInt4 && i > 0 && lane == 0) mbar_arrive(empty_x((i - 1) % kXS));
      if (i + 1 < nsteps) load_a(i + 1, nxt);
      if constexpr (kInt4) {
        if (i & 1) {  // the group is complete: acc += part * s
          wgmma_wait<0>();
          fence_regs(part);
          fence_a(cur);
#pragma unroll
          for (int e = 0; e < 64; ++e) acc[e] = fmaf(part[e], (e & 2) ? sc.y : sc.x, acc[e]);
          if (lane == 0) {
            mbar_arrive(empty_x((i - 1) % kXS));
            mbar_arrive(empty_x(xs));
          }
        }
      }
    };

    uint32_t a0[4][4], a1[4][4];
    if (nsteps > 0) load_a(0, a0);
    for (int i = 0; i < nsteps; i += 2) {
      step(i, a0, a1);
      if (i + 1 < nsteps) step(i + 1, a1, a0);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_a(a0);
    fence_a(a1);

    // acc[4 jb + e]: weight column col + (e >> 1), x row 8 jb + 2 t4 + (e & 1).
    float s0 = 1.f, s1 = 1.f;
    if constexpr (!kInt4) {
      if (col < p.n) s0 = p.s[col];
      if (col + 1 < p.n) s1 = p.s[col + 1];
    }
    const int rbase = m0 + 2 * (lane & 3);
#pragma unroll
    for (int jb = 0; jb < 16; ++jb) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rbase + 8 * jb + h;
        if (row >= p.t) continue;
        const float v0 = acc[4 * jb + h], v1 = acc[4 * jb + 2 + h];
        const int64_t at = static_cast<int64_t>(row) * p.n + col;
        if (p.splits > 1) {
          float* dst = p.ws + static_cast<int64_t>(blockIdx.z) * p.t * p.n + at;
          if (col < p.n) dst[0] = v0;
          if (col + 1 < p.n) dst[1] = v1;
        } else {
          T* y = static_cast<T*>(p.y) + at;
          if (col + 1 < p.n && !(p.n & 1)) {
            *reinterpret_cast<uint32_t*>(y) = Elem<T>::pack(v0 * s0, v1 * s1);
          } else {
            if (col < p.n) y[0] = Elem<T>::from_float(v0 * s0);
            if (col + 1 < p.n) y[1] = Elem<T>::from_float(v1 * s1);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The split-K combine: y = round(sum of the partials in split order [* s]).

template <typename T, bool kScale>
__global__ void __launch_bounds__(256) qmm_combine_kernel(const QmmArgs p) {
  const int64_t total = static_cast<int64_t>(p.t) * p.n;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (idx >= total) return;
  float v = p.ws[idx];
  for (int s = 1; s < p.splits; ++s) v += p.ws[s * total + idx];
  if constexpr (kScale) v *= p.s[idx % p.n];
  static_cast<T*>(p.y)[idx] = Elem<T>::from_float(v);
}

// ---------------------------------------------------------------------------
// Host side.

template <typename T, bool kInt4, int kNT8, int kHalves>
static int launch_decode(const QmmArgs& p, cudaStream_t stream) {
  constexpr int kSmem = decode_smem<kInt4, kNT8, kHalves>();
  constexpr int kCols = DecodeStage<kHalves>::kCols;
  static const int configured = allow_smem(qmm_decode_kernel<T, kInt4, kNT8, kHalves>, kSmem);
  if (configured != cudaSuccess) return configured;
  const dim3 grid((p.n + kCols - 1) / kCols, p.splits, (p.t + 8 * kNT8 - 1) / (8 * kNT8));
  qmm_decode_kernel<T, kInt4, kNT8, kHalves><<<grid, kDecThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool kInt4, int kHalves>
static int launch_decode_rows(const QmmArgs& p, cudaStream_t stream) {
  return p.t <= 8 ? launch_decode<T, kInt4, 1, kHalves>(p, stream)
                  : launch_decode<T, kInt4, 2, kHalves>(p, stream);
}

template <typename T, bool kInt4>
static int launch_prefill(const QmmArgs& p, int dtype, cudaStream_t stream) {
  static const int configured = allow_smem(qmm_prefill_kernel<T, kInt4>, kPreSmem);
  if (configured != cudaSuccess) return configured;
  CUtensorMap xmap, wmap;
  const CUtensorMapDataType xt =
      dtype == kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  const int w_rows = kInt4 ? p.k_pad / 2 : p.k_pad;
  if (!make_map(&xmap, xt, p.x, p.k, p.t, p.x_st * 2, 64, kPreBM) ||
      !make_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.w, p.n_pad, w_rows, p.n_pad, kBN, kRows))
    return cudaErrorInvalidValue;
  const dim3 grid((p.t + kPreBM - 1) / kPreBM, (p.n + kBN - 1) / kBN, p.splits);
  qmm_prefill_kernel<T, kInt4><<<grid, kPreThreads, kPreSmem, stream>>>(xmap, wmap, p);
  return cudaGetLastError();
}

enum Route : int { kDecode = 0, kPrefill = 1 };

template <typename T, bool kInt4>
static int run_qmm(const QmmArgs& p, int route, int tile_n, int dtype, cudaStream_t stream) {
  int err;
  if (route == kPrefill) {
    err = launch_prefill<T, kInt4>(p, dtype, stream);
  } else if (tile_n == kBN) {
    err = launch_decode_rows<T, kInt4, 1>(p, stream);
  } else {
    err = launch_decode_rows<T, kInt4, 2>(p, stream);
  }
  if (err != cudaSuccess || p.splits == 1) return err;
  const int64_t total = static_cast<int64_t>(p.t) * p.n;
  qmm_combine_kernel<T, !kInt4><<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(p);
  return cudaGetLastError();
}

template <bool kInt4>
static int dispatch_qmm(const void* x, const void* w, const void* s, void* y, void* ws, int t,
                        int k, int n, int k_pad, int n_pad, long long x_st, int x_vec, int route,
                        int splits, int tile_n, int dtype, void* stream) {
  QmmArgs p{};
  p.x = x;
  p.w = static_cast<const int8_t*>(w);
  p.s = static_cast<const float*>(s);
  p.y = y;
  p.ws = static_cast<float*>(ws);
  p.t = t, p.k = k, p.n = n, p.k_pad = k_pad, p.n_pad = n_pad;
  p.x_st = x_st;
  p.x_vec = x_vec;
  p.splits = splits;
  // int8 prefill walks the 64-row tiles up to K; the decode design walks
  // pairs of tiles (its stages); int4 every packed row, in pairs.
  p.tiles = kInt4 ? k_pad / 2 / kRows
                  : (route == kPrefill ? (k + kRows - 1) / kRows : 2 * ((k + 2 * kRows - 1) / (2 * kRows)));
  p.unit = kInt4 || route != kPrefill ? 2 : 1;
  if (splits < 1 || splits > p.tiles / p.unit || (splits > 1 && ws == nullptr) ||
      (route == kPrefill && (!x_vec || tile_n != kBN)) || (route != kPrefill && route != kDecode) ||
      (tile_n != kBN && tile_n != 2 * kBN))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return run_qmm<__nv_bfloat16, kInt4>(p, route, tile_n, dtype, st);
  if (dtype == kF16) return run_qmm<__half, kInt4>(p, route, tile_n, dtype, st);
  return cudaErrorInvalidValue;
}

template <typename T>
static void report_type(char* out, int cap, int& used, const char* t) {
  char name[96];
#define QMM_REPORT(label, kernel, smem)                 \
  snprintf(name, sizeof(name), "%s %s", label, t);     \
  report_one(out, cap, used, name, kernel, smem)
  QMM_REPORT("B10 decode x rows <= 8", (qmm_decode_kernel<T, false, 1, 1>),
             (decode_smem<false, 1, 1>()));
  QMM_REPORT("B10 decode x rows <= 16", (qmm_decode_kernel<T, false, 2, 1>),
             (decode_smem<false, 2, 1>()));
  QMM_REPORT("B10 decode 256 columns, x rows <= 8", (qmm_decode_kernel<T, false, 1, 2>),
             (decode_smem<false, 1, 2>()));
  QMM_REPORT("B10 decode 256 columns, x rows <= 16", (qmm_decode_kernel<T, false, 2, 2>),
             (decode_smem<false, 2, 2>()));
  QMM_REPORT("B10 prefill", (qmm_prefill_kernel<T, false>), kPreSmem);
  QMM_REPORT("B10 combine", (qmm_combine_kernel<T, true>), 0);
  QMM_REPORT("B11 decode x rows <= 8", (qmm_decode_kernel<T, true, 1, 1>),
             (decode_smem<true, 1, 1>()));
  QMM_REPORT("B11 decode x rows <= 16", (qmm_decode_kernel<T, true, 2, 1>),
             (decode_smem<true, 2, 1>()));
  QMM_REPORT("B11 decode 256 columns, x rows <= 8", (qmm_decode_kernel<T, true, 1, 2>),
             (decode_smem<true, 1, 2>()));
  QMM_REPORT("B11 decode 256 columns, x rows <= 16", (qmm_decode_kernel<T, true, 2, 2>),
             (decode_smem<true, 2, 2>()));
  QMM_REPORT("B11 prefill", (qmm_prefill_kernel<T, true>), kPreSmem);
  QMM_REPORT("B11 combine", (qmm_combine_kernel<T, false>), 0);
#undef QMM_REPORT
}

}  // namespace fact

// Writes the report of every B10 / B11 instantiation into `out` (at most
// `cap` bytes, NUL-terminated); returns 0.
extern "C" int fact_qmm_report(char* out, int cap) {
  int used = 0;
  if (cap <= 0) return 0;
  out[0] = 0;
  fact::report_type<__nv_bfloat16>(out, cap, used, "bf16");
  fact::report_type<__half>(out, cap, used, "f16");
  out[cap - 1] = 0;
  return 0;
}

// Each returns a cudaError_t code (0 on success). Shapes, dtypes and
// contiguity are checked by the Python wrapper (ops/quantized_matmul.py),
// which also plans `route` (0 decode, 1 prefill), `splits` and the decode
// design's block width `tile_n` (128 or 256 columns; `qmm_plan`)
// and allocates the fp32 workspace `ws` [splits, T, N] when splits > 1:
// K_pad a multiple of 128 (int8) or 256 (int4), N_pad of 128, k <= K_pad.
// `dtype` is x's (and y's) code (common.cuh).
extern "C" int fact_qmm_int8(const void* x, const void* w, const void* s, void* y, void* ws,
                             int t, int k, int n, int k_pad, int n_pad, long long x_st, int x_vec,
                             int route, int splits, int tile_n, int dtype, void* stream) {
  return fact::dispatch_qmm<false>(x, w, s, y, ws, t, k, n, k_pad, n_pad, x_st, x_vec, route,
                                   splits, tile_n, dtype, stream);
}

extern "C" int fact_qmm_int4(const void* x, const void* w, const void* s, void* y, void* ws,
                             int t, int k, int n, int k_pad, int n_pad, long long x_st, int x_vec,
                             int route, int splits, int tile_n, int dtype, void* stream) {
  return fact::dispatch_qmm<true>(x, w, s, y, ws, t, k, n, k_pad, n_pad, x_st, x_vec, route,
                                  splits, tile_n, dtype, stream);
}
