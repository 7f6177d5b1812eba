// The Hopper body of the attention forwards over many query rows, shared by
// P / B2 (flash_fwd.cu: K and V from strided [B, H, S, D] views), B6 / B9
// (paged_extend.cuh: K and V from the pages of a pool, B9's widened from
// int8 / e4m3), B4 (flash_chunked.cu: a contiguous cache, q heads of a GQA
// group packed into a block) and B12 (flash_varlen.cu: packed sequences).
// Each kernel has a producer warpgroup of its own that fills the rings
// below; this header holds the rings' layout and the consumers' side, which
// is the same for all six but for the mask (`Visible`, `Extend`,
// `Segments`, a template choice), B4's P in two parts at verify rounds and
// B4's (o, m, l) partials (`Extend<kSplit, true>`, `PartialsOut`), which it
// stores instead of O:
//
//   * One block per (128 q rows, q head, batch row), three warpgroups:
//     warpgroup 0 produces, warpgroups 1 and 2 consume 64 rows each.
//   * Q arrives once into a 128-row tile; K and V tiles of kN keys stream
//     through two rings (K and V apart, each slot with a full and an empty
//     mbarrier), each 64-column block of D one box of 128-byte rows in the
//     128-byte swizzle.
//   * S = Q K^T is wgmma with both operands in shared memory, K-major. S
//     stays in registers: scaled by the keys' scales (B9), capped, masked
//     and exponentiated there, multiplied by the values' scales (B9) and
//     rounded to the input type, its accumulator layout is the register A
//     operand of O += P V, whose B operand V is read MN-major from its slot
//     (the descriptor's transpose bit): no V^T copy, no round trip of P
//     through shared memory.
//   * The softmax is exact, in fp32 (the `stable="strict"` semantics: the
//     row max is updated at every tile, no lazy rescale); 1/l is applied
//     once at the end, and a row with no visible key (l = 0) is written as
//     exact zeros (B4's partials store O, m and l as they stand). Row
//     statistics are reduced over the four threads (a quad) that hold a row
//     in the accumulator layout. No atomics: a second call writes the same
//     bits.
//   * Overlap: a consumer issues S of tile j together with P V of tile
//     j - 1 and computes tile j's exponentials while P V runs; the two
//     consumers take turns issuing (named barriers, "ping-pong"), so one's
//     products run while the other computes. A K slot is free once S is, a
//     V slot only a tile later, so the K ring is the deeper.
//   * The walk is a block's tile range; the mask runs only on tiles that
//     cross the diagonal, the window's lower edge or the end of the keys,
//     and a consumer skips a tile in which it sees no key (it still hands
//     back its slots). The wgmma products stay in straight-line code: ptxas
//     serializes a wgmma inside a data-dependent branch (C7520).
//   * D 64 / 128: tiles of 128 keys, S 64 fp32 registers a thread, O 32 /
//     64, P 32; D 256: tiles of 64 keys, S 32, O 128 (two products of N 128
//     per k-step of P V), P 16.
//   * The wide layout, D 512 (P / B2, B4 with its partials, B6, B9 and
//     B12: d from 257 to 512): O of 512 columns would take 256 registers a thread
//     and a 64-key K or V tile 64 KB, so a block computes one chunk of 256
//     of O's columns (grid y; Tiles::kDO), recomputing S over the whole
//     depth in each chunk (6 d operations a visible pair where one pass
//     takes 4 d); Q stays whole (128 KB), tiles are of 32 keys: a K tile of
//     32 KB, a V tile holds its chunk's 256 columns (16 KB). S 16
//     registers, O 128 (as D 256), P 8. Every chunk computes the same S,
//     max and sum bit for bit; the lse, and B4's partials' m and l, are
//     written by chunk 0 alone, each chunk its columns of O (or of the
//     partials' o).
#pragma once

#include "hopper.cuh"

namespace fact {

constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kBlockM = 128;   // q rows of a block
constexpr int kTileM = 64;     // q rows of a consumer

// Tile sizes by head dim, in bytes: a 64-column box of Q or of a K / V tile.
template <int D>
struct Tiles {
  static constexpr int kN = D > 256 ? 32 : D == 256 ? 64 : 128;  // keys of a tile
  static constexpr int kDO = D > 256 ? 256 : D;  // O's columns a block computes: a chunk
  static constexpr int kChunks = D / kDO;        // blocks along grid y
  static constexpr int kQBox = kBlockM * 128;
  static constexpr int kKVBox = kN * 128;
  static constexpr int kQ = D / 64 * kQBox;
  static constexpr int kKV = D / 64 * kKVBox;  // a K tile (and a V tile where kDO == D)
  static constexpr int kV = kDO / 64 * kKVBox;  // a V tile: its chunk's columns
};

// A block's shared memory from `base` (1 KB aligned, for the swizzle): the
// Q tile (kQBytes; P-i8 / B2-i8 follow it with their int8 Q tile), the K
// ring (kKStages slots of kKSlot bytes: a tile, or P-i8's int8 tile), the V
// ring (kVStages slots of a V tile), the kernel's own bytes, and at `kBars`
// the mbarriers: q_full, then a full and an empty barrier a slot (K's, then
// V's), then `extra(i)`, the producer's own. Tile `it` of the walk takes
// slot it % stages. Every address is base plus a constant, so the consumers
// hold one register.
template <int D, int kKStages, int kVStages, int kBars, int kKSlot = Tiles<D>::kKV,
          int kQBytes = Tiles<D>::kQ>
struct Rings {
  static constexpr int kBarriers = 1 + 2 * (kKStages + kVStages);
  static constexpr int kK0 = kQBytes, kV0 = kK0 + kKStages * kKSlot;
  uint32_t base;

  __device__ __forceinline__ uint32_t sQ() const { return base; }
  __device__ __forceinline__ uint32_t q_full() const { return base + kBars; }
  __device__ __forceinline__ uint32_t sK(int it) const {
    return base + kK0 + it % kKStages * kKSlot;
  }
  __device__ __forceinline__ uint32_t sV(int it) const {
    return base + kV0 + it % kVStages * Tiles<D>::kV;
  }
  __device__ __forceinline__ uint32_t full_k(int it) const {
    return base + kBars + 8 * (1 + it % kKStages);
  }
  __device__ __forceinline__ uint32_t empty_k(int it) const {
    return base + kBars + 8 * (1 + kKStages + it % kKStages);
  }
  __device__ __forceinline__ uint32_t full_v(int it) const {
    return base + kBars + 8 * (1 + 2 * kKStages + it % kVStages);
  }
  __device__ __forceinline__ uint32_t empty_v(int it) const {
    return base + kBars + 8 * (1 + 2 * kKStages + kVStages + it % kVStages);
  }
  __device__ __forceinline__ uint32_t extra(int i) const {
    return base + kBars + 8 * (kBarriers + i);
  }
  // The parity of tile it's pass through its slot.
  __device__ __forceinline__ int k_pass(int it) const { return (it / kKStages) & 1; }
  __device__ __forceinline__ int v_pass(int it) const { return (it / kVStages) & 1; }

  // One thread: `arrivals` arrive on a full barrier (1: the producer's
  // expect_tx), the consumers' 8 warps on an empty one.
  __device__ __forceinline__ void init(int arrivals) const {
    mbar_init(q_full(), 1);
    for (int s = 0; s < kKStages; ++s) mbar_init(full_k(s), arrivals), mbar_init(empty_k(s), 8);
    for (int s = 0; s < kVStages; ++s) mbar_init(full_v(s), arrivals), mbar_init(empty_v(s), 8);
  }
};

// Which keys the rows of a block see: key n from row m iff n < skv, when
// causal n <= m + offset, and with a window W > 0 n > m + offset - W.
struct Visible {
  int sq, skv, offset, causal, window;
};

// The softmax's scalars: softmax_scale * log2(e) (softmax runs in base 2),
// the cap c * log2(e) (0 for none) and softcap()'s factor of a raw score.
struct Scores {
  float scale_log2, softcap_log2, cap_exp;
};

// The Scores of a launch, from the two scalars the wrappers pass.
inline Scores scores(float scale_log2, float softcap_log2) {
  return {scale_log2, softcap_log2,
          softcap_log2 > 0.f ? 2.f * 1.4426950408889634f * scale_log2 / softcap_log2 : 0.f};
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The soft cap of a raw score s: c2 tanh(y), y = s * scale_log2 / c2, as
// c2 - 2 c2 / (1 + 2^(2 log2(e) y)): two approximate MUFU operations
// (relative errors near 2^-22) where tanhf takes a dozen instructions more.
// Its absolute error stays near 1e-6 c2 (about 1e-4 in the base-2 score at
// Gemma 2's c2 = 72), far inside P's rounding to the input type.
__device__ __forceinline__ float softcap_of(float x, const Scores& p) {  // x = s * cap_exp
  return fmaf(-2.f * p.softcap_log2, rcp(1.f + ex2(x)), p.softcap_log2);
}
__device__ __forceinline__ float softcap(float s, const Scores& p) {
  return softcap_of(s * p.cap_exp, p);
}

// Named barriers of the two consumer warpgroups (ids 1 and 2; 0 is
// __syncthreads): a sync waits for the other's `n / 2` arrivals.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// S = Q K^T of a consumer's 64 rows and a tile's kN keys, both K-major.
template <typename T, int D, int kN>
__device__ __forceinline__ void qk_products(float (&s)[kN / 2], uint32_t q, uint32_t k) {
  constexpr int kQBox = kBlockM * 128, kKBox = kN * 128;
  wgmma_ss<T, kN, false>(s, kmajor(q, 0, kQBox), kmajor(k, 0, kKBox));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk) wgmma_ss<T, kN, true>(s, kmajor(q, kk, kQBox), kmajor(k, kk, kKBox));
}

// P-i8 / B2-i8: S = Q K^T of int8 rows, K-major, into s32 accumulators: a
// consumer's 64 rows of the int8 Q tile (`q`: its first row) and a tile's
// kN int8 keys, D / 32 k-steps of 32 bytes (the byte step of bf16's k16).
// Rows of D bytes: 128-byte boxes (two at D 256); at D 64 one box of 64-byte
// rows in the 64-byte swizzle.
template <int D, int kN>
__device__ __forceinline__ void qk_products_i8(uint32_t (&s)[kN / 2], uint32_t q, uint32_t k) {
  if constexpr (D == 64) {
    wgmma_ss_s8<kN, false>(s, kmajor_sw64(q, 0), kmajor_sw64(k, 0));
    wgmma_ss_s8<kN, true>(s, kmajor_sw64(q, 1), kmajor_sw64(k, 1));
  } else {
    constexpr int kQBox = kBlockM * 128, kKBox = kN * 128;
    wgmma_ss_s8<kN, false>(s, kmajor(q, 0, kQBox), kmajor(k, 0, kKBox));
#pragma unroll
    for (int kk = 1; kk < D / 32; ++kk)
      wgmma_ss_s8<kN, true>(s, kmajor(q, kk, kQBox), kmajor(k, kk, kKBox));
  }
}

// O += P V over a tile's kN keys: P in registers (the A fragments of each
// k-step of 16 keys), V MN-major from its slot; D: O's columns (Tiles::kDO),
// at 256 two products of N 128 a k-step.
template <typename T, int D, int kN>
__device__ __forceinline__ void pv_products(float (&o)[D == 256 ? 2 : 1][D == 256 ? 64 : D / 2],
                                            const uint32_t (&pa)[kN / 16][4], uint32_t v) {
  constexpr int kOBlocks = D == 256 ? 2 : 1, kON = D / kOBlocks, kBox = kN * 128;
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk)
#pragma unroll
    for (int c = 0; c < kOBlocks; ++c)
      wgmma_rs<T, kON, true>(o[c], pa[kk], mnmajor(v + c * 2 * kBox, kk, kBox), 1);
}

// No pair of the 64 rows (m0..) x kN keys (n0..) is visible.
template <int kN>
__device__ __forceinline__ bool tile_dead(const Visible& p, int m0, int n0) {
  return m0 >= p.sq || n0 >= p.skv || (p.causal && n0 > m0 + kTileM - 1 + p.offset) ||
         (p.window > 0 && n0 + kN - 1 <= m0 + p.offset - p.window);
}
// Every key of the tile is visible from every row: no mask needed (rows
// past Sq are never stored).
template <int kN>
__device__ __forceinline__ bool tile_full(const Visible& p, int m0, int n0) {
  return n0 + kN <= p.skv && (!p.causal || n0 + kN - 1 <= m0 + p.offset) &&
         (p.window <= 0 || n0 > m0 + kTileM - 1 + p.offset - p.window);
}

// Two fp32 scales of neighbouring keys from shared memory.
__device__ __forceinline__ float2 lds_f32x2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts_u32x4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}
__device__ __forceinline__ uint4 lds_u32x4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}
__device__ __forceinline__ int lds_s32(uint32_t addr) {
  int v;
  asm volatile("ld.shared.s32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ int2 lds_s32x2(uint32_t addr) {
  int2 v;
  asm volatile("ld.shared.v2.s32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(addr));
  return v;
}

// The two values of T packed in a 32-bit word, as floats (exact).
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t w) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xFFFF0000u));
  else
    return make_float2(__half2float(__ushort_as_half(static_cast<unsigned short>(w & 0xFFFFu))),
                       __half2float(__ushort_as_half(static_cast<unsigned short>(w >> 16))));
}

// P-i8 / B2-i8: a consumer's part of the int8 Q tile (at q8) from the
// block's bf16 / f16 Q tile (at q16, 128-byte swizzled boxes of 64
// columns). A quad (t = 0..3) takes the rows `row` and row + 8 of the block
// that it holds in the accumulator layout, each thread their 16-byte int8
// chunks t, t + 4, ...: q times q_scale rounded to T (the TPU wrapper
// pre-scales q so, in fp32, and rounds it to q's type), a = max |q_row|
// (1 where 0), q8 = rint(q * (127 / a)) clipped to +-127, written in the
// layout of the K tiles (qk_products_i8). Per-row scales: the TPU kernel's
// one scale a tile is a workaround of its lane layout; here each thread
// holds its rows anyway. Returns each row's factor (a / 127) / 127 (the
// TPU kernel's qa * (1 / 127)) in qf.
template <typename T, int D>
__device__ __forceinline__ void quantize_q(uint32_t q16, uint32_t q8, int row, int t,
                                           float q_scale, float (&qf)[2]) {
  constexpr int kChunks = D / 16;
  constexpr float kInv = static_cast<float>(1.0 / 127.0);
  auto load = [&](int r, int c, float (&x)[16]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cc = 2 * c + h;  // a chunk of 8 values of T
      const uint4 u = lds_u32x4(q16 + (cc >> 3) * (kBlockM * 128) + r * 128 +
                                (((cc & 7) ^ (r & 7)) << 4));
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = unpack2<T>(w[i]);
        x[8 * h + 2 * i] = Elem<T>::to_float(Elem<T>::from_float(f.x * q_scale));
        x[8 * h + 2 * i + 1] = Elem<T>::to_float(Elem<T>::from_float(f.y * q_scale));
      }
    }
  };
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + 8 * i;
    float amax = 0.f;
#pragma unroll
    for (int c = t; c < kChunks; c += 4) {
      float x[16];
      load(r, c, x);
#pragma unroll
      for (int e = 0; e < 16; ++e) amax = fmaxf(amax, fabsf(x[e]));
    }
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
    const float a = amax == 0.f ? 1.f : amax;
    const float mul = 127.f / a;
#pragma unroll
    for (int c = t; c < kChunks; c += 4) {
      float x[16];
      load(r, c, x);
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int v = min(127, max(-127, __float2int_rn(x[e] * mul)));
        w[e >> 2] |= (static_cast<uint32_t>(v) & 0xFFu) << (8 * (e & 3));
      }
      const uint32_t addr = D == 64 ? q8 + r * 64 + ((c ^ ((r >> 1) & 3)) << 4)
                                    : q8 + (c >> 3) * (kBlockM * 128) + r * 128 +
                                          (((c & 7) ^ (r & 7)) << 4);
      sts_u32x4(addr, make_uint4(w[0], w[1], w[2], w[3]));
    }
    qf[i] = (a * kInv) * kInv;
  }
  fence_proxy_async();  // before the wgmma reads the tile
}

// The consumers' mask modes besides `Visible` (P / B2 / B6 / B9, whose
// code they leave as it is). Each holds the block's view in shared memory;
// row_state() gives a thread its two rows' bounds and its consumer's key
// range [start, end) once, mask_tile() masks a tile's scores in place, and
// kKeyMeta says that mask_tile() reads the tile's K slot (so the slot goes
// back only after it).
struct NoRows {};
__device__ __forceinline__ NoRows row_state(const Visible&, int, int) { return {}; }
template <typename Vis>
struct KeyMeta {
  static constexpr bool value = Vis::kKeyMeta;
};
template <>
struct KeyMeta<Visible> {
  static constexpr bool value = false;
};

// B4: row r of a block is query position r % s of q head (the run's first)
// + r / s, so a block packs `sq / s` heads of one GQA group (their keys
// are one kv head's), or holds 128 positions of one head (sq = s). Key n
// is visible from a row at position pos iff n < skv, when causal
// n <= pos + offset, and with a window W > 0 n > pos + offset - W.
// kSplit: P enters P V as two parts rounded to T, hi = P rounded and
// lo = P - hi rounded (about 2^-16 of P lost, not 2^-9), so that a verify
// round's attention matches the decode kernels', which keep P in fp32.
// kPartials: the block writes B4's (o, m, l) partials (ring attention's
// per-chunk state) instead of O, into `PartialsOut`: o_unnorm [B, Hq, S, d]
// fp32, O before its division by l; m [B, Hq, S] fp32, the row's running
// max in base-2 units of the scaled (and capped) scores, started at 0, so
// m = max(0, the row's max); l [B, Hq, S] fp32, the row's sum of
// 2^(s - m). A row with no visible key is m = 0, l = 0, o_unnorm = 0, so
// any two partials merge exactly.
template <bool kSplit, bool kPartials = false>
struct Extend {
  int sq;  // rows of a run of heads (heads x S): the stores' bound and a run's stride
  int s;   // S, the positions of a head
  int skv, offset, causal, window;
  static constexpr bool kKeyMeta = false;
};
// The partials' outputs, each from [B, Hq, ...]'s first row: kernel
// parameters, so that the epilogue's addresses take no register before it.
struct PartialsOut {
  float *o, *m, *l;
};
template <typename Vis>
struct SplitP {
  static constexpr bool value = false;
};
template <bool kSplit, bool kPartials>
struct SplitP<Extend<kSplit, kPartials>> {
  static constexpr bool value = kSplit;
};
template <typename Vis>
struct Partials {
  static constexpr bool value = false;
};
template <bool kSplit, bool kPartials>
struct Partials<Extend<kSplit, kPartials>> {
  static constexpr bool value = kPartials;
};
struct ExtendRows {
  int bound0, bound1;  // this thread's rows' causal bound: pos + offset
  int start, end;      // keys some row of the consumer sees
};
template <bool kSplit, bool kPartials>
__device__ __forceinline__ ExtendRows row_state(const Extend<kSplit, kPartials>& v, int mw,
                                                int row0) {
  ExtendRows r;
  r.bound0 = row0 % v.s + v.offset;
  r.bound1 = (row0 + 8) % v.s + v.offset;
  // The positions [lo, hi] of the consumer's rows below sq.
  const int last = min(mw + kTileM, v.sq) - 1;
  int lo = 0, hi = v.s - 1;
  if (mw / v.s == last / v.s) lo = mw % v.s, hi = last % v.s;
  r.start = v.window > 0 ? max(0, lo + v.offset - v.window + 1) : 0;
  r.end = mw < v.sq ? min(v.skv, v.causal ? hi + v.offset + 1 : v.skv) : 0;
  return r;
}
template <int kN, bool kSplit, bool kPartials>
__device__ __forceinline__ void mask_tile(const Extend<kSplit, kPartials>& v,
                                          float (&s)[kN / 2], const ExtendRows& r, int n0,
                                          uint32_t, int, int t) {
  // A tile whose every key both of this thread's rows see needs no mask.
  if (n0 + kN <= v.skv && (!v.causal || n0 + kN - 1 <= min(r.bound0, r.bound1)) &&
      (v.window <= 0 || n0 > max(r.bound0, r.bound1) - v.window))
    return;
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) {
    const int b = i & 2 ? r.bound1 : r.bound0, col = n0 + 8 * (i >> 2) + 2 * t + (i & 1);
    if (col >= v.skv || (v.causal && col > b) || (v.window > 0 && col <= b - v.window))
      s[i] = -INFINITY;
  }
}

// B12: packed tokens. Key n is visible from row m iff kv_seg[n] == q_seg[m],
// when causal kv_pos[n] <= q_bound[m], and with a window W > 0
// kv_pos[n] > q_bound[m] - W. Each K slot carries its keys' kv_seg and
// kv_pos (kN ints each, at base + kMetaOff). a, b, c, d: the first key of
// seg_lo (the block's first row's segment), past the last key of seg_hi
// (its last row's), the first key of seg_hi, past the last key of seg_lo.
// q_bound is non-decreasing within a segment (the varlen front end's
// pos + kv_len - q_len), so a run of rows of one segment is bounded by its
// first row below and its last row above.
template <int kMetaOff, int kKStages>
struct Segments {
  int sq;  // Tq
  int causal, window;
  const int* q_seg;
  const int* q_bound;
  int seg_lo, seg_hi, bound_lo, bound_hi;  // the block's first and last rows'
  int a, b, c, d;
  static constexpr bool kKeyMeta = true;
};
struct SegmentRows {
  int seg[2], bound[2];  // this thread's rows'
  int start, end;        // keys some row of the consumer sees
};
template <int kMetaOff, int kKStages>
__device__ __forceinline__ SegmentRows row_state(const Segments<kMetaOff, kKStages>& v, int mw,
                                                 int row0) {
  SegmentRows r;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = min(row0 + 8 * i, v.sq - 1);  // rows past Tq are never stored
    r.seg[i] = v.q_seg[row];
    r.bound[i] = v.q_bound[row];
  }
  r.start = r.end = 0;
  if (mw >= v.sq) return r;
  const int last = min(mw + kTileM, v.sq) - 1;
  const int sf = v.q_seg[mw], sl = v.q_seg[last];
  const int shift = v.window > 0 ? max(0, v.q_bound[mw] - v.window + 1) : 0;
  // From the consumer's first row's window start (its segment's first key
  // when that is seg_lo or seg_hi), to its last row's causal end (the first
  // key of seg_hi when the last row lies in an earlier segment).
  r.start = sf == v.seg_lo ? min(v.a + shift, v.d) : sf == v.seg_hi ? min(v.c + shift, v.b) : v.a;
  r.end = sl != v.seg_hi ? v.c : v.causal ? min(v.b, v.c + max(v.q_bound[last] + 1, 0)) : v.b;
  return r;
}
template <int kN, int kMetaOff, int kKStages>
__device__ __forceinline__ void mask_tile(const Segments<kMetaOff, kKStages>& v,
                                          float (&s)[kN / 2], const SegmentRows& r, int n0,
                                          uint32_t base, int it, int t) {
  const uint32_t meta = base + kMetaOff + it % kKStages * 8 * kN;  // kv_seg, then kv_pos
  // A tile of one segment (segment ids are sorted) whose every key both
  // rows see needs no mask.
  const int s0 = lds_s32(meta), s1 = lds_s32(meta + 4 * (kN - 1));
  const int p0 = lds_s32(meta + 4 * kN), p1 = lds_s32(meta + 4 * (2 * kN - 1));
  if (s0 == s1 && s0 == r.seg[0] && s0 == r.seg[1] &&
      (!v.causal || p1 <= min(r.bound[0], r.bound[1])) &&
      (v.window <= 0 || p0 > max(r.bound[0], r.bound[1]) - v.window))
    return;
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    const int2 ks = lds_s32x2(meta + (8 * j + 2 * t) * 4);
    const int2 kp = lds_s32x2(meta + (kN + 8 * j + 2 * t) * 4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int seg = e & 1 ? ks.y : ks.x, pos = e & 1 ? kp.y : kp.x, i = e >> 1;
      if (seg != r.seg[i] || (v.causal && pos > r.bound[i]) ||
          (v.window > 0 && pos <= r.bound[i] - v.window))
        s[4 * j + e] = -INFINITY;
    }
  }
}

// A consumer warpgroup's whole part of a block (threads 128..383): its 64
// rows of the walk over `total` tiles from key n_begin, then its rows of O
// (rows < Sq) into `o` ([B * Hq, Sq, d]) at head `head` (b * Hq + h) and,
// with `lse` not null, each row's m + log2(l) (+inf on a row with no
// visible key). The output's address is formed only then, so that it takes
// no register through the walk. d: the output's row pitch, D where the
// true head dim is D; a true head dim below D runs in D's layout, the Q,
// K and V columns past it read as zeros by TMA, so S is exact, and O is
// stored at its pitch (row_pitch of the true head dim), the columns past
// the true head dim zeros, those past the pitch not stored.
// kScaleOff (B9; 0 for none): each tile's kN K and V scales lie at
// base + kScaleOff (kKStages K slots, then kVStages V slots) and land with
// the tile: S is multiplied by
// the K scale of its key (times the softmax scale, or the cap's factor)
// before the cap, P by the V scale of its key after its row sum and before its
// rounding to T.
// Vis: which keys a row sees, `Visible` or a mode above (B4, B12).
// The wide layout (D > 256; bf16 / f16 scores, B9's scales, no two-part
// P): the block's O chunk (Tiles::kDO columns) lies at `o` (B4's partials:
// at `part.o`), which the kernel points at the chunk's first column, and
// `cols` of its columns are stored (the row pitch d past that column, at
// most kDO); the partials' m and l are stored where `part.m` is not null
// (chunk 0). Below it `cols` is unused.
// kI8 (P-i8 / B2-i8): S is the s8 product of the int8 Q tile, which the
// consumers quantize from the Q tile first (quantize_q, with
// sco.scale_log2 as q's pre-scale), and of int8 K tiles, whose keys'
// scales lie at base + kScaleOff a K slot; each s32 score is converted to
// fp32 (exact: |s| <= 127^2 D < 2^24) and multiplied by its key's scale
// times its row's factor (the TPU kernel's s * (bsc * (qa / 127))), giving
// the score in base-2 units: the softmax scale is 1 and the cap's factor
// sco.cap_exp is that of such scores. The conversion is I2F: an exact one
// by the float's bits (an integer add and an fp32 add) measured 4-6 %
// slower at Llama's and Mistral's long prefills on the H100 (PERF.md).
template <typename T, int D, bool kCap, int kScaleOff, bool kI8 = false, int kKStages,
          int kVStages, int kBars, int kKSlot, int kQBytes, typename Vis>
__device__ __forceinline__ void consume(
    const Rings<D, kKStages, kVStages, kBars, kKSlot, kQBytes>& ring, const Vis& vis,
    const Scores& sco, int m0, int n_begin, int total, T* o, float* lse, int head,
    int d = D, PartialsOut part = {}, int cols = 0) {
  constexpr int kN = Tiles<D>::kN, kDO = Tiles<D>::kDO;
  constexpr bool kScaled = kScaleOff > 0 && !kI8;
  constexpr bool kDense = std::is_same_v<Vis, Visible>, kKeyMeta = KeyMeta<Vis>::value;
  constexpr bool kSplit = SplitP<Vis>::value, kPartials = Partials<Vis>::value;
  static_assert(kDO == D || !(kI8 || kSplit),
                "the wide layout takes bf16 / f16 scores and P in one part");
  const int ct = threadIdx.x - 128, wg = ct >> 7, wi = (ct >> 5) & 3, lane = ct & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mw = m0 + kTileM * wg;       // this warpgroup's first row
  const int row0 = mw + 16 * wi + g;     // this thread's rows: row0, row0 + 8
  const uint32_t qa = ring.sQ() + wg * kTileM * 128;
  [[maybe_unused]] const auto rows = row_state(vis, mw, row0);
  constexpr int kOBlocks = kDO == 256 ? 2 : 1;  // PV products of N = kDO / kOBlocks a k-step
  constexpr int kON = kDO / kOBlocks;
  // Element 4 j + e of an accumulator: row row0 + 8 (e >> 1), column
  // 8 j + 2 t + (e & 1) (of keys for S, of D within the block for O).
  float acc[kOBlocks][kON / 2];
#pragma unroll
  for (int c = 0; c < kOBlocks; ++c)
#pragma unroll
    for (int i = 0; i < kON / 2; ++i) acc[c][i] = 0.f;
  // Each row's running max (base-2 units of the scaled score; from 0 for
  // B4's partials) and this thread's part of its running sum, reduced over
  // the quad at the end.
  const float kMax0 = kPartials ? 0.f : -INFINITY;
  float row_max[2] = {kMax0, kMax0}, row_sum[2] = {0.f, 0.f};
  // Scores leave the product raw; the cap scales them inside the tanh, B9
  // with its keys' scales (the TPU kernel's s * (kscale * scale)), which
  // then also carry the cap's factor.
  const float sc = kCap || kScaled || kI8 ? 1.f : sco.scale_log2;
  if (total > 0) mbar_wait(ring.q_full(), 0);
  // kI8: the int8 Q tile after the Q tile (rows of min(D, 128) bytes in
  // boxes of 128 rows), this consumer's rows' factors, and its first row.
  constexpr int kQ8Row = D == 64 ? 64 : 128;
  [[maybe_unused]] const uint32_t qa8 = ring.sQ() + Tiles<D>::kQ + wg * kTileM * kQ8Row;
  [[maybe_unused]] float qf[2] = {0.f, 0.f};
  if constexpr (kI8) {
    if (total > 0) {
      quantize_q<T, D>(ring.sQ(), ring.sQ() + Tiles<D>::kQ, kTileM * wg + 16 * wi + g, t,
                       sco.scale_log2, qf);
      named_sync(3 + wg, 128);  // the warpgroup's rows of the int8 tile are written
    }
  }
  // This thread's keys' scales of tile it (B9): column 8 j + 2 t.
  auto k_scales = [&](int it) { return ring.base + kScaleOff + (it % kKStages * kN + 2 * t) * 4; };
  auto v_scales = [&](int it) {
    return ring.base + kScaleOff + ((kKStages + it % kVStages) * kN + 2 * t) * 4;
  };
  // kI8: S of tile it as fp32 scores, before the slot goes back.
  auto dequantize = [&](float (&s)[kN / 2], uint32_t (&si)[kI8 ? kN / 2 : 1], int it) {
    if constexpr (kI8) {
      fence_regs(si);
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const float2 ks = lds_f32x2(k_scales(it) + 32 * j);
        s[4 * j] = static_cast<float>(static_cast<int>(si[4 * j])) * (ks.x * qf[0]);
        s[4 * j + 1] = static_cast<float>(static_cast<int>(si[4 * j + 1])) * (ks.y * qf[0]);
        s[4 * j + 2] = static_cast<float>(static_cast<int>(si[4 * j + 2])) * (ks.x * qf[1]);
        s[4 * j + 3] = static_cast<float>(static_cast<int>(si[4 * j + 3])) * (ks.y * qf[1]);
      }
    } else {
      fence_regs(s);
    }
  };
  // S of tile it (the s8 product with kI8).
  // B9 in the wide layout: its consumers' 224 registers hold O, S and the
  // scales' products but not also the q descriptors of S's 32 k-steps,
  // which the compiler would keep across the walk (they spilled): an opaque
  // copy of q's address a tile makes them recomputed, a few integer
  // operations a k-step.
  auto s_products = [&](float (&s)[kN / 2], uint32_t (&si)[kI8 ? kN / 2 : 1], int it) {
    if constexpr (kI8) {
      qk_products_i8<D, kN>(si, qa8, ring.sK(it));
    } else if constexpr (kScaled && kDO != D) {
      uint32_t q = qa;
      asm volatile("" : "+r"(q));
      qk_products<T, D, kN>(s, q, ring.sK(it));
    } else {
      qk_products<T, D, kN>(s, qa, ring.sK(it));
    }
  };
  // S of tile it times its keys' scales (B9), before the slot goes back.
  auto scale_keys = [&](float (&s)[kN / 2], int it) {
    if constexpr (kScaled) {
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        float2 ks = lds_f32x2(k_scales(it) + 32 * j);
        const float f = kCap ? sco.cap_exp : sco.scale_log2;
        ks.x *= f, ks.y *= f;
        s[4 * j] *= ks.x, s[4 * j + 1] *= ks.y, s[4 * j + 2] *= ks.x, s[4 * j + 3] *= ks.y;
      }
    }
  };

  // Cap, mask and exponentiate the scores of tile it in place, updating
  // the running max and sum; alpha: the factor of O's old rows.
  auto softmax = [&](float (&s)[kN / 2], int it, float (&alpha)[2]) {
    const int n0 = n_begin + it * kN;
    if constexpr (kCap) {
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) s[i] = kScaled ? softcap_of(s[i], sco) : softcap(s[i], sco);
    }
    if constexpr (kDense) {
      if (!tile_full<kN>(vis, mw, n0)) {
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) {
          const int row = row0 + 8 * ((i >> 1) & 1), col = n0 + 8 * (i >> 2) + 2 * t + (i & 1);
          if (col >= vis.skv || (vis.causal && col > row + vis.offset) ||
              (vis.window > 0 && col <= row + vis.offset - vis.window))
            s[i] = -INFINITY;
        }
      }
    } else {
      mask_tile<kN>(vis, s, rows, n0, ring.base, it, t);
    }
    float m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(row_max[r], mx * sc);
      // A row with no visible key yet keeps max -inf (as a windowed row does
      // below its window); referencing it to 0 makes exp2(-inf - ref)
      // exactly 0 and never -inf - -inf = NaN.
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = ex2(row_max[r] - m_use[r]);
      row_max[r] = m_new;
    }
    float tile_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) {
      s[i] = ex2(fmaf(s[i], sc, -m_use[(i >> 1) & 1]));
      tile_sum[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) row_sum[r] = row_sum[r] * alpha[r] + tile_sum[r];
  };
  // P of tile it rounded to T into the A fragments, after its row sums and
  // after the previous tile's P V (whose fragments it overwrites); B9 first
  // multiplies P by its keys' V scales (the TPU kernel's
  // (p * vscale).astype(compute_dtype)), which land with the V tile that
  // this turn has not waited for yet (its P V runs next turn).
  auto round_p = [&](float (&s)[kN / 2], int it, uint32_t (&pa)[kN / 16][4],
                     uint32_t (&pl)[kSplit ? kN / 16 : 1][4]) {
    if constexpr (kScaled) {
      mbar_wait(ring.full_v(it), ring.v_pass(it));
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const float2 vs = lds_f32x2(v_scales(it) + 32 * j);
        s[4 * j] *= vs.x, s[4 * j + 1] *= vs.y, s[4 * j + 2] *= vs.x, s[4 * j + 3] *= vs.y;
      }
    }
    if constexpr (kSplit) to_a_split<T>(s, pa, pl);
    else to_a<T>(s, pa);
  };
  // O += P V of tile it's slot (kSplit: hi V, then lo V).
  auto pv = [&](uint32_t (&pa)[kN / 16][4], uint32_t (&pl)[kSplit ? kN / 16 : 1][4],
                int it) {
    pv_products<T, kDO, kN>(acc, pa, ring.sV(it));
    if constexpr (kSplit) pv_products<T, kDO, kN>(acc, pl, ring.sV(it));
  };
  auto fence_p = [&](uint32_t (&pa)[kN / 16][4], uint32_t (&pl)[kSplit ? kN / 16 : 1][4]) {
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) fence_regs(pa[kk]);
    if constexpr (kSplit) {
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) fence_regs(pl[kk]);
    }
  };

  // Warpgroup ping-pong: a consumer issues its products of a tile between a
  // sync on its named barrier and an arrive on the other's, so that one
  // consumer's products run while the other computes its exponentials.
  // Within a consumer the products of a tile are S of this tile and O += P V
  // of the previous one: the exponentials of S run while P V does. Every
  // tile of the walk takes a turn (a tile this consumer sees nothing of
  // too), consumer 0 first; consumer 1 skips its last arrive, so that each
  // sync has its arrive.
  const int my_bar = 1 + wg, other_bar = 2 - wg;
  if (wg == 1 && total > 0) named_arrive(1, 256);
  auto take_turn = [&](int it) {
    mbar_wait(ring.full_k(it), ring.k_pass(it));
    named_sync(my_bar, 256);
  };
  auto pass_turn = [&](int it) {
    if (wg == 0 || it + 1 < total) named_arrive(other_bar, 256);
  };
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  // A tile this consumer sees nothing of: its turn, and both slots back
  // (once full, so that no arrive runs ahead into the next pass).
  auto skip = [&](int it) {
    take_turn(it);
    pass_turn(it);
    mbar_wait(ring.full_v(it), ring.v_pass(it));
    release(ring.empty_k(it));
    release(ring.empty_v(it));
  };
  // The tiles this consumer sees a key of are one run [it_lo, it_hi) of the
  // walk; the wgmma products stay out of data-dependent branches (ptxas
  // serializes them there).
  auto dead = [&](int n0) {
    if constexpr (kDense) return tile_dead<kN>(vis, mw, n0);
    else return n0 >= rows.end || n0 + kN <= rows.start;
  };
  int it_lo = 0, it_hi = total;
  while (it_lo < total && dead(n_begin + it_lo * kN)) ++it_lo;
  while (it_hi > it_lo && dead(n_begin + (it_hi - 1) * kN)) --it_hi;
  for (int it = 0; it < it_lo; ++it) skip(it);
  if (it_lo < it_hi) {
    uint32_t pa[kN / 16][4];  // P of the previous tile, rounded to T
    uint32_t pl[kSplit ? kN / 16 : 1][4];  // kSplit: the rest of P, rounded to T
    {
      float s[kN / 2], alpha[2];
      uint32_t si[kI8 ? kN / 2 : 1];
      take_turn(it_lo);
      wgmma_fence();
      s_products(s, si, it_lo);
      wgmma_commit();
      pass_turn(it_lo);
      wgmma_wait<0>();
      dequantize(s, si, it_lo);
      scale_keys(s, it_lo);
      if constexpr (!kKeyMeta) release(ring.empty_k(it_lo));
      softmax(s, it_lo, alpha);  // O is 0: alpha unused
      if constexpr (kKeyMeta) release(ring.empty_k(it_lo));
      round_p(s, it_lo, pa, pl);
    }
    for (int it = it_lo + 1; it < it_hi; ++it) {
      float s[kN / 2], alpha[2];
      uint32_t si[kI8 ? kN / 2 : 1];
      take_turn(it);
      mbar_wait(ring.full_v(it - 1), ring.v_pass(it - 1));
      wgmma_fence();
      s_products(s, si, it);
      wgmma_commit();
      pv(pa, pl, it - 1);
      wgmma_commit();
      pass_turn(it);
      wgmma_wait<1>();  // S done; P V may still run
      dequantize(s, si, it);
      scale_keys(s, it);
      if constexpr (!kKeyMeta) release(ring.empty_k(it));
      softmax(s, it, alpha);
      if constexpr (kKeyMeta) release(ring.empty_k(it));
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < kOBlocks; ++c) fence_regs(acc[c]);
      fence_p(pa, pl);
      release(ring.empty_v(it - 1));
#pragma unroll
      for (int c = 0; c < kOBlocks; ++c)
#pragma unroll
        for (int i = 0; i < kON / 2; ++i) acc[c][i] *= alpha[(i >> 1) & 1];
      round_p(s, it, pa, pl);
    }
    mbar_wait(ring.full_v(it_hi - 1), ring.v_pass(it_hi - 1));
    wgmma_fence();  // the last tile's P V
    pv(pa, pl, it_hi - 1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kOBlocks; ++c) fence_regs(acc[c]);
    fence_p(pa, pl);
    release(ring.empty_v(it_hi - 1));
  }
  for (int it = it_hi; it < total; ++it) skip(it);

  if constexpr (kPartials) {  // B4's partials: O, m and l as they stand, in fp32
    const int64_t first = static_cast<int64_t>(head) * vis.sq;  // the run's first row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = row_sum[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = row0 + 8 * r;
      if (t == 0 && row < vis.sq && (kDO == D || part.m != nullptr))
        part.m[first + row] = row_max[r], part.l[first + row] = l;
    }
    float* out = part.o + first * d;
    const int stored = kDO == D ? d : cols;  // columns of the row (of the chunk) stored
#pragma unroll
    for (int c = 0; c < kOBlocks; ++c)
#pragma unroll
      for (int j = 0; j < kON / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + 8 * r, col = c * kON + 8 * j + 2 * t;
          if (row < vis.sq && col < stored)
            *reinterpret_cast<float2*>(out + static_cast<int64_t>(row) * d + col) =
                make_float2(acc[c][4 * j + 2 * r], acc[c][4 * j + 2 * r + 1]);
        }
  } else {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = row_sum[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[r] = l > 0.f ? 1.f / l : 0.f;  // no visible key -> exact zero row
      const int row = row0 + 8 * r;
      if (lse != nullptr && t == 0 && row < vis.sq)  // the backward's residual
        lse[static_cast<int64_t>(head) * vis.sq + row] =
            l > 0.f ? row_max[r] + log2f(l) : INFINITY;
    }
    T* out = o + static_cast<int64_t>(head) * vis.sq * d;
    const int stored = kDO == D ? d : cols;  // columns of the row (of the chunk) stored
#pragma unroll
    for (int c = 0; c < kOBlocks; ++c)
#pragma unroll
      for (int j = 0; j < kON / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + 8 * r, col = c * kON + 8 * j + 2 * t;
          if (row < vis.sq && col < stored)
            *reinterpret_cast<uint32_t*>(out + static_cast<int64_t>(row) * d + col) =
                Elem<T>::pack(acc[c][4 * j + 2 * r] * inv[r], acc[c][4 * j + 2 * r + 1] * inv[r]);
        }
  }
}

}  // namespace fact
