// Split-KV single-token decode, the kernel of
//
//   * B5 (paged_attention.cu, bf16 / f16 pages): replaces the TPU kernel
//     flash_attention_cute_tpu/ops/paged_attention.py `_paged_decode_kernel`
//     (:85, pallas_call at :341);
//   * B8 (quant_paged_decode.cu, int8 / e4m3 pages with one f32 scale per
//     token and kv head): replaces flash_attention_cute_tpu/ops/quantized.py
//     `_quant_paged_kernel` (:395, pallas_call at :658);
//   * D1 (flash_decode.cu, a contiguous bf16 / f16 cache): replaces
//     flash_attention_cute_tpu/ops/flash_decode.py `_flash_decode_kernel`
//     (:42, pallas_call at :311);
//   * B7 (quantized.cu, a contiguous int8 / e4m3 cache with one f32 scale
//     per token and kv head): replaces flash_attention_cute_tpu/ops/
//     quantized.py `_quant_decode_kernel` (:73, pallas_call at :337).
//
// One block per (split, kv head and chunk of its group, batch row) writes
// the partials of up to 32 query rows of the GQA group (G = Hq / Hkv, any
// size) over its split's keys: acc [B, Hkv, S, G, d] unnormalised, m and l
// [B, Hkv, S, G] in base 2; D2 (flash_decode.cu) merges the splits. A group
// above 32 is cut into c = ceil(G / 32) chunks of ceil(G / c) rows (the
// last one fewer: 71 rows as 24 / 24 / 23; dispatch.decode_group_chunks
// plans it, the launch checks the plan),
// each a block along grid y (kv head hk's chunk j at y = hk c + j) that
// stages and writes its own rows only and reads its kv head's keys itself;
// a group of at most 32 is one chunk, the block of the whole group. The TPU
// kernels pad the group to a multiple of 8 instead (flash_decode.py:209-212,
// paged_attention.py:301, quantized.py:248). Every head dim d from 1 to
// 512 runs in the layout D of padded_head_dim(d, true), the cache's rows at
// any 16-byte stride (row_pitch(d, sizeof(KV)) in the port's caches). The maps
// hold d columns, so TMA reads zeros past them into the tiles (int8 0 and
// e4m3 +0 widen to exact zeros), q is zero past d in shared memory (its
// last 16-byte chunk masked: q's rows lie at a 16-byte stride), and only
// d columns of the partials are written (the TPU kernels pad D to their 128
// lanes likewise, flash_decode.py:215, paged_attention.py:302,
// quantized.py:249, :614). How keys are found is a template
// choice, kContig. Paged (B5 / B8): key n of batch row b sits at page
// page_table[b, n / ps], row n % ps, of one layer's pool [Hkv, P, ps, D].
// Contiguous (D1 / B7): key n of row b is row n of one layer's cache [B,
// Hkv, C, D], which is the pool with ps = C and page b, so the same 4-D
// map (D, C, B, Hkv) serves and no table is read. The query at position
// len - 1 sees keys [lo, len), lo = len - W with a window W, else 0. The
// tanh soft cap applies to the scaled score. B7 / B8 compute what their TPU
// kernels compute: values widened exactly to q's type, each score
// multiplied in fp32 by its key's K scale before the cap, each probability
// by its key's V scale before it is rounded to q's type; the running sum l
// keeps the unscaled probability. P meets V in q's type: B5, B7 and B8
// round it once, as their TPU kernels do; D1 takes it in two parts (hi = P
// rounded, lo = P - hi rounded), which carry P to about 2^-16 of itself, as
// the fp32 P of its TPU kernel does: speculative drafts run on D1, and a P
// rounded once in B4's verify rounds cut the self-draft acceptance, PERF.md. The
// second part costs a product per V tile and fits the registers at every
// head dim (D 256: 251-252 a thread, no spill).
//
// What bounds it on the H100: decode reads every visible K / V row once
// and does 4 G D operations a row, about G operations a byte (2 G over
// int8): memory bytes, far below the card's ~295 operations a byte. A
// group above 32 has each chunk's block read the rows again, the later
// reads mostly from L2. The design keeps the bytes moving:
//
//   * The walk is cut into tiles of kN keys aligned to multiples of kN
//     (64 at D 64, 16 at D 512, else 32). Paged: the tiles that hold a visible key are
//     shared out evenly among the splits, so only a walk's first and last
//     tiles hold keys outside [lo, len). Contiguous: split s takes the keys
//     [s chunk, (s + 1) chunk) of [lo, len), chunk = ceil(C / S) (the
//     partials' public meaning), so a chunk edge inside a tile is masked
//     like an edge of [lo, len). A split with no key writes m = -inf, l =
//     0, acc = 0. The grid is sized from shapes alone
//     (dispatch.decode_num_splits), never from the live lengths.
//   * Warp 0 produces. Paged: lane i copies part i of a tile (keys n0 + i
//     br .., br = gcd(kN, ps), one page or a part of one) by TMA through a
//     4-D map of the pool (D, ps, P, Hkv), one copy per box of 128-byte
//     (int8 at D 64: 64-byte) swizzled rows, K's and V's onto one barrier,
//     B8's scales beside them by bulk copies. Each lane reads its page-table
//     entry once a tile part, a tile ahead of its copies; parts wholly
//     outside [lo, len) are not copied (the table holds page 0 or anything
//     past the row's pages). Contiguous: lane 0 copies the tile whole, one
//     box of kN rows a segment (rows past C read as zeros), and B7's scales
//     come by 4-byte cp.async copies of the tile's live keys, one key a
//     lane, whose completion arrives on the same barrier: the scale rows
//     [B, Hkv, C] start at any 4-byte boundary (any capacity), which a bulk
//     copy's 16-byte rule would refuse. A ring of kStages tiles (a multiple
//     of the consumers' slots, so a slot always refills the same stages)
//     keeps 64-195 KB in flight a block, one or two blocks an SM (D 512:
//     128 KB, one).
//   * Four consumer warps take the tiles in turn, each with its own online
//     softmax, on tensor cores (mma.sync m16n8k16): S = Q K^T with the
//     chunk's rows as M (padded to 16; chunks above 16 rows give each warp
//     pair one of two m-tiles, so a tile is read by both), then O += P V with P
//     from S's registers and V read MN-major by ldmatrix.trans (B7 / B8: its
//     byte pairs regrouped by key and widened in registers); no V^T copy,
//     no round trip of P through shared memory. The contraction order over
//     D is free, so a thread reads (B7 / B8: widens) whole 16-byte runs of a
//     K row and takes q in the same order. B7 / B8 widen int8 to bf16 in
//     bf16 arithmetic (widen4_pairs: two operations a pair; with B9's fp32
//     route and a 4-byte load a key and column group, B8 took 0.062 ms at
//     Gemma's shape against 0.046, PERF.md). O lives in
//     registers (D / 2 a thread) until the warps of an m-tile merge it
//     through the idle ring in a fixed order: a second call writes the same
//     bits.
//   * The wide layout, D 512 (d 257-512): O of 512 columns would take 256
//     registers a thread, so O's columns are split across the warps of an
//     m-tile (kOwners 2 warps, kDO 256 columns each, O 128 registers) and
//     every warp of a slot reads the slot's tiles: a group of 17-32 rows
//     takes all four warps on every tile (two m-tiles x two column
//     owners), one of at most 16 two slots of two owners. Each owner
//     computes the tile's S over the whole d itself (the same instructions
//     on the same inputs: the owners' m and l agree bit for bit, and only
//     the first owner's enter the merge), so S costs twice its single
//     pass; each K / V row still arrives once a block. A stage's empty
//     barrier counts its readers, kOwners x m-tiles. 16-key tiles (a bf16
//     stage 32 KB) keep 4 bf16 / 8 one-byte stages (128 KB) beside q's 33
//     KB; the merge stages O in the ring as below.
//   * Masks run only on a walk's edge tiles: scores of keys outside
//     [lo, len) become -inf by a select, their V rows (and B7 / B8's V
//     scales) are zeroed in registers, so stale or NaN bytes of a tile's
//     dead rows never reach a product (0 x NaN is NaN).
#pragma once

#include "paged_extend.cuh"

namespace fact {

constexpr int kDecodeConsumers = 4;  // consumer warps; warp 0 produces
constexpr int kPagedDecodeThreads = 32 * (1 + kDecodeConsumers);

struct PagedDecodeParams {
  const void* q;          // [B, Hq, 1, D]
  const int* lengths;     // [B] int32
  const int* page_table;  // [B, pps] int32
  const float* k_scale;   // B7 / B8: one layer's scales [Hkv, P, ps] (B7: [B, Hkv, C]),
  const float* v_scale;   // position stride 1
  float* acc;             // [B, Hkv, S, G, d] unnormalised partial outputs
  float* m;               // [B, Hkv, S, G] running max (base 2)
  float* l;               // [B, Hkv, S, G] running sum
  int64_t q_sb, q_sh, ks_sh, ks_sp, vs_sh, vs_sp;  // contiguous: ks_sp / vs_sp step b
  int hkv, group, num_splits, pps, page_size;       // contiguous: pps 1, page_size C
  int box_rows;  // paged: keys of one copy, a page or a part of one
  Scores sc;
  int window;  // W > 0, or 0 for none
  int chunk;   // contiguous: keys a split, ceil(C / num_splits)
  int d;       // the true head dim, D or below it in D's layout
  int chunks;  // blocks a kv head's group is cut into (grid y = hkv chunks)
  int rows;    // q rows of a chunk (<= 32); the last may hold fewer
};

// Shared memory from a 1 KB aligned base: the ring (stage s: its K tile,
// then its V tile, each kSegs boxes of kN rows of kSegBytes), B8's scales
// (stage s: kN K scales, kN V scales), q (32 rows, padded), the warps' row
// maxima and sums, then a full and an empty barrier a stage.
template <typename KV, int D>
struct DecodeTiles {
  static constexpr bool kQuant = sizeof(KV) == 1;
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(KV));
  static constexpr int kSegBytes = kRowBytes < 128 ? kRowBytes : 128;  // a box's row
  static constexpr int kSegs = kRowBytes / kSegBytes;
  static constexpr int kSegD = kSegBytes / static_cast<int>(sizeof(KV));  // values of a box row
  // The wide layout (D 512): each warp of an m-tile owns kDO of O's
  // columns (kOwners warps an m-tile), so O takes kDO / 2 registers a thread.
  static constexpr bool kWide = D > 256;
  static constexpr int kDO = kWide ? 256 : D;
  static constexpr int kOwners = D / kDO;
  // Keys of a tile: 64 at D 64, 16 at D 512, else 32 (B8's int8 rows of
  // 128 bytes in tiles of 64 spilled at the 168 registers of two blocks an
  // SM; at D 512 a bf16 stage of 32 keys would take 64 KB).
  static constexpr int kN = D == 64 ? 64 : kWide ? 16 : 32;
  static constexpr int kBox = kN * kSegBytes;
  static constexpr int kTile = kSegs * kBox;  // a K or a V tile
  static constexpr int kMinBlocks = D >= 256 ? 1 : 2;  // O takes kDO / 2 registers a thread
  static constexpr int kStageBytes = 2 * kTile + (kQuant ? 8 * kN : 0);
  // D 512: a ring of 128 KB (4 bf16 / 8 one-byte stages), which the merge
  // fills, beside q's 33 KB.
  static constexpr int kFit =
      (kWide ? 136 * 1024 : kMinBlocks == 1 ? 200 * 1024 : 96 * 1024) / kStageBytes;
  static constexpr int kStages = (kFit < 16 ? kFit : 16) / kDecodeConsumers * kDecodeConsumers;
  static constexpr int kScaleOff = kStages * 2 * kTile;
  static constexpr int kQOff = kScaleOff + (kQuant ? kStages * 8 * kN : 0);
  static constexpr int kQPitch = 2 * D + 16;  // bytes of a q row: 16 more spread the banks
  static constexpr int kStatOff = kQOff + 32 * kQPitch;
  static constexpr int kBarOff = kStatOff + 2 * kDecodeConsumers * 16 * 4;
  static constexpr int kBytes = 1024 + kBarOff + 2 * kStages * 8;
  static_assert(kStages >= kDecodeConsumers, "a slot of the ring for every consumer");
  static_assert(kDecodeConsumers * 16 * D * 4 <= kScaleOff, "the merge reuses the ring");
};

__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// Four quantized values (one 32-bit word, value 0 in its low byte) as two
// pairs of T, exactly. int8 to bf16 in bf16 arithmetic: 0x43 over the low 7
// bits is 128 + (x & 127), 0x43 over the sign bit 128 + (x & 128), and their
// difference x; two operations a pair where widen4 (B9's) takes five.
template <typename T, typename KV>
__device__ __forceinline__ uint2 widen4_pairs(uint32_t w) {
  if constexpr (std::is_same_v<T, __nv_bfloat16> && std::is_same_v<KV, int8_t>) {
    const uint32_t low = w & 0x7F7F7F7Fu, sign = w & 0x80808080u;
    uint32_t a0 = __byte_perm(low, 0x43434343u, 0x4140), a1 = __byte_perm(low, 0x43434343u, 0x4342);
    const uint32_t b0 = __byte_perm(sign, 0x43434343u, 0x4140);
    const uint32_t b1 = __byte_perm(sign, 0x43434343u, 0x4342);
    asm("sub.rn.bf16x2 %0, %0, %1;\n" : "+r"(a0) : "r"(b0));
    asm("sub.rn.bf16x2 %0, %0, %1;\n" : "+r"(a1) : "r"(b1));
    return make_uint2(a0, a1);
  } else {
    return widen4<T, KV>(w);
  }
}

// P's two parts in T (see the header): hi = (x0, x1) rounded, lo = the
// rounding's error rounded (x - hi is exact in fp32).
template <typename T>
__device__ __forceinline__ void pack_split(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = Elem<T>::pack(x0, x1);
  float h0, h1;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    h0 = __uint_as_float(hi << 16), h1 = __uint_as_float(hi & 0xFFFF0000u);
  } else {
    h0 = __half2float(__ushort_as_half(static_cast<unsigned short>(hi & 0xFFFFu)));
    h1 = __half2float(__ushort_as_half(static_cast<unsigned short>(hi >> 16)));
  }
  lo = Elem<T>::pack(x0 - h0, x1 - h1);
}

// 4 bytes from global to shared memory, and the arrival on `bar` once this
// thread's copies so far have landed (the barrier's pending count is raised
// now, so its phase cannot complete before they do).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// The kernel's body. KV: T (B5, D1) or int8 / e4m3 (B8, B7). kCap: the
// soft cap is compiled in. kContig: keys of a contiguous cache (D1, B7),
// else through the page table (B5, B8).
template <typename T, typename KV, int D, bool kCap, bool kContig>
__device__ __forceinline__ void decode_body(const CUtensorMap& kmap, const CUtensorMap& vmap,
                                            const PagedDecodeParams& p) {
  using L = DecodeTiles<KV, D>;
  constexpr bool kQuant = L::kQuant;
  constexpr bool kSplitP = kContig && !kQuant;
  constexpr int kN = L::kN, kStages = L::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;  // the 128-byte swizzle needs 1 KB
  const int split = blockIdx.x, hk = blockIdx.y / p.chunks, b = blockIdx.z;
  const int g0 = blockIdx.y % p.chunks * p.rows;  // the chunk's first row of the group
  const int G = p.group, R = min(p.rows, G - g0);  // R: this block's q rows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = p.d;  // the partials' row; columns of q past it are zeros
  const int64_t part = (static_cast<int64_t>(b) * p.hkv + hk) * p.num_splits + split;
  const int64_t stat0 = part * G + g0;  // the chunk's first m / l entry
  float* acc_out = p.acc + stat0 * d;

  // This split's tiles [t0, t0 + total) of the visible ones; contiguous,
  // [lo, len) is first cut to the split's chunk.
  int len = min(max(p.lengths[b], 0), p.pps * p.page_size);
  int lo = p.window > 0 ? max(0, len - p.window) : 0;
  if constexpr (kContig) {
    lo = max(lo, split * p.chunk);
    len = min(len, (split + 1) * p.chunk);
  }
  const int first = lo / kN, count = len > lo ? (len + kN - 1) / kN - first : 0;
  int t0 = first, total = count;
  if constexpr (!kContig) {
    t0 = first + static_cast<int>(static_cast<int64_t>(count) * split / p.num_splits);
    total = first + static_cast<int>(static_cast<int64_t>(count) * (split + 1) / p.num_splits) - t0;
  }
  if (total <= 0) {  // weight 0 in the combine
    for (int i = threadIdx.x; i < R * d; i += kPagedDecodeThreads) acc_out[i] = 0.f;
    if (threadIdx.x < R) {
      p.m[stat0 + threadIdx.x] = -INFINITY;
      p.l[stat0 + threadIdx.x] = 0.f;
    }
    return;
  }
  const int mts = R > 16 ? 2 : 1;  // m-tiles of 16 q rows
  // The chunk's rows and first m / l entry for the merge, through shared
  // memory: held in registers across the walk they spilled D1 at D 256
  // with the cap (255 registers, PERF.md).
  __shared__ int64_t chunk_stat0;
  __shared__ int chunk_rows;
  auto sK = [&](int s) { return base + s * 2 * L::kTile; };
  auto sV = [&](int s) { return base + s * 2 * L::kTile + L::kTile; };
  auto k_scales = [&](int s) { return base + L::kScaleOff + s * 8 * kN; };
  auto v_scales = [&](int s) { return base + L::kScaleOff + s * 8 * kN + 4 * kN; };
  auto full = [&](int s) { return base + L::kBarOff + 8 * s; };
  auto empty = [&](int s) { return base + L::kBarOff + 8 * (kStages + s); };
  if (threadIdx.x == 0) {
    // A stage is read by the warps of one slot: kOwners an m-tile.
    for (int s = 0; s < kStages; ++s) mbar_init(full(s), 1), mbar_init(empty(s), L::kOwners * mts);
    mbar_fence_init();
    chunk_stat0 = stat0, chunk_rows = R;
  }
  __syncthreads();

  if constexpr (kContig) {
    if (warp == 0) {
      for (int it = 0; it < total; ++it) {
        const int n0 = (t0 + it) * kN, s = it % kStages;
        if (lane == 0) mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        __syncwarp();
        if constexpr (kQuant) {  // the live keys' scales, one key a lane
          const int64_t row = hk * p.ks_sh + b * p.ks_sp + n0, vrow = hk * p.vs_sh + b * p.vs_sp + n0;
          for (int i = lane; i < kN; i += 32) {
            if (n0 + i >= lo && n0 + i < len) {
              cp_async4(k_scales(s) + 4 * i, p.k_scale + row + i);
              cp_async4(v_scales(s) + 4 * i, p.v_scale + vrow + i);
            }
          }
          cp_async_arrive(full(s));
          __syncwarp();
        }
        if (lane == 0) {
          mbar_expect_tx(full(s), 2 * L::kTile);
          for (int c = 0; c < L::kSegs; ++c) {
            tma_load_4d(sK(s) + c * L::kBox, &kmap, L::kSegD * c, n0, b, hk, full(s));
            tma_load_4d(sV(s) + c * L::kBox, &vmap, L::kSegD * c, n0, b, hk, full(s));
          }
        }
      }
      if constexpr (kQuant) asm volatile("cp.async.wait_all;\n" ::: "memory");
      return;
    }
  }
  if constexpr (!kContig) {
    if (warp == 0) {
      const int br = p.box_rows, parts = kN / br;
      const int* table = p.page_table + static_cast<int64_t>(b) * p.pps;
      // This lane's page of tile it, or -1: no copy of a part outside [lo, len).
      auto page_of = [&](int it) {
        const int n = (t0 + it) * kN + lane * br;
        return lane < parts && n + br > lo && n < len ? table[n / p.page_size] : -1;
      };
      constexpr int kRowBytes = 2 * (L::kRowBytes + (kQuant ? 4 : 0));  // K's and V's of a key
      int page_next = page_of(0);
      for (int it = 0; it < total; ++it) {
        const int n0 = (t0 + it) * kN, s = it % kStages, page = page_next;
        if (it + 1 < total) page_next = page_of(it + 1);
        if (lane == 0) {
          const int i0 = max(lo - n0, 0) / br, i1 = (min(len - n0, kN) + br - 1) / br;
          mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(full(s), (i1 - i0) * br * kRowBytes);
        }
        __syncwarp();
        if (page >= 0) {
          const int row = (n0 + lane * br) % p.page_size;
          const uint32_t at = lane * br * L::kSegBytes;
          for (int c = 0; c < L::kSegs; ++c) {
            tma_load_4d(sK(s) + c * L::kBox + at, &kmap, L::kSegD * c, row, page, hk, full(s));
            tma_load_4d(sV(s) + c * L::kBox + at, &vmap, L::kSegD * c, row, page, hk, full(s));
          }
          if constexpr (kQuant) {
            bulk_load(k_scales(s) + lane * br * 4,
                      p.k_scale + hk * p.ks_sh + static_cast<int64_t>(page) * p.ks_sp + row, br * 4,
                      full(s));
            bulk_load(v_scales(s) + lane * br * 4,
                      p.v_scale + hk * p.vs_sh + static_cast<int64_t>(page) * p.vs_sp + row, br * 4,
                      full(s));
          }
        }
      }
      return;
    }
  }

  // Consumers: warp w takes m-tile w % mts, its columns' part (w / mts) %
  // kOwners (the wide layout) and tiles of its slot w / (kOwners mts), +
  // slots, ...
  constexpr int kOwners = L::kOwners, kDO = L::kDO;
  const int w = warp - 1, mt = w % mts, slots = kDecodeConsumers / (kOwners * mts);
  const int part_x = L::kWide ? w / mts % kOwners * (kDO / 8) : 0;  // its first n-tile of O
  const int r = lane >> 2, c = lane & 3;
  const uint32_t sQ = base + L::kQOff;
  for (int i = threadIdx.x - 32; i < 16 * mts * (D / 8); i += 32 * kDecodeConsumers) {
    const int g = i / (D / 8), col = i % (D / 8);
    uint4 v = make_uint4(0, 0, 0, 0);  // rows past the chunk and columns past d are zero
    if (g < R && col * 8 < d) {
      v = *reinterpret_cast<const uint4*>(static_cast<const T*>(p.q) + b * p.q_sb +
                                          (hk * G + g0 + g) * p.q_sh + col * 8);
      const int live = d - col * 8;  // the chunk's columns before d
      if (live < 8) {  // the 16-byte chunk that holds column d
        uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[e] &= 2 * e + 1 < live ? 0xFFFFFFFFu : 2 * e < live ? 0x0000FFFFu : 0u;
      }
    }
    sts_u32x4(sQ + g * L::kQPitch + col * 16, v);
  }
  named_sync(1, 32 * kDecodeConsumers);

  const float scale = kCap ? p.sc.cap_exp : p.sc.scale_log2;
  const Scores sco = p.sc;
  const uint32_t q_lo = sQ + (16 * mt + r) * L::kQPitch, q_hi = q_lo + 8 * L::kQPitch;
  float o[kDO / 8][4];  // O of rows r, r + 8: n-tile x (B8: see phys_d below)
#pragma unroll
  for (int x = 0; x < kDO / 8; ++x)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[x][e] = 0.f;
  float row_max[2] = {-INFINITY, -INFINITY}, row_sum[2] = {0.f, 0.f};

  for (int it = w / (kOwners * mts); it < total; it += slots) {
    const int s = it % kStages, n0 = (t0 + it) * kN;
    const bool edge = n0 < lo || n0 + kN > len;
    auto live = [&](int key) { return key >= lo && key < len; };
    mbar_wait(full(s), (it / kStages) & 1);

    // S = Q K^T. Within each box row a thread takes bytes [c, c + 1) / 4
    // of it, a 16-byte chunk at a time: 8 bf16 values (2 k-steps) or 16
    // quantized ones (4); k-step j holds its values 4 j .. 4 j + 3, and
    // q's in the same order.
    float sf[kN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sf[nt][e] = 0.f;
    constexpr int kRunChunks = L::kSegBytes / 64, kVals = 16 / static_cast<int>(sizeof(KV));
#pragma unroll
    for (int seg = 0; seg < L::kSegs; ++seg) {
#pragma unroll
      for (int h = 0; h < kRunChunks; ++h) {
        uint32_t qa[kVals / 4][4];
#pragma unroll
        for (int j = 0; j < kVals / 8; ++j) {
          const uint32_t off = 2 * (seg * L::kSegD + c * (L::kSegD / 4) + h * kVals) + 16 * j;
          const uint4 a = lds_u32x4(q_lo + off), b = lds_u32x4(q_hi + off);
          qa[2 * j][0] = a.x, qa[2 * j][1] = b.x, qa[2 * j][2] = a.y, qa[2 * j][3] = b.y;
          qa[2 * j + 1][0] = a.z, qa[2 * j + 1][1] = b.z, qa[2 * j + 1][2] = a.w,
                      qa[2 * j + 1][3] = b.w;
        }
#pragma unroll
        for (int nt = 0; nt < kN / 8; ++nt) {
          const int key = nt * 8 + r;
          const int sw = L::kSegBytes == 128 ? key & 7 : (key >> 1) & 3;
          const uint4 kq = lds_u32x4(sK(s) + seg * L::kBox + key * L::kSegBytes +
                                     (((kRunChunks * c + h) ^ sw) << 4));
          const uint32_t kw[4] = {kq.x, kq.y, kq.z, kq.w};
#pragma unroll
          for (int j = 0; j < kVals / 4; ++j) {
            if constexpr (kQuant) {
              const uint2 kv = widen4_pairs<T, KV>(kw[j]);
              Elem<T>::mma(sf[nt], qa[j], kv.x, kv.y);
            } else {
              Elem<T>::mma(sf[nt], qa[j], kw[2 * j], kw[2 * j + 1]);
            }
          }
        }
      }
    }

    // Scale (B8: by the keys' K scales), cap, mask; the online softmax.
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt) {
      float f0 = scale, f1 = scale;
      if constexpr (kQuant) {
        const float2 ks = lds_f32x2(k_scales(s) + (nt * 8 + 2 * c) * 4);
        f0 *= ks.x, f1 *= ks.y;
      }
      sf[nt][0] *= f0, sf[nt][1] *= f1, sf[nt][2] *= f0, sf[nt][3] *= f1;
      if constexpr (kCap) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sf[nt][e] = softcap_of(sf[nt][e], sco);
      }
    }
    if (edge) {
#pragma unroll
      for (int nt = 0; nt < kN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!live(n0 + nt * 8 + 2 * c + (e & 1))) sf[nt][e] = -INFINITY;
    }
    float m_use[2], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < kN / 8; ++nt) mx = fmaxf(mx, fmaxf(sf[nt][2 * h], sf[nt][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(row_max[h], mx);
      m_use[h] = m_new == -INFINITY ? 0.f : m_new;  // never -inf - -inf
      alpha[h] = ex2(row_max[h] - m_use[h]);
      row_max[h] = m_new;
    }
    float tile_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sf[nt][e] = ex2(sf[nt][e] - m_use[e >> 1]);
        tile_sum[e >> 1] += sf[nt][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) row_sum[h] = row_sum[h] * alpha[h] + tile_sum[h];
#pragma unroll
    for (int x = 0; x < kDO / 8; ++x)
      o[x][0] *= alpha[0], o[x][1] *= alpha[0], o[x][2] *= alpha[1], o[x][3] *= alpha[1];
    if constexpr (kQuant) {  // V's scale folds into P (dead keys' scales may be NaN)
#pragma unroll
      for (int nt = 0; nt < kN / 8; ++nt) {
        float2 vs = lds_f32x2(v_scales(s) + (nt * 8 + 2 * c) * 4);
        if (edge) {
          const int key = n0 + nt * 8 + 2 * c;
          vs.x = live(key) ? vs.x : 0.f;
          vs.y = live(key + 1) ? vs.y : 0.f;
        }
        sf[nt][0] *= vs.x, sf[nt][1] *= vs.y, sf[nt][2] *= vs.x, sf[nt][3] *= vs.y;
      }
    }

    // O += P V, a k-step of 16 keys at a time: P from S's registers.
#pragma unroll
    for (int i = 0; i < kN / 16; ++i) {
      uint32_t pa[4], pl[4];  // P (its rounded part), and D1's second part
      if constexpr (kSplitP) {
        pack_split<T>(sf[2 * i][0], sf[2 * i][1], pa[0], pl[0]);
        pack_split<T>(sf[2 * i][2], sf[2 * i][3], pa[1], pl[1]);
        pack_split<T>(sf[2 * i + 1][0], sf[2 * i + 1][1], pa[2], pl[2]);
        pack_split<T>(sf[2 * i + 1][2], sf[2 * i + 1][3], pa[3], pl[3]);
      } else {
        pa[0] = Elem<T>::pack(sf[2 * i][0], sf[2 * i][1]);
        pa[1] = Elem<T>::pack(sf[2 * i][2], sf[2 * i][3]);
        pa[2] = Elem<T>::pack(sf[2 * i + 1][0], sf[2 * i + 1][1]);
        pa[3] = Elem<T>::pack(sf[2 * i + 1][2], sf[2 * i + 1][3]);
      }
      const int k0 = n0 + 16 * i + 2 * c;  // this thread's keys k0, k0 + 1, k0 + 8, k0 + 9
      // V rows of dead keys: the halves of k0 / k0 + 1 and of k0 + 8 / + 9.
      const uint32_t m0 = (live(k0) || !edge ? 0xFFFFu : 0u) |
                          (live(k0 + 1) || !edge ? 0xFFFF0000u : 0u);
      const uint32_t m1 = (live(k0 + 8) || !edge ? 0xFFFFu : 0u) |
                          (live(k0 + 9) || !edge ? 0xFFFF0000u : 0u);
      // ldmatrix.trans of 16-byte chunks x and x + 1 of the k-step's rows:
      // lanes 0-7 / 8-15 give keys 0-7 / 8-15 of chunk x, 16-31 the same of
      // chunk x + 1. A register holds two 16-bit units of keys k0 and k0 + 1
      // (or + 8, + 9) in one column: B5's values, B8's byte pairs.
      const int key = 16 * i + (lane & 7) + (lane & 8);
      const int sw = L::kSegBytes == 128 ? key & 7 : (key >> 1) & 3;
      constexpr int kChunks = L::kSegBytes / 16, kStep = kQuant ? 4 : 2;  // n-tiles a load
#pragma unroll
      for (int x = 0; x < kDO / 8; x += kStep) {
        const int chunk = (part_x + x) / (kStep / 2) + (lane >> 4);  // of the row's 16-byte chunks
        uint32_t v[4];
        ldmatrix_x4_trans(v, sV(s) + chunk / kChunks * L::kBox + key * L::kSegBytes +
                                 (((chunk % kChunks) ^ sw) << 4));
        v[0] &= m0, v[1] &= m1, v[2] &= m0, v[3] &= m1;
        if constexpr (!kQuant) {
          Elem<T>::mma(o[x], pa, v[0], v[1]);
          Elem<T>::mma(o[x + 1], pa, v[2], v[3]);
          if constexpr (kSplitP) {
            Elem<T>::mma(o[x], pl, v[0], v[1]);
            Elem<T>::mma(o[x + 1], pl, v[2], v[3]);
          }
        } else {
          // Bytes by key: n-tiles x .. x + 3 take values 2 j, 2 j + 1 of
          // chunk x / 2 and of chunk x / 2 + 1, column j.
          const uint2 lo0 = widen4_pairs<T, KV>(__byte_perm(v[0], 0, 0x3120));
          const uint2 lo8 = widen4_pairs<T, KV>(__byte_perm(v[1], 0, 0x3120));
          const uint2 hi0 = widen4_pairs<T, KV>(__byte_perm(v[2], 0, 0x3120));
          const uint2 hi8 = widen4_pairs<T, KV>(__byte_perm(v[3], 0, 0x3120));
          Elem<T>::mma(o[x], pa, lo0.x, lo8.x);
          Elem<T>::mma(o[x + 1], pa, lo0.y, lo8.y);
          Elem<T>::mma(o[x + 2], pa, hi0.x, hi8.x);
          Elem<T>::mma(o[x + 3], pa, hi0.y, hi8.y);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));  // this warp's reads of the stage are done
  }

  // Merge the warps of each m-tile in a fixed order: their rows' maxima and
  // sums, then O scaled to the common max, summed through the idle ring.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row_sum[h] += __shfl_xor_sync(0xffffffffu, row_sum[h], 1);
    row_sum[h] += __shfl_xor_sync(0xffffffffu, row_sum[h], 2);
  }
  const uint32_t stat_m = base + L::kStatOff, stat_l = stat_m + kDecodeConsumers * 16 * 4;
  if (c == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sts_f32(stat_m + (w * 16 + r + 8 * h) * 4, row_max[h]);
      sts_f32(stat_l + (w * 16 + r + 8 * h) * 4, row_sum[h]);
    }
  }
  named_sync(1, 32 * kDecodeConsumers);  // every walk is done: the ring is free
  // Value d of column j of n-tile x: B5 8 x + j, B8 16 (x / 2) + 2 j + x % 2;
  // the wide layout's part of the columns starts at 8 part_x.
  auto phys_d = [&](int x, int j) {
    return 8 * part_x + (L::kQuant ? 16 * (x >> 1) + 2 * j + (x & 1) : 8 * x + j);
  };
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float top = -INFINITY;
    for (int v = mt; v < kDecodeConsumers; v += mts)
      top = fmaxf(top, lds_f32(stat_m + (v * 16 + r + 8 * h) * 4));
    const float f = row_max[h] == -INFINITY ? 0.f : ex2(row_max[h] - top);
    const uint32_t row = base + (w * 16 + r + 8 * h) * D * 4;
#pragma unroll
    for (int x = 0; x < kDO / 8; ++x) {
      sts_f32(row + phys_d(x, 2 * c) * 4, o[x][2 * h] * f);
      sts_f32(row + phys_d(x, 2 * c + 1) * 4, o[x][2 * h + 1] * f);
    }
  }
  named_sync(1, 32 * kDecodeConsumers);
  const int tid = threadIdx.x - 32, rows = chunk_rows;
  const int64_t stat = chunk_stat0;
  float* out = p.acc + stat * d;
  for (int i = tid; i < rows * D; i += 32 * kDecodeConsumers) {
    const int g = i / D, e = i % D;
    if (e >= d) continue;  // the layout's columns past d
    float sum = 0.f;  // over the slots of the warps that own column e
    for (int v = g / 16 + (L::kWide ? e / kDO * mts : 0); v < kDecodeConsumers; v += kOwners * mts)
      sum += lds_f32(base + ((v * 16 + g % 16) * D + e) * 4);
    out[g * d + e] = sum;
  }
  if (tid < rows) {
    float top = -INFINITY, sum = 0.f;
    // The owners of an m-tile's columns hold the same m and l: the first's.
    for (int v = tid / 16; v < kDecodeConsumers; v += kOwners * mts)
      top = fmaxf(top, lds_f32(stat_m + (v * 16 + tid % 16) * 4));
    for (int v = tid / 16; v < kDecodeConsumers; v += kOwners * mts) {
      const float mv = lds_f32(stat_m + (v * 16 + tid % 16) * 4);
      sum += mv == -INFINITY ? 0.f : lds_f32(stat_l + (v * 16 + tid % 16) * 4) * ex2(mv - top);
    }
    p.m[stat + tid] = top;
    p.l[stat + tid] = sum;
  }
}

// B5 / B8: keys through the page table.
template <typename T, typename KV, int D, bool kCap>
__global__ void __launch_bounds__(kPagedDecodeThreads, DecodeTiles<KV, D>::kMinBlocks)
    paged_decode_kernel(const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap, const PagedDecodeParams p) {
  decode_body<T, KV, D, kCap, false>(kmap, vmap, p);
}

// D1 / B7: keys of a contiguous cache.
template <typename T, typename KV, int D, bool kCap>
__global__ void __launch_bounds__(kPagedDecodeThreads, DecodeTiles<KV, D>::kMinBlocks)
    contiguous_decode_kernel(const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap, const PagedDecodeParams p) {
  decode_body<T, KV, D, kCap, true>(kmap, vmap, p);
}

template <typename T, typename KV, int D, bool kCap, bool kContig>
auto decode_kernel() {
  if constexpr (kContig) return contiguous_decode_kernel<T, KV, D, kCap>;
  else return paged_decode_kernel<T, KV, D, kCap>;
}

// ---------------------------------------------------------------------------
// Host side.

template <typename T, typename KV, int D, bool kCap, bool kContig>
int launch_paged_decode(const PagedDecodeParams& p, const PagedViews& w, int batch,
                        cudaStream_t stream) {
  using L = DecodeTiles<KV, D>;
  auto kernel = decode_kernel<T, KV, D, kCap, kContig>();
  static const int configured = allow_smem(kernel, L::kBytes);  // above 48 KB needs an opt-in
  if (configured != cudaSuccess) return configured;
  // The chunk plan (dispatch.decode_group_chunks) must cover the group,
  // hold at most 32 rows a chunk and leave no chunk empty.
  if (p.group < 1 || p.num_splits < 1 || p.chunks < 1 || p.rows < 1 || p.rows > 32 ||
      p.chunks * p.rows < p.group || (p.chunks - 1) * p.rows >= p.group)
    return cudaErrorInvalidValue;
  if (kContig ? p.chunk < 1 || p.pps != 1
              : p.box_rows < 8 || L::kN % p.box_rows || p.page_size % p.box_rows)
    return cudaErrorInvalidValue;
  if (batch <= 0 || p.hkv <= 0) return cudaSuccess;
  const CUtensorMapDataType type = L::kQuant ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                   : std::is_same_v<T, __nv_bfloat16> ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  const CUtensorMapSwizzle swizzle =
      L::kSegBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const int elem = static_cast<int>(sizeof(KV));
  const int rows = kContig ? L::kN : p.box_rows;  // contiguous: a whole tile a box
  CUtensorMap kmap, vmap;  // the maps hold d columns: zeros past them
  if (!pool_map(&kmap, type, elem, w.k, p.d, p.page_size, w.num_pages, w.hkv, w.k_ss, w.k_sp, w.k_sh,
                L::kSegD, rows, swizzle) ||
      !pool_map(&vmap, type, elem, w.v, p.d, p.page_size, w.num_pages, w.hkv, w.v_ss, w.v_sp, w.v_sh,
                L::kSegD, rows, swizzle))
    return cudaErrorInvalidValue;
  if (static_cast<long long>(p.hkv) * p.chunks > 65535) return cudaErrorInvalidValue;
  const dim3 grid(p.num_splits, p.hkv * p.chunks, batch);
  kernel<<<grid, kPagedDecodeThreads, L::kBytes, stream>>>(kmap, vmap, p);
  return cudaGetLastError();
}

template <typename T, typename KV, int D, bool kContig>
int launch_paged_decode_cap(const PagedDecodeParams& p, const PagedViews& w, int batch,
                            cudaStream_t s) {
  return p.sc.softcap_log2 > 0.f ? launch_paged_decode<T, KV, D, true, kContig>(p, w, batch, s)
                                 : launch_paged_decode<T, KV, D, false, kContig>(p, w, batch, s);
}

// kContig: `p` and `w` describe one layer's contiguous cache [B, Hkv, C, d]
// as a pool of B pages of C keys (pps 1, page_size C, num_pages B, the page
// strides those of b), its scales' page strides those of b too. Each runs
// p.d in the layout of padded_head_dim(d, true): a d from 257 to 512 in the
// wide layout of 512.
template <typename T, typename KV, bool kContig = false>
int dispatch_paged_decode(const PagedDecodeParams& p, const PagedViews& w, int batch, int d,
                          cudaStream_t s) {
  const int layout = padded_head_dim(d, true);
  if (layout == 64) return launch_paged_decode_cap<T, KV, 64, kContig>(p, w, batch, s);
  if (layout == 128) return launch_paged_decode_cap<T, KV, 128, kContig>(p, w, batch, s);
  if (layout == 256) return launch_paged_decode_cap<T, KV, 256, kContig>(p, w, batch, s);
  if (layout == 512) return launch_paged_decode_cap<T, KV, 512, kContig>(p, w, batch, s);
  return cudaErrorInvalidValue;
}

// The report lines of the eight instantiations (D x cap) of one T, KV and
// way of finding keys.
template <typename T, typename KV, bool kContig = false>
static void report_paged_decode(char* out, int cap, int& used, const char* what) {
  char name[96];
#define DECODE_REPORT(d, c)                                                      \
  snprintf(name, sizeof(name), "%s D%d%s", what, d, c ? " cap" : "");           \
  report_one(out, cap, used, name, (decode_kernel<T, KV, d, c, kContig>()),       \
             DecodeTiles<KV, d>::kBytes)
  DECODE_REPORT(64, false);
  DECODE_REPORT(64, true);
  DECODE_REPORT(128, false);
  DECODE_REPORT(128, true);
  DECODE_REPORT(256, false);
  DECODE_REPORT(256, true);
  DECODE_REPORT(512, false);
  DECODE_REPORT(512, true);
#undef DECODE_REPORT
}

}  // namespace fact
