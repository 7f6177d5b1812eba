// Chunked prefill over a paged KV cache, the kernel of
//
//   * B6 (paged_attention.cu, bf16 / f16 pages): replaces the TPU kernel
//     flash_attention_cute_tpu/ops/paged_attention.py `_paged_extend_kernel`
//     (:391, pallas_call at :742);
//   * B9 (quant_paged_extend.cu, int8 / e4m3 pages with one f32 scale per
//     token and kv head): replaces flash_attention_cute_tpu/ops/quantized.py
//     `_quant_paged_extend_kernel` (:717, pallas_call at :1076).
//
// The chunk's S query rows of batch row b sit at global positions
// q_offset[b] + r and see key n iff n <= q_offset[b] + r, n < kv_length[b]
// (clamped to the table's pps * ps keys) and, with a window W,
// n > q_offset[b] + r - W; kv_length 0 marks an inactive row, whose output
// is exact zeros. The tanh soft cap applies before the mask. GQA: q head h
// reads kv head h / (Hq / Hkv). Key n sits at page page_table[b, n / ps],
// row n % ps, of one layer's pool [Hkv, P, ps, D]. B9 computes what the TPU
// kernel computes: values widened exactly to q's type, S multiplied by each
// key's K scale in fp32 before the cap, P by each key's V scale before it is
// rounded to q's type (the TPU kernel's `(p * vscale).astype(...)`); no
// scale is folded into a rounded K / V value. Every head dim d runs in the
// layout D of padded_head_dim(d, true), from 1 to 256, its pool rows at
// any 16-byte stride (row_pitch(d, sizeof(KV)) in the port's pools), and
// every d from 257 to 512 in P's wide layout of 512 (attention_wgmma.cuh:
// two blocks along grid y, each O's columns [256 y, 256 y + 256), S
// recomputed in each, a V copy holding the chunk's columns; 32-key tiles;
// B9 widens the chunk's columns of V only). As in P,
// the maps hold d columns, TMA reads zeros past them (B9's raw boxes too,
// which the widening turns into exact zeros), and O is stored at the row
// pitch row_pitch(d), its columns past d zeros (the TPU kernels pad D to
// their 128 lanes, paged_attention.py:665, quantized.py:995).
//
// What bounds them on the H100: tensor-core operations (4 D per visible
// (row, key) pair and q head) at chunk lengths, far above the card's ~295
// operations per byte. So they are P's design (attention_wgmma.cuh: two
// wgmma consumers in ping-pong, exact softmax, S and P in registers, V read
// MN-major, bit-identical repeats) with a producer warpgroup of their own:
//
//   * The grid is sized from shapes alone. A block reads its row's q_offset
//     and kv_length and walks the tiles from its first visible key (the
//     window start) to its causal end, or none, and then writes zeros.
//   * Warp 0 of the producer copies the pages: lane i takes keys
//     [n0 + i br, n0 + (i + 1) br) of a tile of kN keys, one page or a part
//     of one (br: `box_rows`, ops/paged_attention.extend_plan), through a
//     4-D map of the pool (D, ps, P, Hkv): its page id from the table (the
//     next tile's loaded while this one's copies go out), then one TMA copy
//     per 64-column box, every lane at once. A part at or past kv_length
//     gets no copy (the table is padded with page 0 there).
//   * Tails: the pool holds anything at and past kv_length (NaN in the
//     tests), and 0 x NaN is NaN in P V. K needs nothing: a score of such a
//     key is masked by a select. B6's last tile, if it crosses kv_length,
//     lands on a barrier of its own; warp 0 then zeroes its V rows at and
//     past kv_length (copied or not; the chunk's columns in the wide
//     layout) and hands the tile on.
//   * B9: the raw values land by TMA in the upper half of their slot (at D
//     64 in a raw slot beside it; at D 512 a V slot's upper half holds the
//     chunk's 256 raw columns, 8 KB), the scales by bulk copies beside the
//     slots. Warps 1-3 of the producer widen each tile in place into the
//     swizzled bf16 / f16 layout wgmma reads (every row: zeros at and past
//     kv_length, its scales too), then hand it on. The producer warpgroup
//     keeps 40 registers for it, the consumers 232 (at D 512 56 and 224;
//     B6: 24 and 240; setmaxnreg moves registers only within the block, 3
//     x 168 a thread).
//   * Shared memory (K slots / V slots of kN keys): B6 as P (D 64 / 128 /
//     256 / 512: 4 / 4, 4 / 2, 3 / 2, 2 / 2; at D 512 Q 128 KB, K slots of
//     32 KB, V slots of the chunk's 16 KB: 230,480 bytes with the
//     barriers); B9 4 / 4, 3 / 2, 3 / 2, 2 / 2 and the scales, up to
//     231,808 bytes at D 256 and 231,016 at D 512 (512 bytes of scales,
//     four landing barriers); one block an SM.
#pragma once

#include "attention_wgmma.cuh"

namespace fact {

struct PagedParams {
  void* o;                // [B, Hq, Sq, d], rows at the pitch `d` holds on the device
  const int* q_offset;    // [B] int32: global position of q row 0
  const int* kv_length;   // [B] int32: keys visible to the chunk (0 = inactive)
  const int* page_table;  // [B, pps] int32
  const float* k_scale;   // B9: one layer's scales [Hkv, P, ps], position stride 1
  const float* v_scale;
  int64_t ks_sh, ks_sp, vs_sh, vs_sp;
  int batch, hq, group, sq, pps, page_size;
  int box_rows;  // keys of one copy: a page, or a part of one
  Scores sc;
  int window;  // W > 0, or 0 for none
  int d;       // the true head dim (D or below it); on the device O's row pitch
};

// Shared memory: Q, the K and V slots (Rings; a V slot holds its chunk's
// columns, Tiles::kV), B9's raw slots at D 64 and its scales (kN floats a
// slot, K's then V's), the barriers (Rings', then B6's tail barrier or B9's
// landing barriers, K's then V's).
template <int D, bool kQuant>
struct PagedSmem {
  using Tl = Tiles<D>;
  static constexpr int kKStages = D > 256 ? 2 : kQuant ? (D == 64 ? 4 : 3) : D == 256 ? 3 : 4;
  static constexpr int kVStages = D == 64 ? 4 : 2;
  static constexpr int kRaw = kQuant && D == 64 ? Tl::kN * 64 : 0;
  static constexpr int kRawOff = Tl::kQ + kKStages * Tl::kKV + kVStages * Tl::kV;
  static constexpr int kScaleOff = kRawOff + (kKStages + kVStages) * kRaw;
  static constexpr int kBars = kScaleOff + (kQuant ? (kKStages + kVStages) * Tl::kN * 4 : 0);
  static constexpr int kExtra = kQuant ? kKStages + kVStages : 1;
  static constexpr int kBytes =
      1024 + kBars + (Rings<D, kKStages, kVStages, kBars>::kBarriers + kExtra) * 8;
};

__device__ __forceinline__ void sts_f32(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

// Four quantized values (one 32-bit word, value 0 in its low byte) as two
// pairs of T, exactly: int8 and e4m3 values fit bf16's and f16's
// significands.
template <typename T, typename KV>
__device__ __forceinline__ uint2 widen4(uint32_t w) {
  if constexpr (std::is_same_v<KV, int8_t>) {
    const uint32_t u = w ^ 0x80808080u;  // x + 128 as unsigned bytes
    if constexpr (std::is_same_v<T, __half>) {
      // f16 0x64uu is 1024 + uu; minus 1152 leaves x.
      uint32_t lo = __byte_perm(u, 0x64646464u, 0x7170), hi = __byte_perm(u, 0x64646464u, 0x7372);
      asm("sub.f16x2 %0, %0, %1;\n" : "+r"(lo) : "r"(0x64806480u));
      asm("sub.f16x2 %0, %0, %1;\n" : "+r"(hi) : "r"(0x64806480u));
      return make_uint2(lo, hi);
    } else {
      // fp32 0x4B0000uu is 2^23 + uu; minus 2^23 + 128 leaves x, whose
      // upper half is its bf16 (at most 8 significant bits).
      uint32_t f[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        f[i] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) - 8388736.f);
      return make_uint2(__byte_perm(f[0], f[1], 0x7632), __byte_perm(f[2], f[3], 0x7632));
    }
  } else {
    uint32_t out[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>(w >> (16 * i)), __NV_E4M3);
      if constexpr (std::is_same_v<T, __half>) {
        out[i] = static_cast<uint32_t>(h.x) | static_cast<uint32_t>(h.y) << 16;
      } else {
        const float2 f = __half22float2(__half2(h));
        out[i] = Elem<T>::pack(f.x, f.y);
      }
    }
    return make_uint2(out[0], out[1]);
  }
}

// B9: widen tile it of a ring in place (warps 1-3 of the producer, `wt` in
// 0..95), once its raw values and scales have landed on `landed`: row r of
// the raw tile (kCols values: D, or a V slot's chunk of the wide layout;
// min(kCols, 128) bytes a row, kCols / 128 boxes of them above 128)
// becomes row r of the slot's kCols / 64 swizzled boxes of T, zeros at and
// past `live`, where its scale is zeroed too. Above 64 columns the raw rows
// lie in the slot's upper half, each under the wide row of its own index:
// a warp (at 512 columns), half-warp (256) or quarter (128) reads whole
// rows, a batch of steps at a time, before it writes them. Then hands the
// tile on (`full`).
template <typename T, typename KV, int D, int kCols = D>
__device__ __forceinline__ void widen_tile(uint32_t slot, uint32_t raw, uint32_t scales, int live,
                                           int wt, uint32_t landed, int parity, uint32_t full) {
  constexpr int kN = Tiles<D>::kN, kBox = Tiles<D>::kKVBox;
  constexpr int kPitch = kCols < 128 ? kCols : 128, kRowSteps = kCols / 16;  // 16 raw values a step
  constexpr int kRows = 96 / kRowSteps;  // rows the 96 threads step over at once
  // Steps loaded before any is written: two, where the producer's 40
  // registers hold them (int8 to bf16 takes more temporaries: one).
  constexpr int kBatch = std::is_same_v<T, __nv_bfloat16> && std::is_same_v<KV, int8_t> ? 1 : 2;
  // A thread keeps its values e .. e + 15 of every kRows-th row from row0:
  // 16-byte chunks (e % 64) / 8 and + 1 of box e / 64, swizzled by the row.
  const int e = wt % kRowSteps * 16, row0 = wt / kRowSteps, chunk = e % 64 / 8;
  const uint32_t src = raw + e / 128 * kBox + e % 128 + row0 * kPitch;
  const uint32_t dst = slot + e / 64 * kBox + row0 * 128;
  mbar_wait(landed, parity);
#pragma unroll 1
  for (int i0 = 0; row0 + i0 * kRows < kN; i0 += kBatch) {
    uint4 v[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      if (row0 + (i0 + i) * kRows < kN) v[i] = lds_u32x4(src + (i0 + i) * kRows * kPitch);
    __syncwarp();  // the warp's rows are read before their wide bytes overwrite them
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int row = row0 + (i0 + i) * kRows;
      if (row < kN) {
        const uint32_t at = dst + (i0 + i) * kRows * 128;
        const int sw = row & 7;
        uint4 w = make_uint4(0, 0, 0, 0);
        if (row < live) {
          const uint2 a = widen4<T, KV>(v[i].x), b = widen4<T, KV>(v[i].y);
          w = make_uint4(a.x, a.y, b.x, b.y);
        }
        sts_u32x4(at + ((chunk ^ sw) << 4), w);
        if (row < live) {
          const uint2 a = widen4<T, KV>(v[i].z), b = widen4<T, KV>(v[i].w);
          w = make_uint4(a.x, a.y, b.x, b.y);
        }
        sts_u32x4(at + (((chunk + 1) ^ sw) << 4), w);
      }
    }
  }
#pragma unroll 1
  for (int row = live + wt; row < kN; row += 96) sts_f32(scales + 4 * row, 0.f);
  fence_proxy_async();
  __syncwarp();
  if ((wt & 31) == 0) mbar_arrive(full);
}

// KV: T (B6) or int8 / e4m3 (B9). kCap: the soft cap is compiled in.
template <typename T, typename KV, int D, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
    paged_extend_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap, const PagedParams p) {
  constexpr bool kQuant = sizeof(KV) == 1;
  using S = PagedSmem<D, kQuant>;
  using Tl = Tiles<D>;
  constexpr int kN = Tl::kN, kKStages = S::kKStages, kVStages = S::kVStages;
  // setmaxnreg moves registers only within the block (3 x 168 a thread of
  // each warpgroup): B6's producer keeps 24, B9's 40 for the widening (56
  // at D 512, whose two widenings of 512 and 256 columns spilled at 40; its
  // consumers take 224, recomputing q's descriptors a tile: consume).
  constexpr int kProducerRegs = kQuant ? (D > 256 ? 56 : 40) : 24;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;  // the 128-byte swizzle needs 1 KB
  const uint32_t sQ = base, scales = base + S::kScaleOff;
  const Rings<D, kKStages, kVStages, S::kBars> r{base};

  const int per = p.hq * p.batch;
  const int nqb = (p.sq + kBlockM - 1) / kBlockM;
  const int m0 = (nqb - 1 - static_cast<int>(blockIdx.x) / per) * kBlockM;  // most keys first
  const int h = blockIdx.x % per % p.hq, b = blockIdx.x % per / p.hq, hk = h / p.group;
  const int skv = min(max(p.kv_length[b], 0), p.pps * p.page_size);
  const int offset = p.q_offset[b];
  // The first of O's (and V's) columns of this block's chunk (the wide layout).
  const int c0 = Tl::kChunks > 1 ? Tl::kDO * static_cast<int>(blockIdx.y) : 0;
  // The consumers read which keys the rows see and the softmax's scalars
  // from shared memory, so that they take none of their registers (B9's
  // consumers spill at D 256 otherwise).
  __shared__ Visible vis;
  __shared__ Scores sco;
  // Keys from the window's near edge (row m0's first visible key) to the
  // causal edge (the last row's last); none for an inactive row.
  const int n_end = min(skv, m0 + kBlockM + offset);
  const int n_begin = (p.window > 0 ? max(0, m0 + offset - p.window + 1) : 0) / kN * kN;
  const int total = n_end > n_begin ? (n_end - n_begin + kN - 1) / kN : 0;

  if (threadIdx.x == 0) {
    vis = Visible{p.sq, skv, offset, 1, p.window};
    sco = p.sc;
    r.init(kQuant ? 3 : 1);  // B9: the three widening warps hand a tile on
    for (int i = 0; i < S::kExtra; ++i) mbar_init(r.extra(i), 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (total == 0) return;
    // B9's raw slots and scales of tile it, and the barriers they land on
    // (raw V: the chunk's Tl::kDO columns in the wide layout).
    auto raw_k = [&](int it) {
      return D == 64 ? base + S::kRawOff + it % kKStages * S::kRaw : r.sK(it) + D / 128 * Tl::kKVBox;
    };
    auto raw_v = [&](int it) {
      return D == 64 ? base + S::kRawOff + (kKStages + it % kVStages) * S::kRaw
                     : r.sV(it) + Tl::kDO / 128 * Tl::kKVBox;
    };
    auto scales_k = [&](int it) { return scales + it % kKStages * kN * 4; };
    auto scales_v = [&](int it) { return scales + (kKStages + it % kVStages) * kN * 4; };
    auto landed_k = [&](int it) { return r.extra(it % kKStages); };
    auto landed_v = [&](int it) { return r.extra(kKStages + it % kVStages); };

    if (warp == 0) {
      if (lane == 0) {
        mbar_expect_tx(r.q_full(), Tl::kQ);
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(sQ + c * Tl::kQBox, &qmap, 64 * c, m0, h, b, r.q_full());
      }
      const int br = p.box_rows;
      const int* table = p.page_table + static_cast<int64_t>(b) * p.pps;
      // This lane's page of tile it, or -1: no copy past kv_length.
      auto page_of = [&](int it) {
        const int key = n_begin + it * kN + lane * br;
        return lane * br < kN && key < skv ? table[key / p.page_size] : -1;
      };
      // The bytes of one copy of K or V: values (and B9's scales).
      constexpr int kRowBytes = D * static_cast<int>(sizeof(KV)) + (kQuant ? 4 : 0);
      // B9's raw boxes of 128 (D 64: 64) values a row; B6's swizzled ones of 64.
      constexpr int kCols = kQuant ? (D < 128 ? D : 128) : 64, kColBoxes = D / kCols;
      constexpr int kPitch = kCols * static_cast<int>(sizeof(KV));  // bytes of a box's row
      // V's boxes and row bytes: its chunk's columns (the wide layout).
      constexpr int kVColBoxes = Tl::kDO / kCols;
      constexpr int kVRowBytes = Tl::kDO * static_cast<int>(sizeof(KV)) + (kQuant ? 4 : 0);
      int page_next = page_of(0);
      for (int it = 0; it < total; ++it) {
        const int n0 = n_begin + it * kN, page = page_next;
        if (it + 1 < total) page_next = page_of(it + 1);
        const int row = (n0 + lane * br) % p.page_size;
        const int live = min(kN, skv - n0);  // keys of the tile below kv_length
        const int bytes = (live + br - 1) / br * br * kRowBytes;
        const int vbytes = kVRowBytes == kRowBytes ? bytes : (live + br - 1) / br * br * kVRowBytes;
        const bool tail = !kQuant && live < kN;  // B6: V rows to zero
        const uint32_t kbar = kQuant ? landed_k(it) : r.full_k(it);
        const uint32_t vbar = kQuant ? landed_v(it) : tail ? r.extra(0) : r.full_v(it);
        if (lane == 0) {
          mbar_wait(r.empty_k(it), r.k_pass(it) ^ 1);
          mbar_expect_tx(kbar, bytes);
        }
        __syncwarp();
        if (page >= 0) {
          for (int c = 0; c < kColBoxes; ++c)
            tma_load_4d((kQuant ? raw_k(it) : r.sK(it)) + c * Tl::kKVBox + lane * br * kPitch,
                        &kmap, kCols * c, row, page, hk, kbar);
          if constexpr (kQuant)
            bulk_load(scales_k(it) + lane * br * 4, p.k_scale + hk * p.ks_sh + page * p.ks_sp + row,
                      br * 4, kbar);
        }
        if (lane == 0) {
          mbar_wait(r.empty_v(it), r.v_pass(it) ^ 1);
          mbar_expect_tx(vbar, vbytes);
        }
        __syncwarp();
        if (page >= 0) {
          for (int c = 0; c < kVColBoxes; ++c)
            tma_load_4d((kQuant ? raw_v(it) : r.sV(it)) + c * Tl::kKVBox + lane * br * kPitch,
                        &vmap, c0 + kCols * c, row, page, hk, vbar);
          if constexpr (kQuant)
            bulk_load(scales_v(it) + lane * br * 4, p.v_scale + hk * p.vs_sh + page * p.vs_sp + row,
                      br * 4, vbar);
        }
        if (tail) {  // only the walk's last tile crosses kv_length
          mbar_wait(r.extra(0), 0);
          const int dead = (kN - live) * 8;  // 16-byte chunks of a box's dead rows
          for (int i = lane; i < Tl::kDO / 64 * dead; i += 32)
            sts_u32x4(r.sV(it) + i / dead * Tl::kKVBox + live * 128 + i % dead * 16,
                      make_uint4(0, 0, 0, 0));
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) mbar_arrive(r.full_v(it));
        }
      }
    } else if constexpr (kQuant) {
      const int wt = threadIdx.x - 32;
      for (int it = 0; it < total; ++it) {
        const int live = min(kN, skv - (n_begin + it * kN));
        widen_tile<T, KV, D>(r.sK(it), raw_k(it), scales_k(it), live, wt, landed_k(it),
                             r.k_pass(it), r.full_k(it));
        widen_tile<T, KV, D, Tl::kDO>(r.sV(it), raw_v(it), scales_v(it), live, wt, landed_v(it),
                                      r.v_pass(it), r.full_v(it));
      }
    }
    return;
  }

  setmaxnreg_inc<(504 - kProducerRegs) / 2>();
  // The chunk's O columns (the wide layout).
  consume<T, D, kCap, kQuant ? S::kScaleOff : 0>(r, vis, sco, m0, n_begin, total,
                                                 static_cast<T*>(p.o) + c0, nullptr, b * p.hq + h,
                                                 p.d, {}, min(Tl::kDO, p.d - c0));
}

// ---------------------------------------------------------------------------
// Host side.

struct PagedViews {
  const void *q, *k, *v;
  long long q_sb, q_sh, q_ss, k_sh, k_sp, k_ss, v_sh, v_sp, v_ss;  // element strides
  int hkv, num_pages, dtype;
};

// A 4-D map (D, ps, P, Hkv) of one layer's pool [Hkv, P, ps, D] (element
// strides, D contiguous) with boxes of `cols` values x `rows` keys of one
// page. A dimension of size 1 gets the row's byte count, rounded up to 16,
// as its stride.
static bool pool_map(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* base, int d,
                     int ps, int pages, int hkv, long long ss, long long sp, long long sh, int cols,
                     int rows, CUtensorMapSwizzle swizzle) {
  const long long row = static_cast<long long>(elem) * row_pitch(d, elem);  // size-1 dims' stride
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(ps),
                              static_cast<cuuint64_t>(pages), static_cast<cuuint64_t>(hkv)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ps > 1 ? elem * ss : row),
                                 static_cast<cuuint64_t>(pages > 1 ? elem * sp : row),
                                 static_cast<cuuint64_t>(hkv > 1 ? elem * sh : row)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), static_cast<cuuint32_t>(rows), 1, 1};
  return make_map(map, type, 4, base, dims, strides, box, swizzle);
}

template <typename T, typename KV, int D, bool kCap>
int launch_paged_extend(const PagedParams& p, const PagedViews& w, cudaStream_t stream) {
  constexpr bool kQuant = sizeof(KV) == 1;
  using S = PagedSmem<D, kQuant>;
  auto kernel = paged_extend_kernel<T, KV, D, kCap>;
  static const int configured = allow_smem(kernel, S::kBytes);  // above 48 KB needs an opt-in
  if (configured != cudaSuccess) return configured;
  if (p.box_rows < 8 || Tiles<D>::kN % p.box_rows || p.page_size % p.box_rows)
    return cudaErrorInvalidValue;
  const long long blocks = static_cast<long long>((p.sq + kBlockM - 1) / kBlockM) * p.hq * p.batch;
  if (blocks <= 0) return cudaSuccess;
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
  const CUtensorMapDataType type = kQuant ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                   : std::is_same_v<T, __nv_bfloat16> ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  const int cols = kQuant ? (D < 128 ? D : 128) : 64;
  const CUtensorMapSwizzle swizzle = kQuant ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B;
  const int elem = static_cast<int>(sizeof(KV));
  const int d = p.d;  // the maps hold d columns: zeros past them
  CUtensorMap qmap, kmap, vmap;
  if (!head_map(&qmap, w.dtype, w.q, p.batch, p.hq, p.sq, d, w.q_sb, w.q_sh, w.q_ss, kBlockM) ||
      !pool_map(&kmap, type, elem, w.k, d, p.page_size, w.num_pages, w.hkv, w.k_ss, w.k_sp, w.k_sh,
                cols, p.box_rows, swizzle) ||
      !pool_map(&vmap, type, elem, w.v, d, p.page_size, w.num_pages, w.hkv, w.v_ss, w.v_sp, w.v_sh,
                cols, p.box_rows, swizzle))
    return cudaErrorInvalidValue;
  PagedParams kp = p;
  kp.d = row_pitch(d);  // O's row pitch
  const dim3 grid(static_cast<unsigned>(blocks), Tiles<D>::kChunks);
  kernel<<<grid, kThreads, S::kBytes, stream>>>(qmap, kmap, vmap, kp);
  return cudaGetLastError();
}

template <typename T, typename KV, int D>
int launch_paged_extend_cap(const PagedParams& p, const PagedViews& w, cudaStream_t s) {
  return p.sc.softcap_log2 > 0.f ? launch_paged_extend<T, KV, D, true>(p, w, s)
                                 : launch_paged_extend<T, KV, D, false>(p, w, s);
}

// B6 and B9 run d in the layout of padded_head_dim(d, true) (up to 512).
template <typename T, typename KV>
int dispatch_paged_extend(const PagedParams& p, const PagedViews& w, int d, cudaStream_t s) {
  const int layout = padded_head_dim(d, true);
  if (layout == 64) return launch_paged_extend_cap<T, KV, 64>(p, w, s);
  if (layout == 128) return launch_paged_extend_cap<T, KV, 128>(p, w, s);
  if (layout == 256) return launch_paged_extend_cap<T, KV, 256>(p, w, s);
  if (layout == 512) return launch_paged_extend_cap<T, KV, 512>(p, w, s);
  return cudaErrorInvalidValue;
}

// The report lines of the eight instantiations (D x cap) of one T and KV.
template <typename T, typename KV>
static void report_paged_extend(char* out, int cap, int& used, const char* what) {
  char name[96];
#define PAGED_REPORT(d, c)                                                   \
  snprintf(name, sizeof(name), "%s D%d%s", what, d, c ? " cap" : "");       \
  report_one(out, cap, used, name, (paged_extend_kernel<T, KV, d, c>),      \
             PagedSmem<d, sizeof(KV) == 1>::kBytes)
  PAGED_REPORT(64, false);
  PAGED_REPORT(64, true);
  PAGED_REPORT(128, false);
  PAGED_REPORT(128, true);
  PAGED_REPORT(256, false);
  PAGED_REPORT(256, true);
  PAGED_REPORT(512, false);
  PAGED_REPORT(512, true);
#undef PAGED_REPORT
}

}  // namespace fact
