// Split-KV single-token decode partials, shared by kernel D1 (contiguous
// cache, flash_decode.cu) and its quantized-cache twin B7 (quantized.cu),
// whose K/V are int8 or e4m3 values with one f32 scale per key row: the K
// scale multiplies the row's score, the V scale its probability before the
// PV update, so no K/V row is ever dequantized. The kPaged branch (key rows
// through a page table) has no instantiation left: the paged decodes B5 and
// B8 are paged_decode.cuh.
//
// What bounds it on the H100: decode reads every live K/V row once and
// does 4 * G * D operations per row for G = Hq / Hkv query rows, about
// G operations per byte, far below the card's ~295, so the bound is memory
// bytes (a quantized cache halves them: 1-byte values plus 4 bytes of scale
// per row and head). Design: one block of 128 threads per (split, kv head,
// batch row) carries the whole GQA group of G query rows, so each K/V row
// is read once per group. With a sliding window W > 0 the single query at
// position len - 1 sees keys [max(0, len - W), len): the visible range
// replaces [0, len) below, so keys under the window are never loaded (nor
// their scales). D / 8 threads share a key row and each loads 8
// elements of it (16 bytes of bf16, 8 of int8 / e4m3), so a warp reads
// whole rows; one thread of the row loads its two scales. A block reads its
// own length (and, paged, its page-table entries) from device memory; the
// grid is sized from the split count, never from the live lengths (no host
// sync per step), and splits with no visible key (past the length or,
// contiguous, wholly below the window) write m = -inf, l = 0, acc = 0 and
// exit. Rows and scales at or past the length are never
// loaded, so a cache tail of uninitialised memory (even NaN) cannot leak in.
// Scores are kept in base 2 (scale * log2(e) folded in), as in the prefill
// kernel, and so is the tanh soft cap of D1 (its kCap
// instantiations): x = c2 * tanh(x / c2), c2 = c * log2(e), on each
// score before it is stored for the softmax. At head dim 256 a key row is one warp's (kTpk 32) and
// four rows are in flight, so the score reduction stays within a warp and
// s_red keeps its 32 KB at G 8. Not yet done (later work): cp.async/TMA
// prefetch of the next tile, and a single fused launch with the combine.
#pragma once

#include "common.cuh"

namespace fact {

struct DecodeParams {
  const void* q;         // [B, Hq, 1, D]
  const void* k;         // contiguous: one layer's cache [B, Hkv, C, D];
  const void* v;         // paged: one layer's pool [Hkv, P, ps, D]
  const int* lengths;    // [B] int32 on the device
  const int* page_table; // paged: [B, pps] int32 on the device
  float* acc;            // [B, Hkv, S, G, D] unnormalised partial outputs
  float* m;              // [B, Hkv, S, G] running max (base 2)
  float* l;              // [B, Hkv, S, G] running sum
  int64_t q_sb, q_sh;
  int64_t k_sb, k_sh, k_ss, k_sp;  // k_sb: contiguous only; k_sp: paged only
  int64_t v_sb, v_sh, v_ss, v_sp;
  int hkv, group, capacity, num_splits;
  int chunk;             // contiguous: keys per split (paged: from each length)
  int pps, page_size;    // paged only
  float scale_log2;
  float softcap_log2;    // soft cap c * log2(e) (base-2 units), or 0 for none
  float softcap_rcp;     // 1 / softcap_log2 (0 for none), set by the C entry
  int window;            // sliding window W > 0, or 0 for none
};

// Extra arguments of the quantized instantiations (B7): the scales lie
// like the values without the head dim, [B, Hkv, C] contiguous or
// [Hkv, P, ps] paged, position stride 1.
struct KVScales {
  const float* k;
  const float* v;
  int64_t k_sb, k_sh, k_sp;  // k_sb: contiguous only; k_sp: paged only
  int64_t v_sb, v_sh, v_sp;
};
struct QuantDecodeParams : DecodeParams {
  KVScales scales;
};
template <typename KV>
using DecodeArgs = std::conditional_t<sizeof(KV) == 1, QuantDecodeParams, DecodeParams>;

constexpr int kDecodeThreads = 128;
constexpr int kDecodeTile = 64;  // keys per softmax step

// Element offset of key row n of (batch row b, kv head hk): contiguous rows
// follow the cache's strides, paged rows go through the page table.
template <bool kPaged>
__device__ __forceinline__ int64_t key_row(const DecodeParams& p, int b, int hk, int n,
                                           int64_t sb, int64_t sh, int64_t ss, int64_t sp) {
  if constexpr (kPaged) {
    const int page = p.page_table[static_cast<int64_t>(b) * p.pps + n / p.page_size];
    return hk * sh + page * sp + (n % p.page_size) * ss;
  } else {
    return b * sb + hk * sh + static_cast<int64_t>(n) * ss;
  }
}

// T: q and output type; KV: the cache's element type (T, or int8 / e4m3);
// kCap: the soft cap (D1 with a cap; a template flag, so the kernels
// without it are unchanged: a runtime branch here cost D1 / B5 up to 12 %).
template <typename T, typename KV, int D, int GMAX, bool kPaged, bool kCap = false>
__global__ void __launch_bounds__(kDecodeThreads) decode_partials_kernel(const DecodeArgs<KV> p) {
  constexpr bool kQuant = sizeof(KV) == 1;
  constexpr int kTpk = D / 8;             // threads per key row
  constexpr int kSlots = kDecodeThreads / kTpk;  // key rows in flight per pass
  __shared__ float s_p[GMAX][kDecodeTile];       // scores, then probabilities
  __shared__ float s_red[kSlots][GMAX][D];  // cross-slot reduction of acc
  __shared__ float s_m[GMAX], s_l[GMAX], s_alpha[GMAX];
  __shared__ float s_vs[kDecodeTile];  // quantized: the tile's V scales (0 past its end)

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = p.group;
  const int64_t part = (static_cast<int64_t>(b) * p.hkv + hk) * p.num_splits + split;
  float* acc_out = p.acc + part * G * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const int len = min(max(p.lengths[b], 0), p.capacity);
  const int lo = p.window > 0 ? max(0, len - p.window) : 0;  // first visible key
  // Contiguous splits are fixed `chunk`-key ranges of the capacity, cut to
  // the visible range [lo, len). Paged splits cut each row's own visible
  // range, so every split of a long row has work whatever the pool's
  // capacity and the window.
  int start, end;
  if constexpr (kPaged) {
    const int chunk = (len - lo + p.num_splits - 1) / p.num_splits;
    start = lo + split * chunk;
    end = min(start + chunk, len);
  } else {
    start = max(split * p.chunk, lo);
    end = min((split + 1) * p.chunk, len);
  }
  if (start >= end) {  // dead split: contributes weight 0 in the combine
    for (int i = tid; i < G * D; i += kDecodeThreads) acc_out[i] = 0.f;
    if (tid < G) {
      p.m[part * G + tid] = -INFINITY;
      p.l[part * G + tid] = 0.f;
    }
    return;
  }

  const int slot = tid / kTpk, d0 = (tid % kTpk) * 8;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb;
  const KV* k = static_cast<const KV*>(p.k);
  const KV* v = static_cast<const KV*>(p.v);

  float qr[GMAX][8];  // this thread's 8 head-dim entries of each query row
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G) {
      uint4 raw = *reinterpret_cast<const uint4*>(q + (hk * G + g) * p.q_sh + d0);
      unpack8<T>(raw, qr[g]);
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[g][e] *= p.scale_log2;
    }
  }
  float acc[GMAX][8];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  if (tid < G) {
    s_m[tid] = -INFINITY;
    s_l[tid] = 0.f;
  }

  for (int tile0 = start; tile0 < end; tile0 += kDecodeTile) {
    const int tn = min(kDecodeTile, end - tile0);
    __syncthreads();  // s_p is free, s_m/s_l are visible
    // Scores: the kTpk threads of a slot split one key row and reduce.
    for (int kk = slot; kk < kDecodeTile; kk += kSlots) {
      float sc[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) sc[g] = 0.f;
      if (kk < tn) {
        float kf[8];
        const int64_t row = key_row<kPaged>(p, b, hk, tile0 + kk, p.k_sb, p.k_sh, p.k_ss, p.k_sp);
        load8(k + row + d0, kf);
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
#pragma unroll
          for (int e = 0; e < 8; ++e) sc[g] += qr[g][e] * kf[e];
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
#pragma unroll
        for (int off = kTpk / 2; off > 0; off >>= 1)
          sc[g] += __shfl_xor_sync(0xffffffffu, sc[g], off);
      if (tid % kTpk == 0) {
        if constexpr (kQuant) {
          // The row's scales are loaded only for a live key: a scale at or
          // past the length may be NaN, and 0 * NaN is NaN.
          float ks = 0.f, vs = 0.f;
          if (kk < tn) {
            const KVScales& c = p.scales;
            ks = c.k[key_row<kPaged>(p, b, hk, tile0 + kk, c.k_sb, c.k_sh, 1, c.k_sp)];
            vs = c.v[key_row<kPaged>(p, b, hk, tile0 + kk, c.v_sb, c.v_sh, 1, c.v_sp)];
          }
          s_vs[kk] = vs;
#pragma unroll
          for (int g = 0; g < GMAX; ++g)
            if (g < G) s_p[g][kk] = kk < tn ? sc[g] * ks : -INFINITY;
        } else {
          if constexpr (kCap) {
#pragma unroll
            for (int g = 0; g < GMAX; ++g) sc[g] = p.softcap_log2 * tanhf(sc[g] * p.softcap_rcp);
          }
#pragma unroll
          for (int g = 0; g < GMAX; ++g)
            if (g < G) s_p[g][kk] = kk < tn ? sc[g] : -INFINITY;
        }
      }
    }
    __syncthreads();
    // Online softmax update, one warp per query row of the group.
    for (int g = warp; g < G; g += kDecodeThreads / 32) {
      const float x0 = s_p[g][lane], x1 = s_p[g][lane + 32];
      const float m_old = s_m[g];
      // The tile holds at least one live key, so m_new is finite.
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      const float p0 = exp2f(x0 - m_new), p1 = exp2f(x1 - m_new);
      const float sum = warp_sum(p0 + p1);
      if constexpr (kQuant) {  // V's scale folds into P; the sum l keeps P
        s_p[g][lane] = p0 * s_vs[lane];
        s_p[g][lane + 32] = p1 * s_vs[lane + 32];
      } else {
        s_p[g][lane] = p0;
        s_p[g][lane + 32] = p1;
      }
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_new);  // 0 on the first tile
        s_alpha[g] = alpha;
        s_m[g] = m_new;
        s_l[g] = s_l[g] * alpha + sum;
      }
    }
    __syncthreads();
    // acc = acc * alpha + P V over this thread's keys and head-dim entries.
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
        const float a = s_alpha[g];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] *= a;
      }
    }
    for (int kk = slot; kk < tn; kk += kSlots) {
      float vf[8];
      const int64_t row = key_row<kPaged>(p, b, hk, tile0 + kk, p.v_sb, p.v_sh, p.v_ss, p.v_sp);
      load8(v + row + d0, vf);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {
          const float pr = s_p[g][kk];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] += pr * vf[e];
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < GMAX; ++g)
    if (g < G)
#pragma unroll
      for (int e = 0; e < 8; ++e) s_red[slot][g][d0 + e] = acc[g][e];
  __syncthreads();
  for (int i = tid; i < G * D; i += kDecodeThreads) {
    const int g = i / D, d = i % D;
    float sum = 0.f;
#pragma unroll
    for (int sl = 0; sl < kSlots; ++sl) sum += s_red[sl][g][d];
    acc_out[i] = sum;
  }
  if (tid < G) {
    p.m[part * G + tid] = s_m[tid];
    p.l[part * G + tid] = s_l[tid];
  }
}

template <typename T, typename KV, int D, int GMAX, bool kPaged, bool kCap>
int launch_partials(const DecodeArgs<KV>& p, int batch, cudaStream_t stream) {
  const dim3 grid(p.num_splits, p.hkv, batch);
  decode_partials_kernel<T, KV, D, GMAX, kPaged, kCap><<<grid, kDecodeThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, typename KV, int D, bool kPaged, bool kCap = false>
int dispatch_group(const DecodeArgs<KV>& p, int batch, cudaStream_t stream) {
  if (p.group <= 1) return launch_partials<T, KV, D, 1, kPaged, kCap>(p, batch, stream);
  if (p.group <= 2) return launch_partials<T, KV, D, 2, kPaged, kCap>(p, batch, stream);
  if (p.group <= 4) return launch_partials<T, KV, D, 4, kPaged, kCap>(p, batch, stream);
  if (p.group <= 8) return launch_partials<T, KV, D, 8, kPaged, kCap>(p, batch, stream);
  return cudaErrorInvalidValue;
}

// A cache of q's own type (D1), head dims 64, 128 and 256; a soft cap
// (softcap_log2 > 0) launches the kCap instantiation.
template <bool kPaged, bool kCap = false>
int dispatch_partials(const DecodeParams& p, int batch, int d, int dtype, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if constexpr (!kCap)
    if (p.softcap_log2 > 0.f) return dispatch_partials<kPaged, true>(p, batch, d, dtype, s);
  if (dtype == kBF16 && d == 64) return dispatch_group<bf16, bf16, 64, kPaged, kCap>(p, batch, s);
  if (dtype == kBF16 && d == 128) return dispatch_group<bf16, bf16, 128, kPaged, kCap>(p, batch, s);
  if (dtype == kBF16 && d == 256) return dispatch_group<bf16, bf16, 256, kPaged, kCap>(p, batch, s);
  if (dtype == kF16 && d == 64) return dispatch_group<__half, __half, 64, kPaged, kCap>(p, batch, s);
  if (dtype == kF16 && d == 128) return dispatch_group<__half, __half, 128, kPaged, kCap>(p, batch, s);
  if (dtype == kF16 && d == 256) return dispatch_group<__half, __half, 256, kPaged, kCap>(p, batch, s);
  return cudaErrorInvalidValue;
}

// A quantized cache (B7): q and output bf16 / f16, values int8 / e4m3.
template <typename T, bool kPaged>
int dispatch_quant_values(const QuantDecodeParams& p, int batch, int d, int kv_dtype,
                          cudaStream_t s) {
  if (kv_dtype == kInt8 && d == 64) return dispatch_group<T, int8_t, 64, kPaged>(p, batch, s);
  if (kv_dtype == kInt8 && d == 128) return dispatch_group<T, int8_t, 128, kPaged>(p, batch, s);
  if (kv_dtype == kE4M3 && d == 64) return dispatch_group<T, e4m3, 64, kPaged>(p, batch, s);
  if (kv_dtype == kE4M3 && d == 128) return dispatch_group<T, e4m3, 128, kPaged>(p, batch, s);
  return cudaErrorInvalidValue;
}

template <bool kPaged>
int dispatch_partials_quant(const QuantDecodeParams& p, int batch, int d, int dtype,
                            int kv_dtype, cudaStream_t s) {
  if (dtype == kBF16) return dispatch_quant_values<__nv_bfloat16, kPaged>(p, batch, d, kv_dtype, s);
  if (dtype == kF16) return dispatch_quant_values<__half, kPaged>(p, batch, d, kv_dtype, s);
  return cudaErrorInvalidValue;
}

}  // namespace fact
