// Tiled attention forward for many query rows, shared by kernel B4
// (chunked extend over a contiguous cache, flash_chunked.cu) and kernel B12
// (a packed ragged batch, flash_varlen.cu): O = softmax(Q K^T * scale +
// mask) V. (The prefill kernels P and B2 and the paged extends B6 and B9
// have a body of their own, built for Hopper's wgmma and TMA:
// attention_wgmma.cuh.)
//
// Key n is visible from query row m iff n < skv, when causal
// n <= m + offset, and with a sliding window W (a runtime argument, 0 for
// none) n > m + offset - W, i.e. the W keys ending at the row's own global
// position. kRowOffsets: where offset and skv come from. B4 reads
// offset = q_offset[b] and skv = kv_length[b], clamped to the cache's
// capacity, from device memory (top-left causality in global positions,
// `col <= q_offset + row`); without it they come from the shapes
// (offset = Skv - Sq, bottom-right alignment; skv = Skv).
// B12 (kVarlen) runs one batch row of packed tokens:
// key n is visible from row m iff kv_seg[n] == q_seg[m], when causal
// kv_pos[n] <= q_bound[m], and with a window kv_pos[n] > q_bound[m] - W.
// Each block finds its live key range from the sorted segment ids on the
// device (binary searches: the first key of its first row's segment, past
// that row's window, to the last key of its last row's segment, cut at
// that row's causal bound), walks only those keys, and masks every tile
// with the segment ids and positions staged in shared memory.
// Exact online softmax in fp32 (the `stable="strict"` semantics, no lazy
// max), deferred 1/l with the l == 0 -> 0 guard, so rows with no visible
// key (and whole rows of kv_length 0) emit exact zeros. GQA: q head h
// reads kv head h / (Hq / Hkv), the head-repeat order of the reference.
// Head dims 64 and 128; neither kernel takes the soft cap (ROADMAP.md A10b).
//
// What bounds it on the H100: at extend lengths the work is tensor-core
// operations (4 * Sq * Skv * D per head, about half of it under the causal
// mask), far above the card's ~295 operations per byte, so the bound is the
// bf16 tensor-core rate. Design: one block of 4 warps per (64 query rows,
// q head, batch row); each warp owns 16 rows. QK^T and PV run on mma.sync
// m16n8k16 with fp32 accumulators; S stays in registers and is reused as
// the A operand of PV (the accumulator layout of m16n8k16 is its A layout),
// so scores never touch shared memory. KV tiles past the causal diagonal
// are skipped (a tile walk stops at min(skv, last row + offset + 1)), and
// with a window so are the tiles wholly below it (the walk starts at the
// tile holding the block's first visible key, m0 + offset - W + 1), so a
// windowed block does O(64 * W) work, not O(64 * Skv). Only tiles that
// straddle the diagonal, the window's lower edge or the ragged end are
// masked. Rows at or past skv, and rows below the block's first visible
// key, load as zeros and are never read. Blocks with the longest causal
// rows are launched first. Not yet done (later work, as attention_wgmma.cuh
// does it for P / B2 / B6 / B9): TMA pipelining, wgmma, V read MN-major in
// place of the V^T copy (whose 2-byte stores conflict in one bank), loading
// each K/V tile once per GQA group.
#pragma once

#include <climits>

#include "common.cuh"

namespace fact {

struct FwdParams {
  const void* q;
  const void* k;  // B4: [B, Hkv, Skv, D]; B12: [Tkv, Hkv, D] as batch 1
  const void* v;
  void* o;  // [B, Hq, Sq, D] contiguous
  int64_t q_sb, q_sh, q_ss;  // element strides; the head dim is contiguous
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int hq, group, sq, skv;  // skv: B4's capacity C, B12's packed key count
  float scale_log2;  // softmax_scale * log2(e): softmax runs in base 2
  int causal;
  int window;  // sliding window W > 0, or 0 for none
  const int* q_offset;    // B4: [B] int32 global position of q row 0
  const int* kv_length;   // B4: [B] int32 keys visible to the chunk (0 = inactive)
  // B12: int32 metadata of the packed tokens (sq = Tq, skv = Tkv, batch 1);
  // segment ids non-decreasing, kv_pos counting from 0 at a segment's first key.
  const int* q_seg;
  const int* q_bound;
  const int* kv_seg;
  const int* kv_pos;
};

constexpr int kBlockM = 64;   // query rows per block (16 per warp)
constexpr int kBlockN = 64;   // keys per tile
constexpr int kFwdThreads = 128;

// kTileMeta: two 4-byte words per key of a tile (B12's segment ids and
// positions).
template <typename T, int D, bool kTileMeta>
constexpr int fwd_smem_bytes() {
  return (kBlockM * (D + 8) + kBlockN * (D + 8) + D * (kBlockN + 8)) * static_cast<int>(sizeof(T))
         + (kTileMeta ? 2 * kBlockN * static_cast<int>(sizeof(float)) : 0);
}

// First index in [0, n) whose value is >= x (kPast: > x), n if none; `a`
// non-decreasing.
template <bool kPast>
__device__ __forceinline__ int search(const int* a, int n, int x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (kPast ? a[mid] <= x : a[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// T: q, K, V, the output and the shared tiles.
template <typename T, int D, bool kRowOffsets, bool kVarlen>
__device__ __forceinline__ void attention_fwd_body(const FwdParams p) {
  static_assert(!kVarlen || !kRowOffsets, "a packed batch has no per-row offsets");
  constexpr int kRow = D + 8;          // smem row stride of Q and K (bank spread)
  constexpr int kVtRow = kBlockN + 8;  // smem row stride of V^T
  constexpr int kChunks = D / 8;       // chunks of 8 elements per row
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + kBlockM * kRow;
  T* sVt = sK + kBlockN * kRow;
  int* sKseg = reinterpret_cast<int*>(sVt + D * kVtRow);  // varlen: the tile's
  int* sKpos = sKseg + kBlockN;                           // segment ids, positions

  const int m_block = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const int m0 = m_block * kBlockM;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* o = static_cast<T*>(p.o) + (static_cast<int64_t>(b) * p.hq + h) * p.sq * D;
  int skv, offset;
  if constexpr (kRowOffsets) {
    skv = min(max(p.kv_length[b], 0), p.skv);
    offset = p.q_offset[b];
  } else {
    skv = p.skv;
    offset = p.skv - p.sq;
  }

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int wr = warp * 16;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int c = tid; c < kBlockM * kChunks; c += kFwdThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    uint4 val = zero;
    if (m0 + r < p.sq)
      val = *reinterpret_cast<const uint4*>(q + static_cast<int64_t>(m0 + r) * p.q_ss + col);
    *reinterpret_cast<uint4*>(sQ + r * kRow + col) = val;
  }
  __syncthreads();
  // This warp's 16 query rows as A fragments, held in registers.
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const T* base = sQ + (wr + g) * kRow + kk * 16 + 2 * t;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(base);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kRow);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(base + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kRow + 8);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] = 0.f;
  // Thread-local statistics of rows row0 (fragment elements 0,1) and row1
  // (elements 2,3); the running sum is reduced across the quad at the end.
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};
  const int row0 = m0 + wr + g, row1 = row0 + 8;
  int row_seg[2] = {0, 0}, row_bound[2] = {0, 0};  // varlen: each row's segment and bound
  if constexpr (kVarlen) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? row1 : row0;
      row_seg[r] = row < p.sq ? p.q_seg[row] : INT_MIN;  // rows past Tq are never stored
      row_bound[r] = row < p.sq ? p.q_bound[row] : -1;
    }
  }

  // Keys [n_lo, n_end) hold every key a row of the block may see; skv
  // bounds the loads and the mask.
  int n_lo, n_end;
  if constexpr (kVarlen) {  // B12: skv becomes the end of the block's live range
    const int last = min(m0 + kBlockM, p.sq) - 1;
    const int seg_lo = p.q_seg[m0], seg_hi = p.q_seg[last];
    n_lo = search<false>(p.kv_seg, p.skv, seg_lo);  // first key of the first row's segment
    skv = search<true>(p.kv_seg, p.skv, seg_hi);    // past the last key of the last row's
    if (p.causal)  // the last row sees its segment's keys up to position q_bound[last]
      skv = min(skv, search<false>(p.kv_seg, p.skv, seg_hi) + max(p.q_bound[last] + 1, 0));
    if (p.window > 0 && n_lo < p.skv && p.kv_seg[n_lo] == seg_lo)
      n_lo += max(0, p.q_bound[m0] - p.window + 1);  // below the first row's window
    n_end = skv;
  } else {
    n_end = skv;
    if (p.causal) n_end = min(n_end, m0 + kBlockM + offset);  // skip tiles past the diagonal
    // The block's first visible key: row m0's window start (none below it).
    n_lo = p.window > 0 ? max(0, m0 + offset - p.window + 1) : 0;
  }
  // Skip tiles wholly below the window (B12 starts at its first live key).
  const int n_begin = kVarlen ? n_lo : n_lo / kBlockN * kBlockN;

  for (int n0 = n_begin; n0 < n_end; n0 += kBlockN) {
    __syncthreads();  // every warp is done with the previous tile
    for (int c = tid; c < kBlockN * kChunks; c += kFwdThreads) {
      const int r = c / kChunks, col = (c % kChunks) * 8;
      const int n = n0 + r;
      uint4 kv = zero, vv = zero;  // rows no query of the block sees load as zeros
      if (n >= n_lo && n < skv) {
        kv = *reinterpret_cast<const uint4*>(k + static_cast<int64_t>(n) * p.k_ss + col);
        vv = *reinterpret_cast<const uint4*>(v + static_cast<int64_t>(n) * p.v_ss + col);
      }
      *reinterpret_cast<uint4*>(sK + r * kRow + col) = kv;
      const T* ve = reinterpret_cast<const T*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) sVt[(col + e) * kVtRow + r] = ve[e];
    }
    if constexpr (kVarlen) {
      for (int r = tid; r < kBlockN; r += kFwdThreads) {
        const int n = n0 + r;
        sKseg[r] = n < skv ? p.kv_seg[n] : INT_MAX;
        sKpos[r] = n < skv ? p.kv_pos[n] : INT_MAX;
      }
    }
    __syncthreads();

    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        const T* base = sK + (nt * 8 + g) * kRow + kk * 16 + 2 * t;
        Elem<T>::mma(s[nt], qf[kk], *reinterpret_cast<const uint32_t*>(base),
                     *reinterpret_cast<const uint32_t*>(base + 8));
      }
    }

    // Only tiles straddling the ragged end, the diagonal or the lower
    // window edge of the block's last row need the mask.
    const bool edge = kVarlen || n0 + kBlockN > skv || (p.causal && n0 + kBlockN - 1 > m0 + offset) ||
                      (p.window > 0 && n0 <= m0 + kBlockM - 1 + offset - p.window);
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[nt][i] * p.scale_log2;  // scaled here, in the masking pass
        if (edge) {
          const int col = n0 + nt * 8 + 2 * t + (i & 1);
          bool masked;
          if constexpr (kVarlen) {
            const int kseg = sKseg[col - n0], kpos = sKpos[col - n0];
            const int bound = row_bound[i >> 1];
            masked = kseg != row_seg[i >> 1] || col >= skv || (p.causal && kpos > bound) ||
                     (p.window > 0 && kpos <= bound - p.window);
          } else {
            const int row = i < 2 ? row0 : row1;
            masked = col >= skv || (p.causal && col > row + offset) ||
                     (p.window > 0 && col <= row + offset - p.window);
          }
          if (masked) x = -INFINITY;
        }
        s[nt][i] = x;
      }
    }

    float m_use[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(row_max[r], mx);
      // A row with no visible key yet keeps max -inf (as a windowed row
      // does in the tiles below its window); referencing it to 0 makes
      // exp2(-inf - ref) exactly 0 and never -inf - -inf = NaN.
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = exp2f(row_max[r] - m_use[r]);
      row_max[r] = m_new;
    }
    float tile_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[nt][i] = exp2f(s[nt][i] - m_use[i >> 1]);
        tile_sum[i >> 1] += s[nt][i];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) row_sum[r] = row_sum[r] * alpha[r] + tile_sum[r];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // O += P V with P taken from the score registers.
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t a[4];
      a[0] = Elem<T>::pack(s[2 * kk][0], s[2 * kk][1]);
      a[1] = Elem<T>::pack(s[2 * kk][2], s[2 * kk][3]);
      a[2] = Elem<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = Elem<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const T* base = sVt + (dt * 8 + g) * kVtRow + kk * 16 + 2 * t;
        Elem<T>::mma(acc[dt], a, *reinterpret_cast<const uint32_t*>(base),
                     *reinterpret_cast<const uint32_t*>(base + 8));
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = row_sum[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = l > 0.f ? 1.f / l : 0.f;  // no visible key -> exact zero row
  }
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row0 < p.sq)
      *reinterpret_cast<uint32_t*>(o + static_cast<int64_t>(row0) * D + col) =
          Elem<T>::pack(acc[dt][0] * inv[0], acc[dt][1] * inv[0]);
    if (row1 < p.sq)
      *reinterpret_cast<uint32_t*>(o + static_cast<int64_t>(row1) * D + col) =
          Elem<T>::pack(acc[dt][2] * inv[1], acc[dt][3] * inv[1]);
  }
}

template <typename T, int D, bool kRowOffsets, bool kVarlen>
__global__ void __launch_bounds__(kFwdThreads) attention_fwd_kernel(const FwdParams p) {
  attention_fwd_body<T, D, kRowOffsets, kVarlen>(p);
}

template <typename T, int D, bool kRowOffsets, bool kVarlen>
int launch_attention_fwd(const FwdParams& p, int batch, cudaStream_t stream) {
  constexpr int kSmem = fwd_smem_bytes<T, D, kVarlen>();
  void (*kernel)(const FwdParams) = attention_fwd_kernel<T, D, kRowOffsets, kVarlen>;
  static bool configured = false;  // above 48 KB needs an explicit opt-in
  if (!configured) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((p.sq + kBlockM - 1) / kBlockM, p.hq, batch);
  kernel<<<grid, kFwdThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kRowOffsets, bool kVarlen = false>
int dispatch_attention_fwd(const FwdParams& p, int batch, int d, int dtype, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  using h16 = __half;
  constexpr bool R = kRowOffsets, V = kVarlen;
  if (dtype == kBF16 && d == 64) return launch_attention_fwd<bf16, 64, R, V>(p, batch, s);
  if (dtype == kBF16 && d == 128) return launch_attention_fwd<bf16, 128, R, V>(p, batch, s);
  if (dtype == kF16 && d == 64) return launch_attention_fwd<h16, 64, R, V>(p, batch, s);
  if (dtype == kF16 && d == 128) return launch_attention_fwd<h16, 128, R, V>(p, batch, s);
  return cudaErrorInvalidValue;
}

}  // namespace fact
