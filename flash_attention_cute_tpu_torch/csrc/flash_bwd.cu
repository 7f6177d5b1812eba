// Attention backward from the saved log-sum-exp (FlashAttention-2
// recompute): kernels B13a (dK, dV) and B13b (dQ). Natural units, with
// s = scale * q.k and p = exp(s - lse) = exp2(s * log2(e) - lse2):
//
//   delta_m = sum_d dO_md O_md              (PyTorch, ops/flash_bwd.py)
//   dV_n    = sum_m p_mn dO_m
//   dP_mn   = dO_m . V_n
//   dS_mn   = p_mn (dP_mn - delta_m)
//   dQ_m    = scale * sum_n dS_mn K_n
//   dK_n    = scale * sum_m dS_mn Q_m
//
// lse2 is the forward's residual (flash_fwd.cu, `return_lse`): m + log2(l)
// of the base-2 scores, +inf on a row with no visible key, so p is exactly
// 0 there. Key n is visible from row m under the forward's mask: n < Skv,
// when causal n <= m + (Skv - Sq) (bottom-right), with a window W
// n > m + (Skv - Sq) - W. GQA: q head h reads kv head h / (Hq / Hkv), and
// dK, dV sum over the group.
//
// Replaces the TPU kernels flash_attention_cute_tpu/ops/flash_bwd.py
// `_flash_bwd_dkv_kernel` (:84, pallas_call at :358) and
// `_flash_bwd_dq_kernel` (:173, pallas_call at :423). They compute what
// those kernels compute, not their block structure: the TPU kernels carry
// dK/dV (dQ^T) in VMEM scratch across a sequential q (kv) grid axis, keep
// the transposed S^T orientation for lane-vector statistics, and fold
// scale * log2(e) into a pre-rounded q. Here a block loops over its tiles
// itself, the scores are scaled in fp32 after the product (as the forward
// does), and dK is scaled once at the store.
//
// What bounds them on the H100: tensor-core operations. Per visible
// (row, key) pair and q head, B13a runs four products of depth D (S^T,
// dP^T, dV, dK: 8 D operations) and B13b three (S, dP, dQ: 6 D), far
// above the card's ~295 operations per byte at training lengths. Design
// (mma.sync m16n8k16, fp32 accumulators, bf16 / f16 operands; simple and
// right first, no pipelining):
//   * B13a: one block of 8 warps per (64 keys, kv head, batch row). It
//     holds the K and V tile in shared memory and walks the group's q heads
//     and, for each, the 64-row q tiles between the causal edge and the
//     window's far edge (the TPU kernel's `should_run`). Keys are the rows
//     of the products (S^T = K Q^T, dP^T = V dO^T), so P^T and dS^T come
//     out in the accumulator layout, which is the A layout of dV += P^T dO
//     and dK += dS^T Q. The dK and dV accumulators of 64 keys x D would be
//     128 fp32 registers a thread over 4 warps at D 128; instead warp w
//     owns keys 16 (w % 4).. and, in the first half of a tile, query
//     columns 32 (w / 4).. of S^T and dP^T, whose P^T and dS^T go through
//     shared memory (bf16, as the forward rounds P before PV), and in the
//     second half D / 2 columns of dK and dV: 64 accumulators a thread.
//     The group is folded inside the block: no atomics, deterministic.
//   * B13b: one block of 4 warps per (64 q rows, q head, batch row), each
//     warp 16 rows, walking the kv tiles from the window's near edge to the
//     causal edge: S = Q K^T and dP = dO V^T in registers, dS in the
//     accumulator layout is the A operand of dQ += dS K, whose B operand is
//     a transposed K tile in shared memory (the forward's V^T).
// Q, dO and K^T tiles are read from shared memory per product rather than
// held as fragments, to stay clear of register spills. Later work: wgmma,
// TMA / cp.async pipelining, ldmatrix.trans in place of transposed copies.
#include "common.cuh"

namespace fact {

struct BwdParams {
  const void* q;     // [B, Hq, Sq, D]
  const void* k;     // [B, Hkv, Skv, D]
  const void* v;
  const void* dout;  // [B, Hq, Sq, D]
  const float* lse;    // [B, Hq, Sq] contiguous, log2 units
  const float* delta;  // [B, Hq, Sq] contiguous
  void* out0;  // B13a: dK [B, Hkv, Skv, D]; B13b: dQ [B, Hq, Sq, D] (contiguous)
  void* out1;  // B13a: dV [B, Hkv, Skv, D]
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;  // o_: dO
  int hq, group, sq, skv;
  float scale_log2;  // softmax_scale * log2(e)
  float scale;
  int causal;
  int window;  // W > 0, or 0 for none
};

constexpr int kTile = 64;  // rows and keys of a tile
constexpr int kTRow = kTile + 8;  // smem row stride of a transposed tile
constexpr int kDkvThreads = 256;
constexpr int kDqThreads = 128;

__device__ __forceinline__ bool visible(const BwdParams& p, int m, int n, int offset) {
  return n < p.skv && m < p.sq && (!p.causal || n <= m + offset) &&
         (p.window <= 0 || n > m + offset - p.window);
}

// Rows [r0, r0 + 64) of a [rows, D] matrix (row stride rs, head dim
// contiguous) into shared memory, rows at or past `rows` as zeros: row-major
// with stride D + 8 (kRowMajor) and / or transposed [D][kTRow].
template <typename T, int D, int kThreads, bool kRowMajor, bool kTransposed>
__device__ __forceinline__ void load_tile(const T* src, int64_t rs, int r0, int rows, T* dst,
                                          T* dst_t) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < kTile * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < rows) val = *reinterpret_cast<const uint4*>(src + static_cast<int64_t>(r0 + r) * rs + col);
    if constexpr (kRowMajor) *reinterpret_cast<uint4*>(dst + r * (D + 8) + col) = val;
    if constexpr (kTransposed) {
      const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) dst_t[(col + i) * kTRow + r] = e[i];
    }
  }
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragment of m16n8k16 from a row-major tile: `base` points at
// element (row g, column 2 t) of the 16 x 16 sub-tile, `ld` is the stride.
template <typename T>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const T* base, int ld) {
  a[0] = ld32(base);
  a[1] = ld32(base + 8 * ld);
  a[2] = ld32(base + 8);
  a[3] = ld32(base + 8 * ld + 8);
}

template <typename T, int D>
constexpr int dkv_smem_bytes() {
  return (4 * kTile * (D + 8) + 2 * D * kTRow + 2 * kTile * kTRow) * static_cast<int>(sizeof(T)) +
         2 * kTile * static_cast<int>(sizeof(float));
}

// B13a: dK, dV of 64 keys of one kv head, summed over its q-head group.
template <typename T, int D>
__global__ void __launch_bounds__(kDkvThreads) flash_bwd_dkv_kernel(const BwdParams p) {
  constexpr int kRow = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kTile * kRow;
  T* sQ = sV + kTile * kRow;
  T* sdO = sQ + kTile * kRow;
  T* sQt = sdO + kTile * kRow;
  T* sdOt = sQt + D * kTRow;
  T* sP = sdOt + D * kTRow;  // P^T [64 keys][64 rows]
  T* sdS = sP + kTile * kTRow;
  float* sLse = reinterpret_cast<float*>(sdS + kTile * kTRow);
  float* sDelta = sLse + kTile;

  const int n0 = blockIdx.x * kTile;  // the keys with the most causal rows first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int offset = p.skv - p.sq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int kr = (warp & 3) * 16;         // this warp's 16 keys
  const int half = warp >> 2;             // its 32 q columns, then its D / 2 columns

  load_tile<T, D, kDkvThreads, true, false>(
      static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh, p.k_ss, n0, p.skv, sK, nullptr);
  load_tile<T, D, kDkvThreads, true, false>(
      static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh, p.v_ss, n0, p.skv, sV, nullptr);

  // The q rows that see a key of this tile: from the causal edge (row
  // n0 - offset sees key n0) to the window's far edge (the last key is
  // visible up to row n_last - offset + W - 1).
  int m_begin = p.causal ? max(0, n0 - offset) : 0;
  int m_end = p.sq;
  if (p.window > 0) m_end = min(m_end, min(n0 + kTile, p.skv) - 1 - offset + p.window);
  m_begin = m_begin / kTile * kTile;

  float dk[D / 16][4], dv[D / 16][4];
#pragma unroll
  for (int dt = 0; dt < D / 16; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[dt][i] = dv[dt][i] = 0.f;

  for (int gi = 0; gi < p.group; ++gi) {
    const int h = hk * p.group + gi;
    const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* dout = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
    const float* lse = p.lse + (static_cast<int64_t>(b) * p.hq + h) * p.sq;
    const float* delta = p.delta + (static_cast<int64_t>(b) * p.hq + h) * p.sq;
    for (int m0 = m_begin; m0 < m_end; m0 += kTile) {
      __syncthreads();  // every warp is done with the previous tile
      load_tile<T, D, kDkvThreads, true, true>(q, p.q_ss, m0, p.sq, sQ, sQt);
      load_tile<T, D, kDkvThreads, true, true>(dout, p.o_ss, m0, p.sq, sdO, sdOt);
      if (tid < kTile) {
        const int m = m0 + tid;
        sLse[tid] = m < p.sq ? lse[m] : INFINITY;  // a padded row has p = 0
        sDelta[tid] = m < p.sq ? delta[m] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 32 q columns.
      float s[4][4], dp[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4], av[4];
        load_a(ak, sK + (kr + g) * kRow + kk * 16 + 2 * t, kRow);
        load_a(av, sV + (kr + g) * kRow + kk * 16 + 2 * t, kRow);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int r = (half * 32 + nt * 8 + g) * kRow + kk * 16 + 2 * t;
          Elem<T>::mma(s[nt], ak, ld32(sQ + r), ld32(sQ + r + 8));
          Elem<T>::mma(dp[nt], av, ld32(sdO + r), ld32(sdO + r + 8));
        }
      }
      // P^T = exp2(S^T * scale_log2 - lse) on visible pairs, dS^T = P^T (dP^T - delta).
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int key = kr + g + 8 * j;
          const int c = half * 32 + nt * 8 + 2 * t;  // local q row of elements 2j, 2j + 1
          float pv[2], dsv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 2 * j + e;
            const float pr = visible(p, m0 + c + e, n0 + key, offset)
                                 ? exp2f(s[nt][i] * p.scale_log2 - sLse[c + e]) : 0.f;
            pv[e] = pr;
            dsv[e] = pr * (dp[nt][i] - sDelta[c + e]);
          }
          *reinterpret_cast<uint32_t*>(sP + key * kTRow + c) = Elem<T>::pack(pv[0], pv[1]);
          *reinterpret_cast<uint32_t*>(sdS + key * kTRow + c) = Elem<T>::pack(dsv[0], dsv[1]);
        }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q over the tile's 64 rows: this warp's
      // 16 keys x D / 2 columns.
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t ap[4], as[4];
        load_a(ap, sP + (kr + g) * kTRow + kk * 16 + 2 * t, kTRow);
        load_a(as, sdS + (kr + g) * kTRow + kk * 16 + 2 * t, kTRow);
#pragma unroll
        for (int dt = 0; dt < D / 16; ++dt) {
          const int r = (half * (D / 2) + dt * 8 + g) * kTRow + kk * 16 + 2 * t;
          Elem<T>::mma(dv[dt], ap, ld32(sdOt + r), ld32(sdOt + r + 8));
          Elem<T>::mma(dk[dt], as, ld32(sQt + r), ld32(sQt + r + 8));
        }
      }
    }
  }

  const int64_t base = (static_cast<int64_t>(b) * (p.hq / p.group) + hk) * p.skv * D;
  T* dkp = static_cast<T*>(p.out0) + base;
  T* dvp = static_cast<T*>(p.out1) + base;
#pragma unroll
  for (int dt = 0; dt < D / 16; ++dt) {
    const int col = half * (D / 2) + dt * 8 + 2 * t;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int key = n0 + kr + g + 8 * j;
      if (key < p.skv) {
        const int64_t at = static_cast<int64_t>(key) * D + col;
        *reinterpret_cast<uint32_t*>(dkp + at) =
            Elem<T>::pack(dk[dt][2 * j] * p.scale, dk[dt][2 * j + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(dvp + at) = Elem<T>::pack(dv[dt][2 * j], dv[dt][2 * j + 1]);
      }
    }
  }
}

template <typename T, int D>
constexpr int dq_smem_bytes() {
  return (4 * kTile * (D + 8) + D * kTRow) * static_cast<int>(sizeof(T));
}

// B13b: dQ of 64 rows of one q head.
template <typename T, int D>
__global__ void __launch_bounds__(kDqThreads) flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int kRow = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sdO = sQ + kTile * kRow;
  T* sK = sdO + kTile * kRow;
  T* sV = sK + kTile * kRow;
  T* sKt = sV + kTile * kRow;  // K^T [D][64 keys]

  const int m0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // the longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.group;
  const int offset = p.skv - p.sq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const int row0 = m0 + wr + g, row1 = row0 + 8;

  load_tile<T, D, kDqThreads, true, false>(
      static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_ss, m0, p.sq, sQ, nullptr);
  load_tile<T, D, kDqThreads, true, false>(
      static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh, p.o_ss, m0, p.sq, sdO, nullptr);
  const float* lse = p.lse + (static_cast<int64_t>(b) * p.hq + h) * p.sq;
  const float* delta = p.delta + (static_cast<int64_t>(b) * p.hq + h) * p.sq;
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    row_lse[r] = row < p.sq ? lse[row] : INFINITY;
    row_delta[r] = row < p.sq ? delta[row] : 0.f;
  }
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  // Keys from the window's near edge (row m0's first visible key) to the
  // causal edge (the last row's last).
  int n_end = p.skv;
  if (p.causal) n_end = min(n_end, m0 + kTile + offset);
  const int n_lo = p.window > 0 ? max(0, m0 + offset - p.window + 1) : 0;

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] = 0.f;

  for (int n0 = n_lo / kTile * kTile; n0 < n_end; n0 += kTile) {
    __syncthreads();  // every warp is done with the previous tile (and Q, dO are in)
    load_tile<T, D, kDqThreads, true, true>(k, p.k_ss, n0, p.skv, sK, sKt);
    load_tile<T, D, kDqThreads, true, false>(v, p.v_ss, n0, p.skv, sV, nullptr);
    __syncthreads();

    float s[kTile / 8][4], dp[kTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ao[4];
      load_a(aq, sQ + (wr + g) * kRow + kk * 16 + 2 * t, kRow);
      load_a(ao, sdO + (wr + g) * kRow + kk * 16 + 2 * t, kRow);
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
        const int r = (nt * 8 + g) * kRow + kk * 16 + 2 * t;
        Elem<T>::mma(s[nt], aq, ld32(sK + r), ld32(sK + r + 8));
        Elem<T>::mma(dp[nt], ao, ld32(sV + r), ld32(sV + r + 8));
      }
    }
    // dS = P (dP - delta), P = exp2(S * scale_log2 - lse) on visible pairs.
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const float pr = visible(p, r ? row1 : row0, n0 + nt * 8 + 2 * t + (i & 1), offset)
                             ? exp2f(s[nt][i] * p.scale_log2 - row_lse[r]) : 0.f;
        s[nt][i] = pr * (dp[nt][i] - row_delta[r]);
      }
    }
    // dQ += dS K, dS taken from the registers (accumulator layout = A layout).
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
      a[0] = Elem<T>::pack(s[2 * kk][0], s[2 * kk][1]);
      a[1] = Elem<T>::pack(s[2 * kk][2], s[2 * kk][3]);
      a[2] = Elem<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = Elem<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const int r = (dt * 8 + g) * kTRow + kk * 16 + 2 * t;
        Elem<T>::mma(acc[dt], a, ld32(sKt + r), ld32(sKt + r + 8));
      }
    }
  }

  T* dq = static_cast<T*>(p.out0) + (static_cast<int64_t>(b) * p.hq + h) * p.sq * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row0 < p.sq)
      *reinterpret_cast<uint32_t*>(dq + static_cast<int64_t>(row0) * D + col) =
          Elem<T>::pack(acc[dt][0] * p.scale, acc[dt][1] * p.scale);
    if (row1 < p.sq)
      *reinterpret_cast<uint32_t*>(dq + static_cast<int64_t>(row1) * D + col) =
          Elem<T>::pack(acc[dt][2] * p.scale, acc[dt][3] * p.scale);
  }
}

template <typename T, int D, bool kDkv>
int launch_bwd(const BwdParams& p, int batch, cudaStream_t stream) {
  constexpr int kSmem = kDkv ? dkv_smem_bytes<T, D>() : dq_smem_bytes<T, D>();
  auto kernel = kDkv ? flash_bwd_dkv_kernel<T, D> : flash_bwd_dq_kernel<T, D>;
  static bool configured = false;  // above 48 KB needs an explicit opt-in
  if (!configured) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  if (kDkv) {
    const dim3 grid((p.skv + kTile - 1) / kTile, p.hq / p.group, batch);
    kernel<<<grid, kDkvThreads, kSmem, stream>>>(p);
  } else {
    const dim3 grid((p.sq + kTile - 1) / kTile, p.hq, batch);
    kernel<<<grid, kDqThreads, kSmem, stream>>>(p);
  }
  return cudaGetLastError();
}

template <bool kDkv>
int dispatch_bwd(const BwdParams& p, int batch, int d, int dtype, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  using h16 = __half;
  if (dtype == kBF16 && d == 64) return launch_bwd<bf16, 64, kDkv>(p, batch, s);
  if (dtype == kBF16 && d == 128) return launch_bwd<bf16, 128, kDkv>(p, batch, s);
  if (dtype == kF16 && d == 64) return launch_bwd<h16, 64, kDkv>(p, batch, s);
  if (dtype == kF16 && d == 128) return launch_bwd<h16, 128, kDkv>(p, batch, s);
  return cudaErrorInvalidValue;
}

}  // namespace fact

// One launch function for both kernels, counted apart by the wrapper
// (ops/flash_bwd.py): `dkv` 1 launches B13a into out0 = dK and out1 = dV,
// 0 launches B13b into out0 = dQ. Returns a cudaError_t code (0 on
// success). Shapes, strides and dtypes are checked by the wrapper.
extern "C" int fact_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, void* out0, void* out1,
                              int batch, int hq, int hkv, int sq, int skv, int d,
                              long long q_sb, long long q_sh, long long q_ss,
                              long long k_sb, long long k_sh, long long k_ss,
                              long long v_sb, long long v_sh, long long v_ss,
                              long long o_sb, long long o_sh, long long o_ss,
                              float scale_log2, float scale, int causal, int window, int dtype,
                              int dkv, void* stream) {
  using namespace fact;
  BwdParams p{};
  p.q = q, p.k = k, p.v = v, p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.out0 = out0, p.out1 = out1;
  p.q_sb = q_sb, p.q_sh = q_sh, p.q_ss = q_ss;
  p.k_sb = k_sb, p.k_sh = k_sh, p.k_ss = k_ss;
  p.v_sb = v_sb, p.v_sh = v_sh, p.v_ss = v_ss;
  p.o_sb = o_sb, p.o_sh = o_sh, p.o_ss = o_ss;
  p.hq = hq, p.group = hq / hkv, p.sq = sq, p.skv = skv;
  p.scale_log2 = scale_log2, p.scale = scale;
  p.causal = causal, p.window = window;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dkv ? dispatch_bwd<true>(p, batch, d, dtype, s) : dispatch_bwd<false>(p, batch, d, dtype, s);
}
