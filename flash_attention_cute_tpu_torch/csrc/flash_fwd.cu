// Prefill attention forward: O = softmax(Q K^T * scale + mask) V, with
// bottom-right causal masking (key n visible from query m iff
// n <= m + (Skv - Sq)) or no mask, and an optional sliding window W (key n
// also needs n > m + (Skv - Sq) - W).
//
// One launch function serves two kernels of the TPU package, counted apart
// by the wrapper (ops/flash_fwd.py):
//   * P (window 0) replaces flash_attention_cute_tpu/ops/flash_fwd.py
//     `_flash_fwd_kernel_diag` (pallas_call at :1039);
//   * B2 (a window that binds, W < Skv) replaces `_flash_fwd_kernel_fused`
//     (:269) and its per-head fallback `_flash_fwd_kernel` (:102), both
//     behind the pallas_call at :1260, for their windowed geometry. Their
//     int8 scores are not in this kernel: the wrapper raises on them.
// Both take the tanh soft cap (`softcap_log2`, c * log2(e), 0 for none),
// applied to every score before the mask in the base-2 units of the body:
// x = c2 * tanh(x / c2), c2 = c * log2(e), which is log2(e) times the TPU
// kernels' c * tanh(s / c) of the natural score s. Head dims 64, 128, 256.
// With `lse` not null they also write the per-row lse the backward
// (flash_bwd.cu) reads (`return_lse`, flash_fwd.py:845): m + log2(l) in the
// base-2 units of the scores, +inf on a row with no visible key, the TPU
// kernels' convention (:258-266, :580-592), at every head dim and with the
// cap, as the JAX forward returns it.
// The softmax is exact, in fp32 (the `stable="strict"` semantics: the row
// max is updated at every tile, no lazy rescale); P is rounded to the input
// type before PV; 1/l is applied once at the end, and a row with no visible
// key (l = 0) is written as exact zeros. GQA: q head h reads kv head
// h / (Hq / Hkv). No atomics: a second call writes the same bits.
// They compute what the TPU kernels compute, not their block structure:
// those pack a q-head group per grid cell and skip KV blocks wholly below
// every row's window in the grid; here each block walks its own tile range.
//
// What bounds them on the H100: tensor-core operations (4 D per visible
// (row, key) pair and q head), far above the card's ~295 operations per
// byte at prefill lengths. So they are built for wgmma, fed by TMA:
//
//   * One block per (128 q rows, q head, batch row), three warpgroups:
//     warpgroup 0 is the producer (one thread issues every copy; setmaxnreg
//     gives its registers to the others), warpgroups 1 and 2 are consumers
//     of 64 rows each (240 registers).
//   * Q arrives once; K and V tiles of kN keys stream through two rings
//     (K and V apart, each slot with a full and an empty mbarrier): TMA
//     copies with the 128-byte swizzle through 4-D maps of the strided
//     [B, H, S, D] views (each 64-column block of D is one box; rows past S
//     read as zeros), so the model's transposed q / k / v need no copy.
//   * S = Q K^T is wgmma with both operands in shared memory, K-major (D is
//     contiguous in both). S stays in registers: capped, masked and
//     exponentiated there, rounded to the input type, its accumulator
//     layout is the register A operand of O += P V, whose B operand V is
//     read MN-major from its slot (the descriptor's transpose bit):
//     no V^T copy, no round trip of P through shared memory.
//   * Row statistics are reduced over the four threads (a quad) that hold
//     a row in the accumulator layout.
//   * Overlap: a consumer issues S of tile j together with P V of tile j - 1
//     and computes tile j's exponentials while P V runs; the two consumers
//     take turns issuing (named barriers, "ping-pong"), so one's products
//     run while the other computes. A K slot is free once S is, a V slot
//     only a tile later, so the K ring is the deeper.
//   * The tanh of the soft cap is two MUFU operations (softcap() below).
//   * The walk is the block's tile range, from the tile holding its first
//     visible key (the window start) to the causal end; the mask runs only
//     on tiles that cross the diagonal, the window's lower edge or the
//     ragged end of Skv, and a consumer skips a tile in which it sees no
//     key (it still hands back its slots). Causal grids start with the rows
//     that see the most keys.
//   * D 64 / 128: tiles of 128 keys, S 64 fp32 registers a thread, O 32 /
//     64, P 32; D 256: tiles of 64 keys, S 32, O 128 (two products of N 128
//     per k-step of P V), P 16. Shared memory: Q 16 / 32 / 64 KB, K slots
//     4 / 4 / 3 and V slots 4 / 2 / 2 of 16 / 32 / 32 KB: 144 / 224 / 224
//     KB, one block an SM.
#include "hopper.cuh"

namespace fact {

struct FwdParams {
  void* o;     // [B, Hq, Sq, D] contiguous
  float* lse;  // [B, Hq, Sq] fp32 contiguous, or null
  int batch, hq, group, sq, skv;
  float scale_log2;    // softmax_scale * log2(e): softmax runs in base 2
  float softcap_log2;  // c * log2(e), or 0 for none
  float cap_exp;       // 2 log2(e) scale_log2 / softcap_log2: softcap()'s power of 2 a raw score
  int causal;
  int window;  // W > 0, or 0 for none
};

constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kBlockM = 128;   // q rows of a block
constexpr int kTileM = 64;     // q rows of a consumer

// K and V stream through rings of their own: a K tile is free once S is,
// a V tile only after the next tile's S (its P V runs then).
template <int D>
struct FwdSmem {
  static constexpr int kN = D == 256 ? 64 : 128;  // keys of a tile
  static constexpr int kKStages = D == 256 ? 3 : 4;
  static constexpr int kVStages = D == 64 ? 4 : 2;
  static constexpr int kQBox = kBlockM * 128;     // bytes of one 64-column box of Q
  static constexpr int kKVBox = kN * 128;         // of K or V
  static constexpr int kQ = D / 64 * kQBox;
  static constexpr int kKV = D / 64 * kKVBox;     // a K or a V tile
  static constexpr int kBars = kQ + (kKStages + kVStages) * kKV;
  static constexpr int kBytes = 1024 + kBars + (1 + 2 * (kKStages + kVStages)) * 8;
};

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
__device__ __forceinline__ float softcap(float s, const FwdParams& p) {
  return fmaf(-2.f * p.softcap_log2, rcp(1.f + ex2(s * p.cap_exp)), p.softcap_log2);
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

// O += P V over a tile's kN keys: P in registers (the A fragments of each
// k-step of 16 keys), V MN-major from its slot; at D 256 two products of N
// 128 a k-step.
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
__device__ __forceinline__ bool tile_dead(const FwdParams& p, int m0, int n0, int offset) {
  return m0 >= p.sq || n0 >= p.skv || (p.causal && n0 > m0 + kTileM - 1 + offset) ||
         (p.window > 0 && n0 + kN - 1 <= m0 + offset - p.window);
}
// Every key of the tile is visible from every row: no mask needed (rows
// past Sq, zeros by TMA, are never stored).
template <int kN>
__device__ __forceinline__ bool tile_full(const FwdParams& p, int m0, int n0, int offset) {
  return n0 + kN <= p.skv && (!p.causal || n0 + kN - 1 <= m0 + offset) &&
         (p.window <= 0 || n0 > m0 + kTileM - 1 + offset - p.window);
}

// kCap: the soft cap is compiled in (a launch with softcap_log2 > 0).
template <typename T, int D, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, const FwdParams p) {
  using S = FwdSmem<D>;
  constexpr int kN = S::kN, kKStages = S::kKStages, kVStages = S::kVStages;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;  // the 128-byte swizzle needs 1 KB
  const uint32_t sQ = base, sK0 = base + S::kQ, sV0 = sK0 + kKStages * S::kKV;
  const uint32_t bars = base + S::kBars;
  const uint32_t q_full = bars;
  // Tile `it` of the walk: its K and V slots and their full / empty barriers.
  auto sK = [&](int it) { return sK0 + it % kKStages * S::kKV; };
  auto sV = [&](int it) { return sV0 + it % kVStages * S::kKV; };
  auto full_k = [&](int it) { return bars + 8 * (1 + it % kKStages); };
  auto empty_k = [&](int it) { return bars + 8 * (1 + kKStages + it % kKStages); };
  auto full_v = [&](int it) { return bars + 8 * (1 + 2 * kKStages + it % kVStages); };
  auto empty_v = [&](int it) { return bars + 8 * (1 + 2 * kKStages + kVStages + it % kVStages); };
  // The parity of tile it's pass through its slot.
  auto k_pass = [&](int it) { return (it / kKStages) & 1; };
  auto v_pass = [&](int it) { return (it / kVStages) & 1; };

  const int per = p.hq * p.batch;
  const int nqb = (p.sq + kBlockM - 1) / kBlockM;
  const int m0 = (nqb - 1 - static_cast<int>(blockIdx.x) / per) * kBlockM;  // most keys first
  const int h = blockIdx.x % per % p.hq, b = blockIdx.x % per / p.hq, hk = h / p.group;
  const int offset = p.skv - p.sq;

  // Keys from the window's near edge (row m0's first visible key) to the
  // causal edge (the last row's last).
  int n_end = p.skv;
  if (p.causal) n_end = min(n_end, m0 + kBlockM + offset);
  const int n_begin = (p.window > 0 ? max(0, m0 + offset - p.window + 1) : 0) / kN * kN;
  const int total = n_end > n_begin ? (n_end - n_begin + kN - 1) / kN : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kKStages; ++s) mbar_init(full_k(s), 1), mbar_init(empty_k(s), 8);
    for (int s = 0; s < kVStages; ++s) mbar_init(full_v(s), 1), mbar_init(empty_v(s), 8);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0 && total > 0) {
      mbar_expect_tx(q_full, S::kQ);
      for (int c = 0; c < D / 64; ++c) tma_load_4d(sQ + c * S::kQBox, &qmap, 64 * c, m0, h, b, q_full);
      for (int it = 0; it < total; ++it) {
        const int n0 = n_begin + it * kN;
        mbar_wait(empty_k(it), k_pass(it) ^ 1);
        mbar_expect_tx(full_k(it), S::kKV);
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(sK(it) + c * S::kKVBox, &kmap, 64 * c, n0, hk, b, full_k(it));
        mbar_wait(empty_v(it), v_pass(it) ^ 1);
        mbar_expect_tx(full_v(it), S::kKV);
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(sV(it) + c * S::kKVBox, &vmap, 64 * c, n0, hk, b, full_v(it));
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int ct = threadIdx.x - 128, wg = ct >> 7, wi = (ct >> 5) & 3, lane = ct & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mw = m0 + kTileM * wg;       // this warpgroup's first row
  const int row0 = mw + 16 * wi + g;     // this thread's rows: row0, row0 + 8
  const uint32_t qa = sQ + wg * kTileM * 128;
  constexpr int kOBlocks = D == 256 ? 2 : 1;  // PV products of N = D / kOBlocks a k-step
  constexpr int kON = D / kOBlocks;
  // Element 4 j + e of an accumulator: row row0 + 8 (e >> 1), column
  // 8 j + 2 t + (e & 1) (of keys for S, of D within the block for O).
  float o[kOBlocks][kON / 2];
#pragma unroll
  for (int c = 0; c < kOBlocks; ++c)
#pragma unroll
    for (int i = 0; i < kON / 2; ++i) o[c][i] = 0.f;
  // Each row's running max (base-2 units of the scaled score) and this
  // thread's part of its running sum, reduced over the quad at the end.
  float row_max[2] = {-INFINITY, -INFINITY}, row_sum[2] = {0.f, 0.f};
  // Scores leave the product raw; the cap scales them inside the tanh.
  const float sc = kCap ? 1.f : p.scale_log2;
  if (total > 0) mbar_wait(q_full, 0);

  // Cap, mask and exponentiate the scores of one tile in place, updating
  // the running max and sum; alpha: the factor of O's old rows.
  auto softmax = [&](float (&s)[kN / 2], int n0, float (&alpha)[2]) {
    if constexpr (kCap) {
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) s[i] = softcap(s[i], p);
    }
    if (!tile_full<kN>(p, mw, n0, offset)) {
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) {
        const int row = row0 + 8 * ((i >> 1) & 1), col = n0 + 8 * (i >> 2) + 2 * t + (i & 1);
        if (col >= p.skv || (p.causal && col > row + offset) ||
            (p.window > 0 && col <= row + offset - p.window))
          s[i] = -INFINITY;
      }
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
    mbar_wait(full_k(it), k_pass(it));
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
    mbar_wait(full_v(it), v_pass(it));
    release(empty_k(it));
    release(empty_v(it));
  };
  // The tiles this consumer sees a key of are one run [it_lo, it_hi) of the
  // walk; the wgmma products stay out of data-dependent branches (ptxas
  // serializes them there).
  int it_lo = 0, it_hi = total;
  while (it_lo < total && tile_dead<kN>(p, mw, n_begin + it_lo * kN, offset)) ++it_lo;
  while (it_hi > it_lo && tile_dead<kN>(p, mw, n_begin + (it_hi - 1) * kN, offset)) --it_hi;
  for (int it = 0; it < it_lo; ++it) skip(it);
  if (it_lo < it_hi) {
    uint32_t pa[kN / 16][4];  // P of the previous tile, rounded to T
    {
      float s[kN / 2], alpha[2];
      take_turn(it_lo);
      wgmma_fence();
      qk_products<T, D, kN>(s, qa, sK(it_lo));
      wgmma_commit();
      pass_turn(it_lo);
      wgmma_wait<0>();
      fence_regs(s);
      release(empty_k(it_lo));
      softmax(s, n_begin + it_lo * kN, alpha);  // O is 0: alpha unused
      to_a<T>(s, pa);
    }
    for (int it = it_lo + 1; it < it_hi; ++it) {
      float s[kN / 2], alpha[2];
      take_turn(it);
      mbar_wait(full_v(it - 1), v_pass(it - 1));
      wgmma_fence();
      qk_products<T, D, kN>(s, qa, sK(it));
      wgmma_commit();
      pv_products<T, D, kN>(o, pa, sV(it - 1));
      wgmma_commit();
      pass_turn(it);
      wgmma_wait<1>();  // S done; P V may still run
      fence_regs(s);
      release(empty_k(it));
      softmax(s, n_begin + it * kN, alpha);
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < kOBlocks; ++c) fence_regs(o[c]);
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) fence_regs(pa[kk]);
      release(empty_v(it - 1));
#pragma unroll
      for (int c = 0; c < kOBlocks; ++c)
#pragma unroll
        for (int i = 0; i < kON / 2; ++i) o[c][i] *= alpha[(i >> 1) & 1];
      to_a<T>(s, pa);
    }
    mbar_wait(full_v(it_hi - 1), v_pass(it_hi - 1));
    wgmma_fence();  // the last tile's P V
    pv_products<T, D, kN>(o, pa, sV(it_hi - 1));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kOBlocks; ++c) fence_regs(o[c]);
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) fence_regs(pa[kk]);
    release(empty_v(it_hi - 1));
  }
  for (int it = it_hi; it < total; ++it) skip(it);

  const int64_t head = static_cast<int64_t>(b) * p.hq + h;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = row_sum[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = l > 0.f ? 1.f / l : 0.f;  // no visible key -> exact zero row
    const int row = row0 + 8 * r;
    if (p.lse != nullptr && t == 0 && row < p.sq)  // the backward's residual
      p.lse[head * p.sq + row] = l > 0.f ? row_max[r] + log2f(l) : INFINITY;
  }
  T* out = static_cast<T*>(p.o) + head * p.sq * D;
#pragma unroll
  for (int c = 0; c < kOBlocks; ++c)
#pragma unroll
    for (int j = 0; j < kON / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row < p.sq)
          *reinterpret_cast<uint32_t*>(out + static_cast<int64_t>(row) * D + c * kON + 8 * j + 2 * t) =
              Elem<T>::pack(o[c][4 * j + 2 * r] * inv[r], o[c][4 * j + 2 * r + 1] * inv[r]);
      }
}

// ---------------------------------------------------------------------------
// Host side.

struct FwdViews {
  const void *q, *k, *v;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int hkv, dtype;
};

template <typename T, int D, bool kCap>
int launch_fwd(const FwdParams& p, const FwdViews& w, cudaStream_t stream) {
  using S = FwdSmem<D>;
  auto kernel = flash_fwd_kernel<T, D, kCap>;
  static const int configured = allow_smem(kernel, S::kBytes);  // above 48 KB needs an opt-in
  if (configured != cudaSuccess) return configured;
  const long long blocks = static_cast<long long>((p.sq + kBlockM - 1) / kBlockM) * p.hq * p.batch;
  if (blocks <= 0) return cudaSuccess;
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
  CUtensorMap qmap, kmap, vmap;
  if (!head_map(&qmap, w.dtype, w.q, p.batch, p.hq, p.sq, D, w.q_sb, w.q_sh, w.q_ss, kBlockM) ||
      !head_map(&kmap, w.dtype, w.k, p.batch, w.hkv, p.skv, D, w.k_sb, w.k_sh, w.k_ss, S::kN) ||
      !head_map(&vmap, w.dtype, w.v, p.batch, w.hkv, p.skv, D, w.v_sb, w.v_sh, w.v_ss, S::kN))
    return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kThreads, S::kBytes, stream>>>(qmap, kmap, vmap, p);
  return cudaGetLastError();
}

template <typename T, int D>
int launch_cap(const FwdParams& p, const FwdViews& w, cudaStream_t s) {
  return p.softcap_log2 > 0.f ? launch_fwd<T, D, true>(p, w, s) : launch_fwd<T, D, false>(p, w, s);
}

template <typename T>
int dispatch_fwd(const FwdParams& p, const FwdViews& w, int d, cudaStream_t s) {
  if (d == 64) return launch_cap<T, 64>(p, w, s);
  if (d == 128) return launch_cap<T, 128>(p, w, s);
  if (d == 256) return launch_cap<T, 256>(p, w, s);
  return cudaErrorInvalidValue;
}

template <typename T>
static void report_type(char* out, int cap, int& used, const char* t) {
  char name[96];
#define FWD_REPORT(d, c)                                                          \
  snprintf(name, sizeof(name), "P / B2 D%d %s%s", d, t, c ? " cap" : "");        \
  report_one(out, cap, used, name, (flash_fwd_kernel<T, d, c>), FwdSmem<d>::kBytes)
  FWD_REPORT(64, false);
  FWD_REPORT(64, true);
  FWD_REPORT(128, false);
  FWD_REPORT(128, true);
  FWD_REPORT(256, false);
  FWD_REPORT(256, true);
#undef FWD_REPORT
}

}  // namespace fact

// Writes the report of every P / B2 instantiation (the launch's registers:
// the consumers raise theirs to 240 by setmaxnreg; local (spill) bytes;
// shared memory) into `out` (at most `cap` bytes, NUL-terminated); returns 0.
extern "C" int fact_fwd_report(char* out, int cap) {
  int used = 0;
  if (cap <= 0) return 0;
  out[0] = 0;
  fact::report_type<__nv_bfloat16>(out, cap, used, "bf16");
  fact::report_type<__half>(out, cap, used, "f16");
  out[cap - 1] = 0;
  return 0;
}

// Returns a cudaError_t code (0 on success). Shapes, strides and dtypes
// are checked by the Python wrapper (ops/flash_fwd.py).
extern "C" int fact_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              int batch, int hq, int hkv, int sq, int skv, int d,
                              long long q_sb, long long q_sh, long long q_ss,
                              long long k_sb, long long k_sh, long long k_ss,
                              long long v_sb, long long v_sh, long long v_ss,
                              float scale_log2, float softcap_log2, int causal, int window,
                              int dtype, void* stream) {
  using namespace fact;
  FwdParams p{};
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.batch = batch, p.hq = hq, p.group = hq / hkv, p.sq = sq, p.skv = skv;
  p.scale_log2 = scale_log2;
  p.softcap_log2 = softcap_log2;
  p.cap_exp = softcap_log2 > 0.f ? 2.f * 1.4426950408889634f * scale_log2 / softcap_log2 : 0.f;
  p.causal = causal;
  p.window = window;
  const FwdViews w{q, k, v, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, hkv, dtype};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return dispatch_fwd<__nv_bfloat16>(p, w, d, s);
  if (dtype == kF16) return dispatch_fwd<__half>(p, w, d, s);
  return cudaErrorInvalidValue;
}
