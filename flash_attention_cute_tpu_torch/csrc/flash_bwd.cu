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
// does), and dK and dQ are scaled once at the store.
//
// What bounds them on the H100: tensor-core operations. Per visible
// (row, key) pair and q head, B13a runs four products of depth D (S^T,
// dP^T, dV, dK: 8 D operations) and B13b three (S, dP, dQ: 6 D), far above
// the card's ~295 operations per byte at training lengths. So both are
// built for wgmma, fed by TMA, with no copy that transposes a tile:
//
//   * A block is three warpgroups: warpgroup 0 is the producer (one thread
//     issues every copy; setmaxnreg gives its registers to the others),
//     warpgroups 1 and 2 are consumers of 64 rows each (240 registers).
//   * Tiles arrive by TMA with the 128-byte swizzle, through 4-D maps of
//     the strided [B, H, S, D] views (each D half of 64 columns is one box;
//     rows past S read as zeros), into a ring of kStages stages signalled by
//     mbarriers. The lse and delta rows come by bulk copy from padded
//     [B, Hq, Sq rounded up to 128] fp32 buffers (ops/flash_bwd.py).
//   * B13a: one block per (128 keys, kv head, batch row); consumer c owns
//     keys 64 c ... K and V arrive once. The stages carry the group's (Q,
//     dO, lse, delta) tiles of 64 rows: for each q head of the group, the q
//     tiles from the causal edge to the window's far edge. S^T = K Q^T and
//     dP^T = V dO^T are wgmma with both operands in shared memory, K-major
//     (D is contiguous in both). P^T and dS^T stay in registers: the
//     accumulator layout, rounded to the input type, is the register A
//     operand of dV += P^T dO and dK += dS^T Q, whose B operands dO and Q
//     are read MN-major from the same stage (the descriptor's transpose
//     bit). dK, dV of 64 keys x D are 2 x D / 2 fp32 registers a thread.
//   * B13b: one block per (128 q rows, q head, batch row); consumer c owns
//     rows 64 c ... Q, dO, lse and delta arrive once; the (K, V) tiles of 64
//     keys stream through the stages, from the window's near edge to the
//     causal edge. S = Q K^T and dP = dO V^T from shared memory; dS in
//     registers is the A operand of dQ += dS K, K read MN-major from the
//     stage.
//   * S (S^T) and dP (dP^T) are committed as two wgmma groups: the
//     exponentials run while dP is still in the tensor cores, and in B13a
//     dS^T while dV is. The two consumers interleave their products and
//     their elementwise work on the SM. (Keeping the next tile's products
//     in flight across iterations needs more than 240 registers in B13a,
//     and was slower in B13b: PERF.md.)
//   * The mask runs only on tiles that cross the causal or window edge or
//     the end of Sq / Skv; a consumer skips a tile in which it sees no
//     pair (it still releases the stage).
//   * Causal grids start with the heaviest tiles: the keys with the most
//     rows (B13a), the rows with the most keys (B13b), over all heads.
//   * Where the key blocks are too few to fill the card (few kv heads,
//     short sequences: Qwen2-7B's 4 kv heads at S 1024 give 32 blocks), the
//     wrapper's plan (ops/flash_bwd.py `dkv_splits`) cuts each key block's
//     walk into `splits` parts, one block each, that write fp32 partials
//     of dK and dV; a second pass in the same C call adds them in split
//     order, scales dK and rounds.
// The group is summed inside a B13a block (and across its splits) in a
// fixed order: no atomics, and two calls give the same bits. That is the
// layout of D 64 / 128; D 256 and D 512 have one each of their own
// (flash_bwd_dkv_kernel_d256, flash_bwd_dq_kernel_d256, flash_bwd_dkv_kernel_
// d512, flash_bwd_dq_kernel_d512, below), under the same rules.
//
// Head dims: every d from 1 to 512, each run in the layout of the next of
// 64, 128, 256 and 512 at or above it (padded_head_dim with `wide`), as P /
// B2 run theirs (flash_fwd.cu). The maps hold the true d columns (rows at any 16-byte
// stride), so TMA reads zeros past them (each box still credits its whole
// size to the mbarrier): S, dP, P and dS are exact, and the columns of dK,
// dV and dQ past d are zeros. The kernels store rows of the pitch
// row_pitch(d) (zeros past d), which the launch hands them as `d`: it is
// the row stride and the column bound of every store and of the split
// partials. Each kernel has a `kPad` instantiation that reads the pitch
// from its parameters, launched for a pitch below D, and one for a pitch
// of D whose stores keep D as a constant, the code of the layout before
// the rule (a runtime bound in every instantiation cost B13a 3 % at D 256:
// PERF.md). The TPU wrapper pads D to its 128 lanes instead
// (flash_bwd.py:287, :300-302).
#include "hopper.cuh"

namespace fact {

struct BwdParams {
  const float* lse;    // [B, Hq, sq_pad] contiguous, log2 units; +inf past Sq
  const float* delta;  // [B, Hq, sq_pad] contiguous; 0 past Sq
  void* out0;  // B13a: dK [B, Hkv, Skv, d]; B13b: dQ [B, Hq, Sq, d] (contiguous)
  void* out1;  // B13a: dV [B, Hkv, Skv, d]
  float* ws;   // B13a with splits > 1: fp32 partials [2][splits][B, Hkv, Skv, d]
  int batch, hq, hkv, group, sq, skv, sq_pad;
  int splits;  // B13a: parts of each key block's walk, one block each
  float scale_log2;  // softmax_scale * log2(e)
  float scale;
  int causal;
  int window;  // W > 0, or 0 for none
  int d;       // the true head dim (D or below it); on the device the outputs' row pitch
};

constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kTile = 64;      // rows (or keys) of a consumer's tile
constexpr int kBlock = 128;    // keys of a B13a block, rows of a B13b block
constexpr int kStages = 4;
constexpr int kRowPad = 128;   // lse / delta rows are padded to a multiple of this
constexpr int kBox = kTile * 128;  // bytes of one 64-row box of a D half

__device__ __forceinline__ bool visible(const BwdParams& p, int m, int n, int offset) {
  return n < p.skv && m < p.sq && (!p.causal || n <= m + offset) &&
         (p.window <= 0 || n > m + offset - p.window);
}
// No pair of the 64 x 64 tile (rows m0.., keys n0..) is visible.
__device__ __forceinline__ bool tile_dead(const BwdParams& p, int m0, int n0, int offset) {
  return m0 >= p.sq || n0 >= p.skv || (p.causal && n0 > m0 + kTile - 1 + offset) ||
         (p.window > 0 && n0 + kTile - 1 <= m0 + offset - p.window);
}
// Every pair of the tile is visible: no mask needed.
__device__ __forceinline__ bool tile_full(const BwdParams& p, int m0, int n0, int offset) {
  return m0 + kTile <= p.sq && n0 + kTile <= p.skv &&
         (!p.causal || n0 + kTile - 1 <= m0 + offset) &&
         (p.window <= 0 || n0 > m0 + kTile - 1 + offset - p.window);
}

template <int D>
struct DkvSmem {
  static constexpr int kHalves = D / 64;
  static constexpr int kKV = kHalves * 2 * kBox;    // K or V: 128 keys
  static constexpr int kStage = kHalves * 2 * kBox;  // Q and dO: 64 rows
  static constexpr int kRows = 2 * kTile * 4;        // lse, delta
  static constexpr int kBars = 2 * kKV + kStages * kStage + kStages * kRows;
  static constexpr int kBytes = 1024 + kBars + (1 + 2 * kStages) * 8;
};

// B13a: dK, dV of 128 keys of one kv head, summed over its q-head group.
template <typename T, int D, bool kPad>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap omap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap, const BwdParams p) {
  using S = DkvSmem<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023) & ~1023u;  // the 128-byte swizzle needs 1 KB
  const unsigned char* gbase = smem + (base - raw);
  const uint32_t sK = base, sV = base + S::kKV, sQ0 = base + 2 * S::kKV;
  const int rows_off = 2 * S::kKV + kStages * S::kStage;
  const uint32_t bars = base + S::kBars;
  const uint32_t kv_full = bars;
  auto sQ = [&](int s) { return sQ0 + s * S::kStage; };
  auto sO = [&](int s) { return sQ0 + s * S::kStage + S::kHalves * kBox; };
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };

  const int heads = p.hkv * p.batch, per = heads * p.splits;
  const int n0 = (blockIdx.x / per) * kBlock;  // the keys with the most causal rows first
  const int split = blockIdx.x % per / heads, hb = blockIdx.x % heads;
  const int hk = hb % p.hkv, b = hb / p.hkv;
  const int offset = p.skv - p.sq;

  // The q rows that see a key of the block: from the causal edge (row
  // n0 - offset sees key n0) to the window's far edge (the last key is
  // visible up to row n_last - offset + W - 1).
  int m_begin = p.causal ? max(0, n0 - offset) : 0;
  int m_end = p.sq;
  if (p.window > 0) m_end = min(m_end, min(n0 + kBlock, p.skv) - 1 - offset + p.window);
  m_begin = m_begin / kTile * kTile;
  const int nm = m_end > m_begin ? (m_end - m_begin + kTile - 1) / kTile : 0;
  // This block's part of the walk over (q head of the group, q tile).
  const int it0 = nm * p.group * split / p.splits, it1 = nm * p.group * (split + 1) / p.splits;
  const int total = it1 - it0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(full(s), 1), mbar_init(empty(s), 8);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0 && total > 0) {
      mbar_expect_tx(kv_full, 2 * S::kKV);
      for (int h = 0; h < S::kHalves; ++h) {
        tma_load_4d(sK + h * 2 * kBox, &kmap, 64 * h, n0, hk, b, kv_full);
        tma_load_4d(sV + h * 2 * kBox, &vmap, 64 * h, n0, hk, b, kv_full);
      }
      for (int it = 0; it < total; ++it) {
        const int s = it % kStages, h = hk * p.group + (it0 + it) / nm;
        const int m0 = m_begin + (it0 + it) % nm * kTile;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), S::kStage + S::kRows);
        for (int hh = 0; hh < S::kHalves; ++hh) {
          tma_load_4d(sQ(s) + hh * kBox, &qmap, 64 * hh, m0, h, b, full(s));
          tma_load_4d(sO(s) + hh * kBox, &omap, 64 * hh, m0, h, b, full(s));
        }
        const int64_t row = (static_cast<int64_t>(b) * p.hq + h) * p.sq_pad + m0;
        const uint32_t rows = base + rows_off + s * S::kRows;
        bulk_load(rows, p.lse + row, kTile * 4, full(s));
        bulk_load(rows + kTile * 4, p.delta + row, kTile * 4, full(s));
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int ct = threadIdx.x - 128, wg = ct >> 7, wi = (ct >> 5) & 3, lane = ct & 31;
    const int g = lane >> 2, t = lane & 3;
    const int nw = n0 + kTile * wg;  // this warpgroup's first key
    const uint32_t ka = sK + wg * kBox, va = sV + wg * kBox;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    if (total > 0) mbar_wait(kv_full, 0);

    for (int it = 0; it < total; ++it) {
      const int st = it % kStages;
      const int m0 = m_begin + (it0 + it) % nm * kTile;
      mbar_wait(full(st), (it / kStages) & 1);
      if (!tile_dead(p, m0, nw, offset)) {
        const bool edge = !tile_full(p, m0, nw, offset);
        // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 rows, two groups, so
        // that P^T is computed while dP^T runs.
        float s[32], dp[32];
        wgmma_fence();
        wgmma_ss<T, 64, false>(s, kmajor(ka, 0, 2 * kBox), kmajor(sQ(st), 0, kBox));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
          wgmma_ss<T, 64, true>(s, kmajor(ka, kk, 2 * kBox), kmajor(sQ(st), kk, kBox));
        wgmma_commit();
        wgmma_ss<T, 64, false>(dp, kmajor(va, 0, 2 * kBox), kmajor(sO(st), 0, kBox));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
          wgmma_ss<T, 64, true>(dp, kmajor(va, kk, 2 * kBox), kmajor(sO(st), kk, kBox));
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);

        // P^T = exp2(S^T * scale_log2 - lse) on visible pairs. Element 4 j + e:
        // key nw + 16 wi + g + 8 (e >> 1), row m0 + 8 j + 2 t + (e & 1).
        const float* rows = reinterpret_cast<const float*>(gbase + rows_off + st * S::kRows);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l = *reinterpret_cast<const float2*>(rows + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            float pr = exp2f(s[i] * p.scale_log2 - ((e & 1) ? l.y : l.x));
            if (edge && !visible(p, m0 + 8 * j + 2 * t + (e & 1), nw + 16 * wi + g + 8 * (e >> 1),
                                 offset))
              pr = 0.f;
            s[i] = pr;
          }
        }
        uint32_t pa[4][4], sa[4][4];
        to_a<T>(s, pa);

        // dV += P^T dO over the tile's 64 rows, dO MN-major from the stage;
        // it runs while dS^T = P^T (dP^T - delta) is computed.
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs<T, D, true>(dv, pa[kk], mnmajor(sO(st), kk, kBox), 1);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(dp);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 dl = *reinterpret_cast<const float2*>(rows + kTile + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? dl.y : dl.x));
        }
        to_a<T>(dp, sa);

        // dK += dS^T Q, Q MN-major from the stage.
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs<T, D, true>(dk, sa[kk], mnmajor(sQ(st), kk, kBox), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]), fence_regs(sa[kk]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }

    // Rows of d columns; the columns past d (zeros) are not stored.
    const int d = kPad ? p.d : D;
    const int64_t out = (static_cast<int64_t>(b) * p.hkv + hk) * p.skv * d;
    if (p.splits > 1) {  // fp32 partials, added by flash_bwd_dkv_combine
      const int64_t part = static_cast<int64_t>(p.batch) * p.hkv * p.skv * d;
      float* wk = p.ws + split * part + out;
      float* wv = p.ws + (p.splits + split) * part + out;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int key = nw + 16 * wi + g + 8 * r, col = 8 * j + 2 * t;
          if (key < p.skv && (!kPad || col < d)) {
            const int64_t at = static_cast<int64_t>(key) * d + col;
            const int e = 4 * j + 2 * r;
            *reinterpret_cast<float2*>(wk + at) = make_float2(dk[e], dk[e + 1]);
            *reinterpret_cast<float2*>(wv + at) = make_float2(dv[e], dv[e + 1]);
          }
        }
      }
      return;
    }
    T* dkp = static_cast<T*>(p.out0) + out;
    T* dvp = static_cast<T*>(p.out1) + out;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = nw + 16 * wi + g + 8 * r, col = 8 * j + 2 * t;
        if (key < p.skv && (!kPad || col < d)) {
          const int64_t at = static_cast<int64_t>(key) * d + col;
          const int e = 4 * j + 2 * r;
          *reinterpret_cast<uint32_t*>(dkp + at) = Elem<T>::pack(dk[e] * p.scale, dk[e + 1] * p.scale);
          *reinterpret_cast<uint32_t*>(dvp + at) = Elem<T>::pack(dv[e], dv[e + 1]);
        }
      }
    }
  }
}

// dK = scale * (sum of the splits' partials in split order), dV = the same
// sum unscaled, four elements a thread (`part`, B Hkv Skv d, is a multiple
// of 8).
template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_dkv_combine(const BwdParams p, int64_t part) {
  const int64_t i = (static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x) * 4;
  if (i >= part) return;
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    const float* src = p.ws + o * p.splits * part + i;
    float4 acc = *reinterpret_cast<const float4*>(src);
    for (int sp = 1; sp < p.splits; ++sp) {
      const float4 v = *reinterpret_cast<const float4*>(src + sp * part);
      acc.x += v.x, acc.y += v.y, acc.z += v.z, acc.w += v.w;
    }
    const float sc = o ? 1.f : p.scale;
    uint2 packed;
    packed.x = Elem<T>::pack(acc.x * sc, acc.y * sc);
    packed.y = Elem<T>::pack(acc.z * sc, acc.w * sc);
    *reinterpret_cast<uint2*>(static_cast<T*>(o ? p.out1 : p.out0) + i) = packed;
  }
}

template <int D>
struct DqSmem {
  static constexpr int kHalves = D / 64;
  static constexpr int kQO = kHalves * 2 * kBox;     // Q or dO: 128 rows
  static constexpr int kStage = kHalves * 2 * kBox;  // K and V: 64 keys
  static constexpr int kRows = 2 * kBlock * 4;       // lse, delta
  static constexpr int kBars = 2 * kQO + kStages * kStage + kRows;
  static constexpr int kBytes = 1024 + kBars + (1 + 2 * kStages) * 8;
};

// B13b: dQ of 128 rows of one q head.
template <typename T, int D, bool kPad>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap omap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap, const BwdParams p) {
  using S = DqSmem<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  const unsigned char* gbase = smem + (base - raw);
  const uint32_t sQ = base, sO = base + S::kQO, sK0 = base + 2 * S::kQO;
  const int rows_off = 2 * S::kQO + kStages * S::kStage;
  const uint32_t bars = base + S::kBars;
  const uint32_t q_full = bars;
  auto sK = [&](int s) { return sK0 + s * S::kStage; };
  auto sV = [&](int s) { return sK0 + s * S::kStage + S::kHalves * kBox; };
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };

  const int per = p.hq * p.batch;
  const int nqb = (p.sq + kBlock - 1) / kBlock;
  const int m0 = (nqb - 1 - static_cast<int>(blockIdx.x) / per) * kBlock;  // most keys first
  const int h = blockIdx.x % per % p.hq, b = blockIdx.x % per / p.hq, hk = h / p.group;
  const int offset = p.skv - p.sq;

  // Keys from the window's near edge (row m0's first visible key) to the
  // causal edge (the last row's last).
  int n_end = p.skv;
  if (p.causal) n_end = min(n_end, m0 + kBlock + offset);
  const int n_begin = (p.window > 0 ? max(0, m0 + offset - p.window + 1) : 0) / kTile * kTile;
  const int total = n_end > n_begin ? (n_end - n_begin + kTile - 1) / kTile : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(full(s), 1), mbar_init(empty(s), 8);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0 && total > 0) {
      mbar_expect_tx(q_full, 2 * S::kQO + S::kRows);
      for (int hh = 0; hh < S::kHalves; ++hh) {
        tma_load_4d(sQ + hh * 2 * kBox, &qmap, 64 * hh, m0, h, b, q_full);
        tma_load_4d(sO + hh * 2 * kBox, &omap, 64 * hh, m0, h, b, q_full);
      }
      const int64_t row = (static_cast<int64_t>(b) * p.hq + h) * p.sq_pad + m0;
      bulk_load(base + rows_off, p.lse + row, kBlock * 4, q_full);
      bulk_load(base + rows_off + kBlock * 4, p.delta + row, kBlock * 4, q_full);
      for (int it = 0; it < total; ++it) {
        const int s = it % kStages, n0 = n_begin + it * kTile;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), S::kStage);
        for (int hh = 0; hh < S::kHalves; ++hh) {
          tma_load_4d(sK(s) + hh * kBox, &kmap, 64 * hh, n0, hk, b, full(s));
          tma_load_4d(sV(s) + hh * kBox, &vmap, 64 * hh, n0, hk, b, full(s));
        }
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int ct = threadIdx.x - 128, wg = ct >> 7, wi = (ct >> 5) & 3, lane = ct & 31;
    const int g = lane >> 2, t = lane & 3;
    const int mw = m0 + kTile * wg;  // this warpgroup's first row
    const uint32_t qa = sQ + wg * kBox, oa = sO + wg * kBox;

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    float row_lse[2] = {INFINITY, INFINITY}, row_delta[2] = {0.f, 0.f};
    if (total > 0) {
      mbar_wait(q_full, 0);
      const float* rows = reinterpret_cast<const float*>(gbase + rows_off);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rb = kTile * wg + 16 * wi + g + 8 * r;
        row_lse[r] = rows[rb];
        row_delta[r] = rows[kBlock + rb];
      }
    }

    for (int it = 0; it < total; ++it) {
      const int st = it % kStages, n0 = n_begin + it * kTile;
      mbar_wait(full(st), (it / kStages) & 1);
      if (!tile_dead(p, mw, n0, offset)) {
        const bool edge = !tile_full(p, mw, n0, offset);
        // S = Q K^T and dP = dO V^T: 64 rows x 64 keys, two groups, so that
        // P is computed while dP runs.
        float s[32], dp[32];
        wgmma_fence();
        wgmma_ss<T, 64, false>(s, kmajor(qa, 0, 2 * kBox), kmajor(sK(st), 0, kBox));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
          wgmma_ss<T, 64, true>(s, kmajor(qa, kk, 2 * kBox), kmajor(sK(st), kk, kBox));
        wgmma_commit();
        wgmma_ss<T, 64, false>(dp, kmajor(oa, 0, 2 * kBox), kmajor(sV(st), 0, kBox));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
          wgmma_ss<T, 64, true>(dp, kmajor(oa, kk, 2 * kBox), kmajor(sV(st), kk, kBox));
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);

        // P = exp2(S * scale_log2 - lse) on visible pairs, then dS = P (dP - delta).
        // Element 4 j + e: row mw + 16 wi + g + 8 (e >> 1), key n0 + 8 j + 2 t + (e & 1).
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e, r = e >> 1;
            float pr = exp2f(s[i] * p.scale_log2 - row_lse[r]);
            if (edge && !visible(p, mw + 16 * wi + g + 8 * r, n0 + 8 * j + 2 * t + (e & 1), offset))
              pr = 0.f;
            s[i] = pr;
          }
        }
        wgmma_wait<0>();
        fence_regs(dp);
#pragma unroll
        for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - row_delta[(i >> 1) & 1]);
        uint32_t sa[4][4];
        to_a<T>(dp, sa);

        // dQ += dS K over the tile's 64 keys, K MN-major from the stage.
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs<T, D, true>(dq, sa[kk], mnmajor(sK(st), kk, kBox), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_regs(sa[kk]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }

    const int d = kPad ? p.d : D;
    T* dqp = static_cast<T*>(p.out0) + (static_cast<int64_t>(b) * p.hq + h) * p.sq * d;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = mw + 16 * wi + g + 8 * r, col = 8 * j + 2 * t;
        if (row < p.sq && (!kPad || col < d))
          *reinterpret_cast<uint32_t*>(dqp + static_cast<int64_t>(row) * d + col) =
              Elem<T>::pack(dq[4 * j + 2 * r] * p.scale, dq[4 * j + 2 * r + 1] * p.scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Head dim 256 (Gemma 2, Gemma-7B): B13a and B13b redesigned to fit the
// H100. The layout above needs about 385 KB of shared memory for B13a at D
// 256 (K and V of 128 keys, four 64 KB (Q, dO) stages), and its dK, dV of
// 64 keys x 256 would take 256 fp32 registers a consumer thread. Here:
//
//   * Blocks of 64 keys (B13a) or 64 q rows (B13b), two stages, so that
//     the fixed tiles, the ring and the exchange below fit 227 KB (B13a
//     226 KB, B13b 210 KB). The tiles are 64 rows of 256 columns: four
//     boxes of 64 columns, rows past S read as zeros.
//   * Both consumers work on every tile. Consumer c owns the 128-column
//     half c of the block's accumulators (dK, dV or dQ: 64 fp32 registers
//     each), and computes half of S and dP (depth 256): B13a the rows
//     32 c ... of S^T = K Q^T and dP^T = V dO^T, B13b the keys 32 c ... of
//     S = Q K^T and dP = dO V^T, as m64n32 wgmma.
//   * The products into the accumulators need all 64 rows (keys) of the
//     tile as their depth, so each consumer writes its half of P^T and dS^T
//     (B13b: dS) into shared memory in the register A fragments' layout
//     (16 bytes a thread and k-step, so no swizzle and no bank conflict),
//     the two meet at a named barrier, and each reads all four k-steps
//     back as the A operand of dV += P^T dO, dK += dS^T Q (B13b: dQ += dS K)
//     over its column half. The exchange is double buffered by tile
//     parity: a consumer writes tile i + 1's fragments while the other may
//     still read tile i's, and cannot reach tile i + 2 before the other
//     has passed tile i + 1's barrier.
//   * The walks are exact: every tile of B13a's q range and of B13b's key
//     range holds a visible pair (the ranges stop at Sq, and a 64-key
//     block's rows from the causal edge to the window's far edge all see a
//     key of it), so no product sits in a data-dependent branch.
// The splits of B13a, the combine pass and the fixed summation order are
// those of D 64 / 128.

constexpr int kStages256 = 2;
constexpr int kXchgPart = 2 * 128 * 16;  // a consumer's two k-steps of A fragments

template <bool kDkv>
struct Smem256 {
  static constexpr int kFixed = 2 * 4 * kBox;  // B13a: K, V of 64 keys; B13b: Q, dO of 64 rows
  static constexpr int kStage = 2 * 4 * kBox;  // B13a: (Q, dO); B13b: (K, V) of 64
  static constexpr int kRows = 2 * kTile * 4;  // lse, delta of 64 rows
  static constexpr int kRowsAll = kDkv ? kStages256 * kRows : kRows;
  static constexpr int kKinds = kDkv ? 2 : 1;          // P^T and dS^T, or dS
  static constexpr int kXchgBuf = kKinds * 2 * kXchgPart;
  static constexpr int kRowsOff = kFixed + kStages256 * kStage;
  static constexpr int kXchgOff = kRowsOff + kRowsAll;
  static constexpr int kBars = kXchgOff + 2 * kXchgBuf;
  static constexpr int kBytes = 1024 + kBars + (1 + 2 * kStages256) * 8;
};
static_assert(Smem256<true>::kBytes <= 232448 && Smem256<false>::kBytes <= 232448,
              "D-256 backward tiles exceed the H100's 227 KB a block");

// The two consumer warpgroups meet (named barrier 1; the producer takes no
// part).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// A consumer's half of a 64 x 64 operand (k-steps 2 wg, 2 wg + 1) into the
// exchange buffer `xb` of its kind, and all four k-steps back.
__device__ __forceinline__ void xchg_put(unsigned char* xb, int wg, int tid,
                                         const uint32_t (&a)[2][4]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    *reinterpret_cast<uint4*>(xb + (wg * 2 + kk) * 128 * 16 + tid * 16) =
        make_uint4(a[kk][0], a[kk][1], a[kk][2], a[kk][3]);
}
__device__ __forceinline__ void xchg_get(const unsigned char* xb, int tid, uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint4 v = *reinterpret_cast<const uint4*>(xb + kk * 128 * 16 + tid * 16);
    a[kk][0] = v.x, a[kk][1] = v.y, a[kk][2] = v.z, a[kk][3] = v.w;
  }
}

// B13a at D 256: dK, dV of 64 keys of one kv head, summed over its group.
template <typename T, bool kPad>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel_d256(const __grid_constant__ CUtensorMap qmap,
                              const __grid_constant__ CUtensorMap omap,
                              const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap, const BwdParams p) {
  using S = Smem256<true>;
  constexpr int D = 256;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem + (base - raw);
  const uint32_t sK = base, sV = base + 4 * kBox, sQ0 = base + S::kFixed;
  const uint32_t bars = base + S::kBars;
  const uint32_t kv_full = bars;
  auto sQ = [&](int s) { return sQ0 + s * S::kStage; };
  auto sO = [&](int s) { return sQ0 + s * S::kStage + 4 * kBox; };
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages256 + s); };

  const int heads = p.hkv * p.batch, per = heads * p.splits;
  const int n0 = (blockIdx.x / per) * kTile;  // the keys with the most causal rows first
  const int split = blockIdx.x % per / heads, hb = blockIdx.x % heads;
  const int hk = hb % p.hkv, b = hb / p.hkv;
  const int offset = p.skv - p.sq;

  // The q rows that see a key of the block, as in flash_bwd_dkv_kernel.
  int m_begin = p.causal ? max(0, n0 - offset) : 0;
  int m_end = p.sq;
  if (p.window > 0) m_end = min(m_end, min(n0 + kTile, p.skv) - 1 - offset + p.window);
  m_begin = m_begin / kTile * kTile;
  const int nm = m_end > m_begin ? (m_end - m_begin + kTile - 1) / kTile : 0;
  const int it0 = nm * p.group * split / p.splits, it1 = nm * p.group * (split + 1) / p.splits;
  const int total = it1 - it0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages256; ++s) mbar_init(full(s), 1), mbar_init(empty(s), 8);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0 && total > 0) {
      mbar_expect_tx(kv_full, S::kFixed);
      for (int h = 0; h < 4; ++h) {
        tma_load_4d(sK + h * kBox, &kmap, 64 * h, n0, hk, b, kv_full);
        tma_load_4d(sV + h * kBox, &vmap, 64 * h, n0, hk, b, kv_full);
      }
      for (int it = 0; it < total; ++it) {
        const int s = it % kStages256, h = hk * p.group + (it0 + it) / nm;
        const int m0 = m_begin + (it0 + it) % nm * kTile;
        mbar_wait(empty(s), ((it / kStages256) & 1) ^ 1);
        mbar_expect_tx(full(s), S::kStage + S::kRows);
        for (int hh = 0; hh < 4; ++hh) {
          tma_load_4d(sQ(s) + hh * kBox, &qmap, 64 * hh, m0, h, b, full(s));
          tma_load_4d(sO(s) + hh * kBox, &omap, 64 * hh, m0, h, b, full(s));
        }
        const int64_t row = (static_cast<int64_t>(b) * p.hq + h) * p.sq_pad + m0;
        const uint32_t rows = base + S::kRowsOff + s * S::kRows;
        bulk_load(rows, p.lse + row, kTile * 4, full(s));
        bulk_load(rows + kTile * 4, p.delta + row, kTile * 4, full(s));
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int ct = threadIdx.x - 128, wg = ct >> 7, wi = (ct >> 5) & 3, lane = ct & 31;
    const int g = lane >> 2, t = lane & 3, tid = ct & 127;

    float dk[D / 4], dv[D / 4];  // keys n0 + 16 wi + g (+ 8), columns 128 wg ...
#pragma unroll
    for (int i = 0; i < D / 4; ++i) dk[i] = dv[i] = 0.f;
    if (total > 0) mbar_wait(kv_full, 0);

    for (int it = 0; it < total; ++it) {
      const int st = it % kStages256;
      const int m0 = m_begin + (it0 + it) % nm * kTile;
      unsigned char* xp = gbase + S::kXchgOff + (it & 1) * S::kXchgBuf;  // P^T
      unsigned char* xs = xp + 2 * kXchgPart;                            // dS^T
      mbar_wait(full(st), (it / kStages256) & 1);
      const bool edge = !tile_full(p, m0, n0, offset);
      // S^T = K Q^T and dP^T = V dO^T over this consumer's 32 rows: 64 keys
      // x 32 rows, two groups, so that P^T is computed while dP^T runs.
      const uint32_t qh = sQ(st) + wg * 32 * 128, oh = sO(st) + wg * 32 * 128;
      float s[16], dp[16];
      wgmma_fence();
      wgmma_ss<T, 32, false>(s, kmajor(sK, 0, kBox), kmajor(qh, 0, kBox));
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk)
        wgmma_ss<T, 32, true>(s, kmajor(sK, kk, kBox), kmajor(qh, kk, kBox));
      wgmma_commit();
      wgmma_ss<T, 32, false>(dp, kmajor(sV, 0, kBox), kmajor(oh, 0, kBox));
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk)
        wgmma_ss<T, 32, true>(dp, kmajor(sV, kk, kBox), kmajor(oh, kk, kBox));
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);

      // P^T = exp2(S^T * scale_log2 - lse) on visible pairs. Element 4 j + e:
      // key n0 + 16 wi + g + 8 (e >> 1), row m0 + 32 wg + 8 j + 2 t + (e & 1).
      const float* rows =
          reinterpret_cast<const float*>(gbase + S::kRowsOff + st * S::kRows) + 32 * wg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(rows + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          float pr = exp2f(s[i] * p.scale_log2 - ((e & 1) ? l.y : l.x));
          if (edge && !visible(p, m0 + 32 * wg + 8 * j + 2 * t + (e & 1),
                               n0 + 16 * wi + g + 8 * (e >> 1), offset))
            pr = 0.f;
          s[i] = pr;
        }
      }
      uint32_t half[2][4];
      to_a<T>(s, half);
      xchg_put(xp, wg, tid, half);
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(rows + kTile + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? dl.y : dl.x));
      }
      to_a<T>(dp, half);
      xchg_put(xs, wg, tid, half);
      consumers_sync();

      // dV += P^T dO and dK += dS^T Q over the tile's 64 rows and this
      // consumer's 128 columns, dO and Q MN-major from the stage.
      uint32_t pa[4][4], sa[4][4];
      xchg_get(xp, tid, pa);
      xchg_get(xs, tid, sa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<T, 128, true>(dv, pa[kk], mnmajor(sO(st) + wg * 2 * kBox, kk, kBox), 1);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<T, 128, true>(dk, sa[kk], mnmajor(sQ(st) + wg * 2 * kBox, kk, kBox), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]), fence_regs(sa[kk]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }

    // This consumer's half of rows of d columns: at d 136-248 the second
    // half is partial, its columns past d (zeros) not stored.
    const int d = kPad ? p.d : D, cols = d - 128 * wg;
    const int64_t out = (static_cast<int64_t>(b) * p.hkv + hk) * p.skv * d + 128 * wg;
    const int64_t part = static_cast<int64_t>(p.batch) * p.hkv * p.skv * d;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = n0 + 16 * wi + g + 8 * r, col = 8 * j + 2 * t;
        if (key < p.skv && (!kPad || col < cols)) {
          const int64_t at = out + static_cast<int64_t>(key) * d + col;
          const int e = 4 * j + 2 * r;
          if (p.splits > 1) {  // fp32 partials, added by flash_bwd_dkv_combine
            *reinterpret_cast<float2*>(p.ws + split * part + at) = make_float2(dk[e], dk[e + 1]);
            *reinterpret_cast<float2*>(p.ws + (p.splits + split) * part + at) =
                make_float2(dv[e], dv[e + 1]);
          } else {
            *reinterpret_cast<uint32_t*>(static_cast<T*>(p.out0) + at) =
                Elem<T>::pack(dk[e] * p.scale, dk[e + 1] * p.scale);
            *reinterpret_cast<uint32_t*>(static_cast<T*>(p.out1) + at) =
                Elem<T>::pack(dv[e], dv[e + 1]);
          }
        }
      }
    }
  }
}

// B13b at D 256: dQ of 64 rows of one q head.
template <typename T, bool kPad>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel_d256(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap omap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap, const BwdParams p) {
  using S = Smem256<false>;
  constexpr int D = 256;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem + (base - raw);
  const uint32_t sQ = base, sO = base + 4 * kBox, sK0 = base + S::kFixed;
  const uint32_t bars = base + S::kBars;
  const uint32_t q_full = bars;
  auto sK = [&](int s) { return sK0 + s * S::kStage; };
  auto sV = [&](int s) { return sK0 + s * S::kStage + 4 * kBox; };
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages256 + s); };

  const int per = p.hq * p.batch;
  const int nqb = (p.sq + kTile - 1) / kTile;
  const int m0 = (nqb - 1 - static_cast<int>(blockIdx.x) / per) * kTile;  // most keys first
  const int h = blockIdx.x % per % p.hq, b = blockIdx.x % per / p.hq, hk = h / p.group;
  const int offset = p.skv - p.sq;

  // Keys from the window's near edge (row m0's first visible key) to the
  // causal edge of the block's last row within Sq.
  int n_end = p.skv;
  if (p.causal) n_end = min(n_end, min(m0 + kTile, p.sq) + offset);
  const int n_begin = (p.window > 0 ? max(0, m0 + offset - p.window + 1) : 0) / kTile * kTile;
  const int total = n_end > n_begin ? (n_end - n_begin + kTile - 1) / kTile : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages256; ++s) mbar_init(full(s), 1), mbar_init(empty(s), 8);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0 && total > 0) {
      mbar_expect_tx(q_full, S::kFixed + S::kRows);
      for (int hh = 0; hh < 4; ++hh) {
        tma_load_4d(sQ + hh * kBox, &qmap, 64 * hh, m0, h, b, q_full);
        tma_load_4d(sO + hh * kBox, &omap, 64 * hh, m0, h, b, q_full);
      }
      const int64_t row = (static_cast<int64_t>(b) * p.hq + h) * p.sq_pad + m0;
      bulk_load(base + S::kRowsOff, p.lse + row, kTile * 4, q_full);
      bulk_load(base + S::kRowsOff + kTile * 4, p.delta + row, kTile * 4, q_full);
      for (int it = 0; it < total; ++it) {
        const int s = it % kStages256, n0 = n_begin + it * kTile;
        mbar_wait(empty(s), ((it / kStages256) & 1) ^ 1);
        mbar_expect_tx(full(s), S::kStage);
        for (int hh = 0; hh < 4; ++hh) {
          tma_load_4d(sK(s) + hh * kBox, &kmap, 64 * hh, n0, hk, b, full(s));
          tma_load_4d(sV(s) + hh * kBox, &vmap, 64 * hh, n0, hk, b, full(s));
        }
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int ct = threadIdx.x - 128, wg = ct >> 7, wi = (ct >> 5) & 3, lane = ct & 31;
    const int g = lane >> 2, t = lane & 3, tid = ct & 127;

    float dq[D / 4];  // rows m0 + 16 wi + g (+ 8), columns 128 wg ...
#pragma unroll
    for (int i = 0; i < D / 4; ++i) dq[i] = 0.f;
    float row_lse[2] = {INFINITY, INFINITY}, row_delta[2] = {0.f, 0.f};
    if (total > 0) {
      mbar_wait(q_full, 0);
      const float* rows = reinterpret_cast<const float*>(gbase + S::kRowsOff);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        row_lse[r] = rows[16 * wi + g + 8 * r];
        row_delta[r] = rows[kTile + 16 * wi + g + 8 * r];
      }
    }

    for (int it = 0; it < total; ++it) {
      const int st = it % kStages256, n0 = n_begin + it * kTile;
      unsigned char* xs = gbase + S::kXchgOff + (it & 1) * S::kXchgBuf;
      mbar_wait(full(st), (it / kStages256) & 1);
      const bool edge = !tile_full(p, m0, n0, offset);
      // S = Q K^T and dP = dO V^T over this consumer's 32 keys: 64 rows x
      // 32 keys, two groups, so that P is computed while dP runs.
      const uint32_t kh = sK(st) + wg * 32 * 128, vh = sV(st) + wg * 32 * 128;
      float s[16], dp[16];
      wgmma_fence();
      wgmma_ss<T, 32, false>(s, kmajor(sQ, 0, kBox), kmajor(kh, 0, kBox));
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk)
        wgmma_ss<T, 32, true>(s, kmajor(sQ, kk, kBox), kmajor(kh, kk, kBox));
      wgmma_commit();
      wgmma_ss<T, 32, false>(dp, kmajor(sO, 0, kBox), kmajor(vh, 0, kBox));
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk)
        wgmma_ss<T, 32, true>(dp, kmajor(sO, kk, kBox), kmajor(vh, kk, kBox));
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);

      // P = exp2(S * scale_log2 - lse) on visible pairs, then dS = P (dP -
      // delta). Element 4 j + e: row m0 + 16 wi + g + 8 (e >> 1), key n0 +
      // 32 wg + 8 j + 2 t + (e & 1).
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e, r = e >> 1;
          float pr = exp2f(s[i] * p.scale_log2 - row_lse[r]);
          if (edge && !visible(p, m0 + 16 * wi + g + 8 * r, n0 + 32 * wg + 8 * j + 2 * t + (e & 1),
                               offset))
            pr = 0.f;
          s[i] = pr;
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < 16; ++i) dp[i] = s[i] * (dp[i] - row_delta[(i >> 1) & 1]);
      uint32_t half[2][4];
      to_a<T>(dp, half);
      xchg_put(xs, wg, tid, half);
      consumers_sync();

      // dQ += dS K over the tile's 64 keys and this consumer's 128 columns,
      // K MN-major from the stage.
      uint32_t sa[4][4];
      xchg_get(xs, tid, sa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<T, 128, true>(dq, sa[kk], mnmajor(sK(st) + wg * 2 * kBox, kk, kBox), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(sa[kk]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }

    // This consumer's half of rows of d columns, as flash_bwd_dkv_kernel_d256.
    const int d = kPad ? p.d : D, cols = d - 128 * wg;
    T* dqp = static_cast<T*>(p.out0) + (static_cast<int64_t>(b) * p.hq + h) * p.sq * d + 128 * wg;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + 16 * wi + g + 8 * r, col = 8 * j + 2 * t;
        if (row < p.sq && (!kPad || col < cols))
          *reinterpret_cast<uint32_t*>(dqp + static_cast<int64_t>(row) * d + col) =
              Elem<T>::pack(dq[4 * j + 2 * r] * p.scale, dq[4 * j + 2 * r + 1] * p.scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Head dims 257-512 (DeepSeek-V4-Flash's 512): B13a and B13b laid out anew
// once more. At D 512 a 64-row tile of one operand is 64 KB, so D 256's
// layout would need 128 KB for B13a's fixed K and V plus 128 KB for one (Q,
// dO) stage, and its dK, dV of 64 keys x 512 in fp32 would take 256 KB,
// the SM's whole register file. Here (bytes of shared memory, fp32
// registers a consumer thread):
//
//   * B13a, the forward's wide layout (attention_wgmma.cuh Tiles<512>): two
//     blocks a 64-key block, `chunk` 0 and 1 (grid y folded into the grid),
//     each for 256 of dK's and dV's columns; consumer c owns 128 of them,
//     dK and dV of 64 keys x 128 columns: 64 + 64 registers, as at D 256.
//     Each block holds K and V of its 64 keys over the whole depth (2 x 64
//     KB) and recomputes S^T = K Q^T and dP^T = V dO^T over depth 512 (4 D
//     operations a pair) beside dV's and dK's products over its 256
//     columns (2 D): 6 D a block, 12 D for the two where the bound counts
//     8 D. The (Q, dO) tiles are 32 rows: consumer c computes
//     rows 16 c ... of S^T and dP^T (m64n16, 64 keys x 16 rows), and the
//     two exchange their k-step of P^T and dS^T (2 KB each) through shared
//     memory, double buffered by tile parity, as at D 256. A tile arrives
//     in two depth halves of 32 rows x 256 columns (2 x 16 KB), each in a
//     slot of its own: slot 0 the half outside the chunk, read only by S^T
//     and dP^T and released as soon as they are done, slot 1 the chunk's
//     half (and the 32 rows of lse and delta), also the B operand of dV +=
//     P^T dO and dK += dS^T Q. So the next tile's first half loads while
//     this tile's exchange and its dV / dK products run, and its second
//     half while the first half's products run. Shared memory: 1 KB of
//     alignment + 128 KB (K, V) + 64 KB (two slots) + 256 (lse, delta) +
//     16 KB (exchange) + 40 (barriers) = 214,312 bytes.
//   * B13b: a block per 64 q rows, whose Q and dO (2 x 64 KB) stay; (K, V)
//     tiles of 16 keys (2 x 16 KB) stream through two stages. Consumer c
//     owns dQ's columns 256 c ...: 64 rows x 256 = 128 registers. Both
//     consumers need all of S and dP (64 rows x 16 keys), the A operand of
//     dQ += dS K, so they split the depth: consumer c computes S and dP over
//     depth half c (m64n16, 16 k-steps), writes its fp32 partials (16 a
//     thread) to shared memory and adds the other's, in the same order on
//     both (a + b = b + a in fp32), so both hold the same bits. No
//     operation is recomputed: 6 D a pair, as the bound counts. Shared
//     memory: 1 KB + 128 KB (Q, dO) + 64 KB (two stages) + 512 (lse, delta)
//     + 32 KB (partials, double buffered by tile parity) + 40 = 230,952
//     bytes.
//   * Every d from 257 to 511 runs these kernels' kPad instantiations: TMA
//     reads zeros past d (a box wholly past it reads only zeros, and
//     credits its bytes all the same), and the stores stop at the pitch.
//   * The walks, the splits of B13a (fp32 partials over both chunks'
//     columns, the same combine pass), the fixed summation order, the edge
//     masks and the heaviest-first order are those of D 256.

constexpr int kRows512 = 32;  // q rows of a B13a tile
constexpr int kKeys512 = 16;  // keys of a B13b tile
constexpr int kBoxQ512 = kRows512 * 128;  // one 64-column box of a 32-row tile
constexpr int kBoxK512 = kKeys512 * 128;  // of a 16-key tile
constexpr int kChunks512 = 2;             // B13a blocks a key block: 256 columns each

// Every pair of the kM rows x kN keys from (m0, n0) is visible.
template <int kM, int kN>
__device__ __forceinline__ bool rect_full(const BwdParams& p, int m0, int n0, int offset) {
  return m0 + kM <= p.sq && n0 + kN <= p.skv && (!p.causal || n0 + kN - 1 <= m0 + offset) &&
         (p.window <= 0 || n0 > m0 + kM - 1 + offset - p.window);
}

struct Dkv512Smem {
  static constexpr int kFixed = 2 * 8 * kBox;         // K, V: 64 keys x 512
  static constexpr int kHalf = 2 * 4 * kBoxQ512;      // a slot: Q, dO of 32 rows x 256
  static constexpr int kRowsOff = kFixed + 2 * kHalf;
  static constexpr int kRows = 2 * kRows512 * 4;      // lse, delta of 32 rows
  static constexpr int kXchgPart = 128 * 16;          // one k-step of A fragments
  static constexpr int kXchgBuf = 2 * 2 * kXchgPart;  // P^T and dS^T, two k-steps each
  static constexpr int kXchgOff = kRowsOff + kRows;
  static constexpr int kBars = kXchgOff + 2 * kXchgBuf;
  static constexpr int kBytes = 1024 + kBars + 5 * 8;  // kv_full, full and empty of 2 slots
};
struct Dq512Smem {
  static constexpr int kFixed = 2 * 8 * kBox;          // Q, dO: 64 rows x 512
  static constexpr int kStage = 2 * 8 * kBoxK512;      // K, V: 16 keys x 512
  static constexpr int kRowsOff = kFixed + kStages256 * kStage;
  static constexpr int kRows = 2 * kTile * 4;          // lse, delta of 64 rows
  static constexpr int kXchgBuf = 2 * 128 * 16 * 4;    // both consumers' partials, 64 B a thread
  static constexpr int kXchgOff = kRowsOff + kRows;
  static constexpr int kBars = kXchgOff + 2 * kXchgBuf;
  static constexpr int kBytes = 1024 + kBars + (1 + 2 * kStages256) * 8;
};
static_assert(Dkv512Smem::kBytes <= 232448 && Dq512Smem::kBytes <= 232448,
              "D-512 backward tiles exceed the H100's 227 KB a block");

// B13a at D 512: dK, dV of 64 keys and 256 columns (`chunk`) of one kv
// head, summed over its group.
template <typename T, bool kPad>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel_d512(const __grid_constant__ CUtensorMap qmap,
                              const __grid_constant__ CUtensorMap omap,
                              const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap, const BwdParams p) {
  using S = Dkv512Smem;
  constexpr int D = 512;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem + (base - raw);
  const uint32_t sK = base, sV = base + 8 * kBox;
  auto sQ = [&](int slot) { return base + S::kFixed + slot * S::kHalf; };
  auto sO = [&](int slot) { return base + S::kFixed + slot * S::kHalf + 4 * kBoxQ512; };
  const uint32_t bars = base + S::kBars;
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (3 + s); };

  const int heads = p.hkv * p.batch, per = heads * p.splits * kChunks512;
  const int n0 = (blockIdx.x / per) * kTile;  // the keys with the most causal rows first
  const int r = blockIdx.x % per;
  const int chunk = r / (heads * p.splits), split = r % (heads * p.splits) / heads;
  const int hb = r % heads, hk = hb % p.hkv, b = hb / p.hkv;
  const int other = 1 - chunk;  // the depth half outside the chunk, slot 0
  const int offset = p.skv - p.sq;

  // The q rows that see a key of the block, as in flash_bwd_dkv_kernel.
  int m_begin = p.causal ? max(0, n0 - offset) : 0;
  int m_end = p.sq;
  if (p.window > 0) m_end = min(m_end, min(n0 + kTile, p.skv) - 1 - offset + p.window);
  m_begin = m_begin / kRows512 * kRows512;
  const int nm = m_end > m_begin ? (m_end - m_begin + kRows512 - 1) / kRows512 : 0;
  const int it0 = nm * p.group * split / p.splits, it1 = nm * p.group * (split + 1) / p.splits;
  const int total = it1 - it0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < 2; ++s) mbar_init(full(s), 1), mbar_init(empty(s), 8);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0 && total > 0) {
      mbar_expect_tx(kv_full, S::kFixed);
      for (int h = 0; h < 8; ++h) {
        tma_load_4d(sK + h * kBox, &kmap, 64 * h, n0, hk, b, kv_full);
        tma_load_4d(sV + h * kBox, &vmap, 64 * h, n0, hk, b, kv_full);
      }
      for (int it = 0; it < total; ++it) {
        const int h = hk * p.group + (it0 + it) / nm;
        const int m0 = m_begin + (it0 + it) % nm * kRows512;
        for (int slot = 0; slot < 2; ++slot) {
          const int col0 = 256 * (slot ? chunk : other);
          mbar_wait(empty(slot), (it & 1) ^ 1);
          mbar_expect_tx(full(slot), S::kHalf + (slot ? S::kRows : 0));
          for (int hh = 0; hh < 4; ++hh) {
            tma_load_4d(sQ(slot) + hh * kBoxQ512, &qmap, col0 + 64 * hh, m0, h, b, full(slot));
            tma_load_4d(sO(slot) + hh * kBoxQ512, &omap, col0 + 64 * hh, m0, h, b, full(slot));
          }
        }
        const int64_t row = (static_cast<int64_t>(b) * p.hq + h) * p.sq_pad + m0;
        bulk_load(base + S::kRowsOff, p.lse + row, kRows512 * 4, full(1));
        bulk_load(base + S::kRowsOff + kRows512 * 4, p.delta + row, kRows512 * 4, full(1));
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int ct = threadIdx.x - 128, wg = ct >> 7, wi = (ct >> 5) & 3, lane = ct & 31;
    const int g = lane >> 2, t = lane & 3, tid = ct & 127;

    float dk[64], dv[64];  // keys n0 + 16 wi + g (+ 8), columns 256 chunk + 128 wg ...
#pragma unroll
    for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
    if (total > 0) mbar_wait(kv_full, 0);

    for (int it = 0; it < total; ++it) {
      const int ph = it & 1;
      const int m0 = m_begin + (it0 + it) % nm * kRows512;
      unsigned char* xp = gbase + S::kXchgOff + ph * S::kXchgBuf;  // P^T
      unsigned char* xs = xp + 2 * S::kXchgPart;                  // dS^T
      const bool edge = !rect_full<kRows512, kTile>(p, m0, n0, offset);
      // S^T = K Q^T and dP^T = V dO^T over this consumer's 16 rows (64 keys
      // x 16 rows, depth 512): slot 0's half, then slot 1's; S^T's last
      // products and dP^T's second half are groups of their own, so that P^T
      // is computed while dP^T runs.
      const uint32_t q0 = sQ(0) + wg * 16 * 128, o0 = sO(0) + wg * 16 * 128;
      const uint32_t q1 = sQ(1) + wg * 16 * 128, o1 = sO(1) + wg * 16 * 128;
      float s[8], dp[8];
      mbar_wait(full(0), ph);
      wgmma_fence();
      wgmma_ss<T, 16, false>(s, kmajor(sK, 16 * other, kBox), kmajor(q0, 0, kBoxQ512));
#pragma unroll
      for (int kk = 1; kk < 16; ++kk)
        wgmma_ss<T, 16, true>(s, kmajor(sK, 16 * other + kk, kBox), kmajor(q0, kk, kBoxQ512));
      wgmma_ss<T, 16, false>(dp, kmajor(sV, 16 * other, kBox), kmajor(o0, 0, kBoxQ512));
#pragma unroll
      for (int kk = 1; kk < 16; ++kk)
        wgmma_ss<T, 16, true>(dp, kmajor(sV, 16 * other + kk, kBox), kmajor(o0, kk, kBoxQ512));
      wgmma_commit();
      mbar_wait(full(1), ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 16; ++kk)
        wgmma_ss<T, 16, true>(s, kmajor(sK, 16 * chunk + kk, kBox), kmajor(q1, kk, kBoxQ512));
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 16; ++kk)
        wgmma_ss<T, 16, true>(dp, kmajor(sV, 16 * chunk + kk, kBox), kmajor(o1, kk, kBoxQ512));
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);

      // P^T = exp2(S^T * scale_log2 - lse) on visible pairs. Element 4 j + e:
      // key n0 + 16 wi + g + 8 (e >> 1), row m0 + 16 wg + 8 j + 2 t + (e & 1).
      const float* rows = reinterpret_cast<const float*>(gbase + S::kRowsOff) + 16 * wg;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(rows + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          float pr = exp2f(s[i] * p.scale_log2 - ((e & 1) ? l.y : l.x));
          if (edge && !visible(p, m0 + 16 * wg + 8 * j + 2 * t + (e & 1),
                               n0 + 16 * wi + g + 8 * (e >> 1), offset))
            pr = 0.f;
          s[i] = pr;
        }
      }
      uint32_t step[1][4];
      to_a<T>(s, step);
      *reinterpret_cast<uint4*>(xp + wg * S::kXchgPart + tid * 16) =
          make_uint4(step[0][0], step[0][1], step[0][2], step[0][3]);
      wgmma_wait<0>();
      fence_regs(dp);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(0));  // slot 0 has no reader left
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(rows + kRows512 + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? dl.y : dl.x));
      }
      to_a<T>(dp, step);
      *reinterpret_cast<uint4*>(xs + wg * S::kXchgPart + tid * 16) =
          make_uint4(step[0][0], step[0][1], step[0][2], step[0][3]);
      consumers_sync();

      // dV += P^T dO and dK += dS^T Q over the tile's 32 rows and this
      // consumer's 128 columns of the chunk, dO and Q MN-major from slot 1.
      uint32_t pa[2][4], sa[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint4 a = *reinterpret_cast<const uint4*>(xp + kk * S::kXchgPart + tid * 16);
        const uint4 c = *reinterpret_cast<const uint4*>(xs + kk * S::kXchgPart + tid * 16);
        pa[kk][0] = a.x, pa[kk][1] = a.y, pa[kk][2] = a.z, pa[kk][3] = a.w;
        sa[kk][0] = c.x, sa[kk][1] = c.y, sa[kk][2] = c.z, sa[kk][3] = c.w;
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        wgmma_rs<T, 128, true>(dv, pa[kk], mnmajor(sO(1) + wg * 2 * kBoxQ512, kk, kBoxQ512), 1);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        wgmma_rs<T, 128, true>(dk, sa[kk], mnmajor(sQ(1) + wg * 2 * kBoxQ512, kk, kBoxQ512), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) fence_regs(pa[kk]), fence_regs(sa[kk]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(1));
    }

    // This consumer's 128 columns of rows of d columns: at d 257-511 they
    // may be partial or wholly past d (zeros, not stored).
    const int d = kPad ? p.d : D, cols = d - 256 * chunk - 128 * wg;
    const int64_t out =
        (static_cast<int64_t>(b) * p.hkv + hk) * p.skv * d + 256 * chunk + 128 * wg;
    const int64_t part = static_cast<int64_t>(p.batch) * p.hkv * p.skv * d;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int key = n0 + 16 * wi + g + 8 * rr, col = 8 * j + 2 * t;
        if (key < p.skv && (!kPad || col < cols)) {
          const int64_t at = out + static_cast<int64_t>(key) * d + col;
          const int e = 4 * j + 2 * rr;
          if (p.splits > 1) {  // fp32 partials, added by flash_bwd_dkv_combine
            *reinterpret_cast<float2*>(p.ws + split * part + at) = make_float2(dk[e], dk[e + 1]);
            *reinterpret_cast<float2*>(p.ws + (p.splits + split) * part + at) =
                make_float2(dv[e], dv[e + 1]);
          } else {
            *reinterpret_cast<uint32_t*>(static_cast<T*>(p.out0) + at) =
                Elem<T>::pack(dk[e] * p.scale, dk[e + 1] * p.scale);
            *reinterpret_cast<uint32_t*>(static_cast<T*>(p.out1) + at) =
                Elem<T>::pack(dv[e], dv[e + 1]);
          }
        }
      }
    }
  }
}

// B13b at D 512: dQ of 64 rows of one q head.
template <typename T, bool kPad>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel_d512(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap omap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap, const BwdParams p) {
  using S = Dq512Smem;
  constexpr int D = 512;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem + (base - raw);
  const uint32_t sQ = base, sO = base + 8 * kBox, sK0 = base + S::kFixed;
  const uint32_t bars = base + S::kBars;
  const uint32_t q_full = bars;
  auto sK = [&](int s) { return sK0 + s * S::kStage; };
  auto sV = [&](int s) { return sK0 + s * S::kStage + 8 * kBoxK512; };
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages256 + s); };

  const int per = p.hq * p.batch;
  const int nqb = (p.sq + kTile - 1) / kTile;
  const int m0 = (nqb - 1 - static_cast<int>(blockIdx.x) / per) * kTile;  // most keys first
  const int h = blockIdx.x % per % p.hq, b = blockIdx.x % per / p.hq, hk = h / p.group;
  const int offset = p.skv - p.sq;

  // Keys from the window's near edge to the causal edge of the block's last
  // row within Sq, as in flash_bwd_dq_kernel_d256, in tiles of 16.
  int n_end = p.skv;
  if (p.causal) n_end = min(n_end, min(m0 + kTile, p.sq) + offset);
  const int n_begin =
      (p.window > 0 ? max(0, m0 + offset - p.window + 1) : 0) / kKeys512 * kKeys512;
  const int total = n_end > n_begin ? (n_end - n_begin + kKeys512 - 1) / kKeys512 : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages256; ++s) mbar_init(full(s), 1), mbar_init(empty(s), 8);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0 && total > 0) {
      mbar_expect_tx(q_full, S::kFixed + S::kRows);
      for (int hh = 0; hh < 8; ++hh) {
        tma_load_4d(sQ + hh * kBox, &qmap, 64 * hh, m0, h, b, q_full);
        tma_load_4d(sO + hh * kBox, &omap, 64 * hh, m0, h, b, q_full);
      }
      const int64_t row = (static_cast<int64_t>(b) * p.hq + h) * p.sq_pad + m0;
      bulk_load(base + S::kRowsOff, p.lse + row, kTile * 4, q_full);
      bulk_load(base + S::kRowsOff + kTile * 4, p.delta + row, kTile * 4, q_full);
      for (int it = 0; it < total; ++it) {
        const int s = it % kStages256, n0 = n_begin + it * kKeys512;
        mbar_wait(empty(s), ((it / kStages256) & 1) ^ 1);
        mbar_expect_tx(full(s), S::kStage);
        for (int hh = 0; hh < 8; ++hh) {
          tma_load_4d(sK(s) + hh * kBoxK512, &kmap, 64 * hh, n0, hk, b, full(s));
          tma_load_4d(sV(s) + hh * kBoxK512, &vmap, 64 * hh, n0, hk, b, full(s));
        }
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int ct = threadIdx.x - 128, wg = ct >> 7, wi = (ct >> 5) & 3, lane = ct & 31;
    const int g = lane >> 2, t = lane & 3, tid = ct & 127;

    float dq[2][64];  // rows m0 + 16 wi + g (+ 8), columns 256 wg + 128 i ...
#pragma unroll
    for (int i = 0; i < 64; ++i) dq[0][i] = dq[1][i] = 0.f;
    float row_lse[2] = {INFINITY, INFINITY}, row_delta[2] = {0.f, 0.f};
    if (total > 0) {
      mbar_wait(q_full, 0);
      const float* rows = reinterpret_cast<const float*>(gbase + S::kRowsOff);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        row_lse[r] = rows[16 * wi + g + 8 * r];
        row_delta[r] = rows[kTile + 16 * wi + g + 8 * r];
      }
    }

    for (int it = 0; it < total; ++it) {
      const int st = it % kStages256, n0 = n_begin + it * kKeys512;
      unsigned char* xb = gbase + S::kXchgOff + (it & 1) * S::kXchgBuf;
      mbar_wait(full(st), (it / kStages256) & 1);
      const bool edge = !rect_full<kTile, kKeys512>(p, m0, n0, offset);
      // This consumer's depth half of S = Q K^T and dP = dO V^T (64 rows x
      // 16 keys), two groups, so that S's partial is written while dP runs.
      float s[8], dp[8];
      wgmma_fence();
      wgmma_ss<T, 16, false>(s, kmajor(sQ, 16 * wg, kBox), kmajor(sK(st), 16 * wg, kBoxK512));
#pragma unroll
      for (int kk = 1; kk < 16; ++kk)
        wgmma_ss<T, 16, true>(s, kmajor(sQ, 16 * wg + kk, kBox),
                              kmajor(sK(st), 16 * wg + kk, kBoxK512));
      wgmma_commit();
      wgmma_ss<T, 16, false>(dp, kmajor(sO, 16 * wg, kBox), kmajor(sV(st), 16 * wg, kBoxK512));
#pragma unroll
      for (int kk = 1; kk < 16; ++kk)
        wgmma_ss<T, 16, true>(dp, kmajor(sO, 16 * wg + kk, kBox),
                              kmajor(sV(st), 16 * wg + kk, kBoxK512));
      wgmma_commit();
      // Partials as float4 k of thread tid at (4 wg + k) * 2 KB + 16 tid
      // (k 0-1: S, 2-3: dP), so that a warp's stores fill whole banks.
      unsigned char* mine = xb + wg * 4 * 128 * 16 + tid * 16;
      const unsigned char* theirs = xb + (1 - wg) * 4 * 128 * 16 + tid * 16;
      wgmma_wait<1>();
      fence_regs(s);
#pragma unroll
      for (int k = 0; k < 2; ++k)
        *reinterpret_cast<float4*>(mine + k * 128 * 16) =
            make_float4(s[4 * k], s[4 * k + 1], s[4 * k + 2], s[4 * k + 3]);
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int k = 0; k < 2; ++k)
        *reinterpret_cast<float4*>(mine + (2 + k) * 128 * 16) =
            make_float4(dp[4 * k], dp[4 * k + 1], dp[4 * k + 2], dp[4 * k + 3]);
      consumers_sync();
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float4 os = *reinterpret_cast<const float4*>(theirs + k * 128 * 16);
        const float4 od = *reinterpret_cast<const float4*>(theirs + (2 + k) * 128 * 16);
        s[4 * k] += os.x, s[4 * k + 1] += os.y, s[4 * k + 2] += os.z, s[4 * k + 3] += os.w;
        dp[4 * k] += od.x, dp[4 * k + 1] += od.y, dp[4 * k + 2] += od.z, dp[4 * k + 3] += od.w;
      }

      // P = exp2(S * scale_log2 - lse) on visible pairs, then dS = P (dP -
      // delta). Element 4 j + e: row m0 + 16 wi + g + 8 (e >> 1), key n0 +
      // 8 j + 2 t + (e & 1).
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e, r = e >> 1;
          float pr = exp2f(s[i] * p.scale_log2 - row_lse[r]);
          if (edge && !visible(p, m0 + 16 * wi + g + 8 * r, n0 + 8 * j + 2 * t + (e & 1), offset))
            pr = 0.f;
          dp[i] = pr * (dp[i] - row_delta[r]);
        }
      }
      uint32_t sa[1][4];
      to_a<T>(dp, sa);

      // dQ += dS K over the tile's 16 keys and this consumer's 256 columns,
      // K MN-major from the stage.
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wgmma_rs<T, 128, true>(dq[i], sa[0], mnmajor(sK(st) + (4 * wg + 2 * i) * kBoxK512, 0,
                                                     kBoxK512), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq[0]);
      fence_regs(dq[1]);
      fence_regs(sa[0]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }

    // This consumer's 256 columns of rows of d columns, as B13a's.
    const int d = kPad ? p.d : D;
    T* dqp = static_cast<T*>(p.out0) + (static_cast<int64_t>(b) * p.hq + h) * p.sq * d;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = m0 + 16 * wi + g + 8 * r, col = 256 * wg + 128 * i + 8 * j + 2 * t;
          if (row < p.sq && (!kPad || col < d))
            *reinterpret_cast<uint32_t*>(dqp + static_cast<int64_t>(row) * d + col) =
                Elem<T>::pack(dq[i][4 * j + 2 * r] * p.scale, dq[i][4 * j + 2 * r + 1] * p.scale);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side.

struct BwdViews {
  const void *q, *k, *v, *dout;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  int d, dtype;
};

template <typename T, int D, bool kDkv, bool kPad>
auto bwd_kernel() {
  if constexpr (D == 512)
    return kDkv ? flash_bwd_dkv_kernel_d512<T, kPad> : flash_bwd_dq_kernel_d512<T, kPad>;
  else if constexpr (D == 256)
    return kDkv ? flash_bwd_dkv_kernel_d256<T, kPad> : flash_bwd_dq_kernel_d256<T, kPad>;
  else return kDkv ? flash_bwd_dkv_kernel<T, D, kPad> : flash_bwd_dq_kernel<T, D, kPad>;
}
template <int D, bool kDkv>
constexpr int bwd_smem() {
  if constexpr (D == 512) return kDkv ? Dkv512Smem::kBytes : Dq512Smem::kBytes;
  else if constexpr (D == 256) return Smem256<kDkv>::kBytes;
  else return kDkv ? DkvSmem<D>::kBytes : DqSmem<D>::kBytes;
}

template <typename T, int D, bool kDkv, bool kPad>
int launch_bwd(const BwdParams& p, const BwdViews& w, cudaStream_t stream) {
  constexpr int kSmem = bwd_smem<D, kDkv>();
  const auto kernel = bwd_kernel<T, D, kDkv, kPad>();
  static const int configured = allow_smem(kernel, kSmem);  // above 48 KB needs an opt-in
  if (configured != cudaSuccess) return configured;
  // Rows of a block: 128 keys (B13a) or q rows (B13b), 64 of both at D 256
  // and 512; rows of a streamed tile: 64, at D 512 32 q rows (B13a) or 16
  // keys (B13b). At D 512 B13a runs kChunks512 blocks a key block.
  constexpr int block = D >= 256 ? kTile : kBlock;
  constexpr int q_tile = D == 512 ? kRows512 : kTile, kv_tile = D == 512 ? kKeys512 : kTile;
  constexpr int chunks = D == 512 ? kChunks512 : 1;
  const int q_rows = kDkv ? q_tile : block, kv_rows = kDkv ? block : kv_tile;
  // The maps hold the true d columns: a box reads zeros past them.
  CUtensorMap qmap, omap, kmap, vmap;
  BwdParams kp = p;
  kp.d = row_pitch(p.d);  // the outputs' row pitch
  if (!head_map(&qmap, w.dtype, w.q, p.batch, p.hq, p.sq, p.d, w.q_sb, w.q_sh, w.q_ss, q_rows) ||
      !head_map(&omap, w.dtype, w.dout, p.batch, p.hq, p.sq, p.d, w.o_sb, w.o_sh, w.o_ss, q_rows) ||
      !head_map(&kmap, w.dtype, w.k, p.batch, p.hkv, p.skv, p.d, w.k_sb, w.k_sh, w.k_ss, kv_rows) ||
      !head_map(&vmap, w.dtype, w.v, p.batch, p.hkv, p.skv, p.d, w.v_sb, w.v_sh, w.v_ss, kv_rows))
    return cudaErrorInvalidValue;
  const long long blocks =
      kDkv ? static_cast<long long>((p.skv + block - 1) / block) * p.hkv * p.batch * p.splits *
                 chunks
           : static_cast<long long>((p.sq + block - 1) / block) * p.hq * p.batch;
  if (blocks <= 0) return cudaSuccess;
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kThreads, kSmem, stream>>>(qmap, omap, kmap, vmap, kp);
  if (!kDkv || p.splits == 1) return cudaGetLastError();
  const int64_t part = static_cast<int64_t>(p.batch) * p.hkv * p.skv * kp.d;
  const unsigned combine_blocks = static_cast<unsigned>((part / 4 + 255) / 256);
  flash_bwd_dkv_combine<T><<<combine_blocks, 256, 0, stream>>>(kp, part);
  return cudaGetLastError();
}

template <typename T, int D, bool kDkv>
int launch_layout(const BwdParams& p, const BwdViews& w, cudaStream_t s) {
  return row_pitch(p.d) < D ? launch_bwd<T, D, kDkv, true>(p, w, s)
                            : launch_bwd<T, D, kDkv, false>(p, w, s);
}

// d runs in the layout of padded_head_dim(d), padded where its pitch is
// below the layout's D.
template <bool kDkv>
int dispatch_bwd(const BwdParams& p, const BwdViews& w, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  using h16 = __half;
  const int layout = padded_head_dim(w.d, true);
  if (w.dtype == kBF16 && layout == 64) return launch_layout<bf16, 64, kDkv>(p, w, s);
  if (w.dtype == kBF16 && layout == 128) return launch_layout<bf16, 128, kDkv>(p, w, s);
  if (w.dtype == kF16 && layout == 64) return launch_layout<h16, 64, kDkv>(p, w, s);
  if (w.dtype == kF16 && layout == 128) return launch_layout<h16, 128, kDkv>(p, w, s);
  if (w.dtype == kBF16 && layout == 256) return launch_layout<bf16, 256, kDkv>(p, w, s);
  if (w.dtype == kF16 && layout == 256) return launch_layout<h16, 256, kDkv>(p, w, s);
  if (w.dtype == kBF16 && layout == 512) return launch_layout<bf16, 512, kDkv>(p, w, s);
  if (w.dtype == kF16 && layout == 512) return launch_layout<h16, 512, kDkv>(p, w, s);
  return cudaErrorInvalidValue;
}

template <typename T>
static void report_type(char* out, int cap, int& used, const char* t) {
  char name[96];
#define BWD_REPORT(label, kernel, smem)             \
  snprintf(name, sizeof(name), "%s %s", label, t); \
  report_one(out, cap, used, name, kernel, smem)
  BWD_REPORT("B13a D64", (flash_bwd_dkv_kernel<T, 64, false>), DkvSmem<64>::kBytes);
  BWD_REPORT("B13a D128", (flash_bwd_dkv_kernel<T, 128, false>), DkvSmem<128>::kBytes);
  BWD_REPORT("B13b D64", (flash_bwd_dq_kernel<T, 64, false>), DqSmem<64>::kBytes);
  BWD_REPORT("B13b D128", (flash_bwd_dq_kernel<T, 128, false>), DqSmem<128>::kBytes);
  BWD_REPORT("B13a D256", (flash_bwd_dkv_kernel_d256<T, false>), Smem256<true>::kBytes);
  BWD_REPORT("B13b D256", (flash_bwd_dq_kernel_d256<T, false>), Smem256<false>::kBytes);
  BWD_REPORT("B13a D512", (flash_bwd_dkv_kernel_d512<T, false>), Dkv512Smem::kBytes);
  BWD_REPORT("B13b D512", (flash_bwd_dq_kernel_d512<T, false>), Dq512Smem::kBytes);
  // The instantiations of d below the layout's D (kPad).
  BWD_REPORT("B13a D64 padded", (flash_bwd_dkv_kernel<T, 64, true>), DkvSmem<64>::kBytes);
  BWD_REPORT("B13a D128 padded", (flash_bwd_dkv_kernel<T, 128, true>), DkvSmem<128>::kBytes);
  BWD_REPORT("B13b D64 padded", (flash_bwd_dq_kernel<T, 64, true>), DqSmem<64>::kBytes);
  BWD_REPORT("B13b D128 padded", (flash_bwd_dq_kernel<T, 128, true>), DqSmem<128>::kBytes);
  BWD_REPORT("B13a D256 padded", (flash_bwd_dkv_kernel_d256<T, true>), Smem256<true>::kBytes);
  BWD_REPORT("B13b D256 padded", (flash_bwd_dq_kernel_d256<T, true>), Smem256<false>::kBytes);
  BWD_REPORT("B13a D512 padded", (flash_bwd_dkv_kernel_d512<T, true>), Dkv512Smem::kBytes);
  BWD_REPORT("B13b D512 padded", (flash_bwd_dq_kernel_d512<T, true>), Dq512Smem::kBytes);
  BWD_REPORT("B13a split combine", (flash_bwd_dkv_combine<T>), 0);
#undef BWD_REPORT
}

}  // namespace fact

// Writes the report of every B13a / B13b instantiation (the launch's
// registers: the consumers raise theirs to 240 by setmaxnreg; local
// (spill) bytes; shared memory) into `out` (at most `cap` bytes,
// NUL-terminated); returns 0.
extern "C" int fact_bwd_report(char* out, int cap) {
  int used = 0;
  if (cap <= 0) return 0;
  out[0] = 0;
  fact::report_type<__nv_bfloat16>(out, cap, used, "bf16");
  fact::report_type<__half>(out, cap, used, "f16");
  out[cap - 1] = 0;
  return 0;
}

// One launch function for both kernels, counted apart by the wrapper
// (ops/flash_bwd.py): `dkv` 1 launches B13a into out0 = dK and out1 = dV
// (with `splits` > 1, through the fp32 workspace `ws` of 2 x splits x
// B x Hkv x Skv x row_pitch(d) floats and the combine pass), 0 launches
// B13b into out0 = dQ (`ws`, `splits` unused); outputs contiguous but for
// their rows, which lie at row_pitch(d). d: from 1 to 512
// (padded_head_dim with `wide`). lse and delta are [B, Hq, Sq rounded
// up to 128] fp32, contiguous, +inf / 0 past Sq. Returns a cudaError_t code
// (0 on success). Shapes, strides, dtypes and the plan are checked by the
// wrapper.
extern "C" int fact_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, void* out0, void* out1,
                              int batch, int hq, int hkv, int sq, int skv, int d,
                              long long q_sb, long long q_sh, long long q_ss,
                              long long k_sb, long long k_sh, long long k_ss,
                              long long v_sb, long long v_sh, long long v_ss,
                              long long o_sb, long long o_sh, long long o_ss,
                              float scale_log2, float scale, int causal, int window, int dtype,
                              int dkv, void* ws, int splits, void* stream) {
  using namespace fact;
  BwdParams p{};
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.out0 = out0, p.out1 = out1;
  p.ws = static_cast<float*>(ws);
  p.splits = dkv ? splits : 1;
  if (p.splits < 1 || (p.splits > 1 && ws == nullptr)) return cudaErrorInvalidValue;
  p.batch = batch, p.hq = hq, p.hkv = hkv, p.group = hq / hkv, p.sq = sq, p.skv = skv;
  p.sq_pad = (sq + kRowPad - 1) / kRowPad * kRowPad;
  p.scale_log2 = scale_log2, p.scale = scale;
  p.causal = causal, p.window = window;
  p.d = d;
  const BwdViews w{q, k, v, dout, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                   v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, d, dtype};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dkv ? dispatch_bwd<true>(p, w, s) : dispatch_bwd<false>(p, w, s);
}
