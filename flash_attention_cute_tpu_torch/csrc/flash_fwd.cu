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
// GQA: q head h reads kv head h / (Hq / Hkv).
// They compute what the TPU kernels compute, not their block structure:
// those pack a q-head group per grid cell and skip KV blocks wholly below
// every row's window in the grid; here each block walks its own tile range.
//
// What bounds them on the H100: tensor-core operations (4 D per visible
// (row, key) pair and q head), far above the card's ~295 operations per
// byte at prefill lengths. So they are built for wgmma, fed by TMA: the
// consumers are the shared body of attention_wgmma.cuh (exact softmax,
// S and P in registers, V read MN-major, ping-pong, bit-identical repeats);
// the producer here is one thread of warpgroup 0 (setmaxnreg gives the
// warpgroup's registers to the consumers, 240 each), which copies Q once and
// the K / V tiles of the walk with the 128-byte swizzle through 4-D maps of
// the strided [B, H, S, D] views (rows past S read as zeros), so the model's
// transposed q / k / v need no copy. The walk runs from the tile holding
// the block's first visible key (the window start) to the causal end;
// causal grids start with the rows that see the most keys. The tanh of the
// soft cap is two MUFU operations (softcap()). Shared memory: Q 16 / 32 /
// 64 KB, K slots 4 / 4 / 3 and V slots 4 / 2 / 2 of 16 / 32 / 32 KB at D 64
// / 128 / 256: 144 / 224 / 224 KB, one block an SM.
#include "attention_wgmma.cuh"

namespace fact {

struct FwdParams {
  void* o;     // [B, Hq, Sq, D] contiguous
  float* lse;  // [B, Hq, Sq] fp32 contiguous, or null
  int batch, hq, group, sq, skv;
  Scores sc;
  int causal;
  int window;  // W > 0, or 0 for none
};

// K and V stream through rings of their own (attention_wgmma.cuh): a K tile
// is free once S is, a V tile only after the next tile's S (its P V runs
// then).
template <int D>
struct FwdSmem {
  static constexpr int kKStages = D == 256 ? 3 : 4;
  static constexpr int kVStages = D == 64 ? 4 : 2;
  static constexpr int kBars = Tiles<D>::kQ + (kKStages + kVStages) * Tiles<D>::kKV;
  static constexpr int kBytes = 1024 + kBars + Rings<D, kKStages, kVStages, kBars>::kBarriers * 8;
};

// kCap: the soft cap is compiled in (a launch with softcap_log2 > 0).
template <typename T, int D, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, const FwdParams p) {
  using S = FwdSmem<D>;
  using Tl = Tiles<D>;
  constexpr int kN = Tl::kN, kKStages = S::kKStages, kVStages = S::kVStages;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;  // the 128-byte swizzle needs 1 KB
  const uint32_t sQ = base;
  const Rings<D, kKStages, kVStages, S::kBars> r{base};

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
    r.init(1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0 && total > 0) {
      mbar_expect_tx(r.q_full(), Tl::kQ);
      for (int c = 0; c < D / 64; ++c)
        tma_load_4d(sQ + c * Tl::kQBox, &qmap, 64 * c, m0, h, b, r.q_full());
      for (int it = 0; it < total; ++it) {
        const int n0 = n_begin + it * kN;
        mbar_wait(r.empty_k(it), r.k_pass(it) ^ 1);
        mbar_expect_tx(r.full_k(it), Tl::kKV);
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(r.sK(it) + c * Tl::kKVBox, &kmap, 64 * c, n0, hk, b, r.full_k(it));
        mbar_wait(r.empty_v(it), r.v_pass(it) ^ 1);
        mbar_expect_tx(r.full_v(it), Tl::kKV);
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(r.sV(it) + c * Tl::kKVBox, &vmap, 64 * c, n0, hk, b, r.full_v(it));
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  consume<T, D, kCap, 0>(r, Visible{p.sq, p.skv, offset, p.causal, p.window}, p.sc, m0, n_begin,
                         total, static_cast<T*>(p.o), p.lse, b * p.hq + h);
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
  const int sq = p.sq, skv = p.skv, kN = Tiles<D>::kN;
  if (!head_map(&qmap, w.dtype, w.q, p.batch, p.hq, sq, D, w.q_sb, w.q_sh, w.q_ss, kBlockM) ||
      !head_map(&kmap, w.dtype, w.k, p.batch, w.hkv, skv, D, w.k_sb, w.k_sh, w.k_ss, kN) ||
      !head_map(&vmap, w.dtype, w.v, p.batch, w.hkv, skv, D, w.v_sb, w.v_sh, w.v_ss, kN))
    return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kThreads, S::kBytes, stream>>>(qmap, kmap, vmap, p);
  return cudaGetLastError();
}

template <typename T, int D>
int launch_cap(const FwdParams& p, const FwdViews& w, cudaStream_t s) {
  return p.sc.softcap_log2 > 0.f ? launch_fwd<T, D, true>(p, w, s) : launch_fwd<T, D, false>(p, w, s);
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
  p.sc = scores(scale_log2, softcap_log2);
  p.causal = causal;
  p.window = window;
  const FwdViews w{q, k, v, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, hkv, dtype};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return dispatch_fwd<__nv_bfloat16>(p, w, d, s);
  if (dtype == kF16) return dispatch_fwd<__half>(p, w, d, s);
  return cudaErrorInvalidValue;
}
