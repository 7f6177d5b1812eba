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
//     behind the pallas_call at :1260, for their windowed geometry.
// Their int8 scores (`score_dtype="int8"`: the int8 branches of
// `_flash_fwd_kernel_diag` and `_flash_fwd_kernel_fused`, :617-700 and
// :335-418) are the kI8 instantiations of the same kernel, counted as P-i8
// and B2-i8: K comes as K8's int8 rows and fp32 row scales (below), the
// consumers quantize their q rows into an int8 tile once a block, and S is
// the s8 wgmma (m64nNk32, s32 accumulators, twice the bf16 rate), scaled
// back to fp32 per row and key before the cap and the mask; V stays bf16 /
// f16 and P V is unchanged. Q is quantized with one scale a row, where the
// TPU kernels take one a tile (a workaround of their lane layout).
// Both take the tanh soft cap (`softcap_log2`, c * log2(e), 0 for none),
// applied to every score before the mask in the base-2 units of the body:
// x = c2 * tanh(x / c2), c2 = c * log2(e), which is log2(e) times the TPU
// kernels' c * tanh(s / c) of the natural score s. Head dims: every d
// from 1 to 256, each run in the layout of the next of 64, 128 and 256 at
// or above it (padded_head_dim), and P / B2 also every d from 257 to 512 in
// the wide layout of 512 (attention_wgmma.cuh: two blocks along grid y,
// each O's columns [256 y, 256 y + 256), S recomputed in each; 32-key
// tiles): the maps hold the true d columns (rows at
// any 16-byte stride, row_pitch), so TMA reads zeros past them, S is exact
// and O is stored at the row pitch row_pitch(d), its columns past d zeros
// (the TPU wrapper pads D up to its 128 lanes likewise and keeps a D above
// 128 native, flash_fwd.py:926-938). P-i8 / B2-i8 (up to 256) likewise: K8 writes its
// int8 rows at row_pitch(d, 1) with zeros past d, and their kPad
// instantiation (a pitch below the layout's D) stores the pitch's columns
// only, so at d == D they keep the kernels they had.
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
// / 128 / 256: 144 / 224 / 224 KB, one block an SM; at D 512 Q 128 KB, two
// K slots of 32 KB and two V slots of 16 KB (a chunk's 256 columns): 224
// KB. P-i8 / B2-i8 add the
// int8 Q tile (8 / 16 / 32 KB) and take K slots of half the size, with the
// keys' scales beside them: about 122 / 178 / 209 KB.
#include "attention_wgmma.cuh"

namespace fact {

struct FwdParams {
  void* o;     // [B, Hq, Sq, d], rows at the pitch `d` holds on the device
  float* lse;  // [B, Hq, Sq] fp32 contiguous, or null
  int batch, hq, group, sq, skv;
  Scores sc;
  int causal;
  int window;  // W > 0, or 0 for none
  // P-i8 / B2-i8: K8's scales, [B, Hkv, kscale_rows] fp32 (kscale_rows a
  // multiple of 128 >= Skv, 0 past Skv).
  const float* kscale;
  int kscale_rows;
  // The true head dim (D, or below it in D's layout) on the host; the
  // kernel is launched with O's row pitch, row_pitch(d), in its place.
  int d;
};

// K and V stream through rings of their own (attention_wgmma.cuh): a K tile
// is free once S is, a V tile only after the next tile's S (its P V runs
// then). kI8: the int8 Q tile follows the Q tile, K slots hold int8 tiles,
// and the keys' scales of each K slot follow the V ring.
template <int D, bool kI8 = false>
struct FwdSmem {
  static constexpr int kKStages = D > 256 ? 2 : D == 256 ? 3 : 4;
  static constexpr int kVStages = D == 64 ? 4 : 2;
  static constexpr int kQBytes = Tiles<D>::kQ + (kI8 ? kBlockM * D : 0);
  static constexpr int kKSlot = kI8 ? Tiles<D>::kN * D : Tiles<D>::kKV;
  static constexpr int kScaleOff = kQBytes + kKStages * kKSlot + kVStages * Tiles<D>::kV;
  static constexpr int kBars = kScaleOff + (kI8 ? kKStages * Tiles<D>::kN * 4 : 0);
  using Ring = Rings<D, kKStages, kVStages, kBars, kKSlot, kQBytes>;
  static constexpr int kBytes = 1024 + kBars + Ring::kBarriers * 8;
};

// kCap: the soft cap is compiled in (a launch with softcap_log2 > 0).
// kI8: int8 scores (P-i8 / B2-i8): k is K8's int8 [B, Hkv, Skv, d].
// kPad (kI8 only): O's row pitch p.d is below D, and only its columns are
// stored; P / B2 store p.d columns at every d.
template <typename T, int D, bool kCap, bool kI8, bool kPad = false>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, const FwdParams p) {
  using S = FwdSmem<D, kI8>;
  using Tl = Tiles<D>;
  constexpr int kN = Tl::kN, kKStages = S::kKStages;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;  // the 128-byte swizzle needs 1 KB
  const uint32_t sQ = base;
  const typename S::Ring r{base};

  const int per = p.hq * p.batch;
  const int nqb = (p.sq + kBlockM - 1) / kBlockM;
  const int m0 = (nqb - 1 - static_cast<int>(blockIdx.x) / per) * kBlockM;  // most keys first
  const int h = blockIdx.x % per % p.hq, b = blockIdx.x % per / p.hq, hk = h / p.group;
  const int offset = p.skv - p.sq;
  // The first of O's (and V's) columns of this block's chunk (the wide layout).
  const int c0 = Tl::kChunks > 1 ? Tl::kDO * static_cast<int>(blockIdx.y) : 0;

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
        if constexpr (kI8) {  // int8 rows in boxes of 128 bytes, and the keys' scales
          mbar_expect_tx(r.full_k(it), S::kKSlot + kN * 4);
          for (int c = 0; c < (D + 127) / 128; ++c)
            tma_load_4d(r.sK(it) + c * kN * 128, &kmap, 128 * c, n0, hk, b, r.full_k(it));
          bulk_load(base + S::kScaleOff + it % kKStages * kN * 4,
                    p.kscale + (static_cast<int64_t>(b) * (p.hq / p.group) + hk) * p.kscale_rows + n0,
                    kN * 4, r.full_k(it));
        } else {
          mbar_expect_tx(r.full_k(it), Tl::kKV);
          for (int c = 0; c < D / 64; ++c)
            tma_load_4d(r.sK(it) + c * Tl::kKVBox, &kmap, 64 * c, n0, hk, b, r.full_k(it));
        }
        mbar_wait(r.empty_v(it), r.v_pass(it) ^ 1);
        mbar_expect_tx(r.full_v(it), Tl::kV);
        for (int c = 0; c < Tl::kDO / 64; ++c)  // V's columns of the block's chunk
          tma_load_4d(r.sV(it) + c * Tl::kKVBox, &vmap, c0 + 64 * c, n0, hk, b, r.full_v(it));
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  // The chunk's O columns (the wide layout; chunk 0 writes the lse).
  consume<T, D, kCap, kI8 ? S::kScaleOff : 0, kI8>(
      r, Visible{p.sq, p.skv, offset, p.causal, p.window}, p.sc, m0, n_begin, total,
      static_cast<T*>(p.o) + c0, c0 == 0 ? p.lse : nullptr, b * p.hq + h,
      kI8 && !kPad ? D : p.d, {}, min(Tl::kDO, p.d - c0));
}

// ---------------------------------------------------------------------------
// K8: the per-row int8 quantization of K that P-i8 / B2-i8 read, once a
// call (the TPU kernels quantize each K sub-block again for every q tile,
// `_quantize_k_rows`, flash_attention_cute_tpu/ops/flash_fwd.py:79): for
// each row of a strided [B, Hkv, Skv, D] view, b = max |k_row| (1 where 0),
// values rint(k * (127 / b)) clipped to +-127 into int8
// [B, Hkv, Skv, d] at a row pitch of row_pitch(d, 1) bytes (zeros past d,
// so that P-i8's 128-byte K boxes read zeros there), and b into fp32
// [B, Hkv, kscale_rows], 0 past Skv.
// Bit-identical to the plain version: one IEEE quotient, one product, ties
// to even. It moves 2 d + d + 4 bytes a row and computes next to nothing:
// bytes bound it, so a warp takes a row with coalesced 4-byte loads and
// 2-byte stores, eight warps a block; below the layout's D (kPad) with
// 2-byte loads and 1-byte stores of the row's d columns and its pitch.
constexpr int kQuantRowsPerBlock = 8;

template <typename T, int D, bool kPad>
__global__ void __launch_bounds__(32 * kQuantRowsPerBlock)
    quantize_k_rows_kernel(const T* k, int8_t* values, float* scales, int hkv, int skv,
                           int kscale_rows, long long rows, long long sb, long long sh,
                           long long ss, int d) {
  const long long row = static_cast<long long>(blockIdx.x) * kQuantRowsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int n = static_cast<int>(row % kscale_rows);
  const long long bh = row / kscale_rows;
  if (n >= skv) {
    if (lane == 0) scales[row] = 0.f;
    return;
  }
  const T* row_src = k + bh / hkv * sb + bh % hkv * sh + static_cast<long long>(n) * ss;
  if constexpr (kPad) {
    constexpr int kPer = D / 32;  // values a lane
    float x[kPer];
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int col = lane + 32 * i;
      x[i] = col < d ? Elem<T>::to_float(row_src[col]) : 0.f;
      amax = fmaxf(amax, fabsf(x[i]));
    }
    amax = warp_max(amax);
    const float b = amax == 0.f ? 1.f : amax;
    const float mul = 127.f / b;
    const int pitch = row_pitch(d, 1);
    int8_t* dst = values + (bh * skv + n) * pitch;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int col = lane + 32 * i;
      if (col < pitch)
        dst[col] = col < d ? static_cast<int8_t>(min(127, max(-127, __float2int_rn(x[i] * mul)))) : 0;
    }
    if (lane == 0) scales[row] = b;
    return;
  }
  const uint32_t* src = reinterpret_cast<const uint32_t*>(row_src);
  constexpr int kPairs = D / 64;  // pairs of values a lane
  float x[2 * kPairs];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const float2 f = unpack2<T>(src[lane + 32 * i]);
    x[2 * i] = f.x, x[2 * i + 1] = f.y;
    amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
  }
  amax = warp_max(amax);
  const float b = amax == 0.f ? 1.f : amax;
  const float mul = 127.f / b;
  uint16_t* dst = reinterpret_cast<uint16_t*>(values + (bh * skv + n) * D);
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int v0 = min(127, max(-127, __float2int_rn(x[2 * i] * mul)));
    const int v1 = min(127, max(-127, __float2int_rn(x[2 * i + 1] * mul)));
    dst[lane + 32 * i] = static_cast<uint16_t>((v0 & 0xFF) | ((v1 & 0xFF) << 8));
  }
  if (lane == 0) scales[row] = b;
}

template <typename T>
int launch_quantize_k(const void* k, void* values, void* scales, int batch, int hkv, int skv,
                      int d, int kscale_rows, long long sb, long long sh, long long ss,
                      cudaStream_t stream) {
  const long long rows = static_cast<long long>(batch) * hkv * kscale_rows;
  const long long blocks = (rows + kQuantRowsPerBlock - 1) / kQuantRowsPerBlock;
  if (blocks <= 0) return cudaSuccess;
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks)), block(32 * kQuantRowsPerBlock);
  const T* kt = static_cast<const T*>(k);
  int8_t* vt = static_cast<int8_t*>(values);
  float* st = static_cast<float*>(scales);
  const int layout = padded_head_dim(d);
#define K8_LAUNCH(D_, pad) \
  quantize_k_rows_kernel<T, D_, pad><<<grid, block, 0, stream>>>(kt, vt, st, hkv, skv, kscale_rows, rows, sb, sh, ss, d)
  if (d == 64) K8_LAUNCH(64, false);
  else if (d == 128) K8_LAUNCH(128, false);
  else if (d == 256) K8_LAUNCH(256, false);
  else if (layout == 64) K8_LAUNCH(64, true);
  else if (layout == 128) K8_LAUNCH(128, true);
  else if (layout == 256) K8_LAUNCH(256, true);
  else return cudaErrorInvalidValue;
#undef K8_LAUNCH
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Host side.

struct FwdViews {
  const void *q, *k, *v;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int hkv, dtype;
};

template <typename T, int D, bool kCap, bool kI8, bool kPad>
int launch_fwd(const FwdParams& p, const FwdViews& w, cudaStream_t stream) {
  using S = FwdSmem<D, kI8>;
  auto kernel = flash_fwd_kernel<T, D, kCap, kI8, kPad>;
  static const int configured = allow_smem(kernel, S::kBytes);  // above 48 KB needs an opt-in
  if (configured != cudaSuccess) return configured;
  const long long blocks = static_cast<long long>((p.sq + kBlockM - 1) / kBlockM) * p.hq * p.batch;
  if (blocks <= 0) return cudaSuccess;
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
  CUtensorMap qmap, kmap, vmap;
  // The maps hold the true d columns: a box reads zeros past them.
  const int sq = p.sq, skv = p.skv, kN = Tiles<D>::kN, d = p.d;
  const bool kmap_ok = kI8 ? int8_head_map(&kmap, w.k, p.batch, w.hkv, skv, d, D, kN)
                            : head_map(&kmap, w.dtype, w.k, p.batch, w.hkv, skv, d, w.k_sb,
                                       w.k_sh, w.k_ss, kN);
  if (!head_map(&qmap, w.dtype, w.q, p.batch, p.hq, sq, d, w.q_sb, w.q_sh, w.q_ss, kBlockM) ||
      !kmap_ok ||
      !head_map(&vmap, w.dtype, w.v, p.batch, w.hkv, skv, d, w.v_sb, w.v_sh, w.v_ss, kN))
    return cudaErrorInvalidValue;
  FwdParams kp = p;
  kp.d = row_pitch(d);  // O's row pitch
  const dim3 grid(static_cast<unsigned>(blocks), Tiles<D>::kChunks);
  kernel<<<grid, kThreads, S::kBytes, stream>>>(qmap, kmap, vmap, kp);
  return cudaGetLastError();
}

template <typename T, int D, bool kI8, bool kPad>
int launch_cap(const FwdParams& p, const FwdViews& w, cudaStream_t s) {
  return p.sc.softcap_log2 > 0.f ? launch_fwd<T, D, true, kI8, kPad>(p, w, s)
                                 : launch_fwd<T, D, false, kI8, kPad>(p, w, s);
}

template <typename T, int D, bool kI8>
int launch_pad(const FwdParams& p, const FwdViews& w, cudaStream_t s) {
  if constexpr (kI8)
    if (row_pitch(p.d) < D) return launch_cap<T, D, true, true>(p, w, s);
  return launch_cap<T, D, kI8, false>(p, w, s);
}

// P / B2 run d in the layout of padded_head_dim(d, true) (up to 512),
// P-i8 / B2-i8 in that of padded_head_dim(d) (up to 256).
template <typename T, bool kI8>
int dispatch_fwd(const FwdParams& p, const FwdViews& w, int d, cudaStream_t s) {
  const int layout = padded_head_dim(d, !kI8);
  if (layout == 64) return launch_pad<T, 64, kI8>(p, w, s);
  if (layout == 128) return launch_pad<T, 128, kI8>(p, w, s);
  if (layout == 256) return launch_pad<T, 256, kI8>(p, w, s);
  if constexpr (!kI8)
    if (layout == 512) return launch_cap<T, 512, false, false>(p, w, s);
  return cudaErrorInvalidValue;
}

template <typename T>
static void report_type(char* out, int cap, int& used, const char* t) {
  char name[96];
#define FWD_REPORT_PAD(d, c, i, pad)                                                          \
  snprintf(name, sizeof(name), "%s D%d %s%s%s", i ? "P-i8 / B2-i8" : "P / B2", d, t,         \
           c ? " cap" : "", pad ? " padded" : "");                                          \
  report_one(out, cap, used, name, (flash_fwd_kernel<T, d, c, i, pad>), FwdSmem<d, i>::kBytes)
#define FWD_REPORT(d, c, i) FWD_REPORT_PAD(d, c, i, false)
  FWD_REPORT(64, false, false);
  FWD_REPORT(64, true, false);
  FWD_REPORT(128, false, false);
  FWD_REPORT(128, true, false);
  FWD_REPORT(256, false, false);
  FWD_REPORT(256, true, false);
  FWD_REPORT(512, false, false);
  FWD_REPORT(512, true, false);
  FWD_REPORT(64, false, true);
  FWD_REPORT(64, true, true);
  FWD_REPORT(128, false, true);
  FWD_REPORT(128, true, true);
  FWD_REPORT(256, false, true);
  FWD_REPORT(256, true, true);
  FWD_REPORT_PAD(64, false, true, true);
  FWD_REPORT_PAD(64, true, true, true);
  FWD_REPORT_PAD(128, false, true, true);
  FWD_REPORT_PAD(128, true, true, true);
  FWD_REPORT_PAD(256, false, true, true);
  FWD_REPORT_PAD(256, true, true, true);
#undef FWD_REPORT
#undef FWD_REPORT_PAD
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
  p.d = d;
  const FwdViews w{q, k, v, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, hkv, dtype};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return dispatch_fwd<__nv_bfloat16, false>(p, w, d, s);
  if (dtype == kF16) return dispatch_fwd<__half, false>(p, w, d, s);
  return cudaErrorInvalidValue;
}

// P-i8 / B2-i8: as fact_flash_fwd, with k8 K8's int8 [B, Hkv, Skv, d]
// (rows at row_pitch(d, 1) bytes, otherwise contiguous) and kscale its fp32 scales [B, Hkv, kscale_rows]
// (kscale_rows a multiple of 128 >= Skv); q and v as there. scale_log2
// pre-scales q (sm_scale * log2(e)) before its quantization.
extern "C" int fact_flash_fwd_int8(const void* q, const void* k8, const void* kscale,
                                   const void* v, void* o, void* lse, int batch, int hq, int hkv,
                                   int sq, int skv, int d, int kscale_rows, long long q_sb,
                                   long long q_sh, long long q_ss, long long v_sb, long long v_sh,
                                   long long v_ss, float scale_log2, float softcap_log2,
                                   int causal, int window, int dtype, void* stream) {
  using namespace fact;
  if (kscale_rows % 128 || kscale_rows < skv) return cudaErrorInvalidValue;
  FwdParams p{};
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.batch = batch, p.hq = hq, p.group = hq / hkv, p.sq = sq, p.skv = skv;
  // The scores leave the product in base-2 units: the cap's factor is that
  // of a softmax scale of 1; scale_log2 goes to q's pre-scale.
  p.sc = scores(1.f, softcap_log2);
  p.sc.scale_log2 = scale_log2;
  p.causal = causal;
  p.window = window;
  p.kscale = static_cast<const float*>(kscale);
  p.kscale_rows = kscale_rows;
  p.d = d;
  const FwdViews w{q, k8, v, q_sb, q_sh, q_ss, 0, 0, 0, v_sb, v_sh, v_ss, hkv, dtype};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return dispatch_fwd<__nv_bfloat16, true>(p, w, d, s);
  if (dtype == kF16) return dispatch_fwd<__half, true>(p, w, d, s);
  return cudaErrorInvalidValue;
}

// K8: k a strided [B, Hkv, Skv, d] bf16 / f16 view (strides in elements,
// d contiguous); values int8 [B, Hkv, Skv, d] at rows of row_pitch(d, 1)
// bytes, otherwise contiguous, and scales fp32 [B, Hkv, kscale_rows]
// contiguous (kscale_rows a multiple of 128 >= Skv).
extern "C" int fact_quantize_k_rows(const void* k, void* values, void* scales, int batch, int hkv,
                                    int skv, int d, int kscale_rows, long long k_sb,
                                    long long k_sh, long long k_ss, int dtype, void* stream) {
  using namespace fact;
  if (kscale_rows % 128 || kscale_rows < skv) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_quantize_k<__nv_bfloat16>(k, values, scales, batch, hkv, skv, d, kscale_rows,
                                            k_sb, k_sh, k_ss, s);
  if (dtype == kF16)
    return launch_quantize_k<__half>(k, values, scales, batch, hkv, skv, d, kscale_rows, k_sb,
                                     k_sh, k_ss, s);
  return cudaErrorInvalidValue;
}
