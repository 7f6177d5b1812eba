// Attention over a packed ragged batch (kernel B12): sequences concatenated
// along one token axis, q [Hq, Tq, D] and k / v [Hkv, Tkv, D] with the head
// dim contiguous, delimited by int32 metadata on the device: q_seg[m] and
// kv_seg[n] (segment ids, non-decreasing), q_bound[m] (the row's causal
// bound: its position in its sequence + kv_len - q_len of that sequence)
// and kv_pos[n] (the key's position in its sequence, from 0). Key n is
// visible from row m iff kv_seg[n] == q_seg[m], when causal
// kv_pos[n] <= q_bound[m] (bottom-right alignment per sequence), and with a
// sliding window W kv_pos[n] > q_bound[m] - W. The tanh soft cap
// (`softcap_log2`, c * log2(e), 0 for none) applies to every score before
// the mask. Head dims: every d from 1 to 256, each run in the layout of
// the next of 64, 128 and 256 at or above it (padded_head_dim), and every d
// from 257 to 512 in the wide layout of 512 (two blocks along grid y, each
// 256 of O's columns, S recomputed in each; 32-key tiles), as P does
// (flash_fwd.cu): the maps hold the true d columns, so TMA reads zeros
// past them, S is exact and O is stored at the row pitch row_pitch(d),
// its columns past d zeros (the TPU wrapper pads D to its 128 lanes,
// flash_varlen.py:255). A row
// with no visible key (q longer than kv in a sequence, an empty kv
// sequence) is exact zeros.
//
// Replaces the TPU kernel flash_attention_cute_tpu/ops/flash_varlen.py
// `_flash_varlen_kernel` (:48, pallas_call at :378). It computes what that
// kernel computes, not its block structure: the TPU kernel scalar-prefetches
// a [first, last] KV block range per q block, computed by XLA gathers and
// searchsorted over the metadata, sizes its grid by max_seqlen, and runs an
// anchored lazy max over `inner` sub-blocks. Here each block of 128 query
// tokens of one q head finds its own live key range on the device (from the
// first key of its first row's segment, past that row's window, to the last
// key of its last row's segment, cut at that row's causal bound), so
// lengths, offsets and segment ids never cross to the host, and walks only
// that range; tiles straddle segments freely and are masked with the
// segment ids and positions of their keys. The softmax is exact.
//
// What bounds it on the H100: tensor-core operations, 4 D per visible
// (row, key) pair and q head, as for P; the sequences' own causal
// triangles are the work, plus the tiles' overhang across segment edges.
// So it is P's design (attention_wgmma.cuh: two wgmma consumers in
// ping-pong, exact softmax, S and P in registers, V read MN-major,
// bit-identical repeats, mask mode `Segments`) with a producer of its own:
//
//   * Before the warpgroups split, warps 0-3 find the block's range by four
//     searches over kv_seg at once, each a warp's: 32 lanes probe 32 points
//     a step, so a search of 36k keys takes 4 dependent loads (a binary
//     search 16).
//   * Lane 0 of the producer's warp 0 copies Q once and the K / V tiles
//     through TMA maps of the strided [H, T, D] views (the transposed
//     [T, H, D] of the cu_seqlens front end needs no copy; rows past T read
//     as zeros), and beside each K tile the tile's kv_seg and kv_pos by two
//     bulk copies from a [2, T + pad] int32 array (the wrapper pads it
//     with keys no row sees: segment INT_MIN, position INT_MAX).
//   * Each consumer finds its own 64 rows' range from the block's, so a
//     consumer whose rows lie in a later segment skips the earlier one's
//     keys; each thread keeps its two rows' segment and bound in registers.
//     A tile of one segment that every row of the thread sees whole takes
//     no mask. The K slot goes back after the mask reads its keys' ids.
//   * Registers: the producer keeps 24, the consumers 240 (setmaxnreg
//     moves registers only within the block); the mask's scalars sit in
//     shared memory. Shared memory: K slots 4 / 3 / 3 / 2 and V slots 4 / 2
//     / 2 / 2 at D 64 / 128 / 256 / 512 (one K slot fewer than P at D 128
//     for the keys' ids), one block an SM.
#include "attention_wgmma.cuh"

namespace fact {

struct VarlenParams {
  void* o;              // [Hq, Tq, d], rows at the pitch `d` holds on the device
  const int* q_seg;     // [Tq]
  const int* q_bound;   // [Tq]
  const int* kv_meta;   // [2, meta_stride]: kv_seg, then kv_pos; padded past Tkv
  int meta_stride;
  int hq, group, tq, tkv;
  Scores sc;
  int causal;
  int window;  // W > 0, or 0 for none
  int d;       // the true head dim (D or below it); on the device O's row pitch
};

template <int D>
struct VarlenSmem {
  static constexpr int kKStages = D == 64 ? 4 : D > 256 ? 2 : 3;
  static constexpr int kVStages = D == 64 ? 4 : 2;
  static constexpr int kMetaOff =
      Tiles<D>::kQ + kKStages * Tiles<D>::kKV + kVStages * Tiles<D>::kV;
  static constexpr int kBars = kMetaOff + kKStages * 8 * Tiles<D>::kN;
  static constexpr int kBytes = 1024 + kBars + Rings<D, kKStages, kVStages, kBars>::kBarriers * 8;
};

// First index in [0, n) whose value is >= x (kPast: > x), n if none; `a`
// non-decreasing. Every lane of a warp calls it: a step probes 32 points,
// one a lane, and keeps the gap between the last probe below x and the
// next, so n keys take about log32(n) dependent loads.
template <bool kPast>
__device__ __forceinline__ int warp_search(const int* a, int n, int x) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int probe = lo + (lane + 1) * step - 1;
    const bool below = probe < hi && (kPast ? a[probe] <= x : a[probe] < x);
    const int c = __popc(__ballot_sync(0xffffffffu, below));  // probes below x: a prefix
    const int next = lo + (c + 1) * step - 1;                   // probe c, not below x
    if (c < 32 && next < hi) hi = next;
    lo += c * step;
  }
  return lo;
}

template <typename T, int D, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
    varlen_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap, const VarlenParams p) {
  using S = VarlenSmem<D>;
  using Tl = Tiles<D>;
  constexpr int kN = Tl::kN, kKStages = S::kKStages, kVStages = S::kVStages;
  using Vis = Segments<S::kMetaOff, kKStages>;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;  // the 128-byte swizzle needs 1 KB
  const Rings<D, kKStages, kVStages, S::kBars> r{base};
  __shared__ Vis vis;
  __shared__ Scores sco;

  const int nqb = (p.tq + kBlockM - 1) / kBlockM;
  const int m0 = (nqb - 1 - static_cast<int>(blockIdx.x) / p.hq) * kBlockM;
  const int h = blockIdx.x % p.hq, hk = h / p.group;
  const int last = min(m0 + kBlockM, p.tq) - 1;
  // The first of O's (and V's) columns of this block's chunk (the wide layout).
  const int c0 = Tl::kChunks > 1 ? Tl::kDO * static_cast<int>(blockIdx.y) : 0;
  const int* kv_seg = p.kv_meta;

  // The block's range: warp 0 the first key of seg_lo, 1 past the last key
  // of seg_hi, 2 the first key of seg_hi, 3 past the last key of seg_lo;
  // warp 4 the bounds of the first and last rows.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 4) {
    const int seg = warp == 0 || warp == 3 ? p.q_seg[m0] : p.q_seg[last];
    const int at = warp & 1 ? warp_search<true>(kv_seg, p.tkv, seg)
                            : warp_search<false>(kv_seg, p.tkv, seg);
    if (lane == 0) {
      if (warp == 0) vis.a = at, vis.seg_lo = seg;
      if (warp == 1) vis.b = at, vis.seg_hi = seg;
      if (warp == 2) vis.c = at;
      if (warp == 3) vis.d = at;
    }
  } else if (warp == 4 && lane == 0) {
    vis.bound_lo = p.q_bound[m0];
    vis.bound_hi = p.q_bound[last];
    vis.sq = p.tq, vis.causal = p.causal, vis.window = p.window;
    vis.q_seg = p.q_seg, vis.q_bound = p.q_bound;
    sco = p.sc;
    r.init(1);
    mbar_fence_init();
  }
  __syncthreads();
  const int shift = p.window > 0 ? max(0, vis.bound_lo - p.window + 1) : 0;
  const int n_lo = min(vis.a + shift, vis.d);
  const int n_end = p.causal ? min(vis.b, vis.c + max(vis.bound_hi + 1, 0)) : vis.b;
  const int n_begin = n_lo & ~7;  // the keys' ids are copied in 16-byte units
  const int total = n_end > n_begin ? (n_end - n_begin + kN - 1) / kN : 0;

  if (threadIdx.x < 128) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0 && total > 0) {
      mbar_expect_tx(r.q_full(), Tl::kQ);
      for (int c = 0; c < D / 64; ++c)
        tma_load_4d(r.sQ() + c * Tl::kQBox, &qmap, 64 * c, m0, h, 0, r.q_full());
      for (int it = 0; it < total; ++it) {
        const int n0 = n_begin + it * kN;
        const uint32_t meta = base + S::kMetaOff + it % kKStages * 8 * kN;
        mbar_wait(r.empty_k(it), r.k_pass(it) ^ 1);
        mbar_expect_tx(r.full_k(it), Tl::kKV + 8 * kN);
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(r.sK(it) + c * Tl::kKVBox, &kmap, 64 * c, n0, hk, 0, r.full_k(it));
        bulk_load(meta, p.kv_meta + n0, 4 * kN, r.full_k(it));
        bulk_load(meta + 4 * kN, p.kv_meta + p.meta_stride + n0, 4 * kN, r.full_k(it));
        mbar_wait(r.empty_v(it), r.v_pass(it) ^ 1);
        mbar_expect_tx(r.full_v(it), Tl::kV);
        for (int c = 0; c < Tl::kDO / 64; ++c)  // V's columns of the block's chunk
          tma_load_4d(r.sV(it) + c * Tl::kKVBox, &vmap, c0 + 64 * c, n0, hk, 0, r.full_v(it));
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  consume<T, D, kCap, 0>(r, vis, sco, m0, n_begin, total, static_cast<T*>(p.o) + c0, nullptr, h,
                        p.d, {}, min(Tl::kDO, p.d - c0));
}

// ---------------------------------------------------------------------------
// Host side.

struct VarlenViews {
  const void *q, *k, *v;
  long long q_sh, q_ss, k_sh, k_ss, v_sh, v_ss;
  int hkv, dtype;
};

template <typename T, int D, bool kCap>
int launch_varlen(const VarlenParams& p, const VarlenViews& w, cudaStream_t stream) {
  using S = VarlenSmem<D>;
  auto kernel = varlen_kernel<T, D, kCap>;
  static const int configured = allow_smem(kernel, S::kBytes);  // above 48 KB needs an opt-in
  if (configured != cudaSuccess) return configured;
  const long long blocks = static_cast<long long>((p.tq + kBlockM - 1) / kBlockM) * p.hq;
  if (blocks <= 0) return cudaSuccess;
  if (blocks > 0x7FFFFFFF || p.meta_stride % 4 || p.meta_stride < p.tkv + Tiles<D>::kN)
    return cudaErrorInvalidValue;
  // The maps hold the true d columns: a box reads zeros past them.
  CUtensorMap qmap, kmap, vmap;
  const int kN = Tiles<D>::kN;
  if (!head_map(&qmap, w.dtype, w.q, 1, p.hq, p.tq, p.d, 0, w.q_sh, w.q_ss, kBlockM) ||
      !head_map(&kmap, w.dtype, w.k, 1, w.hkv, p.tkv, p.d, 0, w.k_sh, w.k_ss, kN) ||
      !head_map(&vmap, w.dtype, w.v, 1, w.hkv, p.tkv, p.d, 0, w.v_sh, w.v_ss, kN))
    return cudaErrorInvalidValue;
  VarlenParams kp = p;
  kp.d = row_pitch(p.d);  // O's row pitch
  const dim3 grid(static_cast<unsigned>(blocks), Tiles<D>::kChunks);
  kernel<<<grid, kThreads, S::kBytes, stream>>>(qmap, kmap, vmap, kp);
  return cudaGetLastError();
}

template <typename T, int D>
int launch_varlen_cap(const VarlenParams& p, const VarlenViews& w, cudaStream_t s) {
  return p.sc.softcap_log2 > 0.f ? launch_varlen<T, D, true>(p, w, s)
                                 : launch_varlen<T, D, false>(p, w, s);
}

// d runs in the layout of padded_head_dim(d, true): up to 512.
template <typename T>
int dispatch_varlen(const VarlenParams& p, const VarlenViews& w, int d, cudaStream_t s) {
  const int layout = padded_head_dim(d, true);
  if (layout == 64) return launch_varlen_cap<T, 64>(p, w, s);
  if (layout == 128) return launch_varlen_cap<T, 128>(p, w, s);
  if (layout == 256) return launch_varlen_cap<T, 256>(p, w, s);
  if (layout == 512) return launch_varlen_cap<T, 512>(p, w, s);
  return cudaErrorInvalidValue;
}

template <typename T>
static void report_type(char* out, int cap, int& used, const char* t) {
  char name[96];
#define VARLEN_REPORT(d, c)                                                   \
  snprintf(name, sizeof(name), "B12 D%d %s%s", d, t, c ? " cap" : "");       \
  report_one(out, cap, used, name, (varlen_kernel<T, d, c>), VarlenSmem<d>::kBytes)
  VARLEN_REPORT(64, false);
  VARLEN_REPORT(64, true);
  VARLEN_REPORT(128, false);
  VARLEN_REPORT(128, true);
  VARLEN_REPORT(256, false);
  VARLEN_REPORT(256, true);
  VARLEN_REPORT(512, false);
  VARLEN_REPORT(512, true);
#undef VARLEN_REPORT
}

}  // namespace fact

// Writes the report of every B12 instantiation (the launch's registers: the
// consumers raise theirs to 240 by setmaxnreg; local (spill) bytes; shared
// memory) into `out` (at most `cap` bytes, NUL-terminated); returns 0.
extern "C" int fact_varlen_report(char* out, int cap) {
  int used = 0;
  if (cap <= 0) return 0;
  out[0] = 0;
  fact::report_type<__nv_bfloat16>(out, cap, used, "bf16");
  fact::report_type<__half>(out, cap, used, "f16");
  out[cap - 1] = 0;
  return 0;
}

// Returns a cudaError_t code (0 on success). Shapes, strides and dtypes are
// checked by the Python wrapper (ops/flash_varlen.py).
extern "C" int fact_flash_varlen(const void* q, const void* k, const void* v, void* o,
                                 const void* q_seg, const void* q_bound, const void* kv_meta,
                                 int meta_stride, int hq, int hkv, int tq, int tkv, int d,
                                 long long q_sh, long long q_ss, long long k_sh, long long k_ss,
                                 long long v_sh, long long v_ss, float scale_log2,
                                 float softcap_log2, int causal, int window, int dtype,
                                 void* stream) {
  using namespace fact;
  if (hkv <= 0 || hq % hkv) return cudaErrorInvalidValue;
  VarlenParams p{};
  p.o = o;
  p.q_seg = static_cast<const int*>(q_seg);
  p.q_bound = static_cast<const int*>(q_bound);
  p.kv_meta = static_cast<const int*>(kv_meta);
  p.meta_stride = meta_stride;
  p.hq = hq, p.group = hq / hkv, p.tq = tq, p.tkv = tkv;
  p.sc = scores(scale_log2, softcap_log2);
  p.causal = causal;
  p.window = window;
  p.d = d;
  const VarlenViews w{q, k, v, q_sh, q_ss, k_sh, k_ss, v_sh, v_ss, hkv, dtype};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return dispatch_varlen<__nv_bfloat16>(p, w, d, s);
  if (dtype == kF16) return dispatch_varlen<__half>(p, w, d, s);
  return cudaErrorInvalidValue;
}
