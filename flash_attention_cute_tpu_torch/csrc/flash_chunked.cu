// Chunked extend over a contiguous KV cache (kernel B4): the chunk's S query
// rows sit at global positions q_offset[b] + r and attend cache keys
// `col <= q_offset[b] + r` (when causal), `col < min(kv_length[b], C)` and,
// with a sliding window W > 0, `col > q_offset[b] + r - W`; a row with no
// visible key, and a batch row of kv_length 0, is exact zeros. The tanh
// soft cap (`softcap_log2`, c * log2(e), 0 for none) applies to every score
// before the mask. Head dims: every d from 1 to 256, each run in the
// layout of the next of 64, 128 and 256 at or above it, and every d from
// 257 to 512 in P's wide layout of 512 (padded_head_dim(d, true);
// attention_wgmma.cuh: two blocks along grid y, each O's (or the partials'
// o's) columns [256 y, 256 y + 256), S recomputed in each, chunk 0 writing
// the partials' m and l; 32-key tiles): the maps hold the true d columns,
// so TMA reads zeros past them, S is exact and O (and the partials' o) is
// stored at the row pitch row_pitch(d), its columns past d zeros (the TPU
// wrapper pads D to its 128 lanes and has no upper bound,
// flash_chunked.py:283). GQA: q head h reads kv head h / (Hq / Hkv).
//
// Replaces the TPU kernel flash_attention_cute_tpu/ops/flash_chunked.py
// `_flash_chunked_kernel` (:47, pallas_call at :372). It computes what that
// kernel computes, not its block structure: the TPU kernel prefetches the
// offsets and lengths as scalars, sizes its KV grid from max(kv_length) on
// the device, clamps the KV block index so skipped steps elide their DMA,
// and runs an anchored lazy max over `inner` sub-blocks. Here every block
// reads its own row's offset and length from device memory, walks the K/V
// tiles from its window's near edge to min(kv_length, its causal end), and
// the grid is sized from shapes alone, so no host sync sizes it. The
// softmax is exact.
//
// What bounds it on the H100: at chunk lengths tensor-core operations (4 D
// per visible (row, key) pair and q head), far above the card's ~295
// operations per byte; at a speculative verify round (S = gamma + 1 = 5)
// the bytes of the live K / V. So it is P's design (attention_wgmma.cuh:
// two wgmma consumers in ping-pong, exact softmax, S and P in registers, V
// read MN-major, bit-identical repeats, mask mode `Extend`) with a producer
// of its own:
//
//   * GQA packing: a block holds `heads` q heads of one kv head's group,
//     each its S rows (row r: head r / S, position r % S), where heads is
//     the largest divisor of the group with heads x S <= 128 (the TPU
//     kernel packs the group the same way, flash_chunked.py:110, :298); K /
//     V are then read once a run of heads, not once a q head. heads = 1
//     (128 positions of one head a block) where no two heads fit. Either is
//     one box of TMA: (64 columns, S or 128 positions, heads, 1) of the
//     4-D map over q's strided [B, Hq, S, D] view, so the model's
//     transposed q needs no copy; the output [B, Hq, S, D] is contiguous,
//     so a run of heads is one run of rows there too.
//   * Lane 0 of the producer's warp 0 copies Q once and the K / V tiles of
//     the walk through 4-D maps of the strided [B, Hkv, C, D] cache (rows
//     past C read as zeros).
//   * Tails: the cache holds anything at and past kv_length (NaN in the
//     tests), and 0 x NaN is NaN in P V. K needs nothing: a score of such a
//     key is masked by a select. The walk's last tile, if it crosses
//     kv_length, lands its V on a barrier of its own; warp 0 zeroes its
//     rows at and past kv_length (the chunk's columns in the wide layout)
//     and hands the tile on (B6's way).
//   * Verify rounds (S <= 16, the layouts of D 64 / 128) take P into P V
//     in two bf16 parts, so that their attention matches the decode kernels' (fp32 P),
//     whose logits drafted the tokens: with P rounded once, a Llama-3-8B
//     self-draft run (32 layers, random weights, an H100) accepted 0.74 of
//     its drafts, with two parts 0.91.
//   * Registers: the producer keeps 24, the consumers 240 (setmaxnreg moves
//     registers only within the block, 3 x 168 a thread); the block's
//     place and the mask's scalars sit in shared memory. Shared memory:
//     P's rings (K slots 4 / 4 / 3 / 2, V slots 4 / 2 / 2 / 2 at D 64 / 128
//     / 256 / 512; at D 512 Q 128 KB, K slots of 32 KB and V slots of the
//     chunk's 16 KB: 230,480 bytes with the barriers), one block an SM.
//
//   * The (o, m, l) partials (the TPU kernel's `return_partials`, :58,
//     :198-206; ring attention's per-chunk state, parallel/sequence.py):
//     instantiations of their own (kPartials) whose consumers start the
//     running max at 0 and store O unnormalised, m and l in fp32
//     (attention_wgmma.cuh `Extend<kSplit, true>`, `PartialsOut`, the
//     addresses read from the kernel's parameters), so m = max(0, the row's
//     max) as the plain version's. The walk is the same: a q_offset of -S
//     (a chunk wholly in the future) gives an empty walk and rows of m = 0,
//     l = 0, o = 0 with no tile read; a q_offset at or past the capacity
//     makes every key below kv_length visible. Their bytes: 4 D + 8 a row
//     written, against 2 D for O, which matters only where S is long and
//     the walk short.
#include "attention_wgmma.cuh"

namespace fact {

struct ChunkedParams {
  void* o;               // [B, Hq, S, d], rows at the pitch `d` holds on the device
  const int* q_offset;   // [B] int32: global position of q row 0
  const int* kv_length;  // [B] int32: keys visible to the chunk (0 = inactive)
  int batch, hq, group, sq, capacity;
  int heads;     // q heads a block packs (a divisor of the group), heads x S <= 128 if > 1
  int runs;      // runs of heads a batch row: hq / heads
  int rows;      // rows of a run: heads x S
  int box_rows;  // positions of a head in Q's box: S when heads > 1, else 128
  Scores sc;
  int causal;
  int window;  // W > 0, or 0 for none
  int d;       // the true head dim (D or below it); on the device O's row pitch
  float *m, *l;  // the partials' m and l [B, Hq, S] (kPartials; `o` then fp32)
};

// V slots hold a V tile's chunk columns (Tiles::kV: kKV but in the wide
// layout).
template <int D>
struct ChunkedSmem {
  static constexpr int kKStages = D > 256 ? 2 : D == 256 ? 3 : 4;
  static constexpr int kVStages = D == 64 ? 4 : 2;
  static constexpr int kBars =
      Tiles<D>::kQ + kKStages * Tiles<D>::kKV + kVStages * Tiles<D>::kV;
  // Rings' barriers and the tail's.
  static constexpr int kBytes =
      1024 + kBars + (Rings<D, kKStages, kVStages, kBars>::kBarriers + 1) * 8;
};

// A block's place, from its index: its first row, the run's first q head,
// its kv head, batch row and output head, and its walk.
struct ChunkedBlock {
  int m0, h0, hk, b, head, n_begin, total, skv;
};

// kCap: the soft cap is compiled in (a launch with softcap_log2 > 0);
// kSplit: P enters P V in two parts (a chunk of at most kSplitRows rows);
// kPartials: the block stores the (o, m, l) partials instead of O.
template <typename T, int D, bool kCap, bool kSplit, bool kPartials>
__global__ void __launch_bounds__(kThreads, 1)
    chunked_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, const ChunkedParams p) {
  using S = ChunkedSmem<D>;
  using Tl = Tiles<D>;
  constexpr int kN = Tl::kN, kKStages = S::kKStages, kVStages = S::kVStages;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;  // the 128-byte swizzle needs 1 KB
  const Rings<D, kKStages, kVStages, S::kBars> r{base};
  // Thread 0 places the block; both warpgroups read what they need from
  // shared memory after the register hand-over, so that no value of the
  // prologue lives in a register across it (the producer keeps 24), and
  // the consumers read the mask's scalars there.
  __shared__ ChunkedBlock blk;
  __shared__ Extend<kSplit, kPartials> vis;
  __shared__ Scores sco;
  // The first of O's (and V's) columns of this block's chunk (the wide layout).
  const int c0 = Tl::kChunks > 1 ? Tl::kDO * static_cast<int>(blockIdx.y) : 0;

  if (threadIdx.x == 0) {
    const int per = p.runs * p.batch;
    const int nqb = (p.rows + kBlockM - 1) / kBlockM;
    const int m0 = (nqb - 1 - static_cast<int>(blockIdx.x) / per) * kBlockM;  // most keys first
    const int head = blockIdx.x % per, b = head / p.runs, h0 = head % p.runs * p.heads;
    const int skv = min(max(p.kv_length[b], 0), p.capacity);
    const int offset = p.q_offset[b];
    // The positions of the block's rows, and its keys: from the window's
    // near edge to the causal end; none for an inactive row.
    const int lo = p.heads > 1 ? 0 : m0, hi = p.heads > 1 ? p.sq - 1 : min(m0 + kBlockM, p.sq) - 1;
    const int n_end = min(skv, p.causal ? hi + offset + 1 : skv);
    const int n_begin = (p.window > 0 ? max(0, lo + offset - p.window + 1) : 0) / kN * kN;
    const int total = n_end > n_begin ? (n_end - n_begin + kN - 1) / kN : 0;
    blk = ChunkedBlock{m0, h0, h0 / p.group, b, head, n_begin, total, skv};
    vis = Extend<kSplit, kPartials>{p.rows, p.sq, skv, offset, p.causal, p.window};
    sco = p.sc;
    r.init(1);
    mbar_init(r.extra(0), 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<24>();
    asm volatile("" ::: "memory");  // the reads below stay after the hand-over
    const int lane = threadIdx.x & 31, total = blk.total;
    if (threadIdx.x >= 32 || total == 0) return;
    const int n_begin = blk.n_begin, hk = blk.hk, b = blk.b;
    if (lane == 0) {
      mbar_expect_tx(r.q_full(), D / 64 * p.heads * p.box_rows * 128);
      for (int c = 0; c < D / 64; ++c)
        tma_load_4d(r.sQ() + c * Tl::kQBox, &qmap, 64 * c, blk.m0, blk.h0, b, r.q_full());
    }
    for (int it = 0; it < total; ++it) {
      const int n0 = n_begin + it * kN;
      const int live = min(kN, blk.skv - n0);  // keys of the tile below kv_length
      if (lane == 0) {
        mbar_wait(r.empty_k(it), r.k_pass(it) ^ 1);
        mbar_expect_tx(r.full_k(it), Tl::kKV);
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(r.sK(it) + c * Tl::kKVBox, &kmap, 64 * c, n0, hk, b, r.full_k(it));
        const uint32_t vbar = live < kN ? r.extra(0) : r.full_v(it);
        mbar_wait(r.empty_v(it), r.v_pass(it) ^ 1);
        mbar_expect_tx(vbar, Tl::kV);
        for (int c = 0; c < Tl::kDO / 64; ++c)  // V's columns of the block's chunk
          tma_load_4d(r.sV(it) + c * Tl::kKVBox, &vmap, c0 + 64 * c, n0, hk, b, vbar);
      }
      if (live < kN) {  // only the walk's last tile crosses kv_length
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
    return;
  }

  setmaxnreg_inc<240>();
  asm volatile("" ::: "memory");
  // The chunk's columns of O or of the partials' o (the wide layout; chunk
  // 0 writes m and l).
  consume<T, D, kCap, 0>(r, vis, sco, blk.m0, blk.n_begin, blk.total, static_cast<T*>(p.o) + c0,
                         nullptr, blk.head, p.d,
                         PartialsOut{static_cast<float*>(p.o) + c0, c0 == 0 ? p.m : nullptr,
                                     c0 == 0 ? p.l : nullptr},
                         min(Tl::kDO, p.d - c0));
}

// ---------------------------------------------------------------------------
// Host side.

struct ChunkedViews {
  const void *q, *k, *v;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int hkv, dtype;
};

// Chunks of at most this many rows (a speculative verify round, gamma + 1
// rows, or prompt lookup's) take P in two parts: the round's attention then
// matches the decode kernels' (D1, B5: P in fp32), whose logits drafted its
// tokens, to about 2^-16 of P rather than bf16's 2^-9, so fewer near-ties
// flip between draft and verify. Such chunks are bound by the bytes of K / V,
// not by the products a second P V adds; longer chunks keep one. Not at
// D 256: there the second P's fragments do not fit the consumers' 240
// registers (ptxas spilled 64-72 bytes), nor in the wide layout.
constexpr int kSplitRows = 16;
constexpr bool splits_p(int d) { return d <= 128; }

// The largest divisor of the group whose heads' rows fit a block, or 1.
inline int packed_heads(int group, int sq) {
  for (int g = group; g > 1; --g)
    if (group % g == 0 && g * sq <= kBlockM) return g;
  return 1;
}

template <typename T, int D, bool kCap, bool kSplit, bool kPartials>
int launch_chunked(const ChunkedParams& p, const ChunkedViews& w, cudaStream_t stream) {
  using S = ChunkedSmem<D>;
  auto kernel = chunked_kernel<T, D, kCap, kSplit, kPartials>;
  static const int configured = allow_smem(kernel, S::kBytes);  // above 48 KB needs an opt-in
  if (configured != cudaSuccess) return configured;
  const long long rows = static_cast<long long>(p.heads) * p.sq;
  const long long blocks = (rows + kBlockM - 1) / kBlockM * (p.hq / p.heads) * p.batch;
  if (blocks <= 0) return cudaSuccess;
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
  // Q as (d, S, Hq, B) with boxes of (64, box_rows, heads, 1); every map
  // holds the true d columns, so a box reads zeros past them.
  const CUtensorMapDataType type = w.dtype == kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                    : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  const long long row = 2LL * row_pitch(p.d);  // size-1 dims' stride
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(p.d), static_cast<cuuint64_t>(p.sq),
                              static_cast<cuuint64_t>(p.hq), static_cast<cuuint64_t>(p.batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(p.sq > 1 ? 2 * w.q_ss : row),
                                 static_cast<cuuint64_t>(p.hq > 1 ? 2 * w.q_sh : row),
                                 static_cast<cuuint64_t>(p.batch > 1 ? 2 * w.q_sb : row)};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(p.box_rows),
                             static_cast<cuuint32_t>(p.heads), 1};
  CUtensorMap qmap, kmap, vmap;
  const int kN = Tiles<D>::kN;
  if (!make_map(&qmap, type, 4, w.q, dims, strides, box) ||
      !head_map(&kmap, w.dtype, w.k, p.batch, w.hkv, p.capacity, p.d, w.k_sb, w.k_sh, w.k_ss,
                kN) ||
      !head_map(&vmap, w.dtype, w.v, p.batch, w.hkv, p.capacity, p.d, w.v_sb, w.v_sh, w.v_ss,
                kN))
    return cudaErrorInvalidValue;
  ChunkedParams kp = p;
  kp.d = row_pitch(p.d);  // O's row pitch
  const dim3 grid(static_cast<unsigned>(blocks), Tiles<D>::kChunks);
  kernel<<<grid, kThreads, S::kBytes, stream>>>(qmap, kmap, vmap, kp);
  return cudaGetLastError();
}

template <typename T, int D, bool kCap, bool kPartials>
int launch_chunked_split(const ChunkedParams& p, const ChunkedViews& w, cudaStream_t s) {
  if constexpr (splits_p(D))
    if (p.sq <= kSplitRows) return launch_chunked<T, D, kCap, true, kPartials>(p, w, s);
  return launch_chunked<T, D, kCap, false, kPartials>(p, w, s);
}

template <typename T, int D, bool kPartials>
int launch_chunked_cap(const ChunkedParams& p, const ChunkedViews& w, cudaStream_t s) {
  return p.sc.softcap_log2 > 0.f ? launch_chunked_split<T, D, true, kPartials>(p, w, s)
                                 : launch_chunked_split<T, D, false, kPartials>(p, w, s);
}

// d runs in the layout of padded_head_dim(d, true) (up to 512); splits_p
// is decided on that layout, so D 96 keeps P in two parts at verify rounds
// as D 128 does.
template <typename T, bool kPartials>
int dispatch_chunked(const ChunkedParams& p, const ChunkedViews& w, int d, cudaStream_t s) {
  const int layout = padded_head_dim(d, true);
  if (layout == 64) return launch_chunked_cap<T, 64, kPartials>(p, w, s);
  if (layout == 128) return launch_chunked_cap<T, 128, kPartials>(p, w, s);
  if (layout == 256) return launch_chunked_cap<T, 256, kPartials>(p, w, s);
  if (layout == 512) return launch_chunked_cap<T, 512, kPartials>(p, w, s);
  return cudaErrorInvalidValue;
}

template <typename T>
static void report_type(char* out, int cap, int& used, const char* t) {
  char name[96];
#define CHUNKED_REPORT(d, c, sp, pa)                                                        \
  snprintf(name, sizeof(name), "B4 D%d %s%s%s%s", d, t, c ? " cap" : "", sp ? " split-P" : "", \
           pa ? " partials" : "");                                                          \
  report_one(out, cap, used, name, (chunked_kernel<T, d, c, sp, pa>), ChunkedSmem<d>::kBytes)
#define CHUNKED_REPORTS(pa)            \
  CHUNKED_REPORT(64, false, false, pa);  \
  CHUNKED_REPORT(64, true, false, pa);   \
  CHUNKED_REPORT(128, false, false, pa); \
  CHUNKED_REPORT(128, true, false, pa);  \
  CHUNKED_REPORT(256, false, false, pa); \
  CHUNKED_REPORT(256, true, false, pa);  \
  CHUNKED_REPORT(512, false, false, pa); \
  CHUNKED_REPORT(512, true, false, pa);  \
  CHUNKED_REPORT(64, false, true, pa);   \
  CHUNKED_REPORT(64, true, true, pa);    \
  CHUNKED_REPORT(128, false, true, pa);  \
  CHUNKED_REPORT(128, true, true, pa)
  CHUNKED_REPORTS(false);
  CHUNKED_REPORTS(true);
#undef CHUNKED_REPORTS
#undef CHUNKED_REPORT
}

}  // namespace fact

// Writes the report of every B4 instantiation (the launch's registers: the
// consumers raise theirs to 240 by setmaxnreg; local (spill) bytes; shared
// memory) into `out` (at most `cap` bytes, NUL-terminated); returns 0.
extern "C" int fact_chunked_report(char* out, int cap) {
  int used = 0;
  if (cap <= 0) return 0;
  out[0] = 0;
  fact::report_type<__nv_bfloat16>(out, cap, used, "bf16");
  fact::report_type<__half>(out, cap, used, "f16");
  out[cap - 1] = 0;
  return 0;
}

namespace fact {

// The launch of both entry points: O (normalised, q's type) or, with
// partials, O unnormalised in fp32 at `o` and m, l at `m`, `l`.
static int chunked_entry(const void* q, const void* k, const void* v, void* o, void* m, void* l,
                         bool partials, const void* q_offset, const void* kv_length, int batch,
                         int hq, int hkv, int sq, int capacity, int d, const long long (&st)[9],
                         float scale_log2, float softcap_log2, int causal, int window, int dtype,
                         void* stream) {
  if (hkv <= 0 || hq % hkv) return cudaErrorInvalidValue;
  ChunkedParams p{};
  p.o = o;
  p.q_offset = static_cast<const int*>(q_offset);
  p.kv_length = static_cast<const int*>(kv_length);
  p.batch = batch, p.hq = hq, p.group = hq / hkv, p.sq = sq, p.capacity = capacity;
  p.heads = packed_heads(p.group, sq);
  p.runs = hq / p.heads;
  p.rows = p.heads * sq;
  p.box_rows = p.heads > 1 ? sq : kBlockM;
  p.sc = scores(scale_log2, softcap_log2);
  p.causal = causal;
  p.window = window;
  p.d = d;
  p.m = static_cast<float*>(m), p.l = static_cast<float*>(l);
  const ChunkedViews w{q, k, v, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
                       hkv, dtype};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return partials ? dispatch_chunked<__nv_bfloat16, true>(p, w, d, s)
                    : dispatch_chunked<__nv_bfloat16, false>(p, w, d, s);
  if (dtype == kF16)
    return partials ? dispatch_chunked<__half, true>(p, w, d, s)
                    : dispatch_chunked<__half, false>(p, w, d, s);
  return cudaErrorInvalidValue;
}

}  // namespace fact

// Returns a cudaError_t code (0 on success). Shapes, strides and dtypes are
// checked by the Python wrapper (ops/flash_chunked.py).
extern "C" int fact_flash_chunked(const void* q, const void* k, const void* v, void* o,
                                  const void* q_offset, const void* kv_length,
                                  int batch, int hq, int hkv, int sq, int capacity, int d,
                                  long long q_sb, long long q_sh, long long q_ss,
                                  long long k_sb, long long k_sh, long long k_ss,
                                  long long v_sb, long long v_sh, long long v_ss,
                                  float scale_log2, float softcap_log2, int causal, int window,
                                  int dtype, void* stream) {
  const long long st[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  return fact::chunked_entry(q, k, v, o, nullptr, nullptr, false, q_offset, kv_length, batch, hq,
                             hkv, sq, capacity, d, st, scale_log2, softcap_log2, causal, window,
                             dtype, stream);
}

// The (o, m, l) partials: `o` [B, Hq, S, d] fp32 (not divided by l) at
// rows of row_pitch(d) floats, `m` and `l` [B, Hq, S] fp32, all otherwise
// contiguous; the other arguments as above (d from 1 to 512).
extern "C" int fact_flash_chunked_partials(
    const void* q, const void* k, const void* v, void* o, void* m, void* l,
    const void* q_offset, const void* kv_length, int batch, int hq, int hkv, int sq,
    int capacity, int d, long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    float scale_log2, float softcap_log2, int causal, int window, int dtype, void* stream) {
  const long long st[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  return fact::chunked_entry(q, k, v, o, m, l, true, q_offset, kv_length, batch, hq, hkv, sq,
                             capacity, d, st, scale_log2, softcap_log2, causal, window, dtype,
                             stream);
}
