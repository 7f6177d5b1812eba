// Attention over a quantized KV cache (int8 or e4m3 values, one f32 scale
// per token and kv head), and the append that fills it:
//
//   * B7, quantized decode: replaces the TPU kernel
//     flash_attention_cute_tpu/ops/quantized.py `_quant_decode_kernel` (:73,
//     pallas_call at :337). Split-KV decode partials over one layer of the
//     contiguous cache [B, Hkv, C, D] with scales [B, Hkv, C]; D2
//     (flash_decode.cu) merges the splits. It takes B2's sliding window (0
//     for none), the tanh soft cap, every head dim from 1 to 512 (in the
//     layout of 64, 128, 256 or 512: padded_head_dim(d, true)) and every
//     GQA group (above 32 in chunks of at most 32 rows, a block each), as
//     D1 does. B8, the quantized paged decode, is
//     quant_paged_decode.cu; B9, the quantized paged extend,
//     quant_paged_extend.cu.
//   * QA, quantize-and-append (not a TPU kernel): replaces the XLA
//     `quantize_kv` + scatter / dynamic_update_slice of
//     flash_attention_cute_tpu/runtime/paged_cache.py
//     `paged_append_layer_quantized` (:206-239) and models/transformer.py
//     (:167-175). Writes S new K/V rows per batch row, quantized per token,
//     at positions lengths[b] + s of the contiguous cache or through the
//     page table; rows of inactive batch rows and positions past the table
//     (or past the cache) write nothing. Every head dim from 1 to 512, its
//     rows at any stride (it reads and writes single elements).
//
// What bounds them on the H100, and the design. B7 is B8's kernel
// (paged_decode.cuh) over a contiguous cache, as D1 is B5's: bound by
// bytes, which 1-byte values halve; the values are widened exactly to q's
// type in registers, the K scale multiplies each score before the cap, the
// V scale each probability, so no row is dequantized; the scales of any
// capacity come by 4-byte copies. Not copied from the TPU decode kernel:
// the `nh` head packing and 8192-token page blocks. QA is bound by bytes
// (each new row read once, its values and scale written once): one block
// per (token, batch row), one warp per (K or V, kv head) row, an fp32 amax
// over the row by a warp reduction, scale = amax / qmax (1 where amax is
// 0), values x / scale rounded half to even. Compiled for the layout's D
// (D / 32 values a lane: 16 at D 512); below D `quant_append_tail_kernel` reads and
// writes the row's d values only: a lane past d would read the next head's
// or token's row into the amax and write over it. At d = D
// `quant_append_kernel` has no such bound (it cost 16 % at D 256, PERF.md).
// The division is IEEE (no fast-math flags in ops/_build.py), so the values
// are bit-identical to the plain version's.
#include "paged_decode.cuh"

namespace fact {

struct QuantAppendParams {
  const void* k_new;  // [B, Hkv, S, D] in T (any strides, head dim contiguous)
  const void* v_new;
  void* k_vals;       // contiguous: one layer's cache [B, Hkv, C, D];
  void* v_vals;       // paged: one layer's pool [Hkv, P, ps, D]
  float* k_scales;    // the same without the head dim, position stride 1
  float* v_scales;
  const int* lengths;     // [B] int32: positions before the append
  const int* page_table;  // paged: [B, pps] int32
  const int* active;      // [B] int32 or null: 0 drops the row
  int64_t kn_sb, kn_sh, kn_ss, vn_sb, vn_sh, vn_ss;  // element strides of the new rows
  int64_t c_sb, c_sh, c_ss, c_sp;  // value strides (K and V pools alike); sb contiguous, sp paged
  int64_t s_sb, s_sh, s_sp;        // scale strides (K and V alike)
  int hkv, capacity, pps, page_size;
  int d;  // the true head dim, D or below it in D's layout
};

// The kernel's body; kTail: the row's d is below the layout's D.
template <typename T, typename KV, int D, bool kPaged, bool kTail>
__device__ __forceinline__ void quant_append_body(const QuantAppendParams& p) {
  constexpr int kPer = D / 32;  // elements of the layout's row per lane
  const int s = blockIdx.x, b = blockIdx.y;
  if (p.active != nullptr && p.active[b] == 0) return;
  const int pos = p.lengths[b] + s;
  int64_t vrow, srow;  // offsets of the target position, head excluded
  if constexpr (kPaged) {
    const int slot = pos / p.page_size;
    if (pos < 0 || slot >= p.pps) return;  // past the table: dropped
    const int64_t page = p.page_table[static_cast<int64_t>(b) * p.pps + slot];
    const int off = pos % p.page_size;
    vrow = page * p.c_sp + off * p.c_ss;
    srow = page * p.s_sp + off;
  } else {
    if (pos < 0 || pos >= p.capacity) return;
    vrow = b * p.c_sb + pos * p.c_ss;
    srow = b * p.s_sb + pos;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int task = warp; task < 2 * p.hkv; task += blockDim.x >> 5) {
    const bool is_v = task >= p.hkv;
    const int h = is_v ? task - p.hkv : task;
    const T* src = is_v
        ? static_cast<const T*>(p.v_new) + b * p.vn_sb + h * p.vn_sh + s * p.vn_ss
        : static_cast<const T*>(p.k_new) + b * p.kn_sb + h * p.kn_sh + s * p.kn_ss;
    float x[kPer];
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      x[i] = !kTail || lane + 32 * i < p.d ? Elem<T>::to_float(src[lane + 32 * i]) : 0.f;
      amax = fmaxf(amax, fabsf(x[i]));
    }
    amax = warp_max(amax);
    const float scale = amax == 0.f ? 1.f : amax / kv_qmax<KV>();
    KV* dst = static_cast<KV*>(is_v ? p.v_vals : p.k_vals) + h * p.c_sh + vrow;
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      if (!kTail || lane + 32 * i < p.d) kv_round(x[i] / scale, dst + lane + 32 * i);
    if (lane == 0) (is_v ? p.v_scales : p.k_scales)[h * p.s_sh + srow] = scale;
  }
}

// d = D.
template <typename T, typename KV, int D, bool kPaged>
__global__ void __launch_bounds__(128) quant_append_kernel(const QuantAppendParams p) {
  quant_append_body<T, KV, D, kPaged, false>(p);
}

// d below D, in D's layout.
template <typename T, typename KV, int D, bool kPaged>
__global__ void __launch_bounds__(128) quant_append_tail_kernel(const QuantAppendParams p) {
  quant_append_body<T, KV, D, kPaged, true>(p);
}

template <typename T, typename KV, int D, bool kPaged>
void launch_append_layout(const QuantAppendParams& p, dim3 grid, int d, cudaStream_t stream) {
  if (d == D) quant_append_kernel<T, KV, D, kPaged><<<grid, 128, 0, stream>>>(p);
  else quant_append_tail_kernel<T, KV, D, kPaged><<<grid, 128, 0, stream>>>(p);
}

template <typename T, typename KV, bool kPaged>
int launch_append(const QuantAppendParams& p, int batch, int s, int d, cudaStream_t stream) {
  const dim3 grid(s, batch);
  const int layout = padded_head_dim(d, true);
  if (layout == 64) launch_append_layout<T, KV, 64, kPaged>(p, grid, d, stream);
  else if (layout == 128) launch_append_layout<T, KV, 128, kPaged>(p, grid, d, stream);
  else if (layout == 256) launch_append_layout<T, KV, 256, kPaged>(p, grid, d, stream);
  else if (layout == 512) launch_append_layout<T, KV, 512, kPaged>(p, grid, d, stream);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <typename T, bool kPaged>
int dispatch_append_values(const QuantAppendParams& p, int batch, int s, int d, int kv_dtype,
                           cudaStream_t stream) {
  if (kv_dtype == kInt8) return launch_append<T, int8_t, kPaged>(p, batch, s, d, stream);
  if (kv_dtype == kE4M3) return launch_append<T, e4m3, kPaged>(p, batch, s, d, stream);
  return cudaErrorInvalidValue;
}

template <bool kPaged>
int dispatch_append(const QuantAppendParams& p, int batch, int s, int d, int dtype,
                    int kv_dtype, cudaStream_t stream) {
  if (dtype == kBF16) return dispatch_append_values<__nv_bfloat16, kPaged>(p, batch, s, d, kv_dtype, stream);
  if (dtype == kF16) return dispatch_append_values<__half, kPaged>(p, batch, s, d, kv_dtype, stream);
  return cudaErrorInvalidValue;
}

}  // namespace fact

// Each returns a cudaError_t code (0 on success). Shapes, strides, dtypes
// and their 16-byte alignment (the values') are checked by the Python
// wrapper (ops/quantized.py); B7's `chunks` and `rows` are the group's
// chunk plan (dispatch.decode_group_chunks). `dtype` is q's (and the output's) code,
// `kv_dtype` the values' code (common.cuh).
extern "C" int fact_quant_decode_partials(
    const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
    const void* lengths, void* acc, void* m, void* l, int batch, int hkv, int group,
    int chunks, int rows, int capacity, int d, int num_splits, int chunk, long long q_sb, long long q_sh,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long ks_sb, long long ks_sh, long long vs_sb, long long vs_sh,
    float scale_log2, float softcap_log2, int window, int dtype, int kv_dtype, void* stream) {
  using namespace fact;
  using bf16 = __nv_bfloat16;
  PagedDecodeParams p{};
  p.q = q;
  p.lengths = static_cast<const int*>(lengths);
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.acc = static_cast<float*>(acc);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.q_sb = q_sb, p.q_sh = q_sh;
  p.ks_sh = ks_sh, p.ks_sp = ks_sb, p.vs_sh = vs_sh, p.vs_sp = vs_sb;
  p.hkv = hkv, p.group = group, p.chunks = chunks, p.rows = rows;
  p.num_splits = num_splits;
  p.pps = 1, p.page_size = capacity, p.chunk = chunk, p.d = d;
  p.sc = scores(scale_log2, softcap_log2);
  p.window = window;
  const PagedViews w{q, k, v, q_sb, q_sh, 0, k_sh, k_sb, k_ss, v_sh, v_sb, v_ss,
                     hkv, batch, dtype};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16 && kv_dtype == kInt8) return dispatch_paged_decode<bf16, int8_t, true>(p, w, batch, d, s);
  if (dtype == kBF16 && kv_dtype == kE4M3) return dispatch_paged_decode<bf16, e4m3, true>(p, w, batch, d, s);
  if (dtype == kF16 && kv_dtype == kInt8) return dispatch_paged_decode<__half, int8_t, true>(p, w, batch, d, s);
  if (dtype == kF16 && kv_dtype == kE4M3) return dispatch_paged_decode<__half, e4m3, true>(p, w, batch, d, s);
  return cudaErrorInvalidValue;
}

// Writes the report of every B7 instantiation (registers, local (spill)
// bytes, shared memory) into `out` (at most `cap` bytes, NUL-terminated);
// returns 0.
extern "C" int fact_quant_decode_report(char* out, int cap) {
  int used = 0;
  if (cap <= 0) return 0;
  out[0] = 0;
  fact::report_paged_decode<__nv_bfloat16, int8_t, true>(out, cap, used, "B7 bf16 int8");
  fact::report_paged_decode<__nv_bfloat16, fact::e4m3, true>(out, cap, used, "B7 bf16 e4m3");
  fact::report_paged_decode<__half, int8_t, true>(out, cap, used, "B7 f16 int8");
  fact::report_paged_decode<__half, fact::e4m3, true>(out, cap, used, "B7 f16 e4m3");
  out[cap - 1] = 0;
  return 0;
}

// paged != 0: positions go through the page table (c_sb, s_sb unused);
// paged == 0: one layer of the contiguous cache (page_table, c_sp, s_sp
// unused).
extern "C" int fact_quant_append(
    const void* k_new, const void* v_new, void* k_vals, void* v_vals, void* k_scales,
    void* v_scales, const void* lengths, const void* page_table, const void* active,
    int paged, int batch, int s, int hkv, int d, int capacity, int pps, int page_size,
    long long kn_sb, long long kn_sh, long long kn_ss, long long vn_sb, long long vn_sh,
    long long vn_ss, long long c_sb, long long c_sh, long long c_ss, long long c_sp,
    long long s_sb, long long s_sh, long long s_sp, int dtype, int kv_dtype, void* stream) {
  using namespace fact;
  QuantAppendParams p{};
  p.k_new = k_new, p.v_new = v_new;
  p.k_vals = k_vals, p.v_vals = v_vals;
  p.k_scales = static_cast<float*>(k_scales);
  p.v_scales = static_cast<float*>(v_scales);
  p.lengths = static_cast<const int*>(lengths);
  p.page_table = static_cast<const int*>(page_table);
  p.active = static_cast<const int*>(active);
  p.kn_sb = kn_sb, p.kn_sh = kn_sh, p.kn_ss = kn_ss;
  p.vn_sb = vn_sb, p.vn_sh = vn_sh, p.vn_ss = vn_ss;
  p.c_sb = c_sb, p.c_sh = c_sh, p.c_ss = c_ss, p.c_sp = c_sp;
  p.s_sb = s_sb, p.s_sh = s_sh, p.s_sp = s_sp;
  p.hkv = hkv, p.capacity = capacity, p.pps = pps, p.page_size = page_size, p.d = d;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return paged ? dispatch_append<true>(p, batch, s, d, dtype, kv_dtype, st)
               : dispatch_append<false>(p, batch, s, d, dtype, kv_dtype, st);
}
