// B8, the quantized paged decode: replaces the TPU kernel
// flash_attention_cute_tpu/ops/quantized.py `_quant_paged_kernel` (:395,
// pallas_call at :658). Split-KV decode partials of a GQA group of any size
// (above 32 in chunks of at most 32 rows, a block each) over one layer's
// int8 / e4m3 pool [Hkv, P, ps, D] with
// f32 scales [Hkv, P, ps] through the page table; D2 (flash_decode.cu)
// merges the splits. It takes B2's sliding window, the tanh soft cap and
// every head dim from 1 to 512, in the layout of 64, 128, 256 or 512
// (padded_head_dim(d, true); rows at any 16-byte stride). The kernel is B5's
// (paged_decode.cuh): a TMA ring of pages, their scales beside them,
// feeding tensor-core consumers that widen the values exactly to q's type
// in registers; the K scale
// multiplies each score before the cap, the V scale each probability, the
// running sum keeps the unscaled one. Bound by memory bytes, which 1-byte
// values halve. A translation unit of its own, so that its 32
// instantiations build beside quantized.cu's, not after them.
#include "paged_decode.cuh"

// Returns a cudaError_t code (0 on success). Shapes, strides, dtypes and
// the scales' 16-byte alignment are checked by the Python wrapper
// (ops/quantized.py); `chunks` and `rows` are the group's chunk plan
// (dispatch.decode_group_chunks). `dtype` is q's (and the output's) code,
// `kv_dtype` the values' code (common.cuh).
extern "C" int fact_quant_paged_decode_partials(
    const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
    const void* lengths, const void* page_table, void* acc, void* m, void* l, int batch,
    int hkv, int group, int chunks, int rows, int d, int num_splits, int pps, int page_size,
    int num_pages, int box_rows, long long q_sb, long long q_sh, long long k_sh, long long k_sp, long long k_ss,
    long long v_sh, long long v_sp, long long v_ss, long long ks_sh, long long ks_sp,
    long long vs_sh, long long vs_sp, float scale_log2, float softcap_log2, int window, int dtype,
    int kv_dtype, void* stream) {
  using namespace fact;
  using bf16 = __nv_bfloat16;
  PagedDecodeParams p{};
  p.q = q;
  p.lengths = static_cast<const int*>(lengths);
  p.page_table = static_cast<const int*>(page_table);
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.acc = static_cast<float*>(acc);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.q_sb = q_sb, p.q_sh = q_sh;
  p.ks_sh = ks_sh, p.ks_sp = ks_sp, p.vs_sh = vs_sh, p.vs_sp = vs_sp;
  p.hkv = hkv, p.group = group, p.chunks = chunks, p.rows = rows;
  p.num_splits = num_splits;
  p.pps = pps, p.page_size = page_size, p.box_rows = box_rows, p.d = d;
  p.sc = scores(scale_log2, softcap_log2);
  p.window = window;
  const PagedViews w{q, k, v, q_sb, q_sh, 0, k_sh, k_sp, k_ss, v_sh, v_sp, v_ss,
                     hkv, num_pages, dtype};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16 && kv_dtype == kInt8) return dispatch_paged_decode<bf16, int8_t>(p, w, batch, d, s);
  if (dtype == kBF16 && kv_dtype == kE4M3) return dispatch_paged_decode<bf16, e4m3>(p, w, batch, d, s);
  if (dtype == kF16 && kv_dtype == kInt8) return dispatch_paged_decode<__half, int8_t>(p, w, batch, d, s);
  if (dtype == kF16 && kv_dtype == kE4M3) return dispatch_paged_decode<__half, e4m3>(p, w, batch, d, s);
  return cudaErrorInvalidValue;
}

// Writes the report of every B8 instantiation (registers, local (spill)
// bytes, shared memory) into `out` (at most `cap` bytes, NUL-terminated);
// returns 0.
extern "C" int fact_quant_paged_decode_report(char* out, int cap) {
  int used = 0;
  if (cap <= 0) return 0;
  out[0] = 0;
  fact::report_paged_decode<__nv_bfloat16, int8_t>(out, cap, used, "B8 bf16 int8");
  fact::report_paged_decode<__nv_bfloat16, fact::e4m3>(out, cap, used, "B8 bf16 e4m3");
  fact::report_paged_decode<__half, int8_t>(out, cap, used, "B8 f16 int8");
  fact::report_paged_decode<__half, fact::e4m3>(out, cap, used, "B8 f16 e4m3");
  out[cap - 1] = 0;
  return 0;
}
