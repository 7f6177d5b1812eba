// B9, chunked prefill over a quantized paged KV cache (int8 or e4m3 values,
// one f32 scale per token and kv head): replaces the TPU kernel
// flash_attention_cute_tpu/ops/quantized.py `_quant_paged_extend_kernel`
// (:717, pallas_call at :1076), with its soft cap, its sliding window and
// every head dim from 1 to 512, in the layout of 64, 128, 256 or 512
// (padded_head_dim(d, true); rows at any 16-byte stride; D 512 is B6's
// wide layout). The kernel is B6's
// (paged_extend.cuh), whose producer warpgroup widens each tile of raw
// values exactly into q's type before the wgmma products read it; what
// bounds it and the design are there. A translation unit of its own: its 32 instantiations (bf16 / f16 q
// x int8 / e4m3 values x D x cap) build beside quantized.cu's.
#include "paged_extend.cuh"

namespace fact {

template <typename T>
int dispatch_quant_paged_extend(const PagedParams& p, const PagedViews& w, int d, int kv_dtype,
                                cudaStream_t s) {
  if (kv_dtype == kInt8) return dispatch_paged_extend<T, int8_t>(p, w, d, s);
  if (kv_dtype == kE4M3) return dispatch_paged_extend<T, e4m3>(p, w, d, s);
  return cudaErrorInvalidValue;
}

}  // namespace fact

// Returns a cudaError_t code (0 on success). Shapes, strides, dtypes and
// the plan (`box_rows`) are checked by the Python wrapper
// (ops/quantized.py). Every GQA group: a block runs one q head. `dtype` is
// q's (and the output's) code, `kv_dtype` the values' code (common.cuh).
extern "C" int fact_quant_paged_extend(
    const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
    void* o, const void* q_offset, const void* kv_length, const void* page_table, int batch,
    int hq, int hkv, int sq, int d, int pps, int page_size, int num_pages, int box_rows,
    long long q_sb, long long q_sh, long long q_ss, long long k_sh, long long k_sp,
    long long k_ss, long long v_sh, long long v_sp, long long v_ss, long long ks_sh,
    long long ks_sp, long long vs_sh, long long vs_sp, float scale_log2, float softcap_log2,
    int window, int dtype, int kv_dtype, void* stream) {
  using namespace fact;
  PagedParams p{};
  p.o = o;
  p.q_offset = static_cast<const int*>(q_offset);
  p.kv_length = static_cast<const int*>(kv_length);
  p.page_table = static_cast<const int*>(page_table);
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.ks_sh = ks_sh, p.ks_sp = ks_sp, p.vs_sh = vs_sh, p.vs_sp = vs_sp;
  p.batch = batch, p.hq = hq, p.group = hq / hkv, p.sq = sq;
  p.pps = pps, p.page_size = page_size, p.box_rows = box_rows, p.d = d;
  p.sc = scores(scale_log2, softcap_log2);
  p.window = window;
  const PagedViews w{q, k, v, q_sb, q_sh, q_ss, k_sh, k_sp, k_ss, v_sh, v_sp, v_ss,
                     hkv, num_pages, dtype};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return dispatch_quant_paged_extend<__nv_bfloat16>(p, w, d, kv_dtype, s);
  if (dtype == kF16) return dispatch_quant_paged_extend<__half>(p, w, d, kv_dtype, s);
  return cudaErrorInvalidValue;
}

// Writes the report of every B9 instantiation (the launch's registers: the
// consumers raise theirs to 232 by setmaxnreg, 224 at D 512; local (spill)
// bytes; shared memory) into `out` (at most `cap` bytes, NUL-terminated); returns 0.
extern "C" int fact_quant_paged_extend_report(char* out, int cap) {
  int used = 0;
  if (cap <= 0) return 0;
  out[0] = 0;
  fact::report_paged_extend<__nv_bfloat16, int8_t>(out, cap, used, "B9 bf16 int8");
  fact::report_paged_extend<__nv_bfloat16, fact::e4m3>(out, cap, used, "B9 bf16 e4m3");
  fact::report_paged_extend<__half, int8_t>(out, cap, used, "B9 f16 int8");
  fact::report_paged_extend<__half, fact::e4m3>(out, cap, used, "B9 f16 e4m3");
  out[cap - 1] = 0;
  return 0;
}
