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
// Both take the tanh soft cap (`softcap_log2`, c * log2(e), 0 for none) and
// head dims 64, 128 and 256 (Gemma2: D 256, c 50); the lse kernel takes
// neither the cap nor D 256 (no backward takes them).
// Both write the per-row lse the backward (flash_bwd.cu) needs when `lse`
// is not null (`return_lse`, flash_fwd.py:845): m + log2(l) in the base-2
// units of the scores (scale * log2(e) folded in), +inf on a row with no
// visible key, exactly the TPU kernels' convention (:258-266, :580-592),
// so either package's lse feeds either package's backward. That launch is
// the body's second instantiation, attention_fwd_lse_kernel (one 4-byte
// store a row more), so the kernel without the lse is unchanged.
// They compute what those kernels compute, not their block structure: the
// TPU kernels pack a q-head group per grid cell and skip KV blocks wholly
// below every row's window in the grid; here each block walks its own tile
// range, from the tile holding its first visible key to the causal end.
//
// The kernel body (attention_fwd.cuh, which holds the note on what bounds
// it on the H100 and its design) is shared with B4, B6 and B9; here it
// reads contiguous K/V through their strides, so the model's transposed
// q/k/v views need no copy.
#include "attention_fwd.cuh"

// Returns a cudaError_t code (0 on success). Shapes and strides are checked
// by the Python wrapper (ops/flash_fwd.py).
extern "C" int fact_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              int batch, int hq, int hkv, int sq, int skv, int d,
                              long long q_sb, long long q_sh, long long q_ss,
                              long long k_sb, long long k_sh, long long k_ss,
                              long long v_sb, long long v_sh, long long v_ss,
                              float scale_log2, float softcap_log2, int causal, int window,
                              int dtype, void* stream) {
  using namespace fact;
  FwdParams p{};
  p.q = q, p.k = k, p.v = v, p.o = o;
  p.lse = static_cast<float*>(lse);
  p.q_sb = q_sb, p.q_sh = q_sh, p.q_ss = q_ss;
  p.k_sb = k_sb, p.k_sh = k_sh, p.k_ss = k_ss;
  p.v_sb = v_sb, p.v_sh = v_sh, p.v_ss = v_ss;
  p.hq = hq, p.group = hq / hkv, p.sq = sq, p.skv = skv;
  p.scale_log2 = scale_log2;
  p.softcap_log2 = softcap_log2;
  p.softcap_rcp = softcap_log2 > 0.f ? 1.f / softcap_log2 : 0.f;
  p.causal = causal;
  p.window = window;
  return dispatch_attention_fwd<false, false, false, false, true>(
      p, batch, d, dtype, static_cast<cudaStream_t>(stream));
}
