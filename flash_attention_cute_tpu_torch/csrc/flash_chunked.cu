// Chunked extend over a contiguous KV cache (kernel B4): the chunk's S query
// rows sit at global positions q_offset[b] + r and attend cache keys
// `col <= q_offset[b] + r` (when causal), `col < min(kv_length[b], C)` and,
// with a sliding window W > 0, `col > q_offset[b] + r - W`; a row with no
// visible key, and a batch row of kv_length 0, is exact zeros.
//
// Replaces the TPU kernel flash_attention_cute_tpu/ops/flash_chunked.py
// `_flash_chunked_kernel` (:47, pallas_call at :372). It computes what that
// kernel computes, not its block structure: the TPU kernel prefetches the
// offsets and lengths as scalars, sizes its KV grid from max(kv_length) on
// the device, clamps the KV block index so skipped steps elide their DMA,
// and runs an anchored lazy max over `inner` sub-blocks. Here every block
// reads its own row's offset and length from device memory, walks the K/V
// tiles up to min(kv_length, the causal diagonal) and stops, and the grid
// is sized from shapes alone, so no host sync sizes it. The softmax is exact.
//
// The kernel body (attention_fwd.cuh, which holds the note on what bounds
// it on the H100 and its design) is shared with B12, instantiated here with
// per-row device offsets over contiguous rows. It reads q/k/v through their
// strides, so the model's transposed views need no copy; cache rows at or
// past a row's length (uninitialised memory, possibly NaN) are never read.
// Soft cap and the (o, m, l) partials are not in this kernel: the wrapper
// (ops/flash_chunked.py) raises on them.
#include "attention_fwd.cuh"

// Returns a cudaError_t code (0 on success). Shapes, strides and dtypes are
// checked by the Python wrapper (ops/flash_chunked.py).
extern "C" int fact_flash_chunked(const void* q, const void* k, const void* v, void* o,
                                  const void* q_offset, const void* kv_length,
                                  int batch, int hq, int hkv, int sq, int capacity, int d,
                                  long long q_sb, long long q_sh, long long q_ss,
                                  long long k_sb, long long k_sh, long long k_ss,
                                  long long v_sb, long long v_sh, long long v_ss,
                                  float scale_log2, int causal, int window, int dtype,
                                  void* stream) {
  using namespace fact;
  FwdParams p{};
  p.q = q, p.k = k, p.v = v, p.o = o;
  p.q_sb = q_sb, p.q_sh = q_sh, p.q_ss = q_ss;
  p.k_sb = k_sb, p.k_sh = k_sh, p.k_ss = k_ss;
  p.v_sb = v_sb, p.v_sh = v_sh, p.v_ss = v_ss;
  p.hq = hq, p.group = hq / hkv, p.sq = sq, p.skv = capacity;
  p.scale_log2 = scale_log2;
  p.causal = causal;
  p.window = window;
  p.q_offset = static_cast<const int*>(q_offset);
  p.kv_length = static_cast<const int*>(kv_length);
  return dispatch_attention_fwd<true>(p, batch, d, dtype, static_cast<cudaStream_t>(stream));
}
