// Attention over a packed ragged batch (kernel B12): sequences concatenated
// along one token axis, q [Hq, Tq, D] and k / v [Hkv, Tkv, D] with the head
// dim contiguous, delimited by int32 metadata on the device: q_seg[m] and
// kv_seg[n] (segment ids, non-decreasing), q_bound[m] (the row's causal
// bound: its position in its sequence + kv_len - q_len of that sequence)
// and kv_pos[n] (the key's position in its sequence, from 0). Key n is
// visible from row m iff kv_seg[n] == q_seg[m], when causal
// kv_pos[n] <= q_bound[m] (bottom-right alignment per sequence), and with a
// sliding window W kv_pos[n] > q_bound[m] - W. A row with no visible key
// (q longer than kv in a sequence, an empty kv sequence) is exact zeros.
//
// Replaces the TPU kernel flash_attention_cute_tpu/ops/flash_varlen.py
// `_flash_varlen_kernel` (:48, pallas_call at :378). It computes what that
// kernel computes, not its block structure: the TPU kernel scalar-prefetches
// a [first, last] KV block range per q block, computed by XLA gathers and
// searchsorted over the metadata, sizes its grid by max_seqlen, and runs an
// anchored lazy max over `inner` sub-blocks. Here each block of 64 query
// tokens finds its own live key range by binary searches over kv_seg on the
// device (from the first key of its first row's segment, past that row's
// window, to the last key of its last row's segment, cut at that row's
// causal bound), so lengths, offsets and segment ids never cross to the
// host, and walks only that range in 64-key tiles; tiles straddle
// segments freely and are masked with the segment ids and positions
// staged in shared memory. The softmax is exact.
//
// What bounds it on the H100: tensor-core operations, 4 * D per visible
// (row, key) pair and q head, as for P; the sequences' own causal
// triangles are the work, plus the tiles' overhang across segment edges.
// The kernel body (attention_fwd.cuh, kVarlen) is B4's mma.sync body, which
// holds the note on its design; the soft cap (Gemma2, ROADMAP.md A10b) and
// D 256 are not in it: the wrapper (ops/flash_varlen.py) raises on them.
#include "attention_fwd.cuh"

// Returns a cudaError_t code (0 on success). Shapes, strides and dtypes are
// checked by the Python wrapper (ops/flash_varlen.py).
extern "C" int fact_flash_varlen(const void* q, const void* k, const void* v, void* o,
                                 const void* q_seg, const void* q_bound, const void* kv_seg,
                                 const void* kv_pos, int hq, int hkv, int tq, int tkv, int d,
                                 long long q_sh, long long q_ss, long long k_sh, long long k_ss,
                                 long long v_sh, long long v_ss, float scale_log2, int causal,
                                 int window, int dtype, void* stream) {
  using namespace fact;
  FwdParams p{};
  p.q = q, p.k = k, p.v = v, p.o = o;
  p.q_sh = q_sh, p.q_ss = q_ss, p.k_sh = k_sh, p.k_ss = k_ss, p.v_sh = v_sh, p.v_ss = v_ss;
  p.q_seg = static_cast<const int*>(q_seg);
  p.q_bound = static_cast<const int*>(q_bound);
  p.kv_seg = static_cast<const int*>(kv_seg);
  p.kv_pos = static_cast<const int*>(kv_pos);
  p.hq = hq, p.group = hq / hkv, p.sq = tq, p.skv = tkv;
  p.scale_log2 = scale_log2;
  p.causal = causal;
  p.window = window;
  return dispatch_attention_fwd<false, true>(p, 1, d, dtype, static_cast<cudaStream_t>(stream));
}
