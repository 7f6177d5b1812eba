// Split-KV single-token decode: partials (kernel D1) and their combine
// (kernel D2).
//
// D1 replaces the TPU kernel flash_attention_cute_tpu/ops/flash_decode.py
// `_flash_decode_kernel` (pallas_call at :311), sliding window (keys
// n >= length - W), tanh soft cap, every head dim from 1 to 512 (run in
// the layout of 64, 128, 256 or 512: paged_decode.cuh) and
// every GQA group (above 32 in chunks of at most 32 rows, a block each:
// paged_decode.cuh); D2 replaces the XLA combine at flash_decode.py:345-358
// and also merges the splits of B5, B7 and B8, whose partials have the
// same layout.
//
// D1 is the kernel of B5 (paged_decode.cuh, which holds the note on what
// bounds it and its design) over a contiguous cache: one layer's [B, Hkv,
// C, D] is read as a pool of B pages of C keys through one 4-D TMA map, and
// split s takes the keys [s chunk, (s + 1) chunk) of the visible range,
// chunk = ceil(C / num_splits). D2 is a small pass over the fp32 partials.
// Not yet done (later work): a single fused launch for D1 and D2.
#include "paged_decode.cuh"

namespace fact {

// One block per (q head, batch row), one thread per head-dim entry.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ acc, const float* __restrict__ m,
                                      const float* __restrict__ l, T* __restrict__ out,
                                      int hkv, int group, int num_splits, int d) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / group, g = h % group;
  const int64_t base = (static_cast<int64_t>(b) * hkv + hk) * num_splits;
  float m_max = -INFINITY;
  for (int s = 0; s < num_splits; ++s) m_max = fmaxf(m_max, m[(base + s) * group + g]);
  for (int e = threadIdx.x; e < d; e += blockDim.x) {
    float o = 0.f, l_tot = 0.f;
    for (int s = 0; s < num_splits; ++s) {
      const int64_t i = (base + s) * group + g;
      if (m[i] == -INFINITY) continue;  // dead split: weight 0, no -inf - -inf
      const float w = exp2f(m[i] - m_max);
      l_tot += w * l[i];
      o += w * acc[i * d + e];
    }
    const int64_t row = static_cast<int64_t>(b) * hkv * group + h;
    out[row * d + e] = Elem<T>::from_float(l_tot > 0.f ? o / l_tot : 0.f);
  }
}

}  // namespace fact

// Both return a cudaError_t code (0 on success). Shapes, strides and
// their 16-byte alignment are checked by the Python wrapper
// (ops/flash_decode.py); `chunks` and `rows` are the group's chunk plan
// (dispatch.decode_group_chunks).
extern "C" int fact_decode_partials(const void* q, const void* k, const void* v,
                                    const void* lengths, void* acc, void* m, void* l,
                                    int batch, int hkv, int group, int chunks, int rows,
                                    int capacity, int d, int num_splits, int chunk,
                                    long long q_sb, long long q_sh,
                                    long long k_sb, long long k_sh, long long k_ss,
                                    long long v_sb, long long v_sh, long long v_ss,
                                    float scale_log2, float softcap_log2, int window, int dtype,
                                    void* stream) {
  using namespace fact;
  PagedDecodeParams p{};
  p.q = q;
  p.lengths = static_cast<const int*>(lengths);
  p.acc = static_cast<float*>(acc);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.q_sb = q_sb, p.q_sh = q_sh;
  p.hkv = hkv, p.group = group, p.chunks = chunks, p.rows = rows;
  p.num_splits = num_splits;
  p.pps = 1, p.page_size = capacity, p.chunk = chunk, p.d = d;
  p.sc = scores(scale_log2, softcap_log2);
  p.window = window;
  const PagedViews w{q, k, v, q_sb, q_sh, 0, k_sh, k_sb, k_ss, v_sh, v_sb, v_ss,
                     hkv, batch, dtype};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return dispatch_paged_decode<__nv_bfloat16, __nv_bfloat16, true>(p, w, batch, d, s);
  if (dtype == kF16) return dispatch_paged_decode<__half, __half, true>(p, w, batch, d, s);
  return cudaErrorInvalidValue;
}

// Writes the report of every D1 instantiation (registers, local (spill)
// bytes, shared memory) into `out` (at most `cap` bytes, NUL-terminated);
// returns 0.
extern "C" int fact_decode_report(char* out, int cap) {
  int used = 0;
  if (cap <= 0) return 0;
  out[0] = 0;
  fact::report_paged_decode<__nv_bfloat16, __nv_bfloat16, true>(out, cap, used, "D1 bf16");
  fact::report_paged_decode<__half, __half, true>(out, cap, used, "D1 f16");
  out[cap - 1] = 0;
  return 0;
}

extern "C" int fact_decode_combine(const void* acc, const void* m, const void* l, void* out,
                                   int batch, int hkv, int group, int d, int num_splits,
                                   int dtype, void* stream) {
  using namespace fact;
  const dim3 grid(hkv * group, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(acc);
  const float* mm = static_cast<const float*>(m);
  const float* ll = static_cast<const float*>(l);
  if (dtype == kBF16)
    decode_combine_kernel<__nv_bfloat16><<<grid, d, 0, s>>>(
        a, mm, ll, static_cast<__nv_bfloat16*>(out), hkv, group, num_splits, d);
  else if (dtype == kF16)
    decode_combine_kernel<__half><<<grid, d, 0, s>>>(
        a, mm, ll, static_cast<__half*>(out), hkv, group, num_splits, d);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
