// Split-KV single-token decode: partials (kernel D1) and their combine
// (kernel D2).
//
// D1 replaces the TPU kernel flash_attention_cute_tpu/ops/flash_decode.py
// `_flash_decode_kernel` (pallas_call at :311), sliding window (keys
// n >= length - W; splits wholly below it are dead), tanh soft cap and head
// dims 64, 128 and 256 included; D2 replaces the
// XLA combine
// at flash_decode.py:345-358 and also merges the splits of the paged decode
// kernel B5 (paged_attention.cu), whose partials have the same layout.
//
// D1's kernel body is shared with B5 (decode_partials.cuh, which holds the
// note on what bounds it and its design); here it walks a contiguous cache
// whose KV axis is cut into `num_splits` chunks of `chunk` positions. D2 is
// a small pass over the fp32 partials. Not yet done (later work): a single
// fused launch for D1 and D2.
#include "decode_partials.cuh"

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

// Both return a cudaError_t code (0 on success). Shapes, strides and the
// group bound (G <= 8) are checked by the Python wrapper (ops/flash_decode.py).
extern "C" int fact_decode_partials(const void* q, const void* k, const void* v,
                                    const void* lengths, void* acc, void* m, void* l,
                                    int batch, int hkv, int group, int capacity, int d,
                                    int num_splits, int chunk,
                                    long long q_sb, long long q_sh,
                                    long long k_sb, long long k_sh, long long k_ss,
                                    long long v_sb, long long v_sh, long long v_ss,
                                    float scale_log2, float softcap_log2, int window, int dtype,
                                    void* stream) {
  using namespace fact;
  DecodeParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.lengths = static_cast<const int*>(lengths);
  p.acc = static_cast<float*>(acc);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.q_sb = q_sb, p.q_sh = q_sh;
  p.k_sb = k_sb, p.k_sh = k_sh, p.k_ss = k_ss;
  p.v_sb = v_sb, p.v_sh = v_sh, p.v_ss = v_ss;
  p.hkv = hkv, p.group = group, p.capacity = capacity;
  p.num_splits = num_splits, p.chunk = chunk;
  p.scale_log2 = scale_log2;
  p.softcap_log2 = softcap_log2;
  p.softcap_rcp = softcap_log2 > 0.f ? 1.f / softcap_log2 : 0.f;
  p.window = window;
  return dispatch_partials<false>(p, batch, d, dtype, static_cast<cudaStream_t>(stream));
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
