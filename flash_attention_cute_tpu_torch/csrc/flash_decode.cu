// Split-KV single-token decode: partials (kernel D1) and their combine
// (kernel D2).
//
// D1 replaces the TPU kernel flash_attention_cute_tpu/ops/flash_decode.py
// `_flash_decode_kernel` (pallas_call at :311); D2 replaces the XLA combine
// at flash_decode.py:345-358.
//
// What bounds them on the H100: decode reads every live K/V row once and
// does 4 * G * D operations per row for G = Hq / Hkv query rows, about
// G operations per byte, far below the card's ~295, so the bound is memory
// bytes. Design: one block of 128 threads per (split, kv head, batch row)
// carries the whole GQA group of G query rows, so each K/V row is read
// once per group. D / 8 threads share a key row and each loads 16 bytes of
// it, so a warp reads whole rows with 16-byte loads. A block reads its own
// length from the `lengths` device tensor; the grid is sized from the
// cache capacity and the split count, never from the live lengths (no host
// sync per step), and splits that start past the length write m = -inf,
// l = 0, acc = 0 and exit. Rows at or past the length are never loaded, so
// a cache tail of uninitialised memory (even NaN) cannot leak in.
// Scores are kept in base 2 (scale * log2(e) folded in), as in the prefill
// kernel. Not yet done (later work): cp.async/TMA prefetch of the next
// tile, and a single fused launch for D1 and D2.
#include "common.cuh"

namespace fact {

struct DecodeParams {
  const void* q;         // [B, Hq, 1, D]
  const void* k;         // one layer's cache [B, Hkv, C, D]
  const void* v;
  const int* lengths;    // [B] int32 on the device
  float* acc;            // [B, Hkv, S, G, D] unnormalised partial outputs
  float* m;              // [B, Hkv, S, G] running max (base 2)
  float* l;              // [B, Hkv, S, G] running sum
  int64_t q_sb, q_sh;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int hkv, group, capacity, num_splits, chunk;
  float scale_log2;
};

constexpr int kThreads = 128;
constexpr int kTile = 64;  // keys per softmax step

template <typename T, int D, int GMAX>
__global__ void __launch_bounds__(kThreads) decode_partials_kernel(const DecodeParams p) {
  constexpr int kTpk = D / 8;             // threads per key row
  constexpr int kSlots = kThreads / kTpk;  // key rows in flight per pass
  __shared__ float s_p[GMAX][kTile];       // scores, then probabilities
  __shared__ float s_red[kSlots][GMAX][D];  // cross-slot reduction of acc
  __shared__ float s_m[GMAX], s_l[GMAX], s_alpha[GMAX];

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = p.group;
  const int64_t part = (static_cast<int64_t>(b) * p.hkv + hk) * p.num_splits + split;
  float* acc_out = p.acc + part * G * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const int len = min(max(p.lengths[b], 0), p.capacity);
  const int start = split * p.chunk;
  const int end = min(start + p.chunk, len);
  if (start >= end) {  // dead split: contributes weight 0 in the combine
    for (int i = tid; i < G * D; i += kThreads) acc_out[i] = 0.f;
    if (tid < G) {
      p.m[part * G + tid] = -INFINITY;
      p.l[part * G + tid] = 0.f;
    }
    return;
  }

  const int slot = tid / kTpk, d0 = (tid % kTpk) * 8;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  float qr[GMAX][8];  // this thread's 8 head-dim entries of each query row
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G) {
      uint4 raw = *reinterpret_cast<const uint4*>(q + (hk * G + g) * p.q_sh + d0);
      unpack8<T>(raw, qr[g]);
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[g][e] *= p.scale_log2;
    }
  }
  float acc[GMAX][8];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  if (tid < G) {
    s_m[tid] = -INFINITY;
    s_l[tid] = 0.f;
  }

  for (int tile0 = start; tile0 < end; tile0 += kTile) {
    const int tn = min(kTile, end - tile0);
    __syncthreads();  // s_p is free, s_m/s_l are visible
    // Scores: the kTpk threads of a slot split one key row and reduce.
    for (int kk = slot; kk < kTile; kk += kSlots) {
      float sc[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) sc[g] = 0.f;
      if (kk < tn) {
        float kf[8];
        unpack8<T>(*reinterpret_cast<const uint4*>(k + static_cast<int64_t>(tile0 + kk) * p.k_ss + d0), kf);
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
#pragma unroll
          for (int e = 0; e < 8; ++e) sc[g] += qr[g][e] * kf[e];
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
#pragma unroll
        for (int off = kTpk / 2; off > 0; off >>= 1)
          sc[g] += __shfl_xor_sync(0xffffffffu, sc[g], off);
      if (tid % kTpk == 0) {
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          if (g < G) s_p[g][kk] = kk < tn ? sc[g] : -INFINITY;
      }
    }
    __syncthreads();
    // Online softmax update, one warp per query row of the group.
    for (int g = warp; g < G; g += kThreads / 32) {
      const float x0 = s_p[g][lane], x1 = s_p[g][lane + 32];
      const float m_old = s_m[g];
      // The tile holds at least one live key, so m_new is finite.
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      const float p0 = exp2f(x0 - m_new), p1 = exp2f(x1 - m_new);
      const float sum = warp_sum(p0 + p1);
      s_p[g][lane] = p0;
      s_p[g][lane + 32] = p1;
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_new);  // 0 on the first tile
        s_alpha[g] = alpha;
        s_m[g] = m_new;
        s_l[g] = s_l[g] * alpha + sum;
      }
    }
    __syncthreads();
    // acc = acc * alpha + P V over this thread's keys and head-dim entries.
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
        const float a = s_alpha[g];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] *= a;
      }
    }
    for (int kk = slot; kk < tn; kk += kSlots) {
      float vf[8];
      unpack8<T>(*reinterpret_cast<const uint4*>(v + static_cast<int64_t>(tile0 + kk) * p.v_ss + d0), vf);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {
          const float pr = s_p[g][kk];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] += pr * vf[e];
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < GMAX; ++g)
    if (g < G)
#pragma unroll
      for (int e = 0; e < 8; ++e) s_red[slot][g][d0 + e] = acc[g][e];
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float sum = 0.f;
#pragma unroll
    for (int sl = 0; sl < kSlots; ++sl) sum += s_red[sl][g][d];
    acc_out[i] = sum;
  }
  if (tid < G) {
    p.m[part * G + tid] = s_m[tid];
    p.l[part * G + tid] = s_l[tid];
  }
}

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

template <typename T, int D, int GMAX>
int launch_partials(const DecodeParams& p, int batch, cudaStream_t stream) {
  const dim3 grid(p.num_splits, p.hkv, batch);
  decode_partials_kernel<T, D, GMAX><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
int dispatch_group(const DecodeParams& p, int batch, cudaStream_t stream) {
  if (p.group <= 1) return launch_partials<T, D, 1>(p, batch, stream);
  if (p.group <= 2) return launch_partials<T, D, 2>(p, batch, stream);
  if (p.group <= 4) return launch_partials<T, D, 4>(p, batch, stream);
  if (p.group <= 8) return launch_partials<T, D, 8>(p, batch, stream);
  return cudaErrorInvalidValue;
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
                                    float scale_log2, int dtype, void* stream) {
  using namespace fact;
  DecodeParams p{q, k, v, static_cast<const int*>(lengths), static_cast<float*>(acc),
                 static_cast<float*>(m), static_cast<float*>(l),
                 q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                 hkv, group, capacity, num_splits, chunk, scale_log2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16 && d == 64) return dispatch_group<__nv_bfloat16, 64>(p, batch, s);
  if (dtype == kBF16 && d == 128) return dispatch_group<__nv_bfloat16, 128>(p, batch, s);
  if (dtype == kF16 && d == 64) return dispatch_group<__half, 64>(p, batch, s);
  if (dtype == kF16 && d == 128) return dispatch_group<__half, 128>(p, batch, s);
  return cudaErrorInvalidValue;
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
