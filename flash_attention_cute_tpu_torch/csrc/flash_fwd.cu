// Prefill attention forward (kernel P): O = softmax(Q K^T * scale + mask) V.
//
// Replaces the TPU kernel flash_attention_cute_tpu/ops/flash_fwd.py
// `_flash_fwd_kernel_diag` (pallas_call at :1039). It computes what that
// kernel computes, not its block structure: bottom-right causal masking
// (key n visible from query m iff n <= m + (Skv - Sq)), exact online softmax
// in fp32 (the `stable="strict"` semantics, no lazy max), deferred 1/l with
// the l == 0 -> 0 guard so rows with no visible key emit exact zeros. GQA:
// q head h reads kv head h / (Hq / Hkv), the head-repeat order of the
// reference.
//
// What bounds it on the H100: at prefill lengths the work is tensor-core
// operations (4 * Sq * Skv * D per head, about half of it under the causal
// mask), far above the card's ~295 operations per byte, so the bound is the
// bf16 tensor-core rate. Design: one block of 4 warps per (64 query rows,
// q head, batch row); each warp owns 16 rows. QK^T and PV run on mma.sync
// m16n8k16 with fp32 accumulators; S stays in registers and is reused as
// the A operand of PV (the accumulator layout of m16n8k16 is its A layout),
// so scores never touch shared memory. KV tiles past the causal diagonal
// are skipped, and only tiles that straddle it or the ragged end are
// masked. Blocks with the longest causal rows are launched first. Not yet
// done (later work): TMA/cp.async pipelining, wgmma, loading each K/V tile
// once per GQA group.
#include "common.cuh"

namespace fact {

struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;  // [B, Hq, Sq, D] contiguous
  int64_t q_sb, q_sh, q_ss;  // element strides; the head dim is contiguous
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int hq, group, sq, skv;
  float scale_log2;  // softmax_scale * log2(e): softmax runs in base 2
  int causal;
};

constexpr int kBlockM = 64;   // query rows per block (16 per warp)
constexpr int kBlockN = 64;   // keys per tile
constexpr int kThreads = 128;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const FwdParams p) {
  constexpr int kRow = D + 8;          // smem row stride of Q and K (bank spread)
  constexpr int kVtRow = kBlockN + 8;  // smem row stride of V^T
  constexpr int kChunks = D / 8;       // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + kBlockM * kRow;
  T* sVt = sK + kBlockN * kRow;

  const int m_block = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const int m0 = m_block * kBlockM;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* o = static_cast<T*>(p.o) + (static_cast<int64_t>(b) * p.hq + h) * p.sq * D;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int wr = warp * 16;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int c = tid; c < kBlockM * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    uint4 val = zero;
    if (m0 + r < p.sq)
      val = *reinterpret_cast<const uint4*>(q + static_cast<int64_t>(m0 + r) * p.q_ss + col);
    *reinterpret_cast<uint4*>(sQ + r * kRow + col) = val;
  }
  __syncthreads();
  uint32_t qf[D / 16][4];  // this warp's 16 query rows as A fragments
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const T* base = sQ + (wr + g) * kRow + kk * 16 + 2 * t;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(base);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kRow);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(base + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kRow + 8);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] = 0.f;
  // Thread-local statistics of rows row0 (fragment elements 0,1) and row1
  // (elements 2,3); the running sum is reduced across the quad at the end.
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};
  const int row0 = m0 + wr + g, row1 = row0 + 8;

  const int offset = p.skv - p.sq;
  int n_end = p.skv;
  if (p.causal) n_end = min(n_end, m0 + kBlockM + offset);  // skip tiles past the diagonal
  const int n_tiles = n_end > 0 ? (n_end + kBlockN - 1) / kBlockN : 0;

  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * kBlockN;
    __syncthreads();  // every warp is done with the previous tile
    for (int c = tid; c < kBlockN * kChunks; c += kThreads) {
      const int r = c / kChunks, col = (c % kChunks) * 8;
      uint4 kv = zero, vv = zero;  // rows past Skv load as zeros, never garbage
      if (n0 + r < p.skv) {
        kv = *reinterpret_cast<const uint4*>(k + static_cast<int64_t>(n0 + r) * p.k_ss + col);
        vv = *reinterpret_cast<const uint4*>(v + static_cast<int64_t>(n0 + r) * p.v_ss + col);
      }
      *reinterpret_cast<uint4*>(sK + r * kRow + col) = kv;
      const T* ve = reinterpret_cast<const T*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) sVt[(col + e) * kVtRow + r] = ve[e];
    }
    __syncthreads();

    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        const T* base = sK + (nt * 8 + g) * kRow + kk * 16 + 2 * t;
        Elem<T>::mma(s[nt], qf[kk], *reinterpret_cast<const uint32_t*>(base),
                     *reinterpret_cast<const uint32_t*>(base + 8));
      }
    }

    // Only tiles straddling the ragged end or the diagonal need the mask.
    const bool edge =
        n0 + kBlockN > p.skv || (p.causal && n0 + kBlockN - 1 > m0 + offset);
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[nt][i] * p.scale_log2;
        if (edge) {
          const int col = n0 + nt * 8 + 2 * t + (i & 1);
          const int row = i < 2 ? row0 : row1;
          if (col >= p.skv || (p.causal && col > row + offset)) x = -INFINITY;
        }
        s[nt][i] = x;
      }
    }

    float m_use[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(row_max[r], mx);
      // A row with no visible key yet keeps max -inf; referencing it to 0
      // makes exp2(-inf - ref) exactly 0 and never -inf - -inf = NaN.
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = exp2f(row_max[r] - m_use[r]);
      row_max[r] = m_new;
    }
    float tile_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[nt][i] = exp2f(s[nt][i] - m_use[i >> 1]);
        tile_sum[i >> 1] += s[nt][i];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) row_sum[r] = row_sum[r] * alpha[r] + tile_sum[r];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // O += P V with P taken from the score registers.
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t a[4];
      a[0] = Elem<T>::pack(s[2 * kk][0], s[2 * kk][1]);
      a[1] = Elem<T>::pack(s[2 * kk][2], s[2 * kk][3]);
      a[2] = Elem<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = Elem<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const T* base = sVt + (dt * 8 + g) * kVtRow + kk * 16 + 2 * t;
        Elem<T>::mma(acc[dt], a, *reinterpret_cast<const uint32_t*>(base),
                     *reinterpret_cast<const uint32_t*>(base + 8));
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = row_sum[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = l > 0.f ? 1.f / l : 0.f;  // no visible key -> exact zero row
  }
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row0 < p.sq)
      *reinterpret_cast<uint32_t*>(o + static_cast<int64_t>(row0) * D + col) =
          Elem<T>::pack(acc[dt][0] * inv[0], acc[dt][1] * inv[0]);
    if (row1 < p.sq)
      *reinterpret_cast<uint32_t*>(o + static_cast<int64_t>(row1) * D + col) =
          Elem<T>::pack(acc[dt][2] * inv[1], acc[dt][3] * inv[1]);
  }
}

template <typename T, int D>
int launch_fwd(const FwdParams& p, int batch, cudaStream_t stream) {
  constexpr int kSmem =
      (kBlockM * (D + 8) + kBlockN * (D + 8) + D * (kBlockN + 8)) * static_cast<int>(sizeof(T));
  static bool configured = false;  // above 48 KB needs an explicit opt-in
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((p.sq + kBlockM - 1) / kBlockM, p.hq, batch);
  flash_fwd_kernel<T, D><<<grid, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace fact

// Returns a cudaError_t code (0 on success). Shapes and strides are checked
// by the Python wrapper (ops/flash_fwd.py).
extern "C" int fact_flash_fwd(const void* q, const void* k, const void* v, void* o,
                              int batch, int hq, int hkv, int sq, int skv, int d,
                              long long q_sb, long long q_sh, long long q_ss,
                              long long k_sb, long long k_sh, long long k_ss,
                              long long v_sb, long long v_sh, long long v_ss,
                              float scale_log2, int causal, int dtype, void* stream) {
  using namespace fact;
  FwdParams p{q, k, v, o, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
              hq, hq / hkv, sq, skv, scale_log2, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16 && d == 64) return launch_fwd<__nv_bfloat16, 64>(p, batch, s);
  if (dtype == kBF16 && d == 128) return launch_fwd<__nv_bfloat16, 128>(p, batch, s);
  if (dtype == kF16 && d == 64) return launch_fwd<__half, 64>(p, batch, s);
  if (dtype == kF16 && d == 128) return launch_fwd<__half, 128>(p, batch, s);
  return cudaErrorInvalidValue;
}
