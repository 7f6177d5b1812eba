// Weight-only quantized matrix products y[T, N] = x[T, K] @ W[K, N]:
//
//   * B10, int8: replaces the TPU kernel
//     flash_attention_cute_tpu/ops/quantized_matmul.py `_qmm_kernel` (:149,
//     pallas_call at :178). W = values[K_pad, N_pad] int8 with one f32 scale
//     per column: y = (x @ values) * scales, the scale applied once to the
//     fp32 sum (exact: it is constant along K).
//   * B11, int4: replaces `_qmm4_kernel` (:360, pallas_call at :429). W is
//     nibble-packed (biased u = q + 8, block-local packing in blocks of
//     bk = min(512, K_pad) rows) with one f32 scale per (128-row group,
//     column): y = sum over groups g of s[g, n] * (x_g @ q_g). Each 64-row
//     half of a group is summed in fp32 on its own and multiplied by its
//     fp32 scale into the accumulator; the scale is never folded into a
//     bf16 weight (that would round q * s to bf16).
//
// x is bf16 or f16 with its last dim contiguous, read only up to its logical
// K (the rest of a tile is zero-filled, so x is never padded in memory); y is
// written only at its logical T x N, contiguous. The packing and padding
// are the JAX package's (ops/quantized_matmul.py in both packages).
//
// What bounds them on the H100. Decode (T of 1-16) streams the weight once
// per call: bound by its bytes (1 B an element in int8, 0.5 B in int4, plus
// scales) at 3.35 TB/s. Prefill (T in the thousands) does 2 T K N operations,
// far above the card's ~295 per byte: bound by the bf16 tensor-core rate.
// Design, simple first: one block of 4 warps per (BM rows, BN columns) of y,
// walking K in tiles of 128 rows. Each tile's weights are loaded 16 bytes a
// thread into registers one tile ahead (so the next tile's loads are in
// flight during this tile's products), widened to bf16 / f16 (exact: int8
// and q = u - 8 fit both significands) into shared memory as [K][N], and
// read as B fragments by ldmatrix.trans; x is staged beside them; the
// products run on mma.sync m16n8k16 with fp32 accumulators. T <= 16 takes
// 16 x 64 tiles (more blocks for the few-row decode grids), larger T 64 x
// 128. Not copied from the TPU kernels: their tile caps, the scale rows
// padded to 8 sublanes, the compile-service workaround, and the -8 *
// rowsum(x) correction (subtracting 8 at unpack is exact here). Not yet done
// (later work): wgmma and TMA, int8 / fp8 tensor-core products, split-K for
// the decode grids of narrow outputs.
#include "common.cuh"

namespace fact {

struct QmmParams {
  const void* x;    // [T, K] in T; row stride x_st, last dim contiguous
  const int8_t* w;  // int8: values [K_pad, N_pad]; int4: packed [K_pad / 2, N_pad]
  const float* s;   // int8: [N_pad]; int4: [K_pad / 128, N_pad]
  void* y;          // [T, N] in T, contiguous
  int t, k, n, k_pad, n_pad;
  int64_t x_st;
  int x_vec;        // x rows are 16-byte aligned: 16-byte loads
};

constexpr int kQmmBK = 128;  // K rows of a tile (int4: two 64-row halves)
constexpr int kQmmHalf = 64;
constexpr int kQmmThreads = 128;
constexpr int kGroup4 = 128;

template <int BM, int BN>
struct QmmTile {
  static constexpr int kWarpsM = BM >= 32 ? BM / 32 : 1;
  static constexpr int kWarpsN = 4 / kWarpsM;
  static constexpr int kWM = BM / kWarpsM;  // rows of y per warp
  static constexpr int kWN = BN / kWarpsN;  // columns of y per warp
  static constexpr int kMT = kWM / 16;      // m16 tiles per warp
  static constexpr int kNT = kWN / 8;       // n8 tiles per warp
  static constexpr int kXRow = kQmmBK + 8;  // smem row strides (elements), bank spread
  static constexpr int kWRow = BN + 8;
  static_assert(kNT % 2 == 0, "ldmatrix.x4 loads n8 tiles in pairs");
  template <typename T>
  static constexpr int smem_bytes() {
    return (BM * kXRow + kQmmBK * kWRow) * static_cast<int>(sizeof(T));
  }
};

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Sixteen values (floats of small integers, exact) as two uint4 of T.
template <typename T>
__device__ __forceinline__ void store16(T* dst, const float (&f)[16]) {
  uint4 lo, hi;
  uint32_t* a = reinterpret_cast<uint32_t*>(&lo);
  uint32_t* b = reinterpret_cast<uint32_t*>(&hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[i] = Elem<T>::pack(f[2 * i], f[2 * i + 1]);
    b[i] = Elem<T>::pack(f[8 + 2 * i], f[8 + 2 * i + 1]);
  }
  *reinterpret_cast<uint4*>(dst) = lo;
  *reinterpret_cast<uint4*>(dst + 8) = hi;
}

// acc += sX[:, kk*16 .. +16] @ sW[kk*16 .. +16, warp's columns] for each of
// the warp's m16 x n8 tiles.
template <typename T, typename Tile>
__device__ __forceinline__ void mma_k16(float (&acc)[Tile::kMT][Tile::kNT][4], const T* sX,
                                        const T* sW, int kk, int wm, int wn, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  uint32_t a[Tile::kMT][4];
#pragma unroll
  for (int mt = 0; mt < Tile::kMT; ++mt) {
    const T* base = sX + (wm + mt * 16 + g) * Tile::kXRow + kk * 16 + 2 * t4;
    a[mt][0] = *reinterpret_cast<const uint32_t*>(base);
    a[mt][1] = *reinterpret_cast<const uint32_t*>(base + 8 * Tile::kXRow);
    a[mt][2] = *reinterpret_cast<const uint32_t*>(base + 8);
    a[mt][3] = *reinterpret_cast<const uint32_t*>(base + 8 * Tile::kXRow + 8);
  }
#pragma unroll
  for (int np = 0; np < Tile::kNT / 2; ++np) {
    // Lanes 0-15 address rows k of the pair's first n8 tile, lanes 16-31 of
    // its second: r[0], r[1] are the first tile's b0, b1, r[2], r[3] the
    // second's.
    uint32_t b[4];
    ldmatrix_x4_trans(b, sW + (kk * 16 + (lane & 15)) * Tile::kWRow + wn + np * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int mt = 0; mt < Tile::kMT; ++mt) {
      Elem<T>::mma(acc[mt][2 * np], a[mt], b[0], b[1]);
      Elem<T>::mma(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
    }
  }
}

template <typename T, int BM, int BN, bool kInt4>
__global__ void __launch_bounds__(kQmmThreads) qmm_kernel(const QmmParams p) {
  using Tile = QmmTile<BM, BN>;
  constexpr int kMT = Tile::kMT, kNT = Tile::kNT;
  constexpr int kChunksPerRow = BN / 16;                        // 16-byte weight loads per row
  constexpr int kWRows = kInt4 ? kQmmHalf : kQmmBK;             // stored rows per tile
  constexpr int kWLoads = kWRows * kChunksPerRow / kQmmThreads;  // per thread
  static_assert(kWRows * kChunksPerRow % kQmmThreads == 0, "whole weight loads per thread");
  extern __shared__ __align__(16) unsigned char smem[];
  T* sX = reinterpret_cast<T*>(smem);
  T* sW = sX + BM * Tile::kXRow;

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp / Tile::kWarpsN) * Tile::kWM;
  const int wn = (warp % Tile::kWarpsN) * Tile::kWN;
  const T* x = static_cast<const T*>(p.x);
  const int bk = min(512, p.k_pad);  // int4 pack block
  // int8: tiles past the logical K hold only zero rows and are skipped.
  const int n_tiles = kInt4 ? p.k_pad / 2 / kQmmHalf : (p.k + kQmmBK - 1) / kQmmBK;

  // K positions of tile j's two 64-row halves (x columns 0-63 and 64-127 of
  // the tile). int4: packed rows j*64 .. +64 hold one half of a group in
  // their low nibbles and one in their high nibbles.
  auto half_rows = [&](int j, int& klo, int& khi) {
    if constexpr (kInt4) {
      const int pr = j * kQmmHalf, blk = pr / (bk / 2);
      klo = blk * bk + pr % (bk / 2);
      khi = klo + bk / 2;
    } else {
      klo = j * kQmmBK;
      khi = klo + kQmmHalf;
    }
  };
  uint4 wreg[kWLoads];
  auto load_w = [&](int j) {
#pragma unroll
    for (int i = 0; i < kWLoads; ++i) {
      const int c = tid + i * kQmmThreads;
      const int r = c / kChunksPerRow, col = (c % kChunksPerRow) * 16;
      const int64_t row = static_cast<int64_t>(j) * kWRows + r;
      wreg[i] = *reinterpret_cast<const uint4*>(p.w + row * p.n_pad + n0 + col);
    }
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  if (n_tiles > 0) load_w(0);
  for (int j = 0; j < n_tiles; ++j) {
    int klo, khi;
    half_rows(j, klo, khi);
    __syncthreads();  // every warp is done with the previous tile
    for (int c = tid; c < BM * (kQmmBK / 8); c += kQmmThreads) {
      const int r = c / (kQmmBK / 8), col = (c % (kQmmBK / 8)) * 8;
      const int kx = col < kQmmHalf ? klo + col : khi + col - kQmmHalf;
      const int row = m0 + r;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (row < p.t && kx < p.k) {
        const T* src = x + row * p.x_st + kx;
        if (p.x_vec && kx + 8 <= p.k) {
          val = *reinterpret_cast<const uint4*>(src);
        } else {
          T* e = reinterpret_cast<T*>(&val);
#pragma unroll
          for (int i = 0; i < 8; ++i) e[i] = kx + i < p.k ? src[i] : Elem<T>::from_float(0.f);
        }
      }
      *reinterpret_cast<uint4*>(sX + r * Tile::kXRow + col) = val;
    }
#pragma unroll
    for (int i = 0; i < kWLoads; ++i) {
      const int c = tid + i * kQmmThreads;
      const int r = c / kChunksPerRow, col = (c % kChunksPerRow) * 16;
      const int8_t* b = reinterpret_cast<const int8_t*>(&wreg[i]);
      float lo[16];
      if constexpr (kInt4) {
        float hi[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int u = static_cast<uint8_t>(b[e]);
          lo[e] = static_cast<float>((u & 0xF) - 8);
          hi[e] = static_cast<float>((u >> 4) - 8);
        }
        store16<T>(sW + (kQmmHalf + r) * Tile::kWRow + col, hi);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) lo[e] = static_cast<float>(b[e]);
      }
      store16<T>(sW + r * Tile::kWRow + col, lo);
    }
    __syncthreads();
    if (j + 1 < n_tiles) load_w(j + 1);  // in flight during this tile's products

    if constexpr (kInt4) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float part[kMT][kNT][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kQmmHalf / 16; ++kk)
          mma_k16<T, Tile>(part, sX, sW, h * (kQmmHalf / 16) + kk, wm, wn, lane);
        const float* srow = p.s + static_cast<int64_t>((h ? khi : klo) / kGroup4) * p.n_pad + n0 + wn;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const float2 sc = *reinterpret_cast<const float2*>(srow + nt * 8 + 2 * (lane & 3));
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            acc[mt][nt][0] += part[mt][nt][0] * sc.x;
            acc[mt][nt][1] += part[mt][nt][1] * sc.y;
            acc[mt][nt][2] += part[mt][nt][2] * sc.x;
            acc[mt][nt][3] += part[mt][nt][3] * sc.y;
          }
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kQmmBK / 16; ++kk) mma_k16<T, Tile>(acc, sX, sW, kk, wm, wn, lane);
    }
  }

  T* y = static_cast<T*>(p.y);
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int col = n0 + wn + nt * 8 + 2 * t4;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + wm + mt * 16 + g + (i < 2 ? 0 : 8);
        const int c = col + (i & 1);
        if (row < p.t && c < p.n) {
          float v = acc[mt][nt][i];
          if constexpr (!kInt4) v *= p.s[c];
          y[static_cast<int64_t>(row) * p.n + c] = Elem<T>::from_float(v);
        }
      }
    }
  }
}

template <typename T, int BM, int BN, bool kInt4>
int launch_qmm(const QmmParams& p, cudaStream_t stream) {
  constexpr int kSmem = QmmTile<BM, BN>::template smem_bytes<T>();
  static bool configured = false;  // above 48 KB needs an explicit opt-in
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(qmm_kernel<T, BM, BN, kInt4>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((p.n + BN - 1) / BN, (p.t + BM - 1) / BM);
  qmm_kernel<T, BM, BN, kInt4><<<grid, kQmmThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool kInt4>
int dispatch_qmm_rows(const QmmParams& p, cudaStream_t stream) {
  if (p.t <= 16) return launch_qmm<T, 16, 64, kInt4>(p, stream);
  return launch_qmm<T, 64, 128, kInt4>(p, stream);
}

template <bool kInt4>
int dispatch_qmm(const void* x, const void* w, const void* s, void* y, int t, int k, int n,
                 int k_pad, int n_pad, long long x_st, int x_vec, int dtype, void* stream) {
  QmmParams p{};
  p.x = x;
  p.w = static_cast<const int8_t*>(w);
  p.s = static_cast<const float*>(s);
  p.y = y;
  p.t = t, p.k = k, p.n = n, p.k_pad = k_pad, p.n_pad = n_pad;
  p.x_st = x_st;
  p.x_vec = x_vec;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return dispatch_qmm_rows<__nv_bfloat16, kInt4>(p, st);
  if (dtype == kF16) return dispatch_qmm_rows<__half, kInt4>(p, st);
  return cudaErrorInvalidValue;
}

}  // namespace fact

// Each returns a cudaError_t code (0 on success). Shapes, dtypes and
// contiguity are checked by the Python wrapper (ops/quantized_matmul.py):
// K_pad a multiple of 128 (int8) or 256 (int4), N_pad of 128, k <= K_pad.
// `dtype` is x's (and y's) code (common.cuh).
extern "C" int fact_qmm_int8(const void* x, const void* w, const void* s, void* y, int t, int k,
                             int n, int k_pad, int n_pad, long long x_st, int x_vec, int dtype,
                             void* stream) {
  return fact::dispatch_qmm<false>(x, w, s, y, t, k, n, k_pad, n_pad, x_st, x_vec, dtype, stream);
}

extern "C" int fact_qmm_int4(const void* x, const void* w, const void* s, void* y, int t, int k,
                             int n, int k_pad, int n_pad, long long x_st, int x_vec, int dtype,
                             void* stream) {
  return fact::dispatch_qmm<true>(x, w, s, y, t, k, n, k_pad, n_pad, x_st, x_vec, dtype, stream);
}
