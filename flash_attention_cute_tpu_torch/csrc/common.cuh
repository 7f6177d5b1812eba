// Helpers shared by the attention kernels: element types, the bf16/f16
// tensor-core product m16n8k16 (mma.sync), the rounding of the int8 / e4m3
// values of a quantized cache, and a warp reduction.
//
// The kernels are built by nvcc into shared libraries with a plain C
// interface (ops/_build.py) and called through ctypes: pointers and the
// stream come in as void*, every launch function returns cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace fact {

// Element type codes passed from Python (ops/_build.py DTYPE_CODES): q,
// the output and a dense cache.
enum DType : int { kBF16 = 0, kF16 = 1 };
// Value codes of a quantized cache (ops/_build.py KV_DTYPE_CODES).
enum KVType : int { kInt8 = 0, kE4M3 = 1 };

using e4m3 = __nv_fp8_e4m3;

template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_float(float x) {
    return __float2bfloat16(x);
  }
  // Two floats -> one 32-bit register; `lo` lands in the low half, which
  // holds the element of smaller column index in mma fragments.
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  // D += A * B for one 16x8x16 tile, f32 accumulators.
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <>
struct Elem<__half> {
  static __device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
  static __device__ __forceinline__ __half from_float(float x) { return __float2half(x); }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// Largest magnitude a quantized value takes (ops/quantized.py INT8_MAX,
// FP8_E4M3_MAX), and the rounding of x / scale to it: half to even, as
// the plain version's torch.round and .to(float8_e4m3fn) round.
template <typename KV>
__host__ __device__ constexpr float kv_qmax() { return std::is_same_v<KV, int8_t> ? 127.f : 448.f; }
__device__ __forceinline__ void kv_round(float x, int8_t* out) {
  *out = static_cast<int8_t>(__float2int_rn(x));
}
__device__ __forceinline__ void kv_round(float x, e4m3* out) { *out = e4m3(x); }

// The head dim of the layout that every attention kernel (P / B2 and
// P-i8 / B2-i8, K8, D1, B4, B5, B6, B12, B13a / B13b and, over rows of
// one-byte elements, B7, B8, B9 and QA) runs a true head dim d in: the
// least of 64, 128 and 256 at or above d, whose TMA boxes read d's columns
// and zeros past them (ops/_build.py padded_head_dim); with `wide` (P / B2,
// B4 with its partials, B6, B9 and B12, whose wgmma body has a wide layout:
// attention_wgmma.cuh; the decodes D1, B5, B7 and B8, whose body has one:
// paged_decode.cuh; B13a / B13b: flash_bwd.cu; D2, the paged append and
// QA, which take any row) 512
// for a d from 257 to 512. 0 for a d outside 1..256 (1..512 with `wide`).
// Rows at row_pitch(d, elem) meet TMA's stride rule at every d.
inline int padded_head_dim(int d, bool wide = false) {
  if (wide && d > 256 && d <= 512) return 512;
  if (d < 1 || d > 256) return 0;
  return d <= 64 ? 64 : d <= 128 ? 128 : 256;
}

// Elements from one row of head dim d to the next in a buffer read by TMA:
// d rounded up to a whole 16 bytes of `elem`-byte elements
// (ops/_build.py row_pitch). The kernels that store rows in pairs of
// columns write their outputs at row_pitch(d, 2).
__host__ __device__ constexpr int row_pitch(int d, int elem = 2) {
  return (d + 16 / elem - 1) / (16 / elem) * (16 / elem);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

}  // namespace fact

// Each source builds into its own library, so each holds one copy of this.
extern "C" const char* fact_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
