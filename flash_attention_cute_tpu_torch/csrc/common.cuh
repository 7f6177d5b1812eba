// Helpers shared by the attention kernels: element types, the bf16/f16
// tensor-core product m16n8k16 (mma.sync), and warp reductions.
//
// The kernels are built by nvcc into shared libraries with a plain C
// interface (ops/_build.py) and called through ctypes: pointers and the
// stream come in as void*, every launch function returns cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace fact {

// Element type codes passed from Python (ops/_build.py DTYPE_CODES).
enum DType : int { kBF16 = 0, kF16 = 1 };

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

// Eight consecutive elements (one 16-byte load) to floats.
template <typename T>
__device__ __forceinline__ void unpack8(const uint4& raw, float (&out)[8]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = Elem<T>::to_float(e[i]);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace fact

// Each source builds into its own library, so each holds one copy of this.
extern "C" const char* fact_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
