// Hopper (sm_90a) building blocks shared by the kernels that use TMA and
// wgmma (quantized_matmul.cu: B10 / B11 prefill; flash_fwd.cu: P / B2;
// paged_extend.cuh: B6 / B9; flash_chunked.cu: B4; flash_varlen.cu: B12;
// flash_bwd.cu: B13a / B13b): mbarriers, TMA tensor copies and their maps,
// bulk copies, wgmma descriptors and products, ldmatrix, and the register
// hand-over between warpgroups (setmaxnreg).
#pragma once

#include <cuda.h>

#include <cstdio>

#include "common.cuh"

namespace fact {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers.

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// Makes the barriers' initialisation visible to the asynchronous proxy
// (TMA) and the other threads; one thread, after its mbar_init calls.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Orders this thread's writes to shared memory before later reads of it by
// the asynchronous proxy (wgmma, TMA); before the arrive that hands them on.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// TMA: tensor copies through a map, and plain bulk copies, each completing
// on an mbarrier's transaction count.

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// `bytes` (a multiple of 16) from 16-byte aligned global memory.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------------------------
// Registers handed between warpgroups: every warp of a warpgroup executes
// the same one, before the warpgroups' paths split for good.

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// ---------------------------------------------------------------------------
// wgmma.

// Shared-memory descriptor, 128-byte swizzle; offsets in bytes. K-major
// operands (rows of 128 bytes along K): `sbo` is the stride of 8-row
// groups, `lbo` unused. MN-major operands (rows of 128 bytes along M or N,
// one row per K index): `sbo` is the stride of 8-K-row groups, `lbo` that of
// 64-element column blocks.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma boundaries.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define FACT_D8(c, i)                                                                          \
  c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]), c(d[i + 5]), c(d[i + 6]), c(d[i + 7])
#define FACT_RW(x) "+f"(x)
#define FACT_WO(x) "=f"(x)

// d[64 x N] (+)= A[64 x 16] @ B[16 x N], both from shared memory, K-major,
// N 16, 32, 64 or 128. Without kAcc, d = A B: the old values of d are
// neither read nor kept.
#define FACT_WGMMA_SS_16(TYPE, C)                                            \
  asm volatile(                                                              \
      "{\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"                         \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." TYPE "." TYPE            \
      " {%0,%1,%2,%3,%4,%5,%6,%7}, %8, %9, p, 1, 1, 0, 0;\n}\n"               \
      : FACT_D8(C, 0)                                                        \
      : "l"(da), "l"(db), "r"(kAcc ? 1 : 0))

#define FACT_WGMMA_SS_32(TYPE, C)                                                             \
  asm volatile(                                                                               \
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"                                          \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TYPE "." TYPE                             \
      " {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, %16, %17, p, 1, 1, 0, 0;\n}\n" \
      : FACT_D8(C, 0), FACT_D8(C, 8)                                                          \
      : "l"(da), "l"(db), "r"(kAcc ? 1 : 0))

#define FACT_WGMMA_SS_64(TYPE, C)                                                    \
  asm volatile(                                                                      \
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"                                 \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TYPE "." TYPE                    \
      " {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20," \
      "%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, %32, %33, p, 1, 1, 0, 0;\n}\n"  \
      : FACT_D8(C, 0), FACT_D8(C, 8), FACT_D8(C, 16), FACT_D8(C, 24)                 \
      : "l"(da), "l"(db), "r"(kAcc ? 1 : 0))

#define FACT_WGMMA_SS_128(TYPE, C)                                                                \
  asm volatile(                                                                                   \
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"                                              \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TYPE "." TYPE                                \
      " {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23," \
      "%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45," \
      "%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63},"                \
      " %64, %65, p, 1, 1, 0, 0;\n}\n"                                                           \
      : FACT_D8(C, 0), FACT_D8(C, 8), FACT_D8(C, 16), FACT_D8(C, 24), FACT_D8(C, 32),           \
        FACT_D8(C, 40), FACT_D8(C, 48), FACT_D8(C, 56)                                          \
      : "l"(da), "l"(db), "r"(kAcc ? 1 : 0))

template <typename T, int N, bool kAcc>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128, "wgmma_ss takes N 16, 32, 64 or 128");
  constexpr bool kBF16 = std::is_same_v<T, __nv_bfloat16>;
  if constexpr (N == 16) {
    if constexpr (kBF16 && kAcc) FACT_WGMMA_SS_16("bf16", FACT_RW);
    else if constexpr (kBF16) FACT_WGMMA_SS_16("bf16", FACT_WO);
    else if constexpr (kAcc) FACT_WGMMA_SS_16("f16", FACT_RW);
    else FACT_WGMMA_SS_16("f16", FACT_WO);
  } else if constexpr (N == 32) {
    if constexpr (kBF16 && kAcc) FACT_WGMMA_SS_32("bf16", FACT_RW);
    else if constexpr (kBF16) FACT_WGMMA_SS_32("bf16", FACT_WO);
    else if constexpr (kAcc) FACT_WGMMA_SS_32("f16", FACT_RW);
    else FACT_WGMMA_SS_32("f16", FACT_WO);
  } else if constexpr (N == 64) {
    if constexpr (kBF16 && kAcc) FACT_WGMMA_SS_64("bf16", FACT_RW);
    else if constexpr (kBF16) FACT_WGMMA_SS_64("bf16", FACT_WO);
    else if constexpr (kAcc) FACT_WGMMA_SS_64("f16", FACT_RW);
    else FACT_WGMMA_SS_64("f16", FACT_WO);
  } else {
    if constexpr (kBF16 && kAcc) FACT_WGMMA_SS_128("bf16", FACT_RW);
    else if constexpr (kBF16) FACT_WGMMA_SS_128("bf16", FACT_WO);
    else if constexpr (kAcc) FACT_WGMMA_SS_128("f16", FACT_RW);
    else FACT_WGMMA_SS_128("f16", FACT_WO);
  }
}

// d[64 x N] (+)= A[64 x 16] (registers, the m16n8k16 A fragment of each
// warp's 16 rows) @ B[16 x N] (shared memory; K-major, or MN-major with
// kTransB).
#define FACT_WGMMA_RS_64(TYPE, TRANS)                                                        \
  asm volatile(                                                                              \
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"                                         \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TYPE "." TYPE                            \
      " {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,"         \
      "%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, {%32,%33,%34,%35}, %36, p, 1, 1, " TRANS \
      ";\n}\n"                                                                               \
      : FACT_D8(FACT_RW, 0), FACT_D8(FACT_RW, 8), FACT_D8(FACT_RW, 16), FACT_D8(FACT_RW, 24)     \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))
#define FACT_WGMMA_RS_128(TYPE, TRANS)                                                           \
  asm volatile(                                                                                  \
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"                                             \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TYPE "." TYPE                               \
      " {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23," \
      "%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45," \
      "%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63},"                \
      " {%64,%65,%66,%67}, %68, p, 1, 1, " TRANS ";\n}\n"                                        \
      : FACT_D8(FACT_RW, 0), FACT_D8(FACT_RW, 8), FACT_D8(FACT_RW, 16), FACT_D8(FACT_RW, 24),     \
        FACT_D8(FACT_RW, 32), FACT_D8(FACT_RW, 40), FACT_D8(FACT_RW, 48), FACT_D8(FACT_RW, 56)      \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

template <typename T, int N, bool kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma_rs takes N 64 or 128");
  constexpr bool kBF16 = std::is_same_v<T, __nv_bfloat16>;
  if constexpr (N == 64) {
    if constexpr (kBF16 && kTransB) FACT_WGMMA_RS_64("bf16", "1");
    else if constexpr (kBF16) FACT_WGMMA_RS_64("bf16", "0");
    else if constexpr (kTransB) FACT_WGMMA_RS_64("f16", "1");
    else FACT_WGMMA_RS_64("f16", "0");
  } else {
    if constexpr (kBF16 && kTransB) FACT_WGMMA_RS_128("bf16", "1");
    else if constexpr (kBF16) FACT_WGMMA_RS_128("bf16", "0");
    else if constexpr (kTransB) FACT_WGMMA_RS_128("f16", "1");
    else FACT_WGMMA_RS_128("f16", "0");
  }
}

// d[64 x N] (+)= A[64 x 32] @ B[32 x N] of int8 values, both from shared
// memory, K-major (the only layout 8-bit operands take), N 64 or 128; s32
// accumulators, exact. Without kAcc, d = A B.
#define FACT_RWI(x) "+r"(x)
#define FACT_WOI(x) "=r"(x)
#define FACT_WGMMA_SS_S8_64(C)                                                       \
  asm volatile(                                                                      \
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"                                 \
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8"                             \
      " {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20," \
      "%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, %32, %33, p;\n}\n"              \
      : FACT_D8(C, 0), FACT_D8(C, 8), FACT_D8(C, 16), FACT_D8(C, 24)                 \
      : "l"(da), "l"(db), "r"(kAcc ? 1 : 0))
#define FACT_WGMMA_SS_S8_128(C)                                                                   \
  asm volatile(                                                                                   \
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"                                              \
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8"                                         \
      " {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23," \
      "%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45," \
      "%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63},"                \
      " %64, %65, p;\n}\n"                                                                       \
      : FACT_D8(C, 0), FACT_D8(C, 8), FACT_D8(C, 16), FACT_D8(C, 24), FACT_D8(C, 32),           \
        FACT_D8(C, 40), FACT_D8(C, 48), FACT_D8(C, 56)                                          \
      : "l"(da), "l"(db), "r"(kAcc ? 1 : 0))

template <int N, bool kAcc>
__device__ __forceinline__ void wgmma_ss_s8(uint32_t (&d)[N / 2], uint64_t da, uint64_t db) {
  static_assert(N == 64 || N == 128, "wgmma_ss_s8 takes N 64 or 128");
  if constexpr (N == 64) {
    if constexpr (kAcc) FACT_WGMMA_SS_S8_64(FACT_RWI);
    else FACT_WGMMA_SS_S8_64(FACT_WOI);
  } else {
    if constexpr (kAcc) FACT_WGMMA_SS_S8_128(FACT_RWI);
    else FACT_WGMMA_SS_S8_128(FACT_WOI);
  }
}

#undef FACT_WGMMA_SS_16
#undef FACT_WGMMA_SS_32
#undef FACT_WGMMA_SS_64
#undef FACT_WGMMA_SS_128
#undef FACT_WGMMA_RS_64
#undef FACT_WGMMA_RS_128
#undef FACT_WGMMA_SS_S8_64
#undef FACT_WGMMA_SS_S8_128
#undef FACT_D8
#undef FACT_RW
#undef FACT_WO
#undef FACT_RWI
#undef FACT_WOI

// Descriptors of tiles that TMA wrote with the 128-byte swizzle as boxes of
// 64 columns (128 bytes) x R rows, one box after the other.
// K-major operand (rows along M or N, D contiguous): k-step kk of the
// depth; `box_bytes` is the size of one box (one 64-column block of D).
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk, int box_bytes) {
  return wgmma_desc(tile + (kk >> 2) * box_bytes + (kk & 3) * 32, 16, 1024);
}
// MN-major B operand (N along the contiguous columns, K along the rows):
// k-step kk over the rows; `box_bytes` is the stride of 64-column blocks.
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk, int box_bytes) {
  return wgmma_desc(tile + kk * 2048, box_bytes, 1024);
}
// A K-major tile that TMA wrote with the 64-byte swizzle as one box of
// 64-byte rows (layout type 2; 8-row groups 512 bytes apart): k-step kk of
// 32 bytes.
__device__ __forceinline__ uint64_t kmajor_sw64(uint32_t tile, int kk) {
  const uint32_t addr = tile + kk * 32;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}

// The m16n8k16 A fragments of a 64 x N accumulator (each warp's 16 rows),
// rounded to T: k-step kk holds columns 16 kk .. 16 kk + 15.
template <typename T, int N>
__device__ __forceinline__ void to_a(const float (&d)[N], uint32_t (&a)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = Elem<T>::pack(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// to_a() of d as two parts: hi = d rounded to T, lo = (d - hi) rounded to
// T, so that hi + lo carries d to about 2^-16 of itself (d - hi is exact in
// fp32).
template <typename T, int N>
__device__ __forceinline__ void to_a_split(const float (&d)[N], uint32_t (&hi)[N / 8][4],
                                           uint32_t (&lo)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = d[8 * kk + 2 * r], x1 = d[8 * kk + 2 * r + 1];
      const uint32_t h = Elem<T>::pack(x0, x1);
      float h0, h1;  // the halves of h as floats, exactly
      if constexpr (std::is_same_v<T, __nv_bfloat16>) {
        h0 = __uint_as_float(h << 16), h1 = __uint_as_float(h & 0xFFFF0000u);
      } else {
        h0 = __half2float(__ushort_as_half(static_cast<unsigned short>(h & 0xFFFFu)));
        h1 = __half2float(__ushort_as_half(static_cast<unsigned short>(h >> 16)));
      }
      hi[kk][r] = h;
      lo[kk][r] = Elem<T>::pack(x0 - h0, x1 - h1);
    }
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// ---------------------------------------------------------------------------
// Host side: TMA maps.

// libcuda's cuTensorMapEncodeTiled, fetched through the runtime, so that no
// -lcuda is needed.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A map of a `rank`-dimensional array (dims[0] contiguous; strides in bytes
// of dims 1..rank-1), boxes of box[0..rank) elements with the 128-byte
// swizzle (or `swizzle`); out-of-bounds elements read as zero.
static bool make_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base,
                     const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                     CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return encode(map, type, rank, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 2-D map of a row-major [rows, cols] array, boxes of box_cols x box_rows.
static bool make_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, uint64_t cols,
                     uint64_t rows, uint64_t row_bytes, uint32_t box_cols, uint32_t box_rows) {
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  return make_map(map, type, 2, base, dims, strides, box);
}

// A [B, H, S, d] view (strides in elements, d contiguous) as a 4-D TMA map
// with boxes of 64 columns x `box_rows` rows. A dimension of size 1 gets
// the row's byte count rounded up to 16 as its stride (never stepped; any
// multiple of 16 would do); no dimension of size 0 reaches the map (S is
// taken as at least 1, and a block with nothing to load issues no copy).
static bool head_map(CUtensorMap* map, int dtype, const void* base, int batch, int heads, int s,
                     int d, long long sb, long long sh, long long ss, int box_rows) {
  const long long row = 2LL * row_pitch(d);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(s > 1 ? s : 1),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s > 1 ? 2 * ss : row),
                                 static_cast<cuuint64_t>(heads > 1 ? 2 * sh : row),
                                 static_cast<cuuint64_t>(batch > 1 ? 2 * sb : row)};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_rows), 1, 1};
  return make_map(map, dtype == kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                  4, base, dims, strides, box);
}

// An int8 [B, H, S, d] array, its rows at row_pitch(d, 1) bytes and
// otherwise contiguous, as a 4-D TMA map of d columns with boxes of
// min(D, 128) bytes x `box_rows` rows (D the layout's head dim): the
// 128-byte swizzle, the 64-byte one at D 64 (whose rows are 64 bytes).
static bool int8_head_map(CUtensorMap* map, const void* base, int batch, int heads, int s, int d,
                          int D, int box_rows) {
  const long long row = row_pitch(d, 1), head = static_cast<long long>(s > 1 ? s : 1) * row;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(s > 1 ? s : 1),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(row), static_cast<cuuint64_t>(head),
                                 static_cast<cuuint64_t>(heads * head)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(D < 128 ? D : 128),
                             static_cast<cuuint32_t>(box_rows), 1, 1};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, base, dims, strides, box,
                  D == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
}

template <typename Kernel>
static int allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// One line of a kernel's registers, local (spill) bytes and the dynamic
// shared memory it is launched with, appended to `out`.
template <typename Kernel>
static void report_one(char* out, int cap, int& used, const char* name, Kernel kernel, int smem) {
  cudaFuncAttributes a{};
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (used >= cap) return;
  const int n = err == cudaSuccess
                    ? snprintf(out + used, cap - used,
                               "%s: %d registers, %zu bytes local (spill), %d bytes shared memory\n",
                               name, a.numRegs, a.localSizeBytes, smem + static_cast<int>(a.sharedSizeBytes))
                    : snprintf(out + used, cap - used, "%s: %s\n", name, cudaGetErrorString(err));
  used += n > 0 ? n : 0;
}

}  // namespace fact
