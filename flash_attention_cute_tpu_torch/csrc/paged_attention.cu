// Attention over a paged KV cache, and the append that fills it:
//
//   * B5, paged decode: replaces the TPU kernel
//     flash_attention_cute_tpu/ops/paged_attention.py `_paged_decode_kernel`
//     (:85, pallas_call at :341). Split-KV decode partials of a GQA group
//     of any size (above 32 in chunks of at most 32 rows, a block each:
//     paged_decode.cuh) through the page table; the splits are
//     merged by D2 (flash_decode.cu), whose partials layout [B, Hkv, S, G,
//     D] is the same. With a sliding window W the splits cut the visible
//     range [max(0, length - W), length). B5 and B6 take the tanh soft cap
//     (`softcap_log2`, c * log2(e), 0 for none) and every head dim from 1
//     to 512, each run in the layout of 64, 128, 256 or 512
//     (padded_head_dim(d, true); zeros past d; the wide layouts of
//     paged_decode.cuh and paged_extend.cuh); the append takes rows of any byte count, each at a
//     16-byte stride, and writes no byte past it (a pool's pitch columns
//     stay zero).
//   * B6, paged extend: replaces `_paged_extend_kernel` (:391, pallas_call at
//     :742). Chunked prefill: the chunk's S query rows sit at global
//     positions q_offset[b] + r and attend keys `col <= q_offset + r`,
//     `col < kv_length[b]` and, with a window, `col > q_offset + r - W`;
//     kv_length 0 marks an inactive row (exact zeros).
//   * paged append: replaces the XLA scatter / per-row dynamic_update_slice
//     of flash_attention_cute_tpu/runtime/paged_cache.py `paged_append_layer`
//     (:130). Writes S new K/V rows per batch row at positions lengths[b] + s
//     through the page table; rows of inactive batch rows and positions past
//     the table write nothing (the `mode="drop"` of the JAX scatter).
//
// What bounds them on the H100, and the design: B5 reads each visible K/V
// row once per GQA group and is bound by memory bytes: a TMA ring of pages
// feeding tensor-core consumers (paged_decode.cuh, shared with B8); B6 is
// bound by tensor-core operations at chunk lengths and is built for wgmma,
// fed by TMA copies of single pages (paged_extend.cuh, shared with B9). The
// TPU kernels walk `ppcb` pages per grid step with double-buffered DMAs and
// scalar-prefetched tables, and size their grid from max(lengths) on the
// device. Here every block reads its own length, offset and page-table
// entries from device memory; the grid is sized from shapes alone, so no
// host sync sizes it. B5 cuts each row's own visible tiles into the splits,
// so every split of a long row has work whatever the pool's capacity. Not
// copied from the TPU extend kernel: the chunk split for the VMEM budget
// (`_extend_chunk_split`), the anchored lazy max with its 75-nat clamp, and
// the `inner` sub-blocks; the softmax here is exact. The append is bound by
// bytes (each new row read and written once): one block per (token, batch
// row), 16 bytes a thread.
#include "paged_decode.cuh"

namespace fact {

struct AppendParams {
  const unsigned char* k_new;  // [B, Hkv, S, D] (any strides, head dim contiguous)
  const unsigned char* v_new;
  unsigned char* k_pages;      // one layer's pool [Hkv, P, ps, D]
  unsigned char* v_pages;
  const int* lengths;          // [B] int32: positions before the append
  const int* page_table;       // [B, pps] int32
  const int* active;           // [B] int32 or null: 0 drops the row
  int64_t kn_sb, kn_sh, kn_ss, vn_sb, vn_sh, vn_ss;  // byte strides
  int64_t kp_sh, kp_sp, kp_ss, vp_sh, vp_sp, vp_ss;
  int hkv, pps, page_size, row_chunks;  // row_chunks: 16-byte chunks per head row
  int row_bytes;                        // the row's bytes: the last chunk may hold fewer
};

// The first `live` bytes of a 16-byte chunk, zeros past them.
__device__ __forceinline__ uint4 keep_bytes(uint4 v, int live) {
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int n = min(max(live - 4 * e, 0), 4);  // bytes of word e to keep
    w[e] &= n == 4 ? 0xFFFFFFFFu : (1u << (8 * n)) - 1u;
  }
  return v;
}

__global__ void paged_append_kernel(const AppendParams p) {
  const int s = blockIdx.x, b = blockIdx.y;
  if (p.active != nullptr && p.active[b] == 0) return;
  const int pos = p.lengths[b] + s;
  const int slot = pos / p.page_size;
  if (pos < 0 || slot >= p.pps) return;  // past the table: dropped
  const int64_t page = p.page_table[static_cast<int64_t>(b) * p.pps + slot];
  const int64_t off = pos % p.page_size;
  for (int c = threadIdx.x; c < p.hkv * p.row_chunks; c += blockDim.x) {
    const int h = c / p.row_chunks;
    const int64_t col = (c % p.row_chunks) * 16;
    uint4 kv = *reinterpret_cast<const uint4*>(
        p.k_new + b * p.kn_sb + h * p.kn_sh + s * p.kn_ss + col);
    uint4 vv = *reinterpret_cast<const uint4*>(
        p.v_new + b * p.vn_sb + h * p.vn_sh + s * p.vn_ss + col);
    if (col + 16 > p.row_bytes) {  // the row's last chunk: the pitch stays zero
      kv = keep_bytes(kv, p.row_bytes - static_cast<int>(col));
      vv = keep_bytes(vv, p.row_bytes - static_cast<int>(col));
    }
    *reinterpret_cast<uint4*>(p.k_pages + h * p.kp_sh + page * p.kp_sp + off * p.kp_ss + col) = kv;
    *reinterpret_cast<uint4*>(p.v_pages + h * p.vp_sh + page * p.vp_sp + off * p.vp_ss + col) = vv;
  }
}

}  // namespace fact

// Each returns a cudaError_t code (0 on success). Shapes, strides and dtypes
// are checked by the Python wrapper (ops/paged_attention.py,
// runtime/paged_cache.py). Both attention kernels take every GQA group: a
// B6 block runs one q head (paged_extend.cuh); B5's `chunks` and `rows` are
// the group's chunk plan (dispatch.decode_group_chunks).
extern "C" int fact_paged_decode_partials(
    const void* q, const void* k, const void* v, const void* lengths, const void* page_table,
    void* acc, void* m, void* l, int batch, int hkv, int group, int chunks, int rows, int d,
    int num_splits, int pps, int page_size, int num_pages, int box_rows, long long q_sb,
    long long q_sh, long long k_sh, long long k_sp, long long k_ss,
    long long v_sh, long long v_sp, long long v_ss,
    float scale_log2, float softcap_log2, int window, int dtype, void* stream) {
  using namespace fact;
  PagedDecodeParams p{};
  p.q = q;
  p.lengths = static_cast<const int*>(lengths);
  p.page_table = static_cast<const int*>(page_table);
  p.acc = static_cast<float*>(acc);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.q_sb = q_sb, p.q_sh = q_sh;
  p.hkv = hkv, p.group = group, p.chunks = chunks, p.rows = rows;
  p.num_splits = num_splits;
  p.pps = pps, p.page_size = page_size, p.box_rows = box_rows, p.d = d;
  p.sc = scores(scale_log2, softcap_log2);
  p.window = window;
  const PagedViews w{q, k, v, q_sb, q_sh, 0, k_sh, k_sp, k_ss, v_sh, v_sp, v_ss,
                     hkv, num_pages, dtype};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return dispatch_paged_decode<__nv_bfloat16, __nv_bfloat16>(p, w, batch, d, s);
  if (dtype == kF16) return dispatch_paged_decode<__half, __half>(p, w, batch, d, s);
  return cudaErrorInvalidValue;
}

extern "C" int fact_paged_extend(
    const void* q, const void* k, const void* v, void* o, const void* q_offset,
    const void* kv_length, const void* page_table, int batch, int hq, int hkv, int sq, int d,
    int pps, int page_size, int num_pages, int box_rows, long long q_sb, long long q_sh,
    long long q_ss, long long k_sh, long long k_sp, long long k_ss,
    long long v_sh, long long v_sp, long long v_ss,
    float scale_log2, float softcap_log2, int window, int dtype, void* stream) {
  using namespace fact;
  PagedParams p{};
  p.o = o;
  p.q_offset = static_cast<const int*>(q_offset);
  p.kv_length = static_cast<const int*>(kv_length);
  p.page_table = static_cast<const int*>(page_table);
  p.batch = batch, p.hq = hq, p.group = hq / hkv, p.sq = sq;
  p.pps = pps, p.page_size = page_size, p.box_rows = box_rows, p.d = d;
  p.sc = scores(scale_log2, softcap_log2);
  p.window = window;
  const PagedViews w{q, k, v, q_sb, q_sh, q_ss, k_sh, k_sp, k_ss, v_sh, v_sp, v_ss,
                     hkv, num_pages, dtype};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return dispatch_paged_extend<__nv_bfloat16, __nv_bfloat16>(p, w, d, s);
  if (dtype == kF16) return dispatch_paged_extend<__half, __half>(p, w, d, s);
  return cudaErrorInvalidValue;
}

// Writes the report of every B6 instantiation (the launch's registers: the
// consumers raise theirs to 240 by setmaxnreg; local (spill) bytes; shared
// memory) into `out` (at most `cap` bytes, NUL-terminated); returns 0.
extern "C" int fact_paged_extend_report(char* out, int cap) {
  int used = 0;
  if (cap <= 0) return 0;
  out[0] = 0;
  fact::report_paged_extend<__nv_bfloat16, __nv_bfloat16>(out, cap, used, "B6 bf16");
  fact::report_paged_extend<__half, __half>(out, cap, used, "B6 f16");
  out[cap - 1] = 0;
  return 0;
}

// The same report of every B5 instantiation.
extern "C" int fact_paged_decode_report(char* out, int cap) {
  int used = 0;
  if (cap <= 0) return 0;
  out[0] = 0;
  fact::report_paged_decode<__nv_bfloat16, __nv_bfloat16>(out, cap, used, "B5 bf16");
  fact::report_paged_decode<__half, __half>(out, cap, used, "B5 f16");
  out[cap - 1] = 0;
  return 0;
}

extern "C" int fact_paged_append(
    const void* k_new, const void* v_new, void* k_pages, void* v_pages, const void* lengths,
    const void* page_table, const void* active, int batch, int s, int hkv, int row_bytes,
    int pps, int page_size,
    long long kn_sb, long long kn_sh, long long kn_ss,
    long long vn_sb, long long vn_sh, long long vn_ss,
    long long kp_sh, long long kp_sp, long long kp_ss,
    long long vp_sh, long long vp_sp, long long vp_ss, void* stream) {
  using namespace fact;
  if (row_bytes < 1) return cudaErrorInvalidValue;
  AppendParams p{};
  p.k_new = static_cast<const unsigned char*>(k_new);
  p.v_new = static_cast<const unsigned char*>(v_new);
  p.k_pages = static_cast<unsigned char*>(k_pages);
  p.v_pages = static_cast<unsigned char*>(v_pages);
  p.lengths = static_cast<const int*>(lengths);
  p.page_table = static_cast<const int*>(page_table);
  p.active = static_cast<const int*>(active);
  p.kn_sb = kn_sb, p.kn_sh = kn_sh, p.kn_ss = kn_ss;
  p.vn_sb = vn_sb, p.vn_sh = vn_sh, p.vn_ss = vn_ss;
  p.kp_sh = kp_sh, p.kp_sp = kp_sp, p.kp_ss = kp_ss;
  p.vp_sh = vp_sh, p.vp_sp = vp_sp, p.vp_ss = vp_ss;
  p.hkv = hkv, p.pps = pps, p.page_size = page_size, p.row_chunks = (row_bytes + 15) / 16;
  p.row_bytes = row_bytes;
  const dim3 grid(s, batch);
  paged_append_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}
