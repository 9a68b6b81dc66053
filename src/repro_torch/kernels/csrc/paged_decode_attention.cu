// Paged flash-decode GQA attention for Hopper (sm_90a).
//
// Replaces repro/kernels/decode_attention/decode_attention.py
// `paged_decode_attention_pallas` / `_paged_kernel`.  One new token per
// sequence attends over its KV pages, found through its block table.
//
// Bound: device memory.  A decode step reads each sequence's K/V pages once
// (2 * len * hd bf16 per kv head) and does 4 * G * hd flops per key, far
// below the card's 295 flops/byte ridge.  The design therefore reads each
// page once, for all G query heads that share it, and keeps everything
// else on chip.
//
// Design: the tile loop of decode_attention.cuh, one block per (sequence b,
// kv head h), with key t of sequence b at page tables[b, t / PS], slot
// t % PS.  Tiles hold `tile_pages` pages (64 keys at page size 16).  The
// loop stops at the sequence's length: table entries past its last page
// (page 0 by convention) and stale slots are never read.

#include "decode_attention.cuh"

namespace {

struct PagedRows {
  const int* table;   // this sequence's (MP,) page ids
  int ps, hkv, h, hd;
  __device__ size_t row(int t) const {
    return (((size_t)table[t / ps] * ps + t % ps) * hkv + h) * hd;
  }
};

__global__ void __launch_bounds__(decode_attn::kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,      // (B, H, hd)
                    const __nv_bfloat16* __restrict__ kp,     // (NP, PS, Hkv, hd)
                    const __nv_bfloat16* __restrict__ vp,
                    const int* __restrict__ tables,           // (B, MP)
                    const int* __restrict__ lengths,          // (B,)
                    __nv_bfloat16* __restrict__ out,          // (B, H, hd)
                    int hkv, int group, int hd, int ps, int mp,
                    int rows, float scale) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const size_t head0 = ((size_t)b * hkv * group + (size_t)h * group) * hd;
  const PagedRows kv{tables + (size_t)b * mp, ps, hkv, h, hd};
  const int len = max(0, min(lengths[b], mp * ps));
  decode_attn::tile_loop(q + head0, kp, vp, kv, len, out + head0, group, hd,
                         rows, scale);
}

}  // namespace

// hd must be a multiple of 8 and every pointer 16-byte aligned (the
// Python wrapper checks both); group * hd <= 1024.
extern "C" int paged_decode_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* lengths, void* out,
    int batch, int hkv, int group, int hd, int ps, int mp, float scale,
    void* stream) {
  if (!decode_attn::shape_ok(group, hd)) return (int)cudaErrorInvalidValue;
  const int tile_pages = ps >= 64 ? 1 : 64 / ps;
  const int rows = tile_pages * ps;
  const size_t smem = decode_attn::smem_bytes(group, hd, rows);
  cudaError_t e = decode_attn::allow_smem(paged_decode_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(batch, hkv);
  paged_decode_kernel<<<grid, decode_attn::kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pages,
      (const __nv_bfloat16*)v_pages, (const int*)tables, (const int*)lengths,
      (__nv_bfloat16*)out, hkv, group, hd, ps, mp, rows, scale);
  return (int)cudaGetLastError();
}
