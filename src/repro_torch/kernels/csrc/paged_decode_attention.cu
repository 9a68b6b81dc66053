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
// Design: the split-key loop of decode_attention.cuh.  A granule is one
// page: page j of sequence b (table entry tables[b, j]) goes to rank j % 8
// of the cluster for (b, kv head h), and key t lies at page tables[b, t /
// PS], slot t % PS.  Where the Pallas kernel had the table brought ahead
// by scalar prefetch, each block reads the page ids of its own pages once,
// into shared memory, before its first copy.  The loop stops at the
// sequence's length: table entries past its last page (page 0 by
// convention) and stale slots are never read.

#include "decode_attention.cuh"

namespace {

struct PagedRows {
  const int* table;   // this sequence's (MP,) page ids
  size_t head;        // offset of head h within a page's slot: h * hd
  size_t page;        // elements of one page: PS * Hkv * hd
  int stride;         // Hkv * hd
  __device__ void load_ids(int rank, int n_mine, int* ids) const {
    for (int i = threadIdx.x; i < n_mine; i += blockDim.x)
      ids[i] = table[rank + decode_attn::kRanks * i];
  }
  __device__ size_t granule(int, int i_mine, const int* ids) const {
    return (size_t)ids[i_mine] * page + head;
  }
};

template <int GM, int HDM>
__global__ void __cluster_dims__(decode_attn::kRanks, 1, 1)
__launch_bounds__(decode_attn::kThreads, decode_attn::min_blocks(GM, HDM))
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,      // (B, H, hd)
                    const __nv_bfloat16* __restrict__ kp,     // (NP, PS, Hkv, hd)
                    const __nv_bfloat16* __restrict__ vp,
                    const int* __restrict__ tables,           // (B, MP)
                    const int* __restrict__ lengths,          // (B,)
                    __nv_bfloat16* __restrict__ out,          // (B, H, hd)
                    int hkv, int mp, decode_attn::Geometry geo, float scale) {
  const int h = blockIdx.y / geo.n_gb;
  const int g0 = (blockIdx.y - h * geo.n_gb) * GM;
  const int b = blockIdx.z;
  const int hd = geo.hd, ps = geo.gran;
  const size_t q0 = ((size_t)b * hkv * geo.group + (size_t)h * geo.group + g0) *
                    hd;
  const PagedRows kv{tables + (size_t)b * mp, (size_t)h * hd,
                     (size_t)ps * hkv * hd, hkv * hd};
  const int len = max(0, min(lengths[b], mp * ps));
  decode_attn::split_decode<GM, HDM>(q + q0, kp, vp, kv, len,
                                     min(GM, geo.group - g0), out + q0, geo,
                                     scale);
}

template <int GM, int HDM>
cudaError_t launch(const decode_attn::Geometry& geo, const void* q,
                   const void* k_pages, const void* v_pages,
                   const void* tables, const void* lengths, void* out,
                   int batch, int hkv, int mp, float scale, void* stream) {
  const size_t smem = decode_attn::smem_bytes(geo);
  cudaError_t e = decode_attn::allow_smem(paged_decode_kernel<GM, HDM>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(decode_attn::kRanks, hkv * geo.n_gb, batch);
  paged_decode_kernel<GM, HDM><<<grid, decode_attn::kThreads, smem,
                                 (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pages,
      (const __nv_bfloat16*)v_pages, (const int*)tables, (const int*)lengths,
      (__nv_bfloat16*)out, hkv, mp, geo, scale);
  return cudaGetLastError();
}

}  // namespace

// hd must be a multiple of 8 and every pointer 16-byte aligned (the
// Python wrapper checks both); group * hd <= 1024.
extern "C" int paged_decode_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* lengths, void* out,
    int batch, int hkv, int group, int hd, int ps, int mp, float scale,
    void* stream) {
  int gm, hdm;
  if (!decode_attn::shape_ok(group, hd)) return (int)cudaErrorInvalidValue;
  decode_attn::pick(group, hd, &gm, &hdm);
  const decode_attn::Geometry geo =
      decode_attn::make_geometry(group, hd, gm, ps, mp, true);
#define DECODE_ATTN_LAUNCH(G_, H_)                                       \
  if (gm == G_ && hdm == H_)                                             \
    return (int)launch<G_, H_>(geo, q, k_pages, v_pages, tables, lengths, \
                               out, batch, hkv, mp, scale, stream);
  DECODE_ATTN_SHAPES(DECODE_ATTN_LAUNCH)
#undef DECODE_ATTN_LAUNCH
  return (int)cudaErrorInvalidValue;
}
