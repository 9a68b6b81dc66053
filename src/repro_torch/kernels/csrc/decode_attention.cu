// Flash-decode GQA attention over a contiguous KV cache, for Hopper
// (sm_90a).
//
// Replaces repro/kernels/decode_attention/decode_attention.py
// `decode_attention_pallas` / `_kernel`: q (B, H, hd) against k/v
// (B, S, Hkv, hd) with per-row lengths, f32 scores scaled by 1/sqrt(hd),
// keys at positions >= lengths[b] masked out, online softmax, output
// acc / max(l, 1e-20) in bf16.  It serves the decode step of the
// contiguous-cache model (`models.transformer.decode_fn`, one launch per
// layer per step), which is how a processing unit runs a task when the
// engine does not batch steps.
//
// Bound: device memory.  The step reads each row's first `len` keys and
// values once (2 * len * Hkv * hd bf16) and does 4 * H * hd flops per key,
// far below the card's 295 flops/byte ridge.  The Pallas kernel streams all
// S = max_len positions through VMEM and masks the tail; this kernel stops
// at each row's length, so it moves len / S of those bytes: at the serving
// shapes (S = max_len, len ~ 40) most of the cache is never touched.
//
// Design: the tile loop of decode_attention.cuh, one block per (row b, kv
// head h), with key t of row b at k[b, t, h, :].  Tiles hold 64 keys.  The
// split of the work never depends on B, so row b's output has the same bits
// whatever its batch-mates are (merged tasks and bucket padding rely on
// that).

#include "decode_attention.cuh"

namespace {

constexpr int kTileRows = 64;

struct ContiguousRows {
  size_t base;        // offset of row b, key 0, head h
  int row_stride;     // Hkv * hd
  __device__ size_t row(int t) const { return base + (size_t)t * row_stride; }
};

__global__ void __launch_bounds__(decode_attn::kThreads)
decode_kernel(const __nv_bfloat16* __restrict__ q,       // (B, H, hd)
              const __nv_bfloat16* __restrict__ k,       // (B, S, Hkv, hd)
              const __nv_bfloat16* __restrict__ v,
              const int* __restrict__ lengths,           // (B,)
              __nv_bfloat16* __restrict__ out,           // (B, H, hd)
              int s, int hkv, int group, int hd, float scale) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const size_t head0 = ((size_t)b * hkv * group + (size_t)h * group) * hd;
  const ContiguousRows kv{((size_t)b * s * hkv + h) * hd, hkv * hd};
  const int len = max(0, min(lengths[b], s));
  decode_attn::tile_loop(q + head0, k, v, kv, len, out + head0, group, hd,
                         kTileRows, scale);
}

}  // namespace

// hd must be a multiple of 8 and every pointer 16-byte aligned (the
// Python wrapper checks both); group * hd <= 1024.
extern "C" int decode_attention_bf16(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, int batch, int s, int hkv, int group, int hd, float scale,
    void* stream) {
  if (!decode_attn::shape_ok(group, hd)) return (int)cudaErrorInvalidValue;
  const size_t smem = decode_attn::smem_bytes(group, hd, kTileRows);
  cudaError_t e = decode_attn::allow_smem(decode_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(batch, hkv);
  decode_kernel<<<grid, decode_attn::kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int*)lengths, (__nv_bfloat16*)out,
      s, hkv, group, hd, scale);
  return (int)cudaGetLastError();
}
