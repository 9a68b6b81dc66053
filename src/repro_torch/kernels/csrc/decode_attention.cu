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
// A sliding window (`window` > 0) also masks the keys below
// lengths[b] - window, as the model's jnp `layers.decode_attention` does
// (the Pallas kernel has no window): row b attends to keys t with
// max(0, lengths[b] - window) <= t < min(lengths[b], S).  The first key
// comes from the unclamped length, as the reference's mask does.  A row
// whose range is empty gets zeros (the jnp formula gives NaN there).
//
// Bound: device memory.  The step reads each row's attended keys and
// values once (2 * len * Hkv * hd bf16) and does 4 * H * hd flops per key,
// far below the card's 295 flops/byte ridge.  The Pallas kernel streams all
// S = max_len positions through VMEM and masks the tail; this kernel stops
// at each row's length, so it moves len / S of those bytes.
//
// Design: the split-key loop of decode_attention.cuh.  Row b's keys are
// dealt in 16-key granules to the 8 blocks of the cluster for (b, kv head
// h), with key t of row b at k[b, t, h, :]; granule j starts at key
// first + 16 j, first being the row's first attended key (0 without a
// window).  Moving the row's origin to that key keeps every granule whole
// but the last, so the split loop needs no mask below the window; the
// origin moves by first * Hkv * hd bf16, a multiple of 16 bytes as
// hd % 8 == 0, so the 16-byte copies stay aligned.

#include "decode_attention.cuh"

namespace {

struct ContiguousRows {
  size_t base;        // offset of row b, its first attended key, head h
  int stride;         // Hkv * hd
  __device__ void load_ids(int, int, int*) const {}
  __device__ size_t granule(int j, int, const int*) const {
    return base + (size_t)j * decode_attn::kGranule * stride;
  }
};

template <int GM, int HDM>
__global__ void __cluster_dims__(decode_attn::kRanks, 1, 1)
__launch_bounds__(decode_attn::kThreads, decode_attn::min_blocks(GM, HDM))
decode_kernel(const __nv_bfloat16* __restrict__ q,       // (B, H, hd)
              const __nv_bfloat16* __restrict__ k,       // (B, S, Hkv, hd)
              const __nv_bfloat16* __restrict__ v,
              const int* __restrict__ lengths,           // (B,)
              __nv_bfloat16* __restrict__ out,           // (B, H, hd)
              int s, int hkv, int window, decode_attn::Geometry geo,
              float scale) {
  const int h = blockIdx.y / geo.n_gb;
  const int g0 = (blockIdx.y - h * geo.n_gb) * GM;
  const int b = blockIdx.z;
  const size_t q0 = ((size_t)b * hkv * geo.group + (size_t)h * geo.group + g0) *
                    geo.hd;
  const int end = max(0, min(lengths[b], s));
  const int first = window > 0 ? min(end, max(0, lengths[b] - window)) : 0;
  const ContiguousRows kv{((size_t)b * s + first) * hkv * geo.hd +
                              (size_t)h * geo.hd,
                          hkv * geo.hd};
  decode_attn::split_decode<GM, HDM>(q + q0, k, v, kv, end - first,
                                     min(GM, geo.group - g0), out + q0, geo,
                                     scale);
}

template <int GM, int HDM>
cudaError_t launch(const decode_attn::Geometry& geo, const void* q,
                   const void* k, const void* v, const void* lengths,
                   void* out, int batch, int s, int hkv, int window,
                   float scale, void* stream) {
  const size_t smem = decode_attn::smem_bytes(geo);
  cudaError_t e = decode_attn::allow_smem(decode_kernel<GM, HDM>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(decode_attn::kRanks, hkv * geo.n_gb, batch);
  decode_kernel<GM, HDM><<<grid, decode_attn::kThreads, smem,
                           (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int*)lengths, (__nv_bfloat16*)out,
      s, hkv, window, geo, scale);
  return cudaGetLastError();
}

}  // namespace

// The partition the kernels share, for the Python wrapper to check against
// its own constants: ranks a sequence's keys are dealt to, and keys of a
// contiguous-cache granule (the paged kernel's granule is one page).
extern "C" int decode_attention_geometry(int* ranks, int* granule) {
  *ranks = decode_attn::kRanks;
  *granule = decode_attn::kGranule;
  return 0;
}

// hd must be a multiple of 8 and every pointer 16-byte aligned (the
// Python wrapper checks both); group * hd <= 1024; window >= 0 (0: none).
extern "C" int decode_attention_bf16(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, int batch, int s, int hkv, int group, int hd, int window,
    float scale, void* stream) {
  int gm, hdm;
  if (!decode_attn::shape_ok(group, hd) || window < 0)
    return (int)cudaErrorInvalidValue;
  decode_attn::pick(group, hd, &gm, &hdm);
  const decode_attn::Geometry geo = decode_attn::make_geometry(
      group, hd, gm, decode_attn::kGranule, 0, false);
#define DECODE_ATTN_LAUNCH(G_, H_)                                        \
  if (gm == G_ && hdm == H_)                                              \
    return (int)launch<G_, H_>(geo, q, k, v, lengths, out, batch, s, hkv, \
                               window, scale, stream);
  DECODE_ATTN_SHAPES(DECODE_ATTN_LAUNCH)
#undef DECODE_ATTN_LAUNCH
  return (int)cudaErrorInvalidValue;
}
