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
// Design: one block per (sequence b, kv head h).  The TPU kernel carried
// (m, l, acc) across a sequential grid axis over pages; here a loop inside
// the block walks the sequence's own pages in order, so the split of the
// work never depends on the batch size B and a sequence's output does not
// depend on its batch-mates.  The loop stops at the sequence's last page,
// and inside that page at `len`: table entries past it (page 0 by
// convention) and stale slots are never read.  Each iteration takes a tile
// of `tile_pages` pages (64 keys at page size 16):
//   1. the tile's K and V rows for head h are loaded 16 bytes a thread and
//      staged in shared memory as f32 (row stride hd+1 against bank
//      conflicts);
//   2. one thread per (g, t) pair forms the score q_g . k_t * scale in f32
//      (the Pallas kernel's f32 scores, decode_attention.py:145);
//   3. one warp per query row g updates the online-softmax carry (m, l)
//      with shuffle reductions and writes p = exp(s - m) and the rescale
//      factor alpha;
//   4. every thread rescales and accumulates its own (g, d) outputs of
//      acc = alpha * acc + p @ V in registers.
// The output is acc / l, rounded to bf16.  No tensor cores: a (G=3, hd=64)
// tile is far too small for wgmma, and the work is memory bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxOutPerThread = 8;   // G * hd <= kThreads * 8 = 1024

__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,      // (B, H, hd)
                    const __nv_bfloat16* __restrict__ kp,     // (NP, PS, Hkv, hd)
                    const __nv_bfloat16* __restrict__ vp,
                    const int* __restrict__ tables,           // (B, MP)
                    const int* __restrict__ lengths,          // (B,)
                    __nv_bfloat16* __restrict__ out,          // (B, H, hd)
                    int hkv, int group, int hd, int ps, int mp,
                    int tile_pages, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int stride = hd + 1;
  const int rows = tile_pages * ps;          // keys per tile
  float* q_s = smem;                         // (G, hd)
  float* k_s = q_s + group * hd;             // (rows, hd+1)
  float* v_s = k_s + rows * stride;          // (rows, hd+1)
  float* p_s = v_s + rows * stride;          // (G, rows)
  float* m_s = p_s + group * rows;           // (G,)
  float* l_s = m_s + group;                  // (G,)
  float* a_s = l_s + group;                  // (G,) rescale of this tile

  const int h_all = hkv * group;
  const __nv_bfloat16* q_b = q + ((size_t)b * h_all + (size_t)h * group) * hd;
  for (int i = tid; i < group * hd; i += kThreads) q_s[i] = __bfloat162float(q_b[i]);
  if (tid < group) {
    m_s[tid] = -1e30f;
    l_s[tid] = 0.f;
  }
  const int n_out = group * hd;
  float acc[kMaxOutPerThread];
#pragma unroll
  for (int r = 0; r < kMaxOutPerThread; ++r) acc[r] = 0.f;

  const int len = lengths[b];
  const int* table = tables + (size_t)b * mp;
  const int vec = hd / 8;                    // 16-byte chunks per row
  for (int t0 = 0; t0 < len; t0 += rows) {
    const int valid = min(rows, len - t0);
    __syncthreads();   // previous tile's k_s/v_s/p_s fully consumed
    for (int i = tid; i < valid * vec; i += kThreads) {
      const int t = i / vec, c = i - t * vec;
      const int page = table[(t0 + t) / ps];
      const size_t off = (((size_t)page * ps + (t0 + t) % ps) * hkv + h) * hd + c * 8;
      const uint4 kw = *reinterpret_cast<const uint4*>(kp + off);
      const uint4 vw = *reinterpret_cast<const uint4*>(vp + off);
      const __nv_bfloat16* kb = reinterpret_cast<const __nv_bfloat16*>(&kw);
      const __nv_bfloat16* vb = reinterpret_cast<const __nv_bfloat16*>(&vw);
      float* kd = k_s + t * stride + c * 8;
      float* vd = v_s + t * stride + c * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        kd[e] = __bfloat162float(kb[e]);
        vd[e] = __bfloat162float(vb[e]);
      }
    }
    __syncthreads();
    for (int i = tid; i < group * valid; i += kThreads) {
      const int g = i / valid, t = i - g * valid;
      const float* qg = q_s + g * hd;
      const float* kt = k_s + t * stride;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qg[d], kt[d], s);
      p_s[g * rows + t] = s * scale;
    }
    __syncthreads();
    for (int g = warp; g < group; g += kWarps) {
      float* pg = p_s + g * rows;
      float mx = -1e30f;
      for (int t = lane; t < valid; t += 32) mx = fmaxf(mx, pg[t]);
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < valid; t += 32) {
        const float p = expf(pg[t] - m_new);
        pg[t] = p;
        sum += p;
      }
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kMaxOutPerThread; ++r) {
      const int i = tid + r * kThreads;
      if (i < n_out) {
        const int g = i / hd, d = i - g * hd;
        const float* pg = p_s + g * rows;
        float a = acc[r] * a_s[g];
        for (int t = 0; t < valid; ++t) a = fmaf(pg[t], v_s[t * stride + d], a);
        acc[r] = a;
      }
    }
  }
  __syncthreads();
  __nv_bfloat16* o_b = out + ((size_t)b * h_all + (size_t)h * group) * hd;
#pragma unroll
  for (int r = 0; r < kMaxOutPerThread; ++r) {
    const int i = tid + r * kThreads;
    if (i < n_out) {
      const int g = i / hd;
      o_b[i] = __float2bfloat16(acc[r] / fmaxf(l_s[g], 1e-20f));
    }
  }
}

}  // namespace

// hd must be a multiple of 8 and every pointer 16-byte aligned (the
// Python wrapper checks both); group * hd <= 1024.
extern "C" int paged_decode_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* lengths, void* out,
    int batch, int hkv, int group, int hd, int ps, int mp, float scale,
    void* stream) {
  if (group * hd > kThreads * kMaxOutPerThread || hd % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int tile_pages = ps >= 64 ? 1 : 64 / ps;
  const int rows = tile_pages * ps;
  const size_t smem = sizeof(float) *
      ((size_t)group * hd + 2 * (size_t)rows * (hd + 1) + (size_t)group * rows + 3 * group);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(batch, hkv);
  paged_decode_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pages,
      (const __nv_bfloat16*)v_pages, (const int*)tables, (const int*)lengths,
      (__nv_bfloat16*)out, hkv, group, hd, ps, mp, tile_pages, scale);
  return (int)cudaGetLastError();
}
