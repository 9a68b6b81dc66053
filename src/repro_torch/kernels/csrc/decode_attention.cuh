// Flash-decode GQA attention: the tile loop shared by the contiguous-cache
// kernel (decode_attention.cu) and the paged kernel
// (paged_decode_attention.cu).  The two differ only in where key row t of a
// sequence lies, which the caller passes as an addresser `KV`:
//   `size_t KV::row(int t) const` -> element offset of key t's (hd,) row
//   for this block's (sequence, kv head) in the K and V arrays.
//
// One block per (sequence b, kv head h).  The TPU kernels carried
// (m, l, acc) across a sequential grid axis over key blocks; here a loop
// inside the block walks the sequence's keys in order, so the split of the
// work never depends on the batch size and a sequence's output does not
// depend on its batch-mates.  The loop stops at `len`: no key past it is
// read.  Each iteration takes a tile of `rows` keys:
//   1. the tile's K and V rows for head h are loaded 16 bytes a thread and
//      staged in shared memory as f32 (row stride hd+1 against bank
//      conflicts);
//   2. one thread per (g, t) pair forms the score q_g . k_t * scale in f32
//      (the Pallas kernels' f32 scores);
//   3. one warp per query row g updates the online-softmax carry (m, l)
//      with shuffle reductions and writes p = exp(s - m) and the rescale
//      factor alpha;
//   4. every thread rescales and accumulates its own (g, d) outputs of
//      acc = alpha * acc + p @ V in registers.
// The output is acc / max(l, 1e-20), rounded to bf16: a sequence of length
// 0 gets zeros, as from the Pallas kernels.  No tensor cores: a (G=3,
// hd=64) tile is far too small for wgmma, and the work is memory bound.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode_attn {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxOutPerThread = 8;   // G * hd <= kThreads * 8 = 1024

// Dynamic shared memory of one block, in bytes.
inline size_t smem_bytes(int group, int hd, int rows) {
  return sizeof(float) * ((size_t)group * hd + 2 * (size_t)rows * (hd + 1) +
                          (size_t)group * rows + 3 * (size_t)group);
}

// Host-side argument checks shared by both entry points.
inline bool shape_ok(int group, int hd) {
  return group * hd <= kThreads * kMaxOutPerThread && hd % 8 == 0;
}

// Let a kernel take more than 48 KB of dynamic shared memory if it needs it.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// q_b: this block's (G, hd) query rows; o_b: its (G, hd) output rows.
template <class KV>
__device__ __forceinline__ void tile_loop(
    const __nv_bfloat16* __restrict__ q_b, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const KV& kv, int len,
    __nv_bfloat16* __restrict__ o_b, int group, int hd, int rows, float scale) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int stride = hd + 1;
  float* q_s = smem;                         // (G, hd)
  float* k_s = q_s + group * hd;             // (rows, hd+1)
  float* v_s = k_s + rows * stride;          // (rows, hd+1)
  float* p_s = v_s + rows * stride;          // (G, rows)
  float* m_s = p_s + group * rows;           // (G,)
  float* l_s = m_s + group;                  // (G,)
  float* a_s = l_s + group;                  // (G,) rescale of this tile

  for (int i = tid; i < group * hd; i += kThreads) q_s[i] = __bfloat162float(q_b[i]);
  if (tid < group) {
    m_s[tid] = -1e30f;
    l_s[tid] = 0.f;
  }
  const int n_out = group * hd;
  float acc[kMaxOutPerThread];
#pragma unroll
  for (int r = 0; r < kMaxOutPerThread; ++r) acc[r] = 0.f;

  const int vec = hd / 8;                    // 16-byte chunks per row
  for (int t0 = 0; t0 < len; t0 += rows) {
    const int valid = min(rows, len - t0);
    __syncthreads();   // previous tile's k_s/v_s/p_s fully consumed
    for (int i = tid; i < valid * vec; i += kThreads) {
      const int t = i / vec, c = i - t * vec;
      const size_t off = kv.row(t0 + t) + c * 8;
      const uint4 kw = *reinterpret_cast<const uint4*>(k + off);
      const uint4 vw = *reinterpret_cast<const uint4*>(v + off);
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
#pragma unroll
  for (int r = 0; r < kMaxOutPerThread; ++r) {
    const int i = tid + r * kThreads;
    if (i < n_out) {
      const int g = i / hd;
      o_b[i] = __float2bfloat16(acc[r] / fmaxf(l_s[g], 1e-20f));
    }
  }
}

}  // namespace decode_attn
