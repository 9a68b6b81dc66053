// Batched PEND_DROP PMF convolution for Hopper (sm_90a), dissertation
// Eqs. 5.2-5.5.
//
// Replaces repro/kernels/pmf_conv/pmf_conv.py `pmf_conv_pallas`.  For each
// of N (task, machine-tail) rows on a fixed compacted grid:
//   ok[t]    = [t < dl]
//   conv[t]  = sum_k pet[k] * pct[t-k] * ok[t-k]            (t < Lo = Lc+Le-1)
//   out[t]   = conv[t] + pct[t] * (1 - ok[t])               (late mass passes)
//   success  = min(1, sum_{t <= dl} conv[t])
//
// Bound: at the scheduler's shapes (N=32, L=64) the inputs are 16 KB and the
// work ~260 kflop, so a launch costs its fixed overhead; at any size the
// Le*Lo multiply-adds per row sit in f32 CUDA cores.  Design: one block per
// row.  The PET row and the deadline-truncated PCT row are staged once in
// shared memory; thread t computes conv[t] directly, summing over k in
// increasing order as the Pallas kernel's fori_loop does; the success sum
// is a block reduction (warp shuffles, then one warp over the warp sums).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
pmf_conv_kernel(const float* __restrict__ pet,   // (N, Le)
                const float* __restrict__ pct,   // (N, Lc)
                const float* __restrict__ dl,    // (N,)
                float* __restrict__ out,         // (N, Lo)
                float* __restrict__ success,     // (N,)
                int le, int lc) {
  extern __shared__ float smem[];
  float* e_s = smem;          // (Le,)
  float* c_s = smem + le;     // (Lc,) pct * [t < dl]
  __shared__ float warp_sums[kThreads / 32];
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int lo = lc + le - 1;
  const float d = dl[n];
  const float* pet_n = pet + (size_t)n * le;
  const float* pct_n = pct + (size_t)n * lc;
  for (int k = tid; k < le; k += kThreads) e_s[k] = pet_n[k];
  for (int t = tid; t < lc; t += kThreads)
    c_s[t] = ((float)t < d) ? pct_n[t] : 0.f;
  __syncthreads();

  float part = 0.f;
  for (int t = tid; t < lo; t += kThreads) {
    const int k0 = max(0, t - lc + 1), k1 = min(t, le - 1);
    float acc = 0.f;
    for (int k = k0; k <= k1; ++k) acc += e_s[k] * c_s[t - k];
    if ((float)t <= d) part += acc;
    const float late = (t < lc && !((float)t < d)) ? pct_n[t] : 0.f;
    out[(size_t)n * lo + t] = acc + late;
  }
  for (int off = 16; off > 0; off >>= 1) part += __shfl_down_sync(0xffffffffu, part, off);
  if ((tid & 31) == 0) warp_sums[tid >> 5] = part;
  __syncthreads();
  if (tid < 32) {
    float s = tid < kThreads / 32 ? warp_sums[tid] : 0.f;
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (tid == 0) success[n] = fminf(s, 1.f);
  }
}

}  // namespace

extern "C" int pmf_conv_f32(const void* pet, const void* pct, const void* dl,
                            void* out, void* success, int n, int le, int lc,
                            void* stream) {
  const size_t smem = sizeof(float) * ((size_t)le + lc);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pmf_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pmf_conv_kernel<<<n, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)pet, (const float*)pct, (const float*)dl, (float*)out,
      (float*)success, le, lc);
  return (int)cudaGetLastError();
}
