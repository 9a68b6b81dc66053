// Row RMSNorm for Hopper (sm_90a), and the empty kernel that measures the
// floor of a launch through this library.
//
// Replaces repro/kernels/rmsnorm/rmsnorm.py:24 `rmsnorm_pallas`.  For each
// row of D elements:
//   var = mean(x * x)  in f32;   r = rsqrt(var + eps)
//   out = cast_to_x_dtype(x * r) * scale      (rounded to x's dtype)
// the cast order of `layers.rmsnorm` and of the Pallas kernel.
//
// Bound: one read of x, one read of the scale and one write of out.  At the
// served shapes (8 rows of 960 bf16, 65 launches a decode step) that is
// 31 KB, 9.7 ns at 3.35 TB/s, so a launch costs its fixed overhead, on the
// device and on the host; at prefill widths (1,024 rows) it is bytes.
// Design: nothing but the launch itself costs time it need not.  One warp
// owns a row of up to 128 16-byte vectors (D <= 1,024 in bf16, 512 in f32),
// and WARPS warps a wider one.  Each lane reads its VPL vectors of the row
// once, with 16-byte loads, and keeps them in registers with the matching
// vectors of the scale (read through the read-only path, before any
// arithmetic, so a launch waits for one round trip); its f32 sum of
// squares is reduced across the warp by an xor butterfly, which leaves the
// same bits in every lane.  A multi-warp row adds one exchange of the warp
// sums through shared memory and one block barrier; a single-warp row needs
// neither.  Several rows share a block (4 single-warp rows, 2 two-warp rows),
// so 8 rows take 2 blocks and 1,024 rows 256.  WARPS and VPL are template
// parameters, and `geometry` below chooses them from D and the dtype alone,
// never from the row count: every row is reduced in the same order whatever
// its batch-mates, so a row's bits do not depend on them.

//
// The backward (rmsnorm_bwd_*), which no TPU kernel has: the gradient of
// the same function for a trainer that runs its norms on this kernel.  For
// each row, in f32 (r as above, g the output's gradient):
//   dn = g * scale;   dx = r * (dn - x * r^2 * mean(dn * x))    (x's dtype)
//   dscale = sum over rows of g * cast_to_x_dtype(x * r)      (scale's dtype)
// Bound: one read of x and g and the scale, one write of dx and dscale;
// at a training step's 8,192 rows of 960 bf16 that is 47 MB, 14 us at
// 3.35 TB/s.  Design: the forward's geometry (a warp or more a row, the
// row, its gradient and the scale held in registers as 16-byte vectors);
// the row's two sums (x * x and dn * x) share one butterfly and, for a
// multi-warp row, one shared-memory exchange.  dscale is a sum over every
// row, and it is deterministic: at most kBwdMaxBlocks blocks each walk a
// fixed set of rows (group blockIdx.x, then every gridDim.x-th), each lane
// summing its columns' g * cast(x * r) in row order; a block adds its row
// slots in slot order and writes one f32 row of partial sums to a scratch
// (blocks, D) buffer; a second launch adds those rows in block order
// (32 strided chains a column, then the chains in order).  No atomics: two
// calls give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// (type, warps per row, 16-byte vectors per lane): every instantiation,
// the pairs `geometry` reaches for D up to kMaxD
#define RMSNORM_SHAPES(X)                                          \
  X(__nv_bfloat16, 1, 1) X(__nv_bfloat16, 1, 2) X(__nv_bfloat16, 1, 4) \
  X(__nv_bfloat16, 2, 4) X(__nv_bfloat16, 4, 4) X(__nv_bfloat16, 8, 4) \
  X(float, 1, 1) X(float, 1, 2) X(float, 1, 4) X(float, 2, 4)      \
  X(float, 4, 4) X(float, 8, 4) X(float, 16, 4)

namespace {

// the widest row the kernel takes (no model in the repo is wider);
// kernels/rmsnorm/ops.py's MAX_D, which the card tests hold equal
constexpr int kMaxD = 7168;

// elements of T in a 16-byte vector
template <typename T>
__host__ __device__ constexpr int per_vec() { return 16 / sizeof(T); }

struct Geometry {
  int warps, vpl;  // warps a row, 16-byte vectors a lane
};
// The one place the instantiation is chosen, from a row's nvec 16-byte
// vectors alone: up to 32 take one a lane, up to 64 two, up to 128 four; a
// wider row the fewest warps (a power of two) at four a lane.
constexpr Geometry geometry(int nvec) {
  if (nvec <= 64) return {1, nvec <= 32 ? 1 : 2};
  int warps = 1;
  while (128 * warps < nvec) warps *= 2;
  return {warps, 4};
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// round to nearest even, as PyTorch's and XLA's casts do
__device__ __forceinline__ void from_f32(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(v);
}

// rows a block holds: 128 threads for rows of up to 4 warps
__host__ __device__ constexpr int rows_per_block(int warps) {
  return warps >= 4 ? 1 : 4 / warps;
}

template <typename T, int WARPS, int VPL>
__global__ void __launch_bounds__(32 * WARPS * rows_per_block(WARPS))
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               T* __restrict__ out, int rows, int d, float eps) {
  constexpr int E = per_vec<T>();
  constexpr int kRowThreads = 32 * WARPS;
  constexpr int kRows = rows_per_block(WARPS);
  const int slot = threadIdx.x / kRowThreads;
  const int tid = threadIdx.x % kRowThreads;
  const size_t row = (size_t)blockIdx.x * kRows + slot;
  // a multi-warp row's threads all reach the barrier below, so a slot past
  // the last row idles through it instead of returning
  const bool live = row < (size_t)rows;
  const int nvec = d / E;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);

  // the row and the scale are both loaded before any arithmetic, so the
  // launch waits for one round trip to device memory, not two
  const uint4* sv = reinterpret_cast<const uint4*>(scale);
  uint4 v[VPL], s4[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int j = tid + i * kRowThreads;
    const bool in = live && j < nvec;
    v[i] = in ? xr[j] : make_uint4(0, 0, 0, 0);
    s4[i] = in ? __ldg(sv + j) : make_uint4(0, 0, 0, 0);
  }
  // a sum a vector, then the vectors' sums in order: VPL chains at once
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const T* e = reinterpret_cast<const T*>(&v[i]);
    float vs = 0.f;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const float f = to_f32(e[k]);
      vs += f * f;
    }
    ss += vs;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if constexpr (WARPS > 1) {
    __shared__ float warp_ss[kRows][WARPS];
    if ((tid & 31) == 0) warp_ss[slot][tid >> 5] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) ss += warp_ss[slot][w];
  }
  if (!live) return;
  // mean as PyTorch takes it: the sum times the f32 reciprocal of D
  const float r = rsqrtf(ss * (1.f / (float)d) + eps);

  uint4* orow = reinterpret_cast<uint4*>(out + row * d);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int j = tid + i * kRowThreads;
    if (j >= nvec) break;
    const T* e = reinterpret_cast<const T*>(&v[i]);
    const T* s = reinterpret_cast<const T*>(&s4[i]);
    uint4 o4;
    T* o = reinterpret_cast<T*>(&o4);
#pragma unroll
    for (int k = 0; k < E; ++k) {
      T y;
      from_f32(to_f32(e[k]) * r, &y);         // cast to x's dtype first
      from_f32(to_f32(y) * to_f32(s[k]), o + k);
    }
    orow[j] = o4;
  }
}

template <typename T, int WARPS, int VPL>
cudaError_t launch(const void* x, const void* scale, void* out, int rows,
                   int d, float eps, cudaStream_t stream) {
  constexpr int kRows = rows_per_block(WARPS);
  rmsnorm_kernel<T, WARPS, VPL>
      <<<(rows + kRows - 1) / kRows, 32 * WARPS * kRows, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(scale),
          static_cast<T*>(out), rows, d, eps);
  return cudaGetLastError();
}

// The (warps, vpl) instantiation that rows of d elements of T take, or
// none (false) for a d the kernel does not take.
template <typename T>
bool pick(int d, Geometry* g) {
  if (d <= 0 || d % per_vec<T>() || d > kMaxD) return false;
  *g = geometry(d / per_vec<T>());
#define RMSNORM_FOUND(T_, W_, V_)                                      \
  if (std::is_same<T, T_>::value && g->warps == W_ && g->vpl == V_)    \
    return true;
  RMSNORM_SHAPES(RMSNORM_FOUND)
#undef RMSNORM_FOUND
  return false;
}

template <typename T>
int dispatch(const void* x, const void* scale, void* out, int rows, int d,
             float eps, void* stream) {
  Geometry g;
  if (rows <= 0 || !pick<T>(d, &g)) return (int)cudaErrorInvalidValue;
#define RMSNORM_LAUNCH(T_, W_, V_)                                     \
  if constexpr (std::is_same<T, T_>::value) {                          \
    if (g.warps == W_ && g.vpl == V_)                                  \
      return (int)launch<T, W_, V_>(x, scale, out, rows, d, eps,      \
                                    (cudaStream_t)stream);             \
  }
  RMSNORM_SHAPES(RMSNORM_LAUNCH)
#undef RMSNORM_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// the most blocks the backward's first launch takes (4 a streaming
// multiprocessor of an H100): the rows of f32 partial sums of dscale
// that the second launch adds
constexpr int kBwdMaxBlocks = 528;

template <typename T, int WARPS, int VPL>
__global__ void __launch_bounds__(32 * WARPS * rows_per_block(WARPS))
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                   const T* __restrict__ g, T* __restrict__ dx,
                   float* __restrict__ partial, int rows, int d, float eps) {
  constexpr int E = per_vec<T>();
  constexpr int kRowThreads = 32 * WARPS;
  constexpr int kRows = rows_per_block(WARPS);
  const int slot = threadIdx.x / kRowThreads;
  const int tid = threadIdx.x % kRowThreads;
  const int nvec = d / E;
  const uint4* sv = reinterpret_cast<const uint4*>(scale);

  uint4 s4[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int j = tid + i * kRowThreads;
    s4[i] = j < nvec ? __ldg(sv + j) : make_uint4(0, 0, 0, 0);
  }
  // this lane's share of dscale over the rows its slot walks
  float acc[VPL][E];
#pragma unroll
  for (int i = 0; i < VPL; ++i)
#pragma unroll
    for (int k = 0; k < E; ++k) acc[i][k] = 0.f;

  // every slot of the block walks the same number of groups, so the
  // barriers of a multi-warp row are reached by all its threads
  const int groups = (rows + kRows - 1) / kRows;
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const size_t row = (size_t)grp * kRows + slot;
    const bool live = row < (size_t)rows;
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
    const uint4* gr = reinterpret_cast<const uint4*>(g + row * d);
    uint4 v[VPL], g4[VPL];
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int j = tid + i * kRowThreads;
      const bool in = live && j < nvec;
      v[i] = in ? xr[j] : make_uint4(0, 0, 0, 0);
      g4[i] = in ? gr[j] : make_uint4(0, 0, 0, 0);
    }
    // sum x * x and sum dn * x: a sum a vector, then the vectors in order
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const T* e = reinterpret_cast<const T*>(&v[i]);
      const T* ge = reinterpret_cast<const T*>(&g4[i]);
      const T* se = reinterpret_cast<const T*>(&s4[i]);
      float vs = 0.f, vd = 0.f;
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const float f = to_f32(e[k]);
        vs += f * f;
        vd += to_f32(ge[k]) * to_f32(se[k]) * f;
      }
      ss += vs;
      dot += vd;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    }
    if constexpr (WARPS > 1) {
      __shared__ float2 warp_sums[kRows][WARPS];
      if ((tid & 31) == 0) warp_sums[slot][tid >> 5] = make_float2(ss, dot);
      __syncthreads();
      ss = dot = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        ss += warp_sums[slot][w].x;
        dot += warp_sums[slot][w].y;
      }
      __syncthreads();    // read before the next group writes
    }
    if (!live) continue;
    const float inv_d = 1.f / (float)d;
    const float r = rsqrtf(ss * inv_d + eps);
    const float c = r * r * (dot * inv_d);
    uint4* dxr = reinterpret_cast<uint4*>(dx + row * d);
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int j = tid + i * kRowThreads;
      if (j >= nvec) break;
      const T* e = reinterpret_cast<const T*>(&v[i]);
      const T* ge = reinterpret_cast<const T*>(&g4[i]);
      const T* se = reinterpret_cast<const T*>(&s4[i]);
      uint4 o4;
      T* o = reinterpret_cast<T*>(&o4);
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const float f = to_f32(e[k]);
        const float gf = to_f32(ge[k]);
        from_f32(r * (gf * to_f32(se[k]) - f * c), o + k);
        T n;
        from_f32(f * r, &n);                    // the forward's cast
        acc[i][k] += gf * to_f32(n);
      }
      dxr[j] = o4;
    }
  }

  // the block's row slots added in slot order, into one row of partials
  constexpr int kSpan = kRowThreads * VPL * E;
  if constexpr (kRows > 1) {
    __shared__ float slots[kRows - 1][kSpan];
    if (slot > 0) {
#pragma unroll
      for (int i = 0; i < VPL; ++i)
#pragma unroll
        for (int k = 0; k < E; ++k)
          slots[slot - 1][(tid + i * kRowThreads) * E + k] = acc[i][k];
    }
    __syncthreads();
    if (slot == 0) {
      for (int s = 0; s < kRows - 1; ++s)
#pragma unroll
        for (int i = 0; i < VPL; ++i)
#pragma unroll
          for (int k = 0; k < E; ++k)
            acc[i][k] += slots[s][(tid + i * kRowThreads) * E + k];
    }
  }
  if (slot != 0) return;
  float* prow = partial + (size_t)blockIdx.x * d;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int j = tid + i * kRowThreads;
    if (j >= nvec) break;
#pragma unroll
    for (int k = 0; k < E; ++k) prow[j * E + k] = acc[i][k];
  }
}

// dscale[col] = the sum of partial[0..blocks)[col] in a fixed order: 32
// threads a column each add every 32nd row, then one adds their 32 sums
template <typename T>
__global__ void __launch_bounds__(1024)
rmsnorm_dscale_kernel(const float* __restrict__ partial,
                      T* __restrict__ dscale, int blocks, int d) {
  __shared__ float chains[32][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (col < d)
    for (int b = threadIdx.y; b < blocks; b += 32)
      s += partial[(size_t)b * d + col];
  chains[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y != 0 || col >= d) return;
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < 32; ++w) t += chains[w][threadIdx.x];
  from_f32(t, dscale + col);
}

template <typename T, int WARPS, int VPL>
cudaError_t launch_bwd(const void* x, const void* scale, const void* g,
                       void* dx, void* dscale, float* scratch,
                       int scratch_rows, int rows, int d, float eps,
                       cudaStream_t stream) {
  constexpr int kRows = rows_per_block(WARPS);
  const int groups = (rows + kRows - 1) / kRows;
  const int blocks = groups < kBwdMaxBlocks ? groups : kBwdMaxBlocks;
  if (blocks > scratch_rows) return cudaErrorInvalidValue;
  rmsnorm_bwd_kernel<T, WARPS, VPL><<<blocks, 32 * WARPS * kRows, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<const T*>(g), static_cast<T*>(dx), scratch, rows, d, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_dscale_kernel<T><<<(d + 31) / 32, dim3(32, 32), 0, stream>>>(
      scratch, static_cast<T*>(dscale), blocks, d);
  return cudaGetLastError();
}

template <typename T>
int dispatch_bwd(const void* x, const void* scale, const void* g, void* dx,
                 void* dscale, void* scratch, int scratch_rows, int rows,
                 int d, float eps, void* stream) {
  Geometry gm;
  if (rows <= 0 || !pick<T>(d, &gm)) return (int)cudaErrorInvalidValue;
#define RMSNORM_BWD_LAUNCH(T_, W_, V_)                                      \
  if constexpr (std::is_same<T, T_>::value) {                               \
    if (gm.warps == W_ && gm.vpl == V_)                                     \
      return (int)launch_bwd<T, W_, V_>(x, scale, g, dx, dscale,           \
                                        static_cast<float*>(scratch),      \
                                        scratch_rows, rows, d, eps,        \
                                        (cudaStream_t)stream);             \
  }
  RMSNORM_SHAPES(RMSNORM_BWD_LAUNCH)
#undef RMSNORM_BWD_LAUNCH
  return (int)cudaErrorInvalidValue;
}

__global__ void empty_kernel() {}

}  // namespace

// x and scale 16-byte aligned, D a multiple of 8 (bf16) or 4 (f32) up to
// kMaxD; the Python wrapper checks both.  Another D returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int rmsnorm_bf16(const void* x, const void* scale, void* out,
                            int rows, int d, float eps, void* stream) {
  return dispatch<__nv_bfloat16>(x, scale, out, rows, d, eps, stream);
}

extern "C" int rmsnorm_f32(const void* x, const void* scale, void* out,
                           int rows, int d, float eps, void* stream) {
  return dispatch<float>(x, scale, out, rows, d, eps, stream);
}

// The backward: dx (x's shape) and dscale (D,) from x, scale and the
// output's gradient g, all of one dtype, 16-byte aligned; scratch holds
// scratch_rows x D floats, at least min(rows, kBwdMaxBlocks) rows.  Another
// D, or too small a scratch, returns cudaErrorInvalidValue and launches
// nothing.
extern "C" int rmsnorm_bwd_bf16(const void* x, const void* scale,
                                const void* g, void* dx, void* dscale,
                                void* scratch, int scratch_rows, int rows,
                                int d, float eps, void* stream) {
  return dispatch_bwd<__nv_bfloat16>(x, scale, g, dx, dscale, scratch,
                                     scratch_rows, rows, d, eps, stream);
}

extern "C" int rmsnorm_bwd_f32(const void* x, const void* scale,
                               const void* g, void* dx, void* dscale,
                               void* scratch, int scratch_rows, int rows,
                               int d, float eps, void* stream) {
  return dispatch_bwd<float>(x, scale, g, dx, dscale, scratch, scratch_rows,
                             rows, d, eps, stream);
}

// The (warps, vpl) that rows of d elements of elem_bytes (2: bf16, 4: f32)
// take, for the tests; cudaErrorInvalidValue for a D or a type the kernel
// does not take.
extern "C" int rmsnorm_geometry(int d, int elem_bytes, int* warps,
                                int* vpl) {
  Geometry g{0, 0};
  const bool ok = elem_bytes == 2   ? pick<__nv_bfloat16>(d, &g)
                  : elem_bytes == 4 ? pick<float>(d, &g)
                                    : false;
  *warps = g.warps;
  *vpl = g.vpl;
  return ok ? 0 : (int)cudaErrorInvalidValue;
}

// One block of one warp that does nothing: what no launch through this
// route can beat.
extern "C" int launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
