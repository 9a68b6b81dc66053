// Batched PEND_DROP PMF convolution for Hopper (sm_90a), dissertation
// Eqs. 5.2-5.5.
//
// Replaces repro/kernels/pmf_conv/pmf_conv.py:74 `pmf_conv_pallas`.  For each
// of N (task, machine-tail) rows on a fixed compacted grid:
//   ok[t]    = [t < cut]
//   conv[t]  = sum_k pet[k] * pct[t-k] * ok[t-k]            (t < Lo = Lc+Le-1)
//   out[t]   = conv[t] + pct[t] * (1 - ok[t])               (late mass passes)
//   success  = min(1, sum_{t <= dl} conv[t])
// Two per-row indices: `cut` on the PCT grid and `dl` on the output grid.
// The Pallas kernel takes one index for both (cut = dl); the front door
// passes the two apart, since the grids' origins differ by PET's offset.
//
// Bound: at the scheduler's shapes (N=32, L=64) the inputs are 16 KB and the
// work ~260 kflop, so a launch costs its fixed overhead: the launch itself,
// the round trips to device memory, and the longest chain of dependent
// multiply-adds (Le of them for an output in the middle of the row, in k
// order).  Design: one warp owns a row, and a block holds up to kWarps
// rows, so a launch needs no block barrier.  Every global load of a row up
// to L = 128 (the deadline, PET, PCT, and the late mass of the lane's first
// outputs) is issued in one batch, so the row waits for one round trip.
// The warp stages PET (zero-padded) and the deadline-truncated PCT (with
// kPad zeros on each side) once in its own slice of shared memory.  Lanes
// own output positions in chunks of 32 * kOut: lane i owns the kOut
// consecutive positions t0 .. t0 + 3, t0 = base + kOut i (4 a lane at
// L = 64, two chunks at L = 128).  For each k the lane multiplies pet[k]
// into its kOut accumulators against a window of pct[t - k] held in
// registers, which slides by one value each k: a group of four k costs one
// broadcast 16-byte load of PET and four loads of PCT, issued a group ahead.
// The k range is the chunk's (the same for every lane, so PET's load is a
// broadcast and no lane diverges); every accumulator sums over it in
// increasing k, as the Pallas kernel's fori_loop does, and the zero terms
// it meets (PET's padding, PCT's zeros) leave the sum's bits as they are.
// PCT is stored in four rows by index mod 4, so the lanes' loads, kOut
// values apart, fall on consecutive words.  The success sum is one xor-
// butterfly warp reduction.  Rows too long for kWarps slices in 48 KB take
// fewer rows a block, down to one (with dynamic shared memory above 48 KB),
// so a row may hold Le + Lc up to 227 KB less about 280 floats of padding:
// Le + Lc <= 57,832 when both are multiples of 4 (a few floats less
// otherwise; `row_floats` is exact).  A longer row returns
// cudaErrorInvalidValue before any runtime call, so no error is left behind
// for the next launch (test_torch_cuda.py, test_pmf_conv_longest_row).

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;             // rows a block holds at most
constexpr int kOut = 4;               // consecutive outputs a lane owns
constexpr int kChunk = 32 * kOut;     // outputs a warp computes at a time
constexpr int kPad = kChunk + 8;      // zeros on each side of PCT
constexpr size_t kStaticSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;  // a block's opt-in limit on sm_90

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }
// PCT value i (-kPad <= i < lc + kPad) lies at row x % 4, column x / 4 of
// a 4 x pct_cols(lc) array, x = i + kPad
__host__ __device__ constexpr int pct_cols(int lc) {
  return (lc + 2 * kPad + 3) / 4;
}
// floats of a row's slice: PET, a group of zeros past it, then PCT
__host__ __device__ constexpr int row_floats(int le, int lc) {
  return round4(le) + 8 + 4 * pct_cols(lc);
}

__global__ void __launch_bounds__(kWarps * 32)
pmf_conv_kernel(const float* __restrict__ pet,   // (N, Le)
                const float* __restrict__ pct,   // (N, Lc)
                const float* __restrict__ dl,    // (N,) success index
                const float* __restrict__ cut,   // (N,) PEND cut index
                float* __restrict__ out,         // (N, Lo)
                float* __restrict__ success,     // (N,)
                int n, int le, int lc) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= n) return;
  const int le4 = round4(le), cols = pct_cols(lc);
  float* e_s = reinterpret_cast<float*>(smem4) +
               (size_t)warp * row_floats(le, lc);
  float* c_s = e_s + le4 + 8;
  auto at = [&](int i) -> float& {
    const int x = i + kPad;
    return c_s[(x & 3) * cols + (x >> 2)];
  };
  const int lo = lc + le - 1;
  const float* pet_n = pet + (size_t)row * le;
  const float* pct_n = pct + (size_t)row * lc;

  // zeros: past PET, and PCT's padding on both sides
  for (int k = le + lane; k < le4 + 8; k += 32) e_s[k] = 0.f;
  for (int t = lane - kPad; t < 0; t += 32) at(t) = 0.f;
  for (int t = lc + lane; t < lc + kPad; t += 32) at(t) = 0.f;
  const float d = dl[row], c = cut[row];
  float late[kOut];                    // pct[t] of the lane's outputs
  auto load_late = [&](int t0) {
#pragma unroll
    for (int j = 0; j < kOut; ++j) late[j] = t0 + j < lc ? pct_n[t0 + j] : 0.f;
  };
  load_late(kOut * lane);
  for (int b = 0; b < max(le, lc); b += kChunk) {
    float pe[kOut], pc[kOut];          // loaded together, then stored
#pragma unroll
    for (int r = 0; r < kOut; ++r) {
      const int i = b + lane + 32 * r;
      pe[r] = i < le ? pet_n[i] : 0.f;
      pc[r] = i < lc ? pct_n[i] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kOut; ++r) {
      const int i = b + lane + 32 * r;
      if (i < le) e_s[i] = pe[r];
      if (i < lc) at(i) = (float)i < c ? pc[r] : 0.f;
    }
  }
  __syncwarp();
  const float4* e4_s = reinterpret_cast<const float4*>(e_s);

  float part = 0.f;
  for (int base = 0; base < lo; base += kChunk) {
    const int t0 = base + kOut * lane;
    if (base > 0) load_late(t0);
    // the k whose terms can be non-zero in this chunk, whole groups of 4
    const int kb = max(0, (base - lc) & ~3), ke = min(le4, base + kChunk);
    float acc[kOut], w[kOut];          // w[j] = pct[t0 + j - k]
    const float* first = &at(t0 - kb);
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      acc[j] = 0.f;
      w[j] = first[j * cols];
    }
    // pct[t0 - k - 4 + r], r = 0..3: the values group k shifts in, one
    // column to the left of group k - 4's
    const float* src = &at(t0 - kb - 4);
    float4 e4 = e4_s[kb >> 2];
    float nx[4] = {src[3 * cols], src[2 * cols], src[cols], src[0]};
    for (int k = kb; k < ke; k += 4) {
      const float e[4] = {e4.x, e4.y, e4.z, e4.w};
      const float in[4] = {nx[0], nx[1], nx[2], nx[3]};
      --src;                           // the next group, a group ahead
      e4 = e4_s[(k >> 2) + 1];
      nx[0] = src[3 * cols], nx[1] = src[2 * cols], nx[2] = src[cols];
      nx[3] = src[0];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int j = 0; j < kOut; ++j) acc[j] += e[q] * w[j];
#pragma unroll
        for (int j = kOut - 1; j > 0; --j) w[j] = w[j - 1];
        w[0] = in[q];
      }
    }
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const int t = t0 + j;
      if (t >= lo) break;
      if ((float)t <= d) part += acc[j];
      out[(size_t)row * lo + t] = acc[j] + ((float)t < c ? 0.f : late[j]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, off);
  if (lane == 0) success[row] = fminf(part, 1.f);
}

}  // namespace

extern "C" int pmf_conv_f32(const void* pet, const void* pct, const void* dl,
                            const void* cut, void* out, void* success, int n,
                            int le, int lc, void* stream) {
  const size_t row_smem = sizeof(float) * (size_t)row_floats(le, lc);
  int rows = kWarps;
  while (rows > 1 && rows * row_smem > kStaticSmem) rows >>= 1;
  const size_t smem = rows * row_smem;
  if (n <= 0 || le <= 0 || lc <= 0 || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (smem > kStaticSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        pmf_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pmf_conv_kernel<<<(n + rows - 1) / rows, rows * 32, smem,
                    (cudaStream_t)stream>>>(
      (const float*)pet, (const float*)pct, (const float*)dl,
      (const float*)cut, (float*)out, (float*)success, n, le, lc);
  return (int)cudaGetLastError();
}
