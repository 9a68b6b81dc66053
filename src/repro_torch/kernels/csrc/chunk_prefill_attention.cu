// Fused causal flash attention for the chunked prefill, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's cached prefill
// (`repro/models/layers.py` `attention_apply`, `prefix_kv` branch) is plain
// jnp `full_attention`.  The port added it because that formula, eager on
// the card, is the serving path's largest cost: the unit runner pads every
// chunk to the step budget S (2,048 rows) and its keys to the arena's
// capacity plus S (8,448), expands K/V to every query head and writes the
// whole score tile to device memory in f32, some seven passes over ~1 GB a
// layer at smollm-360m's widths, while the real rows and keys of a chunk
// are a small causal corner of it.
//
// What it computes.  q (B, S, H, hd) after RoPE; the prefix's K/V
// (B, P, Hkv, hd) and the chunk's own K/V (B, >= n_rows, Hkv, hd), read
// where they lie (no concatenation, no padding, no expansion: query head h
// reads kv head h / (H / Hkv)).  Values may be narrower than queries and
// keys (DeepSeek-V2's latent attention decompresses to keys of 192 and
// values of 128), and the softmax scale is the caller's.  Chunk row r sits at absolute position P + r and
// attends to keys 0 .. P + r, key j being prefix row j for j < P and chunk
// row j - P after.  Only the first `n_rows` rows are real; the rest trail
// as padding and get zeros, and no key past the last real row's position
// is read.  Scores and the online softmax are f32; the probabilities are
// rounded to bf16 for P.V, which accumulates in f32; the output is bf16.
//
// Bound.  At a typical chunk (c = 1,000 real rows after P = 1,900, smollm's
// 15/5 heads of 64) the causal cells are ~36 M a layer: 9.2 GFLOP on the
// tensor cores (9.3 us at 989 TFLOP/s) against 7.5 MB of q, K, V and out
// (2.2 us at 3.35 TB/s): bound by operations, and by how well the tiles
// keep the tensor cores fed.
//
// Design (FlashAttention-2's forward).  A block takes kBlockM = 64 query
// rows of one head of one sequence, 16 rows a warp; row tiles are launched
// heaviest first.  It walks key tiles of kBlockN = 64 keys from absolute
// key 0 up to its last real row's causal limit, staging K and V through a
// two-stage shared-memory ring filled by 16-byte `cp.async` copies (the
// next tile is in flight while the current one is scored); keys past the
// limit are zero-filled, not read.  Q.K^T and P.V run on the tensor cores
// (`mma.sync.m16n8k16`, bf16 in, f32 accumulate) with operands from
// `ldmatrix`; shared rows are padded by 16 bytes so those loads meet no
// bank conflict.  Each thread keeps the running max m, sum l and output
// accumulator of its two rows in registers; no score reaches device
// memory.  A warp skips a key tile that lies wholly past its own rows; a
// block whose rows are all padding writes zeros and reads nothing.
//
// Why a row's bits do not depend on where the prompt was cut.  The unit
// runner and `ProcessingUnit._prefill` rely on a sequence's tokens being
// the same whatever shares its step and whether its prefix came from the
// cache; within this kernel that means a real row's output must not
// depend on P, n_rows or the row's place in its row tile.  (1) Key tiles
// are anchored at absolute key 0 and walked in one order, so row P + r
// meets the same keys in the same tiles at the same lanes whatever the
// chunk boundaries.  (2) Scores are per-row dot products: an mma output
// element depends on its row of A and column of B only, and the quad
// reductions of a row's max and sum run the same shuffles in every row.
// (3) A key past a row's position is masked to -inf before the max, so it
// leaves m as it was, adds exp2(-inf) = 0 to l and a zero product to the
// accumulator; a tile wholly past the row (walked because the rows after
// it need it) then gives alpha = exp2(0) = 1 exactly and changes nothing.
// (4) A masked key's value is finite (a chunk row or a zero fill), so its
// zero probability adds exactly 0 to P.V.  So the keys one cut walks and
// another does not add exactly nothing, and the rest is computed the same.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;              // query rows of a block
constexpr int kBlockN = 64;              // keys of a tile
constexpr int kWarps = kBlockM / 16;     // one m16 slice of rows a warp
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;                  // bf16 padding a shared row
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const __nv_bfloat16* q;    // (B, S, H, hd), contiguous
  const __nv_bfloat16* pk;   // (B, P, Hkv, hd), rows contiguous
  const __nv_bfloat16* pv;   // (B, P, Hkv, hd_v), rows contiguous
  const __nv_bfloat16* k;    // (B, >= n_rows, Hkv, hd), rows contiguous
  const __nv_bfloat16* v;    // (B, >= n_rows, Hkv, hd_v), rows contiguous
  __nv_bfloat16* out;        // (B, S, H, hd_v), contiguous
  long long pk_b, pv_b, k_b, v_b;   // batch strides, in elements
  int s, p, n_rows, h, hkv, group;
  float scale_log2;          // the softmax scale times log2(e)
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared; `bytes` 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16 x 16, row major) . b (16 x 8, column major), bf16 in, f32 sum.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// HD: query and key width; HDV: value width (HD for every family but
// latent attention's 192 / 128).
template <int HD, int HDV>
constexpr int smem_bytes() {
  return ((kBlockM + 2 * kBlockN) * (HD + kPad) +
          2 * kBlockN * (HDV + kPad)) * 2;
}

template <int HD, int HDV>
__global__ void __launch_bounds__(kThreads)
chunk_attention_kernel(const Args a) {
  constexpr int LD = HD + kPad;          // shared row stride of q, K (bf16)
  constexpr int LDV = HDV + kPad;        // shared row stride of V
  constexpr int VEC = HD / 8;            // 16-byte pieces of a q or K row
  constexpr int VECV = HDV / 8;          // of a V row
  constexpr int KSTEPS = HD / 16;        // k16 steps of q . k
  constexpr int NT = HDV / 8;            // n8 tiles of the output
  constexpr int STAGE = kBlockN * (LD + LDV);   // one ring stage: K, V
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* skv = sq + kBlockM * LD;   // [stage][K (LD), V (LDV)]

  const int r0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;  // heaviest first
  const int head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / a.group;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t q_row = (size_t)a.h * HD, o_row = (size_t)a.h * HDV;
  const size_t k_row = (size_t)a.hkv * HD, v_row = (size_t)a.hkv * HDV;
  const __nv_bfloat16* qb = a.q + (size_t)b * a.s * q_row + head * HD;
  __nv_bfloat16* ob = a.out + (size_t)b * a.s * o_row + head * HDV;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  if (r0 >= a.n_rows) {       // padding rows only: zeros, nothing read
    for (int i = tid; i < kBlockM * VECV; i += kThreads) {
      const int r = r0 + i / VECV;
      if (r < a.s)
        *reinterpret_cast<uint4*>(ob + r * o_row + (i % VECV) * 8) = zero;
    }
    return;
  }

  // the last key the block reads: its last real row's position
  const int kmax = a.p + min(r0 + kBlockM, a.n_rows) - 1;
  const int n_tiles = kmax / kBlockN + 1;
  const __nv_bfloat16* pkb = a.pk + (size_t)b * a.pk_b + kvh * HD;
  const __nv_bfloat16* pvb = a.pv + (size_t)b * a.pv_b + kvh * HDV;
  const __nv_bfloat16* kb = a.k + (size_t)b * a.k_b + kvh * HD;
  const __nv_bfloat16* vb = a.v + (size_t)b * a.v_b + kvh * HDV;

  // the block's query rows, padding rows as zeros
  for (int i = tid; i < kBlockM * VEC; i += kThreads) {
    const int j = i / VEC, c = (i % VEC) * 8, r = r0 + j;
    const bool real = r < a.n_rows;
    cp_async16(sq + j * LD + c, real ? qb + r * q_row + c : a.q,
               real ? 16 : 0);
  }

  // key tile t (absolute keys t * kBlockN ..) into ring stage t & 1
  auto load_tile = [&](int t) {
    __nv_bfloat16* dk = skv + (size_t)(t & 1) * STAGE;
    __nv_bfloat16* dv = dk + kBlockN * LD;
    for (int i = tid; i < kBlockN * VEC; i += kThreads) {
      const int j = i / VEC, c = (i % VEC) * 8, key = t * kBlockN + j;
      const __nv_bfloat16* src = a.k;
      int bytes = 0;
      if (key <= kmax) {
        bytes = 16;
        src = key < a.p ? pkb + key * k_row + c : kb + (key - a.p) * k_row + c;
      }
      cp_async16(dk + j * LD + c, src, bytes);
    }
    for (int i = tid; i < kBlockN * VECV; i += kThreads) {
      const int j = i / VECV, c = (i % VECV) * 8, key = t * kBlockN + j;
      const __nv_bfloat16* src = a.v;
      int bytes = 0;
      if (key <= kmax) {
        bytes = 16;
        src = key < a.p ? pvb + key * v_row + c : vb + (key - a.p) * v_row + c;
      }
      cp_async16(dv + j * LDV + c, src, bytes);
    }
    cp_async_commit();
  };

  // this warp's rows: wr0 + lane / 4 (a) and 8 below it (b)
  const int wr0 = r0 + warp * 16;
  const int pos_a = a.p + wr0 + (lane >> 2), pos_b = pos_a + 8;
  // the last key a real row of this warp attends to (-1 when every row of
  // the warp is padding: it then walks no tile)
  const int w_kmax = wr0 < a.n_rows ? a.p + min(wr0 + 15, a.n_rows - 1) : -1;
  const int w_first = a.p + wr0;

  uint32_t qf[KSTEPS][4];
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  load_tile(0);                 // one group with the query rows
  if (n_tiles > 1) load_tile(1);
  for (int t = 0; t < n_tiles; ++t) {
    if (t == 0 && n_tiles > 1) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();            // tile t landed; tile t - 1 consumed
    if (t >= 1 && t + 1 < n_tiles) load_tile(t + 1);   // into t - 1's stage
    if (t == 0) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
        ldmatrix_x4(qf[ks], sq + (warp * 16 + (lane & 15)) * LD + ks * 16 +
                                (lane >> 4) * 8);
    }
    const int key0 = t * kBlockN;
    if (key0 > w_kmax) continue;         // wholly past this warp's rows
    const __nv_bfloat16* sk = skv + (size_t)(t & 1) * STAGE;
    const __nv_bfloat16* sv = sk + kBlockN * LD;

    // scores of the warp's 16 rows against the tile's 64 keys
    float s[kBlockN / 8][4];
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
      for (int np = 0; np < kBlockN / 16; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, sk + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                            ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[ks], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[ks], kf[2], kf[3]);
      }
    }

    // scale to log2 units; keys past a row's position masked to -inf
    const bool masked = key0 + kBlockN - 1 > w_first;
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + n * 8 + 2 * (lane & 3) + (e & 1);
        float x = s[n][e] * a.scale_log2;
        if (masked && key > (e < 2 ? pos_a : pos_b)) x = -INFINITY;
        s[n][e] = x;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    // a row that has met no key yet keeps a finite base (only padding rows)
    const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float alpha_a = exp2f(m_a - base_a), alpha_b = exp2f(m_b - base_b);
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) {
      s[n][0] = exp2f(s[n][0] - base_a);
      s[n][1] = exp2f(s[n][1] - base_a);
      s[n][2] = exp2f(s[n][2] - base_b);
      s[n][3] = exp2f(s[n][3] - base_b);
      sum_a += s[n][0] + s[n][1];
      sum_b += s[n][2] + s[n][3];
    }
    l_a = l_a * alpha_a + sum_a;       // this thread's part of the row sum
    l_b = l_b * alpha_b + sum_b;
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= alpha_a;
      o[n][1] *= alpha_a;
      o[n][2] *= alpha_b;
      o[n][3] *= alpha_b;
    }

    // o += P . V: the score fragments are P's A fragments, rounded to bf16
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < HDV / 16; ++np) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, sv + (kk * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * LDV +
                                  np * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * np], pa, vf[0], vf[1]);
        mma_bf16(o[2 * np + 1], pa, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait<0>();

  // the row sums over the quad, then o / l through this warp's rows of the
  // query stage (read only by this warp; rows of LDV <= LD), out in
  // 16-byte stores
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const bool real_a = pos_a - a.p < a.n_rows, real_b = pos_b - a.p < a.n_rows;
  __syncwarp();
  __nv_bfloat16* so = sq + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = n * 8 + 2 * (lane & 3);
    *reinterpret_cast<__nv_bfloat162*>(so + (lane >> 2) * LDV + c) =
        real_a ? __floats2bfloat162_rn(o[n][0] / l_a, o[n][1] / l_a)
               : __floats2bfloat162_rn(0.f, 0.f);
    *reinterpret_cast<__nv_bfloat162*>(so + ((lane >> 2) + 8) * LDV + c) =
        real_b ? __floats2bfloat162_rn(o[n][2] / l_b, o[n][3] / l_b)
               : __floats2bfloat162_rn(0.f, 0.f);
  }
  __syncwarp();
  for (int i = lane; i < 16 * VECV; i += 32) {
    const int j = i / VECV, c = (i % VECV) * 8, r = wr0 + j;
    if (r < a.s)
      *reinterpret_cast<uint4*>(ob + r * o_row + c) =
          *reinterpret_cast<const uint4*>(so + j * LDV + c);
  }
}

template <int HD, int HDV>
cudaError_t launch(const Args& a, int batch, void* stream) {
  constexpr int smem = smem_bytes<HD, HDV>();
  if (smem > 48 * 1024) {       // set on every launch: it is per device
    const cudaError_t e = cudaFuncSetAttribute(
        chunk_attention_kernel<HD, HDV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((a.s + kBlockM - 1) / kBlockM, a.h, batch);
  chunk_attention_kernel<HD, HDV>
      <<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The tiles the kernel walks, for the Python wrapper to check against its
// own constants: query rows of a row tile, keys of a key tile.
extern "C" int chunk_attention_geometry(int* block_m, int* block_n) {
  *block_m = kBlockM;
  *block_n = kBlockN;
  return 0;
}

// q (B, S, H, hd) and out (B, S, H, hd_v) contiguous; pk (B, P, Hkv, hd),
// pv (B, P, Hkv, hd_v), k (B, >= n_rows, Hkv, hd) and v (B, >= n_rows,
// Hkv, hd_v) with contiguous rows and the given batch strides; every
// pointer and stride 16-byte aligned (the Python wrapper checks);
// (hd, hd_v) one of (32, 32), (64, 64), (128, 128), (192, 128);
// 0 <= n_rows <= S; `scale` multiplies the scores.
extern "C" int chunk_attention_bf16(
    const void* q, const void* pk, const void* pv, const void* k,
    const void* v, void* out, long long pk_b, long long pv_b, long long k_b,
    long long v_b, int batch, int s, int p, int n_rows, int h, int hkv,
    int hd, int hd_v, float scale, void* stream) {
  if (batch < 1 || s < 1 || p < 0 || n_rows < 0 || n_rows > s || hkv < 1 ||
      h % hkv)
    return (int)cudaErrorInvalidValue;
  const Args a{(const __nv_bfloat16*)q,  (const __nv_bfloat16*)pk,
               (const __nv_bfloat16*)pv, (const __nv_bfloat16*)k,
               (const __nv_bfloat16*)v,  (__nv_bfloat16*)out,
               pk_b, pv_b, k_b, v_b, s, p, n_rows, h, hkv, h / hkv,
               scale * kLog2e};
  if (hd == hd_v) {
    switch (hd) {
      case 32: return (int)launch<32, 32>(a, batch, stream);
      case 64: return (int)launch<64, 64>(a, batch, stream);
      case 128: return (int)launch<128, 128>(a, batch, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (hd == 192 && hd_v == 128) return (int)launch<192, 128>(a, batch, stream);
  return (int)cudaErrorInvalidValue;
}
