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

#include <math.h>

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

// ---------------------------------------------------------------------------
// Latent attention (DeepSeek-V2's MLA), the absorbed form.  Replaces no TPU
// kernel: the JAX package has no latent attention.
//
// Each token of a layer caches one latent row [c_kv (512) | k_pe (64)];
// all 16 query heads attend over it.  The caller absorbs W_UK into the
// query (q~_h = [q_nope_h W_UK,h^T | q_pe_h], 576 wide), so a score is
// q~_h . row, and the values are each row's first 512 columns: the kernel
// gives o~_h = sum_j p_hj c_j, and the caller applies W_UV.
//
// Bound.  Per key: 1,152 bytes and 2 * 16 * (576 + 512) = 34,816 flops,
// 30 flops a byte, below the card's 295 (bf16 tensor cores) but above
// what the CUDA cores reach in f32 (67 TFLOP/s: 20 a byte).  So the
// products run on the tensor cores: the 16 heads are exactly the 16 rows
// of `mma.sync.m16n8k16`, and a latent row is read once for all of them.
//
// Design.  The split of the GQA kernels: each sequence is one cluster of
// kRanks = 8 blocks, page j of its table dealt to rank j % 8 (a function
// of the key index alone, so a row's output does not depend on its
// batch-mates).  A rank stages kMlaKeys = 32 keys at a time (its pages,
// 32 / PS of them) into a two-stage shared ring by 16-byte `cp.async`
// copies, keys at or past the length zero-filled, never read.  Per tile:
// each of the 4 warps scores 8 keys against the 16 heads (36 k16 steps of
// Q~ . K^T, two accumulators), the scores go to shared memory; 8 threads a
// head take the tile's max and sum (f32 online softmax, exp2 in log2
// units) and write P in bf16; each warp then adds P . V into its 128 of the
// 512 output columns (f32 accumulators in registers).  Combining: every
// rank leaves (acc, m, l) in its own shared memory; after a cluster
// barrier rank r reads all 8 partials of its 64 columns through
// distributed shared memory, in rank order, and writes them out; a second
// barrier keeps every rank's memory alive until then.  No atomics: the
// same bits every call.  ~98 KB of shared memory a block, two blocks an SM.

constexpr int kMlaKw = 576;             // latent row: c_kv | k_pe
constexpr int kMlaVw = 512;             // values: the first 512 columns
constexpr int kMlaG = 16;               // query heads sharing a row
constexpr int kMlaKeys = 32;            // keys a rank stages at a time
constexpr int kMlaLd = kMlaKw + 8;      // shared row stride (bf16)
constexpr int kMlaSs = kMlaKeys + 4;    // score row stride (f32)
constexpr int kMlaPs = kMlaKeys + 8;    // probability row stride (bf16)
constexpr int kMlaCols = kMlaVw / decode_attn::kWarps;   // 128 a warp

struct Mla576 {};  // the instantiation's tag: (576, 512, 16)

struct MlaArgs {
  const __nv_bfloat16* q;       // (B, 16, 576): [q~ | q_pe]
  const __nv_bfloat16* pages;   // (NP, PS, 576)
  const int* tables;            // (B, MP)
  const int* lengths;           // (B,)
  __nv_bfloat16* out;           // (B, 16, 512)
  int mp, ps;
  float scale_log2;             // the softmax scale times log2(e)
};

__host__ __device__ constexpr size_t mla_ring_bytes() {
  return (size_t)2 * kMlaKeys * kMlaLd * 2;
}
__host__ __device__ constexpr size_t mla_q_bytes() {
  return (size_t)kMlaG * kMlaLd * 2;
}
__host__ __device__ constexpr size_t mla_fixed_bytes() {
  return mla_ring_bytes() + mla_q_bytes() + (size_t)kMlaG * kMlaSs * 4 +
         (size_t)kMlaG * kMlaPs * 2 + (size_t)3 * kMlaG * 4;
}
inline size_t mla_smem_bytes(int mp) {
  const int max_ids = (mp + decode_attn::kRanks - 1) / decode_attn::kRanks;
  return mla_fixed_bytes() + ((size_t)max_ids * 4 + 15) / 16 * 16;
}

__device__ __forceinline__ unsigned mla_smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared; `bytes` 0 writes zeros and reads nothing.
__device__ __forceinline__ void mla_cp16(void* dst, const void* src,
                                         int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   mla_smem(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mla_ldm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(mla_smem(p)));
}

__device__ __forceinline__ void mla_ldm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(mla_smem(p)));
}

// d += a (16 x 16, row major) . b (16 x 8, column major), bf16 in, f32 sum.
__device__ __forceinline__ void mla_mma(float* d, const uint32_t* a,
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The latent-attention instance of `paged_decode_kernel` (selected by its
// tag type; the GQA instances are the <GM, HDM> template above).
template <class Shape>
__global__ void __cluster_dims__(decode_attn::kRanks, 1, 1)
__launch_bounds__(decode_attn::kThreads, 2)
paged_decode_kernel(const MlaArgs a) {
  using namespace decode_attn;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sq = ring + 2 * kMlaKeys * kMlaLd;
  float* ss = reinterpret_cast<float*>(sq + kMlaG * kMlaLd);
  __nv_bfloat16* sp = reinterpret_cast<__nv_bfloat16*>(ss + kMlaG * kMlaSs);
  float* sm = reinterpret_cast<float*>(sp + kMlaG * kMlaPs);
  float* sl = sm + kMlaG;
  float* salpha = sl + kMlaG;
  int* ids = reinterpret_cast<int*>(smem + mla_fixed_bytes());

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ps = a.ps, tg = kMlaKeys / ps;     // pages a tile stages
  const int len = max(0, min(a.lengths[b], a.mp * ps));
  const int* table = a.tables + (size_t)b * a.mp;
  const __nv_bfloat16* qb = a.q + (size_t)b * kMlaG * kMlaKw;

  const int n_pages = (len + ps - 1) / ps;
  const int n_mine =
      rank < n_pages ? (n_pages - rank + kRanks - 1) / kRanks : 0;
  const int n_tiles = (n_mine + tg - 1) / tg;
  for (int i = tid; i < n_mine; i += kThreads) ids[i] = table[rank + kRanks * i];
  if (tid < kMlaG) {
    sm[tid] = -INFINITY;
    sl[tid] = 0.f;
  }
  for (int i = tid; i < kMlaG * kMlaKw / 8; i += kThreads) {
    const int g = i / (kMlaKw / 8), c = (i % (kMlaKw / 8)) * 8;
    mla_cp16(sq + g * kMlaLd + c, qb + g * kMlaKw + c, 16);
  }
  __syncthreads();               // the page ids, before any copy uses them

  // tile n (the rank's pages n * tg ..) into ring stage n & 1
  auto issue = [&](int n) {
    __nv_bfloat16* dst = ring + (size_t)(n & 1) * kMlaKeys * kMlaLd;
    for (int i = tid; i < kMlaKeys * (kMlaKw / 8); i += kThreads) {
      const int r = i / (kMlaKw / 8), c = (i % (kMlaKw / 8)) * 8;
      const int u = r / ps, slot = r - u * ps, i_mine = n * tg + u;
      const int key = (rank + kRanks * i_mine) * ps + slot;
      const bool real = i_mine < n_mine && key < len;
      const __nv_bfloat16* src =
          real ? a.pages + ((size_t)ids[i_mine] * ps + slot) * kMlaKw + c
               : a.pages;
      mla_cp16(dst + r * kMlaLd + c, src, real ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float o[kMlaCols / 8][4];
#pragma unroll
  for (int n = 0; n < kMlaCols / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  if (n_tiles > 0) issue(0);     // one group with the queries
  if (n_tiles > 1) issue(1);
  for (int n = 0; n < n_tiles; ++n) {
    if (n == 0 && n_tiles > 1) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();             // tile n landed; tile n - 1 consumed
    if (n >= 1 && n + 1 < n_tiles) issue(n + 1);   // into n - 1's stage
    const __nv_bfloat16* kt = ring + (size_t)(n & 1) * kMlaKeys * kMlaLd;

    // scores of the 16 heads against this warp's 8 keys
    float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 6
    for (int kp = 0; kp < kMlaKw / 32; ++kp) {
      uint32_t qa[4], qc[4], kf[4];
      mla_ldm_x4(qa, sq + (lane & 15) * kMlaLd + kp * 32 + (lane >> 4) * 8);
      mla_ldm_x4(qc, sq + (lane & 15) * kMlaLd + kp * 32 + 16 +
                         (lane >> 4) * 8);
      mla_ldm_x4(kf, kt + (warp * 8 + (lane & 7)) * kMlaLd + kp * 32 +
                         (lane >> 3) * 8);
      mla_mma(s0, qa, kf[0], kf[1]);
      mla_mma(s1, qc, kf[2], kf[3]);
    }
    const int key0 = warp * 8 + 2 * (lane & 3);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = key0 + (e & 1);
      const int u = r / ps, i_mine = n * tg + u;
      const int key = (rank + kRanks * i_mine) * ps + (r - u * ps);
      const bool real = i_mine < n_mine && key < len;
      ss[((lane >> 2) + (e >> 1) * 8) * kMlaSs + r] =
          real ? (s0[e] + s1[e]) * a.scale_log2 : -INFINITY;
    }
    __syncthreads();

    // online softmax: 8 threads a head, 4 keys each
    {
      const int g = tid >> 3, part = tid & 7;
      float x[4], mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[e] = ss[g * kMlaSs + part * 4 + e];
        mx = fmaxf(mx, x[e]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sm[g];
      const float m_new = fmaxf(m_old, mx);
      const float base = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[e] = exp2f(x[e] - base);
        sum += x[e];
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      *reinterpret_cast<__nv_bfloat162*>(sp + g * kMlaPs + part * 4) =
          __floats2bfloat162_rn(x[0], x[1]);
      *reinterpret_cast<__nv_bfloat162*>(sp + g * kMlaPs + part * 4 + 2) =
          __floats2bfloat162_rn(x[2], x[3]);
      __syncwarp();
      if (part == 0) {
        const float alpha = exp2f(m_old - base);
        salpha[g] = alpha;
        sl[g] = sl[g] * alpha + sum;
        sm[g] = m_new;
      }
    }
    __syncthreads();

    // o += P . V over this warp's 128 columns
    const float al_a = salpha[lane >> 2], al_b = salpha[(lane >> 2) + 8];
#pragma unroll
    for (int j = 0; j < kMlaCols / 8; ++j) {
      o[j][0] *= al_a;
      o[j][1] *= al_a;
      o[j][2] *= al_b;
      o[j][3] *= al_b;
    }
#pragma unroll
    for (int kk = 0; kk < kMlaKeys / 16; ++kk) {
      uint32_t pa[4];
      mla_ldm_x4(pa, sp + (lane & 15) * kMlaPs + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < kMlaCols / 16; ++np) {
        uint32_t vf[4];
        mla_ldm_x4_t(vf, kt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  kMlaLd +
                              warp * kMlaCols + np * 16 + (lane >> 4) * 8);
        mla_mma(o[2 * np], pa, vf[0], vf[1]);
        mla_mma(o[2 * np + 1], pa, vf[2], vf[3]);
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();               // the ring is free: it holds the partial

  // this rank's partial: acc (16, 512), m (16), l (16), in f32
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < kMlaCols / 8; ++j) {
    const int c = warp * kMlaCols + j * 8 + 2 * (lane & 3);
    part[(lane >> 2) * kMlaVw + c] = o[j][0];
    part[(lane >> 2) * kMlaVw + c + 1] = o[j][1];
    part[((lane >> 2) + 8) * kMlaVw + c] = o[j][2];
    part[((lane >> 2) + 8) * kMlaVw + c + 1] = o[j][3];
  }
  if (tid < kMlaG) {
    part[kMlaG * kMlaVw + tid] = sm[tid];
    part[kMlaG * kMlaVw + kMlaG + tid] = sl[tid];
  }
  cluster.sync();                // every rank's partial is written

  // rank r combines columns [64 r, 64 r + 64) of every head, ranks in order
  constexpr int kSlice = kMlaVw / kRanks;
  for (int i = tid; i < kMlaG * kSlice; i += kThreads) {
    const int g = i / kSlice, c = rank * kSlice + i % kSlice;
    float mx = -INFINITY;
#pragma unroll
    for (int r = 0; r < kRanks; ++r)
      mx = fmaxf(mx, cluster.map_shared_rank(part, r)[kMlaG * kMlaVw + g]);
    float acc = 0.f, l = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int r = 0; r < kRanks; ++r) {
        const float* pr = cluster.map_shared_rank(part, r);
        const float w = exp2f(pr[kMlaG * kMlaVw + g] - mx);
        acc = fmaf(w, pr[g * kMlaVw + c], acc);
        l = fmaf(w, pr[kMlaG * kMlaVw + kMlaG + g], l);
      }
    }
    a.out[((size_t)b * kMlaG + g) * kMlaVw + c] =
        __float2bfloat16(mx == -INFINITY ? 0.f : acc / fmaxf(l, 1e-20f));
  }
  cluster.sync();                // no rank leaves while another reads it
}

}  // namespace

// Latent attention over the pages: q (B, 16, 576) bf16, pages
// (NP, PS, 576) bf16, tables (B, MP), lengths (B,) int32 -> out
// (B, 16, 512) bf16; PS must divide 32 (the Python wrapper checks it and
// every pointer's 16-byte alignment); `scale` multiplies the scores.
extern "C" int paged_mla_decode_attention_bf16(
    const void* q, const void* pages, const void* tables,
    const void* lengths, void* out, int batch, int ps, int mp, float scale,
    void* stream) {
  if (batch < 1 || ps < 1 || kMlaKeys % ps || mp < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = mla_smem_bytes(mp);
  cudaError_t e = decode_attn::allow_smem(paged_decode_kernel<Mla576>, smem);
  if (e != cudaSuccess) return e;
  const MlaArgs a{(const __nv_bfloat16*)q, (const __nv_bfloat16*)pages,
                  (const int*)tables, (const int*)lengths,
                  (__nv_bfloat16*)out, mp, ps, scale * 1.4426950408889634f};
  dim3 grid(decode_attn::kRanks, 1, batch);
  paged_decode_kernel<Mla576>
      <<<grid, decode_attn::kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

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
