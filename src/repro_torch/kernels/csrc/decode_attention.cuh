// Split-key flash-decode GQA attention for Hopper (sm_90a): the loop shared
// by the contiguous-cache kernel (decode_attention.cu) and the paged kernel
// (paged_decode_attention.cu).  The two differ only in where a granule of
// keys lies, which the caller passes as an addresser `KV`:
//   `int stride`  element distance between consecutive keys of a granule
//                 (Hkv * hd in both layouts);
//   `void load_ids(int rank, int n_mine, int* ids) const`  called by every
//                 thread before any copy: read what locating this rank's
//                 granules needs (the paged kernel's page ids) into shared
//                 memory;
//   `size_t granule(int j, int i_mine, const int* ids) const`  element
//                 offset of key 0 of granule j (the rank's i_mine-th) for
//                 this cluster's (sequence, kv head).
//
// Why it is split.  A decode step has one query per sequence, so the TPU
// kernels' grid (B, Hkv, key blocks) gives a card of 132 SMs only B * Hkv
// independent pieces of work (40 at B = 8, 5 at B = 1), each a serial walk
// over its keys.  Here each (sequence b, kv head h) is one cluster of
// kRanks = 8 blocks (grid (8, Hkv, B), `__cluster_dims__(8, 1, 1)`).  Keys
// are dealt to the ranks round robin in granules (kGranule = 16 keys of the
// contiguous cache, or one page of the paged one): granule j goes to rank
// j % 8.  The deal is a function of the key index alone, never of B, S or a
// row's batch-mates, so a row's output has the same bits alone or in any
// batch (batched == one-at-a-time tokens, prefix cache on == off).
//
// Within a rank.  The rank stages up to kTileKeys keys of K and V at a time
// as bf16 in a two-stage shared-memory ring filled by 16-byte `cp.async`
// copies: the prologue puts the rank's first two tiles in flight, and each
// later tile is issued while the one before it is scored.  No key at or
// past `len` is copied.  Each of the 4 warps owns fixed rows of every tile
// (rows 16 p + 4 w + 0..3 at head_dim 64) and keeps its own f32 online
// softmax (m, l, acc) in registers, so a tile costs one block barrier:
//   scores  a group of hd / 8 lanes splits a key's hd, each lane forms its
//           part of q_g . k_t from bf16 in shared memory and the group sums
//           with shuffles; every query row g and every pass of the tile is
//           unrolled, so the loads, dot products and shuffles overlap;
//   softmax the warp's max and sum over its rows by shuffles;
//   P.V     lane i owns output columns (2 i, 2 i + 1) + 64 j of every query
//           row; p reaches it by a shuffle from the lane that scored the
//           key.  No tensor cores: a (G = 3, hd = 64) tile is far below an
//           mma's rows, and the work is bound by bytes.
// The query-row count G and the head-dim capacity are template parameters
// (the DECODE_ATTN_SHAPES list), so every loop over them unrolls; a group
// wider than the list's widest for its head dim is cut into query blocks,
// one cluster each.
//
// Combining.  The four warps' partials are merged in warp order, and each
// rank writes its (m, l, acc) into slot `rank` of rank 0's shared memory
// through distributed shared memory.  After one cluster barrier, rank 0
// combines the slots in rank order 0..7, rescaling each by exp(m_r - m),
// and writes acc / max(l, 1e-20) in bf16.  A rank with no keys writes
// m = -1e30, l = 0, acc = 0, so a row of length 0 gets zeros, as from the
// Pallas kernels.  No atomics and no workspace in device memory: one launch
// a call, and the same bits every call.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode_attn {

namespace cg = cooperative_groups;

constexpr int kRanks = 8;          // blocks of a cluster, one (sequence, kv head)
constexpr int kGranule = 16;       // keys of a contiguous-cache granule
constexpr int kTileKeys = 64;      // keys a rank stages at a time up to hd 128
                                   // (fewer above; one page if it is longer)
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxOut = 1024;      // G * hd

// Blocks an SM should hold for the instantiation (GM, HDM): five for the
// narrow ones, so that a B = 8 launch (320 blocks at Hkv = 5) fits the
// card's 132 SMs in one wave; a second wave costs a served step more than
// wider blocks save.
constexpr int min_blocks(int gm, int hdm) { return gm * hdm <= 256 ? 5 : 1; }

// (query rows of a block GM, head-dim capacity HDM) the kernels are built
// for.  `pick` maps a (G, hd) onto them.
#define DECODE_ATTN_SHAPES(X)                                            \
  X(1, 64) X(2, 64) X(3, 64) X(4, 64) X(8, 64) X(1, 128) X(2, 128)       \
  X(4, 128) X(8, 128) X(1, 256) X(2, 256) X(4, 256) X(1, 512) X(2, 512)  \
  X(1, 1024)

// What both the host (grid, shared-memory size) and the device (layout)
// derive from the shapes.
struct Geometry {
  int group, hd;       // query rows per kv head, head dim
  int gm, n_gb;        // query rows of a block (the template's GM), blocks
  int gran;            // keys of a granule
  int tile_granules;   // granules a tile stages
  int rows;            // keys a tile stages: tile_granules * gran
  int max_ids;         // page ids a rank keeps (paged), else 0
};

// The instantiation for (group, hd): the smallest head-dim capacity that
// holds hd, and the fewest query rows that hold the group (else the most
// there are, in several query blocks).
inline bool pick(int group, int hd, int* gm, int* hdm) {
  int h = 64;
  while (h < hd) h *= 2;
  int best = 0, widest = 0;
#define DECODE_ATTN_PICK(G_, H_)                                  \
  if (H_ == h) {                                                  \
    if (G_ >= group && (best == 0 || G_ < best)) best = G_;       \
    if (G_ > widest) widest = G_;                                 \
  }
  DECODE_ATTN_SHAPES(DECODE_ATTN_PICK)
#undef DECODE_ATTN_PICK
  *gm = best ? best : widest;
  *hdm = h;
  return widest > 0;
}

inline Geometry make_geometry(int group, int hd, int gm, int gran,
                              int max_granules, bool ids) {
  // a tile holds 64 keys up to hd = 128, fewer above (at most 32 KB a stage)
  const int keys = kTileKeys * 128 / (hd > 128 ? hd : 128);
  Geometry g{group, hd, gm, (group + gm - 1) / gm, gran,
             gran >= keys ? 1 : keys / gran, 0, 0};
  g.rows = g.tile_granules * gran;
  g.max_ids = ids ? (max_granules + kRanks - 1) / kRanks : 0;
  return g;
}

// Shared memory: the K/V ring (2 stages x K, V x rows x hd bf16), the page
// ids, the warps' partials and rank 0's kRanks slots, each a partial
// (acc (GM, hd), m (GM,), l (GM,)) in f32.
__host__ __device__ inline size_t ring_bytes(const Geometry& g) {
  return (size_t)2 * 2 * g.rows * g.hd * 2;
}
__host__ __device__ inline size_t ids_bytes(const Geometry& g) {
  return ((size_t)g.max_ids * 4 + 15) / 16 * 16;
}
__host__ __device__ inline int partial_floats(const Geometry& g) {
  return g.gm * g.hd + 2 * g.gm;
}
inline size_t smem_bytes(const Geometry& g) {
  return ring_bytes(g) + ids_bytes(g) +
         (size_t)(kWarps + kRanks) * partial_floats(g) * 4;
}

// Host-side argument checks shared by both entry points.
inline bool shape_ok(int group, int hd) {
  int gm, hdm;
  return group * hd <= kMaxOut && hd % 8 == 0 && pick(group, hd, &gm, &hdm);
}

// Let a kernel take more than 48 KB of dynamic shared memory if it needs it.
// More than a block can have (227 KB: a page of over 64 keys at hd 256, say)
// is refused here, before any runtime call could leave an error behind for
// the next launch's cudaGetLastError.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 8 bf16 (16 bytes) to f32.
__device__ __forceinline__ void unpack8(const uint4& w, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(h[i]);
    f[2 * i] = a.x;
    f[2 * i + 1] = a.y;
  }
}

// One block of the cluster for (sequence b, kv head h, query block).  q_b:
// the block's (rows_q, hd) query rows; o_b: its output rows; len: keys to
// attend over, already clamped to the capacity.
template <int GM, int HDM, class KV>
__device__ __forceinline__ void split_decode(
    const __nv_bfloat16* __restrict__ q_b, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const KV& kv, int len, int rows_q,
    __nv_bfloat16* __restrict__ o_b, const Geometry geo, float scale) {
  constexpr int LPK = HDM / 8 < 32 ? HDM / 8 : 32;  // lanes scoring one key
  constexpr int CPL = HDM / 8 / LPK;     // 16-byte chunks of a key a lane holds
  constexpr int KPW = 32 / LPK;          // keys a warp scores at once
  constexpr int RG = kWarps * KPW;       // rows of a tile one pass covers
  constexpr int PASSES = kTileKeys / RG;
  constexpr int PAIRS = HDM / 64;        // output column pairs a lane owns
  extern __shared__ __align__(16) unsigned char smem[];

  // arrive now, wait before writing into rank 0: every block of the
  // cluster has started by then, so its shared memory exists
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane % LPK, slot = lane / LPK;
  const int hd = geo.hd, gran = geo.gran, tg = geo.tile_granules;
  const int rows = geo.rows, vec = hd / 8;

  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  int* ids = reinterpret_cast<int*>(smem + ring_bytes(geo));
  float* part = reinterpret_cast<float*>(smem + ring_bytes(geo) + ids_bytes(geo));
  const int pf = partial_floats(geo);
  float* slots = part + kWarps * pf;     // rank 0's: (kRanks, partial)

  // this lane's chunks of the query rows, in f32 (zero past rows_q and hd)
  float qr[GM][CPL][8];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = sub + LPK * i;
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (g < rows_q && c < vec)
        w = *reinterpret_cast<const uint4*>(q_b + (size_t)g * hd + c * 8);
      unpack8(w, qr[g][i]);
    }
  }

  // this rank's granules: j = rank + 8 i, i < n_mine
  const int n_gran = (len + gran - 1) / gran;
  const int n_mine = rank < n_gran ? (n_gran - rank + kRanks - 1) / kRanks : 0;
  const int n_tiles = (n_mine + tg - 1) / tg;
  kv.load_ids(rank, n_mine, ids);
  __syncthreads();

  // Stage tile n (the rank's granules n*tg ..) into ring stage n & 1.
  auto issue = [&](int n) {
    __nv_bfloat16* kd = ring + (size_t)(n & 1) * 2 * rows * hd;
    __nv_bfloat16* vd = kd + (size_t)rows * hd;
    const int u_end = min(tg, n_mine - n * tg);
    for (int u = 0; u < u_end; ++u) {
      const int i_mine = n * tg + u;
      const int j = rank + kRanks * i_mine;
      const int keys = min(gran, len - j * gran);
      const size_t base = kv.granule(j, i_mine, ids);
      for (int c = tid; c < keys * vec; c += kThreads) {
        const int kk = c / vec, e = (c - kk * vec) * 8;
        const size_t off = base + (size_t)kk * kv.stride + e;
        const int r = (u * gran + kk) * hd + e;
        cp_async16(kd + r, k + off);
        cp_async16(vd + r, v + off);
      }
    }
    cp_async_commit();
  };

  // this warp's online softmax carry
  float m[GM], l[GM], acc[GM][PAIRS][2];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = -1e30f;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < PAIRS; ++j) acc[g][j][0] = acc[g][j][1] = 0.f;
  }

  if (n_tiles > 0) issue(0);
  if (n_tiles > 1) issue(1);
  for (int n = 0; n < n_tiles; ++n) {
    if (n == 0 && n_tiles > 1) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();   // tile n landed for every thread; tile n-1 consumed
    if (n >= 1 && n + 1 < n_tiles) issue(n + 1);   // into tile n-1's stage
    const __nv_bfloat16* kt = ring + (size_t)(n & 1) * 2 * rows * hd;
    const __nv_bfloat16* vt = kt + (size_t)rows * hd;
    // keys of this tile, a prefix of its rows: its granules are full but
    // the sequence's last
    const int u_last = min(tg, n_mine - n * tg) - 1;
    const int j_last = rank + kRanks * (n * tg + u_last);
    const int valid = u_last * gran + min(gran, len - j_last * gran);

    for (int rb = 0; rb < valid; rb += kTileKeys) {
      // scores of this lane's key in each pass, summed over its group
      float s[GM][PASSES];
#pragma unroll
      for (int p = 0; p < PASSES; ++p) {
        const int r = rb + p * RG + warp * KPW + slot;
        uint4 kc[CPL];
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          const int c = sub + LPK * i;
          kc[i] = make_uint4(0u, 0u, 0u, 0u);
          if (r < valid && c < vec)
            kc[i] = *reinterpret_cast<const uint4*>(kt + (size_t)r * hd + c * 8);
        }
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          float a = 0.f;
#pragma unroll
          for (int i = 0; i < CPL; ++i) {
            float kf[8];
            unpack8(kc[i], kf);
#pragma unroll
            for (int e = 0; e < 8; ++e) a = fmaf(qr[g][i][e], kf[e], a);
          }
          s[g][p] = a;
        }
      }
#pragma unroll
      for (int o = LPK / 2; o > 0; o >>= 1)
#pragma unroll
        for (int g = 0; g < GM; ++g)
#pragma unroll
          for (int p = 0; p < PASSES; ++p)
            s[g][p] += __shfl_xor_sync(0xffffffffu, s[g][p], o);

      // online softmax over the warp's rows of this block
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float mx = -1e30f;
#pragma unroll
        for (int p = 0; p < PASSES; ++p) {
          const int r = rb + p * RG + warp * KPW + slot;
          s[g][p] = r < valid ? s[g][p] * scale : -1e30f;
          mx = fmaxf(mx, s[g][p]);
        }
#pragma unroll
        for (int o = LPK; o < 32; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[g], mx);
        const float alpha = expf(m[g] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int p = 0; p < PASSES; ++p) {
          const int r = rb + p * RG + warp * KPW + slot;
          s[g][p] = r < valid ? expf(s[g][p] - m_new) : 0.f;
          sum += s[g][p];
        }
#pragma unroll
        for (int o = LPK; o < 32; o <<= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        l[g] = l[g] * alpha + sum;
        m[g] = m_new;
#pragma unroll
        for (int j = 0; j < PAIRS; ++j) {
          acc[g][j][0] *= alpha;
          acc[g][j][1] *= alpha;
        }
      }

      // acc += P.V over the warp's rows; p comes from the scoring lane
#pragma unroll
      for (int p = 0; p < PASSES; ++p) {
#pragma unroll
        for (int kk = 0; kk < KPW; ++kk) {
          const int r = rb + p * RG + warp * KPW + kk;
          if (r < valid) {   // the same for every lane of the warp
            float pv[GM];
#pragma unroll
            for (int g = 0; g < GM; ++g)
              pv[g] = __shfl_sync(0xffffffffu, s[g][p], kk * LPK);
#pragma unroll
            for (int j = 0; j < PAIRS; ++j) {
              const int d = 2 * lane + 64 * j;
              if (d < hd) {
                const float2 vv = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(vt + (size_t)r * hd + d));
#pragma unroll
                for (int g = 0; g < GM; ++g) {
                  acc[g][j][0] = fmaf(pv[g], vv.x, acc[g][j][0]);
                  acc[g][j][1] = fmaf(pv[g], vv.y, acc[g][j][1]);
                }
              }
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // the warps' partials, merged in warp order into this rank's
  float* pw = part + warp * pf;          // acc (GM, hd), m (GM,), l (GM,)
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int j = 0; j < PAIRS; ++j) {
      const int d = 2 * lane + 64 * j;
      if (d < hd) {
        pw[g * hd + d] = acc[g][j][0];
        pw[g * hd + d + 1] = acc[g][j][1];
      }
    }
    if (lane == 0) {
      pw[GM * hd + g] = m[g];
      pw[GM * hd + GM + g] = l[g];
    }
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  float* mine = cluster.map_shared_rank(slots, 0) + rank * pf;
  for (int o = tid; o < rows_q * hd; o += kThreads) {
    const int g = o / hd;
    float mw = -1e30f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mw = fmaxf(mw, part[w * pf + GM * hd + g]);
    float a = 0.f, lw = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(part[w * pf + GM * hd + g] - mw);
      a = fmaf(c, part[w * pf + o], a);
      lw = fmaf(c, part[w * pf + GM * hd + GM + g], lw);
    }
    mine[o] = a;
    if (o - g * hd == 0) {
      mine[GM * hd + g] = mw;
      mine[GM * hd + GM + g] = lw;
    }
  }
  cluster.sync();   // every rank's partial is in rank 0's slots

  if (rank == 0) {
    for (int o = tid; o < rows_q * hd; o += kThreads) {
      const int g = o / hd;
      float mx = -1e30f;
#pragma unroll
      for (int r = 0; r < kRanks; ++r) mx = fmaxf(mx, slots[r * pf + GM * hd + g]);
      float a = 0.f, lr = 0.f;
#pragma unroll
      for (int r = 0; r < kRanks; ++r) {
        const float c = expf(slots[r * pf + GM * hd + g] - mx);
        a = fmaf(c, slots[r * pf + o], a);
        lr = fmaf(c, slots[r * pf + GM * hd + GM + g], lr);
      }
      o_b[o] = __float2bfloat16(a / fmaxf(lr, 1e-20f));
    }
  }
}

}  // namespace decode_attn
