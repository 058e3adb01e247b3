// Fused filtered group-by sums over stacked segments, for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_filtered_groupby_sums` in
// pinot_tpu/engine/pallas_kernels.py (the function at line 95, whose
// pl.pallas_call is at line 271).  Per segment s of S, per row i below
// num_docs[s]:
//
//   mask      = filter(s, i)            interval on a dictId column,
//                                       a bool match table over dictIds,
//                                       or an interval on the row index
//                                       (docrange: no column read)
//   key       = the precombined int32 group key, or the mixed radix
//               ((g0*c1 + g1)*c2 + g2)... of up to four group columns,
//               each a global-id stream or a local fwd stream through a
//               per-segment remap table, combined in registers
//   v_j       = dict_j[s][fwd_j[s,i]]   or the raw float row
//   num_docs  = sum mask                                    (int64)
//   count[k]  = sum mask * [key == k]                       (int64)
//   sums[j,k] = sum mask * v_j * [key == k]                 (float or double)
//
// Keys outside [0, K) drop.  With S == 1 and precombined keys this is
// exactly the TPU kernel.
//
// Zone-map blocks: with a block table (block_ids [S, nb_pad], ids of
// `block`-row zone blocks, -1 padded) only the rows of those blocks count.
// Each candidate block is scanned as a segment of its own: the grid's y
// axis runs over the S x nb_pad table entries, an entry reads its
// segment's tables and the block's rows (a padded entry reads none), and
// row bounds stay the segment's (num_docs, the doc interval).  So the grid
// covers only the candidate rows, no other row is loaded, the scan loop is
// the full scan's, and the partials keep their fixed order (entry-major).
// A runtime branch on a null table: no template is added.
//
// Member axis (cross-query batching, engine/dispatch.py): one launch can
// serve `members` queries of one plan that differ only in their literals.
// The row streams and dictionaries are shared; each member has its own
// filter bounds or match table and group remap tables (a member stride of
// 0 shares one), its own int64 accumulator, ticket, per-block partials and
// outputs.  The member is the innermost index of grid.x, so the members'
// blocks over one row range are scheduled together and the first to read
// a range from device memory leaves it in L2 for the others.  Each block
// runs the one-member code with the one-member grid partition, so member
// m's outputs are bit-identical to a launch of member m alone.
//
// Bound on the card: memory.  Q1 reads per row two uint8 group ids and
// three float32 raws (14 B) and does about a dozen integer and float
// operations, far below the card's compute rate, so the least time is
// bytes / 3.35 TB/s.  What the design does about it:
//   * one pass, one launch: each row's bytes are read once; rows outside
//     [0, num_docs) and, for docrange, outside the doc interval are never
//     read; the last block to finish reduces the per-block partials;
//   * the group key is combined from the group columns' own narrow
//     streams in registers (no int32 key materialised in device memory);
//   * loads are vectors: each lane owns slabs of 4 consecutive rows, so a
//     4-byte stream is read with one 16-byte load per slab (8 B for int16,
//     4 B for uint8, 2 x 16 B for double), and every warp load instruction
//     covers one contiguous span; a lane takes 4 slabs (16 rows) per
//     iteration, so 4 loads per stream are in flight before first use, and
//     the filter's loads are issued with the key's, before either is
//     decoded.  The tiers that stream the main path are compiled for 4
//     resident blocks per SM (64 registers a thread): more resident warps
//     keep more loads in flight, which measured faster on the card than
//     deeper unrolling, register prefetch of the next streams, or staging
//     the streams through shared memory with cp.async (PERF.md).
//     Each segment's unaligned head and tail rows (and everything when a
//     pointer is not 16-byte aligned or n_pad % 4 != 0) take a scalar loop;
//   * dictionaries, remap tables and the match table sit in shared memory;
//   * accumulation is chosen by the shape (the tier, picked by the wrapper):
//       private      counts and sums per thread in shared memory laid out
//                    [slot][thread] (no bank conflicts, no atomics, no warp
//                    collectives), summed over the block by a fixed tree;
//       atomic       count-only: int32 shared-memory atomics (integer adds
//                    commute, so no ordering is needed);
//       warp         larger K with sums: per-warp accumulators fed through
//                    __match_any_sync groups, the group leader adding its
//                    peers in lane order;
//   * integer totals go to a per-stream int64 accumulator by atomics
//     (exact, order-free); float sums are per-block partials that the last
//     block (atomic ticket after __threadfence) sums by a fixed tree.
//     There are no float atomics anywhere: per thread in row order, a
//     fixed tree within the block, a fixed partition of the blocks, so a
//     launch's result is bit-identical to the next one's at the same grid.
// The TPU version's chunked lane-shuffle gather and one-hot MXU contraction
// exist only because the TPU has no cheap gather; neither is carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNvMax = 8;
constexpr int kGroupMax = 4;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlab = 4;                 // rows per lane per slab
constexpr int kSlabs = 4;                // slabs per lane per iteration
constexpr int kRows = kSlab * kSlabs;    // rows per lane per iteration
constexpr int kSlabStride = 32 * kSlab;  // rows between a lane's slabs
constexpr int kChunk = 32 * kRows;       // rows per warp per iteration

enum FilterKind { kInterval = 0, kDocrange = 1, kTable = 2 };
enum Code { kU8 = 0, kI16 = 1, kI32 = 2, kRaw = 3 };
enum Tier { kPrivate = 0, kAtomic = 1, kWarp = 2 };

// resident blocks per SM each tier is compiled for (launch bounds): a
// thread may use 65536 / (256 * this) registers.  Four (64 registers) was
// the fastest of two to five for the private and atomic tiers at the main
// path's shapes on the card (PERF.md): the loads that more resident warps
// keep in flight outweigh the registers each thread loses.
template <int TIER> struct MinBlocks { static constexpr int value = 2; };
template <> struct MinBlocks<kPrivate> { static constexpr int value = 4; };
template <> struct MinBlocks<kAtomic> { static constexpr int value = 4; };

struct Params {
  const void* filter_fwd;   // [S, n_pad] F (interval, table)
  const int32_t* bounds;    // [members][S, 2] (interval: dictIds, docrange: rows)
  const uint8_t* match;     // [members][S, match_card] (table)
  int match_card;
  int members;              // queries served by the launch (grid.x = blocks_per_seg * members)
  long long bounds_mstride; // elements between two members' bounds (0: shared)
  long long match_mstride;  // bytes between two members' match tables (0: shared)
  const int32_t* num_docs;  // [S]
  long long n_pad;
  const int32_t* keys;      // [S, n_pad] precombined keys, or null (ng > 0)
  int ng;
  const void* gptr[kGroupMax];      // [S, n_pad] group id streams
  int gcode[kGroupMax];
  int gcard[kGroupMax];             // radices
  const int32_t* gremap[kGroupMax]; // [members][S, gremap_card] or null
  int gremap_card[kGroupMax];
  long long gremap_mstride[kGroupMax]; // elements between two members' remaps (0: shared)
  int goff[kGroupMax];              // offset of column c's remap in shared memory
  int remap_total;
  int K;
  int nv;
  const void* vptr[kNvMax];  // [S, n_pad] fwd or raw rows
  int vcode[kNvMax];
  const void* dptr[kNvMax];  // [S, dcard] dictionary values
  int dcard[kNvMax];
  int doff[kNvMax];          // offset of column j's dictionary in shared memory
  int dict_total;
  const int32_t* block_ids;  // [S, nb_pad] candidate zone blocks, or null
  int nb_pad;
  long long block;           // rows per zone block
  int blocks_per_seg;
  int vec_ok;
  void* part_sums;                 // [members][blocks, nv, K]
  unsigned long long* acc;         // [members][K + 1] zero between launches
  unsigned int* ticket;            // [members] zero between launches
  long long* out_docs;             // [members]
  long long* out_counts;           // [members][K]
  void* out_sums;                  // [members][nv, K]
};

template <typename T>
struct Smem {
  T* dict;
  T* sum;    // private: [nv*K][threads]; warp: [warps][nv][K]
  T* lane;   // warp: [warps][kRows][32]
  int* remap;
  int* cnt;  // private: [K][threads]; else [K]
  int* misc; // docs, last-block flag
  uint8_t* match;
};

// The layout shared_bytes() in engine/kernels/fused_groupby.py counts.
template <typename T, int TIER>
__device__ Smem<T> carve(const Params& p, unsigned char* base) {
  Smem<T> m;
  T* f = reinterpret_cast<T*>(base);
  m.dict = f;
  f += p.dict_total;
  m.sum = f;
  m.lane = nullptr;
  if (TIER == kPrivate) {
    f += (long long)p.nv * p.K * kThreads;
  } else if (TIER == kWarp) {
    f += (long long)kWarps * p.nv * p.K;
    m.lane = f;
    f += kWarps * kRows * 32;
  }
  int* i = reinterpret_cast<int*>(f);
  m.remap = i;
  i += p.remap_total;
  m.cnt = i;
  i += TIER == kPrivate ? p.K * kThreads : p.K;
  m.misc = i;
  i += 2;
  m.match = reinterpret_cast<uint8_t*>(i);
  return m;
}

// ---- loads: 4 consecutive rows starting at row r (r % 4 == 0, aligned)

__device__ __forceinline__ void load4(const uint8_t* p, long long r, int* out) {
  const unsigned w = __ldg(reinterpret_cast<const unsigned int*>(p + r));
  out[0] = w & 0xff;
  out[1] = (w >> 8) & 0xff;
  out[2] = (w >> 16) & 0xff;
  out[3] = w >> 24;
}
__device__ __forceinline__ void load4(const int16_t* p, long long r, int* out) {
  const uint2 w = __ldg(reinterpret_cast<const uint2*>(p + r));
  out[0] = static_cast<int16_t>(w.x & 0xffff);
  out[1] = static_cast<int16_t>(w.x >> 16);
  out[2] = static_cast<int16_t>(w.y & 0xffff);
  out[3] = static_cast<int16_t>(w.y >> 16);
}
__device__ __forceinline__ void load4(const int32_t* p, long long r, int* out) {
  const int4 w = __ldg(reinterpret_cast<const int4*>(p + r));
  out[0] = w.x;
  out[1] = w.y;
  out[2] = w.z;
  out[3] = w.w;
}
__device__ __forceinline__ void load4(const float* p, long long r, float* out) {
  const float4 w = __ldg(reinterpret_cast<const float4*>(p + r));
  out[0] = w.x;
  out[1] = w.y;
  out[2] = w.z;
  out[3] = w.w;
}
__device__ __forceinline__ void load4(const double* p, long long r, double* out) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p + r));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p + r + 2));
  out[0] = a.x;
  out[1] = a.y;
  out[2] = b.x;
  out[3] = b.y;
}

__device__ __forceinline__ void load4_index(const void* p, int code, long long r, int* out) {
  switch (code) {
    case kU8: load4(static_cast<const uint8_t*>(p), r, out); break;
    case kI16: load4(static_cast<const int16_t*>(p), r, out); break;
    default: load4(static_cast<const int32_t*>(p), r, out); break;
  }
}

__device__ __forceinline__ int load1_index(const void* p, int code, long long r) {
  switch (code) {
    case kU8: return static_cast<const uint8_t*>(p)[r];
    case kI16: return static_cast<const int16_t*>(p)[r];
    default: return static_cast<const int32_t*>(p)[r];
  }
}

template <typename T>
__device__ __forceinline__ T warp_tree(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// ---- accumulation of N rows per lane (N = kRows in the body, 1 in the
// scalar head/tail).  Bit e of ok: row e hit the filter and has a key in
// [0, K).  load_vals(j, v) fills v with value column j's N rows.
template <typename T, int TIER, int N, typename LoadVals>
__device__ __forceinline__ void accumulate(const Params& p, const Smem<T>& sm, const int (&key)[N],
                                           unsigned ok, LoadVals load_vals) {
  const int lane = threadIdx.x & 31;
  if (TIER == kPrivate) {
    int* cnt = sm.cnt + threadIdx.x;
#pragma unroll
    for (int e = 0; e < N; ++e)
      if (ok >> e & 1) cnt[key[e] * kThreads] += 1;
    for (int j = 0; j < p.nv; ++j) {
      T v[N];
      load_vals(j, v);
      T* s = sm.sum + (long long)j * p.K * kThreads + threadIdx.x;
#pragma unroll
      for (int e = 0; e < N; ++e)
        if (ok >> e & 1) s[key[e] * kThreads] += v[e];
    }
  } else if (TIER == kAtomic) {
#pragma unroll
    for (int e = 0; e < N; ++e)
      if (ok >> e & 1) atomicAdd(&sm.cnt[key[e]], 1);
  } else {  // kWarp: each key's group of lanes, its leader adding the peers
    const int warp = threadIdx.x >> 5;
    unsigned peers[N];
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int k = (ok >> e & 1) ? key[e] : -1;
      const unsigned m = __match_any_sync(0xffffffffu, k);
      const bool lead = k >= 0 && lane == __ffs(m) - 1;
      if (lead) atomicAdd(&sm.cnt[k], __popc(m));
      peers[e] = lead ? m : 0u;  // nonzero only on each group's leader
    }
    T* lb = sm.lane + warp * kRows * 32;
    for (int j = 0; j < p.nv; ++j) {
      T v[N];
      load_vals(j, v);
#pragma unroll
      for (int e = 0; e < N; ++e) lb[e * 32 + lane] = v[e];
      __syncwarp();
      T* ws = sm.sum + ((long long)warp * p.nv + j) * p.K;
#pragma unroll
      for (int e = 0; e < N; ++e) {
        if (peers[e]) {
          T a = T(0);
          unsigned m = peers[e];
          while (m) {
            const int l = __ffs(m) - 1;
            m &= m - 1;
            a += lb[e * 32 + l];
          }
          ws[key[e]] += a;
        }
        __syncwarp();  // row e's leaders add before row e+1's: a fixed order
      }
    }
  }
}

template <typename T, typename F, int MODE, int TIER>
__global__ void __launch_bounds__(kThreads, MinBlocks<TIER>::value)
fused_groupby(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem<T> sm = carve<T, TIER>(p, smem);
  const int v = blockIdx.y;  // the segment, or with a block table one of its entries
  const int s = p.block_ids == nullptr ? v : v / p.nb_pad;
  const int m = blockIdx.x % p.members;  // the member, innermost
  const int b = blockIdx.x / p.members;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int K = p.K;
  const int nv = p.nv;

  const int ncnt = TIER == kPrivate ? K * kThreads : K;
  for (int i = tid; i < ncnt; i += kThreads) sm.cnt[i] = 0;
  if (TIER == kPrivate)
    for (int i = tid; i < nv * K * kThreads; i += kThreads) sm.sum[i] = T(0);
  if (TIER == kWarp)
    for (int i = tid; i < kWarps * nv * K; i += kThreads) sm.sum[i] = T(0);
  if (tid < 2) sm.misc[tid] = 0;
  for (int j = 0; j < nv; ++j) {
    if (p.vcode[j] == kRaw) continue;
    const T* d = static_cast<const T*>(p.dptr[j]) + (long long)s * p.dcard[j];
    for (int i = tid; i < p.dcard[j]; i += kThreads) sm.dict[p.doff[j] + i] = d[i];
  }
  for (int c = 0; c < p.ng; ++c) {
    if (p.gremap[c] == nullptr) continue;
    const int32_t* r = p.gremap[c] + m * p.gremap_mstride[c] + (long long)s * p.gremap_card[c];
    for (int i = tid; i < p.gremap_card[c]; i += kThreads) sm.remap[p.goff[c] + i] = r[i];
  }
  if (MODE == kTable) {
    const uint8_t* mt = p.match + m * p.match_mstride + (long long)s * p.match_card;
    for (int i = tid; i < p.match_card; i += kThreads) sm.match[i] = mt[i];
  }
  __syncthreads();

  const long long n_pad = p.n_pad;
  // rows [base, base + span) of the segment: all of it, or one zone block
  long long base = 0, span = n_pad;
  if (p.block_ids != nullptr) {
    const long long id = p.block_ids[v];
    base = id < 0 ? 0 : id * p.block;
    span = id < 0 ? 0 : p.block;
  }
  // [lo, hi) relative to base
  long long lo = 0;
  long long hi = min((long long)p.num_docs[s] - base, span);
  int flo = 0, fhi = 0;
  if (MODE == kDocrange) {
    const int32_t* bd = p.bounds + m * p.bounds_mstride;
    lo = max(lo, (long long)bd[2 * s] - base);
    hi = min(hi, (long long)bd[2 * s + 1] - base);
  } else if (MODE == kInterval) {
    const int32_t* bd = p.bounds + m * p.bounds_mstride;
    flo = bd[2 * s];
    fhi = bd[2 * s + 1];
  }
  if (hi < lo) hi = lo;
  // [lo, a) head and [bb, hi) tail: scalar; [a, bb): 4-row slabs
  long long a = hi, bb = hi;
  if (p.vec_ok) {
    a = min((lo + kSlab - 1) & ~(long long)(kSlab - 1), hi);
    bb = max(a, hi & ~(long long)(kSlab - 1));
  }
  const long long off = (long long)s * n_pad + base;
  const int gw = b * kWarps + warp;
  const int nw = p.blocks_per_seg * kWarps;
  const F* fcol = static_cast<const F*>(p.filter_fwd) + off;
  int my_docs = 0;

  auto pass = [&](int f) -> bool {
    if (MODE == kInterval) return f >= flo && f < fhi;
    return f >= 0 && f < p.match_card && sm.match[f] != 0;
  };

  for (long long c0 = a + (long long)gw * kChunk; c0 < bb; c0 += (long long)nw * kChunk) {
    const long long r0 = off + c0 + lane * kSlab;  // slab q starts at r0 + q * kSlabStride
    unsigned sok = 0;
#pragma unroll
    for (int q = 0; q < kSlabs; ++q)
      if (c0 + lane * kSlab + q * kSlabStride < bb) sok |= 1u << q;

    // the filter's raw words are loaded first and decoded after the key
    // loads are issued, so both streams are in flight together
    constexpr int kFW = kSlabs * sizeof(F);  // words per lane per chunk
    unsigned fw[kFW];
    if (MODE != kDocrange) {
      const unsigned char* fp = static_cast<const unsigned char*>(p.filter_fwd);
#pragma unroll
      for (int q = 0; q < kSlabs; ++q) {
        const unsigned char* src = fp + (r0 + q * kSlabStride) * sizeof(F);
        const bool in = sok >> q & 1;
        if constexpr (sizeof(F) == 1) {
          fw[q] = in ? __ldg(reinterpret_cast<const unsigned*>(src)) : 0u;
        } else if constexpr (sizeof(F) == 2) {
          const uint2 w = in ? __ldg(reinterpret_cast<const uint2*>(src)) : make_uint2(0, 0);
          fw[2 * q] = w.x;
          fw[2 * q + 1] = w.y;
        } else {
          const uint4 w = in ? __ldg(reinterpret_cast<const uint4*>(src)) : make_uint4(0, 0, 0, 0);
          fw[4 * q] = w.x;
          fw[4 * q + 1] = w.y;
          fw[4 * q + 2] = w.z;
          fw[4 * q + 3] = w.w;
        }
      }
    }

    int key[kRows];
    unsigned bad = 0;
    if (p.ng == 0) {
#pragma unroll
      for (int q = 0; q < kSlabs; ++q) {
        if (sok >> q & 1) {
          load4(p.keys, r0 + q * kSlabStride, &key[q * kSlab]);
        } else {
#pragma unroll
          for (int e = 0; e < kSlab; ++e) key[q * kSlab + e] = -1;
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < kRows; ++e) key[e] = 0;
      for (int c = 0; c < p.ng; ++c) {
        int g[kRows];
#pragma unroll
        for (int q = 0; q < kSlabs; ++q) {
          if (sok >> q & 1) {
            load4_index(p.gptr[c], p.gcode[c], r0 + q * kSlabStride, &g[q * kSlab]);
          } else {
#pragma unroll
            for (int e = 0; e < kSlab; ++e) g[q * kSlab + e] = 0;
          }
        }
        if (p.gremap[c] != nullptr) {
          const int* rm = sm.remap + p.goff[c];
          const unsigned rc = p.gremap_card[c];
#pragma unroll
          for (int e = 0; e < kRows; ++e) {
            if (static_cast<unsigned>(g[e]) < rc) g[e] = rm[g[e]];
            else bad |= 1u << e;
          }
        }
        const unsigned card = p.gcard[c];
#pragma unroll
        for (int e = 0; e < kRows; ++e)
          key[e] = static_cast<int>(static_cast<unsigned>(key[e]) * card + static_cast<unsigned>(g[e]));
      }
    }

    unsigned hit = 0;
    if (MODE == kDocrange) {
#pragma unroll
      for (int q = 0; q < kSlabs; ++q)
        if (sok >> q & 1) hit |= 0xfu << (q * kSlab);
    } else {
#pragma unroll
      for (int e = 0; e < kRows; ++e) {
        int f;
        if constexpr (sizeof(F) == 1) f = (fw[e / 4] >> (8 * (e % 4))) & 0xff;
        else if constexpr (sizeof(F) == 2) f = static_cast<int16_t>((fw[e / 2] >> (16 * (e % 2))) & 0xffff);
        else f = static_cast<int>(fw[e]);
        if ((sok >> (e / kSlab) & 1) && pass(f)) hit |= 1u << e;
      }
    }
    unsigned ok = hit & ~bad;
#pragma unroll
    for (int e = 0; e < kRows; ++e)
      if (key[e] < 0 || key[e] >= K) ok &= ~(1u << e);  // out-of-range keys drop
    my_docs += __popc(hit);

    accumulate<T, TIER, kRows>(p, sm, key, ok, [&](int j, T (&v)[kRows]) {
      const int code = p.vcode[j];
      if (code == kRaw) {
        const T* vp = static_cast<const T*>(p.vptr[j]);
#pragma unroll
        for (int q = 0; q < kSlabs; ++q) {
          if (sok >> q & 1) {
            load4(vp, r0 + q * kSlabStride, &v[q * kSlab]);
          } else {
#pragma unroll
            for (int e = 0; e < kSlab; ++e) v[q * kSlab + e] = T(0);
          }
        }
      } else {
        int f[kRows];
#pragma unroll
        for (int q = 0; q < kSlabs; ++q) {
          if (sok >> q & 1) {
            load4_index(p.vptr[j], code, r0 + q * kSlabStride, &f[q * kSlab]);
          } else {
#pragma unroll
            for (int e = 0; e < kSlab; ++e) f[q * kSlab + e] = 0;
          }
        }
        const T* d = sm.dict + p.doff[j];
        const unsigned dc = p.dcard[j];
#pragma unroll
        for (int e = 0; e < kRows; ++e) v[e] = static_cast<unsigned>(f[e]) < dc ? d[f[e]] : T(0);
      }
    });
  }

  // ---- head and tail rows: one row per lane; the loop bound depends on
  // the warp only, so the warp-collective calls in accumulate are converged
  auto scalar_rows = [&](long long r_lo, long long r_hi) {
    for (long long base = r_lo + (long long)gw * 32; base < r_hi; base += (long long)nw * 32) {
      const long long i = base + lane;
      const bool in = i < r_hi;
      bool hit = in;
      if (MODE != kDocrange && in) hit = pass(static_cast<int>(fcol[i]));
      int key[1] = {-1};
      bool kok = in;
      if (in) {
        if (p.ng == 0) {
          key[0] = p.keys[off + i];
        } else {
          unsigned k = 0;
          for (int c = 0; c < p.ng; ++c) {
            int g = load1_index(p.gptr[c], p.gcode[c], off + i);
            if (p.gremap[c] != nullptr) {
              if (static_cast<unsigned>(g) < static_cast<unsigned>(p.gremap_card[c]))
                g = sm.remap[p.goff[c] + g];
              else
                kok = false;
            }
            k = k * static_cast<unsigned>(p.gcard[c]) + static_cast<unsigned>(g);
          }
          key[0] = static_cast<int>(k);
        }
      }
      const unsigned ok = (hit && kok && key[0] >= 0 && key[0] < K) ? 1u : 0u;
      my_docs += hit ? 1 : 0;
      accumulate<T, TIER, 1>(p, sm, key, ok, [&](int j, T (&v)[1]) {
        v[0] = T(0);
        if (!in) return;
        const int code = p.vcode[j];
        if (code == kRaw) {
          v[0] = static_cast<const T*>(p.vptr[j])[off + i];
        } else {
          const int f = load1_index(p.vptr[j], code, off + i);
          if (static_cast<unsigned>(f) < static_cast<unsigned>(p.dcard[j])) v[0] = sm.dict[p.doff[j] + f];
        }
      });
    }
  };
  scalar_rows(lo, a);
  scalar_rows(bb, hi);

  // ---- block totals: integers to the int64 accumulator by atomics, float
  // sums to this block's partials by a fixed tree
  my_docs = __reduce_add_sync(0xffffffffu, my_docs);
  if (lane == 0) atomicAdd(&sm.misc[0], my_docs);
  __syncthreads();
  // this member's accumulator, ticket, partials and outputs
  unsigned long long* acc = p.acc + (long long)m * (K + 1);
  if (tid == 0 && sm.misc[0]) atomicAdd(acc + K, static_cast<unsigned long long>(sm.misc[0]));
  const int B = p.blocks_per_seg * gridDim.y;  // blocks of one member
  const long long gb = (long long)v * p.blocks_per_seg + b;
  const int C = nv * K;
  T* const parts_m = static_cast<T*>(p.part_sums) + (long long)m * B * C;
  T* psum = parts_m + gb * C;
  if (TIER == kPrivate) {
    for (int kk = warp; kk < K; kk += kWarps) {
      int c = 0;
      for (int t = lane; t < kThreads; t += 32) c += sm.cnt[kk * kThreads + t];
      c = __reduce_add_sync(0xffffffffu, c);
      if (lane == 0 && c) atomicAdd(acc + kk, static_cast<unsigned long long>(c));
    }
    for (int idx = warp; idx < C; idx += kWarps) {
      T v = T(0);
      for (int t = lane; t < kThreads; t += 32) v += sm.sum[(long long)idx * kThreads + t];
      v = warp_tree(v);
      if (lane == 0) psum[idx] = v;
    }
  } else {
    for (int kk = tid; kk < K; kk += kThreads) {
      const int c = sm.cnt[kk];
      if (c) atomicAdd(acc + kk, static_cast<unsigned long long>(c));
    }
    if (TIER == kWarp) {
      for (int idx = tid; idx < C; idx += kThreads) {
        T v = T(0);
        for (int w = 0; w < kWarps; ++w) v += sm.sum[w * C + idx];
        psum[idx] = v;
      }
    }
  }

  // ---- the last block to finish writes the outputs
  __threadfence();
  __syncthreads();
  if (tid == 0) sm.misc[1] = atomicAdd(p.ticket + m, 1u) == static_cast<unsigned>(B - 1);
  __syncthreads();
  if (!sm.misc[1]) return;
  __threadfence();
  for (int kk = tid; kk <= K; kk += kThreads) {
    const unsigned long long v = atomicExch(acc + kk, 0ull);  // read and re-zero
    if (kk < K) p.out_counts[(long long)m * K + kk] = static_cast<long long>(v);
    else p.out_docs[m] = static_cast<long long>(v);
  }
  const T* parts = parts_m;
  T* out = static_cast<T*>(p.out_sums) + (long long)m * C;
  if (C < kThreads) {
    // one warp per output: lane l sums a fixed contiguous range of blocks,
    // then a fixed shuffle tree
    for (int col = warp; col < C; col += kWarps) {
      const int b0 = static_cast<int>((long long)B * lane / 32);
      const int b1 = static_cast<int>((long long)B * (lane + 1) / 32);
      T v = T(0);
      for (int blk = b0; blk < b1; ++blk) v += __ldcg(parts + (long long)blk * C + col);
      v = warp_tree(v);
      if (lane == 0) out[col] = v;
    }
  } else {
    // one thread per output, blocks in block order (coalesced over outputs)
    for (int col = tid; col < C; col += kThreads) {
      T v = T(0);
      for (int blk = 0; blk < B; ++blk) v += __ldcg(parts + (long long)blk * C + col);
      out[col] = v;
    }
  }
  if (tid == 0) atomicExch(p.ticket + m, 0u);
}

typedef void (*KernelFn)(Params);

template <typename T, typename F, int MODE>
KernelFn pick_tier(int tier) {
  switch (tier) {
    case kPrivate: return fused_groupby<T, F, MODE, kPrivate>;
    case kAtomic: return fused_groupby<T, F, MODE, kAtomic>;
    case kWarp: return fused_groupby<T, F, MODE, kWarp>;
    default: return nullptr;
  }
}

template <typename T>
KernelFn pick_filter(int filter_kind, int filter_code, int tier) {
  if (filter_kind == kDocrange) return pick_tier<T, uint8_t, kDocrange>(tier);
  if (filter_kind == kInterval) {
    if (filter_code == kU8) return pick_tier<T, uint8_t, kInterval>(tier);
    if (filter_code == kI16) return pick_tier<T, int16_t, kInterval>(tier);
    return pick_tier<T, int32_t, kInterval>(tier);
  }
  if (filter_code == kU8) return pick_tier<T, uint8_t, kTable>(tier);
  if (filter_code == kI16) return pick_tier<T, int16_t, kTable>(tier);
  return pick_tier<T, int32_t, kTable>(tier);
}

KernelFn pick(int float_code, int filter_kind, int filter_code, int tier) {
  if (filter_kind < kInterval || filter_kind > kTable || filter_code < kU8 || filter_code > kI32)
    return nullptr;
  return float_code == 1 ? pick_filter<double>(filter_kind, filter_code, tier)
                         : pick_filter<float>(filter_kind, filter_code, tier);
}

cudaError_t prepare(KernelFn fn, long long smem_bytes) {
  int dev = 0, smem_limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem_bytes < 0 || smem_bytes > smem_limit) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes));
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

extern "C" {

// Resident blocks per SM of the kernel for these template arguments and
// this dynamic shared memory (the wrapper sizes a one-wave grid from it);
// -1 for arguments the kernel does not take, else minus a cudaError_t.
int fused_groupby_blocks_per_sm(int float_code, int filter_kind, int filter_code, int tier,
                                long long smem_bytes) {
  KernelFn fn = pick(float_code, filter_kind, filter_code, tier);
  if (fn == nullptr) return -1;
  cudaError_t err = prepare(fn, smem_bytes);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kThreads,
                                                        static_cast<size_t>(smem_bytes));
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Returns 0 on success, a cudaError_t code on a launch failure, or -1 for
// arguments the kernel does not take.  smem_bytes is the dynamic shared
// memory of one block, computed by the caller (shared_bytes in
// engine/kernels/fused_groupby.py) in the layout carve() makes.  acc
// ([members][K + 1] int64) and ticket ([members]) must be zero; the launch
// leaves them zero.  The outputs and part_sums lead with the member axis;
// bounds, match and each remap table are a member's own at member m times
// its stride (0: one shared by every member).
int fused_groupby_launch(int float_code, int filter_kind, int filter_code, int tier,
                         int members, long long bounds_mstride, long long match_mstride,
                         const long long* remap_mstrides,
                         const void* filter_fwd, const int32_t* bounds,
                         const uint8_t* match, int match_card, const int32_t* num_docs,
                         int S, long long n_pad, const int32_t* keys, int ng,
                         const void* const* group_ptrs, const int* group_codes,
                         const int* group_cards, const void* const* remap_ptrs,
                         const int* remap_cards, int K, int nv,
                         const void* const* value_ptrs, const int* value_codes,
                         const void* const* dict_ptrs, const int* dict_cards,
                         const int32_t* block_ids, int nb_pad, long long block_rows,
                         int blocks_per_seg, void* part_sums, unsigned long long* acc,
                         unsigned int* ticket, long long* out_docs, long long* out_counts,
                         void* out_sums, long long smem_bytes, void* stream) {
  if (nv < 0 || nv > kNvMax || ng < 0 || ng > kGroupMax || K < 1 || S < 1 || members < 1 ||
      blocks_per_seg < 1 || (long long)blocks_per_seg * members > 2147483647LL ||
      (ng == 0) == (keys == nullptr) ||
      (block_ids != nullptr && (nb_pad < 1 || block_rows < 1 || n_pad % block_rows != 0 ||
                                (long long)S * nb_pad > 65535)))
    return -1;
  KernelFn fn = pick(float_code, filter_kind, filter_code, tier);
  if (fn == nullptr) return -1;
  Params p;
  p.filter_fwd = filter_fwd;
  p.bounds = bounds;
  p.match = match;
  p.match_card = match_card;
  p.members = members;
  p.bounds_mstride = bounds_mstride;
  p.match_mstride = match_mstride;
  p.num_docs = num_docs;
  p.n_pad = n_pad;
  p.keys = keys;
  p.ng = ng;
  // the 4-row slabs need every row stream 16-byte aligned, and n_pad % 4 ==
  // 0 (and a zone block's rows % 4 == 0)
  bool vec = n_pad % kSlab == 0 && (block_ids == nullptr || block_rows % kSlab == 0) &&
             aligned16(filter_fwd) && aligned16(keys);
  int roff = 0;
  for (int c = 0; c < kGroupMax; ++c) {
    const bool used = c < ng;
    p.gptr[c] = used ? group_ptrs[c] : nullptr;
    p.gcode[c] = used ? group_codes[c] : kI32;
    p.gcard[c] = used ? group_cards[c] : 1;
    p.gremap[c] = used ? static_cast<const int32_t*>(remap_ptrs[c]) : nullptr;
    p.gremap_card[c] = used && remap_ptrs[c] != nullptr ? remap_cards[c] : 0;
    p.gremap_mstride[c] = used ? remap_mstrides[c] : 0;
    p.goff[c] = roff;
    roff += p.gremap_card[c];
    if (used) vec = vec && aligned16(p.gptr[c]);
  }
  p.remap_total = roff;
  p.K = K;
  p.nv = nv;
  int off = 0;
  for (int j = 0; j < kNvMax; ++j) {
    const bool used = j < nv;
    p.vptr[j] = used ? value_ptrs[j] : nullptr;
    p.vcode[j] = used ? value_codes[j] : kRaw;
    p.dptr[j] = used ? dict_ptrs[j] : nullptr;
    p.dcard[j] = used && value_codes[j] != kRaw ? dict_cards[j] : 0;
    p.doff[j] = off;
    off += p.dcard[j];
    if (used) vec = vec && aligned16(p.vptr[j]);
  }
  p.dict_total = off;
  p.block_ids = block_ids;
  p.nb_pad = block_ids != nullptr ? nb_pad : 0;
  p.block = block_rows;
  p.blocks_per_seg = blocks_per_seg;
  p.vec_ok = vec ? 1 : 0;
  p.part_sums = part_sums;
  p.acc = acc;
  p.ticket = ticket;
  p.out_docs = out_docs;
  p.out_counts = out_counts;
  p.out_sums = out_sums;
  cudaError_t err = prepare(fn, smem_bytes);
  if (err == cudaErrorInvalidValue) return -1;
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(blocks_per_seg * members, block_ids != nullptr ? S * nb_pad : S);
  fn<<<grid, kThreads, static_cast<size_t>(smem_bytes), static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
