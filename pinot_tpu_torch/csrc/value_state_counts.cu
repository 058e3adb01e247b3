// Value-state holders (occupancy counts, presence bits, HLL registers) over
// stacked segments, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_value_state_counts_pallas` in
// pinot_tpu/engine/kernel.py (the function at line 130, whose
// pl.pallas_call is at line 170).  The TPU kernel counts a combined int32
// index that jnp ops built beforehand; this kernel builds the index itself
// from the streams the table kernel has staged.  Per segment s of S, per
// row i below num_docs[s] that passes the filter:
//
//   filter  = a dictId interval, a uint8 match table over dictIds, or an
//             interval on the row index (docrange; no filter at all is the
//             docrange [0, n_pad))
//   slot    = the mixed radix ((g0*c1 + g1)*c2 + g2)... of up to four group
//             columns, each a global-id stream or a local fwd stream read
//             through a per-segment remap table (0 with no group-by)
//   idx     = slot * width + v                      counts, presence
//             (slot * HLL_M + bucket) * 64 + rho    registers
//   where v is the value's global id (its stream, or its fwd through a
//   remap table) and (bucket, rho) come from the per-row uint8 streams or
//   from per-dictId tables through the fwd stream.
//
// Indexes outside [0, K) drop, exactly as the sentinel K drops in the TPU
// kernel, so each holder equals what the occupancy counts of the combined
// index give:
//   counts     int64 counts[K]                      (histograms)
//   presence   int32 [K], 1 where counts > 0        (distinct counts)
//   registers  uint8 [K / 64], the largest rho whose count is > 0 per
//              (slot, bucket) register              (HLL)
// plus the matched-doc total (filter & valid).  The precombined form (one
// int32 index stream, no filter, no group-by, width K) is the TPU kernel.
//
// Zone-map blocks: with a block table (block_ids [S, nb_pad], ids of
// `block`-row zone blocks, -1 padded) only those blocks' rows count, each
// candidate block scanned as a segment of its own, as in
// csrc/fused_groupby.cu: the grid covers only the candidate rows and no
// other row is loaded.  The table is a template flag (BLOCKS), so the
// full scan's code is the same as without one: a runtime branch on a null
// table slowed the registers-mode full scan by 6 % on the H100.  The
// source builds two libraries, -DBLOCK_TABLE=0 (full scans) and =1 (block
// tables), each with half the instantiations, compiled in parallel.
//
// Bound on the card: memory.  Each row costs its streams' bytes (1-4 B per
// stream; 2-5 B per row on the main path) and a handful of integer
// operations.  What the design does about it:
//   * the index is combined in registers from the narrow streams: no
//     int32 index, mask or key is materialised in device memory;
//   * K1's streaming (csrc/fused_groupby.cu): each lane owns 4 slabs of 4
//     consecutive rows per iteration, read with one vector load per slab,
//     and the kernel is compiled for 4 resident 256-thread blocks per SM;
//     rows past num_docs and outside a docrange are never read, and when a
//     lane's filter passes none of its 16 rows it reads nothing else;
//   * no warp collective per row in shared memory: each update is one
//     shared-memory operation (only the global counts tier matches equal
//     indexes across the warp, so that a hot bin in device memory takes
//     one int64 atomic per warp, not one per row), and the idempotent
//     holders need no atomic per row:
//       presence   a byte map, each row storing 1 to its byte; or a bitmap,
//                  where a row reads its word and issues atomicOr only
//                  when its bit is clear
//       registers  a byte map over (register, rho), each row storing 1 to
//                  its byte, the largest rho found when the block
//                  flushes; or int32 registers, atomicMax only when rho
//                  is larger
//     so once a block has seen a value, its later rows issue no atomic;
//     a dropped row updates the lane's own trash word in shared memory
//     instead (an address select, not a branch), and a lane's whole
//     chunks (every slab in range) load with no per-slab test;
//   * the holder's tier, picked by the wrapper from the mode and K:
//       byte    presence, registers: a byte per index in shared memory
//       block   one int32 histogram, bitmap or register file per block in
//               shared memory (a bitmap of 2^18 bits is 32 KB)
//       global  the holder in device memory (it stays in the 50 MB L2)
//     Shared holders are flushed once per block: int64 atomics on nonzero
//     bins, atomicOr on words and atomicMax on registers that add
//     something;
//   * lookup tables (remaps, HLL bucket and rho tables) sit in shared
//     memory when they are small, else are read from device memory;
//   * integer add, OR and max only: a launch's holders are the same on
//     every launch whatever the grid.
//
// Member axis (cross-query batching, engine/dispatch.py): one launch can
// serve `members` queries of one plan that differ only in their literals,
// as in csrc/fused_groupby.cu.  The row streams are shared; each member has
// its own filter bounds or match table and lookup tables (a member stride
// of 0 shares one) and its own matched-doc total and holder (one zeroed
// buffer of member_words int64 words each).  The member is the innermost
// index of grid.x, so the members' blocks over one row range run together
// and read it from L2 after the first; each block runs the one-member code
// and grid partition, and the holders are integer add / OR / max, so
// member m's holder equals a launch of member m alone.
// The TPU version's two generated one-hots contracted on the MXU exist only
// because the TPU has no scatter; neither is carried over.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kGroupMax = 4;
constexpr int kTables = kGroupMax + 2;  // group remaps, value table, rho table
constexpr int kValueTable = kGroupMax;
constexpr int kRhoTable = kGroupMax + 1;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlab = 4;                 // rows per lane per slab
constexpr int kSlabs = 4;                // slabs per lane per iteration
constexpr int kRows = kSlab * kSlabs;    // rows per lane per iteration
constexpr int kSlabStride = 32 * kSlab;  // rows between a lane's slabs
constexpr int kChunk = 32 * kRows;       // rows per warp per iteration
constexpr unsigned kHllM = 256;          // HLL registers per slot (engine/config.py HLL_M)
constexpr unsigned kRho = 64;            // rho lanes per register

enum FilterKind { kInterval = 0, kDocrange = 1, kTable = 2 };
enum Code { kU8 = 0, kI16 = 1, kI32 = 2 };
enum Mode { kCounts = 0, kPresence = 1, kRegisters = 2 };
enum Tier { kBlock = 0, kGlobal = 1, kByte = 2 };

struct Params {
  const void* filter_fwd;   // [S, n_pad] F (interval, table)
  const int32_t* bounds;    // [members][S, 2] (interval: dictIds, docrange: rows; null: no filter)
  const uint8_t* match;     // [members][S, match_card] (table)
  int match_card;
  int members;              // queries served by the launch (grid.x = blocks_per_seg * members)
  long long bounds_mstride; // elements between two members' bounds (0: shared)
  long long match_mstride;  // bytes between two members' match tables (0: shared)
  long long member_words;   // int64 words of one member's docs + holder buffer
  const int32_t* num_docs;  // [S], or null: every row is valid
  long long n_pad;
  int ng;
  const void* gptr[kGroupMax];  // [S, n_pad] group id streams
  int gcode[kGroupMax];
  unsigned gcard[kGroupMax];    // radices
  const void* vptr;             // [S, n_pad] value ids, HLL buckets or fwd
  int vcode;
  const uint8_t* rptr;          // [S, n_pad] HLL rho stream, or null
  const int32_t* tab[kTables];  // [members][S, tab_card] lookup tables, or null
  int tab_card[kTables];
  long long tab_mstride[kTables];  // elements between two members' tables (0: shared)
  int tab_off[kTables];         // offset in shared memory when tab_shared
  int tab_shared;
  int tab_total;
  unsigned width;               // values per slot (counts, presence)
  unsigned K;                   // size of the combined index space
  const int32_t* block_ids;     // [S, nb_pad] candidate zone blocks, or null
  int nb_pad;
  long long block;              // rows per zone block
  int blocks_per_seg;
  int vec_ok;
  unsigned long long* counts;   // [K] (counts), member 0's
  unsigned* bits;               // [ceil(K / 32)] zero at launch (presence), member 0's
  int* regs;                    // [K / 64] zero at launch (registers), member 0's
  unsigned long long* docs;     // [1] zero at launch, member 0's
};

// One member's device holder (the Params pointers moved to the member).
struct Holder {
  unsigned long long* counts;
  unsigned* bits;
  int* regs;
};

// Words of the block's holder in shared memory (after the tables); the
// layout shared_bytes() in engine/kernels/value_state_counts.py counts.
template <int MODE, int TIER>
__device__ __forceinline__ unsigned state_words(unsigned K) {
  if (TIER == kGlobal) return 0;
  if (MODE == kCounts) return K;
  if (TIER == kByte) return (K + 3) / 4;
  if (MODE == kPresence) return (K + 31) / 32;
  return K / kRho;
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

// N rows of a stream of type T: N == kRows takes the lane's 4 slabs (slab
// q starts at r0 + q * kSlabStride, read when bit q of sok is set, or
// always when FULL), N == 1 the one row r0 (read when bit 0 of sok is
// set); rows not read are 0.
template <typename T, int N, bool FULL>
__device__ __forceinline__ void load_rows(const void* ptr, long long r0, unsigned sok, int (&out)[N]) {
  const T* p = static_cast<const T*>(ptr);
  if constexpr (N == 1) {
    out[0] = (sok & 1) ? static_cast<int>(p[r0]) : 0;
  } else {
#pragma unroll
    for (int q = 0; q < kSlabs; ++q) {
      if (FULL || (sok >> q & 1)) {
        load4(p, r0 + q * kSlabStride, &out[q * kSlab]);
      } else {
#pragma unroll
        for (int e = 0; e < kSlab; ++e) out[q * kSlab + e] = 0;
      }
    }
  }
}

template <int N, bool FULL>
__device__ __forceinline__ void load_ids(const void* ptr, int code, long long r0, unsigned sok,
                                         int (&out)[N]) {
  switch (code) {
    case kU8: load_rows<uint8_t, N, FULL>(ptr, r0, sok, out); break;
    case kI16: load_rows<int16_t, N, FULL>(ptr, r0, sok, out); break;
    default: load_rows<int32_t, N, FULL>(ptr, r0, sok, out); break;
  }
}

// The lane's own word of shared memory that a dropped row updates instead
// of the holder, so that a shared update is never under a branch; its
// value leaves the test-before-update tiers with nothing to do.
template <int MODE, int TIER>
__device__ __forceinline__ int trash_init() {
  if (TIER == kByte || MODE == kCounts) return 0;
  return MODE == kPresence ? -1 : static_cast<int>(kRho);  // every bit set / above every rho
}

// ---- one update of the holder at the combined index idx (used when ok)
template <int MODE, int TIER>
__device__ __forceinline__ void update(const Holder& hd, int* hold, int* trash, unsigned idx, bool ok) {
  if (TIER == kGlobal) {  // counts: matched across the warp in process()
    if (!ok) return;
    if (MODE == kPresence) {
      const unsigned bit = __funnelshift_l(0u, 1u, idx);  // 1 << (idx % 32)
      unsigned* w = hd.bits + (idx >> 5);
      if (!(__ldcg(w) & bit)) atomicOr(w, bit);
    } else {
      const int rho = static_cast<int>(idx & (kRho - 1));
      int* reg = hd.regs + idx / kRho;
      if (rho > __ldcg(reg)) atomicMax(reg, rho);
    }
  } else if (MODE == kCounts) {
    atomicAdd(ok ? hold + idx : trash, 1);
  } else if (TIER == kByte) {  // presence or registers: every writer stores 1, no race to lose
    *(ok ? reinterpret_cast<uint8_t*>(hold) + idx : reinterpret_cast<uint8_t*>(trash)) = 1;
  } else if (MODE == kPresence) {
    const unsigned bit = __funnelshift_l(0u, 1u, idx);
    unsigned* w = ok ? reinterpret_cast<unsigned*>(hold) + (idx >> 5) : reinterpret_cast<unsigned*>(trash);
    if (!(*w & bit)) atomicOr(w, bit);
  } else {
    const int rho = static_cast<int>(idx & (kRho - 1));
    int* reg = ok ? hold + idx / kRho : trash;
    if (rho > *reg) atomicMax(reg, rho);
  }
}

// N rows of one lane: filter, combine the index in registers, update the
// holder.  FULL: every slab of the lane is in range (sok is all ones).
// Returns the number of rows that passed the filter.
template <typename F, int FILTER, int MODE, int TIER, int N, bool FULL>
__device__ __forceinline__ int process(const Params& p, const Holder& hd, const int32_t* const* tabs,
                                       const uint8_t* match, int* hold, int* trash, long long r0,
                                       unsigned sok, int flo, int fhi) {
  // global counts match equal indexes across the warp before the atomic:
  // every lane of the warp takes the 16-row path together, the one-row
  // paths match over the lanes that are there
  constexpr bool kMatch = MODE == kCounts && TIER == kGlobal;
  const unsigned warp_mask = (kMatch && N == 1) ? __activemask() : 0xffffffffu;
  unsigned hit = 0;
  if (FILTER == kDocrange) {
    if constexpr (N == 1) {
      hit = sok & 1;
    } else if constexpr (FULL) {
      hit = (1u << N) - 1;
    } else {
#pragma unroll
      for (int q = 0; q < kSlabs; ++q)
        if (sok >> q & 1) hit |= 0xfu << (q * kSlab);
    }
  } else {
    int f[N];
    load_rows<F, N, FULL>(p.filter_fwd, r0, sok, f);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const bool in = FULL || ((N == 1 ? sok : sok >> (e / kSlab)) & 1);
      bool pass;
      if (FILTER == kInterval) pass = f[e] >= flo && f[e] < fhi;
      else pass = f[e] >= 0 && f[e] < p.match_card && match[f[e]] != 0;
      if (in && pass) hit |= 1u << e;
    }
  }
  // nothing passed: the lane (the warp, where it matches) reads no other stream
  if (kMatch ? __all_sync(warp_mask, hit == 0) : hit == 0) return 0;

  unsigned idx[N];
  unsigned bad = 0;
#pragma unroll
  for (int e = 0; e < N; ++e) idx[e] = 0;
  for (int c = 0; c < p.ng; ++c) {
    int g[N];
    load_ids<N, FULL>(p.gptr[c], p.gcode[c], r0, sok, g);
    const int32_t* rm = tabs[c];
    if (rm != nullptr) {
      const unsigned rc = p.tab_card[c];
#pragma unroll
      for (int e = 0; e < N; ++e) {
        if (static_cast<unsigned>(g[e]) < rc) g[e] = rm[g[e]];
        else bad |= 1u << e;
      }
    }
    const unsigned card = p.gcard[c];
#pragma unroll
    for (int e = 0; e < N; ++e) idx[e] = idx[e] * card + static_cast<unsigned>(g[e]);
  }

  int x[N];
  load_ids<N, FULL>(p.vptr, p.vcode, r0, sok, x);
  const int32_t* ta = tabs[kValueTable];
  const unsigned tcard = p.tab_card[kValueTable];
  if (MODE != kRegisters) {
    if (ta != nullptr) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        if (static_cast<unsigned>(x[e]) < tcard) x[e] = ta[x[e]];
        else bad |= 1u << e;
      }
    }
#pragma unroll
    for (int e = 0; e < N; ++e) idx[e] = idx[e] * p.width + static_cast<unsigned>(x[e]);
  } else {
    int rho[N];
    if (p.rptr != nullptr) {
      load_rows<uint8_t, N, FULL>(p.rptr, r0, sok, rho);
    } else {  // bucket and rho through the per-dictId tables
      const int32_t* tb = tabs[kRhoTable];
#pragma unroll
      for (int e = 0; e < N; ++e) {
        if (static_cast<unsigned>(x[e]) < tcard) {
          rho[e] = tb[x[e]];
          x[e] = ta[x[e]];
        } else {
          rho[e] = 0;
          bad |= 1u << e;
        }
      }
    }
#pragma unroll
    for (int e = 0; e < N; ++e)
      idx[e] = (idx[e] * kHllM + static_cast<unsigned>(x[e])) * kRho + static_cast<unsigned>(rho[e]);
  }

  const unsigned ok = hit & ~bad;
  if constexpr (kMatch) {
    // one int64 atomic per distinct index of the warp, from its lowest
    // lane; dropped rows carry 0xffffffff, above every K
    const unsigned lane = threadIdx.x & 31;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const bool take = (ok >> e & 1) && idx[e] < p.K;
      const unsigned peers = __match_any_sync(warp_mask, take ? idx[e] : 0xffffffffu);
      if (take && static_cast<unsigned>(__ffs(peers) - 1) == lane)
        atomicAdd(hd.counts + idx[e], static_cast<unsigned long long>(__popc(peers)));
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) update<MODE, TIER>(hd, hold, trash, idx[e], (ok >> e & 1) && idx[e] < p.K);
  }
  return __popc(hit);
}

template <typename F, int FILTER, int MODE, int TIER, bool BLOCKS>
__global__ void __launch_bounds__(kThreads, 4)
value_state_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ const int32_t* s_tab[kTables];
  __shared__ int s_docs;
  __shared__ int s_trash[kThreads];
  int* tabs_smem = reinterpret_cast<int*>(smem);
  int* state = tabs_smem + (p.tab_shared ? p.tab_total : 0);
  const unsigned nstate = state_words<MODE, TIER>(p.K);
  uint8_t* match = reinterpret_cast<uint8_t*>(state + nstate);
  // the segment, or with a block table the segment of entry blockIdx.y
  const int s = BLOCKS ? blockIdx.y / p.nb_pad : blockIdx.y;
  const int m = blockIdx.x % p.members;  // the member, innermost
  const int b = blockIdx.x / p.members;
  const long long mw = m * p.member_words;
  unsigned long long* const docs = p.docs + mw;
  const Holder hd{p.counts + mw, p.bits + 2 * mw, p.regs + 2 * mw};
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (unsigned i = tid; i < nstate; i += kThreads) state[i] = 0;
  if (tid == 0) s_docs = 0;
  s_trash[tid] = trash_init<MODE, TIER>();
  for (int t = 0; t < kTables; ++t) {
    const int32_t* src = p.tab[t];
    if (src == nullptr) {
      if (tid == 0) s_tab[t] = nullptr;
      continue;
    }
    src += m * p.tab_mstride[t] + (long long)s * p.tab_card[t];
    if (p.tab_shared) {
      int* dst = tabs_smem + p.tab_off[t];
      for (int i = tid; i < p.tab_card[t]; i += kThreads) dst[i] = src[i];
      if (tid == 0) s_tab[t] = dst;
    } else if (tid == 0) {
      s_tab[t] = src;
    }
  }
  if (FILTER == kTable) {
    const uint8_t* mt = p.match + m * p.match_mstride + (long long)s * p.match_card;
    for (int i = tid; i < p.match_card; i += kThreads) match[i] = mt[i];
  }
  __syncthreads();

  const long long n_pad = p.n_pad;
  // rows [base, base + span) of the segment: all of it, or one zone block
  long long base = 0, span = n_pad;
  if (BLOCKS) {
    const long long id = p.block_ids[blockIdx.y];
    base = id < 0 ? 0 : id * p.block;
    span = id < 0 ? 0 : p.block;
  }
  // [lo, hi) relative to base
  long long lo = 0;
  long long hi = p.num_docs ? min((long long)p.num_docs[s] - base, span) : span;
  int flo = 0, fhi = 0;
  if (FILTER == kDocrange && p.bounds != nullptr) {
    const int32_t* bd = p.bounds + m * p.bounds_mstride;
    lo = max(lo, (long long)bd[2 * s] - base);
    hi = min(hi, (long long)bd[2 * s + 1] - base);
  } else if (FILTER == kInterval) {
    const int32_t* bd = p.bounds + m * p.bounds_mstride;
    flo = bd[2 * s];
    fhi = bd[2 * s + 1];
  }
  if (hi < lo) hi = lo;
  // [lo, a) head and [bb, hi) tail: one row per lane; [a, bb): 4-row slabs
  long long a = hi, bb = hi;
  if (p.vec_ok) {
    a = min((lo + kSlab - 1) & ~(long long)(kSlab - 1), hi);
    bb = max(a, hi & ~(long long)(kSlab - 1));
  }
  const long long off = (long long)s * n_pad + base;
  const int gw = b * kWarps + warp;
  const int nw = p.blocks_per_seg * kWarps;
  int* trash = s_trash + tid;
  int my_docs = 0;

  // whole chunks, every slab in range; then at most one partial chunk
  long long c0 = a + (long long)gw * kChunk;
  for (; c0 + kChunk <= bb; c0 += (long long)nw * kChunk)
    my_docs += process<F, FILTER, MODE, TIER, kRows, true>(p, hd, s_tab, match, state, trash,
                                                          off + c0 + lane * kSlab, 0xfu, flo, fhi);
  if (c0 < bb) {
    unsigned sok = 0;
#pragma unroll
    for (int q = 0; q < kSlabs; ++q)
      if (c0 + lane * kSlab + q * kSlabStride < bb) sok |= 1u << q;
    my_docs += process<F, FILTER, MODE, TIER, kRows, false>(p, hd, s_tab, match, state, trash,
                                                           off + c0 + lane * kSlab, sok, flo, fhi);
  }
  for (long long r = lo + (long long)gw * 32 + lane; r < a; r += (long long)nw * 32)
    my_docs += process<F, FILTER, MODE, TIER, 1, false>(p, hd, s_tab, match, state, trash, off + r, 1u, flo, fhi);
  for (long long r = bb + (long long)gw * 32 + lane; r < hi; r += (long long)nw * 32)
    my_docs += process<F, FILTER, MODE, TIER, 1, false>(p, hd, s_tab, match, state, trash, off + r, 1u, flo, fhi);

  // ---- flush: docs, then the block's holder into the device holder
  my_docs = __reduce_add_sync(0xffffffffu, my_docs);
  if (lane == 0 && my_docs) atomicAdd(&s_docs, my_docs);
  __syncthreads();
  if (tid == 0 && s_docs) atomicAdd(docs, static_cast<unsigned long long>(s_docs));
  if (TIER == kGlobal) return;
  if (MODE == kCounts) {
    for (unsigned k = tid; k < p.K; k += kThreads) {
      const unsigned c = state[k];
      if (c) atomicAdd(hd.counts + k, static_cast<unsigned long long>(c));
    }
  } else if (MODE == kPresence) {
    const unsigned* bits = reinterpret_cast<const unsigned*>(state);
    const uint8_t* bytes = reinterpret_cast<const uint8_t*>(state);
    for (unsigned w = tid; w < (p.K + 31) / 32; w += kThreads) {
      unsigned v = 0;
      if (TIER == kByte) {
        for (unsigned j = 0; j < 32 && w * 32 + j < p.K; ++j) v |= static_cast<unsigned>(bytes[w * 32 + j]) << j;
      } else {
        v = bits[w];
      }
      if (v && (v & ~__ldcg(hd.bits + w))) atomicOr(hd.bits + w, v);
    }
  } else {
    for (unsigned c = tid; c < p.K / kRho; c += kThreads) {
      int v = 0;
      if (TIER == kByte) {  // the largest rho whose byte is set: 16 words of 4 bytes per register
        const unsigned* w = reinterpret_cast<const unsigned*>(state) + c * (kRho / 4);
        for (int j = kRho / 4 - 1; j >= 0; --j) {
          if (w[j]) {
            v = 4 * j + (31 - __clz(w[j])) / 8;
            break;
          }
        }
      } else {
        v = state[c];
      }
      if (v > 0 && v > __ldcg(hd.regs + c)) atomicMax(hd.regs + c, v);
    }
  }
}

// presence bits -> int32 0/1 [K]; registers int32 -> uint8; member
// blockIdx.y's bits or registers lie 2 * member_words words after member 0's
__global__ void finish_presence(const unsigned* __restrict__ bits, unsigned K, long long member_words,
                                int32_t* __restrict__ out) {
  bits += 2 * member_words * blockIdx.y;
  out += (long long)K * blockIdx.y;
  for (unsigned k = blockIdx.x * blockDim.x + threadIdx.x; k < K; k += gridDim.x * blockDim.x)
    out[k] = (bits[k >> 5] >> (k & 31)) & 1;
}
__global__ void finish_registers(const int* __restrict__ regs, unsigned n, long long member_words,
                                 uint8_t* __restrict__ out) {
  regs += 2 * member_words * blockIdx.y;
  out += (long long)n * blockIdx.y;
  for (unsigned c = blockIdx.x * blockDim.x + threadIdx.x; c < n; c += gridDim.x * blockDim.x)
    out[c] = static_cast<uint8_t>(regs[c]);
}

typedef void (*KernelFn)(Params);

template <typename F, int FILTER, int MODE, bool BLOCKS>
KernelFn pick_tier(int tier) {
  switch (tier) {
    case kBlock: return value_state_kernel<F, FILTER, MODE, kBlock, BLOCKS>;
    case kGlobal: return value_state_kernel<F, FILTER, MODE, kGlobal, BLOCKS>;
    case kByte:
      if constexpr (MODE != kCounts) return value_state_kernel<F, FILTER, MODE, kByte, BLOCKS>;
      return nullptr;
    default: return nullptr;
  }
}

template <typename F, int FILTER, bool BLOCKS>
KernelFn pick_mode(int mode, int tier) {
  switch (mode) {
    case kCounts: return pick_tier<F, FILTER, kCounts, BLOCKS>(tier);
    case kPresence: return pick_tier<F, FILTER, kPresence, BLOCKS>(tier);
    case kRegisters: return pick_tier<F, FILTER, kRegisters, BLOCKS>(tier);
    default: return nullptr;
  }
}

#ifndef BLOCK_TABLE
#define BLOCK_TABLE 0
#endif
constexpr bool kBlockTable = BLOCK_TABLE != 0;  // this library's instantiations

KernelFn pick(int mode, int tier, int filter_kind, int filter_code) {
  if (filter_code < kU8 || filter_code > kI32) return nullptr;
  if (filter_kind == kDocrange) return pick_mode<uint8_t, kDocrange, kBlockTable>(mode, tier);
  if (filter_kind == kInterval) {
    if (filter_code == kU8) return pick_mode<uint8_t, kInterval, kBlockTable>(mode, tier);
    if (filter_code == kI16) return pick_mode<int16_t, kInterval, kBlockTable>(mode, tier);
    return pick_mode<int32_t, kInterval, kBlockTable>(mode, tier);
  }
  if (filter_kind == kTable) {
    if (filter_code == kU8) return pick_mode<uint8_t, kTable, kBlockTable>(mode, tier);
    if (filter_code == kI16) return pick_mode<int16_t, kTable, kBlockTable>(mode, tier);
    return pick_mode<int32_t, kTable, kBlockTable>(mode, tier);
  }
  return nullptr;
}

// (device, kernel) pairs already given at least this much dynamic shared
// memory, so that a launch costs no attribute queries after the first
struct Prepared {
  int dev;
  KernelFn fn;
  long long smem;
};
constexpr int kPreparedMax = 256;
Prepared g_prepared[kPreparedMax];
int g_nprepared = 0;
std::mutex g_prepared_mu;

cudaError_t prepare(KernelFn fn, long long smem_bytes) {
  int dev = 0, smem_limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(g_prepared_mu);
  int slot = -1;
  for (int i = 0; i < g_nprepared; ++i) {
    if (g_prepared[i].dev == dev && g_prepared[i].fn == fn) {
      if (smem_bytes >= 0 && smem_bytes <= g_prepared[i].smem) return cudaSuccess;
      slot = i;
    }
  }
  err = cudaDeviceGetAttribute(&smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  // the dynamic shared memory comes on top of the kernel's static arrays
  if (smem_bytes < 0 || smem_bytes + static_cast<long long>(attr.sharedSizeBytes) > smem_limit)
    return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return err;
  if (slot < 0 && g_nprepared < kPreparedMax) slot = g_nprepared++;
  if (slot >= 0) g_prepared[slot] = Prepared{dev, fn, smem_bytes};
  return cudaSuccess;
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

extern "C" {

// Resident blocks per SM of the kernel for these template arguments and
// this dynamic shared memory (the wrapper sizes a one-wave grid from it);
// -1 for arguments the kernel does not take, else minus a cudaError_t.
int value_state_blocks_per_sm(int mode, int tier, int filter_kind, int filter_code, long long smem_bytes) {
  KernelFn fn = pick(mode, tier, filter_kind, filter_code);
  if (fn == nullptr) return -1;
  cudaError_t err = prepare(fn, smem_bytes);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kThreads, static_cast<size_t>(smem_bytes));
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Returns 0 on success, a cudaError_t code on a launch failure, or -1 for
// arguments the kernel does not take.  smem_bytes is the dynamic shared
// memory of one block, computed by the caller (shared_bytes in
// engine/kernels/value_state_counts.py).  docs and the device holder
// (counts in counts mode, bits in presence, regs in registers) lie in one
// buffer of zero_bytes bytes starting at docs, which the launch zeroes
// first: member_words int64 words per member, member m's at m times that;
// holder receives the int32 presence [members][K] or the uint8 registers
// [members][K / 64].  bounds, match and each table are a member's own at
// member m times its stride (0: one shared by every member).
int value_state_launch(int mode, int tier, int filter_kind, int filter_code,
                       int members, long long bounds_mstride, long long match_mstride,
                       const long long* table_mstrides, long long member_words,
                       const void* filter_fwd, const int32_t* bounds, const uint8_t* match,
                       int match_card, const int32_t* num_docs, int S, long long n_pad, int ng,
                       const void* const* group_ptrs, const int* group_codes, const int* group_cards,
                       const void* values, int value_code, const uint8_t* rho,
                       const int32_t* const* tables, const int* table_cards, int tab_shared,
                       unsigned width, unsigned K, const int32_t* block_ids, int nb_pad,
                       long long block_rows, int blocks_per_seg,
                       unsigned long long* counts, unsigned* bits, int* regs,
                       unsigned long long* docs, long long zero_bytes, void* holder, long long smem_bytes,
                       void* stream) {
  if (ng < 0 || ng > kGroupMax || K < 1 || S < 1 || n_pad < 1 || blocks_per_seg < 1 || members < 1 ||
      (long long)blocks_per_seg * members > 2147483647LL || members > 65535 || member_words < 1 ||
      values == nullptr || docs == nullptr || zero_bytes < 8 * members * member_words || (block_ids != nullptr) != kBlockTable ||
      (block_ids != nullptr && (nb_pad < 1 || block_rows < 1 || n_pad % block_rows != 0 ||
                                (long long)S * nb_pad > 65535)))
    return -1;
  if ((mode == kCounts && counts == nullptr) || (mode == kPresence && (bits == nullptr || holder == nullptr)) ||
      (mode == kRegisters && (regs == nullptr || holder == nullptr || K % kRho != 0)))
    return -1;
  KernelFn fn = pick(mode, tier, filter_kind, filter_code);
  if (fn == nullptr) return -1;
  Params p;
  p.filter_fwd = filter_fwd;
  p.bounds = bounds;
  p.match = match;
  p.match_card = match_card;
  p.members = members;
  p.bounds_mstride = bounds_mstride;
  p.match_mstride = match_mstride;
  p.member_words = member_words;
  p.num_docs = num_docs;
  p.n_pad = n_pad;
  p.ng = ng;
  // the 4-row slabs need every row stream 16-byte aligned, and each
  // segment's rows starting on a slab (n_pad % 4 == 0, or one segment;
  // a zone block's rows % 4 == 0)
  bool vec = (S == 1 || n_pad % kSlab == 0) && (block_ids == nullptr || block_rows % kSlab == 0) &&
             aligned16(filter_fwd) && aligned16(values) && aligned16(rho);
  for (int c = 0; c < kGroupMax; ++c) {
    const bool used = c < ng;
    p.gptr[c] = used ? group_ptrs[c] : nullptr;
    p.gcode[c] = used ? group_codes[c] : kI32;
    p.gcard[c] = used ? static_cast<unsigned>(group_cards[c]) : 1u;
    if (used) vec = vec && aligned16(p.gptr[c]);
  }
  p.vptr = values;
  p.vcode = value_code;
  p.rptr = rho;
  int off = 0;
  for (int t = 0; t < kTables; ++t) {
    p.tab[t] = tables[t];
    p.tab_card[t] = tables[t] != nullptr ? table_cards[t] : 0;
    p.tab_mstride[t] = tables[t] != nullptr ? table_mstrides[t] : 0;
    p.tab_off[t] = off;
    off += p.tab_card[t];
  }
  p.tab_shared = tab_shared;
  p.tab_total = off;
  p.width = width;
  p.K = K;
  p.block_ids = block_ids;
  p.nb_pad = block_ids != nullptr ? nb_pad : 0;
  p.block = block_rows;
  p.blocks_per_seg = blocks_per_seg;
  p.vec_ok = vec ? 1 : 0;
  p.counts = counts;
  p.bits = bits;
  p.regs = regs;
  p.docs = docs;
  cudaError_t err = prepare(fn, smem_bytes);
  if (err == cudaErrorInvalidValue) return -1;
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(docs, 0, static_cast<size_t>(zero_bytes), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(blocks_per_seg * members, block_ids != nullptr ? S * nb_pad : S);
  fn<<<grid, kThreads, static_cast<size_t>(smem_bytes), st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (mode == kPresence) {
    const unsigned blocks = (K + kThreads - 1) / kThreads;
    const dim3 fgrid(blocks < 4096 ? blocks : 4096, members);
    finish_presence<<<fgrid, kThreads, 0, st>>>(bits, K, member_words, static_cast<int32_t*>(holder));
  } else if (mode == kRegisters) {
    const unsigned n = K / kRho;
    const unsigned blocks = (n + kThreads - 1) / kThreads;
    const dim3 fgrid(blocks < 4096 ? blocks : 4096, members);
    finish_registers<<<fgrid, kThreads, 0, st>>>(regs, n, member_words, static_cast<uint8_t*>(holder));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
