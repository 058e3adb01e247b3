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
//   v_j       = dict_j[s][fwd_j[s,i]]   or the raw float row
//   num_docs  = sum mask                                    (int64)
//   count[k]  = sum mask * [key == k]                       (int64)
//   sums[j,k] = sum mask * v_j * [key == k]                 (float or double)
//
// where key is the precombined mixed-radix int32 group key.  With S == 1
// this is exactly the TPU kernel.
//
// Bound on the card: memory.  Q1 reads per row one int32 key and three
// float32 raws (16 B) and does about a dozen integer and float operations,
// far below the card's compute rate, so the least time is bytes / 3.35 TB/s.
// What the design does about it:
//   * one pass, each row's bytes read once, rows outside [0, num_docs) and,
//     for docrange, outside the doc interval are never read;
//   * dictionaries (<= 4096 entries) and the match table sit in shared
//     memory, so a dictionary-fed column costs its narrow fwd bytes only;
//   * fwd columns are read in their staged widths (uint8 / int16 / int32):
//     the filter column through the template parameter F, value columns
//     through a warp-uniform switch on their width code;
//   * group counts are shared-memory integer atomics (exact); float sums go
//     to per-warp accumulators in shared memory through the warp's
//     __match_any_sync groups: the group leader adds its peers' values in
//     lane order, so every sum is taken in a fixed order;
//   * each block writes its partials to a [blocks, nv, K] scratch buffer and
//     a second small kernel reduces the blocks in block order.  There are no
//     float atomics anywhere, so a launch's result is bit-identical to the
//     next one's at the same grid.
// The TPU version's chunked lane-shuffle gather and one-hot MXU contraction
// exist only because the TPU has no cheap gather; neither is carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNvMax = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum FilterKind { kInterval = 0, kDocrange = 1, kTable = 2 };
enum ValueCode { kU8 = 0, kI16 = 1, kI32 = 2, kRaw = 3 };

struct Params {
  const void* filter_fwd;   // [S, n_pad] F (interval, table)
  const int32_t* bounds;    // [S, 2] (interval: dictIds, docrange: rows)
  const uint8_t* match;     // [S, match_card] (table)
  int match_card;
  const int32_t* num_docs;  // [S]
  long long n_pad;
  const int32_t* keys;      // [S, n_pad]
  int K;
  int nv;
  const void* vptr[kNvMax];  // [S, n_pad] fwd or raw rows
  int vcode[kNvMax];
  const void* dptr[kNvMax];  // [S, dcard] dictionary values
  int dcard[kNvMax];
  int doff[kNvMax];          // offset of column j's dictionary in shared memory
  int dict_total;
  int blocks_per_seg;
  int32_t* part_docs;        // [B]
  int32_t* part_counts;      // [B, K]
  void* part_sums;           // [B, nv, K]
};

template <typename T>
__device__ __forceinline__ T load_value(const Params& p, int j, long long idx,
                                        const T* s_dict) {
  switch (p.vcode[j]) {
    case kRaw:
      return static_cast<const T*>(p.vptr[j])[idx];
    case kU8:
      return s_dict[p.doff[j] + static_cast<const uint8_t*>(p.vptr[j])[idx]];
    case kI16:
      return s_dict[p.doff[j] + static_cast<const int16_t*>(p.vptr[j])[idx]];
    default:
      return s_dict[p.doff[j] + static_cast<const int32_t*>(p.vptr[j])[idx]];
  }
}

template <typename T, typename F, int MODE>
__global__ void __launch_bounds__(kThreads)
fused_groupby_partial(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.y;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int K = p.K;
  const int nv = p.nv;

  T* s_dict = reinterpret_cast<T*>(smem);          // [dict_total]
  T* s_wsum = s_dict + p.dict_total;               // [kWarps][nv][K]
  T* s_lane = s_wsum + kWarps * nv * K;            // [kWarps][nv][32]
  int* s_cnt = reinterpret_cast<int*>(s_lane + kWarps * nv * 32);  // [K]
  int* s_docs = s_cnt + K;                         // [1]
  uint8_t* s_match = reinterpret_cast<uint8_t*>(s_docs + 1);       // [match_card]

  for (int i = tid; i < kWarps * nv * K; i += kThreads) s_wsum[i] = T(0);
  for (int i = tid; i < K; i += kThreads) s_cnt[i] = 0;
  if (tid == 0) s_docs[0] = 0;
  for (int j = 0; j < nv; ++j) {
    if (p.vcode[j] == kRaw) continue;
    const T* d = static_cast<const T*>(p.dptr[j]) + (long long)s * p.dcard[j];
    for (int i = tid; i < p.dcard[j]; i += kThreads) s_dict[p.doff[j] + i] = d[i];
  }
  if (MODE == kTable) {
    const uint8_t* m = p.match + (long long)s * p.match_card;
    for (int i = tid; i < p.match_card; i += kThreads) s_match[i] = m[i];
  }
  __syncthreads();

  long long lo = 0;
  long long hi = p.num_docs[s];
  int flo = 0, fhi = 0;
  if (MODE == kDocrange) {
    lo = max(lo, (long long)p.bounds[2 * s]);
    hi = min(hi, (long long)p.bounds[2 * s + 1]);
  } else if (MODE == kInterval) {
    flo = p.bounds[2 * s];
    fhi = p.bounds[2 * s + 1];
  }
  const long long seg_off = (long long)s * p.n_pad;
  const long long stride = (long long)p.blocks_per_seg * kThreads;
  const F* fcol = static_cast<const F*>(p.filter_fwd);
  T* wsum = s_wsum + warp * nv * K;
  T* lbuf = s_lane + warp * nv * 32;
  int my_docs = 0;

  // the loop bound depends on the warp only, so every lane of a warp runs
  // the same iterations and the warp-collective calls below are converged
  for (long long base = lo + (long long)b * kThreads + warp * 32; base < hi;
       base += stride) {
    const long long i = base + lane;
    bool hit = i < hi;
    if (hit && MODE != kDocrange) {
      const int f = static_cast<int>(fcol[seg_off + i]);
      if (MODE == kInterval) {
        hit = f >= flo && f < fhi;
      } else {
        hit = f >= 0 && f < p.match_card && s_match[f] != 0;
      }
    }
    int key = -1;
    if (hit) {
      ++my_docs;
      key = p.keys[seg_off + i];
      if (key < 0 || key >= K) key = -1;  // out-of-range keys drop, as mode="drop"
    }
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    const int leader = __ffs(peers) - 1;
    if (key >= 0) {
      for (int j = 0; j < nv; ++j) lbuf[j * 32 + lane] = load_value<T>(p, j, seg_off + i, s_dict);
      if (lane == leader) atomicAdd(&s_cnt[key], __popc(peers));
    }
    __syncwarp();
    if (key >= 0 && lane == leader) {
      for (int j = 0; j < nv; ++j) {
        T acc = T(0);
        unsigned m = peers;
        while (m) {
          const int l = __ffs(m) - 1;
          m &= m - 1;
          acc += lbuf[j * 32 + l];
        }
        wsum[j * K + key] += acc;
      }
    }
    __syncwarp();
  }

  my_docs = __reduce_add_sync(0xffffffffu, my_docs);
  if (lane == 0) atomicAdd(s_docs, my_docs);
  __syncthreads();

  const long long gb = (long long)s * p.blocks_per_seg + b;
  if (tid == 0) p.part_docs[gb] = s_docs[0];
  for (int k = tid; k < K; k += kThreads) p.part_counts[gb * K + k] = s_cnt[k];
  T* psum = static_cast<T*>(p.part_sums) + gb * nv * K;
  for (int idx = tid; idx < nv * K; idx += kThreads) {
    T acc = T(0);
    for (int w = 0; w < kWarps; ++w) acc += s_wsum[w * nv * K + idx];
    psum[idx] = acc;
  }
}

// Second pass: one thread per output, blocks summed in block order.
template <typename T>
__global__ void fused_groupby_reduce(const int32_t* part_docs, const int32_t* part_counts,
                                     const T* part_sums, int B, int K, int nv,
                                     long long* out_docs, long long* out_counts,
                                     T* out_sums) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t == 0) {
    long long a = 0;
    for (int b = 0; b < B; ++b) a += part_docs[b];
    *out_docs = a;
  } else if (t <= K) {
    const int k = t - 1;
    long long a = 0;
    for (int b = 0; b < B; ++b) a += part_counts[(long long)b * K + k];
    out_counts[k] = a;
  } else if (t <= K + nv * K) {
    const int idx = t - 1 - K;
    T a = T(0);
    for (int b = 0; b < B; ++b) a += part_sums[(long long)b * nv * K + idx];
    out_sums[idx] = a;
  }
}

template <typename T, typename F, int MODE>
cudaError_t launch_partial(const Params& p, int S, size_t smem, cudaStream_t stream) {
  auto kern = fused_groupby_partial<T, F, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(p.blocks_per_seg, S);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_all(const Params& p, int S, int filter_kind, int filter_code,
                       size_t smem, long long* out_docs, long long* out_counts,
                       void* out_sums, cudaStream_t stream) {
  cudaError_t err;
  if (filter_kind == kDocrange) {
    err = launch_partial<T, uint8_t, kDocrange>(p, S, smem, stream);
  } else if (filter_kind == kInterval) {
    if (filter_code == kU8) err = launch_partial<T, uint8_t, kInterval>(p, S, smem, stream);
    else if (filter_code == kI16) err = launch_partial<T, int16_t, kInterval>(p, S, smem, stream);
    else err = launch_partial<T, int32_t, kInterval>(p, S, smem, stream);
  } else {
    if (filter_code == kU8) err = launch_partial<T, uint8_t, kTable>(p, S, smem, stream);
    else if (filter_code == kI16) err = launch_partial<T, int16_t, kTable>(p, S, smem, stream);
    else err = launch_partial<T, int32_t, kTable>(p, S, smem, stream);
  }
  if (err != cudaSuccess) return err;
  const int B = S * p.blocks_per_seg;
  const int outputs = 1 + p.K + p.nv * p.K;
  const int threads = 128;
  fused_groupby_reduce<T><<<(outputs + threads - 1) / threads, threads, 0, stream>>>(
      p.part_docs, p.part_counts, static_cast<const T*>(p.part_sums), B, p.K, p.nv,
      out_docs, out_counts, static_cast<T*>(out_sums));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t code on a launch failure, or -1 for
// arguments the kernel does not take.  smem_bytes is the dynamic shared
// memory of one partial block, computed by the caller (shared_bytes in
// engine/kernels/fused_groupby.py) in the layout fused_groupby_partial
// carves: dictionaries, per-warp sums, per-warp lane staging, counts, docs,
// match table.
int fused_groupby_launch(int float_code, int filter_kind, int filter_code,
                         const void* filter_fwd, const int32_t* bounds,
                         const uint8_t* match, int match_card, const int32_t* num_docs,
                         int S, long long n_pad, const int32_t* keys, int K, int nv,
                         const void* const* value_ptrs, const int* value_codes,
                         const void* const* dict_ptrs, const int* dict_cards,
                         int blocks_per_seg, int32_t* part_docs, int32_t* part_counts,
                         void* part_sums, long long* out_docs, long long* out_counts,
                         void* out_sums, long long smem_bytes, void* stream) {
  if (nv < 0 || nv > kNvMax || K < 1 || S < 1 || blocks_per_seg < 1) return -1;
  Params p;
  p.filter_fwd = filter_fwd;
  p.bounds = bounds;
  p.match = match;
  p.match_card = match_card;
  p.num_docs = num_docs;
  p.n_pad = n_pad;
  p.keys = keys;
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
  }
  p.dict_total = off;
  p.blocks_per_seg = blocks_per_seg;
  p.part_docs = part_docs;
  p.part_counts = part_counts;
  p.part_sums = part_sums;
  int dev = 0, smem_limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem_bytes < 0 || smem_bytes > smem_limit) return -1;
  const size_t smem = static_cast<size_t>(smem_bytes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (float_code == 1) {
    err = launch_all<double>(p, S, filter_kind, filter_code, smem, out_docs, out_counts,
                             out_sums, st);
  } else {
    err = launch_all<float>(p, S, filter_kind, filter_code, smem, out_docs, out_counts,
                            out_sums, st);
  }
  return static_cast<int>(err);
}

}  // extern "C"
