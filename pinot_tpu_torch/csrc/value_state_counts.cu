// Occupancy histogram of an int32 index stream, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_value_state_counts_pallas` in
// pinot_tpu/engine/kernel.py (the function at line 130, whose
// pl.pallas_call is at line 170):
//
//   counts[k] = #{ i : idx[i] == k }      for k in [0, K)
//
// Indexes outside [0, K) are dropped; the callers mark masked rows with the
// sentinel K.  The stream is a flattened [S, n_pad] stack, so one launch
// counts every segment: the value-state reducers over the segment axis are
// max (presence, registers) and sum (histograms), and all three fall out
// of the summed counts.  Counts are exact 64-bit integers.
//
// Bound on the card: memory.  Each element is 4 bytes read and about five
// integer operations, so the least time is (4 n + 8 K) bytes / 3.35 TB/s.
// What the design does about it:
//   * one pass over the stream with 16-byte (int4) loads, so enough bytes
//     are in flight per thread to approach the memory rate;
//   * while 4 K bytes fit one block's shared memory (K <= 58112), each
//     block keeps an int32 sub-histogram there and flushes it once, with
//     int64 atomics on the nonzero bins only; above that the block adds
//     straight into the int64 output, which for K = 2^18 is 2 MB and stays
//     in the 50 MB L2;
//   * hot bins: a warp groups its lanes by index (__match_any_sync) and the
//     group's first lane adds the group's size, so 32 equal indexes cost one
//     atomic, not 32;
//   * integer atomics only: the result is the same on every launch.
// The TPU version's two generated one-hots contracted on the MXU exist only
// because the TPU has no scatter; neither is carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

template <bool kShared>
__device__ __forceinline__ void count_one(int v, int K, int lane, int* s_hist,
                                          unsigned long long* out) {
  if (v < 0 || v >= K) v = -1;
  const unsigned peers = __match_any_sync(0xffffffffu, v);
  if (v >= 0 && lane == __ffs(peers) - 1) {
    const int c = __popc(peers);
    if (kShared) {
      atomicAdd(&s_hist[v], c);
    } else {
      atomicAdd(&out[v], static_cast<unsigned long long>(c));
    }
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
value_state_counts_kernel(const int32_t* __restrict__ idx, long long n, int K,
                          unsigned long long* __restrict__ out) {
  extern __shared__ int s_hist[];  // [K], kShared only
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (kShared) {
    for (int k = tid; k < K; k += kThreads) s_hist[k] = 0;
    __syncthreads();
  }

  // 4-element vectors; the loop bound depends on the warp only, so every
  // lane of a warp runs the same iterations and the warp-collective
  // __match_any_sync calls are converged
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  const long long n4 = n >> 2;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads + warp * 32; base < n4;
       base += stride) {
    const long long i = base + lane;
    int4 q = make_int4(-1, -1, -1, -1);
    if (i < n4) q = idx4[i];
    count_one<kShared>(q.x, K, lane, s_hist, out);
    count_one<kShared>(q.y, K, lane, s_hist, out);
    count_one<kShared>(q.z, K, lane, s_hist, out);
    count_one<kShared>(q.w, K, lane, s_hist, out);
  }
  // the last n % 4 elements: the first warp of the first block
  if (blockIdx.x == 0 && warp == 0) {
    const long long i = (n4 << 2) + lane;
    count_one<kShared>(i < n ? idx[i] : -1, K, lane, s_hist, out);
  }

  if (kShared) {
    __syncthreads();
    for (int k = tid; k < K; k += kThreads) {
      const int c = s_hist[k];
      if (c != 0) atomicAdd(&out[k], static_cast<unsigned long long>(c));
    }
  }
}

template <bool kShared>
cudaError_t launch(const int32_t* idx, long long n, int K, unsigned long long* out,
                   size_t smem, cudaStream_t stream) {
  auto kern = value_state_counts_kernel<kShared>;
  cudaError_t err = cudaSuccess;
  if (kShared) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // as many blocks as fit the card at once, and no more than the stream
  // has vectors for (the counts do not depend on the grid)
  const long long vectors = (n >> 2) > 0 ? (n >> 2) : 1;
  long long blocks = (vectors + kThreads - 1) / kThreads;
  const long long resident = static_cast<long long>(per_sm) * sms;
  if (blocks > resident) blocks = resident;
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(idx, n, K, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Adds the occupancy counts of idx[0, n) into out[0, K) (int64, zeroed by
// the caller).  use_shared selects the shared-memory sub-histogram path
// (4 K bytes of dynamic shared memory per block).  Returns 0 on success, a
// cudaError_t code on a launch failure, or -1 for arguments the kernel does
// not take (idx must be 16-byte aligned for the vector loads).
int value_state_counts_launch(const int32_t* idx, long long n, int K, unsigned long long* out,
                              int use_shared, void* stream) {
  if (n < 1 || K < 1 || idx == nullptr || out == nullptr) return -1;
  if (reinterpret_cast<uintptr_t>(idx) % 16 != 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!use_shared) return static_cast<int>(launch<false>(idx, n, K, out, 0, st));
  int dev = 0, smem_limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(K) * sizeof(int);
  if (smem > static_cast<size_t>(smem_limit)) return -1;
  return static_cast<int>(launch<true>(idx, n, K, out, smem, st));
}

}  // extern "C"
