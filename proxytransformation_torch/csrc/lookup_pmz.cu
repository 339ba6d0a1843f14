// Sorted-key lookup: for each query q, the indices of keys q-1, q and
// q+1 in that sample's ascending, SENTINEL-padded key array (-1 on a
// miss); a SENTINEL query answers -1 three times. A second entry point
// answers q only.
//
// Replaces the TPU kernel proxytransformation_tpu/ops/merge_join_pallas.py
// ::lookup_pmz_stream (:194, kernel body _make_kernel._join_kernel :77)
// and its center-only form lookup_stream (:287). References, matched bit
// for bit: proxytransformation_tpu/ops/sparse.py::_batched_lookup_pmz
// (:350) and ::_batched_lookup (:318).
//
// Bound on the H100: device-memory bytes. Each query is read once and
// three (or one) int32 answers are written; the keys (<= 400 KB a sample)
// stay in the 50 MB L2 across the binary searches. About log2(V) + 3
// integer compares per query.
//
// Design: one thread per query. A binary search finds the lower bound of
// q-1 (of q for the center entry) in the sample's keys; keys are unique
// among valid entries, so the answers are the next three (one) entries
// when they equal q-1, q, q+1. The TPU kernel streamed a merge-join
// window through VMEM because gathers were slow there; the card gathers
// directly, and the sorted query order keeps neighbouring threads on
// neighbouring keys.
#include "common.cuh"

namespace {

constexpr int kSentinel = 2147483647;
constexpr int kThreads = 256;

__device__ __forceinline__ int lower_bound(const int* __restrict__ keys, int V,
                                           long long x) {
  int lo = 0, hi = V;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (static_cast<long long>(keys[mid]) < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void lookup_pmz_kernel(const int* __restrict__ keys,
                                  const int* __restrict__ queries, int B, int V,
                                  int Q, int* __restrict__ out_minus,
                                  int* __restrict__ out_center,
                                  int* __restrict__ out_plus) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(B) * Q) return;
  const int* kb = keys + (t / Q) * V;
  const int q = queries[t];
  int rm = -1, rc = -1, rp = -1;
  if (q != kSentinel) {
    const long long ql = q;
    const int lo = lower_bound(kb, V, ql - 1);
    for (int j = lo; j < lo + 3 && j < V; ++j) {
      const long long d = static_cast<long long>(kb[j]) - ql;  // >= -1
      if (d > 1) break;
      if (d == -1) rm = j; else if (d == 0) rc = j; else rp = j;
    }
  }
  out_minus[t] = rm;
  out_center[t] = rc;
  out_plus[t] = rp;
}

__global__ void lookup_center_kernel(const int* __restrict__ keys,
                                     const int* __restrict__ queries, int B,
                                     int V, int Q, int* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(B) * Q) return;
  const int* kb = keys + (t / Q) * V;
  const int q = queries[t];
  int r = -1;
  if (q != kSentinel) {
    const int lo = lower_bound(kb, V, q);
    if (lo < V && kb[lo] == q) r = lo;
  }
  out[t] = r;
}

int blocks_for(long long n) { return static_cast<int>((n + kThreads - 1) / kThreads); }

}  // namespace

// keys (B, V) int32 sorted ascending per sample, queries (B, Q) int32;
// outputs (B, Q) int32 each; all contiguous on the device.
extern "C" int ptt_lookup_pmz(const void* keys, const void* queries, int B,
                              int V, int Q, void* out_minus, void* out_center,
                              void* out_plus, void* stream) {
  const long long n = static_cast<long long>(B) * Q;
  if (n > 0) {
    lookup_pmz_kernel<<<blocks_for(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(keys), static_cast<const int*>(queries), B, V, Q,
        static_cast<int*>(out_minus), static_cast<int*>(out_center),
        static_cast<int*>(out_plus));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ptt_lookup_center(const void* keys, const void* queries, int B,
                                 int V, int Q, void* out, void* stream) {
  const long long n = static_cast<long long>(B) * Q;
  if (n > 0) {
    lookup_center_kernel<<<blocks_for(n), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(keys), static_cast<const int*>(queries), B, V, Q,
        static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
