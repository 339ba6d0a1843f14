// Shared by every kernel library in this directory: each .cu builds into
// its own shared library with a plain C interface, loaded with ctypes.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

// Text of the cudaError_t code that an entry point returned.
extern "C" const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Asynchronous global -> shared copies (sm_80+). With `valid` false the
// source size is 0: nothing is read and the destination is zero-filled,
// so a miss needs no branch around the copy.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ------------------------------------------------------------------------
// Shared by the sparse-conv kernels (sparse_conv.cu, sparse_conv_dw.cu and
// sparse_conv_bf16.cu): one copy of the device code that reads a map's
// plan (ops/sparse.py::conv_plan) and adds split partials.

constexpr int kMaxK3 = 32;       // offsets a row mask holds
constexpr int kMinChunk = 256;   // hits a dW split takes at least ...
constexpr int kMaxChunk = 4096;  // ... and at most

// The rows of a tile of kRows mask-sorted rows and the map entries of its
// active offsets, in shared memory.
template <int kRows, int kGroup>
struct TileRows {
  int idx[kMaxK3][kRows];          // map entries of the active offsets, -1 for dropped rows
  int rows[kRows];                 // original row of each tile row, -1 past V_out
  int keep[kRows];                 // out_mask of that row
  int act[kMaxK3];                 // the active offsets, ascending
  unsigned grp_or[kRows / kGroup]; // OR of each group of kGroup rows' hit masks
  unsigned mask_or;                // OR of all kept rows' masks
};

// The set-up of a tile block: the tile's rows t0.. in mask order
// (order[b, t0 + t]), whether each is kept (out_mask), the OR of the hit
// masks (row_mask) of each group of kGroup kept rows and of all of them
// (an integer OR, order free) and the active offsets (the bits of that
// OR, ascending). Every thread of the block calls it; returns the number
// of active offsets. rb = b * V_out. The caller stages the map entries
// of the active offsets into s.idx.
template <int kRows, int kGroup, int kThreads>
__device__ __forceinline__ int load_tile_rows(const int* __restrict__ order,
                                              const uint8_t* __restrict__ out_mask,
                                              const int* __restrict__ row_mask, long long rb,
                                              int t0, int V_out, TileRows<kRows, kGroup>& s) {
  static_assert(kThreads >= kRows && kRows % kGroup == 0 && kThreads % 32 == 0, "tile shape");
  const int tid = threadIdx.x;
  if (tid == 0) s.mask_or = 0u;
  if (kGroup > 32 && tid < kRows / kGroup) s.grp_or[tid] = 0u;
  __syncthreads();
  unsigned m = 0u;
  if (tid < kRows) {
    const int pos = t0 + tid;
    int v = -1, keep = 0;
    if (pos < V_out) {
      v = order[rb + pos];
      keep = out_mask[rb + v] != 0;
      if (keep) m = static_cast<unsigned>(row_mask[rb + v]);
    }
    s.rows[tid] = v;
    s.keep[tid] = keep;
  }
  if constexpr (kGroup <= 32) {
#pragma unroll
    for (int off = kGroup / 2; off > 0; off >>= 1) m |= __shfl_xor_sync(0xffffffffu, m, off);
    if (tid < kRows && tid % kGroup == 0) s.grp_or[tid / kGroup] = m;
    m = __reduce_or_sync(0xffffffffu, m);
  } else {
    m = __reduce_or_sync(0xffffffffu, m);
    if ((tid & 31) == 0 && tid < kRows && m) atomicOr(&s.grp_or[tid / kGroup], m);
  }
  if ((tid & 31) == 0 && m) atomicOr(&s.mask_or, m);
  __syncthreads();
  const unsigned mask_or = s.mask_or;
  const int n_act = __popc(mask_or);
  if (tid == 0) {
    unsigned mm = mask_or;
    for (int j = 0; mm; ++j, mm &= mm - 1) s.act[j] = __ffs(mm) - 1;
  }
  __syncthreads();
  return n_act;
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

// out[e] = sum over s in order of ws[s][e], converted once: a fixed order,
// the same bits every run (masked rows are zero in every split already).
template <typename OutT>
__device__ __forceinline__ void sum_splits(const float* __restrict__ ws, long long n, int S,
                                           OutT* __restrict__ out) {
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (e >= n) return;
  float acc = 0.f;
  for (int i = 0; i < S; ++i) acc += ws[i * n + e];
  out[e] = from_float<OutT>(acc);
}

// The splits of every offset's dW hit list: equal chunks of all offsets'
// hits, clamp(ceil(H / pairs_target), kMinChunk, kMaxChunk); offset k
// takes S[k] of them, from split base[k] on. A function of the counts
// alone, so every block and the sum pass derive the same table
// (ops/sparse.py::dw_split_table mirrors it).
struct SplitTable {
  int chunk, total;
  int S[kMaxK3], base[kMaxK3];
};

__device__ __forceinline__ void split_table(const int* counts, int K3, int pairs_target,
                                            SplitTable& t) {
  long long H = 0;
  for (int k = 0; k < K3; ++k) H += counts[k];
  long long chunk = (H + pairs_target - 1) / pairs_target;
  chunk = chunk < kMinChunk ? kMinChunk : chunk > kMaxChunk ? kMaxChunk : chunk;
  int base = 0;
  for (int k = 0; k < K3; ++k) {
    const int S = static_cast<int>((counts[k] + chunk - 1) / chunk);
    t.S[k] = S;
    t.base[k] = base;
    base += S;
  }
  t.chunk = static_cast<int>(chunk);
  t.total = base;
}

struct Split {
  int k, nh;
  long long h0;
};

// A dW block's offset and hit range (blockIdx.x is its split), its hit
// rows and their input rows (nbr[r, k]) in shared memory; nh = 0 when the
// block is past the last split. Args: the kernel's argument struct (hits,
// counts, nbr, K3, pairs_target, R).
template <int kThreads, typename Args>
__device__ __forceinline__ Split load_split(const Args& p, SplitTable& t, int* r_s, int* id_s) {
  if (threadIdx.x == 0) split_table(p.counts, p.K3, p.pairs_target, t);
  __syncthreads();
  const int pair = blockIdx.x;
  Split sp{0, 0, 0};
  if (pair >= t.total) return sp;
  while (pair >= t.base[sp.k] + t.S[sp.k]) ++sp.k;
  sp.h0 = static_cast<long long>(pair - t.base[sp.k]) * t.chunk;
  const long long left = p.counts[sp.k] - sp.h0;
  sp.nh = static_cast<int>(left < t.chunk ? left : t.chunk);
  const int* hl = p.hits + sp.k * p.R + sp.h0;
  for (int e = threadIdx.x; e < sp.nh; e += kThreads) {
    const int r = hl[e];
    r_s[e] = r;
    id_s[e] = p.nbr[static_cast<long long>(r) * p.K3 + sp.k];
  }
  __syncthreads();
  return sp;
}

// dW[e] = sum over k's splits in order of ws[split][e], e over K3 * CC
// elements; zero where offset k has no hit. A fixed order, so the same
// bits every run.
__device__ __forceinline__ void sum_dw_splits(const float* __restrict__ ws,
                                              const int* __restrict__ counts, int K3,
                                              int pairs_target, long long CC,
                                              float* __restrict__ dw) {
  __shared__ SplitTable t;
  if (threadIdx.x == 0) split_table(counts, K3, pairs_target, t);
  __syncthreads();
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (e >= K3 * CC) return;
  const int k = static_cast<int>(e / CC);
  const long long off = e % CC;
  float acc = 0.f;
  for (int i = 0; i < t.S[k]; ++i) acc += ws[(t.base[k] + i) * CC + off];
  dw[e] = acc;
}
