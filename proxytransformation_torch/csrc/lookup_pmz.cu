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
// are read once.
//
// The first design searched each query on its own (one thread, a binary
// search of ~log2(V) = 17 levels over up to 100k keys, every level a
// dependent load from L2), on the assumption that the card gathers
// directly and that sorted queries keep neighbouring threads on
// neighbouring keys. It did not hold: a launch took ~14 us against a
// ~1.7 us bound, the threads' latency chains and not the bytes setting
// the time. A window per tile whose two ends a warp found by a 32-ary
// search in global memory still left ~7 dependent round trips a block
// (~9 us a launch at any size).
//
// Design, after the TPU kernel's merge-join window: a block takes a tile
// of 1024 consecutive queries of one sample (4 a thread). While its
// queries load, it loads into shared memory either the sample's whole
// key row (V <= capacity), or every F-th key (the fences, at most 256; F
// a power of two). The block-wide min and max of its non-SENTINEL
// queries then place the tile's window among the fences in shared
// memory: [lo, hi) holds lower_bound(qmin-1) .. lower_bound(qmax+2), the
// only keys its answers can reach, and at most F-1 more keys at each
// end. The block loads that window with 16-byte loads, up to `capacity`
// keys, and each thread searches it in shared memory (binary lifting,
// the same steps for all its queries, so their loads overlap). A block
// waits for two dependent loads, or one where the whole row fits. A tile
// whose window exceeds the capacity narrows each query to F keys by the
// fences and searches those in global memory; it gives the same answers,
// and the kernel reports each tile's window length when asked. Answers
// do not depend on query order: build_neighbor_map's ascending column
// runs keep windows about as long as the tile, and the neck's parent
// keys (not ascending) search rows that fit whole.
//
// One body, two output forms, each its own kernel symbol so a profile
// tells them apart: lookup_pmz_kernel searches the lower bound of q-1,
// and the three slots from there answer q-1, q, q+1 (keys are unique
// among valid entries; compares in 64 bits so q±1 cannot overflow);
// lookup_center_tile_kernel searches the lower bound of q and answers it
// where the key there equals q. The pmz window holds every center
// answer, so both forms share it.
#include "common.cuh"

namespace {

constexpr int kSentinel = 2147483647;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;  // queries a block
constexpr int kMaxFences = 256;
// the dynamic shared memory a launch gets without cudaFuncSetAttribute;
// lookup_launch_shape keeps every window within it
constexpr int kDefaultSmem = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;

// How many of fence[0, nf) are below x, counted by one warp (every lane
// returns it).
__device__ __forceinline__ int warp_count_below(const int* fence, int nf, long long x) {
  const int lane = threadIdx.x & 31;
  int c = 0;
  for (int i0 = 0; i0 < nf; i0 += 32) {
    const int i = i0 + lane;
    c += __popc(__ballot_sync(kFull, i < nf && static_cast<long long>(fence[i]) < x));
  }
  return c;
}

// Lower bounds of x[k] in w[lo[k], lo[k] + n[k]), n[k] < 2 * top (top a
// power of two): binary lifting, the same steps for every query, so
// their loads overlap. Returns positions in w.
__device__ __forceinline__ void lower_bounds(const int* w, const int (&lo)[kPerThread],
                                             const int (&n)[kPerThread], int top,
                                             const long long (&x)[kPerThread],
                                             int (&pos)[kPerThread]) {
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) pos[k] = 0;
  for (int step = top; step > 0; step >>= 1) {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int p = pos[k] + step;
      if (p <= n[k] && static_cast<long long>(w[lo[k] + p - 1]) < x[k]) pos[k] = p;
    }
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) pos[k] += lo[k];
}

__device__ __forceinline__ int top_bit(int n) { return n > 0 ? 1 << (31 - __clz(n)) : 0; }

// keys[f_lo, f_hi) of the flat (B, V) array into shared memory with
// 16-byte loads from the aligned index at or below f_lo (the keys' base
// is 16-byte aligned), scalar ones past f_end; returns where key f_lo
// sits in `window`.
__device__ __forceinline__ int stage_keys(const int* __restrict__ keys, long long f_lo,
                                          long long f_hi, long long f_end, int4* window4) {
  const long long a0 = f_lo & ~3LL;
  const int groups = static_cast<int>((f_hi - a0 + 3) >> 2);
  int* window = reinterpret_cast<int*>(window4);
  for (int g = threadIdx.x; g < groups; g += kThreads) {
    const long long f = a0 + 4LL * g;
    if (f + 3 < f_end) {
      window4[g] = __ldg(reinterpret_cast<const int4*>(keys + f));
    } else {
      for (int e = 0; e < 4 && f + e < f_end; ++e) window[4 * g + e] = keys[f + e];
    }
  }
  return static_cast<int>(f_lo - a0);
}

// One block per (sample, tile of kTile queries), the body of both
// kernels; kCenter picks the output form (out_minus and out_plus unused
// when set). fence_step F: 0 where the whole row fits in `capacity`,
// else a power of two with ceil(V / F) <= kMaxFences. window_len, when
// not null, receives each tile's window length (0 for an all-SENTINEL
// tile). Shared memory: `window4` (dynamic: capacity + 4 keys, then the
// fences), `red` (2 x kWarps) and `ends` (2), declared by the kernels.
template <bool kCenter>
__device__ __forceinline__ void lookup_tile(
    const int* __restrict__ keys, const int* __restrict__ queries, int B, int V, int Q,
    int tiles, int capacity, int fence_step, int* __restrict__ out_minus,
    int* __restrict__ out_center, int* __restrict__ out_plus, int* __restrict__ window_len,
    int4* window4, int (*red)[kWarps], int* ends) {
  int* window = reinterpret_cast<int*>(window4);
  int* fence = window + capacity + 4;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * kTile;
  const long long f_row = b * V;
  const long long f_end = static_cast<long long>(B) * V;
  const int* kb = keys + f_row;
  const int* qb = queries + b * Q;
  const bool whole = fence_step == 0;
  const int nf = whole ? 0 : (V + fence_step - 1) / fence_step;

  int q[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = q0 + k * kThreads + threadIdx.x;
    q[k] = i < Q ? qb[i] : kSentinel;
  }
  // the row or the fences load while the queries arrive
  int lead = 0;
  if (whole) {
    lead = stage_keys(keys, f_row, f_row + V, f_end, window4);
  } else {
    for (int i = threadIdx.x; i < nf; i += kThreads) fence[i] = kb[i * fence_step];
  }
  int qmin = kSentinel, qmax = -kSentinel - 1;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    if (q[k] != kSentinel) {
      qmin = min(qmin, q[k]);
      qmax = max(qmax, q[k]);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    qmin = min(qmin, __shfl_xor_sync(kFull, qmin, d));
    qmax = max(qmax, __shfl_xor_sync(kFull, qmax, d));
  }
  if (lane == 0) {
    red[0][warp] = qmin;
    red[1][warp] = qmax;
  }
  __syncthreads();
  qmin = red[0][0];
  qmax = red[1][0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    qmin = min(qmin, red[0][w]);
    qmax = max(qmax, red[1][w]);
  }

  if (qmin > qmax) {  // no live query in the tile (uniform per block)
    if (window_len != nullptr && threadIdx.x == 0) window_len[blockIdx.x] = 0;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int i = q0 + k * kThreads + threadIdx.x;
      if (i >= Q) continue;
      out_center[b * Q + i] = -1;
      if constexpr (!kCenter) out_minus[b * Q + i] = out_plus[b * Q + i] = -1;
    }
    return;
  }
  // the tile's window: row keys [lo, lo + n), at window + lead in shared
  // memory unless it exceeds the capacity
  int lo = 0, n = V;
  bool staged = whole;
  if (!whole) {
    if (warp < 2) {
      const int c = warp_count_below(
          fence, nf, warp == 0 ? static_cast<long long>(qmin) - 1
                               : static_cast<long long>(qmax) + 2);
      if (lane == 0) ends[warp] = c;
    }
    __syncthreads();
    lo = ends[0] > 0 ? (ends[0] - 1) * fence_step + 1 : 0;
    n = (ends[1] < nf ? ends[1] * fence_step : V) - lo;
    if (n <= capacity) {
      lead = stage_keys(keys, f_row + lo, f_row + lo + n, f_end, window4);
      __syncthreads();
      staged = true;
    }
  }
  if (window_len != nullptr && threadIdx.x == 0) window_len[blockIdx.x] = n;

  // the lower bound searched: of q-1 (its three slots answer q-1, q,
  // q+1) or of q
  long long x[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) x[k] = static_cast<long long>(q[k]) - (kCenter ? 0 : 1);
  // keys w[0, wn) with w[j] = row key lo + j
  const int* w;
  int wn, pos[kPerThread], zero[kPerThread], len[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) zero[k] = 0;
  if (staged) {
    w = window + lead;
    wn = n;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) len[k] = n;
    lower_bounds(w, zero, len, top_bit(n), x, pos);
  } else {
    // each query narrowed to the F - 1 keys between two fences, then
    // searched in global memory
    w = kb;
    wn = V;
    lo = 0;
    int c[kPerThread], qlo[kPerThread], qn[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) len[k] = nf;
    lower_bounds(fence, zero, len, top_bit(nf), x, c);
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      qlo[k] = c[k] > 0 ? (c[k] - 1) * fence_step + 1 : 0;
      qn[k] = (c[k] < nf ? c[k] * fence_step : V) - qlo[k];
    }
    lower_bounds(kb, qlo, qn, fence_step, x, pos);
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = q0 + k * kThreads + threadIdx.x;
    if (i >= Q) continue;
    const long long t = b * Q + i;
    if constexpr (kCenter) {
      out_center[t] = q[k] != kSentinel && pos[k] < wn && w[pos[k]] == q[k] ? lo + pos[k] : -1;
      continue;
    }
    int rm = -1, rc = -1, rp = -1;
    if (q[k] != kSentinel) {
      // keys past the window exceed q+1, so the slots stop at its end
      for (int j = pos[k]; j < pos[k] + 3 && j < wn; ++j) {
        const long long d = static_cast<long long>(w[j]) - q[k];  // >= -1
        if (d > 1) break;
        if (d == -1) rm = lo + j; else if (d == 0) rc = lo + j; else rp = lo + j;
      }
    }
    out_minus[t] = rm;
    out_center[t] = rc;
    out_plus[t] = rp;
  }
}

__global__ void __launch_bounds__(kThreads)
lookup_pmz_kernel(const int* __restrict__ keys, const int* __restrict__ queries,
                  int B, int V, int Q, int tiles, int capacity, int fence_step,
                  int* __restrict__ out_minus, int* __restrict__ out_center,
                  int* __restrict__ out_plus, int* __restrict__ window_len) {
  extern __shared__ int4 window4[];
  __shared__ int red[2][kWarps];
  __shared__ int ends[2];
  lookup_tile<false>(keys, queries, B, V, Q, tiles, capacity, fence_step, out_minus,
                     out_center, out_plus, window_len, window4, red, ends);
}

__global__ void __launch_bounds__(kThreads)
lookup_center_tile_kernel(const int* __restrict__ keys, const int* __restrict__ queries,
                          int B, int V, int Q, int tiles, int capacity, int fence_step,
                          int* __restrict__ out, int* __restrict__ window_len) {
  extern __shared__ int4 window4[];
  __shared__ int red[2][kWarps];
  __shared__ int ends[2];
  lookup_tile<true>(keys, queries, B, V, Q, tiles, capacity, fence_step, nullptr, out,
                    nullptr, window_len, window4, red, ends);
}

// The launch of either form, or cudaErrorInvalidValue for arguments the
// kernels do not take.
template <bool kCenter>
int launch_lookup(const void* keys, const void* queries, int B, int V, int Q, int capacity,
                  int fence_step, void* out_minus, void* out_center, void* out_plus,
                  void* window_len, void* stream) {
  const bool fences_ok =
      fence_step == 0 ? V <= capacity
                      : (fence_step & (fence_step - 1)) == 0 &&
                            (V + fence_step - 1) / fence_step <= kMaxFences;
  const int smem = (capacity + 4 + (fence_step ? kMaxFences : 0)) *
                   static_cast<int>(sizeof(int));
  if (!aligned16(keys) || capacity < 0 || capacity % 4 != 0 || !fences_ok ||
      smem > kDefaultSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (Q + kTile - 1) / kTile;
  if (B > 0 && tiles > 0) {
    const int* k = static_cast<const int*>(keys);
    const int* qs = static_cast<const int*>(queries);
    int* wl = static_cast<int*>(window_len);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if constexpr (kCenter) {
      lookup_center_tile_kernel<<<B * tiles, kThreads, smem, s>>>(
          k, qs, B, V, Q, tiles, capacity, fence_step, static_cast<int*>(out_center), wl);
    } else {
      lookup_pmz_kernel<<<B * tiles, kThreads, smem, s>>>(
          k, qs, B, V, Q, tiles, capacity, fence_step, static_cast<int*>(out_minus),
          static_cast<int*>(out_center), static_cast<int*>(out_plus), wl);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// keys (B, V) int32 sorted ascending per sample, 16-byte aligned;
// queries (B, Q) int32; outputs (B, Q) int32 each; window_len null or
// (B * ceil(Q / 1024)) int32; all contiguous on the device. A window of
// up to `capacity` keys (a multiple of 4) goes to shared memory, which
// holds capacity + 4 keys (a window starts up to 3 keys into it) and,
// with fence_step > 0, kMaxFences fences: at most 48 KB in all.
extern "C" int ptt_lookup_pmz(const void* keys, const void* queries, int B,
                              int V, int Q, int capacity, int fence_step,
                              void* out_minus, void* out_center, void* out_plus,
                              void* window_len, void* stream) {
  return launch_lookup<false>(keys, queries, B, V, Q, capacity, fence_step, out_minus,
                              out_center, out_plus, window_len, stream);
}

// The center-only form: the same arguments as ptt_lookup_pmz, one output.
extern "C" int ptt_lookup_center(const void* keys, const void* queries, int B,
                                 int V, int Q, int capacity, int fence_step, void* out,
                                 void* window_len, void* stream) {
  return launch_lookup<true>(keys, queries, B, V, Q, capacity, fence_step, nullptr, out,
                             nullptr, window_len, stream);
}
