// Ball query: for each center, the first K point indices (in point
// order) whose masked squared distance is < r², padded with -1.
//
// Replaces the TPU kernel proxytransformation_tpu/ops/ball_query_pallas.py
// ::ball_query_idx_pallas (:100, kernel body _kernel :42). Reference:
// proxytransformation_tpu/ops/ball_query.py::_ball_query_idx (:28),
// which this kernel matches bit for bit.
//
// Bound on the H100: the points are read once from device memory
// (13 bytes each with the mask), then the distance tests are fp32 ALU
// work outside the tensor cores, ~8 operations per point a first-K scan
// visits. A center stops scanning once K slots are filled, so the work
// depends on the data: a center in an empty region walks all N points.
//
// What held the first design back: one warp per center walked the
// points in order, 32 at a time, each step a dependent global load. The
// points come in random order, so no bounding box culls a chunk, and a
// center with fewer than K hits in the cloud walks all N points: N/32
// serial steps (3125 at N = 100k, ~2.1 ms) while the rest of the card
// idles under that tail. Splitting the whole point axis into segments
// that each look for K hits cut that tail but multiplied the work of
// every other center (each segment has to find K hits of its own); and
// tail blocks over tiles of consecutive centers left most warps idle,
// since the centers still short after the first points are few and
// scattered.
//
// Design: a block holds 16 centers, 2 a warp, and runs three steps.
// - Head (one block per 16 consecutive centers): scan the first `head`
//   points in order, write each center's hits straight to the output
//   (padded with -1) and its count, and append each center still short
//   of K to its sample's list (an atomic count, zeroed by a memset).
// - Tail (a persistent grid, a few blocks an SM): work items (segment,
//   16 listed centers of one sample), segment-major, taken from an
//   atomic counter. An item scans its segment of [head, N) for its
//   centers' missing hits, keeping their first hits and count in a
//   workspace; after every chunk it publishes each center's running
//   count and reads back those of the earlier segments (a decoupled
//   look-back, loaded while the chunk is tested), and stops testing a
//   center once its own hits and the earlier segments' reach what the
//   center still needs. Running counts never exceed the final ones, so
//   a segment that stops this way is never read; and the earlier
//   segments are taken first.
// - Merge: the last item of a group (an atomic count per group) takes
//   each center's segments in order and fills its remaining slots,
//   padding with -1: exactly the first K in point order.
// Both passes stage their points through shared memory in 512-point
// chunks as float4 {x, y, z, valid} (the TPU kernel's p4), the next
// chunk's loads in flight in registers while the warps test the current
// one. A warp reads each point once and tests it against its live
// centers: a __ballot_sync over "valid and within radius" per center
// gives the step's hits, a popc of the lanes below each hit its slot, so
// hits land in point order. Staging was measured against each warp
// reading the points straight from global memory: 1.3-1.7x faster on
// the flagship's calls (PERF.md).
//
// Exactness: d² = (dx*dx + dy*dy) + dz*dz with dx = p - c, computed with
// round-to-nearest intrinsics (and -fmad=false) so nothing contracts into
// an FMA that would move points across the radius; the test is a strict
// d² < r².
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPerWarp = 2;                        // centers a warp
constexpr int kGroup = kWarps * kPerWarp;          // centers a block: 16
constexpr int kChunk = 512;                        // points a staged chunk
constexpr int kPointsPerThread = kChunk / kThreads;  // 2
constexpr int kMaxSegments = 32;                   // one merge lane each
constexpr unsigned kFull = 0xffffffffu;

// ctrl workspace (int32): the next tail item, each sample's listed
// centers, then one done count a group of listed centers
constexpr int kNextItem = 0;
constexpr int kListLen = 1;

__device__ __forceinline__ bool within_radius(float4 p, float cx, float cy,
                                              float cz, float r2) {
  const float dx = __fsub_rn(p.x, cx);
  const float dy = __fsub_rn(p.y, cy);
  const float dz = __fsub_rn(p.z, cz);
  const float d2 =
      __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  return p.w != 0.f && d2 < r2;
}

// Point i of the sample as {x, y, z, valid}; {0, 0, 0, 0} past `end`.
__device__ __forceinline__ float4 load_point(const float* __restrict__ pts,
                                             const uint8_t* __restrict__ msk,
                                             int i, int end) {
  if (i >= end) return make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(pts[3 * i + 0], pts[3 * i + 1], pts[3 * i + 2],
                     msk[i] ? 1.f : 0.f);
}

// One warp's centers.
struct Centers {
  float x[kPerWarp], y[kPerWarp], z[kPerWarp];
  long long row[kPerWarp];  // b * M + m
  int need[kPerWarp];       // hits wanted; 0 for no center
  int count[kPerWarp];      // hits seen; identical in every lane
  int* out[kPerWarp];       // where hit t (t < need) goes
  // tail look-back: the center's running counts, one a segment (null in
  // the head), and the hits of earlier segments seen there so far
  int* prog[kPerWarp];
  int earlier[kPerWarp];
};

__device__ __forceinline__ void load_center(const float* __restrict__ centers,
                                            long long row, Centers& c, int j) {
  c.row[j] = row;
  c.x[j] = centers[row * 3 + 0];
  c.y[j] = centers[row * 3 + 1];
  c.z[j] = centers[row * 3 + 2];
  c.count[j] = 0;
  c.earlier[j] = 0;
}

// Test the warp's centers against points [lo, hi) of one sample in
// order, a chunk at a time, until every center has `need` hits with
// those of earlier segments (or the points end). In the tail (`seg` =
// this segment) each center's running count goes to prog[seg] after
// every chunk, and the earlier segments' are read back. Called by every
// thread of the block.
__device__ __forceinline__ void scan_points(const float* __restrict__ pts,
                                            const uint8_t* __restrict__ msk, int lo,
                                            int hi, float r2, int seg, Centers& c,
                                            float4* chunk) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  float4 next[kPointsPerThread];
#pragma unroll
  for (int k = 0; k < kPointsPerThread; ++k)
    next[k] = load_point(pts, msk, lo + threadIdx.x + k * kThreads, hi);
  for (int base = lo; base < hi; base += kChunk) {
#pragma unroll
    for (int k = 0; k < kPointsPerThread; ++k)
      chunk[threadIdx.x + k * kThreads] = next[k];
    __syncthreads();
    // the next chunk's loads stay in flight while the warps test this one
    if (base + kChunk < hi) {
#pragma unroll
      for (int k = 0; k < kPointsPerThread; ++k)
        next[k] = load_point(pts, msk, base + kChunk + threadIdx.x + k * kThreads, hi);
    }
    bool live[kPerWarp];
    bool any = false;
    int ahead[kPerWarp];  // earlier segments' running counts, in flight
#pragma unroll
    for (int j = 0; j < kPerWarp; ++j) {
      live[j] = c.count[j] + c.earlier[j] < c.need[j];
      any |= live[j];
      ahead[j] = live[j] && seg > 0 && lane < seg ? __ldcg(c.prog[j] + lane) : 0;
    }
    if (any) {  // uniform per warp
#pragma unroll 4
      for (int step = 0; step < kChunk / 32; ++step) {
        const int off = step * 32 + lane;
        const float4 p = chunk[off];
#pragma unroll
        for (int j = 0; j < kPerWarp; ++j) {
          const bool within = live[j] && within_radius(p, c.x[j], c.y[j], c.z[j], r2);
          const unsigned hits = __ballot_sync(kFull, within);
          const int slot = c.count[j] + __popc(hits & below);
          if (within && slot < c.need[j]) c.out[j][slot] = base + off;
          c.count[j] += __popc(hits);
        }
      }
    }
    bool full = true;
#pragma unroll
    for (int j = 0; j < kPerWarp; ++j) {
      if (live[j] && seg >= 0) {  // uniform per warp
        if (lane == 0) __stcg(c.prog[j] + seg, min(c.count[j], c.need[j]));
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) ahead[j] += __shfl_xor_sync(kFull, ahead[j], d);
        c.earlier[j] = max(c.earlier[j], ahead[j]);
      }
      full &= c.count[j] + c.earlier[j] >= c.need[j];
    }
    // also the barrier before the next chunk overwrites shared memory
    if (__syncthreads_and(full)) break;
  }
}

// Block = 16 consecutive centers of one sample. Points [0, head): each
// center's hits to out (then -1), min(hits, K) to cnt; a center still
// short of K goes to its sample's list, its running counts to 0.
__global__ void __launch_bounds__(kThreads)
ball_query_head_kernel(const float* __restrict__ centers,
                       const float* __restrict__ points,
                       const uint8_t* __restrict__ mask, int M, int N, int K,
                       float r2, int head, int S, int* __restrict__ cnt,
                       int* __restrict__ ctrl, int* __restrict__ list,
                       int* __restrict__ prog, int* __restrict__ out) {
  __shared__ float4 chunk[kChunk];
  const int lane = threadIdx.x & 31;
  const int groups = (M + kGroup - 1) / kGroup;
  const int b = blockIdx.x / groups;
  Centers c;
#pragma unroll
  for (int j = 0; j < kPerWarp; ++j) {
    const int m = (blockIdx.x % groups) * kGroup + j * kWarps + (threadIdx.x >> 5);
    load_center(centers, static_cast<long long>(b) * M + min(m, M - 1), c, j);
    c.need[j] = m < M ? K : 0;
    c.out[j] = out + c.row[j] * K;
    c.prog[j] = nullptr;
  }
  scan_points(points + static_cast<long long>(b) * N * 3,
              mask + static_cast<long long>(b) * N, 0, head, r2, -1, c, chunk);
#pragma unroll
  for (int j = 0; j < kPerWarp; ++j) {
    if (c.need[j] == 0) continue;  // uniform per warp
    const int n = min(c.count[j], K);
    for (int s = n + lane; s < K; s += 32) c.out[j][s] = -1;
    if (n < K)
      for (int s = lane; s < S; s += 32) prog[c.row[j] * S + s] = 0;
    if (lane == 0) {
      cnt[c.row[j]] = n;
      if (n < K)
        list[static_cast<long long>(b) * M + atomicAdd(ctrl + kListLen + b, 1)] =
            static_cast<int>(c.row[j] - static_cast<long long>(b) * M);
    }
  }
}

// Persistent: items (segment s, group g of 16 listed centers of one
// sample), s-major, over [head, N). Each listed center's first missing
// hits in the segment go to ws_idx[(row * S + s) * K ...], their number
// to ws_cnt[row * S + s]; the group's last item fills out[row][cnt .. K)
// from the segments in order.
__global__ void __launch_bounds__(kThreads)
ball_query_tail_kernel(const float* __restrict__ centers,
                       const float* __restrict__ points,
                       const uint8_t* __restrict__ mask, int B, int M, int N, int K,
                       float r2, int head, int S, int seg_len,
                       const int* __restrict__ cnt, int* __restrict__ ctrl,
                       const int* __restrict__ list, int* __restrict__ prog,
                       int* __restrict__ ws_idx, int* __restrict__ ws_cnt,
                       int* __restrict__ out) {
  __shared__ float4 chunk[kChunk];
  __shared__ int item;
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  int groups = 0;  // listed groups of all samples (the head kernel has ended)
  for (int b = 0; b < B; ++b) groups += (__ldcg(ctrl + kListLen + b) + kGroup - 1) / kGroup;
  int* group_done = ctrl + kListLen + B;
  for (;;) {
    if (threadIdx.x == 0) item = atomicAdd(ctrl + kNextItem, 1);
    __syncthreads();
    const int it = item;
    if (it >= S * groups) break;  // uniform per block
    const int s = it / groups;
    const int gg = it % groups;
    int b = 0, g = gg, listed = 0;  // the group's sample and place in its list
    for (;; ++b) {
      listed = __ldcg(ctrl + kListLen + b);
      const int n = (listed + kGroup - 1) / kGroup;
      if (g < n) break;
      g -= n;
    }
    const long long row0 = static_cast<long long>(b) * M;
    Centers c;
#pragma unroll
    for (int j = 0; j < kPerWarp; ++j) {
      const int li = g * kGroup + j * kWarps + (threadIdx.x >> 5);
      const long long row = row0 + (li < listed ? __ldcg(list + row0 + li) : 0);
      load_center(centers, row, c, j);
      c.need[j] = li < listed ? K - cnt[row] : 0;
      c.out[j] = ws_idx + (row * S + s) * K;
      c.prog[j] = prog + row * S;
    }
    const int seg_lo = min(N, head + s * seg_len);
    const int seg_hi = min(N, seg_lo + seg_len);
    scan_points(points + static_cast<long long>(b) * N * 3,
                mask + static_cast<long long>(b) * N, seg_lo, seg_hi, r2, s, c, chunk);
#pragma unroll
    for (int j = 0; j < kPerWarp; ++j) {
      if (c.need[j] > 0 && lane == 0)
        ws_cnt[c.row[j] * S + s] = min(c.count[j], c.need[j]);
    }
    // the last of the group's S items merges (threadfence reduction)
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(group_done + gg, 1) == S - 1;
    __syncthreads();
    if (last) {
      __threadfence();
#pragma unroll
      for (int j = 0; j < kPerWarp; ++j) {
        if (c.need[j] <= 0) continue;  // uniform per warp
        const long long row = c.row[j];
        const int n = lane < S ? __ldcg(ws_cnt + row * S + lane) : 0;
        int incl = n;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(kFull, incl, d);
          if (lane >= d) incl += y;
        }
        const int excl = incl - n;
        const int total = __shfl_sync(kFull, incl, 31);
        const int have = K - c.need[j];
        for (int t0 = 0; t0 < c.need[j]; t0 += 32) {
          const int t = t0 + lane;
          int seg = 0;  // segments whose hits all come before tail slot t
          for (int u = 0; u < S; ++u) seg += __shfl_sync(kFull, incl, u) <= t;
          const int start = __shfl_sync(kFull, excl, min(seg, 31));
          if (t < c.need[j])
            out[row * K + have + t] =
                t < total ? __ldcg(ws_idx + (row * S + seg) * K + (t - start)) : -1;
        }
      }
    }
    __syncthreads();  // before thread 0 takes the next item
  }
}

}  // namespace

// centers (B, M, 3) f32, points (B, N, 3) f32, mask (B, N) bool,
// out (B, M, K) int32; workspaces (int32) cnt (B*M), ctrl (1 + B +
// ceil(M / 16) * B), list (B*M), prog (B*M, S), ws_idx (B*M, S, K) and
// ws_cnt (B*M, S); all contiguous on the device. The head pass covers
// points [0, head); tail segment s covers [head + s * seg_len,
// min(N, head + (s + 1) * seg_len)); the tail runs `tail_blocks`
// persistent blocks.
extern "C" int ptt_ball_query(const void* centers, const void* points,
                              const void* mask, int B, int M, int N, int K,
                              float r2, int head, int segments, int seg_len,
                              int tail_blocks, void* cnt, void* ctrl,
                              void* list, void* prog, void* ws_idx, void* ws_cnt,
                              void* out, void* stream) {
  if (segments < 1 || segments > kMaxSegments || seg_len < 0 || head < 0 ||
      tail_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(B) * M > 0 && K > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int groups = (M + kGroup - 1) / kGroup;
    const size_t ctrl_bytes = (kListLen + B + static_cast<size_t>(B) * groups) * sizeof(int);
    cudaError_t err = cudaMemsetAsync(ctrl, 0, ctrl_bytes, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    ball_query_head_kernel<<<B * groups, kThreads, 0, st>>>(
        static_cast<const float*>(centers), static_cast<const float*>(points),
        static_cast<const uint8_t*>(mask), M, N, K, r2, head, segments,
        static_cast<int*>(cnt), static_cast<int*>(ctrl), static_cast<int*>(list),
        static_cast<int*>(prog), static_cast<int*>(out));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ball_query_tail_kernel<<<tail_blocks, kThreads, 0, st>>>(
        static_cast<const float*>(centers), static_cast<const float*>(points),
        static_cast<const uint8_t*>(mask), B, M, N, K, r2, head, segments, seg_len,
        static_cast<const int*>(cnt), static_cast<int*>(ctrl),
        static_cast<const int*>(list), static_cast<int*>(prog),
        static_cast<int*>(ws_idx), static_cast<int*>(ws_cnt), static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
