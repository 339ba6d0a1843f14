// Sparse convolution as a gather-GEMM:
//   out[b, v] = sum_k feats[b, nbr[b, v, k]] @ W[k]   over hits (nbr >= 0),
// zero at masked outputs. float32 in, float32 accumulate, no TF32. The
// conv's backward launches the same code for the input gradient (a conv
// of the output gradient over the mirrored or reversed map); the two
// roles are distinct kernel symbols (sparse_conv_fwd_* and
// sparse_conv_dfeats_*) so a profile tells them apart.
//
// Replaces the TPU kernels of proxytransformation_tpu/ops/
// sparse_conv_pallas.py::sparse_conv_gather_gemm_colwin (:744; bodies
// _make_colwin_kernel :498 and the opt-in _make_colfold_kernel :624).
// It takes any neighbor map, column-structured or not, so it also
// computes the function of ::sparse_conv_gather_gemm (:177). Reference:
// proxytransformation_tpu/ops/sparse.py::sparse_conv_apply (:545), the
// float32 CPU path (the TPU kernels cast to bf16; this one does not).
//
// Bound on the H100: fp32 operations outside the tensor cores (67 TFLOP/s)
// for the wide stages, 2 * hits * C_in * C_out; device-memory bytes for
// the stem (C_in = 3), whose 100k x 27 map dominates what it reads.
//
// Design. The TPU kernels precompute per-tile windows on the XLA side
// and scalar-prefetch them; here the per-map plan (ops/sparse.py::
// conv_plan) gives each row's hit mask (bit k: nbr[b, v, k] >= 0) and the
// rows of each sample stably sorted by that mask, so rows with the same
// hit pattern share tiles.
//  * Tile path: a block owns 128 sorted rows x 128 output channels (64
//    where C_out <= 64); 256 threads each hold an 8 x 8 (8 x 4) register
//    sub-tile. It ORs its rows' masks (integer OR, order free) and walks
//    only the offsets whose bit is set, loading their map entries once.
//    The (offset, 16-channel) steps stream through a 4-stage
//    shared-memory ring filled by cp.async (16-byte copies where
//    C_in % 4 == 0, else 4-byte; a miss is a zero-filled copy, no
//    branch): three steps' gathered rows and W[k] slices are in flight
//    while one multiplies. Each step's rows are transposed once in
//    shared memory to channel-major, so a thread reads its 8 rows and 8
//    (4) channels of one input channel as 4 (3) float4s for 64 (32)
//    multiply-adds; one barrier a step. A warp owns 16 neighbouring
//    sorted rows and skips the multiply of a step whose offset none of
//    them hits. Each output row's sum runs over k
//    ascending, then c ascending, whatever the row order; rows are
//    written back to their original positions. TMA does not serve here:
//    it copies boxes, not index-gathered rows.
//  * Small levels (fewer than ~3 waves of two blocks an SM): the tile's
//    steps are cut into `splits` ranges, one block each, writing partial
//    outputs to a workspace that a second kernel adds in split order
//    (deterministic).
//  * Narrow input (C_in <= 4, the stem): a warp walks one row's map entries
//    (one coalesced load, a ballot of the hits), W[:, :, 64-col tile] in
//    shared memory, each lane two output channels; bound by the map bytes.
//  * Narrow output (C_out <= 4, the stem's input gradient): a warp walks a
//    row's hits, its lanes split the gathered row's channels, W in shared
//    memory as one float4 per (k, c), and a fixed butterfly adds the lanes.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 128;      // mask-sorted rows per tile block
constexpr int kTileN = 64;      // output channels per narrow-path block
constexpr int kStepC = 16;      // input channels per pipeline step
constexpr int kStrideA = kRows + 4;  // padded k-major row of the A tile
constexpr int kStages = 4;      // cp.async ring depth
// rows a warp walks in the narrow paths; the narrow-output path gathers a
// whole C_in-wide row per hit, and more warps of fewer rows keep more of
// those gathers in flight
constexpr int kNarrowInRows = 32;
constexpr int kNarrowOutRows = 8;

struct ConvArgs {
  const float* feats;       // (B, V_in, C_in)
  const int* nbr;           // (B, V_out, K3)
  const float* w;           // (K3, C_in, C_out)
  const uint8_t* out_mask;  // (B, V_out)
  const int* row_mask;      // (B, V_out)
  const int* order;         // (B, V_out)
  int B, V_in, V_out, K3, C_in, C_out, splits;
  bool vec_a, vec_w, vec_o;
  float* out;  // (B, V_out, C_out), or the (splits, B, V_out, C_out) workspace
};

// A tile of kRows rows x 16 * TN output channels (TN = 4 or 8).
template <int TN>
struct TileSmem {
  float staged[kStages][kRows * kStepC];    // gathered rows as copied, row-major
  float a[2][kStepC * kStrideA];            // the same, channel-major
  float w[kStages][kStepC * 16 * TN];       // W[k][c0:c0+16, n0:n0+16*TN]
  TileRows<kRows, 16> t;                    // rows, map entries; OR of each warp's 16 rows' masks
};

// the tile row of sub-tile row i (8 a thread, contiguous) of thread-row
// ty: warp w holds tile rows 16w..16w+15
__device__ __forceinline__ int tile_row(int i, int ty) { return ty * 8 + i; }

template <int TN>
__device__ __forceinline__ void conv_tile(const ConvArgs& p) {
  constexpr int BN = 16 * TN;  // output channels per block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TileSmem<TN>& s = *reinterpret_cast<TileSmem<TN>*>(smem_raw);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.z / p.splits, split = blockIdx.z % p.splits;
  const int t0 = blockIdx.x * kRows, n0 = blockIdx.y * BN;
  const long long rb = static_cast<long long>(b) * p.V_out;

  // 1-2. the tile's rows in mask order, the OR of each warp's 16 rows'
  // masks (sorted neighbours, so similar masks) and of the tile's, and the
  // map entries of the active offsets
  const int n_act = load_tile_rows<kRows, 16, kThreads>(p.order, p.out_mask, p.row_mask, rb, t0,
                                                        p.V_out, s.t);
  for (int e = tid; e < n_act * kRows; e += kThreads) {
    const int j = e / kRows, t = e % kRows;
    s.t.idx[j][t] = s.t.keep[t] ? p.nbr[(rb + s.t.rows[t]) * p.K3 + s.t.act[j]] : -1;
  }
  __syncthreads();

  // 3. this block's range of (offset, channel-step) steps
  const int n_c = (p.C_in + kStepC - 1) / kStepC;
  const long long total = static_cast<long long>(n_act) * n_c;
  const int s_begin = static_cast<int>(total * split / p.splits);
  const int n_steps = static_cast<int>(total * (split + 1) / p.splits) - s_begin;
  const float* fb = p.feats + static_cast<long long>(b) * p.V_in * p.C_in;

  // A: 16-byte copies of the gathered rows into a row-major staging ring,
  // four lanes per row; W: 16-byte copies where C_out % 4 == 0.
  auto load = [&](int step, int stage) {
    const int j = step / n_c;
    const int c0 = (step - j * n_c) * kStepC;
    const int* idx = s.t.idx[j];
    float* a = s.staged[stage];
    if (p.vec_a) {
#pragma unroll
      for (int i = 0; i < kRows * kStepC / 4 / kThreads; ++i) {
        const int e = tid + i * kThreads;
        const int t = e / (kStepC / 4), c = e % (kStepC / 4) * 4;
        const int id = idx[t];
        const bool ok = id >= 0 && c0 + c < p.C_in;
        cp_async16(a + t * kStepC + c,
                   ok ? fb + static_cast<long long>(id) * p.C_in + c0 + c : fb, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kRows * kStepC / kThreads; ++i) {
        const int e = tid + i * kThreads;
        const int t = e / kStepC, c = e % kStepC;
        const int id = idx[t];
        const bool ok = id >= 0 && c0 + c < p.C_in;
        cp_async4(a + e, ok ? fb + static_cast<long long>(id) * p.C_in + c0 + c : fb, ok);
      }
    }
    const float* wk = p.w + static_cast<long long>(s.t.act[j]) * p.C_in * p.C_out;
    float* w = s.w[stage];
    if (p.vec_w) {
#pragma unroll
      for (int i = 0; i < kStepC * BN / 4 / kThreads; ++i) {
        const int e = tid + i * kThreads;
        const int c = e / (BN / 4), q = e % (BN / 4) * 4;
        const bool ok = c0 + c < p.C_in && n0 + q < p.C_out;
        cp_async16(w + c * BN + q,
                   ok ? wk + static_cast<long long>(c0 + c) * p.C_out + n0 + q : wk, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kStepC * BN / kThreads; ++i) {
        const int e = tid + i * kThreads;
        const int c = e / BN, q = e % BN;
        const bool ok = c0 + c < p.C_in && n0 + q < p.C_out;
        cp_async4(w + e, ok ? wk + static_cast<long long>(c0 + c) * p.C_out + n0 + q : wk,
                  ok);
      }
    }
  };
  // staged step -> channel-major buffer, so a thread reads its 8 rows of
  // one channel as two float4
  auto transpose = [&](int stage, int buf) {
    const float* src = s.staged[stage];
    float* dst = s.a[buf];
#pragma unroll
    for (int i = 0; i < kRows * kStepC / 4 / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int t = e / (kStepC / 4), c = e % (kStepC / 4) * 4;
      const float4 v = *reinterpret_cast<const float4*>(src + t * kStepC + c);
      dst[(c + 0) * kStrideA + t] = v.x;
      dst[(c + 1) * kStrideA + t] = v.y;
      dst[(c + 2) * kStrideA + t] = v.z;
      dst[(c + 3) * kStrideA + t] = v.w;
    }
  };

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // 4. the pipeline. Iteration st: step st+1 lands and is transposed,
  // step st+3 is copied, step st multiplies; one barrier a step.
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_steps) load(s_begin + st, st);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  __syncthreads();
  if (n_steps > 0) transpose(0, 0);
  for (int st = 0; st < n_steps; ++st) {
    cp_async_wait<kStages - 3>();
    __syncthreads();
    const int ahead = st + kStages - 1;
    if (ahead < n_steps) load(s_begin + ahead, ahead % kStages);
    cp_async_commit();
    if (st + 1 < n_steps) transpose((st + 1) % kStages, (st + 1) & 1);
    // a warp none of whose 16 rows hits this step's offset skips it
    if (!((s.t.grp_or[tid / 32] >> s.t.act[(s_begin + st) / n_c]) & 1u)) continue;
    const float* a = s.a[st & 1];
    const float* w = s.w[st % kStages];
#pragma unroll
    for (int c = 0; c < kStepC; ++c) {
      const float4 a0 = *reinterpret_cast<const float4*>(a + c * kStrideA + ty * 8);
      const float4 a1 = *reinterpret_cast<const float4*>(a + c * kStrideA + ty * 8 + 4);
      float4 wv[TN / 4];
#pragma unroll
      for (int q = 0; q < TN / 4; ++q)
        wv[q] = *reinterpret_cast<const float4*>(w + c * BN + q * 64 + tx * 4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float x = lane4(i < 4 ? a0 : a1, i % 4);
#pragma unroll
        for (int q = 0; q < TN / 4; ++q) {
          acc[i][q * 4 + 0] = fmaf(x, wv[q].x, acc[i][q * 4 + 0]);
          acc[i][q * 4 + 1] = fmaf(x, wv[q].y, acc[i][q * 4 + 1]);
          acc[i][q * 4 + 2] = fmaf(x, wv[q].z, acc[i][q * 4 + 2]);
          acc[i][q * 4 + 3] = fmaf(x, wv[q].w, acc[i][q * 4 + 3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // 5. write back to the original rows; zero at masked outputs
  float* ob = p.out + (static_cast<long long>(split) * p.B + b) * p.V_out * p.C_out;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = tile_row(i, ty);
    const int v = s.t.rows[t];
    if (v < 0) continue;
    const bool keep = s.t.keep[t] != 0;
    float* o = ob + static_cast<long long>(v) * p.C_out;
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) {
      const int n = n0 + q * 64 + tx * 4;
      if (n >= p.C_out) continue;
      const float4 r = keep ? make_float4(acc[i][q * 4], acc[i][q * 4 + 1],
                                          acc[i][q * 4 + 2], acc[i][q * 4 + 3])
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      if (p.vec_o) {
        *reinterpret_cast<float4*>(o + n) = r;
      } else {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (n + jj < p.C_out) o[n + jj] = lane4(r, jj);
      }
    }
  }
}

// C_in <= 4: a warp per row, lanes over two 32-wide halves of the
// block's 64 output channels.
__device__ __forceinline__ void conv_narrow_in(const ConvArgs& p) {
  __shared__ float w_s[kMaxK3 * 4 * kTileN];
  const int n0 = blockIdx.y * kTileN;
  for (int e = threadIdx.x; e < p.K3 * p.C_in * kTileN; e += kThreads) {
    const int kc = e / kTileN, n = e % kTileN;
    w_s[e] = n0 + n < p.C_out ? p.w[static_cast<long long>(kc) * p.C_out + n0 + n] : 0.f;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long R = static_cast<long long>(p.B) * p.V_out;
  const long long r0 =
      (static_cast<long long>(blockIdx.x) * (kThreads / 32) + warp) * kNarrowInRows;
  const long long r1 = r0 + kNarrowInRows < R ? r0 + kNarrowInRows : R;
  for (long long r = r0; r < r1; ++r) {
    const long long b = r / p.V_out;
    float acc0 = 0.f, acc1 = 0.f;
    if (p.out_mask[r]) {
      const int id_l = lane < p.K3 ? p.nbr[r * p.K3 + lane] : -1;
      unsigned hits = __ballot_sync(0xffffffffu, id_l >= 0);
      while (hits) {
        const int k = __ffs(hits) - 1;
        hits &= hits - 1;
        const int id = __shfl_sync(0xffffffffu, id_l, k);
        const float* f = p.feats + (b * p.V_in + id) * p.C_in;
        const float* wk = w_s + k * p.C_in * kTileN;
        for (int c = 0; c < p.C_in; ++c) {
          const float x = __ldg(f + c);
          acc0 = fmaf(x, wk[c * kTileN + lane], acc0);
          acc1 = fmaf(x, wk[c * kTileN + 32 + lane], acc1);
        }
      }
    }
    float* o = p.out + r * p.C_out + n0;
    if (n0 + lane < p.C_out) o[lane] = acc0;
    if (n0 + 32 + lane < p.C_out) o[32 + lane] = acc1;
  }
}

// C_out <= 4: a warp per row, lanes over the gathered row's channels.
__device__ __forceinline__ void conv_narrow_out(const ConvArgs& p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* w_s = reinterpret_cast<float4*>(smem_raw);  // (K3 * C_in) x 4 outputs
  for (int e = threadIdx.x; e < p.K3 * p.C_in; e += kThreads) {
    const float* src = p.w + static_cast<long long>(e) * p.C_out;
    w_s[e] = make_float4(src[0], p.C_out > 1 ? src[1] : 0.f, p.C_out > 2 ? src[2] : 0.f,
                         p.C_out > 3 ? src[3] : 0.f);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long R = static_cast<long long>(p.B) * p.V_out;
  const long long r0 =
      (static_cast<long long>(blockIdx.x) * (kThreads / 32) + warp) * kNarrowOutRows;
  const long long r1 = r0 + kNarrowOutRows < R ? r0 + kNarrowOutRows : R;
  for (long long r = r0; r < r1; ++r) {
    const long long b = r / p.V_out;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p.out_mask[r]) {
      const int id_l = lane < p.K3 ? p.nbr[r * p.K3 + lane] : -1;
      unsigned hits = __ballot_sync(0xffffffffu, id_l >= 0);
      while (hits) {
        const int k = __ffs(hits) - 1;
        hits &= hits - 1;
        const int id = __shfl_sync(0xffffffffu, id_l, k);
        const float* f = p.feats + (b * p.V_in + id) * p.C_in;
        const float4* wk = w_s + k * p.C_in;
        for (int c = lane; c < p.C_in; c += 32) {
          const float x = __ldg(f + c);
          const float4 wv = wk[c];
          acc.x = fmaf(x, wv.x, acc.x);
          acc.y = fmaf(x, wv.y, acc.y);
          acc.z = fmaf(x, wv.z, acc.z);
          acc.w = fmaf(x, wv.w, acc.w);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc.x += __shfl_xor_sync(0xffffffffu, acc.x, off);
        acc.y += __shfl_xor_sync(0xffffffffu, acc.y, off);
        acc.z += __shfl_xor_sync(0xffffffffu, acc.z, off);
        acc.w += __shfl_xor_sync(0xffffffffu, acc.w, off);
      }
    }
    if (lane < p.C_out) p.out[r * p.C_out + lane] = lane4(acc, lane);
  }
}

// the forward and the input gradient: one body, two symbols each
template <int TN>
__global__ void __launch_bounds__(kThreads, 2) sparse_conv_fwd_tile(ConvArgs p) {
  conv_tile<TN>(p);
}
template <int TN>
__global__ void __launch_bounds__(kThreads, 2) sparse_conv_dfeats_tile(ConvArgs p) {
  conv_tile<TN>(p);
}
__global__ void __launch_bounds__(kThreads) sparse_conv_fwd_narrow_in(ConvArgs p) {
  conv_narrow_in(p);
}
__global__ void __launch_bounds__(kThreads) sparse_conv_dfeats_narrow_in(ConvArgs p) {
  conv_narrow_in(p);
}
__global__ void __launch_bounds__(kThreads) sparse_conv_fwd_narrow_out(ConvArgs p) {
  conv_narrow_out(p);
}
__global__ void __launch_bounds__(kThreads) sparse_conv_dfeats_narrow_out(ConvArgs p) {
  conv_narrow_out(p);
}
__global__ void sparse_conv_fwd_sum(const float* ws, long long n, int S, float* out) {
  sum_splits(ws, n, S, out);
}
__global__ void sparse_conv_dfeats_sum(const float* ws, long long n, int S, float* out) {
  sum_splits(ws, n, S, out);
}

using ConvKernel = void (*)(ConvArgs);
using SumKernel = void (*)(const float*, long long, int, float*);

}  // namespace

// feats (B, V_in, C_in) f32, nbr (B, V_out, K3) int32, weights
// (K3, C_in, C_out) f32, out_mask (B, V_out) bool, row_mask and order
// (B, V_out) int32 from the map's plan, out (B, V_out, C_out) f32; all
// contiguous on the device. role 0 = forward, 1 = input gradient (only the
// kernel symbols differ). path 0 = tile (cols 128 or 64 output channels
// a block; splits >= 1, and for splits > 1 `workspace` holds
// splits * B * V_out * C_out floats),
// 1 = narrow input (C_in <= 4), 2 = narrow output (C_out <= 4).
extern "C" int ptt_sparse_conv(const void* feats, const void* nbr, const void* weights,
                               const void* out_mask, const void* row_mask,
                               const void* order, int B, int V_in, int V_out, int K3,
                               int C_in, int C_out, int role, int path, int cols,
                               int splits, void* workspace, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K3 < 1 || K3 > kMaxK3 || splits < 1 || (role != 0 && role != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || V_out <= 0 || C_out <= 0) return static_cast<int>(cudaGetLastError());
  ConvArgs p;
  p.feats = static_cast<const float*>(feats);
  p.nbr = static_cast<const int*>(nbr);
  p.w = static_cast<const float*>(weights);
  p.out_mask = static_cast<const uint8_t*>(out_mask);
  p.row_mask = static_cast<const int*>(row_mask);
  p.order = static_cast<const int*>(order);
  p.B = B; p.V_in = V_in; p.V_out = V_out; p.K3 = K3; p.C_in = C_in; p.C_out = C_out;
  p.splits = path == 0 ? splits : 1;
  p.vec_a = C_in % 4 == 0 && aligned16(feats);
  p.vec_w = C_out % 4 == 0 && aligned16(weights);
  float* target = p.splits > 1 ? static_cast<float*>(workspace) : static_cast<float*>(out);
  p.vec_o = C_out % 4 == 0 && aligned16(target);
  p.out = target;
  const long long R = static_cast<long long>(B) * V_out;
  // blocks of kThreads / 32 warps, each warp `rows` rows
  auto narrow_blocks = [&](int rows) {
    const long long per_block = (kThreads / 32) * rows;
    return static_cast<unsigned>((R + per_block - 1) / per_block);
  };
  if (path == 1) {
    if (C_in > 4) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(narrow_blocks(kNarrowInRows), (C_out + kTileN - 1) / kTileN);
    const ConvKernel kernel =
        role == 0 ? &sparse_conv_fwd_narrow_in : &sparse_conv_dfeats_narrow_in;
    kernel<<<grid, kThreads, 0, st>>>(p);
  } else if (path == 2) {
    const size_t smem = static_cast<size_t>(K3) * C_in * sizeof(float4);
    if (C_out > 4 || smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
    const ConvKernel kernel =
        role == 0 ? &sparse_conv_fwd_narrow_out : &sparse_conv_dfeats_narrow_out;
    kernel<<<narrow_blocks(kNarrowOutRows), kThreads, smem, st>>>(p);
  } else if (path == 0) {
    ConvKernel kernel;
    size_t smem;
    if (cols == 128) {
      kernel = role == 0 ? &sparse_conv_fwd_tile<8> : &sparse_conv_dfeats_tile<8>;
      smem = sizeof(TileSmem<8>);
    } else if (cols == 64) {
      kernel = role == 0 ? &sparse_conv_fwd_tile<4> : &sparse_conv_dfeats_tile<4>;
      smem = sizeof(TileSmem<4>);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t e = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid((V_out + kRows - 1) / kRows, (C_out + cols - 1) / cols, B * p.splits);
    kernel<<<grid, kThreads, smem, st>>>(p);
    if (p.splits > 1) {
      const long long n = R * C_out;
      const SumKernel sum = role == 0 ? &sparse_conv_fwd_sum : &sparse_conv_dfeats_sum;
      sum<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
          static_cast<const float*>(workspace), n, p.splits, static_cast<float*>(out));
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
