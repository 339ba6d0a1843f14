// Weight gradient of the sparse convolution:
//   dW[k] = sum_{b, v} feats[b, nbr[b, v, k]]^T g[b, v]   over hits (nbr >= 0),
// with g already zero at masked outputs. float32 in, float32 accumulate,
// no TF32, no float atomics: the result is the same bits run to run.
//
// Replaces the TPU kernel of proxytransformation_tpu/ops/
// sparse_conv_pallas.py::sparse_conv_dw_gather_gemm (:399; body
// _make_dw_kernel :278), which the conv's backward launches once per
// K3 > 1 conv (ops/sparse.py:510). Reference: autograd's dW of
// ops/sparse.py::sparse_conv_apply (:545), the float32 CPU path.
//
// Bound on the H100: 2 * hits * C_in * C_out float32 operations outside
// the tensor cores (67 TFLOP/s), or the bytes of feats, nbr, g and dW
// over 3.35 TB/s, whichever is larger.
//
// Design. The per-map plan (ops/sparse.py::conv_plan) holds, for each
// offset k, the flattened rows r = b * V_out + v that hit it, in row
// order, and their count on the device. The hits of all offsets are cut
// into chunks of equal size (the count is read on the device, so the
// host never waits): chunk = clamp(ceil(H / pairs_target), 256, 4096)
// for H hits in all, and offset k takes ceil(count_k / chunk) splits.
// Every block derives that table from the counts, so the grid is sized
// for the worst case and blocks past the last split return at once.
//  * Tile path: a block owns (offset k, one split of k's hits, a C_in
//    tile of 128 or 64, a C_out tile of 128 or 64); 256 threads each hold
//    an 8 x 8 (down to 4 x 4) sub-tile of dW[k]. It loads its split's
//    rows and their input rows (nbr[r, k]) once, then streams 16 hits a step
//    through a 3-stage cp.async ring: the gathered feats rows and the g
//    rows, exactly at the hits, so no zero row is multiplied; float4
//    shared reads. Each split writes its partial tile to a workspace.
//  * Narrow path (C_in <= 4, the stem): a block owns (k, split, 64 C_out
//    columns); four groups of 64 threads take every fourth hit, each
//    thread C_in sums for its column, and the groups add in a fixed order.
//  * A second kernel adds each element's splits in split order.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileN = 64;       // output (g) channels per narrow-path block
constexpr int kStepH = 16;       // hits per pipeline step
constexpr int kStages = 3;       // cp.async ring depth

struct DwArgs {
  const float* feats;   // (B, V_in, C_in)
  const int* nbr;       // (B, V_out, K3)
  const float* g;       // (B, V_out, C_out)
  const int* hits;      // (K3, R) hit rows of each offset, row order
  const int* counts;    // (K3,)
  int V_in, V_out, K3, C_in, C_out, pairs_target;
  long long R;
  bool vec_a, vec_g, vec_o;
  float* ws;            // (pairs, C_in, C_out) partial sums
};

// A block's tile of dW[k]: 16 * TM input x 16 * TN output channels.
template <int TM, int TN>
struct DwSmem {
  float a[kStages][kStepH * 16 * TM];  // gathered feats rows (hit-major)
  float g[kStages][kStepH * 16 * TN];  // g rows at the hits
  int r[kMaxChunk];
  int id[kMaxChunk];
  SplitTable t;
};

template <int TM, int TN>
__device__ __forceinline__ void dw_tile(const DwArgs& p) {
  constexpr int BM = 16 * TM;  // input channels per block
  constexpr int BN = 16 * TN;  // output channels per block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DwSmem<TM, TN>& s = *reinterpret_cast<DwSmem<TM, TN>*>(smem_raw);
  const Split sp = load_split<kThreads>(p, s.t, s.r, s.id);
  if (sp.nh == 0) return;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int c_tiles = (p.C_in + BM - 1) / BM;
  const int c0 = blockIdx.y % c_tiles * BM, n0 = blockIdx.y / c_tiles * BN;
  const int n_steps = (sp.nh + kStepH - 1) / kStepH;

  auto load = [&](int step, int stage) {
    const int hb = step * kStepH;
    float* a = s.a[stage];
    float* gs = s.g[stage];
    if (p.vec_a) {
#pragma unroll
      for (int i = 0; i < kStepH * BM / 4 / kThreads; ++i) {
        const int e = tid + i * kThreads;
        const int h = e / (BM / 4), q = e % (BM / 4) * 4;
        const int hh = hb + h;
        const bool ok = hh < sp.nh && c0 + q < p.C_in;
        const float* src = p.feats;
        if (ok) {
          const long long b = s.r[hh] / p.V_out;
          src += (b * p.V_in + s.id[hh]) * p.C_in + c0 + q;
        }
        cp_async16(a + h * BM + q, src, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kStepH * BM / kThreads; ++i) {
        const int e = tid + i * kThreads;
        const int h = e / BM, q = e % BM;
        const int hh = hb + h;
        const bool ok = hh < sp.nh && c0 + q < p.C_in;
        const float* src = p.feats;
        if (ok) {
          const long long b = s.r[hh] / p.V_out;
          src += (b * p.V_in + s.id[hh]) * p.C_in + c0 + q;
        }
        cp_async4(a + e, src, ok);
      }
    }
    if (p.vec_g) {
#pragma unroll
      for (int i = 0; i < kStepH * BN / 4 / kThreads; ++i) {
        const int e = tid + i * kThreads;
        const int h = e / (BN / 4), q = e % (BN / 4) * 4;
        const int hh = hb + h;
        const bool ok = hh < sp.nh && n0 + q < p.C_out;
        const float* src =
            ok ? p.g + static_cast<long long>(s.r[hh]) * p.C_out + n0 + q : p.g;
        cp_async16(gs + h * BN + q, src, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kStepH * BN / kThreads; ++i) {
        const int e = tid + i * kThreads;
        const int h = e / BN, q = e % BN;
        const int hh = hb + h;
        const bool ok = hh < sp.nh && n0 + q < p.C_out;
        const float* src =
            ok ? p.g + static_cast<long long>(s.r[hh]) * p.C_out + n0 + q : p.g;
        cp_async4(gs + e, src, ok);
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_steps) load(st, st);
    cp_async_commit();
  }
  for (int st = 0; st < n_steps; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int ahead = st + kStages - 1;
    if (ahead < n_steps) load(ahead, ahead % kStages);
    cp_async_commit();
    const float* a = s.a[st % kStages];
    const float* gs = s.g[st % kStages];
#pragma unroll
    for (int h = 0; h < kStepH; ++h) {
      float4 av[TM / 4], gv[TN / 4];
#pragma unroll
      for (int q = 0; q < TM / 4; ++q)
        av[q] = *reinterpret_cast<const float4*>(a + h * BM + q * 64 + ty * 4);
#pragma unroll
      for (int q = 0; q < TN / 4; ++q)
        gv[q] = *reinterpret_cast<const float4*>(gs + h * BN + q * 64 + tx * 4);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float x = lane4(av[i / 4], i % 4);
#pragma unroll
        for (int q = 0; q < TN / 4; ++q) {
          acc[i][q * 4 + 0] = fmaf(x, gv[q].x, acc[i][q * 4 + 0]);
          acc[i][q * 4 + 1] = fmaf(x, gv[q].y, acc[i][q * 4 + 1]);
          acc[i][q * 4 + 2] = fmaf(x, gv[q].z, acc[i][q * 4 + 2]);
          acc[i][q * 4 + 3] = fmaf(x, gv[q].w, acc[i][q * 4 + 3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  float* out = p.ws + static_cast<long long>(blockIdx.x) * p.C_in * p.C_out;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int c = c0 + (i / 4) * 64 + ty * 4 + (i % 4);
    if (c >= p.C_in) continue;
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) {
      const int n = n0 + q * 64 + tx * 4;
      if (n >= p.C_out) continue;
      float* o = out + static_cast<long long>(c) * p.C_out + n;
      if (p.vec_o) {
        *reinterpret_cast<float4*>(o) = make_float4(acc[i][q * 4], acc[i][q * 4 + 1],
                                                    acc[i][q * 4 + 2], acc[i][q * 4 + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < p.C_out) o[j] = acc[i][q * 4 + j];
      }
    }
  }
}

// C_in <= 4: four groups of 64 threads, one output column each.
__device__ __forceinline__ void dw_narrow(const DwArgs& p) {
  __shared__ SplitTable t;
  __shared__ int r_s[kMaxChunk];
  __shared__ int id_s[kMaxChunk];
  __shared__ float red[4][4][kTileN];
  const Split sp = load_split<kThreads>(p, t, r_s, id_s);
  if (sp.nh == 0) return;
  const int q = threadIdx.x / kTileN, nn = threadIdx.x % kTileN;
  const int n = blockIdx.y * kTileN + nn;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (n < p.C_out) {
#pragma unroll 4
    for (int h = q; h < sp.nh; h += 4) {
      const int r = r_s[h];
      const long long b = r / p.V_out;
      const float gv = p.g[static_cast<long long>(r) * p.C_out + n];
      const float* f = p.feats + (b * p.V_in + id_s[h]) * p.C_in;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (c < p.C_in) acc[c] = fmaf(__ldg(f + c), gv, acc[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) red[q][c][nn] = acc[c];
  __syncthreads();
  if (threadIdx.x < p.C_in * kTileN) {
    const int c = threadIdx.x / kTileN, m = threadIdx.x % kTileN;
    const int col = blockIdx.y * kTileN + m;
    if (col < p.C_out)
      p.ws[(static_cast<long long>(blockIdx.x) * p.C_in + c) * p.C_out + col] =
          ((red[0][c][m] + red[1][c][m]) + red[2][c][m]) + red[3][c][m];
  }
}

template <int TM, int TN>
__global__ void __launch_bounds__(kThreads, 2) sparse_conv_dw_tile(DwArgs p) {
  dw_tile<TM, TN>(p);
}

__global__ void __launch_bounds__(kThreads) sparse_conv_dw_narrow(DwArgs p) {
  dw_narrow(p);
}

// dW[e] = sum over k's splits in order of ws[split][e]; zero where offset
// k has no hit. A fixed order, so the same bits every run.
__global__ void sparse_conv_dw_sum(const float* __restrict__ ws,
                                   const int* __restrict__ counts, int K3,
                                   int pairs_target, long long CC, float* __restrict__ dw) {
  sum_dw_splits(ws, counts, K3, pairs_target, CC, dw);
}

}  // namespace

// feats (B, V_in, C_in) f32, nbr (B, V_out, K3) int32, g (B, V_out, C_out)
// f32 (zero at masked outputs), hits (K3, B * V_out) and counts (K3,)
// int32 from the map's plan, dw (K3, C_in, C_out) f32, all contiguous on
// the device. tm, tn = 8 or 4: tile path with 16 * tm input and 16 * tn
// output channels a block; tm = 0: narrow path (C_in <= 4). The grid holds `grid_pairs` splits
// (at least max(pairs_target, ceil(K3 * B * V_out / 4096)) + K3, the most
// the split table can give); `workspace` holds grid_pairs * C_in * C_out
// floats.
extern "C" int ptt_sparse_conv_dw(const void* feats, const void* nbr, const void* g,
                                  const void* hits, const void* counts, int B, int V_in,
                                  int V_out, int K3, int C_in, int C_out, int tm,
                                  int tn, int pairs_target, int grid_pairs, void* workspace,
                                  void* dw, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long CC = static_cast<long long>(C_in) * C_out;
  if (K3 < 1 || K3 > kMaxK3 || pairs_target < 1 || grid_pairs < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (CC == 0) return static_cast<int>(cudaGetLastError());
  DwArgs p;
  p.feats = static_cast<const float*>(feats);
  p.nbr = static_cast<const int*>(nbr);
  p.g = static_cast<const float*>(g);
  p.hits = static_cast<const int*>(hits);
  p.counts = static_cast<const int*>(counts);
  p.V_in = V_in; p.V_out = V_out; p.K3 = K3; p.C_in = C_in; p.C_out = C_out;
  p.pairs_target = pairs_target;
  p.R = static_cast<long long>(B) * V_out;
  p.vec_a = C_in % 4 == 0 && aligned16(feats);
  p.vec_g = C_out % 4 == 0 && aligned16(g);
  p.vec_o = C_out % 4 == 0 && aligned16(workspace);
  p.ws = static_cast<float*>(workspace);
  if (tm == 0) {
    if (C_in > 4) return static_cast<int>(cudaErrorInvalidValue);
    sparse_conv_dw_narrow<<<dim3(grid_pairs, (C_out + kTileN - 1) / kTileN), kThreads, 0,
                            st>>>(p);
  } else if ((tm == 8 || tm == 4) && (tn == 8 || tn == 4)) {
    void (*kernel)(DwArgs);
    size_t smem;
    if (tm == 8) {
      kernel = tn == 8 ? &sparse_conv_dw_tile<8, 8> : &sparse_conv_dw_tile<8, 4>;
      smem = tn == 8 ? sizeof(DwSmem<8, 8>) : sizeof(DwSmem<8, 4>);
    } else {
      kernel = tn == 8 ? &sparse_conv_dw_tile<4, 8> : &sparse_conv_dw_tile<4, 4>;
      smem = tn == 8 ? sizeof(DwSmem<4, 8>) : sizeof(DwSmem<4, 4>);
    }
    cudaError_t e = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    const int c_tiles = (C_in + 16 * tm - 1) / (16 * tm);
    const int n_tiles = (C_out + 16 * tn - 1) / (16 * tn);
    kernel<<<dim3(grid_pairs, c_tiles * n_tiles), kThreads, smem, st>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = K3 * CC;
  sparse_conv_dw_sum<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(workspace), p.counts, K3, pairs_target, CC,
      static_cast<float*>(dw));
  return static_cast<int>(cudaGetLastError());
}
