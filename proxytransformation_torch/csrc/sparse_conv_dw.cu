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
// Design: the rows (b, v) of the map are flattened to R = B * V_out and
// cut into S contiguous splits. One block owns (offset k, a 64-wide C_in
// tile, a 64-wide C_out tile, one split); 256 threads each accumulate a
// 4 x 4 sub-tile of dW[k] in registers. The block walks its split 16 rows
// at a time: it loads the 16 map entries, skips the chunk when all miss,
// and otherwise stages the gathered feats rows (zero rows for a miss) and
// the g rows in shared memory and multiplies from there. With S > 1 each
// split writes its partial tile to a workspace and a second kernel adds
// the S partials of every element in split order. The TPU kernel's
// union windows and one-hot scatter matmuls are TPU mechanism and are not
// carried over: the card gathers rows directly.
#include "common.cuh"

namespace {

constexpr int kTileC = 64;   // input channels per block
constexpr int kTileN = 64;   // output channels per block
constexpr int kRows = 16;    // map rows per shared-memory step
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sparse_conv_dw_kernel(const float* __restrict__ feats, const int* __restrict__ nbr,
                      const float* __restrict__ g, int V_in, int V_out, int K3,
                      int C_in, int C_out, long long R, long long rows_per_split,
                      float* __restrict__ out) {
  __shared__ float a_s[kRows][kTileC];
  __shared__ float g_s[kRows][kTileN];
  __shared__ int idx_s[kRows];

  const int k = blockIdx.x;
  const int c0 = blockIdx.y % ((C_in + kTileC - 1) / kTileC) * kTileC;
  const int n0 = blockIdx.y / ((C_in + kTileC - 1) / kTileC) * kTileN;
  const long long split = blockIdx.z;
  const long long r_begin = split * rows_per_split;
  const long long r_end = min(R, r_begin + rows_per_split);
  const int tx = threadIdx.x % 16;  // output-channel group
  const int ty = threadIdx.x / 16;  // input-channel group

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long r0 = r_begin; r0 < r_end; r0 += kRows) {
    int hit = 0;
    if (threadIdx.x < kRows) {
      const long long r = r0 + threadIdx.x;
      int id = -1;
      if (r < r_end) id = nbr[r * K3 + k];
      idx_s[threadIdx.x] = id;
      hit = id >= 0;
    }
    if (!__syncthreads_or(hit)) continue;  // every map entry of the chunk misses

    for (int e = threadIdx.x; e < kRows * kTileC; e += kThreads) {
      const int rr = e / kTileC, c = e % kTileC;
      const int id = idx_s[rr];
      float x = 0.f;
      if (id >= 0 && c0 + c < C_in) {
        const long long b = (r0 + rr) / V_out;
        x = feats[(b * V_in + id) * C_in + c0 + c];
      }
      a_s[rr][c] = x;
    }
    for (int e = threadIdx.x; e < kRows * kTileN; e += kThreads) {
      const int rr = e / kTileN, n = e % kTileN;
      const long long r = r0 + rr;
      float y = 0.f;
      if (idx_s[rr] >= 0 && n0 + n < C_out) y = g[r * C_out + n0 + n];
      g_s[rr][n] = y;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_s[rr][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = g_s[rr][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }

  // this split's tile of dW[k]: out is dW itself when S = 1, else the
  // split's slice of the workspace (S, K3, C_in, C_out)
  float* o = out + (split * K3 + k) * static_cast<long long>(C_in) * C_out;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty * 4 + i;
    if (c >= C_in) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < C_out) o[static_cast<long long>(c) * C_out + n] = acc[i][j];
    }
  }
}

// dW[e] = sum over s in order of ws[s][e]: a fixed order, so the same bits
// every run.
__global__ void sum_splits_kernel(const float* __restrict__ ws, long long n, int S,
                                  float* __restrict__ dw) {
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int i = 0; i < S; ++i) s += ws[i * n + e];
  dw[e] = s;
}

}  // namespace

// feats (B, V_in, C_in) f32, nbr (B, V_out, K3) int32, g (B, V_out, C_out)
// f32 (zero at masked outputs), dw (K3, C_in, C_out) f32, all contiguous
// on the device. S >= 1 splits of the B * V_out rows; for S > 1,
// `workspace` holds S * K3 * C_in * C_out floats.
extern "C" int ptt_sparse_conv_dw(const void* feats, const void* nbr, const void* g,
                                  int B, int V_in, int V_out, int K3, int C_in,
                                  int C_out, int S, void* workspace, void* dw,
                                  void* stream) {
  const long long R = static_cast<long long>(B) * V_out;
  const long long n = static_cast<long long>(K3) * C_in * C_out;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  if (R == 0 || S < 1) {
    cudaMemsetAsync(dw, 0, n * sizeof(float), st);
    return static_cast<int>(cudaGetLastError());
  }
  const long long rows_per_split = (R + S - 1) / S;
  const int c_tiles = (C_in + kTileC - 1) / kTileC;
  const int n_tiles = (C_out + kTileN - 1) / kTileN;
  const dim3 grid(K3, c_tiles * n_tiles, S);
  float* target = S == 1 ? static_cast<float*>(dw) : static_cast<float*>(workspace);
  sparse_conv_dw_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(feats), static_cast<const int*>(nbr),
      static_cast<const float*>(g), V_in, V_out, K3, C_in, C_out, R, rows_per_split,
      target);
  if (S > 1) {
    const int threads = 256;
    sum_splits_kernel<<<static_cast<unsigned>((n + threads - 1) / threads), threads, 0,
                        st>>>(static_cast<const float*>(workspace), n, S,
                              static_cast<float*>(dw));
  }
  return static_cast<int>(cudaGetLastError());
}
