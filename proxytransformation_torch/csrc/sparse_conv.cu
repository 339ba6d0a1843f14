// Sparse convolution as a gather-GEMM:
//   out[b, v] = sum_k feats[b, nbr[b, v, k]] @ W[k]   over hits (nbr >= 0),
// zero at masked outputs. float32 in, float32 accumulate, no TF32.
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
// Design: one block owns a tile of 64 output voxels x 64 output
// channels; 256 threads each accumulate a 4 x 4 sub-tile in registers.
// For each of the K3 offsets the block loads its 64 map entries; if all
// miss (common at the level's sparse edges) the offset is skipped. Else
// it walks C_in in steps of 16: the gathered input rows (zero rows for a
// miss) and the matching slice of W[k] are staged in shared memory and
// multiplied from there. The TPU kernel's monotone column windows and
// one-hot MXU gathers are TPU mechanism and are not carried over: the
// card gathers rows directly.
#include "common.cuh"

namespace {

constexpr int kTileV = 64;   // output voxels per block
constexpr int kTileN = 64;   // output channels per block
constexpr int kTileC = 16;   // input channels per shared-memory step
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sparse_conv_kernel(const float* __restrict__ feats, const int* __restrict__ nbr,
                   const float* __restrict__ weights,
                   const uint8_t* __restrict__ out_mask, int V_in, int V_out,
                   int K3, int C_in, int C_out, float* __restrict__ out) {
  __shared__ float a_s[kTileC][kTileV + 1];
  __shared__ float w_s[kTileC][kTileN];
  __shared__ int idx_s[kTileV];

  const long long b = blockIdx.z;
  const int v0 = blockIdx.x * kTileV;
  const int n0 = blockIdx.y * kTileN;
  const int tx = threadIdx.x % 16;  // output-channel group
  const int ty = threadIdx.x / 16;  // output-voxel group
  const float* fb = feats + b * V_in * C_in;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < K3; ++k) {
    int hit = 0;
    if (threadIdx.x < kTileV) {
      const int v = v0 + threadIdx.x;
      int id = -1;
      if (v < V_out) id = nbr[(b * V_out + v) * K3 + k];
      idx_s[threadIdx.x] = id;
      hit = id >= 0;
    }
    if (!__syncthreads_or(hit)) continue;  // every map entry of the tile misses
    const float* wk = weights + static_cast<long long>(k) * C_in * C_out;

    for (int c0 = 0; c0 < C_in; c0 += kTileC) {
      for (int e = threadIdx.x; e < kTileV * kTileC; e += kThreads) {
        const int v = e / kTileC, c = e % kTileC;
        const int id = idx_s[v];
        float x = 0.f;
        if (id >= 0 && c0 + c < C_in) x = fb[static_cast<long long>(id) * C_in + c0 + c];
        a_s[c][v] = x;
      }
      for (int e = threadIdx.x; e < kTileC * kTileN; e += kThreads) {
        const int c = e / kTileN, n = e % kTileN;
        float w = 0.f;
        if (c0 + c < C_in && n0 + n < C_out)
          w = wk[static_cast<long long>(c0 + c) * C_out + n0 + n];
        w_s[c][n] = w;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < kTileC; ++c) {
        float a[4], w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = a_s[c][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = w_s[c][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int v = v0 + ty * 4 + i;
    if (v >= V_out) continue;
    const bool keep = out_mask[b * V_out + v] != 0;
    float* o = out + (b * V_out + v) * C_out;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < C_out) o[n] = keep ? acc[i][j] : 0.f;
    }
  }
}

}  // namespace

// feats (B, V_in, C_in) f32, nbr (B, V_out, K3) int32, weights
// (K3, C_in, C_out) f32, out_mask (B, V_out) bool, out (B, V_out, C_out)
// f32; all contiguous on the device.
extern "C" int ptt_sparse_conv(const void* feats, const void* nbr,
                               const void* weights, const void* out_mask, int B,
                               int V_in, int V_out, int K3, int C_in, int C_out,
                               void* out, void* stream) {
  if (B > 0 && V_out > 0 && C_out > 0) {
    const dim3 grid((V_out + kTileV - 1) / kTileV, (C_out + kTileN - 1) / kTileN, B);
    sparse_conv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(feats), static_cast<const int*>(nbr),
        static_cast<const float*>(weights), static_cast<const uint8_t*>(out_mask),
        V_in, V_out, K3, C_in, C_out, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
