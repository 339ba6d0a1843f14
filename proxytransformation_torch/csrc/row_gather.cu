// Row gather probe: out[i, c] = table[idx[i], c], one thread per output
// element, float32.
//
// Replaces the TPU probe of tools/exp_pallas_gather.py::try_kernel (:44;
// bodies kernel_take :31 and kernel_take_along :37), which asked whether
// Mosaic lowers an in-VMEM row gather at all. On the card a gather is a
// plain indexed load; this kernel is the counterpart at the probe's
// shapes ((14336, 64) table, 256 indices), timed against
// torch.index_select. Indices must lie in [0, rows).
#include "common.cuh"

namespace {

__global__ void row_gather_kernel(const float* __restrict__ table,
                                  const int* __restrict__ idx, int n_idx, int C,
                                  float* __restrict__ out) {
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (e >= static_cast<long long>(n_idx) * C) return;
  const int i = static_cast<int>(e / C), c = static_cast<int>(e % C);
  out[e] = table[static_cast<long long>(idx[i]) * C + c];
}

}  // namespace

// table (rows, C) f32, idx (n_idx,) int32, out (n_idx, C) f32, contiguous
// on the device.
extern "C" int ptt_row_gather(const void* table, const void* idx, int n_idx, int C,
                              void* out, void* stream) {
  const long long n = static_cast<long long>(n_idx) * C;
  if (n > 0) {
    const int threads = 256;
    row_gather_kernel<<<static_cast<unsigned>((n + threads - 1) / threads), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(table), static_cast<const int*>(idx), n_idx, C,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
