// Row gather probe: out[i, :] = table[idx[i], :], float32.
//
// Replaces the TPU probe of tools/exp_pallas_gather.py::try_kernel (:44;
// bodies kernel_take :31 and kernel_take_along :37), which asked whether
// Mosaic lowers an in-VMEM row gather at all. On the card a gather is a
// plain indexed load; this kernel is the counterpart at the probe's
// shapes ((14336, 64) table, 256 indices), timed against
// torch.index_select. Indices must lie in [0, rows).
//
// Bound on the H100: device-memory bytes (each gathered row read once,
// each output row written once: 128 KB at the probe's shapes), far under
// the latency of one dependent pair of loads (the index, then its row).
// The first design ran one thread per output element, each dividing by C
// and reloading its row's index. Now a group of 16 lanes takes a row:
// one lane loads its index and a shuffle hands it to the others, which
// copy the row with 16-byte loads and stores (a 64-float row is one float4
// a lane). Blocks of kRows rows spread the probe's 256 rows over 32 SMs,
// so the rows' load latencies overlap.
#include "common.cuh"

namespace {

constexpr int kLanes = 16;  // lanes a row
constexpr int kRows = 8;    // rows a block
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kLanes * kRows)
row_gather_kernel(const float4* __restrict__ table, const int* __restrict__ idx, int n_idx,
                  int C4, float4* __restrict__ out) {
  const long long row = static_cast<long long>(blockIdx.x) * kRows + threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  int r = 0;
  if (lane == 0 && row < n_idx) r = __ldg(idx + row);
  r = __shfl_sync(kFull, r, 0, kLanes);
  if (row >= n_idx) return;
  const float4* src = table + static_cast<long long>(r) * C4;
  float4* dst = out + row * C4;
  for (int c = lane; c < C4; c += kLanes) dst[c] = __ldg(src + c);
}

}  // namespace

// table (rows, C) f32, idx (n_idx,) int32, out (n_idx, C) f32, contiguous
// on the device; C a multiple of 4 and table and out 16-byte aligned, or
// cudaErrorInvalidValue.
extern "C" int ptt_row_gather(const void* table, const void* idx, int n_idx, int C,
                              void* out, void* stream) {
  if (C < 0 || C % 4 != 0 || !aligned16(table) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_idx > 0 && C > 0) {
    const unsigned blocks = static_cast<unsigned>((n_idx + kRows - 1) / kRows);
    row_gather_kernel<<<blocks, kLanes * kRows, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(table), static_cast<const int*>(idx), n_idx, C / 4,
        static_cast<float4*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
