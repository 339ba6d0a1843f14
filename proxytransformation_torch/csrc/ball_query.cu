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
// work outside the tensor cores, ~8 operations per point scanned. A
// center stops scanning once K slots are filled, so the work depends on
// the data: a center in an empty region walks all N points.
//
// Design: one warp per center walks the points in order, 32 at a time.
// __ballot_sync over "within radius and valid" gives the hits of the
// 32-point step; a popc of the lanes below each hit gives its slot, so
// hits are written in point order. The warp stops as soon as K slots are
// filled. d² = (dx*dx + dy*dy) + dz*dz with dx = p - c, computed with
// round-to-nearest intrinsics (and -fmad=false) so nothing contracts into
// an FMA that would move points across the radius.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void ball_query_kernel(const float* __restrict__ centers,
                                  const float* __restrict__ points,
                                  const uint8_t* __restrict__ mask,
                                  int B, int M, int N, int K, float r2,
                                  int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= static_cast<long long>(B) * M) return;  // uniform per warp
  const long long b = row / M;
  const float cx = centers[row * 3 + 0];
  const float cy = centers[row * 3 + 1];
  const float cz = centers[row * 3 + 2];
  const float* pts = points + b * N * 3;
  const uint8_t* msk = mask + b * N;
  int* o = out + row * K;
  const unsigned below = (1u << lane) - 1u;

  int count = 0;  // identical in every lane of the warp
  for (int base = 0; base < N && count < K; base += 32) {
    const int i = base + lane;
    bool within = false;
    if (i < N && msk[i]) {
      const float dx = __fsub_rn(pts[3 * i + 0], cx);
      const float dy = __fsub_rn(pts[3 * i + 1], cy);
      const float dz = __fsub_rn(pts[3 * i + 2], cz);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      within = d2 < r2;
    }
    const unsigned hits = __ballot_sync(0xffffffffu, within);
    if (within) {
      const int slot = count + __popc(hits & below);
      if (slot < K) o[slot] = i;
    }
    count += __popc(hits);
  }
  for (int s = min(count, K) + lane; s < K; s += 32) o[s] = -1;
}

}  // namespace

// centers (B, M, 3) f32, points (B, N, 3) f32, mask (B, N) bool,
// out (B, M, K) int32; all contiguous on the device.
extern "C" int ptt_ball_query(const void* centers, const void* points,
                              const void* mask, int B, int M, int N, int K,
                              float r2, void* out, void* stream) {
  const long long rows = static_cast<long long>(B) * M;
  if (rows > 0 && K > 0) {
    const int blocks = static_cast<int>((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
    ball_query_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(centers), static_cast<const float*>(points),
        static_cast<const uint8_t*>(mask), B, M, N, K, r2,
        static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
