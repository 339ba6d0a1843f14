// The bf16 form of the sparse-conv kernels, on Hopper's bf16 tensor cores:
//   forward and input gradient  out[b, v] = sum_k bf16(x[b, nbr[b, v, k]]) @ bf16(W[k])
//   weight gradient             dW[k] = sum_{b, v} bf16(x[b, nbr[b, v, k]])^T bf16(g[b, v])
// over hits (nbr >= 0), each product exact in float32, the sums in float32.
// The forward writes float32 or bf16 (rounded to nearest even once, from
// the float32 sum), zero at masked outputs; dW writes float32. The
// operands arrive as bf16: the wrapper (ops/sparse.py) rounds float32
// inputs once, before the launch, and zero-pads C_in and C_out to
// multiples of 16.
//
// Replaces the bf16 arithmetic of the TPU kernels in proxytransformation_tpu/
// ops/sparse_conv_pallas.py: ::sparse_conv_gather_gemm_colwin (:744; the casts
// at :782-783), whose function ::sparse_conv_gather_gemm (:177; :210-211)
// also computes, and ::sparse_conv_dw_gather_gemm (:399; :422, :436); their
// VMEM rings hold bf16 (:256, :477, :845, :882). The plan-reading set-up,
// the dW split table and the split sums are common.cuh's, shared with the
// float32 kernels of sparse_conv.cu and sparse_conv_dw.cu.
//
// Bound on the H100: 2 * hits * C_in * C_out bf16 operations over the dense
// bf16 tensor-core rate (989 TFLOP/s), or the bytes of x, nbr, W (g) and the
// output over 3.35 TB/s, whichever is larger.
//
// Design.
//  * Forward / input gradient (wgmma.mma_async, sm_90a): a block owns 128
//    mask-sorted rows (the map's plan) x BN output channels, BN = 64, 128 or
//    256 (ops/sparse.py::bf16_tile_launch), so the gathered rows feed up to
//    256 output channels at once. Its two warpgroups own 64 rows each and
//    keep 64 x BN float32 sums in registers (BN / 2 a thread). The block
//    walks only the offsets in the OR of its rows' hit masks; a stage is one
//    (offset, KC-channel) step, KC = 64 (32 or 16 where C_in is not a
//    multiple of 64): KC / 16 wgmma k-slices a warpgroup for one wait and
//    one barrier. A ring of 4-8 stages (up to 192 KB, one block an SM)
//    holds each step's gathered rows, 16-byte cp.async copies by all 256
//    threads (zero-filled at a miss; TMA copies boxes, not index-gathered
//    rows), and its W slice W[k][c0:c0+KC, n0:n0+BN], loaded once for both
//    warpgroups by TMA (one thread, BN / 64 boxes of KC x 64 from a 2D
//    tensor map of W, completion on an mbarrier). Both land in the
//    swizzled layouts the wgmma descriptors name (`swizzle`): A K-major
//    (rows of KC channels, 128/64/32-byte swizzle), B the W slice as W is
//    stored, N-major in 64-column atoms (128-byte swizzle, transposed B).
//    A warpgroup none of whose 64 rows hits a stage's offset skips it. One
//    group of wgmma stays in flight across the barrier (N >= 128); a stage
//    is refilled two steps after its use. The map entries of a tile are
//    staged with every load in flight at once. Blocks launch from the end
//    of the sorted order, so the tiles of masked rows come last. Small
//    levels split the steps across blocks into a float32 workspace that a
//    second kernel adds in split order.
//  * dW (mma.sync.m16n8k16): a block owns (offset k, a split of k's
//    compacted hit list, a 128 (64) x 128 (64) tile of dW[k]); the hits are
//    the MMA's k. 32 hits a step through a 3-stage ring: the gathered x
//    rows and the g rows at the hits, as bf16; A fragments by
//    ldmatrix.x4.trans of the hit-major x tile. Each warp owns a 32 x WN
//    tile. Splits are added in a fixed order by a second kernel: the same
//    bits every run.
#include <cuda.h>
#include <cuda_bf16.h>

#include "common.cuh"

using bf16 = __nv_bfloat16;

template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(smem)));
}

// d += a (16 x 16, row) * b (16 x 8, col), float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float x, float y);
template <>
__device__ __forceinline__ void store2<float>(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
template <>
__device__ __forceinline__ void store2<bf16>(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// ---------------------------------------------------------------- forward
constexpr int kRows = 128;             // mask-sorted rows a block
constexpr int kWgRows = 64;            // rows a warpgroup (the wgmma M)
constexpr int kRingBytes = 192 * 1024; // the stages' ring
constexpr int kMaxStages = 8;

// The block's mbarriers: stage s's W slice has landed (one arrival with
// the slice's bytes expected, completed by its TMA copies).
struct Barriers {
  uint64_t w[kMaxStages];
};

// A stage of a block with BN output channels and KC input channels a
// stage: the gathered rows (kA bytes), then the W slice (kW bytes); both
// multiples of 1024, so every stage starts on a swizzle atom.
template <int BN, int KC>
struct Ring {
  static constexpr int kA = kRows * KC * 2;
  static constexpr int kW = KC * BN * 2;
  static constexpr int kStage = kA + kW;
  static constexpr int kStages = kRingBytes / kStage < kMaxStages ? kRingBytes / kStage
                                                                  : kMaxStages;
  // the ring, the barriers, the tile's rows, and 1 KB to align the ring
  // to 1024 bytes
  static constexpr int kSmem = kStages * kStage +
                               static_cast<int>(sizeof(TileRows<kRows, kWgRows>)) +
                               static_cast<int>(sizeof(Barriers)) + 1024;
  static_assert(kStages >= 4 && kStages <= kMaxStages, "ring depth");
};

// Byte offset of byte `a` of a tile of RowBytes-byte rows (128, 64 or 32)
// in the swizzled layout of wgmma (CUTLASS's Swizzle<log2(RowBytes / 16),
// 4, 3>): the 16-byte chunk index, bits [4, 4 + B), XOR bits [7, 7 + B).
// The tile starts on a 1024-byte boundary. ops/sparse.py::bf16_swizzle is
// its mirror, tested to be a bijection within a stage.
template <int RowBytes>
__device__ __forceinline__ unsigned swizzle(unsigned a) {
  constexpr unsigned kMask = RowBytes / 16 - 1;
  return a ^ (((a >> 7) & kMask) << 4);
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), layout (1: 128-byte swizzle, 2: 64, 3: 32)
__device__ __forceinline__ uint64_t wgmma_desc(unsigned addr, unsigned lbo, unsigned sbo,
                                               unsigned layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void cp_async16_to(unsigned smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem), "l"(gmem),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// an arrival on `bar` that also expects `bytes` of copies to land
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// TMA: the box at (x, y) of the 2D tensor map `map` into shared memory
// at `smem`, its bytes counted on `bar`
__device__ __forceinline__ void tma_load_2d(unsigned smem, const CUtensorMap* map, int x, int y,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_addr(bar))
      : "memory");
}
// wait until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// data that reached this thread through the generic proxy (the copies),
// ordered before its async-proxy reads (wgmma's operand loads)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// the accumulators as the wgmma instructions left them: no other read or
// write of them moves across this point
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, float32) += A (64 x 16, K-major) * B (16 x N, N-major): one
// warpgroup, both operands from shared memory through their descriptors
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t a, uint64_t b) {
  if constexpr (BN == 64) wgmma_m64n64(d, a, b);
  else if constexpr (BN == 128) wgmma_m64n128(d, a, b);
  else wgmma_m64n256(d, a, b);
}

struct ConvArgs {
  CUtensorMap w_map;        // W as a (K3 * C_in, C_out) matrix: (KC, 64) boxes, 128-byte swizzle
  const bf16* feats;        // (B, V_in, C_in)
  const int* nbr;           // (B, V_out, K3)
  const uint8_t* out_mask;  // (B, V_out)
  const int* row_mask;      // (B, V_out)
  const int* order;         // (B, V_out)
  int B, V_in, V_out, K3, C_in, C_out, splits;
  bool out_f32;             // float32 out (always for the split workspace), else bf16
  void* out;  // (B, V_out, C_out), or the float (splits, B, V_out, C_out) workspace
};

template <int BN, int KC>
__device__ __forceinline__ void conv_tile(const ConvArgs& p) {
  using R = Ring<BN, KC>;
  constexpr int S = R::kStages;
  constexpr int kRowA = KC * 2;                  // bytes of a gathered row in a stage
  constexpr unsigned kLayoutA = KC == 64 ? 1 : KC == 32 ? 2 : 3;
  // wgmma groups left running across the next barrier: one where a
  // step's MMAs outlast the barrier and the copies' issue (N >= 128)
  constexpr int kInFlight = BN >= 128 ? 1 : 0;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const unsigned ring = smem_addr(smem);  // 1024-byte aligned
  Barriers& bar = *reinterpret_cast<Barriers*>(smem + S * R::kStage);
  TileRows<kRows, kWgRows>& t =
      *reinterpret_cast<TileRows<kRows, kWgRows>*>(smem + S * R::kStage + sizeof(Barriers));
  const int tid = threadIdx.x, wg = tid / 128;
  // blockIdx.x: the split, then the sample, then the column block;
  // blockIdx.y: the tile from the end of the sorted order, where the rows
  // with the most hits are, so the blocks launched first hold work and
  // the tiles of masked rows (mask 0, sorted first) fill in behind them
  const int split = blockIdx.x % p.splits, b = blockIdx.x / p.splits % p.B;
  const int t0 = (gridDim.y - 1 - blockIdx.y) * kRows, n0 = blockIdx.x / (p.splits * p.B) * BN;
  const long long rb = static_cast<long long>(b) * p.V_out;

  // 1-2. the W barriers; the tile's rows in mask order, the OR of each
  // warpgroup's 64 rows' masks and of the tile's, and the map entries of
  // the active offsets
  if (tid == 0) {
    for (int i = 0; i < S; ++i) mbar_init(&bar.w[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int n_act = load_tile_rows<kRows, kWgRows, kThreads>(p.order, p.out_mask, p.row_mask,
                                                             rb, t0, p.V_out, t);
  // the map entries of the active offsets, -1 for dropped rows: every
  // thread's loads issued before any is stored, so the block waits for
  // one round trip, not one a pass
  {
    constexpr int kPer = kMaxK3 * kRows / kThreads;
    int id[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads, j = e / kRows, r = e % kRows;
      id[i] = j < n_act && t.keep[r] ? p.nbr[(rb + t.rows[r]) * p.K3 + t.act[j]] : -1;
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads;
      if (e / kRows < n_act) t.idx[e / kRows][e % kRows] = id[i];
    }
    __syncthreads();
  }

  // 3. this block's range of (offset, KC-channel) steps
  const int n_c = p.C_in / KC;
  const long long total = static_cast<long long>(n_act) * n_c;
  const int s_begin = static_cast<int>(total * split / p.splits);
  const int n_steps = static_cast<int>(total * (split + 1) / p.splits) - s_begin;
  const bf16* fb = p.feats + static_cast<long long>(b) * p.V_in * p.C_in;

  // a step into `stage`: its 128 gathered rows by every thread (KC / 8
  // 16-byte copies a row, consecutive threads along a row), and its W
  // slice W[k][c0:c0+KC, n0:n0+BN] by one thread, as BN / 64 TMA boxes of
  // KC rows x 64 columns (the 64-column atoms of the B layout)
  auto load = [&](int step, int stage) {
    const int j = step / n_c;
    const int c0 = (step - j * n_c) * KC;
    const unsigned sa = ring + stage * R::kStage;
    constexpr int kChunksA = KC / 8;
#pragma unroll
    for (int i = 0; i < kRows * kChunksA / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kChunksA, c = e % kChunksA;
      const int id = t.idx[j][r];
      const bool ok = id >= 0;
      cp_async16_to(sa + swizzle<kRowA>(r * kRowA + c * 16),
                    ok ? fb + static_cast<long long>(id) * p.C_in + c0 + c * 8 : fb, ok);
    }
    if (tid == 0) {
      mbar_arrive_expect(&bar.w[stage], R::kW);
#pragma unroll
      for (int a = 0; a < BN / 64; ++a)
        tma_load_2d(sa + R::kA + a * KC * 128, &p.w_map, n0 + a * 64, t.act[j] * p.C_in + c0,
                    &bar.w[stage]);
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  // 4. the pipeline. Iteration st: step st's rows have landed (every
  // thread's copies, then the barrier), step st + S - 2 is loaded into
  // the stage that step st - 2 used (every warpgroup waited for its MMAs
  // of step st - 2 before the barrier), and a warpgroup that does not
  // skip step st waits for its W slice and multiplies it, while step
  // st - 1's MMAs may still run.
#pragma unroll
  for (int st = 0; st < S - 2; ++st) {
    if (st < n_steps) load(s_begin + st, st);
    cp_async_commit();
  }
  const unsigned wg_or = t.grp_or[wg];
  // A: this warpgroup's 64 rows, 8-row groups kRowA * 8 bytes apart; B:
  // 8-row (k) groups 1024 bytes apart, 64-column atoms KC * 128 apart
  const unsigned a_wg = wg * kWgRows * kRowA;
  for (int st = 0; st < n_steps; ++st) {
    cp_async_wait<S - 3>();
    fence_proxy_async();
    __syncthreads();
    const int ahead = st + S - 2;
    if (ahead < n_steps) load(s_begin + ahead, ahead % S);
    cp_async_commit();
    if ((wg_or >> t.act[(s_begin + st) / n_c]) & 1u) {
      const int stage = st % S;
      const unsigned sa = ring + stage * R::kStage;
      mbar_wait(&bar.w[stage], (st / S) & 1);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)
        wgmma_tile<BN>(acc,
                       wgmma_desc(sa + a_wg + kk * 32, 16, 8 * kRowA, kLayoutA),
                       wgmma_desc(sa + R::kA + kk * 2048, KC * 128, 1024, 1));
      wgmma_commit();
      wgmma_wait<kInFlight>();
    } else {
      wgmma_wait<0>();
    }
    fence_acc(acc);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  cp_async_wait<0>();

  // 5. write back to the original rows; zero at masked outputs. Thread
  // (warp w of the warpgroup, lane g * 4 + q) holds rows 16w + g and
  // 16w + g + 8 of its warpgroup's 64, columns 8j + 2q, 8j + 2q + 1 of
  // each 8-column block j.
  const int w4 = (tid & 127) >> 5, g = (tid & 31) >> 2, q2 = (tid & 3) * 2;
  const long long o0 = (static_cast<long long>(split) * p.B + b) * p.V_out * p.C_out;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = wg * kWgRows + w4 * 16 + g + half * 8;
    const int v = t.rows[r];
    if (v < 0) continue;
    const bool keep = t.keep[r] != 0;
    const long long o = o0 + static_cast<long long>(v) * p.C_out;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + j * 8 + q2;
      if (n >= p.C_out) continue;
      const float x = keep ? acc[4 * j + 2 * half] : 0.f;
      const float y = keep ? acc[4 * j + 2 * half + 1] : 0.f;
      if (p.out_f32)
        store2(static_cast<float*>(p.out) + o + n, x, y);
      else
        store2(static_cast<bf16*>(p.out) + o + n, x, y);
    }
  }
}

// the forward and the input gradient: one body, two symbols each
template <int BN, int KC>
__global__ void __launch_bounds__(kThreads, 1)
    sparse_conv_fwd_bf16_tile(const __grid_constant__ ConvArgs p) {
  conv_tile<BN, KC>(p);
}
template <int BN, int KC>
__global__ void __launch_bounds__(kThreads, 1)
    sparse_conv_dfeats_bf16_tile(const __grid_constant__ ConvArgs p) {
  conv_tile<BN, KC>(p);
}
template <typename OutT>
__global__ void sparse_conv_fwd_bf16_sum(const float* ws, long long n, int S, OutT* out) {
  sum_splits(ws, n, S, out);
}
template <typename OutT>
__global__ void sparse_conv_dfeats_bf16_sum(const float* ws, long long n, int S, OutT* out) {
  sum_splits(ws, n, S, out);
}

using ConvKernel = void (*)(ConvArgs);

template <int BN, int KC>
cudaError_t launch_tile(int role, const ConvArgs& p, dim3 grid, cudaStream_t st) {
  const ConvKernel kernel =
      role == 0 ? &sparse_conv_fwd_bf16_tile<BN, KC> : &sparse_conv_dfeats_bf16_tile<BN, KC>;
  constexpr int smem = Ring<BN, KC>::kSmem;
  const cudaError_t e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel), cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, st>>>(p);
  return cudaSuccess;
}

template <typename OutT>
void launch_sum(int role, const float* ws, long long n, int S, void* out, cudaStream_t st) {
  auto sum = role == 0 ? &sparse_conv_fwd_bf16_sum<OutT> : &sparse_conv_dfeats_bf16_sum<OutT>;
  sum<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(ws, n, S,
                                                               static_cast<OutT*>(out));
}

// ---------------------------------------------------------------- dW
constexpr int kStepH = 32;       // hits per step: two MMA k16 slices
constexpr int kDwStages = 3;     // cp.async ring depth

struct DwArgs {
  const bf16* feats;    // (B, V_in, C_in)
  const int* nbr;       // (B, V_out, K3)
  const bf16* g;        // (B, V_out, C_out)
  const int* hits;      // (K3, R) hit rows of each offset, row order
  const int* counts;    // (K3,)
  int V_in, V_out, K3, C_in, C_out, pairs_target;
  long long R;
  float* ws;            // (pairs, C_in, C_out) partial sums
};

template <int BM, int BN>
struct DwSmem {
  bf16 a[kDwStages][kStepH * (BM + 8)];  // gathered x rows, hit-major
  bf16 g[kDwStages][kStepH * (BN + 8)];  // g rows at the hits
  int r[kMaxChunk];
  int id[kMaxChunk];
  SplitTable t;
};

template <int BM, int BN>
__device__ __forceinline__ void dw_tile(const DwArgs& p) {
  constexpr int kRowA = BM + 8, kRowG = BN + 8;  // padded tile rows
  constexpr int WARPS_M = BM / 32, WARPS_N = 8 / WARPS_M;
  constexpr int WN = BN / WARPS_N;  // 64, 32 or 16
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DwSmem<BM, BN>& s = *reinterpret_cast<DwSmem<BM, BN>*>(smem_raw);
  const Split sp = load_split<kThreads>(p, s.t, s.r, s.id);
  if (sp.nh == 0) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int c_tiles = (p.C_in + BM - 1) / BM;
  const int c0 = blockIdx.y % c_tiles * BM, n0 = blockIdx.y / c_tiles * BN;
  const int n_steps = (sp.nh + kStepH - 1) / kStepH;

  auto load = [&](int step, int stage) {
    const int hb = step * kStepH;
    for (int e = tid; e < kStepH * BM / 8; e += kThreads) {
      const int h = e / (BM / 8), q = e % (BM / 8) * 8;
      const int hh = hb + h;
      const bool ok = hh < sp.nh && c0 + q < p.C_in;
      const bf16* src = p.feats;
      if (ok) {
        const long long b = s.r[hh] / p.V_out;
        src += (b * p.V_in + s.id[hh]) * p.C_in + c0 + q;
      }
      cp_async16(s.a[stage] + h * kRowA + q, src, ok);
    }
    for (int e = tid; e < kStepH * BN / 8; e += kThreads) {
      const int h = e / (BN / 8), q = e % (BN / 8) * 8;
      const int hh = hb + h;
      const bool ok = hh < sp.nh && n0 + q < p.C_out;
      const bf16* src = ok ? p.g + static_cast<long long>(s.r[hh]) * p.C_out + n0 + q : p.g;
      cp_async16(s.g[stage] + h * kRowG + q, src, ok);
    }
  };

  float acc[2][WN / 8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < WN / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
  for (int st = 0; st < kDwStages - 1; ++st) {
    if (st < n_steps) load(st, st);
    cp_async_commit();
  }
  // A (C_in x hits) is the transpose of the hit-major x tile; B (hits x
  // C_out) the g tile as stored: both fragments by ldmatrix.trans
  const int a_h = (lane & 7) + ((lane >> 4) & 1) * 8, a_c = ((lane >> 3) & 1) * 8;
  const int b_h = (lane & 7) + ((lane >> 3) & 1) * 8, b_n = (lane >> 4) * 8;
  for (int st = 0; st < n_steps; ++st) {
    cp_async_wait<kDwStages - 2>();
    __syncthreads();
    const int ahead = st + kDwStages - 1;
    if (ahead < n_steps) load(ahead, ahead % kDwStages);
    cp_async_commit();
    const bf16* a = s.a[st % kDwStages];
    const bf16* gs = s.g[st % kDwStages];
#pragma unroll
    for (int ks = 0; ks < kStepH / 16; ++ks) {
      unsigned af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4_trans(af[mi], a + (ks * 16 + a_h) * kRowA + wm * 32 + mi * 16 + a_c);
#pragma unroll
      for (int nb = 0; nb < WN / 16; ++nb) {
        unsigned bfr[4];
        ldmatrix_x4_trans(bfr, gs + (ks * 16 + b_h) * kRowG + wn * WN + nb * 16 + b_n);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * nb], af[mi], bfr[0], bfr[1]);
          mma_bf16(acc[mi][2 * nb + 1], af[mi], bfr[2], bfr[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  float* out = p.ws + static_cast<long long>(blockIdx.x) * p.C_in * p.C_out;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = c0 + wm * 32 + mi * 16 + g + half * 8;
      if (c >= p.C_in) continue;
#pragma unroll
      for (int nb = 0; nb < WN / 8; ++nb) {
        const int n = n0 + wn * WN + nb * 8 + t2;
        if (n >= p.C_out) continue;
        store2(out + static_cast<long long>(c) * p.C_out + n, acc[mi][nb][2 * half],
               acc[mi][nb][2 * half + 1]);
      }
    }
  }
}

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads, 2) sparse_conv_dw_bf16_tile(DwArgs p) {
  dw_tile<BM, BN>(p);
}

// dW[e] = sum over k's splits in order of ws[split][e]; zero where offset
// k has no hit. A fixed order, so the same bits every run.
__global__ void sparse_conv_dw_bf16_sum(const float* __restrict__ ws,
                                        const int* __restrict__ counts, int K3,
                                        int pairs_target, long long CC, float* __restrict__ dw) {
  sum_dw_splits(ws, counts, K3, pairs_target, CC, dw);
}

template <int BM, int BN>
cudaError_t launch_dw(const DwArgs& p, int grid_pairs, cudaStream_t st) {
  const size_t smem = sizeof(DwSmem<BM, BN>);
  cudaError_t e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(&sparse_conv_dw_bf16_tile<BM, BN>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int tiles = ((p.C_in + BM - 1) / BM) * ((p.C_out + BN - 1) / BN);
  sparse_conv_dw_bf16_tile<BM, BN><<<dim3(grid_pairs, tiles), kThreads, smem, st>>>(p);
  return cudaSuccess;
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no link to
// libcuda); null where it is missing
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                                  cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f)
                                                                : nullptr;
  }();
  return fn;
}

}  // namespace

// feats (B, V_in, C_in) bf16, nbr (B, V_out, K3) int32, weights (K3, C_in,
// C_out) bf16, out_mask (B, V_out) bool, row_mask and order (B, V_out) int32
// from the map's plan; C_in a multiple of kc, C_out of 16, feats and
// weights 16-byte aligned; all contiguous on the device. role 0 = forward,
// 1 = input gradient (only the kernel symbols differ). out (B, V_out,
// C_out) is float32 where out_f32 != 0, else bf16. kc input channels a
// stage (64, or 32 or 16 with bn = 64), bn output channels a block (64,
// 128 or 256); splits >= 1, and for splits > 1 `workspace` holds splits *
// B * V_out * C_out floats (ops/sparse.py::bf16_tile_launch).
extern "C" int ptt_sparse_conv_bf16(const void* feats, const void* nbr, const void* weights,
                                    const void* out_mask, const void* row_mask,
                                    const void* order, int B, int V_in, int V_out, int K3,
                                    int C_in, int C_out, int role, int out_f32, int kc, int bn,
                                    int splits, void* workspace, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool shape_ok = kc == 64 ? (bn == 64 || bn == 128 || bn == 256)
                                 : (kc == 32 || kc == 16) && bn == 64;
  if (K3 < 1 || K3 > kMaxK3 || splits < 1 || (role != 0 && role != 1) || !shape_ok ||
      C_in <= 0 || C_in % kc || C_out % 16 || !aligned16(feats) || !aligned16(weights))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || V_out <= 0 || C_out <= 0) return static_cast<int>(cudaGetLastError());
  ConvArgs p;
  p.feats = static_cast<const bf16*>(feats);
  p.nbr = static_cast<const int*>(nbr);
  p.out_mask = static_cast<const uint8_t*>(out_mask);
  p.row_mask = static_cast<const int*>(row_mask);
  p.order = static_cast<const int*>(order);
  p.B = B; p.V_in = V_in; p.V_out = V_out; p.K3 = K3; p.C_in = C_in; p.C_out = C_out;
  p.splits = splits;
  // W as a (K3 * C_in, C_out) bf16 matrix, read in (kc rows, 64 columns)
  // boxes in the 128-byte swizzle; columns past C_out read as zeros
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(C_out),
                              static_cast<cuuint64_t>(K3) * static_cast<cuuint64_t>(C_in)};
  const cuuint64_t row_bytes[1] = {static_cast<cuuint64_t>(C_out) * sizeof(bf16)};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(kc)};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(&p.w_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(weights), dims,
             row_bytes, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  // split partials are float32 whatever the output type
  p.out_f32 = out_f32 != 0 || splits > 1;
  p.out = splits > 1 ? workspace : out;
  const dim3 grid(splits * B * ((C_out + bn - 1) / bn), (V_out + kRows - 1) / kRows);
  cudaError_t e;
  if (kc == 64)
    e = bn == 256 ? launch_tile<256, 64>(role, p, grid, st)
        : bn == 128 ? launch_tile<128, 64>(role, p, grid, st)
                    : launch_tile<64, 64>(role, p, grid, st);
  else
    e = kc == 32 ? launch_tile<64, 32>(role, p, grid, st) : launch_tile<64, 16>(role, p, grid, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (splits > 1) {
    const long long n = static_cast<long long>(B) * V_out * C_out;
    const float* ws = static_cast<const float*>(workspace);
    if (out_f32)
      launch_sum<float>(role, ws, n, splits, out, st);
    else
      launch_sum<bf16>(role, ws, n, splits, out, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of the forward / input-gradient block of a (kc,
// bn) launch shape, -1 for a shape the kernel does not take
// (ops/sparse.py::bf16_tile_launch computes the same).
extern "C" int ptt_sparse_conv_bf16_smem(int kc, int bn) {
  if (kc == 64)
    return bn == 256 ? Ring<256, 64>::kSmem : bn == 128 ? Ring<128, 64>::kSmem
                                            : bn == 64 ? Ring<64, 64>::kSmem : -1;
  if (bn != 64) return -1;
  return kc == 32 ? Ring<64, 32>::kSmem : kc == 16 ? Ring<64, 16>::kSmem : -1;
}

// feats (B, V_in, C_in) bf16, nbr (B, V_out, K3) int32, g (B, V_out, C_out)
// bf16 (zero at masked outputs), hits (K3, B * V_out) and counts (K3,)
// int32 from the map's plan, dw (K3, C_in, C_out) float32; C_in and C_out
// multiples of 16, feats and g 16-byte aligned; all contiguous on the
// device. tm, tn = 8 or 4: 16 * tm input and 16 * tn output channels a
// block (ops/sparse.py::dw_launch_shape). The grid holds `grid_pairs`
// splits (the most the split table can give); `workspace` holds
// grid_pairs * C_in * C_out floats.
extern "C" int ptt_sparse_conv_dw_bf16(const void* feats, const void* nbr, const void* g,
                                       const void* hits, const void* counts, int B, int V_in,
                                       int V_out, int K3, int C_in, int C_out, int tm, int tn,
                                       int pairs_target, int grid_pairs, void* workspace,
                                       void* dw, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long CC = static_cast<long long>(C_in) * C_out;
  if (K3 < 1 || K3 > kMaxK3 || pairs_target < 1 || grid_pairs < 1 || C_in % 16 ||
      C_out % 16 || !aligned16(feats) || !aligned16(g) || (tm != 8 && tm != 4) ||
      (tn != 8 && tn != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (CC == 0) return static_cast<int>(cudaGetLastError());
  DwArgs p;
  p.feats = static_cast<const bf16*>(feats);
  p.nbr = static_cast<const int*>(nbr);
  p.g = static_cast<const bf16*>(g);
  p.hits = static_cast<const int*>(hits);
  p.counts = static_cast<const int*>(counts);
  p.V_in = V_in; p.V_out = V_out; p.K3 = K3; p.C_in = C_in; p.C_out = C_out;
  p.pairs_target = pairs_target;
  p.R = static_cast<long long>(B) * V_out;
  p.ws = static_cast<float*>(workspace);
  cudaError_t e;
  if (tm == 8)
    e = tn == 8 ? launch_dw<128, 128>(p, grid_pairs, st) : launch_dw<128, 64>(p, grid_pairs, st);
  else
    e = tn == 8 ? launch_dw<64, 128>(p, grid_pairs, st) : launch_dw<64, 64>(p, grid_pairs, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n = K3 * CC;
  sparse_conv_dw_bf16_sum<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(workspace), p.counts, K3, pairs_target, CC,
      static_cast<float*>(dw));
  return static_cast<int>(cudaGetLastError());
}
