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
// VMEM rings hold bf16 (:256, :477, :845, :882). The plan-reading set-up
// and the forward's split sum are common.cuh's, shared with the float32
// kernels of sparse_conv.cu and sparse_conv_dw.cu; dW has its own split
// table (`dw_plan`).
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
//  * dW (wgmma.mma_async with the hits as k, sm_90a): a block owns (offset
//    k, a split of k's compacted hit list, a BM x BN tile of dW[k]), BM =
//    64 or 128 input and BN = 64, 128 or 256 output channels
//    (ops/sparse.py::bf16_dw_launch), so a gathered x row feeds up to 256
//    output channels. A = x^T is MN-major (the gathered rows are hit-major,
//    channels contiguous: a transposed A), B = g at the hits N-major, both
//    in 64-channel atoms of 64 hit rows in the 128-byte swizzle. Two
//    warpgroups own 64 input channels each (for C_in <= 64 both own the
//    same 64 and each takes half of every stage's hits; their sums are
//    added in one order at the end). A stage is 64 hits (four k16 slices
//    for one wait and one barrier) through a ring of 4-12 stages in 192
//    KB, one block an SM; the operands come by 16-byte cp.async copies,
//    zero-filled past the split's hits. The hit rows and their input rows
//    (nbr[r, k]) are streamed through a ring of 32 steps by 4-byte copies,
//    3D and 2D steps ahead of the operands (D = stages - 2), so a split
//    holds any number of hits. The split table (`dw_plan`, a function of
//    the hit counts) cuts offsets only as far as one wave of one block an
//    SM needs; an offset with one split writes dW itself, the others
//    write float32 partials that a second kernel adds, in split order, for
//    those offsets alone: the same bits every run, no float atomics.
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

// d (64 x N, float32) += A (64 x 16; K-major, or M-major where TA = 1) * B
// (16 x N, N-major): one warpgroup, both operands from shared memory
// through their descriptors
template <int TA>
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1), "n"(TA));
}

template <int TA>
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
      "}, %64, %65, p, 1, 1, %67, 1;\n}\n"
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
      : "l"(a), "l"(b), "r"(1), "n"(TA));
}

template <int TA>
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
      "}, %128, %129, p, 1, 1, %131, 1;\n}\n"
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
      : "l"(a), "l"(b), "r"(1), "n"(TA));
}

// TA = 1: A MN-major (M contiguous, as a transposed A), else K-major
template <int BN, int TA = 0>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t a, uint64_t b) {
  if constexpr (BN == 64) wgmma_m64n64<TA>(d, a, b);
  else if constexpr (BN == 128) wgmma_m64n128<TA>(d, a, b);
  else wgmma_m64n256<TA>(d, a, b);
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
constexpr int kDwHits = 64;               // hits a stage: four wgmma k16 slices
constexpr int kDwAtom = kDwHits * 128;    // a 64-channel atom of a stage's operand tile
constexpr int kDwRingBytes = 192 * 1024;  // the stages' ring
constexpr int kDwMaxStages = 12;
constexpr int kDwIdxSlots = 32;           // steps the hit-index ring holds
constexpr int kDwMinHits = 256;           // hits a split takes at least

// The split table of a dW call, a function of the hit counts alone (so
// every block and the sum pass derive the same one): offset k's hits
// are cut into S[k] splits of `chunk` hits (the last one shorter), one
// split for an offset without a hit; `chunk` is the least that keeps
// the splits of all offsets within `max_splits` (one wave of one block
// an SM, over the channel tiles), and at least kDwMinHits. An offset
// with one split writes dW itself; the others write float32 partials
// to workspace slots wbase[k] .. wbase[k] + S[k] - 1, which the sum
// pass adds in split order. ops/sparse.py::bf16_dw_split_table mirrors
// it.
struct DwPlan {
  int chunk, total, wtotal;
  int S[kMaxK3], base[kMaxK3], wbase[kMaxK3], cnt[kMaxK3];
};

// Called by warp 0 alone (K3 <= 32: a lane an offset).
__device__ __forceinline__ void dw_plan(const int* counts, int K3, int max_splits, DwPlan& t) {
  const int lane = threadIdx.x & 31;
  const int c = lane < K3 ? counts[lane] : 0;
  int chunk = max(__reduce_max_sync(0xffffffffu, c), 1);
  if (K3 < max_splits) {
    // the least chunk in [1, the largest count] whose splits fit: their
    // number falls as the chunk grows
    int lo = 1, hi = chunk;
    while (lo < hi) {
      const int mid = lo + (hi - lo) / 2;
      const int s = lane < K3 ? max(1, (c + mid - 1) / mid) : 0;
      if (__reduce_add_sync(0xffffffffu, s) <= max_splits) hi = mid;
      else lo = mid + 1;
    }
    chunk = max(lo, kDwMinHits);
  }
  const int S = lane < K3 ? max(1, (c + chunk - 1) / chunk) : 0;
  const int W = S > 1 ? S : 0;
  int inc = S, winc = W;  // inclusive prefix sums over the lanes
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int a = __shfl_up_sync(0xffffffffu, inc, o);
    const int b = __shfl_up_sync(0xffffffffu, winc, o);
    if (lane >= o) {
      inc += a;
      winc += b;
    }
  }
  if (lane < K3) {
    t.S[lane] = S;
    t.base[lane] = inc - S;
    t.wbase[lane] = winc - W;
    t.cnt[lane] = c;
  }
  if (lane == 31) {
    t.total = inc;
    t.wtotal = winc;
  }
  if (lane == 0) t.chunk = chunk;
}

// A dW block's shared memory beside its ring: a ring of the hit rows
// (b * V_out + v) and their input rows (nbr[r, k]) of kDwIdxSlots
// steps, and the split table.
struct DwIdx {
  int r[kDwIdxSlots][kDwHits];
  int id[kDwIdxSlots][kDwHits];
  DwPlan plan;
};

// A stage of a block of BM input x BN output channels: 64 hits of the
// gathered x rows (kA bytes), then of the g rows at the hits (kG), each
// hit-major in 64-channel atoms of 64 rows of 128 bytes (the MN-major
// operand layout), so every atom starts on a 1024-byte boundary.
template <int BM, int BN>
struct DwRing {
  static constexpr int kA = kDwHits * BM * 2;
  static constexpr int kG = kDwHits * BN * 2;
  static constexpr int kStage = kA + kG;
  static constexpr int kStages = kDwRingBytes / kStage < kDwMaxStages ? kDwRingBytes / kStage
                                                                      : kDwMaxStages;
  // the ring, the index ring and the table, and 1 KB to align the ring
  static constexpr int kSmem = kStages * kStage + static_cast<int>(sizeof(DwIdx)) + 1024;
  static_assert(kStages >= 4 && 3 * (kStages - 2) < kDwIdxSlots, "ring depth");
};

struct DwArgs {
  const bf16* feats;  // (B, V_in, C_in)
  const int* nbr;     // (B, V_out, K3)
  const bf16* g;      // (B, V_out, C_out)
  const int* hits;    // (K3, R) hit rows of each offset, row order
  const int* counts;  // (K3,)
  int V_in, V_out, K3, C_in, C_out, max_splits;
  long long R;
  float* ws;          // (wtotal, C_in, C_out) split partials
  float* dw;          // (K3, C_in, C_out)
};

template <int BM, int BN>
__device__ __forceinline__ void dw_tile(const DwArgs& p) {
  using R = DwRing<BM, BN>;
  constexpr int S = R::kStages;
  // a step's operands are copied D steps ahead of its MMAs, its input
  // rows 2D and its hit rows 3D steps ahead: each from indices that
  // landed by the barrier of the iteration that issues it
  constexpr int D = S - 2;
  // C_in <= 64: both warpgroups own the block's 64 input channels, each
  // multiplies half of every stage's hits, and their sums are added in
  // one order at the end
  constexpr bool kSplitK = BM == 64;
  constexpr int kInFlight = BN >= 128 ? 1 : 0;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const unsigned ring = smem_addr(smem);  // 1024-byte aligned
  DwIdx& s = *reinterpret_cast<DwIdx*>(smem + S * R::kStage);
  const int tid = threadIdx.x, wg = tid / 128;
  if (tid < 32) dw_plan(p.counts, p.K3, p.max_splits, s.plan);
  __syncthreads();

  // 1. this block's offset, split and hit range; its channel tile
  const int pair = blockIdx.x;
  if (pair >= s.plan.total) return;
  int k = 0;
  while (pair >= s.plan.base[k] + s.plan.S[k]) ++k;
  const int split = pair - s.plan.base[k], n_split = s.plan.S[k];
  const int h0 = split * s.plan.chunk;
  const int nh = min(s.plan.chunk, s.plan.cnt[k] - h0);
  const int n_steps = (nh + kDwHits - 1) / kDwHits;
  const int c_tiles = (p.C_in + BM - 1) / BM;
  const int c0 = blockIdx.y % c_tiles * BM, n0 = blockIdx.y / c_tiles * BN;
  const int* hl = p.hits + k * p.R + h0;

  // step x's hit rows (threads 0-63) and their input rows (threads
  // 64-127): 4-byte copies into index slot x % kDwIdxSlots, zero past
  // the split's last hit
  auto load_r = [&](int x) {
    if (tid < kDwHits) {
      const bool ok = x * kDwHits + tid < nh;
      cp_async4(&s.r[x % kDwIdxSlots][tid], ok ? hl + x * kDwHits + tid : hl, ok);
    }
  };
  auto load_id = [&](int x) {
    const int i = tid - kDwHits;
    if (i >= 0 && i < kDwHits) {
      const bool ok = x * kDwHits + i < nh;
      const int r = s.r[x % kDwIdxSlots][i];
      cp_async4(&s.id[x % kDwIdxSlots][i],
                ok ? p.nbr + static_cast<long long>(r) * p.K3 + k : p.nbr, ok);
    }
  };
  // step x's operands into `stage`: 16-byte copies by every thread
  // (consecutive threads along a row), each at its address in the
  // 128-byte swizzle of its atom (ops/sparse.py::bf16_dw_copy_offset
  // mirrors it); the x rows from c0 on and the g rows from n0 on, zero
  // past the split's last hit and past C_in / C_out
  auto load_rows = [&](int x, int stage) {
    const int slot = x % kDwIdxSlots, hb = x * kDwHits;
    const unsigned sa = ring + stage * R::kStage;
    constexpr int kChunksA = BM / 8, kChunksG = BN / 8;
#pragma unroll
    for (int i = 0; i < kDwHits * kChunksA / kThreads; ++i) {
      const int e = tid + i * kThreads, h = e / kChunksA, c = e % kChunksA;
      const int ch = c0 + c * 8;
      const bool ok = hb + h < nh && ch < p.C_in;
      const bf16* src = p.feats;
      if (ok) {
        const int r = s.r[slot][h];
        src += (static_cast<long long>(r / p.V_out) * p.V_in + s.id[slot][h]) * p.C_in + ch;
      }
      cp_async16_to(sa + (c / 8) * kDwAtom + swizzle<128>(h * 128 + (c % 8) * 16), src, ok);
    }
#pragma unroll
    for (int i = 0; i < kDwHits * kChunksG / kThreads; ++i) {
      const int e = tid + i * kThreads, h = e / kChunksG, c = e % kChunksG;
      const int n = n0 + c * 8;
      const bool ok = hb + h < nh && n < p.C_out;
      const bf16* src = ok ? p.g + static_cast<long long>(s.r[slot][h]) * p.C_out + n : p.g;
      cp_async16_to(sa + R::kA + (c / 8) * kDwAtom + swizzle<128>(h * 128 + (c % 8) * 16), src,
                    ok);
    }
  };

  // 2. the prologue: the hit rows of the first 3D steps, then their
  // input rows for the first 2D, then the operands of the first D
#pragma unroll 1
  for (int x = 0; x < 3 * D && x < n_steps; ++x) load_r(x);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll 1
  for (int x = 0; x < 2 * D && x < n_steps; ++x) load_id(x);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int x = 0; x < D; ++x) {
    if (x < n_steps) load_rows(x, x);
    cp_async_commit();
  }

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  // A: this warpgroup's 64 input channels (atom wg of the x tile; atom 0
  // for both where kSplitK), MN-major; B: the g tile, N-major. k-slices
  // of 16 hits 2048 bytes apart, 8-hit groups 1024 apart, 64-channel
  // atoms kDwAtom apart
  const unsigned a_wg = kSplitK ? 0u : static_cast<unsigned>(wg * kDwAtom);
  const int kk0 = kSplitK ? 2 * wg : 0, kk1 = kSplitK ? kk0 + 2 : kDwHits / 16;

  // 3. the pipeline. Iteration st: step st's operands have landed (every
  // thread's copies, then the barrier); step st + D's operands go into
  // the stage that step st - 2 used (its MMAs finished before this
  // barrier), step st + 2D's input rows and step st + 3D's hit rows into
  // their slots; the warpgroups multiply step st while step st - 1's
  // MMAs may still run.
  for (int st = 0; st < n_steps; ++st) {
    cp_async_wait<D - 1>();
    fence_proxy_async();
    __syncthreads();
    if (st + D < n_steps) load_rows(st + D, (st + D) % S);
    if (st + 2 * D < n_steps) load_id(st + 2 * D);
    if (st + 3 * D < n_steps) load_r(st + 3 * D);
    cp_async_commit();
    const unsigned sa = ring + (st % S) * R::kStage;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = kk0; kk < kk1; ++kk)
      wgmma_tile<BN, 1>(acc, wgmma_desc(sa + a_wg + kk * 2048, kDwAtom, 1024, 1),
                        wgmma_desc(sa + R::kA + kk * 2048, kDwAtom, 1024, 1));
    wgmma_commit();
    wgmma_wait<kInFlight>();
    fence_acc(acc);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  cp_async_wait<0>();

  // 4. kSplitK: warpgroup 1's sums through the (now idle) ring, added to
  // warpgroup 0's: one order, the same bits every run
  if constexpr (kSplitK) {
    float* red = reinterpret_cast<float*>(smem);
    __syncthreads();
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) red[i * 128 + tid - 128] = acc[i];
    }
    __syncthreads();
    if (wg == 1) return;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += red[i * 128 + tid];
  }

  // 5. write back: into dW[k] where offset k has one split, else into the
  // split's workspace slot. Thread (warp w of the warpgroup, lane g * 4 +
  // q) holds input channels 16w + g and 16w + g + 8 of its 64, output
  // channels 8j + 2q and 8j + 2q + 1 of each 8-column block j.
  const long long CC = static_cast<long long>(p.C_in) * p.C_out;
  float* out = n_split == 1 ? p.dw + k * CC : p.ws + (s.plan.wbase[k] + split) * CC;
  const int w4 = (tid & 127) >> 5, gq = (tid & 31) >> 2, q2 = (tid & 3) * 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int c = c0 + (kSplitK ? 0 : wg * 64) + w4 * 16 + gq + half * 8;
    if (c >= p.C_in) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + j * 8 + q2;
      if (n >= p.C_out) continue;
      store2(out + static_cast<long long>(c) * p.C_out + n, acc[4 * j + 2 * half],
             acc[4 * j + 2 * half + 1]);
    }
  }
}

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads, 1)
    sparse_conv_dw_bf16_tile(const __grid_constant__ DwArgs p) {
  dw_tile<BM, BN>(p);
}

// dW[k] = the sum over k's splits, in order, of their partials, for the
// offsets with more than one split: a grid-stride pass over those
// offsets' elements alone, 16 bytes a thread. One order, so the same
// bits every run.
__global__ void sparse_conv_dw_bf16_sum(const float* __restrict__ ws,
                                        const int* __restrict__ counts, int K3, int max_splits,
                                        long long CC, float* __restrict__ dw) {
  __shared__ DwPlan t;
  __shared__ int split_k[kMaxK3];
  __shared__ int n_split;
  if (threadIdx.x < 32) {
    dw_plan(counts, K3, max_splits, t);
    __syncwarp();
    const int lane = threadIdx.x;
    const bool many = lane < K3 && t.S[lane] > 1;
    const unsigned m = __ballot_sync(0xffffffffu, many);
    if (many) split_k[__popc(m & ((1u << lane) - 1u))] = lane;
    if (lane == 0) n_split = __popc(m);
  }
  __syncthreads();
  const long long n4 = CC / 4, total = n_split * n4;
  const float4* w = reinterpret_cast<const float4*>(ws);
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < total;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int k = split_k[e / n4];
    const long long off = e % n4;
    const float4* src = w + t.wbase[k] * n4 + off;
    float4 a = src[0];
    for (int i = 1; i < t.S[k]; ++i) {
      const float4 v = src[i * n4];
      a.x += v.x;
      a.y += v.y;
      a.z += v.z;
      a.w += v.w;
    }
    reinterpret_cast<float4*>(dw)[k * n4 + off] = a;
  }
}

// The split table of `counts` (K3 <= 32) for `max_splits`: out[0] the
// chunk, out[1 + k] offset k's splits. One warp: the check of its
// mirror, ops/sparse.py::bf16_dw_split_table.
__global__ void sparse_conv_dw_bf16_table(const int* counts, int K3, int max_splits, int* out) {
  __shared__ DwPlan t;
  dw_plan(counts, K3, max_splits, t);
  __syncwarp();
  if (threadIdx.x == 0) out[0] = t.chunk;
  if (static_cast<int>(threadIdx.x) < K3) out[1 + threadIdx.x] = t.S[threadIdx.x];
}

template <int BM, int BN>
cudaError_t launch_dw(const DwArgs& p, int tiles, cudaStream_t st) {
  constexpr int smem = DwRing<BM, BN>::kSmem;
  const cudaError_t e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(&sparse_conv_dw_bf16_tile<BM, BN>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  sparse_conv_dw_bf16_tile<BM, BN><<<dim3(p.max_splits, tiles), kThreads, smem, st>>>(p);
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
// device. bm = 64 or 128 input, bn = 64, 128 or 256 output channels a
// block; the grid holds max_splits (>= K3) splits of each channel tile
// (ops/sparse.py::bf16_dw_launch). Where max_splits > K3 an offset may
// split: `workspace` then holds (max_splits, C_in, C_out) floats and
// `sum_blocks` blocks add the partials; with max_splits = K3 no offset
// splits and neither is read.
extern "C" int ptt_sparse_conv_dw_bf16(const void* feats, const void* nbr, const void* g,
                                       const void* hits, const void* counts, int B, int V_in,
                                       int V_out, int K3, int C_in, int C_out, int bm, int bn,
                                       int max_splits, int sum_blocks, void* workspace,
                                       void* dw, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long CC = static_cast<long long>(C_in) * C_out;
  if (K3 < 1 || K3 > kMaxK3 || max_splits < K3 || C_in % 16 || C_out % 16 ||
      !aligned16(feats) || !aligned16(g) || (bm != 64 && bm != 128) ||
      (bn != 64 && bn != 128 && bn != 256) || (max_splits > K3 && sum_blocks < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (CC == 0) return static_cast<int>(cudaGetLastError());
  DwArgs p;
  p.feats = static_cast<const bf16*>(feats);
  p.nbr = static_cast<const int*>(nbr);
  p.g = static_cast<const bf16*>(g);
  p.hits = static_cast<const int*>(hits);
  p.counts = static_cast<const int*>(counts);
  p.V_in = V_in; p.V_out = V_out; p.K3 = K3; p.C_in = C_in; p.C_out = C_out;
  p.max_splits = max_splits;
  p.R = static_cast<long long>(B) * V_out;
  p.ws = static_cast<float*>(workspace);
  p.dw = static_cast<float*>(dw);
  const int tiles = ((C_in + bm - 1) / bm) * ((C_out + bn - 1) / bn);
  cudaError_t e;
  if (bm == 128)
    e = bn == 256 ? launch_dw<128, 256>(p, tiles, st)
        : bn == 128 ? launch_dw<128, 128>(p, tiles, st)
                    : launch_dw<128, 64>(p, tiles, st);
  else
    e = bn == 256 ? launch_dw<64, 256>(p, tiles, st)
        : bn == 128 ? launch_dw<64, 128>(p, tiles, st)
                    : launch_dw<64, 64>(p, tiles, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (max_splits > K3)
    sparse_conv_dw_bf16_sum<<<sum_blocks, 256, 0, st>>>(p.ws, p.counts, K3, max_splits, CC,
                                                        p.dw);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of the dW block of a (bm, bn) launch shape, -1
// for a shape the kernel does not take (ops/sparse.py::bf16_dw_launch
// computes the same).
extern "C" int ptt_sparse_conv_dw_bf16_smem(int bm, int bn) {
  if (bm == 128)
    return bn == 256 ? DwRing<128, 256>::kSmem : bn == 128 ? DwRing<128, 128>::kSmem
                                             : bn == 64 ? DwRing<128, 64>::kSmem : -1;
  if (bm == 64)
    return bn == 256 ? DwRing<64, 256>::kSmem : bn == 128 ? DwRing<64, 128>::kSmem
                                            : bn == 64 ? DwRing<64, 64>::kSmem : -1;
  return -1;
}

// The dW split table of device `counts` (K3 <= 32) for `max_splits` into
// device `out` (1 + K3 ints: the chunk, then each offset's splits).
extern "C" int ptt_sparse_conv_dw_bf16_table(const void* counts, int K3, int max_splits,
                                             void* out, void* stream) {
  if (K3 < 1 || K3 > kMaxK3 || max_splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  sparse_conv_dw_bf16_table<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(counts), K3, max_splits, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
