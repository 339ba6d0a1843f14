// The bf16 form of the sparse-conv kernels, on Hopper's bf16 tensor cores:
//   forward and input gradient  out[b, v] = sum_k bf16(x[b, nbr[b, v, k]]) @ bf16(W[k])
//   weight gradient             dW[k] = sum_{b, v} bf16(x[b, nbr[b, v, k]])^T bf16(g[b, v])
// over hits (nbr >= 0), each product exact in float32, the sums in float32
// (mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32). The forward writes float32
// or bf16 (rounded to nearest even once, from the float32 sum), zero at
// masked outputs; dW writes float32. The operands arrive as bf16: the
// wrapper (ops/sparse.py) rounds float32 inputs once, before the launch,
// and zero-pads C_in and C_out to multiples of 16.
//
// Replaces the bf16 arithmetic of the TPU kernels in proxytransformation_tpu/
// ops/sparse_conv_pallas.py: ::sparse_conv_gather_gemm_colwin (:744; the casts
// at :782-783), whose function ::sparse_conv_gather_gemm (:177; :210-211)
// also computes, and ::sparse_conv_dw_gather_gemm (:399; :422, :436); their
// VMEM rings hold bf16 (:256, :477, :845, :882). The float32 kernels of
// sparse_conv.cu and sparse_conv_dw.cu stay as they are; this file keeps its
// own copy of their tile set-up and split table so that they do not change.
//
// Bound on the H100: 2 * hits * C_in * C_out bf16 operations over the dense
// bf16 tensor-core rate (989 TFLOP/s), or the bytes of x, nbr, W (g) and the
// output over 3.35 TB/s, whichever is larger.
//
// Design (sparse_conv.cu's plan, tiles and ring; the inner product on the
// tensor cores):
//  * Forward / input gradient: a block owns 128 mask-sorted rows x 128 (64)
//    output channels and walks only the offsets in the OR of its rows' hit
//    masks. The (offset, 16-channel) steps stream through a 4-stage cp.async
//    ring as bf16: a step is 128 gathered rows x 16 channels (one 16-byte
//    copy per thread, zero-filled at a miss) and the W[k] slice 16 x 128.
//    A step is exactly one k16 slice of the MMA: each warp owns 16 sorted
//    rows (one m16 tile), loads its A fragment with one ldmatrix.x4 and the
//    B fragments with ldmatrix.x4.trans, and keeps 16 x 128 float32 sums in
//    registers; a warp none of whose rows hits the step's offset skips it.
//    Rows are padded in shared memory (48-byte A rows, +16 bytes on W rows)
//    so that the ldmatrix phases are free of bank conflicts. Small levels
//    split the steps across blocks into a float32 workspace that a second
//    kernel adds in split order and converts.
//  * dW: a block owns (offset k, a split of k's compacted hit list, a 128
//    (64) x 128 (64) tile of dW[k]); the hits are the MMA's k. 32 hits a
//    step through a 3-stage ring: the gathered x rows and the g rows at the
//    hits, as bf16; A fragments by ldmatrix.x4.trans of the hit-major x
//    tile. Each warp owns a 32 x WN tile. Splits are added in a fixed order
//    by a second kernel: the same bits every run.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kMaxK3 = 32;

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
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

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16_rn(x); }

// ---------------------------------------------------------------- forward
constexpr int kRows = 128;             // mask-sorted rows per block
constexpr int kStepC = 16;             // input channels per step = MMA k
constexpr int kStrideA = kStepC + 8;   // bf16 per staged row (48 bytes)
constexpr int kStages = 4;             // cp.async ring depth

struct ConvArgs {
  const bf16* feats;        // (B, V_in, C_in)
  const int* nbr;           // (B, V_out, K3)
  const bf16* w;            // (K3, C_in, C_out)
  const uint8_t* out_mask;  // (B, V_out)
  const int* row_mask;      // (B, V_out)
  const int* order;         // (B, V_out)
  int B, V_in, V_out, K3, C_in, C_out, splits;
  void* out;  // (B, V_out, C_out), or the float (splits, B, V_out, C_out) workspace
};

template <int BN>
struct TileSmem {
  bf16 a[kStages][kRows * kStrideA];       // gathered rows, row-major
  bf16 w[kStages][kStepC * (BN + 8)];      // W[k][c0:c0+16, n0:n0+BN]
  int idx[kMaxK3][kRows];                  // map entries of the active offsets
  int rows[kRows];                         // original row of each tile row
  int keep[kRows];
  int act[kMaxK3];                         // the active offsets, ascending
  unsigned grp_or[kRows / 16];             // OR of each warp's 16 rows' masks
  unsigned mask_or;
};

template <int BN, typename OutT>
__device__ __forceinline__ void conv_tile(const ConvArgs& p) {
  constexpr int kStrideW = BN + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TileSmem<BN>& s = *reinterpret_cast<TileSmem<BN>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z / p.splits, split = blockIdx.z % p.splits;
  const int t0 = blockIdx.x * kRows, n0 = blockIdx.y * BN;
  const long long rb = static_cast<long long>(b) * p.V_out;

  // 1. the tile's rows in mask order and the OR of their masks
  if (tid == 0) s.mask_or = 0u;
  __syncthreads();
  unsigned m = 0u;
  if (tid < kRows) {
    const int pos = t0 + tid;
    int v = -1, keep = 0;
    if (pos < p.V_out) {
      v = p.order[rb + pos];
      keep = p.out_mask[rb + v] != 0;
      if (keep) m = static_cast<unsigned>(p.row_mask[rb + v]);
    }
    s.rows[tid] = v;
    s.keep[tid] = keep;
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) m |= __shfl_xor_sync(0xffffffffu, m, off);
  if (tid < kRows && (tid & 15) == 0) s.grp_or[tid / 16] = m;
  m = __reduce_or_sync(0xffffffffu, m);
  if (lane == 0 && m) atomicOr(&s.mask_or, m);
  __syncthreads();
  const unsigned mask_or = s.mask_or;
  const int n_act = __popc(mask_or);
  if (tid == 0) {
    unsigned mm = mask_or;
    for (int j = 0; mm; ++j, mm &= mm - 1) s.act[j] = __ffs(mm) - 1;
  }
  __syncthreads();
  // 2. the map entries of the active offsets, -1 for dropped rows
  for (int e = tid; e < n_act * kRows; e += kThreads) {
    const int j = e / kRows, t = e % kRows;
    s.idx[j][t] = s.keep[t] ? p.nbr[(rb + s.rows[t]) * p.K3 + s.act[j]] : -1;
  }
  __syncthreads();

  // 3. this block's range of (offset, channel-step) steps
  const int n_c = p.C_in / kStepC;
  const long long total = static_cast<long long>(n_act) * n_c;
  const int s_begin = static_cast<int>(total * split / p.splits);
  const int n_steps = static_cast<int>(total * (split + 1) / p.splits) - s_begin;
  const bf16* fb = p.feats + static_cast<long long>(b) * p.V_in * p.C_in;

  auto load = [&](int step, int stage) {
    const int j = step / n_c;
    const int c0 = (step - j * n_c) * kStepC;
    {  // a row's 16 channels are two 16-byte copies: one a thread
      const int t = tid >> 1, h = (tid & 1) * 8;
      const int id = s.idx[j][t];
      const bool ok = id >= 0;
      cp_async16(s.a[stage] + t * kStrideA + h,
                 ok ? fb + static_cast<long long>(id) * p.C_in + c0 + h : fb, ok);
    }
    const bf16* wk = p.w + static_cast<long long>(s.act[j]) * p.C_in * p.C_out;
    for (int e = tid; e < kStepC * BN / 8; e += kThreads) {
      const int c = e / (BN / 8), q = e % (BN / 8) * 8;
      const bool ok = n0 + q < p.C_out;
      cp_async16(s.w[stage] + c * kStrideW + q,
                 ok ? wk + static_cast<long long>(c0 + c) * p.C_out + n0 + q : wk, ok);
    }
  };

  float acc[BN / 8][4];
#pragma unroll
  for (int i = 0; i < BN / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // 4. the pipeline: iteration st waits for step st, issues step st+3 into
  // the stage step st-1 used (every warp is past it: the barrier), then
  // multiplies step st
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_steps) load(s_begin + st, st);
    cp_async_commit();
  }
  const int a_row = warp * 16 + (lane & 15), a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8, b_col = (lane >> 4) * 8;
  for (int st = 0; st < n_steps; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int ahead = st + kStages - 1;
    if (ahead < n_steps) load(s_begin + ahead, ahead % kStages);
    cp_async_commit();
    if (!((s.grp_or[warp] >> s.act[(s_begin + st) / n_c]) & 1u)) continue;
    const bf16* a = s.a[st % kStages];
    const bf16* w = s.w[st % kStages];
    unsigned af[4];
    ldmatrix_x4(af, a + a_row * kStrideA + a_col);
#pragma unroll
    for (int nb = 0; nb < BN / 16; ++nb) {
      unsigned bfr[4];
      ldmatrix_x4_trans(bfr, w + b_row * kStrideW + nb * 16 + b_col);
      mma_bf16(acc[2 * nb], af, bfr[0], bfr[1]);
      mma_bf16(acc[2 * nb + 1], af, bfr[2], bfr[3]);
    }
  }
  cp_async_wait<0>();

  // 5. write back to the original rows; zero at masked outputs. Lane
  // (g, t) holds rows g and g + 8 of its warp's 16, columns 2t, 2t + 1
  // of each 8-column block.
  OutT* ob = static_cast<OutT*>(p.out) +
             (static_cast<long long>(split) * p.B + b) * p.V_out * p.C_out;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = warp * 16 + g + half * 8;
    const int v = s.rows[r];
    if (v < 0) continue;
    const bool keep = s.keep[r] != 0;
    OutT* o = ob + static_cast<long long>(v) * p.C_out;
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
      const int n = n0 + nb * 8 + t2;
      if (n >= p.C_out) continue;
      store2(o + n, keep ? acc[nb][2 * half] : 0.f, keep ? acc[nb][2 * half + 1] : 0.f);
    }
  }
}

// out[e] = sum over s in order of ws[s][e], converted once
template <typename OutT>
__device__ __forceinline__ void sum_splits(const float* __restrict__ ws, long long n, int S,
                                           OutT* __restrict__ out) {
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (e >= n) return;
  float acc = 0.f;
  for (int i = 0; i < S; ++i) acc += ws[i * n + e];
  out[e] = from_float<OutT>(acc);
}

// the forward and the input gradient: one body, two symbols each
template <int BN, typename OutT>
__global__ void __launch_bounds__(kThreads, 2) sparse_conv_fwd_bf16_tile(ConvArgs p) {
  conv_tile<BN, OutT>(p);
}
template <int BN, typename OutT>
__global__ void __launch_bounds__(kThreads, 2) sparse_conv_dfeats_bf16_tile(ConvArgs p) {
  conv_tile<BN, OutT>(p);
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

template <int BN, typename OutT>
ConvKernel tile_kernel_of(int role) {
  return role == 0 ? &sparse_conv_fwd_bf16_tile<BN, OutT> : &sparse_conv_dfeats_bf16_tile<BN, OutT>;
}

template <int BN>
ConvKernel tile_kernel(int role, bool out_f32) {
  return out_f32 ? tile_kernel_of<BN, float>(role) : tile_kernel_of<BN, bf16>(role);
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
constexpr int kMinChunk = 256;   // hits a split takes at least ...
constexpr int kMaxChunk = 4096;  // ... and at most

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

struct SplitTable {
  int chunk, total;
  int S[kMaxK3], base[kMaxK3];
};

// Splits of every offset's hit list (sparse_conv_dw.cu::split_table): a
// function of the counts alone, so every block and the sum pass agree.
__device__ void split_table(const int* counts, int K3, int pairs_target, SplitTable& t) {
  long long H = 0;
  for (int k = 0; k < K3; ++k) H += counts[k];
  long long chunk = (H + pairs_target - 1) / pairs_target;
  chunk = chunk < kMinChunk ? kMinChunk : chunk > kMaxChunk ? kMaxChunk : chunk;
  int base = 0;
  for (int k = 0; k < K3; ++k) {
    const int S = static_cast<int>((counts[k] + chunk - 1) / chunk);
    t.S[k] = S;
    t.base[k] = base;
    base += S;
  }
  t.chunk = static_cast<int>(chunk);
  t.total = base;
}

struct Split {
  int k, nh;
  long long h0;
};

// This block's offset and hit range, its hit rows and input rows in
// shared memory; nh = 0 when the block is past the last split.
__device__ __forceinline__ Split load_split(const DwArgs& p, SplitTable& t, int* r_s,
                                            int* id_s) {
  if (threadIdx.x == 0) split_table(p.counts, p.K3, p.pairs_target, t);
  __syncthreads();
  const int pair = blockIdx.x;
  Split sp{0, 0, 0};
  if (pair >= t.total) return sp;
  while (pair >= t.base[sp.k] + t.S[sp.k]) ++sp.k;
  sp.h0 = static_cast<long long>(pair - t.base[sp.k]) * t.chunk;
  const long long left = p.counts[sp.k] - sp.h0;
  sp.nh = static_cast<int>(left < t.chunk ? left : t.chunk);
  const int* hl = p.hits + sp.k * p.R + sp.h0;
  for (int e = threadIdx.x; e < sp.nh; e += kThreads) {
    const int r = hl[e];
    r_s[e] = r;
    id_s[e] = p.nbr[static_cast<long long>(r) * p.K3 + sp.k];
  }
  __syncthreads();
  return sp;
}

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
  const Split sp = load_split(p, s.t, s.r, s.id);
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
  __shared__ SplitTable t;
  if (threadIdx.x == 0) split_table(counts, K3, pairs_target, t);
  __syncthreads();
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (e >= K3 * CC) return;
  const int k = static_cast<int>(e / CC);
  const long long off = e % CC;
  float acc = 0.f;
  for (int i = 0; i < t.S[k]; ++i) acc += ws[(t.base[k] + i) * CC + off];
  dw[e] = acc;
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

}  // namespace

// feats (B, V_in, C_in) bf16, nbr (B, V_out, K3) int32, weights (K3, C_in,
// C_out) bf16, out_mask (B, V_out) bool, row_mask and order (B, V_out) int32
// from the map's plan; C_in and C_out multiples of 16, feats and weights
// 16-byte aligned; all contiguous on the device. role 0 = forward, 1 =
// input gradient (only the kernel symbols differ). out (B, V_out, C_out) is
// float32 where out_f32 != 0, else bf16. cols 128 or 64 output channels a
// block; splits >= 1, and for splits > 1 `workspace` holds splits * B *
// V_out * C_out floats.
extern "C" int ptt_sparse_conv_bf16(const void* feats, const void* nbr, const void* weights,
                                    const void* out_mask, const void* row_mask,
                                    const void* order, int B, int V_in, int V_out, int K3,
                                    int C_in, int C_out, int role, int out_f32, int cols,
                                    int splits, void* workspace, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K3 < 1 || K3 > kMaxK3 || splits < 1 || (role != 0 && role != 1) ||
      (cols != 64 && cols != 128) || C_in <= 0 || C_in % kStepC || C_out % kStepC ||
      !aligned16(feats) || !aligned16(weights))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || V_out <= 0 || C_out <= 0) return static_cast<int>(cudaGetLastError());
  ConvArgs p;
  p.feats = static_cast<const bf16*>(feats);
  p.nbr = static_cast<const int*>(nbr);
  p.w = static_cast<const bf16*>(weights);
  p.out_mask = static_cast<const uint8_t*>(out_mask);
  p.row_mask = static_cast<const int*>(row_mask);
  p.order = static_cast<const int*>(order);
  p.B = B; p.V_in = V_in; p.V_out = V_out; p.K3 = K3; p.C_in = C_in; p.C_out = C_out;
  p.splits = splits;
  // split partials are float32 whatever the output type
  const bool tile_f32 = out_f32 != 0 || splits > 1;
  p.out = splits > 1 ? workspace : out;
  ConvKernel kernel;
  size_t smem;
  if (cols == 128) {
    kernel = tile_kernel<128>(role, tile_f32);
    smem = sizeof(TileSmem<128>);
  } else {
    kernel = tile_kernel<64>(role, tile_f32);
    smem = sizeof(TileSmem<64>);
  }
  cudaError_t e = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((V_out + kRows - 1) / kRows, (C_out + cols - 1) / cols, B * splits);
  kernel<<<grid, kThreads, smem, st>>>(p);
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
