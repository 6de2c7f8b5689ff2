// W8A16 matrix product for Hopper (sm_90a): y = (x @ q) * scale, x [M, K]
// in bf16 or f32, q an int8 weight [K, N] with one f32 scale per output
// column, products accumulated in float32, the scale applied once at the
// end, the result cast to the output dtype (or left raw in f32 when the
// scale is off).
//
// Replaces the Pallas TPU kernel symmetry_tpu/ops/qmm.py `_w8a16_kernel`
// (called from `w8a16_matmul`, pl.pallas_call at qmm.py:251).
//
// Weight layout (ops/quant.py PackedQuantizedTensor): [N / 64, K, 64], one
// contiguous panel of 64 output columns per leading index, so a block that
// owns a panel streams one contiguous K * 64-byte run.
//
// The arithmetic is the mixed dot's exactly: an int8 value is exact in
// bf16 and in f32, a bf16 x int8 product is exact in f32, and only the
// summation order differs from the plain version.
//
// Two regimes, two kernels:
//  - M <= 16 rows (decode: one row per slot), and every f32 activation:
//    bytes bound -- each int8 weight byte must be read once and is used
//    2 * M times. `w8a16_gemv_kernel`: one block per (panel, 8 rows, K
//    split); a thread reads 8 columns of a weight row with one 8-byte load
//    and keeps 8 x 8 float32 sums in registers; the block's x rows sit in
//    shared memory, staged 256 K-rows at a time; 32 rows of the panel are
//    read per step by the 256 threads. Small panels counts (wk: 16 panels)
//    split K so that about 264 blocks are in flight; the splits' float32
//    partials are summed, scaled and cast by `w8a16_epilogue_kernel`.
//  - M > 16 bf16 rows (prefill: up to the 2048-row token budget):
//    operations bound. `w8a16_wmma_kernel`: 128 x 64 output tiles, 8 warps
//    of 32 x 32, WMMA bf16 16x16x16 fragments with float32 accumulators;
//    each 32-deep K step copies the x tile and the int8 weight tile,
//    converted to bf16, into shared memory, the next step's global loads
//    already in flight in registers. The grid walks M fastest, so a weight
//    panel is read from device memory once and from L2 by the other row
//    tiles.
// Not yet: TMA, wgmma, a deeper pipeline (later work).
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace symtorch {
namespace {

using namespace nvcuda;

constexpr int PW = 64;  // packed panel width (output columns)

// ---- GEMV regime -----------------------------------------------------------
constexpr int GV_THREADS = 256;
constexpr int GV_CPT = 8;                       // columns per thread
constexpr int GV_TPR = PW / GV_CPT;             // threads per panel row (8)
constexpr int GV_RPS = GV_THREADS / GV_TPR;     // panel rows per step (32)
constexpr int GV_MT = 8;                        // x rows per block
constexpr int GV_KC = 256;                      // K rows staged per chunk

template <typename TX, typename TO>
__global__ void __launch_bounds__(GV_THREADS)
w8a16_gemv_kernel(const TX* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale, TO* __restrict__ out,
                  float* __restrict__ part, int M, int K, int N,
                  int k_per_split, int apply_scale) {
  __shared__ __align__(16) float xs[GV_KC][GV_MT];
  __shared__ float red[GV_THREADS / 32][GV_MT][PW];

  const int panel = blockIdx.x;
  const int m0 = blockIdx.y * GV_MT;
  const int split = blockIdx.z;
  const int k_lo = split * k_per_split;
  const int k_hi = min(K, k_lo + k_per_split);
  const int tid = threadIdx.x;
  const int cg = tid % GV_TPR;   // column group: columns cg*8 .. cg*8+7
  const int r = tid / GV_TPR;    // row within a step
  const int mrows = min(GV_MT, M - m0);
  const int8_t* wp = w + (long long)panel * K * PW + cg * GV_CPT;

  float acc[GV_MT][GV_CPT];
#pragma unroll
  for (int m = 0; m < GV_MT; ++m)
#pragma unroll
    for (int c = 0; c < GV_CPT; ++c) acc[m][c] = 0.f;

  for (int kc = k_lo; kc < k_hi; kc += GV_KC) {
    const int kn = min(GV_KC, k_hi - kc);
    __syncthreads();
    for (int i = tid; i < GV_KC * GV_MT; i += GV_THREADS) {
      const int m = i / GV_KC, kk = i % GV_KC;
      xs[kk][m] = (m < mrows && kk < kn)
                      ? to_f(x[(long long)(m0 + m) * K + kc + kk])
                      : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = r; kk < kn; kk += GV_RPS) {
      const uint2 raw =
          *reinterpret_cast<const uint2*>(wp + (long long)(kc + kk) * PW);
      float wf[8];
      unpack8(raw, wf);
      const float4 xa = *reinterpret_cast<const float4*>(&xs[kk][0]);
      const float4 xb = *reinterpret_cast<const float4*>(&xs[kk][4]);
      const float xv[GV_MT] = {xa.x, xa.y, xa.z, xa.w,
                               xb.x, xb.y, xb.z, xb.w};
#pragma unroll
      for (int m = 0; m < GV_MT; ++m)
#pragma unroll
        for (int c = 0; c < GV_CPT; ++c)
          acc[m][c] = fmaf(xv[m], wf[c], acc[m][c]);
    }
  }

  // Sum the rows of a step: lanes cg, cg + 8, cg + 16, cg + 24 of a warp,
  // then the 8 warps through shared memory.
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int m = 0; m < GV_MT; ++m)
#pragma unroll
    for (int c = 0; c < GV_CPT; ++c) {
      float v = acc[m][c];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < GV_TPR) red[warp][m][cg * GV_CPT + c] = v;
    }
  __syncthreads();
  for (int i = tid; i < GV_MT * PW; i += GV_THREADS) {
    const int m = i / PW, col = i % PW;
    if (m >= mrows) continue;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < GV_THREADS / 32; ++wi) s += red[wi][m][col];
    const int n = panel * PW + col;
    const long long o = (long long)(m0 + m) * N + n;
    if (gridDim.z == 1) {
      out[o] = from_f<TO>(apply_scale ? s * scale[n] : s);
    } else {
      part[(long long)split * M * N + o] = s;
    }
  }
}

template <typename TO>
__global__ void w8a16_epilogue_kernel(const float* __restrict__ part,
                                      const float* __restrict__ scale,
                                      TO* __restrict__ out, int M, int N,
                                      int splits, int apply_scale) {
  const long long total = (long long)M * N;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += part[sp * total + i];
    out[i] = from_f<TO>(apply_scale ? s * scale[i % N] : s);
  }
}

// ---- WMMA regime -----------------------------------------------------------
constexpr int TM = 128, TN = PW, TK = 32;
constexpr int XS_LD = TK + 8;   // bf16 row pitch of the x tile (80 bytes)
constexpr int WS_LD = TN + 8;   // bf16 row pitch of the weight tile
constexpr int X_BYTES = TM * XS_LD * 2;
constexpr int W_BYTES = TK * WS_LD * 2;
constexpr int C_BYTES = 8 * 32 * 32 * 4;  // per-warp 32x32 f32 epilogue
constexpr int SMEM_BYTES =
    (X_BYTES + W_BYTES) > C_BYTES ? (X_BYTES + W_BYTES) : C_BYTES;

template <typename TO>
__global__ void __launch_bounds__(256)
w8a16_wmma_kernel(const __nv_bfloat16* __restrict__ x,
                  const int8_t* __restrict__ w,
                  const float* __restrict__ scale, TO* __restrict__ out,
                  int M, int K, int N, int apply_scale) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  auto xs = reinterpret_cast<__nv_bfloat16(*)[XS_LD]>(smem);
  auto ws = reinterpret_cast<__nv_bfloat16(*)[WS_LD]>(smem + X_BYTES);

  const int m0 = blockIdx.x * TM;
  const int panel = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2;  // warp tile: rows wm*32, cols wn*32
  const int8_t* wp = w + (long long)panel * K * PW;

  // Global -> register staging: two 16-byte x chunks and one 8-byte weight
  // chunk per thread per K step.
  uint4 xr[2];
  uint2 wr;
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * 256;
      const int row = c >> 2, col = (c & 3) * 8;
      xr[i] = m0 + row < M
                  ? *reinterpret_cast<const uint4*>(
                        x + (long long)(m0 + row) * K + k0 + col)
                  : make_uint4(0, 0, 0, 0);
    }
    wr = *reinterpret_cast<const uint2*>(wp + (long long)k0 * PW + tid * 8);
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * 256;
      *reinterpret_cast<uint4*>(&xs[c >> 2][(c & 3) * 8]) = xr[i];
    }
    float f[8];
    unpack8(wr, f);
    __align__(16) __nv_bfloat16 h[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) h[j] = __float2bfloat16(f[j]);  // exact
    *reinterpret_cast<uint4*>(&ws[tid >> 3][(tid & 7) * 8]) =
        *reinterpret_cast<const uint4*>(h);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.f);

  const int nk = K / TK;
  load(0);
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();  // the previous step's fragments are loaded
    store();
    __syncthreads();
    if (kt + 1 < nk) load((kt + 1) * TK);  // in flight during the MMAs
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &xs[wm * 32 + i * 16][kk], XS_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], &ws[kk][wn * 32 + j * 16], WS_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(c[i][j], a[i], bf[j], c[i][j]);
    }
  }

  // Epilogue: each warp parks its 32x32 sums in shared memory (reusing the
  // tiles), then writes 32 consecutive columns per row, scaled and cast.
  __syncthreads();
  float* cs = reinterpret_cast<float*>(smem) + warp * 32 * 32;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + i * 16 * 32 + j * 16, c[i][j], 32,
                              wmma::mem_row_major);
  __syncwarp();
  const int n = panel * PW + wn * 32 + lane;
  const float sc = apply_scale ? scale[n] : 1.f;
  for (int rr = 0; rr < 32; ++rr) {
    const int m = m0 + wm * 32 + rr;
    if (m < M) out[(long long)m * N + n] = from_f<TO>(cs[rr * 32 + lane] * sc);
  }
}

template <typename TX, typename TO>
cudaError_t launch(const void* x, const void* w, const void* scale,
                   void* out, void* part, int M, int K, int N, int splits,
                   int k_per_split, int apply_scale, cudaStream_t s) {
  const int panels = N / PW;
  if constexpr (std::is_same<TX, __nv_bfloat16>::value) {
    if (M > 16) {
      const dim3 grid((M + TM - 1) / TM, panels);
      w8a16_wmma_kernel<TO><<<grid, 256, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const int8_t*>(w), static_cast<const float*>(scale),
          static_cast<TO*>(out), M, K, N, apply_scale);
      return cudaGetLastError();
    }
  }
  const dim3 grid(panels, (M + GV_MT - 1) / GV_MT, splits);
  w8a16_gemv_kernel<TX, TO><<<grid, GV_THREADS, 0, s>>>(
      static_cast<const TX*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<TO*>(out),
      static_cast<float*>(part), M, K, N, k_per_split, apply_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long total = (long long)M * N;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256
                                                       : 4096);
  w8a16_epilogue_kernel<TO><<<blocks, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<const float*>(scale),
      static_cast<TO*>(out), M, N, splits, apply_scale);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t launch_o(int out_dtype, const void* x, const void* w,
                     const void* scale, void* out, void* part, int M, int K,
                     int N, int splits, int k_per_split, int apply_scale,
                     cudaStream_t s) {
  if (out_dtype == kF32)
    return launch<TX, float>(x, w, scale, out, part, M, K, N, splits,
                             k_per_split, apply_scale, s);
  if (out_dtype == kBF16)
    return launch<TX, __nv_bfloat16>(x, w, scale, out, part, M, K, N, splits,
                                     k_per_split, apply_scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace symtorch

// C entry point (ctypes). x [M, K] in `x_dtype`, contiguous, 16-byte
// aligned; w the packed int8 panels [N / 64, K, 64]; scale [N] float32;
// out [M, N] in `out_dtype`; part a float32 workspace of splits * M * N
// (unused when splits == 1 or on the WMMA path). K must be a multiple of
// 32 and N of 64. Returns the cudaError_t of the launches.
extern "C" int w8a16_launch(int x_dtype, int out_dtype, const void* x,
                            const void* w, const void* scale, void* out,
                            void* part, int M, int K, int N, int splits,
                            int k_per_split, int apply_scale, void* stream) {
  using namespace symtorch;
  if (M <= 0 || K <= 0 || N <= 0 || K % 32 || N % PW || splits < 1 ||
      k_per_split <= 0 || (long long)splits * k_per_split < K ||
      (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32)
    return launch_o<float>(out_dtype, x, w, scale, out, part, M, K, N, splits,
                           k_per_split, apply_scale, s);
  if (x_dtype == kBF16)
    return launch_o<__nv_bfloat16>(out_dtype, x, w, scale, out, part, M, K, N,
                                   splits, k_per_split, apply_scale, s);
  return cudaErrorInvalidValue;
}
