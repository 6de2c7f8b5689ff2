// W8A8 matrix product for Hopper (sm_90a): y = (f32(xq @ wq) * xs) * ws,
// xq [M, K] int8 activations quantized per row (scale xs [M]), wq [K, N]
// int8 weights with one float32 scale per output column (ws [N]), the
// product accumulated exactly in int32, the result cast to the output
// dtype.
//
// Replaces the Pallas TPU kernel symmetry_tpu/ops/qmm.py `_kernel` (called
// from `w8a8_matmul`, pl.pallas_call at qmm.py:129). No serving path of
// either package routes it; it is a tested building block.
//
// Bit-reproducible: the int32 sums are exact whatever their order, and the
// epilogue is two rounded multiplies in the plain version's order,
// (f32(acc) * xs) * ws, written with __fmul_rn so that nothing is
// contracted into an FMA. The kernel equals its plain version bit for bit.
//
// Bound: operations at prefill row counts (M = 2048 against a 4096 x 14336
// weight does 2.4e11 int8 operations, 0.12 ms at the card's dense int8
// peak), bytes at decode row counts (the weight's K * N bytes dominate).
// Design, a first version: 128 x 128 output tiles, 8 warps of 64 x 32,
// mma.sync m16n8k32 s8 x s8 -> s32 fragments. Each 64-deep K step stages
// the x tile as it lies (K-contiguous rows) and the weight tile transposed
// to [n][k] (the `col` operand must be K-contiguous): a thread reads a
// 4 x 8 int8 block of the flat [K, N] weight and transposes it in
// registers with byte permutes before the shared-memory store. The next
// step's global loads are in flight in registers during the MMAs. The grid
// walks M fastest, so a weight column tile is read from device memory once
// and from L2 by the other row tiles.
// Not yet: wgmma, TMA, a multi-stage pipeline, a narrow-M tile for decode
// row counts (later work).
#include <stdint.h>

#include "common.cuh"

namespace symtorch {
namespace {

constexpr int BM = 128, BN = 128, BK = 64, THREADS = 256;
// Row pitch of both shared tiles: 64 data bytes + 16 of padding, so the
// fragment loads (8 rows x 4 words per instruction) hit 32 distinct banks.
constexpr int PITCH = BK + 16;

// Weight-tile word swizzle: rows whose bit 3 is set store their 16 words
// XOR 8, halving the bank conflicts of the transposed stores; a fragment
// load XORs the same lane-uniform value.
__device__ __forceinline__ int bswz(int n) { return ((n >> 3) & 1) << 3; }

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Transpose a 4 x 4 byte block: r[i] holds bytes (k = i, n = 0..3); on
// return c[j] holds bytes (k = 0..3, n = j).
__device__ __forceinline__ void transpose4(const uint32_t (&r)[4],
                                           uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

template <typename TO>
__global__ void __launch_bounds__(THREADS)
w8a8_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ w,
            const float* __restrict__ xs, const float* __restrict__ ws,
            TO* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) int8_t As[BM][PITCH];
  __shared__ __align__(16) int8_t Bs[BN][PITCH];

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;      // mma fragment coordinates
  const int wm = warp & 1, wn = warp >> 1;    // warp tile: rows wm*64, cols wn*32

  // Weight staging: this thread's 4 (k) x 8 (n) block of the tile.
  const int n8 = (lane >> 3) + 4 * (warp & 3);  // 0..15
  const int k4 = (lane & 7) + 8 * (warp >> 2);  // 0..15

  uint4 xr[2];
  uint2 wr[4];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      const int row = c >> 2, col = (c & 3) * 16;
      xr[i] = (m0 + row < M && k0 + col < K)
                  ? *reinterpret_cast<const uint4*>(
                        xq + (long long)(m0 + row) * K + k0 + col)
                  : make_uint4(0, 0, 0, 0);
    }
    const int n = n0 + n8 * 8;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = k0 + k4 * 4 + r;
      wr[r] = (k < K && n < N)
                  ? *reinterpret_cast<const uint2*>(w + (long long)k * N + n)
                  : make_uint2(0, 0);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      *reinterpret_cast<uint4*>(&As[c >> 2][(c & 3) * 16]) = xr[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t r[4] = {h ? wr[0].y : wr[0].x, h ? wr[1].y : wr[1].x,
                             h ? wr[2].y : wr[2].x, h ? wr[3].y : wr[3].x};
      uint32_t c[4];
      transpose4(r, c);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n8 * 8 + h * 4 + j;
        reinterpret_cast<uint32_t*>(&Bs[n][0])[k4 ^ bswz(n)] = c[j];
      }
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nk = (K + BK - 1) / BK;
  load(0);
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();  // the previous step's fragments are loaded
    store();
    __syncthreads();
    if (kt + 1 < nk) load((kt + 1) * BK);  // in flight during the MMAs
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      const int kw = kk / 4 + t;  // word column of this lane's fragments
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = wm * 64 + i * 16 + g;
        const uint32_t* lo = reinterpret_cast<const uint32_t*>(&As[row][0]);
        const uint32_t* hi =
            reinterpret_cast<const uint32_t*>(&As[row + 8][0]);
        a[i][0] = lo[kw];
        a[i][1] = hi[kw];
        a[i][2] = lo[kw + 4];
        a[i][3] = hi[kw + 4];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn * 32 + j * 8 + g;
        const uint32_t* col = reinterpret_cast<const uint32_t*>(&Bs[n][0]);
        b[j][0] = col[kw ^ bswz(n)];
        b[j][1] = col[(kw + 4) ^ bswz(n)];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
  }

  // Epilogue: c0, c1 at (row g, cols 2t, 2t + 1), c2, c3 at row g + 8.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 64 + i * 16 + g + half * 8;
      if (m >= M) continue;
      const float sx = xs[m];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + j * 8 + 2 * t;
        if (n >= N) continue;  // N % 8 == 0: n + 1 < N as well
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = __fmul_rn(
              __fmul_rn(__int2float_rn(acc[i][j][half * 2 + e]), sx),
              ws[n + e]);
          out[(long long)m * N + n + e] = from_f<TO>(v);
        }
      }
    }
  }
}

template <typename TO>
cudaError_t launch(const void* xq, const void* w, const void* xs,
                   const void* ws, void* out, int M, int K, int N,
                   cudaStream_t s) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  w8a8_kernel<TO><<<grid, THREADS, 0, s>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(w),
      static_cast<const float*>(xs), static_cast<const float*>(ws),
      static_cast<TO*>(out), M, K, N);
  return cudaGetLastError();
}

}  // namespace
}  // namespace symtorch

// C entry point (ctypes). xq [M, K] int8 and w [K, N] int8, both contiguous
// and 16-byte aligned; xs [M] and ws [N] float32; out [M, N] in
// `out_dtype` (float32 or bfloat16). K must be a multiple of 16 and N of 8.
// Returns the cudaError_t of the launch.
extern "C" int w8a8_launch(int out_dtype, const void* xq, const void* w,
                           const void* xs, const void* ws, void* out, int M,
                           int K, int N, void* stream) {
  using namespace symtorch;
  if (M <= 0 || K <= 0 || N <= 0 || K % 16 || N % 8)
    return cudaErrorInvalidValue;
  if ((M + BM - 1) / BM > 2147483647 || (N + BN - 1) / BN > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == kF32)
    return launch<float>(xq, w, xs, ws, out, M, K, N, s);
  if (out_dtype == kBF16)
    return launch<__nv_bfloat16>(xq, w, xs, ws, out, M, K, N, s);
  return cudaErrorInvalidValue;
}
