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
// contracted into an FMA. The kernel equals its plain version bit for bit,
// split over K or not.
//
// Bound: operations at prefill row counts (M = 2048 against a 4096 x 14336
// weight does 2.4e11 int8 operations, 0.12 ms at the card's dense int8
// peak), bytes at decode row counts (the weight's K * N bytes dominate).
// Design (`w8a8_tc_kernel`): one block per SM walks (output tile, K split)
// items, M fastest, so the blocks running together share a weight column
// tile and read it from device memory once. Four warpgroups:
//  - a producer thread copies the xq tile of a 128-deep K step (128 or 256
//    rows x 128 bytes) by TMA into a ring of four 128-byte-swizzled stages,
//    rows past M and columns past K zero-filled;
//  - a transposer warpgroup turns the weight's [k][n] bytes into the
//    K-major [n][k] tile the integer wgmma needs (it has no transpose bit,
//    and TMA cannot transpose bytes): a thread loads 16 (k) x 8 (n) bytes
//    a step ahead into registers (32-byte runs per k row across a warp),
//    transposes 4 x 4 byte blocks with byte permutes, and stores 16 bytes
//    of one n row's k run into the swizzled tile -- a quarter warp writes
//    one whole 128-byte row, so no store conflicts on a bank; a ring of
//    four tiles lets it run ahead of the products;
//  - two consumer warpgroups run wgmma m64n128k32 s8 x s8 -> s32 (four a
//    step for each 64-row block) with one step's group in flight while the
//    next step's barriers are awaited, then scale and store their rows.
// Few tiles with a long K (wd at M <= 128: 32 tiles, 112 steps) are split
// over K so that about one item per SM runs; each split stores its int32
// partial and `w8a8_reduce_kernel` sums them (exactly) and applies the
// scales.
#include <cuda.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace symtorch {
namespace {

constexpr int NT = 512;        // consumers 0 and 1, transposer 2, producer 3
constexpr int BN = 128;        // output columns per tile
constexpr int BK = 128;        // K values per step: one 128-byte row of xq
constexpr int STAGES = 4;      // xq stages
constexpr int BSTAGES = 4;     // transposed weight tiles
constexpr int B_BYTES = BN * BK;
constexpr int kConsumerRegs = 184;
constexpr int kTransposerRegs = 120;
constexpr int kProducerRegs = 24;

// MT: 64-row wgmma tiles per consumer warpgroup; a tile has 128 * MT rows.
template <int MT>
struct Cfg {
  static constexpr int BM = 128 * MT;
  static constexpr uint32_t A_BYTES = BM * BK;
  static constexpr size_t SMEM =
      1024 + size_t(STAGES) * A_BYTES + size_t(BSTAGES) * B_BYTES;
};

struct Bars {
  uint64_t a_full[STAGES], a_empty[STAGES], b_full[BSTAGES], b_empty[BSTAGES];
};

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

// The (item, K step) sequence of one block: item t is (row tile t % m_tiles,
// K split (t / m_tiles) % splits, column tile t / m_tiles / splits).
struct Walk {
  int t, ks, nk, m0, n0, k0, split;
  int items, stride, m_tiles, splits, k_per_split, K, BM;

  __device__ void place() {
    if (t >= items) return;
    const int r = t / m_tiles;
    m0 = (t % m_tiles) * BM;
    split = r % splits;
    n0 = (r / splits) * BN;
    k0 = split * k_per_split;
    nk = (min(K, k0 + k_per_split) - k0 + BK - 1) / BK;
    ks = 0;
  }
  __device__ Walk(int first, int stride_, int M, int N, int K_, int splits_,
                  int k_per_split_, int BM_)
      : t(first), stride(stride_), m_tiles((M + BM_ - 1) / BM_),
        splits(splits_), k_per_split(k_per_split_), K(K_), BM(BM_) {
    items = m_tiles * ((N + BN - 1) / BN) * splits;
    place();
  }
  __device__ bool done() const { return t >= items; }
  __device__ int k() const { return k0 + ks * BK; }
  __device__ void next() {
    if (++ks == nk) {
      t += stride;
      place();
    }
  }
};

template <int MT, typename TO>
__global__ void __launch_bounds__(NT, 1)
w8a8_tc_kernel(const __grid_constant__ CUtensorMap ta,
               const int8_t* __restrict__ w, const float* __restrict__ xs,
               const float* __restrict__ ws, TO* __restrict__ out,
               int* __restrict__ part, int M, int K, int N, int splits,
               int k_per_split) {
  using C = Cfg<MT>;
  constexpr int BM = C::BM;
  extern __shared__ __align__(1024) uint8_t tc_smem[];
  __shared__ Bars bars;
  const uint32_t sA = (smem_u32(tc_smem) + 1023) & ~1023u;
  const uint32_t sB = sA + STAGES * C::A_BYTES;
  const uint32_t a_full = smem_u32(&bars.a_full[0]);  // + 8 s
  const uint32_t a_empty = smem_u32(&bars.a_empty[0]);
  const uint32_t b_full = smem_u32(&bars.b_full[0]);
  const uint32_t b_empty = smem_u32(&bars.b_empty[0]);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(a_full + 8 * s, 1);
      mbar_init(a_empty + 8 * s, 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < BSTAGES; ++s) {
      mbar_init(b_full + 8 * s, 128);  // every transposer thread
      mbar_init(b_empty + 8 * s, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int lane = tid & 31;
  Walk walk(blockIdx.x, gridDim.x, M, N, K, splits, k_per_split, BM);

  if (wg == 3) {
    // Producer: one thread, one TMA box of xq per K step.
    setmaxnreg_dec<kProducerRegs>();
    if (tid != 3 * 128) return;
    for (int it = 0; !walk.done(); walk.next(), ++it) {
      const int s = it % STAGES;
      if (it >= STAGES) mbar_wait(a_empty + 8 * s, ((it / STAGES) & 1) ^ 1);
      mbar_expect_tx(a_full + 8 * s, C::A_BYTES);
      tma_load_2d(sA + s * C::A_BYTES, &ta, a_full + 8 * s, walk.k(),
                  walk.m0);
    }
    return;
  }

  if (wg == 2) {
    // Transposer. Lane l of warp q: k block c = l % 8 (rows 16 c .. 16 c +
    // 15 of the step), columns 32 q + 8 (l / 8) .. + 7 of the tile. Rows
    // past K and columns past N load zeros.
    setmaxnreg_dec<kTransposerRegs>();
    const int c = lane & 7;
    const int nl = ((tid >> 5) & 3) * 32 + (lane >> 3) * 8;
    uint2 cur[16], nxt[16];
    auto load = [&](const Walk& at, uint2 (&r)[16]) {
      const int n = at.n0 + nl;
      const int8_t* p = w + (long long)(at.k() + 16 * c) * N + n;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        r[i] = (n < N && at.k() + 16 * c + i < K)
                   ? __ldg(reinterpret_cast<const uint2*>(p + (long long)i * N))
                   : make_uint2(0u, 0u);
    };
    Walk ahead = walk;
    if (!ahead.done()) load(ahead, nxt);
    for (int it = 0; !walk.done(); walk.next(), ++it) {
#pragma unroll
      for (int i = 0; i < 16; ++i) cur[i] = nxt[i];
      ahead.next();
      if (!ahead.done()) load(ahead, nxt);
      const int b = it % BSTAGES;
      if (it >= BSTAGES) mbar_wait(b_empty + 8 * b, ((it / BSTAGES) & 1) ^ 1);
      const uint32_t dst = sB + b * B_BYTES + nl * 128;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t o[4][4];  // [k quad][n]
#pragma unroll
        for (int qk = 0; qk < 4; ++qk) {
          const uint32_t r[4] = {
              h ? cur[4 * qk].y : cur[4 * qk].x,
              h ? cur[4 * qk + 1].y : cur[4 * qk + 1].x,
              h ? cur[4 * qk + 2].y : cur[4 * qk + 2].x,
              h ? cur[4 * qk + 3].y : cur[4 * qk + 3].x};
          transpose4(r, o[qk]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = 4 * h + j;  // n % 8 as well: nl is a multiple of 8
          asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                           dst + row * 128 + ((c ^ row) << 4)),
                       "r"(o[0][j]), "r"(o[1][j]), "r"(o[2][j]), "r"(o[3][j])
                       : "memory");
        }
      }
      fence_proxy_async();
      mbar_arrive(b_full + 8 * b);
    }
    return;
  }

  // Consumers: warpgroup wg owns rows 64 MT wg .. 64 MT (wg + 1) - 1 of the
  // tile, MT accumulators of 64 x 128 int32.
  setmaxnreg_inc<kConsumerRegs>();
  const int warp = (tid >> 5) & 3;
  int acc[MT][64];
  int it = 0;
  while (!walk.done()) {
    const int m0 = walk.m0, n0 = walk.n0, split = walk.split, nk = walk.nk;
    for (int ks = 0; ks < nk; ++ks, ++it, walk.next()) {
      const int s = it % STAGES, b = it % BSTAGES;
      mbar_wait(a_full + 8 * s, (it / STAGES) & 1);
      mbar_wait(b_full + 8 * b, (it / BSTAGES) & 1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {
        const uint64_t db = smem_desc(sB + b * B_BYTES + kk * 32, 16, 1024);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          wgmma_s8_n128(acc[mt],
                        smem_desc(sA + s * C::A_BYTES +
                                      (wg * MT + mt) * (64 * 128) + kk * 32,
                                  16, 1024),
                        db, (ks | kk) != 0);
      }
      wgmma_commit();
      // the previous step's products are done: hand back its buffers (an
      // item's last step is handed back below, after its full wait)
      wgmma_wait<1>();
      if (ks > 0 && lane == 0) {
        mbar_arrive(a_empty + 8 * ((it - 1) % STAGES));
        mbar_arrive(b_empty + 8 * ((it - 1) % BSTAGES));
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
    if (lane == 0) {
      mbar_arrive(a_empty + 8 * ((it - 1) % STAGES));
      mbar_arrive(b_empty + 8 * ((it - 1) % BSTAGES));
    }
    // Epilogue: entry 4c + 2i + j of an accumulator is row 16 warp +
    // lane / 4 + 8 i, column 8 c + 2 (lane % 4) + j.
    const int cn = n0 + 2 * (lane & 3);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = m0 + (wg * MT + mt) * 64 + warp * 16 + (lane >> 2) + 8 * i;
        if (m >= M) continue;
        if (splits > 1) {
          int* prow = part + ((long long)split * M + m) * N;
#pragma unroll
          for (int c = 0; c < BN / 8; ++c)
            if (cn + 8 * c < N)  // N % 8 == 0: the pair is inside as well
              *reinterpret_cast<int2*>(prow + cn + 8 * c) = make_int2(
                  acc[mt][4 * c + 2 * i], acc[mt][4 * c + 2 * i + 1]);
          continue;
        }
        const float sx = xs[m];
        TO* orow = out + (long long)m * N;
#pragma unroll
        for (int c = 0; c < BN / 8; ++c) {
          const int n = cn + 8 * c;
          if (n >= N) continue;
          const float2 sw = *reinterpret_cast<const float2*>(ws + n);
          const float v0 = __fmul_rn(
              __fmul_rn(__int2float_rn(acc[mt][4 * c + 2 * i]), sx), sw.x);
          const float v1 = __fmul_rn(
              __fmul_rn(__int2float_rn(acc[mt][4 * c + 2 * i + 1]), sx), sw.y);
          if constexpr (std::is_same<TO, float>::value)
            *reinterpret_cast<float2*>(orow + n) = make_float2(v0, v1);
          else
            *reinterpret_cast<uint32_t*>(orow + n) = pack_bf16(v0, v1);
        }
      }
  }
}

// Sums the K splits' int32 partials (exact in any order) and applies the
// two scales; a thread takes four neighbouring columns (N % 8 == 0).
template <typename TO>
__global__ void w8a8_reduce_kernel(const int* __restrict__ part,
                                   const float* __restrict__ xs,
                                   const float* __restrict__ ws,
                                   TO* __restrict__ out, int M, int N,
                                   int splits) {
  const long long total = (long long)M * N;
  for (long long i = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
       i < total; i += 4LL * gridDim.x * blockDim.x) {
    int4 s = *reinterpret_cast<const int4*>(part + i);
    for (int sp = 1; sp < splits; ++sp) {
      const int4 p = *reinterpret_cast<const int4*>(part + sp * total + i);
      s.x += p.x; s.y += p.y; s.z += p.z; s.w += p.w;
    }
    const float sx = xs[i / N];
    const float4 sw = *reinterpret_cast<const float4*>(ws + i % N);
    const int a[4] = {s.x, s.y, s.z, s.w};
    const float c[4] = {sw.x, sw.y, sw.z, sw.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[i + e] =
          from_f<TO>(__fmul_rn(__fmul_rn(__int2float_rn(a[e]), sx), c[e]));
  }
}

template <int MT, typename TO>
cudaError_t launch(const void* xq, const void* w, const void* xs,
                   const void* ws, void* out, void* part, int M, int K, int N,
                   int splits, int k_per_split, cudaStream_t s) {
  using C = Cfg<MT>;
  CUtensorMap ta;
  if (!make_map_2d(&ta, xq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, M, K, C::BM))
    return cudaErrorInvalidValue;
  auto kernel = w8a8_tc_kernel<MT, TO>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const long long items = (long long)((M + C::BM - 1) / C::BM) *
                          ((N + BN - 1) / BN) * splits;
  if (items > 2147483647LL) return cudaErrorInvalidValue;
  kernel<<<(int)std::min<long long>(items, sms), NT, C::SMEM, s>>>(
      ta, static_cast<const int8_t*>(w), static_cast<const float*>(xs),
      static_cast<const float*>(ws), static_cast<TO*>(out),
      static_cast<int*>(part), M, K, N, splits, k_per_split);
  if ((err = cudaGetLastError()) != cudaSuccess || splits == 1) return err;
  const long long quads = (long long)M * N / 4;
  w8a8_reduce_kernel<TO>
      <<<(int)std::min<long long>((quads + 255) / 256, 4096), 256, 0, s>>>(
          static_cast<const int*>(part), static_cast<const float*>(xs),
          static_cast<const float*>(ws), static_cast<TO*>(out), M, N, splits);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t launch_t(int tile_rows, const void* xq, const void* w,
                     const void* xs, const void* ws, void* out, void* part,
                     int M, int K, int N, int splits, int k_per_split,
                     cudaStream_t s) {
  if (tile_rows == 256)
    return launch<2, TO>(xq, w, xs, ws, out, part, M, K, N, splits,
                         k_per_split, s);
  if (tile_rows == 128)
    return launch<1, TO>(xq, w, xs, ws, out, part, M, K, N, splits,
                         k_per_split, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace symtorch

// C entry point (ctypes). xq [M, K] int8 and w [K, N] int8, both contiguous
// and 16-byte aligned; xs [M] and ws [N] float32; out [M, N] in
// `out_dtype` (float32 or bfloat16). K must be a multiple of 16 and N of 8.
// tile_rows is 128 or 256. The K dimension is cut into `splits` runs of
// k_per_split values (a multiple of 128, splits * k_per_split >= K); with
// splits > 1, part is an int32 workspace of splits * M * N. Returns the
// cudaError_t of the launches.
extern "C" int w8a8_launch(int out_dtype, const void* xq, const void* w,
                           const void* xs, const void* ws, void* out,
                           void* part, int M, int K, int N, int splits,
                           int k_per_split, int tile_rows, void* stream) {
  using namespace symtorch;
  if (M <= 0 || K <= 0 || N <= 0 || K % 16 || N % 8 || splits < 1 ||
      k_per_split <= 0 || k_per_split % BK ||
      (long long)splits * k_per_split < K ||
      (long long)(splits - 1) * k_per_split >= K ||
      (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == kF32)
    return launch_t<float>(tile_rows, xq, w, xs, ws, out, part, M, K, N,
                           splits, k_per_split, s);
  if (out_dtype == kBF16)
    return launch_t<__nv_bfloat16>(tile_rows, xq, w, xs, ws, out, part, M, K,
                                   N, splits, k_per_split, s);
  return cudaErrorInvalidValue;
}
