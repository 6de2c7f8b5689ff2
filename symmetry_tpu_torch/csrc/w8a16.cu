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
//    operations bound (2 * M * K * N bf16 operations against the card's
//    dense bf16 peak). `tc::w8a16_tc_kernel`: a persistent grid, one block
//    per SM, over 256 x 128 output tiles (128 x 128 where the taller tile
//    would leave SMs idle or mostly masked), M fastest, so the blocks
//    running together share few weight panels and read each from device
//    memory once. Four warpgroups a block:
//     - a producer thread brings, per 64-deep K step, the tile's x rows by
//       TMA (128-byte swizzle, rows past M and columns past K zero-filled)
//       and the step's two weight panels, 4 KB contiguous each in the
//       panel layout, by bulk copies, into rings of four (six for the
//       short tile) stages with an mbarrier each;
//     - a converter warpgroup turns each int8 stage into a bf16 staging
//       tile (a ring of three) in the swizzled MN-major layout wgmma reads
//       as a transposed B, by a byte permute into the mantissa of 2^23 and
//       one subtraction (exact for all 256 values), off the products'
//       critical path;
//     - two consumer warpgroups run wgmma m64n128k16 bf16 x bf16 -> f32
//       (x K-major from its stage, the weight MN-major from the staging
//       tile), one step's group in flight while the next step's barriers
//       are awaited, then scale, cast and store their rows in whole
//       32-byte sectors, rows past M masked.
//    A K that is a multiple of 32 but not of 64 ends in a half step: x is
//    zero there, so whatever the stage holds adds nothing. No library
//    product anywhere.
#include <cuda.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace symtorch {
namespace {

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

// ---- Tensor-core regime -----------------------------------------------------
// One block per SM walks the (rows x 128 columns) output tiles, M fastest.
// Four warpgroups: two consumers, the converter, the producer.
namespace tc {

constexpr int NT = 512;
constexpr int BN = 2 * PW;        // output columns per tile: a panel pair
constexpr int BK = 64;            // K rows per step: one 128-byte row of x
constexpr int BSTAGES = 3;        // bf16 weight staging tiles
constexpr int W8_BYTES = BK * BN;       // int8 weight stage: [2][64][64]
constexpr int WB_BYTES = BK * BN * 2;   // bf16 staging tile: [2][64][128 B]
constexpr int kConsumerRegs = 200;
constexpr int kConverterRegs = 88;
constexpr int kProducerRegs = 24;

// MT: 64-row wgmma tiles per consumer warpgroup; a tile has 128 * MT rows.
template <int MT>
struct Cfg {
  static constexpr int BM = 128 * MT;
  static constexpr uint32_t X_BYTES = BM * BK * 2;
  // x and int8 weight stages in flight: a short tile has the room for
  // more, and with few tiles on the card it needs them to keep enough
  // bytes on their way from device memory.
  static constexpr int STAGES = MT == 1 ? 6 : 4;
  // 1 KB alignment slack, the x and int8 rings, the bf16 staging tiles.
  static constexpr size_t SMEM = 1024 + size_t(STAGES) * (X_BYTES + W8_BYTES) +
                                 size_t(BSTAGES) * WB_BYTES;
  static_assert(STAGES <= 6 && SMEM <= 232448, "ring does not fit");
};

constexpr int MAX_STAGES = 6;
struct Bars {
  uint64_t x_full[MAX_STAGES], x_empty[MAX_STAGES], w_full[MAX_STAGES],
      w_empty[MAX_STAGES], b_full[BSTAGES], b_empty[BSTAGES];
};

// Four int8 values (one 32-bit word, already XORed with 0x80808080) to two
// bf16 pairs, exactly: byte b becomes the float 2^23 + b by a byte permute
// into the mantissa of 0x4B000000, and 2^23 + 128 is subtracted.
__device__ __forceinline__ void cvt4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const float f0 = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7651)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7652)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7653)) - 8388736.f;
  lo = pack_bf16(f0, f1);
  hi = pack_bf16(f2, f3);
}

template <int MT, typename TO>
__global__ void __launch_bounds__(NT, 1)
w8a16_tc_kernel(const __grid_constant__ CUtensorMap tx,
                const int8_t* __restrict__ w, const float* __restrict__ scale,
                TO* __restrict__ out, int M, int K, int N, int apply_scale) {
  using C = Cfg<MT>;
  constexpr int BM = C::BM;
  constexpr int STAGES = C::STAGES;
  extern __shared__ __align__(1024) uint8_t tc_smem[];
  __shared__ Bars bars;
  const uint32_t sX = (smem_u32(tc_smem) + 1023) & ~1023u;
  const uint32_t sW8 = sX + STAGES * C::X_BYTES;
  const uint32_t sWB = sW8 + STAGES * W8_BYTES;
  const uint32_t x_full = smem_u32(&bars.x_full[0]);  // + 8 s
  const uint32_t x_empty = smem_u32(&bars.x_empty[0]);
  const uint32_t w_full = smem_u32(&bars.w_full[0]);
  const uint32_t w_empty = smem_u32(&bars.w_empty[0]);
  const uint32_t b_full = smem_u32(&bars.b_full[0]);
  const uint32_t b_empty = smem_u32(&bars.b_empty[0]);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(x_full + 8 * s, 1);
      mbar_init(x_empty + 8 * s, 8);  // one arrival per consumer warp
      mbar_init(w_full + 8 * s, 1);
      mbar_init(w_empty + 8 * s, 4);  // one per converter warp
    }
    for (int s = 0; s < BSTAGES; ++s) {
      mbar_init(b_full + 8 * s, 128);  // every converter thread
      mbar_init(b_empty + 8 * s, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int m_tiles = (M + BM - 1) / BM;
  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = m_tiles * n_tiles;
  const int nk = (K + BK - 1) / BK;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int lane = tid & 31;

  if (wg == 3) {
    // Producer: one thread. Per K step, one TMA box of x (BM rows x 64
    // columns, zero-filled past M and K) and one bulk copy per weight
    // panel (64 K rows x 64 bytes, contiguous in the panel layout).
    setmaxnreg_dec<kProducerRegs>();
    if (tid != 3 * 128) return;
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t % m_tiles) * BM;
      const int p0 = (t / m_tiles) * 2;
      const int np = min(2, N / PW - p0);  // panels this tile has
      for (int ks = 0; ks < nk; ++ks, ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) {
          const uint32_t ph = ((it / STAGES) & 1) ^ 1;
          mbar_wait(x_empty + 8 * s, ph);
          mbar_wait(w_empty + 8 * s, ph);
        }
        mbar_expect_tx(x_full + 8 * s, C::X_BYTES);
        tma_load_2d(sX + s * C::X_BYTES, &tx, x_full + 8 * s, ks * BK, m0);
        const uint32_t wbytes = min(BK, K - ks * BK) * PW;
        mbar_expect_tx(w_full + 8 * s, wbytes * np);
        for (int p = 0; p < np; ++p)
          bulk_load(sW8 + s * W8_BYTES + p * (BK * PW),
                    w + ((long long)(p0 + p) * K + ks * BK) * PW, wbytes,
                    w_full + 8 * s);
      }
    }
    return;
  }

  if (wg == 2) {
    // Converter: int8 stage -> bf16 staging tile in the MN-major layout
    // wgmma reads under the 128-byte swizzle (row k of a panel is 128
    // bytes, its 16-byte chunk c at c ^ (k % 8)). A thread converts four
    // 16-byte pieces a step; neighbouring lanes read neighbouring pieces,
    // and a quarter warp's eight stores land on eight distinct chunks.
    // Rows past K and panels past N convert whatever the stage holds: any
    // byte gives a finite bf16, x is zero there, the columns are masked.
    setmaxnreg_dec<kConverterRegs>();
    const int ct = tid - 2 * 128;
    const int steps = ((tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                       (int)gridDim.x) * nk;
    for (int it = 0; it < steps; ++it) {
      const int s = it % STAGES, b = it % BSTAGES;
      mbar_wait(w_full + 8 * s, (it / STAGES) & 1);
      if (it >= BSTAGES) mbar_wait(b_empty + 8 * b, ((it / BSTAGES) & 1) ^ 1);
      const uint32_t src = sW8 + s * W8_BYTES, dst = sWB + b * WB_BYTES;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = ct + 128 * i;      // 16-byte piece of the stage
        const int row = j >> 2, q = j & 3;  // row = panel * 64 + k
        uint32_t v[4];
        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                     : "r"(src + j * 16));
        uint32_t o[8];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cvt4(v[e] ^ 0x80808080u, o[2 * e], o[2 * e + 1]);
        const uint32_t base = dst + row * 128;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                           base + (((2 * q + h) ^ (row & 7)) << 4)),
                       "r"(o[4 * h]), "r"(o[4 * h + 1]), "r"(o[4 * h + 2]),
                       "r"(o[4 * h + 3])
                       : "memory");
      }
      fence_proxy_async();
      mbar_arrive(b_full + 8 * b);
      __syncwarp();
      if (lane == 0) mbar_arrive(w_empty + 8 * s);
    }
    return;
  }

  // Consumers: warpgroup wg owns rows 64 MT wg .. 64 MT (wg + 1) - 1 of the
  // tile, MT accumulators of 64 x 128. One K step is 4 MT products a
  // warpgroup (x K-major from its stage, the weight MN-major from the
  // staging tile); one step's group stays in flight while the next step's
  // barriers are awaited.
  setmaxnreg_inc<kConsumerRegs>();
  const int warp = (tid >> 5) & 3;
  float acc[MT][64];
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t % m_tiles) * BM;
    const int n0 = (t / m_tiles) * BN;
    for (int ks = 0; ks < nk; ++ks, ++it) {
      const int s = it % STAGES, b = it % BSTAGES;
      mbar_wait(x_full + 8 * s, (it / STAGES) & 1);
      mbar_wait(b_full + 8 * b, (it / BSTAGES) & 1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db =
            smem_desc(sWB + b * WB_BYTES + kk * 2048, BK * 128, 1024);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          wgmma_ss_n128_bt(acc[mt],
                           smem_desc(sX + s * C::X_BYTES +
                                         (wg * MT + mt) * (64 * 128) + kk * 32,
                                     16, 1024),
                           db, (ks | kk) != 0);
      }
      wgmma_commit();
      // the previous step's products are done: hand back its buffers (a
      // tile's last step is handed back below, after its full wait)
      wgmma_wait<1>();
      if (ks > 0 && lane == 0) {
        mbar_arrive(x_empty + 8 * ((it - 1) % STAGES));
        mbar_arrive(b_empty + 8 * ((it - 1) % BSTAGES));
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
    if (lane == 0) {
      mbar_arrive(x_empty + 8 * ((it - 1) % STAGES));
      mbar_arrive(b_empty + 8 * ((it - 1) % BSTAGES));
    }
    // Epilogue: entry 4c + 2i + j of an accumulator is row 16 warp +
    // lane / 4 + 8 i, column 8 c + 2 (lane % 4) + j; scaled, cast, stored.
    // float32: a pair a thread, 32 contiguous bytes a quad. bf16: a pair is
    // 4 bytes, so lanes q and q ^ 1 of a quad trade pairs of two
    // neighbouring chunks -- the even lane ends with four columns of chunk
    // c, the odd lane with four of chunk c + 1 -- and a quad again stores
    // 32 contiguous bytes a row, a whole sector.
    const int q = lane & 3;
#pragma unroll
    for (int c = 0; c < BN / 8; c += 2) {
      if (n0 + 8 * c >= N) continue;  // N % 64 == 0: whole chunk pairs
      float2 s0 = make_float2(1.f, 1.f), s1 = s0;
      if (apply_scale) {
        s0 = *reinterpret_cast<const float2*>(scale + n0 + 8 * c + 2 * q);
        s1 = *reinterpret_cast<const float2*>(scale + n0 + 8 * c + 8 + 2 * q);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int m = m0 + (wg * MT + mt) * 64 + warp * 16 + (lane >> 2) + 8 * i;
          const float a0 = acc[mt][4 * c + 2 * i] * s0.x;
          const float a1 = acc[mt][4 * c + 2 * i + 1] * s0.y;
          const float b0 = acc[mt][4 * c + 4 + 2 * i] * s1.x;
          const float b1 = acc[mt][4 * c + 4 + 2 * i + 1] * s1.y;
          TO* o = out + (long long)m * N + n0 + 8 * c;
          if constexpr (std::is_same<TO, float>::value) {
            if (m >= M) continue;
            *reinterpret_cast<float2*>(o + 2 * q) = make_float2(a0, a1);
            *reinterpret_cast<float2*>(o + 8 + 2 * q) = make_float2(b0, b1);
          } else {
            const uint32_t pa = pack_bf16(a0, a1), pb = pack_bf16(b0, b1);
            const uint32_t got =
                __shfl_xor_sync(0xffffffffu, (q & 1) ? pa : pb, 1);
            if (m >= M) continue;
            *reinterpret_cast<uint2*>(o + ((q & 1) ? 8 + 2 * (q - 1) : 2 * q)) =
                (q & 1) ? make_uint2(got, pb) : make_uint2(pa, got);
          }
        }
    }
  }
}

template <int MT, typename TO>
cudaError_t launch(const void* x, const void* w, const void* scale, void* out,
                   int M, int K, int N, int apply_scale, cudaStream_t s) {
  using C = Cfg<MT>;
  CUtensorMap tx;
  if (!make_map_2d(&tx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, C::BM))
    return cudaErrorInvalidValue;
  auto kernel = w8a16_tc_kernel<MT, TO>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const long long tiles =
      (long long)((M + C::BM - 1) / C::BM) * ((N + BN - 1) / BN);
  if (tiles > 2147483647LL) return cudaErrorInvalidValue;
  kernel<<<(int)std::min<long long>(tiles, sms), NT, C::SMEM, s>>>(
      tx, static_cast<const int8_t*>(w), static_cast<const float*>(scale),
      static_cast<TO*>(out), M, K, N, apply_scale);
  return cudaGetLastError();
}

}  // namespace tc

template <typename TX, typename TO>
cudaError_t launch(const void* x, const void* w, const void* scale,
                   void* out, void* part, int M, int K, int N, int splits,
                   int k_per_split, int apply_scale, int tile_rows,
                   cudaStream_t s) {
  const int panels = N / PW;
  if (tile_rows != 0) {
    if constexpr (std::is_same<TX, __nv_bfloat16>::value) {
      if (tile_rows == 256)
        return tc::launch<2, TO>(x, w, scale, out, M, K, N, apply_scale, s);
      if (tile_rows == 128)
        return tc::launch<1, TO>(x, w, scale, out, M, K, N, apply_scale, s);
    }
    return cudaErrorInvalidValue;
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
                     int tile_rows, cudaStream_t s) {
  if (out_dtype == kF32)
    return launch<TX, float>(x, w, scale, out, part, M, K, N, splits,
                             k_per_split, apply_scale, tile_rows, s);
  if (out_dtype == kBF16)
    return launch<TX, __nv_bfloat16>(x, w, scale, out, part, M, K, N, splits,
                                     k_per_split, apply_scale, tile_rows, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace symtorch

// C entry point (ctypes). x [M, K] in `x_dtype`, contiguous, 16-byte
// aligned; w the packed int8 panels [N / 64, K, 64]; scale [N] float32;
// out [M, N] in `out_dtype`. tile_rows picks the kernel: 0 the GEMV kernel
// (part a float32 workspace of splits * M * N, unused when splits == 1),
// 128 or 256 the tensor-core kernel with that many rows a tile (bf16 x
// only; splits, k_per_split and part unused). K must be a multiple of 32
// and N of 64. Returns the cudaError_t of the launches.
extern "C" int w8a16_launch(int x_dtype, int out_dtype, const void* x,
                            const void* w, const void* scale, void* out,
                            void* part, int M, int K, int N, int splits,
                            int k_per_split, int apply_scale, int tile_rows,
                            void* stream) {
  using namespace symtorch;
  if (M <= 0 || K <= 0 || N <= 0 || K % 32 || N % PW || splits < 1 ||
      k_per_split <= 0 || (long long)splits * k_per_split < K ||
      (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32)
    return launch_o<float>(out_dtype, x, w, scale, out, part, M, K, N, splits,
                           k_per_split, apply_scale, tile_rows, s);
  if (x_dtype == kBF16)
    return launch_o<__nv_bfloat16>(out_dtype, x, w, scale, out, part, M, K, N,
                                   splits, k_per_split, apply_scale,
                                   tile_rows, s);
  return cudaErrorInvalidValue;
}
