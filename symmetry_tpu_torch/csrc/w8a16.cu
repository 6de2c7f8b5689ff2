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
// Three regimes (ops/qmm.py w8a16_regime):
//  - "gemv", M <= 16 bf16 rows (decode: one row per slot): bytes bound --
//    each int8 weight byte must be read once and is used 2 * M times.
//    `gv::w8a16_gemv_tc_kernel` (below): swap-AB products on the tensor
//    cores, the weight bulk-copied through a ring, K splits summed inside
//    a thread-block cluster.
//  - "gemv_f32", every f32 activation (f32 serving, any row count):
//    `gv::w8a16_gemv_f32_kernel` (below), the tensor-core GEMV's machinery
//    -- the bulk-copied ring, the deal of `gemv_plan`, K splits summed in
//    a cluster -- with the products on the CUDA cores in float32 (exact
//    enough that float32 serving on the card reproduces the CPU's greedy
//    tokens; no TF32), up to 16 rows a tile, more rows in 16-row tiles.
//  - "tc", M > 16 bf16 rows (prefill: up to the 2048-row token budget):
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

// One int8 value of a 32-bit word already XORed with 0x80808080, as a
// float, exactly: selector 0x7650 + i puts byte i, b + 128 for the value
// b, into the mantissa of 0x4B000000 (the float 2^23 + b + 128), and 2^23
// + 128 is subtracted. A permute and a subtraction, off the quarter-rate
// int-to-float path.
__device__ __forceinline__ float magic_f(uint32_t w, uint32_t sel) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, sel)) - 8388736.f;
}

// The word's four values.
__device__ __forceinline__ void cvt4f(uint32_t w, float (&f)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = magic_f(w, 0x7650u + i);
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
// bf16 pairs, exactly (cvt4f, then the bf16 rounding, exact for them).
__device__ __forceinline__ void cvt4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  float f[4];
  cvt4f(w, f);
  lo = pack_bf16(f[0], f[1]);
  hi = pack_bf16(f[2], f[3]);
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

// ---- GEMV regimes: bf16 x on the tensor cores, float32 x on FMAs ----------
// Both GEMV kernels share one deal and one pipeline. Work items are
// (row tile, panel, K split) (ops/qmm.py gemv_plan): the splits of an item
// run on the blocks of one thread-block cluster, block rank r always split
// r; cluster c of G takes items c, c + G, ... of the panels x row tiles,
// row tile fastest (bf16 rows are one tile). Per block:
//  - a producer warp whose one thread brings each 64-deep step into a ring
//    of stages with an mbarrier each: the panel's 4,096 contiguous weight
//    bytes by a bulk copy, and beside them the step's x tile (NP rows x 64
//    columns, rows past M and columns past K zero-filled) by TMA, from L2
//    after the first panel. With a stage in each warpgroup's hands, 64 KB
//    of weight stay in flight, past the ~25 KB an SM needs to cover
//    device-memory latency at the card's rate. Nothing is sized by K, so
//    any K takes the kernels;
//  - four warpgroups take every fourth step (below, per kernel);
//  - at an item's end the consumers park their [NP x 64] float32 sums in
//    shared memory and go on with the next item, and an epilogue warp adds
//    them in a fixed order; the cluster's other blocks store their sums
//    into rank 0's shared memory (distributed shared memory, an mbarrier
//    arrival a lane), and rank 0's epilogue warp adds them in rank order,
//    scales, casts and stores. No second kernel, no partials in device
//    memory, no float atomics: the result does not change from run to run.
//
// bf16 x, M <= 16 (`w8a16_gemv_tc_kernel`). Swap-AB: a panel's 64 output
// columns are the 64-row A operand of wgmma m64nNk16 (the converted
// weight, MN-major through the transpose immediate), x's rows, zero-padded
// to N = NP (8 or 16), the narrow B (K-major, as x lies in memory, TMA
// under the 128-byte swizzle), so one read of the weight serves every row.
// A warpgroup converts its int8 stage to a bf16 staging tile (the
// tensor-core kernel's converter: prmt into 2^23's mantissa, one subtract,
// cvt.rn.bf16x2, 128-byte swizzled rows, fence.proxy.async), issues four
// wgmma k16 products into its own accumulator, waits for them and hands the
// stage back; four in turn keep the conversion ahead of the copies. Ring:
// 20 stages (a deeper one measured no faster).
//
// float32 x, any M (`w8a16_gemv_f32_kernel`), in tiles of NP = 8 or 16
// rows. The products stay on the CUDA cores in float32 (no TF32), so the
// result is as exact as the plain version's up to summation order. At 16
// rows the FMAs outweigh the weight's bytes (`wg`: 0.94 G FMAs), so the
// design spends as few other instructions and shared-memory wavefronts as
// it can on each:
//  - the x tile is float32 [NP][64] (no swizzle), twice the bf16 tile's
//    bytes, so the ring has 16 stages;
//  - warp w of a warpgroup takes rows 16 w .. 16 w + 15 of the step, lane
//    l output columns 2 l and 2 l + 1. Per quad of rows a lane loads the
//    weight word holding its two bytes (two lanes a word, one wavefront
//    a row), converts its two values (magic_f: a permute and a
//    subtraction each, off the quarter-rate int-to-float path, which alone
//    would cost ~16 us on `wg`), and for each x row one 16-byte load of
//    four k values, the same address in every lane (a broadcast), feeds 8
//    FMAs;
//  - every lane sums its rows in a fixed order, and each warp parks one
//    [NP x 64] partial at an item's end, which the epilogue warp adds in
//    warpgroup-then-warp order, so a stream is the same run to run.
namespace gv {

constexpr int NWG = 4;                  // converter-consumer warpgroups
constexpr int PRODUCER_WARP = NWG * 4;  // then the producer warp
constexpr int EPILOGUE_WARP = NWG * 4 + 1;  // and the epilogue warp
constexpr int NT = NWG * 128 + 64;
constexpr int STEP = 64;                // K rows a step
constexpr int W8_BYTES = STEP * PW;     // an int8 stage: 4,096 bytes
constexpr int WB_BYTES = STEP * 128;    // the step as bf16 rows: 8,192
constexpr int RING = 20;                // stages, bf16 x
constexpr int RING_F32 = 16;            // stages, float32 x
constexpr int NRED = NWG;               // partials an item, bf16 x
constexpr int NRED_F32 = NWG * 4;       // float32 x: one a consuming warp

struct Bars {
  uint64_t full[RING], empty[RING], red_full, red_empty, in_full, in_free;
};

// Dynamic shared memory of a launch: 1 KB alignment slack, the ring's x
// tiles (NP rows x 128 bytes) and int8 weight stages, each warpgroup's
// bf16 staging tile and parked sums, rank 0's inbox of the other ranks'
// sums.
constexpr size_t smem_bytes(int np, int cluster) {
  return 1024 + size_t(RING) * (np * 128 + W8_BYTES) +
         size_t(NWG) * WB_BYTES + size_t(NRED + cluster - 1) * np * PW * 4;
}
static_assert(smem_bytes(16, 8) + sizeof(Bars) <= 232448, "ring does not fit");

// float32 x: the ring's x tiles (NP rows x 256 bytes) and weight stages,
// each consuming warp's parked sums, rank 0's inbox.
constexpr size_t smem_bytes_f32(int np, int cluster) {
  return 1024 + size_t(RING_F32) * (np * STEP * 4 + W8_BYTES) +
         size_t(NRED_F32 + cluster - 1) * np * PW * 4;
}
static_assert(smem_bytes_f32(16, 8) + sizeof(Bars) <= 232448,
              "ring does not fit");

// A block's share of the deal: its rank (= K split) and cluster, its K
// rows, and the items its cluster takes.
struct Deal {
  int rank, csize, G, cid, k_lo, k_hi, nsteps, row_tiles, items;
  __device__ Deal(int M, int K, int N, int k_per_split, int np) {
    rank = (int)cluster_ctarank();
    asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(csize));
    G = gridDim.x / csize;                 // clusters
    cid = blockIdx.x / csize;              // this block's cluster
    k_lo = rank * k_per_split;
    k_hi = min(K, k_lo + k_per_split);
    nsteps = (k_hi - k_lo + STEP - 1) / STEP;
    row_tiles = (M + np - 1) / np;
    const int total = (N / PW) * row_tiles;
    items = total > cid ? (total - cid + G - 1) / G : 0;
  }
  __device__ int panel(int i) const { return (cid + i * G) / row_tiles; }
  __device__ int row0(int i, int np) const {
    return (cid + i * G) % row_tiles * np;
  }
};

// The producer thread: each step of this block's items through the ring,
// its x tile (XT bytes) and the panel's weight rows on one barrier.
template <int R, int NP, int XT>
__device__ __forceinline__ void produce(const Deal& d, const CUtensorMap* tx,
                                        const int8_t* w, int K, uint32_t sX,
                                        uint32_t sW8, uint32_t full,
                                        uint32_t empty) {
  int it = 0;
  for (int i = 0; i < d.items; ++i) {
    const int p = d.panel(i), row0 = d.row0(i, NP);
    for (int j = 0; j < d.nsteps; ++j, ++it) {
      const int s = it % R;
      if (it >= R) mbar_wait(empty + 8 * s, ((it / R) & 1) ^ 1);
      const int k0 = d.k_lo + j * STEP;
      const uint32_t bytes = min(STEP, d.k_hi - k0) * PW;
      mbar_expect_tx(full + 8 * s, XT + bytes);
      tma_load_2d(sX + s * XT, tx, full + 8 * s, k0, row0);
      bulk_load(sW8 + s * W8_BYTES, w + ((long long)p * K + k0) * PW, bytes,
                full + 8 * s);
    }
  }
}

// The epilogue warp. Per item: the NR parked partials added in order;
// then the cluster's, in rank order, on rank 0, which scales, casts and
// stores. Lane l owns entries l, l + 32, ... of the [NP][64] sums.
template <int NP, int NR, typename TO>
__device__ __forceinline__ void epilogue(
    const Deal& d, const float* red, const float* in, uint32_t sIn,
    uint32_t red_full, uint32_t red_empty, uint32_t in_full, uint32_t in_free,
    int lane, const float* scale, TO* out, int M, int N, int apply_scale) {
  constexpr int SUMS = NP * PW;  // floats of a [NP x 64] sum
  constexpr int PER = SUMS / 32;
  for (int i = 0; i < d.items; ++i) {
    mbar_wait(red_full, i & 1);
    float v[PER];
#pragma unroll
    for (int x = 0; x < PER; ++x) {
      const int e = lane + 32 * x;
      v[x] = red[e];
#pragma unroll
      for (int g = 1; g < NR; ++g) v[x] += red[g * SUMS + e];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(red_empty);
    if (d.csize > 1 && d.rank > 0) {
      // Hand the sums to rank 0 once it has read the previous ones.
      if (i > 0) mbar_wait_cluster(in_free, (i - 1) & 1);
      const uint32_t slot = map_rank(sIn, 0) + (d.rank - 1) * SUMS * 4;
#pragma unroll
      for (int x = 0; x < PER; ++x)
        st_cluster(slot + (lane + 32 * x) * 4, v[x]);
      mbar_arrive_cluster(map_rank(in_full, 0));
      continue;
    }
    if (d.csize > 1) {
      mbar_wait_cluster(in_full, i & 1);
      for (int r = 1; r < d.csize; ++r)
#pragma unroll
        for (int x = 0; x < PER; ++x)
          v[x] += in[(r - 1) * SUMS + lane + 32 * x];
      if (i + 1 < d.items)
        for (int r = 1; r < d.csize; ++r)
          mbar_arrive_cluster(map_rank(in_free, r));
    }
    const int p = d.panel(i), row0 = d.row0(i, NP);
#pragma unroll
    for (int x = 0; x < PER; ++x) {
      const int e = lane + 32 * x;
      const int m = row0 + e / PW, n = p * PW + e % PW;
      if (m < M)
        out[(long long)m * N + n] =
            from_f<TO>(apply_scale ? v[x] * scale[n] : v[x]);
    }
  }
}

// Barriers of a launch: the ring's (R stages), the parked sums' and the
// inbox's. Then every block's barriers exist before any block reaches into
// another.
__device__ __forceinline__ void init_bars(Bars& bars, int R, int csize) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < R; ++s) {
      mbar_init(smem_u32(&bars.full[s]), 1);
      mbar_init(smem_u32(&bars.empty[s]), 4);  // one per consuming warp
    }
    mbar_init(smem_u32(&bars.red_full), NWG * 128);  // every consumer
    mbar_init(smem_u32(&bars.red_empty), 1);         // the epilogue warp
    mbar_init(smem_u32(&bars.in_full),
              csize > 1 ? (csize - 1) * 32 : 1);     // remote lanes
    mbar_init(smem_u32(&bars.in_free), 32);  // rank 0's epilogue lanes
    mbar_init_fence();
  }
  cluster_sync();
}

template <int NP>
__device__ __forceinline__ void mma(float (&d)[NP / 2], uint64_t a,
                                    uint64_t b) {
  if constexpr (NP == 8) wgmma_ss_n8_at(d, a, b, 1);
  else wgmma_ss_n16_at(d, a, b, 1);
}

template <int NP, typename TO>
__global__ void __launch_bounds__(NT, 1)
w8a16_gemv_tc_kernel(const __grid_constant__ CUtensorMap tx,
                     const int8_t* __restrict__ w,
                     const float* __restrict__ scale, TO* __restrict__ out,
                     int M, int K, int N, int k_per_split, int apply_scale) {
  extern __shared__ __align__(1024) uint8_t gv_smem[];
  __shared__ Bars bars;
  constexpr int XT = NP * 128;          // an x tile: one step
  constexpr int SUMS = NP * PW;         // floats of a [NP x 64] sum
  const Deal d(M, K, N, k_per_split, NP);

  // One layout for every rank, so rank 0's inbox sits at the same offset
  // in each block's view.
  const uint32_t base = smem_u32(gv_smem);
  const uint32_t sX = (base + 1023) & ~1023u;
  const uint32_t sW8 = sX + RING * XT;
  const uint32_t sWB = sW8 + RING * W8_BYTES;
  const uint32_t sRed = sWB + NWG * WB_BYTES;
  const uint32_t sIn = sRed + NRED * SUMS * 4;
  float* red = reinterpret_cast<float*>(gv_smem + (sRed - base));
  const float* in = reinterpret_cast<const float*>(gv_smem + (sIn - base));
  const uint32_t full = smem_u32(&bars.full[0]);  // + 8 s
  const uint32_t empty = smem_u32(&bars.empty[0]);
  const uint32_t red_full = smem_u32(&bars.red_full);
  const uint32_t red_empty = smem_u32(&bars.red_empty);
  init_bars(bars, RING, d.csize);

  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp_id = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int lane = tid & 31;
  if (warp_id == PRODUCER_WARP) {
    if (lane == 0)
      produce<RING, NP, XT>(d, &tx, w, K, sX, sW8, full, empty);
    __syncwarp();
  } else if (warp_id == EPILOGUE_WARP) {
    epilogue<NP, NRED, TO>(d, red, in, sIn, red_full, red_empty,
                           smem_u32(&bars.in_full), smem_u32(&bars.in_free),
                           lane, scale, out, M, N, apply_scale);
    __syncwarp();
  } else if (wg < NWG) {
    const int ct = tid - wg * 128;
    const int warp = ct >> 5;
    const uint32_t stage = sWB + wg * WB_BYTES;
    float* my_red = red + wg * SUMS;
    float acc[NP / 2];
    int it = 0;  // ring steps walked
    for (int i = 0; i < d.items; ++i) {
#pragma unroll
      for (int e = 0; e < NP / 2; ++e) acc[e] = 0.f;
      for (int j = 0; j < d.nsteps; ++j, ++it) {
        if (j % NWG != wg) continue;
        const int s = it % RING;
        mbar_wait(full + 8 * s, (it / RING) & 1);
        const uint32_t src = sW8 + s * W8_BYTES;
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int jj = ct + 128 * h2;        // 16-byte piece of the stage
          const int row = jj >> 2, q = jj & 3;  // row = k, q: 16 columns
          uint32_t v[4];
          asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                       : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                       : "r"(src + jj * 16));
          uint32_t o[8];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            tc::cvt4(v[e] ^ 0x80808080u, o[2 * e], o[2 * e + 1]);
          const uint32_t rb = stage + row * 128;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                             rb + (((2 * q + h) ^ (row & 7)) << 4)),
                         "r"(o[4 * h]), "r"(o[4 * h + 1]), "r"(o[4 * h + 2]),
                         "r"(o[4 * h + 3])
                         : "memory");
        }
        fence_proxy_async();
        named_sync(1 + wg, 128);  // the whole tile is stored
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < STEP / 16; ++kk)
          mma<NP>(acc, smem_desc(stage + kk * 2048, WB_BYTES, 1024),
                  smem_desc(sX + s * XT + kk * 32, 16, 1024));
        wgmma_commit();
        // The products have read the x tile and the staging tile: the
        // stage goes back to the producer, the staging tile to the next
        // conversion.
        wgmma_wait<0>();
        fence_regs(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * s);
      }
      // Park the sums once the epilogue has read the previous item's.
      // Entry 4c + 2i + e of the accumulator is D[16 warp + lane / 4 + 8i]
      // [8c + 2 (lane % 4) + e]: output column n, x row m.
      if (i > 0) mbar_wait(red_empty, (i - 1) & 1);
#pragma unroll
      for (int e = 0; e < NP / 2; ++e) {
        const int n = 16 * warp + (lane >> 2) + 8 * ((e >> 1) & 1);
        const int m = 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
        my_red[m * PW + n] = acc[e];
      }
      mbar_arrive(red_full);
    }
  }
  // No block leaves while another may still reach into its shared memory.
  cluster_sync();
}

template <int NP, typename TO>
__global__ void __launch_bounds__(NT, 1)
w8a16_gemv_f32_kernel(const __grid_constant__ CUtensorMap tx,
                      const int8_t* __restrict__ w,
                      const float* __restrict__ scale, TO* __restrict__ out,
                      int M, int K, int N, int k_per_split, int apply_scale) {
  extern __shared__ __align__(1024) uint8_t gv_smem[];
  __shared__ Bars bars;
  constexpr int XT = NP * STEP * 4;     // an x tile: NP float32 rows
  constexpr int SUMS = NP * PW;         // floats of a [NP x 64] sum
  const Deal d(M, K, N, k_per_split, NP);

  const uint32_t base = smem_u32(gv_smem);
  const uint32_t sX = (base + 1023) & ~1023u;
  const uint32_t sW8 = sX + RING_F32 * XT;
  const uint32_t sRed = sW8 + RING_F32 * W8_BYTES;
  const uint32_t sIn = sRed + NRED_F32 * SUMS * 4;
  float* red = reinterpret_cast<float*>(gv_smem + (sRed - base));
  const float* in = reinterpret_cast<const float*>(gv_smem + (sIn - base));
  const uint32_t full = smem_u32(&bars.full[0]);  // + 8 s
  const uint32_t empty = smem_u32(&bars.empty[0]);
  const uint32_t red_full = smem_u32(&bars.red_full);
  const uint32_t red_empty = smem_u32(&bars.red_empty);
  init_bars(bars, RING_F32, d.csize);

  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp_id = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int lane = tid & 31;
  if (warp_id == PRODUCER_WARP) {
    if (lane == 0)
      produce<RING_F32, NP, XT>(d, &tx, w, K, sX, sW8, full, empty);
    __syncwarp();
  } else if (warp_id == EPILOGUE_WARP) {
    epilogue<NP, NRED_F32, TO>(d, red, in, sIn, red_full, red_empty,
                               smem_u32(&bars.in_full),
                               smem_u32(&bars.in_free), lane, scale, out, M,
                               N, apply_scale);
    __syncwarp();
  } else if (wg < NWG) {
    const int warp = (tid >> 5) & 3;  // step rows 16 warp .. 16 warp + 15
    // Lane l's columns 2l, 2l + 1: bytes 2 (l % 2), + 1 of word l / 2.
    const uint32_t sel = 0x7650u + 2 * (lane & 1);
    float* my_red = red + (wg * 4 + warp) * SUMS;
    float acc[NP][2];
    int it = 0;  // ring steps walked
    for (int i = 0; i < d.items; ++i) {
#pragma unroll
      for (int m = 0; m < NP; ++m) acc[m][0] = acc[m][1] = 0.f;
      for (int j = 0; j < d.nsteps; ++j, ++it) {
        if (j % NWG != wg) continue;
        const int s = it % RING_F32;
        mbar_wait(full + 8 * s, (it / RING_F32) & 1);
        // Rows past K (a half last step) hold stale weight bytes, always
        // a finite value, against x's zero fill: they add exactly zero.
        const uint32_t* ws =
            reinterpret_cast<const uint32_t*>(gv_smem + (sW8 - base) +
                                              s * W8_BYTES) +
            16 * warp * (PW / 4) + (lane >> 1);
        const float* xs =
            reinterpret_cast<const float*>(gv_smem + (sX - base) + s * XT) +
            16 * warp;
#pragma unroll
        for (int h = 0; h < 4; ++h) {  // a quad of rows: k = 4 h + r
          float wf[4][2];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const uint32_t u = ws[(4 * h + r) * (PW / 4)] ^ 0x80808080u;
            wf[r][0] = magic_f(u, sel);
            wf[r][1] = magic_f(u, sel + 1);
          }
#pragma unroll
          for (int m = 0; m < NP; ++m) {
            const float4 xv =
                *reinterpret_cast<const float4*>(xs + m * STEP + 4 * h);
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              float a = acc[m][c];
              a = fmaf(xv.x, wf[0][c], a);
              a = fmaf(xv.y, wf[1][c], a);
              a = fmaf(xv.z, wf[2][c], a);
              a = fmaf(xv.w, wf[3][c], a);
              acc[m][c] = a;
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * s);
      }
      // Park the warp's sums once the epilogue has read the previous
      // item's.
      if (i > 0) mbar_wait(red_empty, (i - 1) & 1);
#pragma unroll
      for (int m = 0; m < NP; ++m)
        *reinterpret_cast<float2*>(my_red + m * PW + 2 * lane) =
            make_float2(acc[m][0], acc[m][1]);
      mbar_arrive(red_full);
    }
  }
  // No block leaves while another may still reach into its shared memory.
  cluster_sync();
}

// A launch of `clusters` clusters of `cluster` blocks (not copyable: the
// configuration points at its own attribute).
struct Config {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = {};
  Config(int cluster, int clusters, size_t smem, cudaStream_t s) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(clusters * cluster);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  Config(const Config&) = delete;
};

// The kernel of an x type and row tile, and its shared memory.
template <typename TX, int NP, typename TO>
struct Kernel {
  static constexpr bool kF32 = std::is_same<TX, float>::value;
  static auto fn() {
    if constexpr (kF32) return w8a16_gemv_f32_kernel<NP, TO>;
    else return w8a16_gemv_tc_kernel<NP, TO>;
  }
  static size_t smem(int cluster) {
    return kF32 ? smem_bytes_f32(NP, cluster) : smem_bytes(NP, cluster);
  }
  static cudaError_t allow(int cluster) {
    return cudaFuncSetAttribute(fn(),
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem(cluster));
  }
};

// Clusters of `cluster` blocks the card holds at once (ops/qmm.py
// gemv_capacity reads it to deal the work). Both row tiles of a kernel
// hold one block an SM, so the 16-row one answers for both.
template <typename TX>
cudaError_t capacity(int cluster, int* fit) {
  using Kn = Kernel<TX, 16, float>;
  cudaError_t err = Kn::allow(cluster);
  if (err != cudaSuccess) return err;
  Config c(cluster, 1, Kn::smem(cluster), nullptr);
  return cudaOccupancyMaxActiveClusters(fit, Kn::fn(), &c.cfg);
}

// Exactly the deal of ops/qmm.py gemv_plan: `clusters` clusters, each
// resident at once, so every block streams about the same bytes. x by TMA:
// bf16 rows under the 128-byte swizzle the wgmma B descriptor reads,
// float32 rows plain (256 bytes a step).
template <typename TX, int NP, typename TO>
cudaError_t launch(const void* x, const void* w, const void* scale, void* out,
                   int M, int K, int N, int cluster, int k_per_split,
                   int clusters, int apply_scale, cudaStream_t s) {
  using Kn = Kernel<TX, NP, TO>;
  CUtensorMap tx;
  const bool mapped =
      Kn::kF32 ? make_map_2d(&tx, x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, M, K,
                             NP, STEP * 4, CU_TENSOR_MAP_SWIZZLE_NONE)
               : make_map_2d(&tx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M,
                             K, NP);
  if (!mapped) return cudaErrorInvalidValue;
  cudaError_t err = Kn::allow(cluster);
  if (err != cudaSuccess) return err;
  Config c(cluster, clusters, Kn::smem(cluster), s);
  return cudaLaunchKernelEx(&c.cfg, Kn::fn(), tx,
                            static_cast<const int8_t*>(w),
                            static_cast<const float*>(scale),
                            static_cast<TO*>(out), M, K, N, k_per_split,
                            apply_scale);
}

}  // namespace gv

// Regime codes (ops/qmm.py _REGIME_CODE).
enum Regime { kGemv = 0, kGemvF32 = 1, kTc = 2 };

// Calls f with a value of the output type.
template <typename F>
cudaError_t by_out(int out_dtype, F f) {
  if (out_dtype == kF32) return f(float{});
  if (out_dtype == kBF16) return f(__nv_bfloat16{});
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace symtorch

// C entry point (ctypes). x [M, K] in `x_dtype`, contiguous, 16-byte
// aligned; w the packed int8 panels [N / 64, K, 64]; scale [N] float32;
// out [M, N] in `out_dtype`; K a multiple of 32, N of 64. `regime` names
// the kernel, and each takes only its own arguments (the others must be
// as stated):
//  - kGemv, the tensor-core GEMV: bf16 x, M <= 16; kGemvF32, the float32
//    GEMV: float32 x, any M. Both: `splits` K splits (the cluster size, at
//    most 8) of `k_per_split` rows, a multiple of 64 when split;
//    `clusters` clusters, at most the items (panels x 8- or 16-row tiles);
//    tile_rows 0;
//  - kTc, the tensor-core kernel: bf16 x; `tile_rows` 128 or 256; splits
//    1, k_per_split K, clusters 0.
// Returns the cudaError_t of the launch.
extern "C" int w8a16_launch(int regime, int x_dtype, int out_dtype,
                            const void* x, const void* w, const void* scale,
                            void* out, int M, int K, int N, int splits,
                            int k_per_split, int clusters, int apply_scale,
                            int tile_rows, void* stream) {
  using namespace symtorch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // every K row in exactly one non-empty split
  if (M <= 0 || K <= 0 || N <= 0 || K % 32 || N % PW || splits < 1 ||
      k_per_split <= 0 || (long long)splits * k_per_split < K ||
      (long long)(splits - 1) * k_per_split >= K)
    return cudaErrorInvalidValue;
  const int np = M <= 8 ? 8 : 16;  // a GEMV's row tile
  switch (regime) {
    case kGemv:
    case kGemvF32:
      if (x_dtype != (regime == kGemv ? kBF16 : kF32) ||
          (regime == kGemv && M > 16) || splits > 8 || clusters < 1 ||
          clusters > (long long)(N / PW) * ((M + np - 1) / np) ||
          (splits > 1 && k_per_split % gv::STEP) || tile_rows != 0)
        return cudaErrorInvalidValue;
      return by_out(out_dtype, [&](auto o) {
        using TO = decltype(o);
        auto go = [&](auto tx) {
          using TX = decltype(tx);
          return np == 8 ? gv::launch<TX, 8, TO>(x, w, scale, out, M, K, N,
                                                  splits, k_per_split,
                                                  clusters, apply_scale, s)
                         : gv::launch<TX, 16, TO>(x, w, scale, out, M, K, N,
                                                   splits, k_per_split,
                                                   clusters, apply_scale, s);
        };
        return regime == kGemv ? go(__nv_bfloat16{}) : go(float{});
      });
    case kTc:
      if (x_dtype != kBF16 || splits != 1 || clusters != 0 ||
          (tile_rows != 128 && tile_rows != 256))
        return cudaErrorInvalidValue;
      return by_out(out_dtype, [&](auto o) {
        using TO = decltype(o);
        if (tile_rows == 256)
          return tc::launch<2, TO>(x, w, scale, out, M, K, N, apply_scale, s);
        return tc::launch<1, TO>(x, w, scale, out, M, K, N, apply_scale, s);
      });
    default:
      return cudaErrorInvalidValue;
  }
}

// The clusters of `cluster` (1-8) blocks of the GEMV kernel for `x_dtype`
// (bf16: tensor cores; float32: FMAs) the current device holds at once,
// into *fit. Returns the cudaError_t of the query.
extern "C" int w8a16_gemv_capacity(int x_dtype, int cluster, int* fit) {
  using namespace symtorch;
  if (cluster < 1 || cluster > 8 || fit == nullptr)
    return cudaErrorInvalidValue;
  if (x_dtype == kF32) return gv::capacity<float>(cluster, fit);
  if (x_dtype == kBF16) return gv::capacity<__nv_bfloat16>(cluster, fit);
  return cudaErrorInvalidValue;
}
