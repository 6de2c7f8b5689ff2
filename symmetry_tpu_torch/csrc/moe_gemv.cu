// Grouped int8 expert GEMV for Hopper (sm_90a): for every expert e of a
// stack, y[e] = cast((x[e] @ f32(q[e])) * scale[e]), x [X, M, K] (or one
// [1, M, K] shared by every expert: expert stride 0) in bf16 or float32 with
// M <= 64 rows an expert, q the flat int8 stack [X, K, N] exactly as
// ops/quant.py pack_tree leaves it (row-major [K, N] slabs, no repacking),
// scale [X, N] float32; out [X, M, N], expert-major. With the scale off the
// raw float32 sums are returned (the `model` axis's reduce-then-scale).
//
// Replaces no pallas_call. The JAX package's mixture multiplies the int8
// stacks by the mixed dot (symmetry_tpu/models/moe.py qmatmul_experts and
// _expert_matmul), which XLA fuses with its int8 -> float32 convert, so no
// float32 copy of a slab is ever made there. Run eagerly, the same dot
// copies each [K, N] slab to float32 and hands 8 rows to a float32 GEMM:
// about 9 bytes of traffic per weight byte. This kernel reads each weight
// byte once.
//
// What bounds it: bytes. A decode step at 8 rows does 2 M = 16 operations a
// weight byte, far under the ~295 the card does a byte read; the 45 GB of
// Mixtral's expert stacks take 13.5 ms at 3.35 TB/s. So the design spends
// as little as it can besides the weight's bytes, in device memory and in
// shared memory alike:
//  - items are (expert, column tile, row tile, K split), dealt over a
//    persistent grid of thread-block clusters sized from the card's
//    occupancy (ops/moe_gemv.py moe_gemv_plan); the K splits of an item run
//    on the blocks of one cluster, block rank r always split r;
//  - a producer thread brings each 64-deep step into a ring with an
//    mbarrier a stage: the weight by a TMA 3-D box (the tile's columns x 64
//    K rows of one expert's slab, row pitch N bytes) and the step's x tile
//    by a TMA 3-D box (expert coordinate 0 for a shared x). Past M, K and N
//    both boxes are zero;
//  - bf16 x, in row tiles of NP = 8, 16 or 32 (wgmma's narrow side; one
//    read of the weight serves every row of a tile): 128-column tiles,
//    whose weight box has 128-byte rows under the 128-byte swizzle. Four
//    warpgroups take every fourth step of the ring (each stage always the
//    same one). Each thread loads its 32-bit words of the stage (four
//    columns, one K row each; the swizzle puts a warp's 32 loads on 32
//    banks), converts them to bf16 in registers (a byte permute into
//    2^23's mantissa and one subtraction: exact) straight into the A
//    fragments of two swap-AB wgmma m64nNPk16 products, one a 64-
//    column half: the weight's columns the 64-row side (a thread's four
//    columns are rows 16 w + l / 4 and + 8 of each half), x's rows the
//    narrow side, K-major from the x tile. No bf16 copy of the weight is
//    written to shared memory;
//  - float32 x, in row tiles of 8 or 16: 64-column tiles, the products on
//    CUDA-core FMAs in float32 (no TF32), as the W8A16 float32 GEMV
//    (csrc/w8a16.cu) computes them;
//  - at an item's end every consumer parks its float32 partial in shared
//    memory; an epilogue warp adds them in a fixed order, the cluster's
//    other ranks hand theirs to rank 0 through distributed shared memory,
//    and rank 0 adds them in rank order, then scales (after the whole K
//    sum, as the mixed dot does), casts and stores. No atomics and no
//    partials in device memory: the result does not change from run to
//    run.
// The arithmetic is the mixed dot's: an int8 value is exact in bf16 and in
// float32, a bf16 x int8 product is exact in float32; only the summation
// order differs from the plain version.
#include <cuda.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace symtorch {
namespace {
namespace mg {

constexpr int NWG = 4;                  // consuming warpgroups
constexpr int PRODUCER_WARP = NWG * 4;  // then the producer warp
constexpr int EPILOGUE_WARP = NWG * 4 + 1;  // and the epilogue warp
constexpr int NT = NWG * 128 + 64;
constexpr int STEP = 64;                // K rows a step
constexpr int MAX_RING = 16;
constexpr size_t SMEM_CAP = 232448;

struct Bars {
  uint64_t full[MAX_RING], empty[MAX_RING], red_full, red_empty, in_full,
      in_free;
};

// The shape of a launch by x type and row tile: columns a tile (W), bytes
// of an x tile and of a weight stage, ring stages, the largest cluster
// that fits, partials an item, and the dynamic shared memory (1 KB
// alignment slack, the ring, the parked partials and rank 0's inbox of the
// other ranks' sums).
template <bool F32, int NP>
struct Shape {
  static constexpr int W = F32 ? 64 : 128;
  static constexpr int XT = F32 ? NP * STEP * 4 : NP * 128;
  static constexpr int W8 = STEP * W;
  static constexpr int RING = F32 || NP == 8 ? 16 : NP == 16 ? 12 : 8;
  static constexpr int MAX_CLUSTER = NP == 32 ? 2 : 8;
  static constexpr int NRED = F32 ? NWG * 4 : NWG;
  static constexpr size_t smem(int cluster) {
    return 1024 + size_t(RING) * (XT + W8) +
           size_t(NRED + cluster - 1) * NP * W * 4;
  }
  static_assert(RING <= MAX_RING, "ring too deep");
  // Ring step `it` goes to warpgroup it % NWG, so each stage always goes to
  // the same warpgroup, which never waits on a stage's next phase before
  // it has released the last one: a parity wait cannot see a phase two
  // ahead as complete.
  static_assert(RING % NWG == 0, "a stage must keep its warpgroup");
  static_assert(smem(MAX_CLUSTER) + sizeof(Bars) <= SMEM_CAP,
                "ring does not fit");
};

// D[64 x N] += A[64 x 16] * B[16 x N], A from registers (four bf16 pairs a
// thread in the accumulator's fragment layout, wgmma.cuh), B K-major from
// shared memory (no transpose).
__device__ __forceinline__ void wgmma_rs_n8_k(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n16_k(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, "
      "1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n32_k(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int NP>
__device__ __forceinline__ void mma(float (&d)[NP / 2],
                                    const uint32_t (&a)[4], uint64_t b) {
  if constexpr (NP == 8) wgmma_rs_n8_k(d, a, b);
  else if constexpr (NP == 16) wgmma_rs_n16_k(d, a, b);
  else wgmma_rs_n32_k(d, a, b);
}

// A block's share of the deal: its rank (= K split) and cluster, its K
// rows, and the items its cluster takes. Item t = cid + i G is row tile
// t % row_tiles of column tile (t / row_tiles) % tiles of expert
// t / (row_tiles tiles): neighbouring clusters read neighbouring columns
// of the same slab rows.
struct Deal {
  int rank, csize, G, cid, k_lo, k_hi, nsteps, row_tiles, tiles, items;
  __device__ Deal(int X, int M, int K, int N, int k_per_split, int np,
                  int w) {
    rank = (int)cluster_ctarank();
    asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(csize));
    G = gridDim.x / csize;
    cid = blockIdx.x / csize;
    k_lo = rank * k_per_split;
    k_hi = min(K, k_lo + k_per_split);
    nsteps = (k_hi - k_lo + STEP - 1) / STEP;
    row_tiles = (M + np - 1) / np;
    tiles = (N + w - 1) / w;
    const int total = X * tiles * row_tiles;
    items = total > cid ? (total - cid + G - 1) / G : 0;
  }
  __device__ int item(int i) const { return cid + i * G; }
  __device__ int row0(int i, int np) const {
    return item(i) % row_tiles * np;
  }
  __device__ int tile(int i) const { return item(i) / row_tiles % tiles; }
  __device__ int expert(int i) const {
    return item(i) / (row_tiles * tiles);
  }
};

// The producer thread: each step of this block's items through the ring,
// the x tile and the weight box on one barrier. A TMA box always delivers
// its whole size, zeros included.
template <class S, int NP>
__device__ __forceinline__ void produce(const Deal& d, const CUtensorMap* tx,
                                        const CUtensorMap* tw, int x_shared,
                                        uint32_t sX, uint32_t sW8,
                                        uint32_t full, uint32_t empty) {
  constexpr int R = S::RING;
  int it = 0;
  for (int i = 0; i < d.items; ++i) {
    const int e = d.expert(i), n0 = d.tile(i) * S::W, row0 = d.row0(i, NP);
    for (int j = 0; j < d.nsteps; ++j, ++it) {
      const int s = it % R;
      if (it >= R)
        mbar_wait_bounded<false>(empty + 8 * s, ((it / R) & 1) ^ 1);
      const int k0 = d.k_lo + j * STEP;
      mbar_expect_tx(full + 8 * s, S::XT + S::W8);
      tma_load_3d(sX + s * S::XT, tx, full + 8 * s, k0, row0,
                  x_shared ? 0 : e);
      tma_load_3d(sW8 + s * S::W8, tw, full + 8 * s, n0, k0, e);
    }
  }
}

// The epilogue warp. Per item: the NRED parked partials added in order;
// then the cluster's, in rank order, on rank 0, which scales, casts and
// stores out[e, m, n]. Lane l owns entries l, l + 32, ... of the [NP][W]
// sums, taken CH at a time.
template <class S, int NP, typename TO>
__device__ __forceinline__ void epilogue(
    const Deal& d, const float* red, const float* in, uint32_t sIn,
    uint32_t red_full, uint32_t red_empty, uint32_t in_full, uint32_t in_free,
    int lane, const float* scale, TO* out, int M, int N, int apply_scale) {
  constexpr int W = S::W;
  constexpr int SUMS = NP * W;  // floats of a [NP x W] sum
  constexpr int PER = SUMS / 32;
  constexpr int CH = 16;
  for (int i = 0; i < d.items; ++i) {
    mbar_wait_bounded<false>(red_full, i & 1);
    const bool remote = d.csize > 1 && d.rank > 0;
    // A remote rank writes rank 0's inbox once rank 0 has read the last
    // item's; rank 0 reads it once every rank has written.
    if (remote && i > 0) mbar_wait_bounded<true>(in_free, (i - 1) & 1);
    if (!remote && d.csize > 1) mbar_wait_bounded<true>(in_full, i & 1);
    const int e = d.expert(i), n0 = d.tile(i) * W, row0 = d.row0(i, NP);
    for (int c0 = 0; c0 < PER; c0 += CH) {
      float v[CH];
#pragma unroll
      for (int x = 0; x < CH; ++x) {
        const int idx = lane + 32 * (c0 + x);
        v[x] = red[idx];
#pragma unroll
        for (int g = 1; g < S::NRED; ++g) v[x] += red[g * SUMS + idx];
      }
      if (remote) {
        const uint32_t slot = map_rank(sIn, 0) + (d.rank - 1) * SUMS * 4;
#pragma unroll
        for (int x = 0; x < CH; ++x)
          st_cluster(slot + (lane + 32 * (c0 + x)) * 4, v[x]);
        continue;
      }
      for (int r = 1; r < d.csize; ++r)
#pragma unroll
        for (int x = 0; x < CH; ++x)
          v[x] += in[(r - 1) * SUMS + lane + 32 * (c0 + x)];
#pragma unroll
      for (int x = 0; x < CH; ++x) {
        const int idx = lane + 32 * (c0 + x);
        const int m = row0 + idx / W, n = n0 + idx % W;
        if (m < M && n < N)
          out[((long long)e * M + m) * N + n] = from_f<TO>(
              apply_scale ? v[x] * scale[(long long)e * N + n] : v[x]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(red_empty);
    if (remote) {
      mbar_arrive_cluster(map_rank(in_full, 0));
    } else if (d.csize > 1 && i + 1 < d.items) {
      for (int r = 1; r < d.csize; ++r)
        mbar_arrive_cluster(map_rank(in_free, r));
    }
  }
}

// Barriers of a launch: the ring's (R stages), the parked sums' and the
// inbox's; then every block's barriers exist before any block reaches into
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

// The shared-memory layout of a launch, the same in every rank, so rank
// 0's inbox sits at the same offset in each block's view: the ring's x
// tiles, its weight stages, the parked partials, the inbox.
template <class S, int NP>
struct Layout {
  uint32_t base, sX, sW8, sRed, sIn;
  __device__ explicit Layout(const uint8_t* smem) {
    base = smem_u32(smem);
    sX = (base + 1023) & ~1023u;
    sW8 = sX + S::RING * S::XT;
    sRed = sW8 + S::RING * S::W8;
    sIn = sRed + S::NRED * NP * S::W * 4;
  }
};

// bf16 x: swap-AB products on the tensor cores, 128-column tiles, A
// fragments converted in registers from the int8 stage.
template <int NP, typename TO>
__global__ void __launch_bounds__(NT, 1)
moe_gemv_tc_kernel(const __grid_constant__ CUtensorMap tx,
                   const __grid_constant__ CUtensorMap tw,
                   const float* __restrict__ scale, TO* __restrict__ out,
                   int X, int M, int K, int N, int k_per_split, int x_shared,
                   int apply_scale) {
  using S = Shape<false, NP>;
  constexpr int R = S::RING;
  constexpr int W = S::W;
  constexpr int SUMS = NP * W;
  extern __shared__ __align__(1024) uint8_t mg_smem[];
  __shared__ Bars bars;
  const Deal d(X, M, K, N, k_per_split, NP, W);
  const Layout<S, NP> L(mg_smem);
  float* red = reinterpret_cast<float*>(mg_smem + (L.sRed - L.base));
  const float* in = reinterpret_cast<const float*>(mg_smem + (L.sIn - L.base));
  const uint32_t full = smem_u32(&bars.full[0]);  // + 8 s
  const uint32_t empty = smem_u32(&bars.empty[0]);
  const uint32_t red_full = smem_u32(&bars.red_full);
  const uint32_t red_empty = smem_u32(&bars.red_empty);
  init_bars(bars, R, d.csize);

  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp_id = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int lane = tid & 31;
  if (warp_id == PRODUCER_WARP) {
    if (lane == 0)
      produce<S, NP>(d, &tx, &tw, x_shared, L.sX, L.sW8, full, empty);
    __syncwarp();
  } else if (warp_id == EPILOGUE_WARP) {
    epilogue<S, NP, TO>(d, red, in, L.sIn, red_full, red_empty,
                        smem_u32(&bars.in_full), smem_u32(&bars.in_free),
                        lane, scale, out, M, N, apply_scale);
    __syncwarp();
  } else if (wg < NWG) {
    const int warp = (tid >> 5) & 3;
    const int g = lane >> 2, q = lane & 3;
    // This thread's word of a 128-byte stage row: columns 4 c4 .. 4 c4 +
    // 3, which are rows 16 warp + g (+ 8) of the two halves' A operands.
    const int c4 = 8 * warp + g;
    float* my_red = red + wg * SUMS;
    float acc[2][NP / 2];
    int it = 0;  // ring steps walked
    for (int i = 0; i < d.items; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < NP / 2; ++e) acc[h][e] = 0.f;
      for (int j = 0; j < d.nsteps; ++j, ++it) {
        if (it % NWG != wg) continue;
        const int s = it % R;
        mbar_wait_bounded<false>(full + 8 * s, (it / R) & 1);
        // The lanes leave the wait apart; the wgmma instructions below
        // need the whole warp together.
        __syncwarp();
        // K row k of the stage holds chunk c of its 128 bytes at c ^ (k %
        // 8) (the TMA swizzle). Fragment register 2 hh + r of k slice kk
        // holds K rows 16 kk + 8 hh + 2 q and + 1 of A row 16 warp + g +
        // 8 r: for half t that is column 4 c4 + 2 t + r.
        const uint32_t* st = reinterpret_cast<const uint32_t*>(
            mg_smem + (L.sW8 - L.base) + s * S::W8);
        uint32_t a[2][4][4];  // [half][k slice][register]
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float f[2][4];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int k = 16 * kk + 8 * hh + 2 * q + u;
              const uint32_t wv =
                  st[k * 32 + (((c4 >> 2) ^ (k & 7)) << 2) + (c4 & 3)] ^
                  0x80808080u;
#pragma unroll
              for (int b = 0; b < 4; ++b) f[u][b] = magic_f(wv, 0x7650u + b);
            }
#pragma unroll
            for (int t = 0; t < 2; ++t)
#pragma unroll
              for (int r = 0; r < 2; ++r)
                a[t][kk][2 * hh + r] = pack_bf16(f[0][2 * t + r],
                                                 f[1][2 * t + r]);
          }
        fence_regs(acc[0]);
        fence_regs(acc[1]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t db = smem_desc(L.sX + s * S::XT + kk * 32, 16, 1024);
          mma<NP>(acc[0], a[0][kk], db);
          mma<NP>(acc[1], a[1][kk], db);
        }
        wgmma_commit();
        // The products have read the x tile: the stage goes back to the
        // producer.
        wgmma_wait<0>();
        fence_regs(acc[0]);
        fence_regs(acc[1]);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * s);
      }
      // Park the sums once the epilogue has read the previous item's.
      // Entry 4c + 2r + u of half t's accumulator is D[16 warp + g + 8r]
      // [8c + 2q + u]: column 4 c4 + 2t + r, x row 8c + 2q + u.
      if (i > 0) mbar_wait_bounded<false>(red_empty, (i - 1) & 1);
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < NP / 2; ++e) {
          const int n = 4 * c4 + 2 * t + ((e >> 1) & 1);
          const int m = 8 * (e >> 2) + 2 * q + (e & 1);
          my_red[m * W + n] = acc[t][e];
        }
      mbar_arrive(red_full);
    }
  }
  // No block leaves while another may still reach into its shared memory.
  __syncwarp();
  cluster_sync();
}

// float32 x: products on CUDA-core FMAs, row tiles of NP = 8 or 16, 64-
// column tiles. Warp w of a warpgroup takes K rows 16 w .. 16 w + 15 of
// the step, lane l output columns 2 l and 2 l + 1 (the W8A16 float32
// GEMV's inner loop).
template <int NP, typename TO>
__global__ void __launch_bounds__(NT, 1)
moe_gemv_f32_kernel(const __grid_constant__ CUtensorMap tx,
                    const __grid_constant__ CUtensorMap tw,
                    const float* __restrict__ scale, TO* __restrict__ out,
                    int X, int M, int K, int N, int k_per_split, int x_shared,
                    int apply_scale) {
  using S = Shape<true, NP>;
  constexpr int R = S::RING;
  constexpr int W = S::W;
  constexpr int SUMS = NP * W;
  extern __shared__ __align__(1024) uint8_t mg_smem[];
  __shared__ Bars bars;
  const Deal d(X, M, K, N, k_per_split, NP, W);
  const Layout<S, NP> L(mg_smem);
  float* red = reinterpret_cast<float*>(mg_smem + (L.sRed - L.base));
  const float* in = reinterpret_cast<const float*>(mg_smem + (L.sIn - L.base));
  const uint32_t full = smem_u32(&bars.full[0]);  // + 8 s
  const uint32_t empty = smem_u32(&bars.empty[0]);
  const uint32_t red_full = smem_u32(&bars.red_full);
  const uint32_t red_empty = smem_u32(&bars.red_empty);
  init_bars(bars, R, d.csize);

  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp_id = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int lane = tid & 31;
  if (warp_id == PRODUCER_WARP) {
    if (lane == 0)
      produce<S, NP>(d, &tx, &tw, x_shared, L.sX, L.sW8, full, empty);
    __syncwarp();
  } else if (warp_id == EPILOGUE_WARP) {
    epilogue<S, NP, TO>(d, red, in, L.sIn, red_full, red_empty,
                        smem_u32(&bars.in_full), smem_u32(&bars.in_free),
                        lane, scale, out, M, N, apply_scale);
    __syncwarp();
  } else if (wg < NWG) {
    const int warp = (tid >> 5) & 3;
    // Lane l's columns 2l, 2l + 1: bytes 2 (l % 2), + 1 of word l / 2.
    const uint32_t sel = 0x7650u + 2 * (lane & 1);
    float* my_red = red + (wg * 4 + warp) * SUMS;
    float acc[NP][2];
    int it = 0;  // ring steps walked
    for (int i = 0; i < d.items; ++i) {
#pragma unroll
      for (int m = 0; m < NP; ++m) acc[m][0] = acc[m][1] = 0.f;
      for (int j = 0; j < d.nsteps; ++j, ++it) {
        if (it % NWG != wg) continue;
        const int s = it % R;
        mbar_wait_bounded<false>(full + 8 * s, (it / R) & 1);
        const uint32_t* ws =
            reinterpret_cast<const uint32_t*>(mg_smem + (L.sW8 - L.base) +
                                              s * S::W8) +
            16 * warp * (W / 4) + (lane >> 1);
        const float* xs = reinterpret_cast<const float*>(
                              mg_smem + (L.sX - L.base) + s * S::XT) +
                          16 * warp;
#pragma unroll
        for (int h = 0; h < 4; ++h) {  // a quad of rows: k = 4 h + r
          float wf[4][2];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const uint32_t u = ws[(4 * h + r) * (W / 4)] ^ 0x80808080u;
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
      if (i > 0) mbar_wait_bounded<false>(red_empty, (i - 1) & 1);
#pragma unroll
      for (int m = 0; m < NP; ++m)
        *reinterpret_cast<float2*>(my_red + m * W + 2 * lane) =
            make_float2(acc[m][0], acc[m][1]);
      mbar_arrive(red_full);
    }
  }
  __syncwarp();
  cluster_sync();
}

// The kernel of an x type, row tile and output type, and its shared
// memory.
template <typename TX, int NP, typename TO>
struct Kernel {
  static constexpr bool kF32 = std::is_same<TX, float>::value;
  using S = Shape<kF32, NP>;
  static auto fn() {
    if constexpr (kF32) return moe_gemv_f32_kernel<NP, TO>;
    else return moe_gemv_tc_kernel<NP, TO>;
  }
  static cudaError_t allow(int cluster) {
    return cudaFuncSetAttribute(fn(),
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)S::smem(cluster));
  }
};

template <typename TX, int NP>
cudaError_t capacity(int cluster, int* fit) {
  using Kn = Kernel<TX, NP, float>;
  if (cluster > Kn::S::MAX_CLUSTER) {
    *fit = 0;
    return cudaSuccess;
  }
  cudaError_t err = Kn::allow(cluster);
  if (err != cudaSuccess) return err;
  ClusterLaunch c(cluster, 1, NT, Kn::S::smem(cluster), nullptr);
  return cudaOccupancyMaxActiveClusters(fit, Kn::fn(), &c.cfg);
}

// x by TMA: bf16 rows under the 128-byte swizzle the wgmma B descriptor
// reads, float32 rows plain (256 bytes a step). The weight as int8 boxes
// of a tile's columns x 64 K rows: 128-byte rows under the 128-byte
// swizzle for bf16 x, 64-byte rows plain for float32 x.
template <typename TX, int NP, typename TO>
cudaError_t launch(const void* x, const void* w, const void* scale, void* out,
                   int X, int x_shared, int M, int K, int N, int cluster,
                   int k_per_split, int clusters, int apply_scale,
                   cudaStream_t s) {
  using Kn = Kernel<TX, NP, TO>;
  if (cluster > Kn::S::MAX_CLUSTER) return cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  const long long xX = x_shared ? 1 : X;
  const bool mapped =
      (Kn::kF32 ? make_map_3d(&tx, x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, K,
                              M, xX, STEP, NP, CU_TENSOR_MAP_SWIZZLE_NONE)
                : make_map_3d(&tx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, K,
                              M, xX, STEP, NP, CU_TENSOR_MAP_SWIZZLE_128B)) &&
      make_map_3d(&tw, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N, K, X,
                  Kn::S::W, STEP,
                  Kn::kF32 ? CU_TENSOR_MAP_SWIZZLE_NONE
                           : CU_TENSOR_MAP_SWIZZLE_128B);
  if (!mapped) return cudaErrorInvalidValue;
  cudaError_t err = Kn::allow(cluster);
  if (err != cudaSuccess) return err;
  ClusterLaunch c(cluster, clusters, NT, Kn::S::smem(cluster), s);
  return cudaLaunchKernelEx(&c.cfg, Kn::fn(), tx, tw,
                            static_cast<const float*>(scale),
                            static_cast<TO*>(out), X, M, K, N, k_per_split,
                            x_shared, apply_scale);
}

// Calls f with a value of the x type and an integral constant of the row
// tile, for the tiles each x type is built for.
template <typename F>
cudaError_t by_tile(int x_dtype, int np, F f) {
  if (x_dtype == kBF16) {
    switch (np) {
      case 8: return f(__nv_bfloat16{}, std::integral_constant<int, 8>{});
      case 16: return f(__nv_bfloat16{}, std::integral_constant<int, 16>{});
      case 32: return f(__nv_bfloat16{}, std::integral_constant<int, 32>{});
    }
  } else if (x_dtype == kF32) {
    switch (np) {
      case 8: return f(float{}, std::integral_constant<int, 8>{});
      case 16: return f(float{}, std::integral_constant<int, 16>{});
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace mg
}  // namespace
}  // namespace symtorch

// C entry point (ctypes). x [X or 1, M, K] in `x_dtype` (x_shared: one
// [1, M, K] for every expert), contiguous, 16-byte aligned; w the flat int8
// stack [X, K, N]; scale [X, N] float32; out [X, M, N] in `out_dtype`;
// 1 <= M <= 64, K a multiple of 8 and N of 16 (TMA's 16-byte pitches of x
// and the stack; the boxes' zeros fill ragged steps and tiles). `np` is
// the row tile (bf16: 8, 16 or 32; float32: 8 or 16); `cols` the column
// tile (bf16 128, float32 64); `splits` K splits (the cluster size) of `k_per_split` rows, a
// multiple of 64 when split; `clusters` clusters, at most the items
// (experts x column tiles x row tiles). Returns the cudaError_t of the
// launch.
extern "C" int moe_gemv_launch(int x_dtype, int out_dtype, const void* x,
                               const void* w, const void* scale, void* out,
                               int X, int x_shared, int M, int K, int N,
                               int np, int cols, int splits, int k_per_split,
                               int clusters, int apply_scale, void* stream) {
  using namespace symtorch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (X < 1 || M < 1 || M > 64 || K <= 0 || N <= 0 || K % 8 || N % 16 ||
      cols != (x_dtype == kF32 ? 64 : 128) || splits < 1 || splits > 8 ||
      k_per_split <= 0 || (long long)splits * k_per_split < K ||
      (long long)(splits - 1) * k_per_split >= K ||
      (splits > 1 && k_per_split % mg::STEP) || clusters < 1 ||
      clusters > (long long)X * ((N + cols - 1) / cols) *
                     ((M + np - 1) / np))
    return cudaErrorInvalidValue;
  if (out_dtype != kF32 && out_dtype != kBF16) return cudaErrorInvalidValue;
  return mg::by_tile(x_dtype, np, [&](auto tx, auto tile) {
    using TX = decltype(tx);
    constexpr int NP = decltype(tile)::value;
    if (out_dtype == kF32)
      return mg::launch<TX, NP, float>(x, w, scale, out, X, x_shared, M, K,
                                       N, splits, k_per_split, clusters,
                                       apply_scale, s);
    return mg::launch<TX, NP, __nv_bfloat16>(x, w, scale, out, X, x_shared,
                                             M, K, N, splits, k_per_split,
                                             clusters, apply_scale, s);
  });
}

// The clusters of `cluster` (1-8) blocks of the kernel for `x_dtype` rows
// in tiles of `np` that the current device holds at once, into *fit (0
// where such a cluster's shared memory does not fit). Returns the
// cudaError_t of the query.
extern "C" int moe_gemv_capacity(int x_dtype, int np, int cluster,
                                 int* fit) {
  using namespace symtorch;
  if (cluster < 1 || cluster > 8 || fit == nullptr)
    return cudaErrorInvalidValue;
  return mg::by_tile(x_dtype, np, [&](auto tx, auto tile) {
    return mg::capacity<decltype(tx), decltype(tile)::value>(cluster, fit);
  });
}
