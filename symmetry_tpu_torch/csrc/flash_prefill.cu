// Flash prefill attention for Hopper (sm_90a): causal GQA self-attention
// over a fresh padded prompt, ragged per-row lengths, optional sliding
// window, online softmax in float32.
//
// Replaces the Pallas TPU kernel symmetry_tpu/ops/flash.py `_flash_kernel`
// (called from `flash_prefill`, pl.pallas_call at flash.py:129).
//
// What bounds it on this card: operations, not bytes -- llama3-8b at
// S = 2048 does ~34 GFLOP per layer on ~25 MB of q/k/v, so only the tensor
// cores (989 TFLOP/s bf16) come near the bound. Two variants, chosen in
// ops/flash.py `flash_variant` from (dtype, head_dim):
//
// Tensor-core variant (`flash_tc_kernel`; bf16, head_dim 40 .. 256 run at
// the next of 64, 128, 256 -- TMA zero-fills the columns past the real
// head dim, and only those columns of O are stored):
//  - persistent: one block per SM walks (128-row query tile, query head,
//    batch row) tiles dealt longest-first in a snake, so the blocks finish
//    together, and a tile's Q and first K/V load under the previous tile's
//    softmax and epilogue; three warpgroups: two consumers of 64 query
//    rows each (240 registers a thread by setmaxnreg) and a producer
//    (24 registers) whose one thread issues every load;
//  - loads are TMA copies of 64-column boxes through 4-D tensor maps over
//    the [B, S, heads, D] views (any 16-byte-aligned strides, rows past S
//    zero-filled), into 128-byte-swizzled shared tiles: Q once, K and V
//    through a ring of two stages with full / empty mbarriers, so the next
//    tile lands while this one is multiplied;
//  - S = Q K^T is one wgmma chain (m64nBKk16, A and B from shared memory;
//    128 keys a tile, 64 at head_dim 256); the online softmax runs on the
//    accumulator registers (row max and sum over the four lanes of a quad,
//    exp2 with the scale folded in, float32); P, rounded to bf16 in
//    registers as the JAX kernel rounds p to the value dtype, is the
//    register A operand of the P V wgmma (V read transposed from shared
//    memory);
//  - each consumer issues a tile's S and the previous tile's P V together,
//    then runs the softmax of S while that P V is still in flight; the two
//    consumers take turns issuing (named barriers), so one's softmax also
//    runs under the other's products (exp2 alone takes about half as long
//    as the products);
//  - masks (causal, length, window) are applied only on the tiles that
//    cross an edge; a tile wholly past its row's length writes zeros.
//  What remains: dealing ragged batches by their real tile costs (which
//  depend on seq_lens, a device value) and storing O through shared
//  memory.
//
// FMA variant (`flash_prefill_kernel`; float32, and bf16 at head_dim up to
// 32, each run at the next of 16, 32, 64, 128, 256 with the columns past
// the real head dim loaded as zeros): both products in float32 FMA from shared memory, exact enough that
// float32 serving on the card reproduces the CPU's greedy tokens.
//  - one block per (64-row query tile, query head, batch row), 256 threads;
//    the query tiles are launched longest-first (the tiles on the causal
//    diagonal's far end see the most K/V), so the triangular tail is short;
//  - K/V tiles of 64 positions stream through shared memory as float32
//    over the block range the JAX kernel visits: from the window's first
//    block up to the causal diagonal (and never past the row's length);
//  - each thread owns 4 query rows x 4 key columns of the score tile and
//    4 rows x D/16 output columns, with float4 shared-memory reads.
// In both, query head h reads KV head h / group in place through its
// strides, so repeated K/V is never materialized and no transpose copy is
// made; masked entries contribute exactly 0 and the running sum is guarded
// at 1e-30, so padded rows stay finite.
#include <cuda.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace symtorch {
namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // key positions per tile
constexpr int NT = 256;      // threads per block
constexpr int RPT = 4;       // query rows per thread
constexpr int CPT = 4;       // key columns per thread in the score tile
constexpr int PSTRIDE = BK + 4;

template <int D>
constexpr size_t smem_bytes() {
  // Qs [BQ][D+4], Ks [BK][D+4], Vs [BK][D], Ps [BQ][BK+4], all float32.
  return sizeof(float) *
         (size_t(BQ) * (D + 4) + size_t(BK) * (D + 4) + size_t(BK) * D +
          size_t(BQ) * PSTRIDE);
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ seq_lens,
                     T* __restrict__ out, int S, int D, int group,
                     long long qsb, long long qss, long long qsh,
                     long long ksb, long long kss, long long ksh,
                     long long vsb, long long vss, long long vsh,
                     long long osb, long long oss, long long osh,
                     int window, float scale) {
  constexpr int QS = DP + 4;  // padded row stride of Qs / Ks (16B aligned)
  constexpr int DC = DP / 16; // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * QS;
  float* Vs = Ks + BK * QS;
  float* Ps = Vs + BK * DP;

  const int qi = gridDim.x - 1 - blockIdx.x;  // longest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // 0..15: rows ty*RPT .. +RPT-1
  const int tx = tid & 15;  // 0..15: columns tx + 16*j
  const int q0 = qi * BQ;
  const int seq_len = min(seq_lens[b], S);

  T* ob = out + b * osb + h * osh;
  if (q0 >= seq_len) {
    // Every row of this tile is padding: finite zeros, no work.
    for (int idx = tid; idx < BQ * D; idx += NT) {
      const int r = idx / D, c = idx % D;
      if (q0 + r < S) ob[(long long)(q0 + r) * oss + c] = from_f<T>(0.f);
    }
    return;
  }

  // Columns D .. DP - 1 of the padded tiles are zeros: they add nothing to
  // a score, and the output columns they make are never stored.
  const T* qb = q + b * qsb + h * qsh;
  for (int idx = tid; idx < BQ * DP; idx += NT) {
    const int r = idx / DP, c = idx % DP;
    const float x = (q0 + r < S && c < D)
                        ? to_f(qb[(long long)(q0 + r) * qss + c])
                        : 0.f;
    Qs[r * QS + c] = x * scale;
  }

  float m[RPT], l[RPT], acc[RPT][DC];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // Key tiles: causal bound at the tile's last valid row; with a window,
  // skip tiles wholly older than the oldest key any row here can see.
  const int q_last = min(q0 + BQ, seq_len) - 1;
  const int hi = q_last / BK;
  const int lo = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;

  for (int j = lo; j <= hi; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BK * DP; idx += NT) {
      const int r = idx / DP, c = idx % DP;
      const bool in = k0 + r < S && c < D;
      Ks[r * QS + c] = in ? to_f(kb[(long long)(k0 + r) * kss + c]) : 0.f;
      Vs[r * DP + c] = in ? to_f(vb[(long long)(k0 + r) * vss + c]) : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) s[i][jj] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DP; d += 4) {
      float4 qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty * RPT + i) * QS + d]);
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj)
        kv[jj] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * jj) * QS + d]);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int jj = 0; jj < CPT; ++jj) {
          s[i][jj] = fmaf(qv[i].x, kv[jj].x, s[i][jj]);
          s[i][jj] = fmaf(qv[i].y, kv[jj].y, s[i][jj]);
          s[i][jj] = fmaf(qv[i].z, kv[jj].z, s[i][jj]);
          s[i][jj] = fmaf(qv[i].w, kv[jj].w, s[i][jj]);
        }
    }

    // Online softmax. A row's 64 scores live in the 16 lanes sharing ty,
    // which are one half of a warp: xor-shuffles below 16 stay inside it.
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = q0 + ty * RPT + i;
      bool valid[CPT];
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) {
        const int kp = k0 + tx + 16 * jj;
        valid[jj] = kp <= qpos && kp < seq_len &&
                    (window <= 0 || kp > qpos - window);
        if (valid[jj]) mx = fmaxf(mx, s[i][jj]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) {
        const float p = valid[jj] ? expf(s[i][jj] - m_new) : 0.f;
        rs += p;
        Ps[(ty * RPT + i) * PSTRIDE + tx + 16 * jj] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc += P @ V over this tile.
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 p4[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        p4[i] = *reinterpret_cast<const float4*>(
            &Ps[(ty * RPT + i) * PSTRIDE + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[DC];
#pragma unroll
        for (int c = 0; c < DC; ++c) vv[c] = Vs[(kk + u) * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float p = u == 0 ? p4[i].x
                        : u == 1 ? p4[i].y
                        : u == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = q0 + ty * RPT + i;
    if (r >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      if (tx + 16 * c < D)
        ob[(long long)r * oss + tx + 16 * c] = from_f<T>(acc[i][c] / denom);
  }
}

// DP: the built head dim the kernel runs at; D, the real one, at most DP.
template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* seq_lens, void* out, int B, int S, int H,
                   int K, int D, const long long* st, int window,
                   cudaStream_t stream) {
  auto kernel = flash_prefill_kernel<T, DP>;
  constexpr size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(seq_lens),
      static_cast<T*>(out), S, D, H / K, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], window,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

// A head dim runs at the next built size (16, 32, 64, 128, 256) with the
// columns past it zero (ops/flash.py padded_head_dim). bf16 takes this
// variant only up to 32 (ops/flash.py flash_variant); wider bf16 heads run
// on the tensor cores.
template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     const void* seq_lens, void* out, int B, int S, int H,
                     int K, const long long* st, int window,
                     cudaStream_t stream) {
  if (D < 16 || D % 8) return cudaErrorInvalidValue;
  if (D <= 16) return launch<T, 16>(q, k, v, seq_lens, out, B, S, H, K, D, st, window, stream);
  if (D <= 32) return launch<T, 32>(q, k, v, seq_lens, out, B, S, H, K, D, st, window, stream);
  if constexpr (std::is_same<T, float>::value) {
    if (D <= 64) return launch<T, 64>(q, k, v, seq_lens, out, B, S, H, K, D, st, window, stream);
    if (D <= 128) return launch<T, 128>(q, k, v, seq_lens, out, B, S, H, K, D, st, window, stream);
    if (D <= 256) return launch<T, 256>(q, k, v, seq_lens, out, B, S, H, K, D, st, window, stream);
  }
  return cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------------
// Tensor-core variant (bf16; head_dim 40 .. 256, run at 64, 128 or 256).

namespace tc {

constexpr int NT = 384;  // consumer warpgroups 0 and 1, producer 2
constexpr int BQ = 128;  // query rows per tile, 64 per consumer
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

template <int D>
struct Cfg {
  static constexpr int BK = D == 256 ? 64 : 128;  // keys per K/V tile
  static constexpr uint32_t Q_BYTES = BQ * D * 2;
  static constexpr uint32_t KV_BYTES = BK * D * 2;
  // 1 KB alignment slack, Q, and two stages of (K, V).
  static constexpr size_t SMEM = 1024 + Q_BYTES + 4 * size_t(KV_BYTES);
};

// Barriers: Q and, for each of the two stages, K and V: full (TMA landed)
// and empty (both consumers done with it).
struct Bars {
  uint64_t q_full, q_empty, k_full[2], v_full[2], k_empty[2], v_empty[2];
};

template <int BK>
__device__ __forceinline__ void mma_qk(float (&s)[BK / 2], uint64_t a,
                                       uint64_t b, int scale_d) {
  if constexpr (BK == 128) wgmma_ss_n128(s, a, b, scale_d);
  else wgmma_ss_n64(s, a, b, scale_d);
}

template <int D>
__device__ __forceinline__ void mma_pv(float (&o)[D / 2],
                                       const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 256) wgmma_rs_n256(o, a, b, 1);
  else if constexpr (D == 128) wgmma_rs_n128(o, a, b, 1);
  else wgmma_rs_n64(o, a, b, 1);
}

// A tile of `rows` rows starting at `row` of head `head`, batch `b`: one
// TMA box of 64 columns per column block, each [rows][64] with 128-byte
// swizzled rows.
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int rows, int head,
                                         int row, int b) {
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb)
    tma_load_4d(dst + cb * rows * 128, map, bar, cb * 64, head, row, b);
}

// Query tile t of a launch, longest first: all heads and rows of the last
// query tile, then the one before, ...
struct Tile {
  int q0, h, b;
};

__device__ __forceinline__ Tile tile_of(int t, int n_qt, int H, int B) {
  const int r = t % (H * B);
  return Tile{(n_qt - 1 - t / (H * B)) * BQ, r % H, r / H};
}

// The tile block p of G takes in round r: rounds deal the longest-first
// order out in a snake (odd rounds reversed), so a block that drew a long
// tile draws a short one next and the blocks finish together.
__device__ __forceinline__ int tile_at(int r, int G, int p) {
  return r * G + ((r & 1) ? G - 1 - p : p);
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const int* __restrict__ seq_lens,
                __nv_bfloat16* __restrict__ out, int B, int S, int H,
                int group, int hd, long long osb, long long oss,
                long long osh, int window, float sl2) {
  using C = Cfg<D>;
  constexpr int BK = C::BK;
  extern __shared__ __align__(1024) uint8_t tc_smem[];
  __shared__ Bars bars;
  const uint32_t sQ = (smem_u32(tc_smem) + 1023) & ~1023u;
  const uint32_t sK0 = sQ + C::Q_BYTES;  // stage s: K at sK0 + 2 s KV_BYTES,
  const uint32_t sV0 = sK0 + C::KV_BYTES;  // V right after it
  const int tid = threadIdx.x;
  const int n_qt = (S + BQ - 1) / BQ;
  const int n_tiles = n_qt * H * B;

  const uint32_t q_full = smem_u32(&bars.q_full);
  const uint32_t q_empty = smem_u32(&bars.q_empty);
  const uint32_t k_full = smem_u32(&bars.k_full[0]);  // + 8 s
  const uint32_t v_full = smem_u32(&bars.v_full[0]);
  const uint32_t k_empty = smem_u32(&bars.k_empty[0]);
  const uint32_t v_empty = smem_u32(&bars.v_empty[0]);
  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);  // one arrival per consumer warp
    for (int st = 0; st < 2; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(k_empty + 8 * st, 8);
      mbar_init(v_empty + 8 * st, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // The warpgroup index, read through a shuffle so the compiler sees it
  // is uniform across each warp.
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (wg == 2) {
    // Producer: one thread issues every TMA copy. Q of a tile once both
    // consumers finished the previous tile's products on Q; the block's
    // c-th K/V tile into stage c & 1 once both released its last tenant.
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 2 * 128) {
      int c = 0, k = 0;  // K/V tiles and query tiles loaded so far
      for (int r = 0;; ++r) {
        const int t = tile_at(r, gridDim.x, blockIdx.x);
        if (t >= n_tiles) break;
        const Tile x = tile_of(t, n_qt, H, B);
        const int seq_len = min(seq_lens[x.b], S);
        if (x.q0 >= seq_len) continue;  // zeros, written by the consumers
        const int hi = (min(x.q0 + BQ, seq_len) - 1) / BK;
        const int lo = window > 0 ? max(0, x.q0 - window + 1) / BK : 0;
        if (k > 0) mbar_wait(q_empty, (k - 1) & 1);
        mbar_expect_tx(q_full, C::Q_BYTES);
        tma_tile<D>(sQ, &tq, q_full, BQ, x.h, x.q0, x.b);
        for (int j = hi; j >= lo; --j, ++c) {
          const int st = c & 1;
          const uint32_t ph = ((c >> 1) & 1) ^ 1;
          if (c >= 2) mbar_wait(k_empty + 8 * st, ph);
          mbar_expect_tx(k_full + 8 * st, C::KV_BYTES);
          tma_tile<D>(sK0 + st * 2 * C::KV_BYTES, &tk, k_full + 8 * st, BK,
                      x.h / group, j * BK, x.b);
          if (c >= 2) mbar_wait(v_empty + 8 * st, ph);
          mbar_expect_tx(v_full + 8 * st, C::KV_BYTES);
          tma_tile<D>(sV0 + st * 2 * C::KV_BYTES, &tv, v_full + 8 * st, BK,
                      x.h / group, j * BK, x.b);
        }
        ++k;
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns query rows 64 wg .. 64 wg + 63 of each
  // tile.
  setmaxnreg_inc<kConsumerRegs>();
  const int warp = (tid >> 5) & 3;  // warp in the warpgroup: 16 rows
  const int lane = tid & 31;
  float o[D / 2], s[BK / 2], m[2], l[2], corr[2];
  uint32_t pa[BK / 16][4];  // the previous K/V tile's P, bf16 A fragments
  int q0 = 0, seq_len = 0, r0 = 0;
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;

  // S = Q K^T over D in 16-deep slices (both operands K-major).
  auto issue_qk = [&](int st) {
    const uint32_t sK = sK0 + st * 2 * C::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      mma_qk<BK>(s,
                 smem_desc(sQ + (kk >> 2) * (BQ * 128) + wg * (64 * 128) + off,
                           16, 1024),
                 smem_desc(sK + (kk >> 2) * (BK * 128) + off, 16, 1024),
                 kk > 0);
    }
  };
  // O += P V for a K/V tile in stage st (V transposed), 16 keys a slice.
  auto issue_pv = [&](int st) {
    const uint32_t sV = sV0 + st * 2 * C::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      mma_pv<D>(o, pa[kk], smem_desc(sV + kk * 2048, BK * 128, 1024));
  };
  // Online softmax of key tile j in the log2 domain (sl2 = scale * log2
  // e): P (float32) into s, m and l updated, O's factor into corr. Touches
  // no register of a product in flight.
  auto softmax = [&](int j) {
    const int k0 = j * BK;
    const bool edge = k0 + BK - 1 > q0 || k0 + BK > seq_len ||
                      (window > 0 && k0 <= q0 + BQ - 1 - window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int c = 0; c < BK / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float t = s[4 * c + e] * sl2;
        if (edge) {
          const int kp = k0 + 8 * c + c0 + (e & 1);
          const int qp = r0 + 8 * (e >> 1);
          if (!(kp <= qp && kp < seq_len &&
                (window <= 0 || kp > qp - window)))
            t = kNegInf;
        }
        s[4 * c + e] = t;
        mx[e >> 1] = fmaxf(mx[e >> 1], t);
      }
    }
    float mu[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      // A row with no visible key yet keeps m = kNegInf; exponentiate
      // against 0 then, so its masked entries give exactly 0.
      mu[i] = m_new == kNegInf ? 0.f : m_new;
      corr[i] = ex2(m[i] - mu[i]);
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int c = 0; c < BK / 2; ++c) {
      s[c] = ex2(s[c] - mu[(c >> 1) & 1]);
      l[(c >> 1) & 1] += s[c];
    }
  };
  // Once the previous P V has landed: O rescaled, P to bf16 A fragments.
  auto finish = [&]() {
#pragma unroll
    for (int c = 0; c < BK / 8; ++c) {
      pa[c >> 1][(c & 1) * 2] = pack_bf16(s[4 * c], s[4 * c + 1]);
      pa[c >> 1][(c & 1) * 2 + 1] = pack_bf16(s[4 * c + 2], s[4 * c + 3]);
    }
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      o[4 * c] *= corr[0];
      o[4 * c + 1] *= corr[0];
      o[4 * c + 2] *= corr[1];
      o[4 * c + 3] *= corr[1];
    }
  };

  // Ping-pong: the warpgroups take turns issuing their products (named
  // barrier 1 is warpgroup 0's turn, 2 warpgroup 1's), so one's softmax
  // runs under the other's matrix products. Warpgroup 1 lets warpgroup 0
  // go first; warpgroup 0 takes warpgroup 1's last hand-over at the end.
  if (wg == 1) named_arrive(1, 256);
  int c = 0, k = 0;  // K/V tiles and query tiles consumed so far
  for (int r = 0;; ++r) {
    const int t = tile_at(r, gridDim.x, blockIdx.x);
    if (t >= n_tiles) break;
    const Tile x = tile_of(t, n_qt, H, B);
    q0 = x.q0;
    seq_len = min(seq_lens[x.b], S);
    __nv_bfloat16* ob = out + x.b * osb + x.h * osh;
    if (q0 >= seq_len) {
      // Every row of this tile is padding: finite zeros, no work.
      for (int idx = tid; idx < BQ * (hd / 8); idx += 256) {
        const int r = idx / (hd / 8), cc = idx % (hd / 8);
        if (q0 + r < S)
          *reinterpret_cast<uint4*>(ob + (long long)(q0 + r) * oss + cc * 8) =
              make_uint4(0u, 0u, 0u, 0u);
      }
      continue;
    }
    // Key tiles: causal bound at the tile's last valid row; with a window,
    // skip tiles wholly older than the oldest key any row here can see.
    // Walked from the diagonal down, so the masked tiles come first.
    const int hi = (min(q0 + BQ, seq_len) - 1) / BK;
    const int lo = window > 0 ? max(0, q0 - window + 1) / BK : 0;
    const int n = hi - lo + 1;
    // This thread's rows: r0 (accumulator entries 4n, 4n+1) and r0 + 8
    // (4n+2, 4n+3); its columns 8n + c0 and 8n + c0 + 1.
    r0 = q0 + wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;

    mbar_wait(q_full, k & 1);
    // The diagonal key tile: S only.
    mbar_wait(k_full + 8 * (c & 1), (c >> 1) & 1);
    named_sync(1 + wg, 256);
    fence_regs(s);
    wgmma_fence();
    issue_qk(c & 1);
    wgmma_commit();
    named_arrive(2 - wg, 256);
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) {
      mbar_arrive(k_empty + 8 * (c & 1));
      if (n == 1) mbar_arrive(q_empty);
    }
    softmax(hi);
    finish();
    // Key tiles 1 .. n-1: this tile's S, then the previous tile's P V as
    // a second group; the softmax of S runs while that P V is in flight.
    for (int it = 1; it < n; ++it) {
      const int st = (c + it) & 1;
      mbar_wait(k_full + 8 * st, ((c + it) >> 1) & 1);
      mbar_wait(v_full + 8 * (st ^ 1), ((c + it - 1) >> 1) & 1);
      named_sync(1 + wg, 256);
      fence_regs(o);
      fence_regs(s);
      wgmma_fence();
      issue_qk(st);
      wgmma_commit();
      issue_pv(st ^ 1);
      wgmma_commit();
      named_arrive(2 - wg, 256);
      wgmma_wait<1>();
      fence_regs(s);
      softmax(hi - it);
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) {
        mbar_arrive(k_empty + 8 * st);
        mbar_arrive(v_empty + 8 * (st ^ 1));
        if (it == n - 1) mbar_arrive(q_empty);
      }
      finish();
    }
    // The last key tile's P V.
    c += n;
    ++k;
    const int st = (c - 1) & 1;
    mbar_wait(v_full + 8 * st, ((c - 1) >> 1) & 1);
    fence_regs(o);
    wgmma_fence();
    issue_pv(st);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if (lane == 0) mbar_arrive(v_empty + 8 * st);

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float sum = l[i];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int r = r0 + 8 * i;
      if (r >= S) continue;
      const float inv = 1.f / fmaxf(sum, 1e-30f);
      __nv_bfloat16* orow = ob + (long long)r * oss + c0;
#pragma unroll
      for (int cc = 0; cc < D / 8; ++cc)
        if (8 * cc < hd)  // columns past the real head dim are zeros
          *reinterpret_cast<uint32_t*>(orow + 8 * cc) =
              pack_bf16(o[4 * cc + 2 * i] * inv, o[4 * cc + 2 * i + 1] * inv);
    }
  }
  if (wg == 0) named_sync(1, 256);
}

// The [B, S, heads, D] bf16 tensor at `base` with element strides (batch,
// seq, head) as a 4-D TMA map {D, heads, S, B}, boxes of 64 columns x
// `rows` rows, 128-byte swizzle, zero fill past the edges: with the real
// head dim as D, the columns up to the built size (whole boxes past it
// too) land as zeros.
bool make_map(CUtensorMap* map, const void* base, int B, int S, int heads,
              int D, long long sb, long long ss, long long sh, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(heads),
                              cuuint64_t(S), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(sh) * 2, cuuint64_t(ss) * 2,
                                 cuuint64_t(sb) * 2};
  const cuuint32_t box[4] = {64, 1, cuuint32_t(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// D: the built head dim the kernel runs at; hd, the real one, at most D.
template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* seq_lens, void* out, int B, int S, int H,
                   int K, int hd, const long long* st, int window,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, S, H, hd, st[0], st[1], st[2], BQ) ||
      !make_map(&tk, k, B, S, K, hd, st[3], st[4], st[5], Cfg<D>::BK) ||
      !make_map(&tv, v, B, S, K, hd, st[6], st[7], st[8], Cfg<D>::BK))
    return cudaErrorInvalidValue;
  auto kernel = flash_tc_kernel<D>;
  constexpr size_t smem = Cfg<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // Persistent: one block per SM (at most one per query tile), each
  // walking its share of the longest-first order (tile_at).
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const long long n_tiles = (long long)((S + BQ - 1) / BQ) * H * B;
  kernel<<<(int)std::min<long long>(n_tiles, sms), NT, smem, stream>>>(
      tq, tk, tv, static_cast<const int*>(seq_lens),
      static_cast<__nv_bfloat16*>(out), B, S, H, H / K, hd, st[9], st[10],
      st[11], window, 1.4426950408889634f / sqrtf((float)hd));
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace
}  // namespace symtorch

// C entry point of the FMA variant (ctypes): float32 at any head_dim that
// is a multiple of 8 from 16 to 256, bf16 up to 32. Strides are in elements: (batch, seq, head) for q, k,
// v, out; the head_dim stride is 1. window <= 0 means no window. Returns
// the cudaError_t of the launch.
extern "C" int flash_prefill_launch(
    int dtype, const void* q, const void* k, const void* v,
    const void* seq_lens, void* out, int B, int S, int H, int K, int D,
    long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long osb, long long oss, long long osh, int window,
    void* stream) {
  using namespace symtorch;
  if (B <= 0 || S <= 0 || H <= 0 || K <= 0 || H % K) return cudaErrorInvalidValue;
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh,
                            vsb, vss, vsh, osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_d<float>(D, q, k, v, seq_lens, out, B, S, H, K, st, window, s);
  if (dtype == kBF16)
    return launch_d<__nv_bfloat16>(D, q, k, v, seq_lens, out, B, S, H, K, st, window, s);
  return cudaErrorInvalidValue;
}

// C entry point of the tensor-core variant (ctypes): bf16 q, k, v, out,
// any head_dim that is a multiple of 8 from 40 to 256, run at the next of
// 64, 128 or 256; the same arguments as flash_prefill_launch
// without the dtype. Every row start must be 16-byte aligned (the strides
// multiples of 8 elements, the pointers 16-byte aligned).
extern "C" int flash_prefill_tc_launch(
    const void* q, const void* k, const void* v, const void* seq_lens,
    void* out, int B, int S, int H, int K, int D, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long osb, long long oss,
    long long osh, int window, void* stream) {
  using namespace symtorch;
  if (B <= 0 || S <= 0 || H <= 0 || K <= 0 || H % K) return cudaErrorInvalidValue;
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh,
                            vsb, vss, vsh, osb, oss, osh};
  for (long long x : st)
    if (x % 8) return cudaErrorInvalidValue;
  for (const void* p : {q, k, v, static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32 || D > 256 || D % 8) return cudaErrorInvalidValue;
  if (D <= 64) return tc::launch<64>(q, k, v, seq_lens, out, B, S, H, K, D, st, window, s);
  if (D <= 128) return tc::launch<128>(q, k, v, seq_lens, out, B, S, H, K, D, st, window, s);
  return tc::launch<256>(q, k, v, seq_lens, out, B, S, H, K, D, st, window, s);
}
