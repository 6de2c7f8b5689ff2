// Flash prefill attention for Hopper (sm_90a): causal GQA self-attention
// over a fresh padded prompt, ragged per-row lengths, optional sliding
// window, online softmax in float32.
//
// Replaces the Pallas TPU kernel symmetry_tpu/ops/flash.py `_flash_kernel`
// (called from `flash_prefill`, pl.pallas_call at flash.py:129).
//
// What bounds it on this card: at prefill widths the work is operations,
// not bytes -- llama3-8b at S = 2048 does ~34 GFLOP per layer on ~25 MB of
// q/k/v. This first version computes both products with float32 FMA from
// shared memory (no tensor cores), so it runs far below the bf16 tensor
// core peak; wgmma, TMA and warp specialization are later work.
//
// Design:
//  - one block per (64-row query tile, query head, batch row), 256 threads;
//    the query tiles are launched longest-first (the tiles on the causal
//    diagonal's far end see the most K/V), so the triangular tail is short;
//  - K/V tiles of 64 positions stream through shared memory as float32
//    over the block range the JAX kernel visits: from the window's first
//    block up to the causal diagonal (and never past the row's length);
//  - query head h reads KV head h / group in place through its strides, so
//    repeated K/V is never materialized and no transpose copy is made;
//  - each thread owns 4 query rows x 4 key columns of the score tile and
//    4 rows x D/16 output columns, with float4 shared-memory reads;
//  - masked entries contribute exactly 0 and the running sum is guarded at
//    1e-30, so padded rows stay finite; a tile wholly past its row's length
//    writes zeros and skips the work.
#include <stdint.h>

#include "common.cuh"

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

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ seq_lens,
                     T* __restrict__ out, int S, int group,
                     long long qsb, long long qss, long long qsh,
                     long long ksb, long long kss, long long ksh,
                     long long vsb, long long vss, long long vsh,
                     long long osb, long long oss, long long osh,
                     int window, float scale) {
  constexpr int QS = D + 4;   // padded row stride of Qs / Ks (16B aligned)
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * QS;
  float* Vs = Ks + BK * QS;
  float* Ps = Vs + BK * D;

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

  const T* qb = q + b * qsb + h * qsh;
  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const float x = (q0 + r < S) ? to_f(qb[(long long)(q0 + r) * qss + c])
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
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int r = idx / D, c = idx % D;
      const bool in = k0 + r < S;
      Ks[r * QS + c] = in ? to_f(kb[(long long)(k0 + r) * kss + c]) : 0.f;
      Vs[r * D + c] = in ? to_f(vb[(long long)(k0 + r) * vss + c]) : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) s[i][jj] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
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
        for (int c = 0; c < DC; ++c) vv[c] = Vs[(kk + u) * D + tx + 16 * c];
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
      ob[(long long)r * oss + tx + 16 * c] = from_f<T>(acc[i][c] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* seq_lens, void* out, int B, int S, int H,
                   int K, const long long* st, int window,
                   cudaStream_t stream) {
  auto kernel = flash_prefill_kernel<T, D>;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(seq_lens),
      static_cast<T*>(out), S, H / K, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], window,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     const void* seq_lens, void* out, int B, int S, int H,
                     int K, const long long* st, int window,
                     cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, seq_lens, out, B, S, H, K, st, window, stream);
    case 32: return launch<T, 32>(q, k, v, seq_lens, out, B, S, H, K, st, window, stream);
    case 64: return launch<T, 64>(q, k, v, seq_lens, out, B, S, H, K, st, window, stream);
    case 128: return launch<T, 128>(q, k, v, seq_lens, out, B, S, H, K, st, window, stream);
    case 256: return launch<T, 256>(q, k, v, seq_lens, out, B, S, H, K, st, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace symtorch

// C entry point (ctypes). Strides are in elements: (batch, seq, head) for
// q, k, v, out; the head_dim stride is 1. window <= 0 means no window.
// Returns the cudaError_t of the launch.
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
