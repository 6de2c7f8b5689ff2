// Ragged decode attention for Hopper (sm_90a): one query position per slot
// against the full [L, B, T, K, D] KV cache, reading only the occupied
// prefix of each slot, with an optional sliding-window floor. bf16 and f32
// caches, and int8 caches with position-minor [L, B, K, T] f32 scales.
//
// Replaces the Pallas TPU kernels symmetry_tpu/ops/decode_attention.py
// `_kernel` (bf16/f32) and `_quant_kernel` (int8), both called from
// `decode_attention` (pl.pallas_call at decode_attention.py:231).
//
// What bounds it on this card: bytes. Every occupied K/V row is used for
// G = n_q / K query heads and 2 * G * D operations each, far below the
// ~295 operations per byte where the tensor cores would become the limit.
// So the design reads each live row exactly once, and keeps enough of
// those bytes in flight to run at the memory's rate:
//  - the slot's capacity T is split into spans of `span` positions (the
//    wrapper's plan, ops/decode_attention.py SPAN); one block per (KV head
//    x chunk of up to GT query heads, slot, span), so a long slot is read
//    by many SMs at once instead of one. A block whose span holds no live
//    position -- at or past the slot's length, or wholly below its window
//    floor -- exits at once;
//  - each warp streams its share of the span through its own cp.async ring
//    of 4 stages (1 KB of K and 1 KB of V a stage, 16-byte copies, rows
//    past the length zero-filled), so three stages are in flight while one
//    is reduced, and warps never wait on each other until the span ends;
//  - from shared memory each lane takes 8 elements of a row (D/8 lanes a
//    row); scores reduce over those lanes by shuffles, each row group keeps
//    a float32 online softmax (log2 domain), and the groups and warps merge
//    at the span's end into one partial (m, l, acc[D]) per query head,
//    written in float32 to scratch the wrapper allocates;
//  - a second small kernel merges the live spans of each (slot, query head)
//    and writes the output in q's dtype; it reads kv_length on the device,
//    so the wrapper never synchronizes with the host;
//  - GT is a compile-time register tile (1, 2, 4 or 8 heads) and the group
//    size G a runtime bound: heads past G in the last chunk are computed on
//    zeros and never stored, so every group size runs (qwen2-7b's 7, say);
//    G > 8 takes several chunks, which read the slot's rows again;
//  - the layer is a pointer offset into the full cache -- no slice is
//    copied; int8 caches are read at one byte per element and, as in
//    `_quant_kernel`, the k scale of a position multiplies its score and
//    the v scale its probability, so no dequantized row exists anywhere;
//  - masked positions contribute exactly 0, a span with no live row is
//    never merged, and the final sum is guarded at 1e-30, so an empty slot
//    gets finite zeros (kNegInf is finite: no inf - inf anywhere).
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace symtorch {
namespace {

constexpr int NW = 4;             // warps per block
constexpr int STAGES = 4;         // cp.async ring depth of each warp
constexpr int STAGE_BYTES = 1024; // K bytes (and V bytes) of one stage
constexpr float kLog2e = 1.4426950408889634f;

// Per (cache type, head dim): a lane reads 8 elements of a row from shared
// memory, LPR lanes cover a row, RPW rows a warp pass, WR rows a stage,
// NP passes a stage.
template <typename TKV, int D>
struct Geo {
  static constexpr int ROW_BYTES = D * int(sizeof(TKV));
  static constexpr int LPR = D / 8;
  static constexpr int RPW = 32 / LPR;
  static constexpr int WR = STAGE_BYTES / ROW_BYTES > RPW
                                ? STAGE_BYTES / ROW_BYTES : RPW;
  static constexpr int NP = WR / RPW;
  static constexpr int CPR = ROW_BYTES / 16;  // 16-byte copies a row
  static constexpr int KV_BYTES = WR * ROW_BYTES;
  // K, V, then the k and v scales, rounded to keep stages 16-byte aligned.
  static constexpr int STAGE = 2 * KV_BYTES + (2 * WR * 4 + 15) / 16 * 16;
};

// Eight elements from shared memory into floats.
__device__ __forceinline__ void lds8(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void lds8(const float* p, float (&o)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void lds8(const int8_t* p, float (&o)[8]) {
  unpack8(*reinterpret_cast<const uint2*>(p), o);
}

template <typename TQ, typename TKV, int D, int GT>
__global__ void __launch_bounds__(NW * 32)
decode_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kc,
                    const TKV* __restrict__ vc, const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ kv_length,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int B, int Tcap, int K, int G, int n_chunks, int layer,
                    int window, int span, float scale) {
  using Gm = Geo<TKV, D>;
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  constexpr int LPR = Gm::LPR, RPW = Gm::RPW, WR = Gm::WR, NP = Gm::NP;
  constexpr int CPR = Gm::CPR, EPC = 16 / int(sizeof(TKV));  // elems a copy
  extern __shared__ __align__(16) uint8_t ring[];
  __shared__ float sm_m[NW], sm_l[NW];
  __shared__ float sm_acc[NW][D];

  const int kvh = blockIdx.x / n_chunks;
  const int g0 = (blockIdx.x % n_chunks) * GT;  // first query head served
  const int gcount = min(GT, G - g0);
  const int b = blockIdx.y;
  const int sp = blockIdx.z;
  const int len = min(max(kv_length[b], 0), Tcap);
  const int lo = window > 0 ? max(len - window, 0) : 0;
  const int a = max(sp * span, lo);            // this block's live rows
  const int e = min((sp + 1) * span, len);     // are [a, e)
  if (a >= e) return;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rr = lane / LPR;         // row within a pass
  const int e0 = (lane % LPR) * 8;   // first element this lane reads

  // This chunk's query heads, the lane's 8 elements, pre-scaled into the
  // log2 domain; heads past G stay zero.
  const int nq = K * G;
  const long long head0 = (long long)b * nq + (long long)kvh * G + g0;
  float qr[GT][8];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (g < gcount) {
      load_row<8>(q + (head0 + g) * D + e0, qr[g]);
#pragma unroll
      for (int x = 0; x < 8; ++x) qr[g][x] *= scale * kLog2e;
    } else {
#pragma unroll
      for (int x = 0; x < 8; ++x) qr[g][x] = 0.f;
    }
  }

  const long long row = (long long)K * D;  // elements per position
  const long long kvbase =
      ((long long)layer * B + b) * Tcap * row + (long long)kvh * D;
  const TKV* kb = kc + kvbase;
  const TKV* vb = vc + kvbase;
  // Scale planes: [L, B, K, T], position minor.
  const long long sbase = (((long long)layer * B + b) * K + kvh) * Tcap;

  // This warp's ring, and its chunks of WR rows: w, w + NW, ...
  uint8_t* wring = ring + warp * STAGES * Gm::STAGE;
  const int n_all = (e - a + WR - 1) / WR;
  const int n_w = n_all > warp ? (n_all - warp + NW - 1) / NW : 0;

  auto issue = [&](int i) {
    uint8_t* st = wring + (i % STAGES) * Gm::STAGE;
    const int t0 = a + (warp + i * NW) * WR;
#pragma unroll
    for (int x = lane; x < WR * CPR; x += 32) {
      const int r = x / CPR, c = x % CPR;
      const bool ok = t0 + r < e;
      const long long src = (ok ? t0 + r : a) * row + c * EPC;
      cp_async16(smem_u32(st + r * Gm::ROW_BYTES + c * 16), kb + src, ok);
      cp_async16(smem_u32(st + Gm::KV_BYTES + r * Gm::ROW_BYTES + c * 16),
                 vb + src, ok);
    }
    if constexpr (kQuant) {
      float* sc = reinterpret_cast<float*>(st + 2 * Gm::KV_BYTES);
#pragma unroll
      for (int x = lane; x < WR; x += 32) {
        const bool ok = t0 + x < e;
        const long long src = sbase + (ok ? t0 + x : a);
        cp_async4(smem_u32(sc + x), ks + src, ok);
        cp_async4(smem_u32(sc + WR + x), vs + src, ok);
      }
    }
  };

  float m[GT], l[GT], acc[GT][8];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int x = 0; x < 8; ++x) acc[g][x] = 0.f;
  }

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_w) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_w; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncwarp();  // chunk i landed for every lane; chunk i - 1 is consumed
    if (i + STAGES - 1 < n_w) issue(i + STAGES - 1);
    cp_async_commit();

    const uint8_t* st = wring + (i % STAGES) * Gm::STAGE;
    const TKV* sk = reinterpret_cast<const TKV*>(st);
    const TKV* sv = reinterpret_cast<const TKV*>(st + Gm::KV_BYTES);
    const float* sks = reinterpret_cast<const float*>(st + 2 * Gm::KV_BYTES);
    const int t0 = a + (warp + i * NW) * WR;

    float sc[NP][GT];
    bool live[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int r = p * RPW + rr;
      live[p] = t0 + r < e;
      float kf[8];
      lds8(sk + r * D + e0, kf);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int x = 0; x < 8; ++x) dot = fmaf(qr[g][x], kf[x], dot);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        sc[p][g] = kQuant ? dot * sks[r] : dot;
      }
    }
    // Online softmax over this chunk's rows, per head; sc becomes the
    // probabilities (times the v scale for int8).
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mx = kNegInf;
#pragma unroll
      for (int p = 0; p < NP; ++p)
        if (live[p]) mx = fmaxf(mx, sc[p][g]);
      const float m_new = fmaxf(m[g], mx);
      const float corr = ex2(m[g] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const float pr = live[p] ? ex2(sc[p][g] - m_new) : 0.f;
        rs += pr;
        sc[p][g] = kQuant ? pr * sks[WR + p * RPW + rr] : pr;
      }
      l[g] = l[g] * corr + rs;
      m[g] = m_new;
#pragma unroll
      for (int x = 0; x < 8; ++x) acc[g][x] *= corr;
    }
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      float vf[8];
      lds8(sv + (p * RPW + rr) * D + e0, vf);
#pragma unroll
      for (int g = 0; g < GT; ++g)
#pragma unroll
        for (int x = 0; x < 8; ++x) acc[g][x] = fmaf(sc[p][g], vf[x], acc[g][x]);
    }
  }

  // Merge the warp's row groups (lanes LPR apart hold the same elements).
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mm = fmaxf(m[g], mo);
      const float c1 = ex2(m[g] - mm), c2 = ex2(mo - mm);
      l[g] = l[g] * c1 + lo_ * c2;
#pragma unroll
      for (int x = 0; x < 8; ++x)
        acc[g][x] = acc[g][x] * c1 +
                    __shfl_xor_sync(0xffffffffu, acc[g][x], off) * c2;
      m[g] = mm;
    }
  }

  // Merge the warps, one query head at a time, into this span's partial.
  const int n_spans = gridDim.z;
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (g >= gcount) break;  // uniform across the block
    if (lane < LPR) {
#pragma unroll
      for (int x = 0; x < 8; ++x) sm_acc[warp][e0 + x] = acc[g][x];
      if (lane == 0) {
        sm_m[warp] = m[g];
        sm_l[warp] = l[g];
      }
    }
    __syncthreads();
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w]);
    const long long slot = (head0 + g) * n_spans + sp;
    for (int d = threadIdx.x; d < D; d += NW * 32) {
      float num = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) num += sm_acc[w][d] * ex2(sm_m[w] - mx);
      part_acc[slot * D + d] = num;
    }
    if (threadIdx.x == 0) {
      float den = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) den += sm_l[w] * ex2(sm_m[w] - mx);
      part_ml[2 * slot] = mx;
      part_ml[2 * slot + 1] = den;
    }
    __syncthreads();
  }
}

// One block per (slot, query head): merge the spans that held live rows.
template <typename TQ, int D>
__global__ void __launch_bounds__(128)
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_ml,
                      const int* __restrict__ kv_length, TQ* __restrict__ out,
                      int nq, int Tcap, int window, int span, int n_spans) {
  const long long bh = blockIdx.x;  // b * nq + head
  const int len = min(max(kv_length[bh / nq], 0), Tcap);
  const int lo = window > 0 ? max(len - window, 0) : 0;
  // Spans s_lo .. s_hi are exactly those whose blocks found live rows.
  const int s_lo = lo / span;
  const int s_hi = len > 0 ? (len - 1) / span : -1;
  const float* ml = part_ml + bh * n_spans * 2;
  float mx = kNegInf;
  for (int s = s_lo; s <= s_hi; ++s) mx = fmaxf(mx, ml[2 * s]);
  float den = 0.f;
  for (int s = s_lo; s <= s_hi; ++s) den += ml[2 * s + 1] * ex2(ml[2 * s] - mx);
  const float inv = 1.f / fmaxf(den, 1e-30f);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float num = 0.f;
    for (int s = s_lo; s <= s_hi; ++s)
      num += part_acc[(bh * n_spans + s) * D + d] * ex2(ml[2 * s] - mx);
    out[bh * D + d] = from_f<TQ>(num * inv);
  }
}

struct Args {
  const void* q;
  const void* kc;
  const void* vc;
  const void* ks;
  const void* vs;
  const void* kv_length;
  void* out;
  float* part_acc;
  float* part_ml;
  int B, Tcap, K, G, layer, window, span, n_spans;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int D, int GT>
cudaError_t launch(const Args& a) {
  auto kernel = decode_split_kernel<TQ, TKV, D, GT>;
  const int smem = NW * STAGES * Geo<TKV, D>::STAGE;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_chunks = (a.G + GT - 1) / GT;
  const dim3 grid(a.K * n_chunks, a.B, a.n_spans);
  kernel<<<grid, NW * 32, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.kc),
      static_cast<const TKV*>(a.vc), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.kv_length),
      a.part_acc, a.part_ml, a.B, a.Tcap, a.K, a.G, n_chunks, a.layer,
      a.window, a.span, 1.0f / sqrtf((float)D));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<TQ, D><<<a.B * a.K * a.G, 128, 0, a.stream>>>(
      a.part_acc, a.part_ml, static_cast<const int*>(a.kv_length),
      static_cast<TQ*>(a.out), a.K * a.G, a.Tcap, a.window, a.span,
      a.n_spans);
  return cudaGetLastError();
}

// The smallest register tile that holds the group, at most 8 heads.
template <typename TQ, typename TKV, int D>
cudaError_t launch_g(const Args& a) {
  if (a.G <= 1) return launch<TQ, TKV, D, 1>(a);
  if (a.G <= 2) return launch<TQ, TKV, D, 2>(a);
  if (a.G <= 4) return launch<TQ, TKV, D, 4>(a);
  return launch<TQ, TKV, D, 8>(a);
}

template <typename TQ, typename TKV>
cudaError_t launch_d(int D, const Args& a) {
  switch (D) {
    case 16: return launch_g<TQ, TKV, 16>(a);
    case 32: return launch_g<TQ, TKV, 32>(a);
    case 64: return launch_g<TQ, TKV, 64>(a);
    case 128: return launch_g<TQ, TKV, 128>(a);
    case 256: return launch_g<TQ, TKV, 256>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace symtorch

// C entry point (ctypes). q [B, n_q, D] and out [B, n_q, D] in `dtype`;
// caches [L, B, T, K, D] in `kv_dtype` (== dtype, or int8 with k_scale /
// v_scale [L, B, K, T] float32), all contiguous; kv_length [B] int32 on the
// device. window <= 0 means no window. The capacity T is split into n_spans
// spans of `span` positions (n_spans = ceil(T / span)); `scratch` holds
// B * n_q * n_spans * (D + 2) float32 for the spans' partials. Launches the
// split kernel and the combine kernel; returns the first cudaError_t.
extern "C" int decode_attention_launch(int dtype, int kv_dtype, const void* q,
                                       const void* k_cache,
                                       const void* v_cache,
                                       const void* k_scale,
                                       const void* v_scale,
                                       const void* kv_length, void* out,
                                       void* scratch, int L, int B, int T,
                                       int K, int D, int n_q, int layer,
                                       int window, int span, int n_spans,
                                       void* stream) {
  using namespace symtorch;
  if (B <= 0 || T <= 0 || K <= 0 || n_q <= 0 || n_q % K || layer < 0 ||
      layer >= L || span <= 0 || n_spans <= 0 ||
      (long long)n_spans * span < T || (long long)(n_spans - 1) * span >= T)
    return cudaErrorInvalidValue;
  float* part_acc = static_cast<float*>(scratch);
  float* part_ml = part_acc + (long long)B * n_q * n_spans * D;
  const Args a{q, k_cache, v_cache, k_scale, v_scale, kv_length, out,
               part_acc, part_ml, B, T, K, n_q / K, layer, window, span,
               n_spans, static_cast<cudaStream_t>(stream)};
  if (kv_dtype == kInt8) {
    if (k_scale == nullptr || v_scale == nullptr) return cudaErrorInvalidValue;
    if (dtype == kF32) return launch_d<float, int8_t>(D, a);
    if (dtype == kBF16) return launch_d<__nv_bfloat16, int8_t>(D, a);
    return cudaErrorInvalidValue;
  }
  if (kv_dtype != dtype) return cudaErrorInvalidValue;
  if (dtype == kF32) return launch_d<float, float>(D, a);
  if (dtype == kBF16) return launch_d<__nv_bfloat16, __nv_bfloat16>(D, a);
  return cudaErrorInvalidValue;
}
