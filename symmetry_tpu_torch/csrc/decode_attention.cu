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
// So the design reads each live row exactly once and nothing else:
//  - one block per (KV head, slot, chunk of up to GT query heads): the
//    block serves its query heads of that KV head, so a K/V row is read
//    once for the chunk (the TPU kernel's cross-head masked matmul is a TPU
//    layout trick and is not carried over). GT is a compile-time register
//    tile (1, 2, 4 or 8) and the group size G a runtime bound: heads past
//    G in the last chunk are computed on zeros and never stored, so every
//    group size runs (qwen2-7b's 7, say); G > 8 takes several chunks,
//    which read the slot's rows again;
//  - the layer is a pointer offset into the full cache -- no slice is
//    copied -- and the block walks only [max(len - window, 0), len);
//  - 8 warps split the positions, 4 consecutive positions per warp step;
//    each lane holds D/32 contiguous elements of a row (vector loads),
//    dot products reduce by warp shuffles, and each warp keeps its own
//    float32 online softmax; the warps combine through shared memory;
//  - int8 caches are read at one byte per element; as in `_quant_kernel`
//    the k scale of a position multiplies its score and the v scale its
//    probability, so no dequantized row exists anywhere;
//  - masked positions contribute exactly 0 and the final sum is guarded at
//    1e-30, so an empty slot gets finite zeros.
// Known limit: at B * K blocks (64 for llama3-8b at 8 slots) the grid fills
// half of the 132 SMs; splitting T across blocks with a combine pass is
// later work.
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace symtorch {
namespace {

constexpr int NW = 8;   // warps per block
constexpr int P = 4;    // positions per warp step

template <typename TQ, typename TKV, int D, int GT>
__global__ void __launch_bounds__(NW * 32)
decode_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kc,
                        const TKV* __restrict__ vc,
                        const float* __restrict__ ks,
                        const float* __restrict__ vs,
                        const int* __restrict__ kv_length,
                        TQ* __restrict__ out, int B, int Tcap, int K, int G,
                        int n_chunks, int layer, int window, float scale) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  constexpr int EPL = D >= 32 ? D / 32 : 1;  // row elements per lane
  constexpr int LANES = D / EPL;             // lanes holding a row slice
  __shared__ float sm_m[NW], sm_l[NW];
  __shared__ float sm_acc[NW][D];

  const int kvh = blockIdx.x / n_chunks;
  const int g0 = (blockIdx.x % n_chunks) * GT;  // first query head served
  const int gcount = min(GT, G - g0);
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool active = lane < LANES;
  const int len = min(max(kv_length[b], 0), Tcap);
  const int lo = window > 0 ? max(len - window, 0) : 0;

  // This chunk's query heads, the lane's slice, pre-scaled; heads past G
  // stay zero.
  float qr[GT][EPL];
  const long long head0 = (long long)b * K * G + (long long)kvh * G + g0;
  const TQ* qb = q + head0 * D;
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (active && g < gcount) {
      load_row<EPL>(qb + g * D + lane * EPL, qr[g]);
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[g][e] *= scale;
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[g][e] = 0.f;
    }
  }

  const long long row = (long long)K * D;  // elements per position
  const long long base =
      (((long long)layer * B + b) * Tcap) * row + (long long)kvh * D +
      lane * EPL;
  const TKV* kb = kc + base;
  const TKV* vb = vc + base;
  // Scale planes: [L, B, K, T], position minor.
  const long long sbase = (((long long)layer * B + b) * K + kvh) * Tcap;

  float m[GT], l[GT], acc[GT][EPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  for (int t0 = lo + warp * P; t0 < len; t0 += NW * P) {
    float kr[P][EPL], vr[P][EPL], ksc[P], vsc[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const bool live = t0 + p < len;
      if (active && live) {
        load_row<EPL>(kb + (t0 + p) * row, kr[p]);
        load_row<EPL>(vb + (t0 + p) * row, vr[p]);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kr[p][e] = vr[p][e] = 0.f;
      }
      if constexpr (kQuant) {
        ksc[p] = live ? ks[sbase + t0 + p] : 0.f;
        vsc[p] = live ? vs[sbase + t0 + p] : 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float s[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot = fmaf(qr[g][e], kr[p][e], dot);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[p] = kQuant ? dot * ksc[p] : dot;
      }
      float mx = kNegInf;
#pragma unroll
      for (int p = 0; p < P; ++p)
        if (t0 + p < len) mx = fmaxf(mx, s[p]);
      const float m_new = fmaxf(m[g], mx);
      const float corr = expf(m[g] - m_new);
      float pr[P];
      float rs = 0.f;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        pr[p] = t0 + p < len ? expf(s[p] - m_new) : 0.f;
        rs += pr[p];
      }
      l[g] = l[g] * corr + rs;
      m[g] = m_new;
      if constexpr (kQuant) {
#pragma unroll
        for (int p = 0; p < P; ++p) pr[p] *= vsc[p];
      }
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        float a = acc[g][e] * corr;
#pragma unroll
        for (int p = 0; p < P; ++p) a = fmaf(pr[p], vr[p][e], a);
        acc[g][e] = a;
      }
    }
  }

  // Combine the warps' partial softmaxes, one query head at a time.
  TQ* ob = out + head0 * D;
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (g >= gcount) break;  // uniform across the block
    if (lane == 0) {
      sm_m[warp] = m[g];
      sm_l[warp] = l[g];
    }
    if (active) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) sm_acc[warp][lane * EPL + e] = acc[g][e];
    }
    __syncthreads();
    for (int d = threadIdx.x; d < D; d += NW * 32) {
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w]);
      float denom = 0.f, num = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float c = expf(sm_m[w] - mx);
        denom += sm_l[w] * c;
        num += sm_acc[w][d] * c;
      }
      ob[g * D + d] = from_f<TQ>(num / fmaxf(denom, 1e-30f));
    }
    __syncthreads();
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
  int B, Tcap, K, G, layer, window;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int D, int GT>
cudaError_t launch(const Args& a) {
  const int n_chunks = (a.G + GT - 1) / GT;
  const dim3 grid(a.K * n_chunks, a.B);
  decode_attention_kernel<TQ, TKV, D, GT><<<grid, NW * 32, 0, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.kc),
      static_cast<const TKV*>(a.vc), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.kv_length),
      static_cast<TQ*>(a.out), a.B, a.Tcap, a.K, a.G, n_chunks, a.layer,
      a.window, 1.0f / sqrtf((float)D));
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
// device. window <= 0 means no window. Returns the cudaError_t of the
// launch.
extern "C" int decode_attention_launch(int dtype, int kv_dtype, const void* q,
                                       const void* k_cache,
                                       const void* v_cache,
                                       const void* k_scale,
                                       const void* v_scale,
                                       const void* kv_length, void* out,
                                       int L, int B, int T, int K, int D,
                                       int n_q, int layer, int window,
                                       void* stream) {
  using namespace symtorch;
  if (B <= 0 || T <= 0 || K <= 0 || n_q <= 0 || n_q % K || layer < 0 ||
      layer >= L)
    return cudaErrorInvalidValue;
  const Args a{q, k_cache, v_cache, k_scale, v_scale, kv_length, out,
               B, T, K, n_q / K, layer, window,
               static_cast<cudaStream_t>(stream)};
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
