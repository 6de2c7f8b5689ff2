// Ragged decode attention for Hopper (sm_90a): one query position per slot
// against the full [L, B, T, K, D] KV cache, reading only the occupied
// prefix of each slot, with an optional sliding-window floor. bf16 and f32
// caches.
//
// Replaces the Pallas TPU kernel symmetry_tpu/ops/decode_attention.py
// `_kernel` (called from `decode_attention`, pl.pallas_call at
// decode_attention.py:231). The int8 variant `_quant_kernel` is not ported.
//
// What bounds it on this card: bytes. Every occupied K/V row is used for
// G = n_q / K query heads and 2 * G * D operations each, far below the
// ~295 operations per byte where the tensor cores would become the limit.
// So the design reads each live row exactly once and nothing else:
//  - one block per (KV head, slot): the block serves all G query heads of
//    that KV head, so a K/V row is read once for the group (the TPU kernel's
//    cross-head masked matmul is a TPU layout trick and is not carried
//    over);
//  - the layer is a pointer offset into the full cache -- no slice is
//    copied -- and the block walks only [max(len - window, 0), len);
//  - 8 warps split the positions, 4 consecutive positions per warp step;
//    each lane holds D/32 contiguous elements of a row (8- or 16-byte
//    loads), dot products reduce by warp shuffles, and each warp keeps its
//    own float32 online softmax; the warps combine through shared memory;
//  - masked positions contribute exactly 0 and the final sum is guarded at
//    1e-30, so an empty slot gets finite zeros.
// Known limit: at B * K blocks (64 for llama3-8b at 8 slots) the grid fills
// half of the 132 SMs; splitting T across blocks with a combine pass is
// later work.
#include <stdint.h>

#include "common.cuh"

namespace symtorch {
namespace {

constexpr int NW = 8;   // warps per block
constexpr int P = 4;    // positions per warp step

template <typename T, int D, int G>
__global__ void __launch_bounds__(NW * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc,
                        const int* __restrict__ kv_length, T* __restrict__ out,
                        int B, int Tcap, int K, int layer, int window,
                        float scale) {
  constexpr int EPL = D >= 32 ? D / 32 : 1;  // row elements per lane
  constexpr int LANES = D / EPL;             // lanes holding a row slice
  __shared__ float sm_m[NW], sm_l[NW];
  __shared__ float sm_acc[NW][D];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool active = lane < LANES;
  const int len = min(max(kv_length[b], 0), Tcap);
  const int lo = window > 0 ? max(len - window, 0) : 0;

  // This KV head's G query heads, the lane's slice, pre-scaled.
  float qr[G][EPL];
  const T* qb = q + ((long long)b * K * G + (long long)kvh * G) * D;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (active) {
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
  const T* kb = kc + base;
  const T* vb = vc + base;

  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  for (int t0 = lo + warp * P; t0 < len; t0 += NW * P) {
    float kr[P][EPL], vr[P][EPL];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (active && t0 + p < len) {
        load_row<EPL>(kb + (t0 + p) * row, kr[p]);
        load_row<EPL>(vb + (t0 + p) * row, vr[p]);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kr[p][e] = vr[p][e] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot = fmaf(qr[g][e], kr[p][e], dot);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[p] = dot;
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
  T* ob = out + ((long long)b * K * G + (long long)kvh * G) * D;
#pragma unroll
  for (int g = 0; g < G; ++g) {
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
      ob[g * D + d] = from_f<T>(num / fmaxf(denom, 1e-30f));
    }
    __syncthreads();
  }
}

template <typename T, int D, int G>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const void* kv_length, void* out, int B, int Tcap, int K,
                   int layer, int window, cudaStream_t stream) {
  const dim3 grid(K, B);
  decode_attention_kernel<T, D, G><<<grid, NW * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int*>(kv_length),
      static_cast<T*>(out), B, Tcap, K, layer, window,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_g(int G, const void* q, const void* kc, const void* vc,
                     const void* kv_length, void* out, int B, int Tcap, int K,
                     int layer, int window, cudaStream_t s) {
  switch (G) {
    case 1: return launch<T, D, 1>(q, kc, vc, kv_length, out, B, Tcap, K, layer, window, s);
    case 2: return launch<T, D, 2>(q, kc, vc, kv_length, out, B, Tcap, K, layer, window, s);
    case 4: return launch<T, D, 4>(q, kc, vc, kv_length, out, B, Tcap, K, layer, window, s);
    case 8: return launch<T, D, 8>(q, kc, vc, kv_length, out, B, Tcap, K, layer, window, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_d(int D, int G, const void* q, const void* kc,
                     const void* vc, const void* kv_length, void* out, int B,
                     int Tcap, int K, int layer, int window, cudaStream_t s) {
  switch (D) {
    case 16: return launch_g<T, 16>(G, q, kc, vc, kv_length, out, B, Tcap, K, layer, window, s);
    case 32: return launch_g<T, 32>(G, q, kc, vc, kv_length, out, B, Tcap, K, layer, window, s);
    case 64: return launch_g<T, 64>(G, q, kc, vc, kv_length, out, B, Tcap, K, layer, window, s);
    case 128: return launch_g<T, 128>(G, q, kc, vc, kv_length, out, B, Tcap, K, layer, window, s);
    case 256: return launch_g<T, 256>(G, q, kc, vc, kv_length, out, B, Tcap, K, layer, window, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace symtorch

// C entry point (ctypes). q [B, n_q, D], caches [L, B, T, K, D], out
// [B, n_q, D], all contiguous; kv_length [B] int32 on the device.
// window <= 0 means no window. Returns the cudaError_t of the launch.
extern "C" int decode_attention_launch(int dtype, const void* q,
                                       const void* k_cache,
                                       const void* v_cache,
                                       const void* kv_length, void* out,
                                       int L, int B, int T, int K, int D,
                                       int n_q, int layer, int window,
                                       void* stream) {
  using namespace symtorch;
  if (B <= 0 || T <= 0 || K <= 0 || n_q % K || layer < 0 || layer >= L)
    return cudaErrorInvalidValue;
  const int G = n_q / K;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_d<float>(D, G, q, k_cache, v_cache, kv_length, out, B, T,
                           K, layer, window, s);
  if (dtype == kBF16)
    return launch_d<__nv_bfloat16>(D, G, q, k_cache, v_cache, kv_length, out,
                                   B, T, K, layer, window, s);
  return cudaErrorInvalidValue;
}
