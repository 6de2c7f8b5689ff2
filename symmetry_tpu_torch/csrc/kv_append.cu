// Fused decode-step KV append for Hopper (sm_90a): quantize one new K and V
// row per (slot, KV head) to int8 and write payload and scale into the
// full cache in place.
//
// Replaces the Pallas TPU kernel symmetry_tpu/ops/kv_append.py `_kernel`
// (called from `kv_append`, pl.pallas_call at kv_append.py:151).
//
// Arithmetic, exactly ops/quant.py `quantize_kv` on the row upcast to
// float32: scale = max(max|x|, 1e-8) / 127, q = clip(rint(x / scale),
// -127, 127). rintf rounds half to even like torch.round and jnp.round,
// and the division is IEEE (no fast-math), so the payload is bit-equal to
// the plain version on the same operand.
//
// What bounds it on this card: neither -- it moves B * K * (2 D + 8) bytes
// per call (about 17 KB for llama3-8b at 8 slots), so its time is the
// launch. The design is one warp per (KV head, slot, K or V): the warp
// holds the D-element row in registers (D/32 per lane), reduces the amax
// by shuffles, and writes D payload bytes and one scale. The layer is a
// pointer offset and the position min(pos, T - 1) (a free slot's stale
// length can reach capacity; it writes the last row of its own lane). The
// TPU kernel's masked lane select over a 128-wide scale block is a TPU
// store restriction: here one thread stores the one scale, so neighbouring
// scales are never read or rewritten.
#include <stdint.h>

#include "common.cuh"

namespace symtorch {
namespace {

constexpr int kMaxPerLane = 8;  // D <= 256

template <typename T>
__global__ void __launch_bounds__(32)
kv_append_kernel(const T* __restrict__ k_new, const T* __restrict__ v_new,
                 int8_t* __restrict__ ck, int8_t* __restrict__ cv,
                 float* __restrict__ ks, float* __restrict__ vs,
                 const int* __restrict__ positions, int B, int Tcap, int K,
                 int D, int layer) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const bool is_v = blockIdx.z == 1;
  const int lane = threadIdx.x;
  const T* x = (is_v ? v_new : k_new) + ((long long)b * K + kvh) * D;
  int8_t* cache = is_v ? cv : ck;
  float* sc = is_v ? vs : ks;
  const int pos = min(max(positions[b], 0), Tcap - 1);

  float v[kMaxPerLane];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    const int i = lane + 32 * j;
    v[j] = i < D ? to_f(x[i]) : 0.f;
    amax = fmaxf(amax, fabsf(v[j]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = fmaxf(amax, 1e-8f) / 127.0f;

  int8_t* dst =
      cache + ((((long long)layer * B + b) * Tcap + pos) * K + kvh) * D;
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    const int i = lane + 32 * j;
    if (i < D) {
      const float qv = fminf(fmaxf(rintf(v[j] / scale), -127.f), 127.f);
      dst[i] = static_cast<int8_t>(qv);
    }
  }
  if (lane == 0)
    sc[(((long long)layer * B + b) * K + kvh) * Tcap + pos] = scale;
}

template <typename T>
cudaError_t launch(const void* k_new, const void* v_new, void* ck, void* cv,
                   void* ks, void* vs, const void* positions, int B,
                   int Tcap, int K, int D, int layer, cudaStream_t stream) {
  const dim3 grid(K, B, 2);
  kv_append_kernel<T><<<grid, 32, 0, stream>>>(
      static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<int8_t*>(ck), static_cast<int8_t*>(cv),
      static_cast<float*>(ks), static_cast<float*>(vs),
      static_cast<const int*>(positions), B, Tcap, K, D, layer);
  return cudaGetLastError();
}

}  // namespace
}  // namespace symtorch

// C entry point (ctypes). k_new / v_new [B, K, D] in `dtype`, contiguous;
// caches [L, B, T, K, D] int8 and scale planes [L, B, K, T] float32,
// contiguous, written in place; positions [B] int32 on the device. Returns
// the cudaError_t of the launch.
extern "C" int kv_append_launch(int dtype, const void* k_new,
                                const void* v_new, void* k_cache,
                                void* v_cache, void* k_scale, void* v_scale,
                                const void* positions, int L, int B, int T,
                                int K, int D, int layer, void* stream) {
  using namespace symtorch;
  if (B <= 0 || T <= 0 || K <= 0 || D <= 0 || D > 32 * kMaxPerLane ||
      layer < 0 || layer >= L)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch<float>(k_new, v_new, k_cache, v_cache, k_scale, v_scale,
                         positions, B, T, K, D, layer, s);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(k_new, v_new, k_cache, v_cache, k_scale,
                                 v_scale, positions, B, T, K, D, layer, s);
  return cudaErrorInvalidValue;
}
