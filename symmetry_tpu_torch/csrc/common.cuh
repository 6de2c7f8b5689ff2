// Shared helpers for the package's CUDA kernels: dtype conversion (int8
// words to floats too) and vectorized row loads into float registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace symtorch {

// Large-but-finite mask value, as the JAX kernels use (-2**30): a fully
// masked row never produces inf - inf.
constexpr float kNegInf = -1073741824.0f;

// Kernel dtype codes (ops/kernels.py DTYPE_*).
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kInt8 = 2;

// 2^x in one instruction (relative error ~2^-22; 0 for very negative x).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One int8 value of a 32-bit word already XORed with 0x80808080, as a
// float, exactly: selector 0x7650 + i puts byte i, b + 128 for the value
// b, into the mantissa of 0x4B000000 (the float 2^23 + b + 128), and 2^23
// + 128 is subtracted. A permute and a subtraction, off the quarter-rate
// int-to-float path.
__device__ __forceinline__ float magic_f(uint32_t w, uint32_t sel) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, sel)) - 8388736.f;
}

// Load N consecutive elements starting at p into floats. The caller
// guarantees p is aligned to 4 elements when N % 4 == 0.
template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&o)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      o[i] = x.x; o[i + 1] = x.y; o[i + 2] = x.z; o[i + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = p[i];
  }
}

template <int N>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float (&o)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const uint2 u = *reinterpret_cast<const uint2*>(p + i);
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 b = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u.y));
      o[i] = a.x; o[i + 1] = a.y; o[i + 2] = b.x; o[i + 3] = b.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = __bfloat162float(p[i]);
  }
}

// Eight int8 values packed in a uint2 (little endian) into floats.
__device__ __forceinline__ void unpack8(const uint2 u, float (&o)[8]) {
  const char4 a = *reinterpret_cast<const char4*>(&u.x);
  const char4 b = *reinterpret_cast<const char4*>(&u.y);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

// One warp quantizes a row of hd elements (at most 32 * J) to int8 exactly
// as ops/quant.py quantize_kv does on the row upcast to float32: scale =
// max(max|x|, 1e-8) / 127, q = clip(rint(x / scale), -127, 127). rintf
// rounds half to even like torch.round and jnp.round, and the division is
// IEEE (no fast-math), so the payload is bit-equal to the plain version.
// The payload goes to dst[0, hd) unless dst is null, and to sm[0, sm_len)
// (zeros past hd) unless sm is null; returns the scale (every lane).
template <int J, typename T>
__device__ __forceinline__ float quant_row(const T* src, int hd, int lane,
                                           int8_t* dst, int8_t* sm,
                                           int sm_len) {
  float v[J];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int i = lane + 32 * j;
    v[j] = i < hd ? to_f(src[i]) : 0.f;
    amax = fmaxf(amax, fabsf(v[j]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = fmaxf(amax, 1e-8f) / 127.0f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int i = lane + 32 * j;
    const int8_t qv =
        i < hd ? static_cast<int8_t>(
                     fminf(fmaxf(rintf(v[j] / scale), -127.f), 127.f))
               : 0;
    if (dst != nullptr && i < hd) dst[i] = qv;
    if (sm != nullptr && i < sm_len) sm[i] = qv;
  }
  return scale;
}

}  // namespace symtorch
