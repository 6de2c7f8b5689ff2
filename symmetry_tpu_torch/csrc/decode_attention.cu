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
//    gets finite zeros (kNegInf is finite: no inf - inf anywhere);
//  - a head dim that is a multiple of 8 but not a built size (16, 32, 64,
//    128, 256) runs at the next one: shared rows are padded, the copies
//    past the real head dim are zero-filled (cp.async's src-size), q is
//    zero there, and only the real columns are stored. int8 rows whose
//    length is not a multiple of 16 bytes are copied 8 bytes at a time;
//  - the step's own K/V row can be written by the same launch (append
//    mode: k_new, v_new [B, K, hd] and positions [B]), which also replaces
//    the Pallas TPU kernel symmetry_tpu/ops/kv_append.py `_kernel`
//    (pl.pallas_call at kv_append.py:151) on the serving path. A separate
//    launch for a 17 KB write costs a launch's fixed time, about a hundred
//    times its bytes; folded in here it adds no launch. The row goes to
//    p = min(max(pos, 0), T - 1). Every block whose span holds p builds the
//    row in shared memory before anything else -- for an int8 cache with
//    exactly csrc/kv_append.cu's arithmetic (quant_row) -- and the one
//    block of query-head chunk 0 among them stores it, payload and scale,
//    to the cache. That happens before the test for a span with no live
//    row, so a free slot whose stale length reached capacity, or whose
//    kv_length excludes p, still gets its row. No block reads row p from
//    device memory for its result: where a warp's chunk holds p, it
//    overwrites the copy it took of that row with the shared one before it
//    reads the chunk. So blocks of other chunks (groups of more than 8
//    query heads) never depend on the writer's store, and nothing depends
//    on the order of blocks.
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

// Per (cache type, built head dim D, copy width CB bytes): a lane reads 8
// elements of a row from shared memory, LPR lanes cover a row, RPW rows a
// warp pass, WR rows a stage, NP passes a stage.
template <typename TKV, int D, int CB>
struct Geo {
  static constexpr int ROW_BYTES = D * int(sizeof(TKV));
  static constexpr int LPR = D / 8;
  static constexpr int RPW = 32 / LPR;
  static constexpr int WR = STAGE_BYTES / ROW_BYTES > RPW
                                ? STAGE_BYTES / ROW_BYTES : RPW;
  static constexpr int NP = WR / RPW;
  static constexpr int CPR = ROW_BYTES / CB;  // copies a padded row
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

// 8 bytes global -> shared (.ca: the only cache mode for copies under 16
// bytes), zero-filled when !valid.
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

template <int CB>
__device__ __forceinline__ void cp_async_row(uint32_t dst, const void* src,
                                             bool valid) {
  if constexpr (CB == 16) cp_async16(dst, src, valid);
  else cp_async8(dst, src, valid);
}

// D: the built head dim (shared rows, registers); hd: the real one, the
// row length in device memory, at most D.
template <typename TQ, typename TKV, int D, int GT, int CB, bool kAppend>
__global__ void __launch_bounds__(NW * 32)
decode_split_kernel(const TQ* __restrict__ q, TKV* __restrict__ kc,
                    TKV* __restrict__ vc, float* __restrict__ ks,
                    float* __restrict__ vs,
                    const int* __restrict__ kv_length,
                    const TQ* __restrict__ k_new, const TQ* __restrict__ v_new,
                    const int* __restrict__ positions,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int B, int Tcap, int K, int G, int n_chunks, int layer,
                    int window, int span, int hd, float scale) {
  using Gm = Geo<TKV, D, CB>;
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  constexpr int LPR = Gm::LPR, RPW = Gm::RPW, WR = Gm::WR, NP = Gm::NP;
  constexpr int CPR = Gm::CPR, EPC = CB / int(sizeof(TKV));  // elems a copy
  extern __shared__ __align__(16) uint8_t ring[];
  __shared__ float sm_m[NW], sm_l[NW];
  __shared__ float sm_acc[NW][D];
  __shared__ __align__(16) TKV sm_new[2][D];  // append: the K and V rows
  __shared__ float sm_new_s[2];               // and their int8 scales

  const int kvh = blockIdx.x / n_chunks;
  const int g0 = (blockIdx.x % n_chunks) * GT;  // first query head served
  const int gcount = min(GT, G - g0);
  const int b = blockIdx.y;
  const int sp = blockIdx.z;
  const int len = min(max(kv_length[b], 0), Tcap);
  const int lo = window > 0 ? max(len - window, 0) : 0;
  const int a = max(sp * span, lo);            // this block's live rows
  const int e = min((sp + 1) * span, len);     // are [a, e)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const long long row = (long long)K * hd;  // elements per position
  const long long kvbase =
      ((long long)layer * B + b) * Tcap * row + (long long)kvh * hd;
  // Scale planes: [L, B, K, T], position minor.
  const long long sbase = (((long long)layer * B + b) * K + kvh) * Tcap;

  // Append: the row at p, if this block's span holds it (-1 otherwise).
  // Warp 0 builds the K row, warp 1 the V row; chunk 0 stores them. All
  // before the exit below: the write does not depend on the length.
  int p = -1;
  if constexpr (kAppend) {
    const int pos = min(max(positions[b], 0), Tcap - 1);
    if (pos >= sp * span && pos < (sp + 1) * span) {  // uniform
      p = pos;
      if (warp < 2) {
        const TQ* src =
            (warp ? v_new : k_new) + ((long long)b * K + kvh) * hd;
        const bool store = blockIdx.x % n_chunks == 0;
        TKV* dst = (warp ? vc : kc) + kvbase + (long long)p * row;
        if constexpr (kQuant) {
          const float s = quant_row<(D + 31) / 32>(
              src, hd, lane, store ? dst : nullptr, sm_new[warp], D);
          if (lane == 0) {
            sm_new_s[warp] = s;
            if (store) (warp ? vs : ks)[sbase + p] = s;
          }
        } else {
          static_assert(std::is_same<TQ, TKV>::value, "cache is q's dtype");
          for (int i = lane; i < D; i += 32) {
            const TKV x = i < hd ? src[i] : from_f<TKV>(0.f);
            sm_new[warp][i] = x;
            if (store && i < hd) dst[i] = x;
          }
        }
      }
      __syncthreads();
    }
  }
  if (a >= e) return;
  const int rr = lane / LPR;         // row within a pass
  const int e0 = (lane % LPR) * 8;   // first element this lane reads

  // This chunk's query heads, the lane's 8 elements, pre-scaled into the
  // log2 domain; heads past G and elements past hd stay zero.
  const int nq = K * G;
  const long long head0 = (long long)b * nq + (long long)kvh * G + g0;
  float qr[GT][8];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (g < gcount && e0 < hd) {
      load_row<8>(q + (head0 + g) * hd + e0, qr[g]);
#pragma unroll
      for (int x = 0; x < 8; ++x) qr[g][x] *= scale * kLog2e;
    } else {
#pragma unroll
      for (int x = 0; x < 8; ++x) qr[g][x] = 0.f;
    }
  }

  const TKV* kb = kc + kvbase;
  const TKV* vb = vc + kvbase;

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
      const bool ok = t0 + r < e && c * EPC < hd;
      const long long src = (ok ? t0 + r : a) * row + (ok ? c * EPC : 0);
      cp_async_row<CB>(smem_u32(st + r * Gm::ROW_BYTES + c * CB), kb + src,
                       ok);
      cp_async_row<CB>(
          smem_u32(st + Gm::KV_BYTES + r * Gm::ROW_BYTES + c * CB), vb + src,
          ok);
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

    uint8_t* st = wring + (i % STAGES) * Gm::STAGE;
    const int t0 = a + (warp + i * NW) * WR;
    if (kAppend && p >= t0 && p < min(t0 + WR, e)) {  // warp-uniform
      // Append: this chunk holds row p; take it from shared memory, not
      // from the copy of device memory.
      const int r = p - t0;
      const uint32_t* nk = reinterpret_cast<const uint32_t*>(sm_new[0]);
      const uint32_t* nv = reinterpret_cast<const uint32_t*>(sm_new[1]);
      uint32_t* dk = reinterpret_cast<uint32_t*>(st + r * Gm::ROW_BYTES);
      uint32_t* dv =
          reinterpret_cast<uint32_t*>(st + Gm::KV_BYTES + r * Gm::ROW_BYTES);
      for (int x = lane; x < Gm::ROW_BYTES / 4; x += 32) {
        dk[x] = nk[x];
        dv[x] = nv[x];
      }
      if constexpr (kQuant) {
        if (lane == 0) {
          float* sc = reinterpret_cast<float*>(st + 2 * Gm::KV_BYTES);
          sc[r] = sm_new_s[0];
          sc[WR + r] = sm_new_s[1];
        }
      }
      __syncwarp();
    }
    const TKV* sk = reinterpret_cast<const TKV*>(st);
    const TKV* sv = reinterpret_cast<const TKV*>(st + Gm::KV_BYTES);
    const float* sks = reinterpret_cast<const float*>(st + 2 * Gm::KV_BYTES);

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
    for (int d = threadIdx.x; d < hd; d += NW * 32) {
      float num = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) num += sm_acc[w][d] * ex2(sm_m[w] - mx);
      part_acc[slot * hd + d] = num;
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

// One block per (slot, query head): merge the spans that held live rows;
// D is the real head dim.
template <typename TQ>
__global__ void __launch_bounds__(128)
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_ml,
                      const int* __restrict__ kv_length, TQ* __restrict__ out,
                      int nq, int Tcap, int window, int span, int n_spans,
                      int D) {
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
  void* kc;
  void* vc;
  void* ks;
  void* vs;
  const void* kv_length;
  const void* k_new;  // append mode: all three, or none
  const void* v_new;
  const void* positions;
  void* out;
  float* part_acc;
  float* part_ml;
  int B, Tcap, K, G, layer, window, span, n_spans, hd;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int D, int GT, int CB, bool kAppend>
cudaError_t launch(const Args& a) {
  auto kernel = decode_split_kernel<TQ, TKV, D, GT, CB, kAppend>;
  const int smem = NW * STAGES * Geo<TKV, D, CB>::STAGE;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_chunks = (a.G + GT - 1) / GT;
  const dim3 grid(a.K * n_chunks, a.B, a.n_spans);
  kernel<<<grid, NW * 32, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<TKV*>(a.kc),
      static_cast<TKV*>(a.vc), static_cast<float*>(a.ks),
      static_cast<float*>(a.vs), static_cast<const int*>(a.kv_length),
      static_cast<const TQ*>(a.k_new), static_cast<const TQ*>(a.v_new),
      static_cast<const int*>(a.positions), a.part_acc, a.part_ml, a.B, a.Tcap, a.K, a.G, n_chunks, a.layer,
      a.window, a.span, a.hd, 1.0f / sqrtf((float)a.hd));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<TQ><<<a.B * a.K * a.G, 128, 0, a.stream>>>(
      a.part_acc, a.part_ml, static_cast<const int*>(a.kv_length),
      static_cast<TQ*>(a.out), a.K * a.G, a.Tcap, a.window, a.span,
      a.n_spans, a.hd);
  return cudaGetLastError();
}

// Append mode is its own kernel: compiled into one kernel with a runtime
// test, both modes ran 6-21% slower than before the write moved in (H100,
// llama3-8b widths); compiled apart, neither does.
template <typename TQ, typename TKV, int D, int GT, int CB>
cudaError_t launch_a(const Args& a) {
  return a.positions != nullptr ? launch<TQ, TKV, D, GT, CB, true>(a)
                                : launch<TQ, TKV, D, GT, CB, false>(a);
}

// The smallest register tile that holds the group, at most 8 heads.
template <typename TQ, typename TKV, int D, int CB>
cudaError_t launch_g(const Args& a) {
  if (a.G <= 1) return launch_a<TQ, TKV, D, 1, CB>(a);
  if (a.G <= 2) return launch_a<TQ, TKV, D, 2, CB>(a);
  if (a.G <= 4) return launch_a<TQ, TKV, D, 4, CB>(a);
  return launch_a<TQ, TKV, D, 8, CB>(a);
}

// Rows of 16-byte multiples take 16-byte copies; int8 rows of 8 (mod 16)
// bytes take 8-byte ones (their rows are only 8-byte aligned).
template <typename TQ, typename TKV, int D>
cudaError_t launch_c(const Args& a) {
  if ((a.hd * int(sizeof(TKV))) % 16 == 0) return launch_g<TQ, TKV, D, 16>(a);
  if constexpr (std::is_same<TKV, int8_t>::value)
    return launch_g<TQ, TKV, D, 8>(a);
  return cudaErrorInvalidValue;
}

// The next built head dim at or above the real one (a multiple of 8).
template <typename TQ, typename TKV>
cudaError_t launch_d(const Args& a) {
  const int hd = a.hd;
  if (hd < 16 || hd > 256 || hd % 8) return cudaErrorInvalidValue;
  if (hd <= 16) return launch_c<TQ, TKV, 16>(a);
  if (hd <= 32) return launch_c<TQ, TKV, 32>(a);
  if (hd <= 64) return launch_c<TQ, TKV, 64>(a);
  if (hd <= 128) return launch_c<TQ, TKV, 128>(a);
  return launch_c<TQ, TKV, 256>(a);
}

}  // namespace
}  // namespace symtorch

// C entry point (ctypes). q [B, n_q, D] and out [B, n_q, D] in `dtype`,
// D any multiple of 8 from 16 to 256;
// caches [L, B, T, K, D] in `kv_dtype` (== dtype, or int8 with k_scale /
// v_scale [L, B, K, T] float32), all contiguous; kv_length [B] int32 on the
// device. Append mode: k_new / v_new [B, K, D] in `dtype` and positions [B]
// int32, contiguous, the rows written into the caches (and scales) at
// (layer, slot, min(max(pos, 0), T - 1)) before they are read; all three
// null otherwise. window <= 0 means no window. The capacity T is split into
// n_spans spans of `span` positions (n_spans = ceil(T / span)); `scratch`
// holds B * n_q * n_spans * (D + 2) float32 for the spans' partials.
// Launches the split kernel and the combine kernel; returns the first
// cudaError_t.
extern "C" int decode_attention_launch(int dtype, int kv_dtype, const void* q,
                                       void* k_cache, void* v_cache,
                                       void* k_scale, void* v_scale,
                                       const void* kv_length,
                                       const void* k_new, const void* v_new,
                                       const void* positions, void* out,
                                       void* scratch, int L, int B, int T,
                                       int K, int D, int n_q, int layer,
                                       int window, int span, int n_spans,
                                       void* stream) {
  using namespace symtorch;
  if (B <= 0 || T <= 0 || K <= 0 || n_q <= 0 || n_q % K || layer < 0 ||
      layer >= L || span <= 0 || n_spans <= 0 ||
      (long long)n_spans * span < T || (long long)(n_spans - 1) * span >= T ||
      (k_new == nullptr) != (v_new == nullptr) ||
      (k_new == nullptr) != (positions == nullptr))
    return cudaErrorInvalidValue;
  float* part_acc = static_cast<float*>(scratch);
  float* part_ml = part_acc + (long long)B * n_q * n_spans * D;
  const Args a{q, k_cache, v_cache, k_scale, v_scale, kv_length, k_new,
               v_new, positions, out, part_acc, part_ml, B, T, K, n_q / K,
               layer, window, span, n_spans, D,
               static_cast<cudaStream_t>(stream)};
  if (kv_dtype == kInt8) {
    if (k_scale == nullptr || v_scale == nullptr) return cudaErrorInvalidValue;
    if (dtype == kF32) return launch_d<float, int8_t>(a);
    if (dtype == kBF16) return launch_d<__nv_bfloat16, int8_t>(a);
    return cudaErrorInvalidValue;
  }
  if (kv_dtype != dtype) return cudaErrorInvalidValue;
  if (dtype == kF32) return launch_d<float, float>(a);
  if (dtype == kBF16) return launch_d<__nv_bfloat16, __nv_bfloat16>(a);
  return cudaErrorInvalidValue;
}
