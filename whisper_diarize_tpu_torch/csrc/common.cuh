// Shared helpers for the hand-written Hopper kernels of whisper_diarize_tpu_torch.
//
// Every C entry point in this directory has a plain C interface (loaded with
// ctypes by `kernels/__init__.py`), launches on the stream it is given,
// allocates nothing and returns cudaGetLastError() so a refused launch is
// reported to the Python wrapper, which raises.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

#define WDT_EXPORT extern "C" __attribute__((visibility("default")))
#define WDT_NEG_INF __int_as_float(0xff800000)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// round-trip through bf16: the value a bf16 store followed by a load gives
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// jax.nn.gelu's default (tanh approximation)
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(k0 * (x + 0.044715f * x * x * x)));
}

// K1 launcher (cross_attn.cu), shared by the fused decoder tail (tail.cu).
// q [B, Q, H, 64], k/v [L, B, H, Ta, 64] (layer picked by pointer offset),
// out [B, Q, H, 64]; all bf16, contiguous.
void launch_cross_attn(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                       int B, int Q, int H, int Ta, int layer, int ta_total,
                       cudaStream_t stream);

// K3's bf16 skinny GEMM (tail.cu), shared by the greedy decoder front
// (front.cu): out[N, Dout] = bf16(ln(A)[N, Din] @ W[Din, Dout] + bias) with
// a fused f32-statistics layer norm (ln_g, ln_b; nullptr: none). Needs
// Din % 64 == 0 and Dout % 64 == 0; all bf16, contiguous.
void launch_skinny_gemm(const bf16* A, const bf16* W, const bf16* bias,
                        const bf16* ln_g, const bf16* ln_b, bf16* out, int N,
                        int Din, int Dout, cudaStream_t stream);

// K5 launcher (cross_attn.cu), shared by the fused decoder tail (tail.cu)
// over the int8 cross cache. k8/v8 [L, B, H, Ta, 64] int8 and ks/vs
// [L, B, H, Ta] f32 (layer picked by pointer offset); q, out as for K1.
void launch_cross_attn_q8(const bf16* q, const int8_t* k8, const float* ks,
                          const int8_t* v8, const float* vs, bf16* out, int B,
                          int Q, int H, int Ta, int layer, int ta_total,
                          cudaStream_t stream);
