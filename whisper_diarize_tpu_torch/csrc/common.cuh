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

// Sum over the block, in a fixed order (the same result on every run);
// valid in thread 0. Once per kernel: its scratch is not reused.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float red[32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = 0.0f;
  if (warp == 0) v = warp_sum(lane < (int)(blockDim.x >> 5) ? red[lane] : 0.0f);
  return v;
}

// ---------------------------------------------------------------------------
// Tensor-core and shared-memory helpers (K1 / K5 cross_attn.cu, K9b)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// c += a * b on the tensor cores: m16n8k16, bf16 in, f32 accumulate.
// a: rows g / g + 8, k 2tg.. / 2tg + 8..; b: k 2tg.. / 2tg + 8.., column g;
// c[0..1] row g, columns 2tg, 2tg + 1; c[2..3] row g + 8 (g = lane / 4,
// tg = lane % 4)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four transposed 8x8 bf16 matrices from shared memory (row addresses from
// lanes 8i .. 8i+7 for matrix i)
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  bf162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// max / sum over the four lanes of a quad (the lanes that share a row of an
// mma fragment)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// cp.async: `bytes` (4, 8 or 16) from global to shared memory, bypassing the
// registers; `src_bytes` 0 fills the destination with zeros (src must still
// be a valid address)
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const int src_bytes = valid ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "n"(kBytes), "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// mbarriers (K11b's ring, K10's ring)
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// block until the barrier's phase of parity `parity` has completed; a phase
// that never completes (a fault of the pipeline) traps after 2^26 polls,
// so the launch fails with an error instead of holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  for (uint32_t n = 0; !mbar_try_wait(a, parity); ++n)
    if (n == (1u << 26)) __trap();
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// K1's shared-memory tile (cross_attn.cu): 64 keys of one (b, h) slab's K
// and V rows, each row padded to 72 bf16 (144 bytes: 16-byte aligned for
// cp.async, and the mma fragment reads of eight rows fall in distinct
// banks), K1_STAGES tiles in a ring in dynamic shared memory. K9b
// (stream_sum.cu) stages K1's bytes with the same helper so that it walks
// them exactly as K1 does.
constexpr int K1_DH = 64;
constexpr int K1_TK = 64;
constexpr int K1_KROW = K1_DH + 8;
constexpr int K1_THREADS = 128;
constexpr int K1_STAGES = 3;
constexpr int K1_TILE_ELEMS = K1_TK * K1_KROW;  // one of K or V, bf16

// Issue (not wait for) the cp.async copies of one 64-key tile: rows t0 ..
// t0 + 63 of K and V into kt / vt, 16 bytes a copy (8 a thread for each of
// K and V); keys >= t_end land as zeros. The caller commits the group.
__device__ __forceinline__ void k1_stage_tile_async(const bf16* kb, const bf16* vb,
                                                    bf16* kt, bf16* vt, int t0,
                                                    int t_end, int tid) {
#pragma unroll
  for (int i = tid; i < K1_TK * (K1_DH / 8); i += K1_THREADS) {
    const int row = i / (K1_DH / 8), c = i % (K1_DH / 8);
    const int key = t0 + row;
    const bool ok = key < t_end;
    const size_t off = ok ? (size_t)key * K1_DH + c * 8 : 0;
    cp_async<16>(kt + row * K1_KROW + c * 8, kb + off, ok);
    cp_async<16>(vt + row * K1_KROW + c * 8, vb + off, ok);
  }
}

// K1 launcher (cross_attn.cu), shared by the fused decoder tail (tail.cu).
// q [B, Q, H, 64], k/v [L, B, H, Ta, 64] (layer picked by pointer offset),
// out [B, Q, H, 64]; all bf16, contiguous.
// The keys split into n_span spans of span_keys (a multiple of 64) keys,
// one CTA of a thread-block cluster each (ops/attn.py::cross_attn_plan).
// Returns cudaErrorInvalidValue for a plan that does not cover
// [0, ta_total) with non-empty spans.
cudaError_t launch_cross_attn(const bf16* q, const bf16* k, const bf16* v,
                              bf16* out, int B, int Q, int H, int Ta, int layer,
                              int ta_total, int n_span, int span_keys,
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
cudaError_t launch_cross_attn_q8(const bf16* q, const int8_t* k8, const float* ks,
                                 const int8_t* v8, const float* vs, bf16* out,
                                 int B, int Q, int H, int Ta, int layer,
                                 int ta_total, int n_span, int span_keys,
                                 cudaStream_t stream);
