// Shared helpers for the hand-written Hopper kernels of whisper_diarize_tpu_torch.
//
// Every C entry point in this directory has a plain C interface (loaded with
// ctypes by `kernels/__init__.py`), launches on the stream it is given,
// allocates nothing and returns cudaGetLastError() so a refused launch is
// reported to the Python wrapper, which raises.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
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
// Activations in bf16 or f32 (the f32 forms of K1 - K6): overloads picked by
// a typed null pointer (`static_cast<const T*>(nullptr)`) or the pointer
// itself
// ---------------------------------------------------------------------------

// x rounded to the activation type and back: a bf16 store and load, or x
__device__ __forceinline__ float round_to(float x, const bf16*) { return bf16_round(x); }
__device__ __forceinline__ float round_to(float x, const float*) { return x; }

__device__ __forceinline__ float load_f(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ void store_f(bf16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }

// two adjacent values (4- or 8-byte aligned) as f32, and stored from f32
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const bf162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<bf162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// a 16-byte chunk (8 bf16 or 4 f32) as f32 values, and back (bf16: each
// pair rounded by __floats2bfloat162_rn)
__device__ __forceinline__ void chunk_floats(const uint4& raw, float* f, const bf16*) {
  const bf162* x = reinterpret_cast<const bf162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 v = __bfloat1622float2(x[j]);
    f[2 * j] = v.x;
    f[2 * j + 1] = v.y;
  }
}
__device__ __forceinline__ void chunk_floats(const uint4& raw, float* f, const float*) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ uint4 floats_chunk(const float* f, const bf16*) {
  uint4 raw;
  bf162* x = reinterpret_cast<bf162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
  return raw;
}
__device__ __forceinline__ uint4 floats_chunk(const float* f, const float*) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
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

// four 8x8 bf16 matrices from shared memory, not transposed (row addresses
// from lanes 8i .. 8i+7 for matrix i)
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

// ---------------------------------------------------------------------------
// 3xTF32 products on the tensor cores (the f32 forms of K1, cross_attn.cu:
// mma.sync, and K10, encoder_attn.cu: wgmma). Each f32 operand x splits
// into hi = tf32(x) and lo = tf32(x - hi) (x - hi is exact in f32); a
// product is lo hi' + hi lo' + hi hi', summed into one f32 accumulator, and
// lo lo' (~2^-22 of it) is dropped: about f32's accuracy at TF32's rate
// (`kernels/agreement.py::tf32x3_split` is the same split on the CPU).
// ---------------------------------------------------------------------------

// x rounded to TF32 (10 explicit mantissa bits, ties away from zero, as
// cvt.rna.tf32.f32 and agreement.tf32_round round): the bits a TF32
// product reads
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

// c += a * b on the tensor cores: m16n8k8, TF32 in, f32 accumulate (K1-f32,
// the skinny GEMM of tail.cu at f32).
// a: rows g (a[0], a[2]) / g + 8 (a[1], a[3]), k tg (a[0], a[1]) / tg + 4
// (a[2], a[3]); b0: k tg, b1: k tg + 4, column g; c as mma_bf16's
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b in 3xTF32: the two small terms first, then hi hi'
__device__ __forceinline__ void mma_tf32x3(float* c, const uint32_t* a_hi, const uint32_t* a_lo,
                                           uint32_t bh0, uint32_t bh1, uint32_t bl0,
                                           uint32_t bl1) {
  mma_tf32(c, a_lo, bh0, bh1);
  mma_tf32(c, a_hi, bl0, bl1);
  mma_tf32(c, a_hi, bh0, bh1);
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

// ---------------------------------------------------------------------------
// Hopper: TMA, wgmma, bulk copies (K10 encoder_attn.cu, K2 cross_kv.cu, the
// skinny GEMM of tail.cu)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void fence_view_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N of this warpgroup's committed product groups are in
// flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving reads or writes of the accumulator across
// the asynchronous product (the asm above does not name the registers)
template <int N = 32>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle: start address >> 4,
// leading byte offset (K-major: unused, a 64-element row is one swizzle
// atom; MN-major: the step between 64-element atoms along M / N), stride
// byte offset 1024 B (eight 128-byte rows) >> 4, layout B128
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lead_bytes = 16) {
  return (uint64_t)((smem_u32(p) >> 4) & 0x3FFF) | ((uint64_t)((lead_bytes >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D (+)= A B on the tensor cores, one warpgroup: m64n64k16, bf16 in, f32
// accumulate; A and B from shared memory through their descriptors, both
// K-major. d: the m64n64 accumulator (n8 block j: d[4j..4j+1] row g,
// d[4j+2..4j+3] row g + 8 of the warp's 16 rows, columns 8j + 2tg, + 1).
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D += A B with A (an m16n8k16 A fragment a warp, rows 16w..16w+15) from
// registers and B from shared memory, MN-major (trans-b 1).
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (+)= A B, one warpgroup: m64n128k16, bf16 in, f32 accumulate; A from
// shared memory K-major, B from shared memory MN-major (trans-b 1: two
// 64-column atoms, the descriptor's leading byte offset apart). d: the
// m64n128 accumulator, laid out as wgmma_ss's over sixteen n8 blocks.
__device__ __forceinline__ void wgmma_ss_n128_tb(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (+)= A B, one warpgroup: m64n64k16, bf16 in, f32 accumulate; A from
// shared memory K-major, B from shared memory MN-major (trans-b 1: one
// 64-column atom). d: the m64n64 accumulator, laid out as wgmma_ss's (K2's
// 64-column edge tile).
__device__ __forceinline__ void wgmma_ss_n64_tb(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (+)= A B, one warpgroup: m64n64k8, TF32 in, f32 accumulate (K10-f32's
// 3xTF32 products); A and B from shared memory through their descriptors,
// both K-major (TF32 has no transposed form); d laid out as wgmma_ss's.
__device__ __forceinline__ void wgmma_tf32_ss(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (+)= A B with A from registers (a warp's rows 16w .. 16w + 15 of the
// m64k8 tile, as the m16n8k8 TF32 A fragment: a[0] row g, k tg; a[1] row
// g + 8, k tg; a[2] row g, k tg + 4; a[3] row g + 8, k tg + 4) and B from
// shared memory, K-major.
__device__ __forceinline__ void wgmma_tf32_rs(float* d, const uint32_t* a, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (+)= A B with A from registers (as wgmma_tf32_rs's) and B from shared
// memory, K-major: m64n128k8, TF32 in, f32 accumulate (K2-f32's 3xTF32
// products); d laid out as wgmma_ss_n128_tb's.
__device__ __forceinline__ void wgmma_tf32_rs_n128(float* d, const uint32_t* a, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// keep N registers (an A operand of wgmma ..._rs) live up to this point: the
// asynchronous product reads them after its asm statement has issued, so
// their registers must not be reused before the wgmma_wait that retires it
template <int N>
__device__ __forceinline__ void keep_regs(const uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" :: "r"(r[i]));
}

// one 64-row box of a [B, H, T, 64] tensor into shared memory; the map's
// dimensions are (d, then T / H / B in the order `pos` gives)
__device__ __forceinline__ void tma_rows(void* dst, const CUtensorMap* map, int4 pos,
                                         int t, int h, int b, uint64_t* bar) {
  int c[4] = {0, 0, 0, 0};
  c[pos.x] = t;
  c[pos.y] = h;
  c[pos.z] = b;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c[0]), "r"(c[1]),
         "r"(c[2]), "r"(c[3]), "r"(smem_u32(bar))
      : "memory");
}

// one box of a 3-d tensor map at (c0, c1, c2) into shared memory, completing
// on `bar`; elements outside the tensor land as zeros
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(smem_u32(bar))
      : "memory");
}

// one box from shared memory into a 3-d tensor map at (c0, c1, c2); elements
// outside the tensor are not written. Completes with bulk_commit / bulk_wait.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %2, %3}], [%4];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(src))
      : "memory");
}

// `bytes` (a multiple of 16) from global to shared memory as one bulk copy,
// completing on `bar` (16-byte aligned addresses)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's bulk stores: all but N have read their shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

// this thread's bulk stores: all but N have completed
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" :: "n"(N) : "memory");
}

// cuTensorMapEncodeTiled, looked up through cudaGetDriverEntryPoint (the
// library links no libcuda); nullptr where it is not found.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res) !=
            cudaSuccess ||
        res != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a 3-d bf16 (or `type`) tensor map: dims (innermost first), the byte
// strides of dims 1 and 2, a box of box[0] x box[1] x 1 elements with the
// 128-byte swizzle (box[0] x the element size = 128: one 128-byte row);
// out-of-bounds elements read as zeros
inline bool make_map_3d(CUtensorMap* map, const void* ptr, const cuuint64_t* dims,
                        const cuuint64_t* strides, const cuuint32_t* box,
                        CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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

// K5 launcher (cross_attn.cu), shared by the fused decoder tail (tail.cu)
// over the int8 cross cache. k8/v8 [L, B, H, Ta, 64] int8 and ks/vs
// [L, B, H, Ta] f32 (layer picked by pointer offset); q, out as for K1.
cudaError_t launch_cross_attn_q8(const bf16* q, const int8_t* k8, const float* ks,
                                 const int8_t* v8, const float* vs, bf16* out,
                                 int B, int Q, int H, int Ta, int layer,
                                 int ta_total, int n_span, int span_keys,
                                 cudaStream_t stream);

// K1's and K5's f32 forms (cross_attn.cu), for the fused tail at f32: q,
// out f32; k / v f32 (K1: 3xTF32 products) or int8 with f32 scales (K5: its
// bf16 products, q and out in f32); the plan as above.
cudaError_t launch_cross_attn_f32(const float* q, const float* k, const float* v,
                                  float* out, int B, int Q, int H, int Ta, int layer,
                                  int ta_total, int n_span, int span_keys,
                                  cudaStream_t stream);
cudaError_t launch_cross_attn_q8_f32(const float* q, const int8_t* k8, const float* ks,
                                     const int8_t* v8, const float* vs, float* out,
                                     int B, int Q, int H, int Ta, int layer,
                                     int ta_total, int n_span, int span_keys,
                                     cudaStream_t stream);

// The split of one weight-streaming skinny GEMM (tail.cu), as
// ops/tail.py::skinny_plan gives it: column strips of `bn` (32 or 64)
// columns, each cut along the input dimension into n_split spans of span_k
// rows (a multiple of 64), one CTA of a thread-block cluster each, with a
// copy ring of `stages` (3 - 8) tiles.
struct SkinnyPlan {
  int bn, n_split, span_k, stages;
};

// K3's bf16 skinny GEMM (tail.cu), shared by the greedy decoder front
// (front.cu): out[N, Dout] = bf16(ln(A)[N, Din] @ W[Din, Dout] + bias) with
// a fused f32-statistics layer norm (ln_g, ln_b; nullptr: none), on the
// split `plan`. Needs Din % 64 == 0 and Dout % bn == 0; all bf16,
// contiguous. Returns cudaErrorInvalidValue for a plan that does not cover
// the input dimension or does not fit.
cudaError_t launch_skinny_gemm(const bf16* A, const bf16* W, const bf16* bias,
                               const bf16* ln_g, const bf16* ln_b, bf16* out, int N,
                               int Din, int Dout, SkinnyPlan plan, cudaStream_t stream);

// Its f32 form (K8's f32 product): every operand f32, 3xTF32 products on
// the tensor cores; the plan of ops/tail.py::skinny_plan with f32=True.
cudaError_t launch_skinny_gemm(const float* A, const float* W, const float* bias,
                               const float* ln_g, const float* ln_b, float* out, int N,
                               int Din, int Dout, SkinnyPlan plan, cudaStream_t stream);
