// K3 and K6: one decoder layer's tail for a single-token sampling step.
//
// K3 replaces whisper_diarize_tpu/ops/pallas_tail.py::fused_tail_layer
// (_tail_kernel, bf16 variant):
//   x1 = x  + bf16(self_out @ o_w + o_b)
//   cq = bf16(ln2(x1) @ cq_w + cq_b)
//   a  = cross_attention(cq, K[l], V[l])                (K1's kernel)
//   x2 = x1 + bf16(a @ co_w + co_b)
//   h  = bf16(gelu(ln3(x2) @ fc1_w + fc1_b))
//   y  = x2 + bf16(h @ fc2_w + fc2_b)
// Layer norms use f32 statistics (biased variance, eps 1e-5); every product
// accumulates in f32 and is rounded to bf16 once, as in the TPU kernel.
//
// K6 is the same tail in the TPU kernel's int8 forms (`wq` / `kvq`, each
// independent of the other). `wq`: the five weights are int8, widened to
// bf16 while staged (exact); o / cq / co / fc1 carry one f32 scale per
// output column, which multiplies the f32 accumulator before the bias; fc2
// carries one per input row, applied to the activations in the prologue as
// bf16(f32(h) * ws[row]) (pallas_tail.py:285-294, :403-414). `kvq`: the
// cross cache is int8 with per-position scales and the attention launches
// K5's kernel (`_flash_kernel_q8` numerics, pallas_tail.py:341-356).
//
// What bounds it on the H100: bytes. At N = batch x best_of rows (8..80) each
// projection streams its [Din, Dout] weight once for a few dozen rows
// (~18 MB of bf16 tail weights per layer on turbo, half that in int8), plus
// the layer's cross K/V in the attention. Design: one CTA cannot
// synchronise the grid, so the tail is a fixed sequence of six launches on
// one stream, issued from one C call: five launches of a weight-streaming
// skinny GEMM (16 rows x 64 columns per CTA on bf16 tensor-core MMA, with a
// fused layernorm / row-scale prologue and a fused column-scale / bias /
// GELU / residual epilogue, so no normalised or pre-activation tensor is
// written to device memory) and K1's (or K5's) flash attention. The stacked
// [L, Din, Dout] weights are read in place: a layer is a pointer offset.
// A persistent single-kernel tail is later work.
#include "common.cuh"

#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int BM = 16, BN = 64, BK = 64;
constexpr int ROW = BK + 8;   // staged bf16 row (144 B)
constexpr int CROW = BN + 4;  // f32 staging row
constexpr int THREADS = 128;  // 4 warps, one 16 x 16 output tile each

// 8 weights from global memory -> 8 bf16 in shared memory (16 bytes)
__device__ __forceinline__ void stage8(const bf16* src, bf16* dst) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}

// 8 int8 weights -> 8 bf16 (exact); src 8-byte, dst 16-byte aligned
__device__ __forceinline__ void stage8(const int8_t* src, bf16* dst) {
  const uint2 raw = *reinterpret_cast<const uint2*>(src);
  const int8_t* b8 = reinterpret_cast<const int8_t*>(&raw);
  uint4 res;
  bf162* o2 = reinterpret_cast<bf162*>(&res);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    o2[e] = __floats2bfloat162_rn(static_cast<float>(b8[2 * e]),
                                  static_cast<float>(b8[2 * e + 1]));
  *reinterpret_cast<uint4*>(dst) = res;
}

// out[N, Dout] = epi(pro(A)[N, Din] @ W[Din, Dout]); W is bf16 or int8
//   pro: ln_g != nullptr -> bf16((a - mean) * rstd * g + b), f32 statistics;
//        row_scale != nullptr -> bf16(f32(a) * row_scale[k]) (per input row)
//   epi: y = acc (* col_scale[col]) + bias; gelu -> gelu_tanh(y); o = bf16(y);
//        residual != nullptr -> o = bf16(residual + o)
template <typename WT>
__global__ void __launch_bounds__(THREADS)
skinny_gemm_kernel(const bf16* __restrict__ A, const WT* __restrict__ W,
                   const float* __restrict__ col_scale,
                   const float* __restrict__ row_scale,
                   const bf16* __restrict__ bias,
                   const bf16* __restrict__ residual,
                   const bf16* __restrict__ ln_g, const bf16* __restrict__ ln_b,
                   bf16* __restrict__ out, int N, int Din, int Dout, int gelu) {
  __shared__ __align__(128) bf16 As[BM][ROW];
  __shared__ __align__(128) bf16 Ws[BK][ROW];
  __shared__ __align__(128) float Cs[BM][CROW];
  __shared__ float mean_s[BM], rstd_s[BM];

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  if (ln_g != nullptr) {
    // two-pass f32 statistics per row (jnp.mean / jnp.var semantics)
    for (int r = warp; r < BM; r += THREADS / 32) {
      const int row = m0 + r;
      float mu = 0.0f, rs = 0.0f;
      if (row < N) {
        const bf16* a = A + (size_t)row * Din;
        float s = 0.0f;
        for (int k = lane; k < Din; k += 32) s += __bfloat162float(a[k]);
        mu = warp_sum(s) / Din;
        float v = 0.0f;
        for (int k = lane; k < Din; k += 32) {
          const float d = __bfloat162float(a[k]) - mu;
          v = fmaf(d, d, v);
        }
        rs = rsqrtf(warp_sum(v) / Din + 1e-5f);
      }
      if (lane == 0) {
        mean_s[r] = mu;
        rstd_s[r] = rs;
      }
    }
    __syncthreads();
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.0f);
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  for (int k0 = 0; k0 < Din; k0 += BK) {
    {  // activations: 16 x 64 = 128 vectors, one per thread
      const int r = tid / (BK / 8), c8 = tid % (BK / 8);
      const int row = m0 + r;
      uint4 val = zero4;
      if (row < N) {
        val = *reinterpret_cast<const uint4*>(A + (size_t)row * Din + k0 + c8 * 8);
        if (ln_g != nullptr) {
          const uint4 g4 = *reinterpret_cast<const uint4*>(ln_g + k0 + c8 * 8);
          const uint4 b4 = *reinterpret_cast<const uint4*>(ln_b + k0 + c8 * 8);
          const bf162* x2 = reinterpret_cast<const bf162*>(&val);
          const bf162* g2 = reinterpret_cast<const bf162*>(&g4);
          const bf162* b2 = reinterpret_cast<const bf162*>(&b4);
          uint4 res;
          bf162* o2 = reinterpret_cast<bf162*>(&res);
          const float mu = mean_s[r], rs = rstd_s[r];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 xf = __bfloat1622float2(x2[e]);
            const float2 gf = __bfloat1622float2(g2[e]);
            const float2 bf = __bfloat1622float2(b2[e]);
            o2[e] = __floats2bfloat162_rn((xf.x - mu) * rs * gf.x + bf.x,
                                          (xf.y - mu) * rs * gf.y + bf.y);
          }
          val = res;
        }
        if (row_scale != nullptr) {
          const float* rs = row_scale + k0 + c8 * 8;
          bf162* x2 = reinterpret_cast<bf162*>(&val);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 xf = __bfloat1622float2(x2[e]);
            x2[e] = __floats2bfloat162_rn(xf.x * rs[2 * e], xf.y * rs[2 * e + 1]);
          }
        }
      }
      *reinterpret_cast<uint4*>(&As[r][c8 * 8]) = val;
    }
    // weights: 64 x 64 = 512 vectors of 8, four per thread
    for (int i = tid; i < BK * BN / 8; i += THREADS) {
      const int r = i / (BN / 8), c8 = i % (BN / 8);
      stage8(W + (size_t)(k0 + r) * Dout + n0 + c8 * 8, &Ws[r][c8 * 8]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, &As[0][kk], ROW);
      wmma::load_matrix_sync(b, &Ws[kk][warp * 16], ROW);
      wmma::mma_sync(acc, a, b, acc);
    }
    __syncthreads();
  }

  wmma::store_matrix_sync(&Cs[0][warp * 16], acc, CROW, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    const int row = m0 + r;
    if (row >= N) continue;
    const int col = n0 + c;
    float y = Cs[r][c];
    if (col_scale != nullptr) y *= col_scale[col];
    y += __bfloat162float(bias[col]);
    if (gelu) y = gelu_tanh(y);
    y = bf16_round(y);
    const size_t o = (size_t)row * Dout + col;
    if (residual != nullptr) y = __bfloat162float(residual[o]) + y;
    out[o] = __float2bfloat16(y);
  }
}

template <typename WT>
void skinny_gemm(const bf16* A, const WT* W, const float* col_scale,
                 const float* row_scale, const bf16* bias,
                 const bf16* residual, const bf16* ln_g, const bf16* ln_b,
                 bf16* out, int N, int Din, int Dout, int gelu,
                 cudaStream_t stream) {
  dim3 grid(Dout / BN, (N + BM - 1) / BM);
  skinny_gemm_kernel<WT><<<grid, THREADS, 0, stream>>>(
      A, W, col_scale, row_scale, bias, residual, ln_g, ln_b, out, N, Din,
      Dout, gelu);
}

// The five projections of one layer's tail, over bf16 or int8 weights.
// Scales (int8 only): o_ws, cq_ws, co_ws, fc1_ws [L, Dout] per output
// column, fc2_ws [L, 4D] per input row; layer picked by pointer offset.
template <typename WT>
void tail_layer(const bf16* x, const bf16* self_out, const WT* o_w,
                const WT* cq_w, const WT* co_w, const WT* fc1_w,
                const WT* fc2_w, const float* o_ws, const float* cq_ws,
                const float* co_ws, const float* fc1_ws, const float* fc2_ws,
                const bf16* o_b, const bf16* ln2_g, const bf16* ln2_b,
                const bf16* cq_b, const bf16* co_b, const bf16* ln3_g,
                const bf16* ln3_b, const bf16* fc1_b, const bf16* fc2_b,
                const void* k, const void* v, const float* ks, const float* vs,
                bf16* x1, bf16* cq, bf16* att, bf16* x2, bf16* h4, bf16* out,
                int layer, int N, int D, int H, int Bc, int beams, int Ta,
                int ta_total, cudaStream_t stream) {
  const size_t l = static_cast<size_t>(layer);
  const size_t dd = static_cast<size_t>(D) * D;
  const size_t d4 = static_cast<size_t>(D) * 4 * D;
  const size_t d = static_cast<size_t>(D);
  auto S = [l](const float* p, size_t n) { return p ? p + l * n : nullptr; };

  skinny_gemm(self_out, o_w + l * dd, S(o_ws, d), nullptr, o_b + l * d, x,
              nullptr, nullptr, x1, N, D, D, 0, stream);
  skinny_gemm(x1, cq_w + l * dd, S(cq_ws, d), nullptr, cq_b + l * d, nullptr,
              ln2_g + l * d, ln2_b + l * d, cq, N, D, D, 0, stream);
  if (ks != nullptr) {
    launch_cross_attn_q8(cq, static_cast<const int8_t*>(k), ks,
                         static_cast<const int8_t*>(v), vs, att, Bc, beams, H,
                         Ta, layer, ta_total, stream);
  } else {
    launch_cross_attn(cq, static_cast<const bf16*>(k),
                      static_cast<const bf16*>(v), att, Bc, beams, H, Ta,
                      layer, ta_total, stream);
  }
  skinny_gemm(att, co_w + l * dd, S(co_ws, d), nullptr, co_b + l * d, x1,
              nullptr, nullptr, x2, N, D, D, 0, stream);
  skinny_gemm(x2, fc1_w + l * d4, S(fc1_ws, 4 * d), nullptr, fc1_b + l * 4 * d,
              nullptr, ln3_g + l * d, ln3_b + l * d, h4, N, D, 4 * D, 1,
              stream);
  skinny_gemm(h4, fc2_w + l * d4, nullptr, S(fc2_ws, 4 * d), fc2_b + l * d,
              x2, nullptr, nullptr, out, N, 4 * D, D, 0, stream);
}

}  // namespace

// x, self_out [N, D] (self_out is [N, H, 1, Dh] viewed flat); the stacked
// decoder weights [L, ...] are passed at layer 0 and offset by `layer` here;
// k, v [L, Bc, H, Ta, 64] with N = Bc * beams; x1, cq, att, x2 [N, D] and
// h4 [N, 4D] are scratch; out [N, D]. Needs D % 64 == 0 (the wrapper checks).
// K6's forms: o_ws != nullptr -> the five weights are int8 with the scales
// o_ws, cq_ws, co_ws, fc1_ws (per output column) and fc2_ws (per input row);
// ks != nullptr -> k, v are int8 with per-position scales ks, vs
// [L, Bc, H, Ta]. Null scales: bf16 (K3).
WDT_EXPORT int wdt_fused_tail(
    const void* x, const void* self_out, const void* o_w, const void* o_b,
    const void* ln2_g, const void* ln2_b, const void* cq_w, const void* cq_b,
    const void* co_w, const void* co_b, const void* ln3_g, const void* ln3_b,
    const void* fc1_w, const void* fc1_b, const void* fc2_w, const void* fc2_b,
    const void* k, const void* v, void* x1, void* cq, void* att, void* x2,
    void* h4, void* out, const void* o_ws, const void* cq_ws,
    const void* co_ws, const void* fc1_ws, const void* fc2_ws, const void* ks,
    const void* vs, int layer, int N, int D, int H, int Bc, int beams, int Ta,
    int ta_total, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  auto P = [](const void* p) { return static_cast<const bf16*>(p); };
  auto F = [](const void* p) { return static_cast<const float*>(p); };
  auto O = [](void* p) { return static_cast<bf16*>(p); };
  if (o_ws != nullptr) {
    auto Q = [](const void* p) { return static_cast<const int8_t*>(p); };
    tail_layer(P(x), P(self_out), Q(o_w), Q(cq_w), Q(co_w), Q(fc1_w), Q(fc2_w),
               F(o_ws), F(cq_ws), F(co_ws), F(fc1_ws), F(fc2_ws), P(o_b),
               P(ln2_g), P(ln2_b), P(cq_b), P(co_b), P(ln3_g), P(ln3_b),
               P(fc1_b), P(fc2_b), k, v, F(ks), F(vs), O(x1), O(cq), O(att),
               O(x2), O(h4), O(out), layer, N, D, H, Bc, beams, Ta, ta_total,
               stream);
  } else {
    tail_layer(P(x), P(self_out), P(o_w), P(cq_w), P(co_w), P(fc1_w), P(fc2_w),
               nullptr, nullptr, nullptr, nullptr, nullptr, P(o_b), P(ln2_g),
               P(ln2_b), P(cq_b), P(co_b), P(ln3_g), P(ln3_b), P(fc1_b),
               P(fc2_b), k, v, F(ks), F(vs), O(x1), O(cq), O(att), O(x2),
               O(h4), O(out), layer, N, D, H, Bc, beams, Ta, ta_total, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
