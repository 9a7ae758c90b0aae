// K3: one decoder layer's tail for a single-token sampling step.
//
// Replaces whisper_diarize_tpu/ops/pallas_tail.py::fused_tail_layer
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
// What bounds it on the H100: bytes. At N = batch x best_of rows (8..80) each
// projection streams its [Din, Dout] bf16 weight once for a few dozen rows
// (~18 MB of tail weights per layer on turbo), plus the layer's cross K/V in
// the attention. Design: one CTA cannot synchronise the grid, so the tail is
// a fixed sequence of six launches on one stream, issued from one C call:
// five launches of a weight-streaming skinny GEMM (16 rows x 64 columns per
// CTA on bf16 tensor-core MMA, with a fused layernorm prologue and a fused
// bias / GELU / residual epilogue, so no normalised or pre-activation tensor
// is written to device memory) and K1's flash attention. The stacked
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

// out[N, Dout] = epi(pro(A)[N, Din] @ W[Din, Dout])
//   pro: ln_g != nullptr -> bf16((a - mean) * rstd * g + b), f32 statistics
//   epi: y = acc + bias; gelu -> gelu_tanh(y); o = bf16(y);
//        residual != nullptr -> o = bf16(residual + o)
__global__ void __launch_bounds__(THREADS)
skinny_gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
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
      }
      *reinterpret_cast<uint4*>(&As[r][c8 * 8]) = val;
    }
    // weights: 64 x 64 = 512 vectors, four per thread
    for (int i = tid; i < BK * BN / 8; i += THREADS) {
      const int r = i / (BN / 8), c8 = i % (BN / 8);
      *reinterpret_cast<uint4*>(&Ws[r][c8 * 8]) = *reinterpret_cast<const uint4*>(
          W + (size_t)(k0 + r) * Dout + n0 + c8 * 8);
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
    float y = Cs[r][c] + __bfloat162float(bias[col]);
    if (gelu) y = gelu_tanh(y);
    y = bf16_round(y);
    const size_t o = (size_t)row * Dout + col;
    if (residual != nullptr) y = __bfloat162float(residual[o]) + y;
    out[o] = __float2bfloat16(y);
  }
}

void skinny_gemm(const bf16* A, const bf16* W, const bf16* bias,
                 const bf16* residual, const bf16* ln_g, const bf16* ln_b,
                 bf16* out, int N, int Din, int Dout, int gelu,
                 cudaStream_t stream) {
  dim3 grid(Dout / BN, (N + BM - 1) / BM);
  skinny_gemm_kernel<<<grid, THREADS, 0, stream>>>(A, W, bias, residual, ln_g,
                                                   ln_b, out, N, Din, Dout, gelu);
}

}  // namespace

// x, self_out [N, D] (self_out is [N, H, 1, Dh] viewed flat); the stacked
// decoder weights [L, ...] are passed at layer 0 and offset by `layer` here;
// k, v [L, Bc, H, Ta, 64] with N = Bc * beams; x1, cq, att, x2 [N, D] and
// h4 [N, 4D] are scratch; out [N, D]. Needs D % 64 == 0 (the wrapper checks).
WDT_EXPORT int wdt_fused_tail(
    const void* x, const void* self_out, const void* o_w, const void* o_b,
    const void* ln2_g, const void* ln2_b, const void* cq_w, const void* cq_b,
    const void* co_w, const void* co_b, const void* ln3_g, const void* ln3_b,
    const void* fc1_w, const void* fc1_b, const void* fc2_w, const void* fc2_b,
    const void* k, const void* v, void* x1, void* cq, void* att, void* x2,
    void* h4, void* out, int layer, int N, int D, int H, int Bc, int beams,
    int Ta, int ta_total, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const size_t l = static_cast<size_t>(layer);
  const size_t dd = static_cast<size_t>(D) * D;
  const size_t d4 = static_cast<size_t>(D) * 4 * D;
  auto P = [](const void* p) { return static_cast<const bf16*>(p); };
  bf16* x1p = static_cast<bf16*>(x1);
  bf16* cqp = static_cast<bf16*>(cq);
  bf16* attp = static_cast<bf16*>(att);
  bf16* x2p = static_cast<bf16*>(x2);
  bf16* h4p = static_cast<bf16*>(h4);

  skinny_gemm(P(self_out), P(o_w) + l * dd, P(o_b) + l * D, P(x), nullptr,
              nullptr, x1p, N, D, D, 0, stream);
  skinny_gemm(x1p, P(cq_w) + l * dd, P(cq_b) + l * D, nullptr,
              P(ln2_g) + l * D, P(ln2_b) + l * D, cqp, N, D, D, 0, stream);
  launch_cross_attn(cqp, P(k), P(v), attp, Bc, beams, H, Ta, layer, ta_total,
                    stream);
  skinny_gemm(attp, P(co_w) + l * dd, P(co_b) + l * D, x1p, nullptr, nullptr,
              x2p, N, D, D, 0, stream);
  skinny_gemm(x2p, P(fc1_w) + l * d4, P(fc1_b) + l * 4 * D, nullptr,
              P(ln3_g) + l * D, P(ln3_b) + l * D, h4p, N, D, 4 * D, 1, stream);
  skinny_gemm(h4p, P(fc2_w) + l * d4, P(fc2_b) + l * D, x2p, nullptr, nullptr,
              static_cast<bf16*>(out), N, 4 * D, D, 0, stream);
  return static_cast<int>(cudaGetLastError());
}
