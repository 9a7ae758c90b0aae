// K2: cross K/V build for all decoder layers at prefill.
//
// Replaces whisper_diarize_tpu/ops/pallas_attn.py::cross_kv_tiled_pallas
// (_cross_build_kernel, _cross_build_impl): for every layer l,
//   K[l] = xa @ ck_w[l],  V[l] = xa @ cv_w[l] + cv_b[l]
// with f32 accumulation, the bias added in f32 before the bf16 store, and the
// result written straight into the head-split cache layout [L, B, H, Ta, Dh]
// that K1 and K3 read. The TPU kernel's [L, B, NT, H, Dh, 512] tiling (audio
// on the 128-lane axis) is not carried over.
//
// What bounds it on the H100: tensor-core throughput. Per layer it is a
// [B*Ta, D] x [D, H*Dh] GEMM pair (2 x 2 x 12000 x 1280 x 1280 = 79 GFLOP
// at B=8 turbo), well above the ~295 FLOP/byte balance point. Design: a
// shared-memory tiled kernel on warp-level bf16 tensor-core MMA (wmma
// 16x16x16, f32 accumulators); one CTA per (64-column tile, 64-row tile,
// layer) computes K and V together so each activation tile is staged once
// for both products; ragged row tiles (B*Ta = 12000 is not a multiple of 64)
// are masked on load and store. wgmma, TMA and a multi-stage pipeline are
// later work.
#include "common.cuh"

#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int AROW = BK + 8;  // bf16 elements per staged row (80 B, 16 B aligned)
constexpr int WROW = BN + 8;  // 144 B
constexpr int CROW = BN + 4;  // f32 staging row
constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
cross_kv_kernel(const bf16* __restrict__ xa, const bf16* __restrict__ kw,
                const bf16* __restrict__ vw, const bf16* __restrict__ vb,
                bf16* __restrict__ kout, bf16* __restrict__ vout, int M,
                int D, int HD, int Ta, int Dh) {
  __shared__ __align__(128) bf16 As[BM][AROW];
  __shared__ __align__(128) bf16 Ks[BK][WROW];
  __shared__ __align__(128) bf16 Vs[BK][WROW];
  __shared__ __align__(128) float Cs[BM][CROW];

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int l = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // 2 x 2 warps, 32 x 32 each

  const bf16* kwl = kw + (size_t)l * D * HD;
  const bf16* vwl = vw + (size_t)l * D * HD;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> ck[2][2], cv[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(ck[i][j], 0.0f);
      wmma::fill_fragment(cv[i][j], 0.0f);
    }

  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  for (int k0 = 0; k0 < D; k0 += BK) {
    // activations: BM x BK = 256 16-byte vectors
    for (int i = tid; i < BM * BK / 8; i += THREADS) {
      const int row = i / (BK / 8), c8 = i % (BK / 8);
      const int grow = m0 + row;
      uint4 val = zero4;
      if (grow < M)
        val = *reinterpret_cast<const uint4*>(xa + (size_t)grow * D + k0 + c8 * 8);
      *reinterpret_cast<uint4*>(&As[row][c8 * 8]) = val;
    }
    // weights: BK x BN for K and V
    for (int i = tid; i < BK * BN / 8; i += THREADS) {
      const int row = i / (BN / 8), c8 = i % (BN / 8);
      const size_t off = (size_t)(k0 + row) * HD + n0 + c8 * 8;
      *reinterpret_cast<uint4*>(&Ks[row][c8 * 8]) =
          *reinterpret_cast<const uint4*>(kwl + off);
      *reinterpret_cast<uint4*>(&Vs[row][c8 * 8]) =
          *reinterpret_cast<const uint4*>(vwl + off);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[wm * 32 + i * 16][kk], AROW);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bk, bv;
        wmma::load_matrix_sync(bk, &Ks[kk][wn * 32 + j * 16], WROW);
        wmma::load_matrix_sync(bv, &Vs[kk][wn * 32 + j * 16], WROW);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          wmma::mma_sync(ck[i][j], a[i], bk, ck[i][j]);
          wmma::mma_sync(cv[i][j], a[i], bv, cv[i][j]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: stage f32 tile, then scatter rows (b, t) / cols (h, d) into
  // [L, B, H, Ta, Dh]; consecutive threads write consecutive d
  const size_t layer_off = (size_t)l * M * HD;
  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(&Cs[wm * 32 + i * 16][wn * 32 + j * 16],
                                which == 0 ? ck[i][j] : cv[i][j], CROW,
                                wmma::mem_row_major);
    __syncthreads();
    bf16* dst = which == 0 ? kout : vout;
    for (int i = tid; i < BM * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int grow = m0 + r;
      if (grow >= M) continue;
      const int col = n0 + c;
      float val = Cs[r][c];
      if (which == 1) val += __bfloat162float(vb[(size_t)l * HD + col]);
      const int b = grow / Ta, t = grow % Ta;
      const int h = col / Dh, d = col % Dh;
      dst[layer_off + (((size_t)b * (HD / Dh) + h) * Ta + t) * Dh + d] =
          __float2bfloat16(val);
    }
    __syncthreads();
  }
}

}  // namespace

// xa [B, Ta, D]; kw, vw [L, D, H*Dh]; vb [L, H*Dh]; k, v [L, B, H, Ta, Dh].
// Needs D % 32 == 0 and (H*Dh) % 64 == 0 (the wrapper checks).
WDT_EXPORT int wdt_cross_kv(const void* xa, const void* kw, const void* vw,
                            const void* vb, void* k, void* v, int L, int B,
                            int Ta, int D, int H, int Dh, void* stream) {
  const int M = B * Ta, HD = H * Dh;
  dim3 grid(HD / BN, (M + BM - 1) / BM, L);
  cross_kv_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(xa), static_cast<const bf16*>(kw),
      static_cast<const bf16*>(vw), static_cast<const bf16*>(vb),
      static_cast<bf16*>(k), static_cast<bf16*>(v), M, D, HD, Ta, Dh);
  return static_cast<int>(cudaGetLastError());
}
