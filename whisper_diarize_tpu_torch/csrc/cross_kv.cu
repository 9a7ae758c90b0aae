// K2: cross K/V build for all decoder layers at prefill.
//
// Replaces whisper_diarize_tpu/ops/pallas_attn.py::cross_kv_tiled_pallas
// (_cross_build_kernel, _cross_build_impl): for every layer l,
//   K[l] = xa @ ck_w[l],  V[l] = xa @ cv_w[l] + cv_b[l]
// with f32 accumulation, the bias added in f32 before the single bf16
// rounding, and the result written straight into the head-split cache
// layout [L, B, H, Ta, Dh] that K1 and K3 read. The TPU kernel's
// [L, B, NT, H, Dh, 512] tiling (audio on the 128-lane axis) is not carried
// over.
//
// What bounds it on the H100: tensor-core throughput. Per layer it is a
// [B*Ta, D] x [D, 2*H*Dh] GEMM (4 x 12000 x 1280^2 = 79 GFLOP a layer at
// B 8, large-v3: 2.5 TFLOP over 32 layers, 2.5 ms at 989 TFLOP/s), far above
// the ~295 FLOP/byte balance point. Design (the usual Hopper GEMM):
// - One operand of width 2 * H * Dh. The K and V weights are two tensor
//   maps, and every 128-column tile lies wholly in one of them (H * Dh is a
//   multiple of 128), so one accumulator a tile and one A tile for both
//   products; the epilogue adds the bias only on V's tiles.
// - TMA into a ring of STAGES (4) slots of 64 k-rows (40 KB each: three
//   64-row boxes of xa, two 64-column boxes of the weights), 128-byte
//   swizzle, completing on the slot's `full` mbarrier; a producer warpgroup
//   (one thread issues) refills a slot once the consumers arrive on its
//   `empty` barrier.
// - Three consumer warpgroups, 64 rows each (a 192 x 128 tile): per k-row
//   slot four wgmma m64n128k16, A K-major from the slot, B the weights
//   [D, H*Dh] row-major: an MN-major operand (trans-b, as K10 takes V), the
//   two 64-column boxes one descriptor's leading byte offset (8 KB) apart.
//   One product group stays in flight while the next slot's are issued.
// - Row tiles stay inside one stream: the tensor map over xa [B, Ta, D]
//   zero-fills the rows past Ta (1,500 is no multiple of 64), and the
//   output's tensor map over [L * B * H, Ta, 64] leaves them unwritten, so a
//   ragged tile costs nothing but its zero rows.
// - Persistent CTAs, one an SM, walk the tiles with the layer outermost,
//   then the stream's row tile, the column innermost
//   (ops/attn.py::cross_kv_tile mirrors the order): a layer's weights
//   (6.5 MB at large-v3) and all of xa (30.7 MB at B 8) stay in the 50 MB
//   L2, so each weight byte comes from device memory once. The producer
//   runs ahead into the next tile while the consumers finish one.
// - Epilogue: bias in f32, one bf16 rounding, the tile staged in shared
//   memory with the 128-byte swizzle (conflict-free), then two TMA stores a
//   warpgroup, one a head: [64 rows, 64] contiguous runs of one (l, b, h).
//
// The f32 form (`cross_kv_f32_kernel`): the same function in f32, the TPU
// kernel's one rounding being the identity. Hopper's wgmma has no f32 x f32
// product (only TF32, 10 mantissa bits: not an f32 product), so it is a
// CUDA-core SGEMM: a 128 x 128 output tile a CTA of 256 threads, 8 x 8 a
// thread (rows 4 ty .. + 3 and 64 + 4 ty .., columns likewise: the float4
// reads of a warp fall on few addresses), k steps of 8 double-buffered in
// shared memory (xa stored transposed from registers, the weights by
// cp.async), each output a sequential f32 FMA chain over D, the bias added
// in f32 and the head split written from registers as float4. Rows run
// over all B x Ta positions (a tile may cross a stream), columns over
// [K | V] (each tile in one of them). Bound at large-v3 (L 32, B 8, Ta
// 1500) by operations: 4 x 12000 x 1280^2 x 32 = 2.5e12 FLOP, 37.6 ms at
// 67 TFLOP/s; grid (2 H Dh / 128, row tiles, L), the layer outermost so a
// layer's weights (13 MB) stay in L2.
#include "common.cuh"

namespace {

constexpr int DH = 64;                        // head dimension (every Whisper checkpoint)
constexpr int BK = 64;                        // k rows a slot: one 128-byte swizzle row
constexpr int CONSUMERS = 3;                  // warpgroups of 64 rows
constexpr int BM = 64 * CONSUMERS;            // rows of one stream a tile
constexpr int BN = 128;                       // output columns a tile: two heads
constexpr int THREADS = (CONSUMERS + 1) * 128;  // and the producer warpgroup
constexpr int STAGES = 4;                     // ring slots
constexpr int BOX = 64 * 64 * 2;              // one 64 x 128-byte box
constexpr int A_BYTES = CONSUMERS * BOX;      // xa: rows t0 .. t0 + 191
constexpr int B_BYTES = (BN / 64) * BOX;      // weights: 64 k-rows x 128 columns
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int OUT_BYTES = CONSUMERS * (BN / 64) * BOX;  // the epilogue's staging
// 1024-byte aligned (the swizzle's period), plus the slack to align the base
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + OUT_BYTES + 1024;

struct Tile {
  int l, b, t0, n0;  // layer, stream, first row, first column of [0, 2 HD)
};

// tile i: the layer outermost, then (stream, row tile), the column innermost
__device__ __forceinline__ Tile tile_at(int i, int B, int row_tiles, int col_tiles) {
  Tile t;
  t.n0 = (i % col_tiles) * BN;
  const int r = (i / col_tiles) % (B * row_tiles);
  t.l = i / (col_tiles * B * row_tiles);
  t.b = r / row_tiles;
  t.t0 = (r % row_tiles) * BM;
  return t;
}

__global__ void __launch_bounds__(THREADS, 1)
cross_kv_kernel(const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_kw,
                const __grid_constant__ CUtensorMap map_vw,
                const __grid_constant__ CUtensorMap map_ko,
                const __grid_constant__ CUtensorMap map_vo, const bf16* __restrict__ vb,
                int L, int B, int Ta, int D, int HD) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* base = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  unsigned char* ring = base;                          // [STAGES][STAGE_BYTES]
  unsigned char* outs = base + STAGES * STAGE_BYTES;   // [CONSUMERS][2][BOX]

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int row_tiles = (Ta + BM - 1) / BM;
  const int col_tiles = 2 * HD / BN;
  const int n_tiles = L * B * row_tiles * col_tiles;
  const int kb_n = D / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---------------- producer: one thread issues every copy ----------------
    if (tid != CONSUMERS * 128) return;
    int it = 0;  // k-row slots issued, over all tiles
    for (int i = blockIdx.x; i < n_tiles; i += gridDim.x) {
      const Tile t = tile_at(i, B, row_tiles, col_tiles);
      const bool is_v = t.n0 >= HD;
      const CUtensorMap* wmap = is_v ? &map_vw : &map_kw;
      const int col = t.n0 - (is_v ? HD : 0);
      for (int kb = 0; kb < kb_n; ++kb, ++it) {
        const int slot = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[slot], ((it / STAGES) - 1) & 1);
        unsigned char* st = ring + slot * STAGE_BYTES;
        mbar_expect_tx(&full[slot], STAGE_BYTES);
#pragma unroll
        for (int c = 0; c < CONSUMERS; ++c)
          tma_load_3d(st + c * BOX, &map_x, kb * BK, t.t0 + 64 * c, t.b, &full[slot]);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_3d(st + A_BYTES + j * BOX, wmap, col + 64 * j, kb * BK, t.l, &full[slot]);
      }
    }
    return;
  }

  // ---------------- consumers: 64 rows each ----------------
  const int ct = tid % 128;
  const int warp = ct / 32, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int H = HD / DH;
  unsigned char* stage_out = outs + wg * (BN / 64) * BOX;
  float acc[64];
  int it = 0;  // k-row slots consumed, over all tiles
  for (int i = blockIdx.x; i < n_tiles; i += gridDim.x) {
    const Tile t = tile_at(i, B, row_tiles, col_tiles);
    fence_acc<64>(acc);
    for (int kb = 0; kb < kb_n; ++kb, ++it) {
      const int slot = it % STAGES;
      mbar_wait(&full[slot], (it / STAGES) & 1);
      unsigned char* st = ring + slot * STAGE_BYTES;
      const uint64_t da = smem_desc(st + wg * BOX);
      const uint64_t db = smem_desc(st + A_BYTES, BOX);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)  // 16 k-rows: 32 bytes of A, 2 KB of B
        wgmma_ss_n128_tb(acc, da + 2 * kk, db + 128 * kk, kb > 0 || kk > 0);
      wgmma_commit();
      if (kb > 0) {  // the slot before this one is read: hand it back
        wgmma_wait<1>();
        mbar_arrive(&empty[(it - 1) % STAGES]);
      }
    }
    wgmma_wait<0>();
    fence_acc<64>(acc);
    mbar_arrive(&empty[(it - 1) % STAGES]);

    // epilogue: bias (V's tiles), one bf16 rounding, swizzled staging, TMA
    // stores of the warpgroup's 64 rows, one a head
    const bool is_v = t.n0 >= HD;
    const int col0 = t.n0 - (is_v ? HD : 0);
    if (ct == 0) bulk_wait_read<0>();  // the last tile's stores have read the staging
    named_barrier(1 + wg, 128);
    const int r0 = 16 * warp + g;  // rows r0 and r0 + 8; r0 % 8 == g
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      float b0 = 0.0f, b1 = 0.0f;
      if (is_v) {
        const bf162 bb =
            *reinterpret_cast<const bf162*>(vb + (size_t)t.l * HD + col0 + 8 * j + 2 * tg);
        b0 = __low2float(bb);
        b1 = __high2float(bb);
      }
      unsigned char* box = stage_out + (j / 8) * BOX;
      const int chunk = ((j % 8) ^ g) * 16 + 4 * tg;
      *reinterpret_cast<bf162*>(box + r0 * 128 + chunk) =
          __floats2bfloat162_rn(acc[4 * j] + b0, acc[4 * j + 1] + b1);
      *reinterpret_cast<bf162*>(box + (r0 + 8) * 128 + chunk) =
          __floats2bfloat162_rn(acc[4 * j + 2] + b0, acc[4 * j + 3] + b1);
    }
    fence_view_async();  // the staged tile, visible to the copy engine
    named_barrier(1 + wg, 128);
    const int rows = t.t0 + 64 * wg;
    if (ct == 0 && rows < Ta) {
      const int slab = (t.l * B + t.b) * H + col0 / DH;
#pragma unroll
      for (int j = 0; j < BN / 64; ++j)
        tma_store_3d(is_v ? &map_vo : &map_ko, stage_out + j * BOX, 0, rows, slab + j);
      bulk_commit();
    }
  }
  if (ct == 0) bulk_wait<0>();
}

constexpr int SG_BM = 128, SG_BN = 128, SG_BK = 8, SG_THREADS = 256;

__global__ void __launch_bounds__(SG_THREADS)
cross_kv_f32_kernel(const float* __restrict__ xa, const float* __restrict__ kw,
                    const float* __restrict__ vw, const float* __restrict__ vb,
                    float* __restrict__ ko, float* __restrict__ vo, int B, int Ta, int D,
                    int HD) {
  __shared__ __align__(16) float As[2][SG_BK][SG_BM];  // xa's tile, k-major
  __shared__ __align__(16) float Bs[2][SG_BK][SG_BN];  // the weights' tile
  const int M = B * Ta;
  const int l = blockIdx.z;
  const int n0 = blockIdx.x * SG_BN;  // of [0, 2 HD): K's columns, then V's
  const int m0 = blockIdx.y * SG_BM;
  const bool is_v = n0 >= HD;
  const int c0 = n0 - (is_v ? HD : 0);
  const float* W = (is_v ? vw : kw) + (size_t)l * D * HD + c0;
  const int tid = threadIdx.x;
  // copies: xa row tid / 2, k (tid % 2) * 4 .. + 3; weights k row tid / 32,
  // columns (tid % 32) * 4 .. + 3
  const int a_row = tid >> 1, a_k = (tid & 1) * 4;
  const int b_row = tid >> 5, b_col = (tid & 31) * 4;
  const bool a_ok = m0 + a_row < M;
  const float* a_src = xa + (size_t)(a_ok ? m0 + a_row : 0) * D + a_k;
  const float* b_src = W + (size_t)b_row * HD + b_col;
  const int ty = tid >> 4, tx = tid & 15;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int nk = D / SG_BK;
  float4 ar = a_ok ? *reinterpret_cast<const float4*>(a_src) : zero;
  cp_async<16>(&Bs[0][b_row][b_col], b_src, true);
  cp_async_commit();
  As[0][a_k + 0][a_row] = ar.x;
  As[0][a_k + 1][a_row] = ar.y;
  As[0][a_k + 2][a_row] = ar.z;
  As[0][a_k + 3][a_row] = ar.w;
  cp_async_wait<0>();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1, nxt = cur ^ 1;
    const bool more = kt + 1 < nk;
    if (more) {  // the next tile in flight while this one is computed
      ar = a_ok ? *reinterpret_cast<const float4*>(a_src + (kt + 1) * SG_BK) : zero;
      cp_async<16>(&Bs[nxt][b_row][b_col], b_src + (size_t)(kt + 1) * SG_BK * HD, true);
      cp_async_commit();
    }
#pragma unroll
    for (int kk = 0; kk < SG_BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    if (more) {  // buffer nxt was last read before the previous barrier
      As[nxt][a_k + 0][a_row] = ar.x;
      As[nxt][a_k + 1][a_row] = ar.y;
      As[nxt][a_k + 2][a_row] = ar.z;
      As[nxt][a_k + 3][a_row] = ar.w;
      cp_async_wait<0>();
    }
    __syncthreads();
  }

  // epilogue: V's bias in f32, the head split [L, B, H, Ta, 64], float4 stores
  const int H = HD / DH;
  float* out = is_v ? vo : ko;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= M) continue;
    const int b = r / Ta, t = r % Ta;
#pragma unroll
    for (int gj = 0; gj < 2; ++gj) {
      const int c = c0 + gj * 64 + tx * 4;  // a column of [0, HD)
      float4 y = make_float4(acc[i][4 * gj], acc[i][4 * gj + 1], acc[i][4 * gj + 2],
                             acc[i][4 * gj + 3]);
      if (is_v) {
        const float4 bias = *reinterpret_cast<const float4*>(vb + (size_t)l * HD + c);
        y.x += bias.x;
        y.y += bias.y;
        y.z += bias.z;
        y.w += bias.w;
      }
      *reinterpret_cast<float4*>(
          out + ((((size_t)l * B + b) * H + c / DH) * Ta + t) * DH + c % DH) = y;
    }
  }
}

int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
}

}  // namespace

// xa [B, Ta, D]; kw, vw [L, D, H*Dh]; vb [L, H*Dh]; k, v [L, B, H, Ta, Dh];
// all bf16, contiguous, 16-byte aligned. Needs Dh == 64, D % 64 == 0 and
// (H*Dh) % 128 == 0 (the wrapper checks; the kernel refuses otherwise).
WDT_EXPORT int wdt_cross_kv(const void* xa, const void* kw, const void* vw,
                            const void* vb, void* k, void* v, int L, int B,
                            int Ta, int D, int H, int Dh, void* stream) {
  const int HD = H * Dh;
  if (Dh != DH || D % BK != 0 || HD % BN != 0 || L <= 0 || B <= 0 || Ta <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint64_t x_dims[3] = {(cuuint64_t)D, (cuuint64_t)Ta, (cuuint64_t)B};
  const cuuint64_t x_strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)Ta * D * 2};
  const cuuint64_t w_dims[3] = {(cuuint64_t)HD, (cuuint64_t)D, (cuuint64_t)L};
  const cuuint64_t w_strides[2] = {(cuuint64_t)HD * 2, (cuuint64_t)D * HD * 2};
  const cuuint64_t o_dims[3] = {(cuuint64_t)DH, (cuuint64_t)Ta, (cuuint64_t)L * B * H};
  const cuuint64_t o_strides[2] = {(cuuint64_t)DH * 2, (cuuint64_t)Ta * DH * 2};
  CUtensorMap mx, mkw, mvw, mko, mvo;
  if (!make_map_3d(&mx, xa, x_dims, x_strides, box) ||
      !make_map_3d(&mkw, kw, w_dims, w_strides, box) ||
      !make_map_3d(&mvw, vw, w_dims, w_strides, box) ||
      !make_map_3d(&mko, k, o_dims, o_strides, box) ||
      !make_map_3d(&mvo, v, o_dims, o_strides, box))
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      cross_kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long n_tiles = (long long)L * B * ((Ta + BM - 1) / BM) * (2 * HD / BN);
  const int grid = static_cast<int>(n_tiles < sm_count() ? n_tiles : sm_count());
  cross_kv_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      mx, mkw, mvw, mko, mvo, static_cast<const bf16*>(vb), L, B, Ta, D, HD);
  return static_cast<int>(cudaGetLastError());
}

// The f32 form: the same arguments in f32, 16-byte aligned; the same shape
// rules (the f32 SGEMM's k step is 8 rows, its column tile 128).
WDT_EXPORT int wdt_cross_kv_f32(const void* xa, const void* kw, const void* vw,
                                const void* vb, void* k, void* v, int L, int B,
                                int Ta, int D, int H, int Dh, void* stream) {
  const int HD = H * Dh;
  const long long row_tiles = ((long long)B * Ta + SG_BM - 1) / SG_BM;
  if (Dh != DH || D % SG_BK != 0 || HD % SG_BN != 0 || L <= 0 || L > 65535 || B <= 0 ||
      Ta <= 0 || row_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(2 * HD / SG_BN, static_cast<unsigned>(row_tiles), L);
  cross_kv_f32_kernel<<<grid, SG_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xa), static_cast<const float*>(kw),
      static_cast<const float*>(vw), static_cast<const float*>(vb), static_cast<float*>(k),
      static_cast<float*>(v), B, Ta, D, HD);
  return static_cast<int>(cudaGetLastError());
}
