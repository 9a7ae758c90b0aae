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
//   maps, and every tile lies wholly in one of them, so one accumulator a
//   tile and one A tile for both products; the epilogue adds the bias only
//   on V's tiles. Each half (K's, then V's) is H * Dh / 128 tiles of 128
//   columns (two heads) and, where the head count is odd (a rank of a head
//   split: 3 of tiny.en's 6 heads, 1 of base.en's 8), one 64-column edge
//   tile of its last head: one weights box, wgmma m64n64k16, one store a
//   warpgroup. An edge tile runs at half the warpgroups' product width.
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
// kernel's one rounding being the identity. Hopper has no f32 x f32 tensor
// product, but a 3xTF32 split keeps f32's accuracy (common.cuh's
// tf32_split: hi = tf32(x), lo = tf32(x - hi); a product lo hi' + hi lo' +
// hi hi', summed in f32). Bound at large-v3 (L 32, B 8, Ta 1500) by
// operations: 2.5e12 FLOP of f32 products, 15.25 ms at the 3xTF32 rate
// (495 / 3 TFLOP/s; 37.6 ms at the CUDA cores' 67). It keeps the bf16
// kernel's skeleton: persistent CTAs, one an SM, walking the tiles with the
// layer outermost (a layer's f32 weights, 13 MB, and all of xa, 61 MB at B
// 8, mostly in L2); a ring of STAGES slots on mbarriers with a producer
// warpgroup and consumer warpgroups; rows past Ta are zeros and not stored.
// Where f32 differs:
// - TF32 wgmma reads B from shared memory only K-major, and the weights
//   [D, H*Dh] are MN-major. So the operands trade places: each consumer
//   warpgroup computes one head's K^T (or V^T) = W^T xa^T, a wgmma
//   m64n128k8 with M = the head's 64 weight columns and N = the tile's 128
//   rows of xa. A, the weights, comes from registers: TMA lands the raw
//   tile (32 k rows x 128 columns, four 32-column boxes, 128-byte swizzle)
//   and each thread reads its fragment's eight values and splits them as it
//   reads. B, xa, is K-major as it lies: the producer warpgroup loads each
//   slot's 128 rows x 32 k from device memory (16-byte loads, the next
//   slot's in flight while it waits for a free one), splits them once, and
//   stores hi and lo planes with the 128-byte swizzle the descriptors read.
//   Neither operand is copied or transposed outside the kernel.
// - The slot: at f32 a 128-byte swizzle row holds 32 k values; 16 KB of
//   raw weights and 32 KB of xa hi / lo make 48 KB, four slots 192 KB.
// - The tensor cores' accumulation truncates (cross_attn.cu, tf32x3_pv):
//   each slot's 12 products (four k8 steps, three each) start
//   from zero (scale_d 0) and their sum joins the tile's f32 running sum on
//   the CUDA cores, slot by slot (`agreement.k2_tf32x3_model`). The two
//   accumulator sets cost 128 registers a thread: two consumer warpgroups
//   of 64 weight columns (128-row tiles, one stream each), not three.
// - A's registers are read by the asynchronous product after its issue:
//   two sets alternate over the k8 steps, each kept live (`keep_regs`) up
//   to the wgmma_wait that retires the product reading it.
// - Epilogue: V's bias in f32, then the head split written from registers,
//   a quad's four rows of one head's eight columns a store (32-byte
//   sectors): an f32 staging tile of 128 x 128 would not fit beside the
//   ring.
// - The 64-column edge tile (an odd head count) is one head: the producer
//   loads two of the four 32-column weight boxes, the first consumer
//   warpgroup computes it, and the second waits on each slot's `full`
//   barrier and arrives on its `empty` one without a product or a store
//   (the barrier counts both warpgroups: running ahead, it would complete a
//   slot's phase twice over).
#include "common.cuh"

namespace {

constexpr int DH = 64;                        // head dimension (every Whisper checkpoint)
constexpr int BK = 64;                        // k rows a slot: one 128-byte swizzle row
constexpr int CONSUMERS = 3;                  // warpgroups of 64 rows
constexpr int BM = 64 * CONSUMERS;            // rows of one stream a tile
constexpr int BN = 128;                       // output columns a tile: two heads
constexpr int BN_EDGE = 64;                   // the edge tile of an odd head count: one head
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
  int w;             // columns: BN, or BN_EDGE for a half's odd last head
};

// column tiles of the walk: each half (K's, then V's) is HD / BN full
// tiles and, where HD / 64 is odd, one edge tile
__host__ __device__ __forceinline__ int col_tiles_of(int HD) { return 2 * ((HD + BN - 1) / BN); }

// tile i: the layer outermost, then (stream, row tile), the column innermost
// (K's tiles, then V's); tiles of bm rows (BM, or F_BM for the f32 form);
// col_tiles = col_tiles_of(HD). ODD: an odd head count, whose halves end in
// an edge tile; the even form walks full tiles only and divides by no
// runtime half width
template <bool ODD>
__host__ __device__ __forceinline__ Tile tile_at(int i, int B, int row_tiles, int HD,
                                                 int col_tiles, int bm = BM) {
  Tile t;
  if constexpr (ODD) {
    const int per_half = col_tiles / 2, c = i % col_tiles, j = c % per_half;
    t.n0 = (c / per_half) * HD + j * BN;
    t.w = HD - j * BN < BN ? BN_EDGE : BN;
  } else {
    t.n0 = (i % col_tiles) * BN;
    t.w = BN;
  }
  const int r = (i / col_tiles) % (B * row_tiles);
  t.l = i / (col_tiles * B * row_tiles);
  t.b = r / row_tiles;
  t.t0 = (r % row_tiles) * bm;
  return t;
}

// ODD: an odd head count, each half ending in a 64-column edge tile (the
// even form compiles without the edge tile's walk and branches)
template <bool ODD>
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
  const int col_tiles = col_tiles_of(HD);
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
      const Tile t = tile_at<ODD>(i, B, row_tiles, HD, col_tiles);
      const bool is_v = t.n0 >= HD;
      const CUtensorMap* wmap = is_v ? &map_vw : &map_kw;
      const int col = t.n0 - (is_v ? HD : 0);
      const int w_boxes = ODD ? t.w / 64 : BN / 64;  // 2, or 1 on an edge tile
      for (int kb = 0; kb < kb_n; ++kb, ++it) {
        const int slot = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[slot], ((it / STAGES) - 1) & 1);
        unsigned char* st = ring + slot * STAGE_BYTES;
        mbar_expect_tx(&full[slot], A_BYTES + w_boxes * BOX);
#pragma unroll
        for (int c = 0; c < CONSUMERS; ++c)
          tma_load_3d(st + c * BOX, &map_x, kb * BK, t.t0 + 64 * c, t.b, &full[slot]);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          if (j < w_boxes)
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
    const Tile t = tile_at<ODD>(i, B, row_tiles, HD, col_tiles);
    const bool edge = ODD && t.w == BN_EDGE;  // uniform over the CTA
    fence_acc<64>(acc);
    for (int kb = 0; kb < kb_n; ++kb, ++it) {
      const int slot = it % STAGES;
      mbar_wait(&full[slot], (it / STAGES) & 1);
      unsigned char* st = ring + slot * STAGE_BYTES;
      const uint64_t da = smem_desc(st + wg * BOX);
      const uint64_t db = smem_desc(st + A_BYTES, BOX);
      // each width fences and commits its own group: one fence before the
      // branch makes ptxas serialize every wgmma of the kernel (C7520)
      if (edge) {  // one 64-column box: acc[0 .. 31]
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)  // 16 k-rows: 32 bytes of A, 2 KB of B
          wgmma_ss_n64_tb(acc, da + 2 * kk, db + 128 * kk, kb > 0 || kk > 0);
        wgmma_commit();
      } else {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_ss_n128_tb(acc, da + 2 * kk, db + 128 * kk, kb > 0 || kk > 0);
        wgmma_commit();
      }
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
      if (edge && j >= BN_EDGE / 8) continue;  // the edge tile's 64 columns: acc[0 .. 31]
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
        if (!edge || j == 0)
          tma_store_3d(is_v ? &map_vo : &map_ko, stage_out + j * BOX, 0, rows, slab + j);
      bulk_commit();
    }
  }
  if (ct == 0) bulk_wait<0>();
}

// ---------------------------------------------------------------------------
// The f32 form: 3xTF32 wgmma, the operands traded (see the head of the file)
// ---------------------------------------------------------------------------

constexpr int F_CONSUMERS = 2;                     // warpgroups: one head each
constexpr int F_BM = 128;                          // rows of one stream a tile (wgmma N)
constexpr int F_BK = 32;                           // k a slot: one 128-byte row of f32
constexpr int F_THREADS = (F_CONSUMERS + 1) * 128;  // and the producer warpgroup
constexpr int F_STAGES = 4;                        // ring slots
constexpr int F_WBOX = F_BK * 128;                 // a 32-column box of the weights (4 KB)
constexpr int F_W_BYTES = (BN / 32) * F_WBOX;      // the slot's raw weights (16 KB)
constexpr int F_PLANE = F_BM * 128;                // xa hi or lo, K-major (16 KB)
constexpr int F_STAGE_BYTES = F_W_BYTES + 2 * F_PLANE;
// 1024-byte aligned (the swizzle's period), plus the slack to align the base
constexpr int F_SMEM = F_STAGES * F_STAGE_BYTES + 1024;
static_assert(F_CONSUMERS * 64 == BN, "a consumer warpgroup a head of the tile");

template <bool ODD>  // as cross_kv_kernel's
__global__ void __launch_bounds__(F_THREADS, 1)
cross_kv_f32_kernel(const __grid_constant__ CUtensorMap map_kw,
                    const __grid_constant__ CUtensorMap map_vw, const float* __restrict__ xa,
                    const float* __restrict__ vb, float* __restrict__ ko,
                    float* __restrict__ vo, int L, int B, int Ta, int D, int HD) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[F_STAGES], empty[F_STAGES];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* ring = smem_raw + (((raw + 1023u) & ~1023u) - raw);  // [F_STAGES][48 KB]

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int row_tiles = (Ta + F_BM - 1) / F_BM;
  const int col_tiles = col_tiles_of(HD);
  const int n_tiles = L * B * row_tiles * col_tiles;
  const int kb_n = D / F_BK;

  if (tid == 0) {
    for (int s = 0; s < F_STAGES; ++s) {
      mbar_init(&full[s], 128 + 1);  // the producer's threads and its TMA bytes
      mbar_init(&empty[s], F_CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == F_CONSUMERS) {
    // ---------------- producer warpgroup ----------------
    // Thread pt stages rows pt / 8 + 16q (q < 8) of the slot, k values
    // 4 (pt % 8) .. + 3: eight threads read a row's 128 bytes, and the
    // swizzled 16-byte stores of a quarter-warp fall in distinct banks.
    const int pt = tid - F_CONSUMERS * 128;
    const int c4 = pt & 7, r0 = pt >> 3;
    float4 x[8];
    auto load = [&](int i, int kb) {
      const Tile t = tile_at<ODD>(i, B, row_tiles, HD, col_tiles, F_BM);
      const float* src = xa + (size_t)t.b * Ta * D + kb * F_BK + 4 * c4;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int row = t.t0 + r0 + 16 * q;
        x[q] = row < Ta ? *reinterpret_cast<const float4*>(src + (size_t)row * D)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    };
    if (blockIdx.x < n_tiles) load(blockIdx.x, 0);
    int it = 0;  // slots filled, over all tiles
    for (int i = blockIdx.x; i < n_tiles; i += gridDim.x) {
      const Tile t = tile_at<ODD>(i, B, row_tiles, HD, col_tiles, F_BM);
      const bool is_v = t.n0 >= HD;
      const CUtensorMap* wmap = is_v ? &map_vw : &map_kw;
      const int col = t.n0 - (is_v ? HD : 0);
      const int w_boxes = ODD ? t.w / 32 : BN / 32;  // 4, or 2 on an edge tile
      for (int kb = 0; kb < kb_n; ++kb, ++it) {
        const int slot = it % F_STAGES;
        if (it >= F_STAGES) mbar_wait(&empty[slot], ((it / F_STAGES) - 1) & 1);
        unsigned char* st = ring + slot * F_STAGE_BYTES;
        if (pt == 0) {
          mbar_expect_tx(&full[slot], w_boxes * F_WBOX);
#pragma unroll
          for (int j = 0; j < BN / 32; ++j)
            if (j < w_boxes)
              tma_load_3d(st + j * F_WBOX, wmap, col + 32 * j, kb * F_BK, t.l, &full[slot]);
        }
        unsigned char* xh = st + F_W_BYTES;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int row = r0 + 16 * q;
          const int off = row * 128 + ((c4 ^ (row & 7)) << 4);
          uint4 h, l;
          tf32_split(x[q].x, h.x, l.x);
          tf32_split(x[q].y, h.y, l.y);
          tf32_split(x[q].z, h.z, l.z);
          tf32_split(x[q].w, h.w, l.w);
          *reinterpret_cast<uint4*>(xh + off) = h;
          *reinterpret_cast<uint4*>(xh + F_PLANE + off) = l;
        }
        fence_view_async();  // the planes, visible to the tensor cores
        mbar_arrive(&full[slot]);
        if (kb + 1 < kb_n)  // the next slot's rows in flight
          load(i, kb + 1);
        else if (i + (int)gridDim.x < n_tiles)
          load(i + gridDim.x, 0);
      }
    }
    return;
  }

  // ---------------- consumer warpgroups: one head each ----------------
  const int ct = tid % 128;
  const int warp = ct / 32, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int H = HD / DH;
  // this warp's weight columns 64 wg + 16 warp + g (+ 8): box 2 wg + warp / 2,
  // its columns nn and nn + 8
  const int box = 2 * wg + (warp >> 1), nn = 16 * (warp & 1) + g;
  float acc[64], part[64];
  uint32_t ah[2][4], al[2][4];  // A (W^T) fragments of two k8 steps
  int it = 0;  // slots consumed, over all tiles
  for (int i = blockIdx.x; i < n_tiles; i += gridDim.x) {
    const Tile t = tile_at<ODD>(i, B, row_tiles, HD, col_tiles, F_BM);
    if (ODD && 64 * wg >= t.w) {  // an edge tile is one head: this warpgroup only
      // keeps the barriers' count (see the head of the file)
      for (int kb = 0; kb < kb_n; ++kb, ++it) {
        mbar_wait(&full[it % F_STAGES], (it / F_STAGES) & 1);
        mbar_arrive(&empty[it % F_STAGES]);
      }
      continue;
    }
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.0f;
    for (int kb = 0; kb < kb_n; ++kb, ++it) {
      const int slot = it % F_STAGES;
      mbar_wait(&full[slot], (it / F_STAGES) & 1);
      const unsigned char* st = ring + slot * F_STAGE_BYTES;
      const unsigned char* wt = st + box * F_WBOX;
      const unsigned char* xh = st + F_W_BYTES;
      fence_acc<64>(part);
#pragma unroll
      for (int s = 0; s < F_BK / 8; ++s) {
        uint32_t* h = ah[s & 1];
        uint32_t* l = al[s & 1];
        if (s >= 2) {  // the product of step s - 2 has read this set
          wgmma_wait<1>();
          keep_regs<4>(h);
          keep_regs<4>(l);
        }
        // a[0] (nn, k tg), a[1] (nn + 8, k tg), a[2] (nn, k tg + 4), a[3]
        // (nn + 8, k tg + 4) of W^T: the raw box is [k][32 columns], swizzled
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = 8 * s + tg + 4 * (e >> 1), n = nn + 8 * (e & 1);
          const float w =
              *reinterpret_cast<const float*>(wt + k * 128 + (((n >> 2) ^ (k & 7)) << 4) + (n & 3) * 4);
          tf32_split(w, h[e], l[e]);
        }
        wgmma_fence();
        wgmma_tf32_rs_n128(part, l, smem_desc(xh + 32 * s), s);  // the slot's sum from zero
        wgmma_tf32_rs_n128(part, h, smem_desc(xh + F_PLANE + 32 * s), 1);
        wgmma_tf32_rs_n128(part, h, smem_desc(xh + 32 * s), 1);
        wgmma_commit();
      }
      wgmma_wait<0>();
      keep_regs<4>(ah[0]);
      keep_regs<4>(al[0]);
      keep_regs<4>(ah[1]);
      keep_regs<4>(al[1]);
      fence_acc<64>(part);
      mbar_arrive(&empty[slot]);
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] += part[e];
    }

    // epilogue: V's bias in f32, the head split [L, B, H, Ta, 64] from
    // registers: acc[4j + e] is weight column d0 (e < 2) or d0 + 8, row
    // t0 + 8j + 2tg (+ 1 for odd e)
    const bool is_v = t.n0 >= HD;
    const int col0 = t.n0 - (is_v ? HD : 0) + 64 * wg;  // the head's first column
    const int d0 = 16 * warp + g;
    float b0 = 0.0f, b1 = 0.0f;
    if (is_v) {
      b0 = vb[(size_t)t.l * HD + col0 + d0];
      b1 = vb[(size_t)t.l * HD + col0 + d0 + 8];
    }
    float* out = (is_v ? vo : ko) + (((size_t)t.l * B + t.b) * H + col0 / DH) * Ta * DH;
#pragma unroll
    for (int j = 0; j < F_BM / 8; ++j) {
      const int r = t.t0 + 8 * j + 2 * tg;
      if (r < Ta) {
        out[(size_t)r * DH + d0] = acc[4 * j] + b0;
        out[(size_t)r * DH + d0 + 8] = acc[4 * j + 2] + b1;
      }
      if (r + 1 < Ta) {
        out[(size_t)(r + 1) * DH + d0] = acc[4 * j + 1] + b0;
        out[(size_t)(r + 1) * DH + d0 + 8] = acc[4 * j + 3] + b1;
      }
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
// all bf16, contiguous, 16-byte aligned. Needs Dh == 64 and D % 64 == 0, at
// any head count (the wrapper checks; the kernel refuses otherwise).
WDT_EXPORT int wdt_cross_kv(const void* xa, const void* kw, const void* vw,
                            const void* vb, void* k, void* v, int L, int B,
                            int Ta, int D, int H, int Dh, void* stream) {
  const int HD = H * Dh;
  if (Dh != DH || H <= 0 || D % BK != 0 || L <= 0 || B <= 0 || Ta <= 0)
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
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(cross_kv_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_BYTES),
      cudaFuncSetAttribute(cross_kv_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_BYTES)};
  const bool odd = H % 2;
  if (attr[odd] != cudaSuccess) return static_cast<int>(attr[odd]);
  const long long n_tiles = (long long)L * B * ((Ta + BM - 1) / BM) * col_tiles_of(HD);
  const int grid = static_cast<int>(n_tiles < sm_count() ? n_tiles : sm_count());
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* bias = static_cast<const bf16*>(vb);
  if (odd)
    cross_kv_kernel<true><<<grid, THREADS, SMEM_BYTES, st>>>(mx, mkw, mvw, mko, mvo, bias, L, B,
                                                             Ta, D, HD);
  else
    cross_kv_kernel<false><<<grid, THREADS, SMEM_BYTES, st>>>(mx, mkw, mvw, mko, mvo, bias, L, B,
                                                              Ta, D, HD);
  return static_cast<int>(cudaGetLastError());
}

// The f32 form: the same arguments in f32, 16-byte aligned; the same shape
// rules.
WDT_EXPORT int wdt_cross_kv_f32(const void* xa, const void* kw, const void* vw,
                                const void* vb, void* k, void* v, int L, int B,
                                int Ta, int D, int H, int Dh, void* stream) {
  const int HD = H * Dh;
  if (Dh != DH || H <= 0 || D % BK != 0 || L <= 0 || B <= 0 || Ta <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cuuint32_t box[3] = {32, F_BK, 1};  // 32 columns (128 bytes) x 32 k rows
  const cuuint64_t w_dims[3] = {(cuuint64_t)HD, (cuuint64_t)D, (cuuint64_t)L};
  const cuuint64_t w_strides[2] = {(cuuint64_t)HD * 4, (cuuint64_t)D * HD * 4};
  CUtensorMap mkw, mvw;
  if (!make_map_3d(&mkw, kw, w_dims, w_strides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32) ||
      !make_map_3d(&mvw, vw, w_dims, w_strides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(cross_kv_f32_kernel<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM),
      cudaFuncSetAttribute(cross_kv_f32_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM)};
  const bool odd = H % 2;
  if (attr[odd] != cudaSuccess) return static_cast<int>(attr[odd]);
  const long long n_tiles = (long long)L * B * ((Ta + F_BM - 1) / F_BM) * col_tiles_of(HD);
  const int grid = static_cast<int>(n_tiles < sm_count() ? n_tiles : sm_count());
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(xa);
  const auto* bias = static_cast<const float*>(vb);
  auto *ko = static_cast<float*>(k), *vo = static_cast<float*>(v);
  if (odd)
    cross_kv_f32_kernel<true><<<grid, F_THREADS, F_SMEM, st>>>(mkw, mvw, x, bias, ko, vo, L, B,
                                                               Ta, D, HD);
  else
    cross_kv_f32_kernel<false><<<grid, F_THREADS, F_SMEM, st>>>(mkw, mvw, x, bias, ko, vo, L, B,
                                                                Ta, D, HD);
  return static_cast<int>(cudaGetLastError());
}

// Tile i of K2's walk (`f32` nonzero: the f32 form's tiles) as {layer,
// stream, first row, first column of [0, 2 HD), columns, tiles in the walk}
// in out[0 .. 5]: what ops/attn.py::cross_kv_tile mirrors. Refuses a shape
// the kernels refuse and an i outside the walk.
WDT_EXPORT int wdt_cross_kv_tile(int i, int L, int B, int Ta, int H, int f32, int* out) {
  if (L <= 0 || B <= 0 || Ta <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int HD = H * DH, bm = f32 ? F_BM : BM, row_tiles = (Ta + bm - 1) / bm;
  const int ct = col_tiles_of(HD);
  const long long n = (long long)L * B * row_tiles * ct;
  if (i < 0 || i >= n || n > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const Tile t = H % 2 ? tile_at<true>(i, B, row_tiles, HD, ct, bm)
                       : tile_at<false>(i, B, row_tiles, HD, ct, bm);
  out[0] = t.l;
  out[1] = t.b;
  out[2] = t.t0;
  out[3] = t.n0;
  out[4] = t.w;
  out[5] = static_cast<int>(n);
  return static_cast<int>(cudaSuccess);
}
