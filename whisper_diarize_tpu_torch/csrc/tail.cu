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
// Layer norms use f32 statistics (biased variance, eps 1e-5, two passes:
// the mean, then the squared deviations from it); every product
// accumulates in f32 and is rounded to bf16 once, after the column scale,
// bias and GELU; the residual is added after that rounding, as in the TPU
// kernel.
//
// K6 is the same tail in the TPU kernel's int8 forms (`wq` / `kvq`, each
// independent of the other). `wq`: the five weights are int8, widened to
// bf16 as the fragments are read (exact); o / cq / co / fc1 carry one f32
// scale per output column, which multiplies the f32 accumulator before the
// bias; fc2 carries one per input row, applied to the activations as
// bf16(f32(h) * ws[row]) (pallas_tail.py:285-294, :403-414). `kvq`: the
// cross cache is int8 with per-position scales and the attention launches
// K5's kernel (`_flash_kernel_q8` numerics, pallas_tail.py:341-356).
//
// What bounds it on the H100: bytes. At N = batch x best_of rows (8..80) each
// product streams its [Din, Dout] weight once for a few dozen rows (36 MB of
// bf16 tail weights a layer at large-v3, half that in int8), plus the
// layer's cross K/V in the attention. One CTA cannot synchronise the grid,
// so the tail is a fixed sequence of six launches on one stream, issued from
// one C call: five launches of the weight-streaming skinny GEMM below and
// K1's (or K5's) attention on the plan the wrapper passes. The stacked
// [L, Din, Dout] weights are read in place: a layer is a pointer offset.
//
// The skinny GEMM (also K8's [D, 3D] product, front.cu):
// - The split. A product is cut into column strips of `bn` (32 or 64)
//   columns and each strip's input dimension into n_split spans of span_k
//   rows, one CTA each (ops/tail.py::skinny_plan picks them, a pure
//   function of (N, Din, Dout, weight type) passed from Python and checked
//   here): at large-v3 280 - 320 CTAs a product, at least two an SM, where
//   one CTA per 64 columns gave 20 - 80. All N rows (at most 80 a launch,
//   five m16 tiles on mma.sync) sit in one CTA, so each weight byte is read
//   once.
// - The combine. A strip's spans form a thread-block cluster (at most 8,
//   the portable size). Each CTA owns a share of the strip's outputs (pairs
//   of columns, pair % n_split == its rank) and pushes its f32 partial of
//   every pair into the owner's receive buffer over distributed shared
//   memory; after one cluster barrier each CTA adds the spans' partials of
//   its pairs in span order from its own shared memory, so the result does
//   not depend on timing and no CTA waits for another to leave. No atomics
//   and no workspace: the launch allocates nothing, as K1's cluster
//   combine. The epilogue (column scale, bias, GELU, one bf16 rounding,
//   residual) runs on the combined sum.
// - The copies. The span's weights stream through a ring of 3 - 4 tiles
//   of 64 rows in dynamic shared memory (the plan's `stages`: as many as
//   the shared memory of the CTAs an SM the split needs leaves; the kernel
//   takes up to 8), filled by 16-byte cp.async copies (int8: 16 weights a
//   copy, kept raw in the ring and widened when the fragments are read). Without a layer norm each
//   tile also carries the same 64 columns of the N activation rows, so a
//   CTA holds no more of them than the ring does.
// - Weights first. Weights depend on no launch of the step: a product
//   without a layer norm issues its first weight tiles before its
//   activations; one with a layer norm fetches its activations first (the
//   statistics are on its critical path) and its weights right after.
//   Programmatic dependent launch (each launch started early, its weight
//   copies issued before griddepcontrol.wait) was measured against plain
//   stream order and bought no device time (PERF.md): it is not used.
// - Activations with a layer norm (cq, fc1, K8's q/k/v). A CTA stages its
//   span of the N rows in shared memory, one bulk copy a row (and one for
//   each of ln_g and ln_b over the span), all in flight at once. The
//   statistics come without re-reading the row: each row's sum over the
//   span (every thread on a share of a row's 16-byte chunks, the shares
//   added in order), exchanged across the cluster in two rounds (the mean,
//   then the squared deviations from it: the two-pass semantics), each CTA
//   adding the spans in rank order; the span is then normalised in shared
//   memory, 8 columns a thread a step. fc2's int8 row scale is applied to
//   each streamed tile as it lands.
//
// The f32 forms (`wdt_fused_tail_f32`: f32 activations, biases, layer
// norms and cache; weights f32, or int8 widened to f32, exact, then scaled
// as above): the TPU kernel rounds every update to the activation dtype, so
// at f32 nothing is rounded. The same split, ring, layer-norm exchange and
// combine over f32 rows; the products in 3xTF32 on the tensor cores
// (mma.sync m16n8k8: common.cuh's tf32_split, hi = tf32(x), lo =
// tf32(x - hi); a product lo hi' + hi lo' + hi hi'; int8 weights are exact
// in TF32, lo = 0, so two: a_lo w + a_hi w). What held the FFMA form back
// (0.31 ms of K3-f32's 0.37 at N 40, 14x its bytes' time): one column a
// thread, a branch a row, dependent FMA chains and two warps a scheduler.
// Design:
// - A warp takes 32 columns of the strip (four n8 blocks) and a share of
//   every ring tile's rows: rows 16w .. 16w + 15 (two k8 steps) of a 32-column
//   strip, or 32 of them (two such 16-row groups) of a 64-column one. Each
//   weight is read and split once a CTA, by one warp, in registers as its
//   fragment loads, and then serves every m16 row tile (up to five); each
//   activation is split by the one warp (32 columns) or two (64) that read
//   it, with no copy of the tile in shared memory.
// - The k index of each 8-wide step is permuted in both operands (slot tg
//   <-> k 2tg, slot tg + 4 <-> k 2tg + 1) and the n8 blocks interleaved
//   (block 2p + h, lane g <-> column 16p + 2g + h), so every fragment read
//   is one float2 (int8: two bytes) and a thread's outputs of a row are
//   four adjacent columns. A tile's activation rows are padded to 72
//   floats, so the float2 reads of eight rows fall in distinct banks (a
//   layer norm's span rows, span_k + 4, two to a bank); weight rows to 36
//   floats (48 int8 bytes), distinct banks.
// - The tensor cores' accumulation truncates (K1-f32, cross_attn.cu,
//   tf32x3_pv): each 16-row group's products start from zero and are added
//   to the warp's f32 partial on the CUDA cores, tile by tile in order; the
//   warps sharing a chunk add their partials in warp order, the spans in
//   the cluster's span order (`agreement.skinny_tf32x3_model` is this order
//   on the CPU).
// The attention is K1's f32 form (K5's with `kvq`). At N 40 the f32 tail
// moves a layer's weights, 11 D^2 = 18.0 M floats (72 MB, 0.0215 ms at
// 3.35 TB/s), plus 123 MB of f32 cross cache at B 8; the products are
// 3 x 2 N 11 D^2 = 4.3 GFLOP at the TF32 rate.
#include "common.cuh"

#include <cooperative_groups.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int BK = 64;         // weight rows a ring tile
constexpr int THREADS = 128;   // 4 warps
constexpr int MAX_ROWS = 80;   // rows a launch: five m16 tiles
constexpr int MAX_SPLIT = 8;   // portable cluster size
constexpr int SMEM_MAX = 200 * 1024;  // dynamic shared memory a CTA may take

template <typename WT>
__host__ __device__ constexpr bool is_q8() { return std::is_same<WT, int8_t>::value; }

// bytes of one staged weight row: padded by 16 bytes (bf16: ldmatrix reads
// of eight rows fall in distinct banks; int8: the fragments' byte reads of
// four rows do)
template <typename WT, int BN>
__host__ __device__ constexpr int wrow_bytes() { return BN * static_cast<int>(sizeof(WT)) + 16; }

// One activation row of a streamed tile: 64 values padded by 8 (72 bf16,
// 144 bytes: the ldmatrix reads of eight rows fall in distinct banks; 72
// f32, 288 bytes: so do the float2 fragment reads). A row of a layer
// norm's staged span keeps its 16 bytes (span_k + 4 f32: the f32 float2
// reads of a half-warp's four rows meet two to a bank; 32 bytes would cost
// the f32 plans their second CTA an SM at some row counts).
constexpr int ROW_PAD = 8;
template <typename AT>
__host__ __device__ constexpr int at_row() { return BK + ROW_PAD; }
constexpr int AT_ROW = at_row<bf16>();  // the bf16 rows the mma reads (and its zero row)

// Dynamic shared memory of one CTA, in order: with a layer norm (LN), the
// activations' whole span (rows 0 .. N - 1 and a zero row N, each span_k
// values and 16 bytes) and ln_g / ln_b over the span; the combine's receive
// buffer (every span's share of this CTA's pairs of outputs, f32); the ring,
// each tile the weights' 64 rows and, without a layer norm, the same 64
// columns of the N activation rows.
__host__ __device__ inline int recv_bytes(int rows, int bn) { return (rows * bn / 2 + 8) * 8; }

template <typename AT, typename WT, int BN, bool LN>
__host__ __device__ inline int tile_bytes(int rows) {
  return BK * wrow_bytes<WT, BN>() +
         (LN ? 0 : rows * at_row<AT>() * static_cast<int>(sizeof(AT)));
}

template <typename AT, typename WT, int BN, bool LN>
__host__ __device__ inline int smem_bytes(int rows, int span_k, int stages) {
  constexpr int ES = sizeof(AT);
  return (LN ? (rows + 1) * (span_k * ES + 16) + 2 * ES * span_k : 0) + recv_bytes(rows, BN) +
         stages * tile_bytes<AT, WT, BN, LN>(rows);
}

// Issue one ring tile's copies, 16 bytes a copy: (w != nullptr) the
// weights' rows 0 .. 63 of the span's strip (row stride ld_w elements), and
// (rows > 0) columns 0 .. 63 of `rows` activation rows (row stride ld_a).
template <typename AT, typename WT, int BN>
__device__ __forceinline__ void stage_tile(const WT* w, int ld_w, const AT* a, int ld_a,
                                           int rows, unsigned char* dst, int tid) {
  constexpr int CH = BN * static_cast<int>(sizeof(WT)) / 16;  // copies a row
  constexpr int EPC = 16 / static_cast<int>(sizeof(AT));       // values a copy
  if (w != nullptr) {
#pragma unroll
    for (int i = tid; i < BK * CH; i += THREADS) {
      const int r = i / CH, c = i % CH;
      cp_async<16>(dst + r * wrow_bytes<WT, BN>() + c * 16,
                   reinterpret_cast<const unsigned char*>(w + (size_t)r * ld_w) + c * 16, true);
    }
  }
  AT* at = reinterpret_cast<AT*>(dst + BK * wrow_bytes<WT, BN>());
  for (int i = tid; i < rows * (BK / EPC); i += THREADS) {
    const int r = i / (BK / EPC), c = i % (BK / EPC);
    cp_async<16>(at + r * at_row<AT>() + c * EPC, a + (size_t)r * ld_a + c * EPC, true);
  }
}

// wait until at most n (a runtime value, 0 .. 7) of this thread's committed
// copy groups are in flight
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// The f32 sums of each row of the span (of (x - mean[r])^2 where `mean`)
// over the cluster's spans, in span order: S threads a row sum 16-byte
// chunks (a pair of values at a time), their partials add in order, then
// every span's row sum is read over distributed shared memory (all at once)
// and added in rank order.
template <typename AT>
__device__ __forceinline__ void cluster_row_sums(cg::cluster_group& cluster, const AT* as,
                                                 int AROW, int N, int kc, const float* mean,
                                                 float* red, float* part, float* out, int tid,
                                                 int n_split, float scale) {
  constexpr int EPC = 16 / static_cast<int>(sizeof(AT));
  const int S = THREADS / N > 0 ? THREADS / N : 1;
  if (tid < N * S) {
    const int r = tid / S, s = tid % S;
    const float mu = mean ? mean[r] : 0.0f;
    float acc = 0.0f;
#pragma unroll 4
    for (int c = s; c < kc / EPC; c += S) {
      float f[EPC];
      chunk_floats(*reinterpret_cast<const uint4*>(as + r * AROW + c * EPC), f, as);
#pragma unroll
      for (int e = 0; e < EPC; e += 2) {
        if (mean) {
          acc = fmaf(f[e] - mu, f[e] - mu, acc);
          acc = fmaf(f[e + 1] - mu, f[e + 1] - mu, acc);
        } else {
          acc += f[e] + f[e + 1];
        }
      }
    }
    red[tid] = acc;
  }
  __syncthreads();
  if (tid < N) {
    float t = 0.0f;
    for (int s = 0; s < S; ++s) t += red[tid * S + s];
    part[tid] = t;
  }
  cluster.sync();
  if (tid < N) {
    float v[MAX_SPLIT];
#pragma unroll
    for (int sp = 0; sp < MAX_SPLIT; ++sp)
      if (sp < n_split) v[sp] = *cluster.map_shared_rank(&part[tid], sp);
    float t = 0.0f;
#pragma unroll
    for (int sp = 0; sp < MAX_SPLIT; ++sp)
      if (sp < n_split) t += v[sp];
    out[tid] = t * scale;
  }
  __syncthreads();
}

// out[N, Dout] = epi(pro(A)[N, Din] @ W[Din, Dout]); A and out bf16 or f32
// (AT), W AT or int8 (WT)
//   pro: LN -> round((a - mean) * rstd * g + b), f32 statistics;
//        row_scale != nullptr -> round(f32(a) * row_scale[k]) (per input row)
//   epi: y = acc (* col_scale[col]) + bias; gelu -> gelu_tanh(y); o = round(y);
//        residual != nullptr -> o = round(residual + o)
// (round: to AT; the identity at f32). bf16: mma.sync products; f32:
// 3xTF32 mma.sync.
// Grid (n_split, Dout / BN), cluster (n_split, 1, 1): blockIdx.x is the
// CTA's span of the input dimension, blockIdx.y its column strip.
template <typename AT, typename WT, int BN, bool LN>
__global__ void __launch_bounds__(THREADS)
skinny_gemm_kernel(const AT* __restrict__ A, const WT* __restrict__ W,
                   const float* __restrict__ col_scale,
                   const float* __restrict__ row_scale,
                   const AT* __restrict__ bias,
                   const AT* __restrict__ residual,
                   const AT* __restrict__ ln_g, const AT* __restrict__ ln_b,
                   AT* __restrict__ out, int N, int Din, int Dout, int gelu, int span_k,
                   int n_stages) {
  constexpr bool kQ8 = is_q8<WT>();
  constexpr bool kF32 = std::is_same<AT, float>::value;
  constexpr int ES = sizeof(AT);
  constexpr int EPC = 16 / ES;           // values a 16-byte chunk
  constexpr int ATR = at_row<AT>();
  constexpr int WROW = wrow_bytes<WT, BN>();
  // bf16: 16-column chunks, one a warp; f32: 32-column chunks
  constexpr int NCH = kF32 ? BN / 32 : BN / 16;
  constexpr int KSPLIT = 4 / NCH;  // warps sharing a chunk, over the tile's rows
  constexpr int KG = 4 / KSPLIT;   // f32: 16-row groups of a tile a warp takes
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[THREADS], psum[MAX_ROWS], psq[MAX_ROWS], mean_s[MAX_ROWS],
      var_s[MAX_ROWS];
  __shared__ __align__(16) bf16 zero_row[AT_ROW];  // what the mma reads for rows >= N
  __shared__ __align__(8) uint64_t abar;  // the layer norm's span: its bulk copies

  cg::cluster_group cluster = cg::this_cluster();
  const int n_split = gridDim.x;
  const int rank = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  const int k0 = rank * span_k;
  const int kc = min(span_k, Din - k0);  // this span's rows (a multiple of BK)
  const int n_tiles = kc / BK;
  const int AROW = span_k + EPC;         // LN: a row of the staged span
  const int TILE = tile_bytes<AT, WT, BN, LN>(N);
  AT* as = reinterpret_cast<AT*>(smem);                      // LN: the span
  unsigned char* cparam = smem + (N + 1) * AROW * ES;        // LN: ln_g | ln_b
  float* recv = reinterpret_cast<float*>(LN ? cparam + 2 * ES * span_k : smem);
  unsigned char* ring = reinterpret_cast<unsigned char*>(recv) + recv_bytes(N, BN);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const WT* wb = W + (size_t)k0 * Dout + n0;
  const AT* ab = A + k0;
  const AT* tag = nullptr;  // selects the overloads for AT

  if (tid < AT_ROW / 8) reinterpret_cast<uint4*>(zero_row)[tid] = make_uint4(0u, 0u, 0u, 0u);
  if (LN && tid == 0) {
    mbar_init(&abar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // this CTA has started (distributed shared memory may be read or written
  // only in CTAs that have); the matching wait is below
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  if constexpr (LN) {
    // the span of the N rows and ln_g / ln_b over it: bulk copies, all in
    // flight at once (warp 0 issues them); then the first weight tiles
    if (warp == 0) {
      if (lane == 0) mbar_expect_tx(&abar, N * kc * ES + 2 * kc * ES);
      __syncwarp();
      for (int r = lane; r < N; r += 32)
        bulk_load(as + r * AROW, ab + (size_t)r * Din, kc * ES, &abar);
      if (lane == 0) {
        bulk_load(cparam, ln_g + k0, kc * ES, &abar);
        bulk_load(cparam + ES * span_k, ln_b + k0, kc * ES, &abar);
      }
    }
    for (int s = 0; s < n_stages - 1; ++s) {
      if (s < n_tiles)
        stage_tile<AT, WT, BN>(wb + (size_t)s * BK * Dout, Dout, nullptr, 0, 0,
                               ring + s * TILE, tid);
      cp_async_commit();
    }
    for (int c = tid * EPC; c < kc; c += THREADS * EPC)
      *reinterpret_cast<uint4*>(as + N * AROW + c) = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();  // the barrier's init and the zero row, seen by all
    mbar_wait(&abar, 0);
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every CTA has started
    // the statistics in two rounds: the mean, then the squared deviations
    cluster_row_sums(cluster, as, AROW, N, kc, nullptr, red, psum, mean_s, tid, n_split,
                     1.0f / Din);
    cluster_row_sums(cluster, as, AROW, N, kc, mean_s, red, psq, var_s, tid, n_split,
                     1.0f / Din);
    // normalise the span in place, a 16-byte chunk a thread a step
    const AT* gs = reinterpret_cast<const AT*>(cparam);
    const AT* bs = gs + span_k;
    const int cn = kc / EPC;
#pragma unroll 4
    for (int i = tid; i < N * cn; i += THREADS) {
      const int r = i / cn, c = (i % cn) * EPC;
      float x[EPC], gf[EPC], bf[EPC];
      chunk_floats(*reinterpret_cast<const uint4*>(as + r * AROW + c), x, tag);
      chunk_floats(*reinterpret_cast<const uint4*>(gs + c), gf, tag);
      chunk_floats(*reinterpret_cast<const uint4*>(bs + c), bf, tag);
      const float mu = mean_s[r], rs = rsqrtf(var_s[r] + 1e-5f);
#pragma unroll
      for (int e = 0; e < EPC; ++e) x[e] = (x[e] - mu) * rs * gf[e] + bf[e];
      *reinterpret_cast<uint4*>(as + r * AROW + c) = floats_chunk(x, tag);
    }
    __syncthreads();
  } else {
    // the weights of the first n_stages - 1 tiles, one group a tile, then
    // their activations, one group
    for (int s = 0; s < n_stages - 1; ++s) {
      if (s < n_tiles)
        stage_tile<AT, WT, BN>(wb + (size_t)s * BK * Dout, Dout, nullptr, 0, 0,
                               ring + s * TILE, tid);
      cp_async_commit();
    }
    for (int s = 0; s < n_stages - 1 && s < n_tiles; ++s)
      stage_tile<AT, WT, BN>(nullptr, 0, ab + s * BK, Din, N, ring + s * TILE, tid);
    cp_async_commit();
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every CTA has started
  }

  // bf16: warp w takes the 16 columns of chunk w % NCH and the k16 steps
  // kq, kq + KSPLIT, .. of every tile (kq = w / NCH); acc[mt][nb] is m16
  // tile mt, n8 block nb of its chunk. f32: warp w takes the 32 columns of
  // chunk w % NCH and the KG 16-row groups (two k8 steps each) of every
  // tile from row 16 KG kq; facc[mt][nb] is its f32 partial of m16 tile mt,
  // n8 block nb (block 2p + h, lane g: column 32 chunk + 16p + 2g + h).
  const int chunk = warp % NCH, kq = warp / NCH;
  const int MT = (N + 15) / 16;
  float acc[kF32 ? 1 : MAX_ROWS / 16][2][4];
  float facc[kF32 ? MAX_ROWS / 16 : 1][4][4];
#pragma unroll
  for (int mt = 0; mt < (kF32 ? 1 : MAX_ROWS / 16); ++mt)
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nb][e] = 0.0f;
#pragma unroll
  for (int mt = 0; mt < (kF32 ? MAX_ROWS / 16 : 1); ++mt)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) facc[mt][nb][e] = 0.0f;

  for (int j = 0; j < n_tiles; ++j) {
    // wait for tile j: its group is the (n_stages - 2)-th newest; without a
    // layer norm the first tiles' activations are one group after all the
    // prologue's weights, the j-th newest
    cp_async_wait_n(!LN && j < n_stages - 1 ? j : n_stages - 2);
    __syncthreads();  // everyone's copies landed; tile j - 1 consumed
    {
      const int nj = j + n_stages - 1;  // refill the tile j - 1 used
      if (nj < n_tiles)
        stage_tile<AT, WT, BN>(wb + (size_t)nj * BK * Dout, Dout, ab + nj * BK, Din,
                               LN ? 0 : N, ring + (nj % n_stages) * TILE, tid);
      cp_async_commit();
    }
    unsigned char* st = ring + (j % n_stages) * TILE;
    AT* at = reinterpret_cast<AT*>(st + BK * WROW);  // !LN: the tile's activations
    if (!LN && row_scale != nullptr) {  // fc2's int8 scale, per input row
      for (int i = tid; i < N * (BK / EPC); i += THREADS) {
        const int r = i / (BK / EPC), c = (i % (BK / EPC)) * EPC;
        float x[EPC];
        chunk_floats(*reinterpret_cast<const uint4*>(at + r * ATR + c), x, tag);
        const float* rsc = row_scale + k0 + j * BK + c;
#pragma unroll
        for (int e = 0; e < EPC; ++e) x[e] *= rsc[e];
        *reinterpret_cast<uint4*>(at + r * ATR + c) = floats_chunk(x, tag);
      }
      __syncthreads();
    }
    if constexpr (kF32) {
      const float* a_src = reinterpret_cast<const float*>(LN ? as + j * BK : at);
      const int a_stride = LN ? AROW : ATR;
#pragma unroll
      for (int gi = 0; gi < KG; ++gi) {
        const int k16 = 16 * (KG * kq + gi);  // the group's first row of the tile
        // its two k8 steps of the weights, split once: bh / bl[s][nb] {k
        // slot tg, k slot tg + 4} (int8: exact in TF32, no lo)
        uint32_t bh[2][4][2], bl[2][4][2];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int kr = k16 + 8 * s + 2 * tg;  // rows kr, kr + 1 of the tile
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            float w[2][2];  // [row][column 32 chunk + 16p + 2g + h]
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const unsigned char* src =
                  st + (kr + rr) * WROW + (32 * chunk + 16 * p + 2 * g) * sizeof(WT);
              if constexpr (kQ8) {
                const char2 c2 = *reinterpret_cast<const char2*>(src);
                w[rr][0] = static_cast<float>(c2.x);
                w[rr][1] = static_cast<float>(c2.y);
              } else {
                const float2 f2 = *reinterpret_cast<const float2*>(src);
                w[rr][0] = f2.x;
                w[rr][1] = f2.y;
              }
            }
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int rr = 0; rr < 2; ++rr) {
                if constexpr (kQ8) {
                  bh[s][2 * p + h][rr] = __float_as_uint(w[rr][h]);
                  bl[s][2 * p + h][rr] = 0u;
                } else {
                  tf32_split(w[rr][h], bh[s][2 * p + h][rr], bl[s][2 * p + h][rr]);
                }
              }
          }
        }
#pragma unroll
        for (int mt = 0; mt < MAX_ROWS / 16; ++mt) {
          if (mt >= MT) continue;
          const int r0 = 16 * mt + g, r1 = r0 + 8;
          float t[4][4];  // the group's products, from zero
#pragma unroll
          for (int nb = 0; nb < 4; ++nb) t[nb][0] = t[nb][1] = t[nb][2] = t[nb][3] = 0.0f;
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const int kc2 = k16 + 8 * s + 2 * tg;
            const float2 zero = make_float2(0.0f, 0.0f);
            const float2 x0 =
                r0 < N ? *reinterpret_cast<const float2*>(a_src + r0 * a_stride + kc2) : zero;
            const float2 x1 =
                r1 < N ? *reinterpret_cast<const float2*>(a_src + r1 * a_stride + kc2) : zero;
            uint32_t ah[4], al[4];  // rows g / g + 8, k slots tg / tg + 4
            tf32_split(x0.x, ah[0], al[0]);
            tf32_split(x1.x, ah[1], al[1]);
            tf32_split(x0.y, ah[2], al[2]);
            tf32_split(x1.y, ah[3], al[3]);
#pragma unroll
            for (int nb = 0; nb < 4; ++nb) {
              if constexpr (kQ8) {  // w exact in TF32: a_lo w + a_hi w
                mma_tf32(t[nb], al, bh[s][nb][0], bh[s][nb][1]);
                mma_tf32(t[nb], ah, bh[s][nb][0], bh[s][nb][1]);
              } else {
                mma_tf32x3(t[nb], ah, al, bh[s][nb][0], bh[s][nb][1], bl[s][nb][0],
                           bl[s][nb][1]);
              }
            }
          }
#pragma unroll
          for (int nb = 0; nb < 4; ++nb)
#pragma unroll
            for (int e = 0; e < 4; ++e) facc[mt][nb][e] += t[nb][e];
        }
      }
    } else {
#pragma unroll
      for (int kk = kq; kk < BK / 16; kk += KSPLIT) {
        uint32_t b[2][2];
        if constexpr (kQ8) {  // int8 -> bf16 pairs (exact), rows 2tg, 2tg + 1 (+ 8)
#pragma unroll
          for (int nb = 0; nb < 2; ++nb) {
            const int8_t* p = reinterpret_cast<const int8_t*>(st) + (kk * 16 + 2 * tg) * WROW +
                              chunk * 16 + nb * 8 + g;
            b[nb][0] = pack_bf16(static_cast<float>(p[0]), static_cast<float>(p[WROW]));
            b[nb][1] = pack_bf16(static_cast<float>(p[8 * WROW]), static_cast<float>(p[9 * WROW]));
          }
        } else {
          uint32_t r4[4];
          const int row = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
          ldsm_x4_trans(r4, reinterpret_cast<const bf16*>(st + row * WROW) + chunk * 16 +
                                (lane >> 4) * 8);
          b[0][0] = r4[0];
          b[0][1] = r4[1];
          b[1][0] = r4[2];
          b[1][1] = r4[3];
        }
        const int kcol = kk * 16 + (lane >> 4) * 8;  // within the tile
#pragma unroll
        for (int mt = 0; mt < MAX_ROWS / 16; ++mt) {
          if (mt < MT) {
            const int r = mt * 16 + (lane & 15);
            const bf16* src =
                LN ? reinterpret_cast<const bf16*>(as) + min(r, N) * AROW + j * BK + kcol  // row N: zeros
                   : (r < N ? reinterpret_cast<const bf16*>(at) + r * AT_ROW + kcol
                            : zero_row + kcol);
            uint32_t a[4];
            ldsm_x4(a, src);
            mma_bf16(acc[mt][0], a, b[0][0], b[0][1]);
            mma_bf16(acc[mt][1], a, b[1][0], b[1][1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the CTA's partial [N, BN]

  float* part = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int q = 0; q < KSPLIT; ++q) {  // the k-split warps' sums, in warp order
    if (kq == q) {
#pragma unroll
      for (int mt = 0; mt < MAX_ROWS / 16; ++mt) {
        if (mt >= MT) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mt * 16 + g + 8 * h;
          if (r >= N) continue;
          if constexpr (kF32) {  // columns 32 chunk + 16p + 4tg .. + 3 (interleaved n8 blocks)
#pragma unroll
            for (int p = 0; p < 2; ++p) {
              float4* dst =
                  reinterpret_cast<float4*>(part + r * BN + 32 * chunk + 16 * p + 4 * tg);
              float4 v = make_float4(facc[mt][2 * p][2 * h], facc[mt][2 * p + 1][2 * h],
                                     facc[mt][2 * p][2 * h + 1], facc[mt][2 * p + 1][2 * h + 1]);
              if (q > 0) {
                const float4 o = *dst;
                v.x += o.x;
                v.y += o.y;
                v.z += o.z;
                v.w += o.w;
              }
              *dst = v;
            }
          } else {
#pragma unroll
            for (int nb = 0; nb < 2; ++nb) {
              const int c = chunk * 16 + nb * 8 + 2 * tg;
              float2* p = reinterpret_cast<float2*>(part + r * BN + c);
              float2 v = make_float2(acc[mt][nb][2 * h], acc[mt][nb][2 * h + 1]);
              if (q > 0) {
                v.x += p->x;
                v.y += p->y;
              }
              *p = v;
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // the combine: pair p of (row, 2 columns) belongs to the CTA of rank
  // p % n_split; every CTA pushes its partial of each pair into the owner's
  // receive buffer (slot [its rank][p / n_split]) over distributed shared
  // memory, then one cluster barrier: after it each CTA reads only its own
  // shared memory, so none waits for another to leave
  const int pairs = N * (BN / 2);
  const int per = (pairs + n_split - 1) / n_split;
  for (int p = tid; p < pairs; p += THREADS) {
    float2* dst = reinterpret_cast<float2*>(
        cluster.map_shared_rank(recv + 2 * (rank * per + p / n_split), p % n_split));
    *dst = *reinterpret_cast<const float2*>(part + 2 * p);
  }
  cluster.sync();  // every span's partial of this CTA's pairs is in its buffer

  for (int i = tid; i < per; i += THREADS) {
    const int pr = i * n_split + rank;
    if (pr >= pairs) break;
    const int r = pr / (BN / 2), c = (pr % (BN / 2)) * 2;
    float y0 = 0.0f, y1 = 0.0f;
    for (int sp = 0; sp < n_split; ++sp) {  // the spans in order
      const float2 v = *reinterpret_cast<const float2*>(recv + 2 * (sp * per + i));
      y0 += v.x;
      y1 += v.y;
    }
    const int col = n0 + c;
    if (col_scale != nullptr) {
      y0 *= col_scale[col];
      y1 *= col_scale[col + 1];
    }
    const float2 bb = load2(bias + col);
    y0 += bb.x;
    y1 += bb.y;
    if (gelu) {
      y0 = gelu_tanh(y0);
      y1 = gelu_tanh(y1);
    }
    y0 = round_to(y0, tag);
    y1 = round_to(y1, tag);
    const size_t o = (size_t)r * Dout + col;
    if (residual != nullptr) {
      const float2 rr = load2(residual + o);
      y0 += rr.x;
      y1 += rr.y;
    }
    store2(out + o, y0, y1);
  }
}

template <typename AT, typename WT, int BN>
bool fits(int rows, int span_k, int stages, bool ln) {
  // the CTA's partial [rows, BN] f32 lives in the ring once the loop is done
  const int ring = stages * (ln ? tile_bytes<AT, WT, BN, true>(rows)
                                : tile_bytes<AT, WT, BN, false>(rows));
  const int smem = ln ? smem_bytes<AT, WT, BN, true>(rows, span_k, stages)
                      : smem_bytes<AT, WT, BN, false>(rows, span_k, stages);
  return ring >= rows * BN * 4 && smem <= SMEM_MAX;
}

// the plan checked against the shape (ops/tail.py::skinny_plan's rules)
template <typename AT, typename WT>
bool plan_ok(int rows, int Din, int Dout, bool ln, SkinnyPlan p) {
  if ((p.bn != 32 && p.bn != 64) || Dout % p.bn != 0 || Din % BK != 0 || p.span_k <= 0 ||
      p.span_k % BK != 0 || p.n_split < 1 || p.n_split > MAX_SPLIT ||
      (long long)p.n_split * p.span_k < Din || (long long)(p.n_split - 1) * p.span_k >= Din ||
      p.stages < 3 || p.stages > 8)
    return false;
  return p.bn == 32 ? fits<AT, WT, 32>(rows, p.span_k, p.stages, ln)
                    : fits<AT, WT, 64>(rows, p.span_k, p.stages, ln);
}

template <typename AT, typename WT, int BN, bool LN>
cudaError_t launch_bn(const AT* A, const WT* W, const float* col_scale,
                      const float* row_scale, const AT* bias, const AT* residual,
                      const AT* ln_g, const AT* ln_b, AT* out, int N, int Din,
                      int Dout, int gelu, SkinnyPlan p, cudaStream_t stream) {
  auto kern = skinny_gemm_kernel<AT, WT, BN, LN>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (attr != cudaSuccess) return attr;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = p.n_split;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.n_split, Dout / BN, 1);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes<AT, WT, BN, LN>(N, p.span_k, p.stages);
  cfg.stream = stream;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, A, W, col_scale, row_scale, bias, residual, ln_g,
                            ln_b, out, N, Din, Dout, gelu, p.span_k, p.stages);
}

template <typename AT, typename WT>
cudaError_t launch_plan(const AT* A, const WT* W, const float* col_scale,
                        const float* row_scale, const AT* bias, const AT* residual,
                        const AT* ln_g, const AT* ln_b, AT* out, int N, int Din,
                        int Dout, int gelu, SkinnyPlan p, cudaStream_t stream) {
  const bool ln = ln_g != nullptr;
  if (p.bn == 32)
    return ln ? launch_bn<AT, WT, 32, true>(A, W, col_scale, row_scale, bias, residual, ln_g,
                                            ln_b, out, N, Din, Dout, gelu, p, stream)
              : launch_bn<AT, WT, 32, false>(A, W, col_scale, row_scale, bias, residual, ln_g,
                                             ln_b, out, N, Din, Dout, gelu, p, stream);
  return ln ? launch_bn<AT, WT, 64, true>(A, W, col_scale, row_scale, bias, residual, ln_g,
                                          ln_b, out, N, Din, Dout, gelu, p, stream)
            : launch_bn<AT, WT, 64, false>(A, W, col_scale, row_scale, bias, residual, ln_g,
                                           ln_b, out, N, Din, Dout, gelu, p, stream);
}

// One product on the plan; N > MAX_ROWS rows go in launches of MAX_ROWS.
template <typename AT, typename WT>
cudaError_t skinny_gemm(const AT* A, const WT* W, const float* col_scale,
                        const float* row_scale, const AT* bias, const AT* residual,
                        const AT* ln_g, const AT* ln_b, AT* out, int N, int Din,
                        int Dout, int gelu, SkinnyPlan p, cudaStream_t stream) {
  if (N <= 0 || (ln_g != nullptr && row_scale != nullptr) ||
      !plan_ok<AT, WT>(N < MAX_ROWS ? N : MAX_ROWS, Din, Dout, ln_g != nullptr, p))
    return cudaErrorInvalidValue;
  for (int r0 = 0; r0 < N; r0 += MAX_ROWS) {
    const int rows = N - r0 < MAX_ROWS ? N - r0 : MAX_ROWS;
    const cudaError_t err = launch_plan(
        A + (size_t)r0 * Din, W, col_scale, row_scale, bias,
        residual ? residual + (size_t)r0 * Dout : nullptr, ln_g, ln_b,
        out + (size_t)r0 * Dout, rows, Din, Dout, gelu, p, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// the tail's attention: K1 over a bf16 / f32 cache, K5 over int8 (ks != nullptr)
cudaError_t tail_attention(const bf16* cq, const void* k, const void* v, const float* ks,
                           const float* vs, bf16* att, int Bc, int beams, int H, int Ta,
                           int layer, int ta_total, int n_span, int span_keys,
                           cudaStream_t stream) {
  return ks != nullptr
             ? launch_cross_attn_q8(cq, static_cast<const int8_t*>(k), ks,
                                    static_cast<const int8_t*>(v), vs, att, Bc, beams, H, Ta,
                                    layer, ta_total, n_span, span_keys, stream)
             : launch_cross_attn(cq, static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                                 att, Bc, beams, H, Ta, layer, ta_total, n_span, span_keys,
                                 stream);
}

cudaError_t tail_attention(const float* cq, const void* k, const void* v, const float* ks,
                           const float* vs, float* att, int Bc, int beams, int H, int Ta,
                           int layer, int ta_total, int n_span, int span_keys,
                           cudaStream_t stream) {
  return ks != nullptr
             ? launch_cross_attn_q8_f32(cq, static_cast<const int8_t*>(k), ks,
                                        static_cast<const int8_t*>(v), vs, att, Bc, beams, H,
                                        Ta, layer, ta_total, n_span, span_keys, stream)
             : launch_cross_attn_f32(cq, static_cast<const float*>(k),
                                     static_cast<const float*>(v), att, Bc, beams, H, Ta, layer,
                                     ta_total, n_span, span_keys, stream);
}

// The five projections of one layer's tail, over AT or int8 weights.
// Scales (int8 only): o_ws, cq_ws, co_ws, fc1_ws [L, Dout] per output
// column, fc2_ws [L, 4D] per input row; layer picked by pointer offset.
// plan[0..4]: the splits of o, cq, co, fc1, fc2.
template <typename AT, typename WT>
cudaError_t tail_layer(const AT* x, const AT* self_out, const WT* o_w,
                       const WT* cq_w, const WT* co_w, const WT* fc1_w,
                       const WT* fc2_w, const float* o_ws, const float* cq_ws,
                       const float* co_ws, const float* fc1_ws, const float* fc2_ws,
                       const AT* o_b, const AT* ln2_g, const AT* ln2_b,
                       const AT* cq_b, const AT* co_b, const AT* ln3_g,
                       const AT* ln3_b, const AT* fc1_b, const AT* fc2_b,
                       const void* k, const void* v, const float* ks, const float* vs,
                       AT* x1, AT* cq, AT* att, AT* x2, AT* h4, AT* out,
                       int layer, int N, int D, int H, int Bc, int beams, int Ta,
                       int ta_total, int n_span, int span_keys, const SkinnyPlan* plan,
                       cudaStream_t stream) {
  const size_t l = static_cast<size_t>(layer);
  const size_t dd = static_cast<size_t>(D) * D;
  const size_t d4 = static_cast<size_t>(D) * 4 * D;
  const size_t d = static_cast<size_t>(D);
  auto S = [l](const float* p, size_t n) { return p ? p + l * n : nullptr; };
  const AT* none = nullptr;
  cudaError_t err;
  if ((err = skinny_gemm(self_out, o_w + l * dd, S(o_ws, d), nullptr, o_b + l * d, x,
                         none, none, x1, N, D, D, 0, plan[0], stream)) != cudaSuccess)
    return err;
  if ((err = skinny_gemm(x1, cq_w + l * dd, S(cq_ws, d), nullptr, cq_b + l * d, none,
                         ln2_g + l * d, ln2_b + l * d, cq, N, D, D, 0, plan[1], stream)) !=
      cudaSuccess)
    return err;
  if ((err = tail_attention(cq, k, v, ks, vs, att, Bc, beams, H, Ta, layer, ta_total, n_span,
                            span_keys, stream)) != cudaSuccess)
    return err;
  if ((err = skinny_gemm(att, co_w + l * dd, S(co_ws, d), nullptr, co_b + l * d, x1,
                         none, none, x2, N, D, D, 0, plan[2], stream)) != cudaSuccess)
    return err;
  if ((err = skinny_gemm(x2, fc1_w + l * d4, S(fc1_ws, 4 * d), nullptr, fc1_b + l * 4 * d,
                         none, ln3_g + l * d, ln3_b + l * d, h4, N, D, 4 * D, 1, plan[3],
                         stream)) != cudaSuccess)
    return err;
  return skinny_gemm(h4, fc2_w + l * d4, nullptr, S(fc2_ws, 4 * d), fc2_b + l * d, x2,
                     none, none, out, N, 4 * D, D, 0, plan[4], stream);
}

// wdt_fused_tail(_f32)'s body for activations AT: int8 weights where o_ws
// is given, else AT
template <typename AT>
int fused_tail(
    const void* x, const void* self_out, const void* o_w, const void* o_b,
    const void* ln2_g, const void* ln2_b, const void* cq_w, const void* cq_b,
    const void* co_w, const void* co_b, const void* ln3_g, const void* ln3_b,
    const void* fc1_w, const void* fc1_b, const void* fc2_w, const void* fc2_b,
    const void* k, const void* v, void* x1, void* cq, void* att, void* x2,
    void* h4, void* out, const void* o_ws, const void* cq_ws,
    const void* co_ws, const void* fc1_ws, const void* fc2_ws, const void* ks,
    const void* vs, int layer, int N, int D, int H, int Bc, int beams, int Ta,
    int ta_total, int n_span, int span_keys, const SkinnyPlan* plan, cudaStream_t stream) {
  auto P = [](const void* p) { return static_cast<const AT*>(p); };
  auto F = [](const void* p) { return static_cast<const float*>(p); };
  auto O = [](void* p) { return static_cast<AT*>(p); };
  cudaError_t err;
  if (o_ws != nullptr) {
    auto Q = [](const void* p) { return static_cast<const int8_t*>(p); };
    err = tail_layer(P(x), P(self_out), Q(o_w), Q(cq_w), Q(co_w), Q(fc1_w), Q(fc2_w),
                     F(o_ws), F(cq_ws), F(co_ws), F(fc1_ws), F(fc2_ws), P(o_b),
                     P(ln2_g), P(ln2_b), P(cq_b), P(co_b), P(ln3_g), P(ln3_b),
                     P(fc1_b), P(fc2_b), k, v, F(ks), F(vs), O(x1), O(cq), O(att),
                     O(x2), O(h4), O(out), layer, N, D, H, Bc, beams, Ta, ta_total,
                     n_span, span_keys, plan, stream);
  } else {
    err = tail_layer(P(x), P(self_out), P(o_w), P(cq_w), P(co_w), P(fc1_w), P(fc2_w),
                     nullptr, nullptr, nullptr, nullptr, nullptr, P(o_b), P(ln2_g),
                     P(ln2_b), P(cq_b), P(co_b), P(ln3_g), P(ln3_b), P(fc1_b),
                     P(fc2_b), k, v, F(ks), F(vs), O(x1), O(cq), O(att), O(x2),
                     O(h4), O(out), layer, N, D, H, Bc, beams, Ta, ta_total, n_span,
                     span_keys, plan, stream);
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

cudaError_t launch_skinny_gemm(const bf16* A, const bf16* W, const bf16* bias,
                               const bf16* ln_g, const bf16* ln_b, bf16* out, int N,
                               int Din, int Dout, SkinnyPlan plan, cudaStream_t stream) {
  return skinny_gemm(A, W, nullptr, nullptr, bias, static_cast<const bf16*>(nullptr), ln_g,
                     ln_b, out, N, Din, Dout, 0, plan, stream);
}

cudaError_t launch_skinny_gemm(const float* A, const float* W, const float* bias,
                               const float* ln_g, const float* ln_b, float* out, int N,
                               int Din, int Dout, SkinnyPlan plan, cudaStream_t stream) {
  return skinny_gemm(A, W, nullptr, nullptr, bias, static_cast<const float*>(nullptr), ln_g,
                     ln_b, out, N, Din, Dout, 0, plan, stream);
}

#define WDT_FUSED_TAIL_ARGS                                                                   \
  const void *x, const void *self_out, const void *o_w, const void *o_b, const void *ln2_g,   \
      const void *ln2_b, const void *cq_w, const void *cq_b, const void *co_w,                \
      const void *co_b, const void *ln3_g, const void *ln3_b, const void *fc1_w,              \
      const void *fc1_b, const void *fc2_w, const void *fc2_b, const void *k, const void *v,  \
      void *x1, void *cq, void *att, void *x2, void *h4, void *out, const void *o_ws,         \
      const void *cq_ws, const void *co_ws, const void *fc1_ws, const void *fc2_ws,           \
      const void *ks, const void *vs, int layer, int N, int D, int H, int Bc, int beams,      \
      int Ta, int ta_total, int n_span, int span_keys, int o_bn, int o_split, int o_span,     \
      int o_stages, int cq_bn, int cq_split, int cq_span, int cq_stages, int co_bn,           \
      int co_split, int co_span, int co_stages, int fc1_bn, int fc1_split, int fc1_span,      \
      int fc1_stages, int fc2_bn, int fc2_split, int fc2_span, int fc2_stages, void *stream_
#define WDT_FUSED_TAIL_CALL(AT)                                                               \
  const SkinnyPlan plan[5] = {{o_bn, o_split, o_span, o_stages},                              \
                              {cq_bn, cq_split, cq_span, cq_stages},                          \
                              {co_bn, co_split, co_span, co_stages},                          \
                              {fc1_bn, fc1_split, fc1_span, fc1_stages},                      \
                              {fc2_bn, fc2_split, fc2_span, fc2_stages}};                     \
  return fused_tail<AT>(x, self_out, o_w, o_b, ln2_g, ln2_b, cq_w, cq_b, co_w, co_b, ln3_g,   \
                        ln3_b, fc1_w, fc1_b, fc2_w, fc2_b, k, v, x1, cq, att, x2, h4, out,    \
                        o_ws, cq_ws, co_ws, fc1_ws, fc2_ws, ks, vs, layer, N, D, H, Bc,       \
                        beams, Ta, ta_total, n_span, span_keys, plan,                         \
                        static_cast<cudaStream_t>(stream_))

// x, self_out [N, D] (self_out is [N, H, 1, Dh] viewed flat); the stacked
// decoder weights [L, ...] are passed at layer 0 and offset by `layer` here;
// k, v [L, Bc, H, Ta, 64] with N = Bc * beams; x1, cq, att, x2 [N, D] and
// h4 [N, 4D] are scratch; out [N, D]. Needs D % 64 == 0 (the wrapper checks).
// K6's forms: o_ws != nullptr -> the five weights are int8 with the scales
// o_ws, cq_ws, co_ws, fc1_ws (per output column) and fc2_ws (per input row);
// ks != nullptr -> k, v are int8 with per-position scales ks, vs
// [L, Bc, H, Ta]. Null scales: bf16 (K3). (n_span, span_keys): K1 / K5's
// plan for Bc streams of `beams` queries (ops/attn.py::cross_attn_plan).
// (bn, n_split, span_k, stages) x 5: the splits of o, cq, co, fc1 and fc2
// (ops/tail.py::skinny_plan).
WDT_EXPORT int wdt_fused_tail(WDT_FUSED_TAIL_ARGS) { WDT_FUSED_TAIL_CALL(bf16); }

// The f32 forms: every bf16 operand above in f32 (int8 weights and cache
// as above); the plans of ops/tail.py with f32=True.
WDT_EXPORT int wdt_fused_tail_f32(WDT_FUSED_TAIL_ARGS) { WDT_FUSED_TAIL_CALL(float); }
