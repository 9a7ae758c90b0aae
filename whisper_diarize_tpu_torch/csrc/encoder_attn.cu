// K10: flash self-attention of one encoder layer, in both of the TPU
// kernel's forms.
//
// Replaces tools/bench_encoder_attn.py::encoder_self_attention: the
// single-pass form (_enc_flash_kernel_1pass, pallas_call at :261) and the
// two-pass form (_enc_flash_kernel, :276). Non-causal attention over
// q, k, v [B, H, T, 64]; q and k are each scaled by Dh^-0.25 and rounded to
// bf16; keys >= ta_total are masked.
//   single pass: m = the row's max over every key; p = bf16(exp(s - m));
//                l = the f32 sum of those rounded p; out = (p . V) / l.
//   two pass:    the online recurrence over 512-key blocks (the TPU
//                kernel's): per block m_new = max(m, block max),
//                alpha = exp(m - m_new), p = exp(s - m_new) in f32,
//                l = l * alpha + sum(p), acc = acc * alpha + bf16(p) . V.
// Both keep f32 scores and accumulators; the output is acc / l in bf16.
//
// What bounds it on the H100: operations. At large-v3 and B 8 one layer is
// 4 x 8 x 20 x 1500^2 x 64 = 9.2e10 FLOP (93 us at the 989 TFLOP/s bf16
// tensor rate) against 123 MB of q, k, v and output (37 us at 3.35 TB/s).
// Hitting the TPU kernel's rounding points takes a third product (below):
// 1.4e11 FLOP, 0.14 ms. The plain version writes [B, H, T, T] scores and
// probabilities to device memory; this kernel keeps them in registers.
//
// Design: a warp-specialised CTA of four warpgroups per (192 queries,
// head, batch row), one CTA an SM (100-odd registers a thread).
// - Producer (warpgroup 3). One thread keeps K tiles (sweep 1) and K + V
//   tiles (sweep 2) of 64 keys in flight through a ring of STAGES (4)
//   slots, each a TMA copy of a tiled tensor map (128-byte swizzle) that
//   completes on the slot's `full` mbarrier. q, k and v are the encoder's
//   strided [B, T, H, 64] projections seen as [B, H, T, 64]: the tensor map
//   takes the row stride (H x 64) as it is, so the head views need no copy
//   and the result is independent of the strides. The copy engine cannot
//   scale, so once a slot lands the producer warpgroup scales its K by
//   Dh^-0.25 in place (bf16(k * Dh^-0.25) in f32, once a tile; the
//   swizzle does not matter to an elementwise scale), fences the writes
//   into the async proxy and arrives on the slot's `ready` barrier. The
//   tensor map is encoded on the host through cudaGetDriverEntryPoint
//   (the library links no libcuda).
// - Consumers (warpgroups 0, 1 and 2), 64 query rows each: S = Q K^T as four
//   wgmma m64n64k16 from shared memory (Q scaled once in place, K from the
//   slot), then the softmax in registers, then O += P V as four wgmma with P
//   from registers (the S accumulator re-packed as bf16 A fragments) and V
//   MN-major from the slot (p = exp2(s log2 e - m log2 e): one FMA and one
//   MUFU op, `ex2`). Each consumer thread arrives on the slot's `empty` barrier
//   when its products on it are done; the producer refills the slot once
//   all 384 have. A consumer waits for each product before the next step;
//   issuing the next item's Q K^T before this item's softmax (a second
//   score buffer) made ptxas serialize the wgmma (C7515) and ran slower.
//   Three consumer warpgroups ran faster than two (more warps to cover the
//   waits); four with a one-warp producer, two CTAs an SM, the consumers'
//   products issued in turn, or 128-key tiles were no faster (PERF.md,
//   Findings).
// - Two sweeps a span. The TPU kernel keeps a whole [512, 1536] f32 score
//   block in VMEM; 227 KB of shared memory cannot, so each span of keys
//   (the whole row for the single pass, 512 keys for the two-pass form) is
//   swept twice: first Q K^T for the span's row max, then Q K^T again for
//   p, l and P V. The single pass's rounding point, p = bf16(exp(s -
//   m_final)), needs the row's final max before any P V, so the two sweeps
//   are what it costs; the two-pass form runs on the same kernel.
//
// The f32 form (`wdt_encoder_attn_f32`, `enc_attn_f32_kernel`). Off a TPU the
// JAX tool runs the TPU kernel at f32, where its roundings to the operand
// dtype are the identity. Hopper has no f32 x f32 tensor-core product (only
// TF32: 10 mantissa bits, not an f32 product), so this is a kernel of its
// own on the CUDA cores (FFMA), in the same two-sweep schedule and both
// forms, each in its plain version's order (single pass: the row's max
// over every key before any p; two pass: the online recurrence over 512-key
// spans). Bound at [8, 20, 1500, 64] by operations: 4 x 8 x 20 x 1500^2 x 64
// = 9.2e10 FLOP, 1.37 ms at 67 TFLOP/s (0.073 ms of bytes, 246 MB); the
// second sweep's Q K^T adds half again. Design: a 64-row Q tile of one
// (b, h) a CTA of 128 threads (two CTAs an SM); K and V tiles of 64 keys in
// shared memory through a cp.async double buffer, K scaled in place once it
// lands; rows padded to 68 floats, so the float4 reads of eight rows fall
// in distinct banks. Each thread owns a 4 x 8 block of the scores (rows
// ty + 16 i, keys tx + 8 j: the eight threads of a row are eight adjacent
// lanes, which reduce its max and normalizer by shuffles) and a 4 x 8 block
// of the output (the same rows, columns 4 tx .. + 3 and 32 + 4 tx .. + 3);
// p goes through shared memory between the two products. Every sum is an
// f32 FMA chain; p = expf(s - m) and the output o / l in IEEE division.
#include "common.cuh"  // TMA, wgmma, mbarrier and tensor-map helpers

namespace {

constexpr int DH = 64;                 // head dimension (every Whisper checkpoint)
constexpr int BK = 64;                 // keys a tile
constexpr int CONSUMERS = 3;           // warpgroups of 64 query rows
constexpr int BQ = 64 * CONSUMERS;     // query rows a CTA
constexpr int THREADS = (CONSUMERS + 1) * 128;  // and the producer warpgroup
constexpr int STAGES = 4;              // ring slots
constexpr int TILE_BYTES = BK * DH * 2;  // one 64 x 128-byte box
constexpr int TWO_PASS_SPAN = 512;     // the TPU kernel's key block
// Q (two boxes), then the ring's K and V slots; 1024-byte aligned (the
// 128-byte swizzle's period), plus the slack to align the base
constexpr int SMEM_BYTES = (CONSUMERS + 2 * STAGES) * TILE_BYTES + 1024;

// 8 bf16 values scaled in f32 and rounded back to bf16
__device__ __forceinline__ uint4 scale8(uint4 raw, float scale) {
  bf162* x = reinterpret_cast<bf162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(x[e]);
    x[e] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
  }
  return raw;
}

// a 64-row box scaled in place by `n` threads (thread i of them)
__device__ __forceinline__ void scale_box(unsigned char* box, float scale, int i, int n) {
  uint4* x = reinterpret_cast<uint4*>(box);
  for (int c = i; c < TILE_BYTES / 16; c += n) x[c] = scale8(x[c], scale);
}

// The sweep schedule, one item a (tile, sweep), the same for producer and
// consumers: span s (the whole row, or 512 keys) sweeps its tiles for the
// row max (pass 0, K only), then again for P V (pass 1, K and V).
struct Item {
  int tile;  // key tile: keys 64 tile ..
  int pass;  // 0: row max; 1: p, l, P V
  int last;  // the span's last tile of this pass
  int span_end;  // keys >= span_end are masked
};

__device__ __forceinline__ Item item_at(int i, int tiles, int span_tiles, int ta) {
  const int s = i / (2 * span_tiles);
  const int r = i % (2 * span_tiles);
  const int nt = min(span_tiles, tiles - s * span_tiles);
  Item it;
  it.pass = r / nt;
  const int t = r % nt;
  it.tile = s * span_tiles + t;
  it.last = t == nt - 1;
  it.span_end = min((s * span_tiles + nt) * BK, ta);
  return it;
}

constexpr float LOG2E = 1.4426950408889634f;

// 2^x in one MUFU op (results below 2^-126 flush to 0: far under what a
// bf16 p or an f32 normalizer can hold beside the row's largest p = 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <bool ONE_PASS>
__global__ void __launch_bounds__(THREADS, 1)
enc_attn_kernel(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v, int4 pos, bf16* __restrict__ out,
                int T, int ta, long long ob, long long oh, long long ot, float scale) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], ready[STAGES], empty[STAGES], qbar;
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* base = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  unsigned char* qs = base;                                // [CONSUMERS][TILE_BYTES]
  unsigned char* ks = base + CONSUMERS * TILE_BYTES;       // [STAGES][TILE_BYTES]
  unsigned char* vs = ks + STAGES * TILE_BYTES;            // [STAGES][TILE_BYTES]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int tiles = (ta + BK - 1) / BK;
  const int span_tiles = ONE_PASS ? tiles : TWO_PASS_SPAN / BK;
  const int n_items = 2 * tiles;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], 1);
      mbar_init(&empty[s], CONSUMERS * 128);
    }
    mbar_init(&qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---------------- producer warpgroup ----------------
    const int pt = tid - CONSUMERS * 128;
    constexpr int LAG = STAGES - 1;  // items in flight ahead of the one scaled
    if (pt == 0) {
      mbar_expect_tx(&qbar, CONSUMERS * TILE_BYTES);
      for (int c = 0; c < CONSUMERS; ++c)
        tma_rows(qs + c * TILE_BYTES, &map_q, pos, q0 + 64 * c, h, b, &qbar);
    }
    // step i: hand item i - LAG to the consumers as soon as it lands (it
    // was issued LAG steps ago), then issue item i into the slot item
    // i - STAGES frees; the consumers hold the next item while they finish
    // the one before
    for (int i = 0; i < n_items + LAG; ++i) {
      const int j = i - LAG;
      if (j >= 0) {
        const int slot = j % STAGES;
        mbar_wait(&full[slot], (j / STAGES) & 1);
        scale_box(ks + slot * TILE_BYTES, scale, pt, 128);
        fence_view_async();    // the scaled K, visible to the tensor cores
        named_barrier(1, 128);
        if (pt == 0) mbar_arrive(&ready[slot]);
      }
      if (i < n_items && pt == 0) {
        const int slot = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[slot], ((i / STAGES) - 1) & 1);
        const Item it = item_at(i, tiles, span_tiles, ta);
        mbar_expect_tx(&full[slot], it.pass ? 2 * TILE_BYTES : TILE_BYTES);
        tma_rows(ks + slot * TILE_BYTES, &map_k, pos, it.tile * BK, h, b, &full[slot]);
        if (it.pass)
          tma_rows(vs + slot * TILE_BYTES, &map_v, pos, it.tile * BK, h, b, &full[slot]);
      }
    }
  } else {
    // ---------------- consumer warpgroups ----------------
    const int ct = tid % 128;
    const int warp = ct / 32, lane = tid & 31;
    const int g = lane >> 2, tg = lane & 3;
    unsigned char* qw = qs + wg * TILE_BYTES;
    mbar_wait(&qbar, 0);
    scale_box(qw, scale, ct, 128);
    fence_view_async();
    named_barrier(2 + wg, 128);
    const uint64_t qdesc = smem_desc(qw);

    float m_lo = -1e30f, m_hi = -1e30f;  // running max of rows g, g + 8
    float l_lo = 0.0f, l_hi = 0.0f;      // this thread's part of the normalizers
    float bm_lo = WDT_NEG_INF, bm_hi = WDT_NEG_INF;  // the span's max so far
    float o[32], s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) o[e] = 0.0f;

    for (int i = 0; i < n_items; ++i) {
      const int slot = i % STAGES;
      const Item it = item_at(i, tiles, span_tiles, ta);
      mbar_wait(&ready[slot], (i / STAGES) & 1);
      const uint64_t kdesc = smem_desc(ks + slot * TILE_BYTES);
      fence_acc(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)  // 16 elements = 32 bytes a k-step
        wgmma_ss(s, qdesc + 2 * kk, kdesc + 2 * kk, kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(s);
      const int t0 = it.tile * BK;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = t0 + 8 * j + 2 * tg;
        if (key >= it.span_end) s[4 * j] = s[4 * j + 2] = WDT_NEG_INF;
        if (key + 1 >= it.span_end) s[4 * j + 1] = s[4 * j + 3] = WDT_NEG_INF;
      }
      if (it.pass == 0) {
        mbar_arrive(&empty[slot]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          bm_lo = fmaxf(bm_lo, fmaxf(s[4 * j], s[4 * j + 1]));
          bm_hi = fmaxf(bm_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
        if (it.last) {  // the span's max: rescale the state once
          const float mn_lo = fmaxf(m_lo, quad_max(bm_lo));
          const float mn_hi = fmaxf(m_hi, quad_max(bm_hi));
          const float a_lo = expf(m_lo - mn_lo), a_hi = expf(m_hi - mn_hi);
          l_lo *= a_lo;
          l_hi *= a_hi;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            o[4 * j] *= a_lo;
            o[4 * j + 1] *= a_lo;
            o[4 * j + 2] *= a_hi;
            o[4 * j + 3] *= a_hi;
          }
          m_lo = mn_lo;
          m_hi = mn_hi;
          bm_lo = bm_hi = WDT_NEG_INF;
        }
        continue;
      }
      // p = exp(s - m) as exp2(s log2 e - m log2 e): one FMA and one MUFU op
      const float ml_lo = m_lo * LOG2E, ml_hi = m_hi * LOG2E;
      uint32_t pa[4][4];  // A fragments of keys 16 kc .. + 15
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p0 = ex2(fmaf(s[4 * j], LOG2E, -ml_lo));
        const float p1 = ex2(fmaf(s[4 * j + 1], LOG2E, -ml_lo));
        const float p2 = ex2(fmaf(s[4 * j + 2], LOG2E, -ml_hi));
        const float p3 = ex2(fmaf(s[4 * j + 3], LOG2E, -ml_hi));
        const uint32_t lo = pack_bf16(p0, p1), hi = pack_bf16(p2, p3);
        if (ONE_PASS) {  // the normalizer sums the rounded probabilities
          const float2 fl = __bfloat1622float2(*reinterpret_cast<const bf162*>(&lo));
          const float2 fh = __bfloat1622float2(*reinterpret_cast<const bf162*>(&hi));
          l_lo += fl.x + fl.y;
          l_hi += fh.x + fh.y;
        } else {
          l_lo += p0 + p1;
          l_hi += p2 + p3;
        }
        // accumulator layout -> A fragment of keys 16 (j / 2) .. + 15
        pa[j / 2][(j & 1) * 2 + 0] = lo;
        pa[j / 2][(j & 1) * 2 + 1] = hi;
      }
      const uint64_t vdesc = smem_desc(vs + slot * TILE_BYTES);
      fence_acc(o);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)  // 16 keys = 2048 bytes a k-step
        wgmma_rs(o, pa[kc], vdesc + 128 * kc);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(o);
      mbar_arrive(&empty[slot]);
    }

    const float inv_lo = 1.0f / quad_sum(l_lo), inv_hi = 1.0f / quad_sum(l_hi);
    const int row_lo = q0 + 64 * wg + 16 * warp + g, row_hi = row_lo + 8;
    bf16* ob_ = out + (long long)b * ob + (long long)h * oh;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = 8 * j + 2 * tg;
      if (row_lo < T)
        *reinterpret_cast<bf162*>(ob_ + (long long)row_lo * ot + d) =
            __floats2bfloat162_rn(o[4 * j] * inv_lo, o[4 * j + 1] * inv_lo);
      if (row_hi < T)
        *reinterpret_cast<bf162*>(ob_ + (long long)row_hi * ot + d) =
            __floats2bfloat162_rn(o[4 * j + 2] * inv_hi, o[4 * j + 3] * inv_hi);
    }
  }
}

// ---------------------------------------------------------------------------
// The f32 form: FFMA on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int F_BQ = 64;            // query rows a CTA
constexpr int F_THREADS = 128;      // 16 row groups x 8 key / column groups
constexpr int F_ROW = DH + 4;       // a staged q / k / v row: 68 floats (272 bytes)
constexpr int F_PROW = BK + 8;      // a row of the p tile: 72 floats
constexpr int F_TILE = BK * F_ROW;  // floats of one K or V tile
constexpr int F_SMEM = (F_BQ * F_ROW + 4 * F_TILE + F_BQ * F_PROW) * 4;  // Q, K x 2, V x 2, P

// issue (not wait for) the cp.async copies of rows t0 .. t0 + 63 of one
// (b, h) slab into a tile, 16 bytes a copy; rows >= T land as zeros
__device__ __forceinline__ void f32_stage(float* dst, const float* src, long long st, int t0,
                                          int T, int tid) {
#pragma unroll
  for (int i = tid; i < BK * (DH / 4); i += F_THREADS) {
    const int r = i / (DH / 4), c = i % (DH / 4);
    const bool ok = t0 + r < T;
    cp_async<16>(dst + r * F_ROW + 4 * c, src + (ok ? (t0 + r) * st + 4 * c : 0), ok);
  }
}

// max / sum over the eight lanes that share a row (lanes 8a .. 8a + 7)
__device__ __forceinline__ float oct_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}

__device__ __forceinline__ float oct_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

template <bool ONE_PASS>
__global__ void __launch_bounds__(F_THREADS, 2)
enc_attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out, int T, int ta,
                    long long sb, long long sh, long long st, long long ob, long long oh,
                    long long ot, float scale) {
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                      // [F_BQ][F_ROW], scaled
  float* ks = qs + F_BQ * F_ROW;        // [2][BK][F_ROW], scaled once landed
  float* vs = ks + 2 * F_TILE;          // [2][BK][F_ROW]
  float* ps = vs + 2 * F_TILE;          // [F_BQ][F_PROW]

  const int q0 = blockIdx.x * F_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / 8, tx = tid % 8;  // rows ty + 16 i; keys tx + 8 j; columns 4 tx, 32 + 4 tx
  const long long slab = (long long)b * sb + (long long)h * sh;
  const float* kb = k + slab;
  const float* vb = v + slab;
  const int tiles = (ta + BK - 1) / BK;
  const int span_tiles = ONE_PASS ? tiles : TWO_PASS_SPAN / BK;
  const int n_items = 2 * tiles;

  // item 0's K in flight while Q is staged, scaled, from registers
  f32_stage(ks, kb, st, 0, T, tid);
  cp_async_commit();
  for (int i = tid; i < F_BQ * (DH / 4); i += F_THREADS) {
    const int r = i / (DH / 4), c = i % (DH / 4);
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (q0 + r < T) x = *reinterpret_cast<const float4*>(q + slab + (q0 + r) * st + 4 * c);
    *reinterpret_cast<float4*>(qs + r * F_ROW + 4 * c) =
        make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
  }

  float m[4], l[4], bm[4], o[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -1e30f;
    l[i] = 0.0f;
    bm[i] = WDT_NEG_INF;
#pragma unroll
    for (int c = 0; c < 8; ++c) o[i][c] = 0.0f;
  }

  for (int it = 0; it < n_items; ++it) {
    const Item item = item_at(it, tiles, span_tiles, ta);
    float* kt = ks + (it & 1) * F_TILE;
    float* vt = vs + (it & 1) * F_TILE;
    cp_async_wait<0>();
    __syncthreads();  // item it landed everywhere; item it - 1's products are done
    if (it + 1 < n_items) {  // the next item into the other buffer
      const Item nx = item_at(it + 1, tiles, span_tiles, ta);
      f32_stage(ks + ((it + 1) & 1) * F_TILE, kb, st, nx.tile * BK, T, tid);
      if (nx.pass) f32_stage(vs + ((it + 1) & 1) * F_TILE, vb, st, nx.tile * BK, T, tid);
      cp_async_commit();
    }
    for (int i = tid; i < BK * (DH / 4); i += F_THREADS) {  // k * Dh^-0.25, in place
      float4* x = reinterpret_cast<float4*>(kt + (i / (DH / 4)) * F_ROW + 4 * (i % (DH / 4)));
      const float4 y = *x;
      *x = make_float4(y.x * scale, y.y * scale, y.z * scale, y.w * scale);
    }
    __syncthreads();

    // scores: s[i][j] = q'[row ty + 16 i] . k'[key tx + 8 j], an FMA chain over d
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * F_ROW + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(kt + (tx + 8 * j) * F_ROW + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[i][j] = fmaf(qv[i].w, kv.w, fmaf(qv[i].z, kv.z,
                         fmaf(qv[i].y, kv.y, fmaf(qv[i].x, kv.x, s[i][j]))));
      }
    }
    const int t0 = item.tile * BK;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (t0 + tx + 8 * j >= item.span_end)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = WDT_NEG_INF;

    if (item.pass == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) bm[i] = fmaxf(bm[i], s[i][j]);
      if (item.last) {  // the span's max: rescale the state once
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float mn = fmaxf(m[i], oct_max(bm[i]));
          const float alpha = expf(m[i] - mn);
          l[i] *= alpha;
#pragma unroll
          for (int c = 0; c < 8; ++c) o[i][c] *= alpha;
          m[i] = mn;
          bm[i] = WDT_NEG_INF;
        }
      }
      continue;
    }
    // p = exp(s - m), this thread's part of the normalizer, the p tile
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m[i]);
        l[i] += p;
        ps[(ty + 16 * i) * F_PROW + tx + 8 * j] = p;
      }
    __syncthreads();
    // o[i] += p[row ty + 16 i, :] . V, an FMA chain over the keys
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * F_PROW + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vr = vt + (kk + e) * F_ROW + 4 * tx;
        const float4 v0 = *reinterpret_cast<const float4*>(vr);
        const float4 v1 = *reinterpret_cast<const float4*>(vr + 32);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = comp(pv[i], e);
          o[i][0] = fmaf(p, v0.x, o[i][0]);
          o[i][1] = fmaf(p, v0.y, o[i][1]);
          o[i][2] = fmaf(p, v0.z, o[i][2]);
          o[i][3] = fmaf(p, v0.w, o[i][3]);
          o[i][4] = fmaf(p, v1.x, o[i][4]);
          o[i][5] = fmaf(p, v1.y, o[i][5]);
          o[i][6] = fmaf(p, v1.z, o[i][6]);
          o[i][7] = fmaf(p, v1.w, o[i][7]);
        }
      }
    }
  }

  float* ob_ = out + (long long)b * ob + (long long)h * oh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lt = oct_sum(l[i]);
    const int row = q0 + ty + 16 * i;
    if (row < T) {
      float* dst = ob_ + (long long)row * ot + 4 * tx;
      *reinterpret_cast<float4*>(dst) =
          make_float4(o[i][0] / lt, o[i][1] / lt, o[i][2] / lt, o[i][3] / lt);
      *reinterpret_cast<float4*>(dst + 32) =
          make_float4(o[i][4] / lt, o[i][5] / lt, o[i][6] / lt, o[i][7] / lt);
    }
  }
}

// a [B, H, T, 64] bf16 tensor at element strides (sb, sh, st), its outer
// dimensions in the order of `order` (innermost first after d), boxes of
// 64 rows x 64 values with the 128-byte swizzle
bool make_map(CUtensorMap* map, const void* ptr, const int* order, const long long* extent,
              const long long* stride) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t dims[4] = {DH, 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {DH, 1, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = (cuuint64_t)extent[order[i]];
    strides[i] = (cuuint64_t)stride[order[i]] * 2;
    if (order[i] == 0) box[i + 1] = BK;  // the T axis
  }
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// q, k, v [B, H, T, 64] bf16 read through the element strides (sb, sh, st)
// shared by the three (last axis contiguous, 16-byte aligned rows and
// strides); out [B, H, T, 64] written through (ob, oh, ot). Keys >= ta_total
// masked (0 < ta_total <= T). single_pass selects the form.
WDT_EXPORT int wdt_encoder_attn(const void* q, const void* k, const void* v,
                                void* out, int B, int H, int T, int ta_total,
                                long long sb, long long sh, long long st,
                                long long ob, long long oh, long long ot,
                                int single_pass, void* stream) {
  if (ta_total <= 0 || ta_total > T) return static_cast<int>(cudaErrorInvalidValue);
  // the outer axes (0: T, 1: H, 2: B) by increasing stride, for the maps
  const long long extent[3] = {T, H, B}, stride[3] = {st, sh, sb};
  int order[3] = {0, 1, 2};
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (stride[order[j]] < stride[order[i]]) {
        const int x = order[i];
        order[i] = order[j];
        order[j] = x;
      }
  int where[3];
  for (int i = 0; i < 3; ++i) where[order[i]] = i + 1;
  const int4 pos = make_int4(where[0], where[1], where[2], 0);
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, order, extent, stride) || !make_map(&mk, k, order, extent, stride) ||
      !make_map(&mv, v, order, extent, stride))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  const float scale = 0.35355339059327373f;  // 64^-0.25
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto O = static_cast<bf16*>(out);
  auto kern = single_pass ? enc_attn_kernel<true> : enc_attn_kernel<false>;
  static const cudaError_t a1 = cudaFuncSetAttribute(
      enc_attn_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  static const cudaError_t a2 = cudaFuncSetAttribute(
      enc_attn_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (a1 != cudaSuccess) return static_cast<int>(a1);
  if (a2 != cudaSuccess) return static_cast<int>(a2);
  kern<<<grid, THREADS, SMEM_BYTES, s>>>(mq, mk, mv, pos, O, T, ta_total, ob, oh, ot, scale);
  return static_cast<int>(cudaGetLastError());
}

// The f32 form: q, k, v and out f32 under the same rules (16-byte aligned
// rows and strides); FFMA on the CUDA cores.
WDT_EXPORT int wdt_encoder_attn_f32(const void* q, const void* k, const void* v,
                                    void* out, int B, int H, int T, int ta_total,
                                    long long sb, long long sh, long long st,
                                    long long ob, long long oh, long long ot,
                                    int single_pass, void* stream) {
  if (ta_total <= 0 || ta_total > T || B <= 0 || H <= 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t a1 = cudaFuncSetAttribute(
      enc_attn_f32_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM);
  static const cudaError_t a2 = cudaFuncSetAttribute(
      enc_attn_f32_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM);
  if (a1 != cudaSuccess) return static_cast<int>(a1);
  if (a2 != cudaSuccess) return static_cast<int>(a2);
  const dim3 grid((T + F_BQ - 1) / F_BQ, H, B);
  auto kern = single_pass ? enc_attn_f32_kernel<true> : enc_attn_f32_kernel<false>;
  kern<<<grid, F_THREADS, F_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), T, ta_total, sb, sh, st, ob, oh, ot,
      0.35355339059327373f /* 64^-0.25 */);
  return static_cast<int>(cudaGetLastError());
}
