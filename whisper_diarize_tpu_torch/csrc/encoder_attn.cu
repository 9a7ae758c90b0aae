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
// dtype are the identity: the two forms are then one function, and one
// recurrence serves both entry points. Its plain versions keep their own
// orders (single pass: the row's final max; two pass: 512-key blocks) and
// stay the reference. Hopper has no f32 x f32 tensor-core product, but a
// 3xTF32 split has f32's accuracy (common.cuh's tf32_split: hi / lo of
// each operand, lo hi' + hi lo' + hi hi' into one f32 accumulator).
// Bound at [8, 20, 1500, 64] by operations: 4 x 8 x 20 x 1500^2 x 64 = 9.2e10
// FLOP, 0.56 ms at the 3xTF32 rate (495 / 3 TFLOP/s; 0.073 ms of bytes,
// 246 MB). Design: one sweep, on the bf16 kernel's skeleton. A CTA of three
// warpgroups takes 128 query rows of one (b, h):
// - Producer (warpgroup 2). For each 64-key tile it reads K (scaled by
//   Dh^-0.25) and V from device memory into registers, splits them and
//   stores K hi / lo and V^T hi / lo into a ring slot (two slots of 64 KB),
//   K-major with the 128-byte swizzle (`sw128`), then fences the stores
//   into the async proxy and arrives on the slot's `full` mbarrier; the next
//   tile's reads are in flight while it waits for the slot to drain
//   (`empty`). TF32 wgmma reads B only K-major, so V lands transposed, and
//   its k index runs over each 8-key step's keys in the order 0, 2, 4, 6,
//   1, 3, 5, 7: the order in which P's A fragment holds them (as in K1-f32,
//   cross_attn.cu's tf32x3_* helpers).
// - Consumers (warpgroups 0 and 1), 64 rows each, their q scaled and split
//   once into swizzled Q hi / lo tiles. Per tile: S = Q K^T as 24 wgmma
//   m64n64k8 in TF32 from shared memory (lo hi', hi lo', hi hi' a k-step),
//   the running max moved once (the tile's max), p = expf(s - m) in f32 and
//   its sum into the normalizer, P split into A fragments in registers (the
//   S accumulator as it lies), the tile's P V as 24 wgmma from zero, added to
//   the rescaled o on the CUDA cores: the tensor cores' accumulation
//   truncates, and a chain over a row's 188 key steps biased o by 1.05e-5
//   (cross_attn.cu, tf32x3_pv). Then the slot's `empty`.
// `agreement.k10_tf32x3_model` is this order on the CPU. The output is o / l
// in IEEE division. 192 KB of shared memory: one CTA an SM.
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
// The f32 form: one sweep, 3xTF32 wgmma
// ---------------------------------------------------------------------------

constexpr int F_CONSUMERS = 2;                     // warpgroups of 64 query rows
constexpr int F_BQ = 64 * F_CONSUMERS;             // query rows a CTA
constexpr int F_THREADS = (F_CONSUMERS + 1) * 128;  // and the producer warpgroup
constexpr int F_STAGES = 2;                        // ring slots (K hi / lo, V^T hi / lo)
constexpr int F_ATOM = 64 * 128;   // bytes: 64 rows of 32 floats, 128-byte swizzled
constexpr int F_TILE = 2 * F_ATOM;  // a 64 x 64 f32 tile: two atoms along k (16 KB)
// Q hi / lo of each consumer, then each slot's K hi, K lo, V^T hi, V^T lo;
// 1024-byte aligned (the swizzle's period), plus the slack to align the base
constexpr int F_SMEM = (2 * F_CONSUMERS + 4 * F_STAGES) * F_TILE + 1024;

// byte offset of (row r, column c) of a 64 x 64 f32 tile stored K-major with
// the 128-byte swizzle: columns 0 - 31 in the first atom, 32 - 63 in the
// second; the 16-byte chunk c / 4 of row r lands at chunk (c / 4) ^ (r % 8)
__device__ __forceinline__ int sw128(int r, int c) {
  return (c >> 5) * F_ATOM + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4) + (c & 3) * 4;
}

// x split for 3xTF32 into the hi and lo tiles at byte offset `off`
__device__ __forceinline__ void store_split4(unsigned char* hi, unsigned char* lo, int off,
                                             float4 x) {
  uint4 h, l;
  tf32_split(x.x, h.x, l.x);
  tf32_split(x.y, h.y, l.y);
  tf32_split(x.z, h.z, l.z);
  tf32_split(x.w, h.w, l.w);
  *reinterpret_cast<uint4*>(hi + off) = h;
  *reinterpret_cast<uint4*>(lo + off) = l;
}

__device__ __forceinline__ float4 scale4(float4 x, float s) {
  return make_float4(x.x * s, x.y * s, x.z * s, x.w * s);
}

// the descriptor of k-step ks (8 columns, 32 bytes) of a K-major tile
__device__ __forceinline__ uint64_t tile_desc(const unsigned char* tile, int ks) {
  return smem_desc(tile + (ks >> 2) * F_ATOM + (ks & 3) * 32);
}

__global__ void __launch_bounds__(F_THREADS, 1)
enc_attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out, int T, int ta,
                    long long sb, long long sh, long long st, long long ob, long long oh,
                    long long ot, float scale) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[F_STAGES], empty[F_STAGES];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* base = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  unsigned char* ring = base + 2 * F_CONSUMERS * F_TILE;  // slot s: ring + 4 F_TILE s

  const int q0 = blockIdx.x * F_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const long long slab = (long long)b * sb + (long long)h * sh;
  const int tiles = (ta + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < F_STAGES; ++s) {
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], F_CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == F_CONSUMERS) {
    // ---------------- producer warpgroup ----------------
    // Each tile: K rows scaled by Dh^-0.25 and V rows read from device
    // memory into registers (the next tile's reads in flight while the
    // slot drains), split, and stored as K hi / lo and V^T hi / lo. V^T's
    // k index runs over each 8-key step's keys in the order 0, 2, 4, 6,
    // 1, 3, 5, 7: the order P's A fragment holds them in (cross_attn.cu, tf32x3_pv).
    const int pt = tid - F_CONSUMERS * 128;
    const float* kb = k + slab;
    const float* vb = v + slab;
    float4 kx[8], vx[8];
    auto load = [&](int j) {
      const int t0 = j * BK;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int i = pt + 128 * m, r = i >> 4, c = (i & 15) * 4;  // K: row r, cols c ..
        kx[m] = t0 + r < T ? *reinterpret_cast<const float4*>(kb + (t0 + r) * st + c)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const int d = i & 63, kq = i >> 6;  // V^T: row d, k slots 4 kq ..
        const int key = t0 + 8 * (kq >> 1) + (kq & 1);
        float e[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          e[u] = key + 2 * u < T ? vb[(key + 2 * u) * st + d] : 0.0f;
        vx[m] = make_float4(e[0], e[1], e[2], e[3]);
      }
    };
    if (tiles > 0) load(0);
    for (int j = 0; j < tiles; ++j) {
      const int slot = j % F_STAGES;
      unsigned char* kh = ring + slot * 4 * F_TILE;
      if (j >= F_STAGES) mbar_wait(&empty[slot], ((j / F_STAGES) - 1) & 1);
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int i = pt + 128 * m;
        store_split4(kh, kh + F_TILE, sw128(i >> 4, (i & 15) * 4), scale4(kx[m], scale));
        store_split4(kh + 2 * F_TILE, kh + 3 * F_TILE, sw128(i & 63, (i >> 6) * 4), vx[m]);
      }
      fence_view_async();  // the stores, visible to the tensor cores
      mbar_arrive(&full[slot]);
      if (j + 1 < tiles) load(j + 1);
    }
  } else {
    // ---------------- consumer warpgroups ----------------
    const int ct = tid % 128;
    const int warp = ct / 32, lane = tid & 31;
    const int g = lane >> 2, tg = lane & 3;
    unsigned char* qh = base + wg * 2 * F_TILE;
    unsigned char* ql = qh + F_TILE;
    {  // this warpgroup's 64 rows times Dh^-0.25, split; rows >= T are zeros
      const float* qb = q + slab;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int i = ct + 128 * m, r = i >> 4, c = (i & 15) * 4;
        const int row = q0 + 64 * wg + r;
        const float4 x = row < T ? *reinterpret_cast<const float4*>(qb + row * st + c)
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        store_split4(qh, ql, sw128(r, c), scale4(x, scale));
      }
      fence_view_async();
      named_barrier(1 + wg, 128);
    }

    float m_lo = -1e30f, m_hi = -1e30f;  // running max of rows g, g + 8
    float l_lo = 0.0f, l_hi = 0.0f;      // this thread's part of the normalizers
    float o[32], s[32], t[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) o[e] = s[e] = t[e] = 0.0f;

    for (int j = 0; j < tiles; ++j) {
      const int slot = j % F_STAGES;
      const unsigned char* kh = ring + slot * 4 * F_TILE;
      const unsigned char* kl = kh + F_TILE;
      const unsigned char* vh = kh + 2 * F_TILE;
      const unsigned char* vl = kh + 3 * F_TILE;
      mbar_wait(&full[slot], (j / F_STAGES) & 1);
      // S = Q K^T: lo hi', hi lo', hi hi' a k-step, the tile from zero
      fence_acc(s);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < DH / 8; ++ks) {
        wgmma_tf32_ss(s, tile_desc(ql, ks), tile_desc(kh, ks), ks);
        wgmma_tf32_ss(s, tile_desc(qh, ks), tile_desc(kl, ks), 1);
        wgmma_tf32_ss(s, tile_desc(qh, ks), tile_desc(kh, ks), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(s);
      const int t0 = j * BK;
      float mx_lo = WDT_NEG_INF, mx_hi = WDT_NEG_INF;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int key = t0 + 8 * jj + 2 * tg;
        if (key >= ta) s[4 * jj] = s[4 * jj + 2] = WDT_NEG_INF;
        if (key + 1 >= ta) s[4 * jj + 1] = s[4 * jj + 3] = WDT_NEG_INF;
        mx_lo = fmaxf(mx_lo, fmaxf(s[4 * jj], s[4 * jj + 1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[4 * jj + 2], s[4 * jj + 3]));
      }
      // the tile's max moves the running max once; p against it, its sum
      // into the normalizer, the state rescaled
      const float mn_lo = fmaxf(m_lo, quad_max(mx_lo)), mn_hi = fmaxf(m_hi, quad_max(mx_hi));
      const float a_lo = expf(m_lo - mn_lo), a_hi = expf(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      uint32_t ph[8][4], pl[8][4];  // P's A fragments: keys 8jj + 2tg (k tg), + 1 (k tg + 4)
      float ps_lo = 0.0f, ps_hi = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float p0 = expf(s[4 * jj] - mn_lo), p1 = expf(s[4 * jj + 1] - mn_lo);
        const float p2 = expf(s[4 * jj + 2] - mn_hi), p3 = expf(s[4 * jj + 3] - mn_hi);
        ps_lo += p0 + p1;
        ps_hi += p2 + p3;
        tf32_split(p0, ph[jj][0], pl[jj][0]);
        tf32_split(p2, ph[jj][1], pl[jj][1]);
        tf32_split(p1, ph[jj][2], pl[jj][2]);
        tf32_split(p3, ph[jj][3], pl[jj][3]);
      }
      l_lo = l_lo * a_lo + ps_lo;
      l_hi = l_hi * a_hi + ps_hi;
      // the tile's P V from zero (the tensor cores' accumulation truncates:
      // cross_attn.cu, tf32x3_pv), added to the rescaled o on the CUDA cores
      fence_acc(t);
      wgmma_fence();
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        wgmma_tf32_rs(t, pl[jj], tile_desc(vh, jj), jj);
        wgmma_tf32_rs(t, ph[jj], tile_desc(vl, jj), 1);
        wgmma_tf32_rs(t, ph[jj], tile_desc(vh, jj), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(t);
      mbar_arrive(&empty[slot]);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        o[4 * jj] = o[4 * jj] * a_lo + t[4 * jj];
        o[4 * jj + 1] = o[4 * jj + 1] * a_lo + t[4 * jj + 1];
        o[4 * jj + 2] = o[4 * jj + 2] * a_hi + t[4 * jj + 2];
        o[4 * jj + 3] = o[4 * jj + 3] * a_hi + t[4 * jj + 3];
      }
    }

    const float lt_lo = quad_sum(l_lo), lt_hi = quad_sum(l_hi);
    const int row_lo = q0 + 64 * wg + 16 * warp + g, row_hi = row_lo + 8;
    float* ob_ = out + (long long)b * ob + (long long)h * oh;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int d = 8 * jj + 2 * tg;
      if (row_lo < T)
        *reinterpret_cast<float2*>(ob_ + (long long)row_lo * ot + d) =
            make_float2(o[4 * jj] / lt_lo, o[4 * jj + 1] / lt_lo);
      if (row_hi < T)
        *reinterpret_cast<float2*>(ob_ + (long long)row_hi * ot + d) =
            make_float2(o[4 * jj + 2] / lt_hi, o[4 * jj + 3] / lt_hi);
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
// rows and strides); 3xTF32 on the tensor cores, one sweep whichever form
// single_pass names (at f32 the two forms' roundings are the identity).
WDT_EXPORT int wdt_encoder_attn_f32(const void* q, const void* k, const void* v,
                                    void* out, int B, int H, int T, int ta_total,
                                    long long sb, long long sh, long long st,
                                    long long ob, long long oh, long long ot,
                                    int /*single_pass*/, void* stream) {
  if (ta_total <= 0 || ta_total > T || B <= 0 || H <= 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      enc_attn_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((T + F_BQ - 1) / F_BQ, H, B);
  enc_attn_f32_kernel<<<grid, F_THREADS, F_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), T, ta_total, sb, sh, st, ob, oh, ot,
      0.35355339059327373f /* 64^-0.25 */);
  return static_cast<int>(cudaGetLastError());
}
