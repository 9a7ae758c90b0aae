// K1 and K5: decoder cross-attention of one layer, flash style, its keys
// split across the CTAs of a thread-block cluster.
//
// K1 replaces whisper_diarize_tpu/ops/pallas_attn.py::cross_attn_layer
// (_flash_kernel, _cross_attn_impl) over the bf16 cross cache; K5 replaces
// cross_attn_layer_q8 (_flash_kernel_q8, _cross_attn_q8_impl) over the int8
// cache, whose K/V payloads carry one f32 scale per key / value position.
// Every query of a stream (beams x prompt positions; cross attention has no
// causal mask) attends that layer's cache; columns >= ta_total are masked.
//
// Numerics follow the TPU kernels whatever the caller's dtype: q is scaled
// by Dh^-0.5 in f32 and rounded to bf16; scores, running max, normalizer
// and accumulator are f32; the un-normalized probabilities are rounded to
// bf16 before the P.V product; the output is acc / l rounded to bf16. K5
// adds the scales: score = (q . k8) * ks[t], the normalizer sums the
// unscaled p, and the P.V product takes bf16(p * vs[t]) against the int8
// values (int8 -> bf16 is exact; the activations are never quantized). The
// running max moves once a 64-key tile of a span, so p is rounded against
// the span's running max: it differs from the plain version
// (`cross_attn_layer_plain`, the whole row's max) by bf16 rounding only;
// `ops/attn.py::cross_attn_split_plain` is this order in plain PyTorch.
//
// What bounds it on the H100: bytes. A sampling step reads the layer's whole
// cross K/V (B x H x 1500 x 64 x 2 x 2 bytes, 61 MB at B=8 on large-v3; int8
// with its scales 2 x (B x H x 1500 x (64 + 4)), 32.6 MB) for a few queries
// per stream, far below the card's ~295 FLOP/byte balance point. So the
// design is about keeping enough bytes in flight, on enough SMs:
// - Key split in a cluster. One (b, h, chunk of 16 queries) is a cluster of
//   n_span CTAs (<= 8, the portable size; `ops/attn.py::cross_attn_plan`
//   picks n_span and span_keys from the shape, and the fused tail passes the
//   same plan): CTA r attends keys [r * span_keys, (r + 1) * span_keys). At
//   B 8, Q <= 16 that is 2 spans of 768 keys, 320 CTAs (K5, whose int8
//   tiles hold half the bytes: 3 of 512, 480 CTAs); at B 1, 8 spans of 192
//   keys, 160 CTAs. Past that a span costs more in the combine than it
//   buys (`tools/bench_attn_kernel.py --plans` times every split). After a
//   cluster barrier each CTA combines a share of the chunk's rows (row %
//   n_span == its rank): it reads every CTA's (acc, m, l) of the row from
//   distributed shared memory (all spans' loads in flight together),
//   rescales by exp(m - max m) and sums in span order, so the result does
//   not depend on timing; a second cluster barrier keeps every CTA's shared
//   memory alive until all have read it. No second launch and no scratch in device
//   memory: the fused tail (tail.cu) calls this launcher and allocates
//   nothing.
// - Asynchronous copies. Each CTA streams its span through a ring of
//   K1_STAGES (3) tiles in dynamic shared memory, filled by cp.async 16-byte
//   copies issued by every thread (8 of K and V a thread a tile for bf16):
//   while a tile is computed the next two are in flight. cp.async rather
//   than TMA because the rows land padded to 144 bytes, so the mma fragment
//   reads (eight rows a quad at one column) hit distinct banks without a
//   swizzle, and the int8 rows (80 bytes, padded) and their per-key scales
//   come the same way; a span is a few tiles, so one thread's issue cost is
//   small beside the copy's latency.
// - All warps busy, on the tensor cores. S = Q K^T and O += P V are
//   mma.sync m16n8k16 (bf16 in, f32 accumulate) at every Q; rows past Q are
//   zero and wasted, but at Q 3 one warp's two m16n8k16 per k-step cost less
//   than the scalar FMAs and shuffles of the kernel before, which left three
//   warps of four idle at Q <= 4. At Q <= 16 (sampling steps: Q = beams)
//   each of the four warps takes 16 of a tile's 64 keys for all 16 queries
//   of the chunk; the warps share the running max (each tile's row max is
//   exchanged through shared memory), so their partial (acc, l) add without
//   a rescale at the end of the span. At Q > 16 (prompt passes) a CTA takes
//   64 queries and each warp 16 of their rows over all 64 keys of a tile, so
//   the layer is read once per 64 queries, not per 16. Both give each row
//   the same running max: the tile's max over its 64 keys.
// - K5 stages its int8 rows and f32 scales with the tile; the K fragment is
//   widened in registers, V widened once a tile into a bf16 tile (`widen16`)
//   that ldmatrix reads.
//
// The f32 forms (the TPU kernels cast q to the cache dtype and p to the V
// dtype, so at f32 every product is f32): K5's keeps its bf16 products
// (the TPU kernel casts q * scale and p * vs to bf16 whatever the
// activation dtype); only its q load and out store take f32 (the template's
// AT). K1's (`cross_attn_f32_kernel`) is the bf16 kernel's design with
// 3xTF32 products: the plan, the cluster key split, the copy ring, the
// combine in distributed shared memory and the warps' layouts (Q <= 16: the
// warps split each tile's keys; Q > 16: 64 rows a CTA, 16 a warp) are the
// bf16 kernel's, and S = Q K^T and O += P V are mma.sync m16n8k8 in TF32,
// three a product (hi / lo of each f32 operand split in registers as its
// fragment loads, common.cuh's tf32_split; lo hi' + hi lo' + hi hi' into
// one f32 accumulator; the tf32x3_* helpers below). q is scaled by Dh^-0.5 and split once; the running max
// moves once a 64-key tile, so `cross_attn_split_plain` still describes the
// order (`agreement.k1_tf32x3_model` is that order with the split
// products). The k index of each product is permuted so that P's A
// fragment is the S accumulator as it lies (no shuffle, no shared memory)
// and every fragment read is one conflict-free float2 or float4: K rows
// padded to 72 floats, V rows to 68. The ring of three K + V stages is 105
// KB, so two CTAs fit an SM. What bounds it: bytes at Q <= 16 (the f32
// cache: 123 MB a layer at B 8), the products at the 3xTF32 rate (495 / 3
// TFLOP/s) from Q ~ 100. At f32 the cache moves twice the bytes:
// `cross_attn_plan(f32=True)` aims at twice the CTAs (four spans of 384
// keys at B 8, Q <= 16), the bytes a CTA streams as the bf16 plan's.
//
// K9a, K9c and K9d: the same kernel in the three forms that
// tools/bench_attn_kernel.py measured beside K1 (_attn_4d, _attn_6d_const,
// _attn_6d_flat). K9a is K1's own entry point on one layer's K/V already
// sliced out (the layer offset applied on the host); K9c takes the whole
// cache with the layer a template constant (1); K9d keeps the TPU tool's
// split, spans of 512 keys (one CTA of the cluster each), in place of K1's
// plan.
#include "common.cuh"

#include <cooperative_groups.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int DH = K1_DH;    // head dimension (every Whisper checkpoint)
constexpr int TK = K1_TK;    // keys per shared-memory tile
constexpr int WARPS = K1_THREADS / 32;
constexpr int QC = 16;       // queries per CTA: the rows of an m16n8k16 product
constexpr int KROW = K1_KROW;
constexpr int Q8ROW = DH + 16;  // int8 K row in shared memory, bytes (80)
constexpr int SROW = DH + 4;    // f32 row of the combine state (68 words)
constexpr int MAX_SPAN = 8;     // portable cluster size

template <typename KV>
__host__ __device__ constexpr bool is_q8() { return std::is_same<KV, int8_t>::value; }

// one ring stage: bf16 K and V tiles [TK][KROW]; or int8 K [TK][Q8ROW],
// int8 V [TK][DH], f32 ks [TK], vs [TK]
template <typename KV>
__host__ __device__ constexpr int stage_bytes() {
  return is_q8<KV>() ? TK * Q8ROW + TK * DH + 2 * TK * 4 : 2 * TK * KROW * 2;
}

__host__ __device__ constexpr int part_bytes() { return 4 * QC * SROW * 4; }  // [64 rows][SROW] f32

// the ring (K5: and the widened V tile); the combine reuses the ring
template <typename KV>
__host__ __device__ constexpr int smem_bytes() {
  constexpr int ring = K1_STAGES * stage_bytes<KV>() + (is_q8<KV>() ? TK * KROW * 2 : 0);
  return ring > part_bytes() ? ring : part_bytes();
}

// int8 row chunk (16 values) -> 16 bf16 at dst (4-byte aligned), exact
__device__ __forceinline__ void widen16(const uint4& raw, bf16* dst) {
  const int8_t* b8 = reinterpret_cast<const int8_t*>(&raw);
  bf162* d2 = reinterpret_cast<bf162*>(dst);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    d2[e] = __floats2bfloat162_rn(static_cast<float>(b8[2 * e]),
                                  static_cast<float>(b8[2 * e + 1]));
}

// two int8 values -> a packed bf16 pair (exact)
__device__ __forceinline__ uint32_t widen2(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return pack_bf16(static_cast<float>(c.x), static_cast<float>(c.y));
}

// Issue one tile's copies into ring stage `st` (keys >= t_end land as 0).
__device__ __forceinline__ void stage_tile(const bf16* kb, const bf16* vb, const float*,
                                           const float*, unsigned char* st, int t0,
                                           int t_end, int tid) {
  bf16* kt = reinterpret_cast<bf16*>(st);
  k1_stage_tile_async(kb, vb, kt, kt + K1_TILE_ELEMS, t0, t_end, tid);
}

__device__ __forceinline__ void stage_tile(const int8_t* kb, const int8_t* vb,
                                           const float* ksb, const float* vsb,
                                           unsigned char* st, int t0, int t_end,
                                           int tid) {
  unsigned char* k8 = st;
  unsigned char* v8 = st + TK * Q8ROW;
  float* kss = reinterpret_cast<float*>(v8 + TK * DH);
#pragma unroll
  for (int i = tid; i < TK * (DH / 16); i += K1_THREADS) {
    const int row = i / (DH / 16), c = i % (DH / 16);
    const int key = t0 + row;
    const bool ok = key < t_end;
    const size_t off = ok ? (size_t)key * DH + c * 16 : 0;
    cp_async<16>(k8 + row * Q8ROW + c * 16, kb + off, ok);
    cp_async<16>(v8 + row * DH + c * 16, vb + off, ok);
  }
  // one scale a thread: ks for threads 0..63, vs for 64..127
  const int row = tid % TK, key = t0 + row;
  const bool ok = key < t_end;
  cp_async<4>(kss + tid, (tid < TK ? ksb : vsb) + (ok ? key : 0), ok);
}

// Q [16, 64] of this chunk as m16n8k16 A fragments: bf16(f32(q) * scale),
// rows >= Q zero; q bf16 or f32 (AT)
template <typename AT>
__device__ __forceinline__ void load_q(uint32_t (*qa)[4], const AT* q, int b, int h,
                                       int q0, int Q, int H, int g, int tg, float scale) {
#pragma unroll
  for (int kc = 0; kc < DH / 16; ++kc) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = q0 + g + (e & 1) * 8;
      const int col = kc * 16 + tg * 2 + (e >> 1) * 8;
      uint32_t val = 0u;
      if (row < Q) {
        const float2 f = load2(q + (((size_t)b * Q + row) * H + h) * DH + col);
        val = pack_bf16(f.x * scale, f.y * scale);
      }
      qa[kc][e] = val;
    }
  }
}

// The cluster's combine, shared by both kernels: after a cluster barrier,
// this CTA's rows of the chunk (row % n_span == rank), every span's (m, l,
// acc) of the row read from distributed shared memory all at once (the loop
// is unrolled: the remote loads are in flight together), rescaled by
// exp(m - max m) and summed in span order; acc / l stored as AT.
template <typename AT>
__device__ __forceinline__ void combine_spans(cg::cluster_group& cluster, float* part,
                                              float* lst, float* mst, AT* out, int qch,
                                              int q0, int Q, int b, int h, int H,
                                              int n_span, int rank, int tid) {
  for (int i = tid; i < qch * (DH / 2); i += K1_THREADS) {
    const int r = i / (DH / 2), dp = i % (DH / 2);
    if (r % n_span != rank || q0 + r >= Q) continue;
    float mv[MAX_SPAN], lv[MAX_SPAN];
    float2 av[MAX_SPAN];
    float m_max = -1e30f;
#pragma unroll
    for (int sp = 0; sp < MAX_SPAN; ++sp) {
      if (sp < n_span) {
        mv[sp] = *cluster.map_shared_rank(&mst[r], sp);
        lv[sp] = *cluster.map_shared_rank(&lst[r], sp);
        av[sp] = *reinterpret_cast<const float2*>(
            cluster.map_shared_rank(part + r * SROW + 2 * dp, sp));
      }
    }
#pragma unroll
    for (int sp = 0; sp < MAX_SPAN; ++sp)
      if (sp < n_span) m_max = fmaxf(m_max, mv[sp]);
    float l = 0.0f, a0 = 0.0f, a1 = 0.0f;
#pragma unroll
    for (int sp = 0; sp < MAX_SPAN; ++sp) {
      if (sp < n_span) {
        const float w = expf(mv[sp] - m_max);
        l = fmaf(lv[sp], w, l);
        a0 = fmaf(av[sp].x, w, a0);
        a1 = fmaf(av[sp].y, w, a1);
      }
    }
    const float inv = 1.0f / l;
    store2(out + (((size_t)b * Q + q0 + r) * H + h) * DH + 2 * dp, a0 * inv, a1 * inv);
  }
}

// KV = bf16 (K1, K9; k_scale / v_scale unused) or int8_t (K5; per-position
// f32 scales [L, B, H, Ta]); AT = bf16 or (K5's f32 form) float: q and out. kLayer < 0: the layer is the argument `layer`;
// kLayer >= 0: a compile-time layer (K9c). kRows: the CTA takes 64 queries
// and warp w their rows 16w .. 16w + 15 over all 64 keys of a tile (Q > 16:
// the prompt passes); else 16 queries and warp w keys 16w .. 16w + 15 of
// each tile for all of them. Grid (n_span, H x query chunks, B), cluster
// (n_span, 1, 1): blockIdx.x is the CTA's span.
template <typename KV, typename AT, int kLayer, bool kRows>
__global__ void __launch_bounds__(K1_THREADS)
cross_attn_kernel(const AT* __restrict__ q, const KV* __restrict__ k,
                  const float* __restrict__ k_scale, const KV* __restrict__ v,
                  const float* __restrict__ v_scale, AT* __restrict__ out, int B,
                  int Q, int H, int Ta, int layer, int ta_total, int span_keys,
                  float scale) {
  constexpr bool kQ8 = is_q8<KV>();
  constexpr int QCH = kRows ? 4 * QC : QC;  // queries a CTA
  constexpr int NT = kRows ? TK / 8 : 2;     // n8 key blocks a warp a tile
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[WARPS][QC];  // a tile's row max, by warp (key split)
  __shared__ float lst[4 * QC];     // a span's normalizer: by warp and row, then by row
  __shared__ float mst[4 * QC];     // the span's running max, by row

  cg::cluster_group cluster = cg::this_cluster();
  const int n_span = gridDim.x;
  const int rank = blockIdx.x;
  const int h = blockIdx.y % H;
  const int q0 = (blockIdx.y / H) * QCH;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int kw = kRows ? 0 : warp * 16;  // this warp's first key of a tile
  const int qr = kRows ? warp * 16 : 0;  // this warp's first row of the chunk
  const int lay = kLayer >= 0 ? kLayer : layer;
  const int t_begin = rank * span_keys;
  const int t_end = min(t_begin + span_keys, ta_total);
  const int n_tiles = (t_end - t_begin + TK - 1) / TK;

  const size_t row0 = ((size_t)lay * B * H + (size_t)b * H + h) * Ta;
  const KV* kb = k + row0 * DH;
  const KV* vb = v + row0 * DH;
  const float* ksb = kQ8 ? k_scale + row0 : nullptr;
  const float* vsb = kQ8 ? v_scale + row0 : nullptr;
  constexpr int NS = K1_STAGES;  // K5 too: six of its tiles ran slower (fewer CTAs an SM)
  bf16* vw = reinterpret_cast<bf16*>(smem + NS * stage_bytes<KV>());  // K5

  // prologue: the first NS - 1 tiles in flight (one group a tile, empty
  // where the span has fewer)
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < n_tiles)
      stage_tile(kb, vb, ksb, vsb, smem + s * stage_bytes<KV>(), t_begin + s * TK, t_end,
                 tid);
    cp_async_commit();
  }

  uint32_t qa[DH / 16][4];
  load_q(qa, q, b, h, q0 + qr, Q, H, g, tg, scale);

  float m_lo = -1e30f, m_hi = -1e30f;  // running max of rows g, g + 8
  float l_lo = 0.0f, l_hi = 0.0f;      // this thread's part of the normalizers
  float o[DH / 8][4];
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.0f;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<NS - 2>();  // this thread's copies of tile j landed
    __syncthreads();                 // everyone's landed; tile j - 1 consumed
    {
      const int nj = j + NS - 1;  // refill the stage tile j - 1 used
      if (nj < n_tiles)
        stage_tile(kb, vb, ksb, vsb, smem + (nj % NS) * stage_bytes<KV>(),
                   t_begin + nj * TK, t_end, tid);
      cp_async_commit();
    }
    unsigned char* st = smem + (j % NS) * stage_bytes<KV>();
    const int t0 = t_begin + j * TK;

    // S = Q K^T for this warp's rows and keys: s[nt][e] row g + 8 (e >> 1),
    // key kw + 8 nt + 2 tg + (e & 1)
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
      const int krow = kw + nt * 8 + g;
#pragma unroll
      for (int kc = 0; kc < DH / 16; ++kc) {
        uint32_t b0, b1;
        if constexpr (kQ8) {
          const int8_t* r = reinterpret_cast<const int8_t*>(st) + krow * Q8ROW + kc * 16 + tg * 2;
          b0 = widen2(r);
          b1 = widen2(r + 8);
        } else {
          const bf16* r = reinterpret_cast<const bf16*>(st) + krow * KROW + kc * 16 + tg * 2;
          b0 = lds32(r);
          b1 = lds32(r + 8);
        }
        mma_bf16(s[nt], qa[kc], b0, b1);
      }
    }
    const float* kss = reinterpret_cast<const float*>(st + TK * Q8ROW + TK * DH);
    float mx_lo = WDT_NEG_INF, mx_hi = WDT_NEG_INF;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kt = kw + nt * 8 + tg * 2 + (e & 1);
        float x = s[nt][e];
        if constexpr (kQ8) x *= kss[kt];
        s[nt][e] = t0 + kt < t_end ? x : WDT_NEG_INF;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[nt][0], s[nt][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[nt][2], s[nt][3]));
    }
    mx_lo = quad_max(mx_lo);
    mx_hi = quad_max(mx_hi);
    if (!kRows && tg == 0) {
      red[warp][g] = mx_lo;
      red[warp][g + 8] = mx_hi;
    }
    if constexpr (kQ8) {  // V of this tile widened to bf16 for ldmatrix
      const unsigned char* v8 = st + TK * Q8ROW;
      for (int i = tid; i < TK * (DH / 16); i += K1_THREADS) {
        const int row = i / (DH / 16), c = i % (DH / 16);
        widen16(*reinterpret_cast<const uint4*>(v8 + row * DH + c * 16),
                vw + row * KROW + c * 16);
      }
    }
    if (kQ8 || !kRows) __syncthreads();  // the tile's row maxima (K5: bf16 V) are in

    // the tile's max of each row over all its 64 keys: in the key split,
    // from every warp's part
    float tm_lo = mx_lo, tm_hi = mx_hi;
    if constexpr (!kRows) {
      tm_lo = red[0][g];
      tm_hi = red[0][g + 8];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) {
        tm_lo = fmaxf(tm_lo, red[w][g]);
        tm_hi = fmaxf(tm_hi, red[w][g + 8]);
      }
    }
    const float mn_lo = fmaxf(m_lo, tm_lo), mn_hi = fmaxf(m_hi, tm_hi);
    const float a_lo = expf(m_lo - mn_lo), a_hi = expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    const float* vss = kss + TK;
    uint32_t pa[NT / 2][4];
    float ps_lo = 0.0f, ps_hi = 0.0f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = expf(s[nt][e] - ((e >> 1) ? mn_hi : mn_lo));
      ps_lo += p[0] + p[1];  // the normalizer sums the unscaled, unrounded p
      ps_hi += p[2] + p[3];
      if constexpr (kQ8) {
        const int kt = kw + nt * 8 + tg * 2;
        const float v0 = vss[kt], v1 = vss[kt + 1];
        p[0] *= v0;
        p[1] *= v1;
        p[2] *= v0;
        p[3] *= v1;
      }
      // accumulator layout -> A fragment of keys 16 (nt / 2) .. + 15
      pa[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
      pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
    l_lo = l_lo * a_lo + ps_lo;
    l_hi = l_hi * a_hi + ps_hi;
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt) {
      o[nt][0] *= a_lo;
      o[nt][1] *= a_lo;
      o[nt][2] *= a_hi;
      o[nt][3] *= a_hi;
    }
    const bf16* vt = kQ8 ? vw : reinterpret_cast<const bf16*>(st) + K1_TILE_ELEMS;
#pragma unroll
    for (int kc = 0; kc < NT / 2; ++kc) {
      const int vrow = kw + kc * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
      for (int np = 0; np < DH / 16; ++np) {
        uint32_t vb4[4];
        ldsm_x4_trans(vb4, vt + vrow * KROW + np * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * np], pa[kc], vb4[0], vb4[1]);
        mma_bf16(o[2 * np + 1], pa[kc], vb4[2], vb4[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the span's state

  // state [QCH][SROW] (acc), lst (l), mst (m) by row of the chunk. The key
  // split's four warps share the running max: their (acc, l) [WARPS][16]
  // are summed in warp order; in the row split each warp owns its rows.
  float* part = reinterpret_cast<float*>(smem);
  {
    float* pw = part + warp * QC * SROW;
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt) {
      const int d = nt * 8 + tg * 2;
      *reinterpret_cast<float2*>(pw + g * SROW + d) = make_float2(o[nt][0], o[nt][1]);
      *reinterpret_cast<float2*>(pw + (g + 8) * SROW + d) = make_float2(o[nt][2], o[nt][3]);
    }
    l_lo = quad_sum(l_lo);
    l_hi = quad_sum(l_hi);
    if (tg == 0) {
      lst[warp * QC + g] = l_lo;
      lst[warp * QC + g + 8] = l_hi;
      if (kRows || warp == 0) {
        mst[qr + g] = m_lo;
        mst[qr + g + 8] = m_hi;
      }
    }
  }
  __syncthreads();
  if constexpr (!kRows) {
    for (int i = tid; i < QC * DH; i += K1_THREADS) {
      const int r = i / DH, d = i % DH;
      float a = part[r * SROW + d];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) a += part[(w * QC + r) * SROW + d];
      part[r * SROW + d] = a;
    }
    float a = 0.0f;
    if (tid < QC) {
      a = lst[tid];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) a += lst[w * QC + tid];
    }
    __syncthreads();  // every warp's l read before row tid's is written
    if (tid < QC) lst[tid] = a;
  }
  cluster.sync();  // every span's state is in its CTA's shared memory
  combine_spans(cluster, part, lst, mst, out, QCH, q0, Q, b, h, H, n_span, rank, tid);
  cluster.sync();  // no CTA leaves while another may still read its state
}

// The attention of one warp's 16 query rows against a 64-key tile in
// shared memory (K10-f32 runs the same products as wgmma, encoder_attn.cu,
// with the same k order for P V). K rows lie TF32_KROW floats apart, V
// rows TF32_VROW. The k index of each product is permuted inside every
// 8-wide step, the same way in both operands, which leaves the sums as
// they are:
// - S = Q K^T, step s: slot tg <-> dim 8s + 2tg, slot tg + 4 <-> dim
//   8s + 2tg + 1, so a thread reads one float2 of its q rows and of its K
//   row a step (eight K rows a quad at 72 floats: distinct banks);
// - O += P V, step j (keys 8j .. 8j + 7): slot tg <-> key 8j + 2tg, slot
//   tg + 4 <-> key 8j + 2tg + 1, so the S accumulator of those keys is
//   already P's A fragment (p[0], p[2] / p[1], p[3]): no shuffle, no shared
//   memory;
// - P V's columns: n8 block nb, column c <-> dim (nb & 3) + 4c + 32 (nb >> 2),
//   so a thread reads its V rows as float4 (rows 2tg, 2tg + 1 at 68 floats:
//   distinct banks) and holds output dims 8tg .. 8tg + 7 and 32 + 8tg ..
//   32 + 8tg + 7 of rows g and g + 8 (`tf32x3_out_dims`).
constexpr int TF32_KROW = 72;  // floats a K row in shared memory (64 + 8)
constexpr int TF32_VROW = 68;  // floats a V row (64 + 4)

// The A fragments of 16 query rows (row0: row g, row8: row g + 8, nullptr
// for a row past the queries: zeros) times `scale`, split for 3xTF32
__device__ __forceinline__ void tf32x3_q_frags(uint32_t (*qh)[4], uint32_t (*ql)[4],
                                               const float* row0, const float* row8, int tg,
                                               float scale) {
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const float2 zero = make_float2(0.0f, 0.0f);
    const float2 a = row0 ? *reinterpret_cast<const float2*>(row0 + 8 * s + 2 * tg) : zero;
    const float2 b = row8 ? *reinterpret_cast<const float2*>(row8 + 8 * s + 2 * tg) : zero;
    tf32_split(a.x * scale, qh[s][0], ql[s][0]);
    tf32_split(b.x * scale, qh[s][1], ql[s][1]);
    tf32_split(a.y * scale, qh[s][2], ql[s][2]);
    tf32_split(b.y * scale, qh[s][3], ql[s][3]);
  }
}

// s[nt] = Q K^T for keys 8nt .. 8nt + 7 of `kt` (row 8nt + g of this
// thread's B fragment), nt < NT; each K value times `kscale` first where
// kScaleK
template <int NT, bool kScaleK>
__device__ __forceinline__ void tf32x3_scores(float (*s)[4], const uint32_t (*qh)[4],
                                              const uint32_t (*ql)[4], const float* kt, int g,
                                              int tg, float kscale) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
    const float* kr = kt + (8 * nt + g) * TF32_KROW + 2 * tg;
#pragma unroll
    for (int st = 0; st < 8; ++st) {
      float2 kv = *reinterpret_cast<const float2*>(kr + 8 * st);
      if (kScaleK) {
        kv.x *= kscale;
        kv.y *= kscale;
      }
      uint32_t bh0, bl0, bh1, bl1;
      tf32_split(kv.x, bh0, bl0);
      tf32_split(kv.y, bh1, bl1);
      mma_tf32x3(s[nt], qh[st], ql[st], bh0, bh1, bl0, bl1);
    }
  }
}

// o += P V for keys 8j .. 8j + 7 of `vt`, j < NJ; p[j] the probabilities of
// those keys in the S accumulator's layout. The tensor cores add into their
// accumulator truncating (toward zero), so a chain of products biases it:
// over a row's 188 key steps that left K10-f32 (whose first form ran on
// these helpers) 1.05e-5 from its plain version (H100), past the f32 check.
// The tile's products therefore start from zero, and the tile's sum joins o
// in an f32 add on the CUDA cores.
template <int NJ>
__device__ __forceinline__ void tf32x3_pv(float (*o)[4], const float (*p)[4], const float* vt,
                                          int g, int tg) {
  float t[8][4];
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) t[nb][0] = t[nb][1] = t[nb][2] = t[nb][3] = 0.0f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    uint32_t ah[4], al[4];
    tf32_split(p[j][0], ah[0], al[0]);  // row g, key 2tg
    tf32_split(p[j][2], ah[1], al[1]);  // row g + 8, key 2tg
    tf32_split(p[j][1], ah[2], al[2]);  // row g, key 2tg + 1
    tf32_split(p[j][3], ah[3], al[3]);  // row g + 8, key 2tg + 1
    const float* v0 = vt + (8 * j + 2 * tg) * TF32_VROW + 4 * g;
    const float* v1 = v0 + TF32_VROW;
    const float4 x0 = *reinterpret_cast<const float4*>(v0);
    const float4 x1 = *reinterpret_cast<const float4*>(v0 + 32);
    const float4 y0 = *reinterpret_cast<const float4*>(v1);
    const float4 y1 = *reinterpret_cast<const float4*>(v1 + 32);
    const float b0[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    const float b1[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      uint32_t bh0, bl0, bh1, bl1;
      tf32_split(b0[nb], bh0, bl0);
      tf32_split(b1[nb], bh1, bl1);
      mma_tf32x3(t[nb], ah, al, bh0, bh1, bl0, bl1);
    }
  }
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nb][e] += t[nb][e];
  }
}

// The output accumulator's dims of row g (half 0) or g + 8 (half 1),
// divided by `l`, as four float4: `dst(d, value)` stores dims d .. d + 3
// for d = 8tg, 8tg + 4, 32 + 8tg, 32 + 8tg + 4
template <typename Store>
__device__ __forceinline__ void tf32x3_out_dims(const float (*o)[4], int half, int tg, float l,
                                                Store dst) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = 2 * half + (i & 1), nb = 4 * (i >> 1);
    dst(8 * tg + 4 * (i & 1) + 32 * (i >> 1),
        make_float4(o[nb][e] / l, o[nb + 1][e] / l, o[nb + 2][e] / l, o[nb + 3][e] / l));
  }
}

// K1's f32 form: the kernel above with f32 tiles and 3xTF32 products (see
// the head of this file and the tf32x3_* helpers above). Rows of the
// chunk: QCH (16, or 64 where kRows); the warps split them as the bf16
// kernel's do.
constexpr int F32_STAGE = TK * (TF32_KROW + TF32_VROW);  // K and V tiles, floats

__host__ __device__ constexpr int f32_smem_bytes() {
  return K1_STAGES * F32_STAGE * 4;  // the ring; the combine's state reuses it
}
static_assert(f32_smem_bytes() >= part_bytes(), "the combine's state fits the ring");

// Issue one f32 tile's copies (keys >= t_end land as 0): 8 of K and 8 of V
// a thread, 16 bytes each
__device__ __forceinline__ void stage_tile_f32(const float* kb, const float* vb, float* kt,
                                               int t0, int t_end, int tid) {
  float* vt = kt + TK * TF32_KROW;
#pragma unroll
  for (int i = tid; i < TK * (DH / 4); i += K1_THREADS) {
    const int row = i / (DH / 4), c = i % (DH / 4);
    const int key = t0 + row;
    const bool ok = key < t_end;
    const size_t off = ok ? (size_t)key * DH + c * 4 : 0;
    cp_async<16>(kt + row * TF32_KROW + c * 4, kb + off, ok);
    cp_async<16>(vt + row * TF32_VROW + c * 4, vb + off, ok);
  }
}

template <bool kRows>
__global__ void __launch_bounds__(K1_THREADS, 2)
cross_attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out, int B, int Q,
                      int H, int Ta, int layer, int ta_total, int span_keys, float scale) {
  constexpr int QCH = kRows ? 4 * QC : QC;  // queries a CTA
  constexpr int NT = kRows ? TK / 8 : 2;     // n8 key blocks a warp a tile
  constexpr int NS = K1_STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[WARPS][QC];  // a tile's row max, by warp (key split)
  __shared__ float lst[4 * QC];     // a span's normalizer: by warp and row, then by row
  __shared__ float mst[4 * QC];     // the span's running max, by row

  cg::cluster_group cluster = cg::this_cluster();
  const int n_span = gridDim.x;
  const int rank = blockIdx.x;
  const int h = blockIdx.y % H;
  const int q0 = (blockIdx.y / H) * QCH;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int kw = kRows ? 0 : warp * 16;  // this warp's first key of a tile
  const int qr = kRows ? warp * 16 : 0;  // this warp's first row of the chunk
  const int t_begin = rank * span_keys;
  const int t_end = min(t_begin + span_keys, ta_total);
  const int n_tiles = (t_end - t_begin + TK - 1) / TK;
  const size_t row0 = ((size_t)layer * B * H + (size_t)b * H + h) * Ta;
  const float* kb = k + row0 * DH;
  const float* vb = v + row0 * DH;
  float* ring = reinterpret_cast<float*>(smem);

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < n_tiles) stage_tile_f32(kb, vb, ring + s * F32_STAGE, t_begin + s * TK, t_end, tid);
    cp_async_commit();
  }

  // the chunk's queries times Dh^-0.5 (f32: the cast to the cache dtype is
  // the identity), split once; rows past Q are zeros and never stored
  uint32_t qh[DH / 8][4], ql[DH / 8][4];
  {
    const int r = q0 + qr + g;
    const float* base = q + (((size_t)b * Q + r) * H + h) * DH;
    tf32x3_q_frags(qh, ql, r < Q ? base : nullptr, r + 8 < Q ? base + (size_t)8 * H * DH : nullptr,
                   tg, scale);
  }

  float m_lo = -1e30f, m_hi = -1e30f;  // running max of rows g, g + 8
  float l_lo = 0.0f, l_hi = 0.0f;      // this thread's part of the normalizers
  float o[DH / 8][4];
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.0f;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<NS - 2>();  // this thread's copies of tile j landed
    __syncthreads();          // everyone's landed; tile j - 1 consumed
    {
      const int nj = j + NS - 1;  // refill the stage tile j - 1 used
      if (nj < n_tiles)
        stage_tile_f32(kb, vb, ring + (nj % NS) * F32_STAGE, t_begin + nj * TK, t_end, tid);
      cp_async_commit();
    }
    const float* kt = ring + (j % NS) * F32_STAGE;
    const float* vt = kt + TK * TF32_KROW;
    const int t0 = t_begin + j * TK;

    // S = Q K^T for this warp's rows and keys: s[nt][e] row g + 8 (e >> 1),
    // key kw + 8 nt + 2 tg + (e & 1)
    float s[NT][4];
    tf32x3_scores<NT, false>(s, qh, ql, kt + kw * TF32_KROW, g, tg, 1.0f);
    float mx_lo = WDT_NEG_INF, mx_hi = WDT_NEG_INF;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (t0 + kw + nt * 8 + tg * 2 + (e & 1) >= t_end) s[nt][e] = WDT_NEG_INF;
      mx_lo = fmaxf(mx_lo, fmaxf(s[nt][0], s[nt][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[nt][2], s[nt][3]));
    }
    mx_lo = quad_max(mx_lo);
    mx_hi = quad_max(mx_hi);
    // the tile's max of each row over all its 64 keys: in the key split,
    // from every warp's part
    if constexpr (!kRows) {
      if (tg == 0) {
        red[warp][g] = mx_lo;
        red[warp][g + 8] = mx_hi;
      }
      __syncthreads();
      mx_lo = red[0][g];
      mx_hi = red[0][g + 8];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) {
        mx_lo = fmaxf(mx_lo, red[w][g]);
        mx_hi = fmaxf(mx_hi, red[w][g + 8]);
      }
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float a_lo = expf(m_lo - mn_lo), a_hi = expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float ps_lo = 0.0f, ps_hi = 0.0f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = expf(s[nt][e] - ((e >> 1) ? mn_hi : mn_lo));
      ps_lo += s[nt][0] + s[nt][1];
      ps_hi += s[nt][2] + s[nt][3];
    }
    l_lo = l_lo * a_lo + ps_lo;
    l_hi = l_hi * a_hi + ps_hi;
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt) {
      o[nt][0] *= a_lo;
      o[nt][1] *= a_lo;
      o[nt][2] *= a_hi;
      o[nt][3] *= a_hi;
    }
    tf32x3_pv<NT>(o, s, vt + kw * TF32_VROW, g, tg);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the span's state

  // state [QCH][SROW] (acc), lst (l), mst (m) by row of the chunk, as the
  // bf16 kernel keeps it: the key split's (acc, l) [WARPS][16] summed in
  // warp order, the row split's rows each a warp's own
  float* part = reinterpret_cast<float*>(smem);
  {
    float* pw = part + warp * QC * SROW;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float* pr = pw + (g + 8 * half) * SROW;
      tf32x3_out_dims(o, half, tg, 1.0f, [&](int d, float4 x) {
        *reinterpret_cast<float4*>(pr + d) = x;
      });
    }
    l_lo = quad_sum(l_lo);
    l_hi = quad_sum(l_hi);
    if (tg == 0) {
      lst[warp * QC + g] = l_lo;
      lst[warp * QC + g + 8] = l_hi;
      if (kRows || warp == 0) {
        mst[qr + g] = m_lo;
        mst[qr + g + 8] = m_hi;
      }
    }
  }
  __syncthreads();
  if constexpr (!kRows) {
    for (int i = tid; i < QC * DH; i += K1_THREADS) {
      const int r = i / DH, d = i % DH;
      float a = part[r * SROW + d];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) a += part[(w * QC + r) * SROW + d];
      part[r * SROW + d] = a;
    }
    float a = 0.0f;
    if (tid < QC) {
      a = lst[tid];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) a += lst[w * QC + tid];
    }
    __syncthreads();  // every warp's l read before row tid's is written
    if (tid < QC) lst[tid] = a;
  }
  cluster.sync();  // every span's state is in its CTA's shared memory
  combine_spans(cluster, part, lst, mst, out, QCH, q0, Q, b, h, H, n_span, rank, tid);
  cluster.sync();  // no CTA leaves while another may still read its state
}

constexpr float kScale = 0.125f;  // 64^-0.5
constexpr int kConstLayer = 1;    // K9c's layer, as _attn_6d_const fixed it

// a cluster launch of `kern`: grid (n_span, H x chunks of qch queries, B)
template <typename Kern, typename... Args>
cudaError_t launch_cluster(Kern kern, int smem, int qch, int B, int Q, int H, int n_span,
                           cudaStream_t stream, Args... args) {
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = n_span;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_span, H * ((Q + qch - 1) / qch), B);
  cfg.blockDim = dim3(K1_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, args...);
}

template <typename KV, typename AT, int kLayer, bool kRows>
cudaError_t launch_split(const AT* q, const KV* k, const float* ks, const KV* v,
                         const float* vs, AT* out, int B, int Q, int H, int Ta,
                         int layer, int ta_total, int n_span, int span_keys,
                         cudaStream_t stream) {
  constexpr int QCH = kRows ? 4 * QC : QC;
  auto kern = cross_attn_kernel<KV, AT, kLayer, kRows>;
  constexpr int smem = smem_bytes<KV>();
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  return launch_cluster(kern, smem, QCH, B, Q, H, n_span, stream, q, k, ks, v, vs, out, B,
                        Q, H, Ta, layer, ta_total, span_keys, kScale);
}

// a plan that covers [0, ta_total) with non-empty spans of whole tiles
bool plan_ok(int Ta, int ta_total, int n_span, int span_keys) {
  return n_span >= 1 && n_span <= MAX_SPAN && span_keys > 0 && span_keys % TK == 0 &&
         ta_total > 0 && ta_total <= Ta && (long long)n_span * span_keys >= ta_total &&
         (long long)(n_span - 1) * span_keys < ta_total;
}

// The plan checked, then the key split (Q <= 16) or the row split (Q > 16;
// ops/attn.py::cross_attn_plan counts query chunks the same way).
template <typename KV, typename AT, int kLayer>
cudaError_t launch(const AT* q, const KV* k, const float* ks, const KV* v,
                   const float* vs, AT* out, int B, int Q, int H, int Ta, int layer,
                   int ta_total, int n_span, int span_keys, cudaStream_t stream) {
  if (!plan_ok(Ta, ta_total, n_span, span_keys)) return cudaErrorInvalidValue;
  if (Q > QC)
    return launch_split<KV, AT, kLayer, true>(q, k, ks, v, vs, out, B, Q, H, Ta, layer,
                                              ta_total, n_span, span_keys, stream);
  return launch_split<KV, AT, kLayer, false>(q, k, ks, v, vs, out, B, Q, H, Ta, layer,
                                             ta_total, n_span, span_keys, stream);
}

template <bool kRows>
cudaError_t launch_f32_split(const float* q, const float* k, const float* v, float* out,
                             int B, int Q, int H, int Ta, int layer, int ta_total,
                             int n_span, int span_keys, cudaStream_t stream) {
  auto kern = cross_attn_f32_kernel<kRows>;
  constexpr int smem = f32_smem_bytes();
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  return launch_cluster(kern, smem, kRows ? 4 * QC : QC, B, Q, H, n_span, stream, q, k, v,
                        out, B, Q, H, Ta, layer, ta_total, span_keys, kScale);
}

int finish(cudaError_t err) {
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

cudaError_t launch_cross_attn(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                              int B, int Q, int H, int Ta, int layer, int ta_total,
                              int n_span, int span_keys, cudaStream_t stream) {
  return launch<bf16, bf16, -1>(q, k, nullptr, v, nullptr, out, B, Q, H, Ta, layer, ta_total,
                                n_span, span_keys, stream);
}

cudaError_t launch_cross_attn_q8(const bf16* q, const int8_t* k8, const float* ks,
                                 const int8_t* v8, const float* vs, bf16* out, int B,
                                 int Q, int H, int Ta, int layer, int ta_total,
                                 int n_span, int span_keys, cudaStream_t stream) {
  return launch<int8_t, bf16, -1>(q, k8, ks, v8, vs, out, B, Q, H, Ta, layer, ta_total,
                                  n_span, span_keys, stream);
}

cudaError_t launch_cross_attn_f32(const float* q, const float* k, const float* v, float* out,
                                  int B, int Q, int H, int Ta, int layer, int ta_total,
                                  int n_span, int span_keys, cudaStream_t stream) {
  if (!plan_ok(Ta, ta_total, n_span, span_keys)) return cudaErrorInvalidValue;
  if (Q > QC)
    return launch_f32_split<true>(q, k, v, out, B, Q, H, Ta, layer, ta_total, n_span,
                                  span_keys, stream);
  return launch_f32_split<false>(q, k, v, out, B, Q, H, Ta, layer, ta_total, n_span,
                                 span_keys, stream);
}

cudaError_t launch_cross_attn_q8_f32(const float* q, const int8_t* k8, const float* ks,
                                     const int8_t* v8, const float* vs, float* out, int B,
                                     int Q, int H, int Ta, int layer, int ta_total,
                                     int n_span, int span_keys, cudaStream_t stream) {
  return launch<int8_t, float, -1>(q, k8, ks, v8, vs, out, B, Q, H, Ta, layer, ta_total,
                                   n_span, span_keys, stream);
}

// q [B, Q, H, 64], k / v [L, B, H, Ta, 64] bf16; out [B, Q, H, 64]; all
// contiguous; 0 < ta_total <= Ta; the plan (n_span, span_keys) of
// ops/attn.py::cross_attn_plan.
WDT_EXPORT int wdt_cross_attn(const void* q, const void* k, const void* v, void* out,
                              int B, int Q, int H, int Ta, int layer, int ta_total,
                              int n_span, int span_keys, void* stream) {
  return finish(launch_cross_attn(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), B, Q, H, Ta, layer, ta_total,
      n_span, span_keys, static_cast<cudaStream_t>(stream)));
}

// q [B, Q, H, 64] bf16; k8 / v8 [L, B, H, Ta, 64] int8; ks / vs [L, B, H, Ta]
// f32; out [B, Q, H, 64] bf16; all contiguous; the plan as for K1.
WDT_EXPORT int wdt_cross_attn_q8(const void* q, const void* k8, const void* ks,
                                 const void* v8, const void* vs, void* out, int B,
                                 int Q, int H, int Ta, int layer, int ta_total,
                                 int n_span, int span_keys, void* stream) {
  return finish(launch_cross_attn_q8(
      static_cast<const bf16*>(q), static_cast<const int8_t*>(k8),
      static_cast<const float*>(ks), static_cast<const int8_t*>(v8),
      static_cast<const float*>(vs), static_cast<bf16*>(out), B, Q, H, Ta, layer,
      ta_total, n_span, span_keys, static_cast<cudaStream_t>(stream)));
}

// K1's and K5's f32 forms: q, out [B, Q, H, 64] f32; k / v [L, B, H, Ta, 64]
// f32 (K1) or int8 with ks / vs [L, B, H, Ta] f32 (K5); the plan as above
// (ops/attn.py::cross_attn_plan with f32=True for K1).
WDT_EXPORT int wdt_cross_attn_f32(const void* q, const void* k, const void* v, void* out,
                                  int B, int Q, int H, int Ta, int layer, int ta_total,
                                  int n_span, int span_keys, void* stream) {
  return finish(launch_cross_attn_f32(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), B, Q, H, Ta, layer, ta_total,
      n_span, span_keys, static_cast<cudaStream_t>(stream)));
}

WDT_EXPORT int wdt_cross_attn_q8_f32(const void* q, const void* k8, const void* ks,
                                     const void* v8, const void* vs, void* out, int B,
                                     int Q, int H, int Ta, int layer, int ta_total,
                                     int n_span, int span_keys, void* stream) {
  return finish(launch_cross_attn_q8_f32(
      static_cast<const float*>(q), static_cast<const int8_t*>(k8),
      static_cast<const float*>(ks), static_cast<const int8_t*>(v8),
      static_cast<const float*>(vs), static_cast<float*>(out), B, Q, H, Ta, layer,
      ta_total, n_span, span_keys, static_cast<cudaStream_t>(stream)));
}

// K9c: as K1 with the layer fixed at kConstLayer; k / v [L >= 2, B, H, Ta, 64].
WDT_EXPORT int wdt_cross_attn_const_layer(const void* q, const void* k, const void* v,
                                          void* out, int B, int Q, int H, int Ta,
                                          int ta_total, int n_span, int span_keys,
                                          void* stream) {
  return finish(launch<bf16, bf16, kConstLayer>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), nullptr,
      static_cast<const bf16*>(v), nullptr, static_cast<bf16*>(out), B, Q, H, Ta, 0,
      ta_total, n_span, span_keys, static_cast<cudaStream_t>(stream)));
}
