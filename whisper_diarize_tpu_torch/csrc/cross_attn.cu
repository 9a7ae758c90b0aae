// K1 and K5: decoder cross-attention of one layer, flash style.
//
// K1 replaces whisper_diarize_tpu/ops/pallas_attn.py::cross_attn_layer
// (_flash_kernel, _cross_attn_impl) over the bf16 cross cache; K5 replaces
// cross_attn_layer_q8 (_flash_kernel_q8, _cross_attn_q8_impl) over the int8
// cache, whose K/V payloads carry one f32 scale per key / value position.
// Every query of a stream (beams x prompt positions; cross attention has no
// causal mask) attends that layer's cache in one online-softmax pass;
// columns >= ta_total are masked.
//
// Numerics follow the TPU kernels whatever the caller's dtype: q is scaled
// by Dh^-0.5 in f32 and rounded to bf16; scores, running max, normalizer
// and accumulator are f32; the un-normalized probabilities are rounded to
// bf16 before the P.V product; the output is acc / l rounded to bf16. K5
// adds the scales: score = (q . k8) * ks[t], the normalizer sums the
// unscaled p, and the P.V product takes bf16(p * vs[t]) against the int8
// values. int8 -> bf16 is exact, so K5 widens the payload while staging it
// and the arithmetic is K1's; the activations are never quantized (no int8
// tensor-core product).
//
// What bounds it on the H100: bytes. A sampling step reads the layer's whole
// cross K/V (B x H x 1500 x 64 x 2 x 2 bytes, 61 MB at B=8 on large-v3; int8
// with its scales 2 x (B x H x 1500 x (64 + 4)), 32.6 MB) for a few queries
// per stream, far below the card's ~295 FLOP/byte balance point.
// Design: the cache is [L, B, H, Ta, Dh] contiguous, so one (b, h) slab is
// one contiguous stream (a 64-element bf16 row is one 128-byte line, an int8
// row four 16-byte loads); the layer is a pointer offset. One CTA per (b, h,
// chunk of 16 queries) streams the slab once through shared memory in
// 64-key tiles, widened to bf16 there, and keeps the flash state in
// registers, so K/V is read once per chunk of queries. Splitting the audio
// axis across CTAs (flash-decoding, for the small-B sampling step) is left
// for later work.
//
// K9a, K9c and K9d: the same kernel in the three forms that
// tools/bench_attn_kernel.py measured beside K1 (_attn_4d, _attn_6d_const,
// _attn_6d_flat), as probes of where K1's time goes. K9a is K1's own entry
// point on one layer's K/V already sliced out (the layer offset applied on
// the host, wdt_cross_attn at layer 0 of a one-layer cache); K9c takes the
// whole cache with the layer a template constant (1), so it differs from K1
// only in how the layer offset is formed.
// K9d splits the audio axis: one CTA per (b, h, chunk of queries, span of
// span_keys keys) runs K1's loop over its span and writes f32 (acc, m, l);
// combine_spans_kernel rescales each span by exp(m - max m) and sums. Its
// bf16 p is rounded against the span's running max, not the whole row's, so
// it differs from K1 by bf16 rounding. No TMA, no tensor cores: it asks
// only what more CTAs buy.
#include "common.cuh"

#include <type_traits>

namespace {

constexpr int DH = K1_DH;     // head dimension (every Whisper checkpoint)
constexpr int TK = K1_TK;     // keys per shared-memory tile
constexpr int QPW = 4;        // queries per warp
constexpr int WARPS = K1_THREADS / 32;
constexpr int QC = QPW * WARPS;  // queries per CTA
constexpr int KROW = K1_KROW;  // padded bf16 row (33 words: conflict-free column reads)

// One 64-key tile of a (b, h) slab's K and V rows into shared memory as
// bf16; keys >= Ta read as 0 (common.cuh, shared with K9b).
__device__ __forceinline__ void stage_tile(const bf16* kb, const bf16* vb,
                                           bf16 (*kt)[KROW], bf16 (*vt)[KROW],
                                           int t0, int Ta, int tid) {
  k1_stage_tile(kb, vb, kt, vt, t0, Ta, tid);
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

// int8: 64 rows x 4 chunks of 16 bytes, for K and for V
__device__ __forceinline__ void stage_tile(const int8_t* kb, const int8_t* vb,
                                           bf16 (*kt)[KROW], bf16 (*vt)[KROW],
                                           int t0, int Ta, int tid) {
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < TK * (DH / 16); i += WARPS * 32) {
    const int row = i / (DH / 16), c = i % (DH / 16);
    const int key = t0 + row;
    uint4 kk = zero4, vv = zero4;
    if (key < Ta) {
      kk = reinterpret_cast<const uint4*>(kb + (size_t)key * DH)[c];
      vv = reinterpret_cast<const uint4*>(vb + (size_t)key * DH)[c];
    }
    widen16(kk, &kt[row][c * 16]);
    widen16(vv, &vt[row][c * 16]);
  }
}

// KV = bf16 (K1, K9; k_scale / v_scale unused) or int8_t (K5; per-position
// f32 scales [L, B, H, Ta]). kLayer < 0: the layer is the argument `layer`;
// kLayer >= 0: a compile-time layer (K9c). kSplit (K9d): blockIdx.z is
// b * n_span + span, the CTA attends keys [span * span_keys, + span_keys)
// and writes its unnormalized state to `part` [B, n_span, H, Q, DH + 2]
// (acc, then m and l) in place of `out`.
template <typename KV, int kLayer, bool kSplit>
__global__ void __launch_bounds__(WARPS * 32)
cross_attn_kernel(const bf16* __restrict__ q, const KV* __restrict__ k,
                  const float* __restrict__ k_scale, const KV* __restrict__ v,
                  const float* __restrict__ v_scale, bf16* __restrict__ out,
                  float* __restrict__ part, int B, int Q, int H, int Ta,
                  int layer, int ta_total, int span_keys, float scale) {
  constexpr bool kQ8 = std::is_same<KV, int8_t>::value;
  __shared__ __align__(16) float qs[QC][DH];
  __shared__ __align__(16) bf16 kt[TK][KROW];
  __shared__ __align__(16) bf16 vt[TK][KROW];
  __shared__ float kscale[kQ8 ? TK : 1], vscale[kQ8 ? TK : 1];

  const int q0 = blockIdx.x * QC;
  const int h = blockIdx.y;
  const int n_span = kSplit ? gridDim.z / B : 1;
  const int b = blockIdx.z / n_span;
  const int span = blockIdx.z % n_span;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int lay = kLayer >= 0 ? kLayer : layer;
  const int t_begin = kSplit ? span * span_keys : 0;
  const int t_end = kSplit ? min(Ta, t_begin + span_keys) : Ta;

  const size_t row0 = ((size_t)lay * B * H + (size_t)b * H + h) * Ta;
  const KV* kb = k + row0 * DH;
  const KV* vb = v + row0 * DH;

  // queries of this chunk: bf16(f32(q) * scale), kept as f32 in shared memory
  for (int i = tid; i < QC * DH; i += WARPS * 32) {
    const int qi = i / DH, d = i % DH;
    float val = 0.0f;
    if (q0 + qi < Q) {
      val = __bfloat162float(q[(((size_t)b * Q + q0 + qi) * H + h) * DH + d]);
      val = bf16_round(val * scale);
    }
    qs[qi][d] = val;
  }

  float m[QPW], l[QPW], acc0[QPW], acc1[QPW];
#pragma unroll
  for (int j = 0; j < QPW; ++j) {
    m[j] = -1e30f;
    l[j] = 0.0f;
    acc0[j] = 0.0f;
    acc1[j] = 0.0f;
  }

  for (int t0 = t_begin; t0 < t_end; t0 += TK) {
    __syncthreads();  // previous tile fully consumed (and qs written)
    stage_tile(kb, vb, kt, vt, t0, t_end, tid);
    if constexpr (kQ8) {
      if (tid < TK) {
        const int key = t0 + tid;
        kscale[tid] = key < Ta ? k_scale[row0 + key] : 0.0f;
        vscale[tid] = key < Ta ? v_scale[row0 + key] : 0.0f;
      }
    }
    __syncthreads();

    const int key0 = t0 + lane, key1 = t0 + lane + 32;
    const bool ok0 = key0 < t_end && key0 < ta_total;
    const bool ok1 = key1 < t_end && key1 < ta_total;
    float ks0 = 1.0f, ks1 = 1.0f, vs0 = 1.0f, vs1 = 1.0f;
    if constexpr (kQ8) {
      ks0 = kscale[lane];
      ks1 = kscale[lane + 32];
      vs0 = vscale[lane];
      vs1 = vscale[lane + 32];
    }
#pragma unroll
    for (int j = 0; j < QPW; ++j) {
      const int qi = warp * QPW + j;
      if (q0 + qi >= Q) break;  // uniform across the warp
      float s0 = 0.0f, s1 = 0.0f;
      const bf162* k0row = reinterpret_cast<const bf162*>(&kt[lane][0]);
      const bf162* k1row = reinterpret_cast<const bf162*>(&kt[lane + 32][0]);
#pragma unroll 8
      for (int dp = 0; dp < DH / 2; ++dp) {
        const float2 qq = *reinterpret_cast<const float2*>(&qs[qi][2 * dp]);
        const float2 a = __bfloat1622float2(k0row[dp]);
        const float2 c = __bfloat1622float2(k1row[dp]);
        s0 = fmaf(qq.x, a.x, fmaf(qq.y, a.y, s0));
        s1 = fmaf(qq.x, c.x, fmaf(qq.y, c.y, s1));
      }
      s0 = ok0 ? s0 * ks0 : WDT_NEG_INF;
      s1 = ok1 ? s1 * ks1 : WDT_NEG_INF;
      const float m_new = fmaxf(m[j], warp_max(fmaxf(s0, s1)));
      const float alpha = expf(m[j] - m_new);
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      l[j] = l[j] * alpha + warp_sum(p0 + p1);  // unscaled probabilities
      const float pb0 = bf16_round(p0 * vs0), pb1 = bf16_round(p1 * vs1);
      float a0 = acc0[j] * alpha, a1 = acc1[j] * alpha;
      // lane owns output dims (2 * lane, 2 * lane + 1)
#pragma unroll 8
      for (int kk = 0; kk < 32; ++kk) {
        const float p = __shfl_sync(0xffffffffu, pb0, kk);
        const float2 vv = __bfloat1622float2(
            reinterpret_cast<const bf162*>(&vt[kk][0])[lane]);
        a0 = fmaf(p, vv.x, a0);
        a1 = fmaf(p, vv.y, a1);
      }
#pragma unroll 8
      for (int kk = 0; kk < 32; ++kk) {
        const float p = __shfl_sync(0xffffffffu, pb1, kk);
        const float2 vv = __bfloat1622float2(
            reinterpret_cast<const bf162*>(&vt[kk + 32][0])[lane]);
        a0 = fmaf(p, vv.x, a0);
        a1 = fmaf(p, vv.y, a1);
      }
      acc0[j] = a0;
      acc1[j] = a1;
      m[j] = m_new;
    }
  }

#pragma unroll
  for (int j = 0; j < QPW; ++j) {
    const int qi = q0 + warp * QPW + j;
    if (qi >= Q) break;
    if constexpr (kSplit) {
      float* st = part + ((((size_t)b * n_span + span) * H + h) * Q + qi) * (DH + 2);
      reinterpret_cast<float2*>(st)[lane] = make_float2(acc0[j], acc1[j]);
      if (lane == 0) {
        st[DH] = m[j];
        st[DH + 1] = l[j];
      }
    } else {
      const float inv = 1.0f / l[j];
      bf162* o = reinterpret_cast<bf162*>(out + (((size_t)b * Q + qi) * H + h) * DH);
      o[lane] = __floats2bfloat162_rn(acc0[j] * inv, acc1[j] * inv);
    }
  }
}

// K9d's second pass: one warp per output row (b, q, h) rescales every
// span's (acc, l) by exp(m - max m), sums them in span order and writes
// bf16(acc / l); lane owns dims (2 * lane, 2 * lane + 1).
__global__ void __launch_bounds__(128)
combine_spans_kernel(const float* __restrict__ part, bf16* __restrict__ out,
                     int B, int Q, int H, int n_span) {
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= B * Q * H) return;
  const int h = row % H, qi = (row / H) % Q, b = row / (H * Q);
  const size_t stride = (size_t)H * Q * (DH + 2);  // from one span to the next
  const float* st = part + (((size_t)b * n_span * H + h) * Q + qi) * (DH + 2);
  float m_max = -1e30f;
  for (int s = 0; s < n_span; ++s) m_max = fmaxf(m_max, st[s * stride + DH]);
  float l = 0.0f, a0 = 0.0f, a1 = 0.0f;
  for (int s = 0; s < n_span; ++s) {
    const float* sp = st + s * stride;
    const float w = expf(sp[DH] - m_max);
    const float2 acc = reinterpret_cast<const float2*>(sp)[lane];
    l = fmaf(sp[DH + 1], w, l);
    a0 = fmaf(acc.x, w, a0);
    a1 = fmaf(acc.y, w, a1);
  }
  const float inv = 1.0f / l;
  reinterpret_cast<bf162*>(out + (size_t)row * DH)[lane] =
      __floats2bfloat162_rn(a0 * inv, a1 * inv);
}

constexpr float kScale = 0.125f;  // 64^-0.5
constexpr int kConstLayer = 1;    // K9c's layer, as _attn_6d_const fixed it

}  // namespace

void launch_cross_attn(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                       int B, int Q, int H, int Ta, int layer, int ta_total,
                       cudaStream_t stream) {
  dim3 grid((Q + QC - 1) / QC, H, B);
  cross_attn_kernel<bf16, -1, false><<<grid, WARPS * 32, 0, stream>>>(
      q, k, nullptr, v, nullptr, out, nullptr, B, Q, H, Ta, layer, ta_total, 0,
      kScale);
}

void launch_cross_attn_q8(const bf16* q, const int8_t* k8, const float* ks,
                          const int8_t* v8, const float* vs, bf16* out, int B,
                          int Q, int H, int Ta, int layer, int ta_total,
                          cudaStream_t stream) {
  dim3 grid((Q + QC - 1) / QC, H, B);
  cross_attn_kernel<int8_t, -1, false><<<grid, WARPS * 32, 0, stream>>>(
      q, k8, ks, v8, vs, out, nullptr, B, Q, H, Ta, layer, ta_total, 0, kScale);
}

WDT_EXPORT int wdt_cross_attn(const void* q, const void* k, const void* v,
                              void* out, int B, int Q, int H, int Ta,
                              int layer, int ta_total, void* stream) {
  launch_cross_attn(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), static_cast<bf16*>(out), B, Q,
                    H, Ta, layer, ta_total, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// q [B, Q, H, 64] bf16; k8 / v8 [L, B, H, Ta, 64] int8; ks / vs [L, B, H, Ta]
// f32; out [B, Q, H, 64] bf16; all contiguous.
WDT_EXPORT int wdt_cross_attn_q8(const void* q, const void* k8, const void* ks,
                                 const void* v8, const void* vs, void* out,
                                 int B, int Q, int H, int Ta, int layer,
                                 int ta_total, void* stream) {
  launch_cross_attn_q8(
      static_cast<const bf16*>(q), static_cast<const int8_t*>(k8),
      static_cast<const float*>(ks), static_cast<const int8_t*>(v8),
      static_cast<const float*>(vs), static_cast<bf16*>(out), B, Q, H, Ta,
      layer, ta_total, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// K9c: as K1 with the layer fixed at kConstLayer; k / v [L >= 2, B, H, Ta, 64].
WDT_EXPORT int wdt_cross_attn_const_layer(const void* q, const void* k,
                                          const void* v, void* out, int B,
                                          int Q, int H, int Ta, int ta_total,
                                          void* stream) {
  dim3 grid((Q + QC - 1) / QC, H, B);
  cross_attn_kernel<bf16, kConstLayer, false>
      <<<grid, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k), nullptr,
          static_cast<const bf16*>(v), nullptr, static_cast<bf16*>(out),
          nullptr, B, Q, H, Ta, 0, ta_total, 0, kScale);
  return static_cast<int>(cudaGetLastError());
}

// K9d: as K1, the keys split into n_span spans of span_keys (a multiple of
// 64) keys; part is f32 scratch [B, n_span, H, Q, 66].
WDT_EXPORT int wdt_cross_attn_flat(const void* q, const void* k, const void* v,
                                   void* part, void* out, int B, int Q, int H,
                                   int Ta, int layer, int ta_total,
                                   int span_keys, int n_span, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((Q + QC - 1) / QC, H, B * n_span);
  cross_attn_kernel<bf16, -1, true><<<grid, WARPS * 32, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), nullptr,
      static_cast<const bf16*>(v), nullptr, nullptr, static_cast<float*>(part),
      B, Q, H, Ta, layer, ta_total, span_keys, kScale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  combine_spans_kernel<<<(B * Q * H + 3) / 4, 128, 0, st>>>(
      static_cast<const float*>(part), static_cast<bf16*>(out), B, Q, H, n_span);
  return static_cast<int>(cudaGetLastError());
}
