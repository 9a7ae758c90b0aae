// K1: decoder cross-attention of one layer, flash style.
//
// Replaces whisper_diarize_tpu/ops/pallas_attn.py::cross_attn_layer
// (_flash_kernel, _cross_attn_impl). Every query of a stream (beams x prompt
// positions; cross attention has no causal mask) attends that layer's cross
// K/V in one online-softmax pass; columns >= ta_total are masked.
//
// Numerics follow the TPU kernel: q is scaled by Dh^-0.5 in f32 and rounded
// to bf16; scores, running max, normalizer and accumulator are f32; the
// un-normalized probabilities are rounded to bf16 before the P.V product; the
// output is acc / l rounded to bf16.
//
// What bounds it on the H100: bytes. A sampling step reads the layer's whole
// cross K/V (B x H x 1500 x 64 x 2 x 2 bytes, 61 MB at B=8 turbo) for a few
// queries per stream, far below the card's ~295 FLOP/byte balance point.
// Design: the cache is [L, B, H, Ta, Dh] contiguous, so one (b, h) slab is
// one contiguous 192 KB stream and a 64-element bf16 row is one 128-byte
// line; the layer is a pointer offset. One CTA per (b, h, chunk of 16
// queries) streams the slab once through shared memory in 64-key tiles and
// keeps the flash state in registers, so K/V is read once per chunk of
// queries. Splitting the audio axis across CTAs (flash-decoding, for the
// small-B sampling step) is left for later work.
#include "common.cuh"

namespace {

constexpr int DH = 64;        // head dimension (every Whisper checkpoint)
constexpr int TK = 64;        // keys per shared-memory tile
constexpr int QPW = 4;        // queries per warp
constexpr int WARPS = 4;
constexpr int QC = QPW * WARPS;  // queries per CTA
constexpr int KROW = DH + 2;  // padded row (33 words: conflict-free column reads)

__global__ void __launch_bounds__(WARPS * 32)
cross_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ out,
                  int B, int Q, int H, int Ta, int layer, int ta_total,
                  float scale) {
  __shared__ __align__(16) float qs[QC][DH];
  __shared__ __align__(16) bf16 ks[TK][KROW];
  __shared__ __align__(16) bf16 vs[TK][KROW];

  const int q0 = blockIdx.x * QC;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const size_t slab = (size_t)Ta * DH;
  const size_t kv_off = ((size_t)layer * B * H + (size_t)b * H + h) * slab;
  const bf16* kb = k + kv_off;
  const bf16* vb = v + kv_off;

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

  const bf162 zero2 = __floats2bfloat162_rn(0.0f, 0.0f);
  for (int t0 = 0; t0 < Ta; t0 += TK) {
    __syncthreads();  // previous tile fully consumed (and qs written)
    for (int i = tid; i < TK * (DH / 2); i += WARPS * 32) {
      const int row = i / (DH / 2), cp = i % (DH / 2);
      const int key = t0 + row;
      bf162 kk = zero2, vv = zero2;
      if (key < Ta) {
        kk = reinterpret_cast<const bf162*>(kb + (size_t)key * DH)[cp];
        vv = reinterpret_cast<const bf162*>(vb + (size_t)key * DH)[cp];
      }
      reinterpret_cast<bf162*>(&ks[row][0])[cp] = kk;
      reinterpret_cast<bf162*>(&vs[row][0])[cp] = vv;
    }
    __syncthreads();

    const int key0 = t0 + lane, key1 = t0 + lane + 32;
    const bool ok0 = key0 < Ta && key0 < ta_total;
    const bool ok1 = key1 < Ta && key1 < ta_total;
#pragma unroll
    for (int j = 0; j < QPW; ++j) {
      const int qi = warp * QPW + j;
      if (q0 + qi >= Q) break;  // uniform across the warp
      float s0 = 0.0f, s1 = 0.0f;
      const bf162* k0row = reinterpret_cast<const bf162*>(&ks[lane][0]);
      const bf162* k1row = reinterpret_cast<const bf162*>(&ks[lane + 32][0]);
#pragma unroll 8
      for (int dp = 0; dp < DH / 2; ++dp) {
        const float2 qq = *reinterpret_cast<const float2*>(&qs[qi][2 * dp]);
        const float2 a = __bfloat1622float2(k0row[dp]);
        const float2 c = __bfloat1622float2(k1row[dp]);
        s0 = fmaf(qq.x, a.x, fmaf(qq.y, a.y, s0));
        s1 = fmaf(qq.x, c.x, fmaf(qq.y, c.y, s1));
      }
      s0 = ok0 ? s0 : WDT_NEG_INF;
      s1 = ok1 ? s1 : WDT_NEG_INF;
      const float m_new = fmaxf(m[j], warp_max(fmaxf(s0, s1)));
      const float alpha = expf(m[j] - m_new);
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      l[j] = l[j] * alpha + warp_sum(p0 + p1);
      const float pb0 = bf16_round(p0), pb1 = bf16_round(p1);
      float a0 = acc0[j] * alpha, a1 = acc1[j] * alpha;
      // lane owns output dims (2 * lane, 2 * lane + 1)
#pragma unroll 8
      for (int kk = 0; kk < 32; ++kk) {
        const float p = __shfl_sync(0xffffffffu, pb0, kk);
        const float2 vv = __bfloat1622float2(
            reinterpret_cast<const bf162*>(&vs[kk][0])[lane]);
        a0 = fmaf(p, vv.x, a0);
        a1 = fmaf(p, vv.y, a1);
      }
#pragma unroll 8
      for (int kk = 0; kk < 32; ++kk) {
        const float p = __shfl_sync(0xffffffffu, pb1, kk);
        const float2 vv = __bfloat1622float2(
            reinterpret_cast<const bf162*>(&vs[kk + 32][0])[lane]);
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
    const float inv = 1.0f / l[j];
    bf162* o = reinterpret_cast<bf162*>(out + (((size_t)b * Q + qi) * H + h) * DH);
    o[lane] = __floats2bfloat162_rn(acc0[j] * inv, acc1[j] * inv);
  }
}

}  // namespace

void launch_cross_attn(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                       int B, int Q, int H, int Ta, int layer, int ta_total,
                       cudaStream_t stream) {
  dim3 grid((Q + QC - 1) / QC, H, B);
  cross_attn_kernel<<<grid, WARPS * 32, 0, stream>>>(
      q, k, v, out, B, Q, H, Ta, layer, ta_total, 0.125f /* 64^-0.5 */);
}

WDT_EXPORT int wdt_cross_attn(const void* q, const void* k, const void* v,
                              void* out, int B, int Q, int H, int Ta,
                              int layer, int ta_total, void* stream) {
  launch_cross_attn(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), static_cast<bf16*>(out), B, Q,
                    H, Ta, layer, ta_total, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
