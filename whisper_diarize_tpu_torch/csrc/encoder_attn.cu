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
// The plain version writes [B, H, T, T] scores and probabilities to device
// memory; this kernel keeps them in registers.
//
// Design: one CTA of four warps per (64 queries, head, batch row); each warp
// owns 16 query rows, holds its bf16 Q fragments in registers and runs the
// products on the tensor cores (mma.sync m16n8k16, bf16 in, f32 out) over
// 64-key tiles staged in shared memory (K scaled and rounded while staged,
// V read by ldmatrix.trans). The TPU kernel keeps a whole [512, 1536] f32
// score block in VMEM; 227 KB of shared memory cannot, so each span of keys
// (the whole row for the single pass, 512 keys for the two-pass form) is
// swept twice: first Q.K^T for the span's row max, then Q.K^T again for
// p, l and P.V. Both sweeps give the TPU kernel's rounding points exactly,
// at 1.5x its tensor-core work. q, k, v and out are read through strides
// (last axis contiguous), so the encoder's [B, T, H, 64] projections need no
// transpose.
#include "common.cuh"

namespace {

constexpr int DH = 64;        // head dimension (every Whisper checkpoint)
constexpr int BQ = 64;        // queries per CTA (16 per warp)
constexpr int BK = 64;        // keys per shared-memory tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWP = DH + 8;  // padded bf16 row (144 B): conflict-free fragment reads
constexpr int TWO_PASS_SPAN = 512;  // the TPU kernel's key block

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four transposed 8x8 bf16 matrices from shared memory (row addresses from
// lanes 8i .. 8i+7 for matrix i)
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  bf162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

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

// rows [r0, r0 + 64) of a (b, h) slab into shared memory, 16 bytes a
// thread and step; rows >= T read as 0; scaled when `scale` != 1
__device__ __forceinline__ void stage_rows(const bf16* base, long long st, int r0,
                                           int T, float scale, bf16 (*dst)[ROWP],
                                           int tid) {
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < BK * (DH / 8); i += THREADS) {
    const int r = i / (DH / 8), c = i % (DH / 8);
    uint4 raw = zero4;
    if (r0 + r < T) {
      raw = *reinterpret_cast<const uint4*>(base + (long long)(r0 + r) * st + c * 8);
      if (scale != 1.0f) raw = scale8(raw, scale);
    }
    *reinterpret_cast<uint4*>(&dst[r][c * 8]) = raw;
  }
}

// S = Q K^T for this warp's 16 rows and the 64 keys of the staged tile:
// s[nt][0..1] row g, keys t0 + 8 nt + 2 tg + {0, 1}; s[nt][2..3] row g + 8
__device__ __forceinline__ void tile_scores(uint32_t (*qa)[4], bf16 (*ks)[ROWP],
                                            float (*s)[4],
                                            int t0, int ta, int g, int tg) {
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < DH / 16; ++kc) {
      const bf16* row = &ks[nt * 8 + g][kc * 16 + tg * 2];
      mma_bf16(s[nt], qa[kc], lds32(row), lds32(row + 8));
    }
    const int key = t0 + nt * 8 + tg * 2;
    if (key >= ta) s[nt][0] = s[nt][2] = WDT_NEG_INF;
    if (key + 1 >= ta) s[nt][1] = s[nt][3] = WDT_NEG_INF;
  }
}

// max over the four lanes of a quad (the lanes that share a row)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <bool ONE_PASS>
__global__ void __launch_bounds__(THREADS)
enc_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out, int T,
                int ta, long long sb, long long sh, long long st, long long ob,
                long long oh, long long ot, float scale) {
  __shared__ __align__(16) bf16 Ks[BK][ROWP];
  __shared__ __align__(16) bf16 Vs[BK][ROWP];
  __shared__ __align__(16) bf16 Qs[BQ][ROWP];

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const long long slab = (long long)b * sb + (long long)h * sh;
  const bf16* qb = q + slab;
  const bf16* kb = k + slab;
  const bf16* vb = v + slab;

  stage_rows(qb, st, q0, T, scale, Qs, tid);
  __syncthreads();
  uint32_t qa[DH / 16][4];
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int kc = 0; kc < DH / 16; ++kc) {
    qa[kc][0] = lds32(&Qs[r0][kc * 16 + tg * 2]);
    qa[kc][1] = lds32(&Qs[r0 + 8][kc * 16 + tg * 2]);
    qa[kc][2] = lds32(&Qs[r0][kc * 16 + 8 + tg * 2]);
    qa[kc][3] = lds32(&Qs[r0 + 8][kc * 16 + 8 + tg * 2]);
  }

  const int span = ONE_PASS ? ta : TWO_PASS_SPAN;
  float m_lo = -1e30f, m_hi = -1e30f;  // running max of rows g, g + 8
  float l_lo = 0.0f, l_hi = 0.0f;      // this thread's part of the normalizers
  float o[DH / 8][4];
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.0f;
  float s[BK / 8][4];

  for (int s0 = 0; s0 < ta; s0 += span) {
    const int s1 = min(s0 + span, ta);
    // sweep 1: the span's row max
    float bm_lo = WDT_NEG_INF, bm_hi = WDT_NEG_INF;
    for (int t0 = s0; t0 < s1; t0 += BK) {
      __syncthreads();
      stage_rows(kb, st, t0, T, scale, Ks, tid);
      __syncthreads();
      tile_scores(qa, Ks, s, t0, s1, g, tg);
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        bm_lo = fmaxf(bm_lo, fmaxf(s[nt][0], s[nt][1]));
        bm_hi = fmaxf(bm_hi, fmaxf(s[nt][2], s[nt][3]));
      }
    }
    const float mn_lo = fmaxf(m_lo, quad_max(bm_lo));
    const float mn_hi = fmaxf(m_hi, quad_max(bm_hi));
    const float a_lo = expf(m_lo - mn_lo), a_hi = expf(m_hi - mn_hi);
    l_lo *= a_lo;
    l_hi *= a_hi;
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt) {
      o[nt][0] *= a_lo;
      o[nt][1] *= a_lo;
      o[nt][2] *= a_hi;
      o[nt][3] *= a_hi;
    }
    m_lo = mn_lo;
    m_hi = mn_hi;
    // sweep 2: p, l and P.V
    for (int t0 = s0; t0 < s1; t0 += BK) {
      __syncthreads();
      stage_rows(kb, st, t0, T, scale, Ks, tid);
      stage_rows(vb, st, t0, T, 1.0f, Vs, tid);
      __syncthreads();
      tile_scores(qa, Ks, s, t0, s1, g, tg);
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const float p0 = expf(s[nt][0] - m_lo), p1 = expf(s[nt][1] - m_lo);
        const float p2 = expf(s[nt][2] - m_hi), p3 = expf(s[nt][3] - m_hi);
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
        // accumulator layout -> A fragment of keys 16 (nt / 2) .. + 15
        pa[nt / 2][(nt & 1) * 2 + 0] = lo;
        pa[nt / 2][(nt & 1) * 2 + 1] = hi;
      }
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
#pragma unroll
        for (int np = 0; np < DH / 16; ++np) {
          uint32_t vb4[4];
          const int key = kc * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
          ldsm_x4_trans(vb4, &Vs[key][np * 16 + (lane >> 4) * 8]);
          mma_bf16(o[2 * np], pa[kc], vb4[0], vb4[1]);
          mma_bf16(o[2 * np + 1], pa[kc], vb4[2], vb4[3]);
        }
      }
    }
  }

  const float inv_lo = 1.0f / quad_sum(l_lo), inv_hi = 1.0f / quad_sum(l_hi);
  const int row_lo = q0 + r0, row_hi = row_lo + 8;
  bf16* ob_ = out + (long long)b * ob + (long long)h * oh;
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) {
    const int d = nt * 8 + tg * 2;
    if (row_lo < T)
      *reinterpret_cast<bf162*>(ob_ + (long long)row_lo * ot + d) =
          __floats2bfloat162_rn(o[nt][0] * inv_lo, o[nt][1] * inv_lo);
    if (row_hi < T)
      *reinterpret_cast<bf162*>(ob_ + (long long)row_hi * ot + d) =
          __floats2bfloat162_rn(o[nt][2] * inv_hi, o[nt][3] * inv_hi);
  }
}

}  // namespace

// q, k, v [B, H, T, 64] bf16 read through the element strides (sb, sh, st)
// shared by the three (last axis contiguous, rows 16-byte aligned); out
// [B, H, T, 64] written through (ob, oh, ot). Keys >= ta_total masked
// (0 < ta_total <= T). single_pass selects the form.
WDT_EXPORT int wdt_encoder_attn(const void* q, const void* k, const void* v,
                                void* out, int B, int H, int T, int ta_total,
                                long long sb, long long sh, long long st,
                                long long ob, long long oh, long long ot,
                                int single_pass, void* stream) {
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  const float scale = 0.35355339059327373f;  // 64^-0.25
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto Q = static_cast<const bf16*>(q);
  auto K = static_cast<const bf16*>(k);
  auto V = static_cast<const bf16*>(v);
  auto O = static_cast<bf16*>(out);
  if (single_pass) {
    enc_attn_kernel<true><<<grid, THREADS, 0, s>>>(Q, K, V, O, T, ta_total, sb, sh,
                                                   st, ob, oh, ot, scale);
  } else {
    enc_attn_kernel<false><<<grid, THREADS, 0, s>>>(Q, K, V, O, T, ta_total, sb, sh,
                                                    st, ob, oh, ot, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
