// K4: split-cache self-attention of one decoder layer for a beam step.
//
// Replaces whisper_diarize_tpu/ops/pallas_attn.py::split_self_attn_layer
// (_split_self_kernel, _split_self_impl). Each of a stream's K beams has one
// query; it attends the stream's prompt K/V [L, B, H, Tp, Dh] (shared by the
// beams, slots < row_pad[b] or >= prompt_len masked) and its own decode K/V
// under one softmax. The decode cache [L, B*K, H, Td, Dh] is never permuted:
// beam k reads slot t (t <= step) from row b*K + anc[b, k, t].
//
// Numerics follow the TPU kernel: q is scaled by Dh^-0.5 in f32 and rounded
// to bf16; scores, max and normalizer are f32; the probabilities are rounded
// to bf16 before P.V; the f32 accumulator is divided by the normalizer and
// rounded to bf16 at the end.
//
// The TPU kernel cannot gather: it scores every query against all K physical
// rows of the stream and picks the ancestor's score with a one-hot, K times
// the dot products over the whole Td block at every step. A Hopper thread
// block follows the pointer instead.
//
// What bounds it on the H100: bytes and latency. At B 8, K 5, H 20 one
// layer's decode K/V is at most 2 x 40 x 20 x Td x 64 x 2 bytes (13.1 MB at
// Td 64, ~4 us at 3.35 TB/s), and the kernel reads only the K x (step + 1)
// valid rows, each a 128-byte line. Design: one CTA per (stream b, head h)
// owns all K beams (160 CTAs at B 8, H 20). It builds a table of row offsets
// (prompt rows once for all beams, decode rows through the ancestry map),
// then 8 threads per row read it as 16-byte chunks, 32 rows in flight per
// pass with the loads of four passes issued together, so a warp moves four
// whole rows per load. The K x (Tp + step + 1) f32 scores stay in shared
// memory (a few KB); each beam's max and sum are one warp's; P.V runs beam
// by beam with f32 accumulators reduced in a fixed order (deterministic).
// No tensor cores: the products are a few MFLOP a layer.
#include "common.cuh"

namespace {

constexpr int DH = 64;                  // head dimension (every Whisper checkpoint)
constexpr int THREADS = 256;
constexpr int CHUNKS = DH / 8;          // 16-byte chunks of a bf16 row
constexpr int SLOTS = THREADS / CHUNKS;  // rows read per pass
constexpr int UNROLL = 4;               // passes whose loads are issued together
constexpr int MASKED = -1;              // row offset codes
constexpr int BAD_ANCESTOR = -2;

__host__ __device__ inline int align4(int n) { return (n + 3) & ~3; }

// dynamic shared memory, in 4-byte words
__host__ __device__ inline int smem_words(int K, int t_all) {
  return align4(K * DH) + align4(K * t_all) * 2 + SLOTS * DH + align4(K);
}

__device__ __forceinline__ float dot8(const uint4 raw, const float* q) {
  const bf162* x = reinterpret_cast<const bf162*>(&raw);
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(x[j]);
    s = fmaf(q[2 * j], f.x, fmaf(q[2 * j + 1], f.y, s));
  }
  return s;
}

__global__ void __launch_bounds__(THREADS)
split_self_kernel(const bf16* __restrict__ q, const bf16* __restrict__ pk,
                  const bf16* __restrict__ pv, const bf16* __restrict__ dk,
                  const bf16* __restrict__ dv, const int* __restrict__ anc,
                  const int* __restrict__ row_pad, bf16* __restrict__ out,
                  int B, int K, int H, int Tp, int Td, int layer, int step,
                  int prompt_len, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int t_all = Tp + step + 1;  // joint slots: prompt, then decode
  const int n = K * t_all;
  float* qs = smem;                          // [K][DH] scaled queries
  float* sc = qs + align4(K * DH);           // [K][t_all] scores, then probs
  int* off = reinterpret_cast<int*>(sc + align4(n));  // [K][t_all] row offsets
  float* red = reinterpret_cast<float*>(off + align4(n));  // [SLOTS][DH]
  float* lsum = red + SLOTS * DH;            // [K] normalizers

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int N = B * K;
  const size_t prompt_base = (((size_t)layer * B + b) * H + h) * (size_t)Tp * DH;
  const size_t decode_base = (((size_t)layer * N + (size_t)b * K) * H + h) * (size_t)Td * DH;
  const int rp = row_pad[b];

  for (int i = tid; i < K * DH; i += THREADS) {
    const int k = i / DH, d = i % DH;
    qs[i] = bf16_round(__bfloat162float(q[(((size_t)b * K + k) * H + h) * DH + d]) * scale);
  }
  // offset of each (beam, slot) row from its half's base, or a code
  for (int i = tid; i < n; i += THREADS) {
    const int k = i / t_all, t = i % t_all;
    int o;
    if (t < Tp) {
      o = (t >= rp && t < prompt_len) ? t * DH : MASKED;
    } else {
      const int td = t - Tp;
      const int a = anc[((size_t)b * K + k) * Td + td];
      o = (a >= 0 && a < K) ? (a * H * Td + td) * DH : BAD_ANCESTOR;
    }
    off[i] = o;
  }
  __syncthreads();

  const int slot = tid / CHUNKS, c = tid % CHUNKS;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  // scores: 8 threads per row, each a 16-byte chunk; reduce over the 8
  for (int base = 0; base < n; base += SLOTS * UNROLL) {
    uint4 raw[UNROLL];
    int idx[UNROLL], o[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      idx[u] = base + u * SLOTS + slot;
      o[u] = idx[u] < n ? off[idx[u]] : MASKED;
      raw[u] = zero4;
      if (o[u] >= 0) {
        const bf16* row = ((idx[u] % t_all) < Tp ? pk + prompt_base : dk + decode_base) + o[u];
        raw[u] = reinterpret_cast<const uint4*>(row)[c];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float s = 0.0f;
      if (idx[u] < n) s = dot8(raw[u], qs + (idx[u] / t_all) * DH + c * 8);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      if (c == 0 && idx[u] < n) {
        sc[idx[u]] = o[u] >= 0 ? s : (o[u] == MASKED ? WDT_NEG_INF : __int_as_float(0x7fffffff));
      }
    }
  }
  __syncthreads();

  // softmax per beam (one warp a beam): f32 max and sum, bf16 probabilities
  const int warp = tid >> 5, lane = tid & 31;
  for (int k = warp; k < K; k += THREADS / 32) {
    float* row = sc + k * t_all;
    float m = WDT_NEG_INF;
    for (int t = lane; t < t_all; t += 32) m = fmaxf(m, row[t]);
    m = warp_max(m);
    float l = 0.0f;
    for (int t = lane; t < t_all; t += 32) {
      const float p = expf(row[t] - m);
      l += p;
      row[t] = bf16_round(p);
    }
    l = warp_sum(l);
    if (lane == 0) lsum[k] = l;
  }
  __syncthreads();

  // P.V beam by beam: per-thread f32 partials, reduced over the SLOTS rows
  for (int k = 0; k < K; ++k) {
    const float* p_row = sc + k * t_all;
    const int* o_row = off + k * t_all;
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
    for (int t0 = 0; t0 < t_all; t0 += SLOTS * UNROLL) {
      uint4 raw[UNROLL];
      float p[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int t = t0 + u * SLOTS + slot;
        const int o = t < t_all ? o_row[t] : MASKED;
        p[u] = 0.0f;
        raw[u] = zero4;
        if (o >= 0) {
          p[u] = p_row[t];
          const bf16* row = (t < Tp ? pv + prompt_base : dv + decode_base) + o;
          raw[u] = reinterpret_cast<const uint4*>(row)[c];
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const bf162* x = reinterpret_cast<const bf162*>(&raw[u]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(x[j]);
          acc[2 * j] = fmaf(p[u], f.x, acc[2 * j]);
          acc[2 * j + 1] = fmaf(p[u], f.y, acc[2 * j + 1]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) red[slot * DH + c * 8 + j] = acc[j];
    __syncthreads();
    if (tid < DH) {
      float s = 0.0f;
      for (int r = 0; r < SLOTS; ++r) s += red[r * DH + tid];
      out[(((size_t)b * K + k) * H + h) * DH + tid] = __float2bfloat16(s / lsum[k]);
    }
    __syncthreads();
  }
}

}  // namespace

WDT_EXPORT int wdt_split_self_attn(const void* q, const void* pk, const void* pv,
                                   const void* dk, const void* dv, const void* anc,
                                   const void* row_pad, void* out, int B, int K,
                                   int H, int Tp, int Td, int layer, int step,
                                   int prompt_len, void* stream) {
  const size_t smem = (size_t)smem_words(K, Tp + step + 1) * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        split_self_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(H, B);
  split_self_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(pk),
      static_cast<const bf16*>(pv), static_cast<const bf16*>(dk),
      static_cast<const bf16*>(dv), static_cast<const int*>(anc),
      static_cast<const int*>(row_pad), static_cast<bf16*>(out), B, K, H, Tp, Td,
      layer, step, prompt_len, 0.125f /* 64^-0.5 */);
  return static_cast<int>(cudaGetLastError());
}
