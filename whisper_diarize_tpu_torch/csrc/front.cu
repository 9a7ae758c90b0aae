// K8: the front of one decoder layer for a greedy (single-token) step.
//
// Replaces tools/pallas_front.py::fused_front_layer (_front_kernel,
// pallas_call at :193):
//   h      = ln1(x)                                   (f32 statistics)
//   q|k|v  = bf16(h @ [q_w | k_w | v_w] + [q_b | 0 | v_b])   (k has no bias)
//   out    = softmax(q' . k'^T) . v over the self cache, where q' and k' are
//            q and k scaled by Dh^-0.25 and rounded to bf16, the scores and
//            softmax f32, the weights bf16(p / l) before the f32 P.V
// with slot t of row n attended when row_pad[n] <= t <= pos (and the self
// slot t == pos always).
//
// The cache update: the TPU kernel reads the cache before the update,
// appends this step's K/V as an extra "self column" and returns the new row
// for the caller's update. The port's decode step writes the cache in
// place, so this kernel writes k_new / v_new into slot `pos` of kc / vc
// itself and then attends slots <= pos of the updated cache: the same
// function, without the caller's separate write.
//
// What bounds it on the H100: bytes. At large-v3 one layer streams the
// [D, 3D] q/k/v weights (9.8 MB of bf16) for N = 8 .. 40 rows, plus the
// rows' valid cache slots: ~3.4 us at N 8 and ~5 us at N 40 (3.35 TB/s).
// Design: two launches from one C call, in the way K3 makes six: K3's
// weight-streaming skinny GEMM (tail.cu: its input dimension split across a
// thread-block cluster, a cp.async weight ring) over the packed [D, 3D] matrix
// with ln1 fused in its prologue (statistics exchanged across the split)
// and the biases in its epilogue, on the split `ops/tail.py::skinny_plan`
// gives it; then one CTA per (row, head) for the attention, as K4 without
// the ancestry map: 8 threads read a 128-byte cache row as 16-byte chunks,
// 16 rows a pass; the scores stay in shared memory (Tc <= 448); one warp
// takes the softmax; P.V runs with per-thread f32 partials reduced in a
// fixed order.
#include "common.cuh"

namespace {

constexpr int DH = 64;                   // head dimension (every Whisper checkpoint)
constexpr int THREADS = 128;
constexpr int CHUNKS = DH / 8;           // 16-byte chunks of a bf16 row
constexpr int SLOTS = THREADS / CHUNKS;  // cache rows read per pass
constexpr int MAX_TC = 448;              // n_text_ctx of every checkpoint

// q' . k' over one 16-byte chunk: k scaled and rounded to bf16 first
__device__ __forceinline__ float dot8_scaled(const uint4 raw, const float* q,
                                             float scale) {
  const bf162* x = reinterpret_cast<const bf162*>(&raw);
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(x[j]);
    s = fmaf(q[2 * j], bf16_round(f.x * scale), fmaf(q[2 * j + 1], bf16_round(f.y * scale), s));
  }
  return s;
}

__global__ void __launch_bounds__(THREADS)
front_attn_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ kc,
                  bf16* __restrict__ vc, const int* __restrict__ row_pad,
                  bf16* __restrict__ out, int N, int H, int Tc, int layer,
                  int pos, float scale) {
  __shared__ __align__(16) float qs[DH];
  __shared__ float sc[MAX_TC];
  __shared__ __align__(16) float red[SLOTS][DH];

  const int h = blockIdx.x;
  const int n = blockIdx.y;
  const int tid = threadIdx.x;
  const int D = H * DH;
  const bf16* qr = qkv + (size_t)n * 3 * D + h * DH;
  const size_t base = (((size_t)layer * N + n) * H + h) * (size_t)Tc * DH;
  bf16* kr = kc + base;
  bf16* vr = vc + base;

  // this step's K/V into slot pos; the scaled query
  if (tid < DH) {
    kr[(size_t)pos * DH + tid] = qr[D + tid];
    vr[(size_t)pos * DH + tid] = qr[2 * D + tid];
    qs[tid] = bf16_round(__bfloat162float(qr[tid]) * scale);
  }
  __syncthreads();  // the slot-pos writes are visible to the whole block

  const int rp = row_pad[n];
  const int n_slots = pos + 1;
  const int slot = tid / CHUNKS, c = tid % CHUNKS;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  for (int t0 = 0; t0 < n_slots; t0 += SLOTS) {
    const int t = t0 + slot;
    const bool valid = t < n_slots && (t >= rp || t == pos);
    uint4 raw = zero4;
    if (valid) raw = reinterpret_cast<const uint4*>(kr + (size_t)t * DH)[c];
    float s = dot8_scaled(raw, qs + c * 8, scale);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    if (c == 0 && t < n_slots) sc[t] = valid ? s : WDT_NEG_INF;
  }
  __syncthreads();

  // softmax (one warp): f32 max and sum, weights bf16(p / l)
  if (tid < 32) {
    float m = WDT_NEG_INF;
    for (int t = tid; t < n_slots; t += 32) m = fmaxf(m, sc[t]);
    m = warp_max(m);
    float l = 0.0f;
    for (int t = tid; t < n_slots; t += 32) {
      const float p = expf(sc[t] - m);
      sc[t] = p;
      l += p;
    }
    l = warp_sum(l);
    for (int t = tid; t < n_slots; t += 32) sc[t] = bf16_round(sc[t] / l);
  }
  __syncthreads();

  // P.V: per-thread f32 partials over its slots, reduced over the SLOTS rows
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
  for (int t0 = 0; t0 < n_slots; t0 += SLOTS) {
    const int t = t0 + slot;
    if (t < n_slots && (t >= rp || t == pos)) {
      const float p = sc[t];
      const uint4 raw = reinterpret_cast<const uint4*>(vr + (size_t)t * DH)[c];
      const bf162* x = reinterpret_cast<const bf162*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(x[j]);
        acc[2 * j] = fmaf(p, f.x, acc[2 * j]);
        acc[2 * j + 1] = fmaf(p, f.y, acc[2 * j + 1]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) red[slot][c * 8 + j] = acc[j];
  __syncthreads();
  if (tid < DH) {
    float s = 0.0f;
    for (int r = 0; r < SLOTS; ++r) s += red[r][tid];
    out[((size_t)n * H + h) * DH + tid] = __float2bfloat16(s);
  }
}

}  // namespace

// x [N, D]; the packed front weights at layer 0, offset by `layer` here:
// w [L, D, 3D], b [L, 3D] (q_b | 0 | v_b), ln_g / ln_b [L, D]; qkv [N, 3D]
// (scratch, and the returned k_new / v_new); kc / vc [L, N, H, Tc, 64]
// updated at slot pos; row_pad [N] int32; out [N, H, 64]. All bf16 but
// row_pad, contiguous. Needs D % 64 == 0 and Tc <= 448 (the wrapper checks).
// (bn, n_split, span_k, stages): the product's split (ops/tail.py::skinny_plan).
WDT_EXPORT int wdt_fused_front(const void* x, const void* w, const void* b,
                               const void* ln_g, const void* ln_b, void* qkv,
                               void* kc, void* vc, const void* row_pad, void* out,
                               int layer, int N, int D, int H, int Tc, int pos, int bn,
                               int n_split, int span_k, int stages, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const size_t l = static_cast<size_t>(layer), d = static_cast<size_t>(D);
  cudaError_t err = launch_skinny_gemm(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w) + l * d * 3 * d,
      static_cast<const bf16*>(b) + l * 3 * d, static_cast<const bf16*>(ln_g) + l * d,
      static_cast<const bf16*>(ln_b) + l * d, static_cast<bf16*>(qkv), N, D, 3 * D,
      SkinnyPlan{bn, n_split, span_k, stages}, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, N);
  front_attn_kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(kc), static_cast<bf16*>(vc),
      static_cast<const int*>(row_pad), static_cast<bf16*>(out), N, H, Tc, layer, pos,
      0.35355339059327373f /* 64^-0.25 */);
  return static_cast<int>(cudaGetLastError());
}
