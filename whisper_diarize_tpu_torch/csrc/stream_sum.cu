// K11a, K11b and K9b: f32 sums over a bf16 stream, the probes that measure
// what a plain stream of the cross K/V bytes reaches on this card and what
// K1's way of walking them costs.
//
// K11a stream_sum replaces tools/bench_dma.py::auto_sum (_tile_sum_kernel):
// sum over x of max(f32 x, s), x any contiguous bf16 array. A grid-stride
// loop over the whole card (SUM_CTAS_PER_SM CTAs an SM), 16-byte loads (8
// bf16), UNROLL of them issued before any is summed, so each thread keeps
// UNROLL loads in flight.
//
// K11b stream_sum_pipelined replaces bench_dma.py::manual_sum
// (_manual_kernel: an nbuf-deep ring of pltpu.make_async_copy DMAs and
// their semaphores). Its Hopper counterpart: one CTA an SM streams its
// contiguous share of x through an nbuf-deep ring of shared-memory stages of
// stage_bytes each, filled by 1-D TMA bulk copies
// (cp.async.bulk ... mbarrier::complete_tx::bytes) issued by one thread,
// one mbarrier a slot. Stage j of a CTA lands in slot j % nbuf; the CTA
// waits for that slot's barrier phase (j / nbuf) & 1 to complete, sums the
// stage, and once every thread is past it (a block barrier) refills the slot
// with stage j + nbuf: nbuf - 1 stages are in flight while one is summed.
//
// K9b kv_stream_sum replaces tools/bench_attn_kernel.py::_sum_6d: sum of
// max(f32 k[layer], s) + f32 v[layer] over one layer of the cache
// [L, B, H, Ta, 64]. It keeps K1's work split and loads on purpose: K1's
// key spans (one CTA of K1_THREADS per (b, h, span), cross_attn_plan over
// Ta), each walked in key order through K1's ring of K1_STAGES tiles filled
// by K1's own k1_stage_tile_async (cp.async, 16 bytes a copy). Its distance
// from K11 is the cost of K1's access pattern; K1's distance from it is the
// cost of K1's compute and combine.
//
// Every sum is deterministic: each CTA writes its f32 partial and one CTA
// adds the partials in a fixed order (no float atomics). A thread sums each
// load group (or stage, or tile) on its own before adding it to its running
// sum, so few f32 additions follow one another.
//
// What bounds them on the H100: bytes (two f32 operations a 2-byte element).
#include "common.cuh"

namespace {

constexpr int SUM_THREADS = 256;
constexpr int UNROLL = 4;    // 16-byte loads in flight per thread (K11a)
constexpr int MAX_NBUF = 8;  // ring slots (K11b)

__device__ __forceinline__ float sum8(const uint4& raw, float s) {
  const bf162* p = reinterpret_cast<const bf162*>(&raw);
  float a = 0.0f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(p[e]);
    a += fmaxf(f.x, s) + fmaxf(f.y, s);
  }
  return a;
}

// the n % 8 elements after the last whole 16-byte vector
__device__ __forceinline__ float tail_sum(const bf16* x, long long n, float s) {
  const long long t = (n / 8) * 8 + threadIdx.x;
  return t < n ? fmaxf(__bfloat162float(x[t]), s) : 0.0f;
}

__global__ void __launch_bounds__(SUM_THREADS)
stream_sum_kernel(const bf16* __restrict__ x, long long n, float s,
                  float* __restrict__ partial) {
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const long long nvec = n / 8;
  const long long stride = (long long)gridDim.x * SUM_THREADS;
  const long long g = (long long)blockIdx.x * SUM_THREADS + threadIdx.x;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  float acc = 0.0f;
  for (long long base = g; base < nvec; base += stride * UNROLL) {
    uint4 r[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + u * stride;
      r[u] = i < nvec ? __ldg(xv + i) : zero4;
    }
    float part = 0.0f;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (base + u * stride < nvec) part += sum8(r[u], s);
    acc += part;
  }
  if (blockIdx.x == gridDim.x - 1) acc += tail_sum(x, n, s);
  const float tot = block_sum(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = tot;
}

// thread 0: stage j of this CTA (bytes [off, off + bytes) of x) into its slot
__device__ __forceinline__ void issue_stage(unsigned char* ring, uint64_t* full,
                                            const unsigned char* src, int j,
                                            int nbuf, int stage_bytes,
                                            long long off, uint32_t bytes) {
  const int slot = j % nbuf;
  const uint32_t bar = smem_u32(&full[slot]);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(ring + (size_t)slot * stage_bytes)), "l"(src + off),
         "r"(bytes), "r"(bar)
      : "memory");
}

__global__ void __launch_bounds__(SUM_THREADS)
stream_sum_pipelined_kernel(const bf16* __restrict__ x, long long n, float s,
                            int nbuf, int stage_bytes,
                            float* __restrict__ partial) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[MAX_NBUF];
  const unsigned char* src = reinterpret_cast<const unsigned char*>(x);
  const long long nbytes = (n / 8) * 16;  // the bulk-copied part
  const long long n_stage = (nbytes + stage_bytes - 1) / stage_bytes;
  const long long first = n_stage * blockIdx.x / gridDim.x;
  const int count = (int)(n_stage * (blockIdx.x + 1) / gridDim.x - first);
  auto stage_off = [&](int j) { return (first + j) * stage_bytes; };
  auto stage_len = [&](int j) {
    return (uint32_t)min((long long)stage_bytes, nbytes - stage_off(j));
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < nbuf; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_u32(&full[i])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int j = 0; j < min(nbuf, count); ++j)
      issue_stage(ring, full, src, j, nbuf, stage_bytes, stage_off(j), stage_len(j));
  }
  __syncthreads();

  float acc = 0.0f;
  for (int j = 0; j < count; ++j) {
    const int slot = j % nbuf;
    while (!mbar_try_wait(smem_u32(&full[slot]), (uint32_t)(j / nbuf) & 1u)) {
    }
    const uint4* sv = reinterpret_cast<const uint4*>(ring + (size_t)slot * stage_bytes);
    const int nv = (int)(stage_len(j) / 16);
    float part = 0.0f;
    for (int i = threadIdx.x; i < nv; i += SUM_THREADS) part += sum8(sv[i], s);
    acc += part;
    __syncthreads();  // every thread is done with the slot
    if (threadIdx.x == 0 && j + nbuf < count) {
      // order the generic-proxy reads of the slot before the async refill
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue_stage(ring, full, src, j + nbuf, nbuf, stage_bytes, stage_off(j + nbuf),
                  stage_len(j + nbuf));
    }
  }
  if (blockIdx.x == gridDim.x - 1) acc += tail_sum(x, n, s);
  const float tot = block_sum(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = tot;
}

// K9b: the CTA of span blockIdx.x of slab (b = blockIdx.z, h = blockIdx.y)
// walks its keys [rank * span_keys, + span_keys) of [0, Ta) through K1's
// ring with K1's staging helper, and sums them.
__global__ void __launch_bounds__(K1_THREADS)
kv_stream_sum_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                     int B, int H, int Ta, int layer, int span_keys, float s,
                     float* __restrict__ partial) {
  extern __shared__ __align__(128) unsigned char ring[];
  const int rank = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const size_t row0 = ((size_t)layer * B * H + (size_t)b * H + h) * Ta;
  const bf16* kb = k + row0 * K1_DH;
  const bf16* vb = v + row0 * K1_DH;
  const int t_begin = rank * span_keys;
  const int t_end = min(t_begin + span_keys, Ta);
  const int n_tiles = (t_end - t_begin + K1_TK - 1) / K1_TK;
  auto tile = [&](int j) {
    return reinterpret_cast<bf16*>(ring) + (j % K1_STAGES) * 2 * K1_TILE_ELEMS;
  };
  for (int j = 0; j < K1_STAGES - 1; ++j) {
    if (j < n_tiles)
      k1_stage_tile_async(kb, vb, tile(j), tile(j) + K1_TILE_ELEMS, t_begin + j * K1_TK,
                          t_end, tid);
    cp_async_commit();
  }
  float acc = 0.0f;
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<K1_STAGES - 2>();
    __syncthreads();  // tile j landed for every thread; tile j - 1 summed
    const int nj = j + K1_STAGES - 1;
    if (nj < n_tiles)
      k1_stage_tile_async(kb, vb, tile(nj), tile(nj) + K1_TILE_ELEMS,
                          t_begin + nj * K1_TK, t_end, tid);
    cp_async_commit();
    const bf16* kt = tile(j);
    const bf16* vt = kt + K1_TILE_ELEMS;
    const int pairs = min(K1_TK, t_end - (t_begin + j * K1_TK)) * (K1_DH / 2);
    float part = 0.0f;
    for (int i = tid; i < pairs; i += K1_THREADS) {
      const int row = i / (K1_DH / 2), cp = i % (K1_DH / 2);
      const float2 kk = __bfloat1622float2(
          reinterpret_cast<const bf162*>(kt + row * K1_KROW)[cp]);
      const float2 vv = __bfloat1622float2(
          reinterpret_cast<const bf162*>(vt + row * K1_KROW)[cp]);
      part += (fmaxf(kk.x, s) + fmaxf(kk.y, s)) + (vv.x + vv.y);
    }
    acc += part;
  }
  cp_async_wait<0>();
  const float tot = block_sum(acc);
  if (tid == 0) partial[((size_t)b * H + h) * gridDim.x + rank] = tot;
}

__global__ void __launch_bounds__(SUM_THREADS)
sum_partials_kernel(const float* __restrict__ partial, int n,
                    float* __restrict__ out) {
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n; i += SUM_THREADS) acc += partial[i];
  const float tot = block_sum(acc);
  if (threadIdx.x == 0) *out = tot;
}

int finish(const float* partial, int n, float* out, cudaStream_t st) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials_kernel<<<1, SUM_THREADS, 0, st>>>(partial, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K11a: x bf16 [n] contiguous, 16-byte aligned; partial f32 [ctas]; out f32 [1].
WDT_EXPORT int wdt_stream_sum(const void* x, long long n, float s, void* partial,
                              int ctas, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  stream_sum_kernel<<<ctas, SUM_THREADS, 0, st>>>(static_cast<const bf16*>(x), n, s,
                                                  static_cast<float*>(partial));
  return finish(static_cast<const float*>(partial), ctas, static_cast<float*>(out), st);
}

// K11b: as K11a with 2 <= nbuf <= 8 slots of stage_bytes (a multiple of 16;
// nbuf * stage_bytes within the block's shared memory); ctas = one an SM.
WDT_EXPORT int wdt_stream_sum_pipelined(const void* x, long long n, float s,
                                        int nbuf, int stage_bytes, void* partial,
                                        int ctas, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = nbuf * stage_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      stream_sum_pipelined_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  stream_sum_pipelined_kernel<<<ctas, SUM_THREADS, smem, st>>>(
      static_cast<const bf16*>(x), n, s, nbuf, stage_bytes, static_cast<float*>(partial));
  return finish(static_cast<const float*>(partial), ctas, static_cast<float*>(out), st);
}

// K9b: k / v [L, B, H, Ta, 64] bf16 contiguous; the keys split into n_span
// spans of span_keys as K1 splits them (ops/attn.py::cross_attn_plan over
// Ta); partial f32 [B * H * n_span]; out f32 [1].
WDT_EXPORT int wdt_kv_stream_sum(const void* k, const void* v, int B, int H, int Ta,
                                 int layer, float s, int n_span, int span_keys,
                                 void* partial, void* out, void* stream) {
  if (n_span < 1 || span_keys <= 0 || span_keys % K1_TK != 0 ||
      (long long)n_span * span_keys < Ta || (long long)(n_span - 1) * span_keys >= Ta)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = K1_STAGES * 2 * K1_TILE_ELEMS * 2;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kv_stream_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kv_stream_sum_kernel<<<dim3(n_span, H, B), K1_THREADS, smem, st>>>(
      static_cast<const bf16*>(k), static_cast<const bf16*>(v), B, H, Ta, layer, span_keys,
      s, static_cast<float*>(partial));
  return finish(static_cast<const float*>(partial), B * H * n_span,
                static_cast<float*>(out), st);
}
