// K4: split-cache self-attention of one decoder layer for a beam step.
//
// Replaces whisper_diarize_tpu/ops/pallas_attn.py::split_self_attn_layer
// (_split_self_kernel, _split_self_impl). Each of a stream's K beams has one
// query; it attends the stream's prompt K/V [L, B, H, Tp, Dh] (shared by the
// beams, slots < row_pad[b] or >= prompt_len masked) and its own decode K/V
// under one softmax. The decode cache [L, B*K, H, Td, Dh] is never permuted:
// beam k reads slot t (t <= step) from row b*K + anc[b, k, t].
//
// Numerics follow the TPU kernel, whose body works in the cache's dtype: q
// is scaled by Dh^-0.5 in f32 and rounded to the cache dtype; scores, max
// and normalizer are f32 over the whole joint row [prompt | decode]; the
// probabilities are rounded to the cache dtype against that max before P.V;
// the f32 accumulator is divided by the normalizer and rounded to it at the
// end. The kernel is a template on that dtype, T = bf16 or float: at f32
// both roundings are the identity and a 16-byte chunk of a row holds 4
// values, not 8.
//
// The TPU kernel cannot gather: it scores every query against all K physical
// rows of the stream and picks the ancestor's score with a one-hot, K times
// the dot products over the whole Td block at every step. A Hopper thread
// block follows the pointer instead.
//
// What bounds it on the H100: bytes and latency. A call reads q and out, the
// prompt rows, the K x (step + 1) valid decode rows of K and V and the
// ancestry: 6.9 MB at B 8, K 5, H 20, step 31 (2.1 us at 3.35 TB/s, 4.1 us
// at f32), 20 - 80 KB a CTA. Each CTA's work is small, so its time is a
// chain of latencies: a memory round trip for its data, then each phase's
// dependent shared-memory loads, shuffles and barriers, a fixed cost even
// when the phase has little to do (PERF.md), and its instructions per
// (beam, slot).
//
// Design: one CTA per (stream b, head h) owns all K beams (160 CTAs at B 8,
// H 20), 256 threads.
// - One load phase. Warp 0 issues one bulk copy (cp.async.bulk, completing
//   on an mbarrier) for every contiguous span the CTA needs, up front: the
//   prompt's rows [0, prompt_len) once for all beams and slots [0, step] of
//   each of the stream's K physical decode rows, for K, then the same spans
//   of V. Meanwhile warps 1-3 stage q (scaled, rounded, kept in f32) and
//   warps 4-7 turn the ancestry into the staged row each (beam, slot) reads
//   (int16 codes; masked and bad-ancestor slots coded), each thread's loads
//   issued together. The CTA waits about one round trip in all. Each
//   physical row is read once, however many beams point at it: the bytes
//   stay the bound's. Every span starts 16-byte aligned and is a multiple
//   of 16 bytes (a row is 128 or 256).
// - The ring. Where 2 (prompt_len + K (step + 1)) rows and the CTA's fixed
//   shared memory exceed 113 KB (two CTAs an SM, so 160 CTAs run in one wave
//   on 132 SMs; at K 5, prompt 3: bf16 past step 84, f32 past step 41),
//   `make_plan` cuts the staged slots into chunks (the prompt's rows first,
//   then decode slots of all K rows) that stream through the two stages as
//   a ring, K's chunks first, then V's: V's first chunk is issued as soon as
//   a stage of K's is read, while the scores are computed (four stages of
//   half the size ran slower on the card, PERF.md). It shrinks the chunk,
//   never K; past 113 KB it takes one CTA an SM (227 KB), past that it
//   refuses the launch. ops/attn.py::split_self_plan mirrors it.
// - Scores from shared memory: a thread a (beam, slot), the whole 64-value
//   dot product of its staged row (beam k's decode slot t reads row
//   anc[b, k, t] of its chunk) with q in f32. Each lane walks its row's
//   16-byte chunks in an order rotated by lane % 8, so the 8 lanes of a
//   quarter warp hit 8 different banks though their rows start in the same
//   one (a bulk copy lands contiguous bytes: the rows cannot be padded). The
//   K x (prompt_len + step + 1) f32 scores stay in shared memory; the
//   softmax is the TPU kernel's (no online softmax: p is rounded against the
//   row's global max).
// - Then each warp owns beams (warp, warp + 8, ...): their softmax and P.V
//   touch no other warp's data, so the warps meet only where a ring stage
//   is refilled.
// - P.V for all beams in one pass over V's chunks: a beam's warp reads 4
//   rows at once (2 at f32), 8 (16) lanes a row, a 16-byte chunk each; the
//   lane groups are summed by shuffles in a fixed order, the chunks in order
//   (deterministic: two calls give the same bits).
// - No tensor cores: the products are a few MFLOP a layer; f32 is exact
//   FFMA.
// - The prompt's length and the step are read from device memory, and the
//   launch is planned for the whole caches (prompt_len Tp, step Td - 1):
//   each CTA re-cuts that plan's chunks for the values it reads. So no
//   launch argument changes from step to step or between prompt lengths,
//   and one captured CUDA graph of the decoder step serves them all
//   (ops/beam_graph.py). Where the rows fit one stage it is the one load
//   phase of the step's own plan.
#include "common.cuh"

namespace {

constexpr int DH = 64;                  // head dimension (every Whisper checkpoint)
constexpr int THREADS = 256;
constexpr int UNROLL = 4;               // P.V: rows a lane group loads together
constexpr int STAGES = 2;               // K's stage and V's, or the ring's two
constexpr int SMEM_TWO = 233472 / 2 - 1024;  // two CTAs an SM: 113 KB each
constexpr int SMEM_ONE = 232448;             // one CTA an SM: 227 KB
constexpr int BARS = 128;               // the stages' mbarriers, padded
constexpr int MASKED = -1;              // staged-row codes
constexpr int BAD_ANCESTOR = -2;

template <typename T>
struct Row {
  static constexpr int BYTES = DH * sizeof(T);     // 128 or 256
  static constexpr int ELEMS = 16 / sizeof(T);     // values a 16-byte chunk
  static constexpr int CHUNKS = DH / ELEMS;        // 16-byte chunks a row: 8 or 16
};

__host__ __device__ inline long long a16(long long n) { return (n + 15) & ~15LL; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// `cap` rows a stage, `chunks` slot chunks (each staged for K, then V),
// `smem` bytes of dynamic shared memory; then the chunks' shape (see
// chunk_at): `full` chunks of prompt rows only, the prompt's `rest` rows
// with `dm` decode slots, then `cd` decode slots a chunk
struct Plan {
  int cap, smem, chunks;
  int full, rest, dm, cd;
};

// One chunk: prompt rows [p0, p0 + np) and decode slots [d0, d0 + nd) of
// all K physical rows, staged as the prompt rows, then K spans of nd rows.
// Chunks of `cap` prompt rows first; then the prompt's rest with as many
// decode slots as fit; then cap / K decode slots a chunk.
struct Chunk {
  int p0, np, d0, nd;
};

__device__ __forceinline__ Chunk chunk_at(int c, const Plan& p, int S) {
  if (c < p.full) return {c * p.cap, p.cap, 0, 0};
  if (c == p.full) return {p.full * p.cap, p.rest, 0, p.dm};
  const int d0 = p.dm + (c - p.full - 1) * p.cd;
  return {0, 0, d0, imin(p.cd, S - d0)};
}

// the plan of `cap` rows a stage, with its chunks' shape (on the device: a
// launch planned for the whole caches, re-cut for the prompt and step read)
__host__ __device__ inline Plan plan_of(int cap, long long smem, int K, int P, int S) {
  const int full = P / cap, rest = P - full * cap, dm = imin(S, (cap - rest) / K), cd = cap / K;
  return {cap, (int)smem, full + 1 + (S - dm + cd - 1) / cd, full, rest, dm, cd};
}

// shared memory beside the stages: barriers, q [K][DH] in f32, scores [K][P+S],
// staged-row codes [K][P+S] (int16), P.V sums [K][DH] carried across
// chunks, normalizers [K]
inline long long fixed_bytes(int K, int P, int S) {
  return BARS + 4LL * K * DH + a16(4LL * K * (P + S)) + a16(2LL * K * (P + S)) + 4LL * K * DH +
         a16(4LL * K);
}

// The plan for K beams, prompt_len P, step + 1 = S decode slots, es-byte
// values: all rows in the two stages (one load phase) where they fit 113
// KB, else the largest stages that do, if a stage holds one decode slot of
// all K rows; then the same at 227 KB. False: no plan (the launch is
// refused).
bool make_plan(int K, int P, int S, int es, Plan* out) {
  if (K < 1 || P < 1 || S < 1) return false;
  const long long rb = DH * es, fixed = fixed_bytes(K, P, S);
  const long long whole = P + (long long)K * S;
  const long long budgets[2] = {SMEM_TWO, SMEM_ONE};
  for (const long long budget : budgets) {
    long long cap = (budget - fixed) / (STAGES * rb);
    if (cap > whole) cap = whole;
    if (cap >= K) {
      *out = plan_of((int)cap, fixed + STAGES * cap * rb, K, P, S);
      return true;
    }
  }
  return false;
}

// the staged row of joint slot u (prompt slot u, or decode slot u - P whose
// ancestor is a) in its chunk, or a code: the mirror of `issue`'s layout
__device__ __forceinline__ int staged_row(int u, int a, const Plan& p, int K, int P, int S,
                                          int rp) {
  if (u < P) return u < rp ? MASKED : u < p.full * p.cap ? u % p.cap : u - p.full * p.cap;
  if (a < 0 || a >= K) return BAD_ANCESTOR;
  const int d = u - P;
  if (d < p.dm) return p.rest + a * p.dm + d;
  const int d0 = p.dm + (d - p.dm) / p.cd * p.cd;
  return a * imin(p.cd, S - d0) + d - d0;
}

// joint slot of a chunk's slot s: its prompt rows, then its decode slots
__device__ __forceinline__ int joint_slot(const Chunk& ch, int s, int P) {
  return s < ch.np ? ch.p0 + s : P + ch.d0 + s - ch.np;
}

// q . row over DH values, one lane a row: the row's 16-byte chunks in an
// order rotated by `rot` (lane % 8), so the 8 lanes of a quarter warp read 8
// different chunks of their rows (different banks, though the rows' bases
// share one); q4 holds q in f32 in the matching chunks (bf16: each chunk's
// first and last 4 values in two planes, `plane` float4s apart)
template <typename T>
__device__ __forceinline__ float dot_row(const uint4* row, const float4* q4, int plane, int rot) {
  constexpr int CH = Row<T>::CHUNKS;
  const T* tag = nullptr;
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int j = (i + rot) & (CH - 1);
    float f[Row<T>::ELEMS];
    chunk_floats(row[j], f, tag);
    const float4 a = q4[j];
    s[0] = fmaf(f[0], a.x, s[0]);
    s[1] = fmaf(f[1], a.y, s[1]);
    s[2] = fmaf(f[2], a.z, s[2]);
    s[3] = fmaf(f[3], a.w, s[3]);
    if constexpr (Row<T>::ELEMS == 8) {
      const float4 b = q4[plane + j];
      s[0] = fmaf(f[4], b.x, s[0]);
      s[1] = fmaf(f[5], b.y, s[1]);
      s[2] = fmaf(f[6], b.z, s[2]);
      s[3] = fmaf(f[7], b.w, s[3]);
    }
  }
  return (s[0] + s[1]) + (s[2] + s[3]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
split_self_kernel(const T* __restrict__ q, const T* __restrict__ pk,
                  const T* __restrict__ pv, const T* __restrict__ dk,
                  const T* __restrict__ dv, const int* __restrict__ anc,
                  const int* __restrict__ row_pad, const int* __restrict__ prompt_len_at,
                  const int* __restrict__ step_at, T* __restrict__ out,
                  int B, int K, int H, int Tp, int Td, int layer, float scale, Plan plan) {
  constexpr int E = Row<T>::ELEMS, CH = Row<T>::CHUNKS, RB = Row<T>::BYTES;
  constexpr int WARPS = THREADS / 32, PARTS = 32 / CH;  // P.V: a warp's rows in flight
  const T* tag = nullptr;  // selects the overloads for T
  extern __shared__ __align__(128) unsigned char smem[];
  // the prompt's length and the step from device memory: the launch's
  // stages and shared memory were planned for the whole caches (Tp, Td),
  // so the chunks are re-cut here from its stage size; a prompt length
  // outside [1, Tp] or a step outside [0, Td) makes the CTA's output NaN
  const int prompt_len = *prompt_len_at, step = *step_at;
  if (prompt_len < 1 || prompt_len > Tp || step < 0 || step >= Td) {
    for (int i = threadIdx.x; i < K * DH; i += THREADS)
      store_f(out + (((size_t)blockIdx.y * K + i / DH) * H + blockIdx.x) * DH + i % DH,
              __int_as_float(0x7fffffff));
    return;
  }
  plan = plan_of(plan.cap, plan.smem, K, prompt_len, step + 1);
  const int P = prompt_len, S = step + 1, NU = P + S;  // staged slots: prompt, decode
  const int n = plan.chunks, items = 2 * n, ST = STAGES;
  const size_t stage_bytes = (size_t)plan.cap * RB;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + BARS;
  float4* q4 = reinterpret_cast<float4*>(ring + ST * stage_bytes);       // [K][DH / 4]
  float* sc = reinterpret_cast<float*>(q4 + K * DH / 4);                 // [K][NU]
  short* code = reinterpret_cast<short*>(sc + a16(4LL * K * NU) / 4);    // [K][NU]
  float* red = reinterpret_cast<float*>(code + a16(2LL * K * NU) / 2);   // [K][DH]
  float* lsum = red + K * DH;                                            // [K]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int N = B * K;
  const size_t prompt_base = (((size_t)layer * B + b) * H + h) * (size_t)Tp * DH;
  const size_t decode_base = (((size_t)layer * N + (size_t)b * K) * H + h) * (size_t)Td * DH;
  const size_t row_stride = (size_t)H * Td * DH;  // between a stream's physical decode rows
  const int rp = row_pad[b];

  // item i: chunk i % n of K (i < n) or of V, into stage i % ST; warp 0
  // issues it, one span a lane (0: the prompt's rows, 1 + j: decode row j)
  auto issue = [&](int i) {
    const Chunk ch = chunk_at(i % n, plan, S);
    const bool v = i >= n;
    unsigned char* dst = ring + (i % ST) * stage_bytes;
    uint64_t* full = &bar[i % ST];
    if (lane == 0) mbar_expect_tx(full, (uint32_t)(ch.np + K * ch.nd) * RB);
    __syncwarp();
    for (int s = lane; s <= K; s += 32) {
      if (s == 0) {
        if (ch.np > 0)
          bulk_load(dst, (v ? pv : pk) + prompt_base + (size_t)ch.p0 * DH, ch.np * RB, full);
      } else if (ch.nd > 0) {
        bulk_load(dst + (size_t)(ch.np + (s - 1) * ch.nd) * RB,
                  (v ? dv : dk) + decode_base + (s - 1) * row_stride + (size_t)ch.d0 * DH,
                  ch.nd * RB, full);
      }
    }
  };

  if (warp == 0) {
    if (lane == 0) {
      for (int s = 0; s < ST; ++s) mbar_init(&bar[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    for (int i = 0; i < imin(ST, items); ++i) issue(i);
  }
  // meanwhile warps 1-3 stage q (scaled in f32, rounded to T, kept in f32
  // in dot_row's chunks) and warps 4-7 the ancestry, each thread's loads
  // issued together (warp 0's would queue behind its bulk copies)
  const int plane = K * CH;  // bf16: the second plane of q4
  constexpr int QT = 96, AT = THREADS - 128;  // threads staging q, the ancestry
  for (int i = tid - 32; i < K * CH && warp > 0 && warp < 4; i += QT) {
    const int k = i / CH, j = i % CH;
    const uint4 raw = reinterpret_cast<const uint4*>(q + (((size_t)b * K + k) * H + h) * DH)[j];
    float f[E];
    chunk_floats(raw, f, tag);
#pragma unroll
    for (int e = 0; e < E; ++e) f[e] = round_to(f[e] * scale, tag);
    q4[k * CH + j] = make_float4(f[0], f[1], f[2], f[3]);
    if constexpr (E == 8) q4[plane + k * CH + j] = make_float4(f[4], f[5], f[6], f[7]);
  }
  // each (beam, joint slot)'s staged row in its chunk, from the ancestry
  for (int i0 = 0; i0 < K * NU && warp >= 4; i0 += AT * 8) {
    int a[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * AT + tid - 128, k = i / NU, t = i - k * NU - P;
      a[u] = i < K * NU && t >= 0 ? anc[((size_t)b * K + k) * Td + t] : 0;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * AT + tid - 128;
      if (i < K * NU) code[i] = (short)staged_row(i % NU, a[u], plan, K, P, S, rp);
    }
  }
  __syncthreads();

  const int rot = lane & 7;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  // scores of K's chunks: a thread a (beam, slot) pair, the whole row's dot
  // product; then the stage is read, and takes its next item
  for (int ci = 0; ci < n; ++ci) {
    const Chunk ch = chunk_at(ci, plan, S);
    mbar_wait(&bar[ci % ST], (ci / ST) & 1);
    const uint4* rows = reinterpret_cast<const uint4*>(ring + (ci % ST) * stage_bytes);
    const int ns = ch.np + ch.nd;
    for (int i = tid; i < K * ns; i += THREADS) {
      const int k = i / ns, u = joint_slot(ch, i - k * ns, P), row = code[k * NU + u];
      float x = row == MASKED ? WDT_NEG_INF : __int_as_float(0x7fffffff);
      if (row >= 0) x = dot_row<T>(rows + row * CH, q4 + k * CH, plane, rot);
      sc[k * NU + u] = x;
    }
    __syncthreads();
    if (ci + ST < items && warp == 0) issue(ci + ST);
  }

  // From here each warp owns beams warp, warp + WARPS, ...: its softmax and
  // its P.V touch no other warp's data, so the warps meet only where a ring
  // stage is refilled. The softmax: f32 max and sum over the joint row,
  // probabilities rounded to T against the max. A bad ancestor's NaN score
  // makes the sum NaN, so that beam's output is NaN.
  for (int k = warp; k < K; k += WARPS) {
    float* srow = sc + k * NU;
    float m = WDT_NEG_INF;
    for (int t = lane; t < NU; t += 32) m = fmaxf(m, srow[t]);
    m = warp_max(m);
    float l = 0.0f;
    for (int t = lane; t < NU; t += 32) {
      const float p = expf(srow[t] - m);
      l += p;
      srow[t] = round_to(p, tag);
    }
    l = warp_sum(l);
    if (lane == 0) lsum[k] = l;
  }
  __syncwarp();

  // P.V over V's chunks: a beam's warp takes PARTS rows at once (CH lanes a
  // row, a 16-byte chunk each), lane group g the chunk's slots s = g (mod
  // PARTS); each chunk's groups summed in a fixed order, the chunks' sums
  // carried in `red`, the total divided by the normalizer
  const int g = lane / CH, c = lane % CH;
  for (int ci = 0; ci < n; ++ci) {
    const int i = n + ci;
    const Chunk ch = chunk_at(ci, plan, S);
    mbar_wait(&bar[i % ST], (i / ST) & 1);
    const uint4* rows = reinterpret_cast<const uint4*>(ring + (i % ST) * stage_bytes);
    const int ns = ch.np + ch.nd;
    for (int k = warp; k < K; k += WARPS) {
      float acc[E];
#pragma unroll
      for (int j = 0; j < E; ++j) acc[j] = 0.0f;
      for (int s0 = g; s0 < ns; s0 += PARTS * UNROLL) {
        uint4 raw[UNROLL];
        float p[UNROLL];
        int slot[UNROLL], row[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int s = s0 + u * PARTS;
          slot[u] = joint_slot(ch, s, P);
          row[u] = s < ns ? code[k * NU + slot[u]] : MASKED;
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          raw[u] = row[u] >= 0 ? rows[row[u] * CH + c] : zero4;
          p[u] = row[u] >= 0 ? sc[k * NU + slot[u]] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          float f[E];
          chunk_floats(raw[u], f, tag);
#pragma unroll
          for (int j = 0; j < E; ++j) acc[j] = fmaf(p[u], f[j], acc[j]);
        }
      }
      float* sum = red + k * DH + c * E;
#pragma unroll
      for (int j = 0; j < E; ++j) {
#pragma unroll
        for (int w = CH; w < 32; w <<= 1) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], w);
        if (ci > 0) acc[j] += sum[j];
      }
      if (ci + 1 < n) {
        if (g == 0) {
#pragma unroll
          for (int j = 0; j < E; ++j) sum[j] = acc[j];
        }
      } else if (g == 0) {
        const float l = lsum[k];
#pragma unroll
        for (int j = 0; j < E; ++j) acc[j] /= l;
        reinterpret_cast<uint4*>(out + (((size_t)b * K + k) * H + h) * DH)[c] =
            floats_chunk(acc, tag);
      }
    }
    if (i + ST < items) {
      __syncthreads();
      if (warp == 0) issue(i + ST);
    }
  }
}

template <typename T>
int launch(const void* q, const void* pk, const void* pv, const void* dk, const void* dv,
           const void* anc, const void* row_pad, const void* prompt_len, const void* step,
           void* out, int B, int K, int H, int Tp, int Td, int layer, void* stream) {
  // planned for the largest prompt and step the caches hold
  Plan plan;
  if (!make_plan(K, Tp, Td, sizeof(T), &plan)) return static_cast<int>(cudaErrorInvalidValue);
  if (plan.smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        split_self_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(H, B);
  split_self_kernel<T><<<grid, THREADS, plan.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(pk), static_cast<const T*>(pv),
      static_cast<const T*>(dk), static_cast<const T*>(dv), static_cast<const int*>(anc),
      static_cast<const int*>(row_pad), static_cast<const int*>(prompt_len),
      static_cast<const int*>(step), static_cast<T*>(out), B, K, H, Tp, Td, layer,
      0.125f /* 64^-0.5 */, plan);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, K, H, 64], pk / pv [L, B, H, Tp, 64], dk / dv [L, B*K, H, Td, 64],
// out [B, K, H, 64]: bf16 (wdt_split_self_attn) or f32 (..._f32); anc
// [B, K, Td] and row_pad [B] int32; prompt_len and step one int32 each in
// device memory, read by the kernel, so no launch argument depends on
// them (a captured graph replays one launch at every step and prompt
// length); all contiguous, the caches 16-byte aligned.
WDT_EXPORT int wdt_split_self_attn(const void* q, const void* pk, const void* pv,
                                   const void* dk, const void* dv, const void* anc,
                                   const void* row_pad, const void* prompt_len,
                                   const void* step, void* out, int B, int K, int H, int Tp,
                                   int Td, int layer, void* stream) {
  return launch<bf16>(q, pk, pv, dk, dv, anc, row_pad, prompt_len, step, out, B, K, H, Tp, Td,
                      layer, stream);
}

WDT_EXPORT int wdt_split_self_attn_f32(const void* q, const void* pk, const void* pv,
                                       const void* dk, const void* dv, const void* anc,
                                       const void* row_pad, const void* prompt_len,
                                       const void* step, void* out, int B, int K, int H,
                                       int Tp, int Td, int layer, void* stream) {
  return launch<float>(q, pk, pv, dk, dv, anc, row_pad, prompt_len, step, out, B, K, H, Tp, Td,
                       layer, stream);
}

// The plan `launch` takes for these arguments (ops/attn.py::split_self_plan
// mirrors it): out = {cap, stages, smem, chunks}; non-zero where there is
// none.
WDT_EXPORT int wdt_split_self_plan(int K, int prompt_len, int step, int f32, int* out) {
  Plan plan;
  if (!make_plan(K, prompt_len, step + 1, f32 ? 4 : 2, &plan))
    return static_cast<int>(cudaErrorInvalidValue);
  out[0] = plan.cap;
  out[1] = STAGES;
  out[2] = plan.smem;
  out[3] = plan.chunks;
  return 0;
}
