// DTW anchor frames: the monotonic DTW DP over each row's cost submatrix and
// the backtrack, on the card, so that only [B, N] int32 anchors reach the
// host (`ops/dtw.py::dtw_anchor_frames_batch`).
//
// Replaces no TPU kernel: the JAX package runs this step as two XLA loops,
// `whisper_diarize_tpu/ops/dtw.py::dtw_anchor_frames_batch` (a lax.scan over
// rows of an associative min-plus scan, then a lax.scan pointer walk of
// N + Ta steps). In PyTorch's eager mode either loop is ~2,000 dependent
// launches a batch at large-v3 widths; this kernel is one launch.
//
// Semantics (those of the port's host DP, `native/wdt_native.cpp::dtw_full`):
// for row b the submatrix x = cost[b, sot_len : sot_len + nt, : nf], with
// nt = clip(n_tok[b], 1, N), nf = clip(n_frames[b], 1, Ta);
//   c[i, j] = x[i, j] + min(c[i-1, j-1], c[i-1, j], c[i, j-1])
// (row 0 and column 0 take their one neighbour), one f32 add a cell, so
// every cell rounds as the host DP rounds it and the anchors agree bit for
// bit. The walk from (nt-1, nf-1) moves diagonally when diag <= up and
// diag <= left, else up when up <= left, else left; left along the top
// row, up along the left column. A row's anchor is its first-entered frame;
// rows >= nt read 0. Cells outside the submatrix are never read, so NaNs
// there change nothing.
//
// What bounds it on the H100: neither bytes nor operations (the cost is read
// once, ~4 operations a cell; ~0.003 ms at B 8, N 224, Ta 1500) but a chain
// of dependent cells: a row's DP needs the row above, so B rows of nt x nf
// cells take at least nt + nf - 1 dependent steps, and the walk is serial.
// The design keeps each link of that chain short:
//
// - A wavefront in registers, one warp 32 text rows. Text row i is lane
//   i % 32 of warp i / 32; a step is one 16-byte block of four columns, and
//   lane l works on block t - l at step t. Its four cells' `up` and `diag`
//   come from lane l - 1 by __shfl_up_sync, one a cell, issued as soon as
//   lane l - 1 has the cell (the diagonal of the block's first column is the
//   last `up` of the step before); `left` is the lane's own register. No
//   block barrier and no shared-memory round trip for a cost: a row of
//   Ta 1500 is 375 + 31 steps, not 1,500 + 31 diagonals. Cells left of
//   column 0 hold +inf (row 0's first diagonal -0.0), so row 0 and column 0
//   need no branch.
// - Costs: each lane copies its own row's next blocks with cp.async, 16
//   bytes a step, AHEAD - 1 steps ahead, into a ring of AHEAD slots a warp
//   (4-byte copies where Ta % 4 != 0). The copies hold no registers and no
//   scoreboard the shuffles wait on: loads into registers, consumed eight
//   steps later, were slower in a register-prefetch form of this kernel.
// - N > 32: warp w + 1 takes row 32w + 31 from warp w through a ring of
//   RING chunks of blocks in shared memory, a chunk (CHUNK blocks) behind,
//   with a full and an empty mbarrier a slot: one wait a chunk, any number
//   of warps (N <= 1024, 32 warps), and a waiting warp is suspended, not
//   spinning. A warp starts ~40 steps after the one above it.
// - Codes: each cell's two code bits are sign bits of two f32 differences,
//   funnel-shifted into a register word without a compare; the lane stores
//   the word every four steps, 16 cells a word, a text row's words
//   contiguous. The words of row i start at column -4 (i % 4) (the lanes'
//   skew), so every lane stores at the same step: column c of row i is word
//   (c + 4 (i % 4)) / 16.
// - The walk (one thread): in a row it finds the next move that is not
//   `left` with one bit scan of the code word (`__ffs` of its non-left cells
//   at or below the column), so a run of left moves costs nothing, and it
//   loads the next row's two candidate words before the move is known: ~N
//   + Ta / 16 shared-memory reads, not N + Ta dependent steps. It writes
//   each row's anchor to global memory as it leaves the row.
//
// Measured on the H100 (`tools/bench_dtw.py --probe`, `PERF.md` §6): a
// step of one warp takes ~140 cycles, ~85 without the handoff ring, the
// code-word stores and the copies, so the step's shared-memory traffic
// holds it as much as its arithmetic chain (four dependent min + add pairs)
// and the shuffles do; with 7 warps on one SM a step takes ~210 cycles. The
// walk takes ~180 cycles a row: ~20 µs at N 224, a fifth of the kernel.
//
// Shared memory: the codes, N x ((Ta + 27) / 16) words (167,200 bytes at
// N 440, Ta 1500), each warp's cost ring (4 KB) and the warp pairs' rings
// and barriers (576 bytes a pair): 232,032 bytes at N 440; the
// wrapper refuses shapes above the 232,448 a block may use (`make_plan`,
// mirrored by `ops/dtw.py::dtw_plan`).
#include "common.cuh"

namespace {

constexpr int DTW_MAX_ROWS = 1024;
constexpr int DTW_SMEM_LIMIT = 232448;
// A cell's two code bits, the sign bits of m - diag (m = min(diag, up,
// left): set where diag is not the least) and of left - up (set where left
// < up); the walk moves diagonally where the first is clear, else left
// where the second is set, else up. Cell p of a word (column 16 w - o + p
// of its row) holds bits 31 - 2p and 30 - 2p.
constexpr uint32_t LOW_BITS = 0x55555555u;  // the second bit of every cell
constexpr int CHUNK = 8;  // blocks (steps) a chunk: the loop's and the handoff's unit
constexpr int RING = 4;   // chunks in a warp pair's ring
constexpr int LAG = 31;   // lane l works on block t - l at step t
constexpr int SLOTS = RING * CHUNK;  // blocks a ring holds (a power of 2)
constexpr int AHEAD = CHUNK;  // slots of a lane's cost ring: blocks copied 7 steps ahead
// shared memory beside the codes: each warp's cost ring, and a ring of row
// 32w + 31's blocks for each pair of neighbouring warps with a full and an
// empty mbarrier a slot
constexpr int PAIR_BYTES = SLOTS * 16 + 2 * RING * 8, COST_RING_BYTES = AHEAD * 32 * 16;

struct Plan {
  int warps, words, smem;
};

__host__ __device__ __forceinline__ int code_words(int Ta) { return (Ta + 27) / 16; }
__host__ __device__ __forceinline__ size_t codes_bytes(int N, int Ta) {
  return ((size_t)N * code_words(Ta) * 4 + 15) / 16 * 16;
}

// mirrored by ops/dtw.py::dtw_plan
bool make_plan(int N, int Ta, Plan* p) {
  if (N < 1 || N > DTW_MAX_ROWS || Ta < 1) return false;
  p->warps = (N + 31) / 32;
  p->words = code_words(Ta);
  const size_t smem = codes_bytes(N, Ta) + (size_t)p->warps * COST_RING_BYTES +
                      (size_t)(p->warps - 1) * PAIR_BYTES;
  if (smem > (size_t)DTW_SMEM_LIMIT) return false;
  p->smem = (int)smem;
  return true;
}

// predicated shared-memory stores: the lanes that do not store issue
// nothing. No "memory" clobber, so the compiler may move the ring's loads
// across them: a warp writes one ring and reads another, and the mbarrier
// arrives and the block barrier (volatile, "memory") keep their order.
__device__ __forceinline__ void st_shared_if(bool p, uint32_t* dst, uint32_t v) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n@p st.shared.b32 [%1], %2;\n}\n"
               :: "r"((int)p), "r"(smem_u32(dst)), "r"(v));
}
__device__ __forceinline__ void st_shared_if(bool p, float4* dst, float4 v) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n"
               "@p st.shared.v4.f32 [%1], {%2, %3, %4, %5};\n}\n"
               :: "r"((int)p), "r"(smem_u32(dst)), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w));
}

// (word << 1) | the sign bit of d: no compare, no predicate. The DP holds
// no -0 (the costs are read as x + 0), so for finite values the sign of
// a - b is set exactly where a < b, and a - b is +0 where a == b.
__device__ __forceinline__ uint32_t push_sign(uint32_t word, float d) {
  return __funnelshift_l(__float_as_uint(d), word, 1);
}

// one cell: c = x + min(diag, up, left), one f32 add, and its two code bits
__device__ __forceinline__ float cell(float x, float dg, float up, float lf, uint32_t& word) {
  const float m = fminf(fminf(dg, up), lf);
  word = push_sign(push_sign(word, m - dg), lf - up);
  return x + m;
}

template <bool kVec, int kThreads>
__global__ void __launch_bounds__(kThreads, 1)
    dtw_anchors_kernel(const float* __restrict__ cost, const int* __restrict__ n_tok,
                       const int* __restrict__ n_frames, int S, int Ta, int sot_len, int N,
                       int* __restrict__ anchors) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x / 32, words = code_words(Ta);
  uint32_t* codes = reinterpret_cast<uint32_t*>(smem);
  float4* xring = reinterpret_cast<float4*>(smem + codes_bytes(N, Ta));  // [warps][AHEAD][32]
  float4* rings = xring + warps * AHEAD * 32;  // [warps - 1][SLOTS]: ring w - 1 feeds warp w
  uint64_t* bars = reinterpret_cast<uint64_t*>(rings + (warps - 1) * SLOTS);

  const int b = blockIdx.x, lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nt = min(max(n_tok[b], 1), N), nf = min(max(n_frames[b], 1), Ta);
  const float inf = __int_as_float(0x7f800000);
  if ((int)threadIdx.x < (warps - 1) * 2 * RING) mbar_init(bars + threadIdx.x, 1);
  __syncthreads();

  const int live_warps = (nt + 31) / 32;
  if (w < live_warps) {
    const int i = 32 * w + lane;
    const int nblk = (nf + 3) / 4, nchunks = (nblk + CHUNK - 1) / CHUNK;
    const float* xrow = cost + ((size_t)b * S + sot_len + min(i, N - 1)) * Ta;
    // warp w - 1 -> w: ring w - 1 of row 32w - 1's blocks; full and empty
    // barriers. Warp 0 reads no ring: above row 0 is +inf.
    const bool consumer = w > 0, producer = w + 1 < live_warps;
    const float4* ring_in = rings + (w - 1) * SLOTS;
    float4* ring_out = rings + w * SLOTS;  // written by lane 31 of a producer
    const bool hands_on = producer && lane == 31;
    uint64_t* full_in = bars + (w - 1) * 2 * RING;
    uint64_t* empty_in = full_in + RING;
    uint64_t* full_out = bars + w * 2 * RING;
    uint64_t* empty_out = full_out + RING;

    // The costs reach the lane by cp.async, 16 bytes a step into a ring of
    // AHEAD slots, one commit group a step: the copies need no registers and
    // no scoreboard the shuffles wait on. Block k of the lane's row is
    // clamped to the row's blocks: the cells left of column 0 then hold
    // +inf (or NaN), which fminf drops and the walk never reads; cells right
    // of nf or below nt hold garbage that only flows right and down.
    float4* xs = xring + w * AHEAD * 32 + lane;
    auto fetch = [&](int t, int slot) {  // block t - lane into slot t % AHEAD
      const int kc = min(max(t - lane, 0), nblk - 1);
      const float* src = xrow + 4 * kc;
      float4* dst = xs + slot * 32;
      if constexpr (kVec) {
        cp_async<16>(dst, src, true);
      } else {
        float* d = reinterpret_cast<float*>(dst);
#pragma unroll
        for (int e = 0; e < 4; ++e) cp_async<4>(d + e, src + (4 * kc + e < Ta ? e : 0), 4 * kc + e < Ta);
      }
      cp_async_commit();
    };
#pragma unroll
    for (int t = 0; t < AHEAD - 1; ++t) fetch(t, t);
    float c0 = inf, c1 = inf, c2 = inf, c3 = inf;  // the lane's last block
    float s0 = inf, s1 = inf, s2 = inf, s3 = inf;  // lane l - 1's last block
    float pu3 = i == 0 ? -0.0f : inf;              // c[i-1, first column - 1]
    uint32_t word = 0;
    uint32_t* code_row = codes + (size_t)min(i, N - 1) * words - (lane >> 2);
    const bool code_rows = i < nt;
    int next_full = 0;  // producer: the next chunk to publish
    float4 e = make_float4(inf, inf, inf, inf), e_next = e;  // row 32w - 1's blocks
    const int n_steps = nblk + LAG;
    for (int t0 = 0, ch = 0; t0 < n_steps; t0 += CHUNK, ++ch) {
      if (consumer && ch < nchunks) mbar_wait(full_in + ch % RING, (ch / RING) & 1);
      // this chunk's steps write the first block of chunk ch - 3
      const int cw = ch - 3;
      if (producer && cw >= RING && cw < nchunks)
        mbar_wait(empty_out + cw % RING, ((cw / RING) - 1) & 1);
      // row 32w - 1's blocks t0 and t0 + 1, then each block two steps ahead
      if (consumer) {
        e = ring_in[t0 & (SLOTS - 1)];
        e_next = ring_in[(t0 + 1) & (SLOTS - 1)];
      }
#pragma unroll
      for (int q = 0; q < CHUNK; ++q) {
        const int t = t0 + q;
        cp_async_wait<AHEAD - 2>();  // this lane's copy of step t has landed
        const float4 xv = xs[q * 32];  // t % AHEAD == q: t0 steps a chunk of AHEAD
        const float4 x = make_float4(xv.x + 0.0f, xv.y + 0.0f, xv.z + 0.0f, xv.w + 0.0f);  // -0 -> +0
        fetch(t + AHEAD - 1, (q + AHEAD - 1) % AHEAD);  // into the slot read at step t - 1
        const float u0 = lane == 0 ? e.x : s0, u1 = lane == 0 ? e.y : s1;
        const float u2 = lane == 0 ? e.z : s2, u3 = lane == 0 ? e.w : s3;
        e = e_next;
        if (consumer && q + 2 < CHUNK) e_next = ring_in[(t + 2) & (SLOTS - 1)];
        const float d0 = pu3;
        pu3 = u3;
        // each cell's value goes to lane l + 1 as soon as it is known
        c0 = cell(x.x, d0, u0, c3, word);
        s0 = __shfl_up_sync(0xffffffffu, c0, 1);
        c1 = cell(x.y, u0, u1, c0, word);
        s1 = __shfl_up_sync(0xffffffffu, c1, 1);
        c2 = cell(x.z, u1, u2, c1, word);
        s2 = __shfl_up_sync(0xffffffffu, c2, 1);
        c3 = cell(x.w, u2, u3, c2, word);
        s3 = __shfl_up_sync(0xffffffffu, c3, 1);
        if ((q & 3) == 3) {  // the word of columns 16 (t / 4 - lane / 4) - 4 (lane % 4) + [0, 16)
          const int wi = (t >> 2) - (lane >> 2);
          st_shared_if(code_rows && wi >= 0 && wi < words, code_row + (t >> 2), word);
        }
        // lane 31 hands row 32w + 31's block t - 31 to warp w + 1 (blocks
        // left of column 0 too: those slots are not yet read)
        st_shared_if(hands_on && t < n_steps, ring_out + ((t - LAG) & (SLOTS - 1)),
                     make_float4(c0, c1, c2, c3));
      }
      if (producer && lane == 31) {  // publish each chunk whose valid blocks are all written
        while (next_full < nchunks &&
               min(CHUNK * (next_full + 1), nblk) - 1 + LAG <= t0 + CHUNK - 1) {
          mbar_arrive(full_out + next_full % RING);
          ++next_full;
        }
      }
      if (consumer && lane == 0 && ch < nchunks) mbar_arrive(empty_in + ch % RING);
    }
  }
  __syncthreads();

  int* out = anchors + (size_t)b * N;
  for (int r = nt + threadIdx.x; r < N; r += blockDim.x) out[r] = 0;
  if (threadIdx.x == 0) {
    int r = nt - 1, c = nf - 1, o = 4 * (r & 3);  // row r's words start at column -o
    const uint32_t* row = codes + (size_t)r * words;
    int wi = (c + o) >> 4;
    uint32_t word = row[wi];
    while (r > 0) {
      // the cells that are not `left` at or below column c, one bit each
      const int pos = c + o;
      uint32_t m = ~(word & (word >> 1)) & LOW_BITS & (0xFFFFFFFFu << (30 - 2 * (pos & 15)));
      while (m == 0 && wi > 0) {
        word = row[--wi];
        m = ~(word & (word >> 1)) & LOW_BITS;
      }
      const int lb = __ffs(m) - 1;  // 30 - 2 x the cell of the move out of row r
      const int cc = m ? 16 * wi + 15 - (lb >> 1) - o : 0;  // where the walk leaves row r
      const int cz = max(cc, 0);  // column 0 moves up
      out[r] = cz;
      // row r - 1: its words at columns cz - 1 and cz, loaded before the
      // move is known
      row -= words;
      o = (o - 4) & 12;
      const int w_up = (cz + o) >> 4, w_diag = (max(cz - 1, 0) + o) >> 4;
      const uint32_t word_up = row[w_up], word_diag = row[w_diag];
      const bool diag = cc > 0 && !((word >> (lb + 1)) & 1);
      c = diag ? cz - 1 : cz;
      wi = diag ? w_diag : w_up;
      word = diag ? word_diag : word_up;
      --r;
    }
    out[0] = 0;
  }
}

template <bool kVec, int kThreads>
int launch_at(const float* cost, const int* n_tok, const int* n_frames, int B, int S, int Ta,
           int sot_len, int N, const Plan& plan, int* anchors, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(dtw_anchors_kernel<kVec, kThreads>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         plan.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dtw_anchors_kernel<kVec, kThreads><<<B, plan.warps * 32, plan.smem, stream>>>(
      cost, n_tok, n_frames, S, Ta, sot_len, N, anchors);
  return static_cast<int>(cudaGetLastError());
}

// kThreads: 512 for up to 16 warps (N <= 512, every shape the Engine feeds),
// 1024 (64 registers a thread) above
template <bool kVec>
int launch(const float* cost, const int* n_tok, const int* n_frames, int B, int S, int Ta,
           int sot_len, int N, const Plan& plan, int* anchors, cudaStream_t stream) {
  if (plan.warps <= 16)
    return launch_at<kVec, 512>(cost, n_tok, n_frames, B, S, Ta, sot_len, N, plan, anchors, stream);
  return launch_at<kVec, 1024>(cost, n_tok, n_frames, B, S, Ta, sot_len, N, plan, anchors, stream);
}

}  // namespace

// The plan `wdt_dtw_anchors` launches with (ops/dtw.py::dtw_plan mirrors
// it): out = {warps, chunk, ring, words, smem}; non-zero where there is none.
WDT_EXPORT int wdt_dtw_plan(int N, int Ta, int* out) {
  Plan plan;
  if (!make_plan(N, Ta, &plan)) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = plan.warps;
  out[1] = CHUNK;
  out[2] = RING;
  out[3] = plan.words;
  out[4] = plan.smem;
  return 0;
}

// cost f32 [B, S, Ta] contiguous; n_tok, n_frames int32 [B]; anchors int32
// [B, N] with N = S - sot_len (1 <= N <= 1024).
WDT_EXPORT int wdt_dtw_anchors(const void* cost, const void* n_tok, const void* n_frames,
                               int B, int S, int Ta, int sot_len, void* anchors,
                               void* stream) {
  const int N = S - sot_len;
  Plan plan;
  if (B < 1 || sot_len < 0 || !make_plan(N, Ta, &plan))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (plan.smem > limit) return static_cast<int>(cudaErrorInvalidValue);
  const float* c = static_cast<const float*>(cost);
  const int* nt = static_cast<const int*>(n_tok);
  const int* nf = static_cast<const int*>(n_frames);
  int* out = static_cast<int*>(anchors);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Ta % 4 == 0 && reinterpret_cast<uintptr_t>(cost) % 16 == 0)
    return launch<true>(c, nt, nf, B, S, Ta, sot_len, N, plan, out, s);
  return launch<false>(c, nt, nf, B, S, Ta, sot_len, N, plan, out, s);
}
