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
// row, up along the left column. A row's anchor is its first-entered frame
// (the last one the backward walk writes); rows >= nt read 0. Cells outside
// the submatrix are never read, so NaNs there change nothing.
//
// Design: one CTA a batch row, one thread a text row (N <= 1024). The DP
// sweeps the anti-diagonals d = i + j, one block barrier each; the costs of
// diagonals d-2, d-1 and d live in three rotating shared-memory rows. Each
// cell's choice (0 diag, 1 up, 2 left) is kept as 2 bits in dynamic shared
// memory, 16 a word, a text row's words contiguous; a thread gathers the 16
// codes of a word in a register and stores the word once. Then thread 0
// walks the codes and writes the anchors to shared memory, which the block
// copies out. A thread loads its cost cell one diagonal ahead (eight loads
// in flight, tried, changed nothing on the H100: the load does not hold a
// diagonal). At N 440 x Ta 1500 the codes take 165,440 bytes, the block
// 172,480 (the wrapper refuses shapes above the 232,448 a block may use).
//
// What bounds it on the H100: neither bytes nor operations (the cost matrix
// is read once, ~4 operations a cell) but the chain of N + Ta - 1 dependent
// diagonals and the walk's N + Ta dependent steps, on B SMs.
#include "common.cuh"

namespace {

constexpr int DTW_MAX_THREADS = 1024;
constexpr int CODE_DIAG = 0, CODE_UP = 1, CODE_LEFT = 2;

__host__ __device__ __forceinline__ int code_words(int Ta) { return (Ta + 15) / 16; }

// mirrored by ops/dtw.py::dtw_smem_bytes
__host__ __device__ __forceinline__ size_t dtw_smem_bytes(int N, int Ta) {
  // codes, three diagonals of costs, the anchors
  return (size_t)N * code_words(Ta) * 4 + 3 * (size_t)N * 4 + (size_t)N * 4;
}

__global__ void dtw_anchors_kernel(const float* __restrict__ cost,
                                   const int* __restrict__ n_tok,
                                   const int* __restrict__ n_frames, int S, int Ta,
                                   int sot_len, int N, int* __restrict__ anchors) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = code_words(Ta);
  uint32_t* codes = reinterpret_cast<uint32_t*>(smem);
  float* diag = reinterpret_cast<float*>(codes + (size_t)N * words);  // [3][N]
  int* anch = reinterpret_cast<int*>(diag + 3 * N);

  const int b = blockIdx.x, i = threadIdx.x;
  const int nt = min(max(n_tok[b], 1), N);
  const int nf = min(max(n_frames[b], 1), Ta);
  for (int r = i; r < N; r += blockDim.x) anch[r] = 0;

  const float* xrow = cost + ((size_t)b * S + sot_len + i) * Ta;
  const bool live = i < nt;
  // this thread's cell of diagonal d is (i, d - i), valid for 0 <= d - i < nf
  auto load = [&](int d) {
    const int j = d - i;
    return (live && j >= 0 && j < nf) ? __ldg(xrow + j) : 0.0f;
  };
  float x_next = load(0);
  uint32_t word = 0;
  const int n_diag = nt + nf - 1;
  for (int d = 0; d < n_diag; ++d) {
    const float x = x_next;
    x_next = load(d + 1);
    const int j = d - i;
    if (live && j >= 0 && j < nf) {
      float* cur = diag + (d % 3) * N;
      const float* p1 = diag + ((d + 2) % 3) * N;  // diagonal d - 1
      const float* p2 = diag + ((d + 1) % 3) * N;  // diagonal d - 2
      float c;
      int code;
      if (i == 0 && j == 0) {
        c = x;
        code = CODE_DIAG;  // never read: the walk stops here
      } else if (i == 0) {
        c = p1[0] + x;  // c[0, j-1] + x[0, j]
        code = CODE_LEFT;
      } else if (j == 0) {
        c = x + p1[i - 1];  // x[i, 0] + c[i-1, 0]
        code = CODE_UP;
      } else {
        const float dg = p2[i - 1], up = p1[i - 1], lf = p1[i];
        c = x + fminf(up, fminf(dg, lf));
        code = (dg <= up && dg <= lf) ? CODE_DIAG : (up <= lf ? CODE_UP : CODE_LEFT);
      }
      cur[i] = c;
      word |= (uint32_t)code << (2 * (j & 15));
      if ((j & 15) == 15 || j == nf - 1) {
        codes[(size_t)i * words + (j >> 4)] = word;
        word = 0;
      }
    }
    __syncthreads();
  }

  if (i == 0) {
    int r = nt - 1, c = nf - 1;
    while (true) {
      anch[r] = c;  // the backward walk ends each row at its first frame
      if (r == 0 && c == 0) break;
      const int code = (codes[(size_t)r * words + (c >> 4)] >> (2 * (c & 15))) & 3;
      if (code != CODE_LEFT) --r;
      if (code != CODE_UP) --c;
    }
  }
  __syncthreads();
  for (int r = i; r < N; r += blockDim.x) anchors[(size_t)b * N + r] = anch[r];
}

}  // namespace

// cost f32 [B, S, Ta] contiguous; n_tok, n_frames int32 [B]; anchors int32
// [B, N] with N = S - sot_len (1 <= N <= 1024).
WDT_EXPORT int wdt_dtw_anchors(const void* cost, const void* n_tok, const void* n_frames,
                               int B, int S, int Ta, int sot_len, void* anchors,
                               void* stream) {
  const int N = S - sot_len;
  if (B < 1 || Ta < 1 || sot_len < 0 || N < 1 || N > DTW_MAX_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = dtw_smem_bytes(N, Ta);
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > (size_t)limit) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      dtw_anchors_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = ((N + 31) / 32) * 32;
  dtw_anchors_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<const int*>(n_tok),
      static_cast<const int*>(n_frames), S, Ta, sot_len, N, static_cast<int*>(anchors));
  return static_cast<int>(cudaGetLastError());
}
