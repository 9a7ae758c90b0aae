// K7: the fused log-mel frontend (framing with the center reflect padding,
// Hann window, a real 400-point FFT, power, mel filterbank, log10) in one
// kernel, one launch a call.
//
// Replaces tools/pallas_mel.py::log_mel_pallas (_mel_kernel, pallas_call at
// :117): for each 400-sample frame f (hop 160) of the audio reflect-padded
// by 200 samples at both ends,
//   out[f, m] = log10(max(sum_k |X_f[k]|^2 fb[k, m], 1e-10)),
// X_f the 201 bins of the real DFT of the Hann-windowed frame and fb the
// slaney filterbank. f32 in, f32 out; the clamp to the global max - 8 and the
// (x + 4) / 4 stay outside, as in the TPU version.
//
// Precision: the TPU kernel was quarantined partly because its default f32
// MXU precision drifted, so this kernel takes neither the tensor cores nor
// any reduced precision, and no fast-math intrinsic. The FFT, the split and
// the power run in float64 on the CUDA cores' FP64 units, the filterbank sums
// and the log in f32. An FFT in f32 rounds values of the frame's scale in its
// last stages, and a mel of one bin whose power is a thousandth of the
// frame's carries that error into its log: on chip_smoke's input an f32 FFT
// lay 1.70e-4 from the float64 log-mel, 4x the dense f32 DFT it replaces
// (4.42e-5), and 2.27e-5 in float64 (PERF.md §6).
//
// What bounds it on the H100: bytes. At B 8 x 30 s, 128 mels, log-mel moves
// 28 MB of audio in and mel out (8.3 us at 3.35 TB/s). The operations it
// needs are a frame's window (400), the FFT (2.5 N log2 N = 8,644), the power
// (603), the filterbank's 394 nonzero weights (788) and 128 logs: 10,563 a
// frame, 2.5e8 FLOP over 24,000 frames (7.1 us with the first three at the
// data sheet's 34 TFLOP/s float64 rate). What holds it back: shared-memory
// traffic (~27 KB a frame: the float64 window and twiddles, the FFT rows
// twice, the split) and the FP64 pipe, at 8 warps an SM (254 registers a
// thread, 105 KB a CTA); a form at 16 warps an SM, two lanes a row, was
// slower (PERF.md §6, §7).
//
// Design. A persistent grid of at most two CTAs an SM, four warps each; a
// warp walks quads of 4 consecutive frames of one row. It stages a quad's
// audio span (880 samples, from 200 before its first frame) by cp.async into
// one of its two buffers while it computes the quad before: 16-byte copies
// where the span lies inside the row and is aligned, else sample by sample,
// mirroring the indices at the edges itself (source j < 0 reads -j, j >= T
// reads 2 (T - 1) - j), so no padded copy of the audio exists. Eight lanes a
// frame:
// - the 400 windowed samples packed as 200 complex values z[n] = x[2n] +
//   i x[2n+1], and their 200-point FFT as 8 x 25 (n = j + 8 n2, k = k2 +
//   25 k1): lane j runs the 25-point DFT over n2 in registers (5 x 5, the
//   symmetric 5-point form), multiplies by W200^(j k2) and writes the row to
//   shared memory; then each lane runs 8-point DFTs over j for its columns k2
//   in place (a column's reads and writes are its own);
// - the real split X[k] = (Z[k] + Z*[200-k]) / 2 - i W400^k (Z[k] -
//   Z*[200-k]) / 2, a lane the bins k and 200 - k together, and the power,
//   rounded once to f32;
// - the sparse filterbank: a lane owns whole mels (m = lane + 32 i) for the
//   quad's four frames, each the sum of its run of bins in order, so every
//   sum keeps one fixed order and two calls give the same bits; log10,
//   staged over the quad's dead FFT rows, then one coalesced store of its
//   four output rows.
// Every twiddle, the 5- and 8-point constants, the window and the filterbank
// come from one table computed on the host in float64 and rounded once to f32
// (`ops/mel.py::fft_tables`, laid out at the offsets below and walked by
// `log_mel_fft_walk`, the kernel's stages in plain PyTorch); each CTA widens
// the FFT's part to float64 in shared memory once. Intermediates never reach
// device memory. A frame's complex rows are 16-byte entries, so a quarter
// warp's eight lanes cover the 32 banks; the power rows are 232 floats apart
// (8 banks).
#include "common.cuh"

namespace {

constexpr int HOP = 160;
constexpr int WIN = 400;
constexpr int NZ = 200;               // complex points of the packed FFT
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int FPG = 4;                // frames a warp takes at once
constexpr int SPAN = (FPG - 1) * HOP + WIN;  // audio samples a warp stages for its frames
constexpr int ZST = 4 * NZ;           // a frame's complex float64 row (floats)
constexpr int PST = 232;              // power row stride (floats)
constexpr int MAX_MELS = 128;
// the table's offsets in floats (ops/mel.py T_*)
constexpr int T_WIN = 0;              // [400] periodic Hann
constexpr int T_W5 = 400;             // cos(2pi/5), sin(2pi/5), cos(4pi/5), sin(4pi/5)
constexpr int T_R8 = 404;             // sqrt(1/2)
constexpr int T_W25 = 408;            // [25] W25^m, W_N = e^(-2 pi i / N)
constexpr int T_W200 = 458;           // [8][25] W200^(j k2)
constexpr int T_W400 = 858;           // [201] W400^k
constexpr int T_MELW = 1260;          // the filterbank's nonzero weights
constexpr int TAB_MAX = T_MELW + 2 * (NZ + 1) + 2;  // a bin feeds at most 2 mels
constexpr int SMEM_BYTES = 8 * T_MELW + 4 * ((TAB_MAX - T_MELW) + 3 * MAX_MELS +
                                             WARPS * (2 * SPAN + FPG * (ZST + PST)));

// 5-point DFT in place: x_k = sum_n x_n W5^(nk), the symmetric form
__device__ __forceinline__ void dft5(double& r0, double& i0, double& r1, double& i1, double& r2,
                                     double& i2, double& r3, double& i3, double& r4, double& i4,
                                     double c1, double s1, double c2, double s2) {
  const double t1r = r1 + r4, t1i = i1 + i4, t2r = r2 + r3, t2i = i2 + i3;
  const double d1r = r1 - r4, d1i = i1 - i4, d2r = r2 - r3, d2i = i2 - i3;
  const double a1r = r0 + c1 * t1r + c2 * t2r, a1i = i0 + c1 * t1i + c2 * t2i;
  const double a2r = r0 + c2 * t1r + c1 * t2r, a2i = i0 + c2 * t1i + c1 * t2i;
  const double b1r = s1 * d1r + s2 * d2r, b1i = s1 * d1i + s2 * d2i;
  const double b2r = s2 * d1r - s1 * d2r, b2i = s2 * d1i - s1 * d2i;
  r0 = r0 + t1r + t2r;
  i0 = i0 + t1i + t2i;
  r1 = a1r + b1i;  // a1 - i b1
  i1 = a1i - b1r;
  r4 = a1r - b1i;  // a1 + i b1
  i4 = a1i + b1r;
  r2 = a2r + b2i;
  i2 = a2i - b2r;
  r3 = a2r - b2i;
  i3 = a2i + b2r;
}

// 4-point DFT in place (W4 = -i)
__device__ __forceinline__ void dft4(double2& a0, double2& a1, double2& a2, double2& a3) {
  const double2 t0 = make_double2(a0.x + a2.x, a0.y + a2.y);
  const double2 t1 = make_double2(a0.x - a2.x, a0.y - a2.y);
  const double2 t2 = make_double2(a1.x + a3.x, a1.y + a3.y);
  const double2 t3 = make_double2(a1.x - a3.x, a1.y - a3.y);
  a0 = make_double2(t0.x + t2.x, t0.y + t2.y);
  a1 = make_double2(t1.x + t3.y, t1.y - t3.x);  // t1 - i t3
  a2 = make_double2(t0.x - t2.x, t0.y - t2.y);
  a3 = make_double2(t1.x - t3.y, t1.y + t3.x);  // t1 + i t3
}

// 8-point DFT in place: two 4-point DFTs (even, odd inputs) joined by W8^k
__device__ __forceinline__ void dft8(double2 (&y)[8], double r) {
  dft4(y[0], y[2], y[4], y[6]);
  dft4(y[1], y[3], y[5], y[7]);
  const double2 e[4] = {y[0], y[2], y[4], y[6]};
  double2 o[4] = {y[1], y[3], y[5], y[7]};
  o[1] = make_double2(r * (o[1].x + o[1].y), r * (o[1].y - o[1].x));   // W8^1 o1
  o[2] = make_double2(o[2].y, -o[2].x);                                 // -i o2
  o[3] = make_double2(r * (o[3].y - o[3].x), -r * (o[3].x + o[3].y));  // W8^3 o3
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    y[k] = make_double2(e[k].x + o[k].x, e[k].y + o[k].y);
    y[k + 4] = make_double2(e[k].x - o[k].x, e[k].y - o[k].y);
  }
}

__device__ __forceinline__ double2 cmul(double2 x, double2 w) {
  return make_double2(x.x * w.x - x.y * w.y, x.x * w.y + x.y * w.x);
}

// |X[k]|^2 of the real split from zk = Z[k], zr = Z[200-k], w = W400^k
__device__ __forceinline__ float split_power(double2 zk, double2 zr, double2 w) {
  const double sr = zk.x + zr.x, si = zk.y - zr.y;  // Z[k] + Z*[200-k]
  const double2 wd = cmul(make_double2(zk.x - zr.x, zk.y + zr.y), w);
  const double xr = 0.5 * sr + 0.5 * wd.y, xi = 0.5 * si - 0.5 * wd.x;
  return static_cast<float>(xr * xr + xi * xi);
}

// stage quad q's audio span (frames 4 (q % qpr) .. + 3 of row q / qpr) into
// xs by the warp's cp.async copies: source samples s0 .. s0 + need - 1,
// reflected at both edges; one commit group a lane
__device__ __forceinline__ void stage_quad(float* xs, const float* __restrict__ audio, int q,
                                           int qpr, int T, int F, int lane) {
  const int b = q / qpr, f0 = (q % qpr) * FPG;
  const long long s0 = (long long)f0 * HOP - WIN / 2;
  const int need = (min(FPG, F - f0) - 1) * HOP + WIN;  // a multiple of 4
  const float* xb = audio + (size_t)b * T;
  if (s0 >= 0 && s0 + need <= T && (reinterpret_cast<uintptr_t>(xb + s0) & 15) == 0) {
    for (int i = 4 * lane; i < need; i += 128) cp_async<16>(xs + i, xb + s0 + i, true);
  } else {
    for (int i = lane; i < need; i += 32) {
      long long j = s0 + i;
      j = j < 0 ? -j : j;
      j = j >= T ? 2LL * (T - 1) - j : j;
      cp_async<4>(xs + i, xb + j, true);
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(THREADS, 2)
log_mel_kernel(const float* __restrict__ audio, const float* __restrict__ tabg,
               const int* __restrict__ itabg, float* __restrict__ out, int B, int T, int F,
               int n_mels, int tab_len) {
  extern __shared__ __align__(16) double smem_d[];
  double* dt = smem_d;                                          // [T_MELW] the FFT's tables
  float* melw = reinterpret_cast<float*>(dt + T_MELW);          // [TAB_MAX - T_MELW]
  int* itab = reinterpret_cast<int*>(melw + TAB_MAX - T_MELW);  // [3][n_mels]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* xw = reinterpret_cast<float*>(itab + 3 * MAX_MELS) + warp * 2 * SPAN;  // [2][SPAN]
  float* zall = reinterpret_cast<float*>(itab + 3 * MAX_MELS) + WARPS * 2 * SPAN +
                warp * FPG * ZST;                               // the warp's [FPG][ZST]
  float* pw = zall + (WARPS - warp) * FPG * ZST + warp * FPG * PST;  // the warp's [FPG][PST]

  const int qpr = (F + FPG - 1) / FPG, total = B * qpr;  // quads of 4 frames
  const int stride = gridDim.x * WARPS;
  int q = blockIdx.x * WARPS + warp;
  if (q < total) stage_quad(xw, audio, q, qpr, T, F, lane);
  for (int i = tid; i < T_MELW; i += THREADS) dt[i] = tabg[i];
  for (int i = T_MELW + tid; i < tab_len; i += THREADS) melw[i - T_MELW] = tabg[i];
  for (int i = tid; i < 3 * n_mels; i += THREADS) itab[i] = itabg[i];
  __syncthreads();

  const int fq = lane >> 3, l = lane & 7;  // frame of the quad, lane in the frame
  double2* zf = reinterpret_cast<double2*>(zall + fq * ZST);
  float* pf = pw + fq * PST;
  float* ow = zall;                         // [FPG][n_mels] over the warp's dead Z rows
  // the lane's mels m = lane + 32 i: first bin, bin count, weights
  int mk0[MAX_MELS / 32], mn[MAX_MELS / 32];
  const float* mw[MAX_MELS / 32];
#pragma unroll
  for (int i = 0; i < MAX_MELS / 32; ++i) {
    const int m = lane + 32 * i;
    mk0[i] = m < n_mels ? itab[m] : 0;
    mn[i] = m < n_mels ? itab[n_mels + m] : 0;
    mw[i] = melw + (m < n_mels ? itab[2 * n_mels + m] : 0);
  }
  const double c1 = dt[T_W5], s1 = dt[T_W5 + 1], c2 = dt[T_W5 + 2], s2 = dt[T_W5 + 3];

  for (int it = 0; q < total; ++it, q += stride) {
    if (q + stride < total) {  // prefetch the next quad into the other buffer
      stage_quad(xw + ((it + 1) & 1) * SPAN, audio, q + stride, qpr, T, F, lane);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();  // every lane's copies of this quad landed
    const float* xs = xw + (it & 1) * SPAN;

    // 25-point DFT over n2 of z[l + 8 n2], n2 = p + 5 q; A[s + 5 r] ends at index 5 s + r
    {
      double ar[25], ai[25];
      const float* xf = xs + fq * HOP;
#pragma unroll
      for (int n2 = 0; n2 < 25; ++n2) {
        const int m = 2 * (l + 8 * n2);
        const float2 x = *reinterpret_cast<const float2*>(xf + m);
        const double2 w = *reinterpret_cast<const double2*>(dt + T_WIN + m);
        ar[n2] = x.x * w.x;  // exact: f32 x f32 in float64
        ai[n2] = x.y * w.y;
      }
#pragma unroll
      for (int p = 0; p < 5; ++p)  // over q: B_p[s] at index p + 5 s
        dft5(ar[p], ai[p], ar[p + 5], ai[p + 5], ar[p + 10], ai[p + 10], ar[p + 15], ai[p + 15],
             ar[p + 20], ai[p + 20], c1, s1, c2, s2);
#pragma unroll
      for (int p = 1; p < 5; ++p)
#pragma unroll
        for (int s = 1; s < 5; ++s) {  // W25^(p s)
          const double2 v = cmul(make_double2(ar[p + 5 * s], ai[p + 5 * s]),
                                 *reinterpret_cast<const double2*>(dt + T_W25 + 2 * (p * s)));
          ar[p + 5 * s] = v.x;
          ai[p + 5 * s] = v.y;
        }
#pragma unroll
      for (int s = 0; s < 5; ++s)  // over p: A[s + 5 r] at index 5 s + r
        dft5(ar[5 * s], ai[5 * s], ar[5 * s + 1], ai[5 * s + 1], ar[5 * s + 2], ai[5 * s + 2],
             ar[5 * s + 3], ai[5 * s + 3], ar[5 * s + 4], ai[5 * s + 4], c1, s1, c2, s2);
#pragma unroll
      for (int s = 0; s < 5; ++s)
#pragma unroll
        for (int r = 0; r < 5; ++r) {  // Y[l][k2] = A[k2] W200^(l k2)
          const int k2 = s + 5 * r;
          const double2 w = *reinterpret_cast<const double2*>(dt + T_W200 + 2 * (l * 25 + k2));
          zf[l * 25 + k2] = cmul(make_double2(ar[5 * s + r], ai[5 * s + r]), w);
        }
    }
    __syncwarp();

    // 8-point DFTs over j, column k2 in place: Z[k2 + 25 k1] at index 25 k1 + k2
    const double r8 = dt[T_R8];
    for (int k2 = l; k2 < 25; k2 += 8) {
      double2 y[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) y[j] = zf[25 * j + k2];
      dft8(y, r8);
#pragma unroll
      for (int k1 = 0; k1 < 8; ++k1) zf[25 * k1 + k2] = y[k1];
    }
    __syncwarp();

    // the real split and the power: a lane the bins u and 200 - u, two u at a time
#pragma unroll
    for (int r = 0; r < 13; r += 2) {
      const int u0 = l + 8 * r, u1 = u0 + 8;
      const bool has1 = r + 1 < 13 && u1 <= NZ / 2;
      if (u0 > NZ / 2) break;
      const double2 a0 = zf[u0], b0 = zf[(NZ - u0) % NZ];
      const double2 a1 = has1 ? zf[u1] : a0, b1 = has1 ? zf[NZ - u1] : b0;
      const double2* w = reinterpret_cast<const double2*>(dt + T_W400);
      const float p0 = split_power(a0, b0, w[u0]), q0 = split_power(b0, a0, w[NZ - u0]);
      const float p1 = split_power(a1, b1, w[has1 ? u1 : u0]);
      const float q1 = split_power(b1, a1, w[NZ - (has1 ? u1 : u0)]);
      pf[u0] = p0;
      pf[NZ - u0] = q0;
      if (has1) {
        pf[u1] = p1;
        pf[NZ - u1] = q1;
      }
    }
    __syncwarp();

    // the sparse filterbank and log10: a lane owns mels m = lane + 32 i for the
    // quad's four frames, each the sum of its run of bins in order
#pragma unroll
    for (int i = 0; i < MAX_MELS / 32; ++i) {
      const int m = lane + 32 * i;
      if (m < n_mels) {
        float a[FPG] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int c = 0; c < mn[i]; ++c) {
          const float wc = mw[i][c];
#pragma unroll
          for (int f = 0; f < FPG; ++f) a[f] = fmaf(wc, pw[f * PST + mk0[i] + c], a[f]);
        }
#pragma unroll
        for (int f = 0; f < FPG; ++f) ow[f * n_mels + m] = log10f(fmaxf(a[f], 1e-10f));
      }
    }
    __syncwarp();

    // the quad's live rows, contiguous in `out`
    const int b = q / qpr, f0 = (q % qpr) * FPG, rows = min(FPG, F - f0);
    const int n_out = rows * n_mels;
    float* dst = out + ((size_t)b * F + f0) * n_mels;
    if ((n_out & 3) == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      for (int i = lane; i < n_out / 4; i += 32)
        reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(ow)[i];
    } else {
      for (int i = lane; i < n_out; i += 32) dst[i] = ow[i];
    }
    __syncwarp();  // the quad's rows are read before the next quad's pass A rewrites them
  }
}

}  // namespace

// audio [B, T] f32 (T > 200, unpadded); tab f32 [tab_len] and itab int32
// [3, n_mels] from ops/mel.py::fft_tables; out [B, F, n_mels] f32 raw log10
// mel (F = T // 160, n_mels <= 128). All contiguous. A persistent grid: at
// most two CTAs an SM, each warp walking quads of 4 frames.
WDT_EXPORT int wdt_log_mel(const void* audio, const void* tab, const void* itab, void* out,
                           int B, int T, int F, int n_mels, int tab_len, void* stream) {
  if (B < 1 || T <= WIN / 2 || F < 1 || F > T / HOP || n_mels < 1 || n_mels > MAX_MELS ||
      tab_len < T_MELW || tab_len > TAB_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = SMEM_BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(e);
  const long long ctas = ((long long)B * ((F + FPG - 1) / FPG) + WARPS - 1) / WARPS;
  const int grid = static_cast<int>(ctas < 2LL * sms ? ctas : 2LL * sms);
  log_mel_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), static_cast<const float*>(tab),
      static_cast<const int*>(itab), static_cast<float*>(out), B, T, F, n_mels, tab_len);
  return static_cast<int>(cudaGetLastError());
}
