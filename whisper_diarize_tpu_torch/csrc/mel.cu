// K7: the fused log-mel frontend (framing, Hann-windowed DFT, power, mel
// filterbank, log10) in one kernel.
//
// Replaces tools/pallas_mel.py::log_mel_pallas (_mel_kernel, pallas_call at
// :117). For each 400-sample frame f of the reflect-padded audio (hop 160)
//   re[k] = sum_n x[160 f + n] C[n, k],  im[k] = sum_n x[160 f + n] S[n, k]
//   out[f, m] = log10(max(sum_k (re[k]^2 + im[k]^2) fb[k, m], 1e-10))
// with C, S the Hann-windowed DFT bases [400, 201] (the TPU kernel's three
// 160-row split bases stacked, less the zero rows of the third) and fb the
// slaney filterbank [201, n_mels]. The clamp to the global max - 8 and the
// (x + 4) / 4 stay outside, as in the TPU version. Every product and sum is
// f32 on the CUDA cores: the TPU kernel was quarantined partly because its
// default f32 MXU precision drifted, so this kernel takes neither the
// tensor cores' TF32 nor any other reduced precision.
//
// What bounds it on the H100: bytes. At B 8 x 30 s, 128 mels, log-mel moves
// 28 MB of audio in and mel out (8.3 us at 3.35 TB/s). The operations it
// needs are a frame's window (400), a real 400-point FFT (2.5 N log2 N =
// 8,644), the power (603), the filterbank's 394 nonzero weights (788) and
// 128 logs: 10,563 a frame, 2.5e8 FLOP over 24,000 frames, 3.8 us at the
// 67 TFLOP/s f32 rate (data sheet). This kernel runs the dense DFT and
// filterbank products instead (24,000 x (400 x 201 x 4 + 201 x 128 x 2) =
// 8.9e9 FLOP, 134 us at that rate), so it cannot come near the bound; an
// FFT is the way there. The TPU kernel's split bases were a layout trick to
// avoid a [B, 3000, 400] gather; here a CTA stages its frames' contiguous
// audio span (64 frames: 10,480 samples) in shared memory once and reads
// every frame from it.
//
// Design: one CTA of eight warps per 64 frames of one batch row; warp w owns
// frames 8w .. 8w + 7 (its audio reads are warp-uniform broadcasts), lane j
// two DFT bins of a 64-bin chunk (bases zero-padded to 256 bins, read as
// float2 from L1 / L2). Per chunk a warp writes its frames' power to shared
// memory and folds it into its frames' mel sums (lane j: mels 4j .. 4j + 3
// of a filterbank zero-padded to [256, 128]), so neither re / im nor the
// power ever reach device memory.
#include "common.cuh"

namespace {

constexpr int HOP = 160;
constexpr int WIN = 400;
constexpr int NBP = 256;  // DFT bins (201) padded to four 64-bin chunks
constexpr int BC = 64;    // bins per chunk
constexpr int MP = 128;   // mel filters padded to 128
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int FPW = 8;                // frames per warp
constexpr int FT = WARPS * FPW;       // frames per CTA
constexpr int SPAN = (FT - 1) * HOP + WIN;  // audio samples a CTA reads

__global__ void __launch_bounds__(THREADS)
log_mel_kernel(const float* __restrict__ xpad, const float* __restrict__ cosb,
               const float* __restrict__ sinb, const float* __restrict__ fb,
               float* __restrict__ out, int Tp, int F, int n_mels) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                  // [SPAN] audio
  float* ps = smem + SPAN;           // [FT][BC] power of one chunk

  const int f0 = blockIdx.x * FT;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const float* xb = xpad + (size_t)b * Tp + (size_t)f0 * HOP;
  const int avail = Tp - f0 * HOP;
  for (int i = tid; i < SPAN; i += THREADS) xs[i] = i < avail ? xb[i] : 0.0f;
  __syncthreads();

  const float* xw = xs + warp * FPW * HOP;  // this warp's first frame
  float* pw = ps + warp * FPW * BC;
  float mel[FPW][4];
#pragma unroll
  for (int f = 0; f < FPW; ++f) mel[f][0] = mel[f][1] = mel[f][2] = mel[f][3] = 0.0f;

  for (int k0 = 0; k0 < NBP; k0 += BC) {
    float re[FPW][2], im[FPW][2];
#pragma unroll
    for (int f = 0; f < FPW; ++f) re[f][0] = re[f][1] = im[f][0] = im[f][1] = 0.0f;
    const float* cb = cosb + k0 + 2 * lane;
    const float* sb = sinb + k0 + 2 * lane;
#pragma unroll 4
    for (int n = 0; n < WIN; ++n) {
      const float2 c = __ldg(reinterpret_cast<const float2*>(cb + (size_t)n * NBP));
      const float2 s = __ldg(reinterpret_cast<const float2*>(sb + (size_t)n * NBP));
#pragma unroll
      for (int f = 0; f < FPW; ++f) {
        const float a = xw[f * HOP + n];
        re[f][0] = fmaf(a, c.x, re[f][0]);
        re[f][1] = fmaf(a, c.y, re[f][1]);
        im[f][0] = fmaf(a, s.x, im[f][0]);
        im[f][1] = fmaf(a, s.y, im[f][1]);
      }
    }
#pragma unroll
    for (int f = 0; f < FPW; ++f) {
      *reinterpret_cast<float2*>(pw + f * BC + 2 * lane) =
          make_float2(re[f][0] * re[f][0] + im[f][0] * im[f][0],
                      re[f][1] * re[f][1] + im[f][1] * im[f][1]);
    }
    __syncwarp();
    const float* fbk = fb + (size_t)k0 * MP + 4 * lane;
#pragma unroll 4
    for (int k = 0; k < BC; ++k) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(fbk + (size_t)k * MP));
#pragma unroll
      for (int f = 0; f < FPW; ++f) {
        const float p = pw[f * BC + k];
        mel[f][0] = fmaf(p, w.x, mel[f][0]);
        mel[f][1] = fmaf(p, w.y, mel[f][1]);
        mel[f][2] = fmaf(p, w.z, mel[f][2]);
        mel[f][3] = fmaf(p, w.w, mel[f][3]);
      }
    }
    __syncwarp();  // the next chunk overwrites this warp's power rows
  }

#pragma unroll
  for (int f = 0; f < FPW; ++f) {
    const int frame = f0 + warp * FPW + f;
    if (frame >= F) break;
    float* o = out + ((size_t)b * F + frame) * n_mels;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = 4 * lane + j;
      if (m < n_mels) o[m] = log10f(fmaxf(mel[f][j], 1e-10f));
    }
  }
}

}  // namespace

// xpad [B, Tp] f32: the audio after the center reflect padding (Tp = T +
// 400); cosb / sinb [400, 256] f32 windowed DFT bases and fb [256, 128] f32
// filterbank, zero-padded; out [B, F, n_mels] f32 raw log10 mel (F = T //
// 160, n_mels <= 128). All contiguous.
WDT_EXPORT int wdt_log_mel(const void* xpad, const void* cosb, const void* sinb,
                           const void* fb, void* out, int B, int Tp, int F, int n_mels,
                           void* stream) {
  const int smem = (SPAN + FT * BC) * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(
      log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((F + FT - 1) / FT, B);
  log_mel_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xpad), static_cast<const float*>(cosb),
      static_cast<const float*>(sinb), static_cast<const float*>(fb),
      static_cast<float*>(out), Tp, F, n_mels);
  return static_cast<int>(cudaGetLastError());
}
