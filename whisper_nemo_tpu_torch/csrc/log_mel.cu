// Kernel C: Whisper's log-mel front end, un-normalized, for one or more
// waveforms (the sequential path's 30 s window, language detection).
//
// Replaces whisper_nemo_tpu/ops/mel.py:_log_mel_pallas (Pallas body:
// `_mel_kernel`).
//
// out[b, f, m] = log10(max(sum_k P[f, k] * fb[k, m], 1e-10)) with
// P[f, k] = (sum_j x[f, j] C[j, k])^2 + (sum_j x[f, j] S[j, k])^2, where
// frame f is padded[160 f : 160 f + 400] of the waveform reflect-padded by
// 200 at both ends, C and S [400, 201] are the Hann-windowed cosine and
// sine bases, and fb [201, n_mels] is the slaney mel bank. wave [B, T],
// out [B, T / 160, n_mels], all f32.
//
// Bound: f32 operations, 1.06 GFLOP a 30 s window (2 x 2 x 3000 x 400 x
// 201 for the DFT, 2 x 3000 x 201 x 80 for the mel bank) against 6.5 MB of
// inputs and output. The products stay f32 FMAs outside the tensor cores:
// the JAX reference on the CPU is full f32, and TF32 keeps about three
// digits.
// Design: one CTA per (32-frame tile, waveform). The tile's 5,360 samples
// are read once into shared memory straight from the waveform, the reflect
// padding done by index, so the [3000, 400] frame matrix (4.8 MB) is never
// built. The bases (643 KB) stream through shared memory 8 rows at a time;
// each thread accumulates re and im for 4 frames x 7 bins (bins strided by
// 32 across a warp) in registers. The power spectrum then takes the
// samples' place in shared memory, and each thread forms some of the tile's
// (frame, mel) outputs from it and the mel bank, which stays in L1/L2.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kNfft = 400;
constexpr int kHop = 160;
constexpr int kPad = kNfft / 2;
constexpr int kBins = kNfft / 2 + 1;            // 201
constexpr int kBinGroups = 7;                   // 7 x 32 >= 201
constexpr int kBinsPad = kBinGroups * 32;       // 224
constexpr int kThreads = 256;                   // 8 warps
constexpr int kFramesPerThread = 4;
constexpr int kTileF = (kThreads / 32) * kFramesPerThread;  // 32 frames
constexpr int kChunk = 8;                       // basis rows staged at a time
constexpr int kSpan = (kTileF - 1) * kHop + kNfft;          // 5360 samples
constexpr int kSmem = kSpan + 2 * kChunk * kBinsPad;        // 8944 floats
static_assert(kNfft % kChunk == 0, "the chunks cover the frame");
static_assert(kTileF * kBins <= kSmem, "the power spectrum fits the buffer");

__global__ void __launch_bounds__(kThreads)
log_mel_kernel(const float* __restrict__ wave,   // [B, T]
               const float* __restrict__ cos_m,  // [400, 201]
               const float* __restrict__ sin_m,  // [400, 201]
               const float* __restrict__ fb,     // [201, n_mels]
               float* __restrict__ out,          // [B, n_frames, n_mels]
               int T, int n_frames, int n_mels) {
  __shared__ float smem[kSmem];
  float* x_s = smem;                      // [kSpan] the tile's samples
  float* c_s = smem + kSpan;              // [kChunk][kBinsPad]
  float* s_s = c_s + kChunk * kBinsPad;   // [kChunk][kBinsPad]
  float* p_s = smem;                      // [kTileF][kBins], after the DFT

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kTileF;
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const float* w = wave + (int64_t)b * T;

  // padded[160 f0 + i] = wave[160 f0 + i - 200], mirrored at both ends;
  // samples of frames past n_frames are never used, and are 0 where the
  // mirror would leave the waveform
  const int64_t start = (int64_t)f0 * kHop - kPad;
  for (int i = tid; i < kSpan; i += kThreads) {
    int64_t idx = start + i;
    if (idx < 0) idx = -idx;
    else if (idx >= T) idx = 2 * (int64_t)(T - 1) - idx;
    x_s[i] = (idx >= 0 && idx < T) ? w[idx] : 0.f;
  }

  float re[kFramesPerThread][kBinGroups], im[kFramesPerThread][kBinGroups];
#pragma unroll
  for (int fi = 0; fi < kFramesPerThread; ++fi)
#pragma unroll
    for (int g = 0; g < kBinGroups; ++g) re[fi][g] = im[fi][g] = 0.f;

  const float* x_t = x_s + ty * kFramesPerThread * kHop;  // this thread's first frame
  for (int j0 = 0; j0 < kNfft; j0 += kChunk) {
    __syncthreads();  // the samples are in; the previous chunk's readers are done
    for (int i = tid; i < kChunk * kBinsPad; i += kThreads) {
      const int r = i / kBinsPad, k = i - r * kBinsPad;
      const bool ok = k < kBins;
      c_s[i] = ok ? cos_m[(j0 + r) * kBins + k] : 0.f;
      s_s[i] = ok ? sin_m[(j0 + r) * kBins + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kChunk; ++r) {
      float x[kFramesPerThread];
#pragma unroll
      for (int fi = 0; fi < kFramesPerThread; ++fi) x[fi] = x_t[fi * kHop + j0 + r];
#pragma unroll
      for (int g = 0; g < kBinGroups; ++g) {
        const float c = c_s[r * kBinsPad + g * 32 + tx];
        const float s = s_s[r * kBinsPad + g * 32 + tx];
#pragma unroll
        for (int fi = 0; fi < kFramesPerThread; ++fi) {
          re[fi][g] = fmaf(x[fi], c, re[fi][g]);
          im[fi][g] = fmaf(x[fi], s, im[fi][g]);
        }
      }
    }
  }
  __syncthreads();  // every thread is done with the samples and bases

  // re^2 + im^2, rounded as the plain version rounds it (no fused multiply-add)
#pragma unroll
  for (int fi = 0; fi < kFramesPerThread; ++fi)
#pragma unroll
    for (int g = 0; g < kBinGroups; ++g) {
      const int k = g * 32 + tx;
      if (k < kBins)
        p_s[(ty * kFramesPerThread + fi) * kBins + k] =
            __fadd_rn(__fmul_rn(re[fi][g], re[fi][g]), __fmul_rn(im[fi][g], im[fi][g]));
    }
  __syncthreads();

  // mel bank and log10, neighbouring threads on neighbouring mel bands
  const int rows = min(kTileF, n_frames - f0);
  for (int o = tid; o < rows * n_mels; o += kThreads) {
    const int f = o / n_mels, m = o - f * n_mels;
    const float* pf = p_s + f * kBins;
    float acc = 0.f;
#pragma unroll 8
    for (int k = 0; k < kBins; ++k) acc = fmaf(pf[k], __ldg(fb + k * n_mels + m), acc);
    out[((int64_t)b * n_frames + f0 + f) * n_mels + m] = log10f(fmaxf(acc, 1e-10f));
  }
}

}  // namespace

// Returns a cudaError_t code (0 on success). Launches on `stream`, does not
// synchronise and allocates nothing. T must exceed 200 (reflect padding)
// and n_frames must be T / 160.
extern "C" int wnt_log_mel(const float* wave, const float* cos_m, const float* sin_m,
                           const float* fb, float* out, int B, int T, int n_frames,
                           int n_mels, void* stream) {
  if (B < 1 || B > 65535 || T <= kPad || n_frames != T / kHop || n_frames < 1 || n_mels < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n_frames + kTileF - 1) / kTileF, B);
  log_mel_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      wave, cos_m, sin_m, fb, out, T, n_frames, n_mels);
  return (int)cudaGetLastError();
}
