// Kernel C: Whisper's log-mel front end, un-normalized, for one or more
// waveforms (the batched path's windows, the sequential path's 30 s
// window, language detection).
//
// Replaces whisper_nemo_tpu/ops/mel.py:149 `_log_mel_pallas` (Pallas body
// `_mel_kernel`, :140), which runs the DFT as dense products with
// [400, 201] cosine and sine bases.
//
// out[b, f, m] = log10(max(sum_k P[f, k] * fb[k, m], 1e-10)), where P[f, k]
// = |X[f, k]|^2 and X[f, :] is the 400-point DFT of frame f after the
// periodic Hann window; frame f is padded[160 f : 160 f + 400] of the
// waveform reflect-padded by 200 at both ends, and fb [201, n_mels] is the
// slaney mel bank. wave [B, T], out [B, T / 160, n_mels], all f32.
//
// Bound: bytes. A 30 s window at 80 mels moves 2.88 MB (1.92 MB of
// waveform in, 0.96 MB of mel out): 0.00086 ms at 3.35 TB/s, 0.0275 ms for a
// batch of 32. Its f32 operations are about 0.032 GFLOP a window (the
// window, the FFT, the power and the bank's 391 nonzeros a frame): 0.00047
// ms at 67 TFLOP/s, on the CUDA cores (TF32 keeps about three digits, and
// so few operations need no tensor cores).
//
// Design, so that the operations stay few and the bytes are read once:
// - A real FFT, not dense products. The 400 windowed samples of a frame
//   are taken as 200 complex ones, z[n] = xw[2n] + i xw[2n+1], and go
//   through a 200-point complex FFT; the real split then gives
//   X[k] = E - i W^k O and X[200 - k] = conj(E + i W^k O), with
//   E = (Z[k] + conj Z[200-k]) / 2, O = (Z[k] - conj Z[200-k]) / 2 and
//   W = e^{-2 pi i / 400}, for k = 0..100.
// - The 200-point FFT as 8 x 25 (200 = 8 * 5 * 5), one team of 8 threads
//   a frame, 4 frames a warp. Thread n1 of a team takes z[n1 + 8 n2],
//   n2 = 0..24, and runs their 25-point DFT in registers (5 x 5: radix-5
//   butterflies, twiddles W25^{bc}, radix-5 butterflies), then twiddles
//   its output k2 by W200^{n1 k2}. One exchange through shared memory
//   gives each thread rows k2 of all 8 threads, and an 8-point DFT over
//   n1 gives Z[25 k1 + k2]. So a frame passes through shared memory twice
//   before its power spectrum (the exchange, the split), and a warp's
//   lanes stay busy; Stockham stages of radix 8, 5 and 5 with one warp a
//   frame would pass it through three times and leave 24 of 64 lanes idle
//   in each radix-5 stage.
// - The window and every twiddle come from host tables computed in
//   float64 and rounded once to f32 (ops/mel._fft_tables): W25^{bc} is
//   entry 16 b c, W200^{n1 k2} entry 2 n1 k2, W^k entry k; only the
//   radix-8 and radix-5 butterflies' own constants are literals.
// - Samples straight from the waveform: thread n1 reads its 25 sample
//   pairs as float2, a team's 8 threads on 8 neighbouring pairs, where the
//   frame lies inside the waveform, and sample by sample, mirrored, at its
//   ends; so the [n_frames, 400] frame matrix is never built, and no
//   staging copy or barrier stands before the FFT. Frames overlap (400
//   samples at hop 160): the 2-3 reads of a sample after the first come
//   from the caches, and device memory reads it once.
// - The bank by its nonzero runs: band m sums bins [lo[m], hi[m]) only,
//   with the bank's own weights (ops/mel._mel_bands), stored [width,
//   n_mels] so that a warp's lanes, on neighbouring bands, read
//   neighbouring weights; a band with none gives 0 and the clamp. A
//   thread takes one band for 4 of the tile's frames, so each weight it
//   reads serves 4 products. The clamp and log10f are fused, and the
//   outputs are written coalesced, neighbouring lanes on neighbouring
//   bands.
// - Shared memory is laid out for its banks: the exchange rows hold 9
//   float2 for 8 values and the frames' buffers 232 float2 apart, so a
//   warp's stride-9 and row reads fall in distinct banks. The power
//   spectrum then takes its frame's buffer (19 KB a CTA in all), so the
//   registers, not shared memory, bound the CTAs an SM holds.
// - A persistent grid: min(tiles, SMs x resident CTAs) CTAs walk the
//   tiles, so the tables are staged into shared memory once a CTA. One
//   30 s window is 375 tiles, so it launches 375 CTAs on 132 SMs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kNfft = 400;
constexpr int kHop = 160;
constexpr int kPad = kNfft / 2;
constexpr int kBins = kNfft / 2 + 1;            // 201
constexpr int kN = kNfft / 2;                   // 200-point complex FFT = 8 x 25
constexpr int kTeam = 8;                        // threads a frame
constexpr int kWarps = 2;
constexpr int kThreads = 32 * kWarps;
constexpr int kFrames = kThreads / kTeam;       // 8 frames a tile
constexpr int kRow = 9;                         // an exchange row: 8 values and a pad
constexpr int kBuf = 232;                       // a frame's exchange buffer (float2)
static_assert(kBuf >= 25 * kRow && kBuf % 16 == 8, "frames' rows fall in other banks");
static_assert(2 * kBuf >= kBins, "a frame's buffer holds its 201 powers");
static_assert(kFrames % 4 == 0, "the bank's tasks take 4 frames each");

// radix-5 constants: cos and sin of 2 pi / 5 and 4 pi / 5; sqrt(1/2)
constexpr float kC1 = 0.309016994374947424f, kC2 = -0.809016994374947424f;
constexpr float kS1 = 0.951056516295153572f, kS2 = 0.587785252292473129f;
constexpr float kR2 = 0.707106781186547524f;

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 mul_neg_i(float2 a) { return make_float2(a.y, -a.x); }
__device__ __forceinline__ float2 mul_i(float2 a) { return make_float2(-a.y, a.x); }

// Y[k] = sum_r u[r] (-i)^{rk}, in place
__device__ __forceinline__ void dft4(float2& u0, float2& u1, float2& u2, float2& u3) {
  const float2 s0 = cadd(u0, u2), d0 = csub(u0, u2), s1 = cadd(u1, u3), d1 = csub(u1, u3);
  u0 = cadd(s0, s1);
  u2 = csub(s0, s1);
  u1 = cadd(d0, mul_neg_i(d1));
  u3 = cadd(d0, mul_i(d1));
}

// Y[k] = sum_r v[r] W8^{rk}, W8 = e^{-2 pi i / 8}: split into even and odd outputs
__device__ __forceinline__ void dft8(float2 v[8]) {
  float2 a[4], b[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    a[r] = cadd(v[r], v[r + 4]);
    b[r] = csub(v[r], v[r + 4]);
  }
  b[1] = make_float2(kR2 * (b[1].x + b[1].y), kR2 * (b[1].y - b[1].x));   // x W8
  b[2] = mul_neg_i(b[2]);                                                 // x W8^2
  b[3] = make_float2(kR2 * (b[3].y - b[3].x), -kR2 * (b[3].x + b[3].y));  // x W8^3
  dft4(a[0], a[1], a[2], a[3]);
  dft4(b[0], b[1], b[2], b[3]);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    v[2 * m] = a[m];
    v[2 * m + 1] = b[m];
  }
}

// Y[k] = sum_r v[r] W5^{rk}, W5 = e^{-2 pi i / 5}, in place
__device__ __forceinline__ void dft5(float2 v[5]) {
  const float2 t1 = cadd(v[1], v[4]), t2 = cadd(v[2], v[3]);
  const float2 t3 = csub(v[1], v[4]), t4 = csub(v[2], v[3]);
  const float2 a1 = make_float2(v[0].x + kC1 * t1.x + kC2 * t2.x, v[0].y + kC1 * t1.y + kC2 * t2.y);
  const float2 a2 = make_float2(v[0].x + kC2 * t1.x + kC1 * t2.x, v[0].y + kC2 * t1.y + kC1 * t2.y);
  const float2 b1 = make_float2(kS1 * t3.x + kS2 * t4.x, kS1 * t3.y + kS2 * t4.y);
  const float2 b2 = make_float2(kS2 * t3.x - kS1 * t4.x, kS2 * t3.y - kS1 * t4.y);
  v[0] = cadd(v[0], cadd(t1, t2));
  v[1] = cadd(a1, mul_neg_i(b1));
  v[4] = cadd(a1, mul_i(b1));
  v[2] = cadd(a2, mul_neg_i(b2));
  v[3] = cadd(a2, mul_i(b2));
}

// padded[idx + 200] of a waveform row: mirrored at both ends, 0 where the
// mirror would leave the waveform (samples of frames past n_frames only)
__device__ __forceinline__ float sample_at(const float* w, int64_t idx, int T) {
  if (idx < 0) idx = -idx;
  else if (idx >= T) idx = 2 * (int64_t)(T - 1) - idx;
  return (idx >= 0 && idx < T) ? __ldg(w + idx) : 0.f;
}

// The power spectrum of one frame, by its team (thread t of 8): w is the
// waveform row and base the index in it of the frame's first sample
// (160 f - 200, before the mirror); win2 the window as (even, odd) pairs;
// q the frame's exchange buffer, which ends holding the 201 powers as
// floats; tw_s holds W^k (k <= 100), tw25_s W25^{bc} at [4 (b - 1) + c - 1],
// tw_out_s W200^{n1 k2} at [25 n1 + k2].
__device__ __forceinline__ void frame_power(const float* w, int64_t base, int T,
                                            const float2* win2, const float2* tw_s,
                                            const float2* tw25_s, const float2* tw_out_s,
                                            float2* q, int t) {
  // thread t = n1: u[n2] = z[n1 + 8 n2], windowed, read straight from the
  // waveform: pairs of samples where the frame lies inside it, one by one
  // (mirrored) at its ends
  float2 u[25];
  if (base >= 0 && base + kNfft <= T && ((uintptr_t)(w + base) & 7) == 0) {
    const float2* x2 = reinterpret_cast<const float2*>(w + base);
#pragma unroll
    for (int n2 = 0; n2 < 25; ++n2) {
      const float2 s = __ldg(x2 + t + 8 * n2), h = win2[t + 8 * n2];
      u[n2] = make_float2(s.x * h.x, s.y * h.y);
    }
  } else {
#pragma unroll
    for (int n2 = 0; n2 < 25; ++n2) {
      const int64_t j = base + 2 * (t + 8 * n2);
      const float2 h = win2[t + 8 * n2];
      u[n2] = make_float2(sample_at(w, j, T) * h.x, sample_at(w, j + 1, T) * h.y);
    }
  }
  // its 25-point DFT, n2 = 5a + b and k2 = c + 5d: for each b a DFT over a
  // (slot 5a + b then holds c = a), times W25^{bc}; then for each c a DFT
  // over b (slot 5c + d then holds Y[c + 5d])
#pragma unroll
  for (int b = 0; b < 5; ++b) {
    float2 v[5];
#pragma unroll
    for (int a = 0; a < 5; ++a) v[a] = u[5 * a + b];
    dft5(v);
#pragma unroll
    for (int c = 0; c < 5; ++c)
      u[5 * c + b] = (b > 0 && c > 0) ? cmul(v[c], tw25_s[4 * (b - 1) + c - 1]) : v[c];
  }
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    float2 v[5];
#pragma unroll
    for (int b = 0; b < 5; ++b) v[b] = u[5 * c + b];
    dft5(v);
#pragma unroll
    for (int d = 0; d < 5; ++d) u[5 * c + d] = v[d];
  }
  // Y[k2] x W200^{n1 k2} to row k2, column n1
#pragma unroll
  for (int c = 0; c < 5; ++c)
#pragma unroll
    for (int d = 0; d < 5; ++d) {
      const int k2 = c + 5 * d;
      q[kRow * k2 + t] = k2 > 0 ? cmul(u[5 * c + d], tw_out_s[25 * t + k2]) : u[5 * c + d];
    }
  __syncwarp();
  // rows k2 = t + 8 i: the 8-point DFT over n1 gives Z[25 k1 + k2], written
  // back to the row it read (column k1), so no other thread's
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k2 = t + kTeam * i;
    if (k2 < 25) {
      float2 v[8];
#pragma unroll
      for (int n1 = 0; n1 < 8; ++n1) v[n1] = q[kRow * k2 + n1];
      dft8(v);
#pragma unroll
      for (int k1 = 0; k1 < 8; ++k1) q[kRow * k2 + k1] = v[k1];
    }
  }
  __syncwarp();
  // the real split: bins k and 200 - k from Z[k] and Z[200 - k]; Z[k] sits
  // in row k % 25, column k / 25
  float pa[13], pb[13];
#pragma unroll
  for (int i = 0; i < 13; ++i) {
    const int k = t + kTeam * i;
    if (k <= kN / 2) {
      const int r = k == 0 ? 0 : kN - k;
      const float2 zk = q[kRow * (k % 25) + k / 25], zr = q[kRow * (r % 25) + r / 25];
      const float2 e = make_float2(0.5f * (zk.x + zr.x), 0.5f * (zk.y - zr.y));
      const float2 o = make_float2(0.5f * (zk.x - zr.x), 0.5f * (zk.y + zr.y));
      const float2 wo = cmul(tw_s[k], o);
      const float2 xa = make_float2(e.x + wo.y, e.y - wo.x);  // E - i W^k O
      const float2 xb = make_float2(e.x - wo.y, e.y + wo.x);  // E + i W^k O
      pb[i] = xb.x * xb.x + xb.y * xb.y;
      pa[i] = xa.x * xa.x + xa.y * xa.y;
    }
  }
  __syncwarp();  // every Z is read: the power spectrum takes the buffer's place
  float* p = reinterpret_cast<float*>(q);
#pragma unroll
  for (int i = 0; i < 13; ++i) {
    const int k = t + kTeam * i;
    if (k <= kN / 2) {
      p[kN - k] = pb[i];
      p[k] = pa[i];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 8)
log_mel_kernel(const float* __restrict__ wave,       // [B, T]
               const float* __restrict__ window,     // [400]
               const float2* __restrict__ twiddles,  // [400]: e^{-2 pi i k / 400}
               const int2* __restrict__ bands,       // [n_mels]: (lo, hi)
               const float* __restrict__ weights,    // [width, n_mels]
               float* __restrict__ out,              // [B, n_frames, n_mels]
               int T, int n_frames, int n_mels, int64_t n_tiles, int tiles_per_row) {
  __shared__ __align__(16) float win_s[kNfft];
  __shared__ float2 tw_s[kN / 2 + 1];
  __shared__ float2 tw25_s[16];
  __shared__ float2 tw_out_s[kTeam * 25];
  __shared__ float2 q_s[kFrames][kBuf];

  const int tid = threadIdx.x, frame = tid / kTeam, t = tid % kTeam;
  for (int i = tid; i < kNfft; i += kThreads) win_s[i] = window[i];
  for (int i = tid; i <= kN / 2; i += kThreads) tw_s[i] = twiddles[i];
  if (tid < 16) tw25_s[tid] = twiddles[16 * (tid / 4 + 1) * (tid % 4 + 1)];
  for (int i = tid; i < kTeam * 25; i += kThreads)
    tw_out_s[i] = twiddles[2 * (i / 25) * (i % 25)];
  const float2* win2 = reinterpret_cast<const float2*>(win_s);

  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = (int)(tile / tiles_per_row);
    const int f0 = (int)(tile - (int64_t)b * tiles_per_row) * kFrames;
    __syncthreads();  // the tables are in; the last tile's bank reads are done
    frame_power(wave + (int64_t)b * T, (int64_t)(f0 + frame) * kHop - kPad, T, win2, tw_s,
                tw25_s, tw_out_s, q_s[frame], t);
    __syncthreads();

    // the bank over each band's nonzero run, the clamp and log10: a task is
    // one band for 4 of the tile's frames, so each weight read serves 4
    // products, and a warp's lanes take neighbouring bands
    const int rows = min(kFrames, n_frames - f0);
    float* o_tile = out + ((int64_t)b * n_frames + f0) * n_mels;
    for (int task = tid; task < (kFrames / 4) * n_mels; task += kThreads) {
      const int g = task / n_mels, m = task - g * n_mels;
      const int2 band = __ldg(bands + m);
      const float* p0 = reinterpret_cast<const float*>(q_s[4 * g]);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = band.x; k < band.y; ++k) {
        const float wk = __ldg(weights + (int64_t)(k - band.x) * n_mels + m);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = fmaf(p0[j * 2 * kBuf + k], wk, acc[j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * g + j < rows) o_tile[(4 * g + j) * n_mels + m] = log10f(fmaxf(acc[j], 1e-10f));
    }
  }
}

}  // namespace

// Returns a cudaError_t code (0 on success). Launches on `stream`, does not
// synchronise and allocates nothing. T must exceed 200 (reflect padding),
// n_frames must be T / 160, `bands` is ops/mel._mel_bands' table for
// n_mels bands and `weights` its weights transposed, [width, n_mels].
extern "C" int wnt_log_mel(const float* wave, const float* window, const float* twiddles,
                           const int* bands, const float* weights, float* out, int B, int T,
                           int n_frames, int n_mels, void* stream) {
  if (B < 1 || B > 65535 || T <= kPad || n_frames != T / kHop || n_frames < 1 || n_mels < 1)
    return (int)cudaErrorInvalidValue;
  // the persistent grid's size: SMs x resident CTAs, once a device
  static int caps[64];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (caps[device] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, log_mel_kernel, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    caps[device] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int tiles_per_row = (n_frames + kFrames - 1) / kFrames;
  const int64_t n_tiles = (int64_t)B * tiles_per_row;
  const int64_t cap = caps[device];
  const int grid = (int)(n_tiles < cap ? n_tiles : cap);
  log_mel_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      wave, window, (const float2*)twiddles, (const int2*)bands, weights, out, T, n_frames,
      n_mels, n_tiles, tiles_per_row);
  return (int)cudaGetLastError();
}
