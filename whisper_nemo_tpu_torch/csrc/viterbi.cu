// Kernel D: batched CTC Viterbi, the forward max-plus sweep and the
// backtrack in one launch.
//
// Replaces whisper_nemo_tpu/ops/viterbi_pallas.py:viterbi_forward_pallas
// (Pallas body `_viterbi_block_kernel`), batched over rows: the JAX
// package sends the segmented aligner's rows through a vmapped lax.scan
// and only the global aligner through the Pallas kernel; this kernel
// serves both, and also does the backtrack its callers ran as a scan.
//
// Contract (rows r of R, states s of L, steps t of T):
//   alpha_0[s]   = e[r, 0, s] for s < 2, else NEG_INF
//   alpha_t[s]   = e[r, t, s] + max(stay, prev, skip) with stay = alpha[s],
//                  prev = alpha[s-1], skip = alpha[s-2] if allow_skip[r, s];
//   bps[r, t-1, s] = 0 (stay), 1 (prev) or 2 (skip), the first maximum;
//   path[r, T-1] = L-1 if alpha[L-1] >= alpha[L-2] else L-2, then
//   path[r, t] = path[r, t+1] - bps[r, t, path[r, t+1]].
// One f32 add per state and step and an exact max: the result is bit-equal
// to the plain version and to the JAX scan.
//
// Bound: latency, not bytes. At the segmented main bucket (R = 48,
// T = 2560, L = 1025) the traffic is ~504 MB of emissions read and
// ~126 MB of backpointers written, 0.19 ms at 3.35 TB/s, but the sweep is
// T dependent steps, each a barrier and a load.
// Design: one CTA per row (48-63 rows per group: one wave on 132 SMs);
// alpha double-buffered in shared memory (2*L*4 bytes, 8 KB at L = 1025),
// or in a global scratch [R, 2, L] where that exceeds the opt-in limit
// (same code, another pointer); threads stride over the states, keep the
// skip permissions in a register bitmask, and prefetch the next step's
// emissions into registers before the barrier (two register sets used in
// turn, so the loads stay in flight across it). After the sweep, warp 0
// backtracks 32 steps per window: the path moves down at most two states a
// step, so the window's reachable backpointers (32 rows x 65 states) load
// in parallel into shared memory and one lane walks them there.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 1024;
constexpr int kPrefetch = 12;              // states per thread prefetched
constexpr int kWin = 32;                   // backtrack steps per window
constexpr int kWinStates = 2 * kWin + 1;   // states a window can reach
constexpr int kWinPitch = 68;

struct Trellis {
  const float* e;                    // [T, L] this row's state emissions
  const uint8_t* skip;               // [L]
  int8_t* bp;                        // [T-1, L]
  float* buf;                        // [2, L] alpha, double-buffered
  int T, L, tid, nt;
  uint32_t skip_bits;                // skip permission of the prefetched states

  __device__ __forceinline__ void update(const float* old, float* nxt, int8_t* bp_t,
                                         int s, float ev, bool sk) const {
    float best = old[s];
    int8_t b = 0;
    const float prev = s >= 1 ? old[s - 1] : kNegInf;
    if (prev > best) { best = prev; b = 1; }
    const float skp = sk ? old[s - 2] : kNegInf;  // sk holds only for s >= 2
    if (skp > best) { best = skp; b = 2; }
    nxt[s] = ev + best;
    bp_t[s] = b;
  }

  // Step t with this step's prefetched emissions in `cur`; loads step t+1's
  // into `pf`. The caller synchronises the block afterwards.
  __device__ __forceinline__ void step(int t, const float (&cur)[kPrefetch],
                                       float (&pf)[kPrefetch]) const {
    const float* old = buf + ((t - 1) & 1) * L;
    float* nxt = buf + (t & 1) * L;
    const float* e_t = e + (size_t)t * L;
    int8_t* bp_t = bp + (size_t)(t - 1) * L;
    const bool more = t + 1 < T;
#pragma unroll
    for (int k = 0; k < kPrefetch; ++k) {
      const int s = tid + k * nt;
      pf[k] = (more && s < L) ? e_t[L + s] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kPrefetch; ++k) {
      const int s = tid + k * nt;
      if (s < L) update(old, nxt, bp_t, s, cur[k], (skip_bits >> k) & 1u);
    }
    for (int s = tid + kPrefetch * nt; s < L; s += nt)
      update(old, nxt, bp_t, s, e_t[s], skip[s] != 0);  // s >= 2 here
  }
};

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
viterbi_kernel(const float* __restrict__ e_states,    // [R, T, L]
               const uint8_t* __restrict__ allow_skip, // [R, L]
               float* __restrict__ alpha_out,          // [R, L]
               int8_t* __restrict__ bps,               // [R, T-1, L]
               int* __restrict__ path,                 // [R, T]
               float* scratch,                         // [R, 2, L] or null
               int T, int L) {
  extern __shared__ float smem_alpha[];
  __shared__ int8_t window[kWin * kWinPitch];
  const int r = blockIdx.x;
  Trellis tr;
  tr.e = e_states + (size_t)r * T * L;
  tr.skip = allow_skip + (size_t)r * L;
  tr.bp = bps + (size_t)r * (T - 1) * L;
  tr.buf = kShared ? smem_alpha : scratch + (size_t)r * 2 * L;
  tr.T = T;
  tr.L = L;
  tr.tid = threadIdx.x;
  tr.nt = blockDim.x;

  float ea[kPrefetch], eb[kPrefetch];
  uint32_t bits = 0;
#pragma unroll
  for (int k = 0; k < kPrefetch; ++k) {
    const int s = tr.tid + k * tr.nt;
    ea[k] = 0.f;
    eb[k] = 0.f;
    if (s < L) {
      if (s >= 2 && tr.skip[s]) bits |= 1u << k;
      if (T > 1) ea[k] = tr.e[L + s];
    }
  }
  tr.skip_bits = bits;
  for (int s = tr.tid; s < L; s += tr.nt) tr.buf[s] = s < 2 ? tr.e[s] : kNegInf;
  __syncthreads();

  // two steps per iteration, the register sets in turn
  for (int t = 1; t < T; t += 2) {
    tr.step(t, ea, eb);
    __syncthreads();
    if (t + 1 < T) {
      tr.step(t + 1, eb, ea);
      __syncthreads();
    }
  }

  const float* fin = tr.buf + ((T - 1) & 1) * L;
  for (int s = tr.tid; s < L; s += tr.nt) alpha_out[(size_t)r * L + s] = fin[s];

  if (tr.tid >= 32) return;
  const int lane = tr.tid;
  int s = (L >= 2 && !(fin[L - 1] >= fin[L - 2])) ? L - 2 : L - 1;
  int* pr = path + (size_t)r * T;
  if (lane == 0) pr[T - 1] = s;
  for (int hi = T - 2; hi >= 0; hi -= kWin) {
    const int n = min(kWin, hi + 1);  // steps hi, hi-1, .., hi-n+1
    const int lo = max(0, s - 2 * n);
    const int w = s - lo + 1;
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const int8_t* row = tr.bp + (size_t)(hi - j) * L + lo;
#pragma unroll
      for (int c = lane; c < kWinStates; c += 32)
        if (c < w) window[j * kWinPitch + c] = row[c];
    }
    __syncwarp();
    if (lane == 0) {
      for (int j = 0; j < n; ++j) {
        s -= window[j * kWinPitch + (s - lo)];
        pr[hi - j] = s;
      }
    }
    s = __shfl_sync(0xffffffffu, s, 0);
    __syncwarp();
  }
}

}  // namespace

// The largest L whose two alpha buffers fit in one block's shared memory
// on `device` (opt-in limit, less the backtrack window).
extern "C" int wnt_viterbi_max_shared_states(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return 0;
  const int avail = optin - (int)(kWin * kWinPitch);
  return avail > 0 ? avail / (int)(2 * sizeof(float)) : 0;
}

// `scratch` null: alpha in shared memory (L must not exceed
// wnt_viterbi_max_shared_states); else a [R, 2, L] f32 global buffer.
extern "C" int wnt_viterbi(const void* e_states, const void* allow_skip, void* alpha,
                           void* bps, void* path, void* scratch, int R, int T, int L,
                           void* stream) {
  if (R < 1 || T < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const int threads = std::min(kThreads, (L + 31) / 32 * 32);
  const cudaStream_t st = (cudaStream_t)stream;
  const float* e = (const float*)e_states;
  const uint8_t* sk = (const uint8_t*)allow_skip;
  if (scratch == nullptr) {
    const size_t smem = 2 * (size_t)L * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(viterbi_kernel<true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    viterbi_kernel<true><<<R, threads, smem, st>>>(e, sk, (float*)alpha, (int8_t*)bps,
                                                   (int*)path, nullptr, T, L);
  } else {
    viterbi_kernel<false><<<R, threads, 0, st>>>(e, sk, (float*)alpha, (int8_t*)bps,
                                                 (int*)path, (float*)scratch, T, L);
  }
  return (int)cudaGetLastError();
}
