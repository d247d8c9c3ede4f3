// Kernel D: batched CTC Viterbi, the forward max-plus sweep and the
// backtrack in one launch, with no block-wide barrier in the sweep.
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
// T - 1 dependent steps.
// Design: the recurrence only looks left (state s needs s-1 and s-2 of the
// previous step), so a row's states are cut into segments of 32 * kN
// states, one warp each, and no step waits for a whole block. Lane l of a
// segment holds its states s0 + l + 32 i (i < kN) in registers: the
// emissions of a step load coalesced straight into registers, kDepth
// steps ahead, and a step's backpointers leave as kN coalesced 32-byte
// rows; the states to the left of each come from the lanes below by
// shuffle (lanes 0 and 1 from lanes 30 and 31 of the register below).
// The segment's first two states take theirs from the segment to the
// left, which hands its last two states of every step through a ring in
// the receiving warp's shared memory: each value travels in one 8-byte
// word beside the step index, stored and polled with relaxed (single-copy
// atomic) accesses, so no fence makes a step wait for the sender's
// earlier global stores; the receiver returns how far it has read, so the
// sender never overwrites a slot it has not read. The segments run as a
// skewed wavefront. A row's segments are the warps of one CTA, or of the
// CTAs of a thread-block cluster when there are more than 8, the
// hand-over then crossing into the next CTA's shared memory (distributed
// shared memory). A trellis wider than a cluster's 64 segments of 1,024
// states (L > 65,536: a global alignment of more than about half an hour)
// is swept in passes of 65,536 states, one after another behind a cluster
// barrier: the last segment of a pass writes its last two states of every
// step to a global edge buffer, from which the first segment of the next
// pass reads them (two buffers a row, alternating, so a pass never writes
// the one it reads). After a cluster barrier, warp 0 of the row's first CTA
// backtracks 32 steps per window: the path moves down at most two states
// a step, so the window's reachable backpointers (32 rows x 65 states)
// load in parallel into shared memory and one lane walks them there.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxWarps = 8;      // segments per CTA
constexpr int kMaxCluster = 8;    // CTAs per row (the portable cluster)
constexpr int kRing = 32;         // hand-over slots per segment
constexpr int kWin = 32;          // backtrack steps per window
constexpr int kWinStates = 2 * kWin + 1;  // states a window can reach
constexpr int kWinPitch = 68;

// Shared memory of one warp (one segment), in bytes: the hand-over ring
// from the left neighbour, {u32 step, f32 s0-2}, {u32 step, f32 s0-1} a
// slot, then the count of steps the right neighbour has read.
constexpr int kBnd = 0;
constexpr int kRead = kRing * 16;
constexpr int kWarpBytes = kRead + 16;

// Emission steps in flight per lane (kN registers each)
template <int kN>
struct Depth {
  static constexpr int value = kN <= 8 ? 8 : (kN <= 16 ? 4 : 2);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  return remote;
}

__device__ __forceinline__ int ld_relaxed(uint32_t addr) {
  int v;
  asm volatile("ld.relaxed.cluster.shared::cta.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed_remote(uint32_t remote, int v) {
  asm volatile("st.relaxed.cluster.shared::cluster.u32 [%0], %1;\n" ::"r"(remote), "r"(v)
               : "memory");
}

// A hand-over slot: two 8-byte words, each a value (low half) and the step
// it belongs to (high half), each word single-copy atomic.
__device__ __forceinline__ void st_slot_remote(uint32_t remote, int t, float x, float y) {
  const uint64_t hi = (uint64_t)(uint32_t)t << 32;
  asm volatile("st.relaxed.cluster.shared::cluster.v2.u64 [%0], {%1, %2};\n" ::"r"(remote),
               "l"(hi | __float_as_uint(x)), "l"(hi | __float_as_uint(y))
               : "memory");
}

// Waits until the slot holds step t; returns its two values.
__device__ __forceinline__ void ld_slot(uint32_t addr, int t, float& x, float& y) {
  uint64_t a, b;
  do {
    asm volatile("ld.relaxed.cluster.shared::cta.v2.u64 {%0, %1}, [%2];\n"
                 : "=l"(a), "=l"(b) : "r"(addr) : "memory");
  } while ((int)(a >> 32) != t || (int)(b >> 32) != t);
  x = __uint_as_float((uint32_t)a);
  y = __uint_as_float((uint32_t)b);
}

template <int kN>
__global__ void __launch_bounds__(32 * kMaxWarps)
viterbi_kernel(const float* __restrict__ e_states,     // [R, T, L]
               const uint8_t* __restrict__ allow_skip,  // [R, L]
               float* __restrict__ alpha_out,           // [R, L]
               int8_t* __restrict__ bps,                // [R, T-1, L]
               int* __restrict__ path,                  // [R, T]
               float2* __restrict__ edge,               // [R, 2, T] when in passes
               int T, int L, int n_warps) {
  constexpr int kDepth = Depth<kN>::value;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), r = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_segs = (L + 32 * kN - 1) / (32 * kN);
  const int pass_segs = (int)gridDim.x * n_warps;
  const int n_pass = (n_segs + pass_segs - 1) / pass_segs;

  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int8_t window[kWin * kWinPitch];
  uint8_t* ws = smem + warp * kWarpBytes;
  const uint32_t bnd = smem_u32(ws + kBnd), read = smem_u32(ws + kRead);
  int8_t* bpr = bps + (size_t)r * (T - 1) * L;

  for (int p = 0; p < n_pass; ++p) {
    const int first = p * pass_segs, last = min(n_segs, first + pass_segs) - 1;
    const int seg = first + rank * n_warps + warp;
    const int s0 = seg * 32 * kN;
    for (int i = lane; i < 2 * kRing; i += 32)  // no step yet
      reinterpret_cast<uint64_t*>(ws + kBnd)[i] = ~0ull;
    if (lane == 0) *reinterpret_cast<int*>(ws + kRead) = -1;
    cluster.sync();  // the rings are initialised before any CTA writes another's

    const float* er = e_states + (size_t)r * T * L + s0 + lane;  // this lane's state 0
    if (seg <= last) {
      const bool left = seg > first, right = seg < last;
      // the left edge from the previous pass, the right edge for the next
      const bool edge_in = seg == first && p > 0, edge_out = seg == last && last + 1 < n_segs;
      const float2* edge_rd = edge_in ? edge + ((size_t)r * 2 + ((p + 1) & 1)) * T : nullptr;
      float2* edge_wr = edge_out ? edge + ((size_t)r * 2 + (p & 1)) * T : nullptr;
      // the right neighbour's ring and the left neighbour's read counter,
      // in the shared memory of the CTAs that hold them
      const int rseg = (right ? seg + 1 : seg) - first, lseg = (left ? seg - 1 : seg) - first;
      const uint32_t next_bnd =
          map_rank(smem_u32(smem + (rseg % n_warps) * kWarpBytes + kBnd), rseg / n_warps);
      const uint32_t prev_read =
          map_rank(smem_u32(smem + (lseg % n_warps) * kWarpBytes + kRead), lseg / n_warps);
      uint32_t bits = 0;  // bit i: state s0 + lane + 32 i may be entered by a skip
      int n_here = 0;     // this lane's states below L
      float a[kN];
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const int s = s0 + lane + 32 * i;
        if (s < L) {
          ++n_here;
          if (allow_skip[(size_t)r * L + s]) bits |= 1u << i;
        }
        a[i] = s < 2 && s < L ? er[32 * i] : kNegInf;
      }
      // hand a step's last two states (x = alpha[s0' - 2], y = alpha[s0' - 1],
      // lanes 30 and 31 of the last register) to the right neighbour, once
      // it has read the slot's previous use, or to the next pass
      auto publish = [&](int t, float y) {
        const float x = __shfl_sync(0xffffffffu, y, 30);
        if (lane == 31) {
          if (right) {
            while (ld_relaxed(read) < t - kRing) {
            }
            st_slot_remote(next_bnd + (uint32_t)(t % kRing) * 16, t, x, y);
          } else {
            edge_wr[t] = make_float2(x, y);
          }
        }
      };
      const bool hand = right || edge_out;
      if (hand && T > 1) publish(0, a[kN - 1]);

      // emissions kDepth steps ahead, in registers: ring[u] holds step t
      // when (t - 1) % kDepth == u
      float ring[kDepth][kN];
#pragma unroll
      for (int u = 0; u < kDepth; ++u)
#pragma unroll
        for (int i = 0; i < kN; ++i)
          ring[u][i] = u + 1 < T && i < n_here ? __ldg(er + (size_t)(u + 1) * L + 32 * i) : 0.f;

      for (int t0 = 1; t0 < T; t0 += kDepth) {
#pragma unroll
        for (int u = 0; u < kDepth; ++u) {
          const int t = t0 + u;
          if (t >= T) break;
          // alpha_{t-1} at s - 1 and s - 2 for each of this lane's states
          float prev1[kN], prev2[kN];
#pragma unroll
          for (int i = 0; i < kN; ++i) {
            const float up1 = __shfl_up_sync(0xffffffffu, a[i], 1);
            const float up2 = __shfl_up_sync(0xffffffffu, a[i], 2);
            // lanes 0 and 1 reach into the register below: lanes 30 and 31
            const float wrap = __shfl_sync(0xffffffffu, i > 0 ? a[i - 1] : 0.f, (lane + 30) & 31);
            const float wrap1 = __shfl_sync(0xffffffffu, i > 0 ? a[i - 1] : 0.f, 31);
            prev1[i] = lane >= 1 ? up1 : wrap1;
            prev2[i] = lane >= 2 ? up2 : wrap;
          }
          // the segment's first two states: from the left neighbour
          float x = kNegInf, y = kNegInf;  // alpha_{t-1} at s0 - 2, s0 - 1
          if (lane == 0) {
            if (left) {
              ld_slot(bnd + (uint32_t)((t - 1) % kRing) * 16, t - 1, x, y);
              st_relaxed_remote(prev_read, t - 1);
            } else if (edge_in) {
              const float2 xy = __ldcg(edge_rd + t - 1);
              x = xy.x;
              y = xy.y;
            }
          }
          x = __shfl_sync(0xffffffffu, x, 0);
          y = __shfl_sync(0xffffffffu, y, 0);
          if (lane == 0) {
            prev1[0] = y;
            prev2[0] = x;
          } else if (lane == 1) {
            prev2[0] = y;
          }
          int8_t* bp_t = bpr + (size_t)(t - 1) * L + s0 + lane;
#pragma unroll
          for (int i = 0; i < kN; ++i) {
            float best = a[i];
            int8_t b = 0;
            if (prev1[i] > best) { best = prev1[i]; b = 1; }
            if (((bits >> i) & 1u) && prev2[i] > best) { best = prev2[i]; b = 2; }
            a[i] = ring[u][i] + best;
            if (i < n_here) bp_t[32 * i] = b;
          }
#pragma unroll
          for (int i = 0; i < kN; ++i)
            ring[u][i] = t + kDepth < T && i < n_here
                             ? __ldg(er + (size_t)(t + kDepth) * L + 32 * i) : 0.f;
          if (hand && t < T - 1) publish(t, a[kN - 1]);
        }
      }
#pragma unroll
      for (int i = 0; i < kN; ++i)
        if (i < n_here) alpha_out[(size_t)r * L + s0 + lane + 32 * i] = a[i];
    }
    __syncwarp();
    // every segment of the pass is done: its alpha, backpointers and edge
    // are written, and no CTA reads another's ring any more
    cluster.sync();
  }
  if (rank != 0 || warp != 0) return;

  const float* fin = alpha_out + (size_t)r * L;
  int s = (L >= 2 && !(__ldcg(fin + L - 1) >= __ldcg(fin + L - 2))) ? L - 2 : L - 1;
  int* pr = path + (size_t)r * T;
  if (lane == 0) pr[T - 1] = s;
  for (int hi = T - 2; hi >= 0; hi -= kWin) {
    const int n = min(kWin, hi + 1);  // steps hi, hi-1, .., hi-n+1
    const int lo = max(0, s - 2 * n);
    const int w = s - lo + 1;
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const int8_t* row = bpr + (size_t)(hi - j) * L + lo;
#pragma unroll
      for (int c = lane; c < kWinStates; c += 32)
        if (c < w) window[j * kWinPitch + c] = __ldcg(row + c);
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

template <int kN>
int launch(const float* e, const uint8_t* sk, float* alpha, int8_t* bps, int* path, float2* edge,
           int R, int T, int L, cudaStream_t stream) {
  const int segs = (L + 32 * kN - 1) / (32 * kN);
  const int cluster = min(kMaxCluster, (segs + kMaxWarps - 1) / kMaxWarps);
  const int n_warps = min(kMaxWarps, (segs + cluster - 1) / cluster);
  const int smem = n_warps * kWarpBytes;
  auto kernel = viterbi_kernel<kN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, R);
  cfg.blockDim = dim3(32 * n_warps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, e, sk, alpha, bps, path, edge, T, L, n_warps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// The states one pass sweeps: 8 CTAs of 8 warps of 32 lanes, 32 states a
// lane. A wider trellis takes an edge buffer of R * 2 * T float2.
extern "C" int wnt_viterbi_pass_states() { return kMaxCluster * kMaxWarps * 32 * 32; }

// Returns a cudaError_t code (0 on success). Launches on `stream`, does not
// synchronise and allocates nothing. States per lane: the fewest of 4, 8,
// 16 and 32 that cover L with at most 64 segments (a lane's serial work in
// a step grows with its run; the hand-over of more segments only adds lag);
// 32, in passes, beyond that.
extern "C" int wnt_viterbi(const void* e_states, const void* allow_skip, void* alpha, void* bps,
                           void* path, void* edge, int R, int T, int L, void* stream) {
  if (R < 1 || R > 65535 || T < 1 || L < 1 || (L > wnt_viterbi_pass_states() && !edge))
    return (int)cudaErrorInvalidValue;
  const float* e = (const float*)e_states;
  const uint8_t* sk = (const uint8_t*)allow_skip;
  float2* ed = (float2*)edge;
  const cudaStream_t st = (cudaStream_t)stream;
  const int max_segs = kMaxCluster * kMaxWarps;
  if (L <= max_segs * 32 * 4)
    return launch<4>(e, sk, (float*)alpha, (int8_t*)bps, (int*)path, ed, R, T, L, st);
  if (L <= max_segs * 32 * 8)
    return launch<8>(e, sk, (float*)alpha, (int8_t*)bps, (int*)path, ed, R, T, L, st);
  if (L <= max_segs * 32 * 16)
    return launch<16>(e, sk, (float*)alpha, (int8_t*)bps, (int*)path, ed, R, T, L, st);
  return launch<32>(e, sk, (float*)alpha, (int8_t*)bps, (int*)path, ed, R, T, L, st);
}
