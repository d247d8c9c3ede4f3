// Kernel E: beam decode-step self-attention over a cache that is never
// reordered (Whisper's beam search, every layer, every step).
//
// Replaces whisper_nemo_tpu/ops/self_decode.py:self_attention_decode_ancestry
// and :self_attention_decode_ancestry_layered (Pallas body: `_kernel`).
//
// Layout: cache k, v [L, B*K, H, D, S] bf16 (positions last); each beam row
// writes its own K/V at its own row, and anc [B, K, S] int32 names the lane
// of window b whose row holds position s of query lane j's history. q is
// [B*K, H, D] bf16, mask [1 or B*K, S] f32 (>= 0 visible), out [B*K, H, D]
// bf16.
//
// Bound: device memory. A launch reads, for every row and head, the K and V
// of the visible positions (2 * 2 * D bytes per position) and does 4 * D
// FLOPs per position: 1 FLOP per byte, far below the card's ridge.
// Design: one CTA per (head, row). Its threads stride over the visible
// positions, read anc once, and dot q with K at the lane anc names, so a
// warp reads neighbouring positions of one row at neighbouring addresses.
// The logits stay in shared memory; after an f32 softmax each warp sums
// w * V over the positions for some of the D channels. The TPU kernel
// scored every query lane against all K lanes of its window and selected
// with one-hot masks, because a lane-crossing gather was what the TPU could
// not do; here the gather is the natural read, so each position is scored
// once. Positions at and past `n_visible` are not read: the caller's mask
// hides them, and a masked position's weight is exactly 0 in f32.
//
// Numerics follow the JAX function: q * D^-1/2 rounded to bf16, f32 logits,
// masked logits replaced by a finite -0.7 * 3.4e38, f32 softmax, weights
// rounded to bf16, f32 sums, the output rounded to bf16 once.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kMaskValue = -0.7f * 3.4e38f;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide reduction; every thread gets the result. `scratch` holds one
// float per warp and may be reused by the next call.
template <bool kMax>
__device__ float block_reduce(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  __syncthreads();  // the previous call's readers are done with scratch
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < n_warps ? scratch[lane] : (kMax ? -INFINITY : 0.f);
  return kMax ? warp_max(v) : warp_sum(v);
}

__global__ void __launch_bounds__(kThreads)
self_decode_kernel(const __nv_bfloat16* __restrict__ q,     // [BK, H, D]
                   const __nv_bfloat16* __restrict__ k,     // [L, BK, H, D, S]
                   const __nv_bfloat16* __restrict__ v,     // [L, BK, H, D, S]
                   const int* __restrict__ anc,             // [B, K, S]
                   const float* __restrict__ mask,          // [mask_rows, S]
                   __nv_bfloat16* __restrict__ out,         // [BK, H, D]
                   int BK, int H, int D, int S, int layer, int beam,
                   int mask_rows, int n_visible, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                                     // [D]
  float* p_s = smem + D;                                 // [n_visible]
  int* src_s = reinterpret_cast<int*>(p_s + n_visible);  // [n_visible]
  __shared__ float scratch[32];

  const int h = blockIdx.x, row = blockIdx.y;
  const int w = row / beam;
  const int64_t row_stride = (int64_t)H * D * S;  // one cache row
  // the window's lane 0 at this layer and head; lane r is r rows further
  const int64_t base =
      ((int64_t)layer * BK + (int64_t)w * beam) * row_stride + (int64_t)h * D * S;
  const __nv_bfloat16* kw = k + base;
  const __nv_bfloat16* vw = v + base;
  const int* anc_row = anc + (int64_t)row * S;  // anc[w, j] is row w*K + j
  const float* m_row = mask + (mask_rows == 1 ? 0 : (int64_t)row * S);

  for (int d = threadIdx.x; d < D; d += blockDim.x)
    q_s[d] = bf16_round(__bfloat162float(q[((int64_t)row * H + h) * D + d]) * scale);
  __syncthreads();

  // logits[s] = q . K[anc[s], :, s]
  for (int s = threadIdx.x; s < n_visible; s += blockDim.x) {
    const int src = anc_row[s];
    src_s[s] = src;
    const __nv_bfloat16* kp = kw + src * row_stride + s;
    float acc = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) acc = fmaf(q_s[d], __bfloat162float(kp[(int64_t)d * S]), acc);
    p_s[s] = m_row[s] >= 0.f ? acc : kMaskValue;
  }
  __syncthreads();

  // softmax over the visible positions, f32, weights rounded to bf16
  float mx = -INFINITY;
  for (int s = threadIdx.x; s < n_visible; s += blockDim.x) mx = fmaxf(mx, p_s[s]);
  mx = block_reduce<true>(mx, scratch);
  float sum = 0.f;
  for (int s = threadIdx.x; s < n_visible; s += blockDim.x) {
    const float e = expf(p_s[s] - mx);
    p_s[s] = e;
    sum += e;
  }
  sum = block_reduce<false>(sum, scratch);
  for (int s = threadIdx.x; s < n_visible; s += blockDim.x) p_s[s] = bf16_round(p_s[s] / sum);
  __syncthreads();

  // out[d] = sum_s w[s] * V[anc[s], d, s], one warp per channel
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int d = warp; d < D; d += n_warps) {
    const __nv_bfloat16* vd = vw + (int64_t)d * S;
    float acc = 0.f;
    for (int s = lane; s < n_visible; s += 32)
      acc = fmaf(p_s[s], __bfloat162float(vd[src_s[s] * row_stride + s]), acc);
    acc = warp_sum(acc);
    if (lane == 0) out[((int64_t)row * H + h) * D + d] = __float2bfloat16(acc);
  }
}

}  // namespace

// Returns a cudaError_t code (0 on success). Launches on `stream`, does not
// synchronise and allocates nothing. anc must hold lanes in [0, beam); the
// mask must hide every position at or past n_visible and leave at least one
// position before it visible.
extern "C" int wnt_self_decode(const void* q, const void* k, const void* v,
                               const int* anc, const float* mask, void* out,
                               int L, int BK, int H, int D, int S, int layer,
                               int beam, int mask_rows, int n_visible,
                               float scale, void* stream) {
  if (beam < 1 || BK < 1 || BK % beam || H < 1 || H > 65535 || D < 1 || S < 1 ||
      layer < 0 || layer >= L || (mask_rows != 1 && mask_rows != BK) ||
      n_visible < 1 || n_visible > S || BK > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(D + 2 * n_visible) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        self_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  self_decode_kernel<<<dim3(H, BK), kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), anc, mask,
      static_cast<__nv_bfloat16*>(out), BK, H, D, S, layer, beam, mask_rows,
      n_visible, scale);
  return (int)cudaGetLastError();
}
