// Kernel A: single-query cross-attention over the int8 decode-layout
// cross-KV (Whisper's decode step, every layer, every step).
//
// Replaces whisper_nemo_tpu/ops/cross_decode.py:cross_attention_decode_layered
// (Pallas body: `kernel`, `_head_attend`, `_split_unpack_bf16`).
//
// Layout: kv [L, W, H, R, Kp] int8, R = 2D (rows 0:D are K, rows D:2D are
// V transposed, audio positions contiguous along Kp) or, for bits=4,
// R = D (rows 0:D/2 packed K, D/2:D packed V^T; a byte at row r holds
// channel r in its low nibble and channel r + D/2 in its high nibble).
//
// Bound: device memory. Every step reads each window's whole K|V^T block
// (R*Kp bytes per head; 2.4 GB per step for medium.en at 32 windows) and
// does 2 FLOPs per byte, far below the card's ~295 FLOP/byte ridge.
// Design: one CTA per (head, window) reads its block exactly once in two
// coalesced passes (4 positions per thread per load, 128 contiguous bytes
// per warp); the beam lanes of a window share the reads, the logits live
// in shared memory (beam * Kp * 4 bytes), and the layer is an offset into
// the full stack, so no per-layer copy is made.
//
// Numerics follow the TPU kernel: q (scales pre-folded, f32) and the
// softmax weights are rounded to bf16 before their products; int8 values
// are exact in any float type; sums are f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxBeam = 8;
constexpr int kThreads = 256;

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

__device__ __forceinline__ void lo_hi_nibbles(int8_t p, float& lo, float& hi) {
  const int x = p;                 // sign-extended byte
  lo = (float)((x << 28) >> 28);   // low nibble, sign-extended
  hi = (float)(x >> 4);            // high nibble (arithmetic shift)
}

template <int kBits>
__global__ void __launch_bounds__(kThreads)
cross_decode_kernel(const float* __restrict__ qs,    // [W*beam, H, D]
                    const int8_t* __restrict__ kv,   // [L, W, H, R, Kp]
                    float* __restrict__ out,         // [W*beam, H, D]
                    int W, int H, int D, int Kp, int k_len, int layer,
                    int beam) {
  extern __shared__ float smem[];
  float* q_s = smem;             // [beam][D]
  float* p_s = smem + beam * D;  // [beam][Kp] logits, then weights
  __shared__ float scratch[32];

  const int h = blockIdx.x, w = blockIdx.y;
  const int R = kBits == 8 ? 2 * D : D;
  const int8_t* blk =
      kv + ((((int64_t)layer * W + w) * H + h) * R) * (int64_t)Kp;

  for (int i = threadIdx.x; i < beam * D; i += blockDim.x) {
    const int m = i / D, d = i - m * D;
    q_s[i] = bf16_round(qs[((int64_t)(w * beam + m) * H + h) * D + d]);
  }
  __syncthreads();

  // pass 1: logits[m, t] = sum_d q[m, d] * K[d, t]
  const int n4 = Kp >> 2;
  for (int g = threadIdx.x; g < n4; g += blockDim.x) {
    float acc[kMaxBeam][4];
#pragma unroll
    for (int m = 0; m < kMaxBeam; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;
    if (kBits == 8) {
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const char4 k4 = reinterpret_cast<const char4*>(blk + (int64_t)d * Kp)[g];
        const float k0 = k4.x, k1 = k4.y, k2 = k4.z, k3 = k4.w;
#pragma unroll
        for (int m = 0; m < kMaxBeam; ++m) {
          if (m < beam) {
            const float qv = q_s[m * D + d];
            acc[m][0] += qv * k0;
            acc[m][1] += qv * k1;
            acc[m][2] += qv * k2;
            acc[m][3] += qv * k3;
          }
        }
      }
    } else {
      const int half = D >> 1;
#pragma unroll 8
      for (int d = 0; d < half; ++d) {
        const char4 p4 = reinterpret_cast<const char4*>(blk + (int64_t)d * Kp)[g];
        float lo[4], hi[4];
        lo_hi_nibbles(p4.x, lo[0], hi[0]);
        lo_hi_nibbles(p4.y, lo[1], hi[1]);
        lo_hi_nibbles(p4.z, lo[2], hi[2]);
        lo_hi_nibbles(p4.w, lo[3], hi[3]);
#pragma unroll
        for (int m = 0; m < kMaxBeam; ++m) {
          if (m < beam) {
            const float qlo = q_s[m * D + d], qhi = q_s[m * D + d + half];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[m][j] += qlo * lo[j] + qhi * hi[j];
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kMaxBeam; ++m) {
      if (m < beam) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = 4 * g + j;
          p_s[m * Kp + t] = t < k_len ? acc[m][j] : -INFINITY;
        }
      }
    }
  }
  __syncthreads();

  // softmax over positions, f32, weights rounded to bf16
  for (int m = 0; m < beam; ++m) {
    float* row = p_s + m * Kp;
    float mx = -INFINITY;
    for (int t = threadIdx.x; t < Kp; t += blockDim.x) mx = fmaxf(mx, row[t]);
    mx = block_reduce<true>(mx, scratch);
    float sum = 0.f;
    for (int t = threadIdx.x; t < Kp; t += blockDim.x) {
      const float e = expf(row[t] - mx);
      row[t] = e;
      sum += e;
    }
    sum = block_reduce<false>(sum, scratch);
    for (int t = threadIdx.x; t < Kp; t += blockDim.x) row[t] = bf16_round(row[t] / sum);
  }
  __syncthreads();

  // pass 2: out[m, d] = sum_t w[m, t] * V^T[d, t], one warp per V^T row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int v_rows = kBits == 8 ? D : D >> 1;
  const int8_t* vblk = blk + (int64_t)v_rows * Kp;
  for (int r = warp; r < v_rows; r += n_warps) {
    const char4* vrow = reinterpret_cast<const char4*>(vblk + (int64_t)r * Kp);
    float a[kMaxBeam], b[kMaxBeam];
#pragma unroll
    for (int m = 0; m < kMaxBeam; ++m) a[m] = b[m] = 0.f;
    for (int g = lane; g < n4; g += 32) {
      const char4 v4 = vrow[g];
      if (kBits == 8) {
        const float v0 = v4.x, v1 = v4.y, v2 = v4.z, v3 = v4.w;
#pragma unroll
        for (int m = 0; m < kMaxBeam; ++m) {
          if (m < beam) {
            const float4 p = reinterpret_cast<const float4*>(p_s + m * Kp)[g];
            a[m] += p.x * v0 + p.y * v1 + p.z * v2 + p.w * v3;
          }
        }
      } else {
        float lo[4], hi[4];
        lo_hi_nibbles(v4.x, lo[0], hi[0]);
        lo_hi_nibbles(v4.y, lo[1], hi[1]);
        lo_hi_nibbles(v4.z, lo[2], hi[2]);
        lo_hi_nibbles(v4.w, lo[3], hi[3]);
#pragma unroll
        for (int m = 0; m < kMaxBeam; ++m) {
          if (m < beam) {
            const float4 p = reinterpret_cast<const float4*>(p_s + m * Kp)[g];
            a[m] += p.x * lo[0] + p.y * lo[1] + p.z * lo[2] + p.w * lo[3];
            b[m] += p.x * hi[0] + p.y * hi[1] + p.z * hi[2] + p.w * hi[3];
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kMaxBeam; ++m) {
      if (m < beam) {
        const float sa = warp_sum(a[m]);
        const float sb = kBits == 8 ? 0.f : warp_sum(b[m]);
        if (lane == 0) {
          float* o = out + ((int64_t)(w * beam + m) * H + h) * D;
          o[r] = sa;
          if (kBits == 4) o[r + v_rows] = sb;
        }
      }
    }
  }
}

}  // namespace

// Returns a cudaError_t code (0 on success). Launches on `stream`, does
// not synchronise and allocates nothing. D % 4 == 0 keeps the float4
// reads of the shared-memory weights aligned.
extern "C" int wnt_cross_decode(const float* qs, const int8_t* kv, float* out,
                                int L, int W, int H, int D, int Kp, int k_len,
                                int layer, int beam, int bits, void* stream) {
  if (beam < 1 || beam > kMaxBeam || W < 1 || H < 1 || D < 4 || (D & 3) ||
      Kp < 4 || (Kp & 3) || k_len < 1 || k_len > Kp || layer < 0 ||
      layer >= L || (bits != 8 && bits != 4))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)beam * (D + Kp) * sizeof(float);
  void (*kernel)(const float*, const int8_t*, float*, int, int, int, int, int,
                 int, int) =
      bits == 8 ? cross_decode_kernel<8> : cross_decode_kernel<4>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(H, W), kThreads, smem, (cudaStream_t)stream>>>(
      qs, kv, out, W, H, D, Kp, k_len, layer, beam);
  return (int)cudaGetLastError();
}
