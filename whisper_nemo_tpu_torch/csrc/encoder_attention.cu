// Kernel B: non-causal flash attention forward for the Whisper encoder.
//
// Replaces whisper_nemo_tpu/ops/attention.py:_flash_attention (the library
// Pallas TPU flash-attention kernel it calls, with T padded and the pad
// masked by segment ids).
//
// out[b, t, h, :] = softmax_s(q[b, t, h, :] . k[b, s, h, :] / sqrt(D)) v[b, s, h, :]
// on [B, T, H, D] tensors, D = 64, bf16 or f32 in and out.
//
// Bound: tensor-core FLOPs. At the encoder's T = 1500 each (b, h) does
// 4*T*T*D = 576 MFLOP over 768 KB of bf16 operands, far above the card's
// ridge; the plain version is instead bound by the [B, H, T, T] f32 score
// tensor it writes and reads (4.6 GB at B = 32).
// Design: one CTA of 4 warps per (64-query tile, head, batch row); each warp
// owns 16 query rows. The CTA walks 64-key tiles staged in shared memory;
// QK^T and PV run on mma.sync m16n8k16 (bf16 operands, f32 accumulation)
// with an online f32 softmax, so the scores never leave registers. The
// ragged last tile (T = 1500 is not a multiple of 64) is zero-filled on
// load and masked to -inf before the softmax. f32 inputs are rounded to
// bf16 for the tensor cores, as the TPU's default matmul precision does.
// Single-buffered and synchronous: TMA/wgmma pipelining is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;            // head dim
constexpr int kBM = 64;           // queries per CTA
constexpr int kBN = 64;           // keys per tile
constexpr int kThreads = 128;     // 4 warps x 16 query rows
constexpr int kLds = kD + 8;      // padded smem row (bf16 elements)

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Eight consecutive head-dim values of one row as bf16 (zeros past T).
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p, bool valid) {
  return valid ? *reinterpret_cast<const uint4*>(p) : make_uint4(0, 0, 0, 0);
}
__device__ __forceinline__ uint4 load8(const float* p, bool valid) {
  if (!valid) return make_uint4(0, 0, 0, 0);
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  return make_uint4(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w),
                    pack_bf16x2(b.x, b.y), pack_bf16x2(b.z, b.w));
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Stage rows [t0, t0 + 64) of one head into smem as [row][d] bf16, or
// transposed as [d][row] when kTranspose (for V, so PV's B fragments are
// contiguous pairs along the key axis).
template <bool kTranspose, typename T>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* s, const T* base,
                                           int t0, int n_rows, int row_stride) {
  for (int c = threadIdx.x; c < kBM * (kD / 8); c += blockDim.x) {
    const int r = c >> 3, d0 = (c & 7) * 8;
    const bool valid = t0 + r < n_rows;
    const uint4 v = load8(base + (int64_t)(t0 + r) * row_stride + d0, valid);
    if (!kTranspose) {
      *reinterpret_cast<uint4*>(s + r * kLds + d0) = v;
    } else {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i) s[(d0 + i) * kLds + r] = e[i];
    }
  }
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
encoder_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ out,
                         int n_t, int n_h, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 sq[kBM * kLds];
  __shared__ __align__(16) __nv_bfloat16 sk[kBN * kLds];
  __shared__ __align__(16) __nv_bfloat16 svt[kD * kLds];

  const int m0 = blockIdx.x * kBM, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int row_stride = n_h * kD;
  const int64_t head0 = (int64_t)b * n_t * row_stride + (int64_t)h * kD;

  stage_tile<false>(sq, q + head0, m0, n_t, row_stride);
  __syncthreads();
  uint32_t qa[kD / 16][4];
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks) {
    const __nv_bfloat16* p = sq + (warp * 16 + g) * kLds + ks * 16 + tig * 2;
    qa[ks][0] = lds32(p);
    qa[ks][1] = lds32(p + 8 * kLds);
    qa[ks][2] = lds32(p + 8);
    qa[ks][3] = lds32(p + 8 * kLds + 8);
  }

  float o[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int n0 = 0; n0 < n_t; n0 += kBN) {
    __syncthreads();  // every warp is done with the previous K/V tile
    stage_tile<false>(sk, k + head0, n0, n_t, row_stride);
    stage_tile<true>(svt, v + head0, n0, n_t, row_stride);
    __syncthreads();

    float s[kBN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kD / 16; ++ks) {
        const __nv_bfloat16* p = sk + (nt * 8 + g) * kLds + ks * 16 + tig * 2;
        const uint32_t kb[2] = {lds32(p), lds32(p + 8)};
        mma_16816(s[nt], qa[ks], kb);
      }
    }

    // scale into the exp2 domain, mask keys past T, online softmax
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + nt * 8 + tig * 2 + (j & 1);
        s[nt][j] = col < n_t ? s[nt][j] * scale_log2 : -INFINITY;
        mx[j >> 1] = fmaxf(mx[j >> 1], s[nt][j]);
      }
    }
    float alpha[2], rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);  // finite: key n0 < T is valid
      alpha[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[nt][j] = exp2f(s[nt][j] - m_run[j >> 1]);
        rowsum[j >> 1] += s[nt][j];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rowsum[r];
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }

    // O += P V: the S accumulator layout is the A-fragment layout of P
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < kD / 8; ++dt) {
        const __nv_bfloat16* p = svt + (dt * 8 + g) * kLds + kk * 16 + tig * 2;
        const uint32_t vb[2] = {lds32(p), lds32(p + 8)};
        mma_16816(o[dt], pa, vb);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = m0 + warp * 16 + g + 8 * r;
    if (t >= n_t) continue;
    const float inv = 1.f / l_run[r];
    T* dst = out + head0 + (int64_t)t * row_stride + tig * 2;
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt)
      store2(dst + dt * 8, o[dt][2 * r] * inv, o[dt][2 * r + 1] * inv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int n_t, int n_h, cudaStream_t stream) {
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)kD);
  const dim3 grid((n_t + kBM - 1) / kBM, n_h, B);
  encoder_attention_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), n_t, n_h, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = bf16, 1 = f32. Returns a cudaError_t code (0 on success).
extern "C" int wnt_encoder_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int T,
                                     int H, int D, int dtype, void* stream) {
  if (B < 1 || T < 1 || H < 1 || D != kD || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<__nv_bfloat16>(q, k, v, out, B, T, H, (cudaStream_t)stream);
  if (dtype == 1) return launch<float>(q, k, v, out, B, T, H, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
