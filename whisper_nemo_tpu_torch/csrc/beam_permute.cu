// Kernel F: row permute of a beam-search KV cache, out of place or within
// each window in place.
//
// Replaces whisper_nemo_tpu/ops/beam_permute.py:beam_permute_cache and
// :beam_permute_cache_inplace (Pallas: one block DMA per (row, layer group)
// with the source row from a scalar-prefetched index map).
//
// Layout: k and v [L, R, ...] of any element type, taken as rows of
// `row_bytes` bytes; R = W * beam rows. Out of place, output row j of each
// layer is input row idx[j]. In place, lane j of window w becomes lane
// src[w, j] of the same window, repeats allowed.
//
// Bound: device memory. Each byte of k and v is read once and written once
// and nothing is computed. Design: out of place, one CTA per (layer, output
// row, chunk) copies vectors of up to 16 bytes from the source row, so a
// warp moves up to 512 contiguous bytes a step. In place, one CTA per
// (layer, window, chunk) loads that chunk of all `beam` lanes into shared
// memory, synchronises, and writes each lane from its source: reads and
// writes stay inside the CTA's own bytes, so CTAs never race and gather
// repeats are safe. The TPU kernel needed its in-place form to stop XLA
// copying loop-carry buffers; here it serves a caller that owns the cache.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCopyChunk = kThreads * 8;  // vectors per CTA, out of place
constexpr int kInplaceSmem = 32 * 1024;   // bytes of shared memory, in place

template <typename T>
__global__ void __launch_bounds__(kThreads)
permute_rows_kernel(const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ idx, T* __restrict__ k_out,
                    T* __restrict__ v_out, int R, int64_t row_vecs) {
  const int j = blockIdx.y, layer = blockIdx.z;
  const int64_t in = ((int64_t)layer * R + idx[j]) * row_vecs;
  const int64_t o = ((int64_t)layer * R + j) * row_vecs;
  const int64_t start = (int64_t)blockIdx.x * kCopyChunk;
  const int64_t end = start + kCopyChunk < row_vecs ? start + kCopyChunk : row_vecs;
#pragma unroll 4
  for (int64_t i = start + threadIdx.x; i < end; i += kThreads) {
    k_out[o + i] = k[in + i];
    v_out[o + i] = v[in + i];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
permute_inplace_kernel(T* k, T* v, const int* __restrict__ src, int W, int beam,
                       int64_t row_vecs, int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);  // [beam][chunk]
  const int w = blockIdx.y, layer = blockIdx.z;
  const int64_t start = (int64_t)blockIdx.x * chunk;
  const int n = (int)(row_vecs - start < chunk ? row_vecs - start : chunk);
  const int64_t base = ((int64_t)layer * W + w) * beam * row_vecs + start;
  T* tensors[2] = {k, v};
  for (int t = 0; t < 2; ++t) {
    T* x = tensors[t];
    for (int r = 0; r < beam; ++r)
      for (int i = threadIdx.x; i < n; i += kThreads)
        buf[r * chunk + i] = x[base + r * row_vecs + i];
    __syncthreads();
    for (int r = 0; r < beam; ++r) {
      const int s = src[w * beam + r];
      for (int i = threadIdx.x; i < n; i += kThreads)
        x[base + r * row_vecs + i] = buf[s * chunk + i];
    }
    __syncthreads();  // buf is reloaded for v
  }
}

template <typename T>
int launch_copy(const void* k, const void* v, const int* idx, void* k_out,
                void* v_out, int L, int R, int64_t row_bytes, cudaStream_t stream) {
  const int64_t row_vecs = row_bytes / sizeof(T);
  const dim3 grid((unsigned)((row_vecs + kCopyChunk - 1) / kCopyChunk), R, L);
  permute_rows_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), idx,
      static_cast<T*>(k_out), static_cast<T*>(v_out), R, row_vecs);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_inplace(void* k, void* v, const int* src, int L, int W, int beam,
                   int64_t row_bytes, cudaStream_t stream) {
  const int64_t row_vecs = row_bytes / sizeof(T);
  const int chunk = kInplaceSmem / (beam * (int)sizeof(T));
  const dim3 grid((unsigned)((row_vecs + chunk - 1) / chunk), W, L);
  permute_inplace_kernel<T><<<grid, kThreads, (size_t)beam * chunk * sizeof(T), stream>>>(
      static_cast<T*>(k), static_cast<T*>(v), src, W, beam, row_vecs, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// Both return a cudaError_t code (0 on success), launch on `stream`, do not
// synchronise and allocate nothing. `vec` (1, 2, 4, 8 or 16) divides
// row_bytes and every pointer's address. idx holds rows in [0, R); src
// holds lanes in [0, beam).
extern "C" int wnt_beam_permute(const void* k, const void* v, const int* idx,
                                void* k_out, void* v_out, int L, int R,
                                int64_t row_bytes, int vec, void* stream) {
  if (L < 1 || L > 65535 || R < 1 || R > 65535 || row_bytes < 1 || row_bytes % vec)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (vec) {
    case 16: return launch_copy<uint4>(k, v, idx, k_out, v_out, L, R, row_bytes, s);
    case 8: return launch_copy<uint2>(k, v, idx, k_out, v_out, L, R, row_bytes, s);
    case 4: return launch_copy<uint32_t>(k, v, idx, k_out, v_out, L, R, row_bytes, s);
    case 2: return launch_copy<uint16_t>(k, v, idx, k_out, v_out, L, R, row_bytes, s);
    case 1: return launch_copy<uint8_t>(k, v, idx, k_out, v_out, L, R, row_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int wnt_beam_permute_inplace(void* k, void* v, const int* src, int L,
                                        int W, int beam, int64_t row_bytes,
                                        int vec, void* stream) {
  if (L < 1 || L > 65535 || W < 1 || W > 65535 || beam < 1 || beam > 64 ||
      row_bytes < 1 || row_bytes % vec)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (vec) {
    case 16: return launch_inplace<uint4>(k, v, src, L, W, beam, row_bytes, s);
    case 8: return launch_inplace<uint2>(k, v, src, L, W, beam, row_bytes, s);
    case 4: return launch_inplace<uint32_t>(k, v, src, L, W, beam, row_bytes, s);
    case 2: return launch_inplace<uint16_t>(k, v, src, L, W, beam, row_bytes, s);
    case 1: return launch_inplace<uint8_t>(k, v, src, L, W, beam, row_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
