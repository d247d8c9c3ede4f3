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
// Design: a thread-block cluster of C CTAs per (head, window) splits the
// positions: CTA r owns `span` positions (a multiple of 32) and issues all
// its bytes at once, one bulk copy (cp.async.bulk) per K row and per V^T
// row, K and V^T on two mbarriers, so V^T is in flight while the logits
// are formed. The beam lanes of a window share the reads. Both products
// run on mma.sync m16n8k16 in fp16 with f32 sums: int8 values become
// exact fp16 in two instructions a pair (byte permute under the exponent
// of 1024, one subtraction), and the beam lanes are the 8 columns. The
// softmax stays exact across the split, because the TPU kernel rounds the
// *normalized* weights to bf16: the CTAs exchange their per-lane maxima,
// then their per-lane sums of exp(l - max), through distributed shared
// memory (each CTA pushes its value into every CTA's slot, then one
// cluster barrier), each summing the ranks' values in rank order, so
// every CTA holds the same global max and sum and forms
// bf16(exp(l - max) * (1 / sum)). The partial outputs [beam, D] go into
// rank 0's shared memory; rank 0 sums them in rank order 0..C-1 (the sum
// does not depend on which CTA finishes first) and writes. The scale fold
// is in the kernel: q (bf16 or f32, as the caller holds it) times
// k_scale * D^-1/2, rounded to bf16, and the output times v_scale. The
// layer is an offset into the full stack, so no per-layer copy is made.
//
// The fp16 operands are exact: q's bf16 values are held times a power of
// two that puts the largest in [2^14, 2^15), the bf16 weights times 2^14,
// and both factors are divided out of the f32 sums; a bf16 value is exact
// in fp16 unless it lies below 2^-28 of the largest (q) or below 2^-28
// (weights), where it rounds to a multiple of 2^-24 of that scale.
//
// Cluster size (chosen by the wrapper, ops/cross_decode.py:_cluster_size):
// about two CTAs per SM over the W * H (head, window) pairs, from 2 to 8.
// One window takes 8 (128 CTAs on 132 SMs); the batched decode's 32
// windows take 2, since there a CTA's fixed cost (its q, two cluster
// barriers, the partials' exchange) outweighs more parallel loads
// (chip_smoke.py phase 3 times 2, 4 and 8 at both shapes).
//
// Numerics follow the TPU kernel: q (scales folded, f32) and the softmax
// weights are rounded to bf16 before their products; int8 values are
// exact; sums are f32.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kD = 64;  // head dim
constexpr int kMaxBeam = 8;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kThreads = 256;
constexpr int kMaxChunks = 4;  // 32-position chunks a warp holds: span <= 1024
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// The cluster barrier in two halves: every thread of the cluster arrives,
// and later waits until all have arrived.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// `bytes` (a multiple of 16) from global `src` into shared `dst` (both
// 16-byte aligned) by the copy engine, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// Reduces v0 (beam lane 2*tig) and v1 (lane 2*tig + 1) over the g of a
// warp, then writes the warp's eight lane values to scratch[warp][0:8].
template <bool kMax>
__device__ __forceinline__ void warp_reduce_lanes(float v0, float v1, float* scratch) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    const float u0 = __shfl_xor_sync(0xffffffffu, v0, o), u1 = __shfl_xor_sync(0xffffffffu, v1, o);
    v0 = kMax ? fmaxf(v0, u0) : v0 + u0;
    v1 = kMax ? fmaxf(v1, u1) : v1 + u1;
  }
  const int lane = threadIdx.x & 31;
  if (lane < 4) {
    scratch[(threadIdx.x >> 5) * kMaxBeam + 2 * lane] = v0;
    scratch[(threadIdx.x >> 5) * kMaxBeam + 2 * lane + 1] = v1;
  }
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Bytes 0 and 2 of `t` (x XOR 0x80 each, x an int8) as two exact fp16 in
// one word (byte 0 low): under the fp16 exponent of 1024 a byte reads
// 1024 + 128 + x, and 1152 is subtracted (sel 0x4140; 0x4342 takes bytes 1
// and 3).
__device__ __forceinline__ uint32_t i8x2_f16x2(uint32_t t, uint32_t sel) {
  const uint32_t u = __byte_perm(t, 0x6464u, sel);
  uint32_t r;
  asm("sub.f16x2 %0, %1, %2;\n" : "=r"(r) : "r"(u), "r"(0x64806480u));
  return r;
}

__device__ __forceinline__ uint32_t pack_f16x2(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Nibbles of bytes i and j of a word of split-half int4 pairs as two fp16
// (the high nibbles when `hi`).
__device__ __forceinline__ uint32_t i4x2_f16x2(uint32_t w, int i, int j, bool hi) {
  const int x = (int)(w << (24 - 8 * i)) >> 24, y = (int)(w << (24 - 8 * j)) >> 24;
  return hi ? pack_f16x2((float)(x >> 4), (float)(y >> 4))
            : pack_f16x2((float)((x << 28) >> 28), (float)((y << 28) >> 28));
}

template <int kBits, typename QT>
__global__ void __launch_bounds__(kThreads)
cross_decode_kernel(const QT* __restrict__ q,            // [W*beam, H, D]
                    const int8_t* __restrict__ kv,       // [L, W, H, R, Kp]
                    const float* __restrict__ k_scale,   // [H, D]
                    const float* __restrict__ v_scale,   // [H, D]
                    float* __restrict__ out,             // [W*beam, H, D]
                    int W, int H, int Kp, int k_len, int layer, int beam, int span) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), n_ranks = (int)gridDim.x;  // grid.x = C
  const int h = blockIdx.y, w = blockIdx.z;
  constexpr int D = kD, rows = kBits == 8 ? D : D / 2;  // K rows, then as many V^T rows
  const int t0 = rank * span;
  const int n = max(0, min(span, Kp - t0));  // this CTA's positions, a multiple of 32
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  // shared rows are padded by 16 bytes (K, V^T) or 16 elements (weights):
  // the fragment reads below then hit distinct banks
  const int ld = span + 16;

  extern __shared__ __align__(16) uint8_t smem[];
  int8_t* ks = reinterpret_cast<int8_t*>(smem);  // [rows][ld]
  int8_t* vs = ks + rows * ld;                   // [rows][ld]
  __half* w_h = reinterpret_cast<__half*>(ks);   // [kMaxBeam][ld], over K once read
  __half* q_h = reinterpret_cast<__half*>(vs + rows * ld);  // [kMaxBeam][D]
  float* scratch = reinterpret_cast<float*>(q_h + kMaxBeam * D);  // [kWarps][kMaxBeam]
  float* x_max = scratch + kWarps * kMaxBeam;        // [C][kMaxBeam]: rank c's maxima
  float* x_sum = x_max + kMaxCluster * kMaxBeam;     // [C][kMaxBeam]: rank c's sums
  // bar[0]: the partials have landed (rank 0's); bar[1], bar[2]: the K and V^T slices
  uint64_t* bar = reinterpret_cast<uint64_t*>(x_sum + kMaxCluster * kMaxBeam);
  float* recv = reinterpret_cast<float*>(bar + 4);  // [C][2][beam][D], rank 0's: the partials

  if (threadIdx.x == 0) {
    mbar_init(&bar[0], n_ranks);
    mbar_init(&bar[1], 1);
    mbar_init(&bar[2], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // every CTA of the cluster must have started before another writes its
  // shared memory: arrive now, wait before the first remote store (the
  // bulk loads and the logits run in between)
  cluster_arrive_relaxed();

  // every byte of this CTA's slice in flight at once: one bulk copy per K
  // row and per V^T row (ks and vs are adjacent, so row r of the block
  // lands at ks + r * ld)
  const int8_t* blk = kv + ((((int64_t)layer * W + w) * H + h) * (2 * rows)) * (int64_t)Kp + t0;
  if (threadIdx.x == 0) {
    mbar_expect_tx(&bar[1], rows * n);
    mbar_expect_tx(&bar[2], rows * n);
  }
  if (n > 0 && threadIdx.x < 2 * rows)
    bulk_load(ks + threadIdx.x * ld, blk + (int64_t)threadIdx.x * Kp, n,
              &bar[threadIdx.x < rows ? 1 : 2]);

  // q * (k_scale * D^-1/2) in f32, rounded to bf16 (lanes past beam are 0),
  // then held in fp16 times qs, a power of two that puts the largest at
  // [2^14, 2^15): every bf16 value within 2^28 of the largest is exact
  constexpr int kPer = kMaxBeam * D / kThreads;
  float qv[kPer], qmax = 0.f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * kThreads, m = i / D, d = i - m * D;
    float v = 0.f;
    if (m < beam) {
      const float qf = to_float(q[((int64_t)(w * beam + m) * H + h) * D + d]);
      v = __bfloat162float(__float2bfloat16(__fmul_rn(qf, __fmul_rn(k_scale[h * D + d], 0.125f))));
    }
    qv[j] = v;  // D^-1/2 = 1/8 exactly
    qmax = fmaxf(qmax, fabsf(v));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) qmax = fmaxf(qmax, __shfl_xor_sync(0xffffffffu, qmax, o));
  if (lane == 0) scratch[warp] = qmax;
  __syncthreads();
  qmax = 0.f;
#pragma unroll
  for (int wi = 0; wi < kWarps; ++wi) qmax = fmaxf(qmax, scratch[wi]);
  int e;
  frexpf(qmax, &e);  // qmax = f 2^e, f in [0.5, 1); e = 0 for 0
  const float qs = ldexpf(1.f, 15 - e), inv_qs = ldexpf(1.f, e - 15);
#pragma unroll
  for (int j = 0; j < kPer; ++j) q_h[threadIdx.x + j * kThreads] = __float2half_rn(qv[j] * qs);
  mbar_wait(&bar[1], 0);
  __syncthreads();

  // logits^T[t, m] = K^T[t, d] q^T[d, m] on mma.sync m16n8k16 (beam lanes
  // are the 8 columns). A warp takes chunks of 32 positions as two row
  // tiles: a thread reads one 4-byte word (positions 4g..4g+3) of four K
  // rows, and rows g, g + 8 of tile 0 are positions 4g, 4g + 1, of tile 1
  // 4g + 2, 4g + 3. The reduction order over d is free, so a thread's four
  // k slots are the channels it read; q's fragment is read in that order.
  // lg[k][tile][i]: lane 2tig + (i & 1), position 32 (warp + kWarps k) +
  // 4g + 2 tile + (i >> 1); the logits stay in registers.
  float lg[kMaxChunks][2][4];
#pragma unroll
  for (int k = 0; k < kMaxChunks; ++k) {
    const int c0 = 32 * (warp + kWarps * k);
#pragma unroll
    for (int tile = 0; tile < 2; ++tile)
#pragma unroll
      for (int i = 0; i < 4; ++i) lg[k][tile][i] = -INFINITY;
    if (c0 >= n) continue;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int s = 0; s < D / 16; ++s) {
      uint32_t a0[4], a1[4], b0, b1;
      if (kBits == 8) {
        // kw[i] byte j: channel 16s + 4tig + i at position 4g + j
        uint32_t kw[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          kw[i] = *reinterpret_cast<const uint32_t*>(ks + (16 * s + 4 * tig + i) * ld + c0 +
                                                     4 * g) ^ 0x80808080u;
#pragma unroll
        for (int i = 0; i < 2; ++i) {  // channels (4tig, +1), then (+2, +3)
          const uint32_t t01 = __byte_perm(kw[2 * i], kw[2 * i + 1], 0x5140);
          const uint32_t t23 = __byte_perm(kw[2 * i], kw[2 * i + 1], 0x7362);
          a0[2 * i] = i8x2_f16x2(t01, 0x4140);      // position 4g
          a0[2 * i + 1] = i8x2_f16x2(t01, 0x4342);  // 4g + 1
          a1[2 * i] = i8x2_f16x2(t23, 0x4140);      // 4g + 2
          a1[2 * i + 1] = i8x2_f16x2(t23, 0x4342);  // 4g + 3
        }
        const uint2 qf = *reinterpret_cast<const uint2*>(q_h + g * D + 16 * s + 4 * tig);
        b0 = qf.x;
        b1 = qf.y;
      } else {
        // packed rows 8s + 2tig + {0, 1}: their low nibbles are channels
        // 8s + 2tig + {0, 1}, their high nibbles those + D/2
        const uint32_t kw0 = *reinterpret_cast<const uint32_t*>(ks + (8 * s + 2 * tig) * ld + c0 + 4 * g);
        const uint32_t kw1 = *reinterpret_cast<const uint32_t*>(ks + (8 * s + 2 * tig + 1) * ld + c0 + 4 * g);
        a0[0] = __byte_perm(i4x2_f16x2(kw0, 0, 0, false), i4x2_f16x2(kw1, 0, 0, false), 0x5410);
        a0[1] = __byte_perm(i4x2_f16x2(kw0, 1, 1, false), i4x2_f16x2(kw1, 1, 1, false), 0x5410);
        a0[2] = __byte_perm(i4x2_f16x2(kw0, 0, 0, true), i4x2_f16x2(kw1, 0, 0, true), 0x5410);
        a0[3] = __byte_perm(i4x2_f16x2(kw0, 1, 1, true), i4x2_f16x2(kw1, 1, 1, true), 0x5410);
        a1[0] = __byte_perm(i4x2_f16x2(kw0, 2, 2, false), i4x2_f16x2(kw1, 2, 2, false), 0x5410);
        a1[1] = __byte_perm(i4x2_f16x2(kw0, 3, 3, false), i4x2_f16x2(kw1, 3, 3, false), 0x5410);
        a1[2] = __byte_perm(i4x2_f16x2(kw0, 2, 2, true), i4x2_f16x2(kw1, 2, 2, true), 0x5410);
        a1[3] = __byte_perm(i4x2_f16x2(kw0, 3, 3, true), i4x2_f16x2(kw1, 3, 3, true), 0x5410);
        b0 = *reinterpret_cast<const uint32_t*>(q_h + g * D + 8 * s + 2 * tig);
        b1 = *reinterpret_cast<const uint32_t*>(q_h + g * D + 8 * s + 2 * tig + D / 2);
      }
      mma_16816(acc[0], a0, b0, b1);
      mma_16816(acc[1], a1, b0, b1);
    }
#pragma unroll
    for (int tile = 0; tile < 2; ++tile)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (t0 + c0 + 4 * g + 2 * tile + (i >> 1) < k_len) lg[k][tile][i] = acc[tile][i] * inv_qs;
  }

  // exchange 1: the global max of each lane. Every CTA pushes its maxima
  // into every CTA's x_max[rank]; after the cluster barrier each reads them
  // from its own shared memory in rank order.
  float v0 = -INFINITY, v1 = -INFINITY;
#pragma unroll
  for (int k = 0; k < kMaxChunks; ++k) {
    if (32 * (warp + kWarps * k) >= n) continue;
#pragma unroll
    for (int tile = 0; tile < 2; ++tile)
#pragma unroll
      for (int i = 0; i < 4; i += 2) {
        v0 = fmaxf(v0, lg[k][tile][i]);
        v1 = fmaxf(v1, lg[k][tile][i + 1]);
      }
  }
  warp_reduce_lanes<true>(v0, v1, scratch);
  __syncthreads();  // also: every warp is done reading K
  cluster_wait();
  if (threadIdx.x < beam) {
    float r = -INFINITY;
    for (int wi = 0; wi < kWarps; ++wi) r = fmaxf(r, scratch[wi * kMaxBeam + threadIdx.x]);
    for (int c = 0; c < n_ranks; ++c)
      cluster.map_shared_rank(x_max, c)[rank * kMaxBeam + threadIdx.x] = r;
  }
  cluster.sync();
  const int m0 = 2 * tig, m1 = 2 * tig + 1;
  float gmax0 = -INFINITY, gmax1 = -INFINITY;  // finite for lanes < beam: position 0 < k_len
  if (m0 < beam)
    for (int c = 0; c < n_ranks; ++c) gmax0 = fmaxf(gmax0, x_max[c * kMaxBeam + m0]);
  if (m1 < beam)
    for (int c = 0; c < n_ranks; ++c) gmax1 = fmaxf(gmax1, x_max[c * kMaxBeam + m1]);

  // exchange 2: the global sum of exp(l - max) of each lane, likewise
  v0 = v1 = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxChunks; ++k) {
    if (32 * (warp + kWarps * k) >= n) continue;
#pragma unroll
    for (int tile = 0; tile < 2; ++tile)
#pragma unroll
      for (int i = 0; i < 4; i += 2) {
        lg[k][tile][i] = m0 < beam ? expf(lg[k][tile][i] - gmax0) : 0.f;
        lg[k][tile][i + 1] = m1 < beam ? expf(lg[k][tile][i + 1] - gmax1) : 0.f;
        v0 += lg[k][tile][i];
        v1 += lg[k][tile][i + 1];
      }
  }
  warp_reduce_lanes<false>(v0, v1, scratch);
  __syncthreads();
  if (threadIdx.x < beam) {
    float r = 0.f;
    for (int wi = 0; wi < kWarps; ++wi) r += scratch[wi * kMaxBeam + threadIdx.x];
    for (int c = 0; c < n_ranks; ++c)
      cluster.map_shared_rank(x_sum, c)[rank * kMaxBeam + threadIdx.x] = r;
  }
  cluster.sync();
  float gsum0 = 0.f, gsum1 = 0.f;
  if (m0 < beam)
    for (int c = 0; c < n_ranks; ++c) gsum0 += x_sum[c * kMaxBeam + m0];
  if (m1 < beam)
    for (int c = 0; c < n_ranks; ++c) gsum1 += x_sum[c * kMaxBeam + m1];
  const float inv0 = m0 < beam ? 1.f / gsum0 : 0.f, inv1 = m1 < beam ? 1.f / gsum1 : 0.f;

  // the weights, normalized then rounded to bf16 (lanes past beam are 0),
  // held in fp16 times 2^14 (exact for every bf16 weight above 2^-28)
  // over the K slice
#pragma unroll
  for (int k = 0; k < kMaxChunks; ++k) {
    const int c0 = 32 * (warp + kWarps * k);
    if (c0 >= n) continue;
#pragma unroll
    for (int tile = 0; tile < 2; ++tile)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = 2 * tig + (i & 1), t = c0 + 4 * g + 2 * tile + (i >> 1);
        const float wb = __bfloat162float(__float2bfloat16(lg[k][tile][i] * ((i & 1) ? inv1 : inv0)));
        w_h[m * ld + t] = __float2half_rn(wb * 16384.f);
      }
  }
  mbar_wait(&bar[2], 0);
  __syncthreads();

  // out^T[d, m] = V^T[d, t] w^T[t, m] on mma.sync: warp (tile, half)
  // takes V^T rows 16 tile..16 tile + 15 over the 16-position steps
  // s = half (mod 2); a thread's k slots are positions 16s + 4tig + {0..3},
  // one word of each of its two rows. The partials go straight into rank
  // 0's recv[rank][half].
  constexpr int kTiles = rows / 16;  // 4 at bits 8, 2 at bits 4
  const int tile = warp % kTiles, half = warp / kTiles;
  if (half < 2) {
    // acc[j][hi]: every other step of the half, two chains for the tensor cores
    float acc[2][2][4] = {};
    for (int s = half, j = 0; s < (n >> 4); s += 2, j ^= 1) {
      const int tt = 16 * s + 4 * tig;
      const uint32_t x0 = *reinterpret_cast<const uint32_t*>(vs + (16 * tile + g) * ld + tt);
      const uint32_t x1 = *reinterpret_cast<const uint32_t*>(vs + (16 * tile + g + 8) * ld + tt);
      const uint2 wv = *reinterpret_cast<const uint2*>(w_h + g * ld + tt);
      uint32_t a[4];
      if (kBits == 8) {
        a[0] = i8x2_f16x2(x0 ^ 0x80808080u, 0x4140);
        a[1] = i8x2_f16x2(x1 ^ 0x80808080u, 0x4140);
        a[2] = i8x2_f16x2(x0 ^ 0x80808080u, 0x4342);
        a[3] = i8x2_f16x2(x1 ^ 0x80808080u, 0x4342);
        if (j) mma_16816(acc[1][0], a, wv.x, wv.y);
        else mma_16816(acc[0][0], a, wv.x, wv.y);
      } else {
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          a[0] = i4x2_f16x2(x0, 0, 1, hi);
          a[1] = i4x2_f16x2(x1, 0, 1, hi);
          a[2] = i4x2_f16x2(x0, 2, 3, hi);
          a[3] = i4x2_f16x2(x1, 2, 3, hi);
          if (j) mma_16816(acc[1][hi], a, wv.x, wv.y);
          else mma_16816(acc[0][hi], a, wv.x, wv.y);
        }
      }
    }
    // acc[.][hi][i]: channel 16 tile + g + 8 (i >> 1) (+ D/2 for hi), lane 2tig + (i & 1)
    float* dst = cluster.map_shared_rank(recv, 0) + (rank * 2 + half) * beam * D;
#pragma unroll
    for (int hi = 0; hi < (kBits == 8 ? 1 : 2); ++hi)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = 2 * tig + (i & 1), d = 16 * tile + g + 8 * (i >> 1) + hi * (D / 2);
        if (m < beam) dst[m * D + d] = acc[0][hi][i] + acc[1][hi][i];
      }
  }

  // exchange 3: each CTA's partials are in rank 0's recv; it arrives on
  // rank 0's barrier and leaves. Rank 0 sums them in rank order 0..C-1
  // (each rank's two halves in order), undoes the weights' 2^14, times
  // v_scale, and writes.
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(&bar[0])), "r"(0));
    asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(remote) : "memory");
  }
  if (rank != 0) return;
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(&bar[0])) : "memory");
  }
  for (int i = threadIdx.x; i < beam * D; i += kThreads) {
    float acc = 0.f;
    for (int c = 0; c < 2 * n_ranks; ++c) acc += recv[c * beam * D + i];
    const int m = i / D, d = i - m * D;
    out[((int64_t)(w * beam + m) * H + h) * D + d] = acc * (1.f / 16384.f) * v_scale[h * D + d];
  }
}

template <int kBits, typename QT>
int launch(const void* q, const int8_t* kv, const float* k_scale, const float* v_scale,
           float* out, int W, int H, int Kp, int k_len, int layer, int beam, int cluster,
           cudaStream_t stream) {
  const int span = ((Kp + cluster - 1) / cluster + 31) / 32 * 32;
  if (span > 32 * kWarps * kMaxChunks) return (int)cudaErrorInvalidValue;
  const int rows = kBits == 8 ? kD : kD / 2;
  const size_t smem = (size_t)2 * rows * (span + 16) + sizeof(__half) * kMaxBeam * kD +
                      sizeof(float) * (kWarps + 2 * kMaxCluster) * kMaxBeam + 4 * sizeof(uint64_t) +
                      sizeof(float) * (size_t)cluster * 2 * beam * kD;
  auto kernel = cross_decode_kernel<kBits, QT>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, H, W);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const QT*>(q), kv, k_scale,
                                             v_scale, out, W, H, Kp, k_len, layer, beam, span);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// q [W*beam, H, 64] bf16 (q_dtype 0) or f32 (1); kv [L, W, H, R, Kp] int8,
// 16-byte aligned, Kp a multiple of 32; k_scale and v_scale [H, 64] f32,
// this layer's; out [W*beam, H, 64] f32. `cluster` CTAs (1-8) split each
// (head, window). Returns a cudaError_t code (0 on success). Launches on
// `stream`, does not synchronise and allocates nothing.
extern "C" int wnt_cross_decode(const void* q, const int8_t* kv, const float* k_scale,
                                const float* v_scale, float* out, int L, int W, int H, int D,
                                int Kp, int k_len, int layer, int beam, int bits, int q_dtype,
                                int cluster, void* stream) {
  if (beam < 1 || beam > kMaxBeam || W < 1 || W > 65535 || H < 1 || H > 65535 || D != kD ||
      Kp < 32 || (Kp & 31) || k_len < 1 || k_len > Kp || layer < 0 || layer >= L ||
      (bits != 8 && bits != 4) || (q_dtype != 0 && q_dtype != 1) || cluster < 1 ||
      cluster > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bits == 8) {
    return q_dtype == 0 ? launch<8, __nv_bfloat16>(q, kv, k_scale, v_scale, out, W, H, Kp, k_len,
                                                   layer, beam, cluster, s)
                        : launch<8, float>(q, kv, k_scale, v_scale, out, W, H, Kp, k_len, layer,
                                           beam, cluster, s);
  }
  return q_dtype == 0 ? launch<4, __nv_bfloat16>(q, kv, k_scale, v_scale, out, W, H, Kp, k_len,
                                                 layer, beam, cluster, s)
                      : launch<4, float>(q, kv, k_scale, v_scale, out, W, H, Kp, k_len, layer,
                                         beam, cluster, s);
}
