// Kernel B: non-causal flash attention forward for the Whisper encoder and
// the wav2vec2 aligner, on Hopper's wgmma and TMA.
//
// Replaces whisper_nemo_tpu/ops/attention.py:_flash_attention (the library
// Pallas TPU flash-attention kernel it calls, with T padded and the pad
// masked by segment ids).
//
// out[b, t, h, :] = softmax_s(q[b, t, h, :] . k[b, s, h, :] / sqrt(D)) v[b, s, h, :]
// on [B, T, H, D] tensors, D a multiple of 8 up to 128: bf16 in and out, or
// f32 in and out computed to f32 accuracy (below).
//
// Bound: tensor-core FLOPs. At the encoder's T = 1500 each (b, h) does
// 4*T*T*D = 576 MFLOP over 768 KB of bf16 operands, far above the card's
// ridge. At D = 64 the softmax's exponentials take about as much SM time as
// the two products, so the products run on wgmma while other warpgroups
// of the SM do their softmax.
// Design: one CTA of four warpgroups per (192-query tile, head, batch
// row). Warp 0 is the producer: one thread issues TMA loads of the Q tile
// and of 128-key K and V tiles into a ring of kStages stages, each with a
// full/empty mbarrier pair. The three consumer warpgroups own 64 query
// rows each: S = Q K^T is four wgmma m64n128k16 with Q and K read from
// shared memory (K-major, 128-byte swizzle), the online softmax runs in
// f32 in the exp2 domain on the S accumulators, P is packed to bf16 in
// registers as the A operand of eight wgmma m64n64k16 that add P V into
// the output accumulators, with V read as it lies ([keys][D], MN-major:
// the transpose bit). The tensor maps cover the [B, T, H, D] layout as it
// lies (dims D, H, T, B; boxes of 64 x 1 x rows x 1): one D = 64 bf16 row
// is one 128-byte swizzle row, and no transposed copy exists. TMA
// zero-fills rows past T; keys past T are masked to -inf before the max,
// and the ragged last query tile stores only rows < T. setmaxnreg gives
// the consumers 160 registers and the producer warpgroup 24; one CTA
// (88 KB of shared memory) runs per SM. Three consumer warpgroups rather
// than two keep the tensor cores busy while each does its softmax; a
// third K/V stage, or overlapping a warpgroup's softmax with its next
// Q K^T, did not run faster on the H100.
//
// Head dims: the kernel is instantiated at kD = 64 (three consumer
// warpgroups) and kD = 128 (two: a consumer then holds 64 more output
// accumulators, and two warpgroups at 240 registers fit the register file
// where three do not). A tile row of kD = 128 is two 128-byte swizzle
// atoms, so each tile is two TMA boxes of 64 columns stored one after the
// other, Q K^T runs eight k16 steps, and P V is two m64n64k16 products per
// 16 keys, one per 64 output columns. A true D below the instantiation's
// (a multiple of 8, for TMA's 16-byte strides) is the tensor maps'
// innermost extent: TMA fills the columns past D with zeros, which changes
// neither Q K^T nor the first D output columns, and only those are stored.
// The softmax scale is D^-1/2 of the true D, passed in.
//
// f32 inputs (the f32 widths' encoder) are computed as split bf16
// ("bf16x3"): a first kernel splits each of q, k and v into bf16 parts
// x = hi + lo + r, hi = bf16(x), lo = bf16(x - hi), |r| <= 2^-16 |x|, into a
// scratch buffer that TMA reads through tensor maps of its own; then
// S = Qh Kh^T + Qh Kl^T + Ql Kh^T into the same f32 accumulators, the
// softmax in f32 as above, P split in registers into Ph + Pl, and
// O += Ph Vh + Ph Vl + Pl Vh (V's parts MN-major, as in the bf16 path:
// TF32 wgmma takes no MN-major operand, bf16 parts keep the transpose
// bit). The dropped lo*lo products and r are of order 2^-16 of each
// product, so the result holds to about 1e-5 of the f32 computation where
// one bf16 pass is 2e-3 off. Three times the tensor-core work: the bound
// is three bf16 passes. The split instantiation holds both parts of every
// tile, so it runs two consumer warpgroups (128 queries a CTA, 240
// registers for the split P), and at kD = 128 one K/V stage (192 KB of
// shared memory; two stages would need 320).
//
// The tensor maps are encoded on the host in the C entry point, with
// cuTensorMapEncodeTiled looked up through cudaGetDriverEntryPointByVersion,
// so the library needs no -lcuda.

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kBN = 128;        // keys per tile

// The instantiation of head dim kD, bf16 (kSplit false) or split f32 inputs:
// bf16 parts per operand, consumer warpgroups and their registers, K/V stages
template <int kD, bool kSplit>
struct Cfg {
  static constexpr int kParts = kSplit ? 2 : 1;  // hi (and lo) of each operand
  static constexpr int kHalves = kD / 64;  // 64-column boxes (128-byte rows) per tile row
  static constexpr int kConsumers = (kD == 64 && !kSplit) ? 3 : 2;  // 64 query rows each
  static constexpr int kBM = 64 * kConsumers;          // queries per CTA
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kConsumerRegs = kConsumers == 3 ? 160 : 240;
  static constexpr int kStages = (kD == 128 && kSplit) ? 1 : 2;  // K/V ring depth
  static constexpr uint32_t kTileBytes = kBN * kD * 2;  // one part of one K or V tile
};

template <int kD, bool kSplit>
struct Smem {  // 1024-byte aligned: the 128-byte swizzle's atom
  using C = Cfg<kD, kSplit>;
  // each tile as kHalves boxes of [rows][64], one after the other, per part
  __nv_bfloat16 q[C::kParts][C::kHalves][C::kBM * 64];  // kConsumers x 64 rows
  __nv_bfloat16 k[C::kStages][C::kParts][C::kHalves][kBN * 64];
  __nv_bfloat16 v[C::kStages][C::kParts][C::kHalves][kBN * 64];
  uint64_t q_full;
  uint64_t full[C::kStages];
  uint64_t empty[C::kStages];
};

// The tensor maps of q, k and v: one per part
template <int kParts>
struct Maps {
  CUtensorMap q[kParts], k[kParts], v[kParts];
};

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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
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

// One box (64 x 1 x rows x 1 elements) at (c, h, t, b) into `dst`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c, int h, int t, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
        "r"(c), "r"(h), "r"(t), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle (layout type 1).
// Offsets in bytes; the hardware takes them in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keeps the compiler from moving accesses of accumulator registers across
// the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[0:64] (+)= A[64x16] . B[128x16]^T, both bf16 K-major in shared memory
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t a, uint64_t b,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[0:32] += A[64x16] . B[16x64], A bf16 in registers, B bf16 MN-major in
// shared memory (the transpose bit)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                    uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}


__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return as_u32(__floats2bfloat162_rn(lo, hi));
}

// (a, b) as bf16 hi parts, returned, and the bf16 rounding of what they
// leave, in `lo`: a = hi.x + lo.x + r with |r| <= 2^-16 |a|
__device__ __forceinline__ uint32_t split_bf16x2(float a, float b, uint32_t& lo) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(hi);
  lo = pack_bf16x2(a - f.x, b - f.y);  // a - f.x is exact in f32
  return as_u32(hi);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <int kD, bool kSplit>
__global__ void __launch_bounds__(Cfg<kD, kSplit>::kThreads, 1)
encoder_attention_kernel(const __grid_constant__ Maps<Cfg<kD, kSplit>::kParts> maps,
                         std::conditional_t<kSplit, float, __nv_bfloat16>* __restrict__ out,
                         int n_t, int n_h, int d_true, float scale_log2) {
  using C = Cfg<kD, kSplit>;
  constexpr int kParts = C::kParts, kHalves = C::kHalves, kConsumers = C::kConsumers,
                kBM = C::kBM, kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  Smem<kD, kSplit>& sm = *reinterpret_cast<Smem<kD, kSplit>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int m0 = blockIdx.x * kBM, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (n_t + kBN - 1) / kBN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(&sm.q_full, kParts * kBM * kD * 2);
      for (int c = 0; c < kConsumers; ++c)
#pragma unroll
        for (int p = 0; p < kParts; ++p)
#pragma unroll
          for (int hf = 0; hf < kHalves; ++hf)
            tma_load(sm.q[p][hf] + c * 64 * 64, &maps.q[p], &sm.q_full, 64 * hf, h, m0 + 64 * c,
                     b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&sm.empty[s], ((j / kStages) - 1) & 1);
        mbar_expect_tx(&sm.full[s], 2 * kParts * C::kTileBytes);
#pragma unroll
        for (int p = 0; p < kParts; ++p)
#pragma unroll
          for (int hf = 0; hf < kHalves; ++hf) {
            tma_load(sm.k[s][p][hf], &maps.k[p], &sm.full[s], 64 * hf, h, j * kBN, b);
            tma_load(sm.v[s][p][hf], &maps.v[p], &sm.full[s], 64 * hf, h, j * kBN, b);
          }
      }
    }
  } else {  // consumer warpgroups: 64 query rows each
    if constexpr (C::kConsumerRegs == 160)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n");
    else
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x - 128 * wg, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tig = lane & 3;
    const int q_off = (wg - 1) * 64 * 64;  // this warpgroup's rows within each half

    float o[kHalves][32];  // 64 output columns per half
#pragma unroll
    for (int hf = 0; hf < kHalves; ++hf)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[hf][i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};  // rows g, g + 8

    mbar_wait(&sm.q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      mbar_wait(&sm.full[s], (j / kStages) & 1);

      // S = Q K^T: 64 x 128 per warpgroup, 16 head-dim channels a step
      // (split: Qh Kh^T + Qh Kl^T + Ql Kh^T)
      float sc[kBN / 2];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kD / 16; ++ks) {
        const uint64_t qh = smem_desc(sm.q[0][ks / 4] + q_off + (ks % 4) * 16, 16, 1024);
        const uint64_t kh = smem_desc(sm.k[s][0][ks / 4] + (ks % 4) * 16, 16, 1024);
        wgmma_m64n128k16_ss(sc, qh, kh, ks);
        if constexpr (kSplit) {
          wgmma_m64n128k16_ss(sc, qh, smem_desc(sm.k[s][1][ks / 4] + (ks % 4) * 16, 16, 1024), 1);
          wgmma_m64n128k16_ss(
              sc, smem_desc(sm.q[1][ks / 4] + q_off + (ks % 4) * 16, 16, 1024), kh, 1);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_operands(sc);

      // accumulator i: row g + 8 * ((i >> 1) & 1), key (i >> 2) * 8 + 2 * tig + (i & 1)
      const int n0 = j * kBN;
      if (n0 + kBN > n_t) {
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i)
          if (n0 + (i >> 2) * 8 + 2 * tig + (i & 1) >= n_t) sc[i] = -INFINITY;
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float alpha[2], neg_m[2], rowsum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // finite: key n0 < T is valid; m_run is kept in the exp2 domain
        const float m_new = fmaxf(m_run[r], mx[r] * scale_log2);
        alpha[r] = ex2(m_run[r] - m_new);
        m_run[r] = m_new;
        neg_m[r] = -m_new;
      }
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        sc[i] = ex2(fmaf(sc[i], scale_log2, neg_m[(i >> 1) & 1]));
        rowsum[(i >> 1) & 1] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rowsum[r];
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[hf][i] *= alpha[(i >> 1) & 1];

      // O += P V: the S accumulator layout is the register A layout of P
      // (split: Ph Vh + Ph Vl + Pl Vh)
      uint32_t pa[kBN / 16][4], pl[kSplit ? kBN / 16 : 1][4];
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (kSplit)
            pa[kk][e] = split_bf16x2(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1], pl[kk][e]);
          else
            pa[kk][e] = pack_bf16x2(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
        }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)  // 16 keys = 16 rows of 128 bytes a step
#pragma unroll
        for (int hf = 0; hf < kHalves; ++hf) {
          const uint64_t vh = smem_desc(sm.v[s][0][hf] + kk * 16 * 64, 1024, 1024);
          wgmma_m64n64k16_rs(o[hf], pa[kk], vh);
          if constexpr (kSplit) {
            wgmma_m64n64k16_rs(o[hf], pa[kk], smem_desc(sm.v[s][1][hf] + kk * 16 * 64, 1024, 1024));
            wgmma_m64n64k16_rs(o[hf], pl[kk], vh);
          }
        }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf) fence_operands(o[hf]);
      mbar_arrive(&sm.empty[s]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
    const int64_t row_stride = (int64_t)n_h * d_true;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = m0 + (wg - 1) * 64 + warp * 16 + g + 8 * r;
      if (t >= n_t) continue;
      const float inv = 1.f / l_run[r];
      auto* dst = out + ((int64_t)b * n_t + t) * row_stride + (int64_t)h * d_true + 2 * tig;
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf)
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8)
          if (64 * hf + n8 * 8 < d_true)  // D is a multiple of 8
            store2(dst + 64 * hf + n8 * 8, o[hf][4 * n8 + 2 * r] * inv,
                   o[hf][4 * n8 + 2 * r + 1] * inv);
    }
  }
}

// The split of f32 q, k and v (blockIdx.y picks one) into bf16 parts:
// `parts` holds [q hi, q lo, k hi, k lo, v hi, v lo], n4 groups of four
// elements each. Bound by bytes: 4 read and 4 written per element.
__global__ void __launch_bounds__(256)
split_bf16_kernel(const float4* __restrict__ q, const float4* __restrict__ k,
                  const float4* __restrict__ v, uint2* __restrict__ parts, int64_t n4) {
  const float4* src = blockIdx.y == 0 ? q : blockIdx.y == 1 ? k : v;
  uint2* hi = parts + (int64_t)blockIdx.y * 2 * n4;
  uint2* lo = hi + n4;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * blockDim.x) {
    const float4 x = src[i];
    uint2 l;
    const uint2 h = make_uint2(split_bf16x2(x.x, x.y, l.x), split_bf16x2(x.z, x.w, l.y));
    hi[i] = h;
    lo[i] = l;
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The [B, T, H, D] bf16 tensor at `base` as dims (D, H, T, B), boxes of
// 64 x 1 x rows x 1 with the 128-byte swizzle; columns past D and rows past
// T read as zeros.
bool make_map(CUtensorMap* map, const void* base, int B, int n_t, int n_h, int D, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)n_h, (cuuint64_t)n_t, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)n_h * D * 2,
                                 (cuuint64_t)n_t * n_h * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kD, bool kSplit>
int launch(const void* const* parts, void* out, int B, int n_t, int n_h, int D,
           cudaStream_t stream) {
  using C = Cfg<kD, kSplit>;
  if (encode_tiled() == nullptr) return (int)cudaErrorSymbolNotFound;
  Maps<C::kParts> maps;
  for (int p = 0; p < C::kParts; ++p)
    if (!make_map(&maps.q[p], parts[p], B, n_t, n_h, D, 64) ||
        !make_map(&maps.k[p], parts[C::kParts + p], B, n_t, n_h, D, kBN) ||
        !make_map(&maps.v[p], parts[2 * C::kParts + p], B, n_t, n_h, D, kBN))
      return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem<kD, kSplit>) + 1024;  // + the 1024-byte alignment
  const cudaError_t err = cudaFuncSetAttribute(
      encoder_attention_kernel<kD, kSplit>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  const dim3 grid((n_t + C::kBM - 1) / C::kBM, n_h, B);
  encoder_attention_kernel<kD, kSplit><<<grid, C::kThreads, smem, stream>>>(
      maps, static_cast<std::conditional_t<kSplit, float, __nv_bfloat16>*>(out), n_t, n_h, D,
      scale_log2);
  return (int)cudaGetLastError();
}

template <bool kSplit>
int launch_d(const void* const* parts, void* out, int B, int n_t, int n_h, int D,
             cudaStream_t stream) {
  return D <= 64 ? launch<64, kSplit>(parts, out, B, n_t, n_h, D, stream)
                 : launch<128, kSplit>(parts, out, B, n_t, n_h, D, stream);
}

}  // namespace

// q, k and v are [B, T, H, D], 16-byte aligned, D a multiple of 8 up to 128,
// and out the same: bf16 (dtype 0) or f32 (dtype 1). At f32, `parts` is a
// bf16 scratch buffer of 6 x B*T*H*D elements, 16-byte aligned, that the
// split fills first (unused at bf16). Returns a cudaError_t code (0 on
// success). Launches on `stream`, does not synchronise, allocates nothing.
extern "C" int wnt_encoder_attention(const void* q, const void* k, const void* v, void* out,
                                     int B, int T, int H, int D, int dtype, void* parts,
                                     void* stream) {
  if (B < 1 || T < 1 || H < 1 || D < 8 || D > 128 || D % 8 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    const void* bf16[3] = {q, k, v};
    return launch_d<false>(bf16, out, B, T, H, D, st);
  }
  if (dtype != 1 || parts == nullptr) return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)B * T * H * D, n4 = n / 4;  // D % 8 == 0
  const dim3 grid((unsigned)std::min<int64_t>((n4 + 255) / 256, 1056), 3);
  split_bf16_kernel<<<grid, 256, 0, st>>>(static_cast<const float4*>(q),
                                          static_cast<const float4*>(k),
                                          static_cast<const float4*>(v),
                                          static_cast<uint2*>(parts), n4);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(parts);
  const void* split[6];
  for (int i = 0; i < 6; ++i) split[i] = base + i * n;
  return launch_d<true>(split, out, B, T, H, D, st);
}
