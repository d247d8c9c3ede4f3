// Kernel E: beam decode-step self-attention over a cache that is never
// reordered (Whisper's beam search, every layer, every step), for bf16 and
// f32 caches.
//
// Replaces whisper_nemo_tpu/ops/self_decode.py:self_attention_decode_ancestry
// and :self_attention_decode_ancestry_layered (Pallas body: `_kernel`).
//
// Layout: cache k, v [L, B*K, H, D, S] (positions last); each beam row
// writes its own K/V at its own row, and anc [B, K, S] int32 names the lane
// of window b whose row holds position s of query lane j's history. q is
// [B*K, H, D], mask [1 or B*K, S] f32 (>= 0 visible), out [B*K, H, D]; q,
// the cache and out share one element type (bf16 or f32).
//
// Bound: device memory. A launch reads, for every row and head, the K and V
// of the visible positions (2 * 2 * D bytes per position in bf16, twice that
// in f32) and does 4 * D FLOPs per position: 1 FLOP per byte or less.
// Design: the K lanes of a window read the same K rows of the cache, so the
// work unit is the window, not the row. A thread-block cluster of C CTAs
// serves one (window, head) and splits the visible positions into whole
// tiles of TP positions. One 5-D TMA copy brings a tile of all K lanes
// ([K][D][TP], each (lane, d) row contiguous in positions) into a two-stage
// shared-memory ring, so every visible byte of the window's K and V is read
// once, in wide contiguous requests; the tensor map's position extent is
// n_visible, so positions at and past it are zero-filled by the copy engine
// and never read. The K tiles come first: every query lane's logit at every
// position is the dot of its q with the tile row at the lane anc names (a
// gather from shared memory), kept in shared memory. The softmax is exact
// over all positions before the weights are rounded: per-lane maxima, then
// sums, are pushed into every CTA's shared memory and read in rank order
// after a cluster barrier. The V tiles, already loading during the softmax,
// then give every (lane, channel) its weighted sum in parallel, one thread
// each, the positions walked from a lane-dependent start so that the warp's
// reads hit distinct banks; rank 0 adds the ranks' partial outputs in rank
// order. The TPU kernel scored every lane against all K lanes and selected
// with one-hot masks, because a lane-crossing gather was what the TPU could
// not do; here the gather is the natural read.
//
// Numerics follow the JAX function: q * D^-1/2 rounded to the cache's type,
// f32 logits, masked logits replaced by a finite -0.7 * 3.4e38, f32 softmax,
// weights rounded to the cache's type, f32 sums, the output rounded once.
// In f32 nothing is rounded but the f32 arithmetic itself.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxBeam = 8;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kMaxD = 128;
constexpr int kStages = 2;           // ring depth: one tile loads while one is read
constexpr int kStageBudget = 20480;  // bytes of one ring stage at most: ~4 CTAs an SM
constexpr float kMaskValue = -0.7f * 3.4e38f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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

// One box (TP x D x 1 x K x 1 elements) at (p, 0, h, row, layer) into `dst`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int p,
                                         int h, int row, int layer) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
        "r"(p), "r"(0), "r"(h), "r"(row), "r"(layer)
      : "memory");
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

// Byte offsets of the dynamic shared memory, the same on the host and the
// device. The ring's stages are 1024-byte aligned (TMA destinations).
struct Layout {
  int stage, lg, anc, q, x_max, x_sum, recv, bar, total;
  __host__ __device__ Layout(int beam, int D, int esize, int tp, int span, int cluster) {
    stage = (beam * D * tp * esize + 1023) / 1024 * 1024;
    lg = kStages * stage;                         // f32 [beam][span]: logits, then weights
    anc = lg + beam * span * 4;                   // u8 [beam][span]: source lanes
    q = (anc + beam * span + 15) / 16 * 16;       // f32 [beam][D]: q * D^-1/2, rounded
    x_max = q + beam * D * 4;                     // f32 [C][kMaxBeam]: rank c's maxima
    x_sum = x_max + kMaxCluster * kMaxBeam * 4;   // f32 [C][kMaxBeam]: rank c's sums
    recv = x_sum + kMaxCluster * kMaxBeam * 4;    // f32 [C][beam][D], rank 0's: the partials
    bar = recv + (cluster > 1 ? cluster * beam * D * 4 : 0);
    total = bar + kStages * 8;
  }
};

// 64 threads a query lane: at D = 64 one (lane, channel) item each for the
// weighted sum of V, and for the logits two threads a (lane, position) of a
// 32-position tile, each summing half the channels. The kernel is bound by
// the latency of its loads, so small CTAs (about four share an SM) keep
// more tiles in flight.
template <typename T, int kBeam>
__global__ void __launch_bounds__(64 * kBeam)
self_decode_kernel(const __grid_constant__ CUtensorMap k_map,  // [L, BK, H, D, n_visible]
                   const __grid_constant__ CUtensorMap v_map,
                   const T* __restrict__ q,          // [BK, H, D]
                   const int* __restrict__ anc,      // [B, K, S]
                   const float* __restrict__ mask,   // [mask_rows, S]
                   T* __restrict__ out,              // [BK, H, D]
                   int H, int D, int S, int layer, int mask_rows, int n_visible, int tp,
                   int tiles_per_rank, float scale) {
  constexpr int kThreads = 64 * kBeam;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), n_ranks = (int)gridDim.x;  // grid.x = C
  const int h = blockIdx.y, w = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int span = tiles_per_rank * tp;  // this CTA's positions, padded to whole tiles
  const int p_begin = rank * span;
  const int n_tiles = max(0, min(tiles_per_rank, (n_visible - p_begin + tp - 1) / tp));
  const int n_pos = max(0, min(span, n_visible - p_begin));  // visible positions here
  const Layout lay(kBeam, D, (int)sizeof(T), tp, span, n_ranks);

  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                           ~uintptr_t(1023));
  float* lg = reinterpret_cast<float*>(sm + lay.lg);
  uint8_t* anc_s = sm + lay.anc;
  float* q_s = reinterpret_cast<float*>(sm + lay.q);
  float* x_max = reinterpret_cast<float*>(sm + lay.x_max);
  float* x_sum = reinterpret_cast<float*>(sm + lay.x_sum);
  float* recv = reinterpret_cast<float*>(sm + lay.recv);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + lay.bar);
  const uint32_t tile_bytes = (uint32_t)(kBeam * D * tp * sizeof(T));
  const int n_loads = 2 * n_tiles;  // the K tiles, then the V tiles

  // load k of the sequence: the K tile k or the V tile k - n_tiles, into
  // stage k % kStages
  auto issue = [&](int k) {
    const bool is_v = k >= n_tiles;
    const int ti = is_v ? k - n_tiles : k, st = k % kStages;
    mbar_expect_tx(&full[st], tile_bytes);
    tma_load(sm + st * lay.stage, is_v ? &v_map : &k_map, &full[st], p_begin + ti * tp, h,
             w * kBeam, layer);
  };
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(&full[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < min(kStages, n_loads); ++k) issue(k);
  }
  // every CTA of the cluster must have started before another writes its
  // shared memory: arrive now, wait before the first remote store
  if (n_ranks > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const T zero_t{};
  for (int i = tid; i < kBeam * D; i += kThreads) {
    const int j = i / D, d = i - j * D;
    q_s[i] = round_to(to_float(q[((int64_t)(w * kBeam + j) * H + h) * D + d]) * scale, zero_t);
  }
  for (int i = tid; i < kBeam * span; i += kThreads) {
    const int j = i / span, lp = i - j * span;
    anc_s[i] = lp < n_pos ? (uint8_t)anc[(int64_t)(w * kBeam + j) * S + p_begin + lp] : 0;
  }
  __syncthreads();

  // logits: item (lane j, position p of the tile), dotted with the tile row
  // of the lane anc names, by two neighbouring threads (even and odd
  // channels) whose halves meet by one shuffle
  const int n_items = kBeam * tp * 2;
  for (int k = 0; k < n_tiles; ++k) {
    mbar_wait(&full[k % kStages], (k / kStages) & 1);
    const T* ks = reinterpret_cast<const T*>(sm + (k % kStages) * lay.stage);
    for (int base = 0; base < n_items; base += kThreads) {  // warp-uniform trips
      const int i = base + tid, half = i & 1, pair = i >> 1;
      const int j = pair / tp, p = pair - j * tp, lp = k * tp + p;
      const bool valid = i < n_items && lp < n_pos;
      float a0 = 0.f, a1 = 0.f;
      if (valid) {
        const T* kp = ks + (int)anc_s[j * span + lp] * D * tp + p;
        const float* qj = q_s + j * D;
        int d = half;
        for (; d + 2 < D; d += 4) {
          a0 = fmaf(qj[d], to_float(kp[d * tp]), a0);
          a1 = fmaf(qj[d + 2], to_float(kp[(d + 2) * tp]), a1);
        }
        if (d < D) a0 = fmaf(qj[d], to_float(kp[d * tp]), a0);
      }
      float acc = a0 + a1;
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (valid && half == 0) {
        const int mrow = mask_rows == 1 ? 0 : w * kBeam + j;
        lg[j * span + lp] = mask[(int64_t)mrow * S + p_begin + lp] >= 0.f ? acc : kMaskValue;
      }
    }
    __syncthreads();  // the stage is free
    if (tid == 0 && k + kStages < n_loads) issue(k + kStages);
  }

  // softmax, exact over the cluster's positions: warp j holds lane j's row
  float mx = -INFINITY;
  if (warp < kBeam)
    for (int lp = lane; lp < n_pos; lp += 32) mx = fmaxf(mx, lg[warp * span + lp]);
  mx = warp_max(mx);
  if (n_ranks > 1) {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    if (warp < kBeam && lane < n_ranks)
      cluster.map_shared_rank(x_max, lane)[rank * kMaxBeam + warp] = mx;
    cluster.sync();
  }
  float gmax = mx;
  if (n_ranks > 1) {
    gmax = -INFINITY;
    for (int c = 0; c < n_ranks; ++c) gmax = fmaxf(gmax, x_max[c * kMaxBeam + min(warp, kMaxBeam - 1)]);
  }
  float sum = 0.f;
  if (warp < kBeam)
    for (int lp = lane; lp < n_pos; lp += 32) {
      const float e = expf(lg[warp * span + lp] - gmax);
      lg[warp * span + lp] = e;
      sum += e;
    }
  sum = warp_sum(sum);
  if (n_ranks > 1) {
    if (warp < kBeam && lane < n_ranks)
      cluster.map_shared_rank(x_sum, lane)[rank * kMaxBeam + warp] = sum;
    cluster.sync();
    sum = 0.f;
    for (int c = 0; c < n_ranks; ++c) sum += x_sum[c * kMaxBeam + min(warp, kMaxBeam - 1)];
  }
  if (warp < kBeam)
    for (int lp = lane; lp < span; lp += 32)
      lg[warp * span + lp] = lp < n_pos ? round_to(lg[warp * span + lp] / sum, zero_t) : 0.f;
  __syncthreads();

  // weighted sum of V: one (lane j, channel d) item a thread, the tile's
  // positions walked from a lane-dependent start (distinct banks)
  constexpr int kItems = (kBeam * kMaxD + kThreads - 1) / kThreads;
  float acc[kItems];
#pragma unroll
  for (int m = 0; m < kItems; ++m) acc[m] = 0.f;
  const int rot = (lane * (sizeof(T) == 2 ? 2 : 1)) % tp;
  for (int k = n_tiles; k < n_loads; ++k) {
    mbar_wait(&full[k % kStages], (k / kStages) & 1);
    const T* vs = reinterpret_cast<const T*>(sm + (k % kStages) * lay.stage);
    const int base = (k - n_tiles) * tp;
#pragma unroll
    for (int m = 0; m < kItems; ++m) {
      const int i = tid + m * kThreads;
      if (i >= kBeam * D) break;
      const int j = i / D, d = i - j * D;
      const float* wj = lg + j * span + base;
      const uint8_t* aj = anc_s + j * span + base;
      const T* vd = vs + d * tp;
      const int stride = D * tp;  // one lane's rows in the tile
      // four independent sums over the tile's positions (tp is a multiple of 8)
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      for (int c = 0; c < tp; c += 4) {
        int p0 = rot + c, p1 = p0 + 1, p2 = p0 + 2, p3 = p0 + 3;
        p0 -= p0 >= tp ? tp : 0;
        p1 -= p1 >= tp ? tp : 0;
        p2 -= p2 >= tp ? tp : 0;
        p3 -= p3 >= tp ? tp : 0;
        a0 = fmaf(wj[p0], to_float(vd[(int)aj[p0] * stride + p0]), a0);
        a1 = fmaf(wj[p1], to_float(vd[(int)aj[p1] * stride + p1]), a1);
        a2 = fmaf(wj[p2], to_float(vd[(int)aj[p2] * stride + p2]), a2);
        a3 = fmaf(wj[p3], to_float(vd[(int)aj[p3] * stride + p3]), a3);
      }
      acc[m] += (a0 + a1) + (a2 + a3);
    }
    __syncthreads();
    if (tid == 0 && k + kStages < n_loads) issue(k + kStages);
  }

  if (n_ranks == 1) {
#pragma unroll
    for (int m = 0; m < kItems; ++m) {
      const int i = tid + m * kThreads;
      if (i >= kBeam * D) break;
      const int j = i / D, d = i - j * D;
      store(out + ((int64_t)(w * kBeam + j) * H + h) * D + d, acc[m]);
    }
    return;
  }
  float* dst = cluster.map_shared_rank(recv, 0) + rank * kBeam * D;
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    const int i = tid + m * kThreads;
    if (i < kBeam * D) dst[i] = acc[m];
  }
  cluster.sync();
  if (rank != 0) return;
  for (int i = tid; i < kBeam * D; i += kThreads) {
    float a = 0.f;
    for (int c = 0; c < n_ranks; ++c) a += recv[c * kBeam * D + i];
    const int j = i / D, d = i - j * D;
    store(out + ((int64_t)(w * kBeam + j) * H + h) * D + d, a);
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

// The [L, BK, H, D, S] cache at `base` as dims (n_visible, D, H, BK, L):
// positions at and past n_visible lie outside the map and read as zeros.
bool make_map(CUtensorMap* map, const void* base, bool bf16, int L, int BK, int H, int D, int S,
              int n_visible, int beam, int tp) {
  const cuuint64_t es = bf16 ? 2 : 4;
  const cuuint64_t dims[5] = {(cuuint64_t)n_visible, (cuuint64_t)D, (cuuint64_t)H,
                              (cuuint64_t)BK, (cuuint64_t)L};
  const cuuint64_t strides[4] = {S * es, (cuuint64_t)D * S * es, (cuuint64_t)H * D * S * es,
                                 (cuuint64_t)BK * H * D * S * es};
  const cuuint32_t box[5] = {(cuuint32_t)tp, (cuuint32_t)D, 1, (cuuint32_t)beam, 1};
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  return encode_tiled()(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                        5, const_cast<void*>(base), dims, strides, box, elem_strides,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Positions a tile holds: at most 64, at most what fits kStageBudget, and
// no more than one rank's share, a multiple of 8 (16-byte TMA rows).
int tile_positions(int beam, int D, int esize, int n_visible, int cluster) {
  int tp = kStageBudget / (beam * D * esize) / 8 * 8;
  tp = tp < 8 ? 8 : (tp > 64 ? 64 : tp);
  const int share = ((n_visible + cluster - 1) / cluster + 7) / 8 * 8;
  return share < tp ? share : tp;
}

template <typename T, int kBeam>
int launch(const void* q, const void* k, const void* v, const int* anc, const float* mask,
           void* out, int L, int BK, int H, int D, int S, int layer, int mask_rows,
           int n_visible, float scale, int cluster, cudaStream_t stream) {
  const bool bf16 = sizeof(T) == 2;
  const int tp = tile_positions(kBeam, D, (int)sizeof(T), n_visible, cluster);
  const int n_tiles = (n_visible + tp - 1) / tp;
  const int tiles_per_rank = (n_tiles + cluster - 1) / cluster;
  CUtensorMap maps[2];
  if (!make_map(&maps[0], k, bf16, L, BK, H, D, S, n_visible, kBeam, tp) ||
      !make_map(&maps[1], v, bf16, L, BK, H, D, S, n_visible, kBeam, tp))
    return (int)cudaErrorInvalidValue;
  const Layout lay(kBeam, D, (int)sizeof(T), tp, tiles_per_rank * tp, cluster);
  const int smem = lay.total + 1024;  // + the 1024-byte alignment
  auto kernel = self_decode_kernel<T, kBeam>;
  static int smem_set = 0;  // the largest size set so far (one host thread launches)
  cudaError_t err;
  if (smem > smem_set) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, H, BK / kBeam);
  cfg.blockDim = dim3(64 * kBeam);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, maps[0], maps[1], static_cast<const T*>(q), anc, mask,
                           static_cast<T*>(out), H, D, S, layer, mask_rows, n_visible, tp,
                           tiles_per_rank, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int beam, const void* q, const void* k, const void* v, const int* anc,
             const float* mask, void* out, int L, int BK, int H, int D, int S, int layer,
             int mask_rows, int n_visible, float scale, int cluster, cudaStream_t stream) {
#define WNT_BEAM(KB)                                                                            \
  case KB:                                                                                      \
    return launch<T, KB>(q, k, v, anc, mask, out, L, BK, H, D, S, layer, mask_rows, n_visible, \
                         scale, cluster, stream);
  switch (beam) {
    WNT_BEAM(1) WNT_BEAM(2) WNT_BEAM(3) WNT_BEAM(4) WNT_BEAM(5) WNT_BEAM(6) WNT_BEAM(7)
    WNT_BEAM(8)
  }
#undef WNT_BEAM
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Returns a cudaError_t code (0 on success). Launches on `stream`, does not
// synchronise and allocates nothing. q, k, v and out are bf16 (dtype 0) or
// f32 (dtype 1); k and v 16-byte aligned with S * element size a multiple of
// 16; anc must hold lanes in [0, beam); the mask must hide every position at
// or past n_visible and leave at least one position before it visible.
// `cluster` CTAs (1-8) split each (window, head).
extern "C" int wnt_self_decode(const void* q, const void* k, const void* v, const int* anc,
                               const float* mask, void* out, int L, int BK, int H, int D, int S,
                               int layer, int beam, int mask_rows, int n_visible, int dtype,
                               int cluster, float scale, void* stream) {
  const int esize = dtype == 0 ? 2 : 4;
  if (beam < 1 || beam > kMaxBeam || BK < 1 || BK % beam || BK / beam > 65535 || H < 1 ||
      H > 65535 || D < 1 || D > kMaxD || S < 1 || (S * esize) % 16 || layer < 0 || layer >= L ||
      (mask_rows != 1 && mask_rows != BK) || n_visible < 1 || n_visible > S ||
      (dtype != 0 && dtype != 1) || cluster < 1 || cluster > kMaxCluster ||
      encode_tiled() == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<__nv_bfloat16>(beam, q, k, v, anc, mask, out, L, BK, H, D, S, layer,
                                   mask_rows, n_visible, scale, cluster, st);
  return dispatch<float>(beam, q, k, v, anc, mask, out, L, BK, H, D, S, layer, mask_rows,
                         n_visible, scale, cluster, st);
}
