// Depthwise-conv filter gradient (K6) for bf16 on Hopper (sm_90a): x and dy
// tiles staged by TMA through an mbarrier ring, one launch a call.
//
// Replaces the Pallas kernel automl_tpu/ops/depthwise.py::_filter_grad_kernel
// (launched by depthwise_filter_grad there) for bf16 x and dy whose channel
// count C is a multiple of 8 (C * 2 bytes a multiple of 16: what a TMA
// tensor map takes); float32 and other C keep the kernel of depthwise.cu.
// It computes
//   dW[c, kh, kw] = sum_{b,i,j} xpad[b, i+kh, j+kw, c] * dy[b, i, j, c]
// for a stride-1 depthwise conv with TF SAME padding (odd k: (k-1)/2 on
// every side), summed in f32, on x and dy [B, H, W, C] in memory (torch
// [B, C, H, W] in the channels_last format); the result is f32
// [C, 1, k, k].
//
// Bound: bytes. 2 k^2 flops per element of dy against 4 bytes of x and dy:
// at D0's largest map ([16, 32, 256, 256] k3) 134 MB, 40 us at 3.35 TB/s.
//
// Design. The wrapper's plan (ops/depthwise.py::sm90_plan, pure Python)
// picks, per map size, a channel chunk cb (8 to 64 channels) and a tile of
// nb images x th output rows x tw output columns: whole images, several to
// a tile, on maps of up to 8192 / cb pixels (BiFPN's 4 x 4 to 16 x 16),
// else th x tw windows of one image; and `parts`, the blocks per channel
// chunk (at most one block per SM where they meet at the ticket), in
// clusters of up to 8. Block (part, chunk) takes the chunk's tiles part,
// part + parts, ...:
//   * staging: one thread loads each tile's x window (the tile plus its
//     SAME halo) and dy tile with two 4-D TMA boxes over [B, H, W, C] into
//     a two-stage ring, on an mbarrier per stage. The x box starts at
//     negative coordinates on the image's edges; TMA fills what lies
//     outside the tensor (the SAME halo, images past B, rows past H,
//     columns past W, channels past C) with zeros, so nothing is padded in
//     memory or masked in code. The next tile loads while this one is
//     summed;
//   * arithmetic: a thread owns two neighbouring channels (one bf16x2
//     word of each pixel) and walks a column strip of the tile downwards:
//     the 32 / (cb / 2) strips a warp walks at once are neighbouring
//     columns, so a warp reads 128 contiguous bytes of shared memory per
//     load. It keeps a k x k window of x in f32 registers that moves one
//     row a step (k loads and one dy load a step, the window's rows
//     renamed at compile time, no register moves) and the 2 k^2 sums in
//     f32 registers;
//   * one launch: a block sums its strips per channel and tap in a fixed
//     order through shared memory. The parts of a chunk run in clusters of
//     up to 8 blocks; the first block of each sums the cluster's sums in
//     rank order over distributed shared memory. When one cluster serves
//     the chunk (BiFPN's small maps) it writes dW itself; otherwise it
//     writes its group's part to an f32 scratch [groups, k*k, C], and an
//     atomic ticket per chunk elects the group that finishes last, which
//     sums the groups' parts in group order (16 loads in flight before the
//     adds) and resets the ticket. The order of every sum is fixed: two
//     calls give bit-equal results.
// The halo makes x's boxes overlap (1.3x the elements at k3 on 8 x 64
// tiles); the overlap is read from L2 where a neighbour tile fetched it.
//
// Plain C interface, loaded with ctypes (automl_tpu_torch/ops/cuda_build.py).
// The tensor maps are encoded per call on the host and passed as
// __grid_constant__ kernel parameters. The kernel allocates nothing: the
// wrapper allocates the scratch and keeps the tickets (zero between calls;
// the kernel leaves them zero). The launcher returns a cudaError_t, or -1
// when a tensor map cannot be encoded.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 2;
constexpr int kMaxSmem = 232448;   // a block's shared memory on sm_90

struct Params {
  float* partial;    // [parts / cluster, K*K, C] (parts > cluster)
  float* out;        // [C, K*K]
  int* tickets;      // [chunks], zero between calls (parts > cluster)
  int B, H, W, C;
  int cb, nb, th, tw;
  int tiles_h, tiles_w, n_tiles;
  int parts, cluster;        // blocks per chunk, in clusters of `cluster`
  int x_box, dy_box;         // bytes of a tile's x and dy boxes
  int dy_at, stage_bytes;    // a stage: the x box, then (128-aligned) dy's
  int bars_at;               // the ring's barriers and the ticket's flag
};

__host__ __device__ constexpr int align128(int n) { return (n + 127) & ~127; }

// bf16 pair (low: the even channel) as two f32.
__device__ __forceinline__ float2 bf2(uint32_t v) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}

__device__ __forceinline__ float ld_cluster_f32(uint32_t at) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(at)
               : "memory");
  return v;
}

__device__ __forceinline__ uint32_t ld_shared_u32(uint32_t at) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(at) : "memory");
  return v;
}

template <int K>
__global__ void __launch_bounds__(kThreads, K == 7 ? 1 : 2)
    filter_grad_sm90_kernel(const __grid_constant__ CUtensorMap tx,
                            const __grid_constant__ CUtensorMap tdy,
                            const Params p) {
  constexpr int KK = K * K, PAD = (K - 1) / 2;
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.bars_at);
  int* last = reinterpret_cast<int*>(full + kStages);
  const int t = threadIdx.x;
  const int chunk = blockIdx.x / p.parts, part = blockIdx.x % p.parts;
  const int c0 = chunk * p.cb;
  const int P = p.cb / 2;             // threads across a pixel's channels
  const int pc = t % P, q = t / P;    // channel pair, strip slot
  const int R = kThreads / P;         // strips walked at once
  const int SH = p.th + K - 1, SW = p.tw + K - 1;
  const int n_my = (p.n_tiles - part + p.parts - 1) / p.parts;
  const int tiles_img = p.tiles_h * p.tiles_w;

  if (t == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Tile i of this block into stage s: x from (x0 - PAD, y0 - PAD), dy from
  // (x0, y0), channels c0.., images n0...
  auto load = [&](int i, int s) {
    const int tile = part + i * p.parts;
    const int n0 = tile / tiles_img * p.nb;
    const int r = tile % tiles_img;
    const int y0 = r / p.tiles_w * p.th, x0 = r % p.tiles_w * p.tw;
    uint8_t* st = smem + s * p.stage_bytes;
    mbar_expect_tx(&full[s], p.x_box + p.dy_box);
    tma_load(st, &tx, &full[s], c0, x0 - PAD, y0 - PAD, n0);
    tma_load(st + p.dy_at, &tdy, &full[s], c0, x0, y0, n0);
  };
  if (t == 0)
    for (int i = 0; i < kStages && i < n_my; ++i) load(i, i);

  float2 acc[K][K];
#pragma unroll
  for (int kh = 0; kh < K; ++kh)
#pragma unroll
    for (int kw = 0; kw < K; ++kw) acc[kh][kw] = make_float2(0.f, 0.f);

  const int strips = p.nb * p.tw;
  const int xrow = SW * p.cb * 2, dyrow = p.tw * p.cb * 2;  // bytes a row
  const int px = p.cb * 2;                                 // bytes a pixel
  for (int i = 0; i < n_my; ++i) {
    const int s = i % kStages;
    mbar_wait(&full[s], (i / kStages) & 1);
    const uint32_t xs = smem_u32(smem + s * p.stage_bytes) + pc * 4;
    const uint32_t dys = xs + p.dy_at;
    for (int strip = q; strip < strips; strip += R) {
      const int n = strip / p.tw, j = strip - n * p.tw;
      const uint32_t xb = xs + (n * SH * SW + j) * px;
      const uint32_t db = dys + (n * p.th * p.tw + j) * px;
      // win[(row) % K][kw]: x at (window row, column j + kw) of the tile's
      // padded frame; rows 0 .. K-2 first.
      float2 win[K][K];
#pragma unroll
      for (int r = 0; r < K - 1; ++r)
#pragma unroll
        for (int kw = 0; kw < K; ++kw)
          win[r][kw] = bf2(ld_shared_u32(xb + r * xrow + kw * px));
      for (int i0 = 0; i0 < p.th; i0 += K) {
        static_for<0, K>([&](auto ph) {
          const int row = i0 + ph;
          if (row < p.th) {
            // Output row `row` needs window rows row .. row + K - 1, held
            // in slots (ph + kh) % K; the new one goes to (ph + K - 1) % K.
            constexpr int kNew = (ph + K - 1) % K;
#pragma unroll
            for (int kw = 0; kw < K; ++kw)
              win[kNew][kw] =
                  bf2(ld_shared_u32(xb + (row + K - 1) * xrow + kw * px));
            const float2 g = bf2(ld_shared_u32(db + row * dyrow));
#pragma unroll
            for (int kh = 0; kh < K; ++kh)
#pragma unroll
              for (int kw = 0; kw < K; ++kw) {
                const float2 v = win[(ph + kh) % K][kw];
                acc[kh][kw].x = fmaf(v.x, g.x, acc[kh][kw].x);
                acc[kh][kw].y = fmaf(v.y, g.y, acc[kh][kw].y);
              }
          }
        });
      }
    }
    __syncthreads();  // every thread is done with stage s
    if (t == 0 && i + kStages < n_my) load(i + kStages, s);
  }

  // The block's sums: the R strip slots of each (tap, channel), in order,
  // through shared memory (the ring is free: every load was waited for).
  const int outs = KK * p.cb;
  float* red = reinterpret_cast<float*>(smem);   // [R][KK][cb]
  float* bsum = red + R * outs;                  // [KK][cb]
#pragma unroll
  for (int kh = 0; kh < K; ++kh)
#pragma unroll
    for (int kw = 0; kw < K; ++kw)
      *reinterpret_cast<float2*>(red + (q * KK + kh * K + kw) * p.cb + 2 * pc) =
          acc[kh][kw];
  __syncthreads();
  for (int o = t; o < outs; o += kThreads) {
    float sum = 0.f;
    for (int r = 0; r < R; ++r) sum += red[r * outs + o];
    bsum[o] = sum;
  }
  __syncthreads();

  // The cluster's sum, in rank order, by its first block: dW itself when
  // one cluster serves the chunk, else the group's part.
  const int rank = cluster_rank();
  const int group = part / p.cluster, groups = p.parts / p.cluster;
  if (p.cluster > 1) cluster_sync();
  if (rank == 0) {
    const uint32_t bs = smem_u32(bsum);
    for (int o = t; o < outs; o += kThreads) {
      const int tap = o / p.cb, c = o - tap * p.cb;
      // Every rank's value in flight before the adds, which go in order.
      float v[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        v[r] = r < p.cluster ? ld_cluster_f32(map_to_rank(bs + 4 * o, r))
                             : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < 8; ++r) sum += v[r];
      if (c0 + c < p.C) {
        if (groups == 1)
          p.out[(size_t)(c0 + c) * KK + tap] = sum;
        else
          p.partial[((size_t)group * KK + tap) * p.C + c0 + c] = sum;
      }
    }
  }
  if (p.cluster > 1) cluster_sync();  // the others' sums were read
  if (rank != 0 || groups == 1) return;

  // The ticket: the chunk's last group sums the groups' parts. One thread
  // releases the block's part (the barrier orders the others' writes
  // before its fence) and, when last, acquires the other groups'.
  __syncthreads();
  if (t == 0) {
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    const int prev = atomicAdd(&p.tickets[chunk], 1);
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    *last = prev == groups - 1;
  }
  __syncthreads();
  if (!*last) return;
  // Each output's groups in order, 16 loads in flight at a time.
  constexpr int kBatch = 16;
  for (int o = t; o < outs; o += kThreads) {
    const int tap = o / p.cb, c = o - tap * p.cb;
    if (c0 + c >= p.C) continue;
    const float* src = p.partial + (size_t)tap * p.C + c0 + c;
    const size_t stride = (size_t)KK * p.C;
    float sum = 0.f;
    for (int g0 = 0; g0 < groups; g0 += kBatch) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        v[u] = g0 + u < groups ? __ldcg(src + (g0 + u) * stride) : 0.f;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) sum += v[u];
    }
    p.out[(size_t)(c0 + c) * KK + tap] = sum;
  }
  if (t == 0) p.tickets[chunk] = 0;
}

// A bf16 [B, H, W, C] tensor as a 4-D tensor map read in [cb, bw, bh, nb]
// boxes (no swizzle); what lies outside the tensor reads as zeros.
bool encode_nhwc(CUtensorMap* map, const void* base, int B, int H, int W,
                 int C, int cb, int bw, int bh, int nb) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(C), cuuint64_t(W), cuuint64_t(H),
                              cuuint64_t(B)};
  const cuuint64_t bytes[3] = {cuuint64_t(C) * 2, cuuint64_t(W) * C * 2,
                               cuuint64_t(H) * W * C * 2};
  const cuuint32_t box[4] = {cuuint32_t(cb), cuuint32_t(bw), cuuint32_t(bh),
                             cuuint32_t(nb)};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, bytes, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Bytes of shared memory before the barriers: the ring, or the block's
// sums if larger.
int region_bytes(const Params& p, int K) {
  const int red = (kThreads / (p.cb / 2) + 1) * K * K * p.cb * 4;
  const int ring = kStages * p.stage_bytes;
  return align128(ring > red ? ring : red);
}

template <int K>
int launch(const void* x, const void* dy, Params p, cudaStream_t s) {
  CUtensorMap maps[2];
  if (!encode_nhwc(&maps[0], x, p.B, p.H, p.W, p.C, p.cb, p.tw + K - 1,
                   p.th + K - 1, p.nb) ||
      !encode_nhwc(&maps[1], dy, p.B, p.H, p.W, p.C, p.cb, p.tw, p.th, p.nb))
    return -1;
  const int smem = p.bars_at + kStages * 8 + 16;
  cudaError_t err = cudaFuncSetAttribute(
      filter_grad_sm90_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return int(err);
  const int chunks = (p.C + p.cb - 1) / p.cb;
  err = launch_clusters(filter_grad_sm90_kernel<K>, chunks * p.parts,
                        kThreads, p.cluster, smem, s, maps[0], maps[1], p);
  return int(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// x, dy: bf16 [B, H, W, C], 16-byte aligned, C a multiple of 8; partial:
// f32 scratch [parts / cluster, K*K, C] and tickets: int32 [ceil(C / cb)],
// zero (both unused, may be null, when parts is cluster); out: f32
// [C, K*K]. The plan (cb, nb, th, tw, parts, cluster) is
// ops/depthwise.py::sm90_plan's. Returns a cudaError_t (0 = launched), or
// -1 when a tensor map cannot be encoded.
extern "C" int automl_depthwise_filter_grad_sm90(
    const void* x, const void* dy, void* partial, void* out, void* tickets,
    int B, int H, int W, int C, int K, int cb, int nb, int th, int tw,
    int parts, int cluster, void* stream) {
  cudaGetLastError();  // clear an earlier, unrelated error
  Params p = {};
  p.partial = static_cast<float*>(partial);
  p.out = static_cast<float*>(out);
  p.tickets = static_cast<int*>(tickets);
  p.B = B;
  p.H = H;
  p.W = W;
  p.C = C;
  p.cb = cb;
  p.nb = nb;
  p.th = th;
  p.tw = tw;
  p.parts = parts;
  p.cluster = cluster;
  const bool shape_ok =
      B >= 1 && H >= 1 && W >= 1 && C >= 8 && C % 8 == 0 &&
      (K == 1 || K == 3 || K == 5 || K == 7) &&
      (cb == 8 || cb == 16 || cb == 32 || cb == 64) && nb >= 1 && nb <= B &&
      nb <= 256 && th >= 1 && th <= H && tw >= 1 && tw <= W &&
      th + K - 1 <= 256 && tw + K - 1 <= 256 &&
      (long long)B * H * W * C <= INT_MAX && cluster >= 1 && cluster <= 8 &&
      parts >= 1 && parts % cluster == 0 &&
      (long long)((C + cb - 1) / cb) * parts <= INT_MAX;
  if (!shape_ok) return int(cudaErrorInvalidValue);
  p.tiles_h = (H + th - 1) / th;
  p.tiles_w = (W + tw - 1) / tw;
  const long long tiles =
      (long long)((B + nb - 1) / nb) * p.tiles_h * p.tiles_w;
  // th, tw <= 256 and nb <= 256 (checked above) keep these in range.
  const long long x_box = (long long)cb * 2 * (tw + K - 1) * (th + K - 1) * nb;
  const long long dy_box = (long long)cb * 2 * tw * th * nb;
  if (tiles > INT_MAX || parts > tiles + cluster - 1 ||
      kStages * (x_box + dy_box + 256) > kMaxSmem ||
      (parts > cluster && (partial == nullptr || tickets == nullptr)))
    return int(cudaErrorInvalidValue);
  p.n_tiles = int(tiles);
  p.x_box = int(x_box);
  p.dy_box = int(dy_box);
  p.dy_at = align128(p.x_box);
  p.stage_bytes = p.dy_at + align128(p.dy_box);
  p.bars_at = region_bytes(p, K);
  if (p.bars_at + kStages * 8 + 16 > kMaxSmem)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return launch<1>(x, dy, p, s);
    case 3: return launch<3>(x, dy, p, s);
    case 5: return launch<5>(x, dy, p, s);
    default: return launch<7>(x, dy, p, s);
  }
}
