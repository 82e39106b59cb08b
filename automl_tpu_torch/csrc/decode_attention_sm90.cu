// KV-cached decode attention (K4) for bf16 on Hopper (sm_90a): a split-S
// decode kernel with a fixed-order merge, and a prefill kernel on bf16
// tensor cores (wgmma) fed by TMA that does not visit dead tiles.
//
// Replaces the Pallas kernel automl_tpu/ops/decode_attention.py::_kernel
// (launched by decode_attention there) for bf16 q and cache with a head dim
// H <= 128 that is a multiple of 8 and a cache length S that is a multiple
// of 8 (what a TMA descriptor and 16-byte copies can stride); f32 inputs and
// other shapes keep the kernel of decode_attention.cu. It computes what the
// TPU kernel computes:
//   * q [B, T, N, H] bf16, already scaled (any strides, unit H stride); the
//     rank-3 cache k [B*n_kv, H, S] and v [B*n_kv, S, H], rows batch-major
//     (b*n_kv + g) or head-major (g*B + b); GQA without repeating the cache
//     (q head n reads kv head g = n / rep, rep = N / n_kv);
//   * mask [B, T, S] bool, True = attend, whatever the caller built (causal,
//     window, segments, prefix-LM);
//   * scores capped with tanh, masked to -1e30 with an explicit p = 0, the
//     softmax in f32 with the denominator clamped at 1e-30, so that a
//     fully-masked row gives exactly 0; optional raw (m, l) per row, with
//     l == 0 for a fully-masked row (decode_attention_sp merges on them).
// Output [B, T, N, H] bf16, contiguous.
//
// Precision contract (that of flash_attention_sm90.cu): s = q k^T is an
// exact product of the bf16 operands summed in f32. The f32 p enters p v as
// f32 on the CUDA cores (decode) or as its bf16 hi + lo halves through
// wgmma into one f32 accumulator (prefill); it is never rounded to bf16
// once. The cap is tanhf of s * (1 / cap); the prefill's exponentials are
// exp2f of scores scaled by log2 e.
//
// Bound on this card, at the serving slice's shapes (B 8, N 8 / n_kv 8,
// H 128, S 1024, bf16): a decode step (T 1) reads 33.5 MB of K/V and does
// 4 flops per cache element: bytes, about 0.010 ms at 3.35 TB/s. The prefill
// (T 512, causal in a 1024-slot cache) needs only keys 0-511: the live half
// of the cache (16.8 MB), q, out and the 4.2 MB mask, about 0.011 ms; its
// 4.3 GFLOP of live pairs take 0.0044 ms at 989 TFLOP/s (6.5 with the hi +
// lo split of p: 0.0066 ms).
//
// Design.
//   Decode, T * rep <= 16 query rows per kv row (decode, short chunks):
//   split-S (flash-decoding). A block of 256 threads owns one kv row and
//   one split of S (split_tiles tiles of 64 keys; the caller picks the
//   split so that the grid fills the SMs about eight times over: 64 rows x
//   16 splits of 64 keys at the slice). All rep query heads and T queries
//   of the kv row share the block, so GQA reads the cache once. The block
//   first reads its part of the mask and skips every 64-key tile that no
//   query attends, a split with none left at once (a greedy step j has
//   only 512 + j live keys). The live tiles stream through a ring of up
//   to four stages: K and V by TMA (unswizzled boxes, zero-filled past S)
//   on an mbarrier each, the mask tile by cp.async. Scores and p v are f32
//   FMAs on the CUDA cores (the bound is bytes). The block writes its
//   unnormalised f32 accumulator and raw (m, l) per query row to scratch;
//   a second launch, a programmatic dependent of the first (its launch
//   overlaps the first's tail), merges the splits per row in a fixed
//   order: m* = max m_i, w_i = exp(m_i - m*) for a split with l_i > 0 and
//   exactly 0 otherwise, out = sum w_i acc_i / max(sum w_i l_i, 1e-30)
//   (decode_attention_sp's formula, with acc_i = l_i out_i), so two calls
//   are bit-equal.
//   Prefill, T * rep > 16: one block of three warpgroups owns 128 queries of
//   one (b, n): two consumer warpgroups (64 queries each, 240 registers,
//   setmaxnreg) run wgmma; a producer warpgroup (24 registers) keeps TMA
//   loads in flight through a two-stage mbarrier ring (the building blocks
//   of flash_attention_sm90.cu, sm90_common.cuh). S = Q K^T reads K from
//   the cache tile [H, 64 keys], MN-major for the B operand (wgmma's
//   transpose bit), through a 3-D tensor map [rows, H, S] with a box of 64
//   keys (128 bytes) x H; V [rows, S, H] is MN-major as in K1. O += P V
//   with P's hi and lo halves from registers. A pre-pass kernel reads the
//   mask once and classes every (b, 64 queries, 64 keys) tile as dead,
//   mixed or all live, and writes a mixed tile as one 64-bit word per
//   query. The producer loads only the key tiles that are live for one of
//   the block's two query tiles; a consumer whose query tile is dead skips
//   the products, an all-live tile runs a softmax with no per-element mask,
//   and a mixed tile reads its two rows' words. A one-block kernel orders
//   the blocks by their number of live tiles, the most first. At the slice
//   the softmax's instructions, not the loads or the products, bound this
//   kernel (PERF.md).
//
// Plain C interface, loaded with ctypes (automl_tpu_torch/ops/cuda_build.py).
// The kernels allocate nothing (the caller passes the scratch); the
// launchers return a cudaError_t, or -1 when a tensor map cannot be encoded.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF
constexpr int kTile = 64;          // keys of a tile (and queries of a tile)
// Decode.
constexpr int kDecThreads = 256;
constexpr int kDecMaxRows = 16;    // T * rep query rows of one kv row
constexpr int kDecMaxTiles = 32;   // tiles of one split: one bit each
constexpr int kDecStages = 4;      // the decode ring's stages (at most)
constexpr int kMergeThreads = 128;
// Prefill.
constexpr int kThreads = 384;      // consumer warpgroups 0, 1; producer 2
constexpr int kConsumers = 256;
constexpr int kStages = 2;         // the prefill ring's stages
constexpr int kBQ = 128;           // queries of a block
// Tile classes of the pre-pass.
constexpr uint8_t kDead = 0, kMixed = 1, kLive = 2;

struct Params {
  const __nv_bfloat16* q;  // [B, T, N, H], strides q_sb, q_st, q_sn
  const __nv_bfloat16* k;  // [B*n_kv, H, S]
  const __nv_bfloat16* v;  // [B*n_kv, S, H]
  const uint8_t* mask;     // [B, T, S]
  __nv_bfloat16* out;      // [B, T, N, H]
  float* m_out;            // [B, T, N] or null
  float* l_out;
  float* part_acc;         // decode: [splits, B*T*N, H]
  float* part_ml;          // decode: [splits, B*T*N, 2]
  uint8_t* cls;            // prefill: [B, QT, NK]
  uint64_t* bits;          // prefill: [B, QT, NK, 64] a mixed tile's rows
  int* order;              // prefill: [B*QB] block order
  long long q_sb, q_st, q_sn;
  int B, T, N, n_kv, H, S, head_major;
  int split_tiles, splits;  // decode
  int QT, QB, NK;           // prefill: 64-query tiles, 128-query blocks, key tiles
  float cap, inv_cap;       // 0: no cap
};

constexpr float kLog2e = 1.4426950408889634f;

// cap * tanh(s / cap), with s / cap taken as s * (1 / cap); s without a cap.
__device__ __forceinline__ float cap_score(float s, float cap, float inv_cap) {
  return cap > 0.f ? cap * tanhf(s * inv_cap) : s;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// An 8-byte cp.async copy; `ok` false copies nothing and zero-fills.
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Waits until at most n (< kDecStages) committed groups are pending.
__device__ __forceinline__ void cp_async_wait_for(int n) {
  if (n <= 0) cp_async_wait<0>();
  else if (n == 1) cp_async_wait<1>();
  else if (n == 2) cp_async_wait<2>();
  else cp_async_wait<3>();
}

// A box of a 3-D tensor map at (c0, c1, c2); its bytes complete a
// transaction on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// ---------------------------------------------------------------------------
// Decode: split-S, then the merge.
// ---------------------------------------------------------------------------

// A ring stage: K [H][64 keys] and V [64 keys][H] (bf16, by TMA), the
// mask tile [T][64 keys] (bytes, by cp.async); 1024-byte aligned.
__host__ __device__ __forceinline__ int dec_stage_bytes(int H, int T) {
  return (4 * H * kTile + T * kTile + 1023) / 1024 * 1024;
}

__host__ __device__ __forceinline__ int dec_smem_bytes(int H, int T, int M,
                                                       int stages) {
  return 1024 + stages * dec_stage_bytes(H, T)            // alignment, ring
         + (M * H + 5 * M * kTile + 3 * kDecMaxRows) * 4  // q, red, p, m/l/alpha
         + 8 * kDecStages + 16;                           // barriers, live bits
}

// Row m of a block (t = m / rep, head n = g * rep + m % rep) as its index in
// [B, T, N].
__device__ __forceinline__ long long dec_row(const Params& p, int b, int g,
                                             int rep, int m) {
  return ((long long)b * p.T + m / rep) * p.N + g * rep + m % rep;
}

__host__ __device__ __forceinline__ int dec_stages(int split_tiles) {
  return split_tiles < kDecStages ? split_tiles : kDecStages;
}

template <int MR>  // MR >= M = T * rep, a power of two up to 16
__global__ void __launch_bounds__(kDecThreads, MR <= 2 ? 3 : 2)
    k4_decode_split_kernel(const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const int H = p.H, T = p.T, rep = p.N / p.n_kv, M = T * rep;
  const int stages = dec_stages(p.split_tiles);
  const int stage_bytes = dec_stage_bytes(H, T);
  float* q_s = reinterpret_cast<float*>(smem + stages * stage_bytes);  // [M][H]
  float* red_s = q_s + M * H;              // [4][M][64] partial scores
  float* p_s = red_s + 4 * M * kTile;      // [M][64] scores, then p
  float* m_s = p_s + M * kTile;            // [16] running max
  float* l_s = m_s + kDecMaxRows;          // [16] running sum
  float* alpha_s = l_s + kDecMaxRows;      // [16] this tile's rescale
  uint64_t* full = reinterpret_cast<uint64_t*>(alpha_s + kDecMaxRows);  // [stages]
  uint32_t* live_s = reinterpret_cast<uint32_t*>(full + kDecStages);

  const int r = blockIdx.x, split = blockIdx.y, tid = threadIdx.x;
  const int b = p.head_major ? r % p.B : r / p.n_kv;
  const int g = p.head_major ? r / p.B : r % p.n_kv;
  const int tile0 = split * p.split_tiles;
  const int nt = min(p.split_tiles, (p.S + kTile - 1) / kTile - tile0);
  const uint8_t* mrow = p.mask + (long long)b * T * p.S;
  const long long rows_q = (long long)p.B * T * p.N;
  float* ml = p.part_ml + split * rows_q * 2;

  // The split's tiles that hold a live key for one of the block's queries.
  if (tid == 0) {
    *live_s = 0u;
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int e = tid; e < nt * T * 8; e += kDecThreads) {
    const int i = e / (T * 8), t = (e / 8) % T;
    const int key = (tile0 + i) * kTile + (e % 8) * 8;
    if (key < p.S) {
      const uint2 w = *reinterpret_cast<const uint2*>(mrow + (long long)t * p.S + key);
      if ((w.x | w.y) != 0u) atomicOr(live_s, 1u << i);
    }
  }
  __syncthreads();
  const uint32_t live = *live_s;
  if (live == 0u) {  // no live key: l = 0, and the merge gives it no weight
    if (tid < M) {
      const long long row = dec_row(p, b, g, rep, tid);
      ml[2 * row] = kNegInf;
      ml[2 * row + 1] = 0.f;
    }
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    return;
  }
  auto next_live = [&](int from) {
    const uint32_t rest = from < nt ? live >> from : 0u;
    return rest != 0u ? from + __ffs(rest) - 1 : nt;
  };

  auto issue = [&](int i, int s) {  // tile i of the split into stage s
    uint8_t* st = smem + s * stage_bytes;
    uint8_t* ms = st + 4 * H * kTile;
    const int k0 = (tile0 + i) * kTile;
    if (tid == 0) {  // K and V: two TMA boxes, zero-filled past S
      mbar_expect_tx(&full[s], 4 * H * kTile);
      tma_load_3d(st, &tk, &full[s], k0, 0, r);
      tma_load_3d(st + 2 * H * kTile, &tv, &full[s], 0, k0, r);
    }
    for (int e = tid; e < T * 8; e += kDecThreads) {  // the mask tile
      const int t = e / 8, key = k0 + (e % 8) * 8;
      const bool ok = key < p.S;
      cp_async8(ms + t * kTile + (e % 8) * 8,
                mrow + (long long)t * p.S + (ok ? key : 0), ok);
    }
    cp_async_commit();
  };

  // Up to `stages` live tiles in flight; the i-th live tile uses stage
  // i % stages.
  int cur = next_live(0), ahead = cur, inflight = 0;
  for (; inflight < stages && ahead < nt; ++inflight) {
    issue(ahead, inflight);
    ahead = next_live(ahead + 1);
  }

  for (int e = tid; e < M * H; e += kDecThreads) {
    const int m = e / H, h = e % H;
    const int t = m / rep, n = g * rep + m % rep;
    q_s[e] = __bfloat162float(p.q[b * p.q_sb + t * p.q_st + n * p.q_sn + h]);
  }
  if (tid < M) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  const int j = tid % kTile, hq = tid / kTile;  // scores: key j, H quarter hq
  const int hh = tid % 128, kg = tid / 128;     // p v: dim hh, key half kg
  const int HQ = H / 4, warp = tid / 32, lane = tid % 32;
  float acc[MR];
#pragma unroll
  for (int m = 0; m < MR; ++m) acc[m] = 0.f;

  for (int it = 0; cur < nt; ++it) {
    const int s = it % stages;
    cp_async_wait_for(inflight - 1);
    mbar_wait(&full[s], (it / stages) & 1);
    __syncthreads();  // the tile, q_s and the stats are visible
    const uint8_t* st = smem + s * stage_bytes;
    const __nv_bfloat16* ks = reinterpret_cast<const __nv_bfloat16*>(st);
    const __nv_bfloat16* vs = ks + H * kTile;
    const uint8_t* ms = reinterpret_cast<const uint8_t*>(vs + kTile * H);

    // Partial scores over a quarter of H: exact bf16 products, f32 sums.
    float part[MR];
#pragma unroll
    for (int m = 0; m < MR; ++m) part[m] = 0.f;
    for (int h = hq * HQ; h < (hq + 1) * HQ; ++h) {
      const float kx = __bfloat162float(ks[h * kTile + j]);
#pragma unroll
      for (int m = 0; m < MR; ++m)
        if (m < M) part[m] = fmaf(q_s[m * H + h], kx, part[m]);
    }
#pragma unroll
    for (int m = 0; m < MR; ++m)
      if (m < M) red_s[(hq * M + m) * kTile + j] = part[m];
    __syncthreads();

    // The scores, summed over the quarters in a fixed order, capped and
    // masked (a dead key, or one past S, scores -inf: its p is exactly 0).
    for (int e = tid; e < M * kTile; e += kDecThreads) {
      const int m = e / kTile, jj = e % kTile;
      const float* x = red_s + m * kTile + jj;
      const float sc = ((x[0] + x[M * kTile]) + x[2 * M * kTile]) + x[3 * M * kTile];
      p_s[e] = ms[(m / rep) * kTile + jj] ? cap_score(sc, p.cap, p.inv_cap) : -INFINITY;
    }
    __syncthreads();

    // Online softmax, one warp a row.
    for (int m = warp; m < M; m += kDecThreads / 32) {
      float* row = p_s + m * kTile;
      const float m_prev = m_s[m];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(row[lane], row[lane + 32])));
      const float e0 = expf(row[lane] - m_new), e1 = expf(row[lane + 32] - m_new);
      row[lane] = e0;
      row[lane + 32] = e1;
      const float sum = warp_sum(e0 + e1);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[m] = alpha;
        l_s[m] = alpha * l_s[m] + sum;
        m_s[m] = m_new;
      }
    }
    __syncthreads();

    // acc = alpha acc + p v over this thread's half of the keys.
    if (hh < H) {
#pragma unroll
      for (int m = 0; m < MR; ++m)
        if (m < M) acc[m] *= alpha_s[m];
      for (int jj = kg * 32; jj < kg * 32 + 32; ++jj) {
        const float vx = __bfloat162float(vs[jj * H + hh]);
#pragma unroll
        for (int m = 0; m < MR; ++m)
          if (m < M) acc[m] = fmaf(p_s[m * kTile + jj], vx, acc[m]);
      }
    }
    __syncthreads();  // the stage and p_s are free again
    --inflight;
    if (ahead < nt) {
      issue(ahead, s);
      ahead = next_live(ahead + 1);
      ++inflight;
    }
    cur = next_live(cur + 1);
  }

  // Key half 1's accumulator through shared memory, added to half 0's.
  float* comb = red_s;  // [M][H]: M * H <= 4 * M * 64
  if (kg == 1 && hh < H) {
#pragma unroll
    for (int m = 0; m < MR; ++m)
      if (m < M) comb[m * H + hh] = acc[m];
  }
  __syncthreads();
  if (kg == 0 && hh < H) {
    float* pa = p.part_acc + split * rows_q * H;
#pragma unroll
    for (int m = 0; m < MR; ++m)
      if (m < M) pa[dec_row(p, b, g, rep, m) * H + hh] = acc[m] + comb[m * H + hh];
  }
  if (tid < M) {
    const long long row = dec_row(p, b, g, rep, tid);
    ml[2 * row] = m_s[tid];
    ml[2 * row + 1] = l_s[tid];
  }
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// One block per query row (b, t, n), one thread per head dim: the splits
// merged in order 0, 1, ..., kMergeThreads at a time. A split's weight w_i
// is 0 where it has no live key (its acc was never written, and is not
// used). Launched as a programmatic dependent of the split kernel: it waits
// for that grid's results before reading them.
__global__ void __launch_bounds__(kMergeThreads)
    k4_decode_merge_kernel(const Params p) {
  __shared__ float w_s[kMergeThreads], lw_s[kMergeThreads], max_s[kMergeThreads / 32];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long long row = blockIdx.x;
  const long long rows_q = (long long)p.B * p.T * p.N;
  const int tid = threadIdx.x;
  const float* ml = p.part_ml + 2 * row;  // split i at ml[2 * i * rows_q]
  const float* acc = p.part_acc + row * p.H + tid;  // split i at acc[i * rows_q * H]
  float num = 0.f, den = 0.f, m_star = kNegInf;
  for (int c0 = 0; c0 < p.splits; c0 += kMergeThreads) {
    const int n = min(kMergeThreads, p.splits - c0);
    // This chunk's (m, l) and, for up to 16 splits, this thread's acc: one
    // round trip.
    float2 x = make_float2(kNegInf, 0.f);
    if (tid < n) x = *reinterpret_cast<const float2*>(ml + 2 * (c0 + tid) * rows_q);
    float a[16];
#pragma unroll
    for (int u = 0; u < 16; ++u)
      a[u] = u < n && tid < p.H ? acc[(c0 + u) * rows_q * p.H] : 0.f;
    float mx = warp_max(x.x);
    if (tid % 32 == 0) max_s[tid / 32] = mx;
    __syncthreads();
    const float m_prev = m_star;
    for (int w = 0; w < kMergeThreads / 32; ++w) m_star = fmaxf(m_star, max_s[w]);
    // Rescale the earlier chunks' sums to the new maximum (exactly 1 when
    // it did not move, as with one chunk).
    const float r = expf(m_prev - m_star);
    num *= r;
    den *= r;
    if (tid < n) {
      const float w = x.y > 0.f ? expf(x.x - m_star) : 0.f;
      w_s[tid] = w;
      lw_s[tid] = w * x.y;
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) den += lw_s[i];
    if (tid < p.H) {
#pragma unroll
      for (int u = 0; u < 16; ++u)
        if (u < n && w_s[u] != 0.f) num += w_s[u] * a[u];
      for (int i = 16; i < n; ++i)
        if (w_s[i] != 0.f) num += w_s[i] * acc[(c0 + i) * rows_q * p.H];
    }
    __syncthreads();  // w_s, lw_s and max_s are reused by the next chunk
  }
  if (tid < p.H)
    p.out[row * p.H + tid] = __float2bfloat16(num / fmaxf(den, 1e-30f));
  if (tid == 0 && p.m_out != nullptr) {
    p.m_out[row] = m_star;
    p.l_out[row] = den;  // raw: 0 for a fully-masked row
  }
}

// ---------------------------------------------------------------------------
// Prefill: the mask's tile classes, the block order, the wgmma kernel.
// ---------------------------------------------------------------------------

// One warp per (b, 64-query tile, 64-key tile), eight a block: the tile's
// class, dead (no live pair), all live (every pair of the tile's queries
// < T live, and the key tile wholly inside S) or mixed, and for a mixed
// tile its mask as one 64-bit word per query (bit k: key k of the tile).
// 8-byte reads (S is a multiple of 8), 16 a lane in flight.
__global__ void __launch_bounds__(256) k4_mask_tiles_kernel(const Params p) {
  const long long tile = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (tile >= (long long)p.B * p.QT * p.NK) return;
  const int j = tile % p.NK, qt = (tile / p.NK) % p.QT, b = tile / (p.NK * p.QT);
  const int k0 = j * kTile, rows = min(kTile, p.T - qt * kTile);
  const uint8_t* base = p.mask + ((long long)b * p.T + qt * kTile) * p.S;
  uint2 w[16];
#pragma unroll
  for (int u = 0; u < 16; ++u) {
    const int e = lane + 32 * u, key = k0 + (e % 8) * 8;
    w[u] = e < rows * 8 && key < p.S
               ? *reinterpret_cast<const uint2*>(base + (long long)(e / 8) * p.S + key)
               : make_uint2(0u, 0u);
  }
  bool any = false, all = k0 + kTile <= p.S;
#pragma unroll
  for (int u = 0; u < 16; ++u) {
    any |= (w[u].x | w[u].y) != 0u;
    if (lane + 32 * u < rows * 8)
      all &= (__vcmpne4(w[u].x, 0u) & __vcmpne4(w[u].y, 0u)) == 0xffffffffu;
  }
  any = __any_sync(0xffffffffu, any);
  all = __all_sync(0xffffffffu, all);
  const uint8_t c = !any ? kDead : all ? kLive : kMixed;
  if (lane == 0) p.cls[tile] = c;
  if (c != kMixed) return;
#pragma unroll
  for (int u = 0; u < 16; ++u) {
    // Lane group e / 8 holds query e / 8's 64 bytes, 8 a lane: one bit a
    // byte, then the group's 8 bytes of bits or-ed into the row's word.
    const int e = lane + 32 * u;
    const uint32_t x = __vcmpne4(w[u].x, 0u), y = __vcmpne4(w[u].y, 0u);
    const uint32_t eight = (x & 1u) | ((x >> 7) & 2u) | ((x >> 14) & 4u) |
                           ((x >> 21) & 8u) | ((y & 1u) << 4) | ((y >> 3) & 0x20u) |
                           ((y >> 10) & 0x40u) | ((y >> 17) & 0x80u);
    uint64_t row = uint64_t(eight) << (8 * (e % 8));
    row |= __shfl_xor_sync(0xffffffffu, row, 1);
    row |= __shfl_xor_sync(0xffffffffu, row, 2);
    row |= __shfl_xor_sync(0xffffffffu, row, 4);
    if (e % 8 == 0 && e / 8 < rows) p.bits[tile * kTile + e / 8] = row;
  }
}

constexpr int kOrderItems = 8192;  // items ranked in shared memory

// One block: order[rank] = item (b * QB + qb, a block of 128 queries of
// row b), ranked by the number of key tiles live for one of its queries
// (the classes of its two 64-query tiles), the most first, ties by item.
// Past kOrderItems items the blocks keep their index order.
__global__ void __launch_bounds__(1024) k4_order_kernel(const Params p) {
  __shared__ int cnt_s[kOrderItems];
  const int items = p.B * p.QB;
  if (items > kOrderItems) {
    for (int it = threadIdx.x; it < items; it += blockDim.x) p.order[it] = it;
    return;
  }
  for (int it = threadIdx.x; it < items; it += blockDim.x) cnt_s[it] = 0;
  __syncthreads();
  for (long long e = threadIdx.x; e < (long long)items * p.NK; e += blockDim.x) {
    const int it = e / p.NK, j = e % p.NK, b = it / p.QB, qt = 2 * (it % p.QB);
    const uint8_t* c = p.cls + ((long long)b * p.QT + qt) * p.NK + j;
    if (c[0] != kDead || (qt + 1 < p.QT && c[p.NK] != kDead)) atomicAdd(&cnt_s[it], 1);
  }
  __syncthreads();
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int c = cnt_s[it];
    int rank = 0;
    for (int o = 0; o < items; ++o) {
      const int d = cnt_s[o];
      rank += d > c || (d == c && o < it);
    }
    p.order[rank] = it;
  }
}

template <int HP>
struct PrefillSmem {
  static constexpr int kQ = kBQ * HP * 2;        // HP / 64 chunks [128][64]
  static constexpr int kK = HP * kRow;           // K tile [HP][64 keys]
  static constexpr int kV = kTile * HP * 2;      // V: HP / 64 chunks [64][64]
  static constexpr int kStage = kK + kV;
  static constexpr int kBars = kQ + kStages * kStage;
  static constexpr int kCls = kBars + 128;       // [2][NK] class bytes
  static constexpr int kBytes = kCls + 1024;     // + 2 NK, and the alignment
};

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty,
                                          uint64_t* once) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(once, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

template <int HP>
__global__ void __launch_bounds__(kThreads, 1)
    k4_prefill_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = PrefillSmem<HP>;
  constexpr int CH = HP / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* q_bar = empty + kStages;
  uint8_t* cls_s = smem + L::kCls;  // [2][NK]: the block's two query tiles

  const int n = blockIdx.x, item = p.order[blockIdx.y];
  const int b = item / p.QB, qb = item % p.QB, q0 = qb * kBQ;
  const int rep = p.N / p.n_kv;
  const int kv = p.head_major ? (n / rep) * p.B + b : b * p.n_kv + n / rep;
  for (int e = threadIdx.x; e < 2 * p.NK; e += kThreads) {
    const int qt = 2 * qb + e / p.NK;
    cls_s[e] = qt < p.QT ? p.cls[((long long)b * p.QT + qt) * p.NK + e % p.NK]
                         : kDead;
  }
  init_ring(full, empty, q_bar);  // its barrier also publishes cls_s
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    // Producer: Q once, then the K and V tiles live for the block.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_bar, L::kQ);
      for (int c = 0; c < CH; ++c)
        tma_load(smem + c * kBQ * kRow, &tq, q_bar, c * 64, n, q0, b);
      int i = 0;
      for (int j = 0; j < p.NK; ++j) {
        if ((cls_s[j] | cls_s[p.NK + j]) == kDead) continue;
        const int s = i % kStages;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        uint8_t* st = smem + L::kQ + s * L::kStage;
        mbar_expect_tx(&full[s], L::kStage);
        tma_load_3d(st, &tk, &full[s], j * kTile, 0, kv);
        for (int c = 0; c < CH; ++c)
          tma_load_3d(st + L::kK + c * kTile * kRow, &tv, &full[s], c * 64,
                      j * kTile, kv);
        ++i;
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int wq0 = q0 + wg * 64;  // this warpgroup's queries
    const int qr[2] = {wq0 + warp * 16 + lane / 4, wq0 + warp * 16 + lane / 4 + 8};
    const uint8_t* my_cls = cls_s + wg * p.NK;
    const uint8_t* other_cls = cls_s + (1 - wg) * p.NK;
    const uint8_t* sq = smem + wg * 64 * kRow;

    float o[HP / 2];
    zero(o);
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    mbar_wait(q_bar, 0);

    // The key tiles the producer loads, in order.
    auto next_visit = [&](int j) {
      while (j < p.NK && (my_cls[j] | other_cls[j]) == kDead) ++j;
      return j;
    };
    // This warpgroup's rows of the pre-pass's bit words (mixed tiles).
    const uint64_t* my_bits = p.bits + ((long long)b * p.QT + wq0 / kTile) * p.NK * kTile;
    for (int i = 0, j = next_visit(0); j < p.NK; ++i, j = next_visit(j + 1)) {
      const uint8_t c = my_cls[j];
      const int s = i % kStages;
      const uint8_t* sk = smem + L::kQ + s * L::kStage;
      const uint8_t* sv = sk + L::kK;
      // One visited tile: S = Q K^T, the online softmax (exp2 of scores
      // pre-scaled by log2 e), O = alpha O + P V. kMasked (a mixed tile)
      // reads this thread's 32 pairs from its two rows' bit words; an
      // all-live tile has no per-element mask.
      auto step = [&](auto masked) {
        constexpr bool kMasked = int(decltype(masked)()) != 0;
        uint32_t live_bits = 0xffffffffu;
        if constexpr (kMasked) {
          const uint64_t* words = my_bits + (long long)j * kTile + warp * 16 + lane / 4;
          const uint64_t w0 = qr[0] < p.T ? words[0] : 0u;
          const uint64_t w1 = qr[1] < p.T ? words[8] : 0u;
          live_bits = 0u;
#pragma unroll
          for (int r = 0; r < 32; ++r)
            live_bits |= uint32_t(((r >> 1) & 1 ? w1 : w0) >> acc_col(r, lane) & 1u) << r;
        }
        mbar_wait(&full[s], (i / kStages) & 1);
        // S = Q K^T: K [HP][64 keys] is the MN-major B operand.
        float sc[32];
        zero(sc);
        fence_regs(sc);
        wgmma_fence();
        const uint32_t aq = desc_base(sq), bk = desc_base(sk);
        static_for<0, HP / 16>([&](auto kk) {
          constexpr int ka = (kk / 4) * kBQ * kRow + (kk % 4) * 32;  // K-major
          constexpr int kb = kk * 16 * kRow;                         // MN-major
          wgmma_ss_n64<0, 1, desc_off(ka, 16), desc_off(kb, L::kK)>(sc, aq, bk,
                                                                    kk > 0);
        });
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // Online softmax; a row's 64 keys lie on the 4 lanes of a quad.
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          sc[r] = cap_score(sc[r], p.cap, p.inv_cap);
          if constexpr (kMasked) sc[r] = (live_bits >> r) & 1u ? sc[r] : kNegInf;
          mx[(r >> 1) & 1] = fmaxf(mx[(r >> 1) & 1], sc[r]);
        }
        float alpha[2], m2[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          const float m_new = fmaxf(m[h], mx[h]);
          alpha[h] = exp2f((m[h] - m_new) * kLog2e);
          m[h] = m_new;
          m2[h] = m_new * kLog2e;
          l[h] *= alpha[h];
        }
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          const int h = (r >> 1) & 1;
          sc[r] = exp2f(fmaf(sc[r], kLog2e, -m2[h]));
          if constexpr (kMasked) sc[r] = (live_bits >> r) & 1u ? sc[r] : 0.f;
          l[h] += sc[r];  // this lane's share; the quad's sum at the end
        }
        uint32_t p_hi[4][4], p_lo[4][4];
        split_operand(sc, p_hi, p_lo);

        // O = alpha O + P_hi V + P_lo V.
        fence_regs(o);
#pragma unroll
        for (int r = 0; r < HP / 2; ++r) o[r] *= alpha[(r >> 1) & 1];
        fence_regs(o);
        wgmma_fence();
        const uint32_t bv = desc_base(sv);
        static_for<0, kTile / 16>([&](auto kk) {
          constexpr int kb = desc_off(kk * 16 * kRow, kTile * kRow);  // MN-major
          wgmma_rs<HP, kb>(o, p_hi[kk], bv);
          wgmma_rs<HP, kb>(o, p_lo[kk], bv);
        });
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
      };
      if (c == kMixed) {
        step(Int<1>());
      } else if (c == kLive) {
        step(Int<0>());
      } else {  // dead for this warpgroup, live for the other
        mbar_wait(&full[s], (i / kStages) & 1);
      }
      mbar_arrive(&empty[s]);
    }

    // out = O / max(l, 1e-30); raw (m, l) on request.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      if (p.m_out != nullptr && qr[h] < p.T && (lane & 3) == 0) {
        const long long at = ((long long)b * p.T + qr[h]) * p.N + n;
        p.m_out[at] = m[h];
        p.l_out[at] = l[h];
      }
      l[h] = fmaxf(l[h], 1e-30f);
    }
#pragma unroll
    for (int r = 0; r < HP / 2; r += 2) {
      const int h = (r >> 1) & 1, col = acc_col(r, lane);
      if (qr[h] >= p.T || col >= p.H) continue;
      const long long at = (((long long)b * p.T + qr[h]) * p.N + n) * p.H + col;
      *reinterpret_cast<__nv_bfloat162*>(p.out + at) =
          __floats2bfloat162_rn(o[r] / l[h], o[r + 1] / l[h]);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps and launches.
// ---------------------------------------------------------------------------

// A tensor map of `rank` dims (innermost first), bf16, zero-filled out of
// bounds; byte strides of dims 1.. in `strides`.
bool encode(CUtensorMap* map, const void* base, int rank,
            const cuuint64_t* dims, const cuuint64_t* strides,
            const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Decode: k [rows, H, S] in [64 keys, H, 1] boxes and v [rows, S, H] in
// [H, 64 keys, 1] boxes, not swizzled (the CUDA cores read them row-major).
bool encode_decode_maps(CUtensorMap* maps, const Params& p) {
  const cuuint64_t rows = cuuint64_t(p.B) * p.n_kv, H = p.H, S = p.S;
  const cuuint64_t k_dims[3] = {S, H, rows}, k_bytes[2] = {S * 2, H * S * 2};
  const cuuint32_t k_box[3] = {kTile, cuuint32_t(H), 1};
  const cuuint64_t v_dims[3] = {H, S, rows}, v_bytes[2] = {H * 2, S * H * 2};
  const cuuint32_t v_box[3] = {cuuint32_t(H), kTile, 1};
  return encode(&maps[0], p.k, 3, k_dims, k_bytes, k_box,
                CU_TENSOR_MAP_SWIZZLE_NONE) &&
         encode(&maps[1], p.v, 3, v_dims, v_bytes, v_box,
                CU_TENSOR_MAP_SWIZZLE_NONE);
}

// Prefill: q [B, T, N, H] in [64 dims, 1, 128 queries, 1] boxes; k [rows,
// H, S] in [64 keys, HP dims, 1] boxes; v [rows, S, H] in [64 dims, 64
// keys, 1]; 128-byte swizzled (wgmma's operand layout).
bool encode_prefill_maps(CUtensorMap* maps, const Params& p, int HP) {
  const cuuint64_t rows = cuuint64_t(p.B) * p.n_kv, H = p.H, S = p.S;
  const cuuint64_t q_dims[4] = {H, cuuint64_t(p.N), cuuint64_t(p.T),
                                cuuint64_t(p.B)};
  const cuuint64_t q_bytes[3] = {cuuint64_t(p.q_sn) * 2, cuuint64_t(p.q_st) * 2,
                                 cuuint64_t(p.q_sb) * 2};
  const cuuint32_t q_box[4] = {64, 1, kBQ, 1};
  const cuuint64_t k_dims[3] = {S, H, rows}, k_bytes[2] = {S * 2, H * S * 2};
  const cuuint32_t k_box[3] = {kTile, cuuint32_t(HP), 1};
  const cuuint64_t v_dims[3] = {H, S, rows}, v_bytes[2] = {H * 2, S * H * 2};
  const cuuint32_t v_box[3] = {64, kTile, 1};
  return encode(&maps[0], p.q, 4, q_dims, q_bytes, q_box,
                CU_TENSOR_MAP_SWIZZLE_128B) &&
         encode(&maps[1], p.k, 3, k_dims, k_bytes, k_box,
                CU_TENSOR_MAP_SWIZZLE_128B) &&
         encode(&maps[2], p.v, 3, v_dims, v_bytes, v_box,
                CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int HP>
int launch_prefill(const CUtensorMap* maps, const Params& p,
                   cudaStream_t stream) {
  const long long tiles = (long long)p.B * p.QT * p.NK;
  k4_mask_tiles_kernel<<<unsigned((tiles + 7) / 8), 256, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  k4_order_kernel<<<1, 1024, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int smem = PrefillSmem<HP>::kBytes + 2 * p.NK;
  err = cudaFuncSetAttribute(k4_prefill_kernel<HP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  k4_prefill_kernel<HP><<<dim3(p.N, p.B * p.QB), kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], p);
  return int(cudaGetLastError());
}

template <int MR>
int launch_decode(const CUtensorMap* maps, const Params& p,
                  cudaStream_t stream) {
  const int M = p.T * (p.N / p.n_kv);
  const int smem = dec_smem_bytes(p.H, p.T, M, dec_stages(p.split_tiles));
  cudaError_t err = cudaFuncSetAttribute(
      k4_decode_split_kernel<MR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return int(err);
  k4_decode_split_kernel<MR>
      <<<dim3(p.B * p.n_kv, p.splits), kDecThreads, smem, stream>>>(
          maps[0], maps[1], p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.B * p.T * p.N);
  cfg.blockDim = dim3(kMergeThreads);
  cfg.stream = stream;
  cudaLaunchAttribute dependent[1];
  dependent[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  dependent[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = dependent;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, k4_decode_merge_kernel, p);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* mask, void* out, void* m_out, void* l_out,
                   long long q_sb, long long q_st, long long q_sn, int B,
                   int T, int N, int n_kv, int H, int S, int head_major,
                   float cap) {
  Params p = {};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.mask = static_cast<const uint8_t*>(mask);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.m_out = static_cast<float*>(m_out);
  p.l_out = static_cast<float*>(l_out);
  p.q_sb = q_sb;
  p.q_st = q_st;
  p.q_sn = q_sn;
  p.B = B;
  p.T = T;
  p.N = N;
  p.n_kv = n_kv;
  p.H = H;
  p.S = S;
  p.head_major = head_major;
  p.cap = cap;
  p.inv_cap = cap > 0.f ? 1.f / cap : 0.f;
  return p;
}

bool valid(const Params& p) {
  return p.B >= 1 && p.T >= 1 && p.n_kv >= 1 && p.N % p.n_kv == 0 &&
         p.H >= 8 && p.H <= 128 && p.H % 8 == 0 && p.S >= 8 && p.S % 8 == 0 &&
         (p.m_out == nullptr) == (p.l_out == nullptr);
}

}  // namespace

// Decode regime (T * N / n_kv <= 16 query rows per kv row): split-S over
// ceil(S / (64 * split_tiles)) splits, then the merge. part_acc: f32
// [splits, B*T*N, H]; part_ml: f32 [splits, B*T*N, 2]. m_out / l_out: f32
// [B, T, N] or both null. Returns a cudaError_t (0 = launched), or -1 when
// a tensor map cannot be encoded (bases 16-byte aligned).
extern "C" int automl_decode_attention_sm90_decode(
    const void* q, const void* k, const void* v, const void* mask, void* out,
    void* m_out, void* l_out, void* part_acc, void* part_ml, long long q_sb,
    long long q_st, long long q_sn, int B, int T, int N, int n_kv, int H,
    int S, int head_major, int split_tiles, float cap, void* stream) {
  cudaGetLastError();  // clear an earlier, unrelated error
  Params p = make_params(q, k, v, mask, out, m_out, l_out, q_sb, q_st, q_sn,
                         B, T, N, n_kv, H, S, head_major, cap);
  const int rows = n_kv >= 1 && N % n_kv == 0 ? T * (N / n_kv) : 0;
  if (!valid(p) || rows < 1 || rows > kDecMaxRows || split_tiles < 1 ||
      split_tiles > kDecMaxTiles)
    return int(cudaErrorInvalidValue);
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float*>(part_ml);
  p.split_tiles = split_tiles;
  p.splits = ((S + kTile - 1) / kTile + split_tiles - 1) / split_tiles;
  CUtensorMap maps[2];
  if (!encode_decode_maps(maps, p)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 1) return launch_decode<1>(maps, p, s);
  if (rows <= 2) return launch_decode<2>(maps, p, s);
  if (rows <= 4) return launch_decode<4>(maps, p, s);
  if (rows <= 8) return launch_decode<8>(maps, p, s);
  return launch_decode<16>(maps, p, s);
}

// Prefill regime (more than 16 query rows per kv row). cls: uint8
// [B, ceil(T / 64), ceil(S / 64)]; bits: 64-bit [B, ceil(T / 64),
// ceil(S / 64), 64]; order: int32 [B * ceil(T / 128)].
// Returns a cudaError_t (0 = launched), or -1 when a tensor map cannot be
// encoded (q's strides must be multiples of 8 elements; bases 16-byte
// aligned).
extern "C" int automl_decode_attention_sm90_prefill(
    const void* q, const void* k, const void* v, const void* mask, void* out,
    void* m_out, void* l_out, void* cls, void* bits, void* order, long long q_sb,
    long long q_st, long long q_sn, int B, int T, int N, int n_kv, int H,
    int S, int head_major, float cap, void* stream) {
  cudaGetLastError();
  Params p = make_params(q, k, v, mask, out, m_out, l_out, q_sb, q_st, q_sn,
                         B, T, N, n_kv, H, S, head_major, cap);
  if (!valid(p)) return int(cudaErrorInvalidValue);
  p.cls = static_cast<uint8_t*>(cls);
  p.bits = static_cast<uint64_t*>(bits);
  p.order = static_cast<int*>(order);
  p.QT = (T + kTile - 1) / kTile;
  p.QB = (T + kBQ - 1) / kBQ;
  p.NK = (S + kTile - 1) / kTile;
  if ((long long)p.B * p.QB > 65535) return int(cudaErrorInvalidValue);
  const int HP = H <= 64 ? 64 : 128;
  CUtensorMap maps[3];
  if (!encode_prefill_maps(maps, p, HP)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return HP == 64 ? launch_prefill<64>(maps, p, s) : launch_prefill<128>(maps, p, s);
}
