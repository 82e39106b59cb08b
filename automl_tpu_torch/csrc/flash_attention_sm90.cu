// Flash attention for bf16 on Hopper (sm_90a): the forward (K1), the fused
// backward (K2) and the split backward (K5a, K5b) on bf16 tensor cores
// (wgmma), fed by TMA.
//
// Replaces the Pallas kernels of automl_tpu/ops/attention.py for bf16
// inputs with head dims up to 128 (a multiple of 8):
//   * automl_flash_fwd_sm90 replaces _fwd_kernel (launched by
//     _flash_fwd_pallas): out = softmax(mask(cap(sm_scale * q k^T))) v and
//     lse = the row logsumexp, online over key tiles;
//   * automl_flash_bwd_sm90 replaces _bwd_fused_kernel (launched by
//     _flash_bwd_fused_pallas): one recompute of s, p, dp and ds per
//     (q tile, k tile) gives dq, dk and dv;
//   * automl_flash_bwd_dq_sm90 replaces _bwd_dq_kernel and
//     automl_flash_bwd_dkv_sm90 _bwd_dkv_kernel (both launched by
//     _flash_bwd_pallas): dq = sm_scale * sum_k ds k, and dk = sm_scale *
//     sum_q ds^T q, dv = sum_q p^T g, each kernel recomputing s, p, dp, ds.
// float32 inputs keep the scalar-FMA kernels of flash_attention.cu. The
// interface is theirs: q, k, v, g [B, T, N, H] through their strides (unit
// H stride, the others multiples of 8 elements, 16-byte aligned bases: what
// a TMA descriptor takes); out, dq (K5a), dk, dv contiguous [B, T, N, H];
// lse f32 [B*N, T] (row b*N + n); segment ids int32 [B, T]; K2's dq in f32
// [B*N, Tp / 64, HP / 64, 64, 64] blocks (the caller zeroes and reorders
// it). The backward kernels read lse and delta = rowsum(g * out) from f32
// [B*N, Tp] buffers, zero-padded to Tp = T rounded up to a q tile (64 for
// K2; 128, K5a's q tile, for K5a and K5b, which share one pair of buffers),
// so that each q tile's values are one bulk copy. Masks: causal, sliding
// window (q - k < window), the sequence end and equal segment ids; a masked
// key scores -1e30 and gets an explicit p = 0.
//
// Precision contract (that of the TPU kernels and of flash_attention.cu):
// s = q k^T and dp = g v^T are exact products of the bf16 operands summed in
// f32 (bf16 wgmma with f32 accumulators); sm_scale multiplies the f32
// result. The f32 products p v (K1), p^T g, ds^T q, ds k (K2, K5a, K5b) have
// one f32 operand, p or ds: it is split as x = hi + lo, hi = bf16(x), lo =
// bf16(x - hi), and both halves go through wgmma into one f32 accumulator,
// so the operand keeps about 16 bits of mantissa (relative error near
// 2^-17) where rounding p to bf16 once would keep 8.
//
// Bound on this card, at the LM slice's shapes (B 8, T 2048, N 8, H 128,
// causal): the forward's 2 products are 68.7 GFLOP, the backward's 5 are
// 172 GFLOP, K5a's 3 103 GFLOP and K5b's 4 138 GFLOP, 0.070 / 0.174 / 0.104
// / 0.139 ms at the bf16 tensor-core peak of 989 TFLOP/s (bound by
// operations: the bytes take at most 0.08 ms at 3.35 TB/s). The split costs
// the forward 3 product-units of tensor-core work instead of 2, the
// backward 8 instead of 5, K5a 4 instead of 3 and K5b 6 instead of 4; the
// bound stays that of the work asked.
//
// Design. One block is three warpgroups: two consumer warpgroups that run
// wgmma (240 registers a thread, setmaxnreg) and a producer warpgroup (24
// registers) whose first thread keeps TMA loads in flight into a two-stage
// ring of shared-memory tiles guarded by mbarriers (full: the tile landed;
// empty: both consumers are done with it). Tiles are 64 columns of H wide
// (128 bytes), 128-byte swizzled by TMA, which also zero-fills head dims
// past H and rows past T.
//   K1: a block owns 128 queries of one (b, n), 64 per consumer, and loops
//   over the live 64-key tiles. S = Q K^T (A = q, B = k, both K-major in
//   shared memory), the online softmax in registers, O += P V with P's hi
//   and lo halves from registers (the accumulator layout is the A-operand
//   layout) and V read MN-major (wgmma transposes it). A consumer skips a
//   tile that causality or the window leave dead for all its rows.
//   K5a: K1's grid, tile order and dead-tile skipping. The block's Q and G
//   tiles and its 128 lse and delta values are loaded once; K and V tiles
//   stream through the ring. Per live tile a consumer computes S = Q K^T
//   and dP = G V^T (SS, K-major), p and ds in registers, and dq += ds K
//   with ds's hi and lo halves from registers and K read MN-major (as K1
//   reads V). dq stays in f32 registers over the key tiles and is written
//   once: no atomics, the same result from run to run.
//   K2: a block owns 128 keys of one (b, n), 64 per consumer, and loops
//   over the live 64-query tiles with dk and dv in f32 registers (FA3's
//   structure). S^T = K Q^T and dP^T = V G^T put p^T and ds^T in registers;
//   their hi and lo halves go to shared memory, swizzled [key][query], as
//   the K-major A operands of dv += p^T G and dk += ds^T Q (B = g, q
//   MN-major), and ds^T, read MN-major, as the A of dq = ds K, which each
//   consumer computes for 64 of the head dims. Holding p and ds in shared
//   memory and not as register operands keeps a consumer at dk + dv + s + dp
//   = 192 accumulator registers. dq is summed over key tiles into an f32
//   buffer of [64 queries, 64 head dims] blocks by one bulk f32 add (TMA,
//   performed in L2) per block and q tile, in a fixed order
//   (wait_for_turn), so two calls are bit-equal.
//   K5b: K2 without its dq half (kDq = false): no dq product, no f32 dq
//   buffer, no turns; each consumer reads only its own 64 rows of p^T and
//   ds^T, so the two consumers never wait on each other, and no block waits
//   on another. dk and dv are written once.
// Dead tiles are not visited; blocks with the most tiles are issued first;
// a tile whose pairs are all live skips the masks.
//
// Plain C interface, loaded with ctypes (automl_tpu_torch/ops/cuda_build.py).
// The tensor maps are encoded per call on the host (cuTensorMapEncodeTiled,
// looked up through the CUDA runtime: no libcuda link) and passed as
// __grid_constant__ kernel parameters. The kernels allocate nothing; the launchers return a
// cudaError_t, or -1 when a tensor map cannot be encoded.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

constexpr int kThreads = 384;      // consumer warpgroups 0, 1; producer 2
constexpr int kConsumers = 256;
constexpr int kStages = 2;
constexpr float kNegInf = -1e30f;  // the TPU kernels' NEG_INF
constexpr int kFwdBQ = 128, kFwdBK = 64;
constexpr int kBwdBK = 128, kBwdBQ = 64;

struct Params {
  const int* seg;         // [B, T] or null
  void* out;              // K1: [B, T, N, H]
  float* lse;             // K1: [B*N, T]
  const float* lse_p;     // K2, K5a, K5b: [B*N, Tp]
  const float* delta_p;   // K2, K5a, K5b: [B*N, Tp]
  float* dq32;            // K2: [B*N, Tp / 64, HP / 64, 64, 64] f32, zeroed
  int* dq_turn;           // K2: [B*N, Tp / 64], zeroed by the caller
  void* dq;               // K5a: [B, T, N, H]
  void *dk, *dv;          // K2, K5b: [B, T, N, H]
  int B, T, N, H, Tp;
  int causal;
  int window;             // < 0: no window
  float cap;              // 0: no cap
  float scale;
};

__device__ __forceinline__ float capped(float s, float cap, float* dcap) {
  if (cap > 0.f) {
    const float th = tanhf(s / cap);
    *dcap = 1.f - th * th;
    return cap * th;
  }
  *dcap = 1.f;
  return s;
}

__device__ __forceinline__ bool live(int qp, int kp, const Params& p,
                                     const int* seg) {
  if (qp >= p.T || kp >= p.T) return false;
  if (p.causal && qp < kp) return false;
  if (p.window >= 0 && qp - kp >= p.window) return false;
  if (seg != nullptr && seg[qp] != seg[kp]) return false;
  return true;
}


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

// ---------------------------------------------------------------------------
// K1: the forward.
// ---------------------------------------------------------------------------

template <int HP>
struct FwdSmem {
  static constexpr int kQ = kFwdBQ * HP * 2;      // HP / 64 chunks [BQ][64]
  static constexpr int kKV = kFwdBK * HP * 2;     // K or V: chunks [BK][64]
  static constexpr int kStage = 2 * kKV;          // K then V
  static constexpr int kBars = kQ + kStages * kStage;
  static constexpr int kBytes = kBars + 64 + 1024;  // barriers, alignment
};

template <int HP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const Params p) {
  using L = FwdSmem<HP>;
  constexpr int BQ = kFwdBQ, BK = kFwdBK, CH = HP / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* q_bar = empty + kStages;
  init_ring(full, empty, q_bar);

  const int bn = blockIdx.y, b = bn / p.N, n = bn % p.N;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest rows first
  // Key tiles that hold a live key for some query of this block.
  const int k_end = p.causal ? min(p.T, q0 + BQ) : p.T;
  const int k_begin = p.window >= 0 ? max(0, q0 - p.window + 1) / BK * BK : 0;
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    // Producer: Q once, then K and V tiles through the ring.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_bar, L::kQ);
      for (int c = 0; c < CH; ++c)
        tma_load(smem + c * BQ * kRow, &tq, q_bar, c * 64, n, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        uint8_t* sk = smem + L::kQ + s * L::kStage;
        mbar_expect_tx(&full[s], L::kStage);
        const int k0 = k_begin + j * BK;
        for (int c = 0; c < CH; ++c) {
          tma_load(sk + c * BK * kRow, &tk, &full[s], c * 64, n, k0, b);
          tma_load(sk + L::kKV + c * BK * kRow, &tv, &full[s], c * 64, n, k0,
                   b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int wq0 = q0 + wg * 64;                      // this warpgroup's rows
    const int qr[2] = {wq0 + warp * 16 + lane / 4, wq0 + warp * 16 + lane / 4 + 8};
    const int* seg = p.seg != nullptr ? p.seg + (long long)b * p.T : nullptr;
    const uint8_t* sq = smem + wg * 64 * kRow;

    float o[HP / 2];
    zero(o);
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    mbar_wait(q_bar, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const int k0 = k_begin + j * BK;
      const uint8_t* sk = smem + L::kQ + s * L::kStage;
      const uint8_t* sv = sk + L::kKV;
      mbar_wait(&full[s], (j / kStages) & 1);
      const bool dead = wq0 >= p.T || (p.causal && k0 > wq0 + 63) ||
                        (p.window >= 0 && wq0 - (k0 + BK - 1) >= p.window);
      // Every (query, key) pair of this warpgroup's tile is live: no masks.
      const bool all_live =
          seg == nullptr && wq0 + 63 < p.T && k0 + BK - 1 < p.T &&
          (!p.causal || k0 + BK - 1 <= wq0) &&
          (p.window < 0 || wq0 + 63 - k0 < p.window);
      if (!dead) {
        // S = Q K^T over HP / 16 k16 steps.
        float sc[32];
        zero(sc);
        fence_regs(sc);
        wgmma_fence();
        const uint32_t aq = desc_base(sq), bk = desc_base(sk);
        static_for<0, HP / 16>([&](auto kk) {
          // K-major: chunk kk / 4 of 64 head dims, 32 bytes per k16 step.
          constexpr int ka = (kk / 4) * BQ * kRow + (kk % 4) * 32;
          constexpr int kb = (kk / 4) * BK * kRow + (kk % 4) * 32;
          wgmma_ss_n64<0, 0, desc_off(ka, 16), desc_off(kb, 16)>(sc, aq, bk,
                                                                 kk > 0);
        });
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // Online softmax; a row's 64 keys lie on the 4 lanes of a quad.
        uint32_t live_bits = 0;
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          const int h = (r >> 1) & 1;
          float dcap;
          const float x = capped(p.scale * sc[r], p.cap, &dcap);
          const bool ok =
              all_live || live(qr[h], k0 + acc_col(r, lane), p, seg);
          live_bits |= uint32_t(ok) << r;
          sc[r] = ok ? x : kNegInf;
          mx[h] = fmaxf(mx[h], sc[r]);
        }
        float alpha[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          const float m_new = fmaxf(m[h], mx[h]);
          alpha[h] = expf(m[h] - m_new);
          m[h] = m_new;
          l[h] *= alpha[h];
        }
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          const int h = (r >> 1) & 1;
          sc[r] = (live_bits >> r) & 1 ? expf(sc[r] - m[h]) : 0.f;
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
        static_for<0, BK / 16>([&](auto kk) {
          constexpr int kb = desc_off(kk * 16 * kRow, BK * kRow);  // MN-major
          wgmma_rs<HP, kb>(o, p_hi[kk], bv);
          wgmma_rs<HP, kb>(o, p_lo[kk], bv);
        });
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
      }
      mbar_arrive(&empty[s]);
    }

    // out = O / l (q's dtype), lse = m + log(l).
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      l[h] = fmaxf(l[h], 1e-30f);
      if (qr[h] < p.T && (lane & 3) == 0)
        p.lse[(long long)bn * p.T + qr[h]] = m[h] + logf(l[h]);
    }
#pragma unroll
    for (int r = 0; r < HP / 2; r += 2) {
      const int h = (r >> 1) & 1, col = acc_col(r, lane);
      if (qr[h] >= p.T || col >= p.H) continue;
      const long long at = (((long long)b * p.T + qr[h]) * p.N + n) * p.H + col;
      *reinterpret_cast<__nv_bfloat162*>(out + at) =
          __floats2bfloat162_rn(o[r] / l[h], o[r + 1] / l[h]);
    }
  }
}

// ---------------------------------------------------------------------------
// K5a: the split backward's dq.
// ---------------------------------------------------------------------------

template <int HP>
struct DqSmem {
  static constexpr int kQG = kFwdBQ * HP * 2;     // Q or G: chunks [BQ][64]
  static constexpr int kStats = kFwdBQ * 4;       // lse or delta
  static constexpr int kKV = kFwdBK * HP * 2;     // K or V: chunks [BK][64]
  static constexpr int kStage = 2 * kKV;          // K then V
  static constexpr int kOnce = 2 * kQG + 2 * kStats;  // Q, G, lse, delta
  static constexpr int kRing = kOnce;             // a multiple of 1024
  static constexpr int kBars = kRing + kStages * kStage;
  static constexpr int kBytes = kBars + 64 + 1024;
};

template <int HP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tg,
                             const Params p) {
  using L = DqSmem<HP>;
  constexpr int BQ = kFwdBQ, BK = kFwdBK, CH = HP / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* once_bar = empty + kStages;
  init_ring(full, empty, once_bar);
  const float* lse_s = reinterpret_cast<const float*>(smem + 2 * L::kQG);
  const float* delta_s = lse_s + BQ;

  const int bn = blockIdx.y, b = bn / p.N, n = bn % p.N;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest rows first
  // Key tiles that hold a live key for some query of this block.
  const int k_end = p.causal ? min(p.T, q0 + BQ) : p.T;
  const int k_begin = p.window >= 0 ? max(0, q0 - p.window + 1) / BK * BK : 0;
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    // Producer: Q, G, lse and delta once, then K and V tiles through the
    // ring.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(once_bar, L::kOnce);
      for (int c = 0; c < CH; ++c) {
        tma_load(smem + c * BQ * kRow, &tq, once_bar, c * 64, n, q0, b);
        tma_load(smem + L::kQG + c * BQ * kRow, &tg, once_bar, c * 64, n, q0,
                 b);
      }
      const long long at = (long long)bn * p.Tp + q0;
      bulk_load(smem + 2 * L::kQG, p.lse_p + at, L::kStats, once_bar);
      bulk_load(smem + 2 * L::kQG + L::kStats, p.delta_p + at, L::kStats,
                once_bar);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        uint8_t* sk = smem + L::kRing + s * L::kStage;
        mbar_expect_tx(&full[s], L::kStage);
        const int k0 = k_begin + j * BK;
        for (int c = 0; c < CH; ++c) {
          tma_load(sk + c * BK * kRow, &tk, &full[s], c * 64, n, k0, b);
          tma_load(sk + L::kKV + c * BK * kRow, &tv, &full[s], c * 64, n, k0,
                   b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int wq0 = q0 + wg * 64;                      // this warpgroup's rows
    const int row = wg * 64 + warp * 16 + lane / 4;    // in the block
    const int qr[2] = {q0 + row, q0 + row + 8};
    const int* seg = p.seg != nullptr ? p.seg + (long long)b * p.T : nullptr;
    const uint32_t aq = desc_base(smem + wg * 64 * kRow);
    const uint32_t ag = desc_base(smem + L::kQG + wg * 64 * kRow);

    float dq[HP / 2];
    zero(dq);
    mbar_wait(once_bar, 0);
    const float lse[2] = {lse_s[row], lse_s[row + 8]};
    const float delta[2] = {delta_s[row], delta_s[row + 8]};

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const int k0 = k_begin + j * BK;
      const uint8_t* sk = smem + L::kRing + s * L::kStage;
      mbar_wait(&full[s], (j / kStages) & 1);
      const bool dead = wq0 >= p.T || (p.causal && k0 > wq0 + 63) ||
                        (p.window >= 0 && wq0 - (k0 + BK - 1) >= p.window);
      // Every (query, key) pair of this warpgroup's tile is live: no masks.
      const bool all_live =
          seg == nullptr && wq0 + 63 < p.T && k0 + BK - 1 < p.T &&
          (!p.causal || k0 + BK - 1 <= wq0) &&
          (p.window < 0 || wq0 + 63 - k0 < p.window);
      if (!dead) {
        // S = Q K^T and dP = G V^T over HP / 16 k16 steps.
        float sc[32], dp[32];
        zero(sc);
        zero(dp);
        fence_regs(sc);
        fence_regs(dp);
        wgmma_fence();
        const uint32_t bk = desc_base(sk), bv = desc_base(sk + L::kKV);
        static_for<0, HP / 16>([&](auto kk) {
          // K-major: chunk kk / 4 of 64 head dims, 32 bytes per k16 step.
          constexpr int ka = desc_off((kk / 4) * BQ * kRow + (kk % 4) * 32, 16);
          constexpr int kb = desc_off((kk / 4) * BK * kRow + (kk % 4) * 32, 16);
          wgmma_ss_n64<0, 0, ka, kb>(sc, aq, bk, kk > 0);
          wgmma_ss_n64<0, 0, ka, kb>(dp, ag, bv, kk > 0);
        });
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
        fence_regs(dp);

        // p = exp(s - lse) and ds = p (dp - delta) dcap on live pairs, 0
        // elsewhere; ds in sc.
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          const int h = (r >> 1) & 1;
          float dcap;
          const float x = capped(p.scale * sc[r], p.cap, &dcap);
          const bool ok =
              all_live || live(qr[h], k0 + acc_col(r, lane), p, seg);
          const float pv = ok ? expf(x - lse[h]) : 0.f;
          sc[r] = pv * (dp[r] - delta[h]) * dcap;
        }
        uint32_t ds_hi[4][4], ds_lo[4][4];
        split_operand(sc, ds_hi, ds_lo);

        // dq += ds_hi K + ds_lo K, K read MN-major (sm_scale at the end).
        fence_regs(dq);
        wgmma_fence();
        static_for<0, BK / 16>([&](auto kk) {
          constexpr int kb = desc_off(kk * 16 * kRow, BK * kRow);  // MN-major
          wgmma_rs<HP, kb>(dq, ds_hi[kk], bk);
          wgmma_rs<HP, kb>(dq, ds_lo[kk], bk);
        });
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dq);
      }
      mbar_arrive(&empty[s]);
    }

    // dq = sm_scale * dq, in q's dtype, written once.
    __nv_bfloat16* dq_out = static_cast<__nv_bfloat16*>(p.dq);
#pragma unroll
    for (int r = 0; r < HP / 2; r += 2) {
      const int h = (r >> 1) & 1, col = acc_col(r, lane);
      if (qr[h] >= p.T || col >= p.H) continue;
      const long long at = (((long long)b * p.T + qr[h]) * p.N + n) * p.H + col;
      *reinterpret_cast<__nv_bfloat162*>(dq_out + at) =
          __floats2bfloat162_rn(p.scale * dq[r], p.scale * dq[r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// K2: the fused backward, and K5b: the split backward's dk and dv.
// ---------------------------------------------------------------------------

// The order of dq's sum: dq of one q tile is summed over the key tiles that
// visit it in a fixed order (the last key tile first), so that dq is the same
// bit for bit from run to run. The consumers of a block wait until the q
// tile's counter equals their rank, add their part with atomics (performed
// in L2), and pass the turn on. Blocks run in any order, but the hardware
// hands them out by block index, and the last key tile of a row has the
// lowest index: a block waits only on blocks already running or done (the
// grid is not persistent, and a block's producer never waits on another
// block), so it cannot deadlock. Under causal masking a block trails the
// next key tile's block by two q tiles and seldom waits.
__device__ __forceinline__ void wait_for_turn(int* turn, int rank) {
  if (threadIdx.x == 0) {
    while (atomicAdd(turn, 0) != rank) __nanosleep(64);
    __threadfence();
  }
  consumers_sync();
}

// The barrier orders both consumers' dq atomics before thread 0's fence, and
// the fence (cumulative) makes them visible before the turn moves.
__device__ __forceinline__ void pass_turn(int* turn) {
  consumers_sync();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(turn, 1);
  }
}

template <int HP>
struct BwdSmem {
  static constexpr int kKV = kBwdBK * HP * 2;     // K or V: chunks [BK][64]
  static constexpr int kQG = kBwdBQ * HP * 2;     // Q or G: chunks [BQ][64]
  static constexpr int kStats = kBwdBQ * 4;       // lse or delta
  static constexpr int kTx = 2 * kQG + 2 * kStats;  // a stage's bytes
  static constexpr int kStage = (kTx + 1023) / 1024 * 1024;
  static constexpr int kPs = kBwdBK * kBwdBQ * 2;  // p^T or ds^T, hi or lo
  static constexpr int kRing = 2 * kKV;
  static constexpr int kPsAt = kRing + kStages * kStage;
  static constexpr int kBars = kPsAt + 4 * kPs;
  static constexpr int kBytes = kBars + 64 + 1024;
};

// kDq: K2 (dq, dk, dv); without it K5b (dk, dv).
template <int HP, bool kDq>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tg,
                          const Params p) {
  using L = BwdSmem<HP>;
  constexpr int BQ = kBwdBQ, BK = kBwdBK, CH = HP / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* kv_bar = empty + kStages;
  init_ring(full, empty, kv_bar);
  uint8_t* sk = smem;
  uint8_t* sv = smem + L::kKV;

  const int bn = blockIdx.y, b = bn / p.N, n = bn % p.N;
  // K2: the last key tile gets the lowest block index (see wait_for_turn).
  // K5b: the first key tile, which has the most q tiles under causality,
  // does.
  const int n_kt = gridDim.x, kt = kDq ? n_kt - 1 - blockIdx.x : blockIdx.x;
  const int k0 = kt * BK;
  // Query tiles that hold a live query for some key of this block.
  const int q_begin = p.causal ? k0 : 0;  // BK is a multiple of BQ
  const int q_end = p.window >= 0 ? min(p.T, min(k0 + BK, p.T) - 1 + p.window)
                                  : p.T;
  const int n_tiles = max(0, (q_end - q_begin + BQ - 1) / BQ);
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    // Producer: K and V once, then Q, G, lse and delta tiles through the ring.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(kv_bar, L::kRing);
      for (int c = 0; c < CH; ++c) {
        tma_load(sk + c * BK * kRow, &tk, kv_bar, c * 64, n, k0, b);
        tma_load(sv + c * BK * kRow, &tv, kv_bar, c * 64, n, k0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        const int q0 = q_begin + j * BQ;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        uint8_t* st = smem + L::kRing + s * L::kStage;
        mbar_expect_tx(&full[s], L::kTx);
        for (int c = 0; c < CH; ++c) {
          tma_load(st + c * BQ * kRow, &tq, &full[s], c * 64, n, q0, b);
          tma_load(st + L::kQG + c * BQ * kRow, &tg, &full[s], c * 64, n, q0,
                   b);
        }
        const long long at = (long long)bn * p.Tp + q0;
        bulk_load(st + 2 * L::kQG, p.lse_p + at, L::kStats, &full[s]);
        bulk_load(st + 2 * L::kQG + L::kStats, p.delta_p + at, L::kStats,
                  &full[s]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int lane = threadIdx.x % 32;
    const int row = threadIdx.x / 32 * 16 + lane / 4;  // key row in the block
    const int wk0 = k0 + wg * 64;  // this warpgroup's first key
    const int kr[2] = {k0 + row, k0 + row + 8};
    const int* seg = p.seg != nullptr ? p.seg + (long long)b * p.T : nullptr;
    // Shared-memory addresses: d0 = desc_base(smem); the warpgroup's key
    // rows as a descriptor offset; ps: p^T hi, p^T lo, ds^T hi, ds^T lo.
    const uint32_t sm = smem_u32(smem), d0 = sm >> 4;
    const uint32_t rows = wg * 64 * kRow / 16;
    const uint32_t ps = sm + L::kPsAt;

    float dk[HP / 2], dv[HP / 2];
    zero(dk);
    zero(dv);
    mbar_wait(kv_bar, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const int q0 = q_begin + j * BQ;
      const float* lse_s =
          reinterpret_cast<const float*>(smem + L::kRing + s * L::kStage + 2 * L::kQG);
      const float* delta_s = lse_s + BQ;
      const uint32_t bq = d0 + (L::kRing + s * L::kStage) / 16;  // q tile
      const uint32_t bg = bq + L::kQG / 16;                       // g tile
      // Every (query, key) pair of this warpgroup's tile is live: no masks.
      const bool all_live =
          seg == nullptr && wk0 + 63 < p.T && q0 + 63 < p.T &&
          (!p.causal || q0 >= wk0 + 63) &&
          (p.window < 0 || q0 + 63 - wk0 < p.window);
      mbar_wait(&full[s], (j / kStages) & 1);

      // S^T = K Q^T and dP^T = V G^T: rows are this warpgroup's keys,
      // columns the tile's queries.
      float st[32], dpt[32];
      zero(st);
      zero(dpt);
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
      static_for<0, HP / 16>([&](auto kk) {
        constexpr int ka = desc_off((kk / 4) * BK * kRow + (kk % 4) * 32, 16);
        constexpr int kb = desc_off((kk / 4) * BQ * kRow + (kk % 4) * 32, 16);
        wgmma_ss_n64<0, 0, ka, kb>(st, d0 + rows, bq, kk > 0);
        wgmma_ss_n64<0, 0, ka, kb>(dpt, d0 + L::kKV / 16 + rows, bg, kk > 0);
      });
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      // p^T = exp(s - lse) and ds^T = p^T (dp^T - delta) dcap on live
      // pairs; their hi and lo halves into shared memory (swizzled
      // [key][query]) once the warpgroups that read them (K2: both, for
      // dq; K5b: this one) are done with the previous tile's.
      if constexpr (kDq)
        consumers_sync();
      else
        warpgroup_sync(wg);
#pragma unroll
      for (int r = 0; r < 32; r += 2) {
        float pv[2], dsv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = acc_col(r + e, lane);
          float dcap;
          const float x = capped(p.scale * st[r + e], p.cap, &dcap);
          const bool ok =
              all_live || live(q0 + col, kr[((r + e) >> 1) & 1], p, seg);
          pv[e] = ok ? expf(x - lse_s[col]) : 0.f;
          dsv[e] = pv[e] * (dpt[r + e] - delta_s[col]) * dcap;
        }
        const uint32_t at = ps + swizzled(row + 8 * ((r >> 1) & 1), acc_col(r, lane));
        uint32_t hi, lo;
        split_pair(pv[0], pv[1], &hi, &lo);
        st_shared(at, hi);
        st_shared(at + L::kPs, lo);
        split_pair(dsv[0], dsv[1], &hi, &lo);
        st_shared(at + 2 * L::kPs, hi);
        st_shared(at + 3 * L::kPs, lo);
      }
      fence_proxy_async();
      warpgroup_sync(wg);  // this warpgroup's 64 rows are written

      // dv += p^T G, dk += ds^T Q (sm_scale at the end): A K-major (the
      // warpgroup's key rows), B = g, q MN-major.
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
      static_for<0, BQ / 16>([&](auto kk) {
        constexpr int ka = desc_off(kk * 32, 16);
        constexpr int kb = desc_off(kk * 16 * kRow, BQ * kRow);
        wgmma_ss_kmn<HP, ka, kb>(dv, (ps >> 4) + rows, bg);
        wgmma_ss_kmn<HP, ka, kb>(dv, ((ps + L::kPs) >> 4) + rows, bg);
        wgmma_ss_kmn<HP, ka, kb>(dk, ((ps + 2 * L::kPs) >> 4) + rows, bq);
        wgmma_ss_kmn<HP, ka, kb>(dk, ((ps + 3 * L::kPs) >> 4) + rows, bq);
      });
      wgmma_commit();
      if constexpr (!kDq) {
        wgmma_wait_all();
        fence_regs(dv);
        fence_regs(dk);
        mbar_arrive(&empty[s]);  // Q, G, lse and delta of this stage are read
        continue;
      }

      // dq = ds K over the block's 128 keys (A = ds^T read MN-major, B = k
      // MN-major); warpgroup wg takes head dims [64 wg, 64 wg + 64).
      float dq[32];
      zero(dq);
      fence_regs(dq);
      consumers_sync();  // both halves of ds^T are in shared memory
      if (wg < CH) {
        wgmma_fence();
        static_for<0, BK / 16>([&](auto kk) {
          constexpr int ka = desc_off(kk * 16 * kRow, BQ * kRow);
          constexpr int kb = desc_off(kk * 16 * kRow, BK * kRow);
          const uint32_t bk = d0 + wg * BK * kRow / 16;
          wgmma_ss_n64<1, 1, ka, kb>(dq, (ps + 2 * L::kPs) >> 4, bk, kk > 0);
          wgmma_ss_n64<1, 1, ka, kb>(dq, (ps + 3 * L::kPs) >> 4, bk, 1);
        });
        wgmma_commit();
      }
      wgmma_wait_all();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(dq);
      mbar_arrive(&empty[s]);  // Q, G, lse and delta of this stage are read

      // The key tiles that visit this q tile are a contiguous range ending at
      // the last one whose causal start is <= q0; they add from the last down.
      const int k_last = p.causal ? min(n_kt - 1, q0 / BK) : n_kt - 1;
      int* turn = p.dq_turn + (long long)bn * (p.Tp / BQ) + q0 / BQ;
      wait_for_turn(turn, k_last - kt);  // also: both warpgroups' p^T reads done
      if (wg < CH) {
        // sm_scale * dq into a staging tile [64 queries][64 head dims] (the
        // p^T hi or lo buffer, free now), then one bulk f32 add of its 16 KB
        // into dq32's block (done before the turn passes).
        const uint32_t stage = ps + wg * L::kPs;
#pragma unroll
        for (int r = 0; r < 32; r += 2) {
          const int at = ((row % 64) + 8 * ((r >> 1) & 1)) * 64 + acc_col(r, lane);
          st_shared_f2(stage + 4 * at, p.scale * dq[r], p.scale * dq[r + 1]);
        }
        fence_proxy_async();
        warpgroup_sync(wg);
        if (threadIdx.x % 128 == 0) {
          const long long tile = ((long long)bn * (p.Tp / BQ) + q0 / BQ) * CH + wg;
          bulk_reduce_add(p.dq32 + tile * 64 * 64, stage, 64 * 64 * 4);
        }
      }
      pass_turn(turn);
    }

    __nv_bfloat16* dk_out = static_cast<__nv_bfloat16*>(p.dk);
    __nv_bfloat16* dv_out = static_cast<__nv_bfloat16*>(p.dv);
#pragma unroll
    for (int r = 0; r < HP / 2; r += 2) {
      const int h = (r >> 1) & 1, col = acc_col(r, lane);
      if (kr[h] >= p.T || col >= p.H) continue;
      const long long at = (((long long)b * p.T + kr[h]) * p.N + n) * p.H + col;
      *reinterpret_cast<__nv_bfloat162*>(dk_out + at) =
          __floats2bfloat162_rn(p.scale * dk[r], p.scale * dk[r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv_out + at) =
          __floats2bfloat162_rn(dv[r], dv[r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps and launches.
// ---------------------------------------------------------------------------

// A bf16 [B, T, N, H] tensor (element strides sb, st, sn; unit H stride) as
// a 4-D tensor map read in [64 head dims, 1, rows, 1] boxes, 128-byte
// swizzled; reads past H or T are zero-filled.
bool encode(CUtensorMap* map, const void* base, const long long* strides,
            const Params& p, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(p.H), cuuint64_t(p.N),
                              cuuint64_t(p.T), cuuint64_t(p.B)};
  const cuuint64_t bytes[3] = {cuuint64_t(strides[2]) * 2,
                               cuuint64_t(strides[1]) * 2,
                               cuuint64_t(strides[0]) * 2};
  const cuuint32_t box[4] = {64, 1, cuuint32_t(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, bytes, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

Params make_params(int B, int T, int N, int H, int causal, int window,
                   float cap, float scale, const void* seg) {
  Params p = {};
  p.seg = static_cast<const int*>(seg);
  p.B = B;
  p.T = T;
  p.N = N;
  p.H = H;
  p.Tp = (T + 63) / 64 * 64;
  p.causal = causal;
  p.window = window;
  p.cap = cap;
  p.scale = scale;
  return p;
}

bool valid(const Params& p) {
  return p.B >= 1 && p.T >= 1 && p.N >= 1 && p.H >= 8 && p.H <= 128 &&
         p.H % 8 == 0 && (long long)p.B * p.N <= 65535;
}

template <int HP>
int launch_fwd(const CUtensorMap* maps, const Params& p, cudaStream_t stream) {
  constexpr int smem = FwdSmem<HP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<HP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((p.T + kFwdBQ - 1) / kFwdBQ, p.B * p.N);
  flash_fwd_sm90_kernel<HP>
      <<<grid, kThreads, smem, stream>>>(maps[0], maps[1], maps[2], p);
  return int(cudaGetLastError());
}

template <int HP, bool kDq>
int launch_bwd(const CUtensorMap* maps, const Params& p, cudaStream_t stream) {
  constexpr int smem = BwdSmem<HP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_sm90_kernel<HP, kDq>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((p.T + kBwdBK - 1) / kBwdBK, p.B * p.N);
  flash_bwd_sm90_kernel<HP, kDq><<<grid, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  return int(cudaGetLastError());
}

template <int HP>
int launch_bwd_dq(const CUtensorMap* maps, const Params& p,
                  cudaStream_t stream) {
  constexpr int smem = DqSmem<HP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_sm90_kernel<HP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((p.T + kFwdBQ - 1) / kFwdBQ, p.B * p.N);
  flash_bwd_dq_sm90_kernel<HP><<<grid, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  return int(cudaGetLastError());
}

// The split backward's params and q, k, v, g tensor maps (q and g in boxes
// of q_rows, k and v of k_rows); lse_p and delta_p padded to T rounded up
// to K5a's q tile.
bool split_setup(Params* p, CUtensorMap* maps, const void* q, const void* k,
                 const void* v, const void* g, const long long* st,
                 const void* lse_p, const void* delta_p, int q_rows,
                 int k_rows) {
  p->Tp = (p->T + kFwdBQ - 1) / kFwdBQ * kFwdBQ;
  p->lse_p = static_cast<const float*>(lse_p);
  p->delta_p = static_cast<const float*>(delta_p);
  return encode(&maps[0], q, st, *p, q_rows) &&
         encode(&maps[1], k, st + 3, *p, k_rows) &&
         encode(&maps[2], v, st + 6, *p, k_rows) &&
         encode(&maps[3], g, st + 9, *p, q_rows);
}

}  // namespace

// Each returns a cudaError_t (0 = launched), or -1 when a tensor map cannot
// be encoded (strides or alignment TMA does not take). Strides are in
// elements, (b, t, n) per tensor.
extern "C" int automl_flash_fwd_sm90(
    const void* q, const void* k, const void* v, const void* seg, void* out,
    void* lse, long long q_sb, long long q_st, long long q_sn, long long k_sb,
    long long k_st, long long k_sn, long long v_sb, long long v_st,
    long long v_sn, int B, int T, int N, int H, int causal, int window,
    float cap, float scale, void* stream) {
  cudaGetLastError();  // clear an earlier, unrelated error
  Params p = make_params(B, T, N, H, causal, window, cap, scale, seg);
  if (!valid(p)) return int(cudaErrorInvalidValue);
  p.out = out;
  p.lse = static_cast<float*>(lse);
  const long long st[9] = {q_sb, q_st, q_sn, k_sb, k_st, k_sn,
                           v_sb, v_st, v_sn};
  CUtensorMap maps[3];
  if (!encode(&maps[0], q, st, p, kFwdBQ) ||
      !encode(&maps[1], k, st + 3, p, kFwdBK) ||
      !encode(&maps[2], v, st + 6, p, kFwdBK))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return H <= 64 ? launch_fwd<64>(maps, p, s) : launch_fwd<128>(maps, p, s);
}

extern "C" int automl_flash_bwd_sm90(
    const void* q, const void* k, const void* v, const void* g,
    const void* seg, const void* lse_p, const void* delta_p, void* dq32,
    void* dq_turn, void* dk, void* dv, long long q_sb, long long q_st,
    long long q_sn, long long k_sb, long long k_st, long long k_sn,
    long long v_sb, long long v_st, long long v_sn, long long g_sb,
    long long g_st, long long g_sn, int B, int T, int N, int H, int causal,
    int window, float cap, float scale, void* stream) {
  cudaGetLastError();
  Params p = make_params(B, T, N, H, causal, window, cap, scale, seg);
  if (!valid(p)) return int(cudaErrorInvalidValue);
  p.lse_p = static_cast<const float*>(lse_p);
  p.delta_p = static_cast<const float*>(delta_p);
  p.dq32 = static_cast<float*>(dq32);
  p.dq_turn = static_cast<int*>(dq_turn);
  p.dk = dk;
  p.dv = dv;
  const long long st[12] = {q_sb, q_st, q_sn, k_sb, k_st, k_sn,
                            v_sb, v_st, v_sn, g_sb, g_st, g_sn};
  CUtensorMap maps[4];
  if (!encode(&maps[0], q, st, p, kBwdBQ) ||
      !encode(&maps[1], k, st + 3, p, kBwdBK) ||
      !encode(&maps[2], v, st + 6, p, kBwdBK) ||
      !encode(&maps[3], g, st + 9, p, kBwdBQ))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return H <= 64 ? launch_bwd<64, true>(maps, p, s)
                 : launch_bwd<128, true>(maps, p, s);
}

// K5a and K5b: lse_p and delta_p are [B*N, T rounded up to 128], zero-padded.
extern "C" int automl_flash_bwd_dq_sm90(
    const void* q, const void* k, const void* v, const void* g,
    const void* seg, const void* lse_p, const void* delta_p, void* dq,
    long long q_sb, long long q_st, long long q_sn, long long k_sb,
    long long k_st, long long k_sn, long long v_sb, long long v_st,
    long long v_sn, long long g_sb, long long g_st, long long g_sn, int B,
    int T, int N, int H, int causal, int window, float cap, float scale,
    void* stream) {
  cudaGetLastError();
  Params p = make_params(B, T, N, H, causal, window, cap, scale, seg);
  if (!valid(p)) return int(cudaErrorInvalidValue);
  p.dq = dq;
  const long long st[12] = {q_sb, q_st, q_sn, k_sb, k_st, k_sn,
                            v_sb, v_st, v_sn, g_sb, g_st, g_sn};
  CUtensorMap maps[4];
  if (!split_setup(&p, maps, q, k, v, g, st, lse_p, delta_p, kFwdBQ, kFwdBK))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return H <= 64 ? launch_bwd_dq<64>(maps, p, s) : launch_bwd_dq<128>(maps, p, s);
}

extern "C" int automl_flash_bwd_dkv_sm90(
    const void* q, const void* k, const void* v, const void* g,
    const void* seg, const void* lse_p, const void* delta_p, void* dk,
    void* dv, long long q_sb, long long q_st, long long q_sn, long long k_sb,
    long long k_st, long long k_sn, long long v_sb, long long v_st,
    long long v_sn, long long g_sb, long long g_st, long long g_sn, int B,
    int T, int N, int H, int causal, int window, float cap, float scale,
    void* stream) {
  cudaGetLastError();
  Params p = make_params(B, T, N, H, causal, window, cap, scale, seg);
  if (!valid(p)) return int(cudaErrorInvalidValue);
  p.dk = dk;
  p.dv = dv;
  const long long st[12] = {q_sb, q_st, q_sn, k_sb, k_st, k_sn,
                            v_sb, v_st, v_sn, g_sb, g_st, g_sn};
  CUtensorMap maps[4];
  if (!split_setup(&p, maps, q, k, v, g, st, lse_p, delta_p, kBwdBQ, kBwdBK))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return H <= 64 ? launch_bwd<64, false>(maps, p, s)
                 : launch_bwd<128, false>(maps, p, s);
}
