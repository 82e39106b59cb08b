// The fused softmax cross-entropy for bf16 on Hopper (sm_90a): the forward
// (K3a), dx (K3b) and dW (K3c) on bf16 tensor cores (wgmma), fed by TMA,
// with the model dimension D split across the blocks of a thread-block
// cluster.
//
// Replaces the Pallas kernels of automl_tpu/ops/xent.py for bf16 operands
// with D a multiple of 256 up to 2,048:
//   * automl_xent_fwd_sm90 replaces _fwd_kernel (launched by _fwd_pallas):
//     per token the logsumexp of its capped logits, online over the vocab
//     tiles, and the target's logit;
//   * automl_xent_dx_sm90 replaces _dx_kernel (launched by _bwd_pallas):
//     dx = dz . w;
//   * automl_xent_dw_sm90 replaces _dw_kernel (_bwd_pallas): dW = dz^T . x;
// with dz = coef * (exp(z - lse) - onehot(target)) * (1 - tanh^2),
// z = cap * tanh(x . w^T / cap), recomputed tile by tile: the [M, V] logits
// never reach device memory. float32 operands, and bf16 with another D,
// keep the kernels of xent.cu. The interface is theirs: x [M, D] and w
// [V, D] contiguous bf16 (16-byte aligned: what a TMA descriptor takes);
// targets int32 [M]; lse, tz and coef f32 [M]; dx / dW written once, as
// f32 or bf16.
//
// Precision contract (that of the TPU kernels and of xent.cu): logits are
// products of bf16 values summed in f32 (wgmma, f32 accumulators; the
// blocks' partial sums over their 256 columns of D are added in f32, in
// rank order); the cap and its derivative are taken at the raw logits with
// the exact tanhf; exp and dz are f32; dz is rounded to bf16 before the
// second product, which sums in f32. Masks: vocab columns >= V and tokens
// >= M get dz = 0; rows of w past V and of x past M are zero-filled by TMA,
// so 0 * NaN never enters a sum.
//
// Masks in the forward: vocab columns >= V score -1e30 and add nothing to
// the sum of exponentials; tokens >= M are not written.
//
// Bound on this card, at the LM slice's shapes (M 16,384 tokens, D 1,024,
// V 100,864): the forward does 2*M*V*D = 3.38 TFLOP, dx and dW each
// 4*M*V*D = 6.77 TFLOP (the logit recompute plus the product), on at most
// 0.65 GB of inputs and outputs: bound by operations, 3.42 and 6.84 ms at
// 989 TFLOP/s, against <= 0.2 ms for the bytes at 3.35 TB/s.
//
// Design. One template serves both kernels: "own" rows P, whose output rows
// a cluster writes, and "streamed" rows Q, which it walks in tiles of 64.
// K3b: P = x (tokens), Q = w (vocab); K3c: P = w, Q = x. A cluster of
// C = D / 256 blocks owns 128 rows of P; block c of the cluster holds
// columns [256 c, 256 c + 256) of them (64 KB, loaded once) and streams the
// same columns of each Q tile (32 KB) through a two-stage TMA ring, so the
// cluster reads each streamed element from L2 once, and both products use
// it from shared memory. Each block is three warpgroups: a producer (24
// registers; one thread issues TMA, and for K3c a warp stages each tile's
// per-token lse, coef and target in shared memory) and two consumer
// warpgroups (240 registers, setmaxnreg) that own 64 of the 128 rows each
// and run as two independent pipelines. Per streamed tile a consumer
// warpgroup
//   1. computes its block's partial logits z_c = P_c Q_c^T, [64, 64] by SS
//      wgmma (m64n64k16, 16 k16 steps);
//   2. reduce-scatters them across the cluster: each thread stores its
//      partials straight from its accumulator registers into the slot of
//      the block that owns the row (rows 64 c / C to 64 (c + 1) / C belong
//      to block c), by st.async, whose bytes complete a transaction on that
//      block's mbarrier (a plain store for its own block's rows);
//   3. on its own rows sums the C partials in rank order 0 .. C-1 (the same
//      order in every run: two calls are bit-equal), forms dz with the
//      exact cap, rounds it to bf16 into a swizzled [64, 64] tile, and
//      all-gathers it: st.async of its rows to every other block;
//   4. loads dz into A registers (ldmatrix) and adds dz Q_c to its
//      accumulator [64, 256] f32 (128 registers a thread) by RS wgmma
//      (m64n256k16, 4 k16 steps, Q_c read MN-major from the same tile as
//      step 1), then frees the ring stage.
// Each warp arrives once on its own block's barrier after its stores of a
// step; the barrier expects the other blocks' bytes besides. No staging
// copy, fence or warpgroup barrier sits on the exchange: bulk copies of a
// staged tile (a fence, a warpgroup barrier and one thread issuing them)
// were slower. Step 1 of the next tile is issued before step 3's exchange
// is waited for, so the tensor cores work while dz crosses the cluster.
// The exchange moves, per tile, warpgroup and block, (C-1)/C of 16 KB of
// partials out and (C-1)/C of 8 KB of dz in; the transcendental pass is
// done once per logit, spread over the cluster, and takes about half of a
// tile's time at the slice's shapes (cli/xent_phases.py, which builds this
// file with XENT_PHASE_CLOCKS: clock64 stamps at the steps of a tile, in
// the first block). The accumulator spans
// D = 256 per block, so D up to 2,048 (C = 8, the portable cluster size)
// fits.
// Ordering without extra barriers: a warp stores a tile's partials (dz
// rows) only after its dz wait (recv wait) of the tile before, which every
// warp of every block passes only after reading what it overwrites; every
// buffer is single.
// The last wave: the card runs A clusters at once (30 of 4 blocks on the
// H100 at D 1,024), and the own tiles rarely divide into A; the wrapper
// (ops/xent.py::split_plan) has the last T % A tiles each split n_split
// = A / (T % A) ways along the streamed tiles, their f32 parts written to
// a scratch buffer and summed in part order by xent_split_sum_kernel (the
// same order in every run), so that the last wave fills the card. Each
// block writes its outputs once: no atomics.
// Shared memory per block: P 64 KB + ring 2 x 32 KB + received partials 2
// x 72 rows x 256 B (36 KB) + dz 16 KB + token values (2 x 768 B + 1.5 KB)
// + barriers = 184 KB of the 227 KB a block may use. L2 reads of the
// streamed operand per call at the slice's shapes: 128 clusters x 206 MB
// (K3b) and 788 x 33.5 MB (K3c), ~26 GB each, where xent.cu reads ~235 GB.
// In a cluster launch a block's shared::cta addresses carry its rank in
// their high bits: a wgmma descriptor takes only the 14-bit field
// (desc_base), or the bits reach its leading byte offset.
//
// The forward (xent_fwd_sm90_kernel) is this template without its backward
// half: the same cluster, P = x and Q = w, steps 1 and 2 as above, and no
// dz, no all-gather and no second product. In step 3 a consumer thread
// owns, for the whole launch, the same items (a row of this block and 8 of
// each tile's 64 vocab columns): it sums their partials in rank order,
// caps them with the exact tanhf and carries their online (max, sum of
// exp, target logit) in registers across the tiles; the 8 threads of a row
// merge theirs once, at the end, in a fixed order (two calls are
// bit-equal). The next tile's logits run on the tensor cores during the
// pass. With no dz exchange to order the reuse of a received slot, the
// partials alternate between two slots per warpgroup, and each warp, once
// it has read a slot, arrives on that slot's acknowledgement barrier in
// every block of the cluster (a remote mbarrier arrive with release
// semantics); a block sends tile i + 2 into the slot only after all
// arrivals for tile i. The last wave's split parts write their rows'
// (m, l, t) to a scratch, merged in part order by xent_fwd_merge_kernel.
// Shared memory: P 64 KB + ring 64 KB + received partials 2 x 2 x 18 KB +
// barriers = 201 KB. L2 reads of w per call at the slice's shapes: 128
// clusters x 206 MB = 26 GB, where xent.cu's K3a reads x again per 128-wide
// vocab tile (79 GB).
//
// Plain C interface, loaded with ctypes (automl_tpu_torch/ops/cuda_build.py).
// The tensor maps are encoded per call on the host and passed as
// __grid_constant__ kernel parameters. The kernels allocate nothing; the
// launchers return a cudaError_t, or -1 when a tensor map cannot be
// encoded.

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
constexpr int kBP = 128;           // own rows of a cluster, 64 a warpgroup
constexpr int kBQ = 64;            // streamed rows a tile
constexpr int kSlice = 256;        // columns of D a block
constexpr int kChunks = kSlice / 64;  // 128-byte TMA boxes across a slice
constexpr int kMaxCluster = 8;
constexpr float kNegInf = -1e30f;  // a masked vocab column's logit

struct Smem {
  static constexpr int kP = kBP * kSlice * 2;       // kChunks x [128][64] bf16
  static constexpr int kStage = kBQ * kSlice * 2;   // kChunks x [64][64] bf16
  static constexpr int kZRow = 64 * 4;              // a row of f32 logits
  static constexpr int kRecvRows = 72;  // >= C * ceil(64 / C), C <= 8
  static constexpr int kRecv = 2 * kRecvRows * kZRow;  // per warpgroup
  static constexpr int kDz = kBP * kRow;            // [128][64] bf16
  static constexpr int kRing = kP;
  static constexpr int kRecvAt = kRing + kStages * kStage;
  static constexpr int kDzAt = kRecvAt + kRecv;
  // Token values (lse, coef, target): K3c a streamed tile's per stage, K3b
  // the own rows' once.
  static constexpr int kTok = kBQ * 12;
  static constexpr int kTokAt = kDzAt + kDz;
  static constexpr int kOwnTok = kBP * 12;
  static constexpr int kOwnTokAt = kTokAt + kStages * kTok;
  static constexpr int kBars = kOwnTokAt + kOwnTok;
  static constexpr int kNumBars = 2 * kStages + 1 + 4;
  static constexpr int kBytes = kBars + 8 * kNumBars + 1024;  // + alignment
};
static_assert(Smem::kBytes <= 232448, "a block's shared memory on sm_90");
constexpr bool recv_rows_fit() {
  for (int c = 1; c <= kMaxCluster; ++c)
    if (c * ((64 + c - 1) / c) > Smem::kRecvRows) return false;
  return true;
}
static_assert(recv_rows_fit(), "a warpgroup's received partials");

struct Params {
  const int* tgt;      // [M]
  const float* lse;    // [M]
  const float* coef;   // [M]
  void* out;           // dx [M, D] or dW [V, D], f32 or bf16 (out_bf16)
  int out_bf16;
  int M, V, D;
  int n_tiles;         // streamed tiles of kBQ rows
  float cap;           // 0: no cap
  // The last wave: own tiles n_whole.. are split n_split ways along the
  // streamed tiles, each part's f32 sums into part_out [part][kBP][D],
  // added up in part order by xent_split_sum_kernel.
  int n_whole, n_split;
  float* part_out;
};

#ifdef XENT_PHASE_CLOCKS
// The steps of tiles 64 .. 79 of the first block's two consumer warpgroups,
// in SM clocks (cli/xent_phases.py): [warpgroup][tile][stamp].
__device__ long long xent_phase_clocks[2][16][8];
#define PHASE(k)                                                  \
  if (t == 0 && blockIdx.x == 0 && i >= 64 && i < 80)             \
  xent_phase_clocks[wg][i - 64][k] = clock64()
#else
#define PHASE(k)
#endif

__device__ __forceinline__ float capped(float z, float cap, float* dcap) {
  if (cap > 0.f) {
    const float th = tanhf(z / cap);
    *dcap = 1.f - th * th;
    return cap * th;
  }
  *dcap = 1.f;
  return z;
}

// Byte offset of the 16-byte chunk ch (columns 4 ch .. 4 ch + 3) of `row`
// in an f32 [rows][64] tile, the chunk index swizzled by 2 (row % 4): the
// accumulator's float2 stores and the 16-byte loads of a quarter-warp (one
// row, chunks 2k + (k / 4 % 2)) are free of bank conflicts.
__device__ __forceinline__ uint32_t z_chunk(int row, int ch) {
  return row * Smem::kZRow + ((ch ^ ((row & 3) << 1)) << 4);
}

__device__ __forceinline__ float4 ld_shared_f4(uint32_t at) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(at)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_shared_v4(uint32_t at, uint32_t a,
                                             uint32_t b, uint32_t c,
                                             uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(at), "r"(a),
               "r"(b), "r"(c), "r"(d)
               : "memory");
}

template <bool kDx>
__global__ void __launch_bounds__(kThreads, 1)
    xent_bwd_sm90_kernel(const __grid_constant__ CUtensorMap tp,
                         const __grid_constant__ CUtensorMap tq,
                         const Params p) {
  using L = Smem;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* p_bar = empty + kStages;
  uint64_t* recv_bar = p_bar + 1;   // one per consumer warpgroup
  uint64_t* dz_bar = recv_bar + 2;  // one per consumer warpgroup
  const int C = p.D / kSlice;       // blocks of the cluster
  const int me = cluster_rank();
  if (threadIdx.x == 0) {
    // full: the TMA thread's arrival (and the bytes); K3c: also a warp's
    // that stores the tile's token values.
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kDx ? 1 : 33);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(p_bar, 1);
    // recv / dz: the other blocks' bytes, and one arrival of each warp of
    // the warpgroup once its stores to this block are done.
    for (int w = 0; w < 2; ++w) {
      mbar_init(&recv_bar[w], 4);
      mbar_init(&dz_bar[w], 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every block's barriers exist before a copy reaches one

  // The cluster's own rows and streamed tiles [j0, j1): a whole tile, or
  // a part of one of the last wave's.
  const int unit = blockIdx.x / C;
  const bool split = unit >= p.n_whole;
  const int part_id = unit - p.n_whole;
  const int sp = split ? part_id % p.n_split : 0;
  const int p0 = (split ? p.n_whole + part_id / p.n_split : unit) * kBP;
  const int j0 = split ? p.n_tiles * sp / p.n_split : 0;
  const int n = (split ? p.n_tiles * (sp + 1) / p.n_split : p.n_tiles) - j0;
  const int col0 = me * kSlice;           // this block's columns of D
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    // Producer: this block's slice of P once, then of Q tile by tile.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(p_bar, L::kP);
      for (int c = 0; c < kChunks; ++c)
        tma_load_2d(smem + c * kBP * kRow, &tp, p_bar, col0 + 64 * c, p0);
      for (int i = 0; i < n; ++i) {
        const int s = i % kStages;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        uint8_t* sq = smem + L::kRing + s * L::kStage;
        mbar_expect_tx(&full[s], L::kStage);
        for (int c = 0; c < kChunks; ++c)
          tma_load_2d(sq + c * kBQ * kRow, &tq, &full[s], col0 + 64 * c,
                      (j0 + i) * kBQ);
      }
    }
    if (!kDx && threadIdx.x / 32 == 9) {
      // K3c: each streamed tile's token values (a token past M: coef 0).
      const int lane = threadIdx.x % 32;
      for (int i = 0; i < n; ++i) {
        const int s = i % kStages;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        float* tok_s = reinterpret_cast<float*>(smem + L::kTokAt + s * L::kTok);
        for (int r = lane; r < kBQ; r += 32) {
          const int tok = (j0 + i) * kBQ + r;
          const bool in = tok < p.M;
          tok_s[r] = in ? p.lse[tok] : 0.f;
          tok_s[kBQ + r] = in ? p.coef[tok] : 0.f;
          reinterpret_cast<int*>(tok_s)[2 * kBQ + r] = in ? p.tgt[tok] : -1;
        }
        mbar_arrive(&full[s]);
      }
    }
    cluster_sync();  // the block's shared memory outlives the others' copies
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  // This block's rows of each warpgroup's 64: [r_lo, r_hi).
  const int r_lo = 64 * me / C, r_hi = 64 * (me + 1) / C;
  const int n_items = (r_hi - r_lo) * 8;  // (row, 8 logits) of them
  const int rmax = (64 + C - 1) / C;      // a received slot's rows
  const int own0 = p0 + wg * 64;          // this warpgroup's first own row
  const int n_own = kDx ? p.M : p.V;
  const uint32_t sm = smem_u32(smem);
  const uint32_t recv = sm + L::kRecvAt + wg * L::kRecvRows * L::kZRow;
  const uint32_t dzs = sm + L::kDzAt + wg * 64 * kRow;
  const uint32_t recv_b = smem_u32(&recv_bar[wg]), dz_b = smem_u32(&dz_bar[wg]);

  // Each warp's arrival once its stores to this block are done; warp 0's
  // also expects the other blocks' bytes.
  auto arrive = [&](uint64_t* bar, uint32_t remote_bytes) {
    __syncwarp();
    if (lane == 0) {
      if (warp == 0)
        mbar_expect_tx(bar, remote_bytes);
      else
        mbar_arrive(bar);
    }
  };

  // K3b: the own rows' token values, once, into shared memory.
  float* own_tok = reinterpret_cast<float*>(smem + L::kOwnTokAt) + wg * 64;
  if (kDx) {
    if (t < 64) {
      const int tok = own0 + t;
      const bool in = tok < p.M;
      own_tok[t] = in ? p.lse[tok] : 0.f;
      own_tok[kBP + t] = in ? p.coef[tok] : 0.f;
      reinterpret_cast<int*>(own_tok)[2 * kBP + t] = in ? p.tgt[tok] : -1;
    }
    warpgroup_sync(wg);
  }

  const uint32_t a_p = desc_base(smem) + wg * 64 * kRow / 16;

  // Step 1 of the unit's tile i: this block's partial logits z = P Q^T
  // over its columns of D, issued (not waited for).
  auto issue_z = [&](int i, float(&z)[32]) {
    const int s = i % kStages;
    mbar_wait(&full[s], (i / kStages) & 1);
    const uint32_t b_q = desc_base(smem + L::kRing + s * L::kStage);
    zero(z);
    fence_regs(z);
    wgmma_fence();
    static_for<0, kSlice / 16>([&](auto kk) {
      // K-major: chunk kk / 4 of 64 columns, 32 bytes per k16 step.
      constexpr int ka = desc_off((kk / 4) * kBP * kRow + (kk % 4) * 32, 16);
      constexpr int kb = desc_off((kk / 4) * kBQ * kRow + (kk % 4) * 32, 16);
      wgmma_ss_n64<0, 0, ka, kb>(z, a_p, b_q, kk > 0);
    });
    wgmma_commit();
  };
  // Step 2: each row's partials into its slot in the block that owns it:
  // st.async to another block (its bytes complete a transaction on that
  // block's barrier), a plain store to this one.
  auto send_z = [&](const float(&z)[32]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // Row `row` belongs to block o (the last with 64 o / C <= row), whose
      // slot `me` holds its rows of this block's partials.
      const int row = warp * 16 + 8 * h + lane / 4;
      const int o = ((row + 1) * C - 1) / 64;
      const uint32_t slot = recv + (me * rmax - 64 * o / C) * L::kZRow;
      const uint32_t to = o == me ? slot : map_to_rank(slot, o);
      const uint32_t bar = map_to_rank(recv_b, o);
#pragma unroll
      for (int r = 2 * h; r < 32; r += 4) {
        const int col = acc_col(r, lane);
        const uint32_t at = to + z_chunk(row, col >> 2) + (col & 3) * 4;
        if (o == me)
          st_shared_f2(at, z[r], z[r + 1]);
        else
          st_async_f2(at, z[r], z[r + 1], bar);
      }
    }
    arrive(&recv_bar[wg], (C - 1) * (r_hi - r_lo) * L::kZRow);
  };

  float acc[128];
  zero(acc);
  float z[32];
  mbar_wait(p_bar, 0);
  issue_z(0, z);
  wgmma_wait_all();
  fence_regs(z);
  send_z(z);

  for (int i = 0; i < n; ++i) {
    const int s = i % kStages, q0 = (j0 + i) * kBQ;
    const bool next = i + 1 < n;
    PHASE(0);
    const float* tok_s =
        reinterpret_cast<const float*>(smem + L::kTokAt + s * L::kTok);
    mbar_wait(&recv_bar[wg], i & 1);
    PHASE(1);

    // 3. dz on this block's rows: the partials summed in rank order.
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int it = t + 128 * u;
      if (it < n_items) {
        const int row = r_lo + it / 8, k = it % 8;
        const int ca = 2 * k + ((k >> 2) & 1);  // first of its two chunks
        float zf[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) zf[i] = 0.f;
        for (int c = 0; c < C; ++c) {
          const uint32_t base = recv + (c * rmax - r_lo) * L::kZRow;
          const float4 va = ld_shared_f4(base + z_chunk(row, ca));
          const float4 vb = ld_shared_f4(base + z_chunk(row, ca ^ 1));
          const float4 lo = (ca & 1) ? vb : va, hi = (ca & 1) ? va : vb;
          zf[0] += lo.x;
          zf[1] += lo.y;
          zf[2] += lo.z;
          zf[3] += lo.w;
          zf[4] += hi.x;
          zf[5] += hi.y;
          zf[6] += hi.z;
          zf[7] += hi.w;
        }
        // dz = coef (exp(z - lse) - onehot) cap' at a logit z of a column
        // `voc` of the vocabulary.
        auto dz_of = [&](float zv, float l, float cf, int tg, int voc) {
          float dcap;
          const float zc = capped(zv, p.cap, &dcap);
          return cf * (expf(zc - l) - (voc == tg ? 1.f : 0.f)) * dcap;
        };
        const int own = own0 + row;
        uint32_t packed[4];
        if (kDx) {
          // K3b: one token (the item's own row), 8 vocab columns; past V
          // or M, dz = 0.
          const float l = own_tok[row], cf = own_tok[kBP + row];
          const int tg = reinterpret_cast<const int*>(own_tok)[2 * kBP + row];
#pragma unroll
          for (int i = 0; i < 8; i += 2) {
            float dz[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int voc = q0 + 8 * k + i + e;
              dz[e] = own < p.M && voc < p.V ? dz_of(zf[i + e], l, cf, tg, voc)
                                             : 0.f;
            }
            packed[i / 2] = pack(__floats2bfloat162_rn(dz[0], dz[1]));
          }
        } else {
          // K3c: 8 streamed tokens' values from the stage, one vocab row.
          // All 8 are computed without branches and masked by a select, so
          // that their transcendental chains interleave (faster here; for
          // K3b, the branches above are).
          float l[8], cf[8];
          int tg[8];
          const float4* tv = reinterpret_cast<const float4*>(tok_s + 8 * k);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float4 a = tv[h], b = tv[kBQ / 4 + h];
            const int4 g = reinterpret_cast<const int4*>(tv)[kBQ / 2 + h];
            l[4 * h] = a.x, l[4 * h + 1] = a.y, l[4 * h + 2] = a.z,
            l[4 * h + 3] = a.w;
            cf[4 * h] = b.x, cf[4 * h + 1] = b.y, cf[4 * h + 2] = b.z,
            cf[4 * h + 3] = b.w;
            tg[4 * h] = g.x, tg[4 * h + 1] = g.y, tg[4 * h + 2] = g.z,
            tg[4 * h + 3] = g.w;
          }
#pragma unroll
          for (int i = 0; i < 8; i += 2) {
            float dz[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float d = dz_of(zf[i + e], l[i + e], cf[i + e], tg[i + e],
                                    own);
              dz[e] = q0 + 8 * k + i + e < p.M && own < p.V ? d : 0.f;
            }
            packed[i / 2] = pack(__floats2bfloat162_rn(dz[0], dz[1]));
          }
        }
        const uint32_t at = dzs + row * kRow + ((k ^ (row & 7)) << 4);
        st_shared_v4(at, packed[0], packed[1], packed[2], packed[3]);
        for (int c = 0; c < C; ++c)
          if (c != me)
            st_async_v4(map_to_rank(at, c), packed[0], packed[1], packed[2],
                        packed[3], map_to_rank(dz_b, c));
      }
    }
    PHASE(2);
    arrive(&dz_bar[wg], (64 - (r_hi - r_lo)) * kRow);

    // The next tile's partial logits run on the tensor cores while dz is
    // exchanged.
    if (next) issue_z(i + 1, z);
    PHASE(3);
    mbar_wait(&dz_bar[wg], i & 1);
    PHASE(4);

    // 4. acc += dz Q_c: dz's 64 streamed columns as the A registers of four
    // k16 steps, Q_c read MN-major (k16 step: 16 rows; 64-column chunks
    // kBQ * kRow apart).
    uint32_t a[4][4];
    const int lrow = warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldmatrix_x4(a[kk], dzs + lrow * kRow +
                             (((2 * kk + (lane >> 4)) ^ (lrow & 7)) << 4));
    const uint32_t b_q = desc_base(smem + L::kRing + s * L::kStage);
    wgmma_fence();
    static_for<0, kBQ / 16>([&](auto kk) {
      constexpr int kb = desc_off(kk * 16 * kRow, kBQ * kRow);
      wgmma_rs_n256<kb>(acc, a[kk], b_q, 1);
    });
    wgmma_commit();
    // The next tile's partials go out while the product runs: every block
    // has read this tile's (they sent their dz rows after reading).
    if (next) {
      wgmma_wait_all();
      PHASE(5);
      fence_regs(z);
      send_z(z);
    }
    PHASE(6);
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(&empty[s]);
    PHASE(7);
  }

  // The outputs, written once (a part's into part_out).
#pragma unroll
  for (int r = 0; r < 128; r += 2) {
    const int row = own0 + warp * 16 + 8 * ((r >> 1) & 1) + lane / 4;
    const int col = col0 + acc_col(r, lane);
    if (split) {
      *reinterpret_cast<float2*>(
          p.part_out + ((long long)part_id * kBP + row - p0) * p.D + col) =
          make_float2(acc[r], acc[r + 1]);
      continue;
    }
    if (row >= n_own) continue;
    const long long at = (long long)row * p.D + col;
    if (p.out_bf16)
      *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) +
                                         at) =
          __floats2bfloat162_rn(acc[r], acc[r + 1]);
    else
      *reinterpret_cast<float2*>(static_cast<float*>(p.out) + at) =
          make_float2(acc[r], acc[r + 1]);
  }
  cluster_sync();
}

// The split tiles' outputs: the n_split parts of each summed in part order
// (the same in every run), 4 columns a thread.
__global__ void __launch_bounds__(256)
    xent_split_sum_kernel(const Params p, int n_own) {
  const long long tile = (long long)kBP * p.D;
  const long long total = (long long)((n_own + kBP - 1) / kBP - p.n_whole) *
                          tile / 4;
  for (long long e = blockIdx.x * 256LL + threadIdx.x; e < total;
       e += (long long)gridDim.x * 256) {
    const long long t_off = e * 4 % tile;
    const int rt = int(e * 4 / tile);
    const long long row = (long long)(p.n_whole + rt) * kBP + t_off / p.D;
    if (row >= n_own) continue;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < p.n_split; ++k) {
      const float4 v = *reinterpret_cast<const float4*>(
          p.part_out + (long long)(rt * p.n_split + k) * tile + t_off);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const long long at = row * p.D + t_off % p.D;
    if (p.out_bf16) {
      __nv_bfloat162* o =
          reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) + at);
      o[0] = __floats2bfloat162_rn(sum.x, sum.y);
      o[1] = __floats2bfloat162_rn(sum.z, sum.w);
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(p.out) + at) = sum;
    }
  }
}

// ---------------------------------------------------------------------------
// K3a: the forward.
// ---------------------------------------------------------------------------

// Shared memory of the forward: P (x) and the ring as K3b's; each consumer
// warpgroup's received partials twice (tiles alternate between the two
// slots, so a block sends tile i + 1 while the owners still read tile i);
// per slot a barrier for the partials received and one for the owners'
// acknowledgements that they have read it.
struct FwdSmem {
  static constexpr int kSlot = Smem::kRecvRows * Smem::kZRow;
  static constexpr int kRecvAt = Smem::kRing + kStages * Smem::kStage;
  static constexpr int kBars = kRecvAt + 2 * 2 * kSlot;
  // full, empty, p_bar, recv [wg][slot], ack [wg][slot]
  static constexpr int kNumBars = 2 * kStages + 1 + 4 + 4;
  static constexpr int kBytes = kBars + 8 * kNumBars + 1024;  // + alignment
};
static_assert(FwdSmem::kBytes <= 232448, "a block's shared memory on sm_90");

struct FwdParams {
  const int* tgt;      // [M]
  float* lse;          // [M]
  float* tz;           // [M]
  int M, V, D;
  int n_tiles;         // streamed (vocab) tiles of kBQ rows
  float cap;           // 0: no cap
  // The last wave: own tiles n_whole.. are split n_split ways along the
  // vocab tiles; part k of a tile writes its rows' (m, l, t) to
  // part_out[part][3][kBP], merged in part order by xent_fwd_merge_kernel.
  int n_whole, n_split;
  float* part_out;
};

// Waits for a phase of a barrier that other blocks of the cluster arrive on
// (after their reads, with release semantics).
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// An arrival on the barrier at shared::cluster address `bar` (map_to_rank),
// releasing this thread's earlier reads to the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          bar)
      : "memory");
}

// The online softmax of one row: (m, l, t) merged with (m2, l2, t2).
__device__ __forceinline__ void merge_mlt(float& m, float& l, float& t,
                                          float m2, float l2, float t2) {
  const float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
  t += t2;
}

// The forward for bf16, D a multiple of 256 up to 2,048: K3b's cluster,
// P = x, Q = w, steps 1 and 2 of K3b's tile; then, in place of dz, each
// block's consumer threads carry the online softmax of their own rows'
// capped logits across the vocab tiles.
__global__ void __launch_bounds__(kThreads, 1)
    xent_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tp,
                         const __grid_constant__ CUtensorMap tq,
                         const FwdParams p) {
  using L = Smem;
  using F = FwdSmem;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + F::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* p_bar = empty + kStages;
  uint64_t* recv_bar = p_bar + 1;   // [wg][slot]
  uint64_t* ack_bar = recv_bar + 4;  // [wg][slot]
  const int C = p.D / kSlice;
  const int me = cluster_rank();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(p_bar, 1);
    for (int b = 0; b < 4; ++b) {
      // recv: the other blocks' bytes and one arrival of each warp of the
      // warpgroup; ack: one arrival of each warp of every block (itself
      // included) once it has read the slot.
      mbar_init(&recv_bar[b], 4);
      mbar_init(&ack_bar[b], 4 * C);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  const int unit = blockIdx.x / C;
  const bool split = unit >= p.n_whole;
  const int part_id = unit - p.n_whole;
  const int sp = split ? part_id % p.n_split : 0;
  const int p0 = (split ? p.n_whole + part_id / p.n_split : unit) * kBP;
  const int j0 = split ? p.n_tiles * sp / p.n_split : 0;
  const int n = (split ? p.n_tiles * (sp + 1) / p.n_split : p.n_tiles) - j0;
  const int col0 = me * kSlice;
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(p_bar, L::kP);
      for (int c = 0; c < kChunks; ++c)
        tma_load_2d(smem + c * kBP * kRow, &tp, p_bar, col0 + 64 * c, p0);
      for (int i = 0; i < n; ++i) {
        const int s = i % kStages;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        uint8_t* sq = smem + L::kRing + s * L::kStage;
        mbar_expect_tx(&full[s], L::kStage);
        for (int c = 0; c < kChunks; ++c)
          tma_load_2d(sq + c * kBQ * kRow, &tq, &full[s], col0 + 64 * c,
                      (j0 + i) * kBQ);
      }
    }
    cluster_sync();
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int r_lo = 64 * me / C, r_hi = 64 * (me + 1) / C;
  const int n_items = (r_hi - r_lo) * 8;
  const int rmax = (64 + C - 1) / C;
  const int own0 = p0 + wg * 64;
  const uint32_t sm = smem_u32(smem);
  const uint32_t recv0 = sm + F::kRecvAt + wg * 2 * F::kSlot;

  auto arrive = [&](uint64_t* bar, uint32_t remote_bytes) {
    __syncwarp();
    if (lane == 0) {
      if (warp == 0)
        mbar_expect_tx(bar, remote_bytes);
      else
        mbar_arrive(bar);
    }
  };

  const uint32_t a_p = desc_base(smem) + wg * 64 * kRow / 16;
  auto issue_z = [&](int i, float(&z)[32]) {
    const int s = i % kStages;
    mbar_wait(&full[s], (i / kStages) & 1);
    const uint32_t b_q = desc_base(smem + L::kRing + s * L::kStage);
    zero(z);
    fence_regs(z);
    wgmma_fence();
    static_for<0, kSlice / 16>([&](auto kk) {
      constexpr int ka = desc_off((kk / 4) * kBP * kRow + (kk % 4) * 32, 16);
      constexpr int kb = desc_off((kk / 4) * kBQ * kRow + (kk % 4) * 32, 16);
      wgmma_ss_n64<0, 0, ka, kb>(z, a_p, b_q, kk > 0);
    });
    wgmma_commit();
  };
  // Tile i's partials into slot i % 2 of the blocks that own their rows
  // (as K3b's step 2), once every block has read that slot's tile i - 2.
  auto send_z = [&](int i, const float(&z)[32]) {
    const int slot = i & 1;
    if (i >= 2) mbar_wait_cluster(&ack_bar[wg * 2 + slot], ((i >> 1) - 1) & 1);
    const uint32_t recv = recv0 + slot * F::kSlot;
    const uint32_t recv_b = smem_u32(&recv_bar[wg * 2 + slot]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = warp * 16 + 8 * h + lane / 4;
      const int o = ((row + 1) * C - 1) / 64;
      const uint32_t at_slot = recv + (me * rmax - 64 * o / C) * L::kZRow;
      const uint32_t to = o == me ? at_slot : map_to_rank(at_slot, o);
      const uint32_t bar = map_to_rank(recv_b, o);
#pragma unroll
      for (int r = 2 * h; r < 32; r += 4) {
        const int col = acc_col(r, lane);
        const uint32_t at = to + z_chunk(row, col >> 2) + (col & 3) * 4;
        if (o == me)
          st_shared_f2(at, z[r], z[r + 1]);
        else
          st_async_f2(at, z[r], z[r + 1], bar);
      }
    }
    arrive(&recv_bar[wg * 2 + slot], (C - 1) * (r_hi - r_lo) * L::kZRow);
  };

  // This thread's items u: (row r_lo + it / 8, logits 8 k .. 8 k + 7 of
  // every vocab tile), it = t + 128 u; their online softmax (m, l) and
  // target logit, over the tiles.
  constexpr int kItems = 4;
  float m[kItems], l[kItems], tt[kItems];
  int tg[kItems];
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int it = t + 128 * u, row = own0 + r_lo + it / 8;
    m[u] = kNegInf;
    l[u] = 0.f;
    tt[u] = 0.f;
    tg[u] = it < n_items && row < p.M ? p.tgt[row] : -1;
  }

  float z[32];
  mbar_wait(p_bar, 0);
  issue_z(0, z);
  wgmma_wait_all();
  fence_regs(z);
  mbar_arrive(&empty[0]);
  send_z(0, z);

  for (int i = 0; i < n; ++i) {
    const int slot = i & 1, q0 = (j0 + i) * kBQ;
    const bool next = i + 1 < n;
    PHASE(0);
    // The next tile's partial logits run on the tensor cores during the
    // pass over this one.
    if (next) issue_z(i + 1, z);
    PHASE(1);
    mbar_wait(&recv_bar[wg * 2 + slot], (i >> 1) & 1);
    PHASE(2);
    const uint32_t recv = recv0 + slot * F::kSlot;
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int it = t + 128 * u;
      if (it < n_items) {
        const int row = r_lo + it / 8, k = it % 8;
        const int ca = 2 * k + ((k >> 2) & 1);
        float zf[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) zf[e] = 0.f;
        for (int c = 0; c < C; ++c) {
          const uint32_t base = recv + (c * rmax - r_lo) * L::kZRow;
          const float4 va = ld_shared_f4(base + z_chunk(row, ca));
          const float4 vb = ld_shared_f4(base + z_chunk(row, ca ^ 1));
          const float4 lo = (ca & 1) ? vb : va, hi = (ca & 1) ? va : vb;
          zf[0] += lo.x;
          zf[1] += lo.y;
          zf[2] += lo.z;
          zf[3] += lo.w;
          zf[4] += hi.x;
          zf[5] += hi.y;
          zf[6] += hi.z;
          zf[7] += hi.w;
        }
        // The capped logits of vocab columns q0 + 8 k .. (-1e30 past V),
        // without branches so that the eight chains interleave.
        float mx = kNegInf;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int voc = q0 + 8 * k + e;
          float dcap;
          const float zc = capped(zf[e], p.cap, &dcap);
          tt[u] += voc == tg[u] ? zc : 0.f;
          zf[e] = voc < p.V ? zc : kNegInf;
          mx = fmaxf(mx, zf[e]);
        }
        const float m_new = fmaxf(m[u], mx);
        float sum = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          sum += q0 + 8 * k + e < p.V ? expf(zf[e] - m_new) : 0.f;
        l[u] = l[u] * expf(m[u] - m_new) + sum;
        m[u] = m_new;
      }
    }
    PHASE(3);
    // This warp has read slot i: tell every block of the cluster.
    __syncwarp();
    if (lane < C)
      mbar_arrive_cluster(map_to_rank(smem_u32(&ack_bar[wg * 2 + slot]), lane));
    // Outside the branch (a no-op on the last tile): a wait under it makes
    // ptxas serialize the wgmma.
    wgmma_wait_all();
    fence_regs(z);
    if (next) {
      mbar_arrive(&empty[(i + 1) % kStages]);
      PHASE(4);
      send_z(i + 1, z);
    }
    PHASE(5);
  }

  // Each row's 8 threads (consecutive lanes) merge their (m, l, t); the
  // first writes lse and the target logit, or a split part's triple.
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
#pragma unroll
    for (int o = 1; o < 8; o <<= 1)
      merge_mlt(m[u], l[u], tt[u], __shfl_xor_sync(0xffffffffu, m[u], o),
                __shfl_xor_sync(0xffffffffu, l[u], o),
                __shfl_xor_sync(0xffffffffu, tt[u], o));
    const int it = t + 128 * u, row = wg * 64 + r_lo + it / 8;
    if (it < n_items && it % 8 == 0 && p0 + row < p.M) {
      if (split) {
        float* po = p.part_out + (size_t)part_id * 3 * kBP + row;
        po[0] = m[u];
        po[kBP] = l[u];
        po[2 * kBP] = tt[u];
      } else {
        p.lse[p0 + row] = m[u] + logf(l[u]);
        p.tz[p0 + row] = tt[u];
      }
    }
  }
  cluster_sync();
}

// K3a for D up to 1,024: one block owns 64 tokens, x [64, D] resident in
// shared memory (A of every product, loaded once); w streams in chunks of
// 128 vocab rows x 64 columns of D through a ring of kRStages. Both
// consumer warpgroups read every chunk, each its 64 vocab rows of the tile
// (warpgroup 1 the second half), into a [64, 64] f32 accumulator; the ring
// keeps loading the next tile's chunks during the cap, exp and online
// softmax. No partial logit leaves its thread: a thread carries, for its
// two rows, the running max, sum of exp and target logit over its columns
// of every tile; the 4 threads of a row, then the two warpgroups, merge
// theirs at the end in a fixed order.
constexpr int kRRows = 64;           // tokens of a block
constexpr int kRCols = 128;          // vocab rows of a tile, 64 a warpgroup
constexpr int kRStages = 6;
constexpr int kResidentDim = 1024;   // the largest D whose x stays resident
struct RSmem {
  static constexpr int kX = kRRows * kResidentDim * 2;    // D / 64 boxes
  static constexpr int kStage = kRCols * kRow;            // [128][64] bf16
  static constexpr int kRingAt = kX;
  static constexpr int kMergeAt = kRingAt + kRStages * kStage;
  static constexpr int kMerge = 3 * kRRows * 4;           // (m, l, t) a row
  static constexpr int kBars = kMergeAt + kMerge;
  static constexpr int kNumBars = 2 * kRStages + 1;
  static constexpr int kBytes = kBars + 8 * kNumBars + 1024;  // + alignment
};
static_assert(RSmem::kBytes <= 232448, "a block's shared memory on sm_90");

__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
    xent_fwd_resident_kernel(const __grid_constant__ CUtensorMap tx,
                             const __grid_constant__ CUtensorMap tw,
                             const FwdParams p) {
  using L = RSmem;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kRStages;
  uint64_t* x_bar = empty + kRStages;
  const int nk = p.D / 64;                 // chunks of D
  const int n_vt = (p.V + kRCols - 1) / kRCols;
  const int p0 = blockIdx.x * kRRows;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(x_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(x_bar, kRRows * kRow * nk);
      for (int c = 0; c < nk; ++c)
        tma_load_2d(smem + c * kRRows * kRow, &tx, x_bar, 64 * c, p0);
      // Chunk g = tile * nk + c of the w stream into stage g % kRStages.
      for (int g = 0; g < n_vt * nk; ++g) {
        const int s = g % kRStages;
        mbar_wait(&empty[s], ((g / kRStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], L::kStage);
        tma_load_2d(smem + L::kRingAt + s * L::kStage, &tw, &full[s],
                    64 * (g % nk), g / nk * kRCols);
      }
    }
    __syncthreads();
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  // This thread's rows: warp * 16 + lane / 4 + 8 h.
  float m[2], l[2], tt[2];
  int tg[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = p0 + warp * 16 + lane / 4 + 8 * h;
    m[h] = kNegInf;
    l[h] = 0.f;
    tt[h] = 0.f;
    tg[h] = row < p.M ? p.tgt[row] : -1;
  }
  const uint32_t a_x = desc_base(smem);   // A: all 64 rows of x
  float acc[32];
  // Chunk g: its 4 k16 steps on this warpgroup's 64 vocab rows of the
  // stage, issued once the stage has landed.
  auto issue = [&](int g) {
    const int s = g % kRStages;
    mbar_wait(&full[s], (g / kRStages) & 1);
    const uint32_t a = a_x + (g % nk) * (kRRows * kRow / 16);
    const uint32_t b = desc_base(smem + L::kRingAt + s * L::kStage) +
                       wg * (64 * kRow / 16);
    wgmma_fence();
    static_for<0, 4>([&](auto kk) {
      constexpr int off = desc_off(kk * 32, 16);
      wgmma_ss_n64<0, 0, off, off>(acc, a, b, g % nk > 0 || kk > 0);
    });
    wgmma_commit();
  };
  mbar_wait(x_bar, 0);
  for (int j = 0; j < n_vt; ++j) {
    const int i = j;   // PHASE's tile count
    PHASE(0);
    // The tile's logits: a chunk's stage is freed once the next chunk's
    // products are issued and its own are done.
    fence_regs(acc);
    issue(j * nk);
    for (int c = 1; c < nk; ++c) {
      issue(j * nk + c);
      wgmma_wait_one();
      mbar_arrive(&empty[(j * nk + c - 1) % kRStages]);
    }
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(&empty[(j * nk + nk - 1) % kRStages]);
    PHASE(1);

    // The cap, the mask (-1e30 past V), the target logit, then the online
    // softmax of each row over this thread's 16 columns.
    const int v0 = j * kRCols + wg * 64;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int h = (r >> 1) & 1, col = v0 + acc_col(r, lane);
      float dcap;
      const float zc = capped(acc[r], p.cap, &dcap);
      tt[h] += col == tg[h] ? zc : 0.f;
      acc[r] = col < p.V ? zc : kNegInf;
      mx[h] = fmaxf(mx[h], acc[r]);
    }
    float sum[2] = {0.f, 0.f}, m_new[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) m_new[h] = fmaxf(m[h], mx[h]);
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int h = (r >> 1) & 1;
      sum[h] += v0 + acc_col(r, lane) < p.V ? expf(acc[r] - m_new[h]) : 0.f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] = l[h] * expf(m[h] - m_new[h]) + sum[h];
      m[h] = m_new[h];
    }
    PHASE(2);
  }

  // The 4 threads of a row (lanes 4 q .. 4 q + 3), then warpgroup 1's into
  // warpgroup 0's, in that order.
  float* mg = reinterpret_cast<float*>(smem + L::kMergeAt);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1)
      merge_mlt(m[h], l[h], tt[h], __shfl_xor_sync(0xffffffffu, m[h], o),
                __shfl_xor_sync(0xffffffffu, l[h], o),
                __shfl_xor_sync(0xffffffffu, tt[h], o));
    const int row = warp * 16 + lane / 4 + 8 * h;
    if (wg == 1 && lane % 4 == 0) {
      mg[row] = m[h];
      mg[kRRows + row] = l[h];
      mg[2 * kRRows + row] = tt[h];
    }
  }
  consumers_sync();
  if (wg == 0 && lane % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = warp * 16 + lane / 4 + 8 * h;
      merge_mlt(m[h], l[h], tt[h], mg[row], mg[kRRows + row],
                mg[2 * kRRows + row]);
      if (p0 + row < p.M) {
        p.lse[p0 + row] = m[h] + logf(l[h]);
        p.tz[p0 + row] = tt[h];
      }
    }
  }
  __syncthreads();
}

// The split tiles' rows: the n_split parts' (m, l, t) merged in part order
// (the same in every run).
__global__ void __launch_bounds__(256)
    xent_fwd_merge_kernel(const FwdParams p, int own_tiles) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  const int rt = e / kBP, r = e % kBP;
  const int row = (p.n_whole + rt) * kBP + r;
  if (rt >= own_tiles - p.n_whole || row >= p.M) return;
  const float* po = p.part_out + (size_t)rt * p.n_split * 3 * kBP + r;
  float m = po[0], l = po[kBP], t = po[2 * kBP];
  for (int k = 1; k < p.n_split; ++k) {
    const float* q = po + (size_t)k * 3 * kBP;
    merge_mlt(m, l, t, q[0], q[kBP], q[2 * kBP]);
  }
  p.lse[row] = m + logf(l);
  p.tz[row] = t;
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

// A bf16 [rows, D] tensor as a 2-D tensor map read in [64 columns,
// box_rows] boxes, 128-byte swizzled; rows past the end read as zeros.
bool encode_rows(CUtensorMap* map, const void* base, int rows, int D,
                 int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cuuint64_t(D), cuuint64_t(rows)};
  const cuuint64_t bytes[1] = {cuuint64_t(D) * 2};
  const cuuint32_t box[2] = {64, cuuint32_t(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
            dims, bytes, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool valid(int M, int V, int D) {
  return M >= 1 && V >= 1 && D % kSlice == 0 && D >= kSlice &&
         D <= kMaxCluster * kSlice;
}

template <bool kDx>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(xent_bwd_sm90_kernel<kDx>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Smem::kBytes);
}

cudaError_t set_fwd_smem() {
  return cudaFuncSetAttribute(xent_fwd_sm90_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              FwdSmem::kBytes);
}

// A split plan that leaves every unit at least one streamed tile.
bool valid_split(int own_tiles, int n_tiles, int n_whole, int n_split,
                 const void* part_out) {
  return n_split >= 1 && n_split <= n_tiles && n_whole >= 0 &&
         n_whole <= own_tiles && (n_split == 1) == (n_whole == own_tiles) &&
         (n_split == 1 || part_out != nullptr);
}

template <bool kDx>
int launch(const void* x, const void* w, const void* tgt, const void* lse,
           const void* coef, void* out, int out_bf16, int M, int V, int D,
           float cap, int n_whole, int n_split, void* part_out,
           void* stream) {
  cudaGetLastError();  // clear an earlier, unrelated error
  const int n_own = kDx ? M : V, n_str = kDx ? V : M;
  const int own_tiles = (n_own + kBP - 1) / kBP;
  const int n_tiles = (n_str + kBQ - 1) / kBQ;
  if (!valid(M, V, D) ||
      !valid_split(own_tiles, n_tiles, n_whole, n_split, part_out))
    return int(cudaErrorInvalidValue);
  Params p = {};
  p.tgt = static_cast<const int*>(tgt);
  p.lse = static_cast<const float*>(lse);
  p.coef = static_cast<const float*>(coef);
  p.out = out;
  p.out_bf16 = out_bf16;
  p.M = M;
  p.V = V;
  p.D = D;
  p.cap = cap;
  p.n_tiles = n_tiles;
  p.n_whole = n_whole;
  p.n_split = n_split;
  p.part_out = static_cast<float*>(part_out);
  CUtensorMap maps[2];
  if (!encode_rows(&maps[0], kDx ? x : w, n_own, D, kBP) ||
      !encode_rows(&maps[1], kDx ? w : x, n_str, D, kBQ))
    return -1;
  cudaError_t err = set_smem<kDx>();
  if (err != cudaSuccess) return int(err);
  const int C = D / kSlice;
  const int units = n_whole + (own_tiles - n_whole) * n_split;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = launch_clusters(xent_bwd_sm90_kernel<kDx>, C * units, kThreads, C,
                        Smem::kBytes, st, maps[0], maps[1], p);
  if (err != cudaSuccess) return int(err);
  if (n_split > 1) {
    const long long quads =
        (long long)(own_tiles - n_whole) * kBP * D / 4;
    xent_split_sum_kernel<<<int((quads + 255) / 256), 256, 0, st>>>(p, n_own);
  }
  return int(cudaGetLastError());
}

int launch_fwd(const void* x, const void* w, const void* tgt, void* lse,
               void* tz, int M, int V, int D, float cap, int n_whole,
               int n_split, void* part_out, void* stream) {
  cudaGetLastError();  // clear an earlier, unrelated error
  const int own_tiles = (M + kBP - 1) / kBP;
  const int n_tiles = (V + kBQ - 1) / kBQ;
  if (!valid(M, V, D) ||
      !valid_split(own_tiles, n_tiles, n_whole, n_split, part_out))
    return int(cudaErrorInvalidValue);
  FwdParams p = {};
  p.tgt = static_cast<const int*>(tgt);
  p.lse = static_cast<float*>(lse);
  p.tz = static_cast<float*>(tz);
  p.M = M;
  p.V = V;
  p.D = D;
  p.cap = cap;
  p.n_tiles = n_tiles;
  p.n_whole = n_whole;
  p.n_split = n_split;
  p.part_out = static_cast<float*>(part_out);
  CUtensorMap maps[2];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= kResidentDim) {
    if (n_split != 1) return int(cudaErrorInvalidValue);
    if (!encode_rows(&maps[0], x, M, D, kRRows) ||
        !encode_rows(&maps[1], w, V, D, kRCols))
      return -1;
    cudaError_t err = cudaFuncSetAttribute(
        xent_fwd_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        RSmem::kBytes);
    if (err != cudaSuccess) return int(err);
    xent_fwd_resident_kernel<<<(M + kRRows - 1) / kRRows, kThreads,
                               RSmem::kBytes, st>>>(maps[0], maps[1], p);
    return int(cudaGetLastError());
  }
  if (!encode_rows(&maps[0], x, M, D, kBP) ||
      !encode_rows(&maps[1], w, V, D, kBQ))
    return -1;
  cudaError_t err = set_fwd_smem();
  if (err != cudaSuccess) return int(err);
  const int C = D / kSlice;
  const int units = n_whole + (own_tiles - n_whole) * n_split;
  err = launch_clusters(xent_fwd_sm90_kernel, C * units, kThreads, C,
                        FwdSmem::kBytes, st, maps[0], maps[1], p);
  if (err != cudaSuccess) return int(err);
  if (n_split > 1) {
    const int rows = (own_tiles - n_whole) * kBP;
    xent_fwd_merge_kernel<<<(rows + 255) / 256, 256, 0, st>>>(p, own_tiles);
  }
  return int(cudaGetLastError());
}

}  // namespace

// Each returns a cudaError_t (0 = launched), or -1 when a tensor map cannot
// be encoded (a base TMA does not take). out_bf16: dx / dW written as bf16
// (1) or float32 (0). The own tiles (128 rows of x for dx, of w for dW)
// from n_whole on are split n_split ways along the streamed rows (n_split
// 1: none, n_whole = all); part_out: f32 [(tiles - n_whole) * n_split,
// 128, D], or null without a split.
extern "C" int automl_xent_dx_sm90(const void* x, const void* w,
                                   const void* tgt, const void* lse,
                                   const void* coef, void* dx, int out_bf16,
                                   int M, int V, int D, float cap,
                                   int n_whole, int n_split, void* part_out,
                                   void* stream) {
  return launch<true>(x, w, tgt, lse, coef, dx, out_bf16, M, V, D, cap,
                      n_whole, n_split, part_out, stream);
}

extern "C" int automl_xent_dw_sm90(const void* x, const void* w,
                                   const void* tgt, const void* lse,
                                   const void* coef, void* dw, int out_bf16,
                                   int M, int V, int D, float cap,
                                   int n_whole, int n_split, void* part_out,
                                   void* stream) {
  return launch<false>(x, w, tgt, lse, coef, dw, out_bf16, M, V, D, cap,
                       n_whole, n_split, part_out, stream);
}

// K3a: x [M, D], w [V, D] bf16; targets int32 [M]; lse, tz f32 [M]. The
// own tiles (128 rows of x) from n_whole on are split n_split ways along
// the vocab tiles (n_split 1: none, n_whole = all); part_out: f32
// [(tiles - n_whole) * n_split, 3, 128], or null without a split. Returns
// a cudaError_t, or -1 when a tensor map cannot be encoded.
extern "C" int automl_xent_fwd_sm90(const void* x, const void* w,
                                    const void* tgt, void* lse, void* tz,
                                    int M, int V, int D, float cap,
                                    int n_whole, int n_split, void* part_out,
                                    void* stream) {
  return launch_fwd(x, w, tgt, lse, tz, M, V, D, cap, n_whole, n_split,
                    part_out, stream);
}

// How many clusters of D / 256 blocks of the dW (kind 0), dx (1) or
// forward (2) kernel the card runs at once (cudaOccupancyMaxActiveClusters),
// or -1 on an error.
extern "C" int automl_xent_sm90_clusters(int D, int kind) {
  if (!valid(1, 1, D) || kind < 0 || kind > 2) return -1;
  const int C = D / kSlice;
  const int bytes = kind == 2 ? FwdSmem::kBytes : Smem::kBytes;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * kMaxCluster * 32);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = -1;
  cudaError_t err = kind == 2   ? set_fwd_smem()
                    : kind == 1 ? set_smem<true>()
                                : set_smem<false>();
  if (err != cudaSuccess) return -1;
  if (kind == 2)
    err = cudaOccupancyMaxActiveClusters(&n, (void*)xent_fwd_sm90_kernel, &cfg);
  else if (kind == 1)
    err = cudaOccupancyMaxActiveClusters(
        &n, (void*)xent_bwd_sm90_kernel<true>, &cfg);
  else
    err = cudaOccupancyMaxActiveClusters(
        &n, (void*)xent_bwd_sm90_kernel<false>, &cfg);
  return err == cudaSuccess ? n : -1;
}

#ifdef XENT_PHASE_CLOCKS
extern "C" int automl_xent_phase_clocks(long long* out) {
  return int(cudaMemcpyFromSymbol(out, xent_phase_clocks,
                                  sizeof(xent_phase_clocks)));
}
#endif
