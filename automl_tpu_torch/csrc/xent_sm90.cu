// The fused softmax cross-entropy's backward for bf16 on Hopper (sm_90a):
// dx (K3b) and dW (K3c) on bf16 tensor cores (wgmma), fed by TMA, with the
// model dimension D split across the blocks of a thread-block cluster.
//
// Replaces the Pallas kernels of automl_tpu/ops/xent.py for bf16 operands
// with D a multiple of 256 up to 2,048:
//   * automl_xent_dx_sm90 replaces _dx_kernel (launched by _bwd_pallas):
//     dx = dz . w;
//   * automl_xent_dw_sm90 replaces _dw_kernel (_bwd_pallas): dW = dz^T . x;
// with dz = coef * (exp(z - lse) - onehot(target)) * (1 - tanh^2),
// z = cap * tanh(x . w^T / cap), recomputed tile by tile: the [M, V] logits
// never reach device memory. float32 operands, and bf16 with another D,
// keep the kernels of xent.cu. The interface is theirs: x [M, D] and w
// [V, D] contiguous bf16 (16-byte aligned: what a TMA descriptor takes);
// targets int32 [M]; lse and coef f32 [M]; dx / dW written once, as f32 or
// bf16.
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
// Bound on this card, at the LM slice's shapes (M 16,384 tokens, D 1,024,
// V 100,864): dx and dW each do 4*M*V*D = 6.77 TFLOP (the logit recompute
// plus the product) on at most 0.65 GB of inputs and outputs: bound by
// operations, 6.84 ms each at 989 TFLOP/s, against <= 0.2 ms for the bytes
// at 3.35 TB/s.
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

template <bool kDx>
int launch(const void* x, const void* w, const void* tgt, const void* lse,
           const void* coef, void* out, int out_bf16, int M, int V, int D,
           float cap, int n_whole, int n_split, void* part_out,
           void* stream) {
  cudaGetLastError();  // clear an earlier, unrelated error
  const int n_own = kDx ? M : V, n_str = kDx ? V : M;
  const int own_tiles = (n_own + kBP - 1) / kBP;
  const int n_tiles = (n_str + kBQ - 1) / kBQ;
  if (!valid(M, V, D) || n_split < 1 || n_split > n_tiles || n_whole < 0 ||
      n_whole > own_tiles || (n_split == 1) != (n_whole == own_tiles) ||
      (n_split > 1 && part_out == nullptr))
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

// How many clusters of D / 256 blocks of the dx (dx = 1) or dW kernel the
// card runs at once (cudaOccupancyMaxActiveClusters), or -1 on an error.
extern "C" int automl_xent_sm90_clusters(int D, int dx) {
  if (!valid(1, 1, D)) return -1;
  const int C = D / kSlice;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * kMaxCluster * 32);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Smem::kBytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = -1;
  cudaError_t err = dx ? set_smem<true>() : set_smem<false>();
  if (err == cudaSuccess)
    err = dx ? cudaOccupancyMaxActiveClusters(
                   &n, (void*)xent_bwd_sm90_kernel<true>, &cfg)
             : cudaOccupancyMaxActiveClusters(
                   &n, (void*)xent_bwd_sm90_kernel<false>, &cfg);
  return err == cudaSuccess ? n : -1;
}

#ifdef XENT_PHASE_CLOCKS
extern "C" int automl_xent_phase_clocks(long long* out) {
  return int(cudaMemcpyFromSymbol(out, xent_phase_clocks,
                                  sizeof(xent_phase_clocks)));
}
#endif
