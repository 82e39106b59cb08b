// Flash attention on Hopper (sm_90a): forward (K1), fused backward (K2) and
// the split backward (K5a dq, K5b dk/dv).
//
// Replaces the Pallas kernels of automl_tpu/ops/attention.py:
//   * automl_flash_fwd replaces _fwd_kernel (launched by _flash_fwd_pallas):
//     out = softmax(mask(cap(sm_scale * q k^T))) v and lse = the row
//     logsumexp, online over key tiles;
//   * automl_flash_bwd replaces _bwd_fused_kernel (launched by
//     _flash_bwd_fused_pallas): one recompute of s, p, dp and ds per
//     (q tile, k tile) gives dk, dv (accumulated over q) and dq;
//   * automl_flash_bwd_dq replaces _bwd_dq_kernel and automl_flash_bwd_dkv
//     replaces _bwd_dkv_kernel (both launched by _flash_bwd_pallas): the
//     same recompute twice, once for dq (a block per q tile, looping over
//     the key tiles) and once for dk and dv (a block per key tile, looping
//     over the q tiles).
// All take q, k, v (and g) as [B, T, N, H] through their strides (unit H
// stride), so the TPU wrapper's [B*N, T, H] transposes are not made; lse and
// delta are f32 [B*N, T] (row b*N + n) and segment ids int32 [B, T], not the
// TPU's lane-broadcast [., 128] and [B, 8, T] operands. Masks: causal,
// sliding window (q - k < window), the sequence end (T need not be a multiple
// of a tile) and equal segment ids; a masked key scores -1e30 and gets an
// explicit p = 0, so padded rows make no NaN.
//
// Precision contract (that of the TPU kernels): the s = q k^T and dp = g v^T
// products are exact products of the input-dtype operands summed in f32
// (scalar f32 FMAs on upcast values); sm_scale multiplies the f32 result;
// p v, p^T g, ds^T q and ds k are f32.
//
// Bound on this card, at the LM slice's shapes (B 8, T 2048, N 8, H 128,
// bf16, causal): the forward does 4*B*N*T^2*H/2 = 68.7 GFLOP on 134 MB of
// q/k/v/out, the backward 5 products, 172 GFLOP on about 0.27 GB; the split
// backward's dq kernel 3 products (s, dp, dq; 103 GFLOP) and its dk/dv
// kernel 4 (s, dp, dk, dv; 137 GFLOP). All are bound by operations: 0.070 /
// 0.174 / 0.104 / 0.139 ms at the bf16 tensor-core peak of 989 TFLOP/s,
// against at most 0.08 ms for the bytes at 3.35 TB/s. This first version
// multiplies with scalar f32 FMAs (peak 67 TFLOP/s), so it cannot come
// within 15x of that bound; bf16 mma/wgmma for the s and dp products, and
// TF32 or bf16 for the others with a gradient test of their own, are later
// work.
//
// Design. The TPU grid runs its k (or q) axis in order and carries the
// online-softmax state (or dk/dv, or dq) in VMEM scratch; here blocks run in
// any order, so one block owns a (row b*N + n, q tile) and loops over the
// key tiles (forward, dq), or a (row, k tile) and loops over the q tiles,
// keeping dk and dv in registers in f32 (fused backward, dk/dv). Tiles that
// causality or the window leave empty are not visited. The dq kernel keeps
// its dq tile in f32 registers over the key tiles and writes it once: no
// atomics, no partials. The fused backward sums dq over key tiles with f32
// atomicAdd into one [B, T, N, H] f32 buffer (the caller zeroes it and casts
// it), so the TPU's [num_k, B*N, T, H] partial buffer is not made; a
// counter per q tile makes the key tiles add in a fixed order
// (wait_for_turn), so dq, and a training run, are the same from run to run.
// The dk/dv kernel is the fused backward's kernel without its dq half.
// Operand tiles are staged in shared memory as f32, each in the layout its
// product reads with 16-byte vectors (transposed for the q k^T and g v^T
// contractions); each thread keeps a 4x4 (forward, dq) or 2x4 / 4x4
// (backward) register tile of every product. Head dims up to 64 are padded
// to 64, up to 128 to 128.
//
// Plain C interface, loaded with ctypes (automl_tpu_torch/ops/cuda_build.py).
// The kernels allocate nothing; the launchers return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;  // the TPU kernels' NEG_INF
constexpr int kFwdBQ = 64, kFwdBK = 64;
constexpr int kBwdBQ = 32, kBwdBK = 64;
constexpr int kDqBQ = 64, kDqBK = 64;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {
  long long b, t, n;  // elements
};

struct Common {
  int B, T, N, H;
  int causal;
  int window;   // < 0: no window
  float cap;    // 0: no cap
  float scale;
};

struct FwdParams {
  const void *q, *k, *v;
  const int* seg;  // [B, T] or null
  void* out;       // [B, T, N, H], contiguous
  float* lse;      // [B*N, T]
  Strides qs, ks, vs;
  Common c;
};

struct BwdParams {
  const void *q, *k, *v, *g;
  const int* seg;
  const float* lse;    // [B*N, T]
  const float* delta;  // [B*N, T]
  float* dq32;         // fused: [B, T, N, H] f32, zeroed by the caller
  int* dq_turn;        // fused: [B*N, T] (one per q tile used), zeroed
  void* dq;            // dq kernel: [B, T, N, H]
  void *dk, *dv;       // [B, T, N, H]
  Strides qs, ks, vs, gs;
  Common c;
};

__device__ __forceinline__ bool live(int qp, int kp, const Common& c,
                                     const int* seg) {
  if (qp >= c.T || kp >= c.T) return false;
  if (c.causal && qp < kp) return false;
  if (c.window >= 0 && qp - kp >= c.window) return false;
  if (seg != nullptr && seg[qp] != seg[kp]) return false;
  return true;
}

// Rows [r0, r0 + R) of one (b, n) head, upcast to f32, into shared memory:
// natural nat[r * ld_nat + h] and/or transposed tr[h * ld_tr + r]. Rows past
// T and columns past H are zero.
template <typename T, int HP>
__device__ void load_rows(const T* __restrict__ base, long long st, int r0,
                          int R, const Common& c, float* nat, int ld_nat,
                          float* tr, int ld_tr) {
  for (int e = threadIdx.x; e < R * HP; e += kThreads) {
    const int r = e / HP, h = e % HP;
    float x = 0.f;
    if (r0 + r < c.T && h < c.H) x = to_f32(base[(long long)(r0 + r) * st + h]);
    if (nat != nullptr) nat[r * ld_nat + h] = x;
    if (tr != nullptr) tr[h * ld_tr + r] = x;
  }
}

__device__ __forceinline__ float group16_max(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group16_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float capped(float s, float cap, float* dcap) {
  if (cap > 0.f) {
    const float th = tanhf(s / cap);
    *dcap = 1.f - th * th;
    return cap * th;
  }
  *dcap = 1.f;
  return s;
}

template <int HP>
constexpr size_t fwd_smem_bytes() {
  constexpr int ldt = kFwdBQ + 4, ldv = HP + 4;
  return sizeof(float) * (2 * HP * ldt + kFwdBK * ldv + kFwdBK * ldt);
}

// One block: 64 queries of one (b, n); thread (ty, tx) holds rows ty*4..+3,
// score columns tx*4..+3 and output columns cg*64 + tx*4..+3.
template <typename T, int HP>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FwdParams p) {
  constexpr int BQ = kFwdBQ, BK = kFwdBK;
  constexpr int LDT = BQ + 4, LDV = HP + 4, CW = HP / 64;
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;             // [HP][LDT]
  float* kT = qT + HP * LDT;    // [HP][LDT]
  float* vn = kT + HP * LDT;    // [BK][LDV]
  float* pT = vn + BK * LDV;    // [BK][LDT]

  const Common& c = p.c;
  const int bn = blockIdx.y, b = bn / c.N, n = bn % c.N;
  const int q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* qb = static_cast<const T*>(p.q) + b * p.qs.b + n * p.qs.n;
  const T* kb = static_cast<const T*>(p.k) + b * p.ks.b + n * p.ks.n;
  const T* vb = static_cast<const T*>(p.v) + b * p.vs.b + n * p.vs.n;
  const int* seg = p.seg != nullptr ? p.seg + (long long)b * c.T : nullptr;

  load_rows<T, HP>(qb, p.qs.t, q0, BQ, c, nullptr, 0, qT, LDT);

  float acc[4][4 * CW];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * CW; ++j) acc[i][j] = 0.f;
  }

  // Key tiles that hold a live key for some query of this tile.
  int k_end = c.T;
  if (c.causal) k_end = min(c.T, q0 + BQ);
  int k_begin = 0;
  if (c.window >= 0) k_begin = max(0, q0 - c.window + 1) / BK * BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, HP>(kb, p.ks.t, k0, BK, c, nullptr, 0, kT, LDT);
    load_rows<T, HP>(vb, p.vs.t, k0, BK, c, vn, LDV, nullptr, 0);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int h = 0; h < HP; ++h) {
      const float4 a = *reinterpret_cast<const float4*>(qT + h * LDT + ty * 4);
      const float4 kk = *reinterpret_cast<const float4*>(kT + h * LDT + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], kv[j], s[i][j]);
    }

    // Online softmax: a query row's 64 keys lie on the 16 threads of its ty.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = live(qp, k0 + tx * 4 + j, c, seg);
        float dcap;
        const float x = capped(c.scale * s[i][j], c.cap, &dcap);
        s[i][j] = ok[j] ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = group16_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
      sum = group16_sum(sum);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * CW; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pT + (tx * 4 + j) * LDT + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(pT + kk * LDT + ty * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int cg = 0; cg < CW; ++cg) {
        const float4 vv =
            *reinterpret_cast<const float4*>(vn + kk * LDV + cg * 64 + tx * 4);
        const float vf[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][cg * 4 + j] = fmaf(av[i], vf[j], acc[i][cg * 4 + j]);
      }
    }
  }

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= c.T) continue;
    const float ll = fmaxf(l[i], 1e-30f);
    const long long row = (((long long)b * c.T + qp) * c.N + n) * c.H;
#pragma unroll
    for (int cg = 0; cg < CW; ++cg)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int h = cg * 64 + tx * 4 + j;
        if (h < c.H) out[row + h] = from_f32<T>(acc[i][cg * 4 + j] / ll);
      }
    if (tx == 0) p.lse[(long long)bn * c.T + qp] = m[i] + logf(ll);
  }
}

// The order of dq's sum: dq of one q tile is summed over the key tiles that
// visit it in a fixed order (the last key tile first), so that dq is the same
// bit for bit from run to run. Each block waits until the q tile's counter
// equals its rank, adds its part with atomics (performed in L2), and passes
// the turn on. Blocks run in any order, but the hardware hands them out by
// block index, and the last key tile has the lowest index: a block waits
// only on blocks already running or done, so it cannot deadlock. Under
// causal masking a block trails the next key tile's block by two q tiles
// and seldom waits. A wait of seconds traps: a fault, not a hang.
__device__ void wait_for_turn(int* turn, int rank) {
  if (threadIdx.x == 0) {
    long long polls = 0;
    while (atomicAdd(turn, 0) != rank) {
      __nanosleep(64);
      if (++polls > (1ll << 26)) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// The barrier orders the block's dq atomics before thread 0's fence, and the
// fence (cumulative) makes them visible before the turn moves.
__device__ void pass_turn(int* turn) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(turn, 1);
  }
}

template <int HP, bool kDq>
constexpr size_t bwd_smem_bytes() {
  constexpr int ldq = kBwdBQ + 4, ldk = kBwdBK + 4, ldh = HP + 4;
  return sizeof(float) *
         (2 * HP * ldk + kBwdBK * ldh            // kT, vT, k
          + 2 * HP * ldq + 2 * kBwdBQ * ldh      // qT, gT, q, g
          + 2 * kBwdBQ * ldk                     // p, ds
          + (kDq ? kBwdBK * ldq : 0)             // ds^T
          + 2 * kBwdBQ);                         // lse, delta
}

// One block: 64 keys of one (b, n), looping over 32-query tiles. Thread
// (ty, tx): s/dp rows ty*2..+1, columns tx*4..+3; dk/dv rows (keys)
// ty*4..+3 and dq rows ty*2..+1, columns cg*64 + tx*4..+3. kDq: the fused
// backward (K2), which also sums dq; without it, the split backward's dk/dv
// kernel (K5b).
template <typename T, int HP, bool kDq>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_kernel(BwdParams p) {
  constexpr int BQ = kBwdBQ, BK = kBwdBK;
  constexpr int LDQ = BQ + 4, LDK = BK + 4, LDH = HP + 4, CW = HP / 64;
  extern __shared__ __align__(16) float smem[];
  float* kT = smem;              // [HP][LDK]
  float* vT = kT + HP * LDK;     // [HP][LDK]
  float* kn = vT + HP * LDK;     // [BK][LDH]
  float* qT = kn + BK * LDH;     // [HP][LDQ]
  float* gT = qT + HP * LDQ;     // [HP][LDQ]
  float* qn = gT + HP * LDQ;     // [BQ][LDH]
  float* gn = qn + BQ * LDH;     // [BQ][LDH]
  float* ps = gn + BQ * LDH;     // [BQ][LDK]  p
  float* dss = ps + BQ * LDK;    // [BQ][LDK]  ds
  float* dsT = dss + BQ * LDK;   // [BK][LDQ]  ds^T (kDq only)
  float* lse_s = dsT + (kDq ? BK * LDQ : 0);  // [BQ]
  float* delta_s = lse_s + BQ;   // [BQ]

  const Common& c = p.c;
  const int bn = blockIdx.y, b = bn / c.N, n = bn % c.N;
  // The last key tile gets the lowest block index: see wait_for_turn.
  const int n_kt = gridDim.x, kt = n_kt - 1 - blockIdx.x;
  const int k0 = kt * BK;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* qb = static_cast<const T*>(p.q) + b * p.qs.b + n * p.qs.n;
  const T* kb = static_cast<const T*>(p.k) + b * p.ks.b + n * p.ks.n;
  const T* vb = static_cast<const T*>(p.v) + b * p.vs.b + n * p.vs.n;
  const T* gb = static_cast<const T*>(p.g) + b * p.gs.b + n * p.gs.n;
  const int* seg = p.seg != nullptr ? p.seg + (long long)b * c.T : nullptr;

  load_rows<T, HP>(kb, p.ks.t, k0, BK, c, kn, LDH, kT, LDK);
  load_rows<T, HP>(vb, p.vs.t, k0, BK, c, nullptr, 0, vT, LDK);

  float dk[4][4 * CW], dv[4][4 * CW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * CW; ++j) dk[i][j] = dv[i][j] = 0.f;

  // Query tiles that hold a live query for some key of this tile.
  const int q_begin = c.causal ? k0 / BQ * BQ : 0;
  int q_end = c.T;
  if (c.window >= 0) q_end = min(c.T, min(k0 + BK, c.T) - 1 + c.window);

  for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, HP>(qb, p.qs.t, q0, BQ, c, qn, LDH, qT, LDQ);
    load_rows<T, HP>(gb, p.gs.t, q0, BQ, c, gn, LDH, gT, LDQ);
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
      const bool in = q0 + r < c.T;
      const long long i = (long long)bn * c.T + q0 + r;
      lse_s[r] = in ? p.lse[i] : 0.f;
      delta_s[r] = in ? p.delta[i] : 0.f;
    }
    __syncthreads();

    float s[2][4], dp[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int h = 0; h < HP; ++h) {
      const float2 qa = *reinterpret_cast<const float2*>(qT + h * LDQ + ty * 2);
      const float2 ga = *reinterpret_cast<const float2*>(gT + h * LDQ + ty * 2);
      const float4 kk = *reinterpret_cast<const float4*>(kT + h * LDK + tx * 4);
      const float4 vv = *reinterpret_cast<const float4*>(vT + h * LDK + tx * 4);
      const float qv[2] = {qa.x, qa.y}, gv[2] = {ga.x, ga.y};
      const float kf[4] = {kk.x, kk.y, kk.z, kk.w};
      const float vf[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kf[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vf[j], dp[i][j]);
        }
    }

    float pv[2][4], dsv[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ty * 2 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float dcap;
        const float x = capped(c.scale * s[i][j], c.cap, &dcap);
        const bool ok = live(q0 + r, k0 + tx * 4 + j, c, seg);
        pv[i][j] = ok ? expf(x - lse_s[r]) : 0.f;
        dsv[i][j] = ok ? pv[i][j] * (dp[i][j] - delta_s[r]) * dcap : 0.f;
      }
      *reinterpret_cast<float4*>(ps + r * LDK + tx * 4) =
          make_float4(pv[i][0], pv[i][1], pv[i][2], pv[i][3]);
      *reinterpret_cast<float4*>(dss + r * LDK + tx * 4) =
          make_float4(dsv[i][0], dsv[i][1], dsv[i][2], dsv[i][3]);
    }
    if (kDq) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float2*>(dsT + (tx * 4 + j) * LDQ + ty * 2) =
            make_float2(dsv[0][j], dsv[1][j]);
    }
    __syncthreads();

    // dv += p^T g, dk += ds^T q (sm_scale at the end), over this tile's rows.
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      const float4 pa = *reinterpret_cast<const float4*>(ps + r * LDK + ty * 4);
      const float4 da = *reinterpret_cast<const float4*>(dss + r * LDK + ty * 4);
      const float pf[4] = {pa.x, pa.y, pa.z, pa.w};
      const float df[4] = {da.x, da.y, da.z, da.w};
#pragma unroll
      for (int cg = 0; cg < CW; ++cg) {
        const float4 gg =
            *reinterpret_cast<const float4*>(gn + r * LDH + cg * 64 + tx * 4);
        const float4 qq =
            *reinterpret_cast<const float4*>(qn + r * LDH + cg * 64 + tx * 4);
        const float gf[4] = {gg.x, gg.y, gg.z, gg.w};
        const float qf[4] = {qq.x, qq.y, qq.z, qq.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            dv[i][cg * 4 + j] = fmaf(pf[i], gf[j], dv[i][cg * 4 + j]);
            dk[i][cg * 4 + j] = fmaf(df[i], qf[j], dk[i][cg * 4 + j]);
          }
      }
    }

    if (!kDq) continue;
    // dq += sm_scale * ds k for this q tile, summed over the k tiles in a
    // fixed order (wait_for_turn).
    float dq[2][4 * CW];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4 * CW; ++j) dq[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float2 d2 = *reinterpret_cast<const float2*>(dsT + kk * LDQ + ty * 2);
      const float df[2] = {d2.x, d2.y};
#pragma unroll
      for (int cg = 0; cg < CW; ++cg) {
        const float4 k4 =
            *reinterpret_cast<const float4*>(kn + kk * LDH + cg * 64 + tx * 4);
        const float kf[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            dq[i][cg * 4 + j] = fmaf(df[i], kf[j], dq[i][cg * 4 + j]);
      }
    }
    // The key tiles that visit this q tile are a contiguous range ending at
    // the last one whose causal start is <= q0; they add from the last down.
    const int k_last = c.causal ? min(n_kt - 1, q0 / BK) : n_kt - 1;
    int* turn = p.dq_turn + (long long)bn * c.T + q0 / BQ;
    wait_for_turn(turn, k_last - kt);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qp = q0 + ty * 2 + i;
      if (qp >= c.T) continue;
      float* row = p.dq32 + (((long long)b * c.T + qp) * c.N + n) * c.H;
#pragma unroll
      for (int cg = 0; cg < CW; ++cg)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int h = cg * 64 + tx * 4 + j;
          if (h < c.H) atomicAdd(row + h, c.scale * dq[i][cg * 4 + j]);
        }
    }
    pass_turn(turn);
  }

  T* dk_out = static_cast<T*>(p.dk);
  T* dv_out = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty * 4 + i;
    if (kp >= c.T) continue;
    const long long row = (((long long)b * c.T + kp) * c.N + n) * c.H;
#pragma unroll
    for (int cg = 0; cg < CW; ++cg)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int h = cg * 64 + tx * 4 + j;
        if (h < c.H) {
          dk_out[row + h] = from_f32<T>(c.scale * dk[i][cg * 4 + j]);
          dv_out[row + h] = from_f32<T>(dv[i][cg * 4 + j]);
        }
      }
  }
}

template <int HP>
constexpr size_t dq_smem_bytes() {
  constexpr int ldt = kDqBQ + 4, ldh = HP + 4;
  return sizeof(float) *
         (4 * HP * ldt                   // qT, gT, kT, vT
          + kDqBK * ldh + kDqBK * ldt    // k, ds^T
          + 2 * kDqBQ);                  // lse, delta
}

// The split backward's dq kernel (K5a). One block: 64 queries of one
// (b, n), looping over the live 64-key tiles; dq stays in f32 registers and
// is written once, in q's dtype. Thread (ty, tx): s/dp rows ty*4..+3,
// columns tx*4..+3; dq rows ty*4..+3, columns cg*64 + tx*4..+3.
template <typename T, int HP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(BwdParams p) {
  constexpr int BQ = kDqBQ, BK = kDqBK;
  static_assert(BQ == BK, "the transposed tiles share one leading dim");
  constexpr int LDT = BQ + 4, LDH = HP + 4, CW = HP / 64;
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;               // [HP][LDT]
  float* gT = qT + HP * LDT;      // [HP][LDT]
  float* kT = gT + HP * LDT;      // [HP][LDT]
  float* vT = kT + HP * LDT;      // [HP][LDT]
  float* kn = vT + HP * LDT;      // [BK][LDH]
  float* dsT = kn + BK * LDH;     // [BK][LDT]  ds^T
  float* lse_s = dsT + BK * LDT;  // [BQ]
  float* delta_s = lse_s + BQ;    // [BQ]

  const Common& c = p.c;
  const int bn = blockIdx.y, b = bn / c.N, n = bn % c.N;
  const int q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* qb = static_cast<const T*>(p.q) + b * p.qs.b + n * p.qs.n;
  const T* kb = static_cast<const T*>(p.k) + b * p.ks.b + n * p.ks.n;
  const T* vb = static_cast<const T*>(p.v) + b * p.vs.b + n * p.vs.n;
  const T* gb = static_cast<const T*>(p.g) + b * p.gs.b + n * p.gs.n;
  const int* seg = p.seg != nullptr ? p.seg + (long long)b * c.T : nullptr;

  load_rows<T, HP>(qb, p.qs.t, q0, BQ, c, nullptr, 0, qT, LDT);
  load_rows<T, HP>(gb, p.gs.t, q0, BQ, c, nullptr, 0, gT, LDT);
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const bool in = q0 + r < c.T;
    const long long i = (long long)bn * c.T + q0 + r;
    lse_s[r] = in ? p.lse[i] : 0.f;
    delta_s[r] = in ? p.delta[i] : 0.f;
  }

  float dq[4][4 * CW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * CW; ++j) dq[i][j] = 0.f;

  // Key tiles that hold a live key for some query of this tile (as K1).
  int k_end = c.T;
  if (c.causal) k_end = min(c.T, q0 + BQ);
  int k_begin = 0;
  if (c.window >= 0) k_begin = max(0, q0 - c.window + 1) / BK * BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, HP>(kb, p.ks.t, k0, BK, c, kn, LDH, kT, LDT);
    load_rows<T, HP>(vb, p.vs.t, k0, BK, c, nullptr, 0, vT, LDT);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int h = 0; h < HP; ++h) {
      const float4 qa = *reinterpret_cast<const float4*>(qT + h * LDT + ty * 4);
      const float4 ga = *reinterpret_cast<const float4*>(gT + h * LDT + ty * 4);
      const float4 kk = *reinterpret_cast<const float4*>(kT + h * LDT + tx * 4);
      const float4 vv = *reinterpret_cast<const float4*>(vT + h * LDT + tx * 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float gv[4] = {ga.x, ga.y, ga.z, ga.w};
      const float kf[4] = {kk.x, kk.y, kk.z, kk.w};
      const float vf[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kf[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vf[j], dp[i][j]);
        }
    }

    // ds = p (dp - delta) dcap, stored transposed for the ds k product.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float dcap;
        const float x = capped(c.scale * s[i][j], c.cap, &dcap);
        const bool ok = live(q0 + r, k0 + tx * 4 + j, c, seg);
        const float pv = ok ? expf(x - lse_s[r]) : 0.f;
        s[i][j] = ok ? pv * (dp[i][j] - delta_s[r]) * dcap : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(dsT + (tx * 4 + j) * LDT + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // dq += ds k (sm_scale at the end).
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 d4 = *reinterpret_cast<const float4*>(dsT + kk * LDT + ty * 4);
      const float df[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int cg = 0; cg < CW; ++cg) {
        const float4 k4 =
            *reinterpret_cast<const float4*>(kn + kk * LDH + cg * 64 + tx * 4);
        const float kf[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            dq[i][cg * 4 + j] = fmaf(df[i], kf[j], dq[i][cg * 4 + j]);
      }
    }
  }

  T* dq_out = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= c.T) continue;
    const long long row = (((long long)b * c.T + qp) * c.N + n) * c.H;
#pragma unroll
    for (int cg = 0; cg < CW; ++cg)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int h = cg * 64 + tx * 4 + j;
        if (h < c.H) dq_out[row + h] = from_f32<T>(c.scale * dq[i][cg * 4 + j]);
      }
  }
}

template <typename T, int HP>
cudaError_t launch_fwd(const FwdParams& p, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<HP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.c.T + kFwdBQ - 1) / kFwdBQ, p.c.B * p.c.N);
  flash_fwd_kernel<T, HP><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// kDq: the fused backward (K2); without it, the dk/dv kernel (K5b).
template <typename T, int HP, bool kDq>
cudaError_t launch_bwd(const BwdParams& p, cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<HP, kDq>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<T, HP, kDq>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.c.T + kBwdBK - 1) / kBwdBK, p.c.B * p.c.N);
  flash_bwd_kernel<T, HP, kDq><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int HP>
cudaError_t launch_bwd_dq(const BwdParams& p, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<HP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, HP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.c.T + kDqBQ - 1) / kDqBQ, p.c.B * p.c.N);
  flash_bwd_dq_kernel<T, HP><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

bool valid(const Common& c, int dtype) {
  return c.B >= 1 && c.T >= 1 && c.N >= 1 && c.H >= 1 && c.H <= 128 &&
         (long long)c.B * c.N <= 65535 && dtype >= 0 && dtype <= 1;
}

Common make_common(int B, int T, int N, int H, int causal, int window,
                   float cap, float scale) {
  Common c;
  c.B = B;
  c.T = T;
  c.N = N;
  c.H = H;
  c.causal = causal;
  c.window = window;
  c.cap = cap;
  c.scale = scale;
  return c;
}

}  // namespace

// Each returns a cudaError_t (0 = launched). dtype: 0 = float32, 1 = bf16.
extern "C" int automl_flash_fwd(
    const void* q, const void* k, const void* v, const void* seg, void* out,
    void* lse, int dtype, long long q_sb, long long q_st, long long q_sn,
    long long k_sb, long long k_st, long long k_sn, long long v_sb,
    long long v_st, long long v_sn, int B, int T, int N, int H, int causal,
    int window, float cap, float scale, void* stream) {
  cudaGetLastError();  // clear an earlier, unrelated error
  FwdParams p;
  p.c = make_common(B, T, N, H, causal, window, cap, scale);
  if (!valid(p.c, dtype)) return int(cudaErrorInvalidValue);
  p.q = q;
  p.k = k;
  p.v = v;
  p.seg = static_cast<const int*>(seg);
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.qs = Strides{q_sb, q_st, q_sn};
  p.ks = Strides{k_sb, k_st, k_sn};
  p.vs = Strides{v_sb, v_st, v_sn};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = H <= 64 ? launch_fwd<float, 64>(p, s) : launch_fwd<float, 128>(p, s);
  else
    err = H <= 64 ? launch_fwd<__nv_bfloat16, 64>(p, s)
                  : launch_fwd<__nv_bfloat16, 128>(p, s);
  return int(err);
}

namespace {

// The backward kernels' common parameters; outputs are set by the caller.
BwdParams bwd_params(const void* q, const void* k, const void* v,
                     const void* g, const void* seg, const void* lse,
                     const void* delta, const long long* st, int B, int T,
                     int N, int H, int causal, int window, float cap,
                     float scale) {
  BwdParams p = {};
  p.c = make_common(B, T, N, H, causal, window, cap, scale);
  p.q = q;
  p.k = k;
  p.v = v;
  p.g = g;
  p.seg = static_cast<const int*>(seg);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.qs = Strides{st[0], st[1], st[2]};
  p.ks = Strides{st[3], st[4], st[5]};
  p.vs = Strides{st[6], st[7], st[8]};
  p.gs = Strides{st[9], st[10], st[11]};
  return p;
}

}  // namespace

extern "C" int automl_flash_bwd(
    const void* q, const void* k, const void* v, const void* g,
    const void* seg, const void* lse, const void* delta, void* dq32,
    void* dq_turn, void* dk, void* dv, int dtype, long long q_sb,
    long long q_st, long long q_sn, long long k_sb, long long k_st,
    long long k_sn, long long v_sb, long long v_st, long long v_sn,
    long long g_sb, long long g_st, long long g_sn, int B, int T, int N,
    int H, int causal, int window, float cap, float scale, void* stream) {
  cudaGetLastError();
  const long long st[12] = {q_sb, q_st, q_sn, k_sb, k_st, k_sn,
                            v_sb, v_st, v_sn, g_sb, g_st, g_sn};
  BwdParams p = bwd_params(q, k, v, g, seg, lse, delta, st, B, T, N, H,
                           causal, window, cap, scale);
  if (!valid(p.c, dtype)) return int(cudaErrorInvalidValue);
  p.dq32 = static_cast<float*>(dq32);
  p.dq_turn = static_cast<int*>(dq_turn);
  p.dk = dk;
  p.dv = dv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = H <= 64 ? launch_bwd<float, 64, true>(p, s)
                  : launch_bwd<float, 128, true>(p, s);
  else
    err = H <= 64 ? launch_bwd<__nv_bfloat16, 64, true>(p, s)
                  : launch_bwd<__nv_bfloat16, 128, true>(p, s);
  return int(err);
}

extern "C" int automl_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* g,
    const void* seg, const void* lse, const void* delta, void* dq, int dtype,
    long long q_sb, long long q_st, long long q_sn, long long k_sb,
    long long k_st, long long k_sn, long long v_sb, long long v_st,
    long long v_sn, long long g_sb, long long g_st, long long g_sn, int B,
    int T, int N, int H, int causal, int window, float cap, float scale,
    void* stream) {
  cudaGetLastError();
  const long long st[12] = {q_sb, q_st, q_sn, k_sb, k_st, k_sn,
                            v_sb, v_st, v_sn, g_sb, g_st, g_sn};
  BwdParams p = bwd_params(q, k, v, g, seg, lse, delta, st, B, T, N, H,
                           causal, window, cap, scale);
  if (!valid(p.c, dtype)) return int(cudaErrorInvalidValue);
  p.dq = dq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = H <= 64 ? launch_bwd_dq<float, 64>(p, s)
                  : launch_bwd_dq<float, 128>(p, s);
  else
    err = H <= 64 ? launch_bwd_dq<__nv_bfloat16, 64>(p, s)
                  : launch_bwd_dq<__nv_bfloat16, 128>(p, s);
  return int(err);
}

extern "C" int automl_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* g,
    const void* seg, const void* lse, const void* delta, void* dk, void* dv,
    int dtype, long long q_sb, long long q_st, long long q_sn, long long k_sb,
    long long k_st, long long k_sn, long long v_sb, long long v_st,
    long long v_sn, long long g_sb, long long g_st, long long g_sn, int B,
    int T, int N, int H, int causal, int window, float cap, float scale,
    void* stream) {
  cudaGetLastError();
  const long long st[12] = {q_sb, q_st, q_sn, k_sb, k_st, k_sn,
                            v_sb, v_st, v_sn, g_sb, g_st, g_sn};
  BwdParams p = bwd_params(q, k, v, g, seg, lse, delta, st, B, T, N, H,
                           causal, window, cap, scale);
  if (!valid(p.c, dtype)) return int(cudaErrorInvalidValue);
  p.dk = dk;
  p.dv = dv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = H <= 64 ? launch_bwd<float, 64, false>(p, s)
                  : launch_bwd<float, 128, false>(p, s);
  else
    err = H <= 64 ? launch_bwd<__nv_bfloat16, 64, false>(p, s)
                  : launch_bwd<__nv_bfloat16, 128, false>(p, s);
  return int(err);
}
