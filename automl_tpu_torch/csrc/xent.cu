// Fused softmax cross-entropy on Hopper (sm_90a): forward (K3a), dx (K3b)
// and dW (K3c). The [M, V] logits never reach device memory.
//
// Replaces the Pallas kernels of automl_tpu/ops/xent.py:
//   * automl_xent_fwd replaces _fwd_kernel (launched by _fwd_pallas): per
//     token the logsumexp of its capped logits z = cap * tanh(x.w / cap),
//     online over vocab tiles, and the target's logit tz;
//   * automl_xent_dx replaces _dx_kernel (_bwd_pallas): dx = dz . w;
//   * automl_xent_dw replaces _dw_kernel (_bwd_pallas): dW = dz^T . x;
// with dz = coef * (exp(z - lse) - onehot(target)) * (1 - tanh^2)
// recomputed tile by tile. x [M, D] and w [V, D] are contiguous rows at the
// operand dtype (bf16, or f32 for golden tests), D a multiple of 8; targets
// int32 [M]; lse, tz and coef f32 [M], not the TPU's lane-broadcast
// [M, 128] operands and (8, M) outputs.
//
// Precision contract (that of the TPU kernels): logits are products of
// operand-dtype values summed in f32; the cap and its derivative are taken
// at the raw logits; exp, the logsumexp and dz are f32; dz is rounded to the
// operand dtype before the dx and dW products, which sum in f32. The bf16
// instantiation multiplies on the tensor cores (wmma 16x16x16 bf16 with f32
// accumulation); the f32 instantiation, which serves tests only, with
// scalar f32 FMAs, so nothing is rounded. Masks: vocab columns >= V score
// -1e30 in the forward and get dz = 0; rows of w past V and of x past M are
// loaded as zeros (zero-filling copies), so 0 * NaN never enters a sum.
//
// Bound on this card, at the LM slice's shapes (M 16,384 tokens, D 1,024,
// V 100,864, bf16): the forward does 2*M*V*D = 3.38 TFLOP, dx and dW 6.77
// TFLOP each (the logit recompute plus the product), on at most 0.65 GB of
// inputs and outputs each: bound by operations, 3.42 / 6.84 / 6.84 ms at
// 989 TFLOP/s, against <= 0.2 ms for the bytes at 3.35 TB/s.
//
// Design. The TPU grid walks its vocab (or token) axis in order and carries
// the online-softmax state (or the dx / dW accumulator) in VMEM scratch;
// here one block owns a tile of rows and loops over the other axis. Every
// product is a tile GEMM whose D (or vocab / token) axis is staged through
// shared memory in chunks by cp.async, two stages deep, so the next chunk
// loads while the tensor cores work on this one.
//   * K3a: a block owns 64 tokens and walks V in tiles of 128; the 64 x 128
//     logit tile goes to shared memory and a warp keeps the running
//     (max, sum, target logit) of 8 rows.
//   * K3b / K3c: one kernel, "own" rows P and "streamed" rows Q. K3b: P = x
//     (32 tokens a block), Q = w; K3c: P = w (32 vocab rows), Q = x. Per
//     streamed tile of 128 rows: z = P . Q^T (the logits, or their
//     transpose), dz in the operand dtype in shared memory, then
//     acc[32, D] += dz . Q in f32. acc lives in shared memory (128 KB at
//     D = 1,024), which bounds D (automl_xent_max_dim); the logit's D is
//     never split across blocks. Each block owns its output rows and sums
//     in a fixed order: no atomics, so two calls give bit-equal results.
// What holds them back: the tiles re-read their operands from L2, 79 GB per
// K3a call and ~235 GB per K3b / K3c call at the slice's shapes (K3b/K3c
// read each streamed tile twice), which at their times on the H100
// (PERF.md) is 2.4-2.7 TB/s. For bf16 operands with D a multiple of 256 up
// to 2,048 (the LM's), K3a, K3b and K3c run the Hopper kernels of
// xent_sm90.cu instead (a cluster splits D; wgmma fed by TMA); the kernels
// here serve float32 operands and other bf16 D.
//
// Plain C interface, loaded with ctypes (automl_tpu_torch/ops/cuda_build.py).
// The kernels allocate nothing; the launchers return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;        // 8 warps
constexpr float kNegInf = -1e30f;    // the TPU kernels' NEG_INF
constexpr int kMaxSmem = 232448;     // a block's shared memory on sm_90

// Chunk of the contracted axis staged per step: 128 bytes of a row.
template <typename T>
struct Op;
template <>
struct Op<bf16> {
  static constexpr int BK = 64, PAD = 8;
};
template <>
struct Op<float> {
  static constexpr int BK = 32, PAD = 4;
};

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

struct Params {
  const void* x;       // [M, D] operand dtype
  const void* w;       // [V, D] operand dtype
  const int* tgt;      // [M]
  const float* lse;    // [M] (backward)
  const float* coef;   // [M] (backward)
  float* lse_out;      // [M] (forward)
  float* tz_out;       // [M] (forward)
  void* out;           // dx [M, D] or dW [V, D], f32 or bf16 (out_bf16)
  int out_bf16;
  int M, V, D;
  float cap;           // 0: no cap
};

__device__ __forceinline__ float capped(float z, float cap, float* dcap) {
  if (cap > 0.f) {
    const float th = tanhf(z / cap);
    *dcap = 1.f - th * th;
    return cap * th;
  }
  *dcap = 1.f;
  return z;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 16 bytes global -> shared, asynchronously; zero-filled when !in.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = in ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + R) and columns [k0, k0 + BK) of a [n_rows, D] matrix
// into dst [R][BK + PAD]; rows past n_rows and columns past D are zeros.
// D is a multiple of 8, so a 16-byte vector is wholly inside or outside.
template <typename T, int R>
__device__ __forceinline__ void load_chunk(T* dst, const T* src, int row0,
                                           int n_rows, int D, int k0) {
  constexpr int BK = Op<T>::BK, LDK = BK + Op<T>::PAD;
  constexpr int VEC = 16 / sizeof(T), PER_ROW = BK / VEC;
  for (int e = threadIdx.x; e < R * PER_ROW; e += kThreads) {
    const int r = e / PER_ROW, c = (e % PER_ROW) * VEC;
    const bool in = row0 + r < n_rows && k0 + c < D;
    const T* g = in ? src + (long long)(row0 + r) * D + k0 + c : src;
    cp_async16(dst + r * LDK + c, g, in);
  }
}

// z[BP, BQ] += P[BP, BK] . Q[BQ, BK]^T over one staged chunk, then stored
// to shared memory as f32. bf16: the 8 warps as 2 x 4, each with FR x FC
// wmma fragments.
template <typename T, int BP, int BQ>
struct ZTile;

template <int BP, int BQ>
struct ZTile<bf16, BP, BQ> {
  static constexpr int LDK = Op<bf16>::BK + Op<bf16>::PAD;
  static constexpr int FR = BP / 32, FC = BQ / 64;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> f[FR][FC];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < FR; ++i)
#pragma unroll
      for (int j = 0; j < FC; ++j) wmma::fill_fragment(f[i][j], 0.f);
  }

  __device__ void mma(const bf16* P, const bf16* Q) {
    const int warp = threadIdx.x / 32, wr = warp / 4, wc = warp % 4;
#pragma unroll
    for (int kk = 0; kk < Op<bf16>::BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[FR];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[FC];
#pragma unroll
      for (int i = 0; i < FR; ++i)
        wmma::load_matrix_sync(a[i], P + (wr * FR + i) * 16 * LDK + kk, LDK);
#pragma unroll
      for (int j = 0; j < FC; ++j)
        wmma::load_matrix_sync(b[j], Q + (wc * FC + j) * 16 * LDK + kk, LDK);
#pragma unroll
      for (int i = 0; i < FR; ++i)
#pragma unroll
        for (int j = 0; j < FC; ++j) wmma::mma_sync(f[i][j], a[i], b[j], f[i][j]);
    }
  }

  __device__ void store(float* z, int ldz) {
    const int warp = threadIdx.x / 32, wr = warp / 4, wc = warp % 4;
#pragma unroll
    for (int i = 0; i < FR; ++i)
#pragma unroll
      for (int j = 0; j < FC; ++j)
        wmma::store_matrix_sync(z + (wr * FR + i) * 16 * ldz + (wc * FC + j) * 16,
                                f[i][j], ldz, wmma::mem_row_major);
  }
};

template <int BP, int BQ>
struct ZTile<float, BP, BQ> {
  static constexpr int LDK = Op<float>::BK + Op<float>::PAD;
  static constexpr int N = BP * BQ / kThreads;
  float a[N];

  __device__ void zero() {
#pragma unroll
    for (int n = 0; n < N; ++n) a[n] = 0.f;
  }

  __device__ void mma(const float* P, const float* Q) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int e = threadIdx.x + n * kThreads, r = e / BQ, c = e % BQ;
      float s = a[n];
#pragma unroll 8
      for (int k = 0; k < Op<float>::BK; ++k)
        s = fmaf(P[r * LDK + k], Q[c * LDK + k], s);
      a[n] = s;
    }
  }

  __device__ void store(float* z, int ldz) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int e = threadIdx.x + n * kThreads;
      z[(e / BQ) * ldz + e % BQ] = a[n];
    }
  }
};

// z = P[p0 : p0 + BP] . Q[q0 : q0 + BQ]^T over all of D, into shared
// memory z [BP][ldz]; stages Ps [2][BP][LDK] and Qs [2][BQ][LDK].
template <typename T, int BP, int BQ>
__device__ void logit_tile(const T* P, int p0, int n_p, const T* Q, int q0,
                           int n_q, int D, T* Ps, T* Qs, float* z, int ldz) {
  constexpr int BK = Op<T>::BK, LDK = BK + Op<T>::PAD;
  const int nk = (D + BK - 1) / BK;
  ZTile<T, BP, BQ> acc;
  acc.zero();
  load_chunk<T, BP>(Ps, P, p0, n_p, D, 0);
  load_chunk<T, BQ>(Qs, Q, q0, n_q, D, 0);
  cp_async_commit();
  for (int kc = 0; kc < nk; ++kc) {
    const int st = kc & 1;
    if (kc + 1 < nk) {
      load_chunk<T, BP>(Ps + (st ^ 1) * BP * LDK, P, p0, n_p, D, (kc + 1) * BK);
      load_chunk<T, BQ>(Qs + (st ^ 1) * BQ * LDK, Q, q0, n_q, D, (kc + 1) * BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    acc.mma(Ps + st * BP * LDK, Qs + st * BQ * LDK);
    __syncthreads();  // the stage is free for the chunk after next
  }
  acc.store(z, ldz);
}

// ---------------------------------------------------------------------------
// K3a.
// ---------------------------------------------------------------------------

constexpr int kFwdBP = 64, kFwdBQ = 128;

template <typename T>
constexpr size_t fwd_smem_bytes() {
  constexpr int LDK = Op<T>::BK + Op<T>::PAD;
  return sizeof(T) * 2 * (kFwdBP + kFwdBQ) * LDK +
         sizeof(float) * kFwdBP * (kFwdBQ + 4);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) xent_fwd_kernel(Params p) {
  constexpr int BP = kFwdBP, BQ = kFwdBQ, LDK = Op<T>::BK + Op<T>::PAD;
  constexpr int LDZ = BQ + 4, RPW = BP / 8;   // rows per warp
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ps = reinterpret_cast<T*>(smem);          // [2][BP][LDK]
  T* Qs = Ps + 2 * BP * LDK;                   // [2][BQ][LDK]
  float* zs = reinterpret_cast<float*>(Qs + 2 * BQ * LDK);   // [BP][LDZ]

  const T* x = static_cast<const T*>(p.x);
  const T* w = static_cast<const T*>(p.w);
  const int m0 = blockIdx.x * BP;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  float m[RPW], l[RPW], t[RPW];
  int tg[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int row = m0 + warp * RPW + i;
    m[i] = kNegInf;
    l[i] = 0.f;
    t[i] = 0.f;   // this lane's share of the target logit
    tg[i] = row < p.M ? p.tgt[row] : -1;
  }

  for (int v0 = 0; v0 < p.V; v0 += BQ) {
    logit_tile<T, BP, BQ>(x, m0, p.M, w, v0, p.V, p.D, Ps, Qs, zs, LDZ);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp * RPW + i;
      float zv[BQ / 32];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < BQ / 32; ++j) {
        const int v = v0 + lane + 32 * j;
        float dcap;
        const float zc = capped(zs[r * LDZ + lane + 32 * j], p.cap, &dcap);
        zv[j] = v < p.V ? zc : kNegInf;
        mx = fmaxf(mx, zv[j]);
        if (v < p.V && v == tg[i]) t[i] += zc;
      }
      mx = warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BQ / 32; ++j)
        sum += v0 + lane + 32 * j < p.V ? expf(zv[j] - m_new) : 0.f;
      sum = warp_sum(sum);
      l[i] = l[i] * expf(m[i] - m_new) + sum;
      m[i] = m_new;
    }
    // zs is rewritten only after the next tile's first barrier.
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const float tt = warp_sum(t[i]);
    const int row = m0 + warp * RPW + i;
    if (lane == 0 && row < p.M) {
      p.lse_out[row] = m[i] + logf(l[i]);
      p.tz_out[row] = tt;
    }
  }
}

// ---------------------------------------------------------------------------
// K3b / K3c.
// ---------------------------------------------------------------------------

constexpr int kBwdBP = 32, kBwdBQ = 128;

template <typename T>
__host__ __device__ constexpr int acc_ld(int D) {
  return (D + Op<T>::BK - 1) / Op<T>::BK * Op<T>::BK + 4;
}

template <typename T>
size_t bwd_smem_bytes(int D) {
  constexpr int LDK = Op<T>::BK + Op<T>::PAD;
  return sizeof(float) * kBwdBP * acc_ld<T>(D)            // acc
         + sizeof(T) * 2 * (kBwdBP + kBwdBQ) * LDK        // P, Q stages
         + sizeof(float) * kBwdBP * (kBwdBQ + 4)          // z
         + sizeof(T) * kBwdBP * (kBwdBQ + Op<T>::PAD)     // dz
         + sizeof(float) * 3 * kBwdBQ;                    // per-token values
}

// acc[:, d0 : d0 + BK] += dz[BP, BQ] . Q[BQ, BK] (Q staged [BQ][LDK]).
template <typename T>
struct AccChunk;

template <>
struct AccChunk<bf16> {
  __device__ static void mma(float* acc, int lda, int d0, const bf16* dz,
                             int ldd, const bf16* Q) {
    static_assert(kBwdBP == 32 && Op<bf16>::BK == 64,
                  "one 16 x 16 output fragment per warp");
    constexpr int LDK = Op<bf16>::BK + Op<bf16>::PAD;
    const int warp = threadIdx.x / 32, wr = warp / 4, wc = warp % 4;
    float* c = acc + wr * 16 * lda + d0 + wc * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> f;
    wmma::load_matrix_sync(f, c, lda, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < kBwdBQ; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, dz + wr * 16 * ldd + kk, ldd);
      wmma::load_matrix_sync(b, Q + kk * LDK + wc * 16, LDK);
      wmma::mma_sync(f, a, b, f);
    }
    wmma::store_matrix_sync(c, f, lda, wmma::mem_row_major);
  }
};

template <>
struct AccChunk<float> {
  __device__ static void mma(float* acc, int lda, int d0, const float* dz,
                             int ldd, const float* Q) {
    constexpr int BK = Op<float>::BK, LDK = BK + Op<float>::PAD;
#pragma unroll
    for (int n = 0; n < kBwdBP * BK / kThreads; ++n) {
      const int e = threadIdx.x + n * kThreads, r = e / BK, c = e % BK;
      float s = 0.f;
#pragma unroll 8
      for (int q = 0; q < kBwdBQ; ++q) s = fmaf(dz[r * ldd + q], Q[q * LDK + c], s);
      acc[r * lda + d0 + c] += s;
    }
  }
};

template <typename T, bool kDx>
__global__ void __launch_bounds__(kThreads, 1) xent_bwd_kernel(Params p) {
  constexpr int BP = kBwdBP, BQ = kBwdBQ, BK = Op<T>::BK;
  constexpr int LDK = BK + Op<T>::PAD, LDZ = BQ + 4, LDD = BQ + Op<T>::PAD;
  const int lda = acc_ld<T>(p.D), nk = (p.D + BK - 1) / BK;
  extern __shared__ __align__(128) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);            // [BP][lda]
  T* Ps = reinterpret_cast<T*>(acc + BP * lda);           // [2][BP][LDK]
  T* Qs = Ps + 2 * BP * LDK;                              // [2][BQ][LDK]
  float* zs = reinterpret_cast<float*>(Qs + 2 * BQ * LDK);  // [BP][LDZ]
  T* dzs = reinterpret_cast<T*>(zs + BP * LDZ);           // [BP][LDD]
  float* tok_lse = reinterpret_cast<float*>(dzs + BP * LDD);  // [BQ]
  float* tok_coef = tok_lse + BQ;                         // [BQ]
  int* tok_tgt = reinterpret_cast<int*>(tok_coef + BQ);   // [BQ]

  // K3b: own rows are tokens (x), streamed rows vocab (w); K3c the reverse.
  const T* x = static_cast<const T*>(p.x);
  const T* w = static_cast<const T*>(p.w);
  const T* P = kDx ? x : w;
  const T* Q = kDx ? w : x;
  const int n_p = kDx ? p.M : p.V, n_q = kDx ? p.V : p.M;
  const int p0 = blockIdx.x * BP;

  for (int e = threadIdx.x; e < BP * lda; e += kThreads) acc[e] = 0.f;
  // The token values of a tile: the own tokens once (K3b), the streamed
  // tokens per tile (K3c). A token past M gets coef 0 and no target.
  auto load_tokens = [&](int tok0, int n) {
    for (int r = threadIdx.x; r < n; r += kThreads) {
      const int tok = tok0 + r;
      const bool in = tok < p.M;
      tok_lse[r] = in ? p.lse[tok] : 0.f;
      tok_coef[r] = in ? p.coef[tok] : 0.f;
      tok_tgt[r] = in ? p.tgt[tok] : -1;
    }
  };
  if (kDx) load_tokens(p0, BP);

  for (int q0 = 0; q0 < n_q; q0 += BQ) {
    if (!kDx) load_tokens(q0, BQ);   // readers of the last tile are done
    logit_tile<T, BP, BQ>(P, p0, n_p, Q, q0, n_q, p.D, Ps, Qs, zs, LDZ);
    __syncthreads();
    for (int e = threadIdx.x; e < BP * BQ; e += kThreads) {
      const int r = e / BQ, c = e % BQ;
      const int tl = kDx ? r : c;                       // token, in the tile
      const int tok = (kDx ? p0 : q0) + tl;
      const int voc = kDx ? q0 + c : p0 + r;
      float dz = 0.f;
      if (tok < p.M && voc < p.V) {
        float dcap;
        const float zc = capped(zs[r * LDZ + c], p.cap, &dcap);
        const float pr = expf(zc - tok_lse[tl]);
        dz = tok_coef[tl] * (pr - (voc == tok_tgt[tl] ? 1.f : 0.f)) * dcap;
      }
      dzs[r * LDD + c] = from_f32<T>(dz);
    }
    // acc += dz . Q, Q's D in chunks (the dz writes are published by the
    // first barrier below).
    load_chunk<T, BQ>(Qs, Q, q0, n_q, p.D, 0);
    cp_async_commit();
    for (int dc = 0; dc < nk; ++dc) {
      const int st = dc & 1;
      if (dc + 1 < nk) {
        load_chunk<T, BQ>(Qs + (st ^ 1) * BQ * LDK, Q, q0, n_q, p.D, (dc + 1) * BK);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      AccChunk<T>::mma(acc, lda, dc * BK, dzs, LDD, Qs + st * BQ * LDK);
      __syncthreads();
    }
  }

  for (int e = threadIdx.x; e < BP * p.D; e += kThreads) {
    const int r = e / p.D, d = e % p.D;
    if (p0 + r >= n_p) continue;
    const float v = acc[r * lda + d];
    const long long i = (long long)(p0 + r) * p.D + d;
    if (p.out_bf16)
      static_cast<bf16*>(p.out)[i] = __float2bfloat16(v);
    else
      static_cast<float*>(p.out)[i] = v;
  }
}

// ---------------------------------------------------------------------------
// Launchers.
// ---------------------------------------------------------------------------

template <typename T>
int max_dim() {
  int d = 8;
  while (bwd_smem_bytes<T>(d + 8) <= kMaxSmem) d += 8;
  return d;
}

// K3a's shared memory does not grow with D: it takes any multiple of 8.
// The backward's accumulator bounds D (max_dim).
bool valid(int dtype, int M, int V, int D, bool bwd) {
  if (dtype < 0 || dtype > 1 || M < 1 || V < 1 || D < 8 || D % 8 != 0)
    return false;
  return !bwd || D <= (dtype == 0 ? max_dim<float>() : max_dim<bf16>());
}

template <typename T>
cudaError_t launch_fwd(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      xent_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int grid = (p.M + kFwdBP - 1) / kFwdBP;
  xent_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool kDx>
cudaError_t launch_bwd(const Params& p, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<T>(p.D);
  cudaError_t err = cudaFuncSetAttribute(
      xent_bwd_kernel<T, kDx>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const int rows = kDx ? p.M : p.V;
  const int grid = (rows + kBwdBP - 1) / kBwdBP;
  xent_bwd_kernel<T, kDx><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

Params make_params(const void* x, const void* w, const void* tgt, int M,
                   int V, int D, float cap) {
  Params p = {};
  p.x = x;
  p.w = w;
  p.tgt = static_cast<const int*>(tgt);
  p.M = M;
  p.V = V;
  p.D = D;
  p.cap = cap;
  return p;
}

template <bool kDx>
int launch_bwd_any(const void* x, const void* w, const void* tgt,
                   const void* lse, const void* coef, void* out, int dtype,
                   int out_bf16, int M, int V, int D, float cap, void* stream) {
  cudaGetLastError();  // clear an earlier, unrelated error
  if (!valid(dtype, M, V, D, true)) return int(cudaErrorInvalidValue);
  Params p = make_params(x, w, tgt, M, V, D, cap);
  p.lse = static_cast<const float*>(lse);
  p.coef = static_cast<const float*>(coef);
  p.out = out;
  p.out_bf16 = out_bf16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(dtype == 0 ? launch_bwd<float, kDx>(p, s)
                        : launch_bwd<bf16, kDx>(p, s));
}

}  // namespace

// Each returns a cudaError_t (0 = launched). dtype (of x and w): 0 = float32,
// 1 = bf16; out_bf16: dx / dW written as bf16 (1) or float32 (0).
extern "C" int automl_xent_fwd(const void* x, const void* w, const void* tgt,
                               void* lse, void* tz, int dtype, int M, int V,
                               int D, float cap, void* stream) {
  cudaGetLastError();
  if (!valid(dtype, M, V, D, false)) return int(cudaErrorInvalidValue);
  Params p = make_params(x, w, tgt, M, V, D, cap);
  p.lse_out = static_cast<float*>(lse);
  p.tz_out = static_cast<float*>(tz);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(dtype == 0 ? launch_fwd<float>(p, s) : launch_fwd<bf16>(p, s));
}

extern "C" int automl_xent_dx(const void* x, const void* w, const void* tgt,
                              const void* lse, const void* coef, void* dx,
                              int dtype, int out_bf16, int M, int V, int D,
                              float cap, void* stream) {
  return launch_bwd_any<true>(x, w, tgt, lse, coef, dx, dtype, out_bf16, M, V,
                              D, cap, stream);
}

extern "C" int automl_xent_dw(const void* x, const void* w, const void* tgt,
                              const void* lse, const void* coef, void* dw,
                              int dtype, int out_bf16, int M, int V, int D,
                              float cap, void* stream) {
  return launch_bwd_any<false>(x, w, tgt, lse, coef, dw, dtype, out_bf16, M,
                               V, D, cap, stream);
}

// The largest D the backward kernels take at this operand dtype.
extern "C" int automl_xent_max_dim(int dtype) {
  return dtype == 0 ? max_dim<float>() : max_dim<bf16>();
}
