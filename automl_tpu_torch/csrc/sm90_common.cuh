// Building blocks of the Hopper (sm_90a) kernels of this package, shared by
// flash_attention_sm90.cu (K1 / K2 / K5), decode_attention_sm90.cu (K4)
// and xent_sm90.cu (K3b / K3c): shared-memory addresses, mbarriers, TMA and
// bulk copies, wgmma wrappers and descriptors, ldmatrix, the bf16 hi + lo
// split of an f32 operand, thread-block clusters (ranks, the cluster
// barrier, addresses in another block's shared memory, asynchronous stores
// there, the cluster launch), and the host-side lookup of
// cuTensorMapEncodeTiled. Included once per source, inside no namespace of
// its own: every name lies in an anonymous namespace.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int kRow = 128;          // bytes of one swizzled tile row (64 bf16)

// ---------------------------------------------------------------------------
// PTX helpers: shared-memory addresses, mbarriers, TMA, wgmma.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Waits until the phase of parity `parity` has completed. No wait in these
// kernels traps on a timeout: a trap anywhere in a kernel makes ptxas ignore
// setmaxnreg (the consumers are then held to the 168 registers of the
// launch and spill).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// A [64 columns of H, 1, rows, 1] box of a 4-D [B, T, N, H] tensor map at
// (h0, n, t0, b); the box's bytes complete a transaction on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int h0, int n, int t0,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(h0),
      "r"(n), "r"(t0), "r"(b)
      : "memory");
}

// A [64 columns, rows] box of a 2-D [rows, columns] tensor map at column c0
// and row r0; the box's bytes complete a transaction on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(r0)
      : "memory");
}

// A contiguous copy of `bytes` (a multiple of 16, 16-byte aligned).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// dst[i] += src[i] for `bytes` of f32 (a multiple of 16, 16-byte aligned),
// performed in L2; returns once the adds are done and visible device-wide.
__device__ __forceinline__ void bulk_reduce_add(float* dst, uint32_t src,
                                                uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], "
      "%2;\n" ::"l"(dst),
      "r"(src), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  __threadfence();
}

// wgmma shared-memory descriptors, 128-byte swizzle. A descriptor is a
// 64-bit word: bits 0-13 the start address / 16, 16-29 the leading byte
// offset / 16, 32-45 the stride byte offset / 16 (1024 here: 8 rows of 128
// bytes), 62-63 the swizzle (1: 128 bytes). Its high word is the constant
// kDescHi. The wrappers below take a tile's base (smem_u32 / 16) in a
// register and add a compile-time offset, desc_off, to the low word, so a
// loop of products keeps one register per tile, not one descriptor per k16
// step. K-major operands: rows of 64 bf16 (128 bytes) along K, a k16 step
// moves the start by 32 bytes, and the leading byte offset is unused (16).
// MN-major operands: `lbo` bytes between 64-wide MN blocks; a k16 step is 16
// rows (2048 bytes).
constexpr int kDescHi = (1024 >> 4) | (1 << 30);

__host__ __device__ constexpr int desc_off(int bytes, int lbo) {
  return (bytes >> 4) + ((lbo >> 4) << 16);
}

// The descriptor's 14-bit start address field: in a cluster launch a
// block's shared::cta addresses carry its rank in their high bits, which
// must not reach the leading byte offset above the field.
__device__ __forceinline__ uint32_t desc_base(const void* p) {
  return (smem_u32(p) >> 4) & 0x3FFF;
}

// A compile-time int that converts to int in device code.
template <int I>
struct Int {
  __host__ __device__ constexpr operator int() const { return I; }
};

// Calls f(Int<I>()) for I in [0, N): the k16 steps of a product, with each
// step's offsets known at compile time.
template <int I, int N, class F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(Int<I>());
    static_for<I + 1, N>(f);
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

// The two consumer warpgroups' barrier (the producer does not take part).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// One consumer warpgroup's barrier (wg 0 or 1).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t at, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared_f2(uint32_t at, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(at), "f"(x), "f"(y)
               : "memory");
}

// Generic-proxy writes to shared memory, visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma.mma_async m64nNk16, bf16 operands, f32 accumulators; A and B from
// shared memory (SS, with their major-ness as immediates) or A from
// registers (RS, B MN-major); a, b: desc_base of the tiles, kOffA / kOffB:
// desc_off of this k16 step. scale_d = 0 overwrites the accumulator.

template <int kTnspA, int kTnspB, int kOffA, int kOffB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint32_t a,
                                             uint32_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 la, lb, hi;\n.reg .b64 da, db;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "add.u32 la, %32, %35;\nadd.u32 lb, %33, %36;\nmov.b32 hi, %37;\n"
      "mov.b64 da, {la, hi};\nmov.b64 db, {lb, hi};\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "da, db, p, 1, 1, %38, %39;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a), "r"(b), "r"(scale_d), "n"(kOffA), "n"(kOffB), "n"(kDescHi),
        "n"(kTnspA), "n"(kTnspB));
}

template <int kTnspA, int kTnspB, int kOffA, int kOffB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint32_t a,
                                             uint32_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 la, lb, hi;\n.reg .b64 da, db;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "add.u32 la, %64, %67;\nadd.u32 lb, %65, %68;\nmov.b32 hi, %69;\n"
      "mov.b64 da, {la, hi};\nmov.b64 db, {lb, hi};\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "da, db, p, 1, 1, %70, %71;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a), "r"(b), "r"(scale_d), "n"(kOffA), "n"(kOffB), "n"(kDescHi),
        "n"(kTnspA), "n"(kTnspB));
}

template <int kOffB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint32_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 lb, hi;\n.reg .b64 db;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "add.u32 lb, %36, %38;\nmov.b32 hi, %39;\nmov.b64 db, {lb, hi};\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, db, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b), "r"(scale_d), "n"(kOffB),
        "n"(kDescHi));
}

template <int kOffB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint32_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 lb, hi;\n.reg .b64 db;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "add.u32 lb, %68, %70;\nmov.b32 hi, %71;\nmov.b64 db, {lb, hi};\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, db, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b), "r"(scale_d), "n"(kOffB),
        "n"(kDescHi));
}

template <int kOffB>
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                              uint32_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 lb, hi;\n.reg .b64 db;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "add.u32 lb, %132, %134;\nmov.b32 hi, %135;\nmov.b64 db, {lb, hi};\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, db, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b), "r"(scale_d), "n"(kOffB),
        "n"(kDescHi));
}


// D (m64 x HP, f32) += A (shared memory, K-major) B (shared memory,
// MN-major).
template <int HP, int kOffA, int kOffB>
__device__ __forceinline__ void wgmma_ss_kmn(float (&d)[HP / 2], uint32_t a,
                                             uint32_t b) {
  if constexpr (HP == 64)
    wgmma_ss_n64<0, 1, kOffA, kOffB>(d, a, b, 1);
  else
    wgmma_ss_n128<0, 1, kOffA, kOffB>(d, a, b, 1);
}

// D (m64 x HP, f32) += A (registers) B (shared memory, MN-major).
template <int HP, int kOffB>
__device__ __forceinline__ void wgmma_rs(float (&d)[HP / 2],
                                         const uint32_t (&a)[4], uint32_t b) {
  if constexpr (HP == 64)
    wgmma_rs_n64<kOffB>(d, a, b, 1);
  else
    wgmma_rs_n128<kOffB>(d, a, b, 1);
}

// bf16 pair (x0 low, x1 high) as one 32-bit register.
__device__ __forceinline__ uint32_t pack(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// x = hi + lo: hi = bf16(x), lo = bf16(x - hi), for a pair.
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t* hi,
                                           uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  *hi = pack(h);
  *lo = pack(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// An m64 x 64 f32 accumulator (32 registers) as the hi and lo A operands
// of four k16 steps: register r holds (row 8 * ((r >> 1) & 1) + lane / 4,
// column 8 * (r >> 2) + 2 * (lane % 4) + (r & 1)), the layout of A's
// 16-bit registers once consecutive pairs are packed.
__device__ __forceinline__ void split_operand(const float (&x)[32],
                                              uint32_t (&hi)[4][4],
                                              uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split_pair(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1], &hi[kk][i],
                 &lo[kk][i]);
}

// Four 8 x 8 bf16 matrices from shared memory: lane t gives the address of
// row t % 8 of matrix t / 8, and register i receives matrix i in the
// accumulator layout (row lane / 4, columns 2 * (lane % 4) + {0, 1}). Rows
// (t % 8) + 8 * ((t / 8) % 2) and columns 8 * (t / 16) of a 16 x 16 tile
// give the A operand of one k16 step of an RS wgmma (see split_operand).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr)
      : "memory");
}

// Byte offset of (row, column c) in a 128-byte-swizzled tile of 64 bf16
// columns (the layout TMA's 128-byte swizzle writes): the 16-byte chunk
// c / 8 of a row moves to chunk (c / 8) ^ (row % 8).
__device__ __forceinline__ int swizzled(int row, int c) {
  return row * kRow + (((c >> 3) ^ (row & 7)) << 4) + (c & 7) * 2;
}

// Column of accumulator register r for this lane (see split_operand).
__device__ __forceinline__ int acc_col(int r, int lane) {
  return 8 * (r >> 2) + 2 * (lane & 3) + (r & 1);
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023) & ~1023u) - a);
}

// ---------------------------------------------------------------------------
// Thread-block clusters.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return int(r);
}

// Every thread of every block of the cluster, once each (the non-aligned
// form: the threads of a warp may arrive apart). Orders the shared-memory
// writes before it (mbarrier initialisation included) before the reads
// and writes of the other blocks after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The shared::cluster address of the same offset in block `rank`'s shared
// memory as the local shared::cta address `addr`.
__device__ __forceinline__ uint32_t map_to_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// Asynchronous stores into another block's shared memory at a
// shared::cluster address `at` (from map_to_rank): their bytes complete a
// transaction on that block's mbarrier `bar` (mapped alike), so no fence
// or barrier orders them.
__device__ __forceinline__ void st_async_f2(uint32_t at, float x, float y,
                                            uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(at),
      "f"(x), "f"(y), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_async_v4(uint32_t at, uint32_t a,
                                            uint32_t b, uint32_t c,
                                            uint32_t d, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(at),
      "r"(a), "r"(b), "r"(c), "r"(d), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

// Launches kernel on `blocks` blocks of `threads`, in clusters of `cluster`
// consecutive blocks (blocks a multiple of cluster).
template <typename... KernelArgs, typename... Args>
cudaError_t launch_clusters(void (*kernel)(KernelArgs...), int blocks,
                            int threads, int cluster, size_t smem,
                            cudaStream_t stream, Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so that the library needs no
// link against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}


}  // namespace
