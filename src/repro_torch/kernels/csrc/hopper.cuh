// Hopper pieces shared by the tensor-core kernels (matmul_hopper.cu,
// flash_attention_hopper.cu): mbarriers, TMA tensor loads, the wgmma
// shared-memory descriptor, the wgmma instruction and its fences, and the
// driver's tensor-map encoder.  Each
// source is its own library, so each has its own copy; _build.py hashes
// the headers with every source, so an edit here rebuilds both.
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar)
               : "memory");
}

// wait for the completion of the barrier's phase of this parity; a wait
// that never ends (a load that never lands) traps, so that the launch fails
// with an error instead of holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(sbo >> 4) << 32)
         | (1ull << 62);
}

// ---- wgmma.mma_async m64nNk16, bf16 inputs, f32 accumulators ----
// d (64 x N, f32, N / 2 registers a thread) += A (64 x 16) * B (16 x N),
// scale-d = 1.  SS form: A and B in shared memory (descriptors); RS form:
// A in registers (4 bf16 pairs a thread), B in shared memory.  TA and TB
// are the transpose bits: 1 reads that operand MN-major.  The instruction
// names each accumulator register, so its operand list is spelled out:
// HOPPER_R<n> is "%0, ..., %<n-1>", HOPPER_ACC<n> binds d[0 .. n) to it.
#define HOPPER_R4 "%0, %1, %2, %3"
#define HOPPER_R8 HOPPER_R4 \
    ", %4, %5, %6, %7"
#define HOPPER_R16 HOPPER_R8 \
    ", %8, %9, %10, %11, %12, %13, %14, %15"
#define HOPPER_R32 HOPPER_R16 \
    ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27" \
    ", %28, %29, %30, %31"
#define HOPPER_R64 HOPPER_R32 \
    ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43" \
    ", %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55" \
    ", %56, %57, %58, %59, %60, %61, %62, %63"
#define HOPPER_R128 HOPPER_R64 \
    ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75" \
    ", %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87" \
    ", %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99" \
    ", %100, %101, %102, %103, %104, %105, %106, %107, %108, %109" \
    ", %110, %111, %112, %113, %114, %115, %116, %117, %118, %119" \
    ", %120, %121, %122, %123, %124, %125, %126, %127"
#define HOPPER_ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define HOPPER_ACC8(i) HOPPER_ACC4(i), HOPPER_ACC4(i + 4)
#define HOPPER_ACC16(i) HOPPER_ACC8(i), HOPPER_ACC8(i + 8)
#define HOPPER_ACC32(i) HOPPER_ACC16(i), HOPPER_ACC16(i + 16)
#define HOPPER_ACC64(i) HOPPER_ACC32(i), HOPPER_ACC32(i + 32)
#define HOPPER_ACC128(i) HOPPER_ACC64(i), HOPPER_ACC64(i + 64)

template <int N, int TA, int TB> struct WgmmaSS;
template <int N, int TB> struct WgmmaRS;

// one specialisation of each form for width N with n = N / 2 accumulators:
// the inputs that follow them are operands n, n + 1, ...
#define HOPPER_WGMMA(N, n, n1, n2, n3, n4, n5, n6)                           \
  template <int TA, int TB> struct WgmmaSS<N, TA, TB> {                      \
    static __device__ __forceinline__ void run(float* d, uint64_t da,        \
                                               uint64_t db) {                \
      asm volatile(                                                          \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %" #n2 ", 0;\n"                  \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {"       \
          HOPPER_R##n "}, %" #n ", %" #n1 ", p, 1, 1, %" #n3 ", %" #n4       \
          ";\n}\n"                                                           \
          : HOPPER_ACC##n(0)                                                 \
          : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));                     \
    }                                                                        \
  };                                                                         \
  template <int TB> struct WgmmaRS<N, TB> {                                  \
    static __device__ __forceinline__ void run(float* d, const uint32_t* a,  \
                                               uint64_t db) {                \
      asm volatile(                                                          \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %" #n5 ", 0;\n"                  \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {"       \
          HOPPER_R##n "}, {%" #n ", %" #n1 ", %" #n2 ", %" #n3 "}, %" #n4    \
          ", p, 1, 1, %" #n6 ";\n}\n"                                        \
          : HOPPER_ACC##n(0)                                                 \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),     \
            "n"(TB));                                                        \
    }                                                                        \
  };

HOPPER_WGMMA(8, 4, 5, 6, 7, 8, 9, 10)
HOPPER_WGMMA(16, 8, 9, 10, 11, 12, 13, 14)
HOPPER_WGMMA(32, 16, 17, 18, 19, 20, 21, 22)
HOPPER_WGMMA(64, 32, 33, 34, 35, 36, 37, 38)
HOPPER_WGMMA(128, 64, 65, 66, 67, 68, 69, 70)
HOPPER_WGMMA(256, 128, 129, 130, 131, 132, 133, 134)

template <int N, int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db) {
  WgmmaSS<N, TA, TB>::run(d, da, db);
}

template <int N, int TB = 0>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  WgmmaRS<N, TB>::run(d, a, db);
}

// before the first wgmma that reads registers written since the last one
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups of wgmmas are still in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void wg_commit_wait() {
  wg_commit();
  wg_wait<0>();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call: fetched through the runtime,
// so the library links no libcuda
inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}
