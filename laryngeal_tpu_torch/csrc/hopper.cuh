// Hopper (sm_90a) building blocks for the kernels that run on the Tensor
// Memory Accelerator and warpgroup MMA: mbarriers, 4-D TMA tile loads, the
// wgmma shared-memory descriptor and the bf16 and tf32 wgmma shapes the
// kernels use, TF32 rounding,
// register hand-over between warpgroups, and the host-side tensor-map
// encoding (cuTensorMapEncodeTiled through the runtime's driver entry point,
// so the library needs no -lcuda).
//
// Layout conventions (PTX ISA, "Asynchronous Warpgroup Level Matrix
// Multiply-Accumulate"): a tile in shared memory is a stack of rows of SW
// bytes (SW = 64 or 128) written by TMA with the SW-byte swizzle (the
// 16-byte chunk c of row r lands at chunk c ^ (r % 8) for SW = 128 and
// c ^ (r / 2 % 4) for SW = 64); its 8-row groups are 8 * SW bytes apart and
// every tile base is aligned to 8 * SW bytes. In a warpgroup
// (4 warps, lane = 4 * g + t), warp w holds rows 16 w + g and 16 w + g + 8 of
// the m64 tile: accumulator element 4 j + e sits at column 8 j + 2 t + (e & 1)
// of row g (e < 2) or g + 8 (e >= 2); a bf16 A fragment of k16 is four
// registers, (g, 2t), (g + 8, 2t), (g, 2t + 8), (g + 8, 2t + 8), two values
// each -- mma.m16n8k16's layout, so packed accumulators feed the next product.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---- mbarriers ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Make the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

// Arrive and expect `bytes` of TMA transactions before the phase completes.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Block until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" :: "r"(addr), "r"(parity) : "memory");
}

// ---- TMA ----

// One box of a 4-D tensor map into shared memory; completion is counted in
// bytes on `bar`. Coordinates are in elements, innermost first; elements
// outside the tensor are written as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box of shared memory into a 4-D tensor map (elements outside the
// tensor are not written), in the calling thread's bulk group.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until this thread's bulk stores have read their shared memory.
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Wait until this thread's bulk stores have completed.
__device__ __forceinline__ void tma_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Order this thread's shared-memory writes before later TMA reads of them.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Barrier `id` (1-15) over `threads` threads.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
// Arrive at barrier `id` without waiting (the others of its `threads` sync).
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// ---- register hand-over between warpgroups ----

template <int N>
__device__ __forceinline__ void regs_release() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void regs_claim() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// 2^x on the special-function unit (ex2.approx: 2 ulp; -inf and very
// negative x give 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- wgmma ----

constexpr uint64_t kLayoutSw128 = 1, kLayoutSw64 = 2;

// Descriptor of a swizzled tile at `p`: `lbo` and `sbo` in bytes (the
// leading- and stride-dimension byte offsets), `layout` kLayoutSw128 or
// kLayoutSw64. Base offset 0: tile bases are aligned to the swizzle's 8-row
// group, and a k step inside a row moves the start address only.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16)
         | ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pin registers that an in-flight wgmma writes: the compiler may not move
// their reads or writes across this point (use after wgmma_wait and before
// the first wgmma of a group).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x 64 f32) = (accumulate ? d : 0) + A (64 x 16 bf16) B (16 x 64 bf16),
// A and B from shared memory, both K-major (the 16 k values of a row are
// contiguous).
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t a, uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// The same at n = 32, 16 and 8: d[0 .. n / 2) (a longer array's tail is not
// touched).
template <int N>
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[N], uint64_t a, uint64_t b,
                                                   int accumulate) {
  static_assert(N >= 16, "m64n32 writes 16 accumulators a thread");
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, "
      "1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}
template <int N>
__device__ __forceinline__ void wgmma_m64n16k16_ss(float (&d)[N], uint64_t a, uint64_t b,
                                                   int accumulate) {
  static_assert(N >= 8, "m64n16 writes 8 accumulators a thread");
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate));
}
template <int N>
__device__ __forceinline__ void wgmma_m64n8k16_ss(float (&d)[N], uint64_t a, uint64_t b,
                                                  int accumulate) {
  static_assert(N >= 4, "m64n8 writes 4 accumulators a thread");
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64 f32) = (accumulate ? d : 0) + A (64 x 16 bf16, registers) B
// (16 x 64 bf16, shared memory, K-major: the 16 k values of an n row are
// contiguous).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 64 f32) (+)= A (64 x 16 bf16, registers) B (16 x 64 bf16, shared
// memory, MN-major: the 64 n values of a k row are contiguous).
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[32], const uint32_t (&a)[4],
                                                      uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// The same at n = 32.
__device__ __forceinline__ void wgmma_m64n32k16_rs_tb(float (&d)[16], const uint32_t (&a)[4],
                                                      uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// ---- tf32 (3xTF32 f32 products: flash_attention_fwd.cu) ----

// x rounded to TF32 (10 mantissa bits; the low 13 bits of the result are
// zero) to nearest, ties away from zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// d (64 x 64 f32) = (accumulate ? d : 0) + A (64 x 8 tf32, registers) B
// (8 x 64 tf32, shared memory). TF32 takes no transpose: B is K-major (the 8
// k values of an n row are contiguous). A fragment: a[0] (g, t), a[1]
// (g + 8, t), a[2] (g, t + 4), a[3] (g + 8, t + 4) of the warp's 16 rows.
__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(float (&d)[32], const uint32_t (&a)[4],
                                                       uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// The same with A (64 x 8 tf32, K-major) from shared memory.
__device__ __forceinline__ void wgmma_m64n64k8_tf32_ss(float (&d)[32], uint64_t a, uint64_t b,
                                                       int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// The RS product at n = 32.
__device__ __forceinline__ void wgmma_m64n32k8_tf32_rs(float (&d)[16], const uint32_t (&a)[4],
                                                       uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// ---- host: tensor maps ----

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, looked up once; null if missing.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// A 4-D tensor map of element type `dtype` (bf16 unless given; float32 for
// the f32 kernels) over a (B, N, H, D) tensor with unit D stride and
// element strides sb, sn, sh (positive, multiples of 8), read in boxes of
// `box_cols` head-dim values x `box_rows` sequence rows of one (batch, head),
// with the given swizzle. TMA dimension 0 is D; dimensions 1-3 are the batch,
// sequence and head axes in increasing stride (a size-1 axis last), and
// `pos` returns where each went: bits 0-1 hold the dimension of the head
// axis, 2-3 the sequence's, 4-5 the batch's. Returns false if the driver
// refuses the map.
inline bool encode_bnhd_map(CUtensorMap* map, const void* base, int B, int N, int H, int D,
                            long long sb, long long sn, long long sh, int box_cols, int box_rows,
                            CUtensorMapSwizzle swizzle, int* pos,
                            CUtensorMapDataType dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return false;
  const int elem_bytes = dtype == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
  struct Axis { long long size, stride; int which; };  // which: 0 head, 1 sequence, 2 batch
  Axis ax[3] = {{H, sh, 0}, {N, sn, 1}, {B, sb, 2}};
  long long span = (long long)D;
  for (const Axis& a : ax) span = a.size > 1 && a.size * a.stride > span ? a.size * a.stride : span;
  for (Axis& a : ax)
    if (a.size == 1) a.stride = (span + 7) / 8 * 8;  // never stepped: any valid stride
  for (int i = 1; i < 3; ++i)  // insertion sort by stride
    for (int j = i; j > 0 && ax[j].stride < ax[j - 1].stride; --j) {
      Axis t = ax[j]; ax[j] = ax[j - 1]; ax[j - 1] = t;
    }
  cuuint64_t dims[4] = {(cuuint64_t)D, 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {(cuuint32_t)box_cols, 1, 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  *pos = 0;
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = (cuuint64_t)ax[i].size;
    strides[i] = (cuuint64_t)ax[i].stride * elem_bytes;  // bytes
    if (ax[i].which == 1) box[i + 1] = (cuuint32_t)box_rows;
    *pos |= (i + 1) << (2 * ax[i].which);
  }
  return encode(map, dtype, 4, const_cast<void*>(base), dims,
                strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)
         == CUDA_SUCCESS;
}

// TMA coordinates 1-3 of (head, row, batch) under `pos` (coordinate 0 is
// the head-dim column).
__device__ __forceinline__ void bnhd_coords(int pos, int h, int row, int b, int& c1, int& c2,
                                            int& c3) {
  const int ph = pos & 3, pn = (pos >> 2) & 3;
  c1 = ph == 1 ? h : (pn == 1 ? row : b);
  c2 = ph == 2 ? h : (pn == 2 ? row : b);
  c3 = ph == 3 ? h : (pn == 3 ? row : b);
}

}  // namespace hopper
