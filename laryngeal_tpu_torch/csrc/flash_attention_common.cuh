// Device helpers shared by the attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu, short_attention.cu, window_attention.cu): cp.async
// tile copies, ldmatrix fragment loads, the bf16 m16n8k16 tensor-core
// product and the warp-level tile products built on it, plus the tile
// constants.
//
// Fragment conventions (PTX ISA, mma.m16n8k16 with .row.col): in a warp,
// lane = 4 * g + tig. A C/D accumulator float[4] holds rows g (elements 0,
// 1) and g + 8 (elements 2, 3) at columns 2 * tig and 2 * tig + 1. Two
// adjacent 16x8 accumulators, packed to bf16 pairs, are exactly the A
// fragment of the next product over those 16 columns, which is how P and dS
// stay in registers.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace flash {

constexpr float kMaskValue = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

constexpr int kWarps = 4;     // warps per block of the bf16 kernels
constexpr int kPad = 8;       // shared-memory row padding (elements)
constexpr int kF32Threads = 128;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 writes zeros (out-of-range rows).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// D(16x8 f32) += A(16x16 bf16, row) * B(16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [row0, row0 + ROWS) x [0, HD) of one (batch, head) slice into a
// padded shared tile; rows >= n_rows and columns >= d are zero-filled.
template <int ROWS, int HD>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* tile,
                                                const __nv_bfloat16* base,
                                                long long row_stride, int row0,
                                                int n_rows, int d) {
  constexpr int kChunksPerRow = HD / 8;
  constexpr int kChunks = ROWS * kChunksPerRow;
  for (int c = threadIdx.x; c < kChunks; c += kWarps * 32) {
    const int r = c / kChunksPerRow;
    const int col = (c % kChunksPerRow) * 8;
    const int row = row0 + r;
    const bool ok = row < n_rows && col < d;
    const __nv_bfloat16* src = ok ? base + row * row_stride + col : base;
    cp_async16(tile + r * (HD + kPad) + col, src, ok ? 16 : 0);
  }
}

// The A fragment (16 rows x 16 columns at column ks * 16) of this warp's
// 16-row slice [row0, row0 + 16) of a padded shared tile.
template <int HD>
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4], const __nv_bfloat16* tile,
                                            int row0, int ks) {
  const int lane = threadIdx.x % 32;
  const int lm_mat = lane / 8, lm_row = lane % 8;
  const int row = row0 + (lm_mat & 1) * 8 + lm_row;
  const int col = ks * 16 + (lm_mat >> 1) * 8;
  ldmatrix_x4(a, tile + row * (HD + kPad) + col);
}

// acc[nt], acc[nt + 1] (16 x 16 columns [nt * 8, nt * 8 + 16)) += A x B^T,
// B being rows [nt * 8, nt * 8 + 16) of a padded shared tile (the product
// contracts over the tile's columns [ks * 16, ks * 16 + 16)).
template <int HD>
__device__ __forceinline__ void mma_abt(float (&acc0)[4], float (&acc1)[4],
                                        const uint32_t (&a)[4], const __nv_bfloat16* tile,
                                        int nt, int ks) {
  const int lane = threadIdx.x % 32;
  const int lm_mat = lane / 8, lm_row = lane % 8;
  uint32_t b[4];
  const int row = (nt + (lm_mat >> 1)) * 8 + lm_row;
  const int col = ks * 16 + (lm_mat & 1) * 8;
  ldmatrix_x4(b, tile + row * (HD + kPad) + col);
  mma_bf16(acc0, a, b[0], b[1]);
  mma_bf16(acc1, a, b[2], b[3]);
}

// acc[dt], acc[dt + 1] (16 x 16 columns [dt * 8, dt * 8 + 16) of the head
// dim) += A x B, B being rows [kk * 16, kk * 16 + 16) of a padded shared
// tile (the product contracts over those rows): ldmatrix.trans.
template <int HD>
__device__ __forceinline__ void mma_ab(float (&acc0)[4], float (&acc1)[4],
                                       const uint32_t (&a)[4], const __nv_bfloat16* tile,
                                       int kk, int dt) {
  const int lane = threadIdx.x % 32;
  const int lm_mat = lane / 8, lm_row = lane % 8;
  uint32_t b[4];
  const int row = kk * 16 + (lm_mat & 1) * 8 + lm_row;
  const int col = (dt + (lm_mat >> 1)) * 8;
  ldmatrix_x4_trans(b, tile + row * (HD + kPad) + col);
  mma_bf16(acc0, a, b[0], b[1]);
  mma_bf16(acc1, a, b[2], b[3]);
}

// The A fragment of columns [kk * 16, kk * 16 + 16) of a 16-row f32
// accumulator array, rounded to bf16.
template <int N>
__device__ __forceinline__ void pack_a_frag(uint32_t (&a)[4], const float (&acc)[N][4], int kk) {
  a[0] = pack_bf16(acc[2 * kk][0], acc[2 * kk][1]);
  a[1] = pack_bf16(acc[2 * kk][2], acc[2 * kk][3]);
  a[2] = pack_bf16(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
  a[3] = pack_bf16(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}


// ---- warp-level tile products (the short and window attention kernels) ----
// A warp owns 16 rows; tiles are padded (HD + kPad columns) in shared memory.

// acc (16 rows x COLS) = A (rows [a_row0, a_row0 + 16) of a_tile) x B^T
// (rows [0, COLS) of b_tile), contracting over the head dim.
template <int HD, int COLS>
__device__ __forceinline__ void product_abt(float (&acc)[COLS / 8][4], const __nv_bfloat16* a_tile,
                                            int a_row0, const __nv_bfloat16* b_tile) {
  zero(acc);
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    uint32_t a[4];
    load_a_frag<HD>(a, a_tile, a_row0, ks);
#pragma unroll
    for (int nt = 0; nt < COLS / 8; nt += 2) mma_abt<HD>(acc[nt], acc[nt + 1], a, b_tile, nt, ks);
  }
}

// The same product with the A fragments already in registers.
template <int HD, int COLS>
__device__ __forceinline__ void product_abt_regs(float (&acc)[COLS / 8][4],
                                                 const uint32_t (&a)[HD / 16][4],
                                                 const __nv_bfloat16* b_tile) {
  zero(acc);
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)
#pragma unroll
    for (int nt = 0; nt < COLS / 8; nt += 2) mma_abt<HD>(acc[nt], acc[nt + 1], a[ks], b_tile, nt, ks);
}

// acc (16 x HD) += bf16(p) (16 x ROWS, from registers) x tile (ROWS x HD).
template <int HD, int ROWS>
__device__ __forceinline__ void product_pv(float (&acc)[HD / 8][4], const float (&p)[ROWS / 8][4],
                                           const __nv_bfloat16* tile) {
#pragma unroll
  for (int kk = 0; kk < ROWS / 16; ++kk) {
    uint32_t a[4];
    pack_a_frag(a, p, kk);
#pragma unroll
    for (int dt = 0; dt < HD / 8; dt += 2) mma_ab<HD>(acc[dt], acc[dt + 1], a, tile, kk, dt);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace flash
