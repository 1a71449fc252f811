// 64-row attention tiles on wgmma and TMA, shared by the flash-attention
// forward (flash_attention_fwd.cu, kernels 1-2) and backward
// (flash_attention_bwd.cu, kernels 3-4) and the short-sequence backward
// (short_attention.cu, kernel 7): the tile geometry in shared memory,
// TMA loads of one (batch, head) slice's rows, the two products a warpgroup
// runs on a 64-row tile (A B^T with both operands in shared memory, and
// A B with A in registers), and the bf16 store of a warpgroup's accumulator.
// Conventions as in hopper.cuh.

#pragma once

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace wgtile {

// Shared-memory geometry at head dim HD: a 64-row tile of one tensor is
// kPanels swizzled panels of 64 rows x kPanelCols head-dim values, as TMA
// writes them and wgmma's descriptors read them.
template <int HD>
struct WgTile {
  static constexpr int kPanelCols = HD == 32 ? 32 : 64;
  static constexpr int kPanels = HD / kPanelCols;
  static constexpr int kRowBytes = 2 * kPanelCols;  // the swizzle width, 64 or 128 bytes
  static constexpr int kGroupBytes = 8 * kRowBytes;  // one 8-row swizzle group
  static constexpr uint64_t kLayout = HD == 32 ? hopper::kLayoutSw64 : hopper::kLayoutSw128;
  static constexpr int kPanelBytes = 64 * kRowBytes;
  static constexpr int kTileBytes = kPanels * kPanelBytes;  // 128 HD
};

// A warpgroup's 64 x HD f32 accumulator, one array per panel.
template <int HD>
using Acc = float[WgTile<HD>::kPanels][WgTile<HD>::kPanelCols / 2];

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (hopper::smem_u32(p) & 1023)) & 1023);
}

// TMA loads of rows [row, row + 64) of one (batch, head) slice of a tensor
// into a tile (one box per panel; rows past N arrive as zeros).
template <int HD>
__device__ __forceinline__ void wg_load_tile(unsigned char* dst, const CUtensorMap* map, int pos,
                                             uint64_t* bar, int h, int row, int b) {
  using G = WgTile<HD>;
  int c1, c2, c3;
  hopper::bnhd_coords(pos, h, row, b, c1, c2, c3);
#pragma unroll
  for (int p = 0; p < G::kPanels; ++p)
    hopper::tma_load_4d(dst + p * G::kPanelBytes, map, bar, p * G::kPanelCols, c1, c2, c3);
}

// d (64 x 64 f32) = A B^T, contracting over the head dim: A and B are
// 64-row tiles, both read K-major (SS wgmma). With kAcc, d += A B^T.
template <int HD, bool kAcc = false>
__device__ __forceinline__ void wg_abt(float (&d)[32], const unsigned char* a,
                                       const unsigned char* b) {
  using G = WgTile<HD>;
  const uint64_t da = hopper::smem_desc(a, 16, G::kGroupBytes, G::kLayout);
  const uint64_t db = hopper::smem_desc(b, 16, G::kGroupBytes, G::kLayout);
#pragma unroll
  for (int p = 0; p < G::kPanels; ++p)
#pragma unroll
    for (int ks = 0; ks < G::kPanelCols / 16; ++ks) {
      const uint32_t off = (p * G::kPanelBytes + ks * 32) >> 4;
      hopper::wgmma_m64n64k16_ss(d, da + off, db + off, kAcc || p + ks > 0);
    }
}

// This thread's A fragments (HD / 16 k16 steps) of a warpgroup's 64-row
// tile: rows 16 warp + g (+ 8), columns 16 ks + 2 t4 (+ 1, + 8, + 9), read
// through the tile's swizzle (16-byte chunk c of row r at c ^ (r % 8) for
// 128-byte rows, c ^ (r / 2 % 4) for 64-byte rows).
template <int HD>
__device__ __forceinline__ void wg_load_frags(uint32_t (&a)[HD / 16][4], const unsigned char* tile,
                                              int warp, int g, int t4) {
  using G = WgTile<HD>;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 16 * warp + g + 8 * (r & 1);
      const int col = 16 * ks + 2 * t4 + 8 * (r >> 1);
      const int p = col / G::kPanelCols, byte = 2 * (col % G::kPanelCols);
      const int swz = G::kRowBytes == 128 ? row % 8 : (row / 2) % 4;
      a[ks][r] = *reinterpret_cast<const uint32_t*>(
          tile + p * G::kPanelBytes + row * G::kRowBytes + (((byte >> 4) ^ swz) << 4)
          + (byte & 15));
    }
}

// d (64 x 64 f32) = A B^T, contracting over the head dim: A (64 x HD) in
// registers as HD / 16 k16 fragments (wg_load_frags), B a 64-row tile read
// K-major (RS wgmma). With kAcc, d += A B^T.
template <int HD, bool kAcc = false>
__device__ __forceinline__ void wg_abt_rs(float (&d)[32], const uint32_t (&a)[HD / 16][4],
                                          const unsigned char* b) {
  using G = WgTile<HD>;
  const uint64_t db = hopper::smem_desc(b, 16, G::kGroupBytes, G::kLayout);
#pragma unroll
  for (int p = 0; p < G::kPanels; ++p)
#pragma unroll
    for (int ks = 0; ks < G::kPanelCols / 16; ++ks) {
      const uint32_t off = (p * G::kPanelBytes + ks * 32) >> 4;
      hopper::wgmma_m64n64k16_rs(d, a[p * (G::kPanelCols / 16) + ks], db + off,
                                 kAcc || p + ks > 0);
    }
}

// acc (64 x HD f32, one array per panel) += A B: A (64 x 64 bf16) in
// registers as four k16 fragments, B a 64-row tile read MN-major (the
// product contracts over its rows; RS wgmma, transposed B). With KK < 4 only
// the first 16 KK rows of B (and k16 fragments of A) take part.
template <int HD, int KK = 4>
__device__ __forceinline__ void wg_ab(Acc<HD>& acc, const uint32_t (&a)[4][4],
                                      const unsigned char* b) {
  using G = WgTile<HD>;
  // Only the 8-row group stride matters for an MN-major operand that spans
  // one swizzle atom; it goes in both offset fields.
  const uint64_t db = hopper::smem_desc(b, G::kGroupBytes, G::kGroupBytes, G::kLayout);
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int p = 0; p < G::kPanels; ++p) {
      const uint64_t d = db + ((p * G::kPanelBytes + kk * 16 * G::kRowBytes) >> 4);
      if constexpr (G::kPanelCols == 64)
        hopper::wgmma_m64n64k16_rs_tb(acc[p], a[kk], d, 1);
      else
        hopper::wgmma_m64n32k16_rs_tb(acc[p], a[kk], d, 1);
    }
}

template <int HD>
__device__ __forceinline__ void zero_panels(Acc<HD>& acc) {
#pragma unroll
  for (int p = 0; p < WgTile<HD>::kPanels; ++p)
#pragma unroll
    for (int i = 0; i < WgTile<HD>::kPanelCols / 2; ++i) acc[p][i] = 0.f;
}

template <int HD>
__device__ __forceinline__ void fence_panels(Acc<HD>& acc) {
#pragma unroll
  for (int p = 0; p < WgTile<HD>::kPanels; ++p) hopper::fence_regs(acc[p]);
}

// Write a warpgroup's 64 x HD accumulator as bf16 rows [row0, row0 + 64) of
// one (batch, head) slice, row g + 8 r of warp `warp` times mul[r]: rows >=
// n_rows are skipped, rows >= n_zero written as 0, columns >= D skipped.
template <int HD>
__device__ __forceinline__ void wg_store_rows(const Acc<HD>& acc, __nv_bfloat16* base,
                                              long long row_stride, int row0, int n_rows,
                                              int n_zero, int D, const float (&mul)[2],
                                              int warp, int g, int t4) {
  using G = WgTile<HD>;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + g + 8 * r;
    if (row >= n_rows) continue;
    const float m = row < n_zero ? mul[r] : 0.f;
#pragma unroll
    for (int p = 0; p < G::kPanels; ++p)
#pragma unroll
      for (int j = 0; j < G::kPanelCols / 8; ++j) {
        const int col = p * G::kPanelCols + 8 * j + 2 * t4;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(base + row * row_stride + col) =
              __floats2bfloat162_rn(acc[p][4 * j + 2 * r] * m, acc[p][4 * j + 2 * r + 1] * m);
      }
  }
}

// The same with one factor for every row.
template <int HD>
__device__ __forceinline__ void wg_store(const Acc<HD>& acc, __nv_bfloat16* base,
                                         long long row_stride, int row0, int n_rows, int n_zero,
                                         int D, float mul, int warp, int g, int t4) {
  const float m[2] = {mul, mul};
  wg_store_rows<HD>(acc, base, row_stride, row0, n_rows, n_zero, D, m, warp, g, t4);
}

}  // namespace wgtile
