// f32 tiles on TF32 wgmma (3xTF32), shared by the f32 designs of the
// flash-attention forward (flash_attention_fwd.cu, kernels 1-2) and backward
// (flash_attention_bwd_tf32.cu, kernels 3-4): the split of an f32 value into
// two TF32 parts, TMA loads of raw f32 rows in 32-column panels, a
// warpgroup's A fragments read from such a tile and split, and the two forms
// the transform warps write for the B operands ("rows": split in place, the
// small part beside; "T": transposed, both parts). Conventions as in
// hopper.cuh.
//
// Layout: ROWS rows of an f32 tensor (head dim HD, 32 or 64) are HD / 32
// panels of ROWS rows x 32 floats, one 128-byte swizzle span a row (16-byte
// chunk c of row r at c ^ (r % 8)), as TMA writes a box of 32 columns with
// the 128-byte swizzle. A "T" form of ROWS rows is ROWS / 32 panels of HD
// rows x 32 positions in the same swizzle, K-major over the positions: the B
// operand of a product that contracts over the rows, which TF32 wgmma cannot
// read transposed.

#pragma once

#include <stdint.h>

#include "hopper.cuh"

namespace tf32tile {

// x = big + small + O(2^-21 |x|), both TF32 with their low 13 bits zero, so
// the tensor cores read them exactly. The big part by truncation (the low 13
// bits masked: one logic op, and a NaN stays a NaN; cvt.rna there cost ~10%,
// scripts/ablate_flash_fwd.py's rna_big), the small part, x - big (exact),
// rounded by cvt.rna.
__device__ __forceinline__ void tf32_split(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = hopper::tf32_rna(x - __uint_as_float(big));
}

// Bytes of one panel of ROWS raw rows (32 floats a row).
template <int ROWS>
constexpr int kRowsPanelBytes = ROWS * 128;

// TMA loads of rows [row, row + ROWS) of one (batch, head) slice of an f32
// tensor into HD / 32 panels at dst (one box of 32 columns x ROWS rows per
// panel: the map's box; rows past N and columns past D arrive as zeros).
template <int HD, int ROWS = 64>
__device__ __forceinline__ void tf32_load_tile(unsigned char* dst, const CUtensorMap* map,
                                               int pos, uint64_t* bar, int h, int row, int b) {
  int c1, c2, c3;
  hopper::bnhd_coords(pos, h, row, b, c1, c2, c3);
#pragma unroll
  for (int p = 0; p < HD / 32; ++p)
    hopper::tma_load_4d(dst + p * kRowsPanelBytes<ROWS>, map, bar, 32 * p, c1, c2, c3);
}

// The byte offset, in a raw 64-row tile, of this thread's A-fragment element
// r of k8 step ks of a warpgroup's product over the head dim: row 16 warp +
// g (+ 8), column 8 ks + t4 (+ 4).
__device__ __forceinline__ int tf32_frag_offset(int ks, int r, int warp, int g, int t4) {
  const int row = 16 * warp + g + 8 * (r & 1);
  const int col = 8 * ks + t4 + 4 * (r >> 1), c = col % 32;
  return col / 32 * kRowsPanelBytes<64> + row * 128 + (((c >> 2) ^ (row % 8)) << 4) + (c & 3) * 4;
}

// This thread's A fragments of a warpgroup's raw 64-row tile, split into
// their two TF32 parts. The big part stays in registers; the small part goes
// to `small_tile` at the element's own offset (the fragments cover the
// warpgroup's tile once, so small_tile may be the tile itself), to be read
// by SS wgmma: in registers too (RS), ptxas serialised the forward's products
// and the registers were needed for the step's P V.
template <int HD>
__device__ __forceinline__ void tf32_load_q(uint32_t (&big)[HD / 8][4], const unsigned char* tile,
                                            unsigned char* small_tile, int warp, int g, int t4) {
#pragma unroll
  for (int ks = 0; ks < HD / 8; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int off = tf32_frag_offset(ks, r, warp, g, t4);
      uint32_t small;
      tf32_split(*reinterpret_cast<const float*>(tile + off), big[ks][r], small);
      *reinterpret_cast<uint32_t*>(small_tile + off) = small;
    }
}

// The same with both parts in registers, the tile left as it is.
template <int HD>
__device__ __forceinline__ void tf32_load_frags(uint32_t (&big)[HD / 8][4],
                                                uint32_t (&small)[HD / 8][4],
                                                const unsigned char* tile, int warp, int g,
                                                int t4) {
#pragma unroll
  for (int ks = 0; ks < HD / 8; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      tf32_split(*reinterpret_cast<const float*>(tile + tf32_frag_offset(ks, r, warp, g, t4)),
                 big[ks][r], small[ks][r]);
}

// The "rows" split of BYTES of raw rows at p by THREADS threads (thread
// `tid`): each element rounded in place to its big part, its small part at
// the same offset of `small` (the swizzle moves whole 16-byte chunks, so the
// layout carries over). One chunk at a time: with several loads in flight
// ptxas spilled the 40 registers the producer's warpgroup keeps.
template <int BYTES, int THREADS>
__device__ __forceinline__ void tf32_split_rows(unsigned char* p, unsigned char* small, int tid) {
  uint4* b4 = reinterpret_cast<uint4*>(p);
  uint4* s4 = reinterpret_cast<uint4*>(small);
#pragma unroll 1
  for (int i = tid; i < BYTES / 16; i += THREADS) {
    const uint4 x = b4[i];
    uint4 big, sm;
    tf32_split(__uint_as_float(x.x), big.x, sm.x);
    tf32_split(__uint_as_float(x.y), big.y, sm.y);
    tf32_split(__uint_as_float(x.z), big.z, sm.z);
    tf32_split(__uint_as_float(x.w), big.w, sm.w);
    b4[i] = big;
    s4[i] = sm;
  }
}

// The "T" form of ROWS raw rows (ROWS / 32 panels of HD rows x 32
// positions; big part at tb, small at ts) by WARPS warps (this one `tw`):
// position 8 kk + p of head-dim row d holds raw row 8 kk + 2 p (p < 4) or
// 8 kk + 2 (p - 4) + 1 of its 32, so that a score accumulator's elements
// (columns 2 t4 and 2 t4 + 1 of each 8) are the A fragments of the product
// over its columns (positions t4 and t4 + 4) without a shuffle. Lane = d %
// 32 (conflict-free reads); an item is one 16-byte chunk of a row of both
// parts.
template <int HD, int ROWS, int WARPS>
__device__ __forceinline__ void tf32_transpose(const unsigned char* raw, unsigned char* tb,
                                               unsigned char* ts, int tw, int lane) {
#pragma unroll 1
  for (int it = tw; it < HD / 32 * ROWS / 4; it += WARPS) {
    const int dp = it / (ROWS / 4), pp = it % (ROWS / 4) / 8, cc = it % 8, d = 32 * dp + lane;
    float x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 8 * (4 * pp + cc / 2) + 2 * j + (cc & 1);
      x[j] = *reinterpret_cast<const float*>(raw + dp * kRowsPanelBytes<ROWS> + r * 128
                                             + (((lane >> 2) ^ (r % 8)) << 4) + (lane & 3) * 4);
    }
    uint4 big, small;
    tf32_split(x[0], big.x, small.x);
    tf32_split(x[1], big.y, small.y);
    tf32_split(x[2], big.z, small.z);
    tf32_split(x[3], big.w, small.w);
    const int off = pp * HD * 128 + d * 128 + ((cc ^ (d % 8)) << 4);
    *reinterpret_cast<uint4*>(tb + off) = big;
    *reinterpret_cast<uint4*>(ts + off) = small;
  }
}

// Both forms of one 32-row raw step at p (HD / 32 panels of 32 rows x 128 B)
// in one pass by THREADS threads (this one `tid`): "rows" big in place and
// small at p + HD * 128, "T" big at tb and small at ts (one panel of HD rows
// x 32 positions, tf32_transpose's order). A unit is one 16-byte chunk c (4
// head-dim columns) of the 4 even, or the 4 odd, rows of an 8-row group:
// read once (four 16-byte loads), split, written back as rows, and turned in
// registers into the 4 chunks it fills of the T rows 32 dp + 4 c + i (the
// group's even rows are positions 0-3 of its 8, the odd ones 4-7). The 8
// threads of a 16-byte store phase take c = 0..7 of one group: rows-form
// accesses hit 8 different chunks of one row; each thread writes its T rows
// in an order rotated by c / 2, so that those stores hit 8 different chunks
// too. No thread reads what another writes, so no barrier is needed.
template <int HD, int THREADS>
__device__ __forceinline__ void tf32_step_forms(unsigned char* p, unsigned char* tb,
                                                unsigned char* ts, int tid) {
#pragma unroll 1
  for (int u = tid; u < HD / 32 * 64; u += THREADS) {
    const int c = u % 8, h = u / 8 % 2, kk = u / 16 % 4, dp = u / 64;
    unsigned char* panel = p + dp * kRowsPanelBytes<32>;
    float4 x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      x[j] = *reinterpret_cast<const float4*>(panel + (8 * kk + 2 * j + h) * 128
                                              + ((c ^ (2 * j + h)) << 4));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint4 big, small;
      tf32_split(x[j].x, big.x, small.x);
      tf32_split(x[j].y, big.y, small.y);
      tf32_split(x[j].z, big.z, small.z);
      tf32_split(x[j].w, big.w, small.w);
      const int off = (8 * kk + 2 * j + h) * 128 + ((c ^ (2 * j + h)) << 4);
      *reinterpret_cast<uint4*>(panel + off) = big;
      *reinterpret_cast<uint4*>(panel + HD * 128 + off) = small;
    }
    // Rotate each row's 4 columns left by c / 2 (selects, not a runtime
    // index): element s of x[j] is then column (s + c / 2) & 3.
    const int rot = c >> 1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 v = x[j];
      const float4 r1 = (rot & 1) ? make_float4(v.y, v.z, v.w, v.x) : v;
      x[j] = (rot & 2) ? make_float4(r1.z, r1.w, r1.x, r1.y) : r1;
    }
    auto at = [](const float4& v, int s) { return s == 0 ? v.x : s == 1 ? v.y : s == 2 ? v.z : v.w; };
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int d = 32 * dp + 4 * c + ((s + rot) & 3);
      uint4 big, small;
      tf32_split(at(x[0], s), big.x, small.x);
      tf32_split(at(x[1], s), big.y, small.y);
      tf32_split(at(x[2], s), big.z, small.z);
      tf32_split(at(x[3], s), big.w, small.w);
      const int off = d * 128 + (((2 * kk + h) ^ (d % 8)) << 4);
      *reinterpret_cast<uint4*>(tb + off) = big;
      *reinterpret_cast<uint4*>(ts + off) = small;
    }
  }
}

// A K-major operand in the 128-byte swizzle (8-row groups 1024 bytes apart).
__device__ __forceinline__ uint64_t tf32_desc(const void* p) {
  return hopper::smem_desc(p, 16, 1024, hopper::kLayoutSw128);
}

// acc (64 x HD) (+)= A (64 x 8, registers) B (8 x HD, K-major in shared
// memory) on TF32 operands: the m64nHDk8 product.
template <int HD>
__device__ __forceinline__ void tf32_mma_hd(float (&acc)[HD / 2], const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
  if constexpr (HD == 64)
    hopper::wgmma_m64n64k8_tf32_rs(acc, a, b, accumulate);
  else
    hopper::wgmma_m64n32k8_tf32_rs(acc, a, b, accumulate);
}

// The TF32 parts of a 64 x 8 KK accumulator as the A fragments of a product
// over its columns: k8 step kk takes columns 8 kk + 2 t4 and + 1 at
// positions t4 and t4 + 4 (the T form's order), so fragment register r
// takes element 0, 2, 1, 3.
template <int KK>
__device__ __forceinline__ void tf32_acc_frags(uint32_t (&big)[KK][4], uint32_t (&small)[KK][4],
                                               const float (&x)[4 * KK]) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      tf32_split(x[4 * kk + ((r & 1) << 1 | r >> 1)], big[kk][r], small[kk][r]);
}

// A ring of SLOTS slots of BYTES at `base` between one producer thread (TMA),
// the transform warps (TRANSFORM arrivals: they turn each slot into its
// forms; with none, the consumers read a slot as it arrives) and the
// consumer warps (CONSUMERS arrivals: every consumer reads every slot, so a
// slot never changes owners). Fill idx goes to slot idx % SLOTS.
template <int SLOTS, int BYTES, int TRANSFORM, int CONSUMERS>
struct Ring {
  unsigned char* base;
  uint64_t* full;
  uint64_t* ready;
  uint64_t* empty;
  __device__ __forceinline__ unsigned char* slot(int idx) const { return base + idx % SLOTS * BYTES; }
  __device__ __forceinline__ uint32_t parity(int idx) const { return (idx / SLOTS) & 1; }
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < SLOTS; ++s) {
      hopper::mbar_init(&full[s], 1);
      if (TRANSFORM > 0) hopper::mbar_init(&ready[s], TRANSFORM);
      hopper::mbar_init(&empty[s], CONSUMERS);
    }
  }
  // The producer: waits until fill idx's slot is free, expects `bytes`.
  __device__ __forceinline__ unsigned char* acquire(int idx, uint32_t bytes) const {
    hopper::mbar_wait(&empty[idx % SLOTS], parity(idx) ^ 1);
    hopper::mbar_arrive_expect_tx(&full[idx % SLOTS], bytes);
    return slot(idx);
  }
  __device__ __forceinline__ uint64_t* bar(int idx) const { return &full[idx % SLOTS]; }
  // The transform warps: wait for the loads, then (after the split) release.
  __device__ __forceinline__ unsigned char* arrived(int idx) const {
    hopper::mbar_wait(&full[idx % SLOTS], parity(idx));
    return slot(idx);
  }
  __device__ __forceinline__ void transformed(int idx, int lane) const {
    hopper::fence_async_smem();  // the split parts: visible to the consumers' wgmma
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&ready[idx % SLOTS]);
  }
  // The consumers.
  __device__ __forceinline__ const unsigned char* wait(int idx) const {
    hopper::mbar_wait(TRANSFORM > 0 ? &ready[idx % SLOTS] : &full[idx % SLOTS], parity(idx));
    return slot(idx);
  }
  __device__ __forceinline__ void release(int idx, int lane) const {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[idx % SLOTS]);
  }
};

}  // namespace tf32tile
