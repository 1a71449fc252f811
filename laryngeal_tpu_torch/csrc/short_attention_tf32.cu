// Kernels 6 and 7 (short_attention.cu's entries) in float32 on Hopper's
// tensor cores: the design "wgmma.tf32x3", which short_attention.cu's
// launchers take for f32 at 64 < N <= 256, D <= 64 (after padding) with
// every batch, sequence and head stride positive (shorttf::takes).
//
// Replaces, for those calls, laryngeal_tpu/ops/short_attention.py's
// _fwd_kernel (:101) and _bwd_kernel (:118) in f32, with their arithmetic:
// S = Q K^T scaled, a whole-row softmax (every key of a row at once: the row
// max and sum are exact, no online rescale), P normalised before P V; the
// backward recomputes P, takes delta = sum_k P dP from the f32 P and dP (not
// rowsum(dO O)), dS = P (dP - delta) scale, dQ = dS K, dK = dS^T Q,
// dV = P^T dO. Nothing is rounded to bf16.
//
// The products: TF32 alone keeps 10 mantissa bits and misses the f32 limits
// (tests/test_torch_short_attention.py's emulation), so each operand x is
// split into big (x with its low 13 bits masked) and small = tf32(x - big)
// (cvt.rna), and each product is small.big + big.small + big.big, three
// wgmma.m64nNk8.tf32 (3xTF32; the dropped small.small term and the rounding
// of small leave ~2^-20 of |x||y|). Both parts have their low 13 bits zero.
//
// What bounds it on the H100, at TimeSformer-B's spatial shape (256, 197,
// 12, 64): the forward's 2 products, three TF32 products each, are 9.16e10
// FLOP, 0.185 ms at the TF32 peak (495 TFLOP/s), against 620 MB of q, k, v,
// o (0.185 ms at 3.35 TB/s); the backward's 5 are 0.462 ms against 1.08 GB
// (0.324 ms). The design streams every operand
// from L2 through shared memory 32 rows at a time and splits it there, so it
// does more than the bound's work: S and dP are recomputed (8 products where
// the function has 5) and the keys are padded to 32 (224 at N = 197).
//
// TF32 wgmma reads both operands K-major only. The A operands come from
// registers: Q, K and V are read from the raw f32 tiles TMA wrote (any order
// is free there) and split in registers; P and dS are the score
// accumulators, split in place. The B operands sit in shared memory in the
// forms the products read: "rows" (a 32-row step of q, k, v or dO, the head
// dim contiguous: S = Q K^T, dP = dO V^T, S^T = K Q^T, dP^T = V dO^T) and
// "T" (64 head-dim rows of 32 positions, the keys or queries contiguous:
// V^T for P V, K^T for dS K, dO^T for P^T dO, Q^T for dS^T Q), positions
// 2t and 2t + 1 of each 8 at t and t + 4 so that an accumulator's elements
// are the A fragments of the next product without a shuffle. The raw f32
// steps are brought in by TMA (4-D tensor maps over the (B, N, H, D)
// strides, so the fused-qkv views TimeSformer passes need no copy; 128-byte
// swizzle; rows past N and columns past D arrive as zeros) and split in the
// block, not in a pre-pass: a pre-pass would move ~1.4 / 2.3 GB at the
// spatial shape, more than twice either call's bound.
//
// Blocks: one persistent block an SM (384 threads) walks work items of two
// 64-row tiles of one (batch, head) pair, the tiles fastest, so the pair's
// items run side by side and share its K and V through L2. Warpgroup 0: warp
// 0 issues the TMA loads into a ring of slots, in the order the consumers
// read them; warps 1-3 (the transform warps) split each slot into its form
// (in place for "rows", into two fresh panels for "T") and release it to the
// consumers. Warpgroups 1-2 each take one of the item's tiles; both read
// every slot, in the same order, so a slot never changes hands (a slot that
// did let a parity wait pass a phase early in window_attention_wgmma.cu).
//   * Kernel 6 (short_fwd_tf32_kernel<NS>, NS = ceil(N / 32) steps): a
//     query tile's Q is split into registers; S = Q K^T over every key step
//     (rows slots), the whole-row softmax from the accumulators (base 2,
//     ex2.approx), P normalised in place; then O = P V a step at a time (T
//     slots of V), each step's product in an accumulator of its own added to
//     O on the FMA units (as flash_attention_fwd.cu's f32 design, where O
//     summed by the tensor cores over 3137 keys failed the full-width f32
//     gradient check).
//   * Kernel 7, launch 1 (short_bwd_dq_tf32_kernel<NS>): query tiles as rows.
//     S and the whole-row softmax as kernel 6; dO split once an item into
//     shared memory (an SS operand: with S held, its parts would not fit the
//     registers); dP = dO V^T a step at a time for delta; then dP again with
//     dS = P (dP - delta) split as the A operand of dQ += dS K (T slots of
//     K). Each row's base-2 max, 1 / l and delta go to the caller's scratch
//     (+inf, 0, 0 past N: P = 0 for those queries in launch 2).
//   * Kernel 7, launch 2 (short_bwd_dkv_tf32_kernel): key tiles as rows. A
//     slot holds a 32-query step of Q or dO in both forms; per step S^T =
//     K Q^T and dP^T = V dO^T (K and V split into registers from their raw
//     tiles), P^T and dS^T from launch 1's statistics, dV += P^T dO and
//     dK += dS^T Q in the tensor cores (summed there over 400 queries in
//     window_attention_wgmma.cu's f32 design, the f32 gradient check held).
// Registers: a consumer holds a row's NS x 16 scores (128 at N = 256) beside
// the step's operands; it claims 232 (setmaxnreg: the 8-step dQ instance
// spills 124 bytes, the others none) and the producer's warpgroup keeps 40.

#include "short_attention_tf32.cuh"

#include "flash_attention_common.cuh"
#include "hopper.cuh"

namespace shorttf {
namespace {

using flash::kLog2e;
using flash::quad_max;
using flash::quad_sum;

constexpr int kThreads = 384;  // warpgroup 0 loads and splits, warpgroups 1-2 compute
constexpr int kConsumerWarps = 8;
constexpr int kTransformThreads = 96;  // warps 1-3
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// Shared-memory forms at head dim 64 (D <= 64; columns past D are zeros).
constexpr int kTile = 16384;       // 64 rows: two panels of 64 rows x 32 f32 (128 B)
constexpr int kTilePanel = 8192;
constexpr int kStep = 8192;        // 32 rows: two panels of 32 rows x 32 f32
constexpr int kStepPanel = 4096;
constexpr int kT = 8192;           // a step's T form: 64 rows x 32 positions, one panel

// Ring slots: a step's rows form (in place, its small part after it) or its
// raw rows and T form (kernel 6's V, launch 1's K), then launch 2's step in
// both forms (raw / rows big, rows small, T big, T small).
constexpr int kFwdSlots = 8, kFwdSlot = kStep + 2 * kT;
constexpr int kDqSlots = 5, kDqSlot = kStep + 2 * kT;
constexpr int kDkvSlots = 5, kDkvSlot = 2 * kStep + 2 * kT;
constexpr size_t kFwdSmem = 2 * kTile + kFwdSlots * kFwdSlot + (2 + 3 * kFwdSlots) * 8 + 1024;
constexpr size_t kDqSmem = 6 * kTile + kDqSlots * kDqSlot + (5 + 3 * kDqSlots) * 8 + 1024;
constexpr size_t kDkvSmem = 4 * kTile + kDkvSlots * kDkvSlot + (2 + 3 * kDkvSlots) * 8 + 1024;
static_assert(kFwdSmem <= 232448 && kDqSmem <= 232448 && kDkvSmem <= 232448,
              "227 KB of shared memory a block");

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (hopper::smem_u32(p) & 1023)) & 1023);
}

// x = big + small + O(2^-21 |x|), both TF32 with their low 13 bits zero.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = hopper::tf32_rna(x - __uint_as_float(big));
}

__device__ __forceinline__ uint64_t desc(const void* p) {
  return hopper::smem_desc(p, 16, 1024, hopper::kLayoutSw128);
}

// A ring of SLOTS slots of BYTES: fill idx goes to slot idx % SLOTS. `full`
// takes the producer's transaction bytes, `ready` the three transform
// warps, `empty` the eight consumer warps (every consumer reads every slot).
template <int SLOTS, int BYTES>
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
      hopper::mbar_init(&ready[s], 3);
      hopper::mbar_init(&empty[s], kConsumerWarps);
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
    hopper::mbar_wait(&ready[idx % SLOTS], parity(idx));
    return slot(idx);
  }
  __device__ __forceinline__ void release(int idx, int lane) const {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[idx % SLOTS]);
  }
};

__device__ __forceinline__ void warp_arrive(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive(bar);
}

// TMA loads of rows [row, row + 32) of one (batch, head) slice of an f32
// tensor: two boxes of 32 columns, panel p at dst + p kStepPanel.
__device__ __forceinline__ void load_step(unsigned char* dst, const CUtensorMap* m, int pos,
                                          uint64_t* bar, int h, int row, int b) {
  int c1, c2, c3;
  hopper::bnhd_coords(pos, h, row, b, c1, c2, c3);
  hopper::tma_load_4d(dst, m, bar, 0, c1, c2, c3);
  hopper::tma_load_4d(dst + kStepPanel, m, bar, 32, c1, c2, c3);
}

// Rows [row, row + 64) as a 64-row tile (panel p at dst + p kTilePanel).
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* m, int pos,
                                          uint64_t* bar, int h, int row, int b) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int c1, c2, c3;
    hopper::bnhd_coords(pos, h, row + 32 * r, b, c1, c2, c3);
#pragma unroll
    for (int p = 0; p < 2; ++p)
      hopper::tma_load_4d(dst + p * kTilePanel + r * kStepPanel, m, bar, 32 * p, c1, c2, c3);
  }
}

// The transform warps' "rows" split of BYTES at p: each element rounded in
// place to its big part, its small part at the same offset of p + BYTES (the
// swizzle moves whole 16-byte chunks, so the layout carries over). One chunk
// at a time: with several loads in flight ptxas spilled the 40 registers
// the producer's warpgroup keeps.
template <int BYTES>
__device__ __forceinline__ void split_rows(unsigned char* p, int tid) {
  uint4* b4 = reinterpret_cast<uint4*>(p);
  uint4* s4 = reinterpret_cast<uint4*>(p + BYTES);
#pragma unroll 1
  for (int i = tid; i < BYTES / 16; i += kTransformThreads) {
    const uint4 x = b4[i];
    uint4 big, small;
    split(__uint_as_float(x.x), big.x, small.x);
    split(__uint_as_float(x.y), big.y, small.y);
    split(__uint_as_float(x.z), big.z, small.z);
    split(__uint_as_float(x.w), big.w, small.w);
    b4[i] = big;
    s4[i] = small;
  }
}

// The transform warps' "T" form of a raw 32-row step: 64 head-dim rows of
// 32 positions, position 8 kk + p of row d holding row 8 kk + 2 p (p < 4) or
// 8 kk + 2 (p - 4) + 1 of the step, big part to tb, small to ts, 128-byte
// swizzle. Lane = d % 32 (conflict-free reads); an item is one 16-byte
// chunk of a row of both parts.
__device__ __forceinline__ void transpose(const unsigned char* raw, unsigned char* tb,
                                          unsigned char* ts, int tw, int lane) {
#pragma unroll 1
  for (int it = tw; it < 16; it += 3) {
    const int dp = it / 8, cc = it % 8, d = 32 * dp + lane;
    float x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 8 * (cc / 2) + 2 * j + (cc & 1);
      x[j] = *reinterpret_cast<const float*>(raw + dp * kStepPanel + r * 128
                                             + (((lane >> 2) ^ (r % 8)) << 4) + (lane & 3) * 4);
    }
    uint4 big, small;
    split(x[0], big.x, small.x);
    split(x[1], big.y, small.y);
    split(x[2], big.z, small.z);
    split(x[3], big.w, small.w);
    const int off = d * 128 + ((cc ^ (d % 8)) << 4);
    *reinterpret_cast<uint4*>(tb + off) = big;
    *reinterpret_cast<uint4*>(ts + off) = small;
  }
}

// This thread's A fragments of a warpgroup's raw 64-row tile (rows 16 warp
// + g (+ 8), columns 8 ks + t4 (+ 4) of each k8 step ks, read through the
// swizzle), split into their two TF32 parts.
__device__ __forceinline__ void load_frags(uint32_t (&big)[8][4], uint32_t (&small)[8][4],
                                           const unsigned char* tile, int warp, int g, int t4) {
#pragma unroll
  for (int ks = 0; ks < 8; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 16 * warp + g + 8 * (r & 1);
      const int col = 8 * ks + t4 + 4 * (r >> 1), c = col % 32;
      const int off = col / 32 * kTilePanel + row * 128 + (((c >> 2) ^ (row % 8)) << 4) + (c & 3) * 4;
      split(*reinterpret_cast<const float*>(tile + off), big[ks][r], small[ks][r]);
    }
}

// d (64 x 32) = A B^T over the head dim, 3xTF32: A's parts in registers,
// B a rows-form step (big part at b, small at b + kStep).
__device__ __forceinline__ void abt_rs(float (&d)[16], const uint32_t (&ab)[8][4],
                                       const uint32_t (&as)[8][4], const unsigned char* b) {
  const uint64_t bb = desc(b), bs = desc(b + kStep);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t off = (k / 4 * kStepPanel + k % 4 * 32) >> 4;
    hopper::wgmma_m64n32k8_tf32_rs(d, as[k], bb + off, k > 0);
    hopper::wgmma_m64n32k8_tf32_rs(d, ab[k], bs + off, 1);
    hopper::wgmma_m64n32k8_tf32_rs(d, ab[k], bb + off, 1);
  }
}

// The same with A's parts in shared memory: 64-row tiles at ab and as.
__device__ __forceinline__ void abt_ss(float (&d)[16], const unsigned char* ab,
                                       const unsigned char* as, const unsigned char* b) {
  const uint64_t dab = desc(ab), das = desc(as), bb = desc(b), bs = desc(b + kStep);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t oa = (k / 4 * kTilePanel + k % 4 * 32) >> 4;
    const uint32_t ob = (k / 4 * kStepPanel + k % 4 * 32) >> 4;
    hopper::wgmma_m64n32k8_tf32_ss(d, das + oa, bb + ob, k > 0);
    hopper::wgmma_m64n32k8_tf32_ss(d, dab + oa, bs + ob, 1);
    hopper::wgmma_m64n32k8_tf32_ss(d, dab + oa, bb + ob, 1);
  }
}

// acc (64 x 64) (+)= A B over one 32-position step, 3xTF32: A's parts in
// registers (frags), B a T form (big part at b, small at b + kT). Unless
// `accumulate`, acc is overwritten.
__device__ __forceinline__ void ab_rs(float (&acc)[32], const uint32_t (&ab)[4][4],
                                      const uint32_t (&as)[4][4], const unsigned char* b,
                                      bool accumulate) {
  const uint64_t bb = desc(b), bs = desc(b + kT);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    hopper::wgmma_m64n64k8_tf32_rs(acc, as[kk], bb + 2 * kk, accumulate || kk > 0);
    hopper::wgmma_m64n64k8_tf32_rs(acc, ab[kk], bs + 2 * kk, 1);
    hopper::wgmma_m64n64k8_tf32_rs(acc, ab[kk], bb + 2 * kk, 1);
  }
}

// The TF32 parts of a 64 x 32 accumulator as the A fragments of a product
// over its columns: k8 step kk takes columns 8 kk + 2 t4 and + 1 at
// positions t4 and t4 + 4 (the T form's order): fragment register r takes
// element 0, 2, 1, 3.
__device__ __forceinline__ void frags(uint32_t (&b)[4][4], uint32_t (&s)[4][4],
                                      const float (&x)[16]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) split(x[4 * kk + ((r & 1) << 1 | r >> 1)], b[kk][r], s[kk][r]);
}

// The whole-row softmax of rows g and g + 8 of this warp's 16 over NS
// 32-key steps, in place: keys >= N masked, the exact row max, exp2, the
// row sum, P = exp2(..) / l. Returns each row's base-2 max and 1 / l.
template <int NS>
__device__ __forceinline__ void softmax_rows(float (&s)[NS][16], int N, float sl2, int t4,
                                             float (&mb)[2], float (&inv)[2]) {
  const float neg_inf = __int_as_float(0xff800000);
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (32 * (NS - 1) + 8 * (i >> 2) + 2 * t4 + (i & 1) >= N) s[NS - 1][i] = neg_inf;
  float mx[2][2] = {{neg_inf, neg_inf}, {neg_inf, neg_inf}};
#pragma unroll
  for (int c = 0; c < NS; ++c)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float& m = mx[(i >> 1) & 1][i & 1];
      m = fmaxf(m, s[c][i]);
    }
  float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int r = 0; r < 2; ++r) mb[r] = quad_max(fmaxf(mx[r][0], mx[r][1])) * sl2;
#pragma unroll
  for (int c = 0; c < NS; ++c)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = (i >> 1) & 1;
      const float x = hopper::exp2_approx(fmaf(s[c][i], sl2, -mb[r]));
      s[c][i] = x;
      sum[r][i & 1] += x;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.f / quad_sum(sum[r][0] + sum[r][1]);
#pragma unroll
  for (int c = 0; c < NS; ++c)
#pragma unroll
    for (int i = 0; i < 16; ++i) s[c][i] *= inv[(i >> 1) & 1];
}

// S = Q K^T over NS key steps (fills idx0 ..), Q's parts in registers from
// the warpgroup's raw tile, which is released (q_empty) once read.
template <int NS, int SLOTS, int BYTES>
__device__ __forceinline__ void scores(float (&s)[NS][16], const Ring<SLOTS, BYTES>& ring,
                                       int idx0, const unsigned char* q_tile, uint64_t* q_empty,
                                       int warp, int lane, int g, int t4) {
  uint32_t qb[8][4], qs[8][4];
  load_frags(qb, qs, q_tile, warp, g, t4);
  warp_arrive(q_empty, lane);
#pragma unroll
  for (int c = 0; c < NS; ++c) {
    const unsigned char* kc = ring.wait(idx0 + c);
    hopper::wgmma_fence();
    abt_rs(s[c], qb, qs, kc);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s[c]);
    ring.release(idx0 + c, lane);
  }
}

// Write a warpgroup's 64 x 64 accumulator times `mul` as f32 rows [row0,
// row0 + 64) of one (batch, head) slice; rows >= N and columns >= D skipped.
__device__ __forceinline__ void store_rows(const float (&acc)[32], float* base, long long rs,
                                           int row0, int N, int D, float mul, int warp, int g,
                                           int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 16 * warp + g + 8 * r;
    if (row >= N) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * t4;
      if (col < D)
        *reinterpret_cast<float2*>(base + row * rs + col) =
            make_float2(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
    }
  }
}

// Query- or key-tile pairs (work items) of a (batch, head) pair.
__host__ __device__ __forceinline__ int tile_pairs(int N) { return ((N + 63) / 64 + 1) / 2; }

// ---------------------------------------------------------------------------
// Kernel 6
// ---------------------------------------------------------------------------

// A work item is two 64-row query tiles of one (batch, head) pair. The ring
// carries the item's NS K steps (rows form), then its NS V steps (T form).
template <int NS>
__global__ void __launch_bounds__(kThreads, 1)
short_fwd_tf32_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, float* __restrict__ o, int BH, int H,
                      int N, int D, long long sob, long long son, long long soh, float scale,
                      int pos_q, int pos_k, int pos_v) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* q_s = smem;  // the item's two raw Q tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + 2 * kTile + kFwdSlots * kFwdSlot);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 1;
  const Ring<kFwdSlots, kFwdSlot> ring{smem + 2 * kTile, bars + 2, bars + 2 + kFwdSlots,
                                       bars + 2 + 2 * kFwdSlots};
  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init(q_empty, kConsumerWarps);
    ring.init();
    hopper::mbar_init_fence();
  }
  __syncthreads();
  const int n_tp = tile_pairs(N), n_items = BH * n_tp;
  const int lane = threadIdx.x % 32;

  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    hopper::regs_release<kProducerRegs>();
    const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
    if (warp == 0) {
      if (lane == 0) {
        int idx = 0;
        for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
          const int bh = item / n_tp, b = bh / H, h = bh % H, row0 = item % n_tp * 128;
          hopper::mbar_wait(q_empty, (it & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(q_full, 2 * kTile);
          load_tile(q_s, &tq, pos_q, q_full, h, row0, b);
          load_tile(q_s + kTile, &tq, pos_q, q_full, h, row0 + 64, b);
          for (int s = 0; s < NS; ++s, ++idx)
            load_step(ring.acquire(idx, kStep), &tk, pos_k, ring.bar(idx), h, 32 * s, b);
          for (int s = 0; s < NS; ++s, ++idx)
            load_step(ring.acquire(idx, kStep), &tv, pos_v, ring.bar(idx), h, 32 * s, b);
        }
      }
    } else {
      const int tw = warp - 1, tid = threadIdx.x - 32;
      int idx = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        for (int s = 0; s < NS; ++s, ++idx) {
          split_rows<kStep>(ring.arrived(idx), tid);
          ring.transformed(idx, lane);
        }
        for (int s = 0; s < NS; ++s, ++idx) {
          unsigned char* p = ring.arrived(idx);
          transpose(p, p + kStep, p + kStep + kT, tw, lane);
          ring.transformed(idx, lane);
        }
      }
    }
  } else {
    hopper::regs_claim<kConsumerRegs>();
    const int tid = threadIdx.x - 128;
    const int wg = tid / 128, warp = (tid / 32) % 4;
    const int g = lane / 4, t4 = lane % 4;
    const float sl2 = scale * kLog2e;
    int idx = 0;
    for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
      hopper::mbar_wait(q_full, it & 1);
      float s[NS][16];
      scores<NS>(s, ring, idx, q_s + wg * kTile, q_empty, warp, lane, g, t4);
      float mb[2], inv[2];
      softmax_rows<NS>(s, N, sl2, t4, mb, inv);
      // O = P V a step at a time, each step's product added to O in f32.
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
      for (int c = 0; c < NS; ++c) {
        uint32_t pb[4][4], ps[4][4];
        frags(pb, ps, s[c]);
        const unsigned char* vt = ring.wait(idx + NS + c);
        float pv[32];
        hopper::wgmma_fence();
        ab_rs(pv, pb, ps, vt + kStep, false);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(pv);
        ring.release(idx + NS + c, lane);
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] += pv[i];
      }
      idx += 2 * NS;
      const int bh = item / n_tp, b = bh / H, h = bh % H;
      store_rows(acc, o + b * sob + h * soh, son, item % n_tp * 128 + 64 * wg, N, D, 1.f, warp, g,
                 t4);
    }
  }
}

// ---------------------------------------------------------------------------
// Kernel 7, launch 1: row statistics and dQ
// ---------------------------------------------------------------------------

// A work item is two 64-row query tiles of one (batch, head) pair. The ring
// carries its NS K steps (rows: S), its NS V steps (rows: delta), then per
// step its V (rows: dP again) and its K (T: dQ += dS K). dO's two tiles come
// once an item, split in place by the transform warps (small parts beside).
template <int NS>
__global__ void __launch_bounds__(kThreads, 1)
short_bwd_dq_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tg, float* __restrict__ dq,
                         float* __restrict__ stats, int BH, int H, int N, int D, long long sb,
                         long long sn, long long sh, float scale, int pos_q, int pos_k,
                         int pos_v, int pos_g) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* q_s = smem;               // two raw Q tiles
  unsigned char* do_s = smem + 2 * kTile;  // two dO tiles: raw, then big; small parts after
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + 6 * kTile + kDqSlots * kDqSlot);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 1;
  uint64_t* d_full = bars + 2;
  uint64_t* d_ready = bars + 3;
  uint64_t* d_empty = bars + 4;
  const Ring<kDqSlots, kDqSlot> ring{smem + 6 * kTile, bars + 5, bars + 5 + kDqSlots,
                                     bars + 5 + 2 * kDqSlots};
  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init(q_empty, kConsumerWarps);
    hopper::mbar_init(d_full, 1);
    hopper::mbar_init(d_ready, 3);
    hopper::mbar_init(d_empty, kConsumerWarps);
    ring.init();
    hopper::mbar_init_fence();
  }
  __syncthreads();
  const int n_tp = tile_pairs(N), n_items = BH * n_tp;
  const int lane = threadIdx.x % 32;

  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    hopper::regs_release<kProducerRegs>();
    const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
    if (warp == 0) {
      if (lane == 0) {
        int idx = 0;
        for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
          const int bh = item / n_tp, b = bh / H, h = bh % H, row0 = item % n_tp * 128;
          hopper::mbar_wait(q_empty, (it & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(q_full, 2 * kTile);
          load_tile(q_s, &tq, pos_q, q_full, h, row0, b);
          load_tile(q_s + kTile, &tq, pos_q, q_full, h, row0 + 64, b);
          for (int s = 0; s < NS; ++s, ++idx)
            load_step(ring.acquire(idx, kStep), &tk, pos_k, ring.bar(idx), h, 32 * s, b);
          // dO after the K steps: the consumers release the last item's dO
          // only at its end, which needs every step above it loaded.
          hopper::mbar_wait(d_empty, (it & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(d_full, 2 * kTile);
          load_tile(do_s, &tg, pos_g, d_full, h, row0, b);
          load_tile(do_s + kTile, &tg, pos_g, d_full, h, row0 + 64, b);
          for (int s = 0; s < NS; ++s, ++idx)
            load_step(ring.acquire(idx, kStep), &tv, pos_v, ring.bar(idx), h, 32 * s, b);
          for (int s = 0; s < NS; ++s) {
            load_step(ring.acquire(idx, kStep), &tv, pos_v, ring.bar(idx), h, 32 * s, b);
            ++idx;
            load_step(ring.acquire(idx, kStep), &tk, pos_k, ring.bar(idx), h, 32 * s, b);
            ++idx;
          }
        }
      }
    } else {
      const int tw = warp - 1, tid = threadIdx.x - 32;
      int idx = 0;
      for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
        for (int s = 0; s < NS; ++s, ++idx) {
          split_rows<kStep>(ring.arrived(idx), tid);
          ring.transformed(idx, lane);
        }
        hopper::mbar_wait(d_full, it & 1);
        split_rows<2 * kTile>(do_s, tid);
        hopper::fence_async_smem();
        warp_arrive(d_ready, lane);
        for (int s = 0; s < NS; ++s, ++idx) {
          split_rows<kStep>(ring.arrived(idx), tid);
          ring.transformed(idx, lane);
        }
        for (int s = 0; s < NS; ++s) {
          split_rows<kStep>(ring.arrived(idx), tid);
          ring.transformed(idx, lane);
          ++idx;
          unsigned char* p = ring.arrived(idx);
          transpose(p, p + kStep, p + kStep + kT, tw, lane);
          ring.transformed(idx, lane);
          ++idx;
        }
      }
    }
  } else {
    hopper::regs_claim<kConsumerRegs>();
    const int tid = threadIdx.x - 128;
    const int wg = tid / 128, warp = (tid / 32) % 4;
    const int g = lane / 4, t4 = lane % 4;
    const float sl2 = scale * kLog2e;
    const unsigned char* dob = do_s + wg * kTile;  // this warpgroup's dO: big part
    const unsigned char* dos = dob + 2 * kTile;    // and small part
    int idx = 0;
    for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
      const int bh = item / n_tp, row0 = item % n_tp * 128 + 64 * wg;
      hopper::mbar_wait(q_full, it & 1);
      float s[NS][16];
      scores<NS>(s, ring, idx, q_s + wg * kTile, q_empty, warp, lane, g, t4);
      float mb[2], inv[2];
      softmax_rows<NS>(s, N, sl2, t4, mb, inv);

      // delta = sum_k P dP, dP = dO V^T a step at a time.
      hopper::mbar_wait(d_ready, it & 1);
      float dd[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int c = 0; c < NS; ++c) {
        const unsigned char* vc = ring.wait(idx + NS + c);
        float dp[16];
        hopper::wgmma_fence();
        abt_ss(dp, dob, dos, vc);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dp);
        ring.release(idx + NS + c, lane);
#pragma unroll
        for (int i = 0; i < 16; ++i)
          dd[(i >> 1) & 1][i & 1] = fmaf(s[c][i], dp[i], dd[(i >> 1) & 1][i & 1]);
      }
      float delta[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) delta[r] = quad_sum(dd[r][0] + dd[r][1]);
      if (t4 == 0) {
        float* st = stats + (long long)bh * 3 * kMaxN;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + 16 * warp + g + 8 * r;
          const bool ok = row < N;
          st[row] = ok ? mb[r] : __int_as_float(0x7f800000);
          st[kMaxN + row] = ok ? inv[r] : 0.f;
          st[2 * kMaxN + row] = ok ? delta[r] : 0.f;
        }
      }

      // dS = P (dP - delta), dQ += dS K: dP again a step at a time, dS split
      // as the A operand, K^T's parts from the step's T slot.
      float acc[32];
#pragma unroll
      for (int c = 0; c < NS; ++c) {
        const int f = idx + 2 * NS + 2 * c;
        const unsigned char* vc = ring.wait(f);
        float dp[16];
        hopper::wgmma_fence();
        abt_ss(dp, dob, dos, vc);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dp);
        ring.release(f, lane);
#pragma unroll
        for (int i = 0; i < 16; ++i) dp[i] = s[c][i] * (dp[i] - delta[(i >> 1) & 1]);
        uint32_t db[4][4], ds[4][4];
        frags(db, ds, dp);
        const unsigned char* kt = ring.wait(f + 1);
        hopper::wgmma_fence();
        ab_rs(acc, db, ds, kt + kStep, c > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        ring.release(f + 1, lane);
      }
      idx += 4 * NS;
      warp_arrive(d_empty, lane);
      const int b = bh / H, h = bh % H;
      store_rows(acc, dq + b * sb + h * sh, sn, row0, N, D, scale, warp, g, t4);
    }
  }
}

// ---------------------------------------------------------------------------
// Kernel 7, launch 2: dK and dV
// ---------------------------------------------------------------------------

// A work item is two 64-row key tiles of one (batch, head) pair, their raw
// K and V resident. The ring carries per 32-query step j its Q, then its dO,
// each in both forms: the transform warps write the T form from the raw
// rows, meet, then split the rows in place.
__global__ void __launch_bounds__(kThreads, 1)
short_bwd_dkv_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tg, float* __restrict__ dk,
                          float* __restrict__ dv, const float* __restrict__ stats, int BH, int H,
                          int N, int D, long long skb, long long skn, long long skh, long long svb,
                          long long svn, long long svh, float scale, int pos_q, int pos_k,
                          int pos_v, int pos_g) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* kv_s = smem;  // per warpgroup: its raw K tile, then its raw V tile
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + 4 * kTile + kDkvSlots * kDkvSlot);
  uint64_t* kv_full = bars;
  uint64_t* kv_empty = bars + 1;
  const Ring<kDkvSlots, kDkvSlot> ring{smem + 4 * kTile, bars + 2, bars + 2 + kDkvSlots,
                                       bars + 2 + 2 * kDkvSlots};
  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    hopper::mbar_init(kv_empty, kConsumerWarps);
    ring.init();
    hopper::mbar_init_fence();
  }
  __syncthreads();
  const int n_tp = tile_pairs(N), n_items = BH * n_tp;
  const int ns = (N + 31) / 32;
  const int lane = threadIdx.x % 32;

  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    hopper::regs_release<kProducerRegs>();
    const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
    if (warp == 0) {
      if (lane == 0) {
        int idx = 0;
        for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
          const int bh = item / n_tp, b = bh / H, h = bh % H, row0 = item % n_tp * 128;
          hopper::mbar_wait(kv_empty, (it & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(kv_full, 4 * kTile);
#pragma unroll
          for (int w = 0; w < 2; ++w) {
            load_tile(kv_s + 2 * w * kTile, &tk, pos_k, kv_full, h, row0 + 64 * w, b);
            load_tile(kv_s + (2 * w + 1) * kTile, &tv, pos_v, kv_full, h, row0 + 64 * w, b);
          }
          for (int j = 0; j < ns; ++j) {
            load_step(ring.acquire(idx, kStep), &tq, pos_q, ring.bar(idx), h, 32 * j, b);
            ++idx;
            load_step(ring.acquire(idx, kStep), &tg, pos_g, ring.bar(idx), h, 32 * j, b);
            ++idx;
          }
        }
      }
    } else {
      const int tw = warp - 1, tid = threadIdx.x - 32;
      int idx = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x)
        for (int j = 0; j < 2 * ns; ++j, ++idx) {
          unsigned char* p = ring.arrived(idx);
          transpose(p, p + 2 * kStep, p + 2 * kStep + kT, tw, lane);
          hopper::named_sync(1, kTransformThreads);  // every T read of the raw rows is done
          split_rows<kStep>(p, tid);
          ring.transformed(idx, lane);
        }
    }
  } else {
    hopper::regs_claim<kConsumerRegs>();
    const int tid = threadIdx.x - 128;
    const int wg = tid / 128, warp = (tid / 32) % 4;
    const int g = lane / 4, t4 = lane % 4;
    const float sl2 = scale * kLog2e;
    const unsigned char* k_t = kv_s + 2 * wg * kTile;
    const unsigned char* v_t = k_t + kTile;
    int idx = 0;
    for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
      const int bh = item / n_tp, row0 = item % n_tp * 128 + 64 * wg;
      const float* st_m = stats + (long long)bh * 3 * kMaxN;
      hopper::mbar_wait(kv_full, it & 1);
      float adk[32], adv[32];
#pragma unroll 1
      for (int j = 0; j < ns; ++j, idx += 2) {
        // S^T = K Q_j^T and dP^T = V dO_j^T: this tile's 64 keys x 32 queries.
        float st[16], dpt[16];
        const unsigned char* qj = ring.wait(idx);
        {
          uint32_t xb[8][4], xs[8][4];
          load_frags(xb, xs, k_t, warp, g, t4);
          hopper::wgmma_fence();
          abt_rs(st, xb, xs, qj);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(st);
        }
        const unsigned char* gj = ring.wait(idx + 1);
        {
          uint32_t xb[8][4], xs[8][4];
          load_frags(xb, xs, v_t, warp, g, t4);
          hopper::wgmma_fence();
          abt_rs(dpt, xb, xs, gj);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(dpt);
        }
        // P^T and dS^T = P^T (dP^T - delta) from launch 1's statistics of
        // the step's queries (P = 0 past N).
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int q = 32 * j + 8 * jj + 2 * t4;
          const float2 m = *reinterpret_cast<const float2*>(st_m + q);
          const float2 il = *reinterpret_cast<const float2*>(st_m + kMaxN + q);
          const float2 dl = *reinterpret_cast<const float2*>(st_m + 2 * kMaxN + q);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool odd = e & 1;
            const float p = hopper::exp2_approx(fmaf(st[4 * jj + e], sl2, -(odd ? m.y : m.x)))
                            * (odd ? il.y : il.x);
            st[4 * jj + e] = p;
            dpt[4 * jj + e] = p * (dpt[4 * jj + e] - (odd ? dl.y : dl.x));
          }
        }
        uint32_t pb[4][4], ps[4][4], db[4][4], ds[4][4];
        frags(pb, ps, st);
        frags(db, ds, dpt);
        hopper::wgmma_fence();
        ab_rs(adv, pb, ps, gj + 2 * kStep, j > 0);
        ab_rs(adk, db, ds, qj + 2 * kStep, j > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(adv);
        hopper::fence_regs(adk);
        ring.release(idx, lane);
        ring.release(idx + 1, lane);
      }
      warp_arrive(kv_empty, lane);
      const int b = bh / H, h = bh % H;
      store_rows(adk, dk + b * skb + h * skh, skn, row0, N, D, scale, warp, g, t4);
      store_rows(adv, dv + b * svb + h * svh, svn, row0, N, D, 1.f, warp, g, t4);
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

int sm_count() {
  static int sms = [] {
    int dev = 0, n = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return sms;
}

int grid_for(int BH, int N) {
  const long long items = (long long)BH * tile_pairs(N);
  return items < sm_count() ? (int)items : sm_count();
}

// f32 4-D maps over the (B, N, H, D) tensors read in 32-row boxes of 32
// columns (one 128-byte swizzle span a row).
bool encode_maps(CUtensorMap* m, int* pos, const void* const* ptrs, int n, int B, int N, int H,
                 int D, const long long* st) {
  for (int i = 0; i < n; ++i)
    if (!hopper::encode_bnhd_map(&m[i], ptrs[i], B, N, H, D, st[3 * i], st[3 * i + 1],
                                 st[3 * i + 2], 32, 32, CU_TENSOR_MAP_SWIZZLE_128B, &pos[i],
                                 CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
      return false;
  return true;
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int NS>
cudaError_t launch_fwd(const CUtensorMap (&m)[3], const int (&pos)[3], void* o, int BH, int H,
                       int N, int D, const long long* st, float scale, cudaStream_t s) {
  cudaError_t err = set_smem(short_fwd_tf32_kernel<NS>, kFwdSmem);
  if (err != cudaSuccess) return err;
  short_fwd_tf32_kernel<NS><<<grid_for(BH, N), kThreads, kFwdSmem, s>>>(
      m[0], m[1], m[2], static_cast<float*>(o), BH, H, N, D, st[9], st[10], st[11], scale,
      pos[0], pos[1], pos[2]);
  return cudaGetLastError();
}

template <int NS>
cudaError_t launch_dq(const CUtensorMap (&m)[4], const int (&pos)[4], void* dq, float* stats,
                      int BH, int H, int N, int D, const long long* st, float scale,
                      cudaStream_t s) {
  cudaError_t err = set_smem(short_bwd_dq_tf32_kernel<NS>, kDqSmem);
  if (err != cudaSuccess) return err;
  short_bwd_dq_tf32_kernel<NS><<<grid_for(BH, N), kThreads, kDqSmem, s>>>(
      m[0], m[1], m[2], m[3], static_cast<float*>(dq), stats, BH, H, N, D, st[12], st[13],
      st[14], scale, pos[0], pos[1], pos[2], pos[3]);
  return cudaGetLastError();
}

}  // namespace

bool takes(int dtype, int N, int D, const long long* st, int n) {
  if (dtype != 0 || N < kMinN || N > kMaxN || D < 1 || D > kMaxD) return false;
  for (int i = 0; i < n; ++i)
    if (st[i] <= 0) return false;
  return true;
}

size_t bwd_scratch_floats(int B, int H) { return (size_t)3 * B * H * kMaxN; }

cudaError_t fwd(const void* q, const void* k, const void* v, void* o, int B, int H, int N, int D,
                const long long* st, float scale, cudaStream_t s) {
  CUtensorMap m[3];
  int pos[3];
  const void* ptrs[3] = {q, k, v};
  if (!encode_maps(m, pos, ptrs, 3, B, N, H, D, st)) return cudaErrorInvalidValue;
  const int BH = B * H;
  switch ((N + 31) / 32) {
    case 3: return launch_fwd<3>(m, pos, o, BH, H, N, D, st, scale, s);
    case 4: return launch_fwd<4>(m, pos, o, BH, H, N, D, st, scale, s);
    case 5: return launch_fwd<5>(m, pos, o, BH, H, N, D, st, scale, s);
    case 6: return launch_fwd<6>(m, pos, o, BH, H, N, D, st, scale, s);
    case 7: return launch_fwd<7>(m, pos, o, BH, H, N, D, st, scale, s);
    case 8: return launch_fwd<8>(m, pos, o, BH, H, N, D, st, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t bwd(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
                void* dv, float* stats, int B, int H, int N, int D, const long long* st,
                float scale, cudaStream_t s) {
  if (stats == nullptr) return cudaErrorInvalidValue;
  CUtensorMap m[4];
  int pos[4];
  const void* ptrs[4] = {q, k, v, g};
  if (!encode_maps(m, pos, ptrs, 4, B, N, H, D, st)) return cudaErrorInvalidValue;
  const int BH = B * H;
  cudaError_t err;
  switch ((N + 31) / 32) {
    case 3: err = launch_dq<3>(m, pos, dq, stats, BH, H, N, D, st, scale, s); break;
    case 4: err = launch_dq<4>(m, pos, dq, stats, BH, H, N, D, st, scale, s); break;
    case 5: err = launch_dq<5>(m, pos, dq, stats, BH, H, N, D, st, scale, s); break;
    case 6: err = launch_dq<6>(m, pos, dq, stats, BH, H, N, D, st, scale, s); break;
    case 7: err = launch_dq<7>(m, pos, dq, stats, BH, H, N, D, st, scale, s); break;
    case 8: err = launch_dq<8>(m, pos, dq, stats, BH, H, N, D, st, scale, s); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  if ((err = set_smem(short_bwd_dkv_tf32_kernel, kDkvSmem)) != cudaSuccess) return err;
  short_bwd_dkv_tf32_kernel<<<grid_for(BH, N), kThreads, kDkvSmem, s>>>(
      m[0], m[1], m[2], m[3], static_cast<float*>(dk), static_cast<float*>(dv), stats, BH, H, N,
      D, st[15], st[16], st[17], st[18], st[19], st[20], scale, pos[0], pos[1], pos[2], pos[3]);
  return cudaGetLastError();
}

}  // namespace shorttf
