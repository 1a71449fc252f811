// Kernels 6 and 7 (short_attention.cu's entries) in float32 at short
// sequences on Hopper's tensor cores: the design "mma.tf32x3", which
// short_attention.cu's launchers take for f32 at 1 <= N <= 64, D <= 64
// (after padding) with every batch, sequence and head stride positive
// (shortmma::takes). TimeSformer's temporal attention, (B·196, 32, 12, 64)
// on views of its fused qkv projection, is the call it is built for.
//
// Replaces, for those calls, laryngeal_tpu/ops/short_attention.py's
// _fwd_kernel (:101) and _bwd_kernel (:118) in f32, with their arithmetic:
// S = Q K^T scaled, a whole-row softmax (every key of a row at once: the row
// max and sum are exact, no online rescale), P normalised before P V; the
// backward recomputes P, takes delta = sum_k P dP from the f32 P and dP (not
// rowsum(dO O)), dS = P (dP - delta) scale, dQ = dS K, dK = dS^T Q,
// dV = P^T dO, all five products once, summed inside the block (no atomics,
// no scratch: deterministic).
//
// What bounds it on the H100, at (1568, 32, 12, 64): a (sequence, head) pair
// is 8 KB a tensor. The forward moves 617 MB (q, k, v read, o written once:
// 0.184 ms at 3.35 TB/s) for 2 products, 1.48e10 FLOP in 3xTF32 (0.030 ms
// at 495 TFLOP/s); the backward 1.08 GB (0.322 ms) for 5, 3.70e10 FLOP
// (0.075 ms). Both are bound by bytes, so the design's one job is to read
// each byte once, with enough of them in flight, and to keep the products
// and the softmax from setting the pace:
//   * A pair is the unit of work, whole. Persistent blocks, as many an SM as
//     shared memory allows (the occupancy the runtime reports), walk the
//     pairs. Warp 0's lane 0 brings each pair's Q, K, V (and dO) in by TMA
//     (4-D maps over the (B, N, H, D) strides, so the fused-qkv views need
//     no copy; 32-column boxes of 16 ceil(N / 16) rows, 128-byte swizzle;
//     rows past N and columns past D arrive as zeros) into a ring of pair
//     stages with mbarriers: at N = 32 the forward's blocks (two stages,
//     four blocks an SM) load their next pair while they compute this one,
//     the backward's (one stage, five an SM) hide each other's loads.
//   * The products are mma.sync.m16n8k8 in TF32, 3xTF32: each operand x is
//     split into big (x with its low 13 bits masked) and small = tf32(x -
//     big) (cvt.rna), and each product is small.big + big.small + big.big
//     (TF32 alone keeps 10 mantissa bits and misses the f32 limits:
//     tests/test_torch_short_attention.py's emulation). mma.sync reads its
//     fragments from registers, so every operand is read from the swizzled
//     TMA tile in whatever order a fragment needs (conflict-free) and split
//     in registers on the way: no transform warps, no split pass through
//     shared memory (what bound the wgmma.tf32x3 design at N = 197). An
//     accumulator is the A operand of the next product as it is: columns 2t
//     and 2t + 1 of each 8 sit at positions t and t + 4 of the k step, and
//     the B operand reads rows 2t and 2t + 1 in that order. S, dP, O and dQ
//     keep the two small terms in accumulators of their own, added once at
//     the end: two chains of dependent mma where one would be three deep a
//     step (dV and dK, eight independent chains a warp, keep one each).
//   * Kernel 6: consumer warp w takes query rows [16 w, 16 w + 16); the
//     whole score row (N <= 64 keys; 16 floats a thread at N = 32) stays in
//     registers, so the softmax is exact in one pass.
//   * Kernel 7, two consumer warps a 16-row tile (twice kernel 6's, to hide
//     its longer chains of products): phase A, queries as rows, each warp of
//     a tile S = Q K^T and dP = dO V^T over its half of the keys, the row
//     max, sum and sum of P dP exchanged with the other through shared
//     memory (the softmax stays exact), then dS; P and dS go to shared
//     memory ([query][key], f32). A named barrier, then each warp dQ = dS K
//     over its half of the head dim, and phase B, keys as rows: P^T and dS^T
//     read as A fragments, dV = P^T dO and dK = dS^T Q over the queries, its
//     half of the head dim.
//   * Outputs leave from registers in 16-byte stores: lanes t and t ^ 1
//     trade halves of their two rows, so a quad writes 32 contiguous bytes
//     of a row a store.

#include "short_attention_tf32_mma.cuh"

#include "flash_attention_common.cuh"
#include "hopper.cuh"

namespace shortmma {
namespace {

using flash::kLog2e;
using flash::kMaskValue;
using flash::quad_max;
using flash::quad_sum;

// Pair stages a block's ring holds (scripts/ablate_short_*.py --f32
// --temporal): the forward loads its next pair while it computes this one;
// the backward's blocks (43 KB at N = 32, five an SM against three with two
// stages) hide each other's loads.
constexpr int kFwdStages = 2, kBwdStages = 1;

// A pair at NT 16-row tiles (N <= 16 NT) and head dim HD (32 or 64).
template <int NT, int HD>
struct Geom {
  static constexpr int kRows = 16 * NT;             // a tensor's rows, N padded
  static constexpr int kRowSteps = 2 * NT;          // 8-row steps of the padded rows
  static constexpr int kDimSteps = HD / 8;          // 8-column steps of the head dim
  static constexpr int kPanel = kRows * 128;        // bytes of 32 columns of a tensor
  static constexpr int kTensor = HD / 32 * kPanel;  // bytes of a tensor
  // The producer warp and a consumer warp a tile (kernel 6) or two (kernel 7).
  static constexpr int kFwdWarps = NT, kBwdWarps = 2 * NT;
  static constexpr int kPitch = kRows + 4;          // floats a row of P or dS (kernel 7)
  // Shared memory of a block: `stages` stages of `tensors` tensors (and, for
  // kernel 7, P, dS and each row's max, sum and sum of P dP a key half), the
  // ring's barriers, the slack for 1024-byte alignment.
  static constexpr size_t smem(int stages, int tensors, bool scores) {
    return (size_t)stages * tensors * kTensor + (scores ? (2 * kPitch + 6) * kRows * 4 : 0)
           + 2 * stages * 8 + 1024;
  }
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (hopper::smem_u32(p) & 1023)) & 1023);
}

// The float at (row, col) of a tensor as TMA wrote it: 32-column panels of
// PANEL bytes, rows of 128 bytes, 16-byte chunk c of row r at c ^ r % 8.
template <int PANEL>
__device__ __forceinline__ float at(const unsigned char* tile, int row, int col) {
  const int c = col & 31;
  return *reinterpret_cast<const float*>(tile + (col >> 5) * PANEL + row * 128
                                         + ((((c >> 2) ^ row) & 7) << 4) + (c & 3) * 4);
}

// x = big + small + O(2^-21 |x|), both TF32 with their low 13 bits zero.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = hopper::tf32_rna(x - __uint_as_float(big));
}

// d (16 x 8 f32) += A (16 x 8 tf32) B (8 x 8 tf32). A: a[0] (g, t), a[1]
// (g + 8, t), a[2] (g, t + 4), a[3] (g + 8, t + 4); B: b[0] (t, g), b[1]
// (t + 4, g); d: d[e] at row g + 8 (e >> 1), column 2t + (e & 1).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A B in 3xTF32, small.big + big.small + big.big (the dropped small.small
// and the rounding of small leave ~2^-20 of |A||B|): the two small terms
// into c, the big one into d. A caller that gives its own c adds it to d
// after the last step: two chains of dependent mma where one would be three
// deep a step (the forward's blocks are too few to hide the longer chain:
// `one_chain` in scripts/ablate_short_fwd.py --f32 --temporal). c may be d
// itself.
__device__ __forceinline__ void mma3(float (&d)[4], float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  mma(c, as, bb);
  mma(c, ab, bs);
  mma(d, ab, bb);
}

// d += c, a product's small terms after its last step.
template <int COLS>
__device__ __forceinline__ void add_small(float (&d)[COLS][4], const float (&c)[COLS][4]) {
#pragma unroll
  for (int j = 0; j < COLS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[j][e] += c[j][e];
}

// The split A fragment of a product over the head dim: rows r and r + 8,
// columns c and c + 4 of a tensor (c = 8 kk + t).
template <int PANEL>
__device__ __forceinline__ void a_frag(uint32_t (&ab)[4], uint32_t (&as)[4],
                                       const unsigned char* tile, int r, int c) {
  split(at<PANEL>(tile, r, c), ab[0], as[0]);
  split(at<PANEL>(tile, r + 8, c), ab[1], as[1]);
  split(at<PANEL>(tile, r, c + 4), ab[2], as[2]);
  split(at<PANEL>(tile, r + 8, c + 4), ab[3], as[3]);
}

// The split B fragment of (r0, c0) and (r1, c1) of a tensor: (8 j + g,
// 8 kk + t) and (8 j + g, 8 kk + t + 4) for a product over the head dim
// (B = X^T); (8 kk + 2t, 8 j + g) and (8 kk + 2t + 1, 8 j + g) for one
// over the rows (B = X), in the order an accumulator's A fragment takes.
template <int PANEL>
__device__ __forceinline__ void b_frag(uint32_t (&bb)[2], uint32_t (&bs)[2],
                                       const unsigned char* tile, int r0, int c0, int r1, int c1) {
  split(at<PANEL>(tile, r0, c0), bb[0], bs[0]);
  split(at<PANEL>(tile, r1, c1), bb[1], bs[1]);
}

// An accumulator's 16 x 8 values as the split A fragment of a product over
// its columns: columns 2t and 2t + 1 at positions t and t + 4 (fragment
// register r takes element 0, 2, 1, 3).
__device__ __forceinline__ void acc_frag(uint32_t (&ab)[4], uint32_t (&as)[4],
                                         const float (&c)[4]) {
  split(c[0], ab[0], as[0]);
  split(c[2], ab[1], as[1]);
  split(c[1], ab[2], as[2]);
  split(c[3], ab[3], as[3]);
}

// The split A fragment of a product over the queries with the keys as rows,
// from a [query][key] matrix of PITCH floats a row: keys r and r + 8,
// queries q = 8 kk + 2t and q + 1 at positions t and t + 4.
template <int PITCH>
__device__ __forceinline__ void at_frag(uint32_t (&ab)[4], uint32_t (&as)[4], const float* m,
                                        int q, int r) {
  split(m[q * PITCH + r], ab[0], as[0]);
  split(m[q * PITCH + r + 8], ab[1], as[1]);
  split(m[(q + 1) * PITCH + r], ab[2], as[2]);
  split(m[(q + 1) * PITCH + r + 8], ab[3], as[3]);
}

// S = A B^T over the head dim for rows r, r + 8 of tensor `a` against the
// first KT 8-row steps of `b` (a tensor, or its rows from a multiple of 8
// on), `n` of its rows valid (steps at or past n skipped, left 0).
template <int KT, int HD, int PANEL>
__device__ __forceinline__ void abt(float (&s)[KT][4], const unsigned char* a,
                                    const unsigned char* b, int r, int n, int D, int g, int t) {
  float c[KT][4] = {};
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    if (8 * kk >= D) break;
    uint32_t ab[4], as[4];
    a_frag<PANEL>(ab, as, a, r, 8 * kk + t);
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      if (8 * j >= n) break;
      uint32_t bb[2], bs[2];
      b_frag<PANEL>(bb, bs, b, 8 * j + g, 8 * kk + t, 8 * j + g, 8 * kk + t + 4);
      mma3(s[j], c[j], ab, as, bb, bs);
    }
  }
  add_small(s, c);
}

// acc (16 x HD) = P X over the rows for a warp's accumulator tile P (16 x 16
// NT, its columns the rows of tensor x; steps at or past N skipped).
template <int NT, int HD>
__device__ __forceinline__ void px(float (&acc)[HD / 8][4], const float (&p)[2 * NT][4],
                                   const unsigned char* x, int N, int D, int g, int t) {
  using Gm = Geom<NT, HD>;
#pragma unroll
  for (int j = 0; j < Gm::kDimSteps; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float c[HD / 8][4] = {};
#pragma unroll
  for (int kk = 0; kk < Gm::kRowSteps; ++kk) {
    if (8 * kk >= N) break;
    uint32_t ab[4], as[4];
    acc_frag(ab, as, p[kk]);
#pragma unroll
    for (int j = 0; j < Gm::kDimSteps; ++j) {
      if (8 * j >= D) break;
      uint32_t bb[2], bs[2];
      b_frag<Gm::kPanel>(bb, bs, x, 8 * kk + 2 * t, 8 * j + g, 8 * kk + 2 * t + 1, 8 * j + g);
      mma3(acc[j], c[j], ab, as, bb, bs);
    }
  }
  add_small(acc, c);
}

// The whole-row softmax of rows g and g + 8 of a warp's 16, in place: keys
// >= N masked, the exact row max, exp2, the row sum, P = exp2(..) / l.
template <int KT>
__device__ __forceinline__ void softmax_rows(float (&s)[KT][4], int N, float sl2, int t) {
  float mb[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < KT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (8 * j + 2 * t + (e & 1) >= N) s[j][e] = kMaskValue;
      mb[e >> 1] = fmaxf(mb[e >> 1], s[j][e]);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) mb[i] = quad_max(mb[i]) * sl2;
#pragma unroll
  for (int j = 0; j < KT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = hopper::exp2_approx(fmaf(s[j][e], sl2, -mb[e >> 1]));
      l[e >> 1] += s[j][e];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = 1.f / quad_sum(l[i]);
#pragma unroll
  for (int j = 0; j < KT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] *= l[e >> 1];
}

// Rows r and r + 8 of a warp's accumulator tile to `base` (rows `rs` floats
// apart), rows < N and columns < D, in 16-byte stores: lanes t and t ^ 1
// trade halves, so that an even lane holds row r, columns 8 j + 2t .. + 3,
// and an odd lane row r + 8, columns 8 j + 2t - 2 .. + 1.
template <int COLS>
__device__ __forceinline__ void store_rows(const float (&acc)[COLS][4], float* base, long long rs,
                                           int r, int N, int D, int t) {
  const bool odd = t & 1;
  const int row = odd ? r + 8 : r;
  float* out = base + row * rs + 2 * (t & 2);
#pragma unroll
  for (int j = 0; j < COLS; ++j) {
    if (8 * j >= D) break;
    const float x0 = __shfl_xor_sync(0xffffffffu, odd ? acc[j][0] : acc[j][2], 1);
    const float x1 = __shfl_xor_sync(0xffffffffu, odd ? acc[j][1] : acc[j][3], 1);
    if (row < N)
      *reinterpret_cast<float4*>(out + 8 * j) = odd ? make_float4(x0, x1, acc[j][2], acc[j][3])
                                                    : make_float4(acc[j][0], acc[j][1], x0, x1);
  }
}

// One pair of a tensor map into its stage slot: 32-column boxes of the
// pair's 16 NT rows.
template <int NT, int HD>
__device__ __forceinline__ void load_pair(unsigned char* dst, const CUtensorMap* m, int pos,
                                          uint64_t* bar, int h, int b) {
  int c1, c2, c3;
  hopper::bnhd_coords(pos, h, 0, b, c1, c2, c3);
#pragma unroll
  for (int p = 0; p < HD / 32; ++p)
    hopper::tma_load_4d(dst + p * Geom<NT, HD>::kPanel, m, bar, 32 * p, c1, c2, c3);
}

// The ring's barriers: full[s] takes the producer's transaction bytes,
// empty[s] the WARPS consumer warps.
template <int WARPS, int STAGES>
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], WARPS);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
}

// The producer (warp 0, lane 0): each of the block's pairs, TENSORS maps, into
// the ring of STAGES stages in order.
template <int NT, int HD, int TENSORS, int STAGES>
__device__ __forceinline__ void produce(unsigned char* stages, uint64_t* full, uint64_t* empty,
                                        const CUtensorMap* const (&maps)[TENSORS],
                                        const int (&pos)[TENSORS], int BH, int H) {
  using Gm = Geom<NT, HD>;
  for (int pair = blockIdx.x, i = 0; pair < BH; pair += gridDim.x, ++i) {
    const int s = i % STAGES;
    hopper::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
    hopper::mbar_arrive_expect_tx(&full[s], TENSORS * Gm::kTensor);
    unsigned char* dst = stages + s * TENSORS * Gm::kTensor;
#pragma unroll
    for (int x = 0; x < TENSORS; ++x)
      load_pair<NT, HD>(dst + x * Gm::kTensor, maps[x], pos[x], &full[s], pair % H, pair / H);
  }
}

template <int NT, int HD>
__global__ void __launch_bounds__(32 * (Geom<NT, HD>::kFwdWarps + 1))
short_fwd_mma_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, float* __restrict__ o, int BH,
                          int H, int N, int D, long long sob, long long son, long long soh,
                          float sl2, int pos_q, int pos_k, int pos_v) {
  using Gm = Geom<NT, HD>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* stages = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + kFwdStages * 3 * Gm::kTensor);
  uint64_t* empty = full + kFwdStages;
  init_ring<Gm::kFwdWarps, kFwdStages>(full, empty);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 0) {
    if (lane == 0)
      produce<NT, HD, 3, kFwdStages>(stages, full, empty, {&tq, &tk, &tv}, {pos_q, pos_k, pos_v},
                                     BH, H);
    return;
  }
  const int g = lane / 4, t = lane % 4, r = 16 * (warp - 1) + g;
  for (int pair = blockIdx.x, i = 0; pair < BH; pair += gridDim.x, ++i) {
    const int s = i % kFwdStages;
    hopper::mbar_wait(&full[s], (i / kFwdStages) & 1);
    const unsigned char* q_s = stages + s * 3 * Gm::kTensor;
    const unsigned char* k_s = q_s + Gm::kTensor;
    const unsigned char* v_s = k_s + Gm::kTensor;
    float p[Gm::kRowSteps][4] = {}, acc[Gm::kDimSteps][4];
    abt<2 * NT, HD, Gm::kPanel>(p, q_s, k_s, r, N, D, g, t);
    softmax_rows(p, N, sl2, t);
    px<NT, HD>(acc, p, v_s, N, D, g, t);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
    store_rows(acc, o + (pair / H) * sob + (pair % H) * soh, son, r, N, D, t);
  }
}

// Kernel 7, two consumer warps a 16-row tile: warp 2 w + h takes queries
// [16 w, 16 w + 16) over key half h in phase A (S and dP; the row max, sum
// and sum of P dP exchanged with warp 2 w + 1 - h through shared memory),
// then dQ's column half h over every key, and keys [16 w, 16 w + 16) as rows
// for dV's and dK's column half h.
template <int NT, int HD>
__global__ void __launch_bounds__(32 * (Geom<NT, HD>::kBwdWarps + 1))
short_bwd_mma_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tg, float* __restrict__ dq,
                          float* __restrict__ dk, float* __restrict__ dv, int BH, int H, int N,
                          int D, long long dqb, long long dqn, long long dqh, long long dkb,
                          long long dkn, long long dkh, long long dvb, long long dvn,
                          long long dvh, float sl2, float scale, int pos_q, int pos_k, int pos_v,
                          int pos_g) {
  using Gm = Geom<NT, HD>;
  constexpr int kPitch = Gm::kPitch;
  constexpr int kWarps = Gm::kBwdWarps;
  constexpr int kCols = HD / 16;  // 8-column steps of a column half
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* stages = align1024(smem_raw);
  float* p_s = reinterpret_cast<float*>(stages + kBwdStages * 4 * Gm::kTensor);  // P [q][key]
  float* ds_s = p_s + Gm::kRows * kPitch;                                         // dS, the same
  // Each row's max, sum and sum of P dP over each key half, [row][half].
  float* xm = ds_s + Gm::kRows * kPitch;
  float* xl = xm + 2 * Gm::kRows;
  float* xd = xl + 2 * Gm::kRows;
  uint64_t* full = reinterpret_cast<uint64_t*>(xd + 2 * Gm::kRows);
  uint64_t* empty = full + kBwdStages;
  init_ring<kWarps, kBwdStages>(full, empty);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 0) {
    if (lane == 0)
      produce<NT, HD, 4, kBwdStages>(stages, full, empty, {&tq, &tk, &tv, &tg},
                                     {pos_q, pos_k, pos_v, pos_g}, BH, H);
    return;
  }
  const int w = (warp - 1) >> 1, half = (warp - 1) & 1;
  const int g = lane / 4, t = lane % 4, r = 16 * w + g;
  const int key0 = 8 * NT * half, col0 = HD / 2 * half;
  for (int pair = blockIdx.x, i = 0; pair < BH; pair += gridDim.x, ++i) {
    const int s = i % kBwdStages, b = pair / H, h = pair % H;
    hopper::mbar_wait(&full[s], (i / kBwdStages) & 1);
    const unsigned char* q_s = stages + s * 4 * Gm::kTensor;
    const unsigned char* k_s = q_s + Gm::kTensor;
    const unsigned char* v_s = k_s + Gm::kTensor;
    const unsigned char* g_s = v_s + Gm::kTensor;
    {
      // Phase A: S and dP over this warp's half of the keys; the softmax and
      // delta over both halves; P and dS (0 for queries >= N) to shared memory.
      float p[NT][4] = {}, dp[NT][4] = {};
      abt<NT, HD, Gm::kPanel>(p, q_s, k_s + 128 * key0, r, N - key0, D, g, t);
      abt<NT, HD, Gm::kPanel>(dp, g_s, v_s + 128 * key0, r, N - key0, D, g, t);
      float mb[2] = {kMaskValue, kMaskValue};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (key0 + 8 * j + 2 * t + (e & 1) >= N) p[j][e] = kMaskValue;
          mb[e >> 1] = fmaxf(mb[e >> 1], p[j][e]);
        }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mb[e] = quad_max(mb[e]);
        if (t == 0) xm[2 * (r + 8 * e) + half] = mb[e];
      }
      hopper::named_sync(1 + w, 64);
#pragma unroll
      for (int e = 0; e < 2; ++e) mb[e] = fmaxf(mb[e], xm[2 * (r + 8 * e) + 1 - half]) * sl2;
      float l[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[j][e] = hopper::exp2_approx(fmaf(p[j][e], sl2, -mb[e >> 1]));
          l[e >> 1] += p[j][e];
          dl[e >> 1] = fmaf(p[j][e], dp[j][e], dl[e >> 1]);
        }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        l[e] = quad_sum(l[e]);
        dl[e] = quad_sum(dl[e]);
        if (t == 0) {
          xl[2 * (r + 8 * e) + half] = l[e];
          xd[2 * (r + 8 * e) + half] = dl[e];
        }
      }
      hopper::named_sync(1 + w, 64);
      bool live[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = r + 8 * e;
        l[e] = 1.f / (l[e] + xl[2 * row + 1 - half]);
        dl[e] = (dl[e] + xd[2 * row + 1 - half]) * l[e];
        live[e] = row < N;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pn = p[j][e] * l[e >> 1];
          dp[j][e] = live[e >> 1] ? pn * (dp[j][e] - dl[e >> 1]) * scale : 0.f;
          p[j][e] = live[e >> 1] ? pn : 0.f;
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int idx = (r + 8 * hh) * kPitch + key0 + 8 * j + 2 * t;
          *reinterpret_cast<float2*>(p_s + idx) = make_float2(p[j][2 * hh], p[j][2 * hh + 1]);
          *reinterpret_cast<float2*>(ds_s + idx) =
              make_float2(dp[j][2 * hh], dp[j][2 * hh + 1]);
        }
      }
    }
    hopper::named_sync(1 + NT, 32 * kWarps);  // every query's P and dS are in shared memory
    float adq[kCols][4] = {}, cq[kCols][4] = {};
    float adk[kCols][4] = {}, adv[kCols][4] = {};
    // dQ's column half over every key: dS rows r, r + 8 from shared memory
    // (keys 8 kk + 2t and + 1 at positions t and t + 4), K as B.
#pragma unroll
    for (int kk = 0; kk < Gm::kRowSteps; ++kk) {
      if (8 * kk >= N) break;
      uint32_t ab[4], as[4];
      const float* row = ds_s + r * kPitch + 8 * kk + 2 * t;
      const float2 lo = *reinterpret_cast<const float2*>(row);
      const float2 hi = *reinterpret_cast<const float2*>(row + 8 * kPitch);
      split(lo.x, ab[0], as[0]);
      split(hi.x, ab[1], as[1]);
      split(lo.y, ab[2], as[2]);
      split(hi.y, ab[3], as[3]);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = col0 + 8 * j;
        if (col >= D) break;
        uint32_t bb[2], bs[2];
        b_frag<Gm::kPanel>(bb, bs, k_s, 8 * kk + 2 * t, col + g, 8 * kk + 2 * t + 1, col + g);
        mma3(adq[j], cq[j], ab, as, bb, bs);
      }
    }
    add_small(adq, cq);
    // Keys r and r + 8 as rows: dV = P^T dO, dK = dS^T Q over the queries,
    // this warp's column half.
#pragma unroll
    for (int kk = 0; kk < Gm::kRowSteps; ++kk) {
      if (8 * kk >= N) break;
      uint32_t pb[4], psm[4], db[4], dsm[4];
      at_frag<kPitch>(pb, psm, p_s, 8 * kk + 2 * t, r);
      at_frag<kPitch>(db, dsm, ds_s, 8 * kk + 2 * t, r);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = col0 + 8 * j;
        if (col >= D) break;
        uint32_t bb[2], bs[2];
        b_frag<Gm::kPanel>(bb, bs, g_s, 8 * kk + 2 * t, col + g, 8 * kk + 2 * t + 1, col + g);
        mma3(adv[j], adv[j], pb, psm, bb, bs);
        b_frag<Gm::kPanel>(bb, bs, q_s, 8 * kk + 2 * t, col + g, 8 * kk + 2 * t + 1, col + g);
        mma3(adk[j], adk[j], db, dsm, bb, bs);
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
    store_rows(adq, dq + b * dqb + h * dqh + col0, dqn, r, N, D - col0, t);
    store_rows(adk, dk + b * dkb + h * dkh + col0, dkn, r, N, D - col0, t);
    store_rows(adv, dv + b * dvb + h * dvh + col0, dvn, r, N, D - col0, t);
    hopper::named_sync(1 + NT, 32 * kWarps);  // P, dS and the row statistics read
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

// f32 4-D maps over the (B, N, H, D) tensors read in boxes of 32 columns
// (one 128-byte swizzle span a row) and `rows` rows.
bool encode_maps(CUtensorMap* m, int* pos, const void* const* ptrs, int n, int B, int N, int H,
                 int D, const long long* st, int rows) {
  for (int i = 0; i < n; ++i)
    if (!hopper::encode_bnhd_map(&m[i], ptrs[i], B, N, H, D, st[3 * i], st[3 * i + 1],
                                 st[3 * i + 2], 32, rows, CU_TENSOR_MAP_SWIZZLE_128B, &pos[i],
                                 CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
      return false;
  return true;
}

// Blocks of `kernel` an SM at `smem` bytes (its attributes set on the way),
// 0 if the runtime refuses it.
template <typename K>
int blocks_per_sm(K kernel, int threads, size_t smem) {
  int n = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
          != cudaSuccess
      || cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared) != cudaSuccess
      || cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem) != cudaSuccess)
    return 0;
  return n;
}

// The persistent grid: `per_sm` blocks an SM, at most one a pair.
cudaError_t grid_for(int per_sm, int BH, int* grid) {
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long blocks = (long long)sm_count() * per_sm;
  *grid = BH < blocks ? BH : (int)blocks;
  return cudaSuccess;
}

template <int NT, int HD>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, int B, int H, int N,
                       int D, const long long* st, float scale, cudaStream_t s) {
  using Gm = Geom<NT, HD>;
  CUtensorMap m[3];
  int pos[3], grid = 0;
  const void* ptrs[3] = {q, k, v};
  if (!encode_maps(m, pos, ptrs, 3, B, N, H, D, st, Gm::kRows)) return cudaErrorInvalidValue;
  constexpr size_t smem = Gm::smem(kFwdStages, 3, false);
  constexpr int threads = 32 * (Gm::kFwdWarps + 1);
  static const int per_sm = blocks_per_sm(short_fwd_mma_tf32_kernel<NT, HD>, threads, smem);
  const int BH = B * H;
  cudaError_t err = grid_for(per_sm, BH, &grid);
  if (err != cudaSuccess) return err;
  short_fwd_mma_tf32_kernel<NT, HD><<<grid, threads, smem, s>>>(
      m[0], m[1], m[2], static_cast<float*>(o), BH, H, N, D, st[9], st[10], st[11],
      scale * kLog2e, pos[0], pos[1], pos[2]);
  return cudaGetLastError();
}

template <int NT, int HD>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* g, void* dq,
                       void* dk, void* dv, int B, int H, int N, int D, const long long* st,
                       float scale, cudaStream_t s) {
  using Gm = Geom<NT, HD>;
  CUtensorMap m[4];
  int pos[4], grid = 0;
  const void* ptrs[4] = {q, k, v, g};
  if (!encode_maps(m, pos, ptrs, 4, B, N, H, D, st, Gm::kRows)) return cudaErrorInvalidValue;
  constexpr size_t smem = Gm::smem(kBwdStages, 4, true);
  constexpr int threads = 32 * (Gm::kBwdWarps + 1);
  static const int per_sm = blocks_per_sm(short_bwd_mma_tf32_kernel<NT, HD>, threads, smem);
  const int BH = B * H;
  cudaError_t err = grid_for(per_sm, BH, &grid);
  if (err != cudaSuccess) return err;
  short_bwd_mma_tf32_kernel<NT, HD><<<grid, threads, smem, s>>>(
      m[0], m[1], m[2], m[3], static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), BH, H, N, D, st[12], st[13], st[14], st[15], st[16], st[17],
      st[18], st[19], st[20], scale * kLog2e, scale, pos[0], pos[1], pos[2], pos[3]);
  return cudaGetLastError();
}

// The instance of a call: NT = ceil(N / 16) row tiles, HD 32 or 64.
#define SHORTMMA_DISPATCH(LAUNCH, ...)                           \
  const int nt = (N + 15) / 16;                                 \
  if (D <= 32) {                                                \
    if (nt == 1) return LAUNCH<1, 32>(__VA_ARGS__);             \
    if (nt == 2) return LAUNCH<2, 32>(__VA_ARGS__);             \
    if (nt == 3) return LAUNCH<3, 32>(__VA_ARGS__);             \
    return LAUNCH<4, 32>(__VA_ARGS__);                          \
  }                                                             \
  if (nt == 1) return LAUNCH<1, 64>(__VA_ARGS__);               \
  if (nt == 2) return LAUNCH<2, 64>(__VA_ARGS__);               \
  if (nt == 3) return LAUNCH<3, 64>(__VA_ARGS__);               \
  return LAUNCH<4, 64>(__VA_ARGS__)

}  // namespace

bool takes(int dtype, int N, int D, const long long* st, int n) {
  if (dtype != 0 || N < kMinN || N > kMaxN || D < 1 || D > kMaxD) return false;
  for (int i = 0; i < n; ++i)
    if (st[i] <= 0) return false;
  return true;
}

cudaError_t fwd(const void* q, const void* k, const void* v, void* o, int B, int H, int N, int D,
                const long long* st, float scale, cudaStream_t s) {
  if (N < kMinN || N > kMaxN || D > kMaxD) return cudaErrorInvalidValue;
  SHORTMMA_DISPATCH(launch_fwd, q, k, v, o, B, H, N, D, st, scale, s);
}

cudaError_t bwd(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
                void* dv, int B, int H, int N, int D, const long long* st, float scale,
                cudaStream_t s) {
  if (N < kMinN || N > kMaxN || D > kMaxD) return cudaErrorInvalidValue;
  SHORTMMA_DISPATCH(launch_bwd, q, k, v, g, dq, dk, dv, B, H, N, D, st, scale, s);
}

}  // namespace shortmma
