// Short-sequence self-attention for Hopper (sm_90a), forward and backward,
// bound through a plain C interface (ctypes; see
// laryngeal_tpu_torch/ops/short_attention.py).
//
// Replaces the two Pallas TPU kernels of laryngeal_tpu/ops/short_attention.py
// that TimeSformer's divided attention takes (N < 512, D <= 128, Nq == Nk,
// no bias, no mask):
//   * _fwd_kernel (entry short_attention_fwd): S = (Q K^T, f32) * scale, a
//     full softmax in f32 (row max subtracted, exp, normalised BEFORE P V),
//     P rounded to v's dtype, P V accumulated in f32, cast to q's dtype;
//   * _bwd_kernel (entry short_attention_bwd): P recomputed as above, then
//     dV = P(rounded)^T G, dP = G V^T (f32), delta = sum_k dP * P per row
//     (from the f32 P and dP, not rowsum(dO * O)), dS = P * (dP - delta) *
//     scale rounded to q's dtype, dQ = dS K, dK = dS^T Q; every product
//     accumulates in f32 and each output is cast to its input's dtype. dQ,
//     dK and dV come out of one launch.
// The TPU kernels pack several sequences into one 128-lane score block with
// a block-diagonal mask; that is a TPU layout device that changes no result,
// and is not carried over. q, k, v (and G, dQ, dK, dV) are read through
// their (batch, sequence, head) strides, so views of a fused (B, N, 3, H, D)
// qkv projection need no copy.
//
// What bounds it on the H100: at TimeSformer-B, bf16, B=8 (temporal
// (1568, 32, 12, 64), spatial (256, 197, 12, 64)) the forward moves ~310 MB
// (q, k, v read, o written) against 5-31 GFLOP, and the backward ~540 MB
// (q, k, v, G read, dQ, dK, dV written) against 12-76 GFLOP: both are bound
// by bytes (~0.09 and ~0.16 ms at 3.35 TB/s). The designs therefore keep
// the score tiles in registers and read each sequence from device memory
// about once:
//   * bf16 forward at 64 < N <= 256 (TimeSformer's spatial N = 197): one
//     (sequence, head) pair is the unit of work. A persistent block per SM
//     walks over the pairs; its producer warp loads a pair's whole Q, K and V
//     into shared memory with TMA (a 4-D tensor map over the (B, N, H, D)
//     strides, 128-byte swizzle, rows past N filled with zeros), a pair
//     ahead in a 2-stage ring (1 stage at D = 128), and hands its registers
//     to two consumer warpgroups (setmaxnreg). A consumer takes a 64-row
//     query tile: S = Q K^T comes out of wgmma.m64n64k16 over up to four
//     64-key chunks, every key of the row at once, so the row max and sum
//     are exact in one pass (no second pass over K, no online rescale); P,
//     multiplied by 1/l and rounded to bf16, is packed in registers as the A
//     operand of O = P V (wgmma with V from shared memory, transposed); O
//     leaves through the tile's spent Q slot with a TMA store. K and V leave
//     device memory once per pair and are read from shared memory by every
//     query tile. On the H100 the design is bound by the consumers' work (a
//     pair's loads hide behind it): both warpgroups' products on the tensor
//     cores and the exp2/convert/max chains of the softmax between them.
//   * other bf16 forward calls (N <= 64, TimeSformer's temporal N = 32, and
//     256 < N < 512): mma.sync.m16n8k16, f32 accumulators. A block of W
//     warps (W = 1, 2 or 4, the smallest with 16 W >= N, else 4) owns 16 W
//     rows and makes two passes over 16 W-key tiles streamed through shared
//     memory with cp.async (double-buffered when there is more than one
//     tile): the first for each row's max and sum, the second forms the
//     normalised P, rounds it and accumulates P V. This design also stays
//     callable at every N as short_attention_fwd_mma, to time against.
//   * bf16 backward at 64 < N <= 256 and D <= 64 (TimeSformer's spatial
//     shape): one (sequence, head) pair is the unit of work, so the
//     reductions over queries (dK, dV) and over keys (dQ, delta) stay inside
//     one block (no atomics, deterministic). A persistent block per SM walks
//     over the pairs; its producer thread loads a pair's K and V whole with
//     TMA a pair ahead (two stages) and its Q and G 64 rows at a time into
//     one slot, each 64-row chunk as soon as every consumer warp has spent
//     the previous pair's (mbarriers per chunk), so the loads hide behind
//     the products; two consumer warpgroups (setmaxnreg) take the pair's
//     tiles in turn. Phase A, query tiles as rows: S = Q K^T over every key
//     at once (wgmma, f32 in registers), the exact softmax from the
//     accumulators, P normalised in place; dP = G V^T two 64-key chunks a
//     batch for delta = sum_k P dP; then dS = P (dP - delta) scale rounded
//     to bf16 as the register A operand of dQ += dS K (K read MN-major), the
//     last two chunks' dP kept from the delta pass and the others recomputed;
//     each row's base-2 max, 1 / l and delta go to shared memory (two pairs'
//     worth, so one warpgroup can start the next pair while the other
//     finishes). A named barrier, then phase B, key tiles as rows: per
//     64-query chunk S^T = K Q^T and dP^T = V G^T, P^T and dS^T from the
//     statistics, rounded to bf16 as the A operands of dV += P^T G and
//     dK += dS^T Q (as flash_attention_bwd.cu's dK/dV). S is computed twice
//     and dP two to three times (the TPU kernel: once each); the last
//     64-key (and 64-query) chunk is computed 16 wide when its valid rows
//     fit (N = 197: keys 192-207), which trims the products of the ragged
//     tail. On the H100 the design is bound by its products and the
//     softmax between them (see scripts/ablate_short_bwd.py).
//   * other bf16 backward calls (N <= 64, TimeSformer's temporal N = 32;
//     256 < N < 512; D = 128; a stride of 0): mma.sync, one block a whole
//     (sequence, head) pair. Phase 1 walks the query tiles: one pass over
//     the key tiles for the row max, sum and delta (an online sum of
//     exp(S - m) dP, divided by the row sum at the end), kept in shared
//     memory for all N rows, and a second pass for dS and dQ = dS K. Phase 2
//     walks the key tiles with the keys as rows: S^T = K Q^T and dP^T = V G^T
//     come out of the accumulators in the A-fragment layout of P^T G and
//     dS^T Q, with P rebuilt from the stored statistics. S and dP are
//     computed three times in all. This design also stays callable at every
//     shape as short_attention_bwd_mma, to time against.
//   * f32 at 64 < N <= 256 and D <= 64 with every stride positive
//     (TimeSformer's spatial shape): the tensor cores in 3xTF32, design
//     "wgmma.tf32x3" (short_attention_tf32.cu, built into this library).
//   * f32 at 1 <= N <= 64 and D <= 64 with every stride positive
//     (TimeSformer's temporal shape, N = 32): the tensor cores in 3xTF32 on
//     mma.sync, design "mma.tf32x3" (short_attention_tf32_mma.cu, built into
//     this library): a (sequence, head) pair whole, brought in once by TMA,
//     each product's operands split in registers, both kernels one launch.
//   * other f32 calls (256 < N < 512; D > 64; a stride of 0): the FMA units,
//     TF32 off (as the flash kernels): 1-4 threads per row, each owning a
//     32-wide slice of the head dim; the same passes as the mma.sync
//     designs. The _mma entries keep this design at every f32 shape, to time
//     the tensor-core ones against.
// short_attention_last_design reports the design of the last launch of each
// kernel, short_attention_design the one a call would run. Not yet done
// (later work): several short sequences per block for N <= 16 in bf16, the
// backward at D = 128 on wgmma (a pair's four tensors take 256 KB there).

#include <cstring>

#include "flash_attention_common.cuh"
#include "hopper.cuh"
#include "short_attention_tf32.cuh"
#include "short_attention_tf32_mma.cuh"
#include "wgmma_tiles.cuh"

namespace {

using namespace flash;
using bf16 = __nv_bfloat16;

constexpr int kMaxN = 511;  // the router sends N < 512 here

struct FwdStrides {
  long long qb, qn, qh, kb, kn, kh, vb, vn, vh, ob, on, oh;
};
struct BwdStrides {
  long long qb, qn, qh, kb, kn, kh, vb, vn, vh, gb, gn, gh;
  long long dqb, dqn, dqh, dkb, dkn, dkh, dvb, dvn, dvh;
};

// Copy rows [row0, row0 + ROWS) x [0, HD) of one (batch, head) slice into a
// padded shared tile with THREADS threads; rows >= n_rows and columns >= d
// are zero-filled.
template <int ROWS, int HD, int THREADS>
__device__ __forceinline__ void load_rows_async(bf16* tile, const bf16* base,
                                                long long row_stride, int row0, int n_rows,
                                                int d) {
  constexpr int kChunksPerRow = HD / 8;
  constexpr int kChunks = ROWS * kChunksPerRow;
  for (int c = threadIdx.x; c < kChunks; c += THREADS) {
    const int r = c / kChunksPerRow;
    const int col = (c % kChunksPerRow) * 8;
    const int row = row0 + r;
    const bool ok = row < n_rows && col < d;
    const bf16* src = ok ? base + row * row_stride + col : base;
    cp_async16(tile + r * (HD + kPad) + col, src, ok ? 16 : 0);
  }
}

// Scale the raw logits of key columns [key0, key0 + COLS) and mask keys >= N.
template <int COLS>
__device__ __forceinline__ void scale_mask(float (&s)[COLS / 8][4], int key0, int N, float scale) {
  const int tig = threadIdx.x % 4;
#pragma unroll
  for (int nt = 0; nt < COLS / 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = key0 + nt * 8 + tig * 2 + (j & 1);
      s[nt][j] = key < N ? s[nt][j] * scale : kMaskValue;
    }
}

// Store rows g and g + 8 of this warp's 16 (row0 = the warp's first row) of
// a 16 x HD f32 accumulator as bf16; rows >= N and columns >= D are not
// written.
template <int HD>
__device__ __forceinline__ void store_rows(bf16* base, long long row_stride,
                                           const float (&acc)[HD / 8][4], int row0, int N,
                                           int D) {
  const int lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + r * 8;
    if (row >= N) continue;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      const int col = dt * 8 + tig * 2;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(base + row * row_stride + col) =
            __floats2bfloat162_rn(acc[dt][2 * r], acc[dt][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 forward (kernel 6)
// ---------------------------------------------------------------------------

template <int HD, int W>
__global__ void __launch_bounds__(W * 32)
short_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o, int H, int N, int D,
                      FwdStrides st, float scale) {
  constexpr int T = W * 32;
  constexpr int BM = 16 * W;  // query rows of the block
  constexpr int BN = 16 * W;  // keys per streamed tile
  constexpr int NBUF = W == 4 ? 2 : 1;  // W < 4 means one tile holds all N keys
  constexpr int kLd = HD + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + BM * kLd;
  bf16* v_s = k_s + NBUF * BN * kLd;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32;
  const bf16* qb = q + b * st.qb + h * st.qh;
  const bf16* kb = k + b * st.kb + h * st.kh;
  const bf16* vb = v + b * st.vb + h * st.vh;
  const int n_tiles = (N + BN - 1) / BN;

  load_rows_async<BM, HD, T>(q_s, qb, st.qn, q0, N, D);
  load_rows_async<BN, HD, T>(k_s, kb, st.kn, 0, N, D);
  if (n_tiles == 1) load_rows_async<BN, HD, T>(v_s, vb, st.vn, 0, N, D);
  cp_async_commit();

  uint32_t qa[HD / 16][4];
  // Rows g and g + 8 of this warp's 16: the row max, and this thread's
  // partial row sum (the quad's partials add up after the pass).
  float m_row[2] = {kMaskValue, kMaskValue};
  float l_row[2] = {0.f, 0.f};

  // Pass 1: row max and row sum over all key tiles.
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t % NBUF;
    if (t + 1 < n_tiles) {
      load_rows_async<BN, HD, T>(k_s + ((t + 1) % NBUF) * BN * kLd, kb, st.kn, (t + 1) * BN, N, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) load_a_frag<HD>(qa[ks], q_s, warp * 16, ks);
    }
    float s[BN / 8][4];
    product_abt_regs<HD, BN>(s, qa, k_s + buf * BN * kLd);
    scale_mask<BN>(s, t * BN, N, scale);
    float mx[2] = {m_row[0], m_row[1]};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) mx[j >> 1] = fmaxf(mx[j >> 1], s[nt][j]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      l_row[r] *= expf(m_row[r] - mx[r]);
      m_row[r] = mx[r];
    }
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) l_row[j >> 1] += expf(s[nt][j] - m_row[j >> 1]);
    __syncthreads();  // the next copy overwrites this buffer
  }
  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv_l[r] = 1.f / quad_sum(l_row[r]);

  // Pass 2: P = exp(S - m) / l, rounded to bf16, O = P V.
  if (n_tiles > 1) {
    load_rows_async<BN, HD, T>(k_s, kb, st.kn, 0, N, D);
    load_rows_async<BN, HD, T>(v_s, vb, st.vn, 0, N, D);
    cp_async_commit();
  }
  float acc[HD / 8][4];
  zero(acc);
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t % NBUF;
    if (t + 1 < n_tiles) {
      const int nb = (t + 1) % NBUF;
      load_rows_async<BN, HD, T>(k_s + nb * BN * kLd, kb, st.kn, (t + 1) * BN, N, D);
      load_rows_async<BN, HD, T>(v_s + nb * BN * kLd, vb, st.vn, (t + 1) * BN, N, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[BN / 8][4];
    product_abt_regs<HD, BN>(s, qa, k_s + buf * BN * kLd);
    scale_mask<BN>(s, t * BN, N, scale);
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = expf(s[nt][j] - m_row[j >> 1]) * inv_l[j >> 1];
    product_pv<HD, BN>(acc, s, v_s + buf * BN * kLd);
    __syncthreads();
  }
  store_rows<HD>(o + b * st.ob + h * st.oh, st.on, acc, q0 + warp * 16, N, D);
}

// ---------------------------------------------------------------------------
// bf16 forward on wgmma and TMA (kernel 6 at 64 < N <= 256)
// ---------------------------------------------------------------------------

constexpr int kWgMaxN = 256;      // keys of a (batch, head) held in shared memory at once
constexpr int kWgThreads = 384;   // warpgroup 0 loads, warpgroups 1-2 compute
constexpr int kWgConsumerWarps = 8;

// Shared-memory geometry at head dim HD: q, k and v of one (batch, head)
// pair per stage, each as 256 rows of 64 (HD = 32: 32) head-dim values per
// swizzled panel.
template <int HD>
struct WgTile {
  static constexpr int kPanelCols = HD == 32 ? 32 : 64;
  static constexpr int kPanels = HD / kPanelCols;
  static constexpr int kRowBytes = 2 * kPanelCols;  // the swizzle width, 64 or 128 bytes
  static constexpr int kGroupBytes = 8 * kRowBytes;  // one 8-row swizzle group
  static constexpr uint64_t kLayout = HD == 32 ? hopper::kLayoutSw64 : hopper::kLayoutSw128;
  static constexpr int kPanelBytes = kWgMaxN * kRowBytes;
  static constexpr int kTensorBytes = kPanels * kPanelBytes;  // 512 HD
  static constexpr int kStageBytes = 3 * kTensorBytes;
  static constexpr int kStages = HD == 128 ? 1 : 2;  // 192 KB a stage at HD = 128
  static constexpr size_t kSmemBytes = (size_t)kStages * kStageBytes + 1024 + 64;
};

// Issue the TMA loads of rows [0, 64 nb) of one (batch, head) slice of a
// tensor into its stage slot: nb boxes of 64 rows per panel.
template <int HD>
__device__ __forceinline__ void wg_load(unsigned char* dst, const CUtensorMap* map, int pos,
                                        uint64_t* bar, int h, int b, int nb) {
  using T = WgTile<HD>;
#pragma unroll
  for (int p = 0; p < T::kPanels; ++p)
    for (int r = 0; r < nb; ++r) {
      int c1, c2, c3;
      hopper::bnhd_coords(pos, h, r * 64, b, c1, c2, c3);
      hopper::tma_load_4d(dst + p * T::kPanelBytes + r * 64 * T::kRowBytes, map, bar,
                          p * T::kPanelCols, c1, c2, c3);
    }
}

// One 64-row query tile qt of a (batch, head) pair whose q, k and v sit in
// shared memory, computed by one warpgroup (named barrier `bar`) over NB =
// ceil(N / 64) key chunks: S = Q K^T on wgmma (every key of the row at once,
// f32 in registers), the exact softmax from the accumulators (row max, exp2,
// row sum, multiply by 1/l), P rounded to bf16 and packed in registers as
// the A operand of O = P V. O goes to global memory through the tile's Q
// slot, free once S is done, with a TMA store (rows past N are not written);
// the issuing thread waits for the store's reads before its warp releases
// the stage. Every register index is static.
template <int HD, int NB>
__device__ __forceinline__ void wg_tile(unsigned char* q_s, const unsigned char* k_s,
                                        const unsigned char* v_s, const CUtensorMap* to,
                                        int pos_o, int b, int h, int qt, int N, float scale_log2,
                                        int bar, int warp, int g, int t4) {
  using T = WgTile<HD>;
  constexpr int kSteps = T::kPanelCols / 16;  // k16 steps per panel
  unsigned char* tile = q_s + qt * 64 * T::kRowBytes;
  const uint64_t dq = hopper::smem_desc(tile, 16, T::kGroupBytes, T::kLayout);
  const uint64_t dk = hopper::smem_desc(k_s, 16, T::kGroupBytes, T::kLayout);
  // V is read MN-major (its head-dim values contiguous); a product spans one
  // swizzle atom along them, so only the 8-row group stride matters, and it
  // goes in both offset fields.
  const uint64_t dv = hopper::smem_desc(v_s, T::kGroupBytes, T::kGroupBytes, T::kLayout);

  float s[NB][32];
  hopper::wgmma_fence();
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int p = 0; p < T::kPanels; ++p)
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks)
        hopper::wgmma_m64n64k16_ss(
            s[c], dq + ((p * T::kPanelBytes + ks * 32) >> 4),
            dk + ((p * T::kPanelBytes + c * 64 * T::kRowBytes + ks * 32) >> 4), p + ks > 0);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < NB; ++c) hopper::fence_regs(s[c]);

  // Keys >= N (the last chunk's tail) are masked; then the row max of rows
  // g and g + 8 of this warp's 16, in four partial maxima per row (short
  // dependency chains).
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = (NB - 1) * 64 + j * 8 + 2 * t4 + (e & 1);
      s[NB - 1][4 * j + e] = key < N ? s[NB - 1][4 * j + e] : kMaskValue;
    }
  float mx[2][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) mx[i & 1][i >> 1] = kMaskValue;
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float& m = mx[(i >> 1) & 1][(i >> 2) & 3];
      m = fmaxf(m, s[c][i]);
    }
  float sum[2][4], mb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mb[r] = quad_max(fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]))) * scale_log2;
#pragma unroll
    for (int i = 0; i < 4; ++i) sum[r][i] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (c < NB - 1 || c * 64 + j * 8 < N) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = hopper::exp2_approx(fmaf(s[c][4 * j + e], scale_log2, -mb[e >> 1]));
          s[c][4 * j + e] = x;
          sum[e >> 1][j & 3] += x;
        }
      } else {  // no key of this 8-column block is valid
#pragma unroll
        for (int e = 0; e < 4; ++e) s[c][4 * j + e] = 0.f;
      }
    }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    inv[r] = 1.f / quad_sum((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
  // P = exp(S - m) / l rounded to bf16: the A fragment of keys
  // [64 c + 16 kk, 64 c + 16 kk + 16).
  uint32_t pa[NB][4][4];
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[c][kk][r] = pack_bf16(s[c][8 * kk + 2 * r] * inv[r & 1],
                                 s[c][8 * kk + 2 * r + 1] * inv[r & 1]);

  float acc[T::kPanels][T::kPanelCols / 2];
  hopper::wgmma_fence();
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < T::kPanels; ++p) {
        const uint64_t db = dv + ((p * T::kPanelBytes + (c * 64 + kk * 16) * T::kRowBytes) >> 4);
        if constexpr (T::kPanelCols == 64)
          hopper::wgmma_m64n64k16_rs_tb(acc[p], pa[c][kk], db, c + kk > 0);
        else
          hopper::wgmma_m64n32k16_rs_tb(acc[p], pa[c][kk], db, c + kk > 0);
      }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int p = 0; p < T::kPanels; ++p) hopper::fence_regs(acc[p]);

  // O in bf16 into the Q slot, in the layout TMA reads (the swizzle the
  // loads wrote), then one TMA store per panel.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;
    const int x = T::kRowBytes == 128 ? row & 7 : (row >> 1) & 3;
#pragma unroll
    for (int p = 0; p < T::kPanels; ++p)
#pragma unroll
      for (int j = 0; j < T::kPanelCols / 8; ++j)
        *reinterpret_cast<uint32_t*>(tile + p * T::kPanelBytes + row * T::kRowBytes
                                     + ((j ^ x) << 4) + 4 * t4) =
            pack_bf16(acc[p][4 * j + 2 * r], acc[p][4 * j + 2 * r + 1]);
  }
  hopper::fence_async_smem();
  hopper::named_sync(bar, 128);
  if (warp == 0 && g == 0 && t4 == 0) {
    int c1, c2, c3;
    hopper::bnhd_coords(pos_o, h, qt * 64, b, c1, c2, c3);
#pragma unroll
    for (int p = 0; p < T::kPanels; ++p)
      hopper::tma_store_4d(to, tile + p * T::kPanelBytes, p * T::kPanelCols, c1, c2, c3);
    hopper::tma_store_commit();
  }
}

// A persistent block per SM walks over the (batch, head) pairs. Warpgroup 0
// (one thread) loads each pair's q, k and v whole into a shared-memory stage
// with TMA, a stage ahead of the consumers where two fit; warpgroups 1 and 2
// take the pair's query tiles in turn (tiles wg, wg + 2) and release the
// stage when both are done.
template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
short_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap to, int BH, int H, int N,
                       float scale_log2, int pos_q, int pos_k, int pos_v, int pos_o) {
  using T = WgTile<HD>;
  extern __shared__ __align__(1024) unsigned char wg_smem_raw[];
  unsigned char* smem = wg_smem_raw + ((1024 - (hopper::smem_u32(wg_smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kStages * T::kStageBytes);
  uint64_t* empty = full + T::kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kWgConsumerWarps);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
  const int nb = (N + 63) / 64;  // 64-row boxes per tensor = query tiles = key chunks

  // The role of this thread's warpgroup, broadcast from lane 0 so that the
  // compiler sees a warp-uniform branch.
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    hopper::regs_release<40>();
    if (threadIdx.x == 0) {
      const uint32_t bytes = 3u * T::kPanels * nb * 64 * T::kRowBytes;
      for (int u = blockIdx.x, i = 0; u < BH; u += gridDim.x, ++i) {
        const int s = i % T::kStages;
        hopper::mbar_wait(&empty[s], ((i / T::kStages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], bytes);
        const int b = u / H, h = u % H;
        unsigned char* stage = smem + s * T::kStageBytes;
        wg_load<HD>(stage, &tq, pos_q, &full[s], h, b, nb);
        wg_load<HD>(stage + T::kTensorBytes, &tk, pos_k, &full[s], h, b, nb);
        wg_load<HD>(stage + 2 * T::kTensorBytes, &tv, pos_v, &full[s], h, b, nb);
      }
    }
  } else {
    hopper::regs_claim<232>();
    const int tid = threadIdx.x - 128;
    const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    for (int u = blockIdx.x, i = 0; u < BH; u += gridDim.x, ++i) {
      const int s = i % T::kStages;
      hopper::mbar_wait(&full[s], (i / T::kStages) & 1);
      unsigned char* q_s = smem + s * T::kStageBytes;
      const unsigned char* k_s = q_s + T::kTensorBytes;
      const unsigned char* v_s = k_s + T::kTensorBytes;
      const int b = u / H, h = u % H;
      for (int qt = wg; qt < nb; qt += 2) {
        if (nb == 4)
          wg_tile<HD, 4>(q_s, k_s, v_s, &to, pos_o, b, h, qt, N, scale_log2, 1 + wg, warp, g, t4);
        else if (nb == 3)
          wg_tile<HD, 3>(q_s, k_s, v_s, &to, pos_o, b, h, qt, N, scale_log2, 1 + wg, warp, g, t4);
        else
          wg_tile<HD, 2>(q_s, k_s, v_s, &to, pos_o, b, h, qt, N, scale_log2, 1 + wg, warp, g, t4);
      }
      if (warp == 0 && lane == 0) hopper::tma_store_wait_read();  // O left the Q slots
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }
    if (warp == 0 && lane == 0) hopper::tma_store_wait_all();
  }
}

// ---------------------------------------------------------------------------
// bf16 backward (kernel 7)
// ---------------------------------------------------------------------------

template <int HD, int W>
__global__ void __launch_bounds__(W * 32)
short_bwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ gr,
                      bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                      int H, int N, int D, BwdStrides st, float scale) {
  constexpr int T = W * 32;
  constexpr int BM = 16 * W;  // rows the block's warps own (queries, then keys)
  constexpr int BN = 16 * W;  // phase 1: keys per streamed tile
  // Phase 2: queries per streamed tile; 32 at D = 128 keeps the two 128-wide
  // accumulators and the S / dP tiles within the register file.
  constexpr int BQ = (HD == 128 && W == 4) ? 32 : 16 * W;
  constexpr int NBUF = W == 4 ? 2 : 1;
  constexpr int kLd = HD + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* a_s = reinterpret_cast<bf16*>(smem_raw);  // Q rows, then K rows
  bf16* b_s = a_s + BM * kLd;                      // G rows, then V rows
  bf16* c_s = b_s + BM * kLd;                      // K tiles, then Q tiles
  bf16* d_s = c_s + NBUF * BN * kLd;               // V tiles, then G tiles
  const int n_pad = (N + 63) / 64 * 64;
  float* m_s = reinterpret_cast<float*>(d_s + NBUF * BN * kLd);  // row max
  float* il_s = m_s + n_pad;                                     // 1 / row sum
  float* dl_s = il_s + n_pad;                                    // delta

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const bf16* qb = q + b * st.qb + h * st.qh;
  const bf16* kb = k + b * st.kb + h * st.kh;
  const bf16* vb = v + b * st.vb + h * st.vh;
  const bf16* gb = gr + b * st.gb + h * st.gh;
  const int n_tiles = (N + BN - 1) / BN;

  // ---- phase 1: per query tile, row statistics, then dQ ----
  for (int q0 = 0; q0 < N; q0 += BM) {
    load_rows_async<BM, HD, T>(a_s, qb, st.qn, q0, N, D);
    load_rows_async<BM, HD, T>(b_s, gb, st.gn, q0, N, D);
    load_rows_async<BN, HD, T>(c_s, kb, st.kn, 0, N, D);
    load_rows_async<BN, HD, T>(d_s, vb, st.vn, 0, N, D);
    cp_async_commit();
    float m_row[2] = {kMaskValue, kMaskValue};
    float l_row[2] = {0.f, 0.f};
    float dd_row[2] = {0.f, 0.f};  // partial sums of exp(S - m) dP
    for (int t = 0; t < n_tiles; ++t) {
      const int buf = t % NBUF;
      if (t + 1 < n_tiles) {
        const int nb = (t + 1) % NBUF;
        load_rows_async<BN, HD, T>(c_s + nb * BN * kLd, kb, st.kn, (t + 1) * BN, N, D);
        load_rows_async<BN, HD, T>(d_s + nb * BN * kLd, vb, st.vn, (t + 1) * BN, N, D);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      float s[BN / 8][4], dp[BN / 8][4];
      product_abt<HD, BN>(s, a_s, warp * 16, c_s + buf * BN * kLd);
      product_abt<HD, BN>(dp, b_s, warp * 16, d_s + buf * BN * kLd);
      scale_mask<BN>(s, t * BN, N, scale);
      float mx[2] = {m_row[0], m_row[1]};
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) mx[j >> 1] = fmaxf(mx[j >> 1], s[nt][j]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        const float alpha = expf(m_row[r] - mx[r]);
        l_row[r] *= alpha;
        dd_row[r] *= alpha;
        m_row[r] = mx[r];
      }
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float e = expf(s[nt][j] - m_row[j >> 1]);
          l_row[j >> 1] += e;
          dd_row[j >> 1] += e * dp[nt][j];
        }
      __syncthreads();
    }
    float il[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      il[r] = 1.f / quad_sum(l_row[r]);
      dl[r] = quad_sum(dd_row[r]) * il[r];
      const int row = q0 + warp * 16 + g + r * 8;
      if (tig == 0 && row < N) {
        m_s[row] = m_row[r];
        il_s[row] = il[r];
        dl_s[row] = dl[r];
      }
    }
    // Second pass: dS = P (dP - delta) scale, rounded to bf16; dQ += dS K.
    if (n_tiles > 1) {
      load_rows_async<BN, HD, T>(c_s, kb, st.kn, 0, N, D);
      load_rows_async<BN, HD, T>(d_s, vb, st.vn, 0, N, D);
      cp_async_commit();
    }
    float acc[HD / 8][4];
    zero(acc);
    for (int t = 0; t < n_tiles; ++t) {
      const int buf = t % NBUF;
      if (t + 1 < n_tiles) {
        const int nb = (t + 1) % NBUF;
        load_rows_async<BN, HD, T>(c_s + nb * BN * kLd, kb, st.kn, (t + 1) * BN, N, D);
        load_rows_async<BN, HD, T>(d_s + nb * BN * kLd, vb, st.vn, (t + 1) * BN, N, D);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* kt = c_s + buf * BN * kLd;
      float s[BN / 8][4], dp[BN / 8][4];
      product_abt<HD, BN>(s, a_s, warp * 16, kt);
      product_abt<HD, BN>(dp, b_s, warp * 16, d_s + buf * BN * kLd);
      scale_mask<BN>(s, t * BN, N, scale);
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = j >> 1;
          const float p = expf(s[nt][j] - m_row[r]) * il[r];
          s[nt][j] = p * (dp[nt][j] - dl[r]) * scale;
        }
      product_pv<HD, BN>(acc, s, kt);
      __syncthreads();
    }
    store_rows<HD>(dq + b * st.dqb + h * st.dqh, st.dqn, acc, q0 + warp * 16, N, D);
  }
  __syncthreads();  // the statistics of every row are in shared memory

  // ---- phase 2: per key tile, dK and dV over all query tiles ----
  const int nq_tiles = (N + BQ - 1) / BQ;
  for (int k0 = 0; k0 < N; k0 += BM) {
    load_rows_async<BM, HD, T>(a_s, kb, st.kn, k0, N, D);
    load_rows_async<BM, HD, T>(b_s, vb, st.vn, k0, N, D);
    load_rows_async<BQ, HD, T>(c_s, qb, st.qn, 0, N, D);
    load_rows_async<BQ, HD, T>(d_s, gb, st.gn, 0, N, D);
    cp_async_commit();
    bool key_ok[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) key_ok[r] = k0 + warp * 16 + g + r * 8 < N;
    float acc_dk[HD / 8][4], acc_dv[HD / 8][4];
    zero(acc_dk);
    zero(acc_dv);
    for (int t = 0; t < nq_tiles; ++t) {
      const int buf = t % NBUF;
      if (t + 1 < nq_tiles) {
        const int nb = (t + 1) % NBUF;
        load_rows_async<BQ, HD, T>(c_s + nb * BN * kLd, qb, st.qn, (t + 1) * BQ, N, D);
        load_rows_async<BQ, HD, T>(d_s + nb * BN * kLd, gb, st.gn, (t + 1) * BQ, N, D);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* qt = c_s + buf * BN * kLd;
      const bf16* gt = d_s + buf * BN * kLd;
      // S^T = K Q^T and dP^T = V G^T: this warp's 16 keys x BQ queries.
      float st_[BQ / 8][4], dpt[BQ / 8][4];
      product_abt<HD, BQ>(st_, a_s, warp * 16, qt);
      product_abt<HD, BQ>(dpt, b_s, warp * 16, gt);
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qi = t * BQ + nt * 8 + tig * 2 + (j & 1);
          float p = 0.f, ds = 0.f;
          if (key_ok[j >> 1] && qi < N) {
            p = expf(st_[nt][j] * scale - m_s[qi]) * il_s[qi];
            ds = p * (dpt[nt][j] - dl_s[qi]) * scale;
          }
          st_[nt][j] = p;
          dpt[nt][j] = ds;
        }
      product_pv<HD, BQ>(acc_dv, st_, gt);  // dV += P^T G
      product_pv<HD, BQ>(acc_dk, dpt, qt);  // dK += dS^T Q
      __syncthreads();
    }
    store_rows<HD>(dk + b * st.dkb + h * st.dkh, st.dkn, acc_dk, k0 + warp * 16, N, D);
    store_rows<HD>(dv + b * st.dvb + h * st.dvh, st.dvn, acc_dv, k0 + warp * 16, N, D);
    __syncthreads();  // the next key tile's copies overwrite a_s .. d_s
  }
}

// ---------------------------------------------------------------------------
// bf16 backward on wgmma and TMA (kernel 7 at 64 < N <= 256, D <= 64)
// ---------------------------------------------------------------------------

// Consumer warpgroups; with two, the producer's warpgroup keeps 24 registers
// a thread and each consumer claims 240 (24 + 2 x 240 <= 512, the register
// file over 128 threads).
constexpr int kBwdConsumers = 2;
constexpr int kBwdThreads = 128 * (1 + kBwdConsumers);
constexpr int kBwdKvStages = 2;    // K and V of this pair and of the next
// The last 64-key chunk is computed kBwdTailKeys (16 or 8) wide when its
// valid keys fit (N = 197: keys 192-207 instead of 192-255); 0 keeps every
// chunk 64 wide. scripts/ablate_short_bwd.py times 0 and 8 against 16.
constexpr int kBwdTailKeys = 16;

// Shared memory at head dim HD <= 64 (one swizzled panel a row): K and V of
// kBwdKvStages pairs, then Q and dO, each tensor 256 rows; then the row
// statistics of two pairs (base-2 row max, 1 / row sum, delta: 256 floats
// each); then the barriers.
template <int HD>
struct BwdGeom {
  static_assert(HD <= 64, "the wgmma backward holds a pair's four tensors at D <= 64");
  using G = wgtile::WgTile<HD>;
  static constexpr int kTileBytes = G::kTileBytes;      // 64 rows
  static constexpr int kTensorBytes = 4 * kTileBytes;   // 256 rows
  static constexpr int kStats = 3 * kWgMaxN;
  static constexpr size_t kKvBytes = (size_t)kBwdKvStages * 2 * kTensorBytes;
  static constexpr size_t kStatOffset = kKvBytes + 2 * kTensorBytes;
  static constexpr size_t kBarOffset = kStatOffset + 2 * kStats * sizeof(float);
  static constexpr size_t kSmemBytes = kBarOffset + (2 * kBwdKvStages + 8) * sizeof(uint64_t)
                                       + 1024;
};

// d = A B^T over the head dim for a 64-row tile A and the first W (64, 16 or
// 8) rows of tile B: accumulator elements [0, W / 2) of d.
template <int HD, int W>
__device__ __forceinline__ void bwd_abt(float (&d)[32], const unsigned char* a,
                                        const unsigned char* b) {
  static_assert(W == 64 || W == 16 || W == 8, "a chunk is 64, 16 or 8 keys (queries) wide");
  if constexpr (W == 64) {
    wgtile::wg_abt<HD>(d, a, b);
  } else {
    using G = wgtile::WgTile<HD>;
    const uint64_t da = hopper::smem_desc(a, 16, G::kGroupBytes, G::kLayout);
    const uint64_t db = hopper::smem_desc(b, 16, G::kGroupBytes, G::kLayout);
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      if constexpr (W == 16)
        hopper::wgmma_m64n16k16_ss(d, da + (ks * 2), db + (ks * 2), ks > 0);
      else
        hopper::wgmma_m64n8k16_ss(d, da + (ks * 2), db + (ks * 2), ks > 0);
    }
  }
}

// The A fragments of a 64 x 64 f32 accumulator rounded to bf16, k16 steps
// [0, KK): fragment register r of step kk holds elements 8 kk + 2 r and + 1.
template <int KK>
__device__ __forceinline__ void bwd_pack(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// dS = P (dP - delta) scale of rows g and g + 8, rounded to bf16 as the A
// fragments of k16 steps [0, KK).
template <int KK>
__device__ __forceinline__ void bwd_dscores(uint32_t (&a)[4][4], const float (&p)[32],
                                            const float (&dp)[32], const float (&delta)[2],
                                            float scale) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 8 * kk + 2 * r;
      const float dl = delta[r & 1];
      a[kk][r] = pack_bf16(p[i] * (dp[i] - dl) * scale, p[i + 1] * (dp[i + 1] - dl) * scale);
    }
}

// Phase A of one 64-row query tile qt, by one warpgroup, over NB key chunks
// (the last TW keys wide): S = Q K^T for every key of the row at once (f32,
// in registers), the exact softmax from the accumulators, P normalised in
// place; dP = dO V^T R chunks a batch for delta = sum_k P dP (the last
// batch's chunks stay in registers), then dS = P (dP - delta) scale rounded
// to bf16 and dQ += dS K, the other chunks' dP recomputed. The rows' base-2
// max, 1 / l and delta go to `stats` (max +inf, 1 / l and delta 0 past N,
// so that phase B gives those queries P = 0); dQ is stored, rows past N not
// written. Every register index is static.
template <int HD, int NB, int TW>
__device__ __forceinline__ void bwd_rows(const unsigned char* q_s, const unsigned char* do_s,
                                         const unsigned char* k_s, const unsigned char* v_s,
                                         float* stats, bf16* dq, long long dqn, int qt, int N,
                                         int D, float sl2, float scale, int warp, int g,
                                         int t4) {
  constexpr int kT = BwdGeom<HD>::kTileBytes;
  constexpr int kTailSteps = (TW + 15) / 16;  // k16 steps of the last chunk
  const unsigned char* q_t = q_s + qt * kT;
  const unsigned char* do_t = do_s + qt * kT;

  float s[NB][32];
  hopper::wgmma_fence();
#pragma unroll
  for (int c = 0; c < NB - 1; ++c) bwd_abt<HD, 64>(s[c], q_t, k_s + c * kT);
  bwd_abt<HD, TW>(s[NB - 1], q_t, k_s + (NB - 1) * kT);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < NB; ++c) hopper::fence_regs(s[c]);

  // Keys >= N masked; the row max of rows g and g + 8 of this warp's 16 in
  // four partial maxima per row; exp2, the row sum, P = exp2(..) / l.
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = (NB - 1) * 64 + j * 8 + 2 * t4 + (e & 1);
      s[NB - 1][4 * j + e] = j < TW / 8 && key < N ? s[NB - 1][4 * j + e] : kMaskValue;
    }
  // The last chunk's elements past TW / 2 are statically masked (and then
  // 0): every loop below skips them, so that they take no registers.
  auto live = [](int c, int i) { return c < NB - 1 || i < TW / 2; };
  float mx[2][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) mx[i & 1][i >> 1] = kMaskValue;
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float& m = mx[(i >> 1) & 1][(i >> 2) & 3];
      if (live(c, i)) m = fmaxf(m, s[c][i]);
    }
  float sum[2][4], mb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mb[r] = quad_max(fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]))) * sl2;
#pragma unroll
    for (int i = 0; i < 4; ++i) sum[r][i] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (c < NB - 1 || (j < TW / 8 && c * 64 + j * 8 < N)) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = hopper::exp2_approx(fmaf(s[c][4 * j + e], sl2, -mb[e >> 1]));
          s[c][4 * j + e] = x;
          sum[e >> 1][j & 3] += x;
        }
      } else {  // no key of this 8-column block is valid (static past TW)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[c][4 * j + e] = 0.f;
      }
    }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    inv[r] = 1.f / quad_sum((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (live(c, i)) s[c][i] *= inv[(i >> 1) & 1];

  // delta = sum_k P dP: dP R chunks a batch (chunk c in dp[c - c0]), the
  // last batch holding chunks NB - R .. NB - 1. Two a batch leave a 64-key
  // chunk's dP fewer to recompute; at NB = 4 with a full last chunk the
  // second buffer does not fit beside the S row (ptxas spills).
  constexpr int R = NB == 4 && TW == 64 ? 1 : 2;
  float dp[R][32];
  float dd[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int c0 = NB - R * ((NB + R - 1) / R); c0 < NB; c0 += R) {
    hopper::wgmma_fence();
#pragma unroll
    for (int h = 0; h < R; ++h) {
      const int c = c0 + h;
      if (c >= 0 && c < NB - 1) bwd_abt<HD, 64>(dp[h], do_t, v_s + c * kT);
      if (c == NB - 1) bwd_abt<HD, TW>(dp[h], do_t, v_s + c * kT);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < R; ++h) hopper::fence_regs(dp[h]);
    if (c0 + R - 1 == NB - 1 && TW < 64) {
#pragma unroll
      for (int i = TW / 2; i < 32; ++i) dp[R - 1][i] = 0.f;  // not written by the narrow product
    }
#pragma unroll
    for (int h = 0; h < R; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = c0 + h < 0 ? 0 : c0 + h;
        if (c0 + h >= 0 && live(c, i))
          dd[(i >> 1) & 1][i & 1] = fmaf(s[c][i], dp[h][i], dd[(i >> 1) & 1][i & 1]);
      }
  }
  float delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) delta[r] = quad_sum(dd[r][0] + dd[r][1]);
  if (t4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qt * 64 + warp * 16 + g + 8 * r;
      const bool ok = row < N;
      stats[row] = ok ? mb[r] : __int_as_float(0x7f800000);
      stats[kWgMaxN + row] = ok ? inv[r] : 0.f;
      stats[2 * kWgMaxN + row] = ok ? delta[r] : 0.f;
    }
  }

  // dS = P (dP - delta) scale in bf16, dQ += dS K: the last batch's chunks
  // from registers, then the others from the last down, each batch also
  // recomputing the next chunk's dP into dp[0].
  wgtile::Acc<HD> acc;
  wgtile::zero_panels<HD>(acc);
  {
    uint32_t a_last[4][4], a_prev[4][4];
    bwd_dscores<kTailSteps>(a_last, s[NB - 1], dp[R - 1], delta, scale);
    if constexpr (R == 2) bwd_dscores<4>(a_prev, s[NB - 2], dp[0], delta, scale);
    hopper::wgmma_fence();
    wgtile::wg_ab<HD, kTailSteps>(acc, a_last, k_s + (NB - 1) * kT);
    if constexpr (R == 2) wgtile::wg_ab<HD>(acc, a_prev, k_s + (NB - 2) * kT);
    if constexpr (NB - 1 - R >= 0) bwd_abt<HD, 64>(dp[0], do_t, v_s + (NB - 1 - R) * kT);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    wgtile::fence_panels<HD>(acc);
    hopper::fence_regs(dp[0]);
  }
#pragma unroll
  for (int c = NB - 1 - R; c >= 0; --c) {
    uint32_t a[4][4];
    bwd_dscores<4>(a, s[c], dp[0], delta, scale);
    hopper::wgmma_fence();
    wgtile::wg_ab<HD>(acc, a, k_s + c * kT);
    if (c > 0) bwd_abt<HD, 64>(dp[0], do_t, v_s + (c - 1) * kT);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    wgtile::fence_panels<HD>(acc);
    hopper::fence_regs(dp[0]);
  }
  wgtile::wg_store<HD>(acc, dq, dqn, qt * 64, N, N, D, 1.f, warp, g, t4);
}

// Phase B of one 64-row key tile kt, by one warpgroup, with the keys as
// rows, over NB 64-query chunks (the last TW queries wide): S^T = K Q_j^T
// and dP^T = V dO_j^T, P^T and dS^T from phase A's statistics of the chunk's
// queries, then dV += P^T dO_j and dK += dS^T Q_j with P^T and dS^T, rounded
// to bf16, as the register A operands; each batch also runs the next chunk's
// S^T and dP^T. When `qd_empty` is given (this warpgroup's last key tile),
// each warp releases chunk j of Q and dO once its products are done. dK and
// dV are stored, rows past N not written.
template <int HD, int NB, int TW>
__device__ __forceinline__ void bwd_keys(const unsigned char* q_s, const unsigned char* do_s,
                                         const unsigned char* k_s, const unsigned char* v_s,
                                         const float* stats, bf16* dk, long long dkn, bf16* dv,
                                         long long dvn, int kt, int N, int D, float sl2,
                                         float scale, uint64_t* qd_empty, int warp, int lane,
                                         int g, int t4) {
  constexpr int kT = BwdGeom<HD>::kTileBytes;
  constexpr int kTailSteps = (TW + 15) / 16;
  const unsigned char* k_t = k_s + kt * kT;
  const unsigned char* v_t = v_s + kt * kT;
  wgtile::Acc<HD> acc_dk, acc_dv;
  wgtile::zero_panels<HD>(acc_dk);
  wgtile::zero_panels<HD>(acc_dv);
  float st[32], dpt[32];
  uint32_t pp[4][4], pd[4][4];
  hopper::wgmma_fence();
  bwd_abt<HD, 64>(st, k_t, q_s);
  bwd_abt<HD, 64>(dpt, v_t, do_s);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(st);
  hopper::fence_regs(dpt);
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const float* mb_s = stats + j * 64;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      if (j < NB - 1 || (jj < TW / 8 && j * 64 + jj * 8 < N)) {
        const float2 m = *reinterpret_cast<const float2*>(mb_s + 8 * jj + 2 * t4);
        const float2 il = *reinterpret_cast<const float2*>(mb_s + kWgMaxN + 8 * jj + 2 * t4);
        const float2 dl = *reinterpret_cast<const float2*>(mb_s + 2 * kWgMaxN + 8 * jj + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = hopper::exp2_approx(fmaf(st[4 * jj + e], sl2, -((e & 1) ? m.y : m.x)))
                          * ((e & 1) ? il.y : il.x);
          st[4 * jj + e] = p;
          dpt[4 * jj + e] = p * (dpt[4 * jj + e] - ((e & 1) ? dl.y : dl.x)) * scale;
        }
      } else {  // no query of this 8-column block is valid
#pragma unroll
        for (int e = 0; e < 4; ++e) st[4 * jj + e] = dpt[4 * jj + e] = 0.f;
      }
    }
    const unsigned char* q_j = q_s + j * kT;
    const unsigned char* do_j = do_s + j * kT;
    if (j == NB - 1) {
      bwd_pack<kTailSteps>(pp, st);
      bwd_pack<kTailSteps>(pd, dpt);
      hopper::wgmma_fence();
      wgtile::wg_ab<HD, kTailSteps>(acc_dv, pp, do_j);
      wgtile::wg_ab<HD, kTailSteps>(acc_dk, pd, q_j);
    } else {
      bwd_pack<4>(pp, st);
      bwd_pack<4>(pd, dpt);
      hopper::wgmma_fence();
      wgtile::wg_ab<HD>(acc_dv, pp, do_j);
      wgtile::wg_ab<HD>(acc_dk, pd, q_j);
      if (j + 1 < NB - 1) {
        bwd_abt<HD, 64>(st, k_t, q_j + kT);
        bwd_abt<HD, 64>(dpt, v_t, do_j + kT);
      } else {
        bwd_abt<HD, TW>(st, k_t, q_j + kT);
        bwd_abt<HD, TW>(dpt, v_t, do_j + kT);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(st);
    hopper::fence_regs(dpt);
    if (qd_empty != nullptr) {  // chunk j of Q and dO is spent for this warp
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&qd_empty[j]);
    }
  }
  wgtile::fence_panels<HD>(acc_dk);
  wgtile::fence_panels<HD>(acc_dv);
  wgtile::wg_store<HD>(acc_dk, dk, dkn, kt * 64, N, N, D, 1.f, warp, g, t4);
  wgtile::wg_store<HD>(acc_dv, dv, dvn, kt * 64, N, N, D, 1.f, warp, g, t4);
}

// A persistent block per SM walks over the (batch, head) pairs. Warpgroup 0
// (one thread) loads each pair's K and V whole into one of kBwdKvStages
// stages with TMA, a pair ahead of the consumers, and its Q and dO 64 rows at
// a time into one slot, each 64-row chunk as soon as the previous pair has
// spent it. The consumer warpgroups take the pair's query tiles in turn
// (phase A, tiles wg, wg + kBwdConsumers, ...), meet at a named barrier once
// every row's statistics are in shared memory, then take its key tiles in
// turn (phase B), and release the K/V stage when done.
template <int HD, int NB, int TW>
__global__ void __launch_bounds__(kBwdThreads, 1)
short_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo, bf16* __restrict__ dq,
                       bf16* __restrict__ dk, bf16* __restrict__ dv, int BH, int H, int N, int D,
                       BwdStrides st, float scale, int pos_q, int pos_k, int pos_v, int pos_do) {
  using Gm = BwdGeom<HD>;
  constexpr int S = kBwdKvStages;
  constexpr int kT = Gm::kTileBytes;
  constexpr int kConsumerWarps = 4 * kBwdConsumers;
  extern __shared__ __align__(1024) unsigned char wg_smem_raw[];
  unsigned char* smem = wgtile::align1024(wg_smem_raw);
  unsigned char* q_s = smem + Gm::kKvBytes;
  unsigned char* do_s = q_s + Gm::kTensorBytes;
  float* stats = reinterpret_cast<float*>(smem + Gm::kStatOffset);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + Gm::kBarOffset);
  uint64_t* kv_empty = kv_full + S;
  uint64_t* qd_full = kv_empty + S;
  uint64_t* qd_empty = qd_full + 4;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&kv_full[s], 1);
      hopper::mbar_init(&kv_empty[s], kConsumerWarps);
    }
    for (int j = 0; j < 4; ++j) {
      hopper::mbar_init(&qd_full[j], 1);
      hopper::mbar_init(&qd_empty[j], kConsumerWarps);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    if constexpr (kBwdConsumers > 1) hopper::regs_release<24>();
    if (threadIdx.x == 0) {
      for (int u = blockIdx.x, i = 0; u < BH; u += gridDim.x, ++i) {
        const int b = u / H, h = u % H;
        const int s = i % S;
        unsigned char* k_s = smem + s * 2 * Gm::kTensorBytes;
        hopper::mbar_wait(&kv_empty[s], ((i / S) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&kv_full[s], 2u * NB * kT);
        for (int c = 0; c < NB; ++c) {
          wgtile::wg_load_tile<HD>(k_s + c * kT, &tk, pos_k, &kv_full[s], h, 64 * c, b);
          wgtile::wg_load_tile<HD>(k_s + Gm::kTensorBytes + c * kT, &tv, pos_v, &kv_full[s], h,
                                   64 * c, b);
        }
        for (int j = 0; j < NB; ++j) {
          hopper::mbar_wait(&qd_empty[j], (i & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(&qd_full[j], 2u * kT);
          wgtile::wg_load_tile<HD>(q_s + j * kT, &tq, pos_q, &qd_full[j], h, 64 * j, b);
          wgtile::wg_load_tile<HD>(do_s + j * kT, &tdo, pos_do, &qd_full[j], h, 64 * j, b);
        }
      }
    }
  } else {
    if constexpr (kBwdConsumers > 1) hopper::regs_claim<240>();
    const int tid = threadIdx.x - 128;
    const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const float sl2 = scale * kLog2e;
    for (int u = blockIdx.x, i = 0; u < BH; u += gridDim.x, ++i) {
      const int b = u / H, h = u % H;
      const int s = i % S;
      const unsigned char* k_s = smem + s * 2 * Gm::kTensorBytes;
      const unsigned char* v_s = k_s + Gm::kTensorBytes;
      float* pair_stats = stats + (i & 1) * Gm::kStats;
      hopper::mbar_wait(&kv_full[s], (i / S) & 1);
      for (int qt = wg; qt < NB; qt += kBwdConsumers) {
        hopper::mbar_wait(&qd_full[qt], i & 1);
        bwd_rows<HD, NB, TW>(q_s, do_s, k_s, v_s, pair_stats, dq + b * st.dqb + h * st.dqh,
                             st.dqn, qt, N, D, sl2, scale, warp, g, t4);
      }
      hopper::named_sync(1, 128 * kBwdConsumers);  // every row's statistics are written
      for (int j = 0; j < NB; ++j) hopper::mbar_wait(&qd_full[j], i & 1);
      for (int kt = wg; kt < NB; kt += kBwdConsumers)
        bwd_keys<HD, NB, TW>(q_s, do_s, k_s, v_s, pair_stats, dk + b * st.dkb + h * st.dkh,
                             st.dkn, dv + b * st.dvb + h * st.dvh, st.dvn, kt, N, D, sl2, scale,
                             kt + kBwdConsumers >= NB ? qd_empty : nullptr, warp, lane, g, t4);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&kv_empty[s]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32 (FMA units)
// ---------------------------------------------------------------------------

constexpr int kF32Tile = 32;  // rows per streamed tile

template <int kTpr>
__device__ __forceinline__ float group_sum(float part) {
#pragma unroll
  for (int off = kTpr / 2; off > 0; off /= 2) part += __shfl_xor_sync(0xffffffffu, part, off);
  return part;
}

// Copy rows [row0, row0 + kF32Tile) of one or two (batch, head) slices into
// shared tiles; rows >= N and columns >= D are zero.
template <int HD>
__device__ __forceinline__ void load_f32_tiles(float (*a)[HD], const float* a_base, long long a_rs,
                                               float (*b)[HD], const float* b_base, long long b_rs,
                                               int row0, int N, int D) {
  for (int i = threadIdx.x; i < kF32Tile * HD / 4; i += kF32Threads) {
    const int r = i / (HD / 4), col = (i % (HD / 4)) * 4;
    const int row = row0 + r;
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f), bv = av;
    if (row < N && col < D) {
      av = *reinterpret_cast<const float4*>(a_base + row * a_rs + col);
      if (b) bv = *reinterpret_cast<const float4*>(b_base + row * b_rs + col);
    }
    *reinterpret_cast<float4*>(&a[r][col]) = av;
    if (b) *reinterpret_cast<float4*>(&b[r][col]) = bv;
  }
}

template <int HD>
__global__ void __launch_bounds__(kF32Threads)
short_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int H, int N, int D,
                     FwdStrides st, float scale) {
  constexpr int kTpr = HD / 32;              // threads per query row
  constexpr int kRows = kF32Threads / kTpr;  // query rows per block
  __shared__ __align__(16) float k_s[kF32Tile][HD];
  __shared__ __align__(16) float v_s[kF32Tile][HD];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int row = blockIdx.y * kRows + threadIdx.x / kTpr;
  const int c0 = (threadIdx.x % kTpr) * 32;
  const bool row_ok = row < N;
  const float* kb = k + b * st.kb + h * st.kh;
  const float* vb = v + b * st.vb + h * st.vh;
  const float* qr_p = q + b * st.qb + h * st.qh + row * st.qn;

  float qr[32], acc[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    qr[c] = (row_ok && c0 + c < D) ? qr_p[c0 + c] : 0.f;
    acc[c] = 0.f;
  }
  // Pass 1: row max and row sum.
  float m = kMaskValue, l = 0.f;
  for (int key0 = 0; key0 < N; key0 += kF32Tile) {
    __syncthreads();
    load_f32_tiles<HD>(k_s, kb, st.kn, nullptr, nullptr, 0, key0, N, D);
    __syncthreads();
    float s[kF32Tile];
    float mx = m;
#pragma unroll
    for (int j = 0; j < kF32Tile; ++j) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < 32; ++c) part = fmaf(qr[c], k_s[j][c0 + c], part);
      part = group_sum<kTpr>(part);
      s[j] = key0 + j < N ? part * scale : kMaskValue;
      mx = fmaxf(mx, s[j]);
    }
    l *= expf(m - mx);
    m = mx;
#pragma unroll
    for (int j = 0; j < kF32Tile; ++j) l += expf(s[j] - m);
  }
  const float inv_l = 1.f / l;
  // Pass 2: P = exp(S - m) / l, O = P V.
  for (int key0 = 0; key0 < N; key0 += kF32Tile) {
    __syncthreads();
    load_f32_tiles<HD>(k_s, kb, st.kn, v_s, vb, st.vn, key0, N, D);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kF32Tile; ++j) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < 32; ++c) part = fmaf(qr[c], k_s[j][c0 + c], part);
      part = group_sum<kTpr>(part);
      const float p = key0 + j < N ? expf(part * scale - m) * inv_l : 0.f;
#pragma unroll
      for (int c = 0; c < 32; ++c) acc[c] = fmaf(p, v_s[j][c0 + c], acc[c]);
    }
  }
  if (!row_ok) return;
  float* out = o + b * st.ob + h * st.oh + row * st.on;
#pragma unroll
  for (int c = 0; c < 32; ++c)
    if (c0 + c < D) out[c0 + c] = acc[c];
}

template <int HD>
__global__ void __launch_bounds__(kF32Threads)
short_bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ gr,
                     float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                     int H, int N, int D, BwdStrides st, float scale) {
  constexpr int kTpr = HD / 32;              // threads per row
  constexpr int kRows = kF32Threads / kTpr;  // rows owned at once
  __shared__ __align__(16) float a_s[kF32Tile][HD];  // K tiles, then Q tiles
  __shared__ __align__(16) float b_s[kF32Tile][HD];  // V tiles, then G tiles
  __shared__ float m_s[kMaxN + 1], il_s[kMaxN + 1], dl_s[kMaxN + 1];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int c0 = (threadIdx.x % kTpr) * 32;
  const float* qb = q + b * st.qb + h * st.qh;
  const float* kb = k + b * st.kb + h * st.kh;
  const float* vb = v + b * st.vb + h * st.vh;
  const float* gb = gr + b * st.gb + h * st.gh;

  // ---- phase 1: one query row per kTpr threads ----
  for (int row0 = 0; row0 < N; row0 += kRows) {
    const int row = row0 + threadIdx.x / kTpr;
    const bool row_ok = row < N;
    float qr[32], gv[32], acc[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const bool ok = row_ok && c0 + c < D;
      qr[c] = ok ? qb[row * st.qn + c0 + c] : 0.f;
      gv[c] = ok ? gb[row * st.gn + c0 + c] : 0.f;
      acc[c] = 0.f;
    }
    float m = kMaskValue, l = 0.f, dd = 0.f;
    for (int key0 = 0; key0 < N; key0 += kF32Tile) {
      __syncthreads();
      load_f32_tiles<HD>(a_s, kb, st.kn, b_s, vb, st.vn, key0, N, D);
      __syncthreads();
      float s[kF32Tile], dp[kF32Tile];
      float mx = m;
#pragma unroll
      for (int j = 0; j < kF32Tile; ++j) {
        float ps = 0.f, pd = 0.f;
#pragma unroll
        for (int c = 0; c < 32; ++c) {
          ps = fmaf(qr[c], a_s[j][c0 + c], ps);
          pd = fmaf(gv[c], b_s[j][c0 + c], pd);
        }
        ps = group_sum<kTpr>(ps);
        dp[j] = group_sum<kTpr>(pd);
        s[j] = key0 + j < N ? ps * scale : kMaskValue;
        mx = fmaxf(mx, s[j]);
      }
      const float alpha = expf(m - mx);
      l *= alpha;
      dd *= alpha;
      m = mx;
#pragma unroll
      for (int j = 0; j < kF32Tile; ++j) {
        const float e = expf(s[j] - m);
        l += e;
        dd += e * dp[j];
      }
    }
    const float il = 1.f / l, dl = dd * il;
    if (row_ok && c0 == 0) {
      m_s[row] = m;
      il_s[row] = il;
      dl_s[row] = dl;
    }
    for (int key0 = 0; key0 < N; key0 += kF32Tile) {
      __syncthreads();
      load_f32_tiles<HD>(a_s, kb, st.kn, b_s, vb, st.vn, key0, N, D);
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kF32Tile; ++j) {
        float ps = 0.f, pd = 0.f;
#pragma unroll
        for (int c = 0; c < 32; ++c) {
          ps = fmaf(qr[c], a_s[j][c0 + c], ps);
          pd = fmaf(gv[c], b_s[j][c0 + c], pd);
        }
        ps = group_sum<kTpr>(ps);
        pd = group_sum<kTpr>(pd);
        const float p = key0 + j < N ? expf(ps * scale - m) * il : 0.f;
        const float ds = p * (pd - dl) * scale;
#pragma unroll
        for (int c = 0; c < 32; ++c) acc[c] = fmaf(ds, a_s[j][c0 + c], acc[c]);
      }
    }
    if (row_ok) {
      float* out = dq + b * st.dqb + h * st.dqh + row * st.dqn;
#pragma unroll
      for (int c = 0; c < 32; ++c)
        if (c0 + c < D) out[c0 + c] = acc[c];
    }
  }

  // ---- phase 2: one key row per kTpr threads ----
  for (int key0r = 0; key0r < N; key0r += kRows) {
    const int key = key0r + threadIdx.x / kTpr;
    const bool key_ok = key < N;
    float kr[32], vr[32], adk[32], adv[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const bool ok = key_ok && c0 + c < D;
      kr[c] = ok ? kb[key * st.kn + c0 + c] : 0.f;
      vr[c] = ok ? vb[key * st.vn + c0 + c] : 0.f;
      adk[c] = 0.f;
      adv[c] = 0.f;
    }
    for (int row0 = 0; row0 < N; row0 += kF32Tile) {
      __syncthreads();  // also orders phase 1's statistics before their use
      load_f32_tiles<HD>(a_s, qb, st.qn, b_s, gb, st.gn, row0, N, D);
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < kF32Tile; ++i) {
        float ps = 0.f, pd = 0.f;
#pragma unroll
        for (int c = 0; c < 32; ++c) {
          ps = fmaf(kr[c], a_s[i][c0 + c], ps);
          pd = fmaf(vr[c], b_s[i][c0 + c], pd);
        }
        ps = group_sum<kTpr>(ps);
        pd = group_sum<kTpr>(pd);
        const int qi = row0 + i;
        float p = 0.f, ds = 0.f;
        if (key_ok && qi < N) {
          p = expf(ps * scale - m_s[qi]) * il_s[qi];
          ds = p * (pd - dl_s[qi]) * scale;
        }
#pragma unroll
        for (int c = 0; c < 32; ++c) {
          adv[c] = fmaf(p, b_s[i][c0 + c], adv[c]);
          adk[c] = fmaf(ds, a_s[i][c0 + c], adk[c]);
        }
      }
    }
    if (key_ok) {
      float* ok_ = dk + b * st.dkb + h * st.dkh + key * st.dkn;
      float* ov = dv + b * st.dvb + h * st.dvh + key * st.dvn;
#pragma unroll
      for (int c = 0; c < 32; ++c)
        if (c0 + c < D) {
          ok_[c0 + c] = adk[c];
          ov[c0 + c] = adv[c];
        }
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

int warps_for(int N) { return N <= 16 ? 1 : (N <= 32 ? 2 : 4); }

template <int HD, int W>
cudaError_t launch_fwd_bf16(const void* q, const void* k, const void* v, void* o, int BH, int H,
                            int N, int D, const FwdStrides& st, float scale, cudaStream_t s) {
  constexpr int NBUF = W == 4 ? 2 : 1;
  const size_t smem = (size_t)(16 * W + 2 * NBUF * 16 * W) * (HD + kPad) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(short_fwd_bf16_kernel<HD, W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(BH, (N + 16 * W - 1) / (16 * W));
  short_fwd_bf16_kernel<HD, W><<<grid, W * 32, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), H, N, D, st, scale);
  return cudaGetLastError();
}

template <int HD, int W>
cudaError_t launch_bwd_bf16(const void* q, const void* k, const void* v, const void* g, void* dq,
                            void* dk, void* dv, int BH, int H, int N, int D,
                            const BwdStrides& st, float scale, cudaStream_t s) {
  constexpr int NBUF = W == 4 ? 2 : 1;
  const int n_pad = (N + 63) / 64 * 64;
  const size_t smem = (size_t)(2 * 16 * W + 2 * NBUF * 16 * W) * (HD + kPad) * sizeof(bf16)
                      + 3 * n_pad * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(short_bwd_bf16_kernel<HD, W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  short_bwd_bf16_kernel<HD, W><<<BH, W * 32, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, N, D, st, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_fwd_wgmma(const void* q, const void* k, const void* v, void* o, int B, int H,
                             int N, int D, const FwdStrides& st, float scale, cudaStream_t s) {
  using T = WgTile<HD>;
  const CUtensorMapSwizzle sw = HD == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap tq, tk, tv, to;
  int pq, pk, pv, po;
  const int cols = T::kPanelCols;
  if (!hopper::encode_bnhd_map(&tq, q, B, N, H, D, st.qb, st.qn, st.qh, cols, 64, sw, &pq)
      || !hopper::encode_bnhd_map(&tk, k, B, N, H, D, st.kb, st.kn, st.kh, cols, 64, sw, &pk)
      || !hopper::encode_bnhd_map(&tv, v, B, N, H, D, st.vb, st.vn, st.vh, cols, 64, sw, &pv)
      || !hopper::encode_bnhd_map(&to, o, B, N, H, D, st.ob, st.on, st.oh, cols, 64, sw, &po))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(short_fwd_wgmma_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)T::kSmemBytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int BH = B * H;
  short_fwd_wgmma_kernel<HD><<<BH < sms ? BH : sms, kWgThreads, T::kSmemBytes, s>>>(
      tq, tk, tv, to, BH, H, N, scale * kLog2e, pq, pk, pv, po);
  return cudaGetLastError();
}

template <int HD, int NB, int TW>
cudaError_t launch_bwd_wgmma_nb(const CUtensorMap (&m)[4], const int (&pos)[4], void* dq,
                                void* dk, void* dv, int grid, int BH, int H, int N, int D,
                                const BwdStrides& st, float scale, cudaStream_t s) {
  using Gm = BwdGeom<HD>;
  cudaError_t err = cudaFuncSetAttribute(short_bwd_wgmma_kernel<HD, NB, TW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Gm::kSmemBytes);
  if (err != cudaSuccess) return err;
  short_bwd_wgmma_kernel<HD, NB, TW><<<grid, kBwdThreads, Gm::kSmemBytes, s>>>(
      m[0], m[1], m[2], m[3], static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), BH, H, N, D, st, scale, pos[0], pos[1], pos[2], pos[3]);
  return cudaGetLastError();
}

// Kernel 7's wgmma design at HD <= 64: the four tensor maps (q, k, v, g in
// 64-row boxes), then the instance of the pair's key chunks, the last one
// kBwdTailKeys wide when its valid keys fit.
template <int HD>
cudaError_t launch_bwd_wgmma(const void* q, const void* k, const void* v, const void* g,
                             void* dq, void* dk, void* dv, int B, int H, int N, int D,
                             const BwdStrides& st, float scale, cudaStream_t s) {
  const CUtensorMapSwizzle sw = HD == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap m[4];
  int pos[4];
  const void* ptrs[4] = {q, k, v, g};
  const long long strides[4][3] = {{st.qb, st.qn, st.qh}, {st.kb, st.kn, st.kh},
                                   {st.vb, st.vn, st.vh}, {st.gb, st.gn, st.gh}};
  for (int i = 0; i < 4; ++i)
    if (!hopper::encode_bnhd_map(&m[i], ptrs[i], B, N, H, D, strides[i][0], strides[i][1],
                                 strides[i][2], wgtile::WgTile<HD>::kPanelCols, 64, sw, &pos[i]))
      return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int BH = B * H, grid = BH < sms ? BH : sms;
  const int nb = (N + 63) / 64;
  const bool narrow = kBwdTailKeys > 0 && N - 64 * (nb - 1) <= kBwdTailKeys;
  constexpr int TW = kBwdTailKeys > 0 ? kBwdTailKeys : 64;
#define SHORT_BWD_NB(NB)                                                                       \
  return narrow ? launch_bwd_wgmma_nb<HD, NB, TW>(m, pos, dq, dk, dv, grid, BH, H, N, D, st,   \
                                                  scale, s)                                    \
                : launch_bwd_wgmma_nb<HD, NB, 64>(m, pos, dq, dk, dv, grid, BH, H, N, D, st,   \
                                                  scale, s)
  if (nb == 4) SHORT_BWD_NB(4);
  if (nb == 3) SHORT_BWD_NB(3);
  SHORT_BWD_NB(2);
#undef SHORT_BWD_NB
}

// The design of a call (the Design codes). bf16: the wgmma designs take
// 64 < N <= 256 when TMA can read every input (every batch, sequence and
// head stride positive; a broadcast stride of 0 cannot be described to it);
// the backward also needs D <= 64 (a pair's q, k, v and g in shared memory)
// and takes the outputs' strides into the rule; mma.sync elsewhere. f32:
// mma.tf32x3 where shortmma::takes it (1 <= N <= 64, D <= 64, every stride
// positive), wgmma.tf32x3 where shorttf::takes it (64 < N <= 256, the same
// D and strides), FMA elsewhere. `mma_only` (the _mma entries) keeps the
// earlier designs, mma.sync and FMA, at every shape.
enum Design { kFma = 0, kMmaSync = 1, kWgmma = 2, kWgmmaTf32 = 3, kMmaTf32 = 4 };

bool strides_positive(const long long* st, int n) {
  for (int i = 0; i < n; ++i)
    if (st[i] <= 0) return false;
  return true;
}

int design_of(int which, int dtype, int N, int D, const long long* st, bool mma_only) {
  const int n = which == 0 ? 12 : 21;
  if (dtype == 1) {
    const bool wg = N > 64 && N <= kWgMaxN && (which == 0 || D <= 64) && strides_positive(st, n);
    return !mma_only && wg ? kWgmma : kMmaSync;
  }
  if (mma_only) return kFma;
  if (shortmma::takes(dtype, N, D, st, n)) return kMmaTf32;
  return shorttf::takes(dtype, N, D, st, n) ? kWgmmaTf32 : kFma;
}

// The design of the last launch of kernel 6 ([0]) and kernel 7 ([1]) through
// any entry; -1 before the first. Read through short_attention_last_design.
int g_last_design[2] = {-1, -1};

template <int HD>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, int design, int B,
                       int H, int N, int D, const FwdStrides& st, float scale, cudaStream_t s) {
  const int BH = B * H;
  if (design == kWgmma) return launch_fwd_wgmma<HD>(q, k, v, o, B, H, N, D, st, scale, s);
  if (design == kMmaSync) {
    const int w = warps_for(N);
    if (w == 1) return launch_fwd_bf16<HD, 1>(q, k, v, o, BH, H, N, D, st, scale, s);
    if (w == 2) return launch_fwd_bf16<HD, 2>(q, k, v, o, BH, H, N, D, st, scale, s);
    return launch_fwd_bf16<HD, 4>(q, k, v, o, BH, H, N, D, st, scale, s);
  }
  constexpr int kRows = kF32Threads / (HD / 32);
  dim3 grid(BH, (N + kRows - 1) / kRows);
  short_fwd_f32_kernel<HD><<<grid, kF32Threads, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), H, N, D, st, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* g, void* dq,
                       void* dk, void* dv, int design, int B, int H, int N, int D,
                       const BwdStrides& st, float scale, cudaStream_t s) {
  const int BH = B * H;
  if constexpr (HD <= 64)
    if (design == kWgmma)
      return launch_bwd_wgmma<HD>(q, k, v, g, dq, dk, dv, B, H, N, D, st, scale, s);
  if (design == kMmaSync) {
    const int w = warps_for(N);
    if (w == 1) return launch_bwd_bf16<HD, 1>(q, k, v, g, dq, dk, dv, BH, H, N, D, st, scale, s);
    if (w == 2) return launch_bwd_bf16<HD, 2>(q, k, v, g, dq, dk, dv, BH, H, N, D, st, scale, s);
    return launch_bwd_bf16<HD, 4>(q, k, v, g, dq, dk, dv, BH, H, N, D, st, scale, s);
  }
  short_bwd_f32_kernel<HD><<<BH, kF32Threads, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(g), static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), H, N, D, st, scale);
  return cudaGetLastError();
}

bool bad_args(int dtype, int B, int H, int N, int D) {
  return (dtype != 0 && dtype != 1) || B < 1 || H < 1 || N < 1 || N > kMaxN || D <= 0
         || D > 128 || D % 8 != 0 || (long long)B * H > 0x7fffffffLL;
}

int fwd(const void* q, const void* k, const void* v, void* o, int dtype, int B, int N, int H,
        int D, const long long* st, float scale, bool mma_only, void* stream) {
  if (bad_args(dtype, B, H, N, D)) return (int)cudaErrorInvalidValue;
  FwdStrides s;
  std::memcpy(&s, st, sizeof(s));
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int design = design_of(0, dtype, N, D, st, mma_only);
  g_last_design[0] = design;
  if (design == kWgmmaTf32) return (int)shorttf::fwd(q, k, v, o, B, H, N, D, st, scale, cs);
  if (design == kMmaTf32) return (int)shortmma::fwd(q, k, v, o, B, H, N, D, st, scale, cs);
  if (D <= 32) return (int)launch_fwd<32>(q, k, v, o, design, B, H, N, D, s, scale, cs);
  if (D <= 64) return (int)launch_fwd<64>(q, k, v, o, design, B, H, N, D, s, scale, cs);
  return (int)launch_fwd<128>(q, k, v, o, design, B, H, N, D, s, scale, cs);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v, o are (B, N, H, D) with N < 512;
// `st` holds 12 strides in elements (batch, sequence, head of q, k, v, o).
// The head-dim stride must be 1, D a multiple of 8 (<= 128), every stride a
// multiple of 8 and every pointer 16-byte aligned (the Python wrapper
// guarantees all of it). bf16 at 64 < N <= 256 runs the wgmma design, other
// bf16 calls the mma.sync one; f32 with D <= 64 and every stride positive
// the mma.tf32x3 one at N <= 64 (short_attention_tf32_mma.cu) and the
// wgmma.tf32x3 one at 64 < N <= 256 (short_attention_tf32.cu), other f32
// calls the FMA kernel. Returns the cudaError_t of the launch (0 = success).
extern "C" int short_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int N, int H, int D, const long long* st,
                                   float scale, void* stream) {
  return fwd(q, k, v, o, dtype, B, N, H, D, st, scale, false, stream);
}

// As short_attention_fwd, with the earlier designs at every N: mma.sync in
// bf16, FMA in f32 (kept to time the wgmma designs against).
extern "C" int short_attention_fwd_mma(const void* q, const void* k, const void* v, void* o,
                                       int dtype, int B, int N, int H, int D,
                                       const long long* st, float scale, void* stream) {
  return fwd(q, k, v, o, dtype, B, N, H, D, st, scale, true, stream);
}

namespace {

int bwd(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk, void* dv,
        float* scratch, int dtype, int B, int N, int H, int D, const long long* st, float scale,
        bool mma_only, void* stream) {
  if (bad_args(dtype, B, H, N, D)) return (int)cudaErrorInvalidValue;
  BwdStrides s;
  std::memcpy(&s, st, sizeof(s));
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int design = design_of(1, dtype, N, D, st, mma_only);
  g_last_design[1] = design;
  if (design == kWgmmaTf32)
    return (int)shorttf::bwd(q, k, v, g, dq, dk, dv, scratch, B, H, N, D, st, scale, cs);
  if (design == kMmaTf32)
    return (int)shortmma::bwd(q, k, v, g, dq, dk, dv, B, H, N, D, st, scale, cs);
  if (D <= 32)
    return (int)launch_bwd<32>(q, k, v, g, dq, dk, dv, design, B, H, N, D, s, scale, cs);
  if (D <= 64)
    return (int)launch_bwd<64>(q, k, v, g, dq, dk, dv, design, B, H, N, D, s, scale, cs);
  return (int)launch_bwd<128>(q, k, v, g, dq, dk, dv, design, B, H, N, D, s, scale, cs);
}

}  // namespace

// As short_attention_fwd, for the gradient: g (the output's gradient, in the
// input dtype) in, dq, dk, dv out, all (B, N, H, D); `st` holds 21 strides:
// q, k, v, g, dq, dk, dv (batch, sequence, head each). `scratch` holds
// short_attention_scratch_floats(...) floats (null when that is 0: the
// wgmma.tf32x3 design's row statistics). bf16 at 64 < N <= 256 and D <= 64
// with every stride positive runs the wgmma design, other bf16 calls the
// mma.sync one; f32 the mma.tf32x3 design at N <= 64 and the wgmma.tf32x3
// one at 64 < N <= 256 (D <= 64, every stride positive), the FMA kernel
// elsewhere.
extern "C" int short_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                                   void* dq, void* dk, void* dv, float* scratch, int dtype, int B,
                                   int N, int H, int D, const long long* st, float scale,
                                   void* stream) {
  return bwd(q, k, v, g, dq, dk, dv, scratch, dtype, B, N, H, D, st, scale, false, stream);
}

// As short_attention_bwd, with the earlier designs at every shape: mma.sync
// in bf16, FMA in f32 (kept to time the wgmma designs against).
extern "C" int short_attention_bwd_mma(const void* q, const void* k, const void* v,
                                       const void* g, void* dq, void* dk, void* dv,
                                       float* scratch, int dtype, int B, int N, int H, int D,
                                       const long long* st, float scale, void* stream) {
  return bwd(q, k, v, g, dq, dk, dv, scratch, dtype, B, N, H, D, st, scale, true, stream);
}

// The design (0 = FMA, 1 = mma.sync, 2 = wgmma, 3 = wgmma.tf32x3, 4 =
// mma.tf32x3) of the last launch of kernel 6 (which = 0) or kernel 7
// (which = 1) through any entry above; -1 before the first.
extern "C" int short_attention_last_design(int which) {
  return which == 0 || which == 1 ? g_last_design[which] : -1;
}

// The design the entry of kernel 6 (which = 0) or 7 (1) runs for a call in
// `dtype` at (N, D) (D padded to a multiple of 8) with the launch's 12 or 21
// strides `st`; `mma_only` for the _mma entries. -1 for a call the entries
// refuse.
extern "C" int short_attention_design(int which, int dtype, int N, int D, const long long* st,
                                      int mma_only) {
  if ((which != 0 && which != 1) || bad_args(dtype, 1, 1, N, D)) return -1;
  return design_of(which, dtype, N, D, st, mma_only != 0);
}

// Floats of scratch a call of kernel 7's entries needs (the wgmma.tf32x3
// design's row statistics), 0 when its design takes none; -1 for a call
// they refuse. Arguments as short_attention_bwd's.
extern "C" long long short_attention_scratch_floats(int dtype, int B, int N, int H, int D,
                                                    const long long* st, int mma_only) {
  if (bad_args(dtype, B, H, N, D)) return -1;
  return design_of(1, dtype, N, D, st, mma_only != 0) == kWgmmaTf32
             ? (long long)shorttf::bwd_scratch_floats(B, H)
             : 0;
}
