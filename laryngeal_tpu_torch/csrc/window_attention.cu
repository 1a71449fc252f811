// Swin3D shifted-window attention for Hopper (sm_90a), forward and backward,
// bound through a plain C interface (ctypes; see
// laryngeal_tpu_torch/ops/window_attention.py).
//
// Replaces the Pallas TPU kernels of laryngeal_tpu/ops/window_attention.py
// and the two ablation variants of scripts/bench_window_kernel.py:
//   * kernel 8, _fwd_kernel (entry window_attention_fwd, mode 0, one head a
//     block): per (window, head) S = (Q K^T, f32) * scale + bias[h], -100
//     added where the two positions' region ids differ, an exact f32 softmax
//     (row max subtracted, exp, normalised BEFORE P V), P rounded to v's
//     dtype, P V accumulated in f32, cast to q's dtype;
//   * kernel 11, _fwd_kernel_sm (the same entry, mode 1: (S - max) rounded
//     to bf16 before exp; mode 2: exp2 of (S - max) * log2(e));
//   * kernel 12, _fwd_kernel_h2 (the same entry, 2 or 3 heads a block);
//   * kernel 9, _bwd_kernel (entry window_attention_bwd): P recomputed,
//     delta = sum_k P dP from the f32 P and dP, ds = P (dP - delta) in f32;
//     dQ = (bf16(ds) K) * scale and dK = (bf16(ds)^T Q) * scale (ds is
//     rounded BEFORE the scale, unlike kernel 7), dV = bf16(P)^T G, and
//     dbias[h] = the unrounded f32 ds summed over all B * nW windows.
// q, k, v (and G, dQ, dK, dV) are read through their (window, position,
// head) strides, so views of a fused (B nW, N, 3, H, D) qkv need no copy.
// The region-id mask is rebuilt in the kernel from the window's N ids
// (window w uses row w % nW); the bias is read as f32 and never rounded.
//
// What bounds it on the H100: at Swin3D-T 32f 224^2 B=8 every stage calls
// N = 392, D = 32; at stage 1 (1024 windows, 3 heads) the forward moves
// q, k, v, o = 4 x 77 MB against 60 GFLOP (bf16), 0.093 ms at 3.35 TB/s:
// bound by bytes (N / 2 = 196 FLOP per byte). The backward moves seven such
// tensors, ~0.16 ms. The traffic to watch is the bias: a block that owns one
// (window, head) and reads its 64 query rows of the (N, N) f32 bias per
// element re-reads 100 KB per pass, ~4.3 GB through L2 per stage-1 call
// (this file's first version did, at 3% of its bound). The design:
//   * forward (kernels 8 and 11): one block per (head, 64-query tile,
//     window group) copies the tile's 64 x N f32 bias rows into shared
//     memory once (100 KB at N = 392) and walks the group's windows with
//     several slots of 4 warps (4 / 2 / 1 slots at D = 32 / 64 / 128), each
//     slot on its own windows, tiles and named barrier. Per window, kernel
//     6's structure: two passes over 64-key K/V tiles streamed with
//     cp.async, double-buffered, mma.sync m16n8k16 bf16 with f32
//     accumulators (D = 32 is two k-steps), the row max and sum in the
//     first pass, the normalised P rounded and multiplied by V in the
//     second. The groups are sized so that the blocks fill the card once.
//   * kernel 12 gives a block 2 or 3 heads of one window, each on its own 4
//     warps and tiles, the region ids loaded once. Several heads' bias rows
//     do not fit beside the tiles, so it reads the bias per element (L2).
//   * backward (kernel 9), four launches: (a) statistics and dQ, blocked as
//     the forward (held bias rows, slots): a pass for each row's max, sum
//     and delta, stored to a scratch buffer, a pass for ds and dQ; (b) dK
//     and dV, one block per (head, 64-key tile, window group) holding the
//     bias columns of its keys (N x 64 f32), keys as rows: S^T = K Q^T and
//     dP^T = V G^T with P rebuilt from the statistics (kernel 7's phase 2);
//     (c) dbias, one block per (64-query tile, 64-key tile, head, window
//     group) keeping its tile of the sum over windows of the f32 ds in
//     registers (and its bias tile too), recomputing S and dP per window;
//     (d) when there is more than one group, a reduction that sums the
//     groups' (H, N, N) partials in group order. No atomics: deterministic.
//   * f32: the FMA units, TF32 off, 1-4 threads per row each owning a
//     32-wide slice of the head dim, the bias read per element; the
//     backward's dQ launch accumulates its rows of dbias in shared memory
//     over its window group.
// Those designs hold N <= 448 (kMaxN: the held bias rows, the fixed
// region-id and statistics arrays) and D <= 128. The JAX package runs its
// Pallas kernel at every N % 8 == 0 and D <= 256, so every other shape runs
// the wide path, in f32 or bf16: the f32 kernels' structure on the FMA
// units (1-8 threads per row, a 32-wide head-dim slice each, up to D = 256)
// with the bias, the region ids and the row statistics read from device
// memory (L2) instead of fixed shared arrays, bf16 inputs widened to f32 as
// they land in shared memory, and P and ds rounded to bf16 where kernels
// 8-9 round them (P before P V and dV, ds before dQ and dK; dbias sums the
// unrounded ds, in the dQ launch's shared rows: 64, or fewer at a large N).
// Deterministic, as the held designs. No in-tree model reaches it; it is
// correct, not fast. window_attention_last_design reports which design the
// last call of each kernel ran.
// Not yet done (later work): wgmma/TMA, a persistent schedule, S kept in
// registers across the passes, the wide path on the tensor cores.

#include <algorithm>
#include <cstring>

#include "flash_attention_common.cuh"

namespace {

using namespace flash;
using bf16 = __nv_bfloat16;

constexpr int kMaxN = 448;           // 7 key tiles of 64; Swin3D's window is 392
constexpr float kRegionMask = -100.f;  // torchvision's shifted-window mask
constexpr int kBM = 64;              // rows of a bf16 block (4 warps x 16)
constexpr int kBN = 64;              // keys of a streamed tile
constexpr int kT = 128;              // threads of one head's 4 warps
constexpr int kMaxSmem = 232448;     // bytes a block can use on sm_90

struct FwdStrides {
  long long qb, qn, qh, kb, kn, kh, vb, vn, vh, ob, on, oh;
};
struct BwdStrides {
  long long qb, qn, qh, kb, kn, kh, vb, vn, vh, gb, gn, gh;
  long long dqb, dqn, dqh, dkb, dkn, dkh, dvb, dvn, dvh;
};

// Copy rows [row0, row0 + ROWS) x [0, HD) of one (window, head) slice into a
// padded shared tile with kT threads (thread index tid); rows >= n_rows and
// columns >= d are zero-filled.
template <int ROWS, int HD>
__device__ __forceinline__ void load_rows(bf16* tile, const bf16* base, long long row_stride,
                                          int row0, int n_rows, int d, int tid) {
  constexpr int kChunksPerRow = HD / 8;
  for (int c = tid; c < ROWS * kChunksPerRow; c += kT) {
    const int r = c / kChunksPerRow;
    const int col = (c % kChunksPerRow) * 8;
    const int row = row0 + r;
    const bool ok = row < n_rows && col < d;
    cp_async16(tile + r * (HD + kPad) + col, ok ? base + row * row_stride + col : base,
               ok ? 16 : 0);
  }
}

// One window logit, in the JAX kernel's order: (dot * scale) + bias, then
// + (-100) across region boundaries; no contraction into an FMA.
__device__ __forceinline__ float logit(float dot, float scale, float b, bool differ) {
  const float x = __fadd_rn(__fmul_rn(dot, scale), b);
  return differ ? __fadd_rn(x, kRegionMask) : x;
}

// The query rows g and g + 8 of a warp's 16 (row0 = its first): whether
// each is inside the window, its bias row and its region id. `bias_rows`
// holds the bias rows from `bias_row0` on, N floats each (device memory or
// a block's copy in shared memory).
struct QueryRows {
  bool ok[2];
  const float* bias[2];
  int id[2];
};

__device__ __forceinline__ QueryRows query_rows(int row0, const float* bias_rows, int bias_row0,
                                                const int* ids, int N) {
  const int g = (threadIdx.x % 32) / 4;
  QueryRows r;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    r.ok[i] = row < N;
    r.bias[i] = bias_rows + (long long)((r.ok[i] ? row : bias_row0) - bias_row0) * N;
    r.id[i] = (ids && r.ok[i]) ? ids[row] : 0;
  }
  return r;
}

// Raw Q K^T accumulators of key columns [key0, key0 + COLS) -> logits; keys
// >= N get kMaskValue (no probability), padding rows a zero bias.
template <int COLS>
__device__ __forceinline__ void to_logits(float (&s)[COLS / 8][4], const QueryRows& rows,
                                          int key0, const int* ids, int N, float scale) {
  const int tig = threadIdx.x % 4;
#pragma unroll
  for (int nt = 0; nt < COLS / 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = j >> 1;
      const int key = key0 + nt * 8 + tig * 2 + (j & 1);
      if (key < N) {
        const float b = rows.ok[r] ? rows.bias[r][key] : 0.f;
        s[nt][j] = logit(s[nt][j], scale, b, ids && ids[key] != rows.id[r]);
      } else {
        s[nt][j] = kMaskValue;
      }
    }
}

// exp of z = S - max in a softmax mode: 0 exp, 1 exp(bf16(z)), 2 exp2.
template <int MODE>
__device__ __forceinline__ float softmax_exp(float z) {
  if (MODE == 1) return expf(__bfloat162float(__float2bfloat16_rn(z)));
  if (MODE == 2) return exp2f(z * kLog2e);
  return expf(z);
}

// Store rows g and g + 8 of this warp's 16 (row0 = its first) of a 16 x HD
// f32 accumulator times `mul` as bf16; rows >= N and columns >= D are not
// written.
template <int HD>
__device__ __forceinline__ void store_rows(bf16* base, long long row_stride,
                                           const float (&acc)[HD / 8][4], int row0, int N,
                                           int D, float mul) {
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
            __floats2bfloat162_rn(acc[dt][2 * r] * mul, acc[dt][2 * r + 1] * mul);
    }
  }
}

// Copy the region ids of window w (row w % nW of rid) to shared memory with
// `threads` threads from index `tid`; returns the copy, or null for an
// unshifted block (no rid). The caller synchronises before reading it.
__device__ __forceinline__ const int* load_ids(int* ids_s, const int* rid, int w, int nW, int N,
                                               int tid, int threads) {
  if (!rid) return nullptr;
  const int* row = rid + (long long)(w % nW) * N;
  for (int i = tid; i < N; i += threads) ids_s[i] = row[i];
  return ids_s;
}

// The barrier of one slot's 4 warps (named barrier 1 + slot; 0 is
// __syncthreads').
struct SlotSync {
  int id;
  __device__ __forceinline__ void operator()() const {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(kT) : "memory");
  }
};

// Copy `n_rows` x `cols` floats from a row-major source with row stride
// `src_ld` to a dense shared array, with all the block's threads.
__device__ __forceinline__ void load_bias_block(float* dst, const float* src, long long src_ld,
                                                int n_rows, int cols) {
  for (int i = threadIdx.x; i < n_rows * cols; i += blockDim.x)
    dst[i] = src[(long long)(i / cols) * src_ld + i % cols];
}

// Window groups of a held-bias launch: `tiles` blocks a group, one block
// resident per SM, each slot walking ceil(per_group / slots) windows. Picks
// the group count that minimises (waves of blocks) x (windows a slot walks
// + 1, the bias copy), the wave count taken over the card's SMs.
inline int held_groups(int BW, int tiles, int slots) {
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int most = (BW + slots - 1) / slots;
  int best = 1;
  long long best_cost = -1;
  for (int groups = 1; groups <= most && groups <= 256; ++groups) {
    const int per_group = (BW + groups - 1) / groups;
    const long long blocks = (long long)tiles * ((BW + per_group - 1) / per_group);
    const long long cost = (blocks + sms - 1) / sms * ((per_group + slots - 1) / slots + 1);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = groups;
    }
  }
  return best;
}

// ---------------------------------------------------------------------------
// bf16 forward (kernels 8, 11, 12)
// ---------------------------------------------------------------------------

template <int HD>
__host__ __device__ constexpr int fwd_slot_elems() { return (kBM + 4 * kBN) * (HD + kPad); }
// Slots (4 warps each) of a held-bias forward block: 64 query rows of bias
// (100 KB at N = 392) leave room for 4, 2 or 1 slots by head dim.
template <int HD>
__host__ __device__ constexpr int fwd_max_slots() { return HD == 32 ? 4 : (HD == 64 ? 2 : 1); }

// Bytes of N ints (or floats) rounded up to 16.
__host__ __device__ __forceinline__ size_t ids_bytes(int N) { return (size_t)(N + 3) / 4 * 16; }

// One head of one window: the 64 query rows from q0, two passes (three for
// mode 1) over 64-key K (and V) tiles streamed through the slot's shared
// tiles, O = P V with P normalised and rounded to bf16. `sync` is the
// barrier of the 4 warps that share the tiles. When it returns, the tiles
// and the ids are no longer read.
template <int HD, int MODE, typename Sync>
__device__ __forceinline__ void attend_window(bf16* q_s, bf16* k_s, bf16* v_s, const bf16* qb,
                                              const bf16* kb, const bf16* vb, bf16* ob,
                                              const FwdStrides& st, const QueryRows& rows,
                                              const int* ids, int q0, int N, int D, float scale,
                                              int tid, Sync sync) {
  constexpr int kLd = HD + kPad;
  const int warp = tid / 32;
  const int n_tiles = (N + kBN - 1) / kBN;
  load_rows<kBM, HD>(q_s, qb, st.qn, q0, N, D, tid);
  load_rows<kBN, HD>(k_s, kb, st.kn, 0, N, D, tid);
  cp_async_commit();

  uint32_t qa[HD / 16][4];
  float m_row[2] = {kMaskValue, kMaskValue};
  float l_row[2] = {0.f, 0.f};

  // Pass 1: the row max (and, but for mode 1, the row sum, online).
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t % 2;
    if (t + 1 < n_tiles) {
      load_rows<kBN, HD>(k_s + (buf ^ 1) * kBN * kLd, kb, st.kn, (t + 1) * kBN, N, D, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    sync();
    if (t == 0) {
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) load_a_frag<HD>(qa[ks], q_s, warp * 16, ks);
    }
    float s[kBN / 8][4];
    product_abt_regs<HD, kBN>(s, qa, k_s + buf * kBN * kLd);
    to_logits<kBN>(s, rows, t * kBN, ids, N, scale);
    float mx[2] = {m_row[0], m_row[1]};
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) mx[j >> 1] = fmaxf(mx[j >> 1], s[nt][j]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      if (MODE != 1) l_row[r] *= softmax_exp<MODE>(m_row[r] - mx[r]);
      m_row[r] = mx[r];
    }
    if (MODE != 1) {
#pragma unroll
      for (int nt = 0; nt < kBN / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) l_row[j >> 1] += softmax_exp<MODE>(s[nt][j] - m_row[j >> 1]);
    }
    sync();  // the next copy overwrites this buffer
  }

  // Mode 1 rounds S - max with the final max, so its sum takes a pass of its own.
  if (MODE == 1) {
    load_rows<kBN, HD>(k_s, kb, st.kn, 0, N, D, tid);
    cp_async_commit();
    for (int t = 0; t < n_tiles; ++t) {
      const int buf = t % 2;
      if (t + 1 < n_tiles) {
        load_rows<kBN, HD>(k_s + (buf ^ 1) * kBN * kLd, kb, st.kn, (t + 1) * kBN, N, D, tid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      sync();
      float s[kBN / 8][4];
      product_abt_regs<HD, kBN>(s, qa, k_s + buf * kBN * kLd);
      to_logits<kBN>(s, rows, t * kBN, ids, N, scale);
#pragma unroll
      for (int nt = 0; nt < kBN / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) l_row[j >> 1] += softmax_exp<1>(s[nt][j] - m_row[j >> 1]);
      sync();
    }
  }
  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv_l[r] = 1.f / quad_sum(l_row[r]);

  // Pass 2: P = exp(S - m) / l, rounded to bf16, O = P V.
  load_rows<kBN, HD>(k_s, kb, st.kn, 0, N, D, tid);
  load_rows<kBN, HD>(v_s, vb, st.vn, 0, N, D, tid);
  cp_async_commit();
  float acc[HD / 8][4];
  zero(acc);
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t % 2;
    if (t + 1 < n_tiles) {
      load_rows<kBN, HD>(k_s + (buf ^ 1) * kBN * kLd, kb, st.kn, (t + 1) * kBN, N, D, tid);
      load_rows<kBN, HD>(v_s + (buf ^ 1) * kBN * kLd, vb, st.vn, (t + 1) * kBN, N, D, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    sync();
    float s[kBN / 8][4];
    product_abt_regs<HD, kBN>(s, qa, k_s + buf * kBN * kLd);
    to_logits<kBN>(s, rows, t * kBN, ids, N, scale);
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[nt][j] = softmax_exp<MODE>(s[nt][j] - m_row[j >> 1]) * inv_l[j >> 1];
    product_pv<HD, kBN>(acc, s, v_s + buf * kBN * kLd);
    sync();
  }
  store_rows<HD>(ob, st.on, acc, q0 + warp * 16, N, D, 1.f);
}

// Kernels 8 and 11: one block per (head, 64-query tile, window group) holds
// the tile's 64 x N f32 bias rows in shared memory, read from device memory
// once; its slots of 4 warps (blockDim.x / 128) walk the group's windows,
// slot s taking windows s, s + slots, ... of the group.
template <int HD, int MODE>
__global__ void __launch_bounds__(fwd_max_slots<HD>() * kT, 1)
window_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       const float* __restrict__ bias, const int* __restrict__ rid, int BW,
                       int H, int N, int D, int nW, int per_group, FwdStrides st, float scale) {
  constexpr int kLd = HD + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int slots = blockDim.x / kT, slot = threadIdx.x / kT, tid = threadIdx.x % kT;
  const int warp = tid / 32;
  const int h = blockIdx.x, q0 = blockIdx.y * kBM, grp = blockIdx.z;
  float* bias_s = reinterpret_cast<float*>(smem_raw);
  unsigned char* slot_base = smem_raw + (size_t)kBM * N * sizeof(float)
                             + slot * (fwd_slot_elems<HD>() * sizeof(bf16) + ids_bytes(N));
  bf16* q_s = reinterpret_cast<bf16*>(slot_base);
  bf16* k_s = q_s + kBM * kLd;
  bf16* v_s = k_s + 2 * kBN * kLd;
  int* ids_s = reinterpret_cast<int*>(slot_base + fwd_slot_elems<HD>() * sizeof(bf16));

  load_bias_block(bias_s, bias + ((long long)h * N + q0) * N, N, min(kBM, N - q0), N);
  __syncthreads();
  const SlotSync sync{1 + slot};
  const int w_end = min(BW, (grp + 1) * per_group);
  for (int w = grp * per_group + slot; w < w_end; w += slots) {
    const int* ids = load_ids(ids_s, rid, w, nW, N, tid, kT);
    sync();  // the ids
    const QueryRows rows = query_rows(q0 + warp * 16, bias_s, q0, ids, N);
    attend_window<HD, MODE>(q_s, k_s, v_s, q + w * st.qb + h * st.qh, k + w * st.kb + h * st.kh,
                            v + w * st.vb + h * st.vh, o + w * st.ob + h * st.oh, st, rows, ids,
                            q0, N, D, scale, tid, sync);
  }
}

// Kernel 12: one block per (window, HB heads, 64-query tile), each head on
// its own 4 warps and tiles; the window's region ids are loaded once. The
// bias rows of HB heads do not fit shared memory beside the tiles, so they
// are read per element from device memory (L2).
template <int HD, int HB>
__global__ void __launch_bounds__(HB * kT)
window_fwd_heads_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, bf16* __restrict__ o,
                             const float* __restrict__ bias, const int* __restrict__ rid, int H,
                             int N, int D, int nW, FwdStrides st, float scale) {
  constexpr int kLd = HD + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int slot = threadIdx.x / kT, tid = threadIdx.x % kT, warp = tid / 32;
  int* ids_s = reinterpret_cast<int*>(smem_raw);
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw + ids_bytes(N)) + slot * fwd_slot_elems<HD>();
  bf16* k_s = q_s + kBM * kLd;
  bf16* v_s = k_s + 2 * kBN * kLd;
  const int w = blockIdx.x, h = blockIdx.y * HB + slot, q0 = blockIdx.z * kBM;
  const int* ids = load_ids(ids_s, rid, w, nW, N, threadIdx.x, blockDim.x);
  __syncthreads();  // the region ids
  const QueryRows rows = query_rows(q0 + warp * 16, bias + (long long)h * N * N, 0, ids, N);
  attend_window<HD, 0>(q_s, k_s, v_s, q + w * st.qb + h * st.qh, k + w * st.kb + h * st.kh,
                       v + w * st.vb + h * st.vh, o + w * st.ob + h * st.oh, st, rows, ids, q0,
                       N, D, scale, tid, SlotSync{1 + slot});
}

// ---------------------------------------------------------------------------
// bf16 backward (kernel 9): (a) statistics and dQ, (b) dK and dV, (c) dbias
// partials per window group, (d) the groups' sum
// ---------------------------------------------------------------------------

// Row statistics of window w, head h: stats[((w * H + h) * 3 + c) * N + row],
// c = 0 the row max, 1 the inverse row sum, 2 delta.
__device__ __forceinline__ float* stats_at(float* stats, int w, int h, int H, int N) {
  return stats + ((long long)w * H + h) * 3 * N;
}

template <int HD>
__host__ __device__ constexpr int dq_slot_elems() { return (2 * kBM + 4 * kBN) * (HD + kPad); }
template <int HD>
__host__ __device__ constexpr int dq_max_slots() { return HD == 32 ? 3 : (HD == 64 ? 2 : 1); }

// (a) One block per (head, 64-query tile, window group) holds the tile's
// bias rows in shared memory; each slot of 4 warps walks its windows: a
// pass over the key tiles for each row's max, sum and delta (an online sum
// of exp(S - m) dP, divided by the sum), stored for (b) and (c), then a
// pass for ds = P (dP - delta) and dQ = (bf16(ds) K) * scale.
template <int HD>
__global__ void __launch_bounds__(dq_max_slots<HD>() * kT, 1)
window_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ gr,
                          const float* __restrict__ bias, const int* __restrict__ rid,
                          bf16* __restrict__ dq, float* __restrict__ stats, int BW, int H, int N,
                          int D, int nW, int per_group, BwdStrides st, float scale) {
  constexpr int kLd = HD + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int slots = blockDim.x / kT, slot = threadIdx.x / kT, tid = threadIdx.x % kT;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, tig = lane % 4;
  const int h = blockIdx.x, q0 = blockIdx.y * kBM, grp = blockIdx.z;
  float* bias_s = reinterpret_cast<float*>(smem_raw);
  unsigned char* slot_base = smem_raw + (size_t)kBM * N * sizeof(float)
                             + slot * (dq_slot_elems<HD>() * sizeof(bf16) + ids_bytes(N));
  bf16* q_s = reinterpret_cast<bf16*>(slot_base);  // Q rows
  bf16* g_s = q_s + kBM * kLd;                      // G rows
  bf16* k_s = g_s + kBM * kLd;                      // K tiles
  bf16* v_s = k_s + 2 * kBN * kLd;                  // V tiles
  int* ids_s = reinterpret_cast<int*>(slot_base + dq_slot_elems<HD>() * sizeof(bf16));
  const int n_tiles = (N + kBN - 1) / kBN;

  load_bias_block(bias_s, bias + ((long long)h * N + q0) * N, N, min(kBM, N - q0), N);
  __syncthreads();
  const SlotSync sync{1 + slot};
  const int w_end = min(BW, (grp + 1) * per_group);
  for (int w = grp * per_group + slot; w < w_end; w += slots) {
    const int* ids = load_ids(ids_s, rid, w, nW, N, tid, kT);
    const bf16* qb = q + w * st.qb + h * st.qh;
    const bf16* kb = k + w * st.kb + h * st.kh;
    const bf16* vb = v + w * st.vb + h * st.vh;
    const bf16* gb = gr + w * st.gb + h * st.gh;
    load_rows<kBM, HD>(q_s, qb, st.qn, q0, N, D, tid);
    load_rows<kBM, HD>(g_s, gb, st.gn, q0, N, D, tid);
    load_rows<kBN, HD>(k_s, kb, st.kn, 0, N, D, tid);
    load_rows<kBN, HD>(v_s, vb, st.vn, 0, N, D, tid);
    cp_async_commit();
    sync();  // the region ids
    const QueryRows rows = query_rows(q0 + warp * 16, bias_s, q0, ids, N);

    // Pass 1: row max, sum and the sum of exp(S - m) dP (delta), online.
    float m_row[2] = {kMaskValue, kMaskValue};
    float l_row[2] = {0.f, 0.f};
    float dd_row[2] = {0.f, 0.f};
    for (int t = 0; t < n_tiles; ++t) {
      const int buf = t % 2;
      if (t + 1 < n_tiles) {
        load_rows<kBN, HD>(k_s + (buf ^ 1) * kBN * kLd, kb, st.kn, (t + 1) * kBN, N, D, tid);
        load_rows<kBN, HD>(v_s + (buf ^ 1) * kBN * kLd, vb, st.vn, (t + 1) * kBN, N, D, tid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      sync();
      float s[kBN / 8][4], dp[kBN / 8][4];
      product_abt<HD, kBN>(s, q_s, warp * 16, k_s + buf * kBN * kLd);
      product_abt<HD, kBN>(dp, g_s, warp * 16, v_s + buf * kBN * kLd);
      to_logits<kBN>(s, rows, t * kBN, ids, N, scale);
      float mx[2] = {m_row[0], m_row[1]};
#pragma unroll
      for (int nt = 0; nt < kBN / 8; ++nt)
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
      for (int nt = 0; nt < kBN / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float e = expf(s[nt][j] - m_row[j >> 1]);
          l_row[j >> 1] += e;
          dd_row[j >> 1] += e * dp[nt][j];
        }
      sync();
    }
    float il[2], dl[2];
    float* stw = stats_at(stats, w, h, H, N);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      il[r] = 1.f / quad_sum(l_row[r]);
      dl[r] = quad_sum(dd_row[r]) * il[r];
      const int row = q0 + warp * 16 + g + r * 8;
      if (tig == 0 && row < N) {
        stw[row] = m_row[r];
        stw[N + row] = il[r];
        stw[2 * N + row] = dl[r];
      }
    }

    // Pass 2: ds = P (dP - delta); dQ += bf16(ds) K.
    load_rows<kBN, HD>(k_s, kb, st.kn, 0, N, D, tid);
    load_rows<kBN, HD>(v_s, vb, st.vn, 0, N, D, tid);
    cp_async_commit();
    float acc[HD / 8][4];
    zero(acc);
    for (int t = 0; t < n_tiles; ++t) {
      const int buf = t % 2;
      if (t + 1 < n_tiles) {
        load_rows<kBN, HD>(k_s + (buf ^ 1) * kBN * kLd, kb, st.kn, (t + 1) * kBN, N, D, tid);
        load_rows<kBN, HD>(v_s + (buf ^ 1) * kBN * kLd, vb, st.vn, (t + 1) * kBN, N, D, tid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      sync();
      const bf16* kt = k_s + buf * kBN * kLd;
      float s[kBN / 8][4], dp[kBN / 8][4];
      product_abt<HD, kBN>(s, q_s, warp * 16, kt);
      product_abt<HD, kBN>(dp, g_s, warp * 16, v_s + buf * kBN * kLd);
      to_logits<kBN>(s, rows, t * kBN, ids, N, scale);
#pragma unroll
      for (int nt = 0; nt < kBN / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = j >> 1;
          s[nt][j] = expf(s[nt][j] - m_row[r]) * il[r] * (dp[nt][j] - dl[r]);
        }
      product_pv<HD, kBN>(acc, s, kt);
      sync();
    }
    store_rows<HD>(dq + w * st.dqb + h * st.dqh, st.dqn, acc, q0 + warp * 16, N, D, scale);
  }
}

// (b) dK and dV: one block per (head, 64-key tile, window group) holds the
// bias columns of its keys for every query, (N x 64) f32, in shared memory;
// each slot walks its windows with the keys as rows: S^T = K Q^T and
// dP^T = V G^T over the query tiles, P from (a)'s statistics,
// dV += bf16(P)^T G, dK += bf16(ds)^T Q, dK scaled at the end.
template <int HD>
__host__ __device__ constexpr int dkv_bq() { return HD == 128 ? 32 : 64; }
template <int HD>
__host__ __device__ constexpr int dkv_slot_elems() {
  return (2 * kBM + 4 * dkv_bq<HD>()) * (HD + kPad);
}
template <int HD>
__host__ __device__ constexpr int dkv_max_slots() { return HD == 32 ? 3 : (HD == 64 ? 2 : 1); }
__host__ __device__ __forceinline__ size_t dkv_slot_bytes(int hd_elems, int N) {
  return (size_t)hd_elems * sizeof(bf16) + 3 * ids_bytes(N) + ids_bytes(N);
}

template <int HD>
__global__ void __launch_bounds__(dkv_max_slots<HD>() * kT, 1)
window_bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ gr,
                           const float* __restrict__ bias, const int* __restrict__ rid,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           const float* __restrict__ stats, int BW, int H, int N, int D, int nW,
                           int per_group, BwdStrides st, float scale) {
  constexpr int kLd = HD + kPad;
  constexpr int BQ = dkv_bq<HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int slots = blockDim.x / kT, slot = threadIdx.x / kT, tid = threadIdx.x % kT;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, tig = lane % 4;
  const int h = blockIdx.x, k0 = blockIdx.y * kBM, grp = blockIdx.z;
  float* bias_s = reinterpret_cast<float*>(smem_raw);  // bias[h][qi][k0 + kk] at qi * 64 + kk
  unsigned char* slot_base = smem_raw + (size_t)N * kBM * sizeof(float)
                             + slot * dkv_slot_bytes(dkv_slot_elems<HD>(), N);
  bf16* k_s = reinterpret_cast<bf16*>(slot_base);  // K rows (A)
  bf16* v_s = k_s + kBM * kLd;                      // V rows (A)
  bf16* q_s = v_s + kBM * kLd;                      // Q tiles
  bf16* g_s = q_s + 2 * BQ * kLd;                   // G tiles
  float* m_s = reinterpret_cast<float*>(slot_base + dkv_slot_elems<HD>() * sizeof(bf16));
  float* il_s = m_s + ids_bytes(N) / 4;
  float* dl_s = il_s + ids_bytes(N) / 4;
  int* ids_s = reinterpret_cast<int*>(dl_s + ids_bytes(N) / 4);

  // Columns [k0, k0 + 64) of every row (zero beyond N, never read).
  const int n_cols = min(kBM, N - k0);
  const float* src = bias + (long long)h * N * N + k0;
  for (int i = threadIdx.x; i < N * kBM; i += blockDim.x) {
    const int qi = i / kBM, kk = i % kBM;
    bias_s[i] = kk < n_cols ? src[(long long)qi * N + kk] : 0.f;
  }
  __syncthreads();
  const SlotSync sync{1 + slot};
  bool key_ok[2];
  int key[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key[r] = k0 + warp * 16 + g + r * 8;
    key_ok[r] = key[r] < N;
  }
  const int nq_tiles = (N + BQ - 1) / BQ;
  const int w_end = min(BW, (grp + 1) * per_group);
  for (int w = grp * per_group + slot; w < w_end; w += slots) {
    const bf16* qb = q + w * st.qb + h * st.qh;
    const bf16* kb = k + w * st.kb + h * st.kh;
    const bf16* vb = v + w * st.vb + h * st.vh;
    const bf16* gb = gr + w * st.gb + h * st.gh;
    load_rows<kBM, HD>(k_s, kb, st.kn, k0, N, D, tid);
    load_rows<kBM, HD>(v_s, vb, st.vn, k0, N, D, tid);
    load_rows<BQ, HD>(q_s, qb, st.qn, 0, N, D, tid);
    load_rows<BQ, HD>(g_s, gb, st.gn, 0, N, D, tid);
    cp_async_commit();
    const float* stw = stats + ((long long)w * H + h) * 3 * N;
    for (int i = tid; i < N; i += kT) {
      m_s[i] = stw[i];
      il_s[i] = stw[N + i];
      dl_s[i] = stw[2 * N + i];
    }
    const int* ids = load_ids(ids_s, rid, w, nW, N, tid, kT);
    sync();  // statistics and ids
    int key_id[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) key_id[r] = (ids && key_ok[r]) ? ids[key[r]] : 0;

    float acc_dk[HD / 8][4], acc_dv[HD / 8][4];
    zero(acc_dk);
    zero(acc_dv);
    for (int t = 0; t < nq_tiles; ++t) {
      const int buf = t % 2;
      if (t + 1 < nq_tiles) {
        load_rows<BQ, HD>(q_s + (buf ^ 1) * BQ * kLd, qb, st.qn, (t + 1) * BQ, N, D, tid);
        load_rows<BQ, HD>(g_s + (buf ^ 1) * BQ * kLd, gb, st.gn, (t + 1) * BQ, N, D, tid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      sync();
      const bf16* qt = q_s + buf * BQ * kLd;
      const bf16* gt = g_s + buf * BQ * kLd;
      float st_[BQ / 8][4], dpt[BQ / 8][4];
      product_abt<HD, BQ>(st_, k_s, warp * 16, qt);
      product_abt<HD, BQ>(dpt, v_s, warp * 16, gt);
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = j >> 1;
          const int qi = t * BQ + nt * 8 + tig * 2 + (j & 1);
          float p = 0.f, ds = 0.f;
          if (key_ok[r] && qi < N) {
            const float s = logit(st_[nt][j], scale, bias_s[qi * kBM + key[r] - k0],
                                  ids && ids[qi] != key_id[r]);
            p = expf(s - m_s[qi]) * il_s[qi];
            ds = p * (dpt[nt][j] - dl_s[qi]);
          }
          st_[nt][j] = p;
          dpt[nt][j] = ds;
        }
      product_pv<HD, BQ>(acc_dv, st_, gt);  // dV += bf16(P)^T G
      product_pv<HD, BQ>(acc_dk, dpt, qt);  // dK += bf16(ds)^T Q
      sync();
    }
    store_rows<HD>(dk + w * st.dkb + h * st.dkh, st.dkn, acc_dk, k0 + warp * 16, N, D, scale);
    store_rows<HD>(dv + w * st.dvb + h * st.dvh, st.dvn, acc_dv, k0 + warp * 16, N, D, 1.f);
  }
}

// (c) dbias partials: one block per (64-query tile, 64-key tile, head,
// window group) keeps its 64 x 64 tile of the sum over windows of the f32 ds
// in registers; its bias tile sits in shared memory. It walks the group's
// windows with each window's Q, G, K and V tiles, the query rows'
// statistics and the region ids of its rows and keys double-buffered
// (cp.async), recomputing S and dP and taking P from (a)'s statistics.
template <int HD>
__host__ __device__ constexpr int dbias_tile_elems() { return 4 * kBM * (HD + kPad); }
// Per buffer after the tiles: 3 x 64 f32 statistics, 64 query ids, 64 key ids.
constexpr int kDbiasAux = 3 * kBM + 2 * kBM;

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0));
}

template <int HD>
__global__ void __launch_bounds__(kT, 4)
window_bwd_dbias_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ gr,
                             const float* __restrict__ bias, const int* __restrict__ rid,
                             const float* __restrict__ stats, float* __restrict__ dbias_out,
                             int BW, int H, int N, int D, int nW, int per_group, BwdStrides st,
                             float scale) {
  constexpr int kLd = HD + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* bias_s = reinterpret_cast<float*>(smem_raw);            // 64 x 64 bias tile
  bf16* tiles = reinterpret_cast<bf16*>(bias_s + kBM * kBN);     // 2 x (Q, G, K, V)
  float* aux = reinterpret_cast<float*>(tiles + 2 * dbias_tile_elems<HD>());  // 2 x kDbiasAux
  const int n_kt = (N + kBN - 1) / kBN;
  const int q0 = (blockIdx.x / n_kt) * kBM, k0 = (blockIdx.x % n_kt) * kBN;
  const int h = blockIdx.y, grp = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, tig = lane % 4;
  const float* bias_h = bias + (long long)h * N * N;

  for (int i = tid; i < kBM * kBN; i += kT) {
    const int row = q0 + i / kBN, key = k0 + i % kBN;
    bias_s[i] = (row < N && key < N) ? bias_h[(long long)row * N + key] : 0.f;
  }
  float acc[kBN / 8][4];
  zero(acc);

  const int w0 = grp * per_group, w_end = min(BW, w0 + per_group);
  auto load = [&](int w, int b) {
    bf16* t = tiles + b * dbias_tile_elems<HD>();
    load_rows<kBM, HD>(t, q + w * st.qb + h * st.qh, st.qn, q0, N, D, tid);
    load_rows<kBM, HD>(t + kBM * kLd, gr + w * st.gb + h * st.gh, st.gn, q0, N, D, tid);
    load_rows<kBN, HD>(t + 2 * kBM * kLd, k + w * st.kb + h * st.kh, st.kn, k0, N, D, tid);
    load_rows<kBN, HD>(t + 3 * kBM * kLd, v + w * st.vb + h * st.vh, st.vn, k0, N, D, tid);
    float* x = aux + b * kDbiasAux;
    const float* stw = stats + ((long long)w * H + h) * 3 * N;
    for (int i = tid; i < 3 * kBM; i += kT) {
      const int row = q0 + i % kBM;
      cp_async4(x + i, stw + (i / kBM) * N + (row < N ? row : 0), row < N);
    }
    if (rid) {
      const int* idrow = rid + (long long)(w % nW) * N;
      for (int i = tid; i < 2 * kBM; i += kT) {
        const int pos = (i < kBM ? q0 : k0 - kBM) + i;
        cp_async4(x + 3 * kBM + i, idrow + (pos < N ? pos : 0), pos < N);
      }
    }
  };
  load(w0, 0);
  cp_async_commit();
  for (int w = w0; w < w_end; ++w) {
    const int b = (w - w0) & 1;
    if (w + 1 < w_end) {
      load(w + 1, b ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* t = tiles + b * dbias_tile_elems<HD>();
    const float* x = aux + b * kDbiasAux;
    const int* ids = reinterpret_cast<const int*>(x + 3 * kBM);  // 64 query ids, 64 key ids
    float s[kBN / 8][4], dp[kBN / 8][4];
    product_abt<HD, kBN>(s, t, warp * 16, t + 2 * kBM * kLd);             // Q K^T
    product_abt<HD, kBN>(dp, t + kBM * kLd, warp * 16, t + 3 * kBM * kLd);  // G V^T
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lr = warp * 16 + g + 8 * r;  // the row in the tile
      const float m = x[lr], il = x[kBM + lr], dl = x[2 * kBM + lr];
      const int qid = ids[lr];
#pragma unroll
      for (int nt = 0; nt < kBN / 8; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int lk = nt * 8 + tig * 2 + c;  // the key in the tile
          const float xl = logit(s[nt][2 * r + c], scale, bias_s[lr * kBN + lk],
                                 rid && ids[kBM + lk] != qid);
          acc[nt][2 * r + c] += expf(xl - m) * il * (dp[nt][2 * r + c] - dl);
        }
    }
    __syncthreads();  // the next load overwrites this buffer
  }
  float* out = dbias_out + ((long long)grp * H + h) * N * N;
#pragma unroll
  for (int nt = 0; nt < kBN / 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = q0 + warp * 16 + g + 8 * (j >> 1), key = k0 + nt * 8 + tig * 2 + (j & 1);
      if (row < N && key < N) out[(long long)row * N + key] = acc[nt][j];
    }
}

// (d) dbias = the groups' partials summed in group order.
__global__ void dbias_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dbias,
                                    long long count, int groups) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < count;
       i += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int gi = 0; gi < groups; ++gi) acc += partial[gi * count + i];
    dbias[i] = acc;
  }
}

// ---------------------------------------------------------------------------
// FMA units: f32 at every shape the held designs take, and the wide path
// ---------------------------------------------------------------------------
//
// One template serves two designs. T = float with kWide = false is the f32
// path at N <= kMaxN, D <= 128 (region ids and, in dK/dV, the statistics
// copied to fixed shared arrays). kWide = true is the wide path, in float or
// bf16, at every N and D <= 256 (HD 256): the region ids and statistics are
// read from device memory (L1 / L2) instead, the bias per element as
// everywhere on the FMA units, and bf16 inputs are widened to f32 as they
// land in shared memory; P and ds are rounded to bf16 where kernels 8-9
// round them (P before P V, ds before the dQ / dK products, P before dV),
// and dbias sums the unrounded ds.

constexpr int kF32Tile = 32;  // rows of a streamed tile (16 at HD = 256)
template <int HD>
__host__ __device__ constexpr int fma_tile() { return HD == 256 ? 16 : kF32Tile; }

template <int kTpr>
__device__ __forceinline__ float group_sum(float part) {
#pragma unroll
  for (int off = kTpr / 2; off > 0; off /= 2) part += __shfl_xor_sync(0xffffffffu, part, off);
  return part;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16_rn(x); }
// x as the product's operand: rounded to bf16 in the bf16 path.
template <typename T>
__device__ __forceinline__ float operand(float x) { return to_f32(from_f32<T>(x)); }

// 16 bytes of T at p (4 floats or 8 bf16) into `out` as floats.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load16(const bf16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Copy rows [row0, row0 + fma_tile<HD>()) of one or two (window, head)
// slices into shared f32 tiles with `threads` threads; rows >= N and
// columns >= D are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_f32_tiles(float (*a)[HD], const T* a_base, long long a_rs,
                                               float (*b)[HD], const T* b_base, long long b_rs,
                                               int row0, int N, int D, int threads) {
  constexpr int V = 16 / sizeof(T);
  for (int i = threadIdx.x; i < fma_tile<HD>() * HD / V; i += threads) {
    const int r = i / (HD / V), col = (i % (HD / V)) * V;
    const int row = row0 + r;
    if (row < N && col < D) {
      load16(a_base + row * a_rs + col, &a[r][col]);
      if (b) load16(b_base + row * b_rs + col, &b[r][col]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        a[r][col + j] = 0.f;
        if (b) b[r][col + j] = 0.f;
      }
    }
  }
}

// The region ids of window w: a copy in shared memory (`ids_s`, the held
// path) or row w % nW of rid itself (the wide path); null without rid.
template <bool kWide>
__device__ __forceinline__ const int* window_ids(int* ids_s, const int* rid, int w, int nW,
                                                 int N, int tid, int threads) {
  if (kWide) return rid ? rid + (long long)(w % nW) * N : nullptr;
  return load_ids(ids_s, rid, w, nW, N, tid, threads);
}

// Forward (kernel 8): one query row per HD / 32 threads.
template <typename T, int HD, bool kWide>
__global__ void __launch_bounds__(kF32Threads)
window_fwd_fma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      T* __restrict__ o, const float* __restrict__ bias,
                      const int* __restrict__ rid, int H, int N, int D, int nW, FwdStrides st,
                      float scale) {
  constexpr int kTpr = HD / 32;
  constexpr int kRows = kF32Threads / kTpr;
  constexpr int kTile = fma_tile<HD>();
  __shared__ __align__(16) float k_s[kTile][HD];
  __shared__ __align__(16) float v_s[kTile][HD];
  __shared__ int ids_s[kWide ? 1 : kMaxN];

  const int w = blockIdx.x / H, h = blockIdx.x % H;
  const int row = blockIdx.y * kRows + threadIdx.x / kTpr;
  const int c0 = (threadIdx.x % kTpr) * 32;
  const bool row_ok = row < N;
  const T* kb = k + w * st.kb + h * st.kh;
  const T* vb = v + w * st.vb + h * st.vh;
  const T* qr_p = q + w * st.qb + h * st.qh + row * st.qn;
  const float* brow = bias + ((long long)h * N + (row_ok ? row : 0)) * N;
  const int* ids = window_ids<kWide>(ids_s, rid, w, nW, N, threadIdx.x, blockDim.x);
  __syncthreads();
  const int my_id = (ids && row_ok) ? ids[row] : 0;

  float qr[32], acc[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    qr[c] = (row_ok && c0 + c < D) ? to_f32(qr_p[c0 + c]) : 0.f;
    acc[c] = 0.f;
  }
  float m = kMaskValue, l = 0.f;
  for (int key0 = 0; key0 < N; key0 += kTile) {
    __syncthreads();
    load_f32_tiles<T, HD>(k_s, kb, st.kn, nullptr, nullptr, 0, key0, N, D, kF32Threads);
    __syncthreads();
    float s[kTile];
    float mx = m;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < 32; ++c) part = fmaf(qr[c], k_s[j][c0 + c], part);
      part = group_sum<kTpr>(part);
      const int key = key0 + j;
      s[j] = key < N ? logit(part, scale, row_ok ? brow[key] : 0.f, ids && ids[key] != my_id)
                     : kMaskValue;
      mx = fmaxf(mx, s[j]);
    }
    l *= expf(m - mx);
    m = mx;
#pragma unroll
    for (int j = 0; j < kTile; ++j) l += expf(s[j] - m);
  }
  const float inv_l = 1.f / l;
  for (int key0 = 0; key0 < N; key0 += kTile) {
    __syncthreads();
    load_f32_tiles<T, HD>(k_s, kb, st.kn, v_s, vb, st.vn, key0, N, D, kF32Threads);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < 32; ++c) part = fmaf(qr[c], k_s[j][c0 + c], part);
      part = group_sum<kTpr>(part);
      const int key = key0 + j;
      const float p = key < N ? expf(logit(part, scale, row_ok ? brow[key] : 0.f,
                                           ids && ids[key] != my_id) - m) * inv_l
                              : 0.f;
      const float pv = operand<T>(p);
#pragma unroll
      for (int c = 0; c < 32; ++c) acc[c] = fmaf(pv, v_s[j][c0 + c], acc[c]);
    }
  }
  if (!row_ok) return;
  T* out = o + w * st.ob + h * st.oh + row * st.on;
#pragma unroll
  for (int c = 0; c < 32; ++c)
    if (c0 + c < D) out[c0 + c] = from_f32<T>(acc[c]);
}

// Backward (a): dQ, statistics and dbias rows; one block per (head, block of
// blockDim.x / (HD / 32) query rows, window group), one query row per
// HD / 32 threads. The block's dbias rows (rows x N f32) sit in shared
// memory across its windows.
template <int HD>
__host__ __device__ constexpr int dq_f32_threads() { return kBM * (HD / 32); }

template <typename T, int HD>
__global__ void __launch_bounds__(dq_f32_threads<HD>())
window_bwd_dq_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ gr,
                         const float* __restrict__ bias, const int* __restrict__ rid,
                         T* __restrict__ dq, float* __restrict__ stats,
                         float* __restrict__ dbias_out, int BW, int H, int N, int D, int nW,
                         int per_group, BwdStrides st, float scale) {
  constexpr int kTpr = HD / 32;
  constexpr int kTile = fma_tile<HD>();
  const int threads = blockDim.x, rows = threads / kTpr;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* db_s = reinterpret_cast<float*>(smem_raw);                     // rows x N
  float (*a_s)[HD] = reinterpret_cast<float (*)[HD]>(db_s + rows * N);  // K tiles
  float (*b_s)[HD] = a_s + kTile;                                       // V tiles
  int* ids_s = reinterpret_cast<int*>(b_s + kTile);

  const int h = blockIdx.x, grp = blockIdx.z;
  const int local = threadIdx.x / kTpr;
  const int row = blockIdx.y * rows + local;
  const int c0 = (threadIdx.x % kTpr) * 32;
  const bool row_ok = row < N;
  const float* brow = bias + ((long long)h * N + (row_ok ? row : 0)) * N;
  for (int i = threadIdx.x; i < rows * N; i += threads) db_s[i] = 0.f;
  const int w_end = min(BW, (grp + 1) * per_group);

  for (int w = grp * per_group; w < w_end; ++w) {
    __syncthreads();
    const int* ids = load_ids(ids_s, rid, w, nW, N, threadIdx.x, blockDim.x);
    __syncthreads();
    const int my_id = (ids && row_ok) ? ids[row] : 0;
    const T* kb = k + w * st.kb + h * st.kh;
    const T* vb = v + w * st.vb + h * st.vh;
    const T* qrow = q + w * st.qb + h * st.qh + row * st.qn;
    const T* grow = gr + w * st.gb + h * st.gh + row * st.gn;
    float qr[32], gv[32], acc[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const bool ok = row_ok && c0 + c < D;
      qr[c] = ok ? to_f32(qrow[c0 + c]) : 0.f;
      gv[c] = ok ? to_f32(grow[c0 + c]) : 0.f;
      acc[c] = 0.f;
    }
    float m = kMaskValue, l = 0.f, dd = 0.f;
    for (int key0 = 0; key0 < N; key0 += kTile) {
      __syncthreads();
      load_f32_tiles<T, HD>(a_s, kb, st.kn, b_s, vb, st.vn, key0, N, D, threads);
      __syncthreads();
      float s[kTile], dp[kTile];
      float mx = m;
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        float ps = 0.f, pd = 0.f;
#pragma unroll
        for (int c = 0; c < 32; ++c) {
          ps = fmaf(qr[c], a_s[j][c0 + c], ps);
          pd = fmaf(gv[c], b_s[j][c0 + c], pd);
        }
        ps = group_sum<kTpr>(ps);
        dp[j] = group_sum<kTpr>(pd);
        const int key = key0 + j;
        s[j] = key < N ? logit(ps, scale, row_ok ? brow[key] : 0.f, ids && ids[key] != my_id)
                       : kMaskValue;
        mx = fmaxf(mx, s[j]);
      }
      const float alpha = expf(m - mx);
      l *= alpha;
      dd *= alpha;
      m = mx;
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        const float e = expf(s[j] - m);
        l += e;
        dd += e * dp[j];
      }
    }
    const float il = 1.f / l, dl = dd * il;
    if (row_ok && c0 == 0) {
      float* stw = stats + ((long long)w * H + h) * 3 * N;
      stw[row] = m;
      stw[N + row] = il;
      stw[2 * N + row] = dl;
    }
    for (int key0 = 0; key0 < N; key0 += kTile) {
      __syncthreads();
      load_f32_tiles<T, HD>(a_s, kb, st.kn, b_s, vb, st.vn, key0, N, D, threads);
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kTile; ++j) {
        float ps = 0.f, pd = 0.f;
#pragma unroll
        for (int c = 0; c < 32; ++c) {
          ps = fmaf(qr[c], a_s[j][c0 + c], ps);
          pd = fmaf(gv[c], b_s[j][c0 + c], pd);
        }
        ps = group_sum<kTpr>(ps);
        pd = group_sum<kTpr>(pd);
        const int key = key0 + j;
        float ds = 0.f;
        if (key < N) {
          const float p = expf(logit(ps, scale, row_ok ? brow[key] : 0.f,
                                     ids && ids[key] != my_id) - m) * il;
          ds = p * (pd - dl);
          if (row_ok && c0 == 0) db_s[local * N + key] += ds;
        }
        const float dsr = operand<T>(ds);
#pragma unroll
        for (int c = 0; c < 32; ++c) acc[c] = fmaf(dsr, a_s[j][c0 + c], acc[c]);
      }
    }
    if (row_ok) {
      T* out = dq + w * st.dqb + h * st.dqh + row * st.dqn;
#pragma unroll
      for (int c = 0; c < 32; ++c)
        if (c0 + c < D) out[c0 + c] = from_f32<T>(acc[c] * scale);
    }
  }
  __syncthreads();
  const int row0 = blockIdx.y * rows;
  const int n_rows = min(rows, N - row0);
  float* out = dbias_out + (((long long)grp * H + h) * N + row0) * N;
  for (int i = threadIdx.x; i < n_rows * N; i += threads) out[i] = db_s[i];
}

// Backward (b): dK and dV; one key row per HD / 32 threads.
template <typename T, int HD, bool kWide>
__global__ void __launch_bounds__(kF32Threads)
window_bwd_dkv_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ gr,
                          const float* __restrict__ bias, const int* __restrict__ rid,
                          T* __restrict__ dk, T* __restrict__ dv,
                          const float* __restrict__ stats, int H, int N, int D, int nW,
                          BwdStrides st, float scale) {
  constexpr int kTpr = HD / 32;
  constexpr int kRows = kF32Threads / kTpr;
  constexpr int kTile = fma_tile<HD>();
  constexpr int kHeld = kWide ? 1 : kMaxN;
  __shared__ __align__(16) float a_s[kTile][HD];  // Q tiles
  __shared__ __align__(16) float b_s[kTile][HD];  // G tiles
  __shared__ float m_held[kHeld], il_held[kHeld], dl_held[kHeld];
  __shared__ int ids_s[kHeld];

  const int w = blockIdx.x / H, h = blockIdx.x % H;
  const int key = blockIdx.y * kRows + threadIdx.x / kTpr;
  const int c0 = (threadIdx.x % kTpr) * 32;
  const bool key_ok = key < N;
  const T* qb = q + w * st.qb + h * st.qh;
  const T* gb = gr + w * st.gb + h * st.gh;
  const float* bias_h = bias + (long long)h * N * N;
  const float* stw = stats + ((long long)w * H + h) * 3 * N;
  // The query rows' statistics: copied to shared memory (held), or read in
  // place (wide).
  const float *m_s = stw, *il_s = stw + N, *dl_s = stw + 2 * N;
  if (!kWide) {
    for (int i = threadIdx.x; i < N; i += kF32Threads) {
      m_held[i] = stw[i];
      il_held[i] = stw[N + i];
      dl_held[i] = stw[2 * N + i];
    }
    m_s = m_held;
    il_s = il_held;
    dl_s = dl_held;
  }
  const int* ids = window_ids<kWide>(ids_s, rid, w, nW, N, threadIdx.x, blockDim.x);
  __syncthreads();
  const int key_id = (ids && key_ok) ? ids[key] : 0;
  const T* krow = k + w * st.kb + h * st.kh + key * st.kn;
  const T* vrow = v + w * st.vb + h * st.vh + key * st.vn;
  float kr[32], vr[32], adk[32], adv[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const bool ok = key_ok && c0 + c < D;
    kr[c] = ok ? to_f32(krow[c0 + c]) : 0.f;
    vr[c] = ok ? to_f32(vrow[c0 + c]) : 0.f;
    adk[c] = 0.f;
    adv[c] = 0.f;
  }
  for (int row0 = 0; row0 < N; row0 += kTile) {
    __syncthreads();
    load_f32_tiles<T, HD>(a_s, qb, st.qn, b_s, gb, st.gn, row0, N, D, kF32Threads);
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kTile; ++i) {
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
        const float s = logit(ps, scale, bias_h[(long long)qi * N + key],
                              ids && ids[qi] != key_id);
        p = expf(s - m_s[qi]) * il_s[qi];
        ds = p * (pd - dl_s[qi]);
      }
      const float pr = operand<T>(p), dsr = operand<T>(ds);
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        adv[c] = fmaf(pr, b_s[i][c0 + c], adv[c]);
        adk[c] = fmaf(dsr, a_s[i][c0 + c], adk[c]);
      }
    }
  }
  if (!key_ok) return;
  T* ok_ = dk + w * st.dkb + h * st.dkh + key * st.dkn;
  T* ov = dv + w * st.dvb + h * st.dvh + key * st.dvn;
#pragma unroll
  for (int c = 0; c < 32; ++c)
    if (c0 + c < D) {
      ok_[c0 + c] = from_f32<T>(adk[c] * scale);
      ov[c0 + c] = from_f32<T>(adv[c]);
    }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The slots (4 warps each) that fit beside `held` bytes of bias: at most
// `most`, at least 1 (0 if not even one fits).
inline int fit_slots(size_t held, size_t slot_bytes, int most) {
  if (held + slot_bytes > (size_t)kMaxSmem) return 0;
  const int n = (int)(((size_t)kMaxSmem - held) / slot_bytes);
  return n < most ? n : most;
}

// Kernels 8 and 11 (held bias rows, slots).
template <int HD, int MODE>
cudaError_t launch_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                            const float* bias, const int* rid, int BW, int H, int N, int D,
                            int nW, const FwdStrides& st, float scale, cudaStream_t s) {
  const size_t held = (size_t)kBM * N * sizeof(float);
  const size_t slot_bytes = fwd_slot_elems<HD>() * sizeof(bf16) + ids_bytes(N);
  const int slots = fit_slots(held, slot_bytes, fwd_max_slots<HD>());
  if (slots < 1) return cudaErrorInvalidValue;
  const size_t smem = held + slots * slot_bytes;
  cudaError_t err = set_smem(window_fwd_bf16_kernel<HD, MODE>, smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (N + kBM - 1) / kBM;
  const int groups = held_groups(BW, H * n_qt, slots);
  const int per_group = (BW + groups - 1) / groups;
  dim3 grid(H, n_qt, (BW + per_group - 1) / per_group);
  window_fwd_bf16_kernel<HD, MODE><<<grid, slots * kT, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), bias, rid, BW, H, N, D, nW, per_group, st, scale);
  return cudaGetLastError();
}

// Kernel 12 (HB heads a block).
template <int HD, int HB>
cudaError_t launch_fwd_heads(const void* q, const void* k, const void* v, void* o,
                             const float* bias, const int* rid, int BW, int H, int N, int D,
                             int nW, const FwdStrides& st, float scale, cudaStream_t s) {
  const size_t smem = ids_bytes(N) + (size_t)HB * fwd_slot_elems<HD>() * sizeof(bf16);
  cudaError_t err = set_smem(window_fwd_heads_bf16_kernel<HD, HB>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(BW, H / HB, (N + kBM - 1) / kBM);
  window_fwd_heads_bf16_kernel<HD, HB><<<grid, HB * kT, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), bias, rid, H, N, D, nW, st, scale);
  return cudaGetLastError();
}

// Kernel 8 and the ablation variants (kernels 11 and 12, built for HD <= 64).
template <int HD>
cudaError_t launch_fwd_variant(const void* q, const void* k, const void* v, void* o,
                               const float* bias, const int* rid, int BW, int H, int N, int D,
                               int nW, int mode, int hb, const FwdStrides& st, float scale,
                               cudaStream_t s) {
  if (hb == 1) return launch_fwd_heads<HD, 1>(q, k, v, o, bias, rid, BW, H, N, D, nW, st, scale, s);
  if (hb == 2) return launch_fwd_heads<HD, 2>(q, k, v, o, bias, rid, BW, H, N, D, nW, st, scale, s);
  if (hb == 3) return launch_fwd_heads<HD, 3>(q, k, v, o, bias, rid, BW, H, N, D, nW, st, scale, s);
  if (mode == 1) return launch_fwd_bf16<HD, 1>(q, k, v, o, bias, rid, BW, H, N, D, nW, st, scale, s);
  if (mode == 2) return launch_fwd_bf16<HD, 2>(q, k, v, o, bias, rid, BW, H, N, D, nW, st, scale, s);
  return launch_fwd_bf16<HD, 0>(q, k, v, o, bias, rid, BW, H, N, D, nW, st, scale, s);
}

// The FMA forward: f32 at the held designs' shapes (kWide false), or the
// wide path in either dtype.
template <typename T, int HD, bool kWide>
cudaError_t launch_fwd_fma(const void* q, const void* k, const void* v, void* o,
                           const float* bias, const int* rid, int BW, int H, int N, int D,
                           int nW, const FwdStrides& st, float scale, cudaStream_t s) {
  constexpr int kRows = kF32Threads / (HD / 32);
  dim3 grid(BW * H, (N + kRows - 1) / kRows);
  window_fwd_fma_kernel<T, HD, kWide><<<grid, kF32Threads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), bias, rid, H, N, D, nW, st, scale);
  return cudaGetLastError();
}

struct BwdArgs {
  const void *q, *k, *v, *g;
  const float* bias;
  const int* rid;
  void *dq, *dk, *dv;
  float *dbias, *stats, *partial;
  int BW, H, N, D, nW, per_group, groups;
  BwdStrides st;
  float scale;
};

// (a) statistics and dQ, (b) dK and dV, (c) the dbias partials of
// `a.groups` groups of `a.per_group` windows (straight into dbias when there
// is one group); the caller sums the groups.
template <int HD>
cudaError_t launch_bwd_bf16(const BwdArgs& a, cudaStream_t s) {
  const bf16 *q = static_cast<const bf16*>(a.q), *k = static_cast<const bf16*>(a.k);
  const bf16 *v = static_cast<const bf16*>(a.v), *g = static_cast<const bf16*>(a.g);
  const int n_t = (a.N + kBM - 1) / kBM;
  const size_t held = (size_t)kBM * a.N * sizeof(float);

  const size_t dq_slot = dq_slot_elems<HD>() * sizeof(bf16) + ids_bytes(a.N);
  const int dq_slots = fit_slots(held, dq_slot, dq_max_slots<HD>());
  if (dq_slots < 1) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(window_bwd_dq_bf16_kernel<HD>, held + dq_slots * dq_slot);
  if (err != cudaSuccess) return err;
  int groups = held_groups(a.BW, a.H * n_t, dq_slots);
  int per = (a.BW + groups - 1) / groups;
  window_bwd_dq_bf16_kernel<HD><<<dim3(a.H, n_t, (a.BW + per - 1) / per), dq_slots * kT,
                                  held + dq_slots * dq_slot, s>>>(
      q, k, v, g, a.bias, a.rid, static_cast<bf16*>(a.dq), a.stats, a.BW, a.H, a.N, a.D, a.nW,
      per, a.st, a.scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t dkv_slot = dkv_slot_bytes(dkv_slot_elems<HD>(), a.N);
  const int dkv_slots = fit_slots(held, dkv_slot, dkv_max_slots<HD>());
  if (dkv_slots < 1) return cudaErrorInvalidValue;
  if ((err = set_smem(window_bwd_dkv_bf16_kernel<HD>, held + dkv_slots * dkv_slot))
      != cudaSuccess)
    return err;
  groups = held_groups(a.BW, a.H * n_t, dkv_slots);
  per = (a.BW + groups - 1) / groups;
  window_bwd_dkv_bf16_kernel<HD><<<dim3(a.H, n_t, (a.BW + per - 1) / per), dkv_slots * kT,
                                   held + dkv_slots * dkv_slot, s>>>(
      q, k, v, g, a.bias, a.rid, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.stats,
      a.BW, a.H, a.N, a.D, a.nW, per, a.st, a.scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem_db = (size_t)kBM * kBN * sizeof(float)
                         + 2 * dbias_tile_elems<HD>() * sizeof(bf16) + 2 * kDbiasAux * sizeof(float);
  if ((err = set_smem(window_bwd_dbias_bf16_kernel<HD>, smem_db)) != cudaSuccess) return err;
  window_bwd_dbias_bf16_kernel<HD><<<dim3(n_t * n_t, a.H, a.groups), kT, smem_db, s>>>(
      q, k, v, g, a.bias, a.rid, a.stats, a.groups > 1 ? a.partial : a.dbias, a.BW, a.H, a.N,
      a.D, a.nW, a.per_group, a.st, a.scale);
  return cudaGetLastError();
}

// The FMA backward's (a) and (b): f32 at the held designs' shapes (kWide
// false), or the wide path in either dtype. (a)'s blocks hold 64 query rows'
// dbias (64 x N f32) in shared memory, or as many rows as fit at a larger N.
template <typename T, int HD, bool kWide>
cudaError_t launch_bwd_fma(const BwdArgs& a, cudaStream_t s) {
  float* dbias_out = a.groups > 1 ? a.partial : a.dbias;
  const size_t fixed = 2 * fma_tile<HD>() * HD * sizeof(float) + (size_t)a.N * sizeof(int);
  if (fixed + (size_t)a.N * sizeof(float) > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  const int rows = (int)std::min<size_t>(kBM, ((size_t)kMaxSmem - fixed) / (a.N * sizeof(float)));
  const size_t smem_dq = (size_t)rows * a.N * sizeof(float) + fixed;
  cudaError_t err = set_smem(window_bwd_dq_fma_kernel<T, HD>, smem_dq);
  if (err != cudaSuccess) return err;
  dim3 grid_dq(a.H, (a.N + rows - 1) / rows, a.groups);
  window_bwd_dq_fma_kernel<T, HD><<<grid_dq, rows * (HD / 32), smem_dq, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.g), a.bias, a.rid, static_cast<T*>(a.dq), a.stats, dbias_out,
      a.BW, a.H, a.N, a.D, a.nW, a.per_group, a.st, a.scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  constexpr int kRows = kF32Threads / (HD / 32);
  dim3 grid_dkv(a.BW * a.H, (a.N + kRows - 1) / kRows);
  window_bwd_dkv_fma_kernel<T, HD, kWide><<<grid_dkv, kF32Threads, 0, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.g), a.bias, a.rid, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.stats, a.H, a.N, a.D, a.nW, a.st, a.scale);
  return cudaGetLastError();
}

// The wide path in the call's dtype at head dim HD.
template <int HD>
cudaError_t launch_fwd_wide(int dtype, const void* q, const void* k, const void* v, void* o,
                            const float* bias, const int* rid, int BW, int H, int N, int D,
                            int nW, const FwdStrides& st, float scale, cudaStream_t s) {
  if (dtype == 1)
    return launch_fwd_fma<bf16, HD, true>(q, k, v, o, bias, rid, BW, H, N, D, nW, st, scale, s);
  return launch_fwd_fma<float, HD, true>(q, k, v, o, bias, rid, BW, H, N, D, nW, st, scale, s);
}
template <int HD>
cudaError_t launch_bwd_wide(int dtype, const BwdArgs& a, cudaStream_t s) {
  return dtype == 1 ? launch_bwd_fma<bf16, HD, true>(a, s) : launch_bwd_fma<float, HD, true>(a, s);
}

// The design of the last launch of kernel 8 ([0]) and kernel 9 ([1]): 0 =
// FMA (f32, held arrays), 1 = mma.sync (bf16, held bias rows), 2 = wide;
// -1 before the first launch. Read through window_attention_last_design.
enum Design { kDesignFma = 0, kDesignMmaSync = 1, kDesignWide = 2 };
int g_last_design[2] = {-1, -1};

// The held designs (bf16 mma.sync, f32 FMA with fixed shared arrays) take
// N <= kMaxN and D <= 128; the wide path every other shape.
bool held_takes(int N, int D) { return N <= kMaxN && D <= 128; }

bool bad_args(int dtype, int BW, int H, int N, int D, int nW) {
  return (dtype != 0 && dtype != 1) || BW < 1 || H < 1 || N < 1 || D <= 0 || D > 256
         || D % 8 != 0 || nW < 1 || BW % nW != 0 || H > 65535
         || (long long)BW * H > 0x7fffffffLL;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v, o are (BW, N, H, D), bias
// (H, N, N) f32 contiguous, rid (nW, N) int32 contiguous or null (no mask);
// `st` holds 12 strides in elements (window, position, head of q, k, v, o).
// The head-dim stride must be 1, D a multiple of 8 (<= 256), every stride a
// multiple of 8 and every pointer 16-byte aligned (the Python wrapper
// guarantees all of it). N <= 448 and D <= 128 run the held designs
// (mma.sync in bf16, the FMA kernel with held arrays in f32), every other
// shape the wide path. mode: 0 exp (kernel 8), 1 bf16 (S - max), 2 exp2
// (kernel 11); hb: 0 for kernels 8 and 11 (held bias rows), or 1-3 heads a
// block for kernel 12 (H % hb == 0, mode 0). The variants take bfloat16,
// N <= 448 and D <= 64. Returns the cudaError_t of the launch (0 = success).
extern "C" int window_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                    const float* bias, const int* rid, int dtype, int BW, int N,
                                    int H, int D, int nW, int mode, int hb, const long long* st,
                                    float scale, void* stream) {
  if (bad_args(dtype, BW, H, N, D, nW) || mode < 0 || mode > 2 || hb < 0 || hb > 3
      || (hb > 0 && (H % hb != 0 || mode != 0)))
    return (int)cudaErrorInvalidValue;
  const bool variant = mode != 0 || hb != 0;
  if (variant && (dtype != 1 || D > 64 || N > kMaxN)) return (int)cudaErrorInvalidValue;
  FwdStrides s;
  std::memcpy(&s, st, sizeof(s));
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (!held_takes(N, D)) {
    g_last_design[0] = kDesignWide;
    if (D <= 32) return (int)launch_fwd_wide<32>(dtype, q, k, v, o, bias, rid, BW, H, N, D, nW, s, scale, cs);
    if (D <= 64) return (int)launch_fwd_wide<64>(dtype, q, k, v, o, bias, rid, BW, H, N, D, nW, s, scale, cs);
    if (D <= 128) return (int)launch_fwd_wide<128>(dtype, q, k, v, o, bias, rid, BW, H, N, D, nW, s, scale, cs);
    return (int)launch_fwd_wide<256>(dtype, q, k, v, o, bias, rid, BW, H, N, D, nW, s, scale, cs);
  }
  if (dtype == 1) {
    g_last_design[0] = kDesignMmaSync;
    if (D <= 32) return (int)launch_fwd_variant<32>(q, k, v, o, bias, rid, BW, H, N, D, nW, mode, hb, s, scale, cs);
    if (D <= 64) return (int)launch_fwd_variant<64>(q, k, v, o, bias, rid, BW, H, N, D, nW, mode, hb, s, scale, cs);
    return (int)launch_fwd_bf16<128, 0>(q, k, v, o, bias, rid, BW, H, N, D, nW, s, scale, cs);
  }
  g_last_design[0] = kDesignFma;
  if (D <= 32) return (int)launch_fwd_fma<float, 32, false>(q, k, v, o, bias, rid, BW, H, N, D, nW, s, scale, cs);
  if (D <= 64) return (int)launch_fwd_fma<float, 64, false>(q, k, v, o, bias, rid, BW, H, N, D, nW, s, scale, cs);
  return (int)launch_fwd_fma<float, 128, false>(q, k, v, o, bias, rid, BW, H, N, D, nW, s, scale, cs);
}

// The gradient: g (the output's gradient, in the input dtype) in; dq, dk,
// dv (BW, N, H, D) and dbias (H, N, N) f32 out. stats: (BW, H, 3, N) f32
// scratch; partial: (groups, H, N, N) f32 scratch when groups > 1 (ignored
// otherwise); windows [i * per_group, (i + 1) * per_group) form group i.
// `st` holds 21 strides: q, k, v, g, dq, dk, dv (window, position, head).
// Designs by shape as in window_attention_fwd.
extern "C" int window_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                                    const float* bias, const int* rid, void* dq, void* dk,
                                    void* dv, float* dbias, float* stats, float* partial,
                                    int dtype, int BW, int N, int H, int D, int nW,
                                    int per_group, int groups, const long long* st, float scale,
                                    void* stream) {
  if (bad_args(dtype, BW, H, N, D, nW) || per_group < 1 || groups < 1 || groups > 65535
      || (long long)per_group * groups < BW || (long long)per_group * (groups - 1) >= BW)
    return (int)cudaErrorInvalidValue;
  BwdArgs a{q, k, v, g, bias, rid, dq, dk, dv, dbias, stats, partial,
            BW, H, N, D, nW, per_group, groups, {}, scale};
  std::memcpy(&a.st, st, sizeof(a.st));
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!held_takes(N, D)) {
    g_last_design[1] = kDesignWide;
    err = D <= 32    ? launch_bwd_wide<32>(dtype, a, cs)
          : D <= 64  ? launch_bwd_wide<64>(dtype, a, cs)
          : D <= 128 ? launch_bwd_wide<128>(dtype, a, cs)
                     : launch_bwd_wide<256>(dtype, a, cs);
  } else if (dtype == 1) {
    g_last_design[1] = kDesignMmaSync;
    err = D <= 32 ? launch_bwd_bf16<32>(a, cs) : D <= 64 ? launch_bwd_bf16<64>(a, cs)
                                                         : launch_bwd_bf16<128>(a, cs);
  } else {
    g_last_design[1] = kDesignFma;
    err = D <= 32    ? launch_bwd_fma<float, 32, false>(a, cs)
          : D <= 64  ? launch_bwd_fma<float, 64, false>(a, cs)
                     : launch_bwd_fma<float, 128, false>(a, cs);
  }
  if (err != cudaSuccess || groups == 1) return (int)err;
  const long long count = (long long)H * N * N;
  const int blocks = (int)std::min<long long>((count + 255) / 256, 4096);
  dbias_reduce_kernel<<<blocks, 256, 0, cs>>>(partial, dbias, count, groups);
  return (int)cudaGetLastError();
}

// The design (0 = FMA, 1 = mma.sync, 2 = wide) of the last launch of kernel
// 8 (which = 0; the variants of kernels 11-12 included) or kernel 9
// (which = 1); -1 before the first.
extern "C" int window_attention_last_design(int which) {
  return which == 0 || which == 1 ? g_last_design[which] : -1;
}
