// Kernels 3 and 4 (flash_attention_bwd.cu's entries) in float32 on Hopper's
// tensor cores: the design "wgmma.tf32x3", which launch_dq and launch_dkv
// take for f32 at D <= 64 (after padding) with every batch, sequence and
// head stride of q, k, v and dO positive (TMA cannot describe a stride of 0).
//
// Replaces, for those calls, laryngeal_tpu/ops/flash_attention.py's
// _dq_kernel (:131, launch :437) and _dkv_kernel (:168, launch :451) in f32,
// with their arithmetic: S = scale Q K^T and P = exp(S - lse) recomputed
// (keys >= n_actual give P = 0), dP = dO V^T, dS = P (dP - delta) with delta
// = rowsum(dO O) from the caller; dQ = scale dS K; dV = P^T dO, dK =
// scale dS^T Q. Nothing is rounded to a narrower type: P and dS stay f32 up
// to their TF32 split.
//
// The products: TF32 alone keeps 10 mantissa bits and misses the f32 limits
// (tests/test_torch_flash_backward.py's emulation), so each operand x is
// split into big (x with its low 13 bits masked) and small = tf32(x - big)
// (cvt.rna), and each product is small.big + big.small + big.big, three
// wgmma.m64nNk8.tf32 (3xTF32). dQ sums over every key and dK, dV over every
// query (3137 at ViViT-B), so each 32-row step's product goes to an
// accumulator of its own that is added to dQ, dK or dV on the FMA units
// (every kFlushSteps steps): flash_attention_fwd.cu's f32 O, summed by the
// tensor cores over 3137 keys, failed the full-width f32 gradient check.
//
// What bounds it on the H100, at the ViViT-B shape (8, 3137, 12, 64): a
// product is 2 B H N^2 D = 1.209e11 FLOP, three TF32 products each; kernel 3
// runs 3 (S, dP, dQ), 2.199 ms at the 495 TFLOP/s TF32 peak, kernel 4 runs 4
// (S^T, dP^T, dV, dK), 2.932 ms, against ~0.31 / 0.39 GB of inputs and
// outputs (0.09 / 0.12 ms at 3.35 TB/s): both are bound by the tensor cores,
// and do B H N^2 = 9.4e8 exponentials besides. At 32 rows a step the
// products are m64n32 and m64nHD, so shared memory's 128 bytes a clock also
// count: the A operands come from registers wherever the registers allow.
//
// TF32 wgmma reads both operands K-major only, so every B operand sits in
// shared memory in the form its product reads (tf32_tiles.cuh): "rows" (a
// 32-row step, the head dim contiguous, split in place with its small part
// beside it: K or V for S = Q K^T and dP = dO V^T; Q or dO for S^T = K Q^T
// and dP^T = V dO^T) and "T" (HD head-dim rows of 32 positions: K^T for
// dQ += dS K; Q^T and dO^T for dK += dS^T Q and dV += P^T dO). Raw f32 rows
// come by TMA (4-D maps over the (B, N, H, D) strides, so fused-qkv and
// (B, H, N, D) views need no copy; 32-column boxes, 128-byte swizzle; rows
// past N and columns past D arrive as zeros). Kernel 3 splits them in the
// block, by three transform warps. Kernel 4 streams q's and dO's forms that
// a pre-pass wrote once a call to scratch the wrapper allocates: its blocks
// (128 keys each, 25 for one (b, h) at N = 3137) would otherwise each split
// all of q and dO again, which made it a quarter slower than the pre-pass
// and its kernel together (PERF.md; scripts/ablate_flash_bwd.py --f32 times
// kernel 3's choice both ways).
//
// Blocks: one persistent block an SM (384 threads) walks work items of 128
// rows (two 64-row tiles, one a consumer warpgroup) of one (batch, head),
// the tiles fastest, so a (b, h)'s items run side by side and share its
// streamed tensors through L2. Warpgroup 0: warp 0 issues the TMA loads in
// the order the consumers read them into rings of slots (each slot read by
// both consumer warpgroups, so a slot never changes owners); in kernel 3
// warps 1-3 split each slot. The producer's warpgroup keeps 40 registers a
// thread, the consumers claim 232. Kernel 4's scratch is dkv_scratch_floats floats, 8
// B H Npad HD + 2 B H Npad (Npad = Nq rounded up to 32): 0.62 GB at the
// ViViT-B shape.
//   * Kernel 3 (bwd_dq_tf32_kernel): query tiles as rows. An item's Q comes
//     raw; a consumer splits its fragments, the big part into registers and
//     the small part in place (an SS operand). Its dO is split in place by
//     the transform warps; a consumer reads the big part's fragments into
//     registers and the small part stays an SS operand. Per 32-key step: a K
//     slot (rows and T forms, three deep) and a V slot (rows, two deep); dS
//     from the step's S and dP (lse and delta of the thread's two rows in
//     registers; keys >= n_actual masked in the last step), split into A
//     fragments; then two batches, each waited for in the iteration that
//     issues it: dQ's step product (then its add), and the next step's S and
//     dP (after the last step, this step's K rows again, unused: no branch
//     among the products). One batch of all three held more registers than
//     there are beside dO's big part: with dO read from shared memory
//     instead, it was 13% slower (scripts/ablate_flash_bwd.py --f32).
//   * Kernel 4: first the pre-pass (bwd_forms_tf32_kernel, Forms), a block
//     a 32-row step of q or dO: both forms of each, and each query's lse
//     (base 2; +inf past Nq, so those queries give P = 0) and delta in rows
//     padded to 32 (a (b, h) row of Nq floats need not be 16-byte aligned,
//     as TMA requires). Then bwd_dkv_tf32_kernel: key tiles as rows, K and V
//     raw and resident; their fragments are split into registers each step
//     (both parts of both would not fit beside dK, dV and their step
//     accumulators). A ring of five slots carries each 32-query step's Q
//     forms with its lse and delta, then its dO forms, by TMA; no transform
//     warps (warps 1-3 idle). Per step: S^T, then dP^T, P^T and dS^T from
//     the accumulators, split into A fragments, and dV's and dK's step
//     products as one batch. An item whose keys are all >= n_actual only
//     stores zeros; keys >= n_actual in a live item get exactly 0 too.

#include "flash_attention_bwd_tf32.cuh"

#include "flash_attention_common.cuh"
#include "hopper.cuh"
#include "tf32_tiles.cuh"
#include "wgmma_tiles.cuh"

namespace fabtf32 {
namespace {

using flash::kLog2e;
using namespace tf32tile;

constexpr int kThreads = 384;  // warpgroup 0 loads and splits, warpgroups 1-2 compute
constexpr int kConsumerWarps = 8;
constexpr int kTransformWarps = 3;  // warps 1-3
constexpr int kTransformThreads = 32 * kTransformWarps;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
// Steps whose products the tensor cores sum before the sum is added to dQ,
// dK or dV on the FMA units.
constexpr int kFlushSteps = 1;

template <int SLOTS, int BYTES>
using Ring3 = Ring<SLOTS, BYTES, kTransformWarps, kConsumerWarps>;

// Shared-memory geometry at head dim HD (32: D <= 32; 64: 32 < D <= 64;
// columns past D are zeros).
template <int HD>
struct Geom {
  static constexpr int kTile = 64 * HD * 4;  // 64 raw rows: HD / 32 panels of 8 KB
  static constexpr int kStep = 32 * HD * 4;  // 32 raw rows, or one part of a 32-row T form
  static constexpr int kTilePanel = kRowsPanelBytes<64>, kStepPanel = kRowsPanelBytes<32>;
  // Kernel 3: Q (two tiles), dO (two tiles, then their small parts), a K
  // ring (rows big in place, rows small, T big, T small) and a V ring (rows
  // big in place, rows small); barriers q_full, q_empty, d_full, d_ready,
  // d_empty and three a slot; 1024 bytes of slack for the base alignment.
  static constexpr int kKSlots = 3, kKSlot = 4 * kStep;
  static constexpr int kVSlots = 2, kVSlot = 2 * kStep;
  static constexpr size_t kDqSmem = 6 * kTile + kKSlots * kKSlot + kVSlots * kVSlot
                                    + (5 + 3 * (kKSlots + kVSlots)) * 8 + 1024;
  // Kernel 4: K and V (two tiles each), a ring of Q or dO steps in both
  // forms, each slot's lse and delta rows (32 + 32 floats), barriers
  // kv_full, kv_empty and three a slot (its `ready` unused: no transform).
  static constexpr int kSlots = 5, kSlot = 4 * kStep;
  static constexpr size_t kDkvSmem = 4 * kTile + kSlots * kSlot + kSlots * 64 * 4
                                     + (2 + 3 * kSlots) * 8 + 1024;
  static_assert(kDqSmem <= 232448 && kDkvSmem <= 232448, "227 KB of shared memory a block");
};

__device__ __forceinline__ void warp_arrive(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive(bar);
}

// The 3xTF32 products. d (64 x 32) = A B^T over the head dim, B a rows-form
// step (big part at b, small at b + kStep).

// A's big part in registers, its small part a 64-row tile at `as` (SS).
template <int HD>
__device__ __forceinline__ void abt_rs_ss(float (&d)[16], const uint32_t (&ab)[HD / 8][4],
                                          const unsigned char* as, const unsigned char* b) {
  using G = Geom<HD>;
  const uint64_t da = tf32_desc(as), bb = tf32_desc(b), bs = tf32_desc(b + G::kStep);
#pragma unroll
  for (int k = 0; k < HD / 8; ++k) {
    const uint32_t oa = (k / 4 * G::kTilePanel + k % 4 * 32) >> 4;
    const uint32_t ob = (k / 4 * G::kStepPanel + k % 4 * 32) >> 4;
    hopper::wgmma_m64n32k8_tf32_ss(d, da + oa, bb + ob, k > 0);
    hopper::wgmma_m64n32k8_tf32_rs(d, ab[k], bs + ob, 1);
    hopper::wgmma_m64n32k8_tf32_rs(d, ab[k], bb + ob, 1);
  }
}

// Both of A's parts in registers (RS).
template <int HD>
__device__ __forceinline__ void abt_rs(float (&d)[16], const uint32_t (&ab)[HD / 8][4],
                                       const uint32_t (&as)[HD / 8][4], const unsigned char* b) {
  using G = Geom<HD>;
  const uint64_t bb = tf32_desc(b), bs = tf32_desc(b + G::kStep);
#pragma unroll
  for (int k = 0; k < HD / 8; ++k) {
    const uint32_t ob = (k / 4 * G::kStepPanel + k % 4 * 32) >> 4;
    hopper::wgmma_m64n32k8_tf32_rs(d, as[k], bb + ob, k > 0);
    hopper::wgmma_m64n32k8_tf32_rs(d, ab[k], bs + ob, 1);
    hopper::wgmma_m64n32k8_tf32_rs(d, ab[k], bb + ob, 1);
  }
}

// acc (64 x HD) (+)= A B over one 32-position step: A's parts in registers
// (tf32_acc_frags of a 64 x 32 accumulator), B a T form (big part at tb,
// small at tb + kStep). Unless `accumulate`, acc is overwritten.
template <int HD>
__device__ __forceinline__ void ab_rs(float (&acc)[HD / 2], const uint32_t (&ab)[4][4],
                                      const uint32_t (&as)[4][4], const unsigned char* tb,
                                      bool accumulate) {
  const uint64_t bb = tf32_desc(tb), bs = tf32_desc(tb + Geom<HD>::kStep);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    tf32_mma_hd<HD>(acc, as[kk], bb + 2 * kk, accumulate || kk > 0);
    tf32_mma_hd<HD>(acc, ab[kk], bs + 2 * kk, 1);
    tf32_mma_hd<HD>(acc, ab[kk], bb + 2 * kk, 1);
  }
}

// Kernel 3's step, in place: dp becomes dS = P (dP - delta), with P =
// exp2(S scale log2(e) - lse2) of this thread's rows g and g + 8 (keys >=
// n_valid of the step give P = 0 when TAIL). Accumulator element i sits at
// column 8 (i / 4) + 2 t4 + (i & 1) of row g + 8 ((i / 2) & 1).
template <bool TAIL>
__device__ __forceinline__ void dq_scores(const float (&s)[16], float (&dp)[16],
                                          const float (&lse2)[2], const float (&dl)[2],
                                          float sl2, int n_valid, int t4) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = (i >> 1) & 1;
    float p = hopper::exp2_approx(fmaf(s[i], sl2, -lse2[r]));
    if (TAIL && 8 * (i >> 2) + 2 * t4 + (i & 1) >= n_valid) p = 0.f;
    dp[i] = p * (dp[i] - dl[r]);
  }
}

// Kernel 4's step, keys as rows, in place: st becomes P^T = exp2(S^T scale
// log2(e) - lse2[query]) and dpt dS^T = P^T (dP^T - delta[query]), rows of
// masked keys (key_ok false) P = 0. `rows` holds the step's 32 lse2, then
// its 32 delta.
__device__ __forceinline__ void dkv_scores(float (&st)[16], float (&dpt)[16], const float* rows,
                                           const bool (&key_ok)[2], float sl2, int t4) {
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const float2 l = *reinterpret_cast<const float2*>(rows + 8 * jj + 2 * t4);
    const float2 d = *reinterpret_cast<const float2*>(rows + 32 + 8 * jj + 2 * t4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool odd = e & 1;
      float p = hopper::exp2_approx(fmaf(st[4 * jj + e], sl2, -(odd ? l.y : l.x)));
      if (!key_ok[e >> 1]) p = 0.f;
      st[4 * jj + e] = p;
      dpt[4 * jj + e] = p * (dpt[4 * jj + e] - (odd ? d.y : d.x));
    }
  }
}

// Write a warpgroup's 64 x HD accumulator times `mul` as f32 rows [row0,
// row0 + 64) of one (batch, head) slice: rows >= n_rows skipped, rows >=
// n_zero written as 0, columns >= D skipped.
template <int HD>
__device__ __forceinline__ void store_rows(const float (&acc)[HD / 2], float* base,
                                           long long rs, int row0, int n_rows, int n_zero,
                                           int D, float mul, int warp, int g, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 16 * warp + g + 8 * r;
    if (row >= n_rows) continue;
    const bool keep = row < n_zero;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      if (col < D)
        *reinterpret_cast<float2*>(base + row * rs + col) =
            keep ? make_float2(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul)
                 : make_float2(0.f, 0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// Kernel 3: dQ
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_tf32_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dq, int BH, int H, int Nq, int D, int n_actual,
                   long long sgb, long long sgn, long long sgh, float scale, int pos_q,
                   int pos_k, int pos_v, int pos_do) {
  using G = Geom<HD>;
  constexpr int T = G::kTile, S = G::kStep, KS = G::kKSlots, VS = G::kVSlots;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = wgtile::align1024(smem_raw);
  unsigned char* q_s = smem;           // two raw Q tiles; a warpgroup's small part in place
  unsigned char* do_s = smem + 2 * T;  // two dO tiles: raw, then big; their small parts at + 2 T
  unsigned char* k_base = smem + 6 * T;
  unsigned char* v_base = k_base + KS * G::kKSlot;
  uint64_t* bars = reinterpret_cast<uint64_t*>(v_base + VS * G::kVSlot);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 1;
  uint64_t* d_full = bars + 2;
  uint64_t* d_ready = bars + 3;
  uint64_t* d_empty = bars + 4;
  const Ring3<KS, G::kKSlot> kr{k_base, bars + 5, bars + 5 + KS, bars + 5 + 2 * KS};
  uint64_t* vbars = bars + 5 + 3 * KS;
  const Ring3<VS, G::kVSlot> vr{v_base, vbars, vbars + VS, vbars + 2 * VS};
  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init(q_empty, kConsumerWarps);
    hopper::mbar_init(d_full, 1);
    hopper::mbar_init(d_ready, kTransformWarps);
    hopper::mbar_init(d_empty, kConsumerWarps);
    kr.init();
    vr.init();
    hopper::mbar_init_fence();
  }
  __syncthreads();
  const int n_qt = (Nq + 127) / 128, n_items = BH * n_qt;
  const int n_steps = (n_actual + 31) / 32;
  const int lane = threadIdx.x % 32;

  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    hopper::regs_release<kProducerRegs>();
    const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
    if (warp == 0) {
      if (lane == 0) {
        int idx = 0;  // key steps loaded so far, over every item
        for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
          const int bh = item / n_qt, b = bh / H, h = bh % H, row0 = item % n_qt * 128;
          hopper::mbar_wait(q_empty, (it & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(q_full, 2 * T);
          for (int r = 0; r < 2; ++r)
            tf32_load_tile<HD>(q_s + r * T, &tq, pos_q, q_full, h, row0 + 64 * r, b);
          hopper::mbar_wait(d_empty, (it & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(d_full, 2 * T);
          for (int r = 0; r < 2; ++r)
            tf32_load_tile<HD>(do_s + r * T, &tdo, pos_do, d_full, h, row0 + 64 * r, b);
          for (int t = 0; t < n_steps; ++t, ++idx) {
            tf32_load_tile<HD, 32>(kr.acquire(idx, S), &tk, pos_k, kr.bar(idx), h, 32 * t, b);
            tf32_load_tile<HD, 32>(vr.acquire(idx, S), &tv, pos_v, vr.bar(idx), h, 32 * t, b);
          }
        }
      }
    } else {
      const int tid = threadIdx.x - 32;
      int idx = 0;
      for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
        hopper::mbar_wait(d_full, it & 1);
        tf32_split_rows<2 * T, kTransformThreads>(do_s, do_s + 2 * T, tid);
        hopper::fence_async_smem();
        warp_arrive(d_ready, lane);
        for (int t = 0; t < n_steps; ++t, ++idx) {
          unsigned char* kp = kr.arrived(idx);
          tf32_step_forms<HD, kTransformThreads>(kp, kp + 2 * S, kp + 3 * S, tid);
          kr.transformed(idx, lane);
          unsigned char* vp = vr.arrived(idx);
          tf32_split_rows<S, kTransformThreads>(vp, vp + S, tid);
          vr.transformed(idx, lane);
        }
      }
    }
  } else {
    hopper::regs_claim<kConsumerRegs>();
    const int tid = threadIdx.x - 128;
    const int wg = tid / 128, warp = (tid / 32) % 4;
    const int g = lane / 4, t4 = lane % 4;
    const float sl2 = scale * kLog2e;
    unsigned char* q_w = q_s + wg * T;  // raw, then Q's small part
    const unsigned char* dob = do_s + wg * T;  // dO's big part, in place
    const unsigned char* dos = do_s + (2 + wg) * T;
    int idx0 = 0;  // the ring fill of the item's first key step
    for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
      const int bh = item / n_qt, row0 = item % n_qt * 128 + 64 * wg;
      // This thread's rows g and g + 8: lse (base 2) and delta; rows past Nq
      // read 0 (their Q and dO are zeros, so dS = 0) and are never stored.
      float lse2[2], dl[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 16 * warp + g + 8 * r;
        const bool ok = row < Nq;
        lse2[r] = ok ? lse[(long long)bh * Nq + row] * kLog2e : 0.f;
        dl[r] = ok ? delta[(long long)bh * Nq + row] : 0.f;
      }
      uint32_t qb[HD / 8][4];  // Q's big part
      hopper::mbar_wait(q_full, it & 1);
      tf32_load_q<HD>(qb, q_w, q_w, warp, g, t4);
      hopper::fence_async_smem();  // Q's small part: visible to this warpgroup's wgmma
      hopper::named_sync(2 + wg, 128);
      hopper::mbar_wait(d_ready, it & 1);
      uint32_t dob_r[HD / 8][4];  // dO's big part
#pragma unroll
      for (int ks = 0; ks < HD / 8; ++ks)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          dob_r[ks][r] =
              *reinterpret_cast<const uint32_t*>(dob + tf32_frag_offset(ks, r, warp, g, t4));
      // dQ, and the steps' products: an accumulator of their own, added to
      // dQ on the FMA units.
      float acc[HD / 2], step[HD / 2];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
      float s[16], dp[16];  // the step's S and dP (dS in place)
      const unsigned char* k0 = kr.wait(idx0);
      const unsigned char* v0 = vr.wait(idx0);
      hopper::wgmma_fence();
      abt_rs_ss<HD>(s, qb, q_w, k0);
      abt_rs_ss<HD>(dp, dob_r, dos, v0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      vr.release(idx0, lane);
      for (int t = 0; t < n_steps; ++t) {
        const int n_valid = n_actual - 32 * t;
        if (n_valid < 32)
          dq_scores<true>(s, dp, lse2, dl, sl2, n_valid, t4);
        else
          dq_scores<false>(s, dp, lse2, dl, sl2, n_valid, t4);
        uint32_t db[4][4], ds[4][4];  // dS's parts
        tf32_acc_frags<4>(db, ds, dp);
        const bool more = t + 1 < n_steps;
        const unsigned char* kt = kr.slot(idx0 + t);
        const unsigned char* kn = kt;  // after the last step: its K rows again, unused
        const unsigned char* vn = kt;
        if (more) {
          kn = kr.wait(idx0 + t + 1);
          vn = vr.wait(idx0 + t + 1);
        }
        const bool fresh = t % kFlushSteps == 0;
        if (fresh) {
#pragma unroll
          for (int i = 0; i < HD / 2; ++i) step[i] = 0.f;
        }
        hopper::wgmma_fence();
        ab_rs<HD>(step, db, ds, kt + 2 * S, !fresh);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(step);
        if ((t + 1) % kFlushSteps == 0 || !more) {
#pragma unroll
          for (int i = 0; i < HD / 2; ++i) acc[i] += step[i];
        }
        hopper::wgmma_fence();
        abt_rs_ss<HD>(s, qb, q_w, kn);
        abt_rs_ss<HD>(dp, dob_r, dos, vn);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
        hopper::fence_regs(dp);
        kr.release(idx0 + t, lane);
        if (more) vr.release(idx0 + t + 1, lane);
      }
      idx0 += n_steps;
      warp_arrive(q_empty, lane);
      warp_arrive(d_empty, lane);
      const int b = bh / H, h = bh % H;
      store_rows<HD>(acc, dq + b * sgb + h * sgh, sgn, row0, Nq, Nq, D, scale, warp, g, t4);
    }
  }
}

// ---------------------------------------------------------------------------
// Kernel 4: dK, dV
// ---------------------------------------------------------------------------

// Kernel 4's forms of q and dO in the scratch its wrapper allocates (floats,
// Npad = Nq rounded up to 32 rows, BH = B H planes a part): for tensor t (0 q,
// 1 dO) the rows form, a plane of Npad x HD per (part, b h), big part then
// small; then both tensors' T forms, a plane of HD x Npad positions; then
// each query's lse (base 2, +inf past Nq) and delta (0 past Nq), a plane of
// Npad per b h each. Rows past Nq and columns past D are zeros.
struct Forms {
  long long plane;  // Npad HD
  int BH, Npad;
  __host__ __device__ long long rows(int t, int part) const { return (2LL * t + part) * BH * plane; }
  __host__ __device__ long long trans(int t, int part) const {
    return (4LL + 2 * t + part) * BH * plane;
  }
  __host__ __device__ long long stats() const { return 8LL * BH * plane; }
  __host__ __device__ long long floats() const { return stats() + 2LL * BH * Npad; }
};

__host__ __device__ inline Forms forms_of(int B, int H, int Nq, int D) {
  const int HD = D <= 32 ? 32 : 64, npad = (Nq + 31) / 32 * 32;
  return Forms{(long long)npad * HD, B * H, npad};
}

// The pre-pass: a block splits one 32-row step of q or dO (blockIdx.z) of one
// (b, h) into both forms and, for q, copies the step's lse and delta. Reads
// and writes are coalesced; the T form goes through a shared tile.
template <int HD>
__global__ void __launch_bounds__(256)
bwd_forms_tf32_kernel(const float* __restrict__ q, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ scratch, int H, int Nq, int D, long long sqb,
                      long long sqn, long long sqh, long long sdb, long long sdn, long long sdh,
                      Forms f) {
  __shared__ float tile[32][HD + 1];
  const int j = blockIdx.x, bh = blockIdx.y, t = blockIdx.z, b = bh / H, h = bh % H;
  const float* x = t == 0 ? q + b * sqb + h * sqh : dout + b * sdb + h * sdh;
  const long long xn = t == 0 ? sqn : sdn;
  float* rb = scratch + f.rows(t, 0) + bh * f.plane;
  float* rs = scratch + f.rows(t, 1) + bh * f.plane;
  for (int e = threadIdx.x; e < 32 * HD; e += 256) {
    const int r = e / HD, c = e % HD, n = 32 * j + r;
    const float v = n < Nq && c < D ? x[n * xn + c] : 0.f;
    tile[r][c] = v;
    uint32_t big, small;
    tf32_split(v, big, small);
    rb[(long long)n * HD + c] = __uint_as_float(big);
    rs[(long long)n * HD + c] = __uint_as_float(small);
  }
  __syncthreads();
  float* tb = scratch + f.trans(t, 0) + bh * f.plane;
  float* ts = scratch + f.trans(t, 1) + bh * f.plane;
  for (int e = threadIdx.x; e < 32 * HD; e += 256) {  // tf32_transpose's order
    const int d = e / 32, pos = e % 32, p = pos % 8;
    uint32_t big, small;
    tf32_split(tile[pos - p + (p < 4 ? 2 * p : 2 * p - 7)][d], big, small);
    tb[(long long)d * f.Npad + 32 * j + pos] = __uint_as_float(big);
    ts[(long long)d * f.Npad + 32 * j + pos] = __uint_as_float(small);
  }
  if (t == 0 && threadIdx.x < 32) {
    const int n = 32 * j + threadIdx.x;
    float* st = scratch + f.stats() + (long long)bh * f.Npad + n;
    st[0] = n < Nq ? lse[(long long)bh * Nq + n] * kLog2e : __int_as_float(0x7f800000);
    st[(long long)f.BH * f.Npad] = n < Nq ? delta[(long long)bh * Nq + n] : 0.f;
  }
}

// A step's forms of one tensor from the pre-pass into a slot: rows big and
// small (HD / 32 boxes of 32 columns x 32 rows each), T big and small (one
// box of 32 positions x HD rows each).
template <int HD>
__device__ __forceinline__ void load_forms(unsigned char* p, const CUtensorMap* rows,
                                           const CUtensorMap* trans, uint64_t* bar, int bh,
                                           int BH, int j) {
  constexpr int S = Geom<HD>::kStep;
#pragma unroll
  for (int part = 0; part < 2; ++part) {
#pragma unroll
    for (int pnl = 0; pnl < HD / 32; ++pnl)
      hopper::tma_load_3d(p + part * S + pnl * kRowsPanelBytes<32>, rows, bar, 32 * pnl, 32 * j,
                          part * BH + bh);
    hopper::tma_load_3d(p + (2 + part) * S, trans, bar, 32 * j, 0, part * BH + bh);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkv_tf32_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap rq, const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap rdo, const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tstats, float* __restrict__ dk,
                    float* __restrict__ dv, int BH, int H, int Nq, int Nk, int D, int n_actual,
                    long long sgkb, long long sgkn, long long sgkh, long long sgvb, long long sgvn,
                    long long sgvh, float scale, int pos_k, int pos_v) {
  using G = Geom<HD>;
  constexpr int T = G::kTile, S = G::kStep, NS = G::kSlots;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = wgtile::align1024(smem_raw);
  unsigned char* kv_s = smem;  // per warpgroup: its raw K tile, then its raw V tile
  unsigned char* ring_base = smem + 4 * T;
  float* rows_s = reinterpret_cast<float*>(ring_base + NS * G::kSlot);  // per slot: lse2, delta
  uint64_t* bars = reinterpret_cast<uint64_t*>(rows_s + NS * 64);
  uint64_t* kv_full = bars;
  uint64_t* kv_empty = bars + 1;
  // No transform: the consumers read a slot as TMA fills it.
  const Ring<NS, G::kSlot, 0, kConsumerWarps> ring{ring_base, bars + 2, bars + 2 + NS,
                                                   bars + 2 + 2 * NS};
  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    hopper::mbar_init(kv_empty, kConsumerWarps);
    ring.init();
    hopper::mbar_init_fence();
  }
  __syncthreads();
  const int n_kt = (Nk + 127) / 128, n_items = BH * n_kt;
  const int ns = (Nq + 31) / 32;
  const int lane = threadIdx.x % 32;
  // An item whose keys are all >= n_actual loads nothing and stores zeros.
  auto live = [&](int item) { return item % n_kt * 128 < n_actual; };

  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    hopper::regs_release<kProducerRegs>();
    const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
    if (warp == 0) {
      if (lane == 0) {
        int idx = 0, it = 0;  // ring fills and live items so far
        for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
          if (!live(item)) continue;
          const int bh = item / n_kt, b = bh / H, h = bh % H, row0 = item % n_kt * 128;
          hopper::mbar_wait(kv_empty, (it & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(kv_full, 4 * T);
          for (int w = 0; w < 2; ++w) {
            tf32_load_tile<HD>(kv_s + 2 * w * T, &tk, pos_k, kv_full, h, row0 + 64 * w, b);
            tf32_load_tile<HD>(kv_s + (2 * w + 1) * T, &tv, pos_v, kv_full, h, row0 + 64 * w, b);
          }
          for (int j = 0; j < ns; ++j) {
            unsigned char* p = ring.acquire(idx, 4 * S + 64 * 4);  // Q's forms, lse and delta
            load_forms<HD>(p, &rq, &tq, ring.bar(idx), bh, BH, j);
            float* rows = rows_s + idx % NS * 64;
            hopper::tma_load_3d(rows, &tstats, ring.bar(idx), 32 * j, bh, 0);
            hopper::tma_load_3d(rows + 32, &tstats, ring.bar(idx), 32 * j, bh, 1);
            ++idx;
            load_forms<HD>(ring.acquire(idx, 4 * S), &rdo, &tdo, ring.bar(idx), bh, BH, j);
            ++idx;
          }
          ++it;
        }
      }
    }
  } else {
    hopper::regs_claim<kConsumerRegs>();
    const int tid = threadIdx.x - 128;
    const int wg = tid / 128, warp = (tid / 32) % 4;
    const int g = lane / 4, t4 = lane % 4;
    const float sl2 = scale * kLog2e;
    const unsigned char* k_t = kv_s + 2 * wg * T;
    const unsigned char* v_t = k_t + T;
    int idx = 0, it = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const int bh = item / n_kt, b = bh / H, h = bh % H;
      const int row0 = item % n_kt * 128 + 64 * wg;
      float* gk = dk + b * sgkb + h * sgkh;
      float* gv = dv + b * sgvb + h * sgvh;
      float adk[HD / 2], adv[HD / 2];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) adk[i] = adv[i] = 0.f;
      if (live(item)) {
        bool key_ok[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) key_ok[r] = row0 + 16 * warp + g + 8 * r < n_actual;
        float sdk[HD / 2], sdv[HD / 2];  // the steps' products, added on the FMA units
        hopper::mbar_wait(kv_full, it & 1);
#pragma unroll 1
        for (int j = 0; j < ns; ++j, idx += 2) {
          // S^T = K Q_j^T and dP^T = V dO_j^T: this tile's 64 keys x 32 queries.
          float st[16], dpt[16];
          const unsigned char* qj = ring.wait(idx);
          {
            uint32_t xb[HD / 8][4], xs[HD / 8][4];
            tf32_load_frags<HD>(xb, xs, k_t, warp, g, t4);
            hopper::wgmma_fence();
            abt_rs<HD>(st, xb, xs, qj);
            hopper::wgmma_commit();
            hopper::wgmma_wait<0>();
            hopper::fence_regs(st);
          }
          const unsigned char* gj = ring.wait(idx + 1);
          {
            uint32_t xb[HD / 8][4], xs[HD / 8][4];
            tf32_load_frags<HD>(xb, xs, v_t, warp, g, t4);
            hopper::wgmma_fence();
            abt_rs<HD>(dpt, xb, xs, gj);
            hopper::wgmma_commit();
            hopper::wgmma_wait<0>();
            hopper::fence_regs(dpt);
          }
          dkv_scores(st, dpt, rows_s + idx % NS * 64, key_ok, sl2, t4);
          uint32_t pb[4][4], ps[4][4], db[4][4], ds[4][4];
          tf32_acc_frags<4>(pb, ps, st);
          tf32_acc_frags<4>(db, ds, dpt);
          const bool fresh = j % kFlushSteps == 0;
          if (fresh) {
#pragma unroll
            for (int i = 0; i < HD / 2; ++i) sdk[i] = sdv[i] = 0.f;
          }
          hopper::wgmma_fence();
          ab_rs<HD>(sdv, pb, ps, gj + 2 * S, !fresh);
          ab_rs<HD>(sdk, db, ds, qj + 2 * S, !fresh);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(sdv);
          hopper::fence_regs(sdk);
          if ((j + 1) % kFlushSteps == 0 || j + 1 == ns) {
#pragma unroll
            for (int i = 0; i < HD / 2; ++i) {
              adv[i] += sdv[i];
              adk[i] += sdk[i];
            }
          }
          ring.release(idx, lane);
          ring.release(idx + 1, lane);
        }
        warp_arrive(kv_empty, lane);
        ++it;
      }
      store_rows<HD>(adk, gk, sgkn, row0, Nk, n_actual, D, scale, warp, g, t4);
      store_rows<HD>(adv, gv, sgvn, row0, Nk, n_actual, D, 1.f, warp, g, t4);
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

int grid_for(long long items) { return items < sm_count() ? (int)items : sm_count(); }

// An f32 4-D map over a (B, N, H, D) tensor through its three strides `st`,
// read in boxes of 32 columns (one 128-byte swizzle span a row) x box_rows
// rows: 64 for a kernel's resident tiles, 32 for its streamed steps.
bool encode_map(CUtensorMap* m, int* pos, const void* x, int B, int N, int H, int D,
                const long long* st, int box_rows) {
  return hopper::encode_bnhd_map(m, x, B, N, H, D, st[0], st[1], st[2], 32, box_rows,
                                 CU_TENSOR_MAP_SWIZZLE_128B, pos,
                                 CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, int B, int Nq, int Nk,
                      int H, int D, int n_actual, const long long* st, float scale,
                      cudaStream_t s) {
  using G = Geom<HD>;
  CUtensorMap m[4];
  int pos[4];
  const void* ptrs[4] = {q, k, v, dout};
  const int rows[4] = {Nq, Nk, Nk, Nq}, box[4] = {64, 32, 32, 64};
  for (int i = 0; i < 4; ++i)
    if (!encode_map(&m[i], &pos[i], ptrs[i], B, rows[i], H, D, st + 3 * i, box[i]))
      return cudaErrorInvalidValue;
  cudaError_t err = set_smem(bwd_dq_tf32_kernel<HD>, G::kDqSmem);
  if (err != cudaSuccess) return err;
  const int BH = B * H;
  bwd_dq_tf32_kernel<HD><<<grid_for((long long)BH * ((Nq + 127) / 128)), kThreads, G::kDqSmem,
                           s>>>(m[0], m[1], m[2], m[3], lse, delta, static_cast<float*>(dq), BH,
                                H, Nq, D, n_actual, st[12], st[13], st[14], scale, pos[0], pos[1],
                                pos[2], pos[3]);
  return cudaGetLastError();
}

// A 3-D map over the pre-pass's lse / delta planes (Npad floats a (b, h),
// the delta planes after the lse ones), read 32 floats at a time, no swizzle.
bool encode_stats(CUtensorMap* m, const float* base, const Forms& f) {
  hopper::EncodeTiledFn encode = hopper::encode_tiled_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)f.Npad, (cuuint64_t)f.BH, 2};
  const cuuint64_t strides[2] = {(cuuint64_t)f.Npad * 4, (cuuint64_t)f.BH * f.Npad * 4};
  const cuuint32_t box[3] = {32, 1, 1}, elem[3] = {1, 1, 1};
  return encode(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)
         == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv, float* scratch,
                       int B, int Nq, int Nk, int H, int D, int n_actual, const long long* st,
                       float scale, cudaStream_t s) {
  using G = Geom<HD>;
  const Forms f = forms_of(B, H, Nq, D);
  // K and V raw, in 64-row boxes; q and dO through the pre-pass's forms.
  CUtensorMap mk, mv, fm[5];
  int pos_k, pos_v;
  if (!encode_map(&mk, &pos_k, k, B, Nk, H, D, st + 3, 64)
      || !encode_map(&mv, &pos_v, v, B, Nk, H, D, st + 6, 64))
    return cudaErrorInvalidValue;
  for (int t = 0; t < 2; ++t)
    if (!hopper::encode_planes_f32(&fm[2 * t], scratch + f.rows(t, 0), HD, f.Npad, 2 * f.BH, HD,
                                   f.plane, 32, 32)
        || !hopper::encode_planes_f32(&fm[2 * t + 1], scratch + f.trans(t, 0), f.Npad, HD,
                                      2 * f.BH, f.Npad, f.plane, 32, HD))
      return cudaErrorInvalidValue;
  if (!encode_stats(&fm[4], scratch + f.stats(), f)) return cudaErrorInvalidValue;
  bwd_forms_tf32_kernel<HD><<<dim3(f.Npad / 32, f.BH, 2), 256, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(dout), lse, delta, scratch, H, Nq,
      D, st[0], st[1], st[2], st[9], st[10], st[11], f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if ((err = set_smem(bwd_dkv_tf32_kernel<HD>, G::kDkvSmem)) != cudaSuccess) return err;
  bwd_dkv_tf32_kernel<HD><<<grid_for((long long)f.BH * ((Nk + 127) / 128)), kThreads,
                            G::kDkvSmem, s>>>(
      mk, mv, fm[0], fm[1], fm[2], fm[3], fm[4], static_cast<float*>(dk),
      static_cast<float*>(dv), f.BH, H, Nq, Nk, D, n_actual, st[12], st[13], st[14], st[15],
      st[16], st[17], scale, pos_k, pos_v);
  return cudaGetLastError();
}

}  // namespace

cudaError_t dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dq, int B, int Nq, int Nk, int H, int D, int n_actual,
               const long long* st, float scale, cudaStream_t s) {
  if (D <= 32)
    return launch_dq<32>(q, k, v, dout, lse, delta, dq, B, Nq, Nk, H, D, n_actual, st, scale, s);
  return launch_dq<64>(q, k, v, dout, lse, delta, dq, B, Nq, Nk, H, D, n_actual, st, scale, s);
}

size_t dkv_scratch_floats(int B, int H, int Nq, int D) {
  return (size_t)forms_of(B, H, Nq, D).floats();
}

cudaError_t dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                const float* delta, void* dk, void* dv, float* scratch, int B, int Nq, int Nk,
                int H, int D, int n_actual, const long long* st, float scale, cudaStream_t s) {
  if (scratch == nullptr) return cudaErrorInvalidValue;
  if (D <= 32)
    return launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, scratch, B, Nq, Nk, H, D, n_actual,
                          st, scale, s);
  return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, scratch, B, Nq, Nk, H, D, n_actual, st,
                        scale, s);
}

}  // namespace fabtf32
