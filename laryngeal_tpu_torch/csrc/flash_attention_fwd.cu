// Flash-attention forward for Hopper (sm_90a), bound through a plain C
// interface (ctypes; see laryngeal_tpu_torch/ops/flash_attention.py).
//
// Replaces two Pallas TPU kernels of laryngeal_tpu/ops/flash_attention.py:
//   * _attention_kernel (entry flash_attention_fwd): the forward that every
//     ViViT attention call takes on inference;
//   * _attention_kernel_lse (entry flash_attention_fwd_lse): the same
//     forward plus the per-row log-sum-exp lse = m + log(max(l, 1e-30)) in
//     f32, stored (B, H, Nq) contiguous -- the residual the backward kernels
//     (flash_attention_bwd.cu) recompute P from. Every training forward
//     takes it.
// Both: non-causal online-softmax attention over (B, Nq, H, D) x
// (B, Nk, H, D), keys at index >= n_actual masked with -1e30 (the
// trailing-key / kv_valid mask), P rounded to bf16 before P.V, the row sum
// floored at 1e-30, f32 statistics and accumulation.
//
// What bounds it on the H100, at the ViViT-B bf16 shape (B=8, N=3137,
// H=12, D=64):
//   * products: 4*B*H*N^2*D ~ 2.4e11 FLOP, 0.2445 ms at the 989 TFLOP/s
//     bf16 peak, against ~154 MB of q/k/v/o (0.046 ms at 3.35 TB/s): ~1600
//     FLOP per byte, far above the ~295 FLOP/byte ridge;
//   * exponentials: B*H*N^2 ~ 9.45e8 exp2, ~0.23-0.26 ms on the
//     special-function units (16 a clock an SM) -- as long as the products,
//     so the two have to overlap to get near either;
//   * L2: a block that owns 64 query rows streams its (b, h)'s K and V
//     (803 KB) past them, 50 times a (b, h), ~3.9 GB through L2 a call.
//
// Two designs in bf16 (the C side picks one per call, launch_fwd, and
// flash_attention_fwd_last_design reports which ran):
//   * wgmma (every head dim <= 128, whenever TMA can describe q, k and v:
//     every batch, sequence and head stride positive). A work item is 64
//     query rows per consumer warpgroup of one (b, h): CWG = 3 consumers
//     (192 rows) at D <= 64, 2 at 128, so each K/V tile feeds three times
//     the rows it fed the mma.sync design, a third of its L2 traffic. One
//     persistent block an SM walks the items; its producer thread loads an
//     item's Q once with TMA, then streams 64-key K and V tiles through a
//     4-deep mbarrier ring, K and V on barriers of their own, running on
//     across items (the next item's Q loads while this one computes). A
//     consumer warpgroup holds its Q rows in registers as the A operand of
//     S = Q K^T (RS wgmma: at n = 64 an SS product's operand reads from
//     shared memory cost as much as the product) and, per key step, runs
//     the online softmax of the step's S from its accumulators (base 2,
//     ex2.approx, the row max reduced over the quad that shares a row),
//     rescales O, packs P to bf16 -- the accumulators are already the A
//     fragments of the next product -- and issues O += P V (RS wgmma, V
//     read MN-major) with the next step's S as one batch, which it waits
//     for in the same iteration (a batch in flight across the loop edge, or
//     non-wgmma code between a batch's products, makes ptxas serialise
//     every wgmma: C7515, C7513). The exponentials overlap the products
//     across warpgroups: one warpgroup's softmax runs while the others'
//     batches run on the tensor cores (scripts/ablate_flash_fwd.py times
//     the schedules that overlap them inside a warpgroup, turns, 128-key
//     steps and the ring depth against it). Keys >= n_actual are masked
//     only in the last step (a template flag); TMA fills rows past Nq or Nk
//     with zeros, rows past Nq are never stored. O is scaled by 1/l,
//     rounded to bf16 and stored directly; kernel 2 stores lse.
//   * mma.sync (strides of 0, which TMA cannot describe; kept callable at
//     every shape as the _mma entries, to time against): the template in
//     flash_attention_fwd.cuh, shared with kernel 5. mma.sync.m16n8k16, a
//     block of 4 warps owns 64 query rows (16 per warp); K/V stream through
//     shared memory in 64-key tiles, double-buffered with cp.async. Q, K
//     and V fragments come from shared memory through ldmatrix (.trans for
//     V); rows are padded by 8 elements so those reads are free of bank
//     conflicts. P stays in registers.
// f32 keeps the TPU reference semantics in f32 (the VivitConfig default):
// f32 logits, statistics and accumulation, P unrounded. Two designs:
//   * wgmma.tf32x3 (D <= 64, every stride positive): the products run on
//     the tensor cores in TF32, which alone keeps 10 mantissa bits and
//     misses the 1e-4 agreement (2-4e-4 in the CPU emulation of
//     tests/test_torch_flash_attention.py). Each operand x is split into
//     big (x with its low 13 bits masked) and small = tf32(x - big)
//     (cvt.rna), and each product is small.big + big.small + big.big,
//     three wgmma.m64nNk8.tf32: the dropped small.small term and the
//     rounding of small leave ~2^-20 of |x||y|, near f32's own error (the
//     split of sdpa's f32 memory-efficient backend, CUTLASS's 3xTF32, there
//     on mma.sync). Both parts have their low 13 bits zero, so the result
//     does not depend on how the tensor cores read an f32 register as TF32.
//     Bound at the ViViT-B shape: 3 x 2.42e11 FLOP at the 495 TFLOP/s
//     TF32 peak, 1.47 ms. TF32 wgmma reads both operands K-major only, so
//     V must be transposed for P V: the producer's warpgroup has warp 0
//     issue TMA (Q; K and V tiles into rings of their own) and warps 1-3
//     turn each K tile into its two parts (big in place, small beside it)
//     and each V tile into V^T's two parts, with P's keys 2t and 2t + 1 of
//     every 8 taking positions t and t + 4, so that the S accumulators are
//     P's A fragments without a shuffle. Two consumer warpgroups (128 query
//     rows an item; Q's big part, the next S, P's parts, the step's P V and
//     O take ~200 registers a thread; Q's small part is read from shared
//     memory), a persistent block an SM, and per step the softmax, then
//     P V and the next step's S as one batch, as in bf16. Each step's P V
//     goes to an accumulator of its own and is added to O on the FMA units:
//     the tensor cores' running sum over all N keys lost ten times the FMA
//     kernel's error. What bounds it (scripts/ablate_flash_fwd.py
//     --f32): the transform warps, whose work alone takes ~60% of the
//     kernel's time, more than the TMA loads (~12%), and the consumers'
//     chain (~77% without the transform). D = 128 (O and Q's parts would
//     not fit the registers) and strides of 0 stay on FMA.
//   * FMA (the rest, and the _mma entries at every shape): each thread owns
//     a 32-wide slice of one query row and the row's slices combine by warp
//     shuffles (flash_attention_fwd.cuh).
// Not yet done (later work): a softmax that overlaps its own warpgroup's
// products without ptxas serialising them, and an exp2 polynomial on the
// FMA units for a share of the exponentials.

#include "flash_attention_fwd.cuh"
#include "hopper.cuh"
#include "tf32_tiles.cuh"
#include "wgmma_tiles.cuh"

namespace {

using namespace flash;
using namespace tf32tile;
using namespace wgtile;

// ---------------------------------------------------------------------------
// bf16 on wgmma and TMA
// ---------------------------------------------------------------------------

// Consumer warpgroups a block (64 query rows each): three at HD <= 64, two
// at 128 (its O accumulators need more registers).
template <int HD>
constexpr int kFwdWarpgroups = HD <= 64 ? 3 : 2;
// 64-key tiles a step of the ring (one K tile and one V tile each).
template <int HD>
constexpr int kKeyTiles = 1;
// How a consumer warpgroup orders a step's products and softmax: kBatch
// runs the step's softmax, then issues P V with the next step's S = Q K^T
// as one batch; kNextSOverlap issues the next step's S, runs this step's
// softmax while it runs, then issues P V.
enum Schedule { kBatch, kNextSOverlap };
constexpr Schedule kSchedule = kBatch;
// The consumer warpgroups take turns issuing P V (named barriers, a ring).
constexpr bool kTurns = false;
// Q as the register A operand of S = Q K^T (RS wgmma; false: SS, Q read
// from shared memory by every product).
constexpr bool kQRegs = true;
// One block an SM walking the work items (false: one block an item).
constexpr bool kPersistent = true;

template <int HD>
struct FwdGeom : WgTile<HD> {
  using WgTile<HD>::kTileBytes;
  static constexpr int kStages = 4;  // ring steps in flight
  static constexpr int kStepTiles = kKeyTiles<HD>;
  // Q: CWG tiles; the ring: kStages x (kStepTiles K tiles, then as many V
  // tiles); the barriers full_k, full_v, empty (kStages each), q_full and
  // q_empty; 1024 B of slack for the base alignment.
  __host__ __device__ static constexpr size_t smem_bytes(int cwg) {
    return (size_t)(cwg + 2 * kStepTiles * kStages) * kTileBytes
           + (3 * kStages + 2) * sizeof(uint64_t) + 1024;
  }
};

// One step's online softmax for this thread's rows g and g + 8, in place:
// s (raw Q K^T accumulators of KT 64-key tiles) becomes P = exp2(s sl2 - m)
// with m the new running max (base-2 units), keys >= n_valid of the step
// masked when TAIL; l (this thread's partial row sums) and m are updated,
// alpha is the factor the O accumulators take, and pa holds P packed to
// bf16 as the k16 A fragments of P V. Element i of tile j sits at column
// 64 j + 8 (i / 4) + 2 t4 + (i & 1) of row g + 8 ((i / 2) & 1).
template <int KT, bool TAIL>
__device__ __forceinline__ void softmax_tile(float (&s)[KT][32], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], uint32_t (&pa)[KT][4][4],
                                             float sl2, int n_valid, int t4) {
  const float neg_inf = __int_as_float(0xff800000);
  float mx[2] = {neg_inf, neg_inf};
#pragma unroll
  for (int j = 0; j < KT; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (TAIL && 64 * j + 8 * (i >> 2) + 2 * t4 + (i & 1) >= n_valid) s[j][i] = neg_inf;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[j][i]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]) * sl2);
    alpha[r] = hopper::exp2_approx(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < KT; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const float p = hopper::exp2_approx(fmaf(s[j][i], sl2, -m[r]));
      l[r] += p;
      s[j][i] = p;
    }
#pragma unroll
  for (int j = 0; j < KT; ++j)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[j][kk][r] = pack_bf16(s[j][8 * kk + 2 * r], s[j][8 * kk + 2 * r + 1]);
}

// Turns of the consumer warpgroups (kTurns): wait for this warpgroup's turn
// (barrier 1 + wg), then hand it to the next one in the ring.
[[maybe_unused]] __device__ __forceinline__ void turn_wait(int wg) {
  hopper::named_sync(1 + wg, 256);
}
template <int CWG>
__device__ __forceinline__ void turn_pass(int wg) {
  hopper::named_arrive(1 + (wg + 1) % CWG, 256);
}

// Kernels 1-2. A work item is (64 CWG query rows, batch * head): Q resident,
// K and V streamed over ceil(n_actual / (64 KT)) steps of KT 64-key tiles.
// With kPersistent one block an SM walks items blockIdx.x, + gridDim.x, ...
// (query tiles fastest, so the blocks at work share their (b, h)'s K and V
// in L2): the producer loads the next item's Q as soon as the consumers
// hold this one's in registers and runs the ring on across items, so an
// item's start and its epilogue overlap its neighbours' loads. Without it,
// one block an item.
template <int HD, int CWG, bool kLse>
__global__ void __launch_bounds__(128 * (CWG + 1), 1)
fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int BH, int H, int Nq, int D, int n_actual,
                 long long sob, long long son, long long soh, float scale, int pos_q, int pos_k,
                 int pos_v) {
  using G = FwdGeom<HD>;
  constexpr int S = G::kStages, KT = G::kStepTiles;
  constexpr int kStepBytes = KT * G::kTileBytes;  // the K (or V) tiles of a step
  // Registers a consumer thread claims from the producer's warpgroup (which
  // keeps 24): 24 + CWG x kRegs <= 512, the 64K-register file over 128 threads.
  constexpr int kRegs = CWG == 2 ? 240 : 160;
  extern __shared__ __align__(1024) unsigned char fwd_smem_raw[];
  unsigned char* smem = align1024(fwd_smem_raw);
  unsigned char* stages = smem + CWG * G::kTileBytes;  // stage s: K tiles, then V tiles
  uint64_t* full_k = reinterpret_cast<uint64_t*>(stages + S * 2 * kStepBytes);
  uint64_t* full_v = full_k + S;
  uint64_t* empty = full_v + S;
  uint64_t* q_full = empty + S;
  uint64_t* q_empty = q_full + 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full_k[s], 1);
      hopper::mbar_init(&full_v[s], 1);
      hopper::mbar_init(&empty[s], 4 * CWG);
    }
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init(q_empty, 4 * CWG);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  const int n_qt = (Nq + 64 * CWG - 1) / (64 * CWG);
  const int n_items = n_qt * BH;
  const int n_steps = (n_actual + 64 * KT - 1) / (64 * KT);

  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    hopper::regs_release<24>();
    if (threadIdx.x == 0) {
      int step = 0;  // ring steps loaded so far, over every item
      for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
        const int bh = item / n_qt, b = bh / H, h = bh % H, row0 = item % n_qt * 64 * CWG;
        hopper::mbar_wait(q_empty, (it & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(q_full, CWG * G::kTileBytes);
        for (int r = 0; r < CWG; ++r)
          wg_load_tile<HD>(smem + r * G::kTileBytes, &tq, pos_q, q_full, h, row0 + 64 * r, b);
        for (int t = 0; t < n_steps; ++t, ++step) {
          const int s = step % S;
          hopper::mbar_wait(&empty[s], ((step / S) & 1) ^ 1);
          unsigned char* st = stages + s * 2 * kStepBytes;
          hopper::mbar_arrive_expect_tx(&full_k[s], kStepBytes);
          for (int j = 0; j < KT; ++j)
            wg_load_tile<HD>(st + j * G::kTileBytes, &tk, pos_k, &full_k[s], h,
                             (t * KT + j) * 64, b);
          hopper::mbar_arrive_expect_tx(&full_v[s], kStepBytes);
          for (int j = 0; j < KT; ++j)
            wg_load_tile<HD>(st + kStepBytes + j * G::kTileBytes, &tv, pos_v, &full_v[s], h,
                             (t * KT + j) * 64, b);
        }
      }
    }
  } else {
    hopper::regs_claim<kRegs>();
    const int tid = threadIdx.x - 128;
    const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const float sl2 = scale * kLog2e;
    const unsigned char* q_w = smem + wg * G::kTileBytes;
    int step0 = 0;  // the ring step of the item's first key step
    auto k_step = [&](int t) { return stages + (step0 + t) % S * 2 * kStepBytes; };
    Acc<HD> acc;
    float s[KT][32], sn[KT][32];  // this step's scores; the next step's, in flight
    uint32_t pa[KT][4][4];  // P of the step in P V
    float m[2], l[2], alpha[2];
    if (kTurns && wg == CWG - 1) turn_pass<CWG>(wg);  // warpgroup 0 issues first
    uint32_t qa[kQRegs ? HD / 16 : 1][4];
    auto scores = [&](float (&d)[KT][32], int t) {  // d = Q K^T over step t's keys
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        if constexpr (kQRegs)
          wg_abt_rs<HD>(d[j], qa, k_step(t) + j * G::kTileBytes);
        else
          wg_abt<HD>(d[j], q_w, k_step(t) + j * G::kTileBytes);
      }
    };
    auto pv = [&](const uint32_t (&p)[KT][4][4], int t) {  // acc += P V over step t's keys
#pragma unroll
      for (int j = 0; j < KT; ++j)
        wg_ab<HD>(acc, p[j], k_step(t) + kStepBytes + j * G::kTileBytes);
    };
    auto softmax = [&](float (&x)[KT][32], int t, uint32_t (&p)[KT][4][4]) {
      const int n_valid = n_actual - t * 64 * KT;
      if (n_valid < 64 * KT)
        softmax_tile<KT, true>(x, m, l, alpha, p, sl2, n_valid, t4);
      else
        softmax_tile<KT, false>(x, m, l, alpha, p, sl2, n_valid, t4);
    };
    auto rescale = [&]() {
#pragma unroll
      for (int p = 0; p < G::kPanels; ++p)
#pragma unroll
        for (int i = 0; i < G::kPanelCols / 2; ++i) acc[p][i] *= alpha[(i >> 1) & 1];
    };
    auto fence_scores = [&](float (&x)[KT][32]) {
#pragma unroll
      for (int j = 0; j < KT; ++j) hopper::fence_regs(x[j]);
    };
    auto arrive = [&](uint64_t* bar) {  // this warp is done with what `bar` guards
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(bar);
    };
    auto release = [&](int t) { arrive(&empty[(step0 + t) % S]); };  // step t's products done
    auto wait_k = [&](int t) {
      hopper::mbar_wait(&full_k[(step0 + t) % S], ((step0 + t) / S) & 1);
    };
    auto wait_v = [&](int t) {
      hopper::mbar_wait(&full_v[(step0 + t) % S], ((step0 + t) / S) & 1);
    };
    for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
      [[maybe_unused]] const bool last_item = item + gridDim.x >= n_items;
      zero_panels<HD>(acc);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m[r] = kMaskValue;
        l[r] = 0.f;
      }
      hopper::mbar_wait(q_full, it & 1);
      if constexpr (kQRegs) {  // Q in registers: its tile may take the next item's
        wg_load_frags<HD>(qa, q_w, warp, g, t4);
        arrive(q_empty);
      }
      wait_k(0);
      hopper::wgmma_fence();
      scores(sn, 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      fence_scores(sn);
      // Per step t as kSchedule says; each batch is waited for before the
      // iteration ends (a batch in flight across the loop edge makes ptxas
      // serialise every wgmma, C7515). The scores of step t are in `cur`,
      // step t + 1's go to `next` (the loop runs two steps an iteration,
      // the arrays trading places, so no copy); the last step computes its
      // own S again, unused: no branch among the products.
      auto step = [&](int t, float (&cur)[KT][32], float (&next)[KT][32]) {
        const int tn = t + 1 < n_steps ? t + 1 : t;
        if constexpr (kSchedule == kNextSOverlap) {
          wait_k(tn);
          hopper::wgmma_fence();
          scores(next, tn);
          hopper::wgmma_commit();
        }
        softmax(cur, t, pa);
        rescale();
        wait_v(t);
        if constexpr (kSchedule == kBatch) wait_k(tn);
        if constexpr (kTurns) turn_wait(wg);
        hopper::wgmma_fence();
        pv(pa, t);
        if constexpr (kSchedule == kBatch) scores(next, tn);
        hopper::wgmma_commit();
        if constexpr (kTurns)
          if (wg != CWG - 1 || !last_item || t + 1 < n_steps) turn_pass<CWG>(wg);
        hopper::wgmma_wait<0>();
        fence_scores(next);
        fence_panels<HD>(acc);
        release(t);
      };
      for (int t = 0; t < n_steps; t += 2) {
        step(t, sn, s);
        if (t + 1 < n_steps) step(t + 1, s, sn);
      }
      if constexpr (!kQRegs) arrive(q_empty);
      step0 += n_steps;
      const int bh = item / n_qt, b = bh / H, h = bh % H, row0 = item % n_qt * 64 * CWG;
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float l_safe = fmaxf(quad_sum(l[r]), 1e-30f);
        const int row = row0 + 64 * wg + 16 * warp + g + 8 * r;
        if (kLse && t4 == 0 && row < Nq)
          lse[(long long)bh * Nq + row] = m[r] * kLn2 + logf(l_safe);
        inv[r] = 1.f / l_safe;
      }
      wg_store_rows<HD>(acc, o + b * sob + h * soh, son, row0 + 64 * wg, Nq, Nq, D, inv, warp,
                        g, t4);
    }
  }
}

// The wgmma design takes bf16 when TMA can read q, k and v: every batch,
// sequence and head stride positive (a broadcast stride of 0 cannot be
// described to it). `st` holds q, k, v, o strides (batch, sequence, head).
bool wgmma_takes(const long long* st) {
  for (int i = 0; i < 9; ++i)
    if (st[i] <= 0) return false;
  return true;
}

// The card's SM count, read once (one persistent block an SM).
int sm_count() {
  static int sms = [] {
    int dev = 0, n = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return sms;
}

template <int HD, bool kLse>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse,
                         int B, int Nq, int Nk, int H, int D, int n_actual, const long long* st,
                         float scale, cudaStream_t stream) {
  using G = FwdGeom<HD>;
  constexpr int CWG = kFwdWarpgroups<HD>;
  const CUtensorMapSwizzle sw = HD == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap m[3];
  int pos[3];
  const void* ptrs[3] = {q, k, v};
  const int rows[3] = {Nq, Nk, Nk};
  for (int i = 0; i < 3; ++i)
    if (!hopper::encode_bnhd_map(&m[i], ptrs[i], B, rows[i], H, D, st[3 * i], st[3 * i + 1],
                                 st[3 * i + 2], G::kPanelCols, 64, sw, &pos[i]))
      return cudaErrorInvalidValue;
  const size_t smem = G::smem_bytes(CWG);
  cudaError_t err = cudaFuncSetAttribute(fwd_wgmma_kernel<HD, CWG, kLse>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_items = (Nq + 64 * CWG - 1) / (64 * CWG) * B * H;
  int grid = n_items;
  if (kPersistent) grid = n_items < sm_count() ? n_items : sm_count();
  fwd_wgmma_kernel<HD, CWG, kLse><<<grid, 128 * (CWG + 1), smem, stream>>>(
      m[0], m[1], m[2], static_cast<__nv_bfloat16*>(o), lse, B * H, H, Nq, D, n_actual, st[9],
      st[10], st[11], scale, pos[0], pos[1], pos[2]);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 on wgmma and TMA: 3xTF32
// ---------------------------------------------------------------------------

// Transform warps a block (warps 1-3 of the producer's warpgroup).
constexpr int kTransformWarps = 3;
// Registers a thread of the producer's warpgroup keeps, and a consumer
// thread claims: 128 x kTf32ProducerRegs + 256 x kTf32ConsumerRegs <= 64512,
// the 168 a thread the 384-thread block is launched with.
constexpr int kTf32ProducerRegs = 40, kTf32ConsumerRegs = 232;

// Geometry of the f32 design at head dim HD (32: D <= 32; 64: 32 < D <= 64).
// A 64-row tile of q, k or v is HD / 32 panels of 64 rows x 32 f32 (one
// 128-byte swizzle span a row), as TMA writes it; a V^T tile (HD rows x 64
// keys, K-major: the B operand of P V, which TF32 cannot read transposed) is
// two panels of HD rows x 32 keys, written by the transform warps. Two
// consumer warpgroups (64 query rows each): Q's big part, S and the next
// step's S, P's two parts, the step's P V and O take ~200 registers a
// thread, which three warpgroups' 160 cannot hold.
template <int HD>
struct Tf32Geom {
  static constexpr int kCwg = 2;
  static constexpr int kKStages = 2;  // K ring: K (rounded in place to its big part), K small
  static constexpr int kVStages = 2;  // V ring: V as loaded, V^T big, V^T small
  static constexpr int kPanelBytes = 64 * 128;
  static constexpr int kTileBytes = 64 * HD * 4;
  static constexpr int kVtPanelBytes = HD * 128;
  // Q and Q small: kCwg tiles each; the rings; the barriers k_full,
  // k_ready, k_empty (per K stage), v_full, v_ready, v_empty (per V stage),
  // q_full, q_empty; 1024 B of slack for the base alignment.
  static constexpr int kQTiles = 2 * kCwg;
  __host__ __device__ static constexpr size_t smem_bytes() {
    return (size_t)(kQTiles + 2 * kKStages + 3 * kVStages) * kTileBytes
           + (3 * kKStages + 3 * kVStages + 2) * sizeof(uint64_t) + 1024;
  }
};

// d (64 x 64) = Q K^T over one 64-key tile: per k8 step the three products
// Q_small K_big + Q_big K_small + Q_big K_big (3xTF32), Q big from
// registers, Q small from `qs_tile` and K's parts K-major from shared memory.
template <int HD>
__device__ __forceinline__ void tf32_scores(float (&d)[32], const uint32_t (&qb)[HD / 8][4],
                                            const unsigned char* qs_tile,
                                            const unsigned char* kb, const unsigned char* ks) {
  const uint64_t db = hopper::smem_desc(kb, 16, 1024, hopper::kLayoutSw128);
  const uint64_t ds = hopper::smem_desc(ks, 16, 1024, hopper::kLayoutSw128);
  const uint64_t dq = hopper::smem_desc(qs_tile, 16, 1024, hopper::kLayoutSw128);
#pragma unroll
  for (int k = 0; k < HD / 8; ++k) {
    const uint32_t off = (k / 4 * Tf32Geom<HD>::kPanelBytes + k % 4 * 32) >> 4;
    hopper::wgmma_m64n64k8_tf32_ss(d, dq + off, db + off, k > 0);
    hopper::wgmma_m64n64k8_tf32_rs(d, qb[k], ds + off, 1);
    hopper::wgmma_m64n64k8_tf32_rs(d, qb[k], db + off, 1);
  }
}

// acc (64 x HD) = P V over one 64-key tile, 3xTF32: P's parts from
// registers, V^T's parts K-major from shared memory.
template <int HD>
__device__ __forceinline__ void tf32_pv(float (&acc)[HD / 2], const uint32_t (&pb)[8][4],
                                        const uint32_t (&ps)[8][4], const unsigned char* vtb,
                                        const unsigned char* vts) {
  const uint64_t db = hopper::smem_desc(vtb, 16, 1024, hopper::kLayoutSw128);
  const uint64_t ds = hopper::smem_desc(vts, 16, 1024, hopper::kLayoutSw128);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t off = (kk / 4 * Tf32Geom<HD>::kVtPanelBytes + kk % 4 * 32) >> 4;
    tf32_mma_hd<HD>(acc, ps[kk], db + off, kk > 0);
    tf32_mma_hd<HD>(acc, pb[kk], ds + off, 1);
    tf32_mma_hd<HD>(acc, pb[kk], db + off, 1);
  }
}

// One step's online softmax for this thread's rows g and g + 8 (as
// softmax_tile), with P split into its TF32 parts as the A fragments of
// P V. Accumulator element 4 kk + e holds key 8 kk + 2 t4 + (e & 1); the k8
// fragment wants positions t4 and t4 + 4, so P's keys 2 t4 and 2 t4 + 1 of
// each 8 take positions t4 and t4 + 4, and V^T's columns are permuted
// alike (tf32_transpose): the product sums the same pairs.
template <bool TAIL>
__device__ __forceinline__ void tf32_softmax(float (&s)[32], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], uint32_t (&pb)[8][4],
                                             uint32_t (&ps)[8][4], float sl2, int n_valid,
                                             int t4) {
  const float neg_inf = __int_as_float(0xff800000);
  float mx[2] = {neg_inf, neg_inf};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (TAIL && 8 * (i >> 2) + 2 * t4 + (i & 1) >= n_valid) s[i] = neg_inf;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]) * sl2);
    alpha[r] = hopper::exp2_approx(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    const float p = hopper::exp2_approx(fmaf(s[i], sl2, -m[r]));
    l[r] += p;
    s[i] = p;
  }
  // Fragment register r takes accumulator element 0, 2, 1, 3.
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      tf32_split(s[4 * kk + ((r & 1) << 1 | r >> 1)], pb[kk][r], ps[kk][r]);
}

// Kernels 1-2 in f32. A work item is (128 query rows, batch * head); one
// persistent block an SM walks items blockIdx.x, + gridDim.x, ... (query
// tiles fastest). Warp 0 of the producer's warpgroup issues the TMA loads:
// an item's Q, then its K and V tiles into rings of their own. Warps 1-3
// turn each K tile into its TF32 parts and each V tile into V^T's, then
// release it to the consumers. A consumer warpgroup holds its 64 query
// rows' Q parts in registers; per step it runs the online softmax of S,
// rescales O and issues P V with the next step's S as one batch of 48
// wgmma (HD = 64), which it waits for in the same iteration. The last
// step's next S reads the step's V^T (a tile of the same size that is still
// held) and is discarded, so no branch falls among the products.
template <int HD, bool kLse>
__global__ void __launch_bounds__(128 * (Tf32Geom<HD>::kCwg + 1), 1)
fwd_tf32_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, float* __restrict__ o,
                float* __restrict__ lse, int BH, int H, int Nq, int D, int n_actual,
                long long sob, long long son, long long soh, float scale, int pos_q, int pos_k,
                int pos_v) {
  using G = Tf32Geom<HD>;
  constexpr int CWG = G::kCwg, KS = G::kKStages, VS = G::kVStages, T = G::kTileBytes;
  extern __shared__ __align__(1024) unsigned char tf32_smem_raw[];
  unsigned char* smem = align1024(tf32_smem_raw);
  unsigned char* k_ring = smem + G::kQTiles * T;  // stage s: K big (in place), K small
  unsigned char* v_ring = k_ring + KS * 2 * T;  // stage s: V, V^T big, V^T small
  uint64_t* k_full = reinterpret_cast<uint64_t*>(v_ring + VS * 3 * T);
  uint64_t* k_ready = k_full + KS;
  uint64_t* k_empty = k_ready + KS;
  uint64_t* v_full = k_empty + KS;
  uint64_t* v_ready = v_full + VS;
  uint64_t* v_empty = v_ready + VS;
  uint64_t* q_full = v_empty + VS;
  uint64_t* q_empty = q_full + 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < KS; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&k_ready[s], kTransformWarps);
      hopper::mbar_init(&k_empty[s], 4 * CWG);
    }
    for (int s = 0; s < VS; ++s) {
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&v_ready[s], kTransformWarps);
      hopper::mbar_init(&v_empty[s], 4 * CWG);
    }
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init(q_empty, 4 * CWG);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  const int n_qt = (Nq + 64 * CWG - 1) / (64 * CWG);
  const int n_items = n_qt * BH;
  const int n_steps = (n_actual + 63) / 64;
  const int lane = threadIdx.x % 32;

  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    hopper::regs_release<kTf32ProducerRegs>();
    const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
    if (warp == 0) {
      if (lane == 0) {
        int step = 0;  // K and V tiles loaded so far, over every item
        for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
          const int bh = item / n_qt, b = bh / H, h = bh % H, row0 = item % n_qt * 64 * CWG;
          hopper::mbar_wait(q_empty, (it & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(q_full, CWG * T);
          for (int r = 0; r < CWG; ++r)
            tf32_load_tile<HD>(smem + r * T, &tq, pos_q, q_full, h, row0 + 64 * r, b);
          for (int t = 0; t < n_steps; ++t, ++step) {
            const int sk = step % KS, sv = step % VS;
            hopper::mbar_wait(&k_empty[sk], ((step / KS) & 1) ^ 1);
            hopper::mbar_arrive_expect_tx(&k_full[sk], T);
            tf32_load_tile<HD>(k_ring + sk * 2 * T, &tk, pos_k, &k_full[sk], h, 64 * t, b);
            hopper::mbar_wait(&v_empty[sv], ((step / VS) & 1) ^ 1);
            hopper::mbar_arrive_expect_tx(&v_full[sv], T);
            tf32_load_tile<HD>(v_ring + sv * 3 * T, &tv, pos_v, &v_full[sv], h, 64 * t, b);
          }
        }
      }
    } else {
      const int tw = warp - 1;
      int step = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        for (int t = 0; t < n_steps; ++t, ++step) {
          const int sk = step % KS, sv = step % VS;
          unsigned char* kst = k_ring + sk * 2 * T;
          hopper::mbar_wait(&k_full[sk], (step / KS) & 1);
          tf32_split_rows<T, 32 * kTransformWarps>(kst, kst + T, threadIdx.x - 32);
          hopper::fence_async_smem();
          __syncwarp();
          if (lane == 0) hopper::mbar_arrive(&k_ready[sk]);
          unsigned char* vst = v_ring + sv * 3 * T;
          hopper::mbar_wait(&v_full[sv], (step / VS) & 1);
          tf32_transpose<HD, 64, kTransformWarps>(vst, vst + T, vst + 2 * T, tw, lane);
          hopper::fence_async_smem();
          __syncwarp();
          if (lane == 0) hopper::mbar_arrive(&v_ready[sv]);
        }
      }
    }
  } else {
    hopper::regs_claim<kTf32ConsumerRegs>();
    const int tid = threadIdx.x - 128;
    const int wg = tid / 128, warp = (tid / 32) % 4;
    const int g = lane / 4, t4 = lane % 4;
    const float sl2 = scale * kLog2e;
    const unsigned char* q_w = smem + wg * T;
    unsigned char* qs_w = smem + (CWG + wg) * T;  // Q small
    int step0 = 0;  // the ring step of the item's first key step
    // O, and the step's P V: an accumulator of its own, added to O in f32 on
    // the FMA units (O = O alpha + PV, one rounding). With O the wgmma
    // accumulator, the tensor cores' running sum over all N keys lost ~1e-5
    // of O at the ViViT-B shape, ten times the FMA kernel's error, and the
    // full-width f32 gradients, whose query-bias terms are differences of
    // nearly equal sums that take delta = rowsum(dO O), moved past their
    // 1e-4 / 1e-3 limits (scripts/ablate_flash_fwd.py's o_in_tensor_cores).
    float acc[HD / 2], pv[HD / 2];
    float s[32], sn[32];  // this step's scores; the next step's, in flight
    uint32_t qb[HD / 8][4];       // Q's big TF32 part
    uint32_t pb[8][4], ps[8][4];  // P's, the step's A fragments of P V
    float m[2], l[2], alpha[2];
    auto k_tile = [&](int t) { return k_ring + (step0 + t) % KS * 2 * T; };
    auto v_tile = [&](int t) { return v_ring + (step0 + t) % VS * 3 * T; };
    auto arrive = [&](uint64_t* bar) {  // this warp is done with what `bar` guards
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(bar);
    };
    auto wait_k = [&](int t) {
      hopper::mbar_wait(&k_ready[(step0 + t) % KS], ((step0 + t) / KS) & 1);
    };
    auto wait_v = [&](int t) {
      hopper::mbar_wait(&v_ready[(step0 + t) % VS], ((step0 + t) / VS) & 1);
    };
    for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m[r] = kMaskValue;
        l[r] = 0.f;
      }
      hopper::mbar_wait(q_full, it & 1);
      tf32_load_q<HD>(qb, q_w, qs_w, warp, g, t4);
      arrive(q_empty);
      hopper::fence_async_smem();  // Q small written: visible to this warpgroup's wgmma
      hopper::named_sync(1 + wg, 128);
      wait_k(0);
      hopper::wgmma_fence();
      tf32_scores<HD>(sn, qb, qs_w, k_tile(0), k_tile(0) + T);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sn);
      arrive(&k_empty[step0 % KS]);
      // Step t: its scores in `cur`, step t + 1's to `next` (the loop runs
      // two steps an iteration, the arrays trading places).
      auto step = [&](int t, float (&cur)[32], float (&next)[32]) {
        const bool more = t + 1 < n_steps;
        const int n_valid = n_actual - 64 * t;
        if (n_valid < 64)
          tf32_softmax<true>(cur, m, l, alpha, pb, ps, sl2, n_valid, t4);
        else
          tf32_softmax<false>(cur, m, l, alpha, pb, ps, sl2, n_valid, t4);
        wait_v(t);
        if (more) wait_k(t + 1);
        const unsigned char* vt = v_tile(t);
        const unsigned char* kn = more ? k_tile(t + 1) : vt + T;
        const unsigned char* kn_small = more ? kn + T : vt + T;
        hopper::wgmma_fence();
        tf32_pv<HD>(pv, pb, ps, vt + T, vt + 2 * T);
        tf32_scores<HD>(next, qb, qs_w, kn, kn_small);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(next);
        hopper::fence_regs(pv);
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) acc[i] = fmaf(acc[i], alpha[(i >> 1) & 1], pv[i]);
        arrive(&v_empty[(step0 + t) % VS]);
        if (more) arrive(&k_empty[(step0 + t + 1) % KS]);
      };
      for (int t = 0; t < n_steps; t += 2) {
        step(t, sn, s);
        if (t + 1 < n_steps) step(t + 1, s, sn);
      }
      step0 += n_steps;
      const int bh = item / n_qt, b = bh / H, h = bh % H, row0 = item % n_qt * 64 * CWG;
      float* ob = o + b * sob + h * soh;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float l_safe = fmaxf(quad_sum(l[r]), 1e-30f);
        const int row = row0 + 64 * wg + 16 * warp + g + 8 * r;
        if (row >= Nq) continue;
        if (kLse && t4 == 0) lse[(long long)bh * Nq + row] = m[r] * kLn2 + logf(l_safe);
        const float inv = 1.f / l_safe;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          const int col = 8 * j + 2 * t4;
          if (col < D)
            *reinterpret_cast<float2*>(ob + row * son + col) =
                make_float2(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
        }
      }
    }
  }
}

template <int HD, bool kLse>
cudaError_t launch_tf32(const void* q, const void* k, const void* v, void* o, float* lse,
                        int B, int Nq, int Nk, int H, int D, int n_actual, const long long* st,
                        float scale, cudaStream_t stream) {
  using G = Tf32Geom<HD>;
  CUtensorMap m[3];
  int pos[3];
  const void* ptrs[3] = {q, k, v};
  const int rows[3] = {Nq, Nk, Nk};
  for (int i = 0; i < 3; ++i)
    if (!hopper::encode_bnhd_map(&m[i], ptrs[i], B, rows[i], H, D, st[3 * i], st[3 * i + 1],
                                 st[3 * i + 2], 32, 64, CU_TENSOR_MAP_SWIZZLE_128B, &pos[i],
                                 CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
      return cudaErrorInvalidValue;
  const size_t smem = G::smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(fwd_tf32_kernel<HD, kLse>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_items = (Nq + 64 * G::kCwg - 1) / (64 * G::kCwg) * B * H;
  const int grid = n_items < sm_count() ? n_items : sm_count();
  fwd_tf32_kernel<HD, kLse><<<grid, 128 * (G::kCwg + 1), smem, stream>>>(
      m[0], m[1], m[2], static_cast<float*>(o), lse, B * H, H, Nq, D, n_actual, st[9], st[10],
      st[11], scale, pos[0], pos[1], pos[2]);
  return cudaGetLastError();
}

// The design of the last launch of kernel 1 ([0]) and kernel 2 ([1]), as
// launch_fwd chooses it: 0 = FMA (f32), 1 = mma.sync, 2 = wgmma (bf16),
// 3 = wgmma.tf32x3 (f32); -1 before the first launch. Read through
// flash_attention_fwd_last_design.
enum Design { kFma = 0, kMmaSync = 1, kWgmma = 2, kWgmmaTf32 = 3 };
int g_last_design[2] = {-1, -1};

// dtype: 0 = float32, 1 = bfloat16. Unless `mma_only`, and when every
// stride is positive: bf16 runs the wgmma design, f32 at D <= 64 the
// wgmma.tf32x3 one. Otherwise bf16 runs the mma.sync design and f32 the FMA
// kernel (flash_attention_fwd.cuh).
template <bool kLse>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int dtype,
               int B, int Nq, int Nk, int H, int D, int n_actual, const long long* st,
               float scale, bool mma_only, void* stream) {
  if (D <= 0 || D > 128 || D % 8 != 0 || B * H > 65535 || n_actual < 1 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && !mma_only && D <= 64 && wgmma_takes(st)) {
    g_last_design[kLse] = kWgmmaTf32;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (D <= 32)
      return (int)launch_tf32<32, kLse>(q, k, v, o, lse, B, Nq, Nk, H, D, n_actual, st, scale, s);
    return (int)launch_tf32<64, kLse>(q, k, v, o, lse, B, Nq, Nk, H, D, n_actual, st, scale, s);
  }
  if (dtype == 1 && !mma_only && wgmma_takes(st)) {
    g_last_design[kLse] = kWgmma;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (D <= 32)
      return (int)launch_wgmma<32, kLse>(q, k, v, o, lse, B, Nq, Nk, H, D, n_actual, st, scale, s);
    if (D <= 64)
      return (int)launch_wgmma<64, kLse>(q, k, v, o, lse, B, Nq, Nk, H, D, n_actual, st, scale, s);
    return (int)launch_wgmma<128, kLse>(q, k, v, o, lse, B, Nq, Nk, H, D, n_actual, st, scale, s);
  }
  g_last_design[kLse] = dtype == 1 ? kMmaSync : kFma;
  return flash_fwd::launch<kLse, 0>(q, k, v, o, lse, dtype, B, Nq, Nk, H, D, n_actual, st,
                                    scale, flash_fwd::kNoBias, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the head-dim
// stride must be 1, D a multiple of 8 (<= 128), every stride a multiple of
// 8 and every pointer 16-byte aligned (the Python wrapper guarantees all of
// it). When every q, k and v stride is positive bf16 runs the wgmma design
// and f32 at D <= 64 the wgmma.tf32x3 one; else bf16 runs the mma.sync
// design and f32 the FMA kernel. Returns the cudaError_t of the launch (0 =
// success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int dtype, int B, int Nq, int Nk,
                                   int H, int D, int n_actual,
                                   long long sqb, long long sqn, long long sqh,
                                   long long skb, long long skn, long long skh,
                                   long long svb, long long svn, long long svh,
                                   long long sob, long long son, long long soh,
                                   float scale, void* stream) {
  const long long st[12] = {sqb, sqn, sqh, skb, skn, skh,
                            svb, svn, svh, sob, son, soh};
  return launch_fwd<false>(q, k, v, o, nullptr, dtype, B, Nq, Nk, H, D, n_actual, st, scale,
                           false, stream);
}

// As flash_attention_fwd, plus lse: float32 (B, H, Nq) contiguous, the
// natural-log log-sum-exp of each query row's masked, scaled logits.
extern "C" int flash_attention_fwd_lse(const void* q, const void* k, const void* v,
                                       void* o, void* lse, int dtype, int B, int Nq,
                                       int Nk, int H, int D, int n_actual,
                                       long long sqb, long long sqn, long long sqh,
                                       long long skb, long long skn, long long skh,
                                       long long svb, long long svn, long long svh,
                                       long long sob, long long son, long long soh,
                                       float scale, void* stream) {
  const long long st[12] = {sqb, sqn, sqh, skb, skn, skh,
                            svb, svn, svh, sob, son, soh};
  return launch_fwd<true>(q, k, v, o, static_cast<float*>(lse), dtype, B, Nq, Nk, H, D,
                          n_actual, st, scale, false, stream);
}

// The two entries above with the mma.sync design for bf16 and the FMA
// kernel for f32 at every shape (the earlier kernels, kept to time the
// wgmma ones against).
extern "C" int flash_attention_fwd_mma(const void* q, const void* k, const void* v,
                                       void* o, int dtype, int B, int Nq, int Nk,
                                       int H, int D, int n_actual,
                                       long long sqb, long long sqn, long long sqh,
                                       long long skb, long long skn, long long skh,
                                       long long svb, long long svn, long long svh,
                                       long long sob, long long son, long long soh,
                                       float scale, void* stream) {
  const long long st[12] = {sqb, sqn, sqh, skb, skn, skh,
                            svb, svn, svh, sob, son, soh};
  return launch_fwd<false>(q, k, v, o, nullptr, dtype, B, Nq, Nk, H, D, n_actual, st, scale,
                           true, stream);
}

extern "C" int flash_attention_fwd_lse_mma(const void* q, const void* k, const void* v,
                                           void* o, void* lse, int dtype, int B, int Nq,
                                           int Nk, int H, int D, int n_actual,
                                           long long sqb, long long sqn, long long sqh,
                                           long long skb, long long skn, long long skh,
                                           long long svb, long long svn, long long svh,
                                           long long sob, long long son, long long soh,
                                           float scale, void* stream) {
  const long long st[12] = {sqb, sqn, sqh, skb, skn, skh,
                            svb, svn, svh, sob, son, soh};
  return launch_fwd<true>(q, k, v, o, static_cast<float*>(lse), dtype, B, Nq, Nk, H, D,
                          n_actual, st, scale, true, stream);
}

// The design (0 = FMA, 1 = mma.sync, 2 = wgmma, 3 = wgmma.tf32x3) of the
// last launch of kernel 1 (which = 0) or kernel 2 (which = 1) through any
// entry above; -1 before the first.
extern "C" int flash_attention_fwd_last_design(int which) {
  return which == 0 || which == 1 ? g_last_design[which] : -1;
}
