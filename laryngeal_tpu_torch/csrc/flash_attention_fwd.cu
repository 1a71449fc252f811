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
// f32 runs the TPU reference semantics in full f32 (the VivitConfig
// default) on the FMA units (TF32 loses the 1e-4 agreement): each thread
// owns a 32-wide slice of one query row and the row's slices combine by
// warp shuffles (flash_attention_fwd.cuh).
// Not yet done (later work): a softmax that overlaps its own warpgroup's
// products without ptxas serialising them, an exp2 polynomial on the FMA
// units for a share of the exponentials, and the f32 paths on the tensor
// cores.

#include "flash_attention_fwd.cuh"
#include "hopper.cuh"
#include "wgmma_tiles.cuh"

namespace {

using namespace flash;
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
  if (kPersistent) {
    static int sms = [] {
      int dev = 0, n = 132;
      if (cudaGetDevice(&dev) == cudaSuccess)
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
      return n;
    }();
    grid = n_items < sms ? n_items : sms;
  }
  fwd_wgmma_kernel<HD, CWG, kLse><<<grid, 128 * (CWG + 1), smem, stream>>>(
      m[0], m[1], m[2], static_cast<__nv_bfloat16*>(o), lse, B * H, H, Nq, D, n_actual, st[9],
      st[10], st[11], scale, pos[0], pos[1], pos[2]);
  return cudaGetLastError();
}

// The design of the last launch of kernel 1 ([0]) and kernel 2 ([1]), as
// launch_fwd chooses it: 0 = FMA (f32), 1 = mma.sync, 2 = wgmma; -1 before
// the first launch. Read through flash_attention_fwd_last_design.
enum Design { kFma = 0, kMmaSync = 1, kWgmma = 2 };
int g_last_design[2] = {-1, -1};

// dtype: 0 = float32, 1 = bfloat16. bf16 runs the wgmma design unless
// `mma_only` or a stride is not positive, else the mma.sync one; f32 the
// FMA kernel (flash_attention_fwd.cuh).
template <bool kLse>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int dtype,
               int B, int Nq, int Nk, int H, int D, int n_actual, const long long* st,
               float scale, bool mma_only, void* stream) {
  if (D <= 0 || D > 128 || D % 8 != 0 || B * H > 65535 || n_actual < 1 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
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
// it). bf16 runs the wgmma design when every q, k and v stride is positive,
// else the mma.sync one. Returns the cudaError_t of the launch (0 =
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

// The two entries above with the mma.sync design for bf16 at every shape
// (the earlier kernels, kept to time the wgmma ones against).
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

// The design (0 = FMA, 1 = mma.sync, 2 = wgmma) of the last launch of kernel
// 1 (which = 0) or kernel 2 (which = 1) through any entry above; -1 before
// the first.
extern "C" int flash_attention_fwd_last_design(int which) {
  return which == 0 || which == 1 ? g_last_design[which] : -1;
}
