// Kernel 10, the tubelet embedding, on warpgroup MMA and the Tensor Memory
// Accelerator for Hopper (sm_90a): the designs "wgmma" (bf16) and
// "wgmma.tf32x3" (f32 on TF32 operands split into two parts, three
// products a product) that tubelet_embed.cu's C entry runs at the
// run-length shapes (kw*C in {16, 32, 48, 64}, W*C and D multiples of 8:
// ViViT-B's stem). Both sources build into one library
// (ops/_build.py), compiled in parallel.
//
// It replaces the Pallas TPU kernel _matmul_kernel of
// laryngeal_tpu/ops/tubelet.py (:73, launched at :94) and computes what
// tubelet_embed.cu's held designs compute: out (B*N, D) = patches (B*N, K)
// x W (K, D) + bias, K = kt*kh*kw*C, the product summed in f32, the bias
// added in f32, the output rounded once to the video's dtype. The patch
// matrix is never written: the video (B, T, H, W, C) is read directly.
//
// What bounds it on the H100: at ViViT-B (M = 25088, K = 1536, D = 768)
// one call is 59.2 GFLOP against ~118 MB (bf16), bound by tensor-core
// operations: 0.060 ms at 989 TFLOP/s; in f32 three TF32 products a
// product, 0.359 ms at 495 TFLOP/s. So the design keeps the tensor cores
// fed: persistent blocks, one an SM, walk output tiles; warpgroup 0's first
// thread fills a ring of stages by TMA, each stage one K-step (dt, dh) of
// the tubelet: the A tile's patch runs and the B tile's rows of W; two
// consumer warpgroups run wgmma with f32 accumulators, 64 rows each.
//
// The A tile. A token's patch row for a fixed K-step is one run of kw*C
// values (96 bytes in bf16 at ViViT-B), and an h'-row's runs lie end to end
// in the video (14 x 96 = 1344 bytes). A tile's rows are slots of 16: a slot
// is one h'-row (n_w <= 16 patches; a longer row takes several slots), one
// box of a 5-D tensor map over the video (run, w', row, frame, clip), so a
// box always lands on an 8-row swizzle group and a 128-row tile is 8 slots
// walked in (b, t', h', chunk) order across clip and frame-pair boundaries:
// 112 tokens a tile at ViViT-B, rows past n_w arrive as zeros, idle in the
// products and never stored. A run of 48 values fills no swizzle atom: the
// bf16 box is 64 values wide (TMA fills the rest of each 128-byte row with
// zeros and fetches none of it; the products stop at kw*C, 3 of 4 k16
// steps at 48); in f32 a run is two boxes, 32 values under the 128-byte
// swizzle and the rest (16 or 32) under the 64- or 128-byte swizzle.
//
// Reading the A tiles cost more than the products (scripts/ablate_tubelet.py:
// with every A box dropped a call took about two thirds of its time), whether
// TMA or 16-byte cp.async copied them, and not for HBM: re-reading tiles that
// stay in L2 cost as much. The blocks that share an M tile asked L2 for the
// same lines at once (every block reading one tile took 3x as long). So the
// CTAs that compute D tiles of one M tile form a thread block cluster (the
// largest of at most 4 that divides the D tiles: ViViT-B's D = 768 is 4
// bf16 tiles of 192, 6 f32 tiles of 128, clusters of 4 and 3): each CTA
// loads its share of the tile's slots and multicasts them into every CTA's
// stage, and a stage is refilled once the consumers of every CTA released
// it (their arrivals go to each CTA's barrier).
//
// The B tile: a pre-pass once a call writes W (K, D) transposed, step-major
// (K-step, D, run) K-major (wgmma reads TF32 B only K-major), into the
// caller's scratch: in bf16 as it is, in f32 as its big and small TF32
// parts (tf32tile::tf32_split). Each CTA loads its own D tile's rows of a
// step by TMA (3-D maps over (run, D, step); a step's rows lie end to end).
//   * bf16 ("wgmma"): 128 x 192 output tiles (896 at ViViT-B), wgmma.m64n192k16
//     with A and B from shared memory, one batch a warpgroup in flight across
//     steps, five 40 KB stages.
//   * f32 ("wgmma.tf32x3"): 128 x 128 tiles; each consumer reads its A
//     fragments from the swizzled tile and splits them in registers, then
//     three wgmma.m64n128k8.tf32 a k8 step (small x big, big x small, big x
//     big, the small x small term dropped: ~2^-22 of each |x w|); each
//     step's products start a fresh accumulator and are added to the f32 sum
//     on the FMA units, so the tensor cores never sum over all of K; three
//     72 KB stages at kw*C = 48.
// The epilogue adds the bias in f32 and stores each row to its token (bf16:
// a quad's four threads exchange their column pairs so that each writes 16
// bytes).

#include <cuda_bf16.h>

#include <type_traits>

#include "hopper.cuh"
#include "tf32_tiles.cuh"
#include "tubelet_embed_wgmma.cuh"

namespace tubwg {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 384;      // warpgroup 0 loads, warpgroups 1-2 compute
constexpr int kConsumerWarps = 8;
constexpr int kSlotRows = 16;      // A rows of one slot (an h'-row of <= 16 patches)
constexpr int kSlots = 8;          // slots a tile
constexpr int kBM = kSlots * kSlotRows;  // 128 rows, 64 a consumer warpgroup
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kMaxSmem = 232448;
constexpr int kSmemSlack = 1024 + 128;  // the base's alignment, the barriers

// Where the rows of a tile come from: slot (b, t', hp, wc) is the 16-patch
// chunk wc of h'-row hp of frame pair t' of clip b; its row i is token m =
// ((b T' + t') n_h + hp) n_w + 16 wc + i, whose run for K-step (dt, dh) is
// video[b, kt t' + dt, kh hp + dh, (16 wc + i) kw .. + kw, :].
struct Geo {
  int D, steps, kh, kt;
  int n_w, n_h, n_t, n_wc;  // patches a row, rows a frame pair, frame pairs a clip,
                            // 16-patch slots a row
  int slots, tiles_m, tiles_n;
  int cluster;              // CTAs of a cluster: D tiles of one M tile at once
};

// Work item w of a cluster: M tile w / (tiles_n / cluster), and the D tiles
// of its (w % (tiles_n / cluster))-th group of `cluster`, one a CTA.
__device__ __forceinline__ void item_tiles(const Geo& g, int w, int rank, int& mt, int& nt) {
  const int groups_n = g.tiles_n / g.cluster;
  mt = w / groups_n;
  nt = w % groups_n * g.cluster + rank;
}

// The tensor maps: a[panel] over the video, b[form][panel] over the
// pre-pass's W^T (bf16: [0][0]; f32: form 0 the big parts, 1 the small).
struct Maps {
  CUtensorMap a[2];
  CUtensorMap b[2][2];
};

// Shared memory of one instance. In bf16 a run of kw*C values (kRun bytes)
// is one 128-byte row of the 128-byte swizzle, TMA filling the rest with
// zeros that the products skip (a 64-byte and a 32-byte panel instead ran
// 7% slower at ViViT-B). In f32 it is two
// panels: panel 0 the first kRow0 bytes (128, or 64 for a 64-byte run),
// panel 1 the rest (kRow1: 0, 64 or 128), each under the swizzle of its
// row's width (192-byte runs at ViViT-B: 128 + 64). A stage holds A (panel
// 0's 128 rows, then panel 1's) and B (each form's panel 0, BN rows, then
// its panel 1).
template <bool kF32, int L>
struct Cfg {
  static constexpr int kBN = kF32 ? 128 : 192;
  static constexpr int kRun = L * (kF32 ? 4 : 2);
  static constexpr int kRow0 = kF32 && kRun < 128 ? kRun : 128;
  static constexpr int kRow1 = kF32 ? kRun - kRow0 : 0;
  static constexpr int kForms = kF32 ? 2 : 1;
  static constexpr int kRow = kRow0 + kRow1;  // bytes of a stage row
  static constexpr int kA = kBM * kRow;
  static constexpr int kBForm = kBN * kRow;
  static constexpr int kStage = kA + kForms * kBForm;
  static constexpr int kFit = (kMaxSmem - kSmemSlack) / kStage;
  static constexpr int kStages = kFit > 8 ? 8 : kFit;
  static constexpr size_t kSmem = kSmemSlack + (size_t)kStages * kStage;
  // k steps of each panel's products: 32 bytes, k16 in bf16 or k8 in f32
  static constexpr int kSteps0 = (kRow0 < kRun ? kRow0 : kRun) / 32, kSteps1 = kRow1 / 32;
  static_assert(kRow1 == 0 || kRow1 == 64 || kRow1 == 128, "an f32 run is two panels");
  static_assert(kStages >= 2, "a stage does not fit twice");
  static_assert(kStage % 1024 == 0 && (kBM * kRow0) % 1024 == 0 && (kBN * kRow0) % 256 == 0,
                "each panel starts on its swizzle's repeat");
};

// The TMA swizzle of a panel of `row`-byte rows (128 or 64).
inline CUtensorMapSwizzle swizzle_of(int row) {
  return row == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
}

// The output row of row i (0-15) of slot `slot`, or -1 if it holds no token.
__device__ __forceinline__ int token_of(const Geo& g, int slot, int i) {
  if (slot >= g.slots) return -1;
  const int wc = slot % g.n_wc, r = slot / g.n_wc;
  const int w = kSlotRows * wc + i;
  return w < g.n_w ? r * g.n_w + w : -1;
}

// The offset of element (row, c) of a 64-byte-swizzled f32 panel (16 floats
// a row): the 16-byte chunk c / 4 of row r at (c / 4) ^ (r / 2 % 4).
__device__ __forceinline__ int sw64_f32(int row, int c) {
  return row * 64 + (((c >> 2) ^ ((row >> 1) & 3)) << 4) + (c & 3) * 4;
}

// This thread's TF32 A fragments of k8 steps [0, KS) of a warpgroup's
// 64-row panel (ROW bytes a row: 128 or 64), split into big and small parts.
template <int KS, int ROW>
__device__ __forceinline__ void split_frags(uint32_t (&big)[4][4], uint32_t (&small)[4][4],
                                            const unsigned char* panel, int warp, int g, int t4) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 16 * warp + g + 8 * (r & 1), c = 8 * ks + t4 + 4 * (r >> 1);
      const int off =
          ROW == 128 ? tf32tile::tf32_frag_offset(ks, r, warp, g, t4) : sw64_f32(row, c);
      tf32tile::tf32_split(*reinterpret_cast<const float*>(panel + off), big[ks][r],
                           small[ks][r]);
    }
}

// acc (+)= A B over k8 steps [0, KS) of one panel pair: three TF32 products
// a step, the small terms first; the first product of the call starts acc
// afresh when `fresh`.
template <int KS, int ROW>
__device__ __forceinline__ void tf32x3_panel(float (&acc)[64], const uint32_t (&big)[4][4],
                                             const uint32_t (&small)[4][4],
                                             const unsigned char* b_big,
                                             const unsigned char* b_small, bool fresh) {
  constexpr uint64_t kLayout = ROW == 128 ? hopper::kLayoutSw128 : hopper::kLayoutSw64;
  const uint64_t db = hopper::smem_desc(b_big, 16, 8 * ROW, kLayout);
  const uint64_t ds = hopper::smem_desc(b_small, 16, 8 * ROW, kLayout);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    hopper::wgmma_m64n128k8_tf32_rs(acc, small[ks], db + 2 * ks, !(fresh && ks == 0));
    hopper::wgmma_m64n128k8_tf32_rs(acc, big[ks], ds + 2 * ks, 1);
    hopper::wgmma_m64n128k8_tf32_rs(acc, big[ks], db + 2 * ks, 1);
  }
}

template <bool kF32, int L>
__global__ void __launch_bounds__(kThreads, 1)
tubelet_wgmma_kernel(const __grid_constant__ Maps maps, const void* __restrict__ bias_p,
                     void* __restrict__ out_p, Geo g) {
  using C = Cfg<kF32, L>;
  using T = typename std::conditional<kF32, float, bf16>::type;
  constexpr int S = C::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * C::kStage);
  uint64_t* empty = full + S;
  // The clusters take work items (item_tiles) in turn.
  const int rank = g.cluster > 1 ? (int)hopper::cluster_rank() : 0;
  const int group = blockIdx.x / g.cluster, groups = gridDim.x / g.cluster;
  const int items = g.tiles_m * (g.tiles_n / g.cluster);
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumerWarps * g.cluster);
    }
    hopper::mbar_init_fence();
  }
  if (g.cluster > 1)
    hopper::cluster_sync();  // every CTA's barriers exist before any peer arrives on them
  else
    __syncthreads();

  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    hopper::regs_release<kProducerRegs>();
    if (threadIdx.x < 32) {
      // Warp 0 issues a stage's loads in parallel: lane j < 8 slot j's A
      // box(es) (a CTA of a cluster its share, multicast to all), lane 8 the
      // B boxes. (One thread issuing them all, its slot coordinates worked
      // out per step, took longer than the products.)
      const int lane = threadIdx.x;
      const uint16_t mask = (uint16_t)((1u << g.cluster) - 1);
      int it = 0;
      for (int w = group; w < items; w += groups) {
        int mt, nt;
        item_tiles(g, w, rank, mt, nt);
        const int n0 = nt * C::kBN;
        const int valid = min(kSlots, g.slots - mt * kSlots);
        const uint32_t bytes = valid * kSlotRows * C::kRow + C::kForms * C::kBForm;
        const int slot = mt * kSlots + lane, r = slot / g.n_wc;
        const bool mine = lane < valid && lane % g.cluster == rank;
        const int c1 = kSlotRows * (slot % g.n_wc), c2 = g.kh * (r % g.n_h);
        const int c3 = g.kt * (r / g.n_h % g.n_t), c4 = r / g.n_h / g.n_t;
        for (int s = 0; s < g.steps; ++s, ++it) {
          const int st = it % S;
          hopper::mbar_wait(&empty[st], ((it / S) & 1) ^ 1);
          if (lane == 0) hopper::mbar_arrive_expect_tx(&full[st], bytes);
          unsigned char* a = smem + st * C::kStage;
          if (mine) {
            const int dh = s % g.kh, dt = s / g.kh;
#pragma unroll
            for (int p = 0; p < (C::kRow1 > 0 ? 2 : 1); ++p) {
              unsigned char* dst = p == 0 ? a + lane * kSlotRows * C::kRow0
                                          : a + kBM * C::kRow0 + lane * kSlotRows * C::kRow1;
              const int c0 = p * C::kRow0 / (kF32 ? 4 : 2);  // the panel's first value
              if (g.cluster > 1)
                hopper::tma_load_5d_multicast(dst, &maps.a[p], &full[st], c0, c1, c2 + dh,
                                              c3 + dt, c4, mask);
              else
                hopper::tma_load_5d(dst, &maps.a[p], &full[st], c0, c1, c2 + dh, c3 + dt, c4);
            }
          }
          if (lane == kSlots) {
            unsigned char* bt = a + C::kA;
#pragma unroll
            for (int f = 0; f < C::kForms; ++f) {
              hopper::tma_load_3d(bt + f * C::kBForm, &maps.b[f][0], &full[st], 0, n0, s);
              if constexpr (C::kRow1 > 0)
                hopper::tma_load_3d(bt + f * C::kBForm + C::kBN * C::kRow0, &maps.b[f][1],
                                    &full[st], C::kRow0 / (kF32 ? 4 : 2), n0, s);
            }
          }
        }
      }
    }
  } else {
    hopper::regs_claim<kConsumerRegs>();
    const int tid = threadIdx.x - 128, wg = tid / 128;
    const int warp = (tid % 128) / 32, lane = tid % 32, g8 = lane / 4, t4 = lane % 4;
    const T* bias = static_cast<const T*>(bias_p);
    T* out = static_cast<T*>(out_p);
    // A stage is refilled once the consumers of every CTA of the cluster let
    // it go: each warp arrives on each CTA's barrier (lane c on CTA c's).
    auto release = [&](int st) {
      __syncwarp();
      if (lane == rank)
        hopper::mbar_arrive(&empty[st]);
      else if (lane < g.cluster)
        hopper::mbar_arrive_cluster(&empty[st], lane);
    };
    int it = 0;
    for (int w = group; w < items; w += groups) {
      int mt, nt;
      item_tiles(g, w, rank, mt, nt);
      const int n0 = nt * C::kBN;
      constexpr int kAcc = kF32 ? 64 : 96;
      float acc[kAcc], sum[kF32 ? 64 : 1];
      int prev = -1;  // bf16: the stage of the batch still in flight
      for (int s = 0; s < g.steps; ++s, ++it) {
        const int st = it % S;
        hopper::mbar_wait(&full[st], (it / S) & 1);
        const unsigned char* a = smem + st * C::kStage;
        const unsigned char* b = a + C::kA;
        if constexpr (!kF32) {
          // One batch in flight across steps: this step's products are
          // issued before the last step's are waited for, and its stage
          // released.
          const uint64_t da =
              hopper::smem_desc(a + wg * 64 * 128, 16, 1024, hopper::kLayoutSw128);
          const uint64_t db = hopper::smem_desc(b, 16, 1024, hopper::kLayoutSw128);
          hopper::wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < C::kSteps0; ++ks)
            hopper::wgmma_m64n192k16_ss(acc, da + 2 * ks, db + 2 * ks, s > 0 || ks > 0);
          hopper::wgmma_commit();
          hopper::wgmma_wait<1>();
          if (prev >= 0) release(prev);
          prev = st;
        } else {
          uint32_t big[4][4], small[4][4];
          split_frags<C::kSteps0, C::kRow0>(big, small, a + wg * 64 * C::kRow0, warp, g8, t4);
          hopper::wgmma_fence();
          tf32x3_panel<C::kSteps0, C::kRow0>(acc, big, small, b, b + C::kBForm, true);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(acc);
          if constexpr (C::kRow1 > 0) {
            split_frags<C::kSteps1, C::kRow1>(
                big, small, a + kBM * C::kRow0 + wg * 64 * C::kRow1, warp, g8, t4);
            hopper::wgmma_fence();
            tf32x3_panel<C::kSteps1, C::kRow1>(acc, big, small, b + C::kBN * C::kRow0,
                                               b + C::kBForm + C::kBN * C::kRow0, false);
            hopper::wgmma_commit();
            hopper::wgmma_wait<0>();
            hopper::fence_regs(acc);
          }
          release(st);  // the stage is read: let it go before the sum
#pragma unroll
          for (int i = 0; i < 64; ++i) sum[i] = s == 0 ? acc[i] : sum[i] + acc[i];
        }
      }
      if constexpr (kF32) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = sum[i];
      } else {
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        if (prev >= 0) release(prev);
      }

      // + bias in f32, one rounding; each row to its token.
      const int row = 64 * wg + 16 * warp + g8;  // rows row and row + 8: one slot
      const int slot = mt * kSlots + row / kSlotRows;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = token_of(g, slot, row % kSlotRows + 8 * r);
        T* orow = out + (long long)(m < 0 ? 0 : m) * g.D;
        if constexpr (kF32) {
          if (m < 0) continue;
#pragma unroll
          for (int j = 0; j < C::kBN / 8; ++j) {
            const int col = n0 + 8 * j + 2 * t4;
            if (col >= g.D) continue;
            const float2 bv = *reinterpret_cast<const float2*>(bias + col);
            *reinterpret_cast<float2*>(orow + col) =
                make_float2(acc[4 * j + 2 * r] + bv.x, acc[4 * j + 2 * r + 1] + bv.y);
          }
        } else {
          // A quad holds 8 columns of a row a group, 2 a thread: four groups
          // at a time are exchanged so that thread t4 stores group 4 k + t4
          // as one 16-byte write (the quad's threads take part even past the
          // row's end: the exchange needs all four).
#pragma unroll
          for (int k = 0; k < C::kBN / 32; ++k) {
            uint32_t mine[4];
#pragma unroll
            for (int d = 0; d < 4; ++d) {
              const int j = 4 * k + d, col = n0 + 8 * j + 2 * t4;
              const float2 bv =
                  col < g.D
                      ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + col))
                      : make_float2(0.f, 0.f);
              const __nv_bfloat162 h = __floats2bfloat162_rn(acc[4 * j + 2 * r] + bv.x,
                                                             acc[4 * j + 2 * r + 1] + bv.y);
              mine[d] = *reinterpret_cast<const uint32_t*>(&h);
            }
            // Round x: thread t4 sends its pair of group t4 ^ x and receives
            // thread (t4 ^ x)'s pair of group t4, its piece t4 ^ x.
            uint32_t got[4];
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              const int want = t4 ^ x;
              const uint32_t send = want & 2 ? (want & 1 ? mine[3] : mine[2])
                                             : (want & 1 ? mine[1] : mine[0]);
              got[x] = __shfl_xor_sync(0xffffffffu, send, x);
            }
            uint32_t piece[4];
#pragma unroll
            for (int p = 0; p < 4; ++p) {
              const int x = p ^ t4;
              piece[p] = x & 2 ? (x & 1 ? got[3] : got[2]) : (x & 1 ? got[1] : got[0]);
            }
            const int col = n0 + 8 * (4 * k + t4);
            if (m >= 0 && col < g.D)
              *reinterpret_cast<uint4*>(orow + col) =
                  make_uint4(piece[0], piece[1], piece[2], piece[3]);
          }
        }
      }
    }
  }
  // No CTA leaves while a peer may still multicast into its stages or
  // arrive on its barriers.
  if (g.cluster > 1) hopper::cluster_sync();
}

// ---------------------------------------------------------------------------
// The pre-pass: W (K, D) into W^T step-major, bf16 as it is, f32 as two parts
// ---------------------------------------------------------------------------

// Element (k, d) of W, k = s L + j, goes to ((s D + d) L + j) of the output.
// R: the element's bits (uint16_t for bf16, copied as they are; uint32_t
// for f32, split into big and small TF32 parts).
template <typename R>
__global__ void __launch_bounds__(256) transpose_w_kernel(const R* __restrict__ w,
                                                          R* __restrict__ big,
                                                          uint32_t* __restrict__ small, int K,
                                                          int D, int L) {
  __shared__ R tile[32][33];
  const int k0 = blockIdx.y * 32, d0 = blockIdx.x * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int k = k0 + i, d = d0 + threadIdx.x;
    if (k < K && d < D) tile[i][threadIdx.x] = w[(long long)k * D + d];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int d = d0 + i, k = k0 + threadIdx.x;
    if (d >= D || k >= K) continue;
    const long long o = ((long long)(k / L) * D + d) * L + k % L;
    if constexpr (sizeof(R) == 4) {
      tf32tile::tf32_split(__uint_as_float(tile[threadIdx.x][i]), big[o], small[o]);
    } else {
      big[o] = tile[threadIdx.x][i];
    }
  }
}

template <bool kF32, int L>
cudaError_t launch_l(const void* video, const void* w, const void* bias, void* out,
                     void* scratch, int B, int T, int H, int W, int Ch, int kt, int kh, int kw,
                     int D, cudaStream_t s) {
  using C = Cfg<kF32, L>;
  const int e = kF32 ? 4 : 2;
  const int K = kt * kh * L, steps = kt * kh;
  Geo g;
  g.D = D;
  g.kh = kh;
  g.kt = kt;
  g.steps = steps;
  g.n_w = W / kw;
  g.n_h = H / kh;
  g.n_t = T / kt;
  g.n_wc = (g.n_w + kSlotRows - 1) / kSlotRows;
  const long long slots = (long long)B * g.n_t * g.n_h * g.n_wc;
  if (slots > 0x7fffffffLL - kSlots) return cudaErrorInvalidValue;
  g.slots = (int)slots;
  g.tiles_m = (g.slots + kSlots - 1) / kSlots;
  g.tiles_n = (D + C::kBN - 1) / C::kBN;
  if ((long long)g.tiles_m * g.tiles_n > 0x7fffffffLL) return cudaErrorInvalidValue;
  // A cluster of 4 or 2 where that divides the D tiles, else none (with
  // clusters of 3 the f32 design ran slower than with none).
  g.cluster = g.tiles_n % 4 == 0 ? 4 : g.tiles_n % 2 == 0 ? 2 : 1;

  // The pre-pass into the scratch: W^T step-major, or its big and small
  // parts.
  unsigned char* wt = static_cast<unsigned char*>(scratch);
  const size_t form_bytes = (size_t)K * D * e;
  using R = typename std::conditional<kF32, uint32_t, uint16_t>::type;
  transpose_w_kernel<R><<<dim3((D + 31) / 32, (K + 31) / 32), dim3(32, 8), 0, s>>>(
      static_cast<const R*>(w), reinterpret_cast<R*>(wt),
      reinterpret_cast<uint32_t*>(wt + form_bytes), K, D, L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  Maps maps;
  const CUtensorMapDataType dtype =
      kF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

  // The video as (run, w', row, frame, clip); a box is one slot's runs, one
  // panel of them (TMA fills rows past n_w with zeros and fetches none).
  const unsigned long long sh = (unsigned long long)W * Ch;
  const unsigned long long a_dims[5] = {(unsigned long long)L, (unsigned long long)g.n_w,
                                        (unsigned long long)H, (unsigned long long)T,
                                        (unsigned long long)B};
  const unsigned long long a_strides[4] = {(unsigned long long)L * e, sh * e, sh * H * e,
                                           sh * H * T * e};
  const unsigned w0 = C::kRow0 / e, w1 = C::kRow1 > 0 ? C::kRow1 / e : 8;  // panel widths
  const unsigned a_box0[5] = {w0, (unsigned)kSlotRows, 1, 1, 1};
  const unsigned a_box1[5] = {w1, (unsigned)kSlotRows, 1, 1, 1};
  if (!hopper::encode_tiled(&maps.a[0], dtype, 5, video, a_dims, a_strides, a_box0,
                            swizzle_of(C::kRow0))
      || (C::kRow1 > 0 && !hopper::encode_tiled(&maps.a[1], dtype, 5, video, a_dims, a_strides,
                                                a_box1, swizzle_of(C::kRow1))))
    return cudaErrorInvalidValue;
  // W^T as (run, D, step).
  const unsigned long long b_dims[3] = {(unsigned long long)L, (unsigned long long)D,
                                        (unsigned long long)steps};
  const unsigned long long b_strides[2] = {(unsigned long long)L * e,
                                           (unsigned long long)D * L * e};
  const unsigned b_box0[3] = {w0, (unsigned)C::kBN, 1};
  const unsigned b_box1[3] = {w1, (unsigned)C::kBN, 1};
  for (int f = 0; f < C::kForms; ++f) {
    const unsigned char* base = wt + f * form_bytes;
    if (!hopper::encode_tiled(&maps.b[f][0], dtype, 3, base, b_dims, b_strides, b_box0,
                              swizzle_of(C::kRow0))
        || (C::kRow1 > 0 && !hopper::encode_tiled(&maps.b[f][1], dtype, 3, base, b_dims,
                                                  b_strides, b_box1, swizzle_of(C::kRow1))))
      return cudaErrorInvalidValue;
  }

  if (C::kSmem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = tubelet_wgmma_kernel<kF32, L>;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)C::kSmem))
      != cudaSuccess)
    return err;
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = C::kSmem;
  config.stream = s;
  config.attrs = attr;
  config.numAttrs = 1;
  // One CTA an SM: as many clusters as fit at once (the cluster shape leaves
  // a few SMs of a GPC idle), each walking its share of the work. The count
  // is asked of the CUDA runtime once a device and cluster size.
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  static int fit[16][3];  // [device][cluster 1, 2, 4], 0 until asked
  int& clusters = fit[dev & 15][g.cluster / 2];
  if (clusters == 0) {
    config.gridDim = dim3(g.cluster);
    if ((err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config)) != cudaSuccess)
      return err;
  }
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  const int items = g.tiles_m * (g.tiles_n / g.cluster);
  config.gridDim = dim3((clusters < items ? clusters : items) * g.cluster);
  if ((err = cudaLaunchKernelEx(&config, kernel, maps, bias, out, g)) != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

bool takes(int C, int W, int kw, int D) {
  const int L = kw * C;
  return (L == 16 || L == 32 || L == 48 || L == 64) && (W * C) % 8 == 0 && D % 8 == 0;
}

size_t scratch_bytes(int dtype, int K, int D) { return (size_t)K * D * (dtype == 1 ? 2 : 8); }

cudaError_t launch(const void* video, const void* w, const void* bias, void* out, void* scratch,
                   int dtype, int B, int T, int H, int W, int C, int kt, int kh, int kw, int D,
                   cudaStream_t s) {
  if (!takes(C, W, kw, D) || scratch == nullptr || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
#define TUBWG_L(L)                                                                            \
  return dtype == 1                                                                           \
             ? launch_l<false, L>(video, w, bias, out, scratch, B, T, H, W, C, kt, kh, kw, D, s) \
             : launch_l<true, L>(video, w, bias, out, scratch, B, T, H, W, C, kt, kh, kw, D, s)
  switch (kw * C) {
    case 16: TUBWG_L(16);
    case 32: TUBWG_L(32);
    case 48: TUBWG_L(48);
    default: TUBWG_L(64);
  }
#undef TUBWG_L
}

}  // namespace tubwg
