// Swin3D shifted-window attention, kernels 8 (forward) and 9 (backward), on
// warpgroup MMA and the Tensor Memory Accelerator for Hopper (sm_90a). It
// holds the bfloat16 design that window_attention.cu's C entries
// (window_attention_fwd / window_attention_bwd) run wherever it takes the
// call (winwg::takes): N <= 400, D <= 32 after padding to a multiple of 8,
// every (window, position, head) stride positive; and, below ("f32 on the
// tensor cores"), the float32 design at the same shapes (winwg::takes_tf32).
// Both sources build into one library (ops/_build.py), compiled in parallel.
//
// It replaces the Pallas TPU kernels laryngeal_tpu/ops/window_attention.py
// :55 _fwd_kernel and :95 _bwd_kernel (and, with the forward's softmax mode
// a template parameter, kernel 11: scripts/bench_window_kernel.py :76
// _fwd_kernel_sm, launched at :124, whose softmax rounds z = S - max to
// bf16 before the exp (mode 1) or takes exp2(z log2e) (mode 2); the row max
// is exchanged over both warpgroups as in mode 0, the sum and the
// normalisation stay f32) and computes what window_attention.cu's held
// mma.sync design computes: per (window w, head h) S = (Q K^T in f32)
// * scale + bias[h], -100 added where the two positions' region ids (row
// w % nW) differ, an exact f32 softmax with P normalised before it is
// rounded to bf16 for P V and dV; the backward takes delta = sum_k P dP from
// the f32 P and dP, ds = P (dP - delta), dQ = (bf16(ds) K) * scale, dK =
// (bf16(ds)^T Q) * scale, dV = bf16(P)^T dO and dbias[h] = the unrounded f32
// ds summed over every window. The bias is f32 and never rounded; q, k, v,
// dO are read through their strides (views of the fused qkv need no copy);
// nothing is summed with atomics, so results are deterministic.
//
// What bounds it on the H100: at Swin3D-T's stage 1 (1024 windows, 3 heads,
// N = 392, D = 32) the bytes take ~0.09 ms (forward) and ~0.16 ms
// (backward), but every pass over S costs B nW H N^2 = 4.7e8 exponentials,
// ~0.13 ms on the special-function units (16 a clock an SM), and about as
// much again of f32 work per score (the scale, the bias and the mask, the
// max, the sum, the normalisation, ds). So the design counts passes: the
// forward computes S once; the backward twice (a dQ launch and a dK/dV
// launch, dbias folded into the second), where the held design computed it
// six times over four launches.
//
// The design. A block has three warpgroups: warpgroup 0's first warp loads
// with TMA (4-D tensor maps over the (window, position, head, D) strides,
// 64-byte swizzle, rows past N zero-filled), cp.async (the row statistics)
// and plain loads (the region ids, flagging a window whose ids all name one
// region: there the mask's compares are skipped), and hands its registers
// to the two consumer warpgroups (setmaxnreg). One block runs on an SM (~220 KB of shared memory) and
// walks a group of windows; the host sizes the groups so that the blocks
// fill the card about once.
//   * Forward (kernel 8) and the backward's dQ launch: a block takes one
//     (head, 64-query tile) and holds the tile's 64 x N f32 bias rows in
//     shared memory, copied once (100 KB at N = 392; the row stride is 8
//     floats past a multiple of 32 so that each half-warp's 8-byte reads
//     hit 32 banks). Per window a stage holds the Q tile (and the dO tile),
//     and K and V whole, two stages deep. The consumer warpgroups split the
//     keys, KW = 200 each at N = 392 (3 chunks of 64 keys and one of 8):
//     each computes its 64 x KW of S = Q K^T with wgmma, f32 in registers,
//     and the two exchange each row's max and sum (and, backward, delta)
//     through shared memory at a named barrier, so the softmax is exact in
//     one pass of S. The forward packs P, normalised, as bf16 register A
//     operands of O += P V (V read MN-major); the dQ launch computes dP =
//     dO V^T chunk by chunk for delta, keeps the 8-wide chunk's, writes each
//     row's base-2 log-sum-exp and delta to a scratch buffer, then forms
//     ds = P (dP - delta) chunk by chunk (recomputing dP) as the A operand of
//     dQ += ds K. Warpgroup 1 hands its partial O (dQ) to warpgroup 0 through
//     its spent K/V rows; warpgroup 0 adds and stores.
//   * dK/dV launch: a block takes one (head, 64-key tile) and holds the
//     N x 64 f32 bias columns of its keys (transposed, key-major, the same
//     stride rule). Per window a stage holds the K and V tiles, every
//     query's statistics from the dQ launch and the region ids; Q and dO
//     stream in 64-row chunks through a ring of four slots a warpgroup. The
//     warpgroups split the queries (200 each), 32 at a time: S^T = K Q^T and
//     dP^T = V dO^T, P^T from the statistics, ds^T; dV += P^T dO and dK +=
//     ds^T Q with P^T and ds^T in bf16 as register A operands; and each
//     thread adds its f32 ds^T to its own registers of dbias, 100 a thread,
//     summed over the group's windows in order. Warpgroup 1 hands its
//     partial dK/dV to warpgroup 0 through a shared buffer (a second named
//     barrier says when it is free again); at the end the block writes its
//     dbias partial (the caller sums the groups).
//   * Kernel 12 (window_fwd_heads_kernel): the TPU ablation's schedule of
//     scripts/bench_window_kernel.py :96 _fwd_kernel_h2 (launched at :142),
//     HB heads of one window a program (3 at Swin3D-T's stage 1, 2 at stages
//     2-4), computing kernel 8's function. A block takes (head group, 64-query
//     tile, window group) and walks the group's windows, each window's HB
//     heads in turn: the producer loads a window's region ids once (shared
//     by its heads) and, per (window, head), the Q tile and each warpgroup's
//     key chunks through a ring of 24 KB slots, NC a warpgroup (one slot per
//     chunk, each slot kept by its owner warpgroup): the chunk's K and V rows
//     by TMA and its 64 x 64 f32 bias tile by TMA (two 32-key panels,
//     128-byte swizzle; 64 x 8 for the 8-wide chunk). Three heads' held bias
//     rows (3 x 100 KB at N = 392) do not fit a block, so the bias is
//     streamed (the TMA box needs N % 4 == 0: a bias row of 4 N bytes,
//     a multiple of 16). K and the bias of a slot are released after the
//     logits, V after O += P V, so the next head's K and bias tiles load
//     while this head's softmax and P V run. The arithmetic is kernel 8's:
//     S once, the exact softmax split over the two warpgroups, P V, the
//     hand-over of warpgroup 1's partial O.
// Every register array is indexed statically: the key (query) width is a
// template parameter, KW = 72, 136 or 200 (64 c + 8).

#include <algorithm>

#include "flash_attention_common.cuh"
#include "hopper.cuh"
#include "wgmma_tiles.cuh"
#include "window_attention_wgmma.cuh"

namespace winwg {
namespace {

using namespace flash;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 384;       // warpgroup 0 loads, warpgroups 1-2 compute
constexpr int kConsumers = 256;
constexpr int kConsumerWarps = 8;
constexpr int kTile = 4096;         // 64 rows x 32 bf16, 64-byte swizzle
constexpr int kIds = kMaxN + 16;     // region ids held a window (> every index read), then
                                    // at kIds - 1 whether the window holds two regions
constexpr int kRing = 4;            // Q/dO chunk slots a consumer warpgroup (dK/dV launch)
constexpr int kBar = 1;             // named barrier of the two consumer warpgroups
constexpr int kXchBar = 2;          // forward, dQ: warpgroup 1's partial is in shared memory;
                                    // dK/dV: the exchange buffer is free again
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kMaxSmem = 232448;
constexpr float kRegion = -100.f;   // torchvision's shifted-window mask

// A warpgroup's width KW (keys in the forward and the dQ launch, queries in
// the dK/dV launch): 64-wide chunks and a last one 8 wide. K and V are held
// 2 KW + 8 rows each, warpgroup i's from row i KW, the last 8 rows zero, so
// that the 8-wide chunk's k16 step in O += P V and dQ += ds K reads the next
// warpgroup's rows or zeros (times P = 0).
template <int KW>
struct Geo {
  static_assert(KW == 72 || KW == 136 || KW == 200, "a warpgroup's width is 64 c + 8");
  static constexpr int kChunks = KW / 64 + 1;
  static constexpr int kRows = (2 * KW + 8) * 64;  // bytes of K (or V) in a stage
};

// Element i of chunk c is live: all 32 of a 64-wide chunk, 0-3 of the last.
template <int NC>
__device__ __forceinline__ constexpr bool live(int c, int i) { return c < NC - 1 || i < 4; }

// Row stride of the held bias (floats): >= N, 8 past a multiple of 16.
__host__ __device__ __forceinline__ int bias_stride(int N) { return 16 * ((N + 7) / 16) + 8; }

// One window logit in the JAX kernel's order: (dot * scale) + bias, then
// + (-100) across region boundaries; no contraction into an FMA.
__device__ __forceinline__ float logit(float dot, float scale, float b, bool differ) {
  const float x = __fadd_rn(__fmul_rn(dot, scale), b);
  return differ ? __fadd_rn(x, kRegion) : x;
}

// 4-byte async copy to shared memory (zeros when !ok).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(hopper::smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0) : "memory");
}
// One arrival on `bar` once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n"
               :: "r"(hopper::smem_u32(bar)) : "memory");
}

template <int K, int N>
__device__ __forceinline__ void fence_first(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d = A B^T over the head dim (32: two k16 steps) for a 64-row tile A and
// the first W (64, 32 or 8) rows from B, both K-major 64-byte-swizzled
// tiles: d[0 .. W / 2).
template <int W, int N>
__device__ __forceinline__ void abt(float (&d)[N], const unsigned char* a,
                                    const unsigned char* b) {
  static_assert(W == 64 || W == 32 || W == 8, "a step is 64, 32 or 8 rows of B");
  const uint64_t da = hopper::smem_desc(a, 16, 512, hopper::kLayoutSw64);
  const uint64_t db = hopper::smem_desc(b, 16, 512, hopper::kLayoutSw64);
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    if constexpr (W == 64)
      hopper::wgmma_m64n64k16_ss(d, da + 2 * ks, db + 2 * ks, ks > 0);
    else if constexpr (W == 32)
      hopper::wgmma_m64n32k16_ss(d, da + 2 * ks, db + 2 * ks, ks > 0);
    else
      hopper::wgmma_m64n8k16_ss(d, da + 2 * ks, db + 2 * ks, ks > 0);
  }
}

// A warpgroup's 64 x KW scores: A B^T over its NC chunks of B's rows, the
// chunks STRIDE bytes apart.
template <int NC, int STRIDE = kTile>
__device__ __forceinline__ void scores(float (&s)[NC][32], const unsigned char* a,
                                       const unsigned char* b) {
  hopper::wgmma_fence();
#pragma unroll
  for (int c = 0; c < NC - 1; ++c) abt<64>(s[c], a, b + c * STRIDE);
  abt<8>(s[NC - 1], a, b + (NC - 1) * STRIDE);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < NC - 1; ++c) hopper::fence_regs(s[c]);
  fence_first<4>(s[NC - 1]);
}

// The A fragments (k16 steps [0, KK)) of a 64-wide accumulator rounded to
// bf16; elements past LIVE are zero.
template <int KK, int LIVE, int N>
__device__ __forceinline__ void pack(uint32_t (&a)[4][4], const float (&x)[N]) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 8 * kk + 2 * r;
      a[kk][r] = i < LIVE ? pack_bf16(x[i % N], x[(i + 1) % N]) : 0u;
    }
}

// ds = P (dP - delta) of rows g and g + 8, rounded to bf16 as A fragments.
template <int KK, int LIVE, int N>
__device__ __forceinline__ void pack_ds(uint32_t (&a)[4][4], const float (&p)[32],
                                        const float (&dp)[N], const float (&dl)[2]) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 8 * kk + 2 * r, j = i % N, j1 = (i + 1) % N;
      a[kk][r] = i < LIVE ? pack_bf16(p[i] * (dp[j] - dl[r & 1]), p[i + 1] * (dp[j1] - dl[r & 1]))
                          : 0u;
    }
}

// Scores of one warpgroup's keys [key0, key0 + KW) to logits in place, rows
// as queries: bias(c, j, r) is the bias pair of the thread's row g + 8 r at
// keys key0 + 64 c + 8 j + 2 t4 (+ 1), kid the region ids from key0 (null:
// no mask) and id0, id1 the rows' own. Keys >= N get kMaskValue: every
// block is computed alike (reads past key N - 1 stay inside shared memory
// and are discarded), then the block holding key N - 1 (or past it) masks
// its keys one by one.
template <int NC, typename Bias>
__device__ __forceinline__ void logits(float (&s)[NC][32], Bias bias, const int* kid, int id0,
                                       int id1, int key0, int N, float scale, int t4) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (!live<NC>(c, 4 * j)) continue;
      const int col = 64 * c + 8 * j + 2 * t4;
      float* e = &s[c][4 * j];
      const float2 x0 = bias(c, j, 0);
      const float2 x1 = bias(c, j, 1);
      bool d00 = false, d01 = false, d10 = false, d11 = false;
      if (kid != nullptr) {
        const int2 ki = *reinterpret_cast<const int2*>(kid + col);
        d00 = ki.x != id0;
        d01 = ki.y != id0;
        d10 = ki.x != id1;
        d11 = ki.y != id1;
      }
      e[0] = logit(e[0], scale, x0.x, d00);
      e[1] = logit(e[1], scale, x0.y, d01);
      e[2] = logit(e[2], scale, x1.x, d10);
      e[3] = logit(e[3], scale, x1.y, d11);
      if (key0 + 64 * c + 8 * j + 8 > N) {
        if (key0 + col >= N) e[0] = e[2] = kMaskValue;
        if (key0 + col + 1 >= N) e[1] = e[3] = kMaskValue;
      }
    }
}

// logits with the bias from held rows: b0, b1 are the bias rows of the
// thread's rows g and g + 8 from key0.
template <int NC>
__device__ __forceinline__ void row_logits(float (&s)[NC][32], const float* b0, const float* b1,
                                           const int* kid, int id0, int id1, int key0, int N,
                                           float scale, int t4) {
  logits<NC>(
      s,
      [&](int c, int j, int r) {
        return *reinterpret_cast<const float2*>((r ? b1 : b0) + 64 * c + 8 * j + 2 * t4);
      },
      kid, id0, id1, key0, N, scale, t4);
}

// Each row's value over both warpgroups: warpgroup wg's partial v (rows g,
// g + 8 of warp `warp`, quad-reduced) goes to red[which][wg][row]; after the
// consumers' barrier, returns red[which][0][row], red[which][1][row] in out.
__device__ __forceinline__ void exchange(float* red, int which, int wg, int lr0, int t4,
                                         const float (&v)[2], float (&a)[2], float (&b)[2]) {
  float* r = red + which * 128;
  if (t4 == 0) {
    r[wg * 64 + lr0] = v[0];
    r[wg * 64 + lr0 + 8] = v[1];
  }
  hopper::named_sync(kBar, kConsumers);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    a[i] = r[lr0 + 8 * i];
    b[i] = r[64 + lr0 + 8 * i];
  }
}

// The exact softmax of the logits in s, rows over both warpgroups: P =
// e / l in place with e = exp2(S log2e - m2) (MODE 0, kernel 8), exp of z =
// S - max with z rounded to bf16 first, as exp2(bf16(z) log2e) (MODE 1,
// kernel 11's bf16sm), or exp2((S - max) log2e) (MODE 2, kernel 11's
// exp2: the subtraction, then the product, each rounded); m2 (the base-2
// row max) and il = 1 / l out. A `dead` warp (its 16 rows all past N) only
// takes part in the exchanges: its rows are never stored.
template <int NC, int MODE = 0>
__device__ __forceinline__ void softmax(float (&s)[NC][32], float* red, int wg, int lr0, int t4,
                                        bool dead, float (&m2)[2], float (&il)[2]) {
  static_assert(MODE >= 0 && MODE <= 2, "softmax modes: 0 exp, 1 bf16sm, 2 exp2");
  float mx[2][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) mx[i & 1][i >> 1] = kMaskValue;
  if (!dead) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (live<NC>(c, i)) {
          float& m = mx[(i >> 1) & 1][(c * 8 + (i >> 2)) & 3];
          m = fmaxf(m, s[c][i]);
        }
  }
  float part[2], a[2], b[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    part[r] = quad_max(fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3])));
  exchange(red, 0, wg, lr0, t4, part, a, b);
  float sum[2][4], mrow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mrow[r] = fmaxf(a[r], b[r]);
    m2[r] = mrow[r] * kLog2e;
#pragma unroll
    for (int i = 0; i < 4; ++i) sum[r][i] = 0.f;
  }
  if (!dead) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (live<NC>(c, i)) {
          const int r = (i >> 1) & 1;
          float p;
          if constexpr (MODE == 0) {
            p = hopper::exp2_approx(fmaf(s[c][i], kLog2e, -m2[r]));
          } else {
            float z = __fsub_rn(s[c][i], mrow[r]);
            if constexpr (MODE == 1) z = __bfloat162float(__float2bfloat16_rn(z));
            p = hopper::exp2_approx(__fmul_rn(z, kLog2e));
          }
          s[c][i] = p;
          sum[r][(c * 8 + (i >> 2)) & 3] += p;
        }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    part[r] = quad_sum((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
  exchange(red, 1, wg, lr0, t4, part, a, b);
#pragma unroll
  for (int r = 0; r < 2; ++r) il[r] = 1.f / (a[r] + b[r]);
  if (dead) return;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (live<NC>(c, i)) s[c][i] *= il[(i >> 1) & 1];
}

// Warpgroup 1 hands its 64 x 32 f32 accumulator to warpgroup 0 through its
// own spent K and V rows (k1, v1: 4 KB of each from row KW + 8, which
// warpgroup 0's products never read) and goes on without waiting (barrier
// kXchBar: it cannot arrive twice before warpgroup 0 waits, since the next
// window's first exchange needs warpgroup 0); warpgroup 0 waits and adds it
// to its own.
__device__ __forceinline__ void hand_over(wgtile::Acc<32>& acc, unsigned char* k1,
                                          unsigned char* v1, int wg, int t128) {
  float* xa = reinterpret_cast<float*>(k1);
  float* xb = reinterpret_cast<float*>(v1);
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      xa[i * 128 + t128] = acc[0][i];
      xb[i * 128 + t128] = acc[0][8 + i];
    }
    hopper::fence_async_smem();
    hopper::named_arrive(kXchBar, kConsumers);
    return;
  }
  hopper::named_sync(kXchBar, kConsumers);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    acc[0][i] += xa[i * 128 + t128];
    acc[0][8 + i] += xb[i * 128 + t128];
  }
  hopper::fence_async_smem();
}

// The consumers start copying the 64 x N f32 bias rows of query tile q0 of
// head h into bias_s (row stride BS; rows past N zero): one cp.async group.
__device__ __forceinline__ void copy_bias_rows(float* bias_s, const float* bias, int h, int q0,
                                               int N, int BS, int tid) {
  for (int lr = 0; lr < 64; ++lr) {
    const int row = q0 + lr;
    const float* src = bias + ((long long)h * N + (row < N ? row : 0)) * N;
    for (int k = tid; k < N; k += kConsumers) cp_async4(bias_s + lr * BS + k, src + k, row < N);
  }
  cp_async_commit();
}

// The consumers copy the N x 64 f32 bias columns of key tile k0 of head h,
// transposed, into bias_t (bias_t[kl][q] = bias[h][q][k0 + kl], row stride
// BS): a warp copies 8 keys x 4 queries at a time (32-byte global segments,
// 2-way bank conflicts); then they meet.
__device__ __forceinline__ void copy_bias_cols(float* bias_t, const float* bias, int h, int k0,
                                               int N, int BS, int tid) {
  const int lane = tid % 32, kl = 8 * (tid / 32) + lane % 8;
  const bool ok = k0 + kl < N;
  const float* src = bias + (long long)h * N * N + (ok ? k0 + kl : 0);
  for (int q = lane / 8; q < N; q += 4) cp_async4(bias_t + kl * BS + q, src + (long long)q * N, ok);
  cp_async_commit();
  cp_async_wait<0>();
  hopper::named_sync(kBar, kConsumers);
}

// The consumers copy the bias rows (copy_bias_rows), zero the last 8 K and V
// rows of both stages (`kv` is stage 0's K, V kRows after it, the stages
// `stage` bytes apart), then meet.
template <int KW>
__device__ __forceinline__ void consumers_setup(float* bias_s, const float* bias, int h, int q0,
                                                int N, int BS, unsigned char* kv, int stage,
                                                int tid) {
  copy_bias_rows(bias_s, bias, h, q0, N, BS, tid);
  for (int i = tid; i < 2 * 2 * 128; i += kConsumers) {
    unsigned char* t = kv + (i / 256) * stage + ((i / 128) % 2) * Geo<KW>::kRows;
    reinterpret_cast<uint32_t*>(t + 2 * KW * 64)[i % 128] = 0u;
  }
  hopper::fence_async_smem();
  cp_async_wait<0>();
  hopper::named_sync(kBar, kConsumers);
}

// The producer warp copies window w's region ids (row w % nW of rid) to
// `dst` and, at dst[kIds - 1], whether they hold more than one region (the
// consumers skip the mask where they do not); each lane then arrives on
// `bar`, which releases its copies.
__device__ __forceinline__ void produce_ids(int* dst, const int* rid, int w, int nW, int N,
                                            uint64_t* bar, int lane) {
  const int* src = rid + (long long)(w % nW) * N;
  constexpr int kPer = (kMaxN + 31) / 32;  // every load issued before the first store
  int id[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) id[u] = lane + 32 * u < N ? src[lane + 32 * u] : 0;
  const int first = __shfl_sync(0xffffffffu, id[0], 0);
  bool mixed = false;
#pragma unroll
  for (int u = 0; u < kPer; ++u)
    if (lane + 32 * u < N) {
      dst[lane + 32 * u] = id[u];
      mixed |= id[u] != first;
    }
  mixed = __any_sync(0xffffffffu, mixed);
  if (lane == 0) dst[kIds - 1] = mixed;
  hopper::mbar_arrive(bar);
}

// The producer warp's per-window loads of the forward and the dQ launch: the
// Q (and dO) tile, each warpgroup's K and V rows (boxes of KW rows), and the
// window's region ids (produce_ids) when there are any.
template <int KW, int NT>
__device__ __forceinline__ void produce_rows(unsigned char* smem, int stage_bytes,
                                             uint64_t* full, uint64_t* empty, int* ids_s,
                                             const CUtensorMap* const (&tiles)[NT],
                                             const int (&pos)[NT], const CUtensorMap* tk,
                                             const CUtensorMap* tv, int pos_k, int pos_v,
                                             const int* rid, int h, int q0, int w0, int w_end,
                                             int N, int nW, int lane) {
  using Gm = Geo<KW>;
  for (int w = w0, n = 0; w < w_end; ++w, ++n) {
    const int s = n & 1;
    hopper::mbar_wait(&empty[s], ((n >> 1) & 1) ^ 1);
    unsigned char* st = smem + s * stage_bytes;
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(&full[s], NT * kTile + 4 * KW * 64);
#pragma unroll
      for (int t = 0; t < NT; ++t)
        wgtile::wg_load_tile<32>(st + t * kTile, tiles[t], pos[t], &full[s], h, q0, w);
      unsigned char* kv = st + NT * kTile;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wgtile::wg_load_tile<32>(kv + i * KW * 64, tk, pos_k, &full[s], h, i * KW, w);
        wgtile::wg_load_tile<32>(kv + Gm::kRows + i * KW * 64, tv, pos_v, &full[s], h, i * KW, w);
      }
    }
    if (rid != nullptr) produce_ids(ids_s + s * kIds, rid, w, nW, N, &full[s], lane);
  }
}

// ---------------------------------------------------------------------------
// Kernel 8: one block per (head, 64-query tile, window group)
// ---------------------------------------------------------------------------

template <int KW>
__host__ __device__ constexpr int fwd_stage() { return kTile + 2 * Geo<KW>::kRows; }

template <int KW, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
window_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                        const float* __restrict__ bias, const int* __restrict__ rid, int BW,
                        int H, int N, int D, int nW, int per_group, long long ob, long long on,
                        long long oh, float scale, int pos_q, int pos_k, int pos_v) {
  using Gm = Geo<KW>;
  constexpr int NC = Gm::kChunks;
  constexpr int kStage = fwd_stage<KW>();  // Q | K | V
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = wgtile::align1024(smem_raw);
  const int BS = bias_stride(N);
  float* bias_s = reinterpret_cast<float*>(smem + 2 * kStage);
  float* red = bias_s + 64 * BS;                      // [2][2][64]: max, sum
  int* ids_s = reinterpret_cast<int*>(red + 3 * 128);  // [2][kIds]
  uint64_t* full = reinterpret_cast<uint64_t*>(ids_s + 2 * kIds);
  uint64_t* empty = full + 2;
  const int h = blockIdx.x, q0 = blockIdx.y * 64;
  const int w0 = blockIdx.z * per_group, w_end = min(BW, w0 + per_group);
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&full[s], rid != nullptr ? 33 : 1);
      hopper::mbar_init(&empty[s], kConsumerWarps);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    hopper::regs_release<kProducerRegs>();
    if (threadIdx.x < 32) {
      const CUtensorMap* const tiles[1] = {&tq};
      const int pos[1] = {pos_q};
      produce_rows<KW, 1>(smem, kStage, full, empty, ids_s, tiles, pos, &tk, &tv, pos_k, pos_v,
                          rid, h, q0, w0, w_end, N, nW, threadIdx.x);
    }
    return;
  }
  hopper::regs_claim<kConsumerRegs>();
  const int tid = threadIdx.x - 128, wg = tid / 128, t128 = tid % 128;
  const int warp = t128 / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int lr0 = 16 * warp + g;
  const bool dead = q0 + 16 * warp >= N;  // this warp's rows all past N (never stored)
  consumers_setup<KW>(bias_s, bias, h, q0, N, BS, smem + kTile, kStage, tid);
  const float* b0 = bias_s + lr0 * BS + wg * KW;
  const float* b1 = b0 + 8 * BS;

  for (int w = w0, n = 0; w < w_end; ++w, ++n) {
    const int s = n & 1;
    hopper::mbar_wait(&full[s], (n >> 1) & 1);
    unsigned char* st = smem + s * kStage;
    unsigned char* k_s = st + kTile;
    const unsigned char* k_i = k_s + wg * KW * 64;
    const unsigned char* v_i = k_i + Gm::kRows;
    const int* ids = rid != nullptr && ids_s[s * kIds + kIds - 1] ? ids_s + s * kIds : nullptr;
    const int id0 = ids != nullptr ? ids[min(q0 + lr0, N - 1)] : 0;
    const int id1 = ids != nullptr ? ids[min(q0 + lr0 + 8, N - 1)] : 0;

    float sc[NC][32];
    scores<NC>(sc, st, k_i);
    if (!dead)
      row_logits<NC>(sc, b0, b1, ids != nullptr ? ids + wg * KW : nullptr, id0, id1, wg * KW, N,
                     scale, t4);
    float m2[2], il[2];
    softmax<NC, MODE>(sc, red, wg, lr0, t4, dead, m2, il);

    // O = P V over this warpgroup's keys, P in bf16 register fragments.
    uint32_t pa[NC][4][4];
    if (!dead) {
#pragma unroll
      for (int c = 0; c < NC - 1; ++c) pack<4, 32>(pa[c], sc[c]);
      pack<1, 4>(pa[NC - 1], sc[NC - 1]);
    }
    wgtile::Acc<32> acc;
    wgtile::zero_panels<32>(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < NC - 1; ++c) wgtile::wg_ab<32>(acc, pa[c], v_i + c * kTile);
    wgtile::wg_ab<32, 1>(acc, pa[NC - 1], v_i + (NC - 1) * kTile);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    wgtile::fence_panels<32>(acc);

    // Warpgroup 0 adds warpgroup 1's partial O to its own and stores.
    unsigned char* k1 = k_s + (KW + 8) * 64;
    hand_over(acc, k1, k1 + Gm::kRows, wg, t128);
    if (wg == 0)
      wgtile::wg_store<32>(acc, o + w * ob + h * oh, on, q0, N, N, D, 1.f, warp, g, t4);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }
}

// ---------------------------------------------------------------------------
// Kernel 12: HB heads of a window a block, the bias streamed in 64-key tiles
// ---------------------------------------------------------------------------

// A warpgroup's chunk slot: the chunk's K rows, its V rows (64, or 16 for the
// 8-wide chunk; 64-byte swizzle), then its bias tile: 64 query rows x 64 keys
// f32 as two 32-key panels of 128-byte rows (128-byte swizzle), or 64 x 8
// unswizzled (32 bytes a row) for the 8-wide chunk.
constexpr int kHbBias = 2 * kTile;             // the bias tile's offset in a slot
constexpr int kHbPanel = 64 * 128;             // one 32-key panel of it
constexpr int kHbSlot = kHbBias + 2 * kHbPanel;  // 24 KB
constexpr int kHbNarrowRows = 16;              // K / V rows of the 8-wide chunk
constexpr int kHbXch = 8192;                   // warpgroup 1's partial O (hand_over)

// Shared memory of kernel 12: both warpgroups' NC slots, the Q ring (2
// tiles), the hand-over buffer, the exchange rows, two windows' region ids,
// the barriers (q_full, q_empty, ids_full, ids_empty: 2 each; kb_full,
// kb_empty, v_full, v_empty: one a slot), 1024 B of slack for the base.
template <int KW>
__host__ __device__ constexpr size_t heads_smem() {
  return 1024 + 2 * Geo<KW>::kChunks * (size_t)kHbSlot + 2 * kTile + kHbXch
         + 4 * (3 * 128 + 2 * kIds) + 8 * (8 + 8 * Geo<KW>::kChunks);
}

// The float pair of a slot's bias tile at query row r (0-63), keys k and k + 1
// of the chunk (k even): a 64-wide chunk's two 128-byte-swizzled panels (the
// 16-byte chunk c of row r at c ^ (r % 8)), or the 8-wide chunk's 32-byte rows.
template <bool kNarrow>
__device__ __forceinline__ float2 tile_bias(const unsigned char* tile, int r, int k) {
  if constexpr (kNarrow) return *reinterpret_cast<const float2*>(tile + 32 * r + 4 * k);
  const int byte = 4 * (k % 32);
  return *reinterpret_cast<const float2*>(tile + (k / 32) * kHbPanel + 128 * r
                                          + (((byte >> 4) ^ (r % 8)) << 4) + (byte & 15));
}

template <int KW>
__global__ void __launch_bounds__(kThreads, 1)
window_fwd_heads_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tk16,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tv16,
                        const __grid_constant__ CUtensorMap tb,
                        const __grid_constant__ CUtensorMap tb8, bf16* __restrict__ o,
                        const int* __restrict__ rid, int BW, int HB, int N, int D, int nW,
                        int per_group, long long ob, long long on, long long oh, float scale,
                        int pos_q, int pos_k, int pos_v) {
  constexpr int NC = Geo<KW>::kChunks;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* slots = wgtile::align1024(smem_raw);  // warpgroup 0's NC, then 1's
  unsigned char* q_s = slots + 2 * NC * kHbSlot;        // [2] Q tiles
  unsigned char* xch = q_s + 2 * kTile;
  float* red = reinterpret_cast<float*>(xch + kHbXch);  // [2][2][64]: max, sum
  int* ids_s = reinterpret_cast<int*>(red + 3 * 128);   // [2][kIds]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ids_s + 2 * kIds);
  uint64_t* q_empty = q_full + 2;
  uint64_t* ids_full = q_empty + 2;
  uint64_t* ids_empty = ids_full + 2;
  uint64_t* kb_full = ids_empty + 2;
  uint64_t* kb_empty = kb_full + 2 * NC;
  uint64_t* v_full = kb_empty + 2 * NC;
  uint64_t* v_empty = v_full + 2 * NC;
  const int hg = blockIdx.x, q0 = blockIdx.y * 64;
  const int w0 = blockIdx.z * per_group, w_end = min(BW, w0 + per_group);
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&q_full[s], 1);
      hopper::mbar_init(&q_empty[s], kConsumerWarps);
      hopper::mbar_init(&ids_full[s], 32);
      hopper::mbar_init(&ids_empty[s], kConsumerWarps);
    }
    for (int i = 0; i < 2 * NC; ++i) {
      hopper::mbar_init(&kb_full[i], 1);
      hopper::mbar_init(&kb_empty[i], 4);
      hopper::mbar_init(&v_full[i], 1);
      hopper::mbar_init(&v_empty[i], 4);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    hopper::regs_release<kProducerRegs>();
    if (threadIdx.x >= 32) return;
    // The producer warp: per window its region ids, per (window, head) unit u
    // the Q tile, then each slot's K rows and bias tile (freed by the
    // unit before's logits), then each slot's V rows (freed by its P V).
    const int lane = threadIdx.x;
    for (int w = w0, n = 0, u = 0; w < w_end; ++w, ++n) {
      if (rid != nullptr) {
        hopper::mbar_wait(&ids_empty[n & 1], ((n >> 1) & 1) ^ 1);
        produce_ids(ids_s + (n & 1) * kIds, rid, w, nW, N, &ids_full[n & 1], lane);
      }
      for (int hh = 0; hh < HB; ++hh, ++u) {
        const int h = hg * HB + hh, qs = u & 1;
        hopper::mbar_wait(&q_empty[qs], ((u >> 1) & 1) ^ 1);
        if (lane == 0) {
          hopper::mbar_arrive_expect_tx(&q_full[qs], kTile);
          wgtile::wg_load_tile<32>(q_s + qs * kTile, &tq, pos_q, &q_full[qs], h, q0, w);
        }
        for (int i = 0; i < 2 * NC; ++i) {
          hopper::mbar_wait(&kb_empty[i], (u & 1) ^ 1);
          if (lane != 0) continue;
          const int c = i % NC, key = i / NC * KW + 64 * c;
          unsigned char* sl = slots + i * kHbSlot;
          if (c < NC - 1) {
            hopper::mbar_arrive_expect_tx(&kb_full[i], kTile + 2 * kHbPanel);
            wgtile::wg_load_tile<32>(sl, &tk, pos_k, &kb_full[i], h, key, w);
            hopper::tma_load_3d(sl + kHbBias, &tb, &kb_full[i], key, q0, h);
            hopper::tma_load_3d(sl + kHbBias + kHbPanel, &tb, &kb_full[i], key + 32, q0, h);
          } else {
            hopper::mbar_arrive_expect_tx(&kb_full[i], kHbNarrowRows * 64 + 64 * 32);
            wgtile::wg_load_tile<32>(sl, &tk16, pos_k, &kb_full[i], h, key, w);
            hopper::tma_load_3d(sl + kHbBias, &tb8, &kb_full[i], key, q0, h);
          }
        }
        for (int i = 0; i < 2 * NC; ++i) {
          hopper::mbar_wait(&v_empty[i], (u & 1) ^ 1);
          if (lane != 0) continue;
          const int c = i % NC, key = i / NC * KW + 64 * c;
          hopper::mbar_arrive_expect_tx(&v_full[i], c < NC - 1 ? kTile : kHbNarrowRows * 64);
          wgtile::wg_load_tile<32>(slots + i * kHbSlot + kTile, c < NC - 1 ? &tv : &tv16, pos_v,
                                   &v_full[i], h, key, w);
        }
      }
    }
    return;
  }
  hopper::regs_claim<kConsumerRegs>();
  const int tid = threadIdx.x - 128, wg = tid / 128, t128 = tid % 128;
  const int warp = t128 / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int lr0 = 16 * warp + g;
  const bool dead = q0 + 16 * warp >= N;  // this warp's rows all past N (never stored)
  unsigned char* mine = slots + wg * NC * kHbSlot;  // this warpgroup's slots
  auto arrive = [&](uint64_t* bar) {  // this warp is done with what `bar` guards
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(bar);
  };
  auto bias = [&](int c, int j, int r) {
    const unsigned char* tile = mine + c * kHbSlot + kHbBias;
    return c < NC - 1 ? tile_bias<false>(tile, lr0 + 8 * r, 8 * j + 2 * t4)
                      : tile_bias<true>(tile, lr0 + 8 * r, 2 * t4);
  };

  for (int w = w0, n = 0, u = 0; w < w_end; ++w, ++n) {
    const int* ids = nullptr;
    int id0 = 0, id1 = 0;
    if (rid != nullptr) {
      hopper::mbar_wait(&ids_full[n & 1], (n >> 1) & 1);
      const int* held = ids_s + (n & 1) * kIds;
      if (held[kIds - 1]) {
        ids = held;
        id0 = held[min(q0 + lr0, N - 1)];
        id1 = held[min(q0 + lr0 + 8, N - 1)];
      }
    }
    for (int hh = 0; hh < HB; ++hh, ++u) {
      const int h = hg * HB + hh, qs = u & 1;
      hopper::mbar_wait(&q_full[qs], (u >> 1) & 1);
#pragma unroll
      for (int c = 0; c < NC; ++c) hopper::mbar_wait(&kb_full[wg * NC + c], u & 1);
      float sc[NC][32];
      scores<NC, kHbSlot>(sc, q_s + qs * kTile, mine);
      arrive(&q_empty[qs]);
      if (!dead)
        logits<NC>(sc, bias, ids != nullptr ? ids + wg * KW : nullptr, id0, id1, wg * KW, N,
                   scale, t4);
#pragma unroll
      for (int c = 0; c < NC; ++c) arrive(&kb_empty[wg * NC + c]);
      if (rid != nullptr && hh == HB - 1) arrive(&ids_empty[n & 1]);
      float m2[2], il[2];
      softmax<NC>(sc, red, wg, lr0, t4, dead, m2, il);

      // O = P V over this warpgroup's keys, P in bf16 register fragments.
      uint32_t pa[NC][4][4];
      if (!dead) {
#pragma unroll
        for (int c = 0; c < NC - 1; ++c) pack<4, 32>(pa[c], sc[c]);
        pack<1, 4>(pa[NC - 1], sc[NC - 1]);
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) hopper::mbar_wait(&v_full[wg * NC + c], u & 1);
      wgtile::Acc<32> acc;
      wgtile::zero_panels<32>(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int c = 0; c < NC - 1; ++c) wgtile::wg_ab<32>(acc, pa[c], mine + c * kHbSlot + kTile);
      wgtile::wg_ab<32, 1>(acc, pa[NC - 1], mine + (NC - 1) * kHbSlot + kTile);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      wgtile::fence_panels<32>(acc);
#pragma unroll
      for (int c = 0; c < NC; ++c) arrive(&v_empty[wg * NC + c]);

      // Warpgroup 0 adds warpgroup 1's partial O to its own and stores.
      hand_over(acc, xch, xch + kHbXch / 2, wg, t128);
      if (wg == 0)
        wgtile::wg_store<32>(acc, o + w * ob + h * oh, on, q0, N, N, D, 1.f, warp, g, t4);
    }
  }
}

// ---------------------------------------------------------------------------
// Kernel 9, launch 1: row statistics and dQ, one block per (head, 64-query
// tile, window group)
// ---------------------------------------------------------------------------

template <int KW>
__host__ __device__ constexpr int dq_stage() { return 2 * kTile + 2 * Geo<KW>::kRows; }

template <int KW>
__global__ void __launch_bounds__(kThreads, 1)
window_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tg,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, bf16* __restrict__ dq,
                           const float* __restrict__ bias, const int* __restrict__ rid,
                           float* __restrict__ stats, int BW, int H, int N, int D, int nW,
                           int per_group, long long dqb, long long dqn, long long dqh,
                           float scale, int pos_q, int pos_g, int pos_k, int pos_v) {
  using Gm = Geo<KW>;
  constexpr int NC = Gm::kChunks;
  constexpr int kStage = dq_stage<KW>();  // Q | dO | K | V
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = wgtile::align1024(smem_raw);
  const int BS = bias_stride(N);
  float* bias_s = reinterpret_cast<float*>(smem + 2 * kStage);
  float* red = bias_s + 64 * BS;                      // [3][2][64]: max, sum, delta
  int* ids_s = reinterpret_cast<int*>(red + 3 * 128);  // [2][kIds]
  uint64_t* full = reinterpret_cast<uint64_t*>(ids_s + 2 * kIds);
  uint64_t* empty = full + 2;
  const int h = blockIdx.x, q0 = blockIdx.y * 64;
  const int w0 = blockIdx.z * per_group, w_end = min(BW, w0 + per_group);
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&full[s], rid != nullptr ? 33 : 1);
      hopper::mbar_init(&empty[s], kConsumerWarps);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    hopper::regs_release<kProducerRegs>();
    if (threadIdx.x < 32) {
      const CUtensorMap* const tiles[2] = {&tq, &tg};
      const int pos[2] = {pos_q, pos_g};
      produce_rows<KW, 2>(smem, kStage, full, empty, ids_s, tiles, pos, &tk, &tv, pos_k, pos_v,
                          rid, h, q0, w0, w_end, N, nW, threadIdx.x);
    }
    return;
  }
  hopper::regs_claim<kConsumerRegs>();
  const int tid = threadIdx.x - 128, wg = tid / 128, t128 = tid % 128;
  const int warp = t128 / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int lr0 = 16 * warp + g;
  const bool dead = q0 + 16 * warp >= N;  // this warp's rows all past N (never stored)
  consumers_setup<KW>(bias_s, bias, h, q0, N, BS, smem + 2 * kTile, kStage, tid);
  const float* b0 = bias_s + lr0 * BS + wg * KW;
  const float* b1 = b0 + 8 * BS;

  for (int w = w0, n = 0; w < w_end; ++w, ++n) {
    const int s = n & 1;
    hopper::mbar_wait(&full[s], (n >> 1) & 1);
    unsigned char* st = smem + s * kStage;
    const unsigned char* g_t = st + kTile;
    unsigned char* k_s = st + 2 * kTile;
    const unsigned char* k_i = k_s + wg * KW * 64;
    const unsigned char* v_i = k_i + Gm::kRows;
    const int* ids = rid != nullptr && ids_s[s * kIds + kIds - 1] ? ids_s + s * kIds : nullptr;
    const int id0 = ids != nullptr ? ids[min(q0 + lr0, N - 1)] : 0;
    const int id1 = ids != nullptr ? ids[min(q0 + lr0 + 8, N - 1)] : 0;

    float sc[NC][32];
    scores<NC>(sc, st, k_i);
    if (!dead)
      row_logits<NC>(sc, b0, b1, ids != nullptr ? ids + wg * KW : nullptr, id0, id1, wg * KW, N,
                     scale, t4);
    float m2[2], il[2];
    softmax<NC>(sc, red, wg, lr0, t4, dead, m2, il);

    // delta = sum_k P dP over both warpgroups, dP = dO V^T a chunk at a
    // time; the 8-wide chunk's dP is kept.
    // A chunk a batch (two would not leave ptxas the registers to keep the
    // wgmma pipeline: C7511); the 8-wide chunk's dP is kept.
    float dp[32], dpl[4];
    float dd[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      hopper::wgmma_fence();
      if (c < NC - 1)
        abt<64>(dp, g_t, v_i + c * kTile);
      else
        abt<8>(dp, g_t, v_i + c * kTile);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      if (c < NC - 1) {
        hopper::fence_regs(dp);
      } else {
        fence_first<4>(dp);
#pragma unroll
        for (int i = 0; i < 4; ++i) dpl[i] = dp[i];
      }
      if (!dead) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (live<NC>(c, i))
            dd[(i >> 1) & 1][i & 1] = fmaf(sc[c][i], dp[i], dd[(i >> 1) & 1][i & 1]);
      }
    }
    float part[2], a[2], b[2], delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) part[r] = quad_sum(dd[r][0] + dd[r][1]);
    exchange(red, 2, wg, lr0, t4, part, a, b);
#pragma unroll
    for (int r = 0; r < 2; ++r) delta[r] = a[r] + b[r];
    if (wg == 0 && t4 == 0) {
      float* stw = stats + ((long long)w * H + h) * 3 * N;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + lr0 + 8 * r;
        if (row < N) {
          stw[row] = m2[r] - log2f(il[r]);  // the base-2 log-sum-exp
          stw[2 * N + row] = delta[r];
        }
      }
    }

    // dQ = bf16(ds) K: the 8-wide chunk from its kept dP, then the others
    // from the last down, each batch recomputing the next chunk's dP.
    wgtile::Acc<32> acc;
    wgtile::zero_panels<32>(acc);
    uint32_t fa[4][4];
    if (!dead) pack_ds<1, 4>(fa, sc[NC - 1], dpl, delta);
    hopper::wgmma_fence();
    wgtile::wg_ab<32, 1>(acc, fa, k_i + (NC - 1) * kTile);
    abt<64>(dp, g_t, v_i + (NC - 2) * kTile);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    wgtile::fence_panels<32>(acc);
    hopper::fence_regs(dp);
#pragma unroll
    for (int c = NC - 2; c >= 0; --c) {
      if (!dead) pack_ds<4, 32>(fa, sc[c], dp, delta);
      hopper::wgmma_fence();
      wgtile::wg_ab<32>(acc, fa, k_i + c * kTile);
      if (c > 0) abt<64>(dp, g_t, v_i + (c - 1) * kTile);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      wgtile::fence_panels<32>(acc);
      hopper::fence_regs(dp);
    }

    // Warpgroup 0 adds warpgroup 1's partial dQ to its own and stores.
    unsigned char* k1 = k_s + (KW + 8) * 64;
    hand_over(acc, k1, k1 + Gm::kRows, wg, t128);
    if (wg == 0)
      wgtile::wg_store<32>(acc, dq + w * dqb + h * dqh, dqn, q0, N, N, D, scale, warp, g, t4);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }
}

// ---------------------------------------------------------------------------
// Kernel 9, launch 2: dK, dV and dbias, one block per (head, 64-key tile,
// window group)
// ---------------------------------------------------------------------------

// What a dK/dV step reads besides its tiles: the bias columns of the
// thread's key rows (b0: kl0, b1: kl0 + 8) from the warpgroup's first query,
// the queries' statistics (the base-2 log-sum-exp at sm[q], delta at
// sm[2 sq + q]), the queries' and the two keys' region ids (qid null: no
// mask), and the queries before the window's end (q_lim = N - first query).
struct DkvRows {
  const float *b0, *b1, *sm;
  const int* qid;
  int kid0, kid1, q_lim, sq;
  bool dead;  // the warp's 16 keys all past N: no arithmetic (their rows are never stored)
};

// A dK/dV step's per-score arithmetic on W (32 or 8) queries from `col0`,
// keys as rows, in place: st from S^T to P^T = exp2(S^T log2e - lse) (the
// logits as row_logits forms them), dpt from dP^T to ds^T = P^T (dP^T -
// delta), db += ds^T (f32). Every block alike (reads past query N - 1 stay
// inside shared memory); the block holding query N - 1 (or past it) zeroes
// its P and ds there. A `dead` warp does nothing.
template <int W>
__device__ __forceinline__ void dkv_scores(float (&st)[16], float (&dpt)[16], float (&db)[16],
                                           const DkvRows& r, int col0, float scale, int t4) {
  if (r.dead) return;
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    const int col = col0 + 8 * j + 2 * t4;
    float* e = &st[4 * j];
    float* f = &dpt[4 * j];
    const float2 x0 = *reinterpret_cast<const float2*>(r.b0 + col);
    const float2 x1 = *reinterpret_cast<const float2*>(r.b1 + col);
    const float2 mm = *reinterpret_cast<const float2*>(r.sm + col);
    const float2 dl = *reinterpret_cast<const float2*>(r.sm + 2 * r.sq + col);
    bool d00 = false, d01 = false, d10 = false, d11 = false;
    if (r.qid != nullptr) {
      const int2 qi = *reinterpret_cast<const int2*>(r.qid + col);
      d00 = qi.x != r.kid0;
      d01 = qi.y != r.kid0;
      d10 = qi.x != r.kid1;
      d11 = qi.y != r.kid1;
    }
    const float x[4] = {logit(e[0], scale, x0.x, d00), logit(e[1], scale, x0.y, d01),
                        logit(e[2], scale, x1.x, d10), logit(e[3], scale, x1.y, d11)};
    const bool tail = col0 + 8 * j + 8 > r.q_lim;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float m = (u & 1) ? mm.y : mm.x, d = (u & 1) ? dl.y : dl.x;
      float p = hopper::exp2_approx(fmaf(x[u], kLog2e, -m));
      float ds = p * (f[u] - d);
      if (tail && col + (u & 1) >= r.q_lim) p = ds = 0.f;
      db[4 * j + u] += ds;
      e[u] = p;
      f[u] = ds;
    }
  }
}

// One step of W (32, or 8 at the end) queries from `col0` of a warpgroup's
// range, keys as rows: S^T = K Q^T and dP^T = V dO^T on wgmma, then
// dkv_scores, then dV += bf16(P^T) dO and dK += bf16(ds^T) Q (the A operands
// in registers).
template <int W>
__device__ __forceinline__ void dkv_step(float (&db)[16], wgtile::Acc<32>& adk,
                                         wgtile::Acc<32>& adv, const unsigned char* k_t,
                                         const unsigned char* v_t, const unsigned char* q_r,
                                         const unsigned char* g_r, const DkvRows& r, int col0,
                                         float scale, int t4) {
  constexpr int L = W / 2, KK = (W + 15) / 16;
  float st[16], dpt[16];
  hopper::wgmma_fence();
  abt<W>(st, k_t, q_r);
  abt<W>(dpt, v_t, g_r);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  fence_first<L>(st);
  fence_first<L>(dpt);
  dkv_scores<W>(st, dpt, db, r, col0, scale, t4);
  uint32_t pp[4][4], pd[4][4];
  pack<KK, L>(pp, st);
  pack<KK, L>(pd, dpt);
  hopper::wgmma_fence();
  wgtile::wg_ab<32, KK>(adv, pp, g_r);
  wgtile::wg_ab<32, KK>(adk, pd, q_r);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  wgtile::fence_panels<32>(adv);
  wgtile::fence_panels<32>(adk);
}

// Shared memory of the dK/dV launch: 2 stages of the K and V tiles; each
// warpgroup's ring of Q / dO chunks; the exchange buffer (32 f32 a thread);
// the bias columns (64 keys x BS); 2 stages of statistics (3 x 2 KW) and
// region ids; the barriers.
template <int KW>
struct DkvGeo {
  static constexpr int kSQ = 2 * KW;
  static constexpr int kRingOff = 2 * 2 * kTile;
  static constexpr int kXchOff = kRingOff + 2 * kRing * 2 * kTile;
  static constexpr int kBiasOff = kXchOff + 32 * 128 * 4;
  __host__ __device__ static size_t bytes(int N) {
    return 1024 + kBiasOff + 4 * ((size_t)64 * bias_stride(N) + 2 * 3 * kSQ + 2 * kIds)
           + 8 * (4 + 4 * kRing);
  }
};

template <int KW>
__global__ void __launch_bounds__(kThreads, 1)
window_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tg,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv, bf16* __restrict__ dk,
                            bf16* __restrict__ dv, const float* __restrict__ bias,
                            const int* __restrict__ rid, const float* __restrict__ stats,
                            float* __restrict__ dbias_out, int BW, int H, int N, int D, int nW,
                            int per_group, long long dkb, long long dkn, long long dkh,
                            long long dvb, long long dvn, long long dvh, float scale, int pos_q,
                            int pos_g, int pos_k, int pos_v) {
  using Gm = Geo<KW>;
  using Dg = DkvGeo<KW>;
  constexpr int NC = Gm::kChunks;
  constexpr int kSQ = Dg::kSQ;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = wgtile::align1024(smem_raw);
  unsigned char* kv_s = smem;
  unsigned char* ring = smem + Dg::kRingOff;
  float* xch = reinterpret_cast<float*>(smem + Dg::kXchOff);
  const int BS = bias_stride(N);
  float* bias_t = reinterpret_cast<float*>(smem + Dg::kBiasOff);  // [key][query]
  float* stats_s = bias_t + 64 * BS;                                // [2][3][kSQ]
  int* ids_s = reinterpret_cast<int*>(stats_s + 2 * 3 * kSQ);       // [2][kIds]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(ids_s + 2 * kIds);
  uint64_t* kv_empty = kv_full + 2;
  uint64_t* qd_full = kv_empty + 2;  // [2][kRing]
  uint64_t* qd_empty = qd_full + 2 * kRing;
  const int h = blockIdx.x, k0 = blockIdx.y * 64;
  const int w0 = blockIdx.z * per_group, w_end = min(BW, w0 + per_group);
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&kv_full[s], rid != nullptr ? 65 : 33);
      hopper::mbar_init(&kv_empty[s], kConsumerWarps);
    }
    for (int i = 0; i < 2 * kRing; ++i) {
      hopper::mbar_init(&qd_full[i], 1);
      hopper::mbar_init(&qd_empty[i], 4);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    hopper::regs_release<kProducerRegs>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    for (int w = w0, n = 0; w < w_end; ++w, ++n) {
      const int s = n & 1;
      hopper::mbar_wait(&kv_empty[s], ((n >> 1) & 1) ^ 1);
      unsigned char* kt = kv_s + s * 2 * kTile;
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(&kv_full[s], 2 * kTile);
        wgtile::wg_load_tile<32>(kt, &tk, pos_k, &kv_full[s], h, k0, w);
        wgtile::wg_load_tile<32>(kt + kTile, &tv, pos_v, &kv_full[s], h, k0, w);
      }
      const float* src = stats + ((long long)w * H + h) * 3 * N;
      float* dst = stats_s + s * 3 * kSQ;
      for (int a = 0; a < 3; a += 2)  // the log-sum-exp and delta
        for (int i = lane; i < N; i += 32) cp_async4(dst + a * kSQ + i, src + a * N + i, true);
      cp_async_arrive(&kv_full[s]);
      if (rid != nullptr) produce_ids(ids_s + s * kIds, rid, w, nW, N, &kv_full[s], lane);
      if (lane == 0) {
        for (int c = 0; c < NC; ++c)
          for (int i = 0; i < 2; ++i) {
            const int idx = n * NC + c, slot = i * kRing + idx % kRing;
            hopper::mbar_wait(&qd_empty[slot], ((idx / kRing) & 1) ^ 1);
            hopper::mbar_arrive_expect_tx(&qd_full[slot], 2 * kTile);
            unsigned char* qc = ring + slot * 2 * kTile;
            wgtile::wg_load_tile<32>(qc, &tq, pos_q, &qd_full[slot], h, i * KW + 64 * c, w);
            wgtile::wg_load_tile<32>(qc + kTile, &tg, pos_g, &qd_full[slot], h, i * KW + 64 * c,
                                     w);
          }
      }
      __syncwarp();
    }
    return;
  }
  hopper::regs_claim<kConsumerRegs>();
  const int tid = threadIdx.x - 128, wg = tid / 128, t128 = tid % 128;
  const int warp = t128 / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  copy_bias_cols(bias_t, bias, h, k0, N, BS, tid);
  const int kl0 = 16 * warp + g;
  const int q_base = wg * KW;
  const float* b0 = bias_t + kl0 * BS + q_base;
  const float* b1 = b0 + 8 * BS;
  // dbias^T of this warpgroup's queries, summed over the windows: one
  // 16-accumulator array per 32-query step (the last step 8 wide, 4 live).
  constexpr int kSteps = 2 * (NC - 1) + 1;
  float db[kSteps][16];
#pragma unroll
  for (int u = 0; u < kSteps; ++u)
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (u < kSteps - 1 || i < 4) db[u][i] = 0.f;

  for (int w = w0, n = 0; w < w_end; ++w, ++n) {
    const int s = n & 1;
    hopper::mbar_wait(&kv_full[s], (n >> 1) & 1);
    const unsigned char* k_t = kv_s + s * 2 * kTile;
    const unsigned char* v_t = k_t + kTile;
    DkvRows rows{b0, b1, stats_s + s * 3 * kSQ + q_base, nullptr, 0, 0, N - q_base, kSQ,
                 k0 + 16 * warp >= N};
    if (rid != nullptr && ids_s[s * kIds + kIds - 1]) {
      const int* ids = ids_s + s * kIds;
      rows.qid = ids + q_base;
      rows.kid0 = ids[min(k0 + kl0, N - 1)];
      rows.kid1 = ids[min(k0 + kl0 + 8, N - 1)];
    }
    wgtile::Acc<32> adk, adv;
    wgtile::zero_panels<32>(adk);
    wgtile::zero_panels<32>(adv);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int idx = n * NC + c, slot = wg * kRing + idx % kRing;
      hopper::mbar_wait(&qd_full[slot], (idx / kRing) & 1);
      const unsigned char* q_c = ring + slot * 2 * kTile;
      if (c < NC - 1) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          dkv_step<32>(db[2 * c + hh], adk, adv, k_t, v_t, q_c + hh * 32 * 64,
                       q_c + kTile + hh * 32 * 64, rows, 64 * c + 32 * hh, scale, t4);
      } else {
        dkv_step<8>(db[kSteps - 1], adk, adv, k_t, v_t, q_c, q_c + kTile, rows, 64 * c, scale,
                    t4);
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&qd_empty[slot]);
    }

    // Warpgroup 1's partial dK, dV to warpgroup 0, once warpgroup 0 has
    // read the previous window's (barrier kXchBar).
    if (wg == 1) {
      if (n > 0) hopper::named_sync(kXchBar, kConsumers);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        xch[i * 128 + t128] = adk[0][i];
        xch[(16 + i) * 128 + t128] = adv[0][i];
      }
    }
    hopper::named_sync(kBar, kConsumers);
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        adk[0][i] += xch[i * 128 + t128];
        adv[0][i] += xch[(16 + i) * 128 + t128];
      }
      if (w + 1 < w_end) hopper::named_arrive(kXchBar, kConsumers);
      wgtile::wg_store<32>(adk, dk + w * dkb + h * dkh, dkn, k0, N, N, D, scale, warp, g, t4);
      wgtile::wg_store<32>(adv, dv + w * dvb + h * dvh, dvn, k0, N, N, D, 1.f, warp, g, t4);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&kv_empty[s]);
  }

  // This block's dbias partial: ds summed over its windows, (query, key).
  float* out = dbias_out + ((long long)blockIdx.z * H + h) * N * N;
#pragma unroll
  for (int u = 0; u < kSteps; ++u)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (u == kSteps - 1 && i >= 4) continue;
      const int key = k0 + kl0 + 8 * ((i >> 1) & 1);
      const int q = q_base + 32 * u + 8 * (i >> 2) + 2 * t4 + (i & 1);
      if (key < N && q < N) out[(long long)q * N + key] = db[u][i];
    }
}

// ===========================================================================
// f32 on the tensor cores: 3xTF32 (design "wgmma.tf32x3")
// ===========================================================================
//
// The same blocks, warpgroups and passes over S as the bf16 design above, on
// f32 operands: each product A B is three TF32 products, A_small B_big +
// A_big B_small + A_big B_big, where x = big + small, big is x with its low
// 13 bits masked and small is x - big rounded to TF32 (exact to ~2^-21 |x|;
// one TF32 product alone misses the f32 limits). Logits, softmax, delta, ds,
// the scale and dbias stay f32 on the FMA units, as in the bf16 design; P
// and ds are split, not rounded.
//
// TF32 wgmma reads both operands K-major only, so the product over keys
// (queries) needs V^T and K^T (dO^T and Q^T) with the keys (queries)
// contiguous. A pre-pass (tf32_split_kernel) splits each input once a call,
// for every (window, head), into its two parts in the forms the products
// read: "rows" (N x 32 floats, D padded to 32 with zeros) and "cols" (32 x NP
// floats, NP = N rounded up to 8: the transpose, positions permuted within
// each 8 as the A fragments want them, see tf_frags). The forward takes q
// and k as rows and v as cols; the backward q, k and dO in both forms and v
// as rows. Each form is BW H 2 planes of NP x 32 floats (the caller's
// scratch). The blocks then read every operand by TMA: 3-D maps over the
// planes, 128-byte swizzle (an f32 row of 32 is 128 bytes), rows past N zero.
//
// Shared memory holds the 64-row tile's f32 bias rows (columns) as in bf16,
// so K and V (Q and dO) cannot be held whole a window: they stream in 64-key
// chunks (a warpgroup's last chunk 8 wide) through a ring the two consumer
// warpgroups share, filled in the order they consume it. The forward's ring
// has 6 slots of 16 KB (a chunk's big part, then its small part), the dQ
// launch's 4 (S = Q K^T, then dP = dO V^T for delta, then dP again with
// dQ += ds K^T, chunk by chunk); the dK/dV launch streams 32-query steps
// through 8 slots of 8 KB (Q, dO, Q^T, dO^T a step) and keeps K and V, one
// window at a time. Every slot belongs to one warpgroup: the fills alternate
// between the warpgroups (or come in runs of half the ring) and the slot
// count is even. A warpgroup then never waits on a slot's full barrier two
// phases ahead of it, where the parity wait would take the earlier phase of
// the same parity for the one it wants (a 5-slot ring whose slots changed
// hands raced that way: stalls and faults under back-to-back calls). Each chunk's P V (ds K^T) goes to an accumulator of its
// own, added to O (dQ) on the FMA units; dK and dV accumulate in the tensor
// cores over a warpgroup's 200 queries.

constexpr int kTfSlotBytes = 16384;  // forward / dQ ring slot: a chunk's big part, its small part
constexpr int kTfPart = 8192;        // offset of the small part (a 64-row tile of 32 f32)
constexpr int kTfPanel = 4096;       // 32 rows of 32 f32; the dK/dV ring's part offset
constexpr int kTfFwdSlots = 6, kTfDqSlots = 4, kTfDkvSlots = 8;
static_assert(kTfFwdSlots % 2 == 0 && kTfDqSlots % 2 == 0 && kTfDkvSlots % 8 == 0,
              "a slot belongs to one warpgroup");
constexpr int kTfDkvSlotBytes = 8192;

// x = big + small: big is x with its low 13 bits masked, small is x - big
// (exact) rounded to TF32.
__device__ __forceinline__ void tf32_split(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = hopper::tf32_rna(x - __uint_as_float(big));
}

__host__ __device__ __forceinline__ int tf32_np(int N) { return (N + 7) / 8 * 8; }

// The pre-pass: 32 positions [32 blockIdx.x, + 32) of one (window
// blockIdx.z, head blockIdx.y) slice of an f32 (BW, N, H, D) tensor x
// (strides sb, sn, sh; unit head-dim stride), split into TF32 parts. rows
// (unless null): plane 2 (w H + h) + part, row n, 32 floats (zeros past D).
// cols (unless null): the same plane of the cols form, row d, NP floats,
// position 8 j + p holding element 8 j + 2 p (p < 4) or 8 j + 2 p - 7, zeros
// past N.
__global__ void __launch_bounds__(256)
tf32_split_kernel(const float* __restrict__ x, float* __restrict__ rows, float* __restrict__ cols,
                  int H, int N, int NP, int D, long long sb, long long sn, long long sh) {
  __shared__ float tile[2][32][33];
  const int h = blockIdx.y, n0 = blockIdx.x * 32;
  const int lx = threadIdx.x % 32, wy = threadIdx.x / 32;
  const long long plane = ((long long)blockIdx.z * H + h) * 2;
  const size_t pf = (size_t)NP * 32;
  const float* src = x + blockIdx.z * sb + h * sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = wy + 8 * i, n = n0 + r;
    uint32_t big, small;
    tf32_split(n < N && lx < D ? src[n * sn + lx] : 0.f, big, small);
    tile[0][r][lx] = __uint_as_float(big);
    tile[1][r][lx] = __uint_as_float(small);
    if (rows != nullptr && n < N) {
      rows[plane * pf + (size_t)n * 32 + lx] = __uint_as_float(big);
      rows[(plane + 1) * pf + (size_t)n * 32 + lx] = __uint_as_float(small);
    }
  }
  if (cols == nullptr) return;
  __syncthreads();
  const int m = n0 + lx;
  if (m >= NP) return;
  const int p = m & 7, r = (m & ~7) + (p < 4 ? 2 * p : 2 * p - 7) - n0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = wy + 8 * i;
    cols[plane * pf + (size_t)d * NP + m] = tile[0][r][d];
    cols[(plane + 1) * pf + (size_t)d * NP + m] = tile[1][r][d];
  }
}

__device__ __forceinline__ uint64_t tf_desc(const void* p) {
  return hopper::smem_desc(p, 16, 1024, hopper::kLayoutSw128);
}

template <int W, int N>
__device__ __forceinline__ void tf_ss(float (&d)[N], uint64_t a, uint64_t b, int accumulate) {
  if constexpr (W == 64)
    hopper::wgmma_m64n64k8_tf32_ss(d, a, b, accumulate);
  else if constexpr (W == 32)
    hopper::wgmma_m64n32k8_tf32_ss(d, a, b, accumulate);
  else
    hopper::wgmma_m64n8k8_tf32_ss(d, a, b, accumulate);
}

// d (64 x W) = A B^T over the 32-wide head dim, 3xTF32: A a 64-row tile and
// B W rows (64, 32 or 8), both K-major in shared memory (rows form), each
// with its small part `a_part` / `b_part` bytes after its big part.
template <int W, int N>
__device__ __forceinline__ void tf_abt(float (&d)[N], const unsigned char* a, int a_part,
                                       const unsigned char* b, int b_part) {
  const uint64_t ab = tf_desc(a), as = tf_desc(a + a_part);
  const uint64_t bb = tf_desc(b), bs = tf_desc(b + b_part);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    tf_ss<W>(d, as + 2 * ks, bb + 2 * ks, ks > 0);
    tf_ss<W>(d, ab + 2 * ks, bs + 2 * ks, 1);
    tf_ss<W>(d, ab + 2 * ks, bb + 2 * ks, 1);
  }
}

// d (64 x 32) (+)= A B over KK k8 steps, 3xTF32: A's parts in registers
// (tf_frags), B (cols form: 32 rows, the k values contiguous, 4 KB panels of
// 32) with its small part `b_part` bytes after its big part. Unless
// `accumulate`, d is overwritten.
template <int KK>
__device__ __forceinline__ void tf_ab(float (&d)[16], const uint32_t (&ab)[8][4],
                                      const uint32_t (&as)[8][4], const unsigned char* b,
                                      int b_part, bool accumulate) {
  const uint64_t bb = tf_desc(b), bs = tf_desc(b + b_part);
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    const uint32_t off = (kk / 4 * kTfPanel + kk % 4 * 32) >> 4;
    hopper::wgmma_m64n32k8_tf32_rs(d, as[kk], bb + off, accumulate || kk > 0);
    hopper::wgmma_m64n32k8_tf32_rs(d, ab[kk], bs + off, 1);
    hopper::wgmma_m64n32k8_tf32_rs(d, ab[kk], bb + off, 1);
  }
}

// The TF32 parts of an accumulator's columns [0, 8 KK) as A fragments: k8
// step kk takes columns 8 kk + 2 t4 and + 1 (accumulator elements 4 kk + 0,
// 1 of row g, + 2, 3 of row g + 8) at positions t4 and t4 + 4, which is the
// cols form's order: fragment register r takes element 0, 2, 1, 3.
template <int KK, int N>
__device__ __forceinline__ void tf_frags(uint32_t (&b)[8][4], uint32_t (&s)[8][4],
                                         const float (&x)[N]) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) tf32_split(x[4 * kk + ((r & 1) << 1 | r >> 1)], b[kk][r], s[kk][r]);
}

// The same for ds = P (dP - delta) of rows g and g + 8.
template <int KK, int N>
__device__ __forceinline__ void tf_ds_frags(uint32_t (&b)[8][4], uint32_t (&s)[8][4],
                                            const float (&p)[32], const float (&dp)[N],
                                            const float (&dl)[2]) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * kk + ((r & 1) << 1 | r >> 1);
      tf32_split(p[i] * (dp[i] - dl[(i >> 1) & 1]), b[kk][r], s[kk][r]);
    }
}

// A ring of SLOTS slots of BYTES in shared memory, filled by the producer
// and consumed by the consumer warpgroups in one global order (fill idx goes
// to slot idx % SLOTS); full barriers take the producer's transaction count,
// empty ones the owning warpgroup's 4 warps.
template <int SLOTS, int BYTES>
struct TfRing {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  __device__ __forceinline__ const unsigned char* wait(int idx) const {
    hopper::mbar_wait(&full[idx % SLOTS], (idx / SLOTS) & 1);
    return base + idx % SLOTS * BYTES;
  }
  __device__ __forceinline__ void release(int idx, int lane) const {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[idx % SLOTS]);
  }
  // The producer: waits until fill idx's slot is free, expects `bytes`.
  __device__ __forceinline__ unsigned char* acquire(int idx, uint32_t bytes) const {
    hopper::mbar_wait(&empty[idx % SLOTS], ((idx / SLOTS) & 1) ^ 1);
    hopper::mbar_arrive_expect_tx(&full[idx % SLOTS], bytes);
    return base + idx % SLOTS * BYTES;
  }
  __device__ __forceinline__ uint64_t* bar(int idx) const { return &full[idx % SLOTS]; }
};

// Rows [row, row + box) of plane pair `plane` of a rows-form map: the big
// part to dst, the small part to dst + part.
__device__ __forceinline__ void tf_load_rows(unsigned char* dst, int part, const CUtensorMap* m,
                                             uint64_t* bar, int row, int plane) {
  hopper::tma_load_3d(dst, m, bar, 0, row, plane);
  hopper::tma_load_3d(dst + part, m, bar, 0, row, plane + 1);
}

// Positions [pos, pos + 32 panels) of plane pair `plane` of a cols-form map:
// panel i of the big part to dst + i kTfPanel, of the small part to
// dst + part + i kTfPanel.
__device__ __forceinline__ void tf_load_cols(unsigned char* dst, int part, int panels,
                                             const CUtensorMap* m, uint64_t* bar, int pos,
                                             int plane) {
  for (int i = 0; i < panels; ++i) {
    hopper::tma_load_3d(dst + i * kTfPanel, m, bar, pos + 32 * i, 0, plane);
    hopper::tma_load_3d(dst + part + i * kTfPanel, m, bar, pos + 32 * i, 0, plane + 1);
  }
}

// A warpgroup's 64 x 32 f32 accumulator as f32 rows [row0, row0 + 64) of one
// (window, head) slice, times `mul`; rows >= N and columns >= D skipped.
__device__ __forceinline__ void tf_store(const float (&acc)[16], float* base, long long row_stride,
                                         int row0, int N, int D, float mul, int warp, int g,
                                         int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 16 * warp + g + 8 * r;
    if (row >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 8 * j + 2 * t4;
      if (col < D)
        *reinterpret_cast<float2*>(base + row * row_stride + col) =
            make_float2(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
    }
  }
}

// Warpgroup 1 hands its 64 x 32 accumulator to warpgroup 0 through `xch`
// (16 x 128 floats) and goes on (barrier kXchBar; it writes `xch` again only
// after the next window's first exchange, which needs warpgroup 0 past its
// read); warpgroup 0 waits and adds it to its own.
__device__ __forceinline__ void tf_hand_over(float (&acc)[16], float* xch, int wg, int t128) {
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < 16; ++i) xch[i * 128 + t128] = acc[i];
    hopper::named_arrive(kXchBar, kConsumers);
    return;
  }
  hopper::named_sync(kXchBar, kConsumers);
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] += xch[i * 128 + t128];
}

// Shared memory of the forward (one stage of Q) and the dQ launch (one of Q,
// one of dO): the ring, the stages (16 KB each), the bias rows, the exchange
// rows, warpgroup 1's hand-over, one window's region ids, the barriers.
template <int SLOTS, int STAGES>
struct TfRowsGeo {
  static constexpr int kStageOff = SLOTS * kTfSlotBytes;
  static constexpr int kBiasOff = kStageOff + STAGES * kTfSlotBytes;
  __host__ __device__ static size_t bytes(int N) {
    return 1024 + kBiasOff + 4 * ((size_t)64 * bias_stride(N) + 3 * 128 + 16 * 128 + kIds)
           + 8 * (2 * STAGES + 2 * SLOTS);
  }
};

// ---------------------------------------------------------------------------
// Kernel 8 in f32: one block per (head, 64-query tile, window group)
// ---------------------------------------------------------------------------

template <int KW>
__global__ void __launch_bounds__(kThreads, 1)
window_fwd_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tk8,
                       const __grid_constant__ CUtensorMap tvt, float* __restrict__ o,
                       const float* __restrict__ bias, const int* __restrict__ rid, int BW, int H,
                       int N, int D, int nW, int per_group, long long ob, long long on,
                       long long oh, float scale) {
  constexpr int NC = Geo<KW>::kChunks;
  constexpr int S = kTfFwdSlots;
  using Gt = TfRowsGeo<S, 1>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = wgtile::align1024(smem_raw);
  unsigned char* q_s = smem + Gt::kStageOff;  // Q big, Q small
  const int BS = bias_stride(N);
  float* bias_s = reinterpret_cast<float*>(smem + Gt::kBiasOff);
  float* red = bias_s + 64 * BS;  // [2][2][64]: max, sum
  float* xch = red + 3 * 128;
  int* ids_s = reinterpret_cast<int*>(xch + 16 * 128);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ids_s + kIds);
  uint64_t* q_empty = q_full + 1;
  const TfRing<S, kTfSlotBytes> ring{smem, q_empty + 1, q_empty + 1 + S};
  const int h = blockIdx.x, q0 = blockIdx.y * 64;
  const int w0 = blockIdx.z * per_group, w_end = min(BW, w0 + per_group);
  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, rid != nullptr ? 33 : 1);
    hopper::mbar_init(q_empty, kConsumerWarps);
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&ring.full[s], 1);
      hopper::mbar_init(&ring.empty[s], 4);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    hopper::regs_release<kProducerRegs>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    int idx = 0;  // ring fills so far (lane 0)
    for (int w = w0, n = 0; w < w_end; ++w, ++n) {
      const int plane = 2 * (w * H + h);
      hopper::mbar_wait(q_empty, (n & 1) ^ 1);
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(q_full, 2 * kTfPart);
        tf_load_rows(q_s, kTfPart, &tq, q_full, q0, plane);
      }
      if (rid != nullptr) produce_ids(ids_s, rid, w, nW, N, q_full, lane);
      if (lane == 0) {
        // Each warpgroup's K chunks, then its V^T chunks, the two interleaved.
        for (int c = 0; c < NC; ++c)
          for (int i = 0; i < 2; ++i, ++idx) {
            const bool last = c == NC - 1;
            unsigned char* d = ring.acquire(idx, last ? 2 * 8 * 128 : 2 * kTfPart);
            tf_load_rows(d, kTfPart, last ? &tk8 : &tk, ring.bar(idx), i * KW + 64 * c, plane);
          }
        for (int c = 0; c < NC; ++c)
          for (int i = 0; i < 2; ++i, ++idx) {
            const bool last = c == NC - 1;
            unsigned char* d = ring.acquire(idx, (last ? 2 : 4) * kTfPanel);
            tf_load_cols(d, kTfPart, last ? 1 : 2, &tvt, ring.bar(idx), i * KW + 64 * c, plane);
          }
      }
      __syncwarp();
    }
    return;
  }
  hopper::regs_claim<kConsumerRegs>();
  const int tid = threadIdx.x - 128, wg = tid / 128, t128 = tid % 128;
  const int warp = t128 / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int lr0 = 16 * warp + g;
  const bool dead = q0 + 16 * warp >= N;  // this warp's rows all past N (never stored)
  copy_bias_rows(bias_s, bias, h, q0, N, BS, tid);
  cp_async_wait<0>();
  hopper::named_sync(kBar, kConsumers);
  const float* b0 = bias_s + lr0 * BS + wg * KW;
  const float* b1 = b0 + 8 * BS;

  for (int w = w0, n = 0; w < w_end; ++w, ++n) {
    const int fill0 = n * 4 * NC;
    hopper::mbar_wait(q_full, n & 1);
    const int* ids = rid != nullptr && ids_s[kIds - 1] ? ids_s : nullptr;
    const int id0 = ids != nullptr ? ids[min(q0 + lr0, N - 1)] : 0;
    const int id1 = ids != nullptr ? ids[min(q0 + lr0 + 8, N - 1)] : 0;

    // S = Q K^T over this warpgroup's keys, a chunk at a time.
    float sc[NC][32];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int idx = fill0 + 2 * c + wg;
      const unsigned char* kc = ring.wait(idx);
      hopper::wgmma_fence();
      if (c < NC - 1)
        tf_abt<64>(sc[c], q_s, kTfPart, kc, kTfPart);
      else
        tf_abt<8>(sc[c], q_s, kTfPart, kc, kTfPart);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      if (c < NC - 1)
        hopper::fence_regs(sc[c]);
      else
        fence_first<4>(sc[c]);
      ring.release(idx, lane);
    }
    if (!dead)
      row_logits<NC>(sc, b0, b1, ids != nullptr ? ids + wg * KW : nullptr, id0, id1, wg * KW, N,
                     scale, t4);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(q_empty);  // Q and the ids are spent
    float m2[2], il[2];
    softmax<NC>(sc, red, wg, lr0, t4, dead, m2, il);

    // O = P V, each chunk's product in its own accumulator added to O.
    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int idx = fill0 + 2 * NC + 2 * c + wg;
      const unsigned char* vc = ring.wait(idx);
      uint32_t pb[8][4], ps[8][4];
      if (!dead) {
        if (c < NC - 1)
          tf_frags<8>(pb, ps, sc[c]);
        else
          tf_frags<1>(pb, ps, sc[c]);
      }
      float pv[16];
      hopper::wgmma_fence();
      if (c < NC - 1)
        tf_ab<8>(pv, pb, ps, vc, kTfPart, false);
      else
        tf_ab<1>(pv, pb, ps, vc, kTfPart, false);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(pv);
      ring.release(idx, lane);
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] += pv[i];
    }
    tf_hand_over(acc, xch, wg, t128);
    if (wg == 0) tf_store(acc, o + w * ob + h * oh, on, q0, N, D, 1.f, warp, g, t4);
  }
}

// ---------------------------------------------------------------------------
// Kernel 9 in f32, launch 1: row statistics and dQ, one block per (head,
// 64-query tile, window group)
// ---------------------------------------------------------------------------

template <int KW>
__global__ void __launch_bounds__(kThreads, 1)
window_bwd_dq_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tg,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tk8,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tv8,
                          const __grid_constant__ CUtensorMap tkt, float* __restrict__ dq,
                          const float* __restrict__ bias, const int* __restrict__ rid,
                          float* __restrict__ stats, int BW, int H, int N, int D, int nW,
                          int per_group, long long dqb, long long dqn, long long dqh,
                          float scale) {
  constexpr int NC = Geo<KW>::kChunks;
  constexpr int S = kTfDqSlots;
  using Gt = TfRowsGeo<S, 2>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = wgtile::align1024(smem_raw);
  unsigned char* q_s = smem + Gt::kStageOff;  // Q big, Q small
  unsigned char* g_s = q_s + kTfSlotBytes;    // dO big, dO small
  const int BS = bias_stride(N);
  float* bias_s = reinterpret_cast<float*>(smem + Gt::kBiasOff);
  float* red = bias_s + 64 * BS;  // [3][2][64]: max, sum, delta
  float* xch = red + 3 * 128;
  int* ids_s = reinterpret_cast<int*>(xch + 16 * 128);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ids_s + kIds);
  uint64_t* q_empty = q_full + 1;
  uint64_t* g_full = q_empty + 1;
  uint64_t* g_empty = g_full + 1;
  const TfRing<S, kTfSlotBytes> ring{smem, g_empty + 1, g_empty + 1 + S};
  const int h = blockIdx.x, q0 = blockIdx.y * 64;
  const int w0 = blockIdx.z * per_group, w_end = min(BW, w0 + per_group);
  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, rid != nullptr ? 33 : 1);
    hopper::mbar_init(q_empty, kConsumerWarps);
    hopper::mbar_init(g_full, 1);
    hopper::mbar_init(g_empty, kConsumerWarps);
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&ring.full[s], 1);
      hopper::mbar_init(&ring.empty[s], 4);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    hopper::regs_release<kProducerRegs>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    int idx = 0;  // ring fills so far (lane 0)
    for (int w = w0, n = 0; w < w_end; ++w, ++n) {
      const int plane = 2 * (w * H + h);
      hopper::mbar_wait(q_empty, (n & 1) ^ 1);
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(q_full, 2 * kTfPart);
        tf_load_rows(q_s, kTfPart, &tq, q_full, q0, plane);
      }
      if (rid != nullptr) produce_ids(ids_s, rid, w, nW, N, q_full, lane);
      if (lane == 0) {
        // In the consumers' order, the warpgroups alternating: K chunks (S),
        // dO, V chunks (delta), then each chunk's V and its K^T (ds, dQ).
        for (int c = 0; c < NC; ++c)
          for (int i = 0; i < 2; ++i, ++idx) {
            const bool last = c == NC - 1;
            unsigned char* d = ring.acquire(idx, last ? 2 * 8 * 128 : 2 * kTfPart);
            tf_load_rows(d, kTfPart, last ? &tk8 : &tk, ring.bar(idx), i * KW + 64 * c, plane);
          }
        hopper::mbar_wait(g_empty, (n & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(g_full, 2 * kTfPart);
        tf_load_rows(g_s, kTfPart, &tg, g_full, q0, plane);
        for (int c = 0; c < NC; ++c)
          for (int i = 0; i < 2; ++i, ++idx) {
            const bool last = c == NC - 1;
            unsigned char* d = ring.acquire(idx, last ? 2 * 8 * 128 : 2 * kTfPart);
            tf_load_rows(d, kTfPart, last ? &tv8 : &tv, ring.bar(idx), i * KW + 64 * c, plane);
          }
        for (int c = 0; c < NC; ++c) {
          const bool last = c == NC - 1;
          for (int i = 0; i < 2; ++i, ++idx) {
            unsigned char* d = ring.acquire(idx, last ? 2 * 8 * 128 : 2 * kTfPart);
            tf_load_rows(d, kTfPart, last ? &tv8 : &tv, ring.bar(idx), i * KW + 64 * c, plane);
          }
          for (int i = 0; i < 2; ++i, ++idx) {
            unsigned char* d = ring.acquire(idx, (last ? 2 : 4) * kTfPanel);
            tf_load_cols(d, kTfPart, last ? 1 : 2, &tkt, ring.bar(idx), i * KW + 64 * c, plane);
          }
        }
      }
      __syncwarp();
    }
    return;
  }
  hopper::regs_claim<kConsumerRegs>();
  const int tid = threadIdx.x - 128, wg = tid / 128, t128 = tid % 128;
  const int warp = t128 / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int lr0 = 16 * warp + g;
  const bool dead = q0 + 16 * warp >= N;  // this warp's rows all past N (never stored)
  copy_bias_rows(bias_s, bias, h, q0, N, BS, tid);
  cp_async_wait<0>();
  hopper::named_sync(kBar, kConsumers);
  const float* b0 = bias_s + lr0 * BS + wg * KW;
  const float* b1 = b0 + 8 * BS;

  for (int w = w0, n = 0; w < w_end; ++w, ++n) {
    const int fill0 = n * 8 * NC;
    hopper::mbar_wait(q_full, n & 1);
    const int* ids = rid != nullptr && ids_s[kIds - 1] ? ids_s : nullptr;
    const int id0 = ids != nullptr ? ids[min(q0 + lr0, N - 1)] : 0;
    const int id1 = ids != nullptr ? ids[min(q0 + lr0 + 8, N - 1)] : 0;

    float sc[NC][32];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int idx = fill0 + 2 * c + wg;
      const unsigned char* kc = ring.wait(idx);
      hopper::wgmma_fence();
      if (c < NC - 1)
        tf_abt<64>(sc[c], q_s, kTfPart, kc, kTfPart);
      else
        tf_abt<8>(sc[c], q_s, kTfPart, kc, kTfPart);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      if (c < NC - 1)
        hopper::fence_regs(sc[c]);
      else
        fence_first<4>(sc[c]);
      ring.release(idx, lane);
    }
    if (!dead)
      row_logits<NC>(sc, b0, b1, ids != nullptr ? ids + wg * KW : nullptr, id0, id1, wg * KW, N,
                     scale, t4);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(q_empty);  // Q and the ids are spent
    float m2[2], il[2];
    softmax<NC>(sc, red, wg, lr0, t4, dead, m2, il);

    // delta = sum_k P dP over both warpgroups, dP = dO V^T a chunk at a time.
    hopper::mbar_wait(g_full, n & 1);
    float dd[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int idx = fill0 + 2 * NC + 2 * c + wg;
      const unsigned char* vc = ring.wait(idx);
      float dp[32];
      hopper::wgmma_fence();
      if (c < NC - 1)
        tf_abt<64>(dp, g_s, kTfPart, vc, kTfPart);
      else
        tf_abt<8>(dp, g_s, kTfPart, vc, kTfPart);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      if (c < NC - 1)
        hopper::fence_regs(dp);
      else
        fence_first<4>(dp);
      ring.release(idx, lane);
      if (!dead) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (live<NC>(c, i))
            dd[(i >> 1) & 1][i & 1] = fmaf(sc[c][i], dp[i], dd[(i >> 1) & 1][i & 1]);
      }
    }
    float part[2], a[2], b[2], delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) part[r] = quad_sum(dd[r][0] + dd[r][1]);
    exchange(red, 2, wg, lr0, t4, part, a, b);
#pragma unroll
    for (int r = 0; r < 2; ++r) delta[r] = a[r] + b[r];
    if (wg == 0 && t4 == 0) {
      float* stw = stats + ((long long)w * H + h) * 3 * N;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + lr0 + 8 * r;
        if (row < N) {
          stw[row] = m2[r] - log2f(il[r]);  // the base-2 log-sum-exp
          stw[2 * N + row] = delta[r];
        }
      }
    }

    // dQ = ds K: per chunk dP again, ds = P (dP - delta) split as the A
    // operand, the chunk's product in its own accumulator added to dQ.
    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int idx = fill0 + 4 * NC + 4 * c + wg;  // the chunk's V; its K^T at idx + 2
      const unsigned char* vc = ring.wait(idx);
      float dp[32];
      hopper::wgmma_fence();
      if (c < NC - 1)
        tf_abt<64>(dp, g_s, kTfPart, vc, kTfPart);
      else
        tf_abt<8>(dp, g_s, kTfPart, vc, kTfPart);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      if (c < NC - 1)
        hopper::fence_regs(dp);
      else
        fence_first<4>(dp);
      ring.release(idx, lane);
      uint32_t fb[8][4], fs[8][4];
      if (!dead) {
        if (c < NC - 1)
          tf_ds_frags<8>(fb, fs, sc[c], dp, delta);
        else
          tf_ds_frags<1>(fb, fs, sc[c], dp, delta);
      }
      const unsigned char* kt = ring.wait(idx + 2);
      float dqc[16];
      hopper::wgmma_fence();
      if (c < NC - 1)
        tf_ab<8>(dqc, fb, fs, kt, kTfPart, false);
      else
        tf_ab<1>(dqc, fb, fs, kt, kTfPart, false);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dqc);
      ring.release(idx + 2, lane);
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] += dqc[i];
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(g_empty);  // dO is spent
    tf_hand_over(acc, xch, wg, t128);
    if (wg == 0) tf_store(acc, dq + w * dqb + h * dqh, dqn, q0, N, D, scale, warp, g, t4);
  }
}

// ---------------------------------------------------------------------------
// Kernel 9 in f32, launch 2: dK, dV and dbias, one block per (head, 64-key
// tile, window group)
// ---------------------------------------------------------------------------

// One step of W (32, or 8 at the end) queries from `col0` of a warpgroup's
// range, keys as rows, its four operands fills f .. f + 3 of the ring (Q,
// dO rows; Q^T, dO^T cols): S^T = K Q^T and dP^T = V dO^T, dkv_scores, then
// dV += P^T dO and dK += ds^T Q with P^T and ds^T split as register A
// operands.
template <int W, typename Ring>
__device__ __forceinline__ void tf_dkv_step(float (&db)[16], float (&adk)[16], float (&adv)[16],
                                            const unsigned char* kv, const Ring& ring, int f,
                                            const DkvRows& r, int col0, float scale, int t4,
                                            int lane) {
  constexpr int L = W / 2, KK = W / 8;
  float st[16], dpt[16];
  const unsigned char* qr = ring.wait(f);
  const unsigned char* gr = ring.wait(f + 1);
  hopper::wgmma_fence();
  tf_abt<W>(st, kv, kTfPart, qr, kTfPanel);
  tf_abt<W>(dpt, kv + 2 * kTfPart, kTfPart, gr, kTfPanel);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  fence_first<L>(st);
  fence_first<L>(dpt);
  ring.release(f, lane);
  ring.release(f + 1, lane);
  dkv_scores<W>(st, dpt, db, r, col0, scale, t4);
  uint32_t pb[8][4], ps[8][4], fb[8][4], fs[8][4];
  tf_frags<KK>(pb, ps, st);
  tf_frags<KK>(fb, fs, dpt);
  const unsigned char* qt = ring.wait(f + 2);
  const unsigned char* gt = ring.wait(f + 3);
  hopper::wgmma_fence();
  tf_ab<KK>(adv, pb, ps, gt, kTfPanel, true);
  tf_ab<KK>(adk, fb, fs, qt, kTfPanel, true);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(adv);
  hopper::fence_regs(adk);
  ring.release(f + 2, lane);
  ring.release(f + 3, lane);
}

// Shared memory of the dK/dV launch: the ring; one window's K and V (big,
// small); the hand-over buffer (32 f32 a thread); the bias columns (64 keys x
// BS); one window's statistics (3 x 2 KW) and region ids; the barriers.
template <int KW>
struct TfDkvGeo {
  static constexpr int kSQ = 2 * KW;
  static constexpr int kKvOff = kTfDkvSlots * kTfDkvSlotBytes;
  static constexpr int kXchOff = kKvOff + 4 * kTfPart;
  static constexpr int kBiasOff = kXchOff + 32 * 128 * 4;
  __host__ __device__ static size_t bytes(int N) {
    return 1024 + kBiasOff + 4 * ((size_t)64 * bias_stride(N) + 3 * kSQ + kIds)
           + 8 * (2 + 2 * kTfDkvSlots);
  }
};

template <int KW>
__global__ void __launch_bounds__(kThreads, 1)
window_bwd_dkv_tf32_kernel(const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tq8,
                           const __grid_constant__ CUtensorMap tg,
                           const __grid_constant__ CUtensorMap tg8,
                           const __grid_constant__ CUtensorMap tqt,
                           const __grid_constant__ CUtensorMap tgt, float* __restrict__ dk,
                           float* __restrict__ dv, const float* __restrict__ bias,
                           const int* __restrict__ rid, const float* __restrict__ stats,
                           float* __restrict__ dbias_out, int BW, int H, int N, int D, int nW,
                           int per_group, long long dkb, long long dkn, long long dkh,
                           long long dvb, long long dvn, long long dvh, float scale) {
  using Dg = TfDkvGeo<KW>;
  constexpr int NC = Geo<KW>::kChunks;
  constexpr int kSQ = Dg::kSQ;
  constexpr int kSteps = 2 * (NC - 1) + 1;  // 32-query steps, the last 8 wide
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = wgtile::align1024(smem_raw);
  unsigned char* kv_s = smem + Dg::kKvOff;  // K big, K small, V big, V small
  float* xch = reinterpret_cast<float*>(smem + Dg::kXchOff);
  const int BS = bias_stride(N);
  float* bias_t = reinterpret_cast<float*>(smem + Dg::kBiasOff);  // [key][query]
  float* stats_s = bias_t + 64 * BS;                                // [3][kSQ]
  int* ids_s = reinterpret_cast<int*>(stats_s + 3 * kSQ);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(ids_s + kIds);
  uint64_t* kv_empty = kv_full + 1;
  const TfRing<kTfDkvSlots, kTfDkvSlotBytes> ring{smem, kv_empty + 1,
                                                  kv_empty + 1 + kTfDkvSlots};
  const int h = blockIdx.x, k0 = blockIdx.y * 64;
  const int w0 = blockIdx.z * per_group, w_end = min(BW, w0 + per_group);
  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, rid != nullptr ? 65 : 33);
    hopper::mbar_init(kv_empty, kConsumerWarps);
    for (int s = 0; s < kTfDkvSlots; ++s) {
      hopper::mbar_init(&ring.full[s], 1);
      hopper::mbar_init(&ring.empty[s], 4);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    hopper::regs_release<kProducerRegs>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    int idx = 0;  // ring fills so far (lane 0)
    for (int w = w0, n = 0; w < w_end; ++w, ++n) {
      const int plane = 2 * (w * H + h);
      hopper::mbar_wait(kv_empty, (n & 1) ^ 1);
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(kv_full, 4 * kTfPart);
        tf_load_rows(kv_s, kTfPart, &tk, kv_full, k0, plane);
        tf_load_rows(kv_s + 2 * kTfPart, kTfPart, &tv, kv_full, k0, plane);
      }
      const float* src = stats + ((long long)w * H + h) * 3 * N;
      for (int a = 0; a < 3; a += 2)  // the log-sum-exp and delta
        for (int i = lane; i < N; i += 32) cp_async4(stats_s + a * kSQ + i, src + a * N + i, true);
      cp_async_arrive(kv_full);
      if (rid != nullptr) produce_ids(ids_s, rid, w, nW, N, kv_full, lane);
      if (lane == 0) {
        for (int u = 0; u < kSteps; ++u)
          for (int i = 0; i < 2; ++i) {
            const bool last = u == kSteps - 1;
            const int q = i * KW + 32 * u;
            const uint32_t rows_bytes = last ? 2 * 8 * 128 : 2 * kTfPanel;
            unsigned char* d = ring.acquire(idx, rows_bytes);
            tf_load_rows(d, kTfPanel, last ? &tq8 : &tq, ring.bar(idx), q, plane);
            ++idx;
            d = ring.acquire(idx, rows_bytes);
            tf_load_rows(d, kTfPanel, last ? &tg8 : &tg, ring.bar(idx), q, plane);
            ++idx;
            d = ring.acquire(idx, 2 * kTfPanel);
            tf_load_cols(d, kTfPanel, 1, &tqt, ring.bar(idx), q, plane);
            ++idx;
            d = ring.acquire(idx, 2 * kTfPanel);
            tf_load_cols(d, kTfPanel, 1, &tgt, ring.bar(idx), q, plane);
            ++idx;
          }
      }
      __syncwarp();
    }
    return;
  }
  hopper::regs_claim<kConsumerRegs>();
  const int tid = threadIdx.x - 128, wg = tid / 128, t128 = tid % 128;
  const int warp = t128 / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  copy_bias_cols(bias_t, bias, h, k0, N, BS, tid);
  const int kl0 = 16 * warp + g;
  const int q_base = wg * KW;
  const float* b0 = bias_t + kl0 * BS + q_base;
  const float* b1 = b0 + 8 * BS;
  // dbias^T of this warpgroup's queries, summed over the windows: one
  // 16-accumulator array per 32-query step (the last step 8 wide, 4 live).
  float db[kSteps][16];
#pragma unroll
  for (int u = 0; u < kSteps; ++u)
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (u < kSteps - 1 || i < 4) db[u][i] = 0.f;

  for (int w = w0, n = 0; w < w_end; ++w, ++n) {
    hopper::mbar_wait(kv_full, n & 1);
    DkvRows rows{b0, b1, stats_s + q_base, nullptr, 0, 0, N - q_base, kSQ,
                 k0 + 16 * warp >= N};
    if (rid != nullptr && ids_s[kIds - 1]) {
      rows.qid = ids_s + q_base;
      rows.kid0 = ids_s[min(k0 + kl0, N - 1)];
      rows.kid1 = ids_s[min(k0 + kl0 + 8, N - 1)];
    }
    float adk[16], adv[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) adk[i] = adv[i] = 0.f;
    const int fill0 = n * kSteps * 8 + 4 * wg;
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      if (u < kSteps - 1)
        tf_dkv_step<32>(db[u], adk, adv, kv_s, ring, fill0 + 8 * u, rows, 32 * u, scale, t4,
                        lane);
      else
        tf_dkv_step<8>(db[u], adk, adv, kv_s, ring, fill0 + 8 * u, rows, 32 * u, scale, t4,
                       lane);
    }

    // Warpgroup 1's partial dK, dV to warpgroup 0, once warpgroup 0 has
    // read the previous window's (barrier kXchBar).
    if (wg == 1) {
      if (n > 0) hopper::named_sync(kXchBar, kConsumers);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        xch[i * 128 + t128] = adk[i];
        xch[(16 + i) * 128 + t128] = adv[i];
      }
    }
    hopper::named_sync(kBar, kConsumers);
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        adk[i] += xch[i * 128 + t128];
        adv[i] += xch[(16 + i) * 128 + t128];
      }
      if (w + 1 < w_end) hopper::named_arrive(kXchBar, kConsumers);
      tf_store(adk, dk + w * dkb + h * dkh, dkn, k0, N, D, scale, warp, g, t4);
      tf_store(adv, dv + w * dvb + h * dvh, dvn, k0, N, D, 1.f, warp, g, t4);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(kv_empty);
  }

  // This block's dbias partial: ds summed over its windows, (query, key).
  float* out = dbias_out + ((long long)blockIdx.z * H + h) * N * N;
#pragma unroll
  for (int u = 0; u < kSteps; ++u)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (u == kSteps - 1 && i >= 4) continue;
      const int key = k0 + kl0 + 8 * ((i >> 1) & 1);
      const int q = q_base + 32 * u + 8 * (i >> 2) + 2 * t4 + (i & 1);
      if (key < N && q < N) out[(long long)q * N + key] = db[u][i];
    }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

// The current device's SM count, looked up once a device.
int sm_count() {
  static int cached[16] = {};
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess) return sms;
  if (dev >= 0 && dev < 16 && cached[dev] > 0) return cached[dev];
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (dev >= 0 && dev < 16) cached[dev] = sms;
  return sms;
}

// Windows a block walks in the forward and the dQ launch: `units` (head,
// tile) pairs, one block an SM; minimises (waves of blocks) x (windows a
// block walks + 2, its bias copy and pipeline fill).
int windows_a_block(int BW, int units, int sms) {
  int best = BW;
  long long best_cost = -1;
  for (int groups = 1; groups <= BW && groups <= 256; ++groups) {
    const int per = (BW + groups - 1) / groups;
    const long long blocks = (long long)units * ((BW + per - 1) / per);
    const long long cost = (blocks + sms - 1) / sms * (per + 2);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = per;
    }
  }
  return best;
}

// A bf16 map over (BW, N, H, D) with strides st[0..2], boxes of 32 columns x
// `rows` rows, 64-byte swizzle.
bool map(CUtensorMap* m, int* pos, const void* base, int BW, int N, int H, int D,
         const long long* st, int rows) {
  return hopper::encode_bnhd_map(m, base, BW, N, H, D, st[0], st[1], st[2], 32, rows,
                                 CU_TENSOR_MAP_SWIZZLE_64B, pos);
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Shared memory of the forward and the dQ launch: two stages, the bias
// rows, the exchange rows, two windows' region ids, the barriers.
size_t rows_smem(int stage, int N) {
  return 1024 + 2 * (size_t)stage + 4 * ((size_t)64 * bias_stride(N) + 3 * 128 + 2 * kIds) + 32;
}

template <int KW, int MODE>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, const float* bias,
                       const int* rid, int BW, int H, int N, int D, int nW, const long long* st,
                       float scale, cudaStream_t s) {
  CUtensorMap tq, tk, tv;
  int pq, pk, pv;
  if (!map(&tq, &pq, q, BW, N, H, D, st, 64) || !map(&tk, &pk, k, BW, N, H, D, st + 3, KW)
      || !map(&tv, &pv, v, BW, N, H, D, st + 6, KW))
    return cudaErrorInvalidValue;
  const size_t smem = rows_smem(fwd_stage<KW>(), N);
  cudaError_t err = set_smem(window_fwd_wgmma_kernel<KW, MODE>, smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (N + 63) / 64;
  const int per = windows_a_block(BW, H * n_qt, sm_count());
  window_fwd_wgmma_kernel<KW, MODE><<<dim3(H, n_qt, (BW + per - 1) / per), kThreads, smem, s>>>(
      tq, tk, tv, static_cast<bf16*>(o), bias, rid, BW, H, N, D, nW, per, st[9], st[10], st[11],
      scale, pq, pk, pv);
  return cudaGetLastError();
}

// Kernel 12: HB heads of a window a block (windows_a_block sizes the window
// groups over the (head group, query tile) pairs).
template <int KW>
cudaError_t launch_fwd_heads(const void* q, const void* k, const void* v, void* o,
                             const float* bias, const int* rid, int BW, int H, int HB, int N,
                             int D, int nW, const long long* st, float scale, cudaStream_t s) {
  CUtensorMap tq, tk, tk16, tv, tv16, tb, tb8;
  int pq, pk, pv, unused;
  if (!map(&tq, &pq, q, BW, N, H, D, st, 64) || !map(&tk, &pk, k, BW, N, H, D, st + 3, 64)
      || !map(&tk16, &unused, k, BW, N, H, D, st + 3, kHbNarrowRows)
      || !map(&tv, &pv, v, BW, N, H, D, st + 6, 64)
      || !map(&tv16, &unused, v, BW, N, H, D, st + 6, kHbNarrowRows)
      || !hopper::encode_planes_f32(&tb, bias, N, N, H, N, (long long)N * N, 32, 64)
      || !hopper::encode_planes_f32(&tb8, bias, N, N, H, N, (long long)N * N, 8, 64,
                                    CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  const size_t smem = heads_smem<KW>();
  cudaError_t err = set_smem(window_fwd_heads_kernel<KW>, smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (N + 63) / 64;
  const int per = windows_a_block(BW, H / HB * n_qt, sm_count());
  window_fwd_heads_kernel<KW><<<dim3(H / HB, n_qt, (BW + per - 1) / per), kThreads, smem, s>>>(
      tq, tk, tk16, tv, tv16, tb, tb8, static_cast<bf16*>(o), rid, BW, HB, N, D, nW, per, st[9],
      st[10], st[11], scale, pq, pk, pv);
  return cudaGetLastError();
}

template <int KW>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* g,
                       const float* bias, const int* rid, void* dq, void* dk, void* dv,
                       float* dbias, float* stats, float* partial, int BW, int H, int N, int D,
                       int nW, int per_group, int groups, const long long* st, float scale,
                       cudaStream_t s) {
  // Maps of 64-row boxes (q, g; k, v for the dK/dV launch) and of KW-row
  // boxes (k, v for the dQ launch).
  CUtensorMap tq, tg, tk64, tv64, tk, tv;
  int pq, pg, pk64, pv64, pk, pv;
  if (!map(&tq, &pq, q, BW, N, H, D, st, 64) || !map(&tg, &pg, g, BW, N, H, D, st + 9, 64)
      || !map(&tk64, &pk64, k, BW, N, H, D, st + 3, 64)
      || !map(&tv64, &pv64, v, BW, N, H, D, st + 6, 64)
      || !map(&tk, &pk, k, BW, N, H, D, st + 3, KW) || !map(&tv, &pv, v, BW, N, H, D, st + 6, KW))
    return cudaErrorInvalidValue;
  const int n_t = (N + 63) / 64;
  const size_t smem_dq = rows_smem(dq_stage<KW>(), N);
  cudaError_t err = set_smem(window_bwd_dq_wgmma_kernel<KW>, smem_dq);
  if (err != cudaSuccess) return err;
  const int per = windows_a_block(BW, H * n_t, sm_count());
  window_bwd_dq_wgmma_kernel<KW><<<dim3(H, n_t, (BW + per - 1) / per), kThreads, smem_dq, s>>>(
      tq, tg, tk, tv, static_cast<bf16*>(dq), bias, rid, stats, BW, H, N, D, nW, per, st[12],
      st[13], st[14], scale, pq, pg, pk, pv);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t smem_dkv = DkvGeo<KW>::bytes(N);
  if ((err = set_smem(window_bwd_dkv_wgmma_kernel<KW>, smem_dkv)) != cudaSuccess) return err;
  window_bwd_dkv_wgmma_kernel<KW><<<dim3(H, n_t, groups), kThreads, smem_dkv, s>>>(
      tq, tg, tk64, tv64, static_cast<bf16*>(dk), static_cast<bf16*>(dv), bias, rid, stats,
      groups > 1 ? partial : dbias, BW, H, N, D, nW, per_group, st[15], st[16], st[17], st[18],
      st[19], st[20], scale, pq, pg, pk64, pv64);
  return cudaGetLastError();
}

// The f32 design's pre-pass: x (strides st[0..2]) into its rows and / or
// cols forms.
cudaError_t tf_split(const void* x, const long long* st, float* rows, float* cols, int BW, int H,
                     int N, int D, cudaStream_t s) {
  tf32_split_kernel<<<dim3((tf32_np(N) + 31) / 32, H, BW), 256, 0, s>>>(
      static_cast<const float*>(x), rows, cols, H, N, tf32_np(N), D, st[0], st[1], st[2]);
  return cudaGetLastError();
}

// Maps over a rows form (boxes of `box` rows) and a cols form (boxes of 32
// positions x 32 rows).
bool tf_rows_map(CUtensorMap* m, const float* form, int BW, int H, int N, int box) {
  return hopper::encode_planes_f32(m, form, 32, N, 2LL * BW * H, 32, 32LL * tf32_np(N), 32, box);
}
bool tf_cols_map(CUtensorMap* m, const float* form, int BW, int H, int N) {
  const int np = tf32_np(N);
  return hopper::encode_planes_f32(m, form, np, 32, 2LL * BW * H, np, 32LL * np, 32, 32);
}

template <int KW>
cudaError_t launch_fwd_tf32(const void* q, const void* k, const void* v, void* o,
                            const float* bias, const int* rid, float* split, int BW, int H, int N,
                            int D, int nW, const long long* st, float scale, cudaStream_t s) {
  const size_t F = split_form_floats(BW, H, N);
  float *fq = split, *fk = split + F, *fv = split + 2 * F;
  cudaError_t err;
  if ((err = tf_split(q, st, fq, nullptr, BW, H, N, D, s)) != cudaSuccess
      || (err = tf_split(k, st + 3, fk, nullptr, BW, H, N, D, s)) != cudaSuccess
      || (err = tf_split(v, st + 6, nullptr, fv, BW, H, N, D, s)) != cudaSuccess)
    return err;
  CUtensorMap tq, tk, tk8, tvt;
  if (!tf_rows_map(&tq, fq, BW, H, N, 64) || !tf_rows_map(&tk, fk, BW, H, N, 64)
      || !tf_rows_map(&tk8, fk, BW, H, N, 8) || !tf_cols_map(&tvt, fv, BW, H, N))
    return cudaErrorInvalidValue;
  const size_t smem = TfRowsGeo<kTfFwdSlots, 1>::bytes(N);
  if ((err = set_smem(window_fwd_tf32_kernel<KW>, smem)) != cudaSuccess) return err;
  const int n_qt = (N + 63) / 64;
  const int per = windows_a_block(BW, H * n_qt, sm_count());
  window_fwd_tf32_kernel<KW><<<dim3(H, n_qt, (BW + per - 1) / per), kThreads, smem, s>>>(
      tq, tk, tk8, tvt, static_cast<float*>(o), bias, rid, BW, H, N, D, nW, per, st[9], st[10],
      st[11], scale);
  return cudaGetLastError();
}

template <int KW>
cudaError_t launch_bwd_tf32(const void* q, const void* k, const void* v, const void* g,
                            const float* bias, const int* rid, void* dq, void* dk, void* dv,
                            float* dbias, float* stats, float* partial, float* split, int BW,
                            int H, int N, int D, int nW, int per_group, int groups,
                            const long long* st, float scale, cudaStream_t s) {
  // Forms: q rows, q cols, k rows, k cols, v rows, dO rows, dO cols.
  const size_t F = split_form_floats(BW, H, N);
  float* f[7];
  for (int i = 0; i < 7; ++i) f[i] = split + i * F;
  cudaError_t err;
  if ((err = tf_split(q, st, f[0], f[1], BW, H, N, D, s)) != cudaSuccess
      || (err = tf_split(k, st + 3, f[2], f[3], BW, H, N, D, s)) != cudaSuccess
      || (err = tf_split(v, st + 6, f[4], nullptr, BW, H, N, D, s)) != cudaSuccess
      || (err = tf_split(g, st + 9, f[5], f[6], BW, H, N, D, s)) != cudaSuccess)
    return err;
  CUtensorMap tq, tq32, tq8, tqt, tk, tk8, tkt, tv, tv8, tg, tg32, tg8, tgt;
  if (!tf_rows_map(&tq, f[0], BW, H, N, 64) || !tf_rows_map(&tq32, f[0], BW, H, N, 32)
      || !tf_rows_map(&tq8, f[0], BW, H, N, 8) || !tf_cols_map(&tqt, f[1], BW, H, N)
      || !tf_rows_map(&tk, f[2], BW, H, N, 64) || !tf_rows_map(&tk8, f[2], BW, H, N, 8)
      || !tf_cols_map(&tkt, f[3], BW, H, N) || !tf_rows_map(&tv, f[4], BW, H, N, 64)
      || !tf_rows_map(&tv8, f[4], BW, H, N, 8) || !tf_rows_map(&tg, f[5], BW, H, N, 64)
      || !tf_rows_map(&tg32, f[5], BW, H, N, 32) || !tf_rows_map(&tg8, f[5], BW, H, N, 8)
      || !tf_cols_map(&tgt, f[6], BW, H, N))
    return cudaErrorInvalidValue;
  const int n_t = (N + 63) / 64;
  const size_t smem_dq = TfRowsGeo<kTfDqSlots, 2>::bytes(N);
  if ((err = set_smem(window_bwd_dq_tf32_kernel<KW>, smem_dq)) != cudaSuccess) return err;
  const int per = windows_a_block(BW, H * n_t, sm_count());
  window_bwd_dq_tf32_kernel<KW><<<dim3(H, n_t, (BW + per - 1) / per), kThreads, smem_dq, s>>>(
      tq, tg, tk, tk8, tv, tv8, tkt, static_cast<float*>(dq), bias, rid, stats, BW, H, N, D, nW,
      per, st[12], st[13], st[14], scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t smem_dkv = TfDkvGeo<KW>::bytes(N);
  if ((err = set_smem(window_bwd_dkv_tf32_kernel<KW>, smem_dkv)) != cudaSuccess) return err;
  window_bwd_dkv_tf32_kernel<KW><<<dim3(H, n_t, groups), kThreads, smem_dkv, s>>>(
      tk, tv, tq32, tq8, tg32, tg8, tqt, tgt, static_cast<float*>(dk), static_cast<float*>(dv),
      bias, rid, stats, groups > 1 ? partial : dbias, BW, H, N, D, nW, per_group, st[15], st[16],
      st[17], st[18], st[19], st[20], scale);
  return cudaGetLastError();
}

}  // namespace

size_t split_form_floats(int BW, int H, int N) { return 2ULL * BW * H * tf32_np(N) * 32; }

bool takes_tf32(int dtype, int N, int D, const long long* st, int n) {
  if (dtype != 0 || N < 1 || N > kMaxN || D > 32) return false;
  for (int i = 0; i < n; ++i)
    if (st[i] <= 0) return false;
  return true;
}

// KW by N, as the bf16 design.
cudaError_t fwd_tf32(const void* q, const void* k, const void* v, void* o, const float* bias,
                     const int* rid, float* split, int BW, int H, int N, int D, int nW,
                     const long long* st, float scale, cudaStream_t s) {
#define WINTF_FWD(KW) \
  return launch_fwd_tf32<KW>(q, k, v, o, bias, rid, split, BW, H, N, D, nW, st, scale, s)
  if (N <= 144) WINTF_FWD(72);
  if (N <= 272) WINTF_FWD(136);
  WINTF_FWD(200);
#undef WINTF_FWD
}

cudaError_t bwd_tf32(const void* q, const void* k, const void* v, const void* g,
                     const float* bias, const int* rid, void* dq, void* dk, void* dv,
                     float* dbias, float* stats, float* partial, float* split, int BW, int H,
                     int N, int D, int nW, int per_group, int groups, const long long* st,
                     float scale, cudaStream_t s) {
#define WINTF_BWD(KW)                                                                          \
  return launch_bwd_tf32<KW>(q, k, v, g, bias, rid, dq, dk, dv, dbias, stats, partial, split, \
                             BW, H, N, D, nW, per_group, groups, st, scale, s)
  if (N <= 144) WINTF_BWD(72);
  if (N <= 272) WINTF_BWD(136);
  WINTF_BWD(200);
#undef WINTF_BWD
}

bool takes(int dtype, int N, int D, const long long* st, int n) {
  if (dtype != 1 || N < 1 || N > kMaxN || D > 32) return false;
  for (int i = 0; i < n; ++i)
    if (st[i] <= 0) return false;
  return true;
}

bool takes_heads(int dtype, int N, int D, const long long* st, int n) {
  return N % 4 == 0 && takes(dtype, N, D, st, n);
}

// KW by N, as fwd.
cudaError_t fwd_heads(const void* q, const void* k, const void* v, void* o, const float* bias,
                      const int* rid, int BW, int H, int HB, int N, int D, int nW,
                      const long long* st, float scale, cudaStream_t s) {
  if (HB < 1 || H % HB != 0) return cudaErrorInvalidValue;
#define WINWG_HEADS(KW) \
  return launch_fwd_heads<KW>(q, k, v, o, bias, rid, BW, H, HB, N, D, nW, st, scale, s)
  if (N <= 144) WINWG_HEADS(72);
  if (N <= 272) WINWG_HEADS(136);
  WINWG_HEADS(200);
#undef WINWG_HEADS
}

// KW by N: 72 (N <= 144), 136 (N <= 272), 200 (N <= 400); the softmax mode
// a template parameter.
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, const float* bias,
                const int* rid, int BW, int H, int N, int D, int nW, const long long* st,
                float scale, int mode, cudaStream_t s) {
#define WINWG_FWD(KW, MODE) \
  return launch_fwd<KW, MODE>(q, k, v, o, bias, rid, BW, H, N, D, nW, st, scale, s)
#define WINWG_FWD_MODES(KW)                    \
  {                                            \
    if (mode == 1) WINWG_FWD(KW, 1);           \
    if (mode == 2) WINWG_FWD(KW, 2);           \
    WINWG_FWD(KW, 0);                          \
  }
  if (mode < 0 || mode > 2) return cudaErrorInvalidValue;
  if (N <= 144) WINWG_FWD_MODES(72);
  if (N <= 272) WINWG_FWD_MODES(136);
  WINWG_FWD_MODES(200);
#undef WINWG_FWD_MODES
#undef WINWG_FWD
}

cudaError_t bwd(const void* q, const void* k, const void* v, const void* g, const float* bias,
                const int* rid, void* dq, void* dk, void* dv, float* dbias, float* stats,
                float* partial, int BW, int H, int N, int D, int nW, int per_group, int groups,
                const long long* st, float scale, cudaStream_t s) {
#define WINWG_BWD(KW)                                                                         \
  return launch_bwd<KW>(q, k, v, g, bias, rid, dq, dk, dv, dbias, stats, partial, BW, H, N, D, \
                        nW, per_group, groups, st, scale, s)
  if (N <= 144) WINWG_BWD(72);
  if (N <= 272) WINWG_BWD(136);
  WINWG_BWD(200);
#undef WINWG_BWD
}

}  // namespace winwg
