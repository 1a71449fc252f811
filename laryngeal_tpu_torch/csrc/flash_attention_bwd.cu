// Flash-attention backward for Hopper (sm_90a), bound through a plain C
// interface (ctypes; see laryngeal_tpu_torch/ops/flash_attention.py).
//
// Replaces two Pallas TPU kernels of laryngeal_tpu/ops/flash_attention.py,
// the two-kernel recompute scheme under its custom_vjp (_flash_backward):
//   * _dq_kernel  (entry flash_attention_bwd_dq): a block owns query rows of
//     one (batch, head) and streams K/V tiles, recomputes S = scale * Q K^T and
//     P = exp(S - lse) (keys >= n_actual give P = 0), dP = dO V^T,
//     dS = P * (dP - delta) rounded to the input dtype, dQ += dS K in f32,
//     and scales dQ by `scale` at the end;
//   * _dkv_kernel (entry flash_attention_bwd_dkv): a block owns key rows and
//     streams Q/dO tiles with their lse / delta,
//     dV += P^T dO (P rounded to the input dtype), dK += dS^T Q, dK scaled
//     by `scale` at the end. Keys >= n_actual get P = 0 and so exactly-zero
//     dK and dV; query rows past Nq are masked to P = 0 as well (the TPU
//     kernel relied on zero-padded dO and delta instead).
// lse and delta are float32 (B, H, Nq) contiguous; delta = rowsum(dO * O) is
// computed by the caller in PyTorch, as the JAX package computes it in XLA.
// The scheme needs no atomics: each block owns its output rows, so the
// result is deterministic.
//
// What bounds it on the H100: at the ViViT-B bf16 shape (B=8, N=3137,
// H=12, D=64) dQ does 3 products of 2*N^2*D per head (6*B*H*N^2*D ~ 3.6e11
// FLOP) and dK/dV 4 (the dK/dV kernel recomputes dP too), against ~0.2 GB
// of traffic: both are bound by tensor-core operations (0.37 and 0.49 ms at
// the bf16 peak), and each does ~9.4e8 exponentials besides. So no (N, N)
// tile ever reaches device memory, and each design keeps one side's rows
// in shared memory while the other side streams past them:
//   * bf16, the wgmma design (dQ at every head dim, dK/dV at D <= 64; the
//     tensor maps need every batch, sequence and head stride positive): a
//     block of a producer warpgroup and two or three consumer warpgroups
//     owns 64 rows per consumer (queries for dQ: three consumers at
//     D <= 64, which need ~140 registers a thread, two at 128; keys for
//     dK/dV: two, which need ~200). The producer thread loads the block's
//     two resident tensors (Q and dO; K and V) once with TMA, then streams
//     the other two in 64-row tiles through a 3-4 stage mbarrier ring that
//     every consumer reads, so each streamed tile feeds 128 or 192 rows;
//     for dK/dV the producer warp also copies each tile's lse and delta with
//     ordinary loads (a row of Nq f32 values is not 16-byte aligned, as TMA
//     needs), lse = +inf past Nq so those queries get P = 0. Per tile a
//     consumer runs the two score products on wgmma m64n64k16 (S = Q K^T
//     and dP = dO V^T, or S^T = K Q^T and dP^T = V dO^T with the keys as
//     rows, both operands K-major in shared memory), forms P and dS in
//     registers from the accumulators, which are already the A fragments of
//     the next products, and runs dQ += dS K (or dV += P^T dO and
//     dK += dS^T Q) as RS wgmma with the streamed tile read MN-major. The
//     accumulators stay in registers for the block's life and are scaled,
//     rounded and stored once. The dK/dV kernel's two consumers take turns
//     issuing their products (named barriers), which is faster there and
//     slower for dQ on the H100. Keys >= n_actual get dK = dV = 0 at the
//     store (a block of masked keys only stores zeros).
//   * bf16, the mma.sync design (dK/dV at D = 128, strides of 0; kept
//     callable at every shape as the _mma entries, to time against):
//     mma.sync.m16n8k16, 4 warps of 16 rows, one block per (batch*head, 64
//     rows). The dK/dV kernel computes S^T = K Q^T and dP^T = V dO^T
//     directly, with the keys as rows, so P^T and dS^T come out of the
//     accumulators in the A-fragment layout of the next products. The
//     streamed tiles are double-buffered with cp.async; rows padded by 8
//     elements for ldmatrix. At D = 128 the dK/dV kernel streams 32-query
//     tiles to keep its two accumulators plus S/dP tiles within the
//     register file.
//   * f32 at D <= 64 with every stride positive: "wgmma.tf32x3", the
//     tensor cores on TF32 operands split into two parts, three products a
//     product, each step's product added on the FMA units
//     (flash_attention_bwd_tf32.cu, linked into this library; launchers in
//     flash_attention_bwd_tf32.cuh).
//   * f32 elsewhere (D = 128, strides of 0; kept callable at every shape as
//     the _mma entries, to time against): on the FMA units, TF32 off (the
//     same reason as the forward): one query row (dQ) or key row (dK/dV) per
//     1-4 threads, each owning a 32-wide slice of the head dim, dot products
//     combined by warp shuffles.
// Not yet done (later work): dK/dV on wgmma at D = 128, f32 at D = 128 on
// the tensor cores.

#include "flash_attention_bwd_tf32.cuh"
#include "flash_attention_common.cuh"
#include "hopper.cuh"
#include "wgmma_tiles.cuh"

namespace {

using namespace flash;
using namespace wgtile;

constexpr int kBM = 64;   // rows each bf16 block owns (16 per warp)
constexpr int kBN = 64;   // dQ: keys per streamed K/V tile

// ---------------------------------------------------------------------------
// bf16: dQ
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kWarps * 32)
dq_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dq, int H, int Nq, int Nk, int D, int n_actual,
               long long sqb, long long sqn, long long sqh, long long skb, long long skn,
               long long skh, long long svb, long long svn, long long svh, long long sdb,
               long long sdn, long long sdh, long long sgb, long long sgn, long long sgh,
               float scale) {
  constexpr int kLd = HD + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* do_s = q_s + kBM * kLd;
  __nv_bfloat16* k_s = do_s + kBM * kLd;      // 2 buffers
  __nv_bfloat16* v_s = k_s + 2 * kBN * kLd;   // 2 buffers

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;

  const __nv_bfloat16* kb = k + b * skb + h * skh;
  const __nv_bfloat16* vb = v + b * svb + h * svh;
  const int n_tiles = (Nk + kBN - 1) / kBN;
  load_tile_async<kBM, HD>(q_s, q + b * sqb + h * sqh, sqn, q0, Nq, D);
  load_tile_async<kBM, HD>(do_s, dout + b * sdb + h * sdh, sdn, q0, Nq, D);
  load_tile_async<kBN, HD>(k_s, kb, skn, 0, Nk, D);
  load_tile_async<kBN, HD>(v_s, vb, svn, 0, Nk, D);
  cp_async_commit();

  // This thread's rows g and g + 8 of the warp's 16: lse (base-2 units)
  // and delta. Rows past Nq read 0 and are never written.
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    const bool ok = row < Nq;
    lse2[r] = ok ? lse[(long long)bh * Nq + row] * kLog2e : 0.f;
    dl[r] = ok ? delta[(long long)bh * Nq + row] : 0.f;
  }
  const float scale_log2 = scale * kLog2e;
  float acc[HD / 8][4];
  zero(acc);

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      load_tile_async<kBN, HD>(k_s + (buf ^ 1) * kBN * kLd, kb, skn, (t + 1) * kBN, Nk, D);
      load_tile_async<kBN, HD>(v_s + (buf ^ 1) * kBN * kLd, vb, svn, (t + 1) * kBN, Nk, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kt = k_s + buf * kBN * kLd;
    const __nv_bfloat16* vt = v_s + buf * kBN * kLd;

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 keys.
    float s[kBN / 8][4], dp[kBN / 8][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      uint32_t a[4];
      load_a_frag<HD>(a, q_s, warp * 16, ks);
#pragma unroll
      for (int nt = 0; nt < kBN / 8; nt += 2) mma_abt<HD>(s[nt], s[nt + 1], a, kt, nt, ks);
      load_a_frag<HD>(a, do_s, warp * 16, ks);
#pragma unroll
      for (int nt = 0; nt < kBN / 8; nt += 2) mma_abt<HD>(dp[nt], dp[nt + 1], a, vt, nt, ks);
    }
    // P = exp(S - lse), masked keys 0; dS = P * (dP - delta), kept in s.
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = t * kBN + nt * 8 + tig * 2 + (j & 1);
        const float p = key < n_actual ? exp2f(s[nt][j] * scale_log2 - lse2[j >> 1]) : 0.f;
        s[nt][j] = p * (dp[nt][j] - dl[j >> 1]);
      }
    }
    // dQ += dS K: dS (rounded to bf16) from registers, K through ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      uint32_t a[4];
      pack_a_frag(a, s, kk);
#pragma unroll
      for (int dt = 0; dt < HD / 8; dt += 2) mma_ab<HD>(acc[dt], acc[dt + 1], a, kt, kk, dt);
    }
    __syncthreads();  // the next iteration's copy overwrites this buffer
  }

  __nv_bfloat16* gb = dq + b * sgb + h * sgh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    if (row >= Nq) continue;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      const int col = dt * 8 + tig * 2;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(gb + row * sgn + col) =
            __floats2bfloat162_rn(acc[dt][2 * r] * scale, acc[dt][2 * r + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: dK, dV
// ---------------------------------------------------------------------------

// Copy lse (in base-2 units) and delta of query rows [row0, row0 + BQ) into
// shared memory; rows past Nq read 0.
template <int BQ>
__device__ __forceinline__ void load_rows(float* lse_s, float* dl_s, const float* lse,
                                          const float* delta, int row0, int Nq) {
  for (int i = threadIdx.x; i < BQ; i += kWarps * 32) {
    const int row = row0 + i;
    lse_s[i] = row < Nq ? lse[row] * kLog2e : 0.f;
    dl_s[i] = row < Nq ? delta[row] : 0.f;
  }
}

template <int HD, int BQ>
__global__ void __launch_bounds__(kWarps * 32)
dkv_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                int H, int Nq, int Nk, int D, int n_actual,
                long long sqb, long long sqn, long long sqh, long long skb, long long skn,
                long long skh, long long svb, long long svn, long long svh, long long sdb,
                long long sdn, long long sdh, long long sgkb, long long sgkn, long long sgkh,
                long long sgvb, long long sgvn, long long sgvh, float scale) {
  constexpr int kLd = HD + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + kBM * kLd;
  __nv_bfloat16* q_s = v_s + kBM * kLd;       // 2 buffers
  __nv_bfloat16* do_s = q_s + 2 * BQ * kLd;   // 2 buffers
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * BQ * kLd);  // 2 buffers
  float* dl_s = lse_s + 2 * BQ;                                   // 2 buffers

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kBM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;

  const __nv_bfloat16* qb = q + b * sqb + h * sqh;
  const __nv_bfloat16* db = dout + b * sdb + h * sdh;
  const float* lse_b = lse + (long long)bh * Nq;
  const float* dl_b = delta + (long long)bh * Nq;
  const int n_tiles = (Nq + BQ - 1) / BQ;
  load_tile_async<kBM, HD>(k_s, k + b * skb + h * skh, skn, k0, Nk, D);
  load_tile_async<kBM, HD>(v_s, v + b * svb + h * svh, svn, k0, Nk, D);
  load_tile_async<BQ, HD>(q_s, qb, sqn, 0, Nq, D);
  load_tile_async<BQ, HD>(do_s, db, sdn, 0, Nq, D);
  cp_async_commit();
  load_rows<BQ>(lse_s, dl_s, lse_b, dl_b, 0, Nq);

  // This thread's key rows g and g + 8 of the warp's 16.
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) key_ok[r] = k0 + warp * 16 + g + r * 8 < n_actual;
  const float scale_log2 = scale * kLog2e;
  float acc_dk[HD / 8][4], acc_dv[HD / 8][4];
  zero(acc_dk);
  zero(acc_dv);

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      load_tile_async<BQ, HD>(q_s + (buf ^ 1) * BQ * kLd, qb, sqn, (t + 1) * BQ, Nq, D);
      load_tile_async<BQ, HD>(do_s + (buf ^ 1) * BQ * kLd, db, sdn, (t + 1) * BQ, Nq, D);
      cp_async_commit();
      // The other buffer was last read before the previous iteration's
      // closing barrier, so it may be overwritten now.
      load_rows<BQ>(lse_s + (buf ^ 1) * BQ, dl_s + (buf ^ 1) * BQ, lse_b, dl_b,
                    (t + 1) * BQ, Nq);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* qt = q_s + buf * BQ * kLd;
    const __nv_bfloat16* dt_s = do_s + buf * BQ * kLd;
    const float* lse_t = lse_s + buf * BQ;
    const float* dl_t = dl_s + buf * BQ;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x BQ queries.
    float st[BQ / 8][4], dpt[BQ / 8][4];
    zero(st);
    zero(dpt);
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      uint32_t a[4];
      load_a_frag<HD>(a, k_s, warp * 16, ks);
#pragma unroll
      for (int nt = 0; nt < BQ / 8; nt += 2) mma_abt<HD>(st[nt], st[nt + 1], a, qt, nt, ks);
      load_a_frag<HD>(a, v_s, warp * 16, ks);
#pragma unroll
      for (int nt = 0; nt < BQ / 8; nt += 2) mma_abt<HD>(dpt[nt], dpt[nt + 1], a, dt_s, nt, ks);
    }
    // P^T (kept in st) and dS^T (kept in dpt); masked keys and query rows
    // past Nq give P = 0.
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = nt * 8 + tig * 2 + (j & 1);
        const bool ok = key_ok[j >> 1] && t * BQ + qi < Nq;
        const float p = ok ? exp2f(st[nt][j] * scale_log2 - lse_t[qi]) : 0.f;
        st[nt][j] = p;
        dpt[nt][j] = p * (dpt[nt][j] - dl_t[qi]);
      }
    }
    // dV += P^T dO and dK += dS^T Q: the A fragments from registers (rounded
    // to bf16), dO and Q through ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t a[4];
      pack_a_frag(a, st, kk);
#pragma unroll
      for (int d8 = 0; d8 < HD / 8; d8 += 2) mma_ab<HD>(acc_dv[d8], acc_dv[d8 + 1], a, dt_s, kk, d8);
      pack_a_frag(a, dpt, kk);
#pragma unroll
      for (int d8 = 0; d8 < HD / 8; d8 += 2) mma_ab<HD>(acc_dk[d8], acc_dk[d8 + 1], a, qt, kk, d8);
    }
    __syncthreads();  // the next iteration's copy overwrites this buffer
  }

  __nv_bfloat16* gk = dk + b * sgkb + h * sgkh;
  __nv_bfloat16* gv = dv + b * sgvb + h * sgvh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + warp * 16 + g + r * 8;
    if (row >= Nk) continue;
#pragma unroll
    for (int d8 = 0; d8 < HD / 8; ++d8) {
      const int col = d8 * 8 + tig * 2;
      if (col < D) {
        *reinterpret_cast<__nv_bfloat162*>(gk + row * sgkn + col) =
            __floats2bfloat162_rn(acc_dk[d8][2 * r] * scale, acc_dk[d8][2 * r + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(gv + row * sgvn + col) =
            __floats2bfloat162_rn(acc_dv[d8][2 * r], acc_dv[d8][2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32 (FMA units): dQ
// ---------------------------------------------------------------------------

constexpr int kF32BN = 32;  // keys (dQ) or queries (dK/dV) per streamed tile

// Sum of a dot-product partial over the kTpr threads that share a row.
template <int kTpr>
__device__ __forceinline__ float row_sum(float part) {
#pragma unroll
  for (int off = kTpr / 2; off > 0; off /= 2) part += __shfl_xor_sync(0xffffffffu, part, off);
  return part;
}

template <int HD>
__global__ void __launch_bounds__(kF32Threads)
dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int H, int Nq, int Nk, int D, int n_actual,
              long long sqb, long long sqn, long long sqh, long long skb, long long skn,
              long long skh, long long svb, long long svn, long long svh, long long sdb,
              long long sdn, long long sdh, long long sgb, long long sgn, long long sgh,
              float scale) {
  constexpr int kTpr = HD / 32;                 // threads per query row
  constexpr int kRows = kF32Threads / kTpr;     // query rows per block
  __shared__ __align__(16) float k_s[kF32BN][HD];
  __shared__ __align__(16) float v_s[kF32BN][HD];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int row = blockIdx.x * kRows + threadIdx.x / kTpr;
  const int c0 = (threadIdx.x % kTpr) * 32;
  const bool row_ok = row < Nq;

  const float* qr_p = q + b * sqb + h * sqh + row * sqn;
  const float* dr_p = dout + b * sdb + h * sdh + row * sdn;
  const float* kb = k + b * skb + h * skh;
  const float* vb = v + b * svb + h * svh;
  float qr[32], dr[32], acc[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const bool ok = row_ok && c0 + c < D;
    qr[c] = ok ? qr_p[c0 + c] : 0.f;
    dr[c] = ok ? dr_p[c0 + c] : 0.f;
    acc[c] = 0.f;
  }
  const float lse_r = row_ok ? lse[(long long)bh * Nq + row] : 0.f;
  const float dl = row_ok ? delta[(long long)bh * Nq + row] : 0.f;

  for (int key0 = 0; key0 < Nk; key0 += kF32BN) {
    __syncthreads();
    for (int i = threadIdx.x; i < kF32BN * HD / 4; i += kF32Threads) {
      const int r = i / (HD / 4), col = (i % (HD / 4)) * 4;
      const int key = key0 + r;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (key < Nk && col < D) {
        kv = *reinterpret_cast<const float4*>(kb + key * skn + col);
        vv = *reinterpret_cast<const float4*>(vb + key * svn + col);
      }
      *reinterpret_cast<float4*>(&k_s[r][col]) = kv;
      *reinterpret_cast<float4*>(&v_s[r][col]) = vv;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kF32BN; ++j) {
      float ps = 0.f, pd = 0.f;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        ps = fmaf(qr[c], k_s[j][c0 + c], ps);
        pd = fmaf(dr[c], v_s[j][c0 + c], pd);
      }
      ps = row_sum<kTpr>(ps);
      pd = row_sum<kTpr>(pd);
      const float p = key0 + j < n_actual ? expf(ps * scale - lse_r) : 0.f;
      const float ds = p * (pd - dl);
#pragma unroll
      for (int c = 0; c < 32; ++c) acc[c] = fmaf(ds, k_s[j][c0 + c], acc[c]);
    }
  }
  if (!row_ok) return;
  float* out = dq + b * sgb + h * sgh + row * sgn;
#pragma unroll
  for (int c = 0; c < 32; ++c)
    if (c0 + c < D) out[c0 + c] = acc[c] * scale;
}

// ---------------------------------------------------------------------------
// f32 (FMA units): dK, dV
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kF32Threads)
dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dk, float* __restrict__ dv,
               int H, int Nq, int Nk, int D, int n_actual,
               long long sqb, long long sqn, long long sqh, long long skb, long long skn,
               long long skh, long long svb, long long svn, long long svh, long long sdb,
               long long sdn, long long sdh, long long sgkb, long long sgkn, long long sgkh,
               long long sgvb, long long sgvn, long long sgvh, float scale) {
  constexpr int kTpr = HD / 32;                 // threads per key row
  constexpr int kRows = kF32Threads / kTpr;     // key rows per block
  __shared__ __align__(16) float q_s[kF32BN][HD];
  __shared__ __align__(16) float do_s[kF32BN][HD];
  __shared__ float lse_s[kF32BN], dl_s[kF32BN];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int key = blockIdx.x * kRows + threadIdx.x / kTpr;
  const int c0 = (threadIdx.x % kTpr) * 32;
  const bool key_in = key < Nk, key_ok = key < n_actual;

  const float* kr_p = k + b * skb + h * skh + key * skn;
  const float* vr_p = v + b * svb + h * svh + key * svn;
  const float* qb = q + b * sqb + h * sqh;
  const float* db = dout + b * sdb + h * sdh;
  float kr[32], vr[32], adk[32], adv[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const bool ok = key_in && c0 + c < D;
    kr[c] = ok ? kr_p[c0 + c] : 0.f;
    vr[c] = ok ? vr_p[c0 + c] : 0.f;
    adk[c] = 0.f;
    adv[c] = 0.f;
  }

  for (int row0 = 0; row0 < Nq; row0 += kF32BN) {
    __syncthreads();
    for (int i = threadIdx.x; i < kF32BN * HD / 4; i += kF32Threads) {
      const int r = i / (HD / 4), col = (i % (HD / 4)) * 4;
      const int row = row0 + r;
      float4 qv = make_float4(0.f, 0.f, 0.f, 0.f), dv4 = qv;
      if (row < Nq && col < D) {
        qv = *reinterpret_cast<const float4*>(qb + row * sqn + col);
        dv4 = *reinterpret_cast<const float4*>(db + row * sdn + col);
      }
      *reinterpret_cast<float4*>(&q_s[r][col]) = qv;
      *reinterpret_cast<float4*>(&do_s[r][col]) = dv4;
    }
    for (int i = threadIdx.x; i < kF32BN; i += kF32Threads) {
      const int row = row0 + i;
      lse_s[i] = row < Nq ? lse[(long long)bh * Nq + row] : 0.f;
      dl_s[i] = row < Nq ? delta[(long long)bh * Nq + row] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kF32BN; ++i) {
      float ps = 0.f, pd = 0.f;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        ps = fmaf(kr[c], q_s[i][c0 + c], ps);
        pd = fmaf(vr[c], do_s[i][c0 + c], pd);
      }
      ps = row_sum<kTpr>(ps);
      pd = row_sum<kTpr>(pd);
      const float p = key_ok && row0 + i < Nq ? expf(ps * scale - lse_s[i]) : 0.f;
      const float ds = p * (pd - dl_s[i]);
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        adv[c] = fmaf(p, do_s[i][c0 + c], adv[c]);
        adk[c] = fmaf(ds, q_s[i][c0 + c], adk[c]);
      }
    }
  }
  if (!key_in) return;
  float* ok_ = dk + b * sgkb + h * sgkh + key * sgkn;
  float* ov = dv + b * sgvb + h * sgvh + key * sgvn;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    if (c0 + c < D) {
      ok_[c0 + c] = adk[c] * scale;
      ov[c0 + c] = adv[c];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on wgmma and TMA: dQ (HD <= 128) and dK/dV (HD <= 64)
// ---------------------------------------------------------------------------

// A block of the wgmma design: warpgroup 0 loads, CWG consumer warpgroups
// compute, 64 rows each.
template <int CWG>
struct WgBlock {
  static constexpr int kThreads = 128 * (CWG + 1);
  static constexpr int kRows = 64 * CWG;
  static constexpr int kConsumerWarps = 4 * CWG;
  // Registers a consumer thread claims from the producer's warpgroup (which
  // keeps 24): 24 + CWG x kRegs <= 512, the 64K-register file over 128 threads.
  static constexpr int kRegs = CWG == 2 ? 240 : 160;
};

// Shared-memory geometry at head dim HD (wgtile::WgTile: a 64-row tile of
// kPanels swizzled panels), with the ring's depth and the block's bytes.
template <int HD>
struct WgGeom : WgTile<HD> {
  using WgTile<HD>::kTileBytes;
  static constexpr int kStages = HD == 128 ? 3 : 4;         // streamed tile pairs in flight
  // Resident: 2 tensors x CWG tiles; streamed: kStages x 2 tiles; then
  // kernel 4's per-stage lse / delta rows, the barriers, and 1024 B of slack
  // for the base alignment.
  __host__ __device__ static constexpr size_t tiles_bytes(int cwg) {
    return (size_t)(2 * cwg + 2 * kStages) * kTileBytes;
  }
  __host__ __device__ static constexpr size_t smem_bytes(int cwg) {
    return tiles_bytes(cwg) + kStages * 2 * 64 * sizeof(float)
           + (2 * kStages + 1) * sizeof(uint64_t) + 1024;
  }
};

// Kernel 3's tile, in place: dp becomes dS = P (dP - delta) in f32, with
// P = exp2(S scale log2(e) - lse2) of this thread's rows g and g + 8 (keys
// >= n_valid of the tile give P = 0 when TAIL). Accumulator element i sits
// at column 8 (i / 4) + 2 t4 + (i & 1) of row g + 8 ((i / 2) & 1).
template <bool TAIL>
__device__ __forceinline__ void dq_scores(const float (&s)[32], float (&dp)[32],
                                          const float (&lse2)[2], const float (&dl)[2],
                                          float sl2, int n_valid, int t4) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    float p = hopper::exp2_approx(fmaf(s[i], sl2, -lse2[r]));
    if (TAIL && 8 * (i >> 2) + 2 * t4 + (i & 1) >= n_valid) p = 0.f;
    dp[i] = p * (dp[i] - dl[r]);
  }
}

// Kernel 4's tile, keys as rows, in place: st becomes P^T = exp2(S^T scale
// log2(e) - lse2[query]) and dpt dS^T = P^T (dP^T - delta[query]), in f32.
// lse2 / delta of the tile's 64 queries come from shared memory (lse2 =
// +inf past Nq, so those columns give P = 0).
__device__ __forceinline__ void dkv_scores(float (&st)[32], float (&dpt)[32],
                                           const float* lse_s, const float* dl_s, float sl2,
                                           int t4) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t4);
    const float2 d = *reinterpret_cast<const float2*>(dl_s + 8 * j + 2 * t4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = hopper::exp2_approx(fmaf(st[4 * j + e], sl2, -((e & 1) ? l.y : l.x)));
      st[4 * j + e] = p;
      dpt[4 * j + e] = p * (dpt[4 * j + e] - ((e & 1) ? d.y : d.x));
    }
  }
}

// The A fragments (four k16 steps) of a 64 x 64 f32 accumulator, rounded to
// bf16: fragment register r of step kk holds elements 8 kk + 2 r and + 1.
__device__ __forceinline__ void pack_frags(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// Shared-memory layout of both kernels (after the 1024-byte alignment):
// resident tiles A0 .. A(CWG-1) B0 .. B(CWG-1) (the block's rows of two
// tensors), then
// kStages streamed stages of two tiles each, then kernel 4's lse2 / delta
// rows (kStages x 2 x 64 f32), then the barriers full[kStages],
// empty[kStages] and the resident tiles' `res`.

// Kernel 4's two consumer warpgroups take turns issuing their products:
// wait for this warpgroup's turn (barrier 1 + wg), then hand it to the
// other. (Kernel 3 is faster without turns on the H100.)
__device__ __forceinline__ void turn_wait(int wg) { hopper::named_sync(1 + wg, 256); }
__device__ __forceinline__ void turn_pass(int wg) { hopper::named_arrive(2 - wg, 256); }

// Kernel 3: one block per (64 CWG query rows, batch * head); Q and dO
// resident, K and V streamed over ceil(n_actual / 64) key tiles.
template <int HD, int CWG>
__global__ void __launch_bounds__(WgBlock<CWG>::kThreads, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                const float* __restrict__ lse, const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dq, int H, int Nq, int D, int n_actual,
                long long sgb, long long sgn, long long sgh, float scale, int pos_q, int pos_k,
                int pos_v, int pos_do) {
  using G = WgGeom<HD>;
  using W = WgBlock<CWG>;
  constexpr int S = G::kStages;
  extern __shared__ __align__(1024) unsigned char wg_smem_raw[];
  unsigned char* smem = align1024(wg_smem_raw);
  unsigned char* stages = smem + 2 * CWG * G::kTileBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::tiles_bytes(CWG) + S * 2 * 64 * sizeof(float));
  uint64_t* empty = full + S;
  uint64_t* res = empty + S;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], W::kConsumerWarps);
    }
    hopper::mbar_init(res, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int row0 = blockIdx.x * W::kRows;
  const int n_tiles = (n_actual + 63) / 64;

  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    hopper::regs_release<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(res, 2 * CWG * G::kTileBytes);
      for (int r = 0; r < CWG; ++r) {
        wg_load_tile<HD>(smem + r * G::kTileBytes, &tq, pos_q, res, h, row0 + 64 * r, b);
        wg_load_tile<HD>(smem + (CWG + r) * G::kTileBytes, &tdo, pos_do, res, h, row0 + 64 * r,
                         b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % S;
        hopper::mbar_wait(&empty[s], ((t / S) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], 2 * G::kTileBytes);
        unsigned char* st = stages + s * 2 * G::kTileBytes;
        wg_load_tile<HD>(st, &tk, pos_k, &full[s], h, t * 64, b);
        wg_load_tile<HD>(st + G::kTileBytes, &tv, pos_v, &full[s], h, t * 64, b);
      }
    }
  } else {
    hopper::regs_claim<W::kRegs>();
    const int tid = threadIdx.x - 128;
    const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const float sl2 = scale * kLog2e;
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 64 * wg + 16 * warp + g + 8 * r;
      const bool ok = row < Nq;
      lse2[r] = ok ? lse[(long long)bh * Nq + row] * kLog2e : 0.f;
      dl[r] = ok ? delta[(long long)bh * Nq + row] : 0.f;
    }
    const unsigned char* q_w = smem + wg * G::kTileBytes;
    const unsigned char* do_w = smem + (CWG + wg) * G::kTileBytes;
    float acc[G::kPanels][G::kPanelCols / 2];
    zero_panels<HD>(acc);
    float s[32], dp[32];
    uint32_t pd[4][4];
    auto tile = [&](int t) { return stages + (t % S) * 2 * G::kTileBytes; };
    auto score_products = [&](const unsigned char* kv) {  // S = Q K^T, dP = dO V^T
      wg_abt<HD>(s, q_w, kv);
      wg_abt<HD>(dp, do_w, kv + G::kTileBytes);
    };
    hopper::mbar_wait(res, 0);
    hopper::mbar_wait(&full[0], 0);
    hopper::wgmma_fence();
    score_products(tile(0));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    // Per key tile: dS from this tile's scores, then one batch of products,
    // dQ += dS K and the next tile's S and dP (the last tile's again,
    // unused, after the last: no branch among the products). Each batch is
    // waited for in the iteration that issues it: a batch in flight across
    // the loop edge would have the accumulators' registers moved there, and
    // ptxas would serialise every wgmma (C7515).
    for (int t = 0; t < n_tiles; ++t) {
      const int n_valid = n_actual - t * 64;
      if (n_valid < 64)
        dq_scores<true>(s, dp, lse2, dl, sl2, n_valid, t4);
      else
        dq_scores<false>(s, dp, lse2, dl, sl2, n_valid, t4);
      pack_frags(pd, dp);
      const int tn = t + 1 < n_tiles ? t + 1 : t;
      hopper::mbar_wait(&full[tn % S], (tn / S) & 1);
      hopper::wgmma_fence();
      wg_ab<HD>(acc, pd, tile(t));
      score_products(tile(tn));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      __syncwarp();  // tile t's products are done: release its stage
      if (lane == 0) hopper::mbar_arrive(&empty[t % S]);
    }
#pragma unroll
    for (int p = 0; p < G::kPanels; ++p) hopper::fence_regs(acc[p]);
    wg_store<HD>(acc, dq + b * sgb + h * sgh, sgn, row0 + 64 * wg, Nq, Nq, D, scale, warp, g, t4);
  }
}

// Kernel 4: one block per (128 key rows, batch * head); K and V resident,
// Q and dO streamed over ceil(Nq / 64) query tiles with their lse2 / delta
// rows, which the producer warp copies into the stage with ordinary loads
// (a row of Nq f32 values need not be 16-byte aligned, as TMA requires).
// Keys >= n_actual get exactly zero dK and dV at the store.
template <int HD>
__global__ void __launch_bounds__(WgBlock<2>::kThreads, 1)
dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H, int Nq,
                 int Nk, int D, int n_actual, long long sgkb, long long sgkn, long long sgkh,
                 long long sgvb, long long sgvn, long long sgvh, float scale, int pos_q,
                 int pos_k, int pos_v, int pos_do) {
  using G = WgGeom<HD>;
  using W = WgBlock<2>;
  constexpr int S = G::kStages;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int row0 = blockIdx.x * W::kRows;
  __nv_bfloat16* gk = dk + b * sgkb + h * sgkh;
  __nv_bfloat16* gv = dv + b * sgvb + h * sgvh;
  if (row0 >= n_actual) {  // every key of the block is masked: zero dK, dV
    const int cols = D / 2;
    for (int i = threadIdx.x; i < W::kRows * cols; i += W::kThreads) {
      const int row = row0 + i / cols, col = 2 * (i % cols);
      if (row < Nk) {
        const __nv_bfloat162 z = __floats2bfloat162_rn(0.f, 0.f);
        *reinterpret_cast<__nv_bfloat162*>(gk + row * sgkn + col) = z;
        *reinterpret_cast<__nv_bfloat162*>(gv + row * sgvn + col) = z;
      }
    }
    return;
  }
  extern __shared__ __align__(1024) unsigned char wg_smem_raw[];
  unsigned char* smem = align1024(wg_smem_raw);
  unsigned char* stages = smem + 4 * G::kTileBytes;
  float* rows_s = reinterpret_cast<float*>(smem + G::tiles_bytes(2));  // [stage][lse2 64, delta 64]
  uint64_t* full = reinterpret_cast<uint64_t*>(rows_s + S * 2 * 64);
  uint64_t* empty = full + S;
  uint64_t* res = empty + S;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 32);  // the producer warp's lanes
      hopper::mbar_init(&empty[s], W::kConsumerWarps);
    }
    hopper::mbar_init(res, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  const int n_tiles = (Nq + 63) / 64;

  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    hopper::regs_release<24>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(res, 4 * G::kTileBytes);
        for (int r = 0; r < 2; ++r) {
          wg_load_tile<HD>(smem + r * G::kTileBytes, &tk, pos_k, res, h, row0 + 64 * r, b);
          wg_load_tile<HD>(smem + (2 + r) * G::kTileBytes, &tv, pos_v, res, h, row0 + 64 * r, b);
        }
      }
      const float* lse_b = lse + (long long)bh * Nq;
      const float* dl_b = delta + (long long)bh * Nq;
      // This lane's rows lane and lane + 32 of tile t (lse2 = +inf past Nq:
      // P = 0), loaded a tile ahead so that their latency overlaps the wait
      // for the stage.
      auto fetch_rows = [&](int t, float (&l)[2], float (&d)[2]) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = t * 64 + lane + 32 * r;
          l[r] = row < Nq ? lse_b[row] * kLog2e : __int_as_float(0x7f800000);
          d[r] = row < Nq ? dl_b[row] : 0.f;
        }
      };
      float l[2], d[2];
      fetch_rows(0, l, d);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % S;
        float l_next[2], d_next[2];
        fetch_rows(t + 1, l_next, d_next);
        hopper::mbar_wait(&empty[s], ((t / S) & 1) ^ 1);
        float* rs = rows_s + s * 128;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          rs[lane + 32 * r] = l[r];
          rs[64 + lane + 32 * r] = d[r];
          l[r] = l_next[r];
          d[r] = d_next[r];
        }
        if (lane == 0) {
          hopper::mbar_arrive_expect_tx(&full[s], 2 * G::kTileBytes);
          unsigned char* st = stages + s * 2 * G::kTileBytes;
          wg_load_tile<HD>(st, &tq, pos_q, &full[s], h, t * 64, b);
          wg_load_tile<HD>(st + G::kTileBytes, &tdo, pos_do, &full[s], h, t * 64, b);
        } else {
          hopper::mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    hopper::regs_claim<W::kRegs>();
    const int tid = threadIdx.x - 128;
    const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const float sl2 = scale * kLog2e;
    const unsigned char* k_w = smem + wg * G::kTileBytes;
    const unsigned char* v_w = smem + (2 + wg) * G::kTileBytes;
    float acc_dk[G::kPanels][G::kPanelCols / 2], acc_dv[G::kPanels][G::kPanelCols / 2];
    zero_panels<HD>(acc_dk);
    zero_panels<HD>(acc_dv);
    float st[32], dpt[32];
    uint32_t pp[4][4], pd[4][4];
    auto tile = [&](int t) { return stages + (t % S) * 2 * G::kTileBytes; };
    auto rows = [&](int t) { return rows_s + (t % S) * 128; };
    hopper::mbar_wait(res, 0);
    if (wg == 1) turn_pass(wg);  // warpgroup 0 issues first
    turn_wait(wg);
    hopper::mbar_wait(&full[0], 0);
    hopper::wgmma_fence();
    wg_abt<HD>(st, k_w, tile(0));
    wg_abt<HD>(dpt, v_w, tile(0) + G::kTileBytes);
    hopper::wgmma_commit();
    turn_pass(wg);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(st);
    hopper::fence_regs(dpt);
    for (int t = 0; t < n_tiles; ++t) {  // as in kernel 3
      dkv_scores(st, dpt, rows(t), rows(t) + 64, sl2, t4);
      pack_frags(pp, st);
      pack_frags(pd, dpt);
      const int tn = t + 1 < n_tiles ? t + 1 : t;
      turn_wait(wg);
      hopper::mbar_wait(&full[tn % S], (tn / S) & 1);
      hopper::wgmma_fence();
      wg_ab<HD>(acc_dv, pp, tile(t) + G::kTileBytes);
      wg_ab<HD>(acc_dk, pd, tile(t));
      wg_abt<HD>(st, k_w, tile(tn));
      wg_abt<HD>(dpt, v_w, tile(tn) + G::kTileBytes);
      hopper::wgmma_commit();
      if (wg == 0 || t + 1 < n_tiles) turn_pass(wg);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(st);
      hopper::fence_regs(dpt);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[t % S]);
    }
#pragma unroll
    for (int p = 0; p < G::kPanels; ++p) {
      hopper::fence_regs(acc_dk[p]);
      hopper::fence_regs(acc_dv[p]);
    }
    const int r0 = row0 + 64 * wg;
    wg_store<HD>(acc_dk, gk, sgkn, r0, Nk, n_actual, D, scale, warp, g, t4);
    wg_store<HD>(acc_dv, gv, sgvn, r0, Nk, n_actual, D, 1.f, warp, g, t4);
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

// Strides, in elements, in this order: q, k, v, dO, then the outputs (dq;
// or dk, dv), three each (batch, sequence, head).

// The wgmma design takes bf16 when TMA can read q, k, v and dO (every batch,
// sequence and head stride positive: a broadcast stride of 0 cannot be
// described to it): dQ at every head dim, dK/dV at D <= 64 (at 128 its two
// accumulators and the score tiles would not fit the registers).
// Consumer warpgroups of the dQ kernel: three at HD <= 64 (192 query rows a
// block, 160 registers a thread), two at 128 (its accumulators need more).
// The dK/dV kernel needs ~200 registers a thread, so it keeps two.
template <int HD>
constexpr int kDqWarpgroups = HD <= 64 ? 3 : 2;

bool wgmma_takes(const long long* st) {
  for (int i = 0; i < 12; ++i)
    if (st[i] <= 0) return false;
  return true;
}

// The four tensor maps of a wgmma launch (q and dO over Nq rows, k and v
// over Nk), in boxes of 64 rows; false if cuTensorMapEncodeTiled refuses one.
template <int HD>
bool encode_maps(CUtensorMap (&maps)[4], int (&pos)[4], const void* q, const void* k,
                 const void* v, const void* dout, int B, int Nq, int Nk, int H, int D,
                 const long long* st) {
  const CUtensorMapSwizzle sw = HD == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  const void* ptrs[4] = {q, k, v, dout};
  const int rows[4] = {Nq, Nk, Nk, Nq};
  for (int i = 0; i < 4; ++i)
    if (!hopper::encode_bnhd_map(&maps[i], ptrs[i], B, rows[i], H, D, st[3 * i], st[3 * i + 1],
                                 st[3 * i + 2], WgGeom<HD>::kPanelCols, 64, sw, &pos[i]))
      return false;
  return true;
}

template <int HD>
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, void* dq, int B, int Nq,
                            int Nk, int H, int D, int n_actual, const long long* st, float scale,
                            cudaStream_t stream) {
  using G = WgGeom<HD>;
  CUtensorMap m[4];
  int pos[4];
  if (!encode_maps<HD>(m, pos, q, k, v, dout, B, Nq, Nk, H, D, st)) return cudaErrorInvalidValue;
  constexpr int CWG = kDqWarpgroups<HD>;
  using W = WgBlock<CWG>;
  cudaError_t err = cudaFuncSetAttribute(dq_wgmma_kernel<HD, CWG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)G::smem_bytes(CWG));
  if (err != cudaSuccess) return err;
  dim3 grid((Nq + W::kRows - 1) / W::kRows, B * H);
  dq_wgmma_kernel<HD, CWG><<<grid, W::kThreads, G::smem_bytes(CWG), stream>>>(
      m[0], m[1], m[2], m[3], lse, delta, static_cast<__nv_bfloat16*>(dq), H, Nq, D, n_actual,
      st[12], st[13], st[14], scale, pos[0], pos[1], pos[2], pos[3]);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, void* dk, void* dv, int B,
                             int Nq, int Nk, int H, int D, int n_actual, const long long* st,
                             float scale, cudaStream_t stream) {
  using G = WgGeom<HD>;
  CUtensorMap m[4];
  int pos[4];
  if (!encode_maps<HD>(m, pos, q, k, v, dout, B, Nq, Nk, H, D, st)) return cudaErrorInvalidValue;
  using W = WgBlock<2>;
  cudaError_t err = cudaFuncSetAttribute(dkv_wgmma_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)G::smem_bytes(2));
  if (err != cudaSuccess) return err;
  dim3 grid((Nk + W::kRows - 1) / W::kRows, B * H);
  dkv_wgmma_kernel<HD><<<grid, W::kThreads, G::smem_bytes(2), stream>>>(
      m[0], m[1], m[2], m[3], lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, Nq, Nk, D, n_actual, st[12], st[13], st[14], st[15],
      st[16], st[17], scale, pos[0], pos[1], pos[2], pos[3]);
  return cudaGetLastError();
}

// The design of the last launch of kernel 3 ([0]) and kernel 4 ([1]), as
// launch_dq and launch_dkv choose it: 0 = FMA (f32), 1 = mma.sync, 2 = wgmma
// (bf16), 3 = wgmma.tf32x3 (f32); -1 before the first launch. Read through
// flash_attention_bwd_last_design.
enum Design { kFma = 0, kMmaSync = 1, kWgmma = 2, kWgmmaTf32 = 3 };
int g_last_design[2] = {-1, -1};

// f32 takes the wgmma.tf32x3 design (fabtf32) at D <= 64 when every input
// stride is positive, unless `mma_only`. If its launch fails, the error is
// returned and no other design runs.
template <int HD>
bool tf32_takes(int dtype, bool mma_only, const long long* st) {
  return dtype == 0 && !mma_only && HD <= 64 && wgmma_takes(st);
}

template <int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, int dtype, int B,
                      int Nq, int Nk, int H, int D, int n_actual, const long long* st,
                      float scale, bool mma_only, cudaStream_t stream) {
  if (tf32_takes<HD>(dtype, mma_only, st)) {
    g_last_design[0] = kWgmmaTf32;
    return fabtf32::dq(q, k, v, dout, lse, delta, dq, B, Nq, Nk, H, D, n_actual, st, scale,
                       stream);
  }
  if (dtype == 1) {
    if (!mma_only && wgmma_takes(st)) {
      g_last_design[0] = kWgmma;
      return launch_dq_wgmma<HD>(q, k, v, dout, lse, delta, dq, B, Nq, Nk, H, D, n_actual, st,
                                 scale, stream);
    }
    g_last_design[0] = kMmaSync;
    using T = __nv_bfloat16;
    const size_t smem = (size_t)(2 * kBM + 4 * kBN) * (HD + kPad) * sizeof(T);
    cudaError_t err = cudaFuncSetAttribute(dq_bf16_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((Nq + kBM - 1) / kBM, B * H);
    dq_bf16_kernel<HD><<<grid, kWarps * 32, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), H, Nq, Nk, D,
        n_actual, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
        st[9], st[10], st[11], st[12], st[13], st[14], scale);
  } else {
    g_last_design[0] = kFma;
    constexpr int kRows = kF32Threads / (HD / 32);
    dim3 grid((Nq + kRows - 1) / kRows, B * H);
    dq_f32_kernel<HD><<<grid, kF32Threads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
        static_cast<float*>(dq), H, Nq, Nk, D, n_actual, st[0], st[1], st[2], st[3],
        st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13], st[14],
        scale);
  }
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv, void* scratch,
                       int dtype, int B, int Nq, int Nk, int H, int D, int n_actual,
                       const long long* st, float scale, bool mma_only, cudaStream_t stream) {
  if (tf32_takes<HD>(dtype, mma_only, st)) {
    g_last_design[1] = kWgmmaTf32;
    return fabtf32::dkv(q, k, v, dout, lse, delta, dk, dv, static_cast<float*>(scratch), B, Nq,
                        Nk, H, D, n_actual, st, scale, stream);
  }
  if (dtype == 1) {
    if constexpr (HD <= 64)
      if (!mma_only && wgmma_takes(st)) {
        g_last_design[1] = kWgmma;
        return launch_dkv_wgmma<HD>(q, k, v, dout, lse, delta, dk, dv, B, Nq, Nk, H, D,
                                    n_actual, st, scale, stream);
      }
    g_last_design[1] = kMmaSync;
    using T = __nv_bfloat16;
    constexpr int BQ = HD <= 64 ? 64 : 32;
    const size_t smem = (size_t)(2 * kBM + 4 * BQ) * (HD + kPad) * sizeof(T)
                        + 4 * BQ * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(dkv_bf16_kernel<HD, BQ>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((Nk + kBM - 1) / kBM, B * H);
    dkv_bf16_kernel<HD, BQ><<<grid, kWarps * 32, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
        H, Nq, Nk, D, n_actual, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
        st[8], st[9], st[10], st[11], st[12], st[13], st[14], st[15], st[16], st[17],
        scale);
  } else {
    g_last_design[1] = kFma;
    constexpr int kRows = kF32Threads / (HD / 32);
    dim3 grid((Nk + kRows - 1) / kRows, B * H);
    dkv_f32_kernel<HD><<<grid, kF32Threads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
        static_cast<float*>(dk), static_cast<float*>(dv), H, Nq, Nk, D, n_actual, st[0],
        st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
        st[12], st[13], st[14], st[15], st[16], st[17], scale);
  }
  return cudaGetLastError();
}

bool bad_args(int dtype, int B, int H, int D, int n_actual) {
  return D <= 0 || D > 128 || D % 8 != 0 || B * H > 65535 || n_actual < 1
         || (dtype != 0 && dtype != 1);
}

int dq_entry(const void* q, const void* k, const void* v, const void* dout, const void* lse,
             const void* delta, void* dq, int dtype, int B, int Nq, int Nk, int H, int D,
             int n_actual, const long long* st, float scale, bool mma_only, void* stream) {
  if (bad_args(dtype, B, H, D, n_actual)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (D <= 32) return (int)launch_dq<32>(q, k, v, dout, l, dl, dq, dtype, B, Nq, Nk, H, D, n_actual, st, scale, mma_only, s);
  if (D <= 64) return (int)launch_dq<64>(q, k, v, dout, l, dl, dq, dtype, B, Nq, Nk, H, D, n_actual, st, scale, mma_only, s);
  return (int)launch_dq<128>(q, k, v, dout, l, dl, dq, dtype, B, Nq, Nk, H, D, n_actual, st, scale, mma_only, s);
}

int dkv_entry(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dk, void* dv, void* scratch, int dtype, int B, int Nq,
              int Nk, int H, int D, int n_actual, const long long* st, float scale,
              bool mma_only, void* stream) {
  if (bad_args(dtype, B, H, D, n_actual)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (D <= 32) return (int)launch_dkv<32>(q, k, v, dout, l, dl, dk, dv, scratch, dtype, B, Nq, Nk, H, D, n_actual, st, scale, mma_only, s);
  if (D <= 64) return (int)launch_dkv<64>(q, k, v, dout, l, dl, dk, dv, scratch, dtype, B, Nq, Nk, H, D, n_actual, st, scale, mma_only, s);
  return (int)launch_dkv<128>(q, k, v, dout, l, dl, dk, dv, scratch, dtype, B, Nq, Nk, H, D, n_actual, st, scale, mma_only, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the head-dim
// stride must be 1, D a multiple of 8 (<= 128), every stride a multiple of
// 8 and every pointer 16-byte aligned (the Python wrapper guarantees all of
// it). lse and delta: float32 (B, H, Nq) contiguous. `st` holds 15 strides:
// q, k, v, dO, dq (batch, sequence, head each). When every input stride is
// positive bf16 runs the wgmma design and f32 at D <= 64 the wgmma.tf32x3
// one; else bf16 runs the mma.sync design and f32 the FMA kernel. Returns
// the cudaError_t of the launch (0 = success).
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dq, int dtype, int B, int Nq, int Nk, int H,
                                      int D, int n_actual, const long long* st, float scale,
                                      void* stream) {
  return dq_entry(q, k, v, dout, lse, delta, dq, dtype, B, Nq, Nk, H, D, n_actual, st, scale,
                  false, stream);
}

// As flash_attention_bwd_dq, with 18 strides: q, k, v, dO, dk, dv, and
// `scratch`: flash_attention_bwd_dkv_scratch_floats floats (null when that is
// 0). bf16 runs the wgmma design at D <= 64 when every input stride is
// positive, else the mma.sync one; f32 as kernel 3.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dk, void* dv, void* scratch, int dtype, int B,
                                       int Nq, int Nk, int H, int D, int n_actual,
                                       const long long* st, float scale, void* stream) {
  return dkv_entry(q, k, v, dout, lse, delta, dk, dv, scratch, dtype, B, Nq, Nk, H, D, n_actual,
                   st, scale, false, stream);
}

// Floats of scratch flash_attention_bwd_dkv (mma_only = 0) or
// flash_attention_bwd_dkv_mma (1) needs for a call: the wgmma.tf32x3
// design's pre-pass forms when it takes the call, else 0. Arguments as the
// entries'.
extern "C" long long flash_attention_bwd_dkv_scratch_floats(int dtype, int B, int Nq, int H,
                                                            int D, const long long* st,
                                                            int mma_only) {
  if (D < 1 || D > 64 || !tf32_takes<64>(dtype, mma_only != 0, st)) return 0;
  return (long long)fabtf32::dkv_scratch_floats(B, H, Nq, D);
}

// The two entries above with the mma.sync design for bf16 and the FMA
// kernels for f32 at every shape (the earlier kernels, kept to time the
// wgmma and wgmma.tf32x3 ones against).
extern "C" int flash_attention_bwd_dq_mma(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          void* dq, int dtype, int B, int Nq, int Nk, int H,
                                          int D, int n_actual, const long long* st, float scale,
                                          void* stream) {
  return dq_entry(q, k, v, dout, lse, delta, dq, dtype, B, Nq, Nk, H, D, n_actual, st, scale,
                  true, stream);
}

extern "C" int flash_attention_bwd_dkv_mma(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse,
                                           const void* delta, void* dk, void* dv, void* scratch,
                                           int dtype, int B, int Nq, int Nk, int H, int D,
                                           int n_actual, const long long* st, float scale,
                                           void* stream) {
  return dkv_entry(q, k, v, dout, lse, delta, dk, dv, scratch, dtype, B, Nq, Nk, H, D, n_actual,
                   st, scale, true, stream);
}

// The design (0 = FMA, 1 = mma.sync, 2 = wgmma, 3 = wgmma.tf32x3) of the
// last launch of kernel 3 (which = 0) or kernel 4 (which = 1) through any
// entry above; -1 before the first.
extern "C" int flash_attention_bwd_last_design(int which) {
  return which == 0 || which == 1 ? g_last_design[which] : -1;
}
