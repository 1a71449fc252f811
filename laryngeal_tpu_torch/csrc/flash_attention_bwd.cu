// Flash-attention backward for Hopper (sm_90a), bound through a plain C
// interface (ctypes; see laryngeal_tpu_torch/ops/flash_attention.py).
//
// Replaces two Pallas TPU kernels of laryngeal_tpu/ops/flash_attention.py,
// the two-kernel recompute scheme under its custom_vjp (_flash_backward):
//   * _dq_kernel  (entry flash_attention_bwd_dq): one block per (batch*head,
//     64 query rows) streams K/V tiles, recomputes S = scale * Q K^T and
//     P = exp(S - lse) (keys >= n_actual give P = 0), dP = dO V^T,
//     dS = P * (dP - delta) rounded to the input dtype, dQ += dS K in f32,
//     and scales dQ by `scale` at the end;
//   * _dkv_kernel (entry flash_attention_bwd_dkv): one block per
//     (batch*head, 64 key rows) streams Q/dO tiles with their lse / delta,
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
// of traffic: both are bound by tensor-core operations. So, as in the
// forward, no (N, N) tile ever reaches device memory:
//   * bf16: mma.sync.m16n8k16 with f32 accumulators, 4 warps of 16 rows.
//     The dK/dV kernel computes S^T = K Q^T and dP^T = V dO^T directly, with
//     the keys as rows, so P^T and dS^T come out of the accumulators in the
//     A-fragment layout of the next products (P^T dO, dS^T Q) and stay in
//     registers: no transposed fragment is ever built. The streamed tiles are
//     double-buffered with cp.async; rows padded by 8 elements for ldmatrix.
//     At D = 128 the dK/dV kernel streams 32-query tiles to keep its two
//     accumulators plus S/dP tiles within the register file.
//   * f32: on the FMA units, TF32 off (the same reason as the forward): one
//     query row (dQ) or key row (dK/dV) per 1-4 threads, each owning a
//     32-wide slice of the head dim, dot products combined by warp shuffles.
// Not yet done (later work): wgmma/TMA, warp specialisation, keeping the
// block's resident tiles in registers.

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

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
// Launchers
// ---------------------------------------------------------------------------

// Strides, in elements, in this order: q, k, v, dO, then the outputs (dq;
// or dk, dv), three each (batch, sequence, head).
template <int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, int dtype, int B,
                      int Nq, int Nk, int H, int D, int n_actual, const long long* st,
                      float scale, cudaStream_t stream) {
  if (dtype == 1) {
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
                       const float* lse, const float* delta, void* dk, void* dv, int dtype,
                       int B, int Nq, int Nk, int H, int D, int n_actual,
                       const long long* st, float scale, cudaStream_t stream) {
  if (dtype == 1) {
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the head-dim
// stride must be 1, D a multiple of 8 (<= 128), every stride a multiple of
// 8 and every pointer 16-byte aligned (the Python wrapper guarantees all of
// it). lse and delta: float32 (B, H, Nq) contiguous. `st` holds 15 strides:
// q, k, v, dO, dq (batch, sequence, head each). Returns the cudaError_t of
// the launch (0 = success).
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dq, int dtype, int B, int Nq, int Nk, int H,
                                      int D, int n_actual, const long long* st, float scale,
                                      void* stream) {
  if (bad_args(dtype, B, H, D, n_actual)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (D <= 32) return (int)launch_dq<32>(q, k, v, dout, l, dl, dq, dtype, B, Nq, Nk, H, D, n_actual, st, scale, s);
  if (D <= 64) return (int)launch_dq<64>(q, k, v, dout, l, dl, dq, dtype, B, Nq, Nk, H, D, n_actual, st, scale, s);
  return (int)launch_dq<128>(q, k, v, dout, l, dl, dq, dtype, B, Nq, Nk, H, D, n_actual, st, scale, s);
}

// As flash_attention_bwd_dq, with 18 strides: q, k, v, dO, dk, dv.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dk, void* dv, int dtype, int B, int Nq, int Nk,
                                       int H, int D, int n_actual, const long long* st,
                                       float scale, void* stream) {
  if (bad_args(dtype, B, H, D, n_actual)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (D <= 32) return (int)launch_dkv<32>(q, k, v, dout, l, dl, dk, dv, dtype, B, Nq, Nk, H, D, n_actual, st, scale, s);
  if (D <= 64) return (int)launch_dkv<64>(q, k, v, dout, l, dl, dk, dv, dtype, B, Nq, Nk, H, D, n_actual, st, scale, s);
  return (int)launch_dkv<128>(q, k, v, dout, l, dl, dk, dv, dtype, B, Nq, Nk, H, D, n_actual, st, scale, s);
}
