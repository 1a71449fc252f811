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
// trailing-key / kv_valid mask), the row sum floored at 1e-30, f32
// statistics and accumulation. One template, two instantiations.
//
// What bounds it on the H100: at the ViViT-B bf16 shape (B=8, N=3137,
// H=12, D=64) one launch does 4*B*H*N^2*D ~ 2.4e11 FLOP against ~154 MB
// of q/k/v/o traffic, ~1600 FLOP per byte -- far above the ~295 FLOP/byte
// ridge -- so it is bound by tensor-core operations, not memory. The
// design therefore keeps the whole (N, N) score matrix out of device
// memory and puts both products on the tensor cores:
//   * bf16: mma.sync.m16n8k16 (bf16 operands, f32 accumulators). A block of
//     4 warps owns 64 query rows (16 per warp); K/V stream through shared
//     memory in 64-key tiles, double-buffered with cp.async so the next
//     tile's copy overlaps this tile's products. Q, K and V fragments come
//     from shared memory through ldmatrix (.trans for V); rows are padded
//     by 8 elements so those reads are free of bank conflicts. P stays in
//     registers: the S accumulators of two adjacent 8-key tiles are exactly
//     the A fragment of the next 16-key product, so P never touches shared
//     memory. The online softmax runs in base 2 (exp2 of log2e-scaled
//     logits), which is the same function.
//   * f32: the TPU reference semantics in full f32 (the VivitConfig
//     default). Tensor cores offer f32 only as TF32, which loses the
//     1e-4 agreement, so this path runs on the FMA units: each thread owns a
//     32-wide slice of one query row and the row's slices combine by warp
//     shuffles.
// Not yet done (later work): wgmma/TMA, warp specialisation, and a
// persistent schedule -- mma.sync reaches only part of Hopper's tensor-core
// rate.

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

// ---------------------------------------------------------------------------
// bf16 tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kBM = 64;       // query rows per block (16 per warp)
constexpr int kBN = 64;       // keys per K/V tile

template <int HD, bool kLse>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse,
                      int H, int Nq, int Nk, int D, int n_actual,
                      long long sqb, long long sqn, long long sqh,
                      long long skb, long long skn, long long skh,
                      long long svb, long long svn, long long svh,
                      long long sob, long long son, long long soh,
                      float scale) {
  constexpr int kLd = HD + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + kBM * kLd;     // 2 buffers
  __nv_bfloat16* v_s = k_s + 2 * kBN * kLd; // 2 buffers

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;

  const __nv_bfloat16* qb = q + b * sqb + h * sqh;
  const __nv_bfloat16* kb = k + b * skb + h * skh;
  const __nv_bfloat16* vb = v + b * svb + h * svh;

  const int n_tiles = (Nk + kBN - 1) / kBN;
  load_tile_async<kBM, HD>(q_s, qb, sqn, q0, Nq, D);
  load_tile_async<kBN, HD>(k_s, kb, skn, 0, Nk, D);
  load_tile_async<kBN, HD>(v_s, vb, svn, 0, Nk, D);
  cp_async_commit();

  uint32_t qa[HD / 16][4];
  float acc_o[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_o[i][j] = 0.f;
  // Rows g and g + 8 of this warp's 16: running max (base-2 units) and this
  // thread's partial row sum (the quad's four partials add up at the end).
  float m_row[2] = {kMaskValue, kMaskValue};
  float l_row[2] = {0.f, 0.f};
  const float scale_log2 = scale * kLog2e;

  // ldmatrix lane -> (row, column) of its 8x8 matrix.
  const int lm_mat = lane / 8, lm_row = lane % 8;

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
    if (t == 0) {
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        const int row = warp * 16 + (lm_mat & 1) * 8 + lm_row;
        const int col = ks * 16 + (lm_mat >> 1) * 8;
        ldmatrix_x4(qa[ks], q_s + row * kLd + col);
      }
    }
    const __nv_bfloat16* kt = k_s + buf * kBN * kLd;
    const __nv_bfloat16* vt = v_s + buf * kBN * kLd;

    // S = Q K^T for this warp's 16 rows x 64 keys: 8 tiles of 16x8.
    float s[kBN / 8][4];
#pragma unroll
    for (int i = 0; i < kBN / 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBN / 8; nt += 2) {
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        uint32_t kf[4];
        const int key = (nt + (lm_mat >> 1)) * 8 + lm_row;
        const int col = ks * 16 + (lm_mat & 1) * 8;
        ldmatrix_x4(kf, kt + key * kLd + col);
        mma_bf16(s[nt], qa[ks], kf[0], kf[1]);
        mma_bf16(s[nt + 1], qa[ks], kf[2], kf[3]);
      }
    }

    // Scale, mask keys >= n_actual, online softmax (base 2).
    float mx[2] = {m_row[0], m_row[1]};
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = t * kBN + nt * 8 + tig * 2 + (j & 1);
        const float x = key < n_actual ? s[nt][j] * scale_log2 : kMaskValue;
        s[nt][j] = x;
        mx[j >> 1] = fmaxf(mx[j >> 1], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha[r] = exp2f(m_row[r] - mx[r]);
      m_row[r] = mx[r];
      l_row[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[nt][j] - mx[j >> 1]);
        s[nt][j] = p;
        l_row[j >> 1] += p;
      }
    }
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      acc_o[dt][0] *= alpha[0];
      acc_o[dt][1] *= alpha[0];
      acc_o[dt][2] *= alpha[1];
      acc_o[dt][3] *= alpha[1];
    }

    // O += P V: P (16 x 64 keys) from registers, V through ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < HD / 8; dt += 2) {
        uint32_t vf[4];
        const int key = kk * 16 + (lm_mat & 1) * 8 + lm_row;
        const int col = (dt + (lm_mat >> 1)) * 8;
        ldmatrix_x4_trans(vf, vt + key * kLd + col);
        mma_bf16(acc_o[dt], pa, vf[0], vf[1]);
        mma_bf16(acc_o[dt + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // the next iteration's copy overwrites this buffer
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 1);
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 2);
    const float l_safe = fmaxf(l_row[r], 1e-30f);
    const int row = q0 + warp * 16 + g + r * 8;
    if (kLse && tig == 0 && row < Nq)
      lse[(long long)bh * Nq + row] = m_row[r] * kLn2 + logf(l_safe);
    l_row[r] = 1.f / l_safe;
  }
  __nv_bfloat16* ob = o + b * sob + h * soh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    if (row >= Nq) continue;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      const int col = dt * 8 + tig * 2;
      if (col < D) {
        __nv_bfloat162 val = __floats2bfloat162_rn(acc_o[dt][2 * r] * l_row[r],
                                                   acc_o[dt][2 * r + 1] * l_row[r]);
        *reinterpret_cast<__nv_bfloat162*>(ob + row * son + col) = val;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32 kernel (FMA units)
// ---------------------------------------------------------------------------

constexpr int kF32BN = 32;  // keys per K/V tile

template <int HD, bool kLse>
__global__ void __launch_bounds__(kF32Threads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int H, int Nq, int Nk, int D, int n_actual,
                     long long sqb, long long sqn, long long sqh,
                     long long skb, long long skn, long long skh,
                     long long svb, long long svn, long long svh,
                     long long sob, long long son, long long soh,
                     float scale) {
  constexpr int kTpr = HD / 32;                 // threads per query row
  constexpr int kRows = kF32Threads / kTpr;     // query rows per block
  __shared__ __align__(16) float k_s[kF32BN][HD];
  __shared__ __align__(16) float v_s[kF32BN][HD];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int row = blockIdx.x * kRows + threadIdx.x / kTpr;
  const int c0 = (threadIdx.x % kTpr) * 32;     // this thread's column slice
  const bool row_ok = row < Nq;

  const float* qb = q + b * sqb + h * sqh;
  const float* kb = k + b * skb + h * skh;
  const float* vb = v + b * svb + h * svh;

  float qr[32], acc[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    qr[c] = (row_ok && c0 + c < D) ? qb[row * sqn + c0 + c] : 0.f;
    acc[c] = 0.f;
  }
  float m = kMaskValue, l = 0.f;

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

    float s[kF32BN];
    float mx = m;
#pragma unroll
    for (int j = 0; j < kF32BN; ++j) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < 32; ++c) part = fmaf(qr[c], k_s[j][c0 + c], part);
#pragma unroll
      for (int off = kTpr / 2; off > 0; off /= 2)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      s[j] = key0 + j < n_actual ? part * scale : kMaskValue;
      mx = fmaxf(mx, s[j]);
    }
    const float alpha = expf(m - mx);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kF32BN; ++j) {
      s[j] = expf(s[j] - mx);
      psum += s[j];
    }
    l = l * alpha + psum;
    m = mx;
#pragma unroll
    for (int c = 0; c < 32; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < kF32BN; ++j)
#pragma unroll
      for (int c = 0; c < 32; ++c) acc[c] = fmaf(s[j], v_s[j][c0 + c], acc[c]);
  }

  if (!row_ok) return;
  if (kLse && c0 == 0) lse[(long long)bh * Nq + row] = m + logf(fmaxf(l, 1e-30f));
  const float inv = 1.f / fmaxf(l, 1e-30f);
  float* ob = o + b * sob + h * soh + row * son;
#pragma unroll
  for (int c = 0; c < 32; ++c)
    if (c0 + c < D) ob[c0 + c] = acc[c] * inv;
}

template <int HD, bool kLse>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                        int B, int Nq, int Nk, int H, int D, int n_actual,
                        const long long* st, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)(kBM + 4 * kBN) * (HD + kPad) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<HD, kLse>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Nq + kBM - 1) / kBM, B * H);
  flash_fwd_bf16_kernel<HD, kLse><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse,
      H, Nq, Nk, D, n_actual, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], scale);
  return cudaGetLastError();
}

template <int HD, bool kLse>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* lse,
                       int B, int Nq, int Nk, int H, int D, int n_actual,
                       const long long* st, float scale, cudaStream_t stream) {
  constexpr int kRows = kF32Threads / (HD / 32);
  dim3 grid((Nq + kRows - 1) / kRows, B * H);
  flash_fwd_f32_kernel<HD, kLse><<<grid, kF32Threads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse,
      H, Nq, Nk, D, n_actual, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], scale);
  return cudaGetLastError();
}

template <bool kLse>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int dtype,
           int B, int Nq, int Nk, int H, int D, int n_actual, const long long* st,
           float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 0 || D > 128 || D % 8 != 0 || B * H > 65535 || n_actual < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (D <= 32) return (int)launch_bf16<32, kLse>(q, k, v, o, lse, B, Nq, Nk, H, D, n_actual, st, scale, s);
    if (D <= 64) return (int)launch_bf16<64, kLse>(q, k, v, o, lse, B, Nq, Nk, H, D, n_actual, st, scale, s);
    return (int)launch_bf16<128, kLse>(q, k, v, o, lse, B, Nq, Nk, H, D, n_actual, st, scale, s);
  }
  if (dtype == 0) {
    if (D <= 32) return (int)launch_f32<32, kLse>(q, k, v, o, lse, B, Nq, Nk, H, D, n_actual, st, scale, s);
    if (D <= 64) return (int)launch_f32<64, kLse>(q, k, v, o, lse, B, Nq, Nk, H, D, n_actual, st, scale, s);
    return (int)launch_f32<128, kLse>(q, k, v, o, lse, B, Nq, Nk, H, D, n_actual, st, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the head-dim
// stride must be 1, D a multiple of 8 (<= 128), every stride a multiple of
// 8 and every pointer 16-byte aligned (the Python wrapper guarantees all of
// it). Returns the cudaError_t of the launch (0 = success).
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
  return launch<false>(q, k, v, o, nullptr, dtype, B, Nq, Nk, H, D, n_actual, st,
                       scale, stream);
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
  return launch<true>(q, k, v, o, static_cast<float*>(lse), dtype, B, Nq, Nk, H, D,
                      n_actual, st, scale, stream);
}
