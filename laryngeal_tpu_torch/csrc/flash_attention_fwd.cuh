// The flash-attention forward template shared by flash_attention_fwd.cu
// (kernels 1-2) and flash_attention_bias.cu (kernel 5); see the notes at
// the top of flash_attention_fwd.cu. With the bias off (kBias = 0) every
// bias statement compiles away and the code is kernels 1 and 2's.

#pragma once

#include <type_traits>

#include "flash_attention_common.cuh"

namespace flash_fwd {

using namespace flash;

// ---------------------------------------------------------------------------
// bf16 tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kBM = 64;       // query rows per block (16 per warp)
constexpr int kBN = 64;       // keys per K/V tile

// kBias: 0 none (kernels 1-2), 1 float32 bias, 2 bfloat16 bias (kernel 5).
struct BiasArgs {
  const void* ptr;
  long long sb, sh, sq;  // element strides of the (B, H, Nq, Nk) broadcast view;
                         // the key stride is 1
  int order;             // block order, see block_coords
};
inline constexpr BiasArgs kNoBias = {nullptr, 0, 0, 0, 0};

template <int kBias>
using BiasT = std::conditional_t<kBias == 2, __nv_bfloat16, float>;

// (query tile, b, h) of this block. Order 0: a (q tiles, B*H) grid, q tiles
// fastest (kernels 1-2 and an unbroadcast bias). Orders 1-3, a 1-D grid
// whose fastest axes are the bias's broadcast ones, slowest first:
// 1 = (h, q tile, b), 2 = (b, q tile, h), 3 = (q tile, b, h).
__device__ __forceinline__ void block_coords(int order, int n_qt, int B, int H, int& qt,
                                             int& b, int& h) {
  if (order == 0) {
    qt = blockIdx.x;
    b = blockIdx.y / H;
    h = blockIdx.y % H;
    return;
  }
  int i = blockIdx.x;
  if (order == 1) {
    b = i % B; i /= B; qt = i % n_qt; h = i / n_qt;
  } else if (order == 2) {
    h = i % H; i /= H; qt = i % n_qt; b = i / n_qt;
  } else {
    h = i % H; i /= H; b = i % B; qt = i / B;
  }
}

// The row pointer of the bias at (b, h, row) of the broadcast view.
template <int kBias>
__device__ __forceinline__ const BiasT<kBias>* bias_row_ptr(const BiasArgs& bias, int b, int h,
                                                            int row) {
  return static_cast<const BiasT<kBias>*>(bias.ptr) + b * bias.sb + h * bias.sh +
         row * bias.sq;
}

__device__ __forceinline__ float bias_value(const float* p) { return __ldg(p); }
__device__ __forceinline__ float bias_value(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

template <int HD, bool kLse, int kBias>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse,
                      int B, int H, int Nq, int Nk, int D, int n_actual,
                      long long sqb, long long sqn, long long sqh,
                      long long skb, long long skn, long long skh,
                      long long svb, long long svn, long long svh,
                      long long sob, long long son, long long soh,
                      float scale, BiasArgs bias) {
  constexpr int kLd = HD + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + kBM * kLd;     // 2 buffers
  __nv_bfloat16* v_s = k_s + 2 * kBN * kLd; // 2 buffers

  int qt, b, h;
  block_coords(bias.order, (Nq + kBM - 1) / kBM, B, H, qt, b, h);
  const int bh = b * H + h;
  const int q0 = qt * kBM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;

  const __nv_bfloat16* qb = q + b * sqb + h * sqh;
  const __nv_bfloat16* kb = k + b * skb + h * skh;
  const __nv_bfloat16* vb = v + b * svb + h * svh;
  // kernel 5: this thread's bias rows g and g + 8 at its first key, 2 * tig
  // (a row past Nq reads row Nq - 1; its output is never stored), and its
  // S fragment's bias values for the current key tile, rounded to bf16 and
  // kept as pairs (keys 2 * tig and 2 * tig + 1 of row g or g + 8).
  const BiasT<kBias>* bias_row[2];
  uint32_t bv[kBias != 0 ? kBN / 8 : 1][2];
  auto load_bias = [&](int key0) {
    if constexpr (kBias != 0) {
      const bool whole = key0 + kBN <= Nk;
#pragma unroll
      for (int nt = 0; nt < kBN / 8; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int off = key0 + nt * 8, key = off + tig * 2;
          const float lo = whole || key < Nk ? bias_value(bias_row[r] + off) : 0.f;
          const float hi = whole || key + 1 < Nk ? bias_value(bias_row[r] + off + 1) : 0.f;
          bv[nt][r] = pack_bf16(lo, hi);
        }
    }
  };
  if constexpr (kBias != 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      bias_row[r] = bias_row_ptr<kBias>(bias, b, h, min(q0 + warp * 16 + g + r * 8, Nq - 1)) +
                    tig * 2;
    load_bias(0);
  }

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
        float x = s[nt][j] * scale_log2;
        if constexpr (kBias != 0) {
          const uint32_t pair = bv[nt][j >> 1];
          x = fmaf(__uint_as_float(j & 1 ? pair & 0xffff0000u : pair << 16), kLog2e, x);
        }
        x = key < n_actual ? x : kMaskValue;
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
    // kernel 5: the next tile's bias, in flight during P.V and the next Q.K^T.
    if (t + 1 < n_tiles) load_bias((t + 1) * kBN);

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

template <int HD, bool kLse, int kBias>
__global__ void __launch_bounds__(kF32Threads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int B, int H, int Nq, int Nk, int D,
                     int n_actual,
                     long long sqb, long long sqn, long long sqh,
                     long long skb, long long skn, long long skh,
                     long long svb, long long svn, long long svh,
                     long long sob, long long son, long long soh,
                     float scale, BiasArgs bias) {
  constexpr int kTpr = HD / 32;                 // threads per query row
  constexpr int kRows = kF32Threads / kTpr;     // query rows per block
  __shared__ __align__(16) float k_s[kF32BN][HD];
  __shared__ __align__(16) float v_s[kF32BN][HD];

  int qt, b, h;
  block_coords(bias.order, (Nq + kRows - 1) / kRows, B, H, qt, b, h);
  const int bh = b * H + h;
  const int row = qt * kRows + threadIdx.x / kTpr;
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
  // kernel 5: this row's bias (a row past Nq reads row Nq - 1).
  const BiasT<kBias>* bias_row = nullptr;
  if constexpr (kBias != 0) bias_row = bias_row_ptr<kBias>(bias, b, h, min(row, Nq - 1));

  for (int key0 = 0; key0 < Nk; key0 += kF32BN) {
    // kernel 5: this tile's bias values of the row, issued before the tile
    // copy and the products so the loads overlap them.
    float bv[kBias != 0 ? kF32BN : 1];
    if constexpr (kBias != 0) {
      const bool whole = key0 + kF32BN <= Nk;
#pragma unroll
      for (int j = 0; j < kF32BN; ++j)
        bv[j] = whole || key0 + j < Nk ? bias_value(bias_row + key0 + j) : 0.f;
    }
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
      float x = part * scale;
      if constexpr (kBias != 0) x += bv[j];
      s[j] = key0 + j < n_actual ? x : kMaskValue;
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

// The grid of order 0 is (q tiles, B*H); of orders 1-3, one dimension of
// q tiles * B * H blocks (block_coords).
inline dim3 grid_of(int order, int n_qt, int B, int H) {
  return order == 0 ? dim3(n_qt, B * H) : dim3(n_qt * B * H);
}

template <int HD, bool kLse, int kBias>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                        int B, int Nq, int Nk, int H, int D, int n_actual,
                        const long long* st, float scale, const BiasArgs& bias,
                        cudaStream_t stream) {
  const size_t smem = (size_t)(kBM + 4 * kBN) * (HD + kPad) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<HD, kLse, kBias>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = grid_of(bias.order, (Nq + kBM - 1) / kBM, B, H);
  flash_fwd_bf16_kernel<HD, kLse, kBias><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse,
      B, H, Nq, Nk, D, n_actual, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], scale, bias);
  return cudaGetLastError();
}

template <int HD, bool kLse, int kBias>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* lse,
                       int B, int Nq, int Nk, int H, int D, int n_actual,
                       const long long* st, float scale, const BiasArgs& bias,
                       cudaStream_t stream) {
  constexpr int kRows = kF32Threads / (HD / 32);
  const dim3 grid = grid_of(bias.order, (Nq + kRows - 1) / kRows, B, H);
  flash_fwd_f32_kernel<HD, kLse, kBias><<<grid, kF32Threads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse,
      B, H, Nq, Nk, D, n_actual, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], scale, bias);
  return cudaGetLastError();
}

template <bool kLse, int kBias>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int dtype,
           int B, int Nq, int Nk, int H, int D, int n_actual, const long long* st,
           float scale, const BiasArgs& bias, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 0 || D > 128 || D % 8 != 0 || B * H > 65535 || n_actual < 1 ||
      bias.order < 0 || bias.order > 3)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (D <= 32) return (int)launch_bf16<32, kLse, kBias>(q, k, v, o, lse, B, Nq, Nk, H, D, n_actual, st, scale, bias, s);
    if (D <= 64) return (int)launch_bf16<64, kLse, kBias>(q, k, v, o, lse, B, Nq, Nk, H, D, n_actual, st, scale, bias, s);
    return (int)launch_bf16<128, kLse, kBias>(q, k, v, o, lse, B, Nq, Nk, H, D, n_actual, st, scale, bias, s);
  }
  if (dtype == 0) {
    if (D <= 32) return (int)launch_f32<32, kLse, kBias>(q, k, v, o, lse, B, Nq, Nk, H, D, n_actual, st, scale, bias, s);
    if (D <= 64) return (int)launch_f32<64, kLse, kBias>(q, k, v, o, lse, B, Nq, Nk, H, D, n_actual, st, scale, bias, s);
    return (int)launch_f32<128, kLse, kBias>(q, k, v, o, lse, B, Nq, Nk, H, D, n_actual, st, scale, bias, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace flash_fwd
