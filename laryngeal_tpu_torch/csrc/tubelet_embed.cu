// Tubelet embedding for Hopper (sm_90a), bound through a plain C interface
// (ctypes; see laryngeal_tpu_torch/ops/tubelet.py).
//
// Replaces the Pallas TPU kernel _matmul_kernel of
// laryngeal_tpu/ops/tubelet.py (:73, launched at :94): the ViViT stem as one
// product, out (B*N, D) = patches (B*N, K) x W (K, D) + bias, K = kt*kh*kw*C
// (1536 for the (2, 16, 16) tubelet over RGB), f32 accumulation, the bias
// added in f32, the output rounded once to the video's dtype. The wrapper
// casts W and the bias to the video's dtype first, as the TPU wrapper does.
//
// The TPU kernel multiplies a materialised patch matrix. This one reads the
// video (B, T, H, W, C) itself: for a token (b, t', h', w') and a fixed
// (dt, dh) of its tubelet, the kw*C values of the patch row are one
// contiguous run of the video row at (b, t'*kt + dt, h'*kh + dh), starting
// at w'*kw*C. At kw*C = 48 that run is 96 bytes in bf16 (192 in f32) at a
// multiple of 96 bytes, and the video row (W*C*2 = 1344 bytes) is a
// multiple of 16 bytes, so a K-step of one run (48 values) copies each
// A-tile row with 16-byte cp.async. The 77 MB patch matrix of ViViT-B is
// never written or read.
//
// What bounds it on the H100: at ViViT-B (M = 8*3136 = 25088, K = 1536,
// D = 768) one call is 2*M*K*D = 59.2 GFLOP against ~118 MB of video, W
// and output: ~500 FLOP per byte, above the ~295 FLOP/byte ridge, so in
// bf16 it is bound by tensor-core operations (0.060 ms at 989 TFLOP/s). The
// design puts the product on the tensor cores and reads each video byte
// from HBM about once:
//   * bf16: 128 x 128 output tiles, 8 warps of 64 x 32, mma.sync.m16n8k16
//     (bf16 operands, f32 accumulators); A (the video runs) and B (rows of
//     W) stream through a 3-stage cp.async ring, one K-step of kw*C values
//     a stage; fragments come through ldmatrix (.trans for W) from rows
//     padded by 8 elements, free of bank conflicts. The grid runs the D
//     tiles of one row tile next to each other, so a video tile comes from
//     HBM once and from L2 for the other D tiles.
//   * f32: the FMA units (tensor cores offer f32 only as TF32, which loses
//     the 1e-5 agreement): 64 x 64 tiles, 256 threads of 4 x 4 outputs,
//     double-buffered cp.async tiles.
// Those two are built for the run lengths kw*C in {16, 32, 48, 64} with
// W*C and D multiples of 8 (16-byte runs; ViViT-B's stem is 48). Every
// other shape -- the TPU kernel takes any, padding M -- runs the general
// path in either dtype: the f32 kernel's tiling on the FMA units with
// scalar loads (a run need not be 16-byte aligned) and the run walked in
// chunks of 32 values, f32 accumulation, the output rounded once. No model
// reaches it; it is correct, not fast. tubelet_embed_last_design reports
// which design the last call ran.
// Not yet done (later work): wgmma/TMA and a persistent schedule.

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Where each video run and W row lives: a token m = (b, t', h', w') starts
// at b*sb + t'*kt*st + h'*kh*sh + w'*L; K-step s = (dt, dh) adds dt*st +
// dh*sh and takes rows [s*L, s*L + L) of W.
struct Geometry {
  int M, D, n_t, n_h, n_w, kt, kh;
  long long sb, st, sh;  // video strides (elements) of a clip, a frame, a row
};

template <int L>
__device__ __forceinline__ long long token_base(const Geometry& g, int m) {
  const int per_clip = g.n_t * g.n_h * g.n_w;
  const int b = m / per_clip, r = m % per_clip;
  const int t = r / (g.n_h * g.n_w), hw = r % (g.n_h * g.n_w);
  const int h = hw / g.n_w, w = hw % g.n_w;
  return b * g.sb + (long long)t * g.kt * g.st + (long long)h * g.kh * g.sh + (long long)w * L;
}

// ---------------------------------------------------------------------------
// bf16 tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kBM = 128, kBN = 128, kStages = 3;

template <int L>
__global__ void __launch_bounds__(kThreads)
tubelet_bf16_kernel(const __nv_bfloat16* __restrict__ video,
                    const __nv_bfloat16* __restrict__ w,
                    const __nv_bfloat16* __restrict__ bias,
                    __nv_bfloat16* __restrict__ out, Geometry g) {
  constexpr int kLdA = L + kPad, kLdB = kBN + kPad;
  constexpr int kAStage = kBM * kLdA, kBStage = L * kLdB;
  constexpr int kChunks = L / 16;  // 16-byte chunks per thread per tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* b_s = a_s + kStages * kAStage;

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int warp_m = warp / 4, warp_n = warp % 4;
  const int gq = lane / 4, tig = lane % 4;
  const int lm_mat = lane / 8, lm_row = lane % 8;

  // This thread's A chunks: the same rows at every K-step.
  const __nv_bfloat16* a_src[kChunks];
  int a_dst[kChunks];
  bool a_ok[kChunks];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / (L / 8), col = (c % (L / 8)) * 8;
    const int m = m0 + r;
    a_ok[i] = m < g.M;
    a_src[i] = video + (a_ok[i] ? token_base<L>(g, m) : 0) + col;
    a_dst[i] = r * kLdA + col;
  }

  auto load_stage = [&](int buf, int s) {
    const long long off = (long long)(s / g.kh) * g.st + (long long)(s % g.kh) * g.sh;
    __nv_bfloat16* as = a_s + buf * kAStage;
    __nv_bfloat16* bs = b_s + buf * kBStage;
#pragma unroll
    for (int i = 0; i < kChunks; ++i)
      cp_async16(as + a_dst[i], a_ok[i] ? a_src[i] + off : video, a_ok[i] ? 16 : 0);
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c = tid + i * kThreads;
      const int kr = c / (kBN / 8), col = (c % (kBN / 8)) * 8;
      const bool ok = n0 + col < g.D;
      const __nv_bfloat16* src = ok ? w + (long long)(s * L + kr) * g.D + n0 + col : w;
      cp_async16(bs + kr * kLdB + col, src, ok ? 16 : 0);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int n_steps = g.kt * g.kh;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) load_stage(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s landed; every warp is done with stage s - 1
    const int nxt = s + kStages - 1;
    if (nxt < n_steps) load_stage(nxt % kStages, nxt);
    cp_async_commit();

    const __nv_bfloat16* as = a_s + (s % kStages) * kAStage;
    const __nv_bfloat16* bs = b_s + (s % kStages) * kBStage;
#pragma unroll
    for (int kk = 0; kk < L / 16; ++kk) {
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) load_a_frag<L>(a[mt], as, warp_m * 64 + mt * 16, kk);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bf[4];
        const int row = kk * 16 + (lm_mat & 1) * 8 + lm_row;
        const int col = (warp_n * 4 + np * 2 + (lm_mat >> 1)) * 8;
        ldmatrix_x4_trans(bf, bs + row * kLdB + col);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma_bf16(acc[mt][np * 2], a[mt], bf[0], bf[1]);
          mma_bf16(acc[mt][np * 2 + 1], a[mt], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // Epilogue: + bias in f32, one rounding to bf16.
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + warp_n * 32 + nt * 8 + tig * 2;
    if (col >= g.D) continue;
    const float b0 = __bfloat162float(bias[col]), b1 = __bfloat162float(bias[col + 1]);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + warp_m * 64 + mt * 16 + gq + r * 8;
        if (row >= g.M) continue;
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * g.D + col) =
            __floats2bfloat162_rn(acc[mt][nt][2 * r] + b0, acc[mt][nt][2 * r + 1] + b1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32 kernel (FMA units)
// ---------------------------------------------------------------------------

constexpr int kF32BM = 64, kF32BN = 64;

template <int L>
__global__ void __launch_bounds__(kThreads)
tubelet_f32_kernel(const float* __restrict__ video, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out, Geometry g) {
  constexpr int kLdA = L + 4, kLdB = kF32BN + 4;  // rows stay 16-byte aligned
  constexpr int kAStage = kF32BM * kLdA, kBStage = L * kLdB;
  constexpr int kChunks = L / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* a_s = reinterpret_cast<float*>(smem_raw);
  float* b_s = a_s + 2 * kAStage;

  const int n0 = blockIdx.x * kF32BN, m0 = blockIdx.y * kF32BM;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  const float* a_src[kChunks];
  int a_dst[kChunks];
  bool a_ok[kChunks];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / (L / 4), col = (c % (L / 4)) * 4;
    const int m = m0 + r;
    a_ok[i] = m < g.M;
    a_src[i] = video + (a_ok[i] ? token_base<L>(g, m) : 0) + col;
    a_dst[i] = r * kLdA + col;
  }
  auto load_stage = [&](int buf, int s) {
    const long long off = (long long)(s / g.kh) * g.st + (long long)(s % g.kh) * g.sh;
    float* as = a_s + buf * kAStage;
    float* bs = b_s + buf * kBStage;
#pragma unroll
    for (int i = 0; i < kChunks; ++i)
      cp_async16(as + a_dst[i], a_ok[i] ? a_src[i] + off : video, a_ok[i] ? 16 : 0);
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c = tid + i * kThreads;
      const int kr = c / (kF32BN / 4), col = (c % (kF32BN / 4)) * 4;
      const bool ok = n0 + col < g.D;
      const float* src = ok ? w + (long long)(s * L + kr) * g.D + n0 + col : w;
      cp_async16(bs + kr * kLdB + col, src, ok ? 16 : 0);
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int n_steps = g.kt * g.kh;
  load_stage(0, 0);
  cp_async_commit();
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<0>();
    __syncthreads();  // stage s landed; every thread is done with stage s - 1
    if (s + 1 < n_steps) load_stage((s + 1) & 1, s + 1);
    cp_async_commit();
    const float* as = a_s + (s & 1) * kAStage;
    const float* bs = b_s + (s & 1) * kBStage;
#pragma unroll
    for (int k4 = 0; k4 < L; k4 += 4) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(as + (ty * 4 + i) * kLdA + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 bv = *reinterpret_cast<const float4*>(bs + (k4 + kk) * kLdB + tx * 4);
        const float bj[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float ai = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ai, bj[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const int col = n0 + tx * 4;
  if (col >= g.D) return;
  const float4 bv = *reinterpret_cast<const float4*>(bias + col);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= g.M) continue;
    *reinterpret_cast<float4*>(out + (long long)row * g.D + col) =
        make_float4(acc[i][0] + bv.x, acc[i][1] + bv.y, acc[i][2] + bv.z, acc[i][3] + bv.w);
  }
}

// ---------------------------------------------------------------------------
// The general path (any shape): FMA units, scalar loads
// ---------------------------------------------------------------------------

constexpr int kGenBM = 64, kGenBN = 64, kGenBK = 32;

// Any run length L = kw*C, any W*C and D, float or bf16 (products of bf16
// values are exact in f32, so this is the tensor-core path's arithmetic up
// to the summation order). A block owns a 64 x 64 output tile, 256 threads
// of 4 x 4 outputs; each K-step (dt, dh) walks its run in chunks of 32
// values, each staged in shared memory as f32 with scalar loads (a run
// need not be 16-byte aligned), single-buffered.
template <typename T>
__global__ void __launch_bounds__(kThreads)
tubelet_general_kernel(const T* __restrict__ video, const T* __restrict__ w,
                       const T* __restrict__ bias, T* __restrict__ out, Geometry g, int L) {
  __shared__ float a_s[kGenBM][kGenBK + 1];
  __shared__ __align__(16) float b_s[kGenBK][kGenBN];
  const int n0 = blockIdx.x * kGenBN, m0 = blockIdx.y * kGenBM;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int per_clip = g.n_t * g.n_h * g.n_w;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < g.kt * g.kh; ++s) {
    const long long off = (long long)(s / g.kh) * g.st + (long long)(s % g.kh) * g.sh;
    for (int c0 = 0; c0 < L; c0 += kGenBK) {
      __syncthreads();  // every thread is done with the last chunk
      for (int i = tid; i < kGenBM * kGenBK; i += kThreads) {
        const int r = i / kGenBK, c = i % kGenBK, m = m0 + r;
        float x = 0.f;
        if (m < g.M && c0 + c < L) {
          const int b = m / per_clip, rr = m % per_clip;
          const int t = rr / (g.n_h * g.n_w), hw = rr % (g.n_h * g.n_w);
          const long long base = b * g.sb + (long long)t * g.kt * g.st +
                                 (long long)(hw / g.n_w) * g.kh * g.sh +
                                 (long long)(hw % g.n_w) * L;
          x = to_f32(video[base + off + c0 + c]);
        }
        a_s[r][c] = x;
      }
      for (int i = tid; i < kGenBK * kGenBN; i += kThreads) {
        const int kr = i / kGenBN, col = i % kGenBN;
        const bool ok = c0 + kr < L && n0 + col < g.D;
        b_s[kr][col] = ok ? to_f32(w[(long long)(s * L + c0 + kr) * g.D + n0 + col]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kGenBK; ++kk) {
        const float4 bv = *reinterpret_cast<const float4*>(&b_s[kk][tx * 4]);
        const float bj[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float ai = a_s[ty * 4 + i][kk];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ai, bj[j], acc[i][j]);
        }
      }
    }
  }

  // + bias in f32, one rounding to T.
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + tx * 4 + j;
    if (col >= g.D) continue;
    const float bj = to_f32(bias[col]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty * 4 + i;
      if (row < g.M) out[(long long)row * g.D + col] = from_f32<T>(acc[i][j] + bj);
    }
  }
}

template <typename T>
cudaError_t launch_general(const void* video, const void* w, const void* bias, void* out,
                           const Geometry& g, int L, cudaStream_t stream) {
  dim3 grid((g.D + kGenBN - 1) / kGenBN, (g.M + kGenBM - 1) / kGenBM);
  tubelet_general_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(video), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<T*>(out), g, L);
  return cudaGetLastError();
}

// The design of the last launch: 0 = FMA (f32, a run-length instance),
// 1 = mma.sync (bf16, a run-length instance), 2 = general; -1 before the
// first. Read through tubelet_embed_last_design.
int g_last_design = -1;

template <int L>
cudaError_t launch_l(const void* video, const void* w, const void* bias, void* out, int dtype,
                     const Geometry& g, cudaStream_t stream) {
  if (dtype == 1) {
    const size_t smem = (size_t)kStages * (kBM * (L + kPad) + L * (kBN + kPad)) * 2;
    cudaError_t err = cudaFuncSetAttribute(tubelet_bf16_kernel<L>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((g.D + kBN - 1) / kBN, (g.M + kBM - 1) / kBM);
    tubelet_bf16_kernel<L><<<grid, kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(video), static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out), g);
    return cudaGetLastError();
  }
  const size_t smem = (size_t)2 * (kF32BM * (L + 4) + L * (kF32BN + 4)) * 4;
  cudaError_t err = cudaFuncSetAttribute(tubelet_f32_kernel<L>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((g.D + kF32BN - 1) / kF32BN, (g.M + kF32BM - 1) / kF32BM);
  tubelet_f32_kernel<L><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(video), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), g);
  return cudaGetLastError();
}

}  // namespace

// video (B, T, H, W, C), w (kt*kh*kw*C, D), bias (D,) and out (B*N, D), all
// contiguous, of one dtype (0 = float32, 1 = bfloat16), 16-byte aligned,
// T, H, W multiples of kt, kh, kw (the Python wrapper checks all of it).
// kw*C in {16, 32, 48, 64} with W*C and D multiples of 8 runs its
// run-length instance; every other shape the general path. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int tubelet_embed(const void* video, const void* w, const void* bias, void* out,
                             int dtype, int B, int T, int H, int W, int C, int kt, int kh,
                             int kw, int D, void* stream) {
  const int L = kw * C;
  if ((dtype != 0 && dtype != 1) || D <= 0 || C < 1 || kt < 1 || kh < 1 || kw < 1 ||
      T % kt || H % kh || W % kw)
    return (int)cudaErrorInvalidValue;
  Geometry g;
  g.n_t = T / kt;
  g.n_h = H / kh;
  g.n_w = W / kw;
  g.M = B * g.n_t * g.n_h * g.n_w;
  g.D = D;
  g.kt = kt;
  g.kh = kh;
  g.sh = (long long)W * C;
  g.st = g.sh * H;
  g.sb = g.st * T;
  if (g.M <= 0 || (g.M + kF32BM - 1) / kF32BM > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool run = (L == 16 || L == 32 || L == 48 || L == 64) && (W * C) % 8 == 0 && D % 8 == 0;
  if (!run) {
    g_last_design = 2;
    return (int)(dtype == 1 ? launch_general<__nv_bfloat16>(video, w, bias, out, g, L, s)
                            : launch_general<float>(video, w, bias, out, g, L, s));
  }
  g_last_design = dtype == 1 ? 1 : 0;
  switch (L) {
    case 16: return (int)launch_l<16>(video, w, bias, out, dtype, g, s);
    case 32: return (int)launch_l<32>(video, w, bias, out, dtype, g, s);
    case 48: return (int)launch_l<48>(video, w, bias, out, dtype, g, s);
    default: return (int)launch_l<64>(video, w, bias, out, dtype, g, s);
  }
}

// The design (0 = FMA, 1 = mma.sync, 2 = general) of the last launch; -1
// before the first.
extern "C" int tubelet_embed_last_design() { return g_last_design; }
