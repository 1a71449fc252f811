// Kernels 6 and 7 in float32 at short sequences on the tensor cores, 3xTF32
// on mma.sync (design "mma.tf32x3", short_attention_tf32_mma.cu), as
// short_attention.cu's C entries reach them: the sources build into one
// library (ops/_build.py), so the entries call these launchers directly.

#pragma once

#include <cuda_runtime.h>

namespace shortmma {

// The sequence lengths the design takes: a (sequence, head) pair's rows fit
// four 16-row mma tiles, one consumer warp each.
constexpr int kMinN = 1, kMaxN = 64;
// The head dim it holds (D <= 64, padded to a multiple of 8 by the caller).
constexpr int kMaxD = 64;

// Whether the design takes a call: float32 (dtype 0), kMinN <= N <= kMaxN,
// D <= kMaxD and every one of the `n` (batch, sequence, head) strides `st`
// positive (TMA cannot describe a stride of 0).
bool takes(int dtype, int N, int D, const long long* st, int n);

// Kernel 6: q, k, v, o (B, N, H, D) f32 through the 12 strides `st` (batch,
// sequence, head of q, k, v, o). Returns the launch's error.
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, int B, int H, int N, int D,
                const long long* st, float scale, cudaStream_t s);

// Kernel 7: g in, dq, dk, dv out, through the 21 strides `st` (q, k, v, g,
// dq, dk, dv). One launch, no scratch.
cudaError_t bwd(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
                void* dv, int B, int H, int N, int D, const long long* st, float scale,
                cudaStream_t s);

}  // namespace shortmma
