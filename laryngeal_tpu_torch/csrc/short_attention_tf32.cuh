// Kernels 6 and 7 in float32 on the tensor cores, 3xTF32 (design
// "wgmma.tf32x3", short_attention_tf32.cu), as short_attention.cu's C
// entries reach them: both sources build into one library (ops/_build.py),
// so the entries call these launchers directly.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace shorttf {

// The sequence lengths the design takes: a row's scores over every key sit
// in a consumer's registers, 32 keys a step, at most 8 steps.
constexpr int kMinN = 65, kMaxN = 256;
// The head dim it holds (D <= 64, padded to a multiple of 8 by the caller).
constexpr int kMaxD = 64;

// Whether the design takes a call: float32 (dtype 0), kMinN <= N <= kMaxN,
// D <= kMaxD and every one of the `n` (batch, sequence, head) strides `st`
// positive (TMA cannot describe a stride of 0).
bool takes(int dtype, int N, int D, const long long* st, int n);

// Floats of the backward's scratch: each query row's base-2 max, 1 / row
// sum and delta, (B H, 3, kMaxN).
size_t bwd_scratch_floats(int B, int H);

// Kernel 6: q, k, v, o (B, N, H, D) f32 through the 12 strides `st` (batch,
// sequence, head of q, k, v, o). Returns the launch's error.
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, int B, int H, int N, int D,
                const long long* st, float scale, cudaStream_t s);

// Kernel 7: g in, dq, dk, dv out, through the 21 strides `st` (q, k, v, g,
// dq, dk, dv); `stats` is bwd_scratch_floats(B, H) floats. Two launches:
// the row statistics and dQ, then dK and dV.
cudaError_t bwd(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
                void* dv, float* stats, int B, int H, int N, int D, const long long* st,
                float scale, cudaStream_t s);

}  // namespace shorttf
