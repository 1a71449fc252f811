// Kernels 3 and 4 in float32 on the tensor cores, 3xTF32 (design
// "wgmma.tf32x3", flash_attention_bwd_tf32.cu), as flash_attention_bwd.cu's
// launchers reach them: both sources build into one library (ops/_build.py),
// so launch_dq and launch_dkv call these directly.

#pragma once

#include <cuda_runtime.h>

namespace fabtf32 {

// Kernel 3 in f32: q, k, v, dout (B, N, H, D) f32 with D <= 64 (a multiple
// of 8) and every one of the 12 input strides positive (the caller checks);
// lse, delta f32 (B, H, Nq) contiguous; dq written through st[12..14]. `st`
// holds 15 strides: q, k, v, dO, dq (batch, sequence, head each). Returns the
// launch's error.
cudaError_t dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dq, int B, int Nq, int Nk, int H, int D, int n_actual,
               const long long* st, float scale, cudaStream_t s);

// Floats of kernel 4's scratch: q's and dO's forms from its pre-pass, each
// query's lse and delta.
size_t dkv_scratch_floats(int B, int H, int Nq, int D);

// Kernel 4 in f32: as dq, with dk and dv written through st[12..17] (18
// strides: q, k, v, dO, dk, dv), and `scratch` of dkv_scratch_floats(B, H,
// Nq, D) floats. Two launches: the pre-pass, then dK and dV. Keys >=
// n_actual get dK = dV = 0 exactly.
cudaError_t dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                const float* delta, void* dk, void* dv, float* scratch, int B, int Nq, int Nk,
                int H, int D, int n_actual, const long long* st, float scale, cudaStream_t s);

}  // namespace fabtf32
