// The wgmma/TMA designs of kernels 8 and 9 (window_attention_wgmma.cu): bf16,
// and f32 on 3xTF32 ("wgmma.tf32x3"), as window_attention.cu's C entries
// reach them: both sources build into one library (ops/_build.py), so the
// entries call these launchers directly.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace winwg {

// The largest window the design takes: two consumer warpgroups each hold 200
// keys (queries) of a 64-row tile.
constexpr int kMaxN = 400;

// Whether the design takes a call: bfloat16 (dtype 1), 1 <= N <= kMaxN, D
// (already padded to a multiple of 8) <= 32, and every one of the `n`
// (window, position, head) strides positive (TMA cannot describe a stride of
// 0).
bool takes(int dtype, int N, int D, const long long* st, int n);

// Kernel 8 (mode 0) and kernel 11 (mode 1 bf16sm: S - max rounded to bf16
// before the exp; mode 2 exp2: exp2((S - max) log2e)): q, k, v, o (BW, N,
// H, D) bf16 through the 12 strides `st` (window, position, head of q, k,
// v, o); bias (H, N, N) f32; rid (nW, N) int32 or null. Returns the
// launch's error.
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, const float* bias,
                const int* rid, int BW, int H, int N, int D, int nW, const long long* st,
                float scale, int mode, cudaStream_t s);

// Whether kernel 12's design (HB heads of a window a block, the bias
// streamed by TMA) takes a call: what `takes` takes, and N % 4 == 0 (the
// bias rows, 4 N bytes, a multiple of 16 for TMA).
bool takes_heads(int dtype, int N, int D, const long long* st, int n);

// Kernel 12, as fwd, with HB heads of a window a block (H % HB == 0).
cudaError_t fwd_heads(const void* q, const void* k, const void* v, void* o, const float* bias,
                      const int* rid, int BW, int H, int HB, int N, int D, int nW,
                      const long long* st, float scale, cudaStream_t s);

// Kernel 9: dq, dk, dv out through the 21 strides `st` (q, k, v, g, dq, dk,
// dv), the row statistics in `stats` ((BW, H, 3, N) f32 scratch), dbias's
// partial over each group of `per_group` windows in partial[group] (straight
// into dbias when groups == 1; the caller sums the groups).
cudaError_t bwd(const void* q, const void* k, const void* v, const void* g, const float* bias,
                const int* rid, void* dq, void* dk, void* dv, float* dbias, float* stats,
                float* partial, int BW, int H, int N, int D, int nW, int per_group, int groups,
                const long long* st, float scale, cudaStream_t s);

// Whether the f32 design takes a call: float32 (dtype 0) and the bf16
// design's N, D and strides.
bool takes_tf32(int dtype, int N, int D, const long long* st, int n);

// Floats of one form of the f32 design's split operands: BW H 2 planes (the
// big and small TF32 parts) of NP x 32, NP = N rounded up to 8. The forward
// takes 3 forms of scratch, the backward 7.
size_t split_form_floats(int BW, int H, int N);

// Kernels 8 and 9 in f32, as fwd and bwd, with `split` the scratch of the
// split operands (3 or 7 forms).
cudaError_t fwd_tf32(const void* q, const void* k, const void* v, void* o, const float* bias,
                     const int* rid, float* split, int BW, int H, int N, int D, int nW,
                     const long long* st, float scale, cudaStream_t s);
cudaError_t bwd_tf32(const void* q, const void* k, const void* v, const void* g,
                     const float* bias, const int* rid, void* dq, void* dk, void* dv,
                     float* dbias, float* stats, float* partial, float* split, int BW, int H,
                     int N, int D, int nW, int per_group, int groups, const long long* st,
                     float scale, cudaStream_t s);

}  // namespace winwg
