// The wgmma/TMA designs of kernel 10 (tubelet_embed_wgmma.cu): bf16
// ("wgmma") and f32 on 3xTF32 ("wgmma.tf32x3"), as tubelet_embed.cu's C
// entry reaches them: both sources build into one library (ops/_build.py),
// so the entry calls these launchers directly.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace tubwg {

// Whether the designs take a call: kw*C in {16, 32, 48, 64}, W*C and D
// multiples of 8 (the run-length shapes).
bool takes(int C, int W, int kw, int D);

// Bytes of scratch a call needs for W^T (K-step, D, run) K-major: in bf16
// (dtype 1), or its big and small TF32 parts in f32 (dtype 0).
size_t scratch_bytes(int dtype, int K, int D);

// out (B*N, D) = patches (B*N, K) x w (K, D) + bias, the patches read from
// video (B, T, H, W, C) by TMA; dtype 0 = float32, 1 = bfloat16; `scratch`
// of scratch_bytes. Launches the pre-pass over w, then the product. Returns
// the first launch error.
cudaError_t launch(const void* video, const void* w, const void* bias, void* out, void* scratch,
                   int dtype, int B, int T, int H, int W, int C, int kt, int kh, int kw, int D,
                   cudaStream_t s);

}  // namespace tubwg
