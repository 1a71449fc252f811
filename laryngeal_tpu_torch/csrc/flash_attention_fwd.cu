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
// statistics and accumulation. One template (flash_attention_fwd.cuh), two
// instantiations here; flash_attention_bias.cu instantiates it with a bias
// (kernel 5), in a source of its own so the two build in parallel.
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


#include "flash_attention_fwd.cuh"

using namespace flash_fwd;

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
  return launch<false, 0>(q, k, v, o, nullptr, dtype, B, Nq, Nk, H, D, n_actual, st,
                          scale, kNoBias, stream);
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
  return launch<true, 0>(q, k, v, o, static_cast<float*>(lse), dtype, B, Nq, Nk, H, D,
                         n_actual, st, scale, kNoBias, stream);
}
