// Flash-attention forward with an additive logits bias for Hopper
// (sm_90a), bound through a plain C interface (ctypes; see
// laryngeal_tpu_torch/ops/flash_attention.py).
//
// Replaces the Pallas TPU kernel _attention_kernel_bias of
// laryngeal_tpu/ops/flash_attention.py (:213, launched at :359): kernel 1
// (flash_attention_fwd.cu) plus a logits bias, rounded to q's dtype (the
// TPU wrapper's bias.astype(q.dtype), :351) and added in f32 after the
// scale (:234), keys >= n_actual masked to -1e30, P rounded to the input
// dtype before P.V (:243). It is kernel 1's template
// (flash_attention_fwd.cuh) with the bias on.
//
// What bounds it on the H100: kernel 1's operations (0.245 ms in bf16 at
// the ViViT-B shape) and, for a full per-head bias, its bytes: the
// (1, 12, 3137, 3137) f32 bias is 472 MB, 0.141 ms at 3.35 TB/s. The TPU
// wrapper broadcasts the bias to (B*H, Nq_pad, Nk_pad) in q's dtype first
// (1.9 GB in bf16 at ViViT-B, read once per batch entry); this kernel reads
// the bias through a strided view of its broadcast to (B, H, Nq, Nk),
// stride 0 on the broadcast dimensions, so that copy is never made, and:
//   * the blocks that read the same bias tile (a per-head bias read by
//     every batch entry) run next to each other (block_coords), so HBM
//     serves each tile once and L2 the other batch entries: the per-head
//     bias is read from HBM once, not B times;
//   * the bias rows are not 16-byte aligned (an f32 row of Nk = 3137 is
//     12548 bytes), so they cannot take kernel 1's 16-byte cp.async. Each
//     thread reads its own S fragment's bias values from two row pointers
//     (rows g and g + 8 at key 2 * tig) at constant offsets through L1,
//     and issues the next key tile's loads right after the softmax, so
//     they are in flight during P.V and the next Q.K^T. Rows past Nq read
//     row Nq - 1 (never stored) and only the last key tile checks Nk, so a
//     value costs one load and no address arithmetic;
//   * registers: in bf16 a thread holds its 32 values as 16 bf16 pairs
//     (they are rounded to bf16 anyway), 16 registers fewer than f32 values,
//     which keeps three blocks an SM (an f32 copy took 179 registers and
//     left room for two).
// Not yet done (later work): staging the bias tile through shared memory,
// wgmma/TMA.

#include "flash_attention_fwd.cuh"

using namespace flash_fwd;

// flash_attention_fwd (flash_attention_fwd.cu) plus an additive logits
// bias: bias_dtype 0 = float32, 1 = bfloat16, read through the element
// strides (sbb, sbh, sbq) of its broadcast to (B, H, Nq, Nk) (0 on a
// broadcast dimension, any alignment), its key stride 1. order picks the
// block order (block_coords): the wrapper puts the bias's broadcast
// dimensions fastest. Returns the cudaError_t of the launch (0 = success).
extern "C" int flash_attention_fwd_bias(const void* q, const void* k, const void* v,
                                        const void* bias, void* o, int dtype, int bias_dtype,
                                        int B, int Nq, int Nk, int H, int D, int n_actual,
                                        long long sqb, long long sqn, long long sqh,
                                        long long skb, long long skn, long long skh,
                                        long long svb, long long svn, long long svh,
                                        long long sob, long long son, long long soh,
                                        long long sbb, long long sbh, long long sbq,
                                        int order, float scale, void* stream) {
  const long long st[12] = {sqb, sqn, sqh, skb, skn, skh,
                            svb, svn, svh, sob, son, soh};
  const BiasArgs args = {bias, sbb, sbh, sbq, order};
  if (bias_dtype == 0)
    return launch<false, 1>(q, k, v, o, nullptr, dtype, B, Nq, Nk, H, D, n_actual, st, scale,
                            args, stream);
  if (bias_dtype == 1)
    return launch<false, 2>(q, k, v, o, nullptr, dtype, B, Nq, Nk, H, D, n_actual, st, scale,
                            args, stream);
  return (int)cudaErrorInvalidValue;
}
