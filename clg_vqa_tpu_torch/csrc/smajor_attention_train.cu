// S-major training attention for Hopper (sm_90a): forward and backward (B5).
//
// Replaces the TPU kernels clg_vqa_tpu/ops/attention.py:_sm_fwd_kernel and
// _sm_bwd_kernel as launched by _attn_train_sm_fwd/_bwd (entries
// fused_attention_train_smajor and its eval twin fused_attention_smajor).
// The operands are S-major and row-major, [S, B, H*hd]: sample b, row s, head
// h start at (s*B + b)*H*hd + h*hd. The bias is float32 [B, S] and the
// per-head bias gradient float32 [B, H, S], summed over heads by the caller.
//
// The math is B1's (flat_attention_train.cu): both files instantiate the
// per-(head, sample) device code of attention_train.cuh, here with row
// stride B*H*hd and sample stride H*hd. Dropout is keyed by (seed, absolute
// sample, head, query row, key column // 16), not per grid cell as the TPU
// kernel keys it (_sm_cell_seed), so on the same values and seed B5 and B1
// give the same bits, forward and backward. Its bound and design are B1's:
// the products run on the fp32 CUDA cores, one block per (head, sample).
#include "attention_train.cuh"

namespace {

attn_train::Layout smajor(int B, int H, int hd) {
  const long long HD = (long long)H * hd;
  return {(long long)B * HD, HD, hd};
}

}  // namespace

extern "C" {

// Shared memory (bytes) one block of the forward (backward = 0) or the
// backward (backward = 1) needs at this S and head dim, all-keys (blocked =
// 0) or key-blocked (blocked = 1).
long long smajor_attention_train_smem_bytes(int S, int hd, int backward, int blocked) {
  return attn_train::smem_bytes(S, hd, backward, blocked);
}

// dtype: 0 = float32, 1 = bfloat16. q/k/v/out: [S, B, H*hd] contiguous,
// bias: [B, S] float32 (additive, key side). keep_t: u8 keep threshold
// (256 = no dropout), rscale = 256/keep_t as float. blocked = 1: the
// key-blocked forward. Returns cudaGetLastError().
int smajor_attention_train_fwd(int dtype, const void* q, const void* k, const void* v,
                               const void* bias, void* out, int B, int S, int H, int hd,
                               int keep_t, float rscale, unsigned long long seed,
                               void* stream, int blocked) {
  return attn_train::forward(dtype, q, k, v, bias, out, B, S, H, hd, smajor(B, H, hd),
                             keep_t, rscale, seed, stream, blocked);
}

// The same operands plus dout [S, B, H*hd]; writes dq, dk, dv [S, B, H*hd]
// (operand dtype) and the per-head bias gradient dbias_heads [B, H, S].
// dq32: null, or a float32 [B, H, S, hd] buffer for the key-blocked backward.
int smajor_attention_train_bwd(int dtype, const void* q, const void* k, const void* v,
                               const void* bias, const void* dout, void* dq, void* dk,
                               void* dv, void* dbias_heads, int B, int S, int H, int hd,
                               int keep_t, float rscale, unsigned long long seed,
                               void* stream, void* dq32) {
  return attn_train::backward(dtype, q, k, v, bias, dout, dq, dk, dv, dbias_heads, B, S, H,
                              hd, smajor(B, H, hd), keep_t, rscale, seed, stream, 0, dq32);
}

}  // extern "C"
