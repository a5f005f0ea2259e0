// Flat-boundary training attention for Hopper (sm_90a): forward and backward
// (B1).
//
// Replaces the TPU kernels clg_vqa_tpu/ops/attention.py:_flat_fwd_kernel and
// _flat_bwd_kernel as launched by _attn_train_flat_fwd/_bwd (entry
// fused_attention_train_flat). q, k, v, do and the gradients stay in the
// projections' [B, S, H*hd] layout, head h at column offset h*hd. The device
// code, its bound on the H100 and its design are in attention_train.cuh,
// shared with the S-major kernels (smajor_attention_train.cu).
#include "attention_train.cuh"

namespace {

attn_train::Layout flat(int S, int H, int hd) {
  const long long HD = (long long)H * hd;
  return {HD, (long long)S * HD, hd};
}

}  // namespace

extern "C" {

// Shared memory (bytes) one block of the forward (backward = 0) or the
// backward (backward = 1) needs at this S and head dim, all-keys (blocked =
// 0) or key-blocked (blocked = 1).
long long flat_attention_train_smem_bytes(int S, int hd, int backward, int blocked) {
  return attn_train::smem_bytes(S, hd, backward, blocked);
}

// dtype: 0 = float32, 1 = bfloat16. q/k/v/out: [B, S, H*hd] contiguous,
// bias: [B, S] float32 (additive, key side). keep_t: u8 keep threshold
// (256 = no dropout), rscale = 256/keep_t as float. blocked = 1: the
// key-blocked forward. Returns cudaGetLastError().
int flat_attention_train_fwd(int dtype, const void* q, const void* k, const void* v,
                             const void* bias, void* out, int B, int S, int H, int hd,
                             int keep_t, float rscale, unsigned long long seed,
                             void* stream, int blocked) {
  return attn_train::forward(dtype, q, k, v, bias, out, B, S, H, hd, flat(S, H, hd),
                             keep_t, rscale, seed, stream, blocked);
}

// The same operands plus dout [B, S, H*hd]; writes dq, dk, dv (operand
// dtype) and the per-head bias gradient dbias_heads [B, H, S] float32.
// dq32: null, or a float32 [B, H, S, hd] buffer for the key-blocked backward.
int flat_attention_train_bwd(int dtype, const void* q, const void* k, const void* v,
                             const void* bias, const void* dout, void* dq, void* dk,
                             void* dv, void* dbias_heads, int B, int S, int H, int hd,
                             int keep_t, float rscale, unsigned long long seed,
                             void* stream, void* dq32) {
  return attn_train::backward(dtype, q, k, v, bias, dout, dq, dk, dv, dbias_heads, B, S, H,
                              hd, flat(S, H, hd), keep_t, rscale, seed, stream, 0, dq32);
}

}  // extern "C"
