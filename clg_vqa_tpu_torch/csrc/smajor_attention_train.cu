// S-major training attention for Hopper (sm_90a): forward and backward (B5).
//
// Replaces the TPU kernels clg_vqa_tpu/ops/attention.py:_sm_fwd_kernel and
// _sm_bwd_kernel as launched by _attn_train_sm_fwd/_bwd (entries
// fused_attention_train_smajor and its eval twin fused_attention_smajor).
// The operands are S-major and row-major, [S, B, H*hd]: sample b, row s, head
// h start at (s*B + b)*H*hd + h*hd. The bias is float32 [B, S] and the
// per-head bias gradient float32 [B, H, S], summed over heads by the caller.
//
// The math is B1's (flat_attention_train.cu): both files instantiate B1's
// two device codes, here with row stride B*H*hd (196,608 bytes apart at
// B 128, 12 heads of 64, bf16) and sample stride H*hd: in bf16 the
// tensor-core forward and backward (attention_train_mma.cuh, B3's
// kernels; the forward saves the row statistics and keep bits that the
// backward reads), in fp32 the forward and backward on the fp32 CUDA cores
// (attention_train.cuh, one block per (head, sample)). Dropout is keyed by
// (seed, absolute sample, head, query row, key column // 16), not per grid
// cell as the TPU kernel keys it (_sm_cell_seed), so on the same values and
// seed B5 and B1 give the same bits, forward and backward. Their bounds and
// designs are B1's.
#include "attention_train.cuh"
#include "attention_train_mma.cuh"

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

// dtype: 0 = float32 (bf16 takes smajor_attention_train_mma_fwd below; any other
// dtype returns cudaErrorInvalidValue). q/k/v/out: [S, B, H*hd] contiguous,
// bias: [B, S] float32 (additive, key side). keep_t: u8 keep threshold
// (256 = no dropout), rscale = 256/keep_t as float. blocked = 1: the
// key-blocked forward. Returns cudaGetLastError().
int smajor_attention_train_fwd(int dtype, const void* q, const void* k, const void* v,
                               const void* bias, void* out, int B, int S, int H, int hd,
                               int keep_t, float rscale, unsigned long long seed,
                               void* stream, int blocked) {
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return (int)attn_train::fwd_hd<float>(hd, q, k, v, static_cast<const float*>(bias), out, B,
                                        S, H, smajor(B, H, hd), keep_t, rscale, seed,
                                        static_cast<cudaStream_t>(stream), blocked);
}

// The same operands plus dout [S, B, H*hd]; writes dq, dk, dv [S, B, H*hd]
// and the per-head bias gradient dbias_heads [B, H, S]. dtype: 0 = float32
// (bf16 takes smajor_attention_train_mma_bwd below; any other dtype returns
// cudaErrorInvalidValue). dq32: null, or a float32 [B, H, S, hd] buffer for
// the key-blocked backward.
int smajor_attention_train_bwd(int dtype, const void* q, const void* k, const void* v,
                               const void* bias, const void* dout, void* dq, void* dk,
                               void* dv, void* dbias_heads, int B, int S, int H, int hd,
                               int keep_t, float rscale, unsigned long long seed,
                               void* stream, void* dq32) {
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return (int)attn_train::bwd_hd<float>(
      hd, q, k, v, static_cast<const float*>(bias), dout, dq, dk, dv,
      static_cast<float*>(dbias_heads), B, S, H, smajor(B, H, hd), keep_t, rscale, seed,
      static_cast<cudaStream_t>(stream), static_cast<float*>(dq32));
}

// The bf16 tensor-core kernels (attention_train_mma.cuh). Shared memory
// (bytes) of one block of the forward (backward = 0) or the backward
// (backward = 1) at this S and head dim: the layout does not enter it.
long long smajor_attention_train_mma_smem_bytes(int S, int hd, int backward) {
  return attn_train_mma::smem_bytes(S, hd, backward);
}

// 1 where the bf16 backward at (S, hd) needs its float32 [B, H, S, hd] dq
// buffer (dq32 below), else 0.
int smajor_attention_train_mma_needs_dq32(int S, int hd) {
  return attn_train_mma::needs_dq32(S, hd);
}

// bf16 q/k/v/out: [S, B, H*hd] contiguous, 16-byte aligned; bias, keep_t,
// rscale and seed as smajor_attention_train_fwd. Also writes, where given,
// what the backward reads: stats, float32 [B, H, S, 2], and with dropout
// keep_words, uint16 [B, H, S, ceil(S/16)]. Returns cudaGetLastError().
int smajor_attention_train_mma_fwd(const void* q, const void* k, const void* v,
                                   const void* bias, void* out, void* stats, void* keep_words,
                                   int B, int S, int H, int hd, int keep_t, float rscale,
                                   unsigned long long seed, void* stream) {
  return attn_train_mma::forward(q, k, v, bias, out, stats, keep_words, B, S, H, hd,
                                 smajor(B, H, hd), keep_t, rscale, seed, stream);
}

// The same operands plus bf16 dout [S, B, H*hd] (16-byte aligned) and the
// forward's stats and keep_words; writes bf16 dq, dk, dv [S, B, H*hd] and
// the float32 per-head bias gradient dbias_heads [B, H, S]. dq32: a float32
// [B, H, S, hd] buffer where needs_dq32 says so (its contents on entry do
// not matter), else null.
int smajor_attention_train_mma_bwd(const void* q, const void* k, const void* v,
                                   const void* bias, const void* dout, const void* stats,
                                   const void* keep_words, void* dq, void* dk, void* dv,
                                   void* dbias_heads, int B, int S, int H, int hd, int keep_t,
                                   float rscale, void* stream, void* dq32) {
  return attn_train_mma::backward(q, k, v, bias, dout, stats, keep_words, dq, dk, dv,
                                  dbias_heads, dq32, B, S, H, hd, smajor(B, H, hd), keep_t,
                                  rscale, stream);
}

}  // extern "C"
