// Flat-boundary training attention for Hopper (sm_90a): forward and backward
// (B1).
//
// Replaces the TPU kernels clg_vqa_tpu/ops/attention.py:_flat_fwd_kernel and
// _flat_bwd_kernel as launched by _attn_train_flat_fwd/_bwd (entry
// fused_attention_train_flat). q, k, v, do and the gradients stay in the
// projections' [B, S, H*hd] layout, head h at column offset h*hd: rows of
// one head are 128 contiguous bytes (hd 64, bf16) spaced H*hd elements
// apart.
//
// Two device codes, both shared with the S-major kernels
// (smajor_attention_train.cu) and each holding its bound on the H100 and its
// design:
// - bf16: the tensor-core kernels of attention_train_mma.cuh (bf16 mma.sync
//   products; the forward streams K and V in 32-key tiles with a running
//   max and takes p_d into P.V as hi + lo bf16 terms; the backward runs a
//   pass for D = sum_j dp p and a key-major pass), B3's kernels on this
//   layout's strides, at every S. The forward writes each row's max and 1/l
//   and, with dropout, the keep bits, which the backward reads.
// - fp32: attention_train.cuh, the products on the fp32 CUDA cores, one
//   block per (head, sample), the backward recomputing p and replaying the
//   Philox bits, and its key-blocked variant past one block's shared memory.
#include "attention_train.cuh"
#include "attention_train_mma.cuh"

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

// dtype: 0 = float32 (bf16 takes flat_attention_train_mma_fwd below; any other
// dtype returns cudaErrorInvalidValue). q/k/v/out: [B, S, H*hd] contiguous,
// bias: [B, S] float32 (additive, key side). keep_t: u8 keep threshold
// (256 = no dropout), rscale = 256/keep_t as float. blocked = 1: the
// key-blocked forward. Returns cudaGetLastError().
int flat_attention_train_fwd(int dtype, const void* q, const void* k, const void* v,
                             const void* bias, void* out, int B, int S, int H, int hd,
                             int keep_t, float rscale, unsigned long long seed,
                             void* stream, int blocked) {
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return (int)attn_train::fwd_hd<float>(hd, q, k, v, static_cast<const float*>(bias), out, B,
                                        S, H, flat(S, H, hd), keep_t, rscale, seed,
                                        static_cast<cudaStream_t>(stream), blocked);
}

// The same operands plus dout [B, S, H*hd]; writes dq, dk, dv and the
// per-head bias gradient dbias_heads [B, H, S] float32. dtype: 0 = float32
// (bf16 takes flat_attention_train_mma_bwd below; any other dtype returns
// cudaErrorInvalidValue). dq32: null, or a float32 [B, H, S, hd] buffer for
// the key-blocked backward.
int flat_attention_train_bwd(int dtype, const void* q, const void* k, const void* v,
                             const void* bias, const void* dout, void* dq, void* dk,
                             void* dv, void* dbias_heads, int B, int S, int H, int hd,
                             int keep_t, float rscale, unsigned long long seed,
                             void* stream, void* dq32) {
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return (int)attn_train::bwd_hd<float>(
      hd, q, k, v, static_cast<const float*>(bias), dout, dq, dk, dv,
      static_cast<float*>(dbias_heads), B, S, H, flat(S, H, hd), keep_t, rscale, seed,
      static_cast<cudaStream_t>(stream), static_cast<float*>(dq32));
}

// The bf16 tensor-core kernels (attention_train_mma.cuh). Shared memory
// (bytes) of one block of the forward (backward = 0) or the backward
// (backward = 1) at this S and head dim: the layout does not enter it.
long long flat_attention_train_mma_smem_bytes(int S, int hd, int backward) {
  return attn_train_mma::smem_bytes(S, hd, backward);
}

// 1 where the bf16 backward at (S, hd) needs its float32 [B, H, S, hd] dq
// buffer (dq32 below), else 0.
int flat_attention_train_mma_needs_dq32(int S, int hd) {
  return attn_train_mma::needs_dq32(S, hd);
}

// bf16 q/k/v/out: [B, S, H*hd] contiguous, 16-byte aligned; bias, keep_t,
// rscale and seed as flat_attention_train_fwd. Also writes, where given,
// what the backward reads: stats, float32 [B, H, S, 2], and with dropout
// keep_words, uint16 [B, H, S, ceil(S/16)]. Returns cudaGetLastError().
int flat_attention_train_mma_fwd(const void* q, const void* k, const void* v, const void* bias,
                                 void* out, void* stats, void* keep_words, int B, int S, int H,
                                 int hd, int keep_t, float rscale, unsigned long long seed,
                                 void* stream) {
  return attn_train_mma::forward(q, k, v, bias, out, stats, keep_words, B, S, H, hd,
                                 flat(S, H, hd), keep_t, rscale, seed, stream);
}

// The same operands plus bf16 dout [B, S, H*hd] (16-byte aligned) and the
// forward's stats and keep_words; writes bf16 dq, dk, dv [B, S, H*hd] and
// the float32 per-head bias gradient dbias_heads [B, H, S]. dq32: a float32
// [B, H, S, hd] buffer where needs_dq32 says so (its contents on entry do
// not matter), else null.
int flat_attention_train_mma_bwd(const void* q, const void* k, const void* v, const void* bias,
                                 const void* dout, const void* stats, const void* keep_words,
                                 void* dq, void* dk, void* dv, void* dbias_heads, int B, int S,
                                 int H, int hd, int keep_t, float rscale, void* stream,
                                 void* dq32) {
  return attn_train_mma::backward(q, k, v, bias, dout, stats, keep_words, dq, dk, dv,
                                  dbias_heads, dq32, B, S, H, hd, flat(S, H, hd), keep_t,
                                  rscale, stream);
}

}  // extern "C"
