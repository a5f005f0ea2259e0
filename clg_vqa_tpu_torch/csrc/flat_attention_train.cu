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
// - bf16 forward: the tensor-core forward of attention_train_mma.cuh (bf16
//   mma.sync products, K and V streamed in 32-key tiles, a running max, p_d
//   into P.V as hi + lo bf16 terms), B3's forward on this layout's strides,
//   at every S; it writes no row statistics or keep bits, since the backward
//   below recomputes p and replays the Philox bits.
// - fp32 forward and both backwards: attention_train.cuh, the products on
//   the fp32 CUDA cores, one block per (head, sample), and its key-blocked
//   variant past one block's shared memory.
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

// bf16 q/k/v/out: [B, S, H*hd] contiguous, 16-byte aligned; bias, keep_t,
// rscale and seed as flat_attention_train_fwd. stats and keep_words as
// blocked_attention_train_mma_fwd's, written where not null (B1's backward
// reads neither). Returns cudaGetLastError().
int flat_attention_train_mma_fwd(const void* q, const void* k, const void* v, const void* bias,
                                 void* out, void* stats, void* keep_words, int B, int S, int H,
                                 int hd, int keep_t, float rscale, unsigned long long seed,
                                 void* stream) {
  return attn_train_mma::forward(q, k, v, bias, out, stats, keep_words, B, S, H, hd,
                                 flat(S, H, hd), keep_t, rscale, seed, stream);
}

}  // extern "C"
