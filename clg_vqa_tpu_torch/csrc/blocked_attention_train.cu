// Head-blocked training attention for Hopper (sm_90a): forward and backward
// (B3).
//
// Replaces the TPU kernels clg_vqa_tpu/ops/attention.py:_train_fwd_kernel
// and _train_bwd_kernel as launched by _attn_train_fwd/_bwd (entries
// fused_attention_train, which splits [B, S, H*hd] into heads first, and
// fused_attention_train_hm, which takes them pre-split). The operands are
// head-major and row-major, [B, H, S, hd]: sample b, head h, row s start at
// ((b*H + h)*S + s)*hd. The bias is float32 [B, S] and the per-head bias
// gradient float32 [B, H, S]; the caller sums it over heads 0..H-1 in a
// fixed order, where the TPU kernel accumulates it across its head grid
// axis.
//
// In fp32 the math is B1's (flat_attention_train.cu): both files instantiate
// the per-(head, sample) device code of attention_train.cuh, here with row
// stride hd, head stride S*hd and sample stride H*S*hd. Dropout is keyed by
// (seed, absolute sample, head, query row, key column // 16), not per grid
// cell as the TPU kernel seeds it (seed + program_id(0)*16384 +
// program_id(1), whose mask moves with the batch tile and so with the batch
// size), so on the same values and seed fp32 B3 and B1 give the same bits,
// forward and backward, and in bf16 the same keep mask. S is any length,
// bounded by loop limits: the TPU entry's padding of S to a multiple of 8
// with -1e9 keys adds exact zeros in fp32 and is not needed here.
//
// What bounds it on the H100: at M3P training (B=128, S=140, H*hd=768,
// bf16) the forward moves ~110 MB and does ~7.7 GFLOP, the backward ~193 MB
// and ~19.3 GFLOP: 0.033 ms and 0.058 ms by bytes. The fp32 kernels run
// these products on the CUDA cores (0.115 ms and 0.288 ms by operations at
// their peak). Design: B1's, one block per (head, sample).
//
// bf16, the training path's type, takes the tensor-core kernels of
// attention_train_mma.cuh on the head-major layout at every S (bf16
// mma.sync products, K, V or Q, dO streamed in tiles; in the backward a
// pass for D and a key-major pass); their bound is the bytes above. fp32
// keeps attention_train.cuh's kernels, bit for bit B1's, and is the only
// type those entries take here.
#include "attention_train.cuh"
#include "attention_train_mma.cuh"

namespace {

attn_train::Layout head_major(int S, int H, int hd) {
  const long long SD = (long long)S * hd;
  return {hd, H * SD, SD};
}

}  // namespace

extern "C" {

// Shared memory (bytes) one block of the forward (backward = 0) or the
// backward (backward = 1) needs at this S and head dim, all-keys (blocked =
// 0) or key-blocked (blocked = 1).
long long blocked_attention_train_smem_bytes(int S, int hd, int backward, int blocked) {
  return attn_train::smem_bytes(S, hd, backward, blocked);
}

// dtype: 0 = float32 (bf16 takes the blocked_attention_train_mma_* entries
// below; any other dtype returns cudaErrorInvalidValue). q/k/v/out:
// [B, H, S, hd] contiguous, bias: [B, S] float32 (additive, key side).
// keep_t: u8 keep threshold (256 = no dropout), rscale = 256/keep_t as
// float. blocked = 1: the key-blocked forward. Returns cudaGetLastError().
int blocked_attention_train_fwd(int dtype, const void* q, const void* k, const void* v,
                                const void* bias, void* out, int B, int S, int H, int hd,
                                int keep_t, float rscale, unsigned long long seed,
                                void* stream, int blocked) {
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return (int)attn_train::fwd_hd<float>(hd, q, k, v, static_cast<const float*>(bias), out, B,
                                        S, H, head_major(S, H, hd), keep_t, rscale, seed,
                                        static_cast<cudaStream_t>(stream), blocked);
}

// The same operands plus dout [B, H, S, hd]; writes dq, dk, dv [B, H, S, hd]
// and the per-head bias gradient dbias_heads [B, H, S]. dq32: null, or a
// float32 [B, H, S, hd] buffer for the key-blocked backward.
int blocked_attention_train_bwd(int dtype, const void* q, const void* k, const void* v,
                                const void* bias, const void* dout, void* dq, void* dk,
                                void* dv, void* dbias_heads, int B, int S, int H, int hd,
                                int keep_t, float rscale, unsigned long long seed,
                                void* stream, void* dq32) {
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return (int)attn_train::bwd_hd<float>(
      hd, q, k, v, static_cast<const float*>(bias), dout, dq, dk, dv,
      static_cast<float*>(dbias_heads), B, S, H, head_major(S, H, hd), keep_t, rscale, seed,
      static_cast<cudaStream_t>(stream), static_cast<float*>(dq32));
}

// The bf16 tensor-core kernels (attention_train_mma.cuh). Shared memory
// (bytes) of one block of the forward (backward = 0) or the backward
// (backward = 1) at this S and head dim.
long long blocked_attention_train_mma_smem_bytes(int S, int hd, int backward) {
  return attn_train_mma::smem_bytes(S, hd, backward);
}

// 1 where the bf16 backward at (S, hd) needs its float32 [B, H, S, hd] dq
// buffer (dq32 below), else 0.
int blocked_attention_train_mma_needs_dq32(int S, int hd) {
  return attn_train_mma::needs_dq32(S, hd);
}

// bf16 q/k/v/out: [B, H, S, hd] contiguous, 16-byte aligned; bias, keep_t,
// rscale and seed as blocked_attention_train_fwd. Also writes, where given,
// what the backward reads: stats, float32 [B, H, S, 2], and with dropout
// keep_words, uint16 [B, H, S, ceil(S/16)]. Returns cudaGetLastError().
int blocked_attention_train_mma_fwd(const void* q, const void* k, const void* v,
                                    const void* bias, void* out, void* stats, void* keep_words,
                                    int B, int S, int H, int hd, int keep_t, float rscale,
                                    unsigned long long seed, void* stream) {
  return attn_train_mma::forward(q, k, v, bias, out, stats, keep_words, B, S, H, hd,
                                 head_major(S, H, hd), keep_t, rscale, seed, stream);
}

// The same operands plus bf16 dout and the forward's stats and keep_words;
// writes bf16 dq, dk, dv and the float32 per-head bias gradient dbias_heads
// [B, H, S]. dq32: a float32 [B, H, S, hd] buffer where needs_dq32 says so
// (its contents on entry do not matter), else null.
int blocked_attention_train_mma_bwd(const void* q, const void* k, const void* v,
                                    const void* bias, const void* dout, const void* stats,
                                    const void* keep_words, void* dq, void* dk, void* dv,
                                    void* dbias_heads, int B, int S, int H, int hd, int keep_t,
                                    float rscale, void* stream, void* dq32) {
  return attn_train_mma::backward(q, k, v, bias, dout, stats, keep_words, dq, dk, dv,
                                  dbias_heads, dq32, B, S, H, hd, head_major(S, H, hd), keep_t,
                                  rscale, stream);
}

}  // extern "C"
