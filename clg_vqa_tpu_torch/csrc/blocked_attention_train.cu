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
// The math is B1's (flat_attention_train.cu): both files instantiate the
// per-(head, sample) device code of attention_train.cuh, here with row
// stride hd, head stride S*hd and sample stride H*S*hd. Dropout is keyed by
// (seed, absolute sample, head, query row, key column // 16), not per grid
// cell as the TPU kernel seeds it (seed + program_id(0)*16384 +
// program_id(1), whose mask moves with the batch tile and so with the batch
// size), so on the same values and seed B3 and B1 give the same bits,
// forward and backward. S is any length, bounded by loop limits: the TPU
// entry's padding of S to a multiple of 8 with -1e9 keys adds exact zeros
// in fp32 and is not needed here.
//
// What bounds it on the H100: at M3P training (B=128, S=140, H*hd=768,
// bf16) the forward moves ~110 MB and does ~7.7 GFLOP, the backward ~193 MB
// and ~19.3 GFLOP; on the fp32 CUDA cores these products use that is
// 0.115 ms and 0.288 ms by operations against 0.033 ms and 0.058 ms by
// bytes. Design: B1's, one block per (head, sample).
#include "attention_train.cuh"

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

// dtype: 0 = float32, 1 = bfloat16. q/k/v/out: [B, H, S, hd] contiguous,
// bias: [B, S] float32 (additive, key side). keep_t: u8 keep threshold
// (256 = no dropout), rscale = 256/keep_t as float. blocked = 1: the
// key-blocked forward. Returns cudaGetLastError().
int blocked_attention_train_fwd(int dtype, const void* q, const void* k, const void* v,
                                const void* bias, void* out, int B, int S, int H, int hd,
                                int keep_t, float rscale, unsigned long long seed,
                                void* stream, int blocked) {
  return attn_train::forward(dtype, q, k, v, bias, out, B, S, H, hd, head_major(S, H, hd),
                             keep_t, rscale, seed, stream, blocked);
}

// The same operands plus dout [B, H, S, hd]; writes dq, dk, dv [B, H, S, hd]
// (operand dtype) and the per-head bias gradient dbias_heads [B, H, S].
// dq32: null, or a float32 [B, H, S, hd] buffer for the key-blocked backward.
int blocked_attention_train_bwd(int dtype, const void* q, const void* k, const void* v,
                                const void* bias, const void* dout, void* dq, void* dk,
                                void* dv, void* dbias_heads, int B, int S, int H, int hd,
                                int keep_t, float rscale, unsigned long long seed,
                                void* stream, void* dq32) {
  return attn_train::backward(dtype, q, k, v, bias, dout, dq, dk, dv, dbias_heads, B, S, H,
                              hd, head_major(S, H, hd), keep_t, rscale, seed, stream, 0, dq32);
}

}  // extern "C"
