// Head-blocked eval attention for Hopper (sm_90a), forward only (B2).
//
// Replaces the TPU kernel clg_vqa_tpu/ops/attention.py:_attn_kernel as
// launched by fused_attention: q, k, v and the output are head-major,
// [B, H, S, hd] contiguous. For each (b, h): scores = (q k^T) * (1/sqrt(hd))
// + bias in fp32, a max-subtracted fp32 softmax, then P.V with an fp32
// accumulator, cast to q's dtype (fp32 or bf16). The TPU entry pads S to a
// multiple of 8 with -1e9 keys; a padded key's exp underflows to exactly 0
// in fp32, so the kernel takes any S by loop limits instead.
//
// It is the head-major instantiation of the forward in attention_train.cuh
// at keep_t = 256 (no dropout), the same device code as B3's forward, in a
// library of its own so that its launches are counted apart. Above S = 411
// at hd 64 it takes that header's key-blocked forward.
//
// What bounds it on the H100: at M3P eval (B=1024, S=140, H*hd=768, bf16)
// the call moves ~881 MB (0.263 ms at 3.35 TB/s) and does ~61.7 GFLOP, which
// on the fp32 CUDA cores this design uses takes 0.92 ms: bound by
// operations; tensor cores would make it memory-bound and are left for a
// later change. Design: one block per (head, sample), as B1's forward.
#include "attention_train.cuh"

extern "C" {

// Shared memory (bytes) one block needs at this S and head dim, all-keys
// (blocked = 0) or key-blocked (blocked = 1).
long long blocked_attention_smem_bytes(int S, int hd, int blocked) {
  return attn_train::smem_bytes(S, hd, 0, blocked);
}

// dtype: 0 = float32, 1 = bfloat16. q/k/v/out: [B, H, S, hd] contiguous,
// bias: [B, S] float32 (additive, key side). blocked = 1: the key-blocked
// forward. Returns cudaGetLastError().
int blocked_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                          const void* bias, void* out, int B, int S, int H, int hd,
                          void* stream, int blocked) {
  const long long SD = (long long)S * hd;
  const attn_train::Layout head_major{hd, H * SD, SD};
  return attn_train::forward(dtype, q, k, v, bias, out, B, S, H, hd, head_major, 256, 1.0f,
                             0ULL, stream, blocked);
}

}  // extern "C"
