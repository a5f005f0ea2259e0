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
// bf16, the eval path's type, takes the tensor-core kernel of
// attention_eval.cuh on the head-major layout at every S, the same device
// code as K1's bf16 kernel, in a library of its own so that its launches are
// counted apart. At M3P eval (B=1024, S=140, H*hd=768) the call moves
// ~881 MB (0.263 ms at 3.35 TB/s) against ~61.7 GFLOP: with its products on
// bf16 mma.sync its bound is those bytes; at S = 140 it stays further above
// that bound than K1 does at 76, held by its instruction stream, whose work
// per byte grows with S (design and limits in attention_eval.cuh).
// The entry's head split and merge copies (ops/attention.py) move as many
// bytes again outside the kernel.
//
// fp32, the exact mode of the full-width logit gates, takes the head-major
// instantiation of the forward in attention_train.cuh at keep_t = 256 (no
// dropout), the same device code as B3's forward, bound by its shared-memory
// loads; above S = 411 at hd 64 that header's key-blocked forward.
#include "attention_eval.cuh"
#include "attention_train.cuh"

extern "C" {

// Shared memory (bytes) one block of the fp32 kernels needs at this S and
// head dim, all-keys (blocked = 0) or key-blocked (blocked = 1).
long long blocked_attention_smem_bytes(int S, int hd, int blocked) {
  return attn_train::smem_bytes(S, hd, 0, blocked);
}

// dtype: 0 = float32, 1 = bfloat16. q/k/v/out: [B, H, S, hd] contiguous,
// bias: [B, S] float32 (additive, key side); B, S >= 1. bf16 takes the
// tensor-core kernel at every S (blocked must be 0); fp32 the all-keys
// forward, or with blocked = 1 the key-blocked one. Returns
// cudaGetLastError().
int blocked_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                          const void* bias, void* out, int B, int S, int H, int hd,
                          void* stream, int blocked) {
  const long long SD = (long long)S * hd;
  const attn_train::Layout head_major{hd, H * SD, SD};
  if (dtype == 1)
    return blocked ? (int)cudaErrorInvalidValue
                   : attn_eval::forward(q, k, v, bias, out, B, S, H, hd, head_major, stream);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return (int)attn_train::fwd_hd<float>(hd, q, k, v, static_cast<const float*>(bias), out, B,
                                        S, H, head_major, 256, 1.0f, 0ULL,
                                        static_cast<cudaStream_t>(stream), blocked);
}

}  // extern "C"
