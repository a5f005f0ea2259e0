// Flat-boundary eval attention for Hopper (sm_90a).
//
// Replaces the TPU kernel clg_vqa_tpu/ops/attention.py:_flat_fwd_kernel as
// launched by fused_attention_flat (keep_t=256, no dropout): q, k, v and the
// output stay in the projections' [B, S, H*hd] layout, head h at column
// offset h*hd, so no head split/merge transposes exist outside the kernel.
// For each (b, h): scores = (q k^T) * (1/sqrt(hd)) + bias in fp32, a
// max-subtracted fp32 softmax, then P.V with an fp32 accumulator, cast to
// q's dtype (fp32 or bf16).
//
// What bounds it on the H100: at UC2 eval (B=1024, S=76, H*hd=768, bf16)
// the call moves ~478 MB (0.14 ms at 3.35 TB/s) and does ~18.2 GFLOP. This
// first kernel runs the products on the fp32 CUDA cores (67 TFLOP/s peak),
// so it is bound by operations, not bytes; tensor cores (mma/wgmma) would
// make it memory-bound and are left for a later change.
//
// Design: one block per (head, batch). The block stages its head's K and V
// slices (S x hd) in shared memory as fp32, K rows padded to hd+1 floats so
// that lane j reading K[j][d] hits a distinct bank. Each warp then walks
// query rows: lanes own keys j = lane, lane+32, ... for the scores (q row
// held in registers), reduce max and sum with shuffles, and own output
// columns d = lane, lane+32, ... for P.V. S is a runtime value bounded by
// loop limits, not padding; hd is a template constant.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared-memory floats one block needs: K [S][HDIM+1], V [S][HDIM], bias [S],
// and per warp one q row [HDIM] and one probability row [S].
__host__ __device__ constexpr long long smem_floats(int S, int hdim) {
  return (long long)S * (hdim + 1) + (long long)S * hdim + S +
         (long long)kWarps * hdim + (long long)kWarps * S;
}

template <typename T, int HDIM>
__global__ void __launch_bounds__(kThreads)
flat_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ bias,
                      T* __restrict__ out, int S, int HD, float scale) {
  extern __shared__ float smem[];
  constexpr int KS = HDIM + 1;
  float* Ks = smem;
  float* Vs = Ks + S * KS;
  float* bs = Vs + S * HDIM;
  float* qs = bs + S;
  float* ps = qs + kWarps * HDIM;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const long long base = (long long)b * S * HD + (long long)h * HDIM;

  for (int i = threadIdx.x; i < S * HDIM; i += kThreads) {
    const int s = i / HDIM, d = i % HDIM;
    const long long g = base + (long long)s * HD + d;
    Ks[s * KS + d] = to_f32(k[g]);
    Vs[s * HDIM + d] = to_f32(v[g]);
  }
  for (int j = threadIdx.x; j < S; j += kThreads) bs[j] = bias[(long long)b * S + j];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* qw = qs + warp * HDIM;
  float* pw = ps + warp * S;
  for (int i = warp; i < S; i += kWarps) {
    const long long row = base + (long long)i * HD;
    for (int d = lane; d < HDIM; d += 32) qw[d] = to_f32(q[row + d]);
    __syncwarp();
    float qr[HDIM];
#pragma unroll
    for (int d = 0; d < HDIM; ++d) qr[d] = qw[d];

    float m = -INFINITY;
    for (int j = lane; j < S; j += 32) {
      const float* kr = Ks + j * KS;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < HDIM; ++d) acc = fmaf(qr[d], kr[d], acc);
      const float s = acc * scale + bs[j];
      pw[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(pw[j] - m);
      pw[j] = e;
      l += e;
    }
    l = warp_sum(l);
    for (int j = lane; j < S; j += 32) pw[j] = pw[j] / l;
    __syncwarp();

#pragma unroll
    for (int d0 = 0; d0 < HDIM; d0 += 32) {
      const int d = d0 + lane;
      float acc = 0.f;
      for (int j = 0; j < S; ++j) acc = fmaf(pw[j], Vs[j * HDIM + d], acc);
      store(out + row + d, acc);
    }
    __syncwarp();
  }
}

template <typename T, int HDIM>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias,
                   void* out, int B, int S, int H, cudaStream_t stream) {
  const size_t smem = smem_floats(S, HDIM) * sizeof(float);
  auto kern = flat_attention_kernel<T, HDIM>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      bias, static_cast<T*>(out), S, H * HDIM, (float)(1.0 / sqrt((double)HDIM)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, const float* bias,
                        void* out, int B, int S, int H, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, bias, out, B, S, H, stream);
    case 64: return launch<T, 64>(q, k, v, bias, out, B, S, H, stream);
    case 128: return launch<T, 128>(q, k, v, bias, out, B, S, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Shared memory (bytes) one block needs at this S and head dim.
long long flat_attention_smem_bytes(int S, int hd) {
  return smem_floats(S, hd) * (long long)sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16. q/k/v/out: [B, S, H*hd] contiguous,
// bias: [B, S] float32 (additive, key side). Returns cudaGetLastError().
int flat_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                       const void* bias, void* out, int B, int S, int H, int hd,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(bias);
  cudaError_t e;
  if (dtype == 0) e = dispatch_hd<float>(q, k, v, bf, out, B, S, H, hd, st);
  else if (dtype == 1) e = dispatch_hd<__nv_bfloat16>(q, k, v, bf, out, B, S, H, hd, st);
  else e = cudaErrorInvalidValue;
  return (int)e;
}

}  // extern "C"
