// RoIPool for Hopper (sm_90a), forward only (B6).
//
// Replaces the TPU kernel clg_vqa_tpu/ops/roi_pallas.py:_kernel as launched
// by roi_pool_pallas (the C4 extractor's pooler): quantized max pooling of
// NHWC features [H, W, C] over rois [R, 4] (xyxy, image coordinates) into
// [R, PH, PW, C] in the features' dtype. Roi corners are rint(roi * scale)
// in f32 (round half to even, as jnp.round); roi_h = max(y2 - y1 + 1, 1);
// bin p spans rows (p*roi_h)/PH + y1 .. ((p+1)*roi_h + PH - 1)/PH + y1 (exact
// integer division of non-negative numerators), clipped to [0, H], cut to at
// most max_bin rows from its start; columns alike. The max is taken in f32;
// an empty bin (or one whose max is not finite) gives 0, as ops/roi.py does.
//
// What bounds it on the H100: at the C4 extractor's shapes (features
// [50, 84, 1024] bf16, 300 rois, 14 x 14 bins) the call reads an 8.6 MB map
// and writes 120.4 MB: 0.039 ms at 3.35 TB/s. It does no arithmetic beyond
// the max, so it is bound by bytes, mostly the output's.
//
// Design: one block per (roi, output row); the block computes its bin
// bounds from the roi itself (no host-side boundary arrays, where the TPU
// kernel took them by scalar prefetch), walks the row's PW bins, and its
// threads cover the channels in 16-byte vectors (8 bf16 or 4 fp32), so a
// warp reads 512 contiguous bytes of one feature-map position at a time.
// The map stays in L2 (50 MB) across the rois that overlap it; the output is
// written once, in full vectors. The TPU kernel's aligned fixed-size window
// (and its small-map fallback) exist for VMEM and Mosaic and have no
// counterpart: every map size is taken.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float (&f)[N]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  __device__ static void store(float* p, const float (&f)[N]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&f)[N]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float (&f)[N]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

// Bounds [s, e) of bin p of P over a roi of extent roi starting at origin,
// clipped to [0, lim] and cut to max_bin from s.
__device__ __forceinline__ void bin_bounds(int p, int roi, int P, int origin, int lim,
                                           int max_bin, int& s, int& e) {
  s = min(max((p * roi) / P + origin, 0), lim);
  e = min(max(((p + 1) * roi + P - 1) / P + origin, 0), lim);
  e = min(e, s + max_bin);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_pool_kernel(const T* __restrict__ feat, const float* __restrict__ rois,
                T* __restrict__ out, int H, int W, int C, int PH, int PW, float scale,
                int max_bin) {
  using V = Vec<T>;
  const int r = blockIdx.x, ph = blockIdx.y;
  const float* ro = rois + 4LL * r;
  const int x1 = (int)rintf(ro[0] * scale), y1 = (int)rintf(ro[1] * scale);
  const int x2 = (int)rintf(ro[2] * scale), y2 = (int)rintf(ro[3] * scale);
  const int roi_h = max(y2 - y1 + 1, 1), roi_w = max(x2 - x1 + 1, 1);
  int hs, he;
  bin_bounds(ph, roi_h, PH, y1, H, max_bin, hs, he);
  const int nvec = C / V::N;
  for (int pw = 0; pw < PW; ++pw) {
    int ws, we;
    bin_bounds(pw, roi_w, PW, x1, W, max_bin, ws, we);
    T* o = out + (((long long)r * PH + ph) * PW + pw) * C;
    for (int cv = threadIdx.x; cv < nvec; cv += kThreads) {
      float m[V::N];
#pragma unroll
      for (int i = 0; i < V::N; ++i) m[i] = -INFINITY;
      for (int y = hs; y < he; ++y)
        for (int x = ws; x < we; ++x) {
          float f[V::N];
          V::load(feat + ((long long)y * W + x) * C + cv * V::N, f);
#pragma unroll
          for (int i = 0; i < V::N; ++i) m[i] = fmaxf(m[i], f[i]);
        }
#pragma unroll
      for (int i = 0; i < V::N; ++i) m[i] = isfinite(m[i]) ? m[i] : 0.f;
      V::store(o + cv * V::N, m);
    }
  }
}

template <typename T>
cudaError_t launch(const void* feat, const float* rois, void* out, int H, int W, int C,
                   int R, int PH, int PW, float scale, int max_bin, cudaStream_t st) {
  if (C % Vec<T>::N) return cudaErrorInvalidValue;
  roi_pool_kernel<T><<<dim3(R, PH), kThreads, 0, st>>>(
      static_cast<const T*>(feat), rois, static_cast<T*>(out), H, W, C, PH, PW, scale,
      max_bin);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. feat: [H, W, C] contiguous, C a multiple
// of 4 (fp32) or 8 (bf16), 16-byte aligned; rois: [R, 4] float32 xyxy in
// image coordinates; out: [R, PH, PW, C] in feat's dtype. Returns
// cudaGetLastError().
int roi_pool_fwd(int dtype, const void* feat, const void* rois, void* out, int H, int W,
                 int C, int R, int PH, int PW, float scale, int max_bin, void* stream) {
  if (R == 0 || PH == 0 || PW == 0 || C == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* rf = static_cast<const float*>(rois);
  if (dtype == 0) return (int)launch<float>(feat, rf, out, H, W, C, R, PH, PW, scale, max_bin, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(feat, rf, out, H, W, C, R, PH, PW, scale, max_bin, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
