// Multi-tensor passes of the train step for Hopper (sm_90a): the gradient
// accumulation, the global norm's sums of squares and the clipped AdamW
// update, each over every parameter tensor in one launch.
//
// Replaces no TPU kernel: the JAX package's train step leaves these loops to
// XLA, which fuses them into a few passes. Eagerly, PyTorch runs them as
// ~30 kernels a parameter tensor (~6,000 a UC2 step), each a full pass over
// its tensor, launched one by one from the host.
//
// What bounds it on the H100: bytes. Over UC2's 281.6 M fp32 parameters a
// step needs, at least, a microbatch's gradient read and the buffer written
// (and read again after the first microbatch), one read of the gradients
// for the norm, and for the update reads of g, p, m and v and writes of p,
// m and v: ~14.6 GB at acc 2, 4.4 ms at 3.35 TB/s. There is no arithmetic to
// speak of.
//
// Design: the parameter list is cut into chunks of kChunk elements, each
// chunk within one tensor; ops/multi_tensor.py builds the table of chunks
// (tensor, offset) once per parameter list and keeps it on the device with
// the tensors' pointers. One block walks one chunk in 16-byte vectors when
// every pointer it touches is 16-byte aligned, else element by element. The
// accumulation's destinations (one flat buffer's views) are in the table;
// its sources, autograd's fresh gradients, are kernel arguments. The norm
// writes one fp64 partial per chunk, then one block sums each tensor's
// partials in a fixed order into that tensor's fp32 sum of squares, then one
// thread adds those in tensor order and takes the root: no atomics, so the
// norm is the same bits on every run. Every rounding of the eager PyTorch
// ops these passes replace is kept: each step is a separate _rn intrinsic,
// so nothing contracts into an FMA.
#include <cuda_runtime.h>
#include <stdint.h>

// a named namespace, so traces name the kernels multi_tensor::*
namespace multi_tensor {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr long long kChunk = 1 << 16;  // ops/multi_tensor.CHUNK
constexpr int kMaxSources = 400;       // ops/multi_tensor.MAX_SOURCES
constexpr int kSumThreads = 1024;
constexpr int kNormThreads = 256;

// autograd's gradients for one launch of the accumulation (kernel
// arguments: 3.2 KB, under the 4 KB every CUDA version takes)
struct Sources {
  const float* p[kMaxSources];
};

struct AdamW {
  float b1, one_minus_b1, b2, one_minus_b2, step, eps, decay, max_norm;
};

struct Chunk {
  int tensor;
  long long offset;
  int len;
};

__device__ __forceinline__ Chunk chunk_at(const long long* chunks, const long long* numel,
                                          long long c) {
  Chunk k;
  k.tensor = (int)chunks[2 * c];
  k.offset = chunks[2 * c + 1];
  const long long rest = numel[k.tensor] - k.offset;
  k.len = (int)(rest < kChunk ? rest : kChunk);
  return k;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// acc = (first ? 0 : acc) + g * inv_n, as acc.add_(g / n) after a zero fill:
// PyTorch's CUDA division by a host scalar multiplies by its fp32 reciprocal
__device__ __forceinline__ float accumulate1(float acc, float g, float inv_n) {
  return __fadd_rn(acc, __fmul_rn(g, inv_n));
}

__global__ void __launch_bounds__(kThreads)
accumulate_kernel(const long long* __restrict__ chunks, const long long* __restrict__ numel,
                  const long long* __restrict__ dst_ptrs, Sources src, int t0, long long c0,
                  int first, float inv_n) {
  const Chunk k = chunk_at(chunks, numel, c0 + blockIdx.x);
  const float* __restrict__ s = src.p[k.tensor - t0];
  if (s == nullptr && !first) return;  // an unused parameter adds nothing
  float* __restrict__ d = reinterpret_cast<float*>(dst_ptrs[k.tensor]) + k.offset;
  if (s != nullptr) s += k.offset;
  const bool vec = aligned16(d) && (s == nullptr || aligned16(s));
  const int nv = vec ? k.len / 4 : 0;
#pragma unroll 2
  for (int i = threadIdx.x; i < nv; i += kThreads) {
    float4 a = first ? make_float4(0.f, 0.f, 0.f, 0.f) : reinterpret_cast<const float4*>(d)[i];
    if (s != nullptr) {
      const float4 g = reinterpret_cast<const float4*>(s)[i];
      a.x = accumulate1(a.x, g.x, inv_n);
      a.y = accumulate1(a.y, g.y, inv_n);
      a.z = accumulate1(a.z, g.z, inv_n);
      a.w = accumulate1(a.w, g.w, inv_n);
    }
    reinterpret_cast<float4*>(d)[i] = a;
  }
  for (int i = nv * 4 + threadIdx.x; i < k.len; i += kThreads) {
    const float a = first ? 0.f : d[i];
    d[i] = s != nullptr ? accumulate1(a, s[i], inv_n) : a;
  }
}

__device__ __forceinline__ double warp_sum(double x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// partial[c] = sum over chunk c of x * x (x = g, or g * mask), each square
// rounded to fp32 as (t * t) rounds it, summed in fp64
__global__ void __launch_bounds__(kThreads)
sum_squares_kernel(const long long* __restrict__ chunks, const long long* __restrict__ numel,
                   const long long* __restrict__ g_ptrs, const long long* __restrict__ mask_ptrs,
                   double* __restrict__ partial) {
  const Chunk k = chunk_at(chunks, numel, blockIdx.x);
  const float* g = reinterpret_cast<const float*>(g_ptrs[k.tensor]) + k.offset;
  const float* m = reinterpret_cast<const float*>(mask_ptrs[k.tensor]);
  if (m != nullptr) m += k.offset;
  const bool vec = aligned16(g) && (m == nullptr || aligned16(m));
  const int nv = vec ? k.len / 4 : 0;
  double acc = 0.0;
#pragma unroll 4
  for (int i = threadIdx.x; i < nv; i += kThreads) {
    float4 x = reinterpret_cast<const float4*>(g)[i];
    if (m != nullptr) {
      const float4 w = reinterpret_cast<const float4*>(m)[i];
      x.x = __fmul_rn(x.x, w.x);
      x.y = __fmul_rn(x.y, w.y);
      x.z = __fmul_rn(x.z, w.z);
      x.w = __fmul_rn(x.w, w.w);
    }
    acc += (double)__fmul_rn(x.x, x.x) + (double)__fmul_rn(x.y, x.y) +
           (double)__fmul_rn(x.z, x.z) + (double)__fmul_rn(x.w, x.w);
  }
  for (int i = nv * 4 + threadIdx.x; i < k.len; i += kThreads) {
    const float x = m != nullptr ? __fmul_rn(g[i], m[i]) : g[i];
    acc += (double)__fmul_rn(x, x);
  }
  __shared__ double warp_part[kWarps];
  acc = warp_sum(acc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_part[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = warp_sum(lane < kWarps ? warp_part[lane] : 0.0);
    if (lane == 0) partial[blockIdx.x] = acc;
  }
}

// sq[t] = the sum of tensor t's chunk partials: one warp a tensor, each lane
// a fixed stride of the chunks, then a fixed butterfly
__global__ void __launch_bounds__(kSumThreads)
tensor_sums_kernel(const double* __restrict__ partial, const long long* __restrict__ first_chunk,
                   int n, float* __restrict__ sq) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = warp; t < n; t += kSumThreads / 32) {
    double acc = 0.0;
#pragma unroll 4
    for (long long c = first_chunk[t] + lane; c < first_chunk[t + 1]; c += 32) acc += partial[c];
    acc = warp_sum(acc);
    if (lane == 0) sq[t] = (float)acc;
  }
}

// out = sqrt(0 + sq[0] + sq[1] + ...), in tensor order: optim.global_norm's
// torch.sqrt(sum(sq)). The block stages sq through shared memory; one
// thread adds.
__global__ void __launch_bounds__(kNormThreads)
norm_kernel(const float* __restrict__ sq, int n, float* __restrict__ out) {
  constexpr int kStage = 4 * kNormThreads;
  __shared__ float stage[kStage];
  float s = 0.f;
  for (int base = 0; base < n; base += kStage) {
    const int m = n - base < kStage ? n - base : kStage;
    for (int i = threadIdx.x; i < m; i += kNormThreads) stage[i] = sq[base + i];
    __syncthreads();
    if (threadIdx.x == 0)
      for (int i = 0; i < m; ++i) s = __fadd_rn(s, stage[i]);
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = __fsqrt_rn(s);
}

// one element of train/optim.py's chain, each op rounded as the eager op:
// the mask, clip_by_global_norm's where, _moments, adamw_pt's update and
// decay, the update u = new_p - p, masked again, and p.add_(u)
__device__ __forceinline__ void adamw1(float& p, float& m, float& v, float g, float w,
                                       bool masked, bool keep, float norm, bool decays,
                                       const AdamW& a) {
  if (masked) g = __fmul_rn(g, w);
  if (!keep) g = __fmul_rn(__fdiv_rn(g, norm), a.max_norm);
  m = __fadd_rn(__fmul_rn(m, a.b1), __fmul_rn(a.one_minus_b1, g));
  v = __fadd_rn(__fmul_rn(v, a.b2), __fmul_rn(__fmul_rn(a.one_minus_b2, g), g));
  float np = __fsub_rn(p, __fdiv_rn(__fmul_rn(m, a.step), __fadd_rn(__fsqrt_rn(v), a.eps)));
  if (decays) np = __fsub_rn(np, __fmul_rn(np, a.decay));
  float u = __fsub_rn(np, p);
  if (masked) u = __fmul_rn(u, w);
  p = __fadd_rn(p, u);
}

// ptrs: [6, n] (p, m, v, g, mask, decay flag; a null mask passes through)
__global__ void __launch_bounds__(kThreads)
adamw_kernel(const long long* __restrict__ chunks, const long long* __restrict__ numel,
             const long long* __restrict__ ptrs, int n, const float* __restrict__ norm_ptr,
             AdamW a) {
  const Chunk k = chunk_at(chunks, numel, blockIdx.x);
  const int t = k.tensor;
  // five distinct tensors: nothing aliases
  float* __restrict__ p = reinterpret_cast<float*>(ptrs[t]) + k.offset;
  float* __restrict__ m = reinterpret_cast<float*>(ptrs[n + t]) + k.offset;
  float* __restrict__ v = reinterpret_cast<float*>(ptrs[2 * n + t]) + k.offset;
  const float* __restrict__ g = reinterpret_cast<const float*>(ptrs[3 * n + t]) + k.offset;
  const float* __restrict__ w = reinterpret_cast<const float*>(ptrs[4 * n + t]);
  const bool masked = w != nullptr;
  if (masked) w += k.offset;
  const float norm = *norm_ptr;
  const bool keep = norm < a.max_norm;
  const bool dec = ptrs[5 * n + t] != 0;
  const bool vec = aligned16(p) && aligned16(m) && aligned16(v) && aligned16(g) &&
                   (!masked || aligned16(w));
  const int nv = vec ? k.len / 4 : 0;
#pragma unroll 2
  for (int i = threadIdx.x; i < nv; i += kThreads) {
    float4 pp = reinterpret_cast<const float4*>(p)[i];
    float4 mm = reinterpret_cast<const float4*>(m)[i];
    float4 vv = reinterpret_cast<const float4*>(v)[i];
    const float4 gg = reinterpret_cast<const float4*>(g)[i];
    const float4 ww = masked ? reinterpret_cast<const float4*>(w)[i] : make_float4(1.f, 1.f, 1.f, 1.f);
    adamw1(pp.x, mm.x, vv.x, gg.x, ww.x, masked, keep, norm, dec, a);
    adamw1(pp.y, mm.y, vv.y, gg.y, ww.y, masked, keep, norm, dec, a);
    adamw1(pp.z, mm.z, vv.z, gg.z, ww.z, masked, keep, norm, dec, a);
    adamw1(pp.w, mm.w, vv.w, gg.w, ww.w, masked, keep, norm, dec, a);
    reinterpret_cast<float4*>(p)[i] = pp;
    reinterpret_cast<float4*>(m)[i] = mm;
    reinterpret_cast<float4*>(v)[i] = vv;
  }
  for (int i = nv * 4 + threadIdx.x; i < k.len; i += kThreads) {
    float pp = p[i], mm = m[i], vv = v[i];
    adamw1(pp, mm, vv, g[i], masked ? w[i] : 1.f, masked, keep, norm, dec, a);
    p[i] = pp;
    m[i] = mm;
    v[i] = vv;
  }
}

}  // namespace multi_tensor

using namespace multi_tensor;

extern "C" {

// Every table pointer is a device pointer to ops/multi_tensor.py's layout:
// chunks [n_chunks, 2] int64 (tensor, offset), numel [n] int64, first_chunk
// [n + 1] int64, pointer rows [roles, n] int64 (0 for none). Each entry
// returns cudaGetLastError() after its launches.

// dst[t] = (first ? 0 : dst[t]) + src[t] * inv_n for the tensors t0 ..
// t0 + n_src - 1, whose chunks are c0 .. c0 + n_chunks - 1; srcs is a host
// array of n_src device pointers (null: no gradient).
int mt_accumulate(const void* chunks, const void* numel, const void* dst_ptrs,
                  const void* const* srcs, int t0, int n_src, long long c0, int n_chunks,
                  int first, float inv_n, void* stream) {
  if (n_src > kMaxSources) return (int)cudaErrorInvalidValue;
  if (n_chunks == 0) return (int)cudaSuccess;
  Sources s;
  for (int i = 0; i < kMaxSources; ++i) s.p[i] = i < n_src ? static_cast<const float*>(srcs[i]) : nullptr;
  accumulate_kernel<<<n_chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(chunks), static_cast<const long long*>(numel),
      static_cast<const long long*>(dst_ptrs), s, t0, c0, first, inv_n);
  return (int)cudaGetLastError();
}

// sq[t] = the sum of squares of tensor t (times its mask); partial is
// [n_chunks] fp64 scratch. Two launches.
int mt_sum_squares(const void* chunks, const void* numel, const void* first_chunk,
                   const void* g_ptrs, const void* mask_ptrs, int n, int n_chunks, void* partial,
                   void* sq, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_chunks > 0)
    sum_squares_kernel<<<n_chunks, kThreads, 0, st>>>(
        static_cast<const long long*>(chunks), static_cast<const long long*>(numel),
        static_cast<const long long*>(g_ptrs), static_cast<const long long*>(mask_ptrs),
        static_cast<double*>(partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tensor_sums_kernel<<<1, kSumThreads, 0, st>>>(static_cast<const double*>(partial),
                                                static_cast<const long long*>(first_chunk), n,
                                                static_cast<float*>(sq));
  return (int)cudaGetLastError();
}

// out = sqrt of the sum of sq[0 .. n) in order. One launch.
int mt_norm(const void* sq, int n, void* out, void* stream) {
  norm_kernel<<<1, kNormThreads, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(sq), n,
                                                                static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// In place over every chunk: the mask, the clip against *norm, the moments,
// the AdamW step with decoupled decay where ptrs' sixth row is not 0, and
// p += the masked update. One launch.
int mt_adamw(const void* chunks, const void* numel, const void* ptrs, int n, int n_chunks, const void* norm, float b1, float one_minus_b1, float b2,
             float one_minus_b2, float step, float eps, float decay, float max_norm,
             void* stream) {
  if (n_chunks == 0) return (int)cudaSuccess;
  const AdamW a{b1, one_minus_b1, b2, one_minus_b2, step, eps, decay, max_norm};
  adamw_kernel<<<n_chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(chunks), static_cast<const long long*>(numel),
      static_cast<const long long*>(ptrs), n, static_cast<const float*>(norm), a);
  return (int)cudaGetLastError();
}

}  // extern "C"
