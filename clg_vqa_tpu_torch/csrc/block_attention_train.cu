// Whole-block training attention for Hopper (sm_90a): forward and backward
// (B4, the "proj" route).
//
// Replaces the TPU kernels of clg_vqa_tpu/ops/attention.py:fused_attention_block
// (:958-973): _proj_fwd_kernel (:678, launched by _attn_block_fwd :880),
// _proj_bwda_kernel (:726) and _linear_bwd_kernel (:802, three calls), both
// launched by _attn_block_bwd (:919). One forward and one backward entry each
// run the whole block on the card:
//
//   forward   q|k|v = x Wq|Wk|Wv^T + b (fp32 accumulator, fp32 bias, one cast
//             to x's dtype; one launch for the three), the flat core with
//             dropout -> ctx in x's dtype, y = ctx Wo^T + bo (same epilogue).
//   backward  dctx = g Wo kept at fp32 precision; the core's backward on
//             that do -> dq, dk, dv in x's dtype and the bias gradient per
//             head, summed over heads in order h = 0..H-1; dW = dy^T in and
//             db = sum dy for the four weights (dy = dq, dk, dv with in = x;
//             dy = g with in = ctx), dW rounded once to the weights' dtype;
//             dx = (dxq + dxk) + dxv with each term dy W rounded to x's dtype
//             and the two sums taken in x's dtype, in that order (:940-945).
//
// Weights are in PyTorch's [out, in] layout; activations are [B*S, H*hd] rows.
// ctx is the forward's own output, kept by the caller for the backward: the
// TPU kernel recomputes it in VMEM, which gives the same bits.
//
// Two device codes:
// - bf16: the four projection products and their gradients on wgmma fed by
//   TMA (gemm_wgmma.cuh: 128 x 128 or 128 x 256 tiles, two consumer
//   warpgroups, a producer warp, an mbarrier ring), and the core on B1's tensor-core
//   kernels (attention_train_mma.cuh on the flat strides), so on the same
//   q, k, v ctx is B1's bf16 output bit for bit. The forward saves each
//   row's max and 1/l and the keep bits, and the backward reads them. dctx
//   leaves its product as two bf16 planes, hi = bf16(dctx) and
//   lo = bf16(dctx - hi) (4 bytes a value, as fp32), and the core's backward
//   takes its do as hi + lo: each product that reads do is issued for both
//   terms into one fp32 accumulator. One bf16 rounding of dctx moves the
//   bias gradient 21x past its 1e-4 gate at UC2's -10000 key padding
//   (tests/test_torch_b4_mma_numerics.py).
// - float32 parity mode: 64 x 64 tiles of fp32 FMAs on the CUDA cores
//   (b4_fp32_kernel) and the fp32 core of attention_train.cuh, key-blocked
//   past one block's shared memory, with dctx an fp32 buffer.
// In both, dW and db are summed over the B*S rows in a few fixed K ranges,
// one block per output tile and range, and the partials are added in order
// by b4_wgrad_reduce_kernel: no float atomics anywhere, so every bit repeats.
//
// What bounds it on the H100: at UC2 training (B=128, S=76, H*hd=768, bf16)
// the forward does ~48 GFLOP (q|k|v 34.4, Wo 11.5, core 2.3) against ~94 MB
// moved, the backward ~97 GFLOP against ~114 MB; both are bound by the
// tensor cores' operations (0.05 and 0.10 ms at 989 TFLOP/s), which is why
// the products run on wgmma from shared memory that TMA fills.
#include <initializer_list>

#include "attention_train.cuh"
#include "attention_train_mma.cuh"
#include "gemm_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace gw = gemm_wgmma;

// ---------------------------------------------------------------------------
// float32 parity mode: CUDA cores
// ---------------------------------------------------------------------------

// Epilogues. BIAS: C = acc + bias[n]; F32: C = acc; WGRAD: the partial
// product of one of d.ksplit K ranges, and in the first column of tiles the
// partial colsum[m] = sum_k A(m, k) of that range, for b4_wgrad_reduce_kernel
// to sum in order; SUM: C = the jobs' products summed job by job in one
// block per tile.
enum { EPI_BIAS = 0, EPI_F32 = 1, EPI_WGRAD = 2, EPI_SUM = 3 };

// C[m][n] = sum_k A(m, k) B(n, k) for up to four jobs (blockIdx.z, or all
// of them in one block for EPI_SUM). A(m, k) = A[m*lda + k] when A_KMAJ,
// else A[k*lda + m]; likewise B with ldb. Rows of a K-contiguous operand
// need K % 4 == 0, an M-contiguous operand a row count that is a multiple
// of 4; both start on 16-byte boundaries.
struct Jobs {
  const void* a[4];
  const void* b[4];
  const float* bias[4];
  void* c[4];
  float* colsum[4];
};

struct Dims {
  int M, N, K;
  long long lda, ldb, ldc;
  int njobs;
  int ksplit;   // K ranges per job (blockIdx.z = job * ksplit + range); SUM: 1
};

constexpr int kSplitK = 4;     // K ranges of the weight gradients, fp32
constexpr int kSplitK16 = 5;   // bf16: 360 blocks of 128 x 256, 2.7 waves of 132 SMs

// The K range [k0, k1) of block z's job, cut at multiples of step.
__device__ __forceinline__ void k_range(const Dims& d, int z, int step, int& k0, int& k1) {
  const int chunk = ((d.K + step - 1) / step + d.ksplit - 1) / d.ksplit * step;
  k0 = min(d.K, (z % d.ksplit) * chunk);
  k1 = min(d.K, k0 + chunk);
}

// The epilogue of accumulator v at (gm, gn) of job j. EPI_SUM keeps its
// running sum in C itself: the same thread owns the same element in every
// job, so job j > 0 reads back what it wrote and adds v.
template <int EPI>
__device__ __forceinline__ void emit(const Jobs& jobs, const Dims& d, int j, int gm, int gn,
                                     float v) {
  if (gm >= d.M || gn >= d.N) return;
  const long long o = (long long)gm * d.ldc + gn;
  if constexpr (EPI == EPI_F32 || EPI == EPI_WGRAD) {
    const long long part = EPI == EPI_WGRAD ? (long long)(blockIdx.z % d.ksplit) * d.M * d.ldc : 0;
    static_cast<float*>(jobs.c[j])[part + o] = v;
    return;
  }
  float* c = static_cast<float*>(jobs.c[EPI == EPI_SUM ? 0 : j]) + o;
  if constexpr (EPI == EPI_BIAS) v += jobs.bias[j][gn];
  if constexpr (EPI == EPI_SUM) v = j == 0 ? v : *c + v;
  *c = v;
}

constexpr int BM = 64, BK = 32, kFp32Threads = 128;
constexpr int kLd32 = BK + 4;   // padded smem row (floats)

// A [64 x BK] tile (rows r0.., K columns k0..) into shared memory as
// [64][kLd32] with K contiguous, four 16-byte loads per thread; out-of-range
// vectors read as zeros.
template <bool KMAJ>
__device__ __forceinline__ void load_tile32(float* S, const float* X, long long ld, int r0,
                                            int R, int k0, int K, int tid) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = tid + i * kFp32Threads;
    const int r = KMAJ ? idx >> 3 : (idx & 15) * 4;
    const int k = KMAJ ? (idx & 7) * 4 : idx >> 4;
    const int gr = r0 + r, gk = k0 + k;
    const bool ok = KMAJ ? (gr < R && gk + 4 <= K) : (gk < K && gr + 4 <= R);
    const long long off = KMAJ ? (long long)gr * ld + gk : (long long)gk * ld + gr;
    const float4 v = ok ? *reinterpret_cast<const float4*>(X + off)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    if (KMAJ) {
      *reinterpret_cast<float4*>(S + r * kLd32 + k) = v;
    } else {
      S[r * kLd32 + k] = v.x;
      S[(r + 1) * kLd32 + k] = v.y;
      S[(r + 2) * kLd32 + k] = v.z;
      S[(r + 3) * kLd32 + k] = v.w;
    }
  }
}

// Thread (tr, tc) = (tid/16, tid%16) owns rows tr + 8i and columns tc + 16j
// of the 64x64 tile, acc[4i + j].
template <bool A_KMAJ, bool B_KMAJ, int EPI>
__global__ void __launch_bounds__(kFp32Threads) b4_fp32_kernel(Jobs jobs, Dims d) {
  __shared__ __align__(16) float As[BM * kLd32];
  __shared__ __align__(16) float Bs[BM * kLd32];
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int n0 = blockIdx.x * BM, m0 = blockIdx.y * BM;
  int kb, ke;
  k_range(d, blockIdx.z, BK, kb, ke);
  const int nk = (ke - kb + BK - 1) / BK;
  const int j0 = EPI == EPI_SUM ? 0 : blockIdx.z / d.ksplit;
  const int j1 = EPI == EPI_SUM ? d.njobs : j0 + 1;
  const bool colsum = EPI == EPI_WGRAD && blockIdx.x == 0 && tid < BM;
  for (int j = j0; j < j1; ++j) {
    const float* A = static_cast<const float*>(jobs.a[j]);
    const float* B = static_cast<const float*>(jobs.b[j]);
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    float cs = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      load_tile32<A_KMAJ>(As, A, d.lda, m0, d.M, kb + kt * BK, ke, tid);
      load_tile32<B_KMAJ>(Bs, B, d.ldb, n0, d.N, kb + kt * BK, ke, tid);
      __syncthreads();
      if (colsum) {
#pragma unroll 8
        for (int k = 0; k < BK; ++k) cs += As[tid * kLd32 + k];
      }
#pragma unroll 4
      for (int k = 0; k < BK; ++k) {
        float a[8], b[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = As[(tr + 8 * i) * kLd32 + k];
#pragma unroll
        for (int i = 0; i < 4; ++i) b[i] = Bs[(tc + 16 * i) * kLd32 + k];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc[i * 4 + jj] = fmaf(a[i], b[jj], acc[i * 4 + jj]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 32; ++i)
      emit<EPI>(jobs, d, j, m0 + tr + 8 * (i >> 2), n0 + tc + 16 * (i & 3), acc[i]);
    if (colsum && m0 + tid < d.M)
      jobs.colsum[j][(long long)(blockIdx.z % d.ksplit) * d.M + m0 + tid] = cs;
  }
}

template <bool A_KMAJ, bool B_KMAJ, int EPI>
cudaError_t linear32(const Jobs& jobs, const Dims& d, cudaStream_t st) {
  const int nz = EPI == EPI_SUM ? 1 : d.njobs * d.ksplit;
  b4_fp32_kernel<A_KMAJ, B_KMAJ, EPI>
      <<<dim3((d.N + BM - 1) / BM, (d.M + BM - 1) / BM, nz), kFp32Threads, 0, st>>>(jobs, d);
  return cudaGetLastError();
}

// dbias[b][s] = sum over h = 0..H-1, in that order, of dbias_heads[b][h][s].
__global__ void b4_head_sum_kernel(const float* __restrict__ dbh, float* __restrict__ db,
                                   int B, int H, int S) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * S) return;
  const long long b = i / S, s = i % S;
  float acc = dbh[b * H * S + s];
  for (int h = 1; h < H; ++h) acc += dbh[(b * H + h) * S + s];
  db[i] = acc;
}

// dW[j] = T(sum over s = 0..ksplit-1, in that order, of part[j][s]) and
// db[j] = the same sum of colpart[j][s], over [M, N] and [M]: the weight
// and bias gradients from b4_*_kernel's EPI_WGRAD partials.
struct WGrads {
  void* dw[4];
  float* db[4];
};

template <typename T>
__device__ __forceinline__ void store4(T* p, float4 v);
template <>
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
template <>
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v.x, v.y);
  q[1] = __floats2bfloat162_rn(v.z, v.w);
}

// Four consecutive elements a thread (M * N and M are multiples of 4).
template <typename T>
__global__ void b4_wgrad_reduce_kernel(const float* __restrict__ part,
                                       const float* __restrict__ colpart, WGrads out, int M,
                                       int N, int ksplit) {
  const int j = blockIdx.y;
  const long long MN = (long long)M * N;
  const long long i = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i < MN) {
    const float* p = part + (long long)j * ksplit * MN + i;
    float4 acc = *reinterpret_cast<const float4*>(p);
    for (int s = 1; s < ksplit; ++s) {
      const float4 x = *reinterpret_cast<const float4*>(p + s * MN);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    store4(static_cast<T*>(out.dw[j]) + i, acc);
  }
  if (i < M) {
    const float* p = colpart + (long long)j * ksplit * M + i;
    float4 acc = *reinterpret_cast<const float4*>(p);
    for (int s = 1; s < ksplit; ++s) {
      const float4 x = *reinterpret_cast<const float4*>(p + (long long)s * M);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    *reinterpret_cast<float4*>(out.db[j] + i) = acc;
  }
}

// The reduce over the four weights' [HD, HD] gradients and [HD] bias
// gradients, from ksplit partials each.
template <typename T>
cudaError_t wgrad_reduce(const float* wpart, const float* cpart, const WGrads& out, int HD,
                         int ksplit, cudaStream_t st) {
  const long long quads = (long long)HD * HD / 4;
  b4_wgrad_reduce_kernel<T><<<dim3((unsigned)((quads + 255) / 256), 4), 256, 0, st>>>(
      wpart, cpart, out, HD, HD, ksplit);
  return cudaGetLastError();
}

attn_train::Layout flat(int S, int H, int hd) {
  const long long HD = (long long)H * hd;
  return {HD, (long long)S * HD, hd};
}

int block_fwd32(const void* x, const void* const* w, const float* const* b, const void* bias,
                void* q, void* k, void* v, void* ctx, void* y, int B, int S, int H, int hd,
                int keep_t, float rscale, unsigned long long seed, cudaStream_t st, int blocked) {
  const int N = B * S, HD = H * hd;
  Dims d{N, HD, HD, HD, HD, HD, 3, 1};
  Jobs qkv{{x, x, x}, {w[0], w[1], w[2]}, {b[0], b[1], b[2]}, {q, k, v}, {}};
  cudaError_t e = linear32<true, true, EPI_BIAS>(qkv, d, st);
  if (e != cudaSuccess) return (int)e;
  e = attn_train::fwd_hd<float>(hd, q, k, v, static_cast<const float*>(bias), ctx, B, S, H,
                                flat(S, H, hd), keep_t, rscale, seed, st, blocked);
  if (e != cudaSuccess) return (int)e;
  d.njobs = 1;
  Jobs out{{ctx}, {w[3]}, {b[3]}, {y}, {}};
  return (int)linear32<true, true, EPI_BIAS>(out, d, st);
}

int block_bwd32(const void* x, const void* q, const void* k, const void* v, const void* ctx,
                const void* bias, const void* g, const void* const* w, float* dctx, void* dq,
                void* dk, void* dv, float* dbh, float* dbias, void* dx, void* const* dw,
                float* const* db, float* wpart, int B, int S, int H, int hd, int keep_t,
                float rscale, unsigned long long seed, cudaStream_t st, float* dq32) {
  const int N = B * S, HD = H * hd;
  // dctx = g Wo, fp32: the core's do
  Dims d{N, HD, HD, HD, HD, HD, 1, 1};
  Jobs dc{{g}, {w[3]}, {}, {dctx}, {}};
  cudaError_t e = linear32<true, false, EPI_F32>(dc, d, st);
  if (e != cudaSuccess) return (int)e;
  e = attn_train::bwd_hd<float>(hd, q, k, v, static_cast<const float*>(bias), dctx, dq, dk, dv,
                                dbh, B, S, H, flat(S, H, hd), keep_t, rscale, seed, st, dq32);
  if (e != cudaSuccess) return (int)e;
  b4_head_sum_kernel<<<(N + 255) / 256, 256, 0, st>>>(dbh, dbias, B, H, S);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  // dW = dy^T in over the B*S rows, db = sum dy: kSplitK fp32 partials per
  // weight in wpart, then summed in order
  const long long HH = (long long)HD * HD;
  float* cpart = wpart + 4 * kSplitK * HH;
  Dims dwd{HD, HD, N, HD, HD, HD, 4, kSplitK};
  Jobs wg{{dq, dk, dv, g}, {x, x, x, ctx}, {}, {}, {}};
  for (int j = 0; j < 4; ++j) {
    wg.c[j] = wpart + j * kSplitK * HH;
    wg.colsum[j] = cpart + j * kSplitK * HD;
  }
  e = linear32<false, false, EPI_WGRAD>(wg, dwd, st);
  if (e != cudaSuccess) return (int)e;
  WGrads out{{dw[0], dw[1], dw[2], dw[3]}, {db[0], db[1], db[2], db[3]}};
  if ((e = wgrad_reduce<float>(wpart, cpart, out, HD, kSplitK, st)) != cudaSuccess) return (int)e;
  // dx = (dq Wq + dk Wk) + dv Wv
  d.njobs = 3;
  Jobs xs{{dq, dk, dv}, {w[0], w[1], w[2]}, {}, {dx}, {}};
  return (int)linear32<true, false, EPI_SUM>(xs, d, st);
}

// ---------------------------------------------------------------------------
// bf16: wgmma products and the tensor-core core
// ---------------------------------------------------------------------------

// The tile width of each product (gemm_wgmma's NT: 1 = 128 x 128 tiles,
// two blocks an SM; 2 = 128 x 256, one block an SM), the faster of the two
// at UC2's shapes on an H100 (tools/profile_block.py --widths).
constexpr int kNtQkv = 1, kNtOut = 1, kNtDctx = 1, kNtWgrad = 2, kNtDx = 1;

// One product on gemm_wgmma: operands a[j], b[j] of the template's layouts
// (leading dimension HD each), outputs and bias as Args.
template <bool A_KMAJ, bool B_KMAJ, int EPI, int NT>
cudaError_t product(std::initializer_list<const void*> a, std::initializer_list<const void*> b,
                    gw::Args args, long long HD, cudaStream_t st) {
  gw::Operands ops{};
  int j = 0;
  for (const void* p : a) ops.a[j++] = p;
  j = 0;
  for (const void* p : b) ops.b[j++] = p;
  ops.lda = ops.ldb = HD;
  args.njobs = (int)a.size();
  return gw::gemm<A_KMAJ, B_KMAJ, EPI, NT>(ops, args, st);
}

int block_fwd16(const void* x, const void* const* w, const float* const* b, const void* bias,
                void* q, void* k, void* v, void* ctx, void* y, void* stats, void* words, int B,
                int S, int H, int hd, int keep_t, float rscale, unsigned long long seed,
                cudaStream_t st) {
  const int N = B * S, HD = H * hd;
  gw::Args a{{b[0], b[1], b[2]}, {q, k, v}, {}, N, HD, HD, 3, 1, HD, 0};
  cudaError_t e = product<true, true, gw::EPI_BIAS, kNtQkv>({x, x, x}, {w[0], w[1], w[2]}, a, HD, st);
  if (e != cudaSuccess) return (int)e;
  const int ec = attn_train_mma::forward(q, k, v, bias, ctx, stats, words, B, S, H, hd,
                                         flat(S, H, hd), keep_t, rscale, seed, st);
  if (ec != 0) return ec;
  gw::Args o{{b[3]}, {y}, {}, N, HD, HD, 1, 1, HD, 0};
  return (int)product<true, true, gw::EPI_BIAS, kNtOut>({ctx}, {w[3]}, o, HD, st);
}

int block_bwd16(const void* x, const void* q, const void* k, const void* v, const void* ctx,
                const void* bias, const void* g, const void* const* w, bf16* dctx, void* dq,
                void* dk, void* dv, float* dbh, float* dbias, void* dx, void* const* dw,
                float* const* db, float* wpart, const void* stats, const void* words, int B,
                int S, int H, int hd, int keep_t, float rscale, cudaStream_t st, void* dq32) {
  if (stats == nullptr || (keep_t < 256 && words == nullptr)) return (int)cudaErrorInvalidValue;
  const int N = B * S, HD = H * hd;
  const long long NHD = (long long)N * HD, HH = (long long)HD * HD;
  // dctx = g Wo as hi and lo bf16 planes: the core's do
  gw::Args dc{{}, {dctx}, {}, N, HD, HD, 1, 1, HD, NHD};
  cudaError_t e = product<true, false, gw::EPI_HILO, kNtDctx>({g}, {w[3]}, dc, HD, st);
  if (e != cudaSuccess) return (int)e;
  const int ec = attn_train_mma::backward<true>(q, k, v, bias, dctx, stats, words, dq, dk, dv,
                                                dbh, dq32, B, S, H, hd, flat(S, H, hd), keep_t,
                                                rscale, st, dctx + NHD);
  if (ec != 0) return ec;
  b4_head_sum_kernel<<<(N + 255) / 256, 256, 0, st>>>(dbh, dbias, B, H, S);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  // dW = dy^T in over the B*S rows, db = sum dy: kSplitK16 fp32 partials
  // per weight in wpart, then summed in order
  float* cpart = wpart + 4 * kSplitK16 * HH;
  gw::Args wa{{}, {}, {}, HD, HD, N, 4, kSplitK16, HD, HH};
  for (int j = 0; j < 4; ++j) {
    wa.c[j] = wpart + j * kSplitK16 * HH;
    wa.colsum[j] = cpart + j * kSplitK16 * HD;
  }
  e = product<false, false, gw::EPI_WGRAD, kNtWgrad>({dq, dk, dv, g}, {x, x, x, ctx}, wa, HD, st);
  if (e != cudaSuccess) return (int)e;
  WGrads out{{dw[0], dw[1], dw[2], dw[3]}, {db[0], db[1], db[2], db[3]}};
  if ((e = wgrad_reduce<bf16>(wpart, cpart, out, HD, kSplitK16, st)) != cudaSuccess) return (int)e;
  // dx = (dq Wq + dk Wk) + dv Wv, each term and each sum rounded to bf16
  gw::Args xs{{}, {dx}, {}, N, HD, HD, 3, 1, HD, 0};
  return (int)product<true, false, gw::EPI_SUM, kNtDx>({dq, dk, dv}, {w[0], w[1], w[2]}, xs, HD, st);
}

}  // namespace

extern "C" {

// Shared memory (bytes) one block of the fp32 core's forward (backward = 0)
// or backward (backward = 1) needs at this S and head dim, all-keys (blocked
// = 0) or key-blocked (blocked = 1); the fp32 products use a fixed 18 KB.
long long block_attention_train_smem_bytes(int S, int hd, int backward, int blocked) {
  return attn_train::smem_bytes(S, hd, backward, blocked);
}

// The same for the bf16 core (attention_train_mma.cuh; its backward with do
// as hi + lo terms); the bf16 products use gemm_wgmma::smem_bytes.
long long block_attention_train_mma_smem_bytes(int S, int hd, int backward) {
  return attn_train_mma::smem_bytes(S, hd, backward, true);
}

// 1 where the bf16 core's backward at (S, hd) needs its float32
// [B, H, S, hd] dq buffer (dq32 of the backward entry), else 0.
int block_attention_train_mma_needs_dq32(int S, int hd) {
  return attn_train_mma::needs_dq32(S, hd);
}

// Floats of the backward's weight-gradient scratch at H*hd = HD: the K-range
// partials of the four dW and db.
long long block_attention_train_scratch_floats(int HD) {
  return 4LL * (kSplitK > kSplitK16 ? kSplitK : kSplitK16) * ((long long)HD * HD + HD);
}

// dtype: 0 = float32, 1 = bfloat16 (x, the weights, q/k/v/ctx/y).
// x, q, k, v, ctx, y: [B, S, H*hd] contiguous; wq, wk, wv, wo: [H*hd, H*hd]
// ([out, in]); bq, bk, bv, bo: [H*hd] float32; bias: [B, S] float32
// (additive, key side). keep_t: u8 keep threshold (256 = no dropout), rscale
// = 256/keep_t. Writes q, k, v and ctx (kept for the backward) and y. bf16
// also writes what its backward reads: stats, float32 [B, H, S, 2], and with
// dropout words, uint16 [B, H, S, ceil(S/16)] (attention_train_mma.cuh).
// blocked = 1: the fp32 core's key-blocked forward (bf16 takes every S).
// Every operand starts on a 16-byte boundary. Returns the first CUDA error
// of its launches, 0 on success.
int block_attention_train_fwd(int dtype, const void* x, const void* wq, const void* wk,
                              const void* wv, const void* wo, const void* bq, const void* bk,
                              const void* bv, const void* bo, const void* bias, void* q,
                              void* k, void* v, void* ctx, void* y, void* stats, void* words,
                              int B, int S, int H, int hd, int keep_t, float rscale,
                              unsigned long long seed, void* stream, int blocked) {
  const void* w[4] = {wq, wk, wv, wo};
  const float* b[4] = {static_cast<const float*>(bq), static_cast<const float*>(bk),
                       static_cast<const float*>(bv), static_cast<const float*>(bo)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return block_fwd32(x, w, b, bias, q, k, v, ctx, y, B, S, H, hd, keep_t, rscale, seed, st,
                       blocked);
  if (dtype == 1)
    return block_fwd16(x, w, b, bias, q, k, v, ctx, y, stats, words, B, S, H, hd, keep_t,
                       rscale, seed, st);
  return (int)cudaErrorInvalidValue;
}

// The forward's x, q, k, v, ctx, bias and weights, and g = dL/dy [B, S, H*hd]
// in x's dtype. Scratch: dctx, float32 [B, S, H*hd] (fp32) or bf16
// [2, B, S, H*hd] (bf16: its hi and lo planes); dq, dk, dv [B, S, H*hd]
// in x's dtype (also outputs), dbias_heads [B, H, S] float32, wgrad_scratch
// of block_attention_train_scratch_floats(H*hd) floats. Writes dbias [B, S]
// float32, dx [B, S, H*hd], dwq..dwo [H*hd, H*hd] in x's dtype and dbq..dbo
// [H*hd] float32. stats, words: bf16, the forward's (the backward returns
// cudaErrorInvalidValue without them); fp32 ignores them. dq32: null, or a
// float32 [B, H, S, hd] buffer: for the fp32 core's key-blocked backward,
// or where block_attention_train_mma_needs_dq32 says so (bf16).
int block_attention_train_bwd(int dtype, const void* x, const void* q, const void* k,
                              const void* v, const void* ctx, const void* bias, const void* g,
                              const void* wq, const void* wk, const void* wv, const void* wo,
                              void* dctx, void* dq, void* dk, void* dv, void* dbias_heads,
                              void* dbias, void* dx, void* dwq, void* dwk, void* dwv,
                              void* dwo, void* dbq, void* dbk, void* dbv, void* dbo,
                              void* wgrad_scratch, const void* stats, const void* words, int B,
                              int S, int H, int hd, int keep_t, float rscale,
                              unsigned long long seed, void* stream, void* dq32) {
  const void* w[4] = {wq, wk, wv, wo};
  void* dw[4] = {dwq, dwk, dwv, dwo};
  float* db[4] = {static_cast<float*>(dbq), static_cast<float*>(dbk),
                  static_cast<float*>(dbv), static_cast<float*>(dbo)};
  float* dbh = static_cast<float*>(dbias_heads);
  float* dbs = static_cast<float*>(dbias);
  float* wp = static_cast<float*>(wgrad_scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return block_bwd32(x, q, k, v, ctx, bias, g, w, static_cast<float*>(dctx), dq, dk, dv, dbh,
                       dbs, dx, dw, db, wp, B, S, H, hd, keep_t, rscale, seed, st,
                       static_cast<float*>(dq32));
  if (dtype == 1)
    return block_bwd16(x, q, k, v, ctx, bias, g, w, static_cast<bf16*>(dctx), dq, dk, dv, dbh,
                       dbs, dx, dw, db, wp, stats, words, B, S, H, hd, keep_t, rscale, st, dq32);
  return (int)cudaErrorInvalidValue;
}

// The bf16 product kernel alone (gemm_wgmma.cuh), for the card tests and
// the tools: wide = 0 for 128 x 128 tiles, 1 for 128 x 256; epi
// 0 = bias, 1 = hi/lo, 2 = weight-gradient partials, 3 = the jobs' sum, in
// the layouts B4 gives each: a[j] [M, K] (epi 0, 1, 3) or [K, M] (epi 2);
// b[j] [N, K] (epi 0) or [K, N] (epi 1, 2, 3); c[j] [M, N] (epi 1: [2, M, N];
// epi 2: [ksplit, M, N] float32 and colsum[j] [ksplit, M] float32); bias[j]
// [N] float32 (epi 0). Returns the launch's error.
int block_attention_train_gemm(int epi, int wide, int njobs, const void* const* a,
                               const void* const* b,
                               const void* const* bias, void* const* c, void* const* colsum,
                               int M, int N, int K, int ksplit, void* stream) {
  if (njobs < 1 || njobs > 4) return (int)cudaErrorInvalidValue;
  gw::Operands ops{};
  gw::Args args{};
  for (int j = 0; j < njobs; ++j) {
    ops.a[j] = a[j];
    ops.b[j] = b[j];
    args.bias[j] = bias ? static_cast<const float*>(bias[j]) : nullptr;
    args.c[j] = c[j];
    args.colsum[j] = colsum ? static_cast<float*>(colsum[j]) : nullptr;
  }
  args.M = M;
  args.N = N;
  args.K = K;
  args.njobs = njobs;
  args.ksplit = ksplit;
  args.ldc = N;
  args.plane = (long long)M * N;
  ops.lda = epi == gw::EPI_WGRAD ? M : K;
  ops.ldb = epi == gw::EPI_BIAS ? K : N;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    switch (epi) {
      case gw::EPI_BIAS: return gw::gemm<true, true, gw::EPI_BIAS, NT>(ops, args, st);
      case gw::EPI_HILO: return gw::gemm<true, false, gw::EPI_HILO, NT>(ops, args, st);
      case gw::EPI_WGRAD: return gw::gemm<false, false, gw::EPI_WGRAD, NT>(ops, args, st);
      case gw::EPI_SUM: return gw::gemm<true, false, gw::EPI_SUM, NT>(ops, args, st);
      default: return cudaErrorInvalidValue;
    }
  };
  return (int)(wide ? launch(std::integral_constant<int, 2>())
                    : launch(std::integral_constant<int, 1>()));
}

}  // extern "C"
