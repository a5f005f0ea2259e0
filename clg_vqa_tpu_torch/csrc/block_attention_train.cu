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
//             dropout (attention_train.cuh, B1's device code) -> ctx in x's
//             dtype, y = ctx Wo^T + bo (same epilogue).
//   backward  dctx = g Wo kept in fp32; the core's backward on that fp32 do
//             -> dq, dk, dv in x's dtype and the bias gradient per head,
//             summed over heads in order h = 0..H-1; dW = dy^T in and
//             db = sum dy for the four weights (dy = dq, dk, dv with in = x;
//             dy = g with in = ctx), dW rounded once to the weights' dtype;
//             dx = (dxq + dxk) + dxv with each term dy W rounded to x's dtype
//             and the two sums taken in x's dtype, in that order (:940-945).
//
// Weights are in PyTorch's [out, in] layout; activations are [B*S, H*hd] rows.
// ctx is the forward's own output, kept by the caller for the backward: the
// TPU kernel recomputes it in VMEM, which gives the same bits.
//
// The products are hand-written, C[m][n] = sum_k A(m, k) B(n, k) with an
// epilogue per use. bf16 (b4_mma_kernel): 128x128 output tiles, eight warps
// of 64x32, bf16 mma.sync.m16n8k16 with fp32 accumulators; 64-deep K steps
// copied to shared memory by cp.async in a three-stage ring, in the
// operand's own layout (K-contiguous, or M-contiguous for Wo and W in dctx
// and dx and for dy and the input in dW), and read into fragments by
// ldmatrix, with .trans for the M-contiguous ones, so nothing is transposed
// in registers. float32 parity mode (b4_fp32_kernel): 64x64 tiles of fp32
// FMAs on the CUDA cores. dW and db are summed over the B*S rows in four
// fixed K ranges, one block per output tile and range, and the four fp32
// partials are added in order by b4_wgrad_reduce_kernel: no float atomics
// anywhere, so every bit repeats.
//
// What bounds it on the H100: at UC2 training (B=128, S=76, H*hd=768, bf16)
// the forward does ~48 GFLOP (q|k|v 34.4, Wo 11.5, core 2.3) against ~94 MB
// moved, the backward ~97 GFLOP against ~114 MB; both are bound by the
// tensor cores' operations (0.05 and 0.10 ms at 989 TFLOP/s). mma.sync
// reaches part of that peak, and the core (B1's device code, fp32 CUDA
// cores) takes ~0.3 + 0.9 ms of device time; wgmma and TMA are later
// changes.
#include <type_traits>

#include "attention_train.cuh"
#include "mma_tools.cuh"

namespace {

using bf16 = __nv_bfloat16;

// Epilogues. BIAS: C = T(acc + bias[n]); F32: C = acc (float); WGRAD: the
// fp32 partial product of one of d.ksplit K ranges, and in the first column
// of tiles the partial colsum[m] = sum_k A(m, k) of that range, for
// b4_wgrad_reduce_kernel to sum in order; SUM: C = the jobs' T(acc) summed
// in T, job by job, in one block per tile.
enum { EPI_BIAS = 0, EPI_F32 = 1, EPI_WGRAD = 2, EPI_SUM = 3 };

// C[m][n] = sum_k A(m, k) B(n, k) for up to four jobs (blockIdx.z, or all
// of them in one block for EPI_SUM). A(m, k) = A[m*lda + k] when A_KMAJ,
// else A[k*lda + m]; likewise B with ldb. Rows of a K-contiguous operand
// need K % 8 == 0, an M-contiguous operand a row count that is a multiple
// of 8; both start on 16-byte boundaries.
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

constexpr int kSplitK = 4;   // K ranges of the weight gradients

// The K range [k0, k1) of block z's job, cut at multiples of step.
__device__ __forceinline__ void k_range(const Dims& d, int z, int step, int& k0, int& k1) {
  const int chunk = ((d.K + step - 1) / step + d.ksplit - 1) / d.ksplit * step;
  k0 = min(d.K, (z % d.ksplit) * chunk);
  k1 = min(d.K, k0 + chunk);
}

template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<bf16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The epilogue of accumulator v at (gm, gn) of job j. EPI_SUM keeps its
// running sum in C itself: the same thread owns the same element in every
// job, so job j > 0 reads back what it wrote, adds T(v) and rounds to T.
template <typename T, int EPI>
__device__ __forceinline__ void emit(const Jobs& jobs, const Dims& d, int j, int gm, int gn,
                                     float v) {
  if (gm >= d.M || gn >= d.N) return;
  const long long o = (long long)gm * d.ldc + gn;
  if constexpr (EPI == EPI_F32 || EPI == EPI_WGRAD) {
    const long long part = EPI == EPI_WGRAD ? (long long)(blockIdx.z % d.ksplit) * d.M * d.ldc : 0;
    static_cast<float*>(jobs.c[j])[part + o] = v;
    return;
  }
  T* c = static_cast<T*>(jobs.c[EPI == EPI_SUM ? 0 : j]) + o;
  if constexpr (EPI == EPI_BIAS) v += jobs.bias[j][gn];
  if constexpr (EPI == EPI_SUM) v = j == 0 ? v : attn_train::to_f32(*c) + rnd<T>(v);
  attn_train::store(c, v);
}

// The same for the bf16 pair (gm, gn), (gm, gn + 1); gn is even, as N and
// ldc are.
template <int EPI>
__device__ __forceinline__ void emit2(const Jobs& jobs, const Dims& d, int j, int gm, int gn,
                                      float v0, float v1) {
  if (gm >= d.M || gn >= d.N) return;
  const long long o = (long long)gm * d.ldc + gn;
  if constexpr (EPI == EPI_F32 || EPI == EPI_WGRAD) {
    const long long part = EPI == EPI_WGRAD ? (long long)(blockIdx.z % d.ksplit) * d.M * d.ldc : 0;
    *reinterpret_cast<float2*>(static_cast<float*>(jobs.c[j]) + part + o) = make_float2(v0, v1);
    return;
  }
  __nv_bfloat162* c =
      reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(jobs.c[EPI == EPI_SUM ? 0 : j]) + o);
  if constexpr (EPI == EPI_BIAS) {
    const float2 b = *reinterpret_cast<const float2*>(jobs.bias[j] + gn);
    v0 += b.x;
    v1 += b.y;
  }
  if constexpr (EPI == EPI_SUM) {
    if (j > 0) {
      const float2 p = __bfloat1622float2(*c);
      v0 = p.x + rnd<bf16>(v0);
      v1 = p.y + rnd<bf16>(v1);
    }
  }
  *c = __floats2bfloat162_rn(v0, v1);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int TM = 128, TN = 128, TK = 64, kStages = 3, kMmaThreads = 256;
constexpr int kLdK = TK + 8;     // K-contiguous tile row (elements): 144 bytes
constexpr int kLdM = TM + 8;     // M-contiguous tile row: 272 bytes
constexpr int kChunks = TM * TK / 8 / kMmaThreads;   // 16-byte copies per thread
constexpr int kTileElems = TM * kLdK > TK * kLdM ? TM * kLdK : TK * kLdM;
constexpr int kMmaSmem = 2 * kStages * kTileElems * (int)sizeof(bf16);

// One 128-row, TK-deep K step of an operand into its shared-memory tile,
// kChunks 16-byte cp.async per thread: [128][kLdK] for a K-contiguous
// operand, [TK][kLdM] for an M-contiguous one. Out-of-range chunks are
// zero-filled.
template <bool KMAJ>
__device__ __forceinline__ void load_step(bf16* S, const bf16* X, long long ld, int r0, int R,
                                          int k0, int K, int tid) {
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = tid + i * kMmaThreads;
    const int r = KMAJ ? c / (TK / 8) : (c % (TM / 8)) * 8;
    const int k = KMAJ ? (c % (TK / 8)) * 8 : c / (TM / 8);
    const int gr = r0 + r, gk = k0 + k;
    const bool ok = KMAJ ? (gr < R && gk + 8 <= K) : (gk < K && gr + 8 <= R);
    const long long off = KMAJ ? (long long)gr * ld + gk : (long long)gk * ld + gr;
    cp_async16(S + (KMAJ ? r * kLdK + k : k * kLdM + r), ok ? X + off : X, ok);
  }
}

// A fragment of the 16x16 tile at rows m.., K columns kk.. (registers in
// mma's a0..a3 order).
template <bool KMAJ>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* S, int m, int kk,
                                       int lane) {
  const int q = lane >> 3, r = lane & 7;
  if (KMAJ)
    ldmatrix_x4(a, S + (m + (q & 1) * 8 + r) * kLdK + kk + (q >> 1) * 8);
  else
    ldmatrix_x4_trans(a, S + (kk + (q >> 1) * 8 + r) * kLdM + m + (q & 1) * 8);
}

// B fragments of two n8 tiles at columns n.. and n+8.., K rows kk..:
// b[0], b[1] for the first, b[2], b[3] for the second.
template <bool KMAJ>
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const bf16* S, int n, int kk,
                                       int lane) {
  const int q = lane >> 3, r = lane & 7;
  if (KMAJ)
    ldmatrix_x4(b, S + (n + (q >> 1) * 8 + r) * kLdK + kk + (q & 1) * 8);
  else
    ldmatrix_x4_trans(b, S + (kk + (q & 1) * 8 + r) * kLdM + n + (q >> 1) * 8);
}

template <bool A_KMAJ, bool B_KMAJ, int EPI>
__global__ void __launch_bounds__(kMmaThreads) b4_mma_kernel(Jobs jobs, Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int wm = (w >> 2) * 64, wn = (w & 3) * 32;   // the warp's 64x32 tile
  const int g = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM;
  int kb, ke;
  k_range(d, blockIdx.z, TK, kb, ke);
  const int nk = (ke - kb + TK - 1) / TK;
  const int j0 = EPI == EPI_SUM ? 0 : blockIdx.z / d.ksplit;
  const int j1 = EPI == EPI_SUM ? d.njobs : j0 + 1;
  const bool colsum = EPI == EPI_WGRAD && blockIdx.x == 0 && tid < TM;
  for (int j = j0; j < j1; ++j) {
    const bf16* A = static_cast<const bf16*>(jobs.a[j]);
    const bf16* B = static_cast<const bf16*>(jobs.b[j]);
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    float cs = 0.f;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nk) {
        load_step<A_KMAJ>(sm + 2 * s * kTileElems, A, d.lda, m0, d.M, kb + s * TK, ke, tid);
        load_step<B_KMAJ>(sm + (2 * s + 1) * kTileElems, B, d.ldb, n0, d.N, kb + s * TK, ke,
                          tid);
      }
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      const int nxt = kt + kStages - 1;
      if (nxt < nk) {
        const int s = nxt % kStages;
        load_step<A_KMAJ>(sm + 2 * s * kTileElems, A, d.lda, m0, d.M, kb + nxt * TK, ke, tid);
        load_step<B_KMAJ>(sm + (2 * s + 1) * kTileElems, B, d.ldb, n0, d.N, kb + nxt * TK, ke,
                          tid);
      }
      cp_async_commit();
      const bf16* As = sm + 2 * (kt % kStages) * kTileElems;
      const bf16* Bs = As + kTileElems;
      if (colsum) {
#pragma unroll 8
        for (int k = 0; k < TK; ++k)
          cs += __bfloat162float(A_KMAJ ? As[tid * kLdK + k] : As[k * kLdM + tid]);
      }
#pragma unroll
      for (int kk = 0; kk < TK; kk += 16) {
        uint32_t a[4][4], b[2][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) frag_a<A_KMAJ>(a[mi], As, wm + mi * 16, kk, lane);
#pragma unroll
        for (int p = 0; p < 2; ++p) frag_b<B_KMAJ>(b[p], Bs, wn + p * 16, kk, lane);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_bf16(acc + (mi * 4 + ni) * 4, a[mi], b[ni >> 1][(ni & 1) * 2],
                     b[ni >> 1][(ni & 1) * 2 + 1]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // the next job refills the ring
    // acc[(mi*4 + ni)*4 + e] sits at row wm + 16mi + g + 8(e/2), column
    // wn + 8ni + 2t4 + e%2
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int mi = i >> 4, ni = (i >> 2) & 3, e = i & 3;
      emit2<EPI>(jobs, d, j, m0 + wm + mi * 16 + g + 8 * (e >> 1),
                 n0 + wn + ni * 8 + 2 * t4, acc[i], acc[i + 1]);
    }
    if (colsum && m0 + tid < d.M)
      jobs.colsum[j][(long long)(blockIdx.z % d.ksplit) * d.M + m0 + tid] = cs;
  }
}

// ---------------------------------------------------------------------------
// float32 parity mode: CUDA cores
// ---------------------------------------------------------------------------

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
      emit<float, EPI>(jobs, d, j, m0 + tr + 8 * (i >> 2), n0 + tc + 16 * (i & 3), acc[i]);
    if (colsum && m0 + tid < d.M)
      jobs.colsum[j][(long long)(blockIdx.z % d.ksplit) * d.M + m0 + tid] = cs;
  }
}

template <typename T, bool A_KMAJ, bool B_KMAJ, int EPI>
cudaError_t linear(const Jobs& jobs, const Dims& d, cudaStream_t st) {
  const int nz = EPI == EPI_SUM ? 1 : d.njobs * d.ksplit;
  if constexpr (std::is_same_v<T, bf16>) {
    auto kern = b4_mma_kernel<A_KMAJ, B_KMAJ, EPI>;
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMmaSmem);
    if (e != cudaSuccess) return e;
    kern<<<dim3((d.N + TN - 1) / TN, (d.M + TM - 1) / TM, nz), kMmaThreads, kMmaSmem, st>>>(
        jobs, d);
  } else {
    b4_fp32_kernel<A_KMAJ, B_KMAJ, EPI>
        <<<dim3((d.N + BM - 1) / BM, (d.M + BM - 1) / BM, nz), kFp32Threads, 0, st>>>(jobs,
                                                                                    d);
  }
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
__global__ void b4_wgrad_reduce_kernel(const float* __restrict__ part,
                                       const float* __restrict__ colpart, WGrads out, int M,
                                       int N, int ksplit) {
  const int j = blockIdx.y;
  const long long MN = (long long)M * N;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < MN) {
    const float* p = part + (long long)j * ksplit * MN + i;
    float acc = p[0];
    for (int s = 1; s < ksplit; ++s) acc += p[s * MN];
    attn_train::store(static_cast<T*>(out.dw[j]) + i, acc);
  }
  if (i < M) {
    const float* p = colpart + (long long)j * ksplit * M + i;
    float acc = p[0];
    for (int s = 1; s < ksplit; ++s) acc += p[(long long)s * M];
    out.db[j][i] = acc;
  }
}

attn_train::Layout flat(int S, int H, int hd) {
  const long long HD = (long long)H * hd;
  return {HD, (long long)S * HD, hd};
}

template <typename T>
int block_fwd(int dtype, const void* x, const void* const* w, const float* const* b,
              const void* bias, void* q, void* k, void* v, void* ctx, void* y, int B, int S,
              int H, int hd, int keep_t, float rscale, unsigned long long seed, void* stream,
              int blocked) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int N = B * S, HD = H * hd;
  Dims d{N, HD, HD, HD, HD, HD, 3, 1};
  Jobs qkv{{x, x, x}, {w[0], w[1], w[2]}, {b[0], b[1], b[2]}, {q, k, v}, {}};
  cudaError_t e = linear<T, true, true, EPI_BIAS>(qkv, d, st);
  if (e != cudaSuccess) return (int)e;
  const int ec = attn_train::forward(dtype, q, k, v, bias, ctx, B, S, H, hd, flat(S, H, hd),
                                     keep_t, rscale, seed, stream, blocked);
  if (ec != 0) return ec;
  d.njobs = 1;
  Jobs out{{ctx}, {w[3]}, {b[3]}, {y}, {}};
  return (int)linear<T, true, true, EPI_BIAS>(out, d, st);
}

template <typename T>
int block_bwd(int dtype, const void* x, const void* q, const void* k, const void* v,
              const void* ctx, const void* bias, const void* g, const void* const* w,
              float* dctx, void* dq, void* dk, void* dv, float* dbh, float* dbias, void* dx,
              void* const* dw, float* const* db, float* wpart, int B, int S, int H, int hd,
              int keep_t, float rscale, unsigned long long seed, void* stream, void* dq32) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int N = B * S, HD = H * hd;
  // dctx = g Wo, fp32: the core's do
  Dims d{N, HD, HD, HD, HD, HD, 1, 1};
  Jobs dc{{g}, {w[3]}, {}, {dctx}, {}};
  cudaError_t e = linear<T, true, false, EPI_F32>(dc, d, st);
  if (e != cudaSuccess) return (int)e;
  const int ec = attn_train::backward(dtype, q, k, v, bias, dctx, dq, dk, dv, dbh, B, S, H, hd,
                                      flat(S, H, hd), keep_t, rscale, seed, stream, dq32);
  if (ec != 0) return ec;
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
  e = linear<T, false, false, EPI_WGRAD>(wg, dwd, st);
  if (e != cudaSuccess) return (int)e;
  WGrads out{{dw[0], dw[1], dw[2], dw[3]}, {db[0], db[1], db[2], db[3]}};
  b4_wgrad_reduce_kernel<T><<<dim3((unsigned)((HH + 255) / 256), 4), 256, 0, st>>>(
      wpart, cpart, out, HD, HD, kSplitK);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  // dx = (dq Wq + dk Wk) + dv Wv, each term and each sum rounded to T
  d.njobs = 3;
  Jobs xs{{dq, dk, dv}, {w[0], w[1], w[2]}, {}, {dx}, {}};
  return (int)linear<T, true, false, EPI_SUM>(xs, d, st);
}

}  // namespace

extern "C" {

// Shared memory (bytes) one block of the core's forward (backward = 0) or
// backward (backward = 1) needs at this S and head dim, all-keys (blocked =
// 0) or key-blocked (blocked = 1); the products use a fixed 18 KB (float32)
// or 108 KB (bf16).
long long block_attention_train_smem_bytes(int S, int hd, int backward, int blocked) {
  return attn_train::smem_bytes(S, hd, backward, blocked);
}

// Floats of the backward's weight-gradient scratch at H*hd = HD: the K-range
// partials of the four dW and db.
long long block_attention_train_scratch_floats(int HD) {
  return 4LL * kSplitK * ((long long)HD * HD + HD);
}

// dtype: 0 = float32, 1 = bfloat16 (x, the weights, q/k/v/ctx/y).
// x, q, k, v, ctx, y: [B, S, H*hd] contiguous; wq, wk, wv, wo: [H*hd, H*hd]
// ([out, in]); bq, bk, bv, bo: [H*hd] float32; bias: [B, S] float32
// (additive, key side). keep_t: u8 keep threshold (256 = no dropout), rscale
// = 256/keep_t. blocked = 1: the core's key-blocked forward. Writes q, k, v
// and ctx (kept for the backward) and y. Returns the first CUDA error of its
// launches, 0 on success.
int block_attention_train_fwd(int dtype, const void* x, const void* wq, const void* wk,
                              const void* wv, const void* wo, const void* bq, const void* bk,
                              const void* bv, const void* bo, const void* bias, void* q,
                              void* k, void* v, void* ctx, void* y, int B, int S, int H,
                              int hd, int keep_t, float rscale, unsigned long long seed,
                              void* stream, int blocked) {
  const void* w[4] = {wq, wk, wv, wo};
  const float* b[4] = {static_cast<const float*>(bq), static_cast<const float*>(bk),
                       static_cast<const float*>(bv), static_cast<const float*>(bo)};
  if (dtype == 0)
    return block_fwd<float>(dtype, x, w, b, bias, q, k, v, ctx, y, B, S, H, hd, keep_t,
                            rscale, seed, stream, blocked);
  if (dtype == 1)
    return block_fwd<bf16>(dtype, x, w, b, bias, q, k, v, ctx, y, B, S, H, hd, keep_t,
                           rscale, seed, stream, blocked);
  return (int)cudaErrorInvalidValue;
}

// The forward's x, q, k, v, ctx, bias and weights, and g = dL/dy [B, S, H*hd]
// in x's dtype. Scratch: dctx [B, S, H*hd] float32, dq, dk, dv [B, S, H*hd]
// in x's dtype (also outputs), dbias_heads [B, H, S] float32, wgrad_scratch
// of block_attention_train_scratch_floats(H*hd) floats. Writes dbias [B, S]
// float32, dx [B, S, H*hd], dwq..dwo [H*hd, H*hd] in x's dtype and dbq..dbo
// [H*hd] float32. dq32: null, or a float32 [B, H, S, hd] buffer for the
// core's key-blocked backward.
int block_attention_train_bwd(int dtype, const void* x, const void* q, const void* k,
                              const void* v, const void* ctx, const void* bias, const void* g,
                              const void* wq, const void* wk, const void* wv, const void* wo,
                              void* dctx, void* dq, void* dk, void* dv, void* dbias_heads,
                              void* dbias, void* dx, void* dwq, void* dwk, void* dwv,
                              void* dwo, void* dbq, void* dbk, void* dbv, void* dbo,
                              void* wgrad_scratch, int B, int S, int H, int hd, int keep_t,
                              float rscale, unsigned long long seed, void* stream,
                              void* dq32) {
  const void* w[4] = {wq, wk, wv, wo};
  void* dw[4] = {dwq, dwk, dwv, dwo};
  float* db[4] = {static_cast<float*>(dbq), static_cast<float*>(dbk),
                  static_cast<float*>(dbv), static_cast<float*>(dbo)};
  float* dc = static_cast<float*>(dctx);
  float* dbh = static_cast<float*>(dbias_heads);
  float* dbs = static_cast<float*>(dbias);
  float* wp = static_cast<float*>(wgrad_scratch);
  if (dtype == 0)
    return block_bwd<float>(dtype, x, q, k, v, ctx, bias, g, w, dc, dq, dk, dv, dbh, dbs, dx,
                            dw, db, wp, B, S, H, hd, keep_t, rscale, seed, stream, dq32);
  if (dtype == 1)
    return block_bwd<bf16>(dtype, x, q, k, v, ctx, bias, g, w, dc, dq, dk, dv, dbh, dbs, dx,
                           dw, db, wp, B, S, H, hd, keep_t, rscale, seed, stream, dq32);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
