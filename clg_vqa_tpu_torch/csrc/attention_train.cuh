// Training attention for Hopper (sm_90a): the per-(head, sample) device code
// shared in fp32 by the flat kernels (flat_attention_train.cu, B1), the
// S-major kernels (smajor_attention_train.cu, B5), the head-major kernels
// (blocked_attention_train.cu, B3, and its eval twin blocked_attention.cu,
// B2) and the core of the whole-block kernels (block_attention_train.cu,
// B4). Every instantiation is fp32: in bf16, B1, B5, B3 and B4 run the
// tensor-core code of attention_train_mma.cuh, K1 and B2 attention_eval.cuh.
//
// Layout. Element d of head h, query row s, sample b of q, k, v, do and the
// gradients sits at b * sample + s * row + h * head + d:
//   flat        [B, S, H*hd]: row = H*hd,   head = hd,    sample = S*H*hd;
//   S-major     [S, B, H*hd]: row = B*H*hd, head = hd,    sample = H*hd;
//   head-major  [B, H, S, hd]: row = hd,    head = S*hd,  sample = H*S*hd.
// The additive key bias is float32 [B, S] and the per-head bias gradient
// float32 [B, H, S] in all three. The arithmetic does not depend on the
// strides, so on the same values every layout gives the same bits.
//
// Forward, per (b, h): s = (q k^T) * (1/sqrt(hd)) + bias in fp32, p = a
// max-subtracted fp32 softmax, p_d = keep ? p * 256/t : 0, o = p_d v with an
// fp32 accumulator, cast to q's dtype.
// Backward: recompute p and the keep mask, then dv = p_d^T do,
// dp = keep ? (do v^T) * 256/t : 0, ds = p * (dp - sum_j dp*p),
// dq = (ds k) / sqrt(hd), dk = (ds^T q) / sqrt(hd), and the bias gradient
// sum_i ds per (b, h) as [B, H, S]; the caller sums it over heads in a fixed
// order. No float atomics anywhere, so every bit is reproducible.
//
// Dropout bits: Philox4x32-10 keyed by the 64-bit seed, counter
// (key column / 16, query row, head, sample); key column j keeps where byte
// j % 16 of that call's 16 output bytes is below t. The plain PyTorch version
// (ops/attention.py:dropout_keep_mask) computes the same bits, and the
// backward replays them without storing a mask.
//
// What bounds it on the H100: at UC2 training's shapes (B=128, S=76,
// H*hd=768) in fp32 the forward moves ~120 MB and does ~2.3 GFLOP, the
// backward ~209 MB and ~5.7 GFLOP. The products run on the fp32 CUDA cores
// (67 TFLOP/s): 0.034 ms and 0.085 ms of operations against 0.036 ms and
// 0.062 ms of bytes, so the backward is bound by operations and the forward
// by both about equally. This is the fp32 parity mode; bf16 takes the
// tensor cores.
//
// Design: one block per (head, sample). The forward stages K (rows padded to
// hd+1 floats against bank conflicts) and V in shared memory as fp32, and
// each warp walks query rows: lanes own keys for the scores, shuffles reduce
// max and sum, lanes own output columns for P.V. The backward stages K, V and
// do plus one [S, S] fp32 tile T and runs four phases separated by block
// barriers: (A) each warp writes its rows' p_d into T; (B) warps own key rows
// j and lanes own columns to form dv_j = sum_i T[i][j] do_i; (C) each warp
// recomputes p for its rows (the same instructions as phase A, so the same
// bits), forms dp and ds, writes ds into T and dq_i = ds_i K; (D) Q is staged
// where K was and warps own key rows to form dk_j = sum_i T[i][j] q_i and the
// head's bias gradient. At S=140, hd=64 that is ~191 KB of shared memory,
// opted in above 48 KB. The Philox words of one query row are made by
// ceil(S/16) lanes of the warp and read from a per-warp buffer.
//
// Key-blocked variant, for the S whose K, V and [S, S] tile do not fit one
// block's shared memory (S >= 159 at hd 64 for the backward, S >= 418 for
// the forward): K and V are staged 64 keys at a time (four Philox groups), so
// shared memory holds a fixed set of tiles plus four [S] vectors. Both
// directions first walk the key blocks for every query row's statistics: the
// running max m, the sum l of exp(s - m) and, for the backward, the sum of
// dp exp(s - m), rescaled whenever m grows (c = that sum / l = sum_j dp p).
// Then p = exp(s - m) / l. The forward walks the key blocks again for a
// chunk of 64 query rows at a time, their outputs accumulating in shared
// memory. The backward walks the key blocks once more; per key block it takes
// the query rows 32 at a time: (A) warps own rows and write that chunk's p_d
// and ds tiles, (B) warps own the block's keys and add the chunk into the
// block's dv, dk and bias-gradient accumulators, (C) warps own rows and add
// ds K into dq, kept in a float32 [B, H, S, hd] buffer that the caller
// allocates and that only this (head, sample) block touches. The keep bits
// are the same function of (seed, sample, head, row, column // 16). Every sum
// runs in a fixed order, so the results are reproducible bit for bit; they
// differ from the all-keys kernel's in rounding only (l is summed per block).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Internal linkage: each library that includes this file gets its own copy.
namespace attn_train {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// Strides (in elements) of one operand layout; see the top of this file.
struct Layout {
  long long row;     // query row s -> s + 1
  long long sample;  // sample b -> b + 1
  long long head;    // head h -> h + 1
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

__host__ __device__ constexpr int groups(int S) { return (S + 15) / 16; }

// Philox4x32-10 (Random123's philox4x32_R with R = 10).
__device__ __forceinline__ void philox(uint32_t c[4], uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]), lo0 = 0xD2511F53u * c[0];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]), lo1 = 0xCD9E8D57u * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0, n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

// The keep bits of query row i of (b, h): 16 bytes per Philox call, call g
// for key columns 16g..16g+15, written to the warp's buffer mw[4*G] (bytes
// in little-endian order, so byte j of the buffer is key column j).
__device__ __forceinline__ void row_bits(uint32_t* mw, int S, int i, int h, int b,
                                         uint64_t seed, int lane) {
  for (int g = lane; g < groups(S); g += 32) {
    uint32_t c[4] = {(uint32_t)g, (uint32_t)i, (uint32_t)h, (uint32_t)b};
    philox(c, (uint32_t)seed, (uint32_t)(seed >> 32));
#pragma unroll
    for (int w = 0; w < 4; ++w) mw[4 * g + w] = c[w];
  }
  __syncwarp();
}

__device__ __forceinline__ bool kept(const uint32_t* mw, int j, int keep_t) {
  return (int)((mw[j >> 2] >> (8 * (j & 3))) & 0xffu) < keep_t;
}

// Scores of query row i (q row held in registers) against the K tile, into
// pw[0..S), then the softmax in place, leaving p in pw. The same code
// runs in the forward and in both recomputations of the backward, so p has
// the same bits everywhere.
template <int HDIM>
__device__ __forceinline__ void softmax_row(const float (&qr)[HDIM], const float* Ks,
                                            const float* bs, float* pw, int S,
                                            float scale, int lane) {
  constexpr int KS = HDIM + 1;
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
}

template <typename T, int HDIM>
__device__ __forceinline__ void load_row(float (&r)[HDIM], float* stage, const T* src,
                                         int lane) {
  for (int d = lane; d < HDIM; d += 32) stage[d] = to_f32(src[d]);
  __syncwarp();
#pragma unroll
  for (int d = 0; d < HDIM; ++d) r[d] = stage[d];
  __syncwarp();
}

// Forward shared memory (floats): K [S][HDIM+1], V [S][HDIM], bias [S], and
// per warp a q row [HDIM], a probability row [S] and the row's keep bits.
__host__ __device__ constexpr long long fwd_smem_floats(int S, int hdim) {
  return (long long)S * (hdim + 1) + (long long)S * hdim + S +
         (long long)kWarps * (hdim + S + 4 * groups(S));
}

// Backward: K (later Q) and V [S][HDIM+1], do [S][HDIM], T [S][S], bias [S],
// and per warp a row [HDIM], a dp row [S] and the row's keep bits.
__host__ __device__ constexpr long long bwd_smem_floats(int S, int hdim) {
  return 2LL * S * (hdim + 1) + (long long)S * hdim + (long long)S * S + S +
         (long long)kWarps * (hdim + S + 4 * groups(S));
}

template <typename T, int HDIM>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const float* __restrict__ bias, T* __restrict__ out, int S, Layout lay,
           float scale, int keep_t, float rscale, uint64_t seed) {
  extern __shared__ float smem[];
  constexpr int KS = HDIM + 1;
  const int G4 = 4 * groups(S);
  float* Ks = smem;
  float* Vs = Ks + S * KS;
  float* bs = Vs + S * HDIM;
  float* ws = bs + S;

  const int h = blockIdx.x, b = blockIdx.y;
  const long long base = (long long)b * lay.sample + (long long)h * lay.head;
  for (int i = threadIdx.x; i < S * HDIM; i += kThreads) {
    const int s = i / HDIM, d = i % HDIM;
    const long long g = base + (long long)s * lay.row + d;
    Ks[s * KS + d] = to_f32(k[g]);
    Vs[s * HDIM + d] = to_f32(v[g]);
  }
  for (int j = threadIdx.x; j < S; j += kThreads) bs[j] = bias[(long long)b * S + j];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qw = ws + warp * (HDIM + S + G4);
  float* pw = qw + HDIM;
  uint32_t* mw = reinterpret_cast<uint32_t*>(pw + S);
  for (int i = warp; i < S; i += kWarps) {
    const long long row = base + (long long)i * lay.row;
    float qr[HDIM];
    load_row<T, HDIM>(qr, qw, q + row, lane);
    softmax_row<HDIM>(qr, Ks, bs, pw, S, scale, lane);
    if (keep_t < 256) {
      row_bits(mw, S, i, h, b, seed, lane);
      for (int j = lane; j < S; j += 32)
        pw[j] = kept(mw, j, keep_t) ? pw[j] * rscale : 0.f;
      __syncwarp();
    }
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
__global__ void __launch_bounds__(kThreads)
bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const float* __restrict__ bias, const T* __restrict__ dout,
           T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
           float* __restrict__ dbias_heads, int S, Layout lay, float scale, int keep_t,
           float rscale, uint64_t seed) {
  extern __shared__ float smem[];
  constexpr int KS = HDIM + 1;
  const int G4 = 4 * groups(S);
  float* Ks = smem;                 // K, then Q in phase D
  float* Vs = Ks + S * KS;
  float* Ds = Vs + S * KS;          // do [S][HDIM]
  float* Ts = Ds + S * HDIM;        // [S][S]: p_d, then ds
  float* bs = Ts + S * S;
  float* ws = bs + S;

  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  const long long base = (long long)b * lay.sample + (long long)h * lay.head;
  for (int i = threadIdx.x; i < S * HDIM; i += kThreads) {
    const int s = i / HDIM, d = i % HDIM;
    const long long g = base + (long long)s * lay.row + d;
    Ks[s * KS + d] = to_f32(k[g]);
    Vs[s * KS + d] = to_f32(v[g]);
    Ds[s * HDIM + d] = to_f32(dout[g]);
  }
  for (int j = threadIdx.x; j < S; j += kThreads) bs[j] = bias[(long long)b * S + j];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* rw = ws + warp * (HDIM + S + G4);
  float* dpw = rw + HDIM;
  uint32_t* mw = reinterpret_cast<uint32_t*>(dpw + S);
  const bool drop = keep_t < 256;

  // (A) p_d of every query row into T
  for (int i = warp; i < S; i += kWarps) {
    float qr[HDIM];
    load_row<T, HDIM>(qr, rw, q + base + (long long)i * lay.row, lane);
    float* tr = Ts + i * S;
    softmax_row<HDIM>(qr, Ks, bs, tr, S, scale, lane);
    if (drop) {
      row_bits(mw, S, i, h, b, seed, lane);
      for (int j = lane; j < S; j += 32) tr[j] = kept(mw, j, keep_t) ? tr[j] * rscale : 0.f;
      __syncwarp();
    }
  }
  __syncthreads();

  // (B) dv_j = sum_i p_d[i][j] do_i
  for (int j = warp; j < S; j += kWarps) {
#pragma unroll
    for (int d0 = 0; d0 < HDIM; d0 += 32) {
      const int d = d0 + lane;
      float acc = 0.f;
      for (int i = 0; i < S; ++i) acc = fmaf(Ts[i * S + j], Ds[i * HDIM + d], acc);
      store(dv + base + (long long)j * lay.row + d, acc);
    }
  }
  __syncthreads();

  // (C) ds into T, and dq_i = (ds_i K) / sqrt(hd)
  for (int i = warp; i < S; i += kWarps) {
    const long long row = base + (long long)i * lay.row;
    float* tr = Ts + i * S;
    {
      float qr[HDIM];
      load_row<T, HDIM>(qr, rw, q + row, lane);
      softmax_row<HDIM>(qr, Ks, bs, tr, S, scale, lane);
    }
    if (drop) row_bits(mw, S, i, h, b, seed, lane);
    float dor[HDIM];
#pragma unroll
    for (int d = 0; d < HDIM; ++d) dor[d] = Ds[i * HDIM + d];
    float c = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float* vr = Vs + j * KS;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < HDIM; ++d) acc = fmaf(dor[d], vr[d], acc);
      const float dp = drop ? (kept(mw, j, keep_t) ? acc * rscale : 0.f) : acc;
      dpw[j] = dp;
      c += dp * tr[j];
    }
    c = warp_sum(c);
    for (int j = lane; j < S; j += 32) tr[j] = tr[j] * (dpw[j] - c);
    __syncwarp();
#pragma unroll
    for (int d0 = 0; d0 < HDIM; d0 += 32) {
      const int d = d0 + lane;
      float acc = 0.f;
      for (int j = 0; j < S; ++j) acc = fmaf(tr[j], Ks[j * KS + d], acc);
      store(dq + row + d, acc * scale);
    }
    __syncwarp();
  }
  __syncthreads();

  // (D) Q where K was; dk_j = (sum_i ds[i][j] q_i) / sqrt(hd), bias grad
  float* Qs = Ks;
  for (int i = threadIdx.x; i < S * HDIM; i += kThreads) {
    const int s = i / HDIM, d = i % HDIM;
    Qs[s * KS + d] = to_f32(q[base + (long long)s * lay.row + d]);
  }
  __syncthreads();
  for (int j = warp; j < S; j += kWarps) {
#pragma unroll
    for (int d0 = 0; d0 < HDIM; d0 += 32) {
      const int d = d0 + lane;
      float acc = 0.f;
      for (int i = 0; i < S; ++i) acc = fmaf(Ts[i * S + j], Qs[i * KS + d], acc);
      store(dk + base + (long long)j * lay.row + d, acc * scale);
    }
    float db = 0.f;
    for (int i = lane; i < S; i += 32) db += Ts[i * S + j];
    db = warp_sum(db);
    if (lane == 0) dbias_heads[((long long)b * H + h) * S + j] = db;
  }
}

// ---------------------------------------------------------------------------
// The key-blocked variant (see the top of this file)
// ---------------------------------------------------------------------------

constexpr int kKeyBlock = 64;  // keys staged at a time: four 16-column Philox groups
constexpr int kFwdRows = 64;   // query rows whose outputs accumulate at a time
constexpr int kBwdRows = 32;   // query rows per backward step: one per lane in (B)

// Forward: K and V [64][HDIM+1], bias, m and l [S], the outputs of
// kFwdRows rows, and per warp a row [HDIM], a probability row [64] and its
// keep bits.
__host__ __device__ constexpr long long fwd_blocked_smem_floats(int S, int hdim) {
  return 2LL * kKeyBlock * (hdim + 1) + 3LL * S +
         (long long)kFwdRows * hdim + (long long)kWarps * (hdim + kKeyBlock + 16);
}

// Backward: K and V [64][HDIM+1], q and do rows [32][HDIM], the p_d and ds
// tiles [32][65], the dv, dk [64][HDIM] and bias-gradient [64] accumulators,
// bias, m, l and c [S], and per warp a row [HDIM] and keep bits.
__host__ __device__ constexpr long long bwd_blocked_smem_floats(int S, int hdim) {
  return 2LL * kKeyBlock * (hdim + 1) + 2LL * kBwdRows * hdim +
         2LL * kBwdRows * (kKeyBlock + 1) + 2LL * kKeyBlock * hdim + kKeyBlock + 4LL * S +
         (long long)kWarps * (hdim + 16);
}

// The keep bits of query row i for key columns j0..j0+63 (j0 a multiple of
// 64): Philox calls j0/16 .. j0/16 + 3 by lanes 0-3 into mw[16], so byte jj of
// the buffer is key column j0 + jj.
__device__ __forceinline__ void block_bits(uint32_t* mw, int S, int j0, int i, int h, int b,
                                           uint64_t seed, int lane) {
  const int g = (j0 >> 4) + lane;
  if (lane < kKeyBlock / 16 && 16 * g < S) {
    uint32_t c[4] = {(uint32_t)g, (uint32_t)i, (uint32_t)h, (uint32_t)b};
    philox(c, (uint32_t)seed, (uint32_t)(seed >> 32));
#pragma unroll
    for (int w = 0; w < 4; ++w) mw[4 * lane + w] = c[w];
  }
  __syncwarp();
}

// Scores of a q row (in registers) against the nk staged keys: lane owns
// keys lane and lane + 32; -inf past nk.
template <int HDIM>
__device__ __forceinline__ void block_scores(const float (&qr)[HDIM], const float* Kb,
                                             const float* bs, int nk, float scale, int lane,
                                             float (&s)[2]) {
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int jj = lane + 32 * t;
    s[t] = -INFINITY;
    if (jj < nk) {
      const float* kr = Kb + jj * (HDIM + 1);
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < HDIM; ++d) acc = fmaf(qr[d], kr[d], acc);
      s[t] = acc * scale + bs[jj];
    }
  }
}

// dp of a do row (in registers) against the nk staged values, with the
// row's keep bits: lane owns keys lane and lane + 32; 0 past nk.
template <int HDIM>
__device__ __forceinline__ void block_dp(const float (&dor)[HDIM], const float* Vb,
                                         const uint32_t* mw, int nk, int keep_t,
                                         float rscale, int lane, float (&dp)[2]) {
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int jj = lane + 32 * t;
    dp[t] = 0.f;
    if (jj < nk) {
      const float* vr = Vb + jj * (HDIM + 1);
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < HDIM; ++d) acc = fmaf(dor[d], vr[d], acc);
      dp[t] = keep_t < 256 ? (kept(mw, jj, keep_t) ? acc * rscale : 0.f) : acc;
    }
  }
}

// Stage keys j0..j0+nk-1 of k (and of v when Vb is given) as fp32 rows of
// HDIM+1 floats.
template <typename T, int HDIM>
__device__ __forceinline__ void stage_keys(float* Kb, float* Vb, const T* k, const T* v,
                                           long long base, Layout lay, int j0, int nk) {
  for (int e = threadIdx.x; e < nk * HDIM; e += kThreads) {
    const int jj = e / HDIM, d = e % HDIM;
    const long long g = base + (long long)(j0 + jj) * lay.row + d;
    Kb[jj * (HDIM + 1) + d] = to_f32(k[g]);
    if (Vb) Vb[jj * (HDIM + 1) + d] = to_f32(v[g]);
  }
}

// Every query row's softmax statistics over all keys, a key block at a time:
// ms = the max m, ls = sum exp(s - m) and, with DP, cs = sum dp p. The rows
// of warp w are w, w + 8, ...; each keeps its running values in ms/ls/cs.
template <typename T, int HDIM, bool DP>
__device__ void row_stats(const T* q, const T* k, const T* v, const T* dout, float* Kb,
                          float* Vb, const float* bs, float* ms, float* ls, float* cs,
                          float* rw, uint32_t* mw, int S, long long base, Layout lay,
                          float scale, int keep_t, float rscale, uint64_t seed, int h,
                          int b) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < S; i += kThreads) {
    ms[i] = -INFINITY;
    ls[i] = 0.f;
    if (DP) cs[i] = 0.f;
  }
  for (int j0 = 0; j0 < S; j0 += kKeyBlock) {
    const int nk = min(kKeyBlock, S - j0);
    __syncthreads();
    stage_keys<T, HDIM>(Kb, DP ? Vb : nullptr, k, v, base, lay, j0, nk);
    __syncthreads();
    for (int i = warp; i < S; i += kWarps) {
      const long long row = base + (long long)i * lay.row;
      float s[2], dp[2] = {0.f, 0.f};
      {
        float qr[HDIM];
        load_row<T, HDIM>(qr, rw, q + row, lane);
        block_scores<HDIM>(qr, Kb, bs + j0, nk, scale, lane, s);
      }
      if (DP) {
        if (keep_t < 256) block_bits(mw, S, j0, i, h, b, seed, lane);
        float dor[HDIM];
        load_row<T, HDIM>(dor, rw, dout + row, lane);
        block_dp<HDIM>(dor, Vb, mw, nk, keep_t, rscale, lane, dp);
      }
      const float m_old = ms[i];
      const float mn = fmaxf(m_old, warp_max(fmaxf(s[0], s[1])));
      if (mn != -INFINITY) {  // warp-uniform
        const float e0 = expf(s[0] - mn), e1 = expf(s[1] - mn);
        const float el = warp_sum(e0 + e1);
        const float ec = DP ? warp_sum(dp[0] * e0 + dp[1] * e1) : 0.f;
        const float f = expf(m_old - mn);
        if (lane == 0) {
          ls[i] = ls[i] * f + el;
          if (DP) cs[i] = cs[i] * f + ec;
          ms[i] = mn;
        }
      }
      __syncwarp();
    }
  }
  __syncthreads();
  if (DP)
    for (int i = threadIdx.x; i < S; i += kThreads) cs[i] = cs[i] / ls[i];
  __syncthreads();
}

template <typename T, int HDIM>
__global__ void __launch_bounds__(kThreads)
fwd_blocked_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ bias, T* __restrict__ out, int S, Layout lay,
                   float scale, int keep_t, float rscale, uint64_t seed) {
  extern __shared__ float smem[];
  constexpr int KS = HDIM + 1;
  float* Kb = smem;
  float* Vb = Kb + kKeyBlock * KS;
  float* bs = Vb + kKeyBlock * KS;
  float* ms = bs + S;
  float* ls = ms + S;
  float* Os = ls + S;               // [kFwdRows][HDIM]
  float* ws = Os + kFwdRows * HDIM;

  const int h = blockIdx.x, b = blockIdx.y;
  const long long base = (long long)b * lay.sample + (long long)h * lay.head;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* rw = ws + warp * (HDIM + kKeyBlock + 16);
  float* pw = rw + HDIM;
  uint32_t* mw = reinterpret_cast<uint32_t*>(pw + kKeyBlock);
  for (int j = threadIdx.x; j < S; j += kThreads) bs[j] = bias[(long long)b * S + j];
  row_stats<T, HDIM, false>(q, k, v, q, Kb, nullptr, bs, ms, ls, nullptr, rw, mw, S, base,
                               lay, scale, keep_t, rscale, seed, h, b);

  // outputs of kFwdRows rows at a time; thread (warp, lane) owns rows warp,
  // warp + 8, ... of the chunk and columns lane, lane + 32, ...
  for (int r0 = 0; r0 < S; r0 += kFwdRows) {
    const int nr = min(kFwdRows, S - r0);
    for (int j0 = 0; j0 < S; j0 += kKeyBlock) {
      const int nk = min(kKeyBlock, S - j0);
      __syncthreads();
      stage_keys<T, HDIM>(Kb, Vb, k, v, base, lay, j0, nk);
      __syncthreads();
      for (int r = warp; r < nr; r += kWarps) {
        const int i = r0 + r;
        float s[2];
        {
          float qr[HDIM];
          load_row<T, HDIM>(qr, rw, q + base + (long long)i * lay.row, lane);
          block_scores<HDIM>(qr, Kb, bs + j0, nk, scale, lane, s);
        }
        if (keep_t < 256) block_bits(mw, S, j0, i, h, b, seed, lane);
        const float m = ms[i], l = ls[i];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int jj = lane + 32 * t;
          if (jj < nk) {
            const float p = expf(s[t] - m) / l;
            pw[jj] = keep_t < 256 ? (kept(mw, jj, keep_t) ? p * rscale : 0.f) : p;
          }
        }
        __syncwarp();
#pragma unroll
        for (int d0 = 0; d0 < HDIM; d0 += 32) {
          const int d = d0 + lane;
          float acc = j0 ? Os[r * HDIM + d] : 0.f;
          for (int jj = 0; jj < nk; ++jj) acc = fmaf(pw[jj], Vb[jj * KS + d], acc);
          Os[r * HDIM + d] = acc;
        }
        __syncwarp();
      }
    }
    for (int r = warp; r < nr; r += kWarps) {
      const long long row = base + (long long)(r0 + r) * lay.row;
#pragma unroll
      for (int d0 = 0; d0 < HDIM; d0 += 32) store(out + row + d0 + lane, Os[r * HDIM + d0 + lane]);
    }
  }
}

template <typename T, int HDIM>
__global__ void __launch_bounds__(kThreads)
bwd_blocked_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ bias, const T* __restrict__ dout,
                   T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                   float* __restrict__ dbias_heads, float* __restrict__ dq32, int S, Layout lay,
                   float scale, int keep_t, float rscale, uint64_t seed) {
  extern __shared__ float smem[];
  constexpr int KS = HDIM + 1, PS = kKeyBlock + 1;
  float* Kb = smem;
  float* Vb = Kb + kKeyBlock * KS;
  float* Qc = Vb + kKeyBlock * KS;   // [kBwdRows][HDIM]
  float* Dc = Qc + kBwdRows * HDIM;  // [kBwdRows][HDIM]
  float* Ps = Dc + kBwdRows * HDIM;  // [kBwdRows][PS]: p_d
  float* DSs = Ps + kBwdRows * PS;   // [kBwdRows][PS]: ds
  float* dVa = DSs + kBwdRows * PS;  // [64][HDIM]
  float* dKa = dVa + kKeyBlock * HDIM;
  float* dBa = dKa + kKeyBlock * HDIM;
  float* bs = dBa + kKeyBlock;
  float* ms = bs + S;
  float* ls = ms + S;
  float* cs = ls + S;
  float* ws = cs + S;

  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  const long long base = (long long)b * lay.sample + (long long)h * lay.head;
  float* q32 = dq32 + ((long long)b * H + h) * S * HDIM;  // this block's dq rows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* rw = ws + warp * (HDIM + 16);
  uint32_t* mw = reinterpret_cast<uint32_t*>(rw + HDIM);
  const bool drop = keep_t < 256;
  for (int j = threadIdx.x; j < S; j += kThreads) bs[j] = bias[(long long)b * S + j];
  row_stats<T, HDIM, true>(q, k, v, dout, Kb, Vb, bs, ms, ls, cs, rw, mw, S, base, lay,
                               scale, keep_t, rscale, seed, h, b);

  for (int j0 = 0; j0 < S; j0 += kKeyBlock) {
    const int nk = min(kKeyBlock, S - j0);
    __syncthreads();
    stage_keys<T, HDIM>(Kb, Vb, k, v, base, lay, j0, nk);
    for (int r0 = 0; r0 < S; r0 += kBwdRows) {
      const int nr = min(kBwdRows, S - r0);
      for (int e = threadIdx.x; e < nr * HDIM; e += kThreads) {
        const int r = e / HDIM, d = e % HDIM;
        const long long g = base + (long long)(r0 + r) * lay.row + d;
        Qc[r * HDIM + d] = to_f32(q[g]);
        Dc[r * HDIM + d] = to_f32(dout[g]);
      }
      __syncthreads();

      // (A) p_d and ds of the chunk's rows against the key block
      for (int r = warp; r < nr; r += kWarps) {
        const int i = r0 + r;
        float s[2], dp[2];
        {
          float qr[HDIM];
#pragma unroll
          for (int d = 0; d < HDIM; ++d) qr[d] = Qc[r * HDIM + d];
          block_scores<HDIM>(qr, Kb, bs + j0, nk, scale, lane, s);
        }
        if (drop) block_bits(mw, S, j0, i, h, b, seed, lane);
        {
          float dor[HDIM];
#pragma unroll
          for (int d = 0; d < HDIM; ++d) dor[d] = Dc[r * HDIM + d];
          block_dp<HDIM>(dor, Vb, mw, nk, keep_t, rscale, lane, dp);
        }
        const float m = ms[i], l = ls[i], c = cs[i];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int jj = lane + 32 * t;
          float pd = 0.f, ds = 0.f;
          if (jj < nk) {
            const float p = expf(s[t] - m) / l;
            pd = drop ? (kept(mw, jj, keep_t) ? p * rscale : 0.f) : p;
            ds = p * (dp[t] - c);
          }
          Ps[r * PS + jj] = pd;
          DSs[r * PS + jj] = ds;
        }
        __syncwarp();
      }
      __syncthreads();

      // (B) the key block's dv, dk and bias-gradient sums over the chunk
      for (int jj = warp; jj < nk; jj += kWarps) {
#pragma unroll
        for (int d0 = 0; d0 < HDIM; d0 += 32) {
          const int d = d0 + lane;
          float av = r0 ? dVa[jj * HDIM + d] : 0.f;
          float ak = r0 ? dKa[jj * HDIM + d] : 0.f;
          for (int r = 0; r < nr; ++r) {
            av = fmaf(Ps[r * PS + jj], Dc[r * HDIM + d], av);
            ak = fmaf(DSs[r * PS + jj], Qc[r * HDIM + d], ak);
          }
          dVa[jj * HDIM + d] = av;
          dKa[jj * HDIM + d] = ak;
        }
        const float db = warp_sum(lane < nr ? DSs[lane * PS + jj] : 0.f);
        if (lane == 0) dBa[jj] = (r0 ? dBa[jj] : 0.f) + db;
      }
      // (C) dq of the chunk's rows: += ds K, in the fp32 buffer
      for (int r = warp; r < nr; r += kWarps) {
        float* qrow = q32 + (long long)(r0 + r) * HDIM;
#pragma unroll
        for (int d0 = 0; d0 < HDIM; d0 += 32) {
          const int d = d0 + lane;
          float acc = 0.f;
          for (int jj = 0; jj < nk; ++jj) acc = fmaf(DSs[r * PS + jj], Kb[jj * KS + d], acc);
          qrow[d] = j0 ? qrow[d] + acc : acc;
        }
      }
      __syncthreads();
    }
    for (int jj = warp; jj < nk; jj += kWarps) {
      const long long row = base + (long long)(j0 + jj) * lay.row;
#pragma unroll
      for (int d0 = 0; d0 < HDIM; d0 += 32) {
        const int d = d0 + lane;
        store(dv + row + d, dVa[jj * HDIM + d]);
        store(dk + row + d, dKa[jj * HDIM + d] * scale);
      }
      if (lane == 0) dbias_heads[((long long)b * H + h) * S + j0 + jj] = dBa[jj];
    }
  }
  __syncthreads();
  for (int i = warp; i < S; i += kWarps) {
    const long long row = base + (long long)i * lay.row;
#pragma unroll
    for (int d0 = 0; d0 < HDIM; d0 += 32)
      store(dq + row + d0 + lane, q32[(long long)i * HDIM + d0 + lane] * scale);
  }
}

template <typename K>
cudaError_t set_smem(K kern, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  return cudaSuccess;
}

inline float inv_sqrt(int hd) { return (float)(1.0 / sqrt((double)hd)); }

// blocked = 1: the key-blocked forward.
template <typename T, int HDIM>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const float* bias,
                       void* out, int B, int S, int H, Layout lay, int keep_t,
                       float rscale, uint64_t seed, cudaStream_t st, int blocked) {
  const size_t smem =
      (blocked ? fwd_blocked_smem_floats(S, HDIM) : fwd_smem_floats(S, HDIM)) * sizeof(float);
  auto kern = blocked ? fwd_blocked_kernel<T, HDIM> : fwd_kernel<T, HDIM>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(H, B), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<T*>(out), S, lay, inv_sqrt(HDIM), keep_t, rscale, seed);
  return cudaGetLastError();
}

// dq32 != nullptr: the key-blocked backward, with dq32 its float32
// [B, H, S, hd] dq buffer.
template <typename T, int HDIM>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const float* bias,
                       const void* dout, void* dq, void* dk, void* dv, float* dbh,
                       int B, int S, int H, Layout lay, int keep_t, float rscale,
                       uint64_t seed, cudaStream_t st, float* dq32) {
  if (dq32) {
    static_assert(kBwdRows == 32, "the bias-gradient sum gives each lane one row");
    const size_t smem = bwd_blocked_smem_floats(S, HDIM) * sizeof(float);
    auto kern = bwd_blocked_kernel<T, HDIM>;
    cudaError_t e = set_smem(kern, smem);
    if (e != cudaSuccess) return e;
    kern<<<dim3(H, B), kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
        static_cast<const T*>(dout), static_cast<T*>(dq), static_cast<T*>(dk),
        static_cast<T*>(dv), dbh, dq32, S, lay, inv_sqrt(HDIM), keep_t, rscale, seed);
    return cudaGetLastError();
  }
  const size_t smem = bwd_smem_floats(S, HDIM) * sizeof(float);
  auto kern = bwd_kernel<T, HDIM>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(H, B), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<const T*>(dout), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), dbh, S, lay, inv_sqrt(HDIM), keep_t, rscale, seed);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd_hd(int hd, const void* q, const void* k, const void* v, const float* bias,
                   void* out, int B, int S, int H, Layout lay, int keep_t, float rscale,
                   uint64_t seed, cudaStream_t st, int blocked) {
  switch (hd) {
    case 32:
      return launch_fwd<T, 32>(q, k, v, bias, out, B, S, H, lay, keep_t, rscale, seed, st,
                               blocked);
    case 64:
      return launch_fwd<T, 64>(q, k, v, bias, out, B, S, H, lay, keep_t, rscale, seed, st,
                               blocked);
    case 128:
      return launch_fwd<T, 128>(q, k, v, bias, out, B, S, H, lay, keep_t, rscale, seed, st,
                                blocked);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t bwd_hd(int hd, const void* q, const void* k, const void* v, const float* bias,
                   const void* dout, void* dq, void* dk, void* dv, float* dbh, int B,
                   int S, int H, Layout lay, int keep_t, float rscale, uint64_t seed,
                   cudaStream_t st, float* dq32) {
  switch (hd) {
    case 32:
      return launch_bwd<T, 32>(q, k, v, bias, dout, dq, dk, dv, dbh, B, S, H, lay, keep_t,
                               rscale, seed, st, dq32);
    case 64:
      return launch_bwd<T, 64>(q, k, v, bias, dout, dq, dk, dv, dbh, B, S, H, lay, keep_t,
                               rscale, seed, st, dq32);
    case 128:
      return launch_bwd<T, 128>(q, k, v, bias, dout, dq, dk, dv, dbh, B, S, H, lay, keep_t,
                                rscale, seed, st, dq32);
    default: return cudaErrorInvalidValue;
  }
}

// Shared memory (bytes) of one block of the forward (backward = 0) or the
// backward (backward = 1) at (S, hd). The caller takes the key-blocked
// variant (blocked = 1) where the all-keys kernel's shared memory does not
// fit one block.
inline long long smem_bytes(int S, int hd, int backward, int blocked = 0) {
  const long long f = backward ? (blocked ? bwd_blocked_smem_floats(S, hd) : bwd_smem_floats(S, hd))
                               : (blocked ? fwd_blocked_smem_floats(S, hd) : fwd_smem_floats(S, hd));
  return f * (long long)sizeof(float);
}

}  // namespace
}  // namespace attn_train
