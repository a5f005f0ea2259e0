// bf16 training attention for Hopper (sm_90a) on tensor cores: the forward
// and backward device code, one kernel each for every S, of three layouts
// in bf16: B3 (blocked_attention_train.cu, head-major [B, H, S, hd]), B1
// (flat_attention_train.cu, [B, S, H*hd]) and B5
// (smajor_attention_train.cu, [S, B, H*hd]). Each forward saves the row
// statistics and keep bits that its backward reads; those buffers are
// indexed by (b*H + h) whatever the layout. The operand strides are
// attention_train.cuh's Layout, so on the same values the three layouts give
// the same bits; fp32 keeps that header's kernels.
//
// Replaces, in bf16, the TPU kernels of clg_vqa_tpu/ops/attention.py:
// _train_fwd_kernel (:209-220) and _train_bwd_kernel (:223-263), with
// _probs (:197-206) (B3); _flat_fwd_kernel and _flat_bwd_kernel (:385-459,
// B1); _sm_fwd_kernel and _sm_bwd_kernel (:1082-1144, B5). Per (b, h):
//   s = (q k^T) * (1/sqrt(hd)) + bias in fp32; p a max-subtracted fp32
//   softmax, normalised before dropout; p_d = keep ? p * 256/t : 0;
//   o = p_d v with an fp32 accumulator, cast once to bf16;
//   dv = p_d^T do; dp = keep ? (do v^T) * 256/t : 0; D = sum_j dp p;
//   ds = p (dp - D); dq = (ds k) / sqrt(hd); dk = (ds^T q) / sqrt(hd); the
//   per-head bias gradient sum_i ds as float32 [B, H, S], which the caller
//   sums over heads in a fixed order.
// The keep bits are attention_train.cuh's: Philox4x32-10 keyed by the seed,
// counter (key column / 16, query row, head, sample), key column j kept where
// byte j % 16 of the call's 16 bytes is below t. So the mask equals B1's and
// ops/attention.py:dropout_keep_mask.
//
// What bounds it on the H100: at M3P training (B 128, S 140, 12 heads of 64)
// the forward moves 110 MB (0.033 ms at 3.35 TB/s) against 7.7 GFLOP, the
// backward 193 MB (0.058 ms) against 19.3 GFLOP: 70 and 100 operations per
// byte, under the 295 at which bf16 tensor cores become the limit, so the
// bound is the bytes. At UC2 training (B 128, S 76, 12 heads of 64; B1 flat
// or B5 S-major, whose strides move the same bytes) the forward moves
// 59.8 MB (0.0179 ms) against 2.27 GFLOP and the backward 104.7 MB
// (0.0312 ms) against 5.68 GFLOP: 38 and 54 operations per byte, bound by
// the bytes too. What holds the kernels above it is their instruction
// stream, as in attention_eval.cuh: mma.sync products (the forward runs 3
// products of S x S x hd per head, 1 of them a lo half below; the backward
// 10, 3 of them lo halves), the per-element softmax and dropout work and the
// copies' addresses.
//
// Precision. Products of bf16 inputs are exact and accumulate in fp32, so
// s, dp and D differ from the plain version in the order of fp32 sums only.
// The operands rounded to bf16 for a product are split in two where one
// rounding would miss the gates: p_d (P.V, dv) and ds (dk, dq) go in as
// hi = bf16(x) and lo = bf16(x - hi), two products into one fp32
// accumulator, ~16 bits of x. D is the exact sum_j dp p, not rowsum(do * o)
// from the bf16 output, which misses the bias gradient's tolerance.
//
// Forward: attention_eval.cuh's design, one block per (head, sample), each
// warp 16 query rows (Q fragments in registers), K, V streamed through a
// cp.async ring of 32-key tiles, a running max. The row sum l adds the
// undropped exp(s - m) (the softmax normalises before dropout); P.V takes
// the dropped and rescaled values, hi and lo; o / l at the end. For its
// backward it also writes each row's max m and 1/l (float32
// [B, H, S, 2], 1.7 MB at B 128, S 140, 12 heads) and, with dropout, each
// Philox call's 16 keep bits (uint16 [B, H, S, S/16], 3.9 MB there).
//
// Backward, one block per (head, sample), W warps, no cross-block sum and no
// float atomics (FlashAttention-2's backward, Dao 2023, in a fixed order),
// the forward's m, 1/l and keep bits read rather than made again:
//  1. D, query-major: each warp owns a 16-row query tile and walks the
//     32-key tiles of a ring, forming s (Q K^T) and dp (dO V^T) by mma,
//     p = exp(s - m) / l and D = sum_j dp p, written to shared memory ([S]
//     fp32, beside m and 1/l).
//  2. key-major: the keys go in chunks of W 16-key tiles, one a warp, whose
//     dk and dv accumulate in registers while 32-row query tiles stream
//     through a cp.async ring. Per query tile a warp recomputes s^T = K Q^T
//     and p, forms dp^T = V dO^T and ds, adds p_d^T dO into dv and ds^T Q
//     into dk (hi and lo), ds's row sums into its keys' bias gradient, and
//     writes ds^T (hi and lo, bf16 pairs) into one of two shared tiles.
//     After the next block barrier, one a query tile, the warps share out
//     dq of that tile = ds K over the chunk's keys by 8-column tiles (A
//     fragments by ldmatrix.trans), each summing its keys in order: one
//     chunk (S <= 16 W) writes dq directly, more chunks add into a float32
//     [B, H, S, hd] buffer that only this block touches.
// The Philox words: a call serves 16 keys of one query row. In the forward
// the 4 lanes of a quad hold 2 rows x 2 groups of a 32-key tile, so each
// lane makes (and, for the backward, stores) one call and passes its 16
// keep bits by shfl; pass 1 reads them in the same way, pass 2 by query
// column. A row whose keys so far are all -inf contributes 0, not NaN.
// Shared memory grows with S only by four [S] fp32 vectors.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_eval.cuh"
#include "attention_train.cuh"
#include "mma_tools.cuh"

namespace attn_train_mma {
namespace {

using bf16 = __nv_bfloat16;
using attn_eval::cp_async4;
using attn_eval::exp2_sfu;
using attn_eval::kLog2e;
using attn_eval::split;
using attn_train::Layout;

constexpr int kKeys = 32;        // keys per ring tile (forward, backward pass 1)
constexpr int kStages = 4;       // the key ring: three tiles in flight
constexpr int kQStages = 3;      // the query ring of the key-major pass
constexpr int kFwdWarps = 5;     // the forward's warps a block at most
constexpr int kFwdMinBlocks = 3; // forward blocks an SM the registers are cut for (hd <= 64)
constexpr int kQT = 32;          // queries per step of the backward's key-major pass
constexpr int kLT = kQT + 8;     // row stride (elements) of its ds^T tiles

__host__ __device__ constexpr int tiles16(int S) { return (S + 15) / 16; }
__host__ __device__ constexpr int round32(int S) { return (S + 31) / 32 * 32; }

// Forward: as attention_eval.cuh, ceil(tiles / 5) passes of equal width.
__host__ __device__ constexpr int fwd_passes(int S) {
  return (tiles16(S) + kFwdWarps - 1) / kFwdWarps;
}
__host__ __device__ constexpr int fwd_warps(int S) {
  return (tiles16(S) + fwd_passes(S) - 1) / fwd_passes(S);
}
__host__ __device__ constexpr long long fwd_smem_bytes(int S, int hdim) {
  return (2LL * kStages * kKeys + 16LL * fwd_warps(S)) * (hdim + 8) * (long long)sizeof(bf16) +
         (long long)kStages * kKeys * (long long)sizeof(float);
}

// Backward: W warps, the key tiles in ceil(tiles / max) chunks of equal
// width; pass 1 covers the query tiles in as many passes. Up to 10 warps
// (S <= 160 in one chunk) at hd <= 64, where 168 registers a thread do;
// hd 128's dk and dv accumulators need up to 255, so 8 warps.
__host__ __device__ constexpr int bwd_max_warps(int hdim) { return hdim == 128 ? 8 : 10; }
__host__ __device__ constexpr int bwd_chunks(int S, int hdim) {
  return (tiles16(S) + bwd_max_warps(hdim) - 1) / bwd_max_warps(hdim);
}
__host__ __device__ constexpr int bwd_warps(int S, int hdim) {
  return (tiles16(S) + bwd_chunks(S, hdim) - 1) / bwd_chunks(S, hdim);
}
__host__ __device__ constexpr long long cmax(long long a, long long b) { return a > b ? a : b; }
// Four fp32 [S] vectors (bias, m, 1/l, D; padded to 32), then one region
// that the two passes share: (1) the K and V ring and the Q and dO rows of
// a pass; (2) the K and V chunk, the Q and dO ring and two query tiles' ds^T,
// hi and lo. lo: dO also comes as a second bf16 term (the dO rows and ring
// twice).
__host__ __device__ constexpr long long bwd_smem_bytes(int S, int hdim, bool lo = false) {
  return 4LL * round32(S) * (long long)sizeof(float) +
         cmax((2LL * kStages * kKeys + (lo ? 48LL : 32LL) * bwd_warps(S, hdim)) * (hdim + 8),
              (32LL * bwd_warps(S, hdim) + (lo ? 3LL : 2LL) * kQStages * kQT) * (hdim + 8) +
                  4LL * 16 * bwd_warps(S, hdim) * kLT) *
             (long long)sizeof(bf16);
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// The 16 keep bits of the Philox call for key columns 16 g .. 16 g + 15 of
// query row i: bit x is column 16 g + x (keep_t < 256).
__device__ __forceinline__ uint32_t keep16(int g, int i, int h, int b, uint64_t seed,
                                           int keep_t) {
  uint32_t c[4] = {(uint32_t)g, (uint32_t)i, (uint32_t)h, (uint32_t)b};
  attn_train::philox(c, (uint32_t)seed, (uint32_t)(seed >> 32));
  const uint32_t t4 = (uint32_t)keep_t * 0x01010101u;
  uint32_t m = 0;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    // bytes below t -> 0xff; the four top bits gathered into bits 28..31
    const uint32_t lt = __vcmpltu4(c[w], t4) & 0x80808080u;
    m |= ((lt * 0x00204081u) >> 28) << (4 * w);
  }
  return m;
}

// The keep bits of a quad's 32-key tile (the forward): lane
// t4 of the quad makes the call of row g + 8 (t4 & 1), group 2 t + (t4 >> 1),
// and km[kk][r] receives the bits of group kk, row g + 8 r.
// With words != null the lane also stores its call's bits at
// words[row * G + group] for the backward, G the 16-key groups of S.
__device__ __forceinline__ void quad_keep(uint32_t (&km)[2][2], int j0, int row0, int lane,
                                          int h, int b, uint64_t seed, int keep_t, int S,
                                          uint16_t* words = nullptr) {
  const int g = lane >> 2, t4 = lane & 3;
  const int grp = (j0 >> 4) + (t4 >> 1), row = row0 + g + 8 * (t4 & 1);
  const uint32_t mine = keep16(grp, row, h, b, seed, keep_t);
  if (words != nullptr && row < S && 16 * grp < S) words[row * tiles16(S) + grp] = (uint16_t)mine;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      km[kk][r] = __shfl_sync(0xffffffffu, mine, (lane & ~3) | (kk << 1) | r);
}

// Copies: thread tid moves the 16-byte chunk d0 of rows r0, r0 + rs, ... of
// a tile of `rows` rows starting at row j0 (zero fill past S), its addresses
// stepped rather than recomputed.
template <int HDIM>
struct Copier {
  static constexpr int LD = HDIM + 8, CH = HDIM / 8;
  int d0, r0, rs;
  long long grs;
  __device__ Copier(int tid, int nthreads, Layout lay)
      : d0((tid % CH) * 8), r0(tid / CH), rs(nthreads / CH),
        grs((long long)(nthreads / CH) * lay.row) {}
  __device__ __forceinline__ void rows(bf16* dst, const bf16* src, int j0, int nrows, int S,
                                       Layout lay) const {
    const bf16* p = src + (long long)(j0 + r0) * lay.row + d0;
    bf16* d = dst + r0 * LD + d0;
    for (int r = r0; r < nrows; r += rs, d += rs * LD, p += grs) {
      const bool ok = j0 + r < S;
      cp_async16(d, ok ? p : src, ok);
    }
  }
};

template <int HDIM>
__global__ void __launch_bounds__(kFwdWarps * 32, HDIM <= 64 ? kFwdMinBlocks : 1)
fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           const float* __restrict__ bias, bf16* __restrict__ out, float* __restrict__ stats,
           uint16_t* __restrict__ words, int S, Layout lay, float scale, int keep_t,
           float rscale, uint64_t seed) {
  constexpr int LD = HDIM + 8, CH = HDIM / 8, DT = HDIM / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nthreads = blockDim.x, rows = nthreads / 2;   // 16 rows a warp
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);           // [kStages][kKeys][LD]
  bf16* Vs = Ks + kStages * kKeys * LD;                   // [kStages][kKeys][LD]
  bf16* Qs = Vs + kStages * kKeys * LD;                   // [rows][LD]
  float* Bs = reinterpret_cast<float*>(Qs + rows * LD);   // [kStages][kKeys]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3, quad = lane >> 3, r8 = lane & 7;
  const int h = blockIdx.x, b = blockIdx.y;
  const long long base = (long long)b * lay.sample + (long long)h * lay.head;
  const bf16* qb = q + base;
  const bf16* kb = k + base;
  const bf16* vb = v + base;
  const float* bb = bias + (long long)b * S;
  const int nkt = (S + kKeys - 1) / kKeys;
  const bool drop = keep_t < 256;
  const Copier<HDIM> cp(tid, nthreads, lay);
  const long long bh = (long long)b * gridDim.x + h;
  float* st = stats ? stats + bh * S * 2 : nullptr;
  uint16_t* kw = words ? words + bh * S * tiles16(S) : nullptr;

  auto load_keys = [&](int t) {
    const int st = t % kStages, j0 = t * kKeys;
    cp.rows(Ks + st * kKeys * LD, kb, j0, kKeys, S, lay);
    cp.rows(Vs + st * kKeys * LD, vb, j0, kKeys, S, lay);
    if (tid < kKeys) {
      const bool ok = j0 + tid < S;
      cp_async4(Bs + st * kKeys + tid, bb + (ok ? j0 + tid : 0), ok);
    }
  };

  for (int p0 = 0; p0 < S; p0 += rows) {
    cp.rows(Qs, qb, p0, rows, S, lay);
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) {
      if (t < nkt) load_keys(t);
      cp_async_commit();
    }

    const int row0 = p0 + warp * 16;
    const bool active = row0 < S;          // uniform across the warp
    bf16* qs = Qs + warp * 16 * LD;
    uint32_t qa[HDIM / 16][4];
    float o[DT][4];
#pragma unroll
    for (int d = 0; d < DT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
    // this lane's part of rows g and g + 8's sums of the undropped exp(s - m)
    float l[2] = {0.f, 0.f};
    float m[2] = {-INFINITY, -INFINITY};

    for (int t = 0; t < nkt; ++t) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      if (t + kStages - 1 < nkt) load_keys(t + kStages - 1);
      cp_async_commit();
      if (!active) continue;
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < HDIM / 16; ++kk)
          ldmatrix_x4(qa[kk], qs + ((quad & 1) * 8 + r8) * LD + kk * 16 + (quad >> 1) * 8);
      }
      const int st = t % kStages, j0 = t * kKeys;
      const bf16* ks = Ks + st * kKeys * LD;
      const bf16* vs = Vs + st * kKeys * LD;
      const float* bs = Bs + st * kKeys;
      const int ng = min(kKeys / 16, (S - j0 + 15) / 16);

      float sc[kKeys / 8][4];
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HDIM / 16; ++kk) {
#pragma unroll
        for (int n = 0; n < kKeys / 16; ++n) {
          if (n >= ng) break;
          uint32_t bq[4];
          ldmatrix_x4(bq, ks + (n * 16 + (quad >> 1) * 8 + r8) * LD + kk * 16 + (quad & 1) * 8);
          mma_bf16(sc[2 * n], qa[kk], bq[0], bq[1]);
          mma_bf16(sc[2 * n + 1], qa[kk], bq[2], bq[3]);
        }
      }
      const bool tail = j0 + kKeys > S;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
        const int c = n * 8 + 2 * t4;
        const float2 bv = *reinterpret_cast<const float2*>(bs + c);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float x0 = fmaf(sc[n][2 * r], scale, bv.x), x1 = fmaf(sc[n][2 * r + 1], scale, bv.y);
          if (tail) {
            x0 = j0 + c < S ? x0 : -INFINITY;
            x1 = j0 + c + 1 < S ? x1 : -INFINITY;
          }
          sc[n][2 * r] = x0;
          sc[n][2 * r + 1] = x1;
          mx[r] = fmaxf(mx[r], fmaxf(x0, x1));
        }
      }
      float mr[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float mn = fmaxf(m[r], mx[r]);
        const float mref = mn == -INFINITY ? 0.f : mn;
        alpha[r] = exp2_sfu((m[r] - mref) * kLog2e);
        m[r] = mn;
        mr[r] = mref;
      }
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          o[d][0] *= alpha[0];
          o[d][1] *= alpha[0];
          o[d][2] *= alpha[1];
          o[d][3] *= alpha[1];
        }
        l[0] *= alpha[0];
        l[1] *= alpha[1];
      }
      uint32_t km[2][2];
      if (drop) quad_keep(km, j0, row0, lane, h, b, seed, keep_t, S, kw);

#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        if (kk >= ng) break;
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int n = 2 * kk + (x >> 1), r = x & 1;
          // (s - m) first: exactly 1 at the row's max, as in the backward
          float e0 = exp2_sfu((sc[n][2 * r] - mr[r]) * kLog2e);
          float e1 = exp2_sfu((sc[n][2 * r + 1] - mr[r]) * kLog2e);
          l[r] += e0;
          l[r] += e1;
          if (drop) {
            const int c = (x >> 1) * 8 + 2 * t4;   // column within the group
            e0 = (km[kk][r] >> c) & 1u ? e0 * rscale : 0.f;
            e1 = (km[kk][r] >> (c + 1)) & 1u ? e1 * rscale : 0.f;
          }
          split(e0, e1, hi[x], lo[x]);
        }
#pragma unroll
        for (int n = 0; n < DT / 2; ++n) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv,
                            vs + (kk * 16 + (quad & 1) * 8 + r8) * LD + n * 16 + (quad >> 1) * 8);
          mma_bf16(o[2 * n], hi, bv[0], bv[1]);
          mma_bf16(o[2 * n + 1], hi, bv[2], bv[3]);
          mma_bf16(o[2 * n], lo, bv[0], bv[1]);
          mma_bf16(o[2 * n + 1], lo, bv[2], bv[3]);
        }
      }
    }

    if (active) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const int i = row0 + g + 8 * r;
        if (st && t4 == 0 && i < S) {   // the backward's row statistics
          const bool any = l[r] > 0.f;
          *reinterpret_cast<float2*>(st + 2 * i) =
              make_float2(any ? m[r] : INFINITY, any ? 1.f / l[r] : 0.f);
        }
      }
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        *reinterpret_cast<__nv_bfloat162*>(qs + g * LD + d * 8 + 2 * t4) =
            __floats2bfloat162_rn(o[d][0] / l[0], o[d][1] / l[0]);
        *reinterpret_cast<__nv_bfloat162*>(qs + (g + 8) * LD + d * 8 + 2 * t4) =
            __floats2bfloat162_rn(o[d][2] / l[1], o[d][3] / l[1]);
      }
      __syncwarp();
      bf16* ob = out + base;
      for (int c = lane; c < 16 * CH; c += 32) {
        const int r = c / CH, d = (c % CH) * 8;
        if (row0 + r < S)
          *reinterpret_cast<uint4*>(ob + (long long)(row0 + r) * lay.row + d) =
              *reinterpret_cast<const uint4*>(qs + r * LD + d);
      }
    }
    __syncthreads();
  }
}

// LO: dO comes as two bf16 terms, dout + dout_lo (B4's fp32 dctx), and each
// product that reads dO is issued again with the lo term into the same
// accumulators: dp = dO V^T (pass 1), dp^T = V dO^T and dv += p_d^T dO
// (pass 2; the lo half of p_d is not taken against the lo term, a
// 2^-16-relative part). Without LO the code is the one-term kernel.
template <int HDIM, bool LO = false>
__global__ void __launch_bounds__(bwd_max_warps(HDIM) * 32)
bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           const float* __restrict__ bias, const bf16* __restrict__ dout,
           const bf16* __restrict__ dout_lo, bf16* __restrict__ dq,
           bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ dbias_heads,
           float* __restrict__ dq32, const float* __restrict__ stats,
           const uint16_t* __restrict__ keep_words, int S, Layout lay, float scale, int keep_t,
           float rscale) {
  constexpr int LD = HDIM + 8, DT = HDIM / 8, KT = HDIM / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nthreads = blockDim.x, W = nthreads / 32, rows = 16 * W;
  const int Sp = round32(S);
  float* Bs = reinterpret_cast<float*>(smem_raw);   // [Sp] key bias
  float* Ms = Bs + Sp;                              // [Sp] row max m (+inf where l = 0)
  float* Rs = Ms + Sp;                              // [Sp] 1 / l (0 where l = 0)
  float* Ds = Rs + Sp;                              // [Sp] D = sum_j dp p (0 where l = 0)
  bf16* U = reinterpret_cast<bf16*>(Ds + Sp);       // the region the passes share

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3, quad = lane >> 3, r8 = lane & 7;
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  const long long base = (long long)b * lay.sample + (long long)h * lay.head;
  const bf16* qb = q + base;
  const bf16* kb = k + base;
  const bf16* vb = v + base;
  const bf16* ob = dout + base;
  const bf16* ol = LO ? dout_lo + base : nullptr;
  const bool drop = keep_t < 256;
  const Copier<HDIM> cp(tid, nthreads, lay);
  // the forward's row statistics; keys past S get bias -inf and rows past
  // S m = +inf, 1/l = 0, D = 0, so both passes give them p = 0 and ds = 0
  // without a test
  const float* st = stats + ((long long)b * H + h) * S * 2;
  for (int j = tid; j < Sp; j += nthreads) {
    Bs[j] = j < S ? bias[(long long)b * S + j] : -INFINITY;
    const float2 nr = j < S ? *reinterpret_cast<const float2*>(st + 2 * j)
                            : make_float2(INFINITY, 0.f);
    Ms[j] = nr.x;
    Rs[j] = nr.y;
    Ds[j] = 0.f;
  }
  __syncthreads();
  // this block's keep words [S][G] (dropout only), from the forward
  const int G = tiles16(S);
  const uint16_t* words = drop ? keep_words + ((long long)b * H + h) * S * G : nullptr;

  // ---- 1. D = sum_j dp p, query-major ----
  {
    bf16* Kr = U;                        // [kStages][kKeys][LD]
    bf16* Vr = Kr + kStages * kKeys * LD;
    bf16* Qr = Vr + kStages * kKeys * LD;  // [rows][LD]
    bf16* Or = Qr + rows * LD;             // [rows][LD]
    bf16* Ol = Or + rows * LD;             // LO: [rows][LD]
    const int nkt = (S + kKeys - 1) / kKeys;
    for (int p0 = 0; p0 < S; p0 += rows) {
      cp.rows(Qr, qb, p0, rows, S, lay);
      cp.rows(Or, ob, p0, rows, S, lay);
      if (LO) cp.rows(Ol, ol, p0, rows, S, lay);
#pragma unroll
      for (int t = 0; t < kStages - 1; ++t) {
        if (t < nkt) {
          cp.rows(Kr + t * kKeys * LD, kb, t * kKeys, kKeys, S, lay);
          cp.rows(Vr + t * kKeys * LD, vb, t * kKeys, kKeys, S, lay);
        }
        cp_async_commit();
      }
      const int row0 = p0 + warp * 16;
      const bool active = row0 < S;
      uint32_t qa[KT][4], da[KT][4];
      // rows g and g + 8: m, 1/l and this lane's part of D
      float mr[2], ri[2], D[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mr[r] = active ? Ms[row0 + g + 8 * r] : 0.f;
        ri[r] = active ? Rs[row0 + g + 8 * r] : 0.f;
      }
      for (int t = 0; t < nkt; ++t) {
        cp_async_wait<kStages - 2>();
        __syncthreads();
        const int tn = t + kStages - 1;
        if (tn < nkt) {
          cp.rows(Kr + (tn % kStages) * kKeys * LD, kb, tn * kKeys, kKeys, S, lay);
          cp.rows(Vr + (tn % kStages) * kKeys * LD, vb, tn * kKeys, kKeys, S, lay);
        }
        cp_async_commit();
        if (!active) continue;
        if (t == 0) {
#pragma unroll
          for (int kk = 0; kk < KT; ++kk) {
            const int off = (warp * 16 + (quad & 1) * 8 + r8) * LD + kk * 16 + (quad >> 1) * 8;
            ldmatrix_x4(qa[kk], Qr + off);
            ldmatrix_x4(da[kk], Or + off);
          }
        }
        const int st4 = t % kStages, j0 = t * kKeys;
        const bf16* ks = Kr + st4 * kKeys * LD;
        const bf16* vs = Vr + st4 * kKeys * LD;
        const int ng = min(kKeys / 16, (S - j0 + 15) / 16);
        // the keep bits of rows g + 8 r, groups 2 t + kk: lane t4 of the
        // quad loads one word and passes it on
        uint32_t km[2][2];
        if (drop) {
          const int grp = (j0 >> 4) + (t4 >> 1), row = row0 + g + 8 * (t4 & 1);
          const uint32_t mine = row < S && grp < G ? words[row * G + grp] : 0u;
#pragma unroll
          for (int kk = 0; kk < 2; ++kk)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              km[kk][r] = __shfl_sync(0xffffffffu, mine, (lane & ~3) | (kk << 1) | r);
        }
        float sc[kKeys / 8][4], dp[kKeys / 8][4];
#pragma unroll
        for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
          for (int x = 0; x < 4; ++x) sc[n][x] = dp[n][x] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          // LO: the lo term's fragment, read here rather than kept
          uint32_t dl[4];
          if (LO)
            ldmatrix_x4(dl, Ol + (warp * 16 + (quad & 1) * 8 + r8) * LD + kk * 16 +
                                (quad >> 1) * 8);
#pragma unroll
          for (int n = 0; n < kKeys / 16; ++n) {
            if (n >= ng) break;
            const int off = (n * 16 + (quad >> 1) * 8 + r8) * LD + kk * 16 + (quad & 1) * 8;
            uint32_t bk[4], bv[4];
            ldmatrix_x4(bk, ks + off);
            ldmatrix_x4(bv, vs + off);
            mma_bf16(sc[2 * n], qa[kk], bk[0], bk[1]);
            mma_bf16(sc[2 * n + 1], qa[kk], bk[2], bk[3]);
            mma_bf16(dp[2 * n], da[kk], bv[0], bv[1]);
            mma_bf16(dp[2 * n + 1], da[kk], bv[2], bv[3]);
            if (LO) {
              mma_bf16(dp[2 * n], dl, bv[0], bv[1]);
              mma_bf16(dp[2 * n + 1], dl, bv[2], bv[3]);
            }
          }
        }
#pragma unroll
        for (int n = 0; n < kKeys / 8; ++n) {
          if (n >= 2 * ng) break;
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int r = x >> 1, cc = (n & 1) * 8 + 2 * t4 + (x & 1);
            const float s = fmaf(sc[n][x], scale, Bs[j0 + n * 8 + 2 * t4 + (x & 1)]);
            const float p = exp2_sfu((s - mr[r]) * kLog2e) * ri[r];
            float d = dp[n][x];
            if (drop) d = (km[n >> 1][r] >> cc) & 1u ? d * rscale : 0.f;
            D[r] = fmaf(d, p, D[r]);
          }
        }
      }
      if (active) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          D[r] += __shfl_xor_sync(0xffffffffu, D[r], 1);
          D[r] += __shfl_xor_sync(0xffffffffu, D[r], 2);
          const int i = row0 + g + 8 * r;
          if (t4 == 0 && i < Sp) Ds[i] = D[r];
        }
      }
      __syncthreads();   // the next pass's copies overwrite the Q and dO rows
    }
  }

  // ---- 2. key-major ----
  bf16* Kc = U;                          // [rows][LD]: the chunk's keys
  bf16* Vc = Kc + rows * LD;
  bf16* Qq = Vc + rows * LD;             // [kQStages][kQT][LD]
  bf16* Oq = Qq + kQStages * kQT * LD;
  bf16* Olq = Oq + kQStages * kQT * LD;  // LO: the lo term's ring
  bf16* Ts = Olq + (LO ? kQStages * kQT * LD : 0);   // [2][hi, lo][rows][kLT]: ds^T of two query tiles
  const int nqt = (S + kQT - 1) / kQT;
  const bool chunked = rows < S;         // dq summed over chunks in dq32
  float* q32 = chunked ? dq32 + ((long long)b * H + h) * S * HDIM : nullptr;
  for (int c0 = 0; c0 < S; c0 += rows) {
    const int nkc = min(rows, S - c0);
    const bool first = c0 == 0, last = c0 + rows >= S;
    cp.rows(Kc, kb, c0, rows, S, lay);
    cp.rows(Vc, vb, c0, rows, S, lay);
#pragma unroll
    for (int t = 0; t < kQStages - 1; ++t) {
      if (t < nqt) {
        cp.rows(Qq + t * kQT * LD, qb, t * kQT, kQT, S, lay);
        cp.rows(Oq + t * kQT * LD, ob, t * kQT, kQT, S, lay);
        if (LO) cp.rows(Olq + t * kQT * LD, ol, t * kQT, kQT, S, lay);
      }
      cp_async_commit();
    }
    const int j0 = c0 + warp * 16;       // the warp's first key
    const bool kactive = j0 < S;
    float adv[DT][4], adk[DT][4], db[2] = {0.f, 0.f};
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int x = 0; x < 4; ++x) adv[d][x] = adk[d][x] = 0.f;
    // the warp's two key rows' bias
    const float bk0 = Bs[min(j0 + g, Sp - 1)], bk1 = Bs[min(j0 + g + 8, Sp - 1)];
    const int kdq = (nkc + 15) / 16;     // the chunk's key tiles with a key < S

    // dq of query tile tq over the chunk's keys, from ds^T in buffer tq & 1:
    // warps take 8-column tiles; per 16 queries hi and lo sum in two chains,
    // added last
    auto dq_tile = [&](int tq) {
      const bf16* th = Ts + (tq & 1) * 2 * rows * kLT;
      const bf16* tl = th + rows * kLT;
      for (int nt = warp; nt < DT; nt += W) {
        float ah[kQT / 16][4], al[kQT / 16][4];
#pragma unroll
        for (int m = 0; m < kQT / 16; ++m)
#pragma unroll
          for (int x = 0; x < 4; ++x) ah[m][x] = al[m][x] = 0.f;
        for (int kk = 0; kk < kdq; ++kk) {
          uint32_t bk[2];
          ldmatrix_x2_trans(bk, Kc + (kk * 16 + (lane & 15)) * LD + nt * 8);
#pragma unroll
          for (int m = 0; m < kQT / 16; ++m) {
            const int off = (kk * 16 + (quad >> 1) * 8 + r8) * kLT + m * 16 + (quad & 1) * 8;
            uint32_t fh[4], fl[4];
            ldmatrix_x4_trans(fh, th + off);
            ldmatrix_x4_trans(fl, tl + off);
            mma_bf16(ah[m], fh, bk[0], bk[1]);
            mma_bf16(al[m], fl, bk[0], bk[1]);
          }
        }
#pragma unroll
        for (int m = 0; m < kQT / 16; ++m) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = tq * kQT + m * 16 + g + 8 * r, d = nt * 8 + 2 * t4;
            if (i >= S) continue;
            float x0 = ah[m][2 * r] + al[m][2 * r], x1 = ah[m][2 * r + 1] + al[m][2 * r + 1];
            if (chunked) {
              float2* p32 = reinterpret_cast<float2*>(q32 + (long long)i * HDIM + d);
              if (!first) {
                const float2 prev = *p32;
                x0 = prev.x + x0;
                x1 = prev.y + x1;
              }
              if (!last) {
                *p32 = make_float2(x0, x1);
                continue;
              }
            }
            *reinterpret_cast<__nv_bfloat162*>(dq + base + (long long)i * lay.row + d) =
                __floats2bfloat162_rn(x0 * scale, x1 * scale);
          }
        }
      }
    };

    for (int t = 0; t < nqt; ++t) {
      cp_async_wait<kQStages - 2>();
      __syncthreads();   // tile t landed; tile t - 1's ds^T written, t - 2's read
      const int tn = t + kQStages - 1;
      if (tn < nqt) {
        cp.rows(Qq + (tn % kQStages) * kQT * LD, qb, tn * kQT, kQT, S, lay);
        cp.rows(Oq + (tn % kQStages) * kQT * LD, ob, tn * kQT, kQT, S, lay);
        if (LO) cp.rows(Olq + (tn % kQStages) * kQT * LD, ol, tn * kQT, kQT, S, lay);
      }
      cp_async_commit();
      const int i0 = t * kQT;
      const bf16* qs = Qq + (t % kQStages) * kQT * LD;
      const bf16* os = Oq + (t % kQStages) * kQT * LD;
      const bf16* ls = Olq + (t % kQStages) * kQT * LD;
      if (kactive) {
        // the keep bits of the warp's 16 keys for this lane's 8 queries
        // (n * 8 + 2 t4 + e), from pass 1
        uint32_t kq[kQT / 8][2];
#pragma unroll
        for (int n = 0; n < kQT / 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = i0 + n * 8 + 2 * t4 + e;
            kq[n][e] = drop && i < S ? words[i * G + (j0 >> 4)] : 0xffffu;
          }
        // s^T = K Q^T and dp^T = V dO^T: rows are the warp's keys (g, g + 8),
        // columns the tile's queries (n * 8 + 2 t4 + e)
        float sT[kQT / 8][4], pT[kQT / 8][4];
#pragma unroll
        for (int n = 0; n < kQT / 8; ++n)
#pragma unroll
          for (int x = 0; x < 4; ++x) sT[n][x] = pT[n][x] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          // the warp's K and V fragments, re-read from shared memory each
          // tile (kept in registers they cost spills)
          uint32_t ka[4], va[4];
          {
            const int off = (warp * 16 + (quad & 1) * 8 + r8) * LD + kk * 16 + (quad >> 1) * 8;
            ldmatrix_x4(ka, Kc + off);
            ldmatrix_x4(va, Vc + off);
          }
#pragma unroll
          for (int m = 0; m < kQT / 16; ++m) {
            const int off = (m * 16 + (quad >> 1) * 8 + r8) * LD + kk * 16 + (quad & 1) * 8;
            uint32_t bq[4], bo[4];
            ldmatrix_x4(bq, qs + off);
            ldmatrix_x4(bo, os + off);
            mma_bf16(sT[2 * m], ka, bq[0], bq[1]);
            mma_bf16(sT[2 * m + 1], ka, bq[2], bq[3]);
            mma_bf16(pT[2 * m], va, bo[0], bo[1]);
            mma_bf16(pT[2 * m + 1], va, bo[2], bo[3]);
            if (LO) {
              uint32_t bl[4];
              ldmatrix_x4(bl, ls + off);
              mma_bf16(pT[2 * m], va, bl[0], bl[1]);
              mma_bf16(pT[2 * m + 1], va, bl[2], bl[3]);
            }
          }
        }
        // p_d^T into sT, ds^T into pT
#pragma unroll
        for (int n = 0; n < kQT / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = i0 + n * 8 + 2 * t4 + e;
            const float mi = Ms[i], ri = Rs[i], Di = Ds[i];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int x = 2 * r + e, kr = g + 8 * r;
              // 0 for keys and rows past S and rows with no finite score
              const float s = fmaf(sT[n][x], scale, r ? bk1 : bk0);
              const float p = exp2_sfu((s - mi) * kLog2e) * ri;
              float pd = p, d = pT[n][x];
              if (drop) {
                const bool keep = (kq[n][e] >> kr) & 1u;
                pd = keep ? p * rscale : 0.f;
                d = keep ? d * rscale : 0.f;
              }
              const float ds = p * (d - Di);
              db[r] += ds;
              sT[n][x] = pd;
              pT[n][x] = ds;
            }
          }
        }
        bf16* th = Ts + (t & 1) * 2 * rows * kLT;
#pragma unroll
        for (int m = 0; m < kQT / 16; ++m) {
          // A fragments of the [16 keys, 16 queries] tile m, hi and lo;
          // fragment x holds key row g + 8 (x & 1), queries m * 16 +
          // (x >> 1) * 8 + 2 t4, + 1
          uint32_t ph[4], pl[4], sh[4], sl[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int n = 2 * m + (x >> 1), r = x & 1;
            split(sT[n][2 * r], sT[n][2 * r + 1], ph[x], pl[x]);
            split(pT[n][2 * r], pT[n][2 * r + 1], sh[x], sl[x]);
          }
          // dv += p_d^T dO, dk += ds^T Q over the tile's 16 queries
#pragma unroll
          for (int n = 0; n < DT / 2; ++n) {
            const int off = (m * 16 + (quad & 1) * 8 + r8) * LD + n * 16 + (quad >> 1) * 8;
            uint32_t bo[4], bq[4];
            ldmatrix_x4_trans(bo, os + off);
            ldmatrix_x4_trans(bq, qs + off);
            mma_bf16(adv[2 * n], ph, bo[0], bo[1]);
            mma_bf16(adv[2 * n + 1], ph, bo[2], bo[3]);
            mma_bf16(adv[2 * n], pl, bo[0], bo[1]);
            mma_bf16(adv[2 * n + 1], pl, bo[2], bo[3]);
            if (LO) {
              uint32_t bl[4];
              ldmatrix_x4_trans(bl, ls + off);
              mma_bf16(adv[2 * n], ph, bl[0], bl[1]);
              mma_bf16(adv[2 * n + 1], ph, bl[2], bl[3]);
            }
            mma_bf16(adk[2 * n], sh, bq[0], bq[1]);
            mma_bf16(adk[2 * n + 1], sh, bq[2], bq[3]);
            mma_bf16(adk[2 * n], sl, bq[0], bq[1]);
            mma_bf16(adk[2 * n + 1], sl, bq[2], bq[3]);
          }
          // ds^T (rows = the warp's keys) into buffer t & 1, as bf16 pairs
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int o = (warp * 16 + g + 8 * (x & 1)) * kLT + m * 16 + (x >> 1) * 8 + 2 * t4;
            *reinterpret_cast<uint32_t*>(th + o) = sh[x];
            *reinterpret_cast<uint32_t*>(th + rows * kLT + o) = sl[x];
          }
        }
      }
      if (t > 0) dq_tile(t - 1);
    }
    __syncthreads();     // the last tile's ds^T written
    dq_tile(nqt - 1);

    if (kactive) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        db[r] += __shfl_xor_sync(0xffffffffu, db[r], 1);
        db[r] += __shfl_xor_sync(0xffffffffu, db[r], 2);
        const int j = j0 + g + 8 * r;
        if (j >= S) continue;
        if (t4 == 0) dbias_heads[((long long)b * H + h) * S + j] = db[r];
        const long long row = base + (long long)j * lay.row;
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          const int col = d * 8 + 2 * t4;
          *reinterpret_cast<__nv_bfloat162*>(dv + row + col) =
              __floats2bfloat162_rn(adv[d][2 * r], adv[d][2 * r + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dk + row + col) =
              __floats2bfloat162_rn(adk[d][2 * r] * scale, adk[d][2 * r + 1] * scale);
        }
      }
    }
    __syncthreads();   // the next chunk's copies overwrite K, V and the rings
  }
}

template <int HDIM>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const float* bias, void* out,
                       float* stats, uint16_t* words, int B, int S, int H, Layout lay, int keep_t,
                       float rscale, uint64_t seed, cudaStream_t st) {
  const size_t smem = fwd_smem_bytes(S, HDIM);
  auto kern = fwd_kernel<HDIM>;
  cudaError_t e = attn_train::set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(H, B), 32 * fwd_warps(S), smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      bias, static_cast<bf16*>(out), stats, words, S, lay, attn_train::inv_sqrt(HDIM), keep_t,
      rscale, seed);
  return cudaGetLastError();
}

template <int HDIM, bool LO>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const float* bias,
                       const void* dout, const void* dout_lo, const float* stats,
                       const uint16_t* words, void* dq, void* dk, void* dv, float* dbh,
                       float* dq32, int B, int S, int H, Layout lay, int keep_t, float rscale,
                       cudaStream_t st) {
  if (16 * bwd_warps(S, HDIM) < S && dq32 == nullptr) return cudaErrorInvalidValue;
  if (stats == nullptr || (keep_t < 256 && words == nullptr)) return cudaErrorInvalidValue;
  if (LO && dout_lo == nullptr) return cudaErrorInvalidValue;
  const size_t smem = bwd_smem_bytes(S, HDIM, LO);
  auto kern = bwd_kernel<HDIM, LO>;
  cudaError_t e = attn_train::set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(H, B), 32 * bwd_warps(S, HDIM), smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      bias, static_cast<const bf16*>(dout), static_cast<const bf16*>(dout_lo),
      static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), dbh, dq32, stats, words, S, lay, attn_train::inv_sqrt(HDIM),
      keep_t, rscale);
  return cudaGetLastError();
}

// The entry points behind the plain C interface, bf16 operands in layout
// lay, bias float32 [B, S]; S >= 1, hd 32, 64 or 128. Each returns
// cudaGetLastError() (cudaErrorInvalidValue for an hd it does not take).
// lo: the backward that takes dO as two bf16 terms.
inline long long smem_bytes(int S, int hd, int backward, bool lo = false) {
  return backward ? bwd_smem_bytes(S, hd, lo) : fwd_smem_bytes(S, hd);
}

// Whether the backward at (S, hd) sums dq over key chunks in a float32
// [B, H, S, hd] buffer, which the caller then passes as dq32.
inline int needs_dq32(int S, int hd) { return 16 * bwd_warps(S, hd) < S ? 1 : 0; }

template <typename F>
cudaError_t by_hd(int hd, F f) {
  switch (hd) {
    case 32: return f(std::integral_constant<int, 32>());
    case 64: return f(std::integral_constant<int, 64>());
    case 128: return f(std::integral_constant<int, 128>());
    default: return cudaErrorInvalidValue;
  }
}

// The forward writes out and, where the pointers are given, what its
// backward reads: stats, float32 [B, H, S, 2], each row's max m and 1/l
// (+inf and 0 for a row with no finite score), and with dropout words,
// uint16 [B, H, S, ceil(S/16)], each Philox call's 16 keep bits.
inline int forward(const void* q, const void* k, const void* v, const void* bias, void* out,
                   void* stats, void* words, int B, int S, int H, int hd, Layout lay,
                   int keep_t, float rscale, unsigned long long seed, void* stream) {
  return (int)by_hd(hd, [&](auto c) {
    return launch_fwd<decltype(c)::value>(
        q, k, v, static_cast<const float*>(bias), out, static_cast<float*>(stats),
        static_cast<uint16_t*>(words), B, S, H, lay, keep_t, rscale, seed,
        static_cast<cudaStream_t>(stream));
  });
}

// The backward reads the forward's stats and (with dropout) words; dq32 as
// needs_dq32 says, else null. LO: dO is dout + dout_lo, two bf16 terms.
template <bool LO = false>
inline int backward(const void* q, const void* k, const void* v, const void* bias,
                    const void* dout, const void* stats, const void* words, void* dq, void* dk,
                    void* dv, void* dbias_heads, void* dq32, int B, int S, int H, int hd,
                    Layout lay, int keep_t, float rscale, void* stream,
                    const void* dout_lo = nullptr) {
  return (int)by_hd(hd, [&](auto c) {
    return launch_bwd<decltype(c)::value, LO>(
        q, k, v, static_cast<const float*>(bias), dout, dout_lo, static_cast<const float*>(stats),
        static_cast<const uint16_t*>(words), dq, dk, dv, static_cast<float*>(dbias_heads),
        static_cast<float*>(dq32), B, S, H, lay, keep_t, rscale,
        static_cast<cudaStream_t>(stream));
  });
}

}  // namespace
}  // namespace attn_train_mma
