// bf16 eval attention for Hopper (sm_90a) on tensor cores: the device code of
// K1 (flat_attention.cu, [B, S, H*hd] operands) and B2 (blocked_attention.cu,
// head-major [B, H, S, hd]) in bf16, one kernel for every S. The operand
// strides are attention_train.cuh's Layout; fp32 keeps that header's
// kernels.
//
// Replaces, in bf16, the TPU kernels of clg_vqa_tpu/ops/attention.py:
// _flat_fwd_kernel at keep_t = 256 (:385-410, K1) and _attn_kernel
// (:117-132, B2). Per (b, h): s = (q k^T) * (1/sqrt(hd)) + bias in fp32, a
// max-subtracted fp32 softmax, o = p v with an fp32 accumulator, cast once to
// bf16. Keys at index >= S are masked by tile limits and their bias is never
// read; a key with a -inf bias gets probability exactly 0.
//
// What bounds it on the H100: at K1's UC2 eval shape (B 1024, S 76, 12 heads
// of 64) the call moves 478.5 MB (0.143 ms at 3.35 TB/s) against 18.2 GFLOP,
// at B2's M3P shape (S 140) 881.4 MB (0.263 ms) against 61.7 GFLOP: 38 and 70
// operations per byte, far under the 295 at which bf16 tensor cores become
// the limit, so the bound is the bytes. (The fp32 kernel this replaces in
// bf16 ran its products on the CUDA cores and was bound by shared-memory
// loads, about 1.5 four-byte loads per FMA.) What holds this kernel above
// that bound is its instruction stream: mma.sync products (the second P.V
// product doubles P.V's), the softmax's per-element work and the copies'
// address arithmetic, with 20 warps an SM to hide their latencies; the share
// of the bound it reaches falls as S, and so the work per byte, grows
// (PERF.md gives the times).
//
// Design. One block per (head, sample), so a head's K and V are read from
// device memory once where one pass covers S (S <= 80). Each warp owns 16
// query rows, one m16n8k16 A tile, whose Q fragments it loads once into
// registers with ldmatrix. The ceil(S/16) row tiles go to the block's warps
// in ceil(tiles/5) passes of equal width (S 76: 5 warps, one pass; S 140: 5
// warps, two passes, the second re-reading K and V from L2). Each pass
// streams K, V and the bias through shared memory in 32-key tiles, a ring of
// four with three in flight ahead of the one in use, filled by 16-byte
// cp.async copies (4-byte for the bias) with zero fill beyond S; shared rows
// are padded by 16 bytes (a stride of hd + 8 elements), which keeps every
// ldmatrix free of bank conflicts. Per key tile and warp:
//   QK^T by bf16 mma.sync with fp32 accumulators (products of bf16 inputs
//   are exact, so the scores differ from the plain version only in the order
//   of their fp32 sums), then the scale and the bias in fp32; 16-key groups
//   wholly past S are not multiplied;
//   the running row max m, with the accumulators rescaled by exp(m_old -
//   m_new) when it grows; while every key seen so far is -inf, exp is taken
//   against 0, so such a row contributes 0 rather than NaN;
//   p = exp(s - m) on the special-function unit, as exp2 of a log2 e
//   multiple;
//   P.V as two bf16 products into one fp32 accumulator, hi = bf16(p) and
//   lo = bf16(p - hi), V's fragments by ldmatrix.trans: p keeps ~16 bits
//   (rounding p to one bf16 would be softmax_lowp's numerics, which the
//   plain route has and the kernels do not); the row sums l come from the
//   same hi and lo by an mma against ones, so l weighs what the products
//   weigh.
// Epilogue: o / l, one cast to bf16, staged in the warp's Q rows of shared
// memory and written as 16-byte row chunks. Every sum runs in a fixed order,
// so two launches give the same bits.
// No wgmma or TMA: by bytes, the products are a small part of the time (18.2
// GFLOP at a third of 989 TFLOP/s is 0.06 ms, under the 0.143 ms byte
// bound), and a 64-row wgmma tile would waste most of its rows at S = 76.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_train.cuh"
#include "mma_tools.cuh"

namespace attn_eval {
namespace {

using bf16 = __nv_bfloat16;
using attn_train::Layout;

constexpr int kKeys = 32;      // keys per ring tile, one softmax step
constexpr int kStages = 4;     // ring depth: three tiles in flight ahead of the one in use
constexpr int kMaxWarps = 5;   // warps per block, one 16-row tile each per pass
// Blocks per SM the register budget is cut for at hd <= 64: 4 x 5 warps at
// <= 102 registers (hd 128 needs ~170 and takes what it needs).
constexpr int kMinBlocks = 4;

__host__ __device__ constexpr int row_tiles(int S) { return (S + 15) / 16; }
__host__ __device__ constexpr int passes(int S) {
  return (row_tiles(S) + kMaxWarps - 1) / kMaxWarps;
}
// Warps per block at this S (S >= 1): the row tiles spread evenly over the
// passes.
__host__ __device__ constexpr int warps(int S) {
  return (row_tiles(S) + passes(S) - 1) / passes(S);
}

// Shared memory of one block (bytes): the K and V ring, one pass's Q rows
// (16 per warp), the bias ring.
__host__ __device__ constexpr long long smem_bytes(int S, int hdim) {
  return (2LL * kStages * kKeys + 16LL * warps(S)) * (hdim + 8) * (long long)sizeof(bf16) +
         (long long)kStages * kKeys * (long long)sizeof(float);
}

// 4 bytes global -> shared, or 4 zero bytes when !ok.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr uint32_t kOnes = 0x3F803F80u;   // a bf16 pair of ones: the B fragment of row sums

// 2^x on the special-function unit, one instruction; results below 2^-126
// flush to 0, which no sum of probabilities of order 1 can see.
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (p0, p1) as a bf16 pair hi (low half p0) and the pair lo of what hi
// leaves out, each rounded to nearest: hi + lo holds ~16 bits of each p.
__device__ __forceinline__ void split(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
}

template <int HDIM>
__global__ void __launch_bounds__(kMaxWarps * 32, HDIM <= 64 ? kMinBlocks : 1)
fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const float* __restrict__ bias,
           bf16* __restrict__ out, int S, Layout lay, float scale) {
  constexpr int LD = HDIM + 8;    // shared row stride (elements)
  constexpr int CH = HDIM / 8;    // 16-byte chunks per row
  constexpr int DT = HDIM / 8;    // n8 output tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nthreads = blockDim.x, rows = nthreads / 2;   // 16 rows a warp
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);           // [kStages][kKeys][LD]
  bf16* Vs = Ks + kStages * kKeys * LD;                   // [kStages][kKeys][LD]
  bf16* Qs = Vs + kStages * kKeys * LD;                   // [rows][LD]
  float* Bs = reinterpret_cast<float*>(Qs + rows * LD);   // [kStages][kKeys]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3, quad = lane >> 3, r8 = lane & 7;
  const long long base =
      (long long)blockIdx.y * lay.sample + (long long)blockIdx.x * lay.head;
  const bf16* qb = q + base;
  const bf16* kb = k + base;
  const bf16* vb = v + base;
  const float* bb = bias + (long long)blockIdx.y * S;
  const int nkt = (S + kKeys - 1) / kKeys;

  // Copies: thread tid moves the 16-byte chunk d0 of rows r0, r0 + rs, ...
  // of a tile (nthreads is a multiple of 32, hence of CH), its addresses
  // stepped rather than recomputed.
  const int d0 = (tid % CH) * 8, r0 = tid / CH, rs = nthreads / CH;
  const long long grs = (long long)rs * lay.row;

  // Key tile t into ring stage t % kStages: its K and V rows and its bias.
  auto load_keys = [&](int t) {
    const int st = t % kStages, j0 = t * kKeys;
    const long long g0 = (long long)(j0 + r0) * lay.row + d0;
    const bf16* kp = kb + g0;
    const bf16* vp = vb + g0;
    bf16* ks = Ks + (st * kKeys + r0) * LD + d0;
    for (int r = r0; r < kKeys; r += rs, ks += rs * LD, kp += grs, vp += grs) {
      const bool ok = j0 + r < S;
      cp_async16(ks, ok ? kp : kb, ok);
      cp_async16(ks + (Vs - Ks), ok ? vp : vb, ok);
    }
    if (tid < kKeys) {
      const bool ok = j0 + tid < S;
      cp_async4(Bs + st * kKeys + tid, bb + (ok ? j0 + tid : 0), ok);
    }
  };

  for (int p0 = 0; p0 < S; p0 += rows) {
    {
      const bf16* qp = qb + (long long)(p0 + r0) * lay.row + d0;
      bf16* qd = Qs + r0 * LD + d0;
      for (int r = r0; r < rows; r += rs, qd += rs * LD, qp += grs) {
        const bool ok = p0 + r < S;
        cp_async16(qd, ok ? qp : qb, ok);
      }
    }
    // the ring's first kStages - 1 tiles (Q travels with the first)
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) {
      if (t < nkt) load_keys(t);
      cp_async_commit();
    }

    const int row0 = p0 + warp * 16;       // the warp's first query row
    const bool active = row0 < S;          // uniform across the warp
    bf16* qs = Qs + warp * 16 * LD;        // its Q rows, later its output rows
    uint32_t qa[HDIM / 16][4];
    float o[DT][4];
#pragma unroll
    for (int d = 0; d < DT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
    // row sums as an mma tile against ones: elements 0, 1 hold row g's
    // sum of the probabilities as the products use them, 2, 3 row g + 8's
    float l[4] = {0.f, 0.f, 0.f, 0.f};
    float m[2] = {-INFINITY, -INFINITY};

    for (int t = 0; t < nkt; ++t) {
      cp_async_wait<kStages - 2>();   // tile t has landed (the newer ones may not)
      __syncthreads();                // for every thread; and tile t - 1 is consumed
      if (t + kStages - 1 < nkt) load_keys(t + kStages - 1);   // into tile t - 1's stage
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
      const int ng = min(kKeys / 16, (S - j0 + 15) / 16);   // 16-key groups with a key < S

      // scores of the warp's 16 rows against the tile's keys: thread (g, t4)
      // holds rows g (elements 0, 1) and g + 8 (2, 3) of each n8 tile, at
      // key columns 2 t4 and 2 t4 + 1; groups past S are not multiplied
      float sc[kKeys / 8][4];
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HDIM / 16; ++kk) {
#pragma unroll
        for (int n = 0; n < kKeys / 16; ++n) {
          if (n >= ng) break;
          uint32_t b[4];
          ldmatrix_x4(b, ks + (n * 16 + (quad >> 1) * 8 + r8) * LD + kk * 16 + (quad & 1) * 8);
          mma_bf16(sc[2 * n], qa[kk], b[0], b[1]);
          mma_bf16(sc[2 * n + 1], qa[kk], b[2], b[3]);
        }
      }
      const bool tail = j0 + kKeys > S;   // the tile holds keys >= S
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
        const int c = n * 8 + 2 * t4;   // the tile's key column
        const float2 bv = *reinterpret_cast<const float2*>(bs + c);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float x0 = sc[n][2 * r] * scale + bv.x, x1 = sc[n][2 * r + 1] * scale + bv.y;
          if (tail) {
            x0 = j0 + c < S ? x0 : -INFINITY;
            x1 = j0 + c + 1 < S ? x1 : -INFINITY;
          }
          sc[n][2 * r] = x0;
          sc[n][2 * r + 1] = x1;
          mx[r] = fmaxf(mx[r], fmaxf(x0, x1));
        }
      }
      // exp(x - m) as exp2(x log2 e - m log2 e)
      float nm[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float mn = fmaxf(m[r], mx[r]);
        const float mref = mn == -INFINITY ? 0.f : mn;
        alpha[r] = exp2_sfu((m[r] - mref) * kLog2e);   // 1 while m holds; 0 from -inf
        m[r] = mn;
        nm[r] = -mref * kLog2e;
      }
      // a factor of 1 changes no bit: rescale only where a row's max grew
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          o[d][0] *= alpha[0];
          o[d][1] *= alpha[0];
          o[d][2] *= alpha[1];
          o[d][3] *= alpha[1];
        }
        l[0] *= alpha[0];
        l[1] *= alpha[0];
        l[2] *= alpha[1];
        l[3] *= alpha[1];
      }

      // P.V, 16 keys a group: the A fragment of group kk is the score tiles
      // 2 kk and 2 kk + 1 (a0/a1 rows g/g + 8 of the first, a2/a3 of the
      // second), exponentiated and split into hi and lo
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        if (kk >= ng) break;
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int n = 2 * kk + (x >> 1), r = x & 1;
          const float e0 = exp2_sfu(fmaf(sc[n][2 * r], kLog2e, nm[r]));
          const float e1 = exp2_sfu(fmaf(sc[n][2 * r + 1], kLog2e, nm[r]));
          split(e0, e1, hi[x], lo[x]);
        }
        mma_bf16(l, hi, kOnes, kOnes);
        mma_bf16(l, lo, kOnes, kOnes);
#pragma unroll
        for (int n = 0; n < DT / 2; ++n) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vs + (kk * 16 + (quad & 1) * 8 + r8) * LD + n * 16 +
                                   (quad >> 1) * 8);
          mma_bf16(o[2 * n], hi, b[0], b[1]);
          mma_bf16(o[2 * n + 1], hi, b[2], b[3]);
          mma_bf16(o[2 * n], lo, b[0], b[1]);
          mma_bf16(o[2 * n + 1], lo, b[2], b[3]);
        }
      }
    }

    if (active) {
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        *reinterpret_cast<__nv_bfloat162*>(qs + g * LD + d * 8 + 2 * t4) =
            __floats2bfloat162_rn(o[d][0] / l[0], o[d][1] / l[0]);
        *reinterpret_cast<__nv_bfloat162*>(qs + (g + 8) * LD + d * 8 + 2 * t4) =
            __floats2bfloat162_rn(o[d][2] / l[2], o[d][3] / l[2]);
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
    __syncthreads();           // the next pass's copies overwrite the Q rows
  }
}

template <int HDIM>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias, void* out,
                   int B, int S, int H, Layout lay, cudaStream_t st) {
  const size_t smem = smem_bytes(S, HDIM);
  auto kern = fwd_kernel<HDIM>;
  cudaError_t e = attn_train::set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(H, B), 32 * warps(S), smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      bias, static_cast<bf16*>(out), S, lay, attn_train::inv_sqrt(HDIM));
  return cudaGetLastError();
}

// bf16 q, k, v and out in layout lay, bias float32 [B, S]; S >= 1. Returns
// cudaGetLastError().
inline int forward(const void* q, const void* k, const void* v, const void* bias, void* out,
                   int B, int S, int H, int hd, Layout lay, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(bias);
  switch (hd) {
    case 32: return (int)launch<32>(q, k, v, bf, out, B, S, H, lay, st);
    case 64: return (int)launch<64>(q, k, v, bf, out, B, S, H, lay, st);
    case 128: return (int)launch<128>(q, k, v, bf, out, B, S, H, lay, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace attn_eval
