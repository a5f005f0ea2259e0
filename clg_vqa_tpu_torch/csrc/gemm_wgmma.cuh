// bf16 matrix products for Hopper (sm_90a) on wgmma fed by TMA: the four
// projection products of the whole-block training attention (B4,
// block_attention_train.cu) and their gradients, one kernel template with an
// epilogue per use:
//
//   C[m][n] = sum_k A(m, k) B(n, k), fp32 accumulators, for up to four jobs.
//
// A(m, k) is A[m * lda + k] (K-contiguous) or A[k * lda + m] (M-contiguous);
// B(n, k) likewise. Each operand tile is copied as it lies in memory and a
// contiguous M or N dimension is read through the wgmma descriptor's
// transpose bit, so nothing is transposed by hand.
//
// Replaces, in bf16, the products of the TPU kernels of
// clg_vqa_tpu/ops/attention.py: _proj_fwd_kernel (:678; q|k|v and the output
// projection), _proj_bwda_kernel (:726; dctx = g Wo) and _linear_bwd_kernel
// (:802; dW, db and dx).
//
// What bounds it on the H100: at UC2 training (B*S = 9728 rows, H*hd = 768)
// each product is 9728 x 768 x 768 (11.5 GFLOP) against 32 MB moved, 360
// operations a byte, above the 295 at which bf16 tensor cores become the
// limit: the bound is the tensor cores' rate (0.0116 ms a product at
// 989 TFLOP/s). What the design does about it:
// - Tiles. A block computes a 128 x 128 (NT = 1) or 128 x 256 (NT = 2)
//   output tile: two consumer warpgroups of 64 rows each issue
//   wgmma.mma_async m64n128k16 (NT of them a k16 step) from shared memory,
//   one producer warp keeps TMA loads (cp.async.bulk.tensor.2d) of 64-deep
//   K steps in flight through a ring of stages with mbarriers (one "full"
//   barrier a stage that the copy completes, one "empty" barrier that each
//   consumer warp arrives at when its products have read the stage). At
//   NT = 1 two blocks share an SM (105 KB of shared memory and 112
//   registers a thread each), so one block's first copies and epilogue
//   overlap the other's products: at K = 768 a tile has only 12 K steps. A
//   128 x 256 tile reads 25% fewer operand bytes a product but leaves one
//   block an SM; each use takes the width that measured faster. The
//   producer is one warp, not a warpgroup whose registers setmaxnreg would
//   hand to the consumers: with a producer warpgroup two blocks leave each
//   thread 80 registers at launch, under what a 64-accumulator wgmma
//   needs. What holds the products under cuBLAS's rate at these shapes
//   (35-50% of 989 TFLOP/s against 50-57%, tools/profile_block.py
//   --widths) is the operand traffic from L2 (no cluster shares a tile's
//   loads) and the per-tile start and epilogue (no persistent blocks).
// - Layout. 128-byte swizzle on both sides: a K-contiguous operand lands as
//   128 rows of 64 elements (the k16 steps advance the descriptor's start by
//   32 bytes inside the swizzle atom); an M- or N-contiguous one as two
//   boxes of 64 K rows x 64 elements (the k16 steps advance by 16 rows,
//   2048 bytes; the second box is the leading-dimension offset).
// - Epilogue. From the accumulators to global memory without shared
//   memory; a bf16 output's 4 x 4 words are first transposed within each
//   quad of lanes, so that a lane stores 16 bytes and a row's 64 bytes are
//   whole sectors (half-sector stores cost the hi/lo product twice its
//   one-plane time).
// - Ragged edges. TMA fills zeros past the operand's end (rows past M or N,
//   K past its length) and the epilogue masks its stores.
// - Determinism. No float atomics: the weight gradients' K ranges
//   (EPI_WGRAD) go to fp32 partials that the caller sums in a fixed order,
//   and the three dx jobs (EPI_SUM) run in one block per tile, one after
//   the other, so two runs give the same bits.
// A barrier that has not completed after about 2 s traps, so a fault shows
// as a launch error rather than a hung card.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gemm_wgmma {
namespace {

using bf16 = __nv_bfloat16;

// Epilogues. BIAS: C = bf16(acc + bias[n]) (fp32 bias on the fp32
// accumulator, one cast). HILO: hi = bf16(acc) at C and lo = bf16(acc - hi)
// at C + plane: the fp32 value as two bf16 terms. WGRAD: the fp32 partial
// product of one of ksplit K ranges at C + range * plane and, in the first
// column of tiles, colsum[range * M + m] = sum over the range of A(m, k).
// SUM: the jobs' bf16(acc) summed in bf16, job by job, in one block per tile
// (the running sum kept in C: each thread reads back what it wrote).
enum { EPI_BIAS = 0, EPI_HILO = 1, EPI_WGRAD = 2, EPI_SUM = 3 };

// NT: the tile's width in 128-column halves, 1 (128 x 128 tiles, three
// stages, two blocks an SM) or 2 (128 x 256, four stages, one block an SM).
constexpr int kTM = 128, kTK = 64;
constexpr int kThreads = 288;                       // 2 consumer warpgroups + 1 producer warp
constexpr int kConsumerWarps = 8;
constexpr int kTileBytes = kTM * kTK * 2;           // 128 rows of one K step: 16 KB
constexpr int kBoxBytes = kTileBytes / 2;           // 64 x 64 box of an MN-contiguous operand
constexpr int kColBytes = 16 * kTM * 4;             // EPI_WGRAD's column-sum partials
__host__ __device__ constexpr int stages(int NT) { return NT == 1 ? 3 : 4; }
__host__ __device__ constexpr int stage_bytes(int NT) { return (1 + NT) * kTileBytes; }
__host__ __device__ constexpr int smem_bytes(int NT) {
  return 1024 + stages(NT) * stage_bytes(NT) + kColBytes + 2 * stages(NT) * 8;
}

// One tensor map per operand and job, in kernel parameter space.
struct Maps {
  CUtensorMap a[4];
  CUtensorMap b[4];
};

struct Args {
  const float* bias[4];   // EPI_BIAS: [N] float32
  void* c[4];             // the output of each job (EPI_SUM: c[0])
  float* colsum[4];       // EPI_WGRAD: [ksplit][M] float32
  int M, N, K, njobs, ksplit;
  long long ldc;          // elements between output rows
  long long plane;        // EPI_HILO: hi to lo; EPI_WGRAD: range to range
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// A 2D box of the map at (c0 innermost, c1) into shared memory; completes
// the box's bytes on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// A shared-memory matrix descriptor with 128-byte swizzle.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving uses of the accumulators across a wait.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A B for one m64n128k16 step: A and B from shared memory through their
// descriptors; TA / TB: A is M-contiguous / B is N-contiguous.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// w[i] of lane t4 of a quad: a row's columns 8 i + 2 t4, + 1 (two bf16).
// After the transpose w[i] of lane t4 holds columns 8 t4 + 2 i, + 1: the
// lane's 8 consecutive columns. Round r passes each lane's word for block
// (t4 - r) & 3 to lane (t4 - r) & 3.
__device__ __forceinline__ void quad_transpose(uint32_t (&w)[4], int lane) {
  const int t4 = lane & 3;
  uint32_t out[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int si = (t4 - r) & 3, src = (t4 + r) & 3;
    const uint32_t send = si == 0 ? w[0] : si == 1 ? w[1] : si == 2 ? w[2] : w[3];
    const uint32_t got = __shfl_sync(0xffffffffu, send, (lane & ~3) | src);
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = src == i ? got : out[i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = out[i];
}

// Eight bf16 sums bf16(a + b), element by element.
__device__ __forceinline__ uint4 add_bf16x8(uint4 a, uint4 b) {
  const uint32_t* x = &a.x;
  const uint32_t* y = &b.x;
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + i));
    const float2 q = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(y + i));
    r[i] = bits(__floats2bfloat162_rn(p.x + q.x, p.y + q.y));
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// The K range [k0, k1) of range r of ksplit, cut at multiples of kTK.
__device__ __forceinline__ void k_range(int K, int ksplit, int r, int& k0, int& k1) {
  const int chunk = ((K + kTK - 1) / kTK + ksplit - 1) / ksplit * kTK;
  k0 = min(K, r * chunk);
  k1 = min(K, k0 + chunk);
}

template <bool A_KMAJ, bool B_KMAJ, int EPI, int NT>
__global__ void __launch_bounds__(kThreads, NT == 1 ? 2 : 1)
    gemm_kernel(const __grid_constant__ Maps maps, const Args args) {
  constexpr int kStages = stages(NT), kStage = stage_bytes(NT);
  extern __shared__ unsigned char smem_raw[];
  // the stages at a 1024-byte boundary, as the 128-byte swizzle needs; a
  // stage holds A's 128 rows, then B's 128 NT
  unsigned char* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float* colbuf = reinterpret_cast<float*>(sm + kStages * kStage);   // [16][kTM]
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + kStages * kStage + kColBytes);
  uint64_t* empty = full + kStages;

  const int n0 = blockIdx.x * 128 * NT, m0 = blockIdx.y * kTM;
  const int z = blockIdx.z;
  const int j0 = EPI == EPI_SUM ? 0 : z / args.ksplit;
  const int j1 = EPI == EPI_SUM ? args.njobs : j0 + 1;
  const int range = EPI == EPI_WGRAD ? z % args.ksplit : 0;
  int kb = 0, ke = args.K;
  if (EPI == EPI_WGRAD) k_range(args.K, args.ksplit, range, kb, ke);
  const int nk = (ke - kb + kTK - 1) / kTK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer warp: one thread issues every copy ----
    if (threadIdx.x == 256) {
      int s = 0;
      uint32_t ph = 0;
      for (int j = j0; j < j1; ++j) {
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(&empty[s], ph ^ 1);
          mbar_expect_tx(&full[s], kStage);
          unsigned char* as = sm + s * kStage;
          unsigned char* bs = as + kTileBytes;
          const int k = kb + kt * kTK;
          if (A_KMAJ) {
            tma_load(as, &maps.a[j], &full[s], k, m0);
          } else {
            tma_load(as, &maps.a[j], &full[s], m0, k);
            tma_load(as + kBoxBytes, &maps.a[j], &full[s], m0 + 64, k);
          }
#pragma unroll
          for (int h = 0; h < NT; ++h) {
            if (B_KMAJ) {
              tma_load(bs + h * kTileBytes, &maps.b[j], &full[s], k, n0 + 128 * h);
            } else {
              tma_load(bs + h * kTileBytes, &maps.b[j], &full[s], n0 + 128 * h, k);
              tma_load(bs + h * kTileBytes + kBoxBytes, &maps.b[j], &full[s], n0 + 128 * h + 64,
                       k);
            }
          }
          if (++s == kStages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup w owns rows 64 w .. 64 w + 63 of the tile ----
  const int ct = threadIdx.x, w = ct >> 7, lane = ct & 31;
  const int wr = (ct >> 5) & 3, g = lane >> 2, t4 = lane & 3;
  const bool colsum = EPI == EPI_WGRAD && blockIdx.x == 0;
  // EPI_WGRAD's column sums: this thread's 8 columns (one 16-byte chunk of
  // an A box) over rows rg, rg + 16, rg + 32, rg + 48 of each K step
  const int cc = ct & 15, rg = ct >> 4;
  float cs[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) cs[e] = 0.f;
  float acc[NT][64];
  int s = 0;
  uint32_t ph = 0;
  for (int j = j0; j < j1; ++j) {
#pragma unroll
    for (int h = 0; h < NT; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
    int prev = -1;
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(&full[s], ph);
      const uint32_t as = smem_addr(sm + s * kStage), bs = as + kTileBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTK / 16; ++kk) {
        const uint64_t da = A_KMAJ ? sw128_desc(as + w * 8192 + kk * 32, 16, 1024)
                                   : sw128_desc(as + w * kBoxBytes + kk * 2048, kBoxBytes, 1024);
#pragma unroll
        for (int h = 0; h < NT; ++h) {
          const uint32_t bh = bs + h * kTileBytes;
          const uint64_t db = B_KMAJ ? sw128_desc(bh + kk * 32, 16, 1024)
                                     : sw128_desc(bh + kk * 2048, kBoxBytes, 1024);
          wgmma_m64n128<A_KMAJ ? 0 : 1, B_KMAJ ? 0 : 1>(acc[h], da, db);
        }
      }
      wgmma_commit();
      if (colsum) {
        // A is M-contiguous here: chunk c of row r of box b sits at chunk
        // c ^ (r & 7) of that row
        const unsigned char* box = sm + s * kStage + (cc >> 3) * kBoxBytes;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = rg + 16 * i;
          const uint4 u =
              *reinterpret_cast<const uint4*>(box + r * 128 + (((cc & 7) ^ (r & 7)) << 4));
          const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(p[e]);
            cs[2 * e] += f.x;
            cs[2 * e + 1] += f.y;
          }
        }
      }
      // the previous stage's products done: release that one
      wgmma_wait<1>();
      if (prev >= 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      prev = s;
      if (++s == kStages) {
        s = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < NT; ++h) fence_acc(acc[h]);
    if (prev >= 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);
    }
    // acc[hh][4 q + e] sits at row 64 w + 16 wr + g + 8 (e / 2), column
    // 128 hh + 8 q + 2 t4 + e % 2 of the tile
    const int row = m0 + 64 * w + 16 * wr + g;
    if constexpr (EPI == EPI_WGRAD) {
      // fp32 pairs as they lie: 4 lanes write a row's full 32-byte sector
#pragma unroll
      for (int x = 0; x < 16 * NT; ++x) {
        const int hh = x / 16, q = x % 16;
        const int col = n0 + 128 * hh + 8 * q + 2 * t4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gm = row + 8 * h;
          if (gm >= args.M || col >= args.N) continue;
          *reinterpret_cast<float2*>(static_cast<float*>(args.c[j]) + range * args.plane +
                                     (long long)gm * args.ldc + col) =
              make_float2(acc[hh][4 * q + 2 * h], acc[hh][4 * q + 2 * h + 1]);
        }
      }
    } else {
      // bf16: four column blocks at a time, the quad's 4 x 4 words
      // transposed so that each lane writes 16 bytes (8 columns) of a row
      // and each row's 64 bytes are whole sectors
#pragma unroll
      for (int x = 0; x < 4 * NT; ++x) {
        const int hh = x / 4, q0 = 4 * (x % 4);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gm = row + 8 * h;
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int q = q0 + i, col = n0 + 128 * hh + 8 * q + 2 * t4;
            float v0 = acc[hh][4 * q + 2 * h], v1 = acc[hh][4 * q + 2 * h + 1];
            if constexpr (EPI == EPI_BIAS) {
              const float2 b = col < args.N ? *reinterpret_cast<const float2*>(args.bias[j] + col)
                                            : make_float2(0.f, 0.f);
              v0 += b.x;
              v1 += b.y;
            }
            const __nv_bfloat162 b2 = __floats2bfloat162_rn(v0, v1);
            hi[i] = bits(b2);
            if constexpr (EPI == EPI_HILO) {
              const float2 hf = __bfloat1622float2(b2);
              lo[i] = bits(__floats2bfloat162_rn(v0 - hf.x, v1 - hf.y));
            }
          }
          quad_transpose(hi, lane);
          if constexpr (EPI == EPI_HILO) quad_transpose(lo, lane);
          // this lane: columns 8 (q0 + t4) .. + 7 of row gm
          const int c8 = n0 + 128 * hh + 8 * (q0 + t4);
          if (gm >= args.M || c8 >= args.N) continue;
          const long long o = (long long)gm * args.ldc + c8;
          bf16* c = static_cast<bf16*>(args.c[EPI == EPI_SUM ? 0 : j]) + o;
          uint4 out = make_uint4(hi[0], hi[1], hi[2], hi[3]);
          if constexpr (EPI == EPI_SUM) {
            if (j > j0) out = add_bf16x8(*reinterpret_cast<const uint4*>(c), out);
          }
          *reinterpret_cast<uint4*>(c) = out;
          if constexpr (EPI == EPI_HILO)
            *reinterpret_cast<uint4*>(c + args.plane) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
        }
      }
    }
  }
  if (colsum) {
    // the 16 row groups' partial sums added in order rg = 0..15
#pragma unroll
    for (int e = 0; e < 8; ++e) colbuf[rg * kTM + cc * 8 + e] = cs[e];
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    if (ct < kTM && m0 + ct < args.M) {
      float t = colbuf[ct];
      for (int r = 1; r < 16; ++r) t += colbuf[r * kTM + ct];
      args.colsum[j0][(long long)range * args.M + m0 + ct] = t;
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (the
// library is not linked against libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      p = nullptr;
#endif
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a bf16 operand X(r, k), r < R, k < K: X[r * ld + k] (kmaj,
// boxes of 128 rows x 64 K) or X[k * ld + r] (boxes of 64 K rows x 64).
bool operand_map(CUtensorMap* map, const void* x, bool kmaj, long long R, long long K,
                 long long ld) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)(kmaj ? K : R), (cuuint64_t)(kmaj ? R : K)};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)(kmaj ? kTM : kTK)};
  const cuuint32_t es[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims, strides, box,
             es, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The operands of up to four jobs: a[j] with leading dimension lda, b[j]
// with ldb, in the layouts of the gemm template.
struct Operands {
  const void* a[4];
  const void* b[4];
  long long lda, ldb;
};

// Launch the product on stream st. Operands start on 16-byte boundaries and
// their leading dimensions are multiples of 8 elements, as TMA needs; N and
// ldc are even. Returns the launch's error, cudaErrorInvalidValue for
// operands TMA cannot describe.
template <bool A_KMAJ, bool B_KMAJ, int EPI, int NT>
cudaError_t gemm(const Operands& ops, const Args& args, cudaStream_t st) {
  if (args.njobs < 1 || args.njobs > 4 || args.ksplit < 1 || (EPI != EPI_WGRAD && args.ksplit != 1))
    return cudaErrorInvalidValue;
  if (args.M == 0 || args.N == 0) return cudaSuccess;
  // The attributes, once a thread: the carveout at its largest, so that two
  // blocks' shared memory fits. Being runtime calls, they also make the
  // device's context current on the thread, which the driver's encoding
  // below needs: autograd runs the backward on a thread of its own, where
  // PyTorch may not have made one current yet.
  auto kern = gemm_kernel<A_KMAJ, B_KMAJ, EPI, NT>;
  constexpr int kSmem = smem_bytes(NT);
  static thread_local bool attributes_set = false;
  if (!attributes_set) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    attributes_set = true;
  }
  Maps maps;
  for (int j = 0; j < args.njobs; ++j) {
    if (!operand_map(&maps.a[j], ops.a[j], A_KMAJ, args.M, args.K, ops.lda) ||
        !operand_map(&maps.b[j], ops.b[j], B_KMAJ, args.N, args.K, ops.ldb))
      return cudaErrorInvalidValue;
  }
  const int nz = EPI == EPI_SUM ? 1 : args.njobs * args.ksplit;
  kern<<<dim3((args.N + 128 * NT - 1) / (128 * NT), (args.M + kTM - 1) / kTM, nz), kThreads,
         kSmem, st>>>(maps, args);
  return cudaGetLastError();
}

}  // namespace
}  // namespace gemm_wgmma
