// Grouped bf16 products of a mixture-of-experts layer (ops/moe.py) for Hopper
// (sm_90a), on gemm_wgmma.cuh's TMA loads and wgmma tiles:
//
//   rows:  C[r][n] = sum_k A[r][k] B_g(n, k), g the group that row r lies in;
//   wgrad: C_g[m][n] = sum over the rows r of group g of P[r][m] Q[r][n].
//
// The rows are the (token, expert) pairs held here, sorted by expert; group
// g's rows are [poff[g], poff[g + 1]), each group padded with zero rows to a
// multiple of 128, so that a 128-row tile never spans two groups. The
// offsets stay in device memory: the routing that makes them and the
// products that read them issue back to back, and no count is read on the
// host. The grid is sized from an upper bound on the rows; a block walks the
// 128-row tiles blockIdx.y, blockIdx.y + gridDim.y, ... below poff[E] and
// finds each tile's group by a scan of the offsets.
//
// The uses (E experts of width I over hidden size H):
//   forward   gate|up = X W1_g^T with the SwiGLU epilogue (act = silu(gate)
//             up, gate and up kept for the backward), then Y = act W2_g^T;
//   backward  dact = dY W2_g with the SwiGLU gradient as its epilogue (dgate,
//             dup from the kept gate and up), dX = dgu W1_g, and the weight
//             gradients dW2_g = dY_g^T act_g, dW1_g = dgu_g^T X_g (wgrad).
//
// Replaces no TPU kernel: the JAX package has no mixture of experts. It was
// added for Kimi-VL-A3B's expert layers, whose products over uneven,
// data-dependent groups no existing kernel computes.
//
// What bounds it on the H100: at the benchmark's shapes (about 900 rows an
// expert, H 2048, I 1408) each product is 2 x 7,300 x 2,048 x 2,816 FLOPs at
// most against the 92 MB of its experts' weights and the rows: about 400
// operations a byte, above the 295 at which the tensor cores are the limit,
// but near it, so the weights' reads count. What the design does about it:
// - Tiles. gemm_wgmma's 128 x 128 (two blocks an SM) and 128 x 256 (one
//   block an SM) tiles: two consumer warpgroups issue m64n128k16 wgmma from
//   a ring of TMA-loaded stages that one producer warp keeps full (the ring
//   and the consumers' loop are gemm_wgmma's init_ring and tile_products;
//   only the producer's schedule and the epilogues are this file's). The
//   SwiGLU forward takes 128 x 256 tiles whose two halves are the same 128
//   features' gate and up rows of W1, so the epilogue holds both.
// - Epilogues from the accumulators: the SwiGLU products in fp32 before the
//   single rounding to bf16; the backward reads gate and up in bf16 beside
//   its fp32 accumulators. Weight gradients are stored in fp32 whole (the
//   contraction over a group's rows runs in one block, so no atomics and two
//   runs give the same bits).
// - Ragged edges. TMA fills zeros past the buffers' ends; the padding rows
//   are zeros in X and in dY, so they add nothing to a weight gradient.
#include "gemm_wgmma.cuh"

namespace grouped_gemm {
namespace {

namespace gw = gemm_wgmma;
using bf16 = __nv_bfloat16;
using gw::kBoxBytes;
using gw::kTileBytes;
using gw::kTK;
using gw::kTM;

enum { G_STORE = 0, G_SWIGLU = 1, G_DSWIGLU = 2 };

struct RowArgs {
  const int* poff;  // [E + 1] group offsets in rows, multiples of kTM
  bf16* c;          // the output, [rows][ldc] (SWIGLU: act; DSWIGLU: dgu)
  bf16* gu;         // [rows][2 N]: SWIGLU writes gate | up, DSWIGLU reads them
  int E, N, K;      // output columns (SWIGLU, DSWIGLU: I) and depth
  int bgroup;       // B's coordinate stride from group to group (rows or K rows)
  int bhalf;        // SWIGLU: B's row offset of the up half
  long long ldc;
};

struct WgradArgs {
  const int* poff;
  float* c;  // [E][M][N]
  int E, M, N;
};

// The group of the tile that starts at row m0 < poff[E].
__device__ __forceinline__ int group_of(const int* poff, int E, int m0) {
  int g = 0;
  while (g + 1 < E && poff[g + 1] <= m0) ++g;
  return g;
}

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

template <bool B_KMAJ, int EPI, int NT>
__global__ void __launch_bounds__(gw::kThreads, NT == 1 ? 2 : 1)
    rows_kernel(const __grid_constant__ gw::Maps maps, const RowArgs args) {
  constexpr int kStages = gw::stages(NT), kStage = gw::stage_bytes(NT);
  static_assert(EPI != G_SWIGLU || NT == 2, "the SwiGLU tile pairs gate and up halves");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (gw::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + kStages * kStage + gw::kColBytes);
  uint64_t* empty = full + kStages;
  constexpr int kCols = EPI == G_SWIGLU ? 128 : 128 * NT;
  const int n0 = blockIdx.x * kCols;
  const int total = args.poff[args.E];
  const int nk = (args.K + kTK - 1) / kTK;
  gw::init_ring<NT>(full, empty);

  if (threadIdx.x >= 256) {
    // ---- producer warp: one thread issues every copy ----
    if (threadIdx.x == 256) {
      int s = 0;
      uint32_t ph = 0;
      for (int m0 = blockIdx.y * kTM; m0 < total; m0 += gridDim.y * kTM) {
        const int g = group_of(args.poff, args.E, m0);
        for (int kt = 0; kt < nk; ++kt) {
          gw::mbar_wait(&empty[s], ph ^ 1);
          gw::mbar_expect_tx(&full[s], kStage);
          unsigned char* as = sm + s * kStage;
          unsigned char* bs = as + kTileBytes;
          const int k = kt * kTK;
          gw::tma_load(as, &maps.a[0], &full[s], k, m0);
#pragma unroll
          for (int h = 0; h < NT; ++h) {
            if (B_KMAJ) {
              const int row = g * args.bgroup +
                              (EPI == G_SWIGLU ? h * args.bhalf + n0 : n0 + 128 * h);
              gw::tma_load(bs + h * kTileBytes, &maps.b[0], &full[s], k, row);
            } else {
              const int col = n0 + 128 * h, krow = g * args.bgroup + k;
              gw::tma_load(bs + h * kTileBytes, &maps.b[0], &full[s], col, krow);
              gw::tma_load(bs + h * kTileBytes + kBoxBytes, &maps.b[0], &full[s], col + 64, krow);
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

  const int ct = threadIdx.x, w = ct >> 7, lane = ct & 31;
  const int wr = (ct >> 5) & 3, gq = lane >> 2, t4 = lane & 3;
  const long long gu_ld = 2LL * args.N;
  float acc[NT][64];
  int s = 0;
  uint32_t ph = 0;
  for (int m0 = blockIdx.y * kTM; m0 < total; m0 += gridDim.y * kTM) {
    gw::tile_products<true, B_KMAJ, NT>(acc, sm, full, empty, nk, s, ph, w, lane);
    // acc[hh][4 q + e] sits at row 64 w + 16 wr + gq + 8 (e / 2), column
    // 128 hh + 8 q + 2 t4 + e % 2 of the tile; each quad's 4 x 4 words are
    // transposed so that a lane stores 8 consecutive columns (16 bytes)
    const int row = m0 + 64 * w + 16 * wr + gq;
    constexpr int kBlocks = EPI == G_SWIGLU ? 4 : 4 * NT;
#pragma unroll
    for (int x = 0; x < kBlocks; ++x) {
      const int hh = x / 4, q0 = 4 * (x % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long gm = row + 8 * h;
        uint32_t o0[4], o1[4], o2[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = q0 + i;
          const float v0 = acc[hh][4 * q + 2 * h], v1 = acc[hh][4 * q + 2 * h + 1];
          if constexpr (EPI == G_STORE) {
            o0[i] = gw::bits(__floats2bfloat162_rn(v0, v1));
          } else if constexpr (EPI == G_SWIGLU) {
            const float u0 = acc[1][4 * q + 2 * h], u1 = acc[1][4 * q + 2 * h + 1];
            o0[i] = gw::bits(__floats2bfloat162_rn(silu(v0) * u0, silu(v1) * u1));
            o1[i] = gw::bits(__floats2bfloat162_rn(v0, v1));
            o2[i] = gw::bits(__floats2bfloat162_rn(u0, u1));
          } else {
            // the SwiGLU gradient from dact (fp32) and the kept gate and up
            const int col = n0 + 8 * q + 2 * t4;
            float2 gv = make_float2(0.f, 0.f), uv = make_float2(0.f, 0.f);
            if (col < args.N) {
              const bf16* p = args.gu + gm * gu_ld + col;
              gv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
              uv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + args.N));
            }
            const float s0 = 1.f / (1.f + expf(-gv.x)), s1 = 1.f / (1.f + expf(-gv.y));
            o0[i] = gw::bits(__floats2bfloat162_rn(v0 * uv.x * s0 * (1.f + gv.x * (1.f - s0)),
                                                   v1 * uv.y * s1 * (1.f + gv.y * (1.f - s1))));
            o1[i] = gw::bits(__floats2bfloat162_rn(v0 * gv.x * s0, v1 * gv.y * s1));
          }
        }
        gw::quad_transpose(o0, lane);
        if constexpr (EPI != G_STORE) gw::quad_transpose(o1, lane);
        if constexpr (EPI == G_SWIGLU) gw::quad_transpose(o2, lane);
        const int c8 = n0 + 128 * hh + 8 * (q0 + t4);
        if (c8 >= args.N) continue;
        if constexpr (EPI == G_STORE) {
          *reinterpret_cast<uint4*>(args.c + gm * args.ldc + c8) =
              make_uint4(o0[0], o0[1], o0[2], o0[3]);
        } else if constexpr (EPI == G_SWIGLU) {
          *reinterpret_cast<uint4*>(args.c + gm * args.ldc + c8) =
              make_uint4(o0[0], o0[1], o0[2], o0[3]);
          *reinterpret_cast<uint4*>(args.gu + gm * gu_ld + c8) =
              make_uint4(o1[0], o1[1], o1[2], o1[3]);
          *reinterpret_cast<uint4*>(args.gu + gm * gu_ld + args.N + c8) =
              make_uint4(o2[0], o2[1], o2[2], o2[3]);
        } else {
          *reinterpret_cast<uint4*>(args.c + gm * gu_ld + c8) =
              make_uint4(o0[0], o0[1], o0[2], o0[3]);
          *reinterpret_cast<uint4*>(args.c + gm * gu_ld + args.N + c8) =
              make_uint4(o1[0], o1[1], o1[2], o1[3]);
        }
      }
    }
  }
}

template <int NT>
__global__ void __launch_bounds__(gw::kThreads, NT == 1 ? 2 : 1)
    wgrad_kernel(const __grid_constant__ gw::Maps maps, const WgradArgs args) {
  constexpr int kStages = gw::stages(NT), kStage = gw::stage_bytes(NT);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (gw::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + kStages * kStage + gw::kColBytes);
  uint64_t* empty = full + kStages;
  const int n0 = blockIdx.x * 128 * NT, m0 = blockIdx.y * kTM, g = blockIdx.z;
  const int kb = args.poff[g], nk = (args.poff[g + 1] - kb) / kTK;
  gw::init_ring<NT>(full, empty);

  if (threadIdx.x >= 256) {
    if (threadIdx.x == 256) {
      int s = 0;
      uint32_t ph = 0;
      for (int kt = 0; kt < nk; ++kt) {
        gw::mbar_wait(&empty[s], ph ^ 1);
        gw::mbar_expect_tx(&full[s], kStage);
        unsigned char* as = sm + s * kStage;
        unsigned char* bs = as + kTileBytes;
        const int k = kb + kt * kTK;
        gw::tma_load(as, &maps.a[0], &full[s], m0, k);
        gw::tma_load(as + kBoxBytes, &maps.a[0], &full[s], m0 + 64, k);
#pragma unroll
        for (int h = 0; h < NT; ++h) {
          gw::tma_load(bs + h * kTileBytes, &maps.b[0], &full[s], n0 + 128 * h, k);
          gw::tma_load(bs + h * kTileBytes + kBoxBytes, &maps.b[0], &full[s], n0 + 128 * h + 64,
                       k);
        }
        if (++s == kStages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  const int ct = threadIdx.x, w = ct >> 7, lane = ct & 31;
  const int wr = (ct >> 5) & 3, gq = lane >> 2, t4 = lane & 3;
  float acc[NT][64];
  int s = 0;
  uint32_t ph = 0;
  gw::tile_products<false, false, NT>(acc, sm, full, empty, nk, s, ph, w, lane);
  const int row = m0 + 64 * w + 16 * wr + gq;
  float* c = args.c + (long long)g * args.M * args.N;
#pragma unroll
  for (int x = 0; x < 16 * NT; ++x) {
    const int hh = x / 16, q = x % 16;
    const int col = n0 + 128 * hh + 8 * q + 2 * t4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = row + 8 * h;
      if (gm >= args.M || col >= args.N) continue;
      *reinterpret_cast<float2*>(c + (long long)gm * args.N + col) =
          make_float2(acc[hh][4 * q + 2 * h], acc[hh][4 * q + 2 * h + 1]);
    }
  }
}

template <typename Kern>
cudaError_t attributes(Kern kern, int smem, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  done = e == cudaSuccess;
  return e;
}

template <bool B_KMAJ, int EPI, int NT>
cudaError_t launch_rows(const void* a, const void* b, long long rows, const RowArgs& args,
                        long long b_rows, int grid_y, cudaStream_t st) {
  auto kern = rows_kernel<B_KMAJ, EPI, NT>;
  constexpr int kSmem = gw::smem_bytes(NT);
  static thread_local bool set = false;
  cudaError_t e = attributes(kern, kSmem, set);
  if (e != cudaSuccess) return e;
  gw::Maps maps;
  // B: [E * bgroup rows][K] (K-major) or [E * K rows][N] (N-major)
  if (!gw::operand_map(&maps.a[0], a, true, rows, args.K, args.K) ||
      !(B_KMAJ ? gw::operand_map(&maps.b[0], b, true, b_rows, args.K, args.K)
               : gw::operand_map(&maps.b[0], b, false, args.N, b_rows, args.N)))
    return cudaErrorInvalidValue;
  constexpr int kCols = EPI == G_SWIGLU ? 128 : 128 * NT;
  kern<<<dim3((args.N + kCols - 1) / kCols, grid_y, 1), gw::kThreads, kSmem, st>>>(maps, args);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_wgrad(const void* p, const void* q, long long rows, const WgradArgs& args,
                         cudaStream_t st) {
  auto kern = wgrad_kernel<NT>;
  constexpr int kSmem = gw::smem_bytes(NT);
  static thread_local bool set = false;
  cudaError_t e = attributes(kern, kSmem, set);
  if (e != cudaSuccess) return e;
  gw::Maps maps;
  if (!gw::operand_map(&maps.a[0], p, false, args.M, rows, args.M) ||
      !gw::operand_map(&maps.b[0], q, false, args.N, rows, args.N))
    return cudaErrorInvalidValue;
  kern<<<dim3((args.N + 128 * NT - 1) / (128 * NT), (args.M + kTM - 1) / kTM, args.E),
         gw::kThreads, kSmem, st>>>(maps, args);
  return cudaGetLastError();
}

}  // namespace
}  // namespace grouped_gemm

namespace gg = grouped_gemm;

extern "C" {

// Every function takes bf16 operands whose rows start on 16-byte boundaries,
// the int32 group offsets poff [E + 1] on the device, the rows of the row
// buffers (tiles read past poff[E] never) and grid_y, the number of 128-row
// tile slots the launch walks with; it returns the launch's error
// (cudaErrorInvalidValue for shapes the tiles do not take).

// act [rows][I] = silu(gate) up and gu [rows][2 I] = gate | up, where
// gate | up = x [rows][H] w1_g^T, w1 [E][2 I][H] (gate rows, then up rows).
int grouped_gemm_swiglu(const void* x, const void* w1, void* gu, void* act, const int* poff,
                        int E, long long rows, int H, int I, int grid_y, void* stream) {
  if (I % 128 || H % 8 || E < 1 || grid_y < 1) return (int)cudaErrorInvalidValue;
  gg::RowArgs a{poff, static_cast<gg::bf16*>(act), static_cast<gg::bf16*>(gu), E, I, H, 2 * I, I, I};
  return (int)gg::launch_rows<true, gg::G_SWIGLU, 2>(x, w1, rows, a, (long long)E * 2 * I, grid_y,
                                                     static_cast<cudaStream_t>(stream));
}

// c [rows][N] = a [rows][K] B_g, B_g(n, k) = b[g][n][k] (b_kmaj: b [E][N][K])
// or b[g][k][n] (b [E][K][N]).
int grouped_gemm_rows(const void* a, const void* b, void* c, const int* poff, int E,
                      long long rows, int K, int N, int b_kmaj, int grid_y, void* stream) {
  if (N % 128 || K % 8 || (!b_kmaj && K % gg::kTK) || E < 1 || grid_y < 1)
    return (int)cudaErrorInvalidValue;
  gg::RowArgs ra{poff, static_cast<gg::bf16*>(c), nullptr, E, N, K, b_kmaj ? N : K, 0, N};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long br = (long long)E * (b_kmaj ? N : K);
  const bool wide = N % 256 == 0;
  if (b_kmaj)
    return (int)(wide ? gg::launch_rows<true, gg::G_STORE, 2>(a, b, rows, ra, br, grid_y, st)
                      : gg::launch_rows<true, gg::G_STORE, 1>(a, b, rows, ra, br, grid_y, st));
  return (int)(wide ? gg::launch_rows<false, gg::G_STORE, 2>(a, b, rows, ra, br, grid_y, st)
                    : gg::launch_rows<false, gg::G_STORE, 1>(a, b, rows, ra, br, grid_y, st));
}

// dgu [rows][2 I] = the SwiGLU gradient of dact = dy [rows][H] w2_g, w2
// [E][H][I], at the kept gu [rows][2 I]: dgate = dact up silu'(gate), dup =
// dact silu(gate).
int grouped_gemm_dswiglu(const void* dy, const void* w2, const void* gu, void* dgu,
                         const int* poff, int E, long long rows, int H, int I, int grid_y,
                         void* stream) {
  if (I % 128 || H % gg::kTK || E < 1 || grid_y < 1) return (int)cudaErrorInvalidValue;
  gg::RowArgs a{poff, static_cast<gg::bf16*>(dgu), static_cast<gg::bf16*>(const_cast<void*>(gu)),
                E, I, H, H, 0, 2LL * I};
  return (int)gg::launch_rows<false, gg::G_DSWIGLU, 1>(dy, w2, rows, a, (long long)E * H, grid_y,
                                                       static_cast<cudaStream_t>(stream));
}

// c [E][M][N] float32: c_g = p_g^T q_g over group g's rows of p [rows][M]
// and q [rows][N].
int grouped_gemm_wgrad(const void* p, const void* q, float* c, const int* poff, int E,
                       long long rows, int M, int N, void* stream) {
  if (M % 8 || N % 8 || E < 1) return (int)cudaErrorInvalidValue;
  gg::WgradArgs a{poff, c, E, M, N};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(N % 256 == 0 ? gg::launch_wgrad<2>(p, q, rows, a, st)
                            : gg::launch_wgrad<1>(p, q, rows, a, st));
}

}  // extern "C"
