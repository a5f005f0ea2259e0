// Bank row gather for Hopper (sm_90a): out[i] = bank[idx[i]], bit-exact.
//
// Replaces the TPU kernel clg_vqa_tpu/ops/bank_gather.py:_copy_kernel as
// launched by rows_gather: a scalar-prefetch grid whose index map picked
// bank row idx[i] for output row i, one DMA per row.
//
// What bounds it on the H100: it is a pure copy. At UC2 eval (bank
// [400, 36, 2048] fp32, 1024 indices) it reads 302 MB and writes 302 MB,
// ~0.18 ms at 3.35 TB/s; there is no arithmetic.
//
// Design: rows are copied as raw bytes in 16-byte vectors (uint4), so any
// dtype is copied bit for bit; the wrapper requires the row size and both
// base pointers to be multiples of 16 bytes. Grid (B, Y): block (i, y)
// copies a strided share of output row i, neighbouring threads on
// neighbouring 16-byte words. Every block loads its own index. An index
// outside [0, n_rows) traps in the kernel (no read outside the bank); the
// trap surfaces as a CUDA error at the next synchronisation.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecsPerThread = 4;

__global__ void __launch_bounds__(kThreads)
rows_gather_kernel(const uint4* __restrict__ bank, const int32_t* __restrict__ idx,
                   uint4* __restrict__ out, long long n_rows, long long row_vecs) {
  const long long i = blockIdx.x;
  const int32_t r = idx[i];
  if (r < 0 || (long long)r >= n_rows) __trap();
  const uint4* src = bank + (long long)r * row_vecs;
  uint4* dst = out + i * row_vecs;
  const long long step = (long long)gridDim.y * kThreads;
  for (long long w = (long long)blockIdx.y * kThreads + threadIdx.x; w < row_vecs; w += step)
    dst[w] = src[w];
}

}  // namespace

extern "C" {

// bank: [n_rows, row_bytes] contiguous, idx: [B] int32, out: [B, row_bytes].
// row_bytes must be a multiple of 16. Returns cudaGetLastError().
int rows_gather(const void* bank, const void* idx, void* out, long long n_rows,
                long long row_bytes, int B, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (row_bytes % 16 != 0) return (int)cudaErrorInvalidValue;
  const long long row_vecs = row_bytes / 16;
  long long y = (row_vecs + kThreads * kVecsPerThread - 1) / (kThreads * kVecsPerThread);
  if (y < 1) y = 1;
  if (y > 65535) y = 65535;
  const dim3 grid(B, (unsigned)y);
  rows_gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(bank), static_cast<const int32_t*>(idx),
      static_cast<uint4*>(out), n_rows, row_vecs);
  return (int)cudaGetLastError();
}

}  // extern "C"
