// Batched dense Schur update Y[b] = C[b] - A[b] B[b]^T.
//
// Replaces the TPU kernel src/repro/kernels/batched_schur_update/kernel.py:
// batched_schur_dense_t (body _schur_dense_kernel), one MXU contraction per
// tile in VMEM.  In H-LU it updates the dense target tiles of every
// elimination step: dense x dense products (p = c) and low-rank products
// landing on dense or promoted tiles (p = working rank), up to 5,632
// (256, 256) tiles in one step of the regression problem.
//
// Bound on the H100: operations at p = c (2 m n p flops against 4 (2 m n +
// (m + n) p) bytes: 64 flops per byte at 256), bytes at p = 32.  fp32 with
// no TF32, as the reference's tolerance needs.
//
// Design: a tiled fp32 SIMT GEMM with the subtraction fused.  Grid (B,
// output tiles); a CTA of 256 threads owns a 64 x 64 tile of Y, stages
// 16-deep slices of A and B (transposed, so that the inner loop reads rows of
// shared memory) and keeps a 4 x 4 register tile per thread, with rows
// ty + 16 i and columns tx + 16 j so that neighbouring threads write
// neighbouring addresses.  Each entry sums its p products in ascending
// order and is subtracted from C once, as the reference does.  No atomics.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16;
constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
schur_dense_kernel(const float* __restrict__ c, const float* __restrict__ a,
                   const float* __restrict__ bm, float* __restrict__ y, int m, int n, int p,
                   int tiles_n) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  const long long blk = blockIdx.x;
  const int tm = blockIdx.y / tiles_n, tn = blockIdx.y - (blockIdx.y / tiles_n) * tiles_n;
  const int row0 = tm * BM, col0 = tn * BN;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const float* ab = a + blk * m * (long long)p;
  const float* bb = bm + blk * n * (long long)p;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < p; k0 += BK) {
    for (int t = tid; t < BM * BK; t += NT) {
      const int r = t / BK, kk = t - (t / BK) * BK;
      const int gk = k0 + kk;
      const int gr = row0 + r, gc = col0 + r;
      As[kk][r] = (gr < m && gk < p) ? ab[(size_t)gr * p + gk] : 0.0f;
      Bs[kk][r] = (gc < n && gk < p) ? bb[(size_t)gc * p + gk] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float ar[4], br[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ar[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) br[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float* cb = c + blk * m * (long long)n;
  float* yb = y + blk * m * (long long)n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cc = col0 + tx + 16 * j;
      if (cc < n) yb[(size_t)r * n + cc] = cb[(size_t)r * n + cc] - acc[i][j];
    }
  }
}

}  // namespace

// c, y: (B, m, n), a: (B, m, p), b: (B, n, p); f32 contiguous.  Requires at
// most 65535 output tiles of 64 x 64 (cudaErrorInvalidValue otherwise).
extern "C" int repro_schur_dense(const float* c, const float* a, const float* b, float* y,
                                 int B, int m, int n, int p, void* stream) {
  if (B <= 0 || m <= 0 || n <= 0) return (int)cudaSuccess;
  const long long tiles_m = (m + BM - 1) / BM, tiles_n = (n + BN - 1) / BN;
  if (tiles_m * tiles_n > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  schur_dense_kernel<<<dim3(B, (int)(tiles_m * tiles_n)), NT, 0, s>>>(c, a, b, y, m, n, p,
                                                                     (int)tiles_n);
  return (int)cudaGetLastError();
}
