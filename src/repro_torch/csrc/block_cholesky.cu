// Batched Cholesky factorisation L[b] L[b]^T = A[b] of SPD (c x c) blocks.
//
// Replaces the TPU kernel src/repro/kernels/batched_block_solve/kernel.py:
// batched_block_cholesky_t (body _chol_kernel), a right-looking
// factorisation of one block held whole in VMEM as c rank-1 updates.
//
// Bound on the H100: operations, B c^3 / 3 multiply-adds (1.5e12 for the
// paper's 512 blocks of 2048).  A 2048 x 2048 block (16 MiB) does not fit
// in 227 KB of shared memory, so the factorisation is blocked.
//
// Design: right-looking, panel width NB = 32; the host loops over panels
// and each step launches three kernels batched over all B blocks:
//   diag     one CTA of 32 x 32 threads per block factors the diagonal
//            tile in shared memory, with the reference's pivot rule
//            dinv = rsqrt(max(d, 1e-30)), L[:, j] = residual[:, j] * dinv;
//            the dinv values go to scratch for the panel solve;
//   panel    one thread per row below the tile solves its 32 entries
//            against the factored tile (row tile staged in shared memory
//            with coalesced loads);
//   update   the trailing lower triangle A22 -= P P^T in 64 x 64 tiles, each
//            thread a 4 x 4 micro-tile from panel rows staged in shared
//            memory; only tiles on or below the diagonal are launched.
// Exact zeros are written above the diagonal first, as _chol_kernel does.
#include <cuda_runtime.h>

namespace {

constexpr int NB = 32;     // panel width
constexpr int PT = 128;    // rows per CTA in the panel solve
constexpr int UT = 64;     // trailing-update tile
constexpr int UTH = 256;   // threads per trailing-update CTA (16 x 16, 4 x 4 each)

__global__ void copy_lower_kernel(const float* __restrict__ a, float* __restrict__ l,
                                  int c, size_t total) {
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    const size_t within = idx % ((size_t)c * c);
    const int i = (int)(within / c);
    const int j = (int)(within - (size_t)i * c);
    l[idx] = (j <= i) ? a[idx] : 0.0f;
  }
}

__global__ void __launch_bounds__(NB * NB)
diag_factor_kernel(float* __restrict__ l, float* __restrict__ dinv_out, int c, int j0) {
  __shared__ float t[NB][NB + 1];
  const int b = blockIdx.x;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int nb = min(NB, c - j0);
  float* lb = l + (size_t)b * c * c;
  const bool in = ty < nb && tx < nb;
  t[ty][tx] = in ? lb[(size_t)(j0 + ty) * c + j0 + tx] : 0.0f;
  __syncthreads();
  for (int j = 0; j < nb; ++j) {
    const float dinv = rsqrtf(fmaxf(t[j][j], 1e-30f));
    __syncthreads();
    if (tx == j && ty >= j && ty < nb) t[ty][j] *= dinv;
    if (tx == 0 && ty == 0) dinv_out[(size_t)b * c + j0 + j] = dinv;
    __syncthreads();
    if (ty < nb && tx > j && ty >= tx) t[ty][tx] -= t[ty][j] * t[tx][j];
    __syncthreads();
  }
  if (in && tx <= ty) lb[(size_t)(j0 + ty) * c + j0 + tx] = t[ty][tx];
}

__global__ void __launch_bounds__(PT)
panel_solve_kernel(float* __restrict__ l, const float* __restrict__ dinv_in, int c, int j0) {
  __shared__ float s_tile[NB][NB + 1];
  __shared__ float s_rows[PT][NB + 1];
  __shared__ float s_dinv[NB];
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int nb = min(NB, c - j0);
  const int row0 = j0 + nb + blockIdx.x * PT;
  const int nrows = min(PT, c - row0);
  float* lb = l + (size_t)b * c * c;

  for (int t = tid; t < NB * NB; t += PT) {
    const int ii = t / NB, jj = t - (t / NB) * NB;
    s_tile[ii][jj] = (ii < nb && jj < nb) ? lb[(size_t)(j0 + ii) * c + j0 + jj] : 0.0f;
  }
  for (int t = tid; t < PT * NB; t += PT) {
    const int rr = t / NB, jj = t - (t / NB) * NB;
    s_rows[rr][jj] = (rr < nrows && jj < nb) ? lb[(size_t)(row0 + rr) * c + j0 + jj] : 0.0f;
  }
  if (tid < NB) s_dinv[tid] = (tid < nb) ? dinv_in[(size_t)b * c + j0 + tid] : 0.0f;
  __syncthreads();

  if (tid < nrows) {
    for (int jj = 0; jj < nb; ++jj) {
      float s = s_rows[tid][jj];
      for (int t = 0; t < jj; ++t) s -= s_rows[tid][t] * s_tile[jj][t];
      s_rows[tid][jj] = s * s_dinv[jj];
    }
  }
  __syncthreads();

  for (int t = tid; t < PT * NB; t += PT) {
    const int rr = t / NB, jj = t - (t / NB) * NB;
    if (rr < nrows && jj < nb) lb[(size_t)(row0 + rr) * c + j0 + jj] = s_rows[rr][jj];
  }
}

__global__ void __launch_bounds__(UTH)
trailing_update_kernel(float* __restrict__ l, int c, int j0, int start) {
  __shared__ float s_a[NB][UT + 1];   // panel rows of the row tile, transposed
  __shared__ float s_b[NB][UT + 1];   // panel rows of the column tile, transposed
  const int b = blockIdx.y;
  // linear index over tiles on or below the diagonal -> (ti, tj), tj <= ti
  const int x = blockIdx.x;
  int ti = (int)((sqrtf(8.0f * x + 1.0f) - 1.0f) * 0.5f);
  while (ti * (ti + 1) / 2 > x) --ti;
  while ((ti + 1) * (ti + 2) / 2 <= x) ++ti;
  const int tj = x - ti * (ti + 1) / 2;

  const int nb = min(NB, c - j0);
  const int i0 = start + ti * UT;
  const int l0 = start + tj * UT;
  float* lb = l + (size_t)b * c * c;
  const int tid = threadIdx.x;

  for (int t = tid; t < UT * NB; t += UTH) {
    const int rr = t / NB, kk = t - (t / NB) * NB;
    const int ia = i0 + rr, ib = l0 + rr;
    s_a[kk][rr] = (ia < c && kk < nb) ? lb[(size_t)ia * c + j0 + kk] : 0.0f;
    s_b[kk][rr] = (ib < c && kk < nb) ? lb[(size_t)ib * c + j0 + kk] : 0.0f;
  }
  __syncthreads();

  const int ty = tid / 16, tx = tid - (tid / 16) * 16;
  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.0f;
  for (int kk = 0; kk < nb; ++kk) {
    float av[4], bv[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) av[p] = s_a[kk][ty + 16 * p];
#pragma unroll
    for (int q = 0; q < 4; ++q) bv[q] = s_b[kk][tx + 16 * q];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(av[p], bv[q], acc[p][q]);
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int i = i0 + ty + 16 * p;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = l0 + tx + 16 * q;
      if (i < c && j <= i) lb[(size_t)i * c + j] -= acc[p][q];
    }
  }
}

}  // namespace

// a: (B, c, c) SPD f32 (lower triangle read), l: (B, c, c) f32 output,
// dinv: scratch of B * c floats.  All contiguous.  B <= 65535.
extern "C" int repro_block_cholesky(const float* a, float* l, float* dinv, int B, int c,
                                    void* stream) {
  if (B <= 0 || c <= 0) return (int)cudaSuccess;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t total = (size_t)B * c * c;
  const int copy_blocks = (int)((total + 255) / 256 < 65536 * 16 ? (total + 255) / 256 : 65536 * 16);
  copy_lower_kernel<<<copy_blocks, 256, 0, s>>>(a, l, c, total);
  for (int j0 = 0; j0 < c; j0 += NB) {
    const int nb = (c - j0) < NB ? (c - j0) : NB;
    diag_factor_kernel<<<B, dim3(NB, NB), 0, s>>>(l, dinv, c, j0);
    const int start = j0 + nb;
    const int rem = c - start;
    if (rem <= 0) break;
    panel_solve_kernel<<<dim3((rem + PT - 1) / PT, B), PT, 0, s>>>(l, dinv, c, j0);
    const int tiles = (rem + UT - 1) / UT;
    trailing_update_kernel<<<dim3(tiles * (tiles + 1) / 2, B), UTH, 0, s>>>(l, c, j0, start);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
