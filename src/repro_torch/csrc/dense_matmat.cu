// Batched dense kernel-block product Y[b] = phi(rows[b], cols[b]) @ X[b].
//
// Replaces the TPU kernel src/repro/kernels/batched_dense_matvec/kernel.py:
// batched_kernel_matmat_t (body _kernel_mm), which generates the whole
// (C, C) block in VMEM and feeds one MXU product.
//
// Bound on the H100: operations.  Every block entry costs a squared
// distance, one exp (or the Matern polynomial) and 2R multiply-adds, while
// the bytes are only the points and the (C, R) panels; at C = 2048 the
// generated block (16 MiB) is far beyond the 227 KB of shared memory.
//
// Design: the block is never stored anywhere.  A CTA owns ROWS rows of one
// block (one row per thread, its point in registers) and a chunk of RC
// right-hand sides.  It walks the columns in tiles of TJ: the tile's column
// points and X rows are staged in shared memory (every thread then reads
// the same address, a broadcast), the thread generates phi for its row and
// accumulates RC sums in registers.  Each tile's sums are added to the
// row's total once per tile, which keeps the fp32 rounding near that of a
// blocked product.  Fixed order throughout: results are bit-reproducible.
#include <cuda_runtime.h>

#include "phi.cuh"

namespace {

constexpr int ROWS = 128;  // rows per CTA == threads per CTA
constexpr int TJ = 128;    // columns per staged tile

template <int D, int K, int RC>
__global__ void __launch_bounds__(ROWS)
dense_matmat_kernel(const float* __restrict__ rows, const float* __restrict__ cols,
                    const float* __restrict__ x, float* __restrict__ y,
                    int C, int R, float matern_norm) {
  __shared__ float s_cols[TJ * D];
  __shared__ float s_x[TJ * RC];

  // grid.x runs over (block, row tile) pairs: the batch may exceed 65535
  const int tiles = (C + ROWS - 1) / ROWS;
  const int b = blockIdx.x / tiles;
  const int i = (blockIdx.x - b * tiles) * ROWS + threadIdx.x;
  const int r0 = blockIdx.y * RC;
  const int nr = min(RC, R - r0);

  const float* rb = rows + (size_t)b * C * D;
  const float* cb = cols + (size_t)b * C * D;
  const float* xb = x + (size_t)b * C * R;

  float p[D];
#pragma unroll
  for (int k = 0; k < D; ++k) p[k] = (i < C) ? rb[(size_t)i * D + k] : 0.0f;

  float acc[RC];
#pragma unroll
  for (int q = 0; q < RC; ++q) acc[q] = 0.0f;

  for (int j0 = 0; j0 < C; j0 += TJ) {
    const int nj = min(TJ, C - j0);
    for (int t = threadIdx.x; t < TJ * D; t += ROWS) {
      s_cols[t] = (t < nj * D) ? cb[(size_t)j0 * D + t] : 0.0f;
    }
    for (int t = threadIdx.x; t < TJ * RC; t += ROWS) {
      const int jj = t / RC;
      const int q = t - jj * RC;
      s_x[t] = (jj < nj && q < nr) ? xb[(size_t)(j0 + jj) * R + r0 + q] : 0.0f;
    }
    __syncthreads();

    float part[RC];
#pragma unroll
    for (int q = 0; q < RC; ++q) part[q] = 0.0f;
#pragma unroll 4
    for (int jj = 0; jj < nj; ++jj) {
      const float d2 = repro::sqdist_direct<D>(p, &s_cols[jj * D]);
      const float a = repro::phi_from_sqdist<K>(d2, matern_norm);
#pragma unroll
      for (int q = 0; q < RC; ++q) part[q] = fmaf(a, s_x[jj * RC + q], part[q]);
    }
#pragma unroll
    for (int q = 0; q < RC; ++q) acc[q] += part[q];
    __syncthreads();
  }

  if (i < C) {
    float* yb = y + ((size_t)b * C + i) * R + r0;
#pragma unroll
    for (int q = 0; q < RC; ++q) {
      if (q < nr) yb[q] = acc[q];
    }
  }
}

template <int D, int K, int RC>
void launch(const float* rows, const float* cols, const float* x, float* y,
            int B, int C, int R, float matern_norm, cudaStream_t stream) {
  const dim3 grid((unsigned)B * ((C + ROWS - 1) / ROWS), (R + RC - 1) / RC);
  dense_matmat_kernel<D, K, RC><<<grid, ROWS, 0, stream>>>(rows, cols, x, y, C, R,
                                                          matern_norm);
}

template <int D, int K>
void launch_rc(const float* rows, const float* cols, const float* x, float* y,
               int B, int C, int R, float matern_norm, cudaStream_t stream) {
  if (R == 1) {
    launch<D, K, 1>(rows, cols, x, y, B, C, R, matern_norm, stream);
  } else {
    launch<D, K, 8>(rows, cols, x, y, B, C, R, matern_norm, stream);
  }
}

template <int D>
void launch_k(const float* rows, const float* cols, const float* x, float* y,
              int B, int C, int R, int kernel_id, float matern_norm, cudaStream_t stream) {
  if (kernel_id == repro::KERNEL_GAUSSIAN) {
    launch_rc<D, repro::KERNEL_GAUSSIAN>(rows, cols, x, y, B, C, R, matern_norm, stream);
  } else {
    launch_rc<D, repro::KERNEL_MATERN>(rows, cols, x, y, B, C, R, matern_norm, stream);
  }
}

template <int D>
void launch_matvec(const float* rows, const float* cols, const float* x, float* y, int B,
                   int C, int kernel_id, float matern_norm, cudaStream_t stream) {
  if (kernel_id == repro::KERNEL_GAUSSIAN) {
    launch<D, repro::KERNEL_GAUSSIAN, 1>(rows, cols, x, y, B, C, 1, matern_norm, stream);
  } else {
    launch<D, repro::KERNEL_MATERN, 1>(rows, cols, x, y, B, C, 1, matern_norm, stream);
  }
}

}  // namespace

// rows, cols: (B, C, d) f32; x: (B, C, R) f32; y: (B, C, R) f32, all
// contiguous.  d in {1, 2, 3}; kernel_id 0 = gaussian, 1 = matern.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// an unsupported d or kernel).
extern "C" int repro_dense_matmat(const float* rows, const float* cols, const float* x,
                                  float* y, int B, int C, int d, int R, int kernel_id,
                                  float matern_norm, void* stream) {
  if (B <= 0 || C <= 0 || R <= 0) return (int)cudaSuccess;
  if (kernel_id != repro::KERNEL_GAUSSIAN && kernel_id != repro::KERNEL_MATERN) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: launch_k<1>(rows, cols, x, y, B, C, R, kernel_id, matern_norm, s); break;
    case 2: launch_k<2>(rows, cols, x, y, B, C, R, kernel_id, matern_norm, s); break;
    case 3: launch_k<3>(rows, cols, x, y, B, C, R, kernel_id, matern_norm, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The vector form y[b] = phi(rows[b], cols[b]) @ x[b], which replaces the TPU
// kernel batched_kernel_matvec_t (src/repro/kernels/batched_dense_matvec/
// kernel.py, body _kernel): the RC = 1 instance of the kernel above.
// rows, cols: (B, C, d) f32; x, y: (B, C) f32, all contiguous.
extern "C" int repro_dense_matvec(const float* rows, const float* cols, const float* x,
                                  float* y, int B, int C, int d, int kernel_id,
                                  float matern_norm, void* stream) {
  if (B <= 0 || C <= 0) return (int)cudaSuccess;
  if (kernel_id != repro::KERNEL_GAUSSIAN && kernel_id != repro::KERNEL_MATERN) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: launch_matvec<1>(rows, cols, x, y, B, C, kernel_id, matern_norm, s); break;
    case 2: launch_matvec<2>(rows, cols, x, y, B, C, kernel_id, matern_norm, s); break;
    case 3: launch_matvec<3>(rows, cols, x, y, B, C, kernel_id, matern_norm, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
