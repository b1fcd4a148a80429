// Batched block-Jacobi apply Y[b] = (L[b] L[b]^T)^{-1} X[b].
//
// Replaces the TPU kernel src/repro/kernels/batched_block_solve/kernel.py:
// batched_block_cholesky_solve_t (body _chol_solve_kernel), which holds L,
// a transposed copy of L and the panel in VMEM and runs 2c axpy steps.
//
// Bound on the H100: bytes.  Each call reads the lower triangle of every
// factor twice (forward and back sweep) against 2 c^2 R flops per block:
// at R = 8 about 2 flops per byte.  The paper's problem reads ~8.6 GB per
// call, once per PCG iteration.
//
// Design: one CTA per (block, chunk of RC right-hand sides).  The (c, RC)
// panel lives in shared memory for the whole solve.  The forward sweep
// walks row tiles of 32: warp 0 solves the 32 x 32 diagonal tile (staged
// in shared memory, one lane per row, pivots broadcast by shuffle), then
// every thread updates its rows below from that tile's columns of L.  The
// back sweep walks the tiles in reverse and reads L^T as rows of L: the
// update of row t above the tile reads L[j0 + jj, t], which neighbouring
// threads read at neighbouring addresses.  No transposed copy of L is
// built.  Each row is updated in the reference's order (ascending pivots
// forward, descending back), with divisions by the diagonal as there.
#include <cuda_runtime.h>

namespace {

constexpr int TB = 32;    // row tile
constexpr int NTS = 256;  // threads per CTA

template <int RC>
__global__ void __launch_bounds__(NTS)
chol_solve_kernel(const float* __restrict__ l, const float* __restrict__ x,
                  float* __restrict__ y, int c, int R) {
  extern __shared__ float smem[];
  float* xs = smem;                               // c * RC
  float (*s_l)[TB + 1] = reinterpret_cast<float (*)[TB + 1]>(smem + (size_t)c * RC);

  const int b = blockIdx.x;
  const int r0 = blockIdx.y * RC;
  const int nr = min(RC, R - r0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* lb = l + (size_t)b * c * c;

  for (int t = tid; t < c * RC; t += NTS) {
    const int i = t / RC, q = t - (t / RC) * RC;
    xs[t] = (q < nr) ? x[((size_t)b * c + i) * R + r0 + q] : 0.0f;
  }
  __syncthreads();

  // ---- forward sweep: L Y1 = X
  for (int j0 = 0; j0 < c; j0 += TB) {
    const int nb = min(TB, c - j0);
    for (int t = tid; t < TB * TB; t += NTS) {
      const int ii = t / TB, jj = t - (t / TB) * TB;
      s_l[ii][jj] = (ii < nb && jj < nb) ? lb[(size_t)(j0 + ii) * c + j0 + jj] : 0.0f;
    }
    __syncthreads();
    if (warp == 0) {
      float v[RC];
#pragma unroll
      for (int q = 0; q < RC; ++q) v[q] = (lane < nb) ? xs[(j0 + lane) * RC + q] : 0.0f;
      for (int jj = 0; jj < nb; ++jj) {
        const float d = s_l[jj][jj];
        const float ljj = s_l[lane][jj];
#pragma unroll
        for (int q = 0; q < RC; ++q) {
          const float yq = __shfl_sync(0xffffffffu, v[q], jj) / d;
          if (lane == jj) {
            v[q] = yq;
          } else if (lane > jj) {
            v[q] -= ljj * yq;
          }
        }
      }
      if (lane < nb) {
#pragma unroll
        for (int q = 0; q < RC; ++q) xs[(j0 + lane) * RC + q] = v[q];
      }
    }
    __syncthreads();
    for (int i = j0 + nb + tid; i < c; i += NTS) {
      float acc[RC];
#pragma unroll
      for (int q = 0; q < RC; ++q) acc[q] = xs[i * RC + q];
      const float* lrow = lb + (size_t)i * c + j0;
      for (int jj = 0; jj < nb; ++jj) {
        const float lij = lrow[jj];
#pragma unroll
        for (int q = 0; q < RC; ++q) acc[q] -= lij * xs[(j0 + jj) * RC + q];
      }
#pragma unroll
      for (int q = 0; q < RC; ++q) xs[i * RC + q] = acc[q];
    }
    __syncthreads();
  }

  // ---- back sweep: L^T Y = Y1
  const int last = ((c - 1) / TB) * TB;
  for (int j0 = last; j0 >= 0; j0 -= TB) {
    const int nb = min(TB, c - j0);
    for (int t = tid; t < TB * TB; t += NTS) {
      const int ii = t / TB, jj = t - (t / TB) * TB;
      s_l[ii][jj] = (ii < nb && jj < nb) ? lb[(size_t)(j0 + ii) * c + j0 + jj] : 0.0f;
    }
    __syncthreads();
    if (warp == 0) {
      float v[RC];
#pragma unroll
      for (int q = 0; q < RC; ++q) v[q] = (lane < nb) ? xs[(j0 + lane) * RC + q] : 0.0f;
      for (int jj = nb - 1; jj >= 0; --jj) {
        const float d = s_l[jj][jj];
        const float lji = s_l[jj][lane];   // L^T[lane, jj]
#pragma unroll
        for (int q = 0; q < RC; ++q) {
          const float zq = __shfl_sync(0xffffffffu, v[q], jj) / d;
          if (lane == jj) {
            v[q] = zq;
          } else if (lane < jj) {
            v[q] -= lji * zq;
          }
        }
      }
      if (lane < nb) {
#pragma unroll
        for (int q = 0; q < RC; ++q) xs[(j0 + lane) * RC + q] = v[q];
      }
    }
    __syncthreads();
    for (int t = tid; t < j0; t += NTS) {
      float acc[RC];
#pragma unroll
      for (int q = 0; q < RC; ++q) acc[q] = xs[t * RC + q];
      for (int jj = nb - 1; jj >= 0; --jj) {
        const float lt = lb[(size_t)(j0 + jj) * c + t];
#pragma unroll
        for (int q = 0; q < RC; ++q) acc[q] -= lt * xs[(j0 + jj) * RC + q];
      }
#pragma unroll
      for (int q = 0; q < RC; ++q) xs[t * RC + q] = acc[q];
    }
    __syncthreads();
  }

  for (int t = tid; t < c * RC; t += NTS) {
    const int i = t / RC, q = t - (t / RC) * RC;
    if (q < nr) y[((size_t)b * c + i) * R + r0 + q] = xs[t];
  }
}

template <int RC>
int launch(const float* l, const float* x, float* y, int B, int c, int R, cudaStream_t s) {
  const size_t smem = sizeof(float) * ((size_t)c * RC + TB * (TB + 1));
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(chol_solve_kernel<RC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  chol_solve_kernel<RC><<<dim3(B, (R + RC - 1) / RC), NTS, smem, s>>>(l, x, y, c, R);
  return (int)cudaGetLastError();
}

}  // namespace

// Largest c the kernel takes for a given R (the panel chunk must fit in
// shared memory); the wrapper checks it before launching.
extern "C" int repro_chol_solve_max_c(int R) {
  const int rc = (R == 1) ? 1 : 8;
  return (int)((227 * 1024 / sizeof(float) - TB * (TB + 1)) / rc);
}

// l: (B, c, c) lower factors, x: (B, c, R), y: (B, c, R); f32 contiguous.
extern "C" int repro_block_cholesky_solve(const float* l, const float* x, float* y, int B,
                                          int c, int R, void* stream) {
  if (B <= 0 || c <= 0 || R <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (R == 1) ? launch<1>(l, x, y, B, c, R, s) : launch<8>(l, x, y, B, c, R, s);
}
