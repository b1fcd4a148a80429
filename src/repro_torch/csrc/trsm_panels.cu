// Batched panel triangular solve Y[b] = L[b]^-1 X[b] (forward substitution).
//
// Replaces the TPU kernel src/repro/kernels/batched_trsm_lowrank/kernel.py:
// batched_trsm_panels_t (body _trsm_kernel): the TRSM task of the H-Cholesky
// schedule, one program per tile with L and the panel in VMEM and c axpy
// steps.  H-LU sends it the dense tiles of an elimination column as
// transposed (c, c) panels and the V factors of its low-rank tiles as
// (c, kp) panels, all against one freshly factored L_tt.
//
// Bound on the H100: operations for the dense tiles (c^2 P flops per panel
// against 2 c P floats moved, L read once for the batch), bytes for the
// low-rank panels.
//
// Design: the forward half of block_cholesky_solve.cu.  One CTA per (panel,
// chunk of RC columns): a (c, 256) panel does not fit in shared memory, a
// (c, RC) chunk does.  Row tiles of 32: warp 0 solves the diagonal tile
// (staged in shared memory, one lane per row, pivots broadcast by shuffle),
// then every thread updates its rows below from that tile's columns of L.
// Each row is updated in ascending pivot order, as the reference's axpy
// steps do, and divided by its diagonal clamped at 1e-30 as there.  L has
// a batch stride, 0 when one L_tt serves the whole batch.
#include <cuda_runtime.h>

namespace {

constexpr int TB = 32;     // row tile
constexpr int NTS = 256;   // threads per CTA
constexpr int RC = 8;      // panel columns per CTA
constexpr float TINY = 1e-30f;

__global__ void __launch_bounds__(NTS)
trsm_kernel(const float* __restrict__ l, long long l_stride, const float* __restrict__ x,
            float* __restrict__ y, int c, int P) {
  extern __shared__ float smem[];
  float* xs = smem;                               // c * RC
  float (*s_l)[TB + 1] = reinterpret_cast<float (*)[TB + 1]>(smem + (size_t)c * RC);

  const long long b = blockIdx.x;
  const int r0 = blockIdx.y * RC;
  const int nr = min(RC, P - r0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* lb = l + b * l_stride;
  const float* xb = x + b * c * (long long)P;
  float* yb = y + b * c * (long long)P;

  for (int t = tid; t < c * RC; t += NTS) {
    const int i = t / RC, q = t - (t / RC) * RC;
    xs[t] = (q < nr) ? xb[(size_t)i * P + r0 + q] : 0.0f;
  }
  __syncthreads();

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
        const float dd = s_l[jj][jj];
        const float d = fabsf(dd) > TINY ? dd : TINY;
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

  for (int t = tid; t < c * RC; t += NTS) {
    const int i = t / RC, q = t - (t / RC) * RC;
    if (q < nr) yb[(size_t)i * P + r0 + q] = xs[t];
  }
}

size_t smem_bytes(int c) { return sizeof(float) * ((size_t)c * RC + TB * (TB + 1)); }

}  // namespace

// Largest c the kernel takes (the (c, RC) chunk must fit in shared memory);
// the wrapper checks it before launching.
extern "C" int repro_trsm_max_c() {
  return (int)((227 * 1024 / sizeof(float) - TB * (TB + 1)) / RC);
}

// l: (B or 1, c, c) lower, with batch stride l_batch_stride floats (0 or
// c * c); x, y: (B, c, P); f32 contiguous.
extern "C" int repro_trsm_panels(const float* l, long long l_batch_stride, const float* x,
                                 float* y, int B, int c, int P, void* stream) {
  if (B <= 0 || c <= 0 || P <= 0) return (int)cudaSuccess;
  if ((P + RC - 1) / RC > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(c);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        trsm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  trsm_kernel<<<dim3(B, (P + RC - 1) / RC), NTS, smem, s>>>(l, l_batch_stride, x, y, c, P);
  return (int)cudaGetLastError();
}
