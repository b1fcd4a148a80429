// Batched dense kernel-block product Y[b] = phi(rows[b], cols[b]) @ X[b].
//
// Replaces the TPU kernel src/repro/kernels/batched_dense_matvec/kernel.py:
// batched_kernel_matmat_t (body _kernel_mm), which generates the whole
// (C, C) block in VMEM and feeds one MXU product.
//
// Bound on the H100: operations.  Every block entry costs a squared
// distance, one exp (or the Matern polynomial) and 2R multiply-adds, while
// the bytes are only the points and the (C, R) panels; at C = 2048 the
// generated block (16 MiB) is far beyond the 227 KB of shared memory.  With
// the precise expf (about 8 instructions, one on the MUFU pipe) an entry
// issues about 20 instructions at R = 8: instruction issue, not the FMA
// rate alone, is the realistic limit.
//
// Design: the block is never stored anywhere.  A CTA of NT threads owns
// ROWS = NT x TR rows of one block: each thread holds TR rows (points in
// registers, TR x RC sums), so every staged column point and X row serves
// TR rows and shared-memory loads stay well below the FMAs (3 LDS.128 per
// column and thread at RC = 8, against TR x (distance, phi, RC FMAs)).
// Columns are walked in tiles of TJ, double buffered: the next tile's
// column points (padded to 4 floats) and X rows are copied with cp.async
// while the current one is consumed.  Each tile's sums are added to the
// row's total once per tile, which keeps the fp32 rounding near that of a
// blocked product.  Fixed order throughout: results are bit-reproducible
// and do not depend on the grid.
//
// Operands are read in place: block b's rows are cluster rids[b] of rpts
// (C points each), its columns and its X rows cluster cids[b] of cpts and
// x.  The gathered form passes null ids (cluster b), so both forms run the
// same code and give the same bits.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "phi.cuh"

namespace {

constexpr int NT = 64;          // threads per CTA
constexpr int TR = 4;           // rows per thread
constexpr int ROWS = NT * TR;   // rows per CTA
constexpr int TJ = 128;         // columns per staged tile

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// a copy of 0 source bytes writes zeros
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int D, int K, int RC>
__global__ void __launch_bounds__(NT, 8)
dense_matmat_kernel(const float* __restrict__ rpts, const long long* __restrict__ rids,
                    const float* __restrict__ cpts, const long long* __restrict__ cids,
                    const float* __restrict__ x, float* __restrict__ y, int C, int R,
                    long long r_clusters, long long c_clusters, float matern_norm) {
  __shared__ __align__(16) float s_cols[2][TJ * 4];
  __shared__ __align__(16) float s_x[2][TJ * RC];

  // grid.x runs over (block, row tile) pairs: the batch may exceed 65535
  const int tiles = (C + ROWS - 1) / ROWS;
  const int b = blockIdx.x / tiles;
  const int row0 = (blockIdx.x - b * tiles) * ROWS;
  const int r0 = blockIdx.y * RC;
  const int nr = min(RC, R - r0);
  const int tid = threadIdx.x;

  const long long rid = rids ? rids[b] : b;
  const long long cid = cids ? cids[b] : b;
  const bool valid = rid >= 0 && rid < r_clusters && cid >= 0 && cid < c_clusters;
  const float* rb = rpts + (size_t)(valid ? rid : 0) * C * D;
  const float* cb = cpts + (size_t)(valid ? cid : 0) * C * D;
  const float* xb = x + (size_t)(valid ? cid : 0) * C * R;

  auto stage = [&](int buf, int j0) {
    const int nj = min(TJ, C - j0);
    for (int e = tid; e < TJ * 4; e += NT) {
      const int jj = e >> 2, dim = e & 3;
      const bool ok = jj < nj && dim < D;
      cp_async4(&s_cols[buf][e], ok ? cb + (size_t)(j0 + jj) * D + dim : cb, ok);
    }
    for (int e = tid; e < TJ * RC; e += NT) {
      const int jj = e / RC, q = e - jj * RC;
      const bool ok = jj < nj && q < nr;
      cp_async4(&s_x[buf][e], ok ? xb + (size_t)(j0 + jj) * R + r0 + q : xb, ok);
    }
    cp_async_commit();
  };

  float p[TR][D];
#pragma unroll
  for (int t = 0; t < TR; ++t) {
    const int i = row0 + tid + t * NT;
#pragma unroll
    for (int dim = 0; dim < D; ++dim) p[t][dim] = (i < C) ? rb[(size_t)i * D + dim] : 0.0f;
  }
  float acc[TR][RC];
#pragma unroll
  for (int t = 0; t < TR; ++t)
#pragma unroll
    for (int q = 0; q < RC; ++q) acc[t][q] = 0.0f;

  const int ntiles = (C + TJ - 1) / TJ;
  stage(0, 0);
  for (int tile = 0; tile < ntiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < ntiles) {
      stage(buf ^ 1, (tile + 1) * TJ);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int nj = min(TJ, C - tile * TJ);
    const float4* cols4 = reinterpret_cast<const float4*>(s_cols[buf]);
    const float* xs = s_x[buf];
    float part[TR][RC];
#pragma unroll
    for (int t = 0; t < TR; ++t)
#pragma unroll
      for (int q = 0; q < RC; ++q) part[t][q] = 0.0f;
#pragma unroll 4
    for (int jj = 0; jj < nj; ++jj) {
      const float4 c4 = cols4[jj];
      const float cq[4] = {c4.x, c4.y, c4.z, c4.w};
      float xv[RC];
      if constexpr (RC % 4 == 0) {
        const float4* x4 = reinterpret_cast<const float4*>(xs + jj * RC);
#pragma unroll
        for (int q4 = 0; q4 < RC / 4; ++q4) {
          const float4 w = x4[q4];
          xv[4 * q4] = w.x;
          xv[4 * q4 + 1] = w.y;
          xv[4 * q4 + 2] = w.z;
          xv[4 * q4 + 3] = w.w;
        }
      } else {
#pragma unroll
        for (int q = 0; q < RC; ++q) xv[q] = xs[jj * RC + q];
      }
#pragma unroll
      for (int t = 0; t < TR; ++t) {
        const float a = repro::phi_from_sqdist<K>(repro::sqdist_direct<D>(p[t], cq),
                                                  matern_norm);
#pragma unroll
        for (int q = 0; q < RC; ++q) part[t][q] = fmaf(a, xv[q], part[t][q]);
      }
    }
#pragma unroll
    for (int t = 0; t < TR; ++t)
#pragma unroll
      for (int q = 0; q < RC; ++q) acc[t][q] += part[t][q];
    __syncthreads();   // every thread is done with buf before it is staged again
  }

#pragma unroll
  for (int t = 0; t < TR; ++t) {
    const int i = row0 + tid + t * NT;
    if (i < C) {
      float* yr = y + ((size_t)b * C + i) * R + r0;
#pragma unroll
      for (int q = 0; q < RC; ++q) {
        if (q < nr) yr[q] = valid ? acc[t][q] : CUDART_NAN_F;
      }
    }
  }
}

template <int D, int K, int RC>
void launch(const float* rpts, const long long* rids, const float* cpts, const long long* cids,
            const float* x, float* y, int B, int C, int R, long long r_clusters,
            long long c_clusters, float matern_norm, cudaStream_t stream) {
  const dim3 grid((unsigned)B * ((C + ROWS - 1) / ROWS), (R + RC - 1) / RC);
  dense_matmat_kernel<D, K, RC><<<grid, NT, 0, stream>>>(rpts, rids, cpts, cids, x, y, C, R,
                                                        r_clusters, c_clusters, matern_norm);
}

template <int D, int K>
void launch_rc(const float* rpts, const long long* rids, const float* cpts,
               const long long* cids, const float* x, float* y, int B, int C, int R,
               long long r_clusters, long long c_clusters, float matern_norm,
               cudaStream_t stream) {
  if (R == 1) {
    launch<D, K, 1>(rpts, rids, cpts, cids, x, y, B, C, R, r_clusters, c_clusters,
                    matern_norm, stream);
  } else {
    launch<D, K, 8>(rpts, rids, cpts, cids, x, y, B, C, R, r_clusters, c_clusters,
                    matern_norm, stream);
  }
}

template <int D>
void launch_k(const float* rpts, const long long* rids, const float* cpts, const long long* cids,
              const float* x, float* y, int B, int C, int R, long long r_clusters,
              long long c_clusters, int kernel_id, float matern_norm, cudaStream_t stream) {
  if (kernel_id == repro::KERNEL_GAUSSIAN) {
    launch_rc<D, repro::KERNEL_GAUSSIAN>(rpts, rids, cpts, cids, x, y, B, C, R, r_clusters,
                                         c_clusters, matern_norm, stream);
  } else {
    launch_rc<D, repro::KERNEL_MATERN>(rpts, rids, cpts, cids, x, y, B, C, R, r_clusters,
                                       c_clusters, matern_norm, stream);
  }
}

}  // namespace

// Block b: rows = cluster rids[b] of rpts, columns = cluster cids[b] of
// cpts, X = cluster cids[b] of x (clusters of C points of d floats and of
// C rows of R floats, contiguous; rpts holds r_clusters clusters, cpts and
// x c_clusters).  Null ids mean cluster b.  y: (B, C, R) f32.  A block
// whose id lies outside its array gets NaN rows (nothing outside the
// arrays is read).  d in {1, 2, 3}; kernel_id 0 = gaussian, 1 = matern.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// an unsupported d or kernel).
extern "C" int repro_dense_matmat_ids(const float* rpts, const long long* rids,
                                      const float* cpts, const long long* cids, const float* x,
                                      float* y, int B, int C, int d, int R,
                                      long long r_clusters, long long c_clusters, int kernel_id,
                                      float matern_norm, void* stream) {
  if (B <= 0 || C <= 0 || R <= 0) return (int)cudaSuccess;
  if (kernel_id != repro::KERNEL_GAUSSIAN && kernel_id != repro::KERNEL_MATERN) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)B * ((C + ROWS - 1) / ROWS) > 0x7FFFFFFFLL || (R + 7) / 8 > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: launch_k<1>(rpts, rids, cpts, cids, x, y, B, C, R, r_clusters, c_clusters,
                        kernel_id, matern_norm, s);
            break;
    case 2: launch_k<2>(rpts, rids, cpts, cids, x, y, B, C, R, r_clusters, c_clusters,
                        kernel_id, matern_norm, s);
            break;
    case 3: launch_k<3>(rpts, rids, cpts, cids, x, y, B, C, R, r_clusters, c_clusters,
                        kernel_id, matern_norm, s);
            break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// rows, cols: (B, C, d) f32; x: (B, C, R) f32; y: (B, C, R) f32, all
// contiguous: the gathered form of repro_dense_matmat_ids.
extern "C" int repro_dense_matmat(const float* rows, const float* cols, const float* x,
                                  float* y, int B, int C, int d, int R, int kernel_id,
                                  float matern_norm, void* stream) {
  return repro_dense_matmat_ids(rows, nullptr, cols, nullptr, x, y, B, C, d, R, B, B,
                                kernel_id, matern_norm, stream);
}

// The vector form y[b] = phi(rows[b], cols[b]) @ x[b], which replaces the TPU
// kernel batched_kernel_matvec_t (src/repro/kernels/batched_dense_matvec/
// kernel.py, body _kernel): the RC = 1 instance of the kernel above.
// rows, cols: (B, C, d) f32; x, y: (B, C) f32, all contiguous.
extern "C" int repro_dense_matvec(const float* rows, const float* cols, const float* x,
                                  float* y, int B, int C, int d, int kernel_id,
                                  float matern_norm, void* stream) {
  return repro_dense_matmat_ids(rows, nullptr, cols, nullptr, x, y, B, C, d, 1, B, B,
                                kernel_id, matern_norm, stream);
}
