// Batched dense kernel-block product Y[b] = phi(rows[b], cols[b]) @ X[b].
//
// Replaces the TPU kernel src/repro/kernels/batched_dense_matvec/kernel.py:
// batched_kernel_matmat_t (body _kernel_mm), which generates the whole
// (C, C) block in VMEM and feeds one MXU product.
//
// Bound on the H100: operations.  Every block entry costs a squared
// distance, its phi (an exp for the Gaussian; a square root, a log and
// three precise divisions in the Matern polynomials) and 2R multiply-adds,
// while the bytes are only the points and the (C, R) panels; at C = 2048
// the generated block (16 MiB) is far beyond the 227 KB of shared memory.
// The precise expf is about 12 issued instructions (one on the 16-lane
// MUFU pipe), the Matern phi about a hundred (five on MUFU, with branches
// around the divisions' slow paths): instruction issue and latency, not
// the FMA rate alone, are the realistic limit.  The block is never stored anywhere,
// and the order of every sum is fixed: results are bit-reproducible and do
// not depend on the grid.  Two routes, picked from R alone.
//
// Narrow route (R <= 8: the vector form, PCG and H-LU panels).  A CTA of
// NT threads owns ROWS = NT x TR rows of one block and RC = 8 (or 1) panel
// columns: each thread holds TR rows (points in registers, TR x RC sums),
// so every staged column point and X row serves TR rows and shared-memory
// loads stay well below the FMAs (3 LDS.128 per column and thread at RC =
// 8, against TR x (distance, phi, RC FMAs)).  Columns are walked in tiles
// of TJ, double buffered: the next tile's column points (padded to 4
// floats) and X rows are copied with cp.async while the current one is
// consumed.  Each tile's sums are added to the row's total once per tile,
// which keeps the fp32 rounding near that of a blocked product.  Bound by
// phi at R <= 8: an entry's (distance, phi) outweighs its RC FMAs, and a
// wider panel would be cut into R / 8 slices that each compute phi again.
//
// Wide route (R > 8: the served panels, 16 to 64 wide).  A CTA of WNT =
// 256 threads owns CROWS rows of one block and a group of RW = 16, 32 or
// 64 panel columns (the narrowest that holds R; groups of 64 above), so up
// to 64 columns each entry's distance and phi are computed once.  Columns
// come in sub-tiles of WTS, double buffered with cp.async (X rows as
// 16-byte copies where R is a multiple of 4).  Per sub-tile, (1) each
// thread computes phi of its row against its share of the column points
// (broadcast from shared memory) into a shared tile P[WTS][CROWS], and (2)
// after one barrier a register-tiled product part += P^T X reads it: a
// thread owns TM rows x TN columns (8 x 4 at RW = 64: 3 LDS.128 per 32
// FFMA) in runs of 4, and a warp's 8 x 4 runs read 128 contiguous bytes of
// P and 64 of X.  The sums keep the narrow route's order exactly: per
// 128-column tile (WSUB sub-tiles) each (row, column) chains fmaf over the
// tile's columns from zero, and is then added to the row's total (kept in
// shared memory, which leaves the registers to more warps), so a column's
// result has the narrow route's bits (save the sign of an exact zero).
// Bound at R = 64 by the FMAs for the Gaussian (an entry issues ~16
// instructions of phi against 64 FFMA; 53% of the roofline on P's leaves)
// and by phi's long dependent chains for the Matern instance (precise
// divisions, log and sqrt with their slow-path branches; 40%), which is
// why each CTA has 256 threads and an SM 3 to 4 CTAs.  The split sits at
// R = 8: there the narrow route computes phi once already (one slice) with
// no shared-memory round trip, and from R = 9 on it would compute it twice
// or more.
//
// Operands are read in place: block b's rows are cluster rids[b] of rpts
// (C points each), its columns and its X rows cluster cids[b] of cpts and
// x.  The gathered form passes null ids (cluster b), so both forms run the
// same code and give the same bits.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "phi.cuh"

namespace {

// narrow route
constexpr int NT = 64;          // threads per CTA
constexpr int TR = 4;           // rows per thread
constexpr int ROWS = NT * TR;   // rows per CTA
constexpr int TJ = 128;         // columns per staged tile (and per partial sum)
constexpr int NARROW_MAX_R = 8; // widest panel of the narrow route

// wide route
constexpr int WNT = 256;        // threads per CTA
constexpr int WTS = 32;         // columns per staged sub-tile
constexpr int WSUB = TJ / WTS;  // sub-tiles per partial sum, as the narrow route's tile
constexpr int WRW = 64;         // panel columns per CTA at most
constexpr int kPhiUnroll = 4;

// The wide route's shape by the CTA's group of RW panel columns: rows a
// CTA, a thread's micro-tile in the product (TM rows x TN columns) and the
// CTAs an SM should hold (3 to 4: 24 to 32 warps, which the phi phase's
// long dependent chains need).
template <int RW> struct WideCfg;
template <> struct WideCfg<16> { static constexpr int ROWS = 256, TM = 4, TN = 4, MINB = 3; };
template <> struct WideCfg<32> { static constexpr int ROWS = 128, TM = 4, TN = 4, MINB = 4; };
template <> struct WideCfg<64> { static constexpr int ROWS = 128, TM = 8, TN = 4, MINB = 3; };

// panel columns per CTA of the wide route: the narrowest group that holds R
__host__ __device__ constexpr int wide_cols(int R) { return R <= 16 ? 16 : R <= 32 ? 32 : WRW; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// a copy of 0 source bytes writes zeros
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
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

// Shared memory of the wide route, in floats: phi P[WTS][ROWS], two
// buffers of X rows and of column points, and the row totals as float4s
// [TM TN / 4][WNT] (each thread's own, conflict-free).
template <int RW> struct WideSmem {
  using C = WideCfg<RW>;
  static constexpr int P = WTS * C::ROWS, X = WTS * RW, COLS = WTS * 4;
  static constexpr int FLOATS = P + 2 * X + 2 * COLS + C::ROWS * RW;
};

template <int D, int K, int RW>
__global__ void __launch_bounds__(WNT, WideCfg<RW>::MINB)
dense_matmat_kernel_wide(const float* __restrict__ rpts, const long long* __restrict__ rids,
                         const float* __restrict__ cpts, const long long* __restrict__ cids,
                         const float* __restrict__ x, float* __restrict__ y, int C, int R,
                         long long r_clusters, long long c_clusters, float matern_norm,
                         int vec) {
  using Cfg = WideCfg<RW>;
  using L = WideSmem<RW>;
  constexpr int CROWS = Cfg::ROWS, TM = Cfg::TM, TN = Cfg::TN;
  constexpr int RG = CROWS / TM, CG = RW / TN;     // row groups x column groups = threads
  constexpr int SPLIT = WNT / CROWS;              // threads per row in the phi phase
  static_assert(RG * CG == WNT && TM % 4 == 0 && TN % 4 == 0, "one micro-tile a thread");
  static_assert(RG % 8 == 0 && CG % 4 == 0 && (RG / 8) * (CG / 4) == WNT / 32,
                "a warp owns 8 row groups x 4 column groups");
  static_assert(SPLIT * CROWS == WNT && WTS % SPLIT == 0 && WTS * 4 <= WNT, "phi, staging");
  extern __shared__ __align__(16) float smem[];
  float* s_p = smem;
  float* s_x = s_p + L::P;
  float* s_cols = s_x + 2 * L::X;
  float4* s_acc = reinterpret_cast<float4*>(s_cols + 2 * L::COLS);

  const int tiles = (C + CROWS - 1) / CROWS;
  const int b = blockIdx.x / tiles;
  const int row0 = (blockIdx.x - b * tiles) * CROWS;
  const int r0 = blockIdx.y * RW;
  const int nr = min(RW, R - r0);
  const int tid = threadIdx.x;
  // the product's micro-tile: rows 4 rg + 4 RG a + e, columns 4 cg + 4 CG c + f;
  // a warp's 8 x 4 groups read 128 and 64 contiguous bytes of P and X
  const int warp = tid >> 5, lane = tid & 31;
  const int rg = (lane & 7) + 8 * (warp % (RG / 8));
  const int cg = (lane >> 3) + 4 * (warp / (RG / 8));

  const long long rid = rids ? rids[b] : b;
  const long long cid = cids ? cids[b] : b;
  const bool valid = rid >= 0 && rid < r_clusters && cid >= 0 && cid < c_clusters;
  const float* rb = rpts + (size_t)(valid ? rid : 0) * C * D;
  const float* cb = cpts + (size_t)(valid ? cid : 0) * C * D;
  const float* xb = x + (size_t)(valid ? cid : 0) * C * R + r0;

  // staging: a thread copies one coordinate of one column point and, per
  // pass, a run of X (4 floats where vec, else 1) of one column's row
  const int pj = tid >> 2, pdim = tid & 3;
  const int run = vec ? 4 : 1;
  const int runs = RW / run;                 // runs in a column's row of X
  const int xj = tid / runs, xq = (tid - xj * runs) * run;
  const int pass_cols = WNT / runs;
  auto stage = [&](int buf, int j0) {
    const int nj = min(WTS, C - j0);
    if (tid < WTS * 4) {
      const bool pok = pj < nj && pdim < D;
      cp_async4(s_cols + buf * L::COLS + tid, pok ? cb + (size_t)(j0 + pj) * D + pdim : cb,
                pok);
    }
    float* dst = s_x + buf * L::X + xj * RW + xq;
    const float* src = xb + (size_t)(j0 + xj) * R + xq;
    for (int k = 0; xj + k * pass_cols < WTS; ++k) {
      const bool ok = xj + k * pass_cols < nj && xq < nr;
      const float* at = ok ? src + (size_t)k * pass_cols * R : xb;
      if (vec) {
        cp_async16(dst + k * pass_cols * RW, at, ok);
      } else {
        cp_async4(dst + k * pass_cols * RW, at, ok);
      }
    }
    cp_async_commit();
  };

  // the phi phase: this thread's row and its share of the sub-tile's columns
  const int prow = tid % CROWS, pcol0 = (tid / CROWS) * (WTS / SPLIT);
  float p[D];
  {
    const int i = row0 + prow;
#pragma unroll
    for (int dim = 0; dim < D; ++dim) p[dim] = (i < C) ? rb[(size_t)i * D + dim] : 0.0f;
  }
  float part[TM][TN];
#pragma unroll
  for (int t = 0; t < TM; ++t)
#pragma unroll
    for (int q = 0; q < TN; ++q) part[t][q] = 0.0f;
#pragma unroll
  for (int k = 0; k < TM * TN / 4; ++k) s_acc[k * WNT + tid] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int nsub = (C + WTS - 1) / WTS;
  stage(0, 0);
  for (int sub = 0; sub < nsub; ++sub) {
    const int buf = sub & 1;
    cp_async_wait<0>();
    __syncthreads();   // this sub-tile has landed; every thread is done with s_p and buf ^ 1
    if (sub + 1 < nsub) stage(buf ^ 1, (sub + 1) * WTS);

    // (1) phi of this thread's row against its columns of the sub-tile.
    // Past C the points and X rows are zeros: phi is finite there and meets
    // X = 0, so those columns add nothing.
    {
      const float4* cols4 = reinterpret_cast<const float4*>(s_cols + buf * L::COLS) + pcol0;
      float* pt = s_p + pcol0 * CROWS + prow;
#pragma unroll kPhiUnroll
      for (int jj = 0; jj < WTS / SPLIT; ++jj) {
        const float4 c4 = cols4[jj];
        const float cq[4] = {c4.x, c4.y, c4.z, c4.w};
        pt[jj * CROWS] = repro::phi_from_sqdist<K>(repro::sqdist_direct<D>(p, cq), matern_norm);
      }
    }
    __syncthreads();

    // (2) part += P^T X over the sub-tile, column by column in order
    {
      const float* pp = s_p + 4 * rg;
      const float* xs = s_x + buf * L::X + 4 * cg;
#pragma unroll 8
      for (int jj = 0; jj < WTS; ++jj) {
        float pf[TM], xf[TN];
#pragma unroll
        for (int a = 0; a < TM / 4; ++a) {
          const float4 v = *reinterpret_cast<const float4*>(pp + jj * CROWS + 4 * RG * a);
          pf[4 * a] = v.x;
          pf[4 * a + 1] = v.y;
          pf[4 * a + 2] = v.z;
          pf[4 * a + 3] = v.w;
        }
#pragma unroll
        for (int c = 0; c < TN / 4; ++c) {
          const float4 w = *reinterpret_cast<const float4*>(xs + jj * RW + 4 * CG * c);
          xf[4 * c] = w.x;
          xf[4 * c + 1] = w.y;
          xf[4 * c + 2] = w.z;
          xf[4 * c + 3] = w.w;
        }
#pragma unroll
        for (int t = 0; t < TM; ++t)
#pragma unroll
          for (int q = 0; q < TN; ++q) part[t][q] = fmaf(pf[t], xf[q], part[t][q]);
      }
    }
    if ((sub + 1) % WSUB == 0 || sub + 1 == nsub) {   // the end of a TJ-column tile
#pragma unroll
      for (int t = 0; t < TM; ++t)
#pragma unroll
        for (int c = 0; c < TN / 4; ++c) {
          float4& a4 = s_acc[(t * (TN / 4) + c) * WNT + tid];
          float4 v = a4;
          v.x += part[t][4 * c];
          v.y += part[t][4 * c + 1];
          v.z += part[t][4 * c + 2];
          v.w += part[t][4 * c + 3];
          a4 = v;
#pragma unroll
          for (int f = 0; f < 4; ++f) part[t][4 * c + f] = 0.0f;
        }
    }
  }

#pragma unroll
  for (int t = 0; t < TM; ++t) {
    const int i = row0 + 4 * rg + 4 * RG * (t / 4) + (t % 4);
    if (i >= C) continue;
    float* yr = y + ((size_t)b * C + i) * R + r0;
#pragma unroll
    for (int c = 0; c < TN / 4; ++c) {
      const int q = 4 * cg + 4 * CG * c;
      float4 v = s_acc[(t * (TN / 4) + c) * WNT + tid];
      if (!valid) v = make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F);
      if (vec) {
        if (q < nr) *reinterpret_cast<float4*>(yr + q) = v;
      } else {
        const float vf[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          if (q + f < nr) yr[q + f] = vf[f];
        }
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

template <int D, int K, int RW>
void launch_wide(const float* rpts, const long long* rids, const float* cpts,
                 const long long* cids, const float* x, float* y, int B, int C, int R,
                 long long r_clusters, long long c_clusters, float matern_norm,
                 cudaStream_t stream) {
  using Cfg = WideCfg<RW>;
  constexpr size_t bytes = sizeof(float) * WideSmem<RW>::FLOATS;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(dense_matmat_kernel_wide<D, K, RW>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)bytes);
    if (err != cudaSuccess) return;   // reported by the entry's cudaGetLastError()
  }
  const dim3 grid((unsigned)B * ((C + Cfg::ROWS - 1) / Cfg::ROWS), (R + RW - 1) / RW);
  const int vec = R % 4 == 0 && (reinterpret_cast<size_t>(x) & 15) == 0
                  && (reinterpret_cast<size_t>(y) & 15) == 0;
  dense_matmat_kernel_wide<D, K, RW><<<grid, WNT, bytes, stream>>>(
      rpts, rids, cpts, cids, x, y, C, R, r_clusters, c_clusters, matern_norm, vec);
}

template <int D, int K>
void launch_rc(const float* rpts, const long long* rids, const float* cpts,
               const long long* cids, const float* x, float* y, int B, int C, int R,
               long long r_clusters, long long c_clusters, float matern_norm,
               cudaStream_t stream) {
  if (R == 1) {
    launch<D, K, 1>(rpts, rids, cpts, cids, x, y, B, C, R, r_clusters, c_clusters,
                    matern_norm, stream);
  } else if (R <= NARROW_MAX_R) {
    launch<D, K, 8>(rpts, rids, cpts, cids, x, y, B, C, R, r_clusters, c_clusters,
                    matern_norm, stream);
  } else if (wide_cols(R) == 16) {
    launch_wide<D, K, 16>(rpts, rids, cpts, cids, x, y, B, C, R, r_clusters, c_clusters,
                          matern_norm, stream);
  } else if (wide_cols(R) == 32) {
    launch_wide<D, K, 32>(rpts, rids, cpts, cids, x, y, B, C, R, r_clusters, c_clusters,
                          matern_norm, stream);
  } else {
    launch_wide<D, K, WRW>(rpts, rids, cpts, cids, x, y, B, C, R, r_clusters, c_clusters,
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
  // grid.x = blocks x row tiles, grid.y = column groups, as the route picks them
  const bool wide = R > NARROW_MAX_R;
  const int cols = wide ? wide_cols(R) : NARROW_MAX_R;
  const int rows = !wide ? ROWS
                   : cols == 16 ? WideCfg<16>::ROWS : cols == 32 ? WideCfg<32>::ROWS
                   : WideCfg<WRW>::ROWS;
  if ((long long)B * ((C + rows - 1) / rows) > 0x7FFFFFFFLL || (R + cols - 1) / cols > 65535) {
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
