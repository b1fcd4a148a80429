// Batched Cholesky factorisation L[b] L[b]^T = A[b] of SPD (c x c) blocks.
//
// Replaces the TPU kernel src/repro/kernels/batched_block_solve/kernel.py:
// batched_block_cholesky_t (body _chol_kernel), a right-looking
// factorisation of one block held whole in VMEM as c rank-1 updates.
//
// Bound on the H100: c^3 / 3 flops a block (c^3 / 6 fused multiply-adds):
// 9.2e10 flops for 32 of the paper's blocks of 2048, 1.37 ms at the fp32
// rate of 67 TFLOP/s.  At c = 256 (the regression problem's blocks) the
// bytes bound instead: A's lower triangle read and L written once,
// (c (c + 1) / 2 + c^2) x 4 bytes a block against c^3 / 3 flops, 14 flops
// a byte (the ridge is 20).
//
// Pivot rule of the reference: dinv = rsqrt(max(d, 1e-30)) and
// L[:, j] = residual[:, j] * dinv; exact zeros above the diagonal.  fp32
// throughout, no tensor cores.  Every entry's updates run in a fixed order,
// with no atomics and no split-K: two calls give the same bits.  The route
// is picked by c alone.
//
// Route S, c <= C_S (288): one launch, one CTA of 16 warps per block.  The
// block's lower triangle lives in shared memory as 32 x 32 tiles (rows
// padded to 36 floats: 16-byte rows, conflict-free float4 reads of 8
// consecutive rows), copied in with 16-byte cp.async (tile column 0 first,
// so that the first diagonal tile starts while the rest arrives).  Per
// panel of 32 columns, three CTA barriers:
//   A  one warp factors the diagonal tile in registers (a lane per row),
//      broadcasting each pivot and each column by shuffles (the next
//      pivot's rsqrt issued before the step's other updates: it is the
//      chain), and leaves L^T above the tile's diagonal and dinv in its
//      padding column;
//   B  a warp per tile below solves its 32 rows (a lane per row) against
//      the tile, reading L^T rows as float4 broadcasts; the finished column
//      of L (zeros above the diagonal, and the zeros right of the diagonal
//      tile) is then written to device memory while the next phase runs;
//   C  the rank-32 trailing update, one 32 x 32 tile per warp, 4 x 8 a lane
//      from float4 reads of the two panel tiles.
// The largest c: 45 tiles (c = 288) take 207,360 bytes of the 232,448 a
// CTA may use; 55 (c = 320) would take 253,440.
//
// Route L, c > C_S: right-looking in steps of NB = 128 columns, three
// launches batched over all blocks per step (46 at c = 2048):
//   diagonal  the 128 x 128 diagonal tile, by route S's kernel on the
//             sub-block (dinv to scratch for the panel);
//   panel     L21 = A21 L11^-T with the reference's rule: a CTA per 64 rows
//             with L11 in shared memory, four 32-column substitutions
//             (route S's row solve) each followed by a register-tiled
//             update of the columns to its right; it also writes the zeros
//             above the diagonal in the rows of the step;
//   update    A22 -= L21 L21^T on 128 x 128 tiles: the SIMT SGEMM tile of
//             csrc/schur_dense.cu (8 x 8 a thread, 16-deep slices through a
//             2-stage 16-byte cp.async ring, the target tile copied during
//             the products once the first slice is in and taken into the
//             accumulators after the first 32 columns, so that the rest
//             land on the residual as the reference's rank-1 updates do).
//             Two-level: an even
//             step updates only the next step's 128 columns (depth 128); an
//             odd step updates the lower tiles of the whole trailing
//             triangle with both steps' panels (depth 256).  So most
//             trailing entries are read and written once per 256 columns,
//             with the launches and panel widths of 128-column steps.
// Step 0 reads A and writes L (no separate copy); later steps work in L
// (the first depth-256 update also reads A: nothing has touched its
// triangle yet).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr float TINY = 1e-30f;
constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------- cp.async
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// copies of 4 and 16 bytes; a copy of 0 source bytes writes zeros
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

// ------------------------------------------------------------- 32-wide tiles
constexpr int TB = 32;              // tile edge, panel width of route S
constexpr int TS = TB + 4;          // row stride of a tile in shared memory
constexpr int TILE = TB * TS;       // floats per tile
constexpr int SNT = 512;            // threads of a route-S CTA
constexpr int SNW = SNT / 32;
constexpr long long SMEM_MAX = 232448;   // shared memory a CTA may use

__host__ __device__ constexpr int tri(int n) { return n * (n + 1) / 2; }

constexpr int shared_tiles_max() {
  int nt = 1;
  while ((long long)tri(nt + 1) * TILE * 4 <= SMEM_MAX) ++nt;
  return nt;
}

constexpr int NT_S = shared_tiles_max();
constexpr int C_S = NT_S * TB;      // largest c of route S
static_assert(C_S == 288, "route S holds the lower triangle of c = 288");

// Row x (32 entries, 16-byte aligned) against a factored diagonal tile t of
// row stride S (L^T above its diagonal, dinv_j at dv[j * S]):
// x_j <- (x_j - sum_{k<j} x_k L_jk) * dinv_j, each entry's updates in
// ascending k, as the reference's rank-1 updates.
template <int S>
__device__ __forceinline__ void solve_row32(float* x, const float* t, const float* dv) {
  float s[TB];
#pragma unroll
  for (int q = 0; q < TB / 4; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(x + 4 * q);
    s[4 * q] = v.x; s[4 * q + 1] = v.y; s[4 * q + 2] = v.z; s[4 * q + 3] = v.w;
  }
#pragma unroll
  for (int j = 0; j < TB; ++j) {
    const float lj = s[j] * dv[j * S];
    s[j] = lj;
#pragma unroll
    for (int q = (j + 1) / 4; q < TB / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(t + j * S + 4 * q);
      if (4 * q > j) s[4 * q] = fmaf(-lj, v.x, s[4 * q]);
      if (4 * q + 1 > j) s[4 * q + 1] = fmaf(-lj, v.y, s[4 * q + 1]);
      if (4 * q + 2 > j) s[4 * q + 2] = fmaf(-lj, v.z, s[4 * q + 2]);
      if (4 * q + 3 > j) s[4 * q + 3] = fmaf(-lj, v.w, s[4 * q + 3]);
    }
  }
#pragma unroll
  for (int q = 0; q < TB / 4; ++q)
    *reinterpret_cast<float4*>(x + 4 * q) = make_float4(s[4 * q], s[4 * q + 1], s[4 * q + 2],
                                                         s[4 * q + 3]);
}

// One warp factors the diagonal tile t (stride TS) in place: lane i holds
// row i.  Leaves L below and on the diagonal, L^T above it, dinv_i in
// column TB of row i; dinv_out[i] for i < valid when dinv_out is set.
// Entries above the diagonal may hold anything on entry: they only feed
// entries above the diagonal.
__device__ __forceinline__ void factor_diag(float* t, int lane, float* dinv_out, int valid) {
  float r[TB];
#pragma unroll
  for (int q = 0; q < TB / 4; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(t + lane * TS + 4 * q);
    r[4 * q] = v.x; r[4 * q + 1] = v.y; r[4 * q + 2] = v.z; r[4 * q + 3] = v.w;
  }
  // the lane's own pivot, updated as r[lane] is (the shuffle from the lane
  // itself returns its own l): the next pivot waits on one FMA only, and is
  // issued before the step's other updates (a warp issues in order)
  float diag = t[lane * TS + lane];
  float mydinv = 0.0f;
  float dinv = rsqrtf(fmaxf(__shfl_sync(FULL, diag, 0), TINY));
#pragma unroll
  for (int j = 0; j < TB; ++j) {
    if (lane == j) mydinv = dinv;
    const float lj = r[j] * dinv;
    r[j] = lj;
    diag = fmaf(-lj, lj, diag);
    if (j + 1 < TB) dinv = rsqrtf(fmaxf(__shfl_sync(FULL, diag, j + 1), TINY));
#pragma unroll
    for (int k = j + 1; k < TB; ++k) r[k] = fmaf(-lj, __shfl_sync(FULL, lj, k), r[k]);
  }
#pragma unroll
  for (int q = 0; q < TB / 4; ++q)
    *reinterpret_cast<float4*>(t + lane * TS + 4 * q) =
        make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
  __syncwarp();
#pragma unroll
  for (int k = 0; k < TB; ++k)
    if (k < lane) t[k * TS + lane] = r[k];          // L^T above the diagonal
  t[lane * TS + TB] = mydinv;
  if (dinv_out != nullptr && lane < valid) dinv_out[lane] = mydinv;
  __syncwarp();
}

// c -= a b^T on 32 x 32 tiles (stride TS) by one warp, 4 x 8 a lane:
// rows ty + 8 i, columns tx + 4 j; the 32 products of an entry summed in
// ascending k, then subtracted.
__device__ __forceinline__ void update_tile(float* cc, const float* a, const float* bt,
                                            int lane) {
  const int ty = lane >> 2, tx = lane & 3;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
#pragma unroll
  for (int q = 0; q < TB / 4; ++q) {
    float4 av[4], bv[8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty + 8 * i) * TS + 4 * q);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      bv[j] = *reinterpret_cast<const float4*>(bt + (tx + 4 * j) * TS + 4 * q);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) cc[(ty + 8 * i) * TS + tx + 4 * j] -= acc[i][j];
}

// Route S, and the diagonal tile of a route-L step: factor the n x n
// sub-block at (j0, j0) of each block (row stride c) of src into l, with
// zeros above its diagonal.  src may be l.  One CTA per block.
__global__ void __launch_bounds__(SNT, 1)
chol_shared_kernel(const float* src, float* l, float* dinv_out, int c, int j0, int n, int vec) {
  extern __shared__ __align__(16) float sh[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = (n + TB - 1) / TB;
  const size_t off = (size_t)blockIdx.x * c * c + (size_t)j0 * c + j0;
  const float* g = src + off;
  float* o = l + off;
  const int ept = vec ? TB * TB / 4 : TB * TB;    // copies per tile
  auto tile = [&](int ti, int tj) { return sh + (tri(ti) + tj) * TILE; };

  auto copy_in = [&](int ti, int tj, int e) {
    float* t = tile(ti, tj);
    const int rows = n - ti * TB, cols = n - tj * TB;
    const float* gt = g + (size_t)ti * TB * c + tj * TB;
    if (vec) {
      const int r = e >> 3, q = (e & 7) * 4;
      const bool ok = r < rows && q < cols;
      cp_async16(t + r * TS + q, ok ? gt + (size_t)r * c + q : g, ok);
    } else {
      const int r = e >> 5, q = e & 31;
      const bool ok = r < rows && q < cols;
      cp_async4(t + r * TS + q, ok ? gt + (size_t)r * c + q : g, ok);
    }
  };
  // one copy unit of tile (ti, tj) of L: from shared memory, zeros above
  // the diagonal of a diagonal tile, all zeros where tj > ti
  auto put = [&](int ti, int tj, int e) {
    const int rows = n - ti * TB, cols = n - tj * TB;
    float* gt = o + (size_t)ti * TB * c + tj * TB;
    if (vec) {
      const int r = e >> 3, q = (e & 7) * 4;
      if (r >= rows || q >= cols) return;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (tj <= ti) {
        v = *reinterpret_cast<const float4*>(tile(ti, tj) + r * TS + q);
        if (ti == tj) {
          if (q > r) v.x = 0.0f;
          if (q + 1 > r) v.y = 0.0f;
          if (q + 2 > r) v.z = 0.0f;
          if (q + 3 > r) v.w = 0.0f;
        }
      }
      *reinterpret_cast<float4*>(gt + (size_t)r * c + q) = v;
    } else {
      const int r = e >> 5, q = e & 31;
      if (r >= rows || q >= cols) return;
      gt[(size_t)r * c + q] = (tj < ti || (tj == ti && q <= r)) ? tile(ti, tj)[r * TS + q]
                                                                : 0.0f;
    }
  };

  // group 0: tile column 0; group 1: the other tiles of the lower triangle
  for (int e = tid; e < nt * ept; e += SNT) copy_in(e / ept, 0, e % ept);
  cp_async_commit();
  for (int ti = 1; ti < nt; ++ti)
    for (int e = tid; e < ti * ept; e += SNT) copy_in(ti, 1 + e / ept, e % ept);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  for (int p = 0; p < nt; ++p) {
    if (warp == 0)
      factor_diag(tile(p, p), lane,
                  dinv_out != nullptr ? dinv_out + (size_t)blockIdx.x * c + j0 + p * TB : nullptr,
                  n - p * TB);
    __syncthreads();
    for (int ti = p + 1 + warp; ti < nt; ti += SNW)
      solve_row32<TS>(tile(ti, p) + lane * TS, tile(p, p), tile(p, p) + TB);
    if (p == 0) cp_async_wait<0>();
    __syncthreads();
    // column p of L is final, and tile row p right of the diagonal is zero
    for (int e = tid; e < (2 * (nt - p) - 1) * ept; e += SNT) {
      const int k = e / ept;
      if (k < nt - p) {
        put(p + k, p, e % ept);
      } else {
        put(p, p + 1 + k - (nt - p), e % ept);
      }
    }
    // the trailing update: tiles (ti, tj), p < tj <= ti, one per warp
    const int m = nt - 1 - p;
    for (int u = warp; u < tri(m); u += SNW) {
      int a = 0;
      while (tri(a + 1) <= u) ++a;
      const int ti = p + 1 + a, tj = p + 1 + (u - tri(a));
      update_tile(tile(ti, tj), tile(ti, p), tile(tj, p), lane);
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------------ route L
constexpr int NB = 128;             // step width
constexpr int PR = 64;              // rows of a panel CTA
constexpr int PT = 128;             // threads of a panel CTA (one per row of L11)
constexpr int PS = NB + 4;          // row stride of the panel CTA's arrays
constexpr size_t PANEL_SMEM = sizeof(float) * (size_t)(NB + PR) * PS;
static_assert(PT == NB, "a panel CTA reads dinv with one thread per row of L11");

// Rows r0 .. r0 + 63 of columns j0 .. j0 + 127: L21 = A21 L11^-T.  L11 and
// dinv come from l and the scratch, the rows from src (A at step 0).
__global__ void __launch_bounds__(PT, 2)
chol_panel_kernel(const float* src, float* l, const float* __restrict__ dinv, int c, int j0,
                  int vec) {
  extern __shared__ __align__(16) float sh[];
  float* ls = sh;                   // L11, NB x PS: dinv in column NB
  float* xs = sh + NB * PS;         // the panel rows, PR x PS
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int r0 = j0 + NB + blockIdx.x * PR;
  const int rows = min(PR, c - r0);
  const size_t boff = (size_t)b * c * c;
  const float* lg = l + boff + (size_t)j0 * c + j0;
  const float* xg = src + boff + (size_t)r0 * c + j0;
  if (vec) {
    for (int e = tid; e < NB * NB / 4; e += PT) {
      const int r = e >> 5, q = (e & 31) * 4;
      cp_async16(ls + r * PS + q, lg + (size_t)r * c + q, true);
    }
    for (int e = tid; e < PR * NB / 4; e += PT) {
      const int r = e >> 5, q = (e & 31) * 4;
      const bool ok = r < rows;
      cp_async16(xs + r * PS + q, ok ? xg + (size_t)r * c + q : xg, ok);
    }
  } else {
    for (int e = tid; e < NB * NB; e += PT) {
      const int r = e >> 7, q = e & (NB - 1);
      cp_async4(ls + r * PS + q, lg + (size_t)r * c + q, true);
    }
    for (int e = tid; e < PR * NB; e += PT) {
      const int r = e >> 7, q = e & (NB - 1);
      const bool ok = r < rows;
      cp_async4(xs + r * PS + q, ok ? xg + (size_t)r * c + q : xg, ok);
    }
  }
  cp_async_commit();
  ls[tid * PS + NB] = dinv[(size_t)b * c + j0 + tid];
  cp_async_wait<0>();
  __syncthreads();
  // L^T above the diagonal of L11's four 32 x 32 diagonal tiles
  for (int e = tid; e < 4 * TB * TB; e += PT) {
    const int q = e >> 10, i = (e >> 5) & 31, j = e & 31;
    if (j > i) ls[(TB * q + i) * PS + TB * q + j] = ls[(TB * q + j) * PS + TB * q + i];
  }
  __syncthreads();

  const int ty = tid >> 3, tx = tid & 7;   // the update: rows ty + 16 i, columns tx + 8 j
#pragma unroll 1
  for (int q = 0; q < NB / TB; ++q) {
    const float* lq = ls + TB * q * PS + TB * q;
    if (tid < rows) solve_row32<PS>(xs + tid * PS + TB * q, lq, lq + NB - TB * q);
    __syncthreads();
    // columns right of block q: X[:, qq] -= X[:, q] L11[qq, q]^T
#pragma unroll 1
    for (int qq = q + 1; qq < NB / TB; ++qq) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll
      for (int k = 0; k < TB / 4; ++k) {
        float4 av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          av[i] = *reinterpret_cast<const float4*>(xs + (ty + 16 * i) * PS + TB * q + 4 * k);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bv[j] = *reinterpret_cast<const float4*>(ls + (TB * qq + tx + 8 * j) * PS + TB * q +
                                                   4 * k);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
            acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
            acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
            acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) xs[(ty + 16 * i) * PS + TB * qq + tx + 8 * j] -= acc[i][j];
    }
    __syncthreads();
  }

  // L21, and the zeros above the diagonal in rows j0 .. j0 + 127
  float* og = l + boff + (size_t)r0 * c + j0;
  float* zg = l + boff + (size_t)j0 * c + r0;
  if (vec) {
    for (int e = tid; e < rows * NB / 4; e += PT) {
      const int r = e >> 5, q = (e & 31) * 4;
      *reinterpret_cast<float4*>(og + (size_t)r * c + q) =
          *reinterpret_cast<const float4*>(xs + r * PS + q);
    }
    for (int e = tid; e < NB * PR / 4; e += PT) {
      const int r = e >> 4, q = (e & 15) * 4;
      if (q < rows)
        *reinterpret_cast<float4*>(zg + (size_t)r * c + q) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  } else {
    for (int e = tid; e < rows * NB; e += PT) {
      const int r = e >> 7, q = e & (NB - 1);
      og[(size_t)r * c + q] = xs[r * PS + q];
    }
    for (int e = tid; e < NB * PR; e += PT) {
      const int r = e >> 6, q = e & (PR - 1);
      if (q < rows) zg[(size_t)r * c + q] = 0.0f;
    }
  }
}

// A trailing update: 128 x 128 tiles (ti, tj) of rows and columns s0 ..
// c - 1, C -= P_ti P_tj^T with P the kdepth columns of L from column k0;
// the lower tiles, or (strip) the tiles of the first tile column; C from
// csrc (A where no update has touched it yet, else l), written to l; on a
// diagonal tile only the entries on and below the diagonal.
constexpr int YB = 128;             // tile edge
constexpr int YT = 256;             // threads, 8 x 8 outputs each
constexpr int BK = 16;              // depth of a slice
constexpr int BKP = BK + 4;         // row stride of a slice
constexpr int YCS = YB + 8;         // row stride of the target tile
constexpr size_t SYRK_SMEM = sizeof(float) * ((size_t)2 * BKP * 2 * YB + (size_t)YB * YCS);
static_assert(YB == NB && NB % BK == 0, "the update's tiles are the steps' diagonal tiles");
static_assert(NB / BK > 2, "the target joins the products after the first two slices");

__global__ void __launch_bounds__(YT, 2)
chol_syrk_kernel(const float* csrc, float* l, int c, int k0, int kdepth, int s0, int tiles,
                 int strip, int vec) {
  constexpr int TYN = YB / 8, TXN = YB / 8, WX = TXN / 8;
  extern __shared__ __align__(16) float smem[];
  float* as = smem;                 // 2 x YB x BKP
  float* bs = as + 2 * YB * BKP;    // 2 x YB x BKP
  float* cs = bs + 2 * YB * BKP;    // YB x YCS

  const int blk = blockIdx.x / tiles;
  const int t = blockIdx.x - blk * tiles;
  int ti = t, tj = 0;
  if (!strip) {
    ti = (int)((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
    while (tri(ti) > t) --ti;
    while (tri(ti + 1) <= t) ++ti;
    tj = t - tri(ti);
  }
  const int row0 = s0 + ti * YB, col0 = s0 + tj * YB;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int ty = (warp / WX) * 4 + (lane >> 3);
  const int tx = (warp % WX) * 8 + (lane & 7);
  const size_t boff = (size_t)blk * c * c;
  const float* pg = l + boff + k0;            // the panel columns: row r at pg + r c
  const float* cg = csrc + boff;
  float* yg = l + boff;
  const int KT = kdepth / BK;

  auto load_rows = [&](float* dst, int base, int k0) {
    if (vec) {
#pragma unroll 1
      for (int idx = tid; idx < YB * (BK / 4); idx += YT) {
        const int r = idx >> 2, k = (idx & 3) * 4;
        const bool ok = base + r < c;
        cp_async16(dst + r * BKP + k, ok ? pg + (size_t)(base + r) * c + k0 + k : pg, ok);
      }
    } else {
#pragma unroll 1
      for (int idx = tid; idx < YB * BK; idx += YT) {
        const int r = idx / BK, k = idx % BK;
        const bool ok = base + r < c;
        cp_async4(dst + r * BKP + k, ok ? pg + (size_t)(base + r) * c + k0 + k : pg, ok);
      }
    }
  };
  auto load_ab = [&](int stage, int k0) {
    load_rows(as + stage * YB * BKP, row0, k0);
    load_rows(bs + stage * YB * BKP, col0, k0);
  };
  auto load_c = [&]() {
    if (vec) {
#pragma unroll 1
      for (int idx = tid; idx < YB * YB / 4; idx += YT) {
        const int r = idx / (YB / 4), cc = (idx % (YB / 4)) * 4;
        const bool ok = row0 + r < c && col0 + cc < c;
        cp_async16(cs + r * YCS + cc, ok ? cg + (size_t)(row0 + r) * c + col0 + cc : cg, ok);
      }
    } else {
#pragma unroll 1
      for (int idx = tid; idx < YB * YB; idx += YT) {
        const int r = idx / YB, cc = idx % YB;
        const bool ok = row0 + r < c && col0 + cc < c;
        cp_async4(cs + r * YCS + cc, ok ? cg + (size_t)(row0 + r) * c + col0 + cc : cg, ok);
      }
    }
  };

  // groups: slice 0; then slice 1 and the target tile, issued once slice 0
  // is in (so that the first products do not wait behind the tile); slice
  // kt + 1 while slice kt is used
  load_ab(0, 0);
  cp_async_commit();

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int kt = 0; kt < KT; ++kt) {
    if (kt == 1) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt + 1 < KT) load_ab((kt + 1) & 1, (kt + 1) * BK);
    cp_async_commit();
    if (kt == 0) {
      load_c();
      cp_async_commit();
    }
    if (kt == 2) {
      // the target is in: from here on acc holds P P^T - C, so that each
      // product lands on the shrinking residual (a sum of all kdepth
      // products from zero, subtracted at the end, loses more to rounding
      // where the update cancels most of C, as on ill-conditioned blocks)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] -= cs[(ty + i * TYN) * YCS + tx + j * TXN];
    }
    const float* ap = as + (kt & 1) * YB * BKP + ty * BKP;
    const float* bp = bs + (kt & 1) * YB * BKP + tx * BKP;
#pragma unroll
    for (int kg = 0; kg < BK; kg += 4) {
      float ar[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(ap + i * TYN * BKP + kg);
        ar[i][0] = v.x; ar[i][1] = v.y; ar[i][2] = v.z; ar[i][3] = v.w;
      }
#pragma unroll
      for (int jh = 0; jh < 2; ++jh) {
        float br[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(bp + (4 * jh + j) * TXN * BKP + kg);
          br[j][0] = v.x; br[j][1] = v.y; br[j][2] = v.z; br[j][3] = v.w;
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][4 * jh + j] = fmaf(ar[i][kk], br[j][kk], acc[i][4 * jh + j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) cs[(ty + i * TYN) * YCS + tx + j * TXN] = -acc[i][j];
  __syncthreads();
  const bool diag = ti == tj;
  if (vec) {
#pragma unroll 1
    for (int idx = tid; idx < YB * YB / 4; idx += YT) {
      const int r = idx / (YB / 4), cc = (idx % (YB / 4)) * 4;
      if (row0 + r >= c || col0 + cc >= c || (diag && cc > r)) continue;
      float* dst = yg + (size_t)(row0 + r) * c + col0 + cc;
      const float* v = cs + r * YCS + cc;
      if (!diag || cc + 3 <= r) {
        *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(v);
      } else {
        for (int e = 0; cc + e <= r; ++e) dst[e] = v[e];
      }
    }
  } else {
#pragma unroll 1
    for (int idx = tid; idx < YB * YB; idx += YT) {
      const int r = idx / YB, cc = idx % YB;
      if (row0 + r < c && col0 + cc < c && (!diag || cc <= r))
        yg[(size_t)(row0 + r) * c + col0 + cc] = cs[r * YCS + cc];
    }
  }
}

// ------------------------------------------------------------------- host
int prepare() {
  // the cap on dynamic shared memory, set once per device (bit = device)
  static unsigned long long raised = 0;
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (raised >> (dev & 63) & 1) return 0;
  err = (int)cudaFuncSetAttribute(chol_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)(sizeof(float) * tri(NT_S) * TILE));
  if (!err)
    err = (int)cudaFuncSetAttribute(chol_panel_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)PANEL_SMEM);
  if (!err)
    err = (int)cudaFuncSetAttribute(chol_syrk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)SYRK_SMEM);
  if (!err)
    err = (int)cudaFuncSetAttribute(chol_syrk_kernel,
                                    cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err) return err;
  raised |= 1ull << (dev & 63);
  return 0;
}

int vector_copies(const float* a, const float* l, int c) {
  const auto aligned = [](const float* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  return c % 4 == 0 && aligned(a) && aligned(l);
}

int launch_shared(const float* src, float* l, float* dinv, int B, int c, int j0, int n, int vec,
                  cudaStream_t s) {
  const int nt = (n + TB - 1) / TB;
  chol_shared_kernel<<<B, SNT, sizeof(float) * tri(nt) * TILE, s>>>(src, l, dinv, c, j0, n, vec);
  return (int)cudaGetLastError();
}

// One launch of the route-L step at column j0: part 0 the diagonal tile,
// 1 the panel below it, 2 the trailing update (see chol_syrk_kernel).
int launch_part(const float* a, float* l, float* dinv, int B, int c, int j0, int part, int vec,
                cudaStream_t s) {
  const float* src = j0 == 0 ? a : l;
  const int s0 = j0 + NB;
  if (part == 0) return launch_shared(src, l, dinv, B, c, j0, c - j0 < NB ? c - j0 : NB, vec, s);
  if (s0 >= c) return (int)cudaErrorInvalidValue;
  if (part == 1) {
    chol_panel_kernel<<<dim3((c - s0 + PR - 1) / PR, B), PT, PANEL_SMEM, s>>>(src, l, dinv, c,
                                                                              j0, vec);
    return (int)cudaGetLastError();
  }
  if (part == 2) {
    // an even step updates the next step's 128 columns only (depth 128); an
    // odd step the whole trailing triangle with both steps' panels (depth
    // 256), so that the bulk of the trailing entries is read and written
    // once per 256 columns
    const bool even = (j0 / NB) % 2 == 0;
    const long long rows = (c - s0 + YB - 1) / YB;
    const long long tiles = even ? rows : tri((int)rows);
    if (tiles * B > INT_MAX) return (int)cudaErrorInvalidValue;
    chol_syrk_kernel<<<(unsigned)(tiles * B), YT, SYRK_SMEM, s>>>(
        even ? src : (j0 == NB ? a : l), l, c, even ? j0 : j0 - NB, even ? NB : 2 * NB, s0,
        (int)tiles, even ? 1 : 0, vec);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

// The launches of one call, in order: route S one (kind 0); route L three a
// step of NB columns (kind 0 the diagonal tile, 1 the panel, 2 the trailing
// update), the last step its diagonal tile alone.  Launches number `index`
// and returns its kind in *kind, -1 past the end (and launches nothing).
int launch_at(const float* a, float* l, float* dinv, int B, int c, int index, int* kind,
              cudaStream_t s) {
  const int launches = c <= C_S ? 1 : 3 * ((c + NB - 1) / NB) - 2;
  *kind = index >= 0 && index < launches ? index % 3 : -1;
  if (*kind < 0) return (int)cudaSuccess;
  const int vec = vector_copies(a, l, c);
  if (c <= C_S) return launch_shared(a, l, nullptr, B, c, 0, c, vec, s);
  return launch_part(a, l, dinv, B, c, index / 3 * NB, *kind, vec, s);
}

int check_args(const float* dinv, int B, int c) {
  if (B > 65535 || (c > C_S && dinv == nullptr)) return (int)cudaErrorInvalidValue;
  return prepare();
}

}  // namespace

// a: (B, c, c) SPD f32 (lower triangle read), l: (B, c, c) f32 output
// (zeros above the diagonal), dinv: scratch of B * c floats (route L's
// pivots; may be null for c <= 288).  All contiguous (any 4-byte aligned
// base).  B <= 65535.
extern "C" int repro_block_cholesky(const float* a, float* l, float* dinv, int B, int c,
                                    void* stream) {
  if (B <= 0 || c <= 0) return (int)cudaSuccess;
  int err = check_args(dinv, B, c), kind = 0;
  for (int i = 0; !err && kind >= 0; ++i)
    err = launch_at(a, l, dinv, B, c, i, &kind, static_cast<cudaStream_t>(stream));
  return err;
}

// Launch number `index` of repro_block_cholesky's sequence alone (same
// arguments), and its kind in *kind: 0 route S or route L's diagonal tile,
// 1 a panel, 2 a trailing update; -1 past the end.  Called in order
// 0, 1, ... until -1, the launches give repro_block_cholesky's bits; for
// timing the parts.
extern "C" int repro_block_cholesky_part(const float* a, float* l, float* dinv, int B, int c,
                                         int index, int* kind, void* stream) {
  *kind = -1;
  if (B <= 0 || c <= 0) return (int)cudaSuccess;
  const int err = check_args(dinv, B, c);
  return err ? err : launch_at(a, l, dinv, B, c, index, kind, static_cast<cudaStream_t>(stream));
}
