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
// no TF32 and no tensor cores, as the reference's tolerance needs.
//
// Design: a SIMT SGEMM with the subtraction fused.  One CTA per output tile
// of BM x BN (128 x 128 with 256 threads when the grid fills the card, else
// 64 x 64 with 64 threads: the wrapper picks), an 8 x 8 register tile per thread: rows
// ty + (BM / 8) i, columns tx + (BN / 8) j.  A and B stay k-contiguous as in
// device memory: a two-stage cp.async ring of 16-deep slices, 16-byte copies
// (4-byte where p or a base is not 16-byte aligned), rows padded to 20
// floats, so that every shared-memory read is a float4 of four k values:
// broadcast for A, conflict-free for B (a quarter warp reads 8 consecutive
// rows).  The next slice loads while the current one is multiplied.  The C
// tile is copied into shared memory after the first slice, so at p = 32 its
// read overlaps the products; the epilogue subtracts the products there
// (rows padded to BN + 8: no bank conflicts) and writes Y row by row with
// float4 stores.  Each entry sums its p products in ascending k (fused
// multiply-adds) and is subtracted from C once, as the reference does.  No
// atomics, no split-K: two launches are bit-identical.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int BK = 16;          // depth of a slice
constexpr int BKP = BK + 4;     // row stride of a slice in shared memory

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

template <int BM, int BN>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)2 * BKP * (BM + BN) + (size_t)BM * (BN + 8));
}

template <int BM, int BN>
__global__ void __launch_bounds__(BM * BN / 64, BM == 128 ? 2 : 4)
schur_dense_kernel(const float* __restrict__ c, const float* __restrict__ a,
                   const float* __restrict__ bm, float* __restrict__ y, int m, int n, int p,
                   int tiles_n, int tiles, int vec_ab, int vec_c, int vec_y) {
  constexpr int NT = BM * BN / 64;
  constexpr int TYN = BM / 8, TXN = BN / 8;        // threads down the rows, across the columns
  constexpr int WX = TXN / 8;                      // warps across the columns
  constexpr int CS = BN + 8;                       // row stride of the C tile
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                                // 2 x BM x BKP
  float* Bs = As + 2 * BM * BKP;                   // 2 x BN x BKP
  float* Cs = Bs + 2 * BN * BKP;                   // BM x CS

  const long long blk = blockIdx.x / tiles;
  const int tile = blockIdx.x - (int)(blk * tiles);
  const int tm = tile / tiles_n, tn = tile - (tile / tiles_n) * tiles_n;
  const int row0 = tm * BM, col0 = tn * BN;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int ty = (warp / WX) * 4 + (lane >> 3);
  const int tx = (warp % WX) * 8 + (lane & 7);
  const float* ab = a + blk * m * (long long)p;
  const float* bb = bm + blk * n * (long long)p;
  const float* cb = c + blk * m * (long long)n;
  float* yb = y + blk * m * (long long)n;
  const int kt_count = (p + BK - 1) / BK;

  // rows base .. base + rows of a k-contiguous operand, k0 .. k0 + BK
  auto load_rows = [&](float* dst, const float* src, int rows, int base, int lim, int k0) {
    if (vec_ab) {
#pragma unroll 1
      for (int idx = tid; idx < rows * (BK / 4); idx += NT) {
        const int r = idx >> 2, k = (idx & 3) * 4;
        const bool ok = base + r < lim && k0 + k < p;
        cp_async16(dst + r * BKP + k, ok ? src + (size_t)(base + r) * p + k0 + k : src, ok);
      }
    } else {
#pragma unroll 1
      for (int idx = tid; idx < rows * BK; idx += NT) {
        const int r = idx / BK, k = idx % BK;
        const bool ok = base + r < lim && k0 + k < p;
        cp_async4(dst + r * BKP + k, ok ? src + (size_t)(base + r) * p + k0 + k : src, ok);
      }
    }
  };
  auto load_ab = [&](int stage, int k0) {
    load_rows(As + stage * BM * BKP, ab, BM, row0, m, k0);
    load_rows(Bs + stage * BN * BKP, bb, BN, col0, n, k0);
  };
  auto load_c = [&]() {
    if (vec_c) {
#pragma unroll 1
      for (int idx = tid; idx < BM * BN / 4; idx += NT) {
        const int r = idx / (BN / 4), cc = (idx % (BN / 4)) * 4;
        const bool ok = row0 + r < m && col0 + cc < n;
        cp_async16(Cs + r * CS + cc, ok ? cb + (size_t)(row0 + r) * n + col0 + cc : cb, ok);
      }
    } else {
#pragma unroll 1
      for (int idx = tid; idx < BM * BN; idx += NT) {
        const int r = idx / BN, cc = idx % BN;
        const bool ok = row0 + r < m && col0 + cc < n;
        cp_async4(Cs + r * CS + cc, ok ? cb + (size_t)(row0 + r) * n + col0 + cc : cb, ok);
      }
    }
  };

  // groups: slice 0, then the C tile; slice kt + 1 while slice kt is used
  if (kt_count > 0) load_ab(0, 0);
  cp_async_commit();
  load_c();
  cp_async_commit();

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int kt = 0; kt < kt_count; ++kt) {
    if (kt == 0) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt + 1 < kt_count) load_ab((kt + 1) & 1, (kt + 1) * BK);
    cp_async_commit();
    const float* as = As + (kt & 1) * BM * BKP + ty * BKP;
    const float* bs = Bs + (kt & 1) * BN * BKP + tx * BKP;
#pragma unroll
    for (int kg = 0; kg < BK; kg += 4) {
      float ar[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 t = *reinterpret_cast<const float4*>(as + i * TYN * BKP + kg);
        ar[i][0] = t.x; ar[i][1] = t.y; ar[i][2] = t.z; ar[i][3] = t.w;
      }
#pragma unroll
      for (int jh = 0; jh < 2; ++jh) {
        float br[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 t = *reinterpret_cast<const float4*>(bs + (4 * jh + j) * TXN * BKP + kg);
          br[j][0] = t.x; br[j][1] = t.y; br[j][2] = t.z; br[j][3] = t.w;
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

  // C - A B^T in place in the C tile, then the tile to Y row by row
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) Cs[(ty + i * TYN) * CS + tx + j * TXN] -= acc[i][j];
  __syncthreads();
  if (vec_y) {
#pragma unroll 1
    for (int idx = tid; idx < BM * BN / 4; idx += NT) {
      const int r = idx / (BN / 4), cc = (idx % (BN / 4)) * 4;
      if (row0 + r < m && col0 + cc < n)
        *reinterpret_cast<float4*>(yb + (size_t)(row0 + r) * n + col0 + cc) =
            *reinterpret_cast<const float4*>(Cs + r * CS + cc);
    }
  } else {
#pragma unroll 1
    for (int idx = tid; idx < BM * BN; idx += NT) {
      const int r = idx / BN, cc = idx % BN;
      if (row0 + r < m && col0 + cc < n) yb[(size_t)(row0 + r) * n + col0 + cc] = Cs[r * CS + cc];
    }
  }
}

template <int BM, int BN>
int launch(const float* c, const float* a, const float* b, float* y, int B, int m, int n, int p,
           cudaStream_t s) {
  const long long tiles_n = (n + BN - 1) / BN;
  const long long tiles = (long long)((m + BM - 1) / BM) * tiles_n;
  if (tiles * B > INT_MAX) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = smem_bytes<BM, BN>();
  if constexpr (smem > 48 * 1024) {
    // the cap on dynamic shared memory and the carveout, set once per
    // device (bit = device)
    static unsigned long long raised = 0;
    int dev = 0;
    int err = (int)cudaGetDevice(&dev);
    if (err) return err;
    if (!(raised >> (dev & 63) & 1)) {
      err = (int)cudaFuncSetAttribute(schur_dense_kernel<BM, BN>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err) return err;
      err = (int)cudaFuncSetAttribute(schur_dense_kernel<BM, BN>,
                                      cudaFuncAttributePreferredSharedMemoryCarveout, 100);
      if (err) return err;
      raised |= 1ull << (dev & 63);
    }
  }
  const auto aligned = [](const float* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  const int vec_ab = aligned(a) && aligned(b) && p % 4 == 0;
  const int vec_c = aligned(c) && n % 4 == 0;
  const int vec_y = aligned(y) && n % 4 == 0;
  schur_dense_kernel<BM, BN><<<(unsigned)(tiles * B), BM * BN / 64, smem, s>>>(
      c, a, b, y, m, n, p, (int)tiles_n, (int)tiles, vec_ab, vec_c, vec_y);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of a CTA at tile edge 128 or 64, bytes.
extern "C" long long repro_schur_smem_bytes(int tile) {
  if (tile == 128) return (long long)smem_bytes<128, 128>();
  if (tile == 64) return (long long)smem_bytes<64, 64>();
  return -1;
}

// c, y: (B, m, n), a: (B, m, p), b: (B, n, p); f32 contiguous (any 4-byte
// aligned base).  tile: the CTA tile edge, 128 or 64 (the wrapper's
// choice).  Requires B x (tile x tile tiles) <= INT_MAX
// (cudaErrorInvalidValue otherwise, as for another tile).
extern "C" int repro_schur_dense(const float* c, const float* a, const float* b, float* y,
                                 int B, int m, int n, int p, int tile, void* stream) {
  if (B <= 0 || m <= 0 || n <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile == 128) return launch<128, 128>(c, a, b, y, B, m, n, p, s);
  if (tile == 64) return launch<64, 64>(c, a, b, y, B, m, n, p, s);
  return (int)cudaErrorInvalidValue;
}
