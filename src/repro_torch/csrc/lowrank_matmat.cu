// Batched low-rank product Y[b] = U[b] (V[b]^T X[b]).
//
// Replaces the TPU kernel src/repro/kernels/batched_aca/kernel.py:
// batched_lowrank_matmat_t (body _lowrank_mm_kernel), one program per
// block with both thin products on the MXU.
//
// Bound on the H100: bytes.  Per block the kernel reads U (m x k), V
// (n x k) and X (n x R) once and writes Y (m x R), doing only 2k(m+n)R
// flops: at k = 16, R = 8 that is 2 flops per byte, far below the card's
// balance point.  The factors of the paper's problem are 8.33 GiB.
//
// Design: the coarse level groups have few, very tall blocks (4 blocks of
// 131072 rows), so one CTA per block would leave most of the 132 SMs idle.
//   phase 1  grid (splits, B): each CTA reduces V^T X over a chunk of CHUNK
//            rows.  Row tiles of V and X are staged in shared memory with
//            coalesced loads; the k*R outputs are spread over thread
//            groups, each group taking every G-th row, and the groups'
//            sums are added in a fixed order.  Partials go to scratch.
//   reduce   grid (B): T[b] = sum of the partials in split order.
//   phase 2  grid (row tiles, B): Y = U T over a tile of TM rows, with T
//            and the U tile in shared memory and one thread per output.
// No atomics anywhere, so results are bit-reproducible.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;     // threads per CTA
constexpr int CHUNK = 512;  // rows of V/X per phase-1 CTA
constexpr int TR = 32;      // rows per staged tile in phase 1
constexpr int TM = 64;      // rows of U per phase-2 CTA
constexpr int OPT = 4;      // outputs per thread when k*R > NT (k*R <= NT*OPT)

__global__ void __launch_bounds__(NT)
vtx_partial_kernel(const float* __restrict__ v, const float* __restrict__ x,
                   float* __restrict__ part, int n, int k, int R, int splits) {
  extern __shared__ float smem[];
  const int KR = k * R;
  float* s_v = smem;             // TR * k
  float* s_x = s_v + TR * k;     // TR * R
  float* s_red = s_x + TR * R;   // max(NT, KR)

  const int b = blockIdx.y;
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const bool grouped = KR < NT;
  const int G = grouped ? NT / KR : 1;
  const int g = grouped ? tid / KR : 0;
  const bool active = g < G;

  const float* vb = v + (size_t)b * n * k;
  const float* xb = x + (size_t)b * n * R;
  const int row_begin = s * CHUNK;
  const int row_end = min(n, row_begin + CHUNK);

  float acc[OPT];
#pragma unroll
  for (int t = 0; t < OPT; ++t) acc[t] = 0.0f;

  for (int r0 = row_begin; r0 < row_end; r0 += TR) {
    const int nrows = min(TR, row_end - r0);
    for (int t = tid; t < TR * k; t += NT) {
      s_v[t] = (t < nrows * k) ? vb[(size_t)r0 * k + t] : 0.0f;
    }
    for (int t = tid; t < TR * R; t += NT) {
      s_x[t] = (t < nrows * R) ? xb[(size_t)r0 * R + t] : 0.0f;
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int t = 0; t < OPT; ++t) {
        const int o = grouped ? (t == 0 ? tid - g * KR : KR) : tid + NT * t;
        if (o < KR) {
          const int kk = o / R;
          const int rr = o - kk * R;
          float a = acc[t];
          for (int jj = g; jj < nrows; jj += G) a = fmaf(s_v[jj * k + kk], s_x[jj * R + rr], a);
          acc[t] = a;
        }
      }
    }
    __syncthreads();
  }

  // fixed-order combination of the groups' sums
  if (grouped) {
    if (active) s_red[tid] = acc[0];
    __syncthreads();
    if (tid < KR) {
      float total = s_red[tid];
      for (int gg = 1; gg < G; ++gg) total += s_red[gg * KR + tid];
      part[((size_t)b * splits + s) * KR + tid] = total;
    }
  } else {
#pragma unroll
    for (int t = 0; t < OPT; ++t) {
      const int o = tid + NT * t;
      if (o < KR) part[((size_t)b * splits + s) * KR + o] = acc[t];
    }
  }
}

__global__ void __launch_bounds__(NT)
reduce_partials_kernel(const float* __restrict__ part, float* __restrict__ tmat,
                       int KR, int splits) {
  const int b = blockIdx.x;
  for (int o = threadIdx.x; o < KR; o += NT) {
    const float* p = part + (size_t)b * splits * KR + o;
    float total = p[0];
    for (int s = 1; s < splits; ++s) total += p[(size_t)s * KR];
    tmat[(size_t)b * KR + o] = total;
  }
}

__global__ void __launch_bounds__(NT)
u_times_t_kernel(const float* __restrict__ u, const float* __restrict__ tmat,
                 float* __restrict__ y, int m, int k, int R) {
  extern __shared__ float smem[];
  const int KR = k * R;
  float* s_t = smem;          // k * R
  float* s_u = s_t + KR;      // TM * k

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * TM;
  const int nrows = min(TM, m - row0);
  const int tid = threadIdx.x;

  for (int o = tid; o < KR; o += NT) s_t[o] = tmat[(size_t)b * KR + o];
  const float* ub = u + ((size_t)b * m + row0) * k;
  for (int t = tid; t < TM * k; t += NT) s_u[t] = (t < nrows * k) ? ub[t] : 0.0f;
  __syncthreads();

  float* yb = y + ((size_t)b * m + row0) * R;
  for (int o = tid; o < nrows * R; o += NT) {
    const int row = o / R;
    const int rr = o - row * R;
    float a = 0.0f;
    for (int kk = 0; kk < k; ++kk) a = fmaf(s_u[row * k + kk], s_t[kk * R + rr], a);
    yb[o] = a;
  }
}

}  // namespace

// Number of phase-1 splits for n rows: the wrapper sizes the scratch with it.
extern "C" int repro_lowrank_splits(int n) { return (n + CHUNK - 1) / CHUNK; }

// u: (B, m, k), v: (B, n, k), x: (B, n, R), y: (B, m, R) f32 contiguous;
// part: scratch of B * splits * k * R floats, tmat: scratch of B * k * R.
// Requires k <= 64, k * R <= 1024 and B <= 65535 (cudaErrorInvalidValue
// otherwise).
extern "C" int repro_lowrank_matmat(const float* u, const float* v, const float* x, float* y,
                                    float* part, float* tmat, int B, int m, int n, int k,
                                    int R, void* stream) {
  if (B <= 0 || m <= 0 || R <= 0) return (int)cudaSuccess;
  if (k <= 0 || k > 64 || k * R > NT * OPT || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int KR = k * R;
  const int splits = repro_lowrank_splits(n);
  if (n > 0) {
    const size_t smem1 = sizeof(float) * (TR * k + TR * R + (KR > NT ? KR : NT));
    if (smem1 > 48 * 1024) {
      cudaFuncSetAttribute(vtx_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem1);
    }
    vtx_partial_kernel<<<dim3(splits, B), NT, smem1, s>>>(v, x, part, n, k, R, splits);
    reduce_partials_kernel<<<B, NT, 0, s>>>(part, tmat, KR, splits);
  } else {
    cudaMemsetAsync(tmat, 0, sizeof(float) * (size_t)B * KR, s);
  }
  const size_t smem2 = sizeof(float) * (KR + TM * k);
  u_times_t_kernel<<<dim3((m + TM - 1) / TM, B), NT, smem2, s>>>(u, tmat, y, m, k, R);
  return (int)cudaGetLastError();
}
