// Batched algebraic recompression of low-rank factor pairs (U, V).
//
// Replaces the TPU kernel src/repro/kernels/batched_recompress/kernel.py:
// batched_recompress_t (body _recompress_kernel), one program per block
// with both panels in VMEM:
//
//   Gu = U^T U + (1e-7 tr/k) I = Lu Lu^T,  Gv likewise     Gram + Cholesky
//   Ru = Lu^T, Rv = Lv^T,  M = Ru Rv^T                      (k, k) core
//   M = W S Z^T                          one-sided Jacobi, at most 8 sweeps
//   U' = U Ru^-1 (M . keep),  V' = V Rv^-1 (Z . keep)       keep: s > tol max s
//
// Bound on the H100: bytes for the factor store (tall panels, k = 16: the
// panels are read twice and written once against ~4k flops per row), the
// k x k work for H-LU's wide tiles (m = 256, k = 64: 8 sweeps of the Jacobi
// are ~18M flops per block against 256 KiB of panels).
//
// Design.  One CTA per block with whole panels in shared memory fails on
// both shapes: a store panel of 131,072 x 16 is 8 MiB, and level 3 of the
// paper's problem has only 4 blocks.  So three launches:
//   1. gram   grid (B, row chunks, 2 panels): each CTA forms the partial
//             Gram of CHUNK rows (rows staged in shared memory, one thread
//             per output entry); partials go to scratch;
//   2. core   grid (B): one CTA per block sums the partials in chunk order,
//             adds the jitter, factors both Grams and inverts both
//             triangles in place, forms M, runs the Jacobi sweeps (disjoint
//             column pairs of one round-robin round in parallel, one warp
//             per pair, each dot product a fixed shuffle tree), and writes
//             the two k x k transforms with the truncation and the
//             descending-sigma order folded in, sigma, the rank and the
//             sweep count;
//   3. apply  grid (B, row tiles, 2 panels): U' = U T_u and V' = V T_v.
// The Jacobi stops after the first sweep without a rotation: every later
// sweep of the reference would leave M and Z as they are.  No atomics, so
// results are bit-reproducible; all-zero blocks come out zero with rank 0,
// as the reference's clamps make them.
//
// One departure from the reference, for rank-deficient panels.  H-LU's
// concatenations [u | -a] are rank-deficient (a lies in the span of the
// source tiles), and at k = 64 the jitter 1e-7 tr/k is below the fp32
// rounding of the Gram's Cholesky, so a dependent pivot can come out at or
// below zero.  The reference then scales its column by rsqrt(1e-30) = 1e15,
// and the products overflow: run on the CPU in the same arithmetic, every
// re-truncation of a 2,000-point H-LU returned NaN.  Here a pivot at or
// below the jitter (in exact arithmetic every pivot is at least the
// jitter) marks a dependent direction: its column of L and its row and
// column of the triangular inverse are zero.  Pivots above the jitter, all
// of them in a well-conditioned panel, are treated as in the reference.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;          // threads per CTA
constexpr int NWARP = NT / 32;
constexpr int MAXK = 64;
constexpr int OPT = MAXK * MAXK / NT;  // Gram outputs per thread at k = 64
constexpr int CHUNK = 1024;      // rows per Gram-partial CTA
constexpr int TR = 32;           // rows staged per Gram tile
constexpr int TM = 64;           // rows per transform CTA
constexpr float TINY = 1e-30f;   // pivot / diagonal clamp of the reference
constexpr double JITTER = 1e-7;  // relative Gram jitter of the reference
constexpr int SWEEPS = 8;        // Jacobi sweeps of the reference

__global__ void __launch_bounds__(NT)
gram_partial_kernel(const float* __restrict__ u, const float* __restrict__ v,
                    float* __restrict__ part, int B, int m, int n, int k, int splits) {
  extern __shared__ float s_x[];  // TR * k
  const int b = blockIdx.x, s = blockIdx.y, which = blockIdx.z;
  const int rows = which ? n : m;
  const float* xb = (which ? v : u) + (size_t)b * rows * k;
  const int kk2 = k * k;
  const int tid = threadIdx.x;
  const long long row_begin = (long long)s * CHUNK;
  const long long row_end = row_begin + CHUNK < rows ? row_begin + CHUNK : rows;

  float acc[OPT];
#pragma unroll
  for (int t = 0; t < OPT; ++t) acc[t] = 0.0f;

  for (long long r0 = row_begin; r0 < row_end; r0 += TR) {
    const int nr = (int)(row_end - r0 < TR ? row_end - r0 : TR);
    for (int t = tid; t < TR * k; t += NT) {
      s_x[t] = (t < nr * k) ? xb[r0 * k + t] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < OPT; ++t) {
      const int o = tid + NT * t;
      if (o < kk2) {
        const int i = o / k, j = o - (o / k) * k;
        float a = acc[t];
        for (int r = 0; r < nr; ++r) a = fmaf(s_x[r * k + i], s_x[r * k + j], a);
        acc[t] = a;
      }
    }
    __syncthreads();
  }
  float* out = part + (((size_t)which * B + b) * splits + s) * kk2;
#pragma unroll
  for (int t = 0; t < OPT; ++t) {
    const int o = tid + NT * t;
    if (o < kk2) out[o] = acc[t];
  }
}

// Right-looking Cholesky of the (k, k) matrix g + jit I (g holds the sum,
// leading dimension ld) in place, with the reference's rank-1 updates; on
// return g holds L in its lower triangle and zeros above.  A pivot at or
// below max(jit, TINY) is a dependent direction: its column of L is zero.
// lc, lr: 2k floats.
__device__ void cholesky_inplace(float* g, int k, int ld, float jit, float* lc, float* lr) {
  const int tid = threadIdx.x;
  const float pivot_floor = fmaxf(jit, TINY);
  for (int j = 0; j < k; ++j) {
    const float d2 = g[j * ld + j];
    const float dinv = d2 > pivot_floor ? 1.0f / sqrtf(d2) : 0.0f;
    if (tid < k) {
      lc[tid] = (tid >= j) ? g[tid * ld + j] * dinv : 0.0f;
      lr[tid] = (tid >= j) ? g[j * ld + tid] * dinv : 0.0f;
    }
    __syncthreads();
    for (int o = tid; o < k * k; o += NT) {
      const int i = o / k, l = o - (o / k) * k;
      if (i > j && l > j) g[i * ld + l] -= lc[i] * lr[l];
    }
    if (tid < k && tid >= j) g[tid * ld + j] = lc[tid];
    __syncthreads();
  }
  for (int o = tid; o < k * k; o += NT) {
    const int i = o / k, l = o - (o / k) * k;
    if (l > i) g[i * ld + l] = 0.0f;
  }
  __syncthreads();
}

// X = R^-1 for R = L^T (upper triangular), by the reference's k-step back
// substitution on an identity panel, in place in y (leading dimension ld).
// A dropped pivot (zero diagonal) gives a zero row and column of X: the
// matching row of M is zero, so nothing of it reaches U'.  xi: k floats.
__device__ void inv_upper_inplace(const float* lmat, float* y, int k, int ld, float* xi) {
  const int tid = threadIdx.x;
  for (int o = tid; o < k * k; o += NT) {
    const int i = o / k, c = o - (o / k) * k;
    y[i * ld + c] = (i == c) ? 1.0f : 0.0f;
  }
  __syncthreads();
  for (int i = k - 1; i >= 0; --i) {
    const float dd = lmat[i * ld + i];
    const float d = fabsf(dd) > TINY ? dd : TINY;
    if (tid < k) xi[tid] = dd != 0.0f ? y[i * ld + tid] / d : 0.0f;
    __syncthreads();
    for (int o = tid; o < k * k; o += NT) {
      const int r = o / k, c = o - (o / k) * k;
      if (r < i) y[r * ld + c] -= lmat[i * ld + r] * xi[c];   // R[r][i] = L[i][r]
    }
    if (tid < k) y[i * ld + tid] = xi[tid];
    __syncthreads();
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__global__ void __launch_bounds__(NT)
core_kernel(const float* __restrict__ part, float* __restrict__ tmat, float* __restrict__ s_out,
            int* __restrict__ ranks, int* __restrict__ sweeps_out, int B, int k, int splits,
            float tol) {
  extern __shared__ float sm[];
  const int ld = k + 1;
  float* A = sm;                  // Gram u -> L_u -> (identity ->) X_v
  float* Bm = A + k * ld;         // Gram v -> L_v -> Z
  float* C = Bm + k * ld;         // M
  float* D = C + k * ld;          // X_u
  float* vec = D + k * ld;        // 3 * MAXK scratch
  float* vec2 = vec + MAXK;
  __shared__ int rotated;
  __shared__ float s_max;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kk2 = k * k;

  // partial Grams summed in chunk order
  for (int o = tid; o < kk2; o += NT) {
    const int i = o / k, j = o - (o / k) * k;
    const float* pu = part + (size_t)b * splits * kk2 + o;
    const float* pv = part + ((size_t)B + b) * splits * kk2 + o;
    float gu = pu[0], gv = pv[0];
    for (int s = 1; s < splits; ++s) {
      gu += pu[(size_t)s * kk2];
      gv += pv[(size_t)s * kk2];
    }
    A[i * ld + j] = gu;
    Bm[i * ld + j] = gv;
  }
  __syncthreads();
  if (tid == 0) {
    float tu = 0.0f, tv = 0.0f;
    for (int i = 0; i < k; ++i) {
      tu += A[i * ld + i];
      tv += Bm[i * ld + i];
    }
    vec[0] = (float)(JITTER / k) * tu;
    vec[1] = (float)(JITTER / k) * tv;
  }
  __syncthreads();
  const float ju = vec[0], jv = vec[1];
  __syncthreads();
  if (tid < k) {
    A[tid * ld + tid] += ju;
    Bm[tid * ld + tid] += jv;
  }
  __syncthreads();

  cholesky_inplace(A, k, ld, ju, vec, vec2);
  cholesky_inplace(Bm, k, ld, jv, vec, vec2);
  // M = Ru Rv^T = Lu^T Lv:  M[i][j] = sum_l Lu[l][i] Lv[l][j]
  for (int o = tid; o < kk2; o += NT) {
    const int i = o / k, j = o - (o / k) * k;
    float a = 0.0f;
    for (int l = 0; l < k; ++l) a = fmaf(A[l * ld + i], Bm[l * ld + j], a);
    C[i * ld + j] = a;
  }
  __syncthreads();
  inv_upper_inplace(A, D, k, ld, vec);      // X_u in D
  inv_upper_inplace(Bm, A, k, ld, vec);     // X_v in A
  for (int o = tid; o < kk2; o += NT) {     // Z = I in Bm
    const int i = o / k, c = o - (o / k) * k;
    Bm[i * ld + c] = (i == c) ? 1.0f : 0.0f;
  }
  __syncthreads();

  // one-sided Jacobi on the columns of M, round-robin over disjoint pairs
  const int npos = k + (k & 1);             // odd k: index k is a bye
  const int half = npos / 2;
  int sweeps = 0;
  for (int sw = 0; sw < SWEEPS; ++sw) {
    if (tid == 0) rotated = 0;
    __syncthreads();
    for (int round = 0; round < npos - 1; ++round) {
      for (int pi = warp; pi < half; pi += NWARP) {
        const int ppos = pi, qpos = npos - 1 - pi;
        int p = (ppos == 0) ? 0 : 1 + (ppos - 1 + round) % (npos - 1);
        int q = 1 + (qpos - 1 + round) % (npos - 1);
        if (p > q) { const int t = p; p = q; q = t; }
        if (q >= k) continue;
        float app = 0.0f, aqq = 0.0f, apq = 0.0f;
        for (int r = lane; r < k; r += 32) {
          const float x = C[r * ld + p], y = C[r * ld + q];
          app = fmaf(x, x, app);
          aqq = fmaf(y, y, aqq);
          apq = fmaf(x, y, apq);
        }
        app = warp_sum(app);
        aqq = warp_sum(aqq);
        apq = warp_sum(apq);
        if (!(fabsf(apq) > TINY)) continue;   // the pair is not coupled
        const float tau = (aqq - app) / (2.0f * apq);
        const float sg = (tau > 0.0f) ? 1.0f : ((tau < 0.0f) ? -1.0f : 0.0f);
        const float t = sg / (fabsf(tau) + sqrtf(1.0f + tau * tau));
        const float c = 1.0f / sqrtf(1.0f + t * t);
        const float s = c * t;
        for (int r = lane; r < k; r += 32) {
          const float mp = C[r * ld + p], mq = C[r * ld + q];
          C[r * ld + p] = c * mp - s * mq;
          C[r * ld + q] = s * mp + c * mq;
          const float zp = Bm[r * ld + p], zq = Bm[r * ld + q];
          Bm[r * ld + p] = c * zp - s * zq;
          Bm[r * ld + q] = s * zp + c * zq;
        }
        if (lane == 0) rotated = 1;
      }
      __syncthreads();
    }
    ++sweeps;
    const int any = rotated;
    __syncthreads();
    if (!any) break;
  }

  // sigma = column norms of M; keep s > tol * max s; descending order
  float* sig = vec;        // k
  float* key = vec2;       // k
  if (tid < k) {
    float a = 0.0f;
    for (int r = 0; r < k; ++r) a = fmaf(C[r * ld + tid], C[r * ld + tid], a);
    sig[tid] = sqrtf(a);
  }
  __syncthreads();
  if (tid == 0) {
    float mx = sig[0];
    for (int i = 1; i < k; ++i) mx = fmaxf(mx, sig[i]);
    s_max = mx;
  }
  __syncthreads();
  if (tid < k) key[tid] = (sig[tid] > tol * s_max) ? sig[tid] : 0.0f;
  __syncthreads();
  int* pos = reinterpret_cast<int*>(vec2 + MAXK);   // k
  if (tid < k) {
    const float ki = key[tid];
    int p = 0;
    for (int j = 0; j < k; ++j) p += (key[j] > ki) || (key[j] == ki && j < tid);
    pos[tid] = p;
  }
  __syncthreads();
  if (tid == 0) {
    int r = 0;
    for (int i = 0; i < k; ++i) r += key[i] > 0.0f;
    ranks[b] = r;
    sweeps_out[b] = sweeps;
  }
  if (tid < k) s_out[(size_t)b * k + pos[tid]] = key[tid];
  // T_u = X_u (M . keep), T_v = X_v (Z . keep), columns placed at pos
  float* tu = tmat + (size_t)b * kk2;
  float* tv = tmat + ((size_t)B + b) * kk2;
  for (int o = tid; o < kk2; o += NT) {
    const int r = o / k, i = o - (o / k) * k;
    const float kp = key[i] > 0.0f ? 1.0f : 0.0f;
    float au = 0.0f, av = 0.0f;
    for (int l = 0; l < k; ++l) {
      au = fmaf(D[r * ld + l], C[l * ld + i] * kp, au);
      av = fmaf(A[r * ld + l], Bm[l * ld + i] * kp, av);
    }
    tu[r * k + pos[i]] = au;
    tv[r * k + pos[i]] = av;
  }
}

__global__ void __launch_bounds__(NT)
transform_kernel(const float* __restrict__ u, const float* __restrict__ v,
                 const float* __restrict__ tmat, float* __restrict__ u2, float* __restrict__ v2,
                 int B, int m, int n, int k) {
  extern __shared__ float sm[];
  float* s_t = sm;            // k * k
  float* s_x = sm + k * k;    // TM * k
  const int b = blockIdx.x, which = blockIdx.z;
  const int rows = which ? n : m;
  const long long row0 = (long long)blockIdx.y * TM;
  if (row0 >= rows) return;   // the same for every thread of the CTA
  const int nr = (int)(rows - row0 < TM ? rows - row0 : TM);
  const int tid = threadIdx.x;
  const float* xb = (which ? v : u) + ((size_t)b * rows + row0) * k;
  float* yb = (which ? v2 : u2) + ((size_t)b * rows + row0) * k;
  const float* tb = tmat + ((size_t)which * B + b) * k * k;
  for (int t = tid; t < k * k; t += NT) s_t[t] = tb[t];
  for (int t = tid; t < nr * k; t += NT) s_x[t] = xb[t];
  __syncthreads();
  for (int o = tid; o < nr * k; o += NT) {
    const int r = o / k, c = o - (o / k) * k;
    float a = 0.0f;
    for (int l = 0; l < k; ++l) a = fmaf(s_x[r * k + l], s_t[l * k + c], a);
    yb[o] = a;
  }
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)bytes);
  }
  return (int)cudaSuccess;
}

}  // namespace

// Number of Gram chunks for panels of m and n rows: the wrapper sizes the
// scratch with it.
extern "C" int repro_recompress_splits(int m, int n) {
  const int rows = m > n ? m : n;
  const int s = (rows + CHUNK - 1) / CHUNK;
  return s > 0 ? s : 1;
}

// u: (B, m, k), v: (B, n, k) f32 contiguous -> u2: (B, m, k), v2: (B, n, k)
// with columns in descending-sigma order and truncated columns zero;
// s: (B, k) truncated sigma in the same order, ranks, sweeps: (B,) int32.
// Scratch: part (2, B, splits, k, k) and tmat (2, B, k, k) floats.
// Requires 1 <= k <= 64 and at most 65535 row chunks and row tiles
// (cudaErrorInvalidValue otherwise).
extern "C" int repro_batched_recompress(const float* u, const float* v, float* u2, float* v2,
                                        float* s, int* ranks, int* sweeps, float* part,
                                        float* tmat, int B, int m, int n, int k, float tol,
                                        void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const int rows = m > n ? m : n;
  const int tiles = (rows + TM - 1) / TM;
  const int splits = repro_recompress_splits(m, n);
  if (k <= 0 || k > MAXK || m <= 0 || n <= 0 || tiles > 65535 || splits > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem1 = sizeof(float) * TR * k;
  gram_partial_kernel<<<dim3(B, splits, 2), NT, smem1, st>>>(u, v, part, B, m, n, k, splits);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const size_t smem2 = sizeof(float) * (4 * (size_t)k * (k + 1) + 3 * MAXK);
  err = set_smem((const void*)core_kernel, smem2);
  if (err) return err;
  core_kernel<<<B, NT, smem2, st>>>(part, tmat, s, ranks, sweeps, B, k, splits, tol);
  err = (int)cudaGetLastError();
  if (err) return err;
  const size_t smem3 = sizeof(float) * ((size_t)k * k + TM * k);
  transform_kernel<<<dim3(B, tiles, 2), NT, smem3, st>>>(u, v, tmat, u2, v2, B, m, n, k);
  return (int)cudaGetLastError();
}
