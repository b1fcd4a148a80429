// Batched fixed-rank adaptive cross approximation (paper Algorithm 2).
//
// Replaces the TPU kernel src/repro/kernels/batched_aca/kernel.py:
// batched_aca_t (body _kernel), one program per block that runs the k
// pivoted rank-1 steps with the block's U, V and masks in VMEM.  For every
// block b and step r = 0 .. k-1:
//   u_hat = phi(rows, col j_r) - U V[j_r]          (residual column)
//   i_r   = argmax |u_hat| over rows not yet used   (first index on ties)
//   U[:, r] = u_hat / u_hat[i_r]                    (zero if |u_hat[i_r]| <= 1e-30)
//   V[:, r] = phi(row i_r, cols) - V U[i_r]         (zero likewise)
//   j_r+1 = argmax |V[:, r]| over columns not yet used
// with phi the direct-difference kernel of phi.cuh.
//
// Bound on the H100: bytes.  The compulsory traffic is U, V written once,
// 4 k (m + n) bytes per block (8.9 GB for the paper's problem), and the
// points, read once for all blocks; the operations are about
// (m + n)(3d + 2 + 2r) per step.
//
// Design: one host loop over the k steps, two launches per step, each over
// a grid of (row or column chunks of NT, blocks).  The level groups of one
// H-matrix differ 64x in shape (4 blocks of 131072 rows to 6700 blocks of
// 2048 on the paper's problem): one CTA per block looping over the steps
// would leave 128 of 132 SMs idle on the coarsest group, and a 131072-row
// residual column does not fit in shared memory.  Splitting every block
// over CTAs fills the card for every group with one code path, at the
// price of 2k launches per group and of U and V rows re-read from device
// memory (L2) at every step.
//   column pass  u_hat for one chunk of rows, kept in a (B, m) scratch,
//                and the chunk's best pivot candidate;
//   row pass     reads the pivot, writes U[:, r] = u_hat * (1 / alpha) for
//                one chunk of rows and V[:, r] for one chunk of columns,
//                and the chunk's best next-column candidate.
// The argmax is a 64-bit atomicMax on (order-preserving bits of the masked
// |value|, inverted index): the maximum of a total order, so the pivot is
// the first index on ties and the same whatever order the CTAs run in.
// Used pivots are masked by comparison with the pivots read back from the
// key arrays (at most k of them).  Every sum runs in a fixed order: results
// are bit-reproducible.  Blocks are addressed by cluster id into a point
// array, so a level group is factored without gathering its points.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "phi.cuh"

namespace {

constexpr int NT = 256;     // threads per CTA, one row or column each
constexpr int MAX_K = 64;

__device__ __forceinline__ unsigned long long pivot_key(float val, int idx) {
  const unsigned u = __float_as_uint(val);
  const unsigned ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)ord << 32) | (unsigned long long)(0xFFFFFFFFu - (unsigned)idx);
}

__device__ __forceinline__ int key_index(unsigned long long key) {
  return (int)(0xFFFFFFFFu - (unsigned)(key & 0xFFFFFFFFull));
}

// A cluster id outside [0, clusters) reads cluster 0 in its place (the row
// pass then writes NaN factors for that block): no read outside the points.
__device__ __forceinline__ long long cluster_or_0(long long id, int clusters) {
  return (id >= 0 && id < clusters) ? id : 0;
}

// CTA-wide maximum of every thread's key, folded into *dst by thread 0.
__device__ __forceinline__ void fold_key(unsigned long long key, unsigned long long* dst) {
  __shared__ unsigned long long s_warp[NT / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long other = __shfl_down_sync(0xffffffffu, key, off);
    key = other > key ? other : key;
  }
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = key;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long best = s_warp[0];
#pragma unroll
    for (int w = 1; w < NT / 32; ++w) best = s_warp[w] > best ? s_warp[w] : best;
    atomicMax(dst, best);
  }
}

// Column pass of step r: u_hat for rows of one chunk, and its pivot key.
template <int D, int K>
__global__ void __launch_bounds__(NT)
aca_column_kernel(const float* __restrict__ rpts, const long long* __restrict__ rids,
                  const float* __restrict__ cpts, const long long* __restrict__ cids,
                  const float* __restrict__ u, const float* __restrict__ v,
                  float* __restrict__ uhat, unsigned long long* row_keys,
                  const unsigned long long* col_keys, int B, int m, int n, int r_clusters,
                  int c_clusters, int k, int r, float matern_norm) {
  __shared__ float s_vj[MAX_K];
  __shared__ int s_used[MAX_K];
  __shared__ float s_q[D];
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const float* rp = rpts + (size_t)cluster_or_0(rids[b], r_clusters) * m * D;
  const float* cp = cpts + (size_t)cluster_or_0(cids[b], c_clusters) * n * D;
  const int j = (r == 0) ? 0 : key_index(col_keys[(size_t)(r - 1) * B + b]);
  if (tid < r) {
    s_vj[tid] = v[((size_t)b * n + j) * k + tid];
    s_used[tid] = key_index(row_keys[(size_t)tid * B + b]);
  }
  if (tid < D) s_q[tid] = cp[(size_t)j * D + tid];
  __syncthreads();

  const int i = blockIdx.x * NT + tid;
  unsigned long long key = 0ull;    // below every real candidate
  if (i < m) {
    float p[D];
#pragma unroll
    for (int dim = 0; dim < D; ++dim) p[dim] = rp[(size_t)i * D + dim];
    const float a = repro::phi_from_sqdist<K>(repro::sqdist_direct<D>(p, s_q), matern_norm);
    const float* ui = u + ((size_t)b * m + i) * k;
    float dot = 0.0f;
    for (int s = 0; s < r; ++s) dot = fmaf(ui[s], s_vj[s], dot);
    const float val = a - dot;
    uhat[(size_t)b * m + i] = val;
    bool used = false;
    for (int s = 0; s < r; ++s) used |= (s_used[s] == i);
    key = pivot_key(used ? -1.0f : fabsf(val), i);
  }
  fold_key(key, &row_keys[(size_t)r * B + b]);
}

// Row pass of step r: U[:, r] for rows of one chunk, V[:, r] for columns of
// the same chunk, and the key of the next column pivot.
template <int D, int K>
__global__ void __launch_bounds__(NT)
aca_row_kernel(const float* __restrict__ rpts, const long long* __restrict__ rids,
               const float* __restrict__ cpts, const long long* __restrict__ cids,
               float* u, float* v, const float* __restrict__ uhat,
               const unsigned long long* row_keys, unsigned long long* col_keys,
               int B, int m, int n, int r_clusters, int c_clusters, int k, int r,
               float matern_norm) {
  __shared__ float s_ui[MAX_K];
  __shared__ int s_used[MAX_K];
  __shared__ float s_p[D];
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const bool valid = cluster_or_0(rids[b], r_clusters) == rids[b] &&
                     cluster_or_0(cids[b], c_clusters) == cids[b];
  const float* rp = rpts + (size_t)cluster_or_0(rids[b], r_clusters) * m * D;
  const float* cp = cpts + (size_t)cluster_or_0(cids[b], c_clusters) * n * D;
  const int ip = key_index(row_keys[(size_t)r * B + b]);
  const float alpha = uhat[(size_t)b * m + ip];
  const bool safe = fabsf(alpha) > 1e-30f;
  const float inv = safe ? 1.0f / alpha : 0.0f;
  if (tid < r) s_ui[tid] = u[((size_t)b * m + ip) * k + tid];
  if (tid <= r) s_used[tid] = (tid == 0) ? 0 : key_index(col_keys[(size_t)(tid - 1) * B + b]);
  if (tid < D) s_p[tid] = rp[(size_t)ip * D + tid];
  __syncthreads();

  const int idx = blockIdx.x * NT + tid;
  if (idx < m) {
    u[((size_t)b * m + idx) * k + r] =
        !valid ? CUDART_NAN_F : (safe ? uhat[(size_t)b * m + idx] * inv : 0.0f);
  }
  unsigned long long key = 0ull;
  if (idx < n) {
    float q[D];
#pragma unroll
    for (int dim = 0; dim < D; ++dim) q[dim] = cp[(size_t)idx * D + dim];
    const float a = repro::phi_from_sqdist<K>(repro::sqdist_direct<D>(s_p, q), matern_norm);
    const float* vj = v + ((size_t)b * n + idx) * k;
    float dot = 0.0f;
    for (int s = 0; s < r; ++s) dot = fmaf(vj[s], s_ui[s], dot);
    const float val = safe ? a - dot : 0.0f;
    v[((size_t)b * n + idx) * k + r] = valid ? val : CUDART_NAN_F;
    bool used = false;
    for (int s = 0; s <= r; ++s) used |= (s_used[s] == idx);
    key = pivot_key(used ? -1.0f : fabsf(val), idx);
  }
  fold_key(key, &col_keys[(size_t)r * B + b]);
}

template <int D, int K>
void run_steps(const float* rpts, const long long* rids, const float* cpts,
               const long long* cids, float* u, float* v, float* uhat,
               unsigned long long* row_keys, unsigned long long* col_keys, int B, int m,
               int n, int r_clusters, int c_clusters, int k, float matern_norm,
               cudaStream_t s) {
  const dim3 grid_col((m + NT - 1) / NT, B);
  const dim3 grid_row(((m > n ? m : n) + NT - 1) / NT, B);
  for (int r = 0; r < k; ++r) {
    aca_column_kernel<D, K><<<grid_col, NT, 0, s>>>(rpts, rids, cpts, cids, u, v, uhat,
                                                     row_keys, col_keys, B, m, n, r_clusters,
                                                     c_clusters, k, r, matern_norm);
    aca_row_kernel<D, K><<<grid_row, NT, 0, s>>>(rpts, rids, cpts, cids, u, v, uhat,
                                                  row_keys, col_keys, B, m, n, r_clusters,
                                                  c_clusters, k, r, matern_norm);
  }
}

template <int D>
void run_kernel(int kernel_id, const float* rpts, const long long* rids, const float* cpts,
                const long long* cids, float* u, float* v, float* uhat,
                unsigned long long* row_keys, unsigned long long* col_keys, int B, int m,
                int n, int r_clusters, int c_clusters, int k, float matern_norm,
                cudaStream_t s) {
  if (kernel_id == repro::KERNEL_GAUSSIAN) {
    run_steps<D, repro::KERNEL_GAUSSIAN>(rpts, rids, cpts, cids, u, v, uhat, row_keys,
                                         col_keys, B, m, n, r_clusters, c_clusters, k,
                                         matern_norm, s);
  } else {
    run_steps<D, repro::KERNEL_MATERN>(rpts, rids, cpts, cids, u, v, uhat, row_keys,
                                       col_keys, B, m, n, r_clusters, c_clusters, k,
                                       matern_norm, s);
  }
}

}  // namespace

// Block b has rows rpts[rids[b] * m : (rids[b] + 1) * m] and columns
// cpts[cids[b] * n : (cids[b] + 1) * n] (points of d floats, contiguous;
// rpts holds r_clusters clusters of m points, cpts c_clusters of n).  A
// block whose id lies outside its array gets NaN factors.
// u: (B, m, k), v: (B, n, k) f32 outputs; uhat: (B, m) f32 scratch;
// keys: 2 * k * B uint64, ZEROED by the caller (row pivot keys, then column
// pivot keys, step-major); they hold the pivots afterwards.  Requires
// 1 <= k <= 64, d in {1, 2, 3}, B <= 65535, m, n, r_clusters, c_clusters >= 1
// (cudaErrorInvalidValue otherwise).  Returns cudaGetLastError() after the
// 2k launches.
extern "C" int repro_batched_aca(const float* rpts, const long long* rids, const float* cpts,
                                 const long long* cids, float* u, float* v, float* uhat,
                                 unsigned long long* keys, int B, int m, int n, int r_clusters,
                                 int c_clusters, int d, int k, int kernel_id, float matern_norm,
                                 void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (B < 0 || B > 65535 || m <= 0 || n <= 0 || k <= 0 || k > MAX_K || r_clusters <= 0 ||
      c_clusters <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (kernel_id != repro::KERNEL_GAUSSIAN && kernel_id != repro::KERNEL_MATERN) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* row_keys = keys;
  unsigned long long* col_keys = keys + (size_t)k * B;
  switch (d) {
    case 1: run_kernel<1>(kernel_id, rpts, rids, cpts, cids, u, v, uhat, row_keys, col_keys,
                          B, m, n, r_clusters, c_clusters, k, matern_norm, s);
              break;
    case 2: run_kernel<2>(kernel_id, rpts, rids, cpts, cids, u, v, uhat, row_keys, col_keys,
                          B, m, n, r_clusters, c_clusters, k, matern_norm, s);
              break;
    case 3: run_kernel<3>(kernel_id, rpts, rids, cpts, cids, u, v, uhat, row_keys, col_keys,
                          B, m, n, r_clusters, c_clusters, k, matern_norm, s);
              break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
