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
// Design.  Three launches, each shaped for one part of the work:
//   1. gram   grid (B, row chunks, 2 panels): a CTA forms the partial Gram
//             of CHUNK rows as a register-tiled product: one thread per
//             4 x 4 tile of the lower triangle (both triangles written with
//             the same value), rows staged through shared memory with the
//             next stage prefetched into registers, the row groups' partial
//             tiles summed in a fixed order; partials go to scratch;
//   2. core   a team of threads per block runs the whole k x k chain with
//             no CTA-wide barrier: at k = 64 (K = 64) a CTA of two warps,
//             each on half of the core's rows; at smaller k (K = k rounded
//             up to a power of two) K/2 lanes of one warp, all rows (four
//             blocks per warp at k = 16).  Partials summed in chunk order;
//             the Cholesky factors of both Grams, interleaved (left-looking,
//             the same fmaf chain as the reference's rank-1 updates); M =
//             Lu^T Lv into registers, two columns per lane; both triangular
//             inverses in place (each thread its own columns of X, held in
//             registers, written over the upper triangle; L's strict lower
//             triangle and saved diagonal read); the Jacobi on M in registers, so a rotation is local
//             to a lane (the two row halves add their three dot products
//             through shared memory, one barrier of the two warps a round),
//             the columns moving between lanes by shuffles in the first
//             port's pair order (below); then T_u = X_u (M . keep), and Z
//             replayed: the identity in the same registers, taken through
//             the same walk by the angles the Jacobi logged (one float per
//             lane and round, in global scratch, the next one prefetched),
//             and T_v = X_v (Z . keep).  The transforms come out with the
//             truncation and the descending-sigma order folded in.  An
//             H-LU call is bound by this chain's latency (its blocks are
//             few and mostly zero), hence the two warps on one k = 64 block;
//   3. apply  grid (B, row tiles, 2 panels): U' = U T_u and V' = V T_v as a
//             register-tiled product (4 rows x 4 columns a thread); a block
//             of rank 0 writes zeros without reading its panels.
// A block whose Gram has a zero trace (an all-zero panel: most of H-LU's
// re-truncation blocks, its padding lanes and tiles of rank 0) skips the
// chain and gets zero transforms, rank 0 and one sweep: the jitter and
// every pivot are then 0, so the chain would drop every direction and find
// no rotation.  The cap on dynamic shared memory is raised once per device.
//
// The Jacobi pair order is the circle method of the first port: lane j
// holds the columns at positions j and K-1-j; after each round position 0
// stays and the others move one place around the circle (two shuffles per
// row), so the K - 1 rounds of a sweep meet every pair once, as the
// reference's cyclic sweep does.  A recursive order that moves one column
// per round (one shuffle) converges too slowly: on H-LU's rank-deficient
// blocks its 8 sweeps left errors of 1.6e-4 of the block's norm where this
// order's leave 2e-5.
//
// Why Z is accumulated (replayed), not derived.  Z_k = M^T W_k S_k^-1 would
// spare the replay, but a small kept column carries a direction error of
// order eps sigma_0 / sigma_i from its rotations against large ones, and
// that formula multiplies it by sigma_0 / sigma_i again: on H-LU's
// rank-deficient concatenations a kept noise column then costs 1e-2 of the
// block's norm.  M_final Z^T = M holds for the accumulated Z whatever the
// columns' directions.  A float32 model of this chain is held to the
// QR + SVD oracle in tests/test_torch_recompress.py.
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
// No atomics: results are bit-reproducible.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXK = 64;
constexpr int CHUNK = 1024;      // rows per Gram-partial CTA
constexpr int GRAM_NT = 256;     // threads of a Gram CTA at most
constexpr int APPLY_NT = 256;    // threads of a transform CTA
constexpr int APPLY_RT = 4;      // rows per transform thread
constexpr int CORE_WPC = 2;      // warps per core CTA
constexpr float TINY = 1e-30f;   // pivot / diagonal clamp of the reference
constexpr double JITTER = 1e-7;  // relative Gram jitter of the reference
constexpr int SWEEPS = 8;        // Jacobi sweeps of the reference

// ---------------------------------------------------------------- 1. gram

struct GramShape {
  int kq;      // column quads: ceil(k / 4)
  int ntile;   // 4 x 4 tiles of the lower triangle: kq (kq + 1) / 2
  int ng;      // row groups: GRAM_NT / ntile
  int tr;      // rows per stage: ng * ceil(32 / ng)
  int ldx;     // row stride of a staged row: 4 kq + 4
};

GramShape gram_shape(int k) {
  GramShape g;
  g.kq = (k + 3) / 4;
  g.ntile = g.kq * (g.kq + 1) / 2;
  g.ng = GRAM_NT / g.ntile;
  g.tr = g.ng * ((32 + g.ng - 1) / g.ng);
  g.ldx = 4 * g.kq + 4;
  return g;
}

// One float4 slot (row r of the chunk, quad q) of a panel, zero past the
// chunk's rows or the panel's k columns.
__device__ __forceinline__ float4 load_quad(const float* __restrict__ x, long long r, int q,
                                            int k, bool vec) {
  const float* p = x + r * k + 4 * q;
  if (vec) return *reinterpret_cast<const float4*>(p);
  float4 o;
  o.x = 4 * q + 0 < k ? p[0] : 0.0f;
  o.y = 4 * q + 1 < k ? p[1] : 0.0f;
  o.z = 4 * q + 2 < k ? p[2] : 0.0f;
  o.w = 4 * q + 3 < k ? p[3] : 0.0f;
  return o;
}

constexpr int GRAM_PF = 4;   // float4 slots a thread prefetches per stage (at most)

__global__ void __launch_bounds__(GRAM_NT)
gram_kernel(const float* __restrict__ u, const float* __restrict__ v, float* __restrict__ part,
            int B, int m, int n, int k, int splits, GramShape gs, int vec) {
  extern __shared__ __align__(16) float s_x[];   // max(tr * ldx, nthreads * 16)
  const int b = blockIdx.x, s = blockIdx.y, which = blockIdx.z;
  const int rows = which ? n : m;
  const float* xb = (which ? v : u) + (size_t)b * rows * k;
  const int nth = gs.ntile * gs.ng;
  const int tid = threadIdx.x;
  const int tile = tid % gs.ntile, grp = tid / gs.ntile;
  int ta = 0, tb = tile;                 // tile -> (ta >= tb) of the lower triangle
  while (tb > ta) { tb -= ta + 1; ++ta; }
  const long long row_begin = (long long)s * CHUNK;
  const long long row_end = row_begin + CHUNK < rows ? row_begin + CHUNK : rows;
  const int slots = gs.tr * gs.kq;       // float4 slots per stage

  float acc[4][4];
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) acc[x][y] = 0.0f;

  float4 pf[GRAM_PF];
  auto fetch = [&](long long r0) {
#pragma unroll
    for (int t = 0; t < GRAM_PF; ++t) {
      const int slot = tid + t * nth;
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
      if (slot < slots) {
        const int r = slot / gs.kq, q = slot - (slot / gs.kq) * gs.kq;
        if (r0 + r < row_end) o = load_quad(xb, r0 + r, q, k, vec && 4 * q < k);
      }
      pf[t] = o;
    }
  };
  fetch(row_begin);
  for (long long r0 = row_begin; r0 < row_end; r0 += gs.tr) {
    __syncthreads();                     // the last stage's reads are done
#pragma unroll
    for (int t = 0; t < GRAM_PF; ++t) {
      const int slot = tid + t * nth;
      if (slot < slots) {
        const int r = slot / gs.kq, q = slot - (slot / gs.kq) * gs.kq;
        *reinterpret_cast<float4*>(s_x + r * gs.ldx + 4 * q) = pf[t];
      }
    }
    __syncthreads();
    if (r0 + gs.tr < row_end) fetch(r0 + gs.tr);
    if (tid < nth) {
      const int nr = (int)(row_end - r0 < gs.tr ? row_end - r0 : gs.tr);
      for (int r = grp; r < nr; r += gs.ng) {
        const float4 xa = *reinterpret_cast<const float4*>(s_x + r * gs.ldx + 4 * ta);
        const float4 xc = *reinterpret_cast<const float4*>(s_x + r * gs.ldx + 4 * tb);
        const float a4[4] = {xa.x, xa.y, xa.z, xa.w};
        const float c4[4] = {xc.x, xc.y, xc.z, xc.w};
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(a4[x], c4[y], acc[x][y]);
      }
    }
  }
  // the row groups' partial tiles, summed in group order
  __syncthreads();
  if (tid < nth) {
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) s_x[(grp * gs.ntile + tile) * 16 + x * 4 + y] = acc[x][y];
  }
  __syncthreads();
  const int kk2 = k * k;
  float* out = part + (((size_t)which * B + b) * splits + s) * kk2;
  for (int e = tid; e < gs.ntile * 16; e += nth) {
    const int t = e >> 4, x = (e >> 2) & 3, y = e & 3;
    float sum = s_x[t * 16 + x * 4 + y];
    for (int g = 1; g < gs.ng; ++g) sum += s_x[(g * gs.ntile + t) * 16 + x * 4 + y];
    int a = 0, c = t;
    while (c > a) { c -= a + 1; ++a; }
    const int i = 4 * a + x, j = 4 * c + y;
    if (i < k && j < k) {
      out[i * k + j] = sum;
      out[j * k + i] = sum;
    }
  }
}

// ---------------------------------------------------------------- 2. core

// The threads of one block's chain.  k = 64 (K = 64): the two warps of the
// CTA, each on half of the k x k core's rows ("row halves"), every lane on
// the same two columns in both; K <= 32: G = K/2 lanes of one warp, all rows.
template <int K>
struct Team {
  static constexpr bool SPLIT = K == 64;          // rows split over two warps
  static constexpr int G = K / 2;                  // lanes per warp on a block
  static constexpr int R = SPLIT ? K / 2 : K;      // rows of M a lane holds
  static constexpr int BPW = SPLIT ? 1 : 32 / G;   // blocks per warp
  static constexpr int BPC = SPLIT ? 1 : CORE_WPC * BPW;   // blocks per CTA
  static constexpr int NT = SPLIT ? 64 : G;        // threads on a block
  static constexpr int LD = K + 1;
  static constexpr int XB = SPLIT ? 2 * 2 * 32 * 3 : 0;    // partial-sum exchange
  // floats of shared memory per block: L_u -> X_u, L_v -> X_v and the
  // staging of M . keep and Z . keep (K x (K+1) each), the diagonals, the
  // sort keys and the exchange, padded to 1 mod 32 so the blocks of a warp
  // sit on different banks
  static constexpr int PER = ((3 * K * LD + 3 * K + XB + 31) / 32) * 32 + 1;
  unsigned gm;   // the lanes of this warp on the block
  int gl;        // lane within the block's lanes of this warp
  int t;         // thread within the block's threads
  int w;         // row half (0 when not split)
  __device__ __forceinline__ void sync() const {
    if constexpr (SPLIT) __syncthreads(); else __syncwarp(gm);
  }
};

__device__ __forceinline__ float group_max(float x, unsigned gm, int width) {
  for (int off = width >> 1; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(gm, x, off, width));
  return x;
}

// Sums of a lane's partials over the two row halves (fixed order: half 0
// + half 1); the identity when rows are not split.  xb: the block's
// exchange, parity p selects one of its two slots (a round's slot is not
// reused before every thread has passed the next round's barrier).
template <int K, int N>
__device__ __forceinline__ void sum_halves(const Team<K>& tm, float* xb, int p, float (&v)[N]) {
  if constexpr (Team<K>::SPLIT) {
    float* slot = xb + p * 2 * 32 * 3;
#pragma unroll
    for (int e = 0; e < N; ++e) slot[(tm.w * 32 + tm.gl) * 3 + e] = v[e];
    __syncthreads();
#pragma unroll
    for (int e = 0; e < N; ++e) v[e] = slot[tm.gl * 3 + e] + slot[(32 + tm.gl) * 3 + e];
  }
}

// Left-looking Cholesky of the two (k, k) matrices g and h (leading
// dimension K + 1) in place, by the team's threads (a row each, or two),
// interleaved for latency: L[i][j] = (g[i][j] - sum_p<j L[i][p] L[j][p]) /
// L[j][j], the sum subtracted in p order (the fmaf chain of the reference's
// right-looking rank-1 updates).  A pivot at or below max(jitter, TINY) is
// a dependent direction: its column of L is zero.  On return g and h hold L
// in their lower triangles and zeros above.
template <int K>
__device__ void cholesky_pair(const Team<K>& tm, float* g, float* h, int k, float jg, float jh) {
  constexpr int LD = K + 1, NT = Team<K>::NT, NR = K / NT;
  const float fg = fmaxf(jg, TINY), fh = fmaxf(jh, TINY);
  for (int j = 0; j < k; ++j) {
    float dg = g[j * LD + j], dh = h[j * LD + j];
    float ag[NR], ah[NR];
#pragma unroll
    for (int x = 0; x < NR; ++x) {
      ag[x] = g[(tm.t + NT * x) * LD + j];
      ah[x] = h[(tm.t + NT * x) * LD + j];
    }
#pragma unroll 4
    for (int p = 0; p < j; ++p) {
      const float lg = g[j * LD + p], lh = h[j * LD + p];
      dg = fmaf(-lg, lg, dg);
      dh = fmaf(-lh, lh, dh);
#pragma unroll
      for (int x = 0; x < NR; ++x) {
        ag[x] = fmaf(-g[(tm.t + NT * x) * LD + p], lg, ag[x]);
        ah[x] = fmaf(-h[(tm.t + NT * x) * LD + p], lh, ah[x]);
      }
    }
    const float ig = dg > fg ? 1.0f / sqrtf(dg) : 0.0f;
    const float ih = dh > fh ? 1.0f / sqrtf(dh) : 0.0f;
    tm.sync();                           // row j's reads are done
#pragma unroll
    for (int x = 0; x < NR; ++x) {
      const int i = tm.t + NT * x;
      if (i > j && i < k) {
        g[i * LD + j] = ag[x] * ig;
        h[i * LD + j] = ah[x] * ih;
      }
    }
    if (tm.t == 0) {
      g[j * LD + j] = dg * ig;
      h[j * LD + j] = dh * ih;
    }
    tm.sync();
  }
  for (int i = tm.t; i < K; i += NT)
    for (int l = i + 1; l < K; ++l) g[i * LD + l] = h[i * LD + l] = 0.0f;
  tm.sync();
}

// Column c of X = (L^T)^-1 by the reference's k-step back substitution on
// an identity panel, the column in registers (row r static): x_i = y_i / d_i,
// then y_r -= L[i][r] x_i for r < i.  L's strict lower triangle and its
// diagonal d (saved apart) are read; x_i goes to the upper triangle or the
// diagonal at (i, c) (X is upper triangular), so no thread writes what
// another reads.  A dropped pivot (zero diagonal) gives a zero row and
// column of X.  A column at or past k is none.
template <int K>
__device__ void inv_upper_column(float* l, const float* d, int k, int c) {
  constexpr int LD = K + 1;
  if (c >= k) return;
  float y[K];
#pragma unroll
  for (int r = 0; r < K; ++r) y[r] = r == c ? 1.0f : 0.0f;
  for (int i = c; i >= 0; --i) {       // y[i] = 0 below c: those steps change nothing
    float yi = 0.0f;
#pragma unroll
    for (int r = 0; r < K; ++r) yi = r == i ? y[r] : yi;
    const float dd = d[i];
    const float dv = fabsf(dd) > TINY ? dd : TINY;
    const float xi = dd != 0.0f ? yi / dv : 0.0f;
#pragma unroll
    for (int r = 0; r < K; ++r)
      if (r < i) y[r] = fmaf(-l[i * LD + r], xi, y[r]);
    l[i * LD + c] = xi;
  }
}

// The rotation angle of the lane's pair (p = s0, q = s1) from its rows'
// dot products (summed over the row halves): t = tan of the angle, 0 for an
// uncoupled pair (|apq| <= TINY); returns whether the pair is coupled.  tau
// and t take the fast reciprocal: they sit on each round's dependent chain,
// and a few ulps in the angle leave the columns as orthogonal as the sweeps
// make them.
template <int K>
__device__ __forceinline__ bool jacobi_angle(const Team<K>& tm, float* xb, int parity,
                                             const float (&mp)[Team<K>::R],
                                             const float (&mq)[Team<K>::R], float& t) {
  constexpr int R = Team<K>::R;
  float app0 = 0.f, app1 = 0.f, aqq0 = 0.f, aqq1 = 0.f, apq0 = 0.f, apq1 = 0.f;
#pragma unroll
  for (int i = 0; i < R; i += 2) {
    app0 = fmaf(mp[i], mp[i], app0);
    aqq0 = fmaf(mq[i], mq[i], aqq0);
    apq0 = fmaf(mp[i], mq[i], apq0);
    app1 = fmaf(mp[i + 1], mp[i + 1], app1);
    aqq1 = fmaf(mq[i + 1], mq[i + 1], aqq1);
    apq1 = fmaf(mp[i + 1], mq[i + 1], apq1);
  }
  float d[3] = {app0 + app1, aqq0 + aqq1, apq0 + apq1};
  sum_halves<K, 3>(tm, xb, parity, d);
  const float pp = d[0], qq = d[1], pq = d[2];
  const bool rot = fabsf(pq) > TINY;
  t = 0.0f;
  if (rot) {
    const float tau = __fdividef(qq - pp, 2.0f * pq);
    const float sg = (tau > 0.0f) ? 1.0f : ((tau < 0.0f) ? -1.0f : 0.0f);
    t = __fdividef(sg, fabsf(tau) + sqrtf(fmaf(tau, tau, 1.0f)));
  }
  return rot;
}

// Rotates the lane's pair by the angle of tangent t (c = 1, s = 0 at t = 0;
// the reference's c is an rsqrt too).  The same t gives the same bits in the
// Jacobi and in the replay onto Z.
template <int R>
__device__ __forceinline__ void rotate(float (&mp)[R], float (&mq)[R], float t) {
  const float c = t == 0.0f ? 1.0f : rsqrtf(fmaf(t, t, 1.0f));
  const float s = c * t;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float x = mp[i], y = mq[i];
    mp[i] = c * x - s * y;
    mq[i] = s * x + c * y;
  }
}

// The one-sided Jacobi of the lane pairs (a0, a1) in the first port's
// round-robin order (header).  JACOBI: at most SWEEPS sweeps, stopping
// after one without a coupled pair; each round's t goes to tlog (tlog[round
// * G + lane]); returns the sweeps run.  Replay (!JACOBI): the same walk
// over `sweeps` sweeps, each round rotating by the logged t, so that the
// columns of Z take the rotations M took.  ids follow the columns.
template <int K, bool JACOBI>
__device__ __forceinline__ int jacobi_walk(const Team<K>& tm, float* xb,
                                           float (&a0)[Team<K>::R], float (&a1)[Team<K>::R],
                                           int& id0, int& id1, float* tlog, int sweeps) {
  constexpr int G = Team<K>::G, R = Team<K>::R;
  const int gl = tm.gl;
  const unsigned gm = tm.gm;
  const int up = gl + 1 < G ? gl + 1 : gl, dn = gl > 0 ? gl - 1 : gl;
  const bool first = gl == 0, last = gl == G - 1;
  int rd = 0, sw = 0;
  const int rounds = sweeps * (K - 1);
  float t_next = !JACOBI && rounds > 0 ? tlog[gl] : 0.0f;   // the replay's next angle, in flight
  while (sw < sweeps) {
    bool coupled = false;
    for (int r = 0; r < K - 1; ++r, ++rd) {
      float t;
      if (JACOBI) {
        coupled |= jacobi_angle<K>(tm, xb, rd & 1, a0, a1, t);
        if (tm.w == 0) tlog[rd * G + gl] = t;
      } else {
        t = t_next;
        if (rd + 1 < rounds) t_next = tlog[(rd + 1) * G + gl];
      }
      rotate<R>(a0, a1, t);
      if (G > 1) {
        // the circle method: position 0 (lane 0's s0) stays; s0 moves down a
        // lane, s1 up a lane, lane G-1's s1 turns into its s0 and lane 1's s0
        // into lane 0's s1
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float from_up = __shfl_sync(gm, a0[i], up, G);
          const float from_dn = __shfl_sync(gm, a1[i], dn, G);
          a0[i] = first ? a0[i] : (last ? a1[i] : from_up);
          a1[i] = first ? from_up : from_dn;
        }
        const int i_up = __shfl_sync(gm, id0, up, G), i_dn = __shfl_sync(gm, id1, dn, G);
        id0 = first ? id0 : (last ? id1 : i_up);
        id1 = first ? i_up : i_dn;
      }
    }
    ++sw;
    if (JACOBI && !__any_sync(gm, coupled)) break;
  }
  return sw;
}

// floats of the rotation log per block: one t per lane and round
__host__ __device__ constexpr int log_per_block(int big_k) {
  return SWEEPS * (big_k - 1) * (big_k / 2);
}

template <int K>
constexpr size_t core_smem() {
  return sizeof(float) * (size_t)Team<K>::PER * Team<K>::BPC;
}

// T = X (S . keep) for the lane's two columns (ids), written at their pos:
// X upper triangular in x (leading dimension K + 1), S staged by column id
// in st; rows r of the thread's row half (all rows when not split).
template <int K>
__device__ __forceinline__ void transform_columns(const Team<K>& tm, const float* x,
                                                  const float* st, int k, int id0, int id1,
                                                  int pos0, int pos1, float* out) {
  constexpr int LD = K + 1, R = Team<K>::R;
  const int r_end = min(k, tm.w * R + R);
  for (int r = tm.w * R; r < r_end; ++r) {
    float a0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, a1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int l4 = r & ~3; l4 < K; l4 += 4) {   // X is zero left of the diagonal
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (K < 4 && l4 + e >= K) break;       // K = 2: half a quad
        const float xv = x[r * LD + l4 + e];
        const float m = l4 + e >= r ? xv : 0.0f;
        a0[e] = fmaf(m, st[(l4 + e) * LD + id0], a0[e]);
        a1[e] = fmaf(m, st[(l4 + e) * LD + id1], a1[e]);
      }
    }
    if (id0 < k) out[r * k + pos0] = (a0[0] + a0[1]) + (a0[2] + a0[3]);
    if (id1 < k) out[r * k + pos1] = (a1[0] + a1[1]) + (a1[2] + a1[3]);
  }
}

template <int K>
__global__ void __launch_bounds__(CORE_WPC * 32)
core_kernel(const float* __restrict__ part, float* __restrict__ tmat, float* __restrict__ s_out,
            int* __restrict__ ranks, int* __restrict__ sweeps_out, float* __restrict__ tlogs,
            int B, int k, int splits, float tol) {
  using T = Team<K>;
  constexpr int G = T::G, R = T::R, LD = T::LD;
  extern __shared__ float sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T tm;
  long long b;
  int slot;
  if constexpr (T::SPLIT) {
    tm.gm = 0xffffffffu;
    tm.gl = lane;
    tm.t = threadIdx.x;
    tm.w = warp;
    b = blockIdx.x;
    slot = 0;
  } else {
    const int gi = lane / G;
    tm.gm = G == 32 ? 0xffffffffu : (((1u << G) - 1u) << (gi * G));
    tm.gl = lane % G;
    tm.t = tm.gl;
    tm.w = 0;
    slot = warp * T::BPW + gi;
    b = (long long)blockIdx.x * T::BPC + slot;
  }
  if (b >= B) return;                  // the whole team leaves together
  const int gl = tm.gl;
  float* A = sm + (size_t)slot * T::PER;   // G_u -> L_u -> X_u
  float* Bm = A + K * LD;                  // G_v -> L_v -> X_v
  float* C = Bm + K * LD;                  // M . keep, then Z . keep, by column id
  float* key = C + K * LD;
  float* du = key + K;                     // the diagonals of L_u and L_v
  float* dv = du + K;
  float* xb = dv + K;                      // the row halves' partial sums
  float* tlog = tlogs + (size_t)b * log_per_block(K);
  const int kk2 = k * k;
  float* tu = tmat + (size_t)b * kk2;
  float* tv = tmat + ((size_t)B + b) * kk2;

  // partial Grams summed in chunk order, zero-padded to K x K
  const float* pu = part + (size_t)b * splits * kk2;
  const float* pv = part + ((size_t)B + b) * splits * kk2;
#pragma unroll 4
  for (int o = tm.t; o < K * K; o += T::NT) {
    const int i = o / K, j = o % K;
    float gu = 0.0f, gv = 0.0f;
    if (i < k && j < k) {
      const int oo = i * k + j;
      gu = pu[oo];
      gv = pv[oo];
      for (int s = 1; s < splits; ++s) {
        gu += pu[(size_t)s * kk2 + oo];
        gv += pv[(size_t)s * kk2 + oo];
      }
    }
    A[i * LD + j] = gu;
    Bm[i * LD + j] = gv;
  }
  tm.sync();
  float tru = 0.0f, trv = 0.0f;
  for (int i = 0; i < k; ++i) {
    tru += A[i * LD + i];
    trv += Bm[i * LD + i];
  }
  if (tru == 0.0f || trv == 0.0f) {    // an all-zero panel: rank 0, zero transforms
    for (int o = tm.t; o < kk2; o += T::NT) {
      tu[o] = 0.0f;
      tv[o] = 0.0f;
    }
    for (int i = tm.t; i < k; i += T::NT) s_out[(size_t)b * k + i] = 0.0f;
    if (tm.t == 0) {
      ranks[b] = 0;
      sweeps_out[b] = 1;
    }
    return;
  }
  const float ju = (float)(JITTER / k) * tru, jv = (float)(JITTER / k) * trv;
  tm.sync();
  for (int i = tm.t; i < k; i += T::NT) {
    A[i * LD + i] += ju;
    Bm[i * LD + i] += jv;
  }
  tm.sync();
  cholesky_pair<K>(tm, A, Bm, k, ju, jv);

  // M = Lu^T Lv: the lane holds columns gl and K-1-gl (the circle's
  // positions), rows of its row half: M[i][c] = sum_l Lu[l][i] Lv[l][c]
  const int c1 = K - 1 - gl, row0 = tm.w * R;
  float m0[R], m1[R];
#pragma unroll
  for (int i = 0; i < R; ++i) m0[i] = m1[i] = 0.0f;
  for (int l = 0; l < k; ++l) {
    const float v0 = Bm[l * LD + gl], v1 = Bm[l * LD + c1];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float a = A[l * LD + row0 + i];
      m0[i] = fmaf(a, v0, m0[i]);
      m1[i] = fmaf(a, v1, m1[i]);
    }
  }
  for (int i = tm.t; i < k; i += T::NT) {
    du[i] = A[i * LD + i];
    dv[i] = Bm[i * LD + i];
  }
  tm.sync();                 // every read of the triangles' diagonals and upper halves is done
  // X_u, X_v over the upper triangles, each thread its own columns
  for (int c = tm.t; c < K; c += T::NT) {
    inv_upper_column<K>(A, du, k, c);
    inv_upper_column<K>(Bm, dv, k, c);
  }

  // one-sided Jacobi on M's columns, the angles logged for Z
  int id0 = gl, id1 = c1;
  const int sweeps = jacobi_walk<K, true>(tm, xb, m0, m1, id0, id1, tlog, SWEEPS);

  // sigma = column norms of M; keep s > tol * max s; descending order
  float sg[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < R; ++i) {
    sg[0] = fmaf(m0[i], m0[i], sg[0]);
    sg[1] = fmaf(m1[i], m1[i], sg[1]);
  }
  sum_halves<K, 2>(tm, xb, sweeps & 1, sg);   // the slot the last round did not use
  const float sg0 = sqrtf(sg[0]), sg1 = sqrtf(sg[1]);
  const float smax = group_max(fmaxf(sg0, sg1), tm.gm, G);
  const float key0 = (id0 < k && sg0 > tol * smax) ? sg0 : 0.0f;
  const float key1 = (id1 < k && sg1 > tol * smax) ? sg1 : 0.0f;
  if (tm.w == 0) {
    if (id0 < k) key[id0] = key0;
    if (id1 < k) key[id1] = key1;
  }
  const float kp0 = key0 > 0.0f ? 1.0f : 0.0f, kp1 = key1 > 0.0f ? 1.0f : 0.0f;
#pragma unroll
  for (int i = 0; i < R; ++i) {        // M . keep, staged by column id
    C[(row0 + i) * LD + id0] = m0[i] * kp0;
    C[(row0 + i) * LD + id1] = m1[i] * kp1;
  }
  tm.sync();
  int pos0 = 0, pos1 = 0;
  for (int j = 0; j < k; ++j) {
    const float kj = key[j];
    pos0 += (kj > key0) || (kj == key0 && j < id0);
    pos1 += (kj > key1) || (kj == key1 && j < id1);
  }
  if (tm.w == 0) {
    const int rank = __popc(__ballot_sync(tm.gm, key0 > 0.0f))
                     + __popc(__ballot_sync(tm.gm, key1 > 0.0f));
    if (gl == 0) {
      ranks[b] = rank;
      sweeps_out[b] = sweeps;
    }
    if (id0 < k) s_out[(size_t)b * k + pos0] = key0;
    if (id1 < k) s_out[(size_t)b * k + pos1] = key1;
  }
  // T_u = X_u (M . keep), columns placed at pos
  transform_columns<K>(tm, A, C, k, id0, id1, pos0, pos1, tu);
  // Z: the identity taken through the logged rotations; T_v = X_v (Z . keep)
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m0[i] = row0 + i == gl ? 1.0f : 0.0f;
    m1[i] = row0 + i == c1 ? 1.0f : 0.0f;
  }
  int zid0 = gl, zid1 = c1;
  jacobi_walk<K, false>(tm, xb, m0, m1, zid0, zid1, tlog, sweeps);
  tm.sync();                           // every read of M . keep is done
#pragma unroll
  for (int i = 0; i < R; ++i) {
    C[(row0 + i) * LD + id0] = m0[i] * kp0;
    C[(row0 + i) * LD + id1] = m1[i] * kp1;
  }
  tm.sync();
  transform_columns<K>(tm, Bm, C, k, id0, id1, pos0, pos1, tv);
}

// ---------------------------------------------------------------- 3. apply

__global__ void __launch_bounds__(APPLY_NT)
transform_kernel(const float* __restrict__ u, const float* __restrict__ v,
                 const float* __restrict__ tmat, const int* __restrict__ ranks,
                 float* __restrict__ u2, float* __restrict__ v2, int B, int m, int n, int k,
                 int vec) {
  extern __shared__ __align__(16) float sm[];
  const int kq = (k + 3) / 4, kp = 4 * kq;
  const int nrg = APPLY_NT / kq, tm = APPLY_RT * nrg;
  const int ldx = kp + 4;
  float* s_t = sm;             // kp x kp
  float* s_x = sm + kp * kp;   // tm x ldx
  const int b = blockIdx.x, which = blockIdx.z;
  const int rows = which ? n : m;
  const long long row0 = (long long)blockIdx.y * tm;
  if (row0 >= rows) return;    // the same for every thread of the CTA
  const int nr = (int)(rows - row0 < tm ? rows - row0 : tm);
  const int tid = threadIdx.x;
  const float* xb = (which ? v : u) + ((size_t)b * rows + row0) * k;
  float* yb = (which ? v2 : u2) + ((size_t)b * rows + row0) * k;
  const float* tb = tmat + ((size_t)which * B + b) * k * k;
  if (ranks[b] == 0) {         // zero transforms (an all-zero block): zeros, U unread
    for (long long t = tid; t < (long long)nr * k; t += APPLY_NT) yb[t] = 0.0f;
    return;
  }
  for (int t = tid; t < kp * kp; t += APPLY_NT) {
    const int l = t / kp, c = t - (t / kp) * kp;
    s_t[t] = (l < k && c < k) ? tb[l * k + c] : 0.0f;
  }
  for (int t = tid; t < tm * kq; t += APPLY_NT) {
    const int r = t / kq, q = t - (t / kq) * kq;
    const float4 o = r < nr ? load_quad(xb, r, q, k, vec) : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(s_x + r * ldx + 4 * q) = o;
  }
  __syncthreads();
  if (tid >= nrg * kq) return;
  const int cq = tid % kq, rg = tid / kq;
  float acc[APPLY_RT][4];
#pragma unroll
  for (int x = 0; x < APPLY_RT; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) acc[x][y] = 0.0f;
  for (int lq = 0; lq < kq; ++lq) {
    float4 tq[4];
#pragma unroll
    for (int y = 0; y < 4; ++y) tq[y] = *reinterpret_cast<const float4*>(s_t + (4 * lq + y) * kp + 4 * cq);
#pragma unroll
    for (int x = 0; x < APPLY_RT; ++x) {
      const float4 xv = *reinterpret_cast<const float4*>(s_x + (rg + nrg * x) * ldx + 4 * lq);
      const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        acc[x][0] = fmaf(xs[l], tq[l].x, acc[x][0]);
        acc[x][1] = fmaf(xs[l], tq[l].y, acc[x][1]);
        acc[x][2] = fmaf(xs[l], tq[l].z, acc[x][2]);
        acc[x][3] = fmaf(xs[l], tq[l].w, acc[x][3]);
      }
    }
  }
#pragma unroll
  for (int x = 0; x < APPLY_RT; ++x) {
    const int r = rg + nrg * x;
    if (r >= nr) continue;
    float* out = yb + (size_t)r * k + 4 * cq;
    if (vec) {
      *reinterpret_cast<float4*>(out) = make_float4(acc[x][0], acc[x][1], acc[x][2], acc[x][3]);
    } else {
#pragma unroll
      for (int y = 0; y < 4; ++y)
        if (4 * cq + y < k) out[y] = acc[x][y];
    }
  }
}

size_t transform_smem(int k) {
  const int kq = (k + 3) / 4, kp = 4 * kq;
  return sizeof(float) * ((size_t)kp * kp + (size_t)APPLY_RT * (APPLY_NT / kq) * (kp + 4));
}

int transform_rows(int k) { return APPLY_RT * (APPLY_NT / ((k + 3) / 4)); }

template <int K>
int launch_core(const float* part, float* tmat, float* s, int* ranks, int* sweeps, float* tlog,
                int B, int k, int splits, float tol, cudaStream_t st) {
  constexpr size_t smem = core_smem<K>();
  if constexpr (smem > 48 * 1024) {
    // the cap on dynamic shared memory, set once per device (bit = device)
    static unsigned long long raised = 0;
    int dev = 0;
    int err = (int)cudaGetDevice(&dev);
    if (err) return err;
    if (!(raised >> (dev & 63) & 1)) {
      err = (int)cudaFuncSetAttribute(core_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)smem);
      if (err) return err;
      raised |= 1ull << (dev & 63);
    }
  }
  const long long grid = (B + Team<K>::BPC - 1) / Team<K>::BPC;
  core_kernel<K><<<(unsigned)grid, CORE_WPC * 32, smem, st>>>(part, tmat, s, ranks, sweeps, tlog,
                                                               B, k, splits, tol);
  return (int)cudaGetLastError();
}

}  // namespace

// Number of Gram chunks for panels of m and n rows: the wrapper sizes the
// scratch with it.
extern "C" int repro_recompress_splits(int m, int n) {
  const int rows = m > n ? m : n;
  const int s = (rows + CHUNK - 1) / CHUNK;
  return s > 0 ? s : 1;
}

static int pow2_width(int k) {
  return k <= 2 ? 2 : k <= 4 ? 4 : k <= 8 ? 8 : k <= 16 ? 16 : k <= 32 ? 32 : 64;
}

// Floats of the rotation log per block at width k: the wrapper sizes the
// scratch with it.
extern "C" int repro_recompress_log_floats(int k) { return log_per_block(pow2_width(k)); }

// u: (B, m, k), v: (B, n, k) f32 contiguous -> u2: (B, m, k), v2: (B, n, k)
// with columns in descending-sigma order and truncated columns zero;
// s: (B, k) truncated sigma in the same order, ranks, sweeps: (B,) int32.
// Scratch: part (2, B, splits, k, k), tmat (2, B, k, k) and tlog (B,
// repro_recompress_log_floats(k)) floats.
// Requires 1 <= k <= 64 and at most 65535 row chunks and row tiles
// (cudaErrorInvalidValue otherwise).
extern "C" int repro_batched_recompress(const float* u, const float* v, float* u2, float* v2,
                                        float* s, int* ranks, int* sweeps, float* part,
                                        float* tmat, float* tlog, int B, int m, int n, int k,
                                        float tol, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const int rows = m > n ? m : n;
  const int splits = repro_recompress_splits(m, n);
  if (k <= 0 || k > MAXK || m <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const int tiles = (rows + transform_rows(k) - 1) / transform_rows(k);
  if (tiles > 65535 || splits > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = k % 4 == 0 && aligned(u) && aligned(v) && aligned(u2) && aligned(v2);

  const GramShape gs = gram_shape(k);
  const int nth = gs.ntile * gs.ng;
  size_t smem1 = (size_t)gs.tr * gs.ldx;
  if ((size_t)nth * 16 > smem1) smem1 = (size_t)nth * 16;
  if ((gs.tr * gs.kq + nth - 1) / nth > GRAM_PF) return (int)cudaErrorInvalidValue;
  gram_kernel<<<dim3(B, splits, 2), nth, smem1 * sizeof(float), st>>>(u, v, part, B, m, n, k,
                                                                      splits, gs, vec);
  int err = (int)cudaGetLastError();
  if (err) return err;

  switch (pow2_width(k)) {
    case 2: err = launch_core<2>(part, tmat, s, ranks, sweeps, tlog, B, k, splits, tol, st); break;
    case 4: err = launch_core<4>(part, tmat, s, ranks, sweeps, tlog, B, k, splits, tol, st); break;
    case 8: err = launch_core<8>(part, tmat, s, ranks, sweeps, tlog, B, k, splits, tol, st); break;
    case 16: err = launch_core<16>(part, tmat, s, ranks, sweeps, tlog, B, k, splits, tol, st); break;
    case 32: err = launch_core<32>(part, tmat, s, ranks, sweeps, tlog, B, k, splits, tol, st); break;
    default: err = launch_core<64>(part, tmat, s, ranks, sweeps, tlog, B, k, splits, tol, st); break;
  }
  if (err) return err;
  transform_kernel<<<dim3(B, tiles, 2), APPLY_NT, transform_smem(k), st>>>(u, v, tmat, ranks, u2,
                                                                           v2, B, m, n, k, vec);
  return (int)cudaGetLastError();
}
