// Batched low-rank product Y[b] = U[b] (V[b]^T X[b]), and its level entry
// Z[row cluster] += sum of the cluster's blocks' U (V^T X) in table order.
//
// Replaces the TPU kernel src/repro/kernels/batched_aca/kernel.py:
// batched_lowrank_matmat_t (body _lowrank_mm_kernel), one program per
// block with both thin products on the MXU.
//
// Bound on the H100: bytes.  Per block the kernel reads U (m x k), V
// (n x k) and X (n x R) once and writes Y (m x R), doing only 2k(m+n)R
// flops: at k = 16, R = 8 that is 2 flops per byte, far below the card's
// balance point.  The factors of the paper's problem are 8.95 GB.  The
// level entry reads each block's X slice in place from the tree-ordered
// panel (33.5 MB at R = 8: it stays in the 50 MB L2) and writes each row
// cluster of Z once per group instead of writing Y and scattering it.
//
// Two launches per call (and a memset of B counters when a block's rows
// are split over several CTAs):
//   V^T X   grid (splits, B): a CTA streams CHUNK rows of V and X with
//           16-byte loads, UNROLL rows a thread in flight.  A team of G
//           threads shares a row: thread e of the team holds a quad of k
//           (4 values) times RT columns of the panel.  The row lanes' sums
//           are combined in a fixed order (xor shuffles inside a warp,
//           then the warps in order), written as the split's partial; the
//           last CTA of a block to finish (a counter, which only detects
//           completion) sums the partials in split order into T (k x R).
//   U T     grid (row tiles, B) for the gathered entry, (row tiles, row
//           clusters, longest cluster first) for the level entry: a team
//           of lanes per row, one per quad of k, so that neighbouring
//           lanes load neighbouring 16 bytes of U; lane e holds T's rows
//           4e .. 4e + 3 (read-only cache) and RPT rows.  Per output, y =
//           a fused chain over the quad's 4 values of k, then the quads
//           summed by halving shuffle exchanges (a fixed pairwise tree);
//           the level entry adds its blocks' y left to right in table
//           order and then writes z + sum once.
// The gathered and the level entry run the same code on the same bits:
// the level entry equals the gathered entry followed by the apply's
// fixed-order scatter (core/hmatrix.py: _scatter_rows) bit for bit.  No
// atomic touches a value, so results are bit-reproducible run to run.
// Shared memory: at most 32 KB (the V^T X reduction), below the default
// cap, so no attribute is raised.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;      // threads per CTA
constexpr int CHUNK = 2048;  // rows of V / X per V^T X CTA
constexpr int UNROLL = 4;    // rows a thread has in flight in V^T X
constexpr int RPT = 4;       // rows a lane holds in U T
constexpr int MAX_KR = 1024; // k * R per launch

__host__ __device__ __forceinline__ int next_pow2(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// threads of a V^T X team: quads of k times column tiles, rounded up to a
// power of two (at most 128 for k * R <= 1024)
__host__ __device__ __forceinline__ int team_size(int k, int R, int rt) {
  return next_pow2(((k + 3) >> 2) * ((R + rt - 1) / rt));
}

// n values at p (0 beyond n): one 16-byte load when vec, else scalar
template <int N>
__device__ __forceinline__ void load_row(float (&d)[N], const float* p, int n, bool vec) {
  if constexpr (N % 4 == 0) {
    if (vec && n >= N) {
#pragma unroll
      for (int i = 0; i < N; i += 4) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(p + i));
        d[i] = t.x; d[i + 1] = t.y; d[i + 2] = t.z; d[i + 3] = t.w;
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = i < n ? __ldg(p + i) : 0.0f;
}

// ---- V^T X: partial sums of one chunk of rows, then T by the last CTA
template <int RT>
__global__ void __launch_bounds__(NT)
lowrank_vtx_kernel(const float* __restrict__ v, const float* __restrict__ x, long long x_bstride,
                   int ldx, const long long* __restrict__ cols, float* __restrict__ part,
                   unsigned* __restrict__ count, float* __restrict__ tmat, int n, int k, int R,
                   int splits, int vec_v, int vec_x) {
  extern __shared__ float s_red[];
  __shared__ bool s_last;
  const int b = blockIdx.y, s = blockIdx.x, tid = threadIdx.x;
  const int KQ = (k + 3) >> 2, RTN = (R + RT - 1) / RT;
  const int G = team_size(k, R, RT);
  const int e = tid & (G - 1), lanes = NT / G, lane_row = tid / G;
  const int kq = e % KQ, rt = e / KQ;
  const bool member = rt < RTN;
  const int k0 = kq * 4, r0 = rt * RT;
  const float* vb = v + (size_t)b * n * k + k0;
  const float* xb = x + (cols ? cols[b] * (long long)n * ldx : b * x_bstride) + r0;
  const int row_end = min(n, (s + 1) * CHUNK);
  const bool xv_vec = vec_x && r0 + RT <= R;

  float acc[4][RT];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int q = 0; q < RT; ++q) acc[a][q] = 0.0f;

  if (member) {
    // rows lane_row, lane_row + lanes, ... of the chunk, in ascending order
    for (int j = s * CHUNK + lane_row; j < row_end; j += lanes * UNROLL) {
      float va[UNROLL][4], xa[UNROLL][RT];
#pragma unroll
      for (int w = 0; w < UNROLL; ++w) {
        const int row = j + w * lanes;
        const bool ok = row < row_end;
        load_row<4>(va[w], vb + (size_t)row * k, ok ? k - k0 : 0, vec_v && ok);
        load_row<RT>(xa[w], xb + (size_t)row * ldx, ok ? R - r0 : 0, xv_vec && ok);
      }
#pragma unroll
      for (int w = 0; w < UNROLL; ++w)
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < RT; ++q) acc[a][q] = fmaf(va[w][a], xa[w][q], acc[a][q]);
    }
  }

  // fixed-order combination of the row lanes: xor shuffles inside a warp
  // (both lanes of a pair form the same sum), then the slots in order
  const int per = 4 * RT;
  int slot, nslots;
  bool writer;
  if (G < 32) {
    for (int off = G; off < 32; off <<= 1) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < RT; ++q)
          acc[a][q] += __shfl_xor_sync(0xffffffffu, acc[a][q], off);
    }
    slot = tid >> 5;
    nslots = NT / 32;
    writer = (tid & 31) < G;
  } else {
    slot = lane_row;
    nslots = lanes;
    writer = true;
  }
  if (writer) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < RT; ++q) s_red[(slot * G + e) * per + a * RT + q] = acc[a][q];
  }
  __syncthreads();
  const int KR = k * R;
  float* dst = splits == 1 ? tmat + (size_t)b * KR : part + ((size_t)b * splits + s) * KR;
  for (int idx = tid; idx < G * per; idx += NT) {
    const int te = idx / per, a = (idx % per) / RT, q = idx % RT;
    const int kk = (te % KQ) * 4 + a, r = (te / KQ) * RT + q;
    if (te / KQ >= RTN || kk >= k || r >= R) continue;
    float t = s_red[idx];
    for (int sl = 1; sl < nslots; ++sl) t += s_red[sl * G * per + idx];
    dst[kk * R + r] = t;
  }
  if (splits == 1) return;

  // the last CTA of block b sums the partials in split order
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(count + b, 1u) == (unsigned)(splits - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* pb = part + (size_t)b * splits * KR;
  for (int o = tid; o < KR; o += NT) {
    float t = __ldcg(pb + o);
    for (int sp = 1; sp < splits; ++sp) t += __ldcg(pb + (size_t)sp * KR + o);
    tmat[(size_t)b * KR + o] = t;
  }
}

// ---- U T: y = U T per block; the level entry sums its cluster's blocks
// in table order and adds the sum to z.  A team of TQ lanes (k's quads,
// rounded up to a power of two) takes one row and one column tile: lane e
// loads quad e of the row (neighbouring lanes, neighbouring 16 bytes) and
// holds T's rows 4e .. 4e + 3 of the tile; its partial products are
// reduced over the team by halving exchanges of shuffles, after which
// lane e keeps W of the tile's columns.
template <int RT, int TQ, bool LEVEL>
__global__ void __launch_bounds__(NT, 3)
lowrank_ut_kernel(const float* __restrict__ u, const float* __restrict__ tmat,
                  float* __restrict__ out, long long out_bstride, int ldo,
                  const long long* __restrict__ out_rows, const long long* __restrict__ offsets,
                  const long long* __restrict__ blocks, const long long* __restrict__ order,
                  int m, int k, int R, int vec_u) {
  constexpr int W = RT / TQ > 0 ? RT / TQ : 1;       // columns a lane keeps
  constexpr int HALVE = RT / W;                      // lanes that split the tile's columns
  const int tid = threadIdx.x, e = tid % TQ, team = tid / TQ;
  const int RTN = (R + RT - 1) / RT;
  const int rows_pass = NT / TQ / RTN;               // >= 2 for k * R <= 1024
  const int rt = team % RTN, rl = team / RTN;
  const bool active = rl < rows_pass;
  const int r0 = rt * RT, nr = min(RT, R - r0), k0 = e * 4;
  const long long c = LEVEL ? order[blockIdx.y] : blockIdx.y;
  const long long bi0 = LEVEL ? offsets[c] : c, bi1 = LEVEL ? offsets[c + 1] : c + 1;
  const int row0 = blockIdx.x * rows_pass * RPT + rl;
  const bool t_vec = RT % 4 == 0 && nr == RT && R % 4 == 0;
  // the columns lane e keeps: bit s of e picks the upper half at halving s
  int c0 = 0;
#pragma unroll
  for (int s = 0; (1 << s) < HALVE; ++s)
    if (e >> s & 1) c0 += RT >> (s + 1);

  float acc[RPT][W];
  for (long long bi = bi0; bi < bi1; ++bi) {
    const long long b = LEVEL ? blocks[bi] : bi;
    const float* ub = u + (size_t)b * m * k + k0;
    const float* tb = tmat + (size_t)b * k * R + r0;
    float t[4][RT];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      load_row<RT>(t[a], tb + (size_t)(k0 + a) * R, k0 + a < k ? nr : 0, t_vec);
    float ua[RPT][4];
#pragma unroll
    for (int p = 0; p < RPT; ++p) {
      const int row = row0 + p * rows_pass;
      const bool ok = active && row < m;
      load_row<4>(ua[p], ub + (size_t)row * k, ok ? k - k0 : 0, vec_u && ok);
    }
#pragma unroll
    for (int p = 0; p < RPT; ++p) {
      float v[RT];
#pragma unroll
      for (int q = 0; q < RT; ++q) v[q] = 0.0f;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < RT; ++q) v[q] = fmaf(ua[p][a], t[a][q], v[q]);
      // halving exchanges: at step s the lane pair at distance 2^s swaps the
      // half of its columns that the other keeps and adds; past the halvings
      // the pair adds its one column (both lanes form the same sum)
#pragma unroll
      for (int s = 0; (1 << s) < TQ; ++s) {
        const int half = (RT >> (s + 1)) > 0 ? RT >> (s + 1) : 0;
        if (half > 0) {
          const bool upper = e >> s & 1;
#pragma unroll
          for (int i = 0; i < (half > 0 ? half : 1); ++i) {
            const float send = upper ? v[i] : v[half + i];
            const float keep = upper ? v[half + i] : v[i];
            v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 1 << s);
          }
        } else {
          v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1 << s);
        }
      }
#pragma unroll
      for (int w = 0; w < W; ++w) acc[p][w] = bi == bi0 ? v[w] : __fadd_rn(acc[p][w], v[w]);
    }
  }
  if (bi1 <= bi0 || !active || (TQ > RT && e >= RT)) return;

#pragma unroll
  for (int p = 0; p < RPT; ++p) {
    const int row = row0 + p * rows_pass;
    if (row >= m) continue;
    float* o = LEVEL ? out + ((size_t)out_rows[c] * m + row) * ldo + r0 + c0
                     : out + c * out_bstride + (size_t)row * ldo + r0 + c0;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if (c0 + w >= nr) continue;
      // z is read and written here: plain loads, not the read-only path
      o[w] = LEVEL ? __fadd_rn(o[w], acc[p][w]) : acc[p][w];
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

struct Args {
  const float* u; const float* v;
  const float* x; long long x_bstride; int ldx; const long long* cols;
  float* out; long long out_bstride; int ldo;
  const long long* out_rows; const long long* offsets; const long long* blocks;
  const long long* order; int n_out;
  float* scratch; int B, m, n, k, R;
};

template <int RT, int TQ, bool LEVEL>
void launch_ut(const Args& a, const float* tmat, cudaStream_t s) {
  const int rows_cta = NT / TQ / ((a.R + RT - 1) / RT) * RPT;
  const int vec_u = a.k % 4 == 0 && aligned16(a.u);
  lowrank_ut_kernel<RT, TQ, LEVEL>
      <<<dim3((a.m + rows_cta - 1) / rows_cta, LEVEL ? a.n_out : a.B), NT, 0, s>>>(
          a.u, tmat, a.out, a.out_bstride, a.ldo, a.out_rows, a.offsets, a.blocks, a.order, a.m,
          a.k, a.R, vec_u);
}

template <int RT, bool LEVEL>
int launch(const Args& a, cudaStream_t s) {
  const int KR = a.k * a.R;
  const int splits = (a.n + CHUNK - 1) / CHUNK;
  float* tmat = a.scratch;
  float* part = tmat + (size_t)a.B * KR;
  unsigned* count = reinterpret_cast<unsigned*>(part + (size_t)a.B * splits * KR);
  if (a.n > 0) {
    if (splits > 1) {
      const int err = (int)cudaMemsetAsync(count, 0, sizeof(unsigned) * a.B, s);
      if (err) return err;
    }
    const int G = team_size(a.k, a.R, RT);
    const int nslots = G < 32 ? NT / 32 : NT / G;
    const size_t smem = sizeof(float) * nslots * G * 4 * RT;
    const int vec_v = a.k % 4 == 0 && aligned16(a.v);
    const int vec_x = RT % 4 == 0 && a.ldx % 4 == 0 && a.x_bstride % 4 == 0 && aligned16(a.x);
    lowrank_vtx_kernel<RT><<<dim3(splits, a.B), NT, smem, s>>>(
        a.v, a.x, a.x_bstride, a.ldx, a.cols, part, count, tmat, a.n, a.k, a.R, splits, vec_v,
        vec_x);
  } else {
    const int err = (int)cudaMemsetAsync(tmat, 0, sizeof(float) * (size_t)a.B * KR, s);
    if (err) return err;
  }
  const int tq = next_pow2((a.k + 3) >> 2);
  switch (tq) {
    case 1: launch_ut<RT, 1, LEVEL>(a, tmat, s); break;
    case 2: launch_ut<RT, 2, LEVEL>(a, tmat, s); break;
    case 4: launch_ut<RT, 4, LEVEL>(a, tmat, s); break;
    case 8: launch_ut<RT, 8, LEVEL>(a, tmat, s); break;
    default: launch_ut<RT, 16, LEVEL>(a, tmat, s); break;
  }
  return (int)cudaGetLastError();
}

template <bool LEVEL>
int run(const Args& a, void* stream) {
  if (a.B <= 0 || a.m <= 0 || a.R <= 0 || (LEVEL && a.n_out <= 0)) return (int)cudaSuccess;
  if (a.k <= 0 || a.k > 64 || a.k * a.R > MAX_KR || a.B > 65535 || a.n_out > 65535 ||
      a.n < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a.R == 1 ? launch<1, LEVEL>(a, s) : launch<8, LEVEL>(a, s);
}

}  // namespace

// Floats of scratch a call needs: T (B k R), the partials (B splits k R)
// and B counters.
extern "C" long long repro_lowrank_scratch_floats(int B, int n, int k, int R) {
  const long long splits = (n + CHUNK - 1) / CHUNK;
  return (long long)B * k * R * (1 + splits) + B;
}

// Gathered entry.  u: (B, m, k), v: (B, n, k) f32 contiguous; x: block b's
// row j at x + b * x_bstride + j * ldx (R floats); y likewise with
// y_bstride, ldy.  Requires 1 <= k <= 64, k * R <= 1024 and B <= 65535
// (cudaErrorInvalidValue otherwise).
extern "C" int repro_lowrank_matmat(const float* u, const float* v, const float* x,
                                    long long x_bstride, int ldx, float* y, long long y_bstride,
                                    int ldy, float* scratch, int B, int m, int n, int k, int R,
                                    void* stream) {
  const Args a{u, v, x, x_bstride, ldx, nullptr, y, y_bstride, ldy, nullptr, nullptr, nullptr,
               nullptr, 0, scratch, B, m, n, k, R};
  return run<false>(a, stream);
}

// Level entry: blocks of m x m rows.  Block b reads rows cols[b] * m ... of
// the panel x (row stride ldx, R columns); row cluster c = order[i] adds
// the sum of its blocks blocks[offsets[c] .. offsets[c + 1]) (in that
// order) to rows out_rows[c] * m ... of z (row stride ldz).  Ids are not
// checked here: the apply's block groups are checked when they are built.
extern "C" int repro_lowrank_matmat_level(const float* u, const float* v, const float* x, int ldx,
                                          const long long* cols, float* z, int ldz,
                                          const long long* out_rows, const long long* offsets,
                                          const long long* blocks, const long long* order,
                                          int n_out, float* scratch, int B, int m, int k, int R,
                                          void* stream) {
  const Args a{u, v, x, 0, ldx, cols, z, 0, ldz, out_rows, offsets, blocks, order, n_out,
               scratch, B, m, m, k, R};
  return run<true>(a, stream);
}
