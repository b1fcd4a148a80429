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
// (m + n)(3d + 2 + 2r) per step.  What held the first port back was not
// that traffic but U and V re-read from device memory at every step (about
// 16x the factors at k = 16, with one 4-byte write per 64-byte row line).
//
// Two routes, picked per level group by the wrapper
// (kernels/batched_aca/kernel.py: aca_route) from (m, n, k, d) and the
// card's shared memory per block; both give the same bits.
//
// (a) Resident (aca_resident_kernel): one thread-block cluster of cs CTAs
//     (cs = 1..8) owns a block and runs all k steps in one launch.  CTA q of
//     the cluster holds rows [q m_loc, (q + 1) m_loc) and columns
//     [q n_loc, (q + 1) n_loc): their points, read once, and their U and V
//     entries in shared memory in quads of steps ([s / 4][row][s % 4]), so
//     one 16-byte load gives a row four steps of its dot product and
//     consecutive rows stay conflict-free.  The residual column is kept in U's
//     slot r and scaled there in place.  The argmax goes warp shuffle (keys
//     only) -> CTA -> cluster: each CTA pushes its winner (key, value and
//     point) into every CTA's shared memory with st.async on that CTA's
//     mbarrier, so a step has no cluster barrier and no fence, and the
//     pivot's value u_hat[i_r] and point reach every CTA with its key.  The
//     pivot row's U entries and the pivot column's V entries are read from
//     the CTA that holds them (distributed shared memory).  Used pivots are
//     bits in the registers of the thread that holds them.  U and V are
//     written to device memory once at the end, each row's k floats as
//     16-byte stores, in the (B, m, k) layout.  Small blocks take cs = 1 and
//     several CTAs per SM, so that enough independent step chains are in
//     flight to hide each chain's 2k dependent reductions.
// (b) Streamed (aca_stream_*_kernel), for blocks whose factors exceed a
//     cluster's shared memory: a block is split over CTAs of SPT NT rows,
//     two launches per step.  The residual columns u_hat are kept raw in a
//     step-major (B, k, m) scratch and V step-major in a (B, k, n) scratch,
//     so step r's reads and writes are coalesced; U[i, s] = u_hat_s[i] /
//     alpha_s is formed when read (the same multiply as storing it, alpha_s
//     kept per step), and one last launch writes U and V in the (B, m, k)
//     layout.
//
// The argmax is the maximum of a 64-bit key, (order-preserving bits of the
// masked |value|, inverted index): a total order, so the pivot is the first
// index on ties and the same whatever order threads and CTAs reach it in.
// Every sum runs in a fixed order (each dot over s = 0 .. r-1 is one fmaf
// chain, as in the first port): results are bit-reproducible, equal across
// the two routes and equal to the first port's.  Blocks are addressed by
// cluster id into a point array, so a level group is factored without
// gathering its points.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "phi.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;          // threads per CTA (both routes)
constexpr int MAX_K = 64;
constexpr int MAX_CLUSTER = 8;   // the portable cluster size
constexpr int MAX_LOCAL = 64 * NT;  // rows (columns) of a resident CTA: 64 used-pivot bits a thread
constexpr int SPT = 4;          // rows (columns) per thread in the streamed passes
static_assert(SPT == 4, "the streamed passes load a thread's rows as one float4");

__device__ __forceinline__ unsigned long long pivot_key(float val, int idx) {
  const unsigned u = __float_as_uint(val);
  const unsigned ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)ord << 32) | (unsigned long long)(0xFFFFFFFFu - (unsigned)idx);
}

__device__ __forceinline__ int key_index(unsigned long long key) {
  return (int)(0xFFFFFFFFu - (unsigned)(key & 0xFFFFFFFFull));
}

// A cluster id outside [0, clusters) reads cluster 0 in its place (that
// block then gets NaN factors): no read outside the points.
__device__ __forceinline__ long long cluster_or_0(long long id, int clusters) {
  return (id >= 0 && id < clusters) ? id : 0;
}

// The stored U entry of a row whose raw residual is `raw` at a step with
// pivot value alpha (inv = 1 / alpha when safe).
__device__ __forceinline__ float u_entry(float raw, float inv, bool safe, bool valid) {
  return !valid ? CUDART_NAN_F : (safe ? raw * inv : 0.0f);
}

__device__ __forceinline__ void step_scale(float alpha, bool& safe, float& inv) {
  safe = fabsf(alpha) > 1e-30f;
  inv = safe ? 1.0f / alpha : 0.0f;
}

// ---------------------------------------------------------------------------
// (a) resident route
// ---------------------------------------------------------------------------

// A pivot candidate: its key, its value and its point, so that the winner's
// value (the step's alpha) and point reach every CTA with the key.  32
// bytes: two 16-byte pushes to another CTA.
struct __align__(16) Cand {
  unsigned long long key;
  float val;
  float pt[3];                // the first D coordinates are used
  float pad[2];
};

__device__ __forceinline__ Cand no_cand() {
  Cand c;
  c.key = 0ull;               // below every real candidate
  c.val = 0.0f;
  c.pt[0] = c.pt[1] = c.pt[2] = 0.0f;
  c.pad[0] = c.pad[1] = 0.0f;
  return c;
}

// The largest key over groups of `width` lanes (every lane of a group gets it).
__device__ __forceinline__ unsigned long long group_max_key(unsigned long long key, int width) {
  for (int off = width / 2; off > 0; off >>= 1) {
    const unsigned long long other = __shfl_xor_sync(0xffffffffu, key, off);
    key = other > key ? other : key;
  }
  return key;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar), "r"(parity) : "memory");
}

// Candidate c into the shared memory of cluster CTA `rank` at the local
// address dst (this CTA's layout), completing 32 bytes on its mbarrier bar:
// st.async needs no fence, the receiver's mbarrier wait makes the data visible.
__device__ __forceinline__ void push_cand(const Cand& c, unsigned dst, unsigned bar, int rank) {
  unsigned rdst, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rdst) : "r"(dst), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rbar) : "r"(bar), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(rdst), "r"((unsigned)c.key), "r"((unsigned)(c.key >> 32)),
      "r"(__float_as_uint(c.val)), "r"(__float_as_uint(c.pt[0])), "r"(rbar) : "memory");
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(rdst + 16), "r"(__float_as_uint(c.pt[1])), "r"(__float_as_uint(c.pt[2])),
      "r"(0u), "r"(0u), "r"(rbar) : "memory");
}

struct Reduce {
  Cand warp[NT / 32];
  Cand cta[2][MAX_CLUSTER];      // the cluster's CTA winners, pushed by each CTA
  Cand win;
  unsigned long long bar[2];     // one mbarrier per slot: cs pushes of 32 bytes
};

// Cluster-wide argmax of the threads' candidates: every thread of every CTA
// finds the winner in red.win.  Keys alone go through the shuffles; the
// lane holding a warp's winner stores its candidate; warp 0 picks the CTA's.
// With a cluster, each CTA pushes its winner into every CTA's shared memory
// (st.async on that CTA's mbarrier of this slot), and warp 0 of each CTA
// waits for the cs pushes and picks the winner.  `slot` alternates between
// the two reductions of a step (its mbarrier's phase is the step's parity),
// so a push never overwrites a candidate that a CTA may still read.
__device__ __forceinline__ void cluster_argmax(int cs, int rank, const Cand& c, int slot,
                                               int parity, Reduce& red) {
  const int lane = threadIdx.x & 31;
  const unsigned long long wmax = group_max_key(c.key, 32);
  if (c.key == wmax && (wmax != 0ull || lane == 0)) red.warp[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x < 32) {
    const unsigned long long wk = lane < NT / 32 ? red.warp[lane].key : 0ull;
    const unsigned long long cmax = group_max_key(wk, NT / 32);
    const int src = __ffs(__ballot_sync(0xffffffffu, lane < NT / 32 && wk == cmax)) - 1;
    if (cs == 1) {
      if (lane == 0) red.win = red.warp[src];
    } else {
      const unsigned bar = smem_u32(&red.bar[slot]);
      if (lane == 0) mbar_arrive_expect_tx(bar, 32u * cs);
      if (lane < cs) push_cand(red.warp[src], smem_u32(&red.cta[slot][rank]), bar, lane);
      mbar_wait(bar, parity);
      const unsigned long long ck = lane < cs ? red.cta[slot][lane].key : 0ull;
      const unsigned long long kmax = group_max_key(ck, MAX_CLUSTER);
      const int win = __ffs(__ballot_sync(0xffffffffu, lane < cs && ck == kmax)) - 1;
      if (lane == 0) red.win = red.cta[slot][win];
    }
  }
  __syncthreads();
}

// Steps of U and V held per row, k rounded up to whole quads.
__host__ __device__ constexpr int k_quads(int k) { return (k + 3) / 4; }

// Dynamic shared memory of one resident CTA: U, V entries and the points of
// m_loc rows and n_loc columns.
__host__ __device__ constexpr long long resident_smem(int m_loc, int n_loc, int k, int d) {
  return 4ll * (4 * k_quads(k) + d) * ((long long)m_loc + n_loc);
}

// Element (step s, local row i) of a resident U or V slice of `rows` rows:
// quads of steps, [s / 4][i][s % 4], so one 16-byte load gives a row four
// steps and consecutive rows stay conflict-free.
__device__ __forceinline__ int qidx(int s, int i, int rows) {
  return ((s >> 2) * rows + i) * 4 + (s & 3);
}

// dot = fmaf chain of a[i][s] * w[s] over s = 0 .. r-1, in order, for two
// rows i0, i1 of a quad-interleaved slice; w is 16-byte aligned.
__device__ __forceinline__ void dot2(const float* a, const float* w, int r, int i0, int i1,
                                     int rows, float& d0, float& d1) {
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* w4 = reinterpret_cast<const float4*>(w);
  for (int q = 0; 4 * q < r; ++q) {
    const float4 x = a4[q * rows + i0], y = a4[q * rows + i1], c = w4[q];
    const int left = r - 4 * q;
    d0 = fmaf(x.x, c.x, d0);
    d1 = fmaf(y.x, c.x, d1);
    if (left > 1) {
      d0 = fmaf(x.y, c.y, d0);
      d1 = fmaf(y.y, c.y, d1);
    }
    if (left > 2) {
      d0 = fmaf(x.z, c.z, d0);
      d1 = fmaf(y.z, c.z, d1);
    }
    if (left > 3) {
      d0 = fmaf(x.w, c.w, d0);
      d1 = fmaf(y.w, c.w, d1);
    }
  }
}

// Marks index `idx` in the used-pivot bits of the thread that holds it
// (bit t: the thread's t-th row or column, local index tid + t NT).
__device__ __forceinline__ void mark_used(unsigned long long& bits, int idx, int first,
                                          int count) {
  const int local = idx - first;
  if (local >= 0 && local < count && local % NT == (int)threadIdx.x) {
    bits |= 1ull << (local / NT);
  }
}

template <int D, int K>
__global__ void __launch_bounds__(NT)
aca_resident_kernel(const float* __restrict__ rpts, const long long* __restrict__ rids,
                    const float* __restrict__ cpts, const long long* __restrict__ cids,
                    float* __restrict__ u, float* __restrict__ v, unsigned long long* row_keys,
                    unsigned long long* col_keys, int B, int m, int n, int r_clusters,
                    int c_clusters, int k, int m_loc, int n_loc, float matern_norm) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Reduce red;
  __shared__ __align__(16) float s_vec[MAX_K];

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / cs;
  const int tid = threadIdx.x;

  const bool valid = cluster_or_0(rids[b], r_clusters) == rids[b] &&
                     cluster_or_0(cids[b], c_clusters) == cids[b];
  const float* rp = rpts + (size_t)cluster_or_0(rids[b], r_clusters) * m * D;
  const float* cp = cpts + (size_t)cluster_or_0(cids[b], c_clusters) * n * D;
  const int i0 = rank * m_loc, mh = max(0, min(m_loc, m - i0));
  const int c0 = rank * n_loc, nh = max(0, min(n_loc, n - c0));

  const int kq = 4 * k_quads(k);
  float* us = smem;                        // U of this CTA's rows, quads (qidx)
  float* vs = us + (size_t)kq * m_loc;     // V of this CTA's columns, quads
  float* rps = vs + (size_t)kq * n_loc;    // [m_loc][D]
  float* cps = rps + (size_t)m_loc * D;    // [n_loc][D]
  for (int t = tid; t < mh * D; t += NT) rps[t] = rp[(size_t)i0 * D + t];
  for (int t = tid; t < nh * D; t += NT) cps[t] = cp[(size_t)c0 * D + t];
  // used pivots of this thread's rows and columns; column 0 is step 0's pivot
  unsigned long long used_rows = 0ull, used_cols = 0ull;
  mark_used(used_cols, 0, c0, nh);
  int j = 0;                               // step r's pivot column and its point
  float jpt[D];
#pragma unroll
  for (int dim = 0; dim < D; ++dim) jpt[dim] = cp[dim];
  if (cs > 1) {
    if (tid == 0) {
      mbar_init(smem_u32(&red.bar[0]), 1);
      mbar_init(smem_u32(&red.bar[1]), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cluster.sync();                        // the mbarriers exist before any push
  } else {
    __syncthreads();
  }

  for (int r = 0; r < k; ++r) {
    // ---- column pass: u_hat = phi(rows, col j) - U V[j], kept in U's slot r
    if (tid < r) {
      const int owner = j / n_loc;
      const float* src = cs == 1 ? vs : cluster.map_shared_rank(vs, owner);
      s_vec[tid] = src[qidx(tid, j - owner * n_loc, n_loc)];
    }
    __syncthreads();
    Cand best = no_cand();
    // two rows a thread at a time: two independent dot chains in flight
    for (int il = tid, t = 0; il < mh; il += 2 * NT, t += 2) {
      const int il2 = il + NT < mh ? il + NT : il;
      float p[2][D];
#pragma unroll
      for (int dim = 0; dim < D; ++dim) {
        p[0][dim] = rps[il * D + dim];
        p[1][dim] = rps[il2 * D + dim];
      }
      float dot0 = 0.0f, dot1 = 0.0f;
      dot2(us, s_vec, r, il, il2, m_loc, dot0, dot1);
      const float dots[2] = {dot0, dot1};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h == 1 && il2 == il) break;
        const int row = h == 0 ? il : il2;
        const float a = repro::phi_from_sqdist<K>(repro::sqdist_direct<D>(p[h], jpt),
                                                  matern_norm);
        const float val = a - dots[h];
        us[qidx(r, row, m_loc)] = val;
        const bool used = (used_rows >> (t + h)) & 1ull;
        const unsigned long long kk = pivot_key(used ? -1.0f : fabsf(val), i0 + row);
        if (kk > best.key) {
          best.key = kk;
          best.val = val;
#pragma unroll
          for (int dim = 0; dim < D; ++dim) best.pt[dim] = p[h][dim];
        }
      }
    }
    cluster_argmax(cs, rank, best, 0, r & 1, red);
    const int ip = key_index(red.win.key);
    bool safe;
    float inv;
    step_scale(red.win.val, safe, inv);
    float ipt[D];
#pragma unroll
    for (int dim = 0; dim < D; ++dim) ipt[dim] = red.win.pt[dim];
    if (rank == 0 && tid == 0) row_keys[(size_t)r * B + b] = red.win.key;
    mark_used(used_rows, ip, i0, mh);

    // ---- row pass: U[:, r] scaled in place, V[:, r] = phi(row ip, cols) - V U[ip]
    if (tid < r) {
      const int owner = ip / m_loc;
      const float* src = cs == 1 ? us : cluster.map_shared_rank(us, owner);
      s_vec[tid] = src[qidx(tid, ip - owner * m_loc, m_loc)];
    }
    __syncthreads();
    for (int il = tid; il < mh; il += NT) {
      float* ur = us + qidx(r, il, m_loc);
      *ur = u_entry(*ur, inv, safe, valid);
    }
    best = no_cand();
    for (int cl = tid, t = 0; cl < nh; cl += 2 * NT, t += 2) {
      const int cl2 = cl + NT < nh ? cl + NT : cl;
      float q[2][D];
#pragma unroll
      for (int dim = 0; dim < D; ++dim) {
        q[0][dim] = cps[cl * D + dim];
        q[1][dim] = cps[cl2 * D + dim];
      }
      float dot0 = 0.0f, dot1 = 0.0f;
      dot2(vs, s_vec, r, cl, cl2, n_loc, dot0, dot1);
      const float dots[2] = {dot0, dot1};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h == 1 && cl2 == cl) break;
        const int col = h == 0 ? cl : cl2;
        const float a = repro::phi_from_sqdist<K>(repro::sqdist_direct<D>(ipt, q[h]),
                                                  matern_norm);
        const float val = safe ? a - dots[h] : 0.0f;
        vs[qidx(r, col, n_loc)] = valid ? val : CUDART_NAN_F;
        const bool used = (used_cols >> (t + h)) & 1ull;
        const unsigned long long kk = pivot_key(used ? -1.0f : fabsf(val), c0 + col);
        if (kk > best.key) {
          best.key = kk;
#pragma unroll
          for (int dim = 0; dim < D; ++dim) best.pt[dim] = q[h][dim];
        }
      }
    }
    cluster_argmax(cs, rank, best, 1, r & 1, red);
    j = key_index(red.win.key);
#pragma unroll
    for (int dim = 0; dim < D; ++dim) jpt[dim] = red.win.pt[dim];
    if (rank == 0 && tid == 0) col_keys[(size_t)r * B + b] = red.win.key;
    mark_used(used_cols, j, c0, nh);
  }

  // U and V once, in the (B, m, k) layout, each row's k floats together
  const bool vec4 = (k & 3) == 0;
  for (int il = tid; il < mh; il += NT) {
    float* dst = u + ((size_t)b * m + i0 + il) * k;
    if (vec4) {
      for (int q = 0; q < k / 4; ++q) {
        reinterpret_cast<float4*>(dst)[q] = reinterpret_cast<const float4*>(us)[q * m_loc + il];
      }
    } else {
      for (int s = 0; s < k; ++s) dst[s] = us[qidx(s, il, m_loc)];
    }
  }
  for (int cl = tid; cl < nh; cl += NT) {
    float* dst = v + ((size_t)b * n + c0 + cl) * k;
    if (vec4) {
      for (int q = 0; q < k / 4; ++q) {
        reinterpret_cast<float4*>(dst)[q] = reinterpret_cast<const float4*>(vs)[q * n_loc + cl];
      }
    } else {
      for (int s = 0; s < k; ++s) dst[s] = vs[qidx(s, cl, n_loc)];
    }
  }
  // no CTA leaves while another may still read its shared memory
  if (cs > 1) cluster.sync();
}

// ---------------------------------------------------------------------------
// (b) streamed route
// ---------------------------------------------------------------------------

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

// Column pass of step r: raw u_hat for SPT NT rows of one block, and their
// pivot key.  alphas[b k + s] holds step s's pivot value (s < r).
template <int D, int K>
__global__ void __launch_bounds__(NT)
aca_stream_column_kernel(const float* __restrict__ rpts, const long long* __restrict__ rids,
                         const float* __restrict__ cpts, const long long* __restrict__ cids,
                         float* ut, const float* __restrict__ vt,
                         const float* __restrict__ alphas, unsigned long long* row_keys,
                         const unsigned long long* col_keys, int B, int m, int n,
                         int r_clusters, int c_clusters, int k, int r, float matern_norm) {
  __shared__ float s_vj[MAX_K];
  __shared__ float s_inv[MAX_K];
  __shared__ int s_safe[MAX_K];
  __shared__ int s_used[MAX_K];
  __shared__ float s_q[D];
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const bool valid = cluster_or_0(rids[b], r_clusters) == rids[b] &&
                     cluster_or_0(cids[b], c_clusters) == cids[b];
  const float* rp = rpts + (size_t)cluster_or_0(rids[b], r_clusters) * m * D;
  const float* cp = cpts + (size_t)cluster_or_0(cids[b], c_clusters) * n * D;
  const float* ub = ut + (size_t)b * k * m;
  const int j = (r == 0) ? 0 : key_index(col_keys[(size_t)(r - 1) * B + b]);
  if (tid < r) {
    s_vj[tid] = vt[((size_t)b * k + tid) * n + j];
    s_used[tid] = key_index(row_keys[(size_t)tid * B + b]);
    bool safe;
    float inv;
    step_scale(alphas[(size_t)b * k + tid], safe, inv);
    s_safe[tid] = safe;
    s_inv[tid] = inv;
  }
  if (tid < D) s_q[tid] = cp[(size_t)j * D + tid];
  __syncthreads();

  // SPT consecutive rows a thread (one 16-byte load a step when m % 4 ==
  // 0), their dot chains interleaved
  const int row0 = (blockIdx.x * NT + tid) * SPT;
  const bool quad = (m & 3) == 0 && row0 + SPT <= m;
  int rows[SPT];
  float dot[SPT];
#pragma unroll
  for (int t = 0; t < SPT; ++t) {
    rows[t] = row0 + t;
    dot[t] = 0.0f;
  }
#pragma unroll 2
  for (int s = 0; s < r; ++s) {
    const float vj = s_vj[s], inv = s_inv[s];
    const bool safe = s_safe[s];
    const float* us_ = ub + (size_t)s * m;
    float raw[SPT];
    if (quad) {
      const float4 w = *reinterpret_cast<const float4*>(us_ + row0);
      raw[0] = w.x, raw[1] = w.y, raw[2] = w.z, raw[3] = w.w;
    } else {
#pragma unroll
      for (int t = 0; t < SPT; ++t) raw[t] = rows[t] < m ? us_[rows[t]] : 0.0f;
    }
#pragma unroll
    for (int t = 0; t < SPT; ++t) dot[t] = fmaf(u_entry(raw[t], inv, safe, valid), vj, dot[t]);
  }
  unsigned long long key = 0ull;    // below every real candidate
#pragma unroll
  for (int t = 0; t < SPT; ++t) {
    const int i = rows[t];
    if (i < m) {
      float p[D];
#pragma unroll
      for (int dim = 0; dim < D; ++dim) p[dim] = rp[(size_t)i * D + dim];
      const float a = repro::phi_from_sqdist<K>(repro::sqdist_direct<D>(p, s_q), matern_norm);
      const float val = a - dot[t];
      ut[((size_t)b * k + r) * m + i] = val;
      bool used = false;
      for (int s = 0; s < r; ++s) used |= (s_used[s] == i);
      const unsigned long long kk = pivot_key(used ? -1.0f : fabsf(val), i);
      key = kk > key ? kk : key;
    }
  }
  fold_key(key, &row_keys[(size_t)r * B + b]);
}

// Row pass of step r: V[:, r] for SPT NT columns of one block, and the key
// of the next column pivot; records step r's pivot value in alphas.
template <int D, int K>
__global__ void __launch_bounds__(NT)
aca_stream_row_kernel(const float* __restrict__ rpts, const long long* __restrict__ rids,
                      const float* __restrict__ cpts, const long long* __restrict__ cids,
                      const float* __restrict__ ut, float* vt, float* alphas,
                      const unsigned long long* row_keys, unsigned long long* col_keys, int B,
                      int m, int n, int r_clusters, int c_clusters, int k, int r,
                      float matern_norm) {
  __shared__ float s_ui[MAX_K];
  __shared__ int s_used[MAX_K + 1];
  __shared__ float s_p[D];
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const bool valid = cluster_or_0(rids[b], r_clusters) == rids[b] &&
                     cluster_or_0(cids[b], c_clusters) == cids[b];
  const float* rp = rpts + (size_t)cluster_or_0(rids[b], r_clusters) * m * D;
  const float* cp = cpts + (size_t)cluster_or_0(cids[b], c_clusters) * n * D;
  const float* ub = ut + (size_t)b * k * m;
  const int ip = key_index(row_keys[(size_t)r * B + b]);
  const float alpha = ub[(size_t)r * m + ip];
  bool safe;
  float inv;
  step_scale(alpha, safe, inv);
  if (blockIdx.x == 0 && tid == 0) alphas[(size_t)b * k + r] = alpha;
  if (tid < r) {
    bool safe_s;
    float inv_s;
    step_scale(alphas[(size_t)b * k + tid], safe_s, inv_s);
    s_ui[tid] = u_entry(ub[(size_t)tid * m + ip], inv_s, safe_s, valid);
  }
  if (tid <= r) s_used[tid] = (tid == 0) ? 0 : key_index(col_keys[(size_t)(tid - 1) * B + b]);
  if (tid < D) s_p[tid] = rp[(size_t)ip * D + tid];
  __syncthreads();

  // SPT consecutive columns a thread (one 16-byte load a step when n % 4
  // == 0), their dot chains interleaved
  const int col0 = (blockIdx.x * NT + tid) * SPT;
  const bool quad = (n & 3) == 0 && col0 + SPT <= n;
  int cols[SPT];
  float dot[SPT];
#pragma unroll
  for (int t = 0; t < SPT; ++t) {
    cols[t] = col0 + t;
    dot[t] = 0.0f;
  }
#pragma unroll 2
  for (int s = 0; s < r; ++s) {
    const float ui = s_ui[s];
    const float* vs_ = vt + ((size_t)b * k + s) * n;
    float vv[SPT];
    if (quad) {
      const float4 w = *reinterpret_cast<const float4*>(vs_ + col0);
      vv[0] = w.x, vv[1] = w.y, vv[2] = w.z, vv[3] = w.w;
    } else {
#pragma unroll
      for (int t = 0; t < SPT; ++t) vv[t] = cols[t] < n ? vs_[cols[t]] : 0.0f;
    }
#pragma unroll
    for (int t = 0; t < SPT; ++t) dot[t] = fmaf(vv[t], ui, dot[t]);
  }
  unsigned long long key = 0ull;
#pragma unroll
  for (int t = 0; t < SPT; ++t) {
    const int idx = cols[t];
    if (idx < n) {
      float q[D];
#pragma unroll
      for (int dim = 0; dim < D; ++dim) q[dim] = cp[(size_t)idx * D + dim];
      const float a = repro::phi_from_sqdist<K>(repro::sqdist_direct<D>(s_p, q), matern_norm);
      const float val = safe ? a - dot[t] : 0.0f;
      vt[((size_t)b * k + r) * n + idx] = valid ? val : CUDART_NAN_F;
      bool used = false;
      for (int s = 0; s <= r; ++s) used |= (s_used[s] == idx);
      const unsigned long long kk = pivot_key(used ? -1.0f : fabsf(val), idx);
      key = kk > key ? kk : key;
    }
  }
  fold_key(key, &col_keys[(size_t)r * B + b]);
}

// U and V in the (B, m, k) layout from the step-major scratch, once.
__global__ void __launch_bounds__(NT)
aca_stream_write_kernel(const long long* __restrict__ rids, const long long* __restrict__ cids,
                        const float* __restrict__ ut, const float* __restrict__ vt,
                        const float* __restrict__ alphas, float* __restrict__ u,
                        float* __restrict__ v, int B, int m, int n, int r_clusters,
                        int c_clusters, int k) {
  __shared__ float s_inv[MAX_K];
  __shared__ int s_safe[MAX_K];
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const bool valid = cluster_or_0(rids[b], r_clusters) == rids[b] &&
                     cluster_or_0(cids[b], c_clusters) == cids[b];
  const float* ub = ut + (size_t)b * k * m;
  const float* vb = vt + (size_t)b * k * n;
  if (tid < k) {
    bool safe;
    float inv;
    step_scale(alphas[(size_t)b * k + tid], safe, inv);
    s_safe[tid] = safe;
    s_inv[tid] = inv;
  }
  __syncthreads();
  const int idx = blockIdx.x * NT + tid;
  const bool vec4 = (k & 3) == 0;
  if (idx < m) {
    float* dst = u + ((size_t)b * m + idx) * k;
    if (vec4) {
      for (int s = 0; s < k; s += 4) {
        float w[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          w[t] = u_entry(ub[(size_t)(s + t) * m + idx], s_inv[s + t], s_safe[s + t], valid);
        }
        reinterpret_cast<float4*>(dst)[s >> 2] = make_float4(w[0], w[1], w[2], w[3]);
      }
    } else {
      for (int s = 0; s < k; ++s) {
        dst[s] = u_entry(ub[(size_t)s * m + idx], s_inv[s], s_safe[s], valid);
      }
    }
  }
  if (idx < n) {
    float* dst = v + ((size_t)b * n + idx) * k;
    if (vec4) {
      for (int s = 0; s < k; s += 4) {
        reinterpret_cast<float4*>(dst)[s >> 2] =
            make_float4(vb[(size_t)s * n + idx], vb[(size_t)(s + 1) * n + idx],
                        vb[(size_t)(s + 2) * n + idx], vb[(size_t)(s + 3) * n + idx]);
      }
    } else {
      for (int s = 0; s < k; ++s) dst[s] = vb[(size_t)s * n + idx];
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Args {
  const float* rpts;
  const long long* rids;
  const float* cpts;
  const long long* cids;
  float* u;
  float* v;
  float* scratch;
  unsigned long long* row_keys;
  unsigned long long* col_keys;
  int B, m, n, r_clusters, c_clusters, k;
  float matern_norm;
};

template <int D, int K>
int launch_streamed(const Args& a, cudaStream_t s) {
  float* ut = a.scratch;                                // (B, k, m)
  float* vt = ut + (size_t)a.B * a.k * a.m;             // (B, k, n)
  float* alphas = vt + (size_t)a.B * a.k * a.n;         // (B, k)
  const dim3 grid_col((a.m + NT * SPT - 1) / (NT * SPT), a.B);
  const dim3 grid_row((a.n + NT * SPT - 1) / (NT * SPT), a.B);
  for (int r = 0; r < a.k; ++r) {
    aca_stream_column_kernel<D, K><<<grid_col, NT, 0, s>>>(
        a.rpts, a.rids, a.cpts, a.cids, ut, vt, alphas, a.row_keys, a.col_keys, a.B, a.m, a.n,
        a.r_clusters, a.c_clusters, a.k, r, a.matern_norm);
    aca_stream_row_kernel<D, K><<<grid_row, NT, 0, s>>>(
        a.rpts, a.rids, a.cpts, a.cids, ut, vt, alphas, a.row_keys, a.col_keys, a.B, a.m, a.n,
        a.r_clusters, a.c_clusters, a.k, r, a.matern_norm);
  }
  const dim3 grid_out(((a.m > a.n ? a.m : a.n) + NT - 1) / NT, a.B);
  aca_stream_write_kernel<<<grid_out, NT, 0, s>>>(a.rids, a.cids, ut, vt, alphas, a.u, a.v,
                                                  a.B, a.m, a.n, a.r_clusters, a.c_clusters,
                                                  a.k);
  return (int)cudaGetLastError();
}

template <int D, int K>
int launch_resident(const Args& a, int cs, cudaStream_t s) {
  const int m_loc = (a.m + cs - 1) / cs, n_loc = (a.n + cs - 1) / cs;
  if (m_loc > MAX_LOCAL || n_loc > MAX_LOCAL) return (int)cudaErrorInvalidValue;
  const long long smem = resident_smem(m_loc, n_loc, a.k, D);
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  // the cap on dynamic shared memory, raised once per device (bit = device)
  // to what the card allows beside the kernel's static shared memory
  static unsigned long long raised = 0;
  static int cap[64];
  if (!(raised >> (dev & 63) & 1)) {
    int optin = 0;
    err = (int)cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err) return err;
    cudaFuncAttributes attr;
    err = (int)cudaFuncGetAttributes(&attr, aca_resident_kernel<D, K>);
    if (err) return err;
    const int dyn = optin - (int)attr.sharedSizeBytes;
    err = (int)cudaFuncSetAttribute(aca_resident_kernel<D, K>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (err) return err;
    cap[dev & 63] = dyn;
    raised |= 1ull << (dev & 63);
  }
  if (smem > cap[dev & 63]) return (int)cudaErrorInvalidValue;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)a.B * cs);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = cs;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, aca_resident_kernel<D, K>, a.rpts, a.rids, a.cpts,
                                a.cids, a.u, a.v, a.row_keys, a.col_keys, a.B, a.m, a.n,
                                a.r_clusters, a.c_clusters, a.k, m_loc, n_loc, a.matern_norm);
  if (err) return err;
  return (int)cudaGetLastError();
}

template <int D, int K>
int run_route(const Args& a, int cs, cudaStream_t s) {
  return cs == 0 ? launch_streamed<D, K>(a, s) : launch_resident<D, K>(a, cs, s);
}

template <int D>
int run_kernel(int kernel_id, const Args& a, int cs, cudaStream_t s) {
  if (kernel_id == repro::KERNEL_GAUSSIAN) return run_route<D, repro::KERNEL_GAUSSIAN>(a, cs, s);
  return run_route<D, repro::KERNEL_MATERN>(a, cs, s);
}

}  // namespace

// Dynamic shared memory of one CTA of the resident route on an (m, n) block
// split over a cluster of cs CTAs, bytes (the wrapper's route picker
// mirrors it).
extern "C" long long repro_aca_resident_smem(int m, int n, int k, int d, int cs) {
  if (cs < 1 || cs > MAX_CLUSTER) return -1;
  return resident_smem((m + cs - 1) / cs, (n + cs - 1) / cs, k, d);
}

// The shared memory a block of CUDA device `dev` may opt in to, bytes.
extern "C" int repro_aca_smem_optin(int dev) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) return -1;
  return optin;
}

// Block b has rows rpts[rids[b] * m : (rids[b] + 1) * m] and columns
// cpts[cids[b] * n : (cids[b] + 1) * n] (points of d floats, contiguous;
// rpts holds r_clusters clusters of m points, cpts c_clusters of n).  A
// block whose id lies outside its array gets NaN factors.
// u: (B, m, k), v: (B, n, k) f32 outputs; keys: 2 * k * B uint64, ZEROED
// by the caller (row pivot keys, then column pivot keys, step-major); they
// hold the pivots afterwards.  cluster: 0 takes the streamed route, whose
// scratch is B * k * (m + n + 1) f32; 1..8 the resident route on clusters
// of that many CTAs (scratch unused, may be null).  Requires 1 <= k <= 64,
// d in {1, 2, 3}, B <= 65535, m, n, r_clusters, c_clusters >= 1 and, for
// the resident route, at most 16384 rows and columns a CTA and the CTA's
// shared memory within the card's (cudaErrorInvalidValue otherwise).
// Returns the first launch error.
extern "C" int repro_batched_aca(const float* rpts, const long long* rids, const float* cpts,
                                 const long long* cids, float* u, float* v, float* scratch,
                                 unsigned long long* keys, int B, int m, int n, int r_clusters,
                                 int c_clusters, int d, int k, int kernel_id, float matern_norm,
                                 int cluster, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (B < 0 || B > 65535 || m <= 0 || n <= 0 || k <= 0 || k > MAX_K || r_clusters <= 0 ||
      c_clusters <= 0 || cluster < 0 || cluster > MAX_CLUSTER) {
    return (int)cudaErrorInvalidValue;
  }
  if (kernel_id != repro::KERNEL_GAUSSIAN && kernel_id != repro::KERNEL_MATERN) {
    return (int)cudaErrorInvalidValue;
  }
  if (cluster == 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const Args a{rpts, rids, cpts, cids, u, v, scratch, keys, keys + (size_t)k * B,
               B, m, n, r_clusters, c_clusters, k, matern_norm};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return run_kernel<1>(kernel_id, a, cluster, s);
    case 2: return run_kernel<2>(kernel_id, a, cluster, s);
    case 3: return run_kernel<3>(kernel_id, a, cluster, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
