// Backward of the H-attention near field (#11b): from the cotangents gnum,
// gden and gm of the near field's (num, den, m), the gradients dq, dk and dv
// of its operands, for every leaf i's two inadmissible blocks (i, i)
// [causal] and (i, i-1) [full, absent for leaf 0].  Per row r and visible
// key j, with s = q k^T (q pre-scaled) and p_rj = exp(s_rj - m_r):
//
//   dm_r  = gm_r - (gnum_r . num_r + gden_r den_r)       (num = sum p v, den = sum p)
//   ds_rj = p_rj (gnum_r . v_j + gden_r) + [s_rj = m_r] c_r(block of j)
//   dq_r  = sum_j ds_rj k_j,  dk_j = sum_r ds_rj q_r,  dv_j = sum_r p_rj gnum_r
//
// The arg-max term is the derivative of m = max(max_j s_diag, max_j s_prev)
// as JAX takes it, which the reference's jax.grad goes through (m also
// feeds the far field's ACA): a block's max gets the whole cotangent, or
// half of it where both blocks' maxima are equal, split evenly among the
// entries that attain it: c_r = dm_r w_block / ties_block.
//
// Replaces no TPU kernel: repro's h_attention computes the near field with
// einsums (repro/core/hattention.py:178-194), which jax.grad differentiates.
// The port sends the near field of CUDA tensors to kernel #11
// (hattention_nearfield.cu), so its gradient needs this kernel.
//
// Bound on the H100: operations.  A visible (row, key) pair needs five
// products of length D (s, gnum . v, and the three sums), 10 D flops; at
// the training shape (40, 8, 512, 128) that is 147 GFLOP against ~0.9 GB.
// fp32 with no TF32.
//
// Design (simple first; no tensor cores).  Three launches, no atomics, every
// output written once by one thread, sums in a fixed order:
//  1. dq: a CTA of 8 warps owns 64 rows of one (bh, leaf), a warp 8 of
//     them.  It walks the 64-key tiles of leaf i-1, then those of leaf i up
//     to its diagonal, through a double-buffered cp.async ring (one barrier
//     a tile), as #11 does.  Lane (r, c) holds 2 rows x 8 keys of s and of
//     gnum . v, and 2 x D/8 of dq; ds reaches the lanes of its row by
//     shuffles.  The scores are recomputed in #11's order (one fma chain
//     over d ascending), so s == m finds the row's max bit for bit.  The
//     tie term is taken with weight dm for every entry that attains the
//     max (exact where one entry does); the lanes count the ties per block,
//     and the CTA writes dq, the per-row coefficients c_r of both blocks,
//     dm and the tie count.
//  2. fix: a warp per row with more than one tie (rare: one exits at once
//     otherwise) recomputes that row's scores, and adds (c_r - dm) k_j for
//     each tied key, in key order.
//  3. dk, dv: a CTA owns 64 keys of one (bh, leaf) (resident in shared
//     memory), a warp 8 of them, and walks the 64-row tiles that see them:
//     the causal rows of leaf i, then every row of leaf i+1, through the
//     same ring.  Lane (k, c) holds 2 keys x 8 rows, and 2 x D/8 of dk and
//     of dv.
// Shared memory at D = 128: six 64 x 132 float tiles (202,752 B; the dk
// pass adds 1,536 B of per-row scalars): one CTA of 256 threads per SM.
#include <cuda_runtime.h>

namespace {

constexpr int TT = 64;   // rows or keys per tile
constexpr int NT = 256;  // 8 warps
constexpr float NEG = -1e30f;

template <int D>
struct Layout {
  static constexpr int LD = D + 4;             // row stride of every tile (conflict-free float4 reads)
  static constexpr int T = TT * LD;            // floats of one tile
  static constexpr int VW = D >= 32 ? 4 : 2;   // columns per contiguous run
  static constexpr int NE = D / 8 / VW;        // runs per lane
  static constexpr int PER = NE * VW;          // columns per lane (D / 8)
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;     // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// TT x D floats, contiguous at src, into dst at row stride LD; rows past
// `valid` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int valid) {
  constexpr int V4 = D / 4;
  for (int t = threadIdx.x; t < TT * V4; t += NT) {
    const int r = t / V4, c4 = t - (t / V4) * V4;
    const bool ok = r < valid;
    cp_async16(dst + r * Layout<D>::LD + c4 * 4, ok ? src + (size_t)r * D + c4 * 4 : src, ok);
  }
}

// a . b over D in ascending order, one fma chain: #11's order for the scores
template <int D>
__device__ __forceinline__ void dot_2x8(const float* A, const float* B, int a0, int b0,
                                        float out[2][8]) {
  constexpr int LD = Layout<D>::LD;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) out[i][j] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[2], b[8];
#pragma unroll
    for (int i = 0; i < 2; ++i) a[i] = *reinterpret_cast<const float4*>(A + (a0 + 4 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = *reinterpret_cast<const float4*>(B + (b0 + 8 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        out[i][j] = fmaf(a[i].x, b[j].x, out[i][j]);
        out[i][j] = fmaf(a[i].y, b[j].y, out[i][j]);
        out[i][j] = fmaf(a[i].z, b[j].z, out[i][j]);
        out[i][j] = fmaf(a[i].w, b[j].w, out[i][j]);
      }
  }
}

// acc[i][.] += sum over the tile's 64 entries e of w[i][e] * X[e][lane's columns],
// where w[i][8 j + o] sits in slot j of lane (lane's group, o)
template <int D>
__device__ __forceinline__ void accumulate(float acc[2][Layout<D>::PER], const float w[2][8],
                                           const float* X, int lane) {
  using L = Layout<D>;
  constexpr int VW = L::VW, NE = L::NE;
  const int lc = lane & 7;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      float pv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) pv[i] = __shfl_sync(0xffffffffu, w[i][j], (lane & ~7) | o);
      const float* xrow = X + (8 * j + o) * L::LD + VW * lc;
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        float xv[VW];
        if constexpr (VW == 4) {
          const float4 x = *reinterpret_cast<const float4*>(xrow + 8 * VW * e);
          xv[0] = x.x; xv[1] = x.y; xv[2] = x.z; xv[3] = x.w;
        } else {
          const float2 x = *reinterpret_cast<const float2*>(xrow + 8 * VW * e);
          xv[0] = x.x; xv[1] = x.y;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int u = 0; u < VW; ++u) acc[i][e * VW + u] = fmaf(pv[i], xv[u], acc[i][e * VW + u]);
      }
    }
}

template <int D>
__device__ __forceinline__ void store_row(float* __restrict__ dst, const float* acc, int lane) {
  using L = Layout<D>;
  constexpr int VW = L::VW;
  float* out = dst + VW * (lane & 7);
#pragma unroll
  for (int e = 0; e < L::NE; ++e) {
    if constexpr (VW == 4) {
      *reinterpret_cast<float4*>(out + 8 * VW * e) =
          make_float4(acc[4 * e], acc[4 * e + 1], acc[4 * e + 2], acc[4 * e + 3]);
    } else {
      *reinterpret_cast<float2*>(out + 8 * VW * e) = make_float2(acc[2 * e], acc[2 * e + 1]);
    }
  }
}

// ---------------------------------------------------------------- 1. dq
template <int D>
__global__ void __launch_bounds__(NT, 1)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ num, const float* __restrict__ den,
          const float* __restrict__ mrow, const float* __restrict__ gnum,
          const float* __restrict__ gden, const float* __restrict__ gm, float* __restrict__ dq,
          float* __restrict__ coef_d, float* __restrict__ coef_s, float* __restrict__ dmv,
          int* __restrict__ ties, int nl, int c, int nrt) {
  using L = Layout<D>;
  constexpr int VW = L::VW, NE = L::NE, PER = L::PER;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Gs = Qs + L::T;
  float* Ks = Gs + L::T;          // two key tiles
  float* Vs = Ks + 2 * L::T;      // two value tiles

  const int rt = (int)(blockIdx.x % nrt);
  const long long bl = blockIdx.x / nrt;              // bh * nl + leaf
  const int leaf = (int)(bl % nl);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lr = lane >> 3, lc = lane & 7;
  const size_t leaf_off = (size_t)bl * c * D;
  const int r0 = rt * TT;
  const int nkt = (c + TT - 1) / TT;
  const int r_last = min(r0 + TT, c) - 1;
  const int n_prev = leaf > 0 ? nkt : 0;
  const int n_tiles = n_prev + r_last / TT + 1;
  const int w0 = r0 + 8 * warp;                       // the warp's first row
  const int w_last = min(w0 + 7, c - 1);

  auto tile_src = [&](int t, int* rows, int* tile) {
    const bool prev = t < n_prev;
    *tile = prev ? t : t - n_prev;
    *rows = min(TT, c - *tile * TT);
    return prev ? leaf_off - (size_t)c * D + (size_t)(*tile) * TT * D
                : leaf_off + (size_t)(*tile) * TT * D;
  };

  load_tile<D>(Qs, q + leaf_off + (size_t)r0 * D, c - r0);
  load_tile<D>(Gs, gnum + leaf_off + (size_t)r0 * D, c - r0);
  {
    int rows, tile;
    const size_t off = tile_src(0, &rows, &tile);
    load_tile<D>(Ks, k + off, rows);
    load_tile<D>(Vs, v + off, rows);
  }
  cp_async_commit();

  // per-row scalars of the lane's rows w0 + lr + 4 i
  float m[2], gd[2], dm[2], acc[2][PER];
  int cnt_d[2], cnt_s[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = w0 + lr + 4 * i;
    const bool ok = row < c;
    const size_t at = (size_t)bl * c + (ok ? row : 0);
    m[i] = ok ? mrow[at] : 0.0f;
    gd[i] = ok ? gden[at] : 0.0f;
    // gnum . num over the lane's columns, then across the row's 8 lanes
    float part = 0.0f;
    if (ok) {
      const float* gr = gnum + at * D + VW * lc;
      const float* nr = num + at * D + VW * lc;
#pragma unroll
      for (int e = 0; e < NE; ++e)
#pragma unroll
        for (int u = 0; u < VW; ++u) part = fmaf(gr[8 * VW * e + u], nr[8 * VW * e + u], part);
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    dm[i] = ok ? gm[at] - (part + gd[i] * den[at]) : 0.0f;
    cnt_d[i] = cnt_s[i] = 0;
#pragma unroll
    for (int e = 0; e < PER; ++e) acc[i][e] = 0.0f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();
    __syncthreads();     // tile t is in; every warp is done with tile t - 1's buffers
    if (t + 1 < n_tiles) {
      int rows, tile;
      const size_t off = tile_src(t + 1, &rows, &tile);
      load_tile<D>(Ks + ((t + 1) & 1) * L::T, k + off, rows);
      load_tile<D>(Vs + ((t + 1) & 1) * L::T, v + off, rows);
      cp_async_commit();
    }
    int rows, tile;
    tile_src(t, &rows, &tile);
    const bool causal = t >= n_prev;
    if (w0 >= c || (causal && tile * TT > w_last)) continue;
    const float* Kb = Ks + (t & 1) * L::T;
    const float* Vb = Vs + (t & 1) * L::T;

    float s[2][8], w[2][8];
    dot_2x8<D>(Qs, Kb, 8 * warp + lr, lc, s);
    dot_2x8<D>(Gs, Vb, 8 * warp + lr, lc, w);      // gnum . v
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = w0 + lr + 4 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = lc + 8 * j;
        const bool vis = row < c && col < rows && (!causal || tile * TT + col <= row);
        const bool tie = vis && s[i][j] == m[i];
        const float p = vis ? expf(s[i][j] - m[i]) : 0.0f;
        w[i][j] = vis ? fmaf(p, w[i][j] + gd[i], tie ? dm[i] : 0.0f) : 0.0f;
        if (causal) cnt_d[i] += tie; else cnt_s[i] += tie;
      }
    }
    accumulate<D>(acc, w, Kb, lane);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      cnt_d[i] += __shfl_xor_sync(0xffffffffu, cnt_d[i], off);
      cnt_s[i] += __shfl_xor_sync(0xffffffffu, cnt_s[i], off);
    }
    const int row = w0 + lr + 4 * i;
    if (row >= c) continue;
    const size_t at = (size_t)bl * c + row;
    store_row<D>(dq + at * D, acc[i], lane);
    if (lc == 0) {
      const int cd = cnt_d[i], cs = cnt_s[i];
      coef_d[at] = cd > 0 ? dm[i] * (cs > 0 ? 0.5f : 1.0f) / (float)cd : 0.0f;
      coef_s[at] = cs > 0 ? dm[i] * (cd > 0 ? 0.5f : 1.0f) / (float)cs : 0.0f;
      dmv[at] = dm[i];
      ties[at] = cd + cs;
    }
  }
}

// ---------------------------------------------------------------- 2. fix
// dq of a row whose max is attained more than once: pass 1 gave each tied
// key the weight dm, the row needs c_r(block).
template <int D>
__global__ void __launch_bounds__(NT)
fix_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ mrow, const float* __restrict__ coef_d,
           const float* __restrict__ coef_s, const float* __restrict__ dmv,
           const int* __restrict__ ties, float* __restrict__ dq, int nl, int c, long long rows) {
  constexpr int NC = (D + 31) / 32;
  const long long at = (long long)blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  if (at >= rows || ties[at] <= 1) return;
  const int lane = threadIdx.x & 31;
  const long long bl = at / c;
  const int r = (int)(at - bl * c);
  const int leaf = (int)(bl % nl);
  const float* qr = q + at * D;
  const float m = mrow[at];
  const float fix_d = coef_d[at] - dmv[at], fix_s = coef_s[at] - dmv[at];
  float acc[NC];
#pragma unroll
  for (int u = 0; u < NC; ++u) acc[u] = 0.0f;
  for (int blk = leaf > 0 ? 0 : 1; blk < 2; ++blk) {       // 0: leaf i-1, 1: leaf i
    const float* kb = k + (size_t)(bl - (blk == 0)) * c * D;
    const int n = blk == 0 ? c : r + 1;
    const float fix = blk == 0 ? fix_s : fix_d;
    for (int base = 0; base < n; base += 32) {
      const int j = base + lane;
      float s = 0.0f;
      if (j < n) {
        const float* kj = kb + (size_t)j * D;
        for (int d = 0; d < D; ++d) s = fmaf(qr[d], kj[d], s);
      }
      unsigned hit = __ballot_sync(0xffffffffu, j < n && s == m);
      while (hit) {
        const int b = __ffs(hit) - 1;
        hit &= hit - 1;
        const float* kj = kb + (size_t)(base + b) * D;
#pragma unroll
        for (int u = 0; u < NC; ++u)
          if (lane + 32 * u < D) acc[u] = fmaf(fix, kj[lane + 32 * u], acc[u]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < NC; ++u)
    if (lane + 32 * u < D) dq[at * D + lane + 32 * u] += acc[u];
}

// ---------------------------------------------------------------- 3. dk, dv
template <int D>
__global__ void __launch_bounds__(NT, 1)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           const float* __restrict__ mrow, const float* __restrict__ gnum,
           const float* __restrict__ gden, const float* __restrict__ coef_d,
           const float* __restrict__ coef_s, float* __restrict__ dk, float* __restrict__ dv,
           int nl, int c, int nkt) {
  using L = Layout<D>;
  constexpr int PER = L::PER;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + L::T;
  float* Qs = Vs + L::T;          // two row tiles of q
  float* Gs = Qs + 2 * L::T;      // two row tiles of gnum
  float* Sc = Gs + 2 * L::T;      // per row of the two tiles: m, gden, coefficient

  const int kt = (int)(blockIdx.x % nkt);
  const long long bl = blockIdx.x / nkt;
  const int leaf = (int)(bl % nl);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kr = lane >> 3, lc = lane & 7;
  const size_t leaf_off = (size_t)bl * c * D;
  const int k0 = kt * TT;
  const int n_diag = nkt - kt;                        // row tiles of leaf i from the diagonal on
  const int n_tiles = n_diag + (leaf + 1 < nl ? nkt : 0);
  const int w0 = k0 + 8 * warp;                       // the warp's first key

  auto tile_rows = [&](int t, int* rows, int* first) {  // offset of the tile's first row
    const bool diag = t < n_diag;
    *first = (diag ? kt + t : t - n_diag) * TT;
    *rows = min(TT, c - *first);
    return (size_t)(bl + (diag ? 0 : 1)) * c + *first;
  };
  auto load_rows = [&](int t) {
    int rows, first;
    const size_t row0 = tile_rows(t, &rows, &first);
    load_tile<D>(Qs + (t & 1) * L::T, q + row0 * D, rows);
    load_tile<D>(Gs + (t & 1) * L::T, gnum + row0 * D, rows);
    const float* coef = t < n_diag ? coef_d : coef_s;
    float* sc = Sc + (t & 1) * 3 * TT;
    for (int e = threadIdx.x; e < TT; e += NT) {
      const bool ok = e < rows;
      sc[e] = ok ? mrow[row0 + e] : 0.0f;
      sc[TT + e] = ok ? gden[row0 + e] : 0.0f;
      sc[2 * TT + e] = ok ? coef[row0 + e] : 0.0f;
    }
  };

  load_tile<D>(Ks, k + leaf_off + (size_t)k0 * D, c - k0);
  load_tile<D>(Vs, v + leaf_off + (size_t)k0 * D, c - k0);
  if (n_tiles > 0) load_rows(0);
  cp_async_commit();

  float adk[2][PER], adv[2][PER];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < PER; ++e) adk[i][e] = adv[i][e] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();
    __syncthreads();     // tile t is in; every warp is done with tile t - 1's buffers
    if (t + 1 < n_tiles) {
      load_rows(t + 1);
      cp_async_commit();
    }
    int rows, first;
    tile_rows(t, &rows, &first);
    const bool causal = t < n_diag;
    // a warp with no valid key, or whose keys all lie past this diagonal tile's rows, skips it
    if (w0 >= c || (causal && first + TT - 1 < w0)) continue;
    const float* Qb = Qs + (t & 1) * L::T;
    const float* Gb = Gs + (t & 1) * L::T;
    const float* sc = Sc + (t & 1) * 3 * TT;

    float s[2][8], w[2][8];
    dot_2x8<D>(Ks, Qb, 8 * warp + kr, lc, s);
    dot_2x8<D>(Vs, Gb, 8 * warp + kr, lc, w);       // gnum . v
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = w0 + kr + 4 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int e = lc + 8 * j;                       // row of the tile
        const bool vis = key < c && e < rows && (!causal || key <= first + e);
        const float mr = sc[e];
        const float p = vis ? expf(s[i][j] - mr) : 0.0f;
        const bool tie = vis && s[i][j] == mr;
        w[i][j] = vis ? fmaf(p, w[i][j] + sc[TT + e], tie ? sc[2 * TT + e] : 0.0f) : 0.0f;
        s[i][j] = p;
      }
    }
    accumulate<D>(adk, w, Qb, lane);
    accumulate<D>(adv, s, Gb, lane);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = w0 + kr + 4 * i;
    if (key >= c) continue;
    const size_t at = (size_t)bl * c + key;
    store_row<D>(dk + at * D, adk[i], lane);
    store_row<D>(dv + at * D, adv[i], lane);
  }
}

template <typename K>
int raise_smem(K kernel, int bytes, unsigned long long* raised) {
  // the cap on dynamic shared memory, set once per device (bit = device)
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (!(*raised >> (dev & 63) & 1)) {
    err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err) return err;
    *raised |= 1ull << (dev & 63);
  }
  return 0;
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* num, const float* den,
           const float* m, const float* gnum, const float* gden, const float* gm, float* dq,
           float* dk, float* dv, float* scratch, int* ties, int bh, int nl, int c,
           cudaStream_t s) {
  using L = Layout<D>;
  const int nt = (c + TT - 1) / TT;
  const long long blocks = (long long)bh * nl * nt;
  const long long rows = (long long)bh * nl * c;
  const long long fix_blocks = (rows + NT / 32 - 1) / (NT / 32);
  if (blocks > 2147483647LL || fix_blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  float* coef_d = scratch;
  float* coef_s = scratch + rows;
  float* dmv = scratch + 2 * rows;
  constexpr int dq_bytes = 6 * L::T * (int)sizeof(float);
  constexpr int dkv_bytes = (6 * L::T + 6 * TT) * (int)sizeof(float);
  static unsigned long long raised_dq = 0, raised_dkv = 0;
  int err = 0;
  if constexpr (dq_bytes > 48 * 1024) {
    err = raise_smem(dq_kernel<D>, dq_bytes, &raised_dq);
    if (err) return err;
  }
  if constexpr (dkv_bytes > 48 * 1024) {
    err = raise_smem(dkv_kernel<D>, dkv_bytes, &raised_dkv);
    if (err) return err;
  }
  dq_kernel<D><<<(unsigned)blocks, NT, dq_bytes, s>>>(q, k, v, num, den, m, gnum, gden, gm, dq,
                                                      coef_d, coef_s, dmv, ties, nl, c, nt);
  err = (int)cudaGetLastError();
  if (err) return err;
  fix_kernel<D><<<(unsigned)fix_blocks, NT, 0, s>>>(q, k, m, coef_d, coef_s, dmv, ties, dq, nl,
                                                    c, rows);
  err = (int)cudaGetLastError();
  if (err) return err;
  dkv_kernel<D><<<(unsigned)blocks, NT, dkv_bytes, s>>>(q, k, v, m, gnum, gden, coef_d, coef_s,
                                                        dk, dv, nl, c, nt);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, num, gnum, dq, dk, dv: (bh, nl, c, d); den, m, gden, gm: (bh, nl,
// c); f32 contiguous, q pre-scaled, 16-byte aligned; num, den and m as #11
// computed them from these q, k, v (the arg-max is found by s == m).
// scratch: 3 bh nl c floats, ties: bh nl c ints.  d in {16, 32, 64, 128}
// (cudaErrorInvalidValue otherwise).
extern "C" int repro_hattention_nearfield_bwd(const float* q, const float* k, const float* v,
                                              const float* num, const float* den,
                                              const float* m, const float* gnum,
                                              const float* gden, const float* gm, float* dq,
                                              float* dk, float* dv, float* scratch, int* ties,
                                              int bh, int nl, int c, int d, void* stream) {
  if (bh <= 0 || nl <= 0 || c <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(q, k, v, num, den, m, gnum, gden, gm, dq, dk, dv, scratch, ties, bh, nl, c, s);
    case 32: return launch<32>(q, k, v, num, den, m, gnum, gden, gm, dq, dk, dv, scratch, ties, bh, nl, c, s);
    case 64: return launch<64>(q, k, v, num, den, m, gnum, gden, gm, dq, dk, dv, scratch, ties, bh, nl, c, s);
    case 128: return launch<128>(q, k, v, num, den, m, gnum, gden, gm, dq, dk, dv, scratch, ties, bh, nl, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
