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
// the training shape (40, 8, 512, 128) that is 147.7 GFLOP against ~0.9 GB:
// 2.2 ms at the 67 TFLOP/s of fp32 outside the tensor cores.
//
// Numerics.  Every product runs on the tensor cores as 3xTF32: each fp32
// operand x is split into hi = x rounded to tf32 (nearest, ties away from
// zero: cvt.rna.tf32.f32) and lo = x - hi (exact in fp32; the tensor core
// reads its top 19 bits), and lo.hi + hi.lo + hi.hi go into fp32
// accumulators, the small terms first: fp32 accuracy (one-pass TF32 keeps
// about three digits and is not used).  No TF32 flag is read or set.
//
// The arg-max stays #11's.  A 3xTF32 score and #11's (one fma chain over d
// ascending) both lie within ~2^-16.5 |q| |k| of the exact product, so an
// entry whose 3xTF32 score is below m - 2^-10 |q| |k| cannot attain m; the
// others (the candidates: the max itself and near ties, about one a row)
// are recomputed in #11's order by their lane and tested with == m, so the
// ties are #11's bit for bit.  tests/test_torch_nearfield_bwd_split.py
// holds the bound on the CPU.
//
// Instruction: mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 (SASS
// HMMA.1688.F32.TF32), whose fragments come from ordinary 4-byte shared
// loads in any layout.  Lane (g, t) = (lane / 4, lane % 4) of a warp holds
// C rows g, g + 8 and columns 2t, 2t + 1 of each 8-wide tile; read as an A
// fragment of the next product, those two columns become k = t and t + 4,
// and the B fragment reads the same two keys (or rows), so scores, ds and p
// go from one product's accumulator into the next as they are.
//
// Design: three launches, no atomics, every output written once by one
// lane, every sum in a fixed order (two launches give the same bits).  CTAs
// of 8 warps in 4 pairs, 16 owned rows or keys a pair; two CTAs an SM (at
// D = 128: 110,080 and 100,352 B of shared memory, at most 128 registers),
// 16 warps to cover the mma and load latencies.
//  1. dq: a CTA owns 64 rows of one (bh, leaf) (q and gnum resident) and
//     walks the 32-key tiles of leaf i-1, then those of leaf i up to its
//     diagonal (cp.async).  Per tile, each warp of a pair takes 16 of the
//     keys: the scores and gnum v^T (16 x 16), the candidates' exact test
//     (|q| of the CTA's rows taken once from the resident tile, |k| of the
//     warp's keys from the streamed one),
//     p and ds = p (gnum . v + gden) + tie dm, stored to the stash; the pair
//     trades its ds halves through shared memory (a named barrier), and
//     each warp adds ds K into its half of dq's columns.  The tie term is
//     taken with weight dm for every entry that attains the max (exact
//     where one entry does); the lanes count the ties per block, and the
//     CTA writes dq, the per-row coefficients c_r of both blocks, dm and the
//     tie count.
//  2. fix: a warp per row with more than one tie (rare: one exits at once
//     otherwise) recomputes that row's scores, adds (c_r - dm) k_j to dq and
//     (c_r - dm) to the stashed ds for each tied key, in key order.
//  3. dk, dv: a CTA owns 64 keys of one (bh, leaf) and walks the 32-row
//     tiles that see them (the causal rows of leaf i, then every row of
//     leaf i+1): q and gnum rows and the stashed ds and p through a
//     double-buffered cp.async ring; a pair's first warp adds ds^T Q into
//     dk, its second p^T gnum into dv.
// The stash holds ds and p of every row against its 2c keys (4 bh nl c^2
// floats, 1.34 GB at the training shape, of which the visible 0.92 GB is
// written once and read once): it spares the dk/dv pass the scores, gnum v^T
// and the arg-max test, about half of the work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;      // 8 warps: 4 pairs
constexpr int OWN = 64;      // rows (dq) or keys (dk, dv) a CTA owns, 16 a pair
constexpr int STR = 32;      // keys (dq) or rows (dk, dv) of a streamed tile, 16 a warp
constexpr int FIX_NT = 256;

template <int D>
struct Layout {
  static constexpr int LD = D + 4;        // row stride of every tile: conflict-free fragments
  static constexpr int OWN_T = OWN * LD;  // floats of a resident tile
  static constexpr int STR_T = STR * LD;  // floats of a streamed tile
  static constexpr int NK = D / 8;        // 8-wide steps over D
  // dq: the tiles, the pairs' exchange (float4 a lane, 4 blocks of 8 a
  // pair) and their tie counts (16 rows x 2 a pair); dk, dv: two slots of
  // the streamed tiles and of each lane's 16 stashed values
  static constexpr int XCH = (OWN / 16) * 4 * 32 * 16;
  static constexpr int DQ_BYTES = (2 * OWN_T + 2 * STR_T) * (int)sizeof(float) + XCH + 512;
  static constexpr int DKV_BYTES = (4 * STR_T + 2 * (NT / 32) * 16 * 32) * (int)sizeof(float);
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;     // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 4 : 0;      // 0: zero-fill, nothing read
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// the two warps of pair p meet (named barrier 1 + p; 0 is __syncthreads)
__device__ __forceinline__ void pair_sync(int p) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + p) : "memory");
}

// rows x D floats, contiguous at src, into dst at row stride LD; rows past
// `valid` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int rows,
                                          int valid) {
  constexpr int V4 = D / 4;
  for (int i = threadIdx.x; i < rows * V4; i += NT) {
    const int r = i / V4, c4 = i - r * V4;
    const bool ok = r < valid;
    cp_async16(dst + r * Layout<D>::LD + c4 * 4, ok ? src + (size_t)r * D + c4 * 4 : src, ok);
  }
}

// x = hi + lo: hi rounded to tf32, to nearest with ties away from zero (what
// cvt.rna.tf32.f32 gives a finite x, in two integer operations where the
// compiler spends four on cvt's special cases), lo = x - hi exactly, handed
// over as fp32 bits of which the tensor core reads the tf32 part
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a B fragment (k = t and t + 4 of one column), split
struct BFrag {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void b_frag(float b0, float b1, BFrag& f) {
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
}

// A fragment of rows r, r + 8 and columns k, k + 4 of a row-major tile
template <int D>
__device__ __forceinline__ void a_frag(const float* tile, int r, int k, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  constexpr int LD = Layout<D>::LD;
  const float* a = tile + r * LD + k;
  split(a[0], hi[0], lo[0]);
  split(a[8 * LD], hi[1], lo[1]);
  split(a[4], hi[2], lo[2]);
  split(a[8 * LD + 4], hi[3], lo[3]);
}

// An accumulator fragment (rows g, g + 8; columns 2t, 2t + 1) read as an A
// fragment: column 2t is k = t, column 2t + 1 is k = t + 4
__device__ __forceinline__ void c_as_a(const float (&c)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(c[0], hi[0], lo[0]);
  split(c[2], hi[1], lo[1]);
  split(c[1], hi[2], lo[2]);
  split(c[3], hi[3], lo[3]);
}

// a . b over D in ascending order, one fma chain: #11's order for a score,
// so that it equals #11's bit for bit
template <int D>
__device__ __forceinline__ float exact_score(const float* a, const float* b) {
  float s = 0.0f;
#pragma unroll 8
  for (int d = 0; d < D; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + d);
    const float4 y = *reinterpret_cast<const float4*>(b + d);
    s = fmaf(x.x, y.x, s); s = fmaf(x.y, y.y, s);
    s = fmaf(x.z, y.z, s); s = fmaf(x.w, y.w, s);
  }
  return s;
}

// The arg-max test of a warp's 16 x 16 tile of scores: the candidates (bit
// 4 j + e set in cand: entries whose 3xTF32 score lies within the bound of
// its error below the row's max) are recomputed in #11's order, A row
// r + 8 (e / 2) against X entry 8 j + 2t + e % 2, and compared with their
// row's max, max_of(bit).  Returns the bits of the entries that attain it.
template <int D, typename M>
__device__ __forceinline__ unsigned exact_ties(unsigned cand, const float* A, int r,
                                               const float* X, int t, M max_of) {
  constexpr int LD = Layout<D>::LD;
  unsigned tie = 0;
  while (__any_sync(0xffffffffu, cand != 0)) {
    if (cand) {
      const int b = __ffs(cand) - 1;
      cand &= cand - 1;
      const float x = exact_score<D>(A + (r + 8 * ((b >> 1) & 1)) * LD,
                                     X + (8 * (b >> 2) + 2 * t + (b & 1)) * LD);
      if (x == max_of(b)) tie |= 1u << b;
    }
  }
  return tie;
}

// 2^-10 |q| |k| bounds the distance of a 3xTF32 score to #11's by a wide
// margin (both lie within ~2^-16.5 |q| |k| of the exact product): a score
// below m - 2^-10 |q| |k| cannot attain m
constexpr float CAND = 0x1p-10f;

// acc[i] = A[rows r, r + 8] . Y[entries 8 i + g] over D on the tensor cores:
// gnum v^T (dq pass) or v gnum^T (dk, dv pass); Y: a warp's 16 entries of
// the streamed tile.  The small terms of 3xTF32 go to accumulators of their
// own, added at the end, and the two tiles are issued term by term.
template <int D>
__device__ __forceinline__ void products_d(const float* A, int r, const float* Y, int g, int t,
                                           float (&acc)[2][4]) {
  constexpr int LD = Layout<D>::LD;
  float small[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = small[j][e] = 0.0f;
#pragma unroll 4
  for (int ks = 0; ks < Layout<D>::NK; ++ks) {
    uint32_t ah[4], al[4];
    a_frag<D>(A, r, 8 * ks + t, ah, al);
    BFrag b[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float* y = Y + (8 * j + g) * LD + 8 * ks + t;
      b_frag(y[0], y[4], b[j]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) mma_tf32(small[j], al, b[j].hi[0], b[j].hi[1]);
#pragma unroll
    for (int j = 0; j < 2; ++j) mma_tf32(acc[j], ah, b[j].hi[0], b[j].hi[1]);
#pragma unroll
    for (int j = 0; j < 2; ++j) mma_tf32(small[j], ah, b[j].lo[0], b[j].lo[1]);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += small[j][e];
}

// out[n] += a . X[32 entries][columns 8 (n0 + n) + g], n < NN, on the tensor
// cores (3xTF32, the small terms first): a is 16 x 32 in the accumulator
// layout, entries 0-15 in lo and 16-31 in hi; G column tiles at a time,
// term by term.  Each 8-wide step is summed from zero and then added to out
// in fp32: out sums up to 128 steps, and the tensor core's own accumulation
// (three truncating adds a step) cost it about a decimal digit.
template <int D, int NN, int G>
__device__ __forceinline__ void products_tile(const float (&lo)[2][4], const float (&hi)[2][4],
                                              const float* X, int n0, int g, int t,
                                              float (&out)[NN][4]) {
  constexpr int LD = Layout<D>::LD;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t ah[4], al[4];
    c_as_a(j < 2 ? lo[j & 1] : hi[j & 1], ah, al);
    const float* x = X + (8 * j + 2 * t) * LD + 8 * n0 + g;
#pragma unroll
    for (int nb = 0; nb < NN; nb += G) {
      BFrag b[G];
#pragma unroll
      for (int i = 0; i < G; ++i) b_frag(x[8 * (nb + i)], x[LD + 8 * (nb + i)], b[i]);
      float tmp[G][4];
#pragma unroll
      for (int i = 0; i < G; ++i) {
        tmp[i][0] = tmp[i][1] = tmp[i][2] = tmp[i][3] = 0.0f;
        mma_tf32(tmp[i], al, b[i].hi[0], b[i].hi[1]);
      }
#pragma unroll
      for (int i = 0; i < G; ++i) mma_tf32(tmp[i], ah, b[i].lo[0], b[i].lo[1]);
#pragma unroll
      for (int i = 0; i < G; ++i) mma_tf32(tmp[i], ah, b[i].hi[0], b[i].hi[1]);
#pragma unroll
      for (int i = 0; i < G; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) out[nb + i][e] += tmp[i][e];
    }
  }
}

// row g + 8 h of an accumulator over NN column tiles into dst (float2 stores)
template <int NN>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, const float (&acc)[NN][4],
                                           int h, int t) {
  float* out = dst + 2 * t;
#pragma unroll
  for (int n = 0; n < NN; ++n)
    *reinterpret_cast<float2*>(out + 8 * n) = make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
}

__device__ __forceinline__ float4 as_float4(const float (&c)[4]) {
  return make_float4(c[0], c[1], c[2], c[3]);
}

__device__ __forceinline__ void from_float4(float4 x, float (&c)[4]) {
  c[0] = x.x; c[1] = x.y; c[2] = x.z; c[3] = x.w;
}

// ---------------------------------------------------------------- 1. dq
template <int D>
__global__ void __launch_bounds__(NT, 2)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ num, const float* __restrict__ den,
          const float* __restrict__ mrow, const float* __restrict__ gnum,
          const float* __restrict__ gden, const float* __restrict__ gm, float* __restrict__ dq,
          float* __restrict__ coef_d, float* __restrict__ coef_s, float* __restrict__ dmv,
          int* __restrict__ ties, float* __restrict__ dsv, float* __restrict__ pv, int nl, int c,
          int nrt) {
  using L = Layout<D>;
  constexpr int LD = L::LD, NH = L::NK / 2, G = NH < 8 ? NH : 8;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Gs = Qs + L::OWN_T;
  float* Ks = Gs + L::OWN_T;
  float* Vs = Ks + L::STR_T;
  float4* Xs = reinterpret_cast<float4*>(Vs + L::STR_T);    // [pair][8-key block][lane]
  int* Cs = reinterpret_cast<int*>(Xs + 4 * 4 * 32);        // [pair][row][diag, prev]

  const int rt = nrt - 1 - (int)(blockIdx.x % nrt);   // the longest row tiles first
  const long long bl = blockIdx.x / nrt;              // bh * nl + leaf
  const int leaf = (int)(bl % nl);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int pair = warp >> 1, hf = warp & 1;          // a pair's 16 rows; keys / columns half
  const size_t leaf_off = (size_t)bl * c * D;
  const int r0 = rt * OWN;
  const int nkt = (c + STR - 1) / STR;
  const int n_prev = leaf > 0 ? nkt : 0;
  const int n_tiles = n_prev + (min(r0 + OWN, c) - 1) / STR + 1;
  const int wr = 16 * pair;                           // the pair's first row in the tile
  const int w0 = r0 + wr;                             // ... in the leaf
  const int w_last = min(w0 + 15, c - 1);
  const int kb = 16 * hf;                             // the warp's first key of a tile

  load_tile<D>(Qs, q + leaf_off + (size_t)r0 * D, OWN, c - r0);
  load_tile<D>(Gs, gnum + leaf_off + (size_t)r0 * D, OWN, c - r0);

  // scalars of the lane's rows w0 + g + 8 h; gnum . num over 16-column
  // runs of the row's 4 lanes, then across them
  float m[2], gd[2], dm[2], thr[2] = {0.0f, 0.0f};   // thr: CAND |q|, set at the first tile
  int cnt_d[2], cnt_s[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = w0 + g + 8 * h;
    const bool ok = row < c;
    const size_t at = (size_t)bl * c + (ok ? row : 0);
    m[h] = ok ? mrow[at] : 0.0f;
    gd[h] = ok ? gden[at] : 0.0f;
    float part = 0.0f;
    if (ok) {
#pragma unroll
      for (int e = 0; e < D / 16; ++e) {
        const float4 a = *reinterpret_cast<const float4*>(gnum + at * D + 16 * e + 4 * t);
        const float4 b = *reinterpret_cast<const float4*>(num + at * D + 16 * e + 4 * t);
        part = fmaf(a.x, b.x, part); part = fmaf(a.y, b.y, part);
        part = fmaf(a.z, b.z, part); part = fmaf(a.w, b.w, part);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    dm[h] = ok ? gm[at] - (part + gd[h] * den[at]) : 0.0f;
    cnt_d[h] = cnt_s[h] = 0;
  }
  float acc[NH][4];       // dq of rows g, g + 8, columns of the warp's half of D
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const bool prev = it < n_prev;
    const int tile = prev ? it : it - n_prev;
    const int rows = min(STR, c - tile * STR);
    const size_t off = (prev ? leaf_off - (size_t)c * D : leaf_off) + (size_t)tile * STR * D;
    if (it > 0) __syncthreads();     // every warp is done with tile it - 1
    load_tile<D>(Ks, k + off, STR, rows);
    load_tile<D>(Vs, v + off, STR, rows);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    if (it == 0) {
      // |q| of the lane's rows from the resident tile (rows past c are zeros),
      // a quarter of D a lane, then across the row's 4 lanes
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* qr = Qs + (wr + g + 8 * h) * LD + t * (D / 4);
        float a = 0.0f;
#pragma unroll
        for (int e = 0; e < D / 4; e += 4) {
          const float4 x = *reinterpret_cast<const float4*>(qr + e);
          a = fmaf(x.x, x.x, a); a = fmaf(x.y, x.y, a);
          a = fmaf(x.z, x.z, a); a = fmaf(x.w, x.w, a);
        }
        a += __shfl_xor_sync(0xffffffffu, a, 1);
        a += __shfl_xor_sync(0xffffffffu, a, 2);
        thr[h] = CAND * sqrtf(a);
      }
    }
    // a pair with no valid row, or whose rows all lie above this own tile, skips it
    if (w0 >= c || (!prev && tile * STR > w_last)) continue;

    // ds of the pair's 16 rows and the warp's 16 keys
    float w[2][4], s[2][4];
    if (prev || tile * STR + kb <= w_last) {
      products_d<D>(Gs, wr + g, Vs + kb * LD, g, t, w);          // gnum . v
      products_d<D>(Qs, wr + g, Ks + kb * LD, g, t, s);          // q . k
      // |k| of the warp's 16 keys: lane l sums half l / 16 of key l % 16's
      // squares; kn[j][u] is key 8 j + 2 t + u's, from the lane holding it
      float kn2 = 0.0f;
      const float* kr = Ks + (kb + (lane & 15)) * LD + (lane >> 4) * (D / 2);
#pragma unroll
      for (int e = 0; e < D / 2; e += 4) {
        const float4 x = *reinterpret_cast<const float4*>(kr + e);
        kn2 = fmaf(x.x, x.x, kn2); kn2 = fmaf(x.y, x.y, kn2);
        kn2 = fmaf(x.z, x.z, kn2); kn2 = fmaf(x.w, x.w, kn2);
      }
      kn2 += __shfl_xor_sync(0xffffffffu, kn2, 16);
      const float knl = sqrtf(kn2);
      float kn[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) kn[j][u] = __shfl_sync(0xffffffffu, knl, 8 * j + 2 * t + u);
      unsigned vis = 0, cand = 0;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, b = 4 * j + e;
          const int row = w0 + g + 8 * h;
          const int kl = kb + 8 * j + 2 * t + (e & 1);
          const bool ok = row < c && kl < rows && (prev || tile * STR + kl <= row);
          vis |= (unsigned)ok << b;
          cand |= (unsigned)(ok && s[j][e] >= fmaf(-thr[h], kn[j][e & 1], m[h])) << b;
        }
      const unsigned tie = exact_ties<D>(cand, Qs, wr + g, Ks + kb * LD, t,
                                         [&](int b) { return (b >> 1) & 1 ? m[1] : m[0]; });
      // ds and p to the stash, row-major over [leaf i-1 | leaf i]'s 2c keys
      const size_t col = (size_t)(prev ? 0 : c) + tile * STR + kb + 2 * t;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, b = 4 * j + e;
          const bool ok = vis >> b & 1, hit = tie >> b & 1;
          const float p = ok ? expf(s[j][e] - m[h]) : 0.0f;
          w[j][e] = ok ? fmaf(p, w[j][e] + gd[h], hit ? dm[h] : 0.0f) : 0.0f;
          if (prev) cnt_s[h] += hit; else cnt_d[h] += hit;
          const int row = w0 + g + 8 * h;
          if (row < c && kb + 8 * j + 2 * t + (e & 1) < rows) {
            const size_t at = ((size_t)bl * c + row) * 2 * c + col + 8 * j + (e & 1);
            dsv[at] = w[j][e];
            pv[at] = p;
          }
        }
    } else {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) w[j][e] = 0.0f;
    }
    // both halves of the tile's keys to both warps of the pair
    float4* x = Xs + pair * 4 * 32 + lane;
#pragma unroll
    for (int j = 0; j < 2; ++j) x[(2 * hf + j) * 32] = as_float4(w[j]);
    pair_sync(pair);
    float lo[2][4], hi[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      from_float4(x[j * 32], lo[j]);
      from_float4(x[(2 + j) * 32], hi[j]);
    }
    products_tile<D, NH, G>(lo, hi, Ks, hf * NH, g, t, acc);    // dq += ds K
  }

#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      cnt_d[h] += __shfl_xor_sync(0xffffffffu, cnt_d[h], off);
      cnt_s[h] += __shfl_xor_sync(0xffffffffu, cnt_s[h], off);
    }
  int* cs = Cs + pair * 32;
  if (hf == 1 && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      cs[2 * (g + 8 * h)] = cnt_d[h];
      cs[2 * (g + 8 * h) + 1] = cnt_s[h];
    }
  }
  pair_sync(pair);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = w0 + g + 8 * h;
    if (row >= c) continue;
    const size_t at = (size_t)bl * c + row;
    store_rows<NH>(dq + at * D + 8 * NH * hf, acc, h, t);
    if (hf == 0 && t == 0) {
      const int cd = cnt_d[h] + cs[2 * (g + 8 * h)], ns = cnt_s[h] + cs[2 * (g + 8 * h) + 1];
      coef_d[at] = cd > 0 ? dm[h] * (ns > 0 ? 0.5f : 1.0f) / (float)cd : 0.0f;
      coef_s[at] = ns > 0 ? dm[h] * (cd > 0 ? 0.5f : 1.0f) / (float)ns : 0.0f;
      dmv[at] = dm[h];
      ties[at] = cd + ns;
    }
  }
}

// ---------------------------------------------------------------- 2. fix
// dq and the stashed ds of a row whose max is attained more than once: pass
// 1 gave each tied key the weight dm, the row needs c_r(block).
template <int D>
__global__ void __launch_bounds__(FIX_NT)
fix_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ mrow, const float* __restrict__ coef_d,
           const float* __restrict__ coef_s, const float* __restrict__ dmv,
           const int* __restrict__ ties, float* __restrict__ dq, float* __restrict__ dsv,
           int nl, int c, long long rows) {
  constexpr int NC = (D + 31) / 32;
  const long long at = (long long)blockIdx.x * (FIX_NT / 32) + (threadIdx.x >> 5);
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
      const bool tied = j < n && s == m;
      if (tied) dsv[at * 2 * c + (size_t)blk * c + j] += fix;   // the stash's ds, for dk
      unsigned hit = __ballot_sync(0xffffffffu, tied);
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
__global__ void __launch_bounds__(NT, 2)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ gnum,
           const float* __restrict__ dsv, const float* __restrict__ pv, float* __restrict__ dk,
           float* __restrict__ dv, int nl, int c, int nkt) {
  using L = Layout<D>;
  constexpr int NK = L::NK, G = NK < 4 ? NK : 4;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;               // two slots of the streamed row tiles of q and of gnum
  float* Gs = Qs + 2 * L::STR_T;
  float* Ss = Gs + 2 * L::STR_T;  // two slots of the stash: [warp][16 values][lane]

  const int kt = (int)(blockIdx.x % nkt);             // kt = 0 sees the most rows
  const long long bl = blockIdx.x / nkt;
  const int leaf = (int)(bl % nl);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  // a pair's 16 keys; its first warp sums dk = ds^T q, its second dv = p^T gnum
  const int pair = warp >> 1, hf = warp & 1;
  const int k0 = kt * OWN;
  const int nrs = (c + STR - 1) / STR;
  const int first_diag = k0 / STR;                    // the first row tile of leaf i that sees a key
  const int n_diag = nrs - first_diag;
  const int n_tiles = n_diag + (leaf + 1 < nl ? nrs : 0);
  const int w0 = k0 + 16 * pair;                      // the pair's first key in the leaf
  const float* src = hf ? pv : dsv;
  const float* X = hf ? Gs : Qs;
  float* stage = Ss + warp * 16 * 32 + lane;

  // tile it: rows first .. first + rows - 1 of leaf i (diag) or of leaf i+1
  auto tile_of = [&](int it, bool& diag, int& first, int& rows) {
    diag = it < n_diag;
    first = (diag ? first_diag + it : it - n_diag) * STR;
    rows = min(STR, c - first);
  };
  // tile it's q and gnum rows, and the lane's 16 stashed values of it in the
  // accumulator layout (keys g, g + 8 of the pair, rows 8 j + 2t + e % 2 of
  // the tile at 4 j + e; 0 where not visible), into slot it % 2
  auto load = [&](int it) {
    bool diag;
    int first, rows;
    tile_of(it, diag, first, rows);
    const size_t row0 = (size_t)(bl + (diag ? 0 : 1)) * c + first;
    load_tile<D>(Qs + (it & 1) * L::STR_T, q + row0 * D, STR, rows);
    load_tile<D>(Gs + (it & 1) * L::STR_T, gnum + row0 * D, STR, rows);
    const float* tp = src + row0 * 2 * c + (diag ? c : 0) + w0 + g + 2 * t * 2 * c;
    float* dst = stage + (it & 1) * (NT / 32) * 16 * 32;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int dk = 8 * (e >> 1), rl = 8 * j + 2 * t + (e & 1);
        const int key = w0 + g + dk;
        const bool ok = key < c && rl < rows && (!diag || key <= first + rl);
        cp_async4(dst + (4 * j + e) * 32, ok ? tp + (8 * j + (e & 1)) * 2 * c + dk : src, ok);
      }
    cp_async_commit();
  };

  float acc[NK][4];
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  load(0);

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();     // tile it is in; every warp is done with tile it - 1's slot
    if (it + 1 < n_tiles) load(it + 1);
    bool diag;
    int first, rows;
    tile_of(it, diag, first, rows);
    // a pair with no valid key, or whose keys all lie past this diagonal tile's rows, skips it
    if (w0 >= c || (diag && first + rows - 1 < w0)) continue;
    float lo[2][4], hi[2][4];       // rows 0-15 and 16-31 of the tile
    const float* st = stage + (it & 1) * (NT / 32) * 16 * 32;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        lo[j][e] = st[(4 * j + e) * 32];
        hi[j][e] = st[(4 * j + 8 + e) * 32];
      }
    products_tile<D, NK, G>(lo, hi, X + (it & 1) * L::STR_T, 0, g, t, acc);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = w0 + g + 8 * h;
    if (key >= c) continue;
    store_rows<NK>((hf ? dv : dk) + ((size_t)bl * c + key) * D, acc, h, t);
  }
}

template <typename K>
int prepare(K kernel, int bytes, unsigned long long* raised) {
  // the cap on dynamic shared memory and the carveout, set once per device (bit = device)
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (!(*raised >> (dev & 63) & 1)) {
    if (bytes > 48 * 1024) {
      err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err) return err;
    }
    err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                    (int)cudaSharedmemCarveoutMaxShared);
    if (err) return err;
    *raised |= 1ull << (dev & 63);
  }
  return 0;
}

template <int D>
int prepare_all() {
  using L = Layout<D>;
  static unsigned long long raised_dq = 0, raised_dkv = 0;
  int err = prepare(dq_kernel<D>, L::DQ_BYTES, &raised_dq);
  return err ? err : prepare(dkv_kernel<D>, L::DKV_BYTES, &raised_dkv);
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* num, const float* den,
           const float* m, const float* gnum, const float* gden, const float* gm, float* dq,
           float* dk, float* dv, float* scratch, int* ties, float* stash, int bh, int nl, int c,
           cudaStream_t s) {
  using L = Layout<D>;
  const int nt = (c + OWN - 1) / OWN;
  const long long blocks = (long long)bh * nl * nt;
  const long long rows = (long long)bh * nl * c;
  const long long fix_blocks = (rows + FIX_NT / 32 - 1) / (FIX_NT / 32);
  if (blocks > 2147483647LL || fix_blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  float* coef_d = scratch;
  float* coef_s = scratch + rows;
  float* dmv = scratch + 2 * rows;
  float* dsv = stash;                          // ds and p of every row against its 2c keys
  float* pv = stash + rows * 2 * c;
  int err = prepare_all<D>();
  if (err) return err;
  dq_kernel<D><<<(unsigned)blocks, NT, L::DQ_BYTES, s>>>(q, k, v, num, den, m, gnum, gden, gm,
                                                         dq, coef_d, coef_s, dmv, ties, dsv, pv,
                                                         nl, c, nt);
  err = (int)cudaGetLastError();
  if (err) return err;
  fix_kernel<D><<<(unsigned)fix_blocks, FIX_NT, 0, s>>>(q, k, m, coef_d, coef_s, dmv, ties, dq,
                                                        dsv, nl, c, rows);
  err = (int)cudaGetLastError();
  if (err) return err;
  dkv_kernel<D><<<(unsigned)blocks, NT, L::DKV_BYTES, s>>>(q, gnum, dsv, pv, dk, dv, nl, c, nt);
  return (int)cudaGetLastError();
}

template <int D>
int info(int* out) {
  using L = Layout<D>;
  int err = prepare_all<D>();
  if (err) return err;
  cudaFuncAttributes a{};
  int ctas = 0;
  err = (int)cudaFuncGetAttributes(&a, dq_kernel<D>);
  if (!err) err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, dq_kernel<D>, NT,
                                                                       L::DQ_BYTES);
  if (err) return err;
  out[0] = a.numRegs; out[1] = (int)a.localSizeBytes; out[2] = L::DQ_BYTES; out[3] = ctas;
  err = (int)cudaFuncGetAttributes(&a, dkv_kernel<D>);
  if (!err) err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, dkv_kernel<D>, NT,
                                                                       L::DKV_BYTES);
  if (err) return err;
  out[4] = a.numRegs; out[5] = (int)a.localSizeBytes; out[6] = L::DKV_BYTES; out[7] = ctas;
  return 0;
}

}  // namespace

// q, k, v, num, gnum, dq, dk, dv: (bh, nl, c, d); den, m, gden, gm: (bh, nl,
// c); f32 contiguous, q pre-scaled, 16-byte aligned; num, den and m as #11
// computed them from these q, k, v (the arg-max is found by s == m).
// scratch: 3 bh nl c floats, ties: bh nl c ints, stash: 4 bh nl c^2 floats
// (ds and p of every row against its 2c keys).  d in {16, 32, 64, 128}
// (cudaErrorInvalidValue otherwise).
extern "C" int repro_hattention_nearfield_bwd(const float* q, const float* k, const float* v,
                                              const float* num, const float* den,
                                              const float* m, const float* gnum,
                                              const float* gden, const float* gm, float* dq,
                                              float* dk, float* dv, float* scratch, int* ties,
                                              float* stash, int bh, int nl, int c, int d,
                                              void* stream) {
  if (bh <= 0 || nl <= 0 || c <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(q, k, v, num, den, m, gnum, gden, gm, dq, dk, dv, scratch, ties, stash, bh, nl, c, s);
    case 32: return launch<32>(q, k, v, num, den, m, gnum, gden, gm, dq, dk, dv, scratch, ties, stash, bh, nl, c, s);
    case 64: return launch<64>(q, k, v, num, den, m, gnum, gden, gm, dq, dk, dv, scratch, ties, stash, bh, nl, c, s);
    case 128: return launch<128>(q, k, v, num, den, m, gnum, gden, gm, dq, dk, dv, scratch, ties, stash, bh, nl, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Resources of the dq and dk/dv kernels at head dim d, into out[8]: for
// each, registers a thread, local (spill) bytes a thread, dynamic shared
// bytes a CTA and resident CTAs an SM (the occupancy calculator).
extern "C" int repro_hattention_nearfield_bwd_info(int d, int* out) {
  switch (d) {
    case 16: return info<16>(out);
    case 32: return info<32>(out);
    case 64: return info<64>(out);
    case 128: return info<128>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}
