// H-attention near field: for every leaf i of the causal 1-D partition, the
// exact contribution of the two inadmissible blocks (i, i) [causal] and
// (i, i-1) [full, absent for leaf 0]:
//
//   m[i]   = row max of the visible scores of both blocks
//   num[i] = exp(S_ii - m) V_i + exp(S_i,i-1 - m) V_{i-1}
//   den[i] = rowsum exp(S_ii - m) + rowsum exp(S_i,i-1 - m)
//
// with S = q k^T, q pre-scaled by 1/sqrt(D).
//
// Replaces the TPU kernel src/repro/kernels/hattention_block/kernel.py:
// hattention_nearfield (body _kernel), which holds q, k, v, k_prev, v_prev and
// both (c, c) score blocks of one leaf in VMEM (3.4 MB at c = 512, D = 128,
// fifteen times a Hopper CTA's shared memory).
//
// Bound on the H100: operations.  Past leaf 0 a leaf needs 6 c^2 D flops
// (the two score blocks' products, half of the diagonal one, and the two
// products with V), leaf 0 2 c^2 D; at the serving shape (80, 16, 512, 128)
// that is 247 GFLOP against ~1.3 GB of q, k, v, num, den and m.  fp32 with
// no TF32 (the reference's tolerance and the repo's numerics rule).
//
// Design: one online pass.  A CTA of 8 warps owns 128 query rows of one
// (bh, leaf); each warp owns 16 of them, so everything a row needs stays in
// its warp.  The CTA walks 64-row key tiles: those of leaf i-1 (read in
// place at its offset, never copied), then those of leaf i up to its own
// diagonal (tiles wholly above the diagonal contribute exp(-1e30 - m) = 0
// in the reference and are skipped; a warp whose rows see none of a tile
// skips its products).  Key and value tiles come through a double-buffered
// cp.async ring, one CTA barrier per tile: the next tile loads while this
// one is computed.  Lane (r, c) of a warp (r = lane / 8, c = lane % 8)
// holds the scores of its 4 rows (r + 4 i) against 8 keys (c + 8 j) and
// the 4 x D/8 slice of num for those rows (columns in 16-byte runs at
// 4 c + 32 e, read conflict-free from the value tile).  Per tile: the
// scores, the tile's row max (a shuffle across the 8 lanes of a row),
// m_new = max(m, tile max), num and den rescaled by exp(m - m_new), p =
// exp(s - m_new), and num += p V with each p handed to the lanes of its row
// by a shuffle (p never leaves the registers).  The final m is the exact
// max of every visible score; num and den differ from the two-pass
// formulation by rounding only.  No atomics, each output row written once,
// den summed over the 8 lanes of a row in a fixed order: results do not
// depend on scheduling.  Shared memory at D = 128: q tile 128 x 132, two
// key tiles 64 x 132, two value tiles 64 x 128 floats (200,704 B): one CTA
// of 256 threads per SM.
#include <cuda_runtime.h>

namespace {

constexpr int TQ = 128;  // query rows per CTA
constexpr int TK = 64;   // key rows per tile
constexpr int NT = 256;
constexpr float NEG = -1e30f;

template <int D>
struct Layout {
  static constexpr int LDQ = D + 4;  // row stride of the q and k tiles (conflict-free float4 reads)
  static constexpr int LDV = D;      // row stride of the value tiles
  static constexpr int Q = TQ * LDQ;
  static constexpr int KT = TK * LDQ;
  static constexpr int VT = TK * LDV;
  static constexpr int FLOATS = Q + 2 * KT + 2 * VT;
  static constexpr int VW = D >= 32 ? 4 : 2;    // num columns per contiguous run
  static constexpr int NE = D / 8 / VW;         // runs per lane
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;     // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// rows x D floats, contiguous at src, into dst at row stride ld; rows past
// `valid` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* __restrict__ src,
                                          int rows, int valid) {
  constexpr int V4 = D / 4;
  for (int t = threadIdx.x; t < rows * V4; t += NT) {
    const int r = t / V4, c4 = t - (t / V4) * V4;
    const bool ok = r < valid;
    cp_async16(dst + r * ld + c4 * 4, ok ? src + (size_t)r * D + c4 * 4 : src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
nearfield_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ num, float* __restrict__ den,
                 float* __restrict__ mout, int nl, int c, int nqt) {
  using L = Layout<D>;
  constexpr int VW = L::VW, NE = L::NE;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + L::Q;          // two key tiles
  float* Vs = Ks + 2 * L::KT;     // two value tiles

  const int qt = nqt - 1 - (int)(blockIdx.x % nqt);   // the longest query tiles first
  const long long bl = blockIdx.x / nqt;              // bh * nl + leaf
  const int leaf = (int)(bl % nl);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lr = lane >> 3, lc = lane & 7;
  const size_t leaf_off = (size_t)bl * c * D;
  const bool has_prev = leaf > 0;
  const int q0 = qt * TQ;
  const int nkt = (c + TK - 1) / TK;
  const int q_last = min(q0 + TQ, c) - 1;
  const int n_prev = has_prev ? nkt : 0;
  const int n_tiles = n_prev + q_last / TK + 1;
  const int w0 = q0 + 16 * warp;                      // the warp's first row
  const int w_last = min(w0 + 15, c - 1);

  auto tile_src = [&](int t, int* rows, int* tile) {
    const bool prev = t < n_prev;
    *tile = prev ? t : t - n_prev;
    *rows = min(TK, c - *tile * TK);
    return prev ? leaf_off - (size_t)c * D + (size_t)(*tile) * TK * D
                : leaf_off + (size_t)(*tile) * TK * D;
  };

  load_tile<D>(Qs, L::LDQ, q + leaf_off + (size_t)q0 * D, TQ, min(TQ, c - q0));
  {
    int rows, tile;
    const size_t off = tile_src(0, &rows, &tile);
    load_tile<D>(Ks, L::LDQ, k + off, TK, rows);
    load_tile<D>(Vs, L::LDV, v + off, TK, rows);
  }
  cp_async_commit();

  float m[4], rden[4], acc[4][NE * VW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    rden[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < NE * VW; ++e) acc[i][e] = 0.0f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();
    __syncthreads();     // tile t is in; every warp is done with tile t - 1's buffers
    if (t + 1 < n_tiles) {
      int rows, tile;
      const size_t off = tile_src(t + 1, &rows, &tile);
      load_tile<D>(Ks + ((t + 1) & 1) * L::KT, L::LDQ, k + off, TK, rows);
      load_tile<D>(Vs + ((t + 1) & 1) * L::VT, L::LDV, v + off, TK, rows);
      cp_async_commit();
    }
    int rows, tile;
    tile_src(t, &rows, &tile);
    const bool causal = t >= n_prev;
    // a warp with no valid row, or whose rows all lie above this own tile, skips it
    if (w0 >= c || (causal && tile * TK > w_last)) continue;
    const float* Kb = Ks + (t & 1) * L::KT;
    const float* Vb = Vs + (t & 1) * L::VT;

    // s[i][j] = q[row i] . k[key lc + 8 j], summed over d in ascending order
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(Qs + (16 * warp + lr + 4 * i) * L::LDQ + d);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        b[j] = *reinterpret_cast<const float4*>(Kb + (lc + 8 * j) * L::LDQ + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }

    // online softmax: the tile's row max, rescale, p = exp(s - m_new)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = w0 + lr + 4 * i;
      float tmax = NEG;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = lc + 8 * j;
        const bool vis = col < rows && (!causal || tile * TK + col <= row);
        s[i][j] = vis ? s[i][j] : NEG;
        tmax = fmaxf(tmax, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float mnew = fmaxf(m[i], tmax);
      const float alpha = expf(m[i] - mnew);
      m[i] = mnew;
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = s[i][j] > NEG ? expf(s[i][j] - mnew) : 0.0f;
        s[i][j] = p;
        psum += p;
      }
      rden[i] = fmaf(rden[i], alpha, psum);
#pragma unroll
      for (int e = 0; e < NE * VW; ++e) acc[i][e] *= alpha;
    }

    // num += p V: key 8 j + o's p comes from lane (lr, o), slot j
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = __shfl_sync(0xffffffffu, s[i][j], (lane & ~7) | o);
      const float* vrow = Vb + (8 * j + o) * L::LDV + VW * lc;
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        float vv[VW];
        if constexpr (VW == 4) {
          const float4 x = *reinterpret_cast<const float4*>(vrow + 8 * VW * e);
          vv[0] = x.x; vv[1] = x.y; vv[2] = x.z; vv[3] = x.w;
        } else {
          const float2 x = *reinterpret_cast<const float2*>(vrow + 8 * VW * e);
          vv[0] = x.x; vv[1] = x.y;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int u = 0; u < VW; ++u) acc[i][e * VW + u] = fmaf(pv[i], vv[u], acc[i][e * VW + u]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) rden[i] += __shfl_xor_sync(0xffffffffu, rden[i], off);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = w0 + lr + 4 * i;
    if (r >= c) continue;
    const size_t row = (size_t)bl * c + r;
    float* out = num + row * D + VW * lc;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      if constexpr (VW == 4) {
        *reinterpret_cast<float4*>(out + 8 * VW * e) =
            make_float4(acc[i][4 * e], acc[i][4 * e + 1], acc[i][4 * e + 2], acc[i][4 * e + 3]);
      } else {
        *reinterpret_cast<float2*>(out + 8 * VW * e) = make_float2(acc[i][2 * e], acc[i][2 * e + 1]);
      }
    }
    if (lc == 0) {
      den[row] = rden[i];
      mout[row] = m[i];
    }
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* num, float* den, float* m,
           int bh, int nl, int c, cudaStream_t s) {
  const int nqt = (c + TQ - 1) / TQ;
  const long long blocks = (long long)bh * nl * nqt;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  constexpr int bytes = Layout<D>::FLOATS * (int)sizeof(float);
  if constexpr (bytes > 48 * 1024) {
    // the cap on dynamic shared memory, set once per device (bit = device)
    static unsigned long long raised = 0;
    int dev = 0;
    int err = (int)cudaGetDevice(&dev);
    if (err) return err;
    if (!(raised >> (dev & 63) & 1)) {
      err = (int)cudaFuncSetAttribute(nearfield_kernel<D>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err) return err;
      raised |= 1ull << (dev & 63);
    }
  }
  nearfield_kernel<D><<<(unsigned)blocks, NT, bytes, s>>>(q, k, v, num, den, m, nl, c, nqt);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, num: (bh, nl, c, d); den, m: (bh, nl, c); f32 contiguous, q
// pre-scaled, 16-byte aligned.  d in {16, 32, 64, 128} (cudaErrorInvalidValue
// otherwise).
extern "C" int repro_hattention_nearfield(const float* q, const float* k, const float* v,
                                          float* num, float* den, float* m, int bh, int nl,
                                          int c, int d, void* stream) {
  if (bh <= 0 || nl <= 0 || c <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(q, k, v, num, den, m, bh, nl, c, s);
    case 32: return launch<32>(q, k, v, num, den, m, bh, nl, c, s);
    case 64: return launch<64>(q, k, v, num, den, m, bh, nl, c, s);
    case 128: return launch<128>(q, k, v, num, den, m, bh, nl, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
