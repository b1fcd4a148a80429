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
// Design, simple first: one CTA of 256 threads per (bh, leaf, 64-row query
// tile).  The CTA walks 64-row key tiles: those of leaf i-1 (read in place at
// its offset, never copied), then those of leaf i up to its own diagonal tile
// (tiles wholly above the diagonal contribute exp(-1e30 - m) = 0 in the
// reference and are skipped).  Two passes: pass 1 takes the exact row max
// over every visible score, pass 2 recomputes the scores with the same code
// (so bit for bit the same), forms p = exp(s - m) and accumulates den and num
// in registers.  No online rescaling enters num, no atomics, each output row
// is written once: results do not depend on scheduling.  Each thread owns a
// 4 x 4 score tile (rows ty + 16 i, columns tx + 16 j) and a 4 x D/16 slice
// of num; row reductions are shuffles across the 16 threads of a row.  Shared
// memory: q, k and v tiles at row stride D + 4 (conflict-free float4 reads),
// the p tile aliased onto the k tile: 99 KB at D = 128, two CTAs per SM.
#include <cuda_runtime.h>

namespace {

constexpr int TQ = 64;   // query rows per CTA
constexpr int TK = 64;   // key rows per tile
constexpr int NT = 256;
constexpr int LP = TK + 4;  // row stride of the p tile
constexpr float NEG = -1e30f;

template <int D>
struct Layout {
  static constexpr int LD = D + 4;  // row stride of the q, k, v tiles
  static constexpr int KP = (TK * LD > TQ * LP) ? TK * LD : TQ * LP;  // k tile / p tile
  static constexpr int FLOATS = TQ * LD + KP + TK * LD;
};

// rows x D floats, contiguous at src, into dst at row stride D + 4; rows past
// `rows` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int rows) {
  constexpr int V4 = D / 4;
  for (int t = threadIdx.x; t < TK * V4; t += NT) {
    const int r = t / V4, c4 = t - (t / V4) * V4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) x = reinterpret_cast<const float4*>(src)[(size_t)r * V4 + c4];
    *reinterpret_cast<float4*>(dst + r * (D + 4) + c4 * 4) = x;
  }
}

// s[i][j] = q[ty + 16 i] . k[tx + 16 j], summed over d in ascending order.
template <int D>
__device__ __forceinline__ void tile_scores(const float* Qs, const float* Ks, int tx, int ty,
                                            float s[4][4]) {
  constexpr int LD = Layout<D>::LD;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
      }
  }
}

// Key tile t of a CTA: tiles 0 .. nkt-1 of leaf i-1 (when leaf > 0), then
// tiles 0 .. qt of leaf i.
struct KeyTile {
  size_t off;   // element offset of the tile's first row in k / v
  int rows;     // valid key rows
  bool causal;  // the diagonal tile: key col visible iff col <= query row
};

__device__ __forceinline__ KeyTile key_tile(int t, size_t leaf_off, size_t prev_off, bool has_prev,
                                            int nkt, int qt, int c, int D) {
  KeyTile kt;
  int tile;
  if (has_prev && t < nkt) {
    tile = t;
    kt.off = prev_off + (size_t)tile * TK * D;
    kt.causal = false;
  } else {
    tile = has_prev ? t - nkt : t;
    kt.off = leaf_off + (size_t)tile * TK * D;
    kt.causal = tile == qt;
  }
  kt.rows = min(TK, c - tile * TK);
  return kt;
}

template <int D>
__global__ void __launch_bounds__(NT, 2)
nearfield_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ num, float* __restrict__ den,
                 float* __restrict__ mout, int nl, int c, int nqt) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = Layout<D>::LD;
  constexpr int DC = D / 16;               // num columns per thread
  constexpr int CW = DC < 4 ? DC : 4;      // contiguous run of them
  constexpr int NG = DC / CW;              // runs: column g * 16 CW + tx CW + e
  float* Qs = smem;
  float* Ks = smem + TQ * LD;
  float* Ps = Ks;                          // pass 2: p tile over the k tile
  float* Vs = Ks + Layout<D>::KP;

  const int qt = blockIdx.x % nqt;
  const long long bl = blockIdx.x / nqt;   // bh * nl + leaf
  const int leaf = (int)(bl % nl);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t leaf_off = (size_t)bl * c * D;
  const size_t prev_off = leaf_off - (size_t)c * D;
  const bool has_prev = leaf > 0;
  const int q0 = qt * TQ;
  const int nkt = nqt;
  const int n_tiles = (has_prev ? nkt : 0) + qt + 1;

  load_tile<D>(Qs, q + leaf_off + (size_t)q0 * D, min(TQ, c - q0));

  // pass 1: the exact row max over every visible score
  float rmax[4] = {NEG, NEG, NEG, NEG};
  for (int t = 0; t < n_tiles; ++t) {
    const KeyTile kt = key_tile(t, leaf_off, prev_off, has_prev, nkt, qt, c, D);
    __syncthreads();
    load_tile<D>(Ks, k + kt.off, kt.rows);
    __syncthreads();
    float s[4][4];
    tile_scores<D>(Qs, Ks, tx, ty, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const bool vis = col < kt.rows && (!kt.causal || col <= ty + 16 * i);
        if (vis) rmax[i] = fmaxf(rmax[i], s[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      rmax[i] = fmaxf(rmax[i], __shfl_xor_sync(0xffffffffu, rmax[i], off));

  // pass 2: p = exp(s - m), den and num
  float rden[4] = {0.f, 0.f, 0.f, 0.f};
  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DC; ++e) acc[i][e] = 0.0f;
  for (int t = 0; t < n_tiles; ++t) {
    const KeyTile kt = key_tile(t, leaf_off, prev_off, has_prev, nkt, qt, c, D);
    __syncthreads();
    load_tile<D>(Ks, k + kt.off, kt.rows);
    load_tile<D>(Vs, v + kt.off, kt.rows);
    __syncthreads();
    float s[4][4];
    tile_scores<D>(Qs, Ks, tx, ty, s);
    __syncthreads();                       // every read of Ks is done: Ps may overwrite it
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const bool vis = col < kt.rows && (!kt.causal || col <= ty + 16 * i);
        const float p = vis ? expf(s[i][j] - rmax[i]) : 0.0f;
        rden[i] += p;
        Ps[(ty + 16 * i) * LP + col] = p;
      }
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < TK; kk += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p4[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * LP + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = Vs + (kk + u) * LD + tx * CW;
        float vv[DC];
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          if constexpr (CW == 4) {
            const float4 x = *reinterpret_cast<const float4*>(vrow + g * 16 * CW);
            vv[g * CW] = x.x; vv[g * CW + 1] = x.y; vv[g * CW + 2] = x.z; vv[g * CW + 3] = x.w;
          } else if constexpr (CW == 2) {
            const float2 x = *reinterpret_cast<const float2*>(vrow + g * 16 * CW);
            vv[g * CW] = x.x; vv[g * CW + 1] = x.y;
          } else {
            vv[g] = vrow[g * 16];
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? p4[i].x : u == 1 ? p4[i].y : u == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int e = 0; e < DC; ++e) acc[i][e] = fmaf(p, vv[e], acc[i][e]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      rden[i] += __shfl_xor_sync(0xffffffffu, rden[i], off);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= c) continue;
    const size_t row = (size_t)bl * c + r;
    float* out = num + row * D + tx * CW;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < CW; ++e) out[g * 16 * CW + e] = acc[i][g * CW + e];
    if (tx == 0) {
      den[row] = rden[i];
      mout[row] = rmax[i];
    }
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* num, float* den, float* m,
           int bh, int nl, int c, cudaStream_t s) {
  const int nqt = (c + TQ - 1) / TQ;
  const long long blocks = (long long)bh * nl * nqt;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int bytes = Layout<D>::FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(nearfield_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  nearfield_kernel<D><<<(unsigned)blocks, NT, bytes, s>>>(q, k, v, num, den, m, nl, c, nqt);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, num: (bh, nl, c, d); den, m: (bh, nl, c); f32 contiguous, q
// pre-scaled.  d in {16, 32, 64, 128} (cudaErrorInvalidValue otherwise).
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
