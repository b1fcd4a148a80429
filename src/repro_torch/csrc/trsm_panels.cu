// Batched panel triangular solve Y[b] = L[b]^-1 X[b] (forward substitution).
//
// Replaces the TPU kernel src/repro/kernels/batched_trsm_lowrank/kernel.py:
// batched_trsm_panels_t (body _trsm_kernel): the TRSM task of the H-Cholesky
// schedule, one program per tile with L and the panel in VMEM and c axpy
// steps.  H-LU sends it the dense tiles of an elimination column as
// transposed (c, c) panels and the V factors of its low-rank tiles as
// (c, kp) panels, all against one freshly factored L_tt (batch stride 0).
//
// Bound on the H100: operations (c^2 P flops per panel against 2 c P floats
// moved, L read once for the batch); at small batches the latency of the
// diagonal tiles' dependency chains.
//
// Design: blocked right-looking substitution, fp32 SIMT.  One CTA of 256
// threads per (panel, chunk of RC columns), RC in {32, 16, 8, 4} picked by
// the wrapper (the widest whose (c, RC) chunk fits in shared memory, and
// narrower where the grid would leave SMs idle).
// Row tiles of TB = 32 rows:
//  - diagonal tile: every warp solves its RC / 8 columns at once, one lane
//    per row, in ascending pivot order with the pivot clamped at 1e-30 as
//    the reference.  At step j lane j forms the quotient (the product with
//    its clamped pivot's reciprocal, refined by one residual step: within an
//    ulp of the reference's division) and one shuffle broadcasts it; the
//    update is selected, not branched, so the columns' chains overlap;
//  - off-diagonal update X[rows below] -= L[rows below, tile] Y[tile], a
//    small GEMM over L's panel 128 rows at a time, each thread a 4 x RC/8
//    register tile (2 x 1 at RC = 4), every thread with rows; it reads a
//    float4 of four pivots of each of its rows (a quarter warp shares its
//    rows: broadcast), then Y's four rows.
// L's tiles are staged by cp.async in their row layout (rows padded to 36
// floats), with 16-byte copies where L is 16-byte aligned and c % 4 == 0,
// else 4-byte; the chunk likewise where its rows allow.  Each lane keeps its
// row of the diagonal tile in registers.  The copies run ahead: a step's
// diagonal tile while the previous step's panels are applied, its first
// panel while its diagonal tile is solved, each later panel while the pass
// before it is applied.  Each entry takes its updates in ascending pivot
// order (fused multiply-adds), so results do not depend on the launch: no
// atomics.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TB = 32;          // row tile: the diagonal tile and the update's depth
constexpr int NT = 256;         // threads per CTA
constexpr int LROWS = 128;      // rows of L's panel staged per pass
constexpr int LS = TB + 4;      // row stride of L's staged tiles: float4 rows
constexpr int DS = TB * LS;
constexpr float TINY = 1e-30f;
constexpr int SMEM_MAX = 227 * 1024;

template <int RC>
struct Cfg {
  static constexpr int NCG = RC < 8 ? RC : 8;   // column groups
  static constexpr int CPT = RC / NCG;          // columns per thread
  static constexpr int NRG = NT / NCG;          // row groups
  static constexpr int RPT = LROWS / NRG;       // rows per thread
  static constexpr int CPW = (RC + 7) / 8;      // diagonal-tile columns per warp
  // row stride of the chunk: vector reads of CPT floats stay aligned, and
  // the diagonal tile's column reads meet few bank conflicts
  static constexpr int XS = RC == 32 ? 36 : RC == 16 ? 20 : RC + 1;
};

// a 4-byte copy to shared memory; a copy of 0 source bytes writes zero
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void load_vec(float (&v)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

// rows p0 .. p0 + rows of L's column block j0 .. j0 + TB (zero outside c)
// into dst, row stride LS: 16-byte copies when vec (L 16-byte aligned, c % 4
// == 0; a quarter warp copies one row), else 4-byte
template <int ROWS>
__device__ __forceinline__ void copy_block(float* dst, const float* lb, int c, int j0, int p0,
                                           int tid, bool vec) {
  if (vec) {
#pragma unroll
    for (int e = 0; e < ROWS * (TB / 4) / NT; ++e) {
      const int idx = tid + e * NT;
      const int r = idx >> 3, k = (idx & 7) * 4;
      const bool ok = p0 + r < c && j0 + k < c;
      cp_async16(dst + r * LS + k, ok ? lb + (size_t)(p0 + r) * c + j0 + k : lb, ok);
    }
  } else {
#pragma unroll 4
    for (int e = 0; e < ROWS * TB / NT; ++e) {
      const int idx = tid + e * NT;
      const int r = idx >> 5, k = idx & 31;
      const bool ok = p0 + r < c && j0 + k < c;
      cp_async4(dst + r * LS + k, ok ? lb + (size_t)(p0 + r) * c + j0 + k : lb, ok);
    }
  }
}

template <int RC>
__global__ void __launch_bounds__(NT)
trsm_kernel(const float* __restrict__ l, long long l_stride, const float* __restrict__ x,
            float* __restrict__ y, int c, int P, int vec_l, int vec_x) {
  using K = Cfg<RC>;
  extern __shared__ __align__(16) float smem[];
  float* s_lp = smem;                       // 2 x LROWS x LS: L's panels
  float* s_ld = s_lp + 2 * LROWS * LS;      // TB x LS: the diagonal tile
  float* xs = s_ld + DS;                    // c4 x XS: the panel chunk, solved in place

  const long long b = blockIdx.x;
  const int r0 = blockIdx.y * RC;
  const int nr = min(RC, P - r0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cg = tid % K::NCG, rg = tid / K::NCG;
  const float* lb = l + b * l_stride;
  const float* xb = x + b * c * (long long)P;
  float* yb = y + b * c * (long long)P;

  // the chunk, with zero rows up to a multiple of 4 (the update reads Y
  // four rows at a time)
  const int c4 = (c + 3) & ~3;
  if (vec_x) {
    for (int t = tid; t < c4 * (RC / 4); t += NT) {
      const int i = t / (RC / 4), q = (t - i * (RC / 4)) * 4;
      const bool ok = i < c && q < nr;
      cp_async16(xs + i * K::XS + q, ok ? xb + (size_t)i * P + r0 + q : xb, ok);
    }
  } else {
    for (int t = tid; t < c4 * RC; t += NT) {
      const int i = t / RC, q = t - (t / RC) * RC;
      const bool ok = i < c && q < nr;
      cp_async4(xs + i * K::XS + q, ok ? xb + (size_t)i * P + r0 + q : xb, ok);
    }
  }
  copy_block<TB>(s_ld, lb, c, 0, 0, tid, vec_l);
  cp_async_commit();
  if (TB < c) copy_block<LROWS>(s_lp, lb, c, 0, TB, tid, vec_l);
  cp_async_commit();

  int slot = 0;                             // the panel buffer of the next pass
  for (int j0 = 0; j0 < c; j0 += TB) {
    const int nb = min(TB, c - j0);
    // this step's diagonal tile has landed; its first panel may still be
    // in flight (the most recent group)
    cp_async_wait<1>();
    __syncthreads();

    // diagonal tile: warp w solves columns w * CPW ..., lane = row
    if (warp * K::CPW < RC) {
      float lrow[TB];                                          // lane's row of the tile
#pragma unroll
      for (int k = 0; k < TB; k += 4) {
        const float4 t = *reinterpret_cast<const float4*>(s_ld + lane * LS + k);
        lrow[k] = t.x; lrow[k + 1] = t.y; lrow[k + 2] = t.z; lrow[k + 3] = t.w;
      }
      const float dl = s_ld[lane * LS + lane];
      const float dmine = fabsf(dl) > TINY ? dl : TINY;      // lane's clamped pivot
      const float rmine = 1.0f / dmine;
      float v[K::CPW];
#pragma unroll
      for (int q = 0; q < K::CPW; ++q)
        v[q] = (lane < nb) ? xs[(j0 + lane) * K::XS + warp * K::CPW + q] : 0.0f;
      // step jj: lane jj's value is final; it forms the quotient with its
      // own pivot, one shuffle broadcasts it, and the lanes below update
      // (selects, no branches: the columns' chains overlap).  Steps past nb
      // meet zero rows and change nothing.
#pragma unroll
      for (int jj = 0; jj < TB; ++jj) {
#pragma unroll
        for (int q = 0; q < K::CPW; ++q) {
          float yo = v[q] * rmine;
          yo = fmaf(fmaf(-yo, dmine, v[q]), rmine, yo);
          const float yq = __shfl_sync(0xffffffffu, yo, jj);
          const float upd = fmaf(-lrow[jj], yq, v[q]);
          v[q] = lane == jj ? yq : (lane > jj ? upd : v[q]);
        }
      }
      if (lane < nb) {
#pragma unroll
        for (int q = 0; q < K::CPW; ++q) xs[(j0 + lane) * K::XS + warp * K::CPW + q] = v[q];
      }
    }

    // off-diagonal update of the rows below, LROWS at a time
    for (int p0 = j0 + nb; p0 < c; p0 += LROWS) {
      cp_async_wait<0>();
      __syncthreads();
      // ahead: at the first pass the next step's diagonal tile (this step's
      // diagonal solve is done), then the next pass's panel or, at the last
      // pass, the next step's first panel; two groups, in that order
      if (p0 == j0 + nb) copy_block<TB>(s_ld, lb, c, j0 + TB, j0 + TB, tid, vec_l);
      cp_async_commit();
      if (p0 + LROWS < c) {
        copy_block<LROWS>(s_lp + (slot ^ 1) * LROWS * LS, lb, c, j0, p0 + LROWS, tid, vec_l);
      } else if (j0 + 2 * TB < c) {
        copy_block<LROWS>(s_lp + (slot ^ 1) * LROWS * LS, lb, c, j0 + TB, j0 + 2 * TB, tid, vec_l);
      }
      cp_async_commit();

      const int rb = rg * K::RPT;              // first row of this thread in the pass
      const float* pan = s_lp + slot * LROWS * LS + rb * LS;
      float acc[K::RPT][K::CPT];
#pragma unroll
      for (int i = 0; i < K::RPT; ++i) {
        const int row = p0 + rb + i;
#pragma unroll
        for (int q = 0; q < K::CPT; ++q)
          acc[i][q] = row < c ? xs[row * K::XS + cg * K::CPT + q] : 0.0f;
      }
      // four pivots at a time: a float4 of each of the thread's rows of L
      // (a quarter warp shares its rows: broadcast), then Y's rows
#pragma unroll 1
      for (int k0 = 0; k0 < nb; k0 += 4) {
        float a[K::RPT][4];
#pragma unroll
        for (int i = 0; i < K::RPT; ++i) load_vec(a[i], pan + i * LS + k0);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float bv[K::CPT];
          load_vec(bv, xs + (j0 + k0 + kk) * K::XS + cg * K::CPT);
#pragma unroll
          for (int i = 0; i < K::RPT; ++i)
#pragma unroll
            for (int q = 0; q < K::CPT; ++q) acc[i][q] = fmaf(-a[i][kk], bv[q], acc[i][q]);
        }
      }
#pragma unroll
      for (int i = 0; i < K::RPT; ++i) {
        const int row = p0 + rb + i;
        if (row < c) {
#pragma unroll
          for (int q = 0; q < K::CPT; ++q) xs[row * K::XS + cg * K::CPT + q] = acc[i][q];
        }
      }
      slot ^= 1;
    }
  }
  __syncthreads();

  for (int t = tid; t < c * RC; t += NT) {
    const int i = t / RC, q = t - (t / RC) * RC;
    if (q < nr) yb[(size_t)i * P + r0 + q] = xs[i * K::XS + q];
  }
}

template <int RC>
size_t smem_bytes(int c) {
  return sizeof(float) * ((size_t)2 * LROWS * LS + DS + (size_t)((c + 3) & ~3) * Cfg<RC>::XS);
}

template <int RC>
int max_c() {
  return (int)((SMEM_MAX / sizeof(float) - 2 * LROWS * LS - DS) / Cfg<RC>::XS) & ~3;
}

template <int RC>
int launch(const float* l, long long l_stride, const float* x, float* y, int B, int c, int P,
           cudaStream_t s) {
  if (c > max_c<RC>() || (P + RC - 1) / RC > 65535) return (int)cudaErrorInvalidValue;
  // the cap on dynamic shared memory, raised once per device (bit = device)
  static unsigned long long raised = 0;
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (!(raised >> (dev & 63) & 1)) {
    err = (int)cudaFuncSetAttribute(trsm_kernel<RC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    SMEM_MAX);
    if (err) return err;
    raised |= 1ull << (dev & 63);
  }
  const auto aligned = [](const float* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  const int vec_l = aligned(l) && c % 4 == 0;
  const int vec_x = Cfg<RC>::XS % 4 == 0 && aligned(x) && P % 4 == 0;
  trsm_kernel<RC><<<dim3(B, (P + RC - 1) / RC), NT, smem_bytes<RC>(c), s>>>(
      l, l_stride, x, y, c, P, vec_l, vec_x);
  return (int)cudaGetLastError();
}

}  // namespace

// Largest c the kernel takes at chunk width rc in {32, 16, 8, 4} (its (c,
// rc) chunk must fit in shared memory, c rounded up to a multiple of 4); -1
// for another rc.  The wrapper picks rc with it and checks c.
extern "C" int repro_trsm_max_c(int rc) {
  switch (rc) {
    case 32: return max_c<32>();
    case 16: return max_c<16>();
    case 8: return max_c<8>();
    case 4: return max_c<4>();
    default: return -1;
  }
}

// Dynamic shared memory of a CTA at chunk width rc in {32, 16, 8, 4}, bytes.
extern "C" long long repro_trsm_smem_bytes(int c, int rc) {
  switch (rc) {
    case 32: return (long long)smem_bytes<32>(c);
    case 16: return (long long)smem_bytes<16>(c);
    case 8: return (long long)smem_bytes<8>(c);
    case 4: return (long long)smem_bytes<4>(c);
    default: return -1;
  }
}

// l: (B or 1, c, c) lower, with batch stride l_batch_stride floats (0 or
// c * c); x, y: (B, c, P); f32 contiguous.  rc: panel columns per CTA, in
// {32, 16, 8, 4}, with c <= repro_trsm_max_c(rc) (the wrapper's choice);
// cudaErrorInvalidValue otherwise.
extern "C" int repro_trsm_panels(const float* l, long long l_batch_stride, const float* x,
                                 float* y, int B, int c, int P, int rc, void* stream) {
  if (B <= 0 || c <= 0 || P <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rc) {
    case 32: return launch<32>(l, l_batch_stride, x, y, B, c, P, s);
    case 16: return launch<16>(l, l_batch_stride, x, y, B, c, P, s);
    case 8: return launch<8>(l, l_batch_stride, x, y, B, c, P, s);
    case 4: return launch<4>(l, l_batch_stride, x, y, B, c, P, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
