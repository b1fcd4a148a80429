// Batched block-Jacobi apply Y[b] = (L[b] L[b]^T)^{-1} X[b].
//
// Replaces the TPU kernel src/repro/kernels/batched_block_solve/kernel.py:
// batched_block_cholesky_solve_t (body _chol_solve_kernel), which holds L,
// a transposed copy of L and the panel in VMEM and runs 2c axpy steps.
//
// Bound on the H100: bytes.  A two-sweep solve reads the lower triangle of
// every factor twice (forward, then back) against 2 c^2 R flops per block:
// at R = 8 about 2 flops per byte.  The paper's problem (512 blocks of
// 2048) reads 8.6 GB per call, 2.57 ms at 3.35 TB/s; the triangle does not
// fit in shared memory or, over the blocks in flight, in the L2.
//
// Design: one CTA of 256 threads per (block, chunk of RC right-hand sides),
// RC = 8 (1 for a single column); the (c, RC) chunk stays in shared memory
// for the whole solve.  Every tile of L the solve reads goes through one
// ring of NS slots filled by cp.async (16-byte copies where L is 16-byte
// aligned and c % 4 == 0), in the fixed order the solve uses them:
//   forward, row tiles j0 = 0, 32, ...: the 32 x 32 diagonal tile, then
//     the panel below it, PR = 256 rows x 32 columns a slot;
//   back, j0 from the last tile down: the diagonal tile, then the panel
//     above it read as rows of L (L[j0 .. j0 + 32, p0 .. p0 + PR) a slot:
//     L^T's columns are L's rows, so no transposed copy is built).
// Which tile comes next never depends on the data, so the copies run NS -
// 1 slots ahead of the arithmetic, across tile boundaries, and one barrier
// a slot both publishes the landed slot and frees the one before it.
//   - diagonal tile: warp q solves column q of the chunk, one lane per row
//     (its row of the tile, or its column in the back sweep, in
//     registers); at step j lane j forms the quotient (the product with
//     its pivot's reciprocal refined by one residual step: within an ulp
//     of the reference's division) and one shuffle broadcasts it; the
//     update is selected, not branched;
//   - panel: a thread updates RPT rows x CPT columns (4 x 4 at RC = 8),
//     reading a float4 of L per row (four pivots) and the solved tile's
//     values by broadcast, fused multiply-adds in ascending pivot order.
// At c = 2048 and RC = 8 a CTA holds 204 KB of shared memory, one per SM:
// P's 512 blocks run in 3.9 waves on 132 SMs, the last one 88% full.
// Each entry takes its updates in a fixed order, so results do not depend
// on the launch: no atomics.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TB = 32;          // row tile
constexpr int NT = 256;         // threads per CTA
constexpr int PR = 256;         // rows (forward) or columns (back) of a panel slot
constexpr int NS = 3;           // ring slots
constexpr int LS = TB + 4;      // row stride of a diagonal tile or forward panel
constexpr int BS = PR + 4;      // row stride of a back panel
constexpr int SLOT = PR * LS;   // floats a slot holds (>= TB * BS)
constexpr int SMEM_MAX = 227 * 1024;
static_assert(TB * BS <= SLOT, "a back panel must fit a slot");

constexpr int CPT8 = 4;         // columns a thread updates in a panel at RC = 8

template <int RC>
struct Cfg {
  static constexpr int CPT = RC == 1 ? 1 : CPT8;   // columns a thread updates in a panel
  static constexpr int NCG = RC / CPT;             // column groups
  // rows a thread updates in a panel: the CTA's threads share a slot's rows
  static constexpr int RPT = PR * NCG / NT > 0 ? PR * NCG / NT : 1;
  static constexpr int NRG = PR / RPT;             // row groups
  static constexpr int ACTIVE = NRG * NCG;         // threads of a panel update
  // row stride of the chunk: a thread's CPT columns stay aligned for one
  // vector read, and the diagonal solve's column reads meet few conflicts
  static constexpr int XS = RC == 1 ? 1 : RC + CPT;
  static_assert(ACTIVE <= NT, "a panel update needs more threads than the CTA has");
};

template <int N>
__device__ __forceinline__ void load_vec(float (&v)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

enum Kind { FWD_DIAG, FWD_PANEL, BACK_DIAG, BACK_PANEL, DONE };

// one tile of the solve's read order
struct Item {
  int kind, j0, p0;
};

__device__ __forceinline__ void advance(Item& it, int c, int last) {
  switch (it.kind) {
    case FWD_DIAG:
      if (it.j0 + TB < c) it = {FWD_PANEL, it.j0, it.j0 + TB};
      else it = {BACK_DIAG, last, 0};
      break;
    case FWD_PANEL:
      if (it.p0 + PR < c) it.p0 += PR;
      else it = {FWD_DIAG, it.j0 + TB, 0};
      break;
    case BACK_DIAG:
      if (it.j0 > 0) it = {BACK_PANEL, it.j0, 0};
      else it = {DONE, 0, 0};
      break;
    case BACK_PANEL:
      if (it.p0 + PR < it.j0) it.p0 += PR;
      else it = {BACK_DIAG, it.j0 - TB, 0};
      break;
    default:
      break;
  }
}

// a copy to shared memory; a copy of 0 source bytes writes zeros
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

// rows r0 .. r0 + ROWS and columns q0 .. q0 + COLS of L (zero outside
// rows < r_end, columns < q_end) into dst with row stride STRIDE
template <int ROWS, int COLS, int STRIDE>
__device__ __forceinline__ void copy_tile(float* dst, const float* lb, int c, int r0, int r_end,
                                          int q0, int q_end, int tid, bool vec) {
  static_assert(ROWS * COLS % (4 * NT) == 0, "the CTA's threads must share a tile evenly");
  if (vec) {
    constexpr int PER_ROW = COLS / 4;
#pragma unroll
    for (int e = 0; e < ROWS * PER_ROW / NT; ++e) {
      const int idx = tid + e * NT;
      const int r = idx / PER_ROW, q = (idx % PER_ROW) * 4;
      const bool ok = r0 + r < r_end && q0 + q < q_end;
      cp_async16(dst + r * STRIDE + q, ok ? lb + (size_t)(r0 + r) * c + q0 + q : lb, ok);
    }
  } else {
#pragma unroll 4
    for (int e = 0; e < ROWS * COLS / NT; ++e) {
      const int idx = tid + e * NT;
      const int r = idx / COLS, q = idx % COLS;
      const bool ok = r0 + r < r_end && q0 + q < q_end;
      cp_async4(dst + r * STRIDE + q, ok ? lb + (size_t)(r0 + r) * c + q0 + q : lb, ok);
    }
  }
}

__device__ __forceinline__ void copy_item(const Item& it, float* dst, const float* lb, int c,
                                          int tid, bool vec) {
  switch (it.kind) {
    case FWD_DIAG:
    case BACK_DIAG:
      copy_tile<TB, TB, LS>(dst, lb, c, it.j0, c, it.j0, c, tid, vec);
      break;
    case FWD_PANEL:
      copy_tile<PR, TB, LS>(dst, lb, c, it.p0, c, it.j0, c, tid, vec);
      break;
    case BACK_PANEL:
      copy_tile<TB, PR, BS>(dst, lb, c, it.j0, c, it.p0, it.j0, tid, vec);
      break;
    default:
      break;
  }
}

// the diagonal tile at j0 (slot t), column q of the chunk, lane = row
template <bool FORWARD, int XS>
__device__ __forceinline__ void solve_diag(const float* t, float* xs, int j0, int c, int q,
                                           int lane) {
  const int nb = min(TB, c - j0);
  float lv[TB];   // forward: the lane's row of the tile; back: its column
#pragma unroll
  for (int j = 0; j < TB; ++j) lv[j] = FORWARD ? t[lane * LS + j] : t[j * LS + lane];
  const float d = lane < nb ? t[lane * LS + lane] : 1.0f;
  const float r = 1.0f / d;
  float v = lane < nb ? xs[(j0 + lane) * XS + q] : 0.0f;
  // step jj: lane jj's value is final; it forms the quotient, one shuffle
  // broadcasts it, and the lanes still open update (selects, no branches).
  // Steps past nb meet zero rows and change nothing.
#pragma unroll
  for (int s = 0; s < TB; ++s) {
    const int jj = FORWARD ? s : TB - 1 - s;
    float yo = v * r;
    yo = fmaf(fmaf(-yo, d, v), r, yo);
    const float yq = __shfl_sync(0xffffffffu, yo, jj);
    const float upd = fmaf(-lv[jj], yq, v);
    const bool open = FORWARD ? lane > jj : lane < jj;
    v = lane == jj ? yq : (open ? upd : v);
  }
  if (lane < nb) xs[(j0 + lane) * XS + q] = v;
}

template <int RC>
__global__ void __launch_bounds__(NT)
chol_solve_kernel(const float* __restrict__ l, const float* __restrict__ x,
                  float* __restrict__ y, int c, int R, int vec) {
  using K = Cfg<RC>;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                       // NS x SLOT
  float* xs = ring + NS * SLOT;             // c32 x XS: the chunk, solved in place

  const int b = blockIdx.x;
  const int r0 = blockIdx.y * RC;
  const int nr = min(RC, R - r0);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* lb = l + (size_t)b * c * c;
  const int last = ((c - 1) / TB) * TB;
  const int c32 = last + TB;

  // the first NS - 1 tiles of the read order, one commit group each
  Item prod = {FWD_DIAG, 0, 0};
  for (int s = 0; s < NS - 1; ++s) {
    if (prod.kind != DONE) {
      copy_item(prod, ring + s * SLOT, lb, c, tid, vec);
      advance(prod, c, last);
    }
    cp_async_commit();
  }
  // the chunk, with zero rows up to a multiple of TB and zero columns
  // beyond nr (solved too, never stored)
  for (int t = tid; t < c32 * RC; t += NT) {
    const int i = t / RC, q = t - (t / RC) * RC;
    xs[i * K::XS + q] = (i < c && q < nr) ? x[((size_t)b * c + i) * R + r0 + q] : 0.0f;
  }

  const int cg = tid % K::NCG * K::CPT, rg = tid / K::NCG;  // a panel thread's columns, rows
  Item it = {FWD_DIAG, 0, 0};
  for (int i = 0; it.kind != DONE; ++i) {
    // tile i has landed (its group is the oldest of NS - 1 in flight); the
    // barrier publishes it and ends every thread's use of slot (i - 1) % NS
    cp_async_wait<NS - 2>();
    __syncthreads();
    if (prod.kind != DONE) {
      copy_item(prod, ring + ((i + NS - 1) % NS) * SLOT, lb, c, tid, vec);
      advance(prod, c, last);
    }
    cp_async_commit();

    const float* t = ring + (i % NS) * SLOT;
    if (it.kind == FWD_DIAG || it.kind == BACK_DIAG) {
      if (warp < RC) {
        if (it.kind == FWD_DIAG) solve_diag<true, K::XS>(t, xs, it.j0, c, warp, lane);
        else solve_diag<false, K::XS>(t, xs, it.j0, c, warp, lane);
      }
    } else if (tid < K::ACTIVE) {
      const int j0 = it.j0, rb = rg * K::RPT;
      const bool fwd = it.kind == FWD_PANEL;
      const int row_end = fwd ? c : j0;      // rows updated: below the tile, or above it
      float acc[K::RPT][K::CPT];
#pragma unroll
      for (int p = 0; p < K::RPT; ++p) {
        const int row = it.p0 + rb + p;
        if (row < row_end) {
          load_vec(acc[p], xs + row * K::XS + cg);
        } else {
#pragma unroll
          for (int q = 0; q < K::CPT; ++q) acc[p][q] = 0.0f;
        }
      }
      if (fwd) {
        // X[row] -= L[row, tile] Y[tile]: a float4 of four pivots of each row
#pragma unroll 2
        for (int k0 = 0; k0 < TB; k0 += 4) {
          float a[K::RPT][4];
#pragma unroll
          for (int p = 0; p < K::RPT; ++p) load_vec(a[p], t + (rb + p) * LS + k0);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            float yv[K::CPT];
            load_vec(yv, xs + (j0 + k0 + kk) * K::XS + cg);
#pragma unroll
            for (int p = 0; p < K::RPT; ++p)
#pragma unroll
              for (int q = 0; q < K::CPT; ++q) acc[p][q] = fmaf(-a[p][kk], yv[q], acc[p][q]);
          }
        }
      } else {
        // X[row] -= L[tile, row]^T Y[tile]: the slot holds L's rows of the
        // tile, so a thread's rows are neighbouring columns of each
#pragma unroll 8
        for (int jj = 0; jj < TB; ++jj) {
          float yv[K::CPT], a[K::RPT];
          load_vec(yv, xs + (j0 + jj) * K::XS + cg);
          load_vec(a, t + jj * BS + rb);
#pragma unroll
          for (int p = 0; p < K::RPT; ++p)
#pragma unroll
            for (int q = 0; q < K::CPT; ++q) acc[p][q] = fmaf(-a[p], yv[q], acc[p][q]);
        }
      }
#pragma unroll
      for (int p = 0; p < K::RPT; ++p) {
        const int row = it.p0 + rb + p;
        if (row < row_end) {
#pragma unroll
          for (int q = 0; q < K::CPT; ++q) xs[row * K::XS + cg + q] = acc[p][q];
        }
      }
    }
    advance(it, c, last);
  }
  __syncthreads();

  for (int t = tid; t < c * RC; t += NT) {
    const int i = t / RC, q = t - (t / RC) * RC;
    if (q < nr) y[((size_t)b * c + i) * R + r0 + q] = xs[i * K::XS + q];
  }
}

template <int RC>
size_t smem_bytes(int c) {
  return sizeof(float) * ((size_t)NS * SLOT + (size_t)((c + TB - 1) / TB * TB) * Cfg<RC>::XS);
}

template <int RC>
int max_c() {
  return (int)((SMEM_MAX / sizeof(float) - NS * SLOT) / Cfg<RC>::XS) / TB * TB;
}

template <int RC>
int launch(const float* l, const float* x, float* y, int B, int c, int R, cudaStream_t s) {
  if (c > max_c<RC>() || (R + RC - 1) / RC > 65535)
    return (int)cudaErrorInvalidValue;
  // the cap on dynamic shared memory, raised once per device (bit = device)
  static unsigned long long raised = 0;
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (!(raised >> (dev & 63) & 1)) {
    err = (int)cudaFuncSetAttribute(chol_solve_kernel<RC>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err) return err;
    raised |= 1ull << (dev & 63);
  }
  const int vec = reinterpret_cast<uintptr_t>(l) % 16 == 0 && c % 4 == 0;
  chol_solve_kernel<RC><<<dim3(B, (R + RC - 1) / RC), NT, smem_bytes<RC>(c), s>>>(l, x, y, c,
                                                                                  R, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Largest c the kernel takes for a given R (the chunk, c rounded up to a
// multiple of 32 rows, must fit in shared memory beside the ring); the
// wrapper checks it before launching.
extern "C" int repro_chol_solve_max_c(int R) { return R == 1 ? max_c<1>() : max_c<8>(); }

// l: (B, c, c) lower factors, x: (B, c, R), y: (B, c, R); f32 contiguous.
extern "C" int repro_block_cholesky_solve(const float* l, const float* x, float* y, int B,
                                          int c, int R, void* stream) {
  if (B <= 0 || c <= 0 || R <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (R == 1) ? launch<1>(l, x, y, B, c, R, s) : launch<8>(l, x, y, B, c, R, s);
}
