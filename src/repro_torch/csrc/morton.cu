// Morton (Z-order) codes of points in the unit box, one int64 per point.
//
// Replaces the TPU kernel src/repro/kernels/morton/kernel.py:
// morton_encode_t (body _kernel), which emits the code as two uint32 planes
// (hi, lo) from lane-major (d, N) tiles.  Here the code is one int64,
// (hi << 32) | lo: at most 63 interleaved bits, so it stays non-negative and
// a stable sort on it is the reference's lexicographic sort on (hi, lo).
//
// Bound on the H100: bytes.  Each point reads d floats and writes 8 bytes;
// at N = 2^20, d = 2 that is 16 MiB, about 5 us at 3.35 TB/s.  A
// magic-number bit spread needs ceil(log2 nb) shift / or / mask steps per
// dimension (nb = min(32, 63 / d)), about 64 int32 operations per point, 4 us
// at the int32 rate.  This kernel spreads bit by bit (about 2 nb operations
// per dimension on 64-bit words): simple, and short of the bound.
//
// Design: one thread per point, the (N, d) rows read as they lie (a warp
// reads 32 d consecutive floats), the quantiser and the interleave unrolled
// over the template dimension D.  The quantiser keeps the reference's trap:
// the scale float32(2^nb - 1) rounds up to 2^nb for nb >= 25, so the
// fixed-point value is clamped to 2^nb - 1 after the float -> integer cast.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NT = 256;

template <int D>
__global__ void __launch_bounds__(NT)
morton_kernel(const float* __restrict__ coords, long long* __restrict__ codes, int n) {
  constexpr int NB = (63 / D) < 32 ? (63 / D) : 32;
  const int p = blockIdx.x * NT + threadIdx.x;
  if (p >= n) return;
  const float scale = (float)((double)(1ull << NB) - 1.0);
  const long long qmax = (long long)((1ull << NB) - 1ull);
  long long q[D];
#pragma unroll
  for (int dim = 0; dim < D; ++dim) {
    const float x = fminf(fmaxf(coords[(size_t)p * D + dim], 0.0f), 1.0f);
    const long long v = (long long)(x * scale);   // truncation toward zero
    q[dim] = v < qmax ? v : qmax;
  }
  unsigned long long code = 0ull;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int dim = 0; dim < D; ++dim) {
      code |= (((unsigned long long)q[dim] >> b) & 1ull) << (b * D + dim);
    }
  }
  codes[p] = (long long)code;
}

}  // namespace

// coords: (n, d) f32 contiguous in [0, 1]^d (values outside clip to the
// box); codes: (n,) int64.  d in {1, 2, 3} (cudaErrorInvalidValue
// otherwise).  Returns cudaGetLastError() after the launch.
extern "C" int repro_morton_encode(const float* coords, long long* codes, int n, int d,
                                   void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)((n + NT - 1) / NT);
  switch (d) {
    case 1: morton_kernel<1><<<grid, NT, 0, s>>>(coords, codes, n); break;
    case 2: morton_kernel<2><<<grid, NT, 0, s>>>(coords, codes, n); break;
    case 3: morton_kernel<3><<<grid, NT, 0, s>>>(coords, codes, n); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
