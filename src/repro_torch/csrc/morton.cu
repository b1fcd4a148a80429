// Morton (Z-order) codes of points in the unit box, one int64 per point.
//
// Replaces the TPU kernel src/repro/kernels/morton/kernel.py:
// morton_encode_t (body _kernel), which emits the code as two uint32 planes
// (hi, lo) from lane-major (d, N) tiles.  Here the code is one int64,
// (hi << 32) | lo: at most 63 interleaved bits, so it stays non-negative and
// a stable sort on it is the reference's lexicographic sort on (hi, lo).
//
// Bound on the H100: bytes.  Each point reads d floats and writes 8 bytes;
// at N = 2^20, d = 2 that is 16 MiB, about 5 us at 3.35 TB/s.
//
// Design: each thread encodes two consecutive points: one 16-byte load at
// d = 2 (8-byte loads at d = 1 and 3) and one 16-byte store of the two
// codes, so that a warp's loads and stores are contiguous; the last point
// of an odd N, and bases that are not 16-byte aligned, go point by point.
// The quantiser keeps the reference's trap: the scale float32(2^nb - 1)
// rounds up to 2^nb for nb >= 25, so the fixed-point value is clamped to
// 2^nb - 1 after the float -> integer cast (nb = min(32, 63 / d)).  The bits are spread by magic numbers in
// ceil(log2 nb) shift / or / mask steps instead of one bit at a time:
//   d = 1  the code is the value;
//   d = 2  nb = 31: the low 16 bits of both coordinates make the code's low
//          32 bits and the high 15 its high 32, each spread in 4 steps of
//          32-bit arithmetic (the H100 has no 64-bit integer unit);
//   d = 3  nb = 21: the 64-bit spread to every third bit, 5 steps.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NT = 256;

// bits 0..15 of x to the even bits of a 32-bit word
__device__ __forceinline__ unsigned spread2(unsigned x) {
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;
  x = (x | (x << 1)) & 0x55555555u;
  return x;
}

// bits 0..20 of x to bits 0, 3, 6, ..., 60
__device__ __forceinline__ unsigned long long spread3(unsigned long long x) {
  x = (x | (x << 32)) & 0x001F00000000FFFFull;
  x = (x | (x << 16)) & 0x001F0000FF0000FFull;
  x = (x | (x << 8)) & 0x100F00F00F00F00Full;
  x = (x | (x << 4)) & 0x10C30C30C30C30C3ull;
  x = (x | (x << 2)) & 0x1249249249249249ull;
  return x;
}

template <int D>
__device__ __forceinline__ long long encode(const float* x) {
  constexpr int NB = (63 / D) < 32 ? (63 / D) : 32;
  const float scale = (float)((double)(1ull << NB) - 1.0);
  const long long qmax = (long long)((1ull << NB) - 1ull);
  long long q[D];
#pragma unroll
  for (int dim = 0; dim < D; ++dim) {
    const float v = fminf(fmaxf(x[dim], 0.0f), 1.0f);
    const long long t = (long long)(v * scale);   // truncation toward zero
    q[dim] = t < qmax ? t : qmax;
  }
  if constexpr (D == 1) {
    return q[0];
  } else if constexpr (D == 2) {
    const unsigned a = (unsigned)q[0], b = (unsigned)q[1];
    const unsigned lo = spread2(a & 0xFFFFu) | (spread2(b & 0xFFFFu) << 1);
    const unsigned hi = spread2(a >> 16) | (spread2(b >> 16) << 1);
    return (long long)(((unsigned long long)hi << 32) | lo);
  } else {
    return (long long)(spread3((unsigned long long)q[0]) |
                       (spread3((unsigned long long)q[1]) << 1) |
                       (spread3((unsigned long long)q[2]) << 2));
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
morton_kernel(const float* __restrict__ coords, long long* __restrict__ codes, int n, int vec) {
  const long long p0 = ((long long)blockIdx.x * NT + threadIdx.x) * 2;   // two points a thread
  if (p0 >= n) return;
  if (vec && p0 + 2 <= n) {
    float x[2 * D];
    if constexpr (D == 2) {
      const float4 v = *reinterpret_cast<const float4*>(coords + p0 * D);
      x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    } else {
      const float2* src = reinterpret_cast<const float2*>(coords + p0 * D);
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const float2 v = src[i];
        x[2 * i] = v.x; x[2 * i + 1] = v.y;
      }
    }
    *reinterpret_cast<longlong2*>(codes + p0) = make_longlong2(encode<D>(x), encode<D>(x + D));
  } else {
    for (int i = 0; i < 2 && p0 + i < n; ++i) codes[p0 + i] = encode<D>(coords + (p0 + i) * D);
  }
}

template <int D>
int launch(const float* coords, long long* codes, int n, cudaStream_t s) {
  const auto aligned = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  const long long threads = ((long long)n + 1) / 2;
  morton_kernel<D><<<(unsigned)((threads + NT - 1) / NT), NT, 0, s>>>(
      coords, codes, n, aligned(coords) && aligned(codes));
  return (int)cudaGetLastError();
}

}  // namespace

// coords: (n, d) f32 contiguous in [0, 1]^d (values outside clip to the
// box; any 4-byte aligned base); codes: (n,) int64.  d in {1, 2, 3}
// (cudaErrorInvalidValue otherwise).  Returns cudaGetLastError() after the
// launch.
extern "C" int repro_morton_encode(const float* coords, long long* codes, int n, int d,
                                   void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return launch<1>(coords, codes, n, s);
    case 2: return launch<2>(coords, codes, n, s);
    case 3: return launch<3>(coords, codes, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
