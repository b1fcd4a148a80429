// Kernel functions phi(y, y') as device code, shared by the CUDA kernels.
//
// Same maths as src/repro/kernels/_phi.py (pairwise_sqdist_t and
// phi_from_sqdist) and its plain PyTorch twin src/repro_torch/kernels/phi.py:
// squared distances are summed as DIRECT differences, dimension by
// dimension, and the Matern kernel uses the Abramowitz & Stegun K_1
// polynomials in float32.  The kernel is a template argument so the inner
// loops carry no branch on it.
#pragma once

#include <cuda_runtime.h>

namespace repro {

enum KernelId { KERNEL_GAUSSIAN = 0, KERNEL_MATERN = 1 };

template <int D>
__device__ __forceinline__ float sqdist_direct(const float* a, const float* b) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const float diff = a[k] - b[k];
    acc = (k == 0) ? diff * diff : acc + diff * diff;
  }
  return acc;
}

// Modified Bessel function K_1 (A&S 9.8.7 for x <= 2, 9.8.8 above).
__device__ __forceinline__ float bessel_k1(float x) {
  if (x <= 2.0f) {
    float t = x / 3.75f;
    t = t * t;
    const float i1 = x * (0.5f + t * (0.87890594f + t * (0.51498869f + t * (0.15084934f
        + t * (0.02658733f + t * (0.00301532f + t * 0.00032411f))))));
    float u = x / 2.0f;
    u = u * u;
    const float p = 1.0f + u * (0.15443144f + u * (-0.67278579f + u * (-0.18156897f
        + u * (-0.01919402f + u * (-0.00110404f + u * (-0.00004686f))))));
    return logf(x / 2.0f) * i1 + p / x;
  }
  const float w = 2.0f / x;
  const float q = 1.25331414f + w * (0.23498619f + w * (-0.03655620f + w * (0.01504268f
      + w * (-0.00780353f + w * (0.00325614f + w * (-0.00068245f))))));
  return expf(-x) / sqrtf(x) * q;
}

// phi from a squared distance; matern_norm = 2^(beta-1) Gamma(beta),
// beta = d/2 + 1, computed on the host.
template <int K>
__device__ __forceinline__ float phi_from_sqdist(float d2, float matern_norm) {
  if (K == KERNEL_GAUSSIAN) {
    return expf(-d2);
  }
  const float r = sqrtf(fmaxf(d2, 0.0f));
  const float val = (r > 1e-8f) ? r * bessel_k1(fmaxf(r, 1e-30f)) : 1.0f;
  return val / matern_norm;
}

}  // namespace repro
