// Activations of the fused MLP branch and their derivatives, in fp32 (the
// codes the Python wrappers pass: 0 = gelu, 1 = silu, 2 = relu). GELU is the
// exact erf form; its derivative is the one of
// outgridvit_tpu/ops/mlp_branch_pallas.py:_gelu_grad32.
//
// Each function is written once in terms of the one transcendental it
// shares with the other (erf for GELU, exp for SiLU), so that
// act_and_grad_f32, which computes it once for both, gives bitwise the
// values of act_f32 and act_grad_f32.
#pragma once

#include <cuda_runtime.h>

namespace ogvt {

enum Act : int { kGelu = 0, kSilu = 1, kRelu = 2 };

// The transcendental act and act' share: erf(x / sqrt 2) for GELU, 1 +
// exp(-x) for SiLU, nothing for ReLU.
template <int ACT>
__device__ __forceinline__ float act_shared(float x) {
  if constexpr (ACT == kGelu) {
    return erff(x * 0.70710678118654752f);
  } else if constexpr (ACT == kSilu) {
    return 1.f + expf(-x);
  } else {
    return 0.f;
  }
}

template <int ACT>
__device__ __forceinline__ float act_from(float x, float e) {
  if constexpr (ACT == kGelu) {
    return 0.5f * x * (1.f + e);
  } else if constexpr (ACT == kSilu) {
    return x / e;
  } else {
    return fmaxf(x, 0.f);
  }
}

template <int ACT>
__device__ __forceinline__ float act_grad_from(float x, float e) {
  if constexpr (ACT == kGelu) {
    return 0.5f * (1.f + e) + x * 0.3989422804014327f * expf(-0.5f * x * x);
  } else if constexpr (ACT == kSilu) {
    const float s = 1.f / e;
    return s * (1.f + x * (1.f - s));
  } else {
    return x > 0.f ? 1.f : 0.f;
  }
}

template <int ACT>
__device__ __forceinline__ float act_f32(float x) {
  return act_from<ACT>(x, act_shared<ACT>(x));
}

template <int ACT>
__device__ __forceinline__ float act_grad_f32(float x) {
  return act_grad_from<ACT>(x, act_shared<ACT>(x));
}

// act_f32(x) and act_grad_f32(x) with their shared transcendental once.
template <int ACT>
__device__ __forceinline__ void act_and_grad_f32(float x, float& a,
                                                 float& g) {
  const float e = act_shared<ACT>(x);
  a = act_from<ACT>(x, e);
  g = act_grad_from<ACT>(x, e);
}

}  // namespace ogvt
