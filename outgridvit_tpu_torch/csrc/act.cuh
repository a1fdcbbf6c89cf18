// Activations of the fused MLP branch and their derivatives, in fp32 (the
// codes the Python wrappers pass: 0 = gelu, 1 = silu, 2 = relu). GELU is the
// exact erf form; its derivative is the one of
// outgridvit_tpu/ops/mlp_branch_pallas.py:_gelu_grad32.
#pragma once

#include <cuda_runtime.h>

namespace ogvt {

enum Act : int { kGelu = 0, kSilu = 1, kRelu = 2 };

template <int ACT>
__device__ __forceinline__ float act_f32(float x) {
  if constexpr (ACT == kGelu) {
    return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
  } else if constexpr (ACT == kSilu) {
    return x / (1.f + expf(-x));
  } else {
    return fmaxf(x, 0.f);
  }
}

template <int ACT>
__device__ __forceinline__ float act_grad_f32(float x) {
  if constexpr (ACT == kGelu) {
    return 0.5f * (1.f + erff(x * 0.70710678118654752f)) +
           x * 0.3989422804014327f * expf(-0.5f * x * x);
  } else if constexpr (ACT == kSilu) {
    const float s = 1.f / (1.f + expf(-x));
    return s * (1.f + x * (1.f - s));
  } else {
    return x > 0.f ? 1.f : 0.f;
  }
}

}  // namespace ogvt
