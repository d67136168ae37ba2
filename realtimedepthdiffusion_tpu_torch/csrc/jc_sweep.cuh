// One Jacobi-Chebyshev update of one pixel, shared by the sweep kernels K1
// (jc_sweep_tiles) and K2 (jc_sweep_resident) in sweep.cu and K6
// (jc_sweep_fused) in fused_sweep.cu.
//
// It computes what the TPU sweep computes
// (realtimedepthdiffusion_tpu/ops/pallas_sweep.py:_sweep_full, :80-100):
//
//   r     = clip((wl*ul + bh*ur + wu*uu + bv*ud) * inv, 0, 255)
//   out   = a*r + b*u + c*prev
//   u'    = mask ? u : out,   prev' = u
//
// in the (a, b, c) form of the Chebyshev update and in the plain torch
// version's left-to-right order (ops/sweep.py:sweep_plain). Every product
// and sum is an explicit round-to-nearest intrinsic: left to itself nvcc
// contracts a*r + b*u + c*p into FMAs, which round once instead of twice
// and would make the kernels differ from the plain version in the last bit.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ float jc_point(float ul, float ur, float uu, float ud,
                                          float u, float prev, float wl, float bh,
                                          float wu, float bv, float inv,
                                          unsigned char m, float a, float b,
                                          float c) {
  float s = __fmul_rn(wl, ul);
  s = __fadd_rn(s, __fmul_rn(bh, ur));
  s = __fadd_rn(s, __fmul_rn(wu, uu));
  s = __fadd_rn(s, __fmul_rn(bv, ud));
  float r = fminf(fmaxf(__fmul_rn(s, inv), 0.0f), 255.0f);
  float out = __fmul_rn(a, r);
  out = __fadd_rn(out, __fmul_rn(b, u));
  out = __fadd_rn(out, __fmul_rn(c, prev));
  return m ? u : out;
}
