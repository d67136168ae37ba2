// One projected-SOR update of one pixel, shared by the red-black kernels K4
// (rb_sweep_tiles) and K5 (rb_sweep_resident) in rb_sweep.cu.
//
// It computes what the TPU red-black half-sweep computes
// (realtimedepthdiffusion_tpu/ops/pallas_sweep.py:_rb_iter_full, :1175-1197)
// at a pixel of the colour being relaxed that is not scribbled:
//
//   r  = clip((wl*ul + bh*ur + wu*uu + bv*ud) * inv, 0, 255)
//   u' = clip(u + om*(r - u), 0, 255)
//
// in the plain torch version's left-to-right order (ops/rb_sweep.py:
// rb_iter_plain). Every product, sum and difference is an explicit
// round-to-nearest intrinsic: left to itself nvcc contracts u + om*(r-u)
// into one FMA, and with om near 1.97 that single rounding flips the last
// bit of the plain version's two roundings often.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ float rb_point(float u, float ul, float ur, float uu,
                                          float ud, float wl, float bh, float wu,
                                          float bv, float inv, float om) {
  float s = __fmul_rn(wl, ul);
  s = __fadd_rn(s, __fmul_rn(bh, ur));
  s = __fadd_rn(s, __fmul_rn(wu, uu));
  s = __fadd_rn(s, __fmul_rn(bv, ud));
  const float r = fminf(fmaxf(__fmul_rn(s, inv), 0.0f), 255.0f);
  const float v = __fadd_rn(u, __fmul_rn(om, __fsub_rn(r, u)));
  return fminf(fmaxf(v, 0.0f), 255.0f);
}
