// K3 defocus_box: the exact depth-proportional box blur for Hopper (sm_90a).
//
// Replaces the TPU defocus kernel
//   realtimedepthdiffusion_tpu/ops/pallas_defocus.py:_defocus_kernel (:234)
// and its prologue defocus_half_widths (:551-566). The output is (H, W, 3)
// uint8, equal bit for bit to core/effects.py:defocus_xla and to the plain
// version ops/defocus.py:defocus_sat.
//
// Per pixel, half = min(trunc(k * max(d, 0) / 255) / 2, max_half), snapped
// onto the approx candidate set when asked; the window is rows
// [y-half, y+half-1] x cols [x-half, x+half-1] clipped to the image, and
// the output is trunc(box sum / clipped count) per channel, or the pixel
// itself where half == 0.
//
// What bounds it on the card: bytes. At 1080p the summed-area table (SAT)
// is 3 x 1081 x 1921 int32 (25 MB, written twice by the two scans and
// gathered 12 times per pixel); the arithmetic is a few integer ops per
// byte. The TPU kernel marched every candidate half over a strip because a
// per-pixel gather is slow there. A GPU gathers cheaply, so this kernel
// reads the four corners at the pixel's own half: O(1) work per pixel
// whatever the aperture, and no candidate loop at all. Its steps:
//   1. defocus_half_kernel: half per pixel, in one pinned rounding form
//      trunc(__fdiv_rn(__fmul_rn(k, max(d, 0)), 255)); left to itself the
//      compiler may reorder k*d/255, and a half-width would then flip
//      between this kernel and the plain version.
//   2. sat_rows_kernel + sat_cols_kernel: the 32-bit SAT of each channel,
//      a warp-shuffle scan along each row, then a running sum down each
//      column. The largest entry is 255*h*w: 2,115,072,000 at 2160x3840,
//      2,256,076,800 at DCI 4K (2160x4096), which passes 2^31 - 1. So the
//      SAT is unsigned, which wraps modulo 2^32 by definition (signed
//      overflow is undefined behaviour in C++).
//   3. defocus_gather_kernel: four corners, the clipped count, one
//      correctly rounded f32 divide, truncation to u8. The corner
//      difference is taken modulo 2^32 too: it equals the true box sum,
//      which is below 2^24 for any half up to 128, so wrapped entries
//      give the exact box.

#include <cuda_runtime.h>

__global__ void defocus_half_kernel(const float* __restrict__ depth,
                                    unsigned char* __restrict__ half, int n, int k,
                                    int max_half, int approx, int t, int q, int cmax) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float d = fmaxf(depth[i], 0.0f);
  const int ka = (int)__fdiv_rn(__fmul_rn((float)k, d), 255.0f);
  int hv = min(ka / 2, max_half);
  if (approx && hv > t) {
    // Round onto t + j*q, ties upward, clamped to [t, cmax].
    hv = min(max(t + ((hv - t + q / 2) / q) * q, t), cmax);
  }
  half[i] = (unsigned char)hv;
}

__global__ void sat_rows_kernel(const unsigned char* __restrict__ rgb,
                                unsigned* __restrict__ sat, int h, int w) {
  const int y = blockIdx.x;
  const int c = blockIdx.y;
  const int lane = threadIdx.x;
  const unsigned char* row = rgb + (size_t)y * w * 3 + c;
  unsigned* srow = sat + ((size_t)c * (h + 1) + y + 1) * (w + 1);
  if (lane == 0) srow[0] = 0;
  unsigned carry = 0;
  for (int x0 = 0; x0 < w; x0 += 32) {
    const int x = x0 + lane;
    unsigned v = x < w ? row[(size_t)x * 3] : 0u;
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned up = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += up;
    }
    v += carry;
    if (x < w) srow[x + 1] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

__global__ void sat_cols_kernel(unsigned* __restrict__ sat, int h, int w) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int c = blockIdx.y;
  if (x > w) return;
  unsigned* col = sat + (size_t)c * (h + 1) * (w + 1) + x;
  col[0] = 0;
  unsigned acc = 0;
  for (int y = 1; y <= h; ++y) {
    acc += col[(size_t)y * (w + 1)];
    col[(size_t)y * (w + 1)] = acc;
  }
}

__global__ void defocus_gather_kernel(const unsigned char* __restrict__ rgb,
                                      const unsigned char* __restrict__ half,
                                      const unsigned* __restrict__ sat,
                                      unsigned char* __restrict__ out, int h, int w) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= w) return;
  const size_t p = (size_t)y * w + x;
  const int hv = half[p];
  if (hv == 0) {
    out[3 * p] = rgb[3 * p];
    out[3 * p + 1] = rgb[3 * p + 1];
    out[3 * p + 2] = rgb[3 * p + 2];
    return;
  }
  const int ya = max(y - hv, 0);
  const int yb = min(y + hv, h);
  const int xa = max(x - hv, 0);
  const int xb = min(x + hv, w);
  const float cnt = (float)((yb - ya) * (xb - xa));
  const size_t plane = (size_t)(h + 1) * (w + 1);
  const size_t ra = (size_t)ya * (w + 1);
  const size_t rb = (size_t)yb * (w + 1);
  for (int c = 0; c < 3; ++c) {
    const unsigned* S = sat + c * plane;
    const int box = (int)(S[rb + xb] - S[ra + xb] - S[rb + xa] + S[ra + xa]);
    // Rounds to nearest like the reference's int32 -> f32 convert; exact
    // while box < 2^24 (any half up to 128).
    out[3 * p + c] = (unsigned char)(int)__fdiv_rn((float)box, cnt);
  }
}

extern "C" int defocus_box(const unsigned char* rgb, const float* depth,
                           unsigned char* half, unsigned* sat, unsigned char* out, int h,
                           int w, int k, int max_half, int approx, int exact_upto,
                           int stride, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int n = h * w;
  const int t = approx ? exact_upto : 0;
  const int cmax = approx ? t + (max_half - t) / stride * stride : max_half;
  cudaError_t err;
  defocus_half_kernel<<<(n + 255) / 256, 256, 0, s>>>(depth, half, n, k, max_half, approx,
                                                      t, stride, cmax);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sat_rows_kernel<<<dim3(h, 3), 32, 0, s>>>(rgb, sat, h, w);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sat_cols_kernel<<<dim3((w + 1 + 255) / 256, 3), 256, 0, s>>>(sat, h, w);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  defocus_gather_kernel<<<dim3((w + 127) / 128, h), 128, 0, s>>>(rgb, half, sat, out, h, w);
  return (int)cudaGetLastError();
}
