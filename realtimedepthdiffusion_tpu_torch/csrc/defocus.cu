// K3 defocus_box: the exact depth-proportional box blur for Hopper (sm_90a).
//
// Replaces the TPU defocus kernel
//   realtimedepthdiffusion_tpu/ops/pallas_defocus.py:_defocus_kernel (:234)
// and its prologue defocus_half_widths (:551-566). The output is (H, W, 3)
// uint8, equal bit for bit to core/effects.py:defocus_xla and to the plain
// version ops/defocus.py:defocus_sat.
//
// The entry point defocus_block runs the same SAT and gather on one block
// of a sharded image, in place of the TPU block kernel
//   realtimedepthdiffusion_tpu/ops/pallas_defocus.py:defocus_block_pallas (:569).
// Its input is the (3, hb + 2*ring, wb + 2*ring) channel-major block with a
// ring of neighbour pixels (zeros past the image), its half-widths are given
// (computed on the whole image), and its output is the (hb, wb, 3) interior.
// The SAT is taken over the extended block and each pixel reads its four
// corners there; the count clips the window against the whole image, at the
// pixel's global position (oy + y, ox + x). A whole image is the case ring
// 0, origin (0, 0) and full size (h, w), which is what defocus_box runs.
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

// An 8-bit image with 3 channels, addressed by strides in bytes: (H, W, 3)
// has (1, 3*W, 3), a channel-major (3, H, W) block (H*W, W, 1).
struct U8Image {
  const unsigned char* p;
  long long cs, ys, xs;
  __device__ __forceinline__ unsigned char at(int c, int y, int x) const {
    return p[c * cs + y * ys + x * xs];
  }
};

__global__ void sat_rows_kernel(U8Image img, unsigned* __restrict__ sat, int h, int w) {
  const int y = blockIdx.x;
  const int c = blockIdx.y;
  const int lane = threadIdx.x;
  unsigned* srow = sat + ((size_t)c * (h + 1) + y + 1) * (w + 1);
  if (lane == 0) srow[0] = 0;
  unsigned carry = 0;
  for (int x0 = 0; x0 < w; x0 += 32) {
    const int x = x0 + lane;
    unsigned v = x < w ? img.at(c, y, x) : 0u;
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

// Output pixel (y, x) of an hb x wb interior that sits at (ring, ring) in
// the image the SAT was taken over, and at (oy, ox) in a full_h x full_w
// image.
__global__ void defocus_gather_kernel(U8Image img, const unsigned char* __restrict__ half,
                                      const unsigned* __restrict__ sat,
                                      unsigned char* __restrict__ out, int hb, int wb,
                                      int ring, int oy, int ox, int full_h, int full_w) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= wb) return;
  const size_t p = (size_t)y * wb + x;
  const int hv = half[p];
  const int ly = y + ring;
  const int lx = x + ring;
  if (hv == 0) {
    out[3 * p] = img.at(0, ly, lx);
    out[3 * p + 1] = img.at(1, ly, lx);
    out[3 * p + 2] = img.at(2, ly, lx);
    return;
  }
  const int he = hb + 2 * ring;
  const int we = wb + 2 * ring;
  const int ya = max(ly - hv, 0);
  const int yb = min(ly + hv, he);
  const int xa = max(lx - hv, 0);
  const int xb = min(lx + hv, we);
  const int gy = oy + y;
  const int gx = ox + x;
  const float cnt = (float)((min(gy + hv, full_h) - max(gy - hv, 0)) *
                            (min(gx + hv, full_w) - max(gx - hv, 0)));
  const size_t plane = (size_t)(he + 1) * (we + 1);
  const size_t ra = (size_t)ya * (we + 1);
  const size_t rb = (size_t)yb * (we + 1);
  for (int c = 0; c < 3; ++c) {
    const unsigned* S = sat + c * plane;
    const int box = (int)(S[rb + xb] - S[ra + xb] - S[rb + xa] + S[ra + xa]);
    // Rounds to nearest like the reference's int32 -> f32 convert; exact
    // while box < 2^24 (any half up to 128).
    out[3 * p + c] = (unsigned char)(int)__fdiv_rn((float)box, cnt);
  }
}

// The SAT of the (hb + 2*ring) x (wb + 2*ring) image, then the gather of
// its hb x wb interior.
static int box_blur(U8Image img, const unsigned char* half, unsigned* sat,
                    unsigned char* out, int hb, int wb, int ring, int oy, int ox,
                    int full_h, int full_w, cudaStream_t s) {
  const int he = hb + 2 * ring;
  const int we = wb + 2 * ring;
  cudaError_t err;
  sat_rows_kernel<<<dim3(he, 3), 32, 0, s>>>(img, sat, he, we);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sat_cols_kernel<<<dim3((we + 1 + 255) / 256, 3), 256, 0, s>>>(sat, he, we);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  defocus_gather_kernel<<<dim3((wb + 127) / 128, hb), 128, 0, s>>>(
      img, half, sat, out, hb, wb, ring, oy, ox, full_h, full_w);
  return (int)cudaGetLastError();
}

extern "C" int defocus_box(const unsigned char* rgb, const float* depth,
                           unsigned char* half, unsigned* sat, unsigned char* out, int h,
                           int w, int k, int max_half, int approx, int exact_upto,
                           int stride, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int n = h * w;
  const int t = approx ? exact_upto : 0;
  const int cmax = approx ? t + (max_half - t) / stride * stride : max_half;
  defocus_half_kernel<<<(n + 255) / 256, 256, 0, s>>>(depth, half, n, k, max_half, approx,
                                                      t, stride, cmax);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const U8Image img = {rgb, 1, 3LL * w, 3};
  return box_blur(img, half, sat, out, h, w, 0, 0, 0, h, w, s);
}

extern "C" int defocus_block(const unsigned char* chw_e, const unsigned char* half,
                             unsigned* sat, unsigned char* out, int hb, int wb, int ring,
                             int oy, int ox, int full_h, int full_w, void* stream) {
  const long long we = wb + 2 * ring;
  const U8Image img = {chw_e, (hb + 2LL * ring) * we, we, 1};
  return box_blur(img, half, sat, out, hb, wb, ring, oy, ox, full_h, full_w,
                  (cudaStream_t)stream);
}
