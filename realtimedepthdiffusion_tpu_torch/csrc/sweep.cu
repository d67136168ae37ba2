// Jacobi-Chebyshev sweep kernels for Hopper (sm_90a).
//
// K1 jc_sweep_tiles replaces the TPU strip megakernel
//   realtimedepthdiffusion_tpu/ops/pallas_sweep.py:_strip_mega_kernel_arena (:298)
// K2 jc_sweep_resident replaces the TPU resident kernel
//   realtimedepthdiffusion_tpu/ops/pallas_sweep.py:_resident_kernel (:111)
//
// Layout: every plane is an unpadded row-major (h, w) array. bh[y][x] is
// the weight between (y, x) and (y, x+1), 0 in the last column; bv[y][x]
// between (y, x) and (y+1, x), 0 in the last row; inv is the reciprocal
// weight sum; mask is 1 on scribbled pixels, which keep their value. A
// neighbour outside the image reads as 0 with weight 0. abc is the
// (iters, 3) float32 table of (a, b, c) per sweep, in device memory.
//
// What bounds them on the card. A sweep reads 5 neighbours of u, prev and
// 6 weight values per pixel and writes u: about 9 flops per ~40 bytes, far
// below the card's ~20 flops/byte balance, so a sweep that goes through
// device memory is bandwidth bound (1080p: ~80 MB per sweep, ~25 us at
// 3.35 TB/s, ~1.6 ms for L0's 62 sweeps alone). Each sweep also depends on
// the last, so the coarse levels, with 500-1000 sweeps of a few thousand
// pixels, are bound by the latency of one sweep, not by bytes.
//
// What the designs do about it.
// K1 blocks in time: one CTA loads a TILE_H x TILE_W tile of u and prev
// with a k-pixel ring into shared memory, runs up to k sweeps there with a
// barrier between them (the valid region shrinks by one ring per sweep),
// and writes the tile's interior back. Device-memory traffic for the state
// falls k-fold; the weights are read through the read-only path and stay
// in L1/L2 across the k sweeps. u/prev ping-pong between two global buffer
// pairs from one launch to the next, as the TPU kernel ping-pongs by block
// parity; the last launch of a level runs n_active = iters - base sweeps.
// K2 keeps a whole level (u, prev, bh, bv, inv as f32 and mask as u8: 21
// bytes per padded pixel) in one CTA's shared memory and runs all of its
// sweeps in one launch, so a coarse level pays one launch instead of
// iters/k. It fits a level of up to ~11k padded pixels (227 KB); at 1080p
// that is L4 (67 x 120, 1000 sweeps). A cluster with distributed shared
// memory would hold larger levels; that is later work.

#include <cuda_runtime.h>

#include "jc_sweep.cuh"

#define TILE_H 32
#define TILE_W 64
#define TILE_THREADS 256
#define RESIDENT_THREADS 1024

__global__ void __launch_bounds__(TILE_THREADS)
jc_sweep_tiles_kernel(const float* __restrict__ u_in, const float* __restrict__ p_in,
                      float* __restrict__ u_out, float* __restrict__ p_out,
                      const float* __restrict__ bh, const float* __restrict__ bv,
                      const float* __restrict__ inv,
                      const unsigned char* __restrict__ mask,
                      const float* __restrict__ abc, int h, int w, int base,
                      int n_active, int k) {
  extern __shared__ float smem[];
  const int th = TILE_H + 2 * k;
  const int tw = TILE_W + 2 * k;
  const int n = th * tw;
  // A holds u and B holds prev. A sweep writes the new u into B, in place
  // of prev at the same pixel (the update reads prev only there), and the
  // old u in A becomes prev: the two buffers swap roles every sweep.
  float* A = smem;
  float* B = smem + n;
  const int y0 = blockIdx.y * TILE_H - k;
  const int x0 = blockIdx.x * TILE_W - k;

  // Pixels outside the image load as 0 and are never written, so they
  // read as 0 in both buffers for the whole launch.
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int ly = i / tw;
    const int gy = y0 + ly;
    const int gx = x0 + (i - ly * tw);
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
    const size_t g = (size_t)gy * w + gx;
    A[i] = in ? u_in[g] : 0.0f;
    B[i] = in ? p_in[g] : 0.0f;
  }
  __syncthreads();

  for (int s = 0; s < n_active; ++s) {
    const float a = __ldg(abc + 3 * (base + s));
    const float b = __ldg(abc + 3 * (base + s) + 1);
    const float c = __ldg(abc + 3 * (base + s) + 2);
    // After s sweeps the values in ring >= s are exact; sweep s computes
    // ring >= s + 1 from them. After n_active <= k sweeps ring k, the
    // tile's interior, is exact.
    const int lo = s + 1;
    const int rh = th - 2 * lo;
    const int rw = tw - 2 * lo;
    for (int i = threadIdx.x; i < rh * rw; i += blockDim.x) {
      const int ry = i / rw;
      const int ly = lo + ry;
      const int lx = lo + (i - ry * rw);
      const int gy = y0 + ly;
      const int gx = x0 + lx;
      if (gy < 0 || gy >= h || gx < 0 || gx >= w) continue;
      const size_t g = (size_t)gy * w + gx;
      const int li = ly * tw + lx;
      const float wl = gx > 0 ? __ldg(bh + g - 1) : 0.0f;
      const float wu = gy > 0 ? __ldg(bv + g - w) : 0.0f;
      B[li] = jc_point(A[li - 1], A[li + 1], A[li - tw], A[li + tw], A[li], B[li],
                       wl, __ldg(bh + g), wu, __ldg(bv + g), __ldg(inv + g),
                       __ldg(mask + g), a, b, c);
    }
    __syncthreads();
    float* t = A;
    A = B;
    B = t;
  }

  for (int i = threadIdx.x; i < TILE_H * TILE_W; i += blockDim.x) {
    const int ty = i / TILE_W;
    const int tx = i - ty * TILE_W;
    const int gy = blockIdx.y * TILE_H + ty;
    const int gx = blockIdx.x * TILE_W + tx;
    if (gy >= h || gx >= w) continue;
    const size_t g = (size_t)gy * w + gx;
    const int li = (ty + k) * tw + tx + k;
    u_out[g] = A[li];
    p_out[g] = B[li];
  }
}

__global__ void __launch_bounds__(RESIDENT_THREADS)
jc_sweep_resident_kernel(float* __restrict__ u, const float* __restrict__ bh,
                         const float* __restrict__ bv, const float* __restrict__ inv,
                         const unsigned char* __restrict__ mask,
                         const float* __restrict__ abc, int h, int w, int iters) {
  extern __shared__ float smem[];
  // Every plane is stored with a one-pixel ring of zeros (mask 1 there), so
  // neighbour reads need no bounds checks: wl = bh one pixel to the left,
  // wu = bv one row up, and both are 0 on the ring.
  const int pw = w + 2;
  const int np = (h + 2) * pw;
  float* A = smem;  // u
  float* B = A + np;  // prev, then the new u (see jc_sweep_tiles_kernel)
  float* sbh = B + np;
  float* sbv = sbh + np;
  float* sinv = sbv + np;
  unsigned char* sm = reinterpret_cast<unsigned char*>(sinv + np);

  for (int i = threadIdx.x; i < np; i += blockDim.x) {
    const int py = i / pw;
    const int y = py - 1;
    const int x = i - py * pw - 1;
    const bool in = y >= 0 && y < h && x >= 0 && x < w;
    const size_t g = (size_t)y * w + x;
    A[i] = in ? u[g] : 0.0f;
    B[i] = 0.0f;  // the Chebyshev history starts at zero
    sbh[i] = in ? bh[g] : 0.0f;
    sbv[i] = in ? bv[g] : 0.0f;
    sinv[i] = in ? inv[g] : 0.0f;
    sm[i] = in ? mask[g] : 1;
  }
  __syncthreads();

  const int n = h * w;
  for (int t = 0; t < iters; ++t) {
    const float a = __ldg(abc + 3 * t);
    const float b = __ldg(abc + 3 * t + 1);
    const float c = __ldg(abc + 3 * t + 2);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int y = i / w;
      const int pi = (y + 1) * pw + (i - y * w) + 1;
      B[pi] = jc_point(A[pi - 1], A[pi + 1], A[pi - pw], A[pi + pw], A[pi], B[pi],
                       sbh[pi - 1], sbh[pi], sbv[pi - pw], sbv[pi], sinv[pi], sm[pi],
                       a, b, c);
    }
    __syncthreads();
    float* tmp = A;
    A = B;
    B = tmp;
  }

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int y = i / w;
    u[i] = A[(y + 1) * pw + (i - y * w) + 1];
  }
}

static int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

extern "C" int jc_sweep_tiles(const float* u_in, const float* p_in, float* u_out,
                              float* p_out, const float* bh, const float* bv,
                              const float* inv, const unsigned char* mask,
                              const float* abc, int h, int w, int base, int n_active,
                              int k, void* stream) {
  const size_t smem = 2 * sizeof(float) * (size_t)(TILE_H + 2 * k) * (TILE_W + 2 * k);
  int err = set_smem((const void*)jc_sweep_tiles_kernel, smem);
  if (err) return err;
  const dim3 grid((w + TILE_W - 1) / TILE_W, (h + TILE_H - 1) / TILE_H);
  jc_sweep_tiles_kernel<<<grid, TILE_THREADS, smem, (cudaStream_t)stream>>>(
      u_in, p_in, u_out, p_out, bh, bv, inv, mask, abc, h, w, base, n_active, k);
  return (int)cudaGetLastError();
}

extern "C" int jc_sweep_resident(float* u, const float* bh, const float* bv,
                                 const float* inv, const unsigned char* mask,
                                 const float* abc, int h, int w, int iters,
                                 void* stream) {
  const size_t np = (size_t)(h + 2) * (w + 2);
  const size_t smem = np * (5 * sizeof(float) + 1);
  int err = set_smem((const void*)jc_sweep_resident_kernel, smem);
  if (err) return err;
  jc_sweep_resident_kernel<<<1, RESIDENT_THREADS, smem, (cudaStream_t)stream>>>(
      u, bh, bv, inv, mask, abc, h, w, iters);
  return (int)cudaGetLastError();
}

extern "C" const char* rtdd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
