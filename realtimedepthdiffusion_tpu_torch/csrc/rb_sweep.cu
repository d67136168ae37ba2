// Red-black projected-SOR kernels for Hopper (sm_90a).
//
// K4 rb_sweep_tiles replaces the TPU red-black strip kernels
//   realtimedepthdiffusion_tpu/ops/pallas_sweep.py:_rb_strip_mega_kernel (:1327),
//   the chunked _strip_rb_kernel (:1256) and the quadrant-compacted
//   _rb_compact_mega_kernel (:1491), which all compute the same iterate,
//   and, on a halo-extended block of the sharded step, the TPU halo-block
//   kernel _halo_block_rb_kernel (:1957), which takes the checkerboard as a
//   u8 plane where K4 takes one int, parity.
// K5 rb_sweep_resident replaces the TPU resident red-black kernel
//   realtimedepthdiffusion_tpu/ops/pallas_sweep.py:_resident_rb_kernel (:1209).
//
// Layout as in sweep.cu: unpadded row-major (h, w) planes; bh[y][x] is the
// weight between (y, x) and (y, x+1), 0 in the last column; bv[y][x]
// between (y, x) and (y+1, x), 0 in the last row; inv is the reciprocal
// weight sum; mask is 1 on scribbled pixels, which keep their value. A
// neighbour outside the image reads as 0 with weight 0. om is the (iters, 2)
// float32 table of the red and the black half-sweep's omega per iteration
// (core/solver.py:rb_omegas), in device memory; base indexes its rows.
//
// One iteration is two half-sweeps: every red pixel ((y + x + parity) even
// in image coordinates; parity is 0 for a whole image, and for a block of a
// larger image the parity of its origin) from the current state, then
// every black pixel from the half-updated state. A pixel of one colour reads only neighbours of the
// other, so a half-sweep can update one buffer in place without a race;
// a barrier separates the half-sweeps.
//
// What bounds them on the card: the same as the Jacobi sweeps (sweep.cu).
// An iteration touches every pixel once, reading 4 neighbours, 5 weight
// values and the mask, for about 10 flops: bandwidth bound at the fine
// levels when it goes through device memory, latency bound (one barrier
// per half-sweep) at the coarse ones.
//
// What the designs do about it.
// K4 blocks in time: one CTA loads a tile_h x tile_w tile of u with a ring
// of 2k pixels into shared memory and runs up to k iterations there. Each
// half-sweep advances the dependency cone by one pixel, so half-sweep j
// updates ring >= j + 1 and after 2 n_active <= 2k half-sweeps the tile's
// interior is exact. Device-memory traffic for the state falls k-fold; the
// weights come through the read-only path. u ping-pongs between two global
// buffers from launch to launch, as in K1. The colour of a pixel comes from
// its global coordinates, never from tile-local ones, so a tile whose
// origin has odd y + x keeps the global checkerboard.
// K5 keeps a whole level (u, bh, bv, inv as f32 and mask as u8, with a
// one-pixel ring: 17 bytes per padded pixel) in one CTA's shared memory
// and runs n iterations from row base of the omega table in one launch. At
// 1080p that holds L4 (67 x 120); L3 (137 x 242 padded, 564 KB) does not
// fit.
//
// Both kernels visit only the pixels of the colour being relaxed: a
// thread's index walks the half-width columns of one colour in each row.

#include <cuda_runtime.h>

#include "rb_sweep.cuh"

#define RB_TILE_THREADS 256
#define RB_RESIDENT_THREADS 1024

__global__ void __launch_bounds__(RB_TILE_THREADS)
rb_sweep_tiles_kernel(const float* __restrict__ u_in, float* __restrict__ u_out,
                      const float* __restrict__ bh, const float* __restrict__ bv,
                      const float* __restrict__ inv,
                      const unsigned char* __restrict__ mask,
                      const float* __restrict__ om, int h, int w, int base,
                      int n_active, int k, int tile_h, int tile_w, int parity) {
  extern __shared__ float su[];
  const int ring = 2 * k;
  const int th = tile_h + 2 * ring;
  const int tw = tile_w + 2 * ring;
  const int y0 = blockIdx.y * tile_h - ring;
  const int x0 = blockIdx.x * tile_w - ring;

  // Pixels outside the image load as 0 and are never written.
  for (int i = threadIdx.x; i < th * tw; i += blockDim.x) {
    const int ly = i / tw;
    const int gy = y0 + ly;
    const int gx = x0 + (i - ly * tw);
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
    su[i] = in ? u_in[(size_t)gy * w + gx] : 0.0f;
  }
  __syncthreads();

  for (int j = 0; j < 2 * n_active; ++j) {
    const int colour = j & 1;  // 0 red, 1 black
    // Row base + j/2 of the (iters, 2) table, column colour.
    const float omj = __ldg(om + 2 * base + j);
    // After j half-sweeps ring >= j is exact; this one computes ring >= j+1.
    const int lo = j + 1;
    const int rh = th - 2 * lo;
    const int rw = tw - 2 * lo;
    const int half = (rw + 1) / 2;
    for (int i = threadIdx.x; i < rh * half; i += blockDim.x) {
      const int ry = i / half;
      const int ly = lo + ry;
      const int gy = y0 + ly;
      // The first column of this row whose global (gy + gx + parity) has
      // the colour's parity; & 1 reads the parity of negative sums right.
      const int off = (colour ^ (gy + x0 + lo + parity)) & 1;
      const int lx = lo + off + 2 * (i - ry * half);
      if (lx >= lo + rw) continue;
      const int gx = x0 + lx;
      if (gy < 0 || gy >= h || gx < 0 || gx >= w) continue;
      const size_t g = (size_t)gy * w + gx;
      if (__ldg(mask + g)) continue;
      const int li = ly * tw + lx;
      const float wl = gx > 0 ? __ldg(bh + g - 1) : 0.0f;
      const float wu = gy > 0 ? __ldg(bv + g - w) : 0.0f;
      su[li] = rb_point(su[li], su[li - 1], su[li + 1], su[li - tw], su[li + tw], wl,
                        __ldg(bh + g), wu, __ldg(bv + g), __ldg(inv + g), omj);
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < tile_h * tile_w; i += blockDim.x) {
    const int ty = i / tile_w;
    const int tx = i - ty * tile_w;
    const int gy = blockIdx.y * tile_h + ty;
    const int gx = blockIdx.x * tile_w + tx;
    if (gy >= h || gx >= w) continue;
    u_out[(size_t)gy * w + gx] = su[(ty + ring) * tw + tx + ring];
  }
}

__global__ void __launch_bounds__(RB_RESIDENT_THREADS)
rb_sweep_resident_kernel(float* __restrict__ u, const float* __restrict__ bh,
                         const float* __restrict__ bv, const float* __restrict__ inv,
                         const unsigned char* __restrict__ mask,
                         const float* __restrict__ om, int h, int w, int base,
                         int n) {
  extern __shared__ float smem[];
  // Every plane carries a one-pixel ring of zeros (mask 1 there), so
  // neighbour reads need no bounds checks: wl = bh one pixel to the left,
  // wu = bv one row up, and both are 0 on the ring.
  const int pw = w + 2;
  const int np = (h + 2) * pw;
  float* su = smem;
  float* sbh = su + np;
  float* sbv = sbh + np;
  float* sinv = sbv + np;
  unsigned char* sm = reinterpret_cast<unsigned char*>(sinv + np);

  for (int i = threadIdx.x; i < np; i += blockDim.x) {
    const int py = i / pw;
    const int y = py - 1;
    const int x = i - py * pw - 1;
    const bool in = y >= 0 && y < h && x >= 0 && x < w;
    const size_t g = (size_t)y * w + x;
    su[i] = in ? u[g] : 0.0f;
    sbh[i] = in ? bh[g] : 0.0f;
    sbv[i] = in ? bv[g] : 0.0f;
    sinv[i] = in ? inv[g] : 0.0f;
    sm[i] = in ? mask[g] : 1;
  }
  __syncthreads();

  const int half = (w + 1) / 2;
  for (int j = 0; j < 2 * n; ++j) {
    const int colour = j & 1;
    const float omj = __ldg(om + 2 * base + j);
    for (int i = threadIdx.x; i < h * half; i += blockDim.x) {
      const int y = i / half;
      const int x = ((y ^ colour) & 1) + 2 * (i - y * half);
      if (x >= w) continue;
      const int pi = (y + 1) * pw + x + 1;
      if (sm[pi]) continue;
      su[pi] = rb_point(su[pi], su[pi - 1], su[pi + 1], su[pi - pw], su[pi + pw],
                        sbh[pi - 1], sbh[pi], sbv[pi - pw], sbv[pi], sinv[pi], omj);
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < h * w; i += blockDim.x) {
    const int y = i / w;
    u[i] = su[(y + 1) * pw + (i - y * w) + 1];
  }
}

static int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

extern "C" int rb_sweep_tiles(const float* u_in, float* u_out, const float* bh,
                              const float* bv, const float* inv,
                              const unsigned char* mask, const float* om, int h,
                              int w, int base, int n_active, int k, int tile_h,
                              int tile_w, int parity, void* stream) {
  const size_t smem = sizeof(float) * (size_t)(tile_h + 4 * k) * (tile_w + 4 * k);
  int err = set_smem((const void*)rb_sweep_tiles_kernel, smem);
  if (err) return err;
  const dim3 grid((w + tile_w - 1) / tile_w, (h + tile_h - 1) / tile_h);
  rb_sweep_tiles_kernel<<<grid, RB_TILE_THREADS, smem, (cudaStream_t)stream>>>(
      u_in, u_out, bh, bv, inv, mask, om, h, w, base, n_active, k, tile_h, tile_w,
      parity & 1);
  return (int)cudaGetLastError();
}

extern "C" int rb_sweep_resident(float* u, const float* bh, const float* bv,
                                 const float* inv, const unsigned char* mask,
                                 const float* om, int h, int w, int base, int n,
                                 void* stream) {
  const size_t np = (size_t)(h + 2) * (w + 2);
  const size_t smem = np * (4 * sizeof(float) + 1);
  int err = set_smem((const void*)rb_sweep_resident_kernel, smem);
  if (err) return err;
  rb_sweep_resident_kernel<<<1, RB_RESIDENT_THREADS, smem, (cudaStream_t)stream>>>(
      u, bh, bv, inv, mask, om, h, w, base, n);
  return (int)cudaGetLastError();
}
