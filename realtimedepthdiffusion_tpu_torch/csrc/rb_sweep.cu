// Red-black projected-SOR kernels for Hopper (sm_90a).
//
// K4 rb_sweep_tiles replaces the TPU red-black strip kernels
//   realtimedepthdiffusion_tpu/ops/pallas_sweep.py:_rb_strip_mega_kernel (:1327),
//   the chunked _strip_rb_kernel (:1256) and the quadrant-compacted
//   _rb_compact_mega_kernel (:1491), which all compute the same iterate,
//   and, on a halo-extended block of the sharded step, the TPU halo-block
//   kernel _halo_block_rb_kernel (:1957), which takes the checkerboard as a
//   u8 plane where K4 takes one parity bit per block.
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
// every black pixel from the half-updated state. A pixel of one colour
// reads only neighbours of the other, so a half-sweep can update one buffer
// in place without a race; a barrier separates the half-sweeps.
//
// What bounds them on the card. An iteration does 15 operations a pixel
// (rb_sweep.cuh) and depends on the half-sweep before it. Read once, the
// state and weights are ~21 bytes a pixel, so a level whose iterations all
// stay on chip is bound by the SMs' issue rate (1080p L0, 62 iterations:
// 0.058 ms), and a coarse level of hundreds of iterations over a few
// thousand pixels by the latency of one half-sweep and its barrier.
//
// What the designs do about it.
// K4 blocks in time, on K1's register-blocked layout (sweep.cu). A CTA of
// bx x by threads owns an extended tile of (by*R) x (bx*C) pixels; thread
// (tx, ty) owns the R x C pixels from row ty*R and column tx*C. Before the
// loop each thread loads its pixels' u, bh (wr), bv (wd), inv and a mask
// bit, the bh left of each of its rows and the bv above each of its
// columns from device memory into registers, in one pass; no weight is
// read again. u also lives in one shared buffer, for the neighbouring
// threads: a half-sweep updates one colour in place, and a pixel reads
// only the other colour, so one buffer and one barrier per half-sweep are
// enough. A pixel's neighbours are the thread's own registers except
// across the edge of its R x C patch, where they are one shared load each.
// The buffer keeps the tile's columns de-interleaved, C sub-planes of bx
// slots a row (column x in sub-plane x % C, slot x / C), so a warp's loads
// of the column beside its patches fall on consecutive banks; every
// sub-plane has an end slot of zeros each side and the buffer a row of
// zeros above and below, which nobody writes. Pixels outside the image
// carry mask 1 and u = 0. So the loop has no index arithmetic, divide or
// bounds test, and every half-sweep updates its colour over the whole
// extended tile. Each half-sweep spoils one more ring from the tile's edge
// (the zeros stand in for the true neighbours), so after n_active <= k
// iterations ring 2k inwards is exact and is all that is written back.
// Colour: by*R and bx*C are even and the interior is the tile less 4k each
// way, so every tile's origin has even y + x and a pixel's colour is that
// of its tile coordinates plus the plane's parity. With R even, the pixel
// (r, c) of a thread is red when r + c + ((C*tx + parity) & 1) is even.
// The loop is unrolled with the colour as a template argument, so that the
// register arrays are indexed by constants. With C = 2 the choice between
// the two unrolled bodies is the same for every thread of the CTA, and
// every lane works in every half-sweep; with C = 1 adjacent lanes take
// opposite bodies and each sits idle through the other's. u ping-pongs
// between two global buffers from launch to launch, as in K1. gridDim.z
// walks a stack of nb <= 64 planes, whose parities are the bits of one
// 64-bit word, so the sharded step runs every block a card holds in one
// launch per exchange. (A first form kept only u on chip, in a
// tile_h x tile_w tile of one pixel per thread and step, and read five
// weights and the mask from device memory for every pixel and half-sweep,
// behind an integer divide and four bounds tests; PERF.md has both forms'
// times.)
// K5 is K4's register-blocked half-sweep on one tile that is the whole
// level: one CTA whose threads' patches cover it (60 x 17 threads of 4 x 2
// pixels hold the 67 x 120 of 1080p L4), with no ring to spoil, so it runs
// n iterations from row base of the omega table in one launch, in place,
// and writes every pixel back. The loop is K4's (rb_tile_sweeps): weights
// and mask bits in registers, one shared buffer of u, one barrier per
// half-sweep, no divide and no weight load. What bounds it is the one SM
// it runs on, whose schedulers are busy throughout (about 0.5 us a
// half-sweep of a 67 x 120 level), and that barrier: a level of a few
// thousand pixels is too small to pay a cluster's barrier (K2's costs
// ~1.6 us a sweep). (A first form kept u, bh, bv, inv and the mask of the level in
// shared memory, 17 bytes a pixel, and paid an integer divide, a mask load
// and ten shared loads for every point; PERF.md has both forms' times.)

#include <cuda_runtime.h>

#include "rb_sweep.cuh"

// One half-sweep of colour S on a thread's R x C patch: the pixels with
// (r + c) & 1 == S, where S already counts the patch origin's colour. li0
// is the patch's first pixel in the shared buffer, sub the slots of one
// sub-plane of a row, pitch = C * sub.
template <int R, int C, int S>
__device__ __forceinline__ void rb_half_sweep(float (&u)[R][C], const float (&wr)[R][C],
                                              const float (&wd)[R][C],
                                              const float (&iv)[R][C], const float (&wl0)[R],
                                              const float (&wu0)[C], unsigned msk, float* su,
                                              int li0, int pitch, int sub, float om) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (((r + c) & 1) != S) continue;
      const int li = li0 + r * pitch + c * sub;
      // The column left of the patch is the last sub-plane's slot before
      // this thread's; the column right of it the first sub-plane's next.
      const float ul = c > 0 ? u[r][c > 0 ? c - 1 : 0] : su[li + (C - 1) * sub - 1];
      const float ur = c + 1 < C ? u[r][c + 1 < C ? c + 1 : c] : su[li - (C - 1) * sub + 1];
      const float uu = r > 0 ? u[r > 0 ? r - 1 : 0][c] : su[li - pitch];
      const float ud = r + 1 < R ? u[r + 1 < R ? r + 1 : r][c] : su[li + pitch];
      const float wl = c > 0 ? wr[r][c > 0 ? c - 1 : 0] : wl0[r];
      const float wu = r > 0 ? wd[r > 0 ? r - 1 : 0][c] : wu0[c];
      const float nu = rb_point(u[r][c], ul, ur, uu, ud, wl, wr[r][c], wu, wd[r][c], iv[r][c],
                                om);
      u[r][c] = (msk >> (r * C + c)) & 1u ? u[r][c] : nu;
      su[li] = u[r][c];
    }
  }
}

// The work of one CTA of bx x by threads on the extended tile of (by*R) x
// (bx*C) pixels whose origin is (y0, x0) in the h x w plane: load it, run
// iterations base .. base+n-1, and write back the tile less ring pixels
// each way. u_in and u_out may be one plane when the tile holds all of it.
template <int R, int C>
__device__ __forceinline__ void rb_tile_sweeps(const float* u_in, float* u_out,
                                               const float* __restrict__ bh,
                                               const float* __restrict__ bv,
                                               const float* __restrict__ inv,
                                               const unsigned char* __restrict__ mask,
                                               const float* __restrict__ om, int h, int w,
                                               int base, int n, int y0, int x0, int ring,
                                               int parity) {
  extern __shared__ float su[];
  const int bx = blockDim.x;
  const int ew = bx * C;
  const int eh = blockDim.y * R;
  const int sub = bx + 2;
  const int pitch = C * sub;
  const int tid = threadIdx.y * bx + threadIdx.x;
  const int nt = bx * blockDim.y;

  // The zeros around the tile: a row above and below, and both end slots
  // of every sub-plane of every row.
  for (int i = tid; i < pitch; i += nt) su[i] = su[(eh + 1) * pitch + i] = 0.0f;
  for (int i = tid; i < eh * C; i += nt) {
    float* plane = su + (i / C + 1) * pitch + (i % C) * sub;
    plane[0] = plane[bx + 1] = 0.0f;
  }

  const int tx = threadIdx.x;
  const int ly0 = threadIdx.y * R;  // the patch's first row and column in the tile
  const int gx0 = x0 + tx * C;
  float u[R][C], wr[R][C], wd[R][C], iv[R][C];
  float wl0[R];  // bh of the pixel left of each row of the patch
  float wu0[C];  // bv of the pixel above each column of the patch
  unsigned msk = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int gy = y0 + ly0;
    const int gx = gx0 + c;
    wu0[c] = gx >= 0 && gx < w && gy > 0 && gy < h ? bv[(size_t)(gy - 1) * w + gx] : 0.0f;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int gy = y0 + ly0 + r;
    const bool row_in = gy >= 0 && gy < h;
    wl0[r] = row_in && gx0 > 0 && gx0 < w ? bh[(size_t)gy * w + gx0 - 1] : 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int gx = gx0 + c;
      const bool in = row_in && gx >= 0 && gx < w;
      const size_t g = (size_t)gy * w + gx;
      u[r][c] = in ? u_in[g] : 0.0f;
      wr[r][c] = in ? bh[g] : 0.0f;
      wd[r][c] = in ? bv[g] : 0.0f;
      iv[r][c] = in ? inv[g] : 0.0f;
      msk |= (unsigned)(in ? mask[g] != 0 : 1) << (r * C + c);
    }
  }
  const int li0 = (ly0 + 1) * pitch + tx + 1;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) su[li0 + r * pitch + c * sub] = u[r][c];
  __syncthreads();

  // Whether the patch's first pixel is black: ly0 is even, as R is.
  const int first = (tx * C + parity) & 1;
  for (int j = 0; j < 2 * n; ++j) {
    // Row base + j/2 of the (iters, 2) table, column j & 1: 0 red, 1 black.
    const float omj = __ldg(om + 2 * base + j);
    if ((j ^ first) & 1)
      rb_half_sweep<R, C, 1>(u, wr, wd, iv, wl0, wu0, msk, su, li0, pitch, sub, omj);
    else
      rb_half_sweep<R, C, 0>(u, wr, wd, iv, wl0, wu0, msk, su, li0, pitch, sub, omj);
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int ly = ly0 + r;
    const int gy = y0 + ly;
    if (ly < ring || ly >= eh - ring || gy >= h) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int lx = tx * C + c;
      const int gx = gx0 + c;
      if (lx < ring || lx >= ew - ring || gx >= w) continue;
      u_out[(size_t)gy * w + gx] = u[r][c];
    }
  }
}

// K4: R x C pixels per thread (R even, R * C <= 32), at most MAXT threads
// per CTA (the register budget per thread is 65536 / MAXT).
template <int R, int C, int MAXT>
__global__ void __launch_bounds__(MAXT)
rb_sweep_tiles_kernel(const float* __restrict__ u_in, float* __restrict__ u_out,
                      const float* __restrict__ bh, const float* __restrict__ bv,
                      const float* __restrict__ inv,
                      const unsigned char* __restrict__ mask,
                      const float* __restrict__ om, int h, int w, int base,
                      int n_active, int k, unsigned long long parity_bits,
                      const int* __restrict__ stop) {
  // A stopped launch runs no iteration and writes its input back, as K1's.
  if (stop != nullptr && *stop) n_active = 0;
  const int ring = 2 * k;
  // The extended tile's origin.
  const int y0 = blockIdx.y * (blockDim.y * R - 2 * ring) - ring;
  const int x0 = blockIdx.x * (blockDim.x * C - 2 * ring) - ring;
  const int parity = (int)((parity_bits >> blockIdx.z) & 1ull);
  const size_t off = (size_t)blockIdx.z * h * w;
  rb_tile_sweeps<R, C>(u_in + off, u_out + off, bh + off, bv + off, inv + off, mask + off, om,
                       h, w, base, n_active, y0, x0, ring, parity);
}

// K5: the one tile is the whole level, red at even y + x.
template <int R, int C, int MAXT>
__global__ void __launch_bounds__(MAXT)
rb_sweep_resident_kernel(float* u, const float* __restrict__ bh,
                         const float* __restrict__ bv, const float* __restrict__ inv,
                         const unsigned char* __restrict__ mask,
                         const float* __restrict__ om, int h, int w, int base, int n,
                         const int* __restrict__ stop) {
  if (stop != nullptr && *stop) return;  // stopped: the level stays as it is
  rb_tile_sweeps<R, C>(u, u, bh, bv, inv, mask, om, h, w, base, n, 0, 0, 0, 0);
}

static int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <int R, int C, int MAXT>
static int launch_rb_tiles(const float* u_in, float* u_out, const float* bh, const float* bv,
                           const float* inv, const unsigned char* mask, const float* om,
                           int nb, int h, int w, int base, int n_active, int k, int bx, int by,
                           unsigned long long parity_bits, const int* stop,
                           cudaStream_t stream) {
  const int eh = by * R;
  const int ew = bx * C;
  if (bx * by > MAXT || ew - 4 * k < 1 || eh - 4 * k < 1 || (ew & 1) || nb < 1 || nb > 64)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)(eh + 2) * C * (bx + 2);
  int err = set_smem((const void*)rb_sweep_tiles_kernel<R, C, MAXT>, smem);
  if (err) return err;
  const dim3 grid((w + ew - 4 * k - 1) / (ew - 4 * k), (h + eh - 4 * k - 1) / (eh - 4 * k), nb);
  rb_sweep_tiles_kernel<R, C, MAXT><<<grid, dim3(bx, by), smem, stream>>>(
      u_in, u_out, bh, bv, inv, mask, om, h, w, base, n_active, k, parity_bits, stop);
  return (int)cudaGetLastError();
}

// (rows, cols) picks the instance, the pixels of one thread: 8 x 1 (K1's
// column), 4 x 2, or 8 x 2, which holds the wider tiles that a ring of 17
// and more needs. Plane z of the nb <= 64 is red at even y + x when bit z
// of parity_bits is 0, at odd y + x when it is 1. stop is null, or a
// device int that, when non-zero, turns the launch into a copy of u_in to
// u_out.
extern "C" int rb_sweep_tiles(const float* u_in, float* u_out, const float* bh,
                              const float* bv, const float* inv,
                              const unsigned char* mask, const float* om, int nb, int h,
                              int w, int base, int n_active, int k, int bx, int by, int rows,
                              int cols, unsigned long long parity_bits, const int* stop,
                              void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (rows == 8 && cols == 1)
    return launch_rb_tiles<8, 1, 512>(u_in, u_out, bh, bv, inv, mask, om, nb, h, w, base,
                                      n_active, k, bx, by, parity_bits, stop, s);
  if (rows == 4 && cols == 2)
    return launch_rb_tiles<4, 2, 512>(u_in, u_out, bh, bv, inv, mask, om, nb, h, w, base,
                                      n_active, k, bx, by, parity_bits, stop, s);
  if (rows == 8 && cols == 2)
    return launch_rb_tiles<8, 2, 512>(u_in, u_out, bh, bv, inv, mask, om, nb, h, w, base,
                                      n_active, k, bx, by, parity_bits, stop, s);
  return (int)cudaErrorInvalidValue;
}

template <int R, int C, int MAXT>
static int launch_rb_resident(float* u, const float* bh, const float* bv, const float* inv,
                              const unsigned char* mask, const float* om, int h, int w,
                              int base, int n, int bx, int by, const int* stop,
                              cudaStream_t stream) {
  if (bx * by > MAXT || bx * C < w || by * R < h) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)(by * R + 2) * C * (bx + 2);
  int err = set_smem((const void*)rb_sweep_resident_kernel<R, C, MAXT>, smem);
  if (err) return err;
  rb_sweep_resident_kernel<R, C, MAXT><<<1, dim3(bx, by), smem, stream>>>(
      u, bh, bv, inv, mask, om, h, w, base, n, stop);
  return (int)cudaGetLastError();
}

// One CTA of bx x by threads, each with a patch of 4 x 2 pixels: up to 1024
// threads at 64 registers each. stop is null, or a device int that, when
// non-zero, leaves u as it is.
extern "C" int rb_sweep_resident(float* u, const float* bh, const float* bv,
                                 const float* inv, const unsigned char* mask,
                                 const float* om, int h, int w, int base, int n, int bx,
                                 int by, const int* stop, void* stream) {
  return launch_rb_resident<4, 2, 1024>(u, bh, bv, inv, mask, om, h, w, base, n, bx, by, stop,
                                        (cudaStream_t)stream);
}
