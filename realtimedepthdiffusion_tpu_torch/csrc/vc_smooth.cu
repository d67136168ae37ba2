// The V-cycle's error smoother for Hopper (sm_90a): the Jacobi sweeps of the
// error equation (I - M) e = rhs that core/multigrid.py:vcycle_polish runs
// before and after each coarse correction and at its coarsest level
// (_smooth_error). It replaces no TPU kernel: the JAX package runs the
// polish in plain XLA ops. A sweep computes, per pixel,
//
//   e' = mask ? 0 : ((wl*el + wr*er) + wu*eu + wd*ed) * inv + rhs
//
// in the plain version's left-to-right order (ops/sweep.py:average_plain,
// ops/vc_smooth.py:smooth_plain), every product and sum an explicit
// round-to-nearest intrinsic, so that nvcc contracts nothing into an FMA and
// a launch gives the plain sweeps' bits. A neighbour outside the image reads
// as 0; the error is 0 on scribbles and outside the image.
//
// Layout: unpadded row-major (h, w) float32 planes: e, rhs, bh (the weight
// toward the right neighbour, 0 in the last column), bv (toward the lower
// one, 0 in the last row), inv (the reciprocal weight sum), and the mask as
// u8. wl and wu are bh and bv one pixel to the left and up.
//
// Both kernels run the tile of K1 (jc_tiles.cuh): a CTA of bx x by threads
// owns an extended tile of (by*R) x bx pixels, thread (tx, ty) the R pixels
// of column tx from row ty*R down, with e, rhs and the weights in registers,
// loaded once, and e also in two shared buffers with a ring of zeros that
// nobody writes, which a sweep reads and writes in turn. The upper and lower
// neighbours are the thread's own registers except at the ends of its
// column. Pixels outside the image carry mask 1 and e = 0, so the sweep loop
// has no bounds test.
//
// vc_smooth_tiles_kernel blocks in time over the whole level: k sweeps a
// launch, each spoiling one more ring from the tile's edge, and it writes
// back the interior, ring k inwards. At the defaults (8 sweeps a pre- or
// post-smoothing pass) a pass is one launch.
// vc_smooth_resident_kernel runs on a level one CTA holds whole (1080p's and
// 4K's coarsest, 67 x 120): its tile is the image, whose edges are the true
// zero boundary, so it runs every sweep of a pass (200 at the coarsest) in
// one launch, one barrier a sweep, and writes back every pixel. Its CTA is a
// warp's multiple of columns across and thread rows of VC_RESIDENT_R rows
// down, up to 1024 threads: at 67 x 120, 128 x 8 threads of 9 pixels. One
// SM issues every sweep; at 67 x 120 a sweep takes ~1.2 us, and 17 rows a
// thread on 512 threads was 2 % slower (PERF.md).

#include <cuda_runtime.h>

#include "jc_tiles.cuh"

// The tile route's CTA: 64 x 8 threads of 8 rows (a 64 x 64 tile, as K1's
// shallow tile), and its deepest ring, which leaves a 32 x 32 interior.
#define VC_TILE_BX 64
#define VC_TILE_BY 8
#define VC_TILE_R 8
#define VC_MAX_TILE_SWEEPS 16
// The resident CTA: rows per thread and most threads.
#define VC_RESIDENT_R 9
#define VC_RESIDENT_MAXT 1024
// One CTA's shared memory on Hopper.
#define VC_SMEM_PER_CTA 232448

__device__ __forceinline__ float vc_point(float el, float er, float eu, float ed, float wl,
                                          float wr, float wu, float wd, float inv, float rhs,
                                          unsigned m) {
  float s = __fmul_rn(wl, el);
  s = __fadd_rn(s, __fmul_rn(wr, er));
  s = __fadd_rn(s, __fmul_rn(wu, eu));
  s = __fadd_rn(s, __fmul_rn(wd, ed));
  return m ? 0.0f : __fadd_rn(__fmul_rn(s, inv), rhs);
}

// n sweeps over the tile whose first pixel is (y0, x0) of the image, then
// the write-back of its pixels ring k inwards that lie in the image.
template <int R>
__device__ __forceinline__ void vc_tile(const float* __restrict__ e_in,
                                        float* __restrict__ e_out,
                                        const float* __restrict__ rhs,
                                        const float* __restrict__ bh,
                                        const float* __restrict__ bv,
                                        const float* __restrict__ inv,
                                        const unsigned char* __restrict__ mask, int h, int w,
                                        int y0, int x0, int n, int k) {
  extern __shared__ float smem[];
  const int ew = blockDim.x;
  const int eh = blockDim.y * R;
  const int pitch = ew + 2;
  float* cur = smem;
  float* nxt = smem + (eh + 2) * pitch;
  jc_zero_ring(cur, nxt, eh, ew);

  const int tx = threadIdx.x;
  const int ly0 = threadIdx.y * R;  // the thread's first row in the tile
  const int gx = x0 + tx;
  const bool col_in = gx >= 0 && gx < w;
  float e[R], rh[R], wl[R], wr[R], wd[R], iv[R];
  unsigned msk = 0;
  float wu0 = 0.0f;  // bv of the pixel above the thread's first pixel
  {
    const int gy = y0 + ly0;
    if (col_in && gy > 0 && gy < h) wu0 = bv[(size_t)(gy - 1) * w + gx];
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int gy = y0 + ly0 + r;
    const bool in = col_in && gy >= 0 && gy < h;
    const size_t g = (size_t)gy * w + gx;
    e[r] = in ? e_in[g] : 0.0f;
    rh[r] = in ? rhs[g] : 0.0f;
    wl[r] = in && gx > 0 ? bh[g - 1] : 0.0f;
    wr[r] = in ? bh[g] : 0.0f;
    wd[r] = in ? bv[g] : 0.0f;
    iv[r] = in ? inv[g] : 0.0f;
    msk |= (unsigned)(in ? mask[g] != 0 : 1) << r;
  }

  const int c0 = (ly0 + 1) * pitch + tx + 1;  // the thread's first pixel in the buffers
#pragma unroll
  for (int r = 0; r < R; ++r) cur[c0 + r * pitch] = e[r];
  __syncthreads();
  for (int s = 0; s < n; ++s) {
    float above = cur[c0 - pitch];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int li = c0 + r * pitch;
      const float ec = e[r];
      const float below = r + 1 < R ? e[r + 1 < R ? r + 1 : r] : cur[li + pitch];
      const float wu = r > 0 ? wd[r > 0 ? r - 1 : 0] : wu0;
      const float ne = vc_point(cur[li - 1], cur[li + 1], above, below, wl[r], wr[r], wu, wd[r],
                                iv[r], rh[r], (msk >> r) & 1u);
      nxt[li] = ne;
      above = ec;
      e[r] = ne;
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }

  if (tx < k || tx >= ew - k || gx >= w) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int ly = ly0 + r;
    const int gy = y0 + ly;
    if (ly < k || ly >= eh - k || gy >= h) continue;
    e_out[(size_t)gy * w + gx] = e[r];
  }
}

// The tile route: n <= k sweeps a launch over tiles that overlap by 2k.
template <int R, int MAXT>
__global__ void __launch_bounds__(MAXT)
vc_smooth_tiles_kernel(const float* __restrict__ e_in, float* __restrict__ e_out,
                       const float* __restrict__ rhs, const float* __restrict__ bh,
                       const float* __restrict__ bv, const float* __restrict__ inv,
                       const unsigned char* __restrict__ mask, int h, int w, int n, int k) {
  const int eh = blockDim.y * R;
  const int y0 = blockIdx.y * (eh - 2 * k) - k;  // the extended tile's origin
  const int x0 = blockIdx.x * (blockDim.x - 2 * k) - k;
  vc_tile<R>(e_in, e_out, rhs, bh, bv, inv, mask, h, w, y0, x0, n, k);
}

// The resident route: one CTA whose tile is the whole level, n sweeps.
template <int R, int MAXT>
__global__ void __launch_bounds__(MAXT)
vc_smooth_resident_kernel(const float* __restrict__ e_in, float* __restrict__ e_out,
                          const float* __restrict__ rhs, const float* __restrict__ bh,
                          const float* __restrict__ bv, const float* __restrict__ inv,
                          const unsigned char* __restrict__ mask, int h, int w, int n) {
  vc_tile<R>(e_in, e_out, rhs, bh, bv, inv, mask, h, w, 0, 0, n, 0);
}

static size_t vc_smem(int eh, int ew) { return 2 * sizeof(float) * (size_t)(eh + 2) * (ew + 2); }

static int vc_set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

extern "C" int vc_smooth_tiles(const float* e_in, float* e_out, const float* rhs,
                               const float* bh, const float* bv, const float* inv,
                               const unsigned char* mask, int h, int w, int n, int k,
                               void* stream) {
  if (h < 1 || w < 1 || k < 1 || k > VC_MAX_TILE_SWEEPS || n < 1 || n > k)
    return (int)cudaErrorInvalidValue;
  const int eh = VC_TILE_BY * VC_TILE_R;
  const size_t smem = vc_smem(eh, VC_TILE_BX);
  const dim3 grid((w + VC_TILE_BX - 2 * k - 1) / (VC_TILE_BX - 2 * k),
                  (h + eh - 2 * k - 1) / (eh - 2 * k));
  vc_smooth_tiles_kernel<VC_TILE_R, VC_TILE_BX * VC_TILE_BY>
      <<<grid, dim3(VC_TILE_BX, VC_TILE_BY), smem, (cudaStream_t)stream>>>(
          e_in, e_out, rhs, bh, bv, inv, mask, h, w, n, k);
  return (int)cudaGetLastError();
}

// The resident CTA: a warp's multiple of columns across, as many thread
// rows as the level needs (ops/vc_smooth.py:resident_fits).
static bool vc_resident_cta(int h, int w, int* bx, int* by) {
  *bx = (w + 31) / 32 * 32;
  *by = (h + VC_RESIDENT_R - 1) / VC_RESIDENT_R;
  return *bx * *by <= VC_RESIDENT_MAXT && vc_smem(*by * VC_RESIDENT_R, *bx) <= VC_SMEM_PER_CTA;
}

extern "C" int vc_smooth_resident(const float* e_in, float* e_out, const float* rhs,
                                  const float* bh, const float* bv, const float* inv,
                                  const unsigned char* mask, int h, int w, int n,
                                  void* stream) {
  int bx, by;
  if (h < 1 || w < 1 || n < 1 || !vc_resident_cta(h, w, &bx, &by))
    return (int)cudaErrorInvalidValue;
  const size_t smem = vc_smem(by * VC_RESIDENT_R, bx);
  const void* kernel = (const void*)vc_smooth_resident_kernel<VC_RESIDENT_R, VC_RESIDENT_MAXT>;
  const int err = vc_set_smem(kernel, smem);
  if (err) return err;
  vc_smooth_resident_kernel<VC_RESIDENT_R, VC_RESIDENT_MAXT>
      <<<1, dim3(bx, by), smem, (cudaStream_t)stream>>>(e_in, e_out, rhs, bh, bv, inv, mask, h,
                                                        w, n);
  return (int)cudaGetLastError();
}
