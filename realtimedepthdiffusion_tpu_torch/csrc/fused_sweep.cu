// K6 jc_sweep_fused: Jacobi-Chebyshev sweeps that derive their edge
// weights in the kernel, for Hopper (sm_90a).
//
// Replaces the TPU derived-weights arena megakernel
//   realtimedepthdiffusion_tpu/ops/pallas_sweep.py:_strip_mega_kernel_uarena (:394)
//
// It computes what K1 (sweep.cu) computes, up to k sweeps of one level per
// launch on tiles with a k-ring halo, (u, prev) ping-pong between launches
// and n_active sweeps in the ragged last launch. It takes no f32 weight
// planes. Its inputs are u8 planes: gray, the scribble mask, and d8 =
// trunc(clip(level-entry depth, 0, 255)); the 256-entry table etab[g] =
// exp(-beta*g), pinned to 0 below FLT_MIN; the depth threshold thr (0 at
// level 0) and whether the depth rule applies (every level but the
// coarsest). Once per launch it derives each pixel's weights by the rule of
// core/weights.py:edge_weights:
//   bh(y, x) = etab[|gray(y, x+1) - gray(y, x)|], or 1 where the depth rule
//              applies and |d8(y, x+1) - d8(y, x)| <= thr; 0 when (y, x+1)
//              is outside the image. bv(y, x) the same toward (y+1, x).
//   inv = 1 / (((wl + wr) + wu) + wd), or 0 where the sum is below FLT_MIN,
//              the f32 normal/subnormal boundary that edge_weights pins.
// exp is looked up in the table torch computed: nvcc's expf and the exp in
// torch's binary come from different builds and may differ in the last bit.
// The sum keeps edge_weights' order and the divide is __fdiv_rn, so the
// weights equal the plain version's (ops/fused_sweep.py) bit for bit, and
// the sweeps run the same jc_point as K1.
//
// What bounds it on the card. At 4K L0 (2160 x 3840) the five f32 planes
// K1 reads are 13 B/px x 8.3 MPix = 108 MB, twice the H100's 50 MB L2, so
// every K1 launch streams them from device memory. K6 reads 3 B/px of u8
// planes per launch (plus the halo). Its 31 sweeps of 16 operations a pixel
// bound it by the SMs' issue rate (0.128 ms), as K1.
//
// What the design does about it. K6 is K1's kernel (jc_tiles.cuh) with
// another prologue: a thread owns a column of R pixels of the extended
// tile and derives their weights into registers, once per launch, from
// the u8 values of its own column (one row above to one row below its
// pixels) and of the columns beside it, which it reads through the
// read-only path; wl is the pair one column left, wu of its first pixel
// the pair one row up, and wu of every other pixel is the wd of the pixel
// above it. A pair that leaves the image weighs 0, and pixels outside the
// image carry mask 1 and u = 0. The sweep loop is then K1's: u in two
// shared buffers with a zero ring, two shared loads and one store a
// pixel, no weight read from shared or device memory, no divide and no
// bounds test. Shared memory is 8 B per extended pixel (35 KB for the
// 64 x 64 tile). (A first form kept u, prev, bh, bv, inv and the mask in
// shared memory, 21 B a pixel, 80 KB at k = 8, and spent twelve shared
// loads, a divide and four bounds tests per pixel and sweep; PERF.md has
// both forms' times.)

#include <cfloat>

#include <cuda_runtime.h>

#include "jc_tiles.cuh"

// The weight between two neighbouring pixels of one level, from their gray
// and d8 values; a value below 0 marks a pixel outside the image, and such
// a pair weighs 0. Selects and no branch, so that the table lookups of a
// thread's pixels are all in flight together.
__device__ __forceinline__ float pair_weight(int ga, int gb, int da, int db,
                                             const float* __restrict__ etab, int thr,
                                             int use_depth_rule) {
  const float e = __ldg(etab + min(abs(gb - ga), 255));
  const float wgt = use_depth_rule && abs(db - da) <= thr ? 1.0f : e;
  return ga >= 0 && gb >= 0 ? wgt : 0.0f;
}

// R pixels per thread, at most MAXT threads per CTA, as K1.
template <int R, int MAXT>
__global__ void __launch_bounds__(MAXT)
jc_sweep_fused_kernel(const float* __restrict__ u_in, const float* __restrict__ p_in,
                      float* __restrict__ u_out, float* __restrict__ p_out,
                      const unsigned char* __restrict__ gray,
                      const unsigned char* __restrict__ mask,
                      const unsigned char* __restrict__ d8,
                      const float* __restrict__ abc, const float* __restrict__ etab,
                      int h, int w, int base, int n_active, int k, int thr,
                      int use_depth_rule, const int* __restrict__ stop) {
  // A stopped launch runs no sweep and writes its input back, as K1's.
  if (stop != nullptr && *stop) n_active = 0;
  extern __shared__ float smem[];
  const int ew = blockDim.x;
  const int eh = blockDim.y * R;
  const int pitch = ew + 2;
  float* cur = smem;
  float* nxt = smem + (eh + 2) * pitch;
  const int y0 = blockIdx.y * (eh - 2 * k) - k;  // the extended tile's origin
  const int x0 = blockIdx.x * (ew - 2 * k) - k;
  jc_zero_ring(cur, nxt, eh, ew);

  const int tx = threadIdx.x;
  const int ly0 = threadIdx.y * R;  // the thread's first row in the tile
  const int gx = x0 + tx;
  const bool col_in = gx >= 0 && gx < w;
  const bool left_in = gx - 1 >= 0 && gx - 1 < w;
  const bool right_in = gx + 1 >= 0 && gx + 1 < w;

  // gray and d8 of the thread's column, from the row above its first pixel
  // to the row below its last; -1 outside the image.
  int gc[R + 2], dc[R + 2];
#pragma unroll
  for (int i = 0; i < R + 2; ++i) {
    const int gy = y0 + ly0 - 1 + i;
    const bool in = col_in && gy >= 0 && gy < h;
    const size_t g = (size_t)gy * w + gx;
    gc[i] = in ? (int)__ldg(gray + g) : -1;
    dc[i] = in ? (int)__ldg(d8 + g) : -1;
  }

  float u[R], pv[R], wl[R], wr[R], wd[R], iv[R];
  unsigned msk = 0;
  const float wu0 = pair_weight(gc[0], gc[1], dc[0], dc[1], etab, thr, use_depth_rule);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int gy = y0 + ly0 + r;
    const bool row_in = gy >= 0 && gy < h;
    const bool in = col_in && row_in;
    const size_t g = (size_t)gy * w + gx;
    u[r] = in ? u_in[g] : 0.0f;
    pv[r] = in ? p_in[g] : 0.0f;
    msk |= (unsigned)(in ? mask[g] != 0 : 1) << r;
    const int gl = row_in && left_in ? (int)__ldg(gray + g - 1) : -1;
    const int dl = row_in && left_in ? (int)__ldg(d8 + g - 1) : -1;
    const int gr = row_in && right_in ? (int)__ldg(gray + g + 1) : -1;
    const int dr = row_in && right_in ? (int)__ldg(d8 + g + 1) : -1;
    wl[r] = pair_weight(gl, gc[r + 1], dl, dc[r + 1], etab, thr, use_depth_rule);
    wr[r] = pair_weight(gc[r + 1], gr, dc[r + 1], dr, etab, thr, use_depth_rule);
    wd[r] = pair_weight(gc[r + 1], gc[r + 2], dc[r + 1], dc[r + 2], etab, thr, use_depth_rule);
    const float wu = r > 0 ? wd[r > 0 ? r - 1 : 0] : wu0;
    float count = __fadd_rn(wl[r], wr[r]);
    count = __fadd_rn(count, wu);
    count = __fadd_rn(count, wd[r]);
    iv[r] = count >= FLT_MIN ? __fdiv_rn(1.0f, count) : 0.0f;
  }
  jc_column_sweeps<R>(u, pv, wl, wr, wd, iv, wu0, msk, cur, nxt, (ly0 + 1) * pitch + tx + 1,
                      pitch, abc, base, n_active);
  jc_column_store<R>(u, pv, u_out, p_out, y0, ly0, gx, eh, ew, k, h, w);
}

static int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <int R, int MAXT>
static int launch_fused(const float* u_in, const float* p_in, float* u_out, float* p_out,
                        const unsigned char* gray, const unsigned char* mask,
                        const unsigned char* d8, const float* abc, const float* etab, int h,
                        int w, int base, int n_active, int k, int thr, int use_depth_rule,
                        int bx, int by, const int* stop, cudaStream_t stream) {
  const int eh = by * R;
  if (bx * by > MAXT || bx - 2 * k < 1 || eh - 2 * k < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = jc_tile_smem(bx, by, R);
  int err = set_smem((const void*)jc_sweep_fused_kernel<R, MAXT>, smem);
  if (err) return err;
  const dim3 grid((w + bx - 2 * k - 1) / (bx - 2 * k), (h + eh - 2 * k - 1) / (eh - 2 * k));
  jc_sweep_fused_kernel<R, MAXT><<<grid, dim3(bx, by), smem, stream>>>(
      u_in, p_in, u_out, p_out, gray, mask, d8, abc, etab, h, w, base, n_active, k, thr,
      use_depth_rule, stop);
  return (int)cudaGetLastError();
}

// (bx, by, rows_per_thread) is K1's CTA shape (sweep.cu:jc_sweep_tiles):
// 8 rows a thread at up to 512 threads, or 6 at up to 1024. stop is null,
// or a device int that, when non-zero, turns the launch into a copy of
// (u_in, p_in) to (u_out, p_out).
extern "C" int jc_sweep_fused(const float* u_in, const float* p_in, float* u_out,
                              float* p_out, const unsigned char* gray,
                              const unsigned char* mask, const unsigned char* d8,
                              const float* abc, const float* etab, int h, int w, int base,
                              int n_active, int k, int thr, int use_depth_rule, int bx,
                              int by, int rows_per_thread, const int* stop, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (rows_per_thread == 8)
    return launch_fused<8, 512>(u_in, p_in, u_out, p_out, gray, mask, d8, abc, etab, h, w,
                                base, n_active, k, thr, use_depth_rule, bx, by, stop, s);
  if (rows_per_thread == 6)
    return launch_fused<6, 1024>(u_in, p_in, u_out, p_out, gray, mask, d8, abc, etab, h, w,
                                 base, n_active, k, thr, use_depth_rule, bx, by, stop, s);
  return (int)cudaErrorInvalidValue;
}
