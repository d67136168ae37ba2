// The register-blocked tile of the temporally blocked Jacobi-Chebyshev
// kernels: what K1 (jc_sweep_tiles, sweep.cu) and K6 (jc_sweep_fused,
// fused_sweep.cu) share. The two differ only in where a thread's weights
// come from: K1 loads them from f32 planes, K6 derives them from u8 planes.
//
// A CTA of bx x by threads owns an extended tile of (by*R) x bx pixels;
// thread (tx, ty) owns the R pixels of column tx from row ty*R down, with
// their u, prev and weights in registers. u also lives in two shared
// buffers of (by*R + 2) x (bx + 2) floats, for the neighbouring columns: a
// sweep reads one and writes the other. Their one-pixel ring is zeros that
// nobody writes, and pixels outside the image carry mask 1 and u = 0, so
// the sweep loop has no index arithmetic, divide or bounds test.
#pragma once

#include <cuda_runtime.h>

#include "jc_sweep.cuh"

// Shared memory of one tile: the two buffers of u.
static inline size_t jc_tile_smem(int bx, int by, int rows) {
  return 2 * sizeof(float) * (size_t)(by * rows + 2) * (bx + 2);
}

// The zero ring around both buffers; its slots are disjoint from the
// pixels', so no barrier separates it from the threads' first stores.
__device__ __forceinline__ void jc_zero_ring(float* cur, float* nxt, int eh, int ew) {
  const int pitch = ew + 2;
  const int np = (eh + 2) * pitch;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;
  for (int i = tid; i < pitch; i += nt) {
    cur[i] = nxt[i] = 0.0f;
    cur[np - pitch + i] = nxt[np - pitch + i] = 0.0f;
  }
  for (int i = tid; i < eh; i += nt) {
    const int row = (i + 1) * pitch;
    cur[row] = nxt[row] = 0.0f;
    cur[row + ew + 1] = nxt[row + ew + 1] = 0.0f;
  }
}

// Sweeps base .. base+n_active-1 of the (iters, 3) table abc on the
// thread's column, whose first pixel sits at c0 in the buffers. A sweep
// costs, per pixel, two shared loads (the left and right neighbours), one
// shared store and jc_point: the upper and lower neighbours are the
// thread's own registers except at the ends of its column, and prev is the
// pixel's own old u. Each sweep spoils one more ring from the tile's edge
// (the zero ring stands in for the true neighbours), so after n_active <= k
// sweeps ring k inwards is exact. The sweep's (a, b, c) are loaded one
// sweep ahead, off the critical path.
template <int R>
__device__ __forceinline__ void jc_column_sweeps(float (&u)[R], float (&pv)[R],
                                                 const float (&wl)[R], const float (&wr)[R],
                                                 const float (&wd)[R], const float (&iv)[R],
                                                 float wu0, unsigned msk, float* cur,
                                                 float* nxt, int c0, int pitch,
                                                 const float* __restrict__ abc, int base,
                                                 int n_active) {
#pragma unroll
  for (int r = 0; r < R; ++r) cur[c0 + r * pitch] = u[r];
  __syncthreads();

  float a = __ldg(abc + 3 * base), b = __ldg(abc + 3 * base + 1), c = __ldg(abc + 3 * base + 2);
  for (int s = 0; s < n_active; ++s) {
    const int next = 3 * (base + (s + 1 < n_active ? s + 1 : s));
    const float na = __ldg(abc + next), nb = __ldg(abc + next + 1), nc = __ldg(abc + next + 2);
    float above = cur[c0 - pitch];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int li = c0 + r * pitch;
      const float uc = u[r];
      const float below = r + 1 < R ? u[r + 1 < R ? r + 1 : r] : cur[li + pitch];
      const float wu = r > 0 ? wd[r > 0 ? r - 1 : 0] : wu0;
      const float nu = jc_point(cur[li - 1], cur[li + 1], above, below, uc, pv[r], wl[r],
                                wr[r], wu, wd[r], iv[r], (msk >> r) & 1u, a, b, c);
      nxt[li] = nu;
      above = uc;
      pv[r] = uc;
      u[r] = nu;
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
    a = na;
    b = nb;
    c = nc;
  }
}

// Writes back the thread's pixels of the tile's interior (ring k inwards)
// that lie in the image.
template <int R>
__device__ __forceinline__ void jc_column_store(const float (&u)[R], const float (&pv)[R],
                                                float* __restrict__ u_out,
                                                float* __restrict__ p_out, int y0, int ly0,
                                                int gx, int eh, int ew, int k, int h, int w) {
  const int tx = threadIdx.x;
  if (tx < k || tx >= ew - k || gx >= w) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int ly = ly0 + r;
    const int gy = y0 + ly;
    if (ly < k || ly >= eh - k || gy >= h) continue;
    const size_t g = (size_t)gy * w + gx;
    u_out[g] = u[r];
    p_out[g] = pv[r];
  }
}
