// K6 jc_sweep_fused: Jacobi-Chebyshev sweeps that derive their edge
// weights in the kernel, for Hopper (sm_90a).
//
// Replaces the TPU derived-weights arena megakernel
//   realtimedepthdiffusion_tpu/ops/pallas_sweep.py:_strip_mega_kernel_uarena (:394)
//
// It computes what K1 (sweep.cu) computes, up to k sweeps of one level per
// launch on a TILE_H x TILE_W tile with a k-ring halo, (u, prev) ping-pong
// between launches and n_active sweeps in the ragged last launch. It takes
// no f32 weight planes. Its inputs are u8 planes: gray, the scribble mask,
// and d8 = trunc(clip(level-entry depth, 0, 255)); the 256-entry table
// etab[g] = exp(-beta*g), pinned to 0 below FLT_MIN; the depth threshold
// thr (0 at level 0) and whether the depth rule applies (every level but
// the coarsest). Once per launch it derives the tile's weights by the rule
// of core/weights.py:edge_weights:
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
// planes per launch (plus the halo) and keeps the derived weights in shared
// memory for its k sweeps, which then touch no weight in device memory.
// The price is shared memory: u, prev, bh, bv, inv (f32) and mask (u8) are
// 21 B per tile pixel, 80 KB at k = 8 (48 x 80), so two CTAs per SM, and
// one derivation per launch. On an NVIDIA H100 80GB HBM3 at its 700 W
// limit that made K6 slower than K1 alone at 4K L0 (2.0 against 1.6 ms)
// but faster than K1 plus the torch ops that build its planes (2.6 ms);
// PERF.md has the numbers.

#include <cfloat>

#include <cuda_runtime.h>

#include "jc_sweep.cuh"

#define FUSED_TILE_H 32
#define FUSED_TILE_W 64
#define FUSED_THREADS 512

// The weight between pixels p and q = p + step of one level.
__device__ __forceinline__ float pair_weight(const unsigned char* __restrict__ gray,
                                             const unsigned char* __restrict__ d8,
                                             const float* __restrict__ etab, size_t p,
                                             size_t q, int thr, int use_depth_rule) {
  if (use_depth_rule && abs((int)__ldg(d8 + q) - (int)__ldg(d8 + p)) <= thr) return 1.0f;
  return __ldg(etab + abs((int)__ldg(gray + q) - (int)__ldg(gray + p)));
}

__global__ void __launch_bounds__(FUSED_THREADS, 2)
jc_sweep_fused_kernel(const float* __restrict__ u_in, const float* __restrict__ p_in,
                      float* __restrict__ u_out, float* __restrict__ p_out,
                      const unsigned char* __restrict__ gray,
                      const unsigned char* __restrict__ mask,
                      const unsigned char* __restrict__ d8,
                      const float* __restrict__ abc, const float* __restrict__ etab,
                      int h, int w, int base, int n_active, int k, int thr,
                      int use_depth_rule) {
  extern __shared__ float smem[];
  const int th = FUSED_TILE_H + 2 * k;
  const int tw = FUSED_TILE_W + 2 * k;
  const int n = th * tw;
  float* A = smem;  // u, then prev: the two swap roles every sweep (see K1)
  float* B = A + n;
  float* sbh = B + n;
  float* sbv = sbh + n;
  float* sinv = sbv + n;
  unsigned char* sm = reinterpret_cast<unsigned char*>(sinv + n);
  const int y0 = blockIdx.y * FUSED_TILE_H - k;
  const int x0 = blockIdx.x * FUSED_TILE_W - k;

  // The state, the mask and the pair weights of every tile pixel. Outside
  // the image the state is 0 and never written, and every weight is 0.
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int ly = i / tw;
    const int gy = y0 + ly;
    const int gx = x0 + (i - ly * tw);
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
    const size_t g = (size_t)gy * w + gx;
    A[i] = in ? u_in[g] : 0.0f;
    B[i] = in ? p_in[g] : 0.0f;
    sm[i] = in ? mask[g] : 1;
    sbh[i] = in && gx + 1 < w ? pair_weight(gray, d8, etab, g, g + 1, thr, use_depth_rule)
                              : 0.0f;
    sbv[i] = in && gy + 1 < h ? pair_weight(gray, d8, etab, g, g + w, thr, use_depth_rule)
                              : 0.0f;
  }
  __syncthreads();

  // inv of every pixel a sweep can update (ring >= 1, so its left and upper
  // pairs lie in the tile).
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int ly = i / tw;
    const int lx = i - ly * tw;
    if (ly == 0 || lx == 0) continue;
    float count = __fadd_rn(sbh[i - 1], sbh[i]);
    count = __fadd_rn(count, sbv[i - tw]);
    count = __fadd_rn(count, sbv[i]);
    sinv[i] = count >= FLT_MIN ? __fdiv_rn(1.0f, count) : 0.0f;
  }
  __syncthreads();

  for (int s = 0; s < n_active; ++s) {
    const float a = __ldg(abc + 3 * (base + s));
    const float b = __ldg(abc + 3 * (base + s) + 1);
    const float c = __ldg(abc + 3 * (base + s) + 2);
    // As in K1: sweep s computes ring >= s + 1 from the exact ring >= s.
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
      const int li = ly * tw + lx;
      B[li] = jc_point(A[li - 1], A[li + 1], A[li - tw], A[li + tw], A[li], B[li],
                       sbh[li - 1], sbh[li], sbv[li - tw], sbv[li], sinv[li], sm[li],
                       a, b, c);
    }
    __syncthreads();
    float* t = A;
    A = B;
    B = t;
  }

  for (int i = threadIdx.x; i < FUSED_TILE_H * FUSED_TILE_W; i += blockDim.x) {
    const int ty = i / FUSED_TILE_W;
    const int tx = i - ty * FUSED_TILE_W;
    const int gy = blockIdx.y * FUSED_TILE_H + ty;
    const int gx = blockIdx.x * FUSED_TILE_W + tx;
    if (gy >= h || gx >= w) continue;
    const size_t g = (size_t)gy * w + gx;
    const int li = (ty + k) * tw + tx + k;
    u_out[g] = A[li];
    p_out[g] = B[li];
  }
}

static int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

extern "C" int jc_sweep_fused(const float* u_in, const float* p_in, float* u_out,
                              float* p_out, const unsigned char* gray,
                              const unsigned char* mask, const unsigned char* d8,
                              const float* abc, const float* etab, int h, int w, int base,
                              int n_active, int k, int thr, int use_depth_rule,
                              void* stream) {
  const size_t n = (size_t)(FUSED_TILE_H + 2 * k) * (FUSED_TILE_W + 2 * k);
  const size_t smem = n * (5 * sizeof(float) + 1);
  int err = set_smem((const void*)jc_sweep_fused_kernel, smem);
  if (err) return err;
  const dim3 grid((w + FUSED_TILE_W - 1) / FUSED_TILE_W, (h + FUSED_TILE_H - 1) / FUSED_TILE_H);
  jc_sweep_fused_kernel<<<grid, FUSED_THREADS, smem, (cudaStream_t)stream>>>(
      u_in, p_in, u_out, p_out, gray, mask, d8, abc, etab, h, w, base, n_active, k, thr,
      use_depth_rule);
  return (int)cudaGetLastError();
}
