// The residual early exit's probe for Hopper (sm_90a).
//
// residual_probe replaces no Pallas kernel. The JAX package leaves the probe
// (realtimedepthdiffusion_tpu/core/solver.py: residual_rms / residual_norm
// and the while_loop's bookkeeping around them) to XLA, which fuses it into
// the loop. In the port it was plain torch glue issued after every chunk of
// a level's cap, about 35 launches a chunk, and every one of them ran
// whether the early exit had stopped or not. This kernel does the whole
// probe, its bookkeeping included, in one launch, and a launch after the
// exit returns at once.
//
// What it computes (ops/probe.py:probe_plain, bit for bit per pixel):
//
//   r   = clip((wl*ul + wr*ur + wu*uu + wd*ud) * inv, 0, 255) - u, 0 where
//         scribbled; a neighbour outside the level reads 0
//   rms = sqrt(sum(r*r) / max(count of pixels not scribbled, 1))
//   max = max |r|
//
// then, as the loop's bookkeeping: done[0] += n, done[1] += 1, probes[c] =
// the residual, stop |= !(residual >= tol) (NaN stops). Each product, sum
// and difference is an explicit round-to-nearest intrinsic, so nvcc
// contracts nothing into an FMA, and the clamp keeps a NaN as torch.clamp
// does (fminf / fmaxf would drop it). r*r is rounded to f32 as torch rounds
// it and then summed in f64, in a fixed order, where torch sums in f32: the
// result differs from the plain version's in the last bits of the sum only,
// and is the same on every launch and replay.
//
// What bounds it on the card: bytes. A live probe reads u, the five f32
// weight planes and the u8 mask once, 25 bytes a pixel (the neighbours of
// u come from L1 and L2): 52 MB at 1080p L0, 16 us at 3.35 TB/s. A dead
// probe, the common case under the windowed re-solve, is the launch alone.
//
// What the design does about it. A grid-stride loop over the level's
// pixels, adjacent threads on adjacent pixels, so every plane is read in
// coalesced rows; the grid is a block per 256 pixels up to 528 blocks
// (ops/probe.py:probe_blocks), all resident at once, so a dead launch is
// one wave of blocks that read `stop` and return. Each block
// reduces its threads' partials (warp shuffles, then its warps in order)
// into one slot of `partials`; the last block to take the ticket reduces
// the slots in block order, does the bookkeeping and puts the ticket back
// to 0 for the next launch or replay. So the probe needs no second launch
// and no atomic on a float, and its sum does not depend on which block
// finishes last.

#include <cuda_runtime.h>

namespace {

constexpr int PROBE_THREADS = 256;
constexpr int PROBE_WARPS = PROBE_THREADS / 32;

// a if it is larger or NaN: a max that keeps a NaN, as torch's max does.
__device__ __forceinline__ double nan_max(double a, double b) {
  return (a > b || a != a) ? a : b;
}

// The block's (sum or max, count) in thread 0, in a fixed order: each
// warp's lanes by shuffles, then the warps in order.
__device__ __forceinline__ void block_reduce(double& acc, double& cnt, int is_max) {
  __shared__ double s_acc[PROBE_WARPS], s_cnt[PROBE_WARPS];
  for (int off = 16; off > 0; off >>= 1) {
    const double a = __shfl_down_sync(0xffffffffu, acc, off);
    const double c = __shfl_down_sync(0xffffffffu, cnt, off);
    acc = is_max ? nan_max(acc, a) : acc + a;
    cnt += c;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_acc[warp] = acc;
    s_cnt[warp] = cnt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    acc = s_acc[0];
    cnt = s_cnt[0];
    for (int i = 1; i < PROBE_WARPS; ++i) {
      acc = is_max ? nan_max(acc, s_acc[i]) : acc + s_acc[i];
      cnt += s_cnt[i];
    }
  }
}

__global__ void __launch_bounds__(PROBE_THREADS)
    residual_probe_kernel(const float* __restrict__ u, const float* __restrict__ wl,
                          const float* __restrict__ wr, const float* __restrict__ wu,
                          const float* __restrict__ wd, const float* __restrict__ inv,
                          const unsigned char* __restrict__ mask, int h, int w, int n, int c,
                          float tol, int is_max, int* stop, int* done, float* probes,
                          double* partials, unsigned* ticket) {
  if (*stop) return;  // after the exit: nothing to probe, count or write
  const int hw = h * w;
  double acc = 0.0, cnt = 0.0;
  int free_px = 0;
  for (int i = blockIdx.x * PROBE_THREADS + threadIdx.x; i < hw; i += gridDim.x * PROBE_THREADS) {
    if (mask[i]) continue;  // r = 0: adds nothing to either metric
    const int y = i / w, x = i - y * w;
    const float uc = u[i];
    const float ul = x > 0 ? u[i - 1] : 0.0f;
    const float ur = x + 1 < w ? u[i + 1] : 0.0f;
    const float uu = y > 0 ? u[i - w] : 0.0f;
    const float ud = y + 1 < h ? u[i + w] : 0.0f;
    float s = __fmul_rn(wl[i], ul);
    s = __fadd_rn(s, __fmul_rn(wr[i], ur));
    s = __fadd_rn(s, __fmul_rn(wu[i], uu));
    s = __fadd_rn(s, __fmul_rn(wd[i], ud));
    s = __fmul_rn(s, inv[i]);
    s = s < 0.0f ? 0.0f : (s > 255.0f ? 255.0f : s);  // a NaN stays NaN
    const float r = __fsub_rn(s, uc);
    if (is_max) {
      acc = nan_max(acc, (double)fabsf(r));
    } else {
      acc += (double)__fmul_rn(r, r);
      ++free_px;
    }
  }
  cnt = (double)free_px;
  block_reduce(acc, cnt, is_max);

  __shared__ bool last;
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = acc;
    partials[2 * blockIdx.x + 1] = cnt;
    __threadfence();  // the slot is visible before the ticket is taken
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  // The last block: every other block fenced its slot before its ticket.
  __threadfence();
  acc = 0.0;
  cnt = 0.0;
  for (int b = threadIdx.x; b < gridDim.x; b += PROBE_THREADS) {
    const double a = __ldcg(partials + 2 * b);
    acc = is_max ? nan_max(acc, a) : acc + a;
    cnt += __ldcg(partials + 2 * b + 1);
  }
  __syncthreads();  // block_reduce's shared slots were read above
  block_reduce(acc, cnt, is_max);
  if (threadIdx.x == 0) {
    float res;
    if (is_max) {
      res = (float)acc;  // exact: the largest of f32 values
    } else {
      // sqrt(sum / count) in f32, as torch computes it; the count is exact
      // below 2^24 pixels, as torch's f32 sum of ones is.
      const float count = fmaxf((float)cnt, 1.0f);
      res = __fsqrt_rn(__fdiv_rn(__double2float_rn(acc), count));
    }
    done[0] += n;
    done[1] += 1;
    probes[c] = res;
    if (!(res >= tol)) *stop = 1;  // below the threshold, or NaN
    *ticket = 0u;
  }
}

}  // namespace

// One probe of a level of h x w pixels after a chunk of n iterations: the
// residual (is_max: the max norm, else the rms) into probes[c], the counts
// into done, and stop set where the residual is below tol or NaN; nothing
// where *stop is set on entry. partials holds 2 * blocks doubles, ticket
// one unsigned that is 0 before the launch and after it.
extern "C" int residual_probe(const float* u, const float* wl, const float* wr, const float* wu,
                              const float* wd, const float* inv, const unsigned char* mask,
                              int h, int w, int n, int c, float tol, int is_max, int* stop,
                              int* done, float* probes, double* partials, unsigned* ticket,
                              int blocks, void* stream) {
  residual_probe_kernel<<<blocks, PROBE_THREADS, 0, (cudaStream_t)stream>>>(
      u, wl, wr, wu, wd, inv, mask, h, w, n, c, tol, is_max, stop, done, probes, partials,
      ticket);
  return (int)cudaGetLastError();
}
