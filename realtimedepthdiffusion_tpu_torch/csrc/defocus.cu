// K3 defocus_box: the exact depth-proportional box blur for Hopper (sm_90a).
//
// Replaces the TPU defocus kernel
//   realtimedepthdiffusion_tpu/ops/pallas_defocus.py:_defocus_kernel (:234)
// and its prologue defocus_half_widths (:551-566). The output is (H, W, 3)
// uint8, equal bit for bit to core/effects.py:defocus_xla and to the plain
// version ops/defocus.py:defocus_sat.
//
// The entry point defocus_block runs the same blur on one block of a
// sharded image, in place of the TPU block kernel
//   realtimedepthdiffusion_tpu/ops/pallas_defocus.py:defocus_block_pallas (:569).
// Its input is the (3, hb + 2*ring, wb + 2*ring) channel-major block with a
// ring of neighbour pixels (zeros past the image), its half-widths are given
// (computed on the whole image), and its output is the (hb, wb, 3) interior.
// Box sums are taken in the extended block; the count clips the window
// against the whole image, at the pixel's global position (oy + y, ox + x).
// A whole image is the case ring 0, origin (0, 0) and full size (h, w),
// which is what defocus_box runs.
//
// Per pixel, half = min(trunc(k * max(d, 0) / 255) / 2, max_half), snapped
// onto the approx candidate set when asked; the window is rows
// [y-half, y+half-1] x cols [x-half, x+half-1] clipped to the image, and
// the output is trunc(box sum / clipped count) per channel, or the pixel
// itself where half == 0. The half-width is taken in one pinned rounding
// form, trunc(__fdiv_rn(__fmul_rn(k, max(d, 0)), 255)): left to itself the
// compiler may reorder k*d/255, and a half-width would then flip between
// this kernel and the plain version.
//
// What bounds it on the card: bytes. The function reads 3 B of colour and
// 4 B of depth a pixel and writes 3 B; the arithmetic is a few integer
// operations per byte. The TPU kernel marched every candidate half over a
// strip because a per-pixel gather is slow there. A GPU gathers cheaply,
// so both routes read the four corners of a summed-area table (SAT) at the
// pixel's own half: O(1) work per pixel whatever the aperture.
//
// The tile route (defocus_tile_kernel), one launch, no table in device
// memory. A box sum does not depend on the table's origin, so a CTA takes
// the table of its own neighbourhood: it owns a T x T tile of outputs,
// finds the largest half-width among them (the region it needs is the tile
// plus that margin, clipped to the image; a tile with none copies its
// pixels), and then, one channel at a time, loads the region's u8 values
// into shared memory as 32-bit words, scans them along rows (a thread per
// row) and along columns (a thread per column) with a barrier between, and
// lets every thread read its pixels' four corners there. Rows have an odd
// pitch, so both scans are free of bank conflicts. A region is at most 240
// a side (shared memory holds no more), so a local sum is at most
// 255 * 240^2 < 2^24: no wrap, and the convert to f32 is exact. Neighbouring
// tiles scan overlapping regions: integer work on u8 data that L2 serves,
// in exchange for the table's traffic (12 B a pixel written twice and 48 B
// a pixel gathered, from a table of 25 MB at 1080p and 100 MB at 4K, twice
// the L2). What holds a tile back is latency: five phases a channel with a
// barrier between, the scans on a quarter of the CTA's threads. So loads
// go out eight at a time, and two CTAs share an SM where their tables fit,
// each in another phase.
//
// The table route, for apertures whose region does not fit one CTA's
// shared memory: the 32-bit SAT of each channel of the whole image in
// device memory, then a gather.
//   1. defocus_half_kernel: half per pixel.
//   2. sat_rows_kernel: a CTA per row and channel scans it in chunks of its
//      256 threads (a warp-shuffle scan, the warps' totals through shared
//      memory, a carry from chunk to chunk).
//   3. sat_band_totals_kernel + sat_cols_kernel: the column scan in bands
//      of 64 rows. A thread sums one column of one band; then a thread per
//      column and band adds up the totals of the bands above it and writes
//      the running sums of its own. No thread walks a whole column.
//      The largest entry is 255*h*w: 2,115,072,000 at 2160x3840,
//      2,256,076,800 at DCI 4K (2160x4096), which passes 2^31 - 1. So the
//      SAT is unsigned, which wraps modulo 2^32 by definition (signed
//      overflow is undefined behaviour in C++).
//   4. defocus_gather_kernel: four corners, the clipped count, one
//      correctly rounded f32 divide, truncation to u8. The corner
//      difference is taken modulo 2^32 too: it equals the true box sum,
//      which is below 2^24 for any half up to 128, so wrapped entries
//      give the exact box.

#include <cuda_runtime.h>

#define SAT_ROW_THREADS 256
#define SAT_BAND_ROWS 64

// The rule that turns a depth into a half-width.
struct HalfRule {
  int k, max_half, approx, t, q, cmax;
};

static HalfRule half_rule(int k, int max_half, int approx, int exact_upto, int stride) {
  const int t = approx ? exact_upto : 0;
  const int cmax = approx ? t + (max_half - t) / stride * stride : max_half;
  return {k, max_half, approx, t, stride, cmax};
}

__device__ __forceinline__ int half_width(float depth, const HalfRule& r) {
  const float d = fmaxf(depth, 0.0f);
  const int ka = (int)__fdiv_rn(__fmul_rn((float)r.k, d), 255.0f);
  int hv = min(ka / 2, r.max_half);
  if (r.approx && hv > r.t) {
    // Round onto t + j*q, ties upward, clamped to [t, cmax].
    hv = min(max(r.t + ((hv - r.t + r.q / 2) / r.q) * r.q, r.t), r.cmax);
  }
  return hv;
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

// Where the hb x wb outputs sit: at (ring, ring) in the image the sums are
// taken over, and at (oy, ox) in a full_h x full_w image.
struct BlockGeom {
  int hb, wb, ring, oy, ox, full_h, full_w;
};

// The clipped count of the window of half hv around output pixel (y, x).
__device__ __forceinline__ float window_count(const BlockGeom& g, int y, int x, int hv) {
  const int gy = g.oy + y;
  const int gx = g.ox + x;
  return (float)((min(gy + hv, g.full_h) - max(gy - hv, 0)) *
                 (min(gx + hv, g.full_w) - max(gx - hv, 0)));
}

// -- the tile route -----------------------------------------------------------

// The running sum of the n words from p at the given stride, in place,
// eight at a time: their loads are in flight together.
__device__ __forceinline__ void scan_line(unsigned* p, int stride, int n) {
  unsigned acc = 0;
  int i = 0;
  for (; i + 8 <= n; i += 8) {
    unsigned v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = p[(i + j) * stride];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc += v[j];
      p[(i + j) * stride] = acc;
    }
  }
  for (; i < n; ++i) {
    acc += p[i * stride];
    p[i * stride] = acc;
  }
}

// A CTA of NT threads owns a T x T tile; thread t owns column t % T of the
// rows t / T + i * (NT / T). Half-widths come from depth (a whole image) or
// from half_in (a block, whose values above max_half are clamped: the
// region holds no more). Dynamic shared memory: (T + 2*max_half + 1)^2
// 32-bit words, the table S with a zero row and column in front:
// S[r][c] is the sum over the region's rows < r and columns < c. MINB CTAs
// share an SM, which caps the registers of a thread.
template <int T, int NT, int MINB>
__global__ void __launch_bounds__(NT, MINB)
defocus_tile_kernel(U8Image img, const float* __restrict__ depth,
                    const unsigned char* __restrict__ half_in, HalfRule rule,
                    unsigned char* __restrict__ out, BlockGeom g) {
  static_assert(NT % T == 0 && (T * T) % NT == 0 && NT % 32 == 0, "tile shape");
  constexpr int PX = T * T / NT;  // pixels per thread
  constexpr int RSTEP = NT / T;   // rows between two of them
  constexpr int NW = NT / 32;     // warps
  extern __shared__ unsigned S[];
  __shared__ int s_margin;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int x = blockIdx.x * T + tid % T;
  const int yt = blockIdx.y * T + tid / T;
  const bool col_in = x < g.wb;

  // A pixel's window as four 8-bit table coordinates (ya, yb, xa, xb: the
  // region is at most 241 a side); first its half-width.
  unsigned win[PX];
  int margin = 0;
#pragma unroll
  for (int i = 0; i < PX; ++i) {
    const int y = yt + i * RSTEP;
    int hv = 0;
    if (col_in && y < g.hb) {
      const size_t p = (size_t)y * g.wb + x;
      hv = depth ? half_width(depth[p], rule) : min((int)half_in[p], rule.max_half);
    }
    win[i] = hv;
    margin = max(margin, hv);
  }
  if (tid == 0) s_margin = 0;
  __syncthreads();
  margin = __reduce_max_sync(0xffffffffu, margin);
  if (lane == 0 && margin > 0) atomicMax(&s_margin, margin);
  __syncthreads();
  margin = s_margin;

  if (margin == 0) {  // a sharp tile: every pixel is itself
#pragma unroll
    for (int i = 0; i < PX; ++i) {
      const int y = yt + i * RSTEP;
      if (!col_in || y >= g.hb) continue;
      const size_t p = (size_t)y * g.wb + x;
      for (int c = 0; c < 3; ++c) out[3 * p + c] = img.at(c, y + g.ring, x + g.ring);
    }
    return;
  }

  // The region: the tile plus the margin, clipped to the summed image.
  const int he = g.hb + 2 * g.ring;
  const int we = g.wb + 2 * g.ring;
  const int ty0 = blockIdx.y * T + g.ring;
  const int tx0 = blockIdx.x * T + g.ring;
  const int ry0 = max(ty0 - margin, 0);
  const int rx0 = max(tx0 - margin, 0);
  const int rh = min(ty0 + min(T, g.hb - (int)blockIdx.y * T) + margin, he) - ry0;
  const int rw = min(tx0 + min(T, g.wb - (int)blockIdx.x * T) + margin, we) - rx0;
  const int pitch = T + 2 * rule.max_half + 1;  // odd
  for (int i = tid; i <= rw; i += NT) S[i] = 0;
  for (int i = tid; i < rh; i += NT) S[(i + 1) * pitch] = 0;

  // The divisor: the clipped count, or 1 where half is 0, whose window is
  // the pixel itself. A pixel outside the block reads the empty box at S[0].
  float cnt[PX];
  unsigned res[PX];
#pragma unroll
  for (int i = 0; i < PX; ++i) {
    const int y = yt + i * RSTEP;
    const int h = (int)win[i];
    const int ly = y + g.ring;
    const int lx = x + g.ring;
    cnt[i] = h ? window_count(g, y, x, h) : 1.0f;
    res[i] = 0;
    win[i] = 0;
    if (col_in && y < g.hb) {
      const int ya = max(ly - h, 0) - ry0;
      const int yb = (h ? min(ly + h, he) : ly + 1) - ry0;
      const int xa = max(lx - h, 0) - rx0;
      const int xb = (h ? min(lx + h, we) : lx + 1) - rx0;
      win[i] = ya | yb << 8 | xa << 16 | xb << 24;
    }
  }

#pragma unroll 1
  for (int c = 0; c < 3; ++c) {
    // Nobody reads the last channel's table any more.
    if (c > 0) __syncthreads();
    // Two rows of four chunks a pass: eight loads in flight for each warp
    // (written out, since the compiler will not move a load from the
    // image above a store into the table).
    const unsigned char* __restrict__ plane = img.p + c * img.cs + rx0 * img.xs;
    for (int yy = warp; yy < rh; yy += 2 * NW) {
      const unsigned char* src = plane + (ry0 + yy) * img.ys;
      unsigned* dst = S + (yy + 1) * pitch + 1;
      const bool two = yy + NW < rh;
      for (int x0 = lane; x0 < rw; x0 += 128) {
        unsigned a[4], b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int xx = x0 + 32 * j;
          a[j] = xx < rw ? __ldg(src + xx * img.xs) : 0u;
          b[j] = two && xx < rw ? __ldg(src + NW * img.ys + xx * img.xs) : 0u;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int xx = x0 + 32 * j;
          if (xx < rw) dst[xx] = a[j];
          if (two && xx < rw) dst[NW * pitch + xx] = b[j];
        }
      }
    }
    __syncthreads();
    if (tid < rh) scan_line(S + (tid + 1) * pitch + 1, 1, rw);
    __syncthreads();
    if (tid < rw) scan_line(S + pitch + tid + 1, pitch, rh);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PX; ++i) {
      const unsigned* ra = S + (win[i] & 255u) * pitch;
      const unsigned* rb = S + ((win[i] >> 8) & 255u) * pitch;
      const unsigned xa = (win[i] >> 16) & 255u;
      const unsigned xb = win[i] >> 24;
      // box < 2^24, so the convert is exact, like the reference's.
      const int box = (int)(rb[xb] - ra[xb] - rb[xa] + ra[xa]);
      // Truncated to 8 bits, as the plain version's cast does: a ring with
      // content past the image can put a mean above 255.
      res[i] |= ((unsigned)(int)__fdiv_rn((float)box, cnt[i]) & 255u) << (8 * c);
    }
  }

#pragma unroll
  for (int i = 0; i < PX; ++i) {
    const int y = yt + i * RSTEP;
    if (!col_in || y >= g.hb) continue;
    const size_t p = (size_t)y * g.wb + x;
    out[3 * p] = (unsigned char)(res[i] & 255u);
    out[3 * p + 1] = (unsigned char)((res[i] >> 8) & 255u);
    out[3 * p + 2] = (unsigned char)(res[i] >> 16);
  }
}

template <int T, int NT, int MINB>
static int launch_tile(U8Image img, const float* depth, const unsigned char* half_in,
                       HalfRule rule, unsigned char* out, BlockGeom g, cudaStream_t s) {
  const size_t side = T + 2 * rule.max_half + 1;
  const size_t smem = side * side * sizeof(unsigned);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute((const void*)defocus_tile_kernel<T, NT, MINB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  defocus_tile_kernel<T, NT, MINB>
      <<<dim3((g.wb + T - 1) / T, (g.hb + T - 1) / T), NT, smem, s>>>(img, depth, half_in, rule,
                                                                       out, g);
  return (int)cudaGetLastError();
}

// tile picks the instance: 64 pixels a side on 512 threads, two CTAs an
// SM where their tables fit, or 96 a side on 768 threads, one CTA an SM.
static int tile_blur(U8Image img, const float* depth, const unsigned char* half_in,
                     HalfRule rule, unsigned char* out, BlockGeom g, int tile,
                     cudaStream_t s) {
  if (tile == 64) return launch_tile<64, 512, 2>(img, depth, half_in, rule, out, g, s);
  if (tile == 96) return launch_tile<96, 768, 1>(img, depth, half_in, rule, out, g, s);
  return (int)cudaErrorInvalidValue;
}

// -- the table route ----------------------------------------------------------

__global__ void defocus_half_kernel(const float* __restrict__ depth,
                                    unsigned char* __restrict__ half, int n, HalfRule rule) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  half[i] = (unsigned char)half_width(depth[i], rule);
}

__global__ void __launch_bounds__(SAT_ROW_THREADS)
sat_rows_kernel(U8Image img, unsigned* __restrict__ sat, int h, int w) {
  __shared__ unsigned totals[SAT_ROW_THREADS / 32];
  const int y = blockIdx.x;
  const int c = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned* srow = sat + ((size_t)c * (h + 1) + y + 1) * (w + 1);
  if (threadIdx.x == 0) srow[0] = 0;
  unsigned carry = 0;
  for (int x0 = 0; x0 < w; x0 += SAT_ROW_THREADS) {
    const int x = x0 + threadIdx.x;
    unsigned v = x < w ? img.at(c, y, x) : 0u;
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned up = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += up;
    }
    if (lane == 31) totals[warp] = v;
    __syncthreads();
    unsigned before = carry;
    for (int i = 0; i < SAT_ROW_THREADS / 32; ++i) {
      const unsigned t = totals[i];
      if (i < warp) before += t;
      carry += t;
    }
    if (x < w) srow[x + 1] = v + before;
    __syncthreads();
  }
}

// tot[c][band][x]: the sum of column x of the row-scanned table over the
// rows of one band.
__global__ void sat_band_totals_kernel(const unsigned* __restrict__ sat,
                                       unsigned* __restrict__ tot, int h, int w) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int band = blockIdx.y;
  const int c = blockIdx.z;
  if (x > w) return;
  const unsigned* col = sat + (size_t)c * (h + 1) * (w + 1) + x;
  const int y1 = min((band + 1) * SAT_BAND_ROWS, h);
  unsigned acc = 0;
  for (int y = band * SAT_BAND_ROWS + 1; y <= y1; ++y) acc += col[(size_t)y * (w + 1)];
  tot[((size_t)c * gridDim.y + band) * (w + 1) + x] = acc;
}

__global__ void sat_cols_kernel(unsigned* __restrict__ sat, const unsigned* __restrict__ tot,
                                int h, int w) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int band = blockIdx.y;
  const int c = blockIdx.z;
  if (x > w) return;
  unsigned* col = sat + (size_t)c * (h + 1) * (w + 1) + x;
  if (band == 0) col[0] = 0;
  unsigned acc = 0;
  for (int b = 0; b < band; ++b) acc += tot[((size_t)c * gridDim.y + b) * (w + 1) + x];
  const int y1 = min((band + 1) * SAT_BAND_ROWS, h);
  for (int y = band * SAT_BAND_ROWS + 1; y <= y1; ++y) {
    acc += col[(size_t)y * (w + 1)];
    col[(size_t)y * (w + 1)] = acc;
  }
}

__global__ void defocus_gather_kernel(U8Image img, const unsigned char* __restrict__ half,
                                      const unsigned* __restrict__ sat,
                                      unsigned char* __restrict__ out, BlockGeom g) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= g.wb) return;
  const size_t p = (size_t)y * g.wb + x;
  const int hv = half[p];
  const int ly = y + g.ring;
  const int lx = x + g.ring;
  if (hv == 0) {
    out[3 * p] = img.at(0, ly, lx);
    out[3 * p + 1] = img.at(1, ly, lx);
    out[3 * p + 2] = img.at(2, ly, lx);
    return;
  }
  const int he = g.hb + 2 * g.ring;
  const int we = g.wb + 2 * g.ring;
  const int ya = max(ly - hv, 0);
  const int yb = min(ly + hv, he);
  const int xa = max(lx - hv, 0);
  const int xb = min(lx + hv, we);
  const float cnt = window_count(g, y, x, hv);
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
// its hb x wb interior. tot is scratch for 3 x bands x (we + 1) totals.
static int table_blur(U8Image img, const unsigned char* half, unsigned* sat, unsigned* tot,
                      unsigned char* out, BlockGeom g, cudaStream_t s) {
  const int he = g.hb + 2 * g.ring;
  const int we = g.wb + 2 * g.ring;
  const dim3 cols((we + 1 + 127) / 128, (he + SAT_BAND_ROWS - 1) / SAT_BAND_ROWS, 3);
  cudaError_t err;
  sat_rows_kernel<<<dim3(he, 3), SAT_ROW_THREADS, 0, s>>>(img, sat, he, we);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sat_band_totals_kernel<<<cols, 128, 0, s>>>(sat, tot, he, we);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sat_cols_kernel<<<cols, 128, 0, s>>>(sat, tot, he, we);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  defocus_gather_kernel<<<dim3((g.wb + 127) / 128, g.hb), 128, 0, s>>>(img, half, sat, out, g);
  return (int)cudaGetLastError();
}

// tile > 0 runs the tile route on tiles of that side; half, sat and tot are
// not touched and may be null. tile == 0 runs the table route.
extern "C" int defocus_box(const unsigned char* rgb, const float* depth,
                           unsigned char* half, unsigned* sat, unsigned* tot,
                           unsigned char* out, int h, int w, int k, int max_half, int approx,
                           int exact_upto, int stride, int tile, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const HalfRule rule = half_rule(k, max_half, approx, exact_upto, stride);
  const U8Image img = {rgb, 1, 3LL * w, 3};
  const BlockGeom g = {h, w, 0, 0, 0, h, w};
  if (tile > 0) return tile_blur(img, depth, nullptr, rule, out, g, tile, s);
  const int n = h * w;
  defocus_half_kernel<<<(n + 255) / 256, 256, 0, s>>>(depth, half, n, rule);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return table_blur(img, half, sat, tot, out, g, s);
}

// The half-widths are at most max_half (the tile route clamps them there).
extern "C" int defocus_block(const unsigned char* chw_e, const unsigned char* half,
                             unsigned* sat, unsigned* tot, unsigned char* out, int hb, int wb,
                             int ring, int oy, int ox, int full_h, int full_w, int max_half,
                             int tile, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long we = wb + 2 * ring;
  const U8Image img = {chw_e, (hb + 2LL * ring) * we, we, 1};
  const BlockGeom g = {hb, wb, ring, oy, ox, full_h, full_w};
  if (tile > 0) {
    const HalfRule rule = half_rule(0, max_half, 0, 0, 1);
    return tile_blur(img, nullptr, half, rule, out, g, tile, s);
  }
  return table_blur(img, half, sat, tot, out, g, s);
}
