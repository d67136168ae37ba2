// Jacobi-Chebyshev sweep kernels for Hopper (sm_90a).
//
// K1 jc_sweep_tiles replaces the TPU strip megakernel
//   realtimedepthdiffusion_tpu/ops/pallas_sweep.py:_strip_mega_kernel_arena (:298)
//   and, on a stack of halo-extended blocks, _halo_block_kernel (:1936)
// K2 jc_sweep_resident replaces the TPU resident kernel
//   realtimedepthdiffusion_tpu/ops/pallas_sweep.py:_resident_kernel (:111)
//
// Layout: every plane is an unpadded row-major (h, w) array, or a stack of
// nb of them. bh[y][x] is the weight between (y, x) and (y, x+1), 0 in the
// last column; bv[y][x] between (y, x) and (y+1, x), 0 in the last row; inv
// is the reciprocal weight sum; mask is 1 on scribbled pixels, which keep
// their value. A neighbour outside the image reads as 0 with weight 0. abc
// is the (iters, 3) float32 table of (a, b, c) per sweep, in device memory.
//
// What bounds them on the card. A sweep does 16 operations per pixel
// (jc_sweep.cuh) and depends on the sweep before it. Read once, the state
// and weights are ~25 bytes a pixel, so a level whose sweeps all stay on
// chip is bound by the SMs' issue rate (1080p L0, 62 sweeps: 0.061 ms), and
// a coarse level of 500-1000 sweeps over a few thousand pixels by the
// latency of one sweep and its barrier.
//
// What the designs do about it.
// K1 blocks in time; its tile and sweep loop are jc_tiles.cuh, which K6
// (fused_sweep.cu) shares. A CTA of bx x by threads owns an extended tile of
// (by*R) x bx pixels: thread (tx, ty) owns the R pixels of column tx from
// row ty*R down. Before the sweep loop each thread loads its pixels' u,
// prev and weights (wl, bh, bv, inv, a mask bit) from device memory into
// registers, one coalesced pass in which a warp reads 128-byte lines; the
// weights are never read again. A sweep then costs, per pixel, two shared
// loads (the left and right neighbours), one shared store (the new u, for
// the neighbouring columns) and jc_point: the upper and lower neighbours
// are the thread's own registers except at the ends of its column, and
// prev is the pixel's own old u. No index arithmetic, divide or bounds
// test runs in the loop: the shared buffers carry a one-pixel ring of
// zeros that nobody writes, and pixels outside the image carry mask 1 and
// u = 0, so every sweep updates the whole tile and they stay 0. Each sweep
// spoils one more ring from the tile's edge (the zero ring stands in for
// the true neighbours), so after n_active <= k sweeps the interior, ring k
// inwards, is exact and is all that is written back. u/prev ping-pong
// between two global buffer pairs from one launch to the next; the last
// launch of a level runs n_active = iters - base sweeps. gridDim.z walks a
// stack of nb planes with one abc table, so the sharded step runs every
// block a card holds in one launch per exchange.
// K2 keeps a whole level on chip in a thread block cluster of C CTAs (C <=
// 16) and runs sweeps base .. base+n-1 in one launch, carrying (u, prev) in
// and out. Each CTA holds a band of at most 17 rows of at most 512 columns,
// one column per thread, laid out as K1's threads hold theirs: weights,
// prev and u in registers, u also in shared memory for the neighbouring
// columns (and bh there, whence wl). The cluster spreads a sweep's issue
// over C SMs, and a level that outgrows one SM (1080p L3 and L2, 4K L4 and
// L3: up to 272 x 512) stays on chip for all its sweeps. A sweep needs the
// rows across the band's edges, which the neighbouring CTAs hold, and
// reading them through distributed shared memory behind a cluster barrier
// costs more than a small band's arithmetic (~1.6 us a sweep at 1080p L4,
// PERF.md). So K2 blocks in time across the cluster, as K1 does across
// tiles: it exchanges the band edges once every s sweeps. After a cluster
// barrier each CTA reads s rows above and below its band from its
// neighbours' mailboxes (their edge rows' u and prev, posted before the
// barrier), then runs s sweeps over the band and s-1 ghost rows each side
// with only the CTA's barrier between them. The ghost rows run jc_point on
// the same inputs in the same order as the neighbour's band rows, and each
// sweep spoils one ghost row from each end, so the band comes out bit for
// bit as with an exchange every sweep; only the band is written back. The
// first block's ghost rows come from device memory. s and the layout are
// picked per launch on the host (ops/sweep.py:resident_plan): ghost rows
// need room in the threads' registers and the neighbours' bands. Thread
// rows of 2, 4 or 6 rows (up to 1024 threads) hold the extended bands,
// with enough warps to hide a sweep's latency; the 17-row bands of 480
// columns (1080p L2, 4K L3) fit none and keep one exchange a sweep, on one
// thread row of 17 rows (up to 512 threads). (A
// first form that kept u, prev and the weights in shared memory, 21 bytes
// a pixel, spent 12 shared loads a pixel and lost to K1 at 1080p L2;
// PERF.md.)

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "jc_tiles.cuh"

namespace cg = cooperative_groups;

// K2: a band of at most RESIDENT_ROWS rows and RESIDENT_MAX_W columns per
// CTA, one column per thread: in one thread row of RESIDENT_ROWS rows, one
// exchange a sweep (instance <RESIDENT_ROWS, RESIDENT_MAX_W>), or with
// ghost rows, at most RESIDENT_MAX_S sweeps per exchange, in thread rows of
// 2, 4 or 6 rows (instances <R, RESIDENT_BLOCKED_T>).
#define RESIDENT_ROWS 17
#define RESIDENT_MAX_W 512
#define RESIDENT_BLOCKED_T 1024
#define RESIDENT_MAX_S 8
#define MAX_CLUSTER 16

// K1: R pixels per thread, at most MAXT threads per CTA (the register
// budget per thread is 65536 / MAXT).
template <int R, int MAXT>
__global__ void __launch_bounds__(MAXT)
jc_sweep_tiles_kernel(const float* __restrict__ u_in, const float* __restrict__ p_in,
                      float* __restrict__ u_out, float* __restrict__ p_out,
                      const float* __restrict__ bh, const float* __restrict__ bv,
                      const float* __restrict__ inv,
                      const unsigned char* __restrict__ mask,
                      const float* __restrict__ abc, int h, int w, int base,
                      int n_active, int k, const int* __restrict__ stop) {
  // A stopped launch runs no sweep and writes its input back: the early
  // exit's chunks ping-pong, and a CUDA graph fixes which buffer holds a
  // chunk's result when it is captured.
  if (stop != nullptr && *stop) n_active = 0;
  extern __shared__ float smem[];
  const int ew = blockDim.x;
  const int eh = blockDim.y * R;
  const int pitch = ew + 2;
  float* cur = smem;
  float* nxt = smem + (eh + 2) * pitch;
  const int y0 = blockIdx.y * (eh - 2 * k) - k;  // the extended tile's origin
  const int x0 = blockIdx.x * (ew - 2 * k) - k;
  const size_t off = (size_t)blockIdx.z * h * w;
  u_in += off;
  p_in += off;
  bh += off;
  bv += off;
  inv += off;
  mask += off;
  jc_zero_ring(cur, nxt, eh, ew);

  const int tx = threadIdx.x;
  const int ly0 = threadIdx.y * R;  // the thread's first row in the tile
  const int gx = x0 + tx;
  const bool col_in = gx >= 0 && gx < w;
  float u[R], pv[R], wl[R], wr[R], wd[R], iv[R];
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
    u[r] = in ? u_in[g] : 0.0f;
    pv[r] = in ? p_in[g] : 0.0f;
    wl[r] = in && gx > 0 ? bh[g - 1] : 0.0f;
    wr[r] = in ? bh[g] : 0.0f;
    wd[r] = in ? bv[g] : 0.0f;
    iv[r] = in ? inv[g] : 0.0f;
    msk |= (unsigned)(in ? mask[g] != 0 : 1) << r;
  }
  jc_column_sweeps<R>(u, pv, wl, wr, wd, iv, wu0, msk, cur, nxt, (ly0 + 1) * pitch + tx + 1,
                      pitch, abc, base, n_active);
  jc_column_store<R>(u, pv, u_out + off, p_out + off, y0, ly0, gx, eh, ew, k, h, w);
}

// K2 with ghost rows, s sweeps per exchange: R rows per thread and at most
// MAXT threads per CTA; a CTA of blockDim.x >= w threads across and
// blockDim.y down holds an extended band of blockDim.y * R rows, of which it
// computes ext = rows + 2 * (s - 1).
template <int R, int MAXT>
__global__ void __launch_bounds__(MAXT)
jc_sweep_resident_kernel(float* __restrict__ u, float* __restrict__ p,
                         const float* __restrict__ bh, const float* __restrict__ bv,
                         const float* __restrict__ inv,
                         const unsigned char* __restrict__ mask,
                         const float* __restrict__ abc, int h, int w, int rows, int s,
                         int base, int n, const int* __restrict__ stop) {
  // A stopped launch leaves the level as it is. Every CTA of the cluster
  // reads the same flag, so all return before the first cluster barrier.
  if (stop != nullptr && *stop) return;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ncta = (int)cluster.num_blocks();
  extern __shared__ float smem[];
  // The CTA's band is image rows rank*rows .. rank*rows+rows-1; its
  // extended band adds the s-1 rows above and below it (the ghost rows),
  // ext rows from image row y0. Thread (x, ty) owns column x of extended
  // rows ty*R .. ty*R+R-1, in registers as K1's threads own theirs. Two
  // (eh + 2) x (w + 2) buffers of u hold them for the neighbouring columns
  // and thread rows, and a third their bh, whence wl. Their ring
  // is zeros that nobody writes, columns 0 and w+1 for the neighbours past
  // the image's sides, but for the slots just above and below the extended
  // band: they hold the rows at distance s from the band, which the
  // threads next to them write. Rows outside the image and extended rows
  // past ext load as outside: mask 1, u = 0.
  const int eh = blockDim.y * R;
  const int ext = rows + 2 * (s - 1);
  const int pitch = w + 2;
  const int np = (eh + 2) * pitch;
  float* cur = smem;
  float* nxt = smem + np;
  float* sbh = nxt + np;
  // Two mailboxes (one per parity of the exchange) of 4 * s rows of w:
  // the band's first s rows' u and prev, then its last s rows' u and prev
  // (the last row first), which the CTAs above and below read.
  float* mail = sbh + np;
  const int box = 4 * s * w;
  const int x = threadIdx.x;
  const int ly0 = threadIdx.y * R;  // the thread's first extended row
  const int tid = threadIdx.y * blockDim.x + x;
  const int nt = blockDim.x * blockDim.y;
  const int y0 = rank * rows - (s - 1);
  for (int i = tid; i < pitch; i += nt) {
    cur[i] = nxt[i] = sbh[i] = 0.0f;
    cur[np - pitch + i] = nxt[np - pitch + i] = sbh[np - pitch + i] = 0.0f;
  }
  for (int i = tid; i < eh; i += nt) {
    const int row = (i + 1) * pitch;
    cur[row] = nxt[row] = sbh[row] = 0.0f;
    cur[row + w + 1] = nxt[row + w + 1] = sbh[row + w + 1] = 0.0f;
  }
  __syncthreads();  // the ring's zeros before the slots at distance s

  const bool col = x < w;
  // The thread's computed rows (0 .. R), and the slot below its last one:
  // the next thread row's first row, or the row at distance s below the band.
  const int nrow = min(max(ext - ly0, 0), R);
  const int c0 = (ly0 + 1) * pitch + x + 1;  // the thread's first pixel in the buffers
  const int cpast = c0 + nrow * pitch;
  float uu[R], pv[R], wr[R], wd[R], iv[R];
  unsigned msk = 0;
  float wu0 = 0.0f;  // bv of the row above the thread's first row
  {
    const int gy = y0 + ly0 - 1;
    if (col && gy >= 0 && gy < h) wu0 = bv[(size_t)gy * w + x];
  }
  // The rows at distance s from the band (the slots above and below the
  // computed rows) hold u from device memory until the first exchange.
  if (col && threadIdx.y == 0) {
    const int gy = y0 - 1;
    cur[x + 1] = nxt[x + 1] = gy >= 0 && gy < h ? u[(size_t)gy * w + x] : 0.0f;
  }
  if (col && nrow > 0 && ly0 + nrow == ext) {
    const int gy = y0 + ext;
    cur[cpast] = nxt[cpast] = gy < h ? u[(size_t)gy * w + x] : 0.0f;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int gy = y0 + ly0 + r;
    const bool in = col && r < nrow && gy >= 0 && gy < h;
    const size_t g = (size_t)gy * w + x;
    uu[r] = in ? u[g] : 0.0f;
    pv[r] = in ? p[g] : 0.0f;
    wr[r] = in ? bh[g] : 0.0f;
    wd[r] = in ? bv[g] : 0.0f;
    iv[r] = in ? inv[g] : 0.0f;
    msk |= (unsigned)(in ? mask[g] != 0 : 1) << r;
    if (col && r < nrow) {
      cur[c0 + r * pitch] = uu[r];
      sbh[c0 + r * pitch] = wr[r];
    }
  }
  __syncthreads();

  float a = __ldg(abc + 3 * base), b = __ldg(abc + 3 * base + 1), c = __ldg(abc + 3 * base + 2);
  int parity = 0;
  for (int t = 0; t < n; t += s) {
    // s sweeps (the last block the remainder) with only the CTA's barrier
    // between them. Sweep j spoils extended rows j+1 from each end (the
    // rows at distance s stand still), so the band comes out exact.
    const int m = min(s, n - t);
    for (int j = 0; j < m; ++j) {
      const int k = t + j;
      const int next = 3 * (base + (k + 1 < n ? k + 1 : k));
      const float na = __ldg(abc + next), nb = __ldg(abc + next + 1), nc = __ldg(abc + next + 2);
      if (col) {
        float above = cur[c0 - pitch];
        const float past = cur[cpast];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < nrow) {
            const int li = c0 + r * pitch;
            const float uc = uu[r];
            const float down = r + 1 < R ? uu[r + 1 < R ? r + 1 : r] : 0.0f;
            const float below = r + 1 < nrow ? down : past;
            const float wu = r > 0 ? wd[r > 0 ? r - 1 : 0] : wu0;
            const float nu = jc_point(cur[li - 1], cur[li + 1], above, below, uc, pv[r],
                                      sbh[li - 1], wr[r], wu, wd[r], iv[r], (msk >> r) & 1u,
                                      a, b, c);
            nxt[li] = nu;
            above = uc;
            pv[r] = uc;
            uu[r] = nu;
          }
        }
      }
      __syncthreads();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
      a = na;
      b = nb;
      c = nc;
    }
    if (t + m >= n) break;

    // The exchange. Each CTA posts its band's edge rows in its mailbox of
    // this parity; the cluster barrier (release/acquire) makes them
    // visible; each reads its neighbours' into its ghost rows and the
    // slots at distance s. A mailbox is written again two exchanges later,
    // after a barrier that every reader of this one has passed.
    float* mine = mail + parity * box;
    if (col) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = ly0 + r - (s - 1);  // the band row
        if (r < nrow && j >= 0 && j < s) {
          mine[j * w + x] = uu[r];
          mine[(s + j) * w + x] = pv[r];
        }
        if (r < nrow && j >= rows - s && j < rows) {
          mine[(2 * s + rows - 1 - j) * w + x] = uu[r];
          mine[(3 * s + rows - 1 - j) * w + x] = pv[r];
        }
      }
    }
    cluster.sync();
    // The neighbour above's last rows and the neighbour below's first
    // rows; none past the cluster's ends, where the ghost rows lie outside
    // the image and stay 0.
    const float* up = rank > 0 ? cluster.map_shared_rank(mine, rank - 1) + 2 * s * w : nullptr;
    const float* dn = rank + 1 < ncta ? cluster.map_shared_rank(mine, rank + 1) : nullptr;
    if (col) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = ly0 + r;
        // distance from the band: above it d = s-1-i+1, below it i-(s-1+rows)+1
        const int du = s - 1 - i;
        const int dd = i - (s - 1) - rows + 1;
        const float* src = du > 0 ? up : dn;
        const int d = du > 0 ? du : dd;
        if (r < nrow && d > 0 && src != nullptr) {
          uu[r] = src[(d - 1) * w + x];
          pv[r] = src[(s + d - 1) * w + x];
          cur[c0 + r * pitch] = uu[r];
        }
      }
      if (threadIdx.y == 0 && up != nullptr) cur[x + 1] = nxt[x + 1] = up[(s - 1) * w + x];
      if (nrow > 0 && ly0 + nrow == ext && dn != nullptr)
        cur[cpast] = nxt[cpast] = dn[(s - 1) * w + x];
    }
    // The ghost rows' u for the neighbouring columns and thread rows.
    if (s > 1) __syncthreads();
    parity ^= 1;
  }

  // The band goes back in place, into rows that the neighbours load as
  // ghost rows at entry: no CTA writes before every CTA has loaded, even
  // in a launch of s sweeps or fewer, which has no exchange. Each CTA has
  // also read its last mailbox before it arrives, so none leaves while a
  // neighbour may still read its shared memory.
  cluster.sync();
  if (col) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = ly0 + r - (s - 1);
      const int gy = y0 + ly0 + r;
      if (r < nrow && j >= 0 && j < rows && gy < h) {
        const size_t g = (size_t)gy * w + x;
        u[g] = uu[r];
        p[g] = pv[r];
      }
    }
  }
}

// K2 on one thread row of RESIDENT_ROWS rows, one exchange a sweep (s = 1):
// the layout of the widest bands (1080p L2, 4K L3), which leave no room for
// ghost rows. Each sweep reads the rows across the band's edges in place,
// in the neighbouring CTAs' copies of this sweep's u, and ends with one
// cluster barrier, whose release/acquire makes each CTA's new rows
// visible to its neighbours.
template <>
__global__ void __launch_bounds__(RESIDENT_MAX_W)
jc_sweep_resident_kernel<RESIDENT_ROWS, RESIDENT_MAX_W>(
    float* __restrict__ u, float* __restrict__ p, const float* __restrict__ bh,
    const float* __restrict__ bv, const float* __restrict__ inv,
    const unsigned char* __restrict__ mask, const float* __restrict__ abc, int h, int w,
    int rows, int /* s = 1 */, int base, int n, const int* __restrict__ stop) {
  // A stopped launch leaves the level as it is. Every CTA of the cluster
  // reads the same flag, so all return before the first cluster barrier.
  if (stop != nullptr && *stop) return;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ncta = (int)cluster.num_blocks();
  extern __shared__ float smem[];
  // The CTA's band is image rows y0 .. y0+rows-1 (rows <= RESIDENT_ROWS);
  // thread x owns column x of it, in registers as K1's threads own theirs.
  // Two (rows + 2) x (w + 2) buffers of u hold the band for the
  // neighbouring columns and CTAs, and a third its bh, whence wl (one
  // register array fewer: six arrays of 17 spilled 236 bytes, five spill
  // 108). Their ring is zeros that nobody writes: columns 0 and w+1 stand
  // for the neighbours past the image's sides, rows 0 and rows+1 for those
  // past its top and bottom. Rows past h load as outside the image: mask
  // 1, u = 0.
  const int pitch = w + 2;
  const int np = (rows + 2) * pitch;
  float* cur = smem;
  float* nxt = smem + np;
  float* sbh = nxt + np;
  const int x = threadIdx.x;
  const int nt = blockDim.x;
  const int y0 = rank * rows;
  for (int i = x; i < pitch; i += nt) {
    cur[i] = nxt[i] = sbh[i] = 0.0f;
    cur[np - pitch + i] = nxt[np - pitch + i] = sbh[np - pitch + i] = 0.0f;
  }
  for (int i = x; i < rows; i += nt) {
    const int row = (i + 1) * pitch;
    cur[row] = nxt[row] = sbh[row] = 0.0f;
    cur[row + w + 1] = nxt[row + w + 1] = sbh[row + w + 1] = 0.0f;
  }

  const bool col = x < w;
  float uu[RESIDENT_ROWS], pv[RESIDENT_ROWS], wr[RESIDENT_ROWS], wd[RESIDENT_ROWS],
      iv[RESIDENT_ROWS];
  unsigned msk = 0;
  const float wu0 = col && y0 > 0 && y0 < h ? bv[(size_t)(y0 - 1) * w + x] : 0.0f;
  const int c0 = pitch + x + 1;  // the thread's first pixel in the buffers
#pragma unroll
  for (int r = 0; r < RESIDENT_ROWS; ++r) {
    const int gy = y0 + r;
    const bool in = col && r < rows && gy < h;
    const size_t g = (size_t)gy * w + x;
    uu[r] = in ? u[g] : 0.0f;
    pv[r] = in ? p[g] : 0.0f;
    wr[r] = in ? bh[g] : 0.0f;
    wd[r] = in ? bv[g] : 0.0f;
    iv[r] = in ? inv[g] : 0.0f;
    msk |= (unsigned)(in ? mask[g] != 0 : 1) << r;
    if (col && r < rows) {
      cur[c0 + r * pitch] = uu[r];
      sbh[c0 + r * pitch] = wr[r];
    }
  }
  cluster.sync();

  float a = __ldg(abc + 3 * base), b = __ldg(abc + 3 * base + 1), c = __ldg(abc + 3 * base + 2);
  for (int t = 0; t < n; ++t) {
    const int next = 3 * (base + (t + 1 < n ? t + 1 : t));
    const float na = __ldg(abc + next), nb = __ldg(abc + next + 1), nc = __ldg(abc + next + 2);
    if (col) {
      // The rows across the band's edges: the neighbours' last and first
      // band rows in their copies of this sweep's u, or the zero ring.
      const float* top = rank > 0 ? cluster.map_shared_rank(cur + rows * pitch, rank - 1) : cur;
      const float* bottom =
          rank + 1 < ncta ? cluster.map_shared_rank(cur + pitch, rank + 1) : cur + (rows + 1) * pitch;
      float above = top[x + 1];
      const float past = bottom[x + 1];
#pragma unroll
      for (int r = 0; r < RESIDENT_ROWS; ++r) {
        if (r < rows) {
          const int li = c0 + r * pitch;
          const float uc = uu[r];
          const float down = r + 1 < RESIDENT_ROWS ? uu[r + 1 < RESIDENT_ROWS ? r + 1 : r] : 0.0f;
          const float below = r + 1 < rows ? down : past;
          const float wu = r > 0 ? wd[r > 0 ? r - 1 : 0] : wu0;
          const float nu = jc_point(cur[li - 1], cur[li + 1], above, below, uc, pv[r],
                                    sbh[li - 1], wr[r], wu, wd[r], iv[r], (msk >> r) & 1u, a,
                                    b, c);
          nxt[li] = nu;
          above = uc;
          pv[r] = uc;
          uu[r] = nu;
        }
      }
    }
    // The new u of every CTA is visible to its neighbours (release/acquire).
    cluster.sync();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
    a = na;
    b = nb;
    c = nc;
  }

  if (col) {
#pragma unroll
    for (int r = 0; r < RESIDENT_ROWS; ++r) {
      const int gy = y0 + r;
      if (r < rows && gy < h) {
        const size_t g = (size_t)gy * w + x;
        u[g] = uu[r];
        p[g] = pv[r];
      }
    }
  }
  // No CTA leaves while a neighbour may still read its shared memory.
  cluster.sync();
}

static int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <int R, int MAXT>
static int launch_tiles(const float* u_in, const float* p_in, float* u_out, float* p_out,
                        const float* bh, const float* bv, const float* inv,
                        const unsigned char* mask, const float* abc, int nb, int h, int w,
                        int base, int n_active, int k, int bx, int by, const int* stop,
                        cudaStream_t stream) {
  const int eh = by * R;
  if (bx * by > MAXT || bx - 2 * k < 1 || eh - 2 * k < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = jc_tile_smem(bx, by, R);
  int err = set_smem((const void*)jc_sweep_tiles_kernel<R, MAXT>, smem);
  if (err) return err;
  const dim3 grid((w + bx - 2 * k - 1) / (bx - 2 * k), (h + eh - 2 * k - 1) / (eh - 2 * k), nb);
  jc_sweep_tiles_kernel<R, MAXT><<<grid, dim3(bx, by), smem, stream>>>(
      u_in, p_in, u_out, p_out, bh, bv, inv, mask, abc, h, w, base, n_active, k, stop);
  return (int)cudaGetLastError();
}

// rows_per_thread picks the instance: 8 (at most 512 threads, up to 128
// registers a thread) or 6 (at most 1024 threads, 64 registers), which
// holds the wider tiles that a ring of 17-32 needs. stop is null, or a
// device int that, when non-zero, turns the launch into a copy of
// (u_in, p_in) to (u_out, p_out).
extern "C" int jc_sweep_tiles(const float* u_in, const float* p_in, float* u_out,
                              float* p_out, const float* bh, const float* bv,
                              const float* inv, const unsigned char* mask,
                              const float* abc, int nb, int h, int w, int base, int n_active,
                              int k, int bx, int by, int rows_per_thread, const int* stop,
                              void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (rows_per_thread == 8)
    return launch_tiles<8, 512>(u_in, p_in, u_out, p_out, bh, bv, inv, mask, abc, nb, h, w,
                                base, n_active, k, bx, by, stop, s);
  if (rows_per_thread == 6)
    return launch_tiles<6, 1024>(u_in, p_in, u_out, p_out, bh, bv, inv, mask, abc, nb, h, w,
                                 base, n_active, k, bx, by, stop, s);
  return (int)cudaErrorInvalidValue;
}

// Shared memory of K2: three (eh + 2) x (w + 2) planes and two mailboxes
// of 4 * s rows of w.
static size_t resident_smem(int eh, int w, int s) {
  return sizeof(float) * (3 * (size_t)(eh + 2) * (w + 2) + 8 * (size_t)s * w);
}

// The largest K2 launch the card is asked about (jc_resident_max_cluster);
// no launch may ask for more.
static size_t resident_smem_max() { return resident_smem(RESIDENT_ROWS, RESIDENT_MAX_W, 1); }

template <int R, int MAXT>
static int resident_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int cluster,
                           dim3 threads, size_t smem, cudaStream_t stream) {
  const void* kernel = (const void*)jc_sweep_resident_kernel<R, MAXT>;
  int err = set_smem(kernel, smem);
  if (err) return err;
  if (cluster > 8) {
    err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err) return err;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster);
  cfg->blockDim = threads;
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return 0;
}

// The CTA of one instance for bands of rows x w at s sweeps per exchange:
// bx threads across, by thread rows of R rows down; false where its threads
// or shared memory would pass the instance's.
template <int R, int MAXT>
static bool resident_cta(int w, int rows, int s, int* bx, int* by) {
  *bx = (w + 31) / 32 * 32;
  *by = (rows + 2 * (s - 1) + R - 1) / R;
  return *bx * *by <= MAXT && resident_smem(*by * R, w, s) <= resident_smem_max();
}

template <int R, int MAXT>
static int launch_resident(float* u, float* p, const float* bh, const float* bv,
                           const float* inv, const unsigned char* mask, const float* abc, int h,
                           int w, int rows, int s, int base, int n, int cluster, const int* stop,
                           cudaStream_t stream) {
  int bx, by;
  resident_cta<R, MAXT>(w, rows, s, &bx, &by);
  const size_t smem = resident_smem(by * R, w, s);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int err = resident_config<R, MAXT>(&cfg, &attr, cluster, dim3(bx, by), smem, stream);
  if (err) return err;
  err = (int)cudaLaunchKernelEx(&cfg, jc_sweep_resident_kernel<R, MAXT>, u, p, bh, bv, inv,
                                mask, abc, h, w, rows, s, base, n, stop);
  if (err) return err;
  return (int)cudaGetLastError();
}

// 0 where K2 runs an (h, w) level on cluster CTAs at s sweeps per exchange
// (1 .. min(RESIDENT_MAX_S, the band's rows)) on thread rows of
// rows_per_thread rows: RESIDENT_ROWS (one thread row, s = 1), or 2, 4 or 6
// (as many as the extended band needs); else cudaErrorInvalidValue. The
// host picks the plan (ops/sweep.py:resident_layouts, held to this check
// on the card by the tests).
extern "C" int jc_resident_check(int h, int w, int cluster, int s, int rows_per_thread) {
  if (cluster < 1 || cluster > MAX_CLUSTER || w < 1 || w > RESIDENT_MAX_W || h < 1)
    return (int)cudaErrorInvalidValue;
  const int rows = (h + cluster - 1) / cluster;
  if (rows > RESIDENT_ROWS || s < 1 || s > RESIDENT_MAX_S || s > rows)
    return (int)cudaErrorInvalidValue;
  int bx, by;
  bool ok = false;
  switch (rows_per_thread) {
    case RESIDENT_ROWS:
      ok = s == 1 && resident_cta<RESIDENT_ROWS, RESIDENT_MAX_W>(w, rows, s, &bx, &by);
      break;
    case 2:
      ok = resident_cta<2, RESIDENT_BLOCKED_T>(w, rows, s, &bx, &by);
      break;
    case 4:
      ok = resident_cta<4, RESIDENT_BLOCKED_T>(w, rows, s, &bx, &by);
      break;
    case 6:
      ok = resident_cta<6, RESIDENT_BLOCKED_T>(w, rows, s, &bx, &by);
      break;
  }
  return ok ? 0 : (int)cudaErrorInvalidValue;
}

// K2 at the plan (s, rows_per_thread) that jc_resident_check accepts. stop
// is null, or a device int that, when non-zero, leaves (u, p) as they are.
extern "C" int jc_sweep_resident(float* u, float* p, const float* bh, const float* bv,
                                 const float* inv, const unsigned char* mask,
                                 const float* abc, int h, int w, int base, int n, int cluster,
                                 int s, int rows_per_thread, const int* stop, void* stream) {
  const int err = jc_resident_check(h, w, cluster, s, rows_per_thread);
  if (err) return err;
  const int rows = (h + cluster - 1) / cluster;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (rows_per_thread) {
    case RESIDENT_ROWS:
      return launch_resident<RESIDENT_ROWS, RESIDENT_MAX_W>(u, p, bh, bv, inv, mask, abc, h, w,
                                                            rows, s, base, n, cluster, stop, st);
    case 2:
      return launch_resident<2, RESIDENT_BLOCKED_T>(u, p, bh, bv, inv, mask, abc, h, w, rows, s,
                                                    base, n, cluster, stop, st);
    case 4:
      return launch_resident<4, RESIDENT_BLOCKED_T>(u, p, bh, bv, inv, mask, abc, h, w, rows, s,
                                                    base, n, cluster, stop, st);
    case 6:
      return launch_resident<6, RESIDENT_BLOCKED_T>(u, p, bh, bv, inv, mask, abc, h, w, rows, s,
                                                    base, n, cluster, stop, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The largest cluster of one instance of K2 at the largest launch
// (resident_smem_max, MAXT threads), 0 where none runs.
template <int R, int MAXT>
static int resident_max_cluster(int* out) {
  *out = 0;
  for (int c = MAX_CLUSTER; c >= 1; c /= 2) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    int err = resident_config<R, MAXT>(&cfg, &attr, c, dim3(MAXT), resident_smem_max(), 0);
    if (err) return err;
    int active = 0;
    err = (int)cudaOccupancyMaxActiveClusters(&active, jc_sweep_resident_kernel<R, MAXT>, &cfg);
    if (err == (int)cudaErrorInvalidValue || err == (int)cudaErrorInvalidConfiguration) {
      cudaGetLastError();  // this size is refused: try the next smaller one
      continue;
    }
    if (err) return err;
    if (active >= 1) {
      *out = c;
      return 0;
    }
  }
  return 0;
}

// The largest cluster (16, 8, 4, 2 or 1 CTAs) that the current card runs of
// every instance of K2 at its largest launch (at least one such cluster
// active at once), in *out; 0 where none can.
extern "C" int jc_resident_max_cluster(int* out) {
  int c[4];
  int err = resident_max_cluster<RESIDENT_ROWS, RESIDENT_MAX_W>(&c[0]);
  if (!err) err = resident_max_cluster<2, RESIDENT_BLOCKED_T>(&c[1]);
  if (!err) err = resident_max_cluster<4, RESIDENT_BLOCKED_T>(&c[2]);
  if (!err) err = resident_max_cluster<6, RESIDENT_BLOCKED_T>(&c[3]);
  if (err) return err;
  *out = c[0];
  for (int i = 1; i < 4; ++i) *out = c[i] < *out ? c[i] : *out;
  return 0;
}

extern "C" const char* rtdd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
