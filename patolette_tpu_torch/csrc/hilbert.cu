// K7: the Hilbert-curve visit order of a width x height image.
//
// Replaces patolette_tpu/ops/hilbert.py::pixel_visit_order (xy_to_d of
// every row-major pixel, then jnp.argsort): out[i] is the row-major index
// of the i-th pixel in ascending curve distance d. The keys are distinct,
// so ascending d is the whole permutation: the kernel enumerates d in
// order and keeps the cells inside the image, with no keys and no sort.
//
// The inverse of xy_to_d. A level's digit q = (3 rx) ^ ry gives the bits
// (rx, ry) of the rotated coordinates; xy_to_d's rotation so far is a
// complement of both coordinates (c) and a swap (s), which commute, so the
// image's bits are swap^s(complement^c(rx, ry)); a digit with ry = 0 then
// flips s and, with rx = 1, c. (xy_to_d complements with s - 1 - x in
// uint32, which agrees with the textbook n - 1 - x in every bit a later
// level reads.) Because the state is a pair of flips, a run of levels
// started from state (c, s) gives the cells of the run started from (0, 0)
// under complement^c and swap^s.
//
// Design. The square of side 2^order is cut into tiles of side 2^b, b =
// min(5, order): tile t in curve order holds d in [t 4^b, (t + 1) 4^b).
// The tiles that meet the image are ceil(W / 2^b) x ceil(H / 2^b); a warp
// takes the j-th of them and finds it by rank, with no pass over the
// square (a 40000 x 3 strip has order 16: 4.3 G cells, millions of tiles,
// 1250 of which meet it): it descends the quadtree of tiles from the
// root, taking at each level the first child in curve order whose count
// of image-meeting tiles exceeds what is left of j, and adding the pixels
// of the children it passes to its output offset (both counts in closed
// form: the child's square clipped to the image; 32-bit, as every count
// is below W H < 2^31). The descent also gives the tile's corner and the
// rotation state there. Each block first builds, in shared memory, the
// canonical tile (the inverse over b levels from state (0, 0)) and, for
// each of the four states, every cell's offset ly W + lx from the tile's
// corner. A warp writes a tile inside the image as out[off + d] = corner
// + offset[state][d], 32 cells a step (a shared-memory load, an add, a
// store); a tile on the image's edge walks the canonical cells under the
// state, tests each against the image and writes the cells inside at the
// offset plus their rank (a ballot and a popc). The offsets are exact
// integers, so there is no scan and no second launch, and the result does
// not depend on the schedule. The grid is a few blocks an SM, each warp
// taking tiles j, j + warps, ..., so the tables are built once a block.
//
// Bound on the H100: device-memory bytes, 4 B written a pixel (nothing is
// read): 33 MB at 4K, ~0.0099 ms at 3.35 TB/s. A tile meeting the image's
// edge walks cells outside it: at most (W + 31) (H + 31) cells in all.
#include "common.cuh"

namespace {

constexpr int kTileBits = 5;
constexpr int kTileCells = 1 << (2 * kTileBits);
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// Cells of [a, a + n) below limit.
__device__ __forceinline__ unsigned span(unsigned a, unsigned n,
                                         unsigned limit) {
  return a >= limit ? 0u : min(n, limit - a);
}

__global__ void __launch_bounds__(kThreads)
    visit_order_kernel(int width, int height, int order,
                       int* __restrict__ out) {
  __shared__ unsigned cells[kTileCells];  // canonical tile: x | y << 16
  __shared__ int offset[4][kTileCells];   // state c + 2 s: ly W + lx
  const int b = min(kTileBits, order);
  const int levels = order - b;
  const int side = 1 << b;
  const int n_cells = side * side;
  const unsigned m = side - 1;
  const unsigned w = width, h = height;
  const unsigned tw = (w + m) >> b, th = (h + m) >> b;
  const unsigned n_tiles = tw * th;
  for (int d = threadIdx.x; d < n_cells; d += kThreads) {
    unsigned x = 0, y = 0, c = 0, s = 0;
    for (int lv = b - 1; lv >= 0; --lv) {
      const unsigned q = (d >> (2 * lv)) & 3;
      const unsigned rx = q >> 1, ry = (q ^ (q >> 1)) & 1;
      const unsigned ax = rx ^ c, ay = ry ^ c;
      x |= (s ? ay : ax) << lv;
      y |= (s ? ax : ay) << lv;
      if (ry == 0) {
        c ^= rx;
        s ^= 1;
      }
    }
    cells[d] = x | (y << 16);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 4 * n_cells; i += kThreads) {
    const int st = i >> (2 * b), d = i & (n_cells - 1);
    unsigned lx = cells[d] & 0xffffu, ly = cells[d] >> 16;
    if (st & 1) {
      lx = m - lx;
      ly = m - ly;
    }
    offset[st][d] = (int)((st & 2) ? lx * w + ly : ly * w + lx);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const unsigned stride = gridDim.x * kWarps;
  for (unsigned j = blockIdx.x * kWarps + (threadIdx.x >> 5); j < n_tiles;
       j += stride) {  // warp-uniform
    // the j-th image-meeting tile: corner (tx, ty) in tiles, state (c, s),
    // and the pixels before it
    unsigned rank = j, off = 0, tx = 0, ty = 0, c = 0, s = 0;
    for (int lv = levels - 1; lv >= 0; --lv) {
      const unsigned half = 1u << lv;
      for (unsigned q = 0; q < 4; ++q) {
        const unsigned rx = q >> 1, ry = (q ^ (q >> 1)) & 1;
        const unsigned ax = rx ^ c, ay = ry ^ c;
        const unsigned cx = tx + (s ? ay : ax) * half;
        const unsigned cy = ty + (s ? ax : ay) * half;
        const unsigned count = span(cx, half, tw) * span(cy, half, th);
        if (rank < count || q == 3) {
          tx = cx;
          ty = cy;
          if (ry == 0) {
            c ^= rx;
            s ^= 1;
          }
          break;
        }
        rank -= count;
        off += span(cx << b, half << b, w) * span(cy << b, half << b, h);
      }
    }
    const unsigned x0 = tx << b, y0 = ty << b;
    int* o = out + off;
    if (x0 + side <= w && y0 + side <= h) {  // inside: no test
      const int corner = (int)(y0 * w + x0);
      const int* ofs = offset[c + 2 * s];
      for (int d = lane; d < n_cells; d += 32) o[d] = corner + ofs[d];
      continue;
    }
    unsigned at = 0;
    for (int base = 0; base < n_cells; base += 32) {
      const int d = base + lane;
      bool inside = false;
      int pix = 0;
      if (d < n_cells) {
        const unsigned v = cells[d];
        unsigned lx = v & 0xffffu, ly = v >> 16;
        if (c) {
          lx = m - lx;
          ly = m - ly;
        }
        const unsigned x = x0 + (s ? ly : lx), y = y0 + (s ? lx : ly);
        inside = x < w && y < h;
        pix = (int)(y * w + x);
      }
      const unsigned ball = __ballot_sync(PT_FULL, inside);
      if (inside) o[at + __popc(ball & below)] = pix;
      at += __popc(ball);
    }
  }
}

}  // namespace

// out: (width * height,) int32, width * height < 2^31; order: the curve's
// (2^order >= max(width, height), at most 16); blocks: the grid.
PT_EXPORT int pt_visit_order(int width, int height, int order, int blocks,
                             int* out, void* stream) {
  if (width < 1 || height < 1 || order < 1 || order > 16 || blocks < 1 ||
      (1LL << order) < (long long)(width > height ? width : height) ||
      (long long)width * height >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  // all of an SM's shared memory for the blocks (the default carveout
  // leaves room for fewer of them)
  static int carved[PT_MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= PT_MAX_DEVICES || !carved[dev]) {
    err = cudaFuncSetAttribute(visit_order_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
    if (err != cudaSuccess) return (int)err;
    if (dev < PT_MAX_DEVICES) carved[dev] = 1;
  }
  visit_order_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      width, height, order, out);
  return (int)cudaGetLastError();
}
