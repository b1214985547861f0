// K9: minimum barrier distance, three raster passes as a tiled wavefront.
//
// Replaces patolette_tpu/models/saliency.py::_wavefront_pass (the three
// passes mbd() runs: inverse, forward, inverse). Each cell's update reads
// two neighbours that the same pass has already updated: (x-1, y) and
// (x, y-1) forward, (x+1, y) and (x, y+1) inverse. The barrier through a
// neighbour is max(U, I) - min(L, I); a cell keeps its d when d is no
// larger than both, else takes neighbour 1 when b1 < d and b1 <= b2, else
// neighbour 2. Forward updates x in [1, rows-2], y in [1, cols-2]; inverse
// x in [2, rows-2], y in [2, cols-2]. Min, max and one subtraction: the
// result is exact, so kernel, plain version and JAX agree bit for bit.
//
// Design: 32x32 tiles. Tile (i, j) depends on tiles (i-1, j) and (i, j-1)
// (forward), so the tile anti-diagonals run in order, one launch each
// (the host loop below; 187 a pass at 3840x2160), and the tiles of one
// diagonal run in parallel, one block each. A block stages its tile of
// img, l, u, d and the row and column of finished l, u next to it in
// shared memory (rows padded to 34 floats, so the 32 threads of a
// diagonal step hit 32 banks), walks the tile's 63 cell diagonals with one
// warp (thread = tile row, __syncwarp between steps), and writes l, u, d
// back. The TPU version's skewed layout is not needed.
//
// Bound on the H100: device-memory bytes. Per pass, img, l, u, d read and
// l, u, d written once: 3 passes x 7 planes x 4 B x N, 697 MB at 4K,
// ~0.21 ms at 3.35 TB/s. The wavefront adds latency: the serial chain is
// rows/32 + cols/32 tile diagonals a pass, each 63 dependent steps.
#include "common.cuh"

namespace {

constexpr int kT = 32;       // tile side
constexpr int kW = kT + 2;   // padded smem row
constexpr int kThreads = 128;

__global__ void mbd_diag(const float* __restrict__ img, float* __restrict__ l,
                         float* __restrict__ u, float* __restrict__ d,
                         int rows, int cols, int tdiag, int ti0,
                         bool inverse) {
  __shared__ float sl[kW * kW], su[kW * kW], si[kT * kW], sd[kT * kW];
  const int ti = ti0 + blockIdx.x;
  const int tj = tdiag - ti;
  const int r0 = ti * kT, c0 = tj * kT;
  const int tid = threadIdx.x;

  for (int e = tid; e < kT * kT; e += blockDim.x) {
    const int xl = e / kT, yl = e % kT;
    const int x = r0 + xl, y = c0 + yl;
    if (x < rows && y < cols) {
      const size_t g = (size_t)x * cols + y;
      si[xl * kW + yl] = img[g];
      sd[xl * kW + yl] = d[g];
      sl[(xl + 1) * kW + yl + 1] = l[g];
      su[(xl + 1) * kW + yl + 1] = u[g];
    }
  }
  // the finished neighbours: above and left (forward), below and right
  // (inverse)
  const int hx = inverse ? r0 + kT : r0 - 1;
  const int hy = inverse ? c0 + kT : c0 - 1;
  const int hsx = inverse ? kT + 1 : 0;
  for (int e = tid; e < kT; e += blockDim.x) {
    const int y = c0 + e;
    if (hx >= 0 && hx < rows && y < cols) {
      sl[hsx * kW + e + 1] = l[(size_t)hx * cols + y];
      su[hsx * kW + e + 1] = u[(size_t)hx * cols + y];
    }
    const int x = r0 + e;
    if (hy >= 0 && hy < cols && x < rows) {
      sl[(e + 1) * kW + hsx] = l[(size_t)x * cols + hy];
      su[(e + 1) * kW + hsx] = u[(size_t)x * cols + hy];
    }
  }
  __syncthreads();

  if (tid < kT) {
    const int xl = tid, x = r0 + xl;
    const int lo = inverse ? 2 : 1;
    const bool row_on = x >= lo && x <= rows - 2;
    const int dx = inverse ? 1 : -1;  // neighbour 1: (x + dx, y)
    for (int k = 0; k < 2 * kT - 1; ++k) {
      const int step = inverse ? 2 * kT - 2 - k : k;
      const int yl = step - xl, y = c0 + yl;
      if (row_on && yl >= 0 && yl < kT && y >= lo && y <= cols - 2) {
        const float ix = si[xl * kW + yl];
        const float dd = sd[xl * kW + yl];
        const int c = (xl + 1) * kW + yl + 1;
        const int n1 = c + dx * kW, n2 = c + dx;
        const float hi1 = fmaxf(su[n1], ix), lo1 = fminf(sl[n1], ix);
        const float hi2 = fmaxf(su[n2], ix), lo2 = fminf(sl[n2], ix);
        const float b1 = hi1 - lo1, b2 = hi2 - lo2;
        if (!(dd <= b1 && dd <= b2)) {
          if (b1 < dd && b1 <= b2) {
            sd[xl * kW + yl] = b1;
            su[c] = hi1;
            sl[c] = lo1;
          } else {
            sd[xl * kW + yl] = b2;
            su[c] = hi2;
            sl[c] = lo2;
          }
        }
      }
      __syncwarp();
    }
  }
  __syncthreads();

  for (int e = tid; e < kT * kT; e += blockDim.x) {
    const int xl = e / kT, yl = e % kT;
    const int x = r0 + xl, y = c0 + yl;
    if (x < rows && y < cols) {
      const size_t g = (size_t)x * cols + y;
      d[g] = sd[xl * kW + yl];
      l[g] = sl[(xl + 1) * kW + yl + 1];
      u[g] = su[(xl + 1) * kW + yl + 1];
    }
  }
}

}  // namespace

// img, l, u, d: (rows, cols) f32 row-major; l, u, d are updated in place by
// the three passes (inverse, forward, inverse).
PT_EXPORT int pt_mbd(const float* img, float* l, float* u, float* d, int rows,
                     int cols, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int tr = (rows + kT - 1) / kT, tc = (cols + kT - 1) / kT;
  const int ndiag = tr + tc - 1;
  for (int it = 0; it < 3; ++it) {
    const bool inverse = it % 2 == 0;
    for (int k = 0; k < ndiag; ++k) {
      const int td = inverse ? ndiag - 1 - k : k;
      const int ti0 = td - (tc - 1) > 0 ? td - (tc - 1) : 0;
      const int ti1 = td < tr - 1 ? td : tr - 1;
      mbd_diag<<<ti1 - ti0 + 1, kThreads, 0, st>>>(img, l, u, d, rows, cols,
                                                    td, ti0, inverse);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
