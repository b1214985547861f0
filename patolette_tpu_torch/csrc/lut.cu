// K5: the 24-bit nearest-palette table.
//
// Replaces patolette_tpu/ops/lut.py::_argmin_lut (and the argmin half of
// build_lut_device): for every uint8 sRGB code, the index of the nearest
// valid palette entry in ICtCp, written as u8 (P <= 256) or u16
// (P <= 65536). The JAX package scanned (P, chunk) distance tiles over the
// cached grid; here the grid's three planes are the "pixels" of
// nearest.cuh's scan (the one K3 runs), so the table equals K3's direct map
// of the same grid bit for bit. The grid itself (sRGB -> working -> ICtCp
// of each code) is K10's pass over the codes (ops/lut.py).
//
// The scan is pruned (nearest.cuh): each warp's points are a small box of
// the grid, and only the palette entries that can be nearest somewhere in
// it are scanned, with the same arithmetic and the same first-index ties,
// so the table is the brute-force table bit for bit. On the grid the warps
// take bricks of 4 r x 8 g x 8 b codes, whose ICtCp boxes are tighter than
// the linear layout's 1 r x 8 g x 32 b runs.
//
// Bound on the H100: device-memory bytes, 201 MB of grid read and 16.8 MB
// (u8) or 33.5 MB (u16) of table written, ~0.065 / 0.070 ms at 3.35 TB/s;
// the brute-force scan's 7 f32 operations per (code, valid entry), 3.0e10
// at P = 256 (0.45 ms at 67 TFLOP/s), are no longer the work done. What
// holds it above that bound is the list building: two passes over every
// valid entry a warp, against a scan of the ~3 (P = 256) to ~6 (P = 1024)
// entries a brick lists.
#include <stdint.h>

#include "nearest.cuh"

// a, b, c: the (N,) grid planes; cent: (K, 4) rows [c0, c1, c2, |c|^2];
// valid: (K,) int32; out: (N,) of out_bytes (1: u8, 2: u16) per entry.
// N a multiple of 2^18 (the grid, or a rank's slice of it) takes the brick
// layout.
PT_EXPORT int pt_lut_argmin(const float* a, const float* b, const float* c,
                            const float* cent, const int* valid, int n, int k,
                            void* out, int out_bytes, void* stream) {
  const bool brick = n % kBrickSlab == 0;
  if (out_bytes == 1 && k <= 256) {
    return brick ? launch_nearest<uint8_t, true>(
                       a, b, c, cent, valid, n, k, (uint8_t*)out, nullptr,
                       stream)
                 : launch_nearest<uint8_t, false>(
                       a, b, c, cent, valid, n, k, (uint8_t*)out, nullptr,
                       stream);
  }
  if (out_bytes == 2 && k <= 65536) {
    return brick ? launch_nearest<uint16_t, true>(
                       a, b, c, cent, valid, n, k, (uint16_t*)out, nullptr,
                       stream)
                 : launch_nearest<uint16_t, false>(
                       a, b, c, cent, valid, n, k, (uint16_t*)out, nullptr,
                       stream);
  }
  return (int)cudaErrorInvalidValue;
}

// A measurement of the scan, not on any path: the labels of one launch as
// int32, and per warp the number of centres it scanned (its list's
// length), in the layout `layout`: 0 linear (K5 off the grid), 1 brick
// (K5 on the grid), 2 sorted with 1024 threads a block (tiles of 8192
// points: K3's), 3 sorted with 512 (4096 points). counts: one int per warp.
PT_EXPORT int pt_nearest_probe(const float* a, const float* b, const float* c,
                               const float* cent, const int* valid, int n,
                               int k, int layout, int* labels, int* counts,
                               void* stream) {
  switch (layout) {
    case 0:
      return launch_nearest<int, false, true>(a, b, c, cent, valid, n, k,
                                              labels, counts, stream);
    case 1:
      return launch_nearest<int, true, true>(a, b, c, cent, valid, n, k,
                                             labels, counts, stream);
    case 2:
      return launch_nearest_sorted<1024, true>(a, b, c, cent, valid, n, k,
                                               labels, counts, stream);
    case 3:
      return launch_nearest_sorted<512, true>(a, b, c, cent, valid, n, k,
                                              labels, counts, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
